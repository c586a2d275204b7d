// Multi-head attention forward with an optional additive bias and mask,
// whole key axis resident in shared memory.
//
// Replaces the TPU kernel vss_cffm_tpu/ops/cfm_attention.py:
// _cfm_attention_pallas_impl (_fwd_kernel): the CFM window attention of every
// CFFM decoder block, (q*scale)·Kᵀ over the concatenated K/V source groups
// + relative-position bias (nh, Lq, N) + window mask (G, N), f32 softmax,
// P·V. With a probabilities pointer it also writes the normalised softmax p
// (G, nh, Lq, N) in f32 or bf16, the same values that are rounded to bf16
// for P·V (the TPU kernel's with_probs call, whose p the backward from
// probabilities reads). The same routine serves the spatial-reduction
// attention inside the whole-block path (ops/stage_block.py), with the scale
// folded into K and no bias or mask.
//
// Bound on the H100: memory for the CFM shapes (q, K, V, bias and mask are
// read once; about 2·Lq·N·hd·2 FLOP per (group, head) is little work per
// byte). Design: one block per (group, head, tile of 16·nwarps query rows).
// The block copies its q rows, the group's whole K and V head slices, its
// bias rows and the mask row into shared memory with cp.async, all in flight
// at once (zero rows pad N up to a multiple of 16). Each warp computes its 16
// query rows' scores for all keys with bf16 wmma tiles (f32 accumulation),
// then takes the exact f32 max-subtracted softmax of score + bias + mask over
// its 16 rows together (16 independent chains per lane, so shared-memory
// latency overlaps), rounds P to bf16 and multiplies by V with wmma again.
// Scores never reach device memory. Scaling rounds to bf16 like the reference
// (q·scale in q's dtype for CFM, K·scale in K's dtype for the MiT block).
// The caller picks nwarps so that shared memory fits the SM's 227 KB; at the
// main path's shapes that leaves one block of 4 warps per SM, so latency, not
// the bytes, bounds the kernel: flash-style tiles with register-resident
// scores are the later fix.
#include <cuda_pipeline.h>
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

__host__ __device__ inline int round16(int n) { return (n + 15) / 16 * 16; }

// Layout (bytes) of the dynamic shared memory for one block.
struct Smem {
  int R, Np, ls, hd, N, brows, mlen;
  __host__ __device__ Smem(int nwarps, int N_, int hd_, int Lq, bool bias, bool mask) {
    R = 16 * nwarps;
    Np = round16(N_);
    hd = hd_;
    N = N_;
    ls = Np > hd ? Np : hd;  // score rows also stage the (16, hd) output tile
    brows = bias ? (R < Lq ? R : Lq) : 0;
    mlen = mask ? N_ : 0;
  }
  __host__ __device__ size_t q_off() const { return 0; }
  __host__ __device__ size_t k_off() const { return q_off() + (size_t)R * hd * 2; }
  __host__ __device__ size_t v_off() const { return k_off() + (size_t)Np * hd * 2; }
  __host__ __device__ size_t s_off() const { return v_off() + (size_t)Np * hd * 2; }
  __host__ __device__ size_t p_off() const { return s_off() + (size_t)R * ls * 4; }
  __host__ __device__ size_t b_off() const { return p_off() + (size_t)R * Np * 2; }
  // bias rows (stride N) and mask row, each with 4 floats of slack so that
  // it can start at its source's offset modulo 16 bytes
  __host__ __device__ size_t m_off() const { return b_off() + run_bytes(brows * N); }
  __host__ __device__ size_t bytes() const { return m_off() + run_bytes(mlen); }
  __host__ __device__ static size_t run_bytes(int n) {
    return n ? ((size_t)n * 4 + 16 + 15) / 16 * 16 : 0;
  }
};

// Copy n floats from src to dst by the whole block with cp.async; dst and src
// are equal modulo 16 bytes, src lying `mis` floats past a 16-byte boundary.
__device__ __forceinline__ void copy_floats(float* dst, const float* src, int n, int mis) {
  const int head = min(n, (4 - mis) & 3);          // up to the first boundary
  const int body = (n - head) / 4 * 4;             // whole 16-byte chunks
  for (int i = threadIdx.x; i < head; i += blockDim.x) __pipeline_memcpy_async(dst + i, src + i, 4);
  for (int i = head + threadIdx.x * 4; i < head + body; i += blockDim.x * 4)
    __pipeline_memcpy_async(dst + i, src + i, 16);
  for (int i = head + body + threadIdx.x; i < n; i += blockDim.x)
    __pipeline_memcpy_async(dst + i, src + i, 4);
}

// x[i] = bf16(x[i] * s) over n (a multiple of 8) elements, by the whole block
__device__ __forceinline__ void scale_bf16(__nv_bfloat16* x, int n, float s) {
  for (int c = threadIdx.x * 8; c < n; c += blockDim.x * 8) {
    float f[8];
    vss::load8(x + c, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = f[i] * s;
    vss::store8(x + c, f);
  }
}

template <int HD>
__global__ void __launch_bounds__(128) attention_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
    const float* __restrict__ mask, __nv_bfloat16* __restrict__ out, void* __restrict__ probs,
    int probs_bf16, int Lq, int N, int C, float q_scale, float k_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int nwarps = blockDim.x / 32;
  const Smem L(nwarps, N, HD, Lq, bias != nullptr, mask != nullptr);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + L.q_off());
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + L.k_off());
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + L.v_off());
  float* S = reinterpret_cast<float*>(smem + L.s_off());
  __nv_bfloat16* P = reinterpret_cast<__nv_bfloat16*>(smem + L.p_off());
  float* Bs = reinterpret_cast<float*>(smem + L.b_off());  // bias rows, stride N
  float* Ms = reinterpret_cast<float*>(smem + L.m_off());  // mask row

  const int row0 = blockIdx.x * L.R;
  const int rows = min(L.R, Lq - row0);  // valid query rows of this block
  const int h = blockIdx.y;
  const long long g = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  constexpr int CH = HD / 8;  // 16-byte chunks per head row

  // ---- stage q rows, K / V head slices, bias rows and mask: all in flight --
  for (int c = tid; c < L.R * CH; c += blockDim.x) {
    const int r = c / CH, d = (c % CH) * 8;
    if (r < rows)
      __pipeline_memcpy_async(qs + r * HD + d, q + (g * Lq + row0 + r) * C + h * HD + d, 16);
    else
      *reinterpret_cast<uint4*>(qs + r * HD + d) = make_uint4(0, 0, 0, 0);
  }
  for (int c = tid; c < L.Np * CH; c += blockDim.x) {
    const int n = c / CH, d = (c % CH) * 8;
    if (n < N) {
      const long long off = (g * N + n) * C + h * HD + d;
      __pipeline_memcpy_async(ks + n * HD + d, k + off, 16);
      __pipeline_memcpy_async(vs + n * HD + d, v + off, 16);
    } else {
      *reinterpret_cast<uint4*>(ks + n * HD + d) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(vs + n * HD + d) = make_uint4(0, 0, 0, 0);
    }
  }
  // The block's bias rows are one contiguous run of floats, and so is the
  // mask row; each lands at its source's offset modulo 16 bytes, so that its
  // aligned middle goes in 16-byte copies and only the ragged ends in 4-byte
  // ones.
  if (L.brows) {
    const float* src = bias + ((long long)h * Lq + row0) * N;
    Bs += (reinterpret_cast<size_t>(src) & 15) / 4;
    copy_floats(Bs, src, rows * N, (reinterpret_cast<size_t>(src) & 15) / 4);
  }
  if (L.mlen) {
    const float* src = mask + g * N;
    Ms += (reinterpret_cast<size_t>(src) & 15) / 4;
    copy_floats(Ms, src, N, (reinterpret_cast<size_t>(src) & 15) / 4);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  // the scale, rounded to bf16 with the product as in the reference
  if (q_scale != 1.f) scale_bf16(qs, L.R * HD, q_scale);
  if (k_scale != 1.f) scale_bf16(ks, L.Np * HD, k_scale);
  __syncthreads();

  // ---- scores: this warp's 16 rows x all keys, f32 in shared memory -------
  const int r0 = warp * 16;
  float* Sw = S + (size_t)r0 * L.ls;
  __nv_bfloat16* Pw = P + (size_t)r0 * L.Np;
  {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[HD / 16];
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wmma::load_matrix_sync(a[kk], qs + r0 * HD + kk * 16, HD);
    for (int j = 0; j < L.Np / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
        wmma::load_matrix_sync(b, ks + j * 16 * HD + kk * 16, HD);
        wmma::mma_sync(acc, a[kk], b, acc);
      }
      wmma::store_matrix_sync(Sw + j * 16, acc, L.ls, wmma::mem_row_major);
    }
  }
  __syncwarp();

  // ---- (score + bias) + mask, exact f32 softmax, P rounded to bf16 --------
  // The warp's 16 rows are walked together, lane owning columns lane + 32·i,
  // with no branch inside the loops so that the 16 rows' shared-memory
  // accesses overlap. Rows past the valid ones compute on finite stand-ins
  // (zero q rows, the last valid bias row) and get P = 0.
  const int nv = max(0, min(16, rows - r0));  // valid rows of this warp
  if (nv > 0) {
    const float* Bw = Bs + (size_t)r0 * N;
    float mx[16], sm[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      mx[u] = -3.402823466e38f;  // every row holds >= 1 finite score
      sm[u] = 0.f;
    }
    for (int n = lane; n < N; n += 32) {
      const float mk = L.mlen ? Ms[n] : 0.f;
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        float s = Sw[(size_t)u * L.ls + n];
        if (L.brows) s = s + Bw[(size_t)min(u, nv - 1) * N + n];
        if (L.mlen) s = s + mk;
        Sw[(size_t)u * L.ls + n] = s;
        mx[u] = fmaxf(mx[u], s);
      }
    }
#pragma unroll
    for (int u = 0; u < 16; ++u) mx[u] = vss::warp_max(mx[u]);
    for (int n = lane; n < N; n += 32) {
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const float e = expf(Sw[(size_t)u * L.ls + n] - mx[u]);
        Sw[(size_t)u * L.ls + n] = e;
        sm[u] += e;
      }
    }
#pragma unroll
    for (int u = 0; u < 16; ++u) sm[u] = vss::warp_sum(sm[u]);
    // p rows of this warp in the probabilities output (G, nh, Lq, N)
    const long long prow = ((g * gridDim.y + h) * Lq + row0 + r0) * (long long)N;
    for (int n = lane; n < L.Np; n += 32) {
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const float pv = n < N ? Sw[(size_t)u * L.ls + n] / sm[u] : 0.f;
        Pw[(size_t)u * L.Np + n] = __float2bfloat16_rn(u < nv ? pv : 0.f);
        if (probs != nullptr && u < nv && n < N) {
          if (probs_bf16)
            static_cast<__nv_bfloat16*>(probs)[prow + (long long)u * N + n] =
                __float2bfloat16_rn(pv);
          else
            static_cast<float*>(probs)[prow + (long long)u * N + n] = pv;
        }
      }
    }
  } else {
    for (int i = lane; i < 16 * L.Np; i += 32) Pw[i] = __float2bfloat16_rn(0.f);
  }
  __syncwarp();

  // ---- out = P · V (f32 accumulation), staged through this warp's S rows --
  {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[HD / 16];
#pragma unroll
    for (int d = 0; d < HD / 16; ++d) wmma::fill_fragment(o[d], 0.f);
    for (int kt = 0; kt < L.Np / 16; ++kt) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, Pw + kt * 16, L.Np);
#pragma unroll
      for (int d = 0; d < HD / 16; ++d) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, vs + kt * 16 * HD + d * 16, HD);
        wmma::mma_sync(o[d], a, b, o[d]);
      }
    }
#pragma unroll
    for (int d = 0; d < HD / 16; ++d)
      wmma::store_matrix_sync(Sw + d * 16, o[d], L.ls, wmma::mem_row_major);
  }
  __syncwarp();
  for (int c = lane; c < nv * CH; c += 32) {
    const int r = c / CH, d = (c % CH) * 8;
    float f[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = Sw[(size_t)r * L.ls + d + i];
    vss::store8(out + (g * Lq + row0 + r0 + r) * C + h * HD + d, f);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* bias, const void* mask,
           void* out, void* probs, int probs_bf16, int G, int Lq, int N, int nh, int C,
           float q_scale, float k_scale, int nwarps, cudaStream_t s) {
  const Smem L(nwarps, N, HD, Lq, bias != nullptr, mask != nullptr);
  const size_t bytes = L.bytes();
  cudaError_t e = cudaFuncSetAttribute(attention_fwd_kernel<HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Lq + L.R - 1) / L.R, nh, G);
  attention_fwd_kernel<HD><<<grid, 32 * nwarps, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<__nv_bfloat16*>(out), probs, probs_bf16, Lq,
      N, C, q_scale, k_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q/out (G, Lq, C) bf16, k/v (G, N, C) bf16 with C = nh*hd (head h owns
// channels [h*hd, (h+1)*hd)); bias (nh, Lq, N) f32 or null; mask (G, N) f32
// or null; probs (G, nh, Lq, N), bf16 when probs_bf16 else f32, or null.
// hd in {32, 64}, the head dims of every MiT-B* stage and CFFM decoder;
// nwarps in 1..4. Returns a cudaError_t.
VSS_EXPORT int attention_fwd(const void* q, const void* k, const void* v, const void* bias,
                             const void* mask, void* out, void* probs, int probs_bf16, int G,
                             int Lq, int N, int nh, int hd, int C, float q_scale,
                             float k_scale, int nwarps, int device, void* stream) {
  cudaSetDevice(device);
  if (G == 0 || Lq == 0) return 0;
  if (nwarps < 1 || nwarps > 4 || N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch<32>(q, k, v, bias, mask, out, probs, probs_bf16, G, Lq, N, nh, C, q_scale, k_scale, nwarps, s);
    case 64: return launch<64>(q, k, v, bias, mask, out, probs, probs_bf16, G, Lq, N, nh, C, q_scale, k_scale, nwarps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory one block needs (the wrapper picks nwarps with it).
VSS_EXPORT int attention_smem_bytes(int N, int hd, int nwarps, int Lq, int has_bias,
                                    int has_mask) {
  return (int)Smem(nwarps, N, hd, Lq, has_bias != 0, has_mask != 0).bytes();
}
