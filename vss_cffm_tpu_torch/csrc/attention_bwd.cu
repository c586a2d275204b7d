// Backward of the CFM window attention, with the softmax recomputed or read
// from the forward's probabilities.
//
// Replaces the TPU kernels vss_cffm_tpu/ops/cfm_attention.py:
// _cfm_attention_bwd_pallas_rc (_bwd_kernel_rc): for every (window, head),
// qs = bf16(q * scale), S = qs K^T + bias + mask (f32), p = softmax(S) (f32),
// dP = g V^T, ds = p (dP - sum_n dP p) (f32), dq = bf16(bf16(ds) K) * scale
// rounded again, dK = bf16(ds)^T qs, dV = bf16(p)^T g, and dbias = the sum
// of ds over the windows. Packed K/V: one (G, N, C) tensor each.
// _cfm_attention_bwd_pallas (_bwd_kernel), the compile-time mode FROM_PROBS:
// p is read from the forward's probabilities (G, nh, Lq, N), f32 or bf16,
// the S = qs K^T recompute and its exps are skipped (bias and mask are not
// read), and the rest is the same arithmetic. At the train step p is 73 MB
// in f32 per call, so that mode moves more bytes than the recompute and
// skips one of five products and the 18.4 M exps.
//
// Bound on the H100 at the train step (162 windows, 49 queries, N 289, 8
// heads of 32): reading q, g, K, V, bias and mask and writing dq, dK, dV and
// dbias is ~108 MB (~32 us); the products are ~5.9 GFLOP (~6 us on the
// tensor cores). So bytes bound it.
// Design: one block of 4 warps per (head, tile of windows), walking its
// windows one by one. Per window it stages qs, g (64 rows, zero padded), K
// and V (N padded to 16) in shared memory, recomputes S with bf16 wmma
// tiles (f32 accumulation), takes the exact f32 softmax row by row (bias
// and mask read from global memory, L2-resident), and keeps p in f32 and
// bf16. dV, dK come from the transposed bf16 tiles; dP is computed twice,
// tile by tile (once for the row sums sum_n dP p, once to form ds), so that
// only p (then ds) is held at f32, which keeps head dim 64 within the 227 KB
// of shared memory. Each warp owns 16 query rows for S, the softmax, dP,
// ds and dq. The block adds its windows' ds into its own dbias partial
// (tile, head, 49, N) in a fixed order; the wrapper reduces the partials
// with one torch.sum, so no atomics and the same result run to run. One
// block of ~165 KB per SM: latency, not bytes, will bound this first
// version.
#include <mma.h>

#include <type_traits>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 16 * kWarps;  // query rows held (Lq <= 64)

__host__ __device__ inline int round16(int n) { return (n + 15) / 16 * 16; }

struct Smem {
  int Np, hd;
  __host__ __device__ Smem(int N, int hd_) : Np(round16(N)), hd(hd_) {}
  __host__ __device__ size_t q_off() const { return 0; }
  __host__ __device__ size_t g_off() const { return q_off() + (size_t)kRows * hd * 2; }
  __host__ __device__ size_t k_off() const { return g_off() + (size_t)kRows * hd * 2; }
  __host__ __device__ size_t v_off() const { return k_off() + (size_t)Np * hd * 2; }
  __host__ __device__ size_t s_off() const { return v_off() + (size_t)Np * hd * 2; }
  __host__ __device__ size_t p_off() const { return s_off() + (size_t)kRows * Np * 4; }
  __host__ __device__ size_t t_off() const { return p_off() + (size_t)kRows * Np * 2; }
  __host__ __device__ size_t bytes() const { return t_off() + (size_t)kWarps * 256 * 4; }
};

// rows [0, rows) of a (rows, C)-strided head slice → dst (nrows_pad, HD), zero padded
template <int HD>
__device__ __forceinline__ void stage(__nv_bfloat16* dst, const __nv_bfloat16* src, int rows,
                                      int nrows_pad, int C) {
  constexpr int CH = HD / 8;
  for (int c = threadIdx.x; c < nrows_pad * CH; c += blockDim.x) {
    const int r = c / CH, d = (c % CH) * 8;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (r < rows) u = *reinterpret_cast<const uint4*>(src + (long long)r * C + d);
    *reinterpret_cast<uint4*>(dst + r * HD + d) = u;
  }
}

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragAT = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragBT = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// the 16x16 tile (rows r0.., cols j*16..) of g V^T into this warp's scratch T
template <int HD>
__device__ __forceinline__ void dp_tile(const __nv_bfloat16* gs, const __nv_bfloat16* vs, int r0,
                                        int j, float* T) {
  FragC acc;
  wmma::fill_fragment(acc, 0.f);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    FragA a;
    FragBT b;
    wmma::load_matrix_sync(a, gs + r0 * HD + kk * 16, HD);
    wmma::load_matrix_sync(b, vs + j * 16 * HD + kk * 16, HD);
    wmma::mma_sync(acc, a, b, acc);
  }
  wmma::store_matrix_sync(T, acc, 16, wmma::mem_row_major);
  __syncwarp();
}

// the tile (jt, dt) of X^T Y with X (kRows, Np) bf16 (stride Np) and Y
// (kRows, HD) bf16: out rows jt*16.., cols dt*16.., into scratch T
template <int HD>
__device__ __forceinline__ void xt_y_tile(const __nv_bfloat16* X, const __nv_bfloat16* Y, int Np,
                                          int jt, int dt, float* T) {
  FragC acc;
  wmma::fill_fragment(acc, 0.f);
#pragma unroll
  for (int kk = 0; kk < kRows / 16; ++kk) {
    FragAT a;
    FragB b;
    wmma::load_matrix_sync(a, X + kk * 16 * Np + jt * 16, Np);
    wmma::load_matrix_sync(b, Y + kk * 16 * HD + dt * 16, HD);
    wmma::mma_sync(acc, a, b, acc);
  }
  wmma::store_matrix_sync(T, acc, 16, wmma::mem_row_major);
  __syncwarp();
}

// scratch tile T (16x16 f32) → bf16 rows [row0, row0+16) ∩ [0, rows) of dst
// (stride C), columns col0..col0+15
__device__ __forceinline__ void write_tile(const float* T, __nv_bfloat16* dst, int row0, int rows,
                                           int C, int col0, float post_scale) {
  const int lane = threadIdx.x & 31;
  for (int e = lane; e < 256; e += 32) {
    const int r = e / 16, c = e % 16;
    if (row0 + r < rows) {
      float v = T[e];
      if (post_scale != 1.f) v = vss::round_bf16(v) * post_scale;
      dst[(long long)(row0 + r) * C + col0 + c] = __float2bfloat16_rn(v);
    }
  }
  __syncwarp();
}

// p of one query row from the forward's probabilities, f32 or bf16
__device__ __forceinline__ float load_p(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load_p(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}

// PT = void: the softmax recomputed from q, K, bias and mask; PT = float or
// __nv_bfloat16: p read from probs (G, nh, Lq, N) of that type
template <int HD, typename PT>
__global__ void __launch_bounds__(32 * kWarps) attention_bwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
    const float* __restrict__ mask, const void* __restrict__ probs,
    const __nv_bfloat16* __restrict__ g,
    __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, float* __restrict__ dbias_partial, int G, int Lq, int N,
    int nh, int C, float q_scale, int tw) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem L(N, HD);
  const int Np = L.Np;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + L.q_off());
  __nv_bfloat16* gs = reinterpret_cast<__nv_bfloat16*>(smem + L.g_off());
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + L.k_off());
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + L.v_off());
  float* S = reinterpret_cast<float*>(smem + L.s_off());
  __nv_bfloat16* Pb = reinterpret_cast<__nv_bfloat16*>(smem + L.p_off());
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  float* T = reinterpret_cast<float*>(smem + L.t_off()) + warp * 256;
  const int h = blockIdx.y;
  const int tile = blockIdx.x;
  const int r0 = warp * 16;
  float* dbias = dbias_partial + ((long long)tile * nh + h) * Lq * N;
  const int w_end = min((tile + 1) * tw, G);

  for (int wi = tile * tw; wi < w_end; ++wi) {
    // ---- stage qs, g, K, V (head slices) ------------------------------------
    stage<HD>(qs, q + (long long)wi * Lq * C + h * HD, Lq, kRows, C);
    stage<HD>(gs, g + (long long)wi * Lq * C + h * HD, Lq, kRows, C);
    stage<HD>(ks, k + (long long)wi * N * C + h * HD, N, Np, C);
    stage<HD>(vs, v + (long long)wi * N * C + h * HD, N, Np, C);
    __syncthreads();
    for (int c = threadIdx.x * 8; c < kRows * HD; c += blockDim.x * 8) {
      float f[8];
      vss::load8(qs + c, f);
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] *= q_scale;
      vss::store8(qs + c, f);
    }
    __syncthreads();

    constexpr bool kFromProbs = !std::is_void<PT>::value;
    if constexpr (kFromProbs) {
      // ---- p from the forward: f32 in S and bf16 in Pb, zero past Lq and N --
      const PT* pw = static_cast<const PT*>(probs) + ((long long)wi * nh + h) * Lq * N;
      for (int u = 0; u < 16; ++u) {
        const int row = r0 + u;
        float* Sr = S + (size_t)row * Np;
        __nv_bfloat16* Pr = Pb + (size_t)row * Np;
        for (int n = lane; n < Np; n += 32) {
          const float p = row < Lq && n < N ? load_p(pw, (long long)row * N + n) : 0.f;
          Sr[n] = p;
          Pr[n] = __float2bfloat16_rn(p);
        }
      }
      __syncthreads();
    } else {
      // ---- S = qs K^T for this warp's 16 rows ----------------------------------
      {
        FragA a[HD / 16];
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) wmma::load_matrix_sync(a[kk], qs + r0 * HD + kk * 16, HD);
        for (int j = 0; j < Np / 16; ++j) {
          FragC acc;
          wmma::fill_fragment(acc, 0.f);
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk) {
            FragBT b;
            wmma::load_matrix_sync(b, ks + j * 16 * HD + kk * 16, HD);
            wmma::mma_sync(acc, a[kk], b, acc);
          }
          wmma::store_matrix_sync(S + (size_t)r0 * Np + j * 16, acc, Np, wmma::mem_row_major);
        }
      }
      __syncwarp();

      // ---- p = softmax((S + bias) + mask), f32 in S and bf16 in Pb -------------
      for (int u = 0; u < 16; ++u) {
        const int row = r0 + u;
        float* Sr = S + (size_t)row * Np;
        __nv_bfloat16* Pr = Pb + (size_t)row * Np;
        if (row >= Lq) {
          for (int n = lane; n < Np; n += 32) {
            Sr[n] = 0.f;
            Pr[n] = __float2bfloat16_rn(0.f);
          }
          continue;
        }
        const float* br = bias + ((long long)h * Lq + row) * N;
        const float* mr = mask + (long long)wi * N;
        float mx = -3.402823466e38f;
        for (int n = lane; n < N; n += 32) {
          const float sv = (Sr[n] + br[n]) + mr[n];
          Sr[n] = sv;
          mx = fmaxf(mx, sv);
        }
        mx = vss::warp_max(mx);
        float sum = 0.f;
        for (int n = lane; n < N; n += 32) {
          const float e = expf(Sr[n] - mx);
          Sr[n] = e;
          sum += e;
        }
        sum = vss::warp_sum(sum);
        for (int n = lane; n < Np; n += 32) {
          const float p = n < N ? Sr[n] / sum : 0.f;
          Sr[n] = p;
          Pr[n] = __float2bfloat16_rn(p);
        }
      }
      __syncthreads();
    }

    // ---- dV = bf16(p)^T g ----------------------------------------------------
    for (int t = warp; t < (Np / 16) * (HD / 16); t += kWarps) {
      const int jt = t / (HD / 16), dt = t % (HD / 16);
      xt_y_tile<HD>(Pb, gs, Np, jt, dt, T);
      write_tile(T, dv + (long long)wi * N * C + h * HD, jt * 16, N, C, dt * 16, 1.f);
    }

    // ---- r = sum_n dP p for this warp's rows (lane u < 16 holds row r0 + u) --
    float r = 0.f;
    for (int j = 0; j < Np / 16; ++j) {
      dp_tile<HD>(gs, vs, r0, j, T);
      if (lane < 16) {
        const float* Sr = S + (size_t)(r0 + lane) * Np + j * 16;
#pragma unroll
        for (int c = 0; c < 16; ++c) r += T[lane * 16 + c] * Sr[c];
      }
      __syncwarp();
    }
    __syncthreads();  // every warp is done reading Pb as p

    // ---- ds = p (dP - r): f32 in S, bf16 in Pb -----------------------------
    for (int j = 0; j < Np / 16; ++j) {
      dp_tile<HD>(gs, vs, r0, j, T);
      for (int e = lane; e < 256; e += 32) {
        const int rr = e / 16, cc = e % 16;
        const float rv = __shfl_sync(0xffffffffu, r, rr);
        const size_t idx = (size_t)(r0 + rr) * Np + j * 16 + cc;
        const float ds = S[idx] * (T[e] - rv);
        S[idx] = ds;
        Pb[idx] = __float2bfloat16_rn(ds);
      }
      __syncwarp();
    }

    // ---- dq = bf16(bf16(ds) K) * scale, rounded --------------------------------
    for (int dt = 0; dt < HD / 16; ++dt) {
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < Np / 16; ++kk) {
        FragA a;
        FragB b;
        wmma::load_matrix_sync(a, Pb + (size_t)r0 * Np + kk * 16, Np);
        wmma::load_matrix_sync(b, ks + kk * 16 * HD + dt * 16, HD);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(T, acc, 16, wmma::mem_row_major);
      __syncwarp();
      write_tile(T, dq + (long long)wi * Lq * C + h * HD, r0, Lq, C, dt * 16, q_scale);
    }
    __syncthreads();  // every warp's ds rows are in Pb

    // ---- dK = bf16(ds)^T qs --------------------------------------------------
    for (int t = warp; t < (Np / 16) * (HD / 16); t += kWarps) {
      const int jt = t / (HD / 16), dt = t % (HD / 16);
      xt_y_tile<HD>(Pb, qs, Np, jt, dt, T);
      write_tile(T, dk + (long long)wi * N * C + h * HD, jt * 16, N, C, dt * 16, 1.f);
    }

    // ---- dbias partial += ds -------------------------------------------------
    const bool first = wi == tile * tw;
    for (int e = threadIdx.x; e < Lq * N; e += blockDim.x) {
      const float ds = S[(size_t)(e / N) * Np + e % N];
      dbias[e] = first ? ds : dbias[e] + ds;
    }
    __syncthreads();
  }
}

template <int HD, typename PT>
int launch(const void* q, const void* k, const void* v, const void* bias, const void* mask,
           const void* probs, const void* g, void* dq, void* dk, void* dv, void* partial, int G,
           int Lq, int N, int nh, int C, float q_scale, int tw, cudaStream_t s) {
  const size_t bytes = Smem(N, HD).bytes();
  cudaError_t e = cudaFuncSetAttribute(attention_bwd_kernel<HD, PT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((G + tw - 1) / tw, nh);
  attention_bwd_kernel<HD, PT><<<grid, 32 * kWarps, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
      static_cast<const float*>(mask), probs, static_cast<const __nv_bfloat16*>(g),
      static_cast<__nv_bfloat16*>(dq), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), static_cast<float*>(partial), G, Lq, N, nh, C, q_scale,
      tw);
  return (int)cudaGetLastError();
}

}  // namespace

// q/g/dq (G, Lq, C) bf16, k/v/dk/dv (G, N, C) bf16 with C = nh*hd (head h
// owns channels [h*hd, (h+1)*hd)); bias (nh, Lq, N) f32; mask (G, N) f32;
// partial (ceil(G/tw), nh, Lq, N) f32 receives each window tile's dbias.
// hd in {32, 64}, Lq <= 64. q_scale is the attention scale rounded to bf16.
// Returns a cudaError_t.
VSS_EXPORT int attention_bwd(const void* q, const void* k, const void* v, const void* bias,
                             const void* mask, const void* g, void* dq, void* dk, void* dv,
                             void* partial, int G, int Lq, int N, int nh, int hd, int C,
                             float q_scale, int tw, int device, void* stream) {
  cudaSetDevice(device);
  if (G == 0 || Lq == 0) return 0;
  if (Lq > kRows || N < 1 || tw < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch<32, void>(q, k, v, bias, mask, nullptr, g, dq, dk, dv, partial, G, Lq, N, nh, C, q_scale, tw, s);
    case 64: return launch<64, void>(q, k, v, bias, mask, nullptr, g, dq, dk, dv, partial, G, Lq, N, nh, C, q_scale, tw, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The same gradients from the forward's probabilities probs (G, nh, Lq, N),
// bf16 when probs_bf16 else f32, in place of bias and mask.
VSS_EXPORT int attention_bwd_probs(const void* q, const void* k, const void* v,
                                   const void* probs, int probs_bf16, const void* g, void* dq,
                                   void* dk, void* dv, void* partial, int G, int Lq, int N,
                                   int nh, int hd, int C, float q_scale, int tw, int device,
                                   void* stream) {
  cudaSetDevice(device);
  if (G == 0 || Lq == 0) return 0;
  if (Lq > kRows || N < 1 || tw < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define VSS_BWD_P(HD, PT) \
  return launch<HD, PT>(q, k, v, nullptr, nullptr, probs, g, dq, dk, dv, partial, G, Lq, N, nh, C, q_scale, tw, s)
  if (hd == 32 && probs_bf16) VSS_BWD_P(32, __nv_bfloat16);
  if (hd == 32) VSS_BWD_P(32, float);
  if (hd == 64 && probs_bf16) VSS_BWD_P(64, __nv_bfloat16);
  if (hd == 64) VSS_BWD_P(64, float);
#undef VSS_BWD_P
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory one block needs; -1 when Lq exceeds the 64 rows held.
VSS_EXPORT int attention_bwd_smem_bytes(int N, int hd, int Lq) {
  return Lq > kRows ? -1 : (int)Smem(N, hd).bytes();
}
