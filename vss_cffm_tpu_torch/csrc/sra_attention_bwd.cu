// Backward of the MiT block's spatial-reduction attention, per (frame, head,
// tile of 64 queries), with the softmax recomputed.
//
// Part of the port of the TPU kernel vss_cffm_tpu/ops/stage_block.py:
// _mit_block_train_bwd (_train_bwd_kernel, its attention backward): for the
// frame's queries q (bf16) against its S spatial-reduced keys, Ks = bf16(K ·
// scale) and V (bf16):
//
//   p    = softmax(q·Ksᵀ) over the S keys (f32),         written as bf16 p_b
//   d_p  = d_ctx·Vᵀ (f32),  r = Σ d_p∘p,  d_s = bf16(p∘(d_p − r)),  written
//   d_q  = d_s·Ks (f32),  written as bf16,  and per tile Σ d_q (dbq, f32)
//
// p_b and d_s are written (frame, head, query, Sp) with zeros past S, so that
// dV = p_bᵀ·d_ctx and dKᵀ = qᵀ·d_s, sums over all of a frame's queries, are
// gemm_tn.cu's row reductions; the TPU kernel instead adds per-tile dKᵀ and
// dV into revisited output blocks along its sequential grid.
//
// Bound on the H100: at the train step's stage 1 (14,400 queries per frame
// against 225 keys, head dim 64) the products are 3·2·64·225 flops per query
// and the bytes ~1.1 KB per query (q, d_ctx, d_q, p_b, d_s), so bytes bound
// it (~1 flop/byte per product). Design, as attention_bwd.cu: one block of 4
// warps per (64-query tile, head, frame) stages its q and d_ctx rows and the
// frame's whole K and V head slices in shared memory; each warp owns 16
// query rows for the scores (bf16 wmma tiles, f32 accumulation), the exact
// f32 softmax, d_p, d_s and d_q. d_p is computed twice, tile by tile (once
// for the row sums r, once to form d_s), so that only p is held in f32. One
// block of ~175 KB per SM at S = 225: latency, not bytes, bounds this first
// version.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 16 * kWarps;  // query rows of a tile

__host__ __device__ inline int round16(int n) { return (n + 15) / 16 * 16; }

// Layout (bytes) of the dynamic shared memory of one block; the Python
// wrapper's sra_attention_bwd_smem computes the same sum.
struct Smem {
  int Sp, hd;
  __host__ __device__ Smem(int S, int hd_) : Sp(round16(S)), hd(hd_) {}
  __host__ __device__ size_t k_off() const { return 0; }
  __host__ __device__ size_t v_off() const { return k_off() + (size_t)Sp * hd * 2; }
  __host__ __device__ size_t q_off() const { return v_off() + (size_t)Sp * hd * 2; }
  __host__ __device__ size_t g_off() const { return q_off() + (size_t)kRows * hd * 2; }
  __host__ __device__ size_t s_off() const { return g_off() + (size_t)kRows * hd * 2; }
  __host__ __device__ size_t p_off() const { return s_off() + (size_t)kRows * Sp * 4; }
  __host__ __device__ size_t t_off() const { return p_off() + (size_t)kRows * Sp * 2; }
  __host__ __device__ size_t d_off() const { return t_off() + (size_t)kWarps * 256 * 4; }
  __host__ __device__ size_t bytes() const { return d_off() + (size_t)kWarps * 64 * 4; }
};

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragBT = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// rows [0, rows) of a (·, C)-strided head slice → dst (nrows_pad, HD), zero padded
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

// the 16x16 tile (rows r0.., cols j*16..) of Y·Xᵀ, Y (kRows, HD) and X (Sp,
// HD) row-major, into this warp's scratch T
template <int HD>
__device__ __forceinline__ void yxt_tile(const __nv_bfloat16* Y, const __nv_bfloat16* X, int r0,
                                         int j, float* T) {
  FragC acc;
  wmma::fill_fragment(acc, 0.f);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    FragA a;
    FragBT b;
    wmma::load_matrix_sync(a, Y + r0 * HD + kk * 16, HD);
    wmma::load_matrix_sync(b, X + j * 16 * HD + kk * 16, HD);
    wmma::mma_sync(acc, a, b, acc);
  }
  wmma::store_matrix_sync(T, acc, 16, wmma::mem_row_major);
  __syncwarp();
}

template <int HD>
__global__ void __launch_bounds__(32 * kWarps) sra_attention_bwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ d_ctx,
    __nv_bfloat16* __restrict__ p_b, __nv_bfloat16* __restrict__ d_s,
    __nv_bfloat16* __restrict__ d_q, float* __restrict__ partial, int HW, int S, int nh, int C,
    float k_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem L(S, HD);
  const int Sp = L.Sp;
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + L.k_off());
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + L.v_off());
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + L.q_off());
  __nv_bfloat16* gs = reinterpret_cast<__nv_bfloat16*>(smem + L.g_off());
  float* Sf = reinterpret_cast<float*>(smem + L.s_off());
  __nv_bfloat16* Pb = reinterpret_cast<__nv_bfloat16*>(smem + L.p_off());
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  float* T = reinterpret_cast<float*>(smem + L.t_off()) + warp * 256;
  float* Dq = reinterpret_cast<float*>(smem + L.d_off());  // (kWarps, HD) column sums of d_q
  const int tile = blockIdx.x, h = blockIdx.y;
  const long long f = blockIdx.z;
  const int q0 = tile * kRows;
  const int rows = min(kRows, HW - q0);  // valid query rows of the tile
  const int r0 = warp * 16;
  const int nv = max(0, min(16, rows - r0));  // valid rows of this warp

  // ---- stage K, V (the frame's head slices), q and d_ctx rows -------------
  stage<HD>(ks, k + f * S * C + h * HD, S, Sp, C);
  stage<HD>(vs, v + f * S * C + h * HD, S, Sp, C);
  stage<HD>(qs, q + (f * HW + q0) * C + h * HD, rows, kRows, C);
  stage<HD>(gs, d_ctx + (f * HW + q0) * C + h * HD, rows, kRows, C);
  __syncthreads();
  // Ks = bf16(K · scale), as the reference scales K in its own dtype
  for (int c = threadIdx.x * 8; c < Sp * HD; c += blockDim.x * 8) {
    float x[8];
    vss::load8(ks + c, x);
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = x[i] * k_scale;
    vss::store8(ks + c, x);
  }
  __syncthreads();

  // ---- scores of this warp's 16 rows against all keys ----------------------
  for (int j = 0; j < Sp / 16; ++j) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      FragA a;
      FragBT b;
      wmma::load_matrix_sync(a, qs + r0 * HD + kk * 16, HD);
      wmma::load_matrix_sync(b, ks + j * 16 * HD + kk * 16, HD);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(Sf + (size_t)r0 * Sp + j * 16, acc, Sp, wmma::mem_row_major);
  }
  __syncwarp();

  // ---- p = softmax over the S keys: f32 in Sf, bf16 in Pb (0 past S) ------
  const long long prow0 = ((f * nh + h) * HW + q0) * Sp;  // p_b / d_s offset of the tile
  for (int u = 0; u < 16; ++u) {
    float* Sr = Sf + (size_t)(r0 + u) * Sp;
    __nv_bfloat16* Pr = Pb + (size_t)(r0 + u) * Sp;
    float mx = -3.402823466e38f;
    for (int n = lane; n < S; n += 32) mx = fmaxf(mx, Sr[n]);
    mx = vss::warp_max(mx);
    float sum = 0.f;
    for (int n = lane; n < S; n += 32) {
      const float e = expf(Sr[n] - mx);
      Sr[n] = e;
      sum += e;
    }
    sum = vss::warp_sum(sum);
    for (int n = lane; n < Sp; n += 32) {
      const float p = n < S ? Sr[n] / sum : 0.f;
      Sr[n] = p;
      Pr[n] = __float2bfloat16_rn(p);
    }
  }
  __syncwarp();
  for (int c = lane; c < nv * (Sp / 8); c += 32) {
    const int r = c / (Sp / 8), n = (c % (Sp / 8)) * 8;
    *reinterpret_cast<uint4*>(p_b + prow0 + (long long)(r0 + r) * Sp + n) =
        *reinterpret_cast<const uint4*>(Pb + (size_t)(r0 + r) * Sp + n);
  }

  // ---- r = Σ_n d_p·p for this warp's rows (lane u < 16 holds row r0 + u) --
  float rsum = 0.f;
  for (int j = 0; j < Sp / 16; ++j) {
    yxt_tile<HD>(gs, vs, r0, j, T);
    if (lane < 16) {
      const float* Sr = Sf + (size_t)(r0 + lane) * Sp + j * 16;
#pragma unroll
      for (int c = 0; c < 16; ++c) rsum += T[lane * 16 + c] * Sr[c];
    }
    __syncwarp();
  }

  // ---- d_s = bf16(p·(d_p − r)) into Pb ---------------------------------------
  for (int j = 0; j < Sp / 16; ++j) {
    yxt_tile<HD>(gs, vs, r0, j, T);
    for (int e = lane; e < 256; e += 32) {
      const int rr = e / 16, cc = e % 16;
      const float rv = __shfl_sync(0xffffffffu, rsum, rr);
      const size_t idx = (size_t)(r0 + rr) * Sp + j * 16 + cc;
      Pb[idx] = __float2bfloat16_rn(Sf[idx] * (T[e] - rv));
    }
    __syncwarp();
  }
  for (int c = lane; c < nv * (Sp / 8); c += 32) {
    const int r = c / (Sp / 8), n = (c % (Sp / 8)) * 8;
    *reinterpret_cast<uint4*>(d_s + prow0 + (long long)(r0 + r) * Sp + n) =
        *reinterpret_cast<const uint4*>(Pb + (size_t)(r0 + r) * Sp + n);
  }

  // ---- d_q = d_s·Ks (f32), written as bf16; column sums of the valid rows --
  for (int dt = 0; dt < HD / 16; ++dt) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < Sp / 16; ++kk) {
      FragA a;
      FragB b;
      wmma::load_matrix_sync(a, Pb + (size_t)r0 * Sp + kk * 16, Sp);
      wmma::load_matrix_sync(b, ks + kk * 16 * HD + dt * 16, HD);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(T, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int rr = e / 16, cc = e % 16;
      if (rr < nv)
        d_q[(f * HW + q0 + r0 + rr) * C + h * HD + dt * 16 + cc] = __float2bfloat16_rn(T[e]);
    }
    if (lane < 16) {
      float cs = 0.f;
      for (int rr = 0; rr < nv; ++rr) cs += T[rr * 16 + lane];
      Dq[warp * 64 + dt * 16 + lane] = cs;
    }
    __syncwarp();
  }
  __syncthreads();
  // the tile's Σ d_q, warps added in order
  for (int d = threadIdx.x; d < HD; d += blockDim.x) {
    float cs = 0.f;
    for (int w = 0; w < kWarps; ++w) cs += Dq[w * 64 + d];
    partial[((f * gridDim.x + tile) * nh + h) * HD + d] = cs;
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* d_ctx, void* p_b, void* d_s,
           void* d_q, void* partial, int B, int HW, int S, int nh, int C, float k_scale,
           cudaStream_t s) {
  const size_t bytes = Smem(S, HD).bytes();
  cudaError_t e = cudaFuncSetAttribute(sra_attention_bwd_kernel<HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((HW + kRows - 1) / kRows, nh, B);
  sra_attention_bwd_kernel<HD><<<grid, 32 * kWarps, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(d_ctx),
      static_cast<__nv_bfloat16*>(p_b), static_cast<__nv_bfloat16*>(d_s),
      static_cast<__nv_bfloat16*>(d_q), static_cast<float*>(partial), HW, S, nh, C, k_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, d_ctx, d_q (B·HW, C) bf16; k, v (B, S, C) bf16 (K unscaled; k_scale is
// the attention scale rounded to bf16); p_b, d_s (B, nh, HW, Sp) bf16 with Sp
// = S rounded up to 16; partial (B, ceil(HW / 64), nh, hd) f32. C = nh·hd,
// hd in {32, 64}. Returns a cudaError_t.
VSS_EXPORT int sra_attention_bwd(const void* q, const void* k, const void* v, const void* d_ctx,
                                 void* p_b, void* d_s, void* d_q, void* partial, int B, int HW,
                                 int S, int nh, int hd, int C, float k_scale, int device,
                                 void* stream) {
  cudaSetDevice(device);
  if (B == 0 || HW == 0) return 0;
  if (S < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch<32>(q, k, v, d_ctx, p_b, d_s, d_q, partial, B, HW, S, nh, C, k_scale, s);
    case 64: return launch<64>(q, k, v, d_ctx, p_b, d_s, d_q, partial, B, HW, S, nh, C, k_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
