// Tile GEMM with a fused LayerNorm prologue and a bias / residual epilogue:
//
//     out = [LN(A) | A] · W + bias [+ res]        (W row-major (K, N), bf16)
//
// Part of the port of the TPU kernel vss_cffm_tpu/ops/stage_block.py:
// mit_block_fused (_kernel), which computes a whole MiT block per (frame,
// row tile) in VMEM. Its working set does not fit one H100 block's 227 KB of
// shared memory at stage 3 (the hidden map alone is >= 245 KB in bf16 for a
// single row), so on this card the block is a short sequence of hand-written
// launches: this GEMM serves q = LN1(x)·Wq + bq, y = x + ctx·Wproj + bproj,
// hid = LN2(y)·W1 + b1 and out = y + a·W2 + b2; attention.cu serves the
// softmax(q·(s·K)ᵀ)·V step and dwconv.cu the depthwise conv + GELU.
//
// Bound on the H100: tensor-core operations at the MiT block's shapes
// (M = frames·H·W rows, K and N = 128..1280), the bytes are a few MB per
// launch. Design (right and simple first): 64x64 output tile per block of 4
// warps, each warp a 32x32 sub-tile of bf16 wmma 16x16x16 products with f32
// accumulation; K is walked in steps of 32 through shared memory, staged
// with 16-byte loads that fetch the next step into registers while the
// current one is multiplied. The LayerNorm statistics (f32 mean, then the
// mean squared deviation, like the reference) are computed once per row by
// the block before the K loop (each warp walks its 16 rows together), and
// the normalised row is rounded to bf16 as it is staged, so LN1 / LN2 never
// reach device memory. The epilogue adds the f32 bias and the residual in
// f32 and writes bf16 or f32.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64, BN = 64, BK = 32, THREADS = 128;
constexpr int LDA = BK + 8, LDB = BN + 8, LDC = BN + 4;
constexpr int A_CHUNKS = BM * BK / 8 / THREADS, W_CHUNKS = BK * BN / 8 / THREADS;
constexpr int KMAX_LN = 2048;  // LayerNorm gamma / beta staged in shared memory

template <typename TA>
__global__ void __launch_bounds__(THREADS) gemm_kernel(
    const TA* __restrict__ A, const float* __restrict__ gamma, const float* __restrict__ beta,
    const __nv_bfloat16* __restrict__ W, const float* __restrict__ bias,
    const void* __restrict__ res, void* __restrict__ out, int M, int N, int K, int ln,
    int res_kind, int out_f32, float eps) {
  __shared__ __align__(128) __nv_bfloat16 As[BM * LDA];
  __shared__ __align__(128) __nv_bfloat16 Bs[BK * LDB];
  __shared__ __align__(128) float Cs[BM * LDC];
  __shared__ float mu[BM], rs[BM];
  __shared__ __align__(16) float gs[KMAX_LN], bs[KMAX_LN];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long m0 = (long long)blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  if (ln) {
    for (int k = tid; k < K; k += THREADS) {
      gs[k] = gamma[k];
      bs[k] = beta[k];
    }
    // LayerNorm statistics of the warp's 16 rows, walked together so that
    // each lane has 16 independent loads in flight
    const int r0 = warp * 16;
    float sum[16], mean[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) sum[u] = 0.f;
    for (int k = lane; k < K; k += 32) {
#pragma unroll
      for (int u = 0; u < 16; ++u)
        if (m0 + r0 + u < M) sum[u] += static_cast<float>(A[(m0 + r0 + u) * K + k]);
    }
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      mean[u] = vss::warp_sum(sum[u]) / K;
      sum[u] = 0.f;
    }
    for (int k = lane; k < K; k += 32) {
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        if (m0 + r0 + u < M) {
          const float d = static_cast<float>(A[(m0 + r0 + u) * K + k]) - mean[u];
          sum[u] += d * d;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const float rstd = rsqrtf(vss::warp_sum(sum[u]) / K + eps);
      if (lane == 0) {
        const bool valid = m0 + r0 + u < M;
        mu[r0 + u] = valid ? mean[u] : 0.f;
        rs[r0 + u] = valid ? rstd : 0.f;
      }
    }
    __syncthreads();
  }

  const int wm = warp / 2, wn = warp % 2;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // The next K step's tiles are loaded into registers while the tensor
  // cores work on the current one from shared memory.
  float fa[A_CHUNKS][8];
  uint4 uw[W_CHUNKS];
  auto load_tiles = [&](int k0) {
#pragma unroll
    for (int u = 0; u < A_CHUNKS; ++u) {
      const int c = tid + u * THREADS;
      const int r = c / (BK / 8), gk = k0 + (c % (BK / 8)) * 8;
      const long long gm = m0 + r;
      if (gm < M && gk < K) {
        vss::load8(A + gm * K + gk, fa[u]);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) fa[u][i] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < W_CHUNKS; ++u) {
      const int c = tid + u * THREADS;
      const int gk = k0 + c / (BN / 8), gn = n0 + (c % (BN / 8)) * 8;
      uw[u] = make_uint4(0, 0, 0, 0);
      if (gk < K && gn < N) uw[u] = *reinterpret_cast<const uint4*>(W + (long long)gk * N + gn);
    }
  };
  auto store_tiles = [&](int k0) {
#pragma unroll
    for (int u = 0; u < A_CHUNKS; ++u) {
      const int c = tid + u * THREADS;
      const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8, gk = k0 + kc;
      if (ln && m0 + r < M && gk < K) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          fa[u][i] = (fa[u][i] - mu[r]) * rs[r] * gs[gk + i] + bs[gk + i];
      }
      vss::store8(As + r * LDA + kc, fa[u]);
    }
#pragma unroll
    for (int u = 0; u < W_CHUNKS; ++u) {
      const int c = tid + u * THREADS;
      *reinterpret_cast<uint4*>(Bs + (c / (BN / 8)) * LDB + (c % (BN / 8)) * 8) = uw[u];
    }
  };

  load_tiles(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    store_tiles(k0);
    __syncthreads();
    if (k0 + BK < K) load_tiles(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16, acc[i][j],
                              LDC, wmma::mem_row_major);
  __syncthreads();

  for (int c = tid; c < BM * BN / 8; c += THREADS) {
    const int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
    const long long gm = m0 + r;
    const int gn = n0 + nc;
    if (gm >= M || gn >= N) continue;
    float f[8], b[8];
    vss::load8(bias + gn, b);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = Cs[r * LDC + nc + i] + b[i];
    const long long off = gm * N + gn;
    if (res_kind) {
      float rv[8];
      if (res_kind == 1)
        vss::load8(static_cast<const __nv_bfloat16*>(res) + off, rv);
      else
        vss::load8(static_cast<const float*>(res) + off, rv);
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = f[i] + rv[i];
    }
    if (out_f32)
      vss::store8(static_cast<float*>(out) + off, f);
    else
      vss::store8(static_cast<__nv_bfloat16*>(out) + off, f);
  }
}

}  // namespace

// A (M, K) bf16 or f32 (a_f32); gamma/beta (K,) f32, read when ln != 0
// (then K <= 2048);
// W (K, N) bf16 row-major; bias (N,) f32; res (M, N): none (res_kind 0),
// bf16 (1) or f32 (2); out (M, N) bf16 or f32 (out_f32). K % 8 == 0 and
// N % 8 == 0, pointers 16-byte aligned (checked by the Python wrapper).
VSS_EXPORT int gemm_ln_bias_res(const void* A, const void* gamma, const void* beta,
                                const void* W, const void* bias, const void* res, void* out,
                                int M, int N, int K, int a_f32, int ln, int res_kind,
                                int out_f32, float eps, int device, void* stream) {
  cudaSetDevice(device);
  if (M == 0 || N == 0) return 0;
  if (ln && K > KMAX_LN) return (int)cudaErrorInvalidValue;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(W);
  const float* bi = static_cast<const float*>(bias);
  if (a_f32)
    gemm_kernel<float><<<grid, THREADS, 0, s>>>(static_cast<const float*>(A), g, b, w, bi, res,
                                            out, M, N, K, ln, res_kind, out_f32, eps);
  else
    gemm_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(static_cast<const __nv_bfloat16*>(A), g,
                                                    b, w, bi, res, out, M, N, K, ln, res_kind,
                                                    out_f32, eps);
  return (int)cudaGetLastError();
}
