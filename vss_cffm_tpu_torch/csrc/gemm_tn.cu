// Sums over rows of Aᵀ·B, split over blocks, one f32 partial per split:
//
//     partial[split] = Σ_{rows r of the split} A[r, :]ᵀ · B'[r, :]
//     B' = bf16(B · s[r / rows_per_frame])   (without a scale: B)
//
// A (M, K1) and B (M, N) are contiguous bf16. The wrapper reduces the
// partials over the splits with one torch.sum, so the result repeats
// exactly run to run (no atomics).
//
// Part of the port of the TPU kernel vss_cffm_tpu/ops/stage_block.py:
// _mit_block_train_bwd (_train_bwd_kernel), and of the FFN-half backward
// vss_cffm_tpu/ops/mixffn.py:_block_ffn_bwd_pallas (_bwd_kernel_ln). Those
// kernels walk the (frame, row tile) grid in order and add each tile's
// weight-gradient products into revisited f32 output blocks; on the H100 the
// blocks run in parallel, so the row axis is split over blocks and the
// partials are reduced in a second pass. This GEMM serves every product
// that reduces over the rows of the block: dW2 = aᵀ·bf16(go·s_ffn), dW1 =
// ln2ᵀ·d_hid, dWproj = ctxᵀ·d_attn, dWq = ln1ᵀ·d_q over M = B·H·W rows (dK
// and dV are sra_attention_bwd.cu's own).
//
// Bound on the H100: the bytes of A and B (each read once; K1, N <= 1280,
// so the products are 2·K1·N flops per row pair of 2·(K1 + N) bytes, at or
// below the ~295 flop/byte ridge for the weight gradients) and, for small
// outputs, the partials. Design (right and simple first): a block of 4 warps
// owns one 64x64 tile of the (K1, N) output and one split
// of the rows; it walks the split 32 rows at a time, staging the A and B
// rows in shared memory with 16-byte loads, and each warp accumulates a
// 32x32 sub-tile with bf16 wmma 16x16x16 products, A read column-major (the
// transpose is free). The wrapper picks the number of splits so that about
// four blocks per SM are in flight.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BK1 = 64, BN = 64, BR = 32, THREADS = 128;
constexpr int LDA = BK1 + 8, LDB = BN + 8, LDC = BN + 4;

__global__ void __launch_bounds__(THREADS) gemm_tn_kernel(
    const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ B,
    const float* __restrict__ b_scale, float* __restrict__ partial, int M, int K1, int N,
    int rows_per_split, int rows_per_frame) {
  __shared__ __align__(128) __nv_bfloat16 As[BR * LDA];
  __shared__ __align__(128) __nv_bfloat16 Bs[BR * LDB];
  __shared__ __align__(128) float Cs[BK1 * LDC];

  const int tid = threadIdx.x, warp = tid / 32;
  const int tiles_n = (N + BN - 1) / BN;
  const int k0 = (blockIdx.x / tiles_n) * BK1, n0 = (blockIdx.x % tiles_n) * BN;
  const int split = blockIdx.y;
  const long long r_begin = (long long)split * rows_per_split;
  const long long r_end = min((long long)M, r_begin + rows_per_split);

  const int wm = warp / 2, wn = warp % 2;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (long long r0 = r_begin; r0 < r_end; r0 += BR) {
    // stage BR rows of A (K1 columns k0..) and of B (N columns n0..)
    for (int c = tid; c < BR * BK1 / 8; c += THREADS) {
      const int r = c / (BK1 / 8), kc = (c % (BK1 / 8)) * 8;
      uint4 u = make_uint4(0, 0, 0, 0);
      if (r0 + r < r_end && k0 + kc < K1)
        u = *reinterpret_cast<const uint4*>(A + (r0 + r) * K1 + k0 + kc);
      *reinterpret_cast<uint4*>(As + r * LDA + kc) = u;
    }
    for (int c = tid; c < BR * BN / 8; c += THREADS) {
      const int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
      uint4 u = make_uint4(0, 0, 0, 0);
      if (r0 + r < r_end && n0 + nc < N) {
        u = *reinterpret_cast<const uint4*>(B + (r0 + r) * N + n0 + nc);
        if (b_scale != nullptr) {
          const float sc = b_scale[(r0 + r) / rows_per_frame];
          float f[8];
          vss::load8(reinterpret_cast<const __nv_bfloat16*>(&u), f);
#pragma unroll
          for (int i = 0; i < 8; ++i) f[i] = f[i] * sc;
          vss::store8(reinterpret_cast<__nv_bfloat16*>(&u), f);
        }
      }
      *reinterpret_cast<uint4*>(Bs + r * LDB + nc) = u;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BR; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + kk * LDA + wm * 32 + i * 16, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
  float* out = partial + (long long)split * K1 * N;
  for (int c = tid; c < BK1 * BN / 8; c += THREADS) {
    const int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
    if (k0 + r >= K1 || n0 + nc >= N) continue;
    float f[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = Cs[r * LDC + nc + i];
    vss::store8(out + (long long)(k0 + r) * N + n0 + nc, f);
  }
}

}  // namespace

// A (M, K1) and B (M, N) bf16, contiguous; b_scale (ceil(M /
// rows_per_frame),) f32 or null; partial (ceil(M / rows_per_split), K1, N)
// f32. K1 and N multiples of 8, pointers 16-byte aligned (checked by the
// Python wrapper). Returns a cudaError_t.
VSS_EXPORT int gemm_tn(const void* A, const void* B, const void* b_scale, void* partial, int M,
                       int K1, int N, int rows_per_split, int rows_per_frame, int device,
                       void* stream) {
  vss::use_device(device);
  if (M == 0 || K1 == 0 || N == 0) return 0;
  if (rows_per_split < 1 || rows_per_frame < 1 || K1 % 8 || N % 8) return (int)cudaErrorInvalidValue;
  const int splits = (M + rows_per_split - 1) / rows_per_split;
  dim3 grid(((K1 + BK1 - 1) / BK1) * ((N + BN - 1) / BN), splits);
  gemm_tn_kernel<<<grid, THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(A), static_cast<const __nv_bfloat16*>(B),
      static_cast<const float*>(b_scale), static_cast<float*>(partial), M, K1, N,
      rows_per_split, rows_per_frame);
  return (int)cudaGetLastError();
}
