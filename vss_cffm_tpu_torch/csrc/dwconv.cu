// 3x3 depthwise convolution + bias (+ exact erf GELU), NHWC, bf16 output.
//
// Replaces the TPU kernel vss_cffm_tpu/ops/dwconv.py:_dwconv3x3_pallas
// (_kernel): the MixFFN's depthwise conv of the composed MiT blocks, and the
// depthwise step inside the whole-block path (ops/stage_block.py), where its
// input is the f32 hidden map. In training it also writes the
// pre-activation z (bf16), the residual of the port's plain backward.
//
// Bound on the H100: memory. Each output reads 9 neighbouring input pixels
// but only one pass over x is needed from device memory; the work is 9 FMAs
// per element, far below the card's ~295 FLOP/byte ridge.
// Design: one thread owns one pixel x 8 channels, so every tap is one
// 16-byte load (bf16) or two (f32); neighbouring threads own neighbouring
// channel groups of the same pixel, so a warp's loads are contiguous, and
// the 9 taps of neighbouring pixels are served from L1/L2 rather than device
// memory. Accumulation, bias and GELU are f32 in registers; one 16-byte bf16
// store per thread. The image border is zero padding (taps outside skipped).
#include "common.cuh"

namespace {

template <typename T>
__global__ void dwconv3x3_kernel(const T* __restrict__ x, const float* __restrict__ w,
                                 const float* __restrict__ bias,
                                 __nv_bfloat16* __restrict__ out,
                                 __nv_bfloat16* __restrict__ z, int B, int H, int W,
                                 int C, int gelu) {
  const int c8 = C / 8;
  const long long total = (long long)B * H * W * c8;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int cg = (int)(idx % c8);
  const long long pix = idx / c8;
  const int j = (int)(pix % W);
  const long long t = pix / W;
  const int i = (int)(t % H);
  const long long bi = t / H;
  const int c0 = cg * 8;

  float acc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = 0.f;
#pragma unroll
  for (int di = 0; di < 3; ++di) {
    const int ii = i + di - 1;
    if (ii < 0 || ii >= H) continue;
#pragma unroll
    for (int dj = 0; dj < 3; ++dj) {
      const int jj = j + dj - 1;
      if (jj < 0 || jj >= W) continue;
      float v[8], wk[8];
      vss::load8(x + ((bi * H + ii) * W + jj) * C + c0, v);
      vss::load8(w + (di * 3 + dj) * C + c0, wk);
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[k] += v[k] * wk[k];
    }
  }
  float b[8];
  vss::load8(bias + c0, b);
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] += b[k];
  if (z != nullptr) vss::store8(z + pix * C + c0, acc);
  if (gelu) {
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = vss::gelu_erf(acc[k]);
  }
  vss::store8(out + pix * C + c0, acc);
}

}  // namespace

// x (B,H,W,C) bf16 or f32 (x_is_f32), w (9,C) f32 taps in (di,dj) row-major
// order, bias (C,) f32, out (B,H,W,C) bf16. C % 8 == 0, all pointers
// 16-byte aligned (checked by the Python wrapper). z (B,H,W,C) bf16 receives
// the pre-activation, or is null.
VSS_EXPORT int dwconv3x3_nhwc(const void* x, const void* w, const void* bias, void* out,
                              void* z, int B, int H, int W, int C, int x_is_f32, int gelu,
                              int device, void* stream) {
  cudaSetDevice(device);
  const long long total = (long long)B * H * W * (C / 8);
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (x_is_f32)
    dwconv3x3_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out),
        static_cast<__nv_bfloat16*>(z), B, H, W, C, gelu);
  else
    dwconv3x3_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out),
        static_cast<__nv_bfloat16*>(z), B, H, W, C, gelu);
  return (int)cudaGetLastError();
}
