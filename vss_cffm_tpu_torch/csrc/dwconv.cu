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
// Design: one thread owns 8 channels of one column and walks down a strip
// of rows. Each input row it loads (three 16-byte loads in bf16: columns
// j-1, j, j+1) is the last tap row of the output above it, the middle one of
// its own row and the first of the row below, so it is added into three
// running accumulators and never loaded again: 3 loads per output row
// instead of 9. Taps are added in the same (di, dj) order as the plain
// version. The 9 x 8 f32 taps and the bias are loaded once per thread and
// stay in registers; the next row's loads leave one step ahead of their use
// (168 registers, 3 blocks of 128 threads an SM); the image border is zero
// padding (zero values, so no branch). Neighbouring threads own neighbouring
// channel groups of one column, so a warp's loads and stores are contiguous.
// The wrapper sizes the strips per shape (ops/dwconv.py:strip_plan): the
// most strips whose blocks still fit one wave of resident blocks (5 rows at
// the 4-frame 15x15 maps, 40 at 120x120).
// Accumulation, bias and GELU are f32 in registers; one 16-byte bf16 store
// per output row (two with z).
#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // 168 registers a thread: 3 blocks an SM

template <typename T>
__device__ __forceinline__ void load_row(const T* row, int j, int W, int C, int c0, bool in,
                                         float (&v)[3][8]) {
#pragma unroll
  for (int dj = 0; dj < 3; ++dj) {
    const int jj = j + dj - 1;
    const bool ok = in && jj >= 0 && jj < W;
    vss::load8(row + (long long)(ok ? jj : j) * C + c0, v[dj]);
#pragma unroll
    for (int k = 0; k < 8; ++k) v[dj][k] = ok ? v[dj][k] : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 3) dwconv3x3_kernel(
    const T* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
    __nv_bfloat16* __restrict__ out, __nv_bfloat16* __restrict__ z, int B, int H, int W, int C,
    int rows, int strips, int gelu) {
  const int c8 = C / 8;
  const long long total = (long long)B * strips * W * c8;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int c0 = (int)(idx % c8) * 8;
  long long t = idx / c8;
  const int j = (int)(t % W);
  t /= W;
  const int strip = (int)(t % strips);
  const long long bi = t / strips;
  const int i0 = strip * rows, i1 = min(H, i0 + rows);
  const T* xb = x + bi * H * W * C;

  float wk[9][8], b[8];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) vss::load8(w + tap * C + c0, wk[tap]);
  vss::load8(bias + c0, b);

  // up: the output of the row above the loaded one (di = 0, 1 added so
  // far), mid: the loaded row's own output (di = 0), dn: the row below's
  float up[8], mid[8], dn[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) up[k] = mid[k] = 0.f;
  // nv: the next input row, loaded one step ahead of its use
  float nv[3][8];
  load_row(xb + (long long)(i0 > 0 ? i0 - 1 : i0) * W * C, j, W, C, c0, i0 > 0, nv);
  for (int r = i0 - 1; r <= i1; ++r) {
    float v[3][8];
#pragma unroll
    for (int dj = 0; dj < 3; ++dj)
#pragma unroll
      for (int k = 0; k < 8; ++k) v[dj][k] = nv[dj][k];
    const bool next_in = r + 1 < H && r + 1 <= i1;
    load_row(xb + (long long)(next_in ? r + 1 : i0) * W * C, j, W, C, c0, next_in, nv);
#pragma unroll
    for (int k = 0; k < 8; ++k) dn[k] = 0.f;
#pragma unroll
    for (int dj = 0; dj < 3; ++dj)
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        dn[k] += v[dj][k] * wk[dj][k];
        mid[k] += v[dj][k] * wk[3 + dj][k];
        up[k] += v[dj][k] * wk[6 + dj][k];
      }
    if (r - 1 >= i0) {  // row r - 1 has all its taps
      const long long o = ((bi * H + r - 1) * W + j) * C + c0;
#pragma unroll
      for (int k = 0; k < 8; ++k) up[k] += b[k];
      if (z != nullptr) vss::store8(z + o, up);
      if (gelu) {
#pragma unroll
        for (int k = 0; k < 8; ++k) up[k] = vss::gelu_erf(up[k]);
      }
      vss::store8(out + o, up);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      up[k] = mid[k];
      mid[k] = dn[k];
    }
  }
}

}  // namespace

// x (B,H,W,C) bf16 or f32 (x_is_f32), w (9,C) f32 taps in (di,dj) row-major
// order, bias (C,) f32, out (B,H,W,C) bf16. C % 8 == 0, all pointers
// 16-byte aligned (checked by the Python wrapper). z (B,H,W,C) bf16 receives
// the pre-activation, or is null. Each thread walks `rows` output rows of a
// strip; strips = ceil(H / rows). Returns a cudaError_t.
VSS_EXPORT int dwconv3x3_nhwc(const void* x, const void* w, const void* bias, void* out,
                              void* z, int B, int H, int W, int C, int rows, int x_is_f32,
                              int gelu, int device, void* stream) {
  vss::use_device(device);
  if (rows < 1 || C % 8 != 0) return (int)cudaErrorInvalidValue;
  const int strips = (H + rows - 1) / rows;
  const long long total = (long long)B * strips * W * (C / 8);
  if (total == 0) return 0;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (x_is_f32)
    dwconv3x3_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out),
        static_cast<__nv_bfloat16*>(z), B, H, W, C, rows, strips, gelu);
  else
    dwconv3x3_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out),
        static_cast<__nv_bfloat16*>(z), B, H, W, C, rows, strips, gelu);
  return (int)cudaGetLastError();
}

// The same arguments, nothing launched: the wrapper's host cost alone
// (chip_smoke.py times the wrapper with this entry in place of the one above).
VSS_EXPORT int dwconv3x3_nhwc_nolaunch(const void* x, const void* w, const void* bias, void* out,
                                       void* z, int B, int H, int W, int C, int rows,
                                       int x_is_f32, int gelu, int device, void* stream) {
  vss::use_device(device);
  return 0;
}
