// Shared device helpers for the port's hand-written Hopper kernels.
//
// - bf16 <-> f32 conversion of 8-wide (16-byte) vectors;
// - exact erf GELU (erff), which matches the composed JAX path
//   (jax.nn.gelu(approximate=False));
// - warp sum / max reductions.
//
// Tensor-core products: gemm_tn.cu uses nvcuda::wmma 16x16x16 bf16 tiles
// (it includes <mma.h> itself); block_gemm.cu and the attention kernels use
// mma.sync m16n8k16 with ldmatrix (mma_sync.cuh). f32 accumulation in all.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define VSS_EXPORT extern "C" __attribute__((visibility("default")))

namespace vss {

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.7071067811865476f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 8 consecutive bf16 (one 16-byte load) -> 8 floats
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// 8 consecutive floats (two 16-byte loads) -> 8 floats
__device__ __forceinline__ void load8(const float* p, float* f) {
  float4 a = *reinterpret_cast<const float4*>(p);
  float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// 8 floats -> 8 consecutive bf16 (round to nearest even), one 16-byte store
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* f) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(f[4], f[5], f[6], f[7]);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Make `device` current for the launch; cudaGetDevice is a thread-local read,
// so a call on the device already current skips cudaSetDevice
inline void use_device(int device) {
  int cur = -1;
  if (cudaGetDevice(&cur) != cudaSuccess || cur != device) cudaSetDevice(device);
}

}  // namespace vss
