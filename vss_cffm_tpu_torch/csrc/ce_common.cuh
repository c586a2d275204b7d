// Shared device helpers of the cross-entropy kernels on x s bilinear-upsampled
// logits (csrc/ce_upsampled.cu, csrc/ce_phase.cu): a warp holds one pixel's
// C <= 32*CPL classes, lane owning the classes lane + 32*j.
#pragma once

#include "common.cuh"

namespace vss {
namespace ce {

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// the largest of up over the warp's C classes
template <int CPL>
__device__ __forceinline__ float class_max(const float* up, int C, int lane) {
  float m = -3.402823466e38f;
#pragma unroll
  for (int j = 0; j < CPL; ++j)
    if (lane + 32 * j < C) m = fmaxf(m, up[j]);
  return vss::warp_max(m);
}

// Over the warp, given the row max m (class_max): up[label] (label in
// [0, C)) and the sum of exp(up - m); up[j] is replaced by exp(up[j] - m)
// (0 past C).
template <int CPL>
__device__ __forceinline__ void softmax_stats(float* up, float m, int C, int lane, int label,
                                              float& sum, float& picked) {
  float mine = 0.f;
#pragma unroll
  for (int j = 0; j < CPL; ++j)
    if (j == (label >> 5)) mine = up[j];
  picked = __shfl_sync(0xffffffffu, mine, label & 31);
  sum = 0.f;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    up[j] = lane + 32 * j < C ? expf(up[j] - m) : 0.f;
    sum += up[j];
  }
  sum = vss::warp_sum(sum);
}

}  // namespace ce
}  // namespace vss
