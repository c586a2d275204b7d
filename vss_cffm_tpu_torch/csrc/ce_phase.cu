// Cross-entropy on x s bilinear-upsampled logits (align_corners = False) with
// the labels in the TPU kernels' phase layouts, indexed by source pixel.
//
// Replaces the TPU kernels vss_cffm_tpu/ops/ce_upsampled.py:
//   _ce_bwd_loss_pallas (_bwd_loss_kernel, "v2"): f32 dlogits from labels in
//       the h-major phase layout (N, h, s*s, w), phases unrolled;
//   _ce_fwd_loss_pallas5 (_fwd_loss_kernel5, "v5"): (img_w * sum over valid
//       pixels of lse(up) - up[label], count of valid pixels whose label's
//       logit is the max) from labels in the w-major phase layout
//       (N, h, w, s*s), phases unrolled;
//   _ce_fwd_loss_pallas3 (_fwd_loss_kernel3, "v3"): the same with the phases
//       as a runtime loop whose coefficients come from the loop index
//       (_phase_coeff_dyn: d = (p + 0.5) / s - 0.5 in f32);
//   _ce_bwd_loss_pallas3 (_bwd_loss_kernel3, "v3"): f32 dlogits from w-major
//       labels, phases as a runtime loop.
// They compute the functions of csrc/ce_upsampled.cu's loss pair (rows 14
// and 17), whose labels are in natural layout: dlogits = the adjoint of the
// upsample applied to g[0] * img_w * (softmax(up) - onehot) on the valid
// pixels (0 <= label < C), the softmax recomputed. Phase p = ph * s + pw of
// source pixel (k, v) is output pixel (s k + ph, s v + pw); it reads source
// rows clamp(k + d_ph), clamp(k + d_ph + 1) and columns clamp(v + d_pw),
// clamp(v + d_pw + 1), all within the 3 x 3 neighbourhood of (k, v).
//
// Bound on the H100 at the train step (N 8, h = w = 120, C 124, s 4): as
// for rows 14 and 17, C exps for every valid output pixel (228.5 M), which
// the MUFU needs ~55 us for, against ~10-30 us for the bytes (bf16 logits
// read, f32 dlogits written): bound by operations.
// Design: one warp per (frame, source row, segment of source columns), each
// lane holding the classes lane + 32 j in registers. The warp slides a 3 x 3
// window of source logits along its segment; for each source pixel it forms
// the s row lerps of three columns, then each of its s*s output pixels from
// them, with max, sum of exp and the label pick as warp shuffles. Labels:
// lane i loads those of the segment's column i in the layout given, s*s
// contiguous values (one 128-bit load for uint8 at s = 4) in w-major, s*s
// rows of w values, coalesced across the warp, in h-major; a pixel's label is
// a shuffle from its column's lane. That needs the phase index at compile
// time: the unrolled variants (template S, s in {2, 4}) hold the labels in
// registers; the runtime-loop variants (S = 0, #pragma unroll 1, any s in
// 1..8) read each label from global memory (L1), every lane the same byte.
// Unrolling is the Hopper form of the TPU's unroll-vs-fori_loop question:
// register pressure and occupancy in place of VMEM live sets.
// Forward: per-warp partial (img_w * sum, count) pairs, reduced by one
// torch.sum outside; no atomics. Backward: a warp owns 30 source columns of
// one source row, walks the source pixels of rows k-1..k+1 and columns one
// past its segment on each side (32 = one per lane), and adds each output
// pixel's t into the f32 dlogits of the source pixels it reads that the
// warp owns, in its own slice of shared memory, in a fixed order; each
// output pixel's softmax is recomputed by every warp that owns one of its
// source pixels (about 2-2.5 times). Nothing pixel-sized is written to HBM.
#include <string.h>

#include <type_traits>

#include "ce_common.cuh"

namespace {

using vss::ce::clampi;
using vss::ce::class_max;
using vss::ce::softmax_stats;

constexpr int kWarps = 4;
constexpr int kFwdSeg = 32;  // source columns of a forward warp: lane i <-> column i
constexpr int kBwdSeg = 30;  // of a backward warp; with one halo column each side, 32
constexpr int kMaxScale = 8;
using Label = unsigned char;  // uint8 labels (the bench's and the train batch's)

// (delta, f) of phase p: up[s k + p] = (1 - f) x[k + delta] + f x[k + delta + 1].
// S > 0: from the compile-time phase, in double then rounded (the TPU v2/v5
// kernels' Python floats); S = 0: from the loop index in f32 (v3).
template <int S>
__device__ __forceinline__ void phase_coeff(int p, int s, int& delta, float& f) {
  if constexpr (S > 0) {
    const double d = (p + 0.5) / S - 0.5;
    delta = d < 0.0 ? -1 : 0;
    f = (float)(d - delta);
  } else {
    const float d = ((float)p + 0.5f) / (float)s - 0.5f;
    delta = d < 0.f ? -1 : 0;
    f = d - (float)delta;
  }
}

// body(p) for the s phases: unrolled at compile time (S > 0) or a runtime loop
template <int S, typename F>
__device__ __forceinline__ void for_phases(int s, F&& body) {
  if constexpr (S > 0) {
#pragma unroll
    for (int p = 0; p < S; ++p) body(p);
  } else {
#pragma unroll 1
    for (int p = 0; p < s; ++p) body(p);
  }
}

// column `col` of the 3 x 3 window: rows (k-1, k, k+1) at source column v
template <int CPL>
__device__ __forceinline__ void load_col(float (&win)[3][3][CPL], int col,
                                         const __nv_bfloat16* const (&rows)[3], int v, int C,
                                         int lane) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const __nv_bfloat16* p = rows[r] + (long long)v * C;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = lane + 32 * j;
      win[r][col][j] = c < C ? __bfloat162float(p[c]) : 0.f;
    }
  }
}

template <int CPL>
__device__ __forceinline__ void slide(float (&win)[3][3][CPL]) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      win[r][0][j] = win[r][1][j];
      win[r][1][j] = win[r][2][j];
    }
}

// the row lerp of the window's three columns: rows (k-1, k) when the
// phase's delta < 0, else (k, k+1)
template <int CPL>
__device__ __forceinline__ void row_lerp(const float (&win)[3][3][CPL], bool neg, float f,
                                         float (&xh)[3][CPL]) {
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const float lo = neg ? win[0][c][j] : win[1][c][j];
      const float hi = neg ? win[1][c][j] : win[2][c][j];
      xh[c][j] = lo * (1.f - f) + hi * f;
    }
}

// the column lerp: columns (v-1, v) when delta < 0, else (v, v+1)
template <int CPL>
__device__ __forceinline__ void col_lerp(const float (&xh)[3][CPL], bool neg, float f,
                                         float (&up)[CPL]) {
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const float lo = neg ? xh[0][j] : xh[1][j];
    const float hi = neg ? xh[1][j] : xh[2][j];
    up[j] = lo * (1.f - f) + hi * f;
  }
}

// The S2 labels of source pixel (row, v) into lab, -1 where !in. W-major:
// S2 contiguous bytes, in 16- or 4-byte loads (S2 = 16 or 4); h-major: S2
// rows of w bytes (the warp's lanes read consecutive v).
template <int S2, bool WMAJOR>
__device__ __forceinline__ void load_labels(const Label* labels, long long row, int w, int v,
                                            bool in, int (&lab)[S2]) {
  static_assert(S2 % 4 == 0, "the unrolled phases: s = 2 or 4");
#pragma unroll
  for (int p = 0; p < S2; ++p) lab[p] = -1;
  if (!in) return;
  if constexpr (WMAJOR) {
    const Label* src = labels + (row * w + v) * S2;
    constexpr int kVec = S2 % 16 == 0 ? 16 : 4;  // bytes per load
    using Vec = std::conditional_t<kVec == 16, uint4, unsigned int>;
#pragma unroll
    for (int i = 0; i < S2 / kVec; ++i) {
      const Vec u = reinterpret_cast<const Vec*>(src)[i];
      Label e[kVec];
      memcpy(e, &u, kVec);
#pragma unroll
      for (int q = 0; q < kVec; ++q) lab[i * kVec + q] = e[q];
    }
  } else {
    const Label* src = labels + row * S2 * w + v;
#pragma unroll
    for (int p = 0; p < S2; ++p) lab[p] = src[(long long)p * w];
  }
}

// One warp per (frame n, source row k, segment of kFwdSeg source columns);
// partial[2 item] = (img_w * sum, count). S: 2 or 4 unrolled, 0 a runtime
// loop over s phases. Labels w-major.
template <int CPL, int S>
__global__ void __launch_bounds__(32 * kWarps) ce_phase_fwd_kernel(
    const __nv_bfloat16* __restrict__ x, const Label* __restrict__ labels,
    float* __restrict__ partial, int N, int h, int w, int C, int s, float img_w,
    int count_acc) {
  const int lane = threadIdx.x & 31;
  const int nseg = (w + kFwdSeg - 1) / kFwdSeg;
  const long long item = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (item >= (long long)N * h * nseg) return;
  if constexpr (S > 0) s = S;
  const int s2 = s * s;
  const int n = (int)(item / ((long long)h * nseg));
  const int k = (int)(item / nseg % h);
  const int v0 = (int)(item % nseg) * kFwdSeg;
  const int v1 = min(v0 + kFwdSeg, w) - 1;
  const long long row = (long long)n * h + k;
  const __nv_bfloat16* const rows[3] = {x + ((long long)n * h + clampi(k - 1, 0, h - 1)) * w * C,
                                        x + row * w * C,
                                        x + ((long long)n * h + clampi(k + 1, 0, h - 1)) * w * C};
  int lab[S > 0 ? S * S : 1];
  if constexpr (S > 0) load_labels<S * S, true>(labels, row, w, v0 + lane, v0 + lane <= v1, lab);

  float win[3][3][CPL];
  load_col<CPL>(win, 0, rows, max(v0 - 1, 0), C, lane);
  load_col<CPL>(win, 1, rows, v0, C, lane);
  load_col<CPL>(win, 2, rows, min(v0 + 1, w - 1), C, lane);
  float tot = 0.f, cor = 0.f;
  for (int v = v0; v <= v1; ++v) {
    for_phases<S>(s, [&](int ph) {
      int dh;
      float fh;
      phase_coeff<S>(ph, s, dh, fh);
      float xh[3][CPL];
      row_lerp<CPL>(win, dh < 0, fh, xh);
      for_phases<S>(s, [&](int pw) {
        int dw;
        float fw;
        phase_coeff<S>(pw, s, dw, fw);
        float up[CPL];
        col_lerp<CPL>(xh, dw < 0, fw, up);
        int label;
        if constexpr (S > 0)
          label = __shfl_sync(0xffffffffu, lab[ph * S + pw], v - v0);
        else
          label = (int)labels[(row * w + v) * s2 + ph * s + pw];
        const bool valid = label >= 0 && label < C;
        const float m = class_max<CPL>(up, C, lane);
        float sum, picked;
        softmax_stats<CPL>(up, m, C, lane, valid ? label : 0, sum, picked);
        if (valid) {
          tot += (m + logf(sum)) - picked;
          if (count_acc && picked == m) cor += 1.f;
        }
      });
    });
    slide<CPL>(win);
    load_col<CPL>(win, 2, rows, min(v + 2, w - 1), C, lane);
  }
  if (lane == 0) {
    partial[2 * item] = tot * img_w;
    partial[2 * item + 1] = cor;
  }
}

// One warp per (frame n, source row k, segment of kBwdSeg source columns);
// out (N, h, w, C) f32. Labels w-major (WMAJOR) or h-major; S as above.
template <int CPL, bool WMAJOR, int S>
__global__ void __launch_bounds__(32 * kWarps) ce_phase_bwd_kernel(
    const __nv_bfloat16* __restrict__ x, const Label* __restrict__ labels,
    const float* __restrict__ g, float* __restrict__ out, int N, int h, int w, int C, int s,
    float img_w) {
  extern __shared__ float acc_all[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x / 32;
  const int nseg = (w + kBwdSeg - 1) / kBwdSeg;
  const long long item = (long long)blockIdx.x * kWarps + warp;
  if (item >= (long long)N * h * nseg) return;
  if constexpr (S > 0) s = S;
  const int s2 = s * s;
  const int n = (int)(item / ((long long)h * nseg));
  const int k = (int)(item / nseg % h);
  const int v_lo = (int)(item % nseg) * kBwdSeg;
  const int v_hi = min(v_lo + kBwdSeg, w) - 1;
  constexpr int CP = 32 * CPL;
  float* acc = acc_all + (size_t)warp * kBwdSeg * CP;  // acc[(v - v_lo) * CP + class]
  for (int i = lane; i < kBwdSeg * CP; i += 32) acc[i] = 0.f;
  __syncwarp();
  const float ct = g[0] * img_w;
  const int vs = max(v_lo - 1, 0), ve = min(v_hi + 1, w - 1);  // at most 32 columns

  for (int kp = max(k - 1, 0); kp <= min(k + 1, h - 1); ++kp) {
    const long long row = (long long)n * h + kp;
    const __nv_bfloat16* const rows[3] = {
        x + ((long long)n * h + clampi(kp - 1, 0, h - 1)) * w * C, x + row * w * C,
        x + ((long long)n * h + clampi(kp + 1, 0, h - 1)) * w * C};
    int lab[S > 0 ? S * S : 1];
    if constexpr (S > 0)
      load_labels<S * S, WMAJOR>(labels, row, w, vs + lane, vs + lane <= ve, lab);
    float win[3][3][CPL];
    load_col<CPL>(win, 0, rows, max(vs - 1, 0), C, lane);
    load_col<CPL>(win, 1, rows, vs, C, lane);
    load_col<CPL>(win, 2, rows, min(vs + 1, w - 1), C, lane);
    for (int v = vs; v <= ve; ++v) {
      for_phases<S>(s, [&](int ph) {
        int dh;
        float fh;
        phase_coeff<S>(ph, s, dh, fh);
        const int r0 = clampi(kp + dh, 0, h - 1), r1 = clampi(kp + dh + 1, 0, h - 1);
        if (r0 != k && r1 != k) return;  // this output row does not read row k
        const float a = (r0 == k ? 1.f - fh : 0.f) + (r1 == k ? fh : 0.f);
        float xh[3][CPL];
        row_lerp<CPL>(win, dh < 0, fh, xh);
        for_phases<S>(s, [&](int pw) {
          int dw;
          float fw;
          phase_coeff<S>(pw, s, dw, fw);
          int label;
          if constexpr (S > 0)
            label = __shfl_sync(0xffffffffu, lab[ph * S + pw], v - vs);
          else if constexpr (WMAJOR)
            label = (int)labels[(row * w + v) * s2 + ph * s + pw];
          else
            label = (int)labels[(row * s2 + ph * s + pw) * w + v];
          const int c0 = clampi(v + dw, 0, w - 1), c1 = clampi(v + dw + 1, 0, w - 1);
          const bool in0 = c0 >= v_lo && c0 <= v_hi, in1 = c1 >= v_lo && c1 <= v_hi;
          if (!(in0 || in1) || label < 0 || label >= C) return;
          float up[CPL];
          col_lerp<CPL>(xh, dw < 0, fw, up);
          float sum, picked;
          softmax_stats<CPL>(up, class_max<CPL>(up, C, lane), C, lane, label, sum, picked);
          const float w0 = a * (1.f - fw), w1 = a * fw;
#pragma unroll
          for (int j = 0; j < CPL; ++j) {
            const int c = lane + 32 * j;
            if (c >= C) continue;
            const float t = ct * (up[j] / sum - (c == label ? 1.f : 0.f));
            if (in0) acc[(c0 - v_lo) * CP + c] += w0 * t;
            if (in1) acc[(c1 - v_lo) * CP + c] += w1 * t;
          }
        });
      });
      slide<CPL>(win);
      load_col<CPL>(win, 2, rows, min(v + 2, w - 1), C, lane);
    }
  }
  __syncwarp();
  float* orow = out + ((long long)n * h + k) * w * C;
  for (int v = v_lo; v <= v_hi; ++v)
    for (int c = lane; c < C; c += 32) orow[(long long)v * C + c] = acc[(v - v_lo) * CP + c];
}

template <int S>
int launch_fwd(const void* x, const void* labels, void* partial, int N, int h, int w, int C,
               int s, float img_w, int count_acc, cudaStream_t st) {
  const long long items = (long long)N * h * ((w + kFwdSeg - 1) / kFwdSeg);
  const unsigned blocks = (unsigned)((items + kWarps - 1) / kWarps);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* lb = static_cast<const Label*>(labels);
  auto* pb = static_cast<float*>(partial);
  const int cpl = (C + 31) / 32;
#define VSS_CE_PHASE_FWD(K) \
  ce_phase_fwd_kernel<K, S><<<blocks, 32 * kWarps, 0, st>>>(xb, lb, pb, N, h, w, C, s, img_w, count_acc)
  if (cpl <= 1) VSS_CE_PHASE_FWD(1);
  else if (cpl <= 2) VSS_CE_PHASE_FWD(2);
  else if (cpl <= 4) VSS_CE_PHASE_FWD(4);
  else if (cpl <= 8) VSS_CE_PHASE_FWD(8);
  else return (int)cudaErrorInvalidValue;
#undef VSS_CE_PHASE_FWD
  return (int)cudaGetLastError();
}

template <int CPL, bool WMAJOR, int S>
int launch_bwd_cpl(const void* x, const void* labels, const void* g, void* out, int N, int h,
                   int w, int C, int s, float img_w, cudaStream_t st) {
  const long long items = (long long)N * h * ((w + kBwdSeg - 1) / kBwdSeg);
  const unsigned blocks = (unsigned)((items + kWarps - 1) / kWarps);
  const size_t bytes = (size_t)kWarps * kBwdSeg * 32 * CPL * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(ce_phase_bwd_kernel<CPL, WMAJOR, S>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  ce_phase_bwd_kernel<CPL, WMAJOR, S><<<blocks, 32 * kWarps, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const Label*>(labels),
      static_cast<const float*>(g), static_cast<float*>(out), N, h, w, C, s, img_w);
  return (int)cudaGetLastError();
}

template <bool WMAJOR, int S>
int launch_bwd(const void* x, const void* labels, const void* g, void* out, int N, int h, int w,
               int C, int s, float img_w, cudaStream_t st) {
  const int cpl = (C + 31) / 32;
#define VSS_CE_PHASE_BWD(K) \
  return launch_bwd_cpl<K, WMAJOR, S>(x, labels, g, out, N, h, w, C, s, img_w, st)
  if (cpl <= 1) VSS_CE_PHASE_BWD(1);
  if (cpl <= 2) VSS_CE_PHASE_BWD(2);
  if (cpl <= 4) VSS_CE_PHASE_BWD(4);
  if (cpl <= 8) VSS_CE_PHASE_BWD(8);
#undef VSS_CE_PHASE_BWD
  return (int)cudaErrorInvalidValue;
}

int fwd_by_scale(const void* x, const void* labels, void* partial, int N, int h, int w, int C,
                 int s, int unrolled, float img_w, int count_acc, cudaStream_t st) {
  if (!unrolled) return launch_fwd<0>(x, labels, partial, N, h, w, C, s, img_w, count_acc, st);
  if (s == 2) return launch_fwd<2>(x, labels, partial, N, h, w, C, s, img_w, count_acc, st);
  if (s == 4) return launch_fwd<4>(x, labels, partial, N, h, w, C, s, img_w, count_acc, st);
  return (int)cudaErrorInvalidValue;
}

int bwd_by_variant(const void* x, const void* labels, const void* g, void* out, int N, int h,
                   int w, int C, int s, int w_major, int unrolled, float img_w, cudaStream_t st) {
  if (w_major && !unrolled)
    return launch_bwd<true, 0>(x, labels, g, out, N, h, w, C, s, img_w, st);
  if (!w_major && unrolled && s == 2)
    return launch_bwd<false, 2>(x, labels, g, out, N, h, w, C, s, img_w, st);
  if (!w_major && unrolled && s == 4)
    return launch_bwd<false, 4>(x, labels, g, out, N, h, w, C, s, img_w, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// logits (N, h, w, C) bf16; labels (N, h, w, s*s) uint8 in the w-major
// phase layout; partial (N * h * ceil(w / 32), 2) f32 receives (img_w * sum,
// count) per warp. unrolled: phases unrolled at compile time, s in {2, 4}
// (v5); else a runtime loop, 1 <= s <= 8 (v3). C <= 256. Returns a
// cudaError_t.
VSS_EXPORT int ce_phase_fwd_loss(const void* logits, const void* labels, void* partial, int N,
                                 int h, int w, int C, int s, int unrolled, float img_w,
                                 int count_acc, int device, void* stream) {
  vss::use_device(device);
  if ((long long)N * h * w == 0) return 0;
  if (s < 1 || s > kMaxScale || C < 1) return (int)cudaErrorInvalidValue;
  return fwd_by_scale(logits, labels, partial, N, h, w, C, s, unrolled, img_w, count_acc,
                      reinterpret_cast<cudaStream_t>(stream));
}

// dlogits (N, h, w, C) f32 for the cotangent g[0] (f32, on the device) of the
// forward's img_w-weighted sum. uint8 labels h-major (N, h, s*s, w) with the
// phases unrolled, s in {2, 4} (v2), or w-major (N, h, w, s*s) with a
// runtime loop, 1 <= s <= 8 (v3). C <= 256. Returns a cudaError_t.
VSS_EXPORT int ce_phase_bwd_loss(const void* logits, const void* labels, const void* g,
                                 void* out, int N, int h, int w, int C, int s, int w_major,
                                 int unrolled, float img_w, int device, void* stream) {
  vss::use_device(device);
  if ((long long)N * h * w == 0) return 0;
  if (s < 1 || s > kMaxScale || C < 1) return (int)cudaErrorInvalidValue;
  return bwd_by_variant(logits, labels, g, out, N, h, w, C, s, w_major, unrolled, img_w,
                        reinterpret_cast<cudaStream_t>(stream));
}
