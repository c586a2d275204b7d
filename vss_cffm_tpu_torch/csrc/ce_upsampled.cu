// Cross-entropy on x s bilinear-upsampled logits (align_corners = False),
// forward and backward, in two pairs.
//
// Replaces the TPU kernels vss_cffm_tpu/ops/ce_upsampled.py:
//   _ce_fwd_loss_pallas (_fwd_loss_kernel):  img_w * sum over valid pixels of
//       lse(up) - up[label], and the count of valid pixels whose label's
//       logit equals the pixel's max; nothing pixel-sized written;
//   _ce_bwd_loss_pallas5 (_bwd_loss_kernel5): dlogits = the adjoint of the
//       upsample applied to img_w * g * (softmax(up) - onehot) on the valid
//       pixels, the softmax recomputed;
//   _ce_fwd_pallas (_fwd_kernel): the per-pixel maps nll = lse(up) -
//       up[safe label], pred = the first maximum (torch's tie order) and lse,
//       f32 / int32 / f32 in natural (N, H, W) layout, for OHEM and class
//       weights, whose per-pixel weights the caller applies;
//   _ce_bwd_pallas (_bwd_kernel): dlogits = the adjoint of the upsample
//       applied to g[p] * (exp(up - lse[p]) - onehot(safe label)) with a
//       per-pixel cotangent g and the forward's lse.
// In the loss pair a label is valid when 0 <= label < C; the per-pixel pair
// picks class 0 for a label outside [0, C) (the safe label) and leaves its
// weight to the caller's g, as the TPU kernels do. Output row Y = s*k + p of the
// upsample reads source rows clamp(k + d_p) and clamp(k + d_p + 1) with
// weights (1 - f_p, f_p), d_p = (p + 0.5)/s - 0.5 floored to -1 or 0 and
// f_p = d_p - delta_p (ce_upsampled.py:57-64); columns likewise. Edge
// clamping puts both weights on the first / last row or column.
//
// Bound on the H100 at the train step (N 8, h = w = 120, C 124, s 4):
// reading the bf16 logits (and writing dlogits) is ~30-60 MB, ~10-17 us,
// but every output pixel takes C exps: 228.5 M exp per pass, which the
// MUFU (16 per SM per clock) needs ~60 us for. So the kernels are bound by
// operations, the exps and the warp reductions around them.
// The per-pixel pair does the same exps and writes 12 B per output pixel
// (nll, pred, lse; ~22 MB at the train step), reading lse and g back in the
// backward: still bound by the exps.
// Design: one warp walks one output row (forward) or one source row
// segment (backward); each lane holds the classes lane + 32*j in registers.
// The row-lerped logits of three neighbouring source columns stay in
// registers as the warp slides along the row, so each source value is
// loaded about twice per output row that uses it (from L1/L2), and the
// column phases of one source column share them. Max, sum of exp and the
// label pick are warp shuffles; each lane adds only its own classes.
// Forward: per-warp partial (img_w * sum, count) pairs, reduced by one
// torch.sum outside; no atomics, so the result is the same run to run.
// The per-pixel forward keeps each of 32 consecutive pixels' results in the
// lane of its column and writes them as one coalesced store per map.
// Backward: a warp owns a segment of source columns of one source row and
// accumulates that segment's dlogits in its own slice of shared memory,
// f32, in a fixed order, walking every output row that reads the source
// row (a source row is read by about 2s output rows, so each output pixel's
// softmax is recomputed about twice, plus s pixels at each segment edge),
// then writes each dlogits element once, in bf16.
#include "ce_common.cuh"

namespace {

using vss::ce::clampi;
using vss::ce::class_max;
using vss::ce::softmax_stats;

constexpr int kWarps = 4;
constexpr int kMaxScale = 8;
// source columns of one row that one backward warp owns
constexpr int kSeg = 30;

struct Coeffs {
  int delta[kMaxScale];
  float f[kMaxScale];
  __device__ Coeffs(int s) {
#pragma unroll
    for (int p = 0; p < kMaxScale; ++p) {
      const double d = (p + 0.5) / s - 0.5;
      delta[p] = d < 0.0 ? -1 : 0;
      f[p] = (float)(d - delta[p]);
    }
  }
};

// xh[j] = x0[c]*(1 - fh) + x1[c]*fh at column v, class c = lane + 32 j
template <int CPL>
__device__ __forceinline__ void load_row_lerp(const __nv_bfloat16* x0, const __nv_bfloat16* x1,
                                              int v, int C, float fh, int lane, float* xh) {
  const __nv_bfloat16* p0 = x0 + (long long)v * C;
  const __nv_bfloat16* p1 = x1 + (long long)v * C;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = lane + 32 * j;
    xh[j] = c < C ? __bfloat162float(p0[c]) * (1.f - fh) + __bfloat162float(p1[c]) * fh : 0.f;
  }
}

// up = column lerp of the window (xl, xc, xr) for a column phase (dw, fw)
template <int CPL>
__device__ __forceinline__ void col_lerp(const float* xl, const float* xc, const float* xr,
                                         int dw, float fw, float* up) {
  if (dw < 0) {
#pragma unroll
    for (int j = 0; j < CPL; ++j) up[j] = xl[j] * (1.f - fw) + xc[j] * fw;
  } else {
#pragma unroll
    for (int j = 0; j < CPL; ++j) up[j] = xc[j] * (1.f - fw) + xr[j] * fw;
  }
}

// the smallest class whose up equals the maximum m (torch's argmax tie order)
template <int CPL>
__device__ __forceinline__ int first_argmax(const float* up, float m, int C, int lane) {
  int best = 0x7fffffff;
#pragma unroll
  for (int j = CPL - 1; j >= 0; --j)
    if (lane + 32 * j < C && up[j] == m) best = lane + 32 * j;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) best = min(best, __shfl_xor_sync(0xffffffffu, best, o));
  return best;
}

template <int CPL>
__device__ __forceinline__ void shift_window(float* xl, float* xc, float* xr) {
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    xl[j] = xc[j];
    xc[j] = xr[j];
  }
}

// one warp per (frame n, output row Y); partial[2*(n*H + Y)] = (img_w * sum, count)
template <int CPL, typename L>
__global__ void __launch_bounds__(32 * kWarps) ce_fwd_kernel(
    const __nv_bfloat16* __restrict__ x, const L* __restrict__ labels,
    float* __restrict__ partial, int N, int h, int w, int C, int s, float img_w,
    int count_acc) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  const int H = h * s, W = w * s;
  if (row >= (long long)N * H) return;
  const Coeffs cf(s);
  const int n = (int)(row / H), Y = (int)(row % H);
  const int k = Y / s, ph = Y % s;
  const float fh = cf.f[ph];
  const __nv_bfloat16* x0 = x + ((long long)n * h + clampi(k + cf.delta[ph], 0, h - 1)) * w * C;
  const __nv_bfloat16* x1 =
      x + ((long long)n * h + clampi(k + cf.delta[ph] + 1, 0, h - 1)) * w * C;
  const L* lrow = labels + row * W;

  float xl[CPL], xc[CPL], xr[CPL], up[CPL];
  load_row_lerp<CPL>(x0, x1, 0, C, fh, lane, xc);
#pragma unroll
  for (int j = 0; j < CPL; ++j) xl[j] = xc[j];
  load_row_lerp<CPL>(x0, x1, min(1, w - 1), C, fh, lane, xr);
  float tot = 0.f, cor = 0.f;
  for (int v = 0; v < w; ++v) {
    for (int pw = 0; pw < s; ++pw) {
      const int label = (int)lrow[v * s + pw];
      const bool valid = label >= 0 && label < C;
      col_lerp<CPL>(xl, xc, xr, cf.delta[pw], cf.f[pw], up);
      const float m = class_max<CPL>(up, C, lane);
      float sum, picked;
      softmax_stats<CPL>(up, m, C, lane, valid ? label : 0, sum, picked);
      if (valid) {
        tot += (m + logf(sum)) - picked;
        if (count_acc && picked == m) cor += 1.f;
      }
    }
    shift_window<CPL>(xl, xc, xr);
    load_row_lerp<CPL>(x0, x1, min(v + 2, w - 1), C, fh, lane, xr);
  }
  if (lane == 0) {
    partial[2 * row] = tot * img_w;
    partial[2 * row + 1] = cor;
  }
}

// one warp per (frame n, output row Y): the row's nll, pred and lse
template <int CPL, typename L>
__global__ void __launch_bounds__(32 * kWarps) ce_nll_fwd_kernel(
    const __nv_bfloat16* __restrict__ x, const L* __restrict__ labels, float* __restrict__ nll,
    int* __restrict__ pred, float* __restrict__ lse, int N, int h, int w, int C, int s) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  const int H = h * s, W = w * s;
  if (row >= (long long)N * H) return;
  const Coeffs cf(s);
  const int n = (int)(row / H), Y = (int)(row % H);
  const int k = Y / s, ph = Y % s;
  const float fh = cf.f[ph];
  const __nv_bfloat16* x0 = x + ((long long)n * h + clampi(k + cf.delta[ph], 0, h - 1)) * w * C;
  const __nv_bfloat16* x1 =
      x + ((long long)n * h + clampi(k + cf.delta[ph] + 1, 0, h - 1)) * w * C;
  const L* lrow = labels + row * W;
  const long long orow = row * W;

  float xl[CPL], xc[CPL], xr[CPL], up[CPL];
  load_row_lerp<CPL>(x0, x1, 0, C, fh, lane, xc);
#pragma unroll
  for (int j = 0; j < CPL; ++j) xl[j] = xc[j];
  load_row_lerp<CPL>(x0, x1, min(1, w - 1), C, fh, lane, xr);
  float my_nll = 0.f, my_lse = 0.f;
  int my_pred = 0;
  for (int v = 0; v < w; ++v) {
    for (int pw = 0; pw < s; ++pw) {
      const int X = v * s + pw;
      int label = (int)lrow[X];
      if (label < 0 || label >= C) label = 0;
      col_lerp<CPL>(xl, xc, xr, cf.delta[pw], cf.f[pw], up);
      const float m = class_max<CPL>(up, C, lane);
      const int am = first_argmax<CPL>(up, m, C, lane);
      float sum, picked;
      softmax_stats<CPL>(up, m, C, lane, label, sum, picked);
      if (lane == (X & 31)) {
        my_lse = m + logf(sum);
        my_nll = my_lse - picked;
        my_pred = am;
      }
      if ((X & 31) == 31 || X == W - 1) {
        const int c0 = X & ~31;
        if (c0 + lane <= X) {
          nll[orow + c0 + lane] = my_nll;
          lse[orow + c0 + lane] = my_lse;
          pred[orow + c0 + lane] = my_pred;
        }
      }
    }
    shift_window<CPL>(xl, xc, xr);
    load_row_lerp<CPL>(x0, x1, min(v + 2, w - 1), C, fh, lane, xr);
  }
}

// One warp per (frame n, source row k, segment of kSeg source columns).
// PIXEL = false: the loss's backward, t = img_w * g[0] * (softmax(up) -
// onehot) on the valid pixels. PIXEL = true: the per-pixel backward, t =
// g[p] * (exp(up - lse[p]) - onehot(safe label)) on every pixel whose g is
// not 0 (a zero g adds exactly 0: exp(up - lse) <= 1).
template <int CPL, typename L, bool PIXEL>
__global__ void __launch_bounds__(32 * kWarps) ce_bwd_kernel(
    const __nv_bfloat16* __restrict__ x, const L* __restrict__ labels,
    const float* __restrict__ g, const float* __restrict__ lse, __nv_bfloat16* __restrict__ out,
    int N, int h, int w, int C, int s, float img_w) {
  extern __shared__ float acc_all[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x / 32;
  const int nseg = (w + kSeg - 1) / kSeg;
  const long long item = (long long)blockIdx.x * kWarps + warp;
  if (item >= (long long)N * h * nseg) return;
  const Coeffs cf(s);
  const int n = (int)(item / ((long long)h * nseg));
  const int k = (int)(item / nseg % h);
  const int v_lo = (int)(item % nseg) * kSeg;
  const int v_hi = min(v_lo + kSeg, w) - 1;
  const int H = h * s, W = w * s;
  constexpr int CP = 32 * CPL;
  float* acc = acc_all + (size_t)warp * kSeg * CP;  // acc[(v - v_lo) * CP + j*32 + lane]
  for (int i = lane; i < kSeg * CP; i += 32) acc[i] = 0.f;
  const float ct = PIXEL ? 0.f : g[0] * img_w;

  float xl[CPL], xc[CPL], xr[CPL], up[CPL];
  for (int kp = max(k - 1, 0); kp <= min(k + 1, h - 1); ++kp) {
    for (int ph = 0; ph < s; ++ph) {
      const int r0 = clampi(kp + cf.delta[ph], 0, h - 1);
      const int r1 = clampi(kp + cf.delta[ph] + 1, 0, h - 1);
      if (r0 != k && r1 != k) continue;
      const float fh = cf.f[ph];
      const float a = (r0 == k ? 1.f - fh : 0.f) + (r1 == k ? fh : 0.f);
      const __nv_bfloat16* x0 = x + ((long long)n * h + r0) * w * C;
      const __nv_bfloat16* x1 = x + ((long long)n * h + r1) * w * C;
      const long long prow = ((long long)n * H + kp * s + ph) * W;
      const L* lrow = labels + prow;
      const int vs = max(v_lo - 1, 0), ve = min(v_hi + 1, w - 1);
      load_row_lerp<CPL>(x0, x1, max(vs - 1, 0), C, fh, lane, xl);
      load_row_lerp<CPL>(x0, x1, vs, C, fh, lane, xc);
      load_row_lerp<CPL>(x0, x1, min(vs + 1, w - 1), C, fh, lane, xr);
      for (int v = vs; v <= ve; ++v) {
        for (int pw = 0; pw < s; ++pw) {
          const int dw = cf.delta[pw];
          const float fw = cf.f[pw];
          const int c0 = clampi(v + dw, 0, w - 1), c1 = clampi(v + dw + 1, 0, w - 1);
          const bool in0 = c0 >= v_lo && c0 <= v_hi, in1 = c1 >= v_lo && c1 <= v_hi;
          int label = (int)lrow[v * s + pw];
          float gp = ct;
          if constexpr (PIXEL) {
            gp = g[prow + v * s + pw];
            if (!(in0 || in1) || gp == 0.f) continue;
            if (label < 0 || label >= C) label = 0;
          } else {
            if (!(in0 || in1) || label < 0 || label >= C) continue;
          }
          col_lerp<CPL>(xl, xc, xr, dw, fw, up);
          float sum = 1.f;
          if constexpr (PIXEL) {
            const float ls = lse[prow + v * s + pw];
#pragma unroll
            for (int j = 0; j < CPL; ++j) up[j] = lane + 32 * j < C ? expf(up[j] - ls) : 0.f;
          } else {
            float picked;
            softmax_stats<CPL>(up, class_max<CPL>(up, C, lane), C, lane, label, sum, picked);
          }
          const float w0 = a * (1.f - fw), w1 = a * fw;
#pragma unroll
          for (int j = 0; j < CPL; ++j) {
            const int c = lane + 32 * j;
            if (c >= C) continue;
            const float p = PIXEL ? up[j] : up[j] / sum;
            const float t = gp * (p - (c == label ? 1.f : 0.f));
            if (in0) acc[(c0 - v_lo) * CP + c] += w0 * t;
            if (in1) acc[(c1 - v_lo) * CP + c] += w1 * t;
          }
        }
        shift_window<CPL>(xl, xc, xr);
        load_row_lerp<CPL>(x0, x1, min(v + 2, w - 1), C, fh, lane, xr);
      }
    }
  }
  __syncwarp();
  __nv_bfloat16* orow = out + ((long long)n * h + k) * w * C;
  for (int v = v_lo; v <= v_hi; ++v)
    for (int c = lane; c < C; c += 32)
      orow[(long long)v * C + c] = __float2bfloat16_rn(acc[(v - v_lo) * CP + c]);
}

template <typename L>
int launch_fwd(const void* x, const void* labels, void* partial, int N, int h, int w, int C,
               int s, float img_w, int count_acc, cudaStream_t st) {
  const long long rows = (long long)N * h * s;
  const unsigned blocks = (unsigned)((rows + kWarps - 1) / kWarps);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* lb = static_cast<const L*>(labels);
  auto* pb = static_cast<float*>(partial);
  const int cpl = (C + 31) / 32;
#define VSS_CE_FWD(K) \
  ce_fwd_kernel<K, L><<<blocks, 32 * kWarps, 0, st>>>(xb, lb, pb, N, h, w, C, s, img_w, count_acc)
  if (cpl <= 1) VSS_CE_FWD(1);
  else if (cpl <= 2) VSS_CE_FWD(2);
  else if (cpl <= 4) VSS_CE_FWD(4);
  else if (cpl <= 8) VSS_CE_FWD(8);
  else return (int)cudaErrorInvalidValue;
#undef VSS_CE_FWD
  return (int)cudaGetLastError();
}

template <typename L>
int launch_nll_fwd(const void* x, const void* labels, void* nll, void* pred, void* lse, int N,
                   int h, int w, int C, int s, cudaStream_t st) {
  const long long rows = (long long)N * h * s;
  const unsigned blocks = (unsigned)((rows + kWarps - 1) / kWarps);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* lb = static_cast<const L*>(labels);
  auto* nb = static_cast<float*>(nll);
  auto* pb = static_cast<int*>(pred);
  auto* sb = static_cast<float*>(lse);
  const int cpl = (C + 31) / 32;
#define VSS_CE_NLL(K) \
  ce_nll_fwd_kernel<K, L><<<blocks, 32 * kWarps, 0, st>>>(xb, lb, nb, pb, sb, N, h, w, C, s)
  if (cpl <= 1) VSS_CE_NLL(1);
  else if (cpl <= 2) VSS_CE_NLL(2);
  else if (cpl <= 4) VSS_CE_NLL(4);
  else if (cpl <= 8) VSS_CE_NLL(8);
  else return (int)cudaErrorInvalidValue;
#undef VSS_CE_NLL
  return (int)cudaGetLastError();
}

template <int CPL, typename L, bool PIXEL>
int launch_bwd_cpl(const void* x, const void* labels, const void* g, const void* lse, void* out,
                   int N, int h, int w, int C, int s, float img_w, cudaStream_t st) {
  const long long items = (long long)N * h * ((w + kSeg - 1) / kSeg);
  const unsigned blocks = (unsigned)((items + kWarps - 1) / kWarps);
  const size_t bytes = (size_t)kWarps * kSeg * 32 * CPL * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(ce_bwd_kernel<CPL, L, PIXEL>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  ce_bwd_kernel<CPL, L, PIXEL><<<blocks, 32 * kWarps, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const L*>(labels),
      static_cast<const float*>(g), static_cast<const float*>(lse),
      static_cast<__nv_bfloat16*>(out), N, h, w, C, s, img_w);
  return (int)cudaGetLastError();
}

template <typename L, bool PIXEL>
int launch_bwd(const void* x, const void* labels, const void* g, const void* lse, void* out,
               int N, int h, int w, int C, int s, float img_w, cudaStream_t st) {
  const int cpl = (C + 31) / 32;
#define VSS_CE_BWD(K) \
  return launch_bwd_cpl<K, L, PIXEL>(x, labels, g, lse, out, N, h, w, C, s, img_w, st)
  if (cpl <= 1) VSS_CE_BWD(1);
  if (cpl <= 2) VSS_CE_BWD(2);
  if (cpl <= 4) VSS_CE_BWD(4);
  if (cpl <= 8) VSS_CE_BWD(8);
#undef VSS_CE_BWD
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// logits (N, h, w, C) bf16; labels (N, h*s, w*s) uint8 (labels_i32 = 0) or
// int32; partial (N*h*s, 2) f32 receives (img_w * row sum, row count) per
// output row. C <= 256, 1 <= s <= 8. Returns a cudaError_t.
VSS_EXPORT int ce_fwd_loss(const void* logits, const void* labels, void* partial, int N, int h,
                           int w, int C, int s, int labels_i32, float img_w, int count_acc,
                           int device, void* stream) {
  vss::use_device(device);
  if ((long long)N * h * w == 0) return 0;
  if (s < 1 || s > kMaxScale || C < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return labels_i32 ? launch_fwd<int>(logits, labels, partial, N, h, w, C, s, img_w, count_acc, st)
                    : launch_fwd<unsigned char>(logits, labels, partial, N, h, w, C, s, img_w,
                                                count_acc, st);
}

// dlogits (N, h, w, C) bf16 for the cotangent g[0] (f32, on the device) of
// the forward's img_w-weighted sum.
VSS_EXPORT int ce_bwd_loss(const void* logits, const void* labels, const void* g, void* out,
                           int N, int h, int w, int C, int s, int labels_i32, float img_w,
                           int device, void* stream) {
  vss::use_device(device);
  if ((long long)N * h * w == 0) return 0;
  if (s < 1 || s > kMaxScale || C < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return labels_i32
             ? launch_bwd<int, false>(logits, labels, g, nullptr, out, N, h, w, C, s, img_w, st)
             : launch_bwd<unsigned char, false>(logits, labels, g, nullptr, out, N, h, w, C, s,
                                                img_w, st);
}

// The per-pixel maps of logits (N, h, w, C) bf16 against labels (N, h*s,
// w*s) uint8 (labels_i32 = 0) or int32: nll and lse f32, pred int32, each
// (N, h*s, w*s). C <= 256, 1 <= s <= 8. Returns a cudaError_t.
VSS_EXPORT int ce_fwd_nll(const void* logits, const void* labels, void* nll, void* pred,
                          void* lse, int N, int h, int w, int C, int s, int labels_i32,
                          int device, void* stream) {
  vss::use_device(device);
  if ((long long)N * h * w == 0) return 0;
  if (s < 1 || s > kMaxScale || C < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return labels_i32 ? launch_nll_fwd<int>(logits, labels, nll, pred, lse, N, h, w, C, s, st)
                    : launch_nll_fwd<unsigned char>(logits, labels, nll, pred, lse, N, h, w, C,
                                                    s, st);
}

// dlogits (N, h, w, C) bf16 for the per-pixel cotangent g_nll (N, h*s, w*s)
// f32 of ce_fwd_nll's nll, from its lse.
VSS_EXPORT int ce_bwd_nll(const void* logits, const void* labels, const void* lse,
                          const void* g_nll, void* out, int N, int h, int w, int C, int s,
                          int labels_i32, int device, void* stream) {
  vss::use_device(device);
  if ((long long)N * h * w == 0) return 0;
  if (s < 1 || s > kMaxScale || C < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return labels_i32
             ? launch_bwd<int, true>(logits, labels, g_nll, lse, out, N, h, w, C, s, 0.f, st)
             : launch_bwd<unsigned char, true>(logits, labels, g_nll, lse, out, N, h, w, C, s,
                                               0.f, st);
}
