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
// Forward design: one warp walks one output row; each lane holds the
// classes lane + 32*j in registers.
// The row-lerped logits of three neighbouring source columns stay in
// registers as the warp slides along the row, so each source value is
// loaded about twice per output row that uses it (from L1/L2), and the
// column phases of one source column share them. Max, sum of exp and the
// label pick are warp shuffles; each lane adds only its own classes.
// Forward: per-warp partial (img_w * sum, count) pairs, reduced by one
// torch.sum outside; no atomics, so the result is the same run to run.
// The per-pixel forward keeps each of 32 consecutive pixels' results in the
// lane of its column and writes them as one coalesced store per map.
// Backward (rows 13 and 17): each output pixel's softmax is computed once
// for its strip of source columns (a recompute of s/2 output columns at each
// strip edge only, ~1.06x at the train step), by G = 8 lanes (16 classes a
// lane at C 124), so the max and the sum take 3 shuffles; the column adjoint
// stays in registers and the row adjoint in two f32 shared-memory rows per
// warp; segments of source rows meet in f32 partials summed in a fixed
// order. The softmax's division is vss::div_rn (the `/` operator's rounding
// without its slow-path branch). See ce_bwd_kernel below.
#include "ce_common.cuh"
#include "mma_sync.cuh"

namespace {

using vss::ce::clampi;
using vss::ce::class_max;
using vss::ce::softmax_stats;

constexpr int kWarps = 4;
constexpr int kMaxScale = 8;

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

// ---- the backward: strips of source columns, each output row once ---------
//
// A unit is one warp's work: frame n, a segment [k_lo, k_hi) of source rows
// (at least 2 rows) and a strip [v0, v1) of source columns. It computes every
// output pixel of the output rows s*k_lo .. s*k_hi - 1 (each output row
// belongs to exactly one segment) whose columns reach the strip: X in
// [s*v0 - s/2, s*v1 + s/2), so the strip's s/2-column halo on each side is
// the only recompute. A pixel's G lanes hold its classes c = gl + G*j, so
// the max and the sum of exps take log2(G) shuffles; the warp's 32 / G
// groups walk consecutive runs of `run` output columns of the same output
// row in lockstep (a multiple of s and at least 2s, so their column windows
// never meet while they slide; the last windows are flushed by even groups,
// then odd ones). Each group keeps the row-lerped logits of two source columns and
// two f32 column accumulators (the column adjoint) in registers; when its
// window slides, the finished column goes, times the two row weights, into
// the warp's shared-memory rows (two live source rows, f32, the row
// adjoint). A finished source row is written once: in bf16 to dlogits, or,
// for the two rows at each segment boundary that the neighbouring segment
// also reaches, in f32 to a partial buffer, added in a fixed order (upper
// segment, then lower) by ce_bwd_combine_kernel. No atomics.

constexpr int kBwdWarps = 4;

// the max / the sum over the G lanes of one pixel (G a power of two, groups
// aligned in the warp; every lane takes part)
template <int G>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// xh[j] = x0[c]*(1 - fh) + x1[c]*fh at column v, class c = gl + G j (the
// forward's row lerp, load_row_lerp, with G lanes a pixel)
template <int G, int CPL>
__device__ __forceinline__ void lerp_cols(const __nv_bfloat16* x0, const __nv_bfloat16* x1,
                                          int v, int C, float fh, int gl, float* xh) {
  const __nv_bfloat16* p0 = x0 + (long long)v * C;
  const __nv_bfloat16* p1 = x1 + (long long)v * C;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = gl + G * j;
    xh[j] = c < C ? __bfloat162float(p0[c]) * (1.f - fh) + __bfloat162float(p1[c]) * fh : 0.f;
  }
}

// PIXEL = false: the loss's backward, t = img_w * g[0] * (softmax(up) -
// onehot) on the valid pixels. PIXEL = true: the per-pixel backward, t =
// g[p] * (exp(up - lse[p]) - onehot(safe label)) on every pixel whose g is
// not 0 (a zero g adds exactly 0: exp(up - lse) <= 1). Every exp runs for
// all of a lane's classes, masked by a product with 0 or 1 past C, its
// argument clamped to <= 0 (a no-op for a class in [0, C): up <= max <= lse):
// written as `c < C ? expf(..) : 0` each exp sat in its own branch and the
// 16 of a lane could not overlap.
template <int G, int CPL, typename L, bool PIXEL>
__global__ void __launch_bounds__(32 * kBwdWarps, 3) ce_bwd_kernel(
    const __nv_bfloat16* __restrict__ x, const L* __restrict__ labels,
    const float* __restrict__ g, const float* __restrict__ lse, __nv_bfloat16* __restrict__ out,
    float* __restrict__ part, int N, int h, int w, int C, int s, float img_w, int tw, int nseg,
    int cs) {
  constexpr int NG = 32 / G;
  extern __shared__ float acc_all[];
  __shared__ float sf[kMaxScale];
  __shared__ int sd[kMaxScale];
  if (threadIdx.x == 0) {
    const Coeffs cf(s);
    for (int p = 0; p < s; ++p) {
      sf[p] = cf.f[p];
      sd[p] = cf.delta[p];
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gi = lane / G, gl = lane % G;
  const int nstrip = (w + tw - 1) / tw;
  const long long unit = (long long)blockIdx.x * kBwdWarps + warp;
  if (unit >= (long long)N * nseg * nstrip) return;
  const int strip = (int)(unit % nstrip);
  const int seg = (int)(unit / nstrip % nseg), n = (int)(unit / nstrip / nseg);
  const int k_lo = (int)((long long)seg * h / nseg);
  const int k_hi = (int)((long long)(seg + 1) * h / nseg);
  const int v0 = strip * tw, v1 = min(v0 + tw, w);
  const int H = h * s, W = w * s, hs = s / 2;
  const int xa = max(0, s * v0 - hs), xb = min(W, s * v1 + hs);
  const int run = s * max(2, ((xb - xa + s - 1) / s + NG - 1) / NG);
  const int xg = xa + gi * run;  // the group's first output column
  const bool active = xg < xb;   // the group has a live pixel
  const long long xn = (long long)n * h * w * C;
  float* A = acc_all + (size_t)warp * 2 * tw * cs;  // [row & 1][col - v0][class]
  for (int i = lane; i < 2 * tw * cs; i += 32) A[i] = 0.f;
  __syncwarp();
  const float ct = PIXEL ? 0.f : g[0] * img_w;

  // write source row r (all its strip columns) and clear its slot
  auto emit = [&](int r) {
    __syncwarp();
    float* As = A + (r & 1) * tw * cs;
    const bool top = k_lo > 0 && r <= k_lo, bottom = k_hi < h && r >= k_hi - 1;
    if (top || bottom) {
      const int j = top ? seg - 1 : seg, rr = r - (top ? k_lo : k_hi) + 1;
      float* pp = part + ((((long long)n * (nseg - 1) + j) * 2 + (top ? 1 : 0)) * 2 + rr) * w * C +
                  (long long)v0 * C;
      for (int col = 0; col < v1 - v0; ++col)
        for (int c = lane; c < C; c += 32) pp[col * C + c] = As[col * cs + c];
    } else {
      __nv_bfloat16* o = out + xn + ((long long)r * w + v0) * C;
      for (int col = 0; col < v1 - v0; ++col)
        for (int c = lane; c < C; c += 32) o[col * C + c] = __float2bfloat16_rn(As[col * cs + c]);
    }
    __syncwarp();
    for (int i = lane; i < tw * cs; i += 32) As[i] = 0.f;
    __syncwarp();
  };

  int base = max(k_lo - 1, 0);  // the lowest source row not yet written
  float xw0[CPL], xw1[CPL], nx0[CPL], nx1[CPL], acc0[CPL], acc1[CPL], up[CPL];
  for (int Y = s * k_lo; Y < s * k_hi; ++Y) {
    const int k = Y / s, ph = Y % s;
    const int r0 = clampi(k + sd[ph], 0, h - 1), r1 = clampi(k + sd[ph] + 1, 0, h - 1);
    const float fh = sf[ph], wr0 = 1.f - fh;
    while (r0 > base) emit(base++);
    float* A0 = A + (r0 & 1) * tw * cs;
    float* A1 = A + (r1 & 1) * tw * cs;
    // the column accumulator of source column cr, times the row weights,
    // into the rows r0 and r1 (a group without a live pixel adds nothing:
    // its window may sit, clamped, on a column another group flushes)
    auto flush = [&](int cr, const float (&a)[CPL]) {
      if (active && cr >= v0 && cr < v1) {
        float* d0 = A0 + (cr - v0) * cs + gl;
        float* d1 = A1 + (cr - v0) * cs + gl;
#pragma unroll
        for (int j = 0; j < CPL; ++j) d0[G * j] += wr0 * a[j];
#pragma unroll
        for (int j = 0; j < CPL; ++j) d1[G * j] += fh * a[j];
      }
    };
    const __nv_bfloat16* x0 = x + xn + (long long)r0 * w * C;
    const __nv_bfloat16* x1 = x + xn + (long long)r1 * w * C;
    const long long prow = ((long long)n * H + Y) * W;
    const L* lrow = labels + prow;
    int X = xg, v = min(X, W - 1) / s, pw = min(X, W - 1) % s;
    int wc = v + sd[pw];  // the window: raw source columns wc, wc + 1
    lerp_cols<G, CPL>(x0, x1, clampi(wc, 0, w - 1), C, fh, gl, xw0);
    lerp_cols<G, CPL>(x0, x1, clampi(wc + 1, 0, w - 1), C, fh, gl, xw1);
#pragma unroll
    for (int j = 0; j < CPL; ++j) acc0[j] = acc1[j] = 0.f;
    const int Xl = min(X, W - 1);
    int lab = (int)lrow[Xl];
    float gp = PIXEL ? g[prow + Xl] : ct, ls = PIXEL ? lse[prow + Xl] : 0.f;
    for (int jx = 0; jx < run; ++jx, ++X) {
      // the next pixel's column phase and inputs, and the window's next
      // column when it slides after this pixel
      int vn = v, pwn = pw + 1;
      if (pwn == s) {
        pwn = 0;
        ++vn;
      }
      const bool more = jx + 1 < run && X + 1 < W;
      const bool slide = more && vn + sd[pwn] > wc;
      const int Xn = more ? X + 1 : min(X, W - 1);
      const int lab_n = (int)lrow[Xn];
      const float gp_n = PIXEL ? g[prow + Xn] : ct, ls_n = PIXEL ? lse[prow + Xn] : 0.f;
      if (slide) {
        const __nv_bfloat16* p0 = x0 + (long long)clampi(wc + 2, 0, w - 1) * C;
        const __nv_bfloat16* p1 = x1 + (long long)clampi(wc + 2, 0, w - 1) * C;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int c = gl + G * j;
          nx0[j] = c < C ? __bfloat162float(p0[c]) : 0.f;
          nx1[j] = c < C ? __bfloat162float(p1[c]) : 0.f;
        }
      }
      const float fw = sf[pw], wl = 1.f - fw;
#pragma unroll
      for (int j = 0; j < CPL; ++j) up[j] = xw0[j] * wl + xw1[j] * fw;
      const bool live = X < xb;
      // the adjoint's column weights: at the image edge the window's column
      // -1 or w is the edge column itself, so its share goes there
      float wa = wl, wb = fw;
      if (wc < 0) {
        wb = wl + fw;
        wa = 0.f;
      } else if (wc + 1 >= w) {
        wa = wl + fw;
        wb = 0.f;
      }
      if constexpr (PIXEL) {
        const int label = lab < 0 || lab >= C ? 0 : lab;
        if (live && gp != 0.f) {
#pragma unroll
          for (int j = 0; j < CPL; ++j) {
            const int c = gl + G * j;
            const float e = expf(fminf(up[j] - ls, 0.f)) * (c < C ? 1.f : 0.f);
            const float t = gp * (e - (c == label ? 1.f : 0.f));
            acc0[j] += wa * t;
            acc1[j] += wb * t;
          }
        }
      } else {
        float m = -3.402823466e38f;
#pragma unroll
        for (int j = 0; j < CPL; ++j) m = fmaxf(m, gl + G * j < C ? up[j] : -3.402823466e38f);
        m = group_max<G>(m);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          up[j] = expf(fminf(up[j] - m, 0.f)) * (gl + G * j < C ? 1.f : 0.f);
          sum += up[j];
        }
        sum = group_sum<G>(sum);
        if (live && lab >= 0 && lab < C) {
          const float rs = vss::recip(sum);
#pragma unroll
          for (int j = 0; j < CPL; ++j) {
            const int c = gl + G * j;
            const float t = gp * (vss::div_rn(up[j], sum, rs) - (c == lab ? 1.f : 0.f));
            acc0[j] += wa * t;
            acc1[j] += wb * t;
          }
        }
      }
      if (slide) {
        flush(wc, acc0);
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          acc0[j] = acc1[j];
          acc1[j] = 0.f;
          xw0[j] = xw1[j];
          xw1[j] = nx0[j] * wr0 + nx1[j] * fh;
        }
        ++wc;
      }
      v = vn;
      pw = pwn;
      lab = lab_n;
      gp = gp_n;
      ls = ls_n;
      __syncwarp();
    }
    // the window's last two columns, even groups first: a group whose run
    // ends at the image edge may share its last window with the next one's
    for (int par = 0; par < 2; ++par) {
      if ((gi & 1) == par) {
        flush(wc, acc0);
        flush(wc + 1, acc1);
      }
      __syncwarp();
    }
  }
  const int last = min(k_hi, h - 1);
  while (base <= last) emit(base++);
}

// dlogits rows b - 1 and b of each segment boundary b: the upper segment's
// partial plus the lower one's, in that order, rounded to bf16
__global__ void ce_bwd_combine_kernel(const float* __restrict__ part,
                                      __nv_bfloat16* __restrict__ out, int N, int h, int w, int C,
                                      int nseg) {
  const long long row = (long long)w * C;
  const long long total = (long long)N * (nseg - 1) * 2 * row;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const long long e = i % row, t = i / row;
    const int rr = (int)(t % 2), j = (int)(t / 2 % (nseg - 1)), n = (int)(t / 2 / (nseg - 1));
    const int b = (int)((long long)(j + 1) * h / nseg);
    const float* p = part + (((long long)n * (nseg - 1) + j) * 4 + rr) * row + e;
    out[((long long)n * h + b - 1 + rr) * row + e] = __float2bfloat16_rn(p[0] + p[2 * row]);
  }
}

template <int G, int CPL, typename L, bool PIXEL>
int launch_bwd_gc(const void* x, const void* labels, const void* g, const void* lse, void* out,
                  void* part, int N, int h, int w, int C, int s, float img_w, int tw, int nseg,
                  int cs, cudaStream_t st) {
  const long long units = (long long)N * nseg * ((w + tw - 1) / tw);
  const unsigned blocks = (unsigned)((units + kBwdWarps - 1) / kBwdWarps);
  const size_t bytes = (size_t)kBwdWarps * 2 * tw * cs * sizeof(float);
  static bool attr = false;  // one instance per template: set its limit once
  if (!attr) {
    cudaError_t e = cudaFuncSetAttribute(ce_bwd_kernel<G, CPL, L, PIXEL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, 200 * 1024);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  auto* ob = static_cast<__nv_bfloat16*>(out);
  auto* pb = static_cast<float*>(part);
  ce_bwd_kernel<G, CPL, L, PIXEL><<<blocks, 32 * kBwdWarps, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const L*>(labels),
      static_cast<const float*>(g), static_cast<const float*>(lse), ob, pb, N, h, w, C, s, img_w,
      tw, nseg, cs);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || nseg < 2) return (int)e;
  const long long total = (long long)N * (nseg - 1) * 2 * w * C;
  const long long cblocks = (total + 255) / 256;
  const unsigned cb = (unsigned)(cblocks < 132 * 16 ? cblocks : 132 * 16);
  ce_bwd_combine_kernel<<<cb, 256, 0, st>>>(pb, ob, N, h, w, C, nseg);
  return (int)cudaGetLastError();
}

// classes: G lanes a pixel, CPL classes a lane (ops/ce_upsampled.py
// ce_bwd_groups has the same table)
template <typename L, bool PIXEL>
int launch_bwd(const void* x, const void* labels, const void* g, const void* lse, void* out,
               void* part, int N, int h, int w, int C, int s, float img_w, int tw, int nseg,
               int cs, cudaStream_t st) {
#define VSS_CE_BWD(G, K) \
  return launch_bwd_gc<G, K, L, PIXEL>(x, labels, g, lse, out, part, N, h, w, C, s, img_w, tw, \
                                       nseg, cs, st)
  if (C <= 32) VSS_CE_BWD(4, 8);
  if (C <= 64) VSS_CE_BWD(8, 8);
  if (C <= 128) VSS_CE_BWD(8, 16);
  if (C <= 256) VSS_CE_BWD(16, 16);
#undef VSS_CE_BWD
  return (int)cudaErrorInvalidValue;
}

// the plan's checks: a strip of 1..64 columns, segments of at least 2 rows
// (or one segment), the column stride holding the classes
inline bool bwd_plan_ok(int h, int C, int tw, int nseg, int cs, const void* part) {
  const int cp = C <= 32 ? 32 : C <= 64 ? 64 : C <= 128 ? 128 : 256;
  return tw >= 1 && tw <= 64 && nseg >= 1 && (nseg == 1 || (h / nseg >= 2 && part != nullptr)) &&
         cs >= cp;
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
// the forward's img_w-weighted sum, in strips of tw source columns and nseg
// segments of source rows a frame (ops/ce_upsampled.py ce_bwd_plan); with
// nseg > 1, part is an f32 buffer of N * (nseg - 1) * 4 * w * C for the rows
// at the segment boundaries; cs (>= the classes' padded width) is the column
// stride of the shared-memory rows.
VSS_EXPORT int ce_bwd_loss(const void* logits, const void* labels, const void* g, void* out,
                           void* part, int N, int h, int w, int C, int s, int labels_i32,
                           float img_w, int tw, int nseg, int cs, int device, void* stream) {
  vss::use_device(device);
  if ((long long)N * h * w == 0) return 0;
  if (s < 1 || s > kMaxScale || C < 1 || !bwd_plan_ok(h, C, tw, nseg, cs, part))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return labels_i32 ? launch_bwd<int, false>(logits, labels, g, nullptr, out, part, N, h, w, C,
                                             s, img_w, tw, nseg, cs, st)
                    : launch_bwd<unsigned char, false>(logits, labels, g, nullptr, out, part, N,
                                                       h, w, C, s, img_w, tw, nseg, cs, st);
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
// f32 of ce_fwd_nll's nll, from its lse; the plan (tw, nseg, cs) and part
// as for ce_bwd_loss.
VSS_EXPORT int ce_bwd_nll(const void* logits, const void* labels, const void* lse,
                          const void* g_nll, void* out, void* part, int N, int h, int w, int C,
                          int s, int labels_i32, int tw, int nseg, int cs, int device,
                          void* stream) {
  vss::use_device(device);
  if ((long long)N * h * w == 0) return 0;
  if (s < 1 || s > kMaxScale || C < 1 || !bwd_plan_ok(h, C, tw, nseg, cs, part))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return labels_i32 ? launch_bwd<int, true>(logits, labels, g_nll, lse, out, part, N, h, w, C, s,
                                            0.f, tw, nseg, cs, st)
                    : launch_bwd<unsigned char, true>(logits, labels, g_nll, lse, out, part, N,
                                                      h, w, C, s, 0.f, tw, nseg, cs, st);
}
