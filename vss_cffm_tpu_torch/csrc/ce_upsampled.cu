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
//   _ce_bwd_loss_pallas (_bwd_loss_kernel) and _ce_bwd_loss_pallas3
//       (_bwd_loss_kernel3): the loss's backward with f32 dlogits and uint8
//       labels in the TPU kernels' phase layouts, h-major (N, h, s*s, w) and
//       w-major (N, h, w, s*s), the latter's phase coefficients in f32 from the
//       phase index (its runtime phase loop's _phase_coeff_dyn);
//   _ce_fwd_loss_pallas5 (_fwd_loss_kernel5) and _ce_fwd_loss_pallas3
//       (_fwd_loss_kernel3): the loss's forward with uint8 labels in the
//       w-major phase layout, the phases unrolled (s 2 or 4) or a runtime
//       loop (s 1..8, coefficients in f32 from the phase index).
// In the loss pair a label is valid when 0 <= label < C; the per-pixel pair
// picks class 0 for a label outside [0, C) (the safe label) and leaves its
// weight to the caller's g, as the TPU kernels do; its backward (row 13) is
// csrc/ce_nll_bwd.cu. Output row Y = s*k + p of the
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
// The per-pixel forward does the same exps and writes 12 B per output pixel
// (nll, pred, lse; ~22 MB at the train step): still bound by the exps.
// Forward (rows 12 and 14; rows 16 and 18, the same kernel with w-major
// labels): each output pixel's softmax is computed once, by G = 8 lanes of
// 16 contiguous classes at C 124, in units of (frame, band of 32 / G output
// rows, strip of source columns), the window's row-lerped columns in
// registers; see ce_fwd_kernel below. The loss writes per-warp (img_w * sum,
// count) partials, reduced by one torch.sum outside; the maps are staged in
// shared memory and written as 16-byte stores. No atomics, so the results
// are the same run to run. Rows 16 and 18 differ from row 14 only in where
// the band's labels are read from as they are staged (phase_row, phase_col)
// and, for row 18, in the phase coefficients' rule, so at s 2 and 4 they
// give row 14's (wsum, corr) bit for bit on the same labels.
// Backward (row 17; rows 15 and 19, the same kernel with phase labels and
// f32 out): each output pixel's softmax is computed once for its
// strip of source columns (a recompute of s/2 output columns at each strip
// edge only, ~1.06x at the train step), by G = 8 lanes (16 classes a lane at
// C 124), so the max and the sum take 3 shuffles; the column adjoint stays
// in registers and the row adjoint in two f32 shared-memory rows per warp;
// segments of source rows meet in f32 partials summed in a fixed order. The
// softmax's division is vss::div_rn (the `/` operator's rounding without its
// slow-path branch). See ce_bwd_kernel below.
#include "common.cuh"
#include "mma_sync.cuh"

namespace {

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

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
// adjoint). A finished source row is written once: to dlogits (bf16, or f32
// for rows 15 and 19), or, for the two rows at each segment boundary that the
// neighbouring segment also reaches, in f32 to a partial buffer, added in a
// fixed order (upper segment, then lower) by ce_bwd_combine_kernel. No
// atomics. Rows 15 and 19 differ from row 17 only in where a pixel's label
// lies (phase_row, phase_col) and in the output's type, so rounded to bf16
// they are row 17's result bit for bit at the same labels and coefficients.

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

// xh[j] = x0[c]*(1 - fh) + x1[c]*fh at column v, class c = gl + G j
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

// The labels' layouts: natural (N, H, W), and the TPU kernels' phase layouts
// h-major (N, h, s*s, w) and w-major (N, h, w, s*s), where the label of output
// pixel (s k + ph, s v + pw) is at [n, k, ph s + pw, v] and [n, k, v, ph s + pw].
enum LabelLayout { kNatural = 0, kHMajor = 1, kWMajor = 2 };

// Output row Y = s k + ph's labels in a phase layout: the row's base, and the
// offset of output column s v + pw from it (v clamped to the map, so that
// the look-ahead past a run's end stays inside it)
template <int LAYOUT>
__device__ __forceinline__ long long phase_row(int n, int h, int w, int s, int k, int ph) {
  return LAYOUT == kHMajor ? (((long long)n * h + k) * s * s + ph * s) * w
                           : ((long long)n * h + k) * w * s * s + ph * s;
}
template <int LAYOUT>
__device__ __forceinline__ int phase_col(int v, int pw, int w, int s) {
  v = min(v, w - 1);
  return LAYOUT == kHMajor ? pw * w + v : v * s * s + pw;
}

// a finished dlogits value in the output's type
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }

// The loss's backward, t = img_w * g[0] * (softmax(up) - onehot) on the
// valid pixels. Every exp runs for all of a lane's classes, masked by a
// product with 0 or 1 past C, its argument clamped to <= 0 (a no-op for a
// class in [0, C): up <= max): written as `c < C ? expf(..) : 0` each exp
// sat in its own branch and the 16 of a lane could not overlap. LAYOUT: the
// labels' layout; O: dlogits' type, bf16 (row 17) or f32 (rows 15, 19).
// loop_coeffs: the phase coefficients in f32 from the phase index, as the
// TPU's runtime phase loop takes them (row 19), else Coeffs.
template <int G, int CPL, typename L, int LAYOUT, typename O>
__global__ void __launch_bounds__(32 * kBwdWarps, 3) ce_bwd_kernel(
    const __nv_bfloat16* __restrict__ x, const L* __restrict__ labels,
    const float* __restrict__ g, O* __restrict__ out, float* __restrict__ part, int N, int h,
    int w, int C, int s, float img_w, int tw, int nseg, int cs, int loop_coeffs) {
  constexpr int NG = 32 / G;
  extern __shared__ float acc_all[];
  __shared__ float sf[kMaxScale];
  __shared__ int sd[kMaxScale];
  if (threadIdx.x == 0) {
    const Coeffs cf(s);
    for (int p = 0; p < s; ++p) {
      if (loop_coeffs) {
        const float d = ((float)p + 0.5f) / (float)s - 0.5f;
        sd[p] = d < 0.f ? -1 : 0;
        sf[p] = d - (float)sd[p];
      } else {
        sf[p] = cf.f[p];
        sd[p] = cf.delta[p];
      }
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
  const float ct = g[0] * img_w;

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
      O* o = out + xn + ((long long)r * w + v0) * C;
      for (int col = 0; col < v1 - v0; ++col)
        for (int c = lane; c < C; c += 32) store_out(o + col * C + c, As[col * cs + c]);
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
    const L* lrow = labels + (LAYOUT == kNatural ? prow : phase_row<LAYOUT>(n, h, w, s, k, ph));
    int X = xg, v = min(X, W - 1) / s, pw = min(X, W - 1) % s;
    int wc = v + sd[pw];  // the window: raw source columns wc, wc + 1
    lerp_cols<G, CPL>(x0, x1, clampi(wc, 0, w - 1), C, fh, gl, xw0);
    lerp_cols<G, CPL>(x0, x1, clampi(wc + 1, 0, w - 1), C, fh, gl, xw1);
#pragma unroll
    for (int j = 0; j < CPL; ++j) acc0[j] = acc1[j] = 0.f;
    const int Xl = min(X, W - 1);
    int lab = (int)lrow[LAYOUT == kNatural ? Xl : phase_col<LAYOUT>(v, pw, w, s)];
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
      const int lab_n = (int)lrow[LAYOUT == kNatural ? Xn : phase_col<LAYOUT>(vn, pwn, w, s)];
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
          const float t = ct * (vss::div_rn(up[j], sum, rs) - (c == lab ? 1.f : 0.f));
          acc0[j] += wa * t;
          acc1[j] += wb * t;
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
// partial plus the lower one's, in that order, stored as O (bf16 rounded, or
// f32 as it is)
template <typename O>
__global__ void ce_bwd_combine_kernel(const float* __restrict__ part, O* __restrict__ out, int N,
                                      int h, int w, int C, int nseg) {
  const long long row = (long long)w * C;
  const long long total = (long long)N * (nseg - 1) * 2 * row;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const long long e = i % row, t = i / row;
    const int rr = (int)(t % 2), j = (int)(t / 2 % (nseg - 1)), n = (int)(t / 2 / (nseg - 1));
    const int b = (int)((long long)(j + 1) * h / nseg);
    const float* p = part + (((long long)n * (nseg - 1) + j) * 4 + rr) * row + e;
    store_out(out + ((long long)n * h + b - 1 + rr) * row + e, p[0] + p[2 * row]);
  }
}

template <int G, int CPL, typename L, int LAYOUT, typename O>
int launch_bwd_gc(const void* x, const void* labels, const void* g, void* out, void* part, int N, int h, int w, int C, int s, float img_w, int tw, int nseg,
                  int cs, int loop_coeffs, cudaStream_t st) {
  const long long units = (long long)N * nseg * ((w + tw - 1) / tw);
  const unsigned blocks = (unsigned)((units + kBwdWarps - 1) / kBwdWarps);
  const size_t bytes = (size_t)kBwdWarps * 2 * tw * cs * sizeof(float);
  static bool attr = false;  // one instance per template: set its limit once
  if (!attr) {
    cudaError_t e = cudaFuncSetAttribute(ce_bwd_kernel<G, CPL, L, LAYOUT, O>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, 200 * 1024);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  auto* ob = static_cast<O*>(out);
  auto* pb = static_cast<float*>(part);
  ce_bwd_kernel<G, CPL, L, LAYOUT, O><<<blocks, 32 * kBwdWarps, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const L*>(labels),
      static_cast<const float*>(g), ob, pb, N, h, w, C, s, img_w, tw, nseg, cs, loop_coeffs);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || nseg < 2) return (int)e;
  const long long total = (long long)N * (nseg - 1) * 2 * w * C;
  const long long cblocks = (total + 255) / 256;
  const unsigned cb = (unsigned)(cblocks < 132 * 16 ? cblocks : 132 * 16);
  ce_bwd_combine_kernel<O><<<cb, 256, 0, st>>>(pb, ob, N, h, w, C, nseg);
  return (int)cudaGetLastError();
}

// classes: G lanes a pixel, CPL classes a lane (ops/ce_upsampled.py
// ce_bwd_groups has the same table)
template <typename L, int LAYOUT = kNatural, typename O = __nv_bfloat16>
int launch_bwd(const void* x, const void* labels, const void* g, void* out, void* part, int N,
               int h, int w, int C, int s, float img_w, int tw, int nseg, int cs, cudaStream_t st,
               int loop_coeffs = 0) {
#define VSS_CE_BWD(G, K) \
  return launch_bwd_gc<G, K, L, LAYOUT, O>(x, labels, g, out, part, N, h, w, C, s, img_w, tw, \
                                           nseg, cs, loop_coeffs, st)
  if (C <= 32) VSS_CE_BWD(4, 8);
  if (C <= 64) VSS_CE_BWD(8, 8);
  if (C <= 128) VSS_CE_BWD(8, 16);
  if (C <= 256) VSS_CE_BWD(16, 16);
#undef VSS_CE_BWD
  return (int)cudaErrorInvalidValue;
}

// blocks of a backward instance one SM holds with `bytes` of dynamic shared
// memory; bwd_occupancy: the loss's, uint8 labels in `layout` (bf16 out for
// natural labels, f32 for phase labels)
template <typename Kernel>
int bwd_blocks(Kernel kernel, size_t bytes) {
  int b = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 200 * 1024) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, kernel, 32 * kBwdWarps, bytes) !=
          cudaSuccess)
    return -1;
  return b;
}
template <int G, int CPL>
int bwd_occupancy(size_t bytes, int layout) {
  if (layout == kHMajor)
    return bwd_blocks(ce_bwd_kernel<G, CPL, unsigned char, kHMajor, float>, bytes);
  if (layout == kWMajor)
    return bwd_blocks(ce_bwd_kernel<G, CPL, unsigned char, kWMajor, float>, bytes);
  return bwd_blocks(ce_bwd_kernel<G, CPL, unsigned char, kNatural, __nv_bfloat16>, bytes);
}

// the plan's checks: a strip of 1..64 columns, segments of at least 2 rows
// (or one segment), the column stride holding the classes
inline bool bwd_plan_ok(int h, int C, int tw, int nseg, int cs, const void* part) {
  const int cp = C <= 32 ? 32 : C <= 64 ? 64 : C <= 128 ? 128 : 256;
  return tw >= 1 && tw <= 64 && nseg >= 1 && (nseg == 1 || (h / nseg >= 2 && part != nullptr)) &&
         cs >= cp;
}

// ---- the forward: bands of output rows, strips of source columns -----------
//
// A unit is one warp's work: frame n, a band of NG = 32 / G consecutive output
// rows [Y0, Y0 + NG) and a strip [v0, v1) of source columns, whose output
// columns [s*v0, s*v1) it computes: every output pixel belongs to exactly one
// unit, so each softmax is computed once. The warp first copies what the
// unit reads into its share of shared memory, with every load in flight at
// once (cp.async): the source rows the band's output rows lerp from (clamped
// to the map), each at the columns max(v0 - 1, 0) .. min(v1, w - 1) as the
// one contiguous run it is in device memory, and the band's labels as int16
// (-1 outside [0, C)), read in natural layout as one run a row, or in the
// w-major phase layout (rows 16 and 18) at each row's base plus each
// column's offset, runs of s bytes s*s apart, as the backward reads them
// (phase_row, phase_col). So each source element is read from device memory once
// per band, and the loop below reads nothing from device memory. (Copied
// pixel by pixel into a padded layout, the copy took as long as the loop.)
// Lane group gi takes output row Y0 + gi (a row past H, in a frame's ragged
// last band, computes its clamped twin and keeps nothing); its G lanes hold
// the classes gl*CPL .. gl*CPL + CPL - 1, so the max and the sum take log2(G)
// shuffles. The groups walk the strip's output columns in lockstep, at one
// column phase: each keeps the row-lerped logits of its window's two source
// columns and their difference in registers and, when the window slides,
// lerps the next column from shared memory, a class past C read as -2^99. So
// no max, exp or sum needs a mask: exp(up - m) is exactly 0 for it. The owner
// of the label's class (one lane of the group) takes up[label] by a select
// tree and stages (m, sum, up[label]) and, for the maps, the group's first
// maximum (torch's argmax tie order); the unit's logs are then taken all
// lanes at once: lse = m + log(sum). The loss (PIXEL = false):
// the warp's (img_w * sum of lse - up[label], count of up[label] == m) over
// its valid pixels goes to partial[2 * unit], no atomics, one torch.sum
// outside. The maps (PIXEL = true): nll, pred and lse, written with 16-byte
// stores.
//
// Every loop over a lane's classes has a constant count at every level (the
// trees are template recursions): a tree written as a loop over levels was
// not unrolled, and its array went to local memory on every pixel.

constexpr int kFwdWarps = 4;
constexpr int kFwdMaxStrip = 15;             // ops/ce_upsampled.py _CE_FWD_STRIPS[0]
constexpr unsigned kPad = 0xF100u;           // bf16 -2^99: the logit of a class past C

// Shared memory of one warp, in bytes (ops/ce_upsampled.py ce_fwd_smem has the
// same layout): the source rows, bf16 [fwd_rows][fwd_row_len] (a row's tw + 2
// columns of C classes, rounded up to 16 bytes); the staged per-pixel values,
// f32 / int32 [3 or 4][ng][s * tw] (m, sum, up[label], and for the maps
// pred); the labels, int16 [ng][s * tw]; rounded up to 16.
__host__ __device__ constexpr int fwd_rows(int ng, int s) { return (ng + s - 2) / s + 2; }
__host__ __device__ constexpr int fwd_row_len(int C, int tw) { return ((tw + 2) * C + 7) / 8 * 8; }
__host__ __device__ constexpr int fwd_stage_at(int ng, int C, int s, int tw) {
  return fwd_rows(ng, s) * fwd_row_len(C, tw) * 2;
}
__host__ __device__ constexpr int fwd_labels_at(int ng, int C, int s, int tw, bool pixel) {
  return fwd_stage_at(ng, C, s, tw) + (pixel ? 4 : 3) * ng * s * tw * 4;
}
__host__ __device__ constexpr int fwd_warp_bytes(int ng, int C, int s, int tw, bool pixel) {
  return (fwd_labels_at(ng, C, s, tw, pixel) + ng * s * tw * 2 + 15) / 16 * 16;
}

// 2^x on the MUFU (ex2.approx.ftz: relative error about 2^-22, results below
// 2^-126 flushed to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(vss::smem_addr(dst)), "l"(src));
}

// the classes c0 .. c0 + CPL - 1 of the source pixel at p (its class 0, in
// shared memory) as raw bf16 pairs, class c0 + 2i in the low half of raw[i],
// a class past C as -2^99; vec: C % 4 == 0, so every 4 classes are one 8-byte
// load
template <int CPL>
__device__ __forceinline__ void classes_smem(const unsigned short* p, int c0, int C, bool vec,
                                             unsigned (&raw)[CPL / 2]) {
  if (vec) {
#pragma unroll
    for (int q = 0; q < CPL / 4; ++q) {
      uint2 u = make_uint2(kPad | kPad << 16, kPad | kPad << 16);
      if (c0 + 4 * q < C) u = *reinterpret_cast<const uint2*>(p + c0 + 4 * q);
      raw[2 * q] = u.x;
      raw[2 * q + 1] = u.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < CPL / 2; ++i) {
      const int c = c0 + 2 * i;
      raw[i] = (c < C ? p[c] : kPad) | (c + 1 < C ? p[c + 1] : kPad) << 16;
    }
  }
}

// xh = x0 + fh * (x1 - x0) for a lane's CPL classes of the source pixels at
// a (row r0) and b (row r1)
template <int CPL>
__device__ __forceinline__ void lerp_smem(const unsigned short* a, const unsigned short* b,
                                          int c0, int C, bool vec, float fh, float* xh) {
  unsigned ra[CPL / 2], rb[CPL / 2];
  classes_smem<CPL>(a, c0, C, vec, ra);
  classes_smem<CPL>(b, c0, C, vec, rb);
#pragma unroll
  for (int i = 0; i < CPL / 2; ++i) {
    const float a0 = __uint_as_float(ra[i] << 16), a1 = __uint_as_float(ra[i] & 0xffff0000u);
    const float b0 = __uint_as_float(rb[i] << 16), b1 = __uint_as_float(rb[i] & 0xffff0000u);
    xh[2 * i] = fmaf(fh, b0 - a0, a0);
    xh[2 * i + 1] = fmaf(fh, b1 - a1, a1);
  }
}

// The trees over a lane's values, level by level at compile-time widths W:
// t[i] op= t[i + W] for i < W, then W / 2 (a fixed order: deterministic).
template <int W>
__device__ __forceinline__ void select_levels(float* t, int j) {
  if constexpr (W >= 1) {
    const bool hi = (j & W) != 0;
#pragma unroll
    for (int i = 0; i < W; ++i) t[i] = hi ? t[i + W] : t[i];
    select_levels<W / 2>(t, j);
  }
}
template <int W>
__device__ __forceinline__ void max_levels(float* t) {
  if constexpr (W >= 1) {
#pragma unroll
    for (int i = 0; i < W; ++i) t[i] = fmaxf(t[i], t[i + W]);
    max_levels<W / 2>(t);
  }
}
template <int W>
__device__ __forceinline__ void sum_levels(float* t) {
  if constexpr (W >= 1) {
#pragma unroll
    for (int i = 0; i < W; ++i) t[i] += t[i + W];
    sum_levels<W / 2>(t);
  }
}
template <int W>
__device__ __forceinline__ void min_levels(int* t) {
  if constexpr (W >= 1) {
#pragma unroll
    for (int i = 0; i < W; ++i) t[i] = min(t[i], t[i + W]);
    min_levels<W / 2>(t);
  }
}

// v[j] for a runtime j in [0, CPL) (a runtime index into a register array would
// go through local memory)
template <int CPL>
__device__ __forceinline__ float select_class(const float (&v)[CPL], int j) {
  float t[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) t[i] = v[i];
  select_levels<CPL / 2>(t, j);
  return t[0];
}
template <int CPL>
__device__ __forceinline__ float lane_max(const float (&v)[CPL]) {
  float t[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) t[i] = v[i];
  max_levels<CPL / 2>(t);
  return t[0];
}
template <int CPL>
__device__ __forceinline__ float lane_sum(const float (&v)[CPL]) {
  float t[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) t[i] = v[i];
  sum_levels<CPL / 2>(t);
  return t[0];
}
// the smallest class c0 + j whose v[j] equals m, or INT_MAX
template <int CPL>
__device__ __forceinline__ int lane_first(const float (&v)[CPL], float m, int c0) {
  int t[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) t[i] = v[i] == m ? c0 + i : 0x7fffffff;
  min_levels<CPL / 2>(t);
  return t[0];
}

template <int G>
__device__ __forceinline__ int group_min(int v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// PIXEL = false: the loss, partial[2 * unit] = (img_w * sum, count) over the
// unit's valid pixels. PIXEL = true: the maps nll, pred, lse. LAYOUT: the
// labels' layout (w-major only for the loss). loop_coeffs: the phase
// coefficients in f32 from the phase index, as the TPU's runtime phase loop
// takes them (row 18), else Coeffs' rule.
template <int G, int CPL, typename L, bool PIXEL, int LAYOUT>
__global__ void __launch_bounds__(32 * kFwdWarps, 4) ce_fwd_kernel(
    const __nv_bfloat16* __restrict__ x, const L* __restrict__ labels,
    float* __restrict__ partial, float* __restrict__ nll, int* __restrict__ pred,
    float* __restrict__ lse, int N, int h, int w, int C, int s, float img_w, int count_acc,
    int tw, int loop_coeffs) {
  static_assert(LAYOUT == kNatural || (LAYOUT == kWMajor && !PIXEL),
                "phase labels: w-major, the loss only");
  constexpr int NG = 32 / G;
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  __shared__ float sf[kMaxScale];
  __shared__ int sd[kMaxScale];
  if (threadIdx.x < s) {  // the coefficients of phase p, with no array in local memory
    const int p = threadIdx.x;
    if (loop_coeffs) {
      const float d = ((float)p + 0.5f) / (float)s - 0.5f;
      sd[p] = d < 0.f ? -1 : 0;
      sf[p] = d - (float)sd[p];
    } else {
      const double d = (p + 0.5) / s - 0.5;
      sd[p] = d < 0.0 ? -1 : 0;
      sf[p] = (float)(d - sd[p]);
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gi = lane / G, gl = lane % G, c0 = gl * CPL;
  const int H = h * s, W = w * s;
  const int nband = (H + NG - 1) / NG, nstrip = (w + tw - 1) / tw;
  const long long unit = (long long)blockIdx.x * kFwdWarps + warp;
  if (unit >= (long long)N * nband * nstrip) return;
  const int band = (int)(unit % nband), strip = (int)(unit / nband % nstrip);
  const int n = (int)(unit / nband / nstrip);
  const int v0 = strip * tw, v1 = min(v0 + tw, w);
  const int xa = s * v0, cnt = s * (v1 - v0), srow = s * tw;
  const int Y0 = band * NG, live = min(NG, H - Y0);  // the band's output rows in the map
  const int Yc = Y0 + min(gi, live - 1);
  const int ph = Yc % s;
  const float fh = sf[ph];

  // the unit's source rows (clamped rows rr0 .. rr1, each at the clamped
  // columns cc0 .. cc1) and labels
  unsigned char* wsm = fwd_smem + (size_t)warp * fwd_warp_bytes(NG, C, s, tw, PIXEL);
  unsigned short* xs = reinterpret_cast<unsigned short*>(wsm);
  float* stage = reinterpret_cast<float*>(wsm + fwd_stage_at(NG, C, s, tw));
  short* lab_s = reinterpret_cast<short*>(wsm + fwd_labels_at(NG, C, s, tw, PIXEL));
  const int Yl = Y0 + live - 1;
  const int rr0 = clampi(Y0 / s + sd[Y0 % s], 0, h - 1);
  const int rr1 = clampi(Yl / s + sd[Yl % s] + 1, 0, h - 1);
  const int cc0 = max(v0 - 1, 0), run = (min(v1, w - 1) - cc0 + 1) * C;
  const int rlen = fwd_row_len(C, tw);
  const bool vec = (C & 3) == 0;
  for (int r = rr0; r <= rr1; ++r) {
    const __nv_bfloat16* src = x + (((long long)n * h + r) * w + cc0) * C;
    unsigned short* dst = xs + (r - rr0) * rlen;
    if (vec) {
      for (int e = 4 * lane; e < run; e += 128) cp_async8(dst + e, src + e);
    } else {
      const unsigned short* s16 = reinterpret_cast<const unsigned short*>(src);
      for (int e = lane; e < run; e += 32) dst[e] = __ldg(s16 + e);
    }
  }
  vss::cp_async_commit();
  // a phase read's (i / s, i % s) at i = lane, and their step as i goes on by
  // 32 (a division a label took the kernel ~2 % longer at N 8 on the H100)
  const int lane_q = lane / s, lane_r = lane - lane_q * s;
  const int step_q = 32 / s, step_r = 32 - step_q * s;
  for (int g = 0; g < NG; ++g) {
    const int Y = Y0 + min(g, live - 1);
    if constexpr (LAYOUT == kNatural) {
      const L* lr = labels + ((long long)n * H + Y) * W + xa;
      for (int i = lane; i < cnt; i += 32) {
        const int lb = (int)lr[i];
        lab_s[g * srow + i] = (short)(lb >= 0 && lb < C ? lb : -1);
      }
    } else {  // output column xa + i = s (v0 + q) + r, (q, r) = (i / s, i % s) stepped with i
      const L* lr = labels + phase_row<LAYOUT>(n, h, w, s, Y / s, Y % s);
      int q = lane_q, r = lane_r;
      for (int i = lane; i < cnt; i += 32) {
        const int lb = (int)lr[phase_col<LAYOUT>(v0 + q, r, w, s)];
        lab_s[g * srow + i] = (short)(lb >= 0 && lb < C ? lb : -1);
        q += step_q;
        r += step_r;
        if (r >= s) {
          r -= s;
          ++q;
        }
      }
    }
  }
  vss::cp_async_wait<0>();
  __syncwarp();

  // the group's two source rows, and its window: row-lerped raw source
  // columns wc (xl) and wc + 1 (xr), dd = xr - xl; raw column col of a
  // staged row lies at (clamp(col) - cc0) * C
  const int k = Yc / s;
  const unsigned short* xr0 = xs + (clampi(k + sd[ph], 0, h - 1) - rr0) * rlen - cc0 * C;
  const unsigned short* xr1 = xs + (clampi(k + sd[ph] + 1, 0, h - 1) - rr0) * rlen - cc0 * C;
  float xl[CPL], xr[CPL], dd[CPL], up[CPL];
  int wc = v0 + sd[0];
  int cl = clampi(wc, 0, w - 1) * C, cr = clampi(wc + 1, 0, w - 1) * C;
  lerp_smem<CPL>(xr0 + cl, xr1 + cl, c0, C, vec, fh, xl);
  lerp_smem<CPL>(xr0 + cr, xr1 + cr, c0, C, vec, fh, xr);
#pragma unroll
  for (int j = 0; j < CPL; ++j) dd[j] = xr[j] - xl[j];

  const short* my_lab = lab_s + gi * srow;
  float* st_m = stage + gi * srow;  // [map][gi][column]: m, sum, up[label], pred
  int pw = 0, v = v0;
  for (int jx = 0; jx < cnt; ++jx) {
    const int lab = my_lab[jx];
    const float fw = sf[pw];
#pragma unroll
    for (int j = 0; j < CPL; ++j) up[j] = fmaf(fw, dd[j], xl[j]);
    const int cls = lab >= 0 ? lab : 0;  // the maps' safe label
    const bool owner = (PIXEL || lab >= 0) && gi < live && cls / CPL == gl;
    const float picked = select_class<CPL>(up, cls & (CPL - 1));
    const float m = group_max<G>(lane_max<CPL>(up));
    int am = 0;
    if constexpr (PIXEL) am = group_min<G>(lane_first<CPL>(up, m, c0));
    // exp(up - m) = 2^(up log2 e - m log2 e), the argument one fma: its
    // rounding (|up - m| log2 e 2^-24) and the MUFU's keep each term within
    // ~1e-6 relative for the logits' spread; expf's range reduction took 8
    // instructions a class more and the kernel 17 % longer
    const float ml = m * 1.4426950408889634f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) up[j] = ex2(fmaf(up[j], 1.4426950408889634f, -ml));
    const float sum = group_sum<G>(lane_sum<CPL>(up));
    if (owner) {
      st_m[jx] = m;
      st_m[NG * srow + jx] = sum;
      st_m[2 * NG * srow + jx] = picked;
      if constexpr (PIXEL) st_m[3 * NG * srow + jx] = __int_as_float(am);
    }
    // the next column phase; the window slides when its first column moves
    int pwn = pw + 1, vn = v;
    if (pwn == s) {
      pwn = 0;
      ++vn;
    }
    if (jx + 1 < cnt && vn + sd[pwn] > wc) {
      ++wc;
#pragma unroll
      for (int j = 0; j < CPL; ++j) xl[j] = xr[j];
      cr = clampi(wc + 1, 0, w - 1) * C;
      lerp_smem<CPL>(xr0 + cr, xr1 + cr, c0, C, vec, fh, xr);
#pragma unroll
      for (int j = 0; j < CPL; ++j) dd[j] = xr[j] - xl[j];
    }
    pw = pwn;
    v = vn;
  }
  __syncwarp();

  // the logs, all lanes at once over the unit's staged pixels
  const float* sm = stage;
  const float* ss = stage + NG * srow;
  const float* sp = stage + 2 * NG * srow;
  if constexpr (PIXEL) {
    const float* sa = stage + 3 * NG * srow;
    for (int g = 0; g < live; ++g) {
      const long long o = ((long long)n * H + Y0 + g) * W + xa;
      const int b = g * srow;
      // pixels [0, head) and [head + 4 * nv, cnt) one a lane, the rest four a
      // lane as 16-byte stores
      const int head = min(cnt, (int)((4 - (o & 3)) & 3)), nv = (cnt - head) >> 2;
      for (int i = lane; i < cnt; i += 32) {
        if (i < head || i >= head + 4 * nv) {
          const float ls = sm[b + i] + logf(ss[b + i]);
          nll[o + i] = ls - sp[b + i];
          pred[o + i] = __float_as_int(sa[b + i]);
          lse[o + i] = ls;
        }
      }
      for (int q = lane; q < nv; q += 32) {
        const int i = b + head + 4 * q;
        float l4[4], n4[4];
        int p4[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          l4[e] = sm[i + e] + logf(ss[i + e]);
          n4[e] = l4[e] - sp[i + e];
          p4[e] = __float_as_int(sa[i + e]);
        }
        const long long oq = o + head + 4 * q;
        *reinterpret_cast<float4*>(nll + oq) = make_float4(n4[0], n4[1], n4[2], n4[3]);
        *reinterpret_cast<int4*>(pred + oq) = make_int4(p4[0], p4[1], p4[2], p4[3]);
        *reinterpret_cast<float4*>(lse + oq) = make_float4(l4[0], l4[1], l4[2], l4[3]);
      }
    }
  } else {
    float tot = 0.f, cor = 0.f;
    for (int i = lane; i < live * cnt; i += 32) {
      const int g = i / cnt, b = g * srow + (i - g * cnt);
      if (lab_s[b] >= 0) {
        tot += (sm[b] + logf(ss[b])) - sp[b];
        if (count_acc && sp[b] == sm[b]) cor += 1.f;
      }
    }
    tot = vss::warp_sum(tot);
    cor = vss::warp_sum(cor);
    if (lane == 0) {
      partial[2 * unit] = tot * img_w;
      partial[2 * unit + 1] = cor;
    }
  }
}

template <int G, int CPL, typename L, bool PIXEL, int LAYOUT>
int launch_fwd_gc(const void* x, const void* labels, void* partial, void* nll, void* pred,
                  void* lse, int N, int h, int w, int C, int s, float img_w, int count_acc, int tw,
                  int loop_coeffs, cudaStream_t st) {
  constexpr int NG = 32 / G;
  const long long units = (long long)N * ((h * s + NG - 1) / NG) * ((w + tw - 1) / tw);
  const unsigned blocks = (unsigned)((units + kFwdWarps - 1) / kFwdWarps);
  const size_t bytes = (size_t)kFwdWarps * fwd_warp_bytes(NG, C, s, tw, PIXEL);
  static bool attr = false;  // one instance per template: set its limit once
  if (!attr) {
    cudaError_t e = cudaFuncSetAttribute(ce_fwd_kernel<G, CPL, L, PIXEL, LAYOUT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, 200 * 1024);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  ce_fwd_kernel<G, CPL, L, PIXEL, LAYOUT><<<blocks, 32 * kFwdWarps, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const L*>(labels),
      static_cast<float*>(partial), static_cast<float*>(nll), static_cast<int*>(pred),
      static_cast<float*>(lse), N, h, w, C, s, img_w, count_acc, tw, loop_coeffs);
  return (int)cudaGetLastError();
}

// the band 32 / G of the table below
inline int fwd_ng(int C) { return C <= 32 ? 8 : C <= 128 ? 4 : 2; }

// the backward's table of (G, CPL) (ops/ce_upsampled.py ce_bwd_groups)
template <typename L, bool PIXEL, int LAYOUT = kNatural>
int launch_fwd(const void* x, const void* labels, void* partial, void* nll, void* pred, void* lse,
               int N, int h, int w, int C, int s, float img_w, int count_acc, int tw,
               cudaStream_t st, int loop_coeffs = 0) {
#define VSS_CE_FWD(G, K) \
  return launch_fwd_gc<G, K, L, PIXEL, LAYOUT>(x, labels, partial, nll, pred, lse, N, h, w, C, s, \
                                               img_w, count_acc, tw, loop_coeffs, st)
  if (C <= 32) VSS_CE_FWD(4, 8);
  if (C <= 64) VSS_CE_FWD(8, 8);
  if (C <= 128) VSS_CE_FWD(8, 16);
  if (C <= 256) VSS_CE_FWD(16, 16);
#undef VSS_CE_FWD
  return (int)cudaErrorInvalidValue;
}

// blocks of an instance one SM holds with `bytes` of dynamic shared memory
// (uint8 labels)
template <int G, int CPL, bool PIXEL, int LAYOUT = kNatural>
int fwd_occupancy(size_t bytes) {
  auto* kernel = ce_fwd_kernel<G, CPL, unsigned char, PIXEL, LAYOUT>;
  int b = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 200 * 1024) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, kernel, 32 * kFwdWarps, bytes) !=
          cudaSuccess)
    return -1;
  return b;
}

// the plan's checks: a strip of 1..kFwdMaxStrip columns whose block fits the
// shared memory the launch allows (ops/ce_upsampled.py ce_fwd_plan keeps 4
// blocks an SM where it can)
inline bool fwd_plan_ok(int C, int s, int tw) {
  return tw >= 1 && tw <= kFwdMaxStrip &&
         kFwdWarps * fwd_warp_bytes(fwd_ng(C), C, s, tw, true) <= 200 * 1024;
}

}  // namespace

// logits (N, h, w, C) bf16; labels (N, h*s, w*s) uint8 (labels_i32 = 0) or
// int32; in strips of tw (1..15) source columns (ops/ce_upsampled.py
// ce_fwd_plan), partial (units, 2) f32 receives (img_w * sum, count) per unit
// (ce_fwd_units). C <= 256, 1 <= s <= 8. Returns a cudaError_t.
VSS_EXPORT int ce_fwd_loss(const void* logits, const void* labels, void* partial, int N, int h,
                           int w, int C, int s, int labels_i32, float img_w, int count_acc, int tw,
                           int device, void* stream) {
  vss::use_device(device);
  if ((long long)N * h * w == 0) return 0;
  if (s < 1 || s > kMaxScale || C < 1 || C > 256 || !fwd_plan_ok(C, s, tw))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return labels_i32 ? launch_fwd<int, false>(logits, labels, partial, nullptr, nullptr, nullptr, N,
                                             h, w, C, s, img_w, count_acc, tw, st)
                    : launch_fwd<unsigned char, false>(logits, labels, partial, nullptr, nullptr,
                                                       nullptr, N, h, w, C, s, img_w, count_acc,
                                                       tw, st);
}

// ce_fwd_loss's function with uint8 labels in the TPU kernels' w-major phase
// layout (N, h, w, s*s), the label of output pixel (s k + ph, s v + pw) at
// [n, k, v, ph s + pw] (rows 16 and 18); loop_coeffs: the phase coefficients
// in f32 from the phase index (row 18's runtime phase loop), else in double
// as ce_fwd_loss takes them. The plan and partial as for ce_fwd_loss.
VSS_EXPORT int ce_fwd_loss_phase(const void* logits, const void* labels, void* partial, int N,
                                 int h, int w, int C, int s, int loop_coeffs, float img_w,
                                 int count_acc, int tw, int device, void* stream) {
  vss::use_device(device);
  if ((long long)N * h * w == 0) return 0;
  if (s < 1 || s > kMaxScale || C < 1 || C > 256 || !fwd_plan_ok(C, s, tw))
    return (int)cudaErrorInvalidValue;
  return launch_fwd<unsigned char, false, kWMajor>(
      logits, labels, partial, nullptr, nullptr, nullptr, N, h, w, C, s, img_w, count_acc, tw,
      reinterpret_cast<cudaStream_t>(stream), loop_coeffs);
}

// Bytes of dynamic shared memory a block of ce_fwd_loss (pixel = 0) or
// ce_fwd_nll (pixel = 1) takes at C classes, scale s and strips of tw.
VSS_EXPORT int ce_fwd_smem_bytes(int C, int s, int tw, int pixel) {
  return kFwdWarps * fwd_warp_bytes(fwd_ng(C), C, s, tw, pixel != 0);
}

// Blocks of ce_fwd_loss (pixel = 0) or ce_fwd_nll (pixel = 1) one SM holds at
// C classes, scale s and strips of tw (the CUDA occupancy query, uint8
// labels); -1 on an error.
VSS_EXPORT int ce_fwd_blocks_per_sm(int C, int s, int tw, int pixel) {
  const size_t bytes = (size_t)kFwdWarps * fwd_warp_bytes(fwd_ng(C), C, s, tw, pixel != 0);
#define VSS_CE_OCC(G, K) \
  return pixel ? fwd_occupancy<G, K, true>(bytes) : fwd_occupancy<G, K, false>(bytes)
  if (C <= 32) VSS_CE_OCC(4, 8);
  if (C <= 64) VSS_CE_OCC(8, 8);
  if (C <= 128) VSS_CE_OCC(8, 16);
  if (C <= 256) VSS_CE_OCC(16, 16);
#undef VSS_CE_OCC
  return -1;
}

// Blocks of ce_fwd_loss_phase one SM holds at C classes, scale s and strips
// of tw (the CUDA occupancy query); -1 on an error.
VSS_EXPORT int ce_fwd_phase_blocks_per_sm(int C, int s, int tw) {
  const size_t bytes = (size_t)kFwdWarps * fwd_warp_bytes(fwd_ng(C), C, s, tw, false);
  if (C <= 32) return fwd_occupancy<4, 8, false, kWMajor>(bytes);
  if (C <= 64) return fwd_occupancy<8, 8, false, kWMajor>(bytes);
  if (C <= 128) return fwd_occupancy<8, 16, false, kWMajor>(bytes);
  if (C <= 256) return fwd_occupancy<16, 16, false, kWMajor>(bytes);
  return -1;
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
  return labels_i32 ? launch_bwd<int>(logits, labels, g, out, part, N, h, w, C, s, img_w, tw,
                                      nseg, cs, st)
                    : launch_bwd<unsigned char>(logits, labels, g, out, part, N, h, w, C, s, img_w,
                                                tw, nseg, cs, st);
}

// dlogits (N, h, w, C) f32 of ce_bwd_loss's function with uint8 labels in a
// TPU phase layout: h-major (N, h, s*s, w) (w_major = 0, row 15) or w-major
// (N, h, w, s*s) (w_major = 1, row 19); loop_coeffs: the phase coefficients
// in f32 from the phase index (row 19's runtime phase loop), else in double
// as ce_bwd_loss takes them. The plan and part as for ce_bwd_loss.
VSS_EXPORT int ce_bwd_loss_phase(const void* logits, const void* labels, const void* g,
                                 void* out, void* part, int N, int h, int w, int C, int s,
                                 int w_major, int loop_coeffs, float img_w, int tw, int nseg,
                                 int cs, int device, void* stream) {
  vss::use_device(device);
  if ((long long)N * h * w == 0) return 0;
  if (s < 1 || s > kMaxScale || C < 1 || !bwd_plan_ok(h, C, tw, nseg, cs, part))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return w_major ? launch_bwd<unsigned char, kWMajor, float>(logits, labels, g, out, part, N, h,
                                                              w, C, s, img_w, tw, nseg, cs, st,
                                                              loop_coeffs)
                 : launch_bwd<unsigned char, kHMajor, float>(logits, labels, g, out, part, N, h,
                                                              w, C, s, img_w, tw, nseg, cs, st,
                                                              loop_coeffs);
}

// Blocks of the loss's backward one SM holds at C classes with the plan's
// tw and cs (the CUDA occupancy query, uint8 labels): natural labels and bf16
// out (layout 0, row 17), h-major or w-major labels and f32 out (1, 2: rows
// 15, 19); -1 on an error.
VSS_EXPORT int ce_bwd_blocks_per_sm(int C, int tw, int cs, int layout) {
  if (layout < kNatural || layout > kWMajor) return -1;
  const size_t bytes = (size_t)kBwdWarps * 2 * tw * cs * sizeof(float);
  if (C <= 32) return bwd_occupancy<4, 8>(bytes, layout);
  if (C <= 64) return bwd_occupancy<8, 8>(bytes, layout);
  if (C <= 128) return bwd_occupancy<8, 16>(bytes, layout);
  if (C <= 256) return bwd_occupancy<16, 16>(bytes, layout);
  return -1;
}

// The per-pixel maps of logits (N, h, w, C) bf16 against labels (N, h*s,
// w*s) uint8 (labels_i32 = 0) or int32: nll and lse f32, pred int32, each
// (N, h*s, w*s), in strips of tw (1..15) source columns (ce_fwd_plan).
// C <= 256, 1 <= s <= 8. Returns a cudaError_t.
VSS_EXPORT int ce_fwd_nll(const void* logits, const void* labels, void* nll, void* pred,
                          void* lse, int N, int h, int w, int C, int s, int labels_i32, int tw,
                          int device, void* stream) {
  vss::use_device(device);
  if ((long long)N * h * w == 0) return 0;
  if (s < 1 || s > kMaxScale || C < 1 || C > 256 || !fwd_plan_ok(C, s, tw))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return labels_i32 ? launch_fwd<int, true>(logits, labels, nullptr, nll, pred, lse, N, h, w, C, s,
                                            0.f, 0, tw, st)
                    : launch_fwd<unsigned char, true>(logits, labels, nullptr, nll, pred, lse, N,
                                                      h, w, C, s, 0.f, 0, tw, st);
}
