// The port's host data path: the train clip's pixel work in C++, bit for bit
// the numpy pipeline of data/transforms.py (cv2's fixed-point bilinear
// resize, nearest label windows, flip, the photometric distortion with cv2's
// HSV kernels) and, where the host has libjpeg and libpng, the decodes.
//
// The arithmetic is that of vss_cffm_tpu/native/dataloader.cpp; the source is
// split in two halves:
//   - the pixel half (no header beyond the C++ library, always built):
//       vss_normalize_f32, vss_resize_window_u8c3, vss_cvt_hsv_u8,
//       vss_pmd_apply, vss_label_window, vss_label_window_rows;
//   - the codec half, compiled only with -DVSS_CODECS, where jpeglib.h and
//     png.h are found (linked with -ljpeg -lpng16 -lz then):
//       vss_decode_jpeg, vss_jpeg_dims, vss_png_dims, vss_decode_label,
//       vss_decode_label_band, vss_train_frame, vss_train_clip,
//       vss_train_clip_v2 (JPEG band decode -> window resize -> flip ->
//       photometric distortion, threaded over a clip's frames) and
//       vss_decode_clip_normalized.
//
// Built by vss_cffm_tpu_torch/native/__init__.py with g++ at first use, with
// -ffp-contract=off: every float expression rounds per operation, as numpy
// and cv2 do; the HSV kernel's two fused multiply-adds are explicit fmaf.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#ifdef VSS_CODECS
#include <cstdio>  // jpeglib.h needs FILE declared first

#include <csetjmp>

#include <jpeglib.h>
#include <png.h>
#endif

// ===========================================================================
// The pixel half.
// ===========================================================================

// ---------------------------------------------------------------------------
// cv2-exact INTER_LINEAR resize restricted to a crop window (8U, 3-channel).
//
// OpenCV's 8-bit bilinear path (modules/imgproc/src/resize.cpp) is
// fixed-point: per-axis coefficients are saturate_cast<short>(w * 2048)
// (INTER_RESIZE_COEF_SCALE, round-to-nearest-even), the horizontal pass
// accumulates int rows D[x] = S[sx]*a0 + S[sx+1]*a1, and the vertical pass
// combines rows r0/r1 with betas b0/b1 as
//     dst = (((b0*(r0>>4)) >> 16) + ((b1*(r1>>4)) >> 16) + 2) >> 2.
// Border handling: sx<0 → (sx,fx)=(0,0); sx≥sw-1 → (sx,fx)=(sw-1,0) (the
// second tap then has zero weight; the read index is clamped).
//
// Computing only the columns/rows of the train crop makes the resize cost
// O(crop area), not O(resized-image area) — the resized image (up to
// ratio 2.0 × (853,480) ≈ 1.6 MPx) is never materialized.
// ---------------------------------------------------------------------------

namespace {

struct LinCoef {
  std::vector<int> ofs;      // clamped source index of tap 0 (pixels)
  std::vector<short> alpha;  // 2 per output position: (a0, a1), scale 2048
};

// Coefficients for output positions [o0, o0+n) of a dst-length `dlen` resize
// from src-length `slen` — cv2's exact per-position math. Border handling
// differs by axis in cv2: the *horizontal* loop (resize.cpp xofs setup)
// zeroes the fractional weight at the borders (clamp_frac=true), while the
// *vertical* taps keep the fractional beta and only clamp the row indices at
// fetch time (clamp_frac=false) — getting this wrong shifts the first/last
// output rows of a >1× upscale by ±1 LSB.
LinCoef lin_coeffs(int slen, int dlen, int o0, int n, bool clamp_frac) {
  LinCoef c;
  c.ofs.resize(n);
  c.alpha.resize(2 * n);
  // cv2 computes scale as 1/inv_scale (inv_scale = dst/src) — the double
  // rounding differs from src/dst directly and shifts border coefficients
  // by 1 ULP (±1 LSB output differences otherwise)
  double scale = 1.0 / (static_cast<double>(dlen) / slen);
  for (int i = 0; i < n; ++i) {
    int d = o0 + i;
    float f = static_cast<float>((d + 0.5) * scale - 0.5);
    int s = static_cast<int>(std::floor(f));
    f -= s;
    if (clamp_frac) {
      if (s < 0) {
        s = 0;
        f = 0.f;
      }
      if (s >= slen - 1) {
        s = slen - 1;
        f = 0.f;
      }
    }
    c.ofs[i] = s;  // raw (possibly out-of-range) when !clamp_frac
    c.alpha[2 * i] = static_cast<short>(std::lrintf((1.f - f) * 2048.f));
    c.alpha[2 * i + 1] = static_cast<short>(std::lrintf(f * 2048.f));
  }
  return c;
}

inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

void hresize_row_u8c3(const uint8_t* S, int sw, const LinCoef& cx, int vw,
                      int* D) {
  for (int i = 0; i < vw; ++i) {
    int sx = cx.ofs[i];
    int sx1 = sx + 1 < sw ? sx + 1 : sw - 1;  // clamped; tap-1 weight is 0 there
    int a0 = cx.alpha[2 * i], a1 = cx.alpha[2 * i + 1];
    const uint8_t* p0 = S + static_cast<size_t>(sx) * 3;
    const uint8_t* p1 = S + static_cast<size_t>(sx1) * 3;
    D[i * 3 + 0] = p0[0] * a0 + p1[0] * a1;
    D[i * 3 + 1] = p0[1] * a0 + p1[1] * a1;
    D[i * 3 + 2] = p0[2] * a0 + p1[2] * a1;
  }
}

// Resize (sh, sw, 3) uint8 → the (rh, rw) full-image geometry, emitting only
// the crop window rows [y1, y1+vh) × cols [x1, x1+vw), optionally flipped
// horizontally (train-time flip *after* crop: out col j = window col
// vw-1-j). `out` rows are `out_stride` pixels wide (≥ vw). `src` holds the
// source rows [src_row0, …] only (band decode); indices are global.
void resize_window_impl(const uint8_t* src, int src_row0, int sh, int sw,
                        int rh, int rw, int y1, int x1, int vh, int vw,
                        int flip, uint8_t* out, int out_stride) {
  LinCoef cx = lin_coeffs(sw, rw, x1, vw, /*clamp_frac=*/true);
  LinCoef cy = lin_coeffs(sh, rh, y1, vh, /*clamp_frac=*/false);
  std::vector<int> rows[2];
  rows[0].resize(static_cast<size_t>(vw) * 3);
  rows[1].resize(static_cast<size_t>(vw) * 3);
  int cached_sy[2] = {-2, -2};
  for (int j = 0; j < vh; ++j) {
    int sy = clampi(cy.ofs[j], 0, sh - 1);
    int sy1 = clampi(cy.ofs[j] + 1, 0, sh - 1);
    int b0 = cy.alpha[2 * j], b1 = cy.alpha[2 * j + 1];
    // rolling 2-row cache: consecutive output rows usually share src rows
    const int* r0 = nullptr;
    const int* r1 = nullptr;
    for (int k = 0; k < 2; ++k) {
      if (cached_sy[k] == sy) r0 = rows[k].data();
      if (cached_sy[k] == sy1) r1 = rows[k].data();
    }
    if (!r0) {
      int slot = (cached_sy[0] != sy1) ? 0 : 1;
      hresize_row_u8c3(src + static_cast<size_t>(sy - src_row0) * sw * 3, sw,
                       cx, vw, rows[slot].data());
      cached_sy[slot] = sy;
      r0 = rows[slot].data();
      if (sy1 == sy) r1 = r0;
    }
    if (!r1) {
      int slot = (cached_sy[0] != sy) ? 0 : 1;
      hresize_row_u8c3(src + static_cast<size_t>(sy1 - src_row0) * sw * 3, sw,
                       cx, vw, rows[slot].data());
      cached_sy[slot] = sy1;
      r1 = rows[slot].data();
    }
    uint8_t* dst = out + static_cast<size_t>(j) * out_stride * 3;
    for (int i = 0; i < vw; ++i) {
      int oi = flip ? (vw - 1 - i) : i;
      for (int ch = 0; ch < 3; ++ch) {
        int v = ((b0 * (r0[i * 3 + ch] >> 4)) >> 16) +
                ((b1 * (r1[i * 3 + ch] >> 4)) >> 16);
        dst[oi * 3 + ch] = static_cast<uint8_t>((v + 2) >> 2);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// cv2-exact uint8 HSV conversions + PhotoMetricDistortion.
//
// The reference's train pipeline applies mmcv's PhotoMetricDistortion per
// frame (brightness/contrast LUTs + saturation/hue edits in HSV space,
// re-rolled per frame — PhotoMetricDistortion_clips, reference
// ``mmseg/datasets/pipelines/transforms.py:2114-2137``). The colorspace
// round-trips dominated the Python path (~2.4 ms/frame of cv2.cvtColor +
// cv2.LUT + interpreter overhead); here the whole distortion runs in one
// C++ pass per frame, bit-identical to cv2:
//   BGR→HSV 8U: OpenCV's fixed-point kernel (hsv_shift=12 division tables,
//     rounded >> — imgproc color_hsv, validated exhaustively over all 2^24
//     BGR values in tests).
//   HSV→BGR 8U: OpenCV's float sector kernel with saturate_cast rounding.
//   brightness/contrast: the numpy LUT math of transforms._convert
//     (f32 i*alpha+beta, clip, truncating uint8 cast).
// ---------------------------------------------------------------------------

constexpr int kHsvShift = 12;

struct HsvTables {
  int sdiv[256];
  int hdiv[256];
  HsvTables() {
    sdiv[0] = hdiv[0] = 0;
    for (int i = 1; i < 256; ++i) {
      // saturate_cast<int>(double) rounds to nearest even (cvRound)
      sdiv[i] = static_cast<int>(std::lrint((255 << kHsvShift) / (1.0 * i)));
      hdiv[i] = static_cast<int>(std::lrint((180 << kHsvShift) / (6.0 * i)));
    }
  }
};

inline const HsvTables& hsv_tables() {
  static const HsvTables t;
  return t;
}

inline void bgr2hsv_px(const uint8_t* p, uint8_t* q) {
  const HsvTables& T = hsv_tables();
  int b = p[0], g = p[1], r = p[2];
  int v = b, vmin = b;
  if (g > v) v = g;
  if (r > v) v = r;
  if (g < vmin) vmin = g;
  if (r < vmin) vmin = r;
  int diff = v - vmin;
  int vr = (v == r) ? -1 : 0;
  int vg = (v == g) ? -1 : 0;
  int s = (diff * T.sdiv[v] + (1 << (kHsvShift - 1))) >> kHsvShift;
  int h = (vr & (g - b)) +
          (~vr & ((vg & (b - r + 2 * diff)) + (~vg & (r - g + 4 * diff))));
  h = (h * T.hdiv[diff] + (1 << (kHsvShift - 1))) >> kHsvShift;
  h += (h < 0) ? 180 : 0;
  q[0] = static_cast<uint8_t>(h);
  q[1] = static_cast<uint8_t>(s);
  q[2] = static_cast<uint8_t>(v);
}

// cv2 5.0's 8U HSV→BGR kernel, fitted empirically and verified bit-exact
// over the exhaustive (180, 256, 256) HSV grid in BOTH dispatch regimes
// (test_native): S/V normalized by f32 1/255 *multiplies*, the fractional-h
// taps are single fused multiply-adds. The ONLY difference between cv2's
// SIMD body and its scalar tail is the final cast of tab*255: the vector
// path TRUNCATES, the scalar tail rounds (cvRound, half-to-even). cv2
// dispatches per image row: 32-pixel vector blocks while i+32 ≤ row width,
// scalar for the remainder — hsv2bgr_row reproduces that split exactly.
// Requires -ffp-contract=off so only the two fmaf's fuse.
inline void hsv2bgr_px(const uint8_t* p, uint8_t* q, bool round_cast) {
  static const int sector_data[6][3] = {{1, 3, 0}, {1, 0, 2}, {3, 0, 1},
                                        {0, 2, 1}, {0, 1, 3}, {2, 1, 0}};
  float h = p[0] * (6.0f / 180.0f);
  float s = p[1] * (1.0f / 255.0f);
  float v = p[2] * (1.0f / 255.0f);
  int sector = static_cast<int>(std::floor(h));
  h -= static_cast<float>(sector);
  sector %= 6;  // p[0] ≤ 255 → h ∈ [0, 8.5) → sector already in range
  float tab[4];
  tab[0] = v;
  tab[1] = v * (1.0f - s);
  tab[2] = v * std::fmaf(-s, h, 1.0f);
  tab[3] = v * std::fmaf(-s, 1.0f - h, 1.0f);
  for (int k = 0; k < 3; ++k) {
    float x = tab[sector_data[sector][k]] * 255.0f;
    if (round_cast) {
      long r = std::lrintf(x);  // half-to-even, like cvRound
      q[k] = static_cast<uint8_t>(r < 0 ? 0 : (r > 255 ? 255 : r));
    } else {
      q[k] = static_cast<uint8_t>(x < 0.0f ? 0.0f : (x > 255.0f ? 255.0f : x));
    }
  }
}

// One image row through cv2's HSV→BGR dispatch (HSV input); see above.
inline void hsv2bgr_row(const uint8_t* src, uint8_t* dst, int n) {
  int vec_n = n & ~31;
  for (int i = 0; i < n; ++i) hsv2bgr_px(src + i * 3, dst + i * 3, i >= vec_n);
}

// In-place BGR→HSV→(H/S LUTs)→BGR round-trip of one image row — the body
// of the reference's saturation / hue jitter (BGR→HSV is dispatch-invariant,
// so only the return conversion needs the positional cast split; the LUT is
// a pure table lookup, identical to cv2.LUT).
inline void hsv_roundtrip_row(uint8_t* row, int n, const uint8_t* hlut,
                              const uint8_t* slut) {
  int vec_n = n & ~31;
  uint8_t hsv[3];
  for (int i = 0; i < n; ++i) {
    uint8_t* px = row + i * 3;
    bgr2hsv_px(px, hsv);
    if (hlut) hsv[0] = hlut[hsv[0]];
    if (slut) hsv[1] = slut[hsv[1]];
    hsv2bgr_px(hsv, px, i >= vec_n);
  }
}

// transforms._convert's LUT: clip(f32(i)*alpha + beta, 0, 255) → uint8
// (numpy .astype truncates; values are already clipped so trunc == floor).
inline void convert_lut(float alpha, float beta, uint8_t* lut) {
  for (int i = 0; i < 256; ++i) {
    float v = static_cast<float>(i) * alpha + beta;
    v = v < 0.0f ? 0.0f : (v > 255.0f ? 255.0f : v);
    lut[i] = static_cast<uint8_t>(v);
  }
}

// PhotoMetricDistortion on the (vh, vw) window of a uint8 BGR image whose
// rows are `stride_px` pixels apart, in place. `P` is the 10-float per-frame
// parameter block drawn by transforms.draw_pmd_params (exact reference RNG
// order):
//   [bright?, beta, contrast_pre?, alpha1, sat?, sat_alpha,
//    hue?, hue_delta, contrast_post?, alpha2]
// Each enabled step runs as its own full pass over the window (LUTs are
// per-pixel independent, so row order within a step is irrelevant), exactly
// mirroring the sequential cv2 pipeline in transforms.photometric_distortion_clip.
void pmd_apply_window(uint8_t* img, int vh, int64_t vw, int64_t stride_px,
                      const float* P) {
  // brightness then pre-mode contrast: two uint8 LUTs compose exactly
  if (P[0] != 0.0f || P[2] != 0.0f) {
    uint8_t lut[256];
    if (P[0] != 0.0f) {
      convert_lut(1.0f, P[1], lut);
      if (P[2] != 0.0f) {
        uint8_t lutc[256];
        convert_lut(P[3], 0.0f, lutc);
        for (int i = 0; i < 256; ++i) lut[i] = lutc[lut[i]];
      }
    } else {
      convert_lut(P[3], 0.0f, lut);
    }
    for (int r = 0; r < vh; ++r) {
      uint8_t* row = img + r * stride_px * 3;
      for (int64_t i = 0; i < vw * 3; ++i) row[i] = lut[row[i]];
    }
  }
  if (P[4] != 0.0f) {  // saturation: BGR→HSV, LUT on S, HSV→BGR
    uint8_t lut[256];
    convert_lut(P[5], 0.0f, lut);
    for (int r = 0; r < vh; ++r)
      hsv_roundtrip_row(img + r * stride_px * 3, static_cast<int>(vw),
                        nullptr, lut);
  }
  if (P[6] != 0.0f) {  // hue: (h + d) mod 180, second HSV round-trip
    int d = static_cast<int>(P[7]);
    uint8_t lut[256];
    for (int i = 0; i < 256; ++i)
      lut[i] = static_cast<uint8_t>(((i + d) % 180 + 180) % 180);
    for (int r = 0; r < vh; ++r)
      hsv_roundtrip_row(img + r * stride_px * 3, static_cast<int>(vw),
                        lut, nullptr);
  }
  if (P[8] != 0.0f) {  // post-mode contrast
    uint8_t lut[256];
    convert_lut(P[9], 0.0f, lut);
    for (int r = 0; r < vh; ++r) {
      uint8_t* row = img + r * stride_px * 3;
      for (int64_t i = 0; i < vw * 3; ++i) row[i] = lut[row[i]];
    }
  }
}

}  // namespace

extern "C" {

// Fused (BGR uint8 → optional RGB flip → f32 (x - mean) / std).
// mean/std given in the *output* channel order (mmcv convention).
void vss_normalize_f32(const uint8_t* src, float* dst, int64_t n_pixels,
                       const float* mean, const float* std_, int to_rgb) {
  float inv0 = 1.0f / std_[0], inv1 = 1.0f / std_[1], inv2 = 1.0f / std_[2];
  float m0 = mean[0], m1 = mean[1], m2 = mean[2];
  if (to_rgb) {
    for (int64_t i = 0; i < n_pixels; ++i) {
      const uint8_t* p = src + i * 3;  // BGR
      float* q = dst + i * 3;          // RGB out
      q[0] = (static_cast<float>(p[2]) - m0) * inv0;
      q[1] = (static_cast<float>(p[1]) - m1) * inv1;
      q[2] = (static_cast<float>(p[0]) - m2) * inv2;
    }
  } else {
    for (int64_t i = 0; i < n_pixels; ++i) {
      const uint8_t* p = src + i * 3;
      float* q = dst + i * 3;
      q[0] = (static_cast<float>(p[0]) - m0) * inv0;
      q[1] = (static_cast<float>(p[1]) - m1) * inv1;
      q[2] = (static_cast<float>(p[2]) - m2) * inv2;
    }
  }
}

void vss_resize_window_u8c3(const uint8_t* src, int sh, int sw, int rh,
                            int rw, int y1, int x1, int vh, int vw, int flip,
                            uint8_t* out, int out_stride) {
  resize_window_impl(src, 0, sh, sw, rh, rw, y1, x1, vh, vw, flip, out,
                     out_stride);
}

// Test hook: uint8 BGR↔HSV on a (rows, cols, 3) image (inverse=0:
// BGR→HSV). Row geometry matters for the inverse direction — cv2 splits
// each row into 32-pixel vector blocks (trunc cast) + scalar tail (round).
void vss_cvt_hsv_u8(const uint8_t* src, uint8_t* dst, int rows, int cols,
                    int inverse) {
  for (int r = 0; r < rows; ++r) {
    const uint8_t* s = src + static_cast<int64_t>(r) * cols * 3;
    uint8_t* d = dst + static_cast<int64_t>(r) * cols * 3;
    if (inverse) {
      hsv2bgr_row(s, d, cols);
    } else {
      for (int i = 0; i < cols; ++i) bgr2hsv_px(s + i * 3, d + i * 3);
    }
  }
}

// PhotoMetricDistortion in place on a contiguous (h, w, 3) uint8 BGR image.
void vss_pmd_apply(uint8_t* img, int h, int64_t w, const float* params) {
  pmd_apply_window(img, h, w, w, params);
}

// ---------------------------------------------------------------------------
// Label path: cv2-exact INTER_NEAREST window resize + band-limited PNG decode.
// ---------------------------------------------------------------------------

// cv2-exact INTER_NEAREST resize of a (sh, sw) uint8 plane to the (rh, rw)
// geometry, emitting only the window rows [y1, y1+vh) × cols [x1, x1+vw),
// optionally h-flipped within the window. cv2's resizeNN index math:
//   ifx = 1/(dst/src) double;  sx = min(floor(x*ifx), src-1)   (no ±0.5)
// `src` holds the source rows [src_row0, …] only (band decode); window
// indices are in the resized geometry, source indices global.
void vss_label_window(const uint8_t* src, int src_row0, int sh, int sw,
                      int rh, int rw, int y1, int x1, int vh, int vw,
                      int flip, uint8_t* out, int out_stride) {
  double ify = 1.0 / (static_cast<double>(rh) / sh);
  double ifx = 1.0 / (static_cast<double>(rw) / sw);
  std::vector<int> xofs(static_cast<size_t>(vw));
  for (int i = 0; i < vw; ++i) {
    int sx = static_cast<int>(std::floor((x1 + i) * ifx));
    xofs[i] = sx < sw - 1 ? sx : sw - 1;
  }
  for (int j = 0; j < vh; ++j) {
    int sy = static_cast<int>(std::floor((y1 + j) * ify));
    sy = sy < sh - 1 ? sy : sh - 1;
    const uint8_t* s = src + static_cast<size_t>(sy - src_row0) * sw;
    uint8_t* d = out + static_cast<size_t>(j) * out_stride;
    if (flip) {
      for (int i = 0; i < vw; ++i) d[vw - 1 - i] = s[xofs[i]];
    } else {
      for (int i = 0; i < vw; ++i) d[i] = s[xofs[i]];
    }
  }
}

// The source row range [r_lo, r_hi] that vss_label_window will touch —
// same double math, so callers can band-decode exactly the needed rows.
void vss_label_window_rows(int sh, int rh, int y1, int vh, int* r_lo,
                           int* r_hi) {
  double ify = 1.0 / (static_cast<double>(rh) / sh);
  int lo = static_cast<int>(std::floor(y1 * ify));
  int hi = static_cast<int>(std::floor((y1 + vh - 1) * ify));
  *r_lo = lo < sh - 1 ? lo : sh - 1;
  *r_hi = hi < sh - 1 ? hi : sh - 1;
}

}  // extern "C"

#ifdef VSS_CODECS

// ===========================================================================
// The codec half.
// ===========================================================================

namespace {

// libjpeg's default error handler exit()s the process; recover via longjmp.
struct JmpErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf env;
};

void jmp_error_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JmpErrorMgr*>(cinfo->err)->env, 1);
}

// ---------------------------------------------------------------------------
// PNG label decode (palette/gray, 8-bit) with fused reduce_zero_label.
//
// VSPW masks are palette PNGs whose *indices* are the class ids; PIL's
// np.array(Image.open(p)) yields the index plane. libpng with palette
// expansion OFF gives the same bytes; reduce_zero (0→255, k→k−1, 254→255 —
// data/vspw.py:reduce_zero_label) is applied via a 256-entry LUT in the same
// pass.
// ---------------------------------------------------------------------------

struct PngReadState {
  const uint8_t* data;
  png_size_t len;
  png_size_t pos;
};

void png_mem_read(png_structp png, png_bytep out, png_size_t n) {
  PngReadState* s = static_cast<PngReadState*>(png_get_io_ptr(png));
  if (s->pos + n > s->len) png_error(png, "png: read past end");
  std::memcpy(out, s->data + s->pos, n);
  s->pos += n;
}

// Decode only the source rows [r0, r1] (inclusive) of a JPEG into `out`
// ((r1-r0+1), sw, 3) BGR. jpeg_skip_scanlines (libjpeg-turbo) skips the
// IDCT/color-convert work for rows above the band; rows below it are
// abandoned via jpeg_abort_decompress.
int decode_jpeg_band(const uint8_t* buf, int64_t len, uint8_t* out, int sh,
                     int sw, int r0, int r1) {
  jpeg_decompress_struct cinfo;
  JmpErrorMgr jerr;
  std::vector<uint8_t> row;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jmp_error_exit;
  if (setjmp(jerr.env)) {
    jpeg_destroy_decompress(&cinfo);
    return 3;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if (static_cast<int>(cinfo.output_height) != sh ||
      static_cast<int>(cinfo.output_width) != sw ||
      cinfo.output_components != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  row.resize(static_cast<size_t>(sw) * 3);
  uint8_t* rowp = row.data();
  if (r0 > 0) jpeg_skip_scanlines(&cinfo, static_cast<JDIMENSION>(r0));
  // jpeg_skip_scanlines may land short of r0 (it skips in iMCU-row units
  // internally but reports the exact count); trust output_scanline.
  while (static_cast<int>(cinfo.output_scanline) <= r1) {
    int y = static_cast<int>(cinfo.output_scanline);
    jpeg_read_scanlines(&cinfo, &rowp, 1);
    if (y < r0) continue;
    uint8_t* dst = out + static_cast<size_t>(y - r0) * sw * 3;
    for (int x = 0; x < sw; ++x) {
      dst[x * 3 + 0] = rowp[x * 3 + 2];
      dst[x * 3 + 1] = rowp[x * 3 + 1];
      dst[x * 3 + 2] = rowp[x * 3 + 0];
    }
  }
  jpeg_abort_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // namespace

extern "C" {

// Decode a JPEG byte buffer to uint8 BGR HWC (cv2 channel order, matching
// mmcv's LoadImageFromFile). Returns 0 on success.
int vss_decode_jpeg(const uint8_t* buf, int64_t len, uint8_t* out, int out_h,
                    int out_w) {
  jpeg_decompress_struct cinfo;
  JmpErrorMgr jerr;
  // Constructed BEFORE setjmp: the longjmp from the libjpeg error handler
  // must not cross the initialization of any non-trivially-destructible
  // automatic object (UB + leak otherwise); declared here, the vector's
  // destructor runs normally on the error-path return.
  std::vector<uint8_t> row;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jmp_error_exit;
  if (setjmp(jerr.env)) {
    jpeg_destroy_decompress(&cinfo);
    return 3;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if (static_cast<int>(cinfo.output_height) != out_h ||
      static_cast<int>(cinfo.output_width) != out_w ||
      cinfo.output_components != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  row.resize(static_cast<size_t>(out_w) * 3);
  uint8_t* rowp = row.data();
  while (cinfo.output_scanline < cinfo.output_height) {
    int y = static_cast<int>(cinfo.output_scanline);
    jpeg_read_scanlines(&cinfo, &rowp, 1);
    uint8_t* dst = out + static_cast<size_t>(y) * out_w * 3;
    // RGB (libjpeg) → BGR (cv2 order)
    for (int x = 0; x < out_w; ++x) {
      dst[x * 3 + 0] = rowp[x * 3 + 2];
      dst[x * 3 + 1] = rowp[x * 3 + 1];
      dst[x * 3 + 2] = rowp[x * 3 + 0];
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

int vss_png_dims(const uint8_t* buf, int64_t len, int* h, int* w) {
  if (len < 8 || png_sig_cmp(buf, 0, 8)) return 1;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return 2;
  }
  PngReadState st{buf, static_cast<png_size_t>(len), 0};
  png_set_read_fn(png, &st, png_mem_read);
  png_read_info(png, info);
  *h = static_cast<int>(png_get_image_height(png, info));
  *w = static_cast<int>(png_get_image_width(png, info));
  png_destroy_read_struct(&png, &info, nullptr);
  return 0;
}

// Decode an 8-bit palette/gray PNG's index plane into `out` (h, w) uint8,
// mapping every byte through `lut` (256 entries). Returns 0 on success.
int vss_decode_label(const uint8_t* buf, int64_t len, uint8_t* out, int out_h,
                     int out_w, const uint8_t* lut) {
  if (len < 8 || png_sig_cmp(buf, 0, 8)) return 1;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  std::vector<uint8_t> row;
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return 2;
  }
  PngReadState st{buf, static_cast<png_size_t>(len), 0};
  png_set_read_fn(png, &st, png_mem_read);
  png_read_info(png, info);
  int h = static_cast<int>(png_get_image_height(png, info));
  int w = static_cast<int>(png_get_image_width(png, info));
  int ctype = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);
  if (h != out_h || w != out_w) {
    png_destroy_read_struct(&png, &info, nullptr);
    return 3;
  }
  if (ctype != PNG_COLOR_TYPE_PALETTE && ctype != PNG_COLOR_TYPE_GRAY) {
    png_destroy_read_struct(&png, &info, nullptr);
    return 4;  // not an index/gray mask — caller falls back to PIL
  }
  if (depth < 8) png_set_packing(png);  // 1/2/4-bit indices → one per byte
  if (depth == 16) png_set_strip_16(png);
  png_read_update_info(png, info);
  if (png_get_rowbytes(png, info) < static_cast<size_t>(w)) {
    png_destroy_read_struct(&png, &info, nullptr);
    return 5;
  }
  row.resize(png_get_rowbytes(png, info));
  for (int y = 0; y < h; ++y) {
    png_read_row(png, row.data(), nullptr);
    uint8_t* dst = out + static_cast<size_t>(y) * w;
    for (int x = 0; x < w; ++x) dst[x] = lut[row[x]];
  }
  png_destroy_read_struct(&png, &info, nullptr);
  return 0;
}

int vss_jpeg_dims(const uint8_t* buf, int64_t len, int* h, int* w) {
  jpeg_decompress_struct cinfo;
  JmpErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jmp_error_exit;
  if (setjmp(jerr.env)) {
    jpeg_destroy_decompress(&cinfo);
    return 3;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  *h = static_cast<int>(cinfo.image_height);
  *w = static_cast<int>(cinfo.image_width);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Band-limited variant of vss_decode_label: decode the index plane rows
// [r0, r1] (inclusive) into `out` ((r1-r0+1), w), mapped through `lut`.
// PNG rows are filter-chained so rows 0..r0-1 are still *read*, but the
// LUT/store work and everything below r1 (often half the image for a train
// crop) is skipped — the read struct is torn down right after row r1.
int vss_decode_label_band(const uint8_t* buf, int64_t len, uint8_t* out,
                          int expect_h, int expect_w, const uint8_t* lut,
                          int r0, int r1) {
  if (len < 8 || png_sig_cmp(buf, 0, 8)) return 1;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  std::vector<uint8_t> row;
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return 2;
  }
  PngReadState st{buf, static_cast<png_size_t>(len), 0};
  png_set_read_fn(png, &st, png_mem_read);
  png_read_info(png, info);
  int h = static_cast<int>(png_get_image_height(png, info));
  int w = static_cast<int>(png_get_image_width(png, info));
  int ctype = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);
  int interlace = png_get_interlace_type(png, info);
  if (h != expect_h || w != expect_w || r0 < 0 || r1 >= h || r0 > r1 ||
      interlace != PNG_INTERLACE_NONE) {
    png_destroy_read_struct(&png, &info, nullptr);
    return 3;
  }
  if (ctype != PNG_COLOR_TYPE_PALETTE && ctype != PNG_COLOR_TYPE_GRAY) {
    png_destroy_read_struct(&png, &info, nullptr);
    return 4;  // not an index/gray mask — caller falls back
  }
  if (depth < 8) png_set_packing(png);
  if (depth == 16) png_set_strip_16(png);
  png_read_update_info(png, info);
  if (png_get_rowbytes(png, info) < static_cast<size_t>(w)) {
    png_destroy_read_struct(&png, &info, nullptr);
    return 5;
  }
  row.resize(png_get_rowbytes(png, info));
  for (int y = 0; y <= r1; ++y) {
    png_read_row(png, row.data(), nullptr);
    if (y < r0) continue;
    uint8_t* dst = out + static_cast<size_t>(y - r0) * w;
    for (int x = 0; x < w; ++x) dst[x] = lut[row[x]];
  }
  png_destroy_read_struct(&png, &info, nullptr);
  return 0;
}

// Fused train frame: JPEG band decode → window resize → flip, writing the
// uint8 BGR crop into `out` (ch, cw, 3), which the caller pre-fills with the
// pad value. (rh, rw) is the full resized geometry int(s·f+0.5); the valid
// window is (min(ch, rh-y1), min(cw, rw-x1)) — the remainder keeps the pad.
// Only the source rows feeding the window are decoded.
int vss_train_frame(const uint8_t* jpeg, int64_t len, int sh, int sw, int rh,
                    int rw, int y1, int x1, int ch, int cw, int flip,
                    uint8_t* out) {
  int vh = rh - y1 < ch ? rh - y1 : ch;
  int vw = rw - x1 < cw ? rw - x1 : cw;
  if (vh <= 0 || vw <= 0) return 0;
  LinCoef cy = lin_coeffs(sh, rh, y1, vh, /*clamp_frac=*/false);
  int r_lo = clampi(cy.ofs[0], 0, sh - 1);
  int r_hi = clampi(cy.ofs[vh - 1] + 1, 0, sh - 1);
  std::vector<uint8_t> band(static_cast<size_t>(r_hi - r_lo + 1) * sw * 3);
  int rc = decode_jpeg_band(jpeg, len, band.data(), sh, sw, r_lo, r_hi);
  if (rc != 0) return rc;
  resize_window_impl(band.data(), r_lo, sh, sw, rh, rw, y1, x1, vh, vw, flip,
                     out, cw);
  return 0;
}

// Threaded per-clip entry: n same-geometry frames → (n, ch, cw, 3) uint8.
int vss_train_clip(const uint8_t** jpegs, const int64_t* lens, int n, int sh,
                   int sw, int rh, int rw, int y1, int x1, int ch, int cw,
                   int flip, uint8_t* out, int n_threads) {
  std::atomic<int> status{0};
  std::atomic<int> next{0};
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      int rc = vss_train_frame(jpegs[i], lens[i], sh, sw, rh, rw, y1, x1, ch,
                               cw, flip,
                               out + static_cast<int64_t>(i) * ch * cw * 3);
      if (rc != 0) {
        int expected = 0;
        status.compare_exchange_strong(expected, rc);
      }
    }
  };
  int workers = n_threads > 0 ? n_threads : 1;
  if (workers > n) workers = n;
  std::vector<std::thread> threads;
  threads.reserve(workers);
  for (int t = 0; t < workers; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return status.load();
}

// v2: vss_train_clip with PhotoMetricDistortion fused into each worker —
// `pmd` is (n, 10) per-frame parameter blocks (see pmd_apply_window), or
// null to skip. The distortion runs on the valid (pre-pad) window while the
// decoded crop is still hot in cache, replacing the Python per-frame
// cvtColor/LUT passes entirely.
int vss_train_clip_v2(const uint8_t** jpegs, const int64_t* lens, int n,
                      int sh, int sw, int rh, int rw, int y1, int x1, int ch,
                      int cw, int flip, const float* pmd, uint8_t* out,
                      int n_threads) {
  int vh = rh - y1 < ch ? rh - y1 : ch;
  int vw = rw - x1 < cw ? rw - x1 : cw;
  std::atomic<int> status{0};
  std::atomic<int> next{0};
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      uint8_t* dst = out + static_cast<int64_t>(i) * ch * cw * 3;
      int rc = vss_train_frame(jpegs[i], lens[i], sh, sw, rh, rw, y1, x1, ch,
                               cw, flip, dst);
      if (rc != 0) {
        int expected = 0;
        status.compare_exchange_strong(expected, rc);
        continue;
      }
      if (pmd != nullptr && vh > 0 && vw > 0)
        pmd_apply_window(dst, vh, vw, cw, pmd + static_cast<int64_t>(i) * 10);
    }
  };
  int workers = n_threads > 0 ? n_threads : 1;
  if (workers > n) workers = n;
  std::vector<std::thread> threads;
  threads.reserve(workers);
  for (int t = 0; t < workers; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return status.load();
}

// Threaded clip decode + fused normalize: n frames, each a JPEG buffer of
// identical dimensions (h, w), into one (n, h, w, 3) f32 tensor.
// Returns 0 on success, else the first nonzero per-frame status.
int vss_decode_clip_normalized(const uint8_t** bufs, const int64_t* lens,
                               int n, int h, int w, const float* mean,
                               const float* std_, int to_rgb, float* out,
                               int n_threads) {
  std::atomic<int> status{0};
  std::atomic<int> next{0};
  auto worker = [&]() {
    std::vector<uint8_t> tmp(static_cast<size_t>(h) * w * 3);
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      int rc = vss_decode_jpeg(bufs[i], lens[i], tmp.data(), h, w);
      if (rc != 0) {
        int expected = 0;
        status.compare_exchange_strong(expected, rc);
        continue;
      }
      vss_normalize_f32(tmp.data(), out + static_cast<int64_t>(i) * h * w * 3,
                        static_cast<int64_t>(h) * w, mean, std_, to_rgb);
    }
  };
  int workers = n_threads > 0 ? n_threads : 1;
  if (workers > n) workers = n;
  std::vector<std::thread> threads;
  threads.reserve(workers);
  for (int t = 0; t < workers; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return status.load();
}


}  // extern "C"

#endif  // VSS_CODECS
