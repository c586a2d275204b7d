// Row 13: the backward of the per-pixel cross-entropy maps on x s
// bilinear-upsampled logits (align_corners = False),
//
//     dlogits = U^T [ g[p] * (exp(up[p] - lse[p]) - onehot(safe label[p])) ]
//
// up = U x, the upsample of the logits x (N, h, w, C) bf16; lse the forward's
// log-sum-exp map and g the per-pixel cotangent, (N, h*s, w*s) f32; the safe
// label is the label, or class 0 outside [0, C) (the caller's g is 0 there);
// dlogits (N, h, w, C) bf16.
//
// Replaces the TPU kernel vss_cffm_tpu/ops/ce_upsampled.py:_ce_bwd_pallas
// (_bwd_kernel), the backward of the per-pixel maps that OHEM and the class
// weights take (ce_upsampled.cu's ce_fwd_nll is their forward).
//
// Bound on the H100 at the "ohem" train step (N 8, h = w = 120, C 124, s 4):
// C exps a pixel whose g is not 0 (~217 M at N 8), which the MUFU (16 ex2 an
// SM a clock) needs ~52 us for; the bytes (logits and lse, g, labels read,
// dlogits written, ~45 MB) ~13 us. With lse given, a class of a pixel is one
// lerp, one fma for the exponent, one ex2 and two fmas into the column
// accumulators: no max, no sum, no shuffle.
// Design:
//  - A unit (one warp) owns the source rows [k_lo, k_hi) of a segment and the
//    source columns [v0, v1) of a strip of one frame and writes them once, in
//    bf16, with 16-byte stores. It computes every output pixel whose bilinear
//    weights reach them: output rows [s k_lo - s/2, s k_hi + s/2) and columns
//    [s v0 - s/2, s v1 + s/2), clipped to the map. The s/2 rows and columns
//    on each side are also computed by the neighbouring units, which keep
//    their own share: (rows + 1) / rows x (tw + 1) / tw the exps, and no
//    partial sums, no second launch (ops/ce_upsampled.py ce_nll_bwd_plan,
//    ce_nll_bwd_units).
//  - The whole warp takes one output pixel at a time, lane l its CPL
//    contiguous classes l CPL .. l CPL + CPL - 1 (4 at C <= 128, 8 at C <=
//    256), so nothing is reduced across lanes. An output row's live pixels
//    (g not 0) are listed first, by a ballot over the warp's pixels: the
//    warp walks the list, so a pixel whose g is 0 costs nothing, not even a
//    step of the loop, and a window with no live pixel is never lerped.
//  - The unit's source rows come in by 16-byte cp.async from device memory,
//    into a ring of three rows of its columns and the column on each side
//    the windows read (the next row in flight while two are read), each row
//    once a unit. The window's two source columns, lerped between the output
//    row's two source rows, sit in registers (8-byte shared loads a lane); a
//    class past C reads -2^99, so its exp is 0 with no mask.
//  - The list holds a live pixel's (g w_a, g w_b, lse log2 e, f_w) and its
//    safe label and window; its g, lse and labels come in by 4-byte cp.async
//    a row ahead, and its column weights, the same in every output row, are
//    worked out once a unit into a shared table. exp(up - lse) = ex2(up
//    log2 e - lse log2 e), the argument one fma, as the forward's
//    (ce_upsampled.cu: expf's range reduction took that kernel 17 % longer);
//    the label's class subtracts 1 from its exp.
//  - The adjoint stays in registers: the window's two column accumulators,
//    and the row adjoint of the output row's two source rows at the strip's
//    TW columns (a compile-time width: the windows are walked by an unrolled
//    loop, so that every column's registers are named). When the output rows
//    pass a source row, it goes out through one shared-memory row.
//  - No atomics; every sum is one warp's, in a fixed order: two runs give the
//    same bits.
// Measured on the H100 (tools/probe_ce_nll_bwd.py, PERF.md PR 23): a first
// version that walked every pixel (dead ones by a branch) and worked out its
// column weights per row spent 214 of its 304 us at N 8 outside the exps; a
// second, with the row adjoint in shared memory (float4 read-modify-writes of
// two rows at every window slide), 77 of its 288 us in the slides.
#include "common.cuh"
#include "mma_sync.cuh"

namespace {

constexpr int kWarps = 4;        // units (warps) a block
constexpr int kMaxScale = 8;
constexpr int kPixLoads = 4;     // a lane's share of one output row's pixels: s (tw + 1) <= 128
constexpr int kSmemMax = 200 * 1024;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNeg = -6.338253001141147e29f;  // -2^99: the logit of a class past C

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// the window of output index i: the first of the two source indices it lerps
// (unclamped: -1 at the low edge); i >= -s
__host__ __device__ __forceinline__ int win(int i, int s) { return (i - s / 2 + s) / s - 1; }

// the widest strip at C classes: the row adjoint takes 2 TW CPL registers a
// lane
__host__ __device__ constexpr int strip_max(int C) { return C <= 128 ? 7 : 3; }

// Shared memory of one warp, in bytes (ops/ce_upsampled.py ce_nll_bwd_smem
// has the same layout), for P = s (tw + 1) output columns: the ring, three
// source rows of tw + 2 columns of C bf16, each from the 16-byte boundary at
// or before its first byte; a finished source row on its way out, f32
// [tw][cs], cs = 32 CPL (every lane's classes, past C too); the columns'
// table, float4 [P]; an output row's list of live pixels, float4 [P] and int
// [P] (rounded up to 16); the next output row's g and lse, f32 [P] each, and
// labels, 4 P + 16 bytes (rounded up to 16).
__host__ __device__ constexpr int ring_row_bytes(int C, int tw) {
  return ((tw + 2) * C * 2 + 14 + 15) / 16 * 16;
}
__host__ __device__ constexpr int col_stride(int C) { return C <= 128 ? 128 : 256; }
__host__ __device__ constexpr int out_at(int C, int tw) { return 3 * ring_row_bytes(C, tw); }
__host__ __device__ constexpr int tab_at(int C, int tw) {
  return out_at(C, tw) + tw * col_stride(C) * 4;
}
__host__ __device__ constexpr int list_at(int C, int s, int tw) {
  return tab_at(C, tw) + 16 * s * (tw + 1);
}
__host__ __device__ constexpr int buf_at(int C, int s, int tw) {
  return (list_at(C, s, tw) + 20 * s * (tw + 1) + 15) / 16 * 16;
}
__host__ __device__ constexpr int warp_bytes(int C, int s, int tw) {
  return buf_at(C, s, tw) + (12 * s * (tw + 1) + 16 + 15) / 16 * 16;
}

// 2^x on the MUFU (ex2.approx.ftz: relative error about 2^-22)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(vss::smem_addr(dst)), "l"(src));
}

// Phase clocks of the probe's variant (tools/probe_ce_nll_bwd.py builds it
// with VSS_NLL_CLOCKS defined): each warp's clock64() cycles by phase, summed
// over the warps; compiled out otherwise.
#ifdef VSS_NLL_CLOCKS
__device__ unsigned long long nll_clocks[8];
#define VSS_CLK_START(t) const long long t = clock64()
#define VSS_CLK_ADD(i, t) clk[i] += clock64() - (t)
#else
#define VSS_CLK_START(t)
#define VSS_CLK_ADD(i, t)
#endif

// a bf16 pair's low and high halves
__device__ __forceinline__ float lo_bf16(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_bf16(unsigned u) { return __uint_as_float(u & 0xffff0000u); }

template <int CPL, int TW, typename L>
__global__ void __launch_bounds__(32 * kWarps, 3) ce_nll_bwd_kernel(
    const __nv_bfloat16* __restrict__ x, const L* __restrict__ labels,
    const float* __restrict__ g, const float* __restrict__ lse, __nv_bfloat16* __restrict__ out,
    int N, int h, int w, int C, int s, int tw, int nseg) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float sf[kMaxScale];
  __shared__ int sd[kMaxScale];
  if (threadIdx.x < s) {  // output phase p lerps source k + sd[p] and + 1 by (1 - sf[p], sf[p])
    const int p = threadIdx.x;
    const double d = (p + 0.5) / s - 0.5;
    sd[p] = d < 0.0 ? -1 : 0;
    sf[p] = (float)(d - sd[p]);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, c0 = lane * CPL;
  const int nstrip = (w + tw - 1) / tw;
  const long long unit = (long long)blockIdx.x * kWarps + warp;
  if (unit >= (long long)N * nseg * nstrip) return;
#ifdef VSS_NLL_CLOCKS
  long long clk[6] = {0, 0, 0, 0, 0, 0};  // unit, row set-up, windows, pixels, row end, pixels
  VSS_CLK_START(t_unit);
#endif
  const int strip = (int)(unit % nstrip);
  const int seg = (int)(unit / nstrip % nseg), n = (int)(unit / nstrip / nseg);
  const int k_lo = (int)((long long)seg * h / nseg), k_hi = (int)((long long)(seg + 1) * h / nseg);
  const int v0 = (int)((long long)strip * w / nstrip);
  const int v1 = (int)((long long)(strip + 1) * w / nstrip);  // at most tw <= TW columns
  const int H = h * s, W = w * s, hs = s / 2;
  const int ya = max(0, s * k_lo - hs), yb = min(H, s * k_hi + hs);
  const int xa = max(0, s * v0 - hs), xb = min(W, s * v1 + hs), cnt = xb - xa;
  // the source rows and columns the windows read, clamped to the map
  const int rb = min(win(yb - 1, s) + 1, h - 1);
  const int cc0 = max(win(xa, s), 0), ncol = min(win(xb - 1, s) + 1, w - 1) - cc0 + 1;
  const int rowb = ring_row_bytes(C, tw), cs = col_stride(C);
  const bool vec = (C & 3) == 0;  // 4 classes are one 8-byte shared load
  const int npx = s * (tw + 1);
  unsigned char* wsm = smem + (size_t)warp * warp_bytes(C, s, tw);
  float* orow = reinterpret_cast<float*>(wsm + out_at(C, tw));   // [col - v0][cs]
  float4* ctab = reinterpret_cast<float4*>(wsm + tab_at(C, tw));  // w_a, w_b, f_w, window index
  float4* px = reinterpret_cast<float4*>(wsm + list_at(C, s, tw));  // g w_a, g w_b, lse log2 e, f_w
  int* pmeta = reinterpret_cast<int*>(px + npx);  // safe label + 256 window index
  float* gbuf = reinterpret_cast<float*>(wsm + buf_at(C, s, tw));  // the next row's g [P]
  float* lbuf = gbuf + npx;                                         // its lse [P]
  unsigned char* bbuf = reinterpret_cast<unsigned char*>(lbuf + npx);  // its labels
  const long long xn = (long long)n * h;

  // source row r, columns cc0 .. cc0 + ncol - 1, into ring slot r % 3
  auto row_src = [&](int r) {
    return reinterpret_cast<const unsigned char*>(x + ((xn + r) * w + cc0) * C);
  };
  auto copy_row = [&](int r) {
    const unsigned char* src = row_src(r);
    const int sh = (int)(reinterpret_cast<uintptr_t>(src) & 15);
    unsigned char* dst = wsm + (r % 3) * rowb;
    const int chunks = (sh + ncol * C * 2 + 15) >> 4;
    for (int i = lane; i < chunks; i += 32) vss::cp_async16(dst + 16 * i, src - sh + 16 * i);
  };
  auto row_at = [&](int r) {
    const int sh = (int)(reinterpret_cast<uintptr_t>(row_src(r)) & 15);
    return reinterpret_cast<const unsigned short*>(wsm + (r % 3) * rowb + sh);
  };
  // this lane's classes of raw source column col, lerped between the rows at
  // p0 and p1: x0 + fh (x1 - x0); a class past C is kNeg (its lane reads the
  // column's first classes and drops them: no branch)
  auto lerp_col = [&](const unsigned short* p0, const unsigned short* p1, int col, float fh,
                      float (&xv)[CPL]) {
    const int off = (clampi(col, 0, w - 1) - cc0) * C;
    if (vec) {
#pragma unroll
      for (int q = 0; q < CPL / 4; ++q) {
        const bool in = c0 + 4 * q < C;
        const int o = off + (in ? c0 + 4 * q : 0);
        const uint2 a = *reinterpret_cast<const uint2*>(p0 + o);
        const uint2 b = *reinterpret_cast<const uint2*>(p1 + o);
        xv[4 * q] = in ? fmaf(fh, lo_bf16(b.x) - lo_bf16(a.x), lo_bf16(a.x)) : kNeg;
        xv[4 * q + 1] = in ? fmaf(fh, hi_bf16(b.x) - hi_bf16(a.x), hi_bf16(a.x)) : kNeg;
        xv[4 * q + 2] = in ? fmaf(fh, lo_bf16(b.y) - lo_bf16(a.y), lo_bf16(a.y)) : kNeg;
        xv[4 * q + 3] = in ? fmaf(fh, hi_bf16(b.y) - hi_bf16(a.y), hi_bf16(a.y)) : kNeg;
      }
    } else {
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        if (c0 + j < C) {
          const float a = lo_bf16(p0[off + c0 + j]), b = lo_bf16(p1[off + c0 + j]);
          xv[j] = fmaf(fh, b - a, a);
        } else {
          xv[j] = kNeg;
        }
      }
    }
  };

  // the row adjoint of the output row's two raw source rows jlo (rlo) and
  // jlo + 1 (rhi) at the strip's columns v0 .. v0 + TW - 1, this lane's
  // classes
  float rlo[TW][CPL], rhi[TW][CPL];
#pragma unroll
  for (int u = 0; u < TW; ++u)
#pragma unroll
    for (int jj = 0; jj < CPL; ++jj) rlo[u][jj] = rhi[u][jj] = 0.f;
  // write source row r (its strip's columns, from the registers rr, through
  // the shared row: bf16, 16-byte stores past a head of fewer than 8
  // elements) where the unit owns it
  auto emit = [&](int r, const float (&rr)[TW][CPL]) {
    if (r < k_lo || r >= k_hi) return;
#pragma unroll
    for (int u = 0; u < TW; ++u)
      if (u < v1 - v0) {
#pragma unroll
        for (int q = 0; q < CPL / 4; ++q)
          *reinterpret_cast<float4*>(orow + u * cs + c0 + 4 * q) =
              make_float4(rr[u][4 * q], rr[u][4 * q + 1], rr[u][4 * q + 2], rr[u][4 * q + 3]);
      }
    __syncwarp();
    __nv_bfloat16* o = out + ((xn + r) * w + v0) * C;
    const int len = (v1 - v0) * C;
    const int head = min(len, (int)(((16 - (reinterpret_cast<uintptr_t>(o) & 15)) & 15) >> 1));
    const int nv = (len - head) >> 3;
    auto at = [&](int e) { return orow[(e / C) * cs + e % C]; };
    for (int e = lane; e < head; e += 32) o[e] = __float2bfloat16_rn(at(e));
    for (int q = lane; q < nv; q += 32) {
      const int e = head + 8 * q;
      int col = e / C, cls = e - col * C;
      float f[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {  // (col, class) of element e + i, stepped
        f[i] = orow[col * cs + cls];
        if (++cls == C) {
          cls = 0;
          ++col;
        }
      }
      vss::store8(o + e, f);
    }
    for (int e = head + 8 * nv + lane; e < len; e += 32) o[e] = __float2bfloat16_rn(at(e));
    __syncwarp();
  };

  // an output row's g, lse and labels into the shared buffer, 4-byte
  // cp.async (uint8 labels as the 4-byte words around them: returns the
  // first label's byte in the buffer)
  auto load_px = [&](int Y) {
    const long long o = ((long long)n * H + Y) * W + xa;
    for (int i = lane; i < cnt; i += 32) {
      cp_async4(gbuf + i, g + o + i);
      cp_async4(lbuf + i, lse + o + i);
    }
    if constexpr (sizeof(L) == 4) {
      for (int i = lane; i < cnt; i += 32) cp_async4(bbuf + 4 * i, labels + o + i);
      return 0;
    } else {
      const unsigned char* src = reinterpret_cast<const unsigned char*>(labels + o);
      const int sh = (int)(reinterpret_cast<uintptr_t>(src) & 3);
      for (int i = lane; i < (sh + cnt + 3) >> 2; i += 32) cp_async4(bbuf + 4 * i, src - sh + 4 * i);
      return sh;
    }
  };
  // the unit's output columns X = xa + i, the same in every output row: the
  // column weights of the window's two source columns (at the map's edge the
  // window's column -1 or w is the edge column itself, so its share goes
  // there), f_w, and the window's index u = wc - v0 + 1
  for (int i = lane; i < cnt; i += 32) {
    const int X = xa + i, v = X / s, pw = X - v * s, wc = v + sd[pw];
    const float fw = sf[pw], wl = 1.f - fw;
    ctab[i] = make_float4(wc < 0 ? 0.f : wc + 1 >= w ? wl + fw : wl,
                          wc < 0 ? wl + fw : wc + 1 >= w ? 0.f : fw, fw,
                          __int_as_float(wc - v0 + 1));
  }
  // the output row's live pixels, in order, into the list; returns their
  // count (the same in every lane)
  auto list_px = [&](int sh) {
    int nlive = 0;
#pragma unroll
    for (int q = 0; q < kPixLoads; ++q) {
      if (32 * q >= cnt) break;
      const int i = lane + 32 * q;
      const float gi = i < cnt ? gbuf[i] : 0.f;
      const bool live = gi != 0.f;
      const unsigned m = __ballot_sync(0xffffffffu, live);
      if (live) {
        const int k = nlive + __popc(m & ((1u << lane) - 1u));
        const int b = sizeof(L) == 4 ? reinterpret_cast<const int*>(bbuf)[i] : bbuf[sh + i];
        const float4 t = ctab[i];
        px[k] = make_float4(gi * t.x, gi * t.y, lbuf[i] * kLog2e, t.z);
        pmeta[k] = (b >= 0 && b < C ? b : 0) | __float_as_int(t.w) << 8;
      }
      nlive += __popc(m);
    }
    return nlive;
  };

  // the ring's first three rows and the first output row's pixels in flight
  int have = max(win(ya, s), 0) - 1;  // the last row copied
  while (have < min(max(win(ya, s), 0) + 2, rb)) copy_row(++have);
  int lab_sh = load_px(ya);
  vss::cp_async_commit();
  int jlo = win(ya, s);  // the raw source row of rlo
  for (int Y = ya; Y < yb; ++Y) {
    VSS_CLK_START(t_row);
    const int k = Y / s, ph = Y - k * s, j = k + sd[ph];
    const float fh = sf[ph];
    if (j != jlo) {  // one row on: jlo is finished
      emit(jlo, rlo);
#pragma unroll
      for (int u = 0; u < TW; ++u)
#pragma unroll
        for (int jj = 0; jj < CPL; ++jj) {
          rlo[u][jj] = rhi[u][jj];
          rhi[u][jj] = 0.f;
        }
      jlo = j;
    }
    // the row weights: at the map's edge the raw row -1 or h is the edge row
    // itself, so its share goes there
    const float wlo = j < 0 ? 0.f : j + 1 >= h ? 1.f : 1.f - fh;
    const float whi = j < 0 ? 1.f : j + 1 >= h ? 0.f : fh;
    const int r0 = clampi(j, 0, h - 1), r1 = clampi(j + 1, 0, h - 1);
    // every copy issued a row ago (this row's pixels, and the ring up to r1
    // and beyond) has landed: a row of work to do so
    vss::cp_async_wait<0>();
    __syncwarp();
    const int nlive = list_px(lab_sh);
    __syncwarp();
    // the next row's pixels, and the row after r1 into the slot of r1 - 2,
    // which no lane reads any more: one group
    if (Y + 1 < yb) lab_sh = load_px(Y + 1);
    if (have < min(r1 + 1, rb)) copy_row(++have);
    vss::cp_async_commit();
    const unsigned short* p0 = row_at(r0);
    const unsigned short* p1 = row_at(r1);
    VSS_CLK_ADD(1, t_row);
#ifdef VSS_NLL_CLOCKS
    clk[5] += nlive;
#endif
    // the windows u = 0 .. TW (source columns v0 - 1 + u and v0 + u), each
    // with its live pixels: the window's row-lerped columns xl and xr (dd =
    // xr - xl, loaded at its first live pixel) and column accumulators a0,
    // a1; after window u its first column, v0 - 1 + u, is finished and goes
    // into the row adjoint (its index u - 1), and a1 moves up
    float xl[CPL], xr[CPL], dd[CPL], a0[CPL], a1[CPL];
#pragma unroll
    for (int jj = 0; jj < CPL; ++jj) a0[jj] = a1[jj] = 0.f;
    bool loaded = false;  // xr holds window u - 1's second column
    int kp = 0;
    float4 P = px[0];  // the next entry, read ahead (stale past the list, and unread)
    int meta = pmeta[0];
#pragma unroll
    for (int u = 0; u <= TW; ++u) {
      VSS_CLK_START(t_win);
      if (kp < nlive && (meta >> 8) == u) {  // the same for every lane
        const int wc = v0 - 1 + u;
        if (loaded) {
#pragma unroll
          for (int jj = 0; jj < CPL; ++jj) xl[jj] = xr[jj];
        } else {
          lerp_col(p0, p1, wc, fh, xl);
        }
        lerp_col(p0, p1, wc + 1, fh, xr);
#pragma unroll
        for (int jj = 0; jj < CPL; ++jj) dd[jj] = xr[jj] - xl[jj];
        VSS_CLK_ADD(2, t_win);
        VSS_CLK_START(t_pix);
        do {
          const float4 Pc = P;
          const int rel = (meta & 255) - c0;
          ++kp;
          P = px[min(kp, nlive - 1)];
          meta = pmeta[min(kp, nlive - 1)];
#pragma unroll
          for (int jj = 0; jj < CPL; ++jj) {
            const float e = ex2(fmaf(fmaf(Pc.w, dd[jj], xl[jj]), kLog2e, -Pc.z)) -
                            (rel == jj ? 1.f : 0.f);
            a0[jj] = fmaf(Pc.x, e, a0[jj]);
            a1[jj] = fmaf(Pc.y, e, a1[jj]);
          }
        } while (kp < nlive && (meta >> 8) == u);
        VSS_CLK_ADD(3, t_pix);
        loaded = true;
      } else {
        loaded = false;
      }
      if (u >= 1 && u - 1 < TW) {
#pragma unroll
        for (int jj = 0; jj < CPL; ++jj) {
          rlo[u - 1][jj] = fmaf(wlo, a0[jj], rlo[u - 1][jj]);
          rhi[u - 1][jj] = fmaf(whi, a0[jj], rhi[u - 1][jj]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < CPL; ++jj) {
        a0[jj] = a1[jj];
        a1[jj] = 0.f;
      }
    }
    __syncwarp();  // every lane past this row's list
  }
  VSS_CLK_START(t_end);
  emit(jlo, rlo);
  emit(jlo + 1, rhi);
  VSS_CLK_ADD(4, t_end);
#ifdef VSS_NLL_CLOCKS
  VSS_CLK_ADD(0, t_unit);
  if (lane == 0)
    for (int i = 0; i < 6; ++i) atomicAdd(&nll_clocks[i], (unsigned long long)clk[i]);
#endif
}

template <int CPL, int TW, typename L>
int launch(const void* x, const void* labels, const void* lse, const void* g, void* out, int N,
           int h, int w, int C, int s, int tw, int nseg, cudaStream_t st) {
  const long long units = (long long)N * nseg * ((w + tw - 1) / tw);
  const unsigned blocks = (unsigned)((units + kWarps - 1) / kWarps);
  const size_t bytes = (size_t)kWarps * warp_bytes(C, s, tw);
  static bool attr = false;  // one instance per template: set its limit once
  if (!attr) {
    cudaError_t e = cudaFuncSetAttribute(ce_nll_bwd_kernel<CPL, TW, L>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  ce_nll_bwd_kernel<CPL, TW, L><<<blocks, 32 * kWarps, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const L*>(labels),
      static_cast<const float*>(g), static_cast<const float*>(lse),
      static_cast<__nv_bfloat16*>(out), N, h, w, C, s, tw, nseg);
  return (int)cudaGetLastError();
}

// the instance: CPL 4 and TW 3 or 7 at C <= 128, CPL 8 and TW 3 above
template <typename L>
int launch_c(const void* x, const void* labels, const void* lse, const void* g, void* out, int N,
             int h, int w, int C, int s, int tw, int nseg, cudaStream_t st) {
  if (C > 128) return launch<8, 3, L>(x, labels, lse, g, out, N, h, w, C, s, tw, nseg, st);
  if (tw <= 3) return launch<4, 3, L>(x, labels, lse, g, out, N, h, w, C, s, tw, nseg, st);
  return launch<4, 7, L>(x, labels, lse, g, out, N, h, w, C, s, tw, nseg, st);
}

template <typename Kernel>
int blocks_of(Kernel kernel, size_t bytes) {
  int b = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, kernel, 32 * kWarps, bytes) !=
          cudaSuccess)
    return -1;
  return b;
}

}  // namespace

// dlogits (N, h, w, C) bf16 for the per-pixel cotangent g_nll (N, h*s, w*s)
// f32 of ce_fwd_nll's nll, from its lse (the same shape, f32); logits (N, h,
// w, C) bf16, labels (N, h*s, w*s) uint8 (labels_i32 = 0) or int32. Units of
// ceil(w / tw) strips of at most tw (1..7 at C <= 128, 1..3 above) source
// columns and nseg (1..h) segments of source rows a frame, each split evenly
// (ops/ce_upsampled.py ce_nll_bwd_plan). C <= 256, 1 <= s <= 8, pointers
// 16-byte aligned. One launch. Returns a cudaError_t.
VSS_EXPORT int ce_nll_bwd(const void* logits, const void* labels, const void* lse,
                          const void* g_nll, void* out, int N, int h, int w, int C, int s,
                          int labels_i32, int tw, int nseg, int device, void* stream) {
  vss::use_device(device);
  if ((long long)N * h * w == 0) return 0;
  if (s < 1 || s > kMaxScale || C < 1 || C > 256 || tw < 1 || tw > strip_max(C) || nseg < 1 ||
      nseg > h || (long long)kWarps * warp_bytes(C, s, tw) > kSmemMax)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return labels_i32
             ? launch_c<int>(logits, labels, lse, g_nll, out, N, h, w, C, s, tw, nseg, st)
             : launch_c<unsigned char>(logits, labels, lse, g_nll, out, N, h, w, C, s, tw, nseg,
                                       st);
}

#ifdef VSS_NLL_CLOCKS
// The probe's variant: the phase clocks summed since the last call into
// host[0..5] (unit, row set-up, windows, pixels, row end, live pixels), then
// cleared.
VSS_EXPORT int ce_nll_bwd_clocks(unsigned long long* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, nll_clocks, 6 * sizeof(unsigned long long));
  const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(nll_clocks, zero, sizeof(zero));
  return (int)e;
}
#endif

// Bytes of dynamic shared memory a block of ce_nll_bwd takes at C classes,
// scale s and strips of tw.
VSS_EXPORT int ce_nll_bwd_smem_bytes(int C, int s, int tw) {
  return kWarps * warp_bytes(C, s, tw);
}

// Blocks of ce_nll_bwd one SM holds at C classes, scale s and strips of tw
// (the CUDA occupancy query of the instance the launch takes, uint8 labels);
// -1 on an error.
VSS_EXPORT int ce_nll_bwd_blocks_per_sm(int C, int s, int tw) {
  const size_t bytes = (size_t)kWarps * warp_bytes(C, s, tw);
  if (C > 128) return blocks_of(ce_nll_bwd_kernel<8, 3, unsigned char>, bytes);
  if (tw <= 3) return blocks_of(ce_nll_bwd_kernel<4, 3, unsigned char>, bytes);
  return blocks_of(ce_nll_bwd_kernel<4, 7, unsigned char>, bytes);
}
