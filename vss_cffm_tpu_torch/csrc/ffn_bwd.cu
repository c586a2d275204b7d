// The backward of the FFN half of a MiT block in training in one launch:
//
//     out = x + s·FFN(LN2(x)),  FFN(u) = GELU(dw3x3(mask(u·W1 + b1)) + bdw)·W2 + b2
//
// For the output cotangent go it computes dx = go + LN2ᵀ(d_ln) (x's dtype),
// or, in the whole block's mode (full), d_y = that in f32, d_attn =
// bf16(d_y·s_attn) and the partial Σ d_y·s_attn (dbproj); ln2 = bf16(LN2(x));
// a = bf16(GELU(z)) and d_hid_b = bf16(d_hid), the inputs of the two weight
// products dW2 = aᵀ·bf16(go·s) and dW1 = ln2ᵀ·d_hid_b (gemm_tn.cu); and per
// block the partial sums of the 9 depthwise taps Σ hid(shifted)·d_z, of
// Σ d_z (dbdw), Σ d_hid (db1), Σ d_ln·x̂ (dγ2), Σ d_ln (dβ2), Σ go·s (db2).
//
// Replaces the TPU kernel vss_cffm_tpu/ops/mixffn.py:_bwd_kernel_ln (:313,
// called by _block_ffn_bwd_pallas at :517, row 11 of PERF.md's table) and
// the FFN half of vss_cffm_tpu/ops/stage_block.py:_train_bwd_kernel (:369,
// row 7). Both recompute LN2, the hidden map and z from x in VMEM. The
// port's earlier route kept the forward's hidden map (f32) and a in device
// memory from the forward to the backward, and ran six launches that wrote
// and read d_a and d_ln in f32 and d_hid in bf16: at B1 stage 1 (8 frames
// of 120x120) ~750 MB a backward. Here the hidden map, z, d_a, d_z and d_ln
// never leave the SM; the launch reads x, go and the weights and writes the
// outputs above (~330 MB there with the two weight products).
//
// Bound on the H100: five products of 2·M·C·Ch FLOP (fc1 recomputed, d_a,
// d_ln here; dW2, dW1 in gemm_tn), ~19-30 µs at 989 TFLOP/s at the B1
// stages; this launch's inputs and outputs ~100 µs of bytes at stage 1. The
// launch itself is bound by the latency of its thread passes (8 warps an
// SM, the exact erff of GELU' on the one-pixel halo), then by its halo's
// recomputed products and the weight chunks each tile streams from L2
// (tools/probe_ffn_bwd.py attributes the time phase by phase).
// Design:
//  - A block (two warpgroups, one block an SM) owns a tile of rows x cols
//    pixels of one frame (ops/ffn_bwd.py:ffn_bwd_plan; the last band and
//    strip of a frame shorter). d_hid of a pixel needs d_z on its one-pixel
//    halo, and z there needs the hidden map on a two-pixel halo. So the
//    block keeps in shared memory, in bf16, the LayerNorm of the tile and its
//    two-pixel halo (f32 statistics) and bf16(go·s) of the tile and its
//    one-pixel halo, zero outside the image, each in 64-column chunks,
//    XOR-swizzled, with no padding rows (the A fragments of the last m-tile
//    read a clamped row; its extra rows are never stored).
//  - It walks the hidden channels in chunks of hc (64 or 32; a split walks
//    its own run of chunks). Per chunk, on wgmma m64n{hc}k16 with A by
//    ldmatrix from the tiles above: fc1 over the two-pixel halo (B = the W1
//    chunk, MN-major) → hid + b1 in f32, zero outside the image; d_a =
//    go_s·W2[chunk]ᵀ over the one-pixel halo (B = the W2 chunk's rows,
//    K-major) in f32; the warpgroups take the m-tiles of both in turn (every
//    wgmma on a path ptxas sees as uniform: a product on a path it cannot
//    prove uniform makes it serialise every wgmma of the kernel, C7520).
//    Then
//    the threads, an item being 4 channels of one pixel: z = dw3x3(hid) +
//    bdw (the taps in the plain version's (di, dj) order), d_z =
//    d_a·GELU'(z) (exact erff) on the one-pixel halo, zero outside the
//    image, in place of d_a; on the tile's own pixels a = bf16(GELU(z)) from
//    the same erff to device memory, and from the window of hid still in
//    registers the tap and Σ d_z partials; then d_hid = dw3x3ᵀ(d_z) (the
//    plain version's (dj, di) order) → bf16 to device memory and to shared
//    memory, and Σ d_hid (f32). Last, d_ln += d_hid_b·W1[:, chunk]ᵀ on
//    wgmma (B = the W1 chunk again, read K-major) into f32 register
//    accumulators of the tile's pixels x C, split between the warpgroups as
//    ffn_fused.cu's fc2 (pixels at C <= 128, 64-column atoms above; every
//    warpgroup runs every product, rows past the tile and atoms past C on a
//    clamped row or atom, never stored). The chunk's 11 partial sums are
//    reduced over the threads that hold them (shuffles, then the 8 warps in
//    order) and written as the block's partial of those channels.
//  - The W2 chunk is loaded again by cp.async once d_a has read it, the W1
//    chunk (with b1, bdw and the taps) once d_ln has: the next chunk's W2
//    loads overlap this chunk's thread passes. (Swapping the two buffers'
//    roles from chunk to chunk, so that the next W1 also loads during the
//    passes, measured no faster on an H100: the wait for W1 is not where the
//    loads cost.)
//  - After the last chunk the LayerNorm backward reads x and go again and
//    d_ln from shared memory: as the LayerNorm pass, a pixel's chunks of 8
//    channels on a group of lanes, two passes of a warp's pixels with their
//    loads in flight, 16-byte loads and stores (one warp a pixel with
//    scalar accesses took a quarter of the launch at stage 1). Where the tiles alone leave the card
//    short of blocks the chunks are split over blocks (blockIdx.y): each
//    writes its f32 partial of d_ln, and ffn_bwd_ln_kernel sums them in
//    split order before the same LayerNorm backward. No atomics: every sum
//    over pixels is a per-block partial reduced by the wrapper in a fixed
//    order; two runs give the same bits.
// Rounding points are the plain version's (ops/stage_block.py:
// ffn_bwd_steps): LN in f32 and bf16 before fc1, the hidden map, z, d_a,
// d_z and d_hid in f32, a, go_s and d_hid_b in bf16, d_ln and the LayerNorm
// backward in f32, dx in x's dtype (f32 d_y and bf16 d_attn in the whole
// block's mode).
#include "common.cuh"
#include "mma_sync.cuh"
#include "tma_wgmma.cuh"

namespace {

constexpr int THREADS = 256, WARPS = 8;  // two warpgroups
constexpr int LN_PASSES = 4;             // passes of a warp's LayerNorm pixels in flight
constexpr int SMEM_MAX = 232448;
constexpr int EPI_ROWS = 64;  // pixels of an epilogue block after a split
constexpr int EPI_PASSES = 2;  // passes of a warp's LayerNorm-backward pixels in flight
constexpr int CMAX = 512;

__host__ __device__ constexpr int rup(int a, int b) { return (a + b - 1) / b * b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// d_ln's split of the work by width, as ffn_fused.cu's fc2 (ops/ffn_fused.py:
// _CLASSES): with PIX2 each warpgroup owns 64 of the tile's (up to 128)
// pixels and all NA 64-column atoms of C; without, both own the tile's (up to
// 64) pixels and take every other atom, NA each
template <int K> struct Cls;
template <> struct Cls<0> { static constexpr bool PIX2 = true;  static constexpr int NA = 1; };
template <> struct Cls<1> { static constexpr bool PIX2 = true;  static constexpr int NA = 2; };
template <> struct Cls<2> { static constexpr bool PIX2 = false; static constexpr int NA = 2; };
template <> struct Cls<3> { static constexpr bool PIX2 = false; static constexpr int NA = 3; };
template <> struct Cls<4> { static constexpr bool PIX2 = false; static constexpr int NA = 4; };

__host__ __device__ inline int cls_of(int c) {
  return c <= 64 ? 0 : c <= 128 ? 1 : c <= 256 ? 2 : c <= 384 ? 3 : 4;
}
__host__ __device__ inline int max_pixels_of(int k) { return k <= 1 ? 128 : 64; }

struct Layout {
  int w1, w2, prm, ln, gos, hid, red, dz, valid, total;
};

// byte offsets of a block's shared memory past its 1024-byte aligned base
// for tiles of at most rows x cols pixels (ops/ffn_bwd.py:ffn_bwd_smem). The W1
// and W2 chunks, which wgmma reads through descriptors, sit on 1024-byte
// boundaries. After the last chunk the LN and go_s tiles hold the f32 d_ln
// of the tile's pixels (rows of C + 8), the hidden chunk the LayerNorm
// backward's partial sums; between a chunk's passes the hidden chunk holds
// d_hid_b (the tile's pixels x hc bf16) and, past it, the warps' partial sums
// of the chunk (8 x 11 x hc f32).
__host__ __device__ inline Layout layout(int rows, int cols, int c, int hc) {
  const int cp64 = rup(c, 64);
  const int p2 = (rows + 4) * (cols + 4), p1 = (rows + 2) * (cols + 2), pout = rows * cols;
  Layout s;
  int o = 0;
  s.w1 = o;  o += cp64 * hc * 2;   // W1[:, chunk], rows past C zero
  s.w2 = o;  o += hc * cp64 * 2;   // W2[chunk, :] in 64-column atoms, zeros past C
  s.prm = o; o += 11 * hc * 4;     // b1, bdw, the 9 taps of the chunk
  s.ln = o;                        // LN of the two-pixel halo tile, bf16
  s.gos = o + p2 * cp64 * 2;       // bf16(go·s) of the one-pixel halo tile
  o += imax((p2 + p1) * cp64 * 2, pout * (c + 8) * 4);
  s.hid = o;                       // hidden chunk (f32), d_hid_b, the sums
  s.red = o + rup(pout * hc * 2, 16);
  o += imax(imax(p2 * hc * 4, rup(pout * hc * 2, 16) + WARPS * 11 * hc * 4), 4 * c * 4);
  s.dz = o;  o += p1 * hc * 4;     // d_a, then d_z, of the one-pixel halo tile
  s.valid = o; o += rup(p2, 16);   // halo pixel inside the image
  s.total = o + 1024;              // and the base's alignment
  return s;
}

struct Args {
  const void* x;               // (B, H, W, C) bf16 or f32
  const __nv_bfloat16* go;     // (M, C)
  const float* gamma;
  const float* beta;
  const __nv_bfloat16* w1;     // (C, Ch)
  const float* b1;
  const float* kdw;            // (9, Ch)
  const float* bdw;
  const __nv_bfloat16* w2;     // (Ch, C)
  const float* s_ffn;          // (B,)
  const float* s_attn;         // (B,), the whole block's mode
  __nv_bfloat16* a_out;        // (M, Ch)
  __nv_bfloat16* dhid_out;     // (M, Ch)
  __nv_bfloat16* ln_out;       // (M, C)
  void* dx_out;                // (M, C): f32 d_y (full), else x's dtype
  __nv_bfloat16* dattn_out;    // (M, C), the whole block's mode
  float* cpart;                // (tiles, 11, Ch)
  float* epart;                // (tiles, or epilogue blocks after a split, 4, C)
  float* dlpart;               // (splits, M, C) when splits > 1
  int B, H, W, C, Ch, x_f32, full, rows, cols, tiles_h, tiles_w, chunks, splits;
  float eps;
};

// hidden-chunk element (row, col) of an f32 tile of hc-wide rows, the 4-float
// groups XOR-swizzled by the row so that the fragment stores of 8 rows fall
// in distinct banks
template <int HC>
__device__ __forceinline__ int hoff(int row, int col) {
  return row * HC + (col ^ ((row & 7) << 2));
}

// A fragment of rows [r0, r0 + 16) x cols [c0, c0 + 16) of a swizzled tile of
// `nrows` rows; rows past the tile read its last row (their products are
// never stored)
template <int W>
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[4], const __nv_bfloat16* tile, int r0,
                                            int c0, int lane, int nrows) {
  const int mi = lane >> 3;
  const int r = min(r0 + (lane & 7) + (mi & 1) * 8, nrows - 1);
  vss::ldsm_x4(a, tile + vss::swz<W>(r, c0 + (mi >> 1) * 8));
}

// d (64 x hc, f32) += a (64 x 16, registers) · B (16 x hc in shared memory;
// TB 1: MN-major, 0: K-major)
template <int HC, int TB>
__device__ __forceinline__ void wgmma_hc(float (&d)[HC / 2], const uint32_t (&a)[4],
                                         uint64_t b) {
  if constexpr (HC == 64)
    vss::wgmma_m64n64k16_rs<TB>(d, a, b);
  else
    vss::wgmma_m64n32k16_rs<TB>(d, a, b);
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 8 consecutive elements of a read-only input through the non-coherent path
__device__ __forceinline__ void ldg8(const float* p, float* f) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void ldg8(const __nv_bfloat16* p, float* f) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// 8 consecutive elements of x (bf16 or f32)
__device__ __forceinline__ void ldx8(const Args& p, long long i, float* f) {
  if (p.x_f32)
    ldg8(static_cast<const float*>(p.x) + i, f);
  else
    ldg8(static_cast<const __nv_bfloat16*>(p.x) + i, f);
}

// The LayerNorm backward of np pixels: as the LayerNorm pass, a pixel's C / 8
// chunks of 8 channels on lpr lanes (at most two a lane), a warp's 32 / lpr
// pixels a pass, EPI_PASSES passes with their loads in flight; row_of(pp) is
// pixel pp's row of (M, C), dl8(pp, k, v) loads its d_ln[k .. k + 8). Writes
// dx (or d_y and d_attn) and ln2, 16 bytes a store, and the block's row
// `eblock` of the partials [Σ d_ln·x̂, Σ d_ln, Σ go·s_ffn, Σ d_y·s_attn]:
// each lane's sums over its pixels, then over the lanes of one chunk
// (shuffles), then the warps' in warp order through red (4·C floats of
// shared memory).
template <typename RowOf, typename DlOf8>
__device__ __forceinline__ void ln_epilogue(const Args& p, int np, RowOf row_of, DlOf8 dl8,
                                            float* red, long long eblock) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int C = p.C, c8 = C / 8;
  const long long hw = (long long)p.H * p.W;
  int lpr = 1;
  while (lpr < 32 && lpr * 2 < c8) lpr *= 2;
  const int ppw = 32 / lpr, sub = lane / lpr, sl = lane % lpr;
  float gm[2][8], bt[2][8], acc[4][2][8];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int ck = sl + lpr * q;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      gm[q][i] = ck < c8 ? p.gamma[ck * 8 + i] : 0.f;
      bt[q][i] = ck < c8 ? p.beta[ck * 8 + i] : 0.f;
#pragma unroll
      for (int a = 0; a < 4; ++a) acc[a][q][i] = 0.f;
    }
  }
  for (int p0 = warp * ppw * EPI_PASSES; p0 < np; p0 += WARPS * ppw * EPI_PASSES) {
    float xv[EPI_PASSES][2][8], dv[EPI_PASSES][2][8], gv[EPI_PASSES][2][8];
    long long mr[EPI_PASSES];
#pragma unroll
    for (int u = 0; u < EPI_PASSES; ++u) {
      const int pp = p0 + u * ppw + sub;
      const bool ok = pp < np;
      mr[u] = ok ? row_of(pp) : -1;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int ck = sl + lpr * q;
        if (ok && ck < c8) {
          ldx8(p, mr[u] * C + ck * 8, xv[u][q]);
          ldg8(p.go + mr[u] * C + ck * 8, gv[u][q]);
          dl8(pp, ck * 8, dv[u][q]);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) xv[u][q][i] = dv[u][q][i] = gv[u][q][i] = 0.f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < EPI_PASSES; ++u) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int i = 0; i < 8; ++i) s += xv[u][q][i];
      for (int o = lpr / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      const float mu = s / C;
      s = 0.f;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (sl + lpr * q < c8) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float d = xv[u][q][i] - mu;
            s += d * d;
          }
        }
      }
      for (int o = lpr / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      const float rsig = rsqrtf(s / C + p.eps);
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          xv[u][q][i] = (xv[u][q][i] - mu) * rsig;  // x̂
          const float dly = dv[u][q][i] * gm[q][i];
          s1 += dly;
          s2 += dly * xv[u][q][i];
        }
      for (int o = lpr / 2; o > 0; o >>= 1) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
        s2 += __shfl_xor_sync(0xffffffffu, s2, o);
      }
      if (mr[u] < 0) continue;
      const float m1 = s1 / C, m2 = s2 / C;
      const int fr = (int)(mr[u] / hw);
      const float sf = p.s_ffn[fr];
      const float sa = p.full ? p.s_attn[fr] : 0.f;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int ck = sl + lpr * q;
        if (ck >= c8) continue;
        float d[8], ds[8], ln[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float dly = dv[u][q][i] * gm[q][i];
          d[i] = gv[u][q][i] + rsig * (dly - m1 - xv[u][q][i] * m2);
          ds[i] = d[i] * sa;
          ln[i] = xv[u][q][i] * gm[q][i] + bt[q][i];
          acc[0][q][i] += dv[u][q][i] * xv[u][q][i];
          acc[1][q][i] += dv[u][q][i];
          acc[2][q][i] += gv[u][q][i] * sf;
          acc[3][q][i] += ds[i];
        }
        const long long o = mr[u] * C + ck * 8;
        if (p.full || p.x_f32)
          vss::store8(static_cast<float*>(p.dx_out) + o, d);
        else
          vss::store8(static_cast<__nv_bfloat16*>(p.dx_out) + o, d);
        if (p.full) vss::store8(p.dattn_out + o, ds);
        vss::store8(p.ln_out + o, ln);
      }
    }
  }
  // the lanes of one chunk, then the warps in warp order
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        for (int o = lpr; o < 32; o <<= 1)
          acc[a][q][i] += __shfl_xor_sync(0xffffffffu, acc[a][q][i], o);
  for (int w = 0; w < WARPS; ++w) {
    if (warp == w && sub == 0) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int ck = sl + lpr * q;
        if (ck >= c8) continue;
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            float& r = red[a * C + ck * 8 + i];
            r = w == 0 ? acc[a][q][i] : r + acc[a][q][i];
          }
      }
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < 4 * C; e += THREADS) p.epart[eblock * 4 * C + e] = red[e];
}

// d (64 x hc, f32) = rows [r0, r0 + 16) of this warp of a halo tile (bf16,
// 64-column chunks of nr rows) times a weight chunk in shared memory: W1[:,
// chunk] read MN-major (fc1, FC1) or W2[chunk, :] read K-major (d_a); k-steps
// of 16 channels with the next A fragment loaded while one product runs.
// Tried on an H100 (tools/probe_ffn_bwd.py): four k-steps a commit with a
// short last group made ptxas serialise every wgmma of the kernel (C7520,
// slower); whole groups of four, the next group's A fragments loaded while
// one ran, were up to 7 % faster at stage 3 but wrong where the instance
// spills (C 320, hc 64: the A registers of a product in flight reused).
template <int HC, bool FC1>
__device__ __forceinline__ void halo_product(float (&d)[HC / 2], const __nv_bfloat16* tile,
                                             int nr, int r0, int lane, int cp32, uint32_t w1a,
                                             uint32_t w2a) {
  constexpr uint32_t SW1 = HC == 64 ? 1 : 2;
#pragma unroll
  for (int e = 0; e < HC / 2; ++e) d[e] = 0.f;
  uint32_t af[2][4];
  for (int k = 0; k < cp32; k += 32) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int kb = k + 16 * b;
      load_a_rows<64>(af[b], tile + (kb >> 6) * nr * 64, r0, kb & 63, lane, nr);
      vss::wgmma_fence();
      if constexpr (FC1)
        wgmma_hc<HC, 1>(d, af[b], vss::wgmma_desc(w1a + kb * HC * 2, 16 * HC, 16 * HC, SW1));
      else
        wgmma_hc<HC, 0>(d, af[b],
                        vss::wgmma_desc(w2a + (kb >> 6) * HC * 128 + (kb & 63) * 2, 16, 1024, 1));
      vss::wgmma_commit();
      vss::wgmma_wait<1>();
    }
  }
  vss::wgmma_wait<0>();
  vss::fence_regs(d);
}

template <int HC, int K>
__global__ void __launch_bounds__(THREADS, 1) ffn_bwd_kernel(const Args p) {
  constexpr bool PIX2 = Cls<K>::PIX2;
  constexpr int NA = Cls<K>::NA;
  constexpr int Q4 = HC / 4;                  // 4-channel groups of a hidden chunk
  constexpr uint32_t SW1 = HC == 64 ? 1 : 2;  // W1 rows of 128 or 64 bytes, swizzled
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (vss::smem_addr(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wg = warp / 4, wl = warp % 4;  // warpgroup, warp within it
  const int C = p.C, Ch = p.Ch, H = p.H, W = p.W;
  const int cp32 = rup(C, 32), cp64 = rup(C, 64);
  const Layout L = layout(p.rows, p.cols, C, HC);
  __nv_bfloat16* w1s = reinterpret_cast<__nv_bfloat16*>(smem + L.w1);
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem + L.w2);
  float* prm = reinterpret_cast<float*>(smem + L.prm);
  __nv_bfloat16* lns = reinterpret_cast<__nv_bfloat16*>(smem + L.ln);
  __nv_bfloat16* gos = reinterpret_cast<__nv_bfloat16*>(smem + L.gos);
  float* hid = reinterpret_cast<float*>(smem + L.hid);
  __nv_bfloat16* dhb = reinterpret_cast<__nv_bfloat16*>(smem + L.hid);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* dz = reinterpret_cast<float*>(smem + L.dz);
  unsigned char* valid = smem + L.valid;
  const uint32_t w1a = vss::smem_addr(w1s), w2a = vss::smem_addr(w2s);

  // the tile: frame f, rows [i0, i0 + R), columns [j0, j0 + TW)
  int t = blockIdx.x;
  const int tj = t % p.tiles_w;
  t /= p.tiles_w;
  const int ti = t % p.tiles_h;
  const int f = t / p.tiles_h;
  const int i0 = ti * p.rows, j0 = tj * p.cols;
  const int R = min(p.rows, H - i0), TW = min(p.cols, W - j0);
  const int tw4 = TW + 4, tw2 = TW + 2;
  const int P2 = (R + 4) * tw4, P1 = (R + 2) * tw2, pout = R * TW;
  const int nchunks = (Ch + HC - 1) / HC;
  const int c_lo = blockIdx.y * p.chunks, c_hi = min(nchunks, c_lo + p.chunks);
  const long long tile = blockIdx.x;

  // W1[:, chunk] (zeros past C and Ch), b1, bdw and the taps of the chunk
  auto load_w1 = [&](int ck) {
    if (ck < c_hi) {
      const int h0 = ck * HC;
      constexpr int PR = HC / 8;
      for (int i = tid; i < cp64 * PR; i += THREADS) {
        const int k = i / PR, col = (i % PR) * 8;
        __nv_bfloat16* d = w1s + vss::swz<HC>(k, col);
        if (k < C && h0 + col < Ch)
          vss::cp_async16(d, p.w1 + (long long)k * Ch + h0 + col);
        else
          vss::zero16(d);
      }
      for (int i = tid; i < 11 * (HC / 4); i += THREADS) {
        const int r = i / (HC / 4), c4 = (i % (HC / 4)) * 4;
        float* d = prm + r * HC + c4;
        const float* s = r == 0   ? p.b1 + h0 + c4
                         : r == 1 ? p.bdw + h0 + c4
                                  : p.kdw + (long long)(r - 2) * Ch + h0 + c4;
        if (h0 + c4 < Ch)
          vss::cp_async16(d, s);
        else
          vss::zero16(d);
      }
    }
    vss::cp_async_commit();
  };
  // W2[chunk, :] as 64-column atoms of hc rows (zeros past C and Ch)
  auto load_w2 = [&](int ck) {
    if (ck < c_hi) {
      const int h0 = ck * HC;
      const int PR = cp64 / 8;
      for (int i = tid; i < HC * PR; i += THREADS) {
        const int k = i / PR, col = (i % PR) * 8;
        __nv_bfloat16* d = w2s + (col >> 6) * (HC * 64) + vss::swz<64>(k, col & 63);
        if (h0 + k < Ch && col < C)
          vss::cp_async16(d, p.w2 + (long long)(h0 + k) * C + col);
        else
          vss::zero16(d);
      }
    }
    vss::cp_async_commit();
  };

  load_w1(c_lo);
  load_w2(c_lo);

  // ---- the LayerNorm of the two-pixel halo tile → bf16 ----------------------
  // (as ffn_fused.cu: a pixel's C / 8 chunks of 8 on lpr lanes, LN_PASSES
  // passes of a warp's pixels with their loads in flight)
  const int c8 = C / 8;
  {
    int lpr = 1;
    while (lpr < 32 && lpr * 2 < c8) lpr *= 2;
    const int ppw = 32 / lpr, sub = lane / lpr, sl = lane % lpr;
    // columns [C, round_up(C, 32)) of every row are zero (the last k-step)
    const int zc = (cp32 - C) / 8;
    for (int i = tid; i < P2 * zc; i += THREADS) {
      const int r = i / zc, k = C + (i % zc) * 8;
      vss::zero16(lns + (k >> 6) * P2 * 64 + vss::swz<64>(r, k & 63));
    }
    for (int i = tid; i < P1 * zc; i += THREADS) {
      const int r = i / zc, k = C + (i % zc) * 8;
      vss::zero16(gos + (k >> 6) * P1 * 64 + vss::swz<64>(r, k & 63));
    }
    float gm[2][8], bt[2][8];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int ck = sl + lpr * q;
      if (ck < c8) {
        vss::load8(p.gamma + ck * 8, gm[q]);
        vss::load8(p.beta + ck * 8, bt[q]);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) gm[q][i] = bt[q][i] = 0.f;
      }
    }
    for (int p0 = warp * ppw * LN_PASSES; p0 < P2; p0 += WARPS * ppw * LN_PASSES) {
      float v[LN_PASSES][2][8];
      bool ok[LN_PASSES];
#pragma unroll
      for (int u = 0; u < LN_PASSES; ++u) {
        const int pp = p0 + u * ppw + sub;
        const int ri = pp / tw4, ci = pp - ri * tw4;
        const int i = i0 - 2 + ri, j = j0 - 2 + ci;
        ok[u] = pp < P2 && i >= 0 && i < H && j >= 0 && j < W;
        const long long base = (((long long)f * H + i) * W + j) * C;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int ck = sl + lpr * q;
          if (ok[u] && ck < c8) {
            if (p.x_f32)
              ldg8(static_cast<const float*>(p.x) + base + ck * 8, v[u][q]);
            else
              ldg8(static_cast<const __nv_bfloat16*>(p.x) + base + ck * 8, v[u][q]);
          } else {
#pragma unroll
            for (int i = 0; i < 8; ++i) v[u][q][i] = 0.f;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < LN_PASSES; ++u) {
        const int pp = p0 + u * ppw + sub;
        float sum = 0.f;
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int i = 0; i < 8; ++i) sum += v[u][q][i];
        for (int o = lpr / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        const float mean = sum / C;
        float sq = 0.f;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (sl + lpr * q < c8) {
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float d = v[u][q][i] - mean;
              sq += d * d;
            }
          }
        }
        for (int o = lpr / 2; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
        const float rstd = rsqrtf(sq / C + p.eps);
        if (pp < P2) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int ck = sl + lpr * q;
            if (ck < c8) {
              float o[8];
#pragma unroll
              for (int i = 0; i < 8; ++i)
                o[i] = ok[u] ? (v[u][q][i] - mean) * rstd * gm[q][i] + bt[q][i] : 0.f;
              const int k = ck * 8;
              vss::store8(lns + (k >> 6) * P2 * 64 + vss::swz<64>(pp, k & 63), o);
            }
          }
          if (sl == 0) valid[pp] = ok[u] ? 1 : 0;
        }
      }
    }
  }
  // ---- go_s = bf16(go·s) of the one-pixel halo tile, zero outside the image -
  {
    const float sc = p.s_ffn[f];
    for (int i = tid; i < P1 * c8; i += THREADS) {
      const int pp = i / c8, k = (i - pp * c8) * 8;
      const int ri = pp / tw2, ci = pp - ri * tw2;
      const int ii = i0 - 1 + ri, jj = j0 - 1 + ci;
      float o[8];
      if (ii >= 0 && ii < H && jj >= 0 && jj < W) {
        ldg8(p.go + (((long long)f * H + ii) * W + jj) * C + k, o);
#pragma unroll
        for (int e = 0; e < 8; ++e) o[e] *= sc;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) o[e] = 0.f;
      }
      vss::store8(gos + (k >> 6) * P1 * 64 + vss::swz<64>(pp, k & 63), o);
    }
  }

  // ---- the hidden chunks ----------------------------------------------------
  // d_ln: this warpgroup's rows of the d_hid_b chunk and its atoms of C. Every
  // warpgroup runs every product (rows past the tile read a clamped row,
  // atoms past C the last one), so that no wgmma sits on a path the
  // compiler cannot prove uniform; what they add is never stored.
  const int arow = (PIX2 ? wg * 64 : 0) + wl * 16;
  const int last_atom = cp64 / 64 - 1;
  float acc[NA][32];
#pragma unroll
  for (int j = 0; j < NA; ++j)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[j][e] = 0.f;
  const int cg = tid % Q4;  // THREADS % Q4 == 0: a thread's channel group is fixed
  const int T2 = (P2 + 63) / 64, T1 = (P1 + 63) / 64;
  // the warpgroups take the T2 + T1 m-tiles of fc1 and d_a in turn
  const int da0 = T2 + ((wg + T2) & 1);

  for (int ck = c_lo; ck < c_hi; ++ck) {
    const int h0 = ck * HC;
    vss::cp_async_wait<0>();  // W1, W2 and the chunk's b1, bdw, taps
    fence_async_smem();
    __syncthreads();
    // fc1 over the two-pixel halo: hid = LN · W1[:, chunk] + b1, zero outside
    // the image (b1 and the flags read before any store of hid)
    {
      float b1v[HC / 8][2];
#pragma unroll
      for (int j = 0; j < HC / 8; ++j) {
        const float2 v = *reinterpret_cast<const float2*>(prm + 8 * j + 2 * t4);
        b1v[j][0] = v.x;
        b1v[j][1] = v.y;
      }
      for (int mt = wg; mt < T2; mt += 2) {
        float d[HC / 2];
        const int r0 = mt * 64 + wl * 16;
        halo_product<HC, true>(d, lns, P2, r0, lane, cp32, w1a, w2a);
        const int ra = r0 + g, rb = r0 + g + 8;
        const bool in0 = ra < P2 && valid[ra] != 0, in1 = rb < P2 && valid[rb] != 0;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = hf ? rb : ra;
          if (r >= P2) continue;
          const bool in = hf ? in1 : in0;
#pragma unroll
          for (int j = 0; j < HC / 8; ++j) {
            const float2 o = in ? make_float2(d[4 * j + 2 * hf] + b1v[j][0],
                                              d[4 * j + 2 * hf + 1] + b1v[j][1])
                                : make_float2(0.f, 0.f);
            *reinterpret_cast<float2*>(hid + hoff<HC>(r, 8 * j + 2 * t4)) = o;
          }
        }
      }
    }
    // d_a = go_s · W2[chunk, :]ᵀ over the one-pixel halo (W2's rows K-major)
    for (int mt = da0; mt < T2 + T1; mt += 2) {
      float d[HC / 2];
      const int r0 = (mt - T2) * 64 + wl * 16;
      halo_product<HC, false>(d, gos, P1, r0, lane, cp32, w1a, w2a);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = r0 + g + hf * 8;
        if (r >= P1) continue;
#pragma unroll
        for (int j = 0; j < HC / 8; ++j)
          *reinterpret_cast<float2*>(dz + hoff<HC>(r, 8 * j + 2 * t4)) =
              make_float2(d[4 * j + 2 * hf], d[4 * j + 2 * hf + 1]);
      }
    }
    __syncthreads();
    load_w2(ck + 1);  // d_a has read this chunk's W2
    // z = dw3x3(hid) + bdw (the taps in (di, dj) order) and d_z =
    // d_a·GELU'(z) over the one-pixel halo, in place of d_a, zero outside the
    // image; on the tile's own pixels a = bf16(GELU(z)) from the same erff
    // and, from the 3x3 window of hid still in registers, the partials
    // Σ hid(shifted)·d_z and Σ d_z. An item is 4 channels of one pixel.
    float tp[9][4], sz[4], sh[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sz[e] = sh[e] = 0.f;
#pragma unroll
      for (int q = 0; q < 9; ++q) tp[q][e] = 0.f;
    }
    float kt[9][4];
#pragma unroll
    for (int q = 0; q < 9; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(prm + (2 + q) * HC + cg * 4);
      kt[q][0] = v.x; kt[q][1] = v.y; kt[q][2] = v.z; kt[q][3] = v.w;
    }
    {
      const float4 bv = *reinterpret_cast<const float4*>(prm + HC + cg * 4);
      const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
      for (int it = tid; it < P1 * Q4; it += THREADS) {
        const int q = it / Q4;
        const int ri = q / tw2, ci = q - ri * tw2;
        float hv[9][4];
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const float4 v = *reinterpret_cast<const float4*>(
              hid + hoff<HC>((ri + tap / 3) * tw4 + ci + tap % 3, cg * 4));
          hv[tap][0] = v.x; hv[tap][1] = v.y; hv[tap][2] = v.z; hv[tap][3] = v.w;
        }
        const float4 dav = *reinterpret_cast<const float4*>(dz + hoff<HC>(q, cg * 4));
        const float da[4] = {dav.x, dav.y, dav.z, dav.w};
        const bool in = valid[(ri + 1) * tw4 + ci + 1] != 0;
        const bool own = ri >= 1 && ri <= R && ci >= 1 && ci <= TW;
        float gz[4], a[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float z = hv[0][e] * kt[0][e];
#pragma unroll
          for (int tap = 1; tap < 9; ++tap) z = z + hv[tap][e] * kt[tap][e];
          z = z + bb[e];
          const float er = erff(z * 0.7071067811865476f);
          const float phi = __expf(-0.5f * z * z) * 0.3989422804014327f;
          gz[e] = in ? da[e] * (0.5f * (1.0f + er) + z * phi) : 0.f;
          a[e] = 0.5f * z * (1.0f + er);
        }
        *reinterpret_cast<float4*>(dz + hoff<HC>(q, cg * 4)) =
            make_float4(gz[0], gz[1], gz[2], gz[3]);
        if (own) {
          if (h0 + cg * 4 < Ch) {
            const long long m = ((long long)f * H + i0 + ri - 1) * W + j0 + ci - 1;
            uint2 pk;
            pk.x = vss::pack_bf16(a[0], a[1]);
            pk.y = vss::pack_bf16(a[2], a[3]);
            *reinterpret_cast<uint2*>(p.a_out + m * Ch + h0 + cg * 4) = pk;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
#pragma unroll
            for (int tap = 0; tap < 9; ++tap) tp[tap][e] += hv[tap][e] * gz[e];
            sz[e] += gz[e];
          }
        }
      }
    }
    __syncthreads();
    // d_hid = dw3x3ᵀ(d_z) of the tile's own pixels ((dj, di) order) → bf16
    // (shared memory, in place of the hidden chunk, and device memory),
    // Σ d_hid in f32
    for (int it = tid; it < pout * Q4; it += THREADS) {
      const int pp = it / Q4;
      const int r = pp / TW, c = pp - r * TW;
      float dh[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int dj = 0; dj < 3; ++dj)
#pragma unroll
        for (int di = 0; di < 3; ++di) {
          const float4 v = *reinterpret_cast<const float4*>(
              dz + hoff<HC>((r + 2 - di) * tw2 + c + 2 - dj, cg * 4));
          const float* k = kt[di * 3 + dj];
          if (dj == 0 && di == 0) {
            dh[0] = v.x * k[0]; dh[1] = v.y * k[1]; dh[2] = v.z * k[2]; dh[3] = v.w * k[3];
          } else {
            dh[0] = dh[0] + v.x * k[0]; dh[1] = dh[1] + v.y * k[1];
            dh[2] = dh[2] + v.z * k[2]; dh[3] = dh[3] + v.w * k[3];
          }
        }
      uint2 pk;
      pk.x = vss::pack_bf16(dh[0], dh[1]);
      pk.y = vss::pack_bf16(dh[2], dh[3]);
      *reinterpret_cast<uint2*>(dhb + vss::swz<HC>(pp, cg * 4)) = pk;
      if (h0 + cg * 4 < Ch) {
        const long long m = ((long long)f * H + i0 + r) * W + j0 + c;
        *reinterpret_cast<uint2*>(p.dhid_out + m * Ch + h0 + cg * 4) = pk;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) sh[e] += dh[e];
    }
    __syncthreads();
    // d_ln += d_hid_b · W1[:, chunk]ᵀ (W1's rows read K-major), started here
    // and waited for after the partial sums below
    {
      uint32_t af[HC / 16][4];
#pragma unroll
      for (int i = 0; i < HC / 16; ++i) load_a_rows<HC>(af[i], dhb, arow, 16 * i, lane, pout);
      vss::wgmma_fence();
#pragma unroll
      for (int i = 0; i < HC / 16; ++i)
#pragma unroll
        for (int j = 0; j < NA; ++j) {
          const int atom = min(PIX2 ? j : wg + 2 * j, last_atom);
          vss::wgmma_m64n64k16_rs<0>(
              acc[j], af[i], vss::wgmma_desc(w1a + atom * 64 * HC * 2 + i * 32, 16, 16 * HC, SW1));
        }
      vss::wgmma_commit();
    }
    // the chunk's 11 partial sums: over the lanes of one channel group
    // (shuffles), then each warp's to shared memory
    {
      float v[11][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int q = 0; q < 9; ++q) v[q][e] = tp[q][e];
        v[9][e] = sz[e];
        v[10][e] = sh[e];
      }
#pragma unroll
      for (int o = Q4; o < 32; o <<= 1)
#pragma unroll
        for (int q = 0; q < 11; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) v[q][e] += __shfl_xor_sync(0xffffffffu, v[q][e], o);
      if (lane < Q4) {
#pragma unroll
        for (int q = 0; q < 11; ++q)
          *reinterpret_cast<float4*>(red + (warp * 11 + q) * HC + lane * 4) =
              make_float4(v[q][0], v[q][1], v[q][2], v[q][3]);
      }
    }
    vss::wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < NA; ++j) vss::fence_regs(acc[j]);
    __syncthreads();
    load_w1(ck + 1);  // d_ln has read this chunk's W1
    // the block's partials of the chunk's channels, the warps in order
    for (int e = tid; e < 11 * HC; e += THREADS) {
      const int q = e / HC, c = e - q * HC;
      if (h0 + c >= Ch) continue;
      float s = red[q * HC + c];
      for (int w = 1; w < WARPS; ++w) s += red[(w * 11 + q) * HC + c];
      p.cpart[(tile * 11 + q) * Ch + h0 + c] = s;
    }
  }
  vss::cp_async_wait<0>();
  __syncthreads();

  // ---- d_ln: a split's partial, or the LayerNorm backward -------------------
  const long long M = (long long)p.B * H * W;
  long long mrow[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int pp = arow + g + hf * 8;
    const int r = pp / TW, c = pp - r * TW;
    mrow[hf] = pp < pout ? ((long long)f * H + i0 + r) * W + j0 + c : -1;
  }
  const int CS = C + 8;
  float* dls = reinterpret_cast<float*>(smem + L.ln);
  {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      if (mrow[hf] < 0) continue;
      const int pp = arow + g + hf * 8;
#pragma unroll
      for (int j = 0; j < NA; ++j) {
        const int atom = PIX2 ? j : wg + 2 * j;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int n = atom * 64 + 8 * jj + 2 * t4;
          if (n >= C) continue;
          const float2 v = make_float2(acc[j][4 * jj + 2 * hf], acc[j][4 * jj + 2 * hf + 1]);
          if (p.splits > 1)
            *reinterpret_cast<float2*>(p.dlpart + (blockIdx.y * M + mrow[hf]) * C + n) = v;
          else
            *reinterpret_cast<float2*>(dls + pp * CS + n) = v;
        }
      }
    }
  }
  if (p.splits > 1) return;
  __syncthreads();
  ln_epilogue(
      p, pout,
      [&](int pp) {
        const int r = pp / TW, c = pp - r * TW;
        return ((long long)f * H + i0 + r) * W + j0 + c;
      },
      [&](int pp, int k, float* v) {
        const float4 a = *reinterpret_cast<const float4*>(dls + pp * CS + k);
        const float4 b = *reinterpret_cast<const float4*>(dls + pp * CS + k + 4);
        v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
        v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
      },
      hid, tile);
}

// After a split: d_ln = ((part_0 + part_1) + ...) of EPI_ROWS consecutive
// pixels, then the LayerNorm backward.
__global__ void __launch_bounds__(THREADS) ffn_bwd_ln_kernel(const Args p) {
  __shared__ float red[4 * CMAX];
  const long long M = (long long)p.B * p.H * p.W;
  const long long r0 = (long long)blockIdx.x * EPI_ROWS;
  const int np = (int)min((long long)EPI_ROWS, M - r0);
  const int C = p.C, S = p.splits;
  ln_epilogue(
      p, np, [&](int pp) { return r0 + pp; },
      [&](int pp, int k, float* v) {
        const long long o = (r0 + pp) * C + k;
        vss::load8(p.dlpart + o, v);
        for (int s = 1; s < S; ++s) {
          float w[8];
          vss::load8(p.dlpart + s * M * C + o, w);
#pragma unroll
          for (int i = 0; i < 8; ++i) v[i] += w[i];
        }
      },
      red, blockIdx.x);
}

template <int HC, int K>
int launch(const Args& a, int bytes, cudaStream_t st) {
  static bool attr = false;  // one instance per template: set its limit once
  if (!attr) {
    cudaError_t e = cudaFuncSetAttribute(ffn_bwd_kernel<HC, K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  dim3 grid((unsigned)(a.B * a.tiles_h * a.tiles_w), (unsigned)a.splits);
  ffn_bwd_kernel<HC, K><<<grid, THREADS, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

template <int HC>
int launch_hc(const Args& a, int bytes, cudaStream_t st) {
  switch (cls_of(a.C)) {
    case 0: return launch<HC, 0>(a, bytes, st);
    case 1: return launch<HC, 1>(a, bytes, st);
    case 2: return launch<HC, 2>(a, bytes, st);
    case 3: return launch<HC, 3>(a, bytes, st);
    default: return launch<HC, 4>(a, bytes, st);
  }
}

}  // namespace

// Shared memory (bytes) of one block of tiles of at most rows x cols pixels
// at width c with chunks of hc hidden channels.
VSS_EXPORT int ffn_bwd_smem_bytes(int rows, int cols, int c, int hc) {
  return layout(rows, cols, c, hc).total;
}

// x (B, H, W, C) bf16 or f32 (x_f32); go (B·H·W, C) bf16; gamma, beta (C,)
// f32; w1 (C, Ch) bf16; b1 (Ch,), kdw (9, Ch), bdw (Ch,) f32; w2 (Ch, C)
// bf16; s_ffn (B,) f32; s_attn (B,) f32 when full. Out: a_out, dhid_out
// (B·H·W, Ch) bf16; ln_out (B·H·W, C) bf16; dx_out (B·H·W, C): f32 d_y when
// full (and dattn_out bf16), else dx in x's dtype; cpart (tiles, 11, Ch) f32
// (the 9 tap sums, Σ d_z, Σ d_hid); epart (tiles, or ceil(B·H·W / 64) when
// splits > 1, 4, C) f32 (Σ d_ln·x̂, Σ d_ln, Σ go·s_ffn, Σ d_y·s_attn);
// dlpart (splits, B·H·W, C) f32 when splits > 1. Tiles of rows x cols pixels
// (at most 128 at C <= 128, else 64), chunks of hc (32 or 64) hidden
// channels, splits runs of `chunks` chunks (each run non-empty). C, Ch
// multiples of 8, C <= 512, pointers 16-byte aligned (checked by the Python
// wrapper). One launch, or two with a split. Returns a cudaError_t.
VSS_EXPORT int ffn_bwd(const void* x, const void* go, const void* gamma, const void* beta,
                       const void* w1, const void* b1, const void* kdw, const void* bdw,
                       const void* w2, const void* s_ffn, const void* s_attn, void* a_out,
                       void* dhid_out, void* ln_out, void* dx_out, void* dattn_out, void* cpart,
                       void* epart, void* dlpart, int B, int H, int W, int C, int Ch, int x_f32,
                       int full, int rows, int cols, int hc, int splits, int chunks, float eps,
                       int device, void* stream) {
  vss::use_device(device);
  if (B == 0 || H == 0 || W == 0) return 0;
  const int nchunks = (Ch + hc - 1) / hc;
  const int bytes = layout(rows, cols, C, hc).total;
  if (C % 8 || Ch % 8 || C < 8 || C > CMAX || Ch < 8 || H < 0 || W < 0 || rows < 1 ||
      cols < 1 || rows * cols > max_pixels_of(cls_of(C)) || (hc != 32 && hc != 64) ||
      splits < 1 || chunks < 1 || (long long)splits * chunks < nchunks ||
      (splits - 1) * chunks >= nchunks || (splits > 1 && dlpart == nullptr) ||
      (full && (s_attn == nullptr || dattn_out == nullptr)) || bytes > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  const int th = (H + rows - 1) / rows, tw = (W + cols - 1) / cols;
  Args a{x,
         static_cast<const __nv_bfloat16*>(go),
         static_cast<const float*>(gamma),
         static_cast<const float*>(beta),
         static_cast<const __nv_bfloat16*>(w1),
         static_cast<const float*>(b1),
         static_cast<const float*>(kdw),
         static_cast<const float*>(bdw),
         static_cast<const __nv_bfloat16*>(w2),
         static_cast<const float*>(s_ffn),
         static_cast<const float*>(s_attn),
         static_cast<__nv_bfloat16*>(a_out),
         static_cast<__nv_bfloat16*>(dhid_out),
         static_cast<__nv_bfloat16*>(ln_out),
         dx_out,
         static_cast<__nv_bfloat16*>(dattn_out),
         static_cast<float*>(cpart),
         static_cast<float*>(epart),
         static_cast<float*>(dlpart),
         B, H, W, C, Ch, x_f32, full, rows, cols, th, tw, chunks, splits, eps};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int rc = hc == 64 ? launch_hc<64>(a, bytes, st) : launch_hc<32>(a, bytes, st);
  if (rc != 0 || splits == 1) return rc;
  const long long M = (long long)B * H * W;
  ffn_bwd_ln_kernel<<<(unsigned)((M + EPI_ROWS - 1) / EPI_ROWS), THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}
