// The FFN half of a MiT block at inference in one launch:
//
//     out = bf16( [res] + [s] · ( bf16( GELU( dw3x3( mask( [LN](x)·W1 + b1 ) ) + bdw ) ) · W2 + b2 ) )
//
// x (B, H, W, C) bf16 or f32, the FFN's input; res (B·H·W, C) bf16, f32 or
// none; s (B,) f32, the per-frame branch scale of training (stochastic
// depth), or none; W1 (C, Ch) and W2 (Ch, C) bf16 row-major; b1, bdw (Ch,),
// the taps (9, Ch) and b2 (C,) f32; gamma and beta (C,) f32, or none: then
// fc1 reads x itself (rounded to bf16), the MixFFN alone.
//
// Replaces the FFN half of the TPU kernels vss_cffm_tpu/ops/stage_block.py:
// _kernel (:134-150: LN2 → fc1 → masked hidden map → 3x3 depthwise → GELU →
// fc2 → + y, the whole block's second half, row 1 of PERF.md's table) and
// vss_cffm_tpu/ops/mixffn.py:_kernel_ln (:106) without a scale (row 8:
// block_ffn_fused) and with it (row 10: _block_ffn_fwd_scaled, the forward
// of the block-FFN train pair, and the FFN half of row 6, the whole block's
// train forward, where the JAX kernels keep nothing for the backward and
// neither does this launch), and vss_cffm_tpu/ops/mixffn.py:_kernel (:62,
// row 9: mixffn_fused, no LayerNorm, no residual). All keep the hidden map
// in VMEM. The port's earlier
// route wrote it to device memory in f32 (block_gemm), read it back for the
// depthwise pass (dwconv.cu), wrote a in bf16 and read a again for fc2: at
// B1 stage 2 ~107 MB a clip's pair of blocks, for ~11 MB of inputs and
// outputs. Here neither the hidden map nor a leaves the SM.
//
// Bound on the H100: the tensor cores at the B1 stages (2·M·C·Ch·2 FLOP
// against ~(x, W1, W2, out) bytes: ~600 FLOP a byte at stage 3, above the
// card's 295); the halo's fc1 is recomputed, 1.3-2x of fc1's own work at
// the planned tiles.
// Design:
//  - A block (two warpgroups, one block an SM) owns a tile of rows x cols
//    output pixels of one frame (ops/ffn_fused.py:ffn_fused_plan; the last
//    band and strip of a frame shorter). It computes the LayerNorm of the
//    tile and its one-pixel halo (f32 statistics, two passes as
//    block_gemm.cu; a pixel's channels on a power-of-two group of lanes, 4
//    passes of a warp's pixels with their loads in flight), or without gamma
//    takes x as it is, and keeps it in shared memory in bf16, 64-column
//    chunks, XOR-swizzled; halo pixels outside the image are zeros and
//    flagged.
//  - The block walks the hidden channels in chunks of hc (64 or 32; a split
//    walks its own run of chunks). For each chunk: fc1 over the halo tile
//    on wgmma m64n{hc}k16 (A, the LN rows, by ldmatrix into registers; B,
//    the W1 chunk, read by wgmma from shared memory through a descriptor:
//    MN-major rows of hc bf16 in the 128- or 64-byte swizzle ldmatrix
//    uses; the warpgroups take the 64-pixel m-tiles in turn) → the f32
//    hidden chunk in shared memory, b1 added and zero outside the image
//    (the JAX ``valid`` mask); the depthwise 3x3 + bdw + exact erff GELU,
//    an item being 4 channels of a column walking down a run of rows with
//    three running sums, so that each halo row is read once (the nine taps
//    in the plain version's (di, dj) order) → the bf16 a chunk in shared
//    memory; fc2 on wgmma m64n64k16 (A, the a rows, by ldmatrix; B, 64-column
//    atoms of the W2 chunk), added into register accumulators of the tile's
//    pixels x C: up to 128 pixels with each warpgroup on 64 of them and all
//    of C (C <= 128), else 64 pixels with the warpgroups on every other
//    64-column atom (at most 128 f32 a thread at C = 512).
//  - The W1 and W2 chunks (with b1, bdw and the taps) stream in by cp.async
//    into one buffer each: W1 of the next chunk is in flight during this
//    chunk's depthwise pass and fc2, W2 of the next chunk during its fc1.
//    All of W1 and W2 is at most 4.2 MB (stage 4) and stays in L2.
//  - Reads that the compiler cannot tell apart from the stores around them
//    (b1 and the flags beside the hidden chunk's stores, the next halo row
//    beside a's, the residual and b2 beside out's) are made before them:
//    kept behind the stores they cost up to 19K cycles a block (H100 SXM).
//  - Where the tiles alone leave the card short of blocks (B1 stages 3 and
//    4), the chunks are split over blocks (blockIdx.y): each writes its f32
//    partial of fc2 (no b2), and ffn_reduce_kernel sums the partials in
//    split order, then adds b2 and the residual and rounds to bf16. No
//    atomics: two runs give the same bits.
// Rounding points are the plain version's (ops/stage_block.py:
// _ffn_fwd_steps): LN in f32, bf16 before fc1, the hidden map in f32, a in
// bf16, fc2 in f32, then b2, then the frame's scale, then the residual, bf16
// out.
#include "common.cuh"
#include "mma_sync.cuh"
#include "tma_wgmma.cuh"

namespace {

constexpr int THREADS = 256, WARPS = 8;  // two warpgroups
constexpr int LN_PASSES = 4;  // passes of a warp's LayerNorm pixels in flight
constexpr int SMEM_MAX = 232448;

__host__ __device__ constexpr int rup(int a, int b) { return (a + b - 1) / b * b; }

// fc2's split of the work by width (ops/ffn_fused.py:_CLASSES): with PIX2
// each warpgroup owns 64 of the tile's (up to 128) pixels and all NA
// 64-column atoms of C; without, both own the tile's (up to 64) pixels and
// the warpgroups take every other atom, NA each. The accumulators are NA x
// 32 f32 a thread.
template <int K> struct Cls;
template <> struct Cls<0> { static constexpr bool PIX2 = true;  static constexpr int NA = 1; };
template <> struct Cls<1> { static constexpr bool PIX2 = true;  static constexpr int NA = 2; };
template <> struct Cls<2> { static constexpr bool PIX2 = false; static constexpr int NA = 2; };
template <> struct Cls<3> { static constexpr bool PIX2 = false; static constexpr int NA = 3; };
template <> struct Cls<4> { static constexpr bool PIX2 = false; static constexpr int NA = 4; };

__host__ __device__ inline int cls_of(int c) {
  return c <= 64 ? 0 : c <= 128 ? 1 : c <= 256 ? 2 : c <= 384 ? 3 : 4;
}
// the most output pixels of a tile, and the columns of the W2 chunk (all the
// atoms fc2 runs, zeros past C), by class
__host__ __device__ inline int max_pixels_of(int k) { return k <= 1 ? 128 : 64; }
__host__ __device__ inline int w2cols_of(int k) {
  return k == 0 ? 64 : k == 1 ? 128 : k == 2 ? 256 : k == 3 ? 384 : 512;
}

struct Layout {
  int ln, w1, w2, b1, dw, hid, a, valid, total;
};

// byte offsets of a block's shared memory past its 1024-byte aligned base
// (ops/ffn_fused.py:ffn_fused_smem): W1 and W2, which wgmma reads through
// descriptors, sit on 1024-byte boundaries
__host__ __device__ inline Layout layout(int prow, int c, int hc, int k) {
  const int cp64 = rup(c, 64), cp32 = rup(c, 32);
  Layout s;
  int o = 0;
  s.ln = o;  o += prow * cp64 * 2;            // LN of the halo tile, 64-column chunks
  s.w1 = o;  o += cp32 * hc * 2;              // W1[:, chunk], rows past C zero
  s.w2 = o;  o += hc * w2cols_of(k) * 2;      // W2[chunk, :], 64-column atoms, zeros past C
  s.b1 = o;  o += hc * 4;                     // b1[chunk]
  s.dw = o;  o += 10 * hc * 4;                // bdw[chunk], then the 9 taps
  s.hid = o; o += prow * (hc + 8) * 4;        // hidden chunk, f32, rows padded
  s.a = o;   o += max_pixels_of(k) * hc * 2;  // a chunk, bf16
  s.valid = o; o += rup(prow, 16);            // halo pixel inside the image
  s.total = o + 1024;                         // and the base's alignment
  return s;
}

struct Args {
  const void* x;
  const float* gamma;
  const float* beta;
  const __nv_bfloat16* w1;
  const float* b1;
  const float* kdw;
  const float* bdw;
  const __nv_bfloat16* w2;
  const float* b2;
  const float* scale;  // (B,) or null
  const void* res;
  void* out;  // bf16 (M, C), or the f32 partials (splits, M, C)
  int B, H, W, C, Ch, x_f32, res_kind, rows, cols, tiles_h, tiles_w, prow, chunks, splits;
  float eps;
};

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

// d (64 x hc, f32) += a (64 x 16, registers) · B (16 x hc, MN-major in shared memory)
template <int HC>
__device__ __forceinline__ void wgmma_hc(float (&d)[HC / 2], const uint32_t (&a)[4],
                                         uint64_t b) {
  if constexpr (HC == 64)
    vss::wgmma_m64n64k16_rs<1>(d, a, b);
  else
    vss::wgmma_m64n32k16_rs<1>(d, a, b);
}

// make this thread's writes of W1 / W2 (cp.async, zero fills) visible to
// wgmma's reads through descriptors (the async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int HC, int K>
__global__ void __launch_bounds__(THREADS, 1) ffn_fused_kernel(const Args p) {
  constexpr bool PIX2 = Cls<K>::PIX2;
  constexpr int NA = Cls<K>::NA;
  constexpr int W2C = PIX2 ? NA * 64 : 2 * NA * 64;  // columns of the W2 chunk
  constexpr int Q4 = HC / 4;  // 4-channel groups of a hidden chunk
  constexpr uint32_t SW1 = HC == 64 ? 1 : 2;  // W1 rows of 128 or 64 bytes, swizzled
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (vss::smem_addr(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wg = warp / 4, wl = warp % 4;  // warpgroup, warp within it
  const int C = p.C, Ch = p.Ch, H = p.H, W = p.W, prow = p.prow;
  const int cp32 = rup(C, 32);
  const Layout L = layout(prow, C, HC, K);
  __nv_bfloat16* lns = reinterpret_cast<__nv_bfloat16*>(smem + L.ln);
  __nv_bfloat16* w1s = reinterpret_cast<__nv_bfloat16*>(smem + L.w1);
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem + L.w2);
  float* b1s = reinterpret_cast<float*>(smem + L.b1);
  float* dws = reinterpret_cast<float*>(smem + L.dw);
  float* hid = reinterpret_cast<float*>(smem + L.hid);
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem + L.a);
  unsigned char* valid = smem + L.valid;
  const uint32_t w1a = vss::smem_addr(w1s), w2a = vss::smem_addr(w2s);

  // the tile: frame f, output rows [i0, i0 + R), columns [j0, j0 + TW)
  int t = blockIdx.x;
  const int tj = t % p.tiles_w;
  t /= p.tiles_w;
  const int ti = t % p.tiles_h;
  const int f = t / p.tiles_h;
  const int i0 = ti * p.rows, j0 = tj * p.cols;
  const int R = min(p.rows, H - i0), TW = min(p.cols, W - j0);
  const int tw2 = TW + 2, pin = (R + 2) * tw2, pout = R * TW;
  const int nchunks = (Ch + HC - 1) / HC;
  const int c_lo = blockIdx.y * p.chunks, c_hi = min(nchunks, c_lo + p.chunks);

  // W1[:, chunk] and b1[chunk]: zeros past C and past Ch
  auto load_w1 = [&](int ck) {
    if (ck < c_hi) {
      const int h0 = ck * HC;
      constexpr int PR = HC / 8;
      for (int i = tid; i < cp32 * PR; i += THREADS) {
        const int k = i / PR, col = (i % PR) * 8;
        __nv_bfloat16* d = w1s + vss::swz<HC>(k, col);
        if (k < C && h0 + col < Ch)
          vss::cp_async16(d, p.w1 + (long long)k * Ch + h0 + col);
        else
          vss::zero16(d);
      }
      if (tid < Q4) {
        float* d = b1s + tid * 4;
        if (h0 + tid * 4 < Ch)
          vss::cp_async16(d, p.b1 + h0 + tid * 4);
        else
          vss::zero16(d);
      }
    }
    vss::cp_async_commit();
  };
  // W2[chunk, :] (zeros past C and past Ch), bdw[chunk] and the taps
  auto load_w2 = [&](int ck) {
    if (ck < c_hi) {
      const int h0 = ck * HC;
      constexpr int PR = W2C / 8;
      for (int i = tid; i < HC * PR; i += THREADS) {
        const int k = i / PR, col = (i % PR) * 8;
        __nv_bfloat16* d = w2s + (col >> 6) * (HC * 64) + vss::swz<64>(k, col & 63);
        if (h0 + k < Ch && col < C)
          vss::cp_async16(d, p.w2 + (long long)(h0 + k) * C + col);
        else
          vss::zero16(d);
      }
      for (int i = tid; i < 10 * Q4; i += THREADS) {
        const int r = i / Q4, c4 = (i % Q4) * 4;
        float* d = dws + r * HC + c4;
        const float* s = r == 0 ? p.bdw + h0 + c4 : p.kdw + (long long)(r - 1) * Ch + h0 + c4;
        if (h0 + c4 < Ch)
          vss::cp_async16(d, s);
        else
          vss::zero16(d);
      }
    }
    vss::cp_async_commit();
  };

  load_w1(c_lo);
  load_w2(c_lo);
  // a's rows past the tile's pixels stay zero
  for (int i = tid; i < max_pixels_of(K) * HC / 8; i += THREADS) vss::zero16(as + i * 8);

  // ---- LayerNorm of the halo tile → bf16 in shared memory ----------------
  // A pixel's C / 8 chunks of 8 lie on lpr lanes (at most two a lane), so a
  // warp normalises 32 / lpr pixels a pass, LN_PASSES passes with their loads
  // in flight; the statistics are reduced over the lpr lanes. Without gamma
  // the tile is x itself (no statistics)
  {
    const bool ln = p.gamma != nullptr;
    const int c8 = C / 8;
    int lpr = 1;
    while (lpr < 32 && lpr * 2 < c8) lpr *= 2;
    const int ppw = 32 / lpr, sub = lane / lpr, sl = lane % lpr;
    // columns [C, round_up(C, 32)) of every row are zero (fc1's last k-step)
    for (int i = tid; i < prow * (cp32 - C) / 8; i += THREADS) {
      const int r = i / ((cp32 - C) / 8), k = C + (i % ((cp32 - C) / 8)) * 8;
      vss::zero16(lns + (k >> 6) * prow * 64 + vss::swz<64>(r, k & 63));
    }
    float gm[2][8], bt[2][8];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int ck = sl + lpr * q;
      if (ln && ck < c8) {
        vss::load8(p.gamma + ck * 8, gm[q]);
        vss::load8(p.beta + ck * 8, bt[q]);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) gm[q][i] = bt[q][i] = 0.f;
      }
    }
    for (int p0 = warp * ppw * LN_PASSES; p0 < prow; p0 += WARPS * ppw * LN_PASSES) {
      float v[LN_PASSES][2][8];
      bool ok[LN_PASSES];
#pragma unroll
      for (int u = 0; u < LN_PASSES; ++u) {
        const int pp = p0 + u * ppw + sub;
        const int ri = pp / tw2, ci = pp - ri * tw2;
        const int i = i0 - 1 + ri, j = j0 - 1 + ci;
        ok[u] = pp < pin && i >= 0 && i < H && j >= 0 && j < W;
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
        float mean = 0.f, rstd = 1.f;
        if (ln) {  // the same for every lane of the block
          float sum = 0.f;
#pragma unroll
          for (int q = 0; q < 2; ++q)
#pragma unroll
            for (int i = 0; i < 8; ++i) sum += v[u][q][i];
          for (int o = lpr / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
          mean = sum / C;
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
          rstd = rsqrtf(sq / C + p.eps);
        }
        if (pp < prow) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int ck = sl + lpr * q;
            if (ck < c8) {
              float o[8];
#pragma unroll
              for (int i = 0; i < 8; ++i)
                o[i] = !ok[u] ? 0.f
                       : ln   ? (v[u][q][i] - mean) * rstd * gm[q][i] + bt[q][i]
                              : v[u][q][i];
              const int k = ck * 8;
              vss::store8(lns + (k >> 6) * prow * 64 + vss::swz<64>(pp, k & 63), o);
            }
          }
          if (sl == 0) valid[pp] = ok[u] ? 1 : 0;
        }
      }
    }
  }

  // ---- the hidden chunks ----------------------------------------------------
  // fc2: this warpgroup's rows of the a chunk and its atoms of C
  const int arow = (PIX2 ? wg * 64 : 0) + wl * 16;
  const bool fc2_live = !PIX2 || wg * 64 < pout;
  float acc[NA][32];
#pragma unroll
  for (int j = 0; j < NA; ++j)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[j][e] = 0.f;

  for (int ck = c_lo; ck < c_hi; ++ck) {
    vss::cp_async_wait<1>();  // W1 of this chunk (W2's may still be in flight)
    fence_async_smem();
    __syncthreads();
    // fc1: hid = LN · W1[:, chunk] + b1, zero outside the image; the
    // warpgroups take the halo tile's 64-pixel m-tiles in turn, k-steps of
    // 16 channels with the next A fragment loaded while one product runs.
    // (b1 and the flags are read before any store of hid: the compiler
    // cannot tell the arrays apart and would order each read after them.)
    float b1v[HC / 8][2];
#pragma unroll
    for (int j = 0; j < HC / 8; ++j) {
      const float2 v = *reinterpret_cast<const float2*>(b1s + 8 * j + 2 * t4);
      b1v[j][0] = v.x;
      b1v[j][1] = v.y;
    }
    for (int mt = wg; mt < prow / 64; mt += 2) {
      float d[HC / 2];
#pragma unroll
      for (int e = 0; e < HC / 2; ++e) d[e] = 0.f;
      const int r0 = mt * 64 + wl * 16;
      uint32_t af[2][4];
      for (int k = 0; k < cp32; k += 32) {
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int kb = k + 16 * b;
          vss::load_a<64>(af[b], lns + (kb >> 6) * prow * 64, r0, kb & 63, lane);
          vss::wgmma_fence();
          wgmma_hc<HC>(d, af[b], vss::wgmma_desc(w1a + kb * HC * 2, 16 * HC, 16 * HC, SW1));
          vss::wgmma_commit();
          vss::wgmma_wait<1>();
        }
      }
      const bool in0 = valid[r0 + g] != 0, in1 = valid[r0 + g + 8] != 0;
      vss::wgmma_wait<0>();
      vss::fence_regs(d);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = r0 + g + hf * 8;
        const bool in = hf ? in1 : in0;
#pragma unroll
        for (int j = 0; j < HC / 8; ++j) {
          const float2 o = in ? make_float2(d[4 * j + 2 * hf] + b1v[j][0],
                                            d[4 * j + 2 * hf + 1] + b1v[j][1])
                              : make_float2(0.f, 0.f);
          *reinterpret_cast<float2*>(hid + r * (HC + 8) + 8 * j + 2 * t4) = o;
        }
      }
    }
    __syncthreads();
    load_w1(ck + 1);
    vss::cp_async_wait<1>();  // W2, bdw and the taps of this chunk
    fence_async_smem();
    __syncthreads();
    // depthwise 3x3 + bdw + GELU → a (bf16): an item is 4 channels of one
    // column of the tile walking down a run of its rows; each halo row it
    // loads (3 columns) is the last tap row of the output two rows up, the
    // middle one of the output above and the first of its own, so it is
    // added into three running sums (the taps in (di, dj) order) and never
    // loaded again
    {
      const int cg = tid % Q4;  // THREADS % Q4 == 0: fixed for the thread
      float kt[9][4], bb[4];
#pragma unroll
      for (int tap = 0; tap < 10; ++tap) {
        const float4 v = *reinterpret_cast<const float4*>(dws + tap * HC + cg * 4);
        float* d = tap == 0 ? bb : kt[tap - 1];
        d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
      }
      const int cq = TW * Q4;
      int nseg = min(R, (THREADS + cq - 1) / cq);
      const int rs = (R + nseg - 1) / nseg;
      nseg = (R + rs - 1) / rs;
      for (int it = tid; it < cq * nseg; it += THREADS) {
        const int rest = it / Q4;
        const int c = rest % TW, seg = rest / TW;
        const int r0 = seg * rs, r1 = min(R, r0 + rs);
        float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
        // the next halo row is read before this row's store (the compiler
        // cannot tell hid from a and would order the reads after it)
        const float* hp = hid + (r0 * tw2 + c) * (HC + 8) + cg * 4;
        float4 nx[3];
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) nx[dj] = *reinterpret_cast<const float4*>(hp + dj * (HC + 8));
        for (int ri = r0; ri < r1 + 2; ++ri) {
          float x[3][4];
#pragma unroll
          for (int dj = 0; dj < 3; ++dj) {
            x[dj][0] = nx[dj].x; x[dj][1] = nx[dj].y; x[dj][2] = nx[dj].z; x[dj][3] = nx[dj].w;
          }
          if (ri + 1 < r1 + 2) {
            hp += tw2 * (HC + 8);
#pragma unroll
            for (int dj = 0; dj < 3; ++dj)
              nx[dj] = *reinterpret_cast<const float4*>(hp + dj * (HC + 8));
          }
          if (ri >= r0 + 2) {  // output row ri - 2: its last tap row
            float o[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float a = s1[e];
#pragma unroll
              for (int dj = 0; dj < 3; ++dj) a += x[dj][e] * kt[6 + dj][e];
              o[e] = vss::gelu_erf(a + bb[e]);
            }
            uint2 pk;
            pk.x = vss::pack_bf16(o[0], o[1]);
            pk.y = vss::pack_bf16(o[2], o[3]);
            *reinterpret_cast<uint2*>(as + vss::swz<HC>((ri - 2) * TW + c, cg * 4)) = pk;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float a = s0[e];  // output row ri - 1: its middle tap row
#pragma unroll
            for (int dj = 0; dj < 3; ++dj) a += x[dj][e] * kt[3 + dj][e];
            s1[e] = a;
            float f0 = x[0][e] * kt[0][e];  // output row ri: its first tap row
            f0 += x[1][e] * kt[1][e];
            s0[e] = f0 + x[2][e] * kt[2][e];
          }
        }
      }
    }
    __syncthreads();
    // fc2: acc += a · W2[chunk, :] (every atom of the chunk's W2, zeros past C)
    if (fc2_live) {
      uint32_t af[HC / 16][4];
#pragma unroll
      for (int i = 0; i < HC / 16; ++i) vss::load_a<HC>(af[i], as, arow, 16 * i, lane);
      vss::wgmma_fence();
#pragma unroll
      for (int i = 0; i < HC / 16; ++i)
#pragma unroll
        for (int j = 0; j < NA; ++j) {
          const int atom = PIX2 ? j : wg + 2 * j;
          vss::wgmma_m64n64k16_rs<1>(
              acc[j], af[i], vss::wgmma_desc(w2a + atom * HC * 128 + i * 16 * 128, HC * 128,
                                             1024, 1));
        }
      vss::wgmma_commit();
      vss::wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < NA; ++j) vss::fence_regs(acc[j]);
    }
    __syncthreads();
    load_w2(ck + 1);
  }
  vss::cp_async_wait<0>();

  // ---- epilogue: the partial (split), or b2, the residual and bf16 --------
  if (!fc2_live) return;
  const long long M = (long long)p.B * H * W;
  long long mrow[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int pp = arow + g + hf * 8;
    const int r = pp / TW, c = pp - r * TW;
    mrow[hf] = pp < pout ? ((long long)f * H + i0 + r) * W + j0 + c : -1;
  }
  if (p.splits == 1) {
    // b2, the frame's scale, then the residual, into the accumulators: every
    // read before any store (the compiler cannot tell out from res and would
    // order each read after the stores before it)
    const float sc = p.scale != nullptr ? __ldg(p.scale + f) : 1.f;
#pragma unroll
    for (int j = 0; j < NA; ++j) {
      const int atom = PIX2 ? j : wg + 2 * j;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int n = atom * 64 + 8 * jj + 2 * t4;
        if (n >= C) continue;
        const float2 bv = __ldg(reinterpret_cast<const float2*>(p.b2 + n));
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float& v0 = acc[j][4 * jj + 2 * hf];
          float& v1 = acc[j][4 * jj + 2 * hf + 1];
          v0 += bv.x;
          v1 += bv.y;
          if (p.scale != nullptr) {
            v0 *= sc;
            v1 *= sc;
          }
          if (mrow[hf] < 0 || p.res_kind == 0) continue;
          const long long o = mrow[hf] * C + n;
          float2 rv;
          if (p.res_kind == 1)
            rv = __bfloat1622float2(
                __ldg(reinterpret_cast<const __nv_bfloat162*>(static_cast<const __nv_bfloat16*>(p.res) + o)));
          else
            rv = __ldg(reinterpret_cast<const float2*>(static_cast<const float*>(p.res) + o));
          v0 += rv.x;
          v1 += rv.y;
        }
      }
    }
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (mrow[hf] < 0) continue;
#pragma unroll
    for (int j = 0; j < NA; ++j) {
      const int atom = PIX2 ? j : wg + 2 * j;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int n = atom * 64 + 8 * jj + 2 * t4;
        if (n >= C) continue;
        const float v0 = acc[j][4 * jj + 2 * hf], v1 = acc[j][4 * jj + 2 * hf + 1];
        if (p.splits > 1)
          *reinterpret_cast<float2*>(static_cast<float*>(p.out) + (blockIdx.y * M + mrow[hf]) *
                                     C + n) = make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.out) +
                                             mrow[hf] * C + n) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// The split's second pass: out = bf16((((p_0 + p_1) + ... + p_{S-1}) + b2)·s
// + res), 8 channels a thread; s the frame's scale (rows_per_frame rows a
// frame), or none.
__global__ void __launch_bounds__(256) ffn_reduce_kernel(const float* __restrict__ part,
                                                         const float* __restrict__ b2,
                                                         const float* __restrict__ scale,
                                                         const void* res, int res_kind,
                                                         __nv_bfloat16* __restrict__ out,
                                                         long long M, int C, int S,
                                                         long long rows_per_frame) {
  const int c8 = C / 8;
  const long long total = M * c8;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const long long m = i / c8;
    const int n = (int)(i - m * c8) * 8;
    float v[8], w[8];
    vss::load8(part + m * C + n, v);
    for (int s = 1; s < S; ++s) {
      vss::load8(part + (s * M + m) * C + n, w);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] += w[e];
    }
    vss::load8(b2 + n, w);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] += w[e];
    if (scale != nullptr) {
      const float sc = scale[m / rows_per_frame];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] *= sc;
    }
    if (res_kind) {
      if (res_kind == 1)
        vss::load8(static_cast<const __nv_bfloat16*>(res) + m * C + n, w);
      else
        vss::load8(static_cast<const float*>(res) + m * C + n, w);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] += w[e];
    }
    vss::store8(out + m * C + n, v);
  }
}

template <int HC, int K>
int launch(const Args& a, int bytes, cudaStream_t st) {
  static bool attr = false;  // one instance per template: set its limit once
  if (!attr) {
    cudaError_t e = cudaFuncSetAttribute(ffn_fused_kernel<HC, K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  dim3 grid((unsigned)(a.B * a.tiles_h * a.tiles_w), (unsigned)a.splits);
  ffn_fused_kernel<HC, K><<<grid, THREADS, bytes, st>>>(a);
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

int smem_of(int rows, int cols, int c, int hc) {
  return layout(rup((rows + 2) * (cols + 2), 64), c, hc, cls_of(c)).total;
}

}  // namespace

// Shared memory (bytes) of one block of a rows x cols tile at width c with
// chunks of hc hidden channels.
VSS_EXPORT int ffn_fused_smem_bytes(int rows, int cols, int c, int hc) {
  return smem_of(rows, cols, c, hc);
}

// x (B, H, W, C) bf16 or f32 (x_f32); gamma, beta (C,) f32, or both null (no
// LayerNorm: fc1 reads x rounded to bf16); w1 (C, Ch) bf16;
// b1 (Ch,), kdw (9, Ch), bdw (Ch,) f32; w2 (Ch, C) bf16; b2 (C,) f32; scale
// (B,) f32, the branch's per-frame factor, or null; res
// (B·H·W, C): none (res_kind 0), bf16 (1) or f32 (2); out (B·H·W, C) bf16;
// part (splits, B·H·W, C) f32 when splits > 1, else unused. Tiles of rows x
// cols output pixels (at most the instance's 32·mtw), chunks of hc (32 or
// 64) hidden channels, splits runs of `chunks` chunks (each run non-empty).
// C, Ch multiples of 8, C <= 512, pointers 16-byte aligned (checked by the
// Python wrapper). One launch, or two with a split. Returns a cudaError_t.
VSS_EXPORT int ffn_fused(const void* x, const void* gamma, const void* beta, const void* w1,
                         const void* b1, const void* kdw, const void* bdw, const void* w2,
                         const void* b2, const void* scale, const void* res, void* out,
                         void* part, int B, int H,
                         int W, int C, int Ch, int x_f32, int res_kind, int rows, int cols,
                         int hc, int splits, int chunks, float eps, int device, void* stream) {
  vss::use_device(device);
  if (B == 0 || H == 0 || W == 0) return 0;
  const int nchunks = (Ch + hc - 1) / hc;
  const int bytes = smem_of(rows, cols, C, hc);
  if (C % 8 || Ch % 8 || C < 8 || C > 512 || Ch < 8 || H < 0 || W < 0 || rows < 1 ||
      cols < 1 || rows * cols > max_pixels_of(cls_of(C)) || (hc != 32 && hc != 64) ||
      splits < 1 || chunks < 1 || (long long)splits * chunks < nchunks ||
      (splits - 1) * chunks >= nchunks || (splits > 1 && part == nullptr) ||
      bytes > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  const int th = (H + rows - 1) / rows, tw = (W + cols - 1) / cols;
  Args a{x,
         static_cast<const float*>(gamma),
         static_cast<const float*>(beta),
         static_cast<const __nv_bfloat16*>(w1),
         static_cast<const float*>(b1),
         static_cast<const float*>(kdw),
         static_cast<const float*>(bdw),
         static_cast<const __nv_bfloat16*>(w2),
         static_cast<const float*>(b2),
         static_cast<const float*>(scale),
         res,
         splits > 1 ? part : out,
         B, H, W, C, Ch, x_f32, res_kind, rows, cols, th, tw,
         rup((rows + 2) * (cols + 2), 64), chunks, splits, eps};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int rc = hc == 64 ? launch_hc<64>(a, bytes, st) : launch_hc<32>(a, bytes, st);
  if (rc != 0 || splits == 1) return rc;
  const long long M = (long long)B * H * W;
  const long long n8 = M * (C / 8);
  const long long want = (n8 + 255) / 256;
  const unsigned blocks = (unsigned)(want < 132LL * 16 ? want : 132LL * 16);
  ffn_reduce_kernel<<<blocks, 256, 0, st>>>(static_cast<const float*>(part),
                                            static_cast<const float*>(b2),
                                            static_cast<const float*>(scale), res, res_kind,
                                            static_cast<__nv_bfloat16*>(out), M, C, splits,
                                            (long long)H * W);
  return (int)cudaGetLastError();
}
