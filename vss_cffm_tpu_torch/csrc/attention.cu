// Multi-head attention forward with an optional additive bias and mask:
// scores in registers, K and V in shared memory.
//
// Replaces the TPU kernel vss_cffm_tpu/ops/cfm_attention.py:
// _cfm_attention_pallas_impl (_fwd_kernel): the CFM window attention of every
// CFFM decoder block, (q*scale)·Kᵀ over the concatenated K/V source groups
// + relative-position bias (nh, Lq, N) + window mask (G, N), f32 softmax,
// P·V. With a probabilities pointer it also writes the normalised softmax p
// (G, nh, Lq, N) in f32 or bf16, the same values that are rounded to bf16
// for P·V (the TPU kernel's with_probs call, whose p the backward from
// probabilities reads). The same routine serves the spatial-reduction
// attention inside the whole-block path (ops/stage_block.py), with the scale
// folded into K and no bias or mask.
//
// Bound on the H100: neither bytes nor tensor ops at the CFM shapes (q
// (nW, 49, 256), K/V (nW, 289, 256), 8 heads of 32): a (window, head) holds
// ~0.6 MFLOP of products against ~40 KB of K/V, so what limits the kernel
// is latency, and the lever is the number of blocks in flight.
// Design: one block of 4 warps per (64 query rows, head, group), each warp
// owning 16 query rows, whose q fragments (scaled and rounded to bf16 like
// the reference) it loads once into registers. Shared memory holds only the
// group's K and V head slices (N padded to 16 with zero rows, chunks
// XOR-swizzled for conflict-free ldmatrix), staged with cp.async in two
// groups so that the first pass starts when K has landed: 38 KB at head dim
// 32 and N 289, and launch bounds that hold a thread to 96 registers, so 5
// blocks share an SM (the SM's carveout set to its largest). Scores live in
// registers: mma.sync m16n8k16 tiles of 16 keys, bias and mask read from
// global memory (L2) straight into the accumulator layout, one step ahead of
// their use, (S + bias) + mask in f32. Two passes over the key tiles: the
// first keeps each row's running max and sum of exps, the second recomputes
// S, forms the normalised p = exp(s - max) / sum, packs it to bf16 A
// fragments in registers (the accumulator layout of two n-blocks is the A
// operand layout) and multiplies by V fragments read with ldmatrix.trans,
// accumulating out in f32. When p is asked for, it goes through a (16, 64)
// f32 tile per warp in shared memory and out row by row, 32 lanes on
// consecutive addresses (18 KB more: 4 blocks per SM then). So the
// reference's rounding points stay: bf16(normalised p), f32 P·V, one bf16
// cast; e = expf(s - max) and p = e / sum rounded as the `/` operator rounds
// it, from a reciprocal of the sum taken once per row and two corrections
// (vss::div_rn: the operator's branch to its slow path made the kernel 1.5x
// slower). wgmma is not
// used: at head dim 32 and 49 queries the products are not the limit, and
// 64-row warpgroup tiles would only add padding.
//
// Key-tiled instance (attention_fwd_tiled): for N whose K and V do not fit
// one block's shared memory (multi-scale test-time augmentation gives the
// MiT stages 920-1269 keys at head dim 64; the resident instance stops at
// 896). The same block, warps, q fragments and 16-key steps, but K and V
// stream through a two-stage ring of 64-key tiles (cp.async, the next tile
// in flight while this one is used): pass 1 reads the K tiles for each
// row's running max and sum of exps in f32, pass 2 reads the K and V tiles
// again for the normalised p and P·V. Every step computes what the resident
// instance computes, in the same order, so the two give the same bits where
// both run. No probabilities output.
#include "common.cuh"
#include "mma_sync.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 16 * kWarps;  // query rows per block

__host__ __device__ inline int round16(int n) { return (n + 15) / 16 * 16; }

// rows of a warp's p staging tile: 64 f32 columns, padded to 72 so that the
// float2 stores of the accumulator layout meet no bank twice
constexpr int kPStride = 72;

// dynamic shared memory of one block: K and V, (round16(N), HD) bf16 each,
// and with probabilities a (16, 64) f32 staging tile per warp
__host__ __device__ inline size_t smem_bytes(int N, int hd, bool probs) {
  return (size_t)round16(N) * hd * 2 * 2 + (probs ? (size_t)kWarps * 16 * kPStride * 4 : 0);
}

// q[row, col..col+1] of this (group, head) scaled and rounded to bf16 as the
// reference rounds q·scale, packed; zero past the last row
__device__ __forceinline__ uint32_t q_pair(const __nv_bfloat16* qg, int row, int Lq, int C,
                                           int col, float s) {
  if (row >= Lq) return 0u;
  const uint32_t u = *reinterpret_cast<const uint32_t*>(qg + (long long)row * C + col);
  if (s == 1.f) return u;
  const float2 f = vss::unpack_bf16(u);
  return vss::pack_bf16(f.x * s, f.y * s);
}

// Step n0's bias and mask into b, m (loaded one step earlier into bn, mn),
// and step n0 + 16's requested into bn, mn: the L2 latency overlaps a step's
// math. Nothing without bias and mask (BM false).
template <bool BM>
__device__ __forceinline__ void next_bias_mask(float (&b)[8], float (&m)[4], float (&bn)[8],
                                               float (&mn)[4], const float* b_lo,
                                               const float* b_hi, const float* mrow, int n0,
                                               int t2, int N) {
  if constexpr (BM) {
#pragma unroll
    for (int i = 0; i < 8; ++i) b[i] = bn[i];
#pragma unroll
    for (int i = 0; i < 4; ++i) m[i] = mn[i];
    vss::load_bias(bn, b_lo, b_hi, n0 + 16, t2, N);
    vss::load_mask(mn, mrow, n0 + 16, t2, N);
  }
}

template <int HD, bool BM>
__global__ void __launch_bounds__(32 * kWarps, HD == 32 ? 5 : 3) attention_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
    const float* __restrict__ mask, __nv_bfloat16* __restrict__ out, void* __restrict__ probs,
    int probs_bf16, int Lq, int N, int C, float q_scale, float k_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int CH = HD / 8;  // 16-byte chunks per head row
  const int Np = round16(N);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + Np * HD;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.y;
  const long long g = blockIdx.z;
  const int t2 = (lane & 3) * 2;

  // ---- K, then V, in flight as two cp.async groups; zero rows pad to Np -----
  const __nv_bfloat16* kg = k + g * N * C + h * HD;
  const __nv_bfloat16* vg = v + g * N * C + h * HD;
  for (int c = tid; c < Np * CH; c += blockDim.x) {
    const int n = c / CH, d = (c % CH) * 8;
    if (n < N)
      vss::cp_async16(Ks + vss::swz<HD>(n, d), kg + (long long)n * C + d);
    else
      vss::zero16(Ks + vss::swz<HD>(n, d));
  }
  vss::cp_async_commit();
  for (int c = tid; c < Np * CH; c += blockDim.x) {
    const int n = c / CH, d = (c % CH) * 8;
    if (n < N)
      vss::cp_async16(Vs + vss::swz<HD>(n, d), vg + (long long)n * C + d);
    else
      vss::zero16(Vs + vss::swz<HD>(n, d));
  }
  vss::cp_async_commit();

  // ---- this warp's q fragments, scaled and rounded, in registers -----------
  const int r_lo = blockIdx.x * kRows + warp * 16 + (lane >> 2), r_hi = r_lo + 8;
  const __nv_bfloat16* qg = q + g * Lq * C + h * HD;
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    qa[kk][0] = q_pair(qg, r_lo, Lq, C, kk * 16 + t2, q_scale);
    qa[kk][1] = q_pair(qg, r_hi, Lq, C, kk * 16 + t2, q_scale);
    qa[kk][2] = q_pair(qg, r_lo, Lq, C, kk * 16 + 8 + t2, q_scale);
    qa[kk][3] = q_pair(qg, r_hi, Lq, C, kk * 16 + 8 + t2, q_scale);
  }
  // bias rows (rows past Lq read the last row: finite, never written) and mask
  const float* b_lo = BM ? bias + ((long long)h * Lq + min(r_lo, Lq - 1)) * N : nullptr;
  const float* b_hi = BM ? bias + ((long long)h * Lq + min(r_hi, Lq - 1)) * N : nullptr;
  const float* mrow = BM ? mask + g * N : nullptr;

  vss::cp_async_wait<1>();  // K has landed
  __syncthreads();
  if (k_scale != 1.f) {  // K·scale rounded to bf16, as the reference (block path)
    for (int c = tid; c < N * CH; c += blockDim.x) {
      __nv_bfloat16* p = Ks + vss::swz<HD>(c / CH, (c % CH) * 8);
      float f[8];
      vss::load8(p, f);
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = f[i] * k_scale;
      vss::store8(p, f);
    }
    __syncthreads();
  }

  // ---- pass 1: each row's max and sum of exps (running, rescaled) ----------
  float mx[2] = {-3.402823466e38f, -3.402823466e38f}, sm[2] = {0.f, 0.f};
  float b[8] = {}, m[4] = {}, bn[8] = {}, mn[4] = {};
  if constexpr (BM) {
    vss::load_bias(bn, b_lo, b_hi, 0, t2, N);
    vss::load_mask(mn, mrow, 0, t2, N);
  }
  for (int n0 = 0; n0 < Np; n0 += 16) {
    float s[2][4];
    next_bias_mask<BM>(b, m, bn, mn, b_lo, b_hi, mrow, n0, t2, N);
    vss::mma_xt<HD>(s, qa, Ks, n0, lane);
    vss::add_bias_mask<BM>(s, b, m, n0, t2, N);
    vss::softmax_step(mx, sm, s);
  }
  vss::softmax_rows(mx, sm);
  const float inv[2] = {vss::recip(sm[0]), vss::recip(sm[1])};

  // ---- pass 2: p = exp(s - max) / sum, p written if asked, out += bf16(p) V -
  vss::cp_async_wait<0>();  // V has landed
  __syncthreads();
  float o[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  // p of this warp's first row in probs (G, nh, Lq, N), and its staging tile
  const int row_w = blockIdx.x * kRows + warp * 16;
  const long long p_w = ((g * gridDim.y + h) * Lq + row_w) * (long long)N;
  float* Pw = reinterpret_cast<float*>(Vs + Np * HD) + warp * 16 * kPStride;
  if constexpr (BM) {
    vss::load_bias(bn, b_lo, b_hi, 0, t2, N);
    vss::load_mask(mn, mrow, 0, t2, N);
  }
  for (int n0 = 0; n0 < Np; n0 += 16) {
    float s[2][4];
    next_bias_mask<BM>(b, m, bn, mn, b_lo, b_hi, mrow, n0, t2, N);
    vss::mma_xt<HD>(s, qa, Ks, n0, lane);
    vss::add_bias_mask<BM>(s, b, m, n0, t2, N);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = vss::div_rn(expf(s[j][e] - mx[e >> 1]), sm[e >> 1], inv[e >> 1]);
    if (probs != nullptr) {
      // p into the warp's staging tile; each 64 keys (or the last step) go
      // out row by row, 32 lanes on consecutive addresses
      const int c0 = n0 & 63;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = c0 + 8 * j + t2;
        *reinterpret_cast<float2*>(Pw + (lane >> 2) * kPStride + c) =
            make_float2(s[j][0], s[j][1]);
        *reinterpret_cast<float2*>(Pw + ((lane >> 2) + 8) * kPStride + c) =
            make_float2(s[j][2], s[j][3]);
      }
      if (c0 == 48 || n0 + 16 == Np) {
        __syncwarp();
        const int t0 = n0 - c0, width = min(c0 + 16, N - t0);
        for (int r = 0; r < 16 && row_w + r < Lq; ++r) {
          const long long base = p_w + (long long)r * N + t0;
          for (int c = lane; c < width; c += 32) {
            if (probs_bf16)
              static_cast<__nv_bfloat16*>(probs)[base + c] =
                  __float2bfloat16_rn(Pw[r * kPStride + c]);
            else
              static_cast<float*>(probs)[base + c] = Pw[r * kPStride + c];
          }
        }
        __syncwarp();
      }
    }
    const uint32_t a[4] = {vss::pack_bf16(s[0][0], s[0][1]), vss::pack_bf16(s[0][2], s[0][3]),
                           vss::pack_bf16(s[1][0], s[1][1]), vss::pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int d = 0; d < HD; d += 16) {
      uint32_t b[4];
      vss::load_b<HD>(b, Vs, n0, d, lane);
      vss::mma16816(o[d / 8], a, b[0], b[1]);
      vss::mma16816(o[d / 8 + 1], a, b[2], b[3]);
    }
  }

  // ---- out rows, one bf16 cast ---------------------------------------------
  __nv_bfloat16* og = out + g * Lq * C + h * HD;
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    if (r_lo < Lq)
      *reinterpret_cast<uint32_t*>(og + (long long)r_lo * C + d * 8 + t2) =
          vss::pack_bf16(o[d][0], o[d][1]);
    if (r_hi < Lq)
      *reinterpret_cast<uint32_t*>(og + (long long)r_hi * C + d * 8 + t2) =
          vss::pack_bf16(o[d][2], o[d][3]);
  }
}

// ---- the key-tiled instance -------------------------------------------------

constexpr int kTileKeys = 64;  // keys of one K or V tile

// dynamic shared memory of the key-tiled instance: two stages of a K and a V
// tile, (64, HD) bf16 each
__host__ __device__ inline size_t tiled_smem_bytes(int hd) {
  return (size_t)2 * 2 * kTileKeys * hd * 2;
}

// Keys [t0, t0 + 64) of one (group, head) slice into a swizzled tile, as
// cp.async copies; the rows from N up to the step grid (round16(N)) zeroed
template <int HD>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           int t0, int N, int C, int tid) {
  constexpr int CH = HD / 8;
  const int rows = min(kTileKeys, round16(N) - t0);
  for (int c = tid; c < rows * CH; c += 32 * kWarps) {
    const int r = c / CH, d = (c % CH) * 8, n = t0 + r;
    if (n < N)
      vss::cp_async16(dst + vss::swz<HD>(r, d), src + (long long)n * C + d);
    else
      vss::zero16(dst + vss::swz<HD>(r, d));
  }
}

// K·scale rounded to bf16 in a landed tile, as the resident instance scales
// its K (the block path folds the attention scale into K)
template <int HD>
__device__ __forceinline__ void scale_tile(__nv_bfloat16* Ks, int rows, float k_scale,
                                           int tid) {
  constexpr int CH = HD / 8;
  for (int c = tid; c < rows * CH; c += 32 * kWarps) {
    __nv_bfloat16* p = Ks + vss::swz<HD>(c / CH, (c % CH) * 8);
    float f[8];
    vss::load8(p, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = f[i] * k_scale;
    vss::store8(p, f);
  }
}

template <int HD, bool BM>
__global__ void __launch_bounds__(32 * kWarps, HD == 32 ? 5 : 3) attention_fwd_tiled_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
    const float* __restrict__ mask, __nv_bfloat16* __restrict__ out, int Lq, int N, int C,
    float q_scale, float k_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int TILE = kTileKeys * HD;  // elements of one tile
  __nv_bfloat16* Kb = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][TILE]
  __nv_bfloat16* Vb = Kb + 2 * TILE;                            // [2][TILE]
  const int Np = round16(N), nt = (Np + kTileKeys - 1) / kTileKeys;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.y;
  const long long g = blockIdx.z;
  const int t2 = (lane & 3) * 2;
  const __nv_bfloat16* kg = k + g * N * C + h * HD;
  const __nv_bfloat16* vg = v + g * N * C + h * HD;

  stage_tile<HD>(Kb, kg, 0, N, C, tid);
  vss::cp_async_commit();

  const int r_lo = blockIdx.x * kRows + warp * 16 + (lane >> 2), r_hi = r_lo + 8;
  const __nv_bfloat16* qg = q + g * Lq * C + h * HD;
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    qa[kk][0] = q_pair(qg, r_lo, Lq, C, kk * 16 + t2, q_scale);
    qa[kk][1] = q_pair(qg, r_hi, Lq, C, kk * 16 + t2, q_scale);
    qa[kk][2] = q_pair(qg, r_lo, Lq, C, kk * 16 + 8 + t2, q_scale);
    qa[kk][3] = q_pair(qg, r_hi, Lq, C, kk * 16 + 8 + t2, q_scale);
  }
  const float* b_lo = BM ? bias + ((long long)h * Lq + min(r_lo, Lq - 1)) * N : nullptr;
  const float* b_hi = BM ? bias + ((long long)h * Lq + min(r_hi, Lq - 1)) * N : nullptr;
  const float* mrow = BM ? mask + g * N : nullptr;

  // ---- pass 1: the K tiles; each row's max and sum of exps -----------------
  float mx[2] = {-3.402823466e38f, -3.402823466e38f}, sm[2] = {0.f, 0.f};
  float b[8] = {}, m[4] = {}, bn[8] = {}, mn[4] = {};
  if constexpr (BM) {
    vss::load_bias(bn, b_lo, b_hi, 0, t2, N);
    vss::load_mask(mn, mrow, 0, t2, N);
  }
  for (int t = 0; t < nt; ++t) {
    const int t0 = t * kTileKeys, t1 = min(t0 + kTileKeys, Np);
    if (t + 1 < nt) {  // the next tile into the other stage, freed by the last barrier
      stage_tile<HD>(Kb + ((t + 1) & 1) * TILE, kg, t0 + kTileKeys, N, C, tid);
      vss::cp_async_commit();
      vss::cp_async_wait<1>();
    } else {
      vss::cp_async_wait<0>();
    }
    __syncthreads();
    __nv_bfloat16* Ks = Kb + (t & 1) * TILE;
    if (k_scale != 1.f) {
      scale_tile<HD>(Ks, t1 - t0, k_scale, tid);
      __syncthreads();
    }
    for (int n0 = t0; n0 < t1; n0 += 16) {
      float s[2][4];
      next_bias_mask<BM>(b, m, bn, mn, b_lo, b_hi, mrow, n0, t2, N);
      vss::mma_xt<HD>(s, qa, Ks, n0 - t0, lane);
      vss::add_bias_mask<BM>(s, b, m, n0, t2, N);
      vss::softmax_step(mx, sm, s);
    }
    __syncthreads();  // every warp is done with this stage
  }
  vss::softmax_rows(mx, sm);
  const float inv[2] = {vss::recip(sm[0]), vss::recip(sm[1])};

  // ---- pass 2: the K and V tiles; out += bf16(exp(s - max) / sum) V ---------
  float o[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  if constexpr (BM) {
    vss::load_bias(bn, b_lo, b_hi, 0, t2, N);
    vss::load_mask(mn, mrow, 0, t2, N);
  }
  stage_tile<HD>(Kb, kg, 0, N, C, tid);
  stage_tile<HD>(Vb, vg, 0, N, C, tid);
  vss::cp_async_commit();
  for (int t = 0; t < nt; ++t) {
    const int t0 = t * kTileKeys, t1 = min(t0 + kTileKeys, Np);
    if (t + 1 < nt) {
      stage_tile<HD>(Kb + ((t + 1) & 1) * TILE, kg, t0 + kTileKeys, N, C, tid);
      stage_tile<HD>(Vb + ((t + 1) & 1) * TILE, vg, t0 + kTileKeys, N, C, tid);
      vss::cp_async_commit();
      vss::cp_async_wait<1>();
    } else {
      vss::cp_async_wait<0>();
    }
    __syncthreads();
    __nv_bfloat16* Ks = Kb + (t & 1) * TILE;
    const __nv_bfloat16* Vs = Vb + (t & 1) * TILE;
    if (k_scale != 1.f) {
      scale_tile<HD>(Ks, t1 - t0, k_scale, tid);
      __syncthreads();
    }
    for (int n0 = t0; n0 < t1; n0 += 16) {
      float s[2][4];
      next_bias_mask<BM>(b, m, bn, mn, b_lo, b_hi, mrow, n0, t2, N);
      vss::mma_xt<HD>(s, qa, Ks, n0 - t0, lane);
      vss::add_bias_mask<BM>(s, b, m, n0, t2, N);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = vss::div_rn(expf(s[j][e] - mx[e >> 1]), sm[e >> 1], inv[e >> 1]);
      const uint32_t a[4] = {vss::pack_bf16(s[0][0], s[0][1]), vss::pack_bf16(s[0][2], s[0][3]),
                             vss::pack_bf16(s[1][0], s[1][1]), vss::pack_bf16(s[1][2], s[1][3])};
#pragma unroll
      for (int d = 0; d < HD; d += 16) {
        uint32_t bv[4];
        vss::load_b<HD>(bv, Vs, n0 - t0, d, lane);
        vss::mma16816(o[d / 8], a, bv[0], bv[1]);
        vss::mma16816(o[d / 8 + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();
  }

  __nv_bfloat16* og = out + g * Lq * C + h * HD;
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    if (r_lo < Lq)
      *reinterpret_cast<uint32_t*>(og + (long long)r_lo * C + d * 8 + t2) =
          vss::pack_bf16(o[d][0], o[d][1]);
    if (r_hi < Lq)
      *reinterpret_cast<uint32_t*>(og + (long long)r_hi * C + d * 8 + t2) =
          vss::pack_bf16(o[d][2], o[d][3]);
  }
}

template <int HD, bool BM>
int launch_tiled(const void* q, const void* k, const void* v, const void* bias,
                 const void* mask, void* out, int G, int Lq, int N, int nh, int C,
                 float q_scale, float k_scale, cudaStream_t s) {
  const size_t bytes = tiled_smem_bytes(HD);
  cudaError_t e = cudaFuncSetAttribute(attention_fwd_tiled_kernel<HD, BM>,
                                       cudaFuncAttributePreferredSharedMemoryCarveout,
                                       cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Lq + kRows - 1) / kRows, nh, G);
  attention_fwd_tiled_kernel<HD, BM><<<grid, 32 * kWarps, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<__nv_bfloat16*>(out), Lq, N, C, q_scale,
      k_scale);
  return (int)cudaGetLastError();
}

// the kernel's shared memory, and the largest carveout of the SM for it, so
// that as many blocks as the occupancy calculator counts share an SM
template <int HD, bool BM>
cudaError_t prepare(size_t bytes) {
  cudaError_t e = cudaFuncSetAttribute(attention_fwd_kernel<HD, BM>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(attention_fwd_kernel<HD, BM>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int HD, bool BM>
int launch(const void* q, const void* k, const void* v, const void* bias, const void* mask,
           void* out, void* probs, int probs_bf16, int G, int Lq, int N, int nh, int C,
           float q_scale, float k_scale, cudaStream_t s) {
  const size_t bytes = smem_bytes(N, HD, probs != nullptr);
  cudaError_t e = prepare<HD, BM>(bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Lq + kRows - 1) / kRows, nh, G);
  attention_fwd_kernel<HD, BM><<<grid, 32 * kWarps, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<__nv_bfloat16*>(out), probs, probs_bf16, Lq,
      N, C, q_scale, k_scale);
  return (int)cudaGetLastError();
}

template <int HD, bool BM>
int blocks_per_sm(int N, bool probs) {
  const size_t bytes = smem_bytes(N, HD, probs);
  cudaError_t e = prepare<HD, BM>(bytes);
  if (e != cudaSuccess) return -(int)e;
  int n = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, attention_fwd_kernel<HD, BM>,
                                                    32 * kWarps, bytes);
  return e == cudaSuccess ? n : -(int)e;
}

// q[i] = a[i] / b[i] by the kernels' division (vss::div_rn) and q_ref[i] by
// the `/` operator, for the card test that holds one to the other
__global__ void div_check_kernel(const float* a, const float* b, float* q, float* q_ref,
                                 int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    q[i] = vss::div_rn(a[i], b[i], vss::recip(b[i]));
    q_ref[i] = a[i] / b[i];
  }
}

}  // namespace

// q/out (G, Lq, C) bf16, k/v (G, N, C) bf16 with C = nh*hd (head h owns
// channels [h*hd, (h+1)*hd)); bias (nh, Lq, N) f32 and mask (G, N) f32, both
// or neither; probs (G, nh, Lq, N), bf16 when probs_bf16 else f32, or null.
// hd in {32, 64}, the head dims of every MiT-B* stage and CFFM decoder; K
// and V of one (group, head) must fit one block's shared memory. Returns a
// cudaError_t.
VSS_EXPORT int attention_fwd(const void* q, const void* k, const void* v, const void* bias,
                             const void* mask, void* out, void* probs, int probs_bf16, int G,
                             int Lq, int N, int nh, int hd, int C, float q_scale,
                             float k_scale, int device, void* stream) {
  vss::use_device(device);
  if (G == 0 || Lq == 0) return 0;
  if (N < 1 || (bias == nullptr) != (mask == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define VSS_FWD(HD, BM) \
  return launch<HD, BM>(q, k, v, bias, mask, out, probs, probs_bf16, G, Lq, N, nh, C, q_scale, k_scale, s)
  if (hd == 32 && bias) VSS_FWD(32, true);
  if (hd == 32) VSS_FWD(32, false);
  if (hd == 64 && bias) VSS_FWD(64, true);
  if (hd == 64) VSS_FWD(64, false);
#undef VSS_FWD
  return (int)cudaErrorInvalidValue;
}

// The key-tiled instance: the arguments of attention_fwd without the
// probabilities; any N >= 1, K and V streamed through shared memory in 64-key
// tiles. Returns a cudaError_t.
VSS_EXPORT int attention_fwd_tiled(const void* q, const void* k, const void* v,
                                   const void* bias, const void* mask, void* out, int G, int Lq,
                                   int N, int nh, int hd, int C, float q_scale, float k_scale,
                                   int device, void* stream) {
  vss::use_device(device);
  if (G == 0 || Lq == 0) return 0;
  if (N < 1 || (bias == nullptr) != (mask == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define VSS_FWD(HD, BM) \
  return launch_tiled<HD, BM>(q, k, v, bias, mask, out, G, Lq, N, nh, C, q_scale, k_scale, s)
  if (hd == 32 && bias) VSS_FWD(32, true);
  if (hd == 32) VSS_FWD(32, false);
  if (hd == 64 && bias) VSS_FWD(64, true);
  if (hd == 64) VSS_FWD(64, false);
#undef VSS_FWD
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one block of the key-tiled instance at head dim hd.
VSS_EXPORT int attention_fwd_tiled_smem_bytes(int hd) { return (int)tiled_smem_bytes(hd); }

// Dynamic shared memory of one block at N keys and head dim hd, writing
// probabilities or not: the wrapper's gate against the card's limit.
VSS_EXPORT int attention_fwd_smem_bytes(int N, int hd, int with_probs) {
  return (int)smem_bytes(N, hd, with_probs != 0);
}

// Blocks of the kernel one SM holds at N keys and head dim hd, with bias and
// mask or without, writing probabilities or not
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); minus a cudaError_t on
// failure.
VSS_EXPORT int attention_fwd_blocks_per_sm(int N, int hd, int with_bias, int with_probs,
                                           int device) {
  vss::use_device(device);
  if (N < 1) return -(int)cudaErrorInvalidValue;
  const bool p = with_probs != 0;
  if (hd == 32) return with_bias ? blocks_per_sm<32, true>(N, p) : blocks_per_sm<32, false>(N, p);
  if (hd == 64) return with_bias ? blocks_per_sm<64, true>(N, p) : blocks_per_sm<64, false>(N, p);
  return -(int)cudaErrorInvalidValue;
}

// The softmax's division two ways over n pairs (a, b on the device): the
// kernels' and the `/` operator's. Returns a cudaError_t.
VSS_EXPORT int attention_div_check(const void* a, const void* b, void* q, void* q_ref, int n,
                                   int device, void* stream) {
  vss::use_device(device);
  if (n <= 0) return 0;
  div_check_kernel<<<(n + 255) / 256, 256, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(q),
      static_cast<float*>(q_ref), n);
  return (int)cudaGetLastError();
}
