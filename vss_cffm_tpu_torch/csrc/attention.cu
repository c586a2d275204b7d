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
// Key-tiled instance (attention_fwd_tiled, attention_fwd_tiled_kernel): row
// 1's attention step (vss_cffm_tpu/ops/stage_block.py, _kernel of
// mit_block_fused, :117-131) at the key counts that multi-scale test-time
// augmentation gives the MiT stages (920 keys at 1.5x, 1269 at 1.75x, up to
// the fused block's 2048), where K and V of a (group, head) do not fit one
// block's shared memory (the resident instance stops at 896 keys at head dim
// 64). Bound: the reference rounds the normalised p to bf16 before P·V, so p
// needs each row's final max and sum, and the kernel makes two passes over
// the keys: 1.5x the tensor work of one pass (q·Kᵀ twice, P·V once) and
// about 2.25 exps a score (the statistics rescale once every 16 keys), which
// at N 1269 on stage 3 puts a floor of about 70 us on the special-function
// units. Design: K arrives scaled (the wrapper scales it once, as the JAX
// block does outside its kernel). A block is 128 query rows of one (group,
// head): two consumer warpgroups of 64 rows share every K and V tile, and a
// producer warp streams the tiles by TMA (3-d tensor maps over (G, N, C),
// boxes of 64 keys, rows past N zero-filled, 128- or 64-byte swizzle) through
// a ring of kStages stages, each with a full and an empty mbarrier (pass 1:
// K; pass 2: K and V); no block barrier in the key loops. S = q·Kᵀ is wgmma
// m64n64k16 with q in registers (scaled and rounded as q_pair rounds it) and
// the K tile K-major in shared memory; P·V is wgmma m64n{hd}k16 with p packed
// from the accumulators to bf16 A fragments and the V tile MN-major. The next
// tile's S product is started before this tile's exps, so that the tensor
// cores run while the exps do. The order of arithmetic is the resident
// instance's: statistics per 16-key group in key order (softmax_step, then
// softmax_rows across the quad), p = div_rn(expf(s - max), sum), P·V summed
// in f32 per 16-key step in key order; so the two give the same bits where
// both run, as long as wgmma's and mma.sync's products of 16 keys round
// alike (mma_check_kernel holds the one against the other). No
// probabilities output.
#include <type_traits>

#include "common.cuh"
#include "mma_sync.cuh"
#include "tma_wgmma.cuh"

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

constexpr int kTileKeys = 64;    // keys of one K or V tile
constexpr int kStages = 4;       // ring stages (a consumer holds up to three)
constexpr int kConsumerWGs = 2;  // warpgroups of 64 query rows
constexpr int kTiledRows = 64 * kConsumerWGs;
constexpr int kTiledThreads = 128 * (kConsumerWGs + 1);  // and one producer warpgroup
// registers a thread after setmaxnreg: the producer's go to the consumers
// (65,536 an SM: 128 * (24 + 2 * 240) = 64,512 at most)
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kTiledBlocksPerSM = 1;

__host__ __device__ constexpr int tile_bytes(int hd) { return kTileKeys * hd * 2; }

// dynamic shared memory of the key-tiled instance: the K ring and the V ring
// (kStages tiles of (64, hd) bf16 each, every tile on a 1024-byte boundary),
// a full and an empty mbarrier a stage, and 1024 bytes to align the base
__host__ __device__ constexpr size_t tiled_smem_bytes(int hd) {
  return (size_t)2 * kStages * tile_bytes(hd) + 2 * kStages * 8 + 1024;
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

// S (64 rows x one 64-key tile, f32) += q Kᵀ (s zeroed by the caller) with
// q's A fragments in registers and the K tile K-major at k_tile in shared
// memory: started and committed, not waited for
template <int HD>
__device__ __forceinline__ void start_scores(float (&s)[32], const uint32_t (&qa)[HD / 16][4],
                                             uint32_t k_tile) {
  constexpr uint32_t swz = HD == 64 ? 1 : 2;  // 128- or 64-byte swizzle
  vss::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)  // k-steps of 16 head channels: 32 bytes of a row
    vss::wgmma_m64n64k16_rs<0>(s, qa[kk], vss::wgmma_desc(k_tile + kk * 32, 16, 16 * HD, swz));
  vss::wgmma_commit();
}

// out (64 x HD, f32) += p (64 x 16 keys, bf16 A fragments) V (16 x HD), V
// MN-major at v_rows (16 rows of the tile) in shared memory
template <int HD>
__device__ __forceinline__ void mma_pv(float (&o)[HD / 2], const uint32_t (&pa)[4],
                                       uint32_t v_rows) {
  constexpr uint32_t swz = HD == 64 ? 1 : 2;
  const uint64_t d = vss::wgmma_desc(v_rows, tile_bytes(HD), 16 * HD, swz);
  if constexpr (HD == 64)
    vss::wgmma_m64n64k16_rs<1>(o, pa, d);
  else
    vss::wgmma_m64n32k16_rs<1>(o, pa, d);
}

// The scores of 16-key group i of a tile, as the resident instance holds a
// 16-key step: n-blocks 2i and 2i + 1 of the accumulator
__device__ __forceinline__ void group_scores(float (&sg)[2][4], const float (&s)[32], int i) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sg[j][e] = s[8 * i + 4 * j + e];
}

// One block: 128 query rows of one (group, head). Warps 0-7 are two consumer
// warpgroups of 64 rows; warpgroup 2 is the producer, one thread of which
// streams the tiles by TMA: pass 1's K tiles, then pass 2's K and V tiles,
// 2 nt entries of a kStages ring, each stage with a full barrier (the copy's
// bytes) and an empty one (one arrival per consumer warp). The producer
// warpgroup gives its registers to the consumers (setmaxnreg): with one
// producer warp and no setmaxnreg (288 threads, 224 registers a thread at
// most) ptxas serialised the consumers' wgmma for want of registers, and
// setmaxnreg in a warpgroup of one warp never returned.
template <int HD, bool BM>
__global__ void __launch_bounds__(kTiledThreads, kTiledBlocksPerSM) attention_fwd_tiled_kernel(
    const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
    const __nv_bfloat16* __restrict__ q, const float* __restrict__ bias,
    const float* __restrict__ mask, __nv_bfloat16* __restrict__ out, int Lq, int N, int C,
    float q_scale) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  constexpr int TILE = tile_bytes(HD);
  unsigned char* smem = smem_raw + ((1024 - (vss::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + 2 * kStages * TILE);
  uint64_t* empty = full + kStages;
  const int Np = round16(N), nt = (N + kTileKeys - 1) / kTileKeys;
  const int tid = threadIdx.x, h = blockIdx.y, g = blockIdx.z;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      vss::mbar_init(&full[s], 1);
      vss::mbar_init(&empty[s], 4 * kConsumerWGs);
    }
    vss::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 128 * kConsumerWGs) {  // ---- the producer ------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 128 * kConsumerWGs) {
      for (int i = 0; i < 2 * nt; ++i) {
        const int s = i % kStages, t = i < nt ? i : i - nt;
        vss::mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);  // round 0 passes at once
        vss::mbar_expect_tx(&full[s], i < nt ? TILE : 2 * TILE);
        vss::tma_load_3d(smem + s * TILE, &kmap, &full[s], h * HD, t * kTileKeys, g);
        if (i >= nt)
          vss::tma_load_3d(smem + (kStages + s) * TILE, &vmap, &full[s], h * HD,
                           t * kTileKeys, g);
      }
    }
    return;
  }

  // ---- the consumers: this thread's two rows, q fragments in registers -----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int lane = tid & 31, t2 = (lane & 3) * 2;
  const int r_lo = blockIdx.x * kTiledRows + (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int r_hi = r_lo + 8;
  const __nv_bfloat16* qg = q + (long long)g * Lq * C + h * HD;
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
  const float* mrow = BM ? mask + (long long)g * N : nullptr;
  const uint32_t kring = vss::smem_addr(smem), vring = kring + kStages * TILE;
  auto wait_full = [&](int i) { vss::mbar_wait(&full[i % kStages], (i / kStages) & 1); };

  auto release = [&](int i) {  // this warp is done with ring entry i
    __syncwarp();
    if (lane == 0) vss::mbar_arrive(&empty[i % kStages]);
  };

  float mx[2] = {-3.402823466e38f, -3.402823466e38f}, sm[2] = {0.f, 0.f}, inv[2];
  float b[8] = {}, m[4] = {}, bn[8] = {}, mn[4] = {};
  if constexpr (BM) {
    vss::load_bias(bn, b_lo, b_hi, 0, t2, N);
    vss::load_mask(mn, mrow, 0, t2, N);
  }

  // The statistics of one tile's scores, 16-key group by group, as the
  // resident instance takes its steps (keys below round16(N)); FULL (a tile
  // of 64 keys below N, no bias): no guard, so that the groups interleave
  auto stats = [&](int t, const float (&s)[32], auto full) {
    constexpr bool FULL = decltype(full)::value;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n0 = t * kTileKeys + 16 * i;
      if (FULL || n0 < Np) {
        float sg[2][4];
        group_scores(sg, s, i);
        next_bias_mask<BM>(b, m, bn, mn, b_lo, b_hi, mrow, n0, t2, N);
        if (!FULL && (BM || n0 + 16 > N)) vss::add_bias_mask<BM>(sg, b, m, n0, t2, N);
        vss::softmax_step(mx, sm, sg);
      }
    }
  };

  // p = exp(s - max) / sum of one tile's scores packed to bf16 A fragments,
  // group by group; past round16(N) p is 0 (against V's zero-filled rows)
  auto probs = [&](int t, const float (&s)[32], uint32_t (&pa)[4][4], auto full) {
    constexpr bool FULL = decltype(full)::value;
#pragma unroll
    for (int gi = 0; gi < 4; ++gi) {
      const int n0 = t * kTileKeys + 16 * gi;
      if (FULL || n0 < Np) {
        float sg[2][4];
        group_scores(sg, s, gi);
        next_bias_mask<BM>(b, m, bn, mn, b_lo, b_hi, mrow, n0, t2, N);
        if (!FULL && (BM || n0 + 16 > N)) vss::add_bias_mask<BM>(sg, b, m, n0, t2, N);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sg[j][e] = vss::div_rn(expf(sg[j][e] - mx[e >> 1]), sm[e >> 1], inv[e >> 1]);
        pa[gi][0] = vss::pack_bf16(sg[0][0], sg[0][1]);
        pa[gi][1] = vss::pack_bf16(sg[0][2], sg[0][3]);
        pa[gi][2] = vss::pack_bf16(sg[1][0], sg[1][1]);
        pa[gi][3] = vss::pack_bf16(sg[1][2], sg[1][3]);
      } else {
        pa[gi][0] = pa[gi][1] = pa[gi][2] = pa[gi][3] = 0u;
      }
    }
  };
  auto full_tile = [&](int t) { return !BM && (t + 1) * kTileKeys <= N; };

  // pass 1, tile t (scores in cur): K's stage released, the next entry's
  // scores (pass 1's tile t + 1 or pass 2's tile 0) started into nxt, then the
  // statistics of cur while that product runs
  auto pass1 = [&](int t, float (&cur)[32], float (&nxt)[32]) {
    release(t);
    zero(nxt);
    wait_full(t + 1);
    start_scores<HD>(nxt, qa, kring + ((t + 1) % kStages) * TILE);
    if (full_tile(t))
      stats(t, cur, std::true_type());
    else
      stats(t, cur, std::false_type());
    vss::wgmma_wait<0>();
    vss::fence_regs(nxt);
  };

  float o[HD / 2];
#pragma unroll
  for (int d = 0; d < HD / 2; ++d) o[d] = 0.f;

  // pass 2, tile t (scores in cur): the next tile's scores started into nxt
  // (past the last tile a product on this tile's K, whose stage is still
  // held, so that every step commits the same groups and ptxas can keep the
  // products asynchronous); p into pa (the buffer that tile t - 2's P·V
  // read) and P·V started; then the wait for nxt, which also finds tile t -
  // 1's P·V done and its stage free, while tile t's runs on
  auto pass2 = [&](int t, float (&cur)[32], float (&nxt)[32], uint32_t (&pa)[4][4]) {
    const int i = nt + t, next = t + 1 < nt ? i + 1 : i;
    zero(nxt);
    wait_full(next);
    start_scores<HD>(nxt, qa, kring + (next % kStages) * TILE);
    if (full_tile(t))
      probs(t, cur, pa, std::true_type());
    else
      probs(t, cur, pa, std::false_type());
    const uint32_t v_tile = vring + (i % kStages) * TILE;
    vss::wgmma_fence();
#pragma unroll
    for (int gi = 0; gi < 4; ++gi) mma_pv<HD>(o, pa[gi], v_tile + gi * 16 * HD * 2);
    vss::wgmma_commit();
    vss::wgmma_wait<1>();
    vss::fence_regs(nxt);
    if (t > 0) release(i - 1);
  };

  float sa[32], sb[32];
  zero(sa);
  wait_full(0);
  start_scores<HD>(sa, qa, kring);
  vss::wgmma_wait<0>();
  vss::fence_regs(sa);
  for (int t = 0; t < nt; t += 2) {
    pass1(t, sa, sb);
    if (t + 1 < nt) pass1(t + 1, sb, sa);
  }
  if (nt & 1) {  // pass 2's first scores are in sb
#pragma unroll
    for (int i = 0; i < 32; ++i) sa[i] = sb[i];
  }
  vss::softmax_rows(mx, sm);
  inv[0] = vss::recip(sm[0]);
  inv[1] = vss::recip(sm[1]);
  if constexpr (BM) {
    vss::load_bias(bn, b_lo, b_hi, 0, t2, N);
    vss::load_mask(mn, mrow, 0, t2, N);
  }
  uint32_t pa0[4][4], pa1[4][4];
  for (int t = 0; t < nt; t += 2) {
    pass2(t, sa, sb, pa0);
    if (t + 1 < nt) pass2(t + 1, sb, sa, pa1);
  }
  vss::wgmma_wait<0>();
  vss::fence_regs(o);

  // ---- out rows, one bf16 cast ---------------------------------------------
  __nv_bfloat16* og = out + (long long)g * Lq * C + h * HD;
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    if (r_lo < Lq)
      *reinterpret_cast<uint32_t*>(og + (long long)r_lo * C + d * 8 + t2) =
          vss::pack_bf16(o[4 * d], o[4 * d + 1]);
    if (r_hi < Lq)
      *reinterpret_cast<uint32_t*>(og + (long long)r_hi * C + d * 8 + t2) =
          vss::pack_bf16(o[4 * d + 2], o[4 * d + 3]);
  }
}

// cuTensorMapEncodeTiled, an entry point of libcuda, found through the
// runtime so that the library does not link libcuda; null if it is missing
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of K or V (G, N, C) bf16: boxes of (1, 64 keys, HD
// channels), rows past N zero-filled, swizzled as the wgmma descriptors read
// them (128 bytes at head dim 64, 64 at 32); C * 2 a multiple of 16
bool kv_map(CUtensorMap* map, const void* base, int G, int N, int C, int hd) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)N, (cuuint64_t)G};
  const cuuint64_t strides[2] = {(cuuint64_t)C * 2, (cuuint64_t)N * C * 2};
  const cuuint32_t box[3] = {(cuuint32_t)hd, (cuuint32_t)kTileKeys, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                hd == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, bool BM>
cudaError_t prepare_tiled() {
  return cudaFuncSetAttribute(attention_fwd_tiled_kernel<HD, BM>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)tiled_smem_bytes(HD));
}

template <int HD, bool BM>
int launch_tiled(const void* q, const void* k, const void* v, const void* bias,
                 const void* mask, void* out, int G, int Lq, int N, int nh, int C,
                 float q_scale, cudaStream_t s) {
  CUtensorMap kmap, vmap;
  if (!kv_map(&kmap, k, G, N, C, HD) || !kv_map(&vmap, v, G, N, C, HD))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = prepare_tiled<HD, BM>();
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Lq + kTiledRows - 1) / kTiledRows, nh, G);
  attention_fwd_tiled_kernel<HD, BM><<<grid, kTiledThreads, tiled_smem_bytes(HD), s>>>(
      kmap, vmap, static_cast<const __nv_bfloat16*>(q), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<__nv_bfloat16*>(out), Lq, N, C, q_scale);
  return (int)cudaGetLastError();
}

template <int HD, bool BM>
int tiled_blocks_per_sm() {
  cudaError_t e = prepare_tiled<HD, BM>();
  if (e != cudaSuccess) return -(int)e;
  int n = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, attention_fwd_tiled_kernel<HD, BM>,
                                                    kTiledThreads, tiled_smem_bytes(HD));
  return e == cudaSuccess ? n : -(int)e;
}

// The diagnostic of one tile's products through both instructions: S = q Kᵀ
// (64 rows x 64 keys) and O = p V (64 x HD) by wgmma, as the key-tiled
// instance computes them, and by mma.sync, as the resident one does, from
// the same bf16 inputs (K and V copied into swizzled shared memory). One
// warpgroup; outputs f32, row-major.
template <int HD>
__global__ void __launch_bounds__(128) mma_check_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ p, const __nv_bfloat16* __restrict__ v,
    float* __restrict__ s_wg, float* __restrict__ s_mma, float* __restrict__ o_wg,
    float* __restrict__ o_mma) {
  __shared__ __align__(1024) unsigned char tiles[2 * kTileKeys * HD * 2];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(tiles);
  __nv_bfloat16* Vs = Ks + kTileKeys * HD;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, t2 = (lane & 3) * 2;
  for (int c = tid; c < kTileKeys * HD / 8; c += 128) {
    const int r = c / (HD / 8), d = (c % (HD / 8)) * 8;
    *reinterpret_cast<uint4*>(Ks + vss::swz<HD>(r, d)) =
        *reinterpret_cast<const uint4*>(k + r * HD + d);
    *reinterpret_cast<uint4*>(Vs + vss::swz<HD>(r, d)) =
        *reinterpret_cast<const uint4*>(v + r * HD + d);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma's reads
  __syncthreads();
  const int r_lo = warp * 16 + (lane >> 2), r_hi = r_lo + 8;
  uint32_t qa[HD / 16][4], pa[4][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    qa[kk][0] = q_pair(q, r_lo, 64, HD, kk * 16 + t2, 1.f);
    qa[kk][1] = q_pair(q, r_hi, 64, HD, kk * 16 + t2, 1.f);
    qa[kk][2] = q_pair(q, r_lo, 64, HD, kk * 16 + 8 + t2, 1.f);
    qa[kk][3] = q_pair(q, r_hi, 64, HD, kk * 16 + 8 + t2, 1.f);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    pa[i][0] = q_pair(p, r_lo, 64, 64, i * 16 + t2, 1.f);
    pa[i][1] = q_pair(p, r_hi, 64, 64, i * 16 + t2, 1.f);
    pa[i][2] = q_pair(p, r_lo, 64, 64, i * 16 + 8 + t2, 1.f);
    pa[i][3] = q_pair(p, r_hi, 64, 64, i * 16 + 8 + t2, 1.f);
  }
  float s[32], o[HD / 2];
  zero(s);
  start_scores<HD>(s, qa, vss::smem_addr(Ks));
  vss::wgmma_wait<0>();
  vss::fence_regs(s);
#pragma unroll
  for (int d = 0; d < HD / 2; ++d) o[d] = 0.f;
  vss::wgmma_fence();
#pragma unroll
  for (int i = 0; i < 4; ++i) mma_pv<HD>(o, pa[i], vss::smem_addr(Vs) + i * 16 * HD * 2);
  vss::wgmma_commit();
  vss::wgmma_wait<0>();
  vss::fence_regs(o);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s_wg[r_lo * 64 + 8 * j + t2 + e] = s[4 * j + e];
      s_wg[r_hi * 64 + 8 * j + t2 + e] = s[4 * j + 2 + e];
    }
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      o_wg[r_lo * HD + 8 * j + t2 + e] = o[4 * j + e];
      o_wg[r_hi * HD + 8 * j + t2 + e] = o[4 * j + 2 + e];
    }
  // the resident instance's route: 16-key steps of mma.sync m16n8k16
#pragma unroll
  for (int n0 = 0; n0 < kTileKeys; n0 += 16) {
    float st[2][4];
    vss::mma_xt<HD>(st, qa, Ks, n0, lane);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s_mma[r_lo * 64 + n0 + 8 * j + t2 + e] = st[j][e];
        s_mma[r_hi * 64 + n0 + 8 * j + t2 + e] = st[j][2 + e];
      }
  }
  float om[HD / 8][4] = {};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int d = 0; d < HD; d += 16) {
      uint32_t bv[4];
      vss::load_b<HD>(bv, Vs, 16 * i, d, lane);
      vss::mma16816(om[d / 8], pa[i], bv[0], bv[1]);
      vss::mma16816(om[d / 8 + 1], pa[i], bv[2], bv[3]);
    }
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      o_mma[r_lo * HD + 8 * j + t2 + e] = om[j][e];
      o_mma[r_hi * HD + 8 * j + t2 + e] = om[j][2 + e];
    }
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
// tiles by TMA. K comes scaled (k_scale must be 1: the wrapper scales it
// once), and C * 2 must be a multiple of 16 (TMA's row stride). Returns a
// cudaError_t.
VSS_EXPORT int attention_fwd_tiled(const void* q, const void* k, const void* v,
                                   const void* bias, const void* mask, void* out, int G, int Lq,
                                   int N, int nh, int hd, int C, float q_scale, float k_scale,
                                   int device, void* stream) {
  vss::use_device(device);
  if (G == 0 || Lq == 0) return 0;
  if (N < 1 || (bias == nullptr) != (mask == nullptr) || k_scale != 1.f || C * 2 % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define VSS_FWD(HD, BM) \
  return launch_tiled<HD, BM>(q, k, v, bias, mask, out, G, Lq, N, nh, C, q_scale, s)
  if (hd == 32 && bias) VSS_FWD(32, true);
  if (hd == 32) VSS_FWD(32, false);
  if (hd == 64 && bias) VSS_FWD(64, true);
  if (hd == 64) VSS_FWD(64, false);
#undef VSS_FWD
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one block of the key-tiled instance at head dim hd.
VSS_EXPORT int attention_fwd_tiled_smem_bytes(int hd) { return (int)tiled_smem_bytes(hd); }

// Blocks of the key-tiled instance one SM holds at head dim hd, with bias and
// mask or without; minus a cudaError_t on failure.
VSS_EXPORT int attention_fwd_tiled_blocks_per_sm(int hd, int with_bias, int device) {
  vss::use_device(device);
  if (hd == 32) return with_bias ? tiled_blocks_per_sm<32, true>() : tiled_blocks_per_sm<32, false>();
  if (hd == 64) return with_bias ? tiled_blocks_per_sm<64, true>() : tiled_blocks_per_sm<64, false>();
  return -(int)cudaErrorInvalidValue;
}

// One tile's products through wgmma and through mma.sync (mma_check_kernel):
// q (64, hd), k (64, hd), p (64, 64), v (64, hd) bf16 on the device; s_* (64,
// 64) and o_* (64, hd) f32. Returns a cudaError_t.
VSS_EXPORT int attention_mma_check(const void* q, const void* k, const void* p, const void* v,
                                   void* s_wg, void* s_mma, void* o_wg, void* o_mma, int hd,
                                   int device, void* stream) {
  vss::use_device(device);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define VSS_CHECK(HD)                                                                         \
  mma_check_kernel<HD><<<1, 128, 0, s>>>(                                                     \
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),             \
      static_cast<const __nv_bfloat16*>(p), static_cast<const __nv_bfloat16*>(v),             \
      static_cast<float*>(s_wg), static_cast<float*>(s_mma), static_cast<float*>(o_wg),       \
      static_cast<float*>(o_mma));                                                            \
  return (int)cudaGetLastError()
  if (hd == 32) { VSS_CHECK(32); }
  if (hd == 64) { VSS_CHECK(64); }
#undef VSS_CHECK
  return (int)cudaErrorInvalidValue;
}

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
