// Backward of the MiT block's spatial-reduction attention with dK and dV
// fused, per (frame, head, split of its 64-query tiles), the softmax
// recomputed.
//
// Part of the port of the TPU kernel vss_cffm_tpu/ops/stage_block.py:
// _mit_block_train_bwd (_train_bwd_kernel, its attention backward): for the
// frame's queries q (bf16) against its S spatial-reduced keys, Ks = bf16(K ·
// scale) and V (bf16):
//
//   p    = softmax(q·Ksᵀ) over the S keys (f32)
//   d_p  = d_ctx·Vᵀ (f32),  r = Σ d_p∘p,  d_s = bf16(p∘(d_p − r))
//   d_q  = d_s·Ks (f32), written as bf16, and per tile Σ d_q (dbq, f32)
//   dKsᵀ = Σ_queries d_sᵀ·q,  dV = Σ_queries bf16(p)ᵀ·d_ctx (f32)
//
// As the TPU kernel keeps p and d_s on chip and adds per-tile dKᵀ and dV into
// output blocks that its sequential grid revisits, this kernel never writes
// p or d_s: a block walks its split of the frame's query tiles in order and
// adds each tile's dKs and dV into f32 accumulators of the frame's keys in
// shared memory; at the end it writes them as its split's partial, and the
// wrapper sums the splits in a fixed order (no atomics: two runs are
// bitwise equal) and multiplies dKs by the scale.
//
// Bound on the H100: at the train step's stage 1 (14,400 queries per frame
// against 225 keys, head dim 64) each query costs 7 products of 2·64·225
// flops (the scores three times, d_p twice, d_q, and dK, dV) against ~512
// bytes (q, d_ctx in, d_q out), so the tensor cores and the exponentials
// (three per score) bound it, not bytes. Design, as attention_bwd.cu:
// - one block of two groups of 4 warps; K and V of the (frame, head) stay in
//   shared memory for all its tiles, XOR-swizzled for ldmatrix; q and d_ctx
//   of the next 64-query tile are in flight (cp.async, a ring of 2) while
//   the current one computes; each warp owns 16 query rows, and the two
//   groups split the keys: group 0 the first half of the 16-key steps,
//   group 1 the rest. With 4 warps a block (one warp a scheduler) the chains
//   of dependent mma.sync kept the tensor cores waiting; two warps a
//   scheduler take turns;
// - S, p, d_p and d_s live in mma.sync m16n8k16 accumulators over steps of
//   16 keys, recomputed per sweep: the row max and sum of exps, then r, then
//   d_s with d_q in registers; the groups' partial max / sum and r of each
//   row meet in shared memory after sweeps 1 and 2 and are combined in a
//   fixed order, and group 1's partial d_q is added to group 0's before d_q
//   is written; loads are clamped and branch-free; p = expf(s − max) / sum
//   with vss::div_rn (the `/` operator's rounding);
// - per 32-key chunk of its keys a group passes the bf16 p and d_s of the
//   tile's 64 rows through two 4 KB tiles of its own; its 4 warps then form
//   16 keys of dV = pᵀ·d_ctx or of dKs = d_sᵀ·q each over the 64 rows
//   (ldmatrix.trans) and add them into the f32 accumulators, each element
//   owned by one thread (float groups swizzled by the key, so that the 8
//   keys a load phase touches fall in different banks); the groups own
//   disjoint keys, so they synchronise only on their own named barrier;
// - 228,352 bytes of shared memory at S = 225, head dim 64 (the
//   accumulators alone 115,200): one block per SM; the wrapper cuts the
//   frame's tiles into splits so that the blocks fill one wave.
#include "common.cuh"
#include "mma_sync.cuh"

namespace {

constexpr int kGroups = 2;                   // warp groups, each over its share of the keys
constexpr int kGroupWarps = 4;
constexpr int kWarps = kGroups * kGroupWarps;
constexpr int kRows = 16 * kGroupWarps;      // query rows of a tile
constexpr int kChunk = 32;                   // keys per chunk of the transposed products

__host__ __device__ inline int round16(int n) { return (n + 15) / 16 * 16; }

// Layout (bytes) of one block's dynamic shared memory: Ks, Vs (Sp, hd) bf16;
// a ring of 2 stages of q and d_ctx (kRows, hd) bf16; per group the p and
// d_s chunk tiles (kRows, kChunk) bf16, also the exchange of d_q (kRows, hd)
// f32 at the end of a tile; the dKs and dV accumulators (S, hd) f32; the
// groups' row statistics (max, sum) and r; the warps' column sums of d_q
// (kGroupWarps, hd) f32. ops/stage_block.py:sra_attention_bwd_smem is the
// same sum.
struct Smem {
  int S, Sp, hd;
  __host__ __device__ Smem(int S_, int hd_) : S(S_), Sp(round16(S_)), hd(hd_) {}
  __host__ __device__ size_t stage_elems() const { return (size_t)2 * kRows * hd; }
  __host__ __device__ size_t ring_off() const { return (size_t)2 * Sp * hd * 2; }
  __host__ __device__ size_t tiles_off() const { return ring_off() + 2 * stage_elems() * 2; }
  __host__ __device__ size_t tiles_bytes() const {
    const size_t t = (size_t)kGroups * 2 * kRows * kChunk * 2, x = (size_t)kRows * hd * 4;
    return t > x ? t : x;
  }
  __host__ __device__ size_t acc_off() const { return tiles_off() + tiles_bytes(); }
  __host__ __device__ size_t xch_off() const { return acc_off() + (size_t)2 * S * hd * 4; }
  __host__ __device__ size_t dq_off() const { return xch_off() + (size_t)kGroups * kRows * 3 * 4; }
  __host__ __device__ size_t bytes() const { return dq_off() + (size_t)kGroupWarps * hd * 4; }
};

// offset of (key n, column col) in an accumulator: groups of 8 floats
// XOR-swizzled by the key
template <int HD>
__device__ __forceinline__ int acc_at(int n, int col) {
  return n * HD + ((((col >> 3) ^ (n & (HD / 8 - 1)))) << 3) + (col & 7);
}

// the named barrier of warp group g (its 128 threads)
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + g), "n"(32 * kGroupWarps));
}

// rows [0, rows) of a head slice with row stride C into a swizzled (nrows, HD)
// tile, zero rows past `rows`, as cp.async copies of 16 bytes
template <int HD>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           int rows, int nrows, int C) {
  constexpr int CH = HD / 8;
  for (int c = threadIdx.x; c < nrows * CH; c += blockDim.x) {
    const int r = c / CH, d = (c % CH) * 8;
    if (r < rows)
      vss::cp_async16(dst + vss::swz<HD>(r, d), src + (long long)r * C + d);
    else
      vss::zero16(dst + vss::swz<HD>(r, d));
  }
}

template <int HD>
__global__ void __launch_bounds__(32 * kWarps, 1) sra_attention_bwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ g,
    __nv_bfloat16* __restrict__ dq, float* __restrict__ dbq_partial,
    float* __restrict__ dkv_partial, int HW, int S, int nh, int C, float k_scale, int tps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem L(S, HD);
  const int Sp = L.Sp;
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + Sp * HD;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem + L.ring_off());
  float* dKa = reinterpret_cast<float*>(smem + L.acc_off());
  float* dVa = dKa + S * HD;
  float* xst = reinterpret_cast<float*>(smem + L.xch_off());  // (kGroups, kRows, 2) max, sum
  float* xr = xst + kGroups * kRows * 2;                       // (kGroups, kRows) r
  float* Dq = reinterpret_cast<float*>(smem + L.dq_off());
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = warp / kGroupWarps, wg = warp % kGroupWarps;
  __nv_bfloat16* Pt = reinterpret_cast<__nv_bfloat16*>(smem + L.tiles_off()) +
                      grp * 2 * kRows * kChunk;
  __nv_bfloat16* Dt = Pt + kRows * kChunk;
  float* Xq = reinterpret_cast<float*>(smem + L.tiles_off());  // (kRows, HD) d_q of group 1
  const int t2 = (lane & 3) * 2;
  const int split = blockIdx.x, h = blockIdx.y;
  const long long f = blockIdx.z;
  const int ntq = (HW + kRows - 1) / kRows;
  const int tb = split * tps, te = min(ntq, tb + tps);
  const int wr = wg * 16;
  const int r_lo = wr + (lane >> 2), r_hi = r_lo + 8;  // this thread's two rows of a tile
  // this group's keys: [kb, ke), group 0 the first half of the 16-key steps
  const int half = (Sp / 16 + 1) / 2 * 16;
  const int kb = grp == 0 ? 0 : half, ke = grp == 0 ? half : Sp;

  stage_rows<HD>(Ks, k + f * S * C + h * HD, S, Sp, C);
  stage_rows<HD>(Vs, v + f * S * C + h * HD, S, Sp, C);
  vss::cp_async_commit();
  auto issue = [&](int tile, int st) {
    __nv_bfloat16* Qs = ring + st * L.stage_elems();
    const int q0 = tile * kRows, rows = min(kRows, HW - q0);
    stage_rows<HD>(Qs, q + (f * HW + q0) * C + h * HD, rows, kRows, C);
    stage_rows<HD>(Qs + kRows * HD, g + (f * HW + q0) * C + h * HD, rows, kRows, C);
    vss::cp_async_commit();
  };
  if (tb < te) issue(tb, 0);
  for (int e = tid; e < 2 * S * HD / 4; e += blockDim.x)
    reinterpret_cast<float4*>(dKa)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  vss::cp_async_wait<0>();
  __syncthreads();
  // Ks = bf16(K · scale) in place, as the reference scales K in its own dtype
  for (int c = tid; c < Sp * HD / 8; c += blockDim.x) {
    float x[8];
    vss::load8(Ks + c * 8, x);
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = x[i] * k_scale;
    vss::store8(Ks + c * 8, x);
  }

  for (int tile = tb; tile < te; ++tile) {
    const int st = (tile - tb) & 1;
    if (tile + 1 < te) {  // the stage the last tile used: free since its last sync
      issue(tile + 1, st ^ 1);
      vss::cp_async_wait<1>();
    } else {
      vss::cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Qs = ring + st * L.stage_elems();
    const __nv_bfloat16* Gs = Qs + kRows * HD;
    const int q0 = tile * kRows, rows = min(kRows, HW - q0);

    uint32_t qa[HD / 16][4], ga[HD / 16][4];
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      vss::load_a<HD>(qa[kk], Qs, wr, kk * 16, lane);
      vss::load_a<HD>(ga[kk], Gs, wr, kk * 16, lane);
    }
    const float nob[8] = {}, nom[4] = {};  // no bias, no mask: keys past S at -inf

    // ---- sweep 1: the row max and sum of exps over this group's keys, then
    // both groups' combined in a fixed order ----------------------------------
    float mx[2] = {-3.402823466e38f, -3.402823466e38f}, sm[2] = {0.f, 0.f};
#pragma unroll 2
    for (int n0 = kb; n0 < ke; n0 += 16) {
      float s[2][4];
      vss::mma_xt<HD>(s, qa, Ks, n0, lane);
      vss::add_bias_mask<false>(s, nob, nom, n0, t2, S);
      vss::softmax_step(mx, sm, s);
    }
    vss::softmax_rows(mx, sm);
    if ((lane & 3) == 0) {
      xst[(grp * kRows + r_lo) * 2] = mx[0];
      xst[(grp * kRows + r_lo) * 2 + 1] = sm[0];
      xst[(grp * kRows + r_hi) * 2] = mx[1];
      xst[(grp * kRows + r_hi) * 2 + 1] = sm[1];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = i == 0 ? r_lo : r_hi;
      const float m0 = xst[row * 2], s0 = xst[row * 2 + 1];
      const float m1 = xst[(kRows + row) * 2], s1 = xst[(kRows + row) * 2 + 1];
      mx[i] = fmaxf(m0, m1);
      sm[i] = s0 * expf(m0 - mx[i]) + s1 * expf(m1 - mx[i]);
    }
    const float inv[2] = {vss::recip(sm[0]), vss::recip(sm[1])};

    // p of the warp's rows x keys [n0, n0 + 16), zero past the tile's rows and S
    auto p_step = [&](float (&p)[2][4], int n0) {
      vss::mma_xt<HD>(p, qa, Ks, n0, lane);
      vss::add_bias_mask<false>(p, nob, nom, n0, t2, S);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? r_lo : r_hi;
          p[j][e] = row < rows
                        ? vss::div_rn(expf(p[j][e] - mx[e >> 1]), sm[e >> 1], inv[e >> 1])
                        : 0.f;
        }
    };

    // ---- sweep 2: r = Σ_n d_p·p over this group's keys, then both ----------
    float r[2] = {0.f, 0.f};
#pragma unroll 2
    for (int n0 = kb; n0 < ke; n0 += 16) {
      float p[2][4], dp[2][4];
      p_step(p, n0);
      vss::mma_xt<HD>(dp, ga, Vs, n0, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        r[0] += dp[j][0] * p[j][0] + dp[j][1] * p[j][1];
        r[1] += dp[j][2] * p[j][2] + dp[j][3] * p[j][3];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      r[i] += __shfl_xor_sync(0xffffffffu, r[i], 1);
      r[i] += __shfl_xor_sync(0xffffffffu, r[i], 2);
    }
    if ((lane & 3) == 0) {
      xr[grp * kRows + r_lo] = r[0];
      xr[grp * kRows + r_hi] = r[1];
    }
    __syncthreads();
    r[0] = xr[r_lo] + xr[kRows + r_lo];
    r[1] = xr[r_hi] + xr[kRows + r_hi];

    // ---- sweep 3: d_s, d_q over this group's keys; per 32-key chunk dV and
    // dKs of those keys into the accumulators --------------------------------
    float acc[HD / 8][4];
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
    for (int t0 = kb; t0 < ke; t0 += kChunk) {
      const int steps = min(kChunk, ke - t0) / 16;
      for (int u = 0; u < steps; ++u) {
        const int n0 = t0 + 16 * u;
        float p[2][4], ds[2][4];
        p_step(p, n0);
        vss::mma_xt<HD>(ds, ga, Vs, n0, lane);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) ds[j][e] = p[j][e] * (ds[j][e] - r[e >> 1]);
        const uint32_t pa[4] = {vss::pack_bf16(p[0][0], p[0][1]), vss::pack_bf16(p[0][2], p[0][3]),
                                vss::pack_bf16(p[1][0], p[1][1]), vss::pack_bf16(p[1][2], p[1][3])};
        const uint32_t da[4] = {vss::pack_bf16(ds[0][0], ds[0][1]),
                                vss::pack_bf16(ds[0][2], ds[0][3]),
                                vss::pack_bf16(ds[1][0], ds[1][1]),
                                vss::pack_bf16(ds[1][2], ds[1][3])};
        // d_q += bf16(d_s)·Ks over these 16 keys
#pragma unroll
        for (int d = 0; d < HD; d += 16) {
          uint32_t b[4];
          vss::load_b<HD>(b, Ks, n0, d, lane);
          vss::mma16816(acc[d / 8], da, b[0], b[1]);
          vss::mma16816(acc[d / 8 + 1], da, b[2], b[3]);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = 16 * u + 8 * j + t2;
          *reinterpret_cast<uint32_t*>(Pt + vss::swz<kChunk>(r_lo, c)) = pa[2 * j];
          *reinterpret_cast<uint32_t*>(Pt + vss::swz<kChunk>(r_hi, c)) = pa[2 * j + 1];
          *reinterpret_cast<uint32_t*>(Dt + vss::swz<kChunk>(r_lo, c)) = da[2 * j];
          *reinterpret_cast<uint32_t*>(Dt + vss::swz<kChunk>(r_hi, c)) = da[2 * j + 1];
        }
      }
      group_sync(grp);
      // warp wg of the group: keys t0 + 16 (wg & 1) .. + 15 of dV = bf16(p)ᵀ·d_ctx
      // (wg < 2) or of dKs = bf16(d_s)ᵀ·q (wg >= 2)
      const int m0 = 16 * (wg & 1), which = wg >> 1;
      if (m0 < 16 * steps && t0 + m0 < S) {
        const __nv_bfloat16* X = which == 0 ? Pt : Dt;
        const __nv_bfloat16* Y = which == 0 ? Gs : Qs;
        float* A = which == 0 ? dVa : dKa;
        float o[HD / 8][4];
#pragma unroll
        for (int d = 0; d < HD / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
#pragma unroll
        for (int k0 = 0; k0 < kRows; k0 += 16) {
          uint32_t a[4];
          vss::load_at<kChunk>(a, X, k0, m0, lane);
#pragma unroll
          for (int d = 0; d < HD; d += 16) {
            uint32_t b[4];
            vss::load_b<HD>(b, Y, k0, d, lane);
            vss::mma16816(o[d / 8], a, b[0], b[1]);
            vss::mma16816(o[d / 8 + 1], a, b[2], b[3]);
          }
        }
        const int n_lo = t0 + m0 + (lane >> 2), n_hi = n_lo + 8;
#pragma unroll
        for (int d = 0; d < HD / 8; ++d) {
          if (n_lo < S) {
            float2* pp = reinterpret_cast<float2*>(A + acc_at<HD>(n_lo, d * 8 + t2));
            *pp = make_float2(pp->x + o[d][0], pp->y + o[d][1]);
          }
          if (n_hi < S) {
            float2* pp = reinterpret_cast<float2*>(A + acc_at<HD>(n_hi, d * 8 + t2));
            *pp = make_float2(pp->x + o[d][2], pp->y + o[d][3]);
          }
        }
      }
      group_sync(grp);  // the group's tiles are free again
    }

    // ---- d_q = group 0's + group 1's sum (bf16) and the tile's Σ d_q (f32) --
    __syncthreads();  // both groups are past their tiles: the area holds d_q now
    if (grp == 1) {
#pragma unroll
      for (int d = 0; d < HD / 8; ++d) {
        *reinterpret_cast<float2*>(Xq + r_lo * HD + d * 8 + t2) = make_float2(acc[d][0], acc[d][1]);
        *reinterpret_cast<float2*>(Xq + r_hi * HD + d * 8 + t2) = make_float2(acc[d][2], acc[d][3]);
      }
    }
    __syncthreads();
    if (grp == 0) {
      __nv_bfloat16* dqw = dq + (f * HW + q0) * C + h * HD;
#pragma unroll
      for (int d = 0; d < HD / 8; ++d) {
        const float2 lo = *reinterpret_cast<const float2*>(Xq + r_lo * HD + d * 8 + t2);
        const float2 hi = *reinterpret_cast<const float2*>(Xq + r_hi * HD + d * 8 + t2);
        acc[d][0] += lo.x;
        acc[d][1] += lo.y;
        acc[d][2] += hi.x;
        acc[d][3] += hi.y;
        if (r_lo < rows)
          *reinterpret_cast<uint32_t*>(dqw + (long long)r_lo * C + d * 8 + t2) =
              vss::pack_bf16(acc[d][0], acc[d][1]);
        if (r_hi < rows)
          *reinterpret_cast<uint32_t*>(dqw + (long long)r_hi * C + d * 8 + t2) =
              vss::pack_bf16(acc[d][2], acc[d][3]);
        float cs[2] = {acc[d][0] + acc[d][2], acc[d][1] + acc[d][3]};
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) cs[e] += __shfl_xor_sync(0xffffffffu, cs[e], o);
        if (lane < 4) {
          Dq[wg * HD + d * 8 + t2] = cs[0];
          Dq[wg * HD + d * 8 + t2 + 1] = cs[1];
        }
      }
    }
    __syncthreads();
    for (int d = tid; d < HD; d += blockDim.x) {  // the warps added in order
      float cs = 0.f;
#pragma unroll
      for (int w = 0; w < kGroupWarps; ++w) cs += Dq[w * HD + d];
      dbq_partial[((f * ntq + tile) * nh + h) * HD + d] = cs;
    }
  }

  // ---- this split's dKs and dV of the (frame, head) -----------------------
  __syncthreads();
  float* out = dkv_partial + (((long long)split * gridDim.z + f) * nh + h) * 2 * S * HD;
  for (int e = tid; e < 2 * S * HD / 4; e += blockDim.x) {
    const int i = e * 4, which = i / (S * HD), n = (i % (S * HD)) / HD, col = i % HD;
    const float* A = which == 0 ? dKa : dVa;
    reinterpret_cast<float4*>(out)[e] =
        *reinterpret_cast<const float4*>(A + acc_at<HD>(n, col));
  }
}

template <int HD>
cudaError_t prepare(size_t bytes) {
  cudaError_t e = cudaFuncSetAttribute(sra_attention_bwd_kernel<HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(sra_attention_bwd_kernel<HD>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* d_ctx, void* d_q,
           void* dbq_partial, void* dkv_partial, int B, int HW, int S, int nh, int C,
           float k_scale, int tps, cudaStream_t s) {
  const size_t bytes = Smem(S, HD).bytes();
  cudaError_t e = prepare<HD>(bytes);
  if (e != cudaSuccess) return (int)e;
  const int ntq = (HW + kRows - 1) / kRows;
  dim3 grid((ntq + tps - 1) / tps, nh, B);
  sra_attention_bwd_kernel<HD><<<grid, 32 * kWarps, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(d_ctx),
      static_cast<__nv_bfloat16*>(d_q), static_cast<float*>(dbq_partial),
      static_cast<float*>(dkv_partial), HW, S, nh, C, k_scale, tps);
  return (int)cudaGetLastError();
}

template <int HD>
int blocks_per_sm(int S) {
  const size_t bytes = Smem(S, HD).bytes();
  cudaError_t e = prepare<HD>(bytes);
  if (e != cudaSuccess) return -(int)e;
  int n = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, sra_attention_bwd_kernel<HD>,
                                                    32 * kWarps, bytes);
  return e == cudaSuccess ? n : -(int)e;
}

}  // namespace

// q, d_ctx, d_q (B·HW, C) bf16; k, v (B, S, C) bf16 (K unscaled; k_scale is
// the attention scale rounded to bf16); dbq_partial (B, ceil(HW / 64), nh,
// hd) f32 receives each tile's Σ d_q; dkv_partial (ceil(ceil(HW / 64) / tps),
// B, nh, 2, S, hd) f32 each split's Σ d_sᵀ·q (the gradient of Ks, before the
// scale) and Σ bf16(p)ᵀ·d_ctx; a block walks tps consecutive tiles. C =
// nh·hd, hd in {32, 64}. Returns a cudaError_t.
VSS_EXPORT int sra_attention_bwd(const void* q, const void* k, const void* v, const void* d_ctx,
                                 void* d_q, void* dbq_partial, void* dkv_partial, int B, int HW,
                                 int S, int nh, int hd, int C, float k_scale, int tps,
                                 int device, void* stream) {
  vss::use_device(device);
  if (B == 0 || HW == 0) return 0;
  if (S < 1 || tps < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch<32>(q, k, v, d_ctx, d_q, dbq_partial, dkv_partial, B, HW, S, nh, C, k_scale, tps, s);
    case 64: return launch<64>(q, k, v, d_ctx, d_q, dbq_partial, dkv_partial, B, HW, S, nh, C, k_scale, tps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of one block at S keys and head dim hd: the
// wrapper's gate against the card's limit.
VSS_EXPORT int sra_attention_bwd_smem_bytes(int S, int hd) { return (int)Smem(S, hd).bytes(); }

// Blocks of the kernel one SM holds at S keys and head dim hd
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); minus a cudaError_t on
// failure.
VSS_EXPORT int sra_attention_bwd_blocks_per_sm(int S, int hd, int device) {
  vss::use_device(device);
  if (S < 1) return -(int)cudaErrorInvalidValue;
  if (hd == 32) return blocks_per_sm<32>(S);
  if (hd == 64) return blocks_per_sm<64>(S);
  return -(int)cudaErrorInvalidValue;
}
