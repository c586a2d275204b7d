// Backward of the CFM window attention, with the softmax recomputed or read
// from the forward's probabilities.
//
// Replaces the TPU kernels vss_cffm_tpu/ops/cfm_attention.py:
// _cfm_attention_bwd_pallas_rc (_bwd_kernel_rc): for every (window, head),
// qs = bf16(q * scale), S = qs K^T + bias + mask (f32), p = softmax(S) (f32),
// dP = g V^T, ds = p (dP - sum_n dP p) (f32), dq = bf16(bf16(ds) K) * scale
// rounded again, dK = bf16(ds)^T qs, dV = bf16(p)^T g, and dbias = the sum
// of ds over the windows. Packed K/V: one (G, N, C) tensor each.
// _cfm_attention_bwd_pallas (_bwd_kernel), the compile-time mode PT = float
// or bf16: p is read from the forward's probabilities (G, nh, Lq, N), the
// S = qs K^T recompute and its exps are skipped (bias and mask are not
// read), and the rest is the same arithmetic.
//
// Bound on the H100 at the train step (162 windows, 49 queries, N 289, 8
// heads of 32): ~108 MB of inputs and outputs (~32 us) against ~5.9 GFLOP of
// products (~6 us on the tensor cores); but a (window, head) is small, so
// latency and the blocks in flight limit the kernel first.
// Design: one block of 4 warps per (head, tile of windows), walking its
// windows in order; each warp owns 16 of the (at most 64) query rows.
// - A ring of two stages in shared memory holds qs, g (64 rows, zero
//   padded), K and V (N padded to 16) of a window, XOR-swizzled for
//   conflict-free ldmatrix; the next window's four slices are in flight
//   (cp.async) while the current one computes.
// - S, p, dP and ds live in registers, as mma.sync m16n8k16 accumulators
//   over steps of 16 keys, recomputed per sweep rather than held: a first
//   sweep keeps each row's running max and sum of exps (recompute mode), a
//   second forms p and dP and sums r = sum_n dP p, a third forms
//   ds = p (dP - r), adds bf16(ds) K into dq's register accumulator (the
//   accumulator layout packed to bf16 is the A operand), and adds ds into the
//   block's dbias partial in global memory (each element read and written by
//   one thread, in a fixed order: no atomics, the same sum run to run). The
//   loads of bias, mask, p and the partial so far are clamped and
//   branch-free, issued at the top of a step; p = expf(s - max) / sum with
//   the forward's division (vss::div_rn, rounded as `/` rounds it without
//   the operator's slow-path branch, which made this kernel 1.5x slower).
// - 110.6 KB of shared memory and 164-176 registers a thread at head dim 32
//   and N 289: 2 blocks (8 warps) per SM, with the SM's carveout set to its
//   largest (204.8 KB and one block at head dim 64); the wrapper sizes the
//   window tiles to fill one wave of them.
// - Only the bf16 p and ds of 64 keys x 64 rows (8 KB each) go through
//   shared memory, for the products over the query rows, dV = bf16(p)^T g and
//   dK = bf16(ds)^T qs, read back with ldmatrix.trans; each warp finishes 16
//   keys of dV and dK per 64-key tile and writes them.
#include <type_traits>

#include "common.cuh"
#include "mma_sync.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 16 * kWarps;  // query rows held (Lq <= 64)
constexpr int kTile = 64;           // keys per tile of the transposed products
constexpr int kStages = 2;          // depth of the ring of window inputs

__host__ __device__ inline int round16(int n) { return (n + 15) / 16 * 16; }

// One stage: qs, g (kRows, HD), K, V (Np, HD) bf16; then the p and ds tiles.
struct Smem {
  int Np, hd;
  __host__ __device__ Smem(int N, int hd_) : Np(round16(N)), hd(hd_) {}
  __host__ __device__ size_t stage_elems() const { return (size_t)(2 * kRows + 2 * Np) * hd; }
  __host__ __device__ size_t tiles_off() const { return kStages * stage_elems() * 2; }
  __host__ __device__ size_t bytes() const { return tiles_off() + 2 * kRows * kTile * 2; }
};

// p of (row, n) from the forward's probabilities, f32 or bf16
__device__ __forceinline__ float load_p(const float* p, long long i) { return __ldg(p + i); }
__device__ __forceinline__ float load_p(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(__ldg(p + i));
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

// PT = void: the softmax recomputed from q, K, bias and mask; PT = float or
// __nv_bfloat16: p read from probs (G, nh, Lq, N) of that type
template <int HD, typename PT>
__global__ void __launch_bounds__(32 * kWarps, 2) attention_bwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
    const float* __restrict__ mask, const void* __restrict__ probs,
    const __nv_bfloat16* __restrict__ g, __nv_bfloat16* __restrict__ dq,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
    float* __restrict__ dbias_partial, int G, int Lq, int N, int nh, int C, float q_scale,
    int tw) {
  constexpr bool kFromProbs = !std::is_void<PT>::value;
  constexpr int CH = HD / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem L(N, HD);
  const int Np = L.Np;
  __nv_bfloat16* base = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Pt = reinterpret_cast<__nv_bfloat16*>(smem + L.tiles_off());
  __nv_bfloat16* Dt = Pt + kRows * kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t2 = (lane & 3) * 2;
  const int h = blockIdx.y, tile = blockIdx.x;
  const int w0 = tile * tw, w_end = min(w0 + tw, G);
  const int wr = warp * 16;                       // this warp's first row
  const int r_lo = wr + (lane >> 2), r_hi = r_lo + 8;  // this thread's two rows
  float* dbias = dbias_partial + ((long long)tile * nh + h) * Lq * N;
  const float* b_lo = kFromProbs ? nullptr
                                  : bias + ((long long)h * Lq + min(r_lo, Lq - 1)) * N;
  const float* b_hi = kFromProbs ? nullptr
                                  : bias + ((long long)h * Lq + min(r_hi, Lq - 1)) * N;

  auto issue = [&](int wi, int st) {
    __nv_bfloat16* Qs = base + st * L.stage_elems();
    stage_rows<HD>(Qs, q + (long long)wi * Lq * C + h * HD, Lq, kRows, C);
    stage_rows<HD>(Qs + kRows * HD, g + (long long)wi * Lq * C + h * HD, Lq, kRows, C);
    stage_rows<HD>(Qs + 2 * kRows * HD, k + (long long)wi * N * C + h * HD, N, Np, C);
    stage_rows<HD>(Qs + 2 * kRows * HD + Np * HD, v + (long long)wi * N * C + h * HD, N, Np, C);
    vss::cp_async_commit();
  };

  if (w0 < w_end) issue(w0, 0);
  for (int wi = w0; wi < w_end; ++wi) {
    const int st = (wi - w0) & 1;
    if (wi + 1 < w_end) {  // the stage the last window used: free since its last sync
      issue(wi + 1, st ^ 1);
      vss::cp_async_wait<1>();
    } else {
      vss::cp_async_wait<0>();
    }
    __syncthreads();
    __nv_bfloat16* Qs = base + st * L.stage_elems();
    __nv_bfloat16* Gs = Qs + kRows * HD;
    __nv_bfloat16* Ks = Gs + kRows * HD;
    __nv_bfloat16* Vs = Ks + Np * HD;
    // qs = bf16(q * scale) in place (the reference's rounding)
    for (int c = tid; c < Lq * CH; c += blockDim.x) {
      __nv_bfloat16* p = Qs + vss::swz<HD>(c / CH, (c % CH) * 8);
      float f[8];
      vss::load8(p, f);
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = f[i] * q_scale;
      vss::store8(p, f);
    }
    __syncthreads();

    uint32_t qa[HD / 16][4], ga[HD / 16][4];
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      vss::load_a<HD>(qa[kk], Qs, wr, kk * 16, lane);
      vss::load_a<HD>(ga[kk], Gs, wr, kk * 16, lane);
    }
    const float* mrow = kFromProbs ? nullptr : mask + (long long)wi * N;
    const PT* pw = nullptr;
    if constexpr (kFromProbs)
      pw = static_cast<const PT*>(probs) + ((long long)wi * nh + h) * Lq * N;

    // ---- sweep 1 (recompute): each row's max and sum of exps --------------
    float mx[2] = {-3.402823466e38f, -3.402823466e38f}, sm[2] = {0.f, 0.f}, inv[2];
    if constexpr (!kFromProbs) {
#pragma unroll 2
      for (int n0 = 0; n0 < Np; n0 += 16) {
        float s[2][4], b[8], m[4];
        vss::load_bias(b, b_lo, b_hi, n0, t2, N);
        vss::load_mask(m, mrow, n0, t2, N);
        vss::mma_xt<HD>(s, qa, Ks, n0, lane);
        vss::add_bias_mask<true>(s, b, m, n0, t2, N);
        vss::softmax_step(mx, sm, s);
      }
      vss::softmax_rows(mx, sm);
      inv[0] = vss::recip(sm[0]);
      inv[1] = vss::recip(sm[1]);
    }

    // p of the warp's rows x keys [n0, n0 + 16), zero past Lq and N
    const int rc_lo = min(r_lo, Lq - 1), rc_hi = min(r_hi, Lq - 1);
    auto p_step = [&](float (&p)[2][4], int n0) {
      if constexpr (kFromProbs) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int n = n0 + 8 * j + t2 + (e & 1);
            const bool lo = e < 2;
            const float pv = load_p(pw, (long long)(lo ? rc_lo : rc_hi) * N + min(n, N - 1));
            p[j][e] = n < N && (lo ? r_lo : r_hi) < Lq ? pv : 0.f;
          }
      } else {
        float b[8], m[4];
        vss::load_bias(b, b_lo, b_hi, n0, t2, N);
        vss::load_mask(m, mrow, n0, t2, N);
        vss::mma_xt<HD>(p, qa, Ks, n0, lane);
        vss::add_bias_mask<true>(p, b, m, n0, t2, N);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = e < 2 ? r_lo : r_hi;
            p[j][e] = row < Lq ? vss::div_rn(expf(p[j][e] - mx[e >> 1]), sm[e >> 1],
                                             inv[e >> 1])
                               : 0.f;
          }
      }
    };

    // ---- sweep 2: r = sum_n dP p -----------------------------------------
    float r[2] = {0.f, 0.f};
#pragma unroll 2
    for (int n0 = 0; n0 < Np; n0 += 16) {
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

    // ---- sweep 3: ds, dq, dbias; per 64-key tile dV and dK -----------------
    float acc[HD / 8][4];
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
    const bool first = wi == w0;
    for (int t0 = 0; t0 < Np; t0 += kTile) {
      const int steps = min(kTile, Np - t0) / 16;
      for (int u = 0; u < steps; ++u) {
        const int n0 = t0 + 16 * u;
        // the block's dbias so far (the earlier windows' ds), loaded first
        float prev[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            prev[j][e] = first ? 0.f
                               : dbias[(long long)(e < 2 ? rc_lo : rc_hi) * N +
                                       min(n0 + 8 * j + t2 + (e & 1), N - 1)];
        float p[2][4], ds[2][4];
        p_step(p, n0);
        vss::mma_xt<HD>(ds, ga, Vs, n0, lane);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ds[j][e] = p[j][e] * (ds[j][e] - r[e >> 1]);
            const int n = n0 + 8 * j + t2 + (e & 1);
            const int row = e < 2 ? r_lo : r_hi;
            if (n < N && row < Lq) dbias[(long long)row * N + n] = prev[j][e] + ds[j][e];
          }
        const uint32_t pa[4] = {vss::pack_bf16(p[0][0], p[0][1]), vss::pack_bf16(p[0][2], p[0][3]),
                                vss::pack_bf16(p[1][0], p[1][1]), vss::pack_bf16(p[1][2], p[1][3])};
        const uint32_t da[4] = {vss::pack_bf16(ds[0][0], ds[0][1]),
                                vss::pack_bf16(ds[0][2], ds[0][3]),
                                vss::pack_bf16(ds[1][0], ds[1][1]),
                                vss::pack_bf16(ds[1][2], ds[1][3])};
        // dq += bf16(ds) K over these 16 keys
#pragma unroll
        for (int d = 0; d < HD; d += 16) {
          uint32_t b[4];
          vss::load_b<HD>(b, Ks, n0, d, lane);
          vss::mma16816(acc[d / 8], da, b[0], b[1]);
          vss::mma16816(acc[d / 8 + 1], da, b[2], b[3]);
        }
        // the bf16 p and ds of (this warp's rows, these keys) for dV and dK
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = 16 * u + 8 * j + t2;
          *reinterpret_cast<uint32_t*>(Pt + vss::swz<kTile>(r_lo, c)) = pa[2 * j];
          *reinterpret_cast<uint32_t*>(Pt + vss::swz<kTile>(r_hi, c)) = pa[2 * j + 1];
          *reinterpret_cast<uint32_t*>(Dt + vss::swz<kTile>(r_lo, c)) = da[2 * j];
          *reinterpret_cast<uint32_t*>(Dt + vss::swz<kTile>(r_hi, c)) = da[2 * j + 1];
        }
      }
      __syncthreads();
      // warp w: keys t0 + 16w .. + 15 of dV = bf16(p)^T g and dK = bf16(ds)^T qs
      const int m0 = 16 * warp;
      if (m0 < 16 * steps && t0 + m0 < N) {
#pragma unroll
        for (int which = 0; which < 2; ++which) {
          const __nv_bfloat16* X = which == 0 ? Pt : Dt;
          const __nv_bfloat16* Y = which == 0 ? Gs : Qs;
          __nv_bfloat16* dst = (which == 0 ? dv : dk) + (long long)wi * N * C + h * HD;
          float o[HD / 8][4];
#pragma unroll
          for (int d = 0; d < HD / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
#pragma unroll
          for (int k0 = 0; k0 < kRows; k0 += 16) {
            uint32_t a[4];
            vss::load_at<kTile>(a, X, k0, m0, lane);
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
            if (n_lo < N)
              *reinterpret_cast<uint32_t*>(dst + (long long)n_lo * C + d * 8 + t2) =
                  vss::pack_bf16(o[d][0], o[d][1]);
            if (n_hi < N)
              *reinterpret_cast<uint32_t*>(dst + (long long)n_hi * C + d * 8 + t2) =
                  vss::pack_bf16(o[d][2], o[d][3]);
          }
        }
      }
      __syncthreads();  // the tiles are free again
    }

    // ---- dq = bf16(bf16(ds K) * scale) ---------------------------------------
    __nv_bfloat16* dqw = dq + (long long)wi * Lq * C + h * HD;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      if (r_lo < Lq)
        *reinterpret_cast<uint32_t*>(dqw + (long long)r_lo * C + d * 8 + t2) =
            vss::pack_bf16(vss::round_bf16(acc[d][0]) * q_scale,
                           vss::round_bf16(acc[d][1]) * q_scale);
      if (r_hi < Lq)
        *reinterpret_cast<uint32_t*>(dqw + (long long)r_hi * C + d * 8 + t2) =
            vss::pack_bf16(vss::round_bf16(acc[d][2]) * q_scale,
                           vss::round_bf16(acc[d][3]) * q_scale);
    }
  }
}

// the kernel's shared memory, and the largest carveout of the SM for it, so
// that as many blocks as the occupancy calculator counts share an SM
template <int HD, typename PT>
cudaError_t prepare(size_t bytes) {
  cudaError_t e = cudaFuncSetAttribute(attention_bwd_kernel<HD, PT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(attention_bwd_kernel<HD, PT>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int HD, typename PT>
int launch(const void* q, const void* k, const void* v, const void* bias, const void* mask,
           const void* probs, const void* g, void* dq, void* dk, void* dv, void* partial, int G,
           int Lq, int N, int nh, int C, float q_scale, int tw, cudaStream_t s) {
  const size_t bytes = Smem(N, HD).bytes();
  cudaError_t e = prepare<HD, PT>(bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((G + tw - 1) / tw, nh);
  attention_bwd_kernel<HD, PT><<<grid, 32 * kWarps, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
      static_cast<const float*>(mask), probs, static_cast<const __nv_bfloat16*>(g),
      static_cast<__nv_bfloat16*>(dq), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), static_cast<float*>(partial), G, Lq, N, nh, C, q_scale,
      tw);
  return (int)cudaGetLastError();
}

template <int HD, typename PT>
int blocks_per_sm(int N) {
  const size_t bytes = Smem(N, HD).bytes();
  cudaError_t e = prepare<HD, PT>(bytes);
  if (e != cudaSuccess) return -(int)e;
  int n = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, attention_bwd_kernel<HD, PT>,
                                                    32 * kWarps, bytes);
  return e == cudaSuccess ? n : -(int)e;
}

bool valid(int Lq, int N, int tw) { return Lq <= kRows && N >= 1 && tw >= 1; }

}  // namespace

// q/g/dq (G, Lq, C) bf16, k/v/dk/dv (G, N, C) bf16 with C = nh*hd (head h
// owns channels [h*hd, (h+1)*hd)); bias (nh, Lq, N) f32; mask (G, N) f32;
// partial (ceil(G/tw), nh, Lq, N) f32 receives each window tile's dbias.
// hd in {32, 64}, Lq <= 64. q_scale is the attention scale rounded to bf16.
// Returns a cudaError_t.
VSS_EXPORT int attention_bwd(const void* q, const void* k, const void* v, const void* bias,
                             const void* mask, const void* g, void* dq, void* dk, void* dv,
                             void* partial, int G, int Lq, int N, int nh, int hd, int C,
                             float q_scale, int tw, int device, void* stream) {
  vss::use_device(device);
  if (G == 0 || Lq == 0) return 0;
  if (!valid(Lq, N, tw)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch<32, void>(q, k, v, bias, mask, nullptr, g, dq, dk, dv, partial, G, Lq, N, nh, C, q_scale, tw, s);
    case 64: return launch<64, void>(q, k, v, bias, mask, nullptr, g, dq, dk, dv, partial, G, Lq, N, nh, C, q_scale, tw, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The same gradients from the forward's probabilities probs (G, nh, Lq, N),
// bf16 when probs_bf16 else f32, in place of bias and mask.
VSS_EXPORT int attention_bwd_probs(const void* q, const void* k, const void* v,
                                   const void* probs, int probs_bf16, const void* g, void* dq,
                                   void* dk, void* dv, void* partial, int G, int Lq, int N,
                                   int nh, int hd, int C, float q_scale, int tw, int device,
                                   void* stream) {
  vss::use_device(device);
  if (G == 0 || Lq == 0) return 0;
  if (!valid(Lq, N, tw)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define VSS_BWD_P(HD, PT) \
  return launch<HD, PT>(q, k, v, nullptr, nullptr, probs, g, dq, dk, dv, partial, G, Lq, N, nh, C, q_scale, tw, s)
  if (hd == 32 && probs_bf16) VSS_BWD_P(32, __nv_bfloat16);
  if (hd == 32) VSS_BWD_P(32, float);
  if (hd == 64 && probs_bf16) VSS_BWD_P(64, __nv_bfloat16);
  if (hd == 64) VSS_BWD_P(64, float);
#undef VSS_BWD_P
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one block at N keys and head dim hd: the
// wrapper's gate against the card's limit.
VSS_EXPORT int attention_bwd_smem_bytes(int N, int hd) { return (int)Smem(N, hd).bytes(); }

// Blocks of the kernel one SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
// at N keys and head dim hd; mode 0 recomputes the softmax, 1 reads f32
// probabilities, 2 bf16 ones. Minus a cudaError_t on failure.
VSS_EXPORT int attention_bwd_blocks_per_sm(int N, int hd, int mode, int device) {
  vss::use_device(device);
  if (N < 1) return -(int)cudaErrorInvalidValue;
  if (hd == 32 && mode == 0) return blocks_per_sm<32, void>(N);
  if (hd == 32 && mode == 1) return blocks_per_sm<32, float>(N);
  if (hd == 32 && mode == 2) return blocks_per_sm<32, __nv_bfloat16>(N);
  if (hd == 64 && mode == 0) return blocks_per_sm<64, void>(N);
  if (hd == 64 && mode == 1) return blocks_per_sm<64, float>(N);
  if (hd == 64 && mode == 2) return blocks_per_sm<64, __nv_bfloat16>(N);
  return -(int)cudaErrorInvalidValue;
}
