// Row-block GEMM with a fused LayerNorm prologue and a bias / scale /
// residual epilogue:
//
//     out = s_o[f] · ([LN(A) | bf16(s_a[f] · A) | A] · W [+ bias]) [+ res]
//
// (W row-major (K, N), bf16; s_a and s_o optional per-frame scales, frame
// f = row / rows_per_frame.)
//
// Part of the port of the TPU kernels vss_cffm_tpu/ops/stage_block.py:
// mit_block_fused (_kernel) and _mit_block_train_fwd (_train_fwd_kernel),
// which compute a whole MiT block per (frame, row tile) in VMEM. Their
// working set does not fit one H100 block's 227 KB of shared memory at
// stage 3, so on this card the block is a short sequence of hand-written
// launches: this GEMM serves q = LN1(x)·Wq + bq, y = x + s_attn·(ctx·Wproj +
// bproj), hid = LN2(y)·W1 + b1 and out = y + s_ffn·(a·W2 + b2); attention.cu
// serves the softmax(q·(s·K)ᵀ)·V step and dwconv.cu the depthwise conv +
// GELU. The backward's input-gradient products (d_a = bf16(go·s_ffn)·W2ᵀ,
// d_ln2 = d_hid·W1ᵀ, d_ctx = d_attn·Wprojᵀ, d_ln1 = d_q·Wqᵀ, _train_bwd_kernel)
// run here on a transposed copy of the weight, without bias, and so do the
// FFN pairs of vss_cffm_tpu/ops/mixffn.py.
//
// Bound on the H100: bytes. At the MiT shapes (K and N from 64 to 2048) a
// launch does at most ~200 FLOP a byte, below the card's 295, so what sets
// the pace is reading A once and writing out (and the residual) once.
// Design:
//  - A block owns BM = 64 rows and walks all of its column range (the whole
//    of N, or a wide slab of it when the rows alone do not fill the card:
//    block_gemm_plan in ops/stage_block.py) in slabs of BN = 64 or 128
//    columns, so A is read from device memory once per row block.
//  - "Resident" A (LayerNorm, a scaled A, or an f32 A; K <= 512): the block
//    reads its BM x K rows once into registers (two groups of rows in
//    flight a warp), computes the LayerNorm statistics there with the
//    reference's two passes (f32 mean, then the mean squared deviation,
//    rsqrtf(var + eps)), and writes the normalised (or scaled) rows to
//    shared memory in bf16, XOR-swizzled in 64-column chunks; the K loop
//    then streams only W. gamma / beta are read only when LN is on.
//  - "Streamed" A (a plain bf16 A, any K): A's tiles go through the same
//    cp.async ring as W's.
//  - W (at most 2 MB, resident in L2) streams through a 3-stage cp.async
//    ring of BK x BN tiles; the ring runs on across slabs, so one slab's
//    epilogue overlaps the next slab's loads.
//  - Tensor cores: mma.sync m16n8k16 (bf16 in, f32 accumulation) with
//    ldmatrix from the swizzled tiles (csrc/mma_sync.cuh); 4 warps, each a
//    32 x BN/2 sub-tile; registers capped for 3 blocks an SM.
//  - The epilogue runs from the accumulators' registers: the four lanes of
//    a quad trade the values of four n8 tiles by shuffles, so that each
//    holds 8 neighbouring columns of one row, then f32 bias, the per-frame
//    scale, the bf16 or f32 residual and the output in its dtype, 16 bytes
//    (bf16) or 32 (f32) a lane. No staging tile. (Two columns a lane, the
//    accumulators' own layout, measured 7-12 % slower a step and a clip.)
// Rounding points are the reference's: LN in f32, bf16 before the product,
// f32 accumulation, output dtype per launch. No atomics, no split K: every
// output element is one f32 sum in a fixed order, so runs repeat bit for
// bit.
#include "common.cuh"
#include "mma_sync.cuh"

namespace {

constexpr int BM = 64, BK = 32, THREADS = 128, STAGES = 3;
// resident A: BM x 512 bf16 = 64 KB of shared memory
constexpr int KMAX_RES = 512;

// tag types: the forward's and the backward's launches get their own kernel
// names, so that a profile tells them apart
struct Fwd {};
struct Bwd {};

__host__ __device__ constexpr int round_up(int a, int b) { return (a + b - 1) / b * b; }

// shared memory of one block: resident A (64-column chunks) or the A ring,
// and the W ring
__host__ __device__ inline int smem_bytes(int K, bool res, int nb) {
  const int w_ring = STAGES * BK * 64 * nb * 2;
  const int a = res ? round_up(K, 64) * BM * 2 : STAGES * BM * BK * 2;
  return a + w_ring;
}

struct Args {
  const void* A;
  const float* gamma;
  const float* beta;
  const __nv_bfloat16* W;
  const float* bias;
  const void* res;
  const float* a_scale;
  const float* o_scale;
  void* out;
  int M, N, K, ln, res_kind, out_f32, rows_per_frame, cols_per_block;
  float eps;
};

// The resident-A prologue: the block's rows of A → [LN | scale | as is] →
// bf16 in shared memory, chunk kc of 64 columns at As + kc*BM*64 (swz<64>),
// zeros past K and past M. A row's K/8 chunks of 8 lie on LPR lanes (at most
// two a lane), so a warp works on 32/LPR rows at once, two such groups of
// rows in flight; the statistics are reduced over the LPR lanes. (Copying
// the rows in by cp.async first, all in flight, and taking the statistics
// from shared memory measured 10-30 % slower on the LayerNorm launches.)
template <typename TA>
__device__ void fill_resident(const Args& p, __nv_bfloat16* As, long long m0) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const TA* A = static_cast<const TA*>(p.A);
  const int K = p.K, kc8 = K / 8, kp = round_up(K, 64);
  int lpr = 1;
  while (lpr < 32 && lpr * 2 <= kc8) lpr *= 2;  // K <= 512: at most two chunks a lane
  const int rpw = 32 / lpr;                     // rows a warp holds at once
  const int sub = lane / lpr, sl = lane % lpr;  // this lane's chunks: sl, sl + lpr
  float gm[2][8], bt[2][8];
  if (p.ln) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int ck = sl + q * lpr;
      if (ck < kc8) {
        vss::load8(p.gamma + ck * 8, gm[q]);
        vss::load8(p.beta + ck * 8, bt[q]);
      }
    }
  }
  constexpr int U = 2;  // groups of rows in flight
  for (int r0 = warp * rpw * U; r0 < BM; r0 += 4 * rpw * U) {
    float v[U][2][8];
    bool live[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + u * rpw + sub;
      const long long gm_row = m0 + r;
      live[u] = r < BM && gm_row < p.M;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int ck = sl + q * lpr;
        if (live[u] && ck < kc8) {
          vss::load8(A + gm_row * K + ck * 8, v[u][q]);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) v[u][q][i] = 0.f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + u * rpw + sub;
      if (p.ln) {
        float sum = 0.f;
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int i = 0; i < 8; ++i) sum += v[u][q][i];
        for (int o = lpr / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        const float mean = sum / K;
        float sq = 0.f;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (sl + q * lpr < kc8) {
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float d = v[u][q][i] - mean;
              sq += d * d;
            }
          }
        }
        for (int o = lpr / 2; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
        const float rstd = rsqrtf(sq / K + p.eps);
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int i = 0; i < 8; ++i)
            v[u][q][i] = (v[u][q][i] - mean) * rstd * gm[q][i] + bt[q][i];
      } else if (p.a_scale != nullptr && live[u]) {
        const float sc = p.a_scale[(m0 + r) / p.rows_per_frame];
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int i = 0; i < 8; ++i) v[u][q][i] = v[u][q][i] * sc;
      }
      if (r < BM) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int ck = sl + q * lpr;
          if (ck < kc8) {
            if (!live[u]) {
#pragma unroll
              for (int i = 0; i < 8; ++i) v[u][q][i] = 0.f;
            }
            const int k = ck * 8;
            vss::store8(As + (k / 64) * BM * 64 + vss::swz<64>(r, k % 64), v[u][q]);
          }
        }
      }
    }
  }
  // zeros in the last chunk past K (the K loop's last step may read them)
  for (int i = tid; i < BM * (kp - K) / 8; i += THREADS) {
    const int r = i / ((kp - K) / 8), k = K + (i % ((kp - K) / 8)) * 8;
    vss::zero16(As + (k / 64) * BM * 64 + vss::swz<64>(r, k % 64));
  }
}

template <typename Tag, typename TA, bool RES, int NB>
__global__ void __launch_bounds__(THREADS, 3) gemm_kernel(const Args p) {
  constexpr int BN = 64 * NB;
  constexpr int NT = 4 * NB;  // n8 tiles of a warp (32 x BN/2)
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;
  const int g = lane / 4, t4 = lane % 4;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n_lo = blockIdx.y * p.cols_per_block;
  const int n_hi = min(p.N, n_lo + p.cols_per_block);
  const int K = p.K, N = p.N;
  const int kt = (K + BK - 1) / BK;
  const int slabs = (n_hi - n_lo + BN - 1) / BN;
  const int total = slabs * kt;

  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ws = As + (RES ? round_up(K, 64) * BM : STAGES * BM * BK);
  const __nv_bfloat16* Ab = static_cast<const __nv_bfloat16*>(p.A);

  // tile i of the (slab, k step) sequence into ring stage st
  auto load_tile = [&](int i, int st) {
    if (i < total) {
      const int sl = i / kt, k0 = (i % kt) * BK, c0 = n_lo + sl * BN;
      __nv_bfloat16* wdst = Ws + st * BK * BN;
#pragma unroll
      for (int u = 0; u < BK * BN / 8 / THREADS; ++u) {
        const int c = tid + u * THREADS;
        const int r = c / (BN / 8), col = (c % (BN / 8)) * 8;
        const int gk = k0 + r, gn = c0 + col;
        __nv_bfloat16* d = wdst + (col / 64) * BK * 64 + vss::swz<64>(r, col % 64);
        if (gk < K && gn < n_hi)
          vss::cp_async16(d, p.W + (long long)gk * N + gn);
        else
          vss::zero16(d);
      }
      if constexpr (!RES) {
        __nv_bfloat16* adst = As + st * BM * BK;
#pragma unroll
        for (int u = 0; u < BM * BK / 8 / THREADS; ++u) {
          const int c = tid + u * THREADS;
          const int r = c / (BK / 8), col = (c % (BK / 8)) * 8;
          const long long gm = m0 + r;
          __nv_bfloat16* d = adst + vss::swz<32>(r, col);
          if (gm < p.M && k0 + col < K)
            vss::cp_async16(d, Ab + gm * K + k0 + col);
          else
            vss::zero16(d);
        }
      }
    }
    vss::cp_async_commit();
  };

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) load_tile(i, i);
  if constexpr (RES) fill_resident<TA>(p, As, m0);

  float acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int i = 0; i < total; ++i) {
    vss::cp_async_wait<STAGES - 2>();
    __syncthreads();
    load_tile(i + STAGES - 1, (i + STAGES - 1) % STAGES);
    const int st = i % STAGES, ks = i % kt;
    const __nv_bfloat16* wt = Ws + st * BK * BN;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r0 = wm * 32 + mi * 16;
        if constexpr (RES) {
          const int k = ks * BK + kk;
          vss::load_a<64>(af[mi], As + (k / 64) * BM * 64, r0, k % 64, lane);
        } else {
          vss::load_a<32>(af[mi], As + st * BM * BK, r0, kk, lane);
        }
      }
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        const int col = wn * (BN / 2) + jp * 16;
        uint32_t b[4];
        vss::load_b<64>(b, wt + (col / 64) * BK * 64, kk, col % 64, lane);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          vss::mma16816(acc[mi][2 * jp], af[mi], b[0], b[1]);
          vss::mma16816(acc[mi][2 * jp + 1], af[mi], b[2], b[3]);
        }
      }
    }
    if (ks == kt - 1) {
      // the slab's epilogue: the four lanes of a quad trade the values of
      // four n8 tiles so that each holds 8 neighbouring columns of one row
      const int c0 = n_lo + (i / kt) * BN + wn * (BN / 2);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const long long gm = m0 + wm * 32 + mi * 16 + g + hf * 8;
          const float sc = (p.o_scale != nullptr && gm < p.M) ? p.o_scale[gm / p.rows_per_frame] : 1.f;
#pragma unroll
          for (int jq = 0; jq < NT / 4; ++jq) {
            float y[8];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int give = (t4 - r) & 3, src = (t4 + r) & 3;
              float gx = 0.f, gy = 0.f;
#pragma unroll
              for (int q = 0; q < 4; ++q)
                if (q == give) {
                  gx = acc[mi][4 * jq + q][2 * hf];
                  gy = acc[mi][4 * jq + q][2 * hf + 1];
                }
              const float rx = __shfl_sync(0xffffffffu, gx, (lane & ~3) | src);
              const float ry = __shfl_sync(0xffffffffu, gy, (lane & ~3) | src);
#pragma unroll
              for (int q = 0; q < 4; ++q)
                if (q == src) {
                  y[2 * q] = rx;
                  y[2 * q + 1] = ry;
                }
            }
            const int gn = c0 + (4 * jq + t4) * 8;
            if (gm >= p.M || gn >= n_hi) continue;
            if (p.bias != nullptr) {
              float bb[8];
              vss::load8(p.bias + gn, bb);
#pragma unroll
              for (int e = 0; e < 8; ++e) y[e] = y[e] + bb[e];
            }
            if (p.o_scale != nullptr) {
#pragma unroll
              for (int e = 0; e < 8; ++e) y[e] = y[e] * sc;
            }
            const long long off = gm * N + gn;
            if (p.res_kind) {
              float rv[8];
              if (p.res_kind == 1)
                vss::load8(static_cast<const __nv_bfloat16*>(p.res) + off, rv);
              else
                vss::load8(static_cast<const float*>(p.res) + off, rv);
#pragma unroll
              for (int e = 0; e < 8; ++e) y[e] = y[e] + rv[e];
            }
            if (p.out_f32)
              vss::store8(static_cast<float*>(p.out) + off, y);
            else
              vss::store8(static_cast<__nv_bfloat16*>(p.out) + off, y);
          }
        }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          acc[mi][j][0] = acc[mi][j][1] = acc[mi][j][2] = acc[mi][j][3] = 0.f;
    }
  }
  vss::cp_async_wait<0>();
}

template <typename Tag, typename TA, bool RES, int NB>
int launch(const Args& a, cudaStream_t st) {
  const int bytes = smem_bytes(a.K, RES, NB);
  static bool attr = false;  // one instance per template: set its limit once
  if (!attr) {
    // 200 KB: above the largest block (f32 rows at K 512: 160 KB), below the
    // card's 227 KB less the kernel's static statistics
    cudaError_t e = cudaFuncSetAttribute(gemm_kernel<Tag, TA, RES, NB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, 200 * 1024);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  dim3 grid((unsigned)((a.M + BM - 1) / BM), (unsigned)((a.N + a.cols_per_block - 1) /
                                                        a.cols_per_block));
  gemm_kernel<Tag, TA, RES, NB><<<grid, THREADS, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename Tag>
int launch_tag(const Args& a, int a_f32, bool res, int nb, cudaStream_t st) {
  if (a_f32) {
    if (!res) return (int)cudaErrorInvalidValue;
    return nb == 1 ? launch<Tag, float, true, 1>(a, st) : launch<Tag, float, true, 2>(a, st);
  }
  if (res)
    return nb == 1 ? launch<Tag, __nv_bfloat16, true, 1>(a, st)
                   : launch<Tag, __nv_bfloat16, true, 2>(a, st);
  return nb == 1 ? launch<Tag, __nv_bfloat16, false, 1>(a, st)
                 : launch<Tag, __nv_bfloat16, false, 2>(a, st);
}

}  // namespace

// Shared memory (bytes) of one block at depth K: resident A (res != 0) or the
// streamed A ring, and the W ring, with nb (1 or 2) 64-column W chunks.
VSS_EXPORT int gemm_smem_bytes(int K, int res, int nb) { return smem_bytes(K, res != 0, nb); }

// A (M, K) bf16 or f32 (a_f32); gamma/beta (K,) f32, read when ln != 0;
// W (K, N) bf16 row-major; bias (N,) f32 or null; res (M, N): none
// (res_kind 0), bf16 (1) or f32 (2); a_scale / o_scale (ceil(M /
// rows_per_frame),) f32 or null (a_scale is not read when ln != 0); out
// (M, N) bf16 or f32 (out_f32). A is resident (ln, a_scale or an f32 A,
// then K <= 512) or streamed (a plain bf16 A). Blocks of 64 rows, each over
// cols_per_block columns (a multiple of 64 * nb) in slabs of 64 * nb;
// bwd != 0 launches the backward's instance (the same code under its own
// name). K % 8 == 0 and N % 8 == 0, pointers 16-byte aligned (checked by the
// Python wrapper). Returns a cudaError_t.
VSS_EXPORT int gemm_ln_bias_res(const void* A, const void* gamma, const void* beta,
                                const void* W, const void* bias, const void* res,
                                const void* a_scale, const void* o_scale, void* out, int M,
                                int N, int K, int a_f32, int ln, int res_kind, int out_f32,
                                int rows_per_frame, float eps, int nb, int cols_per_block,
                                int bwd, int device, void* stream) {
  vss::use_device(device);
  if (M == 0 || N == 0) return 0;
  const bool resident = ln || a_scale != nullptr || a_f32;
  if ((resident && K > KMAX_RES) || rows_per_frame < 1 || (nb != 1 && nb != 2) ||
      cols_per_block < 64 * nb || cols_per_block % (64 * nb) || K % 8 || N % 8 || K < 8)
    return (int)cudaErrorInvalidValue;
  Args a{A,
         static_cast<const float*>(gamma),
         static_cast<const float*>(beta),
         static_cast<const __nv_bfloat16*>(W),
         static_cast<const float*>(bias),
         res,
         static_cast<const float*>(a_scale),
         static_cast<const float*>(o_scale),
         out,
         M, N, K, ln, res_kind, out_f32, rows_per_frame, cols_per_block, eps};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return bwd ? launch_tag<Bwd>(a, a_f32, resident, nb, s)
             : launch_tag<Fwd>(a, a_f32, resident, nb, s);
}
