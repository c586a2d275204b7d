// Row and pixel passes of the MiT block's backward: the depthwise conv +
// GELU backward and the LayerNorm backward, each with its parameter sums.
//
// Part of the port of the TPU kernels vss_cffm_tpu/ops/stage_block.py:
// _mit_block_train_bwd (_train_bwd_kernel) and vss_cffm_tpu/ops/mixffn.py:
// _block_ffn_bwd_pallas (_bwd_kernel_ln), which do this work per (frame, row
// tile) in VMEM between their products (the products are block_gemm.cu,
// gemm_tn.cu and sra_attention_bwd.cu). Three entry points:
//
//   dgelu_dz  z = dw3x3(hid) + bdw recomputed in f32 (zero outside the
//             image), d_z = d_a · GELU'(z) (exact erff), and per block the
//             partial sums of the 9 depthwise taps Σ hid(shifted)·d_z and of
//             Σ d_z (dkdw, dbdw);
//   dwconv_t  d_hid = the transposed depthwise conv of d_z, rounded to
//             bf16, and the partial sums Σ d_hid (db1, of the f32 values);
//   ln_bwd    per row of (M, C): the LayerNorm's f32 statistics of its input
//             recomputed, dx = res + rsig·(dly − mean(dly) − x̂·mean(dly·x̂))
//             with dly = dl·γ, the rounded LN output x̂·γ + β (bf16, an input
//             of a weight gradient), optionally dx·s_out rounded (the
//             attention branch's cotangent), and the partial sums Σ dl·x̂,
//             Σ dl, Σ dx·s_out, Σ res·s_res (dγ, dβ, dbproj, db2).
//
// Bound on the H100: memory (a few f32 maps of the block read and written
// once, 9 to 20 flops per element). Design: the depthwise passes give one
// thread one channel of a run of pixels, so a warp reads 32 neighbouring
// channels of a pixel (coalesced) and the thread's tap sums stay in
// registers; the 9 neighbours of a pixel come from L1/L2. The LayerNorm pass
// gives one warp one row (C <= 512, a lane holding channels lane + 32·i).
// No atomics: every block writes its own partial sums, which the wrapper
// reduces with one torch.sum, so results repeat exactly; inside a block the
// warps' sums are added in a fixed order.
#include "common.cuh"

namespace {

constexpr int PIX_THREADS = 256;
constexpr int LN_WARPS = 4;
constexpr int LN_MAXI = 16;  // C <= 32 * LN_MAXI

__device__ __forceinline__ float gelu_grad(float z) {
  const float phi = expf(-0.5f * z * z) * 0.3989422804014327f;
  return 0.5f * (1.0f + erff(z * 0.7071067811865476f)) + z * phi;
}

__global__ void __launch_bounds__(PIX_THREADS) dgelu_dz_kernel(
    const float* __restrict__ d_a, const float* __restrict__ hid, const float* __restrict__ wk,
    const float* __restrict__ bdw, float* __restrict__ d_z, float* __restrict__ partial, int H,
    int W, int C, long long M, int per) {
  const int c = blockIdx.y * PIX_THREADS + threadIdx.x;
  if (c >= C) return;
  float k[9], tap[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    k[t] = wk[t * C + c];
    tap[t] = 0.f;
  }
  const float bb = bdw[c];
  float sdz = 0.f;
  const long long p0 = (long long)blockIdx.x * per;
  const long long p1 = min(M, p0 + per);
  for (long long p = p0; p < p1; ++p) {
    const int j = (int)(p % W);
    const long long t = p / W;
    const int i = (int)(t % H);
    const long long f = t / H;
    float hv[9];
    float z = 0.f;
#pragma unroll
    for (int di = 0; di < 3; ++di) {
#pragma unroll
      for (int dj = 0; dj < 3; ++dj) {
        const int ii = i + di - 1, jj = j + dj - 1;
        const float v = (ii >= 0 && ii < H && jj >= 0 && jj < W)
                            ? hid[((f * H + ii) * W + jj) * C + c] : 0.f;
        hv[di * 3 + dj] = v;
        z += v * k[di * 3 + dj];
      }
    }
    z += bb;
    const float g = d_a[p * C + c] * gelu_grad(z);
    d_z[p * C + c] = g;
#pragma unroll
    for (int t9 = 0; t9 < 9; ++t9) tap[t9] += hv[t9] * g;
    sdz += g;
  }
  float* out = partial + (long long)blockIdx.x * 10 * C + c;
#pragma unroll
  for (int t = 0; t < 9; ++t) out[t * C] = tap[t];
  out[9 * C] = sdz;
}

__global__ void __launch_bounds__(PIX_THREADS) dwconv_t_kernel(
    const float* __restrict__ d_z, const float* __restrict__ wk,
    __nv_bfloat16* __restrict__ d_hid, float* __restrict__ partial, int H, int W, int C,
    long long M, int per) {
  const int c = blockIdx.y * PIX_THREADS + threadIdx.x;
  if (c >= C) return;
  float k[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) k[t] = wk[t * C + c];
  float sum = 0.f;
  const long long p0 = (long long)blockIdx.x * per;
  const long long p1 = min(M, p0 + per);
  for (long long p = p0; p < p1; ++p) {
    const int j = (int)(p % W);
    const long long t = p / W;
    const int i = (int)(t % H);
    const long long f = t / H;
    float acc = 0.f;
#pragma unroll
    for (int dj = 0; dj < 3; ++dj) {
#pragma unroll
      for (int di = 0; di < 3; ++di) {
        const int ii = i + 1 - di, jj = j + 1 - dj;
        if (ii >= 0 && ii < H && jj >= 0 && jj < W)
          acc += d_z[((f * H + ii) * W + jj) * C + c] * k[di * 3 + dj];
      }
    }
    d_hid[p * C + c] = __float2bfloat16_rn(acc);
    sum += acc;
  }
  partial[(long long)blockIdx.x * C + c] = sum;
}

template <typename T>
__device__ __forceinline__ float ld(const T* p, long long i) {
  return static_cast<float>(p[i]);
}
template <>
__device__ __forceinline__ float ld<__nv_bfloat16>(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}

template <typename TX, typename TR, typename TD>
__global__ void __launch_bounds__(32 * LN_WARPS) ln_bwd_kernel(
    const float* __restrict__ dl, const TX* __restrict__ xin, const float* __restrict__ gamma,
    const float* __restrict__ beta, const TR* __restrict__ res, const float* __restrict__ s_out,
    const float* __restrict__ s_res, TD* __restrict__ dx, __nv_bfloat16* __restrict__ ln,
    __nv_bfloat16* __restrict__ dxs, float* __restrict__ partial, long long M, int C,
    int rows_per_frame, int per, float eps) {
  __shared__ float red[LN_WARPS][4][32 * LN_MAXI];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float g[LN_MAXI], bt[LN_MAXI], a_dg[LN_MAXI], a_dbe[LN_MAXI], a_sdx[LN_MAXI],
      a_sres[LN_MAXI];
#pragma unroll
  for (int u = 0; u < LN_MAXI; ++u) {
    const int c = lane + 32 * u;
    g[u] = c < C ? gamma[c] : 0.f;
    bt[u] = c < C ? beta[c] : 0.f;
    a_dg[u] = a_dbe[u] = a_sdx[u] = a_sres[u] = 0.f;
  }
  const long long r0 = (long long)blockIdx.x * per;
  const long long r1 = min(M, r0 + per);
  for (long long row = r0 + warp; row < r1; row += LN_WARPS) {
    float xv[LN_MAXI], dv[LN_MAXI];
    float s = 0.f;
#pragma unroll
    for (int u = 0; u < LN_MAXI; ++u) {
      const int c = lane + 32 * u;
      xv[u] = c < C ? ld(xin, row * C + c) : 0.f;
      dv[u] = c < C ? dl[row * C + c] : 0.f;
      s += xv[u];
    }
    const float mu = vss::warp_sum(s) / C;
    s = 0.f;
#pragma unroll
    for (int u = 0; u < LN_MAXI; ++u) {
      const float d = lane + 32 * u < C ? xv[u] - mu : 0.f;
      s += d * d;
    }
    const float rsig = rsqrtf(vss::warp_sum(s) / C + eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int u = 0; u < LN_MAXI; ++u) {
      xv[u] = (xv[u] - mu) * rsig;  // x̂
      const float dly = dv[u] * g[u];
      s1 += dly;
      s2 += dly * xv[u];
    }
    const float m1 = vss::warp_sum(s1) / C, m2 = vss::warp_sum(s2) / C;
    const float so = s_out != nullptr ? s_out[row / rows_per_frame] : 0.f;
    const float sr = s_res != nullptr ? s_res[row / rows_per_frame] : 0.f;
#pragma unroll
    for (int u = 0; u < LN_MAXI; ++u) {
      const int c = lane + 32 * u;
      if (c >= C) continue;
      const float dly = dv[u] * g[u];
      const float rv = ld(res, row * C + c);
      const float d = rv + rsig * (dly - m1 - xv[u] * m2);
      if constexpr (sizeof(TD) == 4)
        dx[row * C + c] = d;
      else
        dx[row * C + c] = __float2bfloat16_rn(d);
      ln[row * C + c] = __float2bfloat16_rn(xv[u] * g[u] + bt[u]);
      a_dg[u] += dv[u] * xv[u];
      a_dbe[u] += dv[u];
      if (s_out != nullptr) {
        const float ds = d * so;
        dxs[row * C + c] = __float2bfloat16_rn(ds);
        a_sdx[u] += ds;
      }
      if (s_res != nullptr) a_sres[u] += rv * sr;
    }
  }
#pragma unroll
  for (int u = 0; u < LN_MAXI; ++u) {
    const int c = lane + 32 * u;
    if (c >= C) continue;
    red[warp][0][c] = a_dg[u];
    red[warp][1][c] = a_dbe[u];
    red[warp][2][c] = a_sdx[u];
    red[warp][3][c] = a_sres[u];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 4 * C; e += 32 * LN_WARPS) {
    const int q = e / C, c = e % C;
    float v = 0.f;
    for (int w = 0; w < LN_WARPS; ++w) v += red[w][q][c];
    partial[(long long)blockIdx.x * 4 * C + e] = v;
  }
}

template <typename TX, typename TR>
int launch_ln(const float* dl, const void* xin, const float* g, const float* b, const void* res,
              const float* so, const float* sr, void* dx, int dx_f32, __nv_bfloat16* ln,
              __nv_bfloat16* dxs, float* partial, long long M, int C, int rpf, int per,
              float eps, cudaStream_t s) {
  const unsigned blocks = (unsigned)((M + per - 1) / per);
  const TX* x = static_cast<const TX*>(xin);
  const TR* r = static_cast<const TR*>(res);
  if (dx_f32)
    ln_bwd_kernel<TX, TR, float><<<blocks, 32 * LN_WARPS, 0, s>>>(
        dl, x, g, b, r, so, sr, static_cast<float*>(dx), ln, dxs, partial, M, C, rpf, per, eps);
  else
    ln_bwd_kernel<TX, TR, __nv_bfloat16><<<blocks, 32 * LN_WARPS, 0, s>>>(
        dl, x, g, b, r, so, sr, static_cast<__nv_bfloat16*>(dx), ln, dxs, partial, M, C, rpf,
        per, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// d_a, hid, d_z (B, H, W, C) f32; wk (9, C) f32 taps in (di, dj) order; bdw
// (C,) f32; partial (ceil(B·H·W / per), 10, C) f32: the 9 tap sums, then
// Σ d_z. Returns a cudaError_t.
VSS_EXPORT int dgelu_dz(const void* d_a, const void* hid, const void* wk, const void* bdw,
                        void* d_z, void* partial, int B, int H, int W, int C, int per,
                        int device, void* stream) {
  cudaSetDevice(device);
  const long long M = (long long)B * H * W;
  if (M == 0 || C == 0) return 0;
  if (per < 1) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((M + per - 1) / per), (C + PIX_THREADS - 1) / PIX_THREADS);
  dgelu_dz_kernel<<<grid, PIX_THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d_a), static_cast<const float*>(hid),
      static_cast<const float*>(wk), static_cast<const float*>(bdw), static_cast<float*>(d_z),
      static_cast<float*>(partial), H, W, C, M, per);
  return (int)cudaGetLastError();
}

// d_z (B, H, W, C) f32; wk (9, C) f32; d_hid (B, H, W, C) bf16; partial
// (ceil(B·H·W / per), C) f32. Returns a cudaError_t.
VSS_EXPORT int dwconv_t(const void* d_z, const void* wk, void* d_hid, void* partial, int B,
                        int H, int W, int C, int per, int device, void* stream) {
  cudaSetDevice(device);
  const long long M = (long long)B * H * W;
  if (M == 0 || C == 0) return 0;
  if (per < 1) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((M + per - 1) / per), (C + PIX_THREADS - 1) / PIX_THREADS);
  dwconv_t_kernel<<<grid, PIX_THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d_z), static_cast<const float*>(wk),
      static_cast<__nv_bfloat16*>(d_hid), static_cast<float*>(partial), H, W, C, M, per);
  return (int)cudaGetLastError();
}

// dl (M, C) f32; xin (M, C) bf16 or f32 (xin_f32); gamma, beta (C,) f32; res
// (M, C) bf16 or f32 (res_f32); s_out, s_res (ceil(M / rows_per_frame),) f32
// or null; dx (M, C) f32 or bf16 (dx_f32); ln (M, C) bf16; dxs (M, C) bf16,
// written when s_out is given; partial (ceil(M / per), 4, C) f32: Σ dl·x̂,
// Σ dl, Σ dx·s_out, Σ res·s_res (0 where the scale is absent). C <= 512.
// Returns a cudaError_t.
VSS_EXPORT int ln_bwd(const void* dl, const void* xin, const void* gamma, const void* beta,
                      const void* res, const void* s_out, const void* s_res, void* dx, void* ln,
                      void* dxs, void* partial, int M, int C, int xin_f32, int res_f32,
                      int dx_f32, int rows_per_frame, int per, float eps, int device,
                      void* stream) {
  cudaSetDevice(device);
  if (M == 0 || C == 0) return 0;
  if (C > 32 * LN_MAXI || per < 1 || rows_per_frame < 1 || (s_out != nullptr && dxs == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(dl);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  const float* so = static_cast<const float*>(s_out);
  const float* sr = static_cast<const float*>(s_res);
  __nv_bfloat16* l = static_cast<__nv_bfloat16*>(ln);
  __nv_bfloat16* xs = static_cast<__nv_bfloat16*>(dxs);
  float* p = static_cast<float*>(partial);
  if (xin_f32 && res_f32)
    return launch_ln<float, float>(d, xin, g, b, res, so, sr, dx, dx_f32, l, xs, p, M, C,
                                   rows_per_frame, per, eps, s);
  if (xin_f32)
    return launch_ln<float, __nv_bfloat16>(d, xin, g, b, res, so, sr, dx, dx_f32, l, xs, p, M,
                                           C, rows_per_frame, per, eps, s);
  if (res_f32)
    return launch_ln<__nv_bfloat16, float>(d, xin, g, b, res, so, sr, dx, dx_f32, l, xs, p, M,
                                           C, rows_per_frame, per, eps, s);
  return launch_ln<__nv_bfloat16, __nv_bfloat16>(d, xin, g, b, res, so, sr, dx, dx_f32, l, xs,
                                                 p, M, C, rows_per_frame, per, eps, s);
}
