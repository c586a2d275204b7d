// Row and pixel passes of the MiT block's backward: the depthwise conv +
// GELU backward and the LayerNorm backward, each with its parameter sums.
//
// Part of the port of the TPU kernels vss_cffm_tpu/ops/stage_block.py:
// _mit_block_train_bwd (_train_bwd_kernel) and vss_cffm_tpu/ops/mixffn.py:
// _block_ffn_bwd_pallas (_bwd_kernel_ln), which do this work per (frame, row
// tile) in VMEM between their products (the products are block_gemm.cu,
// gemm_tn.cu and sra_attention_bwd.cu). Two entry points:
//
//   dz_dhid   z = dw3x3(hid) + bdw recomputed in f32 (zero outside the
//             image), d_z = d_a · GELU'(z) (exact erff), kept on chip in f32,
//             d_hid = the transposed depthwise conv of d_z, rounded to bf16,
//             and per block the partial sums of the 9 depthwise taps
//             Σ hid(shifted)·d_z, of Σ d_z and of Σ d_hid (dkdw, dbdw, db1,
//             of the f32 values);
//   ln_bwd    per row of (M, C): the LayerNorm's f32 statistics of its input
//             recomputed, dx = res + rsig·(dly − mean(dly) − x̂·mean(dly·x̂))
//             with dly = dl·γ, the rounded LN output x̂·γ + β (bf16, an input
//             of a weight gradient), optionally dx·s_out rounded (the
//             attention branch's cotangent), and the partial sums Σ dl·x̂,
//             Σ dl, Σ dx·s_out, Σ res·s_res (dγ, dβ, dbproj, db2).
//
// Bound on the H100: memory (a few f32 maps of the block read and written
// once, 9 to 40 flops per element; dz_dhid's ~80 instructions an element
// with erff and expf make it bound by instruction issue first). dz_dhid
// reads d_a and hid (f32) and writes d_hid (bf16) once: d_z, f32 in the
// reference, stays on chip (split over two launches it would cost 2 x 4
// bytes an element of device memory traffic). Its tiles of 8 columns x a
// strip of rows recompute z and d_z on a one-pixel halo (1.25 x the
// columns, (rows + 2) / rows the rows); a warp reads 64 neighbouring
// channels of a pixel (256 bytes, coalesced; a lane two channels, 8 bytes).
// The LayerNorm pass gives one warp one row (C <= 512, a lane holding
// channels lane + 32·i).
// No atomics: every block writes its own partial sums, which the wrapper
// reduces with one torch.sum, so results repeat exactly; inside a block the
// warps' sums are added in a fixed order.
#include "common.cuh"

namespace {

constexpr int kTileW = 8;  // owned columns of a d_z -> d_hid block
constexpr int LN_WARPS = 4;
constexpr int LN_MAXI = 16;  // C <= 32 * LN_MAXI

__device__ __forceinline__ float gelu_grad(float z) {
  const float phi = expf(-0.5f * z * z) * 0.3989422804014327f;
  return 0.5f * (1.0f + erff(z * 0.7071067811865476f)) + z * phi;
}

// d_z and d_hid in one pass. A block owns a tile of TW columns x rows
// [i0, i1) of one frame and 64 channels; warp w is column j0 - 1 + w (the TW
// owned columns and one halo column each side), lane l channels 2l, 2l + 1
// (8-byte loads: a warp reads 256 contiguous bytes of a pixel). It walks
// down the rows r = i0 - 1 .. i1: z(r) = dw3x3(hid) + bdw from a 3x3 window
// of hid that rolls down in registers (one new row of 3 loads per step),
// d_z(r) = d_a(r)·GELU'(z) into a ring of 4 rows of d_z in shared memory
// (zero outside the image), then, once d_z(r) of every column is there,
// d_hid(r - 1) = dw3x3^T(d_z) of the owned columns from the ring. With 4
// slots one barrier a row suffices: the slot written at r + 1 is none of the
// three read at r. Only owned pixels add to the tap, Σ d_z and Σ d_hid
// partials, so the halo's recompute never counts a pixel twice. Offsets
// inside a frame are 32-bit and the column offsets and their validity are
// computed once (the pass is bound by its instructions, not its bytes).
template <int TW>
__global__ void __launch_bounds__(32 * (TW + 2), 2) dz_dhid_kernel(
    const float* __restrict__ d_a, const float* __restrict__ hid, const float* __restrict__ wk,
    const float* __restrict__ bdw, __nv_bfloat16* __restrict__ d_hid,
    float* __restrict__ partial, int H, int W, int C, int rows, int strips, int ctiles) {
  __shared__ float2 ring[4][TW + 2][32];
  __shared__ float2 red[TW][11][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the channel slab varies fastest over the blocks, so that the blocks of
  // one tile's slabs run together and read each pixel's channels in one pass
  const int slabs = (C + 63) / 64, slab = blockIdx.x % slabs;
  const int tile = blockIdx.x / slabs;
  const int c = slab * 64 + 2 * lane;
  const bool live = c < C;
  const int cc = live ? c : 0;
  int t = tile;
  const int ct = t % ctiles;
  t /= ctiles;
  const int strip = t % strips;
  const long long f = t / strips;
  const int i0 = strip * rows, i1 = min(H, i0 + rows);
  const int j0 = ct * TW, col = j0 - 1 + warp;
  const bool interior = warp >= 1 && warp <= TW && col < W;
  const bool col_in = col >= 0 && col < W;
  const long long fbase = f * H * W * C;
  const float* hf = hid + fbase;
  const float* af = d_a + fbase;
  const int rstride = W * C;

  float2 k[9];
#pragma unroll
  for (int q = 0; q < 9; ++q) k[q] = *reinterpret_cast<const float2*>(wk + q * C + cc);
  const float2 bb = *reinterpret_cast<const float2*>(bdw + cc);
  int coff[3];
  bool cok[3];
#pragma unroll
  for (int dj = 0; dj < 3; ++dj) {
    const int jj = col - 1 + dj;
    cok[dj] = jj >= 0 && jj < W;
    coff[dj] = (cok[dj] ? jj : 0) * C + cc;
  }
  // hid(rr, col - 1 + dj), zero outside the image
  auto load_row = [&](float2 (&row)[3], int rr) {
    const bool rok = rr >= 0 && rr < H;
    const float* base = hf + (rok ? rr : 0) * rstride;
#pragma unroll
    for (int dj = 0; dj < 3; ++dj) {
      const float2 v = *reinterpret_cast<const float2*>(base + coff[dj]);
      row[dj] = rok && cok[dj] ? v : make_float2(0.f, 0.f);
    }
  };
  // hv: the window of the row computed; nx: hid of the row after it and nda
  // d_a of the next row, both loaded a step ahead of their use
  float2 hv[3][3], nx[3];
  load_row(hv[0], i0 - 2);
  load_row(hv[1], i0 - 1);
  load_row(nx, i0);
  auto load_da = [&](int rr) {
    const bool ok = rr >= 0 && rr < H && col_in;
    return *reinterpret_cast<const float2*>(af + (ok ? rr : 0) * rstride + coff[1]);
  };
  float2 nda = load_da(i0 - 1);
  float2 tap[9], sdz = make_float2(0.f, 0.f), sdh = make_float2(0.f, 0.f);
#pragma unroll
  for (int q = 0; q < 9; ++q) tap[q] = make_float2(0.f, 0.f);

  for (int r = i0 - 1; r <= i1; ++r) {
#pragma unroll
    for (int dj = 0; dj < 3; ++dj) hv[2][dj] = nx[dj];
    const float2 da = nda;
    load_row(nx, r + 2);
    nda = load_da(r + 1);
    const bool in = r >= 0 && r < H && col_in;
    float2 z = make_float2(0.f, 0.f);
#pragma unroll
    for (int di = 0; di < 3; ++di)
#pragma unroll
      for (int dj = 0; dj < 3; ++dj) {
        z.x += hv[di][dj].x * k[di * 3 + dj].x;
        z.y += hv[di][dj].y * k[di * 3 + dj].y;
      }
    z.x += bb.x;
    z.y += bb.y;
    const float2 g = in ? make_float2(da.x * gelu_grad(z.x), da.y * gelu_grad(z.y))
                        : make_float2(0.f, 0.f);
    ring[r & 3][warp][lane] = g;
    if (interior && r >= i0 && r < i1) {
#pragma unroll
      for (int q = 0; q < 9; ++q) {
        tap[q].x += hv[q / 3][q % 3].x * g.x;
        tap[q].y += hv[q / 3][q % 3].y * g.y;
      }
      sdz.x += g.x;
      sdz.y += g.y;
    }
    __syncthreads();
    if (interior && r - 1 >= i0) {  // d_hid of row r - 1: d_z rows r - 2 .. r are in the ring
      float2 acc = make_float2(0.f, 0.f);
#pragma unroll
      for (int dj = 0; dj < 3; ++dj)
#pragma unroll
        for (int di = 0; di < 3; ++di) {
          const float2 dz = ring[(r - di) & 3][warp + 1 - dj][lane];
          acc.x += dz.x * k[di * 3 + dj].x;
          acc.y += dz.y * k[di * 3 + dj].y;
        }
      if (live)
        *reinterpret_cast<__nv_bfloat162*>(d_hid + fbase + (r - 1) * rstride + col * C + c) =
            __floats2bfloat162_rn(acc.x, acc.y);
      sdh.x += acc.x;
      sdh.y += acc.y;
    }
#pragma unroll
    for (int dj = 0; dj < 3; ++dj) {
      hv[0][dj] = hv[1][dj];
      hv[1][dj] = hv[2][dj];
    }
  }
  if (warp >= 1 && warp <= TW) {  // owned columns past W hold zeros
#pragma unroll
    for (int q = 0; q < 9; ++q) red[warp - 1][q][lane] = tap[q];
    red[warp - 1][9][lane] = sdz;
    red[warp - 1][10][lane] = sdh;
  }
  __syncthreads();
  // the block's partials, its columns added in order
  for (int e = threadIdx.x; e < 11 * 32; e += blockDim.x) {
    const int q = e / 32, l = e % 32, ch = slab * 64 + 2 * l;
    if (ch >= C) continue;
    float2 v = make_float2(0.f, 0.f);
#pragma unroll
    for (int w = 0; w < TW; ++w) {
      v.x += red[w][q][l].x;
      v.y += red[w][q][l].y;
    }
    *reinterpret_cast<float2*>(partial + ((long long)tile * 11 + q) * C + ch) = v;
  }
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

// d_a, hid (B, H, W, C) f32; wk (9, C) f32 taps in (di, dj) order; bdw (C,)
// f32; d_hid (B, H, W, C) bf16; partial (B * strips * ceil(W / kTileW), 11,
// C) f32 per block: the 9 tap sums Σ hid(shifted)·d_z, Σ d_z, Σ d_hid. A
// block walks `rows` rows (strips = ceil(H / rows)). Returns a cudaError_t.
VSS_EXPORT int dz_dhid(const void* d_a, const void* hid, const void* wk, const void* bdw,
                       void* d_hid, void* partial, int B, int H, int W, int C, int rows,
                       int device, void* stream) {
  vss::use_device(device);
  if ((long long)B * H * W == 0 || C == 0) return 0;
  if (rows < 1) return (int)cudaErrorInvalidValue;
  const int strips = (H + rows - 1) / rows, ctiles = (W + kTileW - 1) / kTileW;
  const unsigned grid = (unsigned)((long long)B * strips * ctiles * ((C + 63) / 64));
  dz_dhid_kernel<kTileW><<<grid, 32 * (kTileW + 2), 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d_a), static_cast<const float*>(hid),
      static_cast<const float*>(wk), static_cast<const float*>(bdw),
      static_cast<__nv_bfloat16*>(d_hid), static_cast<float*>(partial), H, W, C, rows, strips,
      ctiles);
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
  vss::use_device(device);
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
