// HRNet branch-chain 3x3 conv kernels for Hopper (sm_90a): a stride-1 SAME
// 3x3 convolution on NCHW bf16 activations with C_in = C_out = C <= 128,
// forward with an optional input transform and fused BatchNorm statistics
// (kernel D, also the dx conv of the backward), and the weight gradient
// with the statistics cotangent folded in (kernel E).
//
// Replaces semi_supervised_semantic_segmentation_tpu/ops/pallas_conv.py:
//   D: _conv3x3_nchw_impl -> _kernel_kstack (alternate _kernel)
//   E: _conv3x3_dw_impl   -> _dw_kernel_dyroll (alternate _dw_kernel)
//
// Contract (the TPU kernels'):
//   D: y[n,co] = sum_{ci,kh,kw} bf16(w[co,ci,kh,kw]) * t[n,ci,h+kh-1,w+kw-1]
//      with t = x, or with pre: t = relu(bf16(bf16(x*mul_r) + add_r)) where
//      mul_r/add_r are mul/add rounded to bf16; SAME padding pads t with 0.
//      f32 accumulation, one rounding of y to bf16.  With stats:
//      sums[2,C] = (sum y, sum y^2) of the ROUNDED y over (N, H, W).  With
//      flip the weights are w[ci,co,2-kh,2-kw] (the dx conv).
//   E: dY = bf16((f32(dy) + ds[0,co]) + (2*f32(y))*ds[1,co]) (fuse; written
//      out for the dx conv), else dY = dy; then
//      dk[co,ci,kh,kw] = sum_{n,h,w} f32(dY[n,co,h,w]) * t[n,ci,h+kh-1,w+kw-1]
//      in f32, t as in D.
//
// Design: implicit GEMMs on the tensor cores (mma.sync m16n8k16 bf16 -> f32,
// operands from shared memory with ldmatrix).  A block stages the halo'd,
// transformed input tile of 8 x 32 output pixels in shared memory once, in
// pixel-major layout with the channels contiguous ([pixel][C], padded to 16
// channels plus an 8-channel skew so ldmatrix rows hit distinct banks).  A
// tap (kh, kw) of the conv is then just an offset of the pixel row
// addresses, so no im2col buffer and no shifted copies exist.
//   D: M = C_out, N = the tile's pixels (a warp owns one output row of 32),
//      K = 9 * C_in in (tap, ci) order.  The bf16 weights of the block's
//      M-slice (48 rows at most, so C = 96/128 split C_out over blocks and
//      the weights and the input tile fit in shared memory together) are
//      converted from the f32 OIHW parameter once per block.  Blocks are
//      persistent over tiles.  Statistics are per-block partials of the
//      rounded y, reduced by a second kernel in a fixed order (no atomics:
//      the same inputs give the same bits).
//   E: M = C_out (all rows), N = 9 * C_in, K = the tile's pixels.  The
//      block composes dY for its tile into shared memory ([co][pixel]) and
//      writes it out once; the input tile is read with ldmatrix.trans.  The
//      f32 dk partial of a block lives in registers: C = 48 keeps all 432
//      columns in one block, wider C splits the columns over 4-6 blocks
//      that share a slab of tiles.  Each slab writes one [C][9C] partial
//      and a second kernel sums them in a fixed order into OIHW dk.
// What bounds it: D moves ~100 MB and does 21.7 GFLOP per [8,48,256,256]
// call (bound ~30 us, bytes); E reads x, dy, y and writes dY (~201 MB,
// ~60 us).  This first version does not pipeline the tile loads against
// the MMAs (no cp.async / TMA, no wgmma), so it sits well above the bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define NT 256        // threads per block (8 warps)
#define TW 32         // output pixels per tile row
#define TH 8          // tile rows (D: one per warp)
#define HW2 (TW + 2)  // halo tile width
#define MAXC 128

typedef __nv_bfloat16 bf16;

struct Geo {
  int N, C, Cp, H, W, ntx, nty, ntiles;
};

static Geo make_geo(int N, int C, int H, int W) {
  Geo g;
  g.N = N; g.C = C; g.Cp = (C + 15) / 16 * 16; g.H = H; g.W = W;
  g.ntx = (W + TW - 1) / TW;
  g.nty = H / TH;
  g.ntiles = N * g.nty * g.ntx;
  return g;
}

__device__ __forceinline__ float bf16r(float v) { return __bfloat162float(__float2bfloat16(v)); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void tile_coords(const Geo& g, int tile, int& n, int& oy0, int& ox0) {
  const int tx = tile % g.ntx;
  const int r = tile / g.ntx;
  oy0 = (r % g.nty) * TH;
  n = r / g.nty;
  ox0 = tx * TW;
}

// The input transform's bf16-rounded (mul, add) in shared memory: pm[ci] =
// bf16(mul[ci]), pm[Cp + ci] = bf16(add[ci]), 0 for ci >= C.
__device__ void stage_pre(float* pm, const float* __restrict__ mul,
                          const float* __restrict__ add, bool pre, const Geo& g) {
  for (int e = threadIdx.x; e < 2 * g.Cp; e += NT) {
    const int which = e / g.Cp, ci = e - which * g.Cp;
    pm[e] = (pre && ci < g.C) ? bf16r((which ? add : mul)[ci]) : 0.f;
  }
}

// Stage the transformed input of output rows oy0..oy0+TH-1, columns
// ox0..ox0+TW-1 plus the 1-pixel halo: tile[(r*HW2 + c)*cps + ci] =
// t[n, ci, oy0-1+r, ox0-1+c], 0 outside the image and for ci >= C.
// Each thread packs 8 channels of one pixel into one 16-byte store;
// neighbouring threads read neighbouring pixels of a channel row.  E uses
// this form: one channel loaded, transformed and converted at a time.
__device__ void fill_tile(bf16* tile, const bf16* __restrict__ x, const float* pm, bool pre,
                          const Geo& g, int n, int oy0, int ox0) {
  const int cps = g.Cp + 8;
  const int npx = (TH + 2) * HW2;
  const int ngrp = g.Cp / 8;
  for (int e = threadIdx.x; e < npx * ngrp; e += NT) {
    const int grp = e / npx, p = e - grp * npx;
    const int r = p / HW2, c = p - r * HW2;
    const int iy = oy0 - 1 + r, ix = ox0 - 1 + c;
    const bool inside = iy >= 0 && iy < g.H && ix >= 0 && ix < g.W;
    __align__(16) bf16 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int ci = grp * 8 + j;
      float f = 0.f;
      if (inside && ci < g.C) {
        f = __bfloat162float(x[(((size_t)n * g.C + ci) * g.H + iy) * g.W + ix]);
        if (pre) {
          // bf16(bf16(x * mul_r) + add_r), then ReLU: the reference's bf16 fma
          const float pmv = bf16r(__fmul_rn(f, pm[ci]));
          f = fmaxf(bf16r(__fadd_rn(pmv, pm[g.Cp + ci])), 0.f);
        }
      }
      v[j] = __float2bfloat16(f);
    }
    *reinterpret_cast<uint4*>(&tile[p * cps + grp * 8]) = *reinterpret_cast<const uint4*>(v);
  }
}

// The same tile, with the 8 loads of a thread issued before any transform,
// so they are in flight together.  D uses this form.  E keeps the one
// above: its f32 partial holds most of its registers, and the 8 values
// held across the loads cost it more than the overlap gains.
__device__ void fill_tile_batched(bf16* tile, const bf16* __restrict__ x, const float* pm,
                                  bool pre, const Geo& g, int n, int oy0, int ox0) {
  const int cps = g.Cp + 8;
  const int npx = (TH + 2) * HW2;
  const int ngrp = g.Cp / 8;
  for (int e = threadIdx.x; e < npx * ngrp; e += NT) {
    const int grp = e / npx, p = e - grp * npx;
    const int r = p / HW2, c = p - r * HW2;
    const int iy = oy0 - 1 + r, ix = ox0 - 1 + c;
    const bool inside = iy >= 0 && iy < g.H && ix >= 0 && ix < g.W;
    const bf16* src = x + (((size_t)n * g.C + grp * 8) * g.H + iy) * g.W + ix;
    const size_t plane = (size_t)g.H * g.W;
    float f[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      f[j] = (inside && grp * 8 + j < g.C) ? __bfloat162float(src[j * plane]) : 0.f;
    if (pre && inside) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {  // pm is 0 for ci >= C: the padding stays 0
        const float pmv = bf16r(__fmul_rn(f[j], pm[grp * 8 + j]));
        f[j] = fmaxf(bf16r(__fadd_rn(pmv, pm[g.Cp + grp * 8 + j])), 0.f);
      }
    }
    __align__(16) bf16 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __float2bfloat16(f[j]);
    *reinterpret_cast<uint4*>(&tile[p * cps + grp * 8]) = *reinterpret_cast<const uint4*>(v);
  }
}

// ---------------------------------------------------------------------------
// D: forward conv (+ pre) (+ stats)
// ---------------------------------------------------------------------------

// MT = m16 tiles of C_out per block (rows = 16*MT), nmt = blocks per tile.
template <int MT>
__global__ void __launch_bounds__(NT, 2)
conv_fwd_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ mul, const float* __restrict__ add,
                bf16* __restrict__ y, float* __restrict__ partial, Geo g, int pre, int stats,
                int flip, int nmt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int ROWS = 16 * MT;
  const int cp = g.Cp, cps = cp + 8, wst = 9 * cp + 8;
  bf16* wsm = reinterpret_cast<bf16*>(smem_raw);            // [ROWS][wst]
  bf16* tile = wsm + ROWS * wst;                             // [(TH+2)*HW2][cps]
  float* red = reinterpret_cast<float*>(tile + (TH + 2) * HW2 * cps);  // [8][2][ROWS]
  float* pm = red + 8 * 2 * ROWS;                             // [2][Cp]
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int mtile = blockIdx.x % nmt, slab = blockIdx.x / nmt, nslab = gridDim.x / nmt;
  const int co_base = mtile * ROWS;
  stage_pre(pm, mul, add, pre != 0, g);

  // Weights: bf16(w) as A[co][tap*Cp + ci], zero padding.  Read in the
  // parameter's own order (coalesced), scattered into shared memory.
  for (int e = t; e < ROWS * wst / 8; e += NT)
    reinterpret_cast<uint4*>(wsm)[e] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  const int C = g.C;
  for (int e = t; e < C * C * 9; e += NT) {
    const int a = e / (9 * C), rem = e - a * 9 * C;
    const int b = rem / 9, k = rem - b * 9;
    // OIHW element (a, b, k): forward co=a ci=b tap=k; flipped co=b ci=a tap=8-k
    const int co = flip ? b : a, ci = flip ? a : b, tap = flip ? 8 - k : k;
    const int r = co - co_base;
    if (r >= 0 && r < ROWS) wsm[r * wst + tap * cp + ci] = __float2bfloat16(w[e]);
  }

  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int b_n = (lane & 7) + (lane >> 4) * 8, b_k = ((lane >> 3) & 1) * 8;
  const uint32_t wsm_s = smem_addr(wsm), tile_s = smem_addr(tile);
  float s1[MT][2], s2[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m) s1[m][0] = s1[m][1] = s2[m][0] = s2[m][1] = 0.f;

  for (int tl = slab; tl < g.ntiles; tl += nslab) {
    int n, oy0, ox0;
    tile_coords(g, tl, n, oy0, ox0);
    __syncthreads();  // weights written / previous tile consumed
    fill_tile_batched(tile, x, pm, pre != 0, g, n, oy0, ox0);
    __syncthreads();

    float acc[MT][4][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;

    for (int tap = 0; tap < 9; ++tap) {
      const int kh = tap / 3, kw = tap - kh * 3;
      const uint32_t brow = tile_s + (((warp + kh) * HW2 + b_n + kw) * cps + b_k) * 2;
      const uint32_t arow = wsm_s + ((a_row * wst) + tap * cp + a_col) * 2;
      for (int cc = 0; cc < cp; cc += 16) {
        uint32_t af[MT][4], bfr[4][2];
#pragma unroll
        for (int m = 0; m < MT; ++m) ldsm_x4(af[m], arow + (m * 16 * wst + cc) * 2);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t r[4];
          ldsm_x4(r, brow + (np * 16 * cps + cc) * 2);
          bfr[2 * np][0] = r[0]; bfr[2 * np][1] = r[1];
          bfr[2 * np + 1][0] = r[2]; bfr[2 * np + 1][1] = r[3];
        }
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16(acc[m][j], af[m], bfr[j]);
      }
    }

    // Epilogue: round, store y, accumulate the statistics of the rounded y.
    const int oy = oy0 + warp;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int co = co_base + m * 16 + half * 8 + (lane >> 2);
        if (co >= C) continue;
        bf16* yrow = y + (((size_t)n * C + co) * g.H + oy) * g.W;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ox = ox0 + j * 8 + (lane & 3) * 2;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (ox + e < g.W) {
              const bf16 v = __float2bfloat16(acc[m][j][2 * half + e]);
              yrow[ox + e] = v;
              const float f = __bfloat162float(v);
              s1[m][half] += f;
              s2[m][half] += f * f;
            }
          }
        }
      }
  }
  if (!stats) return;

  // Block partial: sum the 4 lanes of a row, then the 8 warps in order.
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float a = s1[m][half], b = s2[m][half];
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      b += __shfl_xor_sync(0xffffffffu, b, 1);
      b += __shfl_xor_sync(0xffffffffu, b, 2);
      if ((lane & 3) == 0) {
        const int r = m * 16 + half * 8 + (lane >> 2);
        red[(warp * 2 + 0) * ROWS + r] = a;
        red[(warp * 2 + 1) * ROWS + r] = b;
      }
    }
  __syncthreads();
  for (int e = t; e < 2 * ROWS; e += NT) {
    const int which = e / ROWS, r = e - which * ROWS;
    const int co = co_base + r;
    if (co >= C) continue;
    float s = 0.f;
    for (int wp = 0; wp < 8; ++wp) s += red[(wp * 2 + which) * ROWS + r];
    partial[((size_t)slab * 2 + which) * C + co] = s;
  }
}

// ---------------------------------------------------------------------------
// E: weight gradient (+ fused dY composition) (+ pre)
// ---------------------------------------------------------------------------

// n8 tiles per warp for MT = Cp/16 m16 tiles: keeps MT*NW*4 accumulators
// per thread at or below ~96 registers.
__host__ __device__ constexpr int dw_nw(int mt) {
  return (24 / mt) < (18 * mt + 7) / 8 ? (24 / mt) : (18 * mt + 7) / 8;
}

#define DST (TH * TW + 8)  // dY tile row stride (elements): an odd number of 16-byte units

template <int MT>
__global__ void __launch_bounds__(NT, 1)
conv_dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
               const bf16* __restrict__ y, const float* __restrict__ ds,
               const float* __restrict__ mul, const float* __restrict__ add,
               bf16* __restrict__ dY, float* __restrict__ partial, Geo g, int pre, int fuse,
               int ngroup) {
  constexpr int NW = dw_nw(MT);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cp = g.Cp, cps = cp + 8, C = g.C;
  bf16* tile = reinterpret_cast<bf16*>(smem_raw);             // [(TH+2)*HW2][cps]
  bf16* dys = tile + (TH + 2) * HW2 * cps;                     // [Cp][DST]
  float* dss = reinterpret_cast<float*>(dys + cp * DST);       // [2][Cp]
  float* pm = dss + 2 * cp;                                    // [2][Cp]
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int group = blockIdx.x % ngroup, slab = blockIdx.x / ngroup;
  const int nslab = gridDim.x / ngroup;
  const int n8 = 9 * cp / 8, cp8 = cp / 8;
  const int qbase = (group * 8 + warp) * NW;
  for (int e = t; e < 2 * cp; e += NT) {
    const int which = e / cp, co = e - which * cp;
    dss[e] = (fuse && co < C) ? ds[which * C + co] : 0.f;
  }
  stage_pre(pm, mul, add, pre != 0, g);

  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int b_k = (lane & 7) + ((lane >> 3) & 1) * 8;  // pixel row of ldmatrix.trans
  const uint32_t dys_s = smem_addr(dys), tile_s = smem_addr(tile);
  float acc[MT][NW][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NW; ++j) acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;

  for (int tl = slab; tl < g.ntiles; tl += nslab) {
    int n, oy0, ox0;
    tile_coords(g, tl, n, oy0, ox0);
    __syncthreads();  // ds staged / previous tile consumed
    fill_tile(tile, x, pm, pre != 0, g, n, oy0, ox0);
    for (int e = t; e < cp * TH * TW; e += NT) {
      const int co = e / (TH * TW), p = e - co * (TH * TW);
      const int r = p / TW, c = p - r * TW;
      const int ox = ox0 + c;
      float v = 0.f;
      if (co < C && ox < g.W) {
        const size_t idx = (((size_t)n * C + co) * g.H + oy0 + r) * g.W + ox;
        v = __bfloat162float(dy[idx]);
        if (fuse) {
          // (dy + ds0) + (2*y)*ds1 with no contraction into an FMA: the
          // plain version's roundings, so dY is the same bf16.
          v = bf16r(__fadd_rn(__fadd_rn(v, dss[co]),
                              __fmul_rn(__fmul_rn(2.f, __bfloat162float(y[idx])), dss[cp + co])));
          if (group == 0) dY[idx] = __float2bfloat16(v);
        }
      }
      dys[co * DST + p] = __float2bfloat16(v);
    }
    __syncthreads();

    for (int kc = 0; kc < TH * TW; kc += 16) {
      const int r = kc / TW, c0 = kc - r * TW;
      uint32_t af[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
        ldsm_x4(af[m], dys_s + ((m * 16 + a_row) * DST + kc + a_col) * 2);
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        const int q = qbase + j;
        if (q >= n8) break;  // warp-uniform
        const int tap = q / cp8, ci0 = (q - tap * cp8) * 8;
        const int kh = tap / 3, kw = tap - kh * 3;
        uint32_t bfr[2];
        ldsm_x2_trans(bfr, tile_s + (((r + kh) * HW2 + c0 + b_k + kw) * cps + ci0) * 2);
#pragma unroll
        for (int m = 0; m < MT; ++m) mma_bf16(acc[m][j], af[m], bfr);
      }
    }
  }

  // partial[slab][co][tap*Cp + ci]
  const size_t width = 9 * (size_t)cp;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const int q = qbase + j;
    if (q >= n8) break;
    const int col = q * 8 + (lane & 3) * 2;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m * 16 + half * 8 + (lane >> 2);
        float* dst = partial + ((size_t)slab * cp + row) * width + col;
        dst[0] = acc[m][j][2 * half];
        dst[1] = acc[m][j][2 * half + 1];
      }
  }
}

// ---------------------------------------------------------------------------
// fixed-order reductions of the per-block partials
// ---------------------------------------------------------------------------

// out[col] = sum_i part[i][col], i in order.
__global__ void reduce_rows_kernel(const float* __restrict__ part, int nparts, int width,
                                   float* __restrict__ out) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= width) return;
  float s = 0.f;
  for (int i = 0; i < nparts; ++i) s += part[(size_t)i * width + col];
  out[col] = s;
}

// dk[co][ci][tap] (OIHW) = sum_i part[i][co][tap*Cp + ci], i in order.
__global__ void reduce_dk_kernel(const float* __restrict__ part, int nparts, int C, int cp,
                                 float* __restrict__ dk) {
  const int width = 9 * cp;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= C * width) return;
  const int co = e / width, col = e - co * width;
  const int tap = col / cp, ci = col - tap * cp;
  if (ci >= C) return;
  float s = 0.f;
  for (int i = 0; i < nparts; ++i) s += part[((size_t)i * cp + co) * width + col];
  dk[((size_t)co * C + ci) * 9 + tap] = s;
}

// ---------------------------------------------------------------------------
// C interface (ctypes); each returns a cudaError_t
// ---------------------------------------------------------------------------

static int fwd_mt(int cp) { return cp / 16 < 3 ? cp / 16 : 3; }

static int fwd_smem(int cp) {
  const int rows = 16 * fwd_mt(cp);
  return (rows * (9 * cp + 8) + (TH + 2) * HW2 * (cp + 8)) * 2 + (8 * 2 * rows + 2 * cp) * 4;
}

static int dw_smem(int cp) {
  return ((TH + 2) * HW2 * (cp + 8) + cp * DST) * 2 + 4 * cp * 4;
}

static int dw_ngroup(int cp) {
  const int mt = cp / 16;
  const int per_block = 8 * dw_nw(mt);
  return (9 * cp / 8 + per_block - 1) / per_block;
}

// out[0] = D's shared bytes, out[1] = D's blocks per tile (C_out split),
// out[2] = E's shared bytes, out[3] = E's blocks per slab (column split),
// out[4] = tiles per image plane (for the grid).
extern "C" int branch_conv_plan(int C, int H, int W, int* out) {
  if (C < 1 || C > MAXC) return (int)cudaErrorInvalidValue;
  const Geo g = make_geo(1, C, H, W);
  const int mt = fwd_mt(g.Cp);
  out[0] = fwd_smem(g.Cp);
  out[1] = (g.Cp + 16 * mt - 1) / (16 * mt);
  out[2] = dw_smem(g.Cp);
  out[3] = dw_ngroup(g.Cp);
  out[4] = g.ntiles;
  return 0;
}

static bool geo_ok(int N, int C, int H, int W) {
  return N > 0 && C > 0 && C <= MAXC && H > 0 && H % TH == 0 && W > 0;
}

template <int MT>
static cudaError_t launch_fwd(const void* x, const void* w, const void* mul, const void* add,
                              void* y, void* partial, const Geo& g, int pre, int stats, int flip,
                              int grid, int nmt, cudaStream_t s) {
  const int smem = fwd_smem(g.Cp);
  cudaError_t err = cudaFuncSetAttribute(conv_fwd_kernel<MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  conv_fwd_kernel<MT><<<grid, NT, smem, s>>>(
      (const bf16*)x, (const float*)w, (const float*)mul, (const float*)add, (bf16*)y,
      (float*)partial, g, pre, stats, flip, nmt);
  return cudaGetLastError();
}

// Kernel D.  x [N,C,H,W] bf16; w [C,C,3,3] f32 (OIHW); mul, add [C] f32 (pre);
// y [N,C,H,W] bf16; partial [nslab][2][C] f32; sums [2][C] f32 (stats).
// The grid is nslab * (D's C_out split); nslab <= tiles.
extern "C" int branch_conv_fwd(const void* x, const void* w, const void* mul, const void* add,
                               void* y, void* partial, void* sums, int N, int C, int H, int W,
                               int pre, int stats, int flip, int nslab, void* stream) {
  if (!geo_ok(N, C, H, W) || nslab < 1) return (int)cudaErrorInvalidValue;
  const Geo g = make_geo(N, C, H, W);
  if (nslab > g.ntiles) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int mt = fwd_mt(g.Cp);
  const int nmt = (g.Cp + 16 * mt - 1) / (16 * mt);
  const int grid = nslab * nmt;
  cudaError_t err;
  switch (mt) {
    case 1: err = launch_fwd<1>(x, w, mul, add, y, partial, g, pre, stats, flip, grid, nmt, s); break;
    case 2: err = launch_fwd<2>(x, w, mul, add, y, partial, g, pre, stats, flip, grid, nmt, s); break;
    default: err = launch_fwd<3>(x, w, mul, add, y, partial, g, pre, stats, flip, grid, nmt, s); break;
  }
  if (err != cudaSuccess || !stats) return (int)err;
  reduce_rows_kernel<<<(2 * C + 255) / 256, 256, 0, s>>>((const float*)partial, nslab, 2 * C,
                                                        (float*)sums);
  return (int)cudaGetLastError();
}

template <int MT>
static cudaError_t launch_dw(const void* x, const void* dy, const void* y, const void* ds,
                             const void* mul, const void* add, void* dY, void* partial,
                             const Geo& g, int pre, int fuse, int grid, int ngroup,
                             cudaStream_t s) {
  const int smem = dw_smem(g.Cp);
  cudaError_t err = cudaFuncSetAttribute(conv_dw_kernel<MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  conv_dw_kernel<MT><<<grid, NT, smem, s>>>(
      (const bf16*)x, (const bf16*)dy, (const bf16*)y, (const float*)ds, (const float*)mul,
      (const float*)add, (bf16*)dY, (float*)partial, g, pre, fuse, ngroup);
  return cudaGetLastError();
}

// Kernel E.  x, dy [N,C,H,W] bf16; y [N,C,H,W] bf16 and ds [2][C] f32 (fuse);
// mul, add [C] f32 (pre); dY [N,C,H,W] bf16 (fuse); partial [nslab][Cp][9*Cp]
// f32; dk [C,C,3,3] f32 (OIHW).  The grid is nslab * (E's column split).
extern "C" int branch_conv_dw(const void* x, const void* dy, const void* y, const void* ds,
                              const void* mul, const void* add, void* dY, void* partial,
                              void* dk, int N, int C, int H, int W, int pre, int fuse, int nslab,
                              void* stream) {
  if (!geo_ok(N, C, H, W) || nslab < 1) return (int)cudaErrorInvalidValue;
  const Geo g = make_geo(N, C, H, W);
  if (nslab > g.ntiles) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int ngroup = dw_ngroup(g.Cp);
  const int grid = nslab * ngroup;
  cudaError_t err;
  switch (g.Cp / 16) {
#define DW_CASE(M) \
    case M: err = launch_dw<M>(x, dy, y, ds, mul, add, dY, partial, g, pre, fuse, grid, ngroup, s); break;
    DW_CASE(1) DW_CASE(2) DW_CASE(3) DW_CASE(4) DW_CASE(5) DW_CASE(6) DW_CASE(7) DW_CASE(8)
#undef DW_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const int total = C * 9 * g.Cp;
  reduce_dk_kernel<<<(total + 255) / 256, 256, 0, s>>>((const float*)partial, nslab, C, g.Cp,
                                                       (float*)dk);
  return (int)cudaGetLastError();
}
