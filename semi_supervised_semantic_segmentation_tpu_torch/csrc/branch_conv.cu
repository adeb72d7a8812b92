// HRNet branch-chain 3x3 conv kernels for Hopper (sm_90a): a stride-1 SAME
// 3x3 convolution on NCHW bf16 activations with C_in = C_out = C <= 128,
// forward with an optional input transform and fused BatchNorm statistics
// (kernel D, also the dx conv of the backward), and the weight gradient
// with the statistics cotangent folded in (kernel E).
//
// Replaces semi_supervised_semantic_segmentation_tpu/ops/pallas_conv.py:
//   D: _conv3x3_nchw_impl -> _kernel_kstack (alternate _kernel); its post
//      mode (_kernel_kstack(post=True), the reference's opt-in dx
//      epilogue) is D's post epilogue below, which the port always runs
//   E: _conv3x3_dw_impl   -> _dw_kernel_dyroll (alternate _dw_kernel)
//
// Contract (the TPU kernels'):
//   D: y[n,co] = sum_{ci,kh,kw} bf16(w[co,ci,kh,kw]) * t[n,ci,h+kh-1,w+kw-1]
//      with t = x, or with pre: t = relu(bf16(bf16(x*mul_r) + add_r)) where
//      mul_r/add_r are mul/add rounded to bf16; SAME padding pads t with 0.
//      f32 accumulation, one rounding of y to bf16.  With stats:
//      sums[2,C] = (sum y, sum y^2) of the ROUNDED y over (N, H, W).  With
//      flip the weights are w[ci,co,2-kh,2-kw] (the dx conv).
//   D post (the dx conv of a conv whose input was t = relu(x*mul + add);
//      flip, no pre, no stats): dt = bf16(acc) as y above, then per element
//      t2 = bf16(bf16(x*mul_r) + add_r), dtm = t2 > 0 ? dt : 0 (strict),
//      dx = bf16(dtm * mul) with the RAW f32 mul, and
//      sums[2,C] = (sum dtm*x, sum dtm) = (dmul, dadd) in f32.
//   E: dY = bf16((f32(dy) + ds[0,co]) + (2*f32(y))*ds[1,co]) (fuse; written
//      out for the dx conv), else dY = dy; then
//      dk[co,ci,kh,kw] = sum_{n,h,w} f32(dY[n,co,h,w]) * t[n,ci,h+kh-1,w+kw-1]
//      in f32, t as in D.
//
// Design: implicit GEMMs on the tensor cores (mma.sync m16n8k16 bf16 -> f32,
// operands from shared memory with ldmatrix).  A block stages the halo'd,
// transformed input tile of 8 (D) or 4 (E) x 32 output pixels in shared
// memory once, in pixel-major layout with the channels contiguous ([pixel][C], padded to 16
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
//   D96 (conv_fwd96_kernel, D at Cp = 96 with W % 8 == 0 and 16-byte
//      aligned activations; the wrapper picks it, or D48 below, and
//      conv_fwd_kernel serves every other shape): one persistent block per
//      SM, tiles of 4 x 32 pixels x all 96 C_out, so x is staged once per
//      tile (not once per 48-row C_out block).  Warp = (C_out half, tile
//      row) with D's MT = 3 accumulators and product loop.  x goes through
//      E's pieces: raw rows by cp.async 16-byte copies (dw_issue's x loop,
//      issue_x_rows), then dw_transform (position masks, packed-bf16 pre
//      arithmetic) into the operand tile.
//      A small kernel packs the weights once per call, flip applied, into
//      a bf16 scratch [9][96][104] (tap-major, rows C_out); each tap's
//      19,968-byte slab streams from L2 into a 3-stage ring, two taps
//      ahead, as one cp.async.bulk completing on the stage's mbarrier.  So
//      a tap waits for its slab alone: the next tile's x copies (issued
//      into the one raw stage as soon as the transform has emptied it) are
//      a separate cp.async group, waited only at that tile.  The epilogue
//      rounds y (post: dt) into per-warp staging rows and writes 16-byte
//      chunks (post reads x in the same chunks); the per-element post chain,
//      the statistics of the rounded y and their fixed-order partials (4
//      warps of a C_out half in row order) are conv_fwd_kernel's, so y and
//      post's dx are bit-equal to it.  192,984 shared bytes.  Per
//      [8,96,128,128] call: 21.7 GFLOP (~22 us, the bound: operations),
//      ~51 MB of x and y (~15 us); the staging reads x 2.25 x (halo and the
//      48-column raw row, ~57 MB) and the weight slabs ~184 MB from L2 (9
//      slabs per tile, 1,024 tiles).
//   D48 (conv_fwd48_kernel, D at Cp = 48 under D96's conditions; the note
//      above it): D96's parts at one width where all nine weight slabs fit
//      in shared memory, so they are bulk-copied once per block and stay
//      resident; D's 8 x 32-pixel tiles (warp = tile row) with x staged
//      two tiles ahead, and D96's 16-byte epilogue.
//   D post: the epilogue reads x at each output element of the dx conv,
//      applies the mask and the scale to the rounded dt in registers, writes
//      dx in dt's place and sums (dmul, dadd) into the statistics' partials
//      and reduction, so dt never reaches memory.  Every step is an explicit
//      _rn operation, so no fma contraction rounds once where the plain
//      chain rounds twice; dx is bit-equal to D's dx conv followed by the
//      plain chain.  The staging, the product loop and the plan are D's;
//      only the shared memory grows by one [Cp] f32 row (mul_r, add_r and
//      the raw mul, against pre's two).  It is bound by bytes like D: dY
//      and x read, dx written (3 activations, ~151 MB per [8,48,256,256]
//      call, ~45 us), one activation more than the dx conv alone, against
//      the ~13 activations of f32 traffic of the unfused chain it replaces.
//   E: M = C_out, N = 9 * C_in, K = the tile's pixels (4 x 32 output
//      pixels per tile).  A block owns a slice of dk's rows (C_out) and all
//      9C columns, with the f32 partial in registers: C = 48 one block of
//      48 rows, C = 96 three blocks of 32 rows (the plan per width is
//      dw_mt below).  The blocks of a row split walk the same slab of
//      tiles; each composes and writes only its own rows of dY, so no two
//      blocks compose the same dY.  Each slab writes one [Cp][9Cp] partial
//      and a second kernel sums them in a fixed order into OIHW dk.
// What bounds it: D moves ~100 MB and does 21.7 GFLOP per [8,48,256,256]
// call (bound ~30 us, bytes).  E reads x, dy, y and writes dY: ~201 MB per
// [8,48,256,256] call (~60 us) and ~101 MB per [8,96,128,128] call (~30
// us), against 21.7 GFLOP (~22 us): bytes.  With one block per SM (the
// partial fills the registers) a tile's loads must be in flight long
// before its MMAs, or the block waits on memory latency.  So E stages the
// raw x, dy and y rows of the tiles ahead with cp.async 16-byte copies
// into a ring of 2-3 stages (zero-filled outside the image), and
// transforms x (packed bf16 arithmetic) and composes dY shared -> shared
// while the next tiles' copies land; dY goes out with 16-byte stores.  The
// zero-filled staging is masked by position, never by value: the input's
// halo stays 0 (not relu(add)) and dY beyond W stays 0 (not ds0).  The
// product loop loads every fragment of a k-step (B in pairs with
// ldmatrix.x4.trans, from per-lane offsets fixed for the kernel) before
// its first mma, so the loads' latency is not paid once per n8 tile.
// Shapes the copies cannot take (W % 8 != 0, a pointer not 16-byte
// aligned) keep a synchronous fill inside the same kernel; the wrapper
// picks the path from the shape and the pointers.  What still holds E
// above its bound: the cp.async copies (16 bytes each, 1.5 x the rows and
// 1.5 x the columns of x for the halo, x once per row block at C = 96)
// and the block's phases (copy wait, transform, compose, products)
// following one another between barriers; products stay mma.sync, not
// wgmma.

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

// E's synchronous fill (the shapes its asynchronous ring cannot take): the
// transformed input of output rows oy0..oy0+ETH-1, columns ox0..ox0+TW-1
// plus the 1-pixel halo: tile[(r*HW2 + c)*cps + ci] =
// t[n, ci, oy0-1+r, ox0-1+c], 0 outside the image and for ci >= C.
// Each thread packs 8 channels of one pixel into one 16-byte store;
// neighbouring threads read neighbouring pixels of a channel row; one
// channel is loaded, transformed and converted at a time.
#define ETH 4  // E's tile rows
__device__ void fill_tile(bf16* tile, const bf16* __restrict__ x, const bf16* pmb, bool pre,
                          const Geo& g, int n, int oy0, int ox0) {
  const int cps = g.Cp + 8;
  const int npx = (ETH + 2) * HW2;
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
          const float pmv = bf16r(__fmul_rn(f, __bfloat162float(pmb[ci])));
          f = fmaxf(bf16r(__fadd_rn(pmv, __bfloat162float(pmb[g.Cp + ci]))), 0.f);
        }
      }
      v[j] = __float2bfloat16(f);
    }
    *reinterpret_cast<uint4*>(&tile[p * cps + grp * 8]) = *reinterpret_cast<const uint4*>(v);
  }
}

// D's tile (TH rows), with the 8 loads of a thread issued before any
// transform, so they are in flight together.
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
// post: xpost is the conv input x of the forward conv whose dx this is,
// and (mul, add) are its raw f32 fold; pm holds three rows then.
template <int MT>
__global__ void __launch_bounds__(NT, 2)
conv_fwd_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ mul, const float* __restrict__ add,
                const bf16* __restrict__ xpost, bf16* __restrict__ y,
                float* __restrict__ partial, Geo g, int pre, int stats, int flip, int post,
                int nmt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int ROWS = 16 * MT;
  const int cp = g.Cp, cps = cp + 8, wst = 9 * cp + 8;
  bf16* wsm = reinterpret_cast<bf16*>(smem_raw);            // [ROWS][wst]
  bf16* tile = wsm + ROWS * wst;                             // [(TH+2)*HW2][cps]
  float* red = reinterpret_cast<float*>(tile + (TH + 2) * HW2 * cps);  // [8][2][ROWS]
  float* pm = red + 8 * 2 * ROWS;                             // [2][Cp], post [3][Cp]
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int mtile = blockIdx.x % nmt, slab = blockIdx.x / nmt, nslab = gridDim.x / nmt;
  const int co_base = mtile * ROWS;
  if (post) {
    // pm[ci] = bf16(mul[ci]), pm[Cp + ci] = bf16(add[ci]), pm[2Cp + ci] = mul[ci]
    for (int e = t; e < 3 * cp; e += NT) {
      const int which = e / cp, ci = e - which * cp;
      const float v = ci < g.C ? (which == 1 ? add : mul)[ci] : 0.f;
      pm[e] = which == 2 ? v : bf16r(v);
    }
  } else {
    stage_pre(pm, mul, add, pre != 0, g);
  }

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
    // post: y is dt; store dx in its place and accumulate (dmul, dadd).
    const int oy = oy0 + warp;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int co = co_base + m * 16 + half * 8 + (lane >> 2);
        if (co >= C) continue;
        const size_t row = (((size_t)n * C + co) * g.H + oy) * g.W;
        bf16* yrow = y + row;
        if (post) {
          const bf16* xrow = xpost + row;
          const float mr = pm[co], ar = pm[cp + co], mw = pm[2 * cp + co];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int ox = ox0 + j * 8 + (lane & 3) * 2;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (ox + e < g.W) {
                const float dt = bf16r(acc[m][j][2 * half + e]);
                const float xf = __bfloat162float(xrow[ox + e]);
                const float t2 = bf16r(__fadd_rn(bf16r(__fmul_rn(xf, mr)), ar));
                const float dtm = t2 > 0.f ? dt : 0.f;
                yrow[ox + e] = __float2bfloat16(__fmul_rn(dtm, mw));
                s1[m][half] = __fadd_rn(s1[m][half], __fmul_rn(dtm, xf));
                s2[m][half] = __fadd_rn(s2[m][half], dtm);
              }
            }
          }
          continue;
        }
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
  if (!stats && !post) return;

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

#define EPIX (ETH * TW)    // pixels per E tile: the K of one tile's products
#define DST (EPIX + 8)     // dY tile row stride (elements): an odd number of 16-byte units
#define XRW 48             // raw x row in the ring: columns ox0-8 .. ox0+39, six 16-byte chunks
#define SMEM_MAX 232448    // shared memory one block may use (227 KB)

// The tile plan of one channel width, K16 = Cp / 16.  A block of 8 warps
// owns 16 * MT rows of dk and all 9 * Cp columns (18 * K16 n8 tiles); its
// warps split the columns, NW n8 tiles each.  MT is the most of {3, 2, 1}
// that divides K16 and keeps the MT * NW * 4 f32 accumulators of a thread
// at or below 112: C = 48 -> one block of 48 rows, C = 96 -> 3 blocks of 32.
__host__ __device__ constexpr int dw_nw(int k16) { return (18 * k16 + 7) / 8; }

__host__ __device__ constexpr int dw_mt(int k16) {
  return (k16 % 3 == 0 && 3 * dw_nw(k16) * 4 <= 112) ? 3
       : (k16 % 2 == 0 && 2 * dw_nw(k16) * 4 <= 112) ? 2 : 1;
}

// One ring stage: raw x [Cp][ETH+2][XRW], dy [rows][DST] (composed into dY
// in place) and y [rows][EPIX], bf16.
__host__ __device__ constexpr int dw_stage_bytes(int k16) {
  return (16 * k16 * (ETH + 2) * XRW + 16 * dw_mt(k16) * (DST + EPIX)) * 2;
}

// Outside the ring: the transformed x operand [(ETH+2)*HW2][Cp+8] bf16, ds
// of the block's rows [2][rows] f32 and the transform's bf16-rounded (mul,
// add) [2][Cp] bf16.
__host__ __device__ constexpr int dw_fixed_bytes(int k16) {
  return (ETH + 2) * HW2 * (16 * k16 + 8) * 2 + 2 * 16 * dw_mt(k16) * 4 + 2 * 16 * k16 * 2;
}

// Ring stages: as many as fit, at most 3 (2 tiles in flight behind the one
// being multiplied).
__host__ __device__ constexpr int dw_stages(int k16) {
  return (SMEM_MAX - dw_fixed_bytes(k16)) / dw_stage_bytes(k16) < 3
             ? (SMEM_MAX - dw_fixed_bytes(k16)) / dw_stage_bytes(k16) : 3;
}

__host__ __device__ constexpr int dw_smem(int k16) {
  return dw_stages(k16) * dw_stage_bytes(k16) + dw_fixed_bytes(k16);
}

static Geo make_dw_geo(int N, int C, int H, int W) {
  Geo g = make_geo(N, C, H, W);
  g.nty = H / ETH;
  g.ntiles = N * g.nty * g.ntx;
  return g;
}

__device__ __forceinline__ void dw_tile_coords(const Geo& g, int tile, int& n, int& oy0, int& ox0) {
  const int tx = tile % g.ntx;
  const int r = tile / g.ntx;
  oy0 = (r % g.nty) * ETH;
  n = r / g.nty;
  ox0 = tx * TW;
}

// 16-byte asynchronous copy global -> shared; !valid copies nothing and
// fills the 16 bytes with zeros (src is not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}

// The input transform on two bf16 of a 32-bit word: relu(bf16(bf16(x *
// mul_r) + add_r)).  Packed bf16 arithmetic with explicit .rn (no
// contraction into an fma) rounds each step once, which is the
// reference's f32-then-round: a product of two bf16 is exact in f32, and an
// f32 sum of two bf16 is exact or too far from a bf16 midpoint to round
// twice.
__device__ __forceinline__ uint32_t pre2(uint32_t x, uint32_t m, uint32_t a) {
  uint32_t v;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(v) : "r"(x), "r"(m));
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(v) : "r"(v), "r"(a));
  asm("max.bf16x2 %0, %1, %2;\n" : "=r"(v) : "r"(v), "r"(0u));
  return v;
}

// dY = bf16((dy + ds0) + (2*y)*ds1) for the two bf16 of a 32-bit word, with
// no contraction into an FMA: the plain version's roundings, so dY is the
// same bf16.
__device__ __forceinline__ uint32_t fold2(uint32_t d, uint32_t yv, float s0, float s1) {
  return pack_bf16(__fadd_rn(__fadd_rn(__uint_as_float(d << 16), s0),
                             __fmul_rn(__fmul_rn(2.f, __uint_as_float(yv << 16)), s1)),
                   __fadd_rn(__fadd_rn(__uint_as_float(d & 0xffff0000u), s0),
                             __fmul_rn(__fmul_rn(2.f, __uint_as_float(yv & 0xffff0000u)), s1)));
}

// Issue the copies of one tile into ring stage st: x rows oy0-1..oy0+ETH of
// every channel < C (columns ox0-8..ox0+39), dy (and y with fuse) rows
// oy0..oy0+ETH-1 of the block's rows < C.  Rows and chunks outside the
// image are zero-filled; needs W % 8 == 0 and 16-byte aligned tensors.
template <int K16>
__device__ __forceinline__ void dw_issue(bf16* st, const bf16* __restrict__ x,
                                         const bf16* __restrict__ dy, const bf16* __restrict__ y,
                                         const Geo& g, int fuse, int co_base, int n, int oy0,
                                         int ox0) {
  constexpr int CP = 16 * K16, ROWS = 16 * dw_mt(K16), XR = ETH + 2;
  const uint32_t xs = smem_addr(st);
  for (int e = threadIdx.x; e < g.C * XR * (XRW / 8); e += NT) {
    const int ch = e % (XRW / 8), rr = e / (XRW / 8);
    const int r = rr % XR, ci = rr / XR;
    const int iy = oy0 - 1 + r, ix = ox0 - 8 + 8 * ch;
    const bool ok = iy >= 0 && iy < g.H && ix >= 0 && ix < g.W;
    const bf16* src = x + (((size_t)n * g.C + ci) * g.H + iy) * g.W + ix;
    cp_async16(xs + ((ci * XR + r) * XRW + 8 * ch) * 2, ok ? src : x, ok);
  }
  const uint32_t dys = xs + CP * XR * XRW * 2, ys = dys + ROWS * DST * 2;
  const int nrow = min(ROWS, g.C - co_base);
  for (int e = threadIdx.x; e < nrow * ETH * (TW / 8); e += NT) {
    const int ch = e % (TW / 8), rr = e / (TW / 8);
    const int r = rr % ETH, co = rr / ETH;
    const int ox = ox0 + 8 * ch;
    const bool ok = ox < g.W;
    const size_t idx = (((size_t)n * g.C + co_base + co) * g.H + oy0 + r) * g.W + ox;
    cp_async16(dys + (co * DST + r * TW + 8 * ch) * 2, ok ? dy + idx : dy, ok);
    if (fuse) cp_async16(ys + (co * EPIX + r * TW + 8 * ch) * 2, ok ? y + idx : y, ok);
  }
}

// The staged raw x of a tile -> the transformed operand tile
// xop[(r*HW2 + c)*(Cp+8) + ci] = t[n, ci, oy0-1+r, ox0-1+c], shared ->
// shared; a thread takes 8 channels of a pixel, two pixels at a time so
// that their 16 loads are in flight together.  By position, never by
// value: the halo, columns >= W and channels >= C are 0 (the zero-filled
// raw would give relu(add)).  TR: the tile's output rows (the raw stage
// holds TR + 2 rows of each channel).
template <int K16, int TR = ETH>
__device__ __forceinline__ void dw_transform(bf16* xop, const bf16* raw, const bf16* pmb,
                                             bool pre, const Geo& g, int oy0, int ox0) {
  constexpr int CP = 16 * K16, CPS = CP + 8, XR = TR + 2, NPX = XR * HW2;
  constexpr int ITEMS = NPX * (CP / 8);
  const uint16_t* rw = reinterpret_cast<const uint16_t*>(raw);
  for (int e0 = threadIdx.x; e0 < ITEMS; e0 += 2 * NT) {
    uint32_t w[2][4], keep[2][4];
    int grp[2], dst[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = e0 + u * NT;
      grp[u] = e / NPX;
      const int p = e - grp[u] * NPX;
      const int r = p / HW2, c = p - r * HW2;
      const int iy = oy0 - 1 + r, ix = ox0 - 1 + c;
      const bool inside = e < ITEMS && iy >= 0 && iy < g.H && ix >= 0 && ix < g.W;
      dst[u] = e < ITEMS ? p * CPS + grp[u] * 8 : -1;
      const uint16_t* src = rw + (grp[u] * 8 * XR + r) * XRW + c + 7;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int ci = grp[u] * 8 + 2 * jj;
        const bool lo = inside && ci < g.C, hi = inside && ci + 1 < g.C;
        keep[u][jj] = (lo ? 0xffffu : 0u) | (hi ? 0xffff0000u : 0u);
        w[u][jj] = (lo ? (uint32_t)src[2 * jj * XR * XRW] : 0u) |
                   (hi ? (uint32_t)src[(2 * jj + 1) * XR * XRW] << 16 : 0u);
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (dst[u] < 0) continue;
      if (pre) {
        const uint4 m4 = *reinterpret_cast<const uint4*>(&pmb[grp[u] * 8]);
        const uint4 a4 = *reinterpret_cast<const uint4*>(&pmb[CP + grp[u] * 8]);
        w[u][0] = pre2(w[u][0], m4.x, a4.x) & keep[u][0];
        w[u][1] = pre2(w[u][1], m4.y, a4.y) & keep[u][1];
        w[u][2] = pre2(w[u][2], m4.z, a4.z) & keep[u][2];
        w[u][3] = pre2(w[u][3], m4.w, a4.w) & keep[u][3];
      }
      *reinterpret_cast<uint4*>(&xop[dst[u]]) = make_uint4(w[u][0], w[u][1], w[u][2], w[u][3]);
    }
  }
}

// The staged dy of a tile -> dY in place (with fuse: the stats cotangent
// folded in, and written out with 16-byte stores).  By position, never by
// value: rows >= C and pixels at ox >= W are 0 in the operand (the
// zero-filled dy would give ds0), and are not written out.
template <int K16>
__device__ __forceinline__ void dw_compose(bf16* dys, const bf16* ys, const float* dss,
                                           bf16* __restrict__ dY, const Geo& g, int fuse,
                                           int co_base, int n, int oy0, int ox0) {
  constexpr int ROWS = 16 * dw_mt(K16), CH = EPIX / 8;
  for (int e = threadIdx.x; e < ROWS * CH; e += NT) {
    const int co = e / CH, k = e - co * CH;
    const int r = k / (TW / 8), c = (k - r * (TW / 8)) * 8;
    const int cog = co_base + co, ox = ox0 + c;
    uint4* d = reinterpret_cast<uint4*>(&dys[co * DST + r * TW + c]);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (cog < g.C && ox < g.W) {
      v = *d;
      if (fuse) {
        const uint4 yv = *reinterpret_cast<const uint4*>(&ys[co * EPIX + r * TW + c]);
        const float s0 = dss[co], s1 = dss[ROWS + co];
        v = make_uint4(fold2(v.x, yv.x, s0, s1), fold2(v.y, yv.y, s0, s1),
                       fold2(v.z, yv.z, s0, s1), fold2(v.w, yv.w, s0, s1));
        *reinterpret_cast<uint4*>(&dY[(((size_t)n * g.C + cog) * g.H + oy0 + r) * g.W + ox]) = v;
      }
    }
    *d = v;
  }
}

// The synchronous form of dw_compose, from device memory, one element at a
// time (any W, any alignment).
template <int K16>
__device__ __forceinline__ void dw_compose_sync(bf16* dys, const bf16* __restrict__ dy,
                                                const bf16* __restrict__ y, const float* dss,
                                                bf16* __restrict__ dY, const Geo& g, int fuse,
                                                int co_base, int n, int oy0, int ox0) {
  constexpr int ROWS = 16 * dw_mt(K16);
  for (int e = threadIdx.x; e < ROWS * EPIX; e += NT) {
    const int co = e / EPIX, p = e - co * EPIX;
    const int r = p / TW, c = p - r * TW;
    const int cog = co_base + co, ox = ox0 + c;
    float v = 0.f;
    if (cog < g.C && ox < g.W) {
      const size_t idx = (((size_t)n * g.C + cog) * g.H + oy0 + r) * g.W + ox;
      v = __bfloat162float(dy[idx]);
      if (fuse) {
        v = bf16r(__fadd_rn(__fadd_rn(v, dss[co]),
                            __fmul_rn(__fmul_rn(2.f, __bfloat162float(y[idx])), dss[ROWS + co])));
        dY[idx] = __float2bfloat16(v);
      }
    }
    dys[co * DST + p] = __float2bfloat16(v);
  }
}

// Blocks: blockIdx = slab * (Cp / rows) + row block.  A slab's blocks walk
// the tiles slab, slab + nslab, ...; async_copy picks the ring (else the
// synchronous fill).
template <int K16>
__global__ void __launch_bounds__(NT, 1)
conv_dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
               const bf16* __restrict__ y, const float* __restrict__ ds,
               const float* __restrict__ mul, const float* __restrict__ add,
               bf16* __restrict__ dY, float* __restrict__ partial, Geo g, int pre, int fuse,
               int async_copy) {
  constexpr int CP = 16 * K16, CPS = CP + 8, MT = dw_mt(K16), NW = dw_nw(K16);
  constexpr int ROWS = 16 * MT, NRB = K16 / MT, NS = dw_stages(K16);
  constexpr int STAGE = dw_stage_bytes(K16) / 2, XRAW = CP * (ETH + 2) * XRW;
  constexpr int N8 = 9 * CP / 8, CP8 = CP / 8, NP = (NW + 1) / 2;
  static_assert(NS >= 2, "E's ring needs two stages");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);                  // [NS][STAGE]
  bf16* xop = ring + NS * STAGE;                                    // [(ETH+2)*HW2][CPS]
  float* dss = reinterpret_cast<float*>(xop + (ETH + 2) * HW2 * CPS);  // [2][ROWS]
  bf16* pmb = reinterpret_cast<bf16*>(dss + 2 * ROWS);              // [2][Cp]
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int rb = blockIdx.x % NRB, slab = blockIdx.x / NRB, nslab = gridDim.x / NRB;
  const int co_base = rb * ROWS, C = g.C;
  for (int e = t; e < 2 * ROWS; e += NT) {
    const int which = e / ROWS, co = co_base + e - which * ROWS;
    dss[e] = (fuse && co < C) ? ds[which * C + co] : 0.f;
  }
  for (int e = t; e < 2 * CP; e += NT) {
    const int which = e / CP, ci = e - which * CP;
    pmb[e] = __float2bfloat16((pre && ci < C) ? (which ? add : mul)[ci] : 0.f);
  }

  // Per-lane ldmatrix offsets, fixed for the whole kernel.  A: dY rows
  // a_row, pixels a_col.  B: the warp's n8 tiles q = warp*NW + j in pairs,
  // one ldmatrix.x4.trans per pair (lanes 0-15 address tile j, lanes 16-31
  // tile j+1): pixel row b_k of tap (kh, kw), channels ci0..ci0+7.  Tiles
  // past the last (q >= N8) load tile N8-1 and are not multiplied.
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int b_k = (lane & 7) + ((lane >> 3) & 1) * 8;
  const uint32_t a_off = (a_row * DST + a_col) * 2;
  const int nj = N8 - warp * NW;  // this warp's n8 tiles (may exceed NW, may be <= 0)
  uint32_t b_off[NP];
#pragma unroll
  for (int pp = 0; pp < NP; ++pp) {
    const int q = min(warp * NW + 2 * pp + (lane >> 4), N8 - 1);
    const int tap = q / CP8, ci0 = (q - tap * CP8) * 8;
    const int kh = tap / 3, kw = tap - kh * 3;
    b_off[pp] = smem_addr(xop) + ((kh * HW2 + b_k + kw) * CPS + ci0) * 2;
  }
  float acc[MT][NW][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NW; ++j) acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;

  // dk[rows][q*8..] += dY[rows][pixels] * xop[pixels + tap][ci]: per k-step
  // every fragment is loaded before the first product.
  auto mma_tile = [&](const bf16* dys) {
    const uint32_t a_base = smem_addr(dys) + a_off;
#pragma unroll
    for (int kc = 0; kc < EPIX; kc += 16) {
      const int r = kc / TW, c0 = kc - r * TW;
      const uint32_t b_step = (r * HW2 + c0) * CPS * 2;
      uint32_t af[MT][4], bfr[2 * NP][2];
#pragma unroll
      for (int m = 0; m < MT; ++m) ldsm_x4(af[m], a_base + (m * 16 * DST + kc) * 2);
#pragma unroll
      for (int pp = 0; pp < NP; ++pp) {
        if (2 * pp + 1 < NW) {
          uint32_t b4[4];
          ldsm_x4_trans(b4, b_off[pp] + b_step);
          bfr[2 * pp][0] = b4[0]; bfr[2 * pp][1] = b4[1];
          bfr[2 * pp + 1][0] = b4[2]; bfr[2 * pp + 1][1] = b4[3];
        } else {
          ldsm_x2_trans(bfr[2 * pp], b_off[pp] + b_step);
        }
      }
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        if (j < nj) {
#pragma unroll
          for (int m = 0; m < MT; ++m) mma_bf16(acc[m][j], af[m], bfr[j]);
        }
      }
    }
  };

  const int ntl = (g.ntiles - slab + nslab - 1) / nslab;  // this slab's tiles
  if (async_copy) {
    auto issue = [&](int k) {
      int n, oy0, ox0;
      dw_tile_coords(g, slab + k * nslab, n, oy0, ox0);
      dw_issue<K16>(ring + (k % NS) * STAGE, x, dy, y, g, fuse, co_base, n, oy0, ox0);
    };
    for (int k = 0; k < NS - 1; ++k) {
      if (k < ntl) issue(k);
      cp_async_commit();
    }
    for (int i = 0; i < ntl; ++i) {
      __syncthreads();  // tile i-1's products done: its stage and xop are free
      if (i + NS - 1 < ntl) issue(i + NS - 1);
      cp_async_commit();
      cp_async_wait<NS - 1>();  // this thread's copies of tile i have landed
      __syncthreads();          // ... and every thread's
      int n, oy0, ox0;
      dw_tile_coords(g, slab + i * nslab, n, oy0, ox0);
      bf16* st = ring + (i % NS) * STAGE;
      dw_transform<K16>(xop, st, pmb, pre != 0, g, oy0, ox0);
      dw_compose<K16>(st + XRAW, st + XRAW + ROWS * DST, dss, dY, g, fuse, co_base, n, oy0, ox0);
      __syncthreads();
      mma_tile(st + XRAW);
    }
  } else {
    bf16* dys = ring + XRAW;  // stage 0's dY
    for (int i = 0; i < ntl; ++i) {
      int n, oy0, ox0;
      dw_tile_coords(g, slab + i * nslab, n, oy0, ox0);
      __syncthreads();  // ds staged / previous tile consumed
      fill_tile(xop, x, pmb, pre != 0, g, n, oy0, ox0);
      dw_compose_sync<K16>(dys, dy, y, dss, dY, g, fuse, co_base, n, oy0, ox0);
      __syncthreads();
      mma_tile(dys);
    }
  }

  // partial[slab][co][tap*Cp + ci] for the block's rows
  const size_t width = 9 * (size_t)CP;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    if (j >= nj) break;
    const int col = (warp * NW + j) * 8 + (lane & 3) * 2;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = co_base + m * 16 + half * 8 + (lane >> 2);
        float* dst = partial + ((size_t)slab * CP + row) * width + col;
        dst[0] = acc[m][j][2 * half];
        dst[1] = acc[m][j][2 * half + 1];
      }
  }
}

// ---------------------------------------------------------------------------
// D96: kernel D at Cp = 96 (every mode), one block per SM
// ---------------------------------------------------------------------------

#define CP96 96
#define CPS96 (CP96 + 8)                 // operand and weight row stride (elements)
#define SLAB96 (CP96 * CPS96)            // one tap's packed weights [C_out][CPS96]
#define WST96 3                          // weight ring stages
#define XRAW96 (CP96 * (ETH + 2) * XRW)  // the raw x stage: dw_issue's layout
#define XOP96 ((ETH + 2) * HW2 * CPS96)  // the transformed operand tile
#define YST96 (TW + 8)                   // a warp's y staging row (elements)
#define D96_SMEM                                                                  \
  ((XRAW96 + XOP96 + WST96 * SLAB96 + 8 * 48 * YST96) * 2 + (8 * 2 * 48 + 3 * CP96) * 4 + \
   2 * CP96 * 2 + WST96 * 8)

// The weights of one call at padded width CP (D96: 96, D48: 48), packed
// once: wp[tap][co][ci] = bf16(w[co][ci][tap]), with flip
// bf16(w[ci][co][8 - tap]); 0 for co or ci >= C and in the 8-column skew.
template <int CP>
__global__ void pack_w_kernel(const float* __restrict__ w, bf16* __restrict__ wp, int C,
                              int flip) {
  constexpr int CPS = CP + 8, SLAB = CP * CPS;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= 9 * SLAB) return;
  const int tap = e / SLAB, rem = e - tap * SLAB;
  const int co = rem / CPS, ci = rem - co * CPS;
  float v = 0.f;
  if (co < C && ci < C)
    v = flip ? w[((size_t)ci * C + co) * 9 + 8 - tap] : w[((size_t)co * C + ci) * 9 + tap];
  wp[e] = __float2bfloat16(v);
}

// A ring stage's barrier: one arrival (the issuing thread's, with the
// slab's byte count) per use; the bulk copy completes the bytes.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_addr(bar)) : "memory");
}

// One tap's packed weights (a contiguous slab) -> a weight ring stage, as
// one bulk copy by the calling thread, completing on the stage's barrier.
__device__ __forceinline__ void d96_issue_w(bf16* st, const bf16* __restrict__ wp, int tap,
                                            uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // after the stage's last reads
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(SLAB96 * 2) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(st)), "l"(wp + (size_t)tap * SLAB96), "r"(SLAB96 * 2), "r"(smem_addr(bar))
      : "memory");
}

// Wait for the phase of the stage's barrier with this parity to complete.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra.uni DONE;\nbra.uni LAB_WAIT;\nDONE:\n}\n"
      :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// A tile's raw x copies: dw_issue's x loop (rows oy0-1..oy0+TR of every
// channel < C, columns ox0-8..ox0+39, zero-filled outside the image) into
// the raw stage, x only; TR: the tile's output rows.
template <int TR>
__device__ __forceinline__ void issue_x_rows(bf16* st, const bf16* __restrict__ x, const Geo& g,
                                             int n, int oy0, int ox0) {
  constexpr int XR = TR + 2, CH = XRW / 8;
  const uint32_t xs = smem_addr(st);
  for (int e = threadIdx.x; e < g.C * XR * CH; e += NT) {
    const int ch = e % CH, rr = e / CH;
    const int r = rr % XR, ci = rr / XR;
    const int iy = oy0 - 1 + r, ix = ox0 - 8 + 8 * ch;
    const bool ok = iy >= 0 && iy < g.H && ix >= 0 && ix < g.W;
    const bf16* src = x + (((size_t)n * g.C + ci) * g.H + iy) * g.W + ix;
    cp_async16(xs + ((ci * XR + r) * XRW + 8 * ch) * 2, ok ? src : x, ok);
  }
}

// The blocks walk the tiles slab, slab + nslab, ... (E's 4 x 32-pixel
// tiles, all 96 C_out).  Warp = (C_out half hh, tile row wr): 48 rows x 32
// pixels, D's MT = 3 accumulators and product loop.  Each step s = 9 * tile
// + tap waits for its weight slab (on the stage's barrier), then thread 0
// issues the slab of step s + 2 into the stage step s - 1 read.  A tile's
// first step waits for its raw x (cp.async, this tile's only copy group),
// transforms it (dw_transform: the halo, columns >= W and channels >= C
// are 0 by position) and issues the next tile's x into the emptied stage,
// so those copies have the whole tile's products to land.
__global__ void __launch_bounds__(NT, 1)
conv_fwd96_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wp,
                  const float* __restrict__ mul, const float* __restrict__ add,
                  const bf16* __restrict__ xpost, bf16* __restrict__ y,
                  float* __restrict__ partial, Geo g, int pre, int stats, int post) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* raw = reinterpret_cast<bf16*>(smem_raw);                   // [Cp][ETH+2][XRW]
  bf16* xop = raw + XRAW96;                                         // [(ETH+2)*HW2][CPS96]
  bf16* wring = xop + XOP96;                                        // [WST96][Cp][CPS96]
  bf16* ystage = wring + WST96 * SLAB96;                            // [8][48][YST96]
  float* red = reinterpret_cast<float*>(ystage + 8 * 48 * YST96);   // [8][2][48]
  float* pm = red + 8 * 2 * 48;                                     // post: [3][Cp]
  bf16* pmb = reinterpret_cast<bf16*>(pm + 3 * CP96);               // pre: [2][Cp]
  uint64_t* wbar = reinterpret_cast<uint64_t*>(pmb + 2 * CP96);     // [WST96]
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int hh = warp >> 2, wr = warp & 3;
  const int slab = blockIdx.x, nslab = gridDim.x, C = g.C;
  if (post) {
    // pm[ci] = bf16(mul[ci]), pm[Cp + ci] = bf16(add[ci]), pm[2Cp + ci] = mul[ci]
    for (int e = t; e < 3 * CP96; e += NT) {
      const int which = e / CP96, ci = e - which * CP96;
      const float v = ci < C ? (which == 1 ? add : mul)[ci] : 0.f;
      pm[e] = which == 2 ? v : bf16r(v);
    }
  }
  for (int e = t; e < 2 * CP96; e += NT) {
    const int which = e / CP96, ci = e - which * CP96;
    pmb[e] = __float2bfloat16((pre && ci < C) ? (which ? add : mul)[ci] : 0.f);
  }
  if (t == 0) {
    for (int k = 0; k < WST96; ++k) mbar_init(&wbar[k]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int b_n = (lane & 7) + (lane >> 4) * 8, b_k = ((lane >> 3) & 1) * 8;
  const uint32_t a_off = ((hh * 48 + a_row) * CPS96 + a_col) * 2;
  const uint32_t wring_s = smem_addr(wring), xop_s = smem_addr(xop);
  float s1[3][2], s2[3][2];
#pragma unroll
  for (int m = 0; m < 3; ++m) s1[m][0] = s1[m][1] = s2[m][0] = s2[m][1] = 0.f;

  // Stage s % WST96 holds step s's slab; its (s / WST96)-th barrier phase
  // completes when the slab has landed.
  const int ntl = (g.ntiles - slab + nslab - 1) / nslab;  // this block's tiles
  const int nsteps = 9 * ntl;
  {
    int n0, oy, ox;
    dw_tile_coords(g, slab, n0, oy, ox);
    issue_x_rows<ETH>(raw, x, g, n0, oy, ox);
    cp_async_commit();
  }
  if (t == 0)
    for (int k = 0; k < WST96 - 1 && k < nsteps; ++k)
      d96_issue_w(wring + k * SLAB96, wp, k % 9, &wbar[k]);

  for (int i = 0; i < ntl; ++i) {
    int n, oy0, ox0;
    dw_tile_coords(g, slab + i * nslab, n, oy0, ox0);
    int n1 = 0, oy1 = 0, ox1 = 0;
    if (i + 1 < ntl) dw_tile_coords(g, slab + (i + 1) * nslab, n1, oy1, ox1);
    float acc[3][4][4];
#pragma unroll
    for (int m = 0; m < 3; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int s = 9 * i + tap;
      if (tap == 0) cp_async_wait<0>();  // this thread's copies of tile i's x landed
      mbar_wait(&wbar[s % WST96], (s / WST96) & 1);  // slab s landed
      __syncthreads();  // every thread's x copies landed; step s-1's products are done
      if (tap == 0) {
        dw_transform<CP96 / 16>(xop, raw, pmb, pre != 0, g, oy0, ox0);
        __syncthreads();  // the operand tile is ready; the raw stage is free
        if (i + 1 < ntl) issue_x_rows<ETH>(raw, x, g, n1, oy1, ox1);
        cp_async_commit();
      }
      if (t == 0 && s + WST96 - 1 < nsteps)  // into the stage step s-1 read
        d96_issue_w(wring + ((s + WST96 - 1) % WST96) * SLAB96, wp, (s + WST96 - 1) % 9,
                    &wbar[(s + WST96 - 1) % WST96]);

      const int kh = tap / 3, kw = tap - kh * 3;
      const uint32_t arow = wring_s + (s % WST96) * SLAB96 * 2 + a_off;
      const uint32_t brow = xop_s + (((wr + kh) * HW2 + b_n + kw) * CPS96 + b_k) * 2;
#pragma unroll
      for (int cc = 0; cc < CP96; cc += 16) {
        uint32_t af[3][4], bfr[4][2];
#pragma unroll
        for (int m = 0; m < 3; ++m) ldsm_x4(af[m], arow + (m * 16 * CPS96 + cc) * 2);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t r[4];
          ldsm_x4(r, brow + (np * 16 * CPS96 + cc) * 2);
          bfr[2 * np][0] = r[0]; bfr[2 * np][1] = r[1];
          bfr[2 * np + 1][0] = r[2]; bfr[2 * np + 1][1] = r[3];
        }
#pragma unroll
        for (int m = 0; m < 3; ++m)
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16(acc[m][j], af[m], bfr[j]);
      }
    }

    // Epilogue: the rounded y (post: dt) of the warp's 48 rows x 32
    // pixels into its own staging rows, with the statistics of the rounded
    // y as conv_fwd_kernel takes them; then 16-byte chunks of a row out
    // (W % 8 == 0: a chunk is all inside or all outside).  post reads x in
    // the same chunks and applies conv_fwd_kernel's per-element chain, so
    // dx is bit-equal to it; (dmul, dadd) sum in the chunks' order.
    bf16* ysm = ystage + warp * 48 * YST96;
#pragma unroll
    for (int m = 0; m < 3; ++m)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m * 16 + half * 8 + (lane >> 2);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = j * 8 + (lane & 3) * 2;
          const float v0 = acc[m][j][2 * half], v1 = acc[m][j][2 * half + 1];
          *reinterpret_cast<uint32_t*>(&ysm[r * YST96 + c]) = pack_bf16(v0, v1);
          if (!post) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (ox0 + c + e < g.W) {
                const float f = bf16r(e ? v1 : v0);
                s1[m][half] += f;
                s2[m][half] += f * f;
              }
            }
          }
        }
      }
    __syncwarp();
    const int oy = oy0 + wr, q = lane & 3, ox = ox0 + 8 * q;
#pragma unroll
    for (int m = 0; m < 3; ++m)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m * 16 + half * 8 + (lane >> 2), co = hh * 48 + r;
        if (co >= C || ox >= g.W) continue;
        const size_t at = (((size_t)n * C + co) * g.H + oy) * g.W + ox;
        uint4 v = *reinterpret_cast<const uint4*>(&ysm[r * YST96 + 8 * q]);
        if (post) {
          const float mr = pm[co], ar = pm[CP96 + co], mw = pm[2 * CP96 + co];
          const uint4 xv = *reinterpret_cast<const uint4*>(&xpost[at]);
          uint32_t* vw = reinterpret_cast<uint32_t*>(&v);
          const uint32_t* xw = reinterpret_cast<const uint32_t*>(&xv);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            float o[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float dt = __uint_as_float(e ? vw[k] & 0xffff0000u : vw[k] << 16);
              const float xf = __uint_as_float(e ? xw[k] & 0xffff0000u : xw[k] << 16);
              const float t2 = bf16r(__fadd_rn(bf16r(__fmul_rn(xf, mr)), ar));
              const float dtm = t2 > 0.f ? dt : 0.f;
              o[e] = __fmul_rn(dtm, mw);
              s1[m][half] = __fadd_rn(s1[m][half], __fmul_rn(dtm, xf));
              s2[m][half] = __fadd_rn(s2[m][half], dtm);
            }
            vw[k] = pack_bf16(o[0], o[1]);
          }
        }
        *reinterpret_cast<uint4*>(&y[at]) = v;
      }
  }
  if (!stats && !post) return;

  // Block partial: sum the 4 lanes of a row, then the 4 warps of a C_out
  // half in row order.
#pragma unroll
  for (int m = 0; m < 3; ++m)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float a = s1[m][half], b = s2[m][half];
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      b += __shfl_xor_sync(0xffffffffu, b, 1);
      b += __shfl_xor_sync(0xffffffffu, b, 2);
      if ((lane & 3) == 0) {
        const int r = m * 16 + half * 8 + (lane >> 2);
        red[(warp * 2 + 0) * 48 + r] = a;
        red[(warp * 2 + 1) * 48 + r] = b;
      }
    }
  __syncthreads();
  for (int e = t; e < 2 * CP96; e += NT) {
    const int which = e / CP96, co = e - which * CP96;
    if (co >= C) continue;
    const int h2 = co / 48, r = co - h2 * 48;
    float sum = 0.f;
    for (int w4 = 0; w4 < 4; ++w4) sum += red[((h2 * 4 + w4) * 2 + which) * 48 + r];
    partial[((size_t)slab * 2 + which) * C + co] = sum;
  }
}

// ---------------------------------------------------------------------------
// D48: kernel D at Cp = 48 (every mode), one block per SM
// ---------------------------------------------------------------------------
//
// Replaces, at channels that pad to 48 (HRNet-W48's branch 0), the TPU
// kernels D replaces: pallas_conv.py:328 _conv3x3_nchw_impl (-> _kernel_kstack)
// and its post mode, pallas_conv.py:223 _kernel_kstack(post=True).
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16): [8,48,256,256] moves
// 100.7 MB (x read once, y written once) in 30.1 us, post 151 MB (dY and x
// read, dx written) in 45.1 us; its 21.7 GFLOP take 22.0 us: bytes.
// Design: one persistent block per SM walks tiles of 8 x 32 output pixels x
// all 48 C_out; warp = tile row (48 rows x 32 pixels, D's MT = 3
// accumulators and product loop).  The weights are packed once per call
// (pack_w_kernel<48>, flip applied) into a bf16 scratch [9][48][56] and
// copied into shared memory once per block by one cp.async.bulk on an
// mbarrier: all nine tap slabs (48,384 bytes) stay resident, with no
// per-tile reload and no per-block f32 scatter.  x goes through XS48 raw
// stages: a tile's raw rows (issue_x_rows, 16-byte cp.async zero-filled
// outside the image) are issued XS48 tiles ahead, into the stage the
// transform (dw_transform: position masks, packed bf16 pre arithmetic) has
// just emptied, so they land while the tiles between run their products.
// Two block barriers per tile.  The epilogue is D96's: the rounded y (post:
// dt) through per-warp staging rows and out in 16-byte chunks; post's x in
// the same chunks, loaded before the tile's products.  The k order
// (tap-major, then 16-channel steps) and the mma.sync m16n8k16 shape are
// conv_fwd_kernel's, so y, the dx conv and post's dx are bit-equal to it;
// the [2,C] sums are fixed-order partials (lanes, the 8 warps in row order,
// the blocks in order).  What still holds it above the bound, largest
// first: the products (mma.sync, every fragment from shared memory by
// ldmatrix, three of a k-step's five loads being weights that are the same
// for every tile); the transform and the copies, between the two block
// barriers of a tile; the staging reads x 1.875 x (a 48-column raw row for
// 32 outputs, 10 rows for 8: ~94 MB); ~15.5 tiles per block, a tail of one.

#define CP48 48
#define CPS48 (CP48 + 8)                 // operand and weight row stride (elements)
#define SLAB48 (CP48 * CPS48)            // one tap's packed weights [C_out][CPS48]
#define XS48 2                           // raw x stages
#define XRAW48 (CP48 * (TH + 2) * XRW)   // one raw x stage: dw_issue's layout, TH rows
#define XOP48 ((TH + 2) * HW2 * CPS48)   // the transformed operand tile
#define YST48 (TW + 8)                   // a warp's y staging row (elements)
#define D48_SMEM                                                                  \
  ((XS48 * XRAW48 + XOP48 + 9 * SLAB48 + 8 * CP48 * YST48) * 2 +                  \
   (8 * 2 * CP48 + 3 * CP48) * 4 + 2 * CP48 * 2 + 8)

// bytes of global memory -> shared memory as one bulk copy by the calling
// thread, completing on bar (16-byte aligned, a multiple of 16 bytes).
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// The blocks walk D's 8 x 32-pixel tiles slab, slab + nslab, ...  Tile i's
// raw x is copy group i (the prologue issues tiles 0..XS48-1); it is waited,
// transformed into the operand tile, and its stage refilled with tile i +
// XS48, before tile i's products.
__global__ void __launch_bounds__(NT, 1)
conv_fwd48_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wp,
                  const float* __restrict__ mul, const float* __restrict__ add,
                  const bf16* __restrict__ xpost, bf16* __restrict__ y,
                  float* __restrict__ partial, Geo g, int pre, int stats, int post) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* raw = reinterpret_cast<bf16*>(smem_raw);                    // [XS48][Cp][TH+2][XRW]
  bf16* xop = raw + XS48 * XRAW48;                                   // [(TH+2)*HW2][CPS48]
  bf16* wsm = xop + XOP48;                                           // [9][Cp][CPS48]
  bf16* ystage = wsm + 9 * SLAB48;                                   // [8][Cp][YST48]
  float* red = reinterpret_cast<float*>(ystage + 8 * CP48 * YST48);  // [8][2][Cp]
  float* pm = red + 8 * 2 * CP48;                                    // post: [3][Cp]
  bf16* pmb = reinterpret_cast<bf16*>(pm + 3 * CP48);                // pre: [2][Cp]
  uint64_t* wbar = reinterpret_cast<uint64_t*>(pmb + 2 * CP48);
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int slab = blockIdx.x, nslab = gridDim.x, C = g.C;
  if (post) {
    // pm[ci] = bf16(mul[ci]), pm[Cp + ci] = bf16(add[ci]), pm[2Cp + ci] = mul[ci]
    for (int e = t; e < 3 * CP48; e += NT) {
      const int which = e / CP48, ci = e - which * CP48;
      const float v = ci < C ? (which == 1 ? add : mul)[ci] : 0.f;
      pm[e] = which == 2 ? v : bf16r(v);
    }
  }
  for (int e = t; e < 2 * CP48; e += NT) {
    const int which = e / CP48, ci = e - which * CP48;
    pmb[e] = __float2bfloat16((pre && ci < C) ? (which ? add : mul)[ci] : 0.f);
  }
  if (t == 0) {
    mbar_init(wbar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (t == 0) bulk_load(wsm, wp, 9 * SLAB48 * 2, wbar);  // the host gives every block a tile

  const int ntl = (g.ntiles - slab + nslab - 1) / nslab;  // this block's tiles
  for (int k = 0; k < XS48; ++k) {
    if (k < ntl) {
      int n0, oy, ox;
      tile_coords(g, slab + k * nslab, n0, oy, ox);
      issue_x_rows<TH>(raw + k * XRAW48, x, g, n0, oy, ox);
    }
    cp_async_commit();
  }

  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int b_n = (lane & 7) + (lane >> 4) * 8, b_k = ((lane >> 3) & 1) * 8;
  const uint32_t a_off = (a_row * CPS48 + a_col) * 2;
  const uint32_t wsm_s = smem_addr(wsm), xop_s = smem_addr(xop);
  const int q = lane & 3;
  float s1[3][2], s2[3][2];
#pragma unroll
  for (int m = 0; m < 3; ++m) s1[m][0] = s1[m][1] = s2[m][0] = s2[m][1] = 0.f;

  for (int i = 0; i < ntl; ++i) {
    int n, oy0, ox0;
    tile_coords(g, slab + i * nslab, n, oy0, ox0);
    const int oy = oy0 + warp, ox = ox0 + 8 * q;
    // post: this lane's 16-byte chunks of x for the epilogue, in flight
    // through the staging and the products
    uint4 xv[3][2];
    if (post) {
#pragma unroll
      for (int m = 0; m < 3; ++m)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int co = m * 16 + half * 8 + (lane >> 2);
          xv[m][half] = make_uint4(0, 0, 0, 0);
          if (co < C && ox < g.W)
            xv[m][half] = *reinterpret_cast<const uint4*>(
                &xpost[(((size_t)n * C + co) * g.H + oy) * g.W + ox]);
        }
    }
    cp_async_wait<XS48 - 1>();  // this thread's copies of tile i have landed
    __syncthreads();            // ... and every thread's; tile i-1's products are done
    bf16* st = raw + (i % XS48) * XRAW48;
    dw_transform<CP48 / 16, TH>(xop, st, pmb, pre != 0, g, oy0, ox0);
    __syncthreads();  // the operand tile is ready; the raw stage is free
    if (i + XS48 < ntl) {
      int n2, oy2, ox2;
      tile_coords(g, slab + (i + XS48) * nslab, n2, oy2, ox2);
      issue_x_rows<TH>(st, x, g, n2, oy2, ox2);
    }
    cp_async_commit();
    if (i == 0) mbar_wait(wbar, 0);  // the resident weights have landed

    float acc[3][4][4];
#pragma unroll
    for (int m = 0; m < 3; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int kh = tap / 3, kw = tap - kh * 3;
      const uint32_t arow = wsm_s + tap * SLAB48 * 2 + a_off;
      const uint32_t brow = xop_s + (((warp + kh) * HW2 + b_n + kw) * CPS48 + b_k) * 2;
#pragma unroll
      for (int cc = 0; cc < CP48; cc += 16) {
        uint32_t af[3][4], bfr[4][2];
#pragma unroll
        for (int m = 0; m < 3; ++m) ldsm_x4(af[m], arow + (m * 16 * CPS48 + cc) * 2);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t r[4];
          ldsm_x4(r, brow + (np * 16 * CPS48 + cc) * 2);
          bfr[2 * np][0] = r[0]; bfr[2 * np][1] = r[1];
          bfr[2 * np + 1][0] = r[2]; bfr[2 * np + 1][1] = r[3];
        }
#pragma unroll
        for (int m = 0; m < 3; ++m)
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16(acc[m][j], af[m], bfr[j]);
      }
    }

    // Epilogue (D96's): the rounded y (post: dt) of the warp's 48 rows x 32
    // pixels into its staging rows, with the statistics of the rounded y as
    // conv_fwd_kernel takes them; then 16-byte chunks out (W % 8 == 0: a
    // chunk is all inside or all outside), post's chain per element on x's
    // chunk, (dmul, dadd) summed in the chunks' order.
    bf16* ysm = ystage + warp * CP48 * YST48;
#pragma unroll
    for (int m = 0; m < 3; ++m)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m * 16 + half * 8 + (lane >> 2);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = j * 8 + q * 2;
          const float v0 = acc[m][j][2 * half], v1 = acc[m][j][2 * half + 1];
          *reinterpret_cast<uint32_t*>(&ysm[r * YST48 + c]) = pack_bf16(v0, v1);
          if (!post) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (ox0 + c + e < g.W) {
                const float f = bf16r(e ? v1 : v0);
                s1[m][half] += f;
                s2[m][half] += f * f;
              }
            }
          }
        }
      }
    __syncwarp();
#pragma unroll
    for (int m = 0; m < 3; ++m)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int co = m * 16 + half * 8 + (lane >> 2);
        if (co >= C || ox >= g.W) continue;
        uint4 v = *reinterpret_cast<const uint4*>(&ysm[co * YST48 + 8 * q]);
        if (post) {
          const float mr = pm[co], ar = pm[CP48 + co], mw = pm[2 * CP48 + co];
          uint32_t* vw = reinterpret_cast<uint32_t*>(&v);
          const uint32_t* xw = reinterpret_cast<const uint32_t*>(&xv[m][half]);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            float o[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float dt = __uint_as_float(e ? vw[k] & 0xffff0000u : vw[k] << 16);
              const float xf = __uint_as_float(e ? xw[k] & 0xffff0000u : xw[k] << 16);
              const float t2 = bf16r(__fadd_rn(bf16r(__fmul_rn(xf, mr)), ar));
              const float dtm = t2 > 0.f ? dt : 0.f;
              o[e] = __fmul_rn(dtm, mw);
              s1[m][half] = __fadd_rn(s1[m][half], __fmul_rn(dtm, xf));
              s2[m][half] = __fadd_rn(s2[m][half], dtm);
            }
            vw[k] = pack_bf16(o[0], o[1]);
          }
        }
        *reinterpret_cast<uint4*>(&y[(((size_t)n * C + co) * g.H + oy) * g.W + ox]) = v;
      }
  }
  if (!stats && !post) return;

  // Block partial: sum the 4 lanes of a row, then the 8 warps in row order.
#pragma unroll
  for (int m = 0; m < 3; ++m)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float a = s1[m][half], b = s2[m][half];
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      b += __shfl_xor_sync(0xffffffffu, b, 1);
      b += __shfl_xor_sync(0xffffffffu, b, 2);
      if (q == 0) {
        const int r = m * 16 + half * 8 + (lane >> 2);
        red[(warp * 2 + 0) * CP48 + r] = a;
        red[(warp * 2 + 1) * CP48 + r] = b;
      }
    }
  __syncthreads();
  for (int e = t; e < 2 * CP48; e += NT) {
    const int which = e / CP48, co = e - which * CP48;
    if (co >= C) continue;
    float sum = 0.f;
    for (int wr = 0; wr < 8; ++wr) sum += red[(wr * 2 + which) * CP48 + co];
    partial[((size_t)slab * 2 + which) * C + co] = sum;
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

// post stages a third [Cp] f32 row of the fold (the raw mul).
static int fwd_smem(int cp, int post) {
  const int rows = 16 * fwd_mt(cp);
  return (rows * (9 * cp + 8) + (TH + 2) * HW2 * (cp + 8)) * 2 +
         (8 * 2 * rows + (post ? 3 : 2) * cp) * 4;
}

// out[0] = D's shared bytes, out[1] = D's blocks per tile (C_out split),
// out[2] = E's shared bytes, out[3] = E's blocks per slab (row split),
// out[4] = D's tiles per image plane (for the grid), out[5] = D's shared
// bytes in post mode.
extern "C" int branch_conv_plan(int C, int H, int W, int* out) {
  if (C < 1 || C > MAXC) return (int)cudaErrorInvalidValue;
  const Geo g = make_geo(1, C, H, W);
  const int mt = fwd_mt(g.Cp);
  out[0] = fwd_smem(g.Cp, 0);
  out[1] = (g.Cp + 16 * mt - 1) / (16 * mt);
  out[2] = dw_smem(g.Cp / 16);
  out[3] = g.Cp / 16 / dw_mt(g.Cp / 16);
  out[4] = g.ntiles;
  out[5] = fwd_smem(g.Cp, 1);
  return 0;
}

// E's tile plan: out[0] = shared bytes, out[1] = blocks per slab (row
// split), out[2] = dk rows per block, out[3] = tile rows, out[4] = ring
// stages, out[5] = tiles per image plane (for the grid).
extern "C" int branch_conv_dw_plan(int C, int H, int W, int* out) {
  if (C < 1 || C > MAXC) return (int)cudaErrorInvalidValue;
  const Geo g = make_dw_geo(1, C, H, W);
  const int k16 = g.Cp / 16;
  out[0] = dw_smem(k16);
  out[1] = k16 / dw_mt(k16);
  out[2] = 16 * dw_mt(k16);
  out[3] = ETH;
  out[4] = dw_stages(k16);
  out[5] = g.ntiles;
  return 0;
}

static bool geo_ok(int N, int C, int H, int W) {
  return N > 0 && C > 0 && C <= MAXC && H > 0 && H % TH == 0 && W > 0;
}

template <int MT>
static cudaError_t launch_fwd(const void* x, const void* w, const void* mul, const void* add,
                              const void* xpost, void* y, void* partial, const Geo& g, int pre,
                              int stats, int flip, int post, int grid, int nmt, cudaStream_t s) {
  const int smem = fwd_smem(g.Cp, post);
  cudaError_t err = cudaFuncSetAttribute(conv_fwd_kernel<MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  conv_fwd_kernel<MT><<<grid, NT, smem, s>>>(
      (const bf16*)x, (const float*)w, (const float*)mul, (const float*)add,
      (const bf16*)xpost, (bf16*)y, (float*)partial, g, pre, stats, flip, post, nmt);
  return cudaGetLastError();
}

// D's launch and, with sums, the fixed-order reduction of its partials.
static int run_fwd(const void* x, const void* w, const void* mul, const void* add,
                   const void* xpost, void* y, void* partial, void* sums, int N, int C, int H,
                   int W, int pre, int stats, int flip, int post, int nslab, void* stream) {
  if (!geo_ok(N, C, H, W) || nslab < 1) return (int)cudaErrorInvalidValue;
  const Geo g = make_geo(N, C, H, W);
  if (nslab > g.ntiles) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int mt = fwd_mt(g.Cp);
  const int nmt = (g.Cp + 16 * mt - 1) / (16 * mt);
  const int grid = nslab * nmt;
  cudaError_t err;
#define FWD_ARGS x, w, mul, add, xpost, y, partial, g, pre, stats, flip, post, grid, nmt, s
  switch (mt) {
    case 1: err = launch_fwd<1>(FWD_ARGS); break;
    case 2: err = launch_fwd<2>(FWD_ARGS); break;
    default: err = launch_fwd<3>(FWD_ARGS); break;
  }
#undef FWD_ARGS
  if (err != cudaSuccess || !sums) return (int)err;
  reduce_rows_kernel<<<(2 * C + 255) / 256, 256, 0, s>>>((const float*)partial, nslab, 2 * C,
                                                        (float*)sums);
  return (int)cudaGetLastError();
}

static bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// D96's plan: out[0] = shared bytes, out[1] = x stages, out[2] = weight
// stages, out[3] = tile rows, out[4] = tiles per image plane (for the
// grid), out[5] = packed weight elements (the wpack buffer).
extern "C" int branch_conv_fwd96_plan(int C, int H, int W, int* out) {
  const Geo g = make_dw_geo(1, C, H, W);
  if (C < 1 || g.Cp != CP96) return (int)cudaErrorInvalidValue;
  out[0] = D96_SMEM;
  out[1] = 1;
  out[2] = WST96;
  out[3] = ETH;
  out[4] = g.ntiles;
  out[5] = 9 * SLAB96;
  return 0;
}

// D48's plan: out[0] = shared bytes, out[1] = x stages, out[2] = tile
// rows, out[3] = blocks per SM (the occupancy calculator's, for the grid),
// out[4] = tiles per image plane (for the grid), out[5] = packed weight
// elements (the wpack buffer).
extern "C" int branch_conv_fwd48_plan(int C, int H, int W, int* out) {
  const Geo g = make_geo(1, C, H, W);
  if (C < 1 || g.Cp != CP48) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(conv_fwd48_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, D48_SMEM);
  if (err != cudaSuccess) return (int)err;
  int bps = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&bps, conv_fwd48_kernel, NT, D48_SMEM);
  if (err != cudaSuccess) return (int)err;
  out[0] = D48_SMEM;
  out[1] = XS48;
  out[2] = TH;
  out[3] = bps;
  out[4] = g.ntiles;
  out[5] = 9 * SLAB48;
  return 0;
}

// The weight pack of D96 or D48 (cp = its padded width) into wpack.
static cudaError_t launch_pack(const void* w, void* wpack, int C, int flip, int cp,
                               cudaStream_t s) {
  if (cp == CP96)
    pack_w_kernel<CP96><<<(9 * SLAB96 + 255) / 256, 256, 0, s>>>((const float*)w, (bf16*)wpack,
                                                                 C, flip);
  else
    pack_w_kernel<CP48><<<(9 * SLAB48 + 255) / 256, 256, 0, s>>>((const float*)w, (bf16*)wpack,
                                                                 C, flip);
  return cudaGetLastError();
}

// D96 or D48 (kern = its padded width, 96 or 48): the weights packed into
// wpack, then the persistent blocks (grid nslab <= tiles), then with sums
// the fixed-order reduction.  Needs C padding to kern, W % 8 == 0 and the
// activations and wpack 16-byte aligned.
static int run_fwd_packed(int kern, const void* x, const void* w, const void* mul,
                          const void* add, const void* xpost, void* y, void* partial, void* sums,
                          void* wpack, int N, int C, int H, int W, int pre, int stats, int flip,
                          int post, int nslab, void* stream) {
  if (!geo_ok(N, C, H, W) || nslab < 1 || (kern != CP96 && kern != CP48))
    return (int)cudaErrorInvalidValue;
  const Geo g = kern == CP96 ? make_dw_geo(N, C, H, W) : make_geo(N, C, H, W);
  if (g.Cp != kern || W % 8 != 0 || nslab > g.ntiles || !aligned16(x) || !aligned16(y) ||
      !aligned16(wpack) || (xpost && !aligned16(xpost)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = launch_pack(w, wpack, C, flip, kern, s);
  if (err != cudaSuccess) return (int)err;
  const auto kernel = kern == CP96 ? conv_fwd96_kernel : conv_fwd48_kernel;
  const int smem = kern == CP96 ? D96_SMEM : D48_SMEM;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<nslab, NT, smem, s>>>((const bf16*)x, (const bf16*)wpack, (const float*)mul,
                                 (const float*)add, (const bf16*)xpost, (bf16*)y,
                                 (float*)partial, g, pre, stats, post);
  err = cudaGetLastError();
  if (err != cudaSuccess || !sums) return (int)err;
  reduce_rows_kernel<<<(2 * C + 255) / 256, 256, 0, s>>>((const float*)partial, nslab, 2 * C,
                                                        (float*)sums);
  return (int)cudaGetLastError();
}

// Kernel D.  x [N,C,H,W] bf16; w [C,C,3,3] f32 (OIHW); mul, add [C] f32 (pre);
// y [N,C,H,W] bf16; partial [nslab][2][C] f32; sums [2][C] f32 (stats).
// kern = 96 takes D96, 48 D48 (wpack: bf16 scratch of the plan's size; the
// grid is nslab), 0 conv_fwd_kernel (the grid is nslab * D's C_out split);
// nslab <= tiles of the kernel taken.
extern "C" int branch_conv_fwd(const void* x, const void* w, const void* mul, const void* add,
                               void* y, void* partial, void* sums, void* wpack, int N, int C,
                               int H, int W, int pre, int stats, int flip, int nslab, int kern,
                               void* stream) {
  if (kern)
    return run_fwd_packed(kern, x, w, mul, add, nullptr, y, partial, stats ? sums : nullptr,
                          wpack, N, C, H, W, pre, stats, flip, 0, nslab, stream);
  return run_fwd(x, w, mul, add, nullptr, y, partial, stats ? sums : nullptr, N, C, H, W, pre,
                 stats, flip, 0, nslab, stream);
}

// Kernel D's post mode: the dx conv of dY [N,C,H,W] bf16 with the flipped
// w [C,C,3,3] f32, its epilogue fused: x [N,C,H,W] bf16 and mul, add [C]
// f32 (raw) of the forward conv's input transform; dx [N,C,H,W] bf16;
// partial [nslab][2][C] f32; sums [2][C] f32 = (dmul, dadd).  wpack and
// kern as in branch_conv_fwd.
extern "C" int branch_conv_dx_post(const void* dY, const void* w, const void* x,
                                   const void* mul, const void* add, void* dx, void* partial,
                                   void* sums, void* wpack, int N, int C, int H, int W,
                                   int nslab, int kern, void* stream) {
  if (kern)
    return run_fwd_packed(kern, dY, w, mul, add, x, dx, partial, sums, wpack, N, C, H, W, 0, 0,
                          1, 1, nslab, stream);
  return run_fwd(dY, w, mul, add, x, dx, partial, sums, N, C, H, W, 0, 0, 1, 1, nslab, stream);
}

// The weight pack alone, for C padding to 96 or 48: wpack [9][Cp][Cp + 8]
// bf16 from w [C,C,3,3] f32.
extern "C" int branch_conv_pack(const void* w, void* wpack, int C, int flip, void* stream) {
  const int cp = (C + 15) / 16 * 16;
  if (C < 1 || (cp != CP96 && cp != CP48)) return (int)cudaErrorInvalidValue;
  return (int)launch_pack(w, wpack, C, flip, cp, (cudaStream_t)stream);
}

template <int K16>
static cudaError_t launch_dw(const void* x, const void* dy, const void* y, const void* ds,
                             const void* mul, const void* add, void* dY, void* partial,
                             const Geo& g, int pre, int fuse, int async_copy, int grid,
                             cudaStream_t s) {
  const int smem = dw_smem(K16);
  cudaError_t err = cudaFuncSetAttribute(conv_dw_kernel<K16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  conv_dw_kernel<K16><<<grid, NT, smem, s>>>(
      (const bf16*)x, (const bf16*)dy, (const bf16*)y, (const float*)ds, (const float*)mul,
      (const float*)add, (bf16*)dY, (float*)partial, g, pre, fuse, async_copy);
  return cudaGetLastError();
}

// Kernel E.  x, dy [N,C,H,W] bf16; y [N,C,H,W] bf16 and ds [2][C] f32 (fuse);
// mul, add [C] f32 (pre); dY [N,C,H,W] bf16 (fuse); partial [nslab][Cp][9*Cp]
// f32; dk [C,C,3,3] f32 (OIHW).  The grid is nslab * (E's row split).
// async_copy = 1 stages through the cp.async ring, which needs W % 8 == 0
// and x, dy (y, dY with fuse) 16-byte aligned; 0 the synchronous fill.
extern "C" int branch_conv_dw(const void* x, const void* dy, const void* y, const void* ds,
                              const void* mul, const void* add, void* dY, void* partial,
                              void* dk, int N, int C, int H, int W, int pre, int fuse, int nslab,
                              int async_copy, void* stream) {
  if (!geo_ok(N, C, H, W) || nslab < 1) return (int)cudaErrorInvalidValue;
  const Geo g = make_dw_geo(N, C, H, W);
  if (nslab > g.ntiles) return (int)cudaErrorInvalidValue;
  if (async_copy && (W % 8 != 0 || !aligned16(x) || !aligned16(dy) ||
                     (fuse && (!aligned16(y) || !aligned16(dY)))))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int k16 = g.Cp / 16;
  const int grid = nslab * (k16 / dw_mt(k16));
  cudaError_t err;
  switch (k16) {
#define DW_CASE(K) \
    case K: err = launch_dw<K>(x, dy, y, ds, mul, add, dY, partial, g, pre, fuse, async_copy, grid, s); break;
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
