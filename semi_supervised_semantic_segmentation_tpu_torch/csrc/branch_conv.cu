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
// operands from shared memory with ldmatrix; D96 below: wgmma on shared-
// memory descriptors).  A block stages the halo'd,
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
//   D96 (conv_d96_kernel, D at Cp = 96 with W % 8 == 0 and 16-byte aligned
//      activations, every mode; the wrapper picks it, or D48 below, and
//      conv_fwd_kernel serves every other shape): the GEMM turned round for
//      Hopper's warpgroup MMA.  M = 64 output pixels of one row, N = the 96
//      C_out, K = 9 taps x 96 ci, tap-major and ci ascending as in
//      conv_fwd_kernel (y and post's dx come out bit-equal to it).  One
//      persistent CTA of three warpgroups per SM walks tiles of 4 output
//      rows x 64 pixels x 96 C_out.  wgmma.mma_async m64n96k16 (bf16 -> f32)
//      reads both operands from shared memory by descriptor, K-major without
//      swizzle.  A, the transformed x: [ci/8][halo row][halo column][8 ci],
//      16 bytes a pixel, so 8 pixels of a row are one core matrix and tap
//      (kh, kw) is a start offset of (kh * row + kw) x 16 bytes -- no
//      im2col, no shifted copy (ops/branch_conv.py operand_plan computes
//      the offsets and hands them to the kernel).  B: a tap's slab of the
//      weights, packed once per call by pack_wg_kernel<96> as [ci/8][C_out][8
//      ci].  Roles: warp 0 streams the nine 18,432-byte slabs of every tile
//      through a 3-stage ring (cp.async.bulk; ~85 MB of L2 reads a
//      [8,96,128,128] call); warps 1-3 transform x from a raw stage that one
//      TMA box a tile fills ({72, 6, 96}: rows oy0-1 .. oy0+4, columns ox0
//      .. ox0+71, zero outside the tensor; the left halo column by plain
//      loads) into the operand with byte permutes, pre's packed bf16
//      arithmetic and masks by position (halo, columns >= W, channels >= C
//      are 0, never relu(add)); consumer warpgroups 1 and 2 multiply two
//      output rows each (two m64n96 accumulators, 96 f32 a thread; 108
//      wgmma a tile) and write them out: the rounded y (post: dt) into
//      per-warp staging by stmatrix.trans, 16-byte chunks out, post's chain
//      per element on x's chunk, the statistics in a fixed order (a lane's
//      chunks, lane pairs, the 8 consumer warps, the CTAs in the reduce
//      kernel: no atomics, two launches give the same bits).  setmaxnreg
//      moves registers from the producer warpgroup (96) to the consumers
//      (200).  Barriers (mbarrier; every wait traps after ~10 s, so a fault
//      of the protocol fails the launch): rawfull (the producers' thread 0
//      with the box's bytes), xfull (the 96 transforming threads), xempty
//      (one thread per consumer warpgroup after its products), wfull[3]
//      (warp 0's lane 0 with the slab's bytes), wempty[3] (one thread per
//      consumer warpgroup after the wgmma that read the slab completed); a
//      named barrier of the transforming threads before the next box
//      overwrites the raw stage.  Shared bytes: raw 82,944 + operand 77,184
//      (halo rows 67 pixels apart: the 8 lanes of a store phase fall on 8
//      banks) + weight ring 55,296 + staging 12,288 + (mul, add) 1,536 +
//      barriers and stamps 168 + alignment 128 = 229,544.  Bound per
//      [8,96,128,128] call: 21.7 GFLOP (~22 us at 989 TFLOP/s) against ~51
//      MB of x and y (~15 us): operations.  Tried on the card and dropped:
//      x by 16-byte global loads straight into two operand buffers (the
//      loads an SM keeps in flight could not keep pace: consumers waited
//      for x ~39 % of the tile loop, whether one or two octs were in
//      flight); L2 prefetches of the next tiles' x by bulk copies (they
//      queued ahead of the weight slabs); a fourth transforming warp (warp
//      0 between its slabs) and two octs in flight in the transform (no
//      faster); post's x preloaded for a whole tile (the registers
//      spilled).  What holds it above its bound: one operand buffer, so
//      the next tile's transform follows the products and overlaps only
//      the epilogue (consumers wait for x ~22 % of the loop); the epilogue
//      itself (~19 %, post ~46 %) with the tensor cores idle; slab waits
//      (~7 %: a 3-stage ring leads by about one tap).
//   D48 (conv_d48_kernel, D at Cp = 48 under D96's conditions, every
//      mode): D96's design taken down to 48 channels, where every buffer
//      halves and the two levers D96 could not afford fit.  The same tile
//      (4 output rows x 64 pixels, here x 48 C_out), operand layout and
//      plan, transform (wgd_oct, wgd_singles), k order (tap-major, ci
//      ascending, one f32 sum per k16 step: y, the dx conv and post's dx
//      bit-equal to conv_fwd_kernel) and epilogue (wgd_epilogue, wgd_partial)
//      as D96, through wgmma.mma_async m64n48k16 (108 a tile).  x is double-
//      buffered: two raw TMA stages ({72, 6, 48} boxes) and two operand
//      buffers, so tile i + 1's box lands and its transform runs while the
//      consumers multiply tile i.  All nine weight slabs stay resident
//      ([9][6][48][8], packed once per call by pack_wg_kernel<48>, one bulk
//      copy per CTA on an mbarrier): no weight ring and no weight producer.
//      Roles: warp 0 the halo's single columns (the left one by plain loads,
//      as a box cannot start at ox0 - 1) and, on its lane 0, the boxes and
//      the weights' copy; warps 1-3 the octs (three warp-items each); two
//      consumer warpgroups on every tile, two output rows each (48 f32
//      accumulators a thread), setmaxnreg 96 / 200 as D96.  Shared bytes:
//      2 x 41,472 (raw) + 2 x 38,592 (operand, halo rows 67 pixels apart) +
//      41,472 (weights) + 12,288 (staging) + 768 ((mul, add)) + 160
//      (barriers, stamps) + 128 (alignment) = 214,944.  Bound per
//      [8,48,256,256] call: ~100.7 MB of x and y (30.1 us at 3.35 TB/s;
//      post 151 MB, 45.1 us) against 21.7 GFLOP (22.0 us): bytes.  Tried on
//      the card and dropped, each slower in every mode in the same call:
//      each consumer warpgroup issuing tile i + 1's products into a second
//      accumulator set before tile i's epilogue (the wgmma issue stalls for
//      about as long as the products run, so nothing ran under them), and
//      ping-pong (the two consumer warpgroups on alternate tiles, four rows
//      each, taking turns at the tensor cores by named barriers: the
//      four-row epilogue took three times the two-row one beside the
//      other's products).
//      What holds it above its bound: shared memory.  A tile moves ~550 KB
//      through it (the products' operands 378 KB: 108 x (2 KB of x + 1.5 KB
//      of weights), the transform 80, the boxes 41, the staging 49), ~4.3k
//      cycles at 128 bytes a cycle against the ~6.8k a tile takes; the
//      products run at that rate (~44 % of the consumers' tile loop), and
//      the epilogue (~32 %; post's, with its x loads and chain, ~60 %)
//      follows them with the tensor cores idle.
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
//   E96 (conv_dw96_kernel, E at Cp = 96 with W % 8 == 0 and x, dy, y, dY
//      16-byte aligned; the wrapper picks it, conv_dw_kernel serves every
//      other shape): a slab is one cluster of 3 CTAs on 3 SMs, each owning 32
//      of dk's rows and all 864 columns, walking the slab's tiles in the same
//      order.  x arrives by TMA from a 4-D tensor map [N,C,H,W]: each CTA
//      loads its third of the channels (a 48 x 6 x 32 box, columns ox0-8 ..
//      ox0+39: a box's first column must sit on 16 bytes, so the halo costs
//      the ring's 1.5 x in columns) multicast to all three, so L2 serves each
//      x tile once per cluster, not once per CTA (~57 MB a [8,96,128,128]
//      call against ~170); dy comes as one 32 x 4 x 32 box per CTA for its
//      own rows.  The x boxes land in dw_issue's raw layout; the hardware's
//      zero fill outside the image is not relu(add), so the transform's
//      position masks stay.  A ring of NS96 stages on mbarriers: a stage's
//      "full" barrier expects the 55,296 multicast bytes and the CTA's 8,192
//      dy bytes; its "empty" barrier counts one arrival from each CTA of the
//      cluster, so a CTA multicasts into a stage only after all three have
//      released it.  Lane 0 of warp 7, whose share of the products is the
//      smallest, issues the loads a tile ahead (with a ninth, producer warp
//      ptxas allots fewer registers than the product loop needs and spills;
//      warp 0 issuing delayed every block barrier).  The 8 warps load y
//      (fuse) into registers ahead of the stage, transform x (dw96_transform:
//      8 loads of 8 bytes for 4 pixels of 8 channels, against dw_transform's
//      32 loads of 2 bytes, two such quads in flight a thread, transposed by
//      byte permutes) and compose dY (into a skewed operand tile, so ldmatrix
//      stays conflict-free) into one of two operand buffers, meet at one
//      block barrier per tile, release the stage and run E's product loop
//      (dw96_products: the next k-step's fragments loaded during this one's
//      MMAs); the next tile's staging needs no barrier behind those products.
//      The partial goes out through shared memory in 16-byte row chunks.
//      Tried on the card and dropped, each no faster as a whole: staging tile
//      i+1 between the k-steps of tile i's products (they overlapped, but at
//      255 registers the products slowed); two warp groups taking the phases
//      in opposite orders (the products sped up, the staging slowed); and the
//      products as wgmma m64n32k16 on the transposed GEMM (A, x, from
//      registers by ldmatrix; B, dY, by descriptor from core matrices: the
//      products sped up, the staging and the barrier slowed).  Shared bytes:
//      2 stages x 63,488 (raw x 55,296, dy 8,192) + 2 x 42,432 (x operand) +
//      2 x 8,704 (dY operand) + 640 (ds, pre) + 120 (barriers, phase clocks)
//      + 128 (alignment) = 230,136: y in the ring, or 40-column boxes, would
//      not fit beside the two operand buffers.  Bound per [8,96,128,128]
//      call: ~101 MB (x, dy, y read, dY written; ~30 us) against 21.7 GFLOP
//      (~22 us): bytes.
//   E48 (conv_dw48_kernel, E at Cp = 48 under E96's conditions, every mode;
//      the wrapper picks it, conv_dw_kernel serves every other shape): E on
//      D48's tiles (4 output rows x 64 pixels) and x operand, the products on
//      wgmma.  M = 64 C_out (rows 48-63 zero, dropped), N = a tap's 48 ci, K
//      = the tile's 256 pixels: per k16 step one dY fragment in registers
//      (A: ldmatrix.x4 through the 128-byte swizzle, conflict-free; warp 3
//      of a warpgroup holds the zero rows) serves all the warpgroup's taps,
//      and each tap's B is D48's x operand read MN-major (8 ci a 16-byte
//      pixel vector, channel groups a plane apart, 8-pixel groups 128 bytes
//      apart) at the tap's start offset: no im2col.  wgmma.mma_async
//      m64n48k16, 144 a tile; consumer warpgroup 0 takes taps 0-4 (120 f32
//      accumulators a thread), 1 taps 5-8, summed over all the CTA's tiles.
//      One persistent CTA of 384 threads per SM.  Loads, all by TMA on
//      mbarriers, issued by the producers' thread 0 after its share of the
//      transform (an issue can hold its thread): x by D48's box {72, 6, 48}
//      and the left halo column by a side box {8, 6, 48} at ox0 - 8 (one
//      raw stage); dy and y each by one box {64, 48, 4} of a map whose dims
//      are ordered (W, C, H, N), so a tile's four rows land as [row][C_out]
//      [64 px] in the 128-byte swizzle (two dy stages, one y stage).  Roles:
//      the producer warpgroup transforms x into one of two operand buffers
//      (D48's wgd_oct and wgd_singles) under the products of the tile
//      before; the consumer warpgroups compose dY in place in the dy stage
//      (fold2's roundings, positions past C and W 0), meet at a named
//      barrier, write the stage out as dY by one TMA store (clipped at the
//      tensor's edges) and multiply; setmaxnreg 96 / 200.  The CTA's
//      [48][432] partial goes to reduce_dk_kernel (fixed order, no
//      atomics).  Shared bytes: 2 x 24,576 (dy) + 24,576 (y) + 41,472 (x
//      box) + 4,608 (side box) + 2 x 38,592 (operand) + 888 (ds, pre,
//      barriers, stamps) + 1,024 (alignment) = 198,792.  Bound per
//      [8,48,256,256] call: ~201 MB (x, dy, y read, dY written; ~60 us)
//      against ~29 GFLOP of tensor work with the padding (~29 us): bytes.
//      Tried on the card and dropped: the halo columns by plain 2-byte loads
//      (their issue stalled the warp for ~40 % of a tile), L2 prefetches of
//      later tiles' boxes and TMA issues from the consumers (both held
//      their threads), 64-column x boxes in two stages (no room beside the
//      side box), a second y stage and an uneven share of the compose (both
//      slower), dY by 16-byte stores from the compose (slower than the TMA
//      store), A by descriptor (level in time; 504 KB of shared reads a
//      tile against ~264 KB).  What holds it above its bound: the loads'
//      latency with one raw x stage and the compose in series with the
//      products; a tile takes ~9.3k cycles against ~7k at the bound.
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
// 1.5 x the columns of x for the halo, x once per row block where no
// cluster shares it) and the block's phases (copy wait, transform,
// compose, products) following one another between barriers; products
// stay mma.sync, not wgmma (E96: 32 dk rows per CTA against wgmma's 64,
// and a tap is a 1-pixel shift along K, which its core-matrix layout does
// not take).  What still holds E96 above its bound: every CTA of a
// cluster stages the whole x tile (the transform is done 3 times, once
// per 32 rows of dk), and each CTA's staging and products follow one
// another (about 2 : 3 of its tile loop); 39 clusters of 3 fit on the
// card's GPCs, so 15 SMs stay idle.

#include <cuda.h>  // CUtensorMap and its enums only: the encode call is looked up at run time
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
// Barriers and bulk copies (E96, D96, D48)
// ---------------------------------------------------------------------------

#define CP96 96
#define CPS96 (CP96 + 8)                 // E96's operand row stride (elements)
#define CP48 48

// A barrier that counts arrivals per phase (default: one, the issuing
// thread's, with a copy's byte count; the copy completes the bytes).
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// bytes of global memory -> shared memory as one bulk copy by the calling
// thread, completing on bar (16-byte aligned, a multiple of 16 bytes).
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// ---------------------------------------------------------------------------
// E96: kernel E at Cp = 96, a cluster of 3 CTAs per slab, x by TMA multicast
// ---------------------------------------------------------------------------
//
// Replaces, at channels that pad to 96 (HRNet-W48's branch 1), the TPU
// kernel E replaces: pallas_conv.py:536 _conv3x3_dw_impl (-> _dw_kernel_dyroll).
// The design and its shared-memory budget are in the note at the top (E96).

#define NS96 2                             // ring stages
#define CL96 3                             // CTAs per cluster (slab)
#define XBOX96 (32 * (ETH + 2) * XRW)      // one CTA's x box [32 ch][6][48] (elements)
#define XST96 (CL96 * XBOX96)              // a stage's raw x, all 96 channels
#define DYBOX96 (32 * EPIX)                // a CTA's dy box [32 rows][4][32]
#define STG96 (XST96 + DYBOX96)            // one ring stage (elements)
#define OPX96 ((ETH + 2) * HW2 * CPS96)    // one transformed x operand tile
#define OPD96 (32 * DST)                   // one dY operand tile
#define NCY96 11                           // phase sums and stamps per CTA
#define PST96 (9 * CP96 + 8)               // the partial's staging row (floats; skewed)
#define DW96_SMEM                                                                   \
  (128 + (NS96 * STG96 + 2 * OPX96 + 2 * OPD96) * 2 + 2 * 32 * 4 + 2 * CP96 * 2 + \
   2 * NS96 * 8 + NCY96 * 8)
#define TMAP_ERR 10000  // + the CUresult of a tensor-map encode that failed

__device__ __forceinline__ long long globaltimer_ns() {
  long long v;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(v));
  return v;
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster (release / acquire).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\nbarrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// One arrival on the barrier at bar's offset in CTA cta of the cluster,
// releasing this thread's (and, after a block barrier, its CTA's) reads.
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [ra];\n}\n"
      :: "r"(smem_addr(bar)), "r"(cta) : "memory");
}

// E96's waits for a barrier phase of this parity (cluster: with
// cluster-scope acquire, for arrivals from other CTAs).  A wait that has
// not ended after WAIT_LIMIT cycles (~10 s) traps, so a fault in the ring's
// protocol ends the launch with an error instead of hanging the card.
#define WAIT_LIMIT 20000000000LL
template <bool CLUSTER>
__device__ __forceinline__ void mbar_wait_bounded(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    if constexpr (CLUSTER)
      asm volatile("{\n.reg .pred P1;\n"
                   "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%1], %2;\n"
                   "selp.b32 %0, 1, 0, P1;\n}\n"
                   : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    else
      asm volatile("{\n.reg .pred P1;\n"
                   "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
                   "selp.b32 %0, 1, 0, P1;\n}\n"
                   : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > WAIT_LIMIT) __trap();
  }
}

// A box of a 4-D tensor map at coordinates (c0 innermost) -> this CTA's
// shared memory, completing on bar.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// The same box multicast: it lands at dst's offset in every CTA of mask,
// completing on the barrier at bar's offset in each.
__device__ __forceinline__ void tma_load_4d_mc(void* dst, const CUtensorMap* map, uint64_t* bar,
                                               int c0, int c1, int c2, int c3, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5, %6, %7}], [%2], %3;\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)),
         "h"(mask), "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// Per-lane ldmatrix B offsets (bytes, from the operand tile's start), fixed
// for a kernel: the warp's n8 tiles q = warp*NW + j in pairs, one
// ldmatrix.x4.trans per pair (lanes 0-15 address tile j, lanes 16-31 tile
// j+1): pixel row b_k of tap (kh, kw), channels ci0..ci0+7.  Tiles past
// the last (q >= N8) load tile N8-1 and are not multiplied.
template <int K16, int NW = dw_nw(K16)>
__device__ __forceinline__ void dw_b_offsets(uint32_t (&b_off)[(NW + 1) / 2], int warp,
                                             int lane) {
  constexpr int CP = 16 * K16, CPS = CP + 8, N8 = 9 * CP / 8, CP8 = CP / 8;
  const int b_k = (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int pp = 0; pp < (NW + 1) / 2; ++pp) {
    const int q = min(warp * NW + 2 * pp + (lane >> 4), N8 - 1);
    const int tap = q / CP8, ci0 = (q - tap * CP8) * 8;
    const int kh = tap / 3, kw = tap - kh * 3;
    b_off[pp] = ((kh * HW2 + b_k + kw) * CPS + ci0) * 2;
  }
}

// E96's products of one tile: dw_products' sums in its order (the same
// bits), with the fragments of k-step q+1 loaded while k-step q's MMAs run
// (two register sets), so ldmatrix's latency is not paid once per k-step.
template <int K16, int MT = dw_mt(K16), int NW = dw_nw(K16)>
__device__ __forceinline__ void dw96_products(float (&acc)[MT][NW][4], uint32_t a_base,
                                              uint32_t b_base,
                                              const uint32_t (&b_off)[(NW + 1) / 2], int nj) {
  constexpr int CPS = 16 * K16 + 8, NP = (NW + 1) / 2, KS = EPIX / 16;
  uint32_t af[2][MT][4], bfr[2][2 * NP][2];
  auto load = [&](int q, uint32_t (&a)[MT][4], uint32_t (&bb)[2 * NP][2]) {
    const int kc = q * 16, r = kc / TW, c0 = kc - r * TW;
    const uint32_t b_step = b_base + (r * HW2 + c0) * CPS * 2;
#pragma unroll
    for (int m = 0; m < MT; ++m) ldsm_x4(a[m], a_base + (m * 16 * DST + kc) * 2);
#pragma unroll
    for (int pp = 0; pp < NP; ++pp) {
      if (2 * pp + 1 < NW) {
        uint32_t b4[4];
        ldsm_x4_trans(b4, b_off[pp] + b_step);
        bb[2 * pp][0] = b4[0]; bb[2 * pp][1] = b4[1];
        bb[2 * pp + 1][0] = b4[2]; bb[2 * pp + 1][1] = b4[3];
      } else {
        ldsm_x2_trans(bb[2 * pp], b_off[pp] + b_step);
      }
    }
  };
  load(0, af[0], bfr[0]);
#pragma unroll
  for (int q = 0; q < KS; ++q) {
    if (q + 1 < KS) load(q + 1, af[(q + 1) & 1], bfr[(q + 1) & 1]);
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      if (j < nj) {
#pragma unroll
        for (int m = 0; m < MT; ++m) mma_bf16(acc[m][j], af[q & 1][m], bfr[q & 1][j]);
      }
    }
  }
}

// E96's transform: dw_transform's function (the staged raw x -> the
// operand tile, positions masked, pre's packed bf16 arithmetic, the same
// bits) with 8-byte loads.  A quad is 4 pixels (c = 4k+1 .. 4k+4: raw
// columns 4k+8 .. 4k+11, 8-byte aligned) of 8 channels: 8 loads transposed
// in registers by byte permutes into 4 pixel vectors; a thread takes two
// quads at a time, their 16 loads in flight together.  The tile's first
// and last columns (c = 0, 33) are single pixels.  A warp's quads are
// consecutive in a (channel group, row), so its loads are contiguous.
#define XQUADS96 ((CP96 / 8) * (ETH + 2) * ((HW2 - 2) / 4))  // 576 a tile
#define XSINGLES96 ((CP96 / 8) * (ETH + 2) * 2)              // 144 a tile
__device__ __forceinline__ void dw96_transform(bf16* xop, const bf16* raw, const bf16* pmb,
                                               bool pre, const Geo& g, int oy0, int ox0) {
  constexpr int XR = ETH + 2, QPR = (HW2 - 2) / 4;
  static_assert((HW2 - 2) % 4 == 0, "E96's transform: quads of pixels");
  const uint16_t* rw = reinterpret_cast<const uint16_t*>(raw);
  // pre, then the masks (the zero-filled raw would give relu(add)); one
  // pixel vector of channels grp*8 .. grp*8+7 to pixel (r, c)
  // a group's pre (bf16 mul, add) and channel masks (channels >= C are 0)
  struct Group {
    uint4 m4, a4;
    uint32_t keep[4];
  };
  auto group = [&](Group& gr, int grp) {
    gr.m4 = make_uint4(0, 0, 0, 0);
    gr.a4 = gr.m4;
    if (pre) {
      gr.m4 = *reinterpret_cast<const uint4*>(&pmb[grp * 8]);
      gr.a4 = *reinterpret_cast<const uint4*>(&pmb[CP96 + grp * 8]);
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int ci = grp * 8 + 2 * jj;
      gr.keep[jj] = (ci < g.C ? 0xffffu : 0u) | (ci + 1 < g.C ? 0xffff0000u : 0u);
    }
  };
  auto finish = [&](uint32_t (&w)[4], const Group& gr, int grp, int r, int c) {
    const int iy = oy0 - 1 + r, ix = ox0 - 1 + c;
    const uint32_t in = iy >= 0 && iy < g.H && ix >= 0 && ix < g.W ? 0xffffffffu : 0u;
    if (pre) {
      w[0] = pre2(w[0], gr.m4.x, gr.a4.x);
      w[1] = pre2(w[1], gr.m4.y, gr.a4.y);
      w[2] = pre2(w[2], gr.m4.z, gr.a4.z);
      w[3] = pre2(w[3], gr.m4.w, gr.a4.w);
    }
    *reinterpret_cast<uint4*>(&xop[(r * HW2 + c) * CPS96 + grp * 8]) =
        make_uint4(w[0] & gr.keep[0] & in, w[1] & gr.keep[1] & in, w[2] & gr.keep[2] & in,
                   w[3] & gr.keep[3] & in);
  };
  for (int e0 = threadIdx.x; e0 < XQUADS96; e0 += 2 * NT) {
    uint2 v[2][8];
    int grp[2], r[2], c[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = min(e0 + u * NT, XQUADS96 - 1);  // a thread past the end reloads the last
      grp[u] = e / (XR * QPR);
      const int rem = e - grp[u] * (XR * QPR);
      r[u] = rem / QPR;
      c[u] = 4 * (rem - r[u] * QPR) + 1;
      const uint16_t* src = rw + (grp[u] * 8 * XR + r[u]) * XRW + 7 + c[u];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[u][j] = *reinterpret_cast<const uint2*>(src + j * XR * XRW);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (e0 + u * NT >= XQUADS96) break;
      Group gr;
      group(gr, grp[u]);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const uint32_t sel = (m & 1) ? 0x7632u : 0x5410u;  // high or low halves
        uint32_t w[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          w[jj] = __byte_perm(m < 2 ? v[u][2 * jj].x : v[u][2 * jj].y,
                              m < 2 ? v[u][2 * jj + 1].x : v[u][2 * jj + 1].y, sel);
        finish(w, gr, grp[u], r[u], c[u] + m);
      }
    }
  }
  for (int e = threadIdx.x; e < XSINGLES96; e += NT) {
    const int grp = e / (XR * 2), rem = e - grp * (XR * 2), r = rem >> 1;
    const int c = (rem & 1) ? HW2 - 1 : 0;
    const uint16_t* src = rw + (grp * 8 * XR + r) * XRW + 7 + c;
    uint32_t w[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      w[jj] = (uint32_t)src[2 * jj * XR * XRW] | ((uint32_t)src[(2 * jj + 1) * XR * XRW] << 16);
    Group gr;
    group(gr, grp);
    finish(w, gr, grp, r, c);
  }
}

// E96's y for a tile's dY (fuse): thread tid's 16-byte chunks tid, tid +
// NTH, ... of the CTA's 32 rows x 128 pixels (0 outside the image and past
// C), loaded before the tile's stage is waited for, so their latency
// hides behind that wait and the transform.
#define DCH96 (32 * EPIX / 8)  // 16-byte chunks of a tile's dY rows
template <int NTH>
__device__ __forceinline__ void dw96_load_y(uint4 (&yv)[DCH96 / NTH], const bf16* __restrict__ y,
                                            const Geo& g, int co_base, int n, int oy0, int ox0,
                                            int tid) {
#pragma unroll
  for (int u = 0; u < DCH96 / NTH; ++u) {
    const int e = tid + u * NTH, co = e / (EPIX / 8), k = e - co * (EPIX / 8);
    const int r = k / (TW / 8), c = (k - r * (TW / 8)) * 8;
    const int cog = co_base + co, ox = ox0 + c;
    yv[u] = make_uint4(0, 0, 0, 0);
    if (cog < g.C && ox < g.W)
      yv[u] = *reinterpret_cast<const uint4*>(
          &y[(((size_t)n * g.C + cog) * g.H + oy0 + r) * g.W + ox]);
  }
}

// E96's dY operand of a tile: the dense dy box [32 rows][EPIX] -> the
// skewed operand dop [32 rows][DST] (so ldmatrix stays conflict-free),
// with fuse the stats cotangent folded in from yv and dY written out with
// 16-byte stores; positions as dw_compose (rows >= C and pixels at ox >= W
// are 0 in the operand and not written out).  Thread tid takes the
// chunks of dw96_load_y.
template <int NTH>
__device__ __forceinline__ void dw96_compose(bf16* dop, const bf16* dys,
                                             const uint4 (&yv)[DCH96 / NTH], const float* dss,
                                             bf16* __restrict__ dY, const Geo& g, int fuse,
                                             int co_base, int n, int oy0, int ox0, int tid) {
#pragma unroll
  for (int u = 0; u < DCH96 / NTH; ++u) {
    const int e = tid + u * NTH, co = e / (EPIX / 8), k = e - co * (EPIX / 8);
    const int r = k / (TW / 8), c = (k - r * (TW / 8)) * 8;
    const int cog = co_base + co, ox = ox0 + c;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (cog < g.C && ox < g.W) {
      v = *reinterpret_cast<const uint4*>(&dys[co * EPIX + r * TW + c]);
      if (fuse) {
        const float s0 = dss[co], s1 = dss[32 + co];
        v = make_uint4(fold2(v.x, yv[u].x, s0, s1), fold2(v.y, yv[u].y, s0, s1),
                       fold2(v.z, yv[u].z, s0, s1), fold2(v.w, yv[u].w, s0, s1));
        *reinterpret_cast<uint4*>(&dY[(((size_t)n * g.C + cog) * g.H + oy0 + r) * g.W + ox]) = v;
      }
    }
    *reinterpret_cast<uint4*>(&dop[co * DST + r * TW + c]) = v;
  }
}

// blockIdx.x = 3 * slab + rank; the 3 CTAs of a cluster walk the tiles slab,
// slab + nslab, ...  Tile i sits in stage i % 2 and is staged into operand
// buffer i % 2.  The producer thread (lane 0 of warp 7) waits at the top of
// tile i until all three CTAs have released stage (i + 1) % 2 (tile i-1)
// and issues tile i + 1 into it, so those loads have tile i's staging and
// products to land.  tmx: x [N,C,H,W] bf16, box {48, 6, 32, 1} (a box's
// first column must sit on 16 bytes: ox0 - 8); tmdy: dy, box {32, 4, 32,
// 1}; y (fuse) is read by the threads.  cycles (or null): [gridDim.x]
// [NCY96] clock64 sums: thread 0 waiting for a stage, staging, the block
// barrier, products, the whole tile loop; the producer waiting for a
// release and issuing; on the global timer (ns): the CTA's start, the tile
// loop's start and end, the partials stored, the CTA's end.
__global__ void __launch_bounds__(NT, 1)
conv_dw96_kernel(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmdy,
                 const bf16* __restrict__ y, const float* __restrict__ ds,
                 const float* __restrict__ mul, const float* __restrict__ add,
                 bf16* __restrict__ dY, float* __restrict__ partial,
                 long long* __restrict__ cycles, Geo g, int pre, int fuse) {
  constexpr int K16 = CP96 / 16, MT = dw_mt(K16), NW = dw_nw(K16), ROWS = 16 * MT;
  constexpr int N8 = 9 * CP96 / 8, NP = (NW + 1) / 2;
  static_assert(CL96 * ROWS == CP96 && dw_nw(K16) * 8 >= N8, "E96's plan");
  static_assert(DW96_SMEM <= SMEM_MAX, "E96's shared memory");
  static_assert(32 * PST96 * 4 <= NS96 * STG96 * 2, "E96's partial fits in the ring");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // TMA boxes land at 128-byte aligned offsets, the same in every CTA
  unsigned char* base = smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127);
  bf16* ring = reinterpret_cast<bf16*>(base);                      // [NS96][STG96]
  bf16* xop = ring + NS96 * STG96;                                  // [2][OPX96]
  bf16* dop = xop + 2 * OPX96;                                      // [2][OPD96]
  float* dss = reinterpret_cast<float*>(dop + 2 * OPD96);           // [2][ROWS]
  bf16* pmb = reinterpret_cast<bf16*>(dss + 2 * ROWS);              // [2][Cp]
  uint64_t* full = reinterpret_cast<uint64_t*>(pmb + 2 * CP96);     // [NS96]
  uint64_t* empty = full + NS96;                                    // [NS96]
  long long* cyc = reinterpret_cast<long long*>(empty + NS96);      // [NCY96]
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const long long t_start = globaltimer_ns();
  const uint32_t rank = cluster_rank();
  const int slab = blockIdx.x / CL96, nslab = gridDim.x / CL96;
  const int co_base = rank * ROWS, C = g.C;
  // thread 0's phase sums go straight to shared memory: no registers held
  // across the loop
  const bool stamp = cycles != nullptr, st0 = stamp && t == 0;
  for (int e = t; e < 2 * ROWS; e += NT) {
    const int which = e / ROWS, co = co_base + e - which * ROWS;
    dss[e] = (fuse && co < C) ? ds[which * C + co] : 0.f;
  }
  for (int e = t; e < 2 * CP96; e += NT) {
    const int which = e / CP96, ci = e - which * CP96;
    pmb[e] = __float2bfloat16((pre && ci < C) ? (which ? add : mul)[ci] : 0.f);
  }
  if (t < NCY96) cyc[t] = 0;
  if (t == 0) {
    for (int k = 0; k < NS96; ++k) {
      mbar_init(&full[k]);              // the producer's arrival (+ the stage's bytes)
      mbar_init(&empty[k], CL96);       // one release from each CTA of the cluster
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_sync();  // every CTA's barriers are initialised before a copy reaches them

  const int ntl = (g.ntiles - slab + nslab - 1) / nslab;  // this slab's tiles
  // The producer, lane 0 of the last warp (its share of the products is
  // the smallest: 10 of the 108 n8 tiles, against 14): tile j into stage
  // j % NS96 -- this CTA's third of x to all three CTAs, its dy to itself
  // alone.  A TMA issue can hold its thread for a while; warp 0 issuing
  // made every block barrier wait for it.
  const int prod = NT - 32;
  auto issue = [&](int j) {
    int n, oy0, ox0;
    dw_tile_coords(g, slab + j * nslab, n, oy0, ox0);
    bf16* st = ring + (j % NS96) * STG96;
    uint64_t* bar = &full[j % NS96];
    mbar_arrive_expect_tx(bar, STG96 * 2);
    tma_load_4d_mc(st + rank * XBOX96, &tmx, bar, ox0 - 8, oy0 - 1, co_base, n,
                   (uint16_t)((1u << CL96) - 1));
    tma_load_4d(st + XST96, &tmdy, bar, ox0, oy0, co_base, n);
  };
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const uint32_t a_off = (a_row * DST + a_col) * 2;
  const int nj = N8 - warp * NW;
  uint32_t b_off[NP];
  dw_b_offsets<K16>(b_off, warp, lane);
  float acc[MT][NW][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NW; ++j) acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;
  if (st0) {
    cyc[4] = -clock64();
    cyc[7] = globaltimer_ns();
  }
  if (t == prod && ntl > 0) issue(0);
  for (int i = 0; i < ntl; ++i) {
    const int j = i + 1;
    if (t == prod && j < ntl) {
      const long long c0 = stamp ? clock64() : 0;
      if (j >= NS96)  // stage j % 2's previous tile released by all three CTAs
        mbar_wait_bounded<true>(&empty[j % NS96], (j / NS96 - 1) & 1);
      issue(j);
      if (stamp) cyc[5] += clock64() - c0;
    }
    const int s = i % NS96, b = i & 1;
    int n, oy0, ox0;
    dw_tile_coords(g, slab + i * nslab, n, oy0, ox0);
    const bf16* st = ring + s * STG96;
    uint4 yv[DCH96 / NT];
    if (fuse) dw96_load_y<NT>(yv, y, g, co_base, n, oy0, ox0, t);
    long long c0 = st0 ? clock64() : 0;
    mbar_wait_bounded<false>(&full[s], (i / NS96) & 1);  // tile i's boxes have landed
    long long c1 = st0 ? clock64() : 0;
    if (st0) cyc[0] += c1 - c0;
    dw96_transform(xop + b * OPX96, st, pmb, pre != 0, g, oy0, ox0);
    dw96_compose<NT>(dop + b * OPD96, st + XST96, yv, dss, dY, g, fuse, co_base, n, oy0, ox0, t);
    c0 = st0 ? clock64() : 0;
    if (st0) cyc[1] += c0 - c1;
    // operand buffer b is ready, stage s read by every thread, and every
    // thread is past tile i-1's products (buffer b ^ 1 is free next)
    __syncthreads();
    c1 = st0 ? clock64() : 0;
    if (st0) cyc[2] += c1 - c0;
    if (t == prod)
      for (int r = 0; r < CL96; ++r) mbar_arrive_cluster(&empty[s], r);
    dw96_products<K16>(acc, smem_addr(dop + b * OPD96) + a_off, smem_addr(xop + b * OPX96), b_off,
                       nj);
    if (st0) cyc[3] += clock64() - c1;
  }
  if (st0) {
    cyc[4] += clock64();
    cyc[8] = globaltimer_ns();
  }
  // the partial, through shared memory (the ring and the operand tiles are
  // free once every warp is past its last products) and out in 16-byte
  // row chunks: partial[slab][co_base + row][tap*Cp + ci]
  __syncthreads();
  float* pst = reinterpret_cast<float*>(ring);  // [ROWS][PST96]
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    if (j >= nj) break;
    const int col = (warp * NW + j) * 8 + (lane & 3) * 2;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m * 16 + half * 8 + (lane >> 2);
        *reinterpret_cast<float2*>(&pst[row * PST96 + col]) =
            make_float2(acc[m][j][2 * half], acc[m][j][2 * half + 1]);
      }
  }
  __syncthreads();
  for (int e = t; e < ROWS * (N8 * 2); e += NT) {
    const int row = e / (N8 * 2), c4 = e - row * (N8 * 2);
    const size_t at = ((size_t)slab * CP96 + co_base + row) * (9 * CP96) + 4 * c4;
    *reinterpret_cast<float4*>(&partial[at]) =
        *reinterpret_cast<const float4*>(&pst[row * PST96 + 4 * c4]);
  }
  if (st0) cyc[9] = globaltimer_ns();
  // no CTA leaves while a peer may still multicast into its shared memory
  // or arrive on its barriers
  cluster_sync();
  if (st0) {
    cyc[6] = t_start;
    cyc[10] = globaltimer_ns();
  }
  if (cycles != nullptr && t < NCY96) cycles[(size_t)blockIdx.x * NCY96 + t] = cyc[t];
}

// ---------------------------------------------------------------------------
// D96 and D48: kernel D at Cp = 96 and 48 (every mode): wgmma, warp-
// specialised, persistent
// ---------------------------------------------------------------------------
//
// Replace, at channels that pad to 96 (HRNet-W48's branch 1) and to 48
// (branch 0), the TPU kernels D replaces: pallas_conv.py:328
// _conv3x3_nchw_impl (-> _kernel_kstack) and its post mode,
// pallas_conv.py:223 _kernel_kstack(post=True).  The two share the tile
// (4 output rows x 64 pixels x all C_out), the x operand's layout and
// addressing, its transform, the products' k order and the epilogue
// (wgd_* below, templated on the padded width CP where it enters); they
// differ in their buffers and roles.  The designs, their barriers and
// their shared-memory budgets are in the note at the top (D96, D48).

#define WGD_TR 4                           // output rows per tile (two per consumer warpgroup)
#define WGD_TC 64                          // output pixels per tile row: one wgmma's M
#define WGD_XR (WGD_TR + 2)                // halo rows of the x operand
#define WGD_XP 67                          // halo row pitch (pixels): 66 used, odd so that the
                                           // producer's stores of 8 rows spread over the banks
#define WGD_PLANE (WGD_XR * WGD_XP * 16)   // bytes of one channel group's plane (A's LBO)
#define WGD_RAWC 72                        // raw x columns: ox0 .. ox0+71 (halo columns 1 .. 72)
#define WGD_STG (48 * 16 * 2)              // a consumer warp's staging: 48 C_out x 16 pixels bf16
#define D96_NT 384                         // threads: a producer warpgroup, two consumer warpgroups
#define D96_CG (CP96 / 8)                  // channel groups: the core matrices' K chunks
#define D96_XBUF (D96_CG * WGD_PLANE)      // the x operand buffer
#define D96_RAW (CP96 * WGD_XR * WGD_RAWC * 2)  // the raw x stage: one TMA box, bytes
#define D96_WLBO (CP96 * 16)               // bytes of one channel group of a slab (B's LBO)
#define D96_SLAB (D96_CG * D96_WLBO)       // one tap's packed weights, bytes
#define D96_WST 3                          // weight ring stages
#define D96_NCY 12                         // stamps per CTA
#define D96_SMEM_BYTES                                                                 \
  (128 + D96_RAW + D96_XBUF + D96_WST * D96_SLAB + 8 * WGD_STG + 3 * CP96 * 4 + \
   2 * CP96 * 2 + 9 * 8 + D96_NCY * 8)
#define D48_NT 384                         // threads: a producer warpgroup, two consumer warpgroups
#define D48_CG (CP48 / 8)                  // channel groups
#define D48_NB 2                           // x buffers: raw stages and operand buffers
#define D48_XBUF (D48_CG * WGD_PLANE)      // one x operand buffer
#define D48_RAW (CP48 * WGD_XR * WGD_RAWC * 2)  // one raw x stage: one TMA box, bytes
#define D48_WLBO (CP48 * 16)               // bytes of one channel group of a slab (B's LBO)
#define D48_SLAB (D48_CG * D48_WLBO)       // one tap's packed weights, bytes (all 9 resident)
#define D48_NCY 13                         // stamps per CTA
#define D48_SMEM_BYTES                                                                     \
  (128 + D48_NB * (D48_RAW + D48_XBUF) + 9 * D48_SLAB + 8 * WGD_STG + 3 * CP48 * 4 +  \
   2 * CP48 * 2 + (3 * D48_NB + 1) * 8 + D48_NCY * 8)

// The x operand's addressing, from the host (ops/branch_conv.py,
// operand_plan): bytes between channel-group planes (A's leading byte
// offset), between halo rows, and from a tile row's first halo pixel to the
// first pixel tap (kh, kw) reads.  The same at both widths: a plane holds
// one channel group.
struct WgdOps {
  int plane, row, tap[9];
};

static Geo make_wgd_geo(int N, int C, int H, int W) {
  Geo g = make_geo(N, C, H, W);
  g.ntx = (W + WGD_TC - 1) / WGD_TC;
  g.nty = H / WGD_TR;
  g.ntiles = N * g.nty * g.ntx;
  return g;
}

__device__ __forceinline__ void wgd_tile(const Geo& g, int tile, int& n, int& oy0, int& ox0) {
  const int tx = tile % g.ntx;
  const int r = tile / g.ntx;
  oy0 = (r % g.nty) * WGD_TR;
  n = r / g.nty;
  ox0 = tx * WGD_TC;
}

// D96's and D48's packed weights (CP = 96, 48): wp[tap][ci / 8][co][ci % 8]
// = bf16(w[co][ci][tap]), with flip bf16(w[ci][co][8 - tap]); 0 for co or
// ci >= C.  A tap's slab is wgmma's B (N = C_out, K = ci) in core matrices
// of 8 C_out x 8 ci.
template <int CP>
__global__ void pack_wg_kernel(const float* __restrict__ w, bf16* __restrict__ wp, int C,
                               int flip) {
  constexpr int SLAB = CP * CP, GRP = CP * 8;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= 9 * SLAB) return;
  const int tap = e / SLAB, rem = e - tap * SLAB;
  const int grp = rem / GRP, r2 = rem - grp * GRP;
  const int co = r2 >> 3, ci = grp * 8 + (r2 & 7);
  float v = 0.f;
  if (co < C && ci < C)
    v = flip ? w[((size_t)ci * C + co) * 9 + 8 - tap] : w[((size_t)co * C + ci) * 9 + tap];
  wp[e] = __float2bfloat16(v);
}

// A wgmma descriptor of a K-major operand without swizzle at shared address
// addr: core matrices of 8 rows x 16 bytes, 8-row groups 128 bytes apart
// (the stride byte offset), the two 8-element K halves lbo bytes apart.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// The accumulators stay where the asynchronous products left them: no
// read or write of d is moved across this point.
template <int N>
__device__ __forceinline__ void wg_hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (+)= A * B, m64n96k16, bf16 in, f32 accumulators (scale_d = 0: d = A * B).
__device__ __forceinline__ void wgmma96(float (&d)[48], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, "
      "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= A * B, m64n48k16, bf16 in, f32 accumulators (scale_d = 0: d = A * B).
__device__ __forceinline__ void wgmma48(float (&d)[24], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Four 8 x 8 bf16 matrices in mma fragment layout -> shared memory
// transposed: lane 8i + b gives the address of row b of matrix i.
__device__ __forceinline__ void stsm_x4_trans(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2,
                                              uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(r0), "r"(r1), "r"(r2), "r"(r3) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_addr(bar)) : "memory");
}

// Generic-proxy accesses of shared memory ordered with the async proxy's
// (wgmma's reads, a TMA box's writes).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t u4w(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The input transform's operands and the channel masks of channel group
// grp (pmb: pre's [2][CP] bf16 mul_r, add_r).
struct WgdGroup {
  uint4 m4, a4;
  uint32_t keep[4];
};

template <int CP>
__device__ __forceinline__ void wgd_group(WgdGroup& gr, const bf16* pmb, bool pre, int C, int grp) {
  gr.m4 = make_uint4(0, 0, 0, 0);
  gr.a4 = gr.m4;
  if (pre) {
    gr.m4 = *reinterpret_cast<const uint4*>(&pmb[grp * 8]);
    gr.a4 = *reinterpret_cast<const uint4*>(&pmb[CP + grp * 8]);
  }
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const int ci = grp * 8 + 2 * jj;
    gr.keep[jj] = (ci < C ? 0xffffu : 0u) | (ci + 1 < C ? 0xffff0000u : 0u);
  }
}

// One pixel vector (8 channels, two a word) of the operand: pre's packed
// bf16 arithmetic, then the masks (the halo, columns >= W and channels >=
// C are 0 by position, never by value).
__device__ __forceinline__ void wgd_put(unsigned char* dst, uint32_t (&w)[4], const WgdGroup& gr,
                                        bool pre, uint32_t in) {
  if (pre) {
    w[0] = pre2(w[0], gr.m4.x, gr.a4.x);
    w[1] = pre2(w[1], gr.m4.y, gr.a4.y);
    w[2] = pre2(w[2], gr.m4.z, gr.a4.z);
    w[3] = pre2(w[3], gr.m4.w, gr.a4.w);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0] & gr.keep[0] & in, w[1] & gr.keep[1] & in,
                                              w[2] & gr.keep[2] & in, w[3] & gr.keep[3] & in);
}

// The producer's part of a tile, from the raw stage (raw[ci][r][q] = x[n,
// ci, oy0-1+r, ox0+q], zero outside the image and past C, as the TMA box
// lands it): an oct is 8 channels (group grp) x 8 pixels of halo row r
// ((group, row) plane idx = grp * WGD_XR + r), columns c = 8k-7 .. 8k (k =
// 1..8, raw q = 8k-8 .. 8k-1: a 16-byte chunk of each channel row), 8 loads
// of 16 bytes transposed by byte permutes into 8 pixel vectors.  The
// callers give 8 consecutive planes to the 8 lanes of a store phase, so
// they hit 8 rows (the odd pitch puts them on distinct banks) and the
// lanes of a load phase at most 2 to a bank.
template <int CP>
__device__ __forceinline__ void wgd_oct(unsigned char* xop, const unsigned char* raw,
                                        const bf16* pmb, bool pre, const Geo& g,
                                        const WgdOps& ops, int oy0, int ox0, int idx, int k) {
  const int grp = idx / WGD_XR, r = idx - grp * WGD_XR;
  const int iy = oy0 - 1 + r, ix = ox0 + 8 * k - 8;
  const uint32_t in = iy >= 0 && iy < g.H && ix < g.W ? 0xffffffffu : 0u;
  const unsigned char* src = raw + ((grp * 8 * WGD_XR + r) * WGD_RAWC + 8 * k - 8) * 2;
  uint4 v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    v[j] = *reinterpret_cast<const uint4*>(src + j * (WGD_XR * WGD_RAWC * 2));
  WgdGroup gr;
  wgd_group<CP>(gr, pmb, pre, g.C, grp);
  unsigned char* row = xop + grp * ops.plane + r * ops.row + (8 * k - 7) * 16;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    uint32_t w[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      w[jj] = __byte_perm(u4w(v[2 * jj], e >> 1), u4w(v[2 * jj + 1], e >> 1),
                          (e & 1) ? 0x7632u : 0x5410u);
    wgd_put(row + e * 16, w, gr, pre, in);
  }
}

// The halo's single columns of (group, row) idx: c = 0 (x column ox0-1,
// left of the raw box) from device memory, loaded into h before the raw
// stage is waited for; c = 65 (ox0+64) from the raw stage.
__device__ __forceinline__ void wgd_left_load(uint32_t (&h)[8], const bf16* __restrict__ x,
                                              const Geo& g, int n, int oy0, int ox0, int idx) {
  const int grp = idx / WGD_XR, r = idx - grp * WGD_XR;
  const int iy = oy0 - 1 + r, ix = ox0 - 1;
  const bool ok = idx >= 0 && iy >= 0 && iy < g.H && ix >= 0;
  const uint16_t* src = reinterpret_cast<const uint16_t*>(x) +
                        (((size_t)n * g.C + grp * 8) * g.H + iy) * g.W + ix;
  const size_t plane = (size_t)g.H * g.W;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    h[j] = (ok && grp * 8 + j < g.C) ? (uint32_t)__ldg(src + j * plane) : 0u;
}

template <int CP>
__device__ __forceinline__ void wgd_singles(unsigned char* xop, const unsigned char* raw,
                                            const uint32_t (&h)[8], const bf16* pmb, bool pre,
                                            const Geo& g, const WgdOps& ops, int oy0, int ox0,
                                            int idx) {
  const int grp = idx / WGD_XR, r = idx - grp * WGD_XR;
  const int iy = oy0 - 1 + r;
  const bool row_in = iy >= 0 && iy < g.H;
  WgdGroup gr;
  wgd_group<CP>(gr, pmb, pre, g.C, grp);
  uint32_t w[4];
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) w[jj] = h[2 * jj] | (h[2 * jj + 1] << 16);
  unsigned char* at = xop + grp * ops.plane + r * ops.row;
  wgd_put(at, w, gr, pre, row_in && ox0 >= 1 ? 0xffffffffu : 0u);
  const uint16_t* rw = reinterpret_cast<const uint16_t*>(raw) + (grp * 8 * WGD_XR + r) * WGD_RAWC +
                       WGD_TC;
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
    w[jj] = (uint32_t)rw[2 * jj * WGD_XR * WGD_RAWC] |
            ((uint32_t)rw[(2 * jj + 1) * WGD_XR * WGD_RAWC] << 16);
  wgd_put(at + (WGD_TC + 1) * 16, w, gr, pre, row_in && ox0 + WGD_TC < g.W ? 0xffffffffu : 0u);
}

// Post's x chunks of a consumer lane for the epilogue's row pass (rr, hf):
// C_out 48 hf + e / 2, pixels ox0 + 16 q + 8 (e % 2) .. + 7 of output row
// oy0 + row0 + rr, for e = lane + 32 k (zero past C and W).
__device__ __forceinline__ void wgd_load_x(uint4 (&xb)[3], const bf16* __restrict__ xpost,
                                           const Geo& g, int n, int oy0, int ox0, int row0, int q,
                                           int lane, int rr, int hf) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int e = lane + 32 * k, co = 48 * hf + (e >> 1);
    const int ox = ox0 + 16 * q + 8 * (e & 1), oy = oy0 + row0 + rr;
    xb[k] = make_uint4(0, 0, 0, 0);
    if (co < g.C && ox < g.W)
      xb[k] = *reinterpret_cast<const uint4*>(
          &xpost[(((size_t)n * g.C + co) * g.H + oy) * g.W + ox]);
  }
}

// A consumer warp's epilogue of its two output rows of a tile, rows row0
// and row0 + 1 (acc[rr]: wgmma's m64nCP accumulators, CP / 2 f32 a
// thread): each warp's 16 pixels of a row, 48 C_out at a time (CP / 48 row
// passes a row): the rounded y (post: dt) by stmatrix.trans into [48
// C_out][16 pixels] (a row's two 16-byte halves swapped on every other
// 4-row group, so the 8 rows of a matrix hit distinct banks), then 16-byte
// chunks out (W % 8 == 0: a chunk is all inside or all outside); post's
// chain per element on x's chunk (xv[p & 1]: pass p's; the caller loads
// the first pass's, and each pass the next one's).  The statistics of the
// rounded y (post:
// (dmul, dadd)) per lane in a fixed order: s1/s2[3 hf + k] for C_out 48 hf
// + lane / 2 + 16 k, pixel half lane % 2 of the warp's 16.
template <int CP>
__device__ __forceinline__ void wgd_epilogue(const float (&acc)[2][CP / 2],
                                             float (&s1)[3 * CP / 48], float (&s2)[3 * CP / 48],
                                             uint4 (&xv)[2][3], unsigned char* ws, uint32_t ws_s,
                                             const float* pm, const bf16* __restrict__ xpost,
                                             bf16* __restrict__ y, const Geo& g, int n, int oy0,
                                             int ox0, int row0, int q, int lane, int stats,
                                             int post) {
  constexpr int NH = CP / 48;
  const int C = g.C;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int oy = oy0 + row0 + rr;
#pragma unroll
    for (int hf = 0; hf < NH; ++hf) {
      const int pass = NH * rr + hf;
      if (post && pass < 2 * NH - 1)
        wgd_load_x(xv[(pass + 1) & 1], xpost, g, n, oy0, ox0, row0, q, lane, (pass + 1) / NH,
                   (pass + 1) % NH);
#pragma unroll
      for (int s4 = 0; s4 < 3; ++s4) {
        uint32_t r[4];
#pragma unroll
        for (int i4 = 0; i4 < 4; ++i4) {
          const int idx = 4 * s4 + i4, j = 6 * hf + (idx >> 1), pg = idx & 1;
          r[i4] = pack_bf16(acc[rr][4 * j + 2 * pg], acc[rr][4 * j + 2 * pg + 1]);
        }
        const int idx = 4 * s4 + (lane >> 3), col = 8 * (idx >> 1) + (lane & 7);
        stsm_x4_trans(ws_s + col * 32 + (((idx & 1) ^ ((col >> 2) & 1)) << 4), r[0], r[1],
                      r[2], r[3]);
      }
      __syncwarp();
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int e = lane + 32 * k, col = e >> 1, h = e & 1;
        const int co = 48 * hf + col, ox = ox0 + 16 * q + 8 * h;
        uint4 v = *reinterpret_cast<const uint4*>(ws + col * 32 + ((h ^ ((col >> 2) & 1)) << 4));
        if (co < C && ox < g.W) {
          const size_t at = (((size_t)n * C + co) * g.H + oy) * g.W + ox;
          uint32_t* vw = reinterpret_cast<uint32_t*>(&v);
          if (post) {
            const float mr = pm[co], ar = pm[CP + co], mw = pm[2 * CP + co];
            const uint32_t* xw = reinterpret_cast<const uint32_t*>(&xv[pass & 1][k]);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              float o[2];
#pragma unroll
              for (int e2 = 0; e2 < 2; ++e2) {
                const float dt = __uint_as_float(e2 ? vw[kk] & 0xffff0000u : vw[kk] << 16);
                const float xf = __uint_as_float(e2 ? xw[kk] & 0xffff0000u : xw[kk] << 16);
                const float t2 = bf16r(__fadd_rn(bf16r(__fmul_rn(xf, mr)), ar));
                const float dtm = t2 > 0.f ? dt : 0.f;
                o[e2] = __fmul_rn(dtm, mw);
                s1[3 * hf + k] = __fadd_rn(s1[3 * hf + k], __fmul_rn(dtm, xf));
                s2[3 * hf + k] = __fadd_rn(s2[3 * hf + k], dtm);
              }
              vw[kk] = pack_bf16(o[0], o[1]);
            }
          } else if (stats) {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const float f0 = __uint_as_float(vw[kk] << 16);
              const float f1 = __uint_as_float(vw[kk] & 0xffff0000u);
              s1[3 * hf + k] = __fadd_rn(__fadd_rn(s1[3 * hf + k], f0), f1);
              s2[3 * hf + k] = __fadd_rn(__fadd_rn(s2[3 * hf + k], __fmul_rn(f0, f0)),
                                         __fmul_rn(f1, f1));
            }
          }
          *reinterpret_cast<uint4*>(&y[at]) = v;
        }
      }
      __syncwarp();
    }
  }
}

// The CTA partial [2][C] of the consumers' statistics (thread t, 128 ..
// 383): the two pixel halves of a C_out (lanes l, l ^ 1), then the 8
// consumer warps in order, through red ([8][2][CP] f32 of shared memory no
// one else touches any more), between named barriers of the consumers.
template <int CP>
__device__ __forceinline__ void wgd_partial(const float (&s1)[3 * CP / 48],
                                            const float (&s2)[3 * CP / 48], float* red,
                                            float* __restrict__ partial, int C, int slab, int cw,
                                            int lane, int t) {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
#pragma unroll
  for (int k = 0; k < 3 * CP / 48; ++k) {
    const float a = s1[k] + __shfl_xor_sync(0xffffffffu, s1[k], 1);
    const float b2 = s2[k] + __shfl_xor_sync(0xffffffffu, s2[k], 1);
    if ((lane & 1) == 0) {
      const int co = 48 * (k / 3) + (lane >> 1) + 16 * (k % 3);
      red[(cw * 2 + 0) * CP + co] = a;
      red[(cw * 2 + 1) * CP + co] = b2;
    }
  }
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  for (int e = t - 128; e < 2 * CP; e += 256) {
    const int which = e / CP, co = e - which * CP;
    if (co >= C) continue;
    float sum = 0.f;
    for (int w8 = 0; w8 < 8; ++w8) sum += red[(w8 * 2 + which) * CP + co];
    partial[((size_t)slab * 2 + which) * C + co] = sum;
  }
}

// The CTAs walk the tiles slab, slab + nslab, ... (4 output rows x 64
// pixels x all 96 C_out).  Warp 0 streams tap slabs (step s = 9 * tile +
// tap) into the weight ring.  Warps 1-3 transform tile j's raw stage (one
// TMA box of tmx [N,C,H,W], box {72, 6, 96, 1}, issued by their thread 0)
// into the x operand once the consumers have released tile j - 1's, then
// issue tile j + 1's box into the raw stage.  Consumer warpgroup wg (warps
// 4-7, 8-11) multiplies tile rows 2wg and 2wg+1 and writes them out; its
// epilogue overlaps the next tile's transform.  Barriers: rawfull (the
// box's bytes), xfull (96 producer arrivals), xempty (one per consumer
// warpgroup, after its products), wfull[st] (the slab's bytes), wempty[st]
// (one per consumer warpgroup, after the wgmma that read the slab
// completed).  cycles (or null): [gridDim.x][D96_NCY] (ops/branch_conv.py,
// D96_PHASES).
__global__ void __launch_bounds__(D96_NT, 1)
conv_d96_kernel(const __grid_constant__ CUtensorMap tmx, const bf16* __restrict__ x,
                const bf16* __restrict__ wp, const float* __restrict__ mul,
                const float* __restrict__ add, const bf16* __restrict__ xpost,
                bf16* __restrict__ y, float* __restrict__ partial,
                long long* __restrict__ cycles, Geo g, WgdOps ops, int pre, int stats, int post) {
  static_assert(D96_SMEM_BYTES <= SMEM_MAX, "D96's shared memory");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the TMA box lands at a 128-byte aligned offset
  unsigned char* raw = smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127);  // [96][6][72]
  unsigned char* xbuf = raw + D96_RAW;                               // the x operand
  unsigned char* wring = xbuf + D96_XBUF;                            // [D96_WST][D96_SLAB]
  unsigned char* stg = wring + D96_WST * D96_SLAB;                   // [8][WGD_STG]
  float* pm = reinterpret_cast<float*>(stg + 8 * WGD_STG);           // post: [3][Cp]
  bf16* pmb = reinterpret_cast<bf16*>(pm + 3 * CP96);                // pre: [2][Cp]
  uint64_t* rawfull = reinterpret_cast<uint64_t*>(pmb + 2 * CP96);
  uint64_t* xfull = rawfull + 1;
  uint64_t* xempty = xfull + 1;
  uint64_t* wfull = xempty + 1;                                      // [D96_WST]
  uint64_t* wempty = wfull + D96_WST;                                // [D96_WST]
  long long* cyc = reinterpret_cast<long long*>(wempty + D96_WST);   // [D96_NCY]
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const long long t_start = globaltimer_ns();
  const int C = g.C, slab = blockIdx.x, nslab = gridDim.x;
  const bool stamp = cycles != nullptr;
  if (post) {
    // pm[ci] = bf16(mul[ci]), pm[Cp + ci] = bf16(add[ci]), pm[2Cp + ci] = mul[ci]
    for (int e = t; e < 3 * CP96; e += D96_NT) {
      const int which = e / CP96, ci = e - which * CP96;
      const float v = ci < C ? (which == 1 ? add : mul)[ci] : 0.f;
      pm[e] = which == 2 ? v : bf16r(v);
    }
  }
  for (int e = t; e < 2 * CP96; e += D96_NT) {
    const int which = e / CP96, ci = e - which * CP96;
    pmb[e] = __float2bfloat16((pre && ci < C) ? (which ? add : mul)[ci] : 0.f);
  }
  if (t < D96_NCY) cyc[t] = 0;
  if (t == 0) {
    mbar_init(rawfull);         // the issuing thread (+ the box's bytes)
    mbar_init(xfull, 96);       // every x producer thread, after its stores
    mbar_init(xempty, 2);       // each consumer warpgroup, after its products
    for (int k = 0; k < D96_WST; ++k) {
      mbar_init(&wfull[k]);     // the issuing thread (+ the slab's bytes)
      mbar_init(&wempty[k], 2); // each consumer warpgroup, after its products
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int ntl = (g.ntiles - slab + nslab - 1) / nslab;  // this CTA's tiles

  // The roles never meet again: the producer warpgroup hands registers to
  // the consumers' accumulators (128 x 96 + 256 x 200 <= 65,536), and each
  // role writes its own stamps.
  long long* out = stamp ? cycles + (size_t)blockIdx.x * D96_NCY : nullptr;
  if (warp < 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 96;\n" ::: "memory");
    if (warp == 0) {
      // ------------------------------------------------------- weight slabs
      const int nsteps = 9 * ntl;
      for (int s = 0; s < nsteps; ++s) {
        const int st = s % D96_WST;
        if (s >= D96_WST) {  // the slab of step s - 3 released by both consumer warpgroups
          const long long c0 = stamp ? clock64() : 0;
          mbar_wait_bounded<false>(&wempty[st], (s / D96_WST - 1) & 1);
          if (stamp && lane == 0) cyc[2] += clock64() - c0;
        }
        if (lane == 0)
          bulk_load(wring + st * D96_SLAB, wp + (size_t)(s % 9) * (D96_SLAB / 2), D96_SLAB,
                    &wfull[st]);
        __syncwarp();
      }
      if (stamp && lane == 0) out[2] = cyc[2];
    } else {
      // ---------------------------------------------------------- x operand
      const int pt = t - 32, pw = pt >> 5;
      auto issue = [&](int j) {  // tile j's raw box, by thread 0 of the producers
        int n, oy0, ox0;
        wgd_tile(g, slab + j * nslab, n, oy0, ox0);
        mbar_arrive_expect_tx(rawfull, D96_RAW);
        tma_load_4d(raw, &tmx, rawfull, ox0, oy0 - 1, 0, n);
      };
      if (pt == 0 && ntl > 0) issue(0);
      for (int j = 0; j < ntl; ++j) {
        int n, oy0, ox0;
        wgd_tile(g, slab + j * nslab, n, oy0, ox0);
        // the left halo column's loads are in flight through the waits
        const int idx = pt < D96_CG * WGD_XR ? pt : -1;
        uint32_t h[8];
        wgd_left_load(h, x, g, n, oy0, ox0, idx);
        const long long c0 = stamp ? clock64() : 0;
        mbar_wait_bounded<false>(rawfull, j & 1);  // tile j's box has landed
        if (j >= 1)  // tile j - 1's operand released by both consumer warpgroups
          mbar_wait_bounded<false>(xempty, (j - 1) & 1);
        const long long c1 = stamp ? clock64() : 0;
        if (stamp && pt == 0) cyc[0] += c1 - c0;
        fence_async_shared();  // wgmma's reads of the operand before these writes
        // warp-item wi (0..17): 8 consecutive planes 8 * (wi % 9) + lane % 8
        // by 4 chunks k = 4 * (wi / 9) + lane / 8 + 1
#pragma unroll 1
        for (int u = 0; u < 6; ++u) {  // one oct live at a time: the registers are the consumers'
          const int wi = pw * 6 + u;
          wgd_oct<CP96>(xbuf, raw, pmb, pre != 0, g, ops, oy0, ox0, 8 * (wi % 9) + (lane & 7),
                        4 * (wi / 9) + (lane >> 3) + 1);
        }
        if (idx >= 0) wgd_singles<CP96>(xbuf, raw, h, pmb, pre != 0, g, ops, oy0, ox0, idx);
        fence_async_shared();  // these writes before wgmma's reads
        mbar_arrive(xfull);
        // every producer thread is past its reads of the raw stage
        asm volatile("bar.sync 2, 96;\n" ::: "memory");
        if (pt == 0 && j + 1 < ntl) {
          fence_async_shared();
          issue(j + 1);
        }
        if (stamp && pt == 0) cyc[1] += clock64() - c1;
      }
      if (stamp && pt == 0) {
        out[0] = cyc[0];
        out[1] = cyc[1];
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 200;\n" ::: "memory");
    // ---------------------------------------------------------- consumers
    const int cw = warp - 4, wg = cw >> 2, q = cw & 3, wt = t & 127;
    const bool st0 = stamp && t == 128;
    float acc[2][48];
#pragma unroll
    for (int i = 0; i < 48; ++i) acc[0][i] = acc[1][i] = 0.f;
    // statistics of this lane's chunks: C_out 48*hf + lane/2 + 16*k, pixel
    // half lane % 2 of the warp's 16 (index 3 * hf + k)
    float s1[6], s2[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) s1[k] = s2[k] = 0.f;
    const uint32_t xbuf_s = smem_addr(xbuf), wring_s = smem_addr(wring);
    unsigned char* ws = stg + cw * WGD_STG;
    const uint32_t ws_s = smem_addr(ws);
    if (st0) {
      cyc[7] = -clock64();
      cyc[9] = globaltimer_ns();
    }
    for (int i = 0; i < ntl; ++i) {
      int n, oy0, ox0;
      wgd_tile(g, slab + i * nslab, n, oy0, ox0);
      long long c0 = st0 ? clock64() : 0;
      mbar_wait_bounded<false>(xfull, i & 1);
      if (st0) cyc[3] += clock64() - c0;
      // this warpgroup's first row of the tile: halo row 2 * wg; taken
      // through an opaque move each tile, so the 54 descriptors built from
      // it are not hoisted out of the tile loop (108 registers held across
      // it spill)
      uint32_t xa;
      asm volatile("mov.b32 %0, %1;\n" : "=r"(xa) : "r"(xbuf_s + 2 * wg * ops.row));
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int s = 9 * i + tap, st = s % D96_WST;
        c0 = st0 ? clock64() : 0;
        mbar_wait_bounded<false>(&wfull[st], (s / D96_WST) & 1);
        const long long c1 = st0 ? clock64() : 0;
        wg_fence();
        const uint32_t wa = wring_s + st * D96_SLAB;
#pragma unroll
        for (int ks = 0; ks < CP96 / 16; ++ks) {
          const uint64_t da = wg_desc(xa + ops.tap[tap] + 2 * ks * ops.plane, ops.plane);
          const uint64_t db = wg_desc(wa + 2 * ks * D96_WLBO, D96_WLBO);
          wgmma96(acc[0], da, db, tap | ks);
          wgmma96(acc[1], da + (uint64_t)(ops.row >> 4), db, tap | ks);  // the next output row
        }
        wg_commit();
        if (tap > 0) {  // tap - 1's products are done: its slab is free
          wg_wait<1>();
          if (wt == 0) mbar_arrive(&wempty[(s - 1) % D96_WST]);
        }
        if (st0) {
          const long long c2 = clock64();
          cyc[4] += c1 - c0;
          cyc[5] += c2 - c1;
        }
      }
      // post: pass 0's x chunks in flight through the last tap's products
      uint4 xv[2][3];
      if (post) wgd_load_x(xv[0], xpost, g, n, oy0, ox0, 2 * wg, q, lane, 0, 0);
      c0 = st0 ? clock64() : 0;
      wg_wait<0>();
      wg_hold(acc[0]);
      wg_hold(acc[1]);
      if (wt == 0) {
        mbar_arrive(&wempty[(9 * i + 8) % D96_WST]);
        mbar_arrive(xempty);
      }
      const long long c1 = st0 ? clock64() : 0;
      if (st0) cyc[5] += c1 - c0;
      wgd_epilogue<CP96>(acc, s1, s2, xv, ws, ws_s, pm, xpost, y, g, n, oy0, ox0, 2 * wg,
                               q, lane, stats, post);
      if (st0) cyc[6] += clock64() - c1;
    }
    if (st0) {
      cyc[7] += clock64();
      cyc[10] = globaltimer_ns();
    }
    // the CTA partial through the x operand (every warpgroup is past its
    // last products at the named barrier, and the producers past their
    // last transform)
    if (stats || post)
      wgd_partial<CP96>(s1, s2, reinterpret_cast<float*>(xbuf), partial, C, slab, cw, lane, t);
    if (stamp) {
      asm volatile("bar.sync 1, 256;\n" ::: "memory");  // every partial stored
      if (st0) {
        cyc[8] = t_start;
        cyc[11] = globaltimer_ns();
        for (int k = 3; k < D96_NCY; ++k) out[k] = cyc[k];
      }
    }
  }
}

// D48: the CTAs walk D96's tiles (4 output rows x 64 pixels, here x all 48
// C_out), slab, slab + nslab, ...  Tile i's x goes through raw stage and
// operand buffer b = i % 2: thread 0 issues its TMA box (tmx [N,C,H,W], box
// {72, 6, 48, 1}) once the producers have read tile i - 2's out of that
// stage, and the producer warpgroup transforms it into operand buffer b
// once the consumers have released tile i - 2's (warps 1-3 the octs, warp
// 0 the halo's single columns), so tile i + 1's transform runs under tile
// i's products.  Thread 0 also bulk-copies the nine packed weight slabs
// once: they stay resident.  Consumer warpgroup wg (warps 4-7, 8-11)
// multiplies rows 2wg and 2wg+1 of every tile (two m64n48 accumulators)
// and writes them out.  Barriers: rawfull[b] (the box's bytes), xfull[b]
// (the 128 producer threads, after their stores), xempty[b] (one thread per
// consumer warpgroup, after its products), wfull (the weights' bytes).
// cycles (or null): [gridDim.x][D48_NCY] (ops/branch_conv.py, D48_PHASES).
__global__ void __launch_bounds__(D48_NT, 1)
conv_d48_kernel(const __grid_constant__ CUtensorMap tmx, const bf16* __restrict__ x,
                const bf16* __restrict__ wp, const float* __restrict__ mul,
                const float* __restrict__ add, const bf16* __restrict__ xpost,
                bf16* __restrict__ y, float* __restrict__ partial,
                long long* __restrict__ cycles, Geo g, WgdOps ops, int pre, int stats, int post) {
  static_assert(D48_SMEM_BYTES <= SMEM_MAX, "D48's shared memory");
  constexpr int NPL = D48_CG * WGD_XR;  // (group, row) planes of a tile: 36
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the TMA boxes land at 128-byte aligned offsets
  unsigned char* raw = smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127);  // [2][48][6][72]
  unsigned char* xbuf = raw + D48_NB * D48_RAW;                      // [2][the x operand]
  unsigned char* wsm = xbuf + D48_NB * D48_XBUF;                     // [9][6][48][8] bf16
  unsigned char* stg = wsm + 9 * D48_SLAB;                           // [8][WGD_STG]
  float* pm = reinterpret_cast<float*>(stg + 8 * WGD_STG);           // post: [3][Cp]
  bf16* pmb = reinterpret_cast<bf16*>(pm + 3 * CP48);                // pre: [2][Cp]
  uint64_t* rawfull = reinterpret_cast<uint64_t*>(pmb + 2 * CP48);   // [D48_NB]
  uint64_t* xfull = rawfull + D48_NB;                                // [D48_NB]
  uint64_t* xempty = xfull + D48_NB;                                 // [D48_NB]
  uint64_t* wfull = xempty + D48_NB;
  long long* cyc = reinterpret_cast<long long*>(wfull + 1);          // [D48_NCY]
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const long long t_start = globaltimer_ns();
  const int C = g.C, slab = blockIdx.x, nslab = gridDim.x;
  const bool stamp = cycles != nullptr;
  if (post) {
    // pm[ci] = bf16(mul[ci]), pm[Cp + ci] = bf16(add[ci]), pm[2Cp + ci] = mul[ci]
    for (int e = t; e < 3 * CP48; e += D48_NT) {
      const int which = e / CP48, ci = e - which * CP48;
      const float v = ci < C ? (which == 1 ? add : mul)[ci] : 0.f;
      pm[e] = which == 2 ? v : bf16r(v);
    }
  }
  for (int e = t; e < 2 * CP48; e += D48_NT) {
    const int which = e / CP48, ci = e - which * CP48;
    pmb[e] = __float2bfloat16((pre && ci < C) ? (which ? add : mul)[ci] : 0.f);
  }
  if (t < D48_NCY) cyc[t] = 0;
  if (t == 0) {
    for (int b = 0; b < D48_NB; ++b) {
      mbar_init(&rawfull[b]);     // the issuing thread (+ the box's bytes)
      mbar_init(&xfull[b], 128);  // every producer thread, after its stores
      mbar_init(&xempty[b], 2);   // each consumer warpgroup, after its products
    }
    mbar_init(wfull);             // the issuing thread (+ the weights' bytes)
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int ntl = (g.ntiles - slab + nslab - 1) / nslab;  // this CTA's tiles (>= 1)

  // The roles never meet again: the producer warpgroup hands registers to
  // the consumers' accumulators, and each role writes its own stamps.
  long long* out = stamp ? cycles + (size_t)blockIdx.x * D48_NCY : nullptr;
  if (warp < 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 96;\n" ::: "memory");
    // ------------------------------------------------------------ x operand
    auto issue = [&](int j) {  // tile j's raw box, by thread 0
      int n, oy0, ox0;
      wgd_tile(g, slab + j * nslab, n, oy0, ox0);
      mbar_arrive_expect_tx(&rawfull[j & 1], D48_RAW);
      tma_load_4d(raw + (j & 1) * D48_RAW, &tmx, &rawfull[j & 1], ox0, oy0 - 1, 0, n);
    };
    if (t == 0) {
      bulk_load(wsm, wp, 9 * D48_SLAB, wfull);
      for (int j = 0; j < D48_NB && j < ntl; ++j) issue(j);
    }
    for (int j = 0; j < ntl; ++j) {
      const int b = j & 1;
      int n, oy0, ox0;
      wgd_tile(g, slab + j * nslab, n, oy0, ox0);
      unsigned char* xop = xbuf + b * D48_XBUF;
      const unsigned char* rs = raw + b * D48_RAW;
      // warp 0: the single columns of planes lane and lane + 32; the left
      // column's loads in flight through the waits
      uint32_t h0[8], h1[8];
      if (warp == 0) {
        wgd_left_load(h0, x, g, n, oy0, ox0, lane);
        wgd_left_load(h1, x, g, n, oy0, ox0, lane + 32 < NPL ? lane + 32 : -1);
      }
      const long long c0 = stamp ? clock64() : 0;
      mbar_wait_bounded<false>(&rawfull[b], (j >> 1) & 1);  // tile j's box has landed
      const long long c1 = stamp ? clock64() : 0;
      if (j >= D48_NB)  // tile j - 2's operand released by both consumer warpgroups
        mbar_wait_bounded<false>(&xempty[b], ((j - D48_NB) >> 1) & 1);
      const long long c2 = stamp ? clock64() : 0;
      fence_async_shared();  // wgmma's reads of the operand before these writes
      if (warp == 0) {
        wgd_singles<CP48>(xop, rs, h0, pmb, pre != 0, g, ops, oy0, ox0, lane);
        if (lane + 32 < NPL)
          wgd_singles<CP48>(xop, rs, h1, pmb, pre != 0, g, ops, oy0, ox0, lane + 32);
      } else {
        // warp-item wi (0..8): octs o = 32 wi + lane of plane o % 36 and
        // chunk k = o / 36 + 1 (the 8 lanes of a phase: 8 consecutive planes)
#pragma unroll 1
        for (int u = 0; u < 3; ++u) {
          const int o = 32 * (3 * (warp - 1) + u) + lane;
          wgd_oct<CP48>(xop, rs, pmb, pre != 0, g, ops, oy0, ox0, o % NPL, o / NPL + 1);
        }
      }
      fence_async_shared();  // these writes before wgmma's reads
      mbar_arrive(&xfull[b]);
      // every producer thread is past its reads of raw stage b
      asm volatile("bar.sync 2, 128;\n" ::: "memory");
      if (t == 0 && j + D48_NB < ntl) {
        fence_async_shared();
        issue(j + D48_NB);
      }
      if (stamp && t == 0) {
        cyc[0] += c1 - c0;
        cyc[1] += c2 - c1;
        cyc[2] += clock64() - c2;
      }
    }
    if (stamp && t == 0)
      for (int k = 0; k < 3; ++k) out[k] = cyc[k];
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 200;\n" ::: "memory");
    // ---------------------------------------------------------- consumers
    const int cw = warp - 4, wg = cw >> 2, q = cw & 3, wt = t & 127;
    const bool st0 = stamp && t == 128;
    float acc[2][24];
#pragma unroll
    for (int i = 0; i < 24; ++i) acc[0][i] = acc[1][i] = 0.f;
    float s1[3], s2[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) s1[k] = s2[k] = 0.f;
    const uint32_t xbuf_s = smem_addr(xbuf), wsm_s = smem_addr(wsm);
    unsigned char* ws = stg + cw * WGD_STG;
    const uint32_t ws_s = smem_addr(ws);
    if (st0) {
      cyc[8] = -clock64();
      cyc[10] = globaltimer_ns();
    }
    long long c0 = st0 ? clock64() : 0;
    mbar_wait_bounded<false>(wfull, 0);  // the resident weights have landed
    if (st0) cyc[3] += clock64() - c0;
    for (int i = 0; i < ntl; ++i) {
      int n, oy0, ox0;
      wgd_tile(g, slab + i * nslab, n, oy0, ox0);
      c0 = st0 ? clock64() : 0;
      mbar_wait_bounded<false>(&xfull[i & 1], (i >> 1) & 1);
      const long long c1 = st0 ? clock64() : 0;
      // this warpgroup's first row of the tile: halo row 2 * wg; the bases
      // go through opaque moves each tile, so the 54 descriptors built from
      // them are not hoisted out of the tile loop (and spilled)
      uint32_t xa, wa;
      asm volatile("mov.b32 %0, %1;\n" : "=r"(xa)
                   : "r"(xbuf_s + (i & 1) * D48_XBUF + 2 * wg * ops.row));
      asm volatile("mov.b32 %0, %1;\n" : "=r"(wa) : "r"(wsm_s));
      wg_fence();
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
#pragma unroll
        for (int ks = 0; ks < CP48 / 16; ++ks) {
          const uint64_t da = wg_desc(xa + ops.tap[tap] + 2 * ks * ops.plane, ops.plane);
          const uint64_t db = wg_desc(wa + tap * D48_SLAB + 2 * ks * D48_WLBO, D48_WLBO);
          wgmma48(acc[0], da, db, tap | ks);
          wgmma48(acc[1], da + (uint64_t)(ops.row >> 4), db, tap | ks);  // the next output row
        }
      wg_commit();
      const long long c2 = st0 ? clock64() : 0;
      uint4 xv[2][3];  // post: pass 0's x chunks in flight through the products
      if (post) wgd_load_x(xv[0], xpost, g, n, oy0, ox0, 2 * wg, q, lane, 0, 0);
      wg_wait<0>();
      wg_hold(acc[0]);
      wg_hold(acc[1]);
      if (wt == 0) mbar_arrive(&xempty[i & 1]);
      const long long c3 = st0 ? clock64() : 0;
      wgd_epilogue<CP48>(acc, s1, s2, xv, ws, ws_s, pm, xpost, y, g, n, oy0, ox0, 2 * wg,
                                q, lane, stats, post);
      if (st0) {
        cyc[4] += c1 - c0;
        cyc[5] += c2 - c1;
        cyc[6] += c3 - c2;
        cyc[7] += clock64() - c3;
      }
    }
    if (st0) {
      cyc[8] += clock64();
      cyc[11] = globaltimer_ns();
    }
    // the CTA partial through operand buffer 0 (every warpgroup is past its
    // last products at the named barrier, and the producers past their
    // last transform)
    if (stats || post)
      wgd_partial<CP48>(s1, s2, reinterpret_cast<float*>(xbuf), partial, C, slab, cw, lane, t);
    if (stamp) {
      asm volatile("bar.sync 1, 256;\n" ::: "memory");  // every partial stored
      if (st0) {
        cyc[9] = t_start;
        cyc[12] = globaltimer_ns();
        for (int k = 3; k < D48_NCY; ++k) out[k] = cyc[k];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// E48: kernel E at Cp = 48, wgmma, warp-specialised, persistent
// ---------------------------------------------------------------------------
//
// Replaces, at channels that pad to 48 (HRNet-W48's branch 0), the TPU
// kernel E replaces: pallas_conv.py:536 _conv3x3_dw_impl (-> _dw_kernel_dyroll).
// The design and its shared-memory budget are in the note at the top (E48).

#define DW48_NT 384                          // threads: a producer warpgroup, two consumer warpgroups
#define DW48_SIDEC 8                         // the left halo box's columns: ox0-8 .. ox0-1
#define DW48_SIDE (CP48 * WGD_XR * DW48_SIDEC * 2)  // the left halo box, bytes
#define DW48_LINE (WGD_TC * 2)               // a dy line: 64 pixels of one C_out, 128 bytes
#define DW48_ROWBOX (CP48 * DW48_LINE)       // one output row's dy (or y) box [48][64], bytes
#define DW48_DYST (WGD_TR * DW48_ROWBOX)     // a tile's dy (dY in place) or y stage, bytes
#define DW48_TAPS0 5                         // taps of consumer warpgroup 0; 1 takes the other 4
#define DW48_NCY 16                          // stamps per CTA
#define DW48_SMEM_BYTES                                                                       \
  (1024 + 3 * DW48_DYST + D48_RAW + DW48_SIDE + 2 * D48_XBUF + 2 * CP48 * 4 + 2 * CP48 * 2 + \
   9 * 8 + DW48_NCY * 8)

// A wgmma descriptor of an MN-major operand without swizzle at shared
// address addr: core matrices of 8 K rows x 16 bytes (8 N elements), the
// 8-row K groups 128 bytes apart (the leading byte offset), the 8-element
// N groups sbo bytes apart.
__device__ __forceinline__ uint64_t wg_desc_mn(uint32_t addr, uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// d += A * B, m64n48k16, bf16 in, f32 accumulators, A from registers (a
// warp's 16 rows in mma.sync's A fragment layout), B MN-major.
__device__ __forceinline__ void wgmma48_rs(float (&d)[24], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// A tensor map's descriptor into the TMA unit's cache, ahead of its first box.
__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// The left halo column (x column ox0 - 1) of (group, row) plane idx from
// E48's side box [48][6][8] (columns ox0-8 .. ox0-1, zero outside the
// image), one value a word as wgd_singles takes it.
__device__ __forceinline__ void dw48_left(uint32_t (&h)[8], const unsigned char* side, int idx) {
  const int grp = idx / WGD_XR, r = idx - grp * WGD_XR;
  const uint16_t* src = reinterpret_cast<const uint16_t*>(side) + (grp * 8 * WGD_XR + r) *
                        DW48_SIDEC + DW48_SIDEC - 1;
#pragma unroll
  for (int j = 0; j < 8; ++j) h[j] = src[j * WGD_XR * DW48_SIDEC];
}

// fold2's dY (the same f32 roundings and bits), both halves rounded to
// bf16 by one cvt.rn.bf16x2.f32.
__device__ __forceinline__ uint32_t dw48_fold2(uint32_t d, uint32_t yv, float s0, float s1) {
  const float lo = __fadd_rn(__fadd_rn(__uint_as_float(d << 16), s0),
                             __fmul_rn(__fmul_rn(2.f, __uint_as_float(yv << 16)), s1));
  const float hi = __fadd_rn(__fadd_rn(__uint_as_float(d & 0xffff0000u), s0),
                             __fmul_rn(__fmul_rn(2.f, __uint_as_float(yv & 0xffff0000u)), s1));
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// A tile's dY in place in its dy stage: four row boxes [48 C_out][64 px]
// as TMA's 128-byte swizzle lands them (chunk q of line l = 48 rr + co
// holds pixels 8 (q ^ co % 8) .. + 7 of output row oy0 + rr), the stats
// cotangent folded in from the y stage (the same layout); one TMA store
// writes the stage out as dY (dw48_consumer).  By position: pixels at ox >=
// W and rows co >= C are 0 in the operand (the zero-filled dy would give
// ds0; the store leaves them out, past the tensor).  Thread tid of the 256
// consumer threads takes chunks tid, tid + 256, ..., two at a time, their
// loads first.
__device__ __forceinline__ void dw48_compose(unsigned char* dys, const unsigned char* ys,
                                             const float* dss, const Geo& g, int ox0, int tid) {
  constexpr int NCH = WGD_TR * CP48 * 8, PER = NCH / 256;  // 1536 chunks, 6 a thread
  static_assert(NCH % 256 == 0 && PER % 2 == 0, "E48's compose: two chunks at a time");
#pragma unroll 1
  for (int u0 = 0; u0 < PER; u0 += 2) {
    uint4 v[2], yv[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = tid + 256 * (u0 + u);
      v[u] = *reinterpret_cast<const uint4*>(dys + e * 16);
      yv[u] = *reinterpret_cast<const uint4*>(ys + e * 16);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = tid + 256 * (u0 + u), q = e & 7, line = e >> 3;
      const int co = line % CP48;
      uint4 o = make_uint4(0, 0, 0, 0);
      if (co < g.C && ox0 + 8 * (q ^ (co & 7)) < g.W) {
        const float s0 = dss[co], s1 = dss[CP48 + co];
        o = make_uint4(dw48_fold2(v[u].x, yv[u].x, s0, s1), dw48_fold2(v[u].y, yv[u].y, s0, s1),
                       dw48_fold2(v[u].z, yv[u].z, s0, s1), dw48_fold2(v[u].w, yv[u].w, s0, s1));
      }
      *reinterpret_cast<uint4*>(dys + e * 16) = o;
    }
  }
}

// Tile tile's dy (or y) into stage st by one TMA box of map, a map over
// the activation with its dims ordered (W, C, H, N) (encode_rows): the box
// {64, 48, 4, 1} lands as the four row boxes [rr][co][64 px], completing
// on bar.
__device__ __forceinline__ void dw48_issue_rows(unsigned char* st, uint64_t* bar,
                                                const CUtensorMap* map, const Geo& g, int tile) {
  int n, oy0, ox0;
  wgd_tile(g, tile, n, oy0, ox0);
  mbar_arrive_expect_tx(bar, DW48_DYST);
  tma_load_4d(st, map, bar, ox0, 0, oy0, n);
}

// Stage st as tile tile's dY through map (encode_rows over dY): one TMA
// store, its elements past the tensor left out; a bulk group of its own.
__device__ __forceinline__ void dw48_store_rows(const unsigned char* st, const CUtensorMap* map,
                                                const Geo& g, int tile) {
  int n, oy0, ox0;
  wgd_tile(g, tile, n, oy0, ox0);
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      "cp.async.bulk.commit_group;\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(st)), "r"(ox0), "r"(0), "r"(oy0),
         "r"(n) : "memory");
}

// This thread's bulk stores have read their shared memory (READ) or are
// complete.
template <bool READ>
__device__ __forceinline__ void bulk_store_wait() {
  if constexpr (READ)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// A consumer warpgroup's tiles.  Per tile: once the producers have
// transformed its x and its dy (and y) have landed, both consumer
// warpgroups compose its dY in place (fuse; 6 chunks a thread) and meet at
// a named barrier, after which warpgroup 0's thread 0 releases the y stage
// and warpgroup 1's writes the stage out as dY by one TMA store (tmdYo),
// waiting for the store's read of it before it releases the stage;
// then this warpgroup's taps TAP0 .. TAP0 + NTAP - 1: per k16 step s (tile
// row s / 4, pixels 16 (s % 4) ..) one dY fragment (A, M = 64 C_out, loaded
// from registers: warp w of the warpgroup takes rows 16 w .. by one
// ldmatrix.x4 through the 128-byte swizzle, conflict-free; warp 3's rows
// 48-63 are zeros), loaded while the step before runs, serves all the
// warpgroup's taps, and per tap the x operand's descriptor (B, MN-major, N
// = the 48 ci, K = pixels, at the tap's start offset); the accumulators
// (NTAP x 24 f32) are summed over all the CTA's tiles.  After the products
// thread 0 releases the tile's stage.  At the end: the CTA's partial[slab][co][tap * 48 + ci]
// (rows co < 48: warps 0-2 of the warpgroup).
template <int TAP0, int NTAP>
__device__ __forceinline__ void dw48_consumer(unsigned char* dyst, const unsigned char* yst,
                                              const unsigned char* xbuf, const float* dss,
                                              const CUtensorMap* tmdYo, uint64_t* ready,
                                              uint64_t* empty, uint64_t* dyfull, uint64_t* yfull,
                                              uint64_t* yempty, float* __restrict__ partial,
                                              long long* cyc, const Geo& g, const WgdOps& ops,
                                              int fuse, int slab, int nslab, int ntl, int wq,
                                              int lane, int wt, bool st0) {
  float acc[NTAP][24];
#pragma unroll
  for (int k = 0; k < NTAP; ++k)
#pragma unroll
    for (int i = 0; i < 24; ++i) acc[k][i] = 0.f;
  const uint32_t xbuf_s = smem_addr(xbuf), dy_s = smem_addr(dyst);
  if (st0) {
    cyc[11] = -clock64();
    cyc[13] = globaltimer_ns();
  }
  for (int i = 0; i < ntl; ++i) {
    const int b = i & 1;
    int n, oy0, ox0;
    wgd_tile(g, slab + i * nslab, n, oy0, ox0);
    const long long c0 = st0 ? clock64() : 0;
    mbar_wait_bounded<false>(&ready[b], (i >> 1) & 1);  // tile i's x operand is staged
    const long long c1 = st0 ? clock64() : 0;
    mbar_wait_bounded<false>(&dyfull[b], (i >> 1) & 1);  // tile i's dy has landed
    if (fuse) mbar_wait_bounded<false>(yfull, i & 1);     // ... and its y
    const long long c2 = st0 ? clock64() : 0;
    if (fuse) {
      dw48_compose(dyst + b * DW48_DYST, yst, dss, g, ox0, wt + (TAP0 ? 128 : 0));
      fence_async_shared();  // dY's stores before the TMA store's reads, the next load's writes
      // both warpgroups' dY is stored and the y stage read
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      if (wt == 0) {
        if (TAP0 == 0)
          mbar_arrive(yempty);
        else
          dw48_store_rows(dyst + b * DW48_DYST, tmdYo, g, slab + i * nslab);
      }
      __syncwarp();
    }
    const long long c3 = st0 ? clock64() : 0;
    // the bases go through opaque moves each tile, so the descriptors built
    // from them are not hoisted out of the tile loop (and spilled)
    uint32_t ya, xk[NTAP];
    // this lane's ldmatrix row: C_out 16 wq + lane % 16, chunk half lane / 16
    asm volatile("mov.b32 %0, %1;\n" : "=r"(ya)
                 : "r"(dy_s + b * DW48_DYST + (16 * wq + (lane & 15)) * DW48_LINE));
#pragma unroll
    for (int k = 0; k < NTAP; ++k)
      asm volatile("mov.b32 %0, %1;\n" : "=r"(xk[k])
                   : "r"(xbuf_s + b * D48_XBUF + ops.tap[TAP0 + k]));
    // step s's fragment: pixels 16 (s % 4) + 8 (lane / 16) .. of row s / 4,
    // in chunk (2 (s % 4) + lane / 16) ^ (C_out % 8) of the swizzled line
    uint32_t afr[2][4];
    auto load_a = [&](int s, uint32_t (&a)[4]) {
      if (wq < 3)
        ldsm_x4(a, ya + (s >> 2) * DW48_ROWBOX + (((2 * (s & 3) + (lane >> 4)) ^ (lane & 7)) << 4));
      else
        a[0] = a[1] = a[2] = a[3] = 0u;
    };
    load_a(0, afr[0]);
#pragma unroll
    for (int s = 0; s < 4 * WGD_TR; ++s) {
      const int rr = s >> 2, sp = s & 3;
      wg_fence();  // this step's fragment is in its registers
#pragma unroll
      for (int k = 0; k < NTAP; ++k)
        wgmma48_rs(acc[k], afr[s & 1],
                   wg_desc_mn(xk[k] + rr * (WGD_XP * 16) + 256 * sp, WGD_PLANE));
      wg_commit();
      if (s + 1 < 4 * WGD_TR) {
        wg_wait<1>();  // step s - 1's products are done: its fragment's registers are free
        load_a(s + 1, afr[(s + 1) & 1]);
      }
    }
    const long long c4 = st0 ? clock64() : 0;
    wg_wait<0>();
#pragma unroll
    for (int k = 0; k < NTAP; ++k) wg_hold(acc[k]);
    const long long c5 = st0 ? clock64() : 0;
    if (wt == 0) {
      if (TAP0 != 0 && fuse) bulk_store_wait<true>();  // the dY store has read the stage
      mbar_arrive(&empty[b]);
    }
    __syncwarp();
    if (st0) {
      cyc[4] += c1 - c0;
      cyc[5] += c2 - c1;
      cyc[6] += c3 - c2;
      cyc[7] += c4 - c3;
      cyc[8] += c5 - c4;
      cyc[9] += clock64() - c5;
    }
  }
  if (TAP0 != 0 && fuse && wt == 0) bulk_store_wait<false>();  // the last dY is written
  const long long c6 = st0 ? clock64() : 0;
  if (st0) {
    cyc[11] += c6;
    cyc[14] = globaltimer_ns();
  }
  if (wq < 3) {
    const int row = 16 * wq + (lane >> 2);
#pragma unroll
    for (int k = 0; k < NTAP; ++k)
#pragma unroll
      for (int j = 0; j < 6; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = (TAP0 + k) * CP48 + 8 * j + 2 * (lane & 3);
          *reinterpret_cast<float2*>(
              &partial[((size_t)slab * CP48 + row + 8 * h) * (9 * CP48) + col]) =
              make_float2(acc[k][4 * j + 2 * h], acc[k][4 * j + 2 * h + 1]);
        }
  }
  if (st0) cyc[10] += clock64() - c6;
}

// The CTAs walk D48's tiles (4 output rows x 64 pixels), slab, slab +
// nslab, ...  Tile j goes through the raw x stage (D48's box, tmx [N,C,H,W]
// {72, 6, 48, 1}, and the left halo's side box, tmxs {8, 6, 48, 1} at ox0 -
// 8, both without swizzle), x operand buffer and dy stage b = j % 2, and
// the y stage.  The producer warpgroup transforms tile j's x into operand
// buffer b once tile j - 2's products are done (warps 1-3 the octs, warp 0
// the halo's single columns, as D48).  Its thread 0 issues every load, each
// after its own share of the transform, so a TMA issue that holds it
// delays no one: tile j's dy into stage b (tmdy, a (W, C, H, N) map, box
// {64, 48, 4, 1}, 128-byte swizzle; stage b was freed by tile j - 2's
// products), tile j + 1's x and side boxes once every producer has read
// tile j's out of the raw stage, and tile j's y (tmy, as tmdy) once the
// consumers have composed tile j - 1's.  The consumer warpgroups compose
// tile j's dY in place in dy stage b and store it out as dY (tmdYo, as
// tmdy) (dw48_consumer).  Barriers: rawfull,
// dyfull[b], yfull (the boxes' bytes), ready[b] (the 128 producer threads,
// after their stores), empty[b] (one thread per consumer warpgroup, after
// its products), yempty (consumer warpgroup 0's thread 0, after the
// consumers' named barrier that ends the compose).  (A second y stage, or
// an uneven share of the compose, measured slower.)  cycles (or null):
// [gridDim.x][DW48_NCY] (ops/branch_conv.py, DW48_PHASES).
__global__ void __launch_bounds__(DW48_NT, 1)
conv_dw48_kernel(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmxs,
                 const __grid_constant__ CUtensorMap tmdy, const __grid_constant__ CUtensorMap tmy,
                 const __grid_constant__ CUtensorMap tmdYo, const float* __restrict__ ds,
                 const float* __restrict__ mul, const float* __restrict__ add,
                 float* __restrict__ partial, long long* __restrict__ cycles, Geo g, WgdOps ops,
                 int pre, int fuse) {
  static_assert(DW48_SMEM_BYTES <= SMEM_MAX, "E48's shared memory");
  constexpr int NPL = D48_CG * WGD_XR;  // (group, row) planes of a tile: 36
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzled dy and y boxes sit on 1024-byte atoms; dy stage 1's last
  // row box is followed by the y stage, so the dropped rows 48-63 of its A
  // read stay in shared memory
  unsigned char* dyst = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);  // [2][4][48][64]
  unsigned char* yst = dyst + 2 * DW48_DYST;                          // [4][48][64]
  unsigned char* raw = yst + DW48_DYST;                               // [48][6][72]
  unsigned char* side = raw + D48_RAW;                                // [48][6][8]
  unsigned char* xbuf = side + DW48_SIDE;                             // [2][the x operand]
  float* dss = reinterpret_cast<float*>(xbuf + 2 * D48_XBUF);         // [2][48]
  bf16* pmb = reinterpret_cast<bf16*>(dss + 2 * CP48);                // pre: [2][48]
  uint64_t* rawfull = reinterpret_cast<uint64_t*>(pmb + 2 * CP48);
  uint64_t* dyfull = rawfull + 1;                                     // [2]
  uint64_t* yfull = dyfull + 2;
  uint64_t* ready = yfull + 1;                                        // [2]
  uint64_t* empty = ready + 2;                                        // [2]
  uint64_t* yempty = empty + 2;
  long long* cyc = reinterpret_cast<long long*>(yempty + 1);          // [DW48_NCY]
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const long long t_start = globaltimer_ns();
  const int C = g.C, slab = blockIdx.x, nslab = gridDim.x;
  const bool stamp = cycles != nullptr;
  for (int e = t; e < 2 * CP48; e += DW48_NT) {
    const int which = e / CP48, c = e - which * CP48;
    dss[e] = (fuse && c < C) ? ds[which * C + c] : 0.f;
    pmb[e] = __float2bfloat16((pre && c < C) ? (which ? add : mul)[c] : 0.f);
  }
  if (t < DW48_NCY) cyc[t] = 0;
  if (t == 0) {
    mbar_init(rawfull);           // the issuing thread (+ the x and side boxes' bytes)
    for (int b = 0; b < 2; ++b) {
      mbar_init(&dyfull[b]);      // the issuing thread (+ the box's bytes)
      mbar_init(&ready[b], 128);  // every producer thread, after its stores
      mbar_init(&empty[b], 2);    // each consumer warpgroup, after its products
    }
    mbar_init(yfull);             // the issuing thread (+ the box's bytes)
    mbar_init(yempty);            // consumer warpgroup 0's thread 0, after the compose
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int ntl = (g.ntiles - slab + nslab - 1) / nslab;  // this CTA's tiles (>= 1)

  // The roles never meet again before the end: the producer warpgroup hands
  // registers to the consumers' accumulators, and each role writes its own
  // stamps.
  long long* out = stamp ? cycles + (size_t)blockIdx.x * DW48_NCY : nullptr;
  if (warp < 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 96;\n" ::: "memory");
    auto issue_x = [&](int j) {  // tile j's x and side boxes into the raw stage
      int n, oy0, ox0;
      wgd_tile(g, slab + j * nslab, n, oy0, ox0);
      mbar_arrive_expect_tx(rawfull, D48_RAW + DW48_SIDE);
      tma_load_4d(raw, &tmx, rawfull, ox0, oy0 - 1, 0, n);
      tma_load_4d(side, &tmxs, rawfull, ox0 - DW48_SIDEC, oy0 - 1, 0, n);
    };
    if (t == 0) {
      tma_prefetch_map(&tmx);
      tma_prefetch_map(&tmxs);
      tma_prefetch_map(&tmdy);
      if (fuse) {
        tma_prefetch_map(&tmy);
        tma_prefetch_map(&tmdYo);
      }
      issue_x(0);
      for (int j = 0; j < 2 && j < ntl; ++j)
        dw48_issue_rows(dyst + j * DW48_DYST, &dyfull[j], &tmdy, g, slab + j * nslab);
      if (fuse) dw48_issue_rows(yst, yfull, &tmy, g, slab);
    }
    for (int j = 0; j < ntl; ++j) {
      const int b = j & 1;
      int n, oy0, ox0;
      wgd_tile(g, slab + j * nslab, n, oy0, ox0);
      unsigned char* xop = xbuf + b * D48_XBUF;
      const long long c0 = stamp ? clock64() : 0;
      mbar_wait_bounded<false>(rawfull, j & 1);  // tile j's x and side boxes have landed
      const long long c1 = stamp ? clock64() : 0;
      if (j >= 2)  // tile j - 2's products are done: operand buffer b is free
        mbar_wait_bounded<false>(&empty[b], ((j - 2) >> 1) & 1);
      const long long c2 = stamp ? clock64() : 0;
      fence_async_shared();  // wgmma's reads of the operand before these writes
      if (warp == 0) {
        // the single columns of planes lane and lane + 32
        uint32_t h[8];
        dw48_left(h, side, lane);
        wgd_singles<CP48>(xop, raw, h, pmb, pre != 0, g, ops, oy0, ox0, lane);
        if (lane + 32 < NPL) {
          dw48_left(h, side, lane + 32);
          wgd_singles<CP48>(xop, raw, h, pmb, pre != 0, g, ops, oy0, ox0, lane + 32);
        }
      } else {
        // D48's octs: o = 32 wi + lane of plane o % 36 and chunk k = o / 36 + 1
#pragma unroll 1
        for (int u = 0; u < 3; ++u) {
          const int o = 32 * (3 * (warp - 1) + u) + lane;
          wgd_oct<CP48>(xop, raw, pmb, pre != 0, g, ops, oy0, ox0, o % NPL, o / NPL + 1);
        }
      }
      fence_async_shared();  // these writes before wgmma's reads
      mbar_arrive(&ready[b]);
      const long long c3 = stamp ? clock64() : 0;
      if (t == 0 && j >= 2) {  // tile j - 2's products freed dy stage b (waited for above)
        fence_async_shared();
        dw48_issue_rows(dyst + b * DW48_DYST, &dyfull[b], &tmdy, g, slab + j * nslab);
      }
      // every producer thread is past its reads of the raw stage
      asm volatile("bar.sync 2, 128;\n" ::: "memory");
      if (t == 0) {
        if (j + 1 < ntl) {
          fence_async_shared();
          issue_x(j + 1);
        }
        if (fuse && j >= 1) {  // the consumers have composed tile j - 1: the y stage is free
          mbar_wait_bounded<false>(yempty, (j - 1) & 1);
          fence_async_shared();
          dw48_issue_rows(yst, yfull, &tmy, g, slab + j * nslab);
        }
      }
      if (stamp && t == 0) {
        cyc[0] += c1 - c0;
        cyc[1] += c2 - c1;
        cyc[2] += c3 - c2;
        cyc[3] += clock64() - c3;
      }
    }
    if (stamp && t == 0)
      for (int k = 0; k < 4; ++k) out[k] = cyc[k];
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 200;\n" ::: "memory");
    const int cw = warp - 4, wq = cw & 3, wt = t & 127;
    const bool st0 = stamp && t == 128;
    if (cw < 4)
      dw48_consumer<0, DW48_TAPS0>(dyst, yst, xbuf, dss, &tmdYo, ready, empty, dyfull, yfull,
                                   yempty, partial, cyc, g, ops, fuse, slab, nslab, ntl, wq, lane,
                                   wt, st0);
    else
      dw48_consumer<DW48_TAPS0, 9 - DW48_TAPS0>(dyst, yst, xbuf, dss, &tmdYo, ready, empty,
                                                dyfull, yfull, yempty, partial, cyc, g, ops, fuse,
                                                slab, nslab, ntl, wq, lane, wt, false);
    if (stamp) {
      asm volatile("bar.sync 1, 256;\n" ::: "memory");  // every partial stored
      if (st0) {
        cyc[12] = t_start;
        cyc[15] = globaltimer_ns();
        for (int k = 4; k < DW48_NCY; ++k) out[k] = cyc[k];
      }
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

// The plans of D96 (CP = 96) and D48 (CP = 48): out[0] = shared bytes,
// out[1] = x operand buffers, out[2] = weight slabs in shared memory (D96:
// its ring's stages; D48: all nine, resident), out[3] = tile rows, out[4]
// = tile pixels per row, out[5] = warpgroups (one producer, two
// consumers), out[6] = CTAs per SM (the occupancy calculator's: 0 if the
// plan does not fit), out[7] = tiles per image plane (for the grid),
// out[8] = packed weight elements (the wpack buffer), out[9] = the x
// operand's halo row pitch (pixels), out[10] = one raw x stage's bytes (one
// TMA box a tile).
template <int CP, typename Kernel>
static int wgd_plan(Kernel kernel, int smem, int nthreads, int xbufs, int wslabs, int raw,
                    int C, int H, int W, int* out) {
  const Geo g = make_wgd_geo(1, C, H, W);
  if (C < 1 || g.Cp != CP) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int bps = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&bps, kernel, nthreads, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = smem;
  out[1] = xbufs;
  out[2] = wslabs;
  out[3] = WGD_TR;
  out[4] = WGD_TC;
  out[5] = nthreads / 128;
  out[6] = bps;
  out[7] = g.ntiles;
  out[8] = 9 * CP * CP;
  out[9] = WGD_XP;
  out[10] = raw;
  return 0;
}

extern "C" int branch_conv_fwd96_plan(int C, int H, int W, int* out) {
  return wgd_plan<CP96>(conv_d96_kernel, D96_SMEM_BYTES, D96_NT, 1, D96_WST, D96_RAW, C, H, W,
                        out);
}

extern "C" int branch_conv_fwd48_plan(int C, int H, int W, int* out) {
  return wgd_plan<CP48>(conv_d48_kernel, D48_SMEM_BYTES, D48_NT, D48_NB, 9, D48_RAW, C,
                        H, W, out);
}

// The host's x operand addressing (ops: plane, row, tap[9] bytes) against
// the buffers this source lays out (the same planes at both widths): the
// planes and rows its producers write, and every tap of every tile row
// inside its channel group's plane.
static bool wgd_ops_ok(const int* ops, WgdOps& o) {
  if (!ops) return false;
  o.plane = ops[0];
  o.row = ops[1];
  if (o.plane != WGD_PLANE || o.row != WGD_XP * 16) return false;
  for (int k = 0; k < 9; ++k) {
    o.tap[k] = ops[2 + k];
    if (o.tap[k] < 0 || o.tap[k] % 16 != 0 ||
        o.tap[k] + (WGD_TR - 1) * o.row + WGD_TC * 16 > o.plane)
      return false;
  }
  return true;
}

static int encode_act(CUtensorMap* map, const void* p, const Geo& g, int bw, int bh, int bc);

// The weight pack of D96 or D48 into wpack.
template <int CP>
static cudaError_t launch_pack_wg(const void* w, void* wpack, int C, int flip, cudaStream_t s) {
  pack_wg_kernel<CP><<<(9 * CP * CP + 255) / 256, 256, 0, s>>>((const float*)w, (bf16*)wpack, C,
                                                               flip);
  return cudaGetLastError();
}

// D96 (CP = 96) or D48 (CP = 48): x's tensor map (box {72, 6, CP, 1}), the weights packed
// into wpack, the persistent CTAs (grid nslab <= tiles, one per SM), then
// with sums the fixed-order reduction.
template <int CP>
static int run_wgd(const void* x, const void* w, const void* mul, const void* add,
                   const void* xpost, void* y, void* partial, void* sums, void* wpack,
                   void* cycles, const int* ops, int N, int C, int H, int W, int pre, int stats,
                   int flip, int post, int nslab, cudaStream_t s) {
  const Geo g = make_wgd_geo(N, C, H, W);
  WgdOps o;
  if (g.Cp != CP || W % 8 != 0 || nslab > g.ntiles || !aligned16(x) || !aligned16(y) ||
      !aligned16(wpack) || (xpost && !aligned16(xpost)) || !wgd_ops_ok(ops, o))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tmx;
  const int e = encode_act(&tmx, x, g, WGD_RAWC, WGD_XR, CP);
  if (e) return e;
  cudaError_t err = launch_pack_wg<CP>(w, wpack, C, flip, s);
  if (err != cudaSuccess) return (int)err;
  const bf16 *xb = (const bf16*)x, *wb = (const bf16*)wpack, *xpb = (const bf16*)xpost;
  const float *mf = (const float*)mul, *af = (const float*)add;
  if constexpr (CP == CP96) {
    err = cudaFuncSetAttribute(conv_d96_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               D96_SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    conv_d96_kernel<<<nslab, D96_NT, D96_SMEM_BYTES, s>>>(
        tmx, xb, wb, mf, af, xpb, (bf16*)y, (float*)partial, (long long*)cycles, g, o, pre, stats,
        post);
  } else {
    err = cudaFuncSetAttribute(conv_d48_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, D48_SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    conv_d48_kernel<<<nslab, D48_NT, D48_SMEM_BYTES, s>>>(
        tmx, xb, wb, mf, af, xpb, (bf16*)y, (float*)partial, (long long*)cycles, g, o, pre, stats,
        post);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || !sums) return (int)err;
  reduce_rows_kernel<<<(2 * C + 255) / 256, 256, 0, s>>>((const float*)partial, nslab, 2 * C,
                                                        (float*)sums);
  return (int)cudaGetLastError();
}

// D96 or D48 (kern = its padded width, 96 or 48): needs C padding to kern,
// W % 8 == 0, the activations and wpack 16-byte aligned and this source's
// operand plan in ops; cycles (the stamps) or null.
static int run_fwd_packed(int kern, const void* x, const void* w, const void* mul,
                          const void* add, const void* xpost, void* y, void* partial, void* sums,
                          void* wpack, void* cycles, const int* ops, int N, int C, int H, int W,
                          int pre, int stats, int flip, int post, int nslab, void* stream) {
  if (!geo_ok(N, C, H, W) || nslab < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define WGD_ARGS x, w, mul, add, xpost, y, partial, sums, wpack, cycles, ops, N, C, H, W, pre, \
                 stats, flip, post, nslab, s
  switch (kern) {
    case CP96: return run_wgd<CP96>(WGD_ARGS);
    case CP48: return run_wgd<CP48>(WGD_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef WGD_ARGS
}

// Kernel D.  x [N,C,H,W] bf16; w [C,C,3,3] f32 (OIHW); mul, add [C] f32 (pre);
// y [N,C,H,W] bf16; partial [nslab][2][C] f32; sums [2][C] f32 (stats).
// kern = 96 takes D96, 48 D48 (wpack: bf16 scratch of the plan's size; the
// grid is nslab; ops, the x operand's addressing, int[11]: plane, row,
// tap[9] bytes, anything but this source's layout refused; cycles, null or
// [nslab][12] (D96) / [nslab][13] (D48) int64 stamps; a tensor map that
// fails to encode returns TMAP_ERR + its CUresult), 0 conv_fwd_kernel (the
// grid is nslab * D's C_out split); nslab <= tiles of the kernel taken.
extern "C" int branch_conv_fwd(const void* x, const void* w, const void* mul, const void* add,
                               void* y, void* partial, void* sums, void* wpack, void* cycles,
                               const int* ops, int N, int C, int H, int W, int pre, int stats,
                               int flip, int nslab, int kern, void* stream) {
  if (kern)
    return run_fwd_packed(kern, x, w, mul, add, nullptr, y, partial, stats ? sums : nullptr,
                          wpack, cycles, ops, N, C, H, W, pre, stats, flip, 0, nslab, stream);
  return run_fwd(x, w, mul, add, nullptr, y, partial, stats ? sums : nullptr, N, C, H, W, pre,
                 stats, flip, 0, nslab, stream);
}

// Kernel D's post mode: the dx conv of dY [N,C,H,W] bf16 with the flipped
// w [C,C,3,3] f32, its epilogue fused: x [N,C,H,W] bf16 and mul, add [C]
// f32 (raw) of the forward conv's input transform; dx [N,C,H,W] bf16;
// partial [nslab][2][C] f32; sums [2][C] f32 = (dmul, dadd).  wpack,
// cycles, ops and kern as in branch_conv_fwd.
extern "C" int branch_conv_dx_post(const void* dY, const void* w, const void* x,
                                   const void* mul, const void* add, void* dx, void* partial,
                                   void* sums, void* wpack, void* cycles, const int* ops, int N,
                                   int C, int H, int W, int nslab, int kern, void* stream) {
  if (kern)
    return run_fwd_packed(kern, dY, w, mul, add, x, dx, partial, sums, wpack, cycles, ops, N, C,
                          H, W, 0, 0, 1, 1, nslab, stream);
  return run_fwd(dY, w, mul, add, x, dx, partial, sums, N, C, H, W, 0, 0, 1, 1, nslab, stream);
}

// The weight pack alone from w [C,C,3,3] f32: C padding to 96 or 48, wpack
// [9][Cp / 8][Cp][8] bf16 (pack_wg_kernel).
extern "C" int branch_conv_pack(const void* w, void* wpack, int C, int flip, void* stream) {
  const int cp = (C + 15) / 16 * 16;
  if (C < 1 || (cp != CP96 && cp != CP48)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(cp == CP96 ? launch_pack_wg<CP96>(w, wpack, C, flip, s)
                          : launch_pack_wg<CP48>(w, wpack, C, flip, s));
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

// E96's host side: the tensor maps and the cluster launch.  The driver's
// cuTensorMapEncodeTiled is looked up through the runtime, so the library
// links nothing beyond the runtime.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                    cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

// A 4-D map over an activation [N,C,H,W] bf16 (W innermost), box
// {bw, bh, bc, 1}, zero fill outside it; 0 or TMAP_ERR + the CUresult.
static int encode_act(CUtensorMap* map, const void* p, const Geo& g, int bw, int bh, int bc) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return TMAP_ERR + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)g.W, (cuuint64_t)g.H, (cuuint64_t)g.C, (cuuint64_t)g.N};
  const cuuint64_t strides[3] = {(cuuint64_t)g.W * 2, (cuuint64_t)g.H * g.W * 2,
                                 (cuuint64_t)g.C * g.H * g.W * 2};
  const cuuint32_t box[4] = {(cuuint32_t)bw, (cuuint32_t)bh, (cuuint32_t)bc, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims,
                        strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : TMAP_ERR + (int)r;
}

// E48's map over an activation [N,C,H,W] bf16 with its dims ordered (W, C,
// H, N), box {64, 48, 4, 1} in the 128-byte swizzle: one box is a tile's
// four output rows as [row][C][64 px]; 0 or TMAP_ERR + the CUresult.
static int encode_rows(CUtensorMap* map, const void* p, const Geo& g) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return TMAP_ERR + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)g.W, (cuuint64_t)g.C, (cuuint64_t)g.H, (cuuint64_t)g.N};
  const cuuint64_t strides[3] = {(cuuint64_t)g.H * g.W * 2, (cuuint64_t)g.W * 2,
                                 (cuuint64_t)g.C * g.H * g.W * 2};
  const cuuint32_t box[4] = {WGD_TC, CP48, WGD_TR, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims,
                        strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : TMAP_ERR + (int)r;
}

static cudaLaunchConfig_t dw96_config(int nslab, cudaStream_t s, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL96 * nslab);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = DW96_SMEM;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = CL96;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

static int launch_dw96(const void* x, const void* dy, const void* y, const void* ds,
                       const void* mul, const void* add, void* dY, void* partial, void* cycles,
                       const Geo& g, int pre, int fuse, int nslab, cudaStream_t s) {
  CUtensorMap tmx, tmdy;
  int e = encode_act(&tmx, x, g, XRW, ETH + 2, 32);
  if (!e) e = encode_act(&tmdy, dy, g, TW, ETH, 32);
  if (e) return e;
  cudaError_t err = cudaFuncSetAttribute(conv_dw96_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, DW96_SMEM);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = dw96_config(nslab, s, &attr);
  err = cudaLaunchKernelEx(&cfg, conv_dw96_kernel, tmx, tmdy, (const bf16*)y, (const float*)ds,
                           (const float*)mul, (const float*)add, (bf16*)dY, (float*)partial,
                           (long long*)cycles, g, pre, fuse);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// E96's plan: out[0] = shared bytes, out[1] = CTAs per cluster, out[2] =
// clusters that fit on the card at once (the occupancy calculator's, for
// the grid), out[3] = ring stages, out[4] = tile rows, out[5] = tiles per
// image plane, out[6] = x box columns, out[7] = threads per CTA.
extern "C" int branch_conv_dw96_plan(int C, int H, int W, int* out) {
  const Geo g = make_dw_geo(1, C, H, W);
  if (C < 1 || g.Cp != CP96) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(conv_dw96_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, DW96_SMEM);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = dw96_config(1, 0, &attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)conv_dw96_kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  out[0] = DW96_SMEM;
  out[1] = CL96;
  out[2] = clusters;
  out[3] = NS96;
  out[4] = ETH;
  out[5] = g.ntiles;
  out[6] = XRW;
  out[7] = NT;
  return 0;
}

// E48's host side: x's maps (D48's box {72, 6, 48, 1} and the left halo's
// {8, 6, 48, 1}), dy's, y's and dY's (encode_rows, in the 128-byte swizzle
// the dY fragments are read through; without fuse y's and dY's maps are
// dy's, never used), the persistent CTAs (grid nslab <= tiles, one per SM).
static int launch_dw48(const void* x, const void* dy, const void* y, const void* ds,
                       const void* mul, const void* add, void* dY, void* partial, void* cycles,
                       const int* ops, const Geo& g, int pre, int fuse, int nslab,
                       cudaStream_t s) {
  WgdOps o;
  if (!wgd_ops_ok(ops, o)) return (int)cudaErrorInvalidValue;
  CUtensorMap tmx, tmxs, tmdy, tmy, tmdYo;
  int e = encode_act(&tmx, x, g, WGD_RAWC, WGD_XR, CP48);
  if (!e) e = encode_act(&tmxs, x, g, DW48_SIDEC, WGD_XR, CP48);
  if (!e) e = encode_rows(&tmdy, dy, g);
  if (!e) e = encode_rows(&tmy, fuse ? y : dy, g);
  if (!e) e = encode_rows(&tmdYo, fuse ? dY : dy, g);
  if (e) return e;
  cudaError_t err = cudaFuncSetAttribute(conv_dw48_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         DW48_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  conv_dw48_kernel<<<nslab, DW48_NT, DW48_SMEM_BYTES, s>>>(
      tmx, tmxs, tmdy, tmy, tmdYo, (const float*)ds, (const float*)mul, (const float*)add,
      (float*)partial, (long long*)cycles, g, o, pre, fuse);
  return (int)cudaGetLastError();
}

// E48's plan: out[0] = shared bytes, out[1] = raw x stages (a box and
// the left halo's side box each), out[2] = x
// operand buffers, out[3] = dy stages (dY composed in place), out[4] = y
// stages, out[5] = tile rows, out[6] = tile pixels per row, out[7] =
// warpgroups (one producer, two consumers), out[8] = CTAs per SM (the
// occupancy calculator's: 0 if the plan does not fit), out[9] = tiles per
// image plane (for the grid), out[10] = x box columns, out[11] = taps of
// consumer warpgroup 0 (warpgroup 1 takes the rest).
extern "C" int branch_conv_dw48_plan(int C, int H, int W, int* out) {
  const Geo g = make_wgd_geo(1, C, H, W);
  if (C < 1 || g.Cp != CP48) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(conv_dw48_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         DW48_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  int bps = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&bps, conv_dw48_kernel, DW48_NT,
                                                      DW48_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  out[0] = DW48_SMEM_BYTES;
  out[1] = 1;
  out[2] = 2;
  out[3] = 2;
  out[4] = 1;
  out[5] = WGD_TR;
  out[6] = WGD_TC;
  out[7] = DW48_NT / 128;
  out[8] = bps;
  out[9] = g.ntiles;
  out[10] = WGD_RAWC;
  out[11] = DW48_TAPS0;
  return 0;
}

// Kernel E.  x, dy [N,C,H,W] bf16; y [N,C,H,W] bf16 and ds [2][C] f32 (fuse);
// mul, add [C] f32 (pre); dY [N,C,H,W] bf16 (fuse); partial [nslab][Cp][9*Cp]
// f32; dk [C,C,3,3] f32 (OIHW).  The grid is nslab * (E's row split).
// async_copy = 1 stages through the cp.async ring, which needs W % 8 == 0
// and x, dy (y, dY with fuse) 16-byte aligned; 0 the synchronous fill.
// kern = 96 takes E96 (conv_dw96_kernel; partial [nslab][96][864], the grid
// nslab clusters of 3, cycles null or [3 * nslab][11] int64), which needs C
// padding to 96 and the ring's conditions; a cluster launch the card
// refuses returns its error, a tensor map that fails to encode TMAP_ERR +
// its CUresult.  kern = 48 takes E48 (conv_dw48_kernel; partial
// [nslab][48][432], the grid nslab <= its 4 x 64 tiles, cycles null or
// [nslab][15] int64; ops, the x operand's addressing as branch_conv_fwd's),
// which needs C padding to 48 and the ring's conditions; 0 conv_dw_kernel.
extern "C" int branch_conv_dw(const void* x, const void* dy, const void* y, const void* ds,
                              const void* mul, const void* add, void* dY, void* partial,
                              void* dk, void* cycles, const int* ops, int N, int C, int H, int W,
                              int pre, int fuse, int nslab, int async_copy, int kern,
                              void* stream) {
  if (!geo_ok(N, C, H, W) || nslab < 1) return (int)cudaErrorInvalidValue;
  const Geo g = make_dw_geo(N, C, H, W), g48 = make_wgd_geo(N, C, H, W);
  if (nslab > (kern == CP48 ? g48.ntiles : g.ntiles)) return (int)cudaErrorInvalidValue;
  if ((async_copy || kern) && (W % 8 != 0 || !aligned16(x) || !aligned16(dy) ||
                               (fuse && (!aligned16(y) || !aligned16(dY)))))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (kern == CP96) {
    if (g.Cp != CP96) return (int)cudaErrorInvalidValue;
    const int e = launch_dw96(x, dy, y, ds, mul, add, dY, partial, cycles, g, pre, fuse, nslab, s);
    if (e != 0) return e;
  } else if (kern == CP48) {
    if (g.Cp != CP48) return (int)cudaErrorInvalidValue;
    const int e = launch_dw48(x, dy, y, ds, mul, add, dY, partial, cycles, ops, g48, pre, fuse,
                              nslab, s);
    if (e != 0) return e;
  } else if (kern) {
    return (int)cudaErrorInvalidValue;
  } else {
    const int k16 = g.Cp / 16;
    const int grid = nslab * (k16 / dw_mt(k16));
    switch (k16) {
#define DW_CASE(K) \
      case K: err = launch_dw<K>(x, dy, y, ds, mul, add, dY, partial, g, pre, fuse, async_copy, grid, s); break;
      DW_CASE(1) DW_CASE(2) DW_CASE(3) DW_CASE(4) DW_CASE(5) DW_CASE(6) DW_CASE(7) DW_CASE(8)
#undef DW_CASE
      default: return (int)cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return (int)err;
  }
  const int total = C * 9 * g.Cp;
  reduce_dk_kernel<<<(total + 255) / 256, 256, 0, s>>>((const float*)partial, nslab, C, g.Cp,
                                                       (float*)dk);
  return (int)cudaGetLastError();
}
