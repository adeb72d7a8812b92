// ResNet stem kernels for Hopper (sm_90a): an odd-k stride-2 SAME conv with
// Cin = 3 and Co = 64, forward with fused BatchNorm statistics (kernel B) and
// the weight gradient with the statistics cotangent folded in (kernel C).
//
// Replaces semi_supervised_semantic_segmentation_tpu/ops/pallas_stem.py:
//   B: _stem_fwd -> _fwd_kernel  (public stem_conv_bn_s2)
//   C: _stem_dw  -> _dw_kernel   (VJP _stem_bwd_rule)
//
// Contract (same as the TPU kernels):
//   B: x NHWC [N,H,W,3] bf16, w HWIO [k,k,3,64] f32 (rounded to bf16 here)
//      -> y NCHW [N,64,H/2,W/2] bf16, sums [2,64] f32 = (sum y, sum y^2) of
//      the bf16-ROUNDED y over (N, H/2, W/2): the next BatchNorm's batch
//      statistics.  Padding is torch's (k-1)/2 on every side.
//   C: dY = bf16((dy + ds[0]) + (2*y)*ds[1]) composed in f32 with no FMA
//      contraction, then dW[k,k,3,64] = sum over the N*H/2*W/2 output
//      pixels of patch (x) dY in f32.  No x-gradient: the stem input is data.
//
// What bounds them: per [16,512,512,3] call the products are 19.7 GFLOP
// (~20 us on the tensor cores) against ~159 MB (B: x read, y written) and
// ~294 MB (C: x, dy and y read) of traffic, ~48 and ~88 us: both are bound
// by bytes, mostly the 64-channel activations at half resolution.
//
// Design.  Both kernels are implicit GEMMs on the tensor cores (mma.sync
// m16n8k16 bf16 -> f32) whose patch operand is read straight from staged
// input rows: there is no im2col buffer and no per-element index arithmetic.
//   Staging.  A tile is TR output rows x TW = 128 pixels (B: TR = 2, C: TR =
//   1).  A block stages the 2*TR + k - 2 input rows of the tile's window
//   once (NHWC, columns 2*ox0 - 8 .. 2*ox0 + 2*TW + 7, RS = 6*TW + 48 bf16
//   a row) with 16-byte cp.async copies into a 2-stage ring, so the next
//   tile's rows land while this one multiplies.  Copies outside the image
//   are zero-filled (by position, never by value: uninitialised shared
//   memory may hold Inf or NaN, and 0 * Inf = NaN).  Blocks are persistent
//   over tiles.  Shapes the 16-byte copies cannot take (W % 16 != 0, a
//   pointer not 16-byte aligned) take a synchronous element-wise fill and
//   scalar stores inside the same kernels; the wrapper decides
//   (ops/stem.py::stem_vec).
//   K layout (both kernels).  For output pixel j and kernel row kh, the 3k
//   (kw, c) taps in HWIO order are 3k consecutive bf16 of the staged row,
//   from element 6j + 3(8 - p) (p = (k-1)/2).  The kernels read them as a
//   window of KW = 8 * ceil((3k + s) / 8) slots that starts s = p % 2
//   elements early, at W0 + 6j with W0 = 24 - 3p - s even, so every pair of
//   slots (2t, 2t+1) is one aligned 32-bit shared load; the lanes of a
//   fragment read words 3g + t (B) or 6t + const (C): no bank conflicts.
//   At k = 7, KW = 24 and 147 of the 168 slots are real taps.
//   B: M = the 64 output channels, N = pixels, K = the k*KW slots.  The
//     weights are packed once per block into shared memory as [64][k*KW]
//     bf16 with the pad slots exactly 0, and A fragments come by ldmatrix;
//     every fragment of a k-step is loaded before its products.  A k16 step
//     covers 16 slots of one row; the 8-wide window tails of rows 2i and
//     2i+1 share one (B's b1 and the A matrices of lanes 16-31 come from the
//     second row), so k = 7 takes 10 k16 steps and one k8 step, not 7 + 7.
//     A warp owns 32 pixels x 64 channels.  The epilogue rounds y to bf16,
//     sums the rounded values (masked to valid pixels) over the 4 lanes of a
//     channel by shuffles into per-warp statistics in shared memory (not
//     registers: the product loop needs them), stages the [64][TR*TW] tile
//     in shared memory and writes NCHW rows with 16-byte stores.  Per-block
//     statistics partials are reduced by a second kernel in a fixed order
//     (deterministic, no atomics).  Two blocks per SM.
//   C: M = the 64 output channels, N = the k*KW slots, K = the tile's
//     pixels.  dy and y tiles arrive by cp.async beside x; dY is composed
//     shared -> shared in place (zero past W/2 and H/2) and its A fragments
//     (channels x pixels, NCHW as it arrives) come by ldmatrix.  A B
//     fragment needs two consecutive pixels of one slot, 6 elements apart,
//     so n8 tiles go in pairs over the two slots of a slot pair: the 32-bit
//     loads of a slot pair at two pixels give, after two byte permutes, the
//     fragments of both tiles (four loads per pair of tiles and k-step, not
//     eight 16-bit ones).  A warp owns 32 channels x a quarter of the slot
//     pairs; the f32 sum stays in registers over every tile the block
//     visits.  Each block writes one [3k^2][64] partial in HWIO order (pad
//     slots dropped), summed by the second kernel in a fixed order.  One
//     output row per tile keeps the 2-stage ring small enough for two
//     blocks per SM, so one block's products overlap the other's copies and
//     composition.
// What still holds them above the bound: the products are mma.sync, not
// wgmma; a block's phases (copy wait, compose, products, epilogue) follow
// one another between barriers, overlapped only by the SM's second block.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define NT 256                 // threads per block (8 warps)
#define CO 64                  // output channels
#define TW 128                 // output pixels per tile row
#define RS (6 * TW + 48)       // staged input row, bf16: 2*TW + 16 columns x 3
// Output rows per tile: B 2 (8 warps of 32 pixels), C 1 (so that two
// blocks, each with a 2-stage ring, fit on an SM).
#define TRB 2
#define TRC 1

typedef __nv_bfloat16 bf16;

struct Geo {
  int N, H, W, H2, W2, nty, ntx, ntiles, vec;
};

static Geo make_geo(int N, int H, int W, int vec, int tr) {
  Geo g;
  g.N = N; g.H = H; g.W = W; g.H2 = H / 2; g.W2 = W / 2;
  g.nty = (g.H2 + tr - 1) / tr;
  g.ntx = (g.W2 + TW - 1) / TW;
  g.ntiles = N * g.nty * g.ntx;
  g.vec = vec;
  return g;
}

// The window geometry of kernel size k (see the header).
__host__ __device__ constexpr int pad_of(int k) { return (k - 1) / 2; }
__host__ __device__ constexpr int shift_of(int k) { return pad_of(k) % 2; }
__host__ __device__ constexpr int kw_of(int k) { return 8 * ((3 * k + shift_of(k) + 7) / 8); }
__host__ __device__ constexpr int w0_of(int k) { return 24 - 3 * pad_of(k) - shift_of(k); }
// packed weight row stride: an odd number of 16-byte units (ldmatrix rows
// on distinct banks)
__host__ __device__ constexpr int wst_of(int k) {
  return (k * kw_of(k) / 8) % 2 == 0 ? k * kw_of(k) + 8 : k * kw_of(k);
}
__host__ __device__ constexpr int xrows_of(int k, int tr) { return 2 * tr + k - 2; }
// y / dy tile row stride, bf16: an odd number of 16-byte units
__host__ __device__ constexpr int yst_of(int tr) { return tr * TW + 8; }
// C: pairs of n8 tiles per warp (the k*KW/2 slot pairs pad to 4 warps x NP x 8)
__host__ __device__ constexpr int np_of(int k) { return (k * kw_of(k) / 2 + 31) / 32; }

__host__ __device__ constexpr int fwd_smem(int k) {
  return CO * wst_of(k) * 2 + 2 * xrows_of(k, TRB) * RS * 2 + CO * yst_of(TRB) * 2 +
         8 * 2 * CO * 4;
}
__host__ __device__ constexpr int dw_stage_bytes(int k) {
  return xrows_of(k, TRC) * RS * 2 + 2 * CO * yst_of(TRC) * 2;
}
__host__ __device__ constexpr int dw_smem(int k) { return 2 * dw_stage_bytes(k) + 2 * CO * 4; }

template <int TR>
__device__ __forceinline__ void tile_coords(const Geo& g, int tile, int& n, int& oy0, int& ox0) {
  const int tx = tile % g.ntx;
  const int r = tile / g.ntx;
  oy0 = (r % g.nty) * TR;
  n = r / g.nty;
  ox0 = tx * TW;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}

__device__ __forceinline__ void mma16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma8(float* d, const uint32_t* a, uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
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

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}

// dY = bf16((dy + ds0) + (2*y)*ds1) for the two bf16 of a 32-bit word, with
// no contraction into an FMA: the plain version's roundings.
__device__ __forceinline__ uint32_t fold2(uint32_t d, uint32_t yv, float s0, float s1) {
  return pack_bf16(__fadd_rn(__fadd_rn(__uint_as_float(d << 16), s0),
                             __fmul_rn(__fmul_rn(2.f, __uint_as_float(yv << 16)), s1)),
                   __fadd_rn(__fadd_rn(__uint_as_float(d & 0xffff0000u), s0),
                             __fmul_rn(__fmul_rn(2.f, __uint_as_float(yv & 0xffff0000u)), s1)));
}

__device__ __forceinline__ float fold1(float d, float yv, float s0, float s1) {
  return __bfloat162float(__float2bfloat16(
      __fadd_rn(__fadd_rn(d, s0), __fmul_rn(__fmul_rn(2.f, yv), s1))));
}

// Stage the TR-row tile's input rows: xs[q][e] = element e of input
// row 2*oy0 - p + q from column 2*ox0 - 8 on (NHWC, so column c' channel ch
// is e = 3 * (c' - 2*ox0 + 8) + ch), 0 outside the image.  vec: 16-byte
// cp.async copies (W % 8 == 0, x 16-byte aligned; the image edges then fall
// on 24-element = 3-chunk boundaries, so a chunk is all inside or all
// outside); else synchronous 2-byte loads.
template <int K, int TR>
__device__ __forceinline__ void stage_x(bf16* xs, const bf16* __restrict__ x, const Geo& g,
                                        int n, int oy0, int ox0) {
  constexpr int XR = xrows_of(K, TR), P = pad_of(K);
  const int iy0 = 2 * oy0 - P;
  const int e0 = 3 * (2 * ox0 - 8);  // element of the row at xs[q][0]
  const int rowlen = 3 * g.W;
  if (g.vec) {
    const uint32_t base = smem_addr(xs);
    for (int e = threadIdx.x; e < XR * (RS / 8); e += NT) {
      const int q = e / (RS / 8), ch = e - q * (RS / 8);
      const int iy = iy0 + q, ge = e0 + 8 * ch;
      const bool ok = iy >= 0 && iy < g.H && ge >= 0 && ge + 8 <= rowlen;
      const bf16* src = x + ((size_t)n * g.H + iy) * rowlen + ge;
      cp_async16(base + (q * RS + 8 * ch) * 2, ok ? src : x, ok);
    }
  } else {
    for (int e = threadIdx.x; e < XR * RS; e += NT) {
      const int q = e / RS, el = e - q * RS;
      const int iy = iy0 + q, ge = e0 + el;
      const bool ok = iy >= 0 && iy < g.H && ge >= 0 && ge < rowlen;
      xs[e] = ok ? x[((size_t)n * g.H + iy) * rowlen + ge] : __float2bfloat16(0.f);
    }
  }
}

// Stage a [64][TR*TW] NCHW tile of an output-shaped tensor (dy or y) into
// t[co][r*TW + j] (row stride YST), 0 outside the output.
template <int TR>
__device__ __forceinline__ void stage_out(bf16* t, const bf16* __restrict__ src, const Geo& g,
                                          int n, int oy0, int ox0) {
  constexpr int YST = yst_of(TR);
  if (g.vec) {
    const uint32_t base = smem_addr(t);
    for (int e = threadIdx.x; e < CO * TR * (TW / 8); e += NT) {
      const int q = e % (TW / 8), rr = (e / (TW / 8)) % TR, co = e / (TR * (TW / 8));
      const int oy = oy0 + rr, ox = ox0 + 8 * q;
      const bool ok = oy < g.H2 && ox < g.W2;
      const bf16* p = src + (((size_t)n * CO + co) * g.H2 + oy) * g.W2 + ox;
      cp_async16(base + (co * YST + rr * TW + 8 * q) * 2, ok ? p : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < CO * TR * TW; e += NT) {
      const int j = e % TW, rr = (e / TW) % TR, co = e / (TR * TW);
      const int oy = oy0 + rr, ox = ox0 + j;
      const bool ok = oy < g.H2 && ox < g.W2;
      t[co * YST + rr * TW + j] =
          ok ? src[(((size_t)n * CO + co) * g.H2 + oy) * g.W2 + ox] : __float2bfloat16(0.f);
    }
  }
}

// ---------------------------------------------------------------------------
// B: forward conv + BatchNorm statistics
// ---------------------------------------------------------------------------

template <int K>
__global__ void __launch_bounds__(NT, 2)
stem_fwd_kernel(const bf16* __restrict__ x, const float* __restrict__ w, bf16* __restrict__ y,
                float* __restrict__ partial, Geo g) {
  constexpr int KW = kw_of(K), S = shift_of(K), KK = K * KW, WST = wst_of(K);
  constexpr int TR = TRB, XR = xrows_of(K, TR), W0 = w0_of(K), YST = yst_of(TR);
  static_assert(TR * TW == 8 * 32, "B: a warp owns 32 pixels of the tile");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* wsm = reinterpret_cast<bf16*>(smem);  // [CO][WST] packed bf16 weights
  bf16* xst = wsm + CO * WST;                 // [2][XR][RS] input-row ring
  bf16* ysm = xst + 2 * XR * RS;              // [CO][YST] rounded y of the tile
  float* red = reinterpret_cast<float*>(ysm + CO * YST);  // [8][2][CO] per-warp statistics
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;

  // wsm[co][kh*KW + pos] = bf16(w[kh][kw][c][co]) at pos = S + 3*kw + c, 0
  // at every other position (and in the stride's padding).
  for (int e = tid; e < CO * WST; e += NT) {
    const int co = e % CO, m = e / CO;
    float v = 0.f;
    if (m < KK) {
      const int kh = m / KW, q = m - kh * KW - S;
      if (q >= 0 && q < 3 * K) v = w[(kh * 3 * K + q) * CO + co];
    }
    wsm[co * WST + m] = __float2bfloat16(v);
  }

  const int r = warp >> 2, jw = (warp & 3) * 32;  // the warp's output row and pixels
  // ldmatrix row address of this lane (rows co, 8 columns of K)
  const uint32_t wa =
      smem_addr(wsm + ((lane & 7) + ((lane >> 3) & 1) * 8) * WST + (lane >> 4) * 8);
  for (int e = tid; e < 8 * 2 * CO; e += NT) red[e] = 0.f;

  int tile = blockIdx.x;
  if (tile < g.ntiles) {
    int n, oy0, ox0;
    tile_coords<TR>(g, tile, n, oy0, ox0);
    stage_x<K, TR>(xst, x, g, n, oy0, ox0);
  }
  cp_async_commit();
  for (int it = 0; tile < g.ntiles; tile += gridDim.x, ++it) {
    const int nxt = tile + gridDim.x;
    if (nxt < g.ntiles) {
      int n, oy0, ox0;
      tile_coords<TR>(g, nxt, n, oy0, ox0);
      stage_x<K, TR>(xst + ((it + 1) & 1) * XR * RS, x, g, n, oy0, ox0);
    }
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();  // this tile's rows (and the packed weights) visible

    float acc[4][4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
    // the lane's B pairs: pixel jw + 8*nt + gq, window positions 2*tq (+8)
    const bf16* xb = xst + (it & 1) * XR * RS + 2 * r * RS + 6 * (jw + gq) + W0 + 2 * tq;
#pragma unroll
    for (int kh = 0; kh < K; ++kh) {
      const bf16* xr = xb + kh * RS;
#pragma unroll
      for (int ks = 0; ks < KW / 16; ++ks) {
        uint32_t b[4][2], a[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          b[nt][0] = *reinterpret_cast<const uint32_t*>(xr + 48 * nt + 16 * ks);
          b[nt][1] = *reinterpret_cast<const uint32_t*>(xr + 48 * nt + 16 * ks + 8);
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) ldsm_x4(a[mt], wa + (mt * 16 * WST + kh * KW + 16 * ks) * 2);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma16(acc[mt][nt], a[mt], b[nt]);
      }
      if ((KW % 16) && (K & 1) && kh == K - 1) {  // the last row's tail alone: one k8 step
        constexpr int pos = KW - 8;
        uint32_t b[4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) b[nt] = *reinterpret_cast<const uint32_t*>(xr + 48 * nt + pos);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          uint32_t a[2];
          ldsm_x2(a, wa + (mt * 16 * WST + kh * KW + pos) * 2);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma8(acc[mt][nt], a, b[nt]);
        }
      }
    }

    if (KW % 16) {
      // The 8-wide window tails of rows 2kp and 2kp+1 as one k16 step: b1
      // and the A matrices of lanes 16-31 come from the second row.
      constexpr int pos = KW - 8;
      const uint32_t wt = wa + (lane >> 4) * (KW - 8) * 2;
#pragma unroll
      for (int kp = 0; kp < K / 2; ++kp) {
        uint32_t b[4][2], a[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          b[nt][0] = *reinterpret_cast<const uint32_t*>(xb + 2 * kp * RS + 48 * nt + pos);
          b[nt][1] = *reinterpret_cast<const uint32_t*>(xb + (2 * kp + 1) * RS + 48 * nt + pos);
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) ldsm_x4(a[mt], wt + (mt * 16 * WST + 2 * kp * KW + pos) * 2);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma16(acc[mt][nt], a[mt], b[nt]);
      }
    }

    int n, oy0, ox0;
    tile_coords<TR>(g, tile, n, oy0, ox0);
    const bool rok = oy0 + r < g.H2;
    float s1[8], s2[8];  // the tile's statistics of channels mt*16 + gq + 8*h at [mt*2 + h]
#pragma unroll
    for (int i = 0; i < 8; ++i) s1[i] = s2[i] = 0.f;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int j = jw + 8 * nt + 2 * tq;
      const bool ok0 = rok && ox0 + j < g.W2, ok1 = rok && ox0 + j + 1 < g.W2;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t v = pack_bf16(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
          const float f0 = __uint_as_float(v << 16), f1 = __uint_as_float(v & 0xffff0000u);
          if (ok0) { s1[mt * 2 + h] += f0; s2[mt * 2 + h] += f0 * f0; }
          if (ok1) { s1[mt * 2 + h] += f1; s2[mt * 2 + h] += f1 * f1; }
          *reinterpret_cast<uint32_t*>(&ysm[(mt * 16 + gq + 8 * h) * YST + r * TW + j]) = v;
        }
    }
    // the 4 lanes of a channel by shuffles, then into the warp's row of red
    // (one writer per entry, tiles in order: deterministic)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s1[i] += __shfl_xor_sync(0xffffffffu, s1[i], 1);
      s1[i] += __shfl_xor_sync(0xffffffffu, s1[i], 2);
      s2[i] += __shfl_xor_sync(0xffffffffu, s2[i], 1);
      s2[i] += __shfl_xor_sync(0xffffffffu, s2[i], 2);
    }
    if (tq == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int co = (i >> 1) * 16 + gq + 8 * (i & 1);
        red[(warp * 2 + 0) * CO + co] += s1[i];
        red[(warp * 2 + 1) * CO + co] += s2[i];
      }
    }
    __syncthreads();  // the tile's y staged
    if (g.vec) {
      for (int e = tid; e < CO * TR * (TW / 8); e += NT) {
        const int q = e % (TW / 8), rr = (e / (TW / 8)) % TR, co = e / (TR * (TW / 8));
        const int oy = oy0 + rr, ox = ox0 + 8 * q;
        if (oy < g.H2 && ox < g.W2)
          *reinterpret_cast<uint4*>(&y[(((size_t)n * CO + co) * g.H2 + oy) * g.W2 + ox]) =
              *reinterpret_cast<const uint4*>(&ysm[co * YST + rr * TW + 8 * q]);
      }
    } else {
      for (int e = tid; e < CO * TR * TW; e += NT) {
        const int j = e % TW, rr = (e / TW) % TR, co = e / (TR * TW);
        const int oy = oy0 + rr, ox = ox0 + j;
        if (oy < g.H2 && ox < g.W2)
          y[(((size_t)n * CO + co) * g.H2 + oy) * g.W2 + ox] = ysm[co * YST + rr * TW + j];
      }
    }
    __syncthreads();  // y staging read and the ring stage consumed
  }
  cp_async_wait0();  // the last (empty) group: nothing is left in flight

  // Block partial of the statistics: the 8 warps in order (deterministic).
  __syncthreads();
  if (tid < 2 * CO) {
    const int which = tid / CO, co = tid % CO;
    float s = 0.f;
    for (int wi = 0; wi < 8; ++wi) s += red[(wi * 2 + which) * CO + co];
    partial[(size_t)blockIdx.x * 2 * CO + tid] = s;
  }
}

// ---------------------------------------------------------------------------
// C: weight gradient with the statistics cotangent folded in
// ---------------------------------------------------------------------------

template <int K>
__global__ void __launch_bounds__(NT, 2)
stem_dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
               const bf16* __restrict__ y, const float* __restrict__ ds,
               float* __restrict__ partial, Geo g) {
  constexpr int TR = TRC, XR = xrows_of(K, TR), KT = 3 * K * K;
  constexpr int KW = kw_of(K), S = shift_of(K), W0 = w0_of(K);
  constexpr int NP = np_of(K), NJ = 2 * NP;
  constexpr int YST = yst_of(TR);
  constexpr int STAGE = dw_stage_bytes(K) / 2;  // bf16 per ring stage
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);  // 2 x {x [XR][RS], dY [CO][YST], y [CO][YST]}
  float* dss = reinterpret_cast<float*>(ring + 2 * STAGE);  // [2][CO]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  for (int e = tid; e < 2 * CO; e += NT) dss[e] = ds[e];

  const int mh = warp & 1, nq = warp >> 1;  // channels 32*mh.., slot pairs of n8-tile pairs nq*NP..
  // N is B's window layout: slot m = kh*KW + pos, element W0 + pos of input
  // row kh from 6j.  n8 tiles 2q and 2q+1 hold the two slots of slot pairs
  // (nq*NP + q)*8 + column: the lane's 32-bit load at its pair (2 slots of
  // one pixel) feeds both tiles.  Pad slots, and pairs past k*KW, read a
  // real element; their sums are dropped at the end.
  int off[NP];
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    const int m = 2 * ((nq * NP + q) * 8 + gq);  // window slot of the pair's first
    int o = 0;
    if (m < K * KW) o = (m / KW) * RS + W0 + m % KW;
    off[q] = o + 12 * tq;
  }
  const int arow = 32 * mh + (lane & 7) + ((lane >> 3) & 1) * 8, acol = (lane >> 4) * 8;

  float acc[2][NJ][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < NJ; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][i][c] = 0.f;

  int tile = blockIdx.x;
  if (tile < g.ntiles) {
    int n, oy0, ox0;
    tile_coords<TR>(g, tile, n, oy0, ox0);
    stage_x<K, TR>(ring, x, g, n, oy0, ox0);
    stage_out<TR>(ring + XR * RS, dy, g, n, oy0, ox0);
    stage_out<TR>(ring + XR * RS + CO * YST, y, g, n, oy0, ox0);
  }
  cp_async_commit();
  for (int it = 0; tile < g.ntiles; tile += gridDim.x, ++it) {
    const int nxt = tile + gridDim.x;
    if (nxt < g.ntiles) {
      int n, oy0, ox0;
      tile_coords<TR>(g, nxt, n, oy0, ox0);
      bf16* st = ring + ((it + 1) & 1) * STAGE;
      stage_x<K, TR>(st, x, g, n, oy0, ox0);
      stage_out<TR>(st + XR * RS, dy, g, n, oy0, ox0);
      stage_out<TR>(st + XR * RS + CO * YST, y, g, n, oy0, ox0);
    }
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();  // this tile's x, dy and y visible (and ds)

    bf16* xs = ring + (it & 1) * STAGE;
    bf16* dys = xs + XR * RS;
    const bf16* ys = dys + CO * YST;
    int n, oy0, ox0;
    tile_coords<TR>(g, tile, n, oy0, ox0);
    // dY in place of dy, 0 outside the output (by position: ds0 != 0)
    for (int e = tid; e < CO * TR * (TW / 8); e += NT) {
      const int q = e % (TW / 8), rr = (e / (TW / 8)) % TR, co = e / (TR * (TW / 8));
      const int idx = co * YST + rr * TW + 8 * q;
      const int oy = oy0 + rr, ox = ox0 + 8 * q;
      const float d0 = dss[co], d1 = dss[CO + co];
      uint4 dv = *reinterpret_cast<const uint4*>(&dys[idx]);
      if (oy < g.H2 && ox + 8 <= g.W2) {
        const uint4 yv = *reinterpret_cast<const uint4*>(&ys[idx]);
        dv.x = fold2(dv.x, yv.x, d0, d1);
        dv.y = fold2(dv.y, yv.y, d0, d1);
        dv.z = fold2(dv.z, yv.z, d0, d1);
        dv.w = fold2(dv.w, yv.w, d0, d1);
      } else {
        __align__(16) bf16 v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const bool ok = oy < g.H2 && ox + i < g.W2;
          v[i] = __float2bfloat16(ok ? fold1(__bfloat162float(dys[idx + i]),
                                             __bfloat162float(ys[idx + i]), d0, d1) : 0.f);
        }
        dv = *reinterpret_cast<const uint4*>(v);
      }
      *reinterpret_cast<uint4*>(&dys[idx]) = dv;
    }
    __syncthreads();  // dY composed

    const uint32_t abase = smem_addr(dys + arow * YST + acol);
#pragma unroll 2
    for (int s = 0; s < TR * TW / 16; ++s) {
      const int rr = s / (TW / 16), j0 = (s % (TW / 16)) * 16;
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) ldsm_x4(a[mt], abase + (mt * 16 * YST + rr * TW + j0) * 2);
      const bf16* xb = xs + 2 * rr * RS + 6 * j0;
#pragma unroll
      for (int q = 0; q < NP; ++q) {
        const bf16* p = xb + off[q];
        const uint32_t u0 = *reinterpret_cast<const uint32_t*>(p);
        const uint32_t u1 = *reinterpret_cast<const uint32_t*>(p + 6);
        const uint32_t u2 = *reinterpret_cast<const uint32_t*>(p + 48);
        const uint32_t u3 = *reinterpret_cast<const uint32_t*>(p + 54);
        uint32_t b[2];
        b[0] = __byte_perm(u0, u1, 0x5410);
        b[1] = __byte_perm(u2, u3, 0x5410);
        mma16(acc[0][2 * q], a[0], b);
        mma16(acc[1][2 * q], a[1], b);
        b[0] = __byte_perm(u0, u1, 0x7632);
        b[1] = __byte_perm(u2, u3, 0x7632);
        mma16(acc[0][2 * q + 1], a[0], b);
        mma16(acc[1][2 * q + 1], a[1], b);
      }
    }
    __syncthreads();  // the ring stage consumed before it is refilled
  }
  cp_async_wait0();

  // partial[blk][kk][co] in HWIO order kk = kh*3k + 3*kw + c: d0/d1 = (channel
  // gq, columns 2tq, 2tq+1), d2/d3 = channel gq + 8; pad slots are dropped.
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < NJ; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int co = 32 * mh + 16 * mt + gq + 8 * h;
        float* dst = partial + (size_t)blockIdx.x * KT * CO + co;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = 2 * ((nq * NP + i / 2) * 8 + 2 * tq + e) + (i & 1);  // window slot
          const int kh = m / KW, qq = m % KW - S;
          if (m < K * KW && qq >= 0 && qq < 3 * K)
            dst[(size_t)(kh * 3 * K + qq) * CO] = acc[mt][i][2 * h + e];
        }
      }
}

// out[col] = sum_i part[i][col] over 32 columns per block: warp w sums the
// parts i = w, w + 8, ... in order, then the 8 warp sums add in a fixed
// tree (deterministic).  Launch with 256 threads.
__global__ void reduce_partials_kernel(const float* __restrict__ part, int nparts, int width,
                                       float* __restrict__ out) {
  __shared__ float sums[8][32];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (col < width)
    for (int i = w; i < nparts; i += 8) s += part[(size_t)i * width + col];
  sums[w][lane] = s;
  __syncthreads();
  if (w == 0 && col < width)
    out[col] = ((sums[0][lane] + sums[1][lane]) + (sums[2][lane] + sums[3][lane])) +
               ((sums[4][lane] + sums[5][lane]) + (sums[6][lane] + sums[7][lane]));
}

// ---------------------------------------------------------------------------
// C entry points
// ---------------------------------------------------------------------------

static bool geo_ok(int N, int H, int W, int k) {
  return N > 0 && H > 0 && W > 0 && H % 2 == 0 && W % 2 == 0 && k % 2 == 1 && k >= 1 && k <= 11;
}

// vec needs W % 16 == 0 (16-byte x chunks and y rows) and 16-byte aligned tensors.
static bool vec_ok(int W, const void* const* ptrs, int nptrs) {
  if (W % 16) return false;
  for (int i = 0; i < nptrs; ++i)
    if ((uintptr_t)ptrs[i] % 16) return false;
  return true;
}

template <int K>
static cudaError_t launch_fwd(const void* x, const void* w, void* y, void* partial, const Geo& g,
                              int grid, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(stem_fwd_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, fwd_smem(K));
  if (err != cudaSuccess) return err;
  stem_fwd_kernel<K><<<grid, NT, fwd_smem(K), s>>>((const bf16*)x, (const float*)w, (bf16*)y,
                                                   (float*)partial, g);
  return cudaGetLastError();
}

template <int K>
static cudaError_t launch_dw(const void* x, const void* dy, const void* y, const void* ds,
                             void* partial, const Geo& g, int grid, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(stem_dw_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, dw_smem(K));
  if (err != cudaSuccess) return err;
  stem_dw_kernel<K><<<grid, NT, dw_smem(K), s>>>((const bf16*)x, (const bf16*)dy, (const bf16*)y,
                                                 (const float*)ds, (float*)partial, g);
  return cudaGetLastError();
}

#define STEM_K_SWITCH(k, CALL)                 \
  switch (k) {                                 \
    case 1: { constexpr int KS = 1; CALL; } break;  \
    case 3: { constexpr int KS = 3; CALL; } break;  \
    case 5: { constexpr int KS = 5; CALL; } break;  \
    case 7: { constexpr int KS = 7; CALL; } break;  \
    case 9: { constexpr int KS = 9; CALL; } break;  \
    case 11: { constexpr int KS = 11; CALL; } break; \
    default: return (int)cudaErrorInvalidValue; \
  }

// The plan of kernel size k: out = {threads, tile pixels per row, ring
// stages, B's tile rows, shared bytes, blocks per SM and K width (k * KW),
// C's tile rows, shared bytes, blocks per SM and padded taps}.  The
// blocks per SM come from the occupancy calculator (registers included).
extern "C" int stem_plan(int k, int* out) {
  if (!geo_ok(2, 2, 2, k)) return (int)cudaErrorInvalidValue;
  int fb = 0, db = 0;
  cudaError_t err = cudaSuccess;
  STEM_K_SWITCH(k, {
    err = cudaFuncSetAttribute(stem_fwd_kernel<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               fwd_smem(KS));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fb, stem_fwd_kernel<KS>, NT, fwd_smem(KS));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(stem_dw_kernel<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 dw_smem(KS));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&db, stem_dw_kernel<KS>, NT, dw_smem(KS));
  });
  if (err != cudaSuccess) return (int)err;
  const int vals[11] = {NT, TW, 2, TRB, fwd_smem(k), fb, k * kw_of(k), TRC, dw_smem(k), db,
                        64 * np_of(k)};
  for (int i = 0; i < 11; ++i) out[i] = vals[i];
  return 0;
}

// Kernel B.  partial: [grid][2][64] f32 scratch.  Returns a cudaError_t.
extern "C" int stem_fwd(const void* x, const void* w, void* y, void* partial, void* sums,
                        int N, int H, int W, int k, int grid, int vec, void* stream) {
  const void* ptrs[2] = {x, y};
  if (!geo_ok(N, H, W, k) || grid < 1 || (vec && !vec_ok(W, ptrs, 2)))
    return (int)cudaErrorInvalidValue;
  const Geo g = make_geo(N, H, W, vec, TRB);
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  STEM_K_SWITCH(k, err = launch_fwd<KS>(x, w, y, partial, g, grid, s));
  if (err != cudaSuccess) return (int)err;
  reduce_partials_kernel<<<(2 * CO + 31) / 32, 256, 0, s>>>((const float*)partial, grid, 2 * CO,
                                                          (float*)sums);
  return (int)cudaGetLastError();
}

// Kernel C.  ds: [2][64] f32; partial: [grid][3k^2][64] f32 scratch;
// dw: [3k^2][64] f32 (HWIO flattening).  Returns a cudaError_t.
extern "C" int stem_dw(const void* x, const void* dy, const void* y, const void* ds,
                       void* partial, void* dw, int N, int H, int W, int k, int grid, int vec,
                       void* stream) {
  const void* ptrs[3] = {x, dy, y};
  if (!geo_ok(N, H, W, k) || grid < 1 || (vec && !vec_ok(W, ptrs, 3)))
    return (int)cudaErrorInvalidValue;
  const Geo g = make_geo(N, H, W, vec, TRC);
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  STEM_K_SWITCH(k, err = launch_dw<KS>(x, dy, y, ds, partial, g, grid, s));
  if (err != cudaSuccess) return (int)err;
  const int width = 3 * k * k * CO;
  reduce_partials_kernel<<<(width + 31) / 32, 256, 0, s>>>((const float*)partial, grid, width,
                                                           (float*)dw);
  return (int)cudaGetLastError();
}
