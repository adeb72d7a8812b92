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
//   C: dY = bf16(dy + ds[0] + 2*y*ds[1]) composed in f32, then
//      dW[k,k,3,64] = sum over the N*H/2*W/2 output pixels of patch (x) dY
//      in f32.  No x-gradient: the stem input is data.
//
// Design.  Both are implicit-GEMM direct convolutions over tiles of 64
// consecutive output pixels of one output row: the block builds the
// im2col patch [K = 3k^2][64] of the tile in shared memory (f32, zero where
// the window leaves the image), so the strided, 3-channel input is read
// once per tile from L1/L2 and every multiply reads shared memory.
//   B keeps the bf16-rounded weights [K][64] in shared memory for the life
//     of the block; each thread owns 4 pixels x 4 channels in registers and
//     runs K rank-1 updates.  The tile is staged in shared memory and
//     written as coalesced NCHW rows.  The stats are per-block partials of
//     the rounded y, reduced by a second small kernel in a fixed order
//     (deterministic, no atomics).
//   C owns 4 channels x ceil(K/16) taps per thread in registers and
//     accumulates over every pixel of every tile its block visits; each
//     block writes one [K][64] partial and the second kernel sums them.
//   Blocks are persistent (grid = a few per SM, grid-striding over tiles),
//   so the weights are loaded and the partials written once per block.
// What bounds it: the work is 2*K*64 FLOP per output pixel (19.7 GFLOP for
// N=16 at 512^2) against ~159 MB (B) / ~294 MB (C) of traffic, so on the
// card's tensor cores it would be memory-bound (~48 / ~88 us).  This first
// version runs the products as f32 FMAs on the CUDA cores, which bounds it
// at the FMA rate instead; moving the inner product to wgmma/mma on bf16
// tiles is the next step for speed.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define TP 64          // output pixels per tile
#define NT 256         // threads per block
#define CO 64          // output channels
#define PSTR (TP + 1)  // padded row stride of the patch / dY tiles

struct Geo {
  int N, H, W, H2, W2, k, pad, K, ntx, ntiles;
};

static Geo make_geo(int N, int H, int W, int k) {
  Geo g;
  g.N = N; g.H = H; g.W = W; g.H2 = H / 2; g.W2 = W / 2;
  g.k = k; g.pad = (k - 1) / 2; g.K = 3 * k * k;
  g.ntx = (g.W2 + TP - 1) / TP;
  g.ntiles = N * g.H2 * g.ntx;
  return g;
}

__device__ __forceinline__ void tile_coords(const Geo& g, int tile, int& n, int& oy, int& ox0) {
  const int tx = tile % g.ntx;
  const int r = tile / g.ntx;
  oy = r % g.H2;
  n = r / g.H2;
  ox0 = tx * TP;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// patch[kk][p] = x[n][2*oy - pad + kh][2*(ox0+p) - pad + kw][c] for
// kk = (kh*k + kw)*3 + c (the HWIO flattening), zero outside the image and
// for pixels past the right edge of the output row.
__device__ void fill_patch(float* patch, const __nv_bfloat16* __restrict__ x,
                           const Geo& g, int n, int oy, int ox0) {
  const int k3 = 3 * g.k;
  for (int e = threadIdx.x; e < g.K * TP; e += NT) {
    const int kk = e / TP, p = e - (e / TP) * TP;
    const int kh = kk / k3, rem = kk - kh * k3;
    const int kw = rem / 3, c = rem - kw * 3;
    const int iy = 2 * oy - g.pad + kh;
    const int ix = 2 * (ox0 + p) - g.pad + kw;
    float v = 0.f;
    if (ox0 + p < g.W2 && iy >= 0 && iy < g.H && ix >= 0 && ix < g.W)
      v = __bfloat162float(x[(((size_t)n * g.H + iy) * g.W + ix) * 3 + c]);
    patch[kk * PSTR + p] = v;
  }
}

__global__ void __launch_bounds__(NT)
stem_fwd_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
                __nv_bfloat16* __restrict__ y, float* __restrict__ partial, Geo g) {
  extern __shared__ float smem[];
  float* wsm = smem;                  // [K][CO]  bf16-rounded weights
  float* patch = wsm + g.K * CO;      // [K][PSTR]
  float* osm = patch + g.K * PSTR;    // [CO][TP] rounded outputs of the tile
  const int t = threadIdx.x;
  for (int e = t; e < g.K * CO; e += NT) wsm[e] = bf16_round(w[e]);

  const int cq = t % 16;  // channels 4*cq .. 4*cq+3
  const int pg = t / 16;  // pixels   4*pg .. 4*pg+3
  float s1[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};

  for (int tile = blockIdx.x; tile < g.ntiles; tile += gridDim.x) {
    int n, oy, ox0;
    tile_coords(g, tile, n, oy, ox0);
    __syncthreads();  // weights ready / previous tile fully written out
    fill_patch(patch, x, g, n, oy, ox0);
    __syncthreads();

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int kk = 0; kk < g.K; ++kk) {
      const float4 wv = *reinterpret_cast<const float4*>(&wsm[kk * CO + 4 * cq]);
      const float* pr = &patch[kk * PSTR + 4 * pg];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float xv = pr[i];
        acc[i][0] = fmaf(xv, wv.x, acc[i][0]);
        acc[i][1] = fmaf(xv, wv.y, acc[i][1]);
        acc[i][2] = fmaf(xv, wv.z, acc[i][2]);
        acc[i][3] = fmaf(xv, wv.w, acc[i][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = 4 * pg + i;
      const bool ok = ox0 + p < g.W2;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float yb = bf16_round(acc[i][j]);
        osm[(4 * cq + j) * TP + p] = yb;
        if (ok) {
          s1[j] += yb;
          s2[j] += yb * yb;
        }
      }
    }
    __syncthreads();
    for (int e = t; e < CO * TP; e += NT) {
      const int co = e / TP, p = e - (e / TP) * TP;
      if (ox0 + p < g.W2)
        y[(((size_t)n * CO + co) * g.H2 + oy) * g.W2 + ox0 + p] = __float2bfloat16(osm[e]);
    }
  }

  // Block partial of the stats: 16 pixel groups per channel, fixed order.
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    osm[(4 * cq + j) * 16 + pg] = s1[j];
    osm[CO * 16 + (4 * cq + j) * 16 + pg] = s2[j];
  }
  __syncthreads();
  if (t < 2 * CO) {
    float s = 0.f;
    for (int i = 0; i < 16; ++i) s += osm[t * 16 + i];
    partial[(size_t)blockIdx.x * 2 * CO + t] = s;
  }
}

template <int KJ>
__global__ void __launch_bounds__(NT)
stem_dw_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
               const __nv_bfloat16* __restrict__ y, const float* __restrict__ ds,
               float* __restrict__ partial, Geo g) {
  extern __shared__ float smem[];
  float* patch = smem;               // [K][PSTR]
  float* dys = patch + g.K * PSTR;   // [CO][PSTR] folded, bf16-rounded dY
  float* dss = dys + CO * PSTR;      // [2][CO]
  const int t = threadIdx.x;
  for (int e = t; e < 2 * CO; e += NT) dss[e] = ds[e];

  const int cq = t % 16;  // channels 4*cq .. 4*cq+3
  const int kg = t / 16;  // taps kg, kg+16, ..., kg+16*(KJ-1)
  float acc[KJ][4];
#pragma unroll
  for (int j = 0; j < KJ; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;

  for (int tile = blockIdx.x; tile < g.ntiles; tile += gridDim.x) {
    int n, oy, ox0;
    tile_coords(g, tile, n, oy, ox0);
    __syncthreads();  // ds ready / previous tile consumed
    fill_patch(patch, x, g, n, oy, ox0);
    for (int e = t; e < CO * TP; e += NT) {
      const int co = e / TP, p = e - (e / TP) * TP;
      float v = 0.f;
      if (ox0 + p < g.W2) {
        const size_t idx = (((size_t)n * CO + co) * g.H2 + oy) * g.W2 + ox0 + p;
        // (dy + ds0) + (2*y)*ds1 with no contraction into an FMA: the same
        // roundings as the plain version, so dY rounds to the same bf16.
        const float f = __fadd_rn(__fadd_rn(__bfloat162float(dy[idx]), dss[co]),
                                  __fmul_rn(__fmul_rn(2.f, __bfloat162float(y[idx])),
                                            dss[CO + co]));
        v = bf16_round(f);
      }
      dys[co * PSTR + p] = v;
    }
    __syncthreads();
    for (int p = 0; p < TP; ++p) {
      const float d0 = dys[(4 * cq + 0) * PSTR + p];
      const float d1 = dys[(4 * cq + 1) * PSTR + p];
      const float d2 = dys[(4 * cq + 2) * PSTR + p];
      const float d3 = dys[(4 * cq + 3) * PSTR + p];
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int kk = kg + 16 * j;
        const float xv = kk < g.K ? patch[kk * PSTR + p] : 0.f;
        acc[j][0] = fmaf(xv, d0, acc[j][0]);
        acc[j][1] = fmaf(xv, d1, acc[j][1]);
        acc[j][2] = fmaf(xv, d2, acc[j][2]);
        acc[j][3] = fmaf(xv, d3, acc[j][3]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < KJ; ++j) {
    const int kk = kg + 16 * j;
    if (kk < g.K) {
      float* dst = &partial[((size_t)blockIdx.x * g.K + kk) * CO + 4 * cq];
#pragma unroll
      for (int c = 0; c < 4; ++c) dst[c] = acc[j][c];
    }
  }
}

// out[col] = sum_i part[i][col], i in order (deterministic).
__global__ void reduce_partials_kernel(const float* __restrict__ part, int nparts, int width,
                                       float* __restrict__ out) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= width) return;
  float s = 0.f;
  for (int i = 0; i < nparts; ++i) s += part[(size_t)i * width + col];
  out[col] = s;
}

static bool geo_ok(int N, int H, int W, int k) {
  return N > 0 && H > 0 && W > 0 && H % 2 == 0 && W % 2 == 0 && k % 2 == 1 && k >= 1 && k <= 11;
}

extern "C" int stem_fwd_smem_bytes(int k) {
  const int K = 3 * k * k;
  return (K * CO + K * PSTR + CO * TP) * (int)sizeof(float);
}

extern "C" int stem_dw_smem_bytes(int k) {
  const int K = 3 * k * k;
  return (K * PSTR + CO * PSTR + 2 * CO) * (int)sizeof(float);
}

// Kernel B.  partial: [grid][2][64] f32 scratch.  Returns a cudaError_t.
extern "C" int stem_fwd(const void* x, const void* w, void* y, void* partial, void* sums,
                        int N, int H, int W, int k, int grid, void* stream) {
  if (!geo_ok(N, H, W, k) || grid < 1) return (int)cudaErrorInvalidValue;
  const Geo g = make_geo(N, H, W, k);
  const cudaStream_t s = (cudaStream_t)stream;
  const int smem = stem_fwd_smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(stem_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  stem_fwd_kernel<<<grid, NT, smem, s>>>((const __nv_bfloat16*)x, (const float*)w,
                                         (__nv_bfloat16*)y, (float*)partial, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials_kernel<<<1, 2 * CO, 0, s>>>((const float*)partial, grid, 2 * CO, (float*)sums);
  return (int)cudaGetLastError();
}

template <int KJ>
static cudaError_t launch_dw(const void* x, const void* dy, const void* y, const void* ds,
                             void* partial, const Geo& g, int grid, int smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(stem_dw_kernel<KJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  stem_dw_kernel<KJ><<<grid, NT, smem, s>>>((const __nv_bfloat16*)x, (const __nv_bfloat16*)dy,
                                            (const __nv_bfloat16*)y, (const float*)ds,
                                            (float*)partial, g);
  return cudaGetLastError();
}

// Kernel C.  ds: [2][64] f32; partial: [grid][K][64] f32 scratch;
// dw: [K][64] f32 (HWIO flattening).  Returns a cudaError_t.
extern "C" int stem_dw(const void* x, const void* dy, const void* y, const void* ds,
                       void* partial, void* dw, int N, int H, int W, int k, int grid,
                       void* stream) {
  if (!geo_ok(N, H, W, k) || grid < 1) return (int)cudaErrorInvalidValue;
  const Geo g = make_geo(N, H, W, k);
  const cudaStream_t s = (cudaStream_t)stream;
  const int smem = stem_dw_smem_bytes(k);
  cudaError_t err;
  switch ((g.K + 15) / 16) {  // taps per thread
    case 1: err = launch_dw<1>(x, dy, y, ds, partial, g, grid, smem, s); break;
    case 2: err = launch_dw<2>(x, dy, y, ds, partial, g, grid, smem, s); break;
    case 5: err = launch_dw<5>(x, dy, y, ds, partial, g, grid, smem, s); break;
    case 10: err = launch_dw<10>(x, dy, y, ds, partial, g, grid, smem, s); break;
    case 16: err = launch_dw<16>(x, dy, y, ds, partial, g, grid, smem, s); break;
    case 23: err = launch_dw<23>(x, dy, y, ds, partial, g, grid, smem, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const int width = g.K * CO;
  reduce_partials_kernel<<<(width + 255) / 256, 256, 0, s>>>((const float*)partial, grid, width,
                                                            (float*)dw);
  return (int)cudaGetLastError();
}
