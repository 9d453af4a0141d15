// 3x3 stride-1 SAME convolution as an implicit GEMM (K8) and its weight
// gradient (K9) for NVIDIA Hopper (sm_90a), NCHW / OIHW.
//
// Replaces the Pallas TPU kernels ``_fwd_kernel`` and ``_wgrad_kernel``
// (launched by ``_conv3x3_call`` and ``_wgrad_call``) of
// gantrack_tpu/ops/attic/conv3x3.py:
//     K8: out[n,co,y,x] = sum_{ci,dy,dx} w[co,ci,dy,dx] xpad[n,ci,y+dy,x+dx]
//     K9: dw[co,ci,dy,dx] = sum_{n,y,x} g[n,co,y,x] xpad[n,ci,y+dy,x+dx]
// with xpad the image zero-padded by one pixel, sums in f32 and one
// rounding to the tensors' type (bf16 or f32) at the store.  Together with
// the flipped, transposed weights (the input gradient is K8 again) the two
// are closed under differentiation of every order.  No im2col matrix and no
// padded copy of x exist in device memory: a block guards its halo reads at
// the image border.
//
// What is ported is the arithmetic, not the TPU form.  The width fold to
// 128-lane rows, the padded and folded copy of x, the grid that runs in
// order (K8's copy of block i+1 during block i; K9's sum carried in the
// output block across grid steps) and the weights resident in fast memory
// are gone: blocks run in no order, a block has 227 KB, and 9*512*512
// weights do not fit.  Here the loop over input-channel slabs and the nine
// taps runs inside the block, output channels and input channels are tiled,
// and K9 is a split reduction: each block sums a fixed range of pixel tiles
// into an f32 partial in scratch memory, and a second kernel adds the
// partials in a fixed order.  There are no atomics, so K9 is bitwise
// deterministic.
//
// What bounds these kernels on the H100: operations.  At the training
// shapes (32 x 256^2 x 64 -> 64 up to 32 x 32^2 x 512 -> 512) a call is
// 154.6 GFLOP against 537 MB down to 72 MB: at 64 channels the bytes and
// the operations tie (~0.16 ms each at the card's peaks), from 128 channels
// on the tensor cores, not the memory, limit.  So bf16 tensors go through the
// tensor cores with warp-level ``mma.sync.m16n8k16`` (bf16 x bf16 -> f32):
//   * K8 (bf16) makes pixels the M axis and output channels the N axis; K
//     is input channels, so both operands want channel pairs packed.  The
//     block stages a [18 x 18 pixels][32 ci] window TRANSPOSED to
//     pixel-major in shared memory (NCHW keeps pixels contiguous, so the
//     global reads are row segments), and the weights as [tap][co][ci]
//     from a repacked copy the wrapper makes.  A tap shift is then a whole
//     pixel row of the window: every fragment load is an aligned 32-bit
//     load, for all nine taps.  Row strides of 40 elements keep the
//     fragment loads free of bank conflicts.
//   * K9 (bf16) makes output channels M, input channels N and pixels K, so
//     both operands keep NCHW's pixel-contiguous rows; the odd column shift
//     (dx = 1) of the x window is made in registers from the two aligned
//     words around it (``__byte_perm``), not by a second copy.
// f32 tensors run on the CUDA cores in full f32 (FMA), never TF32: a
// register-tiled direct convolution (K8) and a 64 x 64 x 32 tiled GEMM
// over gathered pixels (K9).  These first kernels load synchronously; a
// cp.async/TMA ring, wgmma and a persistent schedule are left to the
// redesign.
//
// Any N, Ci, Co, H, W >= 1 run (tiles are guarded); H*W, 9*Co*Ci and N*H*W
// must be below 2^31, all offsets into tensors are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ----------------------------------------------------------------- K8, bf16
//
// Block: 256 threads, one 16 x 16 pixel tile of one image, 64 output
// channels.  Warp w owns tile rows 2w and 2w+1 (two m16 tiles of 16 pixels)
// and all 64 output channels (eight n8 tiles): 64 f32 accumulators a
// thread.  Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4):
// A: (row g | g+8, k 2t,2t+1 | +8); B: (k 2t,2t+1 | +8, col g);
// C: (row g | g+8, col 2t,2t+1).

constexpr int kF_TH = 16, kF_TW = 16;
constexpr int kF_WinW = kF_TW + 2;
constexpr int kF_WinPix = (kF_TH + 2) * kF_WinW;  // 324
constexpr int kF_CoT = 64, kF_CiT = 32;
constexpr int kF_Stride = kF_CiT + 8;  // 40 elements: 20 words, conflict-free fragments
constexpr int kF_SmemBytes =
    kF_WinPix * kF_Stride * 2 + 9 * kF_CoT * kF_Stride * 2 + kF_WinPix * 4;

__global__ void __launch_bounds__(256, 2)
conv3x3_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wp,
                    bf16* __restrict__ out, int Ci, int Co, int H, int W, int tiles_x,
                    int tiles_y, int co_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);         // [324 pixels][40]
  bf16* ws = xs + kF_WinPix * kF_Stride;            // [9 taps * 64 co][40]
  int* offs = reinterpret_cast<int*>(ws + 9 * kF_CoT * kF_Stride);  // [324]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  long long b = blockIdx.x;
  const int co0 = (int)(b % co_tiles) * kF_CoT;
  b /= co_tiles;
  const int x0 = (int)(b % tiles_x) * kF_TW;
  b /= tiles_x;
  const int y0 = (int)(b % tiles_y) * kF_TH;
  const size_t n = (size_t)(b / tiles_y);
  const size_t HW = (size_t)H * W;

  // Offset of every window pixel inside a plane, or -1 outside the image.
  for (int pix = tid; pix < kF_WinPix; pix += 256) {
    const int r = pix / kF_WinW, c = pix - r * kF_WinW;
    const int y = y0 - 1 + r, xx = x0 - 1 + c;
    offs[pix] = (y >= 0 && y < H && xx >= 0 && xx < W) ? y * W + xx : -1;
  }

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;

  const bool vec_ok = (Ci % 8) == 0;
  const uint32_t* xs32 = reinterpret_cast<const uint32_t*>(xs);
  const uint32_t* ws32 = reinterpret_cast<const uint32_t*>(ws);
  const bf16 zero = __float2bfloat16(0.f);

  for (int ci0 = 0; ci0 < Ci; ci0 += kF_CiT) {
    __syncthreads();  // the previous slab is consumed; offs is written
    // Window, transposed to [pixel][ci]: a warp walks one channel's pixels.
    for (int cl = warp; cl < kF_CiT; cl += 8) {
      const int ci = ci0 + cl;
      const bool ci_ok = ci < Ci;
      const bf16* plane = x + (n * Ci + (ci_ok ? ci : 0)) * HW;
      for (int pix = lane; pix < kF_WinPix; pix += 32) {
        const int off = offs[pix];
        xs[pix * kF_Stride + cl] = (ci_ok && off >= 0) ? plane[off] : zero;
      }
    }
    // Weights [tap][co][ci], 8 input channels (16 bytes) a copy.
    for (int idx = tid; idx < 9 * kF_CoT * (kF_CiT / 8); idx += 256) {
      const int row = idx >> 2, chunk = idx & 3;
      const int tap = row / kF_CoT, co = co0 + (row - tap * kF_CoT), ci = ci0 + chunk * 8;
      bf16* dst = ws + row * kF_Stride + chunk * 8;
      const bf16* src = wp + ((size_t)tap * Co + (co < Co ? co : 0)) * Ci + ci;
      if (vec_ok && co < Co && ci + 8 <= Ci) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) dst[e] = (co < Co && ci + e < Ci) ? src[e] : zero;
      }
    }
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap - dy * 3;
#pragma unroll
      for (int ks = 0; ks < kF_CiT / 16; ++ks) {
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int base = (2 * warp + mt + dy) * kF_WinW + dx;  // window pixel of tile col 0
          const int w_lo = (base + g) * (kF_Stride / 2) + ks * 8 + t;
          const int w_hi = (base + g + 8) * (kF_Stride / 2) + ks * 8 + t;
          a[mt][0] = xs32[w_lo];
          a[mt][1] = xs32[w_hi];
          a[mt][2] = xs32[w_lo + 4];
          a[mt][3] = xs32[w_hi + 4];
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int wrow = (tap * kF_CoT + nt * 8 + g) * (kF_Stride / 2) + ks * 8 + t;
          const uint32_t b0 = ws32[wrow], b1 = ws32[wrow + 4];
          mma_bf16(acc[0][nt], a[0], b0, b1);
          mma_bf16(acc[1][nt], a[1], b0, b1);
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int y = y0 + 2 * warp + mt;
    if (y >= H) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int xx = x0 + g + (k >> 1) * 8;
        const int co = co0 + nt * 8 + 2 * t + (k & 1);
        if (xx < W && co < Co)
          out[((n * Co + co) * H + y) * W + xx] = __float2bfloat16(acc[mt][nt][k]);
      }
    }
  }
}

// ------------------------------------------------------------------ K8, f32
//
// Block: 256 threads, an 8 x 16 pixel tile, 64 output channels, slabs of 8
// input channels.  A thread owns 4 pixels of a row and 8 output channels;
// the 8 weights of a tap are one broadcast read for the whole warp.
// Weights come repacked as [tap][ci][co].

constexpr int kS_TH = 8, kS_TW = 16;
constexpr int kS_WinW = kS_TW + 2, kS_WinH = kS_TH + 2;
constexpr int kS_WinPix = kS_WinH * kS_WinW;  // 180
constexpr int kS_RowStride = 20;
constexpr int kS_CoT = 64, kS_CiT = 8;

__global__ void __launch_bounds__(256)
conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ wp,
                   float* __restrict__ out, int Ci, int Co, int H, int W, int tiles_x,
                   int tiles_y, int co_tiles) {
  __shared__ __align__(16) float xs[kS_CiT * kS_WinH * kS_RowStride];  // [ci][10][20]
  __shared__ __align__(16) float ws[kS_CiT * 9 * kS_CoT];              // [ci][tap][co]
  __shared__ int offs[kS_WinPix];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = lane >> 2, c0 = (lane & 3) * 4, col = warp * 8;
  long long b = blockIdx.x;
  const int co0 = (int)(b % co_tiles) * kS_CoT;
  b /= co_tiles;
  const int x0 = (int)(b % tiles_x) * kS_TW;
  b /= tiles_x;
  const int y0 = (int)(b % tiles_y) * kS_TH;
  const size_t n = (size_t)(b / tiles_y);
  const size_t HW = (size_t)H * W;

  for (int pix = tid; pix < kS_WinPix; pix += 256) {
    const int wr = pix / kS_WinW, wc = pix - wr * kS_WinW;
    const int y = y0 - 1 + wr, xx = x0 - 1 + wc;
    offs[pix] = (y >= 0 && y < H && xx >= 0 && xx < W) ? y * W + xx : -1;
  }

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int p = 0; p < 4; ++p) acc[j][p] = 0.f;

  for (int ci0 = 0; ci0 < Ci; ci0 += kS_CiT) {
    __syncthreads();
    {  // one channel of the window a warp
      const int ci = ci0 + warp;
      const bool ci_ok = ci < Ci;
      const float* plane = x + (n * Ci + (ci_ok ? ci : 0)) * HW;
      for (int pix = lane; pix < kS_WinPix; pix += 32) {
        const int wr = pix / kS_WinW, wc = pix - wr * kS_WinW;
        const int off = offs[pix];
        xs[(warp * kS_WinH + wr) * kS_RowStride + wc] = (ci_ok && off >= 0) ? plane[off] : 0.f;
      }
    }
    for (int idx = tid; idx < kS_CiT * 9 * kS_CoT; idx += 256) {
      const int co_l = idx & (kS_CoT - 1), rest = idx >> 6;
      const int cl = rest / 9, tap = rest - cl * 9;
      const int ci = ci0 + cl, co = co0 + co_l;
      ws[idx] = (ci < Ci && co < Co) ? wp[((size_t)tap * Ci + ci) * Co + co] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int cl = 0; cl < kS_CiT; ++cl) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float xr[6];
        const float* row = xs + (cl * kS_WinH + r + dy) * kS_RowStride + c0;
#pragma unroll
        for (int i = 0; i < 6; ++i) xr[i] = row[i];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4* wv = reinterpret_cast<const float4*>(ws + (cl * 9 + dy * 3 + dx) * kS_CoT + col);
          const float4 w0 = wv[0], w1 = wv[1];
          const float wj[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int p = 0; p < 4; ++p) acc[j][p] = fmaf(wj[j], xr[p + dx], acc[j][p]);
        }
      }
    }
  }

  const int y = y0 + r;
  if (y < H) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int co = co0 + col + j;
      if (co >= Co) continue;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int xx = x0 + c0 + p;
        if (xx < W) out[((n * Co + co) * H + y) * W + xx] = acc[j][p];
      }
    }
  }
}

// ----------------------------------------------------------------- K9, bf16
//
// Block: 256 threads, 64 output channels x 32 input channels x 9 taps, over
// the pixel tiles [tile_lo, tile_hi) of its split (8 x 16 pixels a tile).
// Warp w owns output channels 16 (w % 4) .. +15 (one m16 tile) and input
// channels 16 (w / 4) .. +15 (two n8 tiles) for all nine taps: 72 f32
// accumulators a thread.  A tile row of 16 pixels is one k16 step.

constexpr int kW_TH = 8, kW_TW = 16;
constexpr int kW_CoT = 64, kW_CiT = 32;
constexpr int kW_GStride = kW_TH * kW_TW + 8;                 // 136: 68 words
constexpr int kW_WinW = kW_TW + 2, kW_WinPix = (kW_TH + 2) * kW_WinW;  // 18, 180
constexpr int kW_XStride = kW_WinPix + 4;                     // 184: 92 words

__global__ void __launch_bounds__(256, 2)
wgrad3x3_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gr,
                     float* __restrict__ partial, int Ci, int Co, int H, int W, int tiles_x,
                     int tiles_y, long long tiles, int splits, int co_tiles, int ci_tiles) {
  __shared__ __align__(16) bf16 gs[kW_CoT * kW_GStride];  // [co][8 x 16 pixels]
  __shared__ __align__(16) bf16 xe[kW_CiT * kW_XStride];  // [ci][10 x 18 pixels]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  long long b = blockIdx.x;
  const int ci0 = (int)(b % ci_tiles) * kW_CiT;
  b /= ci_tiles;
  const int co0 = (int)(b % co_tiles) * kW_CoT;
  const long long s = b / co_tiles;
  const long long tile_lo = s * tiles / splits, tile_hi = (s + 1) * tiles / splits;
  const size_t HW = (size_t)H * W;
  const bf16 zero = __float2bfloat16(0.f);

  float acc[9][2][4];
#pragma unroll
  for (int i = 0; i < 9; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;

  const uint32_t* gs32 = reinterpret_cast<const uint32_t*>(gs);
  const uint32_t* xe32 = reinterpret_cast<const uint32_t*>(xe);

  for (long long tile = tile_lo; tile < tile_hi; ++tile) {
    long long q = tile;
    const int x0 = (int)(q % tiles_x) * kW_TW;
    q /= tiles_x;
    const int y0 = (int)(q % tiles_y) * kW_TH;
    const size_t n = (size_t)(q / tiles_y);

    __syncthreads();
    for (int cl = warp; cl < kW_CoT; cl += 8) {
      const int co = co0 + cl;
      const bool ok = co < Co;
      const bf16* plane = gr + (n * Co + (ok ? co : 0)) * HW;
      for (int p = lane; p < kW_TH * kW_TW; p += 32) {
        const int y = y0 + (p >> 4), xx = x0 + (p & 15);
        gs[cl * kW_GStride + p] = (ok && y < H && xx < W) ? plane[(size_t)y * W + xx] : zero;
      }
    }
    for (int cl = warp; cl < kW_CiT; cl += 8) {
      const int ci = ci0 + cl;
      const bool ok = ci < Ci;
      const bf16* plane = x + (n * Ci + (ok ? ci : 0)) * HW;
      for (int pix = lane; pix < kW_WinPix; pix += 32) {
        const int wr = pix / kW_WinW, wc = pix - wr * kW_WinW;
        const int y = y0 - 1 + wr, xx = x0 - 1 + wc;
        xe[cl * kW_XStride + pix] =
            (ok && y >= 0 && y < H && xx >= 0 && xx < W) ? plane[(size_t)y * W + xx] : zero;
      }
    }
    __syncthreads();

#pragma unroll
    for (int kr = 0; kr < kW_TH; ++kr) {
      uint32_t a[4];
      const int a_lo = ((wm * 16 + g) * kW_GStride + kr * kW_TW) / 2 + t;
      const int a_hi = ((wm * 16 + g + 8) * kW_GStride + kr * kW_TW) / 2 + t;
      a[0] = gs32[a_lo];
      a[1] = gs32[a_hi];
      a[2] = gs32[a_lo + 4];
      a[3] = gs32[a_hi + 4];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          // Words of window row kr + dy: columns (2t, 2t+1), (2t+2, 2t+3)
          // and the same eight columns on.
          const int base = ((wn * 16 + nt * 8 + g) * kW_XStride + (kr + dy) * kW_WinW) / 2 + t;
          const uint32_t w0 = xe32[base], w1 = xe32[base + 1];
          const uint32_t w4 = xe32[base + 4], w5 = xe32[base + 5];
          mma_bf16(acc[dy * 3 + 0][nt], a, w0, w4);
          mma_bf16(acc[dy * 3 + 1][nt], a, __byte_perm(w0, w1, 0x5432),
                   __byte_perm(w4, w5, 0x5432));
          mma_bf16(acc[dy * 3 + 2][nt], a, w1, w5);
        }
      }
    }
  }

  const size_t plane9 = (size_t)Co * Ci;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int co = co0 + wm * 16 + g + (k >> 1) * 8;
        const int ci = ci0 + wn * 16 + nt * 8 + 2 * t + (k & 1);
        if (co < Co && ci < Ci)
          partial[((size_t)s * 9 + tap) * plane9 + (size_t)co * Ci + ci] = acc[tap][nt][k];
      }
    }
  }
}

// ------------------------------------------------------------------ K9, f32
//
// Block: 256 threads, one tap, 64 output channels x 64 input channels, over
// the chunks [chunk_lo, chunk_hi) of 32 pixels of its split; pixels are
// numbered n*H*W + y*W + x.  A thread owns 4 x 4 sums.

constexpr int kV_T = 64, kV_K = 32, kV_Stride = kV_K + 1;

__global__ void __launch_bounds__(256)
wgrad3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ gr,
                    float* __restrict__ partial, int N, int Ci, int Co, int H, int W,
                    long long chunks, int splits, int co_tiles, int ci_tiles) {
  __shared__ float as[kV_T * kV_Stride];  // [co][pixel]
  __shared__ float bs[kV_T * kV_Stride];  // [ci][pixel]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  long long b = blockIdx.x;
  const int ci0 = (int)(b % ci_tiles) * kV_T;
  b /= ci_tiles;
  const int co0 = (int)(b % co_tiles) * kV_T;
  b /= co_tiles;
  const int tap = (int)(b % 9);
  const long long s = b / 9;
  const int dy = tap / 3 - 1, dx = tap % 3 - 1;
  const long long chunk_lo = s * chunks / splits, chunk_hi = (s + 1) * chunks / splits;
  const long long HW = (long long)H * W, total = (long long)N * HW;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (long long chunk = chunk_lo; chunk < chunk_hi; ++chunk) {
    const long long P = chunk * kV_K + lane;
    const bool valid = P < total;
    const long long n = valid ? P / HW : 0;
    const int p = valid ? (int)(P - n * HW) : 0;
    const int y = p / W, xx = p - y * W;
    const int ys = y + dy, xsrc = xx + dx;
    const bool src_ok = valid && ys >= 0 && ys < H && xsrc >= 0 && xsrc < W;
    __syncthreads();
    for (int ch = warp; ch < kV_T; ch += 8) {
      const int co = co0 + ch, ci = ci0 + ch;
      as[ch * kV_Stride + lane] =
          (valid && co < Co) ? gr[((size_t)n * Co + co) * HW + p] : 0.f;
      bs[ch * kV_Stride + lane] =
          (src_ok && ci < Ci) ? x[((size_t)n * Ci + ci) * HW + (size_t)ys * W + xsrc] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kV_K; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[(4 * ty + i) * kV_Stride + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[(4 * tx + j) * kV_Stride + k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  const size_t plane9 = (size_t)Co * Ci;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int co = co0 + 4 * ty + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ci = ci0 + 4 * tx + j;
      if (co < Co && ci < Ci)
        partial[((size_t)s * 9 + tap) * plane9 + (size_t)co * Ci + ci] = acc[i][j];
    }
  }
}

// Second pass of K9: the partials [split][tap][co][ci] summed over the
// splits in their order, rounded once, stored as OIHW [co][ci][tap].
template <typename T>
__global__ void wgrad_reduce_kernel(const float* __restrict__ partial, T* __restrict__ dw,
                                    int Ci, int Co, int splits) {
  const size_t total = (size_t)9 * Co * Ci;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) sum += partial[(size_t)s * total + idx];
  const size_t plane9 = (size_t)Co * Ci;
  const size_t tap = idx / plane9, rem = idx - tap * plane9;  // rem = co * Ci + ci
  if constexpr (sizeof(T) == 2) {
    dw[rem * 9 + tap] = __float2bfloat16(sum);
  } else {
    dw[rem * 9 + tap] = sum;
  }
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

}  // namespace

// The entry points launch on ``stream`` and return cudaGetLastError().
// ``is_bf16`` selects the element type of x, g, the weights and the result.

// K8: x [N, Ci, H, W], repacked weights (bf16: [9][Co][Ci]; f32:
// [9][Ci][Co]) -> out [N, Co, H, W].
extern "C" int gantrack_conv3x3(const void* x, const void* wp, void* out, int N, int Ci, int Co,
                                int H, int W, int is_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    const int tx = ceil_div(W, kF_TW), ty = ceil_div(H, kF_TH), ct = ceil_div(Co, kF_CoT);
    const long long blocks = (long long)N * ty * tx * ct;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
    cudaError_t e = cudaFuncSetAttribute(conv3x3_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kF_SmemBytes);
    if (e != cudaSuccess) return (int)e;
    conv3x3_bf16_kernel<<<(unsigned)blocks, 256, kF_SmemBytes, st>>>(
        (const bf16*)x, (const bf16*)wp, (bf16*)out, Ci, Co, H, W, tx, ty, ct);
  } else {
    const int tx = ceil_div(W, kS_TW), ty = ceil_div(H, kS_TH), ct = ceil_div(Co, kS_CoT);
    const long long blocks = (long long)N * ty * tx * ct;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
    conv3x3_f32_kernel<<<(unsigned)blocks, 256, 0, st>>>((const float*)x, (const float*)wp,
                                                         (float*)out, Ci, Co, H, W, tx, ty, ct);
  }
  return (int)cudaGetLastError();
}

// The number of units K9's reduction over N*H*W is cut into (pixel tiles
// for bf16, 32-pixel chunks for f32) and of (co, ci[, tap]) blocks a
// split: the wrapper sizes ``splits`` and the scratch from them.
extern "C" void gantrack_wgrad3x3_geometry(int N, int Ci, int Co, int H, int W, int is_bf16,
                                           long long* units, long long* blocks_per_split) {
  if (is_bf16) {
    *units = (long long)N * ceil_div(H, kW_TH) * ceil_div(W, kW_TW);
    *blocks_per_split = (long long)ceil_div(Co, kW_CoT) * ceil_div(Ci, kW_CiT);
  } else {
    *units = ((long long)N * H * W + kV_K - 1) / kV_K;
    *blocks_per_split = 9LL * ceil_div(Co, kV_T) * ceil_div(Ci, kV_T);
  }
}

// K9: x [N, Ci, H, W], g [N, Co, H, W], scratch ``partial``
// [splits][9][Co][Ci] f32 -> dw [Co, Ci, 3, 3].
extern "C" int gantrack_wgrad3x3(const void* x, const void* g, float* partial, void* dw, int N,
                                 int Ci, int Co, int H, int W, int splits, int is_bf16,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  long long units = 0, per_split = 0;
  gantrack_wgrad3x3_geometry(N, Ci, Co, H, W, is_bf16, &units, &per_split);
  const long long blocks = per_split * splits;
  if (splits < 1 || splits > units || blocks > 2147483647LL)
    return (int)cudaErrorInvalidConfiguration;
  if (is_bf16) {
    wgrad3x3_bf16_kernel<<<(unsigned)blocks, 256, 0, st>>>(
        (const bf16*)x, (const bf16*)g, partial, Ci, Co, H, W, ceil_div(W, kW_TW),
        ceil_div(H, kW_TH), units, splits, ceil_div(Co, kW_CoT), ceil_div(Ci, kW_CiT));
  } else {
    wgrad3x3_f32_kernel<<<(unsigned)blocks, 256, 0, st>>>(
        (const float*)x, (const float*)g, partial, N, Ci, Co, H, W, units, splits,
        ceil_div(Co, kV_T), ceil_div(Ci, kV_T));
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t total = (size_t)9 * Co * Ci;
  const unsigned rblocks = (unsigned)((total + 255) / 256);
  if (is_bf16) {
    wgrad_reduce_kernel<bf16><<<rblocks, 256, 0, st>>>(partial, (bf16*)dw, Ci, Co, splits);
  } else {
    wgrad_reduce_kernel<float><<<rblocks, 256, 0, st>>>(partial, (float*)dw, Ci, Co, splits);
  }
  return (int)cudaGetLastError();
}
