// Six capability probes (P1-P6) for NVIDIA Hopper (sm_90a).
//
// They replace the Pallas probe kernels of scripts/probe_matmul.py (``mk``,
// inline ``kern``: P1) and scripts/probe_mosaic.py (``probe_a`` .. ``probe_e``:
// P2-P6), which asked the TPU's Mosaic compiler what the 3x3 implicit-GEMM
// convolution could be built from.  Each probe here asks the card the same
// question in the card's terms and returns the probe's array, so it is held
// against a plain version; together they are the ladder to
// csrc/conv3x3.cu (P1 -> P4 -> P2/P3 -> K8).
//
//   P1  one tile product per operand / result type pair.  The tensor cores
//       have warp-level products for bf16 x bf16 -> f32
//       (mma.sync.m16n8k16) and tf32 x tf32 -> f32 (mma.sync.m16n8k8) only:
//       a bf16 result is the f32 sum rounded in registers, and every pair
//       with an f32 operand goes through tf32 in registers.  A bf16 operand
//       is exact in tf32.  An f32 operand is split into two tf32 terms,
//       v = hi + lo with hi = tf32(v) and lo = tf32(v - hi), and the product
//       is the sum of the cross terms a_lo b_hi + a_hi b_lo + a_hi b_hi
//       (the "3 x tf32" product: 22 of float32's 24 significand bits, the
//       small terms summed first), so the result is the float32 product to
//       float32 rounding and not a tf32 one.
//       The TPU asked which pairs its matrix unit accepts at all.
//   P2  one 16 x 32 x 64 output tile of the 3x3 conv from an [18, 34, 64]
//       halo window copied into shared memory asynchronously (cp.async) as
//       it lies in device memory.  With channels innermost a tap shift is a
//       whole pixel, so every fragment load is aligned whatever the
//       window's extents; but a pixel is 128 bytes, so the eight rows of a
//       fragment fall on the same banks.
//   P3  the same tile from a wider [24, 40, 64] window, staged with a pixel
//       stride of 72 elements: the shifted reads are free of bank
//       conflicts.  (The TPU needed the wider window for alignment and made
//       the column shifts by rotation.)
//   P4  a two-slot cp.async ring: bands of 4 window rows are copied into the
//       slot ``band % 2``, chosen at run time, while the band before is
//       read back.  (Two whole [24, 40, 64] windows, 245,760 bytes, exceed
//       a block's 227 KB: the ring holds bands, not windows.)
//   P5  nine [256, 64] pieces assembled into 576-wide rows in shared
//       memory, 64 rows a block (256 rows of 576 are 294,912 bytes).
//   P6  rows 1..32 of a [40, 128] array staged in shared memory: a slice
//       off any tile boundary is an address offset here.
//
// What bounds them: neither bytes nor operations; they move a few hundred
// KB each and take the latency of a launch and of one block's dependent
// steps.  They are kept for what they show.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTH = 16, kTW = 32, kC = 64;  // the probes' tile: TH x W x C

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo in two tf32 terms; lo is 0 where v is exact in tf32 (bf16).
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float load_any(const void* p, size_t i, int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const bf16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// P1.  a [m, k], b [k, n] (or [n, k] when b_t), out [m, n]; m % 16 == 0,
// n % 8 == 0, k % 16 == 0.  One block of four warps walks the m16 x n8
// tiles.  Fragment layouts (g = lane / 4, t = lane % 4): k16: A (row g |
// g+8, k 2t,2t+1 | +8), B (k 2t,2t+1 | +8, col g); k8: A (row g | g+8, k t |
// t+4), B (k t | t+4, col g); C (row g | g+8, col 2t,2t+1).
__global__ void probe_matmul_kernel(const void* a, const void* b, void* out, int m, int k, int n,
                                    int a_bf16, int b_bf16, int out_bf16, int b_t) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n_tiles = n / 8, tiles = (m / 16) * n_tiles;
  const bool native = a_bf16 && b_bf16;
  for (int tile = warp; tile < tiles; tile += warps) {
    const int m0 = (tile / n_tiles) * 16, n0 = (tile % n_tiles) * 8;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    auto A = [&](int row, int kk) { return load_any(a, (size_t)row * k + kk, a_bf16); };
    auto B = [&](int kk, int col) {
      return load_any(b, b_t ? (size_t)col * k + kk : (size_t)kk * n + col, b_bf16);
    };
    if (native) {
      for (int k0 = 0; k0 < k; k0 += 16) {
        uint32_t fa[4];
        fa[0] = pack_bf16(A(m0 + g, k0 + 2 * t), A(m0 + g, k0 + 2 * t + 1));
        fa[1] = pack_bf16(A(m0 + g + 8, k0 + 2 * t), A(m0 + g + 8, k0 + 2 * t + 1));
        fa[2] = pack_bf16(A(m0 + g, k0 + 2 * t + 8), A(m0 + g, k0 + 2 * t + 9));
        fa[3] = pack_bf16(A(m0 + g + 8, k0 + 2 * t + 8), A(m0 + g + 8, k0 + 2 * t + 9));
        const uint32_t b0 = pack_bf16(B(k0 + 2 * t, n0 + g), B(k0 + 2 * t + 1, n0 + g));
        const uint32_t b1 = pack_bf16(B(k0 + 2 * t + 8, n0 + g), B(k0 + 2 * t + 9, n0 + g));
        mma_bf16(acc, fa, b0, b1);
      }
    } else {
      // Small terms in their own sum, added to the large one at the end.
      float low[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k0 = 0; k0 < k; k0 += 8) {
        uint32_t hi[4], lo[4], b_hi[2], b_lo[2];
        split_tf32(A(m0 + g, k0 + t), hi[0], lo[0]);
        split_tf32(A(m0 + g + 8, k0 + t), hi[1], lo[1]);
        split_tf32(A(m0 + g, k0 + t + 4), hi[2], lo[2]);
        split_tf32(A(m0 + g + 8, k0 + t + 4), hi[3], lo[3]);
        split_tf32(B(k0 + t, n0 + g), b_hi[0], b_lo[0]);
        split_tf32(B(k0 + t + 4, n0 + g), b_hi[1], b_lo[1]);
        if (!a_bf16) mma_tf32(low, lo, b_hi[0], b_hi[1]);
        if (!b_bf16) mma_tf32(low, hi, b_lo[0], b_lo[1]);
        mma_tf32(acc, hi, b_hi[0], b_hi[1]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] += low[i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const size_t o = (size_t)(m0 + g + (i >> 1) * 8) * n + n0 + 2 * t + (i & 1);
      if (out_bf16) {
        static_cast<bf16*>(out)[o] = __float2bfloat16(acc[i]);
      } else {
        static_cast<float*>(out)[o] = acc[i];
      }
    }
  }
}

// P2 / P3.  x [tiles, win_h, win_w, 64], w [576, 64] ([tap * 64 + ci][co]),
// out [tiles, 16, 32, 64].  The block copies rows 0..17, columns 0..33 of
// its window into shared memory with cp.async at a pixel stride of kStride
// elements (64: as it lies; 72: padded), and the weights transposed to
// [co][tap * 64 + ci].  Warp w computes tile rows 2w, 2w+1: four m16 tiles
// of 16 pixels, each against the eight n8 tiles of output channels.
constexpr int kWinH = kTH + 2, kWinW = kTW + 2, kK = 9 * kC;  // 18, 34, 576
constexpr int kWStride = kK + 8;                              // 584: 292 words

template <int kStride>
__global__ void __launch_bounds__(256)
probe_tile_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w, bf16* __restrict__ out,
                  int win_h, int win_w) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);      // [18 * 34][kStride]
  bf16* ws = xs + kWinH * kWinW * kStride;       // [64 co][584]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bf16* win = x + (size_t)blockIdx.x * win_h * win_w * kC;

  for (int idx = tid; idx < kWinH * kWinW * (kC / 8); idx += 256) {
    const int pix = idx >> 3, chunk = idx & 7;
    const int r = pix / kWinW, c = pix - r * kWinW;
    cp_async16(xs + pix * kStride + chunk * 8, win + ((size_t)r * win_w + c) * kC + chunk * 8);
  }
  cp_async_commit();
  for (int idx = tid; idx < kK * kC; idx += 256) {  // overlaps the copy in flight
    const int kk = idx >> 6, co = idx & 63;
    ws[co * kWStride + kk] = w[idx];
  }
  cp_async_wait<0>();
  __syncthreads();

  const uint32_t* xs32 = reinterpret_cast<const uint32_t*>(xs);
  const uint32_t* ws32 = reinterpret_cast<const uint32_t*>(ws);
  for (int mt = 0; mt < 4; ++mt) {
    const int row = 2 * warp + (mt >> 1), col0 = (mt & 1) * 16;
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap - dy * 3;
      const int base = (row + dy) * kWinW + col0 + dx;
#pragma unroll
      for (int ks = 0; ks < kC / 16; ++ks) {
        uint32_t a[4];
        const int lo = (base + g) * (kStride / 2) + ks * 8 + t;
        const int hi = (base + g + 8) * (kStride / 2) + ks * 8 + t;
        a[0] = xs32[lo];
        a[1] = xs32[hi];
        a[2] = xs32[lo + 4];
        a[3] = xs32[hi + 4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int wrow = (nt * 8 + g) * (kWStride / 2) + (tap * kC) / 2 + ks * 8 + t;
          mma_bf16(acc[nt], a, ws32[wrow], ws32[wrow + 4]);
        }
      }
    }
    bf16* o = out + (((size_t)blockIdx.x * kTH + row) * kTW + col0) * kC;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        o[(size_t)(g + (i >> 1) * 8) * kC + nt * 8 + 2 * t + (i & 1)] = __float2bfloat16(acc[nt][i]);
  }
}

// P4.  x [tiles, 24, 40, 64] -> out [tiles, 16, 32, 64] = x[:, :16, :32].
// One block a window; six bands of four rows go through a two-slot ring.
constexpr int kRingH = kTH + 8, kRingW = kTW + 8, kBand = 4;  // 24, 40
constexpr int kBandElems = kBand * kRingW * kC;               // 10,240 elements

__global__ void __launch_bounds__(256)
probe_ring_kernel(const bf16* __restrict__ x, bf16* __restrict__ out) {
  __shared__ __align__(16) bf16 ring[2][kBandElems];
  const int tid = threadIdx.x;
  const bf16* win = x + (size_t)blockIdx.x * kRingH * kRingW * kC;
  constexpr int bands = kRingH / kBand;

  auto start_band = [&](int band) {
    const int slot = band % 2;  // chosen at run time
    for (int idx = tid; idx < kBandElems / 8; idx += 256)
      cp_async16(&ring[slot][idx * 8], win + (size_t)band * kBandElems + idx * 8);
    cp_async_commit();
  };

  start_band(0);
  for (int band = 0; band < bands; ++band) {
    if (band + 1 < bands) {
      start_band(band + 1);
      cp_async_wait<1>();  // all but the newest group: this band has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int slot = band % 2;
    if (band * kBand < kTH) {
      for (int idx = tid; idx < kBand * kTW * (kC / 8); idx += 256) {
        const int chunk = idx & 7, c = (idx >> 3) % kTW, r = idx / (8 * kTW);
        const uint4 v = *reinterpret_cast<const uint4*>(&ring[slot][(r * kRingW + c) * kC + chunk * 8]);
        *reinterpret_cast<uint4*>(
            out + (((size_t)blockIdx.x * kTH + band * kBand + r) * kTW + c) * kC + chunk * 8) = v;
      }
    }
    __syncthreads();  // the slot is free for band + 2
  }
}

// P5.  x [9, 256, 64] -> out [256, 576]; 64 rows a block.
constexpr int kCatRows = 64;

__global__ void __launch_bounds__(256)
probe_concat_kernel(const bf16* __restrict__ x, bf16* __restrict__ out, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* cat = reinterpret_cast<bf16*>(smem);  // [64][576]
  const int tid = threadIdx.x, row0 = blockIdx.x * kCatRows;
  for (int idx = tid; idx < 9 * kCatRows * (kC / 8); idx += 256) {
    const int chunk = idx & 7, r = (idx >> 3) % kCatRows, piece = idx / (8 * kCatRows);
    *reinterpret_cast<uint4*>(cat + r * kK + piece * kC + chunk * 8) =
        *reinterpret_cast<const uint4*>(x + ((size_t)piece * rows + row0 + r) * kC + chunk * 8);
  }
  __syncthreads();
  for (int idx = tid; idx < kCatRows * (kK / 8); idx += 256)
    *reinterpret_cast<uint4*>(out + (size_t)row0 * kK + idx * 8) =
        *reinterpret_cast<const uint4*>(cat + idx * 8);
}

// P6.  x [40, 128] -> out [32, 128] = x[1:33].
__global__ void __launch_bounds__(256)
probe_row_slice_kernel(const bf16* __restrict__ x, bf16* __restrict__ out) {
  __shared__ bf16 tile[40 * 128];
  const int tid = threadIdx.x;
  for (int idx = tid; idx < 40 * 128; idx += 256) tile[idx] = x[idx];
  __syncthreads();
  for (int idx = tid; idx < 32 * 128; idx += 256) out[idx] = tile[128 + idx];
}

template <int kStride>
int launch_tile(const bf16* x, const bf16* w, bf16* out, int tiles, int win_h, int win_w,
                cudaStream_t st) {
  const int bytes = (kWinH * kWinW * kStride + kC * kWStride) * 2;
  cudaError_t e = cudaFuncSetAttribute(probe_tile_kernel<kStride>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  probe_tile_kernel<kStride><<<tiles, 256, bytes, st>>>(x, w, out, win_h, win_w);
  return (int)cudaGetLastError();
}

}  // namespace

// Every entry point launches on ``stream`` and returns cudaGetLastError().

extern "C" int gantrack_probe_matmul(const void* a, const void* b, void* out, int m, int k, int n,
                                     int a_bf16, int b_bf16, int out_bf16, int b_t, void* stream) {
  if (m % 16 || n % 8 || k % 16) return (int)cudaErrorInvalidValue;
  probe_matmul_kernel<<<1, 128, 0, (cudaStream_t)stream>>>(a, b, out, m, k, n, a_bf16, b_bf16,
                                                           out_bf16, b_t);
  return (int)cudaGetLastError();
}

// ``padded`` 0: P2 (pixel stride 64, window given as it lies); 1: P3.
extern "C" int gantrack_probe_tile(const void* x, const void* w, void* out, int tiles, int win_h,
                                   int win_w, int padded, void* stream) {
  if (win_h < kWinH || win_w < kWinW) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (padded)
    return launch_tile<kC + 8>((const bf16*)x, (const bf16*)w, (bf16*)out, tiles, win_h, win_w, st);
  return launch_tile<kC>((const bf16*)x, (const bf16*)w, (bf16*)out, tiles, win_h, win_w, st);
}

extern "C" int gantrack_probe_ring(const void* x, void* out, int tiles, void* stream) {
  probe_ring_kernel<<<tiles, 256, 0, (cudaStream_t)stream>>>((const bf16*)x, (bf16*)out);
  return (int)cudaGetLastError();
}

extern "C" int gantrack_probe_concat(const void* x, void* out, int rows, void* stream) {
  if (rows % kCatRows) return (int)cudaErrorInvalidValue;
  const int bytes = kCatRows * kK * 2;
  cudaError_t e = cudaFuncSetAttribute(probe_concat_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  probe_concat_kernel<<<rows / kCatRows, 256, bytes, (cudaStream_t)stream>>>(
      (const bf16*)x, (bf16*)out, rows);
  return (int)cudaGetLastError();
}

extern "C" int gantrack_probe_row_slice(const void* x, void* out, void* stream) {
  probe_row_slice_kernel<<<1, 256, 0, (cudaStream_t)stream>>>((const bf16*)x, (bf16*)out);
  return (int)cudaGetLastError();
}
