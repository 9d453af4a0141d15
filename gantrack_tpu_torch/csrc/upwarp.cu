// Fused x2 FIR upsample + affine bilinear warp (K1), and its exact
// adjoint (K2), for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels ``_upwarp_kernel`` and
// ``_upsplat_kernel`` of gantrack_tpu/ops/pallas/upwarp.py.  K1 computes,
// per plane,
//     out = grid_sample(upsample2d(x, fir, up=2), affine_grid(theta))
// (bilinear, zeros padding, align_corners=False) without building the 2x
// canvas; K2 is its transpose, so the two are each other's VJP and any
// order of autodiff closes (R1 differentiates through the pair twice).
//
// What is ported is the arithmetic, not the TPU form: the static window,
// the one-hot hat matmuls, the Ubig phase trick and the 8/128 alignment
// were there for the TPU's layout and are gone.  With no window there is
// no tail clipping either: K1 equals the plain gather chain exactly, up
// to the order of the f32 sums.
//
// What bounds these kernels on the H100: neither device memory (K1 reads
// ~21 MB and writes ~35 MB in bf16 at the augment's shapes) nor arithmetic
// (~0.04 ms at the float32 rate); both are gathers, bound by the
// instructions they issue per output and by each block's wait for its
// staged inputs.
//   * K1 folds the two bilinear taps of each axis and the 12-tap
//     polyphase FIR into 7 weights per axis (one bilinear pair of 2x
//     samples spans 7 samples of the 1x plane), so an output reads 7x7 = 49
//     input values instead of 4 x 6 x 6 = 144.  A block owns a tile of
//     kUpTX x kUpTY outputs and stages, as float32 in shared memory, the box
//     of the 1x plane its outputs can weigh (the tile's corners mapped
//     through the coefficients, plus the 7-sample window), zero outside the
//     plane; the 49 reads of an output are then shared-memory reads, and
//     each input sample is read from device memory about once a block.  A
//     tile whose box exceeds the buffer (a strong zoom out, non-finite
//     positions) takes the direct gather from device memory in the same
//     kernel, a branch that is uniform over the block; a counter can count
//     those blocks.
//   * K2 is one gather kernel, without atomics and bitwise deterministic.
//     A block owns a kSplatTW x kSplatTH tile of the 1x output: (a) it
//     builds the tile's part of the 2x canvas, the tile's footprint plus the
//     FIR's halo, in shared memory: each canvas pixel sums the tent-weighted
//     cotangents of the output pixels whose source position lies within one
//     pixel of it, and a thread takes kColumnPix pixels of a canvas column
//     at a time, visiting once for them only the rows of their preimage and
//     each row's strip interval (K4's bounds); (b) it applies the transposed
//     x2 FIR from shared memory as a horizontal decimating 12-tap pass into a
//     second buffer, then the vertical one.  Halo pixels are rebuilt by the
//     neighbouring blocks.  The cotangents a block reads (the preimage box
//     of its canvas) are first copied to shared memory where they fit, else
//     (a strong zoom out, a singular map) read from device memory, a branch
//     that is uniform over the block; a counter can count those blocks.
//
// Both keep the order of the sums of their first version (one thread per
// pixel, gathers from device memory, a float32 canvas in device memory):
// K1 sums each row of the window, then the rows; K2's canvas pixel sums its
// hits in ascending oy, then ox, and the FIR sums each canvas row over its
// 12 taps, then the rows.  Zeros stand where that version skipped a sample
// outside the plane or the canvas, so both give its bits (for finite data).
//
// Coordinates: the source position of output pixel (ox, oy) on the 2x
// canvas is fx = (ax*ox + bx*oy) + cx (fy likewise), rounded operation by
// operation (no FMA contraction), as the plain PyTorch version rounds it,
// so kernel and plain version sample at bitwise-equal positions.

#include "affine.cuh"

namespace {

constexpr int kTaps = 12;  // sym6 FIR: 6 taps per polyphase branch
constexpr int kSpan = 7;   // 1x samples under one bilinear pair of 2x samples

struct Taps {
  float t[kTaps];  // FIR taps with the per-axis upsampling gain (2) folded in
};

// Tap t of the FIR, zero outside [0, kTaps).  Called with indices that
// are compile-time constants after unrolling, so the test folds away.
__device__ __forceinline__ float tap(const Taps& k, int t) {
  return (t >= 0 && t < kTaps) ? k.t[t] : 0.f;
}

// Upsampled sample v of a 1x signal x is  up[v] = sum_m k[5 + v - 2m] x[m].
// A bilinear read at 2x position f takes up[v0] and up[v0 + 1]
// (v0 = floor(f)), each zero outside the canvas [0, n2).  Writes the
// combined weights of the 1x samples m0 .. m0 + 6 into w and m0, and
// returns false (all weights zero) when both taps are off the canvas.
__device__ __forceinline__ bool axis_weights(const Taps& k, float f, int n2, float w[kSpan],
                                             int& m0) {
  const float fl = floorf(f);
  if (!(fl >= -1.f && fl <= (float)(n2 - 1))) {  // both taps off the canvas, or NaN
#pragma unroll
    for (int j = 0; j < kSpan; ++j) w[j] = 0.f;
    m0 = 0;
    return false;
  }
  const int v0 = (int)fl;
  float w1 = f - fl;
  float w0 = 1.f - w1;
  if (v0 < 0) w0 = 0.f;
  if (v0 + 1 >= n2) w1 = 0.f;
  const int r = v0 & 1;          // parity; v0 >= -1
  const int q = (v0 - r) / 2;    // floor(v0 / 2)
  // m = q - 3 + j:  tap index 11 + r - 2j for v0, 12 + r - 2j for v0 + 1.
  if (r == 0) {
#pragma unroll
    for (int j = 0; j < kSpan; ++j) w[j] = w0 * tap(k, 11 - 2 * j) + w1 * tap(k, 12 - 2 * j);
  } else {
#pragma unroll
    for (int j = 0; j < kSpan; ++j) w[j] = w0 * tap(k, 12 - 2 * j) + w1 * tap(k, 13 - 2 * j);
  }
  m0 = q - 3;
  return true;
}

// The first (lo) or last 1x sample an axis of the window reaches from 2x
// positions up to f, f finite: floor(f) clamped to the canvas [-1, n2 - 1]
// as ``axis_weights`` takes it, halved, and 3 samples on.
__device__ __forceinline__ int window_lo(float f, int n2) {
  return ((int)floorf(fminf(fmaxf(f, -1.f), (float)(n2 - 1))) >> 1) - 3;
}
__device__ __forceinline__ int window_hi(float f, int n2) {
  return ((int)floorf(fminf(fmaxf(f, -1.f), (float)(n2 - 1))) >> 1) + 3;
}

// K1: a block owns a kUpTX x kUpTY tile of outputs, a thread one column of
// kUpRows of them (rows kUpTY / kUpRows apart).
constexpr int kUpTX = 32, kUpTY = 32, kUpRows = 4;
constexpr int kUpThreads = kUpTX * kUpTY / kUpRows;
constexpr int kBoxCap = 4096;  // float32 samples of the staged box (16 KB)

template <typename T>
__global__ void __launch_bounds__(kUpThreads)
upwarp_kernel(const T* __restrict__ img, const float* __restrict__ coeffs, T* __restrict__ out,
              int H1, int W1, int OH, int OW, Taps k, unsigned int* __restrict__ direct_blocks) {
  __shared__ float box[kBoxCap];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ox0 = blockIdx.x * kUpTX, oy0 = blockIdx.y * kUpTY, p = blockIdx.z;
  const int W2 = 2 * W1, H2 = 2 * H1;
  const Coef c = load_coef(coeffs, p);
  const T* plane = img + (size_t)p * H1 * W1;

  // The box of the 1x plane the tile's outputs can weigh.  Positions move
  // monotonically with ox and oy (each rounding is monotone), so the
  // tile's four corners bound every position inside it.
  const float cx0 = (float)ox0, cx1 = (float)(min(ox0 + kUpTX, OW) - 1);
  const float cy0 = (float)oy0, cy1 = (float)(min(oy0 + kUpTY, OH) - 1);
  float xmin = INFINITY, xmax = -INFINITY, ymin = INFINITY, ymax = -INFINITY;
  bool finite = true;
#pragma unroll
  for (int corner = 0; corner < 4; ++corner) {
    const float fox = corner & 1 ? cx1 : cx0, foy = corner & 2 ? cy1 : cy0;
    const float fx = src_pos(c.ax, c.bx, c.cx, fox, foy), fy = src_pos(c.ay, c.by, c.cy, fox, foy);
    finite = finite && isfinite(fx) && isfinite(fy);
    xmin = fminf(xmin, fx); xmax = fmaxf(xmax, fx);
    ymin = fminf(ymin, fy); ymax = fmaxf(ymax, fy);
  }
  int bx0 = 0, by0 = 0, bw = 0, bh = 0;
  if (finite) {
    bx0 = window_lo(xmin, W2);
    by0 = window_lo(ymin, H2);
    bw = window_hi(xmax, W2) - bx0 + 1;
    bh = window_hi(ymax, H2) - by0 + 1;
  }
  const bool staged = finite && bw <= kBoxCap && bh <= kBoxCap && bw * bh <= kBoxCap;
  if (staged) {
    for (int r = ty; r < bh; r += kUpTY / kUpRows) {
      const int my = by0 + r;
      const bool row_in = my >= 0 && my < H1;
      for (int col = tx; col < bw; col += kUpTX) {
        const int mx = bx0 + col;
        box[r * bw + col] =
            row_in && mx >= 0 && mx < W1 ? load(plane + (size_t)my * W1 + mx) : 0.f;
      }
    }
  } else if (direct_blocks != nullptr && tx == 0 && ty == 0) {
    atomicAdd(direct_blocks, 1u);
  }
  __syncthreads();

#pragma unroll
  for (int rr = 0; rr < kUpRows; ++rr) {
    const int ox = ox0 + tx, oy = oy0 + ty + rr * (kUpTY / kUpRows);
    if (ox >= OW || oy >= OH) continue;
    const float fox = (float)ox, foy = (float)oy;
    float wx[kSpan], wy[kSpan];
    int mx0, my0;
    const bool on_x = axis_weights(k, src_pos(c.ax, c.bx, c.cx, fox, foy), W2, wx, mx0);
    const bool on_y = axis_weights(k, src_pos(c.ay, c.by, c.cy, fox, foy), H2, wy, my0);
    float acc = 0.f;
    if (on_x && on_y && staged) {
      // The window lies inside the box; samples off the plane are zeros.
      const float* win = box + (my0 - by0) * bw + (mx0 - bx0);
#pragma unroll
      for (int i = 0; i < kSpan; ++i) {
        if (wy[i] == 0.f) continue;
        const float* row = win + i * bw;
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < kSpan; ++j) s += wx[j] * row[j];
        acc += wy[i] * s;
      }
    } else if (on_x && on_y) {
      // Direct gather from device memory, skipping samples off the plane.
#pragma unroll
      for (int i = 0; i < kSpan; ++i) {
        const int my = my0 + i;
        if (wy[i] == 0.f || my < 0 || my >= H1) continue;
        const T* row = plane + (size_t)my * W1;
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < kSpan; ++j) {
          const int mx = mx0 + j;
          if (mx >= 0 && mx < W1) s += wx[j] * load(row + mx);
        }
        acc += wy[i] * s;
      }
    }
    store(out + ((size_t)p * OH + oy) * OW + ox, acc);
  }
}

// K2: a block owns a kSplatTW x kSplatTH tile of the 1x output.  Output m
// of an axis takes canvas pixels 2m - 5 .. 2m + 6, so the tile's part of
// the canvas is kCanvasW x kCanvasH from (2 mx0 - 5, 2 my0 - 5).
constexpr int kSplatTW = 32, kSplatTH = 32, kSplatThreads = 256;
constexpr int kCanvasW = 2 * kSplatTW + kTaps - 2, kCanvasH = 2 * kSplatTH + kTaps - 2;
constexpr int kHalo = kTaps / 2 - 1;
// Bytes of the staged cotangent box, which shares its buffer with the
// horizontal pass's output.
constexpr int kGBoxBytes = 16384;
constexpr int kHSumBytes = kCanvasH * kSplatTW * (int)sizeof(float);
constexpr int kScratchBytes = kGBoxBytes > kHSumBytes ? kGBoxBytes : kHSumBytes;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// Where pass (a) reads the cotangent: the plane in device memory, or the
// box r0.., c0.. of it staged in shared memory.
template <typename T>
struct GlobalRows {
  const T* plane;
  int pitch;
  __device__ __forceinline__ float at(int oy, int ox) const {
    return load(plane + (size_t)oy * pitch + ox);
  }
};

template <typename T>
struct SharedRows {
  const T* box;
  int r0, c0, pitch;
  __device__ __forceinline__ float at(int oy, int ox) const {
    return to_float(box[(oy - r0) * pitch + (ox - c0)]);
  }
};

// Canvas pixels (vx, vy + k), k < n <= N, of a column: each sums, in
// ascending oy then ox, the tent-weighted cotangents of its hits, the
// output pixels whose source position lies within one pixel of it.  They
// share the candidates: the rows and per-row intervals of their preimage
// (the union of each pixel's, K4's bounds) or, for a singular map, the
// plane.
template <int N, class Src>
__device__ __forceinline__ void splat_column(const Coef& c, const Preimage& m, const Src& src,
                                             float fvx, float fvy, int n, int OH, int OW,
                                             float (&acc)[N]) {
  const float fvy_last = fvy + (float)(n - 1);
  int c0 = 0, c1 = OW - 1, r0 = 0, r1 = OH - 1;
  if (m.bounded) preimage_box(m, c, fvx, fvx, fvy, fvy_last, OH, OW, c0, c1, r0, r1);
  const float kx0 = (fvx - c.cx) * m.sx.r;
  const float ky_first = (fvy - c.cy) * m.sy.r, ky_last = (fvy_last - c.cy) * m.sy.r;
  for (int oy = r0; oy <= r1; ++oy) {
    const float foy = (float)oy;
    float lo = (float)c0, hi = (float)c1;
    if (m.bounded) {
      strip_clip(m.sx, foy, kx0, kx0, lo, hi);
      strip_clip(m.sy, foy, ky_first, ky_last, lo, hi);
      if (!(lo <= hi)) continue;
    }
    for (int ox = (int)ceilf(lo); ox <= (int)floorf(hi); ++ox) {
      const float fox = (float)ox;
      const float dx = fabsf(src_pos(c.ax, c.bx, c.cx, fox, foy) - fvx);
      if (!(dx < 1.f)) continue;
      const float fy = src_pos(c.ay, c.by, c.cy, fox, foy);
      float dy[N];
      bool hit[N], any = false;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        dy[k] = fabsf(fy - (fvy + (float)k));
        hit[k] = k < n && dy[k] < 1.f;
        any = any || hit[k];
      }
      if (!any) continue;
      const float v = src.at(oy, ox);
#pragma unroll
      for (int k = 0; k < N; ++k)
        if (hit[k]) acc[k] += (1.f - dx) * (1.f - dy[k]) * v;
    }
  }
}

// Pass (a) over the block's canvas: a thread takes kColumnPix rows of one
// canvas column at a time, fewer at the tile's last rows (a pixel beyond
// them has hits outside the staged box); pixels off the canvas [0, W2) x
// [0, H2) are zeros.
constexpr int kColumnPix = 4;
constexpr int kColumnRuns = (kCanvasH + kColumnPix - 1) / kColumnPix;

template <class Src>
__device__ __forceinline__ void splat_canvas(float* canvas, const Coef& c, const Preimage& m,
                                             const Src& src, int vx0, int vy0, int H2, int W2,
                                             int OH, int OW) {
  for (int i = threadIdx.x; i < kCanvasW * kColumnRuns; i += kSplatThreads) {
    const int cx = i % kCanvasW, cy = kColumnPix * (i / kCanvasW);
    const int vx = vx0 + cx, vy = vy0 + cy;
    const bool in_x = vx >= 0 && vx < W2;
    const int n = min(kColumnPix, kCanvasH - cy);
    bool in[kColumnPix], any = false;
    float acc[kColumnPix];
#pragma unroll
    for (int k = 0; k < kColumnPix; ++k) {
      in[k] = in_x && k < n && vy + k >= 0 && vy + k < H2;
      any = any || in[k];
      acc[k] = 0.f;
    }
    if (any) splat_column(c, m, src, (float)vx, (float)vy, n, OH, OW, acc);
#pragma unroll
    for (int k = 0; k < kColumnPix; ++k)
      if (k < n) canvas[(cy + k) * kCanvasW + cx] = in[k] ? acc[k] : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kSplatThreads)
upsplat_kernel(const T* __restrict__ g, const float* __restrict__ coeffs, T* __restrict__ out,
               int H1, int W1, int OH, int OW, Taps k, unsigned int* __restrict__ global_blocks) {
  __shared__ float canvas[kCanvasH * kCanvasW];
  __shared__ __align__(16) unsigned char scratch[kScratchBytes];
  float* hsum = reinterpret_cast<float*>(scratch);
  const int mx0 = blockIdx.x * kSplatTW, my0 = blockIdx.y * kSplatTH, p = blockIdx.z;
  const int vx0 = 2 * mx0 - kHalo, vy0 = 2 * my0 - kHalo;
  const int H2 = 2 * H1, W2 = 2 * W1;
  const Coef c = load_coef(coeffs, p);
  const T* gp = g + (size_t)p * OH * OW;

  // (a) The block's canvas.
  if (!coef_finite(c)) {
    // Non-finite coefficients: K1 wrote zeros, so the adjoint is zero.
    for (int i = threadIdx.x; i < kCanvasH * kCanvasW; i += kSplatThreads) canvas[i] = 0.f;
  } else {
    const Preimage m = preimage_of(c, H2, W2, OH, OW);
    bool staged = false;
    if (m.bounded) {
      // Every candidate of the block lies in the preimage box of its whole
      // canvas (the corners of a pair's box lie inside the block's).
      int c0, c1, r0, r1;
      preimage_box(m, c, (float)vx0, (float)(vx0 + kCanvasW - 1), (float)vy0,
                   (float)(vy0 + kCanvasH - 1), OH, OW, c0, c1, r0, r1);
      const int bw = max(c1 - c0 + 1, 0), bh = max(r1 - r0 + 1, 0);
      staged = (long long)bw * bh * (long long)sizeof(T) <= kGBoxBytes;
      if (staged) {
        T* gbox = reinterpret_cast<T*>(scratch);
        const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
        for (int r = warp; r < bh; r += kSplatThreads / 32)
          for (int col = lane; col < bw; col += 32)
            gbox[r * bw + col] = gp[(size_t)(r0 + r) * OW + c0 + col];
        __syncthreads();
        splat_canvas(canvas, c, m, SharedRows<T>{gbox, r0, c0, bw}, vx0, vy0, H2, W2, OH, OW);
      }
    }
    if (!staged) {
      if (global_blocks != nullptr && threadIdx.x == 0) atomicAdd(global_blocks, 1u);
      splat_canvas(canvas, c, m, GlobalRows<T>{gp, OW}, vx0, vy0, H2, W2, OH, OW);
    }
  }
  __syncthreads();

  // (b) The transposed x2 FIR: gx[m] = sum_t k[t] * S[2m - 5 + t] per axis,
  // first along each canvas row, then down the columns.
  for (int i = threadIdx.x; i < kCanvasH * kSplatTW; i += kSplatThreads) {
    const float* row = canvas + (i / kSplatTW) * kCanvasW + 2 * (i % kSplatTW);
    float s = 0.f;
#pragma unroll
    for (int tx = 0; tx < kTaps; ++tx) s += k.t[tx] * row[tx];
    hsum[i] = s;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kSplatTH * kSplatTW; i += kSplatThreads) {
    const int my = i / kSplatTW, mx = i % kSplatTW;
    if (my0 + my >= H1 || mx0 + mx >= W1) continue;
    const float* col = hsum + 2 * my * kSplatTW + mx;
    float acc = 0.f;
#pragma unroll
    for (int ty = 0; ty < kTaps; ++ty) acc += k.t[ty] * col[ty * kSplatTW];
    store(out + ((size_t)p * H1 + my0 + my) * W1 + mx0 + mx, acc);
  }
}

Taps make_taps(const float* fir) {
  Taps k;
  for (int i = 0; i < kTaps; ++i) k.t[i] = 2.f * fir[i];
  return k;
}

dim3 grid_for(int w, int h, int planes, int tw, int th) {
  return dim3((w + tw - 1) / tw, (h + th - 1) / th, planes);
}

}  // namespace

// All entry points launch on ``stream`` and return cudaGetLastError().
// ``fir`` is a host array of 12 taps; ``is_bf16`` selects the element
// type of the image/cotangent tensors (bf16 or f32); sums are f32.

// K1: img [P, H1, W1] -> out [P, OH, OW].  ``direct_blocks``, if not null,
// is a device counter that each block taking the direct gather adds 1 to.
extern "C" int gantrack_upwarp(const void* img, const float* coeffs, void* out, int P, int H1,
                               int W1, int OH, int OW, int is_bf16, const float* fir,
                               unsigned int* direct_blocks, void* stream) {
  const Taps k = make_taps(fir);
  const dim3 block(kUpTX, kUpTY / kUpRows);
  const dim3 grid = grid_for(OW, OH, P, kUpTX, kUpTY);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    upwarp_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        (const __nv_bfloat16*)img, coeffs, (__nv_bfloat16*)out, H1, W1, OH, OW, k, direct_blocks);
  } else {
    upwarp_kernel<float><<<grid, block, 0, s>>>((const float*)img, coeffs, (float*)out, H1, W1,
                                                OH, OW, k, direct_blocks);
  }
  return (int)cudaGetLastError();
}

// The number of blocks K1 launches for P planes of OH x OW outputs.
extern "C" long long gantrack_upwarp_blocks(int P, int OH, int OW) {
  const dim3 grid = grid_for(OW, OH, P, kUpTX, kUpTY);
  return (long long)grid.x * grid.y * grid.z;
}

// K2: g [P, OH, OW] -> out [P, H1, W1], one launch.  ``global_blocks``, if
// not null, is a device counter that each block reading its cotangents from
// device memory (its box did not fit shared memory) adds 1 to.
extern "C" int gantrack_upsplat(const void* g, const float* coeffs, void* out, int P, int H1,
                                int W1, int OH, int OW, int is_bf16, const float* fir,
                                unsigned int* global_blocks, void* stream) {
  const Taps k = make_taps(fir);
  const dim3 grid = grid_for(W1, H1, P, kSplatTW, kSplatTH);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    upsplat_kernel<__nv_bfloat16><<<grid, kSplatThreads, 0, s>>>(
        (const __nv_bfloat16*)g, coeffs, (__nv_bfloat16*)out, H1, W1, OH, OW, k, global_blocks);
  } else {
    upsplat_kernel<float><<<grid, kSplatThreads, 0, s>>>((const float*)g, coeffs, (float*)out, H1,
                                                         W1, OH, OW, k, global_blocks);
  }
  return (int)cudaGetLastError();
}

// The number of blocks K2 launches for P planes of H1 x W1 outputs.
extern "C" long long gantrack_upsplat_blocks(int P, int H1, int W1) {
  const dim3 grid = grid_for(W1, H1, P, kSplatTW, kSplatTH);
  return (long long)grid.x * grid.y * grid.z;
}
