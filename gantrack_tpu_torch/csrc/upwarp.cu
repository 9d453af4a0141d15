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
// What bounds these kernels on the H100: neither is bound by device
// memory (K1 reads ~42 MB and writes ~35 MB in bf16 at the training
// shapes) or by arithmetic.  Both are gathers, bound by L1 load
// throughput and latency.  The design cuts the loads per output:
//   * K1 folds the two bilinear taps of each axis and the 12-tap
//     polyphase FIR into 7 weights per axis (one bilinear pair of 2x
//     samples spans 7 samples of the 1x plane), so a pixel reads 7x7 = 49
//     input values instead of 4 x 6 x 6 = 144.
//   * K2 is written as a gather, so it needs no atomics and is bitwise
//     deterministic: pass (a) gathers, for every 2x-canvas pixel, the
//     output pixels whose bilinear footprint covers it (found through the
//     inverse affine map) into an f32 scratch; pass (b) applies the
//     transposed x2 FIR (a decimating 12x12 stencil) to reach the 1x plane.
// Tiling through shared memory and fusing (a) with (b) are later work.
//
// Coordinates: the source position of output pixel (ox, oy) on the 2x
// canvas is fx = (ax*ox + bx*oy) + cx (fy likewise), rounded operation by
// operation (no FMA contraction), as the plain PyTorch version rounds it,
// so kernel and plain version sample at bitwise-equal positions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kTaps = 12;  // sym6 FIR: 6 taps per polyphase branch
constexpr int kSpan = 7;   // 1x samples under one bilinear pair of 2x samples

struct Taps {
  float t[kTaps];  // FIR taps with the per-axis upsampling gain (2) folded in
};

struct Coef {
  float ax, bx, cx, ay, by, cy;
};

__device__ __forceinline__ Coef load_coef(const float* __restrict__ c, int p) {
  const float* q = c + 6 * p;
  return {q[0], q[1], q[2], q[3], q[4], q[5]};
}

__device__ __forceinline__ float src_pos(float a, float b, float c, float ox, float oy) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, ox), __fmul_rn(b, oy)), c);
}

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Tap t of the FIR, zero outside [0, kTaps).  Called with indices that
// are compile-time constants after unrolling, so the test folds away.
__device__ __forceinline__ float tap(const Taps& k, int t) {
  return (t >= 0 && t < kTaps) ? k.t[t] : 0.f;
}

// Upsampled sample v of a 1x signal x is  up[v] = sum_m k[5 + v - 2m] x[m].
// A bilinear read at 2x position f takes up[v0] and up[v0 + 1]
// (v0 = floor(f)), each zero outside the canvas [0, n2).  Writes the
// combined weights of the 1x samples m0 .. m0 + 6 into w and returns m0.
__device__ __forceinline__ int axis_weights(const Taps& k, float f, int n2, float w[kSpan]) {
  const float fl = floorf(f);
  if (!(fl >= -1.f && fl <= (float)(n2 - 1))) {  // both taps off the canvas, or NaN
#pragma unroll
    for (int j = 0; j < kSpan; ++j) w[j] = 0.f;
    return 0;
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
  return q - 3;
}

// K1: one thread per output pixel.
template <typename T>
__global__ void upwarp_kernel(const T* __restrict__ img, const float* __restrict__ coeffs,
                              T* __restrict__ out, int H1, int W1, int OH, int OW, Taps k) {
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  const int oy = blockIdx.y * blockDim.y + threadIdx.y;
  const int p = blockIdx.z;
  if (ox >= OW || oy >= OH) return;
  const Coef c = load_coef(coeffs, p);
  const float fox = (float)ox, foy = (float)oy;
  float wx[kSpan], wy[kSpan];
  const int mx0 = axis_weights(k, src_pos(c.ax, c.bx, c.cx, fox, foy), 2 * W1, wx);
  const int my0 = axis_weights(k, src_pos(c.ay, c.by, c.cy, fox, foy), 2 * H1, wy);
  const T* plane = img + (size_t)p * H1 * W1;
  float acc = 0.f;
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
  store(out + ((size_t)p * OH + oy) * OW + ox, acc);
}

// K2 pass (a): one thread per 2x-canvas pixel v; gathers the tent-weighted
// cotangents of the output pixels whose source position lies within one
// pixel of v.  Tent weights equal K1's bilinear weights exactly.
template <typename T>
__global__ void splat2x_kernel(const T* __restrict__ g, const float* __restrict__ coeffs,
                               float* __restrict__ canvas, int H2, int W2, int OH, int OW) {
  const int vx = blockIdx.x * blockDim.x + threadIdx.x;
  const int vy = blockIdx.y * blockDim.y + threadIdx.y;
  const int p = blockIdx.z;
  if (vx >= W2 || vy >= H2) return;
  const Coef c = load_coef(coeffs, p);
  const float fvx = (float)vx, fvy = (float)vy;
  float acc = 0.f;
  const bool finite = isfinite(c.ax) && isfinite(c.bx) && isfinite(c.cx) &&
                      isfinite(c.ay) && isfinite(c.by) && isfinite(c.cy);
  if (finite) {  // non-finite coefficients: K1 wrote zeros, so the adjoint is zero
    int ox_lo = 0, ox_hi = OW - 1, oy_lo = 0, oy_hi = OH - 1;
    const float det = c.ax * c.by - c.bx * c.ay;
    if (det != 0.f) {
      // Bounding box of the preimage of the square v + (-1, 1)^2, widened
      // by one pixel to absorb the rounding of the inverse map.
      const float ia = c.by / det, ib = -c.bx / det, ic = -c.ay / det, id = c.ax / det;
      float xmin = INFINITY, xmax = -INFINITY, ymin = INFINITY, ymax = -INFINITY;
#pragma unroll
      for (int sy = -1; sy <= 1; sy += 2) {
#pragma unroll
        for (int sx = -1; sx <= 1; sx += 2) {
          const float px = fvx + sx - c.cx, py = fvy + sy - c.cy;
          const float qx = ia * px + ib * py, qy = ic * px + id * py;
          xmin = fminf(xmin, qx); xmax = fmaxf(xmax, qx);
          ymin = fminf(ymin, qy); ymax = fmaxf(ymax, qy);
        }
      }
      ox_lo = max(ox_lo, (int)floorf(fmaxf(xmin, -2.f)) - 1);
      ox_hi = min(ox_hi, (int)ceilf(fminf(xmax, (float)OW + 1.f)) + 1);
      oy_lo = max(oy_lo, (int)floorf(fmaxf(ymin, -2.f)) - 1);
      oy_hi = min(oy_hi, (int)ceilf(fminf(ymax, (float)OH + 1.f)) + 1);
    }
    const T* gp = g + (size_t)p * OH * OW;
    for (int oy = oy_lo; oy <= oy_hi; ++oy) {
      const float foy = (float)oy;
      for (int ox = ox_lo; ox <= ox_hi; ++ox) {
        const float fox = (float)ox;
        const float dx = fabsf(src_pos(c.ax, c.bx, c.cx, fox, foy) - fvx);
        if (dx >= 1.f) continue;
        const float dy = fabsf(src_pos(c.ay, c.by, c.cy, fox, foy) - fvy);
        if (dy >= 1.f) continue;
        acc += (1.f - dx) * (1.f - dy) * load(gp + (size_t)oy * OW + ox);
      }
    }
  }
  canvas[((size_t)p * H2 + vy) * W2 + vx] = acc;
}

// K2 pass (b): transposed x2 FIR, one thread per 1x pixel m:
//   gx[m] = sum_t k[t] * S[2m - 5 + t]   (per axis, over the canvas).
template <typename T>
__global__ void fir_down_kernel(const float* __restrict__ canvas, T* __restrict__ out,
                                int H1, int W1, Taps k) {
  const int mx = blockIdx.x * blockDim.x + threadIdx.x;
  const int my = blockIdx.y * blockDim.y + threadIdx.y;
  const int p = blockIdx.z;
  if (mx >= W1 || my >= H1) return;
  const int H2 = 2 * H1, W2 = 2 * W1;
  const float* cp = canvas + (size_t)p * H2 * W2;
  const int vx0 = 2 * mx - 5, vy0 = 2 * my - 5;
  float acc = 0.f;
#pragma unroll
  for (int ty = 0; ty < kTaps; ++ty) {
    const int vy = vy0 + ty;
    if (vy < 0 || vy >= H2) continue;
    const float* row = cp + (size_t)vy * W2;
    float s = 0.f;
#pragma unroll
    for (int tx = 0; tx < kTaps; ++tx) {
      const int vx = vx0 + tx;
      if (vx >= 0 && vx < W2) s += k.t[tx] * __ldg(row + vx);
    }
    acc += k.t[ty] * s;
  }
  store(out + ((size_t)p * H1 + my) * W1 + mx, acc);
}

Taps make_taps(const float* fir) {
  Taps k;
  for (int i = 0; i < kTaps; ++i) k.t[i] = 2.f * fir[i];
  return k;
}

dim3 grid_for(int w, int h, int planes, dim3 block) {
  return dim3((w + block.x - 1) / block.x, (h + block.y - 1) / block.y, planes);
}

}  // namespace

// All entry points launch on ``stream`` and return cudaGetLastError().
// ``fir`` is a host array of 12 taps; ``is_bf16`` selects the element
// type of the image/cotangent tensors (bf16 or f32); sums are f32.

extern "C" int gantrack_upwarp(const void* img, const float* coeffs, void* out, int P, int H1,
                               int W1, int OH, int OW, int is_bf16, const float* fir,
                               void* stream) {
  const Taps k = make_taps(fir);
  const dim3 block(32, 8);
  const dim3 grid = grid_for(OW, OH, P, block);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    upwarp_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        (const __nv_bfloat16*)img, coeffs, (__nv_bfloat16*)out, H1, W1, OH, OW, k);
  } else {
    upwarp_kernel<float><<<grid, block, 0, s>>>((const float*)img, coeffs, (float*)out, H1,
                                                W1, OH, OW, k);
  }
  return (int)cudaGetLastError();
}

// ``canvas`` is f32 scratch of P * 2H1 * 2W1 elements.
extern "C" int gantrack_upsplat(const void* g, const float* coeffs, float* canvas, void* out,
                                int P, int H1, int W1, int OH, int OW, int is_bf16,
                                const float* fir, void* stream) {
  const Taps k = make_taps(fir);
  const dim3 block(32, 8);
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid_a = grid_for(2 * W1, 2 * H1, P, block);
  const dim3 grid_b = grid_for(W1, H1, P, block);
  if (is_bf16) {
    splat2x_kernel<__nv_bfloat16><<<grid_a, block, 0, s>>>(
        (const __nv_bfloat16*)g, coeffs, canvas, 2 * H1, 2 * W1, OH, OW);
  } else {
    splat2x_kernel<float><<<grid_a, block, 0, s>>>((const float*)g, coeffs, canvas, 2 * H1,
                                                   2 * W1, OH, OW);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (is_bf16) {
    fir_down_kernel<__nv_bfloat16><<<grid_b, block, 0, s>>>(canvas, (__nv_bfloat16*)out, H1,
                                                            W1, k);
  } else {
    fir_down_kernel<float><<<grid_b, block, 0, s>>>(canvas, (float*)out, H1, W1, k);
  }
  return (int)cudaGetLastError();
}
