// Affine bilinear warp (K3) and its exact adjoint, the splat (K4), for
// NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels ``_warp_kernel`` and ``_splat_kernel``
// of gantrack_tpu/ops/pallas/warp.py.  K3 computes, per plane,
//     out = grid_sample(x, affine_grid(theta))
// (bilinear, zeros padding, align_corners=False) from six float32
// pixel-space coefficients; K4 is its transpose, so the two are each
// other's VJP and any order of autodiff closes (R1 differentiates through
// the augmentation's warp twice).
//
// What is ported is the arithmetic, not the TPU form: the one-hot hat
// matmuls, the static [wr, wc] source window, the 8/128 alignment of the
// window origin and the right/bottom zero pad were there for the TPU's
// layout and are gone.  With no window there is no tail clipping: K3
// equals the plain gather sampler for every transform, up to the order of
// the f32 sums.
//
// What bounds these kernels on the H100: device memory.  K3 reads each
// input pixel about once (neighbouring threads share cache lines) and
// writes each output once; four loads, ~20 flops a pixel.  K4 is written
// as a gather, so it needs no atomics, no zero-filled f32 canvas, and is
// bitwise deterministic: one thread per INPUT pixel v finds, through the
// inverse affine map, the bounding box of the output pixels whose source
// position lies within one pixel of v and sums their tent-weighted
// cotangents in f32 in a fixed order, then stores once in the cotangent's
// type.  For a unit-scale transform the box holds ~25 candidates of which
// ~4 hit.  A singular 2x2 matrix (det == 0, or an inverse that is not
// finite) has no bounded footprint: the thread then scans the whole
// output plane, which is slow and still exact.  Non-finite coefficients
// give zeros in both kernels.
//
// Coordinates: the source position of output pixel (ox, oy) is
// fx = (ax*ox + bx*oy) + cx (fy likewise), rounded operation by operation
// (no FMA contraction), as the plain PyTorch version rounds it, so kernel
// and plain version sample at bitwise-equal positions.
//
// Planes go to grid.z, at most 65535 of it; a block walks the planes
// p, p + gridDim.z, ... so any plane count runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kMaxGridZ = 65535;

struct Coef {
  float ax, bx, cx, ay, by, cy;
};

__device__ __forceinline__ Coef load_coef(const float* __restrict__ c, int p) {
  const float* q = c + 6 * (size_t)p;
  return {q[0], q[1], q[2], q[3], q[4], q[5]};
}

__device__ __forceinline__ bool coef_finite(const Coef& c) {
  return isfinite(c.ax) && isfinite(c.bx) && isfinite(c.cx) && isfinite(c.ay) &&
         isfinite(c.by) && isfinite(c.cy);
}

__device__ __forceinline__ float src_pos(float a, float b, float c, float ox, float oy) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, ox), __fmul_rn(b, oy)), c);
}

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// The two bilinear taps of one axis at position f on an axis of n
// samples: indices i0, i0 + 1 with weights w0, w1, zero outside [0, n).
// Returns false when both taps are off the axis (or f is NaN).
__device__ __forceinline__ bool axis_taps(float f, int n, int& i0, float& w0, float& w1) {
  const float fl = floorf(f);
  if (!(fl >= -1.f && fl <= (float)(n - 1))) return false;
  i0 = (int)fl;
  w1 = f - fl;
  w0 = 1.f - w1;
  if (i0 < 0) w0 = 0.f;
  if (i0 + 1 >= n) w1 = 0.f;
  return true;
}

// K3: one thread per output pixel, four taps, f32 sum.
template <typename T>
__global__ void warp_kernel(const T* __restrict__ img, const float* __restrict__ coeffs,
                            T* __restrict__ out, int P, int H, int W, int OH, int OW) {
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  const int oy = blockIdx.y * blockDim.y + threadIdx.y;
  if (ox >= OW || oy >= OH) return;
  const float fox = (float)ox, foy = (float)oy;
  for (int p = blockIdx.z; p < P; p += gridDim.z) {
    const Coef c = load_coef(coeffs, p);
    int x0 = 0, y0 = 0;
    float wx0 = 0.f, wx1 = 0.f, wy0 = 0.f, wy1 = 0.f;
    float acc = 0.f;
    if (axis_taps(src_pos(c.ax, c.bx, c.cx, fox, foy), W, x0, wx0, wx1) &&
        axis_taps(src_pos(c.ay, c.by, c.cy, fox, foy), H, y0, wy0, wy1)) {
      const T* plane = img + (size_t)p * H * W;
      float top = 0.f, bot = 0.f;
      if (wy0 != 0.f) {
        const T* row = plane + (size_t)y0 * W;
        if (wx0 != 0.f) top += wx0 * load(row + x0);
        if (wx1 != 0.f) top += wx1 * load(row + x0 + 1);
      }
      if (wy1 != 0.f) {
        const T* row = plane + (size_t)(y0 + 1) * W;
        if (wx0 != 0.f) bot += wx0 * load(row + x0);
        if (wx1 != 0.f) bot += wx1 * load(row + x0 + 1);
      }
      acc = wy0 * top + wy1 * bot;
    }
    store(out + ((size_t)p * OH + oy) * OW + ox, acc);
  }
}

// K4: one thread per input pixel v; gathers the tent-weighted cotangents
// of the output pixels whose source position lies within one pixel of v.
// The tent weights (1 - |fx - vx|)(1 - |fy - vy|) are K3's bilinear
// weights.
template <typename T>
__global__ void splat_kernel(const T* __restrict__ g, const float* __restrict__ coeffs,
                             T* __restrict__ out, int P, int H, int W, int OH, int OW) {
  const int vx = blockIdx.x * blockDim.x + threadIdx.x;
  const int vy = blockIdx.y * blockDim.y + threadIdx.y;
  if (vx >= W || vy >= H) return;
  const float fvx = (float)vx, fvy = (float)vy;
  for (int p = blockIdx.z; p < P; p += gridDim.z) {
    const Coef c = load_coef(coeffs, p);
    float acc = 0.f;
    if (coef_finite(c)) {  // non-finite coefficients: K3 wrote zeros, so the adjoint is zero
      int ox_lo = 0, ox_hi = OW - 1, oy_lo = 0, oy_hi = OH - 1;
      const float det = c.ax * c.by - c.bx * c.ay;
      const float ia = c.by / det, ib = -c.bx / det, ic = -c.ay / det, id = c.ax / det;
      if (det != 0.f && isfinite(ia) && isfinite(ib) && isfinite(ic) && isfinite(id)) {
        // Bounding box of the preimage of the square v + (-1, 1)^2, widened
        // by one pixel to absorb the rounding of the inverse map.
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
        // Clamped to the plane (and a little beyond) before the casts, so
        // a far-away preimage gives an empty range, not an overflow.
        const float xhi = (float)OW + 1.f, yhi = (float)OH + 1.f;
        ox_lo = max(ox_lo, (int)floorf(fminf(fmaxf(xmin, -2.f), xhi)) - 1);
        ox_hi = min(ox_hi, (int)ceilf(fminf(fmaxf(xmax, -2.f), xhi)) + 1);
        oy_lo = max(oy_lo, (int)floorf(fminf(fmaxf(ymin, -2.f), yhi)) - 1);
        oy_hi = min(oy_hi, (int)ceilf(fminf(fmaxf(ymax, -2.f), yhi)) + 1);
      }
      const T* gp = g + (size_t)p * OH * OW;
      for (int oy = oy_lo; oy <= oy_hi; ++oy) {
        const float foy = (float)oy;
        for (int ox = ox_lo; ox <= ox_hi; ++ox) {
          const float fox = (float)ox;
          const float dx = fabsf(src_pos(c.ax, c.bx, c.cx, fox, foy) - fvx);
          if (!(dx < 1.f)) continue;
          const float dy = fabsf(src_pos(c.ay, c.by, c.cy, fox, foy) - fvy);
          if (!(dy < 1.f)) continue;
          acc += (1.f - dx) * (1.f - dy) * load(gp + (size_t)oy * OW + ox);
        }
      }
    }
    store(out + ((size_t)p * H + vy) * W + vx, acc);
  }
}

dim3 grid_for(int w, int h, int planes, dim3 block) {
  return dim3((w + block.x - 1) / block.x, (h + block.y - 1) / block.y,
              planes < kMaxGridZ ? planes : kMaxGridZ);
}

}  // namespace

// Both entry points launch on ``stream`` and return cudaGetLastError().
// ``coeffs`` is [P, 6] float32 (ax, bx, cx, ay, by, cy); ``is_bf16``
// selects the element type of the image/cotangent tensors (bf16 or f32);
// sums are f32.

// K3: img [P, H, W] -> out [P, OH, OW].
extern "C" int gantrack_warp(const void* img, const float* coeffs, void* out, int P, int H,
                             int W, int OH, int OW, int is_bf16, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid = grid_for(OW, OH, P, block);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    warp_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        (const __nv_bfloat16*)img, coeffs, (__nv_bfloat16*)out, P, H, W, OH, OW);
  } else {
    warp_kernel<float><<<grid, block, 0, s>>>((const float*)img, coeffs, (float*)out, P, H, W,
                                              OH, OW);
  }
  return (int)cudaGetLastError();
}

// K4: g [P, OH, OW] -> out [P, H, W].
extern "C" int gantrack_splat(const void* g, const float* coeffs, void* out, int P, int H,
                              int W, int OH, int OW, int is_bf16, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid = grid_for(W, H, P, block);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    splat_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        (const __nv_bfloat16*)g, coeffs, (__nv_bfloat16*)out, P, H, W, OH, OW);
  } else {
    splat_kernel<float><<<grid, block, 0, s>>>((const float*)g, coeffs, (float*)out, P, H, W,
                                               OH, OW);
  }
  return (int)cudaGetLastError();
}
