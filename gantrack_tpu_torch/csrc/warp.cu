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
// What bounds these kernels on the H100.  K3 reads the input samples its
// outputs' taps reach (at the unfused augment's draws about 42 % of the
// padded canvas) and writes each output once; ~20 flops a pixel.  A thread
// takes two adjacent outputs of two rows and gathers each one's four taps
// from device memory (neighbouring threads share cache lines); a block
// walks its 32 x 32 tile through several planes.  So the per-output work,
// which holds K3 (positions rounded operation by operation, both axes'
// taps and weights, a store), is shared where it can be: a column's and a
// row's products, one paired store.  Staging each tile's input box in
// shared memory first was tried and was slower than this gather.  The taps
// and the order of the f32 sums are those of the first, one-thread-a-pixel
// version, so it gives that version's bits.
//
// K4 is written as a gather, so it needs no atomics, no zero-filled f32
// canvas, and is bitwise deterministic: each input pixel v sums, in a
// fixed order, the tent-weighted cotangents of the output pixels whose
// source position lies within one pixel of it, and stores once in the
// cotangent's type; it visits only the candidates that the inverse map and
// the two strips leave, about as many as hit.  A singular 2x2 matrix
// (det == 0, or an inverse that is not finite) has no bounded footprint:
// the thread then scans the whole output plane, which is slow and still
// exact.
// Non-finite coefficients give zeros in both kernels.
//
// Coordinates: the source position of output pixel (ox, oy) is
// fx = (ax*ox + bx*oy) + cx (fy likewise), rounded operation by operation
// (no FMA contraction), as the plain PyTorch version rounds it, so kernel
// and plain version sample at bitwise-equal positions.
//
// Planes go to grid.z, at most 65535 of it; a block walks the planes
// p, p + gridDim.z, ... so any plane count runs (K3's blocks walk several
// by design).

#include "affine.cuh"

namespace {

constexpr int kMaxGridZ = 65535;

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

// The bilinear sample of ``plane`` at source position (fx, fy): four taps,
// a tap with a zero weight skipped (so an inf or NaN under it stays out of
// the sum), the row sums, then the column sum, in f32; zero where both
// taps of an axis are off the plane.  A tap that is read lies on the plane.
template <typename T>
__device__ __forceinline__ float bilinear(const T* __restrict__ plane, float fx, float fy, int H,
                                          int W) {
  int x0 = 0, y0 = 0;
  float wx0 = 0.f, wx1 = 0.f, wy0 = 0.f, wy1 = 0.f;
  float acc = 0.f;
  if (axis_taps(fx, W, x0, wx0, wx1) && axis_taps(fy, H, y0, wy0, wy1)) {
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
  return acc;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// K3: a block owns a kWarpTX x kWarpTY tile of outputs in up to kWarpPlanes
// planes (p, p + gridDim.z, ...); a thread takes two adjacent columns of
// two rows of the tile (16 rows apart), gathers each output's taps from
// device memory and stores each pair at once where its address allows.
constexpr int kWarpTX = 32, kWarpTY = 32, kWarpThreads = 256, kWarpMinBlocks = 6;
constexpr int kWarpPlanes = 4;

template <typename T>
__global__ void __launch_bounds__(kWarpThreads, kWarpMinBlocks)
warp_kernel(const T* __restrict__ img, const float* __restrict__ coeffs, T* __restrict__ out,
            int P, int H, int W, int OH, int OW) {
  constexpr int kPairs = kWarpTX / 2, kRowStep = kWarpThreads / kPairs;
  constexpr int kRows = kWarpTY / kRowStep;
  const int tid = threadIdx.x;
  const int ox = blockIdx.x * kWarpTX + 2 * (tid % kPairs);
  const int oy_first = blockIdx.y * kWarpTY + tid / kPairs;
  if (ox >= OW || oy_first >= OH) return;
  const float fox[2] = {(float)ox, (float)(ox + 1)};
  for (int p = blockIdx.z; p < P; p += gridDim.z) {
    const Coef c = load_coef(coeffs, p);
    const T* plane = img + (size_t)p * H * W;
    // src_pos's products, a column's shared by its rows and a row's by its
    // two columns: the positions are src_pos's to the bit.
    const float axo[2] = {__fmul_rn(c.ax, fox[0]), __fmul_rn(c.ax, fox[1])};
    const float ayo[2] = {__fmul_rn(c.ay, fox[0]), __fmul_rn(c.ay, fox[1])};
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int oy = oy_first + k * kRowStep;
      if (oy >= OH) break;
      const float foy = (float)oy;
      const float bxo = __fmul_rn(c.bx, foy), byo = __fmul_rn(c.by, foy);
      float acc[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (ox + j >= OW) continue;
        const float fx = __fadd_rn(__fadd_rn(axo[j], bxo), c.cx);
        const float fy = __fadd_rn(__fadd_rn(ayo[j], byo), c.cy);
        acc[j] = bilinear(plane, fx, fy, H, W);
      }
      T* dst = out + ((size_t)p * OH + oy) * OW + ox;
      if (ox + 1 < OW && ((size_t)(dst - out) & 1) == 0) {
        store2(dst, acc[0], acc[1]);
      } else {
        store(dst, acc[0]);
        if (ox + 1 < OW) store(dst + 1, acc[1]);
      }
    }
  }
}

// K4: the tent-weighted cotangents of the output pixels whose source
// position lies within one pixel of input pixel v, summed.  The tent
// weights (1 - |fx - vx|)(1 - |fy - vy|) are K3's bilinear weights.
//
// The hits of v are the output pixels o inside the parallelogram
// |fx(o) - vx| < 1, |fy(o) - vy| < 1.  A thread takes kSplatPix input
// pixels of a column (a block a tile of kSplatTX x kSplatTY * kSplatPix)
// and inverts the plane's map once for them.  For each pixel it visits
// only the rows of the parallelogram's extent (from the inverse map) and,
// on each row, only the interval of ox that the two strips give (both are
// linear in ox); each candidate is then tested exactly on its source
// position, computed with K3's rounding.  The bounds carry a relative
// slack that covers the float rounding of the positions and of the bounds
// themselves (``tests/test_torch_warp.py`` holds a float32 model of them
// to every hit of random maps, near-singular ones included); an axis whose
// slope in ox is under 1/64 gives no interval.  So a pixel visits about
// as many candidates as it has hits, not the whole bounding box of its
// preimage.  Candidates are visited in ascending oy, then ascending ox,
// and the hits summed in f32 in that fixed order: no atomics, bitwise
// deterministic.
constexpr int kSplatTX = 32, kSplatTY = 8, kSplatPix = 4;
template <typename T>
__global__ void __launch_bounds__(kSplatTX * kSplatTY)
splat_kernel(const T* __restrict__ g, const float* __restrict__ coeffs, T* __restrict__ out,
             int P, int H, int W, int OH, int OW) {
  const int vx = blockIdx.x * kSplatTX + threadIdx.x;
  const int vy0 = blockIdx.y * kSplatTY * kSplatPix + threadIdx.y;  // rows vy0 + kSplatTY * k
  if (vx >= W || vy0 >= H) return;
  const float fvx = (float)vx;
  for (int p = blockIdx.z; p < P; p += gridDim.z) {
    const Coef c = load_coef(coeffs, p);
    const T* gp = g + (size_t)p * OH * OW;
    float acc[kSplatPix];
#pragma unroll
    for (int k = 0; k < kSplatPix; ++k) acc[k] = 0.f;
    const Preimage m = preimage_of(c, H, W, OH, OW);
    if (!coef_finite(c)) {
      // Non-finite coefficients: K3 wrote zeros, so the adjoint is zero.
    } else if (!m.bounded) {
      // A singular map has no bounded footprint: scan the plane (slow, exact).
#pragma unroll
      for (int k = 0; k < kSplatPix; ++k) {
        const int vy = vy0 + kSplatTY * k;
        if (vy >= H) continue;
        const float fvy = (float)vy;
        for (int oy = 0; oy < OH; ++oy) {
          const float foy = (float)oy;
          for (int ox = 0; ox < OW; ++ox) {
            const float fox = (float)ox;
            const float dx = fabsf(src_pos(c.ax, c.bx, c.cx, fox, foy) - fvx);
            if (!(dx < 1.f)) continue;
            const float dy = fabsf(src_pos(c.ay, c.by, c.cy, fox, foy) - fvy);
            if (!(dy < 1.f)) continue;
            acc[k] += (1.f - dx) * (1.f - dy) * load(gp + (size_t)oy * OW + ox);
          }
        }
      }
    } else {
      const float kx0 = (fvx - c.cx) * m.sx.r;
#pragma unroll
      for (int k = 0; k < kSplatPix; ++k) {
        const int vy = vy0 + kSplatTY * k;
        if (vy >= H) continue;
        const float fvy = (float)vy;
        int c0, c1, r0, r1;
        preimage_box(m, c, fvx, fvx, fvy, fvy, OH, OW, c0, c1, r0, r1);
        const float ky0 = (fvy - c.cy) * m.sy.r;
        for (int oy = r0; oy <= r1; ++oy) {
          const float foy = (float)oy;
          float lo = (float)c0, hi = (float)c1;
          strip_clip(m.sx, foy, kx0, kx0, lo, hi);
          strip_clip(m.sy, foy, ky0, ky0, lo, hi);
          if (!(lo <= hi)) continue;
          const T* grow = gp + (size_t)oy * OW;
          for (int ox = (int)ceilf(lo); ox <= (int)floorf(hi); ++ox) {
            const float fox = (float)ox;
            const float dx = fabsf(src_pos(c.ax, c.bx, c.cx, fox, foy) - fvx);
            if (!(dx < 1.f)) continue;
            const float dy = fabsf(src_pos(c.ay, c.by, c.cy, fox, foy) - fvy);
            if (!(dy < 1.f)) continue;
            acc[k] += (1.f - dx) * (1.f - dy) * load(grow + ox);
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kSplatPix; ++k) {
      const int vy = vy0 + kSplatTY * k;
      if (vy < H) store(out + ((size_t)p * H + vy) * W + vx, acc[k]);
    }
  }
}

// The SMs of the current device, read once.
int sm_count() {
  static const int count = [] {
    int device = 0, n = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    return n > 0 ? n : 1;
  }();
  return count;
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
  // A block walks kWarpPlanes planes where the call has tiles enough to
  // give every SM kWarpMinBlocks such blocks (the unfused augment's 64
  // planes), else one (the eq metrics' 8 planes of 256²).
  const dim3 block(kWarpThreads), tile(kWarpTX, kWarpTY);
  const dim3 one = grid_for(OW, OH, 1, tile);
  const long long tiles = (long long)one.x * one.y * P;
  const int planes =
      tiles >= (long long)kWarpPlanes * kWarpMinBlocks * sm_count() ? kWarpPlanes : 1;
  const dim3 grid = grid_for(OW, OH, (P + planes - 1) / planes, tile);
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
  const dim3 block(kSplatTX, kSplatTY);
  const dim3 grid = grid_for(W, H, P, dim3(kSplatTX, kSplatTY * kSplatPix));
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    splat_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        (const __nv_bfloat16*)g, coeffs, (__nv_bfloat16*)out, P, H, W, OH, OW);
  } else {
    splat_kernel<float><<<grid, block, 0, s>>>((const float*)g, coeffs, (float*)out, P, H,
                                                    W, OH, OW);
  }
  return (int)cudaGetLastError();
}
