// What the affine warp kernels share: warp.cu (K3, K4) and upwarp.cu (K1,
// K2).  Per plane six float32 pixel-space coefficients; the source position
// of output pixel (ox, oy) rounded operation by operation as the plain
// PyTorch version rounds it; and the bounds of a gather that inverts the
// map (K4's splat, K2's pass over the 2x canvas): the output rows and
// columns the preimage of a box of input pixels can reach, and on each row
// the interval of ox that the two strips |f(o) - v| < 1 leave.
//
// The bounds carry a relative slack that covers the float rounding of the
// positions and of the bounds themselves (``tests/test_torch_warp.py`` and
// ``tests/test_torch_upwarp.py`` hold a float32 model of them to every hit
// of random maps, near-singular ones included).  Rounding to nearest is
// monotone, so a position or corner computed here moves monotonically with
// each of its arguments: the bounds of a box of several input pixels are
// the union of those of its pixels, and a box's corners bound every
// position inside it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

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

constexpr float kMinSlope = 1.f / 64.f;
constexpr float kSlack = 1e-5f;  // relative rounding slack of the bounds

// One axis of the strip |a*ox + b*oy + c - v| < 1 on row oy: its centre
// k0 + k1*oy with k0 = (v - c)*r, r = 1/a, and half-width h in ox, slack
// included; r = 0 when |a| is under kMinSlope (no bound).  ``n_in`` is the
// input extent of the axis.
struct Strip {
  float r, k1, h;
};

__device__ __forceinline__ Strip strip_axis(float a, float b, float c, int OH, int OW, int n_in) {
  if (!(fabsf(a) >= kMinSlope)) return {0.f, 0.f, 0.f};
  const float r = 1.f / a, k1 = -b * r;
  const float pos = fabsf(a) * OW + fabsf(b) * OH + fabsf(c) + (float)n_in + 2.f;
  const float centre = ((float)n_in + fabsf(c)) * fabsf(r) + fabsf(k1) * OH + 1.f;
  return {r, k1, (1.f + kSlack * pos) * fabsf(r) + kSlack * centre};
}

// A plane's map inverted for a gather over an H x W input: the inverse of
// its 2x2 matrix, the slack of a preimage's extent in output pixels, and
// the two strips.  ``bounded`` is false for a singular matrix (det == 0, or
// an inverse that is not finite): a preimage then has no bounded extent.
struct Preimage {
  float ia, ib, ic, id, ex, ey;
  Strip sx, sy;
  bool bounded;
};

__device__ __forceinline__ Preimage preimage_of(const Coef& c, int H, int W, int OH, int OW) {
  Preimage m;
  const float det = c.ax * c.by - c.bx * c.ay;
  m.ia = c.by / det;
  m.ib = -c.bx / det;
  m.ic = -c.ay / det;
  m.id = c.ax / det;
  m.bounded = det != 0.f && isfinite(m.ia) && isfinite(m.ib) && isfinite(m.ic) &&
              isfinite(m.id);
  m.sx = strip_axis(c.ax, c.bx, c.cx, OH, OW, W);
  m.sy = strip_axis(c.ay, c.by, c.cy, OH, OW, H);
  // Slack of the parallelogram's extent: the rounding of the corners
  // through the inverse and of the positions.
  const float mag = kSlack * ((float)(W + H) + fabsf(c.cx) + fabsf(c.cy) +
                              (fabsf(c.ax) + fabsf(c.ay)) * OW +
                              (fabsf(c.bx) + fabsf(c.by)) * OH + 2.f);
  m.ex = (fabsf(m.ia) + fabsf(m.ib)) * mag;
  m.ey = (fabsf(m.ic) + fabsf(m.id)) * mag;
  return m;
}

// The output columns c0..c1 and rows r0..r1 (clamped to the plane, empty
// when c0 > c1 or r0 > r1) that can hold a hit of an input pixel of the
// box x0..x1, y0..y1: the extent, through the inverse, of the box widened
// by one pixel on every side.  One pixel (x0 == x1, y0 == y1) is K4's.
__device__ __forceinline__ void preimage_box(const Preimage& m, const Coef& c, float x0,
                                             float x1, float y0, float y1, int OH, int OW,
                                             int& c0, int& c1, int& r0, int& r1) {
  const float pxs[2] = {x0 + -1.f - c.cx, x1 + 1.f - c.cx};
  const float pys[2] = {y0 + -1.f - c.cy, y1 + 1.f - c.cy};
  float xmin = INFINITY, xmax = -INFINITY, ymin = INFINITY, ymax = -INFINITY;
#pragma unroll
  for (int sy = 0; sy < 2; ++sy) {
#pragma unroll
    for (int sx = 0; sx < 2; ++sx) {
      const float qx = m.ia * pxs[sx] + m.ib * pys[sy], qy = m.ic * pxs[sx] + m.id * pys[sy];
      xmin = fminf(xmin, qx); xmax = fmaxf(xmax, qx);
      ymin = fminf(ymin, qy); ymax = fmaxf(ymax, qy);
    }
  }
  // Clamped to the plane (and a little beyond) before the casts, so a
  // far-away preimage gives an empty range, not an overflow.
  const float xhi = (float)OW + 1.f, yhi = (float)OH + 1.f;
  c0 = max(0, (int)ceilf(fminf(fmaxf(xmin - m.ex, -2.f), xhi)));
  c1 = min(OW - 1, (int)floorf(fminf(fmaxf(xmax + m.ex, -2.f), xhi)));
  r0 = max(0, (int)ceilf(fminf(fmaxf(ymin - m.ey, -2.f), yhi)));
  r1 = min(OH - 1, (int)floorf(fminf(fmaxf(ymax + m.ey, -2.f), yhi)));
}

// Clips [lo, hi] on output row ``foy`` to the union of the strips centred
// at k0a + k1*oy and k0b + k1*oy (the strips of the first and the last
// input pixel of a run along the axis; k0a == k0b for one pixel).
__device__ __forceinline__ void strip_clip(const Strip& s, float foy, float k0a, float k0b,
                                           float& lo, float& hi) {
  if (s.r != 0.f) {
    const float ma = fmaf(s.k1, foy, k0a), mb = fmaf(s.k1, foy, k0b);
    lo = fmaxf(lo, fminf(ma, mb) - s.h);
    hi = fminf(hi, fmaxf(ma, mb) + s.h);
  }
}

}  // namespace
