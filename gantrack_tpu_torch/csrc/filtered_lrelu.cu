// StyleGAN3's filtered leaky ReLU as one kernel a pass, for NVIDIA Hopper
// (sm_90a).
//
// The JAX package composes ``filtered_lrelu`` from XLA ops (no TPU
// kernel): bias, a ×up FIR, gain · leaky ReLU, clamp, a ↓down FIR.  The
// port ran the same chain as four calls, each a pass over the upsampled
// intermediate in device memory (2x or 4x the layer's size on each axis),
// and autograd kept two copies of it.  Here one block computes an output
// tile of one plane end to end in shared memory, in f32:
//
//   1. stage the input box (plus the bias, per channel) as f32;
//   2. the up pass: zero-stuff by U, pad, correlate -- polyphase, so only
//      the taps that land on an input sample are run (per axis, or as one
//      2-D filter);
//   3. the pointwise step on the intermediate ("mid") samples:
//        write mode (forward): v -> clamp(lrelu(v, slope) * gain, ±clamp),
//          and a 2-bit code a sample: 0 positive, 1 negative or zero, 2
//          clamped (|lrelu(v) * gain| > clamp);
//        read mode (backward, and every higher order): v -> v * gain,
//          v * gain * slope or 0 by the stored code: the op is linear;
//   4. the down pass: pad, correlate, keep every D-th sample (per axis, or
//      as one 2-D filter);
//   5. round once to the output's type (f32 or bf16) and write the tile.
//
// The mid samples never reach device memory; only the codes do, 16 to a
// 32-bit word along x.  The backward of a forward (U, D) is this kernel in
// read mode as (D, U): the adjoint of the down pass is its up pass (taps
// reversed, pads solved so its output is the mid grid again) and the
// adjoint of the up pass its down pass.  Its own adjoint is the forward's
// layout in read mode, so every order of gradient stays on this kernel.
//
// Per axis, with correlation taps f[K] and low pads pu0 (up) and pd0
// (down), a mid sample and an output are
//     mid[m] = sum_t fu[t] * Z[m + t - pu0],  Z[U i] = x[i], zero elsewhere,
//     out[o] = sum_t fd[t] * mid[D o + t - pd0],  mid zero outside [0, M).
// The up pass groups U consecutive mid samples that read the same S input
// samples (those with (m - pu0) = 1 .. U mod U): a block's local mid grid
// starts at such a sample, `off` (< U) before its first needed one, and
// the group's slot s of phase rho takes tap U (s + 1) - 1 - rho.  The
// sign words of a forward start `s_off` = its x offset before sample 0,
// so each 16-sample chunk of a forward block's rows is one whole word.
//
// Work in shared memory: a thread owns a line (a column in the vertical
// passes, a row in the horizontal ones) and a chunk of it, and walks the
// chunk from a register window, so a sample read from shared memory feeds
// several multiply-adds; the taps are kernel parameters with indices known
// at compile time.  Row pitches are odd, so the lanes of a warp, on
// neighbouring lines, hit different banks.  Each output sums its taps in
// ascending order, the vertical pass first, as FMAs into one f32
// accumulator; there are no atomics, so a launch repeats bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

constexpr int round_up(int a, int b) { return (a + b - 1) / b * b; }
constexpr int cmax(int a, int b) { return a > b ? a : b; }

// The compile-time shape of a launch: factors, tap counts (padded with
// zero taps), the output tile and the local grids in shared memory.
template <int U, int D, bool UP2D, bool DOWN2D>
struct Geo {
  static_assert(U == 1 || U == 2 || U == 4, "up factor");
  static_assert(D == 1 || D == 2 || D == 4, "down factor");
  static_assert(!UP2D || U == 2, "a 2-D up-filter runs at x2");
  static_assert(!DOWN2D || D == 2, "a 2-D down-filter runs at ↓2");
  static constexpr int S = U == 1 ? 1 : 6;       // up taps a phase (per axis)
  static constexpr int KD = D == 1 ? 1 : 6 * D;  // down taps (per axis)
  static constexpr int TH = D == 4 ? 16 : 32, TW = 32;  // output tile
  static constexpr int GY = 8;   // mid rows an item of the vertical up pass
  static constexpr int CH = 8;   // output rows an item of the vertical down pass
  static constexpr int CE = TH * TW / kThreads;  // outputs an item of the last pass
  static_assert((D * TH) % U == 0 && (D * TW) % 16 == 0, "tiles keep the phase and the words");
  // Local mid grid: the group offset (< U), the tile's span, the down taps.
  static constexpr int MH = round_up(U - 1 + D * TH + KD - 1, GY);
  static constexpr int MW = round_up(U - 1 + D * TW + KD - 1, 16);
  static constexpr int IH = MH / U + S - 1, IW = MW / U + S - 1;  // staged input
  static constexpr int PI = IW | 1, PM = MW | 1, PO = TW | 1;     // odd pitches
  // X: input (separable up), mid, output (separable down);
  // Y: the vertical up pass (or the input of a 2-D up pass), the vertical
  // down pass (or the output of a 2-D down pass).
  static constexpr int X = cmax(cmax(UP2D ? 0 : IH * PI, MH * PM), DOWN2D ? 0 : TH * PO);
  static constexpr int Y = cmax(UP2D ? IH * PI : MH * PI, DOWN2D ? TH * PO : TH * PM);
  static constexpr int SMEM = (X + Y) * 4;
};

template <int U, int D, bool UP2D, bool DOWN2D>
struct Params {
  using G = Geo<U, D, UP2D, DOWN2D>;
  const void* x;
  void* y;
  const float* bias;  // [C] or null
  uint32_t* sign;     // [P, MHg, wq]
  int read, P, C, H, W, MHg, MWg, OH, OW;
  int i0y, i0x, m0y, m0x, offy, offx, s_off, wq, nty, ntx;
  float gain, slope, clamp;  // clamp < 0: none
  // Up taps [phase][slot] per axis, or [phase y][phase x][slot y][slot x].
  float tuy[UP2D ? 1 : U][G::S], tux[UP2D ? 1 : U][G::S];
  float tu2[UP2D ? 2 : 1][UP2D ? 2 : 1][UP2D ? 6 : 1][UP2D ? 6 : 1];
  // Down taps per axis, or [row][column].
  float tdy[DOWN2D ? 1 : G::KD], tdx[DOWN2D ? 1 : G::KD];
  float td2[DOWN2D ? G::KD : 1][DOWN2D ? G::KD : 1];
};

// What a block writes or reads of the codes: its plane, its rows of the
// mid grid that it owns (write mode) and its words.
struct Own {
  uint32_t* row0;  // the plane's first code row
  int m_lo, m_hi, w_lo, w_hi;
};

// The pointwise step on 16 mid samples of row m, columns n0 .. n0 + 15,
// stored to dst; samples outside the mid grid are zero.
template <class P>
__device__ __forceinline__ void pointwise16(const P& p, const Own& own, float (&v)[16], int m,
                                            int n0, float* dst) {
  const bool row_in = m >= 0 && m < p.MHg;
  const int q = n0 + p.s_off;
  const int w = q >> 4;  // floor
  if (p.read) {
    uint64_t bits = 0;
    if (row_in) {
      const uint32_t* row = own.row0 + (size_t)m * p.wq;
      const uint32_t lo = (w >= 0 && w < p.wq) ? row[w] : 0u;
      const uint32_t hi = (w + 1 >= 0 && w + 1 < p.wq) ? row[w + 1] : 0u;
      bits = (((uint64_t)hi << 32) | lo) >> (2 * (q & 15));
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = n0 + j;
      const uint32_t c = (uint32_t)(bits >> (2 * j)) & 3u;
      float g = v[j] * p.gain;
      if (c == 1u) g *= p.slope;
      dst[j] = (row_in && n >= 0 && n < p.MWg && c != 2u) ? g : 0.f;
    }
  } else {
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = n0 + j;
      const float x = v[j];
      float y;
      uint32_t c;
      if (!(row_in && n >= 0 && n < p.MWg)) {  // outside the mid grid: 0, code 0
        y = 0.f;
        c = 0u;
      } else if (x > 0.f) {
        y = x * p.gain;
        c = 0u;
      } else {
        y = (x * p.slope) * p.gain;
        c = 1u;
      }
      if (p.clamp >= 0.f && fabsf(y) > p.clamp) {
        y = copysignf(p.clamp, y);
        c = 2u;
      }
      word |= c << (2 * j);
      dst[j] = y;
    }
    if (m >= own.m_lo && m < own.m_hi && w >= own.w_lo && w < own.w_hi) {
      own.row0[(size_t)m * p.wq + w] = word;
    }
  }
}

// Vertical up pass: in [IH][PI] -> vt [MH][PI], per column.
template <int U, int D, bool UP2D, bool DOWN2D>
__device__ __forceinline__ void up_vertical(const Params<U, D, UP2D, DOWN2D>& p,
                                            const float* __restrict__ in, float* __restrict__ vt) {
  using G = Geo<U, D, UP2D, DOWN2D>;
  constexpr int S = G::S, NG = G::GY / U;
  for (int it = threadIdx.x; it < G::IW * (G::MH / G::GY); it += kThreads) {
    const int c = it % G::IW, b0 = (it / G::IW) * NG;
    const float* s = in + b0 * G::PI + c;
    float w[S];
#pragma unroll
    for (int k = 0; k < S - 1; ++k) w[k] = s[k * G::PI];
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      w[S - 1] = s[(g + S - 1) * G::PI];
#pragma unroll
      for (int rho = 0; rho < U; ++rho) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < S; ++k) acc = fmaf(p.tuy[rho][k], w[k], acc);
        vt[(U * (b0 + g) + rho) * G::PI + c] = acc;
      }
#pragma unroll
      for (int k = 0; k < S - 1; ++k) w[k] = w[k + 1];
    }
  }
}

// Horizontal up pass and the pointwise step: vt [MH][PI] -> mid [MH][PM],
// per row, 16 mid samples (one code word) an item.
template <int U, int D, bool UP2D, bool DOWN2D>
__device__ __forceinline__ void up_horizontal(const Params<U, D, UP2D, DOWN2D>& p, const Own& own,
                                              const float* __restrict__ vt,
                                              float* __restrict__ mid, int m0y, int m0x) {
  using G = Geo<U, D, UP2D, DOWN2D>;
  constexpr int S = G::S, NG = 16 / U;
  for (int it = threadIdx.x; it < G::MH * (G::MW / 16); it += kThreads) {
    const int r = it % G::MH, k = it / G::MH;
    const float* s = vt + r * G::PI + k * NG;
    float w[S], v[16];
#pragma unroll
    for (int j = 0; j < S - 1; ++j) w[j] = s[j];
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      w[S - 1] = s[g + S - 1];
#pragma unroll
      for (int rho = 0; rho < U; ++rho) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < S; ++j) acc = fmaf(p.tux[rho][j], w[j], acc);
        v[U * g + rho] = acc;
      }
#pragma unroll
      for (int j = 0; j < S - 1; ++j) w[j] = w[j + 1];
    }
    pointwise16(p, own, v, m0y + r, m0x + 16 * k, mid + r * G::PM + 16 * k);
  }
}

// 2-D up pass (x2) and the pointwise step: in [IH][PI] -> mid [MH][PM];
// an item is a group row (2 mid rows) by 8 groups (16 mid columns), all
// four phases from one 6 x 6 window of input samples.
template <int U, int D, bool UP2D, bool DOWN2D>
__device__ __forceinline__ void up_2d(const Params<U, D, UP2D, DOWN2D>& p, const Own& own,
                                      const float* __restrict__ in, float* __restrict__ mid,
                                      int m0y, int m0x) {
  using G = Geo<U, D, UP2D, DOWN2D>;
  constexpr int S = 6, NG = 8;
  for (int it = threadIdx.x; it < (G::MH / 2) * (G::MW / 16); it += kThreads) {
    const int gy = it % (G::MH / 2), k = it / (G::MH / 2);
    const float* s = in + gy * G::PI + k * NG;
    float w[S][S], v0[16], v1[16];
#pragma unroll
    for (int a = 0; a < S; ++a) {
#pragma unroll
      for (int b = 0; b < S - 1; ++b) w[a][b] = s[a * G::PI + b];
    }
#pragma unroll
    for (int g = 0; g < NG; ++g) {
#pragma unroll
      for (int a = 0; a < S; ++a) w[a][S - 1] = s[a * G::PI + g + S - 1];
#pragma unroll
      for (int ry = 0; ry < 2; ++ry) {
#pragma unroll
        for (int rx = 0; rx < 2; ++rx) {
          float acc = 0.f;
#pragma unroll
          for (int a = 0; a < S; ++a) {
#pragma unroll
            for (int b = 0; b < S; ++b) acc = fmaf(p.tu2[ry][rx][a][b], w[a][b], acc);
          }
          (ry ? v1 : v0)[2 * g + rx] = acc;
        }
      }
#pragma unroll
      for (int a = 0; a < S; ++a) {
#pragma unroll
        for (int b = 0; b < S - 1; ++b) w[a][b] = w[a][b + 1];
      }
    }
    pointwise16(p, own, v0, m0y + 2 * gy, m0x + 16 * k, mid + 2 * gy * G::PM + 16 * k);
    pointwise16(p, own, v1, m0y + 2 * gy + 1, m0x + 16 * k, mid + (2 * gy + 1) * G::PM + 16 * k);
  }
}

// Vertical down pass: mid [MH][PM] -> dv [TH][PM], per column.
template <int U, int D, bool UP2D, bool DOWN2D>
__device__ __forceinline__ void down_vertical(const Params<U, D, UP2D, DOWN2D>& p,
                                              const float* __restrict__ mid,
                                              float* __restrict__ dv) {
  using G = Geo<U, D, UP2D, DOWN2D>;
  constexpr int K = G::KD;
  for (int it = threadIdx.x; it < G::MW * (G::TH / G::CH); it += kThreads) {
    const int c = it % G::MW, r0 = (it / G::MW) * G::CH;
    const float* s = mid + (p.offy + D * r0) * G::PM + c;
    float w[K];
#pragma unroll
    for (int t = 0; t < K - D; ++t) w[t] = s[t * G::PM];
#pragma unroll
    for (int k = 0; k < G::CH; ++k) {
#pragma unroll
      for (int j = 0; j < D; ++j) w[K - D + j] = s[(D * k + K - D + j) * G::PM];
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t < K; ++t) acc = fmaf(p.tdy[t], w[t], acc);
      dv[(r0 + k) * G::PM + c] = acc;
#pragma unroll
      for (int t = 0; t < K - D; ++t) w[t] = w[t + D];
    }
  }
}

// Horizontal down pass: dv [TH][PM] -> out [TH][PO], per row.
template <int U, int D, bool UP2D, bool DOWN2D>
__device__ __forceinline__ void down_horizontal(const Params<U, D, UP2D, DOWN2D>& p,
                                                const float* __restrict__ dv,
                                                float* __restrict__ out) {
  using G = Geo<U, D, UP2D, DOWN2D>;
  constexpr int K = G::KD;
  for (int it = threadIdx.x; it < G::TH * (G::TW / G::CE); it += kThreads) {
    const int r = it % G::TH, c0 = (it / G::TH) * G::CE;
    const float* s = dv + r * G::PM + p.offx + D * c0;
    float w[K];
#pragma unroll
    for (int t = 0; t < K - D; ++t) w[t] = s[t];
#pragma unroll
    for (int k = 0; k < G::CE; ++k) {
#pragma unroll
      for (int j = 0; j < D; ++j) w[K - D + j] = s[D * k + K - D + j];
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t < K; ++t) acc = fmaf(p.tdx[t], w[t], acc);
      out[r * G::PO + c0 + k] = acc;
#pragma unroll
      for (int t = 0; t < K - D; ++t) w[t] = w[t + D];
    }
  }
}

// 2-D down pass (↓2): mid [MH][PM] -> out [TH][PO]; an item is one output
// column by CE rows, walking their mid rows once.
template <int U, int D, bool UP2D, bool DOWN2D>
__device__ __forceinline__ void down_2d(const Params<U, D, UP2D, DOWN2D>& p,
                                        const float* __restrict__ mid, float* __restrict__ out) {
  using G = Geo<U, D, UP2D, DOWN2D>;
  constexpr int K = G::KD, C = G::CE;
  for (int it = threadIdx.x; it < G::TW * (G::TH / C); it += kThreads) {
    const int c = it % G::TW, r0 = (it / G::TW) * C;
    const float* s = mid + (p.offy + 2 * r0) * G::PM + p.offx + 2 * c;
    float acc[C];
#pragma unroll
    for (int k = 0; k < C; ++k) acc[k] = 0.f;
#pragma unroll
    for (int j = 0; j < 2 * (C - 1) + K; ++j) {
      float v[K];
#pragma unroll
      for (int b = 0; b < K; ++b) v[b] = s[j * G::PM + b];
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const int a = j - 2 * k;
        if (a < 0 || a >= K) continue;
#pragma unroll
        for (int b = 0; b < K; ++b) acc[k] = fmaf(p.td2[a][b], v[b], acc[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < C; ++k) out[(r0 + k) * G::PO + c] = acc[k];
  }
}

// One block: output tile (blockIdx.x: ty * ntx + tx) of the planes
// blockIdx.y, blockIdx.y + gridDim.y, ...
template <typename T, int U, int D, bool UP2D, bool DOWN2D>
__global__ void __launch_bounds__(kThreads)
filtered_lrelu_kernel(const __grid_constant__ Params<U, D, UP2D, DOWN2D> p) {
  using G = Geo<U, D, UP2D, DOWN2D>;
  extern __shared__ float smem[];
  float* X = smem;
  float* Y = smem + G::X;
  const int tx = blockIdx.x % p.ntx, ty = blockIdx.x / p.ntx;
  const int m0y = p.m0y + D * G::TH * ty, m0x = p.m0x + D * G::TW * tx;
  const int i0y = p.i0y + D * G::TH / U * ty, i0x = p.i0x + D * G::TW / U * tx;
  Own own;
  own.m_lo = D * G::TH * ty;
  own.m_hi = ty == p.nty - 1 ? p.MHg : own.m_lo + D * G::TH;
  own.w_lo = D * G::TW / 16 * tx;
  own.w_hi = tx == p.ntx - 1 ? p.wq : own.w_lo + D * G::TW / 16;
  for (int pl = blockIdx.y; pl < p.P; pl += gridDim.y) {
    const T* xp = (const T*)p.x + (size_t)pl * p.H * p.W;
    const float b = p.bias != nullptr ? p.bias[pl % p.C] : 0.f;
    own.row0 = p.sign + (size_t)pl * p.MHg * p.wq;
    float* in = UP2D ? Y : X;
    for (int i = threadIdx.x; i < G::IH * G::IW; i += kThreads) {
      const int r = i / G::IW, c = i % G::IW, gy = i0y + r, gx = i0x + c;
      float v = 0.f;
      if (gy >= 0 && gy < p.H && gx >= 0 && gx < p.W) v = to_f32(xp[(size_t)gy * p.W + gx]) + b;
      in[r * G::PI + c] = v;
    }
    __syncthreads();
    if constexpr (UP2D) {
      up_2d(p, own, Y, X, m0y, m0x);
    } else {
      up_vertical(p, X, Y);
      __syncthreads();
      up_horizontal(p, own, Y, X, m0y, m0x);
    }
    __syncthreads();
    const float* out;
    if constexpr (DOWN2D) {
      down_2d(p, X, Y);
      out = Y;
    } else {
      down_vertical(p, X, Y);
      __syncthreads();
      down_horizontal(p, Y, X);
      out = X;
    }
    __syncthreads();
    T* yp = (T*)p.y + (size_t)pl * p.OH * p.OW;
    for (int i = threadIdx.x; i < G::TH * G::TW; i += kThreads) {
      const int r = i / G::TW, c = i % G::TW, oy = G::TH * ty + r, ox = G::TW * tx + c;
      if (oy < p.OH && ox < p.OW) yp[(size_t)oy * p.OW + ox] = from_f32<T>(out[r * G::PO + c]);
    }
    __syncthreads();  // the buffers are free for the next plane
  }
}

int floor_mod(int a, int b) { return ((a % b) + b) % b; }

// One axis of the launch: the local mid grid of tile 0 starts at m0 (off
// before the first mid sample its outputs read), its input box at i0.
void axis(int U, int pu0, int pd0, int& i0, int& m0, int& off) {
  const int first = -pd0;
  off = floor_mod(first - pu0 - 1, U);
  m0 = first - off;
  i0 = (m0 - pu0 - 1) / U + 1;  // m0 - pu0 - 1 is a multiple of U
}

template <typename T, int U, int D, bool UP2D, bool DOWN2D>
int launch(const void* x, void* y, const float* bias, void* sign, int read, int P, int C, int H,
           int W, int MHg, int MWg, int OH, int OW, const float* taps_up, const float* taps_down,
           const int* pads, int s_off, float gain, float slope, float clamp, cudaStream_t stream) {
  using G = Geo<U, D, UP2D, DOWN2D>;
  Params<U, D, UP2D, DOWN2D> p = {};
  p.x = x;
  p.y = y;
  p.bias = bias;
  p.sign = (uint32_t*)sign;
  p.read = read;
  p.P = P;
  p.C = C;
  p.H = H;
  p.W = W;
  p.MHg = MHg;
  p.MWg = MWg;
  p.OH = OH;
  p.OW = OW;
  axis(U, pads[0], pads[2], p.i0y, p.m0y, p.offy);
  axis(U, pads[1], pads[3], p.i0x, p.m0x, p.offx);
  p.s_off = s_off;
  p.wq = (MWg + s_off + 15) / 16;
  p.nty = (OH + G::TH - 1) / G::TH;
  p.ntx = (OW + G::TW - 1) / G::TW;
  p.gain = gain;
  p.slope = slope;
  p.clamp = clamp;
  if (!read) {  // each block writes whole words of the rows it owns
    if (pads[2] != 0 || pads[3] != 0 || s_off != p.offx ||
        MHg - D * G::TH * (p.nty - 1) + p.offy > G::MH ||
        16 * (p.wq - D * G::TW / 16 * (p.ntx - 1)) > G::MW) {
      return (int)cudaErrorInvalidValue;
    }
  }
  // Up taps: taps_up holds the correlation taps padded to U * S per axis
  // (y then x), or 12 x 12 for a 2-D filter; slot s of phase rho takes tap
  // U (s + 1) - 1 - rho.
  if constexpr (UP2D) {
    for (int ry = 0; ry < 2; ++ry)
      for (int rx = 0; rx < 2; ++rx)
        for (int a = 0; a < 6; ++a)
          for (int b = 0; b < 6; ++b)
            p.tu2[ry][rx][a][b] = taps_up[(2 * (a + 1) - 1 - ry) * 12 + 2 * (b + 1) - 1 - rx];
  } else {
    for (int rho = 0; rho < U; ++rho) {
      for (int s = 0; s < G::S; ++s) {
        p.tuy[rho][s] = taps_up[U * (s + 1) - 1 - rho];
        p.tux[rho][s] = taps_up[U * G::S + U * (s + 1) - 1 - rho];
      }
    }
  }
  if constexpr (DOWN2D) {
    for (int a = 0; a < G::KD; ++a)
      for (int b = 0; b < G::KD; ++b) p.td2[a][b] = taps_down[a * G::KD + b];
  } else {
    for (int t = 0; t < G::KD; ++t) {
      p.tdy[t] = taps_down[t];
      p.tdx[t] = taps_down[G::KD + t];
    }
  }
  auto kernel = filtered_lrelu_kernel<T, U, D, UP2D, DOWN2D>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(p.ntx * p.nty, P < 65535 ? P : 65535);
  kernel<<<grid, kThreads, G::SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int up, int down, int up2d, int down2d, const void* x, void* y, const float* bias,
             void* sign, int read, int P, int C, int H, int W, int MHg, int MWg, int OH, int OW,
             const float* tu, const float* td, const int* pads, int s_off, float gain,
             float slope, float clamp, cudaStream_t s) {
#define FLRL_LAUNCH(U_, D_, UP2D_, DOWN2D_)                                                      \
  if (up == U_ && down == D_ && up2d == UP2D_ && down2d == DOWN2D_)                              \
    return launch<T, U_, D_, UP2D_, DOWN2D_>(x, y, bias, sign, read, P, C, H, W, MHg, MWg, OH, OW, \
                                             tu, td, pads, s_off, gain, slope, clamp, s);
  // Separable: the forwards (1, 1), (2, 1), (1, 2), (2, 2), (4, 2) and
  // their adjoints (1, 2 -> 2, 1 ...; 4, 2 -> 2, 4).
  FLRL_LAUNCH(1, 1, 0, 0)
  FLRL_LAUNCH(2, 1, 0, 0)
  FLRL_LAUNCH(1, 2, 0, 0)
  FLRL_LAUNCH(2, 2, 0, 0)
  FLRL_LAUNCH(4, 2, 0, 0)
  FLRL_LAUNCH(2, 4, 0, 0)
  // A 2-D down-filter at ↓2, and its adjoint, a 2-D up-filter at x2.
  FLRL_LAUNCH(1, 2, 0, 1)
  FLRL_LAUNCH(2, 2, 0, 1)
  FLRL_LAUNCH(4, 2, 0, 1)
  FLRL_LAUNCH(2, 1, 1, 0)
  FLRL_LAUNCH(2, 2, 1, 0)
  FLRL_LAUNCH(2, 4, 1, 0)
#undef FLRL_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// One pass of the filtered leaky ReLU over P = N * C planes [H, W] of x
// (bf16 if ``is_bf16``, else f32) into y [P, OH, OW] of the same type.
// ``read`` 0 (forward): adds ``bias`` [C] (f32, or null) per plane p % C,
// applies the activation and writes the codes to ``sign`` [P, MH, wq]
// (int32 words, wq = ceil((MW + s_off) / 16)); ``read`` 1: no bias, scales
// by the codes it reads.  ``up`` / ``down`` are the factors, ``up2d`` /
// ``down2d`` mark a 2-D filter; ``taps_up`` holds the up pass' correlation
// taps padded with zeros to U * S (S = 6, or 1 at U = 1) per axis, y then
// x, or a 12 x 12 2-D filter; ``taps_down`` the down pass' padded to 6 *
// D (1 at D = 1) per axis, or 12 x 12; ``pads`` = {pu0y, pu0x, pd0y, pd0x},
// the low pads of the two passes; MH x MW is the mid grid.  ``clamp`` < 0
// clamps nothing.  Launches on ``stream`` and returns cudaGetLastError()
// (or cudaErrorInvalidValue for arguments outside the kernel's contract).
extern "C" int gantrack_filtered_lrelu(const void* x, void* y, const float* bias, void* sign,
                                       int read, int P, int C, int H, int W, int MH, int MW,
                                       int OH, int OW, int up, int down, int up2d, int down2d,
                                       const float* taps_up, const float* taps_down,
                                       const int* pads, int s_off, float gain, float slope,
                                       float clamp, int is_bf16, void* stream) {
  if (P < 1 || C < 1 || H < 1 || W < 1 || MH < 1 || MW < 1 || OH < 1 || OW < 1 || s_off < 0 ||
      (read != 0 && read != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    return dispatch<__nv_bfloat16>(up, down, up2d, down2d, x, y, bias, sign, read, P, C, H, W, MH,
                                   MW, OH, OW, taps_up, taps_down, pads, s_off, gain, slope,
                                   clamp, s);
  }
  return dispatch<float>(up, down, up2d, down2d, x, y, bias, sign, read, P, C, H, W, MH, MW, OH,
                         OW, taps_up, taps_down, pads, s_off, gain, slope, clamp, s);
}
