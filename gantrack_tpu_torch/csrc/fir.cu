// Separable resample FIR in three forms (K5 same, K6 down2, K7 up2) for
// NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels ``_fir_same_kernel``, ``_fir_down2_kernel``
// and ``_fir_up2_kernel`` (launched by ``_call_same``, ``_call_down2`` and
// ``_call_up2``) of gantrack_tpu/ops/attic/fir.py.  They compute the
// contract of ``upfirdn2d`` for a separable filter with up or down in
// {1, 2}: per plane X [H, W] (N*C contiguous planes), with correlation
// taps fy[ky], fx[kx] (already flipped, gain folded in) and the low pads
// py0, px0 of the up-rate grid,
//     same:  o[v,u] = sum_ij fy[i] fx[j] X[v+i-py0, u+j-px0]
//     down2: o[v,u] = sum_ij fy[i] fx[j] X[2v+i-py0, 2u+j-px0]
//     up2:   o[v,u] = sum_ij fy[i] fx[j] Z[v+i-py0, u+j-px0],
//            Z[2m, 2n] = X[m, n] and zero elsewhere (polyphase: only taps
//            that land on an even Z row and column are read; Z is never
//            built).
// Samples outside the image are zero, so any pads work, including the
// negative ones (cropping) of the augment pipe.  Sums are f32; the output
// has the input's type (f32 or bf16).  The three forms are closed under
// transposition (adjoint(same) = same, adjoint(down2) = up2 and back), so
// the PyTorch wrapper's backward is this kernel again, to any order.
//
// What is ported is the arithmetic.  The TPU form (``pl.Element`` halo
// windows over the untiled H dimension, lane regroups for the decimation
// and the phase interleave, ``_pick_th``'s VMEM budget) was a layout
// device for the TPU and is not carried.
//
// What bounds them on the H100: a resample FIR does ky*kx (same, down2)
// multiply-adds per output, or ceil(ky/2)*ceil(kx/2) (up2), against one
// read of the input and one write of the output.  Done separably (ky + kx
// multiply-adds an output, or about half at up2) it is bound by memory
// traffic if each input sample is read once -- but only just: at down2
// with 12 taps an output costs about 26 vertical and 12 horizontal
// multiply-adds and 6 loads of a sample (4 without the halo), some 70
// instructions with their addresses, which the SMs execute in about
// 0.7 ms at StyleGAN3-T's largest call, against its byte bound of 0.96 ms.
// So the inner loops must carry little beyond the multiply-adds, and
// enough loads must be in flight to cover the memory's latency.  The
// first form of K5/K6 staged each 32 x 16 tile's whole input window in
// shared memory with scalar loads, ran the vertical pass over every window
// column from there and read shared memory at a stride of 2 at down2, with
// three barriers a plane and no load in flight while it computed: 5.6x its
// bound at that call.
//
// K5, K6 (``fir_kernel``): a block of kCols = 128 threads owns an output
// tile of kRows = 16 rows x TW columns (TW the widest even count whose
// input window of S*(TW - 1) + kx columns fits kCols; S the input step, 2
// at down2: TW = 58 at 12 taps, 62 at 4; 124 and 116 at the same rate)
// and walks the planes p, p + gridDim.z, ...; the grid holds about
// kBlocksPerSM blocks an SM.  Vertical pass from registers: a thread owns
// one column of the window and walks the tile's 16 output rows down it
// from a register window of ky + S*15 samples, so each sample of the
// tile's window is read from device memory once (the halo rows that
// neighbouring tiles share come mostly from L2), and writes the 16
// vertical sums to a shared f32 buffer [kRows][kCols]; the next plane's
// window is loaded into the registers while this plane's horizontal pass
// runs, and two buffers alternate by plane, so a plane costs one barrier.
// The window's row addresses and bounds are formed a plane at a time: left
// to itself the compiler held all of them in registers, which left room
// for one resident block an SM at down2.  Horizontal pass: a warp takes a
// row, a lane two neighbouring outputs (u, u + 1), which read the window
// columns 2S*q .. 2S*q + S + kx - 1: the lane loads them as 16-byte
// (down2) or 8-byte (same) words from its own aligned offset, so the lanes
// of a warp read consecutive words and no bank is read twice (the even and
// odd columns that the decimation interleaves arrive together in one word,
// and the taps run over them in ascending order), and writes the pair as
// one bf16x2 / float2 store where the row's alignment allows (odd widths
// fall back to two scalar stores on the unaligned rows).  Each output sums
// its vertical taps in ascending order in f32, then its horizontal taps in
// ascending order, as FMAs into one accumulator: the first form's order,
// so the bits are the same.  Blocks of 128 threads and few registers a thread
// (``min_blocks``) keep 32 (down2) to 40 (same) warps an SM resident,
// which the latency of the window's loads needs (blocks of 256 threads,
// two groups of 16 rows, measured slower on an H100 at StyleGAN3-T's down2
// shapes and at the claro same shapes, held to 64 registers or not).
// Hopper's TMA is no help: its 16-byte row pitch needs W % 8 == 0 in bf16,
// which the canvases 562, 522, 306, 259 and 82 are not; the register
// window is the asynchronous copy.
//
// K7 (``fir_up_kernel``): the output is four times the input, so its
// writes are the byte bound.  The polyphase split is static: the host
// (ops/fir.py ``up2_phases``) gives, per axis and output parity r, the
// taps that land on an input sample and their first input offset d_r,
//     out[2b + r] = sum_t taps_r[t] * X[b + d_r + t]   (per axis),
// as the TPU kernel's static phase loops did, so no tap is tested for
// parity and an output costs about k/2 multiply-adds an axis.  Along y,
// the two output rows (2a + ey, 2a + ey + 1) with ey = d_1 - d_0 read the
// same input rows a + d_ey + t: a thread walks 8 row pairs down one input
// column from a register window (the next plane's window is loaded while
// the current plane's horizontal pass runs) and writes both rows to a
// shared f32 buffer; the horizontal pass writes the two phases of an
// output column pair as one bf16x2 / float2 store where the row allows
// (else two scalar stores).  A block owns an output tile of 64 rows x
// 2*TW columns (TW = 58 pairs at 12 taps) and walks the planes p,
// p + gridDim.z, ...; the grid holds about 64 blocks an SM.  Each output
// sums its vertical taps in ascending order, then its horizontal taps, as
// the per-output form over the zero-stuffed grid does without the zero
// terms.
//
// Tap counts 4 and 12 are unrolled at compile time; other counts up to
// kMaxTaps take a generic loop (K5, K6: the vertical pass then reads each
// tap's sample from device memory, not from a register window).  K7's
// factor is a template parameter, instantiated at 2 only.  The grid sizes
// (blocks an SM) are the fastest of 2 .. 1024 on an H100 at StyleGAN3-T's
// shapes, which chip_smoke.py times on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kMaxTaps = 32;
constexpr int kMaxGridZ = 65535;

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n < 1) {
      n = 132;
    }
  }
  return n;
}

// A grid of tiles_x x tiles_y output tiles whose z dimension walks the P
// planes: about blocks_per_sm blocks an SM in all, each block walking the
// planes p, p + gridDim.z, ... (at most kMaxGridZ in z, at least 1).
dim3 plane_grid(int tiles_x, int tiles_y, int P, int blocks_per_sm) {
  const long tiles = (long)tiles_x * tiles_y;
  const long want = ((long)blocks_per_sm * sm_count() + tiles - 1) / tiles;
  const long z = want < P ? want : P;
  return dim3(tiles_x, tiles_y, (unsigned)(z < 1 ? 1 : z < kMaxGridZ ? z : kMaxGridZ));
}

// ------------------------------------------------------- K5, K6: same, down2

enum Form { kSame = 0, kDown2 = 1 };

struct Taps {
  float y[kMaxTaps];
  float x[kMaxTaps];
};

constexpr int kCols = 128;       // window columns of a tile: one a thread
constexpr int kThreads = kCols;  // 4 warps
constexpr int kRows = 16;        // output rows of a tile, which a thread walks down its column
// Blocks of a launch an SM (several resident waves): on an H100 the fastest
// of 2 .. 1024 at StyleGAN3-T's down2 shapes and the claro same shapes,
// which chip_smoke.py times on every run.
constexpr int kBlocksPerSM = 128;

// The input step of an output: 2 at down2.
template <int FORM>
__host__ __device__ constexpr int step() {
  return FORM == kDown2 ? 2 : 1;
}

// Output columns of a tile: the largest even count whose input window,
// S*(TW - 1) + k columns, fits kCols.
template <int FORM>
__host__ __device__ constexpr int tile_w(int k) {
  return ((kCols - k) / step<FORM>() + 1) & ~1;
}

// Window columns a lane loads for its output pair (S + K, rounded up to
// whole 2S-float words).
template <int FORM, int K>
__host__ __device__ constexpr int pair_cols() {
  return (step<FORM>() + K + 2 * step<FORM>() - 1) / (2 * step<FORM>()) * (2 * step<FORM>());
}

// Resident blocks an SM the compiler must allow, which caps its registers
// a thread: 8 at down2 (64 registers; the 12-tap window would otherwise
// take 72), 10 at the same rate (48; else 72): chosen by timing several
// caps on an H100 at the shapes of chip_smoke.py's FIR check.
template <int FORM>
constexpr int min_blocks() {
  return FORM == kDown2 ? 8 : 10;
}

// One block per output tile of kRows x TW; the z dimension of the grid
// walks the planes.  K > 0 fixes ky = kx = K at compile time, so the tap
// loops and the register window unroll; K == 0 reads ky, kx at run time.
template <typename T, int FORM, int K>
__global__ void __launch_bounds__(kThreads, min_blocks<FORM>())
fir_kernel(const T* __restrict__ x, T* __restrict__ out, int P, int H, int W, int OH, int OW,
           int py0, int px0, int ky_rt, int kx_rt, Taps t) {
  constexpr int S = step<FORM>();
  constexpr int WIN = K > 0 ? K + S * (kRows - 1) : 1;
  static_assert(K == 0 || S * (tile_w<FORM>(K) - 2) + pair_cols<FORM, K>() <= kCols,
                "a lane's words stay inside the row of the vertical buffer");
  __shared__ __align__(16) float vert[2][kRows][kCols];
  const int ky = K > 0 ? K : ky_rt;
  const int kx = K > 0 ? K : kx_rt;
  const int tw = tile_w<FORM>(kx);
  const int u0 = blockIdx.x * tw, v0 = blockIdx.y * kRows;
  // Outputs of the tile up to the last pair that holds an output, and the
  // window columns they read (fewer at a ragged right edge).
  const int n_out = min(tw, (OW - u0 + 1) & ~1);
  const int nc = S * (n_out - 1) + kx;
  // The vertical item of this thread: one column of the window, kRows rows.
  const int c = threadIdx.x;
  const int ix = S * u0 - px0 + c;
  const bool col_in = ix >= 0 && ix < W;
  const bool active = c < nc;
  const int iy0 = S * v0 - py0;  // first input row of the item
  // The rows jlo .. jhi - 1 of the register window lie in the image.
  const int jlo = col_in ? max(0, -iy0) : WIN, jhi = col_in ? min(WIN, H - iy0) : WIN;
  float w[WIN];
  auto load_window = [&](int p) {
    // Opaque to the compiler, so that it forms each row's address and test
    // here, a plane at a time, instead of holding WIN of them in registers.
    int stride = W, lo = jlo, hi = jhi;
    asm volatile("" : "+r"(stride), "+r"(lo), "+r"(hi));
    const T* ptr = x + ((long long)p * H + iy0) * W + ix;
#pragma unroll
    for (int j = 0; j < WIN; ++j) {
      w[j] = (j >= lo && j < hi) ? load(ptr) : 0.f;
      ptr += stride;
    }
  };
  int p = blockIdx.z;
  if constexpr (K > 0) {
    if (active && p < P) load_window(p);
  }
  const int lane = threadIdx.x & 31;
  for (int buf = 0; p < P; p += gridDim.z, buf ^= 1) {
    float (*vb)[kCols] = vert[buf];
    if (active) {
      if constexpr (K > 0) {
#pragma unroll
        for (int a = 0; a < kRows; ++a) {
          float s = 0.f;
#pragma unroll
          for (int i = 0; i < K; ++i) s += t.y[i] * w[S * a + i];
          vb[a][c] = s;
        }
        // The next plane's window is in flight while this plane's rows are written.
        if (p + (int)gridDim.z < P) load_window(p + gridDim.z);
      } else {
        const T* col = x + (size_t)p * H * W + ix;
        for (int a = 0; a < kRows; ++a) {
          float s = 0.f;
          for (int i = 0; i < ky; ++i) {
            const int iy = iy0 + S * a + i;
            s += t.y[i] * ((col_in && iy >= 0 && iy < H) ? load(col + (size_t)iy * W) : 0.f);
          }
          vb[a][c] = s;
        }
      }
    }
    __syncthreads();  // one barrier a plane: the two buffers alternate
    T* plane = out + (size_t)p * OH * OW;
    for (int r = threadIdx.x >> 5; r < kRows && v0 + r < OH; r += kThreads / 32) {
      T* row = plane + (size_t)(v0 + r) * OW;
      const bool pair_ok = (reinterpret_cast<size_t>(row) % (2 * sizeof(T))) == 0;
      const float* vr = vb[r];
      for (int q = lane; 2 * q < n_out; q += 32) {
        const int u = u0 + 2 * q;
        float s0 = 0.f, s1 = 0.f;
        if constexpr (K > 0) {
          constexpr int NH = pair_cols<FORM, K>();
          float h[NH];
          if constexpr (S == 2) {
#pragma unroll
            for (int j = 0; j < NH; j += 4) {
              const float4 f = *reinterpret_cast<const float4*>(vr + 4 * q + j);
              h[j] = f.x;
              h[j + 1] = f.y;
              h[j + 2] = f.z;
              h[j + 3] = f.w;
            }
          } else {
#pragma unroll
            for (int j = 0; j < NH; j += 2) {
              const float2 f = *reinterpret_cast<const float2*>(vr + 2 * q + j);
              h[j] = f.x;
              h[j + 1] = f.y;
            }
          }
#pragma unroll
          for (int j = 0; j < K; ++j) s0 += t.x[j] * h[j];
#pragma unroll
          for (int j = 0; j < K; ++j) s1 += t.x[j] * h[S + j];
        } else {
          const float* hp = vr + 2 * S * q;
          for (int j = 0; j < kx; ++j) s0 += t.x[j] * hp[j];
          for (int j = 0; j < kx; ++j) s1 += t.x[j] * hp[S + j];
        }
        if (u + 1 >= OW) {
          store(row + u, s0);
        } else if (pair_ok) {
          store2(row + u, s0, s1);
        } else {
          store(row + u, s0);
          store(row + u + 1, s1);
        }
      }
    }
  }
}

template <typename T, int FORM, int K>
void launch_form(const T* x, T* out, int P, int H, int W, int OH, int OW, int py0, int px0,
                 int ky, int kx, const Taps& t, int blocks_per_sm, cudaStream_t s) {
  const int tw = tile_w<FORM>(kx);
  const dim3 grid = plane_grid((OW + tw - 1) / tw, (OH + kRows - 1) / kRows, P, blocks_per_sm);
  fir_kernel<T, FORM, K><<<grid, kThreads, 0, s>>>(x, out, P, H, W, OH, OW, py0, px0, ky, kx, t);
}

template <typename T, int FORM>
void launch_taps(const T* x, T* out, int P, int H, int W, int OH, int OW, int py0, int px0,
                 int ky, int kx, const Taps& t, int bps, cudaStream_t s) {
  if (ky == 4 && kx == 4) {
    launch_form<T, FORM, 4>(x, out, P, H, W, OH, OW, py0, px0, ky, kx, t, bps, s);
  } else if (ky == 12 && kx == 12) {
    launch_form<T, FORM, 12>(x, out, P, H, W, OH, OW, py0, px0, ky, kx, t, bps, s);
  } else {
    launch_form<T, FORM, 0>(x, out, P, H, W, OH, OW, py0, px0, ky, kx, t, bps, s);
  }
}

template <typename T>
void launch(int form, const T* x, T* out, int P, int H, int W, int OH, int OW, int py0, int px0,
            int ky, int kx, const Taps& t, int bps, cudaStream_t s) {
  if (form == kSame) {
    launch_taps<T, kSame>(x, out, P, H, W, OH, OW, py0, px0, ky, kx, t, bps, s);
  } else {
    launch_taps<T, kDown2>(x, out, P, H, W, OH, OW, py0, px0, ky, kx, t, bps, s);
  }
}

// ---------------------------------------------------------------- K7: up2

constexpr int kMaxPhaseTaps = kMaxTaps / 2;
constexpr int kUpThreads = 256;   // 8 warps
constexpr int kUpRows = 64;       // output rows of a tile: 32 row pairs
constexpr int kUpGroupPairs = 8;  // row pairs a thread of the vertical pass walks
constexpr int kUpCols = 64;       // columns of the vertical buffer: 256 threads / 4 groups
// Blocks of a launch an SM (several resident waves): on an H100 the fastest of 2 .. 1024
// at StyleGAN3-T's x2 shapes, which chip_smoke.py times on every run.
constexpr int kUpBlocksPerSM = 64;

// One axis of the polyphase split: output 2b + r (r the output parity) is
// sum_t t[r][t] * X[b + d[r] + t], t < n[r]; d[1] - d[0] is 0 or 1.
struct Phases {
  float t[2][kMaxPhaseTaps];
  int n[2];
  int d[2];
};

// Column pairs of a tile: the vertical pass's window (TW - 1 + the widest
// phase window, at most kUpCols) fits one column a thread.
template <int K>
__host__ __device__ constexpr int up_tile_pairs() {
  return K > 0 ? kUpCols + 1 - ((K + 1) / 2 + 1) : kUpCols + 1 - (kMaxPhaseTaps + 1);
}

// The horizontal pass of one plane: vertical rows [kUpRows][kUpCols] in
// shared memory -> output rows oy0 .. oy0 + kUpRows - 1, column pairs
// b0 .. b0 + TW - 1.  A warp takes every eighth row, a lane every 32nd
// pair, so a warp's pair stores are contiguous.  NT > 0: NT taps in each
// phase (compile time) and SX = d[1] - d[0]; NT == 0: counts at run time.
template <typename T, int TW, int NT, int SX>
__device__ __forceinline__ void up_rows(const float (*vert)[kUpCols], T* __restrict__ plane,
                                        int oy0, int b0, int OH, int OW, const Phases& px,
                                        const float* cx0, const float* cx1) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < kUpRows; r += kUpThreads / 32) {
    const int oy = oy0 + r;
    if (oy < 0 || oy >= OH) continue;
    T* row = plane + (size_t)oy * OW;
    const bool pair_ok = (reinterpret_cast<size_t>(row) % (2 * sizeof(T))) == 0;
    const float* v = vert[r];
    for (int bl = lane; bl < TW; bl += 32) {
      const int u = 2 * (b0 + bl);
      if (u >= OW) break;
      float s0 = 0.f, s1 = 0.f;
      if constexpr (NT > 0) {
        float w[NT + SX];
#pragma unroll
        for (int j = 0; j < NT + SX; ++j) w[j] = v[bl + j];
#pragma unroll
        for (int j = 0; j < NT; ++j) s0 += cx0[j] * w[j];
#pragma unroll
        for (int j = 0; j < NT; ++j) s1 += cx1[j] * w[j + SX];
      } else {
        const int sx = px.d[1] - px.d[0];
        for (int j = 0; j < px.n[0]; ++j) s0 += px.t[0][j] * v[bl + j];
        for (int j = 0; j < px.n[1]; ++j) s1 += px.t[1][j] * v[bl + sx + j];
      }
      if (pair_ok && u + 1 < OW) {
        store2(row + u, s0, s1);
      } else {
        store(row + u, s0);
        if (u + 1 < OW) store(row + u + 1, s1);
      }
    }
  }
}

// One block per output tile of kUpRows x 2*TW; the z dimension of the grid
// walks the planes.  K > 0 fixes the tap count of both axes (K/2 taps in
// each phase, K even) so the tap loops and the register window unroll;
// K == 0 reads the phases' counts at run time.
template <typename T, int UP, int K>
__global__ void __launch_bounds__(kUpThreads)
fir_up_kernel(const T* __restrict__ x, T* __restrict__ out, int P, int H, int W, int OH, int OW,
              Phases py, Phases px) {
  static_assert(UP == 2, "only the x2 form is instantiated");
  static_assert(K % 2 == 0, "a fixed tap count is even: K/2 taps in each phase");
  constexpr int TW = up_tile_pairs<K>();
  constexpr int NT = K / 2;                       // taps in each phase (0: at run time)
  constexpr int WIN = K > 0 ? kUpGroupPairs + NT - 1 : 1;
  __shared__ float vert[2][kUpRows][kUpCols];
  const int ey = py.d[1] - py.d[0];  // the pair (2a + ey, 2a + ey + 1) reads rows a + d[ey] + t
  const int sx = px.d[1] - px.d[0];
  const int a0 = blockIdx.y * (kUpRows / 2) - ey;  // first row pair of the tile
  const int b0 = blockIdx.x * TW;                   // first column pair
  const int oy0 = 2 * a0 + ey;                      // output row of vertical row 0
  // The vertical item of this thread: one column of the window, 8 row pairs.
  const int c = threadIdx.x % kUpCols, g = threadIdx.x / kUpCols;
  const int nx = TW - 1 + max(px.n[0], px.n[1] + sx);
  const int ix = b0 + px.d[0] + c;
  const bool col_in = c < nx && ix >= 0 && ix < W;
  const int iy0 = a0 + g * kUpGroupPairs + py.d[ey];  // first input row of the item
  // Taps in registers (static indices only).
  float cy0[NT > 0 ? NT : 1], cy1[NT > 0 ? NT : 1], cx0[NT > 0 ? NT : 1], cx1[NT > 0 ? NT : 1];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    cy0[j] = ey ? py.t[1][j] : py.t[0][j];  // the pair's first row: parity ey
    cy1[j] = ey ? py.t[0][j] : py.t[1][j];
    cx0[j] = px.t[0][j];
    cx1[j] = px.t[1][j];
  }
  float w[WIN];
  auto load_window = [&](int p) {
    const T* col = x + (size_t)p * H * W + ix;
#pragma unroll
    for (int j = 0; j < WIN; ++j) {
      const int iy = iy0 + j;
      w[j] = (col_in && iy >= 0 && iy < H) ? load(col + (size_t)iy * W) : 0.f;
    }
  };
  int p = blockIdx.z;
  if constexpr (K > 0) {
    if (p < P) load_window(p);
  }
  for (int buf = 0; p < P; p += gridDim.z, buf ^= 1) {
    float (*vb)[kUpCols] = vert[buf];
    if (c < nx) {
      const int r0 = 2 * g * kUpGroupPairs;
      if constexpr (K > 0) {
#pragma unroll
        for (int a = 0; a < kUpGroupPairs; ++a) {
          float s0 = 0.f, s1 = 0.f;
#pragma unroll
          for (int j = 0; j < NT; ++j) s0 += cy0[j] * w[a + j];
#pragma unroll
          for (int j = 0; j < NT; ++j) s1 += cy1[j] * w[a + j];
          vb[r0 + 2 * a][c] = s0;
          vb[r0 + 2 * a + 1][c] = s1;
        }
      } else {
        const T* col = x + (size_t)p * H * W + ix;
        const float* t0 = py.t[ey];
        const float* t1 = py.t[1 - ey];
        const int n0 = py.n[ey], n1 = py.n[1 - ey];
        for (int a = 0; a < kUpGroupPairs; ++a) {
          float s0 = 0.f, s1 = 0.f;
          for (int j = 0; j < max(n0, n1); ++j) {
            const int iy = iy0 + a + j;
            const float v = (col_in && iy >= 0 && iy < H) ? load(col + (size_t)iy * W) : 0.f;
            if (j < n0) s0 += t0[j] * v;
            if (j < n1) s1 += t1[j] * v;
          }
          vb[r0 + 2 * a][c] = s0;
          vb[r0 + 2 * a + 1][c] = s1;
        }
      }
    }
    // The next plane's window is in flight while this plane's rows are written.
    if constexpr (K > 0) {
      if (p + (int)gridDim.z < P) load_window(p + gridDim.z);
    }
    __syncthreads();  // one barrier a plane: the two buffers alternate
    T* plane = out + (size_t)p * OH * OW;
    if constexpr (K == 0) {
      up_rows<T, TW, 0, 0>(vb, plane, oy0, b0, OH, OW, px, cx0, cx1);
    } else if (sx) {
      up_rows<T, TW, NT, 1>(vb, plane, oy0, b0, OH, OW, px, cx0, cx1);
    } else {
      up_rows<T, TW, NT, 0>(vb, plane, oy0, b0, OH, OW, px, cx0, cx1);
    }
  }
}

template <typename T, int K>
void launch_up(const T* x, T* out, int P, int H, int W, int OH, int OW, const Phases& py,
               const Phases& px, int blocks_per_sm, cudaStream_t s) {
  constexpr int TW = up_tile_pairs<K>();
  const int ey = py.d[1] - py.d[0];
  const dim3 grid = plane_grid(((OW + 1) / 2 + TW - 1) / TW, (OH + ey + kUpRows - 1) / kUpRows, P,
                               blocks_per_sm);
  fir_up_kernel<T, 2, K><<<grid, kUpThreads, 0, s>>>(x, out, P, H, W, OH, OW, py, px);
}

template <typename T>
void launch_up_taps(const T* x, T* out, int P, int H, int W, int OH, int OW, const Phases& py,
                    const Phases& px, int bps, cudaStream_t s) {
  auto all = [&](int n) { return py.n[0] == n && py.n[1] == n && px.n[0] == n && px.n[1] == n; };
  if (all(2)) {
    launch_up<T, 4>(x, out, P, H, W, OH, OW, py, px, bps, s);
  } else if (all(6)) {
    launch_up<T, 12>(x, out, P, H, W, OH, OW, py, px, bps, s);
  } else {
    launch_up<T, 0>(x, out, P, H, W, OH, OW, py, px, bps, s);
  }
}

bool read_phases(Phases& ph, const float* taps, const int* geom) {
  for (int r = 0; r < 2; ++r) {
    ph.n[r] = geom[r];
    ph.d[r] = geom[2 + r];
    if (ph.n[r] < 0 || ph.n[r] > kMaxPhaseTaps) return false;
    for (int j = 0; j < kMaxPhaseTaps; ++j) ph.t[r][j] = j < ph.n[r] ? taps[r * kMaxPhaseTaps + j] : 0.f;
  }
  const int s = ph.d[1] - ph.d[0];
  return s == 0 || s == 1;
}

}  // namespace

// Launches on ``stream`` and returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments outside the kernel's contract).
// ``form`` is 0 same, 1 down2; ``taps_y``/``taps_x`` are host
// arrays of ky/kx correlation taps; ``is_bf16`` selects the element type
// of ``x`` and ``out`` (bf16 or f32); ``blocks_per_sm`` sizes the grid
// (0: kBlocksPerSM).
extern "C" int gantrack_fir(const void* x, void* out, int P, int H, int W, int OH, int OW,
                            int form, int py0, int px0, int ky, int kx, const float* taps_y,
                            const float* taps_x, int is_bf16, int blocks_per_sm, void* stream) {
  if (form < kSame || form > kDown2 || ky < 1 || kx < 1 || ky > kMaxTaps || kx > kMaxTaps ||
      P < 1 || H < 1 || W < 1 || OH < 1 || OW < 1 || blocks_per_sm < 0) {
    return (int)cudaErrorInvalidValue;
  }
  Taps t = {};
  for (int i = 0; i < ky; ++i) t.y[i] = taps_y[i];
  for (int j = 0; j < kx; ++j) t.x[j] = taps_x[j];
  const int bps = blocks_per_sm > 0 ? blocks_per_sm : kBlocksPerSM;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    launch<__nv_bfloat16>(form, (const __nv_bfloat16*)x, (__nv_bfloat16*)out, P, H, W, OH, OW,
                          py0, px0, ky, kx, t, bps, s);
  } else {
    launch<float>(form, (const float*)x, (float*)out, P, H, W, OH, OW, py0, px0, ky, kx, t, bps,
                  s);
  }
  return (int)cudaGetLastError();
}

// K7, the x2 form: ``taps`` is [2 axes (y, x)][2 parities][kMaxPhaseTaps]
// floats and ``geom`` [2 axes][n0, n1, d0, d1] ints, the polyphase split
// that ops/fir.py ``up2_phases`` makes of each axis' taps and low pad.
// ``blocks_per_sm`` sizes the grid (0: kUpBlocksPerSM).  Launches on
// ``stream`` and returns cudaGetLastError() (or cudaErrorInvalidValue for
// arguments outside the kernel's contract).
extern "C" int gantrack_fir_up2(const void* x, void* out, int P, int H, int W, int OH, int OW,
                                const float* taps, const int* geom, int is_bf16,
                                int blocks_per_sm, void* stream) {
  Phases py = {}, px = {};
  if (P < 1 || H < 1 || W < 1 || OH < 1 || OW < 1 || !read_phases(py, taps, geom) ||
      !read_phases(px, taps + 2 * kMaxPhaseTaps, geom + 4) || blocks_per_sm < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int bps = blocks_per_sm > 0 ? blocks_per_sm : kUpBlocksPerSM;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    launch_up_taps<__nv_bfloat16>((const __nv_bfloat16*)x, (__nv_bfloat16*)out, P, H, W, OH, OW,
                                  py, px, bps, s);
  } else {
    launch_up_taps<float>((const float*)x, (float*)out, P, H, W, OH, OW, py, px, bps, s);
  }
  return (int)cudaGetLastError();
}
