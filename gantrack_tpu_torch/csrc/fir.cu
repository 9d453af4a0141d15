// Separable resample FIR in five forms (K5 same, K6 down2, K7 up2 and up4,
// and down4), and down2 and up2 with a 2-D filter, for NVIDIA Hopper
// (sm_90a).
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
// StyleGAN3's factor 4, which the JAX package computes with XLA
// convolutions (no TPU kernel), takes up4 (``fir_up_kernel<T, 4, K>``) and
// down4 (``fir_down4_kernel``): the same contracts with 4 for 2.
// Samples outside the image are zero, so any pads work, including the
// negative ones (cropping) of the augment pipe.  Sums are f32; the output
// has the input's type (f32 or bf16).  The forms are closed under
// transposition (adjoint(same) = same, adjoint(down2) = up2 and back,
// adjoint(down4) = up4 and back), so the PyTorch wrapper's backward is
// this kernel again, to any order.
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
// K7 at x4: the output is sixteen times the input, so its writes are the
// byte bound (2.59 of 2.77 GB at StyleGAN3-T's largest call).  A block
// owns an output tile of 64 rows x 128 columns (64 at f32) and walks the
// planes; per plane it stages the tile's input box (21 x 40 at 24 taps)
// as f32 in shared memory, loaded while the last plane was computed, runs
// the vertical polyphase pass into a f32 buffer, then the horizontal pass
// into the output tile in shared memory (a lane computes one 16-byte word
// of outputs: the output column's slot and group are static for a
// launch, so the taps unroll), rounded once, and copies the tile's rows
// out in the widest words each row's address allows, neighbouring lanes
// on neighbouring words.  (The rows of StyleGAN3-T's canvases are only
// 4-byte aligned; storing each lane's 16 bytes straight from registers,
// shifted to the row's 16-byte boundaries by warp shuffles, measured 1.28x
// slower on an H100 at its largest call, and unrolling the passes or
// capping the registers slower too.)  The down4 kernel (its adjoint)
// reads sixteen times what it writes: K6's register column at step 4,
// streamed (each input sample is read once and added into the output rows
// whose taps reach it, so no window of 84 rows is held; a column wholly
// inside the image skips the bounds tests), then K6's horizontal pass
// with 16-byte words at step 4.  Neither uses atomics: the bits do not
// depend on the grid.
//
// The 2-D forms (``fir_kernel<T, kDown2, KY, KX>``, ``fir_up_kernel<T, 2,
// KY, KX>``) take StyleGAN3-R's radial 12 x 12 down-filters and their x2
// adjoints, which the JAX package computes with XLA convolutions (no TPU
// kernel): the same contracts with one 2-D tap array f[i][j] for fy[i]
// fx[j], and up2 polyphase over 2 x 2 output phases.  With no channel
// reduction, a tensor-core product would need a banded operand that is
// over 90 % zeros, so they run as f32 FMAs on the CUDA cores: 144
// multiply-adds an output (36 at x2, a quarter of the taps landing on
// input samples) against a read and a write, about 1.4x the byte bound at
// StyleGAN3-R's largest call, so operations bound them.  A block walks
// the planes of one output tile; each plane's input window comes into
// shared memory by bulk copies (the copy engine, one a row of the words
// that hold it: the rows are only element-aligned) while the last plane
// is computed, and is unpacked as f32 (the ↓2 form's even and odd columns
// apart); a thread walks the window rows of a block of outputs from
// registers, so that a sample loaded feeds up to 6 output rows' taps, and
// the taps are kernel parameters, read by the FMAs directly.  The x2
// form's output, four times its input, leaves through a tile in shared
// memory in whole rows.  The separable forms and these share no inner
// loop: a vertical then a horizontal pass against one 2-D window.  The
// first form of both staged the window with loads from every thread,
// whose latency the few blocks an SM (a 24-KB window each) could not
// hide, and stored the x2 outputs from registers, a lane's 16 bytes four
// words apart: 5.74 (↓2) and 6.14 ms (x2) at StyleGAN3-R's L10 on an
// H100, back to back, against 4.97 and 4.30 ms now (chip_smoke.py's
// phase 1 times them).
//
// Tap counts 4 and 12 (24 at x4) are unrolled at compile time; other
// counts up to kMaxTaps take a generic loop (K5, K6, down4: the vertical
// pass then reads each tap's sample from device memory, not from a
// register window).  K7's factor is a template parameter, instantiated at
// 2 and 4.  The grid sizes (blocks an SM) are the fastest of 2 .. 1024
// on an H100 at StyleGAN3-T's shapes, which chip_smoke.py times on every
// run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

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

// ------------------------------------------------- K7 at x4, and the ↓4 adjoint

constexpr int kUp4PhaseTaps = kMaxTaps / 4;  // taps of a residue, at most
constexpr int kUp4Threads = 256;             // 8 warps
constexpr int kUp4Rows = 64;                 // output rows of a tile: 16 groups of 4
constexpr int kUp4Groups = kUp4Rows / 4;
// Blocks of a launch an SM: on an H100 the fastest of 2 .. 1024 at
// StyleGAN3-T's x4 shapes, which chip_smoke.py times on every run.
constexpr int kUp4BlocksPerSM = 128;

// One axis of the x4 polyphase split in the kernel's order: the four
// outputs 4a + e + i (slot i = 0 .. 3; residue (e + i) mod 4) read the
// same input samples, out[4a + e + i] = sum_t t[i][t] * X[a + D + t],
// t < n[i].  Built by read_up4_axis from ops/fir.py ``up_phases``.
struct Up4Axis {
  float t[4][kUp4PhaseTaps];
  int n[4];
  int e;
  int D;
};

// The tile of the x4 kernel by element type: a lane computes one 16-byte
// word of outputs (kChunk) a row, 16 words a row, so a warp takes two rows
// at once; the input box holds the tile's columns (kCols / 4 groups, one
// more where the tile starts inside a group, and the taps' reach).
template <typename T>
struct Up4Tile {
  static constexpr int kChunk = 16 / sizeof(T);
  static constexpr int kCols = 16 * kChunk;
  static constexpr int kBoxCols = kCols / 4 + kUp4PhaseTaps;
  // Odd at bf16, so the two half-warps' rows fall on banks of either parity.
  static constexpr int kVertPitch = kBoxCols + (sizeof(T) == 2 ? 1 : 0);
};

__device__ __forceinline__ unsigned bf16x2_bits(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

// The lane's word: outputs k = 0 .. A-1 at tile column A*q + k, slot
// (PHI + k) mod 4 and group offset (PHI + k) / 4 from the vertical row
// ``v`` (already at the lane's first group), rounded once into ``dst``.
template <typename T, int NT, int PHI>
__device__ __forceinline__ void up4_word(const float* v, T* dst, const Up4Axis& ax) {
  constexpr int A = Up4Tile<T>::kChunk;
  float o[A];
  if constexpr (NT > 0) {
    constexpr int NW = (PHI + A - 1) / 4 + NT;
    float w[NW];
#pragma unroll
    for (int j = 0; j < NW; ++j) w[j] = v[j];
#pragma unroll
    for (int k = 0; k < A; ++k) {
      float s = 0.f;
#pragma unroll
      for (int t = 0; t < NT; ++t) s += ax.t[(PHI + k) % 4][t] * w[(PHI + k) / 4 + t];
      o[k] = s;
    }
  } else {
#pragma unroll
    for (int k = 0; k < A; ++k) {
      const int slot = (PHI + k) % 4, go = (PHI + k) / 4;
      float s = 0.f;
      for (int t = 0; t < ax.n[slot]; ++t) s += ax.t[slot][t] * v[go + t];
      o[k] = s;
    }
  }
  if constexpr (sizeof(T) == 2) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(bf16x2_bits(o[0], o[1]), bf16x2_bits(o[2], o[3]),
                                                bf16x2_bits(o[4], o[5]), bf16x2_bits(o[6], o[7]));
  } else {
    *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
  }
}

// The horizontal pass of one plane: vertical rows -> the output tile in
// shared memory, one 16-byte word a lane, two rows a warp at a time.
template <typename T, int NT, int PHI>
__device__ __forceinline__ void up4_rows(const float (*vert)[Up4Tile<T>::kVertPitch],
                                         T (*stage)[Up4Tile<T>::kCols], int oy0, int OH, int n,
                                         const Up4Axis& ax) {
  constexpr int A = Up4Tile<T>::kChunk;
  const int lane = threadIdx.x & 31, q = lane & 15;
  if (A * q >= n) return;
  for (int r = 2 * (threadIdx.x >> 5) + (lane >> 4); r < kUp4Rows; r += 16) {
    if (oy0 + r < 0 || oy0 + r >= OH) continue;
    up4_word<T, NT, PHI>(vert[r] + (A / 4) * q, stage[r] + A * q, ax);
  }
}

// One row of the staged tile to device memory in the widest words its
// and the source's addresses allow (16 bytes where both are so aligned),
// lanes on neighbouring words.
template <typename W, typename T>
__device__ __forceinline__ void copy_words(T* dst, const T* src, int n, int lane) {
  constexpr int E = sizeof(W) / sizeof(T);
  const int words = n / E;
  for (int j = lane; j < words; j += 32) {
    reinterpret_cast<W*>(dst)[j] = reinterpret_cast<const W*>(src)[j];
  }
  for (int j = words * E + lane; j < n; j += 32) dst[j] = src[j];
}

template <typename T>
__device__ __forceinline__ void copy_row(T* dst, const T* src, int n, int lane) {
  const size_t a = reinterpret_cast<size_t>(dst) | reinterpret_cast<size_t>(src);
  if (a % 16 == 0) {
    copy_words<uint4>(dst, src, n, lane);
  } else if (a % 8 == 0) {
    copy_words<uint2>(dst, src, n, lane);
  } else if (a % 4 == 0) {
    copy_words<unsigned>(dst, src, n, lane);
  } else {
    copy_words<T>(dst, src, n, lane);
  }
}

// K7 at x4: one block per output tile of kUp4Rows x kCols; the z dimension
// of the grid walks the planes.  Per plane: the tile's input box (staged
// as f32, the next plane's in flight in registers), the vertical pass
// into a f32 buffer, the horizontal pass into the output tile in shared
// memory (rounded once), then the tile's rows out in wide words.  K > 0
// fixes the tap count of both axes (K/4 in each slot); K == 0 reads the
// counts at run time.
template <typename T, int UP, int K>
__global__ void __launch_bounds__(kUp4Threads)
fir_up_kernel(const T* __restrict__ x, T* __restrict__ out, int P, int H, int W, int OH, int OW,
              Up4Axis ay, Up4Axis ax) {
  static_assert(UP == 4, "the x4 form");
  static_assert(K % 4 == 0, "a fixed tap count is a multiple of 4: K/4 taps in each slot");
  using G = Up4Tile<T>;
  constexpr int NT = K / 4;
  constexpr int BR = kUp4Groups + (K > 0 ? NT : kUp4PhaseTaps) - 1;  // box rows
  constexpr int BC = G::kBoxCols;
  constexpr int NL = (BR * BC + kUp4Threads - 1) / kUp4Threads;       // box loads a thread
  __shared__ float box[2][BR][BC];
  __shared__ float vert[kUp4Rows][G::kVertPitch];
  __shared__ uint4 stage_words[kUp4Rows * G::kCols * sizeof(T) / 16];
  T (*stage)[G::kCols] = reinterpret_cast<T (*)[G::kCols]>(stage_words);
  const int tid = threadIdx.x, lane = tid & 31;
  // Vertical row 0 is output row oy0 = 4 * a0 + ay.e, the first of a group.
  const int oy0 = blockIdx.y * kUp4Rows - ((4 - ay.e) & 3);
  const int a0 = (oy0 - ay.e) / 4;  // exact
  // The tile's first output column starts slot phi of group gx0.
  const int ub = blockIdx.x * G::kCols, n = min(G::kCols, OW - ub);
  const int phi = (ub - ax.e) & 3;
  const int gx0 = (ub - ax.e - phi) / 4;  // exact
  const int iy0 = a0 + ay.D, ix0 = gx0 + ax.D;
  float pre[NL];
  auto load_box = [&](int p) {
    const T* plane = x + (size_t)p * H * W;
#pragma unroll
    for (int k = 0; k < NL; ++k) {
      const int idx = tid + k * kUp4Threads, iy = iy0 + idx / BC, ix = ix0 + idx % BC;
      pre[k] = (idx < BR * BC && iy >= 0 && iy < H && ix >= 0 && ix < W)
                   ? load(plane + (size_t)iy * W + ix) : 0.f;
    }
  };
  int p = blockIdx.z;
  if (p < P) load_box(p);
  for (int buf = 0; p < P; p += gridDim.z, buf ^= 1) {
    float* bx = &box[buf][0][0];
#pragma unroll
    for (int k = 0; k < NL; ++k) {
      if (tid + k * kUp4Threads < BR * BC) bx[tid + k * kUp4Threads] = pre[k];
    }
    // The next plane's box is in flight while this plane is computed.
    if (p + (int)gridDim.z < P) load_box(p + gridDim.z);
    __syncthreads();  // the box is in; the last plane's tile has left shared memory
    for (int it = tid; it < kUp4Groups * BC; it += kUp4Threads) {
      const int g = it / BC, c = it % BC;
      if constexpr (NT > 0) {
        float w[NT];
#pragma unroll
        for (int t = 0; t < NT; ++t) w[t] = box[buf][g + t][c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float s = 0.f;
#pragma unroll
          for (int t = 0; t < NT; ++t) s += ay.t[i][t] * w[t];
          vert[4 * g + i][c] = s;
        }
      } else {
        for (int i = 0; i < 4; ++i) {
          float s = 0.f;
          for (int t = 0; t < ay.n[i]; ++t) s += ay.t[i][t] * box[buf][g + t][c];
          vert[4 * g + i][c] = s;
        }
      }
    }
    __syncthreads();
    switch (phi) {
      case 0: up4_rows<T, NT, 0>(vert, stage, oy0, OH, n, ax); break;
      case 1: up4_rows<T, NT, 1>(vert, stage, oy0, OH, n, ax); break;
      case 2: up4_rows<T, NT, 2>(vert, stage, oy0, OH, n, ax); break;
      default: up4_rows<T, NT, 3>(vert, stage, oy0, OH, n, ax); break;
    }
    __syncthreads();
    T* plane = out + (size_t)p * OH * OW + ub;
    for (int r = tid >> 5; r < kUp4Rows; r += kUp4Threads / 32) {
      const int oy = oy0 + r;
      if (oy >= 0 && oy < OH) copy_row(plane + (size_t)oy * OW, stage[r], n, lane);
    }
  }
}

template <typename T, int K>
void launch_up4(const T* x, T* out, int P, int H, int W, int OH, int OW, const Up4Axis& ay,
                const Up4Axis& ax, int blocks_per_sm, cudaStream_t s) {
  constexpr int TC = Up4Tile<T>::kCols;
  const int fy = (4 - ay.e) & 3;
  const dim3 grid = plane_grid((OW + TC - 1) / TC, (OH + fy + kUp4Rows - 1) / kUp4Rows, P,
                               blocks_per_sm);
  fir_up_kernel<T, 4, K><<<grid, kUp4Threads, 0, s>>>(x, out, P, H, W, OH, OW, ay, ax);
}

template <typename T>
void launch_up4_taps(const T* x, T* out, int P, int H, int W, int OH, int OW, const Up4Axis& ay,
                     const Up4Axis& ax, int bps, cudaStream_t s) {
  auto all = [](const Up4Axis& a, int n) {
    return a.n[0] == n && a.n[1] == n && a.n[2] == n && a.n[3] == n;
  };
  if (all(ay, 6) && all(ax, 6)) {
    launch_up4<T, 24>(x, out, P, H, W, OH, OW, ay, ax, bps, s);
  } else {
    launch_up4<T, 0>(x, out, P, H, W, OH, OW, ay, ax, bps, s);
  }
}

// ``taps`` [4 residues][kUp4PhaseTaps] and ``geom`` [n_0 .. n_3, d_0 .. d_3]
// of one axis (``up_phases``) in the kernel's slot order; false where the
// split is not one (d_r is d_0 up to a residue and d_0 + 1 above).
bool read_up4_axis(Up4Axis& ax, const float* taps, const int* geom) {
  const int* d = geom + 4;
  int at_d0 = 0;
  for (int r = 0; r < 4; ++r) {
    if (geom[r] < 0 || geom[r] > kUp4PhaseTaps) return false;
    if (r > 0 && d[r] != d[r - 1] && d[r] != d[r - 1] + 1) return false;
    at_d0 += d[r] == d[0];
  }
  if (d[3] > d[0] + 1) return false;
  ax.e = at_d0 % 4;
  ax.D = d[ax.e];
  for (int i = 0; i < 4; ++i) {
    const int r = (ax.e + i) % 4;
    ax.n[i] = geom[r];
    for (int j = 0; j < kUp4PhaseTaps; ++j) {
      ax.t[i][j] = j < geom[r] ? taps[r * kUp4PhaseTaps + j] : 0.f;
    }
  }
  return true;
}

constexpr int kDown4Cols = 256;  // window columns of a tile: one a thread
constexpr int kDown4Threads = kDown4Cols;
constexpr int kDown4Rows = 16;   // output rows of a tile
// Blocks of a launch an SM: on an H100 the fastest of 2 .. 1024 at
// StyleGAN3-T's ↓4 shapes, which chip_smoke.py times on every run.
constexpr int kDown4BlocksPerSM = 256;

// Output columns of a tile: the largest even count whose input window,
// 4*(TW - 1) + k columns, fits kDown4Cols.
__host__ __device__ constexpr int down4_tile_w(int k) { return ((kDown4Cols - k) / 4 + 1) & ~1; }

// The vertical pass of the ↓4 kernel down one window column: sample j
// (input row iy0 + j, ``ptr`` at j = 0) is added into the output rows a
// with 0 <= j - 4a < K, taps ascending.  GUARDED reads only the rows
// lo .. hi - 1 and takes the rest as zeros (outside the image); a column
// wholly inside the image skips the tests, which cost 30 % of the
// kernel's time at StyleGAN3-T's largest call.
template <typename T, int K, bool GUARDED>
__device__ __forceinline__ void down4_column(const T* ptr, int stride, int lo, int hi,
                                             const Taps& t, float (&acc)[kDown4Rows]) {
  constexpr int NY = 4 * (kDown4Rows - 1) + K;
#pragma unroll
  for (int j = 0; j < NY; ++j) {
    const float v = (!GUARDED || (j >= lo && j < hi)) ? load(ptr) : 0.f;
    ptr += stride;
#pragma unroll
    for (int a = 0; a < kDown4Rows; ++a) {
      if (j - 4 * a >= 0 && j - 4 * a < K) acc[a] += t.y[j - 4 * a] * v;
    }
  }
}

// The ↓4 adjoint of K7 at x4: one block per output tile of kDown4Rows x
// TW; the z dimension of the grid walks the planes.  Vertical pass: a
// thread owns one column of the window and streams down it, each input
// sample read once and added into the (at most K/4 + 1) output rows whose
// taps reach it, then writes the tile's vertical sums to a shared f32
// buffer (two alternate by plane: one barrier a plane).  Horizontal pass
// as K6's at step 4: a lane takes an output pair and reads its window
// columns as 16-byte words.  Each output sums its vertical taps in
// ascending order, then its horizontal taps.
template <typename T, int K>
__global__ void __launch_bounds__(kDown4Threads)
fir_down4_kernel(const T* __restrict__ x, T* __restrict__ out, int P, int H, int W, int OH,
                 int OW, int py0, int px0, int ky_rt, int kx_rt, Taps t) {
  constexpr int NY = K > 0 ? 4 * (kDown4Rows - 1) + K : 1;  // window rows streamed
  constexpr int NH = (4 + K + 3) / 4 * 4;                      // window columns of a pair
  static_assert(K == 0 || 4 * (down4_tile_w(K) - 2) + NH <= kDown4Cols,
                "a lane's words stay inside the row of the vertical buffer");
  __shared__ __align__(16) float vert[2][kDown4Rows][kDown4Cols];
  const int ky = K > 0 ? K : ky_rt;
  const int kx = K > 0 ? K : kx_rt;
  const int tw = down4_tile_w(kx);
  const int u0 = blockIdx.x * tw, v0 = blockIdx.y * kDown4Rows;
  const int n_out = min(tw, (OW - u0 + 1) & ~1);
  const int nc = 4 * (n_out - 1) + kx;
  const int c = threadIdx.x;
  const int ix = 4 * u0 - px0 + c;
  const bool col_in = ix >= 0 && ix < W;
  const bool active = c < nc;
  const int iy0 = 4 * v0 - py0;
  const int jlo = col_in ? max(0, -iy0) : NY, jhi = col_in ? min(NY, H - iy0) : NY;
  const int lane = threadIdx.x & 31;
  for (int p = blockIdx.z, buf = 0; p < P; p += gridDim.z, buf ^= 1) {
    float (*vb)[kDown4Cols] = vert[buf];
    if (active) {
      if constexpr (K > 0) {
        float acc[kDown4Rows];
#pragma unroll
        for (int a = 0; a < kDown4Rows; ++a) acc[a] = 0.f;
        // Opaque to the compiler, as in fir_kernel's window.
        int stride = W, lo = jlo, hi = jhi;
        asm volatile("" : "+r"(stride), "+r"(lo), "+r"(hi));
        const T* ptr = x + ((long long)p * H + iy0) * W + ix;
        if (lo == 0 && hi == NY) {
          down4_column<T, K, false>(ptr, stride, lo, hi, t, acc);
        } else {
          down4_column<T, K, true>(ptr, stride, lo, hi, t, acc);
        }
#pragma unroll
        for (int a = 0; a < kDown4Rows; ++a) vb[a][c] = acc[a];
      } else {
        const T* col = x + (size_t)p * H * W + ix;
        for (int a = 0; a < kDown4Rows; ++a) {
          float s = 0.f;
          for (int i = 0; i < ky; ++i) {
            const int iy = iy0 + 4 * a + i;
            s += t.y[i] * ((col_in && iy >= 0 && iy < H) ? load(col + (size_t)iy * W) : 0.f);
          }
          vb[a][c] = s;
        }
      }
    }
    __syncthreads();  // one barrier a plane: the two buffers alternate
    T* plane = out + (size_t)p * OH * OW;
    for (int r = threadIdx.x >> 5; r < kDown4Rows && v0 + r < OH; r += kDown4Threads / 32) {
      T* row = plane + (size_t)(v0 + r) * OW;
      const bool pair_ok = (reinterpret_cast<size_t>(row) % (2 * sizeof(T))) == 0;
      const float* vr = vb[r];
      for (int q = lane; 2 * q < n_out; q += 32) {
        const int u = u0 + 2 * q;
        float s0 = 0.f, s1 = 0.f;
        if constexpr (K > 0) {
          float h[NH];
#pragma unroll
          for (int j = 0; j < NH; j += 4) {
            const float4 f = *reinterpret_cast<const float4*>(vr + 8 * q + j);
            h[j] = f.x;
            h[j + 1] = f.y;
            h[j + 2] = f.z;
            h[j + 3] = f.w;
          }
#pragma unroll
          for (int j = 0; j < K; ++j) s0 += t.x[j] * h[j];
#pragma unroll
          for (int j = 0; j < K; ++j) s1 += t.x[j] * h[4 + j];
        } else {
          const float* hp = vr + 8 * q;
          for (int j = 0; j < kx; ++j) s0 += t.x[j] * hp[j];
          for (int j = 0; j < kx; ++j) s1 += t.x[j] * hp[4 + j];
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

template <typename T, int K>
void launch_down4(const T* x, T* out, int P, int H, int W, int OH, int OW, int py0, int px0,
                  int ky, int kx, const Taps& t, int blocks_per_sm, cudaStream_t s) {
  const int tw = down4_tile_w(kx);
  const dim3 grid = plane_grid((OW + tw - 1) / tw, (OH + kDown4Rows - 1) / kDown4Rows, P,
                               blocks_per_sm);
  fir_down4_kernel<T, K><<<grid, kDown4Threads, 0, s>>>(x, out, P, H, W, OH, OW, py0, px0, ky,
                                                         kx, t);
}

template <typename T>
void launch_down4_taps(const T* x, T* out, int P, int H, int W, int OH, int OW, int py0,
                       int px0, int ky, int kx, const Taps& t, int bps, cudaStream_t s) {
  if (ky == 24 && kx == 24) {
    launch_down4<T, 24>(x, out, P, H, W, OH, OW, py0, px0, ky, kx, t, bps, s);
  } else {
    launch_down4<T, 0>(x, out, P, H, W, OH, OW, py0, px0, ky, kx, t, bps, s);
  }
}

// ------------------------------------ 2-D taps at factor 2: down2 and up2 (StyleGAN3-R)

constexpr int k2dMaxTaps = 12;                 // the largest square filter of the 2-D forms
constexpr int k2dPhaseTaps = k2dMaxTaps / 2;   // taps of a slot of the x2 form, at most
constexpr int k2dThreads = 64;                 // threads of a block: 2 warps
constexpr int kD2Tx = 8, kD2Ty = 8;            // down2: threads of a block across and down
constexpr int kD2Rows = 4, kD2Cols = 4;        // down2: outputs of a thread
constexpr int kD2Stages = 1;                   // down2: planes whose words are in flight
constexpr int kD2TileH = kD2Ty * kD2Rows, kD2TileW = kD2Tx * kD2Cols;
constexpr int kU2Tx = 16, kU2Ty = 4;           // up2: threads of a block across and down
constexpr int kU2Rows = 2, kU2Cols = 4;        // up2: output pairs of a thread (2 x 2 phases each)
constexpr int kU2Stages = 2;                   // up2: planes whose words are in flight
constexpr int kU2TileH = kU2Ty * kU2Rows, kU2TileW = kU2Tx * kU2Cols;
// Blocks of a launch an SM: on an H100 the fastest of 2 .. 1024 at
// StyleGAN3-R's shapes, which chip_smoke.py times on every run.
constexpr int k2dBlocksPerSM = 64;
constexpr int k2dUpBlocksPerSM = 128;

// Correlation taps [i][j] (flipped unless flip_filter, gain folded in);
// zero beyond ky, kx.
struct Taps2D {
  float t[k2dMaxTaps][k2dMaxTaps];
};

// The x2 form's static polyphase split of a 2-D filter: along each axis
// the output pair (2a + e, 2a + e + 1) reads the input samples a + d + t
// (ops/fir.py ``up_phases``; slot s is residue (e + s) mod 2), so the 2 x 2
// outputs of pair (a, b) are sum_ts t[sy][sx][t][s] * X[a + dy + t][b + dx + s]
// with t < ny[sy], s < nx[sx].
struct Phases2D {
  float t[2][2][k2dPhaseTaps][k2dPhaseTaps];
  int ny[2], nx[2];
  int ey, dy, ex, dx;
};

// The input window of a 2-D kernel's block: NR x NC samples, unpacked as
// f32 in shared memory (row pitch PITCH; with SPLIT each row's even
// columns in its first HALF floats and its odd ones in the next HALF,
// which the ↓2 form reads apart) from the 16-byte words of device memory
// that hold it, NW a row at most, which a bulk copy brings into shared
// memory a row at a time.
template <typename T, int NR_, int NC_, bool SPLIT_>
struct Win2d {
  static constexpr int NR = NR_, NC = NC_;
  static constexpr bool SPLIT = SPLIT_;
  static constexpr int HALF = SPLIT ? ((NC + 1) / 2 + 3) & ~3 : 0;
  static constexpr int PITCH = SPLIT ? 2 * HALF : (NC + 3) & ~3;
  static constexpr int E = 16 / sizeof(T);        // samples a word
  static constexpr int NW = (NC + 2 * E - 2) / E;
  __device__ static int index(int r, int c) {
    return r * PITCH + (SPLIT ? (c & 1) * HALF + (c >> 1) : c);
  }
};

// The window's rows [r_lo, r_hi) and columns [c_lo, c_hi) lie inside the
// image; the window's sample (0, 0) is image sample (iy0, ix0).  A block's
// window lies at the same place in every plane.
struct Window {
  int iy0, ix0, r_lo, r_hi, c_lo, c_hi;
  template <int NR, int NC>
  __device__ static Window of(int iy0, int ix0, int H, int W) {
    Window w{iy0, ix0, 0, 0, 0, 0};
    w.r_lo = min(max(-iy0, 0), NR);
    w.r_hi = max(min(H - iy0, NR), w.r_lo);
    w.c_lo = min(max(-ix0, 0), NC);
    w.c_hi = max(min(W - ix0, NC), w.c_lo);
    return w;
  }
  // The first sample inside the image of window row r.
  template <typename T>
  __device__ const T* first(const T* plane, int W, int r) const {
    return plane + (size_t)(iy0 + r) * W + (ix0 + c_lo);
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ const char* word_of(const void* p) {
  return reinterpret_cast<const char*>(reinterpret_cast<size_t>(p) & ~(size_t)15);
}

// Zero the window's samples outside the image, once a block.
template <typename B>
__device__ __forceinline__ void zero_window(float* win, const Window& w) {
  for (int it = threadIdx.x; it < B::NR * B::NC; it += k2dThreads) {
    const int r = it / B::NC, c = it % B::NC;
    if (r < w.r_lo || r >= w.r_hi || c < w.c_lo || c >= w.c_hi) win[B::index(r, c)] = 0.f;
  }
}

// Start bringing one plane's rows of the window into ``raw`` (the words
// that hold each row's samples inside the image, one bulk copy a row, by
// the copy engine), completing on ``bar``: each row's thread arrives there
// with the row's bytes.
template <typename B, typename T>
__device__ __forceinline__ void fetch_window(uint4* raw, uint64_t* bar, const Window& w,
                                             const T* plane, int W) {
  for (int r = w.r_lo + threadIdx.x; r < w.r_hi; r += k2dThreads) {
    const T* first = w.first(plane, W, r);
    const char* lo = word_of(first);
    const uint32_t bytes = (uint32_t)(word_of(first + (w.c_hi - w.c_lo - 1)) + 16 - lo);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // after the last reads of raw
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
                 "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(smem_u32(raw + r * B::NW)), "l"(lo), "r"(bytes), "r"(smem_u32(bar)) : "memory");
  }
}

// Wait for the phase of ``bar`` of parity ``parity`` to complete.
__device__ __forceinline__ void wait_bar(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// The fetched words of one plane into the window as f32: whole words as
// two runs of even and odd samples, each row's first and last word in
// part.
template <typename B, typename T>
__device__ __forceinline__ void unpack_window(float* win, const uint4* raw, const Window& w,
                                              const T* plane, int W) {
  constexpr int E = B::E;
  for (int it = threadIdx.x; it < (w.r_hi - w.r_lo) * B::NW; it += k2dThreads) {
    const int r = w.r_lo + it / B::NW, k = it % B::NW;
    const T* first = w.first(plane, W, r);
    // Window column of the word's first sample (negative: before the row's first).
    const int c0 = w.c_lo + (int)((word_of(first) + 16 * k - reinterpret_cast<const char*>(first)) /
                                  (int)sizeof(T));
    if (c0 >= w.c_hi) continue;
    const uint4 v = raw[r * B::NW + k];
    float f[E];
    if constexpr (sizeof(T) == 2) {
      const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        f[2 * j] = __uint_as_float(u[j] << 16);
        f[2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
      }
    } else {
      f[0] = __uint_as_float(v.x);
      f[1] = __uint_as_float(v.y);
      f[2] = __uint_as_float(v.z);
      f[3] = __uint_as_float(v.w);
    }
    if (c0 >= w.c_lo && c0 + E <= w.c_hi) {
      float* even = win + B::index(r, c0);
      float* odd = win + B::index(r, c0 + 1);
#pragma unroll
      for (int e = 0; e < E; ++e) (e % 2 ? odd : even)[B::SPLIT ? e / 2 : e - e % 2] = f[e];
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int c = c0 + e;
        if (c >= w.c_lo && c < w.c_hi) win[B::index(r, c)] = f[e];
      }
    }
  }
}

// One block's staging of the planes it walks: the window, S buffers of the
// words that fill it, and a barrier for each buffer's copies (a phase a
// plane).  The n-th plane of the block comes in buffer n mod S, its copies
// started S planes ahead.
template <typename B, typename T, int S>
struct Stage2d {
  float* win;
  uint4* raw;     // [S][NR * NW]
  uint64_t* bar;  // [S]
  Window w;
  bool rows;  // the window has samples inside the image
  // Zero the window's part outside the image and start the first S planes' copies.
  __device__ void begin(const T* x, int H, int W, int P) {
    rows = w.r_hi > w.r_lo && w.c_hi > w.c_lo;
    if (threadIdx.x == 0 && rows) {
      for (int b = 0; b < S; ++b) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar + b)),
                     "r"(w.r_hi - w.r_lo) : "memory");
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    zero_window<B>(win, w);
    __syncthreads();
    for (int b = 0; b < S; ++b) fetch(x, H, W, P, b);
  }
  // Start the copies of the block's n-th plane, if there is one.
  __device__ void fetch(const T* x, int H, int W, int P, uint32_t n) {
    const int p = blockIdx.z + n * gridDim.z;
    if (p < P && rows) {
      fetch_window<B>(raw + (n % S) * B::NR * B::NW, bar + n % S, w, x + (size_t)p * H * W, W);
    }
  }
  // The block's n-th plane (p) into the window, then the copies of its
  // (n + S)-th started; a barrier between.
  __device__ void next(const T* x, int H, int W, int P, int p, uint32_t n) {
    if (rows) {
      wait_bar(bar + n % S, (n / S) & 1);
      unpack_window<B>(win, raw + (n % S) * B::NR * B::NW, w, x + (size_t)p * H * W, W);
    }
    __syncthreads();  // the window is in; its words are free
    fetch(x, H, W, P, n + S);
  }
};

// N consecutive floats of shared memory (16-byte aligned) into registers.
template <int N>
__device__ __forceinline__ void load_run(const float* p, float (&v)[N]) {
#pragma unroll
  for (int j = 0; j + 4 <= N; j += 4) {
    const float4 f = *reinterpret_cast<const float4*>(p + j);
    v[j] = f.x;
    v[j + 1] = f.y;
    v[j + 2] = f.z;
    v[j + 3] = f.w;
  }
#pragma unroll
  for (int j = N & ~3; j < N; ++j) v[j] = p[j];
}

// One output row's run of N outputs from column u (even), rounded once:
// in pairs where the row allows, else one at a time; columns from OW on
// are skipped.
template <typename T, int N>
__device__ __forceinline__ void store_run(T* row, int u, int OW, const float (&o)[N]) {
  const bool pair_ok = reinterpret_cast<size_t>(row + u) % (2 * sizeof(T)) == 0;
#pragma unroll
  for (int k = 0; k < N; k += 2) {
    const int c = u + k;
    if (c >= OW) break;
    if (pair_ok && c + 1 < OW) {
      store2(row + c, o[k], o[k + 1]);
    } else {
      store(row + c, o[k]);
      if (c + 1 < OW) store(row + c + 1, o[k + 1]);
    }
  }
}

// N outputs, rounded once, into the output tile at ``dst`` (aligned to
// 4 * sizeof(T)).
template <typename T, int N>
__device__ __forceinline__ void put_run(T* dst, const float (&o)[N]) {
  static_assert(N % 4 == 0, "whole runs of 4");
#pragma unroll
  for (int k = 0; k < N; k += 4) {
    if constexpr (sizeof(T) == 2) {
      *reinterpret_cast<uint2*>(dst + k) =
          make_uint2(bf16x2_bits(o[k], o[k + 1]), bf16x2_bits(o[k + 2], o[k + 3]));
    } else {
      *reinterpret_cast<float4*>(dst + k) = make_float4(o[k], o[k + 1], o[k + 2], o[k + 3]);
    }
  }
}

// An output tile of OH_T x OW_T in shared memory to device memory: tile
// row r is output row oy0 + r, tile column c output column ox0 + c; a
// warp a row, in the widest words the addresses allow, lanes on
// neighbouring words (the rows are only element-aligned).
template <int OH_T, int OW_T, typename T>
__device__ __forceinline__ void put_tile(const T* tile, T* plane, int oy0, int ox0, int OH, int OW) {
  const int lane = threadIdx.x & 31;
  const int c_lo = max(-ox0, 0), n = min(OW - ox0, OW_T) - c_lo;
  if (n <= 0) return;
  for (int r = threadIdx.x >> 5; r < OH_T; r += k2dThreads / 32) {
    const int oy = oy0 + r;
    if (oy >= 0 && oy < OH) {
      copy_row(plane + (size_t)oy * OW + ox0 + c_lo, tile + r * OW_T + c_lo, n, lane);
    }
  }
}

template <typename T, int KY, int KX>
using Down2d = Win2d<T, 2 * (kD2TileH - 1) + (KY > 0 ? KY : k2dMaxTaps),
                     2 * (kD2TileW - 1) + (KX > 0 ? KX : k2dMaxTaps), true>;
template <typename T, int KY, int KX>
using Up2d = Win2d<T, kU2TileH + (KY > 0 ? KY / 2 : k2dPhaseTaps) - 1,
                   kU2TileW + (KX > 0 ? KX / 2 : k2dPhaseTaps) - 1, false>;

// ↓2 with a 2-D filter: one block (kD2Tx x kD2Ty threads) per output tile
// of kD2TileH x kD2TileW; the z dimension of the grid walks the planes.
// Each plane's input window (2 * (tile - 1) + k samples each way) comes in
// by bulk copies while the last plane is computed and is unpacked as f32,
// its even and odd columns apart; a thread owns kD2Rows x kD2Cols outputs
// and walks the window rows of its outputs once, each row's 2 * (kD2Cols
// - 1) + kx samples loaded from shared memory in 16-byte words and
// feeding the up to 6 output rows whose taps reach it.  Each output sums
// its taps (i, j) in ascending order, i first, as FMAs into one f32
// accumulator, rounded once.  KY, KX > 0 fix the filter's size at compile
// time (the tap loops unroll with the taps as kernel parameters, no
// guard); 0 reads ky, kx (<= k2dMaxTaps) at run time.
template <typename T, int FORM, int KY, int KX>
__global__ void __launch_bounds__(k2dThreads)
fir_kernel(const T* __restrict__ x, T* __restrict__ out, int P, int H, int W, int OH, int OW,
           int py0, int px0, int ky_rt, int kx_rt, Taps2D t) {
  static_assert(FORM == kDown2, "the 2-D filter runs at ↓2 (↑2 is fir_up_kernel)");
  using B = Down2d<T, KY, KX>;
  constexpr int MY = KY > 0 ? KY : k2dMaxTaps, MX = KX > 0 ? KX : k2dMaxTaps;
  constexpr int NE = kD2Cols + (MX + 1) / 2 - 1;  // even window columns of a thread's outputs
  constexpr int NO = kD2Cols + MX / 2 - 1;        // odd ones
  __shared__ __align__(16) float win[B::NR * B::PITCH];
  __shared__ __align__(16) uint4 raw[kD2Stages * B::NR * B::NW];
  __shared__ __align__(8) uint64_t bar[kD2Stages];
  const int ky = KY > 0 ? KY : ky_rt, kx = KX > 0 ? KX : kx_rt;
  const int v0 = blockIdx.y * kD2TileH, u0 = blockIdx.x * kD2TileW;
  Stage2d<B, T, kD2Stages> st{win, raw, bar,
                              Window::of<B::NR, B::NC>(2 * v0 - py0, 2 * u0 - px0, H, W)};
  st.begin(x, H, W, P);
  const int tx = threadIdx.x % kD2Tx, ty = threadIdx.x / kD2Tx;
  const int v = v0 + kD2Rows * ty, u = u0 + kD2Cols * tx;  // the thread's first output
  const float* run = win + 2 * kD2Rows * ty * B::PITCH + kD2Cols * tx;  // even; odd at + HALF
  uint32_t n = 0;
  for (int p = blockIdx.z; p < P; p += gridDim.z, ++n) {
    st.next(x, H, W, P, p, n);
    if (v < OH && u < OW) {
      float acc[kD2Rows][kD2Cols];
#pragma unroll
      for (int a = 0; a < kD2Rows; ++a) {
#pragma unroll
        for (int c = 0; c < kD2Cols; ++c) acc[a][c] = 0.f;
      }
#pragma unroll
      for (int r = 0; r < 2 * (kD2Rows - 1) + MY; ++r) {
        float e[NE], o[NO];
        load_run(run + r * B::PITCH, e);
        load_run(run + r * B::PITCH + B::HALF, o);
#pragma unroll
        for (int a = 0; a < kD2Rows; ++a) {
          const int i = r - 2 * a;  // the tap row that window row r is to output row a
          if (i < 0 || i >= MY || (KY == 0 && i >= ky)) continue;
#pragma unroll
          for (int j = 0; j < MX; ++j) {
            if (KX == 0 && j >= kx) break;
#pragma unroll
            for (int c = 0; c < kD2Cols; ++c) {
              acc[a][c] += t.t[i][j] * (j % 2 ? o[c + j / 2] : e[c + j / 2]);
            }
          }
        }
      }
      T* plane = out + (size_t)p * OH * OW;
#pragma unroll
      for (int a = 0; a < kD2Rows; ++a) {
        if (v + a < OH) store_run(plane + (size_t)(v + a) * OW, u, OW, acc[a]);
      }
    }
    __syncthreads();  // the window has been read
  }
}

// ×2 with a 2-D filter, polyphase: one block (kU2Tx x kU2Ty threads) per
// tile of kU2TileH x kU2TileW output pairs along each axis (2 kU2TileH x
// 2 kU2TileW outputs); the z dimension of the grid walks the planes.  Each
// plane's input window (tile + slot taps - 1 samples each way) comes in by
// bulk copies while the last plane is computed and is unpacked as f32; a
// thread owns kU2Rows x kU2Cols output pairs, whose 2 x 2 phases each read
// the same slot-tap window of input samples, and walks its window rows
// once, each row's kU2Cols + nx - 1 samples in 16-byte words feeding every
// phase of the pairs its taps reach.  The zero-stuffed grid is never
// built.  Each output sums its slot taps (t, s) in ascending order, t
// first, as the per-output form over the zero-stuffed grid does without
// the zero terms, and goes to the output tile in shared memory, rounded
// once; the tile leaves in whole rows (the output is four times the
// input: its writes are the most bytes).  KY, KX > 0 (even) fix the
// filter's size (KY / 2 taps in each slot); 0 reads the slots' counts at
// run time.
template <typename T, int UP, int KY, int KX>
__global__ void __launch_bounds__(k2dThreads)
fir_up_kernel(const T* __restrict__ x, T* __restrict__ out, int P, int H, int W, int OH, int OW,
              Phases2D ph) {
  static_assert(UP == 2, "the 2-D filter runs at x2 (↓2 is fir_kernel)");
  static_assert(KY % 2 == 0 && KX % 2 == 0, "a fixed size is even: the same taps in each slot");
  using B = Up2d<T, KY, KX>;
  constexpr int NY = KY > 0 ? KY / 2 : k2dPhaseTaps, NX = KX > 0 ? KX / 2 : k2dPhaseTaps;
  constexpr int NWIN = kU2Cols + NX - 1;  // window columns of a thread's pairs
  constexpr int TH = 2 * kU2TileH, TW = 2 * kU2TileW;  // the output tile
  __shared__ __align__(16) float win[B::NR * B::PITCH];
  __shared__ __align__(16) uint4 raw[kU2Stages * B::NR * B::NW];
  __shared__ __align__(16) T tile[TH * TW];
  __shared__ __align__(8) uint64_t bar[kU2Stages];
  const int a0 = blockIdx.y * kU2TileH - ph.ey, b0 = blockIdx.x * kU2TileW - ph.ex;
  Stage2d<B, T, kU2Stages> st{win, raw, bar, Window::of<B::NR, B::NC>(a0 + ph.dy, b0 + ph.dx, H, W)};
  st.begin(x, H, W, P);
  const int tx = threadIdx.x % kU2Tx, ty = threadIdx.x / kU2Tx;
  const int pa = kU2Rows * ty, pb = kU2Cols * tx;     // the thread's first pair in the tile
  const int oy0 = 2 * a0 + ph.ey, ox0 = 2 * b0 + ph.ex;  // the tile's first output
  const bool active = oy0 + 2 * pa < OH && ox0 + 2 * pb < OW;
  const float* run = win + pa * B::PITCH + pb;
  uint32_t n = 0;
  for (int p = blockIdx.z; p < P; p += gridDim.z, ++n) {
    st.next(x, H, W, P, p, n);  // also: the last plane's tile has left
    if (active) {
      float acc[kU2Rows][2][2 * kU2Cols];  // [pair row][y phase][column: pair, x phase]
#pragma unroll
      for (int a = 0; a < kU2Rows; ++a) {
#pragma unroll
        for (int k = 0; k < 2 * kU2Cols; ++k) acc[a][0][k] = acc[a][1][k] = 0.f;
      }
#pragma unroll
      for (int r = 0; r < kU2Rows + NY - 1; ++r) {
        float v[NWIN];
        load_run(run + r * B::PITCH, v);
#pragma unroll
        for (int a = 0; a < kU2Rows; ++a) {
          const int tt = r - a;  // the slot tap that window row r is to pair row a
          if (tt < 0 || tt >= NY) continue;
#pragma unroll
          for (int sy = 0; sy < 2; ++sy) {
            if (KY == 0 && tt >= ph.ny[sy]) continue;
#pragma unroll
            for (int s = 0; s < NX; ++s) {
#pragma unroll
              for (int sx = 0; sx < 2; ++sx) {
                if (KX == 0 && s >= ph.nx[sx]) continue;
#pragma unroll
                for (int c = 0; c < kU2Cols; ++c) {
                  acc[a][sy][2 * c + sx] += ph.t[sy][sx][tt][s] * v[c + s];
                }
              }
            }
          }
        }
      }
#pragma unroll
      for (int a = 0; a < kU2Rows; ++a) {
#pragma unroll
        for (int sy = 0; sy < 2; ++sy) put_run(tile + (2 * (pa + a) + sy) * TW + 2 * pb, acc[a][sy]);
      }
    }
    __syncthreads();  // the tile is whole; the window has been read
    put_tile<TH, TW>(tile, out + (size_t)p * OH * OW, oy0, ox0, OH, OW);
  }
}

template <typename T, int K>
void launch_2d(const T* x, T* out, int P, int H, int W, int OH, int OW, int up, int py0, int px0,
               int ky, int kx, const Taps2D& t, const Phases2D& ph, int bps, cudaStream_t s) {
  if (up == 1) {
    const dim3 grid = plane_grid((OW + kD2TileW - 1) / kD2TileW, (OH + kD2TileH - 1) / kD2TileH,
                                 P, bps > 0 ? bps : k2dBlocksPerSM);
    fir_kernel<T, kDown2, K, K><<<grid, k2dThreads, 0, s>>>(x, out, P, H, W, OH, OW, py0, px0,
                                                            ky, kx, t);
  } else {
    const dim3 grid = plane_grid((OW + ph.ex + 2 * kU2TileW - 1) / (2 * kU2TileW),
                                 (OH + ph.ey + 2 * kU2TileH - 1) / (2 * kU2TileH), P,
                                 bps > 0 ? bps : k2dUpBlocksPerSM);
    fir_up_kernel<T, 2, K, K><<<grid, k2dThreads, 0, s>>>(x, out, P, H, W, OH, OW, ph);
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

// K7 at x4: ``taps`` is [2 axes (y, x)][4 residues][kMaxTaps / 4] floats
// and ``geom`` [2 axes][n_0 .. n_3, d_0 .. d_3] ints, the polyphase split
// that ops/fir.py ``up_phases`` makes of each axis' taps and low pad.
// ``blocks_per_sm`` sizes the grid (0: kUp4BlocksPerSM).  Launches on
// ``stream`` and returns cudaGetLastError() (or cudaErrorInvalidValue for
// arguments outside the kernel's contract).
extern "C" int gantrack_fir_up4(const void* x, void* out, int P, int H, int W, int OH, int OW,
                                const float* taps, const int* geom, int is_bf16,
                                int blocks_per_sm, void* stream) {
  Up4Axis ay = {}, ax = {};
  if (P < 1 || H < 1 || W < 1 || OH < 1 || OW < 1 || !read_up4_axis(ay, taps, geom) ||
      !read_up4_axis(ax, taps + 4 * kUp4PhaseTaps, geom + 8) || blocks_per_sm < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int bps = blocks_per_sm > 0 ? blocks_per_sm : kUp4BlocksPerSM;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    launch_up4_taps<__nv_bfloat16>((const __nv_bfloat16*)x, (__nv_bfloat16*)out, P, H, W, OH, OW,
                                   ay, ax, bps, s);
  } else {
    launch_up4_taps<float>((const float*)x, (float*)out, P, H, W, OH, OW, ay, ax, bps, s);
  }
  return (int)cudaGetLastError();
}

// The ↓4 adjoint: ``taps_y``/``taps_x`` are host arrays of ky/kx
// correlation taps, ``py0``/``px0`` the low pads; otherwise as
// gantrack_fir (0: kDown4BlocksPerSM).
extern "C" int gantrack_fir_down4(const void* x, void* out, int P, int H, int W, int OH, int OW,
                                  int py0, int px0, int ky, int kx, const float* taps_y,
                                  const float* taps_x, int is_bf16, int blocks_per_sm,
                                  void* stream) {
  if (ky < 1 || kx < 1 || ky > kMaxTaps || kx > kMaxTaps || P < 1 || H < 1 || W < 1 || OH < 1 ||
      OW < 1 || blocks_per_sm < 0) {
    return (int)cudaErrorInvalidValue;
  }
  Taps t = {};
  for (int i = 0; i < ky; ++i) t.y[i] = taps_y[i];
  for (int j = 0; j < kx; ++j) t.x[j] = taps_x[j];
  const int bps = blocks_per_sm > 0 ? blocks_per_sm : kDown4BlocksPerSM;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    launch_down4_taps<__nv_bfloat16>((const __nv_bfloat16*)x, (__nv_bfloat16*)out, P, H, W, OH,
                                     OW, py0, px0, ky, kx, t, bps, s);
  } else {
    launch_down4_taps<float>((const float*)x, (float*)out, P, H, W, OH, OW, py0, px0, ky, kx, t,
                             bps, s);
  }
  return (int)cudaGetLastError();
}

// The 2-D forms (StyleGAN3-R's radial filters): ``up`` 1 is down2 with
// ``taps`` the ky x kx correlation taps, row-major, and ``geom`` = {ky, kx,
// py0, px0}; ``up`` 2 is up2 with ``taps`` [2 slots y][2 slots x][6][6]
// floats and ``geom`` = {ny0, ny1, nx0, nx1, ey, dy, ex, dx}, the polyphase
// split that ops/fir.py ``_c_2d`` makes of the filter and the low pads.
// ky, kx <= 12 (slot counts <= 6).  ``blocks_per_sm`` sizes the grid (0:
// k2dBlocksPerSM or k2dUpBlocksPerSM).  Launches on ``stream`` and returns
// cudaGetLastError() (or cudaErrorInvalidValue for arguments outside the
// kernels' contract).
extern "C" int gantrack_fir_2d(const void* x, void* out, int P, int H, int W, int OH, int OW,
                               int up, const float* taps, const int* geom, int is_bf16,
                               int blocks_per_sm, void* stream) {
  if (P < 1 || H < 1 || W < 1 || OH < 1 || OW < 1 || blocks_per_sm < 0 || (up != 1 && up != 2)) {
    return (int)cudaErrorInvalidValue;
  }
  Taps2D t = {};
  Phases2D ph = {};
  int ky = 0, kx = 0, py0 = 0, px0 = 0, fixed = 0;
  if (up == 1) {
    ky = geom[0];
    kx = geom[1];
    py0 = geom[2];
    px0 = geom[3];
    if (ky < 1 || kx < 1 || ky > k2dMaxTaps || kx > k2dMaxTaps) return (int)cudaErrorInvalidValue;
    for (int i = 0; i < ky; ++i) {
      for (int j = 0; j < kx; ++j) t.t[i][j] = taps[i * kx + j];
    }
    fixed = ky == k2dMaxTaps && kx == k2dMaxTaps;
  } else {
    fixed = 1;
    for (int s = 0; s < 2; ++s) {
      ph.ny[s] = geom[s];
      ph.nx[s] = geom[2 + s];
      if (ph.ny[s] < 0 || ph.ny[s] > k2dPhaseTaps || ph.nx[s] < 0 || ph.nx[s] > k2dPhaseTaps) {
        return (int)cudaErrorInvalidValue;
      }
      fixed &= ph.ny[s] == k2dPhaseTaps && ph.nx[s] == k2dPhaseTaps;
    }
    ph.ey = geom[4];
    ph.dy = geom[5];
    ph.ex = geom[6];
    ph.dx = geom[7];
    if ((ph.ey != 0 && ph.ey != 1) || (ph.ex != 0 && ph.ex != 1)) return (int)cudaErrorInvalidValue;
    for (int i = 0; i < 2 * 2 * k2dPhaseTaps * k2dPhaseTaps; ++i) (&ph.t[0][0][0][0])[i] = taps[i];
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    auto xb = (const __nv_bfloat16*)x;
    auto ob = (__nv_bfloat16*)out;
    if (fixed) {
      launch_2d<__nv_bfloat16, k2dMaxTaps>(xb, ob, P, H, W, OH, OW, up, py0, px0, ky, kx, t, ph,
                                           blocks_per_sm, s);
    } else {
      launch_2d<__nv_bfloat16, 0>(xb, ob, P, H, W, OH, OW, up, py0, px0, ky, kx, t, ph,
                                  blocks_per_sm, s);
    }
  } else if (fixed) {
    launch_2d<float, k2dMaxTaps>((const float*)x, (float*)out, P, H, W, OH, OW, up, py0, px0, ky,
                                 kx, t, ph, blocks_per_sm, s);
  } else {
    launch_2d<float, 0>((const float*)x, (float*)out, P, H, W, OH, OW, up, py0, px0, ky, kx, t, ph,
                        blocks_per_sm, s);
  }
  return (int)cudaGetLastError();
}
