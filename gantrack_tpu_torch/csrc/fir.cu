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
// read of the input and one write of the output, so it is bound by memory
// traffic if each input sample is read once.
//
// K5, K6 (``fir_kernel``): a block computes a tile of kTileH x kTileW
// outputs of one plane: it stages the tile's input window in shared
// memory (one coalesced read of each sample, zeros outside the image),
// runs the vertical taps over the window's columns into a second shared
// buffer, then the horizontal taps into the output, so an output costs
// ky + kx multiply-adds from shared memory instead of ky*kx loads.  (A
// first version, one thread per output reading all ky*kx samples, took
// 1.1-2.7x as long forward+backward at the training shapes on an NVIDIA
// H100 80GB HBM3 at 700 W.)
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
// terms.  Tap counts 4 and 12 are
// unrolled at compile time; other counts up to kMaxTaps take a generic
// loop.  The factor is a template parameter, instantiated at 2 only.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kMaxTaps = 32;
constexpr int kMaxGridZ = 65535;

enum Form { kSame = 0, kDown2 = 1 };

struct Taps {
  float y[kMaxTaps];
  float x[kMaxTaps];
};

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

constexpr int kTileW = 32;  // outputs per block: one warp wide
constexpr int kTileH = 16;
constexpr int kBlockY = 8;  // threads: kTileW x kBlockY

// Along one axis: the first input index of the window that outputs
// v0 .. v0 + n - 1 read, and the window's length (an upper bound for up2).
template <int FORM>
__host__ __device__ __forceinline__ int window_lo(int v0, int p0) {
  return FORM == kDown2 ? 2 * v0 - p0 : v0 - p0;
}

template <int FORM>
__host__ __device__ __forceinline__ int window_len(int n, int k) {
  return FORM == kDown2 ? 2 * n + k - 2 : n + k - 1;
}

// The window offset that tap i of output v reads.
template <int FORM>
__device__ __forceinline__ int tap_offset(int v, int i, int p0, int lo) {
  return (FORM == kDown2 ? 2 * v : v) + i - p0 - lo;
}

// One block per output tile; the z dimension of the grid walks the planes
// (P may exceed the 65535 blocks of gridDim.z).  K > 0 fixes ky = kx = K
// at compile time, so the tap loops unroll; K == 0 reads ky, kx at run
// time.  Dynamic shared memory: the window [ny][nx] and the vertical pass
// [kTileH][nx], in f32.
template <typename T, int FORM, int K>
__global__ void __launch_bounds__(kTileW * kBlockY)
fir_kernel(const T* __restrict__ x, T* __restrict__ out, int P, int H, int W, int OH, int OW,
           int py0, int px0, int ky_rt, int kx_rt, Taps t) {
  extern __shared__ float smem[];
  const int ky = K > 0 ? K : ky_rt;
  const int kx = K > 0 ? K : kx_rt;
  const int u0 = blockIdx.x * kTileW, v0 = blockIdx.y * kTileH;
  const int ny = window_len<FORM>(kTileH, ky), nx = window_len<FORM>(kTileW, kx);
  const int ylo = window_lo<FORM>(v0, py0), xlo = window_lo<FORM>(u0, px0);
  float* win = smem;
  float* vert = smem + ny * nx;
  for (int p = blockIdx.z; p < P; p += gridDim.z) {
    const T* plane = x + (size_t)p * H * W;
    for (int r = threadIdx.y; r < ny; r += kBlockY) {
      const int iy = ylo + r;
      const bool row_in = iy >= 0 && iy < H;
      for (int c = threadIdx.x; c < nx; c += kTileW) {
        const int ix = xlo + c;
        win[r * nx + c] = (row_in && ix >= 0 && ix < W) ? load(plane + (size_t)iy * W + ix) : 0.f;
      }
    }
    __syncthreads();
    for (int r = threadIdx.y; r < kTileH; r += kBlockY) {
      for (int c = threadIdx.x; c < nx; c += kTileW) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < ky; ++i) s += t.y[i] * win[tap_offset<FORM>(v0 + r, i, py0, ylo) * nx + c];
        vert[r * nx + c] = s;
      }
    }
    __syncthreads();
    const int u = u0 + threadIdx.x;
    for (int r = threadIdx.y; r < kTileH; r += kBlockY) {
      const int v = v0 + r;
      if (u >= OW || v >= OH) continue;
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < kx; ++j) s += t.x[j] * vert[r * nx + tap_offset<FORM>(u, j, px0, xlo)];
      store(out + ((size_t)p * OH + v) * OW + u, s);
    }
    __syncthreads();  // the next plane reuses both buffers
  }
}

template <typename T, int FORM>
void launch_form(const T* x, T* out, int P, int H, int W, int OH, int OW, int py0, int px0,
                 int ky, int kx, const Taps& t, cudaStream_t s) {
  const dim3 block(kTileW, kBlockY);
  const dim3 grid((OW + kTileW - 1) / kTileW, (OH + kTileH - 1) / kTileH,
                  P < kMaxGridZ ? P : kMaxGridZ);
  const int nx = window_len<FORM>(kTileW, kx);
  const size_t smem = sizeof(float) * (size_t)(window_len<FORM>(kTileH, ky) + kTileH) * nx;
  if (ky == 4 && kx == 4) {
    fir_kernel<T, FORM, 4><<<grid, block, smem, s>>>(x, out, P, H, W, OH, OW, py0, px0, ky, kx, t);
  } else if (ky == 12 && kx == 12) {
    fir_kernel<T, FORM, 12><<<grid, block, smem, s>>>(x, out, P, H, W, OH, OW, py0, px0, ky, kx, t);
  } else {
    fir_kernel<T, FORM, 0><<<grid, block, smem, s>>>(x, out, P, H, W, OH, OW, py0, px0, ky, kx, t);
  }
}

template <typename T>
void launch(int form, const T* x, T* out, int P, int H, int W, int OH, int OW, int py0, int px0,
            int ky, int kx, const Taps& t, cudaStream_t s) {
  if (form == kSame) {
    launch_form<T, kSame>(x, out, P, H, W, OH, OW, py0, px0, ky, kx, t, s);
  } else {
    launch_form<T, kDown2>(x, out, P, H, W, OH, OW, py0, px0, ky, kx, t, s);
  }
}

// ---------------------------------------------------------------- K7: up2

constexpr int kMaxPhaseTaps = kMaxTaps / 2;
constexpr int kUpThreads = 256;   // 8 warps
constexpr int kUpRows = 64;       // output rows of a tile: 32 row pairs
constexpr int kUpGroupPairs = 8;  // row pairs a thread of the vertical pass walks
constexpr int kUpCols = 64;       // columns of the vertical buffer: 256 threads / 4 groups
// Blocks of a launch an SM (several resident waves): on an H100 the fastest of 4 .. 1024
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

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
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

template <typename T, int K>
void launch_up(const T* x, T* out, int P, int H, int W, int OH, int OW, const Phases& py,
               const Phases& px, int blocks_per_sm, cudaStream_t s) {
  constexpr int TW = up_tile_pairs<K>();
  const int ey = py.d[1] - py.d[0];
  const int tiles_x = ((OW + 1) / 2 + TW - 1) / TW;
  const int tiles_y = (OH + ey + kUpRows - 1) / kUpRows;
  // About blocks_per_sm blocks an SM in all; each walks P / gridDim.z planes.
  const long tiles = (long)tiles_x * tiles_y;
  const long want = ((long)blocks_per_sm * sm_count() + tiles - 1) / tiles;
  const int z = (int)(want < 1 ? 1 : want < P ? (want < kMaxGridZ ? want : kMaxGridZ)
                                              : (P < kMaxGridZ ? P : kMaxGridZ));
  fir_up_kernel<T, 2, K><<<dim3(tiles_x, tiles_y, z), kUpThreads, 0, s>>>(x, out, P, H, W, OH, OW,
                                                                          py, px);
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
// of ``x`` and ``out`` (bf16 or f32).
extern "C" int gantrack_fir(const void* x, void* out, int P, int H, int W, int OH, int OW,
                            int form, int py0, int px0, int ky, int kx, const float* taps_y,
                            const float* taps_x, int is_bf16, void* stream) {
  if (form < kSame || form > kDown2 || ky < 1 || kx < 1 || ky > kMaxTaps || kx > kMaxTaps ||
      P < 1 || H < 1 || W < 1 || OH < 1 || OW < 1) {
    return (int)cudaErrorInvalidValue;
  }
  Taps t = {};
  for (int i = 0; i < ky; ++i) t.y[i] = taps_y[i];
  for (int j = 0; j < kx; ++j) t.x[j] = taps_x[j];
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    launch<__nv_bfloat16>(form, (const __nv_bfloat16*)x, (__nv_bfloat16*)out, P, H, W, OH, OW,
                          py0, px0, ky, kx, t, s);
  } else {
    launch<float>(form, (const float*)x, (float*)out, P, H, W, OH, OW, py0, px0, ky, kx, t, s);
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
