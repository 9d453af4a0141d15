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
// What bounds it on the H100: a resample FIR does ky*kx (same, down2) or
// about ky*kx/4 (up2) multiply-adds per output against one read of the
// input and one write of the output, so it is bound by memory traffic if
// each input sample is read once.  A block therefore computes a tile of
// kTileH x kTileW outputs of one plane: it stages the tile's input window
// in shared memory (one coalesced read of each sample, zeros outside the
// image), runs the vertical taps over the window's columns into a second
// shared buffer, then the horizontal taps into the output, so an output
// costs ky + kx multiply-adds from shared memory instead of ky*kx loads.
// (A first version, one thread per output reading all ky*kx samples, took
// 1.1-2.7x as long forward+backward at the training shapes on an NVIDIA
// H100 80GB HBM3 at 700 W.)  Tap counts 4 (the [1,3,3,1] filter of the
// networks) and 12 (the sym6 wavelet of the augment pipe) are unrolled at
// compile time; other counts up to kMaxTaps take a generic loop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kMaxTaps = 32;
constexpr int kMaxGridZ = 65535;

enum Form { kSame = 0, kDown2 = 1, kUp2 = 2 };

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

__host__ __device__ __forceinline__ int floor_half(int z) { return z >= 0 ? z / 2 : -((1 - z) / 2); }

// Along one axis: the first input index of the window that outputs
// v0 .. v0 + n - 1 read, and the window's length (an upper bound for up2).
template <int FORM>
__host__ __device__ __forceinline__ int window_lo(int v0, int p0) {
  if (FORM == kDown2) return 2 * v0 - p0;
  if (FORM == kUp2) return floor_half(v0 - p0);
  return v0 - p0;
}

template <int FORM>
__host__ __device__ __forceinline__ int window_len(int n, int k) {
  if (FORM == kDown2) return 2 * n + k - 2;
  if (FORM == kUp2) return (n + k) / 2 + 1;
  return n + k - 1;
}

// The window offset that tap i of output v reads, or -1 where the sample
// is a stuffed zero of the up2 grid.
template <int FORM>
__device__ __forceinline__ int tap_offset(int v, int i, int p0, int lo) {
  const int s = (FORM == kDown2 ? 2 * v : v) + i - p0;
  if (FORM == kUp2) return (s & 1) ? -1 : (s >> 1) - lo;  // s even: s >> 1 == s / 2
  return s - lo;
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
        for (int i = 0; i < ky; ++i) {
          const int o = tap_offset<FORM>(v0 + r, i, py0, ylo);
          if (o >= 0) s += t.y[i] * win[o * nx + c];
        }
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
      for (int j = 0; j < kx; ++j) {
        const int o = tap_offset<FORM>(u, j, px0, xlo);
        if (o >= 0) s += t.x[j] * vert[r * nx + o];
      }
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
  switch (form) {
    case kSame: launch_form<T, kSame>(x, out, P, H, W, OH, OW, py0, px0, ky, kx, t, s); break;
    case kDown2: launch_form<T, kDown2>(x, out, P, H, W, OH, OW, py0, px0, ky, kx, t, s); break;
    default: launch_form<T, kUp2>(x, out, P, H, W, OH, OW, py0, px0, ky, kx, t, s); break;
  }
}

}  // namespace

// Launches on ``stream`` and returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments outside the kernel's contract).
// ``form`` is 0 same, 1 down2, 2 up2; ``taps_y``/``taps_x`` are host
// arrays of ky/kx correlation taps; ``is_bf16`` selects the element type
// of ``x`` and ``out`` (bf16 or f32).
extern "C" int gantrack_fir(const void* x, void* out, int P, int H, int W, int OH, int OW,
                            int form, int py0, int px0, int ky, int kx, const float* taps_y,
                            const float* taps_x, int is_bf16, void* stream) {
  if (form < kSame || form > kUp2 || ky < 1 || kx < 1 || ky > kMaxTaps || kx > kMaxTaps ||
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
