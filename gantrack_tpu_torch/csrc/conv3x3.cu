// 3x3 stride-1 SAME convolution as an implicit GEMM (K8) and its weight
// gradient (K9) for NVIDIA Hopper (sm_90a), NCHW / OIHW.
//
// Replaces the Pallas TPU kernels ``_fwd_kernel`` and ``_wgrad_kernel``
// (launched by ``_conv3x3_call`` and ``_wgrad_call``) of
// gantrack_tpu/ops/attic/conv3x3.py:
//     K8: out[n,co,y,x] = sum_{ci,dy,dx} w[co,ci,dy,dx] xpad[n,ci,y+dy,x+dx]
//     K9: dw[co,ci,dy,dx] = sum_{n,y,x} g[n,co,y,x] xpad[n,ci,y+dy,x+dx]
// with xpad the image zero-padded by one pixel, sums in f32 and one
// rounding to the tensors' type (bf16 or f32) at the store.  Together with
// the flipped, transposed weights (the input gradient is K8 again) the two
// are closed under differentiation of every order.  No im2col matrix and no
// padded copy of x exist in device memory: a block guards its halo reads at
// the image border.
//
// What is ported is the arithmetic, not the TPU form.  The width fold to
// 128-lane rows, the padded and folded copy of x, the grid that runs in
// order (K8's copy of block i+1 during block i; K9's sum carried in the
// output block across grid steps) and the weights resident in fast memory
// are gone: blocks run in no order, a block has 227 KB, and 9*512*512
// weights do not fit.  Here the loop over input-channel slabs and the nine
// taps runs inside the block, output channels and input channels are tiled,
// and K9 is a split reduction: each block sums a fixed range of pixel tiles
// into an f32 partial in scratch memory, and a second kernel adds the
// partials in a fixed order.  There are no atomics, so K9 is bitwise
// deterministic.
//
// What bounds these kernels on the H100: operations.  At the training
// shapes (32 x 256^2 x 64 -> 64 up to 32 x 32^2 x 512 -> 512) a call is
// 154.6 GFLOP against 537 MB down to 72 MB: at 64 channels the bytes and
// the operations tie (~0.16 ms each at the card's peaks), from 128 channels
// on the tensor cores, not the memory, limit.  What a kernel must then do
// is keep the tensor cores fed: only wgmma reaches their rate, its operands
// come from shared memory, and the shared-memory pipe and the instruction
// slots must not be as busy as the tensor cores (the general kernels below
// spend one shared-memory load per 0.7 mma and as many staging instructions
// again).
//
// bf16, W a multiple of 8 (the wgmma kernels, ``*_wgmma_kernel``): a block
// is two consumer warpgroups and one producer warpgroup around a ring of 2-3
// stages in dynamic shared memory; the consumers take 224 registers a
// thread, the producer 56 (setmaxnreg).
//   * TMA brings every tile as it lies in NCHW (pixels contiguous), at
//     signed coordinates: what lies outside the image (the padding, ragged
//     tiles, channels past the end) arrives as zeros, so there is no offset
//     table and no guard.  wgmma takes bf16 operands with either axis
//     contiguous, so nothing is transposed: K8 makes output channels M,
//     pixels N (x is the N-major B operand, up to 256 pixels an instruction)
//     and input channels K; its accumulator [co][pixels] has NCHW's rows and
//     leaves through a swizzled stage by one TMA store a warpgroup.  K9
//     makes output channels M, input channels N and pixels K: g and x are
//     both K-major as they lie; the g fragment is read once a k-step
//     (ldmatrix) and feeds the nine taps' wgmma from registers.
//   * A tap's row shift dy is a whole line of the window.  Its column shift
//     dx is 2 bytes: TMA faults on a box whose first column is no multiple of
//     16 bytes, cp.async and a wgmma descriptor address 16-byte units too.
//     So the window arrives once, aligned (column x0 - 8, 16 pixels wider),
//     and the producer warpgroup writes the three views at x0 - 1, x0,
//     x0 + 1 into the stage in the swizzled layout wgmma reads
//     (``shift_window``: three 16-byte loads, four byte permutes and three
//     16-byte stores a chunk, ~20 instructions a thread a stage beside
//     ~2300 tensor-core cycles), while the slab before is multiplied.
//   * Barriers a slot: the window has landed; the views are written and the
//     directly loaded operand (K8's packed weights, K9's g box) has landed;
//     the consumers are done.  Windows are requested a ring ahead.
//   * K9's split is one block an SM (132 blocks at most) instead of 1024:
//     19.5 MB of partials at the training shapes instead of 75.5 MB; they
//     are stored 16 bytes a thread.  With Co <= 64 the two warpgroups of a
//     block sum half a tile's rows each into a slice of their own.
//   * Blocks are not persistent: at 64 channels a block's four slabs leave
//     its prologue and epilogue in the open (~350 TFLOP/s there, ~600 from
//     128 channels on).
// ptxas (CUDA 12.9, -O3): the eight wgmma kernels 168 registers at entry,
// no spills, no static shared memory; dynamic shared memory 167,040 to
// 213,120 bytes for K8 (3 views + weights + raw window a stage: 89,088
// bytes at 64-pixel rows and 128 channels, two stages) and 173,184 to
// 216,192 for K9.
//
// bf16, any other W (``conv3x3_bf16_kernel``, ``wgrad3x3_bf16_kernel``):
// warp-level ``mma.sync.m16n8k16`` from synchronously staged tiles.
//   * K8 makes pixels the M axis and output channels the N axis; K is input
//     channels, so both operands want channel pairs packed.  The block
//     stages a [18 x 18 pixels][32 ci] window TRANSPOSED to pixel-major in
//     shared memory, and the weights as [tap][co][ci] from a repacked copy
//     the wrapper makes.  A tap shift is then a whole pixel row of the
//     window: every fragment load is an aligned 32-bit load, for all nine
//     taps.  Row strides of 40 elements keep the fragment loads free of
//     bank conflicts.
//   * K9 makes output channels M, input channels N and pixels K, so both
//     operands keep NCHW's pixel-contiguous rows; the odd column shift
//     (dx = 1) of the x window is made in registers from the two aligned
//     words around it (``__byte_perm``), not by a second copy.
// f32 tensors run on the CUDA cores in full f32 (FMA), never TF32: a
// register-tiled direct convolution over 8 x 16 pixel tiles of one image
// (K8), for images of at most 64 pixels a kernel that packs whole images
// into a block's 64 pixel slots and streams its slabs with cp.async (K8,
// ``conv3x3_f32_flat_kernel``: bound by one block's chain of 64 slabs at
// 4 x 4, where 32 images make only 256 blocks of two warps), and for K9 a
// block of 64 x 32 channels and all nine taps that gathers g and the x
// window once a pixel tile, [pixel][channel] through cp.async into two
// stages, and packs whole small images into a tile as well.
//
// Any N, Ci, Co, H, W >= 1 run (tiles are guarded or zero-filled); H*W,
// 9*Co*Ci and N*H*W must be below 2^31, all offsets into tensors are 64-bit.
// The wrapper picks the variant from the shape alone.

#include <cuda.h>  // CUtensorMap and its enums; libcuda is reached through dlsym
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stddef.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}


// ------------------------------------------ Hopper pieces of the wgmma kernels
//
// Shared by K8 and K9 (bf16): mbarriers, TMA loads and stores, wgmma.  All
// shared-memory addresses are 32-bit addresses of the shared window.

#define ACC4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define ACC16(d, i) ACC4(d, i), ACC4(d, i + 4), ACC4(d, i + 8), ACC4(d, i + 12)
#define ACC64(d, i) ACC16(d, i), ACC16(d, i + 16), ACC16(d, i + 32), ACC16(d, i + 48)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Spin until the phase of parity ``parity`` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// One box of a 4-D tensor map into shared memory; completes on ``bar``.
// Coordinates are signed: what lies outside the tensor arrives as zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// ``bytes`` contiguous bytes (a multiple of 16, 16-byte aligned) into shared memory.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// One box from shared memory into a 4-D tensor map; what lies outside the
// tensor is not written.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::
          "l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_store_finish() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// Barrier ``id`` among ``threads`` threads of the block (not all of it).
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Shared-memory matrix descriptor of wgmma: start address, leading and
// stride byte offsets (all in 16-byte units) and the swizzle of the tile
// (0 none, 1 128-byte, 2 64-byte), which is the swizzle TMA wrote it with.
constexpr uint32_t kSwizzleNone = 0, kSwizzle128 = 1, kSwizzle64 = 2;
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes, uint32_t swizzle) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo_bytes >> 4) << 16) |
         ((uint64_t)(sbo_bytes >> 4) << 32) | ((uint64_t)swizzle << 62);
}

// D[64 x 256] += A[64 x 16] B[16 x 256]: A from shared memory, K-major
// (K contiguous); B from shared memory, N-major (N contiguous: trans-b).
__device__ __forceinline__ void wgmma_m64n256k16_nmajor_b(float (&d)[128], uint64_t da,
                                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      : ACC64(d, 0), ACC64(d, 64)
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_m64n128k16_nmajor_b(float (&d)[64], uint64_t da,
                                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : ACC64(d, 0)
      : "l"(da), "l"(db), "r"(1));
}
// D[64 x 32] += A[64 x 16] B[16 x 32]: A from registers (the fragment of
// mma.m16n8k16, a warp's 16 rows), B from shared memory, K-major.
__device__ __forceinline__ void wgmma_m64n32k16_reg_a(float (&d)[16], const uint32_t (&a)[4],
                                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : ACC16(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// Keeps ``r`` live (and unmoved) up to this point: registers a wgmma in
// flight still reads must not be reused before its wait.
__device__ __forceinline__ void keep_alive(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}
__device__ __forceinline__ void sts128(uint32_t addr, uint32_t x, uint32_t y, uint32_t z,
                                       uint32_t w) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(x), "r"(y), "r"(z),
               "r"(w)
               : "memory");
}
// The high element of ``lo`` and the low element of ``hi``: two bf16
// pixels that straddle two words.
__device__ __forceinline__ uint32_t straddle(uint32_t lo, uint32_t hi) {
  return __byte_perm(lo, hi, 0x5432);
}

// TMA cannot start a box at a column whose byte offset is no multiple of 16
// (the instruction faults), and a wgmma descriptor addresses 16-byte units:
// the column shift dx = -1, +1 of a tap is 2 bytes.  So the window arrives
// once, at the aligned column x0 - 8 and kBW + 16 pixels wide, unswizzled
// ("raw": [lines][kBW + 16]), and the producer warpgroup writes the three
// views at columns x0 - 1, x0, x0 + 1 (``box_bytes`` apart, each [lines][kBW
// pixels]) in the swizzled layout a TMA box of that width would have had:
// 16-byte chunk c of line l at chunk c ^ (l % 8) (128-byte lines) or
// c ^ (l / 2 % 4) (64-byte lines).  Three 16-byte loads, four byte
// permutes and three 16-byte stores a chunk.
template <int kBW>
__device__ __forceinline__ void shift_window(uint32_t raw, uint32_t dst, int box_bytes, int lines,
                                             int tid) {
  constexpr int kChunks = kBW / 8, kRawRow = (kBW + 16) * 2, kRow = kBW * 2;
  for (int item = tid; item < lines * kChunks; item += 128) {
    const int line = item / kChunks, c = item % kChunks;
    const uint32_t src = raw + line * kRawRow + c * 16;
    const uint4 a = lds128(src), b = lds128(src + 16), e = lds128(src + 32);
    const int sw = kBW == 64 ? (line & 7) : ((line >> 1) & 3);
    const uint32_t out = dst + line * kRow + ((c ^ sw) << 4);
    const uint32_t p01 = straddle(b.x, b.y), p12 = straddle(b.y, b.z), p23 = straddle(b.z, b.w);
    sts128(out, straddle(a.w, b.x), p01, p12, p23);
    sts128(out + box_bytes, b.x, b.y, b.z, b.w);
    sts128(out + 2 * box_bytes, p01, p12, p23, straddle(b.w, e.x));
  }
}

constexpr int kConsumerThreads = 256, kProducerThreads = 128;
constexpr int kBlockThreads = kConsumerThreads + kProducerThreads;
// Registers a thread after setmaxnreg: 256 x 224 + 128 x 56 is the 168 a
// thread that a block of 384 starts with.
constexpr int kConsumerRegs = 224, kProducerRegs = 56;

// ----------------------------------------------------------------- K8, bf16
//
// Block: 256 threads, one 16 x 16 pixel tile of one image, 64 output
// channels.  Warp w owns tile rows 2w and 2w+1 (two m16 tiles of 16 pixels)
// and all 64 output channels (eight n8 tiles): 64 f32 accumulators a
// thread.  Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4):
// A: (row g | g+8, k 2t,2t+1 | +8); B: (k 2t,2t+1 | +8, col g);
// C: (row g | g+8, col 2t,2t+1).

constexpr int kF_TH = 16, kF_TW = 16;
constexpr int kF_WinW = kF_TW + 2;
constexpr int kF_WinPix = (kF_TH + 2) * kF_WinW;  // 324
constexpr int kF_CoT = 64, kF_CiT = 32;
constexpr int kF_Stride = kF_CiT + 8;  // 40 elements: 20 words, conflict-free fragments
constexpr int kF_SmemBytes =
    kF_WinPix * kF_Stride * 2 + 9 * kF_CoT * kF_Stride * 2 + kF_WinPix * 4;

__global__ void __launch_bounds__(256, 2)
conv3x3_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wp,
                    bf16* __restrict__ out, int Ci, int Co, int H, int W, int tiles_x,
                    int tiles_y, int co_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);         // [324 pixels][40]
  bf16* ws = xs + kF_WinPix * kF_Stride;            // [9 taps * 64 co][40]
  int* offs = reinterpret_cast<int*>(ws + 9 * kF_CoT * kF_Stride);  // [324]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  long long b = blockIdx.x;
  const int co0 = (int)(b % co_tiles) * kF_CoT;
  b /= co_tiles;
  const int x0 = (int)(b % tiles_x) * kF_TW;
  b /= tiles_x;
  const int y0 = (int)(b % tiles_y) * kF_TH;
  const size_t n = (size_t)(b / tiles_y);
  const size_t HW = (size_t)H * W;

  // Offset of every window pixel inside a plane, or -1 outside the image.
  for (int pix = tid; pix < kF_WinPix; pix += 256) {
    const int r = pix / kF_WinW, c = pix - r * kF_WinW;
    const int y = y0 - 1 + r, xx = x0 - 1 + c;
    offs[pix] = (y >= 0 && y < H && xx >= 0 && xx < W) ? y * W + xx : -1;
  }

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;

  const bool vec_ok = (Ci % 8) == 0;
  const uint32_t* xs32 = reinterpret_cast<const uint32_t*>(xs);
  const uint32_t* ws32 = reinterpret_cast<const uint32_t*>(ws);
  const bf16 zero = __float2bfloat16(0.f);

  for (int ci0 = 0; ci0 < Ci; ci0 += kF_CiT) {
    __syncthreads();  // the previous slab is consumed; offs is written
    // Window, transposed to [pixel][ci]: a warp walks one channel's pixels.
    for (int cl = warp; cl < kF_CiT; cl += 8) {
      const int ci = ci0 + cl;
      const bool ci_ok = ci < Ci;
      const bf16* plane = x + (n * Ci + (ci_ok ? ci : 0)) * HW;
      for (int pix = lane; pix < kF_WinPix; pix += 32) {
        const int off = offs[pix];
        xs[pix * kF_Stride + cl] = (ci_ok && off >= 0) ? plane[off] : zero;
      }
    }
    // Weights [tap][co][ci], 8 input channels (16 bytes) a copy.
    for (int idx = tid; idx < 9 * kF_CoT * (kF_CiT / 8); idx += 256) {
      const int row = idx >> 2, chunk = idx & 3;
      const int tap = row / kF_CoT, co = co0 + (row - tap * kF_CoT), ci = ci0 + chunk * 8;
      bf16* dst = ws + row * kF_Stride + chunk * 8;
      const bf16* src = wp + ((size_t)tap * Co + (co < Co ? co : 0)) * Ci + ci;
      if (vec_ok && co < Co && ci + 8 <= Ci) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) dst[e] = (co < Co && ci + e < Ci) ? src[e] : zero;
      }
    }
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap - dy * 3;
#pragma unroll
      for (int ks = 0; ks < kF_CiT / 16; ++ks) {
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int base = (2 * warp + mt + dy) * kF_WinW + dx;  // window pixel of tile col 0
          const int w_lo = (base + g) * (kF_Stride / 2) + ks * 8 + t;
          const int w_hi = (base + g + 8) * (kF_Stride / 2) + ks * 8 + t;
          a[mt][0] = xs32[w_lo];
          a[mt][1] = xs32[w_hi];
          a[mt][2] = xs32[w_lo + 4];
          a[mt][3] = xs32[w_hi + 4];
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int wrow = (tap * kF_CoT + nt * 8 + g) * (kF_Stride / 2) + ks * 8 + t;
          const uint32_t b0 = ws32[wrow], b1 = ws32[wrow + 4];
          mma_bf16(acc[0][nt], a[0], b0, b1);
          mma_bf16(acc[1][nt], a[1], b0, b1);
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int y = y0 + 2 * warp + mt;
    if (y >= H) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int xx = x0 + g + (k >> 1) * 8;
        const int co = co0 + nt * 8 + 2 * t + (k & 1);
        if (xx < W && co < Co)
          out[((n * Co + co) * H + y) * W + xx] = __float2bfloat16(acc[mt][nt][k]);
      }
    }
  }
}

// ------------------------------------------------------------------ K8, f32
//
// Block: 256 threads, an 8 x 16 pixel tile, 64 output channels, slabs of 8
// input channels.  A thread owns 4 pixels of a row and 8 output channels;
// the 8 weights of a tap are one broadcast read for the whole warp.
// Weights come repacked as [tap][ci][co].

constexpr int kS_TH = 8, kS_TW = 16;
constexpr int kS_WinW = kS_TW + 2, kS_WinH = kS_TH + 2;
constexpr int kS_WinPix = kS_WinH * kS_WinW;  // 180
constexpr int kS_RowStride = 20;
constexpr int kS_CoT = 64, kS_CiT = 8;

__global__ void __launch_bounds__(256, 4)
conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ wp,
                   float* __restrict__ out, int Ci, int Co, int H, int W, int tiles_x,
                   int tiles_y, int co_tiles) {
  __shared__ __align__(16) float xs[kS_CiT * kS_WinH * kS_RowStride];  // [ci][10][20]
  __shared__ __align__(16) float ws[kS_CiT * 9 * kS_CoT];              // [ci][tap][co]
  __shared__ int offs[kS_WinPix];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = lane >> 2, c0 = (lane & 3) * 4, col = warp * 8;
  long long b = blockIdx.x;
  const int co0 = (int)(b % co_tiles) * kS_CoT;
  b /= co_tiles;
  const int x0 = (int)(b % tiles_x) * kS_TW;
  b /= tiles_x;
  const int y0 = (int)(b % tiles_y) * kS_TH;
  const size_t n = (size_t)(b / tiles_y);
  const size_t HW = (size_t)H * W;

  for (int pix = tid; pix < kS_WinPix; pix += 256) {
    const int wr = pix / kS_WinW, wc = pix - wr * kS_WinW;
    const int y = y0 - 1 + wr, xx = x0 - 1 + wc;
    offs[pix] = (y >= 0 && y < H && xx >= 0 && xx < W) ? y * W + xx : -1;
  }

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int p = 0; p < 4; ++p) acc[j][p] = 0.f;

  for (int ci0 = 0; ci0 < Ci; ci0 += kS_CiT) {
    __syncthreads();
    {  // one channel of the window a warp
      const int ci = ci0 + warp;
      const bool ci_ok = ci < Ci;
      const float* plane = x + (n * Ci + (ci_ok ? ci : 0)) * HW;
      for (int pix = lane; pix < kS_WinPix; pix += 32) {
        const int wr = pix / kS_WinW, wc = pix - wr * kS_WinW;
        const int off = offs[pix];
        xs[(warp * kS_WinH + wr) * kS_RowStride + wc] = (ci_ok && off >= 0) ? plane[off] : 0.f;
      }
    }
    for (int idx = tid; idx < kS_CiT * 9 * kS_CoT; idx += 256) {
      const int co_l = idx & (kS_CoT - 1), rest = idx >> 6;
      const int cl = rest / 9, tap = rest - cl * 9;
      const int ci = ci0 + cl, co = co0 + co_l;
      ws[idx] = (ci < Ci && co < Co) ? wp[((size_t)tap * Ci + ci) * Co + co] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int cl = 0; cl < kS_CiT; ++cl) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float xr[6];
        const float* row = xs + (cl * kS_WinH + r + dy) * kS_RowStride + c0;
#pragma unroll
        for (int i = 0; i < 6; ++i) xr[i] = row[i];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4* wv = reinterpret_cast<const float4*>(ws + (cl * 9 + dy * 3 + dx) * kS_CoT + col);
          const float4 w0 = wv[0], w1 = wv[1];
          const float wj[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int p = 0; p < 4; ++p) acc[j][p] = fmaf(wj[j], xr[p + dx], acc[j][p]);
        }
      }
    }
  }

  const int y = y0 + r;
  if (y < H) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int co = co0 + col + j;
      if (co >= Co) continue;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int xx = x0 + c0 + p;
        if (xx < W) out[((n * Co + co) * H + y) * W + xx] = acc[j][p];
      }
    }
  }
}

// ----------------------------------------------------------------- K9, bf16
//
// Block: 256 threads, 64 output channels x 32 input channels x 9 taps, over
// the pixel tiles [tile_lo, tile_hi) of its split (8 x 16 pixels a tile).
// Warp w owns output channels 16 (w % 4) .. +15 (one m16 tile) and input
// channels 16 (w / 4) .. +15 (two n8 tiles) for all nine taps: 72 f32
// accumulators a thread.  A tile row of 16 pixels is one k16 step.

constexpr int kW_TH = 8, kW_TW = 16;
constexpr int kW_CoT = 64, kW_CiT = 32;
constexpr int kW_GStride = kW_TH * kW_TW + 8;                 // 136: 68 words
constexpr int kW_WinW = kW_TW + 2, kW_WinPix = (kW_TH + 2) * kW_WinW;  // 18, 180
constexpr int kW_XStride = kW_WinPix + 4;                     // 184: 92 words

__global__ void __launch_bounds__(256, 2)
wgrad3x3_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gr,
                     float* __restrict__ partial, int Ci, int Co, int H, int W, int tiles_x,
                     int tiles_y, long long tiles, int splits, int co_tiles, int ci_tiles) {
  __shared__ __align__(16) bf16 gs[kW_CoT * kW_GStride];  // [co][8 x 16 pixels]
  __shared__ __align__(16) bf16 xe[kW_CiT * kW_XStride];  // [ci][10 x 18 pixels]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  long long b = blockIdx.x;
  const int ci0 = (int)(b % ci_tiles) * kW_CiT;
  b /= ci_tiles;
  const int co0 = (int)(b % co_tiles) * kW_CoT;
  const long long s = b / co_tiles;
  const long long tile_lo = s * tiles / splits, tile_hi = (s + 1) * tiles / splits;
  const size_t HW = (size_t)H * W;
  const bf16 zero = __float2bfloat16(0.f);

  float acc[9][2][4];
#pragma unroll
  for (int i = 0; i < 9; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;

  const uint32_t* gs32 = reinterpret_cast<const uint32_t*>(gs);
  const uint32_t* xe32 = reinterpret_cast<const uint32_t*>(xe);

  for (long long tile = tile_lo; tile < tile_hi; ++tile) {
    long long q = tile;
    const int x0 = (int)(q % tiles_x) * kW_TW;
    q /= tiles_x;
    const int y0 = (int)(q % tiles_y) * kW_TH;
    const size_t n = (size_t)(q / tiles_y);

    __syncthreads();
    for (int cl = warp; cl < kW_CoT; cl += 8) {
      const int co = co0 + cl;
      const bool ok = co < Co;
      const bf16* plane = gr + (n * Co + (ok ? co : 0)) * HW;
      for (int p = lane; p < kW_TH * kW_TW; p += 32) {
        const int y = y0 + (p >> 4), xx = x0 + (p & 15);
        gs[cl * kW_GStride + p] = (ok && y < H && xx < W) ? plane[(size_t)y * W + xx] : zero;
      }
    }
    for (int cl = warp; cl < kW_CiT; cl += 8) {
      const int ci = ci0 + cl;
      const bool ok = ci < Ci;
      const bf16* plane = x + (n * Ci + (ok ? ci : 0)) * HW;
      for (int pix = lane; pix < kW_WinPix; pix += 32) {
        const int wr = pix / kW_WinW, wc = pix - wr * kW_WinW;
        const int y = y0 - 1 + wr, xx = x0 - 1 + wc;
        xe[cl * kW_XStride + pix] =
            (ok && y >= 0 && y < H && xx >= 0 && xx < W) ? plane[(size_t)y * W + xx] : zero;
      }
    }
    __syncthreads();

#pragma unroll
    for (int kr = 0; kr < kW_TH; ++kr) {
      uint32_t a[4];
      const int a_lo = ((wm * 16 + g) * kW_GStride + kr * kW_TW) / 2 + t;
      const int a_hi = ((wm * 16 + g + 8) * kW_GStride + kr * kW_TW) / 2 + t;
      a[0] = gs32[a_lo];
      a[1] = gs32[a_hi];
      a[2] = gs32[a_lo + 4];
      a[3] = gs32[a_hi + 4];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          // Words of window row kr + dy: columns (2t, 2t+1), (2t+2, 2t+3)
          // and the same eight columns on.
          const int base = ((wn * 16 + nt * 8 + g) * kW_XStride + (kr + dy) * kW_WinW) / 2 + t;
          const uint32_t w0 = xe32[base], w1 = xe32[base + 1];
          const uint32_t w4 = xe32[base + 4], w5 = xe32[base + 5];
          mma_bf16(acc[dy * 3 + 0][nt], a, w0, w4);
          mma_bf16(acc[dy * 3 + 1][nt], a, __byte_perm(w0, w1, 0x5432),
                   __byte_perm(w4, w5, 0x5432));
          mma_bf16(acc[dy * 3 + 2][nt], a, w1, w5);
        }
      }
    }
  }

  const size_t plane9 = (size_t)Co * Ci;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int co = co0 + wm * 16 + g + (k >> 1) * 8;
        const int ci = ci0 + wn * 16 + nt * 8 + 2 * t + (k & 1);
        if (co < Co && ci < Ci)
          partial[((size_t)s * 9 + tap) * plane9 + (size_t)co * Ci + ci] = acc[tap][nt][k];
      }
    }
  }
}

// ------------------------------------------------------------------ K9, f32
//
// Block: 256 threads, 64 output channels x 32 input channels x all nine
// taps, summed over the pixel tiles [unit_lo, unit_hi) of its split.  A
// thread owns 4 output channels x 2 input channels x 9 taps: 72 sums.  A
// tile is 64 pixels with the window around them: 8 x 8 pixels of one image
// and their 10 x 10 window, or, for small images (``imgs`` > 0), imgs whole
// images, each with its own (H + 2) x (W + 2) window, so that a 4 x 4 image
// does not leave three quarters of a tile empty.  Two blocks fit an SM.  g and the window are
// gathered ONCE a tile for all nine taps, transposed to [pixel][channel] in
// shared memory by 4-byte cp.async (zero fill outside the image) into two
// stages: tile t + 1 lands while tile t is summed.  A pixel then costs a
// thread one 16-byte load of g, nine 8-byte loads of x (a tap is a constant
// offset from the pixel's window slot, which a table gives) and 72 FMA.

__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

constexpr int kV_CoT = 64, kV_CiT = 32, kV_Pix = 64, kV_WinMax = 192;
constexpr int kV_TH = 8, kV_TW = 8, kV_WinW = kV_TW + 2, kV_WinHW = (kV_TH + 2) * kV_WinW;
constexpr int kV_GStride = kV_CoT + 4, kV_XStride = kV_CiT + 4;  // 16- and 8-byte aligned rows
constexpr int kV_StageFloats = kV_Pix * kV_GStride + kV_WinMax * kV_XStride;
constexpr int kV_Smem = 2 * kV_StageFloats * 4;

__global__ void __launch_bounds__(256, 2)
wgrad3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ gr,
                    float* __restrict__ partial, int N, int Ci, int Co, int H, int W, int imgs,
                    long long units, int splits, int co_tiles, int ci_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* stages = reinterpret_cast<float*>(smem_raw);
  __shared__ int slot_of[2][kV_Pix];  // window slot of tap (0, 0) of every pixel

  const int tid = threadIdx.x, ti = tid & 15, tc = tid >> 4;
  long long b = blockIdx.x;
  const int ci0 = (int)(b % ci_tiles) * kV_CiT;
  b /= ci_tiles;
  const int co0 = (int)(b % co_tiles) * kV_CoT;
  const long long s = b / co_tiles;
  const long long unit_lo = s * units / splits, unit_hi = (s + 1) * units / splits;

  const bool flat = imgs > 0;
  const int HW = H * W;
  const int win_w = flat ? W + 2 : kV_WinW, win_hw = flat ? (H + 2) * (W + 2) : kV_WinHW;
  const int win_px = flat ? imgs * win_hw : kV_WinHW;
  const int used = flat ? imgs * HW : kV_Pix;  // pixel slots of a tile that can hold a pixel
  const int tiles_x = (W + kV_TW - 1) / kV_TW, tiles_y = (H + kV_TH - 1) / kV_TH;

  auto stage = [&](long long unit, int buf) {
    float* gs = stages + buf * kV_StageFloats;
    float* xs = gs + kV_Pix * kV_GStride;
    long long n0 = unit * imgs;
    int y0 = 0, x0 = 0;
    if (!flat) {
      long long q = unit;
      x0 = (int)(q % tiles_x) * kV_TW;
      q /= tiles_x;
      y0 = (int)(q % tiles_y) * kV_TH;
      n0 = q / tiles_y;
    }
    {  // g: a thread's pixel is fixed, it walks every fourth channel
      const int p = tid & (kV_Pix - 1);
      long long n = n0;
      int y, xx, slot;
      bool valid;
      if (flat) {
        const int im = p / HW, pin = p - im * HW;
        y = pin / W, xx = pin - y * W, n = n0 + im;
        valid = im < imgs && n < N;
        slot = im * win_hw + y * win_w + xx;
      } else {
        y = y0 + p / kV_TW, xx = x0 + p % kV_TW;
        valid = y < H && xx < W;
        slot = (p / kV_TW) * kV_WinW + p % kV_TW;
      }
      if (tid < kV_Pix) slot_of[buf][p] = valid ? slot : 0;
      const float* src = valid ? gr + ((size_t)n * Co + co0) * HW + (size_t)y * W + xx : gr;
      for (int c = tid / kV_Pix; c < kV_CoT; c += 256 / kV_Pix) {
        const bool ok = valid && co0 + c < Co;
        cp_async_4(smem_addr(gs + p * kV_GStride + c), ok ? src + (size_t)c * HW : gr, ok);
      }
    }
    for (int q = tid; q < win_px; q += 256) {  // the window: a thread's slot is fixed
      long long n = n0;
      int y, xx;
      bool valid = true;
      if (flat) {
        const int im = q / win_hw, rem = q - im * win_hw;
        y = rem / win_w - 1, xx = rem % win_w - 1, n = n0 + im;
        valid = n < N;
      } else {
        y = y0 - 1 + q / kV_WinW, xx = x0 - 1 + q % kV_WinW;
      }
      valid = valid && y >= 0 && y < H && xx >= 0 && xx < W;
      const float* src = valid ? x + ((size_t)n * Ci + ci0) * HW + (size_t)y * W + xx : x;
#pragma unroll 4
      for (int c = 0; c < kV_CiT; ++c) {
        const bool ok = valid && ci0 + c < Ci;
        cp_async_4(smem_addr(xs + q * kV_XStride + c), ok ? src + (size_t)c * HW : x, ok);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  float acc[9][4][2];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[t][i][0] = acc[t][i][1] = 0.f;
  int tap_off[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) tap_off[t] = ((t / 3) * win_w + t % 3) * kV_XStride;

  if (unit_lo < unit_hi) stage(unit_lo, 0);
  for (long long unit = unit_lo; unit < unit_hi; ++unit) {
    const int buf = (int)((unit - unit_lo) & 1);
    if (unit + 1 < unit_hi) {
      stage(unit + 1, buf ^ 1);  // its stage was consumed before the barrier below
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const float* gs = stages + buf * kV_StageFloats;
    const float* xs = gs + kV_Pix * kV_GStride + 2 * ti;
#pragma unroll 2
    for (int k = 0; k < used; ++k) {
      const float4 gv = *reinterpret_cast<const float4*>(gs + k * kV_GStride + 4 * tc);
      const float* xw = xs + slot_of[buf][k] * kV_XStride;
      const float gj[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const float2 xv = *reinterpret_cast<const float2*>(xw + tap_off[t]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[t][i][0] = fmaf(gj[i], xv.x, acc[t][i][0]);
          acc[t][i][1] = fmaf(gj[i], xv.y, acc[t][i][1]);
        }
      }
    }
    __syncthreads();  // this stage is consumed: the tile after next may land in it
  }

  const size_t plane9 = (size_t)Co * Ci;
  const int ci = ci0 + 2 * ti;
  const bool pair = (Ci & 1) == 0;  // 8-byte stores stay aligned
#pragma unroll
  for (int t = 0; t < 9; ++t) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int co = co0 + 4 * tc + i;
      if (co >= Co || ci >= Ci) continue;
      float* dst = partial + ((size_t)s * 9 + t) * plane9 + (size_t)co * Ci + ci;
      if (pair) {
        *reinterpret_cast<float2*>(dst) = make_float2(acc[t][i][0], acc[t][i][1]);
      } else {
        dst[0] = acc[t][i][0];
        if (ci + 1 < Ci) dst[1] = acc[t][i][1];
      }
    }
  }
}

// ---------------------------------------------------------- K8, bf16, wgmma
//
// Block: two consumer warpgroups and one producer warpgroup; one tile of
// 256 pixels (kR rows of kBW pixels of one image) and kCoT output channels,
// over all of Ci in slabs of 16.  Output channels are wgmma's M, pixels its
// N, input channels its K, so the accumulator [co][pixels] has NCHW's rows.
//
// A stage of the ring holds, for 16 input channels:
//   * the raw x window [kR + 2 rows][16 ci][kBW + 16 pixels], one TMA box of
//     the (W, Ci, H, N) view of x at column x0 - 8 and row y0 - 1.  What it
//     holds beyond the image (the padding, the ragged edge, ci >= Ci) TMA
//     fills with zeros: there is no table of offsets and no guard.
//   * the three views of it at columns x0 - 1, x0, x0 + 1 that the producer
//     warpgroup writes (``shift_window``), [kR + 2 rows][16 ci][kBW pixels]
//     each.  A tap's row shift dy is a whole box row (a multiple of the
//     swizzle's period), its column shift dx picks the view.  A line of a
//     view is one swizzle row (128 or 64 bytes), so a view is wgmma's
//     N-major B operand as it lies: 8 ci are the 8 rows of a swizzle atom,
//     the next 8 ci the stride offset, the next image row the leading offset.
//   * the weights of the slab, [tap][k half][co][8 ci], one bulk copy of a
//     contiguous block the wrapper packed: wgmma's K-major A operand without
//     swizzle (a core matrix of 8 co x 8 ci is 128 contiguous bytes).
// Barriers of a slot: ``raw`` (the window has landed), ``full`` (the three
// views are written, 128 arrivals, and the weights have landed), ``empty``
// (the eight consumer warps are done with it).  The raw windows are
// requested kStages slabs ahead, the weights when the slot is free; the
// views of slab s are written while slab s - 1 is multiplied.
// kCoT = 128: warpgroup g owns output channels 64 g .. 64 g + 63 and all
// 256 pixels (128 accumulators a thread).  kCoT = 64 (Co <= 64): both own
// the 64 channels and warpgroup g the rows g kR / 2 .. of the tile.
// The epilogue rounds to bf16 into the ring's memory in the store box's
// swizzled layout and one thread a warpgroup starts a TMA store, which
// clips the tile at the tensor's edges.

template <int kBW, int kCoT>
struct ConvTile {
  static constexpr int kR = 256 / kBW;                  // tile rows: 4 | 8
  static constexpr int kKC = 16;                        // input channels a stage
  static constexpr int kRowB = kBW * 2;                 // bytes of a view's line: 128 | 64
  static constexpr uint32_t kSwizzle = kBW == 64 ? kSwizzle128 : kSwizzle64;
  static constexpr int kLines = (kR + 2) * kKC;         // lines of the window
  static constexpr int kXBox = kLines * kRowB;          // one view
  static constexpr int kRawBytes = kLines * (kBW + 16) * 2;
  static constexpr int kWTap = 2 * kCoT * 16;           // [k half][co][8 ci]
  static constexpr int kWBytes = 9 * kWTap;
  static constexpr int kStage = 3 * kXBox + kWBytes + kRawBytes;  // views, weights, raw
  // 1024 bytes of slack to align the ring, 128 for the barriers.
  static constexpr int kMaxStages = (232448 - 1024 - 128) / kStage;
  static constexpr int kStages = kMaxStages > 3 ? 3 : kMaxStages;
  static constexpr int kSmem = kStages * kStage + 1024 + 128;
  static constexpr int kNAcc = kCoT == 128 ? 128 : 64;
  static constexpr int kStoreRows = kCoT == 128 ? kR : kR / 2;
  static_assert(kXBox % 1024 == 0 && kStage % 1024 == 0 && kWBytes % 1024 == 0,
                "views and raw windows keep the swizzle's phase and TMA's alignment");
  static_assert(kStages >= 2, "a ring");
  static_assert(2 * 64 * kStoreRows * kRowB <= kStage, "the epilogue fits the first stage");
};

template <int kBW, int kCoT>
__global__ void __launch_bounds__(kBlockThreads, 1)
conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_out, const bf16* __restrict__ wq,
                     int Ci, int tiles_x, int tiles_y, int co_tiles) {
  using T = ConvTile<kBW, kCoT>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = ring + T::kStages * T::kStage, empty = full + 8 * T::kStages;
  const uint32_t rawbar = empty + 8 * T::kStages;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  long long b = blockIdx.x;
  const int co_tile = (int)(b % co_tiles);
  b /= co_tiles;
  const int x0 = (int)(b % tiles_x) * kBW;
  b /= tiles_x;
  const int y0 = (int)(b % tiles_y) * T::kR;
  const int n = (int)(b / tiles_y);
  const int slabs = (Ci + T::kKC - 1) / T::kKC;

  if (tid == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(full + 8 * s, kProducerThreads + 1);  // the views' writers and the weights' expect_tx
      mbar_init(empty + 8 * s, kConsumerThreads / 32);
      mbar_init(rawbar + 8 * s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerThreads / 32) {
    setmaxnreg_dec<kProducerRegs>();
    const int ptid = tid - kConsumerThreads;
    auto request_raw = [&](int s) {
      const int slot = s % T::kStages;
      mbar_expect_tx(rawbar + 8 * slot, T::kRawBytes);
      tma_load_4d(ring + slot * T::kStage + 3 * T::kXBox + T::kWBytes, &map_x, rawbar + 8 * slot,
                  x0 - 8, s * T::kKC, y0 - 1, n);
    };
    if (ptid == 0)
      for (int s = 0; s < T::kStages && s < slabs; ++s) request_raw(s);
    for (int s = 0; s < slabs; ++s) {
      const int slot = s % T::kStages;
      const uint32_t round = (uint32_t)(s / T::kStages) & 1u;
      const uint32_t stage = ring + slot * T::kStage;
      mbar_wait(empty + 8 * slot, round ^ 1u);
      if (ptid == 0) {
        mbar_expect_tx(full + 8 * slot, T::kWBytes);
        bulk_load(stage + 3 * T::kXBox, wq + ((size_t)s * co_tiles + co_tile) * (T::kWBytes / 2),
                  T::kWBytes, full + 8 * slot);
      }
      mbar_wait(rawbar + 8 * slot, round);
      shift_window<kBW>(stage + 3 * T::kXBox + T::kWBytes, stage, T::kXBox, T::kLines, ptid);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(full + 8 * slot);
      // Every producer thread has read this raw window: the next may land.
      named_barrier(1, kProducerThreads);
      if (ptid == 0 && s + T::kStages < slabs) request_raw(s + T::kStages);
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = warp >> 2;
    float acc[T::kNAcc];
#pragma unroll
    for (int i = 0; i < T::kNAcc; ++i) acc[i] = 0.f;
    const uint32_t a_off = kCoT == 128 ? wg * 64 * 16 : 0;
    const uint32_t b_off = kCoT == 128 ? 0 : wg * (T::kR / 2) * T::kKC * T::kRowB;

    for (int s = 0; s < slabs; ++s) {
      const int slot = s % T::kStages;
      mbar_wait(full + 8 * slot, (uint32_t)(s / T::kStages) & 1u);
      const uint32_t xs = ring + slot * T::kStage, ws = xs + 3 * T::kXBox;
      wgmma_fence();
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap - dy * 3;
        const uint64_t da =
            wgmma_desc(ws + tap * T::kWTap + a_off, kCoT * 16, 128, kSwizzleNone);
        const uint64_t db = wgmma_desc(xs + dx * T::kXBox + dy * T::kKC * T::kRowB + b_off,
                                       T::kKC * T::kRowB, 8 * T::kRowB, T::kSwizzle);
        if constexpr (kCoT == 128) {
          wgmma_m64n256k16_nmajor_b(acc, da, db);
        } else {
          wgmma_m64n128k16_nmajor_b(acc, da, db);
        }
      }
      wgmma_commit();
      if (s > 0) {  // the slab before this one is multiplied: its slot is free
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(empty + 8 * ((s - 1) % T::kStages));
      }
    }
    wgmma_wait<0>();
    // Both warpgroups are past their last wgmma and every copy has landed:
    // the ring is free for the epilogue.
    named_barrier(2, kConsumerThreads);

    const uint32_t stage_out = ring + wg * 32768;
    const int w4 = warp & 3, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < T::kNAcc / 4; ++j) {
      const int r = (8 * j) / kBW, chunk = j % (kBW / 8);  // tile row, 16-byte chunk of it
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int co_l = 16 * w4 + g + 8 * h;
        const int sw = kBW == 64 ? (co_l & 7) : ((co_l >> 1) & 3);
        const uint32_t addr =
            stage_out + (r * 64 + co_l) * T::kRowB + ((chunk ^ sw) << 4) + t * 4;
        const __nv_bfloat162 v = __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr),
                     "r"(*reinterpret_cast<const uint32_t*>(&v))
                     : "memory");
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_barrier(3 + wg, 128);
    if ((tid & 127) == 0) {
      tma_store_4d(&map_out, stage_out, x0, co_tile * kCoT + (kCoT == 128 ? wg * 64 : 0),
                   y0 + (kCoT == 128 ? 0 : wg * T::kStoreRows), n);
      tma_store_finish();
    }
  }
}

// ------------------------------------------------------ K8, f32, small images
//
// For images of at most 64 pixels (8 x 8, 4 x 4): a tile of one image in
// the kernel above is mostly empty, and every block still reads all the
// weights of its 64 output channels.  Here a block holds 64 / (H W) whole
// images in 64 pixel slots and reads its weights once for all of them.
// Block: 64 threads; a thread owns 4 pixel slots and kJ = 8 output channels
// (4 where the grid would otherwise be small), so 32 or 16 channels a block.  Slabs of 8 input channels are staged as they lie (an
// image's plane is contiguous) by cp.async into two buffers, the next slab
// while this one is multiplied: with two warps a block nothing else hides
// the loads.  A tap of a pixel is a shared-memory index the thread keeps in
// a register, computed once from the pixel's own (y, x); outside the image
// it points at a slot that holds zero.  Weights come as [tap][ci][co].

constexpr int kP_Slots = 64, kP_CiT = 8, kP_Threads = 64;
constexpr int kP_XRow = kP_Slots + 4;  // slot 64 of a row is the zero

template <int kJ>  // output channels a thread: 8, or 4 where that leaves too few blocks
__global__ void __launch_bounds__(kP_Threads)
conv3x3_f32_flat_kernel(const float* __restrict__ x, const float* __restrict__ wp,
                        float* __restrict__ out, int N, int Ci, int Co, int H, int W,
                        int imgs, int co_tiles) {
  constexpr int kP_CoT = 4 * kJ;
  __shared__ __align__(16) float xs[2][kP_CiT * kP_XRow];      // [ci][slot]
  __shared__ __align__(16) float ws[2][kP_CiT * 9 * kP_CoT];   // [ci][tap][co]

  const int tid = threadIdx.x;
  const int p0 = (tid & 15) * 4, col = (tid >> 4) * kJ;
  const int co0 = (int)(blockIdx.x % co_tiles) * kP_CoT;
  const int n0 = (int)(blockIdx.x / co_tiles) * imgs;
  const int HW = H * W, used = imgs * HW;

  // The slot each tap of each of the thread's pixels reads.
  int tap_slot[9][4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int p = p0 + k, im = p / HW, pin = p - im * HW;
    const int y = pin / W, xx = pin - y * W;
    const bool live = p < used && n0 + im < N;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ys = y + tap / 3 - 1, xsrc = xx + tap % 3 - 1;
      tap_slot[tap][k] =
          (live && ys >= 0 && ys < H && xsrc >= 0 && xsrc < W) ? im * HW + ys * W + xsrc : kP_Slots;
    }
  }
  if (tid < 2 * kP_CiT) xs[tid / kP_CiT][(tid % kP_CiT) * kP_XRow + kP_Slots] = 0.f;

  const bool vec = (Co & 3) == 0;
  const int slot_img = tid / HW;
  const bool slot_live = tid < used && n0 + slot_img < N;
  const float* slot_src = x + (size_t)(n0 + slot_img) * Ci * HW + (tid - slot_img * HW);
  auto stage = [&](int slab, int buf) {
    const int ci0 = slab * kP_CiT;
#pragma unroll
    for (int cl = 0; cl < kP_CiT; ++cl) {  // thread t stages slot t of every channel
      const bool ok = slot_live && ci0 + cl < Ci;
      cp_async_4(smem_addr(&xs[buf][cl * kP_XRow + tid]),
                 ok ? slot_src + (size_t)(ci0 + cl) * HW : x, ok);
    }
    if (vec) {
      for (int idx = tid; idx < kP_CiT * 9 * (kP_CoT / 4); idx += kP_Threads) {
        const int q = idx % (kP_CoT / 4), rest = idx / (kP_CoT / 4);
        const int cl = rest / 9, tap = rest - cl * 9;
        const int ci = ci0 + cl, co = co0 + 4 * q;
        const bool ok = ci < Ci && co < Co;
        const float* src = ok ? wp + ((size_t)tap * Ci + ci) * Co + co : wp;
        cp_async_16(smem_addr(&ws[buf][(cl * 9 + tap) * kP_CoT + 4 * q]), src, ok);
      }
    } else {
      for (int idx = tid; idx < kP_CiT * 9 * kP_CoT; idx += kP_Threads) {
        const int co_l = idx % kP_CoT, rest = idx / kP_CoT;
        const int cl = rest / 9, tap = rest - cl * 9;
        const int ci = ci0 + cl, co = co0 + co_l;
        const bool ok = ci < Ci && co < Co;
        const float* src = ok ? wp + ((size_t)tap * Ci + ci) * Co + co : wp;
        cp_async_4(smem_addr(&ws[buf][idx]), src, ok);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  float acc[kJ][4];
#pragma unroll
  for (int j = 0; j < kJ; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[j][k] = 0.f;

  const int slabs = (Ci + kP_CiT - 1) / kP_CiT;
  stage(0, 0);
  for (int slab = 0; slab < slabs; ++slab) {
    const int buf = slab & 1;
    if (slab + 1 < slabs) {
      stage(slab + 1, buf ^ 1);  // its buffer was consumed before the barrier below
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
#pragma unroll
    for (int cl = 0; cl < kP_CiT; ++cl) {
      const float* xrow = xs[buf] + cl * kP_XRow;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const float4* wv =
            reinterpret_cast<const float4*>(ws[buf] + (cl * 9 + tap) * kP_CoT + col);
        float wj[kJ];
#pragma unroll
        for (int j = 0; j < kJ; j += 4) {
          const float4 w4 = wv[j / 4];
          wj[j] = w4.x, wj[j + 1] = w4.y, wj[j + 2] = w4.z, wj[j + 3] = w4.w;
        }
        float xr[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) xr[k] = xrow[tap_slot[tap][k]];
#pragma unroll
        for (int j = 0; j < kJ; ++j)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[j][k] = fmaf(wj[j], xr[k], acc[j][k]);
      }
    }
    __syncthreads();  // this buffer is consumed: the slab after next may land in it
  }

#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int p = p0 + k, im = p / HW, pin = p - im * HW;
    if (p >= used || n0 + im >= N) continue;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int co = co0 + col + j;
      if (co < Co) out[((size_t)(n0 + im) * Co + co) * HW + pin] = acc[j][k];
    }
  }
}

// ---------------------------------------------------------- K9, bf16, wgmma
//
// Block: two consumer warpgroups and one producer warpgroup; kCoT output
// channels x 32 input channels x 9 taps, summed over the pixel tiles
// [tile_lo, tile_hi) of its split.  A tile is 128 pixels: kR rows of kBW.
// Output channels are wgmma's M, input channels its N, pixels its K: both
// operands are K-major as NCHW has them.
//
// A stage of the ring is one pixel tile: the g box [kR rows][kCoT co][kBW
// pixels] (TMA, swizzled), the raw x window [kR + 2 rows][32 ci][kBW + 16
// pixels] (TMA, at column x0 - 8) and the three views of it at columns
// x0 - 1, x0, x0 + 1 that the producer warpgroup writes, as in K8 and with
// K8's three barriers a slot (g takes the place of the weights).  A k-step
// is 16 pixels of one row: the g fragment of a warp's 16 output channels is
// read once (ldmatrix, addresses swizzled as TMA wrote them) and feeds the
// nine taps' wgmma from registers; the nine shifted views of the x window
// are B from shared memory.  Two fragment buffers alternate, and
// wgmma.wait_group 1 after every k-step frees the one the step before
// read.  A thread holds 9 x 16 accumulators.
// kCoT = 128: warpgroup g owns output channels 64 g .. and all rows.
// kCoT = 64 (Co <= 64): both own the 64 channels, warpgroup g sums the rows
// g kR / 2 .. of every tile into a partial of its own (slice 2 s + g).
// The partials [slice][tap][co][ci] are stored 16 bytes a thread (two lanes
// exchange halves so that each holds four consecutive input channels).

template <int kBW, int kCoT>
struct WgradTile {
  static constexpr int kR = 128 / kBW;  // tile rows: 2 | 4
  static constexpr int kCiT = 32;
  static constexpr int kRowB = kBW * 2;
  static constexpr uint32_t kSwizzle = kBW == 64 ? kSwizzle128 : kSwizzle64;
  static constexpr int kGBytes = kR * kCoT * kRowB;
  static constexpr int kLines = (kR + 2) * kCiT;
  static constexpr int kXBox = kLines * kRowB;
  static constexpr int kRawBytes = kLines * (kBW + 16) * 2;
  static constexpr int kStage = 3 * kXBox + kGBytes + kRawBytes;  // views, g, raw
  static constexpr int kMaxStages = (232448 - 1024 - 128) / kStage;
  static constexpr int kStages = kMaxStages > 3 ? 3 : kMaxStages;
  static constexpr int kSmem = kStages * kStage + 1024 + 128;
  static constexpr int kRowsPerGroup = kCoT == 128 ? kR : kR / 2;
  static constexpr int kSteps = kRowsPerGroup * (kBW / 16);  // k-steps a tile a warpgroup
  static_assert(kGBytes % 1024 == 0 && kXBox % 1024 == 0 && kStage % 1024 == 0,
                "boxes keep the swizzle's phase and TMA's alignment");
  static_assert(kStages >= 2, "a ring");
};

template <int kBW, int kCoT>
__global__ void __launch_bounds__(kBlockThreads, 1)
wgrad3x3_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_g, float* __restrict__ partial,
                      int Ci, int Co, int tiles_x, int tiles_y, long long tiles, int splits,
                      int co_tiles, int ci_tiles) {
  using T = WgradTile<kBW, kCoT>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = ring + T::kStages * T::kStage, empty = full + 8 * T::kStages;
  const uint32_t rawbar = empty + 8 * T::kStages;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  long long b = blockIdx.x;
  const int ci0 = (int)(b % ci_tiles) * T::kCiT;
  b /= ci_tiles;
  const int co0 = (int)(b % co_tiles) * kCoT;
  const long long s = b / co_tiles;
  const long long tile_lo = s * tiles / splits, tile_hi = (s + 1) * tiles / splits;
  const int count = (int)(tile_hi - tile_lo);

  if (tid == 0) {
    for (int i = 0; i < T::kStages; ++i) {
      mbar_init(full + 8 * i, kProducerThreads + 1);
      mbar_init(empty + 8 * i, kConsumerThreads / 32);
      mbar_init(rawbar + 8 * i, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerThreads / 32) {
    setmaxnreg_dec<kProducerRegs>();
    const int ptid = tid - kConsumerThreads;
    // Tile i of the split: its column, row and image.
    auto origin = [&](int i, int& x0, int& y0, int& n) {
      long long q = tile_lo + i;
      x0 = (int)(q % tiles_x) * kBW;
      q /= tiles_x;
      y0 = (int)(q % tiles_y) * T::kR;
      n = (int)(q / tiles_y);
    };
    auto request_raw = [&](int i) {
      const int slot = i % T::kStages;
      int x0, y0, n;
      origin(i, x0, y0, n);
      mbar_expect_tx(rawbar + 8 * slot, T::kRawBytes);
      tma_load_4d(ring + slot * T::kStage + 3 * T::kXBox + T::kGBytes, &map_x, rawbar + 8 * slot,
                  x0 - 8, ci0, y0 - 1, n);
    };
    if (ptid == 0)
      for (int i = 0; i < T::kStages && i < count; ++i) request_raw(i);
    for (int i = 0; i < count; ++i) {
      const int slot = i % T::kStages;
      const uint32_t round = (uint32_t)(i / T::kStages) & 1u;
      const uint32_t stage = ring + slot * T::kStage;
      mbar_wait(empty + 8 * slot, round ^ 1u);
      if (ptid == 0) {
        int x0, y0, n;
        origin(i, x0, y0, n);
        mbar_expect_tx(full + 8 * slot, T::kGBytes);
        tma_load_4d(stage + 3 * T::kXBox, &map_g, full + 8 * slot, x0, co0, y0, n);
      }
      mbar_wait(rawbar + 8 * slot, round);
      shift_window<kBW>(stage + 3 * T::kXBox + T::kGBytes, stage, T::kXBox, T::kLines, ptid);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(full + 8 * slot);
      named_barrier(1, kProducerThreads);
      if (ptid == 0 && i + T::kStages < count) request_raw(i + T::kStages);
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = warp >> 2, w4 = warp & 3;
    float acc[9][16];
#pragma unroll
    for (int i = 0; i < 9; ++i)
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[i][j] = 0.f;
    const int co_off = kCoT == 128 ? wg * 64 : 0;
    const int row_lo = kCoT == 128 ? 0 : wg * T::kRowsPerGroup;
    // ldmatrix.x4: lane l addresses row l % 8 of matrix l / 8; the matrices
    // are (rows 0-7 | 8-15) x (k 0-7 | 8-15) of the warp's 16 x 16 fragment.
    const int frag_row = co_off + 16 * w4 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int frag_half = lane >> 4;

    for (int i = 0; i < count; ++i) {
      const int slot = i % T::kStages;
      mbar_wait(full + 8 * slot, (uint32_t)(i / T::kStages) & 1u);
      const uint32_t xs = ring + slot * T::kStage, gs = xs + 3 * T::kXBox;
      uint32_t a[2][4] = {};
#pragma unroll
      for (int step = 0; step < T::kSteps; ++step) {
        const int r = row_lo + step / (kBW / 16), kk = step % (kBW / 16);
        const int row = r * kCoT + frag_row;  // 128- or 64-byte row of the g box
        const int sw = kBW == 64 ? (row & 7) : ((row >> 1) & 3);
        ldmatrix_x4(a[step & 1], gs + row * T::kRowB + (((kk * 2 + frag_half) ^ sw) << 4));
        wgmma_fence();
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int dy = tap / 3, dx = tap - dy * 3;
          const uint64_t db =
              wgmma_desc(xs + dx * T::kXBox + (r + dy) * T::kCiT * T::kRowB + kk * 32, 16,
                         8 * T::kRowB, T::kSwizzle);
          wgmma_m64n32k16_reg_a(acc[tap], a[step & 1], db);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the step before is done: its fragment may be overwritten
#pragma unroll
        for (int e = 0; e < 4; ++e) keep_alive(a[(step & 1) ^ 1][e]);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < 4; ++e) keep_alive(a[(T::kSteps - 1) & 1][e]);
      if (lane == 0) mbar_arrive(empty + 8 * slot);
    }

    const long long slice = kCoT == 128 ? s : 2 * s + wg;
    const int g = lane >> 2, t = lane & 3, odd = t & 1;
    const int co = co0 + co_off + 16 * w4 + g + 8 * odd;
    const bool vec = (Ci & 3) == 0;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      float* dst = partial + ((size_t)(slice * 9 + tap) * Co + (co < Co ? co : 0)) * Ci;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // Even lanes keep row g, odd lanes row g + 8; each gets the other's
        // two columns of its row: four consecutive input channels.
        const float v0 = acc[tap][4 * j], v1 = acc[tap][4 * j + 1];
        const float v2 = acc[tap][4 * j + 2], v3 = acc[tap][4 * j + 3];
        const float r0 = __shfl_xor_sync(0xffffffffu, odd ? v0 : v2, 1);
        const float r1 = __shfl_xor_sync(0xffffffffu, odd ? v1 : v3, 1);
        const float4 o = odd ? make_float4(r0, r1, v2, v3) : make_float4(v0, v1, r0, r1);
        const int ci = ci0 + 8 * j + 2 * (t - odd);
        if (co >= Co || ci >= Ci) continue;
        if (vec) {
          *reinterpret_cast<float4*>(dst + ci) = o;
        } else {
          const float ov[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (ci + e < Ci) dst[ci + e] = ov[e];
        }
      }
    }
  }
}

// Second pass of K9: the partials [split][tap][co][ci] summed over the
// splits in their order, rounded once, stored as OIHW [co][ci][tap].
template <typename T>
__global__ void wgrad_reduce_kernel(const float* __restrict__ partial, T* __restrict__ dw,
                                    int Ci, int Co, int splits) {
  const size_t total = (size_t)9 * Co * Ci;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) sum += partial[(size_t)s * total + idx];
  const size_t plane9 = (size_t)Co * Ci;
  const size_t tap = idx / plane9, rem = idx - tap * plane9;  // rem = co * Ci + ci
  if constexpr (sizeof(T) == 2) {
    dw[rem * 9 + tap] = __float2bfloat16(sum);
  } else {
    dw[rem * 9 + tap] = sum;
  }
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Kernel variants, as the wrapper names them.
enum Variant { kMmaSync = 0, kWgmma = 1, kF32Tiled = 2, kF32Flat = 3 };

// Return codes beside cudaError_t: a tensor map that libcuda refused is
// kMapError + its CUresult.
constexpr int kMapError = 10000, kNoLibcuda = 9999;

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the libcuda the process has loaded.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return h ? (EncodeTiledFn)dlsym(h, "cuTensorMapEncodeTiled") : (EncodeTiledFn) nullptr;
  }();
  return fn;
}

// The tensor map of a contiguous bf16 [N, C, H, W] tensor seen as
// (W, C, H, N), with boxes of [bh rows][bc channels][bw pixels] of one
// image; ``swizzled`` over a box line of 128 or 64 bytes, or as it lies.
int make_map(CUtensorMap* map, const void* ptr, int N, int C, int H, int W, int bw, int bc,
             int bh, bool swizzled) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kNoLibcuda;
  const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)C, (cuuint64_t)H, (cuuint64_t)N};
  const cuuint64_t strides[3] = {(cuuint64_t)H * W * 2, (cuuint64_t)W * 2,
                                 (cuuint64_t)C * H * W * 2};
  const cuuint32_t box[4] = {(cuuint32_t)bw, (cuuint32_t)bc, (cuuint32_t)bh, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw = !swizzled  ? CU_TENSOR_MAP_SWIZZLE_NONE
                                : bw == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                           : CU_TENSOR_MAP_SWIZZLE_64B;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kMapError + (int)r;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int kBW, int kCoT>
int launch_conv_wgmma(const void* x, const void* wq, void* out, int N, int Ci, int Co, int H,
                      int W, cudaStream_t st) {
  using T = ConvTile<kBW, kCoT>;
  CUtensorMap map_x, map_out;
  int rc = make_map(&map_x, x, N, Ci, H, W, kBW + 16, T::kKC, T::kR + 2, false);
  if (rc != 0) return rc;
  rc = make_map(&map_out, out, N, Co, H, W, kBW, 64, T::kStoreRows, true);
  if (rc != 0) return rc;
  const int tx = ceil_div(W, kBW), ty = ceil_div(H, T::kR), ct = ceil_div(Co, kCoT);
  const long long blocks = (long long)N * ty * tx * ct;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  cudaError_t e = cudaFuncSetAttribute(conv3x3_wgmma_kernel<kBW, kCoT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (e != cudaSuccess) return (int)e;
  conv3x3_wgmma_kernel<kBW, kCoT><<<(unsigned)blocks, kBlockThreads, T::kSmem, st>>>(
      map_x, map_out, (const bf16*)wq, Ci, tx, ty, ct);
  return (int)cudaGetLastError();
}

template <int kBW, int kCoT>
int launch_wgrad_wgmma(const void* x, const void* g, float* partial, int N, int Ci, int Co,
                       int H, int W, int splits, cudaStream_t st) {
  using T = WgradTile<kBW, kCoT>;
  CUtensorMap map_x, map_g;
  int rc = make_map(&map_x, x, N, Ci, H, W, kBW + 16, T::kCiT, T::kR + 2, false);
  if (rc != 0) return rc;
  rc = make_map(&map_g, g, N, Co, H, W, kBW, kCoT, T::kR, true);
  if (rc != 0) return rc;
  const int tx = ceil_div(W, kBW), ty = ceil_div(H, T::kR);
  const int ct = ceil_div(Co, kCoT), cit = ceil_div(Ci, T::kCiT);
  const long long tiles = (long long)N * ty * tx, blocks = (long long)splits * ct * cit;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  cudaError_t e = cudaFuncSetAttribute(wgrad3x3_wgmma_kernel<kBW, kCoT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (e != cudaSuccess) return (int)e;
  wgrad3x3_wgmma_kernel<kBW, kCoT><<<(unsigned)blocks, kBlockThreads, T::kSmem, st>>>(
      map_x, map_g, partial, Ci, Co, tx, ty, tiles, splits, ct, cit);
  return (int)cudaGetLastError();
}

// The wgmma kernels' tile widths, from the shape alone: 64-pixel box rows
// (32 where the image is no wider), 128 output channels (64 where the
// tensor has no more).  The wrapper packs K8's weights for the same kCoT.
inline int wgmma_bw(int W) { return W > 32 ? 64 : 32; }
inline int wgmma_cot(int Co) { return Co > 64 ? 128 : 64; }

}  // namespace

// The entry points launch on ``stream`` and return 0, a cudaError_t
// (cudaGetLastError() after the launch), or a code of this file for a tensor
// map that could not be made.  ``variant`` names the kernel (enum Variant):
// the wrapper picks it from the shape and packs the weights for it.

// K8: x [N, Ci, H, W] and the packed weights -> out [N, Co, H, W].  Weights:
// kMmaSync [9][Co][Ci] bf16; kWgmma [Ci / 16][Co / kCoT][9][2][kCoT][8] bf16,
// zero-padded; kF32Tiled and kF32Flat [9][Ci][Co] f32.
extern "C" int gantrack_conv3x3(const void* x, const void* wp, void* out, int N, int Ci, int Co,
                                int H, int W, int variant, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (variant == kWgmma) {
    if (W % 8 != 0 || !aligned16(x) || !aligned16(wp) || !aligned16(out))
      return (int)cudaErrorInvalidValue;
    const bool wide = wgmma_bw(W) == 64, many = wgmma_cot(Co) == 128;
    if (wide) {
      return many ? launch_conv_wgmma<64, 128>(x, wp, out, N, Ci, Co, H, W, st)
                  : launch_conv_wgmma<64, 64>(x, wp, out, N, Ci, Co, H, W, st);
    }
    return many ? launch_conv_wgmma<32, 128>(x, wp, out, N, Ci, Co, H, W, st)
                : launch_conv_wgmma<32, 64>(x, wp, out, N, Ci, Co, H, W, st);
  }
  if (variant == kMmaSync) {
    const int tx = ceil_div(W, kF_TW), ty = ceil_div(H, kF_TH), ct = ceil_div(Co, kF_CoT);
    const long long blocks = (long long)N * ty * tx * ct;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
    cudaError_t e = cudaFuncSetAttribute(conv3x3_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kF_SmemBytes);
    if (e != cudaSuccess) return (int)e;
    conv3x3_bf16_kernel<<<(unsigned)blocks, 256, kF_SmemBytes, st>>>(
        (const bf16*)x, (const bf16*)wp, (bf16*)out, Ci, Co, H, W, tx, ty, ct);
  } else if (variant == kF32Tiled) {
    const int tx = ceil_div(W, kS_TW), ty = ceil_div(H, kS_TH), ct = ceil_div(Co, kS_CoT);
    const long long blocks = (long long)N * ty * tx * ct;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
    conv3x3_f32_kernel<<<(unsigned)blocks, 256, 0, st>>>((const float*)x, (const float*)wp,
                                                         (float*)out, Ci, Co, H, W, tx, ty, ct);
  } else if (variant == kF32Flat) {
    if ((long long)H * W > kP_Slots) return (int)cudaErrorInvalidValue;
    // 32 output channels a block; 16 where that would leave fewer than two
    // blocks an SM of the H100: there a block's chain of slabs, not the
    // card's FMA rate, sets the time (0.17 against 0.33 ms at 32 x 512 x 4 x 4),
    // while with more blocks the narrow tile's extra loads cost more.
    const int imgs = kP_Slots / (H * W);
    const bool narrow = (long long)ceil_div(N, imgs) * ceil_div(Co, 32) < 2 * 132;
    const int ct = ceil_div(Co, narrow ? 16 : 32);
    const long long blocks = (long long)ceil_div(N, imgs) * ct;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
    if (narrow) {
      conv3x3_f32_flat_kernel<4><<<(unsigned)blocks, kP_Threads, 0, st>>>(
          (const float*)x, (const float*)wp, (float*)out, N, Ci, Co, H, W, imgs, ct);
    } else {
      conv3x3_f32_flat_kernel<8><<<(unsigned)blocks, kP_Threads, 0, st>>>(
          (const float*)x, (const float*)wp, (float*)out, N, Ci, Co, H, W, imgs, ct);
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K9: x [N, Ci, H, W], g [N, Co, H, W], scratch ``partial``
// [slices][9][Co][Ci] f32 -> dw [Co, Ci, 3, 3].  The reduction over N*H*W
// is cut into ``splits`` ranges of units (kWgmma: tiles of 128 pixels;
// kMmaSync: tiles of 8 x 16; kF32Tiled: tiles of 8 x 8 or, with ``imgs``
// > 0, of imgs whole images); a split writes one slice, or two under
// kWgmma with Co <= 64.  The wrapper sizes all three from the shape;
// ``slices`` and ``imgs`` are checked against what the kernels can take.
extern "C" int gantrack_wgrad3x3(const void* x, const void* g, float* partial, void* dw, int N,
                                 int Ci, int Co, int H, int W, int splits, int slices, int imgs,
                                 int variant, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  long long units = 0, per_split = 0;
  int want_slices = splits;
  if (variant == kWgmma) {
    const int bw = wgmma_bw(W), cot = wgmma_cot(Co);
    units = (long long)N * ceil_div(H, 128 / bw) * ceil_div(W, bw);
    per_split = (long long)ceil_div(Co, cot) * ceil_div(Ci, 32);
    if (cot == 64) want_slices = 2 * splits;
  } else if (variant == kMmaSync) {
    units = (long long)N * ceil_div(H, kW_TH) * ceil_div(W, kW_TW);
    per_split = (long long)ceil_div(Co, kW_CoT) * ceil_div(Ci, kW_CiT);
  } else if (variant == kF32Tiled) {
    if (imgs < 0 || (long long)imgs * H * W > kV_Pix ||
        (long long)imgs * (H + 2) * (W + 2) > kV_WinMax)
      return (int)cudaErrorInvalidValue;
    units = imgs > 0 ? ((long long)N + imgs - 1) / imgs
                     : (long long)N * ceil_div(H, kV_TH) * ceil_div(W, kV_TW);
    per_split = (long long)ceil_div(Co, kV_CoT) * ceil_div(Ci, kV_CiT);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  const long long blocks = per_split * splits;
  if (splits < 1 || splits > units || slices != want_slices || blocks > 2147483647LL)
    return (int)cudaErrorInvalidConfiguration;
  if (variant == kWgmma) {
    if (W % 8 != 0 || !aligned16(x) || !aligned16(g)) return (int)cudaErrorInvalidValue;
    const bool wide = wgmma_bw(W) == 64, many = wgmma_cot(Co) == 128;
    int rc;
    if (wide) {
      rc = many ? launch_wgrad_wgmma<64, 128>(x, g, partial, N, Ci, Co, H, W, splits, st)
                : launch_wgrad_wgmma<64, 64>(x, g, partial, N, Ci, Co, H, W, splits, st);
    } else {
      rc = many ? launch_wgrad_wgmma<32, 128>(x, g, partial, N, Ci, Co, H, W, splits, st)
                : launch_wgrad_wgmma<32, 64>(x, g, partial, N, Ci, Co, H, W, splits, st);
    }
    if (rc != 0) return rc;
  } else if (variant == kMmaSync) {
    wgrad3x3_bf16_kernel<<<(unsigned)blocks, 256, 0, st>>>(
        (const bf16*)x, (const bf16*)g, partial, Ci, Co, H, W, ceil_div(W, kW_TW),
        ceil_div(H, kW_TH), units, splits, ceil_div(Co, kW_CoT), ceil_div(Ci, kW_CiT));
  } else {
    cudaError_t e = cudaFuncSetAttribute(wgrad3x3_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kV_Smem);
    if (e != cudaSuccess) return (int)e;
    wgrad3x3_f32_kernel<<<(unsigned)blocks, 256, kV_Smem, st>>>(
        (const float*)x, (const float*)g, partial, N, Ci, Co, H, W, imgs, units, splits,
        ceil_div(Co, kV_CoT), ceil_div(Ci, kV_CiT));
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t total = (size_t)9 * Co * Ci;
  const unsigned rblocks = (unsigned)((total + 255) / 256);
  if (variant == kF32Tiled) {
    wgrad_reduce_kernel<float><<<rblocks, 256, 0, st>>>(partial, (float*)dw, Ci, Co, slices);
  } else {
    wgrad_reduce_kernel<bf16><<<rblocks, 256, 0, st>>>(partial, (bf16*)dw, Ci, Co, slices);
  }
  return (int)cudaGetLastError();
}
