// Fused dynamic-conv + sigmoid + dice/lava loss reductions, forward and
// backward, on Hopper's tensor cores (sm_90a). Plain C interface, loaded
// with ctypes by planerecnet_tpu_torch/ops/dice_lava.py.
//
// Replaces planerecnet_tpu/ops/pallas/dice_lava.py::fused_dice_lava: the
// forward kernel _fwd_kernel and the backward kernel _bwd_kernel. For image
// b, slot p and pixel q (HW pixels, K kernel channels, N instances):
//   s[p, q] = sigmoid(kernels[p] . feat[q]),   t[p, q] = onehot[p] . targets[:, q]
//   forward:  a[p] = sum_q s t,  b[p] = sum_q s^2,  lava[p] = sum_q s g[q]
//   backward: dl[p, q] = (ga[p] t + 2 gb[p] s + gl[p] g[q]) s (1 - s)
//             dk[p, :] = sum_q dl[p, q] feat[q, :]
//             dm[q, :] = sum_p dl[p, q] kernels[p, :]
// without ever writing the (B, P, HW) probabilities to device memory.
//
// What bounds it: operations. At the training shape (B=8, P=128, K=128,
// N=32, HW=25600) the forward is ~8.4 GFLOP of matrix products on ~133 MB
// of inputs, the backward ~22 GFLOP on ~238 MB; every product is f32 by
// contract. So the products run on the tensor cores in TF32, and f32
// accuracy is kept by a 3xTF32 split (an f32 FMA version, register-blocked
// from shared memory, reached 19% and 26% of the f32 rate).
//
// 3xTF32. Each operand x is split into hi = tf32(x) (cvt.rna, round to
// nearest, low 13 bits zero, so the tensor core reads it exactly) and
// lo = x - hi (exact in f32, |lo| <= 2^-11 |x|), of which the tensor core
// reads the top 19 bits: lo to 2^-10 of itself, x to ~2^-21. Then
//   a.b ~ lo_a.hi_b + hi_a.lo_b + hi_a.hi_b
// with f32 accumulation, small terms first; the dropped lo.lo term is
// ~2^-22 of the product. That is ~21 bits against f32's 24, where one TF32
// pass keeps ~11 (about 3 digits) and misses chip_smoke.py's f32 tolerance
// (1e-5 of scale). Rounding lo as well (a second cvt) gained nothing
// measurable in that tolerance and cost 9% of the backward.
//
// Routes. wgmma takes .tf32 operands K-major only, B only from shared
// memory, A from shared memory or registers.
//   - S = kernels . feat_tile^T (both kernels): wgmma m64nTQk8. A = the
//     kernel rows, registers, loaded from shared memory (fragment order,
//     one 16-byte load a k-step) and split 4 or 8 k-steps at a time: hi
//     and lo rows of all 128 slots would need 128 KB at K=128 and 256 KB at
//     K=256 in shared memory. B = the feature tile, K-major as stored, its
//     hi in place and lo in a second 128-byte swizzled buffer.
//   - Backward, K = 32 and 128 (pixel tile 32):
//     * dk^T = feat_tile^T . dl^T, wgmma m64n128k8: A (channels x pixels,
//       MN-major in the feature tile) loaded by hand into registers, B =
//       the split dl tile, slots x pixels, pixels contiguous.
//     * dm^T = kernels^T . dl, wgmma m64n32k8: A (channels x slots,
//       MN-major in the kernel rows) gathered by hand into registers, B =
//       a transposed copy of the split dl tile, pixels x slots, slots
//       contiguous. dm^T goes through a swizzled staging tile so that dm
//       is written with coalesced 16-byte stores.
//     The dl tile is written once per tile in both layouts (pre-split);
//     each warpgroup takes 64 channels (at K=32 the second one multiplies
//     zero rows, which keeps wgmma out of divergent code).
//   - mma.sync.m16n8k8.tf32, each warp on its own 16 slots, fragments
//     loaded by hand:
//     * s . [targets; g]^T (forward): A = the wgmma accumulator itself.
//       Its thread holds pixels (2t, 2t+1) of each 8-pixel block where a
//       tf32 A fragment wants (t, t+4); a sum over pixels does not care
//       about their order, so the B fragments (the pre-split target rows,
//       pixels contiguous) are read in the same permuted order: logical
//       k = t is pixel 2t, k = t+4 is pixel 2t+1, one 8-byte load. Its
//       n is 8 ceil((N+1)/8), which wgmma would want at compile time.
//     * t = onehot . targets_tile (backward): targets are MN-major
//       (instances strided); the one-hot fragments sit in registers,
//       loaded once per image.
//     * K = 256 (pixel tile 16): dk = dl . feat_tile with A = dl from
//       registers (permuted as above) and dm = dl^T . kernels from the dl
//       tile: shared memory has no room for the wgmma layouts there.
//   None is an FMA loop; the only FMA work is the epilogue of the
//   forward's a[p] = sum_n onehot[p, n] C[p, n] (C = sum_q s t_n, which
//   keeps the general onehot @ targets contract for any onehot), once per
//   block and image.
//
// Tiles and pipeline. A block of 256 threads (two warpgroups) owns all
// 128 slots (P <= 128, padded with zero rows) and a contiguous range of
// the batch's (image, pixel tile) items: a persistent grid, as many
// blocks as fit on the SMs at once (one per SM at K=128). Pixel tiles are
// 64 wide in the forward, 32 in the backward, 16 at K=256. Per item, after
// one barrier, the next tile's feature rows, target rows and lava row go
// to the other stage of a two-stage ring by cp.async (16 B for features,
// 4 B for the ragged target rows, zero-filled past HW) and land while the
// current tile is computed; completion is cp.async.wait_group and that
// barrier (every thread loads a share). The barrier is needed anyway, to
// free the stage that the next prefetch overwrites, so an mbarrier for
// completion would add a wait and remove none. A pass over the landed
// tile writes hi in place and lo to its own buffers (fence.proxy.async,
// then wgmma reads them). The image's kernel rows are staged once per
// image.
//   Forward: C (16 slots x 8 ceil((N+1)/8) a warp, each tile's part formed
//   in its own accumulator, then added in f32) and b stay in registers
//   across the block's tiles of one image; at the end of the image one
//   reduction over the 4 lanes of a row and one f32 atomic per slot and
//   quantity.
//   Backward: dk in registers across tiles (dk^T, 64 a thread; 128 at
//   K = 256, which fills the 255 registers: see phase_fence), one f32
//   atomic per element per block and image or 16 tiles; dm for the tile's
//   pixels is written directly: a block owns all P slots of its pixels, so
//   dm needs no atomics.
// The sigmoid is zeroed on pixels past HW (sigmoid(0) = 0.5 would
// otherwise pollute b, dice_lava.py:63). The atomics make a, b, lava and
// dk vary in their last bits from run to run.
//
// Deterministic variants (prn_dice_lava_fwd_det, prn_dice_lava_bwd_det),
// for training that must reproduce a run: the same kernels with DET set,
// whose flush stores a block's sums for an image to its own slot of a
// workspace instead of adding them to a, b, lava or dk with atomics (dk,
// flushed every kDkTiles tiles, adds to its slot after the first store;
// one thread owns each element, so in a fixed order). A block's items are
// a contiguous range, so it meets at most ipb images; its slots are
// indexed by image - its first image. Then det_reduce_kernel adds, for
// each output element, the slots of the blocks that met its image, in
// block order, and adds that sum to the output. Partials are blocks x ipb
// x 3P floats (forward) and blocks x ipb x P x K (backward: 17 MB at
// B=8, P=K=128, HW=25600 on 132 SMs); the wrapper allocates them.
//
// Shared memory (KB; 1 KB alignment slack included), N = 32 / N = 63:
//   K    pass  tile  features  dl tiles  kernel rows  targets      total
//   32   fwd   64    24        -         16           33.8 / 54    74.8 / 95.0
//   32   bwd   32    12        64        16           18.8 / 30    111.8 / 123.0
//   128  fwd   64    96        -         64           33.8 / 54    194.8 / 215.0
//   128  bwd   32    48        64        64           18.8 / 30    195.8 / 207.0
//   256  fwd   16    48        -         128          11.3 / 18    188.2 / 195.0
//   256  bwd   16    48        16        128          11.3 / 18    204.2 / 211.0
// (features: two ring stages and the lo buffer; targets: two stages and
// the lo buffer.)
//
// Instances. One launch takes N <= 63, so that [targets; g] is at most 8
// n8 blocks (registers of C, the target ring above). A larger N is split
// on the host into even chunks of at most 63, one launch each over the
// same tiles, in stream order: each adds its instances' share of a and,
// in the backward, of dl (the ga t term) to dk and dm; the first launch
// alone adds b, lava and dl's other terms, and writes dm, which the later
// ones add to. Each chunk recomputes S; the presets (N = 32, tiny 4) take
// one launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;   // two warpgroups
constexpr int kMaxP = 128;      // 8 warps x 16 slots
constexpr int kMaxNB = 8;       // n8 blocks of [targets; g]: N + 1 <= 64
constexpr int kMaxN = 8 * kMaxNB - 1;   // instances of one launch
// dk leaves its tensor-core accumulator for global memory every kDkTiles
// tiles, besides at the end of an image: that accumulation drifts over
// hundreds of increments (dk used 0.58 of its error allowance with one
// flush per image, 0.36 with one per 16 tiles, for 2% of the time).
constexpr int kDkTiles = 16;

// Pixel-tile widths: the backward holds more per tile (dk in registers,
// the dl tile in two layouts), so its tiles are narrower.
template <int K, bool BWD> struct Tile {
  static constexpr int TQ = K >= 256 ? 16 : (BWD ? 32 : 64);
};

struct Args {
  const float* kernels;  // (B, P, K)
  const float* feat;     // (B, HW, K)
  const float* onehot;   // (B, P, ldn), from this launch's first instance
  const float* targets;  // (B, ldn, HW), from this launch's first instance
  const float* grad;     // (B, HW)
  int B, P, N, HW;       // N: this launch's instances
  int ldn;               // all instances
  bool lead;             // the first (or only) chunk of N (see the header)
  // The deterministic variants only: per-block partials (ws_cap floats),
  // at most ipb images a block (see "Deterministic variants").
  float* ws;
  long long ws_cap;
  int ipb;
};

// Shared-memory carve, in floats from a 1024-byte aligned base. The
// feature buffers come first: wgmma's 128-byte swizzle wants 1 KB atoms.
struct Layout {
  int feat0, feat1, lo, dl_hi, dl_lo, dlt_hi, dlt_lo, ks, ts0, ts1, ts_lo;
  int total;
  int ts_stride, np, nk;
};

__host__ __device__ inline Layout make_layout(int K, int TQ, int N,
                                              bool backward) {
  Layout l;
  l.np = 8 * ((N + 1 + 7) / 8);
  l.nk = (N + 7) / 8;
  l.ts_stride = TQ + 8;
  const int f = TQ * K;
  // The backward's dl tile, one row of TQ floats per slot: 128 bytes,
  // swizzled for wgmma's B operand of dk at TQ = 32; plain rows at TQ = 16
  // (K = 256), where shared memory has no room for padding.
  const int dl = backward ? kMaxP * TQ : 0;
  l.feat0 = 0;
  l.feat1 = f;
  l.lo = 2 * f;
  l.dl_hi = 3 * f;
  l.dl_lo = l.dl_hi + dl;
  // dl^T (pixels x slots), wgmma's B operand of dm^T at TQ = 32.
  const int dlt = backward && TQ == 32 ? TQ * kMaxP : 0;
  l.dlt_hi = l.dl_lo + dl;
  l.dlt_lo = l.dlt_hi + dlt;
  l.ks = l.dlt_lo + dlt;
  l.ts0 = l.ks + kMaxP * K;
  l.ts1 = l.ts0 + l.np * l.ts_stride;
  l.ts_lo = l.ts1 + l.np * l.ts_stride;
  l.total = l.ts_lo + l.np * l.ts_stride;
  return l;
}

size_t smem_bytes(int K, int TQ, int N, bool backward) {
  return sizeof(float) * make_layout(K, TQ, N, backward).total + 1024;
}

// ---------------------------------------------------------------- PTX --

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

// x = hi + lo: hi exact in TF32, lo = x - hi exact in f32; the tensor
// core reads lo's top 19 bits, which hold it to 2^-10 of itself.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// D (16x8) += A (16x8, row) . B (8x8, col), TF32 in, f32 accumulate.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct FragA {
  uint32_t h[4], l[4];
};

__device__ __forceinline__ FragA split_a(float x0, float x1, float x2,
                                         float x3) {
  FragA f;
  split(x0, f.h[0], f.l[0]);
  split(x1, f.h[1], f.l[1]);
  split(x2, f.h[2], f.l[2]);
  split(x3, f.h[3], f.l[3]);
  return f;
}

// 3xTF32 product on mma.sync, small terms first; B split beforehand.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     uint32_t bh0, uint32_t bh1,
                                     uint32_t bl0, uint32_t bl1) {
  mma(d, a.l, bh0, bh1);
  mma(d, a.h, bl0, bl1);
  mma(d, a.h, bh0, bh1);
}

// wgmma shared-memory descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t saddr) {
  uint64_t d = (uint64_t)((saddr & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;             // leading offset: unused when swizzled
  d |= (uint64_t)(1024 >> 4) << 32;   // stride offset
  d |= (uint64_t)1 << 62;             // SWIZZLE_128B
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x TQ, per warpgroup) += A (64 x 8, registers) . B^T, B (TQ x 8)
// K-major in shared memory.
template <int TQ>
__device__ __forceinline__ void wgmma_rs(float (&d)[TQ / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc);

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;"
      "\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// ------------------------------------------------------------ layouts --

__device__ __forceinline__ float sigmoid(float x) {
  return __frcp_rn(1.f + __expf(-x));
}

// Offset (floats) of feature (q, c) in a TQ x K tile laid out for wgmma:
// K/32 slabs of TQ rows x 128 bytes; the 16-byte chunk (c % 32) / 4 of
// row q sits at chunk position ((c % 32) / 4) ^ (q % 8).
template <int TQ>
__device__ __forceinline__ int swz(int q, int c) {
  return (c >> 5) * (TQ * 32) + q * 32 + ((((c >> 2) & 7) ^ (q & 7)) << 2) +
         (c & 3);
}

// Offset (floats) of element (row p, column c) of a 128-row matrix with
// KS = cols / 8 k-steps, stored in mma A-fragment order: per warp (16
// rows) and k-step, lane (g, t) = (p % 8, c % 4) holds 16 bytes
// {(g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)}.
__device__ __forceinline__ int frag_pos(int p, int c, int KS) {
  return (((p >> 4) * KS + (c >> 3)) * 32 + (p & 7) * 4 + (c & 3)) * 4 +
         ((p >> 3) & 1) + 2 * ((c >> 2) & 1);
}

struct Ctx {
  float* smem;
  Layout l;
  int warp, lane, g, t;
};

// Once per image: the kernel rows in fragment order, zero past P.
template <int K>
__device__ void stage_slots(const Args& a, int b, const Ctx& c) {
  const float* kb = a.kernels + (size_t)b * a.P * K;
  float* ks = c.smem + c.l.ks;
  for (int i = threadIdx.x; i < kMaxP * (K / 4); i += kThreads) {
    const int p = i / (K / 4);
    const int k4 = 4 * (i - p * (K / 4));
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p < a.P)
      v = __ldg(reinterpret_cast<const float4*>(kb + (size_t)p * K + k4));
    ks[frag_pos(p, k4 + 0, K / 8)] = v.x;
    ks[frag_pos(p, k4 + 1, K / 8)] = v.y;
    ks[frag_pos(p, k4 + 2, K / 8)] = v.z;
    ks[frag_pos(p, k4 + 3, K / 8)] = v.w;
  }
}

// The next item's feature rows (swizzled), target rows and lava row.
template <int K, int TQ>
__device__ void prefetch(const Args& a, int b, int q0, int stage,
                         const Ctx& c) {
  float* fs = c.smem + (stage ? c.l.feat1 : c.l.feat0);
  const float* fb = a.feat + (size_t)b * a.HW * K;
  for (int i = threadIdx.x; i < TQ * (K / 4); i += kThreads) {
    const int q = i / (K / 4);
    const int k4 = 4 * (i - q * (K / 4));
    const bool valid = q0 + q < a.HW;
    cp_async16(fs + swz<TQ>(q, k4),
               valid ? fb + (size_t)(q0 + q) * K + k4 : fb, valid);
  }
  float* ts = c.smem + (stage ? c.l.ts1 : c.l.ts0);
  const float* tb = a.targets + (size_t)b * a.ldn * a.HW;
  const float* gb = a.grad + (size_t)b * a.HW;
  for (int i = threadIdx.x; i < (a.N + 1) * TQ; i += kThreads) {
    const int n = i / TQ;
    const int q = i - n * TQ;
    const bool valid = q0 + q < a.HW;
    const float* src = n < a.N ? tb + (size_t)n * a.HW : gb;
    cp_async4(ts + n * c.l.ts_stride + q, valid ? src + q0 + q : gb, valid);
  }
}

__device__ __forceinline__ void split4(float* hi, float* lo) {
  const float4 x = *reinterpret_cast<float4*>(hi);
  uint32_t h[4], l[4];
  split(x.x, h[0], l[0]);
  split(x.y, h[1], l[1]);
  split(x.z, h[2], l[2]);
  split(x.w, h[3], l[3]);
  *reinterpret_cast<uint4*>(hi) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(lo) = make_uint4(l[0], l[1], l[2], l[3]);
}

// The landed feature and target tiles: hi in place, lo to their own
// buffers (once per block, not once per warp), then make the
// generic-proxy writes visible to wgmma.
template <int K, int TQ>
__device__ void split_tile(int stage, const Ctx& c) {
  float* fs = c.smem + (stage ? c.l.feat1 : c.l.feat0);
  float* lo = c.smem + c.l.lo;
  for (int i = 4 * threadIdx.x; i < TQ * K; i += 4 * kThreads)
    split4(fs + i, lo + i);
  float* ts = c.smem + (stage ? c.l.ts1 : c.l.ts0);
  float* tl = c.smem + c.l.ts_lo;
  for (int i = threadIdx.x; i < c.l.np * (TQ / 4); i += kThreads) {
    const int o = (i / (TQ / 4)) * c.l.ts_stride + 4 * (i % (TQ / 4));
    split4(ts + o, tl + o);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// acc (this warp's 16 rows x N, wgmma accumulator layout) += A . B^T over
// KSTEPS k-steps of 8, 3xTF32 on wgmma: A (64 rows a warpgroup) from
// registers, loaded and split by load_a(k) CH k-steps at a time, each
// chunk waited for before its registers are reused; B (N rows, K-major)
// from the hi and lo buffers, laid out as swz<N>. Accumulator layout:
// acc[4 j + e] is row g + 8 (e >> 1), column 8 j + 2 t + (e & 1).
template <int KSTEPS, int N, int CH, typename LoadA>
__device__ void wg_product(float (&acc)[N / 2], LoadA load_a, uint32_t hi,
                           uint32_t lo) {
  static_assert(KSTEPS % CH == 0, "whole chunks of k-steps");
#pragma unroll
  for (int c0 = 0; c0 < KSTEPS; c0 += CH) {
    FragA f[CH];
#pragma unroll
    for (int j = 0; j < CH; ++j) f[j] = load_a(c0 + j);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int ks = c0 + j;
      const uint32_t off = (ks >> 2) * (N * 128) + (ks & 3) * 32;
      const uint64_t dh = wgmma_desc(hi + off);
      const uint64_t dl = wgmma_desc(lo + off);
      wgmma_rs<N>(acc, f[j].l, dh);
      wgmma_rs<N>(acc, f[j].h, dl);
      wgmma_rs<N>(acc, f[j].h, dh);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_acc(acc);
  }
}

// S (this warp's 16 slots x TQ pixels) = kernel rows . feature tile^T; A
// from the kernel rows in fragment order, one 16-byte load a k-step.
template <int K, int TQ, int CH>
__device__ void logits(int stage, const Ctx& c, float (&s)[TQ / 2]) {
  const float4* ka =
      reinterpret_cast<const float4*>(c.smem + c.l.ks) +
      c.warp * (K / 8) * 32;
#pragma unroll
  for (int i = 0; i < TQ / 2; ++i) s[i] = 0.f;
  wg_product<K / 8, TQ, CH>(
      s,
      [&](int k) {
        const float4 v = ka[k * 32 + c.lane];
        return split_a(v.x, v.y, v.z, v.w);
      },
      smem_addr(c.smem + (stage ? c.l.feat1 : c.l.feat0)),
      smem_addr(c.smem + c.l.lo));
}

// Contiguous share of the B * ntiles items for this block.
__device__ __forceinline__ void item_range(int total, int& beg, int& end) {
  beg = (int)(((long long)total * blockIdx.x) / gridDim.x);
  end = (int)(((long long)total * (blockIdx.x + 1)) / gridDim.x);
}

__device__ Ctx make_ctx(float* raw, int K, int TQ, int N, bool backward) {
  Ctx c;
  const uint32_t base = smem_addr(raw);
  c.smem = raw + ((1024 - (base & 1023)) & 1023) / 4;
  c.l = make_layout(K, TQ, N, backward);
  c.warp = threadIdx.x / 32;
  c.lane = threadIdx.x % 32;
  c.g = c.lane / 4;
  c.t = c.lane % 4;
  return c;
}

// Rows N + 1 .. NP - 1 of both target stages stay zero.
__device__ void zero_pad_rows(const Args& a, const Ctx& c) {
  for (int i = threadIdx.x; i < (c.l.np - a.N - 1) * c.l.ts_stride;
       i += kThreads) {
    c.smem[c.l.ts0 + (a.N + 1) * c.l.ts_stride + i] = 0.f;
    c.smem[c.l.ts1 + (a.N + 1) * c.l.ts_stride + i] = 0.f;
  }
}

// ------------------------------------------------------------ forward --

template <int K, bool DET>
__global__ void __launch_bounds__(kThreads, 1)
    dice_lava_fwd_kernel(Args a, float* __restrict__ out_a,
                         float* __restrict__ out_b,
                         float* __restrict__ out_l) {
  constexpr int TQ = Tile<K, false>::TQ;
  constexpr int CH = K / 8 < 8 ? K / 8 : 8;
  extern __shared__ float smem_raw[];
  const Ctx c = make_ctx(smem_raw, K, TQ, a.N, false);
  const int ntiles = (a.HW + TQ - 1) / TQ;
  int beg, end;
  item_range(a.B * ntiles, beg, end);
  if (beg >= end) return;
  const int nbn = c.l.np / 8;
  const int img0 = beg / ntiles;   // the first image of this block's items
  zero_pad_rows(a, c);

  float cacc[kMaxNB][4];
  float sb[2] = {0.f, 0.f};
#pragma unroll
  for (int nb = 0; nb < kMaxNB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) cacc[nb][e] = 0.f;

  // a[p] = sum_n onehot[p, n] C[p, n], lava[p] = C[p, N], b[p]: reduce
  // over the 4 lanes of a row, one atomic per slot and quantity.
  auto flush = [&](int b) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = 16 * c.warp + c.g + 8 * h;
      float va = 0.f, vl = 0.f;
#pragma unroll
      for (int nb = 0; nb < kMaxNB; ++nb) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = 8 * nb + 2 * c.t + e;
          const float v = cacc[nb][2 * h + e];
          if (n < a.N && p < a.P)
            va = fmaf(__ldg(a.onehot + ((size_t)b * a.P + p) * a.ldn + n),
                      v, va);
          else if (n == a.N)
            vl += v;
        }
      }
      float vb = sb[h];
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        va += __shfl_xor_sync(0xffffffffu, va, o);
        vb += __shfl_xor_sync(0xffffffffu, vb, o);
        vl += __shfl_xor_sync(0xffffffffu, vl, o);
      }
      if (c.t == 0 && p < a.P) {
        if constexpr (DET) {
          float* w = a.ws + ((size_t)blockIdx.x * a.ipb + (b - img0)) * 3 *
                                a.P + p;
          w[0] = va;
          if (a.lead) {
            w[a.P] = vb;
            w[2 * a.P] = vl;
          }
        } else {
          atomicAdd(out_a + (size_t)b * a.P + p, va);
          if (a.lead) {
            atomicAdd(out_b + (size_t)b * a.P + p, vb);
            atomicAdd(out_l + (size_t)b * a.P + p, vl);
          }
        }
      }
      sb[h] = 0.f;
    }
#pragma unroll
    for (int nb = 0; nb < kMaxNB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) cacc[nb][e] = 0.f;
  };

  prefetch<K, TQ>(a, beg / ntiles, (beg % ntiles) * TQ, 0, c);
  cp_async_commit();
  int cur = -1;
  for (int it = beg; it < end; ++it) {
    const int stage = (it - beg) & 1;
    const int b = it / ntiles;
    const int q0 = (it - b * ntiles) * TQ;
    // One barrier: this tile has landed, and every thread is done with
    // the last one, so its stage may take the next tile and the slot rows
    // may change.
    cp_async_wait_all();
    __syncthreads();
    if (b != cur) {
      if (cur >= 0) flush(cur);
      stage_slots<K>(a, b, c);
      cur = b;
    }
    if (it + 1 < end) {
      prefetch<K, TQ>(a, (it + 1) / ntiles, ((it + 1) % ntiles) * TQ,
                      stage ^ 1, c);
      cp_async_commit();
    }
    split_tile<K, TQ>(stage, c);
    __syncthreads();

    float s[TQ / 2];
    logits<K, TQ, CH>(stage, c, s);
    const int qn = a.HW - q0;   // valid pixels of this tile
#pragma unroll
    for (int j = 0; j < TQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = 8 * j + 2 * c.t + (e & 1);
        const float v = q < qn ? sigmoid(s[4 * j + e]) : 0.f;
        s[4 * j + e] = v;
        sb[e >> 1] = fmaf(v, v, sb[e >> 1]);
      }
    // C += s . [targets; g]^T over the tile's pixels, in the permuted
    // pixel order (logical k = t is pixel 2t, k = t + 4 is pixel 2t + 1).
    // The tile's part is formed in its own accumulator and added to C in
    // f32: the tensor cores' accumulation drifts over thousands of small
    // positive increments (lava came to 0.8 of its allowance when C was
    // their accumulator across all of a block's tiles).
    const float* ts = c.smem + (stage ? c.l.ts1 : c.l.ts0);
    const float* tl = c.smem + c.l.ts_lo;
    float part[kMaxNB][4];
#pragma unroll
    for (int nb = 0; nb < kMaxNB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[nb][e] = 0.f;
#pragma unroll
    for (int j = 0; j < TQ / 8; ++j) {
      const FragA f = split_a(s[4 * j], s[4 * j + 2], s[4 * j + 1],
                              s[4 * j + 3]);
#pragma unroll
      for (int nb = 0; nb < kMaxNB; ++nb) {
        if (nb < nbn) {
          const int o = (8 * nb + c.g) * c.l.ts_stride + 8 * j + 2 * c.t;
          const uint2 h = *reinterpret_cast<const uint2*>(ts + o);
          const uint2 l = *reinterpret_cast<const uint2*>(tl + o);
          mma3(part[nb], f, h.x, h.y, l.x, l.y);
        }
      }
    }
#pragma unroll
    for (int nb = 0; nb < kMaxNB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) cacc[nb][e] += part[nb][e];
  }
  flush(cur);
}

// ----------------------------------------------------------- backward --

// Offset (floats) of dl (slot p, pixel q) in the dl tile.
template <int TQ>
__device__ __forceinline__ int dl_off(int p, int q) {
  if constexpr (TQ == 32)
    return swz<kMaxP>(p, q);
  else
    return p * TQ + q;
}

// A point ptxas does not schedule across: one thread's branch to read the
// clock (a plain compiler barrier, __syncwarp or a clock read by every
// thread does not do it). The K = 256 backward keeps 128 dk accumulators
// a thread in registers; with these points around its dk, dm and flush
// phases ptxas stops interleaving those phases, which spilled ~1 KB a
// thread and cost over a quarter of its time (2.21 -> 1.60 ms a launch at
// B=8, P=128, N=32, HW=25600 on an H100 SXM).
__device__ __forceinline__ void phase_fence() {
  if (threadIdx.x == 0) {
    uint64_t t;
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(t));
    asm volatile("" ::"l"(t));
  }
}

__device__ __forceinline__ void keep(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

template <int K, bool DET>
__global__ void __launch_bounds__(kThreads, 1)
    dice_lava_bwd_kernel(Args a, const float* __restrict__ ga,
                         const float* __restrict__ gb,
                         const float* __restrict__ gl,
                         float* __restrict__ dk, float* __restrict__ dm) {
  constexpr int TQ = Tile<K, true>::TQ;
  constexpr int KS = K / 8;
  constexpr int MB = TQ / 16;         // m16 blocks of the dm tile
  constexpr int NPW = (KS + 7) / 8;   // its n8 blocks per warp
  // At TQ = 32 (K = 32, 128) dk and dm run on wgmma, warpgroup w on
  // channels 64 w .. 64 w + 63: dk^T = feat_tile^T . dl^T (x all 128
  // slots) and dm^T = kernels^T . dl (x the tile's pixels), with B = the
  // split dl tile in both layouts, 128-byte swizzled rows. At K = 256
  // (TQ = 16) shared memory has no room for those, and both run on
  // mma.sync: dk with each warp on its 16 slots x K and A = dl from
  // registers, dm from the dl tile and the kernel rows.
  constexpr bool kWg = TQ == 32;
  constexpr int DKR = kWg ? 64 : 4 * KS;
  auto fence = [] {
    if constexpr (!kWg) phase_fence();
  };
  extern __shared__ float smem_raw[];
  const Ctx c = make_ctx(smem_raw, K, TQ, a.N, true);
  const int ntiles = (a.HW + TQ - 1) / TQ;
  int beg, end;
  item_range(a.B * ntiles, beg, end);
  if (beg >= end) return;
  zero_pad_rows(a, c);
  const int img0 = beg / ntiles;   // the first image of this block's items
  bool fresh = true;   // DET: the image's slot has not been stored yet
  const int nk = c.l.nk;
  const int row0 = 16 * c.warp + c.g;    // this thread's slots: row0, row0 + 8
  // kWg: this thread's channels of dk^T, ch0 and ch0 + 8 (at K = 32
  // the second warpgroup's are all past K: it multiplies zero rows, which
  // keeps wgmma out of divergent code).
  const int ch0 = 16 * c.warp + c.g;

  float dka[DKR];
#pragma unroll
  for (int i = 0; i < DKR; ++i) dka[i] = 0.f;
  float cga[2], cgb[2], cgl[2];
  // This thread's one-hot fragments of the image (A of the t product):
  // [k-step][a0..a3], zero past P and N, loaded once per image.
  float ohf[kMaxNB][4];

  // DET: this block's slot for image b (P x K), stored at the image's
  // first flush and added to at the later ones.
  auto slot = [&](int b) {
    return a.ws + ((size_t)blockIdx.x * a.ipb + (b - img0)) * a.P * K;
  };
  auto flush = [&](int b) {
    if constexpr (kWg) {
      // dka[4 j + e]: channel ch0 + 8 (e >> 1), slot 8 j + 2 t + (e & 1).
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ch = ch0 + 8 * (e >> 1);
          const int p = 8 * j + 2 * c.t + (e & 1);
          if (ch < K && p < a.P) {
            if constexpr (DET) {
              float* w = slot(b) + (size_t)p * K + ch;
              *w = fresh ? dka[4 * j + e] : *w + dka[4 * j + e];
            } else {
              atomicAdd(dk + ((size_t)b * a.P + p) * K + ch, dka[4 * j + e]);
            }
          }
        }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = row0 + 8 * h;
        if (p < a.P) {
          float* row = DET ? slot(b) + (size_t)p * K
                           : dk + ((size_t)b * a.P + p) * K;
#pragma unroll
          for (int nb = 0; nb < KS; ++nb) {
            float2* d = reinterpret_cast<float2*>(row + 8 * nb + 2 * c.t);
            const float2 v = make_float2(dka[4 * nb + 2 * h],
                                         dka[4 * nb + 2 * h + 1]);
            if constexpr (DET) {
              if (fresh) {
                *d = v;
              } else {
                const float2 o = *d;
                *d = make_float2(o.x + v.x, o.y + v.y);
              }
            } else {
              atomicAdd(d, v);
            }
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < DKR; ++i) dka[i] = 0.f;
    fresh = false;
  };

  prefetch<K, TQ>(a, beg / ntiles, (beg % ntiles) * TQ, 0, c);
  cp_async_commit();
  int cur = -1;
  for (int it = beg; it < end; ++it) {
    const int stage = (it - beg) & 1;
    const int b = it / ntiles;
    const int q0 = (it - b * ntiles) * TQ;
    cp_async_wait_all();
    __syncthreads();   // as in the forward
    if (b != cur) {
      if (cur >= 0) flush(cur);
      fresh = true;
      stage_slots<K>(a, b, c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = row0 + 8 * h;
        const size_t o = (size_t)b * a.P + p;
        cga[h] = p < a.P ? ga[o] : 0.f;
        cgb[h] = p < a.P && a.lead ? gb[o] : 0.f;
        cgl[h] = p < a.P && a.lead ? gl[o] : 0.f;
      }
      const float* oh0 = a.onehot + ((size_t)b * a.P + row0) * a.ldn;
#pragma unroll
      for (int kk = 0; kk < kMaxNB; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int p = row0 + 8 * (r & 1);
          const int n = 8 * kk + c.t + 4 * (r >> 1);
          ohf[kk][r] = p < a.P && n < a.N
                           ? __ldg(oh0 + 8 * (r & 1) * a.ldn + n) : 0.f;
        }
      cur = b;
    }
    if (it + 1 < end) {
      prefetch<K, TQ>(a, (it + 1) / ntiles, ((it + 1) % ntiles) * TQ,
                      stage ^ 1, c);
      cp_async_commit();
    }
    split_tile<K, TQ>(stage, c);
    __syncthreads();

    float s[TQ / 2];
    logits<K, TQ, 4>(stage, c, s);

    // t = onehot . targets_tile (k = instances), same layout as s.
    const float* ts = c.smem + (stage ? c.l.ts1 : c.l.ts0);
    const float* tl = c.smem + c.l.ts_lo;
    float tacc[TQ / 8][4];
#pragma unroll
    for (int j = 0; j < TQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) tacc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kMaxNB; ++kk) {
      if (kk >= nk) break;
      const FragA f = split_a(ohf[kk][0], ohf[kk][1], ohf[kk][2], ohf[kk][3]);
      const int o0 = (8 * kk + c.t) * c.l.ts_stride + c.g;
      const int o1 = o0 + 4 * c.l.ts_stride;
#pragma unroll
      for (int j = 0; j < TQ / 8; ++j)
        mma3(tacc[j], f, __float_as_uint(ts[o0 + 8 * j]),
                 __float_as_uint(ts[o1 + 8 * j]),
                 __float_as_uint(tl[o0 + 8 * j]),
                 __float_as_uint(tl[o1 + 8 * j]));
    }

    // dl in registers (masked past HW), and split into the dl tile.
    const int qn = a.HW - q0;
    const float* gh = ts + a.N * c.l.ts_stride;   // g = hi + lo, exactly
    const float* glo = tl + a.N * c.l.ts_stride;
    float* dlh = c.smem + c.l.dl_hi;
    float* dll = c.smem + c.l.dl_lo;
#pragma unroll
    for (int j = 0; j < TQ / 8; ++j) {
      const int q = 8 * j + 2 * c.t;
      const float2 gq0 = *reinterpret_cast<const float2*>(gh + q);
      const float2 gq1 = *reinterpret_cast<const float2*>(glo + q);
      const float2 gq = make_float2(gq0.x + gq1.x, gq0.y + gq1.y);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float pix = q + (e & 1) < qn ? 1.f : 0.f;
        const float raw = sigmoid(s[4 * j + e]);
        const float v = raw * pix;
        const float ds = cga[h] * tacc[j][e] + 2.f * cgb[h] * v +
                         cgl[h] * ((e & 1) ? gq.y : gq.x);
        s[4 * j + e] = ds * raw * (1.f - raw) * pix;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t h0, l0, h1, l1;
        split(s[4 * j + 2 * h], h0, l0);
        split(s[4 * j + 2 * h + 1], h1, l1);
        const int p = row0 + 8 * h;
        const int o = dl_off<TQ>(p, q);
        *reinterpret_cast<uint2*>(dlh + o) = make_uint2(h0, h1);
        *reinterpret_cast<uint2*>(dll + o) = make_uint2(l0, l1);
        if constexpr (kWg) {
          float* th = c.smem + c.l.dlt_hi;
          float* tlo = c.smem + c.l.dlt_lo;
          th[swz<TQ>(q, p)] = __uint_as_float(h0);
          th[swz<TQ>(q + 1, p)] = __uint_as_float(h1);
          tlo[swz<TQ>(q, p)] = __uint_as_float(l0);
          tlo[swz<TQ>(q + 1, p)] = __uint_as_float(l1);
        }
      }
    }

    fence();
    const float* fh = c.smem + (stage ? c.l.feat1 : c.l.feat0);
    const float* fl = c.smem + c.l.lo;
    if constexpr (!kWg) {
      // dk += dl . feat_tile (k = pixels in the permuted order of the
      // forward; B is the split feature tile).
#pragma unroll
      for (int j = 0; j < TQ / 8; ++j) {
        const FragA f = split_a(s[4 * j], s[4 * j + 2], s[4 * j + 1],
                                s[4 * j + 3]);
        const int q = 8 * j + 2 * c.t;
#pragma unroll
        for (int nb = 0; nb < KS; ++nb) {
          const int o0 = swz<TQ>(q, 8 * nb + c.g);
          const int o1 = swz<TQ>(q + 1, 8 * nb + c.g);
          float(&acc)[4] = *reinterpret_cast<float(*)[4]>(dka + 4 * nb);
          mma3(acc, f, __float_as_uint(fh[o0]), __float_as_uint(fh[o1]),
                   __float_as_uint(fl[o0]), __float_as_uint(fl[o1]));
        }
      }
    }
    fence();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();   // the dl tiles are complete
    fence();

    if constexpr (kWg) {
      // dk^T (channels x slots) += feat_tile^T . dl^T: A (channels x
      // pixels) loaded by hand from the split feature tile, B = the dl
      // tile (pixels contiguous). Issued, then left running under dm.
      FragA fk[TQ / 8];
#pragma unroll
      for (int j = 0; j < TQ / 8; ++j) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int q = 8 * j + c.t + 4 * (r >> 1);
          const int ch = ch0 + 8 * (r & 1);
          const int o = swz<TQ>(q, ch < K ? ch : 0);
          fk[j].h[r] = ch < K ? __float_as_uint(fh[o]) : 0u;
          fk[j].l[r] = ch < K ? __float_as_uint(fl[o]) : 0u;
        }
      }
      float(&acc)[64] = *reinterpret_cast<float(*)[64]>(dka);
      fence_acc(acc);
      wgmma_fence();
      const uint32_t bh = smem_addr(dlh), bl = smem_addr(dll);
#pragma unroll
      for (int j = 0; j < TQ / 8; ++j) {
        const uint64_t dh = wgmma_desc(bh + 32 * j);
        const uint64_t dlo = wgmma_desc(bl + 32 * j);
        wgmma_rs<128>(acc, fk[j].l, dh);
        wgmma_rs<128>(acc, fk[j].h, dlo);
        wgmma_rs<128>(acc, fk[j].h, dh);
      }
      wgmma_commit();

      // dm^T (channels x pixels) = kernels^T . dl (k = slots): A gathered
      // from the kernel rows in fragment order (slots 8 k + t and + 4 of
      // one channel sit 64 floats apart, channels ch0 and ch0 + 8 128
      // apart) and split; B = the dl^T tile (slots contiguous). Its first
      // wait also retires dk.
      float dmt[TQ / 2];
#pragma unroll
      for (int i = 0; i < TQ / 2; ++i) dmt[i] = 0.f;
      const float* ks = c.smem + c.l.ks;
      const bool va = ch0 < K, vb = ch0 + 8 < K;
      const int oa = frag_pos(c.t, va ? ch0 : 0, KS);
      const int ob = frag_pos(c.t, vb ? ch0 + 8 : 0, KS);
      wg_product<kMaxP / 8, TQ, 4>(
          dmt,
          [&](int k) {
            const int o = (k >> 1) * KS * 128 + (k & 1);
            return split_a(va ? ks[oa + o] : 0.f, vb ? ks[ob + o] : 0.f,
                           va ? ks[oa + o + 64] : 0.f,
                           vb ? ks[ob + o + 64] : 0.f);
          },
          smem_addr(c.smem + c.l.dlt_hi), smem_addr(c.smem + c.l.dlt_lo));
      fence_acc(acc);
#pragma unroll
      for (int j = 0; j < TQ / 8; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          keep(fk[j].h[r]);
          keep(fk[j].l[r]);
        }

      // dm^T through the feature lo buffer (free once every warp has its
      // dk fragments), rows of K floats with 16-byte groups XOR-swizzled
      // by the row, so that both the scattered writes and the row reads
      // are free of bank conflicts; then coalesced 16-byte stores of the
      // tile's dm rows.
      __syncthreads();
      float* stg = c.smem + c.l.lo;
#pragma unroll
      for (int j = 0; j < TQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ch = ch0 + 8 * (e >> 1);
          const int q = 8 * j + 2 * c.t + (e & 1);
          if (ch < K) stg[q * K + (ch ^ (4 * (q & 7)))] = dmt[4 * j + e];
        }
      __syncthreads();
      for (int i = threadIdx.x; i < TQ * (K / 4); i += kThreads) {
        const int q = i / (K / 4);
        const int c4 = 4 * (i - q * (K / 4));
        if (q < qn) {
          float4* d = reinterpret_cast<float4*>(
              dm + ((size_t)b * a.HW + q0 + q) * K + c4);
          float4 v = *reinterpret_cast<const float4*>(stg + q * K +
                                                      (c4 ^ (4 * (q & 7))));
          if (!a.lead) {
            const float4 w = *d;
            v = make_float4(v.x + w.x, v.y + w.y, v.z + w.z, v.w + w.w);
          }
          *d = v;
        }
      }
    } else {
      // dm_tile (TQ x K) = dl^T . kernels (k = slots): warp w takes the n8
      // blocks w, w + 8, ... and every m16 block, so each A fragment (the
      // split dl tile) and each B fragment (kernel rows, split here) is
      // loaded once per warp and k-step. In fragment order, kernel rows
      // 8 kk + t and 8 kk + t + 4 of channel 8 nb + g sit 64 floats apart.
      float dma[MB][NPW][4];
#pragma unroll
      for (int m = 0; m < MB; ++m)
#pragma unroll
        for (int i = 0; i < NPW; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) dma[m][i][e] = 0.f;
      const float* kb = c.smem + c.l.ks + (c.t * 4 + (c.g & 3)) * 4 +
                        2 * (c.g >> 2) + c.warp * 128;
#pragma unroll 4
      for (int kk = 0; kk < kMaxP / 8; ++kk) {
        FragA fa[MB];
#pragma unroll
        for (int m = 0; m < MB; ++m) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int o = dl_off<TQ>(8 * kk + c.t + 4 * (r >> 1),
                                     16 * m + c.g + 8 * (r & 1));
            fa[m].h[r] = __float_as_uint(dlh[o]);
            fa[m].l[r] = __float_as_uint(dll[o]);
          }
        }
        const float* kr = kb + (kk >> 1) * KS * 128 + (kk & 1);
#pragma unroll
        for (int i = 0; i < NPW; ++i) {
          if (c.warp + 8 * i < KS) {
            const float* kp = kr + i * 8 * 128;
            uint32_t bh0, bl0, bh1, bl1;
            split(kp[0], bh0, bl0);
            split(kp[64], bh1, bl1);
#pragma unroll
            for (int m = 0; m < MB; ++m)
              mma3(dma[m][i], fa[m], bh0, bh1, bl0, bl1);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < NPW; ++i) {
        const int nb = c.warp + 8 * i;
        if (nb >= KS) continue;
#pragma unroll
        for (int m = 0; m < MB; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int q = 16 * m + c.g + 8 * h;
            if (q < qn) {
              float2* d = reinterpret_cast<float2*>(
                  dm + ((size_t)b * a.HW + q0 + q) * K + 8 * nb + 2 * c.t);
              float2 v = make_float2(dma[m][i][2 * h], dma[m][i][2 * h + 1]);
              if (!a.lead) {
                const float2 w = *d;
                v = make_float2(v.x + w.x, v.y + w.y);
              }
              *d = v;
            }
          }
      }
    }
    fence();
    if ((it - beg) % kDkTiles == kDkTiles - 1) flush(cur);
    fence();
  }
  flush(cur);
}

// --------------------------------------------------------------- host --

template <typename Kernel>
int prepare(Kernel kernel, size_t bytes, int sms, int items, int& grid) {
  if (bytes > 48 * 1024) {
    if (cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(bytes)))
      return static_cast<int>(e);
  }
  int per_sm = 0;
  if (cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, kThreads, bytes))
    return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  grid = sms * per_sm < items ? sms * per_sm : items;
  return 0;
}

// The deterministic variants' second pass: out_s[b, i] += the sum, over
// the blocks in order whose items meet image b, of their slot's element
// (s, i) (slots of `stride` floats, ipb a block; see the header).
__global__ void __launch_bounds__(256)
    det_reduce_kernel(const float* __restrict__ ws, float* out0,
                      float* out1, float* out2, int nout, int len,
                      int stride, int B, int ntiles, int items, int grid,
                      int ipb) {
  extern __shared__ int s_img[];   // each block's first and last image
  for (int blk = threadIdx.x; blk < grid; blk += blockDim.x) {
    const int beg = (int)(((long long)items * blk) / grid);
    const int end = (int)(((long long)items * (blk + 1)) / grid);
    s_img[2 * blk] = beg < end ? beg / ntiles : 1;
    s_img[2 * blk + 1] = beg < end ? (end - 1) / ntiles : 0;
  }
  __syncthreads();
  const long long total = (long long)B * nout * len;
  for (long long idx = blockIdx.x * 256LL + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * 256) {
    const int i = (int)(idx % len);
    const int t = (int)(idx / len);
    const int o = t % nout, b = t / nout;
    float acc = 0.f;
    for (int blk = 0; blk < grid; ++blk) {
      const int first = s_img[2 * blk], last = s_img[2 * blk + 1];
      if (b < first || b > last) continue;
      acc += ws[((size_t)blk * ipb + (b - first)) * stride +
                (size_t)o * len + i];
    }
    float* out = o == 0 ? out0 : (o == 1 ? out1 : out2);
    out[(size_t)b * len + i] += acc;
  }
}

// The persistent grid of one launch and, for a deterministic variant, its
// tiles an image and the most images a block meets.
template <int K, bool BWD, bool DET>
int geometry(const Args& a, int sms, int& grid, int& ntiles, int& ipb) {
  constexpr int TQ = Tile<K, BWD>::TQ;
  const size_t bytes = smem_bytes(K, TQ, a.N, BWD);
  ntiles = (a.HW + TQ - 1) / TQ;
  const int items = a.B * ntiles;
  int err;
  if constexpr (BWD)
    err = prepare(dice_lava_bwd_kernel<K, DET>, bytes, sms, items, grid);
  else
    err = prepare(dice_lava_fwd_kernel<K, DET>, bytes, sms, items, grid);
  if (err) return err;
  const int longest = (items + grid - 1) / grid;
  ipb = (longest - 1) / ntiles + 2 < a.B ? (longest - 1) / ntiles + 2 : a.B;
  return 0;
}

// Floats of one launch's partials.
template <bool BWD>
long long det_floats(const Args& a, int K, int grid, int ipb) {
  return (long long)grid * ipb * a.P * (BWD ? K : 3);
}

int det_reduce(const Args& a, float* o0, float* o1, float* o2, int nout,
               int len, int stride, int ntiles, int grid, int ipb,
               cudaStream_t s) {
  const long long total = (long long)a.B * nout * len;
  const long long want = (total + 255) / 256;
  const int blocks = static_cast<int>(want < 132 * 8 ? want : 132 * 8);
  det_reduce_kernel<<<blocks, 256, 2 * grid * sizeof(int), s>>>(
      a.ws, o0, o1, o2, nout, len, stride, a.B, ntiles, a.B * ntiles, grid,
      ipb);
  return static_cast<int>(cudaGetLastError());
}

template <int K, bool DET>
int launch_fwd(const Args& a, float* out_a, float* out_b, float* out_l,
               int sms, cudaStream_t s) {
  constexpr int TQ = Tile<K, false>::TQ;
  const size_t bytes = smem_bytes(K, TQ, a.N, false);
  int grid = 0, ntiles = 0, ipb = 0;
  if (int err = geometry<K, false, DET>(a, sms, grid, ntiles, ipb))
    return err;
  Args d = a;
  d.ipb = ipb;
  if (DET && det_floats<false>(a, K, grid, ipb) > a.ws_cap)
    return static_cast<int>(cudaErrorInvalidValue);
  dice_lava_fwd_kernel<K, DET><<<grid, kThreads, bytes, s>>>(d, out_a, out_b,
                                                              out_l);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  if constexpr (DET)
    return det_reduce(d, out_a, out_b, out_l, a.lead ? 3 : 1, a.P, 3 * a.P,
                      ntiles, grid, ipb, s);
  return 0;
}

template <int K, bool DET>
int launch_bwd(const Args& a, const float* ga, const float* gb,
               const float* gl, float* dk, float* dm, int sms,
               cudaStream_t s) {
  constexpr int TQ = Tile<K, true>::TQ;
  const size_t bytes = smem_bytes(K, TQ, a.N, true);
  int grid = 0, ntiles = 0, ipb = 0;
  if (int err = geometry<K, true, DET>(a, sms, grid, ntiles, ipb))
    return err;
  Args d = a;
  d.ipb = ipb;
  if (DET && det_floats<true>(a, K, grid, ipb) > a.ws_cap)
    return static_cast<int>(cudaErrorInvalidValue);
  dice_lava_bwd_kernel<K, DET><<<grid, kThreads, bytes, s>>>(d, ga, gb, gl,
                                                              dk, dm);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  if constexpr (DET)
    return det_reduce(d, dk, nullptr, nullptr, 1, a.P * K, a.P * K, ntiles,
                      grid, ipb, s);
  return 0;
}

Args make_args(const void* kernels, const void* feat, const void* onehot,
               const void* targets, const void* grad, int B, int P, int N,
               int HW) {
  return Args{static_cast<const float*>(kernels),
              static_cast<const float*>(feat),
              static_cast<const float*>(onehot),
              static_cast<const float*>(targets),
              static_cast<const float*>(grad), B, P, N, HW, N, true,
              nullptr, 0, 0};
}

int chunks_of(int N) { return (N + kMaxN - 1) / kMaxN; }

// launch(chunk) for each chunk of a's instances: even chunks of at most
// kMaxN, the first one the lead (see the header). Stops at the first
// error.
template <typename Launch>
int per_chunk(const Args& a, Launch launch) {
  const int chunks = chunks_of(a.N);
  const int per = (a.N + chunks - 1) / chunks;
  for (int n0 = 0; n0 < a.N; n0 += per) {
    Args c = a;
    c.onehot = a.onehot + n0;
    c.targets = a.targets + (size_t)n0 * a.HW;
    c.N = a.N - n0 < per ? a.N - n0 : per;
    c.lead = n0 == 0;
    if (int err = launch(c)) return err;
  }
  return 0;
}

bool valid_shape(int B, int P, int K, int N, int HW) {
  return B > 0 && HW > 0 && P > 0 && P <= kMaxP && N >= 1 &&
         (K == 32 || K == 128 || K == 256);
}

template <bool DET>
int fwd_all(const Args& args, int K, float* oa, float* ob, float* ol,
            int sms, cudaStream_t s) {
  return per_chunk(args, [&](const Args& a) {
    switch (K) {
      case 32: return launch_fwd<32, DET>(a, oa, ob, ol, sms, s);
      case 128: return launch_fwd<128, DET>(a, oa, ob, ol, sms, s);
      default: return launch_fwd<256, DET>(a, oa, ob, ol, sms, s);
    }
  });
}

template <bool DET>
int bwd_all(const Args& args, int K, const float* pa, const float* pb,
            const float* pl, float* odk, float* odm, int sms,
            cudaStream_t s) {
  return per_chunk(args, [&](const Args& a) {
    switch (K) {
      case 32: return launch_bwd<32, DET>(a, pa, pb, pl, odk, odm, sms, s);
      case 128: return launch_bwd<128, DET>(a, pa, pb, pl, odk, odm, sms, s);
      default: return launch_bwd<256, DET>(a, pa, pb, pl, odk, odm, sms, s);
    }
  });
}

// The most floats any chunk's deterministic launch needs for its partials.
template <bool BWD>
long long det_workspace(const Args& args, int K, int sms) {
  long long need = 0;
  const int err = per_chunk(args, [&](const Args& a) {
    int grid = 0, ntiles = 0, ipb = 0, e;
    switch (K) {
      case 32: e = geometry<32, BWD, true>(a, sms, grid, ntiles, ipb); break;
      case 128: e = geometry<128, BWD, true>(a, sms, grid, ntiles, ipb); break;
      default: e = geometry<256, BWD, true>(a, sms, grid, ntiles, ipb);
    }
    if (e) return e;
    const long long n = det_floats<BWD>(a, K, grid, ipb);
    need = n > need ? n : need;
    return 0;
  });
  return err ? -err : need;
}

}  // namespace

extern "C" {

// Kernel launches of one call of any function below for N instances (the
// deterministic variants' reductions not counted).
int prn_dice_lava_launches(int N) { return N >= 1 ? chunks_of(N) : 0; }

// All tensors f32, contiguous, on one card, 16-byte aligned. P <= 128,
// K in {32, 128, 256} (the presets' kernel widths), any N >= 1 (one
// launch per chunk of at most 63 instances); the shared memory grows with
// K and the chunk's N, and a launch that asks for more than the card has
// fails. grid_x is the card's SM count: the grid is persistent, as many
// blocks as fit on those SMs at once. a, b, lava (B, P) must be zeroed.
// Returns the cudaError_t of the first launch that failed, else 0.
int prn_dice_lava_fwd(const void* kernels, const void* feat,
                      const void* onehot, const void* targets,
                      const void* grad, void* out_a, void* out_b,
                      void* out_l, int B, int P, int K, int N, int HW,
                      int grid_x, void* stream) {
  if (!valid_shape(B, P, K, N, HW))
    return static_cast<int>(cudaErrorInvalidValue);
  return fwd_all<false>(
      make_args(kernels, feat, onehot, targets, grad, B, P, N, HW), K,
      static_cast<float*>(out_a), static_cast<float*>(out_b),
      static_cast<float*>(out_l), grid_x, static_cast<cudaStream_t>(stream));
}

// ga, gb, gl (B, P); dk (B, P, K) zeroed; dm (B, HW, K) fully written.
int prn_dice_lava_bwd(const void* kernels, const void* feat,
                      const void* onehot, const void* targets,
                      const void* grad, const void* ga, const void* gb,
                      const void* gl, void* dk, void* dm, int B, int P, int K,
                      int N, int HW, int grid_x, void* stream) {
  if (!valid_shape(B, P, K, N, HW))
    return static_cast<int>(cudaErrorInvalidValue);
  return bwd_all<false>(
      make_args(kernels, feat, onehot, targets, grad, B, P, N, HW), K,
      static_cast<const float*>(ga), static_cast<const float*>(gb),
      static_cast<const float*>(gl), static_cast<float*>(dk),
      static_cast<float*>(dm), grid_x, static_cast<cudaStream_t>(stream));
}

// Floats of the partials that the deterministic variant of the forward
// (backward != 0: of the backward) needs at this shape, or minus the
// cudaError_t of a failed query.
long long prn_dice_lava_det_workspace(int B, int P, int K, int N, int HW,
                                      int grid_x, int backward) {
  if (!valid_shape(B, P, K, N, HW))
    return -static_cast<long long>(cudaErrorInvalidValue);
  const Args a = make_args(nullptr, nullptr, nullptr, nullptr, nullptr, B, P,
                           N, HW);
  return backward ? det_workspace<true>(a, K, grid_x)
                  : det_workspace<false>(a, K, grid_x);
}

// The deterministic variants: the arguments of prn_dice_lava_fwd and
// prn_dice_lava_bwd, and ws, 16-byte aligned, of ws_floats floats (at least
// what prn_dice_lava_det_workspace gives). The same outputs, summed in an
// order fixed by the shape and the card's SM count.
int prn_dice_lava_fwd_det(const void* kernels, const void* feat,
                          const void* onehot, const void* targets,
                          const void* grad, void* out_a, void* out_b,
                          void* out_l, void* ws, long long ws_floats, int B,
                          int P, int K, int N, int HW, int grid_x,
                          void* stream) {
  if (!valid_shape(B, P, K, N, HW))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(kernels, feat, onehot, targets, grad, B, P, N, HW);
  a.ws = static_cast<float*>(ws);
  a.ws_cap = ws_floats;
  return fwd_all<true>(a, K, static_cast<float*>(out_a),
                       static_cast<float*>(out_b), static_cast<float*>(out_l),
                       grid_x, static_cast<cudaStream_t>(stream));
}

int prn_dice_lava_bwd_det(const void* kernels, const void* feat,
                          const void* onehot, const void* targets,
                          const void* grad, const void* ga, const void* gb,
                          const void* gl, void* dk, void* dm, void* ws,
                          long long ws_floats, int B, int P, int K, int N,
                          int HW, int grid_x, void* stream) {
  if (!valid_shape(B, P, K, N, HW))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(kernels, feat, onehot, targets, grad, B, P, N, HW);
  a.ws = static_cast<float*>(ws);
  a.ws_cap = ws_floats;
  return bwd_all<true>(a, K, static_cast<const float*>(ga),
                       static_cast<const float*>(gb),
                       static_cast<const float*>(gl), static_cast<float*>(dk),
                       static_cast<float*>(dm), grid_x,
                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"
