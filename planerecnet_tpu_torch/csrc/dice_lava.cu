// Fused dynamic-conv + sigmoid + dice/lava loss reductions, forward and
// backward, for Hopper (sm_90a). Plain C interface, loaded with ctypes by
// planerecnet_tpu_torch/ops/dice_lava.py.
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
// N=32, HW=25600) the forward does ~8.4 GFLOP (the logits and the target
// rows) on ~140 MB of inputs, the backward ~22 GFLOP; both are far above
// the card's f32 balance point of ~20 flops per byte. So the products are
// f32 FMAs (no TF32: the sums must match f32 JAX) from shared memory,
// register-blocked as in an SGEMM.
//
// Design. A block of 256 threads owns one image and a strided set of
// 32-pixel tiles. It stages the image's kernel rows and one-hot rows (all
// P <= 128 slots) in shared memory once, and per tile the 32 feature rows
// and target columns; rows are padded by 4 floats so that float4 reads of
// neighbouring rows fall in different banks. Each thread forms a 4-slot x
// 4-pixel block of logits and target values, summing over k (and n) in
// order with 16 independent FMA chains and 8 float4 shared loads per 64
// FMAs. The sigmoid is zeroed on pixels past HW (sigmoid(0) = 0.5 would
// otherwise pollute b, dice_lava.py:63).
//   Forward: per-thread partial sums across the block's tiles, a
//   reduction over the 8 threads that share a slot, one f32 atomic per
//   slot and quantity per block.
//   Backward: the tile's dl (P x 32) goes to shared memory. dm for the
//   tile's pixels is written directly: a block owns all P slots of its
//   pixels, so dm needs no atomics. dk (P x K) accumulates in registers
//   across the block's tiles (4 slots x K/8 channels a thread) and is
//   added with float4 atomics once per block.
// The atomics make a, b, lava and dk vary in their last bits from run to
// run. Tensor cores (wgmma) are a later step.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTQ = 32;         // pixels per tile
constexpr int kMaxP = 128;      // slots: 32 groups of 4
constexpr int kDS = kTQ + 4;    // row stride of the dl tile

struct Args {
  const float* kernels;  // (B, P, K)
  const float* feat;     // (B, HW, K)
  const float* onehot;   // (B, P, N)
  const float* targets;  // (B, N, HW)
  const float* grad;     // (B, HW)
  int B, P, N, HW;
};

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ void atomic_add4(float* dst, float4 v) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  atomicAdd(reinterpret_cast<float4*>(dst), v);
#else
  atomicAdd(dst, v.x);
  atomicAdd(dst + 1, v.y);
  atomicAdd(dst + 2, v.z);
  atomicAdd(dst + 3, v.w);
#endif
}

__device__ __forceinline__ void fma4(float4& acc, float s, const float4& v) {
  acc.x = fmaf(s, v.x, acc.x);
  acc.y = fmaf(s, v.y, acc.y);
  acc.z = fmaf(s, v.z, acc.z);
  acc.w = fmaf(s, v.w, acc.w);
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// Shared memory, in floats: Ks[kMaxP][K+4] | Ms[kTQ][K+4] |
// Os[kMaxP][N4+4] | Ts[kTQ][N4+4] | Gs[kTQ] | (backward) D[kMaxP][kDS].
// Every part starts on a 16-byte boundary.
struct Smem {
  float *ks, *ms, *os, *ts, *gs, *d;
  int kstride, nstride;
};

__device__ Smem carve(float* smem, int K, int N) {
  Smem s;
  s.kstride = K + 4;
  s.nstride = round4(N) + 4;
  s.ks = smem;
  s.ms = s.ks + kMaxP * s.kstride;
  s.os = s.ms + kTQ * s.kstride;
  s.ts = s.os + kMaxP * s.nstride;
  s.gs = s.ts + kTQ * s.nstride;
  s.d = s.gs + kTQ;
  return s;
}

size_t smem_bytes(int K, int N, bool backward) {
  const size_t ks = K + 4, ns = round4(N) + 4;
  return sizeof(float) * ((kMaxP + kTQ) * ks + (kMaxP + kTQ) * ns + kTQ +
                          (backward ? (size_t)kMaxP * kDS : 0));
}

// Once per block: the image's kernel rows and one-hot rows, zero-padded
// to kMaxP slots and to the padded row widths.
template <int K>
__device__ void stage_slots(const Args& a, int b, const Smem& s) {
  const float* kb = a.kernels + (size_t)b * a.P * K;
  for (int i = threadIdx.x; i < kMaxP * (K / 4); i += kThreads) {
    const int p = i / (K / 4);
    const int v = i - p * (K / 4);
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p < a.P)
      val = __ldg(reinterpret_cast<const float4*>(kb + (size_t)p * K) + v);
    *reinterpret_cast<float4*>(s.ks + p * s.kstride + 4 * v) = val;
  }
  const float* ob = a.onehot + (size_t)b * a.P * a.N;
  for (int i = threadIdx.x; i < kMaxP * s.nstride; i += kThreads) {
    const int p = i / s.nstride;
    const int n = i - p * s.nstride;
    s.os[i] = (p < a.P && n < a.N) ? __ldg(ob + (size_t)p * a.N + n) : 0.f;
  }
}

// Per tile: feature rows Ms[q][k], target columns Ts[q][n], Gs[q]; zeros
// past HW and N.
template <int K>
__device__ void stage_tile(const Args& a, int b, int q0, const Smem& s) {
  const float* fb = a.feat + (size_t)b * a.HW * K;
  for (int i = threadIdx.x; i < kTQ * (K / 4); i += kThreads) {
    const int q = i / (K / 4);
    const int v = i - q * (K / 4);
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + q < a.HW)
      val = __ldg(reinterpret_cast<const float4*>(fb + (size_t)(q0 + q) * K) +
                  v);
    *reinterpret_cast<float4*>(s.ms + q * s.kstride + 4 * v) = val;
  }
  const float* tb = a.targets + (size_t)b * a.N * a.HW;
  for (int i = threadIdx.x; i < s.nstride * kTQ; i += kThreads) {
    const int n = i / kTQ;
    const int q = i - n * kTQ;  // consecutive threads read consecutive q
    s.ts[q * s.nstride + n] =
        (n < a.N && q0 + q < a.HW) ? __ldg(tb + (size_t)n * a.HW + q0 + q)
                                   : 0.f;
  }
  if (threadIdx.x < kTQ) {
    const int q = q0 + threadIdx.x;
    s.gs[threadIdx.x] = q < a.HW ? __ldg(a.grad + (size_t)b * a.HW + q) : 0.f;
  }
}

// Thread (sg, pg) = (tid / 8, tid % 8) owns slots 4 sg + i and pixels
// 4 pg + j of the tile: logits and target values, summed in k (n) order.
template <int K>
__device__ void block_logits(const Smem& s, float (&logit)[4][4],
                             float (&tgt)[4][4]) {
  const int sg = threadIdx.x / 8;
  const int pg = threadIdx.x % 8;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) logit[i][j] = tgt[i][j] = 0.f;
  const float* kr = s.ks + 4 * sg * s.kstride;
  const float* mr = s.ms + 4 * pg * s.kstride;
#pragma unroll 4
  for (int k = 0; k < K; k += 4) {
    float4 kv[4], mv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      kv[i] = *reinterpret_cast<const float4*>(kr + i * s.kstride + k);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      mv[j] = *reinterpret_cast<const float4*>(mr + j * s.kstride + k);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) logit[i][j] = dot4(kv[i], mv[j], logit[i][j]);
  }
  const float* orow = s.os + 4 * sg * s.nstride;
  const float* trow = s.ts + 4 * pg * s.nstride;
  for (int n = 0; n < s.nstride - 4; n += 4) {
    float4 ov[4], tv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      ov[i] = *reinterpret_cast<const float4*>(orow + i * s.nstride + n);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      tv[j] = *reinterpret_cast<const float4*>(trow + j * s.nstride + n);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) tgt[i][j] = dot4(ov[i], tv[j], tgt[i][j]);
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads, 2)
    dice_lava_fwd_kernel(Args a, float* __restrict__ out_a,
                         float* __restrict__ out_b,
                         float* __restrict__ out_l) {
  extern __shared__ __align__(16) float smem[];
  const Smem s = carve(smem, K, a.N);
  const int b = blockIdx.y;
  const int sg = threadIdx.x / 8;
  const int pg = threadIdx.x % 8;
  stage_slots<K>(a, b, s);
  float sa[4] = {0.f, 0.f, 0.f, 0.f}, sb[4] = {0.f, 0.f, 0.f, 0.f},
        sl[4] = {0.f, 0.f, 0.f, 0.f};
  const int ntiles = (a.HW + kTQ - 1) / kTQ;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int q0 = tile * kTQ;
    __syncthreads();  // the slot rows are staged; the last tile is read
    stage_tile<K>(a, b, q0, s);
    __syncthreads();
    float logit[4][4], tgt[4][4];
    block_logits<K>(s, logit, tgt);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = 4 * pg + j;
      const float pix = q0 + q < a.HW ? 1.f : 0.f;
      const float g = s.gs[q];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v = sigmoid(logit[i][j]) * pix;
        sa[i] = fmaf(v, tgt[i][j], sa[i]);
        sb[i] = fmaf(v, v, sb[i]);
        sl[i] = fmaf(v, g, sl[i]);
      }
    }
  }
  // The 8 threads of a slot group are neighbouring lanes of one warp.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) {
      sa[i] += __shfl_xor_sync(0xffffffffu, sa[i], o);
      sb[i] += __shfl_xor_sync(0xffffffffu, sb[i], o);
      sl[i] += __shfl_xor_sync(0xffffffffu, sl[i], o);
    }
    const int p = 4 * sg + i;
    if (pg == 0 && p < a.P) {
      atomicAdd(out_a + (size_t)b * a.P + p, sa[i]);
      atomicAdd(out_b + (size_t)b * a.P + p, sb[i]);
      atomicAdd(out_l + (size_t)b * a.P + p, sl[i]);
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
    dice_lava_bwd_kernel(Args a, const float* __restrict__ ga,
                         const float* __restrict__ gb,
                         const float* __restrict__ gl,
                         float* __restrict__ dk, float* __restrict__ dm) {
  constexpr int KV = K / 4;            // float4 vectors of a row
  constexpr int VPT = (KV + 7) / 8;    // dk vectors a thread owns
  extern __shared__ __align__(16) float smem[];
  const Smem s = carve(smem, K, a.N);
  const int b = blockIdx.y;
  const int sg = threadIdx.x / 8;
  const int pg = threadIdx.x % 8;
  stage_slots<K>(a, b, s);
  float cga[4], cgb[4], cgl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = 4 * sg + i;
    const size_t o = (size_t)b * a.P + p;
    cga[i] = p < a.P ? ga[o] : 0.f;
    cgb[i] = p < a.P ? gb[o] : 0.f;
    cgl[i] = p < a.P ? gl[o] : 0.f;
  }
  float4 dk_acc[4][VPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < VPT; ++j) dk_acc[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int ntiles = (a.HW + kTQ - 1) / kTQ;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int q0 = tile * kTQ;
    __syncthreads();
    stage_tile<K>(a, b, q0, s);
    __syncthreads();
    float logit[4][4], tgt[4][4];
    block_logits<K>(s, logit, tgt);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = 4 * pg + j;
      const float pix = q0 + q < a.HW ? 1.f : 0.f;
      const float g = s.gs[q];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float raw = sigmoid(logit[i][j]);
        const float v = raw * pix;
        const float ds = cga[i] * tgt[i][j] + 2.f * cgb[i] * v + cgl[i] * g;
        s.d[(4 * sg + i) * kDS + q] = ds * raw * (1.f - raw) * pix;
      }
    }
    __syncthreads();

    // dm: item = (pixel group qg, channel vector kv), kv fastest, so a
    // warp writes contiguous channels.
    for (int item = threadIdx.x; item < (kTQ / 4) * KV; item += kThreads) {
      const int kv = item % KV;
      const int qg = item / KV;
      float4 acc[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int p = 0; p < a.P; ++p) {
        const float4 k4 =
            *reinterpret_cast<const float4*>(s.ks + p * s.kstride + 4 * kv);
        const float4 d4 =
            *reinterpret_cast<const float4*>(s.d + p * kDS + 4 * qg);
        fma4(acc[0], d4.x, k4);
        fma4(acc[1], d4.y, k4);
        fma4(acc[2], d4.z, k4);
        fma4(acc[3], d4.w, k4);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = q0 + 4 * qg + j;
        if (q < a.HW)
          reinterpret_cast<float4*>(dm + ((size_t)b * a.HW + q) * K)[kv] =
              acc[j];
      }
    }

    // dk: thread owns slots 4 sg + i and channel vectors pg + 8 j.
    for (int q = 0; q < kTQ; ++q) {
      float d[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) d[i] = s.d[(4 * sg + i) * kDS + q];
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        const int kv = pg + 8 * j;
        if (kv >= KV) continue;
        const float4 m4 =
            *reinterpret_cast<const float4*>(s.ms + q * s.kstride + 4 * kv);
#pragma unroll
        for (int i = 0; i < 4; ++i) fma4(dk_acc[i][j], d[i], m4);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = 4 * sg + i;
    if (p >= a.P) continue;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int kv = pg + 8 * j;
      if (kv < KV) atomic_add4(dk + ((size_t)b * a.P + p) * K + 4 * kv,
                               dk_acc[i][j]);
    }
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

template <int K>
int launch_fwd(const Args& a, float* out_a, float* out_b, float* out_l,
               int grid_x, cudaStream_t s) {
  const size_t bytes = smem_bytes(K, a.N, false);
  if (int err = set_smem(dice_lava_fwd_kernel<K>, bytes)) return err;
  dice_lava_fwd_kernel<K><<<dim3(grid_x, a.B), kThreads, bytes, s>>>(
      a, out_a, out_b, out_l);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch_bwd(const Args& a, const float* ga, const float* gb,
               const float* gl, float* dk, float* dm, int grid_x,
               cudaStream_t s) {
  const size_t bytes = smem_bytes(K, a.N, true);
  if (int err = set_smem(dice_lava_bwd_kernel<K>, bytes)) return err;
  dice_lava_bwd_kernel<K><<<dim3(grid_x, a.B), kThreads, bytes, s>>>(
      a, ga, gb, gl, dk, dm);
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const void* kernels, const void* feat, const void* onehot,
               const void* targets, const void* grad, int B, int P, int N,
               int HW) {
  return Args{static_cast<const float*>(kernels),
              static_cast<const float*>(feat),
              static_cast<const float*>(onehot),
              static_cast<const float*>(targets),
              static_cast<const float*>(grad), B, P, N, HW};
}

}  // namespace

extern "C" {

// All tensors f32, contiguous, on one card, 16-byte aligned. P <= 128,
// K in {32, 128, 256} (the presets' kernel widths); the shared memory grows with K and N, and a
// launch that asks for more than the card has fails. grid_x pixel-tile
// blocks per image. a, b, lava (B, P) must be zeroed. Returns the
// cudaError_t of the launch.
int prn_dice_lava_fwd(const void* kernels, const void* feat,
                      const void* onehot, const void* targets,
                      const void* grad, void* out_a, void* out_b,
                      void* out_l, int B, int P, int K, int N, int HW,
                      int grid_x, void* stream) {
  const Args a = make_args(kernels, feat, onehot, targets, grad, B, P, N, HW);
  float* oa = static_cast<float*>(out_a);
  float* ob = static_cast<float*>(out_b);
  float* ol = static_cast<float*>(out_l);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 32: return launch_fwd<32>(a, oa, ob, ol, grid_x, s);
    case 128: return launch_fwd<128>(a, oa, ob, ol, grid_x, s);
    case 256: return launch_fwd<256>(a, oa, ob, ol, grid_x, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ga, gb, gl (B, P); dk (B, P, K) zeroed; dm (B, HW, K) fully written.
int prn_dice_lava_bwd(const void* kernels, const void* feat,
                      const void* onehot, const void* targets,
                      const void* grad, const void* ga, const void* gb,
                      const void* gl, void* dk, void* dm, int B, int P, int K,
                      int N, int HW, int grid_x, void* stream) {
  const Args a = make_args(kernels, feat, onehot, targets, grad, B, P, N, HW);
  const float* pa = static_cast<const float*>(ga);
  const float* pb = static_cast<const float*>(gb);
  const float* pl = static_cast<const float*>(gl);
  float* odk = static_cast<float*>(dk);
  float* odm = static_cast<float*>(dm);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 32: return launch_bwd<32>(a, pa, pb, pl, odk, odm, grid_x, s);
    case 128: return launch_bwd<128>(a, pa, pb, pl, odk, odm, grid_x, s);
    case 256: return launch_bwd<256>(a, pa, pb, pl, odk, odm, grid_x, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
