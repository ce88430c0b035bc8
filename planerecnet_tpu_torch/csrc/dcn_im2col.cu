// Deformable im2col for modulated deformable convolution (DCNv2), NHWC,
// for Hopper (sm_90a). Plain C interface, loaded with ctypes by
// planerecnet_tpu_torch/ops/dcn.py.
//
// Replaces the sampling half of planerecnet_tpu/ops/dcn.py::deform_conv2d:
// _sampling_positions + _corner_data + _bilinear_gather and the modulation
// in _modulate_matmul (the JAX package builds it from XLA gathers, chunked
// through a scan to fit the TPU's scoped VMEM). The product that follows,
// (B*Ho*Wo, K*Cin) @ (K*Cin, Cout), stays a plain matmul in the wrapper.
//
// For batch b, output pixel p = (oy, ox) and tap k = (ky, kx):
//   sy = (row0 + oy)*stride - pad + ky + offset[b, p, 2k]
//   sx = ox*stride - pad + kx + offset[b, p, 2k+1]
//   cols[b, p, k*C + c] = sum over the corners (00, 01, 10, 11) of
//       (w_corner * mask[b, p, k]) * x[b, y, x, c]
// where a corner outside the image has weight 0. The cols layout is the
// one that weight.reshape(K*C, Cout) of an HWIO kernel expects. row0 is
// the first output row of a window (a rank of the spatial mesh axis
// computes rows row0..row0+Ho-1 of the whole map's Hout from the whole x);
// it is added to the integer row before the offset, so the sample
// position's f32 rounding is the whole map's.
//
// What bounds it: bytes. It does ~9 flops per sampled value against at
// least 2 bytes moved per value, far under the card's ~20 flops/byte f32
// balance point, and the cols it writes are 9x the input. The first port
// (one thread per 16-byte vector of one (pixel, tap) row) reached 41-54%
// of that bound: each thread did ~7 integer divisions, recomputed the
// row's geometry that its 31 neighbours also computed, and ran one chain
// of dependent loads (offset, then corners, then the store) at a time.
// This design:
//   - a block owns a tile of output pixels (8, 16 or 32, across images)
//     with all their taps; it stages the tile's offsets and mask, which
//     are contiguous, into shared memory with coalesced loads;
//   - one thread per (pixel, tap) row then computes the row's four corner
//     offsets (-1 where the corner is outside the map) and four weights,
//     the mask folded in, into shared memory, once;
//   - the threads stream (row, 16-byte vector) pairs with no division in
//     the loop, four rows a thread in flight (two for bf16): up to sixteen
//     independent 16-byte corner loads before the first add;
//   - x is read through L1 with an L2 evict_last policy (createpolicy), so
//     that the corner gathers, which read each input vector up to 4x per
//     sample and ~36x over the taps of neighbouring pixels, stay in L2;
//     cols, written once and read only by the matmul, is stored with the
//     streaming hint (st.global.cs) so that it does not evict x.
// Where the time goes (throwaway edits of this file, timed beside it with
// CUDA events on an H100): without the corner gathers the kernel
// takes ~70% of its time, within a few per cent of its bytes bound, so
// the stores of cols set the pace; the default store policy costs ~2% and
// dropping the L2 hint ~1.5%. Neither hint moved a serving request's
// device time measurably.
// C not a multiple of the vector, or a misaligned pointer, takes the same
// kernel one element a lane. Accumulation is in f32 for f32 and bf16 x.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// VEC consecutive channels, loaded and stored as one access.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}

// A corner vector of x: through L1, kept in L2 (evict_last).
template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load_x(const T* p, uint64_t policy) {
  Pack<T, VEC> out;
  if constexpr (sizeof(T) * VEC == 16) {
    uint4 u;
    asm("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
        : "=r"(u.x), "=r"(u.y), "=r"(u.z), "=r"(u.w)
        : "l"(p), "l"(policy));
    out = *reinterpret_cast<Pack<T, VEC>*>(&u);
  } else if constexpr (sizeof(T) == 4) {
    uint32_t u;
    asm("ld.global.nc.L2::cache_hint.b32 %0, [%1], %2;"
        : "=r"(u)
        : "l"(p), "l"(policy));
    out = *reinterpret_cast<Pack<T, VEC>*>(&u);
  } else {
    unsigned short u;
    asm("ld.global.nc.L2::cache_hint.b16 %0, [%1], %2;"
        : "=h"(u)
        : "l"(p), "l"(policy));
    out = *reinterpret_cast<Pack<T, VEC>*>(&u);
  }
  return out;
}

// A vector of cols, written once: streaming, evict-first.
template <typename T, int VEC>
__device__ __forceinline__ void store_cols(T* p, const Pack<T, VEC>& v) {
  if constexpr (sizeof(T) * VEC == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(&v);
    asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};"
                 :
                 : "l"(p), "r"(u.x), "r"(u.y), "r"(u.z), "r"(u.w));
  } else if constexpr (sizeof(T) == 4) {
    asm volatile("st.global.cs.b32 [%0], %1;"
                 :
                 : "l"(p), "r"(*reinterpret_cast<const uint32_t*>(&v)));
  } else {
    asm volatile("st.global.cs.b16 [%0], %1;"
                 :
                 : "l"(p),
                   "h"(*reinterpret_cast<const unsigned short*>(&v)));
  }
}

// Shared memory of a tile of `tile` pixels with K taps: the staged
// offsets (2K a pixel) and mask (K a pixel), then each row's corner
// offsets and weights.
__host__ __device__ inline size_t tile_smem(int tile, int K) {
  return (size_t)tile * K * (3 * sizeof(float) + sizeof(int4) +
                             sizeof(float4));
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 2)
    dcn_im2col_kernel(const T* __restrict__ x, const float* __restrict__ offset,
                      const float* __restrict__ mask, T* __restrict__ cols,
                      int B, int H, int W, int C, int Ho, int Wo, int ks,
                      int stride, int pad, int row0, int tile) {
  using P = Pack<T, VEC>;
  // Rows a thread keeps in flight: four, two for bf16 vectors, whose
  // sixteen corners of eight channels would not fit in registers.
  constexpr int kRowsInFlight = sizeof(T) == 2 && VEC == 8 ? 2 : 4;
  extern __shared__ int4 smem[];
  const int K = ks * ks;
  int4* s_corner = smem;                                    // tile * K
  float4* s_weight = reinterpret_cast<float4*>(s_corner + tile * K);
  float* s_off = reinterpret_cast<float*>(s_weight + tile * K);  // 2K
  float* s_mask = s_off + tile * 2 * K;                          // K

  const int HoWo = Ho * Wo;
  const int px0 = blockIdx.x * tile;  // first pixel (b * HoWo + p)
  const int npx = min(tile, B * HoWo - px0);
  const int nrows = npx * K;

  // Stage the tile's offsets and mask: contiguous across pixels.
  for (int e = threadIdx.x; e < nrows * 2; e += kThreads)
    s_off[e] = offset[(size_t)px0 * 2 * K + e];
  for (int e = threadIdx.x; e < nrows; e += kThreads)
    s_mask[e] = mask[(size_t)px0 * K + e];
  __syncthreads();

  // Each row's geometry, once.
  for (int row = threadIdx.x; row < nrows; row += kThreads) {
    const int pix = row / K;
    const int k = row - pix * K;
    const int bp = px0 + pix;
    const int b = bp / HoWo;
    const int p = bp - b * HoWo;
    const int oy = p / Wo;
    const int ox = p - oy * Wo;
    const int ky = k / ks;
    const int kx = k - ky * ks;
    const float sy =
        static_cast<float>((row0 + oy) * stride - pad + ky) + s_off[2 * row];
    const float sx =
        static_cast<float>(ox * stride - pad + kx) + s_off[2 * row + 1];
    const float m = s_mask[row];
    const float fy0 = floorf(sy);
    const float fx0 = floorf(sx);
    const float fy = sy - fy0;
    const float fx = sx - fx0;
    const int y0 = static_cast<int>(fy0);
    const int x0 = static_cast<int>(fx0);
    int at[4];
    float wt[4];
#pragma unroll
    for (int corner = 0; corner < 4; ++corner) {
      const int dy = corner >> 1;
      const int dx = corner & 1;
      const int yy = y0 + dy;
      const int xx = x0 + dx;
      const bool in = yy >= 0 && yy <= H - 1 && xx >= 0 && xx <= W - 1;
      at[corner] = in ? ((b * H + yy) * W + xx) * C : -1;
      wt[corner] = in ? (dy ? fy : 1.f - fy) * (dx ? fx : 1.f - fx) * m : 0.f;
    }
    s_corner[row] = make_int4(at[0], at[1], at[2], at[3]);
    s_weight[row] = make_float4(wt[0], wt[1], wt[2], wt[3]);
  }
  __syncthreads();

  // Stream (row, vector) pairs: lane v of `rpp` rows a pass; a row of more
  // vectors than threads is walked by the whole block.
  const uint64_t policy = evict_last_policy();
  const int nvec = C / VEC;
  const int rpp = nvec <= kThreads ? kThreads / nvec : 1;
  const int v0 = nvec <= kThreads ? threadIdx.x % nvec : threadIdx.x;
  const int r0 = nvec <= kThreads ? threadIdx.x / nvec : 0;
  if (r0 >= rpp) return;
  T* cols_tile = cols + (size_t)px0 * K * C;
  for (int r = r0; r < nrows; r += kRowsInFlight * rpp) {
    for (int v = v0; v < nvec; v += kThreads) {
      P got[kRowsInFlight][4];
      float4 wts[kRowsInFlight];
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
        const int row = r + u * rpp;
        wts[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row >= nrows) continue;
        const int4 at = s_corner[row];
        wts[u] = s_weight[row];
        const int a[4] = {at.x, at.y, at.z, at.w};
#pragma unroll
        for (int corner = 0; corner < 4; ++corner) {
          if (a[corner] >= 0) {
            got[u][corner] = load_x<T, VEC>(x + a[corner] + v * VEC, policy);
          } else {
#pragma unroll
            for (int j = 0; j < VEC; ++j)
              got[u][corner].v[j] = from_f32<T>(0.f);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
        const int row = r + u * rpp;
        if (row >= nrows) continue;
        const float w[4] = {wts[u].x, wts[u].y, wts[u].z, wts[u].w};
        float acc[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
#pragma unroll
        for (int corner = 0; corner < 4; ++corner) {
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            acc[j] += w[corner] * to_f32(got[u][corner].v[j]);
        }
        P out;
#pragma unroll
        for (int j = 0; j < VEC; ++j) out.v[j] = from_f32<T>(acc[j]);
        store_cols<T, VEC>(cols_tile + (size_t)row * C + v * VEC, out);
      }
    }
  }
}

template <typename T>
int launch(const T* x, const float* offset, const float* mask, T* cols, int B,
           int H, int W, int C, int Ho, int Wo, int ks, int stride, int pad,
           int row0, cudaStream_t stream) {
  constexpr int kVec16 = 16 / sizeof(T);  // channels in 16 bytes
  // 16-byte accesses need C to be a multiple of the vector and both
  // tensors to start on a 16-byte boundary (a view may not).
  const bool vec = (C % kVec16) == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(cols) % 16 == 0;
  const long long pixels = (long long)B * Ho * Wo;
  if (pixels == 0 || C == 0) return static_cast<int>(cudaGetLastError());
  // The largest tile that still gives the card a few blocks a SM.
  int tile = 32;
  while (tile > 8 && (pixels + tile - 1) / tile < 512) tile /= 2;
  const long long blocks = (pixels + tile - 1) / tile;
  const size_t smem = tile_smem(tile, ks * ks);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (vec) {
    dcn_im2col_kernel<T, kVec16><<<static_cast<unsigned>(blocks), kThreads,
                                   smem, stream>>>(
        x, offset, mask, cols, B, H, W, C, Ho, Wo, ks, stride, pad, row0,
        tile);
  } else {
    dcn_im2col_kernel<T, 1><<<static_cast<unsigned>(blocks), kThreads, smem,
                              stream>>>(
        x, offset, mask, cols, B, H, W, C, Ho, Wo, ks, stride, pad, row0,
        tile);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 = cudaSuccess).
int prn_dcn_im2col_f32(const void* x, const void* offset, const void* mask,
                       void* cols, int B, int H, int W, int C, int Ho, int Wo,
                       int ks, int stride, int pad, int row0, void* stream) {
  return launch(static_cast<const float*>(x),
                static_cast<const float*>(offset),
                static_cast<const float*>(mask), static_cast<float*>(cols), B,
                H, W, C, Ho, Wo, ks, stride, pad, row0,
                static_cast<cudaStream_t>(stream));
}

int prn_dcn_im2col_bf16(const void* x, const void* offset, const void* mask,
                        void* cols, int B, int H, int W, int C, int Ho, int Wo,
                        int ks, int stride, int pad, int row0, void* stream) {
  return launch(static_cast<const __nv_bfloat16*>(x),
                static_cast<const float*>(offset),
                static_cast<const float*>(mask),
                static_cast<__nv_bfloat16*>(cols), B, H, W, C, Ho, Wo, ks,
                stride, pad, row0, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
