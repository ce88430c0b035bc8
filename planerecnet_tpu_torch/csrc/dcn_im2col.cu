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
//   sy = oy*stride - pad + ky + offset[b, p, 2k]
//   sx = ox*stride - pad + kx + offset[b, p, 2k+1]
//   cols[b, p, k*C + c] = mask[b, p, k] *
//       sum over the corners (00, 01, 10, 11) of w_corner * x[b, y, x, c]
// where a corner outside the image has weight 0. The cols layout is the
// one that weight.reshape(K*C, Cout) of an HWIO kernel expects.
//
// What bounds it: bytes. It does ~12 flops per sampled value against at
// least 2 bytes moved per value, far under the card's ~20 flops/byte f32
// balance point, and the cols it writes are 9x the input. The design does
// one 16-byte load per valid corner and one 16-byte store per thread: a
// thread owns one 16-byte vector of channels of one (b, p, k) row, so
// neighbouring threads read neighbouring channels of the same corner pixel
// (NHWC makes each corner one contiguous C vector) and write neighbouring
// addresses of cols. The geometry of a row (offsets, mask, corner weights)
// is recomputed by each thread of the row from broadcast loads rather than
// shared through shared memory: it costs a few flops and no barrier.
// Accumulation is in f32 for both f32 and bf16 inputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

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

template <typename T, int VEC>
__global__ void __launch_bounds__(256)
    dcn_im2col_kernel(const T* __restrict__ x, const float* __restrict__ offset,
                      const float* __restrict__ mask, T* __restrict__ cols,
                      int B, int H, int W, int C, int Ho, int Wo, int ks,
                      int stride, int pad) {
  using P = Pack<T, VEC>;
  const int cv_per_row = C / VEC;
  const int K = ks * ks;
  const int HoWo = Ho * Wo;
  const int total = B * HoWo * K * cv_per_row;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    const int cv = i % cv_per_row;
    const int row = i / cv_per_row;  // (b * HoWo + p) * K + k
    const int k = row % K;
    const int bp = row / K;  // b * HoWo + p
    const int p = bp % HoWo;
    const int b = bp / HoWo;
    const int oy = p / Wo;
    const int ox = p - oy * Wo;
    const int ky = k / ks;
    const int kx = k - ky * ks;

    const float sy = static_cast<float>(oy * stride - pad + ky) +
                     offset[(size_t)bp * 2 * K + 2 * k];
    const float sx = static_cast<float>(ox * stride - pad + kx) +
                     offset[(size_t)bp * 2 * K + 2 * k + 1];
    const float m = mask[(size_t)bp * K + k];

    const float fy0 = floorf(sy);
    const float fx0 = floorf(sx);
    const float fy = sy - fy0;
    const float fx = sx - fx0;
    const int y0 = static_cast<int>(fy0);
    const int x0 = static_cast<int>(fx0);

    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;

    const T* xb = x + (size_t)b * H * W * C + cv * VEC;
#pragma unroll
    for (int corner = 0; corner < 4; ++corner) {
      const int dy = corner >> 1;
      const int dx = corner & 1;
      const int yy = y0 + dy;
      const int xx = x0 + dx;
      if (yy < 0 || yy > H - 1 || xx < 0 || xx > W - 1) continue;
      const float wgt = (dy ? fy : 1.f - fy) * (dx ? fx : 1.f - fx);
      const P v = *reinterpret_cast<const P*>(xb + ((size_t)yy * W + xx) * C);
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] += wgt * to_f32(v.v[j]);
    }

    P out;
#pragma unroll
    for (int j = 0; j < VEC; ++j) out.v[j] = from_f32<T>(acc[j] * m);
    *reinterpret_cast<P*>(cols + (size_t)row * C + cv * VEC) = out;
  }
}

template <typename T>
int launch(const T* x, const float* offset, const float* mask, T* cols, int B,
           int H, int W, int C, int Ho, int Wo, int ks, int stride, int pad,
           cudaStream_t stream) {
  constexpr int kVec16 = 16 / sizeof(T);  // channels in 16 bytes
  const int threads = 256;
  // 16-byte accesses need C to be a multiple of the vector and both
  // tensors to start on a 16-byte boundary (a view may not).
  const bool vec = (C % kVec16) == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(cols) % 16 == 0;
  const long long work =
      (long long)B * Ho * Wo * ks * ks * (vec ? C / kVec16 : C);
  const long long want = (work + threads - 1) / threads;
  const int blocks = static_cast<int>(want < (1 << 20) ? want : (1 << 20));
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  if (vec) {
    dcn_im2col_kernel<T, kVec16><<<blocks, threads, 0, stream>>>(
        x, offset, mask, cols, B, H, W, C, Ho, Wo, ks, stride, pad);
  } else {
    dcn_im2col_kernel<T, 1><<<blocks, threads, 0, stream>>>(
        x, offset, mask, cols, B, H, W, C, Ho, Wo, ks, stride, pad);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 = cudaSuccess).
int prn_dcn_im2col_f32(const void* x, const void* offset, const void* mask,
                       void* cols, int B, int H, int W, int C, int Ho, int Wo,
                       int ks, int stride, int pad, void* stream) {
  return launch(static_cast<const float*>(x),
                static_cast<const float*>(offset),
                static_cast<const float*>(mask), static_cast<float*>(cols), B,
                H, W, C, Ho, Wo, ks, stride, pad,
                static_cast<cudaStream_t>(stream));
}

int prn_dcn_im2col_bf16(const void* x, const void* offset, const void* mask,
                        void* cols, int B, int H, int W, int C, int Ho, int Wo,
                        int ks, int stride, int pad, void* stream) {
  return launch(static_cast<const __nv_bfloat16*>(x),
                static_cast<const float*>(offset),
                static_cast<const float*>(mask),
                static_cast<__nv_bfloat16*>(cols), B, H, W, C, Ho, Wo, ks,
                stride, pad, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
