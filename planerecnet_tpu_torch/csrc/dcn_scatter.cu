// Input gradient of the modulated deformable convolution (DCNv2), NHWC, for
// Hopper (sm_90a). Plain C interface, loaded with ctypes by
// planerecnet_tpu_torch/ops/dcn_scatter.py.
//
// Replaces planerecnet_tpu/ops/pallas/dcn_scatter.py::dcn_input_grad_pallas
// (kernel _make_kernel). For every contribution row r of image b, with its
// top-left corner (cy, cx) in coordinates padded by one pixel and its four
// weights w[0..3] for the corners (00, 01, 10, 11):
//   dx[b, cy + dy - 1, cx + dx - 1, :] += w[2*dy + dx] * dcols[b, r, :]
// A corner that lands in the one-pixel margin is dropped: the TPU kernel
// accumulates it into a padded map and crops the margin afterwards, which
// is the same function. The output must be zeroed by the caller.
//
// What bounds it: bytes. Each row's C channels are read once and added into
// up to four pixels, ~8 flops per 4-byte value; dcols alone is 236 MB at
// PRN-50's 80x80x128 layers at batch 8, 640x640. The design reads each row's
// corner and weights once (broadcast loads, every thread of the row reads
// the same words) and each 16-byte vector of dcols once: a thread owns one
// 16-byte channel vector of one row, so a warp reads contiguous dcols and
// adds into contiguous channels of one destination pixel. The adds are
// float4 atomics in global memory (Hopper has red.global.add.v4.f32), so
// there is no band loop and no shared-memory accumulator: both were the
// TPU kernel's answer to its 16 MB of scoped VMEM. Corners of weight 0 are
// skipped; they add exactly 0 for finite dcols (on a non-finite step the
// trainer discards the gradients anyway).
//
// Determinism: the atomics make the order in which a pixel's contributions
// are summed vary from run to run, so dx varies in its last bits between
// runs and differs from the plain version (four index_add_ in row order) by
// a few f32 ulps of the sum of the contributions' magnitudes (chip_smoke.py
// measures the difference at the PRN-50 shapes). A destination-sorted,
// deterministic form is left for later.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

template <int VEC>
struct alignas(4 * VEC) Pack {
  float v[VEC];
};

__device__ __forceinline__ void atomic_add_vec(float* dst, const float* v,
                                               float scale, int n) {
  for (int j = 0; j < n; ++j) atomicAdd(dst + j, scale * v[j]);
}

template <int VEC>
__device__ __forceinline__ void atomic_add_pack(float* dst,
                                                const Pack<VEC>& d,
                                                float scale) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  if constexpr (VEC == 4) {
    atomicAdd(reinterpret_cast<float4*>(dst),
              make_float4(scale * d.v[0], scale * d.v[1], scale * d.v[2],
                          scale * d.v[3]));
    return;
  }
#endif
  atomic_add_vec(dst, d.v, scale, VEC);
}

template <int VEC>
__global__ void __launch_bounds__(256)
    dcn_scatter_kernel(const int* __restrict__ corner_idx,
                       const float* __restrict__ corner_w,
                       const float* __restrict__ dcols, float* __restrict__ dx,
                       int B, int R, int H, int W, int C) {
  using P = Pack<VEC>;
  const int cv_per_row = C / VEC;
  const long long total = (long long)B * R * cv_per_row;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int cv = static_cast<int>(i % cv_per_row);
    const long long row = i / cv_per_row;  // b * R + r
    const int b = static_cast<int>(row / R);
    const int cy = corner_idx[2 * row];
    const int cx = corner_idx[2 * row + 1];
    float w[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) w[c] = corner_w[4 * row + c];
    const P d = *reinterpret_cast<const P*>(dcols + row * C + cv * VEC);
    float* dxb = dx + (size_t)b * H * W * C + cv * VEC;
#pragma unroll
    for (int corner = 0; corner < 4; ++corner) {
      if (w[corner] == 0.f) continue;
      const int y = cy + (corner >> 1) - 1;  // image coordinates
      const int x = cx + (corner & 1) - 1;
      if (y < 0 || y >= H || x < 0 || x >= W) continue;  // margin
      atomic_add_pack<VEC>(dxb + ((size_t)y * W + x) * C, d, w[corner]);
    }
  }
}

}  // namespace

extern "C" {

// corner_idx (B, R, 2) int32, corner_w (B, R, 4) f32, dcols (B, R, C) f32,
// dx (B, H, W, C) f32 zeroed; all contiguous on one card. Returns the
// cudaError_t of the launch (0 = cudaSuccess).
int prn_dcn_scatter_f32(const void* corner_idx, const void* corner_w,
                        const void* dcols, void* dx, int B, int R, int H,
                        int W, int C, void* stream) {
  const int threads = 256;
  const bool vec = (C % 4) == 0 &&
                   reinterpret_cast<uintptr_t>(dcols) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  const long long work = (long long)B * R * (vec ? C / 4 : C);
  const long long want = (work + threads - 1) / threads;
  const int blocks = static_cast<int>(want < (1 << 20) ? want : (1 << 20));
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* idx = static_cast<const int*>(corner_idx);
  const float* cw = static_cast<const float*>(corner_w);
  const float* dc = static_cast<const float*>(dcols);
  float* out = static_cast<float*>(dx);
  if (vec) {
    dcn_scatter_kernel<4><<<blocks, threads, 0, s>>>(idx, cw, dc, out, B, R,
                                                     H, W, C);
  } else {
    dcn_scatter_kernel<1><<<blocks, threads, 0, s>>>(idx, cw, dc, out, B, R,
                                                     H, W, C);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
