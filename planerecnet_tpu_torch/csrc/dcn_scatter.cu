// Input gradient of the modulated deformable convolution (DCNv2), NHWC, for
// Hopper (sm_90a). Plain C interface, loaded with ctypes by
// planerecnet_tpu_torch/ops/dcn_scatter.py, which also plans the launch.
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
// PRN-50's 80x80x128 layers at batch 8, 640x640, and dx a ninth of that
// (four ninths at stride 2).
//
// What the design does about the atomics. The first port sent every corner
// of every row to L2 as a float4 atomic: up to 4x dcols of atomic payload
// into a dx a ninth of its size, each pixel taking ~36 adds that serialise
// in L2's atomic units, at 26% of HBM. Accumulating in shared memory with
// f32 atomics instead is no cure on this card: sm_90 has no shared-memory
// f32 add, and atomicAdd there compiles to a compare-and-swap loop
// (ATOMS.CAST.SPIN in the SASS), which a throwaway build of this design
// measured slower than the first port. So a block sorts its corners. It
// owns a tile of rows of one image; the host lays the rows out as a grid
// of lines (ops/dcn_scatter.py::scatter_plan: where the rows come from a
// 3x3 conv, a line is one output row, 9 rows a pixel, and a tile L output
// rows by n pixels), so that a tile's corners fall in a small box of dx.
// The block
//   1. loads its rows' corners and weights into registers (two rows a
//      thread), before anything else is queued on the memory system;
//   2. starts copying the first 32 channels (one 128-byte line) of the
//      tile's dcols into shared memory with cp.async, which lands while
//      steps 3-4 run;
//   3. reduces the tile's corner bounding box and mean (warp shuffles,
//      then shared memory) and takes the box, clipped to the planned
//      budget about the mean, as its window of dx pixels;
//   4. counting-sorts the corners by window pixel: each corner's count is
//      a native integer shared atomic whose old value is its rank, a block
//      scan turns counts into starts, and each thread files (row, weight)
//      at start + rank. A corner outside the window (offsets beyond the
//      plan, rows in no 3x3 layout) goes to a list of its own;
//   5. then, for each of its `group` slices of 32 channels (the sort serves
//      them all), starts copying the next slice into the other buffer and
//      sums this one: eight lanes a window pixel, four channels a lane,
//      weight x dcols over the pixel's list from shared memory in
//      registers, with no atomics, then one red.global.add.v4.f32 a lane;
//      an empty pixel sends nothing, and neighbouring tiles overlap only
//      in their halo. The outside list goes to dx the same way.
// Any corner_idx is right; locality is only what makes it fast. The global
// atomic payload falls from up to 4x dcols to the windows' occupied
// pixels, about two to three dx's worth where offsets are under a pixel.
// C not a multiple of 4, or a misaligned pointer, takes the same kernel
// with scalar lanes. Corners of weight 0 are skipped: they add exactly 0
// for finite dcols (on a non-finite step the trainer discards the
// gradients).
//
// Determinism: a pixel's sum within a block follows the order in which the
// integer atomics ranked its corners, and the blocks' global atomics land
// in any order, so dx still varies in its last bits between runs and
// differs from the plain version (four index_add_ in row order) by a few
// f32 ulps of the sum of the contributions' magnitudes (chip_smoke.py
// measures it at the PRN-50 shapes).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlice = 32;  // channels a slice: one 128-byte line
// Rows a thread sorts; a tile holds at most kThreads times this.
constexpr int kRowsPerThread = 2;
constexpr int kMaxTileRows = kThreads * kRowsPerThread;

struct Plan {
  int period;      // rows a line of the row grid
  int lines;       // lines of an image (the last may hold fewer rows)
  int tile_lines;  // lines a tile
  int tile_rows;   // rows a tile takes of each line
  int tiles_across;
  int tiles_down;
  int slices;      // ceil(C / kSlice)
  int group;       // slices a block takes, one after another
  int groups;      // ceil(slices / group)
  int window_px;   // the window's budget in pixels
};

// Shared memory of a block: two buffers of the tile's dcols (kSlice floats
// a row), its sorted corners (four int2 a row), the window's counts and
// starts.
__host__ __device__ inline size_t smem_bytes(int tile_rows_total,
                                             int window_px) {
  return (size_t)tile_rows_total *
             (2 * kSlice * sizeof(float) + 4 * sizeof(int2)) +
         (size_t)window_px * 2 * sizeof(int);
}

// Warp reduction of the box (min y, max y, min x, max x) and of the sums.
__device__ __forceinline__ void warp_box(int& y0, int& y1, int& x0, int& x1,
                                         float& sy, float& sx, int& n) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    y0 = min(y0, __shfl_xor_sync(0xffffffffu, y0, o));
    y1 = max(y1, __shfl_xor_sync(0xffffffffu, y1, o));
    x0 = min(x0, __shfl_xor_sync(0xffffffffu, x0, o));
    x1 = max(x1, __shfl_xor_sync(0xffffffffu, x1, o));
    sy += __shfl_xor_sync(0xffffffffu, sy, o);
    sx += __shfl_xor_sync(0xffffffffu, sx, o);
    n += __shfl_xor_sync(0xffffffffu, n, o);
  }
}

// The window's first pixel and extent along one axis: the box [lo, hi]
// (image coordinates, already inside the map) if it fits in `budget`,
// else `budget` pixels centred on `mean`, inside the box.
__device__ __forceinline__ void fit_axis(int lo, int hi, float mean,
                                         int budget, int& start, int& len) {
  len = hi - lo + 1;
  start = lo;
  if (len > budget) {
    start = __float2int_rn(mean - 0.5f * budget);
    start = max(lo, min(start, hi - budget + 1));
    len = budget;
  }
}

// An asynchronous copy of VEC floats from global to shared memory that
// reads `bytes` of them (0: the destination is zeroed).
template <int VEC>
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (VEC == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                 :
                 : "r"(d), "l"(src), "r"(bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                 :
                 : "r"(d), "l"(src), "r"(bytes));
  }
}

// VEC consecutive channels of one pixel or row.
template <int VEC>
struct alignas(4 * VEC) Vec {
  float v[VEC];
};

// Adds `a` to dx at `dst` unless it is all zero: one red.global.add.v4.f32
// (VEC 4) or one scalar atomic.
template <int VEC>
__device__ __forceinline__ void add_to_dx(float* dst, const Vec<VEC>& a) {
  bool any = false;
#pragma unroll
  for (int k = 0; k < VEC; ++k) any |= a.v[k] != 0.f;
  if (!any) return;
  if constexpr (VEC == 4) {
    atomicAdd(reinterpret_cast<float4*>(dst),
              make_float4(a.v[0], a.v[1], a.v[2], a.v[3]));
  } else {
    atomicAdd(dst, a.v[0]);
  }
}

// VEC 4: dcols and dx on 16-byte boundaries with C a multiple of 4.
template <int VEC>
__global__ void __launch_bounds__(kThreads, 2)
    dcn_scatter_kernel(const int2* __restrict__ corner_idx,
                       const float4* __restrict__ corner_w,
                       const float* __restrict__ dcols, float* __restrict__ dx,
                       int R, int H, int W, int C, Plan plan) {
  extern __shared__ float4 smem4[];
  const int tile_total = plan.tile_lines * plan.tile_rows;
  float* s_dcols = reinterpret_cast<float*>(smem4);  // 2 x rows x 32
  int2* s_list = reinterpret_cast<int2*>(s_dcols + 2 * tile_total * kSlice);
  int* s_count = reinterpret_cast<int*>(s_list + 4 * tile_total);
  int* s_start = s_count + plan.window_px;
  __shared__ int s_box[kWarps][5];
  __shared__ float s_sum[kWarps][2];
  __shared__ int s_win[4];  // y0, x0, rows, cols of the window
  __shared__ int s_scan[kWarps];
  __shared__ int s_outside;

  // Block -> (image, tile down, tile across, group of channel slices),
  // groups fastest so the blocks that share a tile's rows run together.
  int t = blockIdx.x;
  const int slice0 = (t % plan.groups) * plan.group;
  const int nslices = min(plan.group, plan.slices - slice0);
  t /= plan.groups;
  const int tx = t % plan.tiles_across;
  t /= plan.tiles_across;
  const int ty = t % plan.tiles_down;
  const int b = t / plan.tiles_down;
  const int line0 = ty * plan.tile_lines;
  const int nlines = min(plan.tile_lines, plan.lines - line0);
  const int col0 = tx * plan.tile_rows;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // A row or pixel takes kLanes lanes, VEC channels each; a warp takes
  // kGroups of them.
  constexpr int kLanes = kSlice / VEC;
  constexpr int kGroups = 32 / kLanes;
  const int sub = lane % kLanes;
  const int group = lane / kLanes;
  const int my_ch = sub * VEC;  // this lane's first channel in the slice
  // Tile row t = i * tile_rows + j is row (line0 + i) * period + col0 + j
  // of image b, if j < len(i).
  auto line_len = [&](int i) {
    const int start = (line0 + i) * plan.period + col0;
    return min(min(plan.tile_rows, plan.period - col0), R - start);
  };
  auto global_row = [&](int i, int j) {
    return (size_t)b * R + (size_t)(line0 + i) * plan.period + col0 + j;
  };
  // Starts copying slice slice0 + k of the tile's dcols into buffer k % 2.
  auto copy_slice = [&](int k) {
    const int ch0 = (slice0 + k) * kSlice;
    const int valid_ch = min(kSlice, C - ch0);
    float* buf = s_dcols + (k & 1) * tile_total * kSlice;
    for (int i = 0; i < nlines; ++i) {
      const int len = line_len(i);
      for (int e = threadIdx.x; e < len * kLanes; e += kThreads) {
        const int j = e / kLanes;
        const int l = e - j * kLanes;
        const bool in = l * VEC < valid_ch;
        copy_async<VEC>(buf + (i * plan.tile_rows + j) * kSlice + l * VEC,
                        in ? dcols + global_row(i, j) * C + ch0 + l * VEC
                           : dcols,
                        in ? 4 * VEC : 0);
      }
    }
    asm volatile("cp.async.commit_group;");
  };

  // 1. Load this thread's rows' corners and weights (tile row
  // threadIdx.x + u * kThreads); they serve steps 3 and 4.
  int tag[kRowsPerThread];
  int2 corner[kRowsPerThread];
  float4 weight[kRowsPerThread];
#pragma unroll
  for (int u = 0; u < kRowsPerThread; ++u) {
    const int tr = threadIdx.x + u * kThreads;  // tile row
    const int i = tr / plan.tile_rows;
    const int j = tr - i * plan.tile_rows;
    tag[u] = i < nlines && j < line_len(i) ? tr : -1;
    corner[u] = make_int2(0, 0);
    weight[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (tag[u] < 0) continue;
    const size_t row = global_row(i, j);
    corner[u] = corner_idx[row];
    weight[u] = corner_w[row];
  }

  // 2. Start copying the first slice of the tile's dcols into shared
  // memory; the copy runs while the block sorts the corners (steps 3-4).
  copy_slice(0);

  // 3. The tile's corner box and mean, and the window.
  int y0 = INT_MAX, y1 = INT_MIN, x0 = INT_MAX, x1 = INT_MIN, n = 0;
  float sy = 0.f, sx = 0.f;
#pragma unroll
  for (int u = 0; u < kRowsPerThread; ++u) {
    if (tag[u] < 0) continue;
    const int2 c = corner[u];
    y0 = min(y0, c.x);
    y1 = max(y1, c.x);
    x0 = min(x0, c.y);
    x1 = max(x1, c.y);
    sy += static_cast<float>(c.x);
    sx += static_cast<float>(c.y);
    ++n;
  }
  warp_box(y0, y1, x0, x1, sy, sx, n);
  if (lane == 0) {
    s_box[warp][0] = y0;
    s_box[warp][1] = y1;
    s_box[warp][2] = x0;
    s_box[warp][3] = x1;
    s_box[warp][4] = n;
    s_sum[warp][0] = sy;
    s_sum[warp][1] = sx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      y0 = min(y0, s_box[w][0]);
      y1 = max(y1, s_box[w][1]);
      x0 = min(x0, s_box[w][2]);
      x1 = max(x1, s_box[w][3]);
      n += s_box[w][4];
      sy += s_sum[w][0];
      sx += s_sum[w][1];
    }
    // Padded top-left corners [y0, y1] reach image rows [y0 - 1, y1];
    // keep what lies in the map.
    const int lo_y = max(y0 - 1, 0), hi_y = min(y1, H - 1);
    const int lo_x = max(x0 - 1, 0), hi_x = min(x1, W - 1);
    int wy = 0, wx = 0, nh = 0, nw = 0;
    if (n > 0 && lo_y <= hi_y && lo_x <= hi_x) {
      // Mean patch centre, image coordinates: (cy - 1) + 0.5.
      const float my = sy / n - 0.5f, mx = sx / n - 0.5f;
      fit_axis(lo_x, hi_x, mx, plan.window_px, wx, nw);
      fit_axis(lo_y, hi_y, my, plan.window_px / nw, wy, nh);
    }
    s_win[0] = wy;
    s_win[1] = wx;
    s_win[2] = nh;
    s_win[3] = nw;
    s_outside = 0;
  }
  __syncthreads();
  const int wy = s_win[0], wx = s_win[1], nh = s_win[2], nw = s_win[3];
  const int npx = nh * nw;
  for (int p = threadIdx.x; p < npx; p += kThreads) s_count[p] = 0;
  __syncthreads();

  // 4. Count each row's corners into their window pixels (rank = the old
  // count); corners outside the window go to the list's far end.
  const int list_end = 4 * tile_total;
  int pix[kRowsPerThread][4], rank[kRowsPerThread][4];
#pragma unroll
  for (int u = 0; u < kRowsPerThread; ++u) {
    const int2 c = corner[u];
    const float ws[4] = {weight[u].x, weight[u].y, weight[u].z, weight[u].w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      pix[u][k] = -1;
      if (tag[u] < 0) continue;
      const int y = c.x + (k >> 1) - 1;  // image coordinates
      const int x = c.y + (k & 1) - 1;
      if (ws[k] == 0.f || y < 0 || y >= H || x < 0 || x >= W) continue;
      const int py = y - wy, px = x - wx;
      if (py >= 0 && py < nh && px >= 0 && px < nw) {
        pix[u][k] = py * nw + px;
        rank[u][k] = atomicAdd(&s_count[py * nw + px], 1);
      } else {
        const int o = atomicAdd(&s_outside, 1);
        s_list[list_end - 1 - o] =
            make_int2(tag[u] * 4 + k, __float_as_int(ws[k]));
      }
    }
  }
  __syncthreads();

  // Exclusive scan of the counts: each thread a contiguous run.
  {
    const int per = (npx + kThreads - 1) / kThreads;
    const int lo = min(npx, threadIdx.x * per), hi = min(npx, lo + per);
    int run = 0;
    for (int p = lo; p < hi; ++p) run += s_count[p];
    int incl = run;  // inclusive scan of the runs across the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) s_scan[warp] = incl;
    __syncthreads();
    int base = incl - run;
    for (int w = 0; w < warp; ++w) base += s_scan[w];
    for (int p = lo; p < hi; ++p) {
      s_start[p] = base;
      base += s_count[p];
    }
  }
  __syncthreads();

  // File each counted corner at its pixel's start + rank.
#pragma unroll
  for (int u = 0; u < kRowsPerThread; ++u) {
    const float ws[4] = {weight[u].x, weight[u].y, weight[u].z, weight[u].w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int p = pix[u][k];
      if (p < 0) continue;
      s_list[s_start[p] + rank[u][k]] =
          make_int2(tag[u] * 4 + k, __float_as_int(ws[k]));
    }
  }
  __syncthreads();

  // 5. For each slice: start copying the next while this one is summed,
  // kLanes lanes a window pixel, VEC channels a lane, weight x dcols over
  // the pixel's list in registers, one add to dx; then the corners outside
  // the window, kLanes lanes each.
  const int outside = s_outside;
  for (int k = 0; k < nslices; ++k) {
    if (k + 1 < nslices) {
      copy_slice(k + 1);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();
    const int ch0 = (slice0 + k) * kSlice;
    const bool lane_on = my_ch < C - ch0;
    float* dx_b = dx + (size_t)b * H * W * C + ch0 + my_ch;
    const float* s_mine = s_dcols + (k & 1) * tile_total * kSlice + my_ch;
    for (int p = warp * kGroups + group; p < npx; p += kWarps * kGroups) {
      const int cnt = s_count[p];
      const int2* list = s_list + s_start[p];
      Vec<VEC> acc;
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc.v[q] = 0.f;
#pragma unroll 4
      for (int e = 0; e < cnt; ++e) {
        const int2 en = list[e];
        const float w = __int_as_float(en.y);
        const Vec<VEC> d = *reinterpret_cast<const Vec<VEC>*>(
            s_mine + (en.x >> 2) * kSlice);
#pragma unroll
        for (int q = 0; q < VEC; ++q) acc.v[q] += w * d.v[q];
      }
      if (lane_on && cnt > 0) {
        const int y = wy + p / nw, x = wx + p % nw;
        add_to_dx<VEC>(dx_b + ((size_t)y * W + x) * C, acc);
      }
    }
    for (int e = warp * kGroups + group; e < outside; e += kWarps * kGroups) {
      const int2 en = s_list[list_end - 1 - e];
      const int tr = en.x >> 2, corner = en.x & 3;
      const int i = tr / plan.tile_rows;
      const int2 c = corner_idx[global_row(i, tr - i * plan.tile_rows)];
      const int y = c.x + (corner >> 1) - 1;
      const int x = c.y + (corner & 1) - 1;
      const float w = __int_as_float(en.y);
      Vec<VEC> v = *reinterpret_cast<const Vec<VEC>*>(s_mine + tr * kSlice);
#pragma unroll
      for (int q = 0; q < VEC; ++q) v.v[q] *= w;
      if (lane_on) add_to_dx<VEC>(dx_b + ((size_t)y * W + x) * C, v);
    }
    __syncthreads();  // before the next copy overwrites this buffer
  }
}

template <int VEC>
int launch(const int2* idx, const float4* cw, const float* dcols, float* dx,
           int B, int R, int H, int W, int C, const Plan& plan,
           cudaStream_t stream) {
  const size_t smem =
      smem_bytes(plan.tile_lines * plan.tile_rows, plan.window_px);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        dcn_scatter_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (long long)B * plan.tiles_down *
                           plan.tiles_across * plan.groups;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  dcn_scatter_kernel<VEC><<<static_cast<int>(blocks), kThreads, smem,
                            stream>>>(idx, cw, dcols, dx, R, H, W, C, plan);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// corner_idx (B, R, 2) int32 on an 8-byte boundary, corner_w (B, R, 4) f32
// on a 16-byte boundary, dcols (B, R, C) f32, dx (B, H, W, C) f32 zeroed;
// all contiguous on one card. The last seven ints are
// ops/dcn_scatter.py::ScatterPlan. Returns the cudaError_t of the launch
// (0 = cudaSuccess).
int prn_dcn_scatter_f32(const void* corner_idx, const void* corner_w,
                        const void* dcols, void* dx, int B, int R, int H,
                        int W, int C, int period, int lines, int tile_lines,
                        int tile_rows, int slices, int group, int window_px,
                        void* stream) {
  if (period <= 0 || lines <= 0 || tile_lines <= 0 || tile_rows <= 0 ||
      tile_lines * tile_rows > kMaxTileRows || window_px <= 0 ||
      slices != (C + kSlice - 1) / kSlice || group <= 0 ||
      (long long)period * lines < R ||
      reinterpret_cast<uintptr_t>(corner_idx) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(corner_w) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan plan{period, lines, tile_lines, tile_rows,
            (period + tile_rows - 1) / tile_rows,
            (lines + tile_lines - 1) / tile_lines, slices, group,
            (slices + group - 1) / group, window_px};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int2* idx = static_cast<const int2*>(corner_idx);
  const float4* cw = static_cast<const float4*>(corner_w);
  const float* dc = static_cast<const float*>(dcols);
  float* out = static_cast<float*>(dx);
  const bool vec = (C % 4) == 0 &&
                   reinterpret_cast<uintptr_t>(dcols) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  if (vec) return launch<4>(idx, cw, dc, out, B, R, H, W, C, plan, s);
  return launch<1>(idx, cw, dc, out, B, R, H, W, C, plan, s);
}

}  // extern "C"
