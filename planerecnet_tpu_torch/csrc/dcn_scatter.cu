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
//
// prn_dcn_scatter_det_f32 is the variant that sums in a fixed order, for
// training that must reproduce a run (the train CLI's --reproductablity).
// Every dx element is the sum of its corners' w x dcols in key order, key =
// corner * R + row: the order of the plain version's four index_add_
// passes, each product and each sum rounded on its own (__fmul_rn,
// __fadd_rn: no fused multiply-add), so it gives the CPU's bits. What
// bounds it is bytes, as above: dcols read once, dx written once. Its
// design, a block per tile of dx pixels (ops/dcn_scatter.py::det_plan:
// 7x8 pixels where a pixel takes 9 rows' corners, 16x16 at stride 2), in
// two launches:
//   1. bin: each row's corners that land in the map with a non-zero weight
//      name at most four tiles; each (row, tile) pair takes a place in the
//      tile's bucket of kDetRowCap rows from an integer atomic count, which
//      a warp takes once a tile (its lanes' pairs merged by
//      __match_any_sync). A pair past the bucket's end goes to a spill
//      list. The places vary from run to run; nothing below depends on
//      them;
//   2. sum, a block per tile and group of 16-channel slices, two blocks an
//      SM: the block loads its rows and their corners (four rows a thread
//      in flight at once), starts copying their dcols, 16 channels (64
//      bytes) a row, into shared memory with cp.async, and meanwhile orders
//      them: a row's corner k lands on pixel (top-left + k), so a pixel's
//      entries in key order are, for k = 0..3, the rows whose top-left is
//      (pixel - k), in row order. The block counting-sorts its rows by
//      top-left (shared-memory integer atomics, a scan), ranks each within
//      its bucket by row (about 9 rows a bucket), and writes each pixel's
//      entries (row offset, weight), those of weight 0 left out, as one
//      list. Then, slice by slice, four lanes a pixel (four channels each)
//      sum their pixel's list from shared memory in registers and store
//      the pixel with plain coalesced stores: no atomics, no zeroed dx.
//      Each row's dcols is read from device memory once per tile it
//      touches: 1.29x dcols at 7x8 (72 top-left pixels feed 56), 1.13x at
//      16x16. One block an SM with two buffers lost more to its serial
//      ordering than the second block on the SM, which overlaps it, costs.
// A tile with more rows than a round holds (offsets that pile many rows
// onto a few pixels) is summed in rounds of key ranges, each of at most
// kDetRowCap corners: a histogram of the tile's keys picks the ranges,
// refined where one bin alone overflows, and each round after the first
// adds onto the dx that the earlier rounds stored. The key order holds
// across rounds, so any corner_idx gives the same bits; only speed
// depends on locality.

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

// ------------------------------------------ the deterministic variant --

constexpr int kDetThreads = 256;
constexpr int kDetWarps = kDetThreads / 32;
constexpr int kDetSlice = 16;         // channels a slice: 64 bytes of a row
constexpr int kDetRowCap = 768;       // rows (or corners) a round holds
constexpr int kDetMaxBuckets = 1024;  // (tile_h + 1) * (tile_w + 1), at most
constexpr int kDetBins = 1024;        // histogram bins of an overflowing tile

struct DetPlan {
  int tile_h, tile_w;  // dx pixels of a tile
  int tiles_down, tiles_across;
  int slices;  // ceil(C / kDetSlice)
  int group;   // slices a block takes, one after another
  int groups;  // ceil(slices / group)
};

// Dynamic shared memory of det_tile_kernel: kDetSlice channels of each
// staged row; the pixels' entries (four at most a row;
// the rows' weights by slot live there until the entries are built); each
// row's weights in summing order, its row, bucket, rank as the bucket
// filled, the buckets' rows and the slots in summing order; the
// histogram, the buckets' counts and starts.
// ops/dcn_scatter.py::DET_SMEM mirrors it.
constexpr size_t kDetSmem =
    (size_t)kDetRowCap * (kDetSlice * sizeof(float) + 4 * sizeof(int2) +
                          sizeof(float4) + 5 * sizeof(int)) +
    (size_t)(kDetBins + 2 * kDetMaxBuckets + 1) * sizeof(int);

// Step 1 (see the header). The whole warp runs each iteration, so that
// its lanes can merge their (row, tile) pairs. count[tiles] counts the
// spilled pairs.
__global__ void __launch_bounds__(kDetThreads)
    det_bin_kernel(const int2* __restrict__ corner_idx,
                   const float4* __restrict__ corner_w, int* __restrict__ count,
                   int* __restrict__ bucket, int2* __restrict__ spill,
                   int tiles, int rows, int R, int H, int W, DetPlan p) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  for (int base = blockIdx.x * kDetThreads + (threadIdx.x & ~31); base < rows;
       base += gridDim.x * kDetThreads) {
    const int i = base + lane;
    int tile[4] = {-1, -1, -1, -1};
    int r = 0;
    if (i < rows) {
      const int b = i / R;
      r = i - b * R;
      const int2 c = corner_idx[i];
      const float4 w4 = corner_w[i];
      const float ws[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int y = c.x - 1 + (k >> 1), x = c.y - 1 + (k & 1);
        if (ws[k] == 0.f || y < 0 || y >= H || x < 0 || x >= W) continue;
        const int t = (b * p.tiles_down + y / p.tile_h) * p.tiles_across +
                      x / p.tile_w;
        bool seen = false;
#pragma unroll
        for (int j = 0; j < k; ++j) seen |= tile[j] == t;
        if (!seen) tile[k] = t;
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int t = tile[k];
      if (!__any_sync(0xffffffffu, t >= 0)) continue;
      const unsigned peers = __match_any_sync(0xffffffffu, t);
      const int leader = __ffs(peers) - 1;
      int at = 0;
      if (t >= 0 && lane == leader) at = atomicAdd(count + t, __popc(peers));
      at = __shfl_sync(0xffffffffu, at, leader) + __popc(peers & below);
      if (t < 0) continue;
      if (at < kDetRowCap)
        bucket[(size_t)t * kDetRowCap + at] = r;
      else
        spill[atomicAdd(count + tiles, 1)] = make_int2(t, r);
    }
  }
}

// Exclusive scan of count[0, n) into start[0, n], start[n] the total, by
// the whole block (n <= kDetMaxBuckets: at most four a thread).
__device__ __forceinline__ void det_block_scan(const int* count, int* start,
                                               int n, int* s_scan) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (n + kDetThreads - 1) / kDetThreads;
  const int lo = min(n, (int)threadIdx.x * per), hi = min(n, lo + per);
  int run = 0;
  for (int p = lo; p < hi; ++p) run += count[p];
  int incl = run;
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
    start[p] = base;
    base += count[p];
  }
  if (threadIdx.x == kDetThreads - 1) start[n] = base;
  __syncthreads();
}

// Step 4 (see the header): a block per (tile, group of slices), groups
// fastest, so that the blocks of one tile run together.
template <int VEC>
__global__ void __launch_bounds__(kDetThreads, 2)
    det_tile_kernel(const int2* __restrict__ corner_idx,
                    const float4* __restrict__ corner_w,
                    const float* __restrict__ dcols, float* dx,
                    const int* __restrict__ count,
                    const int* __restrict__ bucket,
                    const int2* __restrict__ spill, int R, int H, int W,
                    int C, DetPlan p) {
  extern __shared__ float4 smem4[];
  float* s_dc = reinterpret_cast<float*>(smem4);  // cap x kDetSlice
  // A pixel's entries: (offset of the row in a buffer, weight).
  int2* s_plist = reinterpret_cast<int2*>(s_dc + kDetRowCap * kDetSlice);
  float4* s_w = reinterpret_cast<float4*>(s_plist);  // by slot, until then
  float4* s_ow = reinterpret_cast<float4*>(s_plist + 4 * kDetRowCap);
  int* s_row = reinterpret_cast<int*>(s_ow + kDetRowCap);
  int* s_q = s_row + kDetRowCap;     // a slot's bucket
  int* s_rank = s_q + kDetRowCap;    // its rank as the bucket filled
  int* s_tmp = s_rank + kDetRowCap;  // the buckets' rows, unordered
  int* s_oj = s_tmp + kDetRowCap;    // slots in summing order
  int* s_hist = s_oj + kDetRowCap;
  int* s_qcount = s_hist + kDetBins;
  int* s_qstart = s_qcount + kDetMaxBuckets;
  // (pixel, corner) counts and starts, once the buckets are ordered.
  int* s_pcount = s_qcount;
  int* s_pstart = s_rank;  // over s_rank and s_tmp
  __shared__ int s_n, s_take, s_scan[kDetWarps];

  const int slice0 = (blockIdx.x % p.groups) * p.group;
  const int nslices = min(p.group, p.slices - slice0);
  const int tile = blockIdx.x / p.groups;
  const int tx = tile % p.tiles_across;
  const int ty = (tile / p.tiles_across) % p.tiles_down;
  const int b = tile / (p.tiles_across * p.tiles_down);
  const int y0 = ty * p.tile_h, x0 = tx * p.tile_w;
  // Bucket qy * qw + qx holds the rows whose top-left corner is pixel
  // (y0 - 1 + qy, x0 - 1 + qx).
  const int qw = p.tile_w + 1;
  const int nq = (p.tile_h + 1) * qw;
  const int npc = 4 * p.tile_h * p.tile_w;  // (pixel, corner) pairs
  // The tile's rows: its bucket, and past kDetRowCap the spill list's
  // pairs that name it.
  const int total = count[tile];
  const int kept = min(total, kDetRowCap);
  const int* rows = bucket + (size_t)tile * kDetRowCap;
  const int spilled = total > kDetRowCap ? count[gridDim.x / p.groups] : 0;
  const int keys = 4 * R;
  constexpr int kLanes = kDetSlice / VEC;  // lanes a row or pixel

  // Calls fn(i, r, corner, weights) for each of the tile's rows (i: its
  // place in the bucket, or -1 from the spill list), four a thread at
  // once, so that their loads are in flight together.
  auto each_row = [&](auto&& fn) {
    int i0 = 0;
    do {
      int r[4];
      int2 c[4];
      float4 w4[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + threadIdx.x + u * kDetThreads;
        // The bucket's load does not wait for the count: what lies past
        // the filed rows is read and dropped.
        const int filed = i < kDetRowCap ? rows[i] : -1;
        r[u] = -1;
        if (i < kept) {
          r[u] = filed;
        } else if (i < kept + spilled) {
          const int2 e = spill[i - kept];
          if (e.x == tile) r[u] = e.y;
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        c[u] = make_int2(0, 0);
        w4[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r[u] < 0) continue;
        const size_t row = (size_t)b * R + r[u];
        c[u] = corner_idx[row];
        w4[u] = corner_w[row];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + threadIdx.x + u * kDetThreads;
        if (r[u] >= 0) fn(i < kept ? i : -1, r[u], c[u], w4[u]);
      }
    } while ((i0 += 4 * kDetThreads) < kept + spilled);
  };

  // Row r's weights, each zeroed unless its corner lands in this tile (and
  // the map) with a non-zero weight and a key in [lo, hi); its bucket.
  auto corners = [&](int r, int2 c, float4 w4, int lo, int hi, int& q,
                     float4& kept) {
    float ws[4] = {w4.x, w4.y, w4.z, w4.w};
    const int ty0 = c.x - 1 - y0, tx0 = c.y - 1 - x0;  // tile coordinates
    bool any = false;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int py = ty0 + (k >> 1), px = tx0 + (k & 1);
      const int key = k * R + r;
      const bool keep = ws[k] != 0.f && py >= 0 && py < p.tile_h &&
                        px >= 0 && px < p.tile_w && y0 + py < H &&
                        x0 + px < W && key >= lo && key < hi;
      if (!keep) ws[k] = 0.f;
      any |= keep;
    }
    q = (ty0 + 1) * qw + tx0 + 1;
    kept = make_float4(ws[0], ws[1], ws[2], ws[3]);
    return any;
  };

  // Starts copying slice k of the n staged rows' dcols; commits a group
  // (empty past the last slice).
  auto copy_slice = [&](int k, int n) {
    if (k < nslices) {
      const int ch0 = (slice0 + k) * kDetSlice;
      for (int e = threadIdx.x; e < n * kLanes; e += kDetThreads) {
        const int j = e / kLanes, l = e - j * kLanes;
        const int ch = ch0 + l * VEC;
        const bool in = ch < C;
        copy_async<VEC>(
            s_dc + j * kDetSlice + l * VEC,
            in ? dcols + ((size_t)b * R + s_row[j]) * C + ch : dcols,
            in ? 4 * VEC : 0);
      }
    }
    asm volatile("cp.async.commit_group;");
  };

  // One round: the corners with keys in [lo, hi) (at most kDetRowCap rows
  // hold them; `all`: every row of the list, in list order), added onto dx
  // unless `fresh` (the first round stores).
  auto sum_round = [&](int lo, int hi, bool fresh, bool all) {
    for (int e = threadIdx.x; e < nq; e += kDetThreads) s_qcount[e] = 0;
    if (threadIdx.x == 0) s_n = 0;
    __syncthreads();
    each_row([&](int i, int r, int2 c, float4 w4) {
      int q;
      float4 w;
      if (!corners(r, c, w4, lo, hi, q, w)) return;
      const int j = all ? i : atomicAdd(&s_n, 1);
      s_row[j] = r;
      s_q[j] = q;
      s_w[j] = w;
      s_rank[j] = atomicAdd(s_qcount + q, 1);
    });
    __syncthreads();
    const int n = all ? kept : s_n;
    copy_slice(0, n);  // lands while the rows are ordered
    det_block_scan(s_qcount, s_qstart, nq, s_scan);
    for (int j = threadIdx.x; j < n; j += kDetThreads)
      s_tmp[s_qstart[s_q[j]] + s_rank[j]] = s_row[j];
    __syncthreads();
    // A row's place: its bucket's start plus the bucket's smaller rows.
    for (int j = threadIdx.x; j < n; j += kDetThreads) {
      const int q = s_q[j], r = s_row[j];
      const int e1 = s_qstart[q + 1];
      int at = s_qstart[q];
      for (int e = at; e < e1; ++e) at += s_tmp[e] < r;
      s_oj[at] = j;
      s_ow[at] = s_w[j];
    }
    __syncthreads();
    // Pixel pix's entries in key order: for kc = 0..3, corner kc of the
    // rows whose top-left is (pixel - kc), in row order, where its weight
    // is not 0 (a corner of weight 0 adds nothing).
    auto bucket = [&](int task) {
      const int pix = task >> 2, kc = task & 3;
      const int py = pix / p.tile_w, px = pix - py * p.tile_w;
      return (py + 1 - (kc >> 1)) * qw + px + 1 - (kc & 1);
    };
    for (int task = threadIdx.x; task < npc; task += kDetThreads) {
      const int q = bucket(task), kc = task & 3;
      int cnt = 0;
      for (int e = s_qstart[q]; e < s_qstart[q + 1]; ++e)
        cnt += reinterpret_cast<const float*>(s_ow + e)[kc] != 0.f;
      s_pcount[task] = cnt;
    }
    __syncthreads();
    det_block_scan(s_pcount, s_pstart, npc, s_scan);
    for (int task = threadIdx.x; task < npc; task += kDetThreads) {
      const int q = bucket(task), kc = task & 3;
      int at = s_pstart[task];
      for (int e = s_qstart[q]; e < s_qstart[q + 1]; ++e) {
        const float w = reinterpret_cast<const float*>(s_ow + e)[kc];
        if (w != 0.f)
          s_plist[at++] = make_int2(s_oj[e] * kDetSlice, __float_as_int(w));
      }
    }
    __syncthreads();
    for (int k = 0; k < nslices; ++k) {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
      __syncthreads();
      const int ch0 = (slice0 + k) * kDetSlice;
      for (int task = threadIdx.x; task < p.tile_h * p.tile_w * kLanes;
           task += kDetThreads) {
        const int pix = task / kLanes, l = task - pix * kLanes;
        const int py = pix / p.tile_w, px = pix - py * p.tile_w;
        const int ch = ch0 + l * VEC;
        if (y0 + py >= H || x0 + px >= W || ch >= C) continue;
        float* out = dx + (((size_t)b * H + y0 + py) * W + x0 + px) * C + ch;
        Vec<VEC> acc;
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc.v[v] = 0.f;
        if (!fresh) acc = *reinterpret_cast<const Vec<VEC>*>(out);
        const float* mine = s_dc + l * VEC;
        const int e1 = s_pstart[4 * pix + 4];
#pragma unroll 4
        for (int e = s_pstart[4 * pix]; e < e1; ++e) {
          const int2 en = s_plist[e];
          const float w = __int_as_float(en.y);
          const Vec<VEC> d = *reinterpret_cast<const Vec<VEC>*>(mine + en.x);
#pragma unroll
          for (int v = 0; v < VEC; ++v)
            acc.v[v] = __fadd_rn(acc.v[v], __fmul_rn(w, d.v[v]));
        }
        *reinterpret_cast<Vec<VEC>*>(out) = acc;
      }
      __syncthreads();  // before the next copy overwrites the buffer
      copy_slice(k + 1, n);
    }
  };

  if (total <= kDetRowCap) {
    sum_round(0, keys, true, true);
    return;
  }
  // More rows than a round holds: rounds of key ranges, each of at most
  // kDetRowCap corners (so of at most as many rows), taken greedily from a
  // histogram of the keys from lo on, which is refined to its first bin
  // while that bin alone holds more.
  bool fresh = true;
  int lo = 0;
  while (lo < keys) {
    int end = keys, width;
    for (;;) {
      width = (end - lo + kDetBins - 1) / kDetBins;
      for (int e = threadIdx.x; e < kDetBins; e += kDetThreads) s_hist[e] = 0;
      __syncthreads();
      each_row([&](int, int r, int2 c, float4 w4) {
        int q;
        float4 w;
        if (!corners(r, c, w4, lo, end, q, w)) return;
        const float ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (ws[k] != 0.f) atomicAdd(s_hist + (k * R + r - lo) / width, 1);
      });
      __syncthreads();
      const bool fits = s_hist[0] <= kDetRowCap;
      __syncthreads();
      if (fits) break;
      end = lo + width;
    }
    const int origin = lo;
    int bin = 0;
    while (lo < end) {
      if (threadIdx.x == 0) {
        int take = 0, sum = 0;
        while (bin + take < kDetBins &&
               sum + s_hist[bin + take] <= kDetRowCap)
          sum += s_hist[bin + take++];
        s_take = take;
      }
      __syncthreads();
      const int take = s_take;
      __syncthreads();
      if (take == 0) break;  // the next bin alone overflows: refine it
      bin += take;
      const int hi = (int)min((long long)end, origin + (long long)bin * width);
      sum_round(lo, hi, fresh, false);
      fresh = false;
      lo = hi;
    }
  }
}

int det_blocks(long long work, int per_block, int cap) {
  const long long b = (work + per_block - 1) / per_block;
  return static_cast<int>(b < cap ? (b > 0 ? b : 1) : cap);
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

// The deterministic variant (see the header): the same arguments as
// prn_dcn_scatter_f32 but for the plan, ops/dcn_scatter.py::DetPlan
// (tile_h, tile_w, group), and its workspace: count (tiles + 1 int32,
// zeroed), bucket (tiles * kDetRowCap int32) and spill (4*B*R int2, on an
// 8-byte boundary). dx (B, H, W, C) f32 is fully written. Returns the
// cudaError_t of the first launch that failed, else 0.
int prn_dcn_scatter_det_f32(const void* corner_idx, const void* corner_w,
                            const void* dcols, void* dx, void* count,
                            void* bucket, void* spill, int B, int R, int H,
                            int W, int C, int tile_h, int tile_w, int group,
                            void* stream) {
  const long long rows = (long long)B * R;
  if (B <= 0 || R <= 0 || H <= 0 || W <= 0 || C <= 0 || tile_h <= 0 ||
      tile_w <= 0 || group <= 0 || 4 * rows >= INT_MAX ||
      (long long)(tile_h + 1) * (tile_w + 1) > kDetMaxBuckets ||
      4LL * tile_h * tile_w > kDetMaxBuckets ||
      reinterpret_cast<uintptr_t>(corner_idx) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(corner_w) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(spill) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int slices = (C + kDetSlice - 1) / kDetSlice;
  DetPlan plan{tile_h, tile_w, (H + tile_h - 1) / tile_h,
               (W + tile_w - 1) / tile_w, slices, group,
               (slices + group - 1) / group};
  const long long tiles = (long long)B * plan.tiles_down * plan.tiles_across;
  if (tiles * plan.groups > INT_MAX || tiles * kDetRowCap > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int2* idx = static_cast<const int2*>(corner_idx);
  const float4* cw = static_cast<const float4*>(corner_w);
  int* cnt = static_cast<int*>(count);
  int* bk = static_cast<int*>(bucket);
  int2* sp = static_cast<int2*>(spill);
  det_bin_kernel<<<det_blocks(rows, kDetThreads, 132 * 8), kDetThreads, 0,
                   s>>>(idx, cw, cnt, bk, sp, static_cast<int>(tiles),
                        static_cast<int>(rows), R, H, W, plan);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  const float* dc = static_cast<const float*>(dcols);
  float* out = static_cast<float*>(dx);
  const bool vec = (C % 4) == 0 &&
                   reinterpret_cast<uintptr_t>(dcols) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  const int blocks = static_cast<int>(tiles * plan.groups);
  auto kernel = vec ? det_tile_kernel<4> : det_tile_kernel<1>;
  if (cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(kDetSmem)))
    return static_cast<int>(e);
  kernel<<<blocks, kDetThreads, kDetSmem, s>>>(idx, cw, dc, out, cnt, bk, sp,
                                              R, H, W, C, plan);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
