// LSS BEV pooling over precomputed intervals, fp32 (the BEVPoolv2 form).
//
//   out[cell[r], c] = sum_{i < len[r]} depth[ranks_depth[start[r] + i]]
//                                    * ctx[ranks_feat[start[r] + i], c]
//
// Frustum points that fall in the BEV grid are sorted by cell id once per
// calibration (models/vtransforms.py:build_pool_lut); a run of equal cell
// ids is one interval. Per frame
// only depth and ctx change, so the kernel does no sort and no atomics:
// one thread owns one (interval, channel) pair, sums the interval's
// points in a register and stores its output element once. Cells that no
// interval covers are left as the caller zeroed them.
//
// Replaces the TPU kernel bevfusion_tpu/ops/bev_pool_pallas.py:_kernel
// (reached through rank_segment_sum from the LUT pool). Its rank-space
// one-hot matmul, 1024-point chunks with a carry row, bf16 context with a
// hi/lo depth split and base-64 cell-id digits exist because the TPU
// has no cheap scatter or row gather; none of that is needed here.
//
// What bounds it on an H100: per point it reads two int32 ranks, one
// depth value and a ctx row (C * 4 B = 320 B at C = 80), and does C
// multiply-adds: well under one flop per byte, so it is bound by memory.
// ctx at the flagship (6 * 32 * 88 rows x 80 ch x 4 B = 5.4 MB) and depth
// (8 MB) fit in the 50 MB L2, so the row gathers are served from L2.
// Layout: ctx is channels-last [rows, C] and consecutive threads take
// consecutive channels of one interval, so a warp's ctx loads and output
// stores are 128-byte coalesced and the per-point ranks and depth value
// are one broadcast load for the warp.

#include <cassert>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
bev_pool_f32_kernel(const float* __restrict__ depth, const float* __restrict__ ctx,
                    const int* __restrict__ ranks_depth, const int* __restrict__ ranks_feat,
                    const int* __restrict__ starts, const int* __restrict__ lengths,
                    const int* __restrict__ cells, float* __restrict__ out, int num_intervals,
                    int channels, int depth_size, int ctx_rows, int num_cells) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<long long>(num_intervals) * channels) return;
  const int r = static_cast<int>(t / channels);
  const int c = static_cast<int>(t % channels);
  const int cell = cells[r];
  assert(cell >= 0 && cell < num_cells);
  const int begin = starts[r], end = begin + lengths[r];
  float acc = 0.f;
  // An index outside its array is skipped in the loop and asserted on once
  // after it: an assert inside the loop made the kernel 25% slower than
  // this on an H100 at the flagship's shape.
  bool in_bounds = true;
  for (int i = begin; i < end; ++i) {
    const int rd = ranks_depth[i], rf = ranks_feat[i];
    const bool ok = static_cast<unsigned>(rd) < static_cast<unsigned>(depth_size) &&
                    static_cast<unsigned>(rf) < static_cast<unsigned>(ctx_rows);
    in_bounds &= ok;
    if (ok) acc = fmaf(depth[rd], ctx[static_cast<size_t>(rf) * channels + c], acc);
  }
  assert(in_bounds);
  out[static_cast<size_t>(cell) * channels + c] = acc;
}

}  // namespace

// depth [depth_size], ctx [ctx_rows, channels], ranks_depth / ranks_feat
// [num_points] int32, starts / lengths / cells [num_intervals] int32,
// out [num_cells, channels]; all contiguous device memory, out zeroed by
// the caller. Launches on `stream`, does not synchronise, and returns the
// launch's cudaError_t (0 on success). An index outside its array trips a
// device-side assert (cudaErrorAssert at the next synchronisation), as
// PyTorch's own CUDA index kernels do.
extern "C" int bevf_bev_pool_f32(const float* depth, const float* ctx, const int* ranks_depth,
                                 const int* ranks_feat, const int* starts, const int* lengths,
                                 const int* cells, float* out, int num_intervals, int channels,
                                 int depth_size, int ctx_rows, int num_cells, void* stream) {
  if (num_intervals < 1 || channels < 1 || depth_size < 0 || ctx_rows < 0 || num_cells < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long threads = static_cast<long long>(num_intervals) * channels;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  bev_pool_f32_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      depth, ctx, ranks_depth, ranks_feat, starts, lengths, cells, out, num_intervals, channels,
      depth_size, ctx_rows, num_cells);
  return static_cast<int>(cudaGetLastError());
}
