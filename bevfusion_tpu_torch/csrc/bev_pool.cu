// LSS BEV pooling over precomputed intervals, fp32 (the BEVPoolv2 form).
//
//   out[cell[r], c] = sum_{i < len[r]} depth[ranks_depth[start[r] + i]]
//                                    * ctx[ranks_feat[start[r] + i], c]
//
// Frustum points that fall in the BEV grid are sorted by cell id once per
// calibration (models/vtransforms.py:build_pool_lut); a run of equal cell
// ids is one interval. Per frame only depth and ctx change, so the kernel
// does no sort and no atomics, and stores each covered cell's row once.
// Cells that no interval covers are left as the caller zeroed them.
//
// Replaces the TPU kernel bevfusion_tpu/ops/bev_pool_pallas.py:_kernel
// (reached through rank_segment_sum from the LUT pool). Its rank-space
// one-hot matmul, 1024-point chunks with a carry row, bf16 context with a
// hi/lo depth split and base-64 cell-id digits exist because the TPU
// has no cheap scatter or row gather; none of that is needed here.
//
// What bounds it on an H100: per point it reads two int32 ranks, one
// depth value and a ctx row (C * 4 B = 320 B at C = 80), and does C
// multiply-adds: well under one flop per byte, so bytes bound it. Counted
// once each, the inputs and the output grid (41.5 MB at the flagship, 360
// x 360 cells x 80 channels) bound it at 0.0198 ms. The kernel itself
// reads far more: every point gathers its whole ctx row, 504 MB a call at
// the flagship (P = 1,574,862), served from the 50 MB L2, which holds ctx
// (5.4 MB) and depth (8 MB). So its time is the L2 gather rate, and what
// the design controls is how many of those gathers are in flight.
//
// The first form gave each thread one (interval, channel) pair: at
// C = 80 a warp straddled two or three intervals of different lengths, and
// every thread reloaded the two ranks and the depth value of each point as
// dependent 4-byte loads before its ctx load (0.110 of the bound, 0.1804 ms
// on an NVIDIA H100 80GB HBM3 at 700 W). Its time, and that of a first
// warp-per-interval form (0.1801 ms), is set by the few long intervals,
// not by the gather rate: at the flagship the intervals hold 36 points on
// average, p99 160, at most 576, and chip_smoke.py phase 9 times the same
// kernel on the intervals of at most 64 points alone (85% of the points)
// and on all of them longest first. Within one warp a long interval is a
// serial chain of rank, depth and row loads. This form:
// - one warp per interval, four warps a block (small blocks: a block's
//   slot is freed as soon as its longest interval ends);
// - the warp loads the ranks of up to 64 points with two coalesced loads
//   (lane i: points i and 32 + i, both issued before either depth gather),
//   each lane gathers its points' depth values, and the loop over the
//   points takes both from the owning lane by __shfl_sync, so the only
//   loads in the loop are the ctx rows, independent of each other, and a
//   long interval waits on one rank and one depth round trip per 64 points;
// - a row is read by a group of lanes, each taking two 16-byte vectors
//   where C % 4 == 0 and ctx and out are 16-byte aligned (10 lanes a row
//   at C = 80), else one channel (C = 6: 6 lanes); the warp's groups (3 at
//   C = 80) read different points at once, each with 4 steps unrolled, so
//   a long interval walks its points 12 rows at a time; the groups' sums
//   are added in group order (no atomics: two calls give equal bits);
//   C > 256 runs in channel blocks. Four warps a block and 4 steps were the
//   fastest of 2, 4 and 8 warps and 4 and 8 steps in a sweep on the card;
// - an index outside its array is skipped in the loop and asserted on once
//   after it: an assert inside the loop made the first form 25% slower on
//   an H100 at the flagship's shape.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase 9, the
// wrapper's call with its 41.5 MB zero fill of 0.0226 ms): 0.1196 ms,
// 0.166 of the bound; with the intervals longest first 0.1017 ms, so part
// of the rest is still the long intervals' tail.

#include <cassert>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // intervals a block: a block's slot frees when its longest ends
constexpr int kThreads = 32 * kWarps;
constexpr int kRanks = 2;  // points a lane loads the ranks of, a round

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  static constexpr int kPerLane = 1;  // vectors of a row a lane reads
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ void fma(T& acc, float d, const T& v) {
    acc = fmaf(d, v, acc);
  }
  static __device__ __forceinline__ T shfl(const T& v, int src) {
    return __shfl_sync(0xffffffffu, v, src);
  }
  static __device__ __forceinline__ void add(T& acc, const T& v) { acc += v; }
};
template <>
struct Vec<4> {
  using T = float4;
  static constexpr int kPerLane = 2;
  static __device__ __forceinline__ T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ void fma(T& acc, float d, const T& v) {
    acc.x = fmaf(d, v.x, acc.x);
    acc.y = fmaf(d, v.y, acc.y);
    acc.z = fmaf(d, v.z, acc.z);
    acc.w = fmaf(d, v.w, acc.w);
  }
  static __device__ __forceinline__ T shfl(const T& v, int src) {
    return make_float4(__shfl_sync(0xffffffffu, v.x, src), __shfl_sync(0xffffffffu, v.y, src),
                       __shfl_sync(0xffffffffu, v.z, src), __shfl_sync(0xffffffffu, v.w, src));
  }
  static __device__ __forceinline__ void add(T& acc, const T& v) {
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
};

template <int VEC>
__global__ void __launch_bounds__(kThreads)
bev_pool_f32_kernel(const float* __restrict__ depth, const float* __restrict__ ctx,
                    const int* __restrict__ ranks_depth, const int* __restrict__ ranks_feat,
                    const int* __restrict__ starts, const int* __restrict__ lengths,
                    const int* __restrict__ cells, float* __restrict__ out, int num_intervals,
                    int channels, int depth_size, int ctx_rows, int num_cells) {
  using V = Vec<VEC>;
  using T = typename V::T;
  constexpr int PL = V::kPerLane;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= num_intervals) return;  // the same for the whole warp
  const int cell = cells[r];
  assert(cell >= 0 && cell < num_cells);
  const int begin = starts[r], end = begin + lengths[r];
  const int row_vecs = channels / VEC;
  const T* ctx_v = reinterpret_cast<const T*>(ctx);
  T* out_v = reinterpret_cast<T*>(out + static_cast<size_t>(cell) * channels);
  bool in_bounds = true;
  for (int c0 = 0; c0 < row_vecs; c0 += 32 * PL) {  // channel blocks: one at C <= 256
    // lp lanes read one point's vectors [c0, c0 + nv), groups of them read
    // `groups` points at once; the rest of the warp idles
    const int nv = min(row_vecs - c0, 32 * PL);
    const int lp = (nv + PL - 1) / PL, groups = 32 / lp;
    const int grp = lane / lp, sub = lane - grp * lp;
    const bool active = grp < groups;
    T acc[PL];
#pragma unroll
    for (int v = 0; v < PL; ++v) acc[v] = V::zero();
    for (int i0 = begin; i0 < end; i0 += 32 * kRanks) {
      // points i0 + 32 q + lane, q < kRanks: their ctx rows (-1 where out of
      // range) and depth values, the rank loads of all of them issued first
      int rd[kRanks], rf[kRanks];
      float d[kRanks];
#pragma unroll
      for (int q = 0; q < kRanks; ++q) {
        const int i = i0 + 32 * q + lane;
        rd[q] = i < end ? ranks_depth[i] : 0;
        rf[q] = i < end ? ranks_feat[i] : -1;
      }
#pragma unroll
      for (int q = 0; q < kRanks; ++q) {
        d[q] = 0.f;
        if (i0 + 32 * q + lane < end) {
          const bool ok = static_cast<unsigned>(rd[q]) < static_cast<unsigned>(depth_size) &&
                          static_cast<unsigned>(rf[q]) < static_cast<unsigned>(ctx_rows);
          in_bounds &= ok;
          if (ok)
            d[q] = depth[rd[q]];
          else
            rf[q] = -1;
        }
      }
      const int n = min(32 * kRanks, end - i0), steps = (n + groups - 1) / groups;
#pragma unroll 4  // steps of a lane group in flight
      for (int t = 0; t < steps; ++t) {  // group grp takes points grp, grp + groups, ...
        const int j = t * groups + grp;
        int rf_j = -1;
        float d_j = 0.f;
#pragma unroll
        for (int q = 0; q < kRanks; ++q) {  // point j is lane j % 32's q = j / 32
          const int rf_q = __shfl_sync(0xffffffffu, rf[q], j & 31);
          const float d_q = __shfl_sync(0xffffffffu, d[q], j & 31);
          if ((j >> 5) == q) {
            rf_j = rf_q;
            d_j = d_q;
          }
        }
        if (active && j < n && rf_j >= 0) {
          const T* row = ctx_v + static_cast<size_t>(rf_j) * row_vecs + c0 + sub * PL;
#pragma unroll
          for (int v = 0; v < PL; ++v)
            if (sub * PL + v < nv) V::fma(acc[v], d_j, row[v]);
        }
      }
    }
    // the groups' sums into group 0, in group order
    for (int g = 1; g < groups; ++g) {
#pragma unroll
      for (int v = 0; v < PL; ++v) {
        const T other = V::shfl(acc[v], (lane + g * lp) & 31);
        if (grp == 0) V::add(acc[v], other);
      }
    }
    if (grp == 0) {
#pragma unroll
      for (int v = 0; v < PL; ++v)
        if (sub * PL + v < nv) out_v[c0 + sub * PL + v] = acc[v];
    }
  }
  assert(in_bounds);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

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
  const unsigned blocks = static_cast<unsigned>((num_intervals + kWarps - 1) / kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (channels % 4 == 0 && aligned16(ctx) && aligned16(out))
    bev_pool_f32_kernel<4><<<blocks, kThreads, 0, s>>>(
        depth, ctx, ranks_depth, ranks_feat, starts, lengths, cells, out, num_intervals,
        channels, depth_size, ctx_rows, num_cells);
  else
    bev_pool_f32_kernel<1><<<blocks, kThreads, 0, s>>>(
        depth, ctx, ranks_depth, ranks_feat, starts, lengths, cells, out, num_intervals,
        channels, depth_size, ctx_rows, num_cells);
  return static_cast<int>(cudaGetLastError());
}
