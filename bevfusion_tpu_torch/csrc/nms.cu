// The greedy pass of NMS over a suppression matrix, one block per problem.
//
//   keep_sorted = 1 everywhere;
//   for i in 0 .. n-1 (score rank):  if keep_sorted[i]:
//       keep_sorted[j] = 0 for every j > i with sup[i][j];
//   keep[order[j]] = keep_sorted[j]
//
// sup [P, n, n] (bool bytes) says, in score order, which detection
// suppresses which (circle NMS: squared center distance <= radius; rotated
// NMS: BEV IoU > threshold; ops/nms.py builds it with tensor ops); order
// [P, n] is the score order (a permutation of 0 .. n-1 per problem); keep
// [P, n] comes back in the original index order.
//
// Replaces the greedy pass of the JAX package's NMS,
// bevfusion_tpu/ops/nms.py:_greedy_suppress: one lax.fori_loop over score
// rank on the device. It is not a Pallas kernel; its plain PyTorch
// counterpart (ops/nms.py:greedy_suppress_plain) is a Python loop of n
// steps of a few launches each: 3,000 steps a frame at CenterHead's n = 500
// and six tasks. This kernel does a whole frame's task in one launch:
// one block per problem (P = the batch), so the 6 tasks of a frame are 6
// launches.
//
// What bounds it on an H100 SXM (at its full 700 W): the pass is n
// dependent steps (row i waits for every earlier row's suppressions), and
// it reads the n x n matrix once (250 KB at n = 500): at 3.35 TB/s that is
// 0.075 us, far below n steps of even one clock each (0.25 us at the
// 1.98 GHz SM clock). So the chain of steps bounds it, and the design
// keeps each step short:
// - the keep flags live in shared memory (n bytes);
// - a row that is already suppressed is skipped without a barrier (every
//   thread reads the same flag, which no thread writes between barriers:
//   a kept row's threads only clear flags j > i), so a problem pays one
//   barrier per kept row, not per row;
// - a kept row is read by the block's threads with neighbouring threads on
//   neighbouring bytes, from j = i + 1 on only; n above the block's 256
//   threads loops.
// Boolean in, boolean out: its result equals the plain version's bit for
// bit. Measured (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase 11b):
// 0.043 ms with 1 row kept to 0.205 ms with all 500 kept (~0.33 us more a
// kept row), 0.21 ms at n = 1000; the plain loop 18-38 ms. A bitmask or warp-vote form (one 64-bit word per 64 columns) would
// cut the bytes and the per-row work; whether it pays is measured later
// (PERF.md).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
greedy_suppress_kernel(const uint8_t* __restrict__ sup, const int64_t* __restrict__ order,
                       uint8_t* __restrict__ keep_out, int n) {
  extern __shared__ uint8_t keep[];  // [n]: keep flag per score rank
  const size_t p = blockIdx.x;
  const uint8_t* s = sup + p * n * n;
  for (int j = threadIdx.x; j < n; j += kThreads) keep[j] = 1;
  __syncthreads();
  for (int i = 0; i + 1 < n; ++i) {
    if (!keep[i]) continue;  // the same flag for every thread: no barrier needed
    const uint8_t* row = s + static_cast<size_t>(i) * n;
    for (int j = i + 1 + threadIdx.x; j < n; j += kThreads)
      if (row[j]) keep[j] = 0;
    __syncthreads();
  }
  const int64_t* ord = order + p * n;
  uint8_t* out = keep_out + p * n;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const int64_t o = ord[j];
    if (o >= 0 && o < n) out[o] = keep[j];
  }
}

}  // namespace

// sup [problems, n, n] uint8 (0 or 1), order [problems, n] int64 (a
// permutation of 0 .. n-1 per problem), keep [problems, n] uint8; all
// contiguous device memory, keep zeroed by the caller (an order entry
// outside 0 .. n-1 is skipped). 1 <= n <= 49152 (the flags in shared
// memory). Launches on `stream`, does not synchronise, and returns the
// launch's cudaError_t (0 on success).
extern "C" int bevf_greedy_suppress(const uint8_t* sup, const int64_t* order, uint8_t* keep,
                                    int problems, int n, void* stream) {
  if (problems < 1 || n < 1 || n > 49152) return static_cast<int>(cudaErrorInvalidValue);
  greedy_suppress_kernel<<<problems, kThreads, n, static_cast<cudaStream_t>(stream)>>>(
      sup, order, keep, n);
  return static_cast<int>(cudaGetLastError());
}
