// The auction matcher (Hungarian assignment of the TransFusion head), every
// round of a problem in one block, every problem of a call in one launch.
//
//   price[j] = 0, owner[j] = -1, assign[r] = -1;  it = 0
//   while it < max_iters and some valid row r has assign[r] < 0:
//       for each such (bidding) row r:
//           net[j] = value[r][j] - price[j]
//           best_j[r] = the first j of the largest net, best = net[best_j]
//           second = the largest net[j] over j != best_j (-inf where C = 1)
//           bid[r] = (best - second) + eps
//       col_best[j] = the largest bid[r] over bidding rows with best_j[r] = j
//       win[j] = the lowest bidding row with best_j[r] = j and bid[r] == col_best[j]
//       where a column has a winner: price[j] += col_best[j], owner[j] = win[j]
//       assign = the inverse of owner;  it += 1
//   assign[r] = -1 for invalid rows;  out: assign, price, it
//
// Replaces no Pallas kernel: the JAX package runs this loop as one
// lax.while_loop on the device (bevfusion_tpu/core/matching.py:93, body
// :59-91, stop test :54-57), the design its docstring states: no host sync
// in the middle of a train step. The port's plain version
// (core/matching.py:auction_assignment_plain) issues ~12 launches a round
// and reads the stop flag on the host every 8 rounds; at random init the
// auction runs all 2000 rounds on 64 ground truths, ~24,000 launches a call.
//
// What bounds it on an H100 SXM (at its full 700 W): the rounds are
// dependent (a round's prices decide the next one's bids), so a problem is
// one chain of `rounds` steps, against its bytes (value read once, assign
// and price written once) over 3.35 TB/s; the chain sets the bound, one
// step at one SM clock each (1980 MHz), the rule of N2 and D2. The design
// keeps a round short and the host out of it:
// - one block of 1024 threads a problem; value (R x C fp32) staged in
//   shared memory where it fits with the scratch (R = 140, C = 200: 112 KB),
//   else read from global memory (L2) every round; price, owner, assign and
//   the round's scratch (col_best, win, best_j, bid) always in shared memory;
// - a warp a bidding row: each lane keeps a top-2 of its columns (best, its
//   first index, second; a tie with the best counts as the second), merged
//   by a butterfly of shuffles that keeps the lower index of equal bests
//   and the larger of the other values, as torch.max(dim) and the JAX
//   argmax with net.at[r, best_j].set(-inf) do;
// - the column max of the bids by atomicMax on their int bits in shared
//   memory: bids are >= 0, +inf or NaN (C = 1: inf - inf), so the int order
//   is the float order and NaN, above +inf, equals no bid as in the plain
//   version; the winner is the lowest row by atomicMin; the column pass
//   updates price, owner and assign in place (a row owns at most one
//   column, so the writes never collide);
// - the stop test by __syncthreads_or each round, on the device;
// - every subtraction and addition rounded on its own (__fsub_rn,
//   __fadd_rn) with eps computed once by the torch prologue, so assign,
//   price and the rounds equal the plain version's bit for bit.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;  // the dynamic shared memory a block may take
constexpr unsigned kFull = 0xffffffffu;

// a lane's top-2 over its columns (taken in increasing j)
struct Top2 {
  float best;
  int j;
  float second;
};

__device__ __forceinline__ void take(Top2& t, float v, int j) {
  if (v > t.best) {
    t.second = t.best;
    t.best = v;
    t.j = j;
  } else if (v > t.second) {
    t.second = v;
  }
}

// every lane ends with the warp's top-2: the larger best (of equal ones the
// lower index), the second the largest of the seconds and the other best
__device__ __forceinline__ void merge(Top2& t) {
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    const float ob = __shfl_xor_sync(kFull, t.best, off);
    const int oj = __shfl_xor_sync(kFull, t.j, off);
    const float os = __shfl_xor_sync(kFull, t.second, off);
    const bool theirs = ob > t.best || (ob == t.best && oj < t.j);
    const float lost = theirs ? t.best : ob;
    float s = t.second > os ? t.second : os;
    s = s > lost ? s : lost;
    if (theirs) {
      t.best = ob;
      t.j = oj;
    }
    t.second = s;
  }
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
auction_kernel(const float* __restrict__ value_g, const uint8_t* __restrict__ row_valid_g,
               const float* __restrict__ eps_g, int R, int C, int max_iters,
               int64_t* __restrict__ assign_out, float* __restrict__ price_out,
               int* __restrict__ rounds_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* price = reinterpret_cast<float*>(smem);
  int* col_best = reinterpret_cast<int*>(price + C);  // the bids' int bits; INT_MIN: none
  int* win = col_best + C;                            // R: none
  int* owner = win + C;
  int* assign = owner + C;
  int* best_j = assign + R;
  float* bid = reinterpret_cast<float*>(best_j + R);
  float* value_s = bid + R;

  const int n = blockIdx.x;
  const float* vg = value_g + static_cast<size_t>(n) * R * C;
  const float* value = kStaged ? value_s : vg;
  const uint8_t* row_valid = row_valid_g + static_cast<size_t>(n) * R;
  const float eps = eps_g[n];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int j = threadIdx.x; j < C; j += kThreads) {
    price[j] = 0.0f;
    col_best[j] = INT_MIN;
    win[j] = R;
    owner[j] = -1;
  }
  for (int r = threadIdx.x; r < R; r += kThreads) assign[r] = -1;
  if (kStaged)
    for (size_t k = threadIdx.x; k < static_cast<size_t>(R) * C; k += kThreads)
      value_s[k] = vg[k];
  __syncthreads();

  int it = 0;
  for (;;) {
    // the stop test, taken on the device: every thread sees the same answer
    int bidding = 0;
    for (int r = threadIdx.x; r < R; r += kThreads) bidding |= assign[r] < 0 && row_valid[r];
    if (!__syncthreads_or(bidding) || it >= max_iters) break;

    // bids: a warp a bidding row
    for (int r = warp; r < R; r += kWarps) {
      if (assign[r] >= 0 || !row_valid[r]) continue;  // the same for the whole warp
      const float* vr = value + static_cast<size_t>(r) * C;
      Top2 t{-CUDART_INF_F, INT_MAX, -CUDART_INF_F};
      for (int j = lane; j < C; j += 32) {
        const float v = __fsub_rn(vr[j], price[j]);
        if (j == lane) {  // the lane's first column, whatever its value (all -inf: index 0)
          t.best = v;
          t.j = j;
        } else {
          take(t, v, j);
        }
      }
      merge(t);
      if (lane == 0) {
        const float b = __fadd_rn(__fsub_rn(t.best, t.second), eps);
        bid[r] = b;
        best_j[r] = t.j;
        atomicMax(&col_best[t.j], __float_as_int(b));
      }
    }
    __syncthreads();

    // the winner of each column: the lowest row whose bid is the column's best
    for (int r = threadIdx.x; r < R; r += kThreads) {
      if (assign[r] < 0 && row_valid[r]) {
        const int j = best_j[r];
        if (__int_as_float(col_best[j]) == bid[r]) atomicMin(&win[j], r);
      }
    }
    __syncthreads();

    // prices, owners and assignments where a column was won; the scratch reset
    for (int j = threadIdx.x; j < C; j += kThreads) {
      const int w = win[j];
      if (w < R) {
        price[j] = __fadd_rn(price[j], __int_as_float(col_best[j]));
        const int o = owner[j];
        if (o >= 0) assign[o] = -1;
        assign[w] = j;
        owner[j] = w;
      }
      col_best[j] = INT_MIN;
      win[j] = R;
    }
    __syncthreads();
    ++it;
  }

  for (int r = threadIdx.x; r < R; r += kThreads)
    assign_out[static_cast<size_t>(n) * R + r] = row_valid[r] ? assign[r] : -1;
  for (int j = threadIdx.x; j < C; j += kThreads)
    price_out[static_cast<size_t>(n) * C + j] = price[j];
  if (threadIdx.x == 0) rounds_out[n] = it;
}

size_t scratch_bytes(int R, int C) {
  return 16 * static_cast<size_t>(C) + 12 * static_cast<size_t>(R);
}

// The shared memory a block takes: the scratch, plus value where `stage`
// asks for it and it fits (ops/auction.py:value_staged). 0 where even the
// scratch does not fit.
size_t smem_bytes(int R, int C, int stage) {
  const size_t scratch = scratch_bytes(R, C);
  const size_t staged = scratch + 4 * static_cast<size_t>(R) * C;
  if (stage && staged <= kMaxSmem) return staged;
  return scratch <= kMaxSmem ? scratch : 0;
}

}  // namespace

// N problems, each value [R, C] fp32 (row-major), row_valid [R] bool, eps
// one fp32; out assign [N, R] int64, price [N, C] fp32, rounds [N] int32.
// `stage` 1: value in shared memory where it fits; 0: read from global memory.
extern "C" int bevf_auction(const float* value, const uint8_t* row_valid, const float* eps,
                            int N, int R, int C, int max_iters, int stage, int64_t* assign,
                            float* price, int* rounds, void* stream) {
  if (N < 1 || R < 1 || C < 1 || max_iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_bytes(R, C, stage);
  if (bytes == 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool staged = bytes > scratch_bytes(R, C);
  auto kernel = staged ? auction_kernel<true> : auction_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<N, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      value, row_valid, eps, R, C, max_iters, assign, price, rounds);
  return static_cast<int>(cudaGetLastError());
}
