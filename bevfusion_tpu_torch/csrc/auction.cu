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
// step at one SM clock each (1980 MHz), the rule of N2 and D2. A round's
// fixed cost is what the design cuts (its first form, with four barriers,
// a warp a bidding row and a second pass for the winning row, spent
// 3,300-3,700 cycles a round on an H100 SXM, 2,100 of them finding the
// winner; PERF.md section 6):
// - one block a problem, `lanes` threads a row (ops/auction.py:auction_plan:
//   the largest power of two <= 32 with R * lanes <= 1024: 16 at R = 64, 4
//   at R = 140), the block sized to R * lanes threads, so every bidding row
//   bids at once; value (R x C fp32, rows padded to `ldv` floats so the row
//   groups of a warp read distinct banks; the valid rows only) staged in
//   shared memory where it fits, else read from global memory (L2) every
//   round; four columns a load where C is a multiple of 4; price, owner,
//   assign and the column keys always in shared memory;
// - a row's lanes each keep a top-2 of their columns (best, its first
//   index, second; a tie with the best counts as the second), merged by a
//   butterfly of shuffles that keeps the lower index of equal bests and the
//   larger of the other values, as torch.max(dim) and the JAX argmax with
//   net.at[r, best_j].set(-inf) do; both with min, max and one select, no
//   branch (with branches a round took 1.6x as long), and a warp with no
//   bidding row skips the merge;
// - the column's best bid and its winning row in one 64-bit shared-memory
//   atomicMax on (bid bits << 32) | (0xFFFFFFFF - r): bids are > 0 (eps >
//   0), +inf or NaN (C = 1: inf - inf), so the unsigned order of the high
//   word is the float order with NaN above +inf, and of equal bids the
//   lowest row wins; a column whose best is NaN gets no winner, as the
//   plain version's NaN == NaN; key 0 is "no bid";
// - the stop test is the count of unassigned valid rows, kept exact: a
//   won column that had no owner takes one off, a displaced owner leaves
//   it as it was. Two barriers a round: after the bids, after the columns;
// - every subtraction and addition rounded on its own (__fsub_rn,
//   __fadd_rn) with eps computed once by the torch prologue, so assign,
//   price and the rounds equal the plain version's bit for bit.
//
// The probe form (kProbe) also writes, for block 0, thread 0's clock64() at
// each phase boundary of every round, each warp's arrival at the two
// barriers, and each bidding row's scan, merge and key
// (ops/auction.py:auction_probe).

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxSmem = 232448;  // the dynamic shared memory a block may take
constexpr unsigned kFull = 0xffffffffu;
// a round's probe record, every word a clock64() read by the warp it names: thread 0's 6
// stamps (the round's start, its scan's end, its key's, the bid barrier's release, its column
// pass's end, the column barrier's release), each warp's arrival at the bid barrier and at
// the column barrier (2 x 32 words), then each bidding row's start of its scan and end of its
// scan, merge and key (4 words a row; 0: the row did not bid); plain stores, so the record
// does not delay what it measures
constexpr int kProbeStamps = 6, kProbeWarps = 32, kProbeRowWords = 4;
__host__ __device__ inline size_t probe_words(int R) {
  return kProbeStamps + 2 * kProbeWarps + kProbeRowWords * static_cast<size_t>(R);
}

// a lane's top-2 over its columns (taken in increasing j)
struct Top2 {
  float best;
  int j;
  float second;
};

__device__ __forceinline__ void take(Top2& t, float v, int j) {
  // min / max and one select, no branch (no NaN here: value is finite, a
  // price finite or +inf): a larger v moves best to second, an equal or
  // smaller one competes for second
  t.j = v > t.best ? j : t.j;
  t.second = fmaxf(t.second, fminf(t.best, v));
  t.best = fmaxf(t.best, v);
}

// every lane of a G-lane group ends with the group's top-2: the larger best
// (of equal ones the lower index), the second the largest of the seconds and
// the other best. Every lane of the warp takes part.
template <int G>
__device__ __forceinline__ void merge(Top2& t) {
#pragma unroll
  for (int off = G / 2; off; off >>= 1) {
    const float ob = __shfl_xor_sync(kFull, t.best, off);
    const int oj = __shfl_xor_sync(kFull, t.j, off);
    const float os = __shfl_xor_sync(kFull, t.second, off);
    t.j = ob > t.best || (ob == t.best && oj < t.j) ? oj : t.j;
    t.second = fmaxf(fmaxf(t.second, os), fminf(t.best, ob));
    t.best = fmaxf(t.best, ob);
  }
}

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~static_cast<size_t>(15); }

// scratch: keys (8 C), price (4 C), owner (4 C), assign (4 R), the count
__host__ __device__ inline size_t scratch_bytes(int R, int C) {
  return align16(16 * static_cast<size_t>(C) + 4 * static_cast<size_t>(R) + 4);
}

template <int G, bool kStaged, bool kProbe>
__global__ void __launch_bounds__(kMaxThreads)
auction_kernel(const float* __restrict__ value_g, const uint8_t* __restrict__ row_valid_g,
               const float* __restrict__ eps_g, int R, int C, int ldv, int max_iters,
               int64_t* __restrict__ assign_out, float* __restrict__ price_out,
               int* __restrict__ rounds_out, long long* __restrict__ probe) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);  // 0: no bid
  float* price = reinterpret_cast<float*>(keys + C);
  int* owner = reinterpret_cast<int*>(price + C);
  int* assign = owner + C;  // -2: an invalid row (never bids), -1: unassigned
  int* counters = assign + R;  // [0] unassigned valid rows
  float* value_s = reinterpret_cast<float*>(smem + scratch_bytes(R, C));

  const int n = blockIdx.x, tid = threadIdx.x, nthreads = blockDim.x;
  const float* vg = value_g + static_cast<size_t>(n) * R * C;
  const float* value = kStaged ? value_s : vg;
  const uint8_t* row_valid = row_valid_g + static_cast<size_t>(n) * R;
  const float eps = eps_g[n];
  const int groups = nthreads / G, group = tid / G, gl = tid % G;
  // value rows and price as float4 where every row starts 16-byte aligned
  const bool vec4 = C % 4 == 0 && ldv % 4 == 0 &&
                    (reinterpret_cast<uintptr_t>(value) & 15) == 0;
  const int C4 = C / 4;

  if (tid == 0) counters[0] = 0;
  for (int j = tid; j < C; j += nthreads) {
    keys[j] = 0;
    price[j] = 0.0f;
    owner[j] = -1;
  }
  int valid = 0;
  for (int r = tid; r < R; r += nthreads) {
    const bool v = row_valid[r] != 0;
    assign[r] = v ? -1 : -2;
    valid += v;
  }
  if (kStaged) {  // the valid rows only (no other row bids), a warp a row
    const int warp = tid >> 5, lane = tid & 31, warps = nthreads >> 5;
    const bool v4 = C % 4 == 0 && ldv % 4 == 0 && (reinterpret_cast<uintptr_t>(vg) & 15) == 0;
    for (int r = warp; r < R; r += warps) {
      if (!row_valid[r]) continue;
      float* dst = value_s + static_cast<size_t>(r) * ldv;
      const float* src = vg + static_cast<size_t>(r) * C;
      if (v4)
        for (int q = lane; q < C / 4; q += 32)
          reinterpret_cast<float4*>(dst)[q] = reinterpret_cast<const float4*>(src)[q];
      else
        for (int j = lane; j < C; j += 32) dst[j] = src[j];
    }
  }
  __syncthreads();
  if (valid) atomicAdd(&counters[0], valid);
  __syncthreads();

  const bool record = kProbe && n == 0, stamp = record && tid == 0;
  long long* ps = nullptr;
  int it = 0;
  while (it < max_iters && counters[0] > 0) {  // the same for every thread
    if (record) ps = probe + probe_words(R) * it;
    if (stamp) ps[0] = clock64();

    // bids: a G-lane group a row, every bidding row at once
    for (int base = 0; base < R; base += groups) {  // the same trip count for every thread
      const int r = base + group;
      const bool bids = r < R && assign[r] == -1;  // the same for the whole group
      Top2 t{-CUDART_INF_F, INT_MAX, -CUDART_INF_F};
      long long* pr = record ? ps + kProbeStamps + 2 * kProbeWarps + kProbeRowWords * r : nullptr;
      if (record && bids && gl == 0) pr[0] = clock64();
      if (bids) {
        const float* vr = value + static_cast<size_t>(r) * ldv;
        if (vec4) {  // four columns a load: lane gl takes columns 4q..4q+3, q = gl, gl + G, ...
          const float4* v4 = reinterpret_cast<const float4*>(vr);
          const float4* p4 = reinterpret_cast<const float4*>(price);
          if (gl < C4) {  // the lane's first column, whatever its value
            const float4 a = v4[gl], b = p4[gl];
            t.best = __fsub_rn(a.x, b.x);
            t.j = 4 * gl;
            take(t, __fsub_rn(a.y, b.y), 4 * gl + 1);
            take(t, __fsub_rn(a.z, b.z), 4 * gl + 2);
            take(t, __fsub_rn(a.w, b.w), 4 * gl + 3);
          }
#pragma unroll(kStaged ? 2 : 1)  // the global form: no spill at 64 registers
          for (int q = gl + G; q < C4; q += G) {
            const float4 a = v4[q], b = p4[q];
            take(t, __fsub_rn(a.x, b.x), 4 * q);
            take(t, __fsub_rn(a.y, b.y), 4 * q + 1);
            take(t, __fsub_rn(a.z, b.z), 4 * q + 2);
            take(t, __fsub_rn(a.w, b.w), 4 * q + 3);
          }
        } else {
          if (gl < C) {  // the lane's first column, whatever its value (all -inf: index 0)
            t.best = __fsub_rn(vr[gl], price[gl]);
            t.j = gl;
          }
#pragma unroll 4
          for (int j = gl + G; j < C; j += G) take(t, __fsub_rn(vr[j], price[j]), j);
        }
      }
      if (stamp && base == 0) ps[1] = clock64();
      if (record && bids && gl == 0) pr[1] = clock64();
      if (__any_sync(kFull, bids)) merge<G>(t);  // a warp with no bidding row goes on
      if (bids && gl == 0) {
        if (record) pr[2] = clock64();
        const float b = __fadd_rn(__fsub_rn(t.best, t.second), eps);
        atomicMax(&keys[t.j], (static_cast<unsigned long long>(__float_as_uint(b)) << 32) |
                                  (0xFFFFFFFFu - static_cast<unsigned>(r)));
        if (record) pr[3] = clock64();
      }
      if (stamp && base == 0) ps[2] = clock64();
    }
    if (record && (tid & 31) == 0) ps[kProbeStamps + (tid >> 5)] = clock64();
    __syncthreads();
    if (stamp) ps[3] = clock64();

    // the columns: price, owner and assignment where a column was won; the
    // keys reset; the unassigned count less the columns won without an owner
    int fresh = 0;
    for (int j = tid; j < C; j += nthreads) {
      const unsigned long long k = keys[j];
      if (k == 0) continue;
      keys[j] = 0;
      const unsigned bits = static_cast<unsigned>(k >> 32);
      if (bits > 0x7f800000u) continue;  // a NaN bid: no winner
      const int w = static_cast<int>(0xFFFFFFFFu - static_cast<unsigned>(k));
      price[j] = __fadd_rn(price[j], __uint_as_float(bits));
      const int o = owner[j];
      if (o >= 0)
        assign[o] = -1;  // never a winner: an owner does not bid
      else
        ++fresh;
      assign[w] = j;
      owner[j] = w;
    }
    if (fresh) atomicSub(&counters[0], fresh);
    if (stamp) ps[4] = clock64();
    if (record && (tid & 31) == 0) ps[kProbeStamps + kProbeWarps + (tid >> 5)] = clock64();
    __syncthreads();
    if (stamp) ps[5] = clock64();
    ++it;
  }

  for (int r = tid; r < R; r += nthreads)
    assign_out[static_cast<size_t>(n) * R + r] = assign[r] >= 0 ? assign[r] : -1;
  for (int j = tid; j < C; j += nthreads) price_out[static_cast<size_t>(n) * C + j] = price[j];
  if (tid == 0) rounds_out[n] = it;
}

// a block's shape, as ops/auction.py:auction_plan chooses it
struct Launch {
  int threads, ldv;
  size_t bytes;
};

template <int G, bool kStaged, bool kProbe>
int launch(const Launch& l, const float* value, const uint8_t* row_valid, const float* eps, int N,
           int R, int C, int max_iters, int64_t* assign, float* price, int* rounds,
           long long* probe, cudaStream_t stream) {
  auto kernel = auction_kernel<G, kStaged, kProbe>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(l.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<N, l.threads, l.bytes, stream>>>(value, row_valid, eps, R, C, l.ldv, max_iters,
                                            assign, price, rounds, probe);
  return static_cast<int>(cudaGetLastError());
}

template <int G>
int launch_lanes(const Launch& l, bool staged, const float* value, const uint8_t* row_valid,
                 const float* eps, int N, int R, int C, int max_iters, int64_t* assign,
                 float* price, int* rounds, long long* probe, cudaStream_t s) {
  if (probe)
    return staged ? launch<G, true, true>(l, value, row_valid, eps, N, R, C, max_iters, assign,
                                          price, rounds, probe, s)
                  : launch<G, false, true>(l, value, row_valid, eps, N, R, C, max_iters, assign,
                                           price, rounds, probe, s);
  return staged ? launch<G, true, false>(l, value, row_valid, eps, N, R, C, max_iters, assign,
                                         price, rounds, probe, s)
                : launch<G, false, false>(l, value, row_valid, eps, N, R, C, max_iters, assign,
                                          price, rounds, probe, s);
}

}  // namespace

// N problems, each value [R, C] fp32 (row-major), row_valid [R] bool, eps
// one fp32; out assign [N, R] int64, price [N, C] fp32, rounds [N] int32.
// The block as ops/auction.py:auction_plan gives it: `threads` (whole warps,
// at most 1024), `lanes` a row (a power of two <= 32), `staged` 1: value in
// shared memory with rows of `ldv` >= C floats; 0: read from global memory
// (ldv = C). `probe` null, or [max_iters, 70 + 4 R] int64 for the probe form
// (block 0's record). Refuses a block past the limits; launches on `stream`
// and returns the launch's cudaError_t (0 on success).
extern "C" int bevf_auction(const float* value, const uint8_t* row_valid, const float* eps,
                            int N, int R, int C, int max_iters, int threads, int lanes, int ldv,
                            int staged, int64_t* assign, float* price, int* rounds,
                            long long* probe, void* stream) {
  const size_t bytes = scratch_bytes(R, C) + (staged ? 4 * static_cast<size_t>(R) * ldv : 0);
  if (N < 1 || R < 1 || C < 1 || max_iters < 0 || threads < 32 || threads > kMaxThreads ||
      threads % 32 || lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) ||
      (staged ? ldv < C : ldv != C) || bytes > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch l{threads, ldv, bytes};
  auto s = static_cast<cudaStream_t>(stream);
  switch (lanes) {
#define AUCTION_LANES(G_)                                                                   \
  case G_:                                                                                  \
    return launch_lanes<G_>(l, staged != 0, value, row_valid, eps, N, R, C, max_iters, assign, \
                            price, rounds, probe, s);
    AUCTION_LANES(1) AUCTION_LANES(2) AUCTION_LANES(4) AUCTION_LANES(8) AUCTION_LANES(16)
    AUCTION_LANES(32)
#undef AUCTION_LANES
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
