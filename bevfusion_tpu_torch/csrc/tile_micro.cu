// Two probes of the card's memory system, bf16.
//
//   copy_add_one:  out = x + 1 over a contiguous array (the copy rate)
//   gather_tiles:  `steps` steps, each reading G tiles of R pool rows
//                  (256 B a row) from random row starts into shared
//                  memory; out [R, 128] = the last step's tiles G-2 and
//                  G-1 summed (the random-tile gather rate), on two
//                  engines: TMA bulk copies (gather_tiles_tma_kernel) and
//                  16-byte cp.async copies (gather_tiles_kernel)
//
// Replaces the two TPU kernels of tools/bench_tile_micro.py: `kern` of
// `bench_copy_bw` (a blocked HBM -> VMEM -> HBM copy through BlockSpecs)
// and `kern` of `bench_dma_rand` (G async tile DMAs per grid step, two
// VMEM slots, from scalar-prefetched slot starts). On the TPU they
// calibrated the DMA engine; here the gather measures Hopper's DMA engine,
// the TMA, against cp.async from every thread, on rows the size the sparse
// convs gather (256 B) up to 128 KB tiles, from L2 or from HBM.
//
// What bounds them on an H100: both are pure data movement, so the bytes
// over the 3.35 TB/s HBM rate (2 x 128 MiB for the copy: 0.0801 ms; each
// distinct tile once for the gather). A gather whose pool fits the 50 MB
// L2 can beat that bound, since its rows come from L2 after the first
// touch; one whose pool does not re-reads tiles drawn twice from HBM.
//
// Design. The copy: each thread loads one 16-byte vector (neighbouring
// threads on neighbouring addresses) and stores it plus one, and 32768
// one-shot blocks of 256 threads cover the 132 SMs many times over; the
// add goes through the bf16 intrinsics (round to nearest even, as
// PyTorch's bf16 add), so the result equals `x + 1` bit for bit. It runs
// at the rate of torch's own `x + 1`; 2, 4 or 8 vectors a thread were up
// to 0.8% slower, and 128 or 512 threads, a grid-stride loop over 2-8
// blocks an SM and streaming cache hints no faster (PERF.md, K5).
// The gather on the TMA engine (what gather_tiles launches): persistent
// blocks, 2 an SM, each over an equal run of the list of all steps'
// units. A unit is whole tiles or one chunk of a tile, at most one ring
// stage (32 KB), copied by `cp.async.bulk` (1-D, no tensor map) issued by
// one thread and completing on the stage's own mbarrier (expect_tx set to
// its bytes); the thread takes a stage again once its
// unit has landed, so the whole ring (96 KB a block) is in flight and no
// other thread waits. Thread 0 keeps its ring position in counters, not
// divisions: it issues every copy, and a 64-bit division is a long
// software routine on the card. The last block finally copies the last
// step's tiles G-2 and G-1 chunk by chunk side by side and sums them with
// every thread, after its run: summed first, they held up its run.
// The gather on cp.async (its first form, kept as the same-run yardstick):
// one block a step; a tile is copied in units of up to 32 rows (8 KB) with
// 16-byte copies into a ring of 4 shared-memory stages, so 3 units are in
// flight while the block waits for the oldest; units go chunk-major (all G
// tiles' chunk c, then chunk c + 1), so the last step's block finds chunk c
// of tiles G-2 and G-1 in two neighbouring stages and sums them there.
// Either engine issues its copies from volatile asm, so every step's G
// tiles are read although no thread reads most of them; a tile outside the
// pool is not copied and trips a device-side assert.
//
// Measured (chip_smoke.py phase 14, an NVIDIA H100 80GB HBM3 at 700 W; ms
// at R = 32 / 128 / 512 / 8 / 1 rows a tile, the tool's settings): TMA
// 0.0533 / 0.1550 / 0.1742 / 0.0241 / 0.0763, cp.async 0.0521 / 0.1446 /
// 0.1648 / 0.0208 / 0.0214. From 32 KB tiles on, both read every tile at
// 0.92-1.11x the HBM rate. Below, the TMA pays per copy: 77-97 ns a bulk
// copy an SM at 256 B-2 KB, and one issuing block an SM ran at half the
// rate of two (PERF.md, K6), so rows of 64-256 B are gathered faster by
// cp.async. 2 blocks an SM and 32 KB stages were the fastest, or tied, of
// 1-2 blocks and 8-32 KB stages at every R.

#include <algorithm>
#include <cassert>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCopyThreads = 256;
constexpr int kCopyVecs = 1;     // 16-byte vectors a thread loads before it stores
constexpr int kRowVecs = 16;     // a pool row: 128 bf16 = 256 B = 16 vectors
constexpr int kChunkRows = 32;   // rows per copy unit of the gather (8 KB)
constexpr int kStages = 4;       // shared-memory ring of the gather; kStages - 1 in flight

__device__ __forceinline__ uint32_t add_one_bf16x2(uint32_t v) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&v);
  const __nv_bfloat162 r = __floats2bfloat162_rn(__low2float(h) + 1.f, __high2float(h) + 1.f);
  return *reinterpret_cast<const uint32_t*>(&r);
}

__global__ void __launch_bounds__(kCopyThreads)
copy_add_one_kernel(const uint4* __restrict__ x, uint4* __restrict__ out, long long nvec) {
  const long long base =
      static_cast<long long>(blockIdx.x) * kCopyThreads * kCopyVecs + threadIdx.x;
  uint4 v[kCopyVecs];
#pragma unroll
  for (int j = 0; j < kCopyVecs; ++j) {
    const long long i = base + static_cast<long long>(j) * kCopyThreads;
    if (i < nvec) v[j] = x[i];
  }
#pragma unroll
  for (int j = 0; j < kCopyVecs; ++j) {
    const long long i = base + static_cast<long long>(j) * kCopyThreads;
    if (i < nvec) {
      uint4 r;
      r.x = add_one_bf16x2(v[j].x);
      r.y = add_one_bf16x2(v[j].y);
      r.z = add_one_bf16x2(v[j].z);
      r.w = add_one_bf16x2(v[j].w);
      out[i] = r;
    }
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
}

__global__ void gather_tiles_kernel(const uint4* __restrict__ pool, const int* __restrict__ slots,
                                    __nv_bfloat162* __restrict__ out, long long pool_rows, int R,
                                    int G, int steps) {
  extern __shared__ uint4 ring[];  // [kStages][chunk_rows * kRowVecs]
  const int step = blockIdx.x;
  const int chunk_rows = min(R, kChunkRows);
  const int stage_vecs = chunk_rows * kRowVecs;
  const int units = (R + chunk_rows - 1) / chunk_rows * G;  // unit u: chunk u / G of tile u % G
  bool bad = false;

  // every thread commits one group per unit (empty past the end), so the
  // group counts, and with them the waits, are the same for all threads
  auto fetch = [&](int u) {
    if (u < units) {
      const int c = u / G, g = u % G;
      const long long start = slots[static_cast<long long>(step) * G + g];
      if (start >= 0 && start + R <= pool_rows) {
        const int rows = min(chunk_rows, R - c * chunk_rows);
        const uint4* src = pool + (start + static_cast<long long>(c) * chunk_rows) * kRowVecs;
        uint4* dst = ring + (u % kStages) * stage_vecs;
        for (int e = threadIdx.x; e < rows * kRowVecs; e += blockDim.x)
          cp_async16(dst + e, src + e);
      } else {
        bad = true;
      }
    }
    cp_async_commit();
  };

  for (int u = 0; u < kStages - 1; ++u) fetch(u);
  for (int u = 0; u < units; ++u) {
    cp_async_wait_all_but_newest();  // this thread's copies of unit u have landed
    __syncthreads();                 // and every thread's
    if (step == steps - 1 && u % G == G - 1) {  // units u - 1, u: chunk c of tiles G-2, G-1
      const int c = u / G;
      const int rows = min(chunk_rows, R - c * chunk_rows);
      const __nv_bfloat162* a =
          reinterpret_cast<const __nv_bfloat162*>(ring + ((u - 1) % kStages) * stage_vecs);
      const __nv_bfloat162* b =
          reinterpret_cast<const __nv_bfloat162*>(ring + (u % kStages) * stage_vecs);
      __nv_bfloat162* o = out + static_cast<long long>(c) * chunk_rows * 64;  // 64 pairs a row
      for (int e = threadIdx.x; e < rows * 64; e += blockDim.x)
        o[e] = __floats2bfloat162_rn(__low2float(a[e]) + __low2float(b[e]),
                                     __high2float(a[e]) + __high2float(b[e]));
    }
    __syncthreads();  // the stage refilled next (unit u - 1's) has been read
    fetch(u + kStages - 1);
  }
  assert(!bad);
}

// ---- the gather on the TMA engine ----

constexpr int kRowBytes = kRowVecs * 16;    // a pool row: 256 B
constexpr int kTmaThreads = 128;            // the last step's owner sums with all of them
constexpr int kTmaMaxStages = 64;           // mbarriers of a block's ring
constexpr int kTmaBlocksPerSm = 2;          // persistent blocks an SM
constexpr int kTmaRing = 96 * 1024;         // ring bytes a block (192 KB an SM)
constexpr int kTmaUnitBytes = 32 * 1024;    // the most a ring stage (one transaction) takes
constexpr int kSlotBatch = 2048;            // slots a block stages in shared memory at once
// two blocks' rings, barriers, slot batches and the 1 KB the card reserves
// a block fit the 228 KB of an SM
static_assert(kTmaBlocksPerSm * (kTmaRing + kTmaMaxStages * 8 + kSlotBatch * 4 + 16 + 1024) <=
                  228 * 1024,
              "the TMA engine's blocks do not fit an SM");

struct TmaPlan {
  const char* pool;
  const int* slots;
  __nv_bfloat162* out;
  long long pool_rows;
  int R, G, steps;
  int tile_bytes;
  int tiles_per_unit;  // whole tiles a unit (one barrier's transaction) holds; 0: split tiles
  int chunk_bytes;     // a unit of a split tile
  int pair_bytes;      // the last step's tiles G-2 and G-1 go in pairs of chunks this size
  int stage_bytes, stages;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

// the issuer's arrival, expecting `bytes` of bulk copies to complete the phase
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// until the phase of parity `parity` has completed (that phase must be the
// barrier's current one or the one before it)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// a TMA bulk copy global -> shared, completing `bytes` on the barrier
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__global__ void __launch_bounds__(kTmaThreads) gather_tiles_tma_kernel(const TmaPlan p) {
  extern __shared__ __align__(128) unsigned char tma_ring[];  // [stages][stage_bytes]; barriers
  __shared__ int slot_s[kSlotBatch];
  __shared__ int pair_next;  // the ring's position where the last step's pairs start
  __shared__ uint32_t pair_round;
  const uint32_t ring0 = smem_u32(tma_ring), bar0 = ring0 + p.stages * p.stage_bytes;
  const int tid = threadIdx.x, S = p.stages, G = p.G;
  const long long last = p.steps - 1;
  // the units of all steps in one list, unit v = part v % ups of step v / ups;
  // this block's run [v0, v1) of it, the same length for every block to a
  // unit; the last block's run ends with the last step
  const int ups = p.tiles_per_unit ? (G + p.tiles_per_unit - 1) / p.tiles_per_unit
                                   : G * (p.tile_bytes / p.chunk_bytes +
                                          (p.tile_bytes % p.chunk_bytes != 0));
  const long long units = static_cast<long long>(p.steps) * ups;
  const long long v0 = blockIdx.x * units / gridDim.x, v1 = (blockIdx.x + 1) * units / gridDim.x;
  // thread 0's ring position, kept without divisions (a 64-bit one costs
  // hundreds of cycles, and one thread issues every copy): the next unit
  // takes stage `next`, in round `round` of the ring (its parity), and
  // waits for the stage's unit of the round before unless `fresh`
  int next = 0;
  uint32_t round = 0;
  bool fresh = true, bad = false;
  auto in_pool = [&](int start) { return start >= 0 && start + p.R <= p.pool_rows; };
  auto acquire = [&]() {  // the next unit's stage, once its previous unit has landed
    const int st = next;
    if (!fresh) mbar_wait(bar0 + 8 * st, round ^ 1u);
    if (++next == S) {
      next = 0;
      round ^= 1u;
      fresh = false;
    }
    return st;
  };

  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(bar0 + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the run: thread 0 issues, a unit being whole tiles (at most one stage)
  // or one chunk of a tile, on its own barrier; a stage is taken again once
  // its unit has landed, so S units stay in flight and no other thread
  // waits. The last step's tiles G-2 and G-1 are the owner's pairs, below.
  auto issue_unit = [&](long long step, int j, const int* s) {
    const int g_end = step == last ? G - 2 : G;
    if (p.tiles_per_unit) {
      const int g0 = j * p.tiles_per_unit, g1 = min(g_end, g0 + p.tiles_per_unit);
      if (g0 >= g1) return;
      const int st = acquire();
      int bytes = 0;
      for (int g = g0; g < g1; ++g) {
        if (in_pool(s[g])) bytes += p.tile_bytes;
        else bad = true;
      }
      mbar_expect(bar0 + 8 * st, bytes);
      for (int g = g0; g < g1; ++g)
        if (in_pool(s[g]))
          bulk_copy(ring0 + st * p.stage_bytes + (g - g0) * p.tile_bytes,
                    p.pool + static_cast<long long>(s[g]) * kRowBytes, p.tile_bytes,
                    bar0 + 8 * st);
    } else {
      const int cpt = ups / G, g = j / cpt, off = j % cpt * p.chunk_bytes;
      if (g >= g_end) return;
      const bool ok = in_pool(s[g]);
      bad |= !ok;
      const int st = acquire(), bytes = min(p.chunk_bytes, p.tile_bytes - off);
      mbar_expect(bar0 + 8 * st, ok ? bytes : 0);
      if (ok)
        bulk_copy(ring0 + st * p.stage_bytes,
                  p.pool + static_cast<long long>(s[g]) * kRowBytes + off, bytes, bar0 + 8 * st);
    }
  };
  // the run's slots go through shared memory a batch of whole steps at a time
  const long long s0 = v0 / ups, s1 = v1 > v0 ? (v1 - 1) / ups + 1 : s0;
  const int steps_per_batch = kSlotBatch / G;
  long long v = v0, step = s0;  // unit v is part j of step
  int j = static_cast<int>(v0 - s0 * ups);
  for (long long b0 = s0; b0 < s1; b0 += steps_per_batch) {
    const long long b1 = min(s1, b0 + steps_per_batch);
    __syncthreads();  // thread 0 has issued the previous batch
    for (long long e = tid; e < (b1 - b0) * G; e += blockDim.x) slot_s[e] = p.slots[b0 * G + e];
    __syncthreads();
    if (tid == 0)
      for (; v < v1 && step < b1; ++v) {
        issue_unit(step, j, slot_s + (step - b0) * G);
        if (++j == ups) {
          j = 0;
          ++step;
        }
      }
  }
  if (tid == 0) {
    // every unit in flight lands before the ring is reused or the block
    // leaves: each stage's last unit is of this round below `next`, of the
    // round before from `next` on
    for (int st = 0; st < S; ++st)
      if (st < next || !fresh) mbar_wait(bar0 + 8 * st, st < next ? round : round ^ 1u);
    pair_next = next;
    pair_round = round;
  }

  if (blockIdx.x == gridDim.x - 1) {
    // the owner of the last step: its tiles G-2 and G-1, chunk q of both side
    // by side in one stage, summed in fp32 and rounded to bf16 once by every
    // thread; pair q takes the ring's position n0 + q
    const int last_a = p.slots[last * G + G - 2], last_b = p.slots[last * G + G - 1];
    const bool ok = in_pool(last_a) && in_pool(last_b);
    const int pairs = (p.tile_bytes + p.pair_bytes - 1) / p.pair_bytes;
    const int pair_rows = p.pair_bytes / kRowBytes;
    auto issue_pair = [&](int q) {  // thread 0
      const int st = acquire(), off = q * p.pair_bytes;
      const int bytes = min(p.pair_bytes, p.tile_bytes - off);
      const uint32_t bar = bar0 + 8 * st, dst = ring0 + st * p.stage_bytes;
      mbar_expect(bar, ok ? 2 * bytes : 0);
      if (ok) {
        bulk_copy(dst, p.pool + static_cast<long long>(last_a) * kRowBytes + off, bytes, bar);
        bulk_copy(dst + p.pair_bytes, p.pool + static_cast<long long>(last_b) * kRowBytes + off,
                  bytes, bar);
      }
    };
    bad |= !ok;
    if (tid == 0)
      for (int q = 0; q < min(S, pairs); ++q) issue_pair(q);
    __syncthreads();  // the ring's position is shared and the first pairs issued
    const int n0 = pair_next;
    const uint32_t r0 = pair_round;
    for (int q = 0; q < pairs; ++q) {
      const int st = (n0 + q) % S;
      mbar_wait(bar0 + 8 * st, r0 ^ static_cast<uint32_t>((n0 + q) / S & 1));
      const unsigned char* stage = tma_ring + st * p.stage_bytes;
      const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(stage);
      const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(stage + p.pair_bytes);
      const int rows = min(pair_rows, p.R - q * pair_rows);
      __nv_bfloat162* o = p.out + static_cast<long long>(q) * pair_rows * 64;  // 64 pairs a row
      for (int e = tid; e < rows * 64; e += blockDim.x)
        o[e] = __floats2bfloat162_rn(__low2float(a[e]) + __low2float(b[e]),
                                     __high2float(a[e]) + __high2float(b[e]));
      __syncthreads();  // the stage has been read: it may take pair q + S
      if (tid == 0 && q + S < pairs) issue_pair(q + S);
    }
  }
  if (tid == 0) assert(!bad);
}

}  // namespace

// x, out: n bf16 values each (n a multiple of 8), contiguous device
// memory, 16-byte aligned. out = x + 1. Launches on `stream`, does not
// synchronise, returns the launch's cudaError_t (0 on success).
extern "C" int bevf_copy_add_one_bf16(const void* x, void* out, long long n, void* stream) {
  if (n < 0 || n % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long nvec = n / 8;
  if (nvec == 0) return 0;
  const long long per_block = static_cast<long long>(kCopyThreads) * kCopyVecs;
  const long long blocks = (nvec + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  copy_add_one_kernel<<<static_cast<unsigned>(blocks), kCopyThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), nvec);
  return static_cast<int>(cudaGetLastError());
}

// pool [pool_rows, 128] bf16, slots [steps * G] int32 (each a row start
// with start + R <= pool_rows), out [R, 128] bf16; contiguous device
// memory, 16-byte aligned. G >= 2. out = pool[slots[-2] : +R] +
// pool[slots[-1] : +R]; every step's tiles are read. Launches on `stream`,
// does not synchronise, returns the launch's cudaError_t (0 on success).
extern "C" int bevf_gather_tiles_bf16(const void* pool, const int* slots, void* out,
                                      long long pool_rows, int R, int G, int steps,
                                      void* stream) {
  if (R < 1 || G < 2 || steps < 1 || pool_rows < R) return static_cast<int>(cudaErrorInvalidValue);
  const int chunk_rows = R < kChunkRows ? R : kChunkRows;
  const int stage_vecs = chunk_rows * kRowVecs;
  // one thread per 16-byte copy of a unit, whole warps, at most 256
  const int threads = stage_vecs >= 256 ? 256 : (stage_vecs + 31) / 32 * 32;
  const size_t smem = static_cast<size_t>(kStages) * stage_vecs * sizeof(uint4);
  gather_tiles_kernel<<<steps, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(pool), slots, static_cast<__nv_bfloat162*>(out), pool_rows, R, G,
      steps);
  return static_cast<int>(cudaGetLastError());
}

// The same contract as bevf_gather_tiles_bf16, on the TMA engine:
// SMs x kTmaBlocksPerSm persistent blocks (fewer where there are fewer
// units), each over an equal run of the steps' units, its kTmaRing bytes
// of ring in stages of at most kTmaUnitBytes. G <= 2048.
extern "C" int bevf_gather_tiles_tma_bf16(const void* pool, const int* slots, void* out,
                                          long long pool_rows, int R, int G, int steps,
                                          void* stream) {
  if (R < 1 || R > (1 << 20) / kRowBytes || G < 2 || G > kSlotBatch || steps < 1 ||
      pool_rows < R)
    return static_cast<int>(cudaErrorInvalidValue);
  TmaPlan p{static_cast<const char*>(pool), slots, static_cast<__nv_bfloat162*>(out), pool_rows,
            R, G, steps};
  p.tile_bytes = R * kRowBytes;
  int unit;
  if (p.tile_bytes <= kTmaUnitBytes) {  // whole tiles a unit
    p.tiles_per_unit = std::min(G, kTmaUnitBytes / p.tile_bytes);
    p.chunk_bytes = p.tile_bytes;
    unit = p.tiles_per_unit * p.tile_bytes;
  } else {  // a tile in chunks of a stage
    p.tiles_per_unit = 0;
    p.chunk_bytes = unit = kTmaUnitBytes;
  }
  p.pair_bytes = std::min(p.tile_bytes, kTmaUnitBytes / 2);
  p.stage_bytes = std::max(unit, 2 * p.pair_bytes);
  p.stages = std::min(kTmaMaxStages, kTmaRing / p.stage_bytes);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long ups = p.tiles_per_unit ? (G + p.tiles_per_unit - 1) / p.tiles_per_unit
                                         : G * ((p.tile_bytes + kTmaUnitBytes - 1) / kTmaUnitBytes);
  const long long blocks = std::min(static_cast<long long>(steps) * ups,
                                    static_cast<long long>(sms) * kTmaBlocksPerSm);
  const size_t smem = static_cast<size_t>(p.stages) * (p.stage_bytes + 8);
  err = cudaFuncSetAttribute(gather_tiles_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_tiles_tma_kernel<<<static_cast<unsigned>(blocks), kTmaThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
