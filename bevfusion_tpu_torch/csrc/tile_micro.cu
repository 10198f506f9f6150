// Two probes of the card's memory system, bf16.
//
//   copy_add_one:  out = x + 1 over a contiguous array (the copy rate)
//   gather_tiles:  one block per step; each reads G tiles of R pool rows
//                  (256 B a row) from random row starts into shared
//                  memory; out [R, 128] = the last step's tiles G-2 and
//                  G-1 summed (the random-tile gather rate)
//
// Replaces the two TPU kernels of tools/bench_tile_micro.py: `kern` of
// `bench_copy_bw` (a blocked HBM -> VMEM -> HBM copy through BlockSpecs)
// and `kern` of `bench_dma_rand` (G async tile DMAs per grid step, two
// VMEM slots, from scalar-prefetched slot starts). On the TPU they
// calibrated the DMA engine; here they measure what a gather of rows the
// size the sparse convs gather (64-256 B) reaches, from L2 or from HBM.
//
// What bounds them on an H100: both are pure data movement, so the bytes
// over the 3.35 TB/s HBM rate (2 x 128 MiB for the copy: 0.0801 ms).
// A gather whose pool fits the 50 MB L2 can beat that bound, since its
// rows come from L2 after the first touch.
//
// Design. The copy: each thread loads one 16-byte vector (neighbouring
// threads on neighbouring addresses) and stores it plus one, and 32768
// one-shot blocks of 256 threads cover the 132 SMs many times over; the
// add goes through the bf16 intrinsics (round to nearest even, as
// PyTorch's bf16 add), so the result equals `x + 1` bit for bit. Timed
// between back-to-back launches on an H100 it runs at the rate of torch's
// own `x + 1`; 2, 4 or 8 vectors a thread were up to 0.8% slower, and
// 128 or 512 threads, a grid-stride loop over 2-8 blocks an SM and
// streaming cache hints no faster (PERF.md, K5).
// The gather: a tile is copied in units of up to 32 rows (8 KB) with
// 16-byte `cp.async` copies into a ring of 4 shared-memory stages, so 3
// units are in flight while the block waits for the oldest; units go
// chunk-major (all G tiles' chunk c, then chunk c + 1), so the last step's
// block finds chunk c of tiles G-2 and G-1 in two neighbouring stages and
// sums them there. `cp.async` is volatile asm: the compiler cannot drop a
// copy whose data no thread reads, so every step's G tiles are read. A
// tile outside the pool is not copied and trips a device-side assert.

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
