// bf16 helpers of the sparse-conv kernels' bf16 forms (K1/K2 bf16's loop in
// sparse_conv_bf16_tile.cuh, K3 bf16's in sparse_conv_dw_bf16.cuh): raw bf16
// bits (uint16_t) in shared memory, cp.async copies of them (16-byte ones,
// and the aligned 4-byte words that cover a row of 1, 3 or 5 bf16), ldmatrix
// fragments, the mbarriers of their rings, and the bf16 tensor-core product
// with fp32 sums. native.py hashes this header into every library's name.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tf32_mma.cuh"

namespace {

// how a bf16 row reaches shared memory: 16-byte cp.async copies (a
// multiple of 8 bf16, 16-byte aligned), the aligned 4-byte words that cover
// a row of 1, 3 or 5 bf16 (cp_async_row_words: the input conv's 10-byte
// rows, 2-byte aligned, which cp.async cannot take in one piece), or 2-byte
// loads stored as they arrive (any other width; no path of the models runs
// it)
enum RowCopy { kRows16 = 0, kRowsWords = 1, kRowsSync = 2 };

// copies 16 bytes (8 bf16), or writes zeros when `hit` is false (source size 0)
__device__ __forceinline__ void cp_async16_bf16(uint16_t* dst, const uint16_t* src, bool hit) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(hit ? 16 : 0)
               : "memory");
}

// copies `bytes` (0..4) of the 4-byte word at `src`, zeros for the rest
__device__ __forceinline__ void cp_async4_bf16(uint16_t* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

// Row `src` of a [rows, width] bf16 table (width 1, 3 or 5; the input conv's
// 10-byte rows, 2-byte aligned, which cp.async cannot take) as the three
// aligned 4-byte words that cover it, into dst[0..5] (16-byte aligned):
// bytes past the row, and all of them for src < 0, are zeros. A row that
// starts mid-word (src * width odd) lands one column late: shift_row_words
// moves it into place once it has landed.
__device__ __forceinline__ void cp_async_row_words(uint16_t* dst, const uint16_t* base, int src,
                                                   int width) {
  const size_t b = static_cast<size_t>(src < 0 ? 0 : src) * width * 2;
  const size_t end = src < 0 ? 0 : b + width * 2, w0 = b & ~static_cast<size_t>(3);
  const unsigned char* bytes0 = reinterpret_cast<const unsigned char*>(base);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const size_t ws = w0 + 4 * i;
    const int bytes = ws >= end ? 0 : end - ws >= 4 ? 4 : static_cast<int>(end - ws);
    cp_async4_bf16(dst + 2 * i, bytes0 + (bytes ? ws : 0), bytes);
  }
}

__device__ __forceinline__ void shift_row_words(uint16_t* row) {
  uint4* q = reinterpret_cast<uint4*>(row);
  const uint4 v = *q;  // columns -1..6; 7 is zero
  *q = make_uint4(__funnelshift_r(v.x, v.y, 16), __funnelshift_r(v.y, v.z, 16),
                  __funnelshift_r(v.z, v.w, 16), v.w >> 16);
}

// two bf16 in one register, `lo` (the lower index) in the lower half
__device__ __forceinline__ uint32_t pack_bf16(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

__device__ __forceinline__ float bf16_to_float(uint16_t bits) {
  return __bfloat162float(__ushort_as_bfloat16(bits));
}

// round to nearest even, as torch's .to(torch.bfloat16)
__device__ __forceinline__ uint16_t float_to_bf16(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// one arrival (release: this thread's earlier shared-memory writes are seen
// by whoever waits on the phase)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n .reg .b64 state;\n mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// the arrival of this thread's cp.async copies: when they have all landed,
// one arrival (noinc); or (inc) the phase also waits for them, and the
// thread arrives apart
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar, bool noinc) {
  if (noinc)
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
                 : "memory");
  else
    asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
                 : "memory");
}

// wait until the phase of `parity` has completed (acquire)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// d += a @ b on a 16x8x16 tile: bf16 A row-major, B column-major, fp32 sums.
// A: a[0] (row g, k 2t..2t+1), a[1] (row g+8), a[2] (row g, k 2t+8..2t+9),
// a[3] (row g+8, k 2t+8..); B: b0 (k 2t..2t+1, col g), b1 (k 2t+8..2t+9);
// D as m16n8k8's: rows g, g+8, cols 2t, 2t+1 (g = lane / 4, t = lane % 4)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace
