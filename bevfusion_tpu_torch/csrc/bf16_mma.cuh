// bf16 helpers of the sparse-conv kernels' bf16 forms (sparse_conv.cu,
// sparse_conv_dw.cu): raw bf16 bits (uint16_t) in shared memory, 16-byte
// cp.async copies of them, and the bf16 tensor-core product with fp32 sums.
// native.py hashes this header into every library's name.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tf32_mma.cuh"

namespace {

// copies 16 bytes (8 bf16), or writes zeros when `hit` is false (source size 0)
__device__ __forceinline__ void cp_async16_bf16(uint16_t* dst, const uint16_t* src, bool hit) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(hit ? 16 : 0)
               : "memory");
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
