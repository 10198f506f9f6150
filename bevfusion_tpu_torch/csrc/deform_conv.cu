// D1: the deformable im2col of DCN, fp32.
//
//   col[n, k*C + c] = mask[n, k] * sum over the four corners (yc, xc) of
//                     x[b, yc, xc, c] * w_corner * inside(yc, xc)
//   (py, px) = (oy*stride - pad + k / kw + offset[n, 2k], ox*stride - pad + k % kw + offset[n, 2k+1])
//   corners (y0, x0), (y0, x0+1), (y0+1, x0), (y0+1, x0+1), y0 = floor(py), x0 = floor(px),
//   weights (1-wy)(1-wx), (1-wy)wx, wy(1-wx), wy wx with wy = py - y0, wx = px - x0
//
// x [B, H, W, C] (NHWC), offset [B, Ho, Wo, 2K] (mmcv's order: dy then dx a
// tap, taps row-major), mask [B, Ho, Wo, K] or none, col [B*Ho*Wo, K*C];
// n = (b*Ho + oy)*Wo + ox. The product with the weight is a torch.matmul
// outside (ops/deform_conv.py), as the JAX package leaves it to an einsum.
//
// Replaces no Pallas kernel: the JAX package's deform_conv2d
// (bevfusion_tpu/ops/deform_conv.py:27-88) samples with four flat
// jnp.take gathers a tap, which XLA runs as its own gather kernels; its
// plain PyTorch counterpart (ops/deform_conv.py:deform_im2col_plain) is
// some forty launches over [B, Ho, Wo, K, C] temporaries. This kernel
// writes each column element once from four reads of the input.
//
// What bounds it on an H100 SXM (at its full 700 W): bytes. Each column
// element is written once (4 K C bytes a position) and takes 7 fp32
// operations; the input's pixels are read by ~4 K positions' taps, mostly
// from L1/L2. At the swint CenterHead head (64 channels, 128 x 128, K = 9)
// the column is 37.7 MB: 12.9 us for x, offsets and column at 3.35 TB/s,
// against 0.07 G operations, 1 us at the fp32 peak. A warp a (position,
// tap), each lane taking the pair apart with 64-bit divisions and
// computing the tap's corners again, is held to 0.17 of that by the
// repeated scalar work (PERF.md section 6); this design spends its
// instructions on the channels:
// - a block takes `positions` neighbouring outputs of one row (grid: row
//   tiles, oy, b; 16 at most, measured faster than 32 or 64: more blocks,
//   so one block's table overlaps another's stores), so b, oy and ox come
//   from the block and thread indices;
//   every index is 32-bit (the launch refuses sizes past int32), and the
//   few quotients left are multiplies by a reciprocal the host computes;
// - phase 1: one thread a (position, tap) reads the tap's offsets and mask
//   (neighbouring threads on neighbouring words) and writes the four
//   corners' element offsets and weights to a table in shared memory (a
//   corner outside the image weighed 0, as the plain version's w * inside,
//   which is exact): each tap's geometry once a block, not once a lane;
// - phase 2: the block's column rows are one contiguous run of
//   positions * K * C floats; the threads walk it in vectors of `vec`
//   floats (4 where C % 4 == 0 and x is 16-byte aligned, else 1),
//   neighbouring threads on neighbouring vectors, each vector taking its
//   (position, tap)'s entry from the table (a broadcast) and its four
//   corners' vectors through the read-only path (neighbouring positions
//   share most pixels: L1 hits), then one streaming store (__stcs: the
//   column is written once; measured 15% faster than plain stores alone
//   and no slower with the `col @ weight` product that reads it next);
// - each product and sum is rounded on its own in the plain version's
//   order (__fmul_rn / __fadd_rn: no fused multiply-add), the mask applied
//   to the finished sum, so the column equals the plain version's bit for
//   bit.
// The launch plan (positions, threads, vec) is Python's
// (ops/deform_conv.py:deform_im2col_plan); this entry refuses one past the
// limits below.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxSmem = 48 * 1024;
constexpr int kEntryBytes = 36;  // a table entry: int4 corner offsets, float4 weights, the mask
constexpr int kMaxQuotient = 1 << 16;

// floor(n / d) for 0 <= n, d < 2^16, m = ceil(2^32 / d): n * m / 2^32 exceeds
// n / d by less than 2^-16, and n / d's fraction is at most 1 - 1/d.
__device__ __forceinline__ int quotient(int n, unsigned long long m) {
  return static_cast<int>((static_cast<unsigned long long>(n) * m) >> 32);
}

unsigned long long reciprocal(int d) { return ((1ULL << 32) + d - 1) / d; }

// the four corners' sum of one channel, left to right, each step rounded
__device__ __forceinline__ float blend(float a, float b, float c, float d, float4 w) {
  float v = __fadd_rn(__fmul_rn(a, w.x), __fmul_rn(b, w.y));
  v = __fadd_rn(v, __fmul_rn(c, w.z));
  return __fadd_rn(v, __fmul_rn(d, w.w));
}

template <int V, bool MASK>
__global__ void __launch_bounds__(kMaxThreads)
deform_im2col_kernel(const float* __restrict__ x, const float* __restrict__ offset,
                     const float* __restrict__ mask, float* __restrict__ col, int H, int W,
                     int C, int Ho, int Wo, int kw, int stride, int pad, int positions,
                     unsigned long long k_rcp, unsigned long long kw_rcp,
                     unsigned long long cv_rcp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = kw * kw;
  int4* at = reinterpret_cast<int4*>(smem);
  float4* wt = reinterpret_cast<float4*>(smem + positions * K * 16);
  float* mk = reinterpret_cast<float*>(smem + positions * K * 32);

  const int b = blockIdx.z, oy = blockIdx.y, ox0 = blockIdx.x * positions;
  const int pairs = min(positions, Wo - ox0) * K;  // the block's (position, tap) pairs
  const int n0 = (b * Ho + oy) * Wo + ox0;         // its first position

  // phase 1: pair t = p*K + k, its offsets at offset[(n0 + p)*2K + 2k] = offset[2(n0*K + t)]
  for (int t = threadIdx.x; t < pairs; t += blockDim.x) {
    const int p = quotient(t, k_rcp), k = t - p * K;
    const int ky = quotient(k, kw_rcp), kx = k - ky * kw;
    const float* off = offset + 2 * (n0 * K + t);
    const float py = __fadd_rn(static_cast<float>(oy * stride - pad + ky), off[0]);
    const float px = __fadd_rn(static_cast<float>((ox0 + p) * stride - pad + kx), off[1]);
    const float y0 = floorf(py), x0 = floorf(px);
    const float wy = __fsub_rn(py, y0), wx = __fsub_rn(px, x0);
    const float uy = __fsub_rn(1.0f, wy), ux = __fsub_rn(1.0f, wx);
    const float cy[4] = {y0, y0, __fadd_rn(y0, 1.0f), __fadd_rn(y0, 1.0f)};
    const float cx[4] = {x0, __fadd_rn(x0, 1.0f), x0, __fadd_rn(x0, 1.0f)};
    const float cw[4] = {__fmul_rn(uy, ux), __fmul_rn(uy, wx), __fmul_rn(wy, ux),
                         __fmul_rn(wy, wx)};
    int idx[4];
    float w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const bool inside = cy[q] >= 0.0f && cy[q] < static_cast<float>(H) && cx[q] >= 0.0f &&
                          cx[q] < static_cast<float>(W);
      // the JAX package reads the clamped pixel and weighs it by 0 outside
      const int yi = static_cast<int>(fminf(fmaxf(cy[q], 0.0f), static_cast<float>(H - 1)));
      const int xi = static_cast<int>(fminf(fmaxf(cx[q], 0.0f), static_cast<float>(W - 1)));
      idx[q] = ((b * H + yi) * W + xi) * C;
      w[q] = inside ? cw[q] : 0.0f;
    }
    at[t] = make_int4(idx[0], idx[1], idx[2], idx[3]);
    wt[t] = make_float4(w[0], w[1], w[2], w[3]);
    if (MASK) mk[t] = mask[n0 * K + t];
  }
  __syncthreads();

  // phase 2: vector v of the block's run is channel vector c of pair `pair`,
  // v = pair * cv + c; each step moves v by blockDim.x = dq * cv + dr
  const int cv = C / V;
  const int vectors = pairs * cv;
  float* out = col + n0 * K * C;
  int pair = quotient(threadIdx.x, cv_rcp);
  int c = threadIdx.x - pair * cv;
  const int dq = quotient(blockDim.x, cv_rcp), dr = blockDim.x - dq * cv;
  for (int v = threadIdx.x; v < vectors; v += blockDim.x) {
    const int4 a = at[pair];
    const float4 w = wt[pair];
    if constexpr (V == 4) {
      const float4 q0 = __ldg(reinterpret_cast<const float4*>(x + a.x) + c);
      const float4 q1 = __ldg(reinterpret_cast<const float4*>(x + a.y) + c);
      const float4 q2 = __ldg(reinterpret_cast<const float4*>(x + a.z) + c);
      const float4 q3 = __ldg(reinterpret_cast<const float4*>(x + a.w) + c);
      float4 r = make_float4(blend(q0.x, q1.x, q2.x, q3.x, w), blend(q0.y, q1.y, q2.y, q3.y, w),
                             blend(q0.z, q1.z, q2.z, q3.z, w), blend(q0.w, q1.w, q2.w, q3.w, w));
      if (MASK) {
        const float m = mk[pair];
        r = make_float4(__fmul_rn(r.x, m), __fmul_rn(r.y, m), __fmul_rn(r.z, m),
                        __fmul_rn(r.w, m));
      }
      __stcs(reinterpret_cast<float4*>(out) + v, r);
    } else {
      float r = blend(__ldg(x + a.x + c), __ldg(x + a.y + c), __ldg(x + a.z + c),
                      __ldg(x + a.w + c), w);
      if (MASK) r = __fmul_rn(r, mk[pair]);
      __stcs(out + v, r);
    }
    c += dr;
    pair += dq;
    if (c >= cv) {
      c -= cv;
      ++pair;
    }
  }
}

bool fits_int32(double a, double b, double c, double d) { return a * b * c * d <= INT_MAX; }

}  // namespace

// x [B, H, W, C], offset [B, Ho, Wo, 2 kw^2], mask [B, Ho, Wo, kw^2] or
// null, col [B*Ho*Wo, kw^2 * C]; all contiguous fp32 device memory. The plan
// (positions of one output row a block, threads a block, vec floats a
// channel vector) is deform_im2col_plan's. Refuses (cudaErrorInvalidValue)
// a block past the limits, vec 4 where C % 4 or a pointer is not 16-byte
// aligned, and sizes past int32 (x's, the offsets' or col's elements) or
// the grid's (B, Ho <= 65535). Launches on `stream`, does not synchronise,
// and returns the launch's cudaError_t (0 on success).
extern "C" int bevf_deform_im2col(const float* x, const float* offset, const float* mask,
                                  float* col, int B, int H, int W, int C, int Ho, int Wo, int kw,
                                  int stride, int pad, int positions, int threads, int vec,
                                  void* stream) {
  const auto invalid = static_cast<int>(cudaErrorInvalidValue);
  if (B < 1 || H < 1 || W < 1 || C < 1 || Ho < 1 || Wo < 1 || kw < 1 || stride < 1 ||
      B > 65535 || Ho > 65535 || kw >= 256 || C >= kMaxQuotient)
    return invalid;
  const int K = kw * kw;
  if (positions < 1 || positions > Wo || threads < 32 || threads > kMaxThreads ||
      threads % 32 || (vec != 1 && vec != 4) || C % vec ||
      static_cast<long long>(positions) * K * kEntryBytes > kMaxSmem)
    return invalid;
  if (vec == 4 && ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(col)) & 15))
    return invalid;
  if (!fits_int32(B, H, W, C) || !fits_int32(B, Ho, Wo, 2.0 * K) ||
      !fits_int32(B, Ho, Wo, 1.0 * K * C))
    return invalid;
  const dim3 grid((Wo + positions - 1) / positions, Ho, B);
  const auto kernel = vec == 4
      ? (mask ? deform_im2col_kernel<4, true> : deform_im2col_kernel<4, false>)
      : (mask ? deform_im2col_kernel<1, true> : deform_im2col_kernel<1, false>);
  kernel<<<grid, threads, positions * K * kEntryBytes, static_cast<cudaStream_t>(stream)>>>(
      x, offset, mask, col, H, W, C, Ho, Wo, kw, stride, pad, positions, reciprocal(K),
      reciprocal(kw), reciprocal(C / vec));
  return static_cast<int>(cudaGetLastError());
}
