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
// element is written once (4 K C bytes a position) and takes ~11 fp32
// operations; the input's pixels are read by ~4 K positions' taps, mostly
// from L1/L2. At the swint CenterHead head (64 channels, 128 x 128, K = 9)
// the column is 37.7 MB: ~11 us at 3.35 TB/s, against 0.4 G operations,
// 6 us at the fp32 peak. The design writes and reads coalesced:
// - one warp a (position, tap): every lane computes the tap's corners and
//   weights (a few registers, no shared memory), then the lanes walk the
//   channels, neighbouring lanes on neighbouring channels of each corner
//   pixel (NHWC) and of the column row;
// - the sum keeps the plain version's (and the JAX package's) operations
//   and order, each rounded on its own (__fmul_rn / __fadd_rn: no fused
//   multiply-add), so the column equals the plain version's bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
deform_im2col_kernel(const float* __restrict__ x, const float* __restrict__ offset,
                     const float* __restrict__ mask, float* __restrict__ col, int B, int H,
                     int W, int C, int Ho, int Wo, int kw, int stride, int pad) {
  const int K = kw * kw;
  const int64_t pairs = static_cast<int64_t>(B) * Ho * Wo * K;
  const int64_t pair = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (pair >= pairs) return;
  const int lane = threadIdx.x & 31;
  const int k = static_cast<int>(pair % K);
  const int64_t n = pair / K;  // (b*Ho + oy)*Wo + ox
  const int ox = static_cast<int>(n % Wo);
  const int oy = static_cast<int>((n / Wo) % Ho);
  const int b = static_cast<int>(n / (static_cast<int64_t>(Wo) * Ho));

  const float* off = offset + n * 2 * K + 2 * k;
  const float py = __fadd_rn(static_cast<float>(oy * stride - pad + k / kw), off[0]);
  const float px = __fadd_rn(static_cast<float>(ox * stride - pad + k % kw), off[1]);
  const float y0 = floorf(py), x0 = floorf(px);
  const float wy = __fsub_rn(py, y0), wx = __fsub_rn(px, x0);
  const float uy = __fsub_rn(1.0f, wy), ux = __fsub_rn(1.0f, wx);
  const float cy[4] = {y0, y0, __fadd_rn(y0, 1.0f), __fadd_rn(y0, 1.0f)};
  const float cx[4] = {x0, __fadd_rn(x0, 1.0f), x0, __fadd_rn(x0, 1.0f)};
  const float cw[4] = {__fmul_rn(uy, ux), __fmul_rn(uy, wx), __fmul_rn(wy, ux),
                       __fmul_rn(wy, wx)};
  const float* src[4];
  float w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const bool inside = cy[q] >= 0.0f && cy[q] < static_cast<float>(H) && cx[q] >= 0.0f &&
                        cx[q] < static_cast<float>(W);
    // the JAX package reads the clamped pixel and weighs it by 0 outside
    const int yi = static_cast<int>(fminf(fmaxf(cy[q], 0.0f), static_cast<float>(H - 1)));
    const int xi = static_cast<int>(fminf(fmaxf(cx[q], 0.0f), static_cast<float>(W - 1)));
    src[q] = x + ((static_cast<int64_t>(b) * H + yi) * W + xi) * C;
    w[q] = inside ? cw[q] : 0.0f;
  }
  const float m = mask == nullptr ? 1.0f : mask[n * K + k];
  float* dst = col + n * static_cast<int64_t>(K) * C + static_cast<int64_t>(k) * C;
  for (int c = lane; c < C; c += 32) {
    float v = __fadd_rn(__fmul_rn(src[0][c], w[0]), __fmul_rn(src[1][c], w[1]));
    v = __fadd_rn(v, __fmul_rn(src[2][c], w[2]));
    v = __fadd_rn(v, __fmul_rn(src[3][c], w[3]));
    dst[c] = mask == nullptr ? v : __fmul_rn(v, m);
  }
}

}  // namespace

// x [B, H, W, C], offset [B, Ho, Wo, 2 kw^2], mask [B, Ho, Wo, kw^2] or
// null, col [B*Ho*Wo, kw^2 * C]; all contiguous fp32 device memory.
// Launches on `stream`, does not synchronise, and returns the launch's
// cudaError_t (0 on success).
extern "C" int bevf_deform_im2col(const float* x, const float* offset, const float* mask,
                                  float* col, int B, int H, int W, int C, int Ho, int Wo, int kw,
                                  int stride, int pad, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || Ho < 1 || Wo < 1 || kw < 1 || stride < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t pairs = static_cast<int64_t>(B) * Ho * Wo * kw * kw;
  const int64_t blocks = (pairs + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  deform_im2col_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(x, offset, mask, col, B, H, W, C,
                                                              Ho, Wo, kw, stride, pad);
  return static_cast<int>(cudaGetLastError());
}
