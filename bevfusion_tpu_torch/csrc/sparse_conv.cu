// Sparse 3D convolution as a gather-GEMM over a neighbor table, fp32,
// with the eval-time BatchNorm / residual / ReLU epilogue fused.
//
//   out[i] = epilogue( sum_k feats[nbr[k, i]] @ W[k] ),  nbr = -1 skips
//   epilogue(y) = relu( y * scale + shift + residual[i] ), each part optional
//
// Replaces the two TPU kernel bodies of
// bevfusion_tpu/ops/sparse_conv_windowed.py: `_kernel_sq` (submanifold
// convs, Cin == Cout) and `_kernel` (Cin != Cout: the strided convs and
// the 5-channel input conv). Their 128-lane site packing, one-hot-matmul
// row "gathers", DMA windows and int16 window selectors exist because
// row gathers on the TPU are descriptor-bound; none of that is needed
// here, where a thread block gathers rows straight into shared memory.
//
// What bounds it on an H100: per output row the kernel reads K*Cin*4
// bytes of gathered neighbor rows (1.7 KB at C = 16, 6.9 KB at C = 64
// for K = 27) and does 2*K*Cin*Cout flops, 8 to 32 flops per byte - at
// or below the fp32 ridge (67 TFLOP/s over 3.35 TB/s ~ 20 flop/B). The
// feature tables (<= 160000 x 64 x 4 B) fit in the 50 MB L2, so the
// gathers are L2 latency and bandwidth bound rather than HBM bound.
// The design answers that by reading each neighbor row once per
// (offset, output tile) into shared memory and reusing it for all Cout
// outputs, staging W[k] once per tile, skipping an offset outright when
// every site of the tile misses it (block-wide vote), and writing each
// output row exactly once (no atomics, no second pass).
//
// Simple first form: one block per 64 output sites, 256 threads; thread
// t owns output column t % COUT_PAD for 64 / (256 / COUT_PAD) rows and
// keeps their sums in registers. Cin and Cout up to 128. No mma/wgmma,
// no cp.async or TMA pipelining yet.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;
constexpr int kThreads = 256;
constexpr int kMaxChannels = 128;

template <int COUT_PAD>
__global__ void __launch_bounds__(kThreads)
sparse_conv_f32_kernel(const float* __restrict__ feats, const int* __restrict__ nbr,
                       const float* __restrict__ weight, const float* __restrict__ scale,
                       const float* __restrict__ shift, const float* __restrict__ residual,
                       float* __restrict__ out, int cap_in, int cap_out, int num_offsets,
                       int cin, int cout, int relu) {
  constexpr int kLanes = kThreads / COUT_PAD;  // row lanes per column
  constexpr int kRows = kTile / kLanes;        // rows per thread
  extern __shared__ float smem[];
  float* xs = smem;                                              // [kTile][cin]
  float* ws = xs + kTile * cin;                                  // [cin][COUT_PAD]
  int* src_rows = reinterpret_cast<int*>(ws + cin * COUT_PAD);   // [kTile]

  const int tid = threadIdx.x;
  const int col = tid % COUT_PAD;
  const int lane = tid / COUT_PAD;
  const int row0 = blockIdx.x * kTile;

  float acc[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) acc[j] = 0.f;

  for (int k = 0; k < num_offsets; ++k) {
    bool hit = false;
    if (tid < kTile) {
      const int r = row0 + tid;
      int src = r < cap_out ? nbr[static_cast<size_t>(k) * cap_out + r] : -1;
      if (src >= cap_in) src = -1;
      src_rows[tid] = src;
      hit = src >= 0;
    }
    // also orders the previous offset's reads of xs/ws before the writes below
    if (!__syncthreads_or(hit)) continue;

    const float* wk = weight + static_cast<size_t>(k) * cin * cout;
    for (int e = tid; e < cin * COUT_PAD; e += kThreads) {
      const int ci = e / COUT_PAD, co = e % COUT_PAD;
      ws[e] = co < cout ? wk[ci * cout + co] : 0.f;
    }
    for (int e = tid; e < kTile * cin; e += kThreads) {
      const int src = src_rows[e / cin];
      xs[e] = src >= 0 ? feats[static_cast<size_t>(src) * cin + e % cin] : 0.f;
    }
    __syncthreads();

    for (int ci = 0; ci < cin; ++ci) {
      const float w = ws[ci * COUT_PAD + col];
#pragma unroll
      for (int j = 0; j < kRows; ++j) acc[j] = fmaf(xs[(lane + j * kLanes) * cin + ci], w, acc[j]);
    }
  }

  if (col >= cout) return;
  const float sc = scale ? scale[col] : 1.f;
  const float sh = shift ? shift[col] : 0.f;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int r = row0 + lane + j * kLanes;
    if (r >= cap_out) continue;
    const size_t o = static_cast<size_t>(r) * cout + col;
    float y = acc[j] * sc + sh;
    if (residual) y += residual[o];
    if (relu) y = fmaxf(y, 0.f);
    out[o] = y;
  }
}

template <int COUT_PAD>
cudaError_t launch(const float* feats, const int* nbr, const float* weight, const float* scale,
                   const float* shift, const float* residual, float* out, int cap_in,
                   int cap_out, int num_offsets, int cin, int cout, int relu,
                   cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(kTile) * cin + static_cast<size_t>(cin) * COUT_PAD) *
                          sizeof(float) + kTile * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sparse_conv_f32_kernel<COUT_PAD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (cap_out + kTile - 1) / kTile;
  sparse_conv_f32_kernel<COUT_PAD><<<blocks, kThreads, smem, stream>>>(
      feats, nbr, weight, scale, shift, residual, out, cap_in, cap_out, num_offsets, cin, cout,
      relu);
  return cudaGetLastError();
}

}  // namespace

// feats [cap_in, cin], nbr [num_offsets, cap_out] int32 (-1 = miss),
// weight [num_offsets, cin, cout], scale/shift [cout] or null,
// residual [cap_out, cout] or null, out [cap_out, cout]; all contiguous
// fp32 device memory. Launches on `stream`, does not synchronise, and
// returns the launch's cudaError_t (0 on success).
extern "C" int bevf_sparse_conv_f32(const float* feats, const int* nbr, const float* weight,
                                    const float* scale, const float* shift,
                                    const float* residual, float* out, int cap_in, int cap_out,
                                    int num_offsets, int cin, int cout, int relu, void* stream) {
  if (cin < 1 || cin > kMaxChannels || cout < 1 || cout > kMaxChannels || num_offsets < 1 ||
      cap_in < 0 || cap_out < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (cout <= 16)
    err = launch<16>(feats, nbr, weight, scale, shift, residual, out, cap_in, cap_out,
                     num_offsets, cin, cout, relu, s);
  else if (cout <= 32)
    err = launch<32>(feats, nbr, weight, scale, shift, residual, out, cap_in, cap_out,
                     num_offsets, cin, cout, relu, s);
  else if (cout <= 64)
    err = launch<64>(feats, nbr, weight, scale, shift, residual, out, cap_in, cap_out,
                     num_offsets, cin, cout, relu, s);
  else
    err = launch<128>(feats, nbr, weight, scale, shift, residual, out, cap_in, cap_out,
                      num_offsets, cin, cout, relu, s);
  return static_cast<int>(err);
}
