// The first, scalar form of the sparse-conv gather-GEMM loop of
// csrc/sparse_conv.cu (before its tensor-core redesign), without its
// epilogue, in four modes that split its time into parts, fp32:
//
//   current    out[i] = sum_k x[nbr[k, i]] @ W[k]  (the scalar loop: an offset
//              that every site of the tile misses is skipped)
//   noskip     the same numbers with no skip: every offset is staged and
//              multiplied
//   nogather   out[i] = sum_k [nbr[k, i] >= 0] x[i] @ W[k]: the tile's own
//              rows (coalesced) in place of the gathered ones; the cost
//              floor of the gather
//   noproduct  out[i] = sum_k x[nbr[k, i]]  ([cap_out, Cin], no weights):
//              the gather without the product; the cost floor of the product
//
// Replaces the TPU kernel tools/bench_kernel_variants.py:_kernel (modes
// current, roll, noalign, nohot), which split the windowed Pallas conv's
// time into its lane alignment, its one-hot matmul and its DMAs. The scalar
// kernel has none of those, so the modes here split it into what it does
// have: the gather (current - nogather), the product (current - noproduct)
// and what the skip saves (noskip - current). fp32, because the kernel it
// breaks down is fp32 (the TPU tool was bf16 because its production kernel
// was); a bf16 form waits for the bf16 sparse-conv path.
//
// What bounds it on an H100: per output row K * Cin * 4 bytes of gathered
// rows and 2 * K * Cin * Cout flops on the fp32 FMA units, 8 to 32 flops
// per byte, at or below the fp32 ridge; the feature tables fit the 50 MB
// L2. The design is the scalar one, so the modes measure it: one block of 256
// threads per TILE output sites (64, the scalar kernel's tile, or 128), each thread
// keeping TILE / (256 / COL_PAD) sums in registers, a block-wide vote and
// a synchronous staging of rows and W[k] per offset. `current` at TILE 64
// is the scalar kernel without epilogue, bit for bit; chip_smoke.py times it
// beside today's csrc/sparse_conv.cu (a cp.async ring feeding 3xTF32
// tensor-core tiles), which agrees with it to fp32 rounding, not bit for
// bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChannels = 128;

enum Mode { kCurrent = 0, kNoSkip = 1, kNoGather = 2, kNoProduct = 3 };

template <int MODE, int TILE, int COL_PAD>
__global__ void __launch_bounds__(kThreads)
variant_kernel(const float* __restrict__ feats, const int* __restrict__ nbr,
               const float* __restrict__ weight, float* __restrict__ out, int cap_in, int cap_out,
               int num_offsets, int cin, int cout) {
  constexpr bool kProduct = MODE != kNoProduct;
  constexpr int kLanes = kThreads / COL_PAD;  // row lanes per column
  constexpr int kRows = TILE / kLanes;        // rows per thread
  extern __shared__ float smem[];
  float* xs = smem;                                                         // [TILE][cin]
  float* ws = xs + TILE * cin;                                              // [cin][COL_PAD]
  int* src_rows = reinterpret_cast<int*>(ws + (kProduct ? cin * COL_PAD : 0));  // [TILE]

  const int ncols = kProduct ? cout : cin;
  const int tid = threadIdx.x;
  const int col = tid % COL_PAD;
  const int lane = tid / COL_PAD;
  const int row0 = blockIdx.x * TILE;

  float acc[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) acc[j] = 0.f;

  for (int k = 0; k < num_offsets; ++k) {
    bool hit = false;
    if (tid < TILE) {
      const int r = row0 + tid;
      int src = r < cap_out ? nbr[static_cast<size_t>(k) * cap_out + r] : -1;
      if (src >= cap_in) src = -1;
      if (MODE == kNoGather && src >= 0) src = r < cap_in ? r : -1;
      src_rows[tid] = src;
      hit = src >= 0;
    }
    // also orders the previous offset's reads of xs/ws before the writes below
    if (MODE == kNoSkip) {
      __syncthreads();
    } else if (!__syncthreads_or(hit)) {
      continue;
    }

    if (kProduct) {
      const float* wk = weight + static_cast<size_t>(k) * cin * cout;
      for (int e = tid; e < cin * COL_PAD; e += kThreads) {
        const int ci = e / COL_PAD, co = e % COL_PAD;
        ws[e] = co < cout ? wk[ci * cout + co] : 0.f;
      }
    }
    for (int e = tid; e < TILE * cin; e += kThreads) {
      const int src = src_rows[e / cin];
      xs[e] = src >= 0 ? feats[static_cast<size_t>(src) * cin + e % cin] : 0.f;
    }
    __syncthreads();

    if (kProduct) {
      for (int ci = 0; ci < cin; ++ci) {
        const float w = ws[ci * COL_PAD + col];
#pragma unroll
        for (int j = 0; j < kRows; ++j)
          acc[j] = fmaf(xs[(lane + j * kLanes) * cin + ci], w, acc[j]);
      }
    } else if (col < cin) {
#pragma unroll
      for (int j = 0; j < kRows; ++j) acc[j] += xs[(lane + j * kLanes) * cin + col];
    }
  }

  if (col >= ncols) return;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int r = row0 + lane + j * kLanes;
    if (r < cap_out) out[static_cast<size_t>(r) * ncols + col] = acc[j];
  }
}

template <int MODE, int TILE, int COL_PAD>
cudaError_t launch(const float* feats, const int* nbr, const float* weight, float* out,
                   int cap_in, int cap_out, int num_offsets, int cin, int cout,
                   cudaStream_t stream) {
  const size_t w_floats = MODE == kNoProduct ? 0 : static_cast<size_t>(cin) * COL_PAD;
  const size_t smem =
      (static_cast<size_t>(TILE) * cin + w_floats) * sizeof(float) + TILE * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(variant_kernel<MODE, TILE, COL_PAD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (cap_out + TILE - 1) / TILE;
  variant_kernel<MODE, TILE, COL_PAD><<<blocks, kThreads, smem, stream>>>(
      feats, nbr, weight, out, cap_in, cap_out, num_offsets, cin, cout);
  return cudaGetLastError();
}

template <int MODE, int TILE>
cudaError_t launch_cols(const float* feats, const int* nbr, const float* weight, float* out,
                        int cap_in, int cap_out, int num_offsets, int cin, int cout,
                        cudaStream_t s) {
  const int ncols = MODE == kNoProduct ? cin : cout;
  if (ncols <= 16)
    return launch<MODE, TILE, 16>(feats, nbr, weight, out, cap_in, cap_out, num_offsets, cin,
                                  cout, s);
  if (ncols <= 32)
    return launch<MODE, TILE, 32>(feats, nbr, weight, out, cap_in, cap_out, num_offsets, cin,
                                  cout, s);
  if (ncols <= 64)
    return launch<MODE, TILE, 64>(feats, nbr, weight, out, cap_in, cap_out, num_offsets, cin,
                                  cout, s);
  return launch<MODE, TILE, 128>(feats, nbr, weight, out, cap_in, cap_out, num_offsets, cin,
                                 cout, s);
}

template <int MODE>
cudaError_t launch_tile(const float* feats, const int* nbr, const float* weight, float* out,
                        int cap_in, int cap_out, int num_offsets, int cin, int cout, int tile,
                        cudaStream_t s) {
  if (tile == 64)
    return launch_cols<MODE, 64>(feats, nbr, weight, out, cap_in, cap_out, num_offsets, cin,
                                 cout, s);
  return launch_cols<MODE, 128>(feats, nbr, weight, out, cap_in, cap_out, num_offsets, cin,
                                cout, s);
}

}  // namespace

// feats [cap_in, cin], nbr [num_offsets, cap_out] int32 (-1 = miss),
// weight [num_offsets, cin, cout] (not read by noproduct), out [cap_out,
// cout] ([cap_out, cin] for noproduct); all contiguous fp32 device memory.
// mode 0 current, 1 noskip, 2 nogather, 3 noproduct; tile 64 or 128.
// Launches on `stream`, does not synchronise, and returns the launch's
// cudaError_t (0 on success).
extern "C" int bevf_sparse_conv_variant_f32(const float* feats, const int* nbr,
                                            const float* weight, float* out, int cap_in,
                                            int cap_out, int num_offsets, int cin, int cout,
                                            int mode, int tile, void* stream) {
  if (cin < 1 || cin > kMaxChannels || cout < 1 || cout > kMaxChannels || num_offsets < 1 ||
      cap_in < 0 || cap_out < 1 || (tile != 64 && tile != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kCurrent:
      return static_cast<int>(launch_tile<kCurrent>(feats, nbr, weight, out, cap_in, cap_out,
                                                    num_offsets, cin, cout, tile, s));
    case kNoSkip:
      return static_cast<int>(launch_tile<kNoSkip>(feats, nbr, weight, out, cap_in, cap_out,
                                                   num_offsets, cin, cout, tile, s));
    case kNoGather:
      return static_cast<int>(launch_tile<kNoGather>(feats, nbr, weight, out, cap_in, cap_out,
                                                     num_offsets, cin, cout, tile, s));
    case kNoProduct:
      return static_cast<int>(launch_tile<kNoProduct>(feats, nbr, weight, out, cap_in, cap_out,
                                                      num_offsets, cin, cout, tile, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
