// Weight gradient of the sparse gather-GEMM conv, fp32.
//
//   dW[k, ci, co] = sum_o feats[nbr[k, o], ci] * dout[o, co],  nbr = -1 skips
//
// Replaces the TPU kernel bevfusion_tpu/ops/sparse_conv_windowed.py:
// `_kernel_dw` (reached through windowed_gather_dw). That kernel builds
// the gathered rows of one site block with one-hot matmuls over a DMA'd
// window, then adds A^T @ dout into one VMEM-resident dW as the grid
// steps run in order (`dw_ref +=`), with packed 128-lane sites folded back
// at the end. None of that carries over: blocks run in parallel and in no
// order here, and a block gathers rows straight into shared memory.
//
// Design. Pass 1: one block per (offset k, chunk of `chunk` output sites).
// It walks its chunk in tiles of 64 sites: gathers the tile's
// feats[nbr[k, o]] rows (zeros on a miss) and dout[o] rows into shared
// memory, and accumulates its [Cin, Cout] partial in registers (thread t
// owns column t % COUT_PAD and a strided set of rows). A tile in which
// every site misses offset k is skipped (block-wide vote), so a chunk
// that misses everywhere does no work but store zeros. Each block stores
// its partial once. Pass 2 sums the partials of each dW element over the
// chunks in chunk order: no fp32 atomics, so dW is the same from run to
// run.
//
// What bounds it on an H100: the useful work is 2*Cin*Cout flops per hit
// pair (an output site whose offset-k neighbor exists), and the least
// traffic is each input once (feats, the [K, cap_out] table, dout) plus
// dW. Counted so, the table's bytes bound it at C = 16 and the fp32 FMA
// rate (67 TFLOP/s, no tensor cores) from C = 32 on. What actually limits
// this first form is its inner loop - one shared-memory load per FMA -
// and the misses it still computes: a 64-site tile that any site hits
// runs all 64 rows (21% of the stage-0 slots hit). It answers the gather
// cost by reading each neighbor row once per (offset, tile) into shared
// memory, skips all-miss tiles, and needs no atomics. No mma/wgmma, no
// cp.async yet; compacting the hit rows is the next step.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;
constexpr int kThreads = 256;
constexpr int kMaxChannels = 128;

template <int COUT_PAD>
__global__ void __launch_bounds__(kThreads)
sparse_conv_dw_partial_kernel(const float* __restrict__ feats, const int* __restrict__ nbr,
                              const float* __restrict__ dout, float* __restrict__ partial,
                              int cap_in, int cap_out, int cin, int cout, int chunk) {
  constexpr int kLanes = kThreads / COUT_PAD;                      // row lanes per column
  constexpr int kRows = (kMaxChannels + kLanes - 1) / kLanes;      // rows per thread, at most
  extern __shared__ float smem[];
  float* xs = smem;                                                // [kTile][cin]
  float* ds = xs + kTile * cin;                                    // [kTile][COUT_PAD]
  int* src_rows = reinterpret_cast<int*>(ds + kTile * COUT_PAD);   // [kTile]

  const int k = blockIdx.y;
  const int tid = threadIdx.x;
  const int col = tid % COUT_PAD;
  const int lane = tid / COUT_PAD;
  const int begin = blockIdx.x * chunk;
  const int end = min(begin + chunk, cap_out);
  const int* nbr_k = nbr + static_cast<size_t>(k) * cap_out;

  float acc[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) acc[j] = 0.f;

  for (int row0 = begin; row0 < end; row0 += kTile) {
    bool hit = false;
    if (tid < kTile) {
      const int r = row0 + tid;
      int src = r < end ? nbr_k[r] : -1;
      if (src >= cap_in) src = -1;
      src_rows[tid] = src;
      hit = src >= 0;
    }
    // also orders the previous tile's reads of xs/ds before the writes below
    if (!__syncthreads_or(hit)) continue;

    for (int e = tid; e < kTile * cin; e += kThreads) {
      const int src = src_rows[e / cin];
      xs[e] = src >= 0 ? feats[static_cast<size_t>(src) * cin + e % cin] : 0.f;
    }
    for (int e = tid; e < kTile * COUT_PAD; e += kThreads) {
      const int s = e / COUT_PAD, co = e % COUT_PAD;
      ds[e] = (co < cout && src_rows[s] >= 0)
                  ? dout[static_cast<size_t>(row0 + s) * cout + co] : 0.f;
    }
    __syncthreads();

    for (int s = 0; s < kTile; ++s) {
      const float d = ds[s * COUT_PAD + col];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int ci = lane + j * kLanes;
        if (ci < cin) acc[j] = fmaf(xs[s * cin + ci], d, acc[j]);
      }
    }
  }

  if (col >= cout) return;
  float* out = partial + (static_cast<size_t>(blockIdx.x) * gridDim.y + k) * cin * cout;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int ci = lane + j * kLanes;
    if (ci < cin) out[ci * cout + col] = acc[j];
  }
}

// dw[i] = sum over chunks c, in order, of partial[c][i]; i < n = K*cin*cout
__global__ void __launch_bounds__(kThreads)
sparse_conv_dw_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                             int num_chunks, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int c = 0; c < num_chunks; ++c) s += partial[static_cast<size_t>(c) * n + i];
  dw[i] = s;
}

template <int COUT_PAD>
cudaError_t launch(const float* feats, const int* nbr, const float* dout, float* partial,
                   int cap_in, int cap_out, int num_offsets, int cin, int cout, int chunk,
                   cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(kTile) * cin + static_cast<size_t>(kTile) * COUT_PAD) *
                          sizeof(float) + kTile * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sparse_conv_dw_partial_kernel<COUT_PAD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((cap_out + chunk - 1) / chunk, num_offsets);
  sparse_conv_dw_partial_kernel<COUT_PAD><<<grid, kThreads, smem, stream>>>(
      feats, nbr, dout, partial, cap_in, cap_out, cin, cout, chunk);
  return cudaGetLastError();
}

}  // namespace

// feats [cap_in, cin], nbr [num_offsets, cap_out] int32 (-1 = miss),
// dout [cap_out, cout], partial [ceil(cap_out / chunk), num_offsets, cin,
// cout] scratch, dw [num_offsets, cin, cout]; all contiguous fp32 device
// memory (nbr int32). chunk is a positive multiple of 64. Launches both
// passes on `stream`, does not synchronise, and returns the first failed
// launch's cudaError_t (0 on success).
extern "C" int bevf_sparse_conv_dw_f32(const float* feats, const int* nbr, const float* dout,
                                       float* partial, float* dw, int cap_in, int cap_out,
                                       int num_offsets, int cin, int cout, int chunk,
                                       void* stream) {
  if (cin < 1 || cin > kMaxChannels || cout < 1 || cout > kMaxChannels || num_offsets < 1 ||
      cap_in < 0 || cap_out < 1 || chunk < kTile || chunk % kTile != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(num_offsets) * cin * cout;
  if (n > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (cout <= 16)
    err = launch<16>(feats, nbr, dout, partial, cap_in, cap_out, num_offsets, cin, cout, chunk, s);
  else if (cout <= 32)
    err = launch<32>(feats, nbr, dout, partial, cap_in, cap_out, num_offsets, cin, cout, chunk, s);
  else if (cout <= 64)
    err = launch<64>(feats, nbr, dout, partial, cap_in, cap_out, num_offsets, cin, cout, chunk, s);
  else
    err = launch<128>(feats, nbr, dout, partial, cap_in, cap_out, num_offsets, cin, cout, chunk,
                      s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int num_chunks = (cap_out + chunk - 1) / chunk;
  sparse_conv_dw_reduce_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads,
                                 0, s>>>(partial, dw, num_chunks, static_cast<int>(n));
  return static_cast<int>(cudaGetLastError());
}
