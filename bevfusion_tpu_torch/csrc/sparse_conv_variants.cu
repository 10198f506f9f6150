// K7: where the sparse-conv kernel's time goes, in three families of modes,
// no epilogue: two fp32 ones and the bf16 family (below the others).
//
// The scalar family: the first form of csrc/sparse_conv.cu's loop (before
// its tensor-core redesign), kept as the yardstick that chip_smoke.py times
// today's kernel against, at tiles of 64 and 128 output sites:
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
// The tensor-core family: today's K1/K2 loop itself (sparse_conv_tile.cuh,
// shared with csrc/sparse_conv.cu, which instantiates its production mode):
// the same prologue, cp.async ring, 64-site blocks of 4 warps and 3xTF32
// mma.sync tiles, with one part changed a mode (tc, tc_noskip, tc_nogather,
// tc_noproduct, tc_1xtf32; the header lists them). tc is K1/K2 without its
// epilogue, bit for bit. The differences from tc give the gather (tc -
// tc_nogather), the product (tc - tc_noproduct), what the per-warp skip
// saves (tc_noskip - tc) and what the 3xTF32 split costs over one TF32
// product (tc - tc_1xtf32), which is also the most a bf16 form with one mma
// a step could save.
//
// The bf16 family: K1/K2 bf16's loop itself (sparse_conv_bf16_tile.cuh,
// shared with csrc/sparse_conv.cu) on bf16 rows and weights, bf16 out
// rounded once from fp32 sums: bf16 (K1/K2 bf16 without its epilogue, bit
// for bit), bf16_noskip, bf16_nogather and bf16_noproduct, the split of the
// tensor-core family; the same loop at any depth of its ring (K7's sweep),
// each depth's bits equal.
//
// Replaces the TPU kernel tools/bench_kernel_variants.py:_kernel (modes
// current, roll, noalign, nohot), which split the windowed Pallas conv's
// time into its lane alignment, its one-hot matmul and its DMAs. Neither
// Hopper loop has those parts, so the modes split each into what it has.
// fp32, because the kernel it breaks down is fp32 (the TPU tool was bf16
// because its production kernel was; the bf16 family runs at the TPU
// tool's own precision).
//
// What bounds it on an H100. Per hit pair the product does 2 * Cin * Cout
// flops: on the fp32 FMA units (67 TFLOP/s) for the scalar family, three
// TF32 products on the tensor cores (495 TFLOP/s) for tc, tc_noskip and
// tc_nogather, one for tc_1xtf32; noproduct and tc_noproduct only move
// bytes (each input once, the output once, at 3.35 TB/s; the feature
// tables fit the 50 MB L2). The scalar loop: one block of 256 threads per
// TILE output sites, each thread keeping TILE / (256 / COL_PAD) sums in
// registers, a block-wide vote and a synchronous staging of rows and W[k]
// per offset, so nothing is in flight while it multiplies.
//
// Measured (chip_smoke.py phase 14, an NVIDIA H100 80GB HBM3 at 700 W; ms
// at the stage-0 16->16 / stage-1 32->32 / stage-2 64->64 submanifold convs
// of a 120k-point scan): tc 0.0715 / 0.1819 / 0.3755 (K1/K2 without
// epilogue, 0.16 / 0.06 / 0.11 of its bound); tc_nogather the same (the
// gather costs nothing: the tables sit in L2); tc_noproduct 0.0444 /
// 0.0808 / 0.1056, the loop's floor without a product; tc_1xtf32 0.0599 /
// 0.1444 / 0.2523, so the 3xTF32 split costs 16 / 21 / 33%; tc_noskip
// 0.1563 / 0.2516 / 0.5427. 0.315 / 0.559 / 0.620 of the rows multiplied
// hold a hit. The scalar loop's current at tile 64: 0.127 / 0.398 / 0.943.

#include <cstdint>

#include <cuda_runtime.h>

#include "sparse_conv_bf16_tile.cuh"
#include "sparse_conv_dw_bf16.cuh"
#include "sparse_conv_tile.cuh"

namespace {

constexpr int kThreads = 256;  // the scalar loop's block

enum Mode { kCurrent = 0, kNoSkip = 1, kNoGather = 2, kNoProduct = 3 };

template <int MODE, int TILE, int COL_PAD>
__global__ void __launch_bounds__(kThreads)
variant_kernel(const float* __restrict__ feats, const int* __restrict__ nbr,
               const float* __restrict__ weight, float* __restrict__ out, int cap_in, int cap_out,
               int num_offsets, int cin, int cout) {
  constexpr bool kProduct = MODE != kNoProduct;
  constexpr int kLanes = kThreads / COL_PAD;  // row lanes per column
  constexpr int kRows = TILE / kLanes;        // rows per thread
  extern __shared__ float scalar_smem[];
  float* xs = scalar_smem;                                                  // [TILE][cin]
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

namespace {

// the tensor-core family runs K1/K2's loop at the submanifold convs, Cin ==
// Cout, padded as csrc/sparse_conv.cu pads them
template <int MODE>
cudaError_t launch_tc(const Params& p, cudaStream_t s) {
  if (p.cin <= 16) return launch<MODE, 16, 16>(p, s);
  if (p.cin <= 32) return launch<MODE, 32, 32>(p, s);
  return launch<MODE, 64, 64>(p, s);
}

}  // namespace

// The tensor-core family. feats [cap_in, c], nbr [num_offsets, cap_out]
// int32 (-1 = miss), weight [num_offsets, c, c] (not read by tc_noproduct),
// out [cap_out, c]; all contiguous fp32 device memory, 1 <= c <= 64. mode 0
// tc, 1 tc_noskip, 2 tc_nogather, 3 tc_noproduct, 4 tc_1xtf32. Launches on
// `stream`, does not synchronise, and returns the launch's cudaError_t (0
// on success).
extern "C" int bevf_sparse_conv_tc_variant_f32(const float* feats, const int* nbr,
                                               const float* weight, float* out, int cap_in,
                                               int cap_out, int num_offsets, int c, int mode,
                                               void* stream) {
  if (c < 1 || c > 64 || num_offsets < 1 || cap_in < 0 || cap_out < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{feats, nbr, weight, nullptr, nullptr, nullptr, out, cap_in, cap_out, num_offsets, c,
           c, 0, 0};
  p.vec_rows = c % 4 == 0 && aligned(feats, 16);
  p.vec_weight = c % 4 == 0 && aligned(weight, 16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return static_cast<int>(launch_tc<kTileBare>(p, s));
    case 1: return static_cast<int>(launch_tc<kTileNoSkip>(p, s));
    case 2: return static_cast<int>(launch_tc<kTileNoGather>(p, s));
    case 3: return static_cast<int>(launch_tc<kTileNoProduct>(p, s));
    case 4: return static_cast<int>(launch_tc<kTileOneTf32>(p, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}


namespace {

// the bf16 family runs the bf16 form's loop at the submanifold convs, Cin ==
// Cout, padded as csrc/sparse_conv.cu pads them
template <int MODE>
cudaError_t launch_bf16_variant(const ParamsBf16& p, cudaStream_t s, int* info, int stages) {
  if (p.cin <= 16) return run_bf16<MODE, 16, 16>(p, s, info, stages);
  if (p.cin <= 32) return run_bf16<MODE, 32, 32>(p, s, info, stages);
  return run_bf16<MODE, 64, 64>(p, s, info, stages);
}

}  // namespace

// The bf16 family. feats [cap_in, c], weight [num_offsets, c, c] (not read by
// bf16_noproduct) and out [cap_out, c] bf16, nbr [num_offsets, cap_out] int32
// (-1 = miss); all contiguous device memory, 1 <= c <= 64. mode 0 bf16, 1
// bf16_noskip, 2 bf16_nogather, 3 bf16_noproduct. stages >= 0 replaces the
// launch's choice of the ring's depth. With info null: launches on `stream`
// and does not synchronise; else writes what the launch would run into
// info[kPlanInfo] (run_bf16 in sparse_conv_bf16_tile.cuh) and launches
// nothing. Returns a cudaError_t (0 on success).
extern "C" int bevf_sparse_conv_bf16_variant(const void* feats, const int* nbr,
                                             const void* weight, void* out, int cap_in,
                                             int cap_out, int num_offsets, int c, int mode,
                                             int stages, void* stream, int* info) {
  if (c < 1 || c > 64 || num_offsets < 1 || cap_in < 0 || cap_out < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const ParamsBf16 p = params_bf16(feats, nbr, weight, nullptr, nullptr, nullptr, out, cap_in,
                                   cap_out, num_offsets, c, c, 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return static_cast<int>(launch_bf16_variant<kTileBare>(p, s, info, stages));
    case 1: return static_cast<int>(launch_bf16_variant<kTileNoSkip>(p, s, info, stages));
    case 2: return static_cast<int>(launch_bf16_variant<kTileNoGather>(p, s, info, stages));
    case 3: return static_cast<int>(launch_bf16_variant<kTileNoProduct>(p, s, info, stages));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The dw_bf16 family (K3 bf16's kernel, sparse_conv_dw_bf16.cuh). feats
// [cap_in, c] and dout [cap_out, c] bf16, nbr [num_offsets, cap_out] int32
// (-1 = miss), partial and chunk as for bevf_sparse_conv_dw_bf16, dw
// [num_offsets, c, c] fp32; all contiguous device memory, c 16, 32 or 64,
// the rows 16-byte aligned. mode 0 dw_bf16, 1 dw_bf16_nogather, 2
// dw_bf16_noproduct, 3 dw_bf16_compact. Launches both passes on `stream`
// and does not synchronise. Returns a cudaError_t (0 on success).
extern "C" int bevf_sparse_conv_dw_bf16_variant(const void* feats, const int* nbr,
                                                const void* dout, float* partial, float* dw,
                                                int cap_in, int cap_out, int num_offsets, int c,
                                                int chunk, int mode, void* stream) {
  switch (mode) {
    case 0: return dwb::run<dwb::kDwConv, true>(feats, nbr, dout, dw, partial, cap_in, cap_out,
                                                num_offsets, c, c, chunk, stream, nullptr);
    case 1: return dwb::run<dwb::kDwNoGather, true>(feats, nbr, dout, dw, partial, cap_in,
                                                    cap_out, num_offsets, c, c, chunk, stream,
                                                    nullptr);
    case 2: return dwb::run<dwb::kDwNoProduct, true>(feats, nbr, dout, dw, partial, cap_in,
                                                     cap_out, num_offsets, c, c, chunk, stream,
                                                     nullptr);
    case 3: return dwb::run<dwb::kDwCompact, true>(feats, nbr, dout, dw, partial, cap_in,
                                                   cap_out, num_offsets, c, c, chunk, stream,
                                                   nullptr);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
