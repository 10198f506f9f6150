// Sparse 3D convolution as a gather-GEMM over a neighbor table, fp32 in
// and out (a bf16 form below), with the eval-time BatchNorm / residual /
// ReLU epilogue fused.
//
//   out[i] = epilogue( sum_k feats[nbr[k, i]] @ W[k] ),  nbr = -1 skips
//   epilogue(y) = relu( y * scale + shift + residual[i] ), each part optional
//
// Replaces the two TPU kernel bodies of
// bevfusion_tpu/ops/sparse_conv_windowed.py: `_kernel_sq` (submanifold
// convs, Cin == Cout) and `_kernel` (Cin != Cout: the strided convs, the
// 5-channel input conv and backward-data). Their 128-lane site packing,
// one-hot-matmul row "gathers", DMA windows and int16 window selectors
// exist because row gathers on the TPU are descriptor-bound; none of that
// is needed here, where a block gathers rows straight into shared memory.
//
// What bounds it on an H100. Per hit pair the product does 2 * Cin * Cout
// flops; on the tensor cores in the 3xTF32 split below that is three TF32
// products, 3 * 2 * Cin * Cout operations at 495 TFLOP/s. The bytes are
// each input and output once at 3.35 TB/s. At the encoder's shapes the two
// are within a few times of each other, and both are far below what the
// first form of this kernel reached (4-10% of its bound): it was held back
// by latency, not by either rate. For each of the 27 offsets it voted
// block-wide, gathered 64 rows and W[k] synchronously through registers,
// waited at a second barrier and ran a scalar FMA loop, so nothing was in
// flight while it multiplied. The gather itself is cheap (the feature
// tables sit in the 50 MB L2).
//
// The loop below lives in sparse_conv_tile.cuh, a template over a
// compile-time mode: this file instantiates the production mode only, and
// csrc/sparse_conv_variants.cu instantiates the modes that split its time
// (K7's tensor-core family). This file keeps the dispatch on the channel
// widths and the C interface.
//
// Design, one block of 4 warps per 64 output sites:
// - Prologue: the tile's nbr[K, 64] is loaded once into shared memory
//   (coalesced); warp ballots give a 64-bit hit mask per offset; after one
//   barrier each warp compacts the offsets any site hits into its own copy
//   of the active list. nbr >= cap_in counts as a miss.
// - A ring of 2-4 stages in shared memory (as many as fit two blocks an
//   SM), each holding one active offset's gathered rows [64, Cin] and its
//   W[k] [Cin, Cout], filled with cp.async (16-byte .cg copies, 4-byte
//   ones where a row is not 16-byte aligned, e.g. Cin = 5); a missed row
//   is zero-filled (source size 0). The next stages - 1 offsets are in
//   flight while the tensor cores work on the oldest; one barrier per
//   offset. Every thread commits one group per step, so the waits agree.
// - The product on the tensor cores, mma.sync m16n8k8 with TF32 inputs in
//   the 3xTF32 split: a = big + small with big = cvt.rna.tf32(a) and small
//   = cvt.rna.tf32(a - big), the same for W, and the sum of small*big' +
//   big*small' + big*big' (small*small' dropped, ~2^-22 relative). The
//   tensor cores' fp32 accumulation truncates, so a sum carried through
//   hundreds of mma steps drifts toward zero (one accumulator for all 27
//   offsets was 1.5e-5 off at C = 64 on an H100, enough to break the train
//   step's gradient check). So each 8-deep big*big' product starts from a
//   zero accumulator and is added on the FP32 units (round to nearest) into
//   the offset's own sum, which goes into the running sum once per offset
//   (at Cout <= 64; at 128 straight into the running sum, for registers),
//   and only the small terms, 2^-11 of the size, accumulate on the tensor
//   cores. Against the same conv in float64 this is 2-4x closer than an
//   fp32 FMA loop (cuBLAS, or this kernel's first form, which round alike).
// - Each warp owns 16 rows and every output column, with its sums in
//   registers across all offsets, and skips an offset that none of its 16
//   rows hits (the rows are zeros). Row strides of Cin + 4 and Cout + 8
//   floats make the fragment loads free of shared-memory bank conflicts.
//   Cin is padded to a multiple of 8 (the mma depth) and Cout to
//   16/32/64/128 with zeros in shared memory.
// - The epilogue straight from the accumulator fragments: each output row
//   is written once; a tile no offset hits (a padding tile) still writes
//   epilogue(0), so padded rows hold relu(shift). No atomics and a fixed
//   order of summation: two calls give equal bits.
//
// The bf16 form (bevf_sparse_conv_bf16, below) is the TPU kernels' own
// contract: bf16 rows, weights and residual, fp32 scale and shift, bf16
// out. It runs the same loop (64-site blocks of 4 warps, the prologue, a
// cp.async ring, 16-row warp slabs, the skip of offsets a slab misses) on
// bf16 rows, so a ring stage takes half the bytes, and one mma.sync
// m16n8k16 bf16 product (fp32 sums) a 16-deep step in place of the three
// TF32 products: the bound is 2 * Cin * Cout operations a hit pair at 989
// TFLOP/s, or half the fp32 form's row bytes. Each step's product starts
// from zero and is added on the FP32 units (round to nearest), as above.
// Rows of 16-byte multiples (Cin % 8 == 0) come by 16-byte cp.async copies;
// other widths (the 5-channel input conv: 10-byte rows) by synchronous
// 2-byte loads, the channel padding written as zeros. Cin pads to 16 (the
// mma depth), Cout to 16/32/64/128. Row strides of Cin + 8 and Cout + 8
// bf16 keep the fragment loads free of bank conflicts. The epilogue is
// fp32 (y * scale + shift + residual, ReLU), rounded once to bf16 (round
// to nearest even).

#include <cstdint>

#include <cuda_runtime.h>

#include "bf16_mma.cuh"
#include "sparse_conv_tile.cuh"

namespace {

template <int CIN_PAD>
cudaError_t launch_cout(const Params& p, cudaStream_t s) {
  if (p.cout <= 16) return launch<kTileConv, CIN_PAD, 16>(p, s);
  if (p.cout <= 32) return launch<kTileConv, CIN_PAD, 32>(p, s);
  if (p.cout <= 64) return launch<kTileConv, CIN_PAD, 64>(p, s);
  return launch<kTileConv, CIN_PAD, 128>(p, s);
}

cudaError_t launch_cin(const Params& p, cudaStream_t s) {
  if (p.cin <= 8) return launch_cout<8>(p, s);
  if (p.cin <= 16) return launch_cout<16>(p, s);
  if (p.cin <= 32) return launch_cout<32>(p, s);
  if (p.cin <= 64) return launch_cout<64>(p, s);
  return launch_cout<128>(p, s);
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
  Params p{feats, nbr, weight, scale, shift, residual, out, cap_in, cap_out, num_offsets, cin,
           cout, relu, 0};
  p.vec_rows = cin % 4 == 0 && aligned(feats, 16);
  p.vec_weight = cout % 4 == 0 && aligned(weight, 16);
  p.pair_out = cout % 2 == 0 && aligned(out, 8) && (!residual || aligned(residual, 8));
  return static_cast<int>(launch_cin(p, static_cast<cudaStream_t>(stream)));
}

// ----------------------------------------------------------------------
// the bf16 form
// ----------------------------------------------------------------------

namespace {

struct ParamsBf16 {
  const uint16_t* feats;
  const int* nbr;
  const uint16_t* weight;
  const float* scale;
  const float* shift;
  const uint16_t* residual;
  uint16_t* out;
  int cap_in, cap_out, num_offsets, cin, cout, relu, stages;
  int vec_rows;    // feature rows of 16-byte multiples, aligned: 16-byte copies
  int vec_weight;  // the same for the rows of W[k]
  int pair_out;    // out (and residual) rows in 4-byte pairs
};

template <int CIN_PAD, int COUT_PAD>
struct LayoutBf16 {
  static constexpr int kWarps = kTile / 16;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kWords = kTile / 32;
  static constexpr int kRowStride = CIN_PAD + 8;  // bf16: conflict-free A fragments
  static constexpr int kWStride = COUT_PAD + 8;   // bf16: conflict-free B fragments
  static constexpr int kStageA = kTile * kRowStride;
  static constexpr int kStage = kStageA + CIN_PAD * kWStride;  // bf16, a multiple of 8
  static constexpr size_t kStageBytes = static_cast<size_t>(kStage) * sizeof(uint16_t);
  static_assert(CIN_PAD % 16 == 0 && kStage % 8 == 0, "bf16 stage layout");
};

// acc[nt] += rows[16 of this warp] @ W[k][:, 8 nt : 8 nt + 8], one bf16 mma a
// 16-deep step from a zero accumulator, added into acc on the FP32 units
template <int CIN_PAD, int COUT_PAD>
__device__ __forceinline__ void mma_stage_bf16(const uint16_t* stage,
                                               float (&acc)[COUT_PAD / 8][4], int warp,
                                               int lane) {
  using L = LayoutBf16<CIN_PAD, COUT_PAD>;
  const int g = lane >> 2, t = lane & 3;
  const uint16_t* a = stage + (warp * 16 + g) * L::kRowStride + 2 * t;
  const uint16_t* b = stage + L::kStageA + 2 * t * L::kWStride + g;
#pragma unroll
  for (int kk = 0; kk < CIN_PAD; kk += 16) {
    uint32_t af[4];
    af[0] = *reinterpret_cast<const uint32_t*>(a + kk);
    af[1] = *reinterpret_cast<const uint32_t*>(a + 8 * L::kRowStride + kk);
    af[2] = *reinterpret_cast<const uint32_t*>(a + kk + 8);
    af[3] = *reinterpret_cast<const uint32_t*>(a + 8 * L::kRowStride + kk + 8);
#pragma unroll
    for (int nt = 0; nt < COUT_PAD / 8; ++nt) {
      const uint16_t* bk = b + kk * L::kWStride + nt * 8;
      const uint32_t b0 = pack_bf16(bk[0], bk[L::kWStride]);
      const uint32_t b1 = pack_bf16(bk[8 * L::kWStride], bk[9 * L::kWStride]);
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16(d, af, b0, b1);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[nt][j] += d[j];
    }
  }
}

template <int CIN_PAD, int COUT_PAD>
__global__ void __launch_bounds__(LayoutBf16<CIN_PAD, COUT_PAD>::kThreads)
    sparse_conv_bf16_kernel(const ParamsBf16 p) {
  using L = LayoutBf16<CIN_PAD, COUT_PAD>;
  constexpr int NT = COUT_PAD / 8, kThreads = L::kThreads, kWords = L::kWords;
  extern __shared__ uint4 smem_bf16[];
  const int K = p.num_offsets, S = p.stages;
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem_bf16);            // [S][kStage]
  int* nbr_s = reinterpret_cast<int*>(ring + S * L::kStage);         // [K][kTile]
  uint32_t* mask_s = reinterpret_cast<uint32_t*>(nbr_s + K * kTile);  // [K][kWords]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* act = reinterpret_cast<int*>(mask_s + K * kWords) + warp * K;  // this warp's list
  const int row0 = blockIdx.x * kTile;

  // the padding that no copy writes: zero it once
  if (p.cin < CIN_PAD || p.cout < COUT_PAD) {
    for (int e = tid; e < S * L::kStage / 8; e += kThreads) smem_bf16[e] = make_uint4(0, 0, 0, 0);
  }
  // the offsets any site of the tile hits, in order
  const int n_act = tile_prologue<kTileConv, kThreads>(p.nbr, p.cap_in, p.cap_out, K, row0, nbr_s,
                                                       mask_s, act, tid, lane);

  // active offset i -> stage i % S: its gathered rows and W[k]
  auto fetch = [&](int i) {
    const int k = act[i];
    uint16_t* rows = ring + (i % S) * L::kStage;
    uint16_t* w_s = rows + L::kStageA;
    const int* src_rows = nbr_s + k * kTile;
    if (p.vec_rows) {
      constexpr int kChunks = CIN_PAD / 8;
      for (int e = tid; e < kTile * kChunks; e += kThreads) {
        const int r = e / kChunks, c = (e % kChunks) * 8;
        if (c < p.cin) {
          const int src = src_rows[r];
          cp_async16_bf16(rows + r * L::kRowStride + c,
                          p.feats + static_cast<size_t>(src < 0 ? 0 : src) * p.cin + c, src >= 0);
        }
      }
    } else {  // synchronous: every column, zeros past cin and for a miss
      for (int e = tid; e < kTile * CIN_PAD; e += kThreads) {
        const int r = e / CIN_PAD, c = e % CIN_PAD;
        const int src = src_rows[r];
        rows[r * L::kRowStride + c] =
            src >= 0 && c < p.cin ? p.feats[static_cast<size_t>(src) * p.cin + c] : 0;
      }
    }
    const uint16_t* wk = p.weight + static_cast<size_t>(k) * p.cin * p.cout;
    if (p.vec_weight) {
      constexpr int kChunks = COUT_PAD / 8;
      for (int e = tid; e < p.cin * kChunks; e += kThreads) {
        const int ci = e / kChunks, c = (e % kChunks) * 8;
        if (c < p.cout) cp_async16_bf16(w_s + ci * L::kWStride + c, wk + ci * p.cout + c, true);
      }
    } else {
      for (int e = tid; e < p.cin * COUT_PAD; e += kThreads) {
        const int ci = e / COUT_PAD, c = e % COUT_PAD;
        w_s[ci * L::kWStride + c] = c < p.cout ? wk[ci * p.cout + c] : 0;
      }
    }
  };

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[nt][j] = 0.f;

  for (int i = 0; i < S - 1; ++i) {
    if (i < n_act) fetch(i);
    cp_async_commit();
  }
  const int word = warp * 16 / 32, shift = warp * 16 % 32;
  for (int i = 0; i < n_act; ++i) {
    cp_async_wait_oldest(S);  // this thread's copies of offset i have landed
    __syncthreads();          // and every thread's; offset i - 1's stage is free
    if (i + S - 1 < n_act) fetch(i + S - 1);
    cp_async_commit();
    const uint32_t mine = (mask_s[act[i] * kWords + word] >> shift) & 0xffffu;
    if (!mine) continue;
    mma_stage_bf16<CIN_PAD, COUT_PAD>(ring + (i % S) * L::kStage, acc, warp, lane);
  }

  // the fp32 epilogue from the fragments, one rounding to bf16
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = nt * 8 + 2 * t;
    if (col >= p.cout) continue;
    const bool two = col + 1 < p.cout;
    const float sc0 = p.scale ? p.scale[col] : 1.f, sh0 = p.shift ? p.shift[col] : 0.f;
    const float sc1 = p.scale && two ? p.scale[col + 1] : 1.f;
    const float sh1 = p.shift && two ? p.shift[col + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + warp * 16 + g + 8 * h;
      if (r >= p.cap_out) continue;
      const size_t o = static_cast<size_t>(r) * p.cout + col;
      float y0 = acc[nt][2 * h] * sc0 + sh0;
      float y1 = acc[nt][2 * h + 1] * sc1 + sh1;
      if (p.pair_out) {  // cout even: col + 1 < cout
        if (p.residual) {
          const uint32_t res = *reinterpret_cast<const uint32_t*>(p.residual + o);
          y0 += bf16_to_float(static_cast<uint16_t>(res & 0xffffu));
          y1 += bf16_to_float(static_cast<uint16_t>(res >> 16));
        }
        if (p.relu) {
          y0 = fmaxf(y0, 0.f);
          y1 = fmaxf(y1, 0.f);
        }
        *reinterpret_cast<uint32_t*>(p.out + o) = pack_bf16(float_to_bf16(y0), float_to_bf16(y1));
      } else {
        if (p.residual) {
          y0 += bf16_to_float(p.residual[o]);
          if (two) y1 += bf16_to_float(p.residual[o + 1]);
        }
        if (p.relu) {
          y0 = fmaxf(y0, 0.f);
          y1 = fmaxf(y1, 0.f);
        }
        p.out[o] = float_to_bf16(y0);
        if (two) p.out[o + 1] = float_to_bf16(y1);
      }
    }
  }
}

template <int CIN_PAD, int COUT_PAD>
cudaError_t launch_bf16(ParamsBf16 p, cudaStream_t stream) {
  using L = LayoutBf16<CIN_PAD, COUT_PAD>;
  const size_t fixed =
      static_cast<size_t>(p.num_offsets) * (kTile + L::kWords + L::kWarps) * sizeof(int);
  p.stages = 0;
  for (int s = kMaxStages; s >= 2 && !p.stages; --s)
    if (s * L::kStageBytes + fixed <= kTwoBlocksSmem) p.stages = s;
  for (int s = kMaxStages; s >= 2 && !p.stages; --s)
    if (s * L::kStageBytes + fixed <= kMaxSmem) p.stages = s;
  if (!p.stages) return cudaErrorInvalidValue;  // too many offsets for shared memory
  const size_t smem = p.stages * L::kStageBytes + fixed;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(sparse_conv_bf16_kernel<CIN_PAD, COUT_PAD>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (p.cap_out + kTile - 1) / kTile;
  sparse_conv_bf16_kernel<CIN_PAD, COUT_PAD><<<blocks, L::kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int CIN_PAD>
cudaError_t launch_cout_bf16(const ParamsBf16& p, cudaStream_t s) {
  if (p.cout <= 16) return launch_bf16<CIN_PAD, 16>(p, s);
  if (p.cout <= 32) return launch_bf16<CIN_PAD, 32>(p, s);
  if (p.cout <= 64) return launch_bf16<CIN_PAD, 64>(p, s);
  return launch_bf16<CIN_PAD, 128>(p, s);
}

}  // namespace

// The bf16 form: feats [cap_in, cin], weight [num_offsets, cin, cout],
// residual [cap_out, cout] or null and out [cap_out, cout] bf16; nbr
// [num_offsets, cap_out] int32 (-1 = miss); scale/shift [cout] fp32 or null;
// all contiguous device memory. Launches on `stream`, does not synchronise,
// and returns the launch's cudaError_t (0 on success).
extern "C" int bevf_sparse_conv_bf16(const void* feats, const int* nbr, const void* weight,
                                     const float* scale, const float* shift, const void* residual,
                                     void* out, int cap_in, int cap_out, int num_offsets, int cin,
                                     int cout, int relu, void* stream) {
  if (cin < 1 || cin > kMaxChannels || cout < 1 || cout > kMaxChannels || num_offsets < 1 ||
      cap_in < 0 || cap_out < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  ParamsBf16 p{static_cast<const uint16_t*>(feats), nbr, static_cast<const uint16_t*>(weight),
               scale, shift, static_cast<const uint16_t*>(residual), static_cast<uint16_t*>(out),
               cap_in, cap_out, num_offsets, cin, cout, relu, 0};
  p.vec_rows = cin % 8 == 0 && aligned(feats, 16);
  p.vec_weight = cout % 8 == 0 && aligned(weight, 16);
  p.pair_out = cout % 2 == 0 && aligned(out, 4) && (!residual || aligned(residual, 4));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (cin <= 16)
    err = launch_cout_bf16<16>(p, s);
  else if (cin <= 32)
    err = launch_cout_bf16<32>(p, s);
  else if (cin <= 64)
    err = launch_cout_bf16<64>(p, s);
  else
    err = launch_cout_bf16<128>(p, s);
  return static_cast<int>(err);
}
