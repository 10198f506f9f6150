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
// The bf16 form (bevf_sparse_conv_bf16, below; its loop in
// sparse_conv_bf16_tile.cuh) is the TPU kernels' own contract: bf16 rows,
// weights and residual, fp32 scale and shift, bf16 out rounded once from an
// fp32 epilogue. Its bound is 2 * Cin * Cout operations a hit pair at 989
// TFLOP/s or its bf16 bytes. Its first form ran the fp32 form's loop on bf16
// rows and reached 0.055-0.188 of that bound: K7's bf16 family put 48-74% of
// its time in the loop's floor (the barrier an offset over a 4-stage ring
// at 2-9 blocks an SM) and at C = 64 half in the product (four scalar loads
// and two packs a B fragment, a zeroed accumulator and four FP32 adds an
// mma). So the redesign, one block of 4 warps per tile of 64 output sites,
// each warp owning a 16-row slab:
// - No block barrier in the loop. W[k] passes through a ring of stages
//   shared by the 4 warps, every thread copying a share of it with
//   cp.async; each warp gathers its own rows into its own ring (misses
//   zero-filled) and stages `ahead` offsets ahead of the one it
//   multiplies. Each thread's copies arrive on the stage's full mbarrier
//   (cp.async.mbarrier.arrive), which a warp waits on before its product;
//   a warp releases the stage on its empty mbarrier after it. Warps walk
//   the offsets any row of the tile hits and skip the copies and product
//   of a 16-row slab none of whose rows hits. Only the tile's hit masks
//   cross warps: one barrier a block.
// - Two 16-row slabs a warp where Cin <= 16 and Cout <= 32 (128-site
//   tiles): there a slab's product is a few mma, and the bookkeeping an
//   offset costs is shared by both slabs.
// - The ring as deep as the most resident blocks an SM allow
//   (cudaOccupancyMaxActiveBlocksPerMultiprocessor at run time): in K7's
//   sweep resident blocks paid more than stages. Every W[k] resident in
//   shared memory (loaded once a block, a persistent grid) was measured
//   too and dropped: at 27 offsets it costs resident blocks at every width.
// - Fragments by ldmatrix: the A fragments of a 16-deep step by one
//   ldmatrix.x4 of the staged rows, the B fragments of two 8-column tiles
//   by one ldmatrix.x4.trans of W[k] ([Cin][Cout] row-major); strides of
//   Cin + 8 and Cout + 8 bf16 keep both free of bank conflicts.
// - One mma.sync m16n8k16 a step into the running sums: the sums stay on
//   the tensor cores across steps and offsets. Their accumulation
//   truncates (fp32 form above: 1.5e-5 relative over 27 offsets at C = 64),
//   some 500x inside one bf16 rounding.
// - The 5-channel input conv's rows are 10 bytes, only 2-byte aligned,
//   which cp.async cannot take: each row comes as the three aligned 4-byte
//   words that cover it (the bytes past the row zero-filled by a short
//   source size), so its copies are in flight like any other; a row that
//   starts mid-word lands one column early, and the warp shifts it into
//   place with a funnel shift once the stage has landed. Other widths that
//   are not multiples of 8 (no model's): 2-byte loads stored as they
//   arrive.
// The summation order is fixed (offsets in order, 16-deep steps in order)
// and does not depend on the ring's depth, so two calls, and any two
// depths, give equal bits. A padding tile still writes epilogue(0).

#include <cstdint>

#include <cuda_runtime.h>

#include "sparse_conv_bf16_tile.cuh"
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
// the bf16 form (its loop in sparse_conv_bf16_tile.cuh)
// ----------------------------------------------------------------------

namespace {

template <int CIN_PAD>
cudaError_t launch_cout_bf16(const ParamsBf16& p, cudaStream_t s, int* info) {
  if (p.cout <= 16) return run_bf16<kTileConv, CIN_PAD, 16>(p, s, info);
  if (p.cout <= 32) return run_bf16<kTileConv, CIN_PAD, 32>(p, s, info);
  if (p.cout <= 64) return run_bf16<kTileConv, CIN_PAD, 64>(p, s, info);
  return run_bf16<kTileConv, CIN_PAD, 128>(p, s, info);
}

cudaError_t launch_cin_bf16(const ParamsBf16& p, cudaStream_t s, int* info) {
  if (p.cin <= 16) return launch_cout_bf16<16>(p, s, info);
  if (p.cin <= 32) return launch_cout_bf16<32>(p, s, info);
  if (p.cin <= 64) return launch_cout_bf16<64>(p, s, info);
  return launch_cout_bf16<128>(p, s, info);
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
  const ParamsBf16 p = params_bf16(feats, nbr, weight, scale, shift, residual, out, cap_in,
                                   cap_out, num_offsets, cin, cout, relu);
  return static_cast<int>(launch_cin_bf16(p, static_cast<cudaStream_t>(stream), nullptr));
}

// What bevf_sparse_conv_bf16 would launch for these sizes (pointers assumed
// 16-byte aligned), into info[kPlanInfo] as run_bf16 (sparse_conv_bf16_tile.cuh)
// lays it out: resident blocks an SM, registers and spilled bytes a thread,
// shared memory, stages, offsets ahead, threads, grid, slabs a warp.
// Returns a cudaError_t.
extern "C" int bevf_sparse_conv_bf16_info(int cap_out, int num_offsets, int cin, int cout,
                                          int* info) {
  if (cin < 1 || cin > kMaxChannels || cout < 1 || cout > kMaxChannels || num_offsets < 1 ||
      cap_out < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const ParamsBf16 p = params_bf16(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                   0, cap_out, num_offsets, cin, cout, 0);
  return static_cast<int>(launch_cin_bf16(p, nullptr, info));
}
