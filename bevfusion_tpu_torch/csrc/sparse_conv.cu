// Sparse 3D convolution as a gather-GEMM over a neighbor table, fp32 in
// and out, with the eval-time BatchNorm / residual / ReLU epilogue fused.
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

#include <cstdint>

#include <cuda_runtime.h>

namespace {

// output sites a block; a block has one warp per 16-row mma slab of its tile
constexpr int kTile = 64;
constexpr int kMaxChannels = 128;
constexpr int kMaxStages = 4;
// dynamic shared memory a block may take and still leave room for a second
// block on the SM (228 KB an SM, 1 KB reserved a block), and the most one
// block may take
constexpr size_t kTwoBlocksSmem = 233472 / 2 - 1024;
constexpr size_t kMaxSmem = 232448;

struct Params {
  const float* feats;
  const int* nbr;
  const float* weight;
  const float* scale;
  const float* shift;
  const float* residual;
  float* out;
  int cap_in, cap_out, num_offsets, cin, cout, relu, stages;
  int vec_rows;    // feature rows 16-byte aligned: 16-byte copies, else 4-byte
  int vec_weight;  // the same for the rows of W[k]
  int pair_out;    // out (and residual) rows in 8-byte pairs
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// copies 16 (4) bytes, or writes zeros when `hit` is false (source size 0)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool hit) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(hit ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool hit) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(hit ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the newest `stages - 2` groups of this thread have landed
__device__ __forceinline__ void cp_async_wait_oldest(int stages) {
  if (stages >= 4)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (stages == 3)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// x = big + small, both TF32 (round to nearest, ties away from zero)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  const float rest = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

// d += a @ b on a 16x8x8 tile: A row-major, B column-major, fp32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int CIN_PAD, int COUT_PAD>
struct Layout {
  static constexpr int kWarps = kTile / 16;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kWords = kTile / 32;        // 32-bit hit-mask words of one offset
  static constexpr int kRowStride = CIN_PAD + 4;   // gathered rows: conflict-free A fragments
  static constexpr int kWStride = COUT_PAD + 8;    // W[k] rows: conflict-free B fragments
  static constexpr int kStageA = kTile * kRowStride;
  static constexpr int kStage = kStageA + CIN_PAD * kWStride;  // floats, a multiple of 4
  static constexpr size_t kStageBytes = static_cast<size_t>(kStage) * sizeof(float);
};

// acc[nt] + small[nt] += rows[16 of this warp] @ W[k][:, 8 nt : 8 nt + 8],
// 3xTF32: big*big' of each 8-deep step comes from a zero accumulator and is
// added into acc on the FP32 units (round to nearest); the two small terms
// accumulate in small on the tensor cores
template <int CIN_PAD, int COUT_PAD>
__device__ __forceinline__ void mma_stage(const float* stage, float (&acc)[COUT_PAD / 8][4],
                                          float (&small)[COUT_PAD / 8][4], int warp, int lane) {
  using L = Layout<CIN_PAD, COUT_PAD>;
  const int g = lane >> 2, t = lane & 3;
  const float* a = stage + (warp * 16 + g) * L::kRowStride + t;
  const float* b = stage + L::kStageA + t * L::kWStride + g;
#pragma unroll
  for (int kk = 0; kk < CIN_PAD; kk += 8) {
    uint32_t a_big[4], a_small[4];
    split_tf32(a[kk], a_big[0], a_small[0]);
    split_tf32(a[8 * L::kRowStride + kk], a_big[1], a_small[1]);
    split_tf32(a[kk + 4], a_big[2], a_small[2]);
    split_tf32(a[8 * L::kRowStride + kk + 4], a_big[3], a_small[3]);
#pragma unroll
    for (int nt = 0; nt < COUT_PAD / 8; ++nt) {
      uint32_t b_big0, b_small0, b_big1, b_small1;
      split_tf32(b[kk * L::kWStride + nt * 8], b_big0, b_small0);
      split_tf32(b[(kk + 4) * L::kWStride + nt * 8], b_big1, b_small1);
      mma_tf32(small[nt], a_small, b_big0, b_big1);
      mma_tf32(small[nt], a_big, b_small0, b_small1);
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      mma_tf32(d, a_big, b_big0, b_big1);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[nt][j] += d[j];
    }
  }
}

template <int CIN_PAD, int COUT_PAD>
__global__ void __launch_bounds__(Layout<CIN_PAD, COUT_PAD>::kThreads)
    sparse_conv_tc_kernel(const Params p) {
  using L = Layout<CIN_PAD, COUT_PAD>;
  constexpr int NT = COUT_PAD / 8, kThreads = L::kThreads, kWords = L::kWords;
  extern __shared__ __align__(16) float smem[];
  const int K = p.num_offsets, S = p.stages;
  float* ring = smem;                                                 // [S][kStage]
  int* nbr_s = reinterpret_cast<int*>(smem + S * L::kStage);         // [K][kTile]
  uint32_t* mask_s = reinterpret_cast<uint32_t*>(nbr_s + K * kTile);  // [K][kWords]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* act = reinterpret_cast<int*>(mask_s + K * kWords) + warp * K;  // this warp's list
  const int row0 = blockIdx.x * kTile;

  // the channel padding is never written by the copies: zero it once
  if (p.cin < CIN_PAD || p.cout < COUT_PAD) {
    float4* r4 = reinterpret_cast<float4*>(ring);
    for (int e = tid; e < S * L::kStage / 4; e += kThreads)
      r4[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // the tile's neighbor rows, and one hit bit per (offset, site); a warp
  // covers 32 sites of one offset; kLoads loads in flight a thread
  constexpr int kLoads = 4;
  for (int e0 = tid; e0 < K * kTile; e0 += kLoads * kThreads) {
    int src[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int e = e0 + j * kThreads, row = row0 + e % kTile;
      src[j] = e < K * kTile && row < p.cap_out
                   ? __ldg(p.nbr + static_cast<size_t>(e / kTile) * p.cap_out + row)
                   : -1;
    }
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int e = e0 + j * kThreads;
      if (e >= K * kTile) break;  // the same for the whole warp
      const int v = src[j] < 0 || src[j] >= p.cap_in ? -1 : src[j];
      nbr_s[e] = v;
      const uint32_t hits = __ballot_sync(0xffffffffu, v >= 0);
      if (lane == 0) mask_s[e / 32] = hits;
    }
  }
  __syncthreads();

  int n_act = 0;  // the offsets any site of the tile hits, in order
  for (int base = 0; base < K; base += 32) {
    const int k = base + lane;
    uint32_t any = 0;
    if (k < K) {
#pragma unroll
      for (int j = 0; j < kWords; ++j) any |= mask_s[k * kWords + j];
    }
    const uint32_t b = __ballot_sync(0xffffffffu, any != 0);
    if (any) act[n_act + __popc(b & ((1u << lane) - 1u))] = k;
    n_act += __popc(b);
  }
  __syncwarp();

  // active offset i -> stage i % S: its gathered rows and W[k]
  auto fetch = [&](int i) {
    const int k = act[i];
    float* rows = ring + (i % S) * L::kStage;
    float* w_s = rows + L::kStageA;
    const int* src_rows = nbr_s + k * kTile;
    if (p.vec_rows) {
      constexpr int kChunks = CIN_PAD / 4;
      for (int e = tid; e < kTile * kChunks; e += kThreads) {
        const int r = e / kChunks, c = (e % kChunks) * 4;
        if (c < p.cin) {
          const int src = src_rows[r];
          cp_async16(rows + r * L::kRowStride + c,
                     p.feats + static_cast<size_t>(src < 0 ? 0 : src) * p.cin + c, src >= 0);
        }
      }
    } else {
      for (int e = tid; e < kTile * CIN_PAD; e += kThreads) {
        const int r = e / CIN_PAD, c = e % CIN_PAD;
        if (c < p.cin) {
          const int src = src_rows[r];
          cp_async4(rows + r * L::kRowStride + c,
                    p.feats + static_cast<size_t>(src < 0 ? 0 : src) * p.cin + c, src >= 0);
        }
      }
    }
    const float* wk = p.weight + static_cast<size_t>(k) * p.cin * p.cout;
    if (p.vec_weight) {
      constexpr int kChunks = COUT_PAD / 4;
      for (int e = tid; e < p.cin * kChunks; e += kThreads) {
        const int ci = e / kChunks, c = (e % kChunks) * 4;
        if (c < p.cout) cp_async16(w_s + ci * L::kWStride + c, wk + ci * p.cout + c, true);
      }
    } else {
      for (int e = tid; e < p.cin * COUT_PAD; e += kThreads) {
        const int ci = e / COUT_PAD, c = e % COUT_PAD;
        if (c < p.cout) cp_async4(w_s + ci * L::kWStride + c, wk + ci * p.cout + c, true);
      }
    }
  };

  float acc[NT][4], small[NT][4];  // big*big' (fp32 adds), small terms (tensor cores)
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[nt][j] = small[nt][j] = 0.f;

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
    if (COUT_PAD <= 64) {  // the offset's own fp32 sum first, then the running one
      float part[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[nt][j] = 0.f;
      mma_stage<CIN_PAD, COUT_PAD>(ring + (i % S) * L::kStage, part, small, warp, lane);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[nt][j] += part[nt][j];
    } else {  // registers: at 128 columns a third set of sums would spill
      mma_stage<CIN_PAD, COUT_PAD>(ring + (i % S) * L::kStage, acc, small, warp, lane);
    }
  }

  // epilogue from the fragments: thread (g, t) holds rows g, g + 8 of its
  // slab and columns 2t, 2t + 1 of every 8-column tile
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
      float y0 = (acc[nt][2 * h] + small[nt][2 * h]) * sc0 + sh0;
      float y1 = (acc[nt][2 * h + 1] + small[nt][2 * h + 1]) * sc1 + sh1;
      if (p.pair_out) {  // cout even: col + 1 < cout
        if (p.residual) {
          const float2 res = *reinterpret_cast<const float2*>(p.residual + o);
          y0 += res.x;
          y1 += res.y;
        }
        if (p.relu) {
          y0 = fmaxf(y0, 0.f);
          y1 = fmaxf(y1, 0.f);
        }
        *reinterpret_cast<float2*>(p.out + o) = make_float2(y0, y1);
      } else {
        if (p.residual) {
          y0 += p.residual[o];
          if (two) y1 += p.residual[o + 1];
        }
        if (p.relu) {
          y0 = fmaxf(y0, 0.f);
          y1 = fmaxf(y1, 0.f);
        }
        p.out[o] = y0;
        if (two) p.out[o + 1] = y1;
      }
    }
  }
}

template <int CIN_PAD, int COUT_PAD>
cudaError_t launch(Params p, cudaStream_t stream) {
  using L = Layout<CIN_PAD, COUT_PAD>;
  // nbr_s, mask_s and the warps' active lists
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
    const cudaError_t err =
        cudaFuncSetAttribute(sparse_conv_tc_kernel<CIN_PAD, COUT_PAD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (p.cap_out + kTile - 1) / kTile;
  sparse_conv_tc_kernel<CIN_PAD, COUT_PAD><<<blocks, L::kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int CIN_PAD>
cudaError_t launch_cout(const Params& p, cudaStream_t s) {
  if (p.cout <= 16) return launch<CIN_PAD, 16>(p, s);
  if (p.cout <= 32) return launch<CIN_PAD, 32>(p, s);
  if (p.cout <= 64) return launch<CIN_PAD, 64>(p, s);
  return launch<CIN_PAD, 128>(p, s);
}

cudaError_t launch_cin(const Params& p, cudaStream_t s) {
  if (p.cin <= 8) return launch_cout<8>(p, s);
  if (p.cin <= 16) return launch_cout<16>(p, s);
  if (p.cin <= 32) return launch_cout<32>(p, s);
  if (p.cin <= 64) return launch_cout<64>(p, s);
  return launch_cout<128>(p, s);
}

bool aligned(const void* ptr, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
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
