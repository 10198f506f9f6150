// Weight gradient of the sparse gather-GEMM conv, fp32 in and out (and,
// below, the C interface of its bf16 form, whose kernels and design note are
// in sparse_conv_dw_bf16.cuh: bf16 in, fp32 out; its pass 2 is this form's).
//
//   dW[k, ci, co] = sum_o feats[nbr[k, o], ci] * dout[o, co],
//   nbr = -1 or nbr >= cap_in skips
//
// Replaces the TPU kernel bevfusion_tpu/ops/sparse_conv_windowed.py:
// `_kernel_dw` (reached through windowed_gather_dw). That kernel builds
// the gathered rows of one site block with one-hot matmuls over a DMA'd
// window, then adds A^T @ dout into one VMEM-resident dW as the grid
// steps run in order (`dw_ref +=`), with packed 128-lane sites folded back
// at the end. None of that carries over: blocks run in parallel and in no
// order here, and a block gathers rows straight into shared memory.
//
// What bounds it on an H100. Per hit pair (an output site o whose offset-k
// neighbor exists) the product does 2 * Cin * Cout flops; on the tensor
// cores in the 3xTF32 split below that is three TF32 products, 3 * 2 *
// Cin * Cout operations at 495 TFLOP/s. The bytes are each input once
// (feats, the [K, cap_out] table, dout) and dW, at 3.35 TB/s. At the
// encoder's shapes the table's bytes bound it up to C = 32 and the TF32
// products from C = 64 on. The first form of this kernel reached 0.9-5.7%
// of that: a scalar FMA loop with one shared-memory load per FMA, 64-site
// tiles that ran all 64 rows whenever any one of them hit (21% of the
// stage-0 slots hit), and dout reloaded synchronously for every (offset,
// tile), so nothing was in flight while it multiplied.
//
// Design: pass 1, one block of 8 warps per (offset k, chunk of `chunk`
// output sites); pass 2 sums the blocks' partials.
// - Hit pairs: the block loads nbr[k, chunk] once (coalesced, 4 loads in
//   flight a thread); warp ballots and one prefix over the warps' counts
//   compact the chunk's hit pairs (src row, output site) in site order into
//   shared memory. A miss costs nothing beyond that vote; a chunk with no
//   hit stores zeros and ends.
// - The product D = P^T Q over the hit pairs, the sites as the reduction
//   depth: P is the wider of the gathered dout and feats rows (padded to a
//   multiple of 16, the mma's M), Q the other (padded to 8, the mma's N).
//   At the input conv (5 -> 16) that is M = Cout = 16 and N = Cin padded to
//   8. A warp owns one 16-row slab of D and every column; the 8 warps split
//   the slabs and, where there are fewer than 8, the 8-site mma steps
//   (warp group g takes steps g, g + G, ...).
// - A ring of 2-4 stages in shared memory, each holding the P and Q rows of
//   the next 32 hit pairs (64 at M = 16), filled with cp.async: 16-byte .cg
//   copies, 4-byte ones where a row is not 16-byte aligned (Cin = 5), zeros
//   (source size 0) past the last hit. The next stages - 1 steps are in
//   flight while the tensor cores work on the oldest; one barrier a stage.
//   Stages and blocks an SM are chosen together from the shared memory
//   (below). The channel padding is zeroed once a block.
// - Row strides of 8 or 24 mod 32 floats (24, 40, 72, 136 for widths 16,
//   32, 64, 128) make the fragment loads, which read both operands
//   column-wise here, free of shared-memory bank conflicts.
// - mma.sync m16n8k8 with TF32 inputs in the 3xTF32 split (x = big + small,
//   both cvt.rna.tf32; small * small' dropped, ~2^-22 relative). The
//   tensor cores' fp32 accumulation truncates, and this reduction runs
//   hundreds of steps deep, far deeper than the forward's 27 offsets. So
//   each 8-deep big * big' product starts from a zero accumulator and is
//   added on the FP32 units (round to nearest) into the warp's own sum, and
//   only the small terms, 2^-11 of the size, accumulate on the tensor
//   cores. tests/test_torch_dw_numerics.py emulates this order on the CPU
//   against float64, and shows that one accumulator carried on the tensor
//   cores through a chunk misses the same gate.
// - The warps' sums go through shared memory and are added in warp-group
//   order; each block stores its [Cin, Cout] partial once; pass 2
//   (sparse_conv_dw_bf16.cuh:sum_parts_kernel, shared with the bf16 form)
//   adds the partials of each dW element in chunk order. No atomics and a fixed
//   order of summation: two calls give equal bits. The partial scratch,
//   chunks x K x Cin x Cout fp32, is written once and read once.
//
// Grid and occupancy at chunk = 2048 (the wrapper's DW_CHUNK), on the
// flagship's scan: the input and stage-0 convs (cap_out 160,000, 70,748
// valid), the strided 16 -> 32 and stage-1 convs (100,000; 74,134) and the
// strided 32 -> 64 and stage-2 convs (60,000; 49,178) give 79 / 49 / 30
// chunks, so 2,133 / 1,323 / 810 blocks over the 27 offsets, of which 35 /
// 37 / 25 chunks an offset hold valid sites (the rest store zeros at
// once): 945 / 999 / 675 working blocks, several waves on the 132 SMs.
// The hit list takes 16 KB of shared memory and a ring stage 8-18 KB at
// these widths; registers (63-128 a thread, ptxas) hold an SM to 2-4
// blocks of 8 warps. The partial scratch is 0.2-13 MB (64 -> 64: 30 x 27
// x 4,096 floats), written and read once, mostly in L2.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase 4), at the
// six shapes input 5 -> 16, stage-0 16 -> 16, strided 16 -> 32, stage-1
// 32 -> 32, strided 32 -> 64, stage-2 64 -> 64: 0.0556 / 0.0580 / 0.0522 /
// 0.1777 / 0.1121 / 0.3377 ms, 0.165 / 0.194 / 0.194 / 0.061 / 0.093 /
// 0.121 of the bound (bytes up to the strided 32 -> 64 conv, the TF32
// products at 64 -> 64), 0.52-0.96x the forward kernel's time at the same
// shape in the same run, and 1.9e-7 to 2.8e-7 of scale from the float64
// product (cuBLAS fp32: 3.9e-7 to 1.2e-6). What holds the C = 32 shapes
// lowest is not measured here (no profiler runs on that machine).

#include <cstdint>

#include <cuda_runtime.h>

#include "sparse_conv_dw_bf16.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxChannels = 128;
constexpr int kMaxChunk = 4096;  // output sites a block, at most (its hit list is in smem)
constexpr int kLoads = 4;        // nbr loads in flight a thread while compacting
constexpr size_t kSmPerSm = 233472;  // shared memory an SM, 1 KB of it reserved a block
constexpr size_t kMaxSmem = 232448;  // the most one block may take

// a row stride >= width that is 8 or 24 mod 32 elements: the fragment loads
// (lanes 4 apart in the row index, 1 apart in the column) hit 32 banks
constexpr int conflict_free_stride(int width) {
  return width % 32 == 8 || width % 32 == 24 ? width : conflict_free_stride(width + 4);
}

template <int MP, int NQ>
struct Layout {
  static constexpr int kDepth = 8;                        // sites an mma step
  static constexpr int kSlabs = MP / 16;                  // 16-row slabs of D
  static constexpr int kGroups = kWarps / kSlabs;         // warps that share a slab
  static constexpr int kSteps = kGroups > 4 ? kGroups : 4;  // mma steps a stage
  static constexpr int kSites = kDepth * kSteps;          // hit pairs a stage
  static constexpr int kStrideP = conflict_free_stride(MP);
  static constexpr int kStrideQ = conflict_free_stride(NQ);
  static constexpr int kStageP = kSites * kStrideP;
  static constexpr int kStage = kStageP + kSites * kStrideQ;  // elements, 16-byte multiples
  static constexpr size_t kStageBytes = static_cast<size_t>(kStage) * sizeof(float);
  static_assert(kSlabs * kGroups == kWarps && kSteps % kGroups == 0, "warp split");
  static_assert(kStageBytes % 16 == 0, "stage alignment");
  // the warps' fp32 sums [kGroups][MP][NQ] reuse two stages of the ring
  static_assert(kGroups * MP * NQ * sizeof(float) <= 2 * kStageBytes, "reduction scratch");
};

struct Params {
  const float* feats;
  const int* nbr;
  const float* dout;
  float* partial;
  int cap_in, cap_out, num_offsets, cin, cout, chunk, stages;
  int p_is_dout;  // P = dout (Cout >= Cin), else P = feats
  int vec_feats;  // feats rows 16-byte aligned: 16-byte copies, else 4-byte
  int vec_dout;   // the same for dout
};

// rows [first, first + kSites) of the hit list -> a stage's [kSites][STRIDE]
// block: row r from base + list[first + r] * width, zeros past n_hits
template <int WIDTH, int STRIDE, int SITES>
__device__ __forceinline__ void fetch_rows(float* dst, const float* base, int width, bool vec,
                                           const int* list, int first, int n_hits, int tid) {
  if (vec) {
    constexpr int kChunks = WIDTH / 4;
    for (int e = tid; e < SITES * kChunks; e += kThreads) {
      const int r = e / kChunks, c = (e % kChunks) * 4;
      if (c < width) {
        const bool hit = first + r < n_hits;
        const int row = hit ? list[first + r] : 0;
        cp_async16(dst + r * STRIDE + c, base + static_cast<size_t>(row) * width + c, hit);
      }
    }
  } else {
    for (int e = tid; e < SITES * WIDTH; e += kThreads) {
      const int r = e / WIDTH, c = e % WIDTH;
      if (c < width) {
        const bool hit = first + r < n_hits;
        const int row = hit ? list[first + r] : 0;
        cp_async4(dst + r * STRIDE + c, base + static_cast<size_t>(row) * width + c, hit);
      }
    }
  }
}

// acc + small += P[steps of this warp's group]^T Q on this warp's slab,
// 3xTF32: big*big' of each 8-deep step comes from a zero accumulator and
// is added into acc on the FP32 units; the small terms accumulate in small
// on the tensor cores. A[m][kk] = P[s + kk][m], B[kk][n] = Q[s + kk][n].
template <int MP, int NQ>
__device__ __forceinline__ void mma_stage(const float* stage, float (&acc)[NQ / 8][4],
                                          float (&small)[NQ / 8][4], int slab, int group,
                                          int lane) {
  using L = Layout<MP, NQ>;
  const int g = lane >> 2, t = lane & 3;
  const float* pa = stage + t * L::kStrideP + slab * 16 + g;
  const float* qb = stage + L::kStageP + t * L::kStrideQ + g;
#pragma unroll
  for (int i = 0; i < L::kSteps / L::kGroups; ++i) {
    const int step = group + i * L::kGroups;
    const float* a = pa + step * 8 * L::kStrideP;
    const float* b = qb + step * 8 * L::kStrideQ;
    uint32_t a_big[4], a_small[4];
    split_tf32(a[0], a_big[0], a_small[0]);
    split_tf32(a[8], a_big[1], a_small[1]);
    split_tf32(a[4 * L::kStrideP], a_big[2], a_small[2]);
    split_tf32(a[4 * L::kStrideP + 8], a_big[3], a_small[3]);
#pragma unroll
    for (int nt = 0; nt < NQ / 8; ++nt) {
      uint32_t b_big0, b_small0, b_big1, b_small1;
      split_tf32(b[nt * 8], b_big0, b_small0);
      split_tf32(b[4 * L::kStrideQ + nt * 8], b_big1, b_small1);
      mma_tf32(small[nt], a_small, b_big0, b_big1);
      mma_tf32(small[nt], a_big, b_small0, b_small1);
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      mma_tf32(d, a_big, b_big0, b_big1);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[nt][j] += d[j];
    }
  }
}

template <int MP, int NQ>
__global__ void __launch_bounds__(kThreads) sparse_conv_dw_tc_kernel(const Params p) {
  using L = Layout<MP, NQ>;
  constexpr int NT = NQ / 8;
  extern __shared__ __align__(16) float smem[];
  const int S = p.stages;
  float* ring = smem;                                          // [S][kStage]
  int* src_s = reinterpret_cast<int*>(ring + S * L::kStage);  // [chunk] hit pairs: feats row
  int* out_s = src_s + p.chunk;                                // [chunk] and output site
  int* counts = out_s + p.chunk;                               // [2][kLoads * kWarps]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k = blockIdx.y;
  const int begin = blockIdx.x * p.chunk;
  const int end = min(begin + p.chunk, p.cap_out);
  const int* nbr_k = p.nbr + static_cast<size_t>(k) * p.cap_out;
  float* part =
      p.partial + (static_cast<size_t>(blockIdx.x) * p.num_offsets + k) * p.cin * p.cout;

  // 1. the chunk's hit pairs, in site order: site e0 + j * kThreads + tid
  //    is thread tid's j-th load of a round
  int n_hits = 0;
  for (int round = 0, e0 = begin; e0 < end; ++round, e0 += kLoads * kThreads) {
    int src[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int o = e0 + j * kThreads + tid;
      src[j] = o < end ? __ldg(nbr_k + o) : -1;
    }
    int* cnt = counts + (round & 1) * kLoads * kWarps;
    uint32_t hits[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      if (src[j] >= p.cap_in) src[j] = -1;
      hits[j] = __ballot_sync(0xffffffffu, src[j] >= 0);
      if (lane == 0) cnt[j * kWarps + warp] = __popc(hits[j]);
    }
    __syncthreads();
    int run = n_hits, off[kLoads];
#pragma unroll
    for (int q = 0; q < kLoads * kWarps; ++q) {
      if (q % kWarps == warp) off[q / kWarps] = run;
      run += cnt[q];
    }
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      if (src[j] >= 0) {
        const int slot = off[j] + __popc(hits[j] & ((1u << lane) - 1u));
        src_s[slot] = src[j];
        out_s[slot] = e0 + j * kThreads + tid;
      }
    }
    n_hits = run;  // the counts buffer of this round is reused two rounds on,
                   // after the next round's barrier
  }
  if (n_hits == 0) {  // the same for the whole block
    for (int e = tid; e < p.cin * p.cout; e += kThreads) part[e] = 0.f;
    return;
  }
  // the channel padding is never written by the copies: zero it once
  const int wp = p.p_is_dout ? p.cout : p.cin, wq = p.p_is_dout ? p.cin : p.cout;
  if (wp < MP || wq < NQ) {
    float4* r4 = reinterpret_cast<float4*>(ring);
    for (int e = tid; e < static_cast<int>(S * L::kStageBytes / 16); e += kThreads)
      r4[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();  // the hit list, and the zeros before any copy lands

  const float* p_base = p.p_is_dout ? p.dout : p.feats;
  const float* q_base = p.p_is_dout ? p.feats : p.dout;
  const bool p_vec = p.p_is_dout ? p.vec_dout : p.vec_feats;
  const bool q_vec = p.p_is_dout ? p.vec_feats : p.vec_dout;
  const int* p_list = p.p_is_dout ? out_s : src_s;
  const int* q_list = p.p_is_dout ? src_s : out_s;
  auto fetch = [&](int i) {
    float* stage = ring + (i % S) * L::kStage;
    const int first = i * L::kSites;
    fetch_rows<MP, L::kStrideP, L::kSites>(stage, p_base, wp, p_vec, p_list, first, n_hits, tid);
    fetch_rows<NQ, L::kStrideQ, L::kSites>(stage + L::kStageP, q_base, wq, q_vec, q_list, first,
                                           n_hits, tid);
  };

  float acc[NT][4], small[NT][4];  // big*big' (fp32 adds), small terms (tensor cores)
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[nt][j] = small[nt][j] = 0.f;

  // 2. the ring: stage i holds hit pairs [i * kSites, (i + 1) * kSites)
  const int n_stages = (n_hits + L::kSites - 1) / L::kSites;
  const int slab = warp % L::kSlabs, group = warp / L::kSlabs;
  for (int i = 0; i < S - 1; ++i) {
    if (i < n_stages) fetch(i);
    cp_async_commit();
  }
  for (int i = 0; i < n_stages; ++i) {
    cp_async_wait_oldest(S);  // this thread's copies of stage i have landed
    __syncthreads();          // and every thread's; stage i - 1's slot is free
    if (i + S - 1 < n_stages) fetch(i + S - 1);
    cp_async_commit();
    mma_stage<MP, NQ>(ring + (i % S) * L::kStage, acc, small, slab, group, lane);
  }

  // 3. the warps' sums, then the block's partial: thread (g, t) holds rows
  //    g, g + 8 of its slab and columns 2t, 2t + 1 of every 8-column tile
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();  // every warp is done with the ring
  float* red = smem;  // [kGroups][MP][NQ]
  {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = slab * 16 + g + 8 * (j >> 1), n = nt * 8 + 2 * t + (j & 1);
        red[(group * MP + m) * NQ + n] = acc[nt][j] + small[nt][j];
      }
  }
  __syncthreads();
  for (int e = tid; e < p.cin * p.cout; e += kThreads) {
    const int ci = e / p.cout, co = e % p.cout;
    const int idx = p.p_is_dout ? co * NQ + ci : ci * NQ + co;
    float s = red[idx];
#pragma unroll
    for (int gr = 1; gr < L::kGroups; ++gr) s += red[gr * MP * NQ + idx];
    part[e] = s;
  }
}

// (stages, blocks an SM) in the order they are tried: at least 3 stages
// with the most blocks, then 2 stages, then one block
constexpr int kPlans[][2] = {{4, 4}, {3, 4}, {4, 3}, {3, 3}, {4, 2}, {3, 2}, {2, 4},
                             {2, 3}, {2, 2}, {4, 1}, {3, 1}, {2, 1}};

template <int MP, int NQ>
cudaError_t launch(Params p, cudaStream_t stream) {
  using L = Layout<MP, NQ>;
  const size_t fixed = (2 * static_cast<size_t>(p.chunk) + 2 * kLoads * kWarps) * sizeof(int);
  size_t smem = 0;
  p.stages = 0;
  for (const auto& plan : kPlans) {
    const size_t need = plan[0] * L::kStageBytes + fixed;
    const size_t room = plan[1] == 1 ? kMaxSmem : kSmPerSm / plan[1] - 1024;
    if (need <= room) {
      p.stages = plan[0];
      smem = need;
      break;
    }
  }
  if (!p.stages) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(sparse_conv_dw_tc_kernel<MP, NQ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((p.cap_out + p.chunk - 1) / p.chunk, p.num_offsets);
  sparse_conv_dw_tc_kernel<MP, NQ><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int MP>
cudaError_t launch_nq(const Params& p, int nq, cudaStream_t s) {
  if (nq <= 8) return launch<MP, 8>(p, s);
  if constexpr (MP >= 16) {
    if (nq <= 16) return launch<MP, 16>(p, s);
  }
  if constexpr (MP >= 32) {
    if (nq <= 32) return launch<MP, 32>(p, s);
  }
  if constexpr (MP >= 64) {
    if (nq <= 64) return launch<MP, 64>(p, s);
  }
  if constexpr (MP >= 128) return launch<MP, 128>(p, s);
  return cudaErrorInvalidValue;
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

// both passes; 16-byte copies need rows of 16-byte multiples
int run_passes(const float* feats, const int* nbr, const float* dout, float* partial, float* dw,
               int cap_in, int cap_out, int num_offsets, int cin, int cout, int chunk,
               void* stream) {
  if (cin < 1 || cin > kMaxChannels || cout < 1 || cout > kMaxChannels || num_offsets < 1 ||
      num_offsets > 65535 || cap_in < 0 || cap_out < 1 || chunk < 1 || chunk > kMaxChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(num_offsets) * cin * cout;
  if (n > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  Params p{feats, nbr, dout, partial, cap_in, cap_out, num_offsets, cin, cout, chunk, 0};
  p.p_is_dout = cout >= cin;
  p.vec_feats = cin % 4 == 0 && aligned16(feats);
  p.vec_dout = cout % 4 == 0 && aligned16(dout);
  const int mp = p.p_is_dout ? cout : cin, nq = p.p_is_dout ? cin : cout;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (mp <= 16)
    err = launch_nq<16>(p, nq, s);
  else if (mp <= 32)
    err = launch_nq<32>(p, nq, s);
  else if (mp <= 64)
    err = launch_nq<64>(p, nq, s);
  else
    err = launch_nq<128>(p, nq, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int num_chunks = (cap_out + chunk - 1) / chunk;
  dwb::sum_parts_kernel<<<static_cast<unsigned>((n + dwb::kSumThreads - 1) / dwb::kSumThreads),
                          dwb::kSumThreads, 0, s>>>(partial, dw, num_chunks, static_cast<int>(n));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// feats [cap_in, cin], nbr [num_offsets, cap_out] int32 (-1 = miss),
// dout [cap_out, cout], partial [ceil(cap_out / chunk), num_offsets, cin,
// cout] scratch, dw [num_offsets, cin, cout]; all contiguous fp32 device
// memory (nbr int32). 1 <= chunk <= 4096. Launches both passes on
// `stream`, does not synchronise, and returns the first failed launch's
// cudaError_t (0 on success).
extern "C" int bevf_sparse_conv_dw_f32(const float* feats, const int* nbr, const float* dout,
                                       float* partial, float* dw, int cap_in, int cap_out,
                                       int num_offsets, int cin, int cout, int chunk,
                                       void* stream) {
  return run_passes(feats, nbr, dout, partial, dw, cap_in, cap_out, num_offsets, cin, cout,
                    chunk, stream);
}

// The bf16 form (its kernel in sparse_conv_dw_bf16.cuh): feats [cap_in,
// cin] and dout [cap_out, cout] bf16, nbr [num_offsets, cap_out] int32 (-1 =
// miss), partial [ceil(cap_out / chunk), num_offsets, cin, cout] scratch and
// dw [num_offsets, cin, cout] fp32; all contiguous device memory. 1 <=
// chunk <= 2048. Launches both passes on `stream`, does not synchronise, and
// returns the first failed launch's cudaError_t (0 on success).
extern "C" int bevf_sparse_conv_dw_bf16(const void* feats, const int* nbr, const void* dout,
                                        float* partial, float* dw, int cap_in, int cap_out,
                                        int num_offsets, int cin, int cout, int chunk,
                                        void* stream) {
  return dwb::run<dwb::kDwConv>(feats, nbr, dout, dw, partial, cap_in, cap_out, num_offsets, cin,
                                cout, chunk, stream, nullptr);
}

// What bevf_sparse_conv_dw_bf16's pass 1 would launch for these sizes
// (pointers assumed 16-byte aligned), into info[dwb::kPlanInfo] as dwb::run
// lays it out; launches nothing. Returns a cudaError_t.
extern "C" int bevf_sparse_conv_dw_bf16_info(int cap_out, int num_offsets, int cin, int cout,
                                             int chunk, int* info) {
  return dwb::run<dwb::kDwConv>(nullptr, nullptr, nullptr, nullptr, nullptr, 0, cap_out,
                                num_offsets, cin, cout, chunk, nullptr, info);
}
