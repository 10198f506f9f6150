// The weight-gradient kernel's bf16 form (K3 bf16): bf16 feats and dout,
// an fp32 dW whose products are exact, a fixed order of summation.
//
//   dW[k, ci, co] = sum_o feats[nbr[k, o], ci] * dout[o, co],
//   nbr = -1 or nbr >= cap_in skips
//
// Replaces the TPU kernel bevfusion_tpu/ops/sparse_conv_windowed.py:
// `_kernel_dw` (reached through windowed_gather_dw) at its own precision,
// bf16 rows in and an fp32 dW out. sparse_conv_dw.cu instantiates the
// production mode and exports it; sparse_conv_variants.cu instantiates the
// modes of K7's dw_bf16 family, each of which changes one part:
//
//   kDwConv       dw_bf16            the kernel
//   kDwNoGather   dw_bf16_nogather   each hit pair's own site row of feats in
//                                    place of the gathered one
//   kDwNoProduct  dw_bf16_noproduct  the scan and the ring, no mma: every
//                                    element of dW[k] the hit pairs of k
//   kDwCompact    dw_bf16_compact    the scan alone: the same count
//
// What bounds it on an H100: per hit pair 2 * Cin * Cout operations at 989
// TFLOP/s, or the bytes of the bf16 rows, the [K, cap_out] table and dW once
// at 3.35 TB/s (the table's bytes up to C = 32, the operations at 64 -> 64).
// What it moves in fact is more: a hit pair gathers its feats row and its
// dout row from L2 (each row read once for every offset it hits, 128-256
// bytes a pair at 32-64 channels), so at the encoder's wide shapes the L2's
// rate bounds it first.
//
// Its first form (sparse_conv_dw.cu's fp32 loop on bf16 rows) reached
// 0.049-0.219 of its bound. K7's dw_bf16 family put half of its time at 32
// and 64 channels in the product (each fragment built from 2-byte shared
// loads, a zeroed product and four FP32 adds an mma), then the ring's block
// barrier a stage; at 16 channels half in the table scan, the partial
// store and the second pass.
//
// Design: pass 1, one block of 4-8 warps (two teams, below) per (chunk of
// `chunk` output sites, offset k); pass 2 (sum_parts_kernel) adds the
// blocks' parts of each dW element in chunk order.
// - The hit pairs: the block loads nbr[k, chunk] once (coalesced, kLoads
//   loads in flight a thread); warp ballots and a prefix over the warps'
//   counts compact them (feats row, output site) in site order into shared
//   memory. A chunk with no hit stores zeros and ends.
// - Teams: 1-8 warps that share a ring of stages; each warp holds the sums
//   of H 16-row slabs of D = P^T Q (P the wider of the gathered dout and
//   feats rows, padded to 16..128; Q the other, padded to 8..128) and every
//   column: H = 2 where Q is 8-32 wide, so a team is one warp at 16 and 32
//   channels, two at 32 -> 64, four at 64 -> 64. Stage j of the block (hit
//   pairs 32 j .. 32 j + 31) goes to team j mod G.
// - The ring: a stage holds the P and Q rows of kStageHits hit pairs, rows
//   of 16-byte multiples by 16-byte cp.async copies (zeros past the last
//   hit), the input conv's 10-byte feats rows by the aligned words that
//   cover them (bf16_mma.cuh) and a shift once landed, any other width by
//   2-byte loads. No block barrier: each thread's copies arrive on the
//   stage's full mbarrier (cp.async.mbarrier.arrive.noinc), each warp on its
//   empty mbarrier once it has multiplied it. Row strides of width + 8 bf16
//   (8 at width 8) keep ldmatrix free of bank conflicts. The launch takes
//   the most resident blocks an SM, then the most stages that keep them.
// - The product: both operands are stored site-major and the sites are the
//   mma's depth, so each fragment comes by one ldmatrix.x4.trans (x2 for Q
//   at 8 columns); one bf16 mma.sync m16n8k16 a 16-site step and 8-column
//   tile.
// - The sums: the tensor cores' fp32 accumulation truncates, so the steps
//   are carried on them for kRun steps (128 sites) from a zero accumulator,
//   then added into the warp's FP32 sum (round to nearest).
//   tests/test_torch_dw_numerics.py models this order on the CPU: 5.4e-7 of
//   scale from float64 on a 4,096-hit same-signed stream, where one
//   accumulator through the stream is 6.5e-5 and past the 1e-4 gate at
//   16,384 hits.
// - The teams' sums go through shared memory and are added in team order;
//   each block stores its [Cin, Cout] part once. No atomics and a fixed
//   order of summation: two calls give equal bits.
//
// Measured and dropped (PERF.md section 6): one thread block cluster
// of 8 blocks an offset adding its blocks' sums through distributed shared
// memory in one launch (no parts in device memory), its teams walking the
// offset's chunks in turn: every offset got the same 64 warps, and the
// centre offset of a submanifold conv, which every valid site hits (4.8x
// the mean offset's hit pairs at 16 channels), held the launch alone;
// blocks of an offset adding parts into device memory with the last block
// to arrive summing them (one launch): its fence and count cost more a
// block than the second pass does.
//
// native.py hashes every csrc/*.cuh into each library's name.
#pragma once

#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

#include "bf16_mma.cuh"

namespace {
namespace dwb {

enum DwMode { kDwConv = 0, kDwNoGather = 1, kDwNoProduct = 2, kDwCompact = 3 };

constexpr int kMaxChunk = 2048;               // output sites a block, at most (its list in smem)
constexpr int kLoads = 8;                     // nbr loads in flight a thread while compacting
constexpr int kStageHits = 32;                // hit pairs a stage
constexpr int kSteps = kStageHits / 16;       // 16-site mma steps a stage
constexpr int kRun = 8;                       // steps carried on the tensor cores
constexpr int kRunStages = kRun / kSteps;     // stages a run
constexpr int kMaxStages = 6;
constexpr size_t kMaxSmem = 232448;           // the most one block may take
constexpr int kPlanInfo = 10;
constexpr int kSumThreads = 256;              // pass 2's block
static_assert(kRun % kSteps == 0 && kStageHits == 32, "dw_bf16 layout: lane r copies row r");

// a row stride >= width (bf16) that is an odd multiple of 8: the 8 rows an
// ldmatrix phase reads fall in 8 different 16-byte bank groups
constexpr int stride_of(int width) { return width % 16 == 8 ? width : stride_of(width + 8); }

template <int MP, int NQ>
struct Layout {
  static constexpr int kH = MP >= 32 && NQ <= 32 ? 2 : 1;  // 16-row slabs of D a warp
  static constexpr int kTeam = MP / (16 * kH);             // warps a team
  static constexpr int kSP = stride_of(MP), kSQ = stride_of(NQ);
  static constexpr int kStageP = kStageHits * kSP;  // elements
  static constexpr int kStage = kStageP + kStageHits * kSQ;
  static constexpr size_t kStageBytes = static_cast<size_t>(kStage) * 2;
  // warps a block: two teams', 4 to 8 (K7's dw_bf16 family: 4-warp blocks
  // beat 8-warp ones at 16 and 32 channels, two 4-warp teams a block beat
  // one at 64; PERF.md section 6)
  static constexpr int kWarps = 2 * kTeam < 4 ? 4 : 2 * kTeam > 8 ? 8 : 2 * kTeam;
  static constexpr int kTeams = kWarps / kTeam;
  static constexpr int kThreads = 32 * kWarps;
  static_assert(kH * 16 * kTeam == MP && kTeams * kTeam == kWarps, "dw_bf16 team split");
  static_assert(kStageBytes % 16 == 0, "stage alignment");
};

// Shared memory of one block, in bytes from a 16-byte aligned base: the
// teams' full and empty barriers [teams][2][stages] and shift masks
// [teams][stages][2], the block's list of hit pairs (feats row,
// output site) [2][kMaxChunk] and compaction counts [2][kLoads x warps],
// the teams' rings [teams][stages][kStage]; after the loop the teams' sums
// [teams][MP x NQ] fp32 take the place of the rings.
struct Smem {
  size_t masks, list, ring, total;
};

template <int MP, int NQ>
__host__ __device__ Smem smem_of(int stages) {
  using L = Layout<MP, NQ>;
  Smem s;
  s.masks = static_cast<size_t>(L::kTeams) * 2 * stages * sizeof(uint64_t);
  s.list = (s.masks + static_cast<size_t>(L::kTeams) * stages * 2 * sizeof(uint32_t) + 15) / 16 * 16;
  s.ring = s.list + (2 * kMaxChunk + 2 * kLoads * L::kWarps) * sizeof(int);
  const size_t loop = s.ring + static_cast<size_t>(L::kTeams) * stages * L::kStageBytes;
  const size_t sums = s.ring + static_cast<size_t>(L::kTeams) * MP * NQ * sizeof(float);
  s.total = loop > sums ? loop : sums;
  return s;
}

// Pass 2: dw[i] = sum over chunks c, in order, of partial[c][i]; i < n = K
// x cin x cout (the fp32 form's pass 2 too: sparse_conv_dw.cu)
__global__ void __launch_bounds__(kSumThreads)
sum_parts_kernel(const float* __restrict__ partial, float* __restrict__ dw, int num_chunks,
                 int n) {
  const int i = blockIdx.x * kSumThreads + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int c = 0; c < num_chunks; ++c) s += partial[static_cast<size_t>(c) * n + i];
  dw[i] = s;
}

struct Params {
  const uint16_t* feats;
  const int* nbr;
  const uint16_t* dout;
  float* dw;
  float* partial;  // [chunks][K][cin x cout] fp32 scratch: each block's part of dW[k]
  int cap_in, cap_out, num_offsets, cin, cout, chunk;
  int stages, ahead;      // ring stages; stages in flight ahead of the one multiplied
  int p_is_dout;          // P = dout (cout >= cin), else P = feats
  int p_rows, q_rows;     // how P's and Q's rows are copied: a RowCopy
};

// This thread's share of the rows of one operand of a stage: row r from
// base + list[first + r] * width, zeros past the m-th.
// Words: lane r copies row r (a team of one warp), and the warp's vote of
// the rows that start mid-word comes back in `mid`. Returns whether it
// stored with plain stores (2-byte loads).
template <int WIDTH, int STRIDE, int TEAM, bool FAST>
__device__ __forceinline__ bool copy_rows(uint16_t* dst, const uint16_t* base, int width, int how,
                                          const int* list, int first, int m, int tt,
                                          uint32_t& mid) {
  if (FAST || how == kRows16) {
    constexpr int kChunks = WIDTH / 8;
#pragma unroll
    for (int e = tt; e < kStageHits * kChunks; e += 32 * TEAM) {
      const int r = e / kChunks, col = (e % kChunks) * 8;
      if (col < width) {
        const bool hit = r < m;
        const int row = hit ? list[first + r] : 0;
        cp_async16_bf16(dst + r * STRIDE + col, base + static_cast<size_t>(row) * width + col,
                        hit);
      }
    }
    return false;
  }
  if (TEAM == 1 && how == kRowsWords) {  // lane r, row r
    const int row = tt < m ? list[first + tt] : -1;
    cp_async_row_words(dst + tt * STRIDE, base, row, width);
    mid = __ballot_sync(0xffffffffu, row >= 0 && (row * width & 1));
    return false;
  }
  for (int e = tt; e < kStageHits * width; e += 32 * TEAM) {
    const int r = e / width, col = e % width;
    dst[r * STRIDE + col] =
        r < m ? base[static_cast<size_t>(list[first + r]) * width + col]
              : uint16_t{0};
  }
  return true;
}

// acc[h][nt] += P[:, slab h of warp tw]^T Q[:, tile nt] over a stage's
// kStageHits sites, one bf16 mma a 16-site step and tile, the sums carried
// on the tensor cores. Both operands are site-major in the stage, so their
// fragments come transposed: A (16 x 16, row m, column s) from the 4 8x8
// blocks (s 0-7 | 8-15) x (m 0-7 | 8-15) of P, B from (s 0-7 | 8-15) of Q
// at two 8-column tiles (one at NQ = 8); lane l addresses row l % 8 of
// block l / 8.
template <int MP, int NQ>
__device__ __forceinline__ void mma_stage(const uint16_t* stage,
                                          float (&acc)[Layout<MP, NQ>::kH][NQ / 8][4], int tw,
                                          int lane) {
  using L = Layout<MP, NQ>;
  constexpr int H = L::kH, NT = NQ / 8;
  const uint32_t pa = smem_addr(stage + ((lane >> 4) * 8 + (lane & 7)) * L::kSP + tw * H * 16 +
                                ((lane >> 3) & 1) * 8);
  const uint32_t qb = smem_addr(stage + L::kStageP +
                                (((lane >> 3) & 1) * 8 + (lane & 7)) * L::kSQ + (lane >> 4) * 8);
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    uint32_t af[H][4];
#pragma unroll
    for (int h = 0; h < H; ++h) ldmatrix_x4_trans(af[h], pa + (u * 16 * L::kSP + h * 16) * 2);
    if constexpr (NT == 1) {
      uint32_t bf[2];
      ldmatrix_x2_trans(bf, qb + u * 16 * L::kSQ * 2);
#pragma unroll
      for (int h = 0; h < H; ++h) mma_bf16(acc[h][0], af[h], bf[0], bf[1]);
    } else {
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, qb + (u * 16 * L::kSQ + nt * 8) * 2);
#pragma unroll
        for (int h = 0; h < H; ++h) {
          mma_bf16(acc[h][nt], af[h], bf[0], bf[1]);
          mma_bf16(acc[h][nt + 1], af[h], bf[2], bf[3]);
        }
      }
    }
  }
}

// One block per (chunk of p.chunk output sites, offset k). FAST: every row
// of both operands by 16-byte copies (the other routes not compiled: a
// smaller loop); else the route of each is chosen at run time.
template <int MODE, int MP, int NQ, bool FAST>
__global__ void __launch_bounds__(Layout<MP, NQ>::kThreads,
                                  Layout<MP, NQ>::kH * NQ <= 64 ? 2 : 1)
    dw_bf16_kernel(const Params p) {
  using L = Layout<MP, NQ>;
  constexpr int H = L::kH, T = L::kTeam, G = L::kTeams, W = L::kWarps, NT = NQ / 8;
  constexpr int kThreads = L::kThreads;
  constexpr bool kProduct = MODE == kDwConv || MODE == kDwNoGather;
  extern __shared__ uint4 dwb_smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(dwb_smem);
  const int S = p.stages;
  const Smem lay = smem_of<MP, NQ>(S);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int team = warp / T, tw = warp % T, tt = tw * 32 + lane;  // tt: thread of the team
  const int c = blockIdx.x, k = blockIdx.y;
  uint64_t* full = reinterpret_cast<uint64_t*>(base) + team * 2 * S;  // [S]
  uint64_t* empty = full + S;                                          // [S]
  uint32_t* masks = reinterpret_cast<uint32_t*>(base + lay.masks) + team * 2 * S;  // [S][2]
  int* src_s = reinterpret_cast<int*>(base + lay.list);  // [kMaxChunk] hit pairs: feats row
  int* out_s = src_s + kMaxChunk;                         // [kMaxChunk] and output site
  int* counts = out_s + kMaxChunk;                        // [2][kLoads * W]
  uint16_t* ring = reinterpret_cast<uint16_t*>(base + lay.ring) + team * S * L::kStage;
  if (tt < S) {
    mbar_init(full + tt, 32 * T);
    mbar_init(empty + tt, T);
  }

  // 1. the chunk's hit pairs in site order: site e0 + j * kThreads + tid is
  //    thread tid's j-th load of a round
  const int begin = c * p.chunk, end = min(begin + p.chunk, p.cap_out);
  const int* nbr_k = p.nbr + static_cast<size_t>(k) * p.cap_out;
  int n_hits = 0;
  for (int round = 0, e0 = begin; e0 < end; ++round, e0 += kLoads * kThreads) {
    int src[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int o = e0 + j * kThreads + tid;
      src[j] = o < end ? __ldg(nbr_k + o) : -1;
    }
    int* cnt = counts + (round & 1) * kLoads * W;
    uint32_t hits[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      if (src[j] >= p.cap_in) src[j] = -1;
      if (MODE == kDwNoGather && src[j] >= 0) {
        const int o = e0 + j * kThreads + tid;
        src[j] = o < p.cap_in ? o : -1;
      }
      hits[j] = __ballot_sync(0xffffffffu, src[j] >= 0);
      if (lane == 0) cnt[j * W + warp] = __popc(hits[j]);
    }
    __syncthreads();
    int run = n_hits, off[kLoads];
#pragma unroll
    for (int q = 0; q < kLoads * W; ++q) {
      if (q % W == warp) off[q / W] = run;
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
    n_hits = run;  // the counts of this round are reused two rounds on, after the next barrier
  }
  __syncthreads();  // the list, and the barriers

  const uint16_t* p_base = p.p_is_dout ? p.dout : p.feats;
  const uint16_t* q_base = p.p_is_dout ? p.feats : p.dout;
  const int wp = p.p_is_dout ? p.cout : p.cin, wq = p.p_is_dout ? p.cin : p.cout;
  const int* p_list = p.p_is_dout ? out_s : src_s;
  const int* q_list = p.p_is_dout ? src_s : out_s;
  const bool words = !FAST && (p.p_rows == kRowsWords || p.q_rows == kRowsWords);
  const bool released = !FAST && (words || p.p_rows == kRowsSync || p.q_rows == kRowsSync);

  // 2. the teams' rings: stage j of the block (hit pairs [32 j, 32 j + 32))
  //    goes to team j mod G; this team's q-th is stage team + q G, in slot s
  //    with phase parity ph
  auto issue = [&](int q, int s, uint32_t ph) {
    const int first = (team + q * G) * kStageHits, m = min(kStageHits, n_hits - first);
    if (q >= S) mbar_wait(empty + s, ph ^ 1);  // every warp is done with this team's q - S
    uint16_t* st = ring + s * L::kStage;
    uint32_t mid_p = 0, mid_q = 0;
    copy_rows<MP, L::kSP, T, FAST>(st, p_base, wp, p.p_rows, p_list, first, m, tt, mid_p);
    copy_rows<NQ, L::kSQ, T, FAST>(st + L::kStageP, q_base, wq, p.q_rows, q_list, first, m, tt,
                                   mid_q);
    if (words && lane == 0) {
      masks[2 * s] = mid_p;
      masks[2 * s + 1] = mid_q;
    }
    if (released) {  // the copies, then this thread's stores, released
      mbar_arrive_copies(full + s, false);
      mbar_arrive(full + s);
    } else {
      mbar_arrive_copies(full + s, true);
    }
  };

  float acc[H][NT][4], sum[H][NT][4];
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[h][nt][j] = sum[h][nt][j] = 0.f;
  auto fold = [&]() {  // the run into the FP32 sum
#pragma unroll
    for (int h = 0; h < H; ++h)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sum[h][nt][j] += acc[h][nt][j];
          acc[h][nt][j] = 0.f;
        }
  };

  auto consume = [&](int q, int s, uint32_t ph) {
    mbar_wait(full + s, ph);
    uint16_t* st = ring + s * L::kStage;
    if (words) {  // rows that start mid-word: one column on (a team of one warp)
      if (masks[2 * s] >> lane & 1) shift_row_words(st + lane * L::kSP);
      if (masks[2 * s + 1] >> lane & 1) shift_row_words(st + L::kStageP + lane * L::kSQ);
      __syncwarp();
    }
    if constexpr (kProduct) mma_stage<MP, NQ>(st, acc, tw, lane);
    __syncwarp();  // this warp is done with the stage
    if (lane == 0) mbar_arrive(empty + s);
    if (kProduct && (q + 1) % kRunStages == 0) fold();
  };

  const int n_stages = (n_hits + kStageHits - 1) / kStageHits;
  const int mine = MODE == kDwCompact || team >= n_stages ? 0 : (n_stages - 1 - team) / G + 1;
  int qi = 0, qd = 0, is = 0, ds = 0;
  uint32_t iph = 0, dph = 0;
  while (qd < mine) {  // issue `ahead` stages ahead of the one multiplied
    for (; qi < mine && qi - qd <= p.ahead; ++qi) {
      issue(qi, is, iph);
      if (++is == S) {
        is = 0;
        iph ^= 1;
      }
    }
    consume(qd++, ds, dph);
    if (++ds == S) {
      ds = 0;
      dph ^= 1;
    }
  }
  if constexpr (kProduct) fold();

  // 3. the teams' sums in team order (thread (g, t) holds rows g, g + 8 of
  //    each of its slabs and columns 2t, 2t + 1 of every 8-column tile),
  //    then this block's part of dW[k]; a chunk with no hit stores zeros
  const int n = p.cin * p.cout;
  float* own = p.partial + (static_cast<size_t>(c) * p.num_offsets + k) * n;
  if (n_hits == 0) {  // the same for the whole block
    for (int e = tid; e < n; e += kThreads) own[e] = 0.f;
    return;
  }
  __syncthreads();  // every team is done with its ring
  float* red = reinterpret_cast<float*>(base + lay.ring);  // [G][MP][NQ]
  {
    const int g = lane >> 2, t = lane & 3;
    const float count = team == 0 ? static_cast<float>(n_hits) : 0.f;
#pragma unroll
    for (int h = 0; h < H; ++h)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int m = (tw * H + h) * 16 + g + 8 * (j >> 1), n2 = nt * 8 + 2 * t + (j & 1);
          red[(team * MP + m) * NQ + n2] = kProduct ? sum[h][nt][j] : count;
        }
  }
  __syncthreads();
  for (int e = tid; e < n; e += kThreads) {
    const int ci = e / p.cout, co = e % p.cout;
    const int idx = p.p_is_dout ? co * NQ + ci : ci * NQ + co;
    float s = red[idx];
#pragma unroll
    for (int t2 = 1; t2 < G; ++t2) s += red[t2 * MP * NQ + idx];
    own[e] = s;
  }
}

// The ring's depth of a kernel on the current device: the most resident blocks
// an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), then the most
// stages that keep them; worked out once a device, for devices 0-15 (a
// higher index is refused with cudaErrorInvalidDevice; the cache behind a
// mutex: autograd's device thread launches the backward pass while another
// thread may launch), with the kernel's dynamic shared memory raised to the
// most a block may take.
template <int MODE, int MP, int NQ, bool FAST>
cudaError_t ring_of(int* stages, int* blocks) {
  auto* fn = dw_bf16_kernel<MODE, MP, NQ, FAST>;  // the cache below is this kernel's own
  constexpr int kDevices = 16;
  static std::mutex mu;
  static int plan[kDevices][2] = {{0}};  // stages, blocks
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kDevices) return cudaErrorInvalidDevice;  // no plan kept for it
  const std::lock_guard<std::mutex> lock(mu);
  if (!plan[dev][0]) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kMaxSmem));
    if (err != cudaSuccess) return err;
    for (int s = 2; s <= kMaxStages; ++s) {
      const size_t smem = smem_of<MP, NQ>(s).total;
      if (smem > kMaxSmem) break;
      int b = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, fn, Layout<MP, NQ>::kThreads, smem);
      if (err != cudaSuccess) return err;
      if (b > 0 && b >= plan[dev][1]) {
        plan[dev][0] = s;
        plan[dev][1] = b;
      }
    }
    if (!plan[dev][0]) return cudaErrorInvalidValue;
  }
  *stages = plan[dev][0];
  *blocks = plan[dev][1];
  return cudaSuccess;
}

// Both passes of MODE at these paddings in one copy form, or (info
// non-null) what pass 1 would run (see run).
template <int MODE, int MP, int NQ, bool FAST>
cudaError_t launch(Params p, cudaStream_t stream, int* info) {
  using L = Layout<MP, NQ>;
  auto* fn = dw_bf16_kernel<MODE, MP, NQ, FAST>;
  int blocks = 0;
  cudaError_t err = ring_of<MODE, MP, NQ, FAST>(&p.stages, &blocks);
  if (err != cudaSuccess) return err;
  p.ahead = L::kTeam == 1 ? p.stages - 1 : p.stages - 2;  // a stage of slack between warps
  const size_t smem = smem_of<MP, NQ>(p.stages).total;
  const dim3 grid((p.cap_out + p.chunk - 1) / p.chunk, p.num_offsets);
  if (info) {
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, fn);
    if (err != cudaSuccess) return err;
    const int values[kPlanInfo] = {blocks, fa.numRegs, static_cast<int>(fa.localSizeBytes),
                                   static_cast<int>(smem), p.stages, p.ahead, L::kThreads,
                                   static_cast<int>(grid.x * grid.y), L::kTeam, L::kTeams};
    for (int i = 0; i < kPlanInfo; ++i) info[i] = values[i];
    return cudaSuccess;
  }
  fn<<<grid, L::kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = static_cast<long long>(p.num_offsets) * p.cin * p.cout;
  sum_parts_kernel<<<static_cast<unsigned>((n + kSumThreads - 1) / kSumThreads), kSumThreads, 0,
                     stream>>>(p.partial, p.dw, grid.x, static_cast<int>(n));
  return cudaGetLastError();
}

inline int row_copy_of(int width, const void* ptr, int team) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(ptr);
  if (width % 8 == 0 && a % 16 == 0) return kRows16;
  if (team == 1 && width % 2 == 1 && width <= 5 && a % 4 == 0) return kRowsWords;
  return kRowsSync;
}

// the copy routes of P and Q at these paddings, then the FAST form where
// both are 16-byte copies, compiled at the square paddings only: there (the
// submanifold convs) it is 3-8% faster than the general form, at 16 -> 32
// and 32 -> 64 no faster (PERF.md, K3 bf16)
template <int MODE, int MP, int NQ>
cudaError_t launch_rows(Params p, cudaStream_t stream, int* info) {
  constexpr int T = Layout<MP, NQ>::kTeam;
  p.p_rows = row_copy_of(p.p_is_dout ? p.cout : p.cin, p.p_is_dout ? p.dout : p.feats, T);
  p.q_rows = row_copy_of(p.p_is_dout ? p.cin : p.cout, p.p_is_dout ? p.feats : p.dout, T);
  if constexpr (MP == NQ) {
    if (p.p_rows == kRows16 && p.q_rows == kRows16)
      return launch<MODE, MP, NQ, true>(p, stream, info);
  }
  return launch<MODE, MP, NQ, false>(p, stream, info);
}

template <int MODE, int MP>
cudaError_t launch_nq(const Params& p, int nq, cudaStream_t s, int* info) {
  if (nq <= 8) return launch_rows<MODE, MP, 8>(p, s, info);
  if constexpr (MP >= 16) {
    if (nq <= 16) return launch_rows<MODE, MP, 16>(p, s, info);
  }
  if constexpr (MP >= 32) {
    if (nq <= 32) return launch_rows<MODE, MP, 32>(p, s, info);
  }
  if constexpr (MP >= 64) {
    if (nq <= 64) return launch_rows<MODE, MP, 64>(p, s, info);
  }
  if constexpr (MP >= 128) return launch_rows<MODE, MP, 128>(p, s, info);
  return cudaErrorInvalidValue;
}

// One launch of MODE (info null), or what it would run: info[kPlanInfo] =
// resident blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// registers and spilled bytes a thread, dynamic shared memory a block,
// stages, stages ahead, threads a block, blocks in the grid, warps a team,
// teams a block. partial: [ceil(cap_out / chunk)][K][cin x cout] floats.
// SQUARE (K7's family): the submanifold
// paddings only, Cin == Cout in 16, 32, 64, the FAST form.
template <int MODE, bool SQUARE = false>
int run(const void* feats, const int* nbr, const void* dout, float* dw, float* partial,
        int cap_in, int cap_out, int num_offsets, int cin, int cout, int chunk, void* stream,
        int* info) {
  if (cin < 1 || cin > 128 || cout < 1 || cout > 128 || num_offsets < 1 ||
      num_offsets > 65535 || cap_in < 0 || cap_out < 1 || chunk < 1 || chunk > kMaxChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{static_cast<const uint16_t*>(feats), nbr, static_cast<const uint16_t*>(dout), dw,
           partial, cap_in, cap_out, num_offsets, cin, cout, chunk, 0, 0, cout >= cin, kRows16,
           kRows16};
  const int mp = p.p_is_dout ? cout : cin, nq = p.p_is_dout ? cin : cout;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if constexpr (SQUARE) {
    if (cin != cout || (cin != 16 && cin != 32 && cin != 64) ||
        row_copy_of(cin, feats, 1) != kRows16 || row_copy_of(cout, dout, 1) != kRows16)
      return static_cast<int>(cudaErrorInvalidValue);
    err = cin == 16 ? launch<MODE, 16, 16, true>(p, s, info)
          : cin == 32 ? launch<MODE, 32, 32, true>(p, s, info)
                      : launch<MODE, 64, 64, true>(p, s, info);
  } else if (mp <= 16) {
    err = launch_nq<MODE, 16>(p, nq, s, info);
  } else if (mp <= 32) {
    err = launch_nq<MODE, 32>(p, nq, s, info);
  } else if (mp <= 64) {
    err = launch_nq<MODE, 64>(p, nq, s, info);
  } else {
    err = launch_nq<MODE, 128>(p, nq, s, info);
  }
  return static_cast<int>(err);
}

}  // namespace dwb
}  // namespace
