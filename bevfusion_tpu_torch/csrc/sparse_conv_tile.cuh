// The loop of the sparse-conv gather-GEMM kernel (K1/K2; the design note is
// in sparse_conv.cu): its shared-memory layout, the tile's prologue, its
// 3xTF32 tile product and the kernel, with a compile-time mode (the bf16
// form's loop, sparse_conv_bf16_tile.cuh, takes the same modes).
// sparse_conv.cu instantiates the production mode (kTileConv) only;
// sparse_conv_variants.cu instantiates the others, K7's tensor-core
// family, each of which runs the same prologue,
// cp.async ring, 64-site blocks of 4 warps and mma.sync tiles with one part
// changed, and no epilogue:
//
//   kTileBare       tc            out = sum_k x[nbr[k]] @ W[k]: the loop alone
//   kTileNoSkip     tc_noskip     every offset staged and multiplied by every
//                                 warp, whether or not a row of it hits
//   kTileNoGather   tc_nogather   the tile's own rows through the ring in
//                                 place of the gathered ones (zero where nbr
//                                 misses): coalesced
//   kTileNoProduct  tc_noproduct  the ring without W[k] and without mma;
//                                 out [cap_out, cin] = sum_k x[nbr[k]] on the
//                                 FP32 units
//   kTileOneTf32    tc_1xtf32     one TF32 mma a step (big * big') in place
//                                 of the three of the 3xTF32 split
//
// native.py hashes every csrc/*.cuh into each library's name, so an edit
// here rebuilds both libraries.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "tf32_mma.cuh"

namespace {

enum TileMode {
  kTileConv = 0,
  kTileBare = 1,
  kTileNoSkip = 2,
  kTileNoGather = 3,
  kTileNoProduct = 4,
  kTileOneTf32 = 5,
};

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

bool aligned(const void* ptr, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

// x rounded to TF32 (round to nearest, ties away from zero)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// acc[nt] + small[nt] += rows[16 of this warp] @ W[k][:, 8 nt : 8 nt + 8],
// 3xTF32: big*big' of each 8-deep step comes from a zero accumulator and is
// added into acc on the FP32 units (round to nearest); the two small terms
// accumulate in small on the tensor cores. kTileOneTf32: big*big' alone.
template <int MODE, int CIN_PAD, int COUT_PAD>
__device__ __forceinline__ void mma_stage(const float* stage, float (&acc)[COUT_PAD / 8][4],
                                          float (&small)[COUT_PAD / 8][4], int warp, int lane) {
  using L = Layout<CIN_PAD, COUT_PAD>;
  const int g = lane >> 2, t = lane & 3;
  const float* a = stage + (warp * 16 + g) * L::kRowStride + t;
  const float* b = stage + L::kStageA + t * L::kWStride + g;
#pragma unroll
  for (int kk = 0; kk < CIN_PAD; kk += 8) {
    uint32_t a_big[4], a_small[4];
    if constexpr (MODE == kTileOneTf32) {
      a_big[0] = to_tf32(a[kk]);
      a_big[1] = to_tf32(a[8 * L::kRowStride + kk]);
      a_big[2] = to_tf32(a[kk + 4]);
      a_big[3] = to_tf32(a[8 * L::kRowStride + kk + 4]);
    } else {
      split_tf32(a[kk], a_big[0], a_small[0]);
      split_tf32(a[8 * L::kRowStride + kk], a_big[1], a_small[1]);
      split_tf32(a[kk + 4], a_big[2], a_small[2]);
      split_tf32(a[8 * L::kRowStride + kk + 4], a_big[3], a_small[3]);
    }
#pragma unroll
    for (int nt = 0; nt < COUT_PAD / 8; ++nt) {
      uint32_t b_big0, b_small0, b_big1, b_small1;
      if constexpr (MODE == kTileOneTf32) {
        b_big0 = to_tf32(b[kk * L::kWStride + nt * 8]);
        b_big1 = to_tf32(b[(kk + 4) * L::kWStride + nt * 8]);
      } else {
        split_tf32(b[kk * L::kWStride + nt * 8], b_big0, b_small0);
        split_tf32(b[(kk + 4) * L::kWStride + nt * 8], b_big1, b_small1);
        mma_tf32(small[nt], a_small, b_big0, b_big1);
        mma_tf32(small[nt], a_big, b_small0, b_small1);
      }
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      mma_tf32(d, a_big, b_big0, b_big1);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[nt][j] += d[j];
    }
  }
}

// The prologue of a 64-site tile, which every mode shares: the tile's
// neighbor rows into nbr_s [K][kTile] (-1 for a miss or a row >= cap_in;
// kTileNoGather: a hit reads the site's own row), one hit bit per (offset,
// site) into mask_s [K][kTile / 32], a
// barrier, then this warp's list `act` of the offsets any site of the tile
// hits, in order (every offset for kTileNoSkip); returns its length. A warp
// covers 32 sites of one offset; kLoads loads in flight a thread.
template <int MODE, int kThreads>
__device__ __forceinline__ int tile_prologue(const int* nbr, int cap_in, int cap_out, int K,
                                             int row0, int* nbr_s, uint32_t* mask_s, int* act,
                                             int tid, int lane) {
  constexpr int kWords = kTile / 32, kLoads = 4;
  for (int e0 = tid; e0 < K * kTile; e0 += kLoads * kThreads) {
    int src[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int e = e0 + j * kThreads, row = row0 + e % kTile;
      src[j] = e < K * kTile && row < cap_out
                   ? __ldg(nbr + static_cast<size_t>(e / kTile) * cap_out + row)
                   : -1;
    }
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int e = e0 + j * kThreads;
      if (e >= K * kTile) break;  // the same for the whole warp
      int v = src[j] < 0 || src[j] >= cap_in ? -1 : src[j];
      if constexpr (MODE == kTileNoGather) {  // a hit reads the site's own row
        const int row = row0 + e % kTile;
        if (v >= 0) v = row < cap_in ? row : -1;
      }
      nbr_s[e] = v;
      const uint32_t hits = __ballot_sync(0xffffffffu, v >= 0);
      if (lane == 0) mask_s[e / 32] = hits;
    }
  }
  __syncthreads();

  int n_act = 0;
  if constexpr (MODE == kTileNoSkip) {  // every offset
    for (int k = lane; k < K; k += 32) act[k] = k;
    n_act = K;
  } else {
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
  }
  __syncwarp();
  return n_act;
}

template <int MODE, int CIN_PAD, int COUT_PAD>
__global__ void __launch_bounds__(Layout<CIN_PAD, COUT_PAD>::kThreads)
    sparse_conv_tc_kernel(const Params p) {
  using L = Layout<CIN_PAD, COUT_PAD>;
  constexpr int NT = COUT_PAD / 8, kThreads = L::kThreads, kWords = L::kWords;
  // kTileNoProduct: lane's element j of its warp's [16, CIN_PAD] sum is
  // e = lane + 32 j, row e / CIN_PAD, column e % CIN_PAD
  constexpr int kSums = MODE == kTileNoProduct ? 16 * CIN_PAD / 32 : 1;
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
  // the offsets any site of the tile hits, in order
  const int n_act = tile_prologue<MODE, kThreads>(p.nbr, p.cap_in, p.cap_out, K, row0, nbr_s,
                                                  mask_s, act, tid, lane);

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
    if constexpr (MODE == kTileNoProduct) return;  // no product: W[k] is not read
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
  float sums[kSums];  // kTileNoProduct's sums of gathered rows
#pragma unroll
  for (int j = 0; j < kSums; ++j) sums[j] = 0.f;

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
    if constexpr (MODE != kTileNoSkip) {
      const uint32_t mine = (mask_s[act[i] * kWords + word] >> shift) & 0xffffu;
      if (!mine) continue;
    }
    if constexpr (MODE == kTileNoProduct) {
      const float* rows = ring + (i % S) * L::kStage + warp * 16 * L::kRowStride;
#pragma unroll
      for (int j = 0; j < kSums; ++j) {
        const int e = lane + 32 * j;
        sums[j] += rows[(e / CIN_PAD) * L::kRowStride + e % CIN_PAD];
      }
    } else if (COUT_PAD <= 64) {  // the offset's own fp32 sum first, then the running one
      float part[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[nt][j] = 0.f;
      mma_stage<MODE, CIN_PAD, COUT_PAD>(ring + (i % S) * L::kStage, part, small, warp, lane);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[nt][j] += part[nt][j];
    } else {  // registers: at 128 columns a third set of sums would spill
      mma_stage<MODE, CIN_PAD, COUT_PAD>(ring + (i % S) * L::kStage, acc, small, warp, lane);
    }
  }

  if constexpr (MODE == kTileNoProduct) {  // out [cap_out, cin]
#pragma unroll
    for (int j = 0; j < kSums; ++j) {
      const int e = lane + 32 * j;
      const int r = row0 + warp * 16 + e / CIN_PAD, c = e % CIN_PAD;
      if (r < p.cap_out && c < p.cin) p.out[static_cast<size_t>(r) * p.cin + c] = sums[j];
    }
    return;
  }
  // epilogue from the fragments: thread (g, t) holds rows g, g + 8 of its
  // slab and columns 2t, 2t + 1 of every 8-column tile
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = nt * 8 + 2 * t;
    if (col >= p.cout) continue;
    const bool two = col + 1 < p.cout;
    if constexpr (MODE != kTileConv) {  // K7's modes: the sum, no epilogue
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + warp * 16 + g + 8 * h;
        if (r >= p.cap_out) continue;
        const size_t o = static_cast<size_t>(r) * p.cout + col;
        p.out[o] = acc[nt][2 * h] + small[nt][2 * h];
        if (two) p.out[o + 1] = acc[nt][2 * h + 1] + small[nt][2 * h + 1];
      }
      continue;
    }
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

template <int MODE, int CIN_PAD, int COUT_PAD>
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
    const cudaError_t err = cudaFuncSetAttribute(sparse_conv_tc_kernel<MODE, CIN_PAD, COUT_PAD>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (p.cap_out + kTile - 1) / kTile;
  sparse_conv_tc_kernel<MODE, CIN_PAD, COUT_PAD><<<blocks, L::kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
