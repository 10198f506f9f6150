// The loop of the sparse-conv kernel's bf16 form (K1/K2 bf16; the design
// note is in sparse_conv.cu), with a compile-time mode as
// sparse_conv_tile.cuh has for the fp32 form. sparse_conv.cu instantiates
// the production mode (kTileConv); sparse_conv_variants.cu instantiates the
// modes of K7's bf16 family, each of which changes one part of the loop:
//
//   kTileBare       bf16            out = bf16(sum_k x[nbr[k]] @ W[k]): the
//                                   loop alone, no epilogue
//   kTileNoSkip     bf16_noskip     every offset staged and multiplied by
//                                   every warp, whether or not a row hits
//   kTileNoGather   bf16_nogather   the slab's own rows in place of the
//                                   gathered ones (zero where nbr misses)
//   kTileNoProduct  bf16_noproduct  no W and no mma: out [cap_out, cin] =
//                                   bf16(sum_k x[nbr[k]]) on the FP32 units
//
// native.py hashes every csrc/*.cuh into each library's name.
#pragma once

#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

#include "bf16_mma.cuh"
#include "sparse_conv_tile.cuh"

namespace {

struct ParamsBf16 {
  const uint16_t* feats;
  const int* nbr;
  const uint16_t* weight;
  const float* scale;
  const float* shift;
  const uint16_t* residual;
  uint16_t* out;
  int cap_in, cap_out, num_offsets, cin, cout, relu;
  int stages;    // ring stages
  int ahead;     // offsets staged ahead of the one multiplied
  int rows;      // how feature rows are copied: a RowCopy
  int weights;   // the same for the rows of W[k]
  int pair_out;  // out (and residual) rows in 4-byte pairs
};

constexpr int kWarpsBf16 = 4;
constexpr int kThreadsBf16 = 32 * kWarpsBf16;
constexpr int kMinStagesBf16 = 3;  // one offset ahead and a stage of slack between the warps
constexpr int kMaxStagesBf16 = 8;
constexpr int kPlanInfo = 9;  // the ints a plan query writes (run_bf16)

template <int CIN_PAD, int COUT_PAD>
struct LayoutBf16 {
  // 16-row mma slabs a warp: two at Cin <= 16 and Cout <= 32, where a slab's
  // product is a few mma and the loop's bookkeeping for an offset would
  // dominate it (K7's bf16 family: one slab is faster at 32 -> 32)
  static constexpr int kSlabs = CIN_PAD == 16 && COUT_PAD <= 32 ? 2 : 1;
  static constexpr int kRows = 16 * kSlabs;              // rows a warp
  static constexpr int kTileRows = kWarpsBf16 * kRows;   // output sites a block
  static constexpr int kRowStride = CIN_PAD + 8;  // bf16: conflict-free ldmatrix rows
  static constexpr int kWStride = COUT_PAD + 8;   // bf16: conflict-free ldmatrix.trans rows
  static constexpr int kStageA = kRows * kRowStride;  // one warp's gathered rows of a stage
  static constexpr int kW = CIN_PAD * kWStride;       // one W[k]
  static_assert(CIN_PAD % 16 == 0 && COUT_PAD % 16 == 0 && kSlabs <= 2, "bf16 layout");
};

// Shared memory of one block, in bytes from a 16-byte aligned base: a full
// and an empty mbarrier a stage, the ring of W[k] (not kTileNoProduct's),
// each warp's ring of gathered rows, each warp's neighbor rows [K][kRows],
// the tile's slab bits [warps][K] and each warp's list of offsets.
struct SmemBf16 {
  size_t w, a, nbr, masks, list, total;
};

template <int CIN_PAD, int COUT_PAD, bool W_USED>
__host__ __device__ SmemBf16 smem_bf16(int num_offsets, int stages) {
  using L = LayoutBf16<CIN_PAD, COUT_PAD>;
  SmemBf16 s;
  s.w = (static_cast<size_t>(2) * stages * 8 + 15) / 16 * 16;
  s.a = s.w + (W_USED ? static_cast<size_t>(stages) * L::kW * 2 : 0);
  s.nbr = s.a + static_cast<size_t>(kWarpsBf16) * stages * L::kStageA * 2;
  s.masks = s.nbr + static_cast<size_t>(kWarpsBf16) * num_offsets * L::kRows * 4;
  s.list = s.masks + static_cast<size_t>(kWarpsBf16) * num_offsets * 4;
  s.total = (s.list + static_cast<size_t>(kWarpsBf16) * num_offsets * 4 + 15) / 16 * 16;
  return s;
}

// acc[h][nt] += rows[slab h] @ W[:, 8 nt : 8 nt + 8] for each slab h whose
// bit is set in `slabs`: the A fragments of each 16-deep step by one
// ldmatrix.x4 a slab, the B fragments of two 8-column tiles by one
// ldmatrix.x4.trans of W ([CIN_PAD][COUT_PAD] row-major), shared by the
// slabs, one bf16 mma a tile, the sums carried on the tensor cores
template <int CIN_PAD, int COUT_PAD>
__device__ __forceinline__ void mma_slabs(
    const uint16_t* rows, const uint16_t* w, uint32_t slabs,
    float (&acc)[LayoutBf16<CIN_PAD, COUT_PAD>::kSlabs][COUT_PAD / 8][4], int lane) {
  using L = LayoutBf16<CIN_PAD, COUT_PAD>;
  // lane l addresses row l % 8 of 8x8 matrix l / 8
  const uint32_t a = smem_addr(rows + (lane & 15) * L::kRowStride + (lane >> 4) * 8);
  const uint32_t b =
      smem_addr(w + ((lane & 7) + ((lane >> 3) & 1) * 8) * L::kWStride + (lane >> 4) * 8);
  auto hit = [&](int h) { return L::kSlabs == 1 || (slabs >> h & 1); };  // one slab: it hits
#pragma unroll
  for (int kk = 0; kk < CIN_PAD; kk += 16) {
    uint32_t af[L::kSlabs][4];
#pragma unroll
    for (int h = 0; h < L::kSlabs; ++h)
      if (hit(h)) ldmatrix_x4(af[h], a + (h * 16 * L::kRowStride + kk) * 2);
#pragma unroll
    for (int nt = 0; nt < COUT_PAD / 8; nt += 2) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, b + (kk * L::kWStride + nt * 8) * 2);
#pragma unroll
      for (int h = 0; h < L::kSlabs; ++h) {
        if (!hit(h)) continue;
        mma_bf16(acc[h][nt], af[h], bf[0], bf[1]);
        mma_bf16(acc[h][nt + 1], af[h], bf[2], bf[3]);
      }
    }
  }
}

// One block of 4 warps per tile of kTileRows output sites; warp w owns its
// kRows rows, kSlabs 16-row mma slabs. W[k] passes through a ring of
// `stages` shared by the warps, each thread copying a share of it, with a
// full and an empty mbarrier a stage; each warp gathers its own rows into
// its own ring and stages `ahead` offsets ahead of the one it multiplies.
// FAST: every row of the features and of W[k] by 16-byte cp.async copies
// (Cin and Cout multiples of 8, aligned), the other routes not compiled (a
// smaller loop for the instruction cache); else the route of each is
// chosen at run time.
template <int MODE, int CIN_PAD, int COUT_PAD, bool FAST>
__global__ void __launch_bounds__(kThreadsBf16,
                                  LayoutBf16<CIN_PAD, COUT_PAD>::kSlabs == 2 ? 6
                                  : COUT_PAD <= 32                          ? 8
                                  : COUT_PAD == 64                          ? 4
                                                                            : 2)
    sparse_conv_bf16_kernel(const ParamsBf16 p) {
  using L = LayoutBf16<CIN_PAD, COUT_PAD>;
  constexpr bool W_USED = MODE != kTileNoProduct;
  constexpr int NT = COUT_PAD / 8, H = L::kSlabs, R = L::kRows;
  // kTileNoProduct: lane's element j of its warp's [R, CIN_PAD] sum is
  // e = lane + 32 j, row e / CIN_PAD, column e % CIN_PAD
  constexpr int kSums = MODE == kTileNoProduct ? R * CIN_PAD / 32 : 1;
  extern __shared__ uint4 smem_bf16_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem_bf16_raw);
  const int K = p.num_offsets, S = p.stages, P = p.ahead;
  const SmemBf16 lay = smem_bf16<CIN_PAD, COUT_PAD, W_USED>(K, S);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint64_t* full = reinterpret_cast<uint64_t*>(base);  // [S]
  uint64_t* empty = full + S;                          // [S]
  uint16_t* w_s = reinterpret_cast<uint16_t*>(base + lay.w);
  uint16_t* a_ring = reinterpret_cast<uint16_t*>(base + lay.a) + warp * S * L::kStageA;
  int* nbr_w = reinterpret_cast<int*>(base + lay.nbr) + warp * K * R;  // [K][R]
  uint32_t* masks = reinterpret_cast<uint32_t*>(base + lay.masks);     // [warps][K]
  uint32_t* mask_w = masks + warp * K;
  int* list = reinterpret_cast<int*>(base + lay.list) + warp * K;
  const int row0 = blockIdx.x * L::kTileRows + warp * R;

  // the padding that no copy writes, zeroed once: channels past cin of
  // every staged row, rows past cin and columns past cout of W
  if (p.cin < CIN_PAD || p.cout < COUT_PAD) {
    for (size_t e = tid; e < (lay.nbr - lay.w) / 16; e += kThreadsBf16)
      smem_bf16_raw[lay.w / 16 + e] = make_uint4(0, 0, 0, 0);
  }
  if (tid < S) {
    mbar_init(full + tid, kThreadsBf16);
    mbar_init(empty + tid, kWarpsBf16);
  }

  // this warp's neighbor rows (-1: a miss or a row >= cap_in; kTileNoGather:
  // a hit reads the site's own row) and an offset's slab bits (slab h: any
  // of rows 16h..16h+15 hits); each half-warp of a load takes 16 rows of
  // one offset, one slab (H <= 2)
  constexpr int kLoads = 28;  // 27 offsets' rows in one batch of loads (H <= 2)
  for (int e0 = 0; e0 < K * R; e0 += 32 * kLoads) {  // e0: the same for the whole warp
    int src[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int e = e0 + 32 * j + lane, row = row0 + e % R;
      src[j] = e < K * R && row < p.cap_out
                   ? __ldg(p.nbr + static_cast<size_t>(e / R) * p.cap_out + row)
                   : -1;
    }
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int e = e0 + 32 * j + lane;
      if (e0 + 32 * j >= K * R) break;  // the same for the whole warp
      int v = src[j] < 0 || src[j] >= p.cap_in ? -1 : src[j];
      if constexpr (MODE == kTileNoGather) {
        const int row = row0 + e % R;
        if (v >= 0) v = row < p.cap_in ? row : -1;
      }
      if (e < K * R) nbr_w[e] = v;
      const uint32_t hits = __ballot_sync(0xffffffffu, v >= 0);
      const uint32_t lo = (hits & 0xffffu) != 0, hi = (hits >> 16) != 0;
      const int k = (e0 + 32 * j) / R;  // H == 1: offsets k, k + 1; H == 2: offset k
      if (lane == 0) {
        if (H == 2) {
          mask_w[k] = lo | hi << 1;
        } else {
          mask_w[k] = lo;
          if (k + 1 < K) mask_w[k + 1] = hi;
        }
      }
    }
  }
  __syncthreads();  // every warp's slab bits of the tile, and the barriers
  // the offsets any row of the tile hits, in order, with this warp's slab
  // bits from bit 16 (kTileNoSkip: every offset and slab)
  int n = 0;
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int k = k0 + lane;
    uint32_t mine = 0, any = 0;
    if (k < K) {
      mine = MODE == kTileNoSkip ? (1u << H) - 1 : mask_w[k];
      any = mine;
#pragma unroll
      for (int w = 0; w < kWarpsBf16; ++w) any |= masks[w * K + k];
    }
    const uint32_t b = __ballot_sync(0xffffffffu, any != 0);
    if (any) list[n + __popc(b & ((1u << lane) - 1u))] = k | static_cast<int>(mine << 16);
    n += __popc(b);
  }
  __syncwarp();

  // staging of list entry j into stage s (phase parity `phase`): this
  // thread's share of W[k], and this warp's rows of the slabs that hit
  auto issue = [&](int j, int s, uint32_t phase) {
    const int entry = list[j], k = entry & 0xffff;
    const uint32_t slabs = static_cast<uint32_t>(entry) >> 16;
    if (j >= S) mbar_wait(empty + s, phase ^ 1);  // every warp is done with entry j - S
    if constexpr (W_USED) {
      const uint16_t* wk = p.weight + static_cast<size_t>(k) * p.cin * p.cout;
      uint16_t* dst = w_s + s * L::kW;
      if (FAST || p.weights == kRows16) {
        constexpr int kChunks = COUT_PAD / 8;
        for (int e = tid; e < p.cin * kChunks; e += kThreadsBf16) {
          const int ci = e / kChunks, c = (e % kChunks) * 8;
          if (c < p.cout) cp_async16_bf16(dst + ci * L::kWStride + c, wk + ci * p.cout + c, true);
        }
      } else {
        for (int e = tid; e < p.cin * p.cout; e += kThreadsBf16)
          dst[(e / p.cout) * L::kWStride + e % p.cout] = wk[e];
      }
    }
    uint16_t* rows = a_ring + s * L::kStageA;
    const int* src_rows = nbr_w + k * R;
    auto hit = [&](int r) { return H == 1 || (slabs >> (r / 16) & 1); };
    if (!slabs) {
    } else if (FAST || p.rows == kRows16) {
      constexpr int kChunks = CIN_PAD / 8;
#pragma unroll
      for (int e = lane; e < R * kChunks; e += 32) {
        const int r = e / kChunks, c = (e % kChunks) * 8;
        if (c < p.cin && hit(r)) {
          const int src = src_rows[r];
          cp_async16_bf16(rows + r * L::kRowStride + c,
                          p.feats + static_cast<size_t>(src < 0 ? 0 : src) * p.cin + c,
                          src >= 0);
        }
      }
    } else if (p.rows == kRowsWords) {  // row r: lane r, the three words that cover it
      for (int r = lane; r < R; r += 32)
        if (hit(r)) cp_async_row_words(rows + r * L::kRowStride, p.feats, src_rows[r], p.cin);
    } else {
      for (int e = lane; e < R * p.cin; e += 32) {
        const int r = e / p.cin, c = e % p.cin, src = src_rows[r];
        if (hit(r))
          rows[r * L::kRowStride + c] =
              src >= 0 ? p.feats[static_cast<size_t>(src) * p.cin + c] : uint16_t{0};
      }
    }
    // the arrival of this thread's copies; after 2-byte stores, a release too
    if (!FAST && ((slabs && p.rows == kRowsSync) || (W_USED && p.weights == kRowsSync))) {
      mbar_arrive_copies(full + s, false);
      mbar_arrive(full + s);
    } else {
      mbar_arrive_copies(full + s, true);
    }
  };

  float acc[H][NT][4];
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[h][nt][j] = 0.f;
  float sums[kSums];  // kTileNoProduct's sums of gathered rows
#pragma unroll
  for (int j = 0; j < kSums; ++j) sums[j] = 0.f;

  // entries 0..P-1 are staged first (j < 0), then entry j + P while entry
  // j multiplies; (fs, fph), (cs, cph): the stage and phase parity of the
  // entry staged and of the entry multiplied
  int fs = 0, cs = 0;
  uint32_t fph = 0, cph = 0;
  for (int j = -P; j < n; ++j) {
    if (j + P < n) {
      issue(j + P, fs, fph);
      if (++fs == S) {
        fs = 0;
        fph ^= 1;
      }
    }
    if (j < 0) continue;
    const int entry = list[j];
    const uint32_t slabs = static_cast<uint32_t>(entry) >> 16;
    if (slabs) {
      mbar_wait(full + cs, cph);
      uint16_t* rows = a_ring + cs * L::kStageA;
      if (!FAST && p.rows == kRowsWords) {  // rows that start mid-word: one column on
        for (int r = lane; r < R; r += 32) {
          const int src = nbr_w[(entry & 0xffff) * R + r];
          if ((H == 1 || (slabs >> (r / 16) & 1)) && src >= 0 && (src * p.cin & 1))
            shift_row_words(rows + r * L::kRowStride);
        }
        __syncwarp();
      }
      if constexpr (MODE == kTileNoProduct) {  // the rows of the slabs that hit
#pragma unroll
        for (int j2 = 0; j2 < kSums; ++j2) {
          const int e = lane + 32 * j2, r = e / CIN_PAD;  // r / 16: the same for the warp
          if (H == 1 || (slabs >> (r / 16) & 1))
            sums[j2] += bf16_to_float(rows[r * L::kRowStride + e % CIN_PAD]);
        }
      } else {
        mma_slabs<CIN_PAD, COUT_PAD>(rows, w_s + cs * L::kW, slabs, acc, lane);
      }
    }
    __syncwarp();  // this warp is done with stage cs
    if (lane == 0) mbar_arrive(empty + cs);
    if (++cs == S) {
      cs = 0;
      cph ^= 1;
    }
  }
  // a warp that multiplied none of the last offsets still has copies in
  // flight, which the other warps wait for
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  if constexpr (MODE == kTileNoProduct) {  // out [cap_out, cin]
#pragma unroll
    for (int j = 0; j < kSums; ++j) {
      const int e = lane + 32 * j;
      const int r = row0 + e / CIN_PAD, c = e % CIN_PAD;
      if (r < p.cap_out && c < p.cin)
        p.out[static_cast<size_t>(r) * p.cin + c] = float_to_bf16(sums[j]);
    }
    return;
  }
  // the fp32 epilogue from the fragments, one rounding to bf16 (the modes
  // other than kTileConv are launched with no scale, shift or residual):
  // thread (g, t) holds rows g, g + 8 of each slab, columns 2t, 2t + 1 of
  // every 8-column tile
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
    for (int h = 0; h < H; ++h)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = row0 + 16 * h + g + 8 * hh;
        if (r >= p.cap_out) continue;
        const size_t o = static_cast<size_t>(r) * p.cout + col;
        float y0 = acc[h][nt][2 * hh] * sc0 + sh0;
        float y1 = acc[h][nt][2 * hh + 1] * sc1 + sh1;
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
          *reinterpret_cast<uint32_t*>(p.out + o) =
              pack_bf16(float_to_bf16(y0), float_to_bf16(y1));
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

// resident blocks an SM of one instantiation at `smem` bytes
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor, cached per device; the
// cache behind a mutex, as autograd's device thread launches the backward
// pass while another thread may launch a forward)
template <int MODE, int CIN_PAD, int COUT_PAD, bool FAST>
cudaError_t blocks_per_sm(size_t smem, int* blocks) {
  auto* fn = sparse_conv_bf16_kernel<MODE, CIN_PAD, COUT_PAD, FAST>;
  constexpr int kDevices = 16, kCache = 16;
  static std::mutex mu;
  static bool raised[kDevices] = {false};
  static size_t keys[kDevices][kCache] = {{0}};
  static int values[kDevices][kCache] = {{0}};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= kDevices) dev = 0;
  const std::lock_guard<std::mutex> lock(mu);
  if (!raised[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(kMaxSmem));
    if (err != cudaSuccess) return err;
    raised[dev] = true;
  }
  const int slot = static_cast<int>(smem / 16 % kCache);
  if (keys[dev][slot] != smem) {
    int b = 0;
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, fn, kThreadsBf16, smem);
    if (err != cudaSuccess) return err;
    keys[dev][slot] = smem;
    values[dev][slot] = b;
  }
  *blocks = values[dev][slot];
  return cudaSuccess;
}

// One launch of MODE at these paddings in one copy form, or (info non-null)
// what it would run (see run_bf16). The ring's depth: the most resident
// blocks an SM, then the most stages that keep them (K7's sweep: resident
// blocks pay more than stages), unless `stages` >= 0 says.
template <int MODE, int CIN_PAD, int COUT_PAD, bool FAST>
cudaError_t launch_bf16(ParamsBf16 p, cudaStream_t stream, int* info, int stages) {
  using L = LayoutBf16<CIN_PAD, COUT_PAD>;
  constexpr bool W_USED = MODE != kTileNoProduct;
  const int K = p.num_offsets;
  int blocks = 0;
  for (int s = kMinStagesBf16; stages < 0 && s <= kMaxStagesBf16; ++s) {
    const size_t smem = smem_bf16<CIN_PAD, COUT_PAD, W_USED>(K, s).total;
    if (smem > kMaxSmem) break;
    int b = 0;
    const cudaError_t err = blocks_per_sm<MODE, CIN_PAD, COUT_PAD, FAST>(smem, &b);
    if (err != cudaSuccess) return err;
    if (b > 0 && b >= blocks) {
      p.stages = s;
      blocks = b;
    }
  }
  if (stages >= 0) p.stages = stages;
  if (p.stages < kMinStagesBf16 || p.stages > kMaxStagesBf16)
    return cudaErrorInvalidValue;  // too many offsets for shared memory
  const size_t smem = smem_bf16<CIN_PAD, COUT_PAD, W_USED>(K, p.stages).total;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = blocks_per_sm<MODE, CIN_PAD, COUT_PAD, FAST>(smem, &blocks);
  if (err != cudaSuccess) return err;
  if (blocks < 1) return cudaErrorInvalidConfiguration;
  p.ahead = p.stages - 2;  // a stage of slack between the warps
  const int grid = (p.cap_out + L::kTileRows - 1) / L::kTileRows;
  if (info) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, sparse_conv_bf16_kernel<MODE, CIN_PAD, COUT_PAD, FAST>);
    if (err != cudaSuccess) return err;
    const int values[kPlanInfo] = {blocks,   attr.numRegs, static_cast<int>(attr.localSizeBytes),
                                   static_cast<int>(smem), p.stages, p.ahead, kThreadsBf16, grid,
                                   L::kSlabs};
    for (int i = 0; i < kPlanInfo; ++i) info[i] = values[i];
    return cudaSuccess;
  }
  sparse_conv_bf16_kernel<MODE, CIN_PAD, COUT_PAD, FAST><<<grid, kThreadsBf16, smem, stream>>>(p);
  return cudaGetLastError();
}

// One launch of MODE at these paddings, or (info non-null) what it would
// run: info[kPlanInfo] = resident blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers a thread,
// local (spilled) bytes a thread, dynamic shared memory a block, stages,
// offsets staged ahead, threads a block, blocks in the grid, 16-row slabs a
// warp. The FAST form where every row goes by 16-byte copies. `stages` >=
// 0 replaces the launch's choice (K7's sweep).
template <int MODE, int CIN_PAD, int COUT_PAD>
cudaError_t run_bf16(const ParamsBf16& p, cudaStream_t stream, int* info, int stages = -1) {
  if (p.rows == kRows16 && (MODE == kTileNoProduct || p.weights == kRows16))
    return launch_bf16<MODE, CIN_PAD, COUT_PAD, true>(p, stream, info, stages);
  return launch_bf16<MODE, CIN_PAD, COUT_PAD, false>(p, stream, info, stages);
}

inline int row_copy(int n, const void* ptr, bool words) {
  if (n % 8 == 0 && aligned(ptr, 16)) return kRows16;
  if (words && n % 2 == 1 && n <= 5 && aligned(ptr, 4)) return kRowsWords;
  return kRowsSync;
}

ParamsBf16 params_bf16(const void* feats, const int* nbr, const void* weight, const float* scale,
                       const float* shift, const void* residual, void* out, int cap_in,
                       int cap_out, int num_offsets, int cin, int cout, int relu) {
  ParamsBf16 p{static_cast<const uint16_t*>(feats), nbr, static_cast<const uint16_t*>(weight),
               scale, shift, static_cast<const uint16_t*>(residual), static_cast<uint16_t*>(out),
               cap_in, cap_out, num_offsets, cin, cout, relu, 0, 0};
  p.rows = row_copy(cin, feats, true);
  p.weights = row_copy(cout, weight, false);
  p.pair_out = cout % 2 == 0 && aligned(out, 4) && (!residual || aligned(residual, 4));
  return p;
}

}  // namespace
