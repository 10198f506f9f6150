// The heads' NMS as two kernels: N1 builds the suppression words, N2 runs
// the greedy pass on them.
//
//   N1: words[p][i][j / 64] bit (j % 64) = j > i and row i suppresses column j
//       (rows and columns in score order; circle problems: the squared
//       center distance <= thr[p]; rotated problems: the BEV IoU > thr[p])
//   N2: removed = {};  for i in 0 .. n-1:  if i not in removed:
//           keep i;  removed |= {j > i : bit j of row i}
//       keep[order[i]] = kept i
//
// Replaces the greedy pass of the JAX package's NMS,
// bevfusion_tpu/ops/nms.py:25 (_greedy_suppress, a lax.fori_loop over
// score rank) and the [N, N] suppression matrix its callers build with
// XLA ops (circle_nms_mask, nms_bev_mask; the rotated IoU of
// bevfusion_tpu/ops/iou3d.py). Neither is a Pallas kernel. The reference's
// own CUDA (mmdet3d's nms_gpu, iou3d_kernel.cu) has the same two parts: the
// IoU and 64-bit suppression words in one kernel, the greedy pass on the
// words after it.
//
// N1, one thread a (row, column) pair: a block is 8 rows x 32 columns of one
// problem, a warp a row, a lane a column; the block's 8 row boxes and 32
// column boxes are staged in shared memory (nine floats a box: the four BEV
// corners and the area dx * dy, or a circle problem's center in the first
// two), and one __ballot_sync gives a row's 32 bits, stored as one half of
// its 64-bit word. A tile wholly at or below the diagonal writes zeros. Every
// problem of a call is in the one launch (a camera CenterHead frame's six
// tasks: 4 x 125,000 live rotated pairs at N = 500, some 3,000 busy blocks; a
// first form with a 64 x 64 tile a block, 16 pairs a lane, left most SMs one
// or two blocks and ran longer, PERF.md section 6). The rotated IoU is
// ops/iou3d.py's, step for step: row i's rectangle clipped by column j's four
// half-planes (Sutherland-Hodgman, 8 vertex slots, a vertex then the edge's
// intersection emitted in slot order, emits past 8 dropped, the count clamped
// at 8, |denom| < 1e-12 -> 1e-12), the shoelace sum over the active vertices
// in the pairwise order of ops/iou3d.py:_poly_area, abs / 2, the union
// clamped at 1e-6. Every product, sum and quotient is rounded on its own
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn: no contraction into a fused
// multiply-add), as each torch op rounds, so the words equal the plain
// version's. A polygon clipped to nothing stops there (its area is 0, as it
// would be after the other clips). The running polygons live in shared
// memory, a column of slots a thread (no bank conflicts).
//
// N2, one warp a problem: the problem's rows of words copied into shared
// memory (cp.async) at once where they fit (N up to about 1,300), else
// streamed in chunks of 64 rows (fewer above N = 12,480), two in flight. For
// a chunk, the rows whose diagonal word (the word of their own 64-row block,
// bits above the row) is not zero are resolved in order with bit operations,
// every lane doing the same steps: a kept row ORs its diagonal word into the
// block's removed word, a removed row is skipped; the rows whose word is zero
// cost nothing. Then the lanes OR the kept rows' later words into the removed
// set (shared memory): a lane a row, every row's word loaded and a removed
// row's masked off, so that the loads overlap, the lanes' OR by
// __reduce_or_sync. No barrier a row: a chunk is one warp's straight-line
// work. The kept bits wait in shared memory and go out in original index
// order at the end, in one pass, eight `order` loads a lane in flight. Bits
// of a row at or below the diagonal are ignored, as the JAX pass ignores
// them.
//
// What bounds them on an H100 SXM (at its full 700 W): N1's bytes (the
// boxes in, the words out once: 36 N + 8 N W per problem, ~0.1 MB for a
// frame) are nothing; its FP32 operations are the clip's, counted from
// this code per live pair (PERF.md section 3), over 67 TFLOP/s. N2 is n
// dependent steps, the bound the greedy pass has always had: n steps at
// one SM clock each, against its bytes (the words once).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // N1: a block of 8 warps
constexpr int kRows = kThreads / 32;  // N1: rows of a block's tile, one a warp
constexpr int kV = 8;        // the clip's vertex slots (ops/iou3d.py:_V)
constexpr int kGeom = 9;     // floats a box: corners x0 y0 .. x3 y3, area; a circle's center
constexpr int kMaxN = 49152;
constexpr int kMaxSmem = 232448;  // the dynamic shared memory a block may take

// d[0] * (v[1] - p[1]) - d[1] * (v[0] - p[0]): ops/iou3d.py:_clip_halfplane's side
__device__ __forceinline__ float side(float dx, float dy, float px, float py, float vx,
                                      float vy) {
  return __fsub_rn(__fmul_rn(dx, __fsub_rn(vy, py)), __fmul_rn(dy, __fsub_rn(vx, px)));
}

// Clip the polygon (ix, iy: n slots, a slot every kThreads floats) by the
// half-plane left of the directed edge p -> q into (ox, oy); the new count.
__device__ int clip(const float* ix, const float* iy, float* ox, float* oy, int n, float px,
                    float py, float qx, float qy) {
  if (n == 0) return 0;
  const float dx = __fsub_rn(qx, px), dy = __fsub_rn(qy, py);
  const float x0 = ix[0], y0 = iy[0];
  const float s0 = side(dx, dy, px, py, x0, y0);
  float cx = x0, cy = y0, sc = s0;
  int cnt = 0;
  for (int i = 0; i < n; ++i) {
    float nx = x0, ny = y0, sn = s0;  // the last vertex's next is vertex 0
    if (i + 1 < n) {
      nx = ix[(i + 1) * kThreads];
      ny = iy[(i + 1) * kThreads];
      sn = side(dx, dy, px, py, nx, ny);
    }
    const bool in_c = sc >= 0.0f, in_n = sn >= 0.0f;
    if (in_c) {
      if (cnt < kV) {
        ox[cnt * kThreads] = cx;
        oy[cnt * kThreads] = cy;
      }
      ++cnt;
    }
    if (in_c != in_n) {
      const float den = __fsub_rn(sc, sn);
      const float t = __fdiv_rn(sc, fabsf(den) < 1e-12f ? 1e-12f : den);
      if (cnt < kV) {
        ox[cnt * kThreads] = __fadd_rn(cx, __fmul_rn(__fsub_rn(nx, cx), t));
        oy[cnt * kThreads] = __fadd_rn(cy, __fmul_rn(__fsub_rn(ny, cy), t));
      }
      ++cnt;
    }
    cx = nx;
    cy = ny;
    sc = sn;
  }
  return cnt < kV ? cnt : kV;
}

// BEV IoU of row box a (clipped) and column box b (clipping) above thr.
// poly: this thread's two polygon buffers (x, y of each, kV slots apart by
// kThreads floats).
__device__ bool iou_above(const float* a, const float* b, float thr, float* poly) {
  float* bx[2] = {poly, poly + 2 * kV * kThreads};
  float* by[2] = {poly + kV * kThreads, poly + 3 * kV * kThreads};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    bx[0][k * kThreads] = a[2 * k];
    by[0][k * kThreads] = a[2 * k + 1];
  }
  int n = 4;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int f = (e + 1) % 4;
    n = clip(bx[e & 1], by[e & 1], bx[(e + 1) & 1], by[(e + 1) & 1], n, b[2 * e], b[2 * e + 1],
             b[2 * f], b[2 * f + 1]);
  }
  // after four clips the polygon is in buffer 0 again
  float c[kV];
#pragma unroll
  for (int k = 0; k < kV; ++k) {
    c[k] = 0.0f;
    if (k < n) {
      const int m = k + 1 < n ? k + 1 : 0;
      c[k] = __fsub_rn(__fmul_rn(bx[0][k * kThreads], by[0][m * kThreads]),
                       __fmul_rn(bx[0][m * kThreads], by[0][k * kThreads]));
    }
  }
  const float sum = __fadd_rn(__fadd_rn(__fadd_rn(c[0], c[4]), __fadd_rn(c[2], c[6])),
                              __fadd_rn(__fadd_rn(c[1], c[5]), __fadd_rn(c[3], c[7])));
  const float inter = __fdiv_rn(fabsf(sum), 2.0f);
  float uni = __fsub_rn(__fadd_rn(a[8], b[8]), inter);
  uni = uni < 1e-6f ? 1e-6f : uni;  // clamp(min=1e-6); a NaN stays NaN
  return __fdiv_rn(inter, uni) > thr;
}

__global__ void __launch_bounds__(kThreads)
suppression_words_kernel(const float* __restrict__ geom, const uint8_t* __restrict__ rotated,
                         const float* __restrict__ thr, uint32_t* __restrict__ halves, int n,
                         int w_count) {
  // a block: kRows rows x 32 columns (one half-word column); a warp: one row
  const int ct = blockIdx.x, r0 = blockIdx.y * kRows, p = blockIdx.z, tid = threadIdx.x;
  const int c0 = ct * 32, rows = min(kRows, n - r0), cols = min(32, n - c0);
  const int warp = tid >> 5, lane = tid & 31;
  uint32_t* out = halves + (static_cast<size_t>(p) * n + r0) * 2 * w_count + ct;
  if (c0 + 31 <= r0) {  // every column at or left of every row: j <= i throughout
    if (tid < rows) out[static_cast<size_t>(tid) * 2 * w_count] = 0u;
    return;
  }
  __shared__ float row_g[kRows * kGeom], col_g[32 * kGeom];
  __shared__ float poly_s[4 * kV * kThreads];  // per thread: x, y of two polygon buffers
  const float* g = geom + static_cast<size_t>(p) * n * kGeom;
  for (int e = tid; e < rows * kGeom; e += kThreads) row_g[e] = g[r0 * kGeom + e];
  for (int e = tid; e < cols * kGeom; e += kThreads) col_g[e] = g[c0 * kGeom + e];
  __syncthreads();
  if (warp >= rows) return;
  const int i = r0 + warp, j = c0 + lane;
  bool s = false;
  if (lane < cols && j > i) {
    const float* a = row_g + warp * kGeom;
    const float* b = col_g + lane * kGeom;
    if (rotated[p] != 0) {
      s = iou_above(a, b, thr[p], poly_s + tid);
    } else {
      // ((c_i - c_j) ** 2).sum(-1) <= thr
      const float dx = __fsub_rn(a[0], b[0]), dy = __fsub_rn(a[1], b[1]);
      s = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) <= thr[p];
    }
  }
  const uint32_t bits = __ballot_sync(0xffffffffu, s);
  if (lane == 0) out[static_cast<size_t>(warp) * 2 * w_count] = bits;
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the bits of a 64-row block's word above position s
__device__ __forceinline__ unsigned long long above(int s) {
  return s >= 63 ? 0ull : (~0ull << (s + 1));
}

__global__ void __launch_bounds__(32)
greedy_words_kernel(const unsigned long long* __restrict__ words, const int64_t* __restrict__ order,
                    uint8_t* __restrict__ keep_out, int n, int w_count, int chunk_rows,
                    bool whole) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* removed = smem;             // [w_count]: the removed set
  unsigned long long* kept_bits = smem + w_count;  // [w_count]: the kept rows, 64 a word
  unsigned long long* rows_s = smem + 2 * w_count;  // every row, or 2 x [chunk_rows, w_count]
  const int p = blockIdx.x, lane = threadIdx.x;
  const size_t base = static_cast<size_t>(p) * n;
  const unsigned long long* g = words + base * w_count;
  const int chunk = chunk_rows * w_count, chunks = (n + chunk_rows - 1) / chunk_rows;
  for (int w = lane; w < w_count; w += 32) removed[w] = kept_bits[w] = 0ull;
  for (int j = lane; j < n; j += 32) keep_out[base + j] = 0;  // an entry no order names stays 0
  auto stage = [&](int c) {  // chunk c into ring slot c & 1
    const int r0 = c * chunk_rows, len = min(chunk_rows, n - r0) * w_count;
    const unsigned long long* src = g + static_cast<size_t>(r0) * w_count;
    unsigned long long* dst = rows_s + (c & 1) * chunk;
    for (int e = lane; e < len; e += 32) cp_async8(dst + e, src + e);
    cp_async_commit();
  };
  if (whole) {
    for (int e = lane; e < n * w_count; e += 32) cp_async8(rows_s + e, g + e);
    cp_async_commit();
    cp_async_wait<0>();
  } else {
    stage(0);
  }
  __syncwarp();
  unsigned long long rem = 0ull;  // the current 64-row block's removed word, the same in every lane
  for (int c = 0; c < chunks; ++c) {
    const int r0 = c * chunk_rows, rows = min(chunk_rows, n - r0);
    const unsigned long long* buf = rows_s + (whole ? r0 * w_count : (c & 1) * chunk);
    if (!whole) {
      if (c + 1 < chunks) {
        stage(c + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncwarp();
    }
    const int b = r0 >> 6, sh = r0 & 63;
    if (sh == 0) rem = removed[b];
    const unsigned long long row_mask = rows == 64 ? ~0ull : ((1ull << rows) - 1ull);
    // the chunk's rows whose diagonal word is live
    const int k0 = lane, k1 = lane + 32;
    const bool nz0 = k0 < rows && (buf[k0 * w_count + b] & above(sh + k0)) != 0ull;
    const bool nz1 = k1 < rows && (buf[k1 * w_count + b] & above(sh + k1)) != 0ull;
    const unsigned long long nz =
        static_cast<unsigned long long>(__ballot_sync(0xffffffffu, nz0)) |
        (static_cast<unsigned long long>(__ballot_sync(0xffffffffu, nz1)) << 32);
    // the dependent steps: only kept rows with a live word change the block's word
    unsigned long long todo = nz & ~(rem >> sh);
    while (todo) {
      const int k = __ffsll(static_cast<long long>(todo)) - 1;
      rem |= buf[k * w_count + b] & above(sh + k);
      todo &= ~(rem >> sh);
      todo &= todo - 1ull;  // k, the lowest: its own bit is never in rem
    }
    const unsigned long long kept = ~(rem >> sh) & row_mask;
    if (lane == 0) kept_bits[b] |= kept << sh;
    // the kept rows' later words into the removed set: a lane a row (two), every
    // row's word read and a removed row's masked off, so that the loads do not
    // wait on one another, and the lanes' OR by __reduce_or_sync a half word
    const unsigned long long m0 = 0ull - ((kept >> k0) & 1ull), m1 = 0ull - ((kept >> k1) & 1ull);
#pragma unroll 4
    for (int w = b + 1; w < w_count; ++w) {
      const unsigned long long v = (k0 < rows ? buf[k0 * w_count + w] & m0 : 0ull) |
                                   (k1 < rows ? buf[k1 * w_count + w] & m1 : 0ull);
      const unsigned lo = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(v));
      const unsigned hi = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(v >> 32));
      if (lane == 0)
        removed[w] |=
            static_cast<unsigned long long>(lo) | (static_cast<unsigned long long>(hi) << 32);
    }
    __syncwarp();  // the removed set is whole, and the slot free to refill
  }
  // the kept bits out in index order: a lane's eight order entries loaded before any store,
  // so that their latencies overlap
  constexpr int kOut = 8;
  for (int j0 = lane; j0 < n; j0 += 32 * kOut) {
    int64_t o[kOut];
#pragma unroll
    for (int u = 0; u < kOut; ++u) {
      const int j = j0 + 32 * u;
      o[u] = j < n ? order[base + j] : -1;
    }
#pragma unroll
    for (int u = 0; u < kOut; ++u) {
      const int j = j0 + 32 * u;
      if (o[u] >= 0 && o[u] < n)
        keep_out[base + o[u]] = static_cast<uint8_t>((kept_bits[j >> 6] >> (j & 63)) & 1ull);
    }
  }
}

}  // namespace

// N1. geom [problems, n, 9] fp32 (score order: per box its four BEV corners
// x0 y0 .. x3 y3 and its area; a circle problem's center in columns 0-1),
// rotated [problems] uint8 (1 rotated IoU, 0 circle), thr [problems] fp32
// (the IoU threshold, or the squared radius), words [problems, n, ceil(n /
// 64)] int64, every word written. All contiguous device memory; 1 <= n <=
// 49152, problems <= 65535. Launches on `stream`, does not synchronise,
// and returns the launch's cudaError_t (0 on success).
extern "C" int bevf_suppression_words(const float* geom, const uint8_t* rotated, const float* thr,
                                      int64_t* words, int problems, int n, void* stream) {
  if (problems < 1 || problems > 65535 || n < 1 || n > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  const int w_count = (n + 63) / 64;
  // the words as little-endian halves: bits 0-31 of word w are half 2w, bits 32-63 half 2w + 1
  suppression_words_kernel<<<dim3(2 * w_count, (n + kRows - 1) / kRows, problems), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      geom, rotated, thr, reinterpret_cast<uint32_t*>(words), n, w_count);
  return static_cast<int>(cudaGetLastError());
}

// N2. words [problems, n, ceil(n / 64)] int64 (bit j % 64 of word j / 64 of
// row i: row i suppresses column j; bits j <= i ignored), order [problems,
// n] int64 (the score order, a permutation of 0 .. n-1 per problem), keep
// [problems, n] uint8 in the original index order, every entry written (an
// order entry outside 0 .. n-1 is skipped, and no entry gets its bit). All contiguous device
// memory; 1 <= n <= 49152. Launches on `stream`, does not synchronise, and
// returns the launch's cudaError_t (0 on success).
extern "C" int bevf_greedy_suppress_words(const int64_t* words, const int64_t* order,
                                          uint8_t* keep, int problems, int n, void* stream) {
  if (problems < 1 || n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  const int w_count = (n + 63) / 64;
  // every row in shared memory where it fits (n <= 1,300 or so); else chunks of rows, two in
  // flight, of a power of two rows, so that no chunk straddles a 64-row block
  const bool whole = (2 + n) * w_count * 8 <= kMaxSmem;
  int chunk_rows = 64;
  while (!whole && (2 * chunk_rows + 2) * w_count * 8 > kMaxSmem) chunk_rows /= 2;
  const int smem = (whole ? 2 + n : 2 * chunk_rows + 2) * w_count * 8;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        greedy_words_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  greedy_words_kernel<<<problems, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const unsigned long long*>(words), order, keep, n, w_count, chunk_rows,
      whole);
  return static_cast<int>(cudaGetLastError());
}
