// D2: furthest point sampling, one block a sample up to 8,192 points, a
// cluster of four blocks past that.
//
//   dist[j] = 1e10 (valid j) or -1 (masked j);  out[0] = 0;  last = 0
//   for i in 1 .. npoint-1:
//       d[j] = (dx*dx + dy*dy) + dz*dz,  (dx, dy, dz) = xyz[j] - xyz[last]  (-1 if masked)
//       dist[j] = min(dist[j], d[j]);  last = argmax_j dist[j] (the lowest j of equal ones)
//       out[i] = last
//
// Replaces no Pallas kernel: the JAX package's furthest_point_sample
// (bevfusion_tpu/ops/pointnet.py:64-85) is a lax.fori_loop of npoint - 1
// rounds on the device. Its plain PyTorch counterpart
// (ops/pointnet.py:furthest_point_sample_plain) issues several launches a
// round: 3,840 rounds for VoteNet's SA stack (2048 + 1024 + 512 + 256
// samples), each a few microseconds of launch overhead. This kernel runs
// every round of a sample in one launch.
//
// What bounds it on an H100 SXM (at its full 700 W): the rounds are
// dependent (each needs the previous argmax), so a sample is one chain of
// npoint - 1 steps of N distance updates and one argmax each; the bytes
// (xyz read once, 12 N bytes; the indices written once) and the operations
// (8 N a round: 3 subtractions, 3 products, 2 additions, then a min and a
// compare) are far below what the card moves and computes in that chain:
// for N = 20,000 and 2,048 samples, 0.33 G operations (5 us at the fp32
// peak) against 2,047 dependent rounds. A round's fixed cost is what the
// design cuts (its first form spent ~0.7 us a round at N <= 2,048 on two
// barriers, a serial second-level reduction and an L2 read of the last
// point, and 4.6 us at N = 20,000 reading 20 points a thread from L2):
// - the points of a sample are dealt to its threads (j = g, g + TT, ...
//   for the sample's TT threads), P a thread: up to 8,192 points a block
//   every point is in registers (coordinates and running distance), P =
//   min(ceil(points / 512), 8) and the block sized to its points (no slot
//   rounded up a power of two; ops/pointnet.py:fps_plan); a slot past N
//   holds the distance -inf;
// - past 8,192 points a cluster of four blocks on four SMs shares the
//   sample (a quarter each, still every point in registers): one SM's
//   issue rate is what a round at 20,000 points spends (12 instructions a
//   point), so four SMs take a quarter each (one block keeping 12,000 of
//   the points in shared memory took 1.7x as long, a cluster of two 1.3x,
//   and their forms spilled registers; PERF.md section 6);
// - a thread's argmax over its slots (select and max, no branch; a strict
//   > in slot order keeps the lowest index), the warp's by a redux (the
//   largest distance as an ordered int) and a ballot of its holders (a
//   second redux, the lowest index, only where they tie); the warp's
//   winner writes (distance, index, x, y, z) to its slot of a buffer chosen
//   by the round's parity; one barrier; every warp then reduces the slots
//   itself, the same way, and takes the winner's coordinates from its
//   slot: one barrier a round, no global read of the last point, and the
//   parity keeps a fast warp's next slot from overwriting one a slow warp
//   still reads. In a cluster warp 0's winner then hands the block's winner
//   to every block's slot of the same kind (distributed shared memory), and
//   one cluster barrier later every warp takes the best of the four;
// - the distance's operations are rounded one by one (__fsub_rn,
//   __fmul_rn, __fadd_rn: no fused multiply-add), as the plain version and
//   the JAX package compute them, so the indices are the same bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRegPoints = 8;  // points a thread at most, all in registers
constexpr int kCluster = 4;    // the blocks of a sample past 8,192 points

// a launch's shape, as ops/pointnet.py:fps_plan chooses it
struct Plan {
  int threads, points, cluster;  // threads a block, points a thread, blocks a sample
};

// a float as an int of the same order (no NaN here)
__device__ __forceinline__ int ordered(float v) {
  const int b = __float_as_int(v);
  return b ^ ((b >> 31) & 0x7fffffff);
}

// the register slot k's coordinates, k in [LO, HI): a binary tree of branches
template <int LO, int HI, int R>
__device__ __forceinline__ void pick(const float (&px)[R], const float (&py)[R],
                                     const float (&pz)[R], int k, float& x, float& y, float& z) {
  if constexpr (HI - LO == 1) {
    x = px[LO];
    y = py[LO];
    z = pz[LO];
  } else {
    constexpr int MID = (LO + HI) / 2;
    if (k < MID)
      pick<LO, MID, R>(px, py, pz, k, x, y, z);
    else
      pick<MID, HI, R>(px, py, pz, k, x, y, z);
  }
}

// the lane's (ordered distance, index) candidates reduced over the warp:
// the largest distance, then the lowest index (a second redux only where
// lanes tie); returns the winning lane
__device__ __forceinline__ int warp_winner(int key, int idx) {
  const int wkey = __reduce_max_sync(kFull, key);
  unsigned m = __ballot_sync(kFull, key == wkey);
  if (m & (m - 1)) {
    const int cand = key == wkey ? idx : INT_MAX;
    m = __ballot_sync(kFull, cand == __reduce_min_sync(kFull, cand));
  }
  return __ffs(m) - 1;
}

template <int P, int CL>
__global__ void __launch_bounds__(kMaxThreads)
fps_kernel(const float* __restrict__ xyz, const uint8_t* __restrict__ mask,
           int* __restrict__ out, int n, int npoint) {
  __shared__ int2 slot_ki[2][32];    // each warp's (ordered distance, index)
  __shared__ float4 slot_pt[2][32];  // and its point
  __shared__ int2 block_ki[2][CL];   // each block's of the cluster (CL > 1)
  __shared__ float4 block_pt[2][CL];
  const int c = CL > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const int b = blockIdx.x / CL, t = threadIdx.x, T = blockDim.x;
  const int g = c * T + t, TT = CL * T;  // the thread and the threads of the sample
  const int lane = t & 31, warp = t >> 5;
  const float* xs = xyz + static_cast<size_t>(b) * 3 * n;
  const float* ys = xs + n;
  const float* zs = ys + n;
  const uint8_t* ms = mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * n;
  float dist[P], px[P], py[P], pz[P];
  // a valid point's running distance stays >= 0, a masked one's is -1 for
  // good, a slot past n holds -inf: the sign says which, no flag is kept
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int j = g + k * TT;
    const bool in = j < n;
    dist[k] = !in ? -__int_as_float(0x7f800000) : ((ms == nullptr || ms[j] != 0) ? 1e10f : -1.0f);
    px[k] = in ? xs[j] : 0.0f;
    py[k] = in ? ys[j] : 0.0f;
    pz[k] = in ? zs[j] : 0.0f;
  }
  int* o = out + static_cast<size_t>(b) * npoint;
  if (g == 0) o[0] = 0;
  float lx = xs[0], ly = ys[0], lz = zs[0];
  // every block of the cluster runs before a slot is written into it
  if constexpr (CL > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
  for (int i = 1; i < npoint; ++i) {
    // every slot's distance update, then the thread's argmax: min, max and
    // one select, no branch (a slot past n stays -inf; a strict > in slot
    // order keeps the lowest index)
    float best = -__int_as_float(0x7f800000);
    int bk = 0;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const float dx = __fsub_rn(px[k], lx), dy = __fsub_rn(py[k], ly), dz = __fsub_rn(pz[k], lz);
      const float d =
          __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      dist[k] = fminf(dist[k], d);  // -1 and -inf stay
      bk = dist[k] > best ? k : bk;
      best = fmaxf(best, dist[k]);
    }
    const int key = ordered(best), j = g + bk * TT, par = i & 1;
    if (lane == warp_winner(key, j)) {  // one lane: its point's coordinates go with it
      float x, y, z;
      pick<0, P, P>(px, py, pz, bk, x, y, z);
      slot_ki[par][warp] = make_int2(key, j);
      slot_pt[par][warp] = make_float4(x, y, z, 0.0f);
    }
    __syncthreads();
    // the block's winner from its warps' slots, the same way
    const int2 sl = lane < (T >> 5) ? slot_ki[par][lane] : make_int2(INT_MIN, INT_MAX);
    int wl = warp_winner(sl.x, sl.y);
    int bj = __shfl_sync(kFull, sl.y, wl);
    float4 w = slot_pt[par][wl];
    if constexpr (CL > 1) {
      // the sample's: warp 0's winning lane hands the block's winner to every
      // block of the cluster (distributed shared memory), one cluster barrier,
      // then every warp takes the best of the blocks' (one a lane)
      cg::cluster_group cluster = cg::this_cluster();
      if (warp == 0 && lane == wl) {
#pragma unroll
        for (int q = 0; q < CL; ++q) {
          cluster.map_shared_rank(&block_ki[par][0], q)[c] = sl;
          cluster.map_shared_rank(&block_pt[par][0], q)[c] = w;
        }
      }
      cluster.sync();
      const int2 bl = lane < CL ? block_ki[par][lane] : make_int2(INT_MIN, INT_MAX);
      wl = warp_winner(bl.x, bl.y);
      bj = __shfl_sync(kFull, bl.y, wl);
      w = block_pt[par][wl];
    }
    lx = w.x;
    ly = w.y;
    lz = w.z;
    if (g == 0) o[i] = bj;
  }
}

template <int P, int CL>
int launch(const Plan& p, const float* xyz, const uint8_t* mask, int* out, int batch, int n,
           int npoint, cudaStream_t stream) {
  auto kernel = fps_kernel<P, CL>;
  if constexpr (CL == 1) {
    kernel<<<batch, p.threads, 0, stream>>>(xyz, mask, out, n, npoint);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * CL);
  cfg.blockDim = dim3(p.threads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, xyz, mask, out, n, npoint);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int P, int CL>
int dispatch(const Plan& p, const float* xyz, const uint8_t* mask, int* out, int batch, int n,
             int npoint, cudaStream_t stream) {
  if constexpr (P > kRegPoints) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (p.points == P) return launch<P, CL>(p, xyz, mask, out, batch, n, npoint, stream);
    return dispatch<P + 1, CL>(p, xyz, mask, out, batch, n, npoint, stream);
  }
}

}  // namespace

// xyz [batch, 3, n] fp32 (each sample's x, then y, then z), mask [batch, n]
// uint8 (0 = masked) or null, out [batch, npoint] int32; all contiguous
// device memory. 1 <= n <= 32768, npoint >= 1. The launch as
// ops/pointnet.py:fps_plan gives it: `threads` a block (whole warps, at most
// 1024), `points` a thread (1-8, in registers), `cluster` blocks a sample
// (1 or 4), covering the n points. Refuses a launch past those limits;
// launches on `stream`, does not synchronise, and returns the launch's
// cudaError_t (0 on success).
extern "C" int bevf_furthest_point_sample(const float* xyz, const uint8_t* mask, int* out,
                                          int batch, int n, int npoint, int threads, int points,
                                          int cluster, void* stream) {
  if (batch < 1 || npoint < 1 || n < 1 || n > kCluster * kRegPoints * kMaxThreads ||
      threads < 32 || threads > kMaxThreads || threads % 32 || points < 1 ||
      points > kRegPoints || (cluster != 1 && cluster != kCluster) ||
      static_cast<long long>(threads) * points * cluster < n)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p{threads, points, cluster};
  const auto s = static_cast<cudaStream_t>(stream);
  if (p.cluster == 1) return dispatch<1, 1>(p, xyz, mask, out, batch, n, npoint, s);
  return dispatch<1, kCluster>(p, xyz, mask, out, batch, n, npoint, s);
}
