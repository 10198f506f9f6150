// D2: furthest point sampling, one block a sample.
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
// every round of a sample inside one block.
//
// What bounds it on an H100 SXM (at its full 700 W): the rounds are
// dependent (each needs the previous argmax), so a sample is one chain of
// npoint - 1 steps of N distance updates and one block-wide argmax each;
// the bytes (xyz read once, 12 N bytes; the indices written once) and the
// operations (8 N a round: 3 subtractions, 3 products, 2 additions, then
// a min and a compare) are far below what the card moves and computes in
// that chain: for N = 20,000 and 2,048 samples, 0.33 G operations (5 us at
// the fp32 peak) against 2,047 barriers-bound rounds. The design keeps a
// round short:
// - 1024 threads a block; each thread owns the points j = t, t + 1024, ...
//   and keeps their running distance in registers (PPT = points per
//   thread, a template parameter, N <= 32 * 1024), and their coordinates
//   too where PPT <= 8; beyond that it reads them each round from the
//   [B, 3, N] layout the wrapper prepares (neighbouring threads,
//   neighbouring floats; L2-resident after the first round);
// - the argmax is a warp shuffle reduction (value, then lowest index),
//   one slot a warp in shared memory, and a last warp's reduction: two
//   barriers a round;
// - the distance's operations are rounded one by one (__fsub_rn,
//   __fmul_rn, __fadd_rn: no fused multiply-add), as the plain version and
//   the JAX package compute them, so the indices are the same bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

// (value, index) of the larger value; of equal values the lower index
__device__ __forceinline__ void better(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

template <int PPT>
__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ xyz, const uint8_t* __restrict__ mask,
           int* __restrict__ out, int n, int npoint) {
  constexpr bool kRegXyz = PPT <= 8;
  __shared__ float warp_v[kWarps];
  __shared__ int warp_i[kWarps];
  __shared__ int winner;
  const int b = blockIdx.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float* xs = xyz + static_cast<size_t>(b) * 3 * n;
  const float* ys = xs + n;
  const float* zs = ys + n;
  const uint8_t* ms = mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * n;
  float dist[PPT];
  float px[kRegXyz ? PPT : 1], py[kRegXyz ? PPT : 1], pz[kRegXyz ? PPT : 1];
  // a valid point's running distance stays >= 0, a masked one's is -1 for
  // good, a slot past n holds -inf: the sign says which, no flag is kept
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int j = t + k * kThreads;
    const bool in = j < n;
    dist[k] = !in ? -__int_as_float(0x7f800000)
                  : ((ms == nullptr || ms[j] != 0) ? 1e10f : -1.0f);
    if constexpr (kRegXyz) {
      px[k] = in ? xs[j] : 0.0f;
      py[k] = in ? ys[j] : 0.0f;
      pz[k] = in ? zs[j] : 0.0f;
    }
  }
  int* o = out + static_cast<size_t>(b) * npoint;
  if (t == 0) o[0] = 0;
  int last = 0;
  for (int i = 1; i < npoint; ++i) {
    const float lx = __ldg(xs + last), ly = __ldg(ys + last), lz = __ldg(zs + last);
    float best = -__int_as_float(0x7f800000);
    int best_i = 0x7fffffff;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int j = t + k * kThreads;
      if (dist[k] >= 0.0f) {  // a valid point (a masked one keeps -1)
        float x, y, z;
        if constexpr (kRegXyz) {
          x = px[k];
          y = py[k];
          z = pz[k];
        } else {
          x = __ldg(xs + j);
          y = __ldg(ys + j);
          z = __ldg(zs + j);
        }
        const float dx = __fsub_rn(x, lx), dy = __fsub_rn(y, ly), dz = __fsub_rn(z, lz);
        const float d =
            __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
        if (d < dist[k]) dist[k] = d;
      }
      better(best, best_i, dist[k], j);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      better(best, best_i, __shfl_down_sync(0xffffffffu, best, off),
             __shfl_down_sync(0xffffffffu, best_i, off));
    }
    if (lane == 0) {
      warp_v[warp] = best;
      warp_i[warp] = best_i;
    }
    __syncthreads();
    if (warp == 0) {
      float v = warp_v[lane];
      int vi = warp_i[lane];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        better(v, vi, __shfl_down_sync(0xffffffffu, v, off),
               __shfl_down_sync(0xffffffffu, vi, off));
      }
      if (lane == 0) {
        winner = vi;
        o[i] = vi;
      }
    }
    __syncthreads();
    last = winner;
  }
}

template <int PPT>
int launch(const float* xyz, const uint8_t* mask, int* out, int batch, int n, int npoint,
           cudaStream_t stream) {
  fps_kernel<PPT><<<batch, kThreads, 0, stream>>>(xyz, mask, out, n, npoint);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xyz [batch, 3, n] fp32 (each sample's x, then y, then z), mask [batch, n]
// uint8 (0 = masked) or null, out [batch, npoint] int32; all contiguous
// device memory. 1 <= n <= 32768, npoint >= 1. Launches on `stream`, does
// not synchronise, and returns the launch's cudaError_t (0 on success).
extern "C" int bevf_furthest_point_sample(const float* xyz, const uint8_t* mask, int* out,
                                          int batch, int n, int npoint, void* stream) {
  if (batch < 1 || n < 1 || n > 32 * kThreads || npoint < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int ppt = (n + kThreads - 1) / kThreads;
  if (ppt <= 1) return launch<1>(xyz, mask, out, batch, n, npoint, s);
  if (ppt <= 2) return launch<2>(xyz, mask, out, batch, n, npoint, s);
  if (ppt <= 4) return launch<4>(xyz, mask, out, batch, n, npoint, s);
  if (ppt <= 8) return launch<8>(xyz, mask, out, batch, n, npoint, s);
  if (ppt <= 16) return launch<16>(xyz, mask, out, batch, n, npoint, s);
  return launch<32>(xyz, mask, out, batch, n, npoint, s);
}
