// Fused gated nearest-neighbour Hamming matcher for NVIDIA Hopper (sm_90a).
//
// Replaces orb_slam2_map_tpu/ops/pallas_kernels.py:gated_nn_pallas
// (kernel body _gated_nn_kernel), the matcher under every projection
// search of the tracking path (slam/search.py).
//
// For each query row i of A [N, 8] (packed 256-bit descriptors) against
// every key j of B [M, 8], under gate [N, M] (nonzero = pair allowed):
//   d(i, j)   = popcount(A[i] ^ B[j]) if gate[i, j] else 1e9
//   best[i]   = min_j d(i, j)
//   idx[i]    = lowest j with d(i, j) == best[i]; 0 when best[i] >= 1e9
//   second[i] = min over j != idx[i] of d(i, j), capped at 1e9
// (a tie at the best distance therefore gives second == best).
//
// What bounds it on this card: the gate. At the local-map shape
// [4096 x 1032] the gate is 4.2 MB of bytes read once, against 32 KB of
// keys reused by every row; the popcount work (8 XOR + __popc per pair)
// is small. The design keeps everything else out of device memory: the
// [N, M] distance matrix never exists, keys are staged once per block
// in shared memory, and the argmin / second-best reductions happen in
// registers and warp shuffles.
//
// Layout: one warp per query row, 8 rows (256 threads) per block. The
// block stages keys in chunks of KEY_CHUNK in shared memory, word-major
// ([8][KEY_CHUNK], so a warp reading word w of 32 consecutive keys hits
// 32 distinct banks). Lane l walks columns l, l+32, ... in ascending
// order and keeps (best, idx, second): a strictly smaller value pushes
// best into second; anything else only lowers second. The warp then
// merges lane triples pairwise: the lexicographically smaller (best,
// idx) wins, and second = min(second_winner, best_loser).
//
// The kernel allocates nothing and does not synchronise; the host
// wrapper (ops/gated_nn_cuda.py) allocates the outputs and checks
// shapes, types and devices.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS_PER_BLOCK = 8;
constexpr int THREADS = ROWS_PER_BLOCK * 32;
constexpr int KEY_CHUNK = 1024;            // 8 words x 1024 keys x 4 B = 32 KB
constexpr float GATED = 1e9f;
constexpr int NO_IDX = 0x7fffffff;

struct Triple {
  float best;
  int idx;
  float second;
};

__device__ __forceinline__ Triple merge(Triple x, Triple y) {
  const bool x_wins = (x.best < y.best) || (x.best == y.best && x.idx < y.idx);
  Triple w = x_wins ? x : y;
  const float loser_best = x_wins ? y.best : x.best;
  w.second = fminf(w.second, loser_best);
  return w;
}

__global__ void __launch_bounds__(THREADS)
gated_nn_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                const uint8_t* __restrict__ gate, int32_t* __restrict__ idx_out,
                float* __restrict__ best_out, float* __restrict__ second_out,
                int n, int m) {
  __shared__ uint32_t keys[8][KEY_CHUNK];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS_PER_BLOCK + warp;
  const bool active = row < n;

  uint32_t q[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) q[w] = active ? a[(size_t)row * 8 + w] : 0u;
  const uint8_t* grow = gate + (size_t)(active ? row : 0) * (size_t)m;

  Triple t{GATED, NO_IDX, GATED};

  for (int c0 = 0; c0 < m; c0 += KEY_CHUNK) {
    const int cn = min(KEY_CHUNK, m - c0);
    __syncthreads();  // the previous chunk is no longer read
    for (int i = threadIdx.x; i < cn * 8; i += THREADS) {
      const int w = i / cn;
      const int k = i - w * cn;
      keys[w][k] = b[(size_t)(c0 + k) * 8 + w];
    }
    __syncthreads();
    if (active) {
      for (int k = lane; k < cn; k += 32) {
        const int j = c0 + k;
        float v = GATED;
        if (grow[j]) {
          int d = 0;
#pragma unroll
          for (int w = 0; w < 8; ++w) d += __popc(q[w] ^ keys[w][k]);
          v = (float)d;
        }
        if (v < t.best) {
          t.second = t.best;
          t.best = v;
          t.idx = j;
        } else {
          t.second = fminf(t.second, v);
        }
      }
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Triple o;
    o.best = __shfl_xor_sync(0xffffffffu, t.best, off);
    o.idx = __shfl_xor_sync(0xffffffffu, t.idx, off);
    o.second = __shfl_xor_sync(0xffffffffu, t.second, off);
    t = merge(t, o);
  }

  if (active && lane == 0) {
    idx_out[row] = t.best >= GATED ? 0 : t.idx;
    best_out[row] = t.best;
    second_out[row] = t.second;
  }
}

}  // namespace

// Plain C entry for ctypes. Pointers are device pointers; `stream` is a
// cudaStream_t. Returns cudaGetLastError() after the launch (0 = ok).
extern "C" int gated_nn_launch(const void* a, const void* b, const void* gate,
                               void* idx, void* best, void* second, int n,
                               int m, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const dim3 grid((n + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
  gated_nn_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (const uint8_t*)gate,
      (int32_t*)idx, (float*)best, (float*)second, n, m);
  return (int)cudaGetLastError();
}
