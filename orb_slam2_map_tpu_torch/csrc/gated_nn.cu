// Fused gated nearest-neighbour Hamming matcher for NVIDIA Hopper (sm_90a).
//
// Replaces orb_slam2_map_tpu/ops/pallas_kernels.py:gated_nn_pallas
// (lines 125-170, kernel body _gated_nn_kernel at 89-122, pallas_call at
// 142), the matcher under every projection search of the tracking path
// (slam/search.py) and of local mapping (slam/mapping_kernels.py).
//
// For each query row i of A [N, 8] (packed 256-bit descriptors) against
// every key j of B [M, 8], under gate [N, M] (torch.bool: 1 = allowed):
//   d(i, j)   = popcount(A[i] ^ B[j]) if gate[i, j] else 1e9
//   best[i]   = min_j d(i, j)
//   idx[i]    = lowest j with d(i, j) == best[i]; 0 when best[i] >= 1e9
//   second[i] = min over j != idx[i] of d(i, j), capped at 1e9
// (a tie at the best distance therefore gives second == best).
//
// What bounds it on this card. The least time is set by the bytes: the
// [N, M] byte gate read once (4.2 MB at the local-map shape [4096 x
// 1032], 8.4 MB at [4096 x 2040]), against 2 x 256 int8 operations per
// open pair, a fraction of that time at 1,979 TOP/s. A CUDA-core kernel
// is held far above it by the popcount issue rate (8 __popc per pair at
// 16 per clock per SM: ~16 us at [4096 x 2040]).
//
// Design (csrc/hamming_mma.cuh has the tile and the bit order):
// - The distances come from the tensor cores as a +-1 int8 product,
//   d = (256 - a.b) / 2. A warp owns 32 query rows (two m16 tiles),
//   unpacked once into A fragments kept in registers; keys stay packed
//   and each B fragment is unpacked right before its mma.
// - A block of 4 warps shares 32 query rows and splits its key range
//   among the warps in chunks of 64 keys; where that leaves SMs idle the
//   key range is also split across the blocks of a thread-block cluster
//   (gridDim.y = cluster size, up to 8), and the
//   cluster's first block merges the others' results from their shared
//   memory (distributed shared memory): no second pass, no scratch in
//   device memory.
// - Each warp computes two n8 key tiles at a time, so four independent
//   mma accumulator chains (2 tiles x 2 m16 tiles) hide the mma latency.
// - Each warp stages its chunk's keys (2 KB) and gate tile (32 x 64 B)
//   in shared memory with cp.async, double-buffered, so the next chunk
//   loads while this one computes. The gate rows are M bytes apart and
//   M (1032, 2040 on the paths) is a multiple of 8 but not of 16, so the
//   gate is copied 8 bytes at a time (16-byte copies and TMA would be
//   misaligned); an M that is not a multiple of 8 takes byte loads.
// - A pair of n8 key tiles whose gate is closed for all 32 rows of the
//   warp skips its mmas: real search gates are windows and mostly closed
//   (chip_smoke.py measures the open share on each path).
// - Epilogue. Each candidate is one 32-bit key, (d << 22) | j for an
//   open pair, with 2^31 added for a closed one: one IMAD from the
//   accumulator, the gate bit XORed into the addend. The smallest key
//   is the lowest column at the best distance, and the second-smallest
//   key's distance is the best over the other columns, so the running
//   (best, second) pair is three unsigned min/max operations per
//   candidate, in whatever order the mma layout visits the columns (2t,
//   2t + 1 of each n8 tile), and merging two pairs (quad lanes, warps,
//   cluster blocks) is
//       best = min(b1, b2), second = min(s1, s2, max(b1, b2)),
//   associative and commutative. A best >= 2^31 means the row is all
//   gated: idx 0, best 1e9. Columns must be below 2^22.
//
// The kernel allocates nothing and does not synchronise; the host wrapper
// (ops/gated_nn_cuda.py) allocates the outputs and checks shapes, types,
// alignment and devices.

#include <cooperative_groups.h>

#include "hamming_mma.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace hamming_mma;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = 32;                  // query rows per block (2 m16 tiles)
constexpr int CHUNK = 64;                 // keys per staged chunk (8 n8 tiles)
constexpr int GATE_STRIDE = CHUNK + 8;    // bytes; spreads the 16-bit reads over banks
constexpr uint32_t CLOSED = 0x80000000u;  // added to the key of a gated pair
constexpr uint32_t NONE = 0xFFFFFFFFu;    // no candidate yet
constexpr int IDX_BITS = 22;
constexpr int MAX_CLUSTER = 8;          // portable thread-block cluster size
constexpr int TILES = 2;                // n8 key tiles per step: 2 x TILES mma chains
constexpr int MIN_BLOCKS = 3;           // resident blocks per SM (register budget)
constexpr int BLOCKS_PER_SM = 2;        // the key splits aim at this many per SM

struct WarpStage {
  uint32_t keys[CHUNK][8];
  uint8_t gate[ROWS][GATE_STRIDE];
};

__device__ __forceinline__ void merge(uint32_t& b, uint32_t& s, uint32_t ob,
                                      uint32_t os) {
  s = min(min(s, os), max(b, ob));
  b = min(b, ob);
}

__device__ __forceinline__ void write_row(uint32_t b, uint32_t s, int row,
                                          int32_t* idx_out, float* best_out,
                                          float* second_out) {
  const bool none = b >= CLOSED;
  idx_out[row] = none ? 0 : (int32_t)(b & ((1u << IDX_BITS) - 1u));
  best_out[row] = none ? 1e9f : (float)(b >> IDX_BITS);
  second_out[row] = s >= CLOSED ? 1e9f : (float)(s >> IDX_BITS);
}

// Stage chunk c of the keys and of the block's 32 gate rows into st.
template <bool GATE8>
__device__ __forceinline__ void stage_chunk(WarpStage& st, int c, int lane,
                                            const uint32_t* b,
                                            const uint8_t* gate, int row0,
                                            int n, int m) {
  const int k0 = c * CHUNK;
#pragma unroll
  for (int i = 0; i < CHUNK * 2 / 32; ++i) {
    const int p = lane + 32 * i;
    const int key = p >> 1;
    const bool ok = k0 + key < m;
    cp_async16(&st.keys[key][(p & 1) * 4],
               ok ? b + (size_t)(k0 + key) * 8 + (p & 1) * 4 : b, ok);
  }
  if (GATE8) {
#pragma unroll
    for (int i = 0; i < ROWS * (CHUNK / 8) / 32; ++i) {
      const int p = lane + 32 * i;
      const int r = p / (CHUNK / 8);
      const int col = (p % (CHUNK / 8)) * 8;
      const bool ok = row0 + r < n && k0 + col < m;
      cp_async8(&st.gate[r][col],
                ok ? gate + (size_t)(row0 + r) * m + k0 + col : gate, ok);
    }
  } else {
    for (int p = lane; p < ROWS * CHUNK; p += 32) {
      const int r = p / CHUNK;
      const int col = p % CHUNK;
      st.gate[r][col] = (row0 + r < n && k0 + col < m)
                            ? gate[(size_t)(row0 + r) * m + k0 + col]
                            : (uint8_t)0;
    }
  }
  cp_async_commit();
}

template <bool GATE8>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
gated_nn_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                const uint8_t* __restrict__ gate, int32_t* __restrict__ idx_out,
                float* __restrict__ best_out, float* __restrict__ second_out,
                int n, int m, int chunks_per_block) {
  __shared__ __align__(16) WarpStage stage[WARPS][2];
  __shared__ uint2 merged[WARPS][ROWS];
  __shared__ uint2 block_rows[ROWS];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = blockIdx.x * ROWS;
  const int chunks = (m + CHUNK - 1) / CHUNK;
  const int c_end = min(chunks, (int)(blockIdx.y + 1) * chunks_per_block);

  // the first chunk is in flight while the query rows are unpacked
  int c = blockIdx.y * chunks_per_block + warp;
  if (c < c_end)
    stage_chunk<GATE8>(stage[warp][0], c, lane, b, gate, row0, n, m);
  QueryTiles<2> q;
  q.load([&](int r) -> const uint32_t* {
    return row0 + r < n ? a + (size_t)(row0 + r) * 8 : nullptr;
  }, lane);

  // (best, second) keys of rows g + 8 * ri, over this thread's columns
  uint32_t best[4], second[4];
#pragma unroll
  for (int ri = 0; ri < 4; ++ri) best[ri] = second[ri] = NONE;

  for (int buf = 0; c < c_end; c += WARPS, buf ^= 1) {
    if (c + WARPS < c_end) {
      stage_chunk<GATE8>(stage[warp][buf ^ 1], c + WARPS, lane, b, gate,
                         row0, n, m);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const WarpStage& st = stage[warp][buf];
    const int k0 = c * CHUNK;
    // TILES n8 tiles at a time: 2 x TILES independent mma chains.
    // Columns past m were staged with a closed gate: skipped or ignored.
    for (int u = 0; u < CHUNK / 8; u += TILES) {
      uint32_t gw[TILES][4];
      uint32_t open = 0u;
#pragma unroll
      for (int k = 0; k < TILES; ++k)
#pragma unroll
        for (int ri = 0; ri < 4; ++ri) {
          gw[k][ri] = *reinterpret_cast<const uint16_t*>(
              &st.gate[8 * ri + g][8 * (u + k) + 2 * t]);
          open |= gw[k][ri];
        }
      if (!__any_sync(0xffffffffu, open != 0u)) continue;
      uint32_t kw[TILES][8];
#pragma unroll
      for (int k = 0; k < TILES; ++k) load_key(kw[k], st.keys[8 * (u + k) + g]);
      int32_t acc[TILES][2][4];
      q.dot<TILES>(acc, kw, t);
#pragma unroll
      for (int k = 0; k < TILES; ++k) {
        // addend of column j: j + 2^29 + 2^31, the 2^31 cleared when
        // open; key = addend - acc * 2^21 = (d << 22) | j (+ 2^31 if closed)
        const uint32_t base =
            (uint32_t)(k0 + 8 * (u + k) + 2 * t) + 0xA0000000u;
#pragma unroll
        for (int ri = 0; ri < 4; ++ri) {
          const int r = ri >> 1;
          const int h = ri & 1;
          const uint32_t v0 = (base ^ (gw[k][ri] << 31))
                              + (uint32_t)acc[k][r][2 * h] * 0xFFE00000u;
          const uint32_t v1 = ((base + 1u) ^ ((gw[k][ri] << 23) & CLOSED))
                              + (uint32_t)acc[k][r][2 * h + 1] * 0xFFE00000u;
          second[ri] = min(second[ri], max(best[ri], v0));
          best[ri] = min(best[ri], v0);
          second[ri] = min(second[ri], max(best[ri], v1));
          best[ri] = min(best[ri], v1);
        }
      }
    }
    __syncwarp();  // this buffer is refilled in the next iteration
  }

  // merge: the 4 lanes of a quad (shuffles), the 4 warps (shared
  // memory), the blocks of the cluster (distributed shared memory)
#pragma unroll
  for (int ri = 0; ri < 4; ++ri) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const uint32_t ob = __shfl_xor_sync(0xffffffffu, best[ri], off);
      const uint32_t os = __shfl_xor_sync(0xffffffffu, second[ri], off);
      merge(best[ri], second[ri], ob, os);
    }
    if (t == 0) merged[warp][8 * ri + g] = make_uint2(best[ri], second[ri]);
  }
  __syncthreads();
  if (threadIdx.x < ROWS) {
    uint32_t rb = NONE, rs = NONE;
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      merge(rb, rs, merged[w][threadIdx.x].x, merged[w][threadIdx.x].y);
    block_rows[threadIdx.x] = make_uint2(rb, rs);
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (cluster.block_rank() == 0 && threadIdx.x < ROWS) {
    uint2 r = block_rows[threadIdx.x];
    for (unsigned k = 1; k < cluster.num_blocks(); ++k) {
      const uint2 o = cluster.map_shared_rank(block_rows, k)[threadIdx.x];
      merge(r.x, r.y, o.x, o.y);
    }
    if (row0 + (int)threadIdx.x < n)
      write_row(r.x, r.y, row0 + threadIdx.x, idx_out, best_out, second_out);
  }
  cluster.sync();  // each block's shared memory outlives the reads of it
}

template <bool GATE8>
cudaError_t launch(const dim3& grid, int splits, cudaStream_t stream,
                   const void* a, const void* b, const void* gate, void* idx,
                   void* best, void* second, int n, int m, int per_block) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = splits;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, gated_nn_kernel<GATE8>,
                            (const uint32_t*)a, (const uint32_t*)b,
                            (const uint8_t*)gate, (int32_t*)idx, (float*)best,
                            (float*)second, n, m, per_block);
}

// Key splits for an [n, m] problem: about two blocks per SM where the
// key range allows (each warp at least one chunk), at most the portable
// cluster size. (Measured on an H100: three resident blocks per SM, or
// clusters padded to powers of two, were slower at the path shapes.)
int splits_for(int n, int m) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int chunks = (m + CHUNK - 1) / CHUNK;
  const int row_blocks = (n + ROWS - 1) / ROWS;
  const int by_keys = (chunks + WARPS - 1) / WARPS;
  int splits = BLOCKS_PER_SM * sms / row_blocks;
  if (splits > by_keys) splits = by_keys;
  if (splits > MAX_CLUSTER) splits = MAX_CLUSTER;
  return splits > 1 ? splits : 1;
}

}  // namespace

// Plain C entry for ctypes. Pointers are device pointers (a [n, 8] and
// b [m, 8] uint32, 16-byte aligned; gate [n, m] bytes); `stream` is a
// cudaStream_t. Returns the launch's error (0 = ok).
extern "C" int gated_nn_launch(const void* a, const void* b, const void* gate,
                               void* idx, void* best, void* second, int n,
                               int m, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int splits = splits_for(n, m);
  const int chunks = (m + CHUNK - 1) / CHUNK;
  const int per_block = chunks == 0 ? 1 : (chunks + splits - 1) / splits;
  const dim3 grid((n + ROWS - 1) / ROWS, splits);
  const bool gate8 = m % 8 == 0 && (uintptr_t)gate % 8 == 0;
  const cudaError_t err =
      gate8 ? launch<true>(grid, splits, (cudaStream_t)stream, a, b, gate,
                           idx, best, second, n, m, per_block)
            : launch<false>(grid, splits, (cudaStream_t)stream, a, b, gate,
                            idx, best, second, n, m, per_block);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// The key splits the entry chooses for [n, m] (a cluster of that many
// blocks shares each 32-row tile); exported for the tests.
extern "C" int gated_nn_splits(int n, int m) { return splits_for(n, m); }
