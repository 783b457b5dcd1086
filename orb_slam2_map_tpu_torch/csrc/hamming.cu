// All-pairs Hamming distance matrix for NVIDIA Hopper (sm_90a).
//
// Replaces orb_slam2_map_tpu/ops/pallas_kernels.py:hamming_matrix_pallas
// (lines 51-79, kernel body _hamming_kernel at 31-48, pallas_call at 66),
// whose consumer is the stereo matcher (ops/stereo.py: one [N x N]
// matrix per stereo frame, N = 2040 at the KITTI settings).
//
//   out[i, j] = popcount(A[i] ^ B[j])   (float32, A [N, 8], B [M, 8]
//                                        packed 256-bit descriptors)
//
// What bounds it on this card. At [2040 x 2040] the float32 output alone
// is 16.6 MB: 5.0 us at 3.35 TB/s (the inputs are 130 KB). Counted as a
// +-1 int8 product it is 2.13 GOP, 1.1 us at 1,979 TOP/s. So the least
// time is set by the bytes: the output write. A CUDA-core kernel cannot
// reach it: 8 __popc per pair is 33.3 M popcounts, and POPC issues at 16
// per clock per SM (15.8 measured on an H100 SXM by chip_profile.py's
// popc_rate), a floor of about 8 us. On the tensor cores the same
// distances are 261 k mma.sync m16n8k32 s8 instructions at [2040 x 2040]
// (csrc/hamming_mma.cuh: d = (256 - a.b) / 2 with a, b in {-1, +1}^256),
// with the unpacking of packed keys into fragments as the only extra
// CUDA-core work; the write is what is left to wait for.
//
// Design. A block of 4 warps owns a 64-row x 64-column output tile. It
// stages the tile's 64 query rows and 64 keys packed in shared memory
// (one 16-byte cp.async per thread each, zero-filled past the edges).
// Each warp owns 32 rows x 32 columns: its rows are unpacked once into
// A fragments, and each of its four n8 key tiles is unpacked into B
// fragments right before its 16 mmas. The epilogue turns each s32 dot
// into its exact float32 distance with one IADD and one FFMA (the float
// with bit pattern 0x4B400000 + acc is 1.5 * 2^23 + acc), stages the
// tile in shared memory, and writes it as rows of 16-byte stores:
// 256 contiguous bytes per 16 threads, when M % 4 == 0 (the f32 row
// strides on the paths, 8160 and 6000 bytes, are multiples of 16);
// otherwise scalar stores (the VEC template argument). Ragged edges are
// masked; the kernel allocates nothing and does not synchronise.

#include "hamming_mma.cuh"

namespace {

using namespace hamming_mma;

constexpr int THREADS = 128;             // 4 warps
constexpr int TILE_M = 64;               // query rows per block
constexpr int TILE_N = 64;               // keys per block
constexpr int WARP_N = TILE_N / 2;       // each warp: 32 rows x WARP_N keys
constexpr int OUT_STRIDE = TILE_N + 8;   // floats; conflict-free float2 writes
constexpr int ROW_THREADS = TILE_N / 4;  // threads storing one row, 16 B each

// exact distance (256 - acc) / 2 as float32, for |acc| <= 256
__device__ __forceinline__ float distance(int32_t acc) {
  return fmaf(__int_as_float(0x4B400000 + acc), -0.5f, 6291584.0f);
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
hamming_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
               float* __restrict__ out, int n, int m) {
  __shared__ __align__(16) uint32_t rows_s[TILE_M][8];
  __shared__ __align__(16) uint32_t keys_s[TILE_N][8];
  __shared__ __align__(16) float out_s[TILE_M][OUT_STRIDE];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int col0 = blockIdx.x * TILE_N;
  const int row0 = blockIdx.y * TILE_M;

  {
    const int r = tid >> 1;
    const int h = (tid & 1) * 4;
    const bool row_ok = row0 + r < n;
    cp_async16(&rows_s[r][h], row_ok ? a + (size_t)(row0 + r) * 8 + h : a,
               row_ok);
#pragma unroll
    for (int k = r; k < TILE_N; k += THREADS / 2) {
      const bool key_ok = col0 + k < m;
      cp_async16(&keys_s[k][h], key_ok ? b + (size_t)(col0 + k) * 8 + h : b,
                 key_ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();

  const int wr = (warp & 1) * 32;   // the warp's rows and columns in the tile
  const int wc = (warp >> 1) * WARP_N;
  QueryTiles<2> q;
  q.load([&](int r) -> const uint32_t* { return rows_s[wr + r]; }, lane);

#pragma unroll
  for (int u = 0; u < WARP_N / 8; u += 2) {   // two n8 tiles: four mma chains
    uint32_t kw[2][8];
    load_key(kw[0], keys_s[wc + 8 * u + g]);
    load_key(kw[1], keys_s[wc + 8 * (u + 1) + g]);
    int32_t acc[2][2][4];
    q.dot<2>(acc, kw, t);
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(&out_s[wr + 16 * r + 8 * h + g]
                                           [wc + 8 * (u + k) + 2 * t]) =
              make_float2(distance(acc[k][r][2 * h]),
                          distance(acc[k][r][2 * h + 1]));
  }
  __syncthreads();

  const int c4 = (tid % ROW_THREADS) * 4;
  const int col = col0 + c4;
#pragma unroll
  for (int i = 0; i < TILE_M * ROW_THREADS / THREADS; ++i) {
    const int r = tid / ROW_THREADS + THREADS / ROW_THREADS * i;
    const int row = row0 + r;
    if (row >= n || col >= m) continue;
    float* dst = out + (size_t)row * (size_t)m + col;
    const float4 v = *reinterpret_cast<const float4*>(&out_s[r][c4]);
    if (VEC) {
      *reinterpret_cast<float4*>(dst) = v;   // M % 4 == 0: col + 4 <= m
    } else {
      const float d[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (col + c < m) dst[c] = d[c];
    }
  }
}

}  // namespace

// Plain C entry for ctypes. Pointers are device pointers (a [n, 8] and
// b [m, 8] uint32, out [n, m] float32, all 16-byte aligned); `stream` is
// a cudaStream_t. Returns cudaGetLastError() after the launch (0 = ok).
extern "C" int hamming_launch(const void* a, const void* b, void* out, int n,
                              int m, void* stream) {
  if (n <= 0 || m <= 0) return (int)cudaSuccess;
  const dim3 grid((m + TILE_N - 1) / TILE_N, (n + TILE_M - 1) / TILE_M);
  if (m % 4 == 0)
    hamming_kernel<true><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (float*)out, n, m);
  else
    hamming_kernel<false><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (float*)out, n, m);
  return (int)cudaGetLastError();
}
