// All-pairs Hamming distance matrix for NVIDIA Hopper (sm_90a).
//
// Replaces orb_slam2_map_tpu/ops/pallas_kernels.py:hamming_matrix_pallas
// (kernel body _hamming_kernel), whose consumer is the stereo matcher
// (ops/stereo.py: one [N x N] matrix per stereo frame, N = 2040 at the
// KITTI settings).
//
//   out[i, j] = popcount(A[i] ^ B[j])   (float32, A [N, 8], B [M, 8]
//                                        packed 256-bit descriptors)
//
// What bounds it on this card. At [2040 x 2040] the float32 output alone
// is 16.6 MB: 5.0 us at 3.35 TB/s (the inputs are 130 KB). Counted as a
// +-1 int8 product it is 2.13 GOP, 1.1 us at 1,979 TOP/s. So the least
// time is set by the bytes: the output write. A CUDA-core kernel is held
// first by the popcount issue rate: 8 __popc per pair is 33.3 M popcounts,
// and POPC issues at 16 per clock per SM on compute capability 9.0 (the
// CUDA C++ Programming Guide's arithmetic-instruction throughput table;
// csrc/popc_rate.cu, run by chip_profile.py, reads 15.8 on an H100 SXM),
// 132 SMs x 16 x 1.98 GHz = 4.2 T/s, about 8 us. The XORs (LOP3) and
// adds issue at 64 per clock per SM and hide behind it; the int->float
// conversion (16 per clock, like POPC) is replaced by an exact OR + FADD
// with the 2^23 magic constant.
//
// Design. Nothing of the Pallas kernel's 256 x 256 VMEM tile or its SWAR
// shifts is kept: __popc on the uint32 XOR is one instruction, and the
// int32 view the wrapper passes is read as uint32 (an arithmetic >> on
// int32 is what breaks SWAR on words with the top bit set). A block of
// 256 threads (32 x 8) owns a 64-row x 128-column output tile. It stages
// the tile's 128 keys word-major in shared memory ([8][128], one
// coalesced 16-byte load per thread from the contiguous 4 KB of B) and
// its 64 query rows ([64][8]). Each thread keeps 4 consecutive keys in
// registers and walks 8 rows; a warp shares its rows (shared-memory
// broadcast) and writes 32 x 16 bytes = 512 contiguous bytes of a row
// per store: float4 stores, 16-byte aligned when M % 4 == 0, scalar
// stores otherwise (the VEC template argument). Ragged edges are masked;
// the kernel allocates nothing and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 32;                 // threads across columns
constexpr int TY = 8;                  // threads across rows
constexpr int THREADS = TX * TY;
constexpr int COLS_PER_THREAD = 4;
constexpr int ROWS_PER_THREAD = 8;
constexpr int TILE_N = TX * COLS_PER_THREAD;   // 128 keys
constexpr int TILE_M = TY * ROWS_PER_THREAD;   // 64 query rows

// exact int -> float for 0 <= d < 2^23: the float with bit pattern
// 0x4B000000 | d is 2^23 + d
__device__ __forceinline__ float to_float(uint32_t d) {
  return __uint_as_float(0x4B000000u | d) - 8388608.0f;
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
hamming_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
               float* __restrict__ out, int n, int m) {
  __shared__ __align__(16) uint32_t keys[8][TILE_N];
  __shared__ __align__(16) uint32_t rows[TILE_M][8];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int col0 = blockIdx.x * TILE_N;
  const int row0 = blockIdx.y * TILE_M;

  // keys: thread tid loads words 4h..4h+3 of key k = tid / 2 (h = tid % 2)
  {
    const int k = tid >> 1;
    const int h = tid & 1;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (col0 + k < m)
      v = reinterpret_cast<const uint4*>(b + (size_t)(col0 + k) * 8)[h];
    keys[4 * h + 0][k] = v.x;
    keys[4 * h + 1][k] = v.y;
    keys[4 * h + 2][k] = v.z;
    keys[4 * h + 3][k] = v.w;
  }
  // query rows: threads 0..127 load one 16-byte half-row each
  if (tid < TILE_M * 2) {
    const int r = tid >> 1;
    const int h = tid & 1;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n)
      v = reinterpret_cast<const uint4*>(a + (size_t)(row0 + r) * 8)[h];
    reinterpret_cast<uint4*>(&rows[r][0])[h] = v;
  }
  __syncthreads();

  uint32_t kw[8][COLS_PER_THREAD];
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    const uint4 v = reinterpret_cast<const uint4*>(&keys[w][0])[tx];
    kw[w][0] = v.x;
    kw[w][1] = v.y;
    kw[w][2] = v.z;
    kw[w][3] = v.w;
  }

  const int col = col0 + tx * COLS_PER_THREAD;
#pragma unroll 2
  for (int i = 0; i < ROWS_PER_THREAD; ++i) {
    const int r = ty * ROWS_PER_THREAD + i;
    const int row = row0 + r;
    const uint4 q0 = reinterpret_cast<const uint4*>(&rows[r][0])[0];
    const uint4 q1 = reinterpret_cast<const uint4*>(&rows[r][0])[1];
    const uint32_t q[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
    float d[COLS_PER_THREAD];
#pragma unroll
    for (int c = 0; c < COLS_PER_THREAD; ++c) {
      uint32_t s = 0;
#pragma unroll
      for (int w = 0; w < 8; ++w) s += __popc(q[w] ^ kw[w][c]);
      d[c] = to_float(s);
    }
    if (row >= n) continue;
    float* dst = out + (size_t)row * (size_t)m + col;
    if (VEC && col + COLS_PER_THREAD <= m) {
      *reinterpret_cast<float4*>(dst) = make_float4(d[0], d[1], d[2], d[3]);
    } else {
#pragma unroll
      for (int c = 0; c < COLS_PER_THREAD; ++c)
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
  const dim3 block(TX, TY);
  if (m % 4 == 0)
    hamming_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (float*)out, n, m);
  else
    hamming_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (float*)out, n, m);
  return (int)cudaGetLastError();
}
