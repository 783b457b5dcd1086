// Microbenchmark, on no path of the port: the issue rate of
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 on this card, the
// instruction that carries csrc/gated_nn.cu and csrc/hamming.cu (8 per
// m16 x n8 tile of descriptor pairs, csrc/hamming_mma.cuh). Every warp
// runs 8 independent accumulator chains of the same +-1 fragments, so
// the loop is bound by the tensor cores' rate for this shape and type,
// not by their latency. chip_profile.py times it and divides: mma per
// clock per SM, and int8 TOP/s at 2 x 16 x 8 x 32 operations each.

#include "hamming_mma.cuh"

namespace {

using namespace hamming_mma;

constexpr int THREADS = 256;
constexpr int CHAINS = 8;

__global__ void __launch_bounds__(THREADS)
mma_rate_kernel(const uint32_t* __restrict__ in, int32_t* __restrict__ out,
                int iters) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  uint32_t a[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) a[k] = pm1(in[(t * 4 + k) & 1023], 0);
  const uint32_t b0 = pm1(in[(t * 2 + 7) & 1023], 1);
  const uint32_t b1 = pm1(in[(t * 2 + 8) & 1023], 2);
  int32_t acc[CHAINS][4];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[c][k] = 0;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) mma_s8(acc[c], a, b0, b1);
  }
  int32_t s = 0;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  out[t] = s;
}

}  // namespace

// in: 1024 uint32 words; out: blocks * 256 int32. Each warp issues
// iters * 8 mma. Returns cudaGetLastError() after the launch (0 = ok).
extern "C" int mma_rate_launch(const void* in, void* out, int blocks,
                               int iters, void* stream) {
  mma_rate_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (int32_t*)out, iters);
  return (int)cudaGetLastError();
}
