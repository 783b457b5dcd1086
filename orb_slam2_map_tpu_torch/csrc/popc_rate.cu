// Microbenchmark, on no path of the port: the issue rate of __popc (POPC)
// on this card, which bounds csrc/hamming.cu (8 POPC per descriptor
// pair). Every thread runs 8 independent chains of
//   acc[k] += __popc(a[k] ^ i)
// so each POPC comes with one LOP3 and one IADD, both of which issue at
// 4x the POPC rate of the CUDA C++ Programming Guide's table (64 against
// 16 per clock per SM on compute capability 9.0): the loop is POPC-bound
// if the table is right. chip_profile.py times it and divides.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHAINS = 8;

__global__ void __launch_bounds__(THREADS)
popc_rate_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                 int iters) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  uint32_t a[CHAINS], acc[CHAINS];
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) {
    a[k] = in[(t * CHAINS + k) & 1023];
    acc[k] = 0u;
  }
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < CHAINS; ++k) acc[k] += __popc(a[k] ^ (uint32_t)i);
  }
  uint32_t s = 0u;
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) s += acc[k];
  out[t] = s;
}

}  // namespace

// in: 1024 uint32 words; out: blocks * 256 uint32. Returns
// cudaGetLastError() after the launch (0 = ok).
extern "C" int popc_rate_launch(const void* in, void* out, int blocks,
                                int iters, void* stream) {
  popc_rate_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, iters);
  return (int)cudaGetLastError();
}
