// Shared tensor-core tile of the two Hamming kernels (csrc/gated_nn.cu,
// csrc/hamming.cu) for NVIDIA Hopper (sm_90a).
//
// The Hamming distance of two packed 256-bit descriptors is a +-1 dot
// product:  d(a, b) = (256 - a.b) / 2  with a, b in {-1, +1}^256. It is
// computed with mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 (8
// k-steps of 32 bits cover one descriptor), exact in the s32
// accumulator; d is an integer <= 256, so every float32 output is exact.
//
// Only packed bytes cross memory. A warp unpacks its query rows into A
// fragments once and keeps them in registers for the whole key loop
// (32 registers per m16 tile); keys stay packed (32 B each) and each
// B fragment is unpacked in registers right before its mma. The +-1
// int8 form is never written to memory.
//
// Bit order. m16n8k32 gives thread t of a quad (t = lane % 4) the k
// indices 4t..4t+3 and 16+4t..16+4t+3 of a k-step, in its A and in its
// B fragment alike. K-step s takes word s of the descriptor, and thread
// t maps
//   k = 4t + i       <- bit t + 8i      of word s   (i = 0..3)
//   k = 16 + 4t + i  <- bit t + 4 + 8i  of word s
// so the four threads of a quad cover the 32 bits of a word exactly
// once, and A and B use the same map, which is all a dot product asks
// for. This is NOT ops/orb.py:unpack_bits's order: nothing outside
// these two kernels sees the unpacked form.
//
// Unpacking one fragment register: (w >> shift) & 0x01010101 puts four
// bits at the bottom of four bytes; y * 0xFE + 0x01010101 turns each
// byte into 0xFF (-1, bit set) or 0x01 (+1, bit clear), without carries.
// Two integer instructions and a shift per register.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hamming_mma {

constexpr uint32_t LOW_BITS = 0x01010101u;

// four bits (at bits 0, 8, 16, 24 of w >> shift) -> four +-1 int8
__device__ __forceinline__ uint32_t pm1(uint32_t w, int shift) {
  return ((w >> shift) & LOW_BITS) * 0xFEu + LOW_BITS;
}

// d += a . b over one k-step of 32 int8 values (m16n8k32, s32 accumulate)
__device__ __forceinline__ void mma_s8(int32_t (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the 8 packed words of a descriptor, 16-byte aligned (shared or global)
__device__ __forceinline__ void load_key(uint32_t (&kw)[8], const uint32_t* p) {
  const uint4 lo = reinterpret_cast<const uint4*>(p)[0];
  const uint4 hi = reinterpret_cast<const uint4*>(p)[1];
  kw[0] = lo.x; kw[1] = lo.y; kw[2] = lo.z; kw[3] = lo.w;
  kw[4] = hi.x; kw[5] = hi.y; kw[6] = hi.z; kw[7] = hi.w;
}

// A fragments of R m16 tiles of query rows: a[r][s] is k-step s of rows
// 16r + g and 16r + g + 8 (g = lane / 4). `words(row)` returns a pointer
// to the row's 8 packed words (16-byte aligned), or nullptr for a row
// past the end (unpacked as zeros: any distance, never read back).
template <int R>
struct QueryTiles {
  uint32_t a[R][8][4];

  template <typename RowWords>
  __device__ __forceinline__ void load(RowWords words, int lane) {
    const int g = lane >> 2;
    const int t = lane & 3;
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t* p = words(16 * r + g + 8 * h);
        uint32_t w[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
        if (p != nullptr) load_key(w, p);
#pragma unroll
        for (int s = 0; s < 8; ++s) {
          a[r][s][h] = pm1(w[s], t);          // k = 4t .. 4t+3
          a[r][s][2 + h] = pm1(w[s], t + 4);  // k = 16+4t .. 16+4t+3
        }
      }
    }
  }

  // acc[k][r] = a . b for T keys, key k's 8 packed words in kw[k] (this
  // thread's key: column g of n8 tile k), starting from zero. The T * R
  // accumulator chains are independent, so their mmas overlap.
  template <int T>
  __device__ __forceinline__ void dot(int32_t (&acc)[T][R][4],
                                      const uint32_t (&kw)[T][8], int t) const {
#pragma unroll
    for (int k = 0; k < T; ++k)
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[k][r][c] = 0;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
#pragma unroll
      for (int k = 0; k < T; ++k) {
        const uint32_t b0 = pm1(kw[k][s], t);
        const uint32_t b1 = pm1(kw[k][s], t + 4);
#pragma unroll
        for (int r = 0; r < R; ++r) mma_s8(acc[k][r], a[r][s], b0, b1);
      }
    }
  }
};

// The accumulator layout of m16n8k32 (s32): acc[k][r][0], acc[k][r][1]
// are row 16r + g, columns 2t and 2t + 1 of n8 tile k; acc[k][r][2],
// acc[k][r][3] row 16r + g + 8, the same columns.

// 16 bytes, global -> shared, zero-filled when !valid (cp.async.cg)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(valid ? 16 : 0) : "memory");
}

// 8 bytes, global -> shared, zero-filled when !valid (cp.async.ca)
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem,
                                          bool valid) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(valid ? 8 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

}  // namespace hamming_mma
