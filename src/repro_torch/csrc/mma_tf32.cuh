// Shared pieces of the kernels that take fp32 products on Hopper's tf32
// tensor cores (wkv.cu, flash_attention.cu): the operand split that keeps
// an fp32 product's accuracy in three tf32 products, the m16n8k8 MMA, and
// the 16- and 8-byte cp.async copies that stage tiles ahead of use.
//
// Fragment layout of mma.sync.aligned.m16n8k8 (tf32 operands, fp32
// accumulators), lane (g, q) = (lane / 4, lane % 4):
//   A (16 x 8, row-major):  a0 = A[g][q], a1 = A[g + 8][q],
//                           a2 = A[g][q + 4], a3 = A[g + 8][q + 4];
//   B (8 x 8, column):      b0 = B[q][g], b1 = B[q + 4][g];
//   C (16 x 8):             c0 = C[g][2 q], c1 = C[g][2 q + 1],
//                           c2 = C[g + 8][2 q], c3 = C[g + 8][2 q + 1].
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// x = hi + lo: hi is x rounded to tf32 (10 explicit mantissa bits) by
// its bit pattern, lo the exact fp32 remainder, whose top 19 bits the
// tensor cores read. Three tf32 products (hi hi, hi lo, lo hi) keep an
// fp32 product's accuracy (the rest is below 2^-21 of it). Integer and
// fp32 adds only: cvt.rna.tf32 runs at a quarter of their rate.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += A B, one m16n8k8 tf32 product
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = A B, one m16n8k8 tf32 product into fresh accumulators (C = 0)
__device__ __forceinline__ void mma_tf32_new(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f));
}

// A B for an A fragment given as (hi, lo) and B as two floats: the large
// product into `big`, the two small ones into `small` (two accumulators,
// so that the chains run side by side; the caller adds them in a fixed
// order)
__device__ __forceinline__ void mma3(float (&big)[4], float (&small)[4],
                                     const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4], float b0,
                                     float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma_tf32(small, alo, bh0, bh1);
  mma_tf32(small, ahi, bl0, bl1);
  mma_tf32(big, ahi, bh0, bh1);
}

// cp.async: 16 bytes (through L2 only) or 8 bytes from global to shared
// memory; with `valid` false nothing is read and the bytes are zeroed
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 8 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most `n` of this thread's committed groups are in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait<0>(); }

}  // namespace repro
