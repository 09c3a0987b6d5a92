// Float32-accurate products on Hopper's tensor cores for the float32 flash
// kernels (flash_attention_f32.cu): asynchronous copies into shared memory,
// the 3xTF32 split and mma.sync.m16n8k8 in TF32.  Inline PTX only; no
// CUTLASS.
//
// 3xTF32.  TF32 keeps 10 of float32's 23 fraction bits.  A float32 x splits
// into hi = tf32(x) and lo = tf32(x - hi), both rounded to nearest, ties
// away from zero (cvt.rna's rounding; feeding raw float32 bits to a .tf32
// operand truncates instead).  x - hi is exact, so x = hi + lo to about 2^-22
// relative, and a . b = hi.hi + hi.lo + lo.hi with the lo.lo term (2^-22)
// dropped.  Each product of two TF32 values is exact in the float32
// accumulator.  The two small products go first into the accumulator, then
// hi.hi.  That is CUTLASS's OpMultiplyAddFastF32, the arithmetic of
// PyTorch's own float32 attention on this card.
//
// Fragments of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, lane =
// 4 g + t (PTX ISA, "Matrix Fragments for mma.m16n8k8"):
//   A (16 x 8, row):  a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, col):   b0 (k = t, n = g), b1 (k = t + 4, n = g)
//   C (16 x 8):       c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)

#pragma once

#include <stdint.h>

namespace tf32 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, of which the first `src_bytes`
// (0 to 16) are read and the rest written as zeros.  Both addresses
// 16-byte aligned.  Bypasses L1 (.cg).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes, read when src_bytes is 4 and written as zero when it is 0.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds a finite x: to nearest,
// ties away from zero (half an ulp of TF32 added to the magnitude, the low
// 13 bits cleared), in two integer operations, which issue at 64 a clock
// on an SM where the conversion issues at 16.
__device__ __forceinline__ uint32_t round_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// A float32 value as hi + lo, both TF32 (see above).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = round_tf32(x);
  lo = round_tf32(x - __uint_as_float(hi));
}

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// d (16 x 8) += a (16 x 8) . b (8 x 8), one TF32 product.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a . b to float32 accuracy: lo.hi and hi.lo, then hi.hi.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
  mma(d, a.lo, b.hi);
  mma(d, a.hi, b.lo);
  mma(d, a.hi, b.hi);
}

// The same product into two accumulators, big += hi.hi and small += lo.hi
// + hi.lo (their sum is a . b): two dependency chains, and the big one
// takes one tensor-core addition a step where mma3 takes three.  The
// tensor cores add with truncation, so a long chain of additions into one
// accumulator drifts toward zero by up to an ulp each; small's drift is
// 2^-11 of big's.
__device__ __forceinline__ void mma3(float (&big)[4], float (&small)[4], const FragA& a,
                                     const FragB& b) {
  mma(small, a.lo, b.hi);
  mma(small, a.hi, b.lo);
  mma(big, a.hi, b.hi);
}

// A: rows r0 + g, r0 + g + 8 and columns c0 + t, c0 + t + 4 of a row-major
// float32 tile of row stride LD.
template <int LD>
__device__ __forceinline__ void load_a(FragA& a, const float* tile, int r0, int c0, int g,
                                       int t) {
  const float* p = tile + (r0 + g) * LD + c0 + t;
  split(p[0], a.hi[0], a.lo[0]);
  split(p[8 * LD], a.hi[1], a.lo[1]);
  split(p[4], a.hi[2], a.lo[2]);
  split(p[8 * LD + 4], a.hi[3], a.lo[3]);
}

// B of a product that reduces along a tile's rows (the "K-major" operand,
// K of Q.K^T): n = tile row n0 + g, k = columns c0 + t and c0 + t + 4.
template <int LD>
__device__ __forceinline__ void load_b_rows(FragB& b, const float* tile, int n0, int c0,
                                            int g, int t) {
  const float* p = tile + (n0 + g) * LD + c0 + t;
  split(p[0], b.hi[0], b.lo[0]);
  split(p[4], b.hi[1], b.lo[1]);
}

// B of a product that reduces down a tile's columns (V of P.V), its k
// index in a score accumulator's order (acc_as_a): k = t is tile row
// r0 + 2t, k = t + 4 is row r0 + 2t + 1; n = column c0 + g.
template <int LD>
__device__ __forceinline__ void load_b_cols(FragB& b, const float* tile, int r0, int c0,
                                            int g, int t) {
  const float* p = tile + (r0 + 2 * t) * LD + c0 + g;
  split(p[0], b.hi[0], b.lo[0]);
  split(p[LD], b.hi[1], b.lo[1]);
}

// A from the accumulator of a 16 x 8 score tile, no shuffle: the lane holds
// columns 2t and 2t + 1, which A wants at k = t and t + 4.  A sum over k
// does not care about the order, so c0, c2 serve as k = t and c1, c3 as
// k = t + 4, and load_b_cols reads B's rows in the same order.
__device__ __forceinline__ void acc_as_a(FragA& a, const float (&c)[4]) {
  split(c[0], a.hi[0], a.lo[0]);
  split(c[2], a.hi[1], a.lo[1]);
  split(c[1], a.hi[2], a.lo[2]);
  split(c[3], a.hi[3], a.lo[3]);
}

}  // namespace tf32
