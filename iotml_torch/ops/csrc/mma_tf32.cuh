// Split-TF32 ("3xTF32") building blocks for the float32 flash backward
// kernels at D = 8 and 16 (flash_attention_bwd.cu, namespace tf32x3):
// the tf32 rounding, the hi/lo split, the m16n8k8 tf32 mma.sync and the
// three-term product, and the cp.async copies that stream their tiles.
//
// Why split.  A tf32 operand keeps 11 significant bits, so one product is
// off by up to ~2^-11 relative: above the f32 grads' rtol 1e-4.  With
// x = hi + lo, hi = tf32(x) and lo = tf32(x - hi) (the subtraction is
// exact), a * b = a_hi b_hi + a_hi b_lo + a_lo b_hi + a_lo b_lo, and the
// first three terms keep the product to ~2^-21 relative.  Each term is an
// exact product in the tensor core's f32 accumulation.  lo is rounded to
// tf32 too: the mma reads only an operand's top 19 bits and would
// truncate it otherwise.
//
// The rounding is cvt.rn.tf32.f32 (nearest, ties to even), one F2FP
// instruction on sm_90; cvt.rna.tf32.f32 (ties away from zero) has no
// instruction there and ptxas builds it from four (add, compare, select,
// mask): 9.1 against 7.8 ms for the dK/dV kernel at the SensorFormer layer
// (scripts/bwd_tf32_variants.py, PERF.md).  The two differ only on exact
// ties.
//
// m16n8k8 fragments (g = lane / 4, t = lane % 4), the PTX ISA's layout:
// - A [16 x 8], row-major: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//   a3 (g + 8, t + 4);
// - B [8 x 8] (k x n): b0 (t, g), b1 (t + 4, g);
// - C/D [16 x 8]: c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//   c3 (g + 8, 2t + 1).
// A C fragment becomes the A fragment of a product that sums over its
// columns with no shuffle: k slot t holds column 2t and slot t + 4 column
// 2t + 1 (a = {c0, c2, c1, c3}), and the B operand's rows are read in the
// same order (b0 row 2t, b1 row 2t + 1).  A sum does not depend on the
// order of its index.
//
// No PyTorch headers: the file builds with plain nvcc in seconds.

#pragma once

#include <cstdint>

namespace mma_tf32 {

// cvt.rn.tf32.f32: nearest, ties to even, low 13 bits cleared
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rn.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both tf32 (as raw bits)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// the split of four values, as float bits
__device__ __forceinline__ void split4(float4 x, float4& hi, float4& lo) {
  uint32_t h, l;
  split(x.x, h, l); hi.x = __uint_as_float(h); lo.x = __uint_as_float(l);
  split(x.y, h, l); hi.y = __uint_as_float(h); lo.y = __uint_as_float(l);
  split(x.z, h, l); hi.z = __uint_as_float(h); lo.z = __uint_as_float(l);
  split(x.w, h, l); hi.w = __uint_as_float(h); lo.w = __uint_as_float(l);
}

// d[16 x 8] += a[16 x 8] b[8 x 8], tf32 operands, f32 accumulation
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The B fragment of one product, hi and lo: b0, b1 of each
struct BFrag {
  uint32_t hi0, hi1, lo0, lo1;
};

// d += a b in three tf32 terms, the small ones first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&a_hi)[4],
                                     const uint32_t (&a_lo)[4], BFrag b) {
  mma(d, a_lo, b.hi0, b.hi1);
  mma(d, a_hi, b.lo0, b.lo1);
  mma(d, a_hi, b.hi0, b.hi1);
}

// ------------------------------------------------------------- cp.async
// 16 bytes from global to shared; zeros when !in (src is not read then)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

// 4 bytes, likewise
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N of this thread's committed groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

}  // namespace mma_tf32
