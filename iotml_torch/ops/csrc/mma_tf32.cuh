// Split-TF32 ("3xTF32") building blocks for the float32 flash kernels at
// D = 8 and 16, forward and backward (namespace tf32x3 of
// flash_attention.cu and of flash_attention_bwd.cu): the tf32 rounding,
// the hi/lo split, the m16n8k8 tf32 mma.sync and the three-term product;
// the cp.async copies that stream two [kStep][D] tiles into a raw stage
// and their split into the two shared-memory layouts the B fragments read
// (Stream); the A fragments of a warp's held rows, a C fragment as the
// next A fragment, and the store of accumulator rows.
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

// ------------------------------------------------ streamed tiles, split
// Each streamed [kStep][D] tile is split once into hi and lo and stored
// in shared memory as float4s that one 128-bit load brings in whole (b0
// and b1, hi and lo), in one or both of the orders the B fragments read:
// - by row, "layout A" (products summing over d: S = Q K^T, dP): float4
//   (r, s) of row r holds d = 8 (s / 4) + s % 4 and that d + 4, hi then
//   lo;
// - by row pair, "layout B" (products summing over the rows: P V, dV, dK,
//   dQ): float4 (p, n) holds rows 2p and 2p + 1 of column n, hi then lo.
// Within a row (A) or row pair (B) the float4s are permuted (layout_a,
// layout_b) so that a warp's fragment reads and the split's stores each
// fall on distinct banks.
//
// float4 offsets of the two layouts within one tile's layout block.  A
// 128-byte row of 8 float4s (D = 16) is one pass over the 32 banks.
// Layout A: a read takes rows g (lane / 4) by slot t (lane % 4), a split
// store rows 2p + h by slot 4 cg + t (lanes (p, cg)); slot s ^ f(r) with
// f(r) = (r / 2) % 4 + 4 (r % 2) keeps 8 lanes on 8 float4s in both.  At
// D = 8 two rows make 128 bytes and the reads need no permutation.
template <int D>
__device__ __forceinline__ int layout_a(int r, int s) {
  return r * (D / 2) +
         (D == 16 ? s ^ (((r >> 1) & 3) | ((r & 1) << 2)) : s);
}
// Layout B: a read takes row pair 4j + t by column 8 nn + g, a split
// store row pairs p by columns 8 cg + i; column n ^ (2 (p % 4) ^ n / 8)
// keeps both on distinct float4s.
template <int D>
__device__ __forceinline__ int layout_b(int p, int n) {
  return p * D + (n ^ ((2 * (p & 3)) ^ ((n >> 3) & 1)));
}

// The B fragment at float4 `at` of a layout
__device__ __forceinline__ BFrag frag_at(const float* layout, int at) {
  const uint4 f = reinterpret_cast<const uint4*>(layout)[at];
  return {f.x, f.y, f.z, f.w};
}

// Two [T][D] tensors a and b streamed kStep rows a step by kThreads
// threads.  The raw stage holds the step's two tiles as copied; a split
// buffer holds the layouts the flags name (kA0, kB0: tile a's layouts A
// and B; kA1, kB1: tile b's), one kLayout block each, in the order
// [a: A, B][b: A, B] with the absent ones left out.  A thread's unit of
// copy and split is rows 2p, 2p + 1 by 8 columns of one tile; the raw
// stage is unit-major (chunk c of unit u at float4 c * kUnits + u), so the
// split's reads are conflict-free too.  A thread splits only the units it
// copied, so no barrier stands between its copies landing and its split.
template <int D, int kStep, int kThreads, bool kA0, bool kB0, bool kA1,
          bool kB1>
struct Stream {
  static constexpr int kRaw = 2 * kStep * D;     // floats of the raw stage
  static constexpr int kLayout = 2 * kStep * D;  // one tile, hi and lo
  static constexpr int kLayouts = kA0 + kB0 + kA1 + kB1;
  static constexpr int kBuf = kLayouts * kLayout;  // floats of the layouts
  static constexpr int kUnitsPerTile = kStep / 2 * D / 8;
  static constexpr int kUnits = 2 * kUnitsPerTile;

  // This thread's units of rows [r0, r0 + kStep) of a and b into the raw
  // stage by cp.async: 16-byte chunks, zeros past T; nothing when !any.
  // Not committed.
  static __device__ __forceinline__ void load(uint32_t raw, const float* a,
                                              const float* b, int r0, int T,
                                              bool any) {
    for (int u = threadIdx.x; any && u < kUnits; u += kThreads) {
      const int tensor = u / kUnitsPerTile, w = u % kUnitsPerTile;
      const int p = w / (D / 8), c8 = 8 * (w % (D / 8));
      const float* src = tensor ? b : a;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 2 * p + h;
        const bool in = r0 + r < T;
#pragma unroll
        for (int c = 0; c < 2; ++c)
          cp_async16(raw + 16 * ((2 * h + c) * kUnits + u),
                     src + (in ? (size_t)(r0 + r) * D + c8 + 4 * c : 0), in);
      }
    }
  }

  // This thread's units of the raw stage (landed: it copied them) split
  // into hi and lo in the layouts of split buffer `buf`.
  static __device__ __forceinline__ void split(const float* raw,
                                               float* buf) {
    for (int u = threadIdx.x; u < kUnits; u += kThreads) {
      const int tensor = u / kUnitsPerTile, w = u % kUnitsPerTile;
      const int p = w / (D / 8), cg = w % (D / 8);
      float hi[2][8], lo[2][8];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 8; c += 4) {
          float4 fh, fl;
          split4(reinterpret_cast<const float4*>(
                     raw)[(2 * h + c / 4) * kUnits + u],
                 fh, fl);
          hi[h][c] = fh.x; hi[h][c + 1] = fh.y;
          hi[h][c + 2] = fh.z; hi[h][c + 3] = fh.w;
          lo[h][c] = fl.x; lo[h][c + 1] = fl.y;
          lo[h][c + 2] = fl.z; lo[h][c + 3] = fl.w;
        }
      float4* la = reinterpret_cast<float4*>(
          buf + (tensor ? kA0 + kB0 : 0) * kLayout);
      float4* lb = la + (tensor ? kA1 : kA0) * (kLayout / 4);
      if (tensor ? kA1 : kA0)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int t = 0; t < 4; ++t)
            la[layout_a<D>(2 * p + h, 4 * cg + t)] =
                make_float4(hi[h][t], hi[h][t + 4], lo[h][t], lo[h][t + 4]);
      if (tensor ? kB1 : kB0)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          lb[layout_b<D>(p, 8 * cg + i)] =
              make_float4(hi[0][i], hi[1][i], lo[0][i], lo[1][i]);
    }
  }
};

// --------------------------------------------- fragments in registers
// The A fragments (hi, lo) of a warp's held rows: kMT m16 tiles from r0
// of a [T][8 NT] tensor, for each 8-wide slice of d; zeros past T.
template <int kMT, int NT>
__device__ __forceinline__ void held_rows(uint32_t (&hi)[kMT][NT][4],
                                          uint32_t (&lo)[kMT][NT][4],
                                          const float* src, int r0, int T) {
  constexpr int D = 8 * NT;
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int kk = 0; kk < NT; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + 16 * m + g + 8 * (e % 2);
        const int d = 8 * kk + t + 4 * (e / 2);
        split(r < T ? src[(size_t)r * D + d] : 0.f, hi[m][kk][e],
              lo[m][kk][e]);
      }
}

// A C fragment as the A fragment (hi, lo) of a product summing over its
// columns: {c0, c2, c1, c3} (see the top of this file)
__device__ __forceinline__ void as_a(const float (&c)[4], uint32_t (&hi)[4],
                                     uint32_t (&lo)[4]) {
  split(c[0], hi[0], lo[0]);
  split(c[2], hi[1], lo[1]);
  split(c[1], hi[2], lo[2]);
  split(c[3], hi[3], lo[3]);
}

// Rows [r0, r0 + 16 kMT) of a [T][8 NT] output from a warp's kMT x NT
// accumulator fragments (rows g, g + 8 of each m16 tile, columns 2t, 2t +
// 1 of each n8 tile); rows past T are not written.
template <int kMT, int NT>
__device__ __forceinline__ void store_rows(float* out,
                                           const float (&acc)[kMT][NT][4],
                                           int r0, int T) {
  constexpr int D = 8 * NT;
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 16 * m + g + 8 * h;
      if (r >= T) continue;
#pragma unroll
      for (int nn = 0; nn < NT; ++nn)
        *reinterpret_cast<float2*>(out + (size_t)r * D + 8 * nn + 2 * t) =
            make_float2(acc[m][nn][2 * h], acc[m][nn][2 * h + 1]);
    }
}

}  // namespace mma_tf32
