// Tile helpers shared by the flash-attention forward and backward
// tensor-core kernels (bf16, D = 128), on hopper.cuh's building blocks:
// the design rules of both directions, tile sizes, TMA row loads, the two
// wgmma products (scores S = A B^T and accumulate acc += A B) and the
// accumulator's element-to-(row, column) map.
//
// No PyTorch headers: the file builds with plain nvcc in seconds.

#pragma once

#include <cstdint>

#include "hopper.cuh"

namespace flash_tiles {

// The design rules, one for each direction, on one set of codes;
// iotml_torch/ops/attention.py::flash_design states the same rules, and
// FLASH_DESIGNS there names the codes in this order.
enum Design : int { kFma = 0, kWgmma = 1, kMmaTf32x3 = 2 };

// Forward: dtype 1 (bfloat16) at D = 128 takes the tensor-core (wgmma)
// kernel, dtype 0 (float32) at D = 8 and 16 the split-TF32 mma.sync
// kernel, every other (dtype, d) the FMA one.
__host__ __device__ constexpr int fwd_design(int dtype, int d) {
  return dtype == 1 && d == 128 ? kWgmma
         : dtype == 0 && (d == 8 || d == 16) ? kMmaTf32x3
         : kFma;
}

// Backward: the forward's designs at the same (dtype, d): the wgmma
// kernels, the split-TF32 ones, the FMA ones.
__host__ __device__ constexpr int bwd_design(int dtype, int d) {
  return fwd_design(dtype, d);
}

constexpr int kD = 128;
constexpr uint32_t kRow = 128;  // bytes of one swizzled row: 64 bf16

// bytes of a [rows][128] bf16 tile, held as two [rows][64] chunks
__host__ __device__ constexpr uint32_t tile_bytes(int rows) {
  return rows * kD * 2;
}

// rows [row0, row0 + rows) of head bh: both 64-column chunks by TMA
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap* map,
                                          int rows, int row0, int bh,
                                          uint32_t bar) {
  hopper::tma_load_3d(dst, map, 0, row0, bh, bar);
  hopper::tma_load_3d(dst + rows * kRow, map, 64, row0, bh, bar);
}

// 8 k16 slices over d: acc = A[64 rows] B[n rows]^T, A and B K-major
// tiles of a_rows / b_rows rows (a_at / b_at: the first row used)
template <int kARows, int kBRows>
__device__ __forceinline__ void scores(float (&acc)[32], uint32_t a_at,
                                       uint32_t b_at) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint32_t a = a_at + (kk / 4) * kARows * kRow + (kk % 4) * 32;
    const uint32_t b = b_at + (kk / 4) * kBRows * kRow + (kk % 4) * 32;
    hopper::wgmma_m64n64k16_ss(acc, hopper::sw128_desc(a, 0, 1024),
                               hopper::sw128_desc(b, 0, 1024), kk);
  }
}

// 4 k16 slices over a tile's 64 rows: acc += A B, A the four bf16
// fragments, B the tile (of kRows rows) read MN-major
template <int kRows>
__device__ __forceinline__ void accumulate(float (&acc)[64],
                                           const uint32_t (&a)[4][4],
                                           uint32_t tile) {
#pragma unroll
  for (int t = 0; t < 4; ++t)
    hopper::wgmma_m64n128k16_rs(
        acc, a[t], hopper::sw128_desc(tile + t * 16 * kRow, kRows * kRow,
                                      1024));
}

// Element e of a [64 x 64] (or [64 x 128]) accumulator: row 16 * warp +
// lane / 4 + acc_row(e), column 8 * (e / 4) + 2 * (lane % 4) + (e % 2).
__device__ __forceinline__ constexpr int acc_row(int e) {
  return 8 * ((e / 2) % 2);
}
__device__ __forceinline__ constexpr int acc_col(int e) {
  return 8 * (e / 4) + (e % 2);
}

// TMA reads 16-byte aligned tensors only
inline bool misaligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 != 0;
}

}  // namespace flash_tiles
