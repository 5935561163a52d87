// Flash-attention backward for Hopper (sm_90a): dQ, dK and dV of
// O = softmax(Q K^T / sqrt(D)) V, causal or not, from the forward's
// per-row log-sum-exp, in two kernels.
//
// Replaces the TPU kernels iotml/ops/attention.py::_flash_bwd_dkv_kernel
// (:402, dense grid) and ::_flash_bwd_dkv_kernel_tri (:482, causal
// triangle) with flash_bwd_dkv_kernel (FMA), flash_bwd_dkv_wgmma_kernel
// (bf16 tensor cores) and flash_bwd_dkv_mma_kernel (split-TF32 tensor
// cores), and ::_flash_bwd_dq_kernel (:447) and ::_flash_bwd_dq_kernel_tri
// (:518) with flash_bwd_dq_kernel, flash_bwd_dq_wgmma_kernel and
// flash_bwd_dq_mma_kernel; each has a causal and a full entry.  It
// computes what they compute (_bwd_common, :376), with their dtype policy,
// and is not carried over block by block.  The plain PyTorch version
// beside the wrapper
// (iotml_torch/ops/attention.py::flash_attention_backward_reference)
// repeats the arithmetic.
//
// Layout: q, k, v, do, dq, dk, dv are [B*H, T, D] contiguous in the
// input dtype (float32 or bfloat16); lse (from the forward) and delta =
// rowsum(dO * O) (a plain f32 reduction in the wrapper, as in the JAX
// package) are [B*H, T] float32.
//
// What bounds it on this card.  Each live (query, key) pair costs 10*D
// flops in all (Q K^T and dO V^T, recomputed by both kernels, then P^T dO
// and dS^T Q in the dK/dV kernel and dS K in the dQ kernel: 8*D and 6*D)
// against a few loads of D values per row for the whole sequence, so at
// the shapes the port runs (SensorFormer: T = 4096, D = 16; long context:
// T = 65,536, D = 128) operations bound it, not bytes.  At the long causal
// shape (bf16, B = 1, H = 2) that is 4.295e9 live pairs: 4.447 ms for
// dK/dV and 3.335 ms for dQ at the tensor cores' 989 TFLOP/s.  In float32
// the split-TF32 products cost three tf32 products each: at the
// SensorFormer layer (B*H = 400, T = 4096, causal) 2.604 ms for dK/dV and
// 1.953 ms for dQ at 495 TFLOP/s / 3 (the fp32 FMA floor: 6.412 and 4.809).
//
// Three designs, chosen by (dtype, D) in the entry points below
// (bwd_design in flash_tiles.cuh; iotml_flash_bwd_design reports it):
// - bf16 at D = 128: the wgmma kernels (namespace tc, below);
// - float32 at D = 8, 16: the split-TF32 mma.sync kernels (namespace
//   tf32x3, below);
// - float32 at D = 128 and bf16 at D = 8, 16: the FMA kernels.
//
// The FMA kernels.  The products run as fp32 FMA on the CUDA cores
// (67 TFLOP/s on an H100 SXM).  Blocks of 128 threads (16 row groups x
// 8 lanes); every tile is staged in shared memory as float32 and each
// thread keeps a register micro-tile, so every shared-memory load feeds
// several FMAs, as in the forward.
// - dK/dV: one block owns BK key rows and loops over the q tiles itself
//   (the TPU's sequential q grid axis becomes that loop).  K and V are
//   staged once; per q tile, q, dO, lse and delta are staged, each thread
//   recomputes S^T and dP^T for its key rows x BQ/8 query columns, writes
//   P^T and dS^T (rounded to the input dtype) to shared memory, and then
//   accumulates dV += P^T dO and dK += dS^T Q for its key rows x D/8
//   columns in registers.  A causal call starts at the q tile that holds
//   key row k0 (floor(k0 / BQ) * BQ, what _causal_tiles(..., "col")
//   gives the TPU) and skips strictly-past q tiles; blocks of key tile 0,
//   the heaviest, start first.  Every key row a block owns is written,
//   rows nothing reached included (as zeros).
// - dQ: one block owns BQ query rows; q, dO, lse and delta are staged or
//   held once, and the block loops over key tiles, stopping at the
//   diagonal when causal; per key tile it recomputes S and dP, writes dS
//   (rounded) to shared memory and accumulates dQ += dS K in registers.
//   The last (heaviest causal) q tile starts first.
// At D = 128 the tiles shrink to 32 rows so that the accumulators (two
// [BK, 128] f32 tiles per block in dK/dV) stay in registers without
// spills and three blocks fit an SM's shared memory.
//
// The tensor-core kernels (bf16, D = 128) are written for Hopper, not
// carried over from the TPU's 1024^2 tiles.  What held the FMA kernels
// back at this shape, and what these do about it:
// - no tensor cores: every product is a bf16 wgmma with f32 accumulators
//   (hopper.cuh).  Each of a block's two warpgroups owns 64 rows.
//   dK/dV: a block owns 128 key rows and loops over q tiles of 64 rows;
//   S^T = K Q^T and dP^T = V dO^T read K, V and Q, dO from shared memory,
//   both K-major; dV += P^T dO and dK += dS^T Q take P^T and dS^T from
//   registers and dO, Q from the same tiles read MN-major.  dQ: a block
//   owns 128 query rows and loops over key tiles of 64; S = Q K^T and
//   dP = dO V^T from shared memory, dQ += dS K with dS from registers
//   and K read MN-major.  The f32 S/dP accumulator fragment is, pair by
//   pair, the bf16 A fragment of the next product, so P^T and dS^T never
//   touch shared memory and need no transpose.
// - bf16 staged as f32: tiles stay bf16, in the 128-byte swizzled layout
//   wgmma reads (two 64-column chunks at D = 128), with no conversion.
// - tiny tiles: 64-row warpgroup tiles, 128 rows a block; one k16 wgmma
//   replaces 64 x 16 x 16 FMAs and their shared loads.
// - synchronous loads: one thread streams the q (dK/dV) or key (dQ)
//   tiles by TMA into a ring of two stages, each with an mbarrier that
//   counts the bytes; lse and delta rows come in beside each dK/dV tile.
//   The next tile is in flight while the current one is multiplied.
//   Within a step, exp(s - lse) runs while dP's wgmma is in flight.
// - the shared-memory round trip of P^T and dS^T: gone (see above).
// What stays: two kernels and no atomics (a second launch repeats the
// first bit for bit); the causal start at floor(k0 / BQ) * BQ and the
// stop at the diagonal; the heaviest blocks first (every head's first
// key tile, or last query tile, before the next); the live-pair select
// below, applied only in steps that straddle the diagonal or the ragged
// end (TMA fills rows past T with zeros); p and ds rounded to bf16 as
// they become the A operand; ragged T and B*H up to 65,535.  The dK/dV
// warpgroup holds dK and dV (128 f32 registers a thread) plus S^T and
// dP^T (64): 256 threads a block, one block an SM.
//
// The split-TF32 kernels (float32, D = 8 and 16, the SensorFormer layer)
// replace the FMA kernels there.  What held those back, and what these do
// about it:
// - the shared-memory pipe: the FMA kernels issued about one shared load
//   for every 1.7 FMAs (S^T and dP^T tiles, and the round trip of P^T and
//   dS^T), against an SM's one warp-wide shared access a clock and four
//   warp FMAs.  Here every product is an m16n8k8 tf32 mma.sync
//   (mma_tf32.cuh), and one 128-bit shared load feeds six of them (three
//   terms, two m16 tiles).
// - TF32's 11 bits: each f32 operand is split as hi + lo, and each
//   product is a_lo b_hi + a_hi b_lo + a_hi b_hi (three mmas), which keeps
//   it to ~2^-21 relative: within the f32 grads' rtol 1e-4
//   (iotml_torch/ops/tf32x3.py models it on the CPU).  wgmma takes tf32
//   operands only K-major, and three of the products read an MN-major
//   operand, so these use mma.sync, whose fragments load in any layout.
// - the tensor cores' own f32 accumulation aligns and truncates: each
//   step's sums start at 0 in registers and are added to the running
//   sums with IEEE adds, so truncation reaches one step's sum only.
// - P^T and dS^T: they stay in registers.  The S^T / dP^T accumulator is
//   the next product's A fragment with no shuffle (mma_tf32.cuh: the
//   reduction index is read in the order the fragment holds it).
// - synchronous staging (stage(): a div/mod per element between two
//   barriers): each thread copies its share of the next step's tiles (q,
//   dO, lse, delta for dK/dV; K, V for dQ) by cp.async, 16-byte chunks,
//   into a raw stage while the current step runs, then splits its own
//   chunks (no barrier needed: it copied them) into hi and lo in one of
//   two split buffers, in the two orders the B fragments read (one
//   128-bit load brings b0, b1, hi and lo); one barrier a step.  The
//   layouts are permuted so that the fragment reads and the split's
//   stores fall on distinct banks.
// - shared-memory reads per mma: each warp holds two m16 tiles (32 rows),
//   so every B fragment it reads feeds two mmas (kMT; one tile a warp took
//   8.5 / 6.7 ms against 7.8 / 6.2 at the SensorFormer layer,
//   scripts/bwd_tf32_variants.py).
// Shape: 128 threads, four warps of 32 rows; two blocks an SM (about 240
// registers a thread in dK/dV).  dK/dV: a block holds 128 key rows (K and
// V as hi/lo A fragments in registers) and steps over q tiles of 64; dQ:
// a block holds 128 query rows (Q, dO, lse, delta in registers) and steps
// over key tiles of 64.  A warp works through a step 8 columns at a time:
// S and dP of that slice (2 x 3 x D/8 mmas a tile), p and ds, then 3 x
// D/8 mmas a tile into each sum.  What stays is listed below.
//
// Exactness, as the TPU kernels have it: scores are f32 sums of
// input-dtype products (exact in f32 for bf16), scaled after Q K^T;
// p = exp(s - lse) only where the pair is live (kj < T, qi < T and, when
// causal, qi >= kj) and 0 by a select elsewhere, never via exp of a large
// negative number, so lse = -1e30 rows are never evaluated; ds = p *
// (dp - delta) * scale; p is rounded to the input dtype before P^T dO,
// and ds before dS^T Q and dS K, with f32 accumulation; outputs in the
// input dtype.  Sums run in a fixed order and there are no atomics (hence
// two kernels), so a second launch repeats the first bit for bit.  Build
// without --use_fast_math: expf must be the accurate one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "flash_tiles.cuh"
#include "hopper.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kTY = 16;  // thread rows (row groups)
constexpr int kTX = 8;   // thread columns: lanes of one row group
constexpr int kThreads = kTY * kTX;

// dK/dV: key rows per block and query rows per step
__host__ __device__ constexpr int dkv_key_tile(int D) { return D >= 128 ? 32 : 64; }
__host__ __device__ constexpr int dkv_q_tile(int D) { return D >= 128 ? 32 : 64; }
// dQ: query rows per block and key rows per step
__host__ __device__ constexpr int dq_q_tile(int D) { return D >= 128 ? 32 : 64; }
__host__ __device__ constexpr int dq_key_tile(int D) { return D >= 128 ? 32 : 64; }

__host__ __device__ constexpr int dkv_smem_floats(int D) {
  // k, v [BK][D+1]; q, do [BQ][D+1]; p^T, ds^T [BK][BQ+1]; lse, delta [BQ].
  // The +1 pads keep the strided reads on distinct banks.
  return 2 * dkv_key_tile(D) * (D + 1) + 2 * dkv_q_tile(D) * (D + 1) +
         2 * dkv_key_tile(D) * (dkv_q_tile(D) + 1) + 2 * dkv_q_tile(D);
}

__host__ __device__ constexpr int dq_smem_floats(int D) {
  // q, do [BQ][D+1]; k, v [BK][D+1]; ds [BQ][BK+1]
  return 2 * dq_q_tile(D) * (D + 1) + 2 * dq_key_tile(D) * (D + 1) +
         dq_q_tile(D) * (dq_key_tile(D) + 1);
}

__device__ inline float to_float(float x) { return x; }
__device__ inline float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename Elt> __device__ inline Elt from_float(float x);
template <> __device__ inline float from_float<float>(float x) { return x; }
template <> __device__ inline __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to Elt and back: the rounding p and ds take before a product
template <typename Elt> __device__ inline float round_to(float x) {
  return to_float(from_float<Elt>(x));
}

// rows [r0, r0 + rows) of a [T][D] tensor into smem [rows][D+1] as f32,
// zeros past T
template <typename Elt, int D>
__device__ inline void stage(float* dst, const Elt* __restrict__ src, int r0,
                             int rows, int T) {
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    dst[r * (D + 1) + d] =
        r0 + r < T ? to_float(src[(size_t)(r0 + r) * D + d]) : 0.f;
  }
}

template <typename Elt, int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const Elt* __restrict__ q, const Elt* __restrict__ k,
                     const Elt* __restrict__ v, const Elt* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, Elt* __restrict__ dk,
                     Elt* __restrict__ dv, int T, float scale) {
  constexpr int BK = dkv_key_tile(D);
  constexpr int BQ = dkv_q_tile(D);
  constexpr int kRows = BK / kTY;  // key rows per thread
  constexpr int kCols = BQ / kTX;  // query columns per thread (S^T, dP^T)
  constexpr int kDs = D / kTX;     // dK / dV columns per thread
  static_assert(BK % kTY == 0 && BQ % kTX == 0 && D % kTX == 0, "tile shape");

  extern __shared__ float smem[];
  float* ks = smem;                   // [BK][D + 1]
  float* vs = ks + BK * (D + 1);      // [BK][D + 1]
  float* qs = vs + BK * (D + 1);      // [BQ][D + 1]
  float* dos = qs + BQ * (D + 1);     // [BQ][D + 1]
  float* pt = dos + BQ * (D + 1);     // [BK][BQ + 1]
  float* dst = pt + BK * (BQ + 1);    // [BK][BQ + 1]
  float* lse_s = dst + BK * (BQ + 1); // [BQ]
  float* delta_s = lse_s + BQ;        // [BQ]

  const int ty = threadIdx.x / kTX, tx = threadIdx.x % kTX;
  const int k0 = blockIdx.x * BK;
  const size_t base = (size_t)blockIdx.y * T * D;
  const size_t row_base = (size_t)blockIdx.y * T;

  stage<Elt, D>(ks, k + base, k0, BK, T);
  stage<Elt, D>(vs, v + base, k0, BK, T);

  float dk_acc[kRows][kDs], dv_acc[kRows][kDs];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int e = 0; e < kDs; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  // q rows [q_begin, T): a causal call starts at the tile holding row k0
  const int q_begin = kCausal ? (k0 / BQ) * BQ : 0;
  for (int q0 = q_begin; q0 < T; q0 += BQ) {
    __syncthreads();  // the last tile's q, do, p^T, ds^T are no longer read
    stage<Elt, D>(qs, q + base, q0, BQ, T);
    stage<Elt, D>(dos, dout + base, q0, BQ, T);
    for (int r = threadIdx.x; r < BQ; r += kThreads) {
      const bool in = q0 + r < T;
      lse_s[r] = in ? lse[row_base + q0 + r] : 0.f;
      delta_s[r] = in ? delta[row_base + q0 + r] : 0.f;
    }
    __syncthreads();

    // s^T = k q^T and dp^T = v do^T for this thread's kRows x kCols, d
    // ascending
    float s[kRows][kCols], dp[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[kRows], vv[kRows], qv[kCols], dov[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        kv[i] = ks[(ty * kRows + i) * (D + 1) + d];
        vv[i] = vs[(ty * kRows + i) * (D + 1) + d];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        qv[j] = qs[(tx + kTX * j) * (D + 1) + d];
        dov[j] = dos[(tx + kTX * j) * (D + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], dov[j], dp[i][j]);
        }
    }

    // p and ds, rounded to the input dtype, into shared memory
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int kj = k0 + ty * kRows + i;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tx + kTX * j;
        const int qi = q0 + c;
        const bool live = qi < T && kj < T && (!kCausal || qi >= kj);
        const float arg = live ? s[i][j] * scale - lse_s[c] : 0.f;
        const float p = live ? expf(arg) : 0.f;
        const float ds = p * (dp[i][j] - delta_s[c]) * scale;
        pt[(ty * kRows + i) * (BQ + 1) + c] = round_to<Elt>(p);
        dst[(ty * kRows + i) * (BQ + 1) + c] = round_to<Elt>(ds);
      }
    }
    __syncthreads();

    // dv += p^T do, dk += ds^T q over this tile's query rows, ascending
#pragma unroll 2
    for (int r = 0; r < BQ; ++r) {
      float pv[kRows], dsv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        pv[i] = pt[(ty * kRows + i) * (BQ + 1) + r];
        dsv[i] = dst[(ty * kRows + i) * (BQ + 1) + r];
      }
#pragma unroll
      for (int e = 0; e < kDs; ++e) {
        const float dov = dos[r * (D + 1) + tx + kTX * e];
        const float qv = qs[r * (D + 1) + tx + kTX * e];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          dv_acc[i][e] = fmaf(pv[i], dov, dv_acc[i][e]);
          dk_acc[i][e] = fmaf(dsv[i], qv, dk_acc[i][e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int kj = k0 + ty * kRows + i;
    if (kj >= T) continue;
#pragma unroll
    for (int e = 0; e < kDs; ++e) {
      dk[base + (size_t)kj * D + tx + kTX * e] = from_float<Elt>(dk_acc[i][e]);
      dv[base + (size_t)kj * D + tx + kTX * e] = from_float<Elt>(dv_acc[i][e]);
    }
  }
}

template <typename Elt, int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const Elt* __restrict__ q, const Elt* __restrict__ k,
                    const Elt* __restrict__ v, const Elt* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, Elt* __restrict__ dq,
                    int T, float scale) {
  constexpr int BQ = dq_q_tile(D);
  constexpr int BK = dq_key_tile(D);
  constexpr int kRows = BQ / kTY;  // query rows per thread
  constexpr int kCols = BK / kTX;  // key columns per thread (S, dP)
  constexpr int kDs = D / kTX;     // dQ columns per thread
  static_assert(BQ % kTY == 0 && BK % kTX == 0 && D % kTX == 0, "tile shape");

  extern __shared__ float smem[];
  float* qs = smem;                // [BQ][D + 1]
  float* dos = qs + BQ * (D + 1);  // [BQ][D + 1]
  float* ks = dos + BQ * (D + 1);  // [BK][D + 1]
  float* vs = ks + BK * (D + 1);   // [BK][D + 1]
  float* dss = vs + BK * (D + 1);  // [BQ][BK + 1]

  const int ty = threadIdx.x / kTX, tx = threadIdx.x % kTX;
  // the last query tile first: under the causal mask it has the most work
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const size_t base = (size_t)blockIdx.y * T * D;
  const size_t row_base = (size_t)blockIdx.y * T;

  stage<Elt, D>(qs, q + base, q0, BQ, T);
  stage<Elt, D>(dos, dout + base, q0, BQ, T);

  float lse_r[kRows], delta_r[kRows], acc[kRows][kDs];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty * kRows + i;
    lse_r[i] = qi < T ? lse[row_base + qi] : 0.f;
    delta_r[i] = qi < T ? delta[row_base + qi] : 0.f;
#pragma unroll
    for (int e = 0; e < kDs; ++e) acc[i][e] = 0.f;
  }

  // keys [0, kv_end): the causal entry stops at the block's last row
  const int kv_end = kCausal ? min(q0 + BQ, T) : T;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the last tile's k, v and ds are no longer read
    stage<Elt, D>(ks, k + base, k0, BK, T);
    stage<Elt, D>(vs, v + base, k0, BK, T);
    __syncthreads();

    // s = q k^T and dp = do v^T for this thread's kRows x kCols, d
    // ascending
    float s[kRows][kCols], dp[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kRows], dov[kRows], kv[kCols], vv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        qv[i] = qs[(ty * kRows + i) * (D + 1) + d];
        dov[i] = dos[(ty * kRows + i) * (D + 1) + d];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        kv[j] = ks[(tx + kTX * j) * (D + 1) + d];
        vv[j] = vs[(tx + kTX * j) * (D + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }

    // ds, rounded to the input dtype, into shared memory
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + ty * kRows + i;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tx + kTX * j;
        const int kj = k0 + c;
        const bool live = qi < T && kj < T && (!kCausal || qi >= kj);
        const float arg = live ? s[i][j] * scale - lse_r[i] : 0.f;
        const float p = live ? expf(arg) : 0.f;
        const float ds = p * (dp[i][j] - delta_r[i]) * scale;
        dss[(ty * kRows + i) * (BK + 1) + c] = round_to<Elt>(ds);
      }
    }
    __syncthreads();

    // dq += ds k over this tile's keys, ascending
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float dsv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) dsv[i] = dss[(ty * kRows + i) * (BK + 1) + c];
#pragma unroll
      for (int e = 0; e < kDs; ++e) {
        const float kv = ks[c * (D + 1) + tx + kTX * e];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][e] = fmaf(dsv[i], kv, acc[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty * kRows + i;
    if (qi >= T) continue;
#pragma unroll
    for (int e = 0; e < kDs; ++e)
      dq[base + (size_t)qi * D + tx + kTX * e] = from_float<Elt>(acc[i][e]);
  }
}

template <typename Kernel>
int configure(Kernel kernel, int smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <typename Elt, int D, bool kCausal>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int bh, int T, float scale, cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_kernel<Elt, D, kCausal>;
  const int smem = dkv_smem_floats(D) * (int)sizeof(float);
  if (int err = configure(kernel, smem)) return err;
  const dim3 grid((T + dkv_key_tile(D) - 1) / dkv_key_tile(D), bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const Elt*>(q), static_cast<const Elt*>(k),
      static_cast<const Elt*>(v), static_cast<const Elt*>(dout), lse, delta,
      static_cast<Elt*>(dk), static_cast<Elt*>(dv), T, scale);
  return (int)cudaGetLastError();
}

template <typename Elt, int D, bool kCausal>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int bh, int T,
              float scale, cudaStream_t stream) {
  auto kernel = flash_bwd_dq_kernel<Elt, D, kCausal>;
  const int smem = dq_smem_floats(D) * (int)sizeof(float);
  if (int err = configure(kernel, smem)) return err;
  const dim3 grid((T + dq_q_tile(D) - 1) / dq_q_tile(D), bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const Elt*>(q), static_cast<const Elt*>(k),
      static_cast<const Elt*>(v), static_cast<const Elt*>(dout), lse, delta,
      static_cast<Elt*>(dq), T, scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------------
// The tensor-core kernels: bf16, D = 128
// ------------------------------------------------------------------------
namespace tc {

using namespace flash_tiles;
using hopper::fence_regs;

constexpr int kThreads = 256;  // two warpgroups of 64 rows each
constexpr int kStages = 2;     // the ring of streamed tiles

// dK/dV: key rows held per block, q rows streamed per step
constexpr int kDkvBK = 128, kDkvBQ = 64;
// dQ: query rows held per block, key rows streamed per step
constexpr int kDqBQ = 128, kDqBK = 64;

// lse and delta rows come in by TMA as boxes of kStatsBox floats that
// start on the 16-byte boundary at or below the tile's first row (TMA
// refuses a box whose start is not 16-byte aligned); each lands in a
// slot of kStatsSlot bytes
constexpr int kStatsBox = kDkvBQ + 4;
constexpr uint32_t kStatsSlot = 384;
static_assert(kStatsBox * 4 <= kStatsSlot && kStatsSlot % 128 == 0,
              "stats slot");

// A block's shared memory, in bytes from its 1024-aligned start: the two
// held tiles (k, v or q, do); kStages stages of the two streamed tiles
// and, with kStats, their lse and delta slots; the barriers (held, then
// one a stage); 1024 bytes of slack to align the start.
template <int kHeld, int kStep, bool kStats>
struct Smem {
  static constexpr uint32_t kHeldB = tile_bytes(kHeld);
  static constexpr uint32_t kStage0 = 2 * tile_bytes(kHeld);
  static constexpr uint32_t kStageBytes = 2 * tile_bytes(kStep);
  static constexpr uint32_t kStats0 = kStage0 + kStages * kStageBytes;
  static constexpr uint32_t kStatsBytes = kStats ? 2 * kStatsSlot : 0;
  static constexpr uint32_t kBars = kStats0 + kStages * kStatsBytes;
  static constexpr uint32_t kBytes = kBars + 8 * (1 + kStages) + 1024;
};
using DkvSmem = Smem<kDkvBK, kDkvBQ, true>;
using DqSmem = Smem<kDqBQ, kDqBK, false>;

// One q tile of the dK/dV kernel for one warpgroup: its 64 key rows
// (from ka) against q rows [q0, q0 + 64).  kMask: the tile straddles the
// diagonal or the ragged end, so pairs are tested one by one.
template <bool kCausal, bool kMask>
__device__ __forceinline__ void dkv_step(
    float (&dk)[64], float (&dv)[64], uint32_t k_at, uint32_t v_at,
    uint32_t q_tile, uint32_t do_tile, const float* lse, const float* delta,
    int ka, int q0, int row0, int col0, int T, float scale) {
  constexpr int BK = kDkvBK, BQ = kDkvBQ;
  float st[32], dpt[32];
  __syncwarp();
  hopper::wgmma_fence();
  scores<BK, BQ>(st, k_at, q_tile);  // S^T = K Q^T
  hopper::wgmma_commit();
  scores<BK, BQ>(dpt, v_at, do_tile);  // dP^T = V dO^T
  hopper::wgmma_commit();

  // p = exp(s * scale - lse), in place, while dP^T is in flight; lse and
  // delta index the accumulator's column (the q row)
  hopper::wgmma_wait<1>();
  fence_regs(st);
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int c = col0 + acc_col(e);
    // rounded as the plain version rounds: s * scale, then - lse
    const float arg = __fmul_rn(st[e], scale) - lse[c];
    if (kMask) {
      const int qi = q0 + c, kj = ka + row0 + acc_row(e);
      const bool live = qi < T && kj < T && (!kCausal || qi >= kj);
      st[e] = live ? expf(live ? arg : 0.f) : 0.f;
    } else {
      st[e] = expf(arg);
    }
  }

  // ds = p (dp - delta) scale; p and ds rounded to bf16 as A fragments
  hopper::wgmma_wait<0>();
  fence_regs(dpt);
  uint32_t pa[4][4], da[4][4];
#pragma unroll
  for (int e = 0; e < 32; e += 2) {
    const int c = col0 + acc_col(e);
    const float ds0 = st[e] * (dpt[e] - delta[c]) * scale;
    const float ds1 = st[e + 1] * (dpt[e + 1] - delta[c + 1]) * scale;
    pa[e / 8][(e % 8) / 2] = hopper::pack_bf16(st[e], st[e + 1]);
    da[e / 8][(e % 8) / 2] = hopper::pack_bf16(ds0, ds1);
  }

  // dV += P^T dO, dK += dS^T Q over the tile's q rows
  fence_regs(pa);
  fence_regs(da);
  fence_regs(dv);
  fence_regs(dk);
  hopper::wgmma_fence();
  accumulate<BQ>(dv, pa, do_tile);
  accumulate<BQ>(dk, da, q_tile);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  fence_regs(dv);
  fence_regs(dk);
  fence_regs(pa);
  fence_regs(da);
}

template <bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const __grid_constant__ CUtensorMap do_map,
                           const __grid_constant__ CUtensorMap lse_map,
                           const __grid_constant__ CUtensorMap delta_map,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int BH, int T,
                           float scale) {
  constexpr int BK = kDkvBK, BQ = kDkvBQ;
  using S = DkvSmem;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint8_t* smem = smem_raw + (base - raw);
  const uint32_t held_bar = base + S::kBars;

  // every head's key tile 0 (the most causal work) first, then tile 1, ...
  const int bh = blockIdx.x % BH;
  const int k0 = (blockIdx.x / BH) * BK;
  // a causal call starts at the q tile holding key row k0
  const int q_begin = kCausal ? (k0 / BQ) * BQ : 0;
  const int n_steps = (T - q_begin + BQ - 1) / BQ;

  if (threadIdx.x == 0) {
    hopper::mbar_init(held_bar, 1);
    for (int s = 0; s < kStages; ++s)
      hopper::mbar_init(held_bar + 8 * (1 + s), 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // thread 0 streams q, do, lse and delta of step i into stage i % kStages
  auto load_step = [&](int i) {
    const int s = i % kStages, q0 = q_begin + i * BQ;
    const uint32_t bar = held_bar + 8 * (1 + s);
    const uint32_t tile = base + S::kStage0 + s * S::kStageBytes;
    const uint32_t stats = base + S::kStats0 + s * S::kStatsBytes;
    const int row = (bh * T + q0) & ~3;  // 16-byte aligned, <= bh * T + q0
    hopper::mbar_expect_tx(bar, S::kStageBytes + 2 * kStatsBox * 4);
    load_rows(tile, &q_map, BQ, q0, bh, bar);
    load_rows(tile + tile_bytes(BQ), &do_map, BQ, q0, bh, bar);
    hopper::tma_load_1d(stats, &lse_map, row, bar);
    hopper::tma_load_1d(stats + kStatsSlot, &delta_map, row, bar);
  };
  if (threadIdx.x == 0) {
    hopper::mbar_expect_tx(held_bar, 2 * tile_bytes(BK));
    load_rows(base, &k_map, BK, k0, bh, held_bar);
    load_rows(base + S::kHeldB, &v_map, BK, k0, bh, held_bar);
    for (int i = 0; i < kStages && i < n_steps; ++i) load_step(i);
  }

  const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32;
  const int lane = threadIdx.x % 32;
  const int ka = k0 + 64 * wg;            // the warpgroup's first key row
  const int row0 = 16 * warp + lane / 4;  // the thread's rows: row0, +8
  const int col0 = 2 * (lane % 4);
  const uint32_t k_at = base + wg * 64 * kRow;
  const uint32_t v_at = base + S::kHeldB + wg * 64 * kRow;

  float dk_acc[64], dv_acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) dk_acc[e] = dv_acc[e] = 0.f;

  hopper::mbar_wait(held_bar, 0);
  for (int i = 0; i < n_steps; ++i) {
    const int s = i % kStages, q0 = q_begin + i * BQ;
    hopper::mbar_wait(held_bar + 8 * (1 + s), (i / kStages) & 1);
    // no live pair: keys past T, or (causal) every q row before every key
    const bool dead = ka >= T || (kCausal && q0 + BQ <= ka);
    if (!dead) {
      const uint32_t tile = base + S::kStage0 + s * S::kStageBytes;
      // lse of q row q0 + c at stats[c], delta at stats[c + kStatsSlot / 4]
      const float* stats =
          reinterpret_cast<const float*>(smem + S::kStats0 +
                                         s * S::kStatsBytes) +
          ((bh * T + q0) & 3);
      const bool edge =
          (kCausal && q0 < ka + 64) || q0 + BQ > T || ka + 64 > T;
      if (edge)
        dkv_step<kCausal, true>(dk_acc, dv_acc, k_at, v_at, tile,
                                tile + tile_bytes(BQ), stats,
                                stats + kStatsSlot / 4, ka, q0, row0, col0, T,
                                scale);
      else
        dkv_step<kCausal, false>(dk_acc, dv_acc, k_at, v_at, tile,
                                 tile + tile_bytes(BQ), stats,
                                 stats + kStatsSlot / 4, ka, q0, row0, col0, T,
                                 scale);
    }
    __syncthreads();  // both warpgroups are done with stage s
    if (threadIdx.x == 0 && i + kStages < n_steps) {
      hopper::fence_proxy_async();
      load_step(i + kStages);
    }
  }

  // every key row the block owns is written, rows no q tile reached too
  const size_t head = (size_t)bh * T * kD;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kj = ka + row0 + 8 * h;
      if (kj >= T) continue;
      const size_t at = head + (size_t)kj * kD + 8 * j + col0;
      *reinterpret_cast<__nv_bfloat162*>(dk + at) = __floats2bfloat162_rn(
          dk_acc[4 * j + 2 * h], dk_acc[4 * j + 2 * h + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + at) = __floats2bfloat162_rn(
          dv_acc[4 * j + 2 * h], dv_acc[4 * j + 2 * h + 1]);
    }
}

// One key tile of the dQ kernel for one warpgroup: its 64 query rows
// (from qa) against keys [k0, k0 + 64); lse and delta index the
// accumulator's row, held per thread (rows row0 and row0 + 8).
template <bool kCausal, bool kMask>
__device__ __forceinline__ void dq_step(float (&dq)[64], uint32_t q_at,
                                        uint32_t do_at, uint32_t k_tile,
                                        uint32_t v_tile, const float (&lse)[2],
                                        const float (&delta)[2], int qa,
                                        int k0, int row0, int col0, int T,
                                        float scale) {
  constexpr int BQ = kDqBQ, BK = kDqBK;
  float s[32], dp[32];
  __syncwarp();
  hopper::wgmma_fence();
  scores<BQ, BK>(s, q_at, k_tile);  // S = Q K^T
  hopper::wgmma_commit();
  scores<BQ, BK>(dp, do_at, v_tile);  // dP = dO V^T
  hopper::wgmma_commit();

  hopper::wgmma_wait<1>();
  fence_regs(s);
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int h = acc_row(e) / 8;
    const float arg = __fmul_rn(s[e], scale) - lse[h];
    if (kMask) {
      const int qi = qa + row0 + acc_row(e), kj = k0 + col0 + acc_col(e);
      const bool live = qi < T && kj < T && (!kCausal || qi >= kj);
      s[e] = live ? expf(live ? arg : 0.f) : 0.f;
    } else {
      s[e] = expf(arg);
    }
  }

  hopper::wgmma_wait<0>();
  fence_regs(dp);
  uint32_t da[4][4];
#pragma unroll
  for (int e = 0; e < 32; e += 2) {
    const int h = acc_row(e) / 8;
    da[e / 8][(e % 8) / 2] =
        hopper::pack_bf16(s[e] * (dp[e] - delta[h]) * scale,
                          s[e + 1] * (dp[e + 1] - delta[h]) * scale);
  }

  // dQ += dS K over the tile's keys
  fence_regs(da);
  fence_regs(dq);
  hopper::wgmma_fence();
  accumulate<BK>(dq, da, k_tile);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  fence_regs(dq);
  fence_regs(da);
}

template <bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, int BH, int T,
                          float scale) {
  constexpr int BQ = kDqBQ, BK = kDqBK;
  using S = DqSmem;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t held_bar = base + S::kBars;

  // every head's last query tile (the most causal work) first
  const int nq = (T + BQ - 1) / BQ;
  const int bh = blockIdx.x % BH;
  const int tile = blockIdx.x / BH;
  const int q0 = (kCausal ? nq - 1 - tile : tile) * BQ;
  // keys [0, kv_end): the causal entry stops at the block's last row
  const int kv_end = kCausal ? min(q0 + BQ, T) : T;
  const int n_steps = (kv_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    hopper::mbar_init(held_bar, 1);
    for (int s = 0; s < kStages; ++s)
      hopper::mbar_init(held_bar + 8 * (1 + s), 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // thread 0 streams k and v of step i into stage i % kStages
  auto load_step = [&](int i) {
    const int s = i % kStages;
    const uint32_t bar = held_bar + 8 * (1 + s);
    const uint32_t tile = base + S::kStage0 + s * S::kStageBytes;
    hopper::mbar_expect_tx(bar, S::kStageBytes);
    load_rows(tile, &k_map, BK, i * BK, bh, bar);
    load_rows(tile + tile_bytes(BK), &v_map, BK, i * BK, bh, bar);
  };
  if (threadIdx.x == 0) {
    hopper::mbar_expect_tx(held_bar, 2 * tile_bytes(BQ));
    load_rows(base, &q_map, BQ, q0, bh, held_bar);
    load_rows(base + S::kHeldB, &do_map, BQ, q0, bh, held_bar);
    for (int i = 0; i < kStages && i < n_steps; ++i) load_step(i);
  }

  const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32;
  const int lane = threadIdx.x % 32;
  const int qa = q0 + 64 * wg;            // the warpgroup's first query row
  const int row0 = 16 * warp + lane / 4;  // the thread's rows: row0, +8
  const int col0 = 2 * (lane % 4);
  const uint32_t q_at = base + wg * 64 * kRow;
  const uint32_t do_at = base + S::kHeldB + wg * 64 * kRow;

  float lse_r[2], delta_r[2], dq_acc[64];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = qa + row0 + 8 * h;
    lse_r[h] = qi < T ? lse[(size_t)bh * T + qi] : 0.f;
    delta_r[h] = qi < T ? delta[(size_t)bh * T + qi] : 0.f;
  }
#pragma unroll
  for (int e = 0; e < 64; ++e) dq_acc[e] = 0.f;

  hopper::mbar_wait(held_bar, 0);
  for (int i = 0; i < n_steps; ++i) {
    const int s = i % kStages, k0 = i * BK;
    hopper::mbar_wait(held_bar + 8 * (1 + s), (i / kStages) & 1);
    // no live pair: query rows past T, or (causal) every key after every
    // query row
    const bool dead = qa >= T || (kCausal && k0 > qa + 63);
    if (!dead) {
      const uint32_t tile = base + S::kStage0 + s * S::kStageBytes;
      const bool edge =
          (kCausal && k0 + BK - 1 > qa) || k0 + BK > T || qa + 64 > T;
      if (edge)
        dq_step<kCausal, true>(dq_acc, q_at, do_at, tile,
                               tile + tile_bytes(BK), lse_r, delta_r, qa, k0,
                               row0, col0, T, scale);
      else
        dq_step<kCausal, false>(dq_acc, q_at, do_at, tile,
                                tile + tile_bytes(BK), lse_r, delta_r, qa, k0,
                                row0, col0, T, scale);
    }
    __syncthreads();  // both warpgroups are done with stage s
    if (threadIdx.x == 0 && i + kStages < n_steps) {
      hopper::fence_proxy_async();
      load_step(i + kStages);
    }
  }

  const size_t head = (size_t)bh * T * kD;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = qa + row0 + 8 * h;
      if (qi >= T) continue;
      *reinterpret_cast<__nv_bfloat162*>(dq + head + (size_t)qi * kD + 8 * j +
                                         col0) =
          __floats2bfloat162_rn(dq_acc[4 * j + 2 * h],
                                dq_acc[4 * j + 2 * h + 1]);
    }
}

template <bool kCausal>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int bh, int T, float scale, cudaStream_t stream) {
  if (misaligned(q) || misaligned(k) || misaligned(v) || misaligned(dout) ||
      misaligned(lse) || misaligned(delta))
    return (int)cudaErrorMisalignedAddress;
  CUtensorMap qm, km, vm, dom, lm, dm;
  int err = hopper::bf16_rows_map(&qm, q, bh, T, kDkvBQ);
  if (!err) err = hopper::bf16_rows_map(&km, k, bh, T, kDkvBK);
  if (!err) err = hopper::bf16_rows_map(&vm, v, bh, T, kDkvBK);
  if (!err) err = hopper::bf16_rows_map(&dom, dout, bh, T, kDkvBQ);
  if (!err)
    err = hopper::f32_vector_map(&lm, lse, (long long)bh * T, kStatsBox);
  if (!err)
    err = hopper::f32_vector_map(&dm, delta, (long long)bh * T, kStatsBox);
  if (err) return err;
  auto kernel = flash_bwd_dkv_wgmma_kernel<kCausal>;
  if (int e = configure(kernel, DkvSmem::kBytes)) return e;
  const int tiles = (T + kDkvBK - 1) / kDkvBK;
  kernel<<<tiles * bh, kThreads, DkvSmem::kBytes, stream>>>(
      qm, km, vm, dom, lm, dm, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), bh, T, scale);
  return (int)cudaGetLastError();
}

template <bool kCausal>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int bh, int T,
              float scale, cudaStream_t stream) {
  if (misaligned(q) || misaligned(k) || misaligned(v) || misaligned(dout))
    return (int)cudaErrorMisalignedAddress;
  CUtensorMap qm, km, vm, dom;
  int err = hopper::bf16_rows_map(&qm, q, bh, T, kDqBQ);
  if (!err) err = hopper::bf16_rows_map(&km, k, bh, T, kDqBK);
  if (!err) err = hopper::bf16_rows_map(&vm, v, bh, T, kDqBK);
  if (!err) err = hopper::bf16_rows_map(&dom, dout, bh, T, kDqBQ);
  if (err) return err;
  auto kernel = flash_bwd_dq_wgmma_kernel<kCausal>;
  if (int e = configure(kernel, DqSmem::kBytes)) return e;
  const int tiles = (T + kDqBQ - 1) / kDqBQ;
  kernel<<<tiles * bh, kThreads, DqSmem::kBytes, stream>>>(
      qm, km, vm, dom, lse, delta, static_cast<__nv_bfloat16*>(dq), bh, T,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace tc

// ------------------------------------------------------------------------
// The split-TF32 kernels: float32, D = 8 and 16
// ------------------------------------------------------------------------
namespace tf32x3 {

using mma_tf32::as_a;
using mma_tf32::BFrag;
using mma_tf32::frag_at;
using mma_tf32::held_rows;
using mma_tf32::layout_a;
using mma_tf32::layout_b;
using mma_tf32::mma3;
using mma_tf32::store_rows;

constexpr int kThreads = 128;  // four warps
constexpr int kMT = 2;          // m16 tiles a warp holds
constexpr int kWarpRows = 16 * kMT;
// rows a block holds: keys (dK/dV), q (dQ)
constexpr int kHeld = kThreads / 32 * kWarpRows;
constexpr int kStep = 64;  // rows a step streams: q (dK/dV), keys (dQ)
constexpr int kMinBlocks = 2;  // blocks an SM holds (registers <= 255)

// The two streamed tiles (mma_tf32.cuh): kDkv, the dK/dV kernel's q and
// dO, each in both layouts (S^T, dP^T read layout A; dV, dK layout B);
// else the dQ kernel's K (A for S, B for dQ) and V (A for dP).
template <int D, bool kDkv>
using Stream = mma_tf32::Stream<D, kStep, kThreads, true, true, true, kDkv>;

// A block's shared memory, in floats; kDkv: the dK/dV kernel's (q, dO,
// lse, delta), else the dQ kernel's (K, V).  The raw stage: the two
// streamed tiles as copied and, with kDkv, their lse and delta rows; the
// next step's copies land there while a step runs.  Two split buffers (a
// step reads one while the next is split into the other), each holding
// the streamed tiles' layouts (Stream) and then, with kDkv, the lse and
// delta rows.
template <int D, bool kDkv>
struct Smem {
  using St = Stream<D, kDkv>;
  static constexpr int kRaw = St::kRaw + (kDkv ? 2 * kStep : 0);
  static constexpr int kLayout = St::kLayout;
  static constexpr int kBuf = St::kBuf + (kDkv ? 2 * kStep : 0);
  static constexpr int kBuf0 = kRaw;
  static constexpr int kFloats = kBuf0 + 2 * kBuf;
  static constexpr int kBytes = kFloats * 4;
};

// Thread x's units (with kDkv, lse and delta rows too) of step rows
// [r0, r0 + kStep) of the two [T][D] tensors a and b into the raw stage
// by cp.async: 16-byte chunks, zeros past T.  One group, committed.
template <int D, bool kDkv>
__device__ __forceinline__ void load_step(uint32_t raw, const float* a,
                                          const float* b, const float* lse,
                                          const float* delta, int r0, int T,
                                          bool any) {
  Stream<D, kDkv>::load(raw, a, b, r0, T, any);
  for (int u = threadIdx.x; kDkv && any && u < 2 * kStep; u += kThreads) {
    const int x = u % kStep;
    const bool in = r0 + x < T;
    mma_tf32::cp_async4(raw + 4 * (2 * kStep * D + u),
                        (u < kStep ? lse : delta) + (in ? r0 + x : 0), in);
  }
  mma_tf32::cp_async_commit();
}

// Thread x's units of the raw stage (landed: it copied them) split into hi
// and lo in the layouts of split buffer `buf`: [a: A, B][b: A, B] (dQ: no
// b B), then (kDkv) the lse and delta rows.
template <int D, bool kDkv>
__device__ __forceinline__ void split_step(const float* raw, float* buf) {
  using S = Smem<D, kDkv>;
  Stream<D, kDkv>::split(raw, buf);
  for (int u = threadIdx.x; kDkv && u < 2 * kStep; u += kThreads)
    buf[4 * S::kLayout + u] = raw[2 * kStep * D + u];
}

// p (in place of s) and ds (in place of dp) of one [16 x 8] fragment:
// element e at held row g + 8 (e / 2) and step column 2t + (e % 2).
// live(e) says whether the pair is live (kMask only); lse_of(e) and
// delta_of(e) give the query row's lse and delta.
template <bool kMask, typename Live, typename Lse, typename Delta>
__device__ __forceinline__ void p_and_ds(float (&s)[4], float (&dp)[4],
                                         float scale, Live live, Lse lse_of,
                                         Delta delta_of) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    // rounded as the plain version rounds: s * scale, then - lse
    const float arg = __fmul_rn(s[e], scale) - lse_of(e);
    float p;
    if (kMask) {
      const bool in = live(e);
      p = in ? expf(in ? arg : 0.f) : 0.f;
    } else {
      p = expf(arg);
    }
    s[e] = p;
    dp[e] = p * (dp[e] - delta_of(e)) * scale;
  }
}

// acc += step, element by element (IEEE adds)
template <int D>
__device__ __forceinline__ void add_step(float (&acc)[kMT][D / 8][4],
                                         const float (&step)[kMT][D / 8][4]) {
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int nn = 0; nn < D / 8; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][nn][e] += step[m][nn][e];
}

// One q step of the dK/dV kernel for one warp: its 16 kMT key rows (from
// ka) against q rows [q0, q0 + kStep) of split buffer `buf`; each B
// fragment feeds the warp's kMT m16 tiles.  The step's dK and dV sums
// start at 0 in registers and are added to the running sums with IEEE
// adds, so the tensor cores' own accumulation covers one step.
template <int D, bool kCausal, bool kMask>
__device__ __forceinline__ void dkv_step(
    float (&dk)[kMT][D / 8][4], float (&dv)[kMT][D / 8][4],
    const uint32_t (&k_hi)[kMT][D / 8][4],
    const uint32_t (&k_lo)[kMT][D / 8][4],
    const uint32_t (&v_hi)[kMT][D / 8][4],
    const uint32_t (&v_lo)[kMT][D / 8][4], const float* buf, int ka, int q0,
    int T, float scale) {
  using S = Smem<D, true>;
  constexpr int NT = D / 8;
  const float* q_a = buf;
  const float* q_b = buf + S::kLayout;
  const float* do_a = buf + 2 * S::kLayout;
  const float* do_b = buf + 3 * S::kLayout;
  const float* lse = buf + 4 * S::kLayout;
  const float* delta = lse + kStep;
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  float dk_step[kMT][NT][4] = {}, dv_step[kMT][NT][4] = {};
#pragma unroll
  for (int j = 0; j < kStep / 8; ++j) {
    // S^T = K Q^T and dP^T = V dO^T for q columns 8j..8j+7
    float st[kMT][4] = {}, dpt[kMT][4] = {};
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      const int at = layout_a<D>(8 * j + g, 4 * kk + t);
      const BFrag qf = frag_at(q_a, at), dof = frag_at(do_a, at);
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        mma3(st[m], k_hi[m][kk], k_lo[m][kk], qf);
        mma3(dpt[m], v_hi[m][kk], v_lo[m][kk], dof);
      }
    }
    const int c = 8 * j + 2 * t;  // the q column of elements 0 and 2
    const float2 lse_c = *reinterpret_cast<const float2*>(lse + c);
    const float2 delta_c = *reinterpret_cast<const float2*>(delta + c);
    uint32_t pa_hi[kMT][4], pa_lo[kMT][4], da_hi[kMT][4], da_lo[kMT][4];
#pragma unroll
    for (int m = 0; m < kMT; ++m) {
      p_and_ds<kMask>(
          st[m], dpt[m], scale,
          [&](int e) {
            const int qi = q0 + c + e % 2;
            const int kj = ka + 16 * m + g + 8 * (e / 2);
            return qi < T && kj < T && (!kCausal || qi >= kj);
          },
          [&](int e) { return e % 2 ? lse_c.y : lse_c.x; },
          [&](int e) { return e % 2 ? delta_c.y : delta_c.x; });
      as_a(st[m], pa_hi[m], pa_lo[m]);
      as_a(dpt[m], da_hi[m], da_lo[m]);
    }
    // dV += P^T dO, dK += dS^T Q over these 8 q rows (row pair 4j + t
    // holds rows c and c + 1)
#pragma unroll
    for (int nn = 0; nn < NT; ++nn) {
      const int at = layout_b<D>(4 * j + t, 8 * nn + g);
      const BFrag dof = frag_at(do_b, at), qf = frag_at(q_b, at);
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        mma3(dv_step[m][nn], pa_hi[m], pa_lo[m], dof);
        mma3(dk_step[m][nn], da_hi[m], da_lo[m], qf);
      }
    }
  }
  add_step<D>(dk, dk_step);
  add_step<D>(dv, dv_step);
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_bwd_dkv_mma_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int BH, int T, float scale) {
  using S = Smem<D, true>;
  constexpr int NT = D / 8;
  extern __shared__ __align__(16) float smem[];
  const uint32_t raw0 = hopper::smem_u32(smem);

  // every head's key tile 0 (the most causal work) first, then tile 1, ...
  const int bh = blockIdx.x % BH;
  const int k0 = (blockIdx.x / BH) * kHeld;
  // a causal call starts at the q tile holding key row k0
  const int q_begin = kCausal ? (k0 / kStep) * kStep : 0;
  const int n_steps = (T - q_begin + kStep - 1) / kStep;
  const size_t head = (size_t)bh * T * D;
  const float* qh = q + head;
  const float* doh = dout + head;
  const float* lseh = lse + (size_t)bh * T;
  const float* deltah = delta + (size_t)bh * T;

  auto load = [&](int i) {
    load_step<D, true>(raw0, qh, doh, lseh, deltah, q_begin + i * kStep, T,
                       i < n_steps);
  };
  load(0);

  const int warp = threadIdx.x / 32;
  const int ka = k0 + kWarpRows * warp;  // the warp's first key row
  uint32_t k_hi[kMT][NT][4], k_lo[kMT][NT][4], v_hi[kMT][NT][4],
      v_lo[kMT][NT][4];
  held_rows(k_hi, k_lo, k + head, ka, T);
  held_rows(v_hi, v_lo, v + head, ka, T);
  float dk_acc[kMT][NT][4] = {}, dv_acc[kMT][NT][4] = {};

  for (int i = 0; i < n_steps; ++i) {
    const int q0 = q_begin + i * kStep;
    float* buf = smem + S::kBuf0 + (i % 2) * S::kBuf;
    mma_tf32::cp_async_wait<0>();
    split_step<D, true>(smem, buf);
    // buf is whole, and every warp is past step i - 1, so buffer
    // (i + 1) % 2 may be rewritten; the raw stage is free (each thread
    // split its own copies), and step i + 1's copies land there while
    // step i runs
    __syncthreads();
    load(i + 1);
    // no live pair: keys past T, or (causal) every q row before every key
    const bool dead = ka >= T || (kCausal && q0 + kStep <= ka);
    if (!dead) {
      const bool edge = (kCausal && q0 < ka + kWarpRows) || q0 + kStep > T ||
                        ka + kWarpRows > T;
      if (edge)
        dkv_step<D, kCausal, true>(dk_acc, dv_acc, k_hi, k_lo, v_hi, v_lo,
                                   buf, ka, q0, T, scale);
      else
        dkv_step<D, kCausal, false>(dk_acc, dv_acc, k_hi, k_lo, v_hi, v_lo,
                                    buf, ka, q0, T, scale);
    }
  }

  // every key row the block owns is written, rows no q tile reached too
  store_rows(dk + head, dk_acc, ka, T);
  store_rows(dv + head, dv_acc, ka, T);
}

// One key step of the dQ kernel for one warp: its 16 kMT query rows (from
// qa) against keys [k0, k0 + kStep) of split buffer `buf`; lse and delta
// of the thread's rows (qa + 16 m + g, + 8) held in registers.  The
// step's dQ sum starts at 0, as in dkv_step.
template <int D, bool kCausal, bool kMask>
__device__ __forceinline__ void dq_step(
    float (&dq)[kMT][D / 8][4], const uint32_t (&q_hi)[kMT][D / 8][4],
    const uint32_t (&q_lo)[kMT][D / 8][4],
    const uint32_t (&do_hi)[kMT][D / 8][4],
    const uint32_t (&do_lo)[kMT][D / 8][4], const float (&lse)[kMT][2],
    const float (&delta)[kMT][2], const float* buf, int qa, int k0, int T,
    float scale) {
  using S = Smem<D, false>;
  constexpr int NT = D / 8;
  const float* k_a = buf;
  const float* k_b = buf + S::kLayout;
  const float* v_a = buf + 2 * S::kLayout;
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  float dq_step[kMT][NT][4] = {};
#pragma unroll
  for (int j = 0; j < kStep / 8; ++j) {
    // S = Q K^T and dP = dO V^T for keys 8j..8j+7
    float s[kMT][4] = {}, dp[kMT][4] = {};
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      const int at = layout_a<D>(8 * j + g, 4 * kk + t);
      const BFrag kf = frag_at(k_a, at), vf = frag_at(v_a, at);
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        mma3(s[m], q_hi[m][kk], q_lo[m][kk], kf);
        mma3(dp[m], do_hi[m][kk], do_lo[m][kk], vf);
      }
    }
    const int c = 8 * j + 2 * t;  // the key column of elements 0 and 2
    uint32_t da_hi[kMT][4], da_lo[kMT][4];
#pragma unroll
    for (int m = 0; m < kMT; ++m) {
      p_and_ds<kMask>(
          s[m], dp[m], scale,
          [&](int e) {
            const int qi = qa + 16 * m + g + 8 * (e / 2);
            const int kj = k0 + c + e % 2;
            return qi < T && kj < T && (!kCausal || qi >= kj);
          },
          [&](int e) { return lse[m][e / 2]; },
          [&](int e) { return delta[m][e / 2]; });
      as_a(dp[m], da_hi[m], da_lo[m]);
    }
    // dQ += dS K over these 8 keys (row pair 4j + t holds keys c, c + 1)
#pragma unroll
    for (int nn = 0; nn < NT; ++nn) {
      const BFrag kf = frag_at(k_b, layout_b<D>(4 * j + t, 8 * nn + g));
#pragma unroll
      for (int m = 0; m < kMT; ++m)
        mma3(dq_step[m][nn], da_hi[m], da_lo[m], kf);
    }
  }
  add_step<D>(dq, dq_step);
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_bwd_dq_mma_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int BH, int T, float scale) {
  using S = Smem<D, false>;
  constexpr int NT = D / 8;
  extern __shared__ __align__(16) float smem[];
  const uint32_t raw0 = hopper::smem_u32(smem);

  // every head's last query tile (the most causal work) first
  const int nq = (T + kHeld - 1) / kHeld;
  const int bh = blockIdx.x % BH;
  const int tile = blockIdx.x / BH;
  const int q0 = (kCausal ? nq - 1 - tile : tile) * kHeld;
  // keys [0, kv_end): the causal entry stops at the block's last row
  const int kv_end = kCausal ? min(q0 + kHeld, T) : T;
  const int n_steps = (kv_end + kStep - 1) / kStep;
  const size_t head = (size_t)bh * T * D;
  const float* kh = k + head;
  const float* vh = v + head;

  auto load = [&](int i) {
    load_step<D, false>(raw0, kh, vh, nullptr, nullptr, i * kStep, T,
                        i < n_steps);
  };
  load(0);

  const int warp = threadIdx.x / 32;
  const int g = threadIdx.x % 32 / 4;
  const int qa = q0 + kWarpRows * warp;  // the warp's first query row
  uint32_t q_hi[kMT][NT][4], q_lo[kMT][NT][4], do_hi[kMT][NT][4],
      do_lo[kMT][NT][4];
  held_rows(q_hi, q_lo, q + head, qa, T);
  held_rows(do_hi, do_lo, dout + head, qa, T);
  float lse_r[kMT][2], delta_r[kMT][2];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = qa + 16 * m + g + 8 * h;
      lse_r[m][h] = qi < T ? lse[(size_t)bh * T + qi] : 0.f;
      delta_r[m][h] = qi < T ? delta[(size_t)bh * T + qi] : 0.f;
    }
  float dq_acc[kMT][NT][4] = {};

  for (int i = 0; i < n_steps; ++i) {
    const int k0 = i * kStep;
    float* buf = smem + S::kBuf0 + (i % 2) * S::kBuf;
    mma_tf32::cp_async_wait<0>();
    split_step<D, false>(smem, buf);
    __syncthreads();  // as in the dK/dV kernel
    load(i + 1);
    // no live pair: query rows past T, or (causal) every key after every
    // query row
    const bool dead = qa >= T || (kCausal && k0 > qa + kWarpRows - 1);
    if (!dead) {
      const bool edge = (kCausal && k0 + kStep - 1 > qa) || k0 + kStep > T ||
                        qa + kWarpRows > T;
      if (edge)
        dq_step<D, kCausal, true>(dq_acc, q_hi, q_lo, do_hi, do_lo, lse_r,
                                  delta_r, buf, qa, k0, T, scale);
      else
        dq_step<D, kCausal, false>(dq_acc, q_hi, q_lo, do_hi, do_lo, lse_r,
                                   delta_r, buf, qa, k0, T, scale);
    }
  }

  store_rows(dq + head, dq_acc, qa, T);
}

// cp.async copies 16-byte chunks: every [T][D] tensor starts on 16 bytes
inline bool misaligned4(const void* q, const void* k, const void* v,
                        const void* dout) {
  return flash_tiles::misaligned(q) || flash_tiles::misaligned(k) ||
         flash_tiles::misaligned(v) || flash_tiles::misaligned(dout);
}

template <int D, bool kCausal>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int bh, int T, float scale, cudaStream_t stream) {
  if (misaligned4(q, k, v, dout)) return (int)cudaErrorMisalignedAddress;
  auto kernel = flash_bwd_dkv_mma_kernel<D, kCausal>;
  constexpr int smem = Smem<D, true>::kBytes;
  if (int err = configure(kernel, smem)) return err;
  const int tiles = (T + kHeld - 1) / kHeld;
  kernel<<<tiles * bh, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dk), static_cast<float*>(dv), bh, T, scale);
  return (int)cudaGetLastError();
}

template <int D, bool kCausal>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int bh, int T,
              float scale, cudaStream_t stream) {
  if (misaligned4(q, k, v, dout)) return (int)cudaErrorMisalignedAddress;
  auto kernel = flash_bwd_dq_mma_kernel<D, kCausal>;
  constexpr int smem = Smem<D, false>::kBytes;
  if (int err = configure(kernel, smem)) return err;
  const int tiles = (T + kHeld - 1) / kHeld;
  kernel<<<tiles * bh, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dq), bh, T, scale);
  return (int)cudaGetLastError();
}

}  // namespace tf32x3

using flash_tiles::bwd_design;

template <typename T> struct Type { using type = T; };
template <int D, bool C> struct Variant {
  static constexpr int kD = D;
  static constexpr bool kCausal = C;
};

template <typename Elt, int D, typename F>
int pick_causal(int causal, F f) {
  return causal ? f(Type<Elt>{}, Variant<D, true>{})
                : f(Type<Elt>{}, Variant<D, false>{});
}

// The FMA kernels' (dtype, d): float32 at D = 128, bfloat16 at D = 8, 16
// (float32 at D = 8, 16 and bfloat16 at D = 128 take the other designs)
template <typename Elt, typename F>
int pick_dim(int d, int causal, F f) {
  if constexpr (std::is_same<Elt, float>::value) {
    if (d == 128) return pick_causal<Elt, 128>(causal, f);
  } else {
    if (d == 8) return pick_causal<Elt, 8>(causal, f);
    if (d == 16) return pick_causal<Elt, 16>(causal, f);
  }
  return (int)cudaErrorInvalidValue;
}

// The design bwd_design picks for (dtype, d): tc(causal) for the wgmma
// kernels, mma(Type<float>, Variant<D, causal>) for the split-TF32 ones,
// else fma(Type<Elt>, Variant<D, causal>) for the runtime dtype (0
// float32, 1 bfloat16), head dim (8, 16, 128) and causal flag: 6 FMA,
// 4 split-TF32 and 2 wgmma instantiations a kernel.
template <typename Fma, typename Tc, typename Mma>
int dispatch(int bh, int T, int dtype, int d, int causal, Fma fma, Tc tc,
             Mma mma) {
  if (bh < 1 || bh > 65535 || T < 1) return (int)cudaErrorInvalidValue;
  switch (bwd_design(dtype, d)) {
    case flash_tiles::kWgmma:
      return tc(causal != 0);
    case flash_tiles::kMmaTf32x3:
      return d == 8 ? pick_causal<float, 8>(causal, mma)
                    : pick_causal<float, 16>(causal, mma);
    default:
      break;
  }
  switch (dtype) {
    case 0: return pick_dim<float>(d, causal, fma);
    case 1: return pick_dim<__nv_bfloat16>(d, causal, fma);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dK and dV on the given stream.  dtype: 0 float32, 1 bfloat16; d in
// {8, 16, 128}.  Returns 0 or the CUDA error of the launch.
extern "C" int iotml_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                   const void* dout, const float* lse,
                                   const float* delta, void* dk, void* dv,
                                   int bh, int T, int d, int dtype, int causal,
                                   float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(
      bh, T, dtype, d, causal,
      [&](auto elt, auto var) {
        using Elt = typename decltype(elt)::type;
        using V = decltype(var);
        return launch_dkv<Elt, V::kD, V::kCausal>(q, k, v, dout, lse, delta,
                                                  dk, dv, bh, T, scale, s);
      },
      [&](bool c) {
        return c ? tc::launch_dkv<true>(q, k, v, dout, lse, delta, dk, dv, bh,
                                        T, scale, s)
                 : tc::launch_dkv<false>(q, k, v, dout, lse, delta, dk, dv,
                                         bh, T, scale, s);
      },
      [&](auto, auto var) {
        using V = decltype(var);
        return tf32x3::launch_dkv<V::kD, V::kCausal>(
            q, k, v, dout, lse, delta, dk, dv, bh, T, scale, s);
      });
}

// dQ on the given stream; arguments as iotml_flash_bwd_dkv.
extern "C" int iotml_flash_bwd_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  const float* delta, void* dq, int bh, int T,
                                  int d, int dtype, int causal, float scale,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(
      bh, T, dtype, d, causal,
      [&](auto elt, auto var) {
        using Elt = typename decltype(elt)::type;
        using V = decltype(var);
        return launch_dq<Elt, V::kD, V::kCausal>(q, k, v, dout, lse, delta, dq,
                                                 bh, T, scale, s);
      },
      [&](bool c) {
        return c ? tc::launch_dq<true>(q, k, v, dout, lse, delta, dq, bh, T,
                                       scale, s)
                 : tc::launch_dq<false>(q, k, v, dout, lse, delta, dq, bh, T,
                                        scale, s);
      },
      [&](auto, auto var) {
        using V = decltype(var);
        return tf32x3::launch_dq<V::kD, V::kCausal>(q, k, v, dout, lse, delta,
                                                    dq, bh, T, scale, s);
      });
}

// The design (d, dtype) runs: 0 the FMA kernels, 1 the wgmma ones, 2 the
// split-TF32 ones (flash_tiles::bwd_design); -1 for what the kernels are
// not built for.
extern "C" int iotml_flash_bwd_design(int d, int dtype) {
  if ((d != 8 && d != 16 && d != 128) || (dtype != 0 && dtype != 1))
    return -1;
  return bwd_design(dtype, d);
}

// Dynamic shared memory of one block, in bytes: kind 0 the dK/dV kernel,
// 1 the dQ kernel, at head dim d and dtype (0 float32, 1 bfloat16); -1
// for what the kernels are not built for.
extern "C" int iotml_flash_bwd_smem(int d, int kind, int dtype) {
  switch (iotml_flash_bwd_design(d, dtype)) {
    case flash_tiles::kWgmma:
      return (int)(kind == 0 ? tc::DkvSmem::kBytes : tc::DqSmem::kBytes);
    case flash_tiles::kMmaTf32x3:
      if (d == 8)
        return kind == 0 ? tf32x3::Smem<8, true>::kBytes
                         : tf32x3::Smem<8, false>::kBytes;
      return kind == 0 ? tf32x3::Smem<16, true>::kBytes
                       : tf32x3::Smem<16, false>::kBytes;
    case flash_tiles::kFma:
      return (kind == 0 ? dkv_smem_floats(d) : dq_smem_floats(d)) *
             (int)sizeof(float);
    default:
      return -1;
  }
}
