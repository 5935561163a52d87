// Flash-attention forward for Hopper (sm_90a): O and the per-row
// log-sum-exp of softmax(Q K^T / sqrt(D)) V, causal or not.
//
// Replaces the TPU kernels iotml/ops/attention.py::_flash_kernel (:149,
// the dense grid; here the non-causal entry) and ::_flash_kernel_tri
// (:215, the causal triangle; here the causal entry).  It computes what
// they compute, with their dtype policy, and is not carried over block
// by block.  The plain PyTorch version beside the wrapper
// (iotml_torch/ops/attention.py::flash_attention_reference) repeats the
// arithmetic.
//
// Layout: q, k, v, o are [B*H, T, D] contiguous in the input dtype
// (float32 or bfloat16); lse is [B*H, T] float32.
//
// What bounds it on this card.  Each live (query, key) pair costs 4*D
// flops (2*D for Q K^T, 2*D for P V) against 4 loads of D values per
// query row for the whole sequence, so at the shapes the port runs
// (SensorFormer: T = 4096, D = 16; long context: T = 65,536, D = 128)
// operations bound it, not bytes.  At the long causal shape (bf16, B = 1,
// H = 2) that is 2.199e12 flops: 2.224 ms at the tensor cores' 989
// TFLOP/s, 4.447 ms without the mask.  In float32 the split-TF32 products
// cost three tf32 products each: at the SensorFormer layer (B*H = 400,
// T = 4096, causal) 1.302 ms at 495 TFLOP/s / 3 (the fp32 FMA floor:
// 3.206 ms); its one ex2 a live pair floors it at 0.80 ms on the SFU
// alone.
//
// Three designs, chosen by (dtype, D) in iotml_flash_fwd below
// (fwd_design in flash_tiles.cuh; iotml_flash_fwd_design reports it):
// - bf16 at D = 128: the tensor-core kernel (namespace tc, below);
// - float32 at D = 8, 16: the split-TF32 mma.sync kernel (namespace
//   tf32x3, below);
// - float32 at D = 128 and bf16 at D = 8, 16: the FMA kernel.
//
// The FMA kernel does its products with fp32 FMA on the CUDA cores
// (67 TFLOP/s on an H100 SXM).  One block of 128 threads owns 64 query
// rows and loops over the key tiles itself (the TPU's sequential kv grid
// axis becomes that loop); blocks start with the heaviest causal rows so
// the tail of the grid is short.  A key/value tile of BK rows is staged
// in shared memory as float32 and used by all 64 rows.  Each thread owns
// 4 query rows x BK/8 key columns of the score tile and 4 rows x D/8
// output columns, so every shared-memory load feeds 2 to 4 FMAs; the
// running max, denominator and f32 accumulator stay in registers.  The
// causal entry stops at the last key tile that reaches the diagonal, so
// strictly-future tiles are never loaded, and masks elementwise; keys at
// kj >= T are masked in the kernel rather than padded.
//
// The tensor-core kernel (bf16, D = 128) is written for Hopper, not
// carried over from the TPU's 1024^2 tiles.  What held the FMA kernel
// back at this shape, and what this one does about it:
// - no tensor cores: S = Q K^T and O += P V are bf16 wgmma with f32
//   accumulators (hopper.cuh, flash_tiles.cuh).  A block of 256 threads
//   holds 128 query rows, 64 for each of its two warpgroups, and loops
//   over key tiles of 64 rows; S reads Q and K from shared memory, both
//   K-major, and P V reads V MN-major.
// - bf16 staged as f32: tiles stay bf16, in the 128-byte swizzled layout
//   wgmma reads, with no conversion.
// - tiny key tiles: 64-row tiles, one k16 wgmma in place of 64 x 16 x 16
//   FMAs and their shared loads.
// - P through shared memory: the online softmax runs in registers on the
//   m64n64 accumulator fragment (a row's 64 columns lie in the 4 lanes of
//   a quad), and the f32 P fragment is, pair by pair, the bf16 A fragment
//   of P V.  m and l are two floats a thread.
// - synchronous loads: Q comes in once by TMA; one thread streams K and V
//   by TMA into a ring of kStages stages, each with an mbarrier that
//   counts the bytes, so the next tiles are in flight while one is used.
// - the exps beside idle tensor cores: S of step i + 1 is issued, into a
//   second set of 32 registers, before the softmax of step i, and O +=
//   P V of step i - 1 behind it; the softmax runs while both are in
//   flight.  The softmax is the kernel's other cost (the accurate expf
//   above all), so it reduces rows as trees.
// What stays: the heaviest blocks first (every head's last query tile,
// then the one before); the causal stop at the diagonal (keys
// [0, min(q0 + 128, T))); masks only in steps that straddle the diagonal
// or the ragged end, since TMA fills rows past T with zeros, which would
// otherwise be live scores; a warpgroup skips the steps it has no live
// key in.  A thread holds O (64 f32 registers), two S (32 each) and P
// (16): 256 threads a block, one block an SM.
//
// The split-TF32 kernel (float32, D = 8 and 16, the SensorFormer layer)
// replaces the FMA kernel there, on the backward's blocks (mma_tf32.cuh).
// What held the FMA kernel back, and what this one does about it:
// - products on the CUDA cores, fed by scalar shared loads: here S = Q K^T
//   and O += P V are m16n8k8 tf32 mma.sync, each f32 operand split as
//   hi + lo and each product a_lo b_hi + a_hi b_lo + a_hi b_hi (three
//   mmas, ~2^-21 relative: within O's and the LSE's 2e-5); one 128-bit
//   shared load brings a B fragment's b0, b1, hi and lo, and feeds the
//   warp's two m16 tiles (six mmas).
// - P through shared memory behind a barrier: the online softmax runs in
//   registers on S's C fragment (a row's 64 keys lie in the 4 lanes of a
//   quad: two shuffles for the max, two for the sum), and the C fragment
//   is P V's A fragment with no shuffle (mma_tf32.cuh).  l sums p in f32
//   before p is split.
// - the tensor cores' truncating f32 accumulation: S and each step's P V
//   sum start at 0 in registers; o = o * corr + sum by IEEE ops.
// - the accurate expf's cost beside the mmas: p = exp2f((s - m) log2 e),
//   one ex2 and a multiply, within O's 2e-5 by far (fwd_step).
// - synchronous staging (a div/mod per element between two barriers):
//   each thread copies its share of the next step's K and V by cp.async,
//   16-byte chunks, into a raw stage while the current step runs, then
//   splits its own chunks into hi and lo in one of two split buffers (K
//   in the order S reads it, V in the order P V reads it); one barrier a
//   step.
// Shape: 128 threads, four warps of two m16 tiles (32 query rows; Q as
// hi/lo A fragments in registers), 128 query rows a block, key steps of
// 64, two blocks an SM.  What stays: the heaviest query tiles first, the
// causal stop at the block's last row, masks only in steps that straddle
// the diagonal or the ragged end (cp.async fills keys past T with zeros),
// and a warp skips the steps it has no live key in.
//
// Exactness, as the TPU kernels have it: scores are f32 sums of
// input-dtype products (exact in f32 for bf16), scaled after Q K^T;
// masked scores are NEG_INF = -1e30, not -inf; alive = m_new > NEG_INF/2
// guards both the correction and p; p is rounded to the input dtype
// before P V, with f32 accumulation; o = acc / (l == 0 ? 1 : l) and
// lse = l == 0 ? NEG_INF : m + log(l).  Sums run in a fixed order with no
// atomics, so runs repeat bit for bit.  Build without --use_fast_math:
// expf, logf and the division must be the accurate ones (the split-TF32
// kernel's p is the one exp2f, above).  The
// tensor-core kernels keep all of it: the scale is applied with
// __fmul_rn, so it cannot fuse into the subtraction of m; l sums p
// before p is rounded to bf16 (or split) in the A fragment.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "flash_tiles.cuh"
#include "hopper.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;           // query rows per block
constexpr int kTY = 16;           // thread rows: 4 query rows each
constexpr int kTX = 8;            // thread columns: lanes of one row group
constexpr int kThreads = kTY * kTX;
constexpr int kRows = kBQ / kTY;  // query rows per thread

// key rows per tile: at D = 128 a 64-row tile would hold the block's
// shared memory above 110 KB (one block per SM); 32 rows keep three
__host__ __device__ constexpr int key_tile(int D) { return D >= 128 ? 32 : 64; }

__host__ __device__ constexpr int smem_floats(int D) {
  // q [kBQ][D+1], k [BK][D+1], v [BK][D], p [kBQ][BK+1]; the +1 pads keep
  // the strided reads on distinct banks
  return kBQ * (D + 1) + key_tile(D) * (D + 1) + key_tile(D) * D +
         kBQ * (key_tile(D) + 1);
}

__device__ inline float to_float(float x) { return x; }
__device__ inline float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename Elt> __device__ inline Elt from_float(float x);
template <> __device__ inline float from_float<float>(float x) { return x; }
template <> __device__ inline __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename Elt, int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Elt* __restrict__ q, const Elt* __restrict__ k,
                 const Elt* __restrict__ v, Elt* __restrict__ o,
                 float* __restrict__ lse, int T, float scale) {
  constexpr int BK = key_tile(D);
  constexpr int kCols = BK / kTX;  // score columns per thread
  constexpr int kDs = D / kTX;     // output columns per thread
  static_assert(D % kTX == 0 && BK % kTX == 0, "tile shape");

  extern __shared__ float smem[];
  float* qs = smem;                 // [kBQ][D + 1]
  float* ks = qs + kBQ * (D + 1);   // [BK][D + 1]
  float* vs = ks + BK * (D + 1);    // [BK][D]
  float* ps = vs + BK * D;          // [kBQ][BK + 1]

  const int tid = threadIdx.x;
  const int ty = tid / kTX, tx = tid % kTX;
  // the last query tile first: under the causal mask it has the most work
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const size_t base = (size_t)blockIdx.y * T * D;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int qi = q0 + r;
    qs[r * (D + 1) + d] = qi < T ? to_float(q[base + (size_t)qi * D + d]) : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][kDs];
  int limit[kRows];  // last key each row attends to
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty * kRows + i;
    m[i] = kNegInf;
    l[i] = 0.f;
    limit[i] = kCausal ? min(qi, T - 1) : T - 1;
#pragma unroll
    for (int c = 0; c < kDs; ++c) acc[i][c] = 0.f;
  }

  // keys [0, kv_end): the causal entry stops at the block's last row
  const int kv_end = kCausal ? min(q0 + kBQ, T) : T;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the last tile's k, v and p are no longer read
    for (int idx = tid; idx < BK * D; idx += kThreads) {
      const int c = idx / D, d = idx % D;
      const int kj = k0 + c;
      float kv = 0.f, vv = 0.f;
      if (kj < T) {
        kv = to_float(k[base + (size_t)kj * D + d]);
        vv = to_float(v[base + (size_t)kj * D + d]);
      }
      ks[c * (D + 1) + d] = kv;
      vs[c * D + d] = vv;
    }
    __syncthreads();

    // s = q k^T for this thread's 4 rows x kCols columns, d ascending
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(ty * kRows + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = ks[(tx + kTX * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax; the kTX lanes of a row group share each row
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kj = k0 + tx + kTX * j;
        s[i][j] = kj <= limit[i] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 1; w < kTX; w <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      const bool alive = m_new > kNegInf / 2;
      const float corr = alive ? expf(m[i] - m_new) : 0.f;
      float row_sum = 0.f;
      float* prow = ps + (ty * kRows + i) * (BK + 1);
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = alive ? expf(s[i][j] - m_new) : 0.f;
        row_sum += p;
        prow[tx + kTX * j] = to_float(from_float<Elt>(p));
      }
#pragma unroll
      for (int w = 1; w < kTX; w <<= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, w);
      l[i] = l[i] * corr + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kDs; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // acc += p v over this tile's keys, ascending
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = ps[(ty * kRows + i) * (BK + 1) + c];
#pragma unroll
      for (int e = 0; e < kDs; ++e) {
        const float vv = vs[c * D + tx + kTX * e];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][e] = fmaf(pv[i], vv, acc[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty * kRows + i;
    if (qi >= T) continue;
    const float safe_l = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int e = 0; e < kDs; ++e)
      o[base + (size_t)qi * D + tx + kTX * e] = from_float<Elt>(acc[i][e] / safe_l);
    if (tx == 0)
      lse[(size_t)blockIdx.y * T + qi] = l[i] == 0.f ? kNegInf : m[i] + logf(safe_l);
  }
}

template <typename Elt, int D, bool kCausal>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int bh, int T, float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<Elt, D, kCausal>;
  const int smem = smem_floats(D) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + kBQ - 1) / kBQ, bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const Elt*>(q), static_cast<const Elt*>(k),
      static_cast<const Elt*>(v), static_cast<Elt*>(o), lse, T, scale);
  return (int)cudaGetLastError();
}

template <typename Elt, int D>
int launch_entry(int causal, const void* q, const void* k, const void* v,
                 void* o, float* lse, int bh, int T, float scale,
                 cudaStream_t stream) {
  return causal ? launch<Elt, D, true>(q, k, v, o, lse, bh, T, scale, stream)
                : launch<Elt, D, false>(q, k, v, o, lse, bh, T, scale, stream);
}

// The FMA kernel's (dtype, d): float32 at D = 128, bfloat16 at D = 8, 16
// (float32 at D = 8, 16 and bfloat16 at D = 128 take the other designs)
template <typename Elt>
int launch_dim(int d, int causal, const void* q, const void* k, const void* v,
               void* o, float* lse, int bh, int T, float scale,
               cudaStream_t stream) {
  if constexpr (std::is_same<Elt, float>::value) {
    if (d == 128)
      return launch_entry<Elt, 128>(causal, q, k, v, o, lse, bh, T, scale, stream);
  } else {
    if (d == 8)
      return launch_entry<Elt, 8>(causal, q, k, v, o, lse, bh, T, scale, stream);
    if (d == 16)
      return launch_entry<Elt, 16>(causal, q, k, v, o, lse, bh, T, scale, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------------------------------
// The tensor-core kernel: bf16, D = 128
// ------------------------------------------------------------------------
namespace tc {

using namespace flash_tiles;
using hopper::fence_regs;

constexpr int kThreads = 256;  // two warpgroups of 64 query rows each
constexpr int kBQ = 128;       // query rows a block holds
constexpr int kBK = 64;        // key rows a step streams
// The ring of K/V tiles.  Step i holds three stages (the K of i + 1, the
// V of i - 1 and of i) and frees i - 1's at its end, for step
// i - 1 + kStages: with 3 the next step waits on a load just issued, and
// each stage past 3 keeps one more step of loads ahead.  Four is the
// fewest that ran as fast as five on an H100 (scripts/fwd_ring_depth.py
// times each depth; PERF.md has the reading).
constexpr int kStages = 4;
static_assert(kStages >= 3, "a step holds three K/V stages");

// A block's shared memory, in bytes from its 1024-aligned start: the Q
// tile; kStages stages of a K and a V tile; the barriers (Q, then one a
// stage); 1024 bytes of slack to align the start.
struct Smem {
  static constexpr uint32_t kStage0 = tile_bytes(kBQ);
  static constexpr uint32_t kStageBytes = 2 * tile_bytes(kBK);
  static constexpr uint32_t kBars = kStage0 + kStages * kStageBytes;
  static constexpr uint32_t kBytes = kBars + 8 * (1 + kStages) + 1024;
};

// The thread's 16 values of row h (h = 0, 1) of a [64 x 64] accumulator
// fragment, reduced pairwise by op: four dependent steps, not sixteen.
template <typename Op>
__device__ __forceinline__ float row_tree(const float (&s)[32], int h,
                                          Op op) {
  float t[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) t[j] = op(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]);
#pragma unroll
  for (int w = 4; w >= 1; w /= 2)
#pragma unroll
    for (int j = 0; j < w; ++j) t[j] = op(t[j], t[j + w]);
  return t[0];
}

// The online softmax of one step for one warpgroup, in registers: s, the
// scores Q K^T of keys [k0, k0 + 64) for the thread's rows row0 and
// row0 + 8 (h = 0, 1), becomes p in place; m and l move on, and corr is
// what the O accumulator's rows are to be scaled by.  kMask: the step
// straddles the diagonal or the ragged end, so pairs are tested one by
// one.  Every exp is computed and then selected, so that the compiler
// has no reason to branch around it.
template <bool kCausal, bool kMask>
__device__ __forceinline__ void softmax_step(float (&s)[32], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             int qa, int k0, int row0,
                                             int col0, int T, float scale) {
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    // rounded as the plain version rounds: s * scale, then - m
    const float x = __fmul_rn(s[e], scale);
    if (kMask) {
      const int qi = qa + row0 + acc_row(e), kj = k0 + col0 + acc_col(e);
      const bool live = qi < T && kj < T && (!kCausal || qi >= kj);
      s[e] = live ? x : kNegInf;
    } else {
      s[e] = x;
    }
  }
  const auto max_op = [](float a, float b) { return fmaxf(a, b); };
  const auto add_op = [](float a, float b) { return a + b; };
  float mx[2];
  bool alive[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(m[h], row_tree(s, h, max_op));
    // the row's other 48 columns are in the quad's other three lanes
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    alive[h] = mx[h] > kNegInf / 2;
    const float c = expf(m[h] - mx[h]);
    corr[h] = alive[h] ? c : 0.f;
  }
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int h = acc_row(e) / 8;
    const float p = expf(s[e] - mx[h]);
    s[e] = alive[h] ? p : 0.f;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = row_tree(s, h, add_op);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l[h] = __fmul_rn(l[h], corr[h]) + sum;
    m[h] = mx[h];
  }
}

template <bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                       int BH, int T, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t q_bar = base + Smem::kBars;
  // step i's stage: its K tile (its V tile follows) and its barrier
  auto stage_at = [&](int i) {
    return base + Smem::kStage0 + (i % kStages) * Smem::kStageBytes;
  };
  auto full_bar = [&](int i) { return q_bar + 8 * (1 + i % kStages); };

  // every head's last query tile (the most causal work) first
  const int nq = (T + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % BH;
  const int tile = blockIdx.x / BH;
  const int q0 = (kCausal ? nq - 1 - tile : tile) * kBQ;
  // keys [0, kv_end): the causal entry stops at the block's last row
  const int kv_end = kCausal ? min(q0 + kBQ, T) : T;
  const int n_steps = (kv_end + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_bar, 1);
    for (int i = 0; i < kStages; ++i) hopper::mbar_init(full_bar(i), 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // thread 0 streams k and v of step i into stage i % kStages
  auto load_step = [&](int i) {
    hopper::mbar_expect_tx(full_bar(i), Smem::kStageBytes);
    load_rows(stage_at(i), &k_map, kBK, i * kBK, bh, full_bar(i));
    load_rows(stage_at(i) + tile_bytes(kBK), &v_map, kBK, i * kBK, bh,
              full_bar(i));
  };
  if (threadIdx.x == 0) {
    hopper::mbar_expect_tx(q_bar, tile_bytes(kBQ));
    load_rows(base, &q_map, kBQ, q0, bh, q_bar);
    for (int i = 0; i < kStages && i < n_steps; ++i) load_step(i);
  }

  const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32;
  const int lane = threadIdx.x % 32;
  const int qa = q0 + 64 * wg;            // the warpgroup's first query row
  const int row0 = 16 * warp + lane / 4;  // the thread's rows: row0, +8
  const int col0 = 2 * (lane % 4);
  const uint32_t q_at = base + wg * 64 * kRow;
  // the warpgroup's steps with a live key: none when its rows start past
  // T; causal, none after the tile holding its diagonal
  const int n_live = qa >= T ? 0
                     : kCausal ? min(n_steps, qa / kBK + 1)
                               : n_steps;

  // s_a and s_b take turns: S of one step is softmaxed in one while the
  // next step's S lands in the other
  float o_acc[64], s_a[32], s_b[32], m[2], l[2];
  uint32_t pa[4][4];
#pragma unroll
  for (int e = 0; e < 64; ++e) o_acc[e] = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m[h] = kNegInf;
    l[h] = 0.f;
  }
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j) pa[t][j] = 0u;

  // Step i: issue S of step i + 1 and O += P V of step i - 1, run the
  // softmax of step i (its S is in s_cur) while both are in flight, then
  // scale O and make P of step i the A fragment.
  auto step = [&](int i, float (&s_cur)[32], float (&s_next)[32]) {
    const bool live = i < n_live;
    if (live || (i == n_live && i > 0)) {
      const bool next = i + 1 < n_live;
      if (next) hopper::mbar_wait(full_bar(i + 1), ((i + 1) / kStages) & 1);
      fence_regs(pa);
      fence_regs(o_acc);
      __syncwarp();
      hopper::wgmma_fence();
      if (next) scores<kBQ, kBK>(s_next, q_at, stage_at(i + 1));
      // the warpgroup's last P V comes in the step after its last live one
      if (i > 0) accumulate<kBK>(o_acc, pa, stage_at(i - 1) + tile_bytes(kBK));
      hopper::wgmma_commit();
      float corr[2] = {1.f, 1.f};
      if (live) {
        const int k0 = i * kBK;
        const bool edge =
            (kCausal && k0 + kBK - 1 > qa) || k0 + kBK > T || qa + 64 > T;
        if (edge)
          softmax_step<kCausal, true>(s_cur, m, l, corr, qa, k0, row0, col0,
                                      T, scale);
        else
          softmax_step<kCausal, false>(s_cur, m, l, corr, qa, k0, row0, col0,
                                       T, scale);
      }
      hopper::wgmma_wait<0>();
      fence_regs(o_acc);
      fence_regs(pa);
      fence_regs(s_next);
      // O now holds every step before this one
#pragma unroll
      for (int e = 0; e < 64; ++e) o_acc[e] *= corr[acc_row(e) / 8];
      // p is rounded to bf16 only here, as it becomes the A fragment
      if (live) {
#pragma unroll
        for (int e = 0; e < 32; e += 2)
          pa[e / 8][(e % 8) / 2] = hopper::pack_bf16(s_cur[e], s_cur[e + 1]);
      }
    }
    __syncthreads();  // both warpgroups are done with step i - 1's stage
    if (threadIdx.x == 0 && i >= 1 && i - 1 + kStages < n_steps) {
      hopper::fence_proxy_async();
      load_step(i - 1 + kStages);
    }
  };

  hopper::mbar_wait(q_bar, 0);
  if (n_live > 0) {  // S of step 0
    hopper::mbar_wait(full_bar(0), 0);
    __syncwarp();
    hopper::wgmma_fence();
    scores<kBQ, kBK>(s_a, q_at, stage_at(0));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    fence_regs(s_a);
  }
  for (int i = 0; i < n_steps; i += 2) {
    step(i, s_a, s_b);
    if (i + 1 < n_steps) step(i + 1, s_b, s_a);
  }
  if (n_live == n_steps && n_live > 0) {  // the last P V
    fence_regs(pa);
    fence_regs(o_acc);
    __syncwarp();
    hopper::wgmma_fence();
    accumulate<kBK>(o_acc, pa, stage_at(n_steps - 1) + tile_bytes(kBK));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    fence_regs(o_acc);
    fence_regs(pa);
  }

  // o = acc / l and lse = m + log(l); rows past T are not written
  const size_t head = (size_t)bh * T * kD;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = qa + row0 + 8 * h;
    if (qi >= T) continue;
    const float safe_l = l[h] == 0.f ? 1.f : l[h];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o + head + (size_t)qi * kD + 8 * j +
                                         col0) =
          __floats2bfloat162_rn(o_acc[4 * j + 2 * h] / safe_l,
                                o_acc[4 * j + 2 * h + 1] / safe_l);
    if (lane % 4 == 0)
      lse[(size_t)bh * T + qi] = l[h] == 0.f ? kNegInf : m[h] + logf(safe_l);
  }
}

template <bool kCausal>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int bh, int T, float scale, cudaStream_t stream) {
  if (misaligned(q) || misaligned(k) || misaligned(v))
    return (int)cudaErrorMisalignedAddress;
  CUtensorMap qm, km, vm;
  int err = hopper::bf16_rows_map(&qm, q, bh, T, kBQ);
  if (!err) err = hopper::bf16_rows_map(&km, k, bh, T, kBK);
  if (!err) err = hopper::bf16_rows_map(&vm, v, bh, T, kBK);
  if (err) return err;
  auto kernel = flash_fwd_wgmma_kernel<kCausal>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem::kBytes);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (T + kBQ - 1) / kBQ;
  kernel<<<tiles * bh, kThreads, Smem::kBytes, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), lse, bh, T, scale);
  return (int)cudaGetLastError();
}

}  // namespace tc

// ------------------------------------------------------------------------
// The split-TF32 kernel: float32, D = 8 and 16
// ------------------------------------------------------------------------
namespace tf32x3 {

using mma_tf32::as_a;
using mma_tf32::BFrag;
using mma_tf32::frag_at;
using mma_tf32::layout_a;
using mma_tf32::layout_b;
using mma_tf32::mma3;

constexpr int kThreads = 128;  // four warps
constexpr int kMT = 2;         // m16 query tiles a warp holds
constexpr int kWarpRows = 16 * kMT;
constexpr int kBQ = kThreads / 32 * kWarpRows;  // query rows a block holds
constexpr int kStep = 64;      // key rows a step streams
constexpr int kMinBlocks = 2;  // blocks an SM holds (registers <= 255)
constexpr float kLog2e = 1.4426950408889634f;

// The streamed K and V tiles (mma_tf32.cuh): K in layout A (S = Q K^T sums
// over d), V in layout B (O += P V sums over the keys).
template <int D>
using Stream = mma_tf32::Stream<D, kStep, kThreads, true, false, false, true>;

// A block's shared memory, in floats: the raw stage (the next step's K and
// V land there while a step runs), then two split buffers (a step reads
// one while the next is split into the other).
template <int D>
struct Smem {
  static constexpr int kBuf0 = Stream<D>::kRaw;
  static constexpr int kBuf = Stream<D>::kBuf;
  static constexpr int kBytes = 4 * (kBuf0 + 2 * kBuf);
};

// One key step for one warp: its kMT m16 query tiles (rows from qa, Q as
// hi/lo A fragments) against keys [k0, k0 + kStep) of split buffer `buf`.
// S = Q K^T lands in fresh registers, 8 keys a slice (element e of slice j
// of tile i: query row qa + 16 i + g + 8 (e / 2), key k0 + 8 j + 2 t + e %
// 2).  The online softmax runs there: a row's 64 keys lie in the 4 lanes of
// a quad.  P, split into hi and lo, is the A fragment of P V; the step's
// P V sum starts at 0 in registers and joins o as o * corr + sum, by IEEE
// ops, so the tensor cores' own accumulation covers one step.  kMask: the
// step straddles the diagonal or the ragged end, so pairs are tested one
// by one.
template <int D, bool kCausal, bool kMask>
__device__ __forceinline__ void fwd_step(float (&o)[kMT][D / 8][4],
                                         float (&m)[kMT][2],
                                         float (&l)[kMT][2],
                                         const uint32_t (&q_hi)[kMT][D / 8][4],
                                         const uint32_t (&q_lo)[kMT][D / 8][4],
                                         const float* buf, int qa, int k0,
                                         int T, float scale) {
  constexpr int NT = D / 8;
  constexpr int kJ = kStep / 8;
  const float* k_a = buf;
  const float* v_b = buf + Stream<D>::kLayout;
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;

  float s[kMT][kJ][4];
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      const BFrag kf = frag_at(k_a, layout_a<D>(8 * j + g, 4 * kk + t));
#pragma unroll
      for (int i = 0; i < kMT; ++i) mma3(s[i][j], q_hi[i][kk], q_lo[i][kk], kf);
    }
  }

  float corr[kMT][2];
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // rounded as the plain version rounds: s * scale, then - m
        const float x = __fmul_rn(s[i][j][e], scale);
        if (kMask) {
          const int qi = qa + 16 * i + g + 8 * (e / 2);
          const int kj = k0 + 8 * j + 2 * t + e % 2;
          s[i][j][e] = kj < T && (!kCausal || qi >= kj) ? x : kNegInf;
        } else {
          s[i][j][e] = x;
        }
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // the row's 16 values here as a tree, then the quad's other lanes
      float tree[kJ];
#pragma unroll
      for (int j = 0; j < kJ; ++j)
        tree[j] = fmaxf(s[i][j][2 * h], s[i][j][2 * h + 1]);
#pragma unroll
      for (int w = kJ / 2; w >= 1; w /= 2)
#pragma unroll
        for (int j = 0; j < w; ++j) tree[j] = fmaxf(tree[j], tree[j + w]);
      float mx = fmaxf(m[i][h], tree[0]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const bool alive = mx > kNegInf / 2;
      const float c = expf(m[i][h] - mx);
      corr[i][h] = alive ? c : 0.f;
      // every exp is computed and then selected, so that the compiler has
      // no reason to branch around it.  p = 2^((s - m) log2 e): the
      // product's rounding moves p by |s - m| 2^-24 relative (6e-7 at
      // s - m = -10), far inside O's 2e-5, and exp2f beside it costs less
      // than the accurate expf (scripts/fwd_tf32_variants.py, PERF.md)
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          const float p = exp2f((s[i][j][e] - mx) * kLog2e);
          s[i][j][e] = alive ? p : 0.f;
        }
#pragma unroll
      for (int j = 0; j < kJ; ++j) tree[j] = s[i][j][2 * h] + s[i][j][2 * h + 1];
#pragma unroll
      for (int w = kJ / 2; w >= 1; w /= 2)
#pragma unroll
        for (int j = 0; j < w; ++j) tree[j] += tree[j + w];
      float sum = tree[0];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      // l sums p in f32 before p is split
      l[i][h] = __fmul_rn(l[i][h], corr[i][h]) + sum;
      m[i][h] = mx;
    }
  }

  // O += P V over this step's keys, 8 a slice (row pair 4j + t holds keys
  // 8j + 2t and + 1, the keys of A slots t and t + 4)
  float o_step[kMT][NT][4] = {};
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    uint32_t pa_hi[kMT][4], pa_lo[kMT][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i) as_a(s[i][j], pa_hi[i], pa_lo[i]);
#pragma unroll
    for (int nn = 0; nn < NT; ++nn) {
      const BFrag vf = frag_at(v_b, layout_b<D>(4 * j + t, 8 * nn + g));
#pragma unroll
      for (int i = 0; i < kMT; ++i)
        mma3(o_step[i][nn], pa_hi[i], pa_lo[i], vf);
    }
  }
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int nn = 0; nn < NT; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[i][nn][e] = __fmul_rn(o[i][nn][e], corr[i][e / 2]) + o_step[i][nn][e];
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_fwd_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int BH, int T, float scale) {
  using S = Smem<D>;
  constexpr int NT = D / 8;
  extern __shared__ __align__(16) float smem[];
  const uint32_t raw0 = hopper::smem_u32(smem);

  // every head's last query tile (the most causal work) first
  const int nq = (T + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % BH;
  const int tile = blockIdx.x / BH;
  const int q0 = (kCausal ? nq - 1 - tile : tile) * kBQ;
  // keys [0, kv_end): the causal entry stops at the block's last row
  const int kv_end = kCausal ? min(q0 + kBQ, T) : T;
  const int n_steps = (kv_end + kStep - 1) / kStep;
  const size_t head = (size_t)bh * T * D;

  auto load = [&](int i) {
    Stream<D>::load(raw0, k + head, v + head, i * kStep, T, i < n_steps);
    mma_tf32::cp_async_commit();
  };
  load(0);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qa = q0 + kWarpRows * warp;  // the warp's first query row
  uint32_t q_hi[kMT][NT][4], q_lo[kMT][NT][4];
  mma_tf32::held_rows(q_hi, q_lo, q + head, qa, T);
  float o_acc[kMT][NT][4] = {}, m[kMT][2], l[kMT][2];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[i][h] = kNegInf;
      l[i][h] = 0.f;
    }

  for (int i = 0; i < n_steps; ++i) {
    const int k0 = i * kStep;
    float* buf = smem + S::kBuf0 + (i % 2) * S::kBuf;
    mma_tf32::cp_async_wait<0>();
    Stream<D>::split(smem, buf);
    // buf is whole, and every warp is past step i - 1, so buffer
    // (i + 1) % 2 may be rewritten; the raw stage is free (each thread
    // split its own copies), and step i + 1's copies land there while
    // step i runs
    __syncthreads();
    load(i + 1);
    // no live pair: query rows past T, or (causal) every key after every
    // query row
    const bool dead = qa >= T || (kCausal && k0 > qa + kWarpRows - 1);
    if (!dead) {
      const bool edge = (kCausal && k0 + kStep - 1 > qa) || k0 + kStep > T;
      if (edge)
        fwd_step<D, kCausal, true>(o_acc, m, l, q_hi, q_lo, buf, qa, k0, T,
                                   scale);
      else
        fwd_step<D, kCausal, false>(o_acc, m, l, q_hi, q_lo, buf, qa, k0, T,
                                    scale);
    }
  }

  // o = acc / l and lse = m + log(l); rows past T are not written
  const int g = lane / 4;
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float safe_l = l[i][h] == 0.f ? 1.f : l[i][h];
#pragma unroll
      for (int nn = 0; nn < NT; ++nn) {
        o_acc[i][nn][2 * h] /= safe_l;
        o_acc[i][nn][2 * h + 1] /= safe_l;
      }
      const int qi = qa + 16 * i + g + 8 * h;
      if (qi < T && lane % 4 == 0)
        lse[(size_t)bh * T + qi] =
            l[i][h] == 0.f ? kNegInf : m[i][h] + logf(safe_l);
    }
  mma_tf32::store_rows(o + head, o_acc, qa, T);
}

template <int D>
int launch(int causal, const void* q, const void* k, const void* v, void* o,
           float* lse, int bh, int T, float scale, cudaStream_t stream) {
  // cp.async copies 16-byte chunks: every [T][D] tensor starts on 16 bytes
  if (flash_tiles::misaligned(q) || flash_tiles::misaligned(k) ||
      flash_tiles::misaligned(v))
    return (int)cudaErrorMisalignedAddress;
  auto kernel = causal ? flash_fwd_mma_kernel<D, true>
                       : flash_fwd_mma_kernel<D, false>;
  constexpr int smem = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (T + kBQ - 1) / kBQ;
  kernel<<<tiles * bh, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, bh, T,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace tf32x3

using flash_tiles::fwd_design;

}  // namespace

// Flash forward on the given stream.  dtype: 0 float32, 1 bfloat16;
// d in {8, 16, 128}.  Returns 0 or the CUDA error of the launch.
extern "C" int iotml_flash_fwd(const void* q, const void* k, const void* v,
                               void* o, float* lse, int bh, int T, int d,
                               int dtype, int causal, float scale,
                               void* stream) {
  if (bh < 1 || bh > 65535 || T < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fwd_design(dtype, d)) {
    case flash_tiles::kWgmma:
      return causal ? tc::launch<true>(q, k, v, o, lse, bh, T, scale, s)
                    : tc::launch<false>(q, k, v, o, lse, bh, T, scale, s);
    case flash_tiles::kMmaTf32x3:
      return d == 8
                 ? tf32x3::launch<8>(causal, q, k, v, o, lse, bh, T, scale, s)
                 : tf32x3::launch<16>(causal, q, k, v, o, lse, bh, T, scale,
                                      s);
    default:
      break;
  }
  switch (dtype) {
    case 0: return launch_dim<float>(d, causal, q, k, v, o, lse, bh, T, scale, s);
    case 1: return launch_dim<__nv_bfloat16>(d, causal, q, k, v, o, lse, bh, T, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The design (d, dtype) runs: 0 the FMA kernel, 1 the wgmma one, 2 the
// split-TF32 one (flash_tiles::fwd_design); -1 for what the kernels are
// not built for.
extern "C" int iotml_flash_fwd_design(int d, int dtype) {
  if ((d != 8 && d != 16 && d != 128) || (dtype != 0 && dtype != 1))
    return -1;
  return fwd_design(dtype, d);
}

// Dynamic shared memory of one block, in bytes, at head dim d and dtype
// (0 float32, 1 bfloat16); -1 for what the kernels are not built for.
extern "C" int iotml_flash_fwd_smem(int d, int dtype) {
  switch (iotml_flash_fwd_design(d, dtype)) {
    case flash_tiles::kWgmma:
      return (int)tc::Smem::kBytes;
    case flash_tiles::kMmaTf32x3:
      return d == 8 ? tf32x3::Smem<8>::kBytes : tf32x3::Smem<16>::kBytes;
    case flash_tiles::kFma:
      return smem_floats(d) * (int)sizeof(float);
    default:
      return -1;
  }
}
