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
// TFLOP/s, 4.447 ms without the mask.
//
// Two designs, chosen by (dtype, D) in iotml_flash_fwd below
// (tensor_core_design in flash_tiles.cuh, the backward's rule too;
// iotml_flash_fwd_design reports it):
// - bf16 at D = 128: the tensor-core kernel (namespace tc, below);
// - float32 (D = 8, 16, 128) and bf16 at D = 8, 16: the FMA kernel.
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
// Exactness, as the TPU kernels have it: scores are f32 sums of
// input-dtype products (exact in f32 for bf16), scaled after Q K^T;
// masked scores are NEG_INF = -1e30, not -inf; alive = m_new > NEG_INF/2
// guards both the correction and p; p is rounded to the input dtype
// before P V, with f32 accumulation; o = acc / (l == 0 ? 1 : l) and
// lse = l == 0 ? NEG_INF : m + log(l).  Sums run in a fixed order with no
// atomics, so runs repeat bit for bit.  Build without --use_fast_math:
// expf, logf and the division must be the accurate ones.  The
// tensor-core kernel keeps all of it: the scale is applied with
// __fmul_rn, so it cannot fuse into the subtraction of m; l sums p
// before p is rounded to bf16 in the A fragment.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "flash_tiles.cuh"
#include "hopper.cuh"

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

template <typename Elt>
int launch_dim(int d, int causal, const void* q, const void* k, const void* v,
               void* o, float* lse, int bh, int T, float scale,
               cudaStream_t stream) {
  switch (d) {
    case 8: return launch_entry<Elt, 8>(causal, q, k, v, o, lse, bh, T, scale, stream);
    case 16: return launch_entry<Elt, 16>(causal, q, k, v, o, lse, bh, T, scale, stream);
    case 128:
      // bf16 at D = 128 runs the tensor-core kernel, not this one
      if constexpr (std::is_same<Elt, float>::value)
        return launch_entry<Elt, 128>(causal, q, k, v, o, lse, bh, T, scale, stream);
      return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
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

using flash_tiles::tensor_core_design;

}  // namespace

// Flash forward on the given stream.  dtype: 0 float32, 1 bfloat16;
// d in {8, 16, 128}.  Returns 0 or the CUDA error of the launch.
extern "C" int iotml_flash_fwd(const void* q, const void* k, const void* v,
                               void* o, float* lse, int bh, int T, int d,
                               int dtype, int causal, float scale,
                               void* stream) {
  if (bh < 1 || bh > 65535 || T < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tensor_core_design(dtype, d))
    return causal ? tc::launch<true>(q, k, v, o, lse, bh, T, scale, s)
                  : tc::launch<false>(q, k, v, o, lse, bh, T, scale, s);
  switch (dtype) {
    case 0: return launch_dim<float>(d, causal, q, k, v, o, lse, bh, T, scale, s);
    case 1: return launch_dim<__nv_bfloat16>(d, causal, q, k, v, o, lse, bh, T, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// 1 where (d, dtype) runs the tensor-core kernel, 0 the FMA one, -1 for
// what the kernels are not built for.
extern "C" int iotml_flash_fwd_design(int d, int dtype) {
  if ((d != 8 && d != 16 && d != 128) || (dtype != 0 && dtype != 1))
    return -1;
  return tensor_core_design(dtype, d) ? 1 : 0;
}

// Dynamic shared memory of one block, in bytes, at head dim d and dtype
// (0 float32, 1 bfloat16); -1 for what the kernels are not built for.
extern "C" int iotml_flash_fwd_smem(int d, int dtype) {
  const int design = iotml_flash_fwd_design(d, dtype);
  if (design < 0) return -1;
  if (design == 1) return (int)tc::Smem::kBytes;
  return smem_floats(d) * (int)sizeof(float);
}
