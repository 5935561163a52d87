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
// operations bound it, not bytes.  This kernel does its products with
// fp32 FMA on the CUDA cores (67 TFLOP/s on an H100 SXM), not the tensor
// cores (989 TFLOP/s bf16): for bf16 inputs that floor sits ~15x above
// the card's bound.  Closing it is later work (wgmma, TMA).
//
// What the design does about it.  One block of 128 threads owns 64 query
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
// Exactness, as the TPU kernels have it: scores are f32 sums of
// input-dtype products (exact in f32 for bf16), scaled after Q K^T;
// masked scores are NEG_INF = -1e30, not -inf; alive = m_new > NEG_INF/2
// guards both the correction and p; p is rounded to the input dtype
// before P V, with f32 accumulation; o = acc / (l == 0 ? 1 : l) and
// lse = l == 0 ? NEG_INF : m + log(l).  Sums run in a fixed order with no
// atomics, so runs repeat bit for bit.  Build without --use_fast_math:
// expf, logf and the division must be the accurate ones.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
    case 128: return launch_entry<Elt, 128>(causal, q, k, v, o, lse, bh, T, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Flash forward on the given stream.  dtype: 0 float32, 1 bfloat16;
// d in {8, 16, 128}.  Returns 0 or the CUDA error of the launch.
extern "C" int iotml_flash_fwd(const void* q, const void* k, const void* v,
                               void* o, float* lse, int bh, int T, int d,
                               int dtype, int causal, float scale,
                               void* stream) {
  if (bh < 1 || bh > 65535 || T < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_dim<float>(d, causal, q, k, v, o, lse, bh, T, scale, s);
    case 1: return launch_dim<__nv_bfloat16>(d, causal, q, k, v, o, lse, bh, T, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
