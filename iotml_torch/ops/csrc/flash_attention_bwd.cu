// Flash-attention backward for Hopper (sm_90a): dQ, dK and dV of
// O = softmax(Q K^T / sqrt(D)) V, causal or not, from the forward's
// per-row log-sum-exp, in two kernels.
//
// Replaces the TPU kernels iotml/ops/attention.py::_flash_bwd_dkv_kernel
// (:402, dense grid) and ::_flash_bwd_dkv_kernel_tri (:482, causal
// triangle) with flash_bwd_dkv_kernel, and ::_flash_bwd_dq_kernel (:447)
// and ::_flash_bwd_dq_kernel_tri (:518) with flash_bwd_dq_kernel; each
// has a causal and a full entry.  It computes what they compute
// (_bwd_common, :376), with their dtype policy, and is not carried over
// block by block.  The plain PyTorch version beside the wrapper
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
// T = 65,536, D = 128) operations bound it, not bytes.  The products run
// as fp32 FMA on the CUDA cores (67 TFLOP/s on an H100 SXM), not on the
// tensor cores (989 TFLOP/s bf16): for bf16 inputs that floor sits ~15x
// above the card's bound.  Closing it is later work (wgmma, TMA).
//
// What the design does about it.  Blocks of 128 threads (16 row groups x
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

template <typename Elt, typename F>
int pick_dim(int d, int causal, F f) {
  switch (d) {
    case 8: return pick_causal<Elt, 8>(causal, f);
    case 16: return pick_causal<Elt, 16>(causal, f);
    case 128: return pick_causal<Elt, 128>(causal, f);
    default: return (int)cudaErrorInvalidValue;
  }
}

// f(Type<Elt>, Variant<D, causal>) for the runtime dtype (0 float32,
// 1 bfloat16), head dim (8, 16, 128) and causal flag: 12 instantiations
template <typename F>
int dispatch(int bh, int T, int dtype, int d, int causal, F f) {
  if (bh < 1 || bh > 65535 || T < 1) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return pick_dim<float>(d, causal, f);
    case 1: return pick_dim<__nv_bfloat16>(d, causal, f);
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
  return dispatch(bh, T, dtype, d, causal, [&](auto elt, auto var) {
    using Elt = typename decltype(elt)::type;
    using V = decltype(var);
    return launch_dkv<Elt, V::kD, V::kCausal>(q, k, v, dout, lse, delta, dk,
                                              dv, bh, T, scale, s);
  });
}

// dQ on the given stream; arguments as iotml_flash_bwd_dkv.
extern "C" int iotml_flash_bwd_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  const float* delta, void* dq, int bh, int T,
                                  int d, int dtype, int causal, float scale,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(bh, T, dtype, d, causal, [&](auto elt, auto var) {
    using Elt = typename decltype(elt)::type;
    using V = decltype(var);
    return launch_dq<Elt, V::kD, V::kCausal>(q, k, v, dout, lse, delta, dq,
                                             bh, T, scale, s);
  });
}

// Dynamic shared memory of one block, in bytes: kind 0 the dK/dV kernel,
// 1 the dQ kernel; -1 for a head dim the kernels are not built for.
extern "C" int iotml_flash_bwd_smem(int d, int kind) {
  if (d != 8 && d != 16 && d != 128) return -1;
  return (kind == 0 ? dkv_smem_floats(d) : dq_smem_floats(d)) *
         (int)sizeof(float);
}
