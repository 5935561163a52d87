// Whole autoencoder fit in one launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel iotml/ops/fused_train.py::_fit_kernel.  One
// launch runs every epoch and every step of the fit: the 4-layer forward
// (tanh / relu / tanh / relu), masked MSE plus the L1 activity penalty,
// the Keras `out == x` accuracy, the hand-derived backward, and Adam on
// all eight parameter tensors, then writes the new parameters, moments
// and per-epoch mean loss and accuracy.  The arithmetic is the TPU
// kernel's, step for step; the plain PyTorch version beside the wrapper
// (iotml_torch/ops/fused_train.py::fused_fit_reference) repeats it.
//
// What bounds it on this card.  At batch 100 and 18 features a step is
// about 0.27 MFLOP of fp32 work and the whole slice is under 1 MB, so the
// whole-card bound (67 TFLOP/s fp32) is 8 us a fit.  That bound cannot be
// reached: each step depends on the last through the parameters, so the
// fit is a chain of epochs x S steps that one thread block runs on one
// SM.  The honest yardstick is one SM's fp32 rate (67 / 132 TFLOP/s):
// 1.07 ms for the reference fit, 0.53 us a step.  Within a step what one
// warp scheduler issues and waits for bounds it: each row's forward and
// delta chain is ~2,000 instructions, a third of them shared-memory
// weight loads whose results it waits on, and the gradient phase's
// shared-memory reads and Adam's divisions follow.
//
// Two designs; iotml_fused_fit_design below picks one by shape, and the
// wrapper's fit_design states the same rule.  Both replace _fit_kernel
// and keep the whole fit in one block's shared memory (parameters, Adam
// moments, the step's activations), so a step touches device memory only
// to read its batch (the stacked slice stays in L2).
//
// "rows" (fused_fit_rows_kernel, F = 18 or 30 with E = 14, H = 7 and
// B <= 256: the cardata and creditcard autoencoders).  Two barriers a
// step, from ten.
// - Rows phase.  Thread b of the 256 owns row b.  x, h1, h2, h3 and the
//   deltas stay in registers through the forward and the delta chain,
//   with no barrier between them; weights are read at warp-uniform
//   addresses (broadcast float4 loads of rows padded to four).  The
//   output layer, the loss terms, dz4 and dh3 = dz4 W4 are one pass over
//   each W4 row.  (Two threads a row, each taking half of every layer's
//   outputs and trading them by warp shuffle, was measured 13% slower.)
// - Prefetch.  The next step's row is copied to a second shared buffer by
//   cp.async and its mask and denominator loaded into registers while the
//   step runs; the denominators max(sum(m) F, 1) are summed once at the
//   start, a batch per thread, into the scratch buffer `denoms`.
// - Metrics.  The loss, accuracy and |h1| sums build up per thread and
//   are reduced once an epoch, by one warp, in a fixed order.
// - Gradient phase, after one barrier.  4 x 4 tiles of each layer's
//   [W | b] gradient (the bias is a column of ones on the input); the four
//   threads of a tile each sum a quarter of the batch, b ascending, and
//   two shuffles add the quarters in a fixed order, so a shared-memory
//   wavefront feeds twice the multiply-adds of a 1 x 4 tile.  Each thread
//   then takes one row of its tile through Adam, whose IEEE divisions and
//   root are kept off their slow paths (div_in_range, sqrt_in_range).
//   A second barrier ends the step.
//
// "elements" (fused_fit_kernel, every other shape).  Ten barriers a step:
// 1,024 threads, one per output element in each phase, every operand
// reloaded from shared memory, the parameter gradients one dependent
// 100-long chain per parameter.
//
// Both: products are plain fp32 FMA loops (no tensor cores, no TF32);
// sums run in a fixed order and no reduction uses atomics, so runs repeat
// bit for bit.
//
// Exactness, as the TPU kernel has it: the penalty divides by the batch
// size with masked rows included; sign(0) = 0 and the relu derivative is
// 0 at 0; the loss denominator is max(sum(mask) * F, 1) and the mask
// enters linearly; Adam's bias correction is 1 - exp(t * ln b) at
// t = t0 + step + 1; accuracy is exact float equality.  Build without
// --use_fast_math, which would change tanhf, expf, sqrtf and division.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 4;  // sum(m), sum|h1|, sum(diff^2 m), sum((out==x) m)

struct Hyper {
  float lr, l1, l1_over_b, inv_s;
  float b1, one_minus_b1, b2, one_minus_b2, eps, log_b1, log_b2;
};

// floats of dynamic shared memory the kernel uses (the layout below);
// Python reads it through iotml_fused_fit_smem
__host__ __device__ inline long long smem_floats(int B, int F, int E, int H) {
  const long long n = (long long)E * F + E + (long long)H * E + H +
                      (long long)H * H + H + (long long)F * H + F;
  return 3 * n + (long long)B * (2 * F + 2 * E + 4 * H) + B +
         kWarps * kSums;
}

// sum_b a[b * lda] * c[b * ldc], b ascending
__device__ inline float col_dot(const float* a, int lda, const float* c,
                                int ldc, int B) {
  float acc = 0.f;
  for (int b = 0; b < B; ++b) acc = fmaf(a[b * lda], c[b * ldc], acc);
  return acc;
}

__device__ inline float col_sum(const float* a, int lda, int B) {
  float acc = 0.f;
  for (int b = 0; b < B; ++b) acc += a[b * lda];
  return acc;
}

__global__ void __launch_bounds__(kThreads)
fused_fit_kernel(const float* __restrict__ xs, const float* __restrict__ masks,
                 const float* __restrict__ p_in,
                 const float* __restrict__ m_in,
                 const float* __restrict__ v_in, float* __restrict__ p_out,
                 float* __restrict__ m_out, float* __restrict__ v_out,
                 float* __restrict__ losses, float* __restrict__ accs, int S,
                 int B, int F, int E, int H, int epochs, int t0, Hyper hp) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  // parameter layout, nn.Linear order: weight [out, in], then bias
  const int oW1 = 0, oB1 = oW1 + E * F, oW2 = oB1 + E, oB2 = oW2 + H * E,
            oW3 = oB2 + H, oB3 = oW3 + H * H, oW4 = oB3 + H,
            oB4 = oW4 + F * H, n = oB4 + F;
  float* P = smem;
  float* M = P + n;
  float* V = M + n;
  float* sx = V + n;        // [B, F] this step's batch
  float* sm = sx + B * F;   // [B]    its mask
  float* h1 = sm + B;       // [B, E] tanh
  float* h2 = h1 + B * E;   // [B, H] relu
  float* h3 = h2 + B * H;   // [B, H] tanh
  float* so = h3 + B * H;   // [B, F] relu output, then dz4 in place
  float* d3 = so + B * F;   // [B, H] dz3
  float* d2 = d3 + B * H;   // [B, H] dz2
  float* d1 = d2 + B * H;   // [B, E] dz1
  float* red = d1 + B * E;  // [kWarps, kSums] per-warp partial sums

  for (int q = tid; q < n; q += kThreads) {
    P[q] = p_in[q];
    M[q] = m_in[q];
    V[q] = v_in[q];
  }

  const int total = epochs * S;
  const float fF = (float)F, fB = (float)B;
  float loss_sum = 0.f, acc_sum = 0.f;  // thread 0's running epoch sums

  for (int i = 0; i < total; ++i) {
    const int s = i % S;
    const float* xg = xs + (size_t)s * B * F;
    const float* mg = masks + (size_t)s * B;
    for (int q = tid; q < B * F; q += kThreads) sx[q] = xg[q];
    for (int b = tid; b < B; b += kThreads) sm[b] = mg[b];
    __syncthreads();

    // ---- forward
    float habs = 0.f;
    for (int q = tid; q < B * E; q += kThreads) {
      const int b = q / E, j = q - b * E;
      const float* xr = sx + b * F;
      const float* w = P + oW1 + j * F;
      float acc = 0.f;
      for (int k = 0; k < F; ++k) acc = fmaf(xr[k], w[k], acc);
      const float h = tanhf(acc + P[oB1 + j]);
      h1[q] = h;
      habs += fabsf(h);
    }
    __syncthreads();
    for (int q = tid; q < B * H; q += kThreads) {
      const int b = q / H, j = q - b * H;
      const float* hr = h1 + b * E;
      const float* w = P + oW2 + j * E;
      float acc = 0.f;
      for (int k = 0; k < E; ++k) acc = fmaf(hr[k], w[k], acc);
      h2[q] = fmaxf(acc + P[oB2 + j], 0.f);
    }
    __syncthreads();
    for (int q = tid; q < B * H; q += kThreads) {
      const int b = q / H, j = q - b * H;
      const float* hr = h2 + b * H;
      const float* w = P + oW3 + j * H;
      float acc = 0.f;
      for (int k = 0; k < H; ++k) acc = fmaf(hr[k], w[k], acc);
      h3[q] = tanhf(acc + P[oB3 + j]);
    }
    __syncthreads();
    float sq = 0.f, eq = 0.f, msum = 0.f;
    for (int q = tid; q < B * F; q += kThreads) {
      const int b = q / F, j = q - b * F;
      const float* hr = h3 + b * H;
      const float* w = P + oW4 + j * H;
      float acc = 0.f;
      for (int k = 0; k < H; ++k) acc = fmaf(hr[k], w[k], acc);
      const float o = fmaxf(acc + P[oB4 + j], 0.f);
      so[q] = o;
      const float d = o - sx[q];
      sq += d * d * sm[b];
      eq += (o == sx[q]) ? sm[b] : 0.f;
    }
    for (int b = tid; b < B; b += kThreads) msum += sm[b];

    // ---- the four sums: warp butterfly, then warps in order
    float v[kSums] = {msum, habs, sq, eq};
#pragma unroll
    for (int c = 0; c < kSums; ++c)
      for (int off = 16; off > 0; off >>= 1)
        v[c] += __shfl_xor_sync(0xffffffffu, v[c], off);
    if (lane == 0)
      for (int c = 0; c < kSums; ++c) red[warp * kSums + c] = v[c];
    __syncthreads();
    float tot[kSums] = {0.f, 0.f, 0.f, 0.f};
    for (int w = 0; w < kWarps; ++w)
      for (int c = 0; c < kSums; ++c) tot[c] += red[w * kSums + c];
    const float denom = fmaxf(tot[0] * fF, 1.f);
    if (tid == 0) {
      loss_sum += tot[2] / denom + (hp.l1 * tot[1]) / fB;
      acc_sum += tot[3] / denom;
      if ((i + 1) % S == 0) {
        const int e = i / S;
        losses[e] = loss_sum * hp.inv_s;
        accs[e] = acc_sum * hp.inv_s;
        loss_sum = 0.f;
        acc_sum = 0.f;
      }
    }

    // ---- backward: the delta chain reads the pre-update weights
    const float two_over_denom = 2.f / denom;
    for (int q = tid; q < B * F; q += kThreads) {
      const float o = so[q];
      const float g = two_over_denom * (o - sx[q]) * sm[q / F];
      so[q] = (o > 0.f) ? g : 0.f;  // dz4
    }
    __syncthreads();
    for (int q = tid; q < B * H; q += kThreads) {
      const int b = q / H, k = q - b * H;
      const float* dr = so + b * F;
      float acc = 0.f;
      for (int j = 0; j < F; ++j) acc = fmaf(dr[j], P[oW4 + j * H + k], acc);
      const float h = h3[q];
      d3[q] = acc * (1.f - h * h);
    }
    __syncthreads();
    for (int q = tid; q < B * H; q += kThreads) {
      const int b = q / H, k = q - b * H;
      const float* dr = d3 + b * H;
      float acc = 0.f;
      for (int j = 0; j < H; ++j) acc = fmaf(dr[j], P[oW3 + j * H + k], acc);
      d2[q] = (h2[q] > 0.f) ? acc : 0.f;
    }
    __syncthreads();
    for (int q = tid; q < B * E; q += kThreads) {
      const int b = q / E, k = q - b * E;
      const float* dr = d2 + b * H;
      float acc = 0.f;
      for (int j = 0; j < H; ++j) acc = fmaf(dr[j], P[oW2 + j * E + k], acc);
      const float h = h1[q];
      const float sg = (float)((h > 0.f) - (h < 0.f));  // sign(0) = 0
      d1[q] = (acc + hp.l1_over_b * sg) * (1.f - h * h);
    }
    __syncthreads();

    // ---- parameter gradients + Adam, one thread per parameter
    const float t = (float)(t0 + i + 1);
    const float c1 = 1.f - expf(t * hp.log_b1);
    const float c2 = 1.f - expf(t * hp.log_b2);
    for (int q = tid; q < n; q += kThreads) {
      float g;
      if (q < oB1) {
        const int j = q / F, k = q - j * F;
        g = col_dot(d1 + j, E, sx + k, F, B);
      } else if (q < oW2) {
        g = col_sum(d1 + (q - oB1), E, B);
      } else if (q < oB2) {
        const int r = q - oW2, j = r / E, k = r - j * E;
        g = col_dot(d2 + j, H, h1 + k, E, B);
      } else if (q < oW3) {
        g = col_sum(d2 + (q - oB2), H, B);
      } else if (q < oB3) {
        const int r = q - oW3, j = r / H, k = r - j * H;
        g = col_dot(d3 + j, H, h2 + k, H, B);
      } else if (q < oW4) {
        g = col_sum(d3 + (q - oB3), H, B);
      } else if (q < oB4) {
        const int r = q - oW4, j = r / H, k = r - j * H;
        g = col_dot(so + j, F, h3 + k, H, B);
      } else {
        g = col_sum(so + (q - oB4), F, B);
      }
      const float mk = hp.b1 * M[q] + hp.one_minus_b1 * g;
      const float vk = hp.b2 * V[q] + hp.one_minus_b2 * g * g;
      M[q] = mk;
      V[q] = vk;
      P[q] = P[q] - hp.lr * (mk / c1) / (sqrtf(vk / c2) + hp.eps);
    }
    __syncthreads();  // next step's batch load overwrites sx
  }

  for (int q = tid; q < n; q += kThreads) {
    p_out[q] = P[q];
    m_out[q] = M[q];
    v_out[q] = V[q];
  }
}

// ------------------------------------------------------------- "rows"
namespace rows {

constexpr int kRowsThreads = 256;  // the block, and its largest batch
constexpr int kReduceWarp = kRowsThreads / 32 - 1;
constexpr int kMetrics = 3;  // per thread: sum (d^2 m)/denom, (o==x) m/denom, |h1|

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// Stride of a [B][w] tile written one row per thread with float4 stores:
// an odd count of float4s, so eight neighbouring rows land on eight
// distinct 16-byte bank groups.
__host__ __device__ constexpr int row_stride(int w) {
  return (round4(w) / 4) % 2 ? round4(w) : round4(w) + 4;
}

template <int F, int E, int H>
struct Shape {
  // a layer's parameters [out][kW], kW = in + 1 padded to four, its bias
  // in column `in`, padding at 0 (its gradient is 0, so Adam keeps it 0)
  static constexpr int kW1 = round4(F + 1), kW2 = round4(E + 1),
                       kW3 = round4(H + 1), kW4 = round4(H + 1);
  static constexpr int oW1 = 0, oW2 = oW1 + E * kW1, oW3 = oW2 + H * kW2,
                       oW4 = oW3 + H * kW3, kParams = oW4 + F * kW4;
  // per row: each layer's input with a 1 appended (h1, h2, h3; x twice,
  // this step's and the next one's), the deltas dz1..dz4
  static constexpr int sX = row_stride(F + 1), sA1 = row_stride(E + 1),
                       sA2 = row_stride(H + 1), sA3 = sA2;
  static constexpr int sD1 = row_stride(E), sD2 = row_stride(H), sD3 = sD2,
                       sD4 = row_stride(F);
  static constexpr int kRowFloats =
      2 * sX + sA1 + sA2 + sA3 + sD1 + sD2 + sD3 + sD4;
  // gradient tiles: 4 outputs x 4 inputs of one layer's [W | b]
  static constexpr int kTiles1 = round4(E) / 4 * (kW1 / 4),
                       kTiles2 = round4(H) / 4 * (kW2 / 4),
                       kTiles3 = round4(H) / 4 * (kW3 / 4),
                       kTiles4 = round4(F) / 4 * (kW4 / 4),
                       kTiles = kTiles1 + kTiles2 + kTiles3 + kTiles4;

  // floats of dynamic shared memory at batch B: P, M, V; the rows'
  // activations and deltas; the per-thread metric sums
  static long long smem_floats(int B) {
    return 3LL * kParams + (long long)B * kRowFloats +
           kMetrics * kRowsThreads;
  }
};

// index in the flat nn.Linear vector (weights [out, in] then bias) of
// padded slot q of one layer, or -1 for padding
__device__ inline int flat_of(int q, int kW, int in, int w_flat,
                              int b_flat) {
  const int j = q / kW, c = q - j * kW;
  return c < in ? w_flat + j * in + c : (c == in ? b_flat + j : -1);
}

template <int F, int E, int H>
__device__ inline int flat_index(int q) {
  using L = Shape<F, E, H>;
  constexpr int w1 = 0, b1 = w1 + E * F, w2 = b1 + E, b2 = w2 + H * E,
                w3 = b2 + H, b3 = w3 + H * H, w4 = b3 + H, b4 = w4 + F * H;
  if (q < L::oW2) return flat_of(q - L::oW1, L::kW1, F, w1, b1);
  if (q < L::oW3) return flat_of(q - L::oW2, L::kW2, E, w2, b2);
  if (q < L::oW4) return flat_of(q - L::oW3, L::kW3, H, w3, b3);
  return flat_of(q - L::oW4, L::kW4, H, w4, b4);
}

// sum_k in[k] * w[k], k ascending, and the bias w[IN], from one padded
// parameter row read as float4 broadcasts
template <int IN, int KW>
__device__ inline float row_dot(const float* w, const float (&in)[IN],
                                float& bias) {
  const float4* w4 = reinterpret_cast<const float4*>(w);
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < KW / 4; ++c) {
    const float4 q = w4[c];
    const float e[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = 4 * c + u;
      if (k < IN) acc = fmaf(in[k], e[u], acc);
      else if (k == IN) bias = e[u];
    }
  }
  return acc;
}

// a layer's pre-activations: z[j] = sum_k in[k] W[j][k] + b[j]
template <int IN, int KW, int OUT>
__device__ inline void layer(const float* w, const float (&in)[IN],
                             float (&z)[OUT]) {
#pragma unroll
  for (int j = 0; j < OUT; ++j) {
    float bias = 0.f;
    const float acc = row_dot<IN, KW>(w + j * KW, in, bias);
    z[j] = acc + bias;
  }
}

// dh[k] = sum_j dz[j] W[j][k], j ascending (the transposed product)
template <int OUT, int IN, int KW>
__device__ inline void back(const float* w, const float (&dz)[OUT],
                            float (&dh)[IN]) {
#pragma unroll
  for (int k = 0; k < IN; ++k) dh[k] = 0.f;
#pragma unroll
  for (int j = 0; j < OUT; ++j) {
    const float4* w4 = reinterpret_cast<const float4*>(w + j * KW);
#pragma unroll
    for (int c = 0; c < (IN + 3) / 4; ++c) {
      const float4 q = w4[c];
      const float e[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (4 * c + u < IN) dh[4 * c + u] = fmaf(dz[j], e[u], dh[4 * c + u]);
    }
  }
}

// v[0..N), then `tail`, then 0 up to W, as float4 stores
template <int N, int W>
__device__ inline void store_row(float* dst, const float (&v)[N],
                                 float tail = 0.f) {
#pragma unroll
  for (int c = 0; c < W / 4; ++c) {
    float e[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = 4 * c + u;
      e[u] = k < N ? v[k] : (k == N ? tail : 0.f);
    }
    reinterpret_cast<float4*>(dst)[c] = make_float4(e[0], e[1], e[2], e[3]);
  }
}

// Gradient tile t: columns j0..j0+3 of one layer's deltas (a [B][ds]
// tile, padded to four columns with 0), columns c0..c0+3 of its inputs (a
// [B][is] tile), the parameter slot of (j0, c0), the parameter row length
// and how many of the four rows are outputs.
struct Tile {
  const float* dz;
  const float* in;
  int ds, is, off, kw, rows;
};

template <int F, int E, int H>
__device__ inline Tile tile_of(int t, const float* X, const float* A1,
                               int B) {
  using L = Shape<F, E, H>;
  const float* A2 = A1 + B * L::sA1;
  const float* A3 = A2 + B * L::sA2;
  const float* D1 = A3 + B * L::sA3;
  const float* D2 = D1 + B * L::sD1;
  const float* D3 = D2 + B * L::sD2;
  const float* D4 = D3 + B * L::sD3;
  if (t < L::kTiles1) {
    const int j = 4 * (t / (L::kW1 / 4)), c = 4 * (t % (L::kW1 / 4));
    return {D1 + j, X + c, L::sD1, L::sX, L::oW1 + j * L::kW1 + c, L::kW1,
            min(4, E - j)};
  }
  if ((t -= L::kTiles1) < L::kTiles2) {
    const int j = 4 * (t / (L::kW2 / 4)), c = 4 * (t % (L::kW2 / 4));
    return {D2 + j, A1 + c, L::sD2, L::sA1, L::oW2 + j * L::kW2 + c, L::kW2,
            min(4, H - j)};
  }
  if ((t -= L::kTiles2) < L::kTiles3) {
    const int j = 4 * (t / (L::kW3 / 4)), c = 4 * (t % (L::kW3 / 4));
    return {D3 + j, A2 + c, L::sD3, L::sA2, L::oW3 + j * L::kW3 + c, L::kW3,
            min(4, H - j)};
  }
  t -= L::kTiles3;
  const int j = 4 * (t / (L::kW4 / 4)), c = 4 * (t % (L::kW4 / 4));
  return {D4 + j, A3 + c, L::sD4, L::sA3, L::oW4 + j * L::kW4 + c, L::kW4,
          min(4, F - j)};
}

// a 4-byte copy from device to shared memory that the thread waits for
// later (copy_async_wait), without a register in between
__device__ inline void copy_async(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ inline void copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// x / y, IEEE, for y in [2^-30, 2] (c1, c2, Adam's denominator), kept off
// the division's slow path, which a branch would take in one lane and the
// whole warp wait for: a zero x gives itself, an x below 2^-100 in
// magnitude is scaled by 2^64 and the quotient back, exactly unless the
// quotient is subnormal.  Parameters whose gradient stays 0 (a dead unit,
// a zeroed input column, the padding) drive m there within ~800 steps.
__device__ inline float div_in_range(float x, float y) {
  const bool tiny = fabsf(x) < 0x1p-100f;
  const float q = (tiny ? (x == 0.f ? 1.f : x * 0x1p64f) : x) / y;
  return tiny ? (x == 0.f ? x : q * 0x1p-64f) : q;
}

// sqrtf(x), x >= 0, off its slow path likewise (scaling by 2^64 is exact
// here: the root of any positive float is normal)
__device__ inline float sqrt_in_range(float x) {
  const bool tiny = x < 0x1p-100f;
  const float r = sqrtf(tiny ? (x == 0.f ? 1.f : x * 0x1p64f) : x);
  return tiny ? (x == 0.f ? x : r * 0x1p-32f) : r;
}

__device__ inline void adam(float& p, float& m, float& v, float g,
                            float c1, float c2, const Hyper& hp) {
  m = hp.b1 * m + hp.one_minus_b1 * g;
  v = hp.b2 * v + hp.one_minus_b2 * g * g;
  // p - lr * (m / c1) / (sqrt(v / c2) + eps)
  p = p - div_in_range(hp.lr * div_in_range(m, c1),
                       sqrt_in_range(div_in_range(v, c2)) + hp.eps);
}

template <int F, int E, int H>
__global__ void __launch_bounds__(kRowsThreads, 1)
fused_fit_rows_kernel(const float* __restrict__ xs,
                      const float* __restrict__ masks,
                      const float* __restrict__ p_in,
                      const float* __restrict__ m_in,
                      const float* __restrict__ v_in,
                      float* __restrict__ p_out, float* __restrict__ m_out,
                      float* __restrict__ v_out, float* __restrict__ losses,
                      float* __restrict__ accs, float* denoms, int S, int B,
                      int epochs, int t0, Hyper hp) {
  using L = Shape<F, E, H>;
  extern __shared__ float4 smem4[];
  float* P = reinterpret_cast<float*>(smem4);
  float* M = P + L::kParams;
  float* V = M + L::kParams;
  float* A1 = V + L::kParams;  // [B][sA1] h1, 1
  float* A2 = A1 + B * L::sA1;  // [B][sA2] h2, 1
  float* A3 = A2 + B * L::sA2;  // [B][sA3] h3, 1
  float* D1 = A3 + B * L::sA3;  // [B][sD1] dz1
  float* D2 = D1 + B * L::sD1;  // [B][sD2] dz2
  float* D3 = D2 + B * L::sD2;  // [B][sD3] dz3
  float* D4 = D3 + B * L::sD3;  // [B][sD4] dz4
  float* Xs = D4 + B * L::sD4;  // [2][B][sX] x, 1: step i in Xs[i % 2]
  float* red = Xs + 2 * B * L::sX;  // [kMetrics][kRowsThreads]
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  for (int q = tid; q < L::kParams; q += kRowsThreads) {
    const int src = flat_index<F, E, H>(q);
    P[q] = src < 0 ? 0.f : p_in[src];
    M[q] = src < 0 ? 0.f : m_in[src];
    V[q] = src < 0 ? 0.f : v_in[src];
  }
  // batch s's loss denominator, the same in every epoch: b ascending
  for (int s = tid; s < S; s += kRowsThreads) {
    const float* mg = masks + (size_t)s * B;
    float sum = 0.f;
    for (int b = 0; b < B; ++b) sum += mg[b];
    denoms[s] = fmaxf(sum * (float)F, 1.f);
  }
  __syncthreads();

  // rows phase: thread r < B owns row r
  const int r = tid;
  const bool row = r < B;
  const int total = epochs * S;
  const float fB = (float)B;
  // the next step's row (copied to shared memory), mask and denominator,
  // loaded a step ahead; the 1 and the padding after x are set once
  float mn = 0.f, dnn = 1.f;
  if (row) {
    for (int k = F; k < L::kW1; ++k)
      Xs[r * L::sX + k] = Xs[(B + r) * L::sX + k] = k == F ? 1.f : 0.f;
#pragma unroll
    for (int k = 0; k < F; ++k)
      copy_async(Xs + r * L::sX + k, xs + (size_t)r * F + k);
    mn = masks[r];
    dnn = __ldcg(denoms);
  }
  float lsum = 0.f, asum = 0.f, hsum = 0.f;  // this thread's epoch sums

  for (int i = 0; i < total; ++i) {
    const bool epoch_end = (i + 1) % S == 0;
    const float* X = Xs + (i & 1) * B * L::sX;
    if (row) {
      copy_async_wait();
      float x[F];
      {
        const float4* x4 = reinterpret_cast<const float4*>(X + r * L::sX);
#pragma unroll
        for (int c = 0; c < L::kW1 / 4; ++c) {
          const float4 q = x4[c];
          const float e[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (4 * c + u < F) x[4 * c + u] = e[u];
        }
      }
      const float m = mn, dn = dnn;
      if (i + 1 < total) {
        // into the other buffer, which the last step's gradients read
        const int s = (i + 1) % S;
        const float* xg = xs + ((size_t)s * B + r) * F;
        float* xn = Xs + (((i + 1) & 1) * B + r) * L::sX;
#pragma unroll
        for (int k = 0; k < F; ++k) copy_async(xn + k, xg + k);
        mn = masks[(size_t)s * B + r];
        dnn = __ldcg(denoms + s);
      }

      // ---- forward, in registers
      float h1[E], h2[H], h3[H];
      float habs = 0.f;
      layer<F, L::kW1, E>(P + L::oW1, x, h1);
#pragma unroll
      for (int j = 0; j < E; ++j) {
        h1[j] = tanhf(h1[j]);
        habs += fabsf(h1[j]);
      }
      layer<E, L::kW2, H>(P + L::oW2, h1, h2);
#pragma unroll
      for (int j = 0; j < H; ++j) h2[j] = fmaxf(h2[j], 0.f);
      layer<H, L::kW3, H>(P + L::oW3, h2, h3);
#pragma unroll
      for (int j = 0; j < H; ++j) h3[j] = tanhf(h3[j]);

      // ---- the output layer, fused with the loss and accuracy terms, dz4
      // and dh3 = dz4 W4, so each W4 row is read once and neither the
      // output nor dz4 is held whole; x is read again, four at a time
      const float* xrow = X + r * L::sX;
      float* d4row = D4 + r * L::sD4;
      const float two_over_denom = 2.f / dn;
      float sq = 0.f, eq = 0.f, dh3[H], xq[4], dq[4];
#pragma unroll
      for (int k = 0; k < H; ++k) dh3[k] = 0.f;
#pragma unroll
      for (int j = 0; j < F; ++j) {
        if (j % 4 == 0) {
          const float4 q = reinterpret_cast<const float4*>(xrow)[j / 4];
          xq[0] = q.x, xq[1] = q.y, xq[2] = q.z, xq[3] = q.w;
        }
        const float* w = P + L::oW4 + j * L::kW4;
        float bias = 0.f;
        const float o = fmaxf(row_dot<H, L::kW4>(w, h3, bias) + bias, 0.f);
        const float xj = xq[j % 4];
        const float d = o - xj;
        sq += d * d * m;
        eq += (o == xj) ? m : 0.f;
        const float dz4 = o > 0.f ? two_over_denom * d * m : 0.f;
#pragma unroll
        for (int k = 0; k < H; ++k) dh3[k] = fmaf(dz4, w[k], dh3[k]);
        dq[j % 4] = dz4;
        if (j % 4 == 3 || j == F - 1)
          reinterpret_cast<float4*>(d4row)[j / 4] =
              make_float4(dq[0], j % 4 > 0 ? dq[1] : 0.f,
                          j % 4 > 1 ? dq[2] : 0.f, j % 4 > 2 ? dq[3] : 0.f);
      }
      lsum += sq / dn;
      asum += eq / dn;
      hsum += habs;

      // ---- the rest of the delta chain, on the pre-update weights
      float dz3[H], dz2[H], dz1[E];
#pragma unroll
      for (int k = 0; k < H; ++k) dz3[k] = dh3[k] * (1.f - h3[k] * h3[k]);
      back<H, H, L::kW3>(P + L::oW3, dz3, dz2);
#pragma unroll
      for (int k = 0; k < H; ++k) dz2[k] = (h2[k] > 0.f) ? dz2[k] : 0.f;
      back<H, E, L::kW2>(P + L::oW2, dz2, dz1);
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const float g = h1[k];
        const float sg = (float)((g > 0.f) - (g < 0.f));  // sign(0) = 0
        dz1[k] = (dz1[k] + hp.l1_over_b * sg) * (1.f - g * g);
      }

      store_row<E, L::kW2>(A1 + r * L::sA1, h1, 1.f);
      store_row<H, L::kW3>(A2 + r * L::sA2, h2, 1.f);
      store_row<H, L::kW4>(A3 + r * L::sA3, h3, 1.f);
      store_row<E, round4(E)>(D1 + r * L::sD1, dz1);
      store_row<H, round4(H)>(D2 + r * L::sD2, dz2);
      store_row<H, round4(H)>(D3 + r * L::sD3, dz3);
      if (epoch_end) {
        red[tid] = lsum;
        red[kRowsThreads + tid] = asum;
        red[2 * kRowsThreads + tid] = hsum;
        lsum = asum = hsum = 0.f;
      }
    }
    __syncthreads();  // 1: activations and deltas in, weights all read

    // ---- the epoch's loss and accuracy: threads in a fixed order, off
    // the step's critical path
    if (epoch_end && warp == kReduceWarp) {
      float v[kMetrics] = {0.f, 0.f, 0.f};
      for (int t = lane; t < B; t += 32)
#pragma unroll
        for (int c = 0; c < kMetrics; ++c) v[c] += red[c * kRowsThreads + t];
#pragma unroll
      for (int c = 0; c < kMetrics; ++c)
        for (int off = 16; off > 0; off >>= 1)
          v[c] += __shfl_xor_sync(0xffffffffu, v[c], off);
      if (lane == 0) {
        const int e = i / S;
        losses[e] = (v[0] + (hp.l1 * v[2]) / fB) * hp.inv_s;
        accs[e] = v[1] * hp.inv_s;
      }
    }

    // ---- gradient tiles.  Lanes l, l^8, l^16, l^24 of a warp share a
    // 4 x 4 tile, each summing one quarter of the batch, b ascending; two
    // shuffles add the quarters as ((q0 + q1) + (q2 + q3)) on all four.
    // Then quarter q takes row q of the tile through Adam.
    for (int base = warp * 8; base < L::kTiles; base += kRowsThreads / 4) {
      const int q = lane >> 3, t = base + (lane & 7);
      const bool live = t < L::kTiles;
      const Tile tile = tile_of<F, E, H>(live ? t : 0, X, A1, B);
      const int chunk = (B + 3) / 4;
      const int b0 = live ? q * chunk : B, b1 = min(B, b0 + chunk);
      float g[4][4] = {};
#pragma unroll 2
      for (int b = b0; b < b1; ++b) {
        const float4 d = *reinterpret_cast<const float4*>(tile.dz + b * tile.ds);
        const float4 a = *reinterpret_cast<const float4*>(tile.in + b * tile.is);
        const float dv[4] = {d.x, d.y, d.z, d.w}, av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) g[r][c] = fmaf(dv[r], av[c], g[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          g[r][c] += __shfl_xor_sync(0xffffffffu, g[r][c], 8);
          g[r][c] += __shfl_xor_sync(0xffffffffu, g[r][c], 16);
        }
      if (!live || q >= tile.rows) continue;
      float gq[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        gq[c] = q == 0 ? g[0][c] : q == 1 ? g[1][c] : q == 2 ? g[2][c] : g[3][c];
      const int off = tile.off + q * tile.kw;
      const float tt = (float)(t0 + i + 1);
      const float c1 = 1.f - expf(tt * hp.log_b1);
      const float c2 = 1.f - expf(tt * hp.log_b2);
      float4 p4 = *reinterpret_cast<float4*>(P + off);
      float4 m4 = *reinterpret_cast<float4*>(M + off);
      float4 v4 = *reinterpret_cast<float4*>(V + off);
      adam(p4.x, m4.x, v4.x, gq[0], c1, c2, hp);
      adam(p4.y, m4.y, v4.y, gq[1], c1, c2, hp);
      adam(p4.z, m4.z, v4.z, gq[2], c1, c2, hp);
      adam(p4.w, m4.w, v4.w, gq[3], c1, c2, hp);
      *reinterpret_cast<float4*>(P + off) = p4;
      *reinterpret_cast<float4*>(M + off) = m4;
      *reinterpret_cast<float4*>(V + off) = v4;
    }
    __syncthreads();  // 2: parameters updated, activations free
  }

  for (int q = tid; q < L::kParams; q += kRowsThreads) {
    const int dst = flat_index<F, E, H>(q);
    if (dst >= 0) {
      p_out[dst] = P[q];
      m_out[dst] = M[q];
      v_out[dst] = V[q];
    }
  }
}

}  // namespace rows

// the design at (B, F, E, H): 1 = rows, 0 = elements
int design_of(int B, int F, int E, int H) {
  return B >= 1 && B <= rows::kRowsThreads && E == 14 && H == 7 &&
                 (F == 18 || F == 30)
             ? 1
             : 0;
}

// bytes of dynamic shared memory `design` needs at (B, F, E, H), or -1
// where the design does not take that shape
long long smem_bytes(int design, int B, int F, int E, int H) {
  if (design == 0) return 4 * smem_floats(B, F, E, H);
  if (design != 1 || design_of(B, F, E, H) != 1) return -1;
  return 4 * (F == 18 ? rows::Shape<18, 14, 7>::smem_floats(B)
                      : rows::Shape<30, 14, 7>::smem_floats(B));
}

template <int F>
cudaError_t launch_rows(long long bytes, const float* xs, const float* masks,
                        const float* p_in, const float* m_in,
                        const float* v_in, float* p_out, float* m_out,
                        float* v_out, float* losses, float* accs,
                        float* denoms, int S, int B, int epochs, int t0,
                        const Hyper& hp, cudaStream_t stream) {
  auto kernel = rows::fused_fit_rows_kernel<F, 14, 7>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<1, rows::kRowsThreads, (size_t)bytes, stream>>>(
      xs, masks, p_in, m_in, v_in, p_out, m_out, v_out, losses, accs, denoms,
      S, B, epochs, t0, hp);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The design fused_fit launches at (B, F, E, H): 1 = rows, 0 = elements.
// iotml_torch/ops/fused_train.py::fit_design states the same rule.
int iotml_fused_fit_design(int B, int F, int E, int H) {
  return design_of(B, F, E, H);
}

// The dynamic shared memory one fit of `design` at (B, F, E, H) needs, and
// the most a block may opt into on the current device; returns the CUDA
// error code (cudaErrorInvalidValue where the design does not take the
// shape).
int iotml_fused_fit_smem(int design, int B, int F, int E, int H,
                         long long* need, int* optin) {
  *need = smem_bytes(design, B, F, E, H);
  if (*need < 0) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(
      optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// Launches the fit in `design` on `stream`; returns the CUDA error code
// (0 = launched).  `denoms` is S floats of scratch for the rows design.
int iotml_fused_fit(int design, const float* xs, const float* masks,
                    const float* p_in, const float* m_in, const float* v_in,
                    float* p_out, float* m_out, float* v_out, float* losses,
                    float* accs, float* denoms, int S, int B, int F, int E,
                    int H, int epochs, int t0, float lr, float l1,
                    float l1_over_b, float inv_s, float b1, float one_minus_b1,
                    float b2, float one_minus_b2, float eps, float log_b1,
                    float log_b2, void* stream) {
  long long bytes = 0;
  int optin = 0;
  cudaError_t err = (cudaError_t)iotml_fused_fit_smem(design, B, F, E, H,
                                                      &bytes, &optin);
  if (err != cudaSuccess) return (int)err;
  if (bytes > optin) return (int)cudaErrorInvalidValue;
  const Hyper hp{lr, l1, l1_over_b, inv_s, b1, one_minus_b1,
                 b2, one_minus_b2, eps, log_b1, log_b2};
  const cudaStream_t st = (cudaStream_t)stream;
  if (design == 1)
    return (int)(F == 18
                     ? launch_rows<18>(bytes, xs, masks, p_in, m_in, v_in,
                                       p_out, m_out, v_out, losses, accs,
                                       denoms, S, B, epochs, t0, hp, st)
                     : launch_rows<30>(bytes, xs, masks, p_in, m_in, v_in,
                                       p_out, m_out, v_out, losses, accs,
                                       denoms, S, B, epochs, t0, hp, st));
  err = cudaFuncSetAttribute(fused_fit_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return (int)err;
  fused_fit_kernel<<<1, kThreads, (size_t)bytes, st>>>(
      xs, masks, p_in, m_in, v_in, p_out, m_out, v_out, losses, accs, S, B, F,
      E, H, epochs, t0, hp);
  return (int)cudaGetLastError();
}

}  // extern "C"
