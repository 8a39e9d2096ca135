// Flash attention for Hopper (sm_90a): the training path's causal
// attention forward and its two backward kernels, with GQA read by index.
//
// Replaces the three TPU kernels of tony_tpu/ops/attention.py:
//   flash_fwd  <- _fwd_kernel     (:44)   out and lse from q, k, v
//   flash_dq   <- _bwd_dq_kernel  (:138)  dq from q, k, v, dO, lse, delta
//   flash_dkv  <- _bwd_dkv_kernel (:177)  dk, dv summed over the GQA group
// and computes what they compute: scores s = (q . k) * scale in float32,
// causal entries above the diagonal set to the finite -0.7 * FLT_MAX (so
// exp(m_prev - m_new) of two masked maxima is 1, never NaN), an online
// softmax (m, l, acc) in float32, p rounded to the input type before P.V
// (the TPU kernel's p.astype(v.dtype)), out = acc / max(l, 1e-30) and
// lse = m + log(max(l, 1e-30)). The backward kernels recompute
// p = exp(s - lse) and take ds = p * (dO . v - delta) * scale.
// delta = rowsum(dO * out) is computed by the caller.
//
// Layouts. Each tensor is addressed as (batch b, head h, position s, dim d)
// with d of unit stride and element strides (sb, sh, ss) for the rest, so
// the same kernels read the model's [B, S, H, hd] activations with no
// transpose and the reference's folded [B * H, S, hd] layout alike. q, out,
// dO and dq share one set of strides, k, v, dk and dv another. lse and
// delta are float32 [B * H, S]. Head h reads kv head h / (H / Hkv), the
// TPU kernel's _kv_index.
//
// Two designs, picked by input type (flash_route says which runs):
//
// bf16 flash_fwd and flash_dkv: tensor cores (namespace tc). Tiles are
// 64-column halves of hd in 128-byte-swizzled shared memory, loaded by TMA
// (cp.async.bulk.tensor over 4-D tensor maps of (hd, S, heads, B) with the
// caller's strides; rows past S arrive as zeros) through a 2-stage ring of
// full/empty mbarriers, and read by wgmma through descriptors: K-major for
// Q, K, V and dO as the "rows . rows" operands, MN-major (transposed) for
// V, dO and Q as the second operand of P.V, P^T.dO and dS^T.Q. Products
// are wgmma m64nNk16, bf16 in, float32 out.
// - flash_fwd: one CTA per (128 query rows, b * H + h), the longest causal
//   rows first; 384 threads. Warpgroup 0 is the producer, one thread of
//   which keeps the Q, K and V loads in flight; warpgroups 1 and 2 own 64
//   rows each. Per 128-key tile: S = Q.K^T (both from shared memory), the
//   online softmax in the accumulator registers (a row's max over the 4
//   lanes that hold it; masking only on the diagonal tile and past S;
//   whole tiles above the diagonal are never loaded, the TPU kernel's
//   j * blk_k <= i * blk_q + blk_q - 1), p rounded to bf16 and repacked in
//   registers as the A operand of O += P.V. A consumer fits the 168
//   registers a 384-thread CTA gives each thread (no spills).
// - flash_dkv: one CTA per (128 keys, b * Hkv + kv head), K and V loaded
//   once and resident; two warpgroups own 64 keys each and walk every
//   64-row q tile on or below the diagonal of every query head of the GQA
//   group (the TPU grid's innermost rep * nq dimension), so dK and dV
//   accumulate in registers without atomics. Per q tile, in the transposed
//   form, so every product has M = keys: S^T = K.Q^T and dP^T = V.dO^T
//   from shared memory, P^T = exp(S^T scale - lse) (lse along the
//   columns), dS^T = P^T (dP^T - delta) scale, then dV += P^T.dO and
//   dK += dS^T.Q with P^T and dS^T rounded to bf16 as the register
//   operand. Rows past S are masked explicitly: their zero-filled q gives
//   s = 0, and exp(0 - 0) = 1. A thread needs about 235 registers (dK,
//   dV, S^T and dP^T are 192), more than the 168 of a 384-thread CTA, and
//   ptxas does not raise that for a region after setmaxnreg (with a
//   producer warpgroup it spilled 392 bytes at setmaxnreg 24 / 240 and
//   56 / 224 alike). So there is no producer warpgroup: warp 0 stages the
//   next q tile (lse and delta by its lanes, Q and dO by TMA) between its
//   own tiles. The reference keeps p and ds in float32 for
//   the two products; rounding them to bf16 stays inside the bf16
//   tolerance at every shape checked (chip_smoke phase 3b), so no hi + lo
//   split is made.
// Scores run in log2 units (exp2f of s * scale * log2 e), the same
// function as exp up to float32 rounding of the argument.
//
// float32 inputs, and flash_dq in both types: the first design, scalar
// float32 FMA on CUDA cores. 64 x 64 tiles, 256 threads, a 4 x 4 block of
// the score tile per thread; Q, K, V and dO staged as float32 transposed to
// [hd][65] (the stride of 65 words keeps the staging stores and the column
// reads free of bank conflicts); p and ds pass through shared memory. The
// tensor cores have no float32 path that holds 1e-4 (TF32 keeps about 10
// bits), so float32 stays here. flash_dq keeps p and ds in float32, as the
// TPU kernel does.
//
// What bounds it on this card: operations. At the training shapes
// (S = 2048, hd = 128) a tile does 2 * 64 * 128 * 128 flops per matmul
// against 128 * 128 * 2 bytes loaded, far above the H100's ~295 flop/byte
// ridge. The least time is the causal matmul flops over the bf16
// tensor-core peak of 989 TFLOP/s (H100 SXM data sheet); the scalar
// instances peak at the CUDA cores' 67 TFLOP/s. Measured times are in
// PERF.md.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;          // query rows and key positions per tile
constexpr int kLd = kTile + 1;     // shared-memory row stride (words)
constexpr float kNeg = -0.7f * 3.4028234663852886e38f;

struct Strides {
  long long sb, sh, ss;            // batch, head, position (d has stride 1)
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// max / sum over the 16 lanes (tx = 0..15) that share one tile row
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o, 16));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o, 16);
  return x;
}

// Stage rows [row0, row0 + 64) of head (b, h) into dst[d * kLd + r] as
// float32; rows past S read as zero.
template <typename T, int HD>
__device__ __forceinline__ void stage(float* dst, const T* src, Strides st, int b,
                                      int h, int row0, int S) {
  const T* base = src + b * st.sb + h * st.sh;
  for (int e = threadIdx.x; e < kTile * HD; e += kThreads) {
    const int r = e / HD, d = e % HD, s = row0 + r;
    dst[d * kLd + r] = s < S ? to_f(base[(long long)s * st.ss + d]) : 0.f;
  }
}

// float32 values [64] of a [B * H, S] row vector; past S read as zero
__device__ __forceinline__ void stage_row(float* dst, const float* src, int bh,
                                          int row0, int S) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const int s = row0 + r;
    dst[r] = s < S ? src[(long long)bh * S + s] : 0.f;
  }
}

// ---------------------------------------------- scalar forward (float32)

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int H, int Hkv, int S, Strides sq,
                 Strides sk, float scale, int causal) {
  constexpr int C = HD / 16;
  extern __shared__ float smem[];
  float* qt = smem;                 // [HD][kLd]
  float* kt = qt + HD * kLd;        // [HD][kLd]
  float* vt = kt + HD * kLd;        // [HD][kLd]
  float* ps = vt + HD * kLd;        // [kTile][kLd]: ps[c * kLd + r]

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, hk = h / (H / Hkv);
  // the longest causal tiles first
  const int i0 = (gridDim.x - 1 - blockIdx.x) * kTile;

  stage<T, HD>(qt, q, sq, b, h, i0, S);

  float m[4], l[4], acc[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < C; ++j) acc[i][j] = 0.f;
  }

  int nk = (S + kTile - 1) / kTile;
  if (causal) nk = min(nk, i0 / kTile + 1);
  for (int jt = 0; jt < nk; ++jt) {
    const int j0 = jt * kTile;
    __syncthreads();                // the previous tile's readers are done
    stage<T, HD>(kt, k, sk, b, hk, j0, S);
    stage<T, HD>(vt, v, sk, b, hk, j0, S);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qt[d * kLd + ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = kt[d * kLd + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += a[i] * c[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i0 + ty * 4 + i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = j0 + tx + 16 * j;
        const bool ok = c < S && (!causal || c <= r);
        s[i][j] = ok ? s[i][j] * scale : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        // p is rounded to the input type before P.V (TPU kernel :74)
        ps[(tx + 16 * j) * kLd + ty * 4 + i] = to_f(from_f<T>(p));
      }
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < C; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float a[4], w[C];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ps[c * kLd + ty * 4 + i];
#pragma unroll
      for (int j = 0; j < C; ++j) w[j] = vt[(tx + 16 * j) * kLd + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < C; ++j) acc[i][j] += a[i] * w[j];
    }
  }

  T* obase = out + b * sq.sb + h * sq.sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = i0 + ty * 4 + i;
    if (r >= S) continue;
    const float ll = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < C; ++j)
      obase[(long long)r * sq.ss + tx + 16 * j] = from_f<T>(acc[i][j] / ll);
    if (tx == 0) lse[(long long)bh * S + r] = m[i] + logf(ll);
  }
}

// ---------------------------------------------- scalar dq (both types)

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dq, int H, int Hkv, int S, Strides sq,
                Strides sk, float scale, int causal) {
  constexpr int C = HD / 16;
  extern __shared__ float smem[];
  float* qt = smem;                 // [HD][kLd]
  float* ot = qt + HD * kLd;        // dO, [HD][kLd]
  float* kt = ot + HD * kLd;        // [HD][kLd]
  float* vt = kt + HD * kLd;        // [HD][kLd]
  float* dss = vt + HD * kLd;       // [kTile][kLd]: dss[c * kLd + r]
  float* lse_s = dss + kTile * kLd; // [kTile]
  float* dl_s = lse_s + kTile;      // [kTile]

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int i0 = (gridDim.x - 1 - blockIdx.x) * kTile;

  stage<T, HD>(qt, q, sq, b, h, i0, S);
  stage<T, HD>(ot, dout, sq, b, h, i0, S);
  stage_row(lse_s, lse, bh, i0, S);
  stage_row(dl_s, delta, bh, i0, S);

  float acc[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) acc[i][j] = 0.f;

  int nk = (S + kTile - 1) / kTile;
  if (causal) nk = min(nk, i0 / kTile + 1);
  for (int jt = 0; jt < nk; ++jt) {
    const int j0 = jt * kTile;
    __syncthreads();
    stage<T, HD>(kt, k, sk, b, hk, j0, S);
    stage<T, HD>(vt, v, sk, b, hk, j0, S);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[4], o[4], c[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = qt[d * kLd + ty * 4 + i];
        o[i] = ot[d * kLd + ty * 4 + i];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[j] = kt[d * kLd + tx + 16 * j];
        w[j] = vt[d * kLd + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] += a[i] * c[j];
          dp[i][j] += o[i] * w[j];
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = ty * 4 + i, r = i0 + rl;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = tx + 16 * j, c = j0 + cl;
        const bool ok = r < S && c < S && (!causal || c <= r);
        const float p = ok ? expf(s[i][j] * scale - lse_s[rl]) : 0.f;
        dss[cl * kLd + rl] = p * (dp[i][j] - dl_s[rl]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float a[4], w[C];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = dss[c * kLd + ty * 4 + i];
#pragma unroll
      for (int j = 0; j < C; ++j) w[j] = kt[(tx + 16 * j) * kLd + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < C; ++j) acc[i][j] += a[i] * w[j];
    }
  }

  T* base = dq + b * sq.sb + h * sq.sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = i0 + ty * 4 + i;
    if (r >= S) continue;
#pragma unroll
    for (int j = 0; j < C; ++j)
      base[(long long)r * sq.ss + tx + 16 * j] = from_f<T>(acc[i][j]);
  }
}

// ------------------------------------------------ scalar dk/dv (float32)

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 T* __restrict__ dk, T* __restrict__ dv, int H, int Hkv, int S,
                 Strides sq, Strides sk, float scale, int causal) {
  constexpr int C = HD / 16;
  extern __shared__ float smem[];
  float* kt = smem;                 // [HD][kLd]
  float* vt = kt + HD * kLd;        // [HD][kLd]
  float* qt = vt + HD * kLd;        // [HD][kLd]
  float* ot = qt + HD * kLd;        // dO, [HD][kLd]
  float* ps = ot + HD * kLd;        // [kTile][kLd]: ps[r * kLd + c]
  float* dss = ps + kTile * kLd;    // [kTile][kLd]: dss[r * kLd + c]
  float* lse_s = dss + kTile * kLd; // [kTile]
  float* dl_s = lse_s + kTile;      // [kTile]

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int rep = H / Hkv;
  const int bk = blockIdx.y, b = bk / Hkv, hk = bk % Hkv;
  const int j0 = blockIdx.x * kTile;  // this CTA's key positions

  stage<T, HD>(kt, k, sk, b, hk, j0, S);
  stage<T, HD>(vt, v, sk, b, hk, j0, S);

  // rows of this thread: key positions j0 + 4 * ty + i
  float gk[4][C], gv[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) gk[i][j] = gv[i][j] = 0.f;

  const int nq = (S + kTile - 1) / kTile;
  // the first q tile with i0 + 63 >= j0 (TPU kernel :191)
  const int iq0 = causal ? j0 / kTile : 0;
  for (int g = 0; g < rep; ++g) {
    const int h = hk * rep + g, bh = b * H + h;
    for (int iq = iq0; iq < nq; ++iq) {
      const int i0 = iq * kTile;
      __syncthreads();
      stage<T, HD>(qt, q, sq, b, h, i0, S);
      stage<T, HD>(ot, dout, sq, b, h, i0, S);
      stage_row(lse_s, lse, bh, i0, S);
      stage_row(dl_s, delta, bh, i0, S);
      __syncthreads();

      // transposed scores: st[i][j] = k[c] . q[r], c = 4 * ty + i,
      // r = tx + 16 * j
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float a[4], w[4], c[4], o[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = kt[d * kLd + ty * 4 + i];
          w[i] = vt[d * kLd + ty * 4 + i];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          c[j] = qt[d * kLd + tx + 16 * j];
          o[j] = ot[d * kLd + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            st[i][j] += a[i] * c[j];
            dpt[i][j] += w[i] * o[j];
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int cl = ty * 4 + i, c = j0 + cl;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int rl = tx + 16 * j, r = i0 + rl;
          const bool ok = r < S && c < S && (!causal || c <= r);
          const float p = ok ? expf(st[i][j] * scale - lse_s[rl]) : 0.f;
          ps[rl * kLd + cl] = p;
          dss[rl * kLd + cl] = p * (dpt[i][j] - dl_s[rl]) * scale;
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int r = 0; r < kTile; ++r) {
        float a[4], e[4], o[C], c[C];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = ps[r * kLd + ty * 4 + i];
          e[i] = dss[r * kLd + ty * 4 + i];
        }
#pragma unroll
        for (int j = 0; j < C; ++j) {
          o[j] = ot[(tx + 16 * j) * kLd + r];
          c[j] = qt[(tx + 16 * j) * kLd + r];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < C; ++j) {
            gv[i][j] += a[i] * o[j];
            gk[i][j] += e[i] * c[j];
          }
      }
    }
  }

  T* kb = dk + b * sk.sb + hk * sk.sh;
  T* vb = dv + b * sk.sb + hk * sk.sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = j0 + ty * 4 + i;
    if (c >= S) continue;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      kb[(long long)c * sk.ss + tx + 16 * j] = from_f<T>(gk[i][j]);
      vb[(long long)c * sk.ss + tx + 16 * j] = from_f<T>(gv[i][j]);
    }
  }
}

// ------------------------------------------------- tensor cores (bf16 only)

namespace tc {

constexpr int kThreads = 384;      // fwd: warpgroup 0 produces, 1 and 2 consume
constexpr int kConsumers = 256;    // the two compute warpgroups (dkv: the whole CTA)
constexpr int kRows = 128;         // fwd: q rows per CTA, keys per tile; dkv: keys per CTA
constexpr int kQRows = 64;         // dkv: q rows per tile
constexpr int kStages = 2;
constexpr int kHalf = 64;          // bf16 columns in one 128-byte swizzled row
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers and TMA

__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool bar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the phase of the given parity to complete. A barrier that stays
// open for 2^32 cycles (about 2 s; a tile takes microseconds) traps, so a
// load that never lands is a launch error and not a hung card.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  if (bar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!bar_try(bar, parity))
    if (clock64() - t0 > (1ll << 32)) __trap();
}

// 4-D box (64 columns of hd, rows positions, 1 head, 1 batch row) at
// (d0, s0, head, b) into dst, completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap& map, uint32_t bar,
                                         int d0, int s0, int head, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(d0), "r"(s0), "r"(head), "r"(b)
      : "memory");
}

// a [rows, HD] tile as HD / 64 halves of [rows][64], one after the other
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap& map, uint32_t bar,
                                          int s0, int head, int b, int rows) {
#pragma unroll
  for (int h = 0; h < HD / kHalf; ++h)
    tma_load(dst + h * rows * 128, map, bar, h * kHalf, s0, head, b);
}

// --- warpgroup MMA

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving reads or writes of wgmma registers across
// the fence / wait that brackets the asynchronous product
template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void hold(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled operand: start
// address, leading byte offset (MN-major: the distance between 64-column
// halves; K-major: unused), stride byte offset 1024 (8 rows of 128 bytes),
// layout 128B swizzle. Within a swizzled row a k-step of 16 moves the
// start by 32 bytes; the tiles are 1024-byte aligned, so the base offset
// is 0.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// wgmma.mma_async m64nNk16, float32 += bf16 x bf16. ss: A and B from
// shared memory, both K-major. rs: A from registers (the m64k16 fragment),
// B from shared memory MN-major. acc = 0 overwrites d.
// Accumulator layout (thread t of the warpgroup, warp w = t / 32, lane l):
// d[i] is row 16 w + l / 4 + 8 ((i >> 1) & 1), column 8 (i >> 2) +
// 2 (l % 4) + (i & 1); the A fragment of k-step kk is the same layout's
// d[8 kk .. 8 kk + 7] packed in pairs.
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                               int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void mma_ss_n128(float (&d)[64], uint64_t a, uint64_t b,
                                               int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void mma_rs_n64(float (&d)[32], const uint32_t* a, uint64_t b,
                                               int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

__device__ __forceinline__ void mma_rs_n128(float (&d)[64], const uint32_t* a, uint64_t b,
                                               int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int acc) {
  if constexpr (N == 64) mma_ss_n64(d, a, b, acc);
  else mma_ss_n128(d, a, b, acc);
}

template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t* a, uint64_t b, int acc) {
  if constexpr (N == 64) mma_rs_n64(d, a, b, acc);
  else mma_rs_n128(d, a, b, acc);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// an accumulator as A fragments, rounded to bf16
template <int N>
__device__ __forceinline__ void to_a(const float (&d)[N], uint32_t (&a)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) a[i] = pack_bf16(d[2 * i], d[2 * i + 1]);
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// rows r and r + 8 of a [64, HD] accumulator (this thread's columns), as
// bf16 divided by div[0] / div[1], to row pointers p0 / p1 (null: not stored)
template <int HD>
__device__ __forceinline__ void store_rows(const float (&acc)[HD / 2], __nv_bfloat16* p0,
                                           __nv_bfloat16* p1, const float (&div)[2]) {
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (p0)
      *reinterpret_cast<__nv_bfloat162*>(p0 + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j] / div[0], acc[4 * j + 1] / div[0]);
    if (p1)
      *reinterpret_cast<__nv_bfloat162*>(p1 + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2] / div[1], acc[4 * j + 3] / div[1]);
  }
}

__device__ __forceinline__ void init_done() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// dynamic shared memory: 1 KB of slack to align the tiles to 1024 bytes
constexpr int fwd_smem(int hd) { return 1024 + (1 + 2 * kStages) * kRows * hd * 2; }
constexpr int dkv_smem(int hd) { return 1024 + 2 * kRows * hd * 2 + 2 * kStages * kQRows * hd * 2; }

// ---------------------------------------------------------------- forward

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ out,
                 float* __restrict__ lse, int H, int Hkv, int S, Strides sq, float scale,
                 int causal) {
  constexpr int kTile = kRows * HD * 2;    // bytes of a 128-row Q, K or V tile
  constexpr int kHalfB = kRows * 128;      // bytes of one 64-column half of it
  extern __shared__ uint8_t smem[];
  __shared__ __align__(8) uint64_t bars[1 + 4 * kStages];
  const uint32_t sQ = (saddr(smem) + 1023) & ~1023u;
  const uint32_t sK = sQ + kTile, sV = sK + kStages * kTile;
  // q_full, then k_full[s], v_full[s], k_empty[s], v_empty[s]
  const uint32_t q_full = saddr(bars), k_full = q_full + 8, v_full = k_full + 8 * kStages;
  const uint32_t k_empty = v_full + 8 * kStages, v_empty = k_empty + 8 * kStages;

  // a 1-D grid, heaviest tiles first: block x is tile rank x / BH of row
  // x % BH, so every head's diagonal-end tile starts before any short one
  const int nt = (S + kRows - 1) / kRows, BH = gridDim.x / nt;
  const int bh = blockIdx.x % BH, b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int i0 = (nt - 1 - blockIdx.x / BH) * kRows;    // the longest causal rows first
  int nk = nt;
  if (causal) nk = min(nk, i0 / kRows + 1);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    bar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(k_full + 8 * s, 1);
      bar_init(v_full + 8 * s, 1);
      bar_init(k_empty + 8 * s, kConsumers);
      bar_init(v_empty + 8 * s, kConsumers);
    }
    init_done();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the loads in flight
    if (tid == 0) {
      bar_expect(q_full, kTile);
      load_tile<HD>(sQ, qmap, q_full, i0, h, b, kRows);
      for (int t = 0; t < nk; ++t) {
        const int s = t % kStages;
        const uint32_t ph = (t / kStages) & 1;
        bar_wait(k_empty + 8 * s, ph ^ 1);
        bar_expect(k_full + 8 * s, kTile);
        load_tile<HD>(sK + s * kTile, kmap, k_full + 8 * s, t * kRows, hk, b, kRows);
        bar_wait(v_empty + 8 * s, ph ^ 1);
        bar_expect(v_full + 8 * s, kTile);
        load_tile<HD>(sV + s * kTile, vmap, v_full + 8 * s, t * kRows, hk, b, kRows);
      }
    }
  } else {
    const int cw = wg - 1, lane = tid % 32, t4 = lane % 4;
    const int rw = i0 + 64 * cw;                   // this warpgroup's first row
    const int r0 = rw + 16 * (tid / 32) + lane / 4;  // this thread's rows r0, r0 + 8
    const float sl2 = scale * kLog2e;
    const uint32_t aQ = sQ + cw * 64 * 128;        // its 64 rows of each Q half
    float o[HD / 2], m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
    zero(o);
    bar_wait(q_full, 0);
    for (int t = 0; t < nk; ++t) {
      const int s = t % kStages, j0 = t * kRows;
      const uint32_t ph = (t / kStages) & 1;
      float sc[64];
      zero(sc);
      bar_wait(k_full + 8 * s, ph);
      hold(sc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk / 4) * kHalfB + (kk % 4) * 32;
        mma_ss<kRows>(sc, desc(aQ + off, 16), desc(sK + s * kTile + off, 16), kk);
      }
      wg_commit();
      wg_wait();
      hold(sc);
      bar_arrive(k_empty + 8 * s);

      // the online softmax, in log2 units; masks on the diagonal and past S
      const bool edge = (causal && j0 + kRows > rw) || j0 + kRows > S;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        float x = sc[i] * sl2;
        if (edge) {
          const int r = r0 + 8 * ((i >> 1) & 1), c = j0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
          if (c >= S || (causal && c > r)) x = kNeg;
        }
        sc[i] = x;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = exp2f(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= corr[r];
      }
      // p rounded to bf16 before P.V (TPU kernel :74); l sums it unrounded
      uint32_t pa[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float p0 = exp2f(sc[2 * i] - m[i & 1]), p1 = exp2f(sc[2 * i + 1] - m[i & 1]);
        l[i & 1] += p0 + p1;
        pa[i] = pack_bf16(p0, p1);
      }
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] *= corr[(i >> 1) & 1];

      bar_wait(v_full + 8 * s, ph);
      hold(o);
      hold(pa);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk)
        mma_rs<HD>(o, &pa[4 * kk], desc(sV + s * kTile + kk * 16 * 128, kHalfB), 1);
      wg_commit();
      wg_wait();
      hold(o);
      bar_arrive(v_empty + 8 * s);
    }

    float ll[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      ll[r] = fmaxf(l[r], 1e-30f);
    }
    __nv_bfloat16* base = out + b * sq.sb + h * sq.sh + 2 * t4;
    store_rows<HD>(o, r0 < S ? base + (long long)r0 * sq.ss : nullptr,
                   r0 + 8 < S ? base + (long long)(r0 + 8) * sq.ss : nullptr, ll);
    if (t4 == 0) {
      if (r0 < S) lse[(long long)bh * S + r0] = m[0] * kLn2 + logf(ll[0]);
      if (r0 + 8 < S) lse[(long long)bh * S + r0 + 8] = m[1] * kLn2 + logf(ll[1]);
    }
  }
}

// ------------------------------------------------------------------ dk/dv

// Two warpgroups and no producer (see the top of the file): 256 threads get
// the 255 registers a thread needs about 235 of; warp 0 stages the tiles.
template <int HD>
__global__ void __launch_bounds__(kConsumers, 1)
flash_dkv_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 const __grid_constant__ CUtensorMap omap, const float* __restrict__ lse,
                 const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                 __nv_bfloat16* __restrict__ dv, int H, int Hkv, int S, Strides sk,
                 float scale, int causal) {
  constexpr int kKV = kRows * HD * 2, kQ = kQRows * HD * 2;   // tile bytes
  constexpr int kKVHalf = kRows * 128, kQHalf = kQRows * 128;  // half-tile bytes
  extern __shared__ uint8_t smem[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];
  __shared__ float rowv[kStages][2][kQRows];   // lse and delta of each staged q tile
  const uint32_t sK = (saddr(smem) + 1023) & ~1023u, sV = sK + kKV;
  const uint32_t sQ = sV + kKV, sO = sQ + kStages * kQ;
  // kv_full, then full[s] (q, dO, lse, delta), empty[s]
  const uint32_t kv_full = saddr(bars), full = kv_full + 8, empty = full + 8 * kStages;

  // a 1-D grid, the keys with the most q tiles first (see the forward)
  const int nt = (S + kRows - 1) / kRows, BK = gridDim.x / nt;
  const int bk = blockIdx.x % BK, b = bk / Hkv, hk = bk % Hkv, rep = H / Hkv;
  const int j0 = (blockIdx.x / BK) * kRows;
  const int nq = (S + kQRows - 1) / kQRows, iq0 = causal ? j0 / kQRows : 0;
  const int per = nq - iq0, total = rep * per;   // q tiles: per head, in all
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, lane = tid % 32;

  if (threadIdx.x == 0) {
    bar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(full + 8 * s, 1);
      bar_init(empty + 8 * s, kConsumers);
    }
    init_done();
  }
  __syncthreads();

  // warp 0: q tile t (head t / per of the group) into stage t % kStages,
  // lse and delta by its lanes, Q and dO by TMA
  auto stage = [&](int t) {
    const int s = t % kStages, hq = hk * rep + t / per, i0 = (iq0 + t % per) * kQRows;
    const long long at = (long long)(b * H + hq) * S + i0;
    for (int r = lane; r < kQRows; r += 32) {
      const bool in = i0 + r < S;
      rowv[s][0][r] = in ? lse[at + r] : 0.f;
      rowv[s][1][r] = in ? delta[at + r] : 0.f;
    }
    __syncwarp();
    if (lane == 0) {
      bar_expect(full + 8 * s, 2 * kQ);   // its release covers the lanes' rowv stores
      load_tile<HD>(sQ + s * kQ, qmap, full + 8 * s, i0, hq, b, kQRows);
      load_tile<HD>(sO + s * kQ, omap, full + 8 * s, i0, hq, b, kQRows);
    }
  };
  if (threadIdx.x < 32) {
    if (lane == 0) {
      bar_expect(kv_full, 2 * kKV);
      load_tile<HD>(sK, kmap, kv_full, j0, hk, b, kRows);
      load_tile<HD>(sV, vmap, kv_full, j0, hk, b, kRows);
    }
    for (int t = 0; t < kStages && t < total; ++t) stage(t);
  }

  const int kw = j0 + 64 * wg;                      // this warpgroup's first key
  const int c0 = kw + 16 * (tid / 32) + lane / 4;   // this thread's keys c0, c0 + 8
  const int t4 = lane % 4;
  const float sl2 = scale * kLog2e;
  const uint32_t aK = sK + wg * 64 * 128, aV = sV + wg * 64 * 128;
  float gk[HD / 2], gv[HD / 2];
  zero(gk);
  zero(gv);
  bar_wait(kv_full, 0);
  for (int t = 0; t < total; ++t) {
    const int s = t % kStages, i0 = (iq0 + t % per) * kQRows;
    const uint32_t ph = (t / kStages) & 1;
    float st[32], dp[32];
    zero(st);
    zero(dp);
    bar_wait(full + 8 * s, ph);
    hold(st);
    hold(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t ko = (kk / 4) * kKVHalf + (kk % 4) * 32;
      const uint32_t qo = s * kQ + (kk / 4) * kQHalf + (kk % 4) * 32;
      mma_ss<kQRows>(st, desc(aK + ko, 16), desc(sQ + qo, 16), kk);
      mma_ss<kQRows>(dp, desc(aV + ko, 16), desc(sO + qo, 16), kk);
    }
    wg_commit();
    wg_wait();
    hold(st);
    hold(dp);

    // P^T and dS^T: columns are q rows; rows past S and keys after a row
    // are masked (zero-filled rows past S would give p = 1)
    const float* lr = rowv[s][0];
    const float* dr = rowv[s][1];
    const bool edge = (causal && i0 < kw + 64) || i0 + kQRows > S;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int rl = 8 * (i >> 2) + 2 * t4 + (i & 1);
      float p = exp2f(st[i] * sl2 - lr[rl] * kLog2e);
      if (edge) {
        const int r = i0 + rl, c = c0 + 8 * ((i >> 1) & 1);
        if (r >= S || (causal && c > r)) p = 0.f;
      }
      st[i] = p;
      dp[i] = p * (dp[i] - dr[rl]) * scale;
    }
    uint32_t pa[16], da[16];
    to_a(st, pa);
    to_a(dp, da);
    hold(gk);
    hold(gv);
    hold(pa);
    hold(da);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kQRows / 16; ++kk) {
      const uint32_t qo = s * kQ + kk * 16 * 128;
      mma_rs<HD>(gv, &pa[4 * kk], desc(sO + qo, kQHalf), 1);
      mma_rs<HD>(gk, &da[4 * kk], desc(sQ + qo, kQHalf), 1);
    }
    wg_commit();
    wg_wait();
    hold(gk);
    hold(gv);
    bar_arrive(empty + 8 * s);
    if (threadIdx.x < 32 && t + kStages < total) {
      bar_wait(empty + 8 * s, ph);   // both warpgroups are done with tile t
      stage(t + kStages);
    }
  }

  const float one[2] = {1.f, 1.f};
  const long long off = b * sk.sb + hk * sk.sh + 2 * t4;
  const long long o0 = off + (long long)c0 * sk.ss, o1 = o0 + 8 * sk.ss;
  store_rows<HD>(gk, c0 < S ? dk + o0 : nullptr, c0 + 8 < S ? dk + o1 : nullptr, one);
  store_rows<HD>(gv, c0 < S ? dv + o0 : nullptr, c0 + 8 < S ? dv + o1 : nullptr, one);
}

}  // namespace tc

// ---------------------------------------------------------------- launches

constexpr int fwd_smem(int hd) { return 4 * (3 * hd * kLd + kTile * kLd); }
constexpr int dq_smem(int hd) { return 4 * (4 * hd * kLd + kTile * kLd + 2 * kTile); }
constexpr int dkv_smem(int hd) { return 4 * (4 * hd * kLd + 2 * kTile * kLd + 2 * kTile); }

// past the default 48 KB a kernel must opt in; the attribute is per
// device, so it is set on every launch rather than cached
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int HD>
int fwd(const void* q, const void* k, const void* v, void* out, void* lse, int B,
        int H, int Hkv, int S, Strides sq, Strides sk, float scale, int causal,
        cudaStream_t stream) {
  const int smem = fwd_smem(HD);
  cudaError_t err = allow_smem(flash_fwd_kernel<T, HD>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kTile - 1) / kTile, B * H);
  flash_fwd_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), H, Hkv, S, sq, sk, scale,
      causal);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int dq(const void* q, const void* k, const void* v, const void* dout,
       const void* lse, const void* delta, void* dq_out, int B, int H, int Hkv,
       int S, Strides sq, Strides sk, float scale, int causal, cudaStream_t stream) {
  const int smem = dq_smem(HD);
  cudaError_t err = allow_smem(flash_dq_kernel<T, HD>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kTile - 1) / kTile, B * H);
  flash_dq_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq_out), H, Hkv, S, sq,
      sk, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int dkv(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dk_out, void* dv_out, int B,
        int H, int Hkv, int S, Strides sq, Strides sk, float scale, int causal,
        cudaStream_t stream) {
  const int smem = dkv_smem(HD);
  cudaError_t err = allow_smem(flash_dkv_kernel<T, HD>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kTile - 1) / kTile, B * Hkv);
  flash_dkv_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk_out),
      static_cast<T*>(dv_out), H, Hkv, S, sq, sk, scale, causal);
  return (int)cudaGetLastError();
}

// --- the tensor-core instances' tensor maps

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query (so the library links no libcuda); null when libcuda lacks it
decltype(&cuTensorMapEncodeTiled) encoder() {
  static decltype(&cuTensorMapEncodeTiled) fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<decltype(&cuTensorMapEncodeTiled)>(p);
  }
  return fn;
}

constexpr int kNoEncoder = -2;   // libcuda has no cuTensorMapEncodeTiled
constexpr int kBadMap = -3;      // it refused a map (base or stride not 16-byte aligned)

// 4-D map of a bf16 tensor over (hd, S, heads, B) with element strides st,
// boxes of (64, rows, 1, 1) in 128-byte swizzle; positions past S read as
// zero. A dimension of size 1 gets a stride of its own (the caller's may be
// any number there, and its only coordinate is 0).
int make_map(CUtensorMap* map, const void* ptr, int hd, int S, int heads, int B, Strides st,
             int rows) {
  const auto enc = encoder();
  if (!enc) return kNoEncoder;
  auto bytes = [hd](long long stride, int n) -> cuuint64_t {
    return (cuuint64_t)(n > 1 ? stride : hd) * 2;
  };
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)S, (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {bytes(st.ss, S), bytes(st.sh, heads), bytes(st.sb, B)};
  const cuuint32_t box[4] = {(cuuint32_t)tc::kHalf, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                         strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kBadMap;
}

template <int HD>
int fwd_tc(const void* q, const void* k, const void* v, void* out, void* lse, int B, int H,
           int Hkv, int S, Strides sq, Strides sk, float scale, int causal,
           cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  int e = make_map(&qm, q, HD, S, H, B, sq, tc::kRows);
  if (!e) e = make_map(&km, k, HD, S, Hkv, B, sk, tc::kRows);
  if (!e) e = make_map(&vm, v, HD, S, Hkv, B, sk, tc::kRows);
  if (e) return e;
  const int smem = tc::fwd_smem(HD);
  cudaError_t err = allow_smem(tc::flash_fwd_kernel<HD>, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (S + tc::kRows - 1) / tc::kRows;
  tc::flash_fwd_kernel<HD><<<tiles * B * H, tc::kThreads, smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), H, Hkv, S, sq,
      scale, causal);
  return (int)cudaGetLastError();
}

template <int HD>
int dkv_tc(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dk_out, void* dv_out, int B, int H, int Hkv, int S,
           Strides sq, Strides sk, float scale, int causal, cudaStream_t stream) {
  CUtensorMap qm, km, vm, om;
  int e = make_map(&qm, q, HD, S, H, B, sq, tc::kQRows);
  if (!e) e = make_map(&om, dout, HD, S, H, B, sq, tc::kQRows);
  if (!e) e = make_map(&km, k, HD, S, Hkv, B, sk, tc::kRows);
  if (!e) e = make_map(&vm, v, HD, S, Hkv, B, sk, tc::kRows);
  if (e) return e;
  const int smem = tc::dkv_smem(HD);
  cudaError_t err = allow_smem(tc::flash_dkv_kernel<HD>, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (S + tc::kRows - 1) / tc::kRows;
  tc::flash_dkv_kernel<HD><<<tiles * B * Hkv, tc::kConsumers, smem, stream>>>(
      qm, km, vm, om, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk_out), static_cast<__nv_bfloat16*>(dv_out), H, Hkv, S,
      sk, scale, causal);
  return (int)cudaGetLastError();
}

// head_dim and dtype are template arguments: pick the instance. TC names
// the bf16 tensor-core instance where the kernel has one (flash_route),
// else the scalar one runs for bf16 too.
#define TONY_DISPATCH(TC, FN, ...)                                            \
  do {                                                                        \
    if (dtype == 1) {                                                         \
      switch (hd) {                                                           \
        case 64: return TC<64>(__VA_ARGS__);                                  \
        case 128: return TC<128>(__VA_ARGS__);                                \
      }                                                                       \
    } else if (dtype == 0) {                                                  \
      switch (hd) {                                                           \
        case 64: return FN<float, 64>(__VA_ARGS__);                           \
        case 128: return FN<float, 128>(__VA_ARGS__);                         \
      }                                                                       \
    }                                                                         \
    return -1;                                                                \
  } while (0)

template <int HD, typename... A>
int dq_bf16(A... args) {
  return dq<__nv_bfloat16, HD>(args...);
}

}  // namespace

// Plain C entry points (bound with ctypes). dtype: 0 = float32,
// 1 = bfloat16; hd 64 or 128. Strides are in elements: q-like
// tensors (q, out, dO, dq) use (qsb, qsh, qss), k-like ones (k, v, dk, dv)
// (ksb, ksh, kss). Each returns the cudaError_t of its launch (0 =
// launched), -1 for a head_dim or dtype it has no instance for, -2 when
// libcuda has no cuTensorMapEncodeTiled, -3 when it refuses a tensor
// map (a base or stride that is not a multiple of 16 bytes).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* out,
                         void* lse, int B, int H, int Hkv, int S, int hd,
                         long long qsb, long long qsh, long long qss,
                         long long ksb, long long ksh, long long kss, float scale,
                         int causal, int dtype, void* stream) {
  const Strides sq{qsb, qsh, qss}, sk{ksb, ksh, kss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  TONY_DISPATCH(fwd_tc, fwd, q, k, v, out, lse, B, H, Hkv, S, sq, sk, scale, causal, s);
}

extern "C" int flash_dq(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dq_out, int B, int H, int Hkv, int S, int hd,
                        long long qsb, long long qsh, long long qss,
                        long long ksb, long long ksh, long long kss, float scale,
                        int causal, int dtype, void* stream) {
  const Strides sq{qsb, qsh, qss}, sk{ksb, ksh, kss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  TONY_DISPATCH(dq_bf16, dq, q, k, v, dout, lse, delta, dq_out, B, H, Hkv, S, sq, sk,
                scale, causal, s);
}

extern "C" int flash_dkv(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dk_out, void* dv_out, int B, int H, int Hkv, int S,
                         int hd, long long qsb, long long qsh, long long qss,
                         long long ksb, long long ksh, long long kss, float scale,
                         int causal, int dtype, void* stream) {
  const Strides sq{qsb, qsh, qss}, sk{ksb, ksh, kss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  TONY_DISPATCH(dkv_tc, dkv, q, k, v, dout, lse, delta, dk_out, dv_out, B, H, Hkv, S,
                sq, sk, scale, causal, s);
}

// Which instance a kernel (0 flash_fwd, 1 flash_dq, 2 flash_dkv) runs for
// dtype and hd: 1 the tensor-core one (wgmma + TMA), 0 the scalar one, -1
// none. It mirrors the TONY_DISPATCH arguments above.
extern "C" int flash_route(int kernel, int dtype, int hd) {
  if ((hd != 64 && hd != 128) || (dtype != 0 && dtype != 1) || kernel < 0 || kernel > 2)
    return -1;
  return dtype == 1 && kernel != 1 ? 1 : 0;
}
