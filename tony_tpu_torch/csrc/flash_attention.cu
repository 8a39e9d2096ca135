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
// bf16: tensor cores (namespace tc). Tiles are 64-column halves of hd in
// 128-byte-swizzled shared memory, loaded by TMA (cp.async.bulk.tensor over
// 4-D tensor maps of (hd, S, heads, B) with the caller's strides; rows past
// S arrive as zeros) through rings of full/empty mbarriers, and read by
// wgmma through descriptors: K-major for Q, K, V and dO as the "rows .
// rows" operands, MN-major (transposed) for V, K, dO and Q as the second
// operand of P.V, dS.K, P^T.dO and dS^T.Q. Products are wgmma m64nNk16,
// bf16 in, float32 out. The mbarrier, TMA, descriptor and wgmma wrappers
// are in sm90.cuh.
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
// - flash_dq: one CTA per (128 query rows, b * H + h), the longest causal
//   rows first; 288 threads: warpgroups 0 and 1 own 64 rows each, warp 8
//   is the producer. Q and dO are loaded once and stay resident; K and V
//   stream through a 3-stage ring in 64-key tiles. Per tile: S = Q.K^T and
//   dP = dO.V^T from shared memory, P = exp2(S scale log2 e - lse log2 e),
//   dS = P (dP - delta) scale, rounded to bf16 and repacked as the register
//   operand of dQ += dS.K, K read again MN-major from the same tile. A
//   consumer holds S, dP and dQ: 128 floats at hd 128, as the forward's
//   S and O. The tile is 64 keys for that reason (128 would hold 192,
//   the dk/dv case). Whole tiles above a warpgroup's diagonal contribute
//   no products; keys after a row and columns past S are masked by select
//   on edge tiles. dq stays a kernel of its own, as in the reference: no
//   atomics, so it is deterministic.
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
// float32: the first design, scalar float32 FMA on CUDA cores. 64 x 64
// tiles, 256 threads, a 4 x 4 block of the score tile per thread; Q, K, V
// and dO staged as float32 transposed to [hd][65] (the stride of 65 words
// keeps the staging stores and the column reads free of bank conflicts);
// p and ds pass through shared memory. The tensor cores have no float32
// path that holds 1e-4 (TF32 keeps about 10 bits), so float32 stays here.
// Its flash_dq keeps p and ds in float32, as the TPU kernel does.
//
// What bounds it on this card: operations. At the training shapes
// (S = 2048, hd = 128) a tile does 2 * 64 * 128 * 128 flops per matmul
// against 128 * 128 * 2 bytes loaded, far above the H100's ~295 flop/byte
// ridge. The least time is the causal matmul flops over the bf16
// tensor-core peak of 989 TFLOP/s (H100 SXM data sheet); the scalar
// instances peak at the CUDA cores' 67 TFLOP/s. Measured times are in
// PERF.md.

#include <math.h>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;          // query rows and key positions per tile
constexpr int kLd = kTile + 1;     // shared-memory row stride (words)
constexpr float kNeg = -0.7f * 3.4028234663852886e38f;

struct Strides {
  long long sb, sh, ss;            // batch, head, position (d has stride 1)
};

// the scalar kernels' element type: float32 (bf16 runs on the tensor cores)
__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

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

// ---------------------------------------------------- scalar dq (float32)

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
constexpr int kDqThreads = 288;    // dq: warpgroups 0 and 1 consume, warp 8 produces
constexpr int kConsumers = 256;    // the two compute warpgroups (dkv: the whole CTA)
constexpr int kRows = 128;         // fwd, dq: q rows per CTA; fwd: keys per tile; dkv: keys per CTA
constexpr int kQRows = 64;         // dkv: q rows per tile
constexpr int kKeys = 64;          // dq: keys per tile
constexpr int kStages = 2;
constexpr int kDqStages = 3;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// a [rows, HD] tile as HD / 64 halves of [rows][64], one after the other
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap& map, uint32_t bar,
                                          int s0, int head, int b, int rows) {
#pragma unroll
  for (int h = 0; h < HD / kHalf; ++h)
    tma_load(dst + h * rows * 128, map, bar, h * kHalf, s0, head, b);
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

// dynamic shared memory: 1 KB of slack to align the tiles to 1024 bytes
constexpr int fwd_smem(int hd) { return 1024 + (1 + 2 * kStages) * kRows * hd * 2; }
constexpr int dq_smem(int hd) { return 1024 + 2 * kRows * hd * 2 + 2 * kDqStages * kKeys * hd * 2; }
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

// --------------------------------------------------------------------- dq

// Q and dO resident, K and V streamed in 64-key tiles through a 3-stage
// ring. A producer warp (warp 8) rather than a warpgroup: ptxas gives each
// thread of a CTA the same register budget, 65,536 over the CTA's threads
// (168 at 384 threads, 224 at 288), and a consumer holds S, dP and dQ.
template <int HD>
__global__ void __launch_bounds__(kDqThreads, 1)
flash_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                const __grid_constant__ CUtensorMap omap, const float* __restrict__ lse,
                const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int H,
                int Hkv, int S, Strides sq, float scale, int causal) {
  constexpr int kQ = kRows * HD * 2, kKV = kKeys * HD * 2;      // tile bytes
  constexpr int kQHalf = kRows * 128, kKVHalf = kKeys * 128;    // half-tile bytes
  extern __shared__ uint8_t smem[];
  __shared__ __align__(8) uint64_t bars[1 + 4 * kDqStages];
  const uint32_t sQ = (saddr(smem) + 1023) & ~1023u, sO = sQ + kQ;
  const uint32_t sK = sO + kQ, sV = sK + kDqStages * kKV;
  // q_full (Q and dO), then k_full[s], v_full[s], k_empty[s], v_empty[s]
  const uint32_t q_full = saddr(bars), k_full = q_full + 8, v_full = k_full + 8 * kDqStages;
  const uint32_t k_empty = v_full + 8 * kDqStages, v_empty = k_empty + 8 * kDqStages;

  // a 1-D grid, the longest causal rows first (see the forward)
  const int nt = (S + kRows - 1) / kRows, BH = gridDim.x / nt;
  const int bh = blockIdx.x % BH, b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int i0 = (nt - 1 - blockIdx.x / BH) * kRows;
  int nk = (S + kKeys - 1) / kKeys;
  if (causal) nk = min(nk, (i0 + kRows) / kKeys);

  if (threadIdx.x == 0) {
    bar_init(q_full, 1);
    for (int s = 0; s < kDqStages; ++s) {
      bar_init(k_full + 8 * s, 1);
      bar_init(v_full + 8 * s, 1);
      bar_init(k_empty + 8 * s, kConsumers);
      bar_init(v_empty + 8 * s, kConsumers);
    }
    init_done();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // producer: one thread keeps the loads in flight
    if (threadIdx.x == kConsumers) {
      bar_expect(q_full, 2 * kQ);
      load_tile<HD>(sQ, qmap, q_full, i0, h, b, kRows);
      load_tile<HD>(sO, omap, q_full, i0, h, b, kRows);
      for (int t = 0; t < nk; ++t) {
        const int s = t % kDqStages;
        const uint32_t ph = (t / kDqStages) & 1;
        bar_wait(k_empty + 8 * s, ph ^ 1);
        bar_expect(k_full + 8 * s, kKV);
        load_tile<HD>(sK + s * kKV, kmap, k_full + 8 * s, t * kKeys, hk, b, kKeys);
        bar_wait(v_empty + 8 * s, ph ^ 1);
        bar_expect(v_full + 8 * s, kKV);
        load_tile<HD>(sV + s * kKV, vmap, v_full + 8 * s, t * kKeys, hk, b, kKeys);
      }
    }
    return;
  }

  const int cw = threadIdx.x / 128, tid = threadIdx.x % 128, lane = tid % 32, t4 = lane % 4;
  const int rw = i0 + 64 * cw;                     // this warpgroup's first row
  const int r0 = rw + 16 * (tid / 32) + lane / 4;  // this thread's rows r0, r0 + 8
  // the last key tile its rows attend (whole tiles above the diagonal
  // contribute nothing); none when its rows all lie past S
  const int last = rw >= S ? -1 : causal ? rw / kKeys : nk - 1;
  const float sl2 = scale * kLog2e;
  float l2[2], dl[2];                              // lse in log2 units, delta
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = r0 + 8 * r < S;
    l2[r] = in ? lse[(long long)bh * S + r0 + 8 * r] * kLog2e : 0.f;
    dl[r] = in ? delta[(long long)bh * S + r0 + 8 * r] : 0.f;
  }
  const uint32_t aQ = sQ + cw * 64 * 128, aO = sO + cw * 64 * 128;  // its rows of each half
  float g[HD / 2];
  zero(g);
  bar_wait(q_full, 0);
  for (int t = 0; t < nk; ++t) {
    const int s = t % kDqStages, j0 = t * kKeys;
    const uint32_t ph = (t / kDqStages) & 1;
    bar_wait(k_full + 8 * s, ph);
    bar_wait(v_full + 8 * s, ph);
    if (t > last) {                  // the tile's keys all follow its rows
      bar_arrive(v_empty + 8 * s);
      bar_arrive(k_empty + 8 * s);
      continue;
    }
    float st[32], dp[32];
    zero(st);
    zero(dp);
    hold(st);
    hold(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t qo = (kk / 4) * kQHalf + (kk % 4) * 32;
      const uint32_t ko = s * kKV + (kk / 4) * kKVHalf + (kk % 4) * 32;
      mma_ss<kKeys>(st, desc(aQ + qo, 16), desc(sK + ko, 16), kk);
      mma_ss<kKeys>(dp, desc(aO + qo, 16), desc(sV + ko, 16), kk);
    }
    wg_commit();
    wg_wait();
    hold(st);
    hold(dp);
    bar_arrive(v_empty + 8 * s);

    // P and dS; masks on the diagonal tile and past S, by select, so no
    // inf from a masked score reaches a product
    const bool edge = (causal && j0 + kKeys > rw) || j0 + kKeys > S;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int ri = (i >> 1) & 1;
      float p = exp2f(st[i] * sl2 - l2[ri]);
      if (edge) {
        const int r = r0 + 8 * ri, c = j0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        if (c >= S || (causal && c > r)) p = 0.f;
      }
      dp[i] = p * (dp[i] - dl[ri]) * scale;
    }
    uint32_t da[16];
    to_a(dp, da);
    hold(g);
    hold(da);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
      mma_rs<HD>(g, &da[4 * kk], desc(sK + s * kKV + kk * 16 * 128, kKVHalf), 1);
    wg_commit();
    wg_wait();
    hold(g);
    bar_arrive(k_empty + 8 * s);
  }

  const float one[2] = {1.f, 1.f};
  __nv_bfloat16* base = dq + b * sq.sb + h * sq.sh + 2 * t4;
  store_rows<HD>(g, r0 < S ? base + (long long)r0 * sq.ss : nullptr,
                 r0 + 8 < S ? base + (long long)(r0 + 8) * sq.ss : nullptr, one);
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

// 4-D map of a bf16 tensor over (hd, S, heads, B) with element strides st,
// boxes of (64, rows, 1, 1); positions past S read as zero. A dimension of
// size 1 gets a stride of its own (the caller's may be any number there,
// and its only coordinate is 0).
int make_map(CUtensorMap* map, const void* ptr, int hd, int S, int heads, int B, Strides st,
             int rows) {
  auto stride = [hd](long long s, int n) { return n > 1 ? s : (long long)hd; };
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)S, (cuuint64_t)heads, (cuuint64_t)B};
  const long long strides[3] = {stride(st.ss, S), stride(st.sh, heads), stride(st.sb, B)};
  const cuuint32_t box[4] = {(cuuint32_t)tc::kHalf, (cuuint32_t)rows, 1, 1};
  return encode_map<4>(map, ptr, dims, strides, box);
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
int dq_tc(const void* q, const void* k, const void* v, const void* dout, const void* lse,
          const void* delta, void* dq_out, int B, int H, int Hkv, int S, Strides sq,
          Strides sk, float scale, int causal, cudaStream_t stream) {
  CUtensorMap qm, km, vm, om;
  int e = make_map(&qm, q, HD, S, H, B, sq, tc::kRows);
  if (!e) e = make_map(&om, dout, HD, S, H, B, sq, tc::kRows);
  if (!e) e = make_map(&km, k, HD, S, Hkv, B, sk, tc::kKeys);
  if (!e) e = make_map(&vm, v, HD, S, Hkv, B, sk, tc::kKeys);
  if (e) return e;
  const int smem = tc::dq_smem(HD);
  cudaError_t err = allow_smem(tc::flash_dq_kernel<HD>, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (S + tc::kRows - 1) / tc::kRows;
  tc::flash_dq_kernel<HD><<<tiles * B * H, tc::kDqThreads, smem, stream>>>(
      qm, km, vm, om, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq_out), H, Hkv, S, sq, scale, causal);
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
// the bf16 tensor-core instance, FN the scalar float32 one (flash_route).
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
  TONY_DISPATCH(dq_tc, dq, q, k, v, dout, lse, delta, dq_out, B, H, Hkv, S, sq, sk,
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
  return dtype == 1 ? 1 : 0;
}
