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
// p = exp(s - lse), take ds = p * (dO . v - delta) * scale, and keep p and
// ds in float32 for dv += p^T dO, dk += ds^T q, dq += ds k, as the TPU
// kernels do. delta = rowsum(dO * out) is computed by the caller.
//
// Layouts. Each tensor is addressed as (batch b, head h, position s, dim d)
// with d of unit stride and element strides (sb, sh, ss) for the rest, so
// the same kernels read the model's [B, S, H, hd] activations with no
// transpose and the reference's folded [B * H, S, hd] layout alike. q, out,
// dO and dq share one set of strides, k, v, dk and dv another. lse and
// delta are float32 [B * H, S]. Head h reads kv head h / (H / Hkv), the
// TPU kernel's _kv_index.
//
// Shape of the work. Tiles of 64 query rows by 64 key positions, 256
// threads. A thread holds a 4 x 4 block of the 64 x 64 score tile (rows
// 4 * ty + i, columns tx + 16 * j for ty, tx in 0..15) and a 4 x hd/16
// block of each [64, hd] accumulator (columns tx + 16 * j). Q, K, V and dO
// tiles are staged in shared memory as float32, transposed to [hd][65]:
// the stride of 65 words keeps both the staging stores and the
// column-strided reads free of bank conflicts. A row's max and sum are
// shuffles across the 16 lanes that hold it.
// - flash_fwd: one CTA per (b * H + h, q tile), walking k tiles up to the
//   diagonal (whole tiles above it are skipped, the TPU kernel's
//   j * blk_k <= i * blk_q + blk_q - 1). The online-softmax state lives in
//   registers; p passes through shared memory for P.V.
// - flash_dq: one CTA per (b * H + h, q tile), the same walk; ds passes
//   through shared memory for ds . K.
// - flash_dkv: one CTA per (b * Hkv + kv head, k tile). It walks every q
//   tile on or below the diagonal of every query head of the GQA group, so
//   dk and dv accumulate in registers without atomics, as the TPU grid's
//   innermost (rep * nq) dimension does.
// The math is scalar float32 FMA, the same code for float32 and bfloat16
// inputs; the tensor-core (wgmma/TMA) redesign is later work.
//
// What bounds it on this card: operations. At the training shapes
// (S = 2048, hd = 128) a tile does 2 * 64 * 64 * 128 flops per matmul
// against 64 * 128 * 2 bytes loaded, far above the H100's ~295 flop/byte
// ridge. The least time is the causal matmul flops over the bf16
// tensor-core peak of 989 TFLOP/s (H100 SXM data sheet); scalar FMA on
// CUDA cores peaks at 67 TFLOP/s, so these kernels sit an order of
// magnitude above that bound by design. Measured times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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

// ---------------------------------------------------------------- forward

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

// --------------------------------------------------------------------- dq

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

// ------------------------------------------------------------------ dk/dv

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

// head_dim and dtype are template arguments: pick the instance
#define TONY_DISPATCH(FN, ...)                                                  \
  do {                                                                        \
    if (dtype == 1) {                                                         \
      switch (hd) {                                                           \
        case 64: return FN<__nv_bfloat16, 64>(__VA_ARGS__);                   \
        case 128: return FN<__nv_bfloat16, 128>(__VA_ARGS__);                 \
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
// launched), or -1 for a head_dim or dtype it has no instance for.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* out,
                         void* lse, int B, int H, int Hkv, int S, int hd,
                         long long qsb, long long qsh, long long qss,
                         long long ksb, long long ksh, long long kss, float scale,
                         int causal, int dtype, void* stream) {
  const Strides sq{qsb, qsh, qss}, sk{ksb, ksh, kss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  TONY_DISPATCH(fwd, q, k, v, out, lse, B, H, Hkv, S, sq, sk, scale, causal, s);
}

extern "C" int flash_dq(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dq_out, int B, int H, int Hkv, int S, int hd,
                        long long qsb, long long qsh, long long qss,
                        long long ksb, long long ksh, long long kss, float scale,
                        int causal, int dtype, void* stream) {
  const Strides sq{qsb, qsh, qss}, sk{ksb, ksh, kss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  TONY_DISPATCH(dq, q, k, v, dout, lse, delta, dq_out, B, H, Hkv, S, sq, sk,
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
  TONY_DISPATCH(dkv, q, k, v, dout, lse, delta, dk_out, dv_out, B, H, Hkv, S,
                sq, sk, scale, causal, s);
}
