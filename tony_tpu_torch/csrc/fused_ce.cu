// Fused cross-entropy head for Hopper (sm_90a): per-token loss, dh and dW
// from hidden states h [N, D] and lm_head W [D, V] without ever holding
// [N, V] logits.
//
// Replaces the three TPU kernels of tony_tpu/ops/fused_ce.py:
//   ce_fwd <- _ce_fwd_kernel (:164)  lse = m + log(max(s, 1e-30)) and the
//                                    target logit tl, online over the vocab
//   ce_dh  <- _ce_dh_kernel  (:204)  dh = sum_v dlogits W^T, dlogits =
//                                    (exp(logits - lse) - onehot) g
//   ce_dw  <- _ce_dw_kernel  (:236)  dW = h^T dlogits, one writer per column
// and computes what they compute: products of the input type summed in
// float32, padded vocab columns and rows past N kept out of every sum by
// select. dlogits are rounded to h's type before the backward's products,
// as the scan head does (tony_tpu_torch/ops/fused_ce.py _scan_bwd).
//
// Layouts, all row-major and dense: h [N, D], W [D, V], tgt int32 [N], lse
// and g float32 [N]; dh like h, dW like W. D and V are multiples of 8 and
// every pointer is 16-byte aligned (the wrapper checks): operands load 16
// bytes at a time.
//
// Why not the TPU's blocks. The TPU kernels keep [512, D] (dh) and [D, 512]
// (dW) float32 accumulators in VMEM across a sequential grid: 4 MB each at
// D 2048. An H100 CTA has at most 227 KB of shared memory, and its CTAs
// run in no order. So:
// - ce_fwd: a CTA owns 128 rows and one split of the vocab's 128-column
//   tiles. Per tile it forms the [128, 128] float32 logits in registers
//   (a GEMM main loop over D) and folds them into three per-row scalars in
//   shared memory (m, s, tl); nothing else survives a tile. With one CTA
//   per 128 rows alone, bench_1b4's 16,384 rows would give 128 CTAs for 132
//   SMs, so the vocab is split across CTAs (flash-decoding's trick) and a
//   second, small kernel merges each row's partial (m, s, tl). Both kernels
//   are one launch of ce_fwd.
// - backward, per vocab chunk of Vc columns (the wrapper's loop): ce_dh
//   recomputes the chunk's logits once and writes dlogits in h's type to a
//   [N, Vc] scratch (kernel a), then accumulates dh_f32 += dlogits W_c^T
//   (kernel b; the last chunk writes dh in h's type). ce_dw then writes the
//   chunk's dW columns once, dW_c = h^T dlogits, from the same scratch. The
//   logits are recomputed once, where the TPU kernels recompute them in dh
//   and again in dW.
//
// Every product is one tiled GEMM loop: a CTA of 256 threads owns a 128 x
// 128 output tile with float32 accumulators in registers and walks the
// contraction in staged slices, two buffers deep.
// - bf16 on the tensor cores: mma.sync m16n8k16 on slices of 32 staged as
//   bf16, fragments loaded with ldmatrix; 8 warps split the tile 2 x 4.
// - float32 on scalar FMA: slices of 16, 8 x 8 accumulators a thread.
// (The tile code is grouped_mm.cu's, copied so that each source builds and
// hashes on its own.)
//
// NaN. fmaxf drops a NaN, so a running max built on it never holds one;
// a NaN logit still reaches its row's s through exp(NaN - m), and the final
// max(s, 1e-30) keeps a NaN s. A NaN weight therefore reaches every loss,
// dh and dW, as the TPU kernels let it. The padded-column and padded-row
// masks are selects on indices and never touch a real value.
//
// What bounds it on this card: operations. One pass of h W at bench_1b4's
// shapes (N 16,384, D 2048, V 32,000) is 2.15e12 operations on 0.2 GB of
// bf16 operands, far above the H100's ~295 operations per byte, so the
// least time is the operations over the bf16 tensor-core peak (989
// TFLOP/s): 2.17 ms per pass, one pass in ce_fwd, two in ce_dh, one in
// ce_dw. mma.sync without TMA or wgmma reaches part of that peak; the
// float32 path is bounded by the CUDA cores' 67 TFLOP/s. Measured times are
// in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;   // output rows and columns per CTA
constexpr int kSlice = 16;   // float32 contraction depth per staged slice
constexpr float kNeg = -0.7f * 3.402823466e38f;   // the TPU kernels' _NEG

__device__ __forceinline__ void load8(float (&v)[8], const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// ------------------------------------------------ float32: scalar FMA tiles
// One operand of C[m, n] = sum_k A(m, k) B(k, n), seen along its output dim
// ("mn"). KC: element (mn, k) at p[mn * ld + k]; otherwise at p[k * ld +
// mn]. Rows mn >= mn_end and depths k >= k_end read as zero.
template <bool KC>
struct Operand {
  const float* p;
  long long ld;
  int mn0, mn_end;

  __device__ __forceinline__ void fetch(float (&v)[8], int k0, int k_end) const {
    const int t = threadIdx.x;
    const int mn = mn0 + (KC ? t >> 1 : (t & 15) * 8);
    const int k = k0 + (KC ? (t & 1) * 8 : t >> 4);
    if (mn < mn_end && k < k_end) {
      load8(v, p + (KC ? (long long)mn * ld + k : (long long)k * ld + mn));
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = 0.f;
    }
  }

  // store what fetch() read into s[k][mn] ([kSlice][kTile] floats)
  __device__ __forceinline__ void put(float* s, const float (&v)[8]) const {
    const int t = threadIdx.x;
    if (KC) {
      const int mn = t >> 1, k = (t & 1) * 8;
#pragma unroll
      for (int j = 0; j < 8; ++j) s[(k + j) * kTile + mn] = v[j];
    } else {
      float4* d = reinterpret_cast<float4*>(s + (t >> 4) * kTile + (t & 15) * 8);
      d[0] = make_float4(v[0], v[1], v[2], v[3]);
      d[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
};

__device__ __forceinline__ void fma_slice(float (&acc)[8][8], const float* sa,
                                          const float* sb) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int k = 0; k < kSlice; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(sa + k * kTile + ty * 4);
    const float4 a1 = *reinterpret_cast<const float4*>(sa + k * kTile + 64 + ty * 4);
    const float4 b0 = *reinterpret_cast<const float4*>(sb + k * kTile + tx * 4);
    const float4 b1 = *reinterpret_cast<const float4*>(sb + k * kTile + 64 + tx * 4);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <bool A_KC, bool B_KC>
__device__ __forceinline__ void gemm_tile(float (&acc)[8][8], const Operand<A_KC>& A,
                                          const Operand<B_KC>& B, int k_begin,
                                          int k_end) {
  __shared__ __align__(16) float sa[2][kSlice * kTile];
  __shared__ __align__(16) float sb[2][kSlice * kTile];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  if (k_begin >= k_end) return;

  float va[8], vb[8];
  A.fetch(va, k_begin, k_end);
  B.fetch(vb, k_begin, k_end);
  A.put(sa[0], va);
  B.put(sb[0], vb);
  __syncthreads();
  int buf = 0;
  for (int k0 = k_begin; k0 < k_end; k0 += kSlice) {
    const bool more = k0 + kSlice < k_end;
    if (more) {                       // next slice's loads fly during the FMAs
      A.fetch(va, k0 + kSlice, k_end);
      B.fetch(vb, k0 + kSlice, k_end);
    }
    fma_slice(acc, sa[buf], sb[buf]);
    if (more) {
      A.put(sa[buf ^ 1], va);
      B.put(sb[buf ^ 1], vb);
    }
    __syncthreads();
    buf ^= 1;
  }
}

// ------------------------------------------------ bf16: tensor-core tiles
constexpr int kHSlice = 32;            // contraction depth per staged slice
constexpr int kLdK = kHSlice + 8;      // [mn][k] row, elements
constexpr int kLdMN = kTile + 8;       // [k][mn] row, elements
constexpr int kHBuf = kTile * kLdK;    // one operand's slice buffer (>= kHSlice * kLdMN)

template <bool KC>
struct OperandH {
  const __nv_bfloat16* p;
  long long ld;
  int mn0, mn_end;

  __device__ __forceinline__ void fetch(uint4 (&v)[2], int k0, int k_end) const {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int e = threadIdx.x + c * kThreads;
      const int mn = mn0 + (KC ? e >> 2 : (e & 15) * 8);
      const int k = k0 + (KC ? (e & 3) * 8 : e >> 4);
      v[c] = mn < mn_end && k < k_end
                 ? *reinterpret_cast<const uint4*>(
                       p + (KC ? (long long)mn * ld + k : (long long)k * ld + mn))
                 : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  __device__ __forceinline__ void put(__nv_bfloat16* s, const uint4 (&v)[2]) const {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int e = threadIdx.x + c * kThreads;
      const int off = KC ? (e >> 2) * kLdK + (e & 3) * 8 : (e >> 4) * kLdMN + (e & 15) * 8;
      *reinterpret_cast<uint4*>(s + off) = v[c];
    }
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <bool A_KC, bool B_KC>
__device__ __forceinline__ void mma_slice(float (&acc)[4][4][4],
                                          const __nv_bfloat16* sa,
                                          const __nv_bfloat16* sb) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int r8 = lane & 7, hi = (lane >> 3) & 1, q = lane >> 4;
#pragma unroll
  for (int kk = 0; kk < kHSlice; kk += 16) {
    uint32_t a[4][4], b[2][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int m = wm + mt * 16;
      if (A_KC) ldsm_x4(a[mt], sa + (m + r8 + 8 * hi) * kLdK + kk + 8 * q);
      else ldsm_x4_t(a[mt], sa + (kk + r8 + 8 * q) * kLdMN + m + 8 * hi);
    }
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      const int n = wn + np * 16;
      if (B_KC) ldsm_x4(b[np], sb + (n + r8 + 8 * q) * kLdK + kk + 8 * hi);
      else ldsm_x4_t(b[np], sb + (kk + r8 + 8 * hi) * kLdMN + n + 8 * q);
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        mma_bf16(acc[mt][nt], a[mt], b[nt >> 1][(nt & 1) * 2], b[nt >> 1][(nt & 1) * 2 + 1]);
  }
}

template <bool A_KC, bool B_KC>
__device__ __forceinline__ void gemm_tile_tc(float (&acc)[4][4][4], const OperandH<A_KC>& A,
                                             const OperandH<B_KC>& B, int k_begin,
                                             int k_end) {
  __shared__ __align__(16) __nv_bfloat16 sa[2][kHBuf];
  __shared__ __align__(16) __nv_bfloat16 sb[2][kHBuf];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
  if (k_begin >= k_end) return;

  uint4 va[2], vb[2];
  A.fetch(va, k_begin, k_end);
  B.fetch(vb, k_begin, k_end);
  A.put(sa[0], va);
  B.put(sb[0], vb);
  __syncthreads();
  int buf = 0;
  for (int k0 = k_begin; k0 < k_end; k0 += kHSlice) {
    const bool more = k0 + kHSlice < k_end;
    if (more) {
      A.fetch(va, k0 + kHSlice, k_end);
      B.fetch(vb, k0 + kHSlice, k_end);
    }
    mma_slice<A_KC, B_KC>(acc, sa[buf], sb[buf]);
    if (more) {
      A.put(sa[buf ^ 1], va);
      B.put(sb[buf ^ 1], vb);
    }
    __syncthreads();
    buf ^= 1;
  }
}

// ------------------------------------------------ the tile as epilogues see it
// A thread's part of the CTA's 128 x 128 float32 tile: 8 row slots r and 8
// column slots c. row(r) and col(c) are offsets inside the tile. The
// threads that share a row reduce over their lanes with row_max/row_sum,
// then over kParts partial results in shared memory (part() is the slot a
// thread's result goes to, writer() the one lane per part that writes it).

// mma layout: accumulator (mt, nt, e) of lane l in warp w is row
// 64 (w / 4) + 16 mt + l / 4 (+ 8 for e >= 2), column 32 (w % 4) + 8 nt +
// 2 (l % 4) (+ 1 for odd e); a row is shared by the 4 lanes of a quad in
// each of the 4 warps with the same w / 4
struct TileTC {
  static constexpr int kParts = 4;
  float a[4][4][4];
  __device__ __forceinline__ float& at(int r, int c) {
    return a[r >> 1][c >> 1][(r & 1) * 2 + (c & 1)];
  }
  __device__ static __forceinline__ int row(int r) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    return (warp >> 2) * 64 + (r >> 1) * 16 + (lane >> 2) + (r & 1) * 8;
  }
  __device__ static __forceinline__ int col(int c) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    return (warp & 3) * 32 + (c >> 1) * 8 + 2 * (lane & 3) + (c & 1);
  }
  __device__ static __forceinline__ float row_max(float x) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  }
  __device__ static __forceinline__ float row_sum(float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
  }
  __device__ static __forceinline__ int part() { return (threadIdx.x >> 5) & 3; }
  __device__ static __forceinline__ bool writer() { return (threadIdx.x & 3) == 0; }
};

// FMA layout: thread (ty, tx) = (tid / 16, tid % 16) holds rows 4 ty + i
// and 64 + 4 ty + i, columns likewise from tx; a row's 16 threads are one
// half-warp
struct TileF32 {
  static constexpr int kParts = 1;
  float a[8][8];
  __device__ __forceinline__ float& at(int r, int c) { return a[r][c]; }
  __device__ static __forceinline__ int row(int r) {
    const int ty = threadIdx.x >> 4;
    return r < 4 ? ty * 4 + r : 64 + ty * 4 + r - 4;
  }
  __device__ static __forceinline__ int col(int c) {
    const int tx = threadIdx.x & 15;
    return c < 4 ? tx * 4 + c : 64 + tx * 4 + c - 4;
  }
  __device__ static __forceinline__ float row_max(float x) {
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
  }
  __device__ static __forceinline__ float row_sum(float x) {
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
  }
  __device__ static __forceinline__ int part() { return 0; }
  __device__ static __forceinline__ bool writer() { return (threadIdx.x & 15) == 0; }
};

template <typename T>
using TileOf = std::conditional_t<std::is_same_v<T, __nv_bfloat16>, TileTC, TileF32>;

// tile = sum over k in [k_begin, k_end) of A(m0 + i, k) B(k, n0 + j); rows
// past m_end and columns past n_end read as zero. Every thread of the CTA
// calls it with the same arguments.
template <typename T, bool A_KC, bool B_KC>
__device__ __forceinline__ void product(TileOf<T>& t, const T* a, long long lda, int m0,
                                        int m_end, const T* b, long long ldb, int n0,
                                        int n_end, int k_begin, int k_end) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    gemm_tile_tc(t.a, OperandH<A_KC>{a, lda, m0, m_end}, OperandH<B_KC>{b, ldb, n0, n_end},
                 k_begin, k_end);
  } else {
    gemm_tile(t.a, Operand<A_KC>{a, lda, m0, m_end}, Operand<B_KC>{b, ldb, n0, n_end},
              k_begin, k_end);
  }
}

// max(s, 1e-30) that keeps a NaN s, as jnp.maximum does
__device__ __forceinline__ float floor_keep_nan(float s) {
  return s != s ? s : fmaxf(s, 1e-30f);
}

// ---------------------------------------------------------------- kernels

// grid (splits, row blocks). CTA (split, i): rows [128 i, 128 i + 128),
// vocab tiles [split * tps, min(n_tiles, (split + 1) * tps)); writes the
// rows' partial (m, s, tl) over its tiles to part[{0, 1, 2}][split][row]
template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_fwd_kernel(const T* __restrict__ h, const T* __restrict__ w,
              const int* __restrict__ tgt, float* __restrict__ part, int N, int D, int V,
              int tps) {
  using Tile = TileOf<T>;
  __shared__ float red_m[Tile::kParts][kTile];
  __shared__ float red_s[Tile::kParts][kTile];
  __shared__ float m_sm[kTile], s_sm[kTile], t_sm[kTile];
  __shared__ int tgt_sm[kTile];
  const int split = blockIdx.x, r0 = blockIdx.y * kTile;
  const int n_tiles = (V + kTile - 1) / kTile;
  const int t_begin = split * tps, t_end = min(n_tiles, t_begin + tps);
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    m_sm[i] = kNeg;
    s_sm[i] = 0.f;
    t_sm[i] = 0.f;
    tgt_sm[i] = r0 + i < N ? tgt[r0 + i] : -1;
  }
  __syncthreads();

  Tile t;
  for (int vt = t_begin; vt < t_end; ++vt) {
    const int c0 = vt * kTile;
    // logits: A(m = row, k = d) = h[row, d] (KC); B(k = d, n = v) = W[d, v]
    product<T, true, false>(t, h, D, r0, N, w, V, c0, V, 0, D);
    // columns past V to kNeg by select, before they touch m or s
    float part_max[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      float x = kNeg;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float& v = t.at(r, c);
        v = c0 + Tile::col(c) < V ? v : kNeg;
        x = fmaxf(x, v);
      }
      part_max[r] = Tile::row_max(x);
    }
    if (Tile::writer()) {
#pragma unroll
      for (int r = 0; r < 8; ++r) red_m[Tile::part()][Tile::row(r)] = part_max[r];
    }
    __syncthreads();
    float part_sum[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = Tile::row(r);
      float m_new = m_sm[row];
#pragma unroll
      for (int p = 0; p < Tile::kParts; ++p) m_new = fmaxf(m_new, red_m[p][row]);
      float x = 0.f;
      const int want = tgt_sm[row] - c0;   // the target's column in this tile
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float v = t.at(r, c);
        x += expf(v - m_new);
        // exactly one thread holds a row's target column; one in [V, ...) never counts
        if (Tile::col(c) == want && c0 + Tile::col(c) < V) t_sm[row] = v;
      }
      part_sum[r] = Tile::row_sum(x);
    }
    if (Tile::writer()) {
#pragma unroll
      for (int r = 0; r < 8; ++r) red_s[Tile::part()][Tile::row(r)] = part_sum[r];
    }
    __syncthreads();
    if (threadIdx.x < kTile) {
      const int row = threadIdx.x;
      const float m_old = m_sm[row];
      float m_new = m_old, s = 0.f;
#pragma unroll
      for (int p = 0; p < Tile::kParts; ++p) m_new = fmaxf(m_new, red_m[p][row]);
#pragma unroll
      for (int p = 0; p < Tile::kParts; ++p) s += red_s[p][row];
      s_sm[row] = s_sm[row] * expf(m_old - m_new) + s;
      m_sm[row] = m_new;
    }
    __syncthreads();
  }
  if (threadIdx.x < kTile && r0 + (int)threadIdx.x < N) {
    const long long at = (long long)split * N + r0 + threadIdx.x;
    const long long plane = (long long)gridDim.x * N;
    part[at] = m_sm[threadIdx.x];
    part[plane + at] = s_sm[threadIdx.x];
    part[2 * plane + at] = t_sm[threadIdx.x];
  }
}

// one thread per row: merge the splits' (m, s, tl) into lse and tl
__global__ void ce_fwd_merge_kernel(const float* __restrict__ part,
                                    const int* __restrict__ tgt, float* __restrict__ lse,
                                    float* __restrict__ tl, int N, int V, int splits,
                                    int tps) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  const long long plane = (long long)splits * N;
  float m = kNeg;
  for (int i = 0; i < splits; ++i) m = fmaxf(m, part[(long long)i * N + row]);
  float s = 0.f;
  for (int i = 0; i < splits; ++i) {
    const long long at = (long long)i * N + row;
    s += part[plane + at] * expf(part[at] - m);
  }
  lse[row] = m + logf(floor_keep_nan(s));
  const int t = tgt[row];
  tl[row] = t >= 0 && t < V ? part[2 * plane + (long long)(t / kTile / tps) * N + row] : 0.f;
}

// backward (a): dl[row, v] = (exp(logit - lse) - onehot) g for the chunk's
// columns v in [0, vc) (global column c0 + v), rounded to T
template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_dlogits_kernel(const T* __restrict__ h, const T* __restrict__ w,
                  const int* __restrict__ tgt, const float* __restrict__ lse,
                  const float* __restrict__ g, T* __restrict__ dl, int N, int D, int V,
                  int c0, int vc, int ldl) {
  using Tile = TileOf<T>;
  const int r0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  Tile t;
  product<T, true, false>(t, h, D, r0, N, w + c0, V, n0, vc, 0, D);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = r0 + Tile::row(r);
    if (row >= N) continue;                  // rows past N are never written
    const float l = lse[row], gr = g[row];
    const int want = tgt[row] - c0;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = n0 + Tile::col(c);
      if (col >= vc) continue;               // nor columns past the chunk
      const float p = expf(t.at(r, c) - l);
      dl[(long long)row * ldl + col] = from_f<T>((p - (col == want ? 1.f : 0.f)) * gr);
    }
  }
}

// backward (b): dh[row, d] (+)= sum over the chunk's v of dl[row, v]
// W[d, c0 + v]; acc holds the float32 sum between chunks, the last chunk
// writes dh in T
template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_dh_kernel(const T* __restrict__ dl, const T* __restrict__ w, float* __restrict__ acc,
             T* __restrict__ dh, int N, int D, int V, int c0, int vc, int ldl, int first,
             int last) {
  using Tile = TileOf<T>;
  const int r0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  Tile t;
  // A(m = row, k = v) = dl[row, v] (KC); B(k = v, n = d) = W[d, c0 + v] (KC):
  // W's rows read along their contiguous v, the transpose taken in place
  product<T, true, true>(t, dl, ldl, r0, N, w + c0, V, n0, D, 0, vc);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = r0 + Tile::row(r);
    if (row >= N) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = n0 + Tile::col(c);
      if (col >= D) continue;
      const long long at = (long long)row * D + col;
      const float v = first ? t.at(r, c) : acc[at] + t.at(r, c);
      if (last) dh[at] = from_f<T>(v);
      else acc[at] = v;
    }
  }
}

// dW[d, c0 + v] = sum over rows of h[row, d] dl[row, v], written once
template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_dw_kernel(const T* __restrict__ h, const T* __restrict__ dl, T* __restrict__ dw,
             int N, int D, int V, int c0, int vc, int ldl) {
  using Tile = TileOf<T>;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  Tile t;
  // A(m = d, k = row) = h[row, d] (MC); B(k = row, n = v) = dl[row, v] (MC)
  product<T, false, false>(t, h, D, m0, D, dl, ldl, n0, vc, 0, N);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int d = m0 + Tile::row(r);
    if (d >= D) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = n0 + Tile::col(c);
      if (col < vc) dw[(long long)d * V + c0 + col] = from_f<T>(t.at(r, c));
    }
  }
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

template <typename T>
int fwd(const void* h, const void* w, const void* tgt, void* part, void* lse, void* tl,
        int N, int D, int V, int splits, cudaStream_t stream) {
  const int tps = cdiv(cdiv(V, kTile), splits);
  ce_fwd_kernel<T><<<dim3(splits, cdiv(N, kTile)), kThreads, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w), static_cast<const int*>(tgt),
      static_cast<float*>(part), N, D, V, tps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ce_fwd_merge_kernel<<<cdiv(N, kThreads), kThreads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const int*>(tgt),
      static_cast<float*>(lse), static_cast<float*>(tl), N, V, splits, tps);
  return (int)cudaGetLastError();
}

template <typename T>
int dh(const void* h, const void* w, const void* tgt, const void* lse, const void* g,
       void* dl, void* acc, void* dh_out, int N, int D, int V, int c0, int vc, int ldl,
       int first, int last, cudaStream_t stream) {
  ce_dlogits_kernel<T><<<dim3(cdiv(vc, kTile), cdiv(N, kTile)), kThreads, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w), static_cast<const int*>(tgt),
      static_cast<const float*>(lse), static_cast<const float*>(g), static_cast<T*>(dl),
      N, D, V, c0, vc, ldl);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ce_dh_kernel<T><<<dim3(cdiv(D, kTile), cdiv(N, kTile)), kThreads, 0, stream>>>(
      static_cast<const T*>(dl), static_cast<const T*>(w), static_cast<float*>(acc),
      static_cast<T*>(dh_out), N, D, V, c0, vc, ldl, first, last);
  return (int)cudaGetLastError();
}

template <typename T>
int dw(const void* h, const void* dl, void* dw_out, int N, int D, int V, int c0, int vc,
       int ldl, cudaStream_t stream) {
  ce_dw_kernel<T><<<dim3(cdiv(vc, kTile), cdiv(D, kTile)), kThreads, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(dl), static_cast<T*>(dw_out), N, D,
      V, c0, vc, ldl);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). dtype: 0 = float32, 1 =
// bfloat16 (h, W, dl, dh and dW share it; tgt is int32, lse, g, tl and the
// partials float32). Each returns the cudaError_t of its launches (0 =
// launched), or -1 for a dtype it has no instance for.

// lse, tl [N]; part: float32 scratch of 3 * splits * N
extern "C" int ce_fwd(const void* h, const void* w, const void* tgt, void* part, void* lse,
                      void* tl, int N, int D, int V, int splits, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return fwd<__nv_bfloat16>(h, w, tgt, part, lse, tl, N, D, V, splits, s);
  if (dtype == 0) return fwd<float>(h, w, tgt, part, lse, tl, N, D, V, splits, s);
  return -1;
}

// one vocab chunk [c0, c0 + vc): dl [N, ldl] gets the chunk's dlogits, then
// dh's float32 sum acc [N, D] grows by dl W_c^T (first: starts from zero;
// last: the sum is written to dh_out in h's dtype instead)
extern "C" int ce_dh(const void* h, const void* w, const void* tgt, const void* lse,
                     const void* g, void* dl, void* acc, void* dh_out, int N, int D, int V,
                     int c0, int vc, int ldl, int first, int last, int dtype,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dh<__nv_bfloat16>(h, w, tgt, lse, g, dl, acc, dh_out, N, D, V, c0, vc, ldl,
                             first, last, s);
  if (dtype == 0)
    return dh<float>(h, w, tgt, lse, g, dl, acc, dh_out, N, D, V, c0, vc, ldl, first,
                     last, s);
  return -1;
}

// dW[:, c0:c0 + vc] = h^T dl from the chunk's dlogits that ce_dh wrote
extern "C" int ce_dw(const void* h, const void* dl, void* dw_out, int N, int D, int V,
                     int c0, int vc, int ldl, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return dw<__nv_bfloat16>(h, dl, dw_out, N, D, V, c0, vc, ldl, s);
  if (dtype == 0) return dw<float>(h, dl, dw_out, N, D, V, c0, vc, ldl, s);
  return -1;
}
