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
// float32, padded vocab columns and rows past N kept out of every sum.
// dlogits are rounded to h's type before the backward's products, as the
// scan head does (tony_tpu_torch/ops/fused_ce.py _scan_bwd). No atomics:
// every output element is summed by one thread in a fixed order, so two
// launches are bit-equal.
//
// Layouts, all row-major and dense: h [N, D], W [D, V], tgt int32 [N], lse
// and g float32 [N]; dh like h, dW like W. D and V are multiples of 8 and
// every pointer is 16-byte aligned (the wrapper checks): operands load 16
// bytes at a time, and TMA needs 16-byte row strides.
//
// Why not the TPU's blocks. The TPU kernels keep [512, D] (dh) and [D, 512]
// (dW) float32 accumulators in VMEM across a sequential grid: 4 MB each at
// D 2048. An H100 CTA has at most 227 KB of shared memory, and its CTAs
// run in no order. So:
// - ce_fwd: each output tile's [rows, columns] float32 logits (a GEMM
//   main loop over D) fold into three per-row scalars (m, s, tl); nothing
//   else survives a tile. The vocab is split across CTAs (flash-decoding's
//   trick) and a second, small kernel merges each row's partials. Both
//   kernels are one launch of ce_fwd. bf16: every 128 x 256 tile of the
//   persistent wgmma body below writes its rows' partial to a float32
//   workspace [3][cdiv(V, 256)][N] (25 MB at bench_1b4's head), the row
//   reductions in registers and two shuffles (see the tc section). float32:
//   a CTA of 256 threads owns 128 rows and a split of the vocab's
//   128-column tiles, scalar FMA on slices of 16, 8 x 8 accumulators a
//   thread, the partials met in shared memory.
// - backward, per vocab chunk of Vc columns (the wrapper's loop): ce_dh
//   recomputes the chunk's logits once and writes dlogits in h's type to a
//   [N, Vc] scratch (kernel a), then accumulates dh_f32 += dlogits W_c^T
//   (kernel b; the last chunk writes dh in h's type). ce_dw then writes the
//   chunk's dW columns once, dW_c = h^T dlogits, from the same scratch. The
//   logits are recomputed once, where the TPU kernels recompute them in dh
//   and again in dW. A cluster-resident dh accumulator does not fit: 128
//   rows of float32 dh at D 2048 are 1 MB, a whole 8-CTA cluster's shared
//   memory, and dW would then need a sum across row blocks. Recomputing
//   dlogits inside the dh product instead would multiply the logits work
//   by D / 256.
//
// bf16 (the training path's) runs on wgmma with TMA staging (namespace
// tc, the persistent 128 x 256 tile body of sm90.cuh's pgemm, shared with
// grouped_mm.cu): the forward's one pass h W over the whole vocab, its
// tiles walked in column groups so that W and h stay in L2 (tile_origin),
// and three GEMMs a chunk for the backward: dlogits = h W_c
// with an epilogue of exp, onehot and g in registers and a TMA store of
// the bf16 tile; dh += dl W_c^T with 8-byte float32 read-add-writes of
// dh's sum (bf16 pairs on the last chunk); dW_c = h^T dl through wgmma's
// transposed A, a TMA store. The tail chunk's columns past Vc and the
// rows past N are masked by the tensor maps' extents (see the tc
// section). float32 keeps one scalar-FMA CTA per 128 x 128 output tile
// for all three. ce_route says which instance runs; no atomics anywhere,
// so two launches of any of them are bit-equal.
//
// NaN. fmaxf drops a NaN, so a running max built on it never holds one;
// a NaN logit still reaches its row's s through exp(NaN - m), and the final
// max(s, 1e-30) keeps a NaN s. A NaN weight therefore reaches every loss,
// dh and dW, as the TPU kernels let it; a NaN or inf row reaches its own
// loss and dh row and, through the sum over rows, every dW entry. The
// padded-column and padded-row masks are selects on indices or zero-filled
// loads and never touch a real value.
//
// What bounds it on this card: operations. One pass of h W at bench_1b4's
// shapes (N 16,384, D 2048, V 32,000) is 2.15e12 operations on 0.2 GB of
// bf16 operands, far above the H100's ~295 operations per byte, so the
// least time is the operations over the bf16 tensor-core peak (989
// TFLOP/s): 2.17 ms per pass, one pass in ce_fwd, two in ce_dh, one in
// ce_dw. The backward's scratch adds about 1 GB written and 2 GB read, and
// dh's float32 sum 2 GB of round trips, about 1.5 ms at 3.35 TB/s, partly
// under the products. The forward's W (131 MB) and h (67 MB) do not fit
// the L2 together; in column groups W is read about 16 times and h about
// 8 (2.6 GB, 0.8 ms), under its products. The float32 path is bounded by
// the CUDA cores' 67 TFLOP/s. Measured times are in PERF.md.

#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

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

// ------------------------------------------------ the tile as epilogues see it
// A thread's part of the CTA's 128 x 128 float32 tile: 8 row slots r and 8
// column slots c. row(r) and col(c) are offsets inside the tile. The
// threads that share a row reduce over their lanes with row_max/row_sum;
// writer() is the one lane of a row that stores its result.

// FMA layout: thread (ty, tx) = (tid / 16, tid % 16) holds rows 4 ty + i
// and 64 + 4 ty + i, columns likewise from tx; a row's 16 threads are one
// half-warp
struct TileF32 {
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
  __device__ static __forceinline__ bool writer() { return (threadIdx.x & 15) == 0; }
};

// tile = sum over k in [k_begin, k_end) of A(m0 + i, k) B(k, n0 + j); rows
// past m_end and columns past n_end read as zero. Every thread of the CTA
// calls it with the same arguments.
template <bool A_KC, bool B_KC>
__device__ __forceinline__ void product(TileF32& t, const float* a, long long lda, int m0,
                                        int m_end, const float* b, long long ldb, int n0,
                                        int n_end, int k_begin, int k_end) {
  gemm_tile(t.a, Operand<A_KC>{a, lda, m0, m_end}, Operand<B_KC>{b, ldb, n0, n_end}, k_begin,
            k_end);
}

// max(s, 1e-30) that keeps a NaN s, as jnp.maximum does
__device__ __forceinline__ float floor_keep_nan(float s) {
  return s != s ? s : fmaxf(s, 1e-30f);
}

// ---------------------------------------------------------------- kernels

// grid (splits, row blocks). CTA (split, i): rows [128 i, 128 i + 128),
// vocab tiles [split * tps, min(n_tiles, (split + 1) * tps)); writes the
// rows' partial (m, s, tl) over its tiles to part[{0, 1, 2}][split][row]
__global__ void __launch_bounds__(kThreads)
ce_fwd_kernel(const float* __restrict__ h, const float* __restrict__ w,
              const int* __restrict__ tgt, float* __restrict__ part, int N, int D, int V,
              int tps) {
  using Tile = TileF32;
  __shared__ float red_m[kTile], red_s[kTile];   // a tile's row max and sum
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
    product<true, false>(t, h, D, r0, N, w, V, c0, V, 0, D);
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
      for (int r = 0; r < 8; ++r) red_m[Tile::row(r)] = part_max[r];
    }
    __syncthreads();
    float part_sum[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = Tile::row(r);
      const float m_new = fmaxf(m_sm[row], red_m[row]);
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
      for (int r = 0; r < 8; ++r) red_s[Tile::row(r)] = part_sum[r];
    }
    __syncthreads();
    if (threadIdx.x < kTile) {
      const int row = threadIdx.x;
      const float m_old = m_sm[row], m_new = fmaxf(m_old, red_m[row]);
      s_sm[row] = s_sm[row] * expf(m_old - m_new) + red_s[row];
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

// one thread per row: merge the splits' (m, s, tl) into lse and tl; a
// split covers `cols` vocab columns (the scalar instance's kTile * tps, the
// tensor-core instance's 256), so the target's column names its split
__global__ void ce_fwd_merge_kernel(const float* __restrict__ part,
                                    const int* __restrict__ tgt, float* __restrict__ lse,
                                    float* __restrict__ tl, int N, int V, int splits,
                                    int cols) {
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
  tl[row] = t >= 0 && t < V ? part[2 * plane + (long long)(t / cols) * N + row] : 0.f;
}

// The float32 backward (bf16 runs the tc section's instances).
// backward (a): dl[row, v] = (exp(logit - lse) - onehot) g for the chunk's
// columns v in [0, vc) (global column c0 + v), in float32
__global__ void __launch_bounds__(kThreads)
ce_dlogits_kernel(const float* __restrict__ h, const float* __restrict__ w,
                  const int* __restrict__ tgt, const float* __restrict__ lse,
                  const float* __restrict__ g, float* __restrict__ dl, int N, int D, int V,
                  int c0, int vc, int ldl) {
  using Tile = TileF32;
  const int r0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  Tile t;
  product<true, false>(t, h, D, r0, N, w + c0, V, n0, vc, 0, D);
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
      dl[(long long)row * ldl + col] = ((p - (col == want ? 1.f : 0.f)) * gr);
    }
  }
}

// backward (b): dh[row, d] (+)= sum over the chunk's v of dl[row, v]
// W[d, c0 + v]; acc holds the float32 sum between chunks, the last chunk
// writes dh
__global__ void __launch_bounds__(kThreads)
ce_dh_kernel(const float* __restrict__ dl, const float* __restrict__ w, float* __restrict__ acc,
             float* __restrict__ dh, int N, int D, int V, int c0, int vc, int ldl, int first,
             int last) {
  using Tile = TileF32;
  const int r0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  Tile t;
  // A(m = row, k = v) = dl[row, v] (KC); B(k = v, n = d) = W[d, c0 + v] (KC):
  // W's rows read along their contiguous v, the transpose taken in place
  product<true, true>(t, dl, ldl, r0, N, w + c0, V, n0, D, 0, vc);
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
      if (last) dh[at] = (v);
      else acc[at] = v;
    }
  }
}

// dW[d, c0 + v] = sum over rows of h[row, d] dl[row, v], written once
__global__ void __launch_bounds__(kThreads)
ce_dw_kernel(const float* __restrict__ h, const float* __restrict__ dl, float* __restrict__ dw,
             int N, int D, int V, int c0, int vc, int ldl) {
  using Tile = TileF32;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  Tile t;
  // A(m = d, k = row) = h[row, d] (MC); B(k = row, n = v) = dl[row, v] (MC)
  product<false, false>(t, h, D, m0, D, dl, ldl, n0, vc, 0, N);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int d = m0 + Tile::row(r);
    if (d >= D) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = n0 + Tile::col(c);
      if (col < vc) dw[(long long)d * V + c0 + col] = (t.at(r, c));
    }
  }
}

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// ------------------------------ bf16: wgmma + TMA, one GEMM forward, three a chunk backward
// Each product is pgemm's persistent 128 x 256 tile GEMM (sm90.cuh, the
// body of grouped_mm.cu's kernels): out [M, Nc] = A [M, K] B [K, Nc].
// Every operand and output goes through a 2-D tensor map of [64][64]
// boxes, (inner, outer) coordinates:
//   h  (D, N)      row stride D
//   W  (V, D)      row stride V: the forward's whole vocab
//   W_c (vc, D)    row stride V, from column c0: the chunk's columns
//   dl (vc, N)     row stride ldl: the chunk's dlogits, width vc
//   dW_c (vc, D)   row stride V, from column c0
// A and B are read K-major (coordinates (k, mn)) or MN-major ((mn, k)).
// The maps are as wide and as tall as the tensor's real part, so TMA
// zero-fills every element a box reads past it and clips every store:
// - columns past vc (the tail chunk): W_c and dl read as 0, so the dh
//   product never sees the scratch's stale columns from the chunk before,
//   and dlogits' columns there (exp(0 - lse) g, not 0) are never stored;
// - rows past N: h and dl read as 0, so dW's contraction over rows adds
//   exact zeros there; dlogits and dh never store them;
// - the forward's columns past V read 0 as well, so its epilogue sets
//   them to kNeg by index before they touch m or s.
// Boxes wholly past the output's edge are not loaded; the outputs that
// read their stale stage are past the edge too and never stored.

namespace tc {

using namespace pgemm;

// Four stages: a stage's load is issued about 2.5 slices' products
// (about 1.4 µs at the peak rate) before the consumers need it, against
// about 1.5 with three, which left the loads' latency exposed (PERF.md).
// Beside them each warpgroup stages half its output tile (64 x 128 bf16)
// at a time for the TMA store: 1 KB to align to 1024, 192 KB of ring,
// 32 KB of staging
constexpr int kStages = 4;
constexpr int kYBytes = 2 * kBox;   // one warpgroup's 64 x 128 bf16
constexpr int kSmem = 1024 + kStages * (kABytes + kBBytes) + 2 * kYBytes;
// the forward stores no tile: the ring alone
constexpr int kFwdSmem = 1024 + kStages * (kABytes + kBBytes);

enum Epilogue { kDlogits, kDh, kDw, kFwd };

// what the epilogues read beside the tile: the rows' target, lse and g
// (dlogits), dh's float32 sum and its bf16 output (dh), the partials'
// workspace (fwd)
struct Rows {
  const int* tgt;
  const float* lse;
  const float* g;
  float* acc;
  __nv_bfloat16* dh;
  int c0, first, last;
  float* part;
};

// The persistent grid's tile order. The backward walks row blocks
// outermost: a 4096-column chunk of W (16.8 MB at D 2048) stays in the 50
// MB L2 while every row block passes it. The forward's W is the whole
// vocab (131 MB at bench_1b4's head), so it walks column groups of kGroup
// tiles outermost, then row blocks, then the group's tiles: the ~132 tiles
// in flight share about 8 row blocks of h (4 MB) and one group's 4096
// columns of W (17 MB), and W is read from HBM once per group pass, not
// once per row block. Returns the tile's first row and column.
constexpr int kGroup = 16;

template <int EPI>
__device__ __forceinline__ int2 tile_origin(int tile, int m_tiles, int n_cols) {
  if constexpr (EPI == kFwd) {
    const int g = tile / (kGroup * m_tiles), r = tile % (kGroup * m_tiles);
    const int width = min(kGroup, n_cols - g * kGroup);   // the last group's
    return make_int2(r / width * kRows, (g * kGroup + r % width) * kCols);
  } else {
    return make_int2(tile / n_cols * kRows, tile % n_cols * kCols);
  }
}

// v to p where pred holds, as one predicated 4-byte store
__device__ __forceinline__ void st_f32_if(bool pred, float* p, float v) {
  asm volatile("{\n.reg .pred q;\nsetp.ne.b32 q, %0, 0;\n@q st.global.f32 [%1], %2;\n}\n" ::"r"(
                   (int)pred),
               "l"(p), "f"(v)
               : "memory");
}

// (pred ? *p : 0) as one predicated 8-byte load
__device__ __forceinline__ float2 ld_pair_if(bool pred, const float* p) {
  float2 v;
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %2, 0;\nmov.f32 %0, 0f00000000;\n"
      "mov.f32 %1, 0f00000000;\n@q ld.global.v2.f32 {%0, %1}, [%3];\n}\n"
      : "=f"(v.x), "=f"(v.y)
      : "r"((int)pred), "l"(p)
      : "memory");
  return v;
}

// the bf16 pair v to p where pred holds, as one predicated 4-byte store
__device__ __forceinline__ void st_b32_if(bool pred, void* p, uint32_t v) {
  asm volatile("{\n.reg .pred q;\nsetp.ne.b32 q, %0, 0;\n@q st.global.b32 [%1], %2;\n}\n" ::"r"(
                   (int)pred),
               "l"(p), "r"(v)
               : "memory");
}

// out = A B, A read K-major (TA 0) or MN-major (1), B likewise (TB);
// epilogue EPI: kDlogits and kDw round the tile to bf16
// (dlogits after (exp(x - lse) - onehot) g) into a swizzled staging tile
// and TMA store it through omap; kDh adds it to dh's float32 sum; kFwd
// folds each row into its partial (m, s, tl) and stores nothing else.
template <int TA, int TB, int EPI>
__device__ __forceinline__ void tiles_body(const CUtensorMap& amap, const CUtensorMap& bmap,
                                           const CUtensorMap& omap, int M, int Nc, int K,
                                           const Rows& p) {
  extern __shared__ uint8_t smem[];
  __shared__ __align__(8) uint64_t bars[2 * kStages];
  const uint32_t sA = (saddr(smem) + 1023) & ~1023u, sB = sA + kStages * kABytes;
  const uint32_t sY = sB + kStages * kBBytes;
  const Ring<kStages> ring{saddr(bars), saddr(bars) + 8 * kStages};
  const int m_tiles = cdiv(M, kRows), n_cols = cdiv(Nc, kCols), nk = cdiv(K, kDepth);
  const int tiles = m_tiles * n_cols;

  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      int it = 0;                                  // slices loaded, over all tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int2 o = tile_origin<EPI>(tile, m_tiles, n_cols);
        const int m0 = o.x, n0 = o.y;
        // 64-wide boxes of A's rows and B's columns, those wholly past M or
        // Nc not loaded
        const int na = min(kRows / kHalf, cdiv(M - m0, kHalf));
        const int nb = min(kCols / kHalf, cdiv(Nc - n0, kHalf));
        for (int t = 0; t < nk; ++t, ++it) {
          const int s = it % kStages, k = t * kDepth;
          const uint32_t full = ring.acquire(it, (na + nb) * kBox);
          for (int q = 0; q < na; ++q) {
            const int m = m0 + q * kHalf;
            tma_load(sA + s * kABytes + q * kBox, amap, full, TA ? m : k, TA ? k : m);
          }
          for (int q = 0; q < nb; ++q) {
            const int n = n0 + q * kHalf;
            tma_load(sB + s * kBBytes + q * kBox, bmap, full, TB ? n : k, TB ? k : n);
          }
        }
      }
    }
    return;
  }

  const int cw = threadIdx.x / 128, tid = threadIdx.x % 128, lane = tid % 32, t4 = lane % 4;
  const uint32_t sYw = sY + cw * kYBytes;         // its staging tile
  const int rr = 16 * (tid / 32) + lane / 4;      // its rows rr and rr + 8 there
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int2 o = tile_origin<EPI>(tile, m_tiles, n_cols);
    const int m0 = o.x, n0 = o.y;
    // acc[j][4 i + c]: row m0 + 64 cw + rr (+ 8 for c >= 2), column n0 +
    // 128 j + 8 i + 2 t4 (+ 1 for odd c)
    const int row = m0 + 64 * cw + rr;
    float acc[kCols / 128][64];
#pragma unroll
    for (int j = 0; j < kCols / 128; ++j) zero(acc[j]);
    // its 64 rows of each A slice: box cw
    mainloop<kStages, TA, TB>(acc, ring, it, nk, sA + cw * kBox, sB);

    if constexpr (EPI == kFwd) {
      // each row's partial over the tile's 256 columns, to slot n0 / kCols
      // of part [3][n_cols][M]. A quad (t4 0..3) holds a row's 256
      // columns, 64 each, so the row max and sum take two shuffles, no
      // shared memory and no barrier. Columns past Nc (V) go to kNeg by
      // index before they touch m or s; fmaxf drops a NaN from the max and
      // exp(NaN - m) carries it into s. The thread whose column is the
      // target takes tl. The targets are loaded here and not before the
      // main loop (held across it they spill, see kDlogits); rows past M
      // read row M - 1's and are never stored.
      const int c_end = Nc - n0 - 2 * t4;          // its columns from here are padding
      int want[2];
      float mx[2] = {kNeg, kNeg}, sum[2] = {0.f, 0.f}, tl[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) want[h] = p.tgt[min(row + 8 * h, M - 1)] - n0 - 2 * t4;
#pragma unroll
      for (int j = 0; j < kCols / 128; ++j)
#pragma unroll
        for (int i = 0; i < 16; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float& x = acc[j][4 * i + c];
            x = 128 * j + 8 * i + (c & 1) < c_end ? x : kNeg;
            mx[c >> 1] = fmaxf(mx[c >> 1], x);
          }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      }
#pragma unroll
      for (int j = 0; j < kCols / 128; ++j)
#pragma unroll
        for (int i = 0; i < 16; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int h = c >> 1, col = 128 * j + 8 * i + (c & 1);
            const float x = acc[j][4 * i + c];
            sum[h] += expf(x - mx[h]);
            tl[h] = col == want[h] ? x : tl[h];
          }
      const long long plane = (long long)n_cols * M;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
        const int r = row + 8 * h, w = want[h];
        // its columns are 128 j + 8 i + {0, 1} past n0 + 2 t4
        const bool holds = w >= 0 && w < kCols && w < c_end && (w & 6) == 0;
        float* at = p.part + (long long)(n0 / kCols) * M + r;
        st_f32_if(r < M && t4 == 0, at, mx[h]);
        st_f32_if(r < M && t4 == 0, at + plane, sum[h]);
        st_f32_if(r < M && holds, at + 2 * plane, tl[h]);
      }
    } else if constexpr (EPI == kDh) {
      // dh = (first ? 0 : acc) + tile: float32 pairs back to acc, or on the
      // last chunk bf16 pairs to dh; every access predicated, none
      // branched. Nc (D) is a multiple of 8, so a pair is wholly inside or
      // past it. kBatch column groups' sums are loaded before any of them
      // is stored, so 2 kBatch reads are in flight at once (each pair is
      // read and written by its own thread alone)
      constexpr int kBatch = 4;
      const long long at = (long long)row * Nc + n0 + 2 * t4;
#pragma unroll
      for (int j = 0; j < kCols / 128; ++j)
#pragma unroll
        for (int i0 = 0; i0 < 16; i0 += kBatch) {
          float2 s[kBatch][2];
#pragma unroll
          for (int b = 0; b < kBatch; ++b)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int c = 128 * j + 8 * (i0 + b);
              const bool in = row + 8 * h < M && n0 + c < Nc;
              s[b][h] = ld_pair_if(in && !p.first, p.acc + at + 8LL * h * Nc + c);
            }
#pragma unroll
          for (int b = 0; b < kBatch; ++b)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int c = 128 * j + 8 * (i0 + b), e = 4 * (i0 + b) + 2 * h;
              const bool in = row + 8 * h < M && n0 + c < Nc;
              const long long o = at + 8LL * h * Nc + c;
              const float x = s[b][h].x + acc[j][e], y = s[b][h].y + acc[j][e + 1];
              st_pair_if(in && !p.last, p.acc + o, x, y);
              st_b32_if(in && p.last, p.dh + o, pack_bf16(x, y));
            }
        }
    } else {
      if constexpr (EPI == kDlogits) {
        // its rows' lse, g and target column (relative to its first
        // column), loaded here and not before the main loop: held across
        // it they make ptxas spill (168 registers a thread at 288 threads,
        // 3 warps on one SM sub-partition); rows past M read row M - 1's
        // (never stored)
        float l[2], g[2];
        int want[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = min(row + 8 * h, M - 1);
          l[h] = p.lse[r];
          g[h] = p.g[r];
          want[h] = p.tgt[r] - p.c0 - n0 - 2 * t4;
        }
#pragma unroll
        for (int j = 0; j < kCols / 128; ++j)
#pragma unroll
          for (int i = 0; i < 16; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int h = c >> 1, col = 128 * j + 8 * i + (c & 1);
              float& x = acc[j][4 * i + c];
              x = (expf(x - l[h]) - (col == want[h] ? 1.f : 0.f)) * g[h];
            }
      }
      // each 128-column half j in turn: columns 8 i + 2 t4 (+ 1) into box
      // i / 8, 16-byte chunk i % 8 of a row swizzled by the row (128B:
      // chunk ^ row % 8), then TMA stored; the map clips rows past M and
      // columns past Nc
#pragma unroll
      for (int j = 0; j < kCols / 128; ++j) {
        if (tid == 0) bulk_wait_read();           // the last stores read sYw
        named_sync(1 + cw, 128);
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const uint32_t at = sYw + (i / 8) * kBox + (((i % 8) ^ (rr % 8)) << 4) + 4 * t4;
          st_shared(at + rr * 128, pack_bf16(acc[j][4 * i], acc[j][4 * i + 1]));
          st_shared(at + (rr + 8) * 128, pack_bf16(acc[j][4 * i + 2], acc[j][4 * i + 3]));
        }
        fence_async_smem();
        named_sync(1 + cw, 128);
        if (tid == 0 && m0 + 64 * cw < M) {
          for (int q = 0; q < 2 && n0 + 128 * j + q * kHalf < Nc; ++q)
            tma_store(omap, sYw + q * kBox, n0 + 128 * j + q * kHalf, m0 + 64 * cw);
          bulk_commit();
        }
      }
    }
  }
  if ((EPI == kDlogits || EPI == kDw) && tid == 0) bulk_wait();   // the stores are done
}

// forward: each row's partial (m, s, tl) over each 256-column tile of the
// vocab, to part [3][cdiv(V, 256)][N]; ce_fwd_merge_kernel folds them.
// A = h (m = row, k = d) K-major; B = W (k = d, n = v) MN-major, the whole
// vocab (Nc = V)
__global__ void __launch_bounds__(kThreads, 1)
ce_fwd_kernel(const __grid_constant__ CUtensorMap hmap,
              const __grid_constant__ CUtensorMap wmap, const int* __restrict__ tgt,
              float* __restrict__ part, int N, int D, int V) {
  tiles_body<0, 1, kFwd>(hmap, wmap, hmap, N, V, D,
                         Rows{tgt, nullptr, nullptr, nullptr, nullptr, 0, 0, 0, part});
}

// backward (a): dl [N, vc] = (exp(h W_c - lse) - onehot) g in bf16.
// A = h (m = row, k = d) K-major; B = W_c (k = d, n = v) MN-major
__global__ void __launch_bounds__(kThreads, 1)
ce_dlogits_kernel(const __grid_constant__ CUtensorMap hmap,
                  const __grid_constant__ CUtensorMap wmap,
                  const __grid_constant__ CUtensorMap dlmap, const int* __restrict__ tgt,
                  const float* __restrict__ lse, const float* __restrict__ g, int N, int D,
                  int c0, int vc) {
  tiles_body<0, 1, kDlogits>(hmap, wmap, dlmap, N, vc, D,
                                      Rows{tgt, lse, g, nullptr, nullptr, c0, 0, 0});
}

// backward (b): acc (+)= dl W_c^T, or dh = bf16(acc + dl W_c^T) on the last
// chunk. A = dl (m = row, k = v) K-major; B = W_c (k = v, n = d) K-major:
// W's rows read along their contiguous v, the transpose taken in place
__global__ void __launch_bounds__(kThreads, 1)
ce_dh_kernel(const __grid_constant__ CUtensorMap dlmap,
             const __grid_constant__ CUtensorMap wmap, float* __restrict__ acc,
             __nv_bfloat16* __restrict__ dh, int N, int D, int vc, int first, int last) {
  tiles_body<0, 0, kDh>(dlmap, wmap, dlmap, N, D, vc,
                                   Rows{nullptr, nullptr, nullptr, acc, dh, 0, first, last});
}

// dW_c [D, vc] = h^T dl. A = h (m = d, k = row) MN-major (wgmma's
// transposed A); B = dl (k = row, n = v) MN-major. One CTA sums a tile
// over all N rows in a fixed order: no atomics, each column written once
__global__ void __launch_bounds__(kThreads, 1)
ce_dw_kernel(const __grid_constant__ CUtensorMap hmap,
             const __grid_constant__ CUtensorMap dlmap,
             const __grid_constant__ CUtensorMap dwmap, int N, int D, int vc) {
  tiles_body<1, 1, kDw>(hmap, dlmap, dwmap, D, vc, N, Rows{});
}

}  // namespace tc

// the float32 instances: one scalar-FMA CTA per 128 x 128 tile
int fwd(const void* h, const void* w, const void* tgt, void* part, void* lse, void* tl, int N,
        int D, int V, int splits, cudaStream_t stream) {
  const int tps = cdiv(cdiv(V, kTile), splits);
  ce_fwd_kernel<<<dim3(splits, cdiv(N, kTile)), kThreads, 0, stream>>>(
      static_cast<const float*>(h), static_cast<const float*>(w),
      static_cast<const int*>(tgt), static_cast<float*>(part), N, D, V, tps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ce_fwd_merge_kernel<<<cdiv(N, kThreads), kThreads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const int*>(tgt),
      static_cast<float*>(lse), static_cast<float*>(tl), N, V, splits, kTile * tps);
  return (int)cudaGetLastError();
}

int dh(const void* h, const void* w, const void* tgt, const void* lse, const void* g,
       void* dl, void* acc, void* dh_out, int N, int D, int V, int c0, int vc, int ldl,
       int first, int last, cudaStream_t stream) {
  ce_dlogits_kernel<<<dim3(cdiv(vc, kTile), cdiv(N, kTile)), kThreads, 0, stream>>>(
      static_cast<const float*>(h), static_cast<const float*>(w), static_cast<const int*>(tgt),
      static_cast<const float*>(lse), static_cast<const float*>(g), static_cast<float*>(dl),
      N, D, V, c0, vc, ldl);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ce_dh_kernel<<<dim3(cdiv(D, kTile), cdiv(N, kTile)), kThreads, 0, stream>>>(
      static_cast<const float*>(dl), static_cast<const float*>(w), static_cast<float*>(acc),
      static_cast<float*>(dh_out), N, D, V, c0, vc, ldl, first, last);
  return (int)cudaGetLastError();
}

int dw(const void* h, const void* dl, void* dw_out, int N, int D, int V, int c0, int vc,
       int ldl, cudaStream_t stream) {
  ce_dw_kernel<<<dim3(cdiv(vc, kTile), cdiv(D, kTile)), kThreads, 0, stream>>>(
      static_cast<const float*>(h), static_cast<const float*>(dl), static_cast<float*>(dw_out),
      N, D, V, c0, vc, ldl);
  return (int)cudaGetLastError();
}

// a bf16 [outer][inner] tensor with row stride ld as a map of [64][64]
// boxes (see the tc section): 0, kNoEncoder or kBadMap
int map2(CUtensorMap* map, const void* p, int inner, int outer, long long ld) {
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const long long strides[1] = {ld};
  const cuuint32_t box[2] = {(cuuint32_t)tc::kHalf, (cuuint32_t)tc::kHalf};
  return encode_map<2>(map, p, dims, strides, box);
}

// kernel on a persistent grid of at most one CTA per SM over `tiles` tiles
template <typename Kernel, typename... Args>
int launch_tc(Kernel kernel, int smem, int tiles, cudaStream_t stream, const Args&... args) {
  int sms = 0;
  const cudaError_t err = prepare(kernel, smem, &sms);
  if (err != cudaSuccess) return (int)err;
  kernel<<<tiles < sms ? tiles : sms, tc::kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// the workspace's splits must be the vocab's 256-column tiles
constexpr int kBadSplits = -4;

int fwd_tc(const void* h, const void* w, const void* tgt, void* part, void* lse, void* tl,
           int N, int D, int V, int splits, cudaStream_t stream) {
  const int n_cols = cdiv(V, tc::kCols);
  if (splits != n_cols) return kBadSplits;
  CUtensorMap hm, wm;
  int e = map2(&hm, h, D, N, D);
  if (!e) e = map2(&wm, w, V, D, V);
  if (!e)
    e = launch_tc(tc::ce_fwd_kernel, tc::kFwdSmem, cdiv(N, tc::kRows) * n_cols, stream, hm, wm,
                  static_cast<const int*>(tgt), static_cast<float*>(part), N, D, V);
  if (e) return e;
  ce_fwd_merge_kernel<<<cdiv(N, kThreads), kThreads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const int*>(tgt), static_cast<float*>(lse),
      static_cast<float*>(tl), N, V, n_cols, tc::kCols);
  return (int)cudaGetLastError();
}

int dh_tc(const void* h, const void* w, const void* tgt, const void* lse, const void* g,
          void* dl, void* acc, void* dh_out, int N, int D, int V, int c0, int vc, int ldl,
          int first, int last, cudaStream_t stream) {
  CUtensorMap hm, wm, dlm;
  int e = map2(&hm, h, D, N, D);
  if (!e) e = map2(&wm, static_cast<const __nv_bfloat16*>(w) + c0, vc, D, V);
  if (!e) e = map2(&dlm, dl, vc, N, ldl);
  if (!e)
    e = launch_tc(tc::ce_dlogits_kernel, tc::kSmem, cdiv(N, tc::kRows) * cdiv(vc, tc::kCols),
                  stream, hm, wm, dlm, static_cast<const int*>(tgt),
                  static_cast<const float*>(lse), static_cast<const float*>(g), N, D, c0, vc);
  if (!e)
    e = launch_tc(tc::ce_dh_kernel, tc::kSmem, cdiv(N, tc::kRows) * cdiv(D, tc::kCols),
                  stream, dlm, wm, static_cast<float*>(acc),
                  static_cast<__nv_bfloat16*>(dh_out), N, D, vc, first, last);
  return e;
}

int dw_tc(const void* h, const void* dl, void* dw_out, int N, int D, int V, int c0, int vc,
          int ldl, cudaStream_t stream) {
  CUtensorMap hm, dlm, dwm;
  int e = map2(&hm, h, D, N, D);
  if (!e) e = map2(&dlm, dl, vc, N, ldl);
  if (!e) e = map2(&dwm, static_cast<__nv_bfloat16*>(dw_out) + c0, vc, D, V);
  if (!e)
    e = launch_tc(tc::ce_dw_kernel, tc::kSmem, cdiv(D, tc::kRows) * cdiv(vc, tc::kCols),
                  stream, hm, dlm, dwm, N, D, vc);
  return e;
}

}  // namespace

// Plain C entry points (bound with ctypes). dtype: 0 = float32, 1 =
// bfloat16 (h, W, dl, dh and dW share it; tgt is int32, lse, g, tl and the
// partials float32). D and V must be multiples of 8, ldl too, and every
// pointer 16-byte aligned (the wrapper checks; TMA needs the same of the
// tensor-core instances' maps). Each returns the cudaError_t of its
// launches (0 = launched), -1 for a dtype it has no instance for, -2 when
// libcuda has no cuTensorMapEncodeTiled, -3 when it refuses a tensor map,
// -4 when ce_fwd's splits do not match its instance's workspace.

// Which instance a kernel (0 ce_fwd, 1 ce_dh, 2 ce_dw) runs for dtype: 2
// the tensor-core instances (wgmma + TMA: bf16), 0 scalar FMA (float32),
// -1 none. The entry points dispatch by it.
extern "C" int ce_route(int kernel, int dtype) {
  if (kernel < 0 || kernel > 2 || (dtype != 0 && dtype != 1)) return -1;
  return dtype == 0 ? 0 : 2;
}

// lse, tl [N]; part: float32 scratch of 3 * splits * N, where splits is
// cdiv(V, 256) on the tensor-core instance (one per 256-column tile) and
// the scalar instance's choice otherwise
extern "C" int ce_fwd(const void* h, const void* w, const void* tgt, void* part, void* lse,
                      void* tl, int N, int D, int V, int splits, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ce_route(0, dtype)) {
    case 2: return fwd_tc(h, w, tgt, part, lse, tl, N, D, V, splits, s);
    case 0: return fwd(h, w, tgt, part, lse, tl, N, D, V, splits, s);
  }
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
  switch (ce_route(1, dtype)) {
    case 2:
      return dh_tc(h, w, tgt, lse, g, dl, acc, dh_out, N, D, V, c0, vc, ldl, first, last, s);
    case 0:
      return dh(h, w, tgt, lse, g, dl, acc, dh_out, N, D, V, c0, vc, ldl, first, last, s);
  }
  return -1;
}

// dW[:, c0:c0 + vc] = h^T dl from the chunk's dlogits that ce_dh wrote
extern "C" int ce_dw(const void* h, const void* dl, void* dw_out, int N, int D, int V,
                     int c0, int vc, int ldl, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ce_route(2, dtype)) {
    case 2: return dw_tc(h, dl, dw_out, N, D, V, c0, vc, ldl, s);
    case 0: return dw(h, dl, dw_out, N, D, V, c0, vc, ldl, s);
  }
  return -1;
}
