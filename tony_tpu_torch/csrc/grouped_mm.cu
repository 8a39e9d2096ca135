// Grouped (ragged) matmul for Hopper (sm_90a): the MoE expert FFN's
// forward, dx and dW over a block-aligned, expert-sorted row buffer.
//
// Replaces the three TPU kernels of tony_tpu/ops/grouped_mm.py:
//   gmm_fwd <- _gmm_kernel    (:107)  y tile i = x tile i @ w[tile_group[i]]
//   gmm_dx  <- _gmm_dx_kernel (:141)  dx tile i = dy tile i @ w[tile_group[i]]^T
//   gmm_dw  <- _gmm_dw_kernel (:189)  dW[g] = sum over g's row tiles of
//                                             x tile^T @ dy tile
// and computes what they compute: products of the input type, summed in
// float32; y and dx are rounded once to the input type, dW is written in
// float32 (the caller casts it to the weight's type, as _gmm_pallas_bwd
// :252 does).
//
// Layouts, all row-major and dense: x [N, D] and dy [N, F] with N =
// n_tiles * br rows (row tile i is rows [i * br, (i + 1) * br)), w [G, D, F],
// tile_group [n_tiles] int32, non-decreasing (grouped_layout's map). dx
// reads w[g] [D, F] as its transpose in place: no transposed copy of the
// expert weights is made, as the TPU kernel contracts w's last dim in place.
//
// Shape of the work. bf16 at row tiles of a multiple of 128 rows, the
// training path's, all three run on wgmma with TMA staging (the tc section
// below); every other instance is one tiled GEMM loop: a CTA of 256
// threads owns a 128 x 128 output tile with float32 accumulators in
// registers and walks the contraction in staged slices, two slice buffers
// deep: the global loads of slice s + 1 are in flight while slice s is
// multiplied, and one barrier per slice suffices. gmm_route says which
// instance runs.
// - bf16 runs on the tensor cores: mma.sync m16n8k16 (bf16 in, float32
//   accumulate) on slices of 32 staged as bf16, fragments loaded with
//   ldmatrix; the 8 warps split the tile 2 x 4, 64 x 32 each.
// - float32 runs scalar FMA: slices of 16 staged as float32, [16][128] with
//   the output dim contiguous, 8 x 8 accumulators a thread (rows 4 * ty + i
//   and 64 + 4 * ty + i, columns likewise from tx; ty, tx in 0..15).
// A thread fetches 16 bytes at a time per operand (8 bf16 or 4 + 4 float32),
// so widths must be multiples of 8; the ragged edge of a width that is not
// a multiple of 128 is masked at that granularity.
// - gmm_fwd: one CTA per (row slice, F column tile). A row tile of br rows
//   is cut into ceil(br / 128) slices, so no CTA spans two groups. The CTA
//   reads tile_group[i] itself: there is no scalar prefetch to bring it.
// - gmm_dx: one CTA per (row slice, D column tile), looping over F.
// - gmm_dw: on the TPU the dW block stays resident across the consecutive
//   grid steps of one group. Hopper's CTAs run in no order, so one CTA owns
//   one (group, D tile, F tile) block of dW and loops over all of that
//   group's rows itself: no atomics and no second pass. The caller passes
//   each group's first tile and its end (searches of tile_group on the
//   device). A zero-load expert owns one all-zero tile, so its dW is 0;
//   trailing tiles clamped to G - 1 hold zero rows and add nothing.
//
// What bounds it on this card: operations. At bench_moe's shapes (33,792
// buffer rows, D 1024, F 2816) a launch is about 1.9e11 operations on
// about 0.3 GB of bf16 operands: 640 operations per byte, above the H100's
// ~295 ridge, so the least time is the operations over the bf16
// tensor-core peak (989 TFLOP/s). Tiles re-read the operands from L2: at
// 128 x 128 about 3 GB a launch, at the tensor-core instances' 128 x 256
// about 2.3-2.6 GB. mma.sync without TMA, warp specialisation or wgmma
// reaches only part of the peak; the float32 path is bounded by the CUDA
// cores' 67 TFLOP/s.
// Measured times are in PERF.md.

#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;   // output rows and columns per CTA
constexpr int kSlice = 16;   // contraction depth per staged slice

__device__ __forceinline__ void load8(float (&v)[8], const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(float (&v)[8], const __nv_bfloat16* p) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// One operand of C[m, n] = sum_k A(m, k) B(k, n), seen along its output dim
// ("mn": m for A, n for B). KC: element (mn, k) at p[mn * ld + k], the
// contraction contiguous; otherwise at p[k * ld + mn]. Rows mn >= mn_end and
// depths k >= k_end read as zero.
template <typename T, bool KC>
struct Operand {
  const T* p;
  long long ld;
  int mn0, mn_end;

  // this thread's 8 consecutive elements of the slice at depth k0: along k
  // for KC (mn = tid / 2, k = k0 + 8 * (tid % 2)), along mn otherwise
  // (k = k0 + tid / 16, mn = mn0 + 8 * (tid % 16))
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

// one slice: acc[i][j] += sum_k sa[k][row i] * sb[k][col j]
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

// acc = sum over k in [k_begin, k_end) of A(m, k) B(k, n) for this CTA's
// 128 x 128 tile. Every thread of the CTA must call it with the same range.
template <typename T, bool A_KC, bool B_KC>
__device__ __forceinline__ void gemm_tile(float (&acc)[8][8], const Operand<T, A_KC>& A,
                                          const Operand<T, B_KC>& B, int k_begin,
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
    if (more) {                       // buf ^ 1 was last read before the
      A.put(sa[buf ^ 1], va);         // previous barrier
      B.put(sb[buf ^ 1], vb);
    }
    __syncthreads();
    buf ^= 1;
  }
}

// write this thread's part of the tile at out[m * ldo + n], rows < m_end,
// columns < n_end
template <typename OutT>
__device__ __forceinline__ void store_tile(const float (&acc)[8][8], OutT* out,
                                           long long ldo, int m0, int m_end, int n0,
                                           int n_end) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= m_end) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n < n_end) out[(long long)m * ldo + n] = from_f<OutT>(acc[i][j]);
    }
  }
}

// ------------------------------------------------ bf16: tensor-core tiles
// The same 128 x 128 CTA tile and slice loop on mma.sync m16n8k16 (bf16
// in, float32 accumulate). Slices of 32 are staged as bf16: a KC operand
// as [mn][k] rows of 40 (80 bytes), an MC one as [k][mn] rows of 136 (272
// bytes); both pads keep the 8 rows an ldmatrix reads on distinct banks.
// ldmatrix loads the fragments, .trans for the MC layout. The 8 warps
// split the tile 2 x 4: each warp owns 64 x 32 of it, 4 x 4 mma tiles of
// 16 x 8, 64 float32 accumulators a thread.

constexpr int kHSlice = 32;            // contraction depth per staged slice
constexpr int kLdK = kHSlice + 8;      // [mn][k] row, elements
constexpr int kLdMN = kTile + 8;       // [k][mn] row, elements
constexpr int kHBuf = kTile * kLdK;    // one operand's slice buffer (>= kHSlice * kLdMN)

template <bool KC>
struct OperandH {
  const __nv_bfloat16* p;
  long long ld;
  int mn0, mn_end;

  // this thread's two 16-byte chunks of the 128 x 32 slice at depth k0:
  // chunk e = tid + 256 c is (mn = e / 4, k = 8 (e % 4)) for KC, (k = e / 16,
  // mn = 8 (e % 16)) otherwise
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

// d += a (16 x 16, row) b (16 x 8, col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// one staged slice into this warp's 64 x 32 of the tile. A fragment (m16 x
// k16): registers (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15), (m 8-15,
// k 8-15); B (two n8 tiles x k16): (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15,
// k 0-7), (n 8-15, k 8-15). Lane l addresses row l % 8 of matrix l / 8.
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

// accumulator (mt, nt, c) of lane l: row 16 mt + l / 4 (+ 8 for c >= 2),
// column 8 nt + 2 (l % 4) (+ 1 for odd c), inside the warp's 64 x 32
template <typename OutT>
__device__ __forceinline__ void store_tile_tc(const float (&acc)[4][4][4], OutT* out,
                                              long long ldo, int m0, int m_end, int n0,
                                              int n_end) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rm = m0 + (warp >> 2) * 64 + (lane >> 2);
  const int cn = n0 + (warp & 3) * 32 + 2 * (lane & 3);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int m = rm + mt * 16 + (c >> 1) * 8, n = cn + nt * 8 + (c & 1);
        if (m < m_end && n < n_end) out[(long long)m * ldo + n] = from_f<OutT>(acc[mt][nt][c]);
      }
}

// C[m0.., n0..] = sum over k in [k_begin, k_end) of A(m, k) B(k, n), written
// to out[m * ldo + n]: tensor-core tiles for bf16, scalar FMA for float32
template <typename T, bool A_KC, bool B_KC, typename OutT>
__device__ __forceinline__ void gemm(const T* a, long long lda, int m0, int m_end,
                                     const T* b, long long ldb, int n0, int n_end,
                                     int k_begin, int k_end, OutT* out, long long ldo) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    float acc[4][4][4];
    gemm_tile_tc(acc, OperandH<A_KC>{a, lda, m0, m_end}, OperandH<B_KC>{b, ldb, n0, n_end},
                 k_begin, k_end);
    store_tile_tc(acc, out, ldo, m0, m_end, n0, n_end);
  } else {
    float acc[8][8];
    gemm_tile(acc, Operand<T, A_KC>{a, lda, m0, m_end}, Operand<T, B_KC>{b, ldb, n0, n_end},
              k_begin, k_end);
    store_tile(acc, out, ldo, m0, m_end, n0, n_end);
  }
}

// rows of the CTA's slice of a row tile (gridDim.y = n_tiles * n_sub)
struct RowSlice {
  int tile, r0, r_end;
};

__device__ __forceinline__ RowSlice row_slice(int br, int n_sub) {
  const int tile = blockIdx.y / n_sub, sub = blockIdx.y % n_sub;
  const int r0 = tile * br + sub * kTile;
  return {tile, r0, min(r0 + kTile, (tile + 1) * br)};
}

// ------------------- bf16 at row tiles of a multiple of 128: wgmma + TMA
// The instances gmm_route sends bf16 to at row tiles of a multiple of 128
// rows (the training path's). Each is a persistent grid, one CTA of 288
// threads per SM, walking 128 x 256 output tiles, columns fastest
// (consecutive tiles share operands in L2). Warpgroups 0 and 1 own 64
// output rows each; warp 8 produces: one thread keeps a ring of TMA loads
// in flight across tiles, each stage a 64-deep slice of both operands in
// 128-byte swizzle (16 KB of A, 32 KB of B). Per slice each consumer
// issues 4 x 2 wgmma m64n128k16 (A and B from shared memory), keeps one
// slice's products in flight and releases the stage before it. TMA
// zero-fills what a box reads past the tensor, and boxes wholly past the
// output's edge are not loaded (their columns are never stored).
// - gmm_fwd and gmm_dx share one body (rows_tile): out tile = a's 128 rows
//   times w[g], g read from tile_group, a [N, K] K-major through a 2-D map
//   over (K, N) (x, K = D, for the forward; dy, K = F, for dx), w [G, D, F]
//   through one 3-D map over (F, D, G). The forward reads B(k = d, n = f)
//   MN-major, four 64-column halves of [64 d][64 f]; dx reads B(k = f,
//   n = d) K-major, w's rows along their contiguous f, two boxes of [128
//   d][64 f]: the transpose is taken in place, as the TPU kernel contracts
//   w's last dim, and rows past D read as zeros, so no load reads another
//   group's rows. The epilogue rounds to bf16 into a swizzled staging tile
//   in shared memory (one per warpgroup) and TMA stores it (the output's
//   map clips columns past its width): the stores run while the warpgroup
//   starts the next tile, and the producer has its first slices loaded by
//   then. A 64-row tile would put two groups in one CTA, whose two
//   warpgroups share the w slice, so other row tiles keep mma.sync.
// - gmm_dw walks the (g, 128 rows of d, 256 columns of f) tiles of dW and
//   contracts each over its group's rows, [bounds[g] br, bounds[G + g] br),
//   in 64-row slices, which never cross a group at these row tiles. Both
//   operands are MN-major: A(m = d, k = row) = x[row, d] (wgmma's
//   transposed A, one [64 rows][64 d] box per warpgroup) and B(k = row,
//   n = f) = dy[row, f], as the forward reads w. A float32 128 x 256 tile
//   (128 KB) has no room beside the ring, so the ring has 4 stages and the
//   epilogue stores each thread's column pairs straight from the
//   accumulators, 8 bytes a lane and a full 32-byte sector per 4 lanes.
//   No atomics and no split over the rows: one CTA sums a dW tile in a
//   fixed order, so dW is deterministic, as the TPU kernel's resident
//   accumulator is.

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

namespace tc {

using namespace pgemm;            // the tile, the ring and the main loop (sm90.cuh)

constexpr int kStages = 3;        // rows_tile: the ring, beside two staging tiles
constexpr int kYBytes = kCols / kHalf * kBox;  // one warpgroup's 64 x 256 bf16
// 1 KB to align to 1024
constexpr int kSmem = 1024 + kStages * (kABytes + kBBytes) + 2 * kYBytes;
constexpr int kDwStages = 4;
constexpr int kDwSmem = 1024 + kDwStages * (kABytes + kBBytes);
// gmm_dw's entry point carries no row count: x's and dy's maps extend over
// this many rows, and the kernel reads only the rows the caller's bounds
// give each group, which lie inside the buffer (the mma.sync instance
// reads by them too)
constexpr cuuint64_t kMapRows = 0x7fffffff;

// gmm_fwd (BK false: a = x, K = D, M = F) and gmm_dx (BK true: a = dy,
// K = F, M = D): out [N, M] = each 128-row tile of a [N, K] times w[g],
// B read MN-major (w[g] [D, F] as it lies) or K-major (its transpose)
template <bool BK>
__device__ __forceinline__ void rows_tile(const CUtensorMap& amap, const CUtensorMap& wmap,
                                          const CUtensorMap& omap,
                                          const int* __restrict__ tile_group, int br,
                                          int n_rows, int G, int K, int M) {
  extern __shared__ uint8_t smem[];
  __shared__ __align__(8) uint64_t bars[2 * kStages];
  const uint32_t sA = (saddr(smem) + 1023) & ~1023u, sB = sA + kStages * kABytes;
  const uint32_t sY = sB + kStages * kBBytes;
  const Ring<kStages> ring{saddr(bars), saddr(bars) + 8 * kStages};
  const int n_cols = cdiv(M, kCols), tiles = n_rows / kRows * n_cols, nk = cdiv(K, kDepth);

  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      int it = 0;                                  // slices loaded, over all tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int r0 = tile / n_cols * kRows, n0 = tile % n_cols * kCols;
        // in range for grouped_layout's maps; clamped so no load reads outside w
        const int g = min(max(tile_group[r0 / br], 0), G - 1);
        // w's boxes: [128 d][64 f] (dx) or [64 d][64 f] (forward), those
        // wholly past M not loaded
        const int box = BK ? 2 * kBox : kBox, span = BK ? 128 : kHalf;
        const int nb = min(kBBytes / box, cdiv(M - n0, span));
        for (int t = 0; t < nk; ++t, ++it) {
          const int s = it % kStages;
          const uint32_t full = ring.acquire(it, kABytes + nb * box);
          tma_load(sA + s * kABytes, amap, full, t * kDepth, r0);
          for (int q = 0; q < nb; ++q) {
            const uint32_t dst = sB + s * kBBytes + q * box;
            if (BK) tma_load(dst, wmap, full, t * kDepth, n0 + q * span, g);
            else tma_load(dst, wmap, full, n0 + q * span, t * kDepth, g);
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
    const int r0 = tile / n_cols * kRows, n0 = tile % n_cols * kCols;
    float acc[kCols / 128][64];
#pragma unroll
    for (int j = 0; j < kCols / 128; ++j) zero(acc[j]);
    // its 64 rows of each A slice
    mainloop<kStages, 0, BK ? 0 : 1>(acc, ring, it, nk, sA + cw * kBox, sB);

    // columns 8 i + 2 t4 (+ 1) of each 128-column half into box 2 j + i / 8,
    // 16-byte chunk i % 8 of a row swizzled by the row (128B: chunk ^ row % 8)
    if (tid == 0) bulk_wait_read();               // the last tile's stores read sYw
    named_sync(1 + cw, 128);
#pragma unroll
    for (int j = 0; j < kCols / 128; ++j)
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const uint32_t at = sYw + (2 * j + i / 8) * kBox + (((i % 8) ^ (rr % 8)) << 4) + 4 * t4;
        st_shared(at + rr * 128, pack_bf16(acc[j][4 * i], acc[j][4 * i + 1]));
        st_shared(at + (rr + 8) * 128, pack_bf16(acc[j][4 * i + 2], acc[j][4 * i + 3]));
      }
    fence_async_smem();
    named_sync(1 + cw, 128);
    if (tid == 0) {
      for (int q = 0; q < kCols / kHalf && n0 + q * kHalf < M; ++q)
        tma_store(omap, sYw + q * kBox, n0 + q * kHalf, r0 + 64 * cw);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait();                      // the stores are done before exit
}

__global__ void __launch_bounds__(kThreads, 1)
gmm_fwd_kernel(const __grid_constant__ CUtensorMap xmap,
               const __grid_constant__ CUtensorMap wmap,
               const __grid_constant__ CUtensorMap ymap, const int* __restrict__ tile_group,
               int br, int n_rows, int G, int D, int F) {
  rows_tile<false>(xmap, wmap, ymap, tile_group, br, n_rows, G, D, F);
}

__global__ void __launch_bounds__(kThreads, 1)
gmm_dx_kernel(const __grid_constant__ CUtensorMap dymap,
              const __grid_constant__ CUtensorMap wmap,
              const __grid_constant__ CUtensorMap dxmap, const int* __restrict__ tile_group,
              int br, int n_rows, int G, int D, int F) {
  rows_tile<true>(dymap, wmap, dxmap, tile_group, br, n_rows, G, F, D);
}

__global__ void __launch_bounds__(kThreads, 1)
gmm_dw_kernel(const __grid_constant__ CUtensorMap xmap,
              const __grid_constant__ CUtensorMap dymap, const int* __restrict__ bounds,
              float* __restrict__ dw, int br, int G, int D, int F) {
  extern __shared__ uint8_t smem[];
  __shared__ __align__(8) uint64_t bars[2 * kDwStages];
  const uint32_t sA = (saddr(smem) + 1023) & ~1023u, sB = sA + kDwStages * kABytes;
  const Ring<kDwStages> ring{saddr(bars), saddr(bars) + 8 * kDwStages};
  const int n_cols = cdiv(F, kCols), per_group = cdiv(D, kRows) * n_cols;
  const int tiles = G * per_group, per_slice = br / kDepth;

  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int g = tile / per_group, m0 = tile % per_group / n_cols * kRows;
        const int n0 = tile % n_cols * kCols;
        const int k0 = bounds[g] * br, nk = (bounds[G + g] - bounds[g]) * per_slice;
        // 64-wide boxes of x's d and dy's f, those wholly past D or F not loaded
        const int na = min(kRows / kHalf, cdiv(D - m0, kHalf));
        const int nb = min(kCols / kHalf, cdiv(F - n0, kHalf));
        for (int t = 0; t < nk; ++t, ++it) {
          const int s = it % kDwStages, row = k0 + t * kDepth;
          const uint32_t full = ring.acquire(it, (na + nb) * kBox);
          for (int q = 0; q < na; ++q)
            tma_load(sA + s * kABytes + q * kBox, xmap, full, m0 + q * kHalf, row);
          for (int q = 0; q < nb; ++q)
            tma_load(sB + s * kBBytes + q * kBox, dymap, full, n0 + q * kHalf, row);
        }
      }
    }
    return;
  }

  const int cw = threadIdx.x / 128, tid = threadIdx.x % 128, lane = tid % 32, t4 = lane % 4;
  const int rr = 16 * (tid / 32) + lane / 4;
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int g = tile / per_group, m0 = tile % per_group / n_cols * kRows;
    const int n0 = tile % n_cols * kCols;
    const int nk = (bounds[G + g] - bounds[g]) * per_slice;
    float acc[kCols / 128][64];
#pragma unroll
    for (int j = 0; j < kCols / 128; ++j) zero(acc[j]);
    // its 64 d of each x slice, the [64 rows][64 d] box cw
    mainloop<kDwStages, 1, 1>(acc, ring, it, nk, sA + cw * kBox, sB);

    // acc[j][4 i + c]: row rr (+ 8 for c >= 2), columns 128 j + 8 i + 2 t4
    // (+ 1) of this warpgroup's 64 rows; F is a multiple of 8, so a pair is
    // wholly inside or past it
    const int d = m0 + 64 * cw + rr;
    float* out = dw + ((long long)g * D + d) * F + n0 + 2 * t4;
#pragma unroll
    for (int j = 0; j < kCols / 128; ++j)
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int c = 128 * j + 8 * i;
        st_pair_if(d < D && n0 + c < F, out + c, acc[j][4 * i], acc[j][4 * i + 1]);
        st_pair_if(d + 8 < D && n0 + c < F, out + 8LL * F + c, acc[j][4 * i + 2],
                   acc[j][4 * i + 3]);
      }
  }
}

}  // namespace tc

// ---------------------------------------------------------------- kernels

template <typename T>
__global__ void __launch_bounds__(kThreads)
gmm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const int* __restrict__ tile_group, T* __restrict__ y, int br,
               int n_sub, int G, int D, int F) {
  const RowSlice rs = row_slice(br, n_sub);
  // in range for grouped_layout's maps; clamped so no map reads outside w
  const int g = min(max(tile_group[rs.tile], 0), G - 1);
  const int n0 = blockIdx.x * kTile;
  // A(m = row, k = d) = x[row, d] (KC); B(k = d, n = f) = w[g, d, f] (MC)
  gemm<T, true, false>(x, D, rs.r0, rs.r_end, w + (long long)g * D * F, F, n0, F, 0, D,
                       y, F);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gmm_dx_kernel(const T* __restrict__ dy, const T* __restrict__ w,
              const int* __restrict__ tile_group, T* __restrict__ dx, int br,
              int n_sub, int G, int D, int F) {
  const RowSlice rs = row_slice(br, n_sub);
  const int g = min(max(tile_group[rs.tile], 0), G - 1);
  const int n0 = blockIdx.x * kTile;
  // A(m = row, k = f) = dy[row, f] (KC); B(k = f, n = d) = w[g, d, f] (KC):
  // w's rows read along their contiguous f, the transpose taken in place
  gemm<T, true, true>(dy, F, rs.r0, rs.r_end, w + (long long)g * D * F, F, n0, D, 0, F,
                      dx, D);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gmm_dw_kernel(const T* __restrict__ x, const T* __restrict__ dy,
              const int* __restrict__ bounds, float* __restrict__ dw, int br, int G,
              int D, int F) {
  const int g = blockIdx.z;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  // the group's rows: tiles [bounds[g], bounds[G + g]), contiguous
  const int k_begin = bounds[g] * br, k_end = bounds[G + g] * br;
  // A(m = d, k = row) = x[row, d] (MC); B(k = row, n = f) = dy[row, f] (MC)
  gemm<T, false, false>(x, D, m0, D, dy, F, n0, F, k_begin, k_end,
                        dw + (long long)g * D * F, F);
}

// bf16 a [N, K], w [G, D, F] and out [N, M] as tensor maps (TMA boxes of 64
// columns: a [128 rows][64], w [64 d][64 f] for the forward or [128 d][64 f]
// for dx, of one group, out [64 rows][64]), out by the tensor-core forward
// (BK false: a = x, K = D, M = F) or dx (BK true: a = dy, K = F, M = D) on
// a persistent grid of at most one CTA per SM
template <bool BK>
int rows_tc(const void* a, const void* w, const void* tg, void* out, int n_tiles, int br,
            int G, int D, int F, cudaStream_t stream) {
  const int N = n_tiles * br, K = BK ? F : D, M = BK ? D : F;
  const cuuint64_t adims[2] = {(cuuint64_t)K, (cuuint64_t)N};
  const long long astrides[1] = {K};
  const cuuint32_t abox[2] = {(cuuint32_t)tc::kHalf, (cuuint32_t)tc::kRows};
  const cuuint64_t wdims[3] = {(cuuint64_t)F, (cuuint64_t)D, (cuuint64_t)G};
  const long long wstrides[2] = {F, (long long)D * F};
  const cuuint32_t wbox[3] = {(cuuint32_t)tc::kHalf, BK ? 128u : (cuuint32_t)tc::kDepth, 1};
  const cuuint64_t odims[2] = {(cuuint64_t)M, (cuuint64_t)N};
  const long long ostrides[1] = {M};
  const cuuint32_t obox[2] = {(cuuint32_t)tc::kHalf, 64};
  CUtensorMap am, wm, om;
  int e = encode_map<2>(&am, a, adims, astrides, abox);
  if (!e) e = encode_map<3>(&wm, w, wdims, wstrides, wbox);
  if (!e) e = encode_map<2>(&om, out, odims, ostrides, obox);
  if (e) return e;
  const auto kernel = BK ? tc::gmm_dx_kernel : tc::gmm_fwd_kernel;
  int sms = 0;
  const cudaError_t err = prepare(kernel, tc::kSmem, &sms);
  if (err != cudaSuccess) return (int)err;
  const int tiles = N / tc::kRows * cdiv(M, tc::kCols);
  kernel<<<tiles < sms ? tiles : sms, tc::kThreads, tc::kSmem, stream>>>(
      am, wm, om, static_cast<const int*>(tg), br, N, G, D, F);
  return (int)cudaGetLastError();
}

// bf16 x [rows, D] and dy [rows, F] as tensor maps (boxes of [64 rows][64]),
// dW [G, D, F] float32 by the tensor-core dW on a persistent grid of at
// most one CTA per SM
int dw_tc(const void* x, const void* dy, const void* bounds, void* dw_out, int br, int G,
          int D, int F, cudaStream_t stream) {
  const cuuint64_t xdims[2] = {(cuuint64_t)D, tc::kMapRows};
  const long long xstrides[1] = {D};
  const cuuint64_t dydims[2] = {(cuuint64_t)F, tc::kMapRows};
  const long long dystrides[1] = {F};
  const cuuint32_t box[2] = {(cuuint32_t)tc::kHalf, (cuuint32_t)tc::kDepth};
  CUtensorMap xm, dym;
  int e = encode_map<2>(&xm, x, xdims, xstrides, box);
  if (!e) e = encode_map<2>(&dym, dy, dydims, dystrides, box);
  if (e) return e;
  int sms = 0;
  const cudaError_t err = prepare(tc::gmm_dw_kernel, tc::kDwSmem, &sms);
  if (err != cudaSuccess) return (int)err;
  const int tiles = G * cdiv(D, tc::kRows) * cdiv(F, tc::kCols);
  tc::gmm_dw_kernel<<<tiles < sms ? tiles : sms, tc::kThreads, tc::kDwSmem, stream>>>(
      xm, dym, static_cast<const int*>(bounds), static_cast<float*>(dw_out), br, G, D, F);
  return (int)cudaGetLastError();
}

template <typename T>
int fwd(const void* x, const void* w, const void* tg, void* y, int n_tiles, int br,
        int G, int D, int F, cudaStream_t stream) {
  const int n_sub = cdiv(br, kTile);
  const dim3 grid(cdiv(F, kTile), n_tiles * n_sub);
  gmm_fwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const int*>(tg),
      static_cast<T*>(y), br, n_sub, G, D, F);
  return (int)cudaGetLastError();
}

template <typename T>
int dx(const void* dy, const void* w, const void* tg, void* dx_out, int n_tiles,
       int br, int G, int D, int F, cudaStream_t stream) {
  const int n_sub = cdiv(br, kTile);
  const dim3 grid(cdiv(D, kTile), n_tiles * n_sub);
  gmm_dx_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(w), static_cast<const int*>(tg),
      static_cast<T*>(dx_out), br, n_sub, G, D, F);
  return (int)cudaGetLastError();
}

template <typename T>
int dw(const void* x, const void* dy, const void* bounds, void* dw_out, int br,
       int G, int D, int F, cudaStream_t stream) {
  const dim3 grid(cdiv(F, kTile), cdiv(D, kTile), G);
  gmm_dw_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const int*>(bounds), static_cast<float*>(dw_out), br, G, D, F);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). dtype: 0 = float32, 1 =
// bfloat16 (x, w, dy, y and dx share it; dW is float32). D and F must be
// multiples of 8 and every pointer 16-byte aligned (the wrapper checks;
// TMA needs the same of the tensor-core instances' maps). Each returns the
// cudaError_t of its launch (0 = launched), -1 for a dtype it has no
// instance for, -2 when libcuda has no cuTensorMapEncodeTiled, -3 when it
// refuses a tensor map.

// Which instance a kernel (0 gmm_fwd, 1 gmm_dx, 2 gmm_dw) runs for dtype
// and row tile br: 2 the tensor-core instances (wgmma + TMA, bf16, br a
// multiple of 128), 1 the mma.sync tiles (bf16), 0 scalar FMA (float32),
// -1 none. The entry points dispatch by it.
extern "C" int gmm_route(int kernel, int dtype, int br) {
  if (kernel < 0 || kernel > 2 || (dtype != 0 && dtype != 1) || br <= 0) return -1;
  if (dtype == 0) return 0;
  return br % tc::kRows == 0 ? 2 : 1;
}

extern "C" int gmm_fwd(const void* x, const void* w, const void* tile_group, void* y,
                       int n_tiles, int br, int G, int D, int F, int dtype,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (gmm_route(0, dtype, br)) {
    case 2: return rows_tc<false>(x, w, tile_group, y, n_tiles, br, G, D, F, s);
    case 1: return fwd<__nv_bfloat16>(x, w, tile_group, y, n_tiles, br, G, D, F, s);
    case 0: return fwd<float>(x, w, tile_group, y, n_tiles, br, G, D, F, s);
  }
  return -1;
}

extern "C" int gmm_dx(const void* dy, const void* w, const void* tile_group, void* dx_out,
                      int n_tiles, int br, int G, int D, int F, int dtype,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (gmm_route(1, dtype, br)) {
    case 2: return rows_tc<true>(dy, w, tile_group, dx_out, n_tiles, br, G, D, F, s);
    case 1: return dx<__nv_bfloat16>(dy, w, tile_group, dx_out, n_tiles, br, G, D, F, s);
    case 0: return dx<float>(dy, w, tile_group, dx_out, n_tiles, br, G, D, F, s);
  }
  return -1;
}

// bounds: int32 [2 * G], each group's first row tile then its end tile
extern "C" int gmm_dw(const void* x, const void* dy, const void* bounds, void* dw_out,
                      int br, int G, int D, int F, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (gmm_route(2, dtype, br)) {
    case 2: return dw_tc(x, dy, bounds, dw_out, br, G, D, F, s);
    case 1: return dw<__nv_bfloat16>(x, dy, bounds, dw_out, br, G, D, F, s);
    case 0: return dw<float>(x, dy, bounds, dw_out, br, G, D, F, s);
  }
  return -1;
}
