// Int8 weight-only matmul for Hopper (sm_90a): out = x @ dequant(wq, scale).
//
// Replaces tony_tpu/ops/quant_mm.py::_qmm_kernel (:84, reached through
// _pallas_impl): the TPU kernel that the serving engine's decode and verify
// steps call for each of the seven layer matmuls and lm_head when the int8
// weight copy is on. It computes what that kernel computes:
//   x      [M, D]   bf16 or float32 (M = the step's rows: one per slot, or
//                   G per slot in a verify step)
//   wq     [D, N]   int8, row-major (N contiguous), as quantize_weights
//                   gives it: read in place, no repacked copy
//   scale  [N]      float32, one per output channel
//   out    [M, N]   x's dtype
// Each weight is dequantized on its own, float(wq) * scale[n], and rounded
// to x's dtype before the product, as the TPU kernel does; the products
// accumulate in float32 and the sum is rounded to x's dtype once.
//
// What bounds it on this card: bytes. At a decode step's 8 rows there are 16
// operations per weight byte, at a verify step's 128 rows 256, both under
// the H100's ~295 operations per byte for the bf16 tensor cores, so the
// least time is the int8 weight (plus the scales, x and out) over the 3.35
// TB/s of HBM3: 7.50 GB of Llama-3-8B int8 weights a step, about 2.24 ms.
// chip_smoke.py computes the bound per shape.
//
// What the design does about it (bf16 x, namespace tc, quant_mm_kernel<NT>):
// - The weight is read once, whatever the row count: a CTA owns 256
//   output columns and a range of D, and covers every row of x up to 128
//   (NT n-tiles of 8 rows; past 128 rows a grid dimension of row tiles).
// - Products on the tensor cores, the weight as the wide operand: A = W^T
//   (16 output columns a fragment), B = x^T, bf16 in and float32 sums
//   (the rounding the TPU kernel does). Up to 32 rows mma.sync m16n8k16
//   (8 rows an n-tile), 8 warps of 32 columns; from 33 rows wgmma
//   m64nNk16 with A from registers (N = 8 NT up to 128), two warpgroups
//   of two m64 tiles, x's staged slice read as B through a descriptor.
//   mma.sync reaches the bytes where the weight dominates; at 128 rows
//   (256 operations a byte) it left the products at twice the streaming
//   time, as every warp read all of x from shared memory, and wgmma reads
//   it once a warpgroup at the tensor cores' full rate. NT x 2 x 4
//   float32 accumulators a thread either way.
// - Dequantized straight into the fragments, each weight once. The int8
//   tile [k][n] in shared memory is read by ldmatrix.trans as 16-bit
//   pairs along n, so a lane's register holds W[k][n], W[k][n+1],
//   W[k+1][n], W[k+1][n+1] (k = 2 (lane % 4), n = 2 (lane / 4) in its
//   8 x 8 block): byte permutes pair k with k + 1. Fragment row g of a
//   16-column group is therefore column 2 g and row g + 8 column 2 g + 1,
//   a permutation the accumulators follow. A byte becomes the float
//   2^23 + 128 + q by one permute, minus 2^23 + 128 exactly q, times the
//   column's scale, rounded to bf16 in (k, k + 1) pairs: about 3.5
//   instructions a weight, shared by NT mma's. (The other layout, a
//   dequantize pass into a bf16 tile and ldmatrix from there, writes and
//   reads every weight through shared memory twice more.)
// - Staging: a cp.async ring of 64-deep slices (8 stages up to 64 rows, 6
//   at 128: one CTA an SM, 7 or 5 slices in flight), the int8 weight tile (64 x 256, 16 KB) and x's slice (8 NT
//   rows x 64, bf16) side by side, 16-byte chunks XOR-swizzled by row so
//   that ldmatrix's 8 row addresses fall on distinct banks. A ragged N
//   (not a multiple of 16) loads the weight byte by byte.
// - Split-K for narrow N (wq/wo: 16 column tiles for 132 SMs, wk/wv 4):
//   the wrapper splits D over `splits` CTAs per column tile, at most 8,
//   chosen from (D, N) and the card (its SMs, and how many clusters of
//   each size it holds at once: 15 of 8 on an H100, not 16) and never
//   from M (ops/quant_mm.py split_k), so a row's float32 sum runs in the
//   same order decoded
//   alone, in 8 slots or in a verify step's 128 rows. The splits of a
//   column tile are one thread-block cluster: each leaves its float32
//   partial tile in its own shared memory, and after a cluster barrier
//   each writes a share of the outputs, reading the partials of ranks 0,
//   1, ... over distributed shared memory and adding them in that order.
//   No workspace, no atomics, one launch per call. (A first design wrote
//   the partials to global memory and let the last CTA of a tile, picked
//   by an atomic counter, sum them; its serial L2 round trips cost more
//   than the products at 128 rows. PERF.md.)
// float32 x keeps the scalar-FMA body below (TF32 would round x otherwise
// than the reference): a CTA owns 32 output columns at a time and a slot
// tile of 8 rows; 256 threads are 2 across the columns (16 each, one int4)
// by 128 row groups down D; x staged in shared memory as float. Measured
// times against the bound are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// A byte q of u = word ^ 0x80808080 (offset to unsigned) as the float
// 2^23 + 128 + q; subtracting 2^23 + 128 leaves float(q) exactly
__device__ __forceinline__ float byte_to_f(uint32_t u, int j) {
  return __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + j)), 8388736.0f);
}

// ------------------------------------------------ float32 x: scalar FMA
constexpr int kThreads = 256;
constexpr int kVec = 16;                          // columns per thread: one int4
constexpr int kCols = 32;                         // output columns per tile
constexpr int kColThreads = kCols / kVec;         // threads across the columns
constexpr int kRowGroups = kThreads / kColThreads;
constexpr int kMT = 8;                            // x rows per CTA
constexpr int kUnroll = 4;                        // rows per thread per step
constexpr int kStageUnroll = 8;                   // 16-byte x loads in flight
constexpr int kChunk = 4096;                      // rows of D staged per chunk
constexpr int kHalf = kMT / 2;                    // slots per reduce pass
constexpr int kRedStride = kHalf * kCols + 4;     // +4: float4 stores, no conflicts
constexpr int kStageFloats = kChunk * kMT;
constexpr int kRedFloats = kRowGroups * kRedStride;
constexpr int kSmemBytes = 4 * (kStageFloats + kRedFloats);
static_assert(kHalf * kCols <= kThreads, "one thread per output in the reduce");

// Four int8 weights of one 32-bit word, dequantized: float(q) * s[j]
__device__ __forceinline__ void dequant4(uint32_t word, const float* s, float* w) {
  const uint32_t u = word ^ 0x80808080u;          // signed -> biased bytes
#pragma unroll
  for (int j = 0; j < 4; ++j) w[j] = byte_to_f(u, j) * s[j];
}

// 16 int8 weights of row `row` from column col0, zero past N. Rows are
// 16-byte aligned when N % 16 == 0 (every shape of the serving path); a
// ragged N reads byte by byte.
__device__ __forceinline__ int4 load16(const int8_t* __restrict__ wq, size_t row,
                                       int col0, int N, bool vec) {
  const int8_t* src = wq + row * (size_t)N + col0;
  if (vec) return *reinterpret_cast<const int4*>(src);
  int w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int b = col0 + i < N ? (int)(uint8_t)src[i] : 0;
    w[i / 4] |= b << (8 * (i % 4));
  }
  return make_int4(w[0], w[1], w[2], w[3]);
}

// x[m0 .. m0+8, k0 .. k0+kc) into shared memory, [slot][row] (row stride
// kChunk); slots past M are zero. D is a multiple of 8 (the wrapper
// checks), so x's rows move in 16-byte loads, kStageUnroll of them in
// flight per thread before any is stored.
__device__ __forceinline__ void stage_x(const float* __restrict__ x, float* xs, int m0,
                                        int mt, int D, int k0, int kc) {
  constexpr int kPer = 4;                         // floats per 16-byte load
  const int nv = kc / kPer;                       // kc is a multiple of 8
  for (int e0 = threadIdx.x; e0 < kMT * nv; e0 += kThreads * kStageUnroll) {
    float4 raw[kStageUnroll];
#pragma unroll
    for (int u = 0; u < kStageUnroll; ++u) {
      const int e = e0 + u * kThreads;
      const int m = e / nv, v = e % nv;
      raw[u] = (e < kMT * nv && m < mt)
                   ? *reinterpret_cast<const float4*>(x + (size_t)(m0 + m) * D + k0 + v * kPer)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kStageUnroll; ++u) {
      const int e = e0 + u * kThreads;
      if (e >= kMT * nv) break;
      const int m = e / nv, v = e % nv;
      *reinterpret_cast<float4*>(xs + m * kChunk + v * kPer) = raw[u];
    }
  }
}

__device__ __forceinline__ void fma_rows(const int4 (&raw)[kUnroll], int r, int kc,
                                         const float* xs, const float* s,
                                         float (&acc)[kMT][kVec]) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int rr = r + u * kRowGroups;
    if (rr >= kc) break;
    const uint32_t words[4] = {(uint32_t)raw[u].x, (uint32_t)raw[u].y,
                               (uint32_t)raw[u].z, (uint32_t)raw[u].w};
    float w[kVec];
#pragma unroll
    for (int q = 0; q < 4; ++q) dequant4(words[q], s + 4 * q, w + 4 * q);
    float xv[kMT];
#pragma unroll
    for (int m = 0; m < kMT; ++m) xv[m] = xs[m * kChunk + rr];
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[m][i] = fmaf(xv[m], w[i], acc[m][i]);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
quant_mm_kernel(const float* __restrict__ x, const int8_t* __restrict__ wq,
                const float* __restrict__ scale, float* __restrict__ out,
                int M, int D, int N) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int cg = tid % kColThreads;
  const int rg = tid / kColThreads;
  const int m0 = blockIdx.y * kMT;
  const int mt = min(kMT, M - m0);
  const bool vec = N % kVec == 0;
  const int n_tiles = (N + kCols - 1) / kCols;
  const bool one_chunk = D <= kChunk;     // x staged once for every tile
  float* red = smem + kStageFloats;
  if (one_chunk) {
    stage_x(x, smem, m0, mt, D, 0, D);
    __syncthreads();
  }

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int col0 = tile * kCols + cg * kVec;
    const bool live = col0 < N;           // this thread's columns exist
    float s[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) s[i] = col0 + i < N ? scale[col0 + i] : 0.f;
    float acc[kMT][kVec];
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[m][i] = 0.f;

    for (int k0 = 0; k0 < D; k0 += kChunk) {
      const int kc = min(kChunk, D - k0);
      if (!one_chunk) {
        __syncthreads();                  // the previous readers are done
        stage_x(x, smem, m0, mt, D, k0, kc);
        __syncthreads();
      }
      if (!live) continue;
      // software pipeline: the next four rows load while these compute
      int4 cur[kUnroll], nxt[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int rr = rg + u * kRowGroups;
        cur[u] = rr < kc ? load16(wq, (size_t)(k0 + rr), col0, N, vec)
                         : make_int4(0, 0, 0, 0);
      }
      for (int r = rg; r < kc; r += kRowGroups * kUnroll) {
        const int rn = r + kRowGroups * kUnroll;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int rr = rn + u * kRowGroups;
          nxt[u] = rr < kc ? load16(wq, (size_t)(k0 + rr), col0, N, vec)
                           : make_int4(0, 0, 0, 0);
        }
        fma_rows(cur, r, kc, smem, s, acc);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) cur[u] = nxt[u];
      }
    }

    // the row groups' partial sums meet in shared memory, four slots at a
    // time: [group][slot, column], then one thread per output sums its
    // column over the groups
    float* mine = red + rg * kRedStride + cg * kVec;
#pragma unroll
    for (int h = 0; h < kMT; h += kHalf) {
      __syncthreads();                    // the previous pass's readers are done
#pragma unroll
      for (int m = 0; m < kHalf; ++m)
#pragma unroll
        for (int i = 0; i < kVec; i += 4)
          *reinterpret_cast<float4*>(mine + m * kCols + i) = make_float4(
              acc[h + m][i], acc[h + m][i + 1], acc[h + m][i + 2], acc[h + m][i + 3]);
      __syncthreads();
      if (tid < kHalf * kCols) {
        const int m = h + tid / kCols;
        const int col = tile * kCols + tid % kCols;
        float p0 = 0.f, p1 = 0.f, p2 = 0.f, p3 = 0.f;
        for (int g = 0; g < kRowGroups; g += 4) {
          p0 += red[g * kRedStride + tid];
          p1 += red[(g + 1) * kRedStride + tid];
          p2 += red[(g + 2) * kRedStride + tid];
          p3 += red[(g + 3) * kRedStride + tid];
        }
        if (m < mt && col < N) out[(size_t)(m0 + m) * N + col] = (p0 + p1) + (p2 + p3);
      }
    }
  }
}

int launch_scalar(const void* x, const void* wq, const void* scale, void* out, int M, int D,
                  int N, cudaStream_t stream) {
  // past the default 48 KB the kernel must opt in; the attribute is per
  // device, so it is set on every launch rather than cached
  cudaError_t err = cudaFuncSetAttribute(
      quant_mm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (N + kCols - 1) / kCols;
  const int m_tiles = (M + kMT - 1) / kMT;
  // one CTA per SM (registers and shared memory allow no second), spread
  // over the slot tiles
  const int per_m = max(1, min(n_tiles, sms / m_tiles));
  const dim3 grid(per_m, m_tiles);
  quant_mm_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(scale), static_cast<float*>(out), M, D, N);
  return (int)cudaGetLastError();
}

// ------------------------------------------------ bf16 x: tensor cores
namespace tc {

constexpr int kThreads = 256;     // 8 warps, 32 output columns each
constexpr int kCols = 256;        // output columns of a CTA
constexpr int kDepth = 64;        // rows of D in a stage
constexpr int kWBytes = kDepth * kCols;           // the int8 weight tile: 16 KB
constexpr int kMaxNT = 16;                        // 128 rows of x in one CTA
constexpr int kMaxSplits = 8;                     // a portable cluster

template <int NT>
__host__ __device__ constexpr int x_bytes() { return NT * 8 * kDepth * 2; }
// ring stages: 8 up to 64 rows (136 to 192 KB), 6 at 128 (192 KB): one CTA
// an SM at every row count, 7 or 5 slices in flight (the bytes in flight
// set a CTA's rate), and one cluster capacity for the wrapper's split; the
// partials of the split-K reduction (8 NT x 256 floats) reuse the ring once
// the main loop is done
template <int NT>
__host__ __device__ constexpr int stages() { return NT <= 8 ? 8 : 6; }
// 1 KB to align the ring to 1024 (wgmma's swizzled B), then the ring
template <int NT>
__host__ __device__ constexpr int smem_bytes() {
  return 1024 + stages<NT>() * (kWBytes + x_bytes<NT>());
}
static_assert(smem_bytes<kMaxNT>() - 1024 >= kMaxNT * 8 * kCols * 4, "partials fit the ring");

// 16 bytes global -> shared, zero-filled (nothing read) unless `ok`
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void st_shared16(uint32_t dst, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// d[0..3] += a (16 x 16, row) b (16 x 8, col), bf16 in, float32
// accumulate; not volatile (registers in, registers out), so ptxas may
// interleave it with the next fragments' loads and dequantization
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the cluster's CTAs all arrive here before any goes on; shared-memory
// writes before it are seen by the cluster's reads after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::
                   : "memory");
}

// 16 bytes of CTA `rank`'s shared memory at the offset of local address a
__device__ __forceinline__ float4 ld_cluster16(uint32_t a, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(a), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

// One ldmatrix.trans register, bytes W[k][n], W[k][n+1], W[k+1][n],
// W[k+1][n+1], dequantized into the two A-fragment registers it feeds:
// (W[k][n], W[k+1][n]) s0 for column n and (W[k][n+1], W[k+1][n+1]) s1
// for column n + 1, each product rounded to bf16
__device__ __forceinline__ void dequant_pairs(uint32_t word, float s0, float s1, uint32_t& a_n,
                                              uint32_t& a_n1) {
  const uint32_t u = word ^ 0x80808080u;
  a_n = pack_bf16(__fmul_rn(byte_to_f(u, 0), s0), __fmul_rn(byte_to_f(u, 2), s0));
  a_n1 = pack_bf16(__fmul_rn(byte_to_f(u, 1), s1), __fmul_rn(byte_to_f(u, 3), s1));
}

// Shared-memory offsets, 16-byte chunks XOR-swizzled by the row: the
// weight tile [kDepth][kCols] int8 (16 chunks a row), x's slice
// [8 NT][kDepth] bf16 (8 chunks a row)
__device__ __forceinline__ uint32_t w_off(int k, int c) { return k * kCols + ((c ^ (k & 7)) << 4); }
__device__ __forceinline__ uint32_t x_off(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// The copies one thread starts for each 64-deep slice, addresses worked
// out once: weight rows wk + 16 i (i < 4) of its 16-byte column chunk wc,
// and x's rows xr + 32 i of its chunk xc (the first 8 NT x 8 chunks of
// the slice, spread over the threads). Swizzled offsets step by whole
// rows, so the XOR is the same for every i. Everything past D, N or M is
// zero-filled. A ragged N (rows not 16-byte aligned) takes weight bytes
// one at a time instead.
template <int NT>
struct Loader {
  static constexpr int kX = cdiv(NT * 8 * (kDepth / 8), kThreads);   // x copies a thread
  const int8_t* w;                // its first weight chunk of the next slice
  const __nv_bfloat16* x;         // its first x chunk of the next slice
  size_t wstep;                   // bytes between its weight rows (16 N)
  uint32_t wdst, xdst;            // their offsets in a stage
  int wk, k;                      // its weight row in a slice, the slice's first row of D
  bool wcol, xrow[kX], xown[kX];

  __device__ __forceinline__ Loader(const int8_t* wq, const __nv_bfloat16* xg, int k0, int n0,
                                    int m0, int M, int D, int N) {
    const int wc = threadIdx.x % 16, xc = threadIdx.x % 8, xr = threadIdx.x / 8;
    wk = threadIdx.x / 16;
    k = k0;
    wcol = n0 + 16 * wc < N;
    w = wq + (size_t)(k0 + wk) * N + n0 + 16 * wc;
    wstep = (size_t)16 * N;
    wdst = w_off(wk, wc);
    x = xg + (size_t)(m0 + xr) * D + k0 + 8 * xc;
    xdst = x_off(xr, xc);
#pragma unroll
    for (int i = 0; i < kX; ++i) {
      xown[i] = xr + 32 * i < NT * 8;
      xrow[i] = m0 + xr + 32 * i < M;
    }
  }

  // this slice's copies into stage buffers sw, sx; then step to the next
  __device__ __forceinline__ void copy(uint32_t sw, uint32_t sx, const int8_t* wq,
                                        const __nv_bfloat16* xg, int D, int N, bool vec) {
#pragma unroll
    for (int i = 0; i < kDepth / 16; ++i) {
      const bool in = wcol && k + wk + 16 * i < D;
      const int8_t* src = w + i * wstep;
      if (vec) {
        cp_async16(sw + wdst + i * 16 * kCols, in ? src : wq, in);
      } else {
        const int gn = (int)((src - wq) % N);
        uint32_t b[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int e = 0; e < 16; ++e)
          if (in && gn + e < N) b[e / 4] |= (uint32_t)(uint8_t)src[e] << (8 * (e % 4));
        st_shared16(sw + wdst + i * 16 * kCols, make_uint4(b[0], b[1], b[2], b[3]));
      }
    }
    const bool xk = k + 8 * (threadIdx.x % 8) < D;
#pragma unroll
    for (int i = 0; i < kX; ++i) {
      if (!xown[i]) continue;
      const bool in = xrow[i] && xk;
      cp_async16(sx + xdst + i * 32 * 128, in ? x + (size_t)32 * i * D : xg, in);
    }
    w += (size_t)kDepth * N;
    x += kDepth;
    k += kDepth;
  }
};

// grid (column tiles of 256, splits, row tiles of 8 NT), clusters of
// (1, splits, 1): CTA (t, s, z) sums out[rows of z][columns of t] over
// split s's range of D; the cluster's CTAs then meet their float32
// partials in shared memory and each writes a share of the tile, summed
// in split order.
//
// The products: up to 32 rows (NT <= 4) mma.sync m16n8k16, warp w owning
// columns 32 w .. 32 w + 31; from 33 rows wgmma m64nNk16 (N = 8 NT) with
// A from registers and x's slice as B (K-major, the 128-byte swizzle
// x_off writes), warpgroup v owning columns 128 v .. 128 v + 127 as two
// m64 tiles, warp w of it their rows 16 w .. 16 w + 15: the tensor cores
// read x from shared memory once a warpgroup instead of once a warp, at
// wgmma's rate. A fragment is the same in both: rows g and g + 8 of a
// 16-column group are its columns 2 g and 2 g + 1. So are the
// accumulators: acc[f][4 j + c] is x row 8 j + 2 t4 + (c & 1) of column
// 16 chunk(f) + 2 g + (c >> 1).
template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
quant_mm_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ wq,
                const float* __restrict__ scale, __nv_bfloat16* __restrict__ out, int M, int D,
                int N, int splits) {
  constexpr int S = stages<NT>();
  constexpr bool kWg = NT >= 8;
  extern __shared__ __align__(128) uint8_t ring[];
  const uint32_t sW = (saddr(ring) + 1023) & ~1023u, sX = sW + S * kWBytes;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const int n0 = blockIdx.x * kCols, split = blockIdx.y, m0 = blockIdx.z * 8 * NT;
  const bool vec = N % 16 == 0;
  // split's slices of D: [s0, s0 + nk) of cdiv(D, 64)
  const int slices = cdiv(D, kDepth), per = cdiv(slices, splits);
  const int s0 = split * per, nk = max(0, min(slices, s0 + per) - s0);
  // its two 16-column chunks of the tile
  int chunk[2];
#pragma unroll
  for (int f = 0; f < 2; ++f) chunk[f] = kWg ? 8 * (warp / 4) + 4 * f + warp % 4 : 2 * warp + f;

  // fragment f, row half e -> column n0 + 16 chunk[f] + 2 g + e
  float sc[2][2];
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + 16 * chunk[f] + 2 * g + e;
      sc[f][e] = n < N ? scale[n] : 0.f;
    }
  float acc[2][4 * NT];
  zero(acc[0]);
  zero(acc[1]);

  Loader<NT> ld(wq, x, s0 * kDepth, n0, m0, M, D, N);
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nk) ld.copy(sW + s * kWBytes, sX + s * x_bytes<NT>(), wq, x, D, N, vec);
    cp_commit();
  }
  for (int t = 0; t < nk; ++t) {
    cp_wait<S - 2>();                            // slice t has landed
    if constexpr (kWg) fence_async_smem();       // its copies, seen by wgmma's reads
    __syncthreads();                             // and slice t - 1's readers are done
    const int nt = t + S - 1;
    if (nt < nk) ld.copy(sW + nt % S * kWBytes, sX + nt % S * x_bytes<NT>(), wq, x, D, N, vec);
    cp_commit();
    const uint32_t w = sW + t % S * kWBytes, xs = sX + t % S * x_bytes<NT>();
    // ldmatrix.trans matrix q = lane / 8: k half q % 2, column chunk
    // chunk[q / 2]; r[2 f + h] feeds fragment f's k half h. Step kk + 1's
    // bytes load while step kk's dequantize and multiply.
    const int q = lane / 8;
    uint32_t r[4];
    ldsm_x4_t(r, w + w_off(8 * (q % 2) + lane % 8, chunk[q / 2]));
    uint32_t a[2][2][4];                         // wgmma: [kk % 2][f]
#pragma unroll
    for (int kk = 0; kk < kDepth / 16; ++kk) {
      uint32_t rn[4];
      if (kk + 1 < kDepth / 16)
        ldsm_x4_t(rn, w + w_off(16 * (kk + 1) + 8 * (q % 2) + lane % 8, chunk[q / 2]));
      uint32_t (&ak)[2][4] = a[kk % 2];
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          dequant_pairs(r[2 * f + h], sc[f][0], sc[f][1], ak[f][2 * h], ak[f][2 * h + 1]);
      if constexpr (kWg) {
        // step kk's two products in flight while step kk + 1 dequantizes;
        // the wait leaves step kk - 1's done, so its fragments are free
        hold(acc[0]);
        hold(acc[1]);
        wg_fence();
        const uint64_t b = desc(xs + 32 * kk, 16);
        mma_rs<8 * NT, 0>(acc[0], ak[0], b, 1);
        mma_rs<8 * NT, 0>(acc[1], ak[1], b, 1);
        wg_commit();
        wg_wait<1>();
        hold(acc[0]);
        hold(acc[1]);
      } else {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          // x rows 8 j .. 8 j + 7 at k chunks 2 kk (lanes 0-7) and 2 kk + 1
          uint32_t b[2];
          ldsm_x2(b, xs + x_off(8 * j + lane % 8, 2 * kk + (lane / 8) % 2));
          mma_bf16(&acc[0][4 * j], ak[0], b);
          mma_bf16(&acc[1][4 * j], ak[1], b);
        }
      }
      if (kk + 1 < kDepth / 16)
#pragma unroll
        for (int i = 0; i < 4; ++i) r[i] = rn[i];
    }
    if constexpr (kWg) {
      wg_wait<0>();                              // the slice's products read xs
      hold(acc[0]);
      hold(acc[1]);
    }
  }

  // the partial tile [8 NT][256] float32 into the ring: acc[f][4 j + c]
  // with c = e and e + 2 are rows r of columns c0 and c0 + 1 (r = 8 j +
  // 2 t4 + e, c0 = 16 chunk[f] + 2 g)
  cp_wait<0>();
  __syncthreads();                               // the ring's last readers are done
  float* part = reinterpret_cast<float*>(ring + (sW - saddr(ring)));
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *reinterpret_cast<float2*>(part + (8 * j + 2 * t4 + e) * kCols + 16 * chunk[f] +
                                   2 * g) = make_float2(acc[f][4 * j + e], acc[f][4 * j + e + 2]);
  cluster_sync();
  // CTA `split` of the cluster writes every splits-th group of 4 outputs,
  // each the partials of ranks 0, 1, ... added in that order: the same
  // order, and so the same bits, at every M
  const bool by4 = N % 4 == 0;
  for (int e = split * kThreads + threadIdx.x; e < 8 * NT * kCols / 4; e += splits * kThreads) {
    const int r = 4 * e / kCols, c = 4 * e % kCols, m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    const uint32_t a = saddr(part + 4 * e);
    float4 v = ld_cluster16(a, 0);
    for (int q = 1; q < splits; ++q) {
      const float4 u = ld_cluster16(a, q);
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    __nv_bfloat16* o = out + (size_t)m * N + n;
    if (by4 && n + 4 <= N) {
      *reinterpret_cast<uint2*>(o) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
    } else {
      const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (n + i < N) o[i] = __float2bfloat16(vs[i]);
    }
  }
  cluster_sync();                                // no CTA leaves while its partial is read
}

}  // namespace tc

template <int NT>
cudaLaunchConfig_t launch_config(int M, int N, int splits, cudaStream_t stream,
                                 cudaLaunchAttribute* cluster) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cdiv(N, tc::kCols), splits, cdiv(M, 8 * NT));
  cfg.blockDim = dim3(tc::kThreads);
  cfg.dynamicSmemBytes = tc::smem_bytes<NT>();
  cfg.stream = stream;
  cluster->id = cudaLaunchAttributeClusterDimension;
  cluster->val.clusterDim.x = 1;
  cluster->val.clusterDim.y = splits;
  cluster->val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cfg;
}

template <int NT>
int launch_tc(const void* x, const void* wq, const void* scale, void* out, int M, int D, int N,
              int splits, cudaStream_t stream) {
  constexpr int smem = tc::smem_bytes<NT>();
  const cudaError_t err = cudaFuncSetAttribute(
      tc::quant_mm_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg = launch_config<NT>(M, N, splits, stream, &cluster);
  return (int)cudaLaunchKernelEx(&cfg, tc::quant_mm_kernel<NT>,
                                 static_cast<const __nv_bfloat16*>(x),
                                 static_cast<const int8_t*>(wq), static_cast<const float*>(scale),
                                 static_cast<__nv_bfloat16*>(out), M, D, N, splits);
}

}  // namespace

// Plain C entry points (bound with ctypes). dtype: 0 = float32, 1 = bfloat16
// (x and out).

// Which instance quant_mm runs for dtype: 1 the tensor cores (bf16), 0
// scalar FMA (float32), -1 none. The entry point dispatches by it.
extern "C" int quant_mm_route(int dtype) {
  return dtype == 1 ? 1 : dtype == 0 ? 0 : -1;
}

// How many clusters of `splits` CTAs of the tensor-core instance the
// current card holds at once (every instance holds one CTA an SM), or the
// negated cudaError_t. The wrapper splits D only as far as a column tile's
// clusters all fit: a second wave would double the time.
extern "C" int quant_mm_max_clusters(int splits) {
  if (splits < 1 || splits > tc::kMaxSplits) return -1;
  cudaError_t err = cudaFuncSetAttribute(tc::quant_mm_kernel<tc::kMaxNT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         tc::smem_bytes<tc::kMaxNT>());
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg = launch_config<tc::kMaxNT>(1, tc::kCols, splits, 0, &cluster);
  int n = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&n, tc::quant_mm_kernel<tc::kMaxNT>, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

// The tensor-core instance takes rows 8 NT at a time (NT the fewest n-tiles
// of 1, 2, 4, 8, 16 that cover M, 16 past 128 rows: a grid dimension of row
// tiles) and splits D `splits` ways, 1 to 8 (a cluster of that many CTAs
// per column tile); the scalar instance reads no split. Returns the
// cudaError_t of the launch (0 = launched), -1 for a dtype it has no
// instance for, -2 for a split outside 1..8.
extern "C" int quant_mm(const void* x, const void* wq, const void* scale, void* out, int M,
                        int D, int N, int splits, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (quant_mm_route(dtype)) {
    case 1:
      if (splits < 1 || splits > tc::kMaxSplits) return -2;
      if (M <= 8) return launch_tc<1>(x, wq, scale, out, M, D, N, splits, s);
      if (M <= 16) return launch_tc<2>(x, wq, scale, out, M, D, N, splits, s);
      if (M <= 32) return launch_tc<4>(x, wq, scale, out, M, D, N, splits, s);
      if (M <= 64) return launch_tc<8>(x, wq, scale, out, M, D, N, splits, s);
      return launch_tc<tc::kMaxNT>(x, wq, scale, out, M, D, N, splits, s);
    case 0: return launch_scalar(x, wq, scale, out, M, D, N, s);
  }
  return -1;
}
