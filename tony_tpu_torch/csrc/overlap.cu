// One ring chunk's product for Hopper (sm_90a): out [M, N] float32 =
// A [M, K] B [K, N], the matmul of one step of the decomposed fsdp
// collectives.
//
// Replaces the TPU kernel of tony_tpu/ops/overlap.py:
//   chunk_mm <- _mm_kernel (:75), launched by _chunk_mm (:82) over a grid
//               of N tiles of _pick_block(N, 256): dot_general of the
//               whole A block and one column tile of B, float32 out
// and computes what it computes: products of the input type summed in
// float32. The ring's float32 accumulation (acc + chunk) stays outside the
// kernel, as it stays outside the TPU kernel.
//
// Operands are views, read where they lie. A ring step multiplies a column
// slice of the activations (row stride D), a transposed weight shard (the
// backward's dx reads W^T) or a transposed activation slice (the
// backward's dW reads x^T), so each operand comes as a base pointer, a
// leading dimension and its major order: A K-major (element (m, k) at
// a[m lda + k]) or MN-major (at a[k lda + m]); B MN-major (element (k, n)
// at b[k ldb + n]) or K-major (at b[n ldb + k]). out is dense, row stride N.
//
// What bounds it. At bench_1b4's chunks (M 8192 local rows, K 1024-5504,
// N 1024-5504) a chunk is 1.7e10-9.2e10 operations on 20-110 MB: about 290
// operations per byte read and written, at the card's bf16 balance point
// (989 TFLOP/s over 3.35 TB/s). So the bf16 instance runs on the tensor
// cores (wgmma, operands staged by TMA), and its float32 output is written
// straight from the accumulators with 8-byte stores while the producer
// already loads the next tile's slices.
//
// Why not the TPU's blocks. The TPU kernel holds the whole [M, K] A block
// and a [K, 256] column tile of B in VMEM (16 MB and more at M 8192): far
// past an SM's 227 KB. So the bf16 instance is the persistent 128 x 256
// tile GEMM the grouped and CE kernels share (sm90.cuh, tc::pgemm): one CTA
// per SM walks output tiles, a ring of four 64-deep slices of both
// operands in flight. The tensor maps' strides read each operand K- or
// MN-major in place (wgmma takes both orders from shared memory), so no
// transpose is copied. float32 runs scalar FMA tiles (the tensor cores
// have no float32 form; TF32 would round the operands).
//
// No atomics: every output element is summed by one thread in a fixed
// order, so two launches on the same inputs are bit-equal.

#include "sm90.cuh"

namespace {

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// ------------------------------------------------ float32: scalar FMA tiles
// One CTA of 256 threads per 128 x 128 output tile; 8-deep slices of A and B
// staged in shared memory; each thread sums an 8 x 8 block of the tile
// (rows 4 ty + i and 64 + 4 ty + i, columns likewise from tx).
constexpr int kThreads = 256;
constexpr int kTile = 128;
constexpr int kSlice = 8;

// element e (0 .. 1023) of a [kTile][kSlice] slice, walked along the
// operand's contiguous dim so that neighbouring threads read neighbouring
// addresses: (mn, k)
__device__ __forceinline__ int2 slot(int e, bool k_contig) {
  return k_contig ? make_int2(e / kSlice, e % kSlice) : make_int2(e % kTile, e / kTile);
}

__global__ void __launch_bounds__(kThreads)
chunk_mm_f32_kernel(const float* __restrict__ a, long long sam, long long sak,
                    const float* __restrict__ b, long long sbk, long long sbn,
                    float* __restrict__ out, int M, int N, int K) {
  __shared__ float sa[kSlice][kTile];
  __shared__ float sb[kSlice][kTile];
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const bool a_kc = sak == 1, b_kc = sbk == 1;
  for (int k0 = 0; k0 < K; k0 += kSlice) {
#pragma unroll
    for (int q = 0; q < kTile * kSlice / kThreads; ++q) {
      const int e = threadIdx.x + q * kThreads;
      const int2 pa = slot(e, a_kc), pb = slot(e, b_kc);
      const int m = m0 + pa.x, ka = k0 + pa.y, n = n0 + pb.x, kb = k0 + pb.y;
      sa[pa.y][pa.x] = m < M && ka < K ? a[m * sam + ka * sak] : 0.f;
      sb[pb.y][pb.x] = n < N && kb < K ? b[kb * sbk + n * sbn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kSlice; ++k) {
      float x[8], y[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[i] = sa[k][4 * ty + i];
        x[4 + i] = sa[k][64 + 4 * ty + i];
        y[i] = sb[k][4 * tx + i];
        y[4 + i] = sb[k][64 + 4 * tx + i];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
      if (n < N) out[(long long)m * N + n] = acc[i][j];
    }
  }
}

// ------------------------------------------------ bf16: wgmma + TMA
// pgemm's persistent 128 x 256 tile GEMM (sm90.cuh). Each operand goes
// through a 2-D tensor map of [64][64] boxes as tall and wide as its real
// part, (inner, outer) coordinates: A K-major (K, M), MN-major (M, K); B
// MN-major (N, K), K-major (K, N). TMA zero-fills what a box reads past the
// edge, so a contraction tail adds exact zeros; boxes wholly past M or N
// are not loaded, and the outputs that read their stale stage lie past
// the edge and are never stored.

namespace tc {

using namespace pgemm;

// Four stages, as the CE backward's dW: a stage's load is issued about 2.5
// slices' products before the consumers need it. 1 KB to align to 1024 and
// 192 KB of ring; the epilogue stores from registers, with no staging tile
constexpr int kStages = 4;
constexpr int kSmem = 1024 + kStages * (kABytes + kBBytes);

// out = A B, A read K-major (TA 0) or MN-major (1), B MN-major (TB 1) or
// K-major (0). Tiles walk row blocks outermost: at the ring's chunk shapes
// both operands (at most 16 and 11 MB) stay in the 50 MB L2.
template <int TA, int TB>
__global__ void __launch_bounds__(kThreads, 1)
chunk_mm_kernel(const __grid_constant__ CUtensorMap amap,
                const __grid_constant__ CUtensorMap bmap, float* __restrict__ out, int M,
                int N, int K) {
  extern __shared__ uint8_t smem[];
  __shared__ __align__(8) uint64_t bars[2 * kStages];
  const uint32_t sA = (saddr(smem) + 1023) & ~1023u, sB = sA + kStages * kABytes;
  const Ring<kStages> ring{saddr(bars), saddr(bars) + 8 * kStages};
  const int n_cols = cdiv(N, kCols), nk = cdiv(K, kDepth);
  const int tiles = cdiv(M, kRows) * n_cols;

  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      int it = 0;                                  // slices loaded, over all tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / n_cols * kRows, n0 = tile % n_cols * kCols;
        const int na = min(kRows / kHalf, cdiv(M - m0, kHalf));
        const int nb = min(kCols / kHalf, cdiv(N - n0, kHalf));
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
  const int rr = 16 * (tid / 32) + lane / 4;      // its rows rr and rr + 8 of 64
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / n_cols * kRows, n0 = tile % n_cols * kCols;
    // acc[j][4 i + c]: row m0 + 64 cw + rr (+ 8 for c >= 2), column n0 +
    // 128 j + 8 i + 2 t4 (+ 1 for odd c)
    float acc[kCols / 128][64];
#pragma unroll
    for (int j = 0; j < kCols / 128; ++j) zero(acc[j]);
    mainloop<kStages, TA, TB>(acc, ring, it, nk, sA + cw * kBox, sB);
    // float32 pairs straight to out, every store predicated (N is even, so
    // a pair is wholly inside or past it), none branched
    const int row = m0 + 64 * cw + rr;
#pragma unroll
    for (int j = 0; j < kCols / 128; ++j)
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row + 8 * h, c = n0 + 128 * j + 8 * i + 2 * t4;
          st_pair_if(r < M && c < N, out + (long long)r * N + c, acc[j][4 * i + 2 * h],
                     acc[j][4 * i + 2 * h + 1]);
        }
  }
}

}  // namespace tc

// a bf16 [outer][inner] view with row stride ld as a map of [64][64] boxes
int map2(CUtensorMap* map, const void* p, int inner, int outer, long long ld) {
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const long long strides[1] = {ld};
  const cuuint32_t box[2] = {(cuuint32_t)tc::kHalf, (cuuint32_t)tc::kHalf};
  return encode_map<2>(map, p, dims, strides, box);
}

template <int TA, int TB>
int launch_tc(const void* a, long long lda, const void* b, long long ldb, float* out, int M,
              int N, int K, cudaStream_t stream) {
  CUtensorMap am, bm;
  int e = TA ? map2(&am, a, M, K, lda) : map2(&am, a, K, M, lda);
  if (!e) e = TB ? map2(&bm, b, N, K, ldb) : map2(&bm, b, K, N, ldb);
  if (e) return e;
  const auto kernel = tc::chunk_mm_kernel<TA, TB>;
  int sms = 0;
  const cudaError_t err = prepare(kernel, tc::kSmem, &sms);
  if (err != cudaSuccess) return (int)err;
  const int tiles = cdiv(M, tc::kRows) * cdiv(N, tc::kCols);
  kernel<<<tiles < sms ? tiles : sms, tc::kThreads, tc::kSmem, stream>>>(am, bm, out, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes).

// Which instance chunk_mm runs for dtype (0 float32, 1 bfloat16): 2 the
// tensor-core instance (wgmma + TMA: bf16), 0 scalar FMA (float32), -1 none.
extern "C" int chunk_mm_route(int dtype) {
  return dtype == 1 ? 2 : dtype == 0 ? 0 : -1;
}

// out [M, N] float32 = A [M, K] B [K, N]. a_mn: A MN-major (else K-major);
// b_k: B K-major (else MN-major); lda, ldb their leading dimensions in
// elements. The tensor-core instance needs 16-byte-aligned bases, lda and
// ldb multiples of 8 and N even (the wrapper checks). Returns the launch's
// cudaError_t (0 = launched), -1 for a dtype with no instance, -2 when
// libcuda has no cuTensorMapEncodeTiled, -3 when it refuses a tensor map.
extern "C" int chunk_mm(const void* a, long long lda, int a_mn, const void* b, long long ldb,
                        int b_k, void* out, int M, int N, int K, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  switch (chunk_mm_route(dtype)) {
    case 2:
      if (a_mn)
        return b_k ? launch_tc<1, 0>(a, lda, b, ldb, o, M, N, K, s)
                   : launch_tc<1, 1>(a, lda, b, ldb, o, M, N, K, s);
      return b_k ? launch_tc<0, 0>(a, lda, b, ldb, o, M, N, K, s)
                 : launch_tc<0, 1>(a, lda, b, ldb, o, M, N, K, s);
    case 0: {
      const long long sam = a_mn ? 1 : lda, sak = a_mn ? lda : 1;
      const long long sbk = b_k ? 1 : ldb, sbn = b_k ? ldb : 1;
      chunk_mm_f32_kernel<<<dim3(cdiv(N, kTile), cdiv(M, kTile)), kThreads, 0, s>>>(
          static_cast<const float*>(a), sam, sak, static_cast<const float*>(b), sbk, sbn, o,
          M, N, K);
      return (int)cudaGetLastError();
    }
  }
  return -1;
}
