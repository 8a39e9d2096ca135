// Int8 weight-only matmul for Hopper (sm_90a): out = x @ dequant(wq, scale).
//
// Replaces tony_tpu/ops/quant_mm.py::_qmm_kernel (reached through
// _pallas_impl): the TPU kernel that the serving engine's decode step calls
// for each of the seven layer matmuls and lm_head when the int8 weight copy
// is on. It computes what that kernel computes:
//   x      [M, D]   bf16 or float32 (M = the decode batch: one row per slot)
//   wq     [D, N]   int8, row-major (N contiguous)
//   scale  [N]      float32, one per output channel
//   out    [M, N]   x's dtype
// Each weight is dequantized on its own, float(wq) * scale[n], and rounded
// to x's dtype before the product, as the TPU kernel does; the products
// accumulate in float32 and the sum is rounded to x's dtype once.
//
// What bounds it on this card: bytes, nearly. At the decode step's M = 8
// there are 8 multiply-adds per weight byte, far below the H100's ~295
// flop/byte ridge for the tensor cores, so the least time is the int8
// weight (plus the scales, x and out) over the 3.35 TB/s of HBM3: 7.50 GB
// of Llama-3-8B int8 weights a step, about 2.24 ms. On CUDA cores the
// same work is close to its own limit: 8 float32 FMAs and about 5 more
// instructions to dequantize each weight byte put the instruction floor
// near twice the bytes bound. chip_smoke.py computes the bound per shape.
//
// What the design does about it. The weight is read once, in 16-byte
// loads: a CTA owns 32 output columns at a time and every x row tile of 8
// slots; its 256 threads are 2 across the 32 columns (16 columns, one
// int4, each) by 128 row groups down D, so a warp reads 16 rows x 32
// contiguous bytes (whole 32-byte sectors), and each thread loads its next
// four rows before it computes the current four. The dequantization is
// integer work where it can be: a byte becomes a float by one byte permute
// into 2^23's mantissa and one subtraction (exact), then one multiply by
// the channel's scale; bf16 rounds two weights per instruction. x is
// staged through shared memory as float, in chunks of 4096 rows of D (w2's
// x row is 14,336 wide), in 16-byte loads that are all in flight before
// any is stored. CTAs are persistent: one per SM walks
// the column tiles, so where D fits one chunk x is staged once per CTA,
// not once per tile. The 128 row groups' partial sums meet once per tile
// in shared memory beside the staged x, four slots per pass. Tensor cores
// (mma with x as the 8-wide operand), split-K for narrow N (wk/wv have 32
// tiles for 132 SMs) and cp.async/TMA staging are later work. Measured times against the bound are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Four int8 weights of one 32-bit word, dequantized: float(q) * s[j], then
// rounded to T (bf16 two at a time). A byte b lands as the float
// 2^23 + (b + 128) by one permute; subtracting 2^23 + 128 leaves float(b)
// exactly, so the product is the one the TPU kernel rounds.
template <typename T>
__device__ __forceinline__ void dequant4(uint32_t word, const float* s, float* w) {
  const uint32_t u = word ^ 0x80808080u;          // signed -> biased bytes
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float f = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + j)) -
                    8388736.0f;                    // 2^23 + 128
    w[j] = f * s[j];
  }
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
      const float2 r = __bfloat1622float2(__floats2bfloat162_rn(w[j], w[j + 1]));
      w[j] = r.x;
      w[j + 1] = r.y;
    }
  }
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

// x[m0 .. m0+8, k0 .. k0+kc) into shared memory as float, [slot][row]
// (row stride kChunk); slots past M are zero. D is a multiple of 8 (the
// wrapper checks), so x's rows move in 16-byte loads, kStageUnroll of them
// in flight per thread before any is stored.
template <typename T>
__device__ __forceinline__ void stage_x(const T* __restrict__ x, float* xs, int m0,
                                        int mt, int D, int k0, int kc) {
  constexpr int kPer = 16 / (int)sizeof(T);       // elements per 16-byte load
  const int nv = kc / kPer;                       // kc is a multiple of 8
  for (int e0 = threadIdx.x; e0 < kMT * nv; e0 += kThreads * kStageUnroll) {
    int4 raw[kStageUnroll];
#pragma unroll
    for (int u = 0; u < kStageUnroll; ++u) {
      const int e = e0 + u * kThreads;
      const int m = e / nv, v = e % nv;
      raw[u] = (e < kMT * nv && m < mt)
                   ? *reinterpret_cast<const int4*>(x + (size_t)(m0 + m) * D + k0 + v * kPer)
                   : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kStageUnroll; ++u) {
      const int e = e0 + u * kThreads;
      if (e >= kMT * nv) break;
      const int m = e / nv, v = e % nv;
      const T* vals = reinterpret_cast<const T*>(&raw[u]);
      float4* dst = reinterpret_cast<float4*>(xs + m * kChunk + v * kPer);
#pragma unroll
      for (int i = 0; i < kPer; i += 4)
        dst[i / 4] = make_float4(to_f(vals[i]), to_f(vals[i + 1]), to_f(vals[i + 2]),
                                 to_f(vals[i + 3]));
    }
  }
}

template <typename T>
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
    for (int q = 0; q < 4; ++q) dequant4<T>(words[q], s + 4 * q, w + 4 * q);
    float xv[kMT];
#pragma unroll
    for (int m = 0; m < kMT; ++m) xv[m] = xs[m * kChunk + rr];
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[m][i] = fmaf(xv[m], w[i], acc[m][i]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
quant_mm_kernel(const T* __restrict__ x, const int8_t* __restrict__ wq,
                const float* __restrict__ scale, T* __restrict__ out,
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
        fma_rows<T>(cur, r, kc, smem, s, acc);
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
        if (m < mt && col < N)
          out[(size_t)(m0 + m) * N + col] = from_f<T>((p0 + p1) + (p2 + p3));
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* wq, const void* scale, void* out, int M,
           int D, int N, cudaStream_t stream) {
  // past the default 48 KB the kernel must opt in; the attribute is per
  // device, so it is set on every launch rather than cached
  cudaError_t err = cudaFuncSetAttribute(
      quant_mm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
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
  quant_mm_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(scale), static_cast<T*>(out), M, D, N);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). dtype: 0 = float32, 1 = bfloat16
// (x and out). Returns the cudaError_t of the launch (0 = launched).
extern "C" int quant_mm(const void* x, const void* wq, const void* scale,
                        void* out, int M, int D, int N, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch<__nv_bfloat16>(x, wq, scale, out, M, D, N, s);
  return launch<float>(x, wq, scale, out, M, D, N, s);
}
