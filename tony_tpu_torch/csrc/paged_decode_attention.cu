// GQA decode attention for Hopper (sm_90a): one decode step of attention
// for every row of a batch, reading K/V through a block table (kernels 8
// and 9 of PERF.md's table) or from a contiguous cache (kernel 7).
//
// Replaces tony_tpu/ops/decode_attention.py::_paged_kernel (its tile body
// is _paged_body): the TPU kernel that the serving engine's decode step
// calls once per layer. It computes what that kernel computes:
//   q      [B, G, H, hd]           G query positions per row (G = 1 when
//                                  decoding one token)
//   k, v   [P, Hkv, blk, hd]       physical-block pools of one layer
//   lengths[B]   int32             cache length after this step's writes
//   tables [B, M] int32            row b's logical block j lives at
//                                  tables[b, j]
//   out    [B, G, H, hd]
// Query g of row b attends positions < lengths[b] - (G - 1) + g, with an
// online softmax in float32 (m, l, acc), scores scaled after the dot, and
// the probabilities cast to the cache dtype before P.V as the TPU kernel
// does. Head h reads kv head h / (H / Hkv).
//
// Shape of the work. One CTA per (row b, kv head x): grid B * Hkv, 256
// threads. The G * rep query rows that share kv head x are folded into
// one tile (R = G * rep rows), so each K/V byte is read once per CTA. The
// CTA reads its own row length and walks its table row for
// j < ceil(len / blk): this takes the place of the TPU's scalar prefetch,
// and table entries past the length are never read. Each logical block is
// staged into shared memory with 16-byte loads, in chunks of `chunk`
// positions (the whole block at the serving shapes); scores go warp per
// position with the lanes across head_dim (rows reduced four at a time),
// the softmax update warp per row, and P.V thread per (row, dim) with the
// accumulator in shared memory and four independent partial sums.
//
// What bounds it on this card: bytes. A decode step does 4 * R * hd flops
// per K/V position against 2 * hd * sizeof(T) bytes, far below the H100's
// ~295 flop/byte ridge. The least time is the distinct K/V bytes up to
// each row's length (a block shared by two rows counted once) plus q and
// out, over the 3.35 TB/s of HBM3 (H100 SXM data sheet): at chip_smoke.py's
// Llama-3-8B decode case (8 rows of 5..2048 positions, two rows sharing 8
// blocks, 8 kv heads, hd 128, bf16) that is 28.7 MB, 8.6 us, as the script
// computes it. The design reads every needed byte once per CTA (a block
// shared by two rows is read by both) and nothing past a row's length; it
// does not yet overlap loads with math (no cp.async/TMA pipeline), and
// B * Hkv CTAs
// (64 at 8 rows) fill under half of the 132 SMs: splitting the sequence
// across CTAs (flash-decoding) is the known next step. Measured times
// against this bound are in PERF.md.

// Quantized pools (the same kernel, templated on the payload type P).
// Replaces tony_tpu/ops/decode_attention.py::_paged_quant_kernel (reached
// through _paged_pallas): the step the engine runs when its KV pools are
// block-scaled int8 or fp8 e4m3. The pools hold P, and two scale pools
//   k_scale, v_scale [P, Hkv] float32
// carry one scale per physical block per kv head. Each K/V element is
// dequantized as float(payload) * scale[tables[b, j], x] and rounded to the
// query's dtype, as the TPU kernel does, before the dot. The CTA loads the
// two scales of a block beside its table entry, one load each per (block,
// kv head), and dequantizes each 16-byte vector of payload in registers as
// it stages the chunk into shared memory: shared memory holds the
// dequantized values in the query's dtype, so the chunking rule is the
// unquantized kernel's at that dtype, and the dequantized cache never
// exists in device memory. Bound: the same as above with one byte per K/V
// element plus two float32 scales per (block, kv head) read, about half the
// bf16 pools' bytes. Scales are not clamped and no block past a row's length
// is read, so a NaN scale reaches exactly the rows whose tables name its
// block.

// Contiguous caches (the same CTA body, templated on how a block's address
// is found). Replaces tony_tpu/ops/decode_attention.py::_decode_kernel
// (reached through _decode_pallas): decode attention over a contiguous
// head-major cache
//   k, v   [B, Hkv, T, hd]         T = M * blk (blk = min(block, T))
// with no table: logical block j of row b, kv head x starts at position
// (b * Hkv + x) * T + j * blk. The grid, the folding of the G * rep query
// rows, the G mask and the numerics are kernel 8's. Bound: the K/V bytes
// up to each row's length plus q and out, over HBM's 3.35 TB/s (bytes:
// 4 * R * hd flops per position against 2 * hd * sizeof(T) bytes). The
// reference bench's case (8 rows of 1024 positions, 4 kv heads, hd 128,
// bf16) moves 16.8 MB: 5.0 us; chip_smoke.py prints the measured time
// beside it.
//
// Both forms read no K/V position at or past a row's length: a CTA walks
// blocks j < min(ceil(len / blk), M) and stages only the chunk's positions
// below the length, so neither the tail of a row's last block nor anything
// past the table's M blocks is read. The rest of the chunk's shared memory
// keeps stale values; their scores are replaced by the length mask and
// P.V stops at the staged positions, so none reaches the output. (A branch
// that set those scores masked instead spilled registers and ran slower on
// the card; PERF.md section 6 has the times.) A speculative verify step's padding
// rows ask for up to G - 1 positions past their written length; with the
// clamp to M they see at most the table's width, as the plain version does.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHeadDim = 256;
// the TPU kernel's -0.7 * float32 max: finite, so exp(m_prev - m_new) of
// two masked maxima is 1 and never NaN
constexpr float kNeg = -0.7f * 3.4028234663852886e38f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// One 16-byte vector of 1-byte payload -> 16 values of T in shared memory:
// float(payload) * sc, rounded to T, stored with 16-byte writes.
template <typename T, typename P>
__device__ __forceinline__ void dequant16(const int4 raw, float sc, T* __restrict__ dst) {
  static_assert(sizeof(P) == 1, "quantized payloads are one byte");
  const P* b = reinterpret_cast<const P*>(&raw);
  alignas(16) T vals[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) vals[i] = from_f<T>(to_f(b[i]) * sc);
  const int4* src = reinterpret_cast<const int4*>(vals);
  int4* d = reinterpret_cast<int4*>(dst);
#pragma unroll
  for (int u = 0; u < (int)(16 * sizeof(T) / 16); ++u) d[u] = src[u];
}

// The CTA body of both forms. T: the query's (and output's, and staged
// K/V's) dtype; P: the cache's payload, T itself for unquantized caches
// (k_scale/v_scale unused, null). kPaged: block j of row b is physical
// block tables[b, j] of the pools; otherwise it is block j of row b's
// contiguous cache (tables unused, null; M = T / blk).
template <typename T, typename P, bool kPaged>
__device__ __forceinline__ void decode_cta(
    const T* __restrict__ q, const P* __restrict__ k, const P* __restrict__ v,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int* __restrict__ lengths, const int* __restrict__ tables,
    T* __restrict__ out, int G, int H, int Hkv, int hd, int blk, int M, int chunk,
    float scale) {
  constexpr bool kQuant = !std::is_same<T, P>::value;
  static_assert(kPaged || !kQuant, "quantized caches are paged");
  const int b = blockIdx.x / Hkv;
  const int x = blockIdx.x % Hkv;
  const int rep = H / Hkv;
  const int R = G * rep;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);                       // [chunk, hd]
  T* v_s = k_s + chunk * hd;                                 // [chunk, hd]
  float* q_s = reinterpret_cast<float*>(v_s + chunk * hd);   // [R, hd]
  float* acc = q_s + R * hd;                                 // [R, hd]
  float* s_s = acc + R * hd;                                 // [R, chunk]
  float* m_s = s_s + R * chunk;                              // [R]
  float* l_s = m_s + R;                                      // [R]
  float* c_s = l_s + R;                                      // [R]

  const int len = lengths[b];
  // folded row r = g * rep + i is query g of head x * rep + i
  for (int e = tid; e < R * hd; e += kThreads) {
    const int r = e / hd, d = e % hd;
    const int g = r / rep, i = r % rep;
    q_s[e] = to_f(q[((size_t)(b * G + g) * H + x * rep + i) * hd + d]);
    acc[e] = 0.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    m_s[r] = kNeg;
    l_s[r] = 0.f;
  }

  const int n_blocks = min((len + blk - 1) / blk, M);
  for (int j = 0; j < n_blocks; ++j) {
    size_t block_off;
    // the block's two scales ride with its table entry
    float ksc = 1.f, vsc = 1.f;
    if constexpr (kPaged) {
      const int pid = tables[(size_t)b * M + j];
      block_off = ((size_t)pid * Hkv + x) * blk * hd;
      if constexpr (kQuant) {
        ksc = k_scale[(size_t)pid * Hkv + x];
        vsc = v_scale[(size_t)pid * Hkv + x];
      }
    } else {
      block_off = (((size_t)b * Hkv + x) * M + j) * blk * hd;
    }
    for (int c0 = 0; c0 < blk; c0 += chunk) {
      const int base = j * blk + c0;  // logical position of the chunk's first entry
      if (base >= len) break;         // uniform across the CTA
      // positions of the chunk below the length: the only ones loaded (the
      // mask below covers the rest, whose shared memory is stale)
      const int n_valid = min(chunk, len - base);
      const int n_vec = n_valid * hd * (int)sizeof(P) / 16;
      __syncthreads();                // the previous chunk's readers are done
      const int4* ksrc = reinterpret_cast<const int4*>(k + block_off + (size_t)c0 * hd);
      const int4* vsrc = reinterpret_cast<const int4*>(v + block_off + (size_t)c0 * hd);
      if constexpr (kQuant) {
        // dequantize in registers while staging: 16 payload bytes -> 16 T
        for (int i = tid; i < n_vec; i += kThreads) {
          dequant16<T, P>(ksrc[i], ksc, k_s + i * 16);
          dequant16<T, P>(vsrc[i], vsc, v_s + i * 16);
        }
      } else {
        int4* kdst = reinterpret_cast<int4*>(k_s);
        int4* vdst = reinterpret_cast<int4*>(v_s);
        for (int i = tid; i < n_vec; i += kThreads) {
          kdst[i] = ksrc[i];
          vdst[i] = vsrc[i];
        }
      }
      __syncthreads();

      // scores: one warp per position, lanes across head_dim; the rows'
      // dot products reduce in groups of 4 with interleaved shuffles, so
      // the shuffle latency is paid once per group, not once per row
      for (int t = warp; t < chunk; t += kWarps) {
        const int pos = base + t;
        float kr[kMaxHeadDim / 32];
#pragma unroll
        for (int u = 0; u < kMaxHeadDim / 32; ++u) {
          const int d = lane + 32 * u;
          kr[u] = d < hd ? to_f(k_s[t * hd + d]) : 0.f;
        }
        for (int r0 = 0; r0 < R; r0 += 4) {
          float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int u = 0; u < kMaxHeadDim / 32; ++u) {
            const int d = lane + 32 * u;
            if (d < hd) {
#pragma unroll
              for (int w = 0; w < 4; ++w)
                if (r0 + w < R) part[w] += q_s[(r0 + w) * hd + d] * kr[u];
            }
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
            for (int w = 0; w < 4; ++w)
              part[w] += __shfl_xor_sync(0xffffffffu, part[w], o);
          }
          // lane w keeps row r0 + w (a select chain, not a dynamic index,
          // so part[] stays in registers)
          const float mine = lane == 0 ? part[0] : lane == 1 ? part[1]
                           : lane == 2 ? part[2] : part[3];
          const int r = r0 + lane;
          if (lane < 4 && r < R) {
            const bool ok = pos < len - (G - 1) + r / rep;
            s_s[r * chunk + t] = ok ? mine * scale : kNeg;
          }
        }
      }
      __syncthreads();

      // online softmax update: one warp per row
      for (int r = warp; r < R; r += kWarps) {
        const int lim = len - (G - 1) + r / rep;
        float mx = kNeg;
        for (int t = lane; t < chunk; t += 32) mx = fmaxf(mx, s_s[r * chunk + t]);
        mx = warp_max(mx);
        const float m_prev = m_s[r];
        const float m_new = fmaxf(m_prev, mx);
        float sum = 0.f;
        for (int t = lane; t < chunk; t += 32) {
          const float p = base + t < lim ? expf(s_s[r * chunk + t] - m_new) : 0.f;
          sum += p;
          // P.V takes p in the cache dtype, as the TPU kernel does
          s_s[r * chunk + t] = to_f(from_f<T>(p));
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          const float corr = expf(m_prev - m_new);
          c_s[r] = corr;
          l_s[r] = l_s[r] * corr + sum;
          m_s[r] = m_new;
        }
      }
      __syncthreads();

      // acc = acc * corr + P.V over the staged positions only: the rest of
      // the chunk was never loaded and must not reach the sum
      for (int e = tid; e < R * hd; e += kThreads) {
        const int r = e / hd, d = e % hd;
        const float* pr = s_s + r * chunk;
        // four independent partial sums: the FMAs do not wait on each other
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        int t = 0;
        for (; t + 4 <= n_valid; t += 4) {
          a0 += pr[t] * to_f(v_s[t * hd + d]);
          a1 += pr[t + 1] * to_f(v_s[(t + 1) * hd + d]);
          a2 += pr[t + 2] * to_f(v_s[(t + 2) * hd + d]);
          a3 += pr[t + 3] * to_f(v_s[(t + 3) * hd + d]);
        }
        for (; t < n_valid; ++t) a0 += pr[t] * to_f(v_s[t * hd + d]);
        acc[e] = acc[e] * c_s[r] + ((a0 + a1) + (a2 + a3));
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < R * hd; e += kThreads) {
    const int r = e / hd, d = e % hd;
    const int g = r / rep, i = r % rep;
    out[((size_t)(b * G + g) * H + x * rep + i) * hd + d] =
        from_f<T>(acc[e] / fmaxf(l_s[r], 1e-30f));
  }
}

// Kernels 8 and 9: paged pools (P = T unquantized).
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const P* __restrict__ k,
                    const P* __restrict__ v, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ lengths,
                    const int* __restrict__ tables, T* __restrict__ out,
                    int G, int H, int Hkv, int hd, int blk, int M, int chunk,
                    float scale) {
  decode_cta<T, P, true>(q, k, v, k_scale, v_scale, lengths, tables, out, G, H,
                         Hkv, hd, blk, M, chunk, scale);
}

// Kernel 7: a contiguous cache of M blocks of blk positions per row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ lengths,
              T* __restrict__ out, int G, int H, int Hkv, int hd, int blk, int M,
              int chunk, float scale) {
  decode_cta<T, T, false>(q, k, v, nullptr, nullptr, lengths, nullptr, out, G, H,
                          Hkv, hd, blk, M, chunk, scale);
}

// One CTA per (row, kv head). Past the default 48 KB of shared memory the
// kernel must opt in; the attribute is per device, so it is set on every
// such launch rather than cached.
template <typename Kernel, typename... Args>
int launch_cta(Kernel kernel, int B, int Hkv, int smem_bytes, cudaStream_t stream,
               Args... args) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<B * Hkv, kThreads, smem_bytes, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <typename T, typename P>
int launch(const void* q, const void* k, const void* v, const float* k_scale,
           const float* v_scale, const int* lengths, const int* tables,
           void* out, int B, int G, int H, int Hkv, int hd, int blk, int M,
           int chunk, float scale, int smem_bytes, cudaStream_t stream) {
  return launch_cta(paged_decode_kernel<T, P>, B, Hkv, smem_bytes, stream,
                    static_cast<const T*>(q), static_cast<const P*>(k),
                    static_cast<const P*>(v), k_scale, v_scale, lengths, tables,
                    static_cast<T*>(out), G, H, Hkv, hd, blk, M, chunk, scale);
}

template <typename T>
int launch_contiguous(const void* q, const void* k, const void* v,
                      const int* lengths, void* out, int B, int G, int H, int Hkv,
                      int hd, int blk, int M, int chunk, float scale,
                      int smem_bytes, cudaStream_t stream) {
  return launch_cta(decode_kernel<T>, B, Hkv, smem_bytes, stream,
                    static_cast<const T*>(q), static_cast<const T*>(k),
                    static_cast<const T*>(v), lengths, static_cast<T*>(out), G, H,
                    Hkv, hd, blk, M, chunk, scale);
}

template <typename T>
int launch_quant(const void* q, const void* k, const void* v, const float* ks,
                 const float* vs, const int* len_p, const int* tbl_p, void* out,
                 int B, int G, int H, int Hkv, int hd, int blk, int M, int chunk,
                 float scale, int smem_bytes, int payload, cudaStream_t s) {
  if (payload == 1)
    return launch<T, __nv_fp8_e4m3>(q, k, v, ks, vs, len_p, tbl_p, out, B, G, H,
                                    Hkv, hd, blk, M, chunk, scale, smem_bytes, s);
  return launch<T, int8_t>(q, k, v, ks, vs, len_p, tbl_p, out, B, G, H, Hkv, hd,
                           blk, M, chunk, scale, smem_bytes, s);
}

}  // namespace

// Plain C entry points (bound with ctypes). dtype: 0 = float32, 1 = bfloat16
// (q, out and the unquantized pools). Each returns the cudaError_t of the
// launch (0 = launched).
extern "C" int paged_decode_attention(
    const void* q, const void* k, const void* v, const void* lengths,
    const void* tables, void* out, int B, int G, int H, int Hkv, int hd,
    int blk, int M, int chunk, float scale, int smem_bytes, int dtype,
    void* stream) {
  const int* len_p = static_cast<const int*>(lengths);
  const int* tbl_p = static_cast<const int*>(tables);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, nullptr, nullptr, len_p, tbl_p, out, B, G, H, Hkv, hd, blk, M,
        chunk, scale, smem_bytes, s);
  return launch<float, float>(q, k, v, nullptr, nullptr, len_p, tbl_p, out, B,
                              G, H, Hkv, hd, blk, M, chunk, scale, smem_bytes, s);
}

// Quantized pools: payload 0 = int8, 1 = fp8 e4m3; k_scale/v_scale
// [P, Hkv] float32.
extern "C" int paged_decode_attention_quant(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* lengths, const void* tables, void* out,
    int B, int G, int H, int Hkv, int hd, int blk, int M, int chunk,
    float scale, int smem_bytes, int dtype, int payload, void* stream) {
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* len_p = static_cast<const int*>(lengths);
  const int* tbl_p = static_cast<const int*>(tables);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_quant<__nv_bfloat16>(q, k, v, ks, vs, len_p, tbl_p, out, B, G,
                                       H, Hkv, hd, blk, M, chunk, scale,
                                       smem_bytes, payload, s);
  return launch_quant<float>(q, k, v, ks, vs, len_p, tbl_p, out, B, G, H, Hkv,
                             hd, blk, M, chunk, scale, smem_bytes, payload, s);
}

// Contiguous caches k/v [B, Hkv, M * blk, hd] in q's dtype.
extern "C" int decode_attention_contiguous(
    const void* q, const void* k, const void* v, const void* lengths, void* out,
    int B, int G, int H, int Hkv, int hd, int blk, int M, int chunk, float scale,
    int smem_bytes, int dtype, void* stream) {
  const int* len_p = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_contiguous<__nv_bfloat16>(q, k, v, len_p, out, B, G, H, Hkv, hd,
                                            blk, M, chunk, scale, smem_bytes, s);
  return launch_contiguous<float>(q, k, v, len_p, out, B, G, H, Hkv, hd, blk, M,
                                  chunk, scale, smem_bytes, s);
}
