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
// Two designs, picked per call by decode_route (ops/decode_attention.py's
// kernel_instance asks the same function, so Python and CUDA agree):
//
// bf16 queries on the tensor cores (namespace tc, tc::paged_decode_kernel
// for the paged form, tc::paged_quant_decode_kernel for quantized pools and
// tc::decode_kernel for the contiguous one, at head_dim a multiple of 16
// up to 128 and up to 128 query rows a kv head), the path of the serving
// engine's decode and verify steps:
// - A fixed split over the sequence (flash-decoding). The grid is (split
//   s, kv head x, row b); split s covers positions [s * kSplit, (s + 1) *
//   kSplit) of its row, kSplit = 256 whatever the batch, the grid or the
//   other rows (128 and 512 measured slower, PERF.md section 6). The host
//   does not know the lengths, so the grid takes ceil(M * blk / kSplit)
//   splits a row and a CTA past its row's length exits at once. A row of
//   one split writes its output directly; a longer row's CTAs write
//   float32 partials (acc [R, hd], m, l) to a workspace the wrapper
//   allocates, and tc::decode_merge_kernel combines them in the order of
//   s: M = max m_s, out = sum e^(m_s - M) acc_s / max(sum e^(m_s - M) l_s,
//   1e-30), one thread an output. A second kernel, not a last-CTA counter:
//   it needs no zeroed counters that outlive a launch. It is launched as a
//   programmatic dependent of the split kernel, so its launch overlaps the
//   split kernel's last CTAs, and griddepcontrol.wait orders its reads.
// - Each CTA (256 threads, 8 warps) first works out where each position
//   of its split lies, one thread a position (the paged form looks the
//   block up in the table row, whose entries past the length are never
//   read), then streams the split in tiles of kTile = 64 positions
//   through a ring of shared-memory stages filled with cp.async.cg 16-byte
//   copies, so the next tiles load while one is computed: for bf16 pools
//   three stages, two for the NT 4 and 8 instances, where a third would
//   keep a second CTA off the SM (quantized pools: below). Positions at
//   or past the row's length are zero-filled (cp.async with a source size
//   of 0 reads nothing). The queries ride with the first tile's copies.
// - mma.sync m16n8k16, bf16 in, float32 accumulators, fed by ldmatrix, in
//   the "swap AB" form: S^T = K Q^T with positions as the m16 dimension
//   and the R = G * rep query rows as n8 tiles (padded to 8, 32, 64 or 128
//   rows: the instance NT = 1, 4, 8 or 16), the k-steps in two chains
//   summed at the end; then out^T = V^T P^T (V through ldmatrix.trans)
//   with each warp owning 16 of head_dim. The scores go through shared
//   memory for the online softmax of the tile (8 lanes a query row), and
//   each row's p, rounded to bf16 before P.V as the TPU kernel does,
//   overwrites its scores. K, V and Q rows are padded with 8 bf16 and the
//   score rows with 4 floats, so that ldmatrix's 8 row addresses fall on
//   distinct banks.
// - Invariance: a (row, query) output depends on its own length and data
//   alone. Splits and tiles sit at fixed positions, every reduction has a
//   fixed order, each output column of an mma depends on its own query
//   row only, and no atomics touch the sums: a row computed in a batch
//   equals the row computed alone, query G - 1 of a verify step equals a
//   one-token step at the same length, and two launches are bit-equal.
//
// The scalar CTA body (float32 queries, over any pools, and bf16 shapes the
// tensor-core instance does not take): one CTA per (row b, kv head x),
// 256 threads. The G * rep query rows that share kv head x are folded into
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
// computes it. Both designs read every needed byte once per CTA (a block
// shared by two rows is read by both) and nothing past a row's length.
// The scalar body fills B * Hkv CTAs (64 at 8 rows, under half of the 132
// SMs) and does not overlap loads with math; the split gives the
// tensor-core instance 264 working CTAs at that case, two an SM, each
// with tiles in flight while it computes. What holds it above the bound is
// each CTA's chain of dependent reads (its length, then its table
// entries, then its first tiles) and the per-tile steps between barriers.
// Measured times against this bound are in PERF.md.

// Quantized pools (both designs templated on the payload type P).
// Replaces tony_tpu/ops/decode_attention.py::_paged_quant_kernel (reached
// through _paged_pallas): the step the engine runs when its KV pools are
// block-scaled int8 or fp8 e4m3. The pools hold P, and two scale pools
//   k_scale, v_scale [P, Hkv] float32
// carry one scale per physical block per kv head. Each K/V element is
// dequantized as float(payload) * scale[tables[b, j], x] and rounded to the
// query's dtype, as the TPU kernel does, before the dot: the scale is not
// folded into the score or the output, which would round otherwise.
// Bound: the same as above with one byte per K/V element plus two float32
// scales per (block, kv head) read, about half the bf16 pools' bytes.
// - bf16 queries: tc::paged_quant_decode_kernel<NT, P>, kernel 8's split
//   CTA in a quantized address-and-dequant mode, with kernel 8's split,
//   merge, workspace and invariance. The scalar body it replaces ran one
//   CTA per (row, kv head), 64 CTAs at the serving case for 132 SMs, with
//   scalar math and no load in flight while it computed: 48x its bound at
//   G 1 and 370x at the verify step's G 16 (PERF.md). Here the loop that
//   finds each position's offset keeps its (block, kv head), and the
//   position's K and V scales (0 past the length) are loaded from it once
//   a CTA while the first tiles are in flight; a tile of 64 positions may
//   span several blocks, so a scale is taken a position, not a tile. The
//   ring stages one-byte tiles [64][hd] with the same cp.async copies,
//   half the bf16 ring's bytes, so it holds one stage more at the same
//   occupancy (four, three and two stages at NT 1 / 16, 4 and 8), and a
//   stage is refilled as soon as its V is dequantized, before the
//   softmax. The CTA dequantizes a tile, 8 bytes a
//   thread into one 16-byte store, into a bf16 K and a bf16 V tile in the
//   padded layout kernel 8's ldmatrix reads: tile t's V beside its scores,
//   tile t + 1's K beside tile t's P.V, so it keeps kernel 8's three
//   barriers a tile. The math is kernel 8's, so the output is bit-equal
//   to kernel 8 over pools dequantized beforehand (the card tests assert
//   it). What holds it above the bound is kernel 8's: each CTA's chain of
//   dependent reads and per-tile steps, plus the dequant's conversions
//   (PERF.md section 6 has the times, and what a copy without the
//   dequant showed).
// - float32 queries: the scalar CTA body, which loads the two scales of a
//   block beside its table entry and dequantizes each 16-byte vector of
//   payload in registers as it stages the chunk into shared memory, in
//   the query's dtype (so the chunking rule is the unquantized kernel's at
//   that dtype).
// Scales are not clamped, and no block past a row's length is read (a
// position past it dequantizes to an exact 0 through a scale of 0), so a
// NaN scale reaches exactly the rows whose tables name its block below
// their length.

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
// Both forms read no K/V position at or past a row's length. The scalar
// body walks blocks j < min(ceil(len / blk), M) and stages only the
// chunk's positions below the length, so neither the tail of a row's last
// block nor anything past the table's M blocks is read. The rest of the
// chunk's shared memory keeps stale values; their scores are replaced by
// the length mask and P.V stops at the staged positions, so none reaches
// the output. (A branch that set those scores masked instead spilled
// registers and ran slower on the card; PERF.md section 6 has the times.)
// The tensor-core instance copies positions below min(len, M * blk) only,
// reads the table entries of those positions only, and zero-fills the
// rest of a tile. A speculative verify step's padding rows ask for up to
// G - 1 positions past their written length; with the clamp to M they
// see at most the table's width, as the plain version does.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
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

// --- the tensor-core instance for bf16 queries (kernels 7, 8 and 9) ------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSplit = 256;       // positions a split covers, whatever the batch
constexpr int kTile = 64;         // positions a ring stage holds
constexpr int kMaxHd = 128;       // one 16-wide slice of head_dim a warp
constexpr int kMaxRows = 128;     // query rows a kv head (16 n8 tiles)
constexpr int kPad = 8;           // bf16 a K/V/Q row is padded by
constexpr int kSld = kTile + 4;   // float stride of a score row
constexpr int kPld = 2 * kSld;    // bf16 stride of a probability row: p overlays
                                  // its score row (272 bytes: ldmatrix's 8 rows
                                  // fall on distinct banks)
static_assert(kSplit % kTile == 0, "a split is whole tiles");
static_assert(kTile == 16 * 4, "four warps of 16 positions score a tile");

struct Args {
  const bf16* q;
  const void* k;          // bf16 pools, or the int8 / fp8 e4m3 payload of quantized ones
  const void* v;
  const float* k_scale;   // quantized pools only: [P, Hkv] float32
  const float* v_scale;
  const int* lengths;
  const int* tables;  // paged form only
  bf16* out;
  float* ws;          // [B, Hkv, splits, R * (hd + 2)]: acc [R, hd], then (m, l) x R
  int G, H, Hkv, hd, blk, M;
  float scale;
};

// Ring stages of the NT instance, and the CTAs an SM that __launch_bounds__
// asks for. bf16 pools: three, except where a third would keep a second
// CTA off the SM (NT 4 and 8 at head_dim 128). Quantized pools stage one
// byte an element beside a bf16 K and V tile, and the same rule gives
// four, three and two.
__host__ __device__ constexpr int stages(int NT, bool quant) {
  return quant ? (NT == 8 ? 2 : NT == 4 ? 3 : 4) : (NT == 4 || NT == 8 ? 2 : 3);
}
__host__ __device__ constexpr int min_ctas(int NT) { return NT <= 8 ? 2 : 1; }

// Dynamic shared memory of one CTA of the NT instance (layout in
// split_cta): the ring (bf16 rows padded by kPad; payload rows of hd bytes
// and a dequantized bf16 K and V tile when quantized), then the queries,
// scores, offsets (and the positions' scales) and the row state.
__host__ __device__ constexpr int smem_bytes(int hd, int NT, bool quant) {
  return (quant ? stages(NT, true) * 2 * kTile * hd + 2 * kTile * (hd + kPad) * 2 + kSplit * 8
                : stages(NT, false) * 2 * kTile * (hd + kPad) * 2) +
         NT * 8 * (hd + kPad) * 2 + NT * 8 * kSld * 4 + kSplit * 8 + 4 * NT * 8 * 4;
}

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled (nothing read) unless `ok`
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(saddr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(saddr(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(saddr(p)));
}

// d += a (16 x 16, row) b (16 x 8, col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four payload bytes -> four floats: float(payload), exact. int8 by the
// magic-number form (each byte, offset to unsigned, becomes the low byte
// of the float 2^23 + u; subtracting 2^23 + 128 leaves the int8 value);
// fp8 e4m3 two at a time through f16x2 (exact: e4m3 is a subset of f16).
template <typename P>
__device__ __forceinline__ void payload4(uint32_t w, float* f) {
  if constexpr (std::is_same<P, int8_t>::value) {
    const uint32_t u = w ^ 0x80808080u;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[i] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)), 8388736.f);
  } else {
    static_assert(std::is_same<P, __nv_fp8_e4m3>::value, "int8 or fp8 e4m3 payloads");
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const __half2_raw r = __nv_cvt_fp8x2_to_halfraw2(
          static_cast<__nv_fp8x2_storage_t>(w >> (16 * h)), __NV_E4M3);
      const float2 v = __half22float2(__half2(r));
      f[2 * h] = v.x;
      f[2 * h + 1] = v.y;
    }
  }
}

// Dequantize one tile of payload [kTile][hd] bytes into bf16 [kTile][ld]:
// float(payload) * its position's scale, rounded to bf16, as the TPU
// kernel does (and the plain version, and the scalar body's dequant16).
// A thread takes 8 bytes of the rows row0, row0 + step, ... (at most four:
// step >= kThreads / (kMaxHd / 8) = 16) at column c, loads them all first,
// and writes each as one 16-byte store, so both the loads and the stores
// of a quarter-warp cover consecutive bytes.
template <typename P>
__device__ __forceinline__ void dequant_tile(const P* __restrict__ src,
                                             const float2* __restrict__ sc, bool v,
                                             bf16* __restrict__ dst, int hd, int ld,
                                             int row0, int step, int c) {
  static_assert(kTile <= 4 * (kThreads / (kMaxHd / 8)), "four rows a thread at most");
  uint2 raw[4];
  float m[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + i * step;
    if (row < kTile) {
      raw[i] = *reinterpret_cast<const uint2*>(src + row * hd + c * 8);
      const float2 rs = sc[row];
      m[i] = v ? rs.y : rs.x;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + i * step;
    if (row < kTile) {
      float f[8];
      payload4<P>(raw[i].x, f);
      payload4<P>(raw[i].y, f + 4);
      uint4 out;
      uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(__fmul_rn(f[2 * e], m[i]),
                                                       __fmul_rn(f[2 * e + 1], m[i]));
        o[e] = *reinterpret_cast<const uint32_t*>(&h);
      }
      *reinterpret_cast<uint4*>(dst + row * ld + c * 8) = out;
    }
  }
}

// One CTA: split s = blockIdx.x of row b = blockIdx.z, kv head x =
// blockIdx.y, at NT n8 tiles of query rows (R <= 8 * NT). P: the pools'
// element, bf16, or int8 / fp8 e4m3 for quantized pools (then paged), whose
// tiles are staged as bytes and dequantized once a tile into the bf16
// layout the math reads: a tile's V beside its scores, the next tile's K
// beside its P.V, so the quantized mode keeps kernel 8's three barriers a
// tile. Fragment layouts of m16n8k16: lane l holds C rows l / 4 (+ 8) and
// columns 2 * (l % 4) (+ 1); ldmatrix lane l addresses row l % 8 of matrix
// l / 8.
template <int NT, bool kPaged, typename P>
__device__ __forceinline__ void split_cta(const Args& a) {
  constexpr bool kQuant = !std::is_same<P, bf16>::value;
  static_assert(kPaged || !kQuant, "quantized pools are paged");
  static_assert(kSplit == kThreads, "one thread a position of the split");
  constexpr int Rp = NT * 8, kStages = stages(NT, kQuant);
  const int s = blockIdx.x, x = blockIdx.y, b = blockIdx.z;
  const int hd = a.hd, ld = hd + kPad;
  const int rld = kQuant ? hd : ld;                   // a ring row's stride, in P
  const int rep = a.H / a.Hkv, R = a.G * rep;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r8 = lane & 7, mi = lane >> 3;
  const int len = a.lengths[b];
  const int T = a.M * a.blk;
  const int end = min(len, T);                        // positions the row may read
  const int start = s * kSplit;
  if (s > 0 && start >= end) return;                  // past the row: no work
  // the merge may be launched now; it waits for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int stop = min(start + kSplit, end);
  const int n_tiles = stop > start ? (stop - start + kTile - 1) / kTile : 0;
  const int n_split = max(1, (end + kSplit - 1) / kSplit);
  const P* kp = static_cast<const P*>(a.k);
  const P* vp = static_cast<const P*>(a.v);

  extern __shared__ __align__(16) unsigned char smem[];
  P* ring = reinterpret_cast<P*>(smem);               // kStages x {K, V} [kTile][rld]
  // quantized: a tile's K and V, dequantized, {K, V} [kTile][ld]
  bf16* kq_s = reinterpret_cast<bf16*>(ring + kStages * 2 * kTile * rld);
  bf16* vq_s = kq_s + kTile * ld;
  bf16* q_s = kq_s + (kQuant ? 2 * kTile * ld : 0);    // [Rp][ld]
  float* s_s = reinterpret_cast<float*>(q_s + Rp * ld);  // [Rp][kSld]
  bf16* p_s = reinterpret_cast<bf16*>(s_s);            // [Rp][kPld], over s_s
  long long* off_s = reinterpret_cast<long long*>(s_s + Rp * kSld);  // [kSplit]
  float2* sc_s = reinterpret_cast<float2*>(off_s + kSplit);  // [kSplit] (K, V) scales
  float* m_s = reinterpret_cast<float*>(sc_s + (kQuant ? kSplit : 0));  // [Rp]
  float* l_s = m_s + Rp;                               // [Rp]
  float* c_s = l_s + Rp;                               // [Rp] this tile's correction
  int* lim_s = reinterpret_cast<int*>(c_s + Rp);       // [Rp] positions a row attends

  // where this thread's position of the split lies (-1: at or past the
  // row's length, never read): the paged form looks its block up in the
  // table row, whose entries past the length are never read; and the
  // positions each query row attends, below stop
  long long sb = -1;                                   // the position's (block, kv head)
  {
    const int pos = start + tid;
    long long off = -1;
    if (pos < stop) {
      if constexpr (kPaged) {
        const int j = pos / a.blk;
        sb = (long long)a.tables[(size_t)b * a.M + j] * a.Hkv + x;
        off = (sb * a.blk + (pos - j * a.blk)) * hd;
      } else {
        off = (((long long)b * a.Hkv + x) * T + pos) * hd;
      }
    }
    off_s[tid] = off;
  }
  for (int r = tid; r < Rp; r += kThreads)
    lim_s[r] = r < R ? min(len - (a.G - 1) + r / rep, stop) : -1;
  __syncthreads();

  // each thread copies the same (row, 16-byte column) slots of every tile
  constexpr int kVec = 16 / (int)sizeof(P);            // elements a 16-byte copy moves
  const int vpr = hd / kVec;                           // 16-byte vectors a row
  // (threads past the last whole row of slots idle when vpr does not
  // divide kThreads)
  const int row_step = kThreads / vpr;
  const int row0 = tid < row_step * vpr ? tid / vpr : kTile, c = tid % vpr;
  auto stage = [&](int t) {
    P* ks = ring + (t % kStages) * 2 * kTile * rld;
    P* vs = ks + kTile * rld;
    for (int row = row0; row < kTile; row += row_step) {
      const long long off = off_s[t * kTile + row];
      const size_t src = off < 0 ? 0 : (size_t)off + c * kVec;
      cp_async16(ks + row * rld + c * kVec, kp + src, off >= 0);
      cp_async16(vs + row * rld + c * kVec, vp + src, off >= 0);
    }
  };
  // quantized: each thread dequantizes the same (row, 8-byte piece) slots
  // of every tile, K (v false) or V of tile t
  const int cpr = hd / 8, dstep = kThreads / cpr;
  const int drow0 = tid < dstep * cpr ? tid / cpr : kTile, dc = tid % cpr;
  auto dequant = [&](int t, bool v) {
    if constexpr (kQuant) {
      const P* src = ring + (t % kStages) * 2 * kTile * rld + (v ? kTile * rld : 0);
      dequant_tile(src, sc_s + t * kTile, v, v ? vq_s : kq_s, hd, ld, drow0, dstep, dc);
    }
  };

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  const int d0 = warp * 16;                            // this warp's slice of head_dim

  // the queries ride with tile 0's copies: folded row r = g * rep + i is
  // query g of head x * rep + i; rows past R are zero (their columns are
  // computed and never written)
  const int qvpr = hd / 8;
  for (int e = tid; e < Rp * qvpr; e += kThreads) {
    const int r = e / qvpr, cq = e - r * qvpr;
    size_t off = 0;
    if (r < R) {
      const int g = r / rep, i = r - g * rep;
      off = ((size_t)(b * a.G + g) * a.H + x * rep + i) * hd + cq * 8;
    }
    cp_async16(q_s + r * ld + cq * 8, a.q + off, r < R);
  }
  // the ring's first tiles: all its stages when quantized (a stage frees
  // once its V is dequantized, before the softmax), else all but one
  constexpr int kAhead = kQuant ? kStages : kStages - 1;
#pragma unroll
  for (int t = 0; t < kAhead; ++t) {
    if (t < n_tiles) stage(t);
    cp_commit();
  }
  if constexpr (kQuant) {
    // the position's two scales, one load each per position, read while
    // the first tiles are in flight (the first barrier below orders them);
    // past the length 0, a finite scale for the zero-filled payload, so
    // no block past the length is read
    float2 sc = make_float2(0.f, 0.f);
    if (sb >= 0) sc = make_float2(a.k_scale[sb], a.v_scale[sb]);
    sc_s[tid] = sc;
  }
  for (int r = tid; r < Rp; r += kThreads) {
    m_s[r] = kNeg;
    l_s[r] = 0.f;
    c_s[r] = 1.f;
  }
  if constexpr (kQuant) {
    if (n_tiles > 0) {
      cp_wait<kAhead - 1>();
      __syncthreads();  // tile 0 and the scales landed
      dequant(0, false);
    }
  }
  for (int t = 0; t < n_tiles; ++t) {
    const bf16* ks;
    const bf16* vs;
    if constexpr (kQuant) {
      // K(t), dequantized beside P.V of tile t - 1, is complete; that P.V
      // is done with V's tile; tile t's bytes landed before it
      __syncthreads();
      ks = kq_s;
      vs = vq_s;
    } else {
      cp_wait<kStages - 2>();
      __syncthreads();  // tile t landed for every thread; tile t - 1's readers are done
      if (t + kStages - 1 < n_tiles) stage(t + kStages - 1);
      cp_commit();
      ks = ring + (t % kStages) * 2 * kTile * rld;
      vs = ks + kTile * ld;
    }
    const int p0 = start + t * kTile;

    // scores S^T = K Q^T: warp w takes positions 16 (w % 4) .. + 16 and the
    // n8 tiles nt = w / 4, w / 4 + 2, ..., four at a time
    {
      const int prow = (warp & 3) * 16, nh = warp >> 2;
      const bf16* a_ptr = ks + (prow + r8 + 8 * (mi & 1)) * ld + 8 * (mi >> 1);
      constexpr int NJ = (NT + 1) / 2;
#pragma unroll
      for (int jc = 0; jc < NJ; jc += 4) {
        // two chains of k-steps (even, odd), summed at the end: the same
        // arithmetic for every NT
        float sc[2][4][4] = {};
#pragma unroll
        for (int kk = 0; kk < kMaxHd; kk += 16) {
          if (kk < hd) {
            uint32_t af[4];
            ldsm_x4(af, a_ptr + kk);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int nt = nh + 2 * (jc + u);
              if (jc + u < NJ && nt < NT) {
                uint32_t bq[2];
                ldsm_x2(bq, q_s + (nt * 8 + r8) * ld + kk + 8 * (mi & 1));
                mma_bf16(sc[(kk / 16) & 1][u], af, bq);
              }
            }
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int nt = nh + 2 * (jc + u);
          if (jc + u < NJ && nt < NT) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int r = nt * 8 + 2 * (lane & 3) + e;
              const int lim = lim_s[r];
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int row = prow + (lane >> 2) + 8 * h;
                const float dot = sc[0][u][2 * h + e] + sc[1][u][2 * h + e];
                s_s[r * kSld + row] = p0 + row < lim ? dot * a.scale : kNeg;
              }
            }
          }
        }
      }
    }
    if constexpr (kQuant) dequant(t, true);
    __syncthreads();
    if constexpr (kQuant) {
      // tile t's stage is read: the ring's next tile takes it
      if (t + kStages < n_tiles) stage(t + kStages);
      cp_commit();
    }

    // online softmax of the tile: 8 lanes a query row, four rows a warp;
    // every padded row too, whose p is 0. A row's p overwrites its scores
    // once its lanes hold them (the max's shuffles order the two).
    {
      const int grp = lane >> 3, li = lane & 7;
      for (int r0 = warp * 4; r0 < Rp; r0 += kWarps * 4) {
        const int r = r0 + grp;
        const float* sr = s_s + r * kSld;
        float sv[kTile / 8];
        float mx = kNeg;
#pragma unroll
        for (int u = 0; u < kTile / 8; ++u) {
          sv[u] = sr[li + 8 * u];
          mx = fmaxf(mx, sv[u]);
        }
#pragma unroll
        for (int o = 1; o < 8; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_prev = m_s[r];
        const float m_new = fmaxf(m_prev, mx);
        const int lim = lim_s[r];                      // -1 past R: p = 0
        float sum = 0.f;
#pragma unroll
        for (int u = 0; u < kTile / 8; ++u) {
          const int pos = p0 + li + 8 * u;
          const float p = pos < lim ? expf(sv[u] - m_new) : 0.f;
          sum += p;
          // P.V takes p in bf16, as the TPU kernel does
          p_s[r * kPld + li + 8 * u] = __float2bfloat16(p);
        }
#pragma unroll
        for (int o = 1; o < 8; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (li == 0 && r < R) {
          const float corr = expf(m_prev - m_new);
          c_s[r] = corr;
          l_s[r] = l_s[r] * corr + sum;
          m_s[r] = m_new;
        }
      }
    }
    // quantized: tile t + 1 landed for every thread (its K is dequantized
    // after P.V)
    if constexpr (kQuant) cp_wait<kAhead - 1>();
    __syncthreads();

    // out^T = acc^T * corr + V^T P^T over this warp's 16 of head_dim
    if (d0 < hd) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int r = nt * 8 + 2 * (lane & 3);
        const float c0 = c_s[r], c1 = c_s[r + 1];
        acc[nt][0] *= c0;
        acc[nt][1] *= c1;
        acc[nt][2] *= c0;
        acc[nt][3] *= c1;
      }
#pragma unroll
      for (int kk = 0; kk < kTile; kk += 16) {
        uint32_t af[4];
        ldsm_x4_t(af, vs + (kk + r8 + 8 * (mi >> 1)) * ld + d0 + 8 * (mi & 1));
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          uint32_t bp[2];
          ldsm_x2(bp, p_s + (nt * 8 + r8) * kPld + kk + 8 * (mi & 1));
          mma_bf16(acc[nt], af, bp);
        }
      }
    }
    // quantized: the next tile's K (the scores of tile t are done with K)
    if constexpr (kQuant)
      if (t + 1 < n_tiles) dequant(t + 1, false);
  }
  cp_wait<0>();
  __syncthreads();  // m_s and l_s as the last tile left them (or as set up)

  // a row of one split writes its output; a longer row's splits write
  // partials for tc::decode_merge_kernel
  const size_t stride = (size_t)R * (hd + 2);
  float* part = a.ws + (((size_t)b * a.Hkv + x) * gridDim.x + s) * stride;
  if (d0 < hd) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = nt * 8 + 2 * (lane & 3) + e, d = d0 + (lane >> 2) + 8 * h;
          if (r >= R) continue;
          if (n_split == 1) {
            const int g = r / rep, i = r - g * rep;
            a.out[((size_t)(b * a.G + g) * a.H + x * rep + i) * hd + d] =
                __float2bfloat16(acc[nt][2 * h + e] / fmaxf(l_s[r], 1e-30f));
          } else {
            part[(size_t)r * hd + d] = acc[nt][2 * h + e];
          }
        }
  }
  if (n_split > 1)
    for (int r = tid; r < R; r += kThreads) {
      part[(size_t)R * hd + 2 * r] = m_s[r];
      part[(size_t)R * hd + 2 * r + 1] = l_s[r];
    }
}

// Kernel 8: paged pools through the block table.
template <int NT>
__global__ void __launch_bounds__(kThreads, min_ctas(NT)) paged_decode_kernel(Args a) {
  split_cta<NT, true, bf16>(a);
}

// Kernel 9: quantized paged pools (P int8 or fp8 e4m3), bf16 queries.
template <int NT, typename P>
__global__ void __launch_bounds__(kThreads, min_ctas(NT)) paged_quant_decode_kernel(Args a) {
  split_cta<NT, true, P>(a);
}

// Kernel 7: a contiguous cache [B, Hkv, M * blk, hd].
template <int NT>
__global__ void __launch_bounds__(kThreads, min_ctas(NT)) decode_kernel(Args a) {
  split_cta<NT, false, bf16>(a);
}

// Combine a row's splits, in the order of s; rows of one split were
// written by their CTA. Grid (ceil(R * hd / kThreads), Hkv, B): one
// thread a (query row, dim), so the loads over the splits of different
// outputs run side by side.
__global__ void __launch_bounds__(kThreads) decode_merge_kernel(Args a, int n_grid) {
  const int x = blockIdx.y, b = blockIdx.z;
  const int end = min(a.lengths[b], a.M * a.blk);
  const int n = max(1, (end + kSplit - 1) / kSplit);
  const int hd = a.hd, rep = a.H / a.Hkv, R = a.G * rep;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (n == 1 || e >= R * hd) return;
  // launched early (programmatic dependent launch): the split kernel's
  // partials are complete and visible past this point
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int r = e / hd, d = e - r * hd;
  const size_t stride = (size_t)R * (hd + 2);
  const float* base = a.ws + ((size_t)b * a.Hkv + x) * n_grid * stride;
  const float* ml = base + (size_t)R * hd + 2 * r;
  float mx = kNeg;
#pragma unroll 4
  for (int s = 0; s < n; ++s) mx = fmaxf(mx, ml[s * stride]);
  float num = 0.f, den = 0.f;
#pragma unroll 4
  for (int s = 0; s < n; ++s) {
    // a split whose positions are all masked for this row (m = kNeg,
    // l = 0, acc = 0) weighs e^(kNeg - mx) = 0, or 1 if all are
    const float w = expf(ml[s * stride] - mx);
    num += w * base[s * stride + e];
    den += w * ml[s * stride + 1];
  }
  const int g = r / rep, i = r - g * rep;
  a.out[((size_t)(b * a.G + g) * a.H + x * rep + i) * hd + d] =
      __float2bfloat16(num / fmaxf(den, 1e-30f));
}

// Splits a row of the grid: ceil(M * blk / kSplit).
__host__ __device__ constexpr int splits(int M, int blk) {
  return (M * blk + kSplit - 1) / kSplit;
}

template <int NT, bool kPaged, typename P>
int launch_nt(const Args& a, int B, cudaStream_t stream) {
  constexpr bool kQuant = !std::is_same<P, bf16>::value;
  void (*kernel)(Args);
  if constexpr (kQuant)
    kernel = paged_quant_decode_kernel<NT, P>;
  else
    kernel = kPaged ? paged_decode_kernel<NT> : decode_kernel<NT>;
  const int smem = smem_bytes(a.hd, NT, kQuant);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(splits(a.M, a.blk), a.Hkv, B), kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The split kernel at the smallest NT that holds R rows, then the merge
// when a row may take more than one split.
template <bool kPaged, typename P>
int launch(const Args& a, int B, cudaStream_t stream) {
  const int R = a.G * (a.H / a.Hkv);
  const int err = R <= 8    ? launch_nt<1, kPaged, P>(a, B, stream)
                  : R <= 32 ? launch_nt<4, kPaged, P>(a, B, stream)
                  : R <= 64 ? launch_nt<8, kPaged, P>(a, B, stream)
                            : launch_nt<16, kPaged, P>(a, B, stream);
  if (err != 0) return err;
  const int n_grid = splits(a.M, a.blk);
  if (n_grid > 1) {
    // programmatic dependent launch: the merge's launch overlaps the split
    // kernel's last CTAs, and griddepcontrol.wait orders its reads
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((R * a.hd + kThreads - 1) / kThreads, a.Hkv, B);
    cfg.blockDim = dim3(kThreads);
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return (int)cudaLaunchKernelEx(&cfg, decode_merge_kernel, a, n_grid);
  }
  return 0;
}

}  // namespace tc

}  // namespace

// Plain C entry points (bound with ctypes). dtype: 0 = float32, 1 = bfloat16
// (q, out and the unquantized pools). Each returns the cudaError_t of the
// launch (0 = launched).

// Which design runs (quant: 0 = unquantized pools, 1 = int8 / fp8 pools,
// which take the same limits; R = G * rep query rows a kv head): 1 the bf16
// tensor-core instance, 0 the scalar body (float32 queries, and bf16 past
// head_dim 128 or 128 query rows), -1 no instance (an unknown dtype). The
// entry points below dispatch through it.
extern "C" int decode_route(int quant, int dtype, int hd, int R) {
  (void)quant;
  if (dtype != 0 && dtype != 1) return -1;
  if (dtype == 0) return 0;
  return hd % 16 == 0 && hd >= 16 && hd <= tc::kMaxHd && R >= 1 && R <= tc::kMaxRows ? 1
                                                                                      : 0;
}

// Positions a split of the tensor-core instance covers (the wrapper sizes
// the workspace with it).
extern "C" int decode_split_positions() { return tc::kSplit; }

// workspace: float32 [B, Hkv, ceil(M * blk / 256), R * (hd + 2)] when the
// tensor-core instance runs and a row may take more than one split, else
// unused (null). chunk and smem_bytes size the scalar body.
extern "C" int paged_decode_attention(
    const void* q, const void* k, const void* v, const void* lengths,
    const void* tables, void* out, void* workspace, int B, int G, int H, int Hkv,
    int hd, int blk, int M, int chunk, float scale, int smem_bytes, int dtype,
    void* stream) {
  const int* len_p = static_cast<const int*>(lengths);
  const int* tbl_p = static_cast<const int*>(tables);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (decode_route(0, dtype, hd, G * (H / Hkv)) == 1) {
    const tc::Args a{static_cast<const tc::bf16*>(q), k, v, nullptr, nullptr, len_p, tbl_p,
                     static_cast<tc::bf16*>(out), static_cast<float*>(workspace),
                     G, H, Hkv, hd, blk, M, scale};
    return tc::launch<true, tc::bf16>(a, B, s);
  }
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, nullptr, nullptr, len_p, tbl_p, out, B, G, H, Hkv, hd, blk, M,
        chunk, scale, smem_bytes, s);
  return launch<float, float>(q, k, v, nullptr, nullptr, len_p, tbl_p, out, B,
                              G, H, Hkv, hd, blk, M, chunk, scale, smem_bytes, s);
}

// Quantized pools: payload 0 = int8, 1 = fp8 e4m3; k_scale/v_scale
// [P, Hkv] float32; workspace as for the unquantized form (the bf16
// tensor-core instance, tc::paged_quant_decode_kernel, takes kernel 8's
// split and merge).
extern "C" int paged_decode_attention_quant(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* lengths, const void* tables, void* out,
    void* workspace, int B, int G, int H, int Hkv, int hd, int blk, int M, int chunk,
    float scale, int smem_bytes, int dtype, int payload, void* stream) {
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* len_p = static_cast<const int*>(lengths);
  const int* tbl_p = static_cast<const int*>(tables);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (decode_route(1, dtype, hd, G * (H / Hkv)) == 1) {
    const tc::Args a{static_cast<const tc::bf16*>(q), k, v, ks, vs, len_p, tbl_p,
                     static_cast<tc::bf16*>(out), static_cast<float*>(workspace),
                     G, H, Hkv, hd, blk, M, scale};
    return payload == 1 ? tc::launch<true, __nv_fp8_e4m3>(a, B, s)
                        : tc::launch<true, int8_t>(a, B, s);
  }
  if (dtype == 1)
    return launch_quant<__nv_bfloat16>(q, k, v, ks, vs, len_p, tbl_p, out, B, G,
                                       H, Hkv, hd, blk, M, chunk, scale,
                                       smem_bytes, payload, s);
  return launch_quant<float>(q, k, v, ks, vs, len_p, tbl_p, out, B, G, H, Hkv,
                             hd, blk, M, chunk, scale, smem_bytes, payload, s);
}

// Contiguous caches k/v [B, Hkv, M * blk, hd] in q's dtype; workspace as
// for the paged form.
extern "C" int decode_attention_contiguous(
    const void* q, const void* k, const void* v, const void* lengths, void* out,
    void* workspace, int B, int G, int H, int Hkv, int hd, int blk, int M, int chunk,
    float scale, int smem_bytes, int dtype, void* stream) {
  const int* len_p = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (decode_route(0, dtype, hd, G * (H / Hkv)) == 1) {
    const tc::Args a{static_cast<const tc::bf16*>(q), k, v, nullptr, nullptr, len_p,
                     nullptr, static_cast<tc::bf16*>(out), static_cast<float*>(workspace),
                     G, H, Hkv, hd, blk, M, scale};
    return tc::launch<false, tc::bf16>(a, B, s);
  }
  if (dtype == 1)
    return launch_contiguous<__nv_bfloat16>(q, k, v, len_p, out, B, G, H, Hkv, hd,
                                            blk, M, chunk, scale, smem_bytes, s);
  return launch_contiguous<float>(q, k, v, len_p, out, B, G, H, Hkv, hd, blk, M,
                                  chunk, scale, smem_bytes, s);
}
