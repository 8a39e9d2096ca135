// Hopper (sm_90a) building blocks shared by the tensor-core kernels of
// flash_attention.cu, grouped_mm.cu, fused_ce.cu and quant_mm.cu: mbarriers, TMA loads,
// shared-memory matrix descriptors and the wgmma forms they use, the
// persistent 128 x 256 tile GEMM's ring and main loop (pgemm), and the
// host-side lookup of cuTensorMapEncodeTiled. Each .cu file includes it
// and compiles on its own (ops/_build.py hashes this header with every
// source).
//
// Conventions. Tiles live in shared memory in 128-byte swizzle: rows of 64
// bf16 (kHalf), a wider tile stored as 64-column halves one after the
// other, every tile 1024-byte aligned. TMA writes them in that layout
// (CU_TENSOR_MAP_SWIZZLE_128B, boxes 64 columns wide) and wgmma reads them
// through desc().

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {
namespace tc {

constexpr int kHalf = 64;          // bf16 columns in one 128-byte swizzled row

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers and TMA

__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool bar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the phase of the given parity to complete. A barrier that stays
// open for 2^32 cycles (about 2 s; a tile takes microseconds) traps, so a
// load that never lands is a launch error and not a hung card.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  if (bar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!bar_try(bar, parity))
    if (clock64() - t0 > (1ll << 32)) __trap();
}

// shared-memory writes of this thread visible to the async proxy (TMA)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier inits visible to the async proxy (TMA) before any load uses them
__device__ __forceinline__ void init_done() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  fence_async_smem();
}

// One box of a tensor map at the given coordinates (innermost first) into
// dst, completing on bar. Elements outside the tensor arrive as zeros and
// count toward the box's bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap& map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap& map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap& map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A box of shared memory at src to a tensor map's coordinates, as one bulk
// async group of the issuing thread; elements outside the tensor are not
// written.
__device__ __forceinline__ void tma_store(const CUtensorMap& map, uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(&map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until this thread's bulk groups have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// wait until this thread's bulk groups are complete
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// the pair (a, b) to p where pred holds, as one predicated store: a
// kernel reads its wgmma accumulators on the path every thread takes (see
// pgemm::mainloop), so its epilogue predicates stores instead of branching
__device__ __forceinline__ void st_pair_if(bool pred, float* p, float a, float b) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %0, 0;\n@q st.global.v2.f32 [%1], {%2, %3};\n}\n" ::"r"(
          (int)pred),
      "l"(p), "f"(a), "f"(b)
      : "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// barrier `id` (1..15; 0 is __syncthreads') over `count` threads
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// --- warpgroup MMA

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups are still in flight
template <int N = 0>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of wgmma registers across
// the fence / wait that brackets the asynchronous product
template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void hold(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled operand: start
// address, leading byte offset (MN-major: the distance between 64-column
// halves; K-major: unused), stride byte offset 1024 (8 rows of 128 bytes),
// layout 128B swizzle. Within a swizzled row a k-step of 16 moves the
// start by 32 bytes (K-major); MN-major, it moves 16 rows (2048 bytes).
// The tiles are 1024-byte aligned, so the base offset is 0.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// wgmma.mma_async m64nNk16, float32 += bf16 x bf16. ss: A and B from
// shared memory, each K-major (TA, TB 0) or MN-major (1). rs: A
// from registers (the m64k16 fragment), B from shared memory MN-major
// (TB 1) or K-major (0). acc = 0 overwrites d.
// Accumulator layout (thread t of the warpgroup, warp w = t / 32, lane l):
// d[i] is row 16 w + l / 4 + 8 ((i >> 1) & 1), column 8 (i >> 2) +
// 2 (l % 4) + (i & 1); the A fragment of k-step kk is the same layout's
// d[8 kk .. 8 kk + 7] packed in pairs.
template <int TB, int TA = 0>
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %36, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc), "n"(TB), "n"(TA));
}

template <int TB, int TA = 0>
__device__ __forceinline__ void mma_ss_n128(float (&d)[64], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %68, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc), "n"(TB), "n"(TA));
}

template <int TB = 1>
__device__ __forceinline__ void mma_rs_n64(float (&d)[32], const uint32_t* a, uint64_t b,
                                           int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(TB));
}

template <int TB = 1>
__device__ __forceinline__ void mma_rs_n128(float (&d)[64], const uint32_t* a, uint64_t b,
                                            int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(TB));
}

template <int N, int TB = 0, int TA = 0>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int acc) {
  if constexpr (N == 64) mma_ss_n64<TB, TA>(d, a, b, acc);
  else mma_ss_n128<TB, TA>(d, a, b, acc);
}

template <int N, int TB = 1>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t* a, uint64_t b, int acc) {
  if constexpr (N == 64) mma_rs_n64<TB>(d, a, b, acc);
  else mma_rs_n128<TB>(d, a, b, acc);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// an accumulator as A fragments, rounded to bf16
template <int N>
__device__ __forceinline__ void to_a(const float (&d)[N], uint32_t (&a)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) a[i] = pack_bf16(d[2 * i], d[2 * i + 1]);
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// --- the persistent 128 x 256 tile GEMM (grouped_mm.cu's three kernels,
// fused_ce.cu's backward). A persistent grid, one CTA of 288 threads per
// SM, walks 128 x 256 output tiles. Warpgroups 0 and 1 own 64 output rows
// each; warp 8 produces: one thread keeps a ring of TMA loads in flight
// across tiles, each stage a 64-deep slice of both operands in 128-byte
// swizzle, A 128 x 64 (16 KB) and B 64 x 256 (32 KB). Per slice each
// consumer issues 4 x 2 wgmma m64n128k16 (A and B from shared memory),
// keeps one slice's products in flight and releases the stage before it.
namespace pgemm {

constexpr int kThreads = 288;     // warpgroups 0 and 1 consume, warp 8 produces
constexpr int kConsumers = 256;
constexpr int kRows = 128;        // output rows of a tile, 64 per consumer warpgroup
constexpr int kCols = 256;        // output columns of a tile
constexpr int kDepth = 64;        // contraction depth of a stage: one swizzled row
constexpr int kBox = 64 * 128;    // one [64][64] bf16 box in 128B swizzle, bytes
constexpr int kABytes = 2 * kBox; // A slice: 128 x 64
constexpr int kBBytes = kCols / kHalf * kBox;  // B slice: 64 x 256

// The ring of kS stages: full[s] completes when stage s's loads land, empty[s]
// when the 256 consumer threads have released it. Slice `it` (counted over
// all tiles) uses stage it % kS in phase it / kS.
template <int kS>
struct Ring {
  uint32_t full, empty;

  __device__ __forceinline__ void init() const {
    for (int s = 0; s < kS; ++s) {
      bar_init(full + 8 * s, 1);
      bar_init(empty + 8 * s, kConsumers);
    }
    init_done();
  }
  // producer: wait until slice it's stage is free, announce its bytes and
  // return the barrier its loads complete on
  __device__ __forceinline__ uint32_t acquire(int it, uint32_t bytes) const {
    const int s = it % kS;
    bar_wait(empty + 8 * s, ((it / kS) & 1) ^ 1);
    bar_expect(full + 8 * s, bytes);
    return full + 8 * s;
  }
  __device__ __forceinline__ void wait(int it) const {
    bar_wait(full + 8 * (it % kS), (it / kS) & 1);
  }
  __device__ __forceinline__ void release(int it) const { bar_arrive(empty + 8 * (it % kS)); }
};

// descriptor of k-step kk (16 deep) of a swizzled tile: K-major (T 0) moves
// 32 bytes along the rows, MN-major (T 1) 16 rows, its 64-wide halves kBox
// apart
template <int T>
__device__ __forceinline__ uint64_t step_desc(uint32_t addr, int kk) {
  return T ? desc(addr + kk * 16 * 128, kBox) : desc(addr + kk * 32, 16);
}

// acc += nk slices from slice it on (it advances past them): this
// warpgroup's A of stage 0 at a, B of stage 0 at b (stage s kABytes and
// kBBytes further); A and B K-major (0) or MN-major (1)
template <int kS, int TA, int TB>
__device__ __forceinline__ void mainloop(float (&acc)[kCols / 128][64], const Ring<kS>& ring,
                                         int& it, int nk, uint32_t a, uint32_t b) {
  for (int t = 0; t < nk; ++t, ++it) {
    const int s = it % kS;
    ring.wait(it);
#pragma unroll
    for (int j = 0; j < kCols / 128; ++j) hold(acc[j]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kDepth / 16; ++kk)
#pragma unroll
      for (int j = 0; j < kCols / 128; ++j)
        mma_ss<128, TB, TA>(acc[j], step_desc<TA>(a + s * kABytes, kk),
                            step_desc<TB>(b + s * kBBytes + j * 2 * kBox, kk), 1);
    wg_commit();
    wg_wait<1>();                                 // slice t - 1's products are done
#pragma unroll
    for (int j = 0; j < kCols / 128; ++j) hold(acc[j]);
    if (t > 0) ring.release(it - 1);
  }
  // outside any branch: nk may differ between tiles (gmm_dw), and ptxas
  // serializes every wgmma of a kernel that touches its accumulators on a
  // path it cannot prove uniform (C7518)
  wg_wait<0>();
#pragma unroll
  for (int j = 0; j < kCols / 128; ++j) hold(acc[j]);
  if (nk > 0) ring.release(it - 1);
}

}  // namespace pgemm

}  // namespace tc

// --- host: tensor maps

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query (so the library links no libcuda); null when libcuda lacks it
decltype(&cuTensorMapEncodeTiled) encoder() {
  static decltype(&cuTensorMapEncodeTiled) fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<decltype(&cuTensorMapEncodeTiled)>(p);
  }
  return fn;
}

constexpr int kNoEncoder = -2;   // libcuda has no cuTensorMapEncodeTiled
constexpr int kBadMap = -3;      // it refused a map (base or stride not 16-byte aligned)

// A bf16 tensor map of rank R: dims and element strides innermost first
// (the innermost of unit stride), boxes of box[] elements in 128-byte
// swizzle (box[0] = kHalf columns); elements outside the tensor read as
// zero. 0, kNoEncoder or kBadMap.
template <int R>
int encode_map(CUtensorMap* map, const void* ptr, const cuuint64_t (&dims)[R],
               const long long (&strides)[R - 1], const cuuint32_t (&box)[R]) {
  const auto enc = encoder();
  if (!enc) return kNoEncoder;
  cuuint64_t bytes[R - 1];
  cuuint32_t unit[R];
  for (int i = 0; i < R - 1; ++i) bytes[i] = (cuuint64_t)strides[i] * 2;
  for (int i = 0; i < R; ++i) unit[i] = 1;
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, R, const_cast<void*>(ptr), dims,
                         bytes, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kBadMap;
}

// the current device's SMs, after raising kernel's dynamic shared memory
// to smem bytes
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem, int* sms) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

}  // namespace
