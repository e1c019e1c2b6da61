// Hopper (sm_90a) building blocks for the port's warp-specialised kernels:
// mbarriers, TMA tile copies, wgmma shared-memory descriptors and
// instructions, setmaxnreg, and the host-side encoding of TMA descriptors.
//
// Shared-memory tiles are written by TMA with a swizzle whose span equals
// the tile's row width in bytes (32, 64 or 128: 16, 32 or 64 bf16), so an
// 8-row group is one swizzle atom of 8 * span bytes and every tile starts
// on a 1024-byte boundary. The same tile serves wgmma as a K-major operand
// (rows are M or N, the 16-byte chunks are K: a k16 step advances the start
// address by 32 bytes inside the atom) or as an MN-major B operand (rows
// are K, the span is N: a k16 step advances by 16 rows, the transpose bit
// set). In both cases the descriptor's stride byte offset is the atom size
// and the leading byte offset is unused, since a tile is one span wide.
//
// wgmma accumulator of m64nNk16 (fp32), thread lane = 4 * g + t of warp w in
// the warpgroup: d[4j + 2h + e] holds row 16w + g + 8h, column 8j + 2t + e.
// The register A operand of m64n*k16 has the mma.sync m16n8k16 layout per
// warp: {a0, a1} (g, 2t..), {a2, a3} (g + 8, 2t..), {a4, a5} (g, 2t + 8..),
// {a6, a7} (g + 8, 2t + 8..), two bf16 per 32-bit register.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the driver function is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

namespace padt {
namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// arrive, and expect `bytes` more of transactions (TMA) before the phase ends
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed: a fresh barrier is
// in phase 0, so parity 1 passes at once (the "previous" phase). A phase that
// never completes (a protocol fault) traps after 2^24 polls, seconds, rather
// than hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (n == (1u << 24)) __trap();
  }
}

// --------------------------------------------------------------------- TMA

// coordinates innermost first; elements outside the tensor read as 0 and
// still count toward the barrier's transaction bytes
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// fetches a TMA descriptor (in kernel parameter space) into the cache ahead of its first use
__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// the same over a 3D view
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// elements outside the tensor are not written
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0, int c1, int c2,
                                             int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.tile.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }

// wait until every committed store has read its shared memory
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// orders this thread's generic shared-memory writes before later async-proxy
// (TMA store, wgmma) reads of them
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// barrier `id` (1..15) over `threads` threads, a multiple of 32
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// --------------------------------------------------------------- registers

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ------------------------------------------------------------------- wgmma

// the shared-memory descriptor of a tile with rows of SPAN bytes (32, 64 or
// 128), written by TMA with the swizzle of the same span, at shared address a
template <int SPAN>
__device__ __forceinline__ uint64_t smem_desc_at(uint32_t a) {
  static_assert(SPAN == 32 || SPAN == 64 || SPAN == 128, "swizzle span");
  constexpr uint64_t layout = SPAN == 128 ? 1 : SPAN == 64 ? 2 : 3;
  constexpr uint64_t atom = 8 * SPAN;  // bytes of one 8-row group
  return (uint64_t)((a & 0x3FFFF) >> 4) | (uint64_t)1 << 16 | (atom >> 4) << 32 | layout << 62;
}

template <int SPAN>
__device__ __forceinline__ uint64_t smem_desc(const void* tile) {
  return smem_desc_at<SPAN>(smem_u32(tile));
}

// smem_desc of a tile that a loop reads on every pass, computed where it is
// used (the empty asm keeps the compiler from hoisting it and its k-step
// copies out of the loop), for kernels whose accumulators leave few
// registers for values held across the loop
template <int SPAN>
__device__ __forceinline__ uint64_t smem_desc_here(const void* tile) {
  uint32_t a = smem_u32(tile);
  asm volatile("" : "+r"(a));
  return smem_desc_at<SPAN>(a);
}

// the descriptor `bytes` further on (a multiple of 16)
__device__ __forceinline__ uint64_t desc_advance(uint64_t desc, uint32_t bytes) { return desc + (bytes >> 4); }

// the byte offset, from a 1024-byte-aligned tile of rows of SPAN bytes, at
// which TMA's swizzle stores byte `off` of the row-major tile
template <int SPAN>
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  constexpr uint32_t mask = (SPAN / 16 - 1) << 4;
  return off ^ ((off >> 3) & mask);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads of an accumulator above the wait that
// completes it (the asm that writes it returns before the hardware does),
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// ... and the writes of registers that a wgmma reads below the wgmma fence
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D (64 x 16) += A (64 x 16, registers) * B (16 x 16, smem)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TRANS_B));
}

// D (64 x 32) += A (64 x 16, registers) * B (16 x 32, smem)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TRANS_B));
}

// D (64 x 64) += A (64 x 16, registers) * B (16 x 64, smem)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TRANS_B));
}

// D (64 x 128) {+}= A (64 x 16, smem) * B (16 x 128, smem)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_B));
}

// D (64 x 32) {+}= A (64 x 16, smem) * B (16 x 32, smem), both K-major
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64) {+}= A (64 x 16, smem) * B (16 x 64, smem), both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// RS m64nNk16 by N, for a kernel templated on a tile width
template <int N, int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  static_assert(N == 16 || N == 32 || N == 64, "wgmma N");
  if constexpr (N == 16) wgmma_rs_n16<TRANS_B>(d, a, db);
  else if constexpr (N == 32) wgmma_rs_n32<TRANS_B>(d, a, db);
  else wgmma_rs_n64<TRANS_B>(d, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------------------------ host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, fetched through the runtime so
// that the library needs no -lcuda; null if the driver lacks it
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t rc = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return rc == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

// A TMA descriptor over a 4D bf16 view {d0, d1, d2, d3} (innermost first,
// unit stride in d0; s1..s3 the element strides of d1..d3, multiples of 8)
// with a box {box0, 1, box2, 1} stored with the swizzle of box0 * 2 bytes
// (32, 64 or 128). Returns a CUDA error code (0 on success).
inline int encode_bf16_4d(CUtensorMap* map, const void* base, long long d0, long long d1, long long d2,
                          long long d3, long long s1, long long s2, long long s3, int box0, int box2) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const int span = box0 * 2;
  if (span != 32 && span != 64 && span != 128) return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[4] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2, (cuuint64_t)d3};
  const cuuint64_t strides[3] = {(cuuint64_t)s1 * 2, (cuuint64_t)s2 * 2, (cuuint64_t)s3 * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box0, 1, (cuuint32_t)box2, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw = span == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                : span == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                             : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// A TMA descriptor over a view of up to 3 dimensions {d0, d1, d2}
// (innermost first, unit stride in d0; s1, s2 the byte strides of d1, d2,
// multiples of 16) of elements of `elem` bytes (2: bf16, 1: uint8), with a
// box {box0, box1, box2}, stored with the swizzle of `swizzle` bytes (0 for
// none, else 32, 64 or 128 = box0 * elem). Encodings are cached by all of
// these values: an entry is a pure function of its key, so a hit is always
// the descriptor a fresh encoding would give. Returns a CUDA error code (0
// on success).
inline int encode_cached(CUtensorMap* map, int elem, const void* base, long long d0, long long d1, long long d2,
                         long long s1, long long s2, int box0, int box1, int box2, int swizzle) {
  struct Key {
    const void* base;
    long long v[5];
    int b[5];
  };
  struct Entry {
    Key key;
    CUtensorMap map;
    bool used;
  };
  constexpr int kSlots = 256;  // direct-mapped
  static Entry cache[kSlots];
  static std::mutex mu;
  Key key;
  memset(&key, 0, sizeof(key));  // the padding too: keys compare as bytes
  key.base = base;
  key.v[0] = d0, key.v[1] = d1, key.v[2] = d2, key.v[3] = s1, key.v[4] = s2;
  key.b[0] = elem, key.b[1] = box0, key.b[2] = box1, key.b[3] = box2, key.b[4] = swizzle;
  uint64_t h = 1469598103934665603ull;  // FNV-1a over the key's bytes
  for (size_t i = 0; i < sizeof(key); ++i) h = (h ^ reinterpret_cast<const uint8_t*>(&key)[i]) * 1099511628211ull;
  Entry& e = cache[h % kSlots];
  std::lock_guard<std::mutex> lock(mu);
  if (e.used && memcmp(&e.key, &key, sizeof(key)) == 0) {
    *map = e.map;
    return 0;
  }
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  if ((elem != 1 && elem != 2) || (swizzle != 0 && swizzle != box0 * elem)) return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)s1, (cuuint64_t)s2};
  const cuuint32_t box[3] = {(cuuint32_t)box0, (cuuint32_t)box1, (cuuint32_t)box2};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle sw = swizzle == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                : swizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                : swizzle == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                                                : CU_TENSOR_MAP_SWIZZLE_NONE;
  const CUresult r = fn(map, elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
                        const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  e.key = key;
  e.map = *map;
  e.used = true;
  return 0;
}

}  // namespace hopper
}  // namespace padt
