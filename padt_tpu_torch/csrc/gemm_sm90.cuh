// The Hopper (sm_90a) GEMM mainloop that H10 (stream_matmul.cu) and H7
// (int8_matmul.cu) share: out (M, N) = x (M, K) @ W (K, N), x bf16 with
// strided rows (K-contiguous), W N-contiguous, bf16 (H10: one layer of an
// (L, K, N) stack) or int8 (H7: converted to bf16 in shared memory, exact
// for |q| <= 127), the sum in fp32, then the kernel's epilogue: H10
// bf16(bf16(sum) + bias[n]), H7 bf16(sum * s[n]).
//
// Bound on the H100: the weight stream at decode (M <= 128: K * N * 2 or
// K * N bytes per call against 3.35 TB/s), the tensor cores at prefill (H7
// at M = 2560: 2 * M * N * K operations against 989 TFLOP/s bf16). The
// design:
//   - a CTA of a producer warpgroup and one (decode) or two (prefill)
//     consumer warpgroups. Warp 0's lane 0 issues every TMA copy into a
//     ring of `stages` stages of 64 K rows (one x tile and one W tile each),
//     each with a full and an empty mbarrier. In H7, warps 1-3 are the
//     converter: they write each stage's int8 W tile once per CTA as a bf16
//     tile (a few such tiles, in turn), fence it to the async proxy and
//     arrive on its ready barrier, while the int8 stages keep the weight
//     stream in flight at half the bytes of bf16;
//   - swap-AB at decode (M <= 128): the CTA computes out^T = W^T x^T, so
//     that 64 columns of the weight's N fill wgmma's 64 rows (A: the W
//     tile read MN-major, the transpose bit) and the decode rows are
//     wgmma's n (B: the x tile, K-major), n = M rounded up to 8, 16, 32,
//     64, 96 or 128;
//   - the usual orientation at prefill (M > 128): 256 x 128 tiles, two
//     consumer warpgroups of two 64-row blocks each (A: the x tile, K-major)
//     against 128 columns (B: the W tile, MN-major, its two 64-column chunks
//     LBO apart), setmaxnreg 56 / 224 so that a consumer holds 128 fp32
//     accumulators. 256 rows a tile: each int8 W element H7 converts serves
//     as many rows, so that three converter warps keep up;
//   - split-K without a workspace: where the output tiles are too few for
//     the SMs, the K splits of one output tile are the CTAs of a
//     thread-block cluster (at most 8). Each stages its fp32 tile in its own
//     shared memory (over the ring), and after a cluster barrier each CTA
//     folds its share of the tile's rows over the cluster in rank order
//     (cluster_fold.cuh), applies the epilogue once and stores bf16: no
//     atomics, no second launch, reruns bit-identical. Without a split the
//     accumulators go straight to out;
//   - the wrapper's launch plan (ops/cuda_matmul.py `gemm_plan`) picks the
//     orientation, n, the splits and the stages; the kernel takes them as
//     they are and refuses what it was not built for.
// Tiles: every shared-memory tile is 64 bf16 (128 bytes) wide, written with
// the 128-byte swizzle, 1024-byte aligned (hopper.cuh). K, M and N tails
// read as zeros (TMA's out-of-bounds fill); the epilogue stores only rows
// < M and columns < N.
#pragma once

#include "cluster_fold.cuh"
#include "hopper.cuh"

namespace padt {
namespace gemm {

using namespace hopper;
namespace cg = cooperative_groups;

typedef __nv_bfloat16 bf16;

constexpr int BK = 64;                   // K rows per stage: one 128-byte span of bf16
constexpr int kMaxStages = 8;
constexpr int kMaxCluster = 8;           // the largest portable cluster
constexpr int kSmemLimit = 232448;       // dynamic shared memory a block may use
constexpr int kMaxTiles = 4;             // H7's bf16 W tiles
constexpr int kConverterThreads = 96;    // warps 1-3 of the producer warpgroup
constexpr int kProducerRegs = 56;        // prefill: setmaxnreg of the producer warpgroup
constexpr int kConsumerRegs = 224;       // ... and of the consumers: 128 * 56 + 256 * 224 <= 65536

// ------------------------------------------------------------------ wgmma
// D (64 x N) += A (64 x 16) * B (16 x N), both from shared memory; TA / TB
// the transpose bits (1: the operand's tile is MN-major)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_8(float (&d)[4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, %7, %8;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_16(float (&d)[8], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_32(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_96(float (&d)[48], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, %48, %49, p, 1, 1, %51, %52;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 8) wgmma_ss_8<TA, TB>(d, da, db);
  else if constexpr (N == 16) wgmma_ss_16<TA, TB>(d, da, db);
  else if constexpr (N == 32) wgmma_ss_32<TA, TB>(d, da, db);
  else if constexpr (N == 64) wgmma_ss_64<TA, TB>(d, da, db);
  else if constexpr (N == 96) wgmma_ss_96<TA, TB>(d, da, db);
  else if constexpr (N == 128) wgmma_ss_128<TA, TB>(d, da, db);
  else {
    static_assert(N == 256, "wgmma N");
    wgmma_ss_256<TA, TB>(d, da, db);
  }
}

// the descriptor of an MN-major tile made of 64-column chunks `lbo` bytes
// apart (the leading byte offset: the stride of the MN dimension's
// repeats; the stride byte offset is the 8-row atom, as in smem_desc_at)
__device__ __forceinline__ uint64_t desc_mn(uint32_t a, uint32_t lbo) {
  return (smem_desc_at<128>(a) & ~(0x3FFFull << 16)) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
}

// ----------------------------------------------------------------- layout

// One instance: W8 (int8 weight, H7) or bf16 (H10); SWAP (decode) or not;
// NT = wgmma's N.
template <bool W8, bool SWAP, int NT>
struct Layout {
  static constexpr int WGS = SWAP ? 1 : 2;  // consumer warpgroups
  static_assert(SWAP || NT == 128, "prefill: 256 x 128 tiles");
  static constexpr int THREADS = 128 * (1 + WGS);
  // prefill: two row blocks of 64 per consumer warpgroup (256 x 128 tiles),
  // so that each int8 W element H7 converts serves 256 rows and its
  // converter keeps up with the tensor cores
  static constexpr int RB = SWAP ? 1 : 2;
  static constexpr int TM = SWAP ? NT : 64 * WGS * RB;  // output rows (M) per CTA = x tile rows
  static constexpr int TN = SWAP ? 64 * WGS : NT;  // output columns (N) per CTA
  static constexpr int CHUNKS = TN / 64;           // 64-column chunks of the W tile
  static constexpr int X_BYTES = TM * 128;         // x tile: TM rows of 64 bf16
  static constexpr int WB_BYTES = CHUNKS * BK * 128;  // bf16 W tile: chunks of 64 rows of 64 bf16
  static constexpr int WQ_BYTES = TN * BK;            // int8 W tile as TMA lands it (row-major, no swizzle)
  static constexpr int STAGE = X_BYTES + (W8 ? WQ_BYTES : WB_BYTES);  // = TMA bytes per stage
  static constexpr int TILES = SWAP ? 4 : 2;          // H7: bf16 W tiles the converter writes in turn
  static constexpr int CONV = W8 ? TILES * WB_BYTES : 0;
  static constexpr int PITCH = TN + (SWAP ? 4 : 8);   // fp32 staging row (conflict-free stores)
  static constexpr int STAGING = TM * PITCH * 4;
  static constexpr int BARS = (2 * kMaxStages + 2 * kMaxTiles) * 8;  // full, empty; H7's ready, free
  static constexpr int COLS = 256 * 4;  // the tile's columns' scale (H7) or bias (H10), fp32
  // the threads that fold and store: all at decode, the consumers at prefill (the producers gave up registers)
  static constexpr int FOLD0 = SWAP ? 0 : 128;
  // decode: registers for two CTAs an SM
  static constexpr int MIN_BLOCKS = SWAP ? 2 : 1;
  __host__ __device__ static int ring(int stages) {  // the ring and the bf16 tiles, or the fp32 tile over them
    return stages * STAGE + CONV > STAGING ? stages * STAGE + CONV : STAGING;
  }
  __host__ __device__ static int smem(int stages) { return ring(stages) + BARS + COLS + 1024; }  // + alignment slack
};

struct Params {
  CUtensorMap x_map;  // x (M, K): box {64, TM}
  CUtensorMap w_map;  // H10: (L, K, N) box {64, 64, 1}; H7: (K, N) int8 box {TN, 64}
  const bf16* bias;   // H10: bias[li] (N,) or null
  const float* scale; // H7: s (N,)
  bf16* out;          // (M, N) contiguous
  int M, N, K, li, k_tiles, stages;
  int x_after;        // x is written by the grid launched just before (H10's fused norm): wait for it
};

struct Ring {
  uint8_t* base;
  uint8_t* conv;    // H7's bf16 W tiles
  uint64_t* full;   // [stages]: the producer's arrive + the TMA bytes
  uint64_t* empty;  // [stages]: one arrive per consumer warp
  uint64_t* ready;  // [TILES]: H7, a bf16 tile is written: one arrive per converter warp
  uint64_t* free;   // [TILES]: H7, a bf16 tile is read: one arrive per consumer warp
};

__device__ __forceinline__ float bf16_round(float v) { return __bfloat162float(__float2bfloat16(v)); }

// four int8 (one word) -> four bf16 (two words), exact: byte b biased to
// b ^ 0x80 = q + 128 is the low byte of the float 2^23 + q + 128 (one byte
// permute); less 2^23 + 128 (one float add) that is q, and its upper half is
// the bf16 of q (one permute per two values)
__device__ __forceinline__ uint2 i8x4_bf16x4(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
  return make_uint2(__byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632),
                    __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632));
}

// H7's converter: the stage's int8 W tile into a bf16 tile of 64-column
// chunks, swizzled as TMA would have written it
template <bool SWAP, int NT>
__device__ __forceinline__ void convert(const uint8_t* q, uint8_t* wb, int ctid) {
  using T = Layout<true, SWAP, NT>;
  constexpr int TN = T::TN, PER_ROW = TN / 16;
#pragma unroll 2
  for (int i = ctid; i < BK * PER_ROW; i += kConverterThreads) {
    const int k = i / PER_ROW, n = (i % PER_ROW) * 16;
    const uint4 v = *reinterpret_cast<const uint4*>(q + k * TN + n);
    const uint2 a = i8x4_bf16x4(v.x), b = i8x4_bf16x4(v.y), c = i8x4_bf16x4(v.z), d = i8x4_bf16x4(v.w);
    uint8_t* chunk = wb + (n / 64) * (BK * 128);
    const uint32_t off = k * 128 + (n % 64) * 2;
    *reinterpret_cast<uint4*>(chunk + swizzle<128>(off)) = make_uint4(a.x, a.y, b.x, b.y);
    *reinterpret_cast<uint4*>(chunk + swizzle<128>(off + 16)) = make_uint4(c.x, c.y, d.x, d.y);
  }
}

// Warp 0 (lane 0): the TMA copies of this CTA's k tiles [kt0, kt0 + n_kt).
// With x_after, the W tiles of the first round of stages go out first, and
// the x tiles only once the grid before (the norm pass) has ended.
template <bool W8, bool SWAP, int NT>
__device__ __forceinline__ void produce(const Params& p, const Ring& rg, int kt0, int n_kt, int m0, int n0) {
  using T = Layout<W8, SWAP, NT>;
  auto load_w = [&](int i, int s) {
    const int k0 = (kt0 + i) * BK;
    uint8_t* st = rg.base + s * T::STAGE;
    if constexpr (W8) {
      tma_load_3d(st + T::X_BYTES, &p.w_map, &rg.full[s], n0, k0, 0);
    } else {
#pragma unroll
      for (int c = 0; c < T::CHUNKS; ++c)
        tma_load_3d(st + T::X_BYTES + c * BK * 128, &p.w_map, &rg.full[s], n0 + 64 * c, k0, p.li);
    }
  };
  auto load_x = [&](int i, int s) {
    tma_load_3d(rg.base + s * T::STAGE, &p.x_map, &rg.full[s], (kt0 + i) * BK, m0, 0);
  };
  const int first = p.x_after ? min(p.stages, n_kt) : 0;  // the ring's first round: all its slots are free
  for (int i = 0; i < first; ++i) {
    mbar_arrive_expect_tx(&rg.full[i], T::STAGE);
    load_w(i, i);
  }
  if (first > 0) {
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    for (int i = 0; i < first; ++i) load_x(i, i);
  }
  int s = first == p.stages ? 0 : first;  // the stage and the parity of its round, counted: no division
  uint32_t ph = first == p.stages ? 1 : 0;
  for (int i = first; i < n_kt; ++i) {
    mbar_wait(&rg.empty[s], ph ^ 1);
    mbar_arrive_expect_tx(&rg.full[s], T::STAGE);
    load_w(i, s);
    load_x(i, s);
    if (++s == p.stages) s = 0, ph ^= 1;
  }
}

// H7, warps 1-3: stage i's int8 tile into bf16 tile i % TILES, once the
// consumers are done with that tile's last stage
template <bool SWAP, int NT>
__device__ __forceinline__ void convert_all(const Params& p, const Ring& rg, int n_kt) {
  using T = Layout<true, SWAP, NT>;
  const int lane = threadIdx.x & 31;
  int s = 0;
  uint32_t ph = 0;
  for (int i = 0; i < n_kt; ++i) {
    mbar_wait(&rg.full[s], ph);
    const int b = i % T::TILES;
    mbar_wait(&rg.free[b], ((i / T::TILES) & 1) ^ 1);
    convert<SWAP, NT>(rg.base + s * T::STAGE + T::X_BYTES, rg.conv + b * T::WB_BYTES, threadIdx.x - 32);
    fence_proxy_async();  // this thread's writes, before the tensor cores read them
    __syncwarp();
    if (lane == 0) mbar_arrive(&rg.ready[b]);
    if (++s == p.stages) s = 0, ph ^= 1;
  }
}

// One consumer warpgroup's mainloop: acc (64 x NT, wgmma's layout) over the
// CTA's k tiles
template <bool W8, bool SWAP, int NT>
__device__ __forceinline__ void consume(const Params& p, const Ring& rg, int n_kt, int cw,
                                        float (&acc)[Layout<W8, SWAP, NT>::RB][NT / 2]) {
  using T = Layout<W8, SWAP, NT>;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) {
#pragma unroll
    for (int rb = 0; rb < T::RB; ++rb) acc[rb][i] = 0.f;
  }
  int s = 0, prev = 0;  // this stage and the last
  uint32_t ph = 0;
  for (int i = 0; i < n_kt; ++i) {
    mbar_wait(&rg.full[s], ph);
    if constexpr (W8) mbar_wait(&rg.ready[i % T::TILES], (i / T::TILES) & 1);
    const uint32_t x = smem_u32(rg.base + s * T::STAGE);
    const uint32_t w = W8 ? smem_u32(rg.conv + (i % T::TILES) * T::WB_BYTES) : x + T::X_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if constexpr (SWAP) {  // A: W chunk cw, MN-major (16 K rows a step); B: x, K-major (32 bytes a step)
        const uint64_t da = desc_mn(w + cw * BK * 128 + kk * 16 * 128, BK * 128);
        const uint64_t db = smem_desc_at<128>(x + kk * 32);
        wgmma_ss<NT, 1, 0>(acc[0], da, db);
      } else {  // A: x rows 64 (RB cw + rb).., K-major; B: the W chunks, MN-major, BK * 128 bytes apart
        const uint64_t db = desc_mn(w + kk * 16 * 128, BK * 128);
#pragma unroll
        for (int rb = 0; rb < T::RB; ++rb)
          wgmma_ss<NT, 0, 1>(acc[rb], smem_desc_at<128>(x + (T::RB * cw + rb) * 64 * 128 + kk * 32), db);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: release it
    if (i > 0 && lane == 0) {
      mbar_arrive(&rg.empty[prev]);
      if constexpr (W8) mbar_arrive(&rg.free[(i - 1) % T::TILES]);
    }
    prev = s;
    if (++s == p.stages) s = 0, ph ^= 1;
  }
  wgmma_wait<0>();
#pragma unroll
  for (int rb = 0; rb < T::RB; ++rb) fence_regs(acc[rb]);
}

// The accumulators into the CTA's fp32 tile [TM][PITCH] (rows M, columns N)
template <bool W8, bool SWAP, int NT>
__device__ __forceinline__ void stage_tile(float* S, int cw, const float (&acc)[Layout<W8, SWAP, NT>::RB][NT / 2]) {
  using T = Layout<W8, SWAP, NT>;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * warp + g + 8 * h;  // wgmma row
      if constexpr (SWAP) {  // row r is column 64 cw + r of the output, column 8j + 2t + e its row
#pragma unroll
        for (int e = 0; e < 2; ++e) S[(8 * j + 2 * t + e) * T::PITCH + 64 * cw + r] = acc[0][4 * j + 2 * h + e];
      } else {
#pragma unroll
        for (int rb = 0; rb < T::RB; ++rb)
          *reinterpret_cast<float2*>(S + (64 * (T::RB * cw + rb) + r) * T::PITCH + 8 * j + 2 * t) =
              make_float2(acc[rb][4 * j + 2 * h], acc[rb][4 * j + 2 * h + 1]);
      }
    }
  }
}

// Without a K split: the accumulators, the epilogue applied, straight to
// out (at decode two bytes a store, 16 contiguous bytes for 8 lanes; the
// output is a few percent of the weight's bytes)
template <bool W8, bool SWAP, int NT>
__device__ __forceinline__ void store_tile(const Params& p, const float* cols, int cw, int m0, int n0,
                                           const float (&acc)[Layout<W8, SWAP, NT>::RB][NT / 2]) {
  using T = Layout<W8, SWAP, NT>;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  auto epi = [&](float v, int c) { return W8 ? v * cols[c] : bf16_round(v) + cols[c]; };
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * warp + g + 8 * h;  // wgmma row
      if constexpr (SWAP) {  // row r is column r of the tile, column 8j + 2t + e its row
        const int n = n0 + r;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = m0 + 8 * j + 2 * t + e;
          if (m < p.M && n < p.N) p.out[(long long)m * p.N + n] = __float2bfloat16(epi(acc[0][4 * j + 2 * h + e], r));
        }
      } else {
        const int c = 8 * j + 2 * t, n = n0 + c;  // N % 8 == 0: n < N implies n + 1 < N
#pragma unroll
        for (int rb = 0; rb < T::RB; ++rb) {
          const int m = m0 + 64 * (T::RB * cw + rb) + r;
          if (m < p.M && n < p.N)
            *reinterpret_cast<uint32_t*>(p.out + (long long)m * p.N + n) =
                pack_bf16x2(epi(acc[rb][4 * j + 2 * h], c), epi(acc[rb][4 * j + 2 * h + 1], c + 1));
        }
      }
    }
  }
}

// After the cluster barrier: this CTA's share of the tile's 8-column pieces,
// each folded over the cluster in rank order, the epilogue applied once
template <bool W8, bool SWAP, int NT>
__device__ __forceinline__ void fold_store(const Params& p, float* S, const float* cols, int C, int rank, int m0,
                                           int n0) {
  using T = Layout<W8, SWAP, NT>;
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int PIECES = T::TN / 8;
  const int rows = min(T::TM, p.M - m0);
  const int items = rows * PIECES;
  const int i0 = items * rank / C, i1 = items * (rank + 1) / C;
  for (int i = i0 + (int)threadIdx.x - T::FOLD0; i < i1; i += T::THREADS - T::FOLD0) {
    const int r = i / PIECES, c8 = (i % PIECES) * 8;
    const int n = n0 + c8;
    if (n >= p.N) continue;  // N % 8 == 0: the piece is whole or out
    float acc[8];
    fold::fold8(cluster, S + r * T::PITCH + c8, C, acc);
    uint32_t o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float c0 = cols[c8 + 2 * j], c1 = cols[c8 + 2 * j + 1];
      if constexpr (W8) o[j] = pack_bf16x2(acc[2 * j] * c0, acc[2 * j + 1] * c1);
      else o[j] = pack_bf16x2(bf16_round(acc[2 * j]) + c0, bf16_round(acc[2 * j + 1]) + c1);
    }
    *reinterpret_cast<uint4*>(p.out + (long long)(m0 + r) * p.N + n) = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// Grid (C, N tiles, M tiles) in clusters of (C, 1, 1): CTA z of a cluster
// sums k tiles [z * k_tiles / C, (z + 1) * k_tiles / C) of its output tile.
template <bool W8, bool SWAP, int NT>
__global__ void __launch_bounds__(Layout<W8, SWAP, NT>::THREADS, Layout<W8, SWAP, NT>::MIN_BLOCKS)
    gemm_kernel(const __grid_constant__ Params p) {
  using T = Layout<W8, SWAP, NT>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  Ring rg;
  rg.base = base;
  rg.conv = base + p.stages * T::STAGE;
  rg.full = reinterpret_cast<uint64_t*>(base + T::ring(p.stages));
  rg.empty = rg.full + kMaxStages;
  rg.ready = rg.empty + kMaxStages;
  rg.free = rg.ready + kMaxTiles;
  float* cols = reinterpret_cast<float*>(rg.free + kMaxTiles);
  cg::cluster_group cluster = cg::this_cluster();
  const int C = gridDim.x;
  // this CTA's k tiles [kt0, kt0 + n_kt) and tile origin, derived where each
  // role uses them: a value live across setmaxnreg.dec would be spilled
  auto k_range = [&](int& kt0, int& n_kt) {
    kt0 = p.k_tiles * (int)blockIdx.x / C;
    n_kt = p.k_tiles * ((int)blockIdx.x + 1) / C - kt0;
  };
  auto n_origin = [] { return (int)blockIdx.y * T::TN; };
  auto m_origin = [] { return (int)blockIdx.z * T::TM; };

  if (threadIdx.x == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(&rg.full[i], 1);
      mbar_init(&rg.empty[i], 4 * T::WGS);
    }
    for (int i = 0; i < kMaxTiles; ++i) {
      mbar_init(&rg.ready[i], kConverterThreads / 32);
      mbar_init(&rg.free[i], 4 * T::WGS);
    }
    fence_barrier_init();
    prefetch_tensormap(&p.x_map);
    prefetch_tensormap(&p.w_map);
  }
  __syncthreads();

  // the columns' scale or bias, read while the ring fills (0 past N and without a bias)
  for (int c = (int)threadIdx.x - 128; c >= 0 && c < T::TN; c += 128 * T::WGS) {
    const int n = n_origin() + c;
    cols[c] = n >= p.N ? 0.f : W8 ? p.scale[n] : p.bias != nullptr ? __bfloat162float(p.bias[n]) : 0.f;
  }
  // With K splits: every CTA of the cluster stages its tile, a cluster
  // barrier, the fold, a second barrier (so that no CTA leaves while another
  // reads its shared memory). Each role calls it in its own branch: code
  // after the branches would have to fit the producers' registers.
  auto fold = [&](bool folds) {
    cluster.sync();
    if (folds)
      fold_store<W8, SWAP, NT>(p, reinterpret_cast<float*>(base), cols, C, (int)blockIdx.x, m_origin(), n_origin());
    cluster.sync();
  };
  int kt0, n_kt;
  if (threadIdx.x < 128) {
    if constexpr (!SWAP) setmaxnreg_dec<kProducerRegs>();
    k_range(kt0, n_kt);
    if (threadIdx.x == 0) produce<W8, SWAP, NT>(p, rg, kt0, n_kt, m_origin(), n_origin());
    if constexpr (W8) {
      if (threadIdx.x >= 32) convert_all<SWAP, NT>(p, rg, n_kt);
    }
    if (C > 1) fold(T::FOLD0 == 0);
  } else {
    if constexpr (!SWAP) setmaxnreg_inc<kConsumerRegs>();
    k_range(kt0, n_kt);
    const int cw = (threadIdx.x >> 7) - 1;
    float acc[T::RB][NT / 2];
    consume<W8, SWAP, NT>(p, rg, n_kt, cw, acc);
    named_barrier(1, 128 * T::WGS);  // cols is written; every consumer's products are done
    if (C == 1) {
      store_tile<W8, SWAP, NT>(p, cols, cw, m_origin(), n_origin(), acc);
    } else {
      stage_tile<W8, SWAP, NT>(reinterpret_cast<float*>(base), cw, acc);  // the ring takes the fp32 tile
      fold(true);
    }
  }
}

// ------------------------------------------------------------------- host

struct Plan {
  int swap, nt, splits, stages;
};

template <bool W8, bool SWAP, int NT>
int launch_one(const Params& p, const Plan& pl, cudaStream_t st) {
  using T = Layout<W8, SWAP, NT>;
  const int smem = T::smem(pl.stages);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  auto kernel = gemm_kernel<W8, SWAP, NT>;
  static int allowed = 0;  // the shared memory this instance was last allowed: set again only on a change
  cudaError_t e = cudaSuccess;
  if (smem != allowed) e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  allowed = smem;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.splits, (p.N + T::TN - 1) / T::TN, (p.M + T::TM - 1) / T::TM);
  cfg.blockDim = dim3(T::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.x_after ? 2 : 1;
  e = cudaLaunchKernelEx(&cfg, kernel, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The instance the plan names; an error for one that was not built
template <bool W8>
int launch(const Params& p, const Plan& pl, cudaStream_t st) {
  if (pl.splits < 1 || pl.splits > kMaxCluster || pl.stages < 2 || pl.stages > kMaxStages ||
      p.k_tiles < pl.splits)
    return (int)cudaErrorInvalidValue;
  if (pl.swap) {
    if (pl.nt < p.M) return (int)cudaErrorInvalidValue;
    switch (pl.nt) {
      case 8: return launch_one<W8, true, 8>(p, pl, st);
      case 16: return launch_one<W8, true, 16>(p, pl, st);
      case 32: return launch_one<W8, true, 32>(p, pl, st);
      case 64: return launch_one<W8, true, 64>(p, pl, st);
      case 96: return launch_one<W8, true, 96>(p, pl, st);
      case 128: return launch_one<W8, true, 128>(p, pl, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return pl.nt == 128 ? launch_one<W8, false, 128>(p, pl, st) : (int)cudaErrorInvalidValue;
}

// the x map: (M, K) with row stride x_rs elements, box {64, TM}
inline int encode_x(CUtensorMap* map, const void* x, long long x_rs, int M, int K, const Plan& pl) {
  const int tm = pl.swap ? pl.nt : 256;
  return encode_cached(map, 2, x, K, M, 1, x_rs * 2, (long long)M * x_rs * 2, 64, tm, 1, 128);
}

}  // namespace gemm
}  // namespace padt
