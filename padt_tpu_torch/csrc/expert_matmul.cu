// H11 expert_matmul: the grouped expert GEMM of a sparse-expert MLP
// (Qwen3-MoE's, as Keye-VL-2.0-30B-A3B runs it: 128 experts of width 768,
// 8 a token). The token-expert choices arrive grouped by expert
// (ops/moe.py `group`): expert e's choices are rows [ends[e-1], ends[e]).
// Two products, the sums in fp32:
//   gate-up: h[i] = bf16(silu(a[i] @ Wg_e) * (a[i] @ Wu_e)), a (rows, K) the
//            choices' token rows in expert order, W (E, K, 2F) gate | up,
//            h (rows, F) in expert order (SiLU * up fused in the epilogue);
//   down:    out[dst[i]] = bf16((h[i] @ Wd_e) * scale[i]), W (E, F, D): each
//            row scaled by its routing weight and written at its choice's
//            own place, so that the combine is a sum over a token's k rows
//            in fixed order (no atomics: a replay equals an eager step bit
//            for bit).
// No TPU kernel stands behind it: the JAX package has no MoE.
//
// The grid is static, so that a CUDA graph holds it: (column tiles, the
// most row tiles any routing of `rows` choices can give). Warp 0 of each CTA
// reads `ends` from device memory and finds its row tile's expert and rows
// (each expert's rows cut into tiles of TM, in expert order); a CTA past the
// last tile, and so every tile an expert without rows would have had, exits
// before it reads a weight.
//
// The mainloop is gemm_sm90.cuh's (H7's and H10's): a producer warpgroup
// whose lane 0 issues the TMA copies into a ring of stages of 64 K rows,
// wgmma from shared memory, 128-byte swizzled tiles. The expert is the third
// coordinate of the weight's (NW, K, E) descriptor, as the layer is H10's.
//   - Decode (swap-AB: at most 64 tokens a call, so at most 64 rows an
//     expert, 1-3 at the serve cell): out^T = W^T a^T, 64 weight columns are
//     wgmma's rows and an expert's rows its n (NT, the tokens rounded up to
//     8, 16, 32 or 64), so one tile holds all of an expert's rows and its
//     weights stream once. Gate-up loads the gate and the up chunk of the
//     same 64 columns into each stage and keeps two accumulators.
//   - Prefill (some 160 rows an expert for 2560 tokens): 256 x 128 tiles,
//     two consumer warpgroups of two 64-row blocks (setmaxnreg 56 / 224, as
//     gemm_sm90.cuh's prefill). Gate-up's 128 B columns are the gate and the
//     up chunk of 64 output columns side by side, so wgmma's accumulator
//     column c + 64 is the up product of column c, in the same thread.
// Rows of the next expert that a tile's x box reads are multiplied and
// never stored; rows past `rows` read as zeros (TMA's out-of-bounds fill).
#include "gemm_sm90.cuh"

namespace padt {
namespace moe {

using namespace hopper;
using gemm::BK;
using gemm::bf16;
using gemm::kMaxStages;

// One instance: SWAP (decode) or not; NT = wgmma's N; GATED (gate-up) or down
template <bool SWAP, int NT, bool GATED>
struct XLayout {
  static_assert(SWAP || NT == 128, "prefill: 256 x 128 tiles");
  static constexpr bool G = GATED;
  static constexpr bool S = SWAP;
  static constexpr int WGS = SWAP ? 1 : 2;              // consumer warpgroups
  static constexpr int RB = SWAP ? 1 : 2;               // 64-row blocks of a consumer warpgroup
  static constexpr int THREADS = 128 * (1 + WGS);
  static constexpr int TM = SWAP ? NT : 64 * WGS * RB;  // choices a CTA: the x tile's rows
  static constexpr int CHUNKS = SWAP && !GATED ? 1 : 2;  // 64-column chunks of the W tile
  static constexpr int ACCS = SWAP ? CHUNKS : RB;        // accumulators a consumer thread holds
  static constexpr int TN = GATED || SWAP ? 64 : 128;    // output columns a CTA
  static constexpr int X_BYTES = TM * 128;
  static constexpr int STAGE = X_BYTES + CHUNKS * BK * 128;  // = TMA bytes a stage
  static constexpr int MIN_BLOCKS = SWAP ? 2 : 1;
  // the ring, its full and empty barriers, the tile's (expert, first row, end), alignment slack
  __host__ __device__ static int smem(int stages) { return stages * STAGE + 2 * kMaxStages * 8 + 16 + 1024; }
};

struct Params {
  CUtensorMap x_map;   // a (rows, K): box {64, TM}
  CUtensorMap w_map;   // W (E, K, NW) as (NW, K, E): box {64, 64, 1}
  const int* ends;     // (E,) inclusive running count of choices per expert
  const int* dst;      // down: (rows,) each choice's output row
  const float* scale;  // down: (rows,) its routing weight
  bf16* out;           // gate-up (rows, NW / 2) in expert order; down (rows, NW)
  int n_out, up, E, k_tiles, stages;  // up: gate-up's first up column (NW / 2)
};

// Warp 0: the expert of row tile `tile`, its first row and the expert's end
// row into info[0..2]; expert -1 past the last tile. Lane l sums the tiles
// of experts [l * per, (l + 1) * per), a warp scan finds the lane that holds
// the tile, and that lane walks its experts.
__device__ __forceinline__ void find_tile(const int* __restrict__ ends, int E, int tm, int tile, int* info) {
  const int lane = threadIdx.x & 31;
  const int per = (E + 31) / 32, lo = min(lane * per, E), hi = min(lo + per, E);
  auto first = [&](int e) { return e > 0 ? ends[e - 1] : 0; };
  int mine = 0;
  for (int e = lo; e < hi; ++e) mine += (ends[e] - first(e) + tm - 1) / tm;
  int incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 0) info[0] = -1;
  __syncwarp();
  int t = tile - (incl - mine);
  if (t >= 0 && t < mine) {
    for (int e = lo; e < hi; ++e) {
      const int s = first(e), n = (ends[e] - s + tm - 1) / tm;
      if (t < n) {
        info[0] = e, info[1] = s + t * tm, info[2] = ends[e];
        break;
      }
      t -= n;
    }
  }
}

// Lane 0 of warp 0: the x rows [row0, row0 + TM) and the W chunks of expert
// e, column origin n0, for every k tile
template <class T>
__device__ __forceinline__ void produce(const Params& p, const gemm::Ring& rg, int e, int row0, int n0) {
  int s = 0;
  uint32_t ph = 0;
  for (int i = 0; i < p.k_tiles; ++i) {
    mbar_wait(&rg.empty[s], ph ^ 1);
    mbar_arrive_expect_tx(&rg.full[s], T::STAGE);
    uint8_t* st = rg.base + s * T::STAGE;
    tma_load_3d(st, &p.x_map, &rg.full[s], i * BK, row0, 0);
#pragma unroll
    for (int c = 0; c < T::CHUNKS; ++c)  // gate-up: the gate and the up chunk of the same output columns
      tma_load_3d(st + T::X_BYTES + c * BK * 128, &p.w_map, &rg.full[s], T::G ? n0 + c * p.up : n0 + 64 * c,
                  i * BK, e);
    if (++s == p.stages) s = 0, ph ^= 1;
  }
}

// One consumer warpgroup's mainloop over every k tile. Swap-AB: acc[c] is
// W chunk c (wgmma's rows) against the x rows (its n). Else acc[rb] is x row
// block RB cw + rb against both chunks (128 columns)
template <class T, int NT>
__device__ __forceinline__ void consume(const Params& p, const gemm::Ring& rg, int cw, float (&acc)[T::ACCS][NT / 2]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int a = 0; a < T::ACCS; ++a) {
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[a][i] = 0.f;
  }
  int s = 0, prev = 0;  // this stage and the last
  uint32_t ph = 0;
  for (int i = 0; i < p.k_tiles; ++i) {
    mbar_wait(&rg.full[s], ph);
    const uint32_t x = smem_u32(rg.base + s * T::STAGE), w = x + T::X_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if constexpr (T::S) {  // A: W chunk c, MN-major (16 K rows a step); B: x, K-major (32 bytes a step)
        const uint64_t db = smem_desc_at<128>(x + kk * 32);
#pragma unroll
        for (int c = 0; c < T::CHUNKS; ++c)
          gemm::wgmma_ss<NT, 1, 0>(acc[c], gemm::desc_mn(w + c * BK * 128 + kk * 16 * 128, BK * 128), db);
      } else {  // A: x rows 64 (RB cw + rb).., K-major; B: both W chunks, MN-major, BK * 128 bytes apart
        const uint64_t db = gemm::desc_mn(w + kk * 16 * 128, BK * 128);
#pragma unroll
        for (int rb = 0; rb < T::RB; ++rb)
          gemm::wgmma_ss<NT, 0, 1>(acc[rb], smem_desc_at<128>(x + (T::RB * cw + rb) * 64 * 128 + kk * 32), db);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: release it
    if (i > 0 && lane == 0) mbar_arrive(&rg.empty[prev]);
    prev = s;
    if (++s == p.stages) s = 0, ph ^= 1;
  }
  wgmma_wait<0>();
#pragma unroll
  for (int a = 0; a < T::ACCS; ++a) fence_regs(acc[a]);
}

__device__ __forceinline__ float silu_mul(float g, float u) { return g / (1.f + expf(-g)) * u; }

// Swap-AB epilogue: wgmma row r is output column n0 + r, column 8j + 2t + e
// the tile's choice row0 + 8j + 2t + e (two bytes a store; the output is a
// few percent of the weight's bytes)
template <class T, int NT>
__device__ __forceinline__ void store_swap(const Params& p, int row0, int row_end, int n0,
                                           const float (&acc)[T::ACCS][NT / 2]) {
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + 16 * warp + g + 8 * h;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = row0 + 8 * j + 2 * t + e, q = 4 * j + 2 * h + e;
        if (m >= row_end || n >= p.n_out) continue;
        if constexpr (T::G) {
          p.out[(long long)m * p.n_out + n] = __float2bfloat16(silu_mul(acc[0][q], acc[1][q]));
        } else {
          p.out[(long long)p.dst[m] * p.n_out + n] = __float2bfloat16(acc[0][q] * p.scale[m]);
        }
      }
    }
  }
}

// Prefill epilogue: wgmma row r of block rb is the choice row0 + 64 (RB cw +
// rb) + r, columns 8j + 2t and one more a 32-bit store; gate-up pairs column
// c with its up product at c + 64 (j + 8)
template <class T>
__device__ __forceinline__ void store_tiles(const Params& p, int cw, int row0, int row_end, int n0,
                                            const float (&acc)[T::ACCS][64]) {
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  constexpr int J = T::G ? 8 : 16;
#pragma unroll
  for (int rb = 0; rb < T::RB; ++rb) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = row0 + 64 * (T::RB * cw + rb) + 16 * warp + g + 8 * h;
      if (m >= row_end) continue;
      const long long orow = T::G ? (long long)m : (long long)p.dst[m];
      const float sc = T::G ? 1.f : p.scale[m];
      bf16* o = p.out + orow * p.n_out;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int n = n0 + 8 * j + 2 * t, q = 4 * j + 2 * h;  // n_out is even: n < n_out implies n + 1 < n_out
        if (n >= p.n_out) continue;
        uint32_t v;
        if constexpr (T::G) {
          v = pack_bf16x2(silu_mul(acc[rb][q], acc[rb][q + 32]), silu_mul(acc[rb][q + 1], acc[rb][q + 33]));
        } else {
          v = pack_bf16x2(acc[rb][q] * sc, acc[rb][q + 1] * sc);
        }
        *reinterpret_cast<uint32_t*>(o + n) = v;
      }
    }
  }
}

// Grid (column tiles, row tiles)
template <bool SWAP, int NT, bool GATED>
__global__ void __launch_bounds__(XLayout<SWAP, NT, GATED>::THREADS, XLayout<SWAP, NT, GATED>::MIN_BLOCKS)
    expert_gemm_kernel(const __grid_constant__ Params p) {
  using T = XLayout<SWAP, NT, GATED>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  gemm::Ring rg = {};
  rg.base = base;
  rg.full = reinterpret_cast<uint64_t*>(base + p.stages * T::STAGE);
  rg.empty = rg.full + kMaxStages;
  int* info = reinterpret_cast<int*>(rg.empty + kMaxStages);
  if (threadIdx.x < 32) find_tile(p.ends, p.E, T::TM, (int)blockIdx.y, info);
  if (threadIdx.x == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(&rg.full[i], 1);
      mbar_init(&rg.empty[i], 4 * T::WGS);
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (info[0] < 0) return;  // past the last tile: no weight is read
  if (threadIdx.x < 128) {
    if constexpr (!SWAP) setmaxnreg_dec<gemm::kProducerRegs>();
    if (threadIdx.x == 0) {
      prefetch_tensormap(&p.x_map);
      prefetch_tensormap(&p.w_map);
      produce<T>(p, rg, info[0], info[1], (int)blockIdx.x * T::TN);
    }
  } else {
    if constexpr (!SWAP) setmaxnreg_inc<gemm::kConsumerRegs>();
    const int cw = (threadIdx.x >> 7) - 1;
    float acc[T::ACCS][NT / 2];
    consume<T, NT>(p, rg, cw, acc);
    if constexpr (SWAP) store_swap<T, NT>(p, info[1], info[2], (int)blockIdx.x * T::TN, acc);
    else store_tiles<T>(p, cw, info[1], info[2], (int)blockIdx.x * T::TN, acc);
  }
}

template <bool SWAP, int NT, bool GATED>
int launch_one(const Params& p, int row_tiles, cudaStream_t st) {
  using T = XLayout<SWAP, NT, GATED>;
  const int smem = T::smem(p.stages);
  if (smem > gemm::kSmemLimit) return (int)cudaErrorInvalidValue;
  auto kernel = expert_gemm_kernel<SWAP, NT, GATED>;
  static int allowed = 0;  // the shared memory this instance was last allowed: set again only on a change
  if (smem != allowed) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    allowed = smem;
  }
  kernel<<<dim3((p.n_out + T::TN - 1) / T::TN, row_tiles), T::THREADS, smem, st>>>(p);
  return (int)cudaGetLastError();
}

template <bool GATED>
int launch(const Params& p, int swap, int nt, int row_tiles, cudaStream_t st) {
  if (!swap) return nt == 128 ? launch_one<false, 128, GATED>(p, row_tiles, st) : (int)cudaErrorInvalidValue;
  switch (nt) {
    case 8: return launch_one<true, 8, GATED>(p, row_tiles, st);
    case 16: return launch_one<true, 16, GATED>(p, row_tiles, st);
    case 32: return launch_one<true, 32, GATED>(p, row_tiles, st);
    case 64: return launch_one<true, 64, GATED>(p, row_tiles, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace moe
}  // namespace padt

// C entry point (loaded with ctypes). a (rows, K) bf16 contiguous: the
// choices' token rows in expert order (gate-up) or h (down); w (E, K, NW)
// bf16 contiguous; ends (E,) int32; dst (rows,) int32 and scale (rows,) fp32
// (down only); out (rows, NW / 2) for gate-up, (rows, NW) for down. swap,
// nt, stages, row_tiles: the wrapper's launch plan (ops/cuda_moe.py
// `expert_plan`). Returns the CUDA error code of the launch (0 on success),
// or cudaErrorInvalidValue for shapes or a plan the kernel does not take.
extern "C" int padt_expert_matmul(const void* a, const void* w, void* out, const void* ends, const void* dst,
                                  const void* scale, int rows, int K, int NW, int E, int gated, int swap, int nt,
                                  int stages, int row_tiles, void* stream) {
  using namespace padt;
  if (rows == 0 || row_tiles == 0) return 0;
  if (K % 8 != 0 || NW % 16 != 0 || E < 1 || stages < 2 || stages > gemm::kMaxStages ||
      (!gated && (dst == nullptr || scale == nullptr)))
    return (int)cudaErrorInvalidValue;
  moe::Params p = {};
  const gemm::Plan pl{swap, nt, 1, stages};
  int rc = gemm::encode_x(&p.x_map, a, K, rows, K, pl);
  if (rc == 0)
    rc = hopper::encode_cached(&p.w_map, 2, w, NW, K, E, (long long)NW * 2, (long long)K * NW * 2, 64, gemm::BK, 1,
                               128);
  if (rc != 0) return rc;
  p.ends = static_cast<const int*>(ends);
  p.dst = static_cast<const int*>(dst);
  p.scale = static_cast<const float*>(scale);
  p.out = static_cast<gemm::bf16*>(out);
  p.n_out = gated ? NW / 2 : NW, p.up = NW / 2, p.E = E, p.k_tiles = (K + gemm::BK - 1) / gemm::BK;
  p.stages = stages;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return gated ? moe::launch<true>(p, swap, nt, row_tiles, st) : moe::launch<false>(p, swap, nt, row_tiles, st);
}
