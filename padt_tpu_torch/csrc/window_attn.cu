// H3 window_slot_attn: exact softmax attention inside each 64-token window
// slot of the vision tower's slot layout (padt_tpu/models/vision_geom.py,
// window_slots): every window sits alone in its own 64-token slot, so a
// query sees only the keys of its slot, and only those with seg >= 0.
//
// Replaces padt_tpu/ops/pallas_attention.py::_vis_win_kernel :860 (the 28
// windowed vision layers) and keeps its function: one exact softmax over the
// slot's 64 keys (no online rescaling), keys with seg < 0 masked, the
// probabilities rounded to bf16 before P.V (K2's p.astype(vs.dtype)), the
// division by l after P.V, and 0 for a row with no valid key. There the TPU
// paired two windows into one 128x128 tile to fill its matrix unit; here a
// work item is one (slot, head, batch row): 64 queries against 64 keys.
//
// Bound on the H100: memory. Per layer at B=2, S=2304, 16 heads of 80:
// 1.5 GFLOP of tensor work (1.5 us at the bf16 peak) against 47 MB of
// q/k/v/out traffic (14 us at 3.35 TB/s). The design keeps bytes in flight:
//   - persistent CTAs, one per SM, walk the items i = r * gridDim.x +
//     blockIdx.x (r = 0, 1, ...), the head the fastest index of i, then the
//     slot, then the batch row (ops/cuda_attention.py::window_plan mirrors
//     the walk);
//   - a producer warp issues, for each item, TMA copies of its Q, K and V
//     tiles (64 x HD each, out of 4D {hd, heads, seq, batch} views with the
//     caller's strides, so q/k/v may be views of the fused qkv buffer and V
//     is never transposed or copied) into a ring of stages under full /
//     empty mbarriers. Each consumer thread loads the 16 segment ids of its
//     key columns from global memory (L2: the slot's 16 heads share them)
//     before it waits for the item's tiles, so the loads' latency hides
//     under that wait;
//   - two consumer warpgroups take the CTA's items in turn (item r goes to
//     warpgroup r % 2, from stage r % stages), so one item's softmax and
//     store overlap the other's wgmma and the producer's copies: S = Q K^T
//     by SS-wgmma m64n64k16 on
//     the tiles as TMA writes them (K-major, no transpose), the masked
//     one-tile softmax in registers (base 2, scale * log2 e folded into the
//     exponent), O = P V by RS-wgmma with P the bf16 of the probabilities
//     in registers and V read MN-major (the transpose bit). A consumer
//     releases its stage as soon as P V has completed;
//   - the output O / l goes, as bf16, into the warpgroup's own staging tile
//     in shared memory (swizzled as TMA stores it) and out by TMA stores;
//     the next item waits only for that store to have read the tile;
//   - head dims 16, 32 and 64 are one tile of that width; 80 is a 64-wide
//     chunk (128-byte swizzle) and a 16-wide one (32-byte swizzle); 128 is
//     two 64-wide chunks. Each chunk has its own TMA box, descriptor and
//     wgmma (S's k-steps, P V's N);
//   - programmatic dependent launch: the launch and the barriers' set-up
//     overlap the previous kernel's tail (H1's, on the vision path).
//
// Layout: q/k/v (B, S, H, HD) with unit last stride and every other stride
// a multiple of 8 elements (16 bytes, as TMA requires); seg (B, S) int32,
// contiguous and 16-byte aligned; out contiguous (B, S, H, HD). S is a
// multiple of 64.
#include "hopper.cuh"

namespace padt {
namespace wslot {

using namespace hopper;

constexpr int kWin = 64;       // rows of a window slot: wgmma's M and N of S
constexpr int kThreads = 288;  // two consumer warpgroups, then the producer warp
constexpr float kLog2e = 1.4426950408889634f;

// The ring's stage count is even, so stage s is always read by warpgroup
// s % 2: a warpgroup then waits on a stage's full barrier only after it has
// itself consumed that stage's previous fill, so the barrier is never two
// phases behind the parity it waits for. With an odd count the two
// warpgroups alternate on a stage, and warpgroup 1 could wait for stage 0's
// second fill before its first had landed: a barrier in phase 0 passes a
// wait on parity 1 at once (on the card, 3 and 5 stages faulted or gave
// wrong rows; tests/test_torch_rope_window_plan.py replays the protocol).
//
// The shared-memory layout of a CTA with a ring of `stages` stages (the
// launch plan's; ops/cuda_attention.py::window_smem_bytes mirrors smem()):
// the ring's Q K V tiles, two output staging tiles (one per consumer
// warpgroup), then full[stages] and empty[stages].
template <int HD>
struct Tiles {
  static constexpr int WA = HD < 64 ? HD : 64;  // first head-dim chunk
  static constexpr int WB = HD - WA;            // second chunk: 0, 16 or 64
  // bytes; every tile is a multiple of 1024, so every tile is atom-aligned
  static constexpr int T_A = kWin * WA * 2, T_B = kWin * WB * 2;
  static constexpr int TILE = T_A + T_B;       // one Q, K or V tile: chunk A, chunk B
  static constexpr int STAGE = 3 * TILE;       // Q K V
  __host__ __device__ static constexpr int o0(int stages) { return stages * STAGE; }
  __host__ __device__ static constexpr int bar0(int stages) { return o0(stages) + 2 * TILE; }
  __host__ __device__ static constexpr int smem(int stages) { return bar0(stages) + 2 * stages * 8 + 1024; }
};

struct Maps {
  CUtensorMap q[2], k[2], v[2], o[2];  // [0]: first head-dim chunk, [1]: second
};

// item i: head i % H, slot (i / H) % n_slots, batch row i / (H * n_slots)
struct Item {
  int h, s0, b;
  __device__ __forceinline__ Item(int i, int H, int n_slots) {
    h = i % H;
    const int j = i / H;
    s0 = (j % n_slots) * kWin;
    b = j / n_slots;
  }
};

// The producer warp: each of this CTA's items into the next stage of the
// ring, once the consumer of the item `stages` back has released it.
template <int HD>
__device__ __forceinline__ void produce(const Maps& maps, uint8_t* base, uint64_t* full, uint64_t* empty, int S,
                                        int H, int n_items, int stages) {
  using T = Tiles<HD>;
  if ((threadIdx.x & 31) != 0) return;
  const int n_slots = S / kWin;
  int stage = 0;
  uint32_t phase = 0;
  for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
    const Item w(i, H, n_slots);
    mbar_wait(&empty[stage], phase ^ 1);
    uint8_t* st = base + stage * T::STAGE;
    uint64_t* bar = &full[stage];
    mbar_arrive_expect_tx(bar, T::STAGE);
    tma_load_4d(st, &maps.q[0], bar, 0, w.h, w.s0, w.b);
    tma_load_4d(st + T::TILE, &maps.k[0], bar, 0, w.h, w.s0, w.b);
    tma_load_4d(st + 2 * T::TILE, &maps.v[0], bar, 0, w.h, w.s0, w.b);
    if constexpr (T::WB > 0) {
      tma_load_4d(st + T::T_A, &maps.q[1], bar, T::WA, w.h, w.s0, w.b);
      tma_load_4d(st + T::TILE + T::T_A, &maps.k[1], bar, T::WA, w.h, w.s0, w.b);
      tma_load_4d(st + 2 * T::TILE + T::T_A, &maps.v[1], bar, T::WA, w.h, w.s0, w.b);
    }
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// Consumer warpgroup wg (0 or 1): items r = wg, wg + 2, ... of this CTA,
// each from stage r % stages.
template <int HD>
__device__ __forceinline__ void consume(const Maps& maps, const int* seg, uint8_t* base, uint64_t* full,
                                        uint64_t* empty, int S, int H, int n_items, float scale, int stages) {
  using T = Tiles<HD>;
  constexpr int WA = T::WA, WB = T::WB;
  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int n_slots = S / kWin;
  const float sl2 = scale * kLog2e;
  uint8_t* oa_tile = base + T::o0(stages) + wg * T::TILE;  // this warpgroup's staging tile: chunk A, chunk B
  uint8_t* ob_tile = oa_tile + T::T_A;
  int stage = wg, phase = 0;  // item r's stage and parity: r % stages, (r / stages) & 1 (stages >= 2)
  for (int i = blockIdx.x + wg * gridDim.x; i < n_items; i += 2 * gridDim.x) {
    const Item w(i, H, n_slots);
    uint8_t* st = base + stage * T::STAGE;
    // the segment ids of this thread's key columns 8j + 2t + {0, 1}, in
    // flight while the tiles land
    int2 ks[kWin / 8];
    const int* sr = seg + (long long)w.b * S + w.s0 + 2 * t;
#pragma unroll
    for (int j = 0; j < kWin / 8; ++j) ks[j] = __ldg(reinterpret_cast<const int2*>(sr + 8 * j));
    mbar_wait(&full[stage], phase);

    // S = Q K^T over the head-dim chunks (k16 steps of 32 bytes in a row)
    float s[kWin / 2];
    wgmma_fence();
    {
      const uint64_t dq = smem_desc<2 * WA>(st), dk = smem_desc<2 * WA>(st + T::TILE);
#pragma unroll
      for (int kk = 0; kk < WA / 16; ++kk)
        wgmma_ss_n64(s, desc_advance(dq, 32 * kk), desc_advance(dk, 32 * kk), kk > 0);
    }
    if constexpr (WB > 0) {
      const uint64_t dq = smem_desc<2 * WB>(st + T::T_A), dk = smem_desc<2 * WB>(st + T::TILE + T::T_A);
#pragma unroll
      for (int kk = 0; kk < WB / 16; ++kk)
        wgmma_ss_n64(s, desc_advance(dq, 32 * kk), desc_advance(dk, 32 * kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // keys with seg < 0 masked
#pragma unroll
    for (int j = 0; j < kWin / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (((e & 1) ? ks[j].y : ks[j].x) < 0) s[4 * j + e] = -INFINITY;
    }

    // one exact softmax over the slot, base 2; a row with no valid key has
    // m = -inf, takes base 0, and its p and l are exactly 0
    float l[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kWin / 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mb = mx == -INFINITY ? 0.f : mx * sl2;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kWin / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(fmaf(s[4 * j + 2 * hh + e], sl2, -mb));  // masked: exp2(-inf) = 0
          s[4 * j + 2 * hh + e] = p;
          sum += p;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[hh] = sum;
    }

    // P as the register A operand: key block kk's two n8 blocks of S
    uint32_t pa[kWin / 16][4];
#pragma unroll
    for (int kk = 0; kk < kWin / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16x2(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    }

    // O = P V, V MN-major: a k16 step is 16 rows of the tile
    float oa[WA / 2], ob[WB > 0 ? WB / 2 : 1];
#pragma unroll
    for (int r = 0; r < WA / 2; ++r) oa[r] = 0.f;
#pragma unroll
    for (int r = 0; r < (WB > 0 ? WB / 2 : 1); ++r) ob[r] = 0.f;
    fence_regs(oa);
    fence_regs(ob);
#pragma unroll
    for (int kk = 0; kk < kWin / 16; ++kk) fence_regs(pa[kk]);
    wgmma_fence();
    {
      const uint64_t dv = smem_desc<2 * WA>(st + 2 * T::TILE);
#pragma unroll
      for (int kk = 0; kk < kWin / 16; ++kk) wgmma_rs<WA, 1>(oa, pa[kk], desc_advance(dv, kk * 16 * 2 * WA));
    }
    if constexpr (WB > 0) {
      const uint64_t dv = smem_desc<2 * WB>(st + 2 * T::TILE + T::T_A);
#pragma unroll
      for (int kk = 0; kk < kWin / 16; ++kk) wgmma_rs<WB, 1>(ob, pa[kk], desc_advance(dv, kk * 16 * 2 * WB));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(oa);
    fence_regs(ob);
    if (lane == 0) mbar_arrive(&empty[stage]);  // this warp has read the stage
    stage += 2;
    if (stage >= stages) {
      stage -= stages;
      phase ^= 1;
    }

    // O / l as bf16 into the staging tile, once the previous item's store
    // has read it, swizzled as TMA stores it
    if (tid == 0) tma_store_wait_read();
    named_barrier(1 + wg, 128);
    const float inv[2] = {l[0] > 0.f ? 1.f / l[0] : 0.f, l[1] > 0.f ? 1.f / l[1] : 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = 16 * warp + g + 8 * hh;
#pragma unroll
      for (int n = 0; n < WA / 8; ++n)
        *reinterpret_cast<uint32_t*>(oa_tile + swizzle<2 * WA>(row * 2 * WA + (8 * n + 2 * t) * 2)) =
            pack_bf16x2(oa[4 * n + 2 * hh] * inv[hh], oa[4 * n + 2 * hh + 1] * inv[hh]);
      if constexpr (WB > 0) {
#pragma unroll
        for (int n = 0; n < WB / 8; ++n)
          *reinterpret_cast<uint32_t*>(ob_tile + swizzle<2 * WB>(row * 2 * WB + (8 * n + 2 * t) * 2)) =
              pack_bf16x2(ob[4 * n + 2 * hh] * inv[hh], ob[4 * n + 2 * hh + 1] * inv[hh]);
      }
    }
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    if (tid == 0) {
      tma_store_4d(&maps.o[0], oa_tile, 0, w.h, w.s0, w.b);
      if constexpr (WB > 0) tma_store_4d(&maps.o[1], ob_tile, WA, w.h, w.s0, w.b);
      tma_store_commit();
    }
  }
  if (tid == 0) tma_store_wait_read();  // the staging tile outlives the CTA's stores
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    window_slot_kernel(const __grid_constant__ Maps maps, const int* __restrict__ seg, int S, int H, int n_items,
                       float scale, int stages) {
  using T = Tiles<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + T::bar0(stages));
  uint64_t* empty = full + stages;
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], 1);   // the producer's arrive (+ the copies' bytes)
      mbar_init(&empty[i], 4);  // one arrive per warp of the consuming warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();
  // under programmatic dependent launch: the grid before this one (which
  // writes q and k) has completed and its writes are visible; otherwise a
  // no-op
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (threadIdx.x >= 256) {
    if (threadIdx.x == 256) {
      prefetch_tensormap(&maps.q[0]);
      prefetch_tensormap(&maps.k[0]);
      prefetch_tensormap(&maps.v[0]);
    }
    produce<HD>(maps, base, full, empty, S, H, n_items, stages);
  } else {
    consume<HD>(maps, seg, base, full, empty, S, H, n_items, scale, stages);
  }
}

template <int HD>
static int launch(const Maps& maps, int n_ctas, int stages, int pdl, cudaStream_t st, const int* seg, int S, int H,
                  int n_items, float scale) {
  const int smem = Tiles<HD>::smem(stages);
  cudaError_t e = cudaFuncSetAttribute(window_slot_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_ctas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, window_slot_kernel<HD>, maps, seg, S, H, n_items, scale, stages);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace wslot
}  // namespace padt

// C entry point (loaded with ctypes); strides in elements (the batch, seq
// and head strides of q, k and v); n_ctas persistent CTAs with a ring of
// `stages` stages (the launch plan, ops/cuda_attention.py::window_plan),
// and pdl 1 to launch under programmatic dependent launch (the launch and
// the barriers' set-up overlap the previous kernel's tail; 0: a plain
// launch, for the launch-plan sweep's comparison).
// Returns cudaGetLastError() after the launch, or an error code for a head
// dim it was not built for, an S that is not a multiple of 64, a ring of an
// odd count of stages or more than a block's shared memory, or a view TMA
// cannot take.
extern "C" int padt_window_slot_attn(const void* q, const void* k, const void* v, const void* seg, void* out, int B,
                                     int S, int H, int hd, long long q_sb, long long q_ss, long long q_sh,
                                     long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                                     long long v_sh, float scale, int n_ctas, int stages, int pdl, void* stream) {
  using namespace padt::wslot;
  if (S % kWin != 0 || n_ctas <= 0 || stages < 2 || stages % 2 != 0) return (int)cudaErrorInvalidValue;
  if (hd != 16 && hd != 32 && hd != 64 && hd != 80 && hd != 128) return (int)cudaErrorInvalidValue;
  const long long items = (long long)B * (S / kWin) * H;
  if (items == 0) return 0;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int wa = hd < 64 ? hd : 64, wb = hd - wa;
  Maps maps = {};
  const long long o_ss = (long long)H * hd, o_sb = (long long)S * H * hd;
  int rc = 0;
  for (int c = 0; c < (wb > 0 ? 2 : 1) && rc == 0; ++c) {
    const int w = c == 0 ? wa : wb;
    if (rc == 0) rc = padt::hopper::encode_bf16_4d(&maps.q[c], q, hd, H, S, B, q_sh, q_ss, q_sb, w, kWin);
    if (rc == 0) rc = padt::hopper::encode_bf16_4d(&maps.k[c], k, hd, H, S, B, k_sh, k_ss, k_sb, w, kWin);
    if (rc == 0) rc = padt::hopper::encode_bf16_4d(&maps.v[c], v, hd, H, S, B, v_sh, v_ss, v_sb, w, kWin);
    if (rc == 0) rc = padt::hopper::encode_bf16_4d(&maps.o[c], out, hd, H, S, B, hd, o_ss, o_sb, w, kWin);
  }
  if (rc != 0) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto sg = static_cast<const int*>(seg);
  const int n = (int)items;
  switch (hd) {
    case 16: return launch<16>(maps, n_ctas, stages, pdl, st, sg, S, H, n, scale);
    case 32: return launch<32>(maps, n_ctas, stages, pdl, st, sg, S, H, n, scale);
    case 64: return launch<64>(maps, n_ctas, stages, pdl, st, sg, S, H, n, scale);
    case 80: return launch<80>(maps, n_ctas, stages, pdl, st, sg, S, H, n, scale);
    default: return launch<128>(maps, n_ctas, stages, pdl, st, sg, S, H, n, scale);
  }
}
