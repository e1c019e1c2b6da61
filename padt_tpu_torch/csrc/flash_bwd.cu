// H8 flash_bwd_dq and H9 flash_bwd_dkv: the flash-attention backward of the
// segment-id attention that H2 (segment_flash.cu) runs forward, from the
// forward's saved log-sum-exp and delta = rowsum(dO * O), written for
// Hopper (sm_90a): wgmma, a TMA ring, the segment-tile skip and, in H9, a
// fold of the GQA heads across a thread-block cluster.
//
// Replaces the two TPU kernels of the flash VJP (`_flash_bwd_pallas`,
// padt_tpu/ops/pallas_attention.py:453):
//   H8 <- _bwd_dq_kernel  :348  (dq; k-blocks in _kblock_ranges's [lo, hi))
//   H9 <- _bwd_dkv_kernel :392  (dk, dv; q-blocks in the transposed
//                                [qlo, qhi) from the causal diagonal on; the
//                                GQA heads summed into one output block)
// Same visibility rule as H2: key c is visible to query r iff
// q_seg[r] == k_seg[c] && k_seg[c] >= 0, and r >= c when causal; query head
// h reads kv head h / (H / Hkv). For each visible (r, c):
//   p  = exp(s * scale - lse[r])            (0 where not visible)
//   dp = dO[r] . v[c]
//   ds = p * (dp - delta[r]) * scale,        rounded to bf16 before ds.k, ds^T.q
//   dq[r] += ds * k[c];  dk[c] += ds * q[r];  dv[c] += bf16(p) * dO[r]
// A row with no visible key carries lse = +1e30 (H2's LSE output), so its p
// is exactly 0; rows and keys with no visible partner get 0 gradients.
//
// Bound on the H100: tensor-core operations. Per visible (r, c) pair and
// query head, H8 does three products of length hd (s, dp, dq) and H9 four
// (s, dp, dk, dv), against 989 TFLOP/s; the bytes (q, k, v, dO, lse, delta
// in, the gradients out) are 10-20x below that at the train step's shapes.
// The design, H2's with the roles of the products changed:
//   - two consumer warpgroups each own 64 rows of the item's 128 (query
//     rows in H8, keys in H9: wgmma's M). H8 adds a producer warpgroup
//     whose warp 0 issues every TMA copy and moves registers to the
//     consumers by setmaxnreg, as H2 does. H9's consumers hold dK and dV
//     (128 fp32 registers at hd 128): it has no producer, so that each
//     thread may have 255 registers, and its warp 0 streams the tiles;
//   - the item's own 128 rows (Q and dO in H8, K and V in H9) come in once
//     by TMA; the other side streams through a ring of STAGES stages, each
//     with a full and an empty mbarrier: H8 streams K/V tiles of 64 keys
//     (and the segment ids of a tile to mask), H9 Q/dO tiles of 64 query
//     rows and their LSE, delta and segment ids (loaded by the lanes of the
//     streaming warp: a TMA box must start 16-byte aligned, and a row of
//     them does not);
//   - the two score-like products by SS-wgmma on the tiles as TMA writes
//     them (both operands K-major): H8 S = Q K^T and dP = dO V^T (m64n64k16),
//     H9 S^T = K Q^T and dP^T = V dO^T in two halves of 32 queries
//     (m64n32k16); p and ds then stay in registers;
//   - the gradient products by RS-wgmma m64n(hd chunk)k16 with A taken from
//     the score accumulators' registers (as H2 does with P) and B read
//     MN-major (the transpose bit): H8 dQ += bf16(dS) K, H9 dV +=
//     bf16(P^T) dO and dK += bf16(dS^T) Q, summed in fp32 registers;
//   - the segment-tile skip (segment_tiles.cuh, shared with H2): the CTA
//     summarises its batch row's query and key tiles into a table in shared
//     memory, and only the tiles whose valid ids meet the item's are
//     streamed; H8 stops at the causal diagonal, H9 starts there. Masking
//     only on the tiles the producer flags (a segment edge, the diagonal,
//     padding, the end of the sequence);
//   - the longest items first: under causal masking H8's last query tiles
//     and H9's first key tiles see the most tiles;
//   - head dims 16, 32 and 64 are one chunk of that width; 80 is a 64-wide
//     chunk (128-byte swizzle) and a 16-wide one (32-byte swizzle); 128 is
//     two 64-wide chunks. Each chunk has its own TMA box, descriptors and
//     wgmma (the score products' k-steps, the gradient products' N).
// The GQA fold of H9 without atomics: one item is one key tile of the G =
// H / Hkv query heads of one kv head, split over a thread-block cluster of C
// CTAs (C <= min(G, 8); CTA r takes heads r, r + C, ... of the group in
// series). Each keeps its heads' dK and dV in fp32 registers, stages them in
// its own shared memory at the end (over its K/V and ring buffers), and
// after a cluster barrier CTA r sums its share of the 128 rows over the C
// CTAs' shared memory (distributed shared memory, as H4 does in int8_kv.cu)
// in rank order (cluster_fold.cuh), casts once and stores. Every sum is taken in one fixed
// order, so the gradients are the same bits from run to run. The launcher
// picks C: the fold's distributed reads bound it, so C is the smallest that
// still gives every SM a CTA (2 at the train step's shapes).
//
// Tensors: q, dO (B, Sq, H, HD), k, v (B, Sk, Hkv, HD) bf16 with unit last
// stride and other strides multiples of 8 elements; segment ids (B, S)
// int32; lse, delta (B, H, Sq) fp32, contiguous; outputs dq (B, Sq, H, HD),
// dk, dv (B, Sk, Hkv, HD) bf16, contiguous.
#include <cooperative_groups.h>

#include "cluster_fold.cuh"
#include "hopper.cuh"
#include "segment_tiles.cuh"

namespace padt {
namespace fbwd {

using namespace hopper;
using namespace segtiles;
namespace cg = cooperative_groups;

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 384;        // H8: a producer warpgroup + two consumer warpgroups
constexpr int kConsumers = 256;      // two consumer warpgroups (all of H9's threads)
constexpr int kProducerRegs = 40;    // H8: setmaxnreg of its producer warpgroup
constexpr int kConsumerRegs = 232;   // ... and of its consumers: 128 * 40 + 256 * 232 = 384 * 168
constexpr int kTable = 256;          // tile summaries a CTA keeps (its batch row's tiles)
constexpr int kMaxCluster = 8;       // the largest portable cluster
constexpr int kVec = 64;             // entries of one streamed tile's vector (LSE, delta or ids)
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Chunks {
  static constexpr int WA = HD < 64 ? HD : 64;  // first head-dim chunk
  static constexpr int WB = HD - WA;            // second chunk: 0, 16 or 64
  static constexpr int NB = WB > 0 ? WB / 2 : 1;  // accumulator registers of the second chunk
};

__host__ __device__ constexpr int align_up(int x, int a) { return (x + a - 1) / a * a; }

// fp32 accumulators of a 64 x N wgmma (rows 16 w + g + 8 hh) -> bf16 A
// fragments of the next product, k-step kk covering columns 16 kk .. + 15
template <int N>
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[N / 16][4], const float (&d)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16x2(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// D (64 x N) {+}= A (64 x 16) B (16 x N), both from K-major tiles
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int accumulate) {
  static_assert(N == 32 || N == 64, "wgmma N");
  if constexpr (N == 32) wgmma_ss_n32(d, da, db, accumulate);
  else wgmma_ss_n64(d, da, db, accumulate);
}

// The two score-like products of one 64 x N tile pair, S = A1 B1^T and
// P = A2 B2^T over the head-dim chunks, from K-major tiles: a* are this
// warpgroup's 64 rows, b* the N streamed rows, chunk A then chunk B.
template <int HD, int N>
__device__ __forceinline__ void score_products(float (&s)[N / 2], float (&p)[N / 2], const uint8_t* a1a, const uint8_t* a1b,
                                               const uint8_t* b1a, const uint8_t* b1b, const uint8_t* a2a,
                                               const uint8_t* a2b, const uint8_t* b2a, const uint8_t* b2b) {
  constexpr int WA = Chunks<HD>::WA, WB = Chunks<HD>::WB;
  wgmma_fence();
  {
    const uint64_t d1 = smem_desc_here<2 * WA>(a1a), e1 = smem_desc_here<2 * WA>(b1a);
    const uint64_t d2 = smem_desc_here<2 * WA>(a2a), e2 = smem_desc_here<2 * WA>(b2a);
#pragma unroll
    for (int kk = 0; kk < WA / 16; ++kk) {
      wgmma_ss<N>(s, desc_advance(d1, 32 * kk), desc_advance(e1, 32 * kk), kk > 0);
      wgmma_ss<N>(p, desc_advance(d2, 32 * kk), desc_advance(e2, 32 * kk), kk > 0);
    }
  }
  if constexpr (WB > 0) {
    const uint64_t d1 = smem_desc_here<2 * WB>(a1b), e1 = smem_desc_here<2 * WB>(b1b);
    const uint64_t d2 = smem_desc_here<2 * WB>(a2b), e2 = smem_desc_here<2 * WB>(b2b);
#pragma unroll
    for (int kk = 0; kk < WB / 16; ++kk) {
      wgmma_ss<N>(s, desc_advance(d1, 32 * kk), desc_advance(e1, 32 * kk), 1);
      wgmma_ss<N>(p, desc_advance(d2, 32 * kk), desc_advance(e2, 32 * kk), 1);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(p);
}

// D (64 x HD, chunks da / db) += A (64 x K, fragments a) B, B the K rows
// from row r0 of a tile read MN-major: a k16 step is 16 rows of it. No
// commit.
template <int HD, int K>
__device__ __forceinline__ void grad_product(float (&da)[Chunks<HD>::WA / 2], float (&db)[Chunks<HD>::NB],
                                             const uint32_t (&a)[K / 16][4], const uint8_t* ba, const uint8_t* bb,
                                             int r0) {
  constexpr int WA = Chunks<HD>::WA, WB = Chunks<HD>::WB;
  const uint64_t d = smem_desc_here<2 * WA>(ba + r0 * 2 * WA);
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) wgmma_rs<WA, 1>(da, a[kk], desc_advance(d, kk * 16 * 2 * WA));
  if constexpr (WB > 0) {
    const uint64_t e = smem_desc_here<2 * WB>(bb + r0 * 2 * WB);
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk) wgmma_rs<WB, 1>(db, a[kk], desc_advance(e, kk * 16 * 2 * WB));
  }
}

// ===========================================================================
// H9: dk, dv
// ===========================================================================

namespace dkv {

constexpr int BK = 128;  // keys per item: two consumer warpgroups of 64
constexpr int BQ = 64;   // query rows per ring stage
constexpr int BH = 32;   // ... taken in halves (S^T's N): the whole tile's S^T and dP^T do not fit beside dK, dV at hd 128

template <int HD>
struct Tiles {
  static constexpr int WA = Chunks<HD>::WA, WB = Chunks<HD>::WB;
  static constexpr int STAGES = HD > 80 ? 3 : 4;  // a fourth stage at hd 128 measured no faster
  // bytes; every tile region is a multiple of 1024, so every tile is atom-aligned
  static constexpr int K_A = BK * WA * 2, K_B = BK * WB * 2;
  static constexpr int KV_TILE = K_A + K_B;          // K (chunk A, chunk B), then V
  static constexpr int Q_A = BQ * WA * 2, Q_B = BQ * WB * 2;
  static constexpr int STAGE = 2 * (Q_A + Q_B);      // Q_A Q_B dO_A dO_B
  static constexpr int RING0 = 2 * KV_TILE;
  static constexpr int VEC0 = RING0 + STAGES * STAGE;  // float lse, delta, int q_seg [STAGES][3][kVec]
  static constexpr int PITCH = HD + 8;                  // fp32 row of the staged dK / dV (no bank conflicts)
  static constexpr int STAGED = 2 * BK * PITCH * 4;     // dK then dV, over the buffers above at the end
  static constexpr int DATA = align_up(VEC0 + STAGES * 3 * kVec * 4 > STAGED ? VEC0 + STAGES * 3 * kVec * 4 : STAGED, 1024);
  static constexpr int INFO0 = DATA;                    // int2 {first query row or -1 = end, masked}
  static constexpr int SUM0 = INFO0 + align_up(STAGES * 8, 16);  // int4 summaries[kTable]
  static constexpr int BAR0 = SUM0 + kTable * 16;       // kv_full, full[STAGES], empty[STAGES]
  static constexpr int SMEM = BAR0 + (1 + 2 * STAGES) * 8 + 1024;  // + alignment slack
};

struct Maps {
  CUtensorMap q[2], g[2], k[2], v[2];  // [0]: first head-dim chunk, [1]: second
};

struct Smem {
  uint8_t* kv;  // K, V; at the end the staged fp32 dK, dV
  uint8_t* ring;
  float* vec;
  int2* info;
  int4* sums;
  uint64_t* kv_full;
  uint64_t* full;
  uint64_t* empty;
};

// This CTA's item: key tile kt (the lowest first) of batch row b, kv head
// hk, and the query heads r, r + C, ... of hk's group of G, r the CTA's rank
// in its cluster of C.
struct Item {
  int r, C, G, hk, b, kt, k0;
  __device__ __forceinline__ Item(int H, int Hkv) {
    r = blockIdx.x, C = gridDim.x, G = H / Hkv;
    hk = blockIdx.y % Hkv, b = blockIdx.y / Hkv, kt = blockIdx.z, k0 = kt * BK;
  }
};

// The query tiles this CTA streams, found and loaded by warp 0 of the
// consumers: for each of the CTA's heads, every live query tile's Q and dO
// (TMA) and its LSE, delta and segment ids (the lanes' loads, 2 entries
// each: a TMA box of them would start unaligned), then an end marker. A
// query tile is live if its valid ids meet the key tile's, and, when
// causal, it reaches the key tile's first key. `find` runs a stage ahead
// of `put`, so that the lanes' loads are in flight while the warp computes.
struct Stream {
  int i, qt;      // the next head of the group and query tile to look at
  int h, q0;      // the tile found (q0 < 0: none left)
  bool plain;     // ... needs no mask
  float l[2], d[2];  // ... and this lane's LSE, delta, segment ids
  int sg[2];
};

template <bool CAUSAL>
__device__ __forceinline__ void find(Stream& st, const Tables& tb, const int4* sums, bool in_table, int4 ks,
                                     const Item& w, int H, const float* lse, const float* delta) {
  const int lane = threadIdx.x & 31;
  st.q0 = -1;
  for (; st.i < w.G; st.i += w.C, st.qt = CAUSAL ? w.k0 / BQ : 0) {
    for (; st.qt < tb.n_qt; ++st.qt) {
      const int4 qs = summary(tb, sums, in_table, st.qt);
      if (!meets(qs, ks)) continue;
      st.h = w.hk * w.G + st.i, st.q0 = st.qt * BQ;
      st.plain = one_segment(qs) && one_segment(ks) && qs.z == ks.z && (!CAUSAL || st.q0 >= w.k0 + BK - 1);
      const long long row = ((long long)w.b * H + st.h) * tb.Sq;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int p = st.q0 + lane + 32 * u;
        const bool in = p < tb.Sq;
        st.l[u] = in ? __ldg(lse + row + p) : 0.f;
        st.d[u] = in ? __ldg(delta + row + p) : 0.f;
        st.sg[u] = in ? __ldg(tb.q_seg + p) : -1;
      }
      ++st.qt;
      return;
    }
  }
}

// the tile found into ring slot `stage` (free), or the end marker
template <int HD>
__device__ __forceinline__ void put(const Stream& st, const Maps& maps, const Smem& sm, const Item& w, int stage) {
  using T = Tiles<HD>;
  const int lane = threadIdx.x & 31;
  if (st.q0 >= 0) {
    float* vec = sm.vec + stage * 3 * kVec;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      vec[lane + 32 * u] = st.l[u];
      vec[kVec + lane + 32 * u] = st.d[u];
      reinterpret_cast<int*>(vec)[2 * kVec + lane + 32 * u] = st.sg[u];
    }
  }
  __syncwarp();
  if (lane == 0) {
    if (st.q0 < 0) {
      sm.info[stage] = make_int2(-1, 0);
      mbar_arrive(&sm.full[stage]);
    } else {
      sm.info[stage] = make_int2(st.q0, st.plain ? 0 : 1);
      uint8_t* dst = sm.ring + stage * T::STAGE;
      uint64_t* bar = &sm.full[stage];
      mbar_arrive_expect_tx(bar, T::STAGE);
      tma_load_4d(dst, &maps.q[0], bar, 0, st.h, st.q0, w.b);
      tma_load_4d(dst + T::Q_A + T::Q_B, &maps.g[0], bar, 0, st.h, st.q0, w.b);
      if constexpr (T::WB > 0) {
        tma_load_4d(dst + T::Q_A, &maps.q[1], bar, T::WA, st.h, st.q0, w.b);
        tma_load_4d(dst + 2 * T::Q_A + T::Q_B, &maps.g[1], bar, T::WA, st.h, st.q0, w.b);
      }
    }
  }
  __syncwarp();
}

// One consumer warpgroup: its 64 keys against every query tile in the ring,
// dK and dV summed in fp32 registers; then staged in shared memory. Warp 0
// of the first also streams the tiles (Stream): the first STAGES before the
// loop, then one into each slot that all eight warps have released.
template <int HD, bool CAUSAL>
__device__ __forceinline__ void consume(const Maps& maps, const Smem& sm, const Tables& tb, bool in_table,
                                        const int* k_seg, const Item& w, int H, const float* lse_g,
                                        const float* delta_g, float scale) {
  const int Sq = tb.Sq, Sk = tb.Sk;
  using T = Tiles<HD>;
  constexpr int WA = T::WA, WB = T::WB, NB = Chunks<HD>::NB;
  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const float sl2 = scale * kLog2e;
  // this thread's two keys (accumulator rows g and g + 8 of its warp)
  int kpos[2], kseg[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    kpos[hh] = w.k0 + 64 * wg + 16 * warp + g + 8 * hh;
    kseg[hh] = kpos[hh] < Sk ? __ldg(k_seg + (long long)w.b * Sk + kpos[hh]) : -1;
  }
  float dka[WA / 2], dkb[NB], dva[WA / 2], dvb[NB];
  zero(dka), zero(dkb), zero(dva), zero(dvb);
  const uint8_t* ka = sm.kv + 64 * wg * 2 * WA;  // this warpgroup's 64 keys of each chunk
  const uint8_t* kb = sm.kv + T::K_A + 64 * wg * 2 * WB;
  const uint8_t* va = ka + T::KV_TILE;
  const uint8_t* vb = kb + T::KV_TILE;
  const bool streams = threadIdx.x < 32;
  bool more = true;  // warp 0: the end marker is not in the ring yet
  Stream st;
  int4 ks;
  if (streams) {
    ks = summary(tb, sm.sums, in_table, tb.n_q + w.kt);
    st.i = w.r, st.qt = CAUSAL ? w.k0 / BQ : 0;
    for (int i = 0; i < T::STAGES && more; ++i) {
      find<CAUSAL>(st, tb, sm.sums, in_table, ks, w, H, lse_g, delta_g);
      put<HD>(st, maps, sm, w, i);
      more = st.q0 >= 0;
    }
    if (more) find<CAUSAL>(st, tb, sm.sums, in_table, ks, w, H, lse_g, delta_g);
  }
  mbar_wait(sm.kv_full, 0);

  int stage = 0;
  uint32_t phase = 0;
  for (;;) {
    mbar_wait(&sm.full[stage], phase);
    const int2 info = sm.info[stage];
    if (info.x < 0) break;  // the end marker
    const int q0 = info.x;
    const uint8_t* qa = sm.ring + stage * T::STAGE;
    const uint8_t* qb = qa + T::Q_A;
    const uint8_t* ga = qb + T::Q_B;
    const uint8_t* gb = ga + T::Q_A;
    const float* lse = sm.vec + stage * 3 * kVec;
    const float* delta = lse + kVec;
    const int* qseg = reinterpret_cast<const int*>(lse + 2 * kVec);

    // each half of 32 queries: S^T = K Q^T and dP^T = V dO^T for this
    // warpgroup's 64 keys (half the registers of the whole tile), P^T and
    // dS^T in place, then dV += bf16(P^T) dO and dK += bf16(dS^T) Q
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r0 = BH * half;  // the half's first row of the Q / dO tiles
      float s[BH / 2], dp[BH / 2];
      score_products<HD, BH>(s, dp, ka, kb, qa + r0 * 2 * WA, qb + r0 * 2 * WB, va, vb, ga + r0 * 2 * WA,
                             gb + r0 * 2 * WB);
      // column 8j + 2t + e is query q0 + r0 + 8j + 2t + e
#pragma unroll
      for (int j = 0; j < BH / 8; ++j) {
        const int c = r0 + 8 * j + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(lse + c);
        const float2 d2 = *reinterpret_cast<const float2*>(delta + c);
        const int2 q2 = *reinterpret_cast<const int2*>(qseg + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = e & 1, hh = e >> 1;
          const float lq = x ? l2.y : l2.x, dq = x ? d2.y : d2.x;
          float p = exp2f(fmaf(s[4 * j + e], sl2, -lq * kLog2e));
          float ds = p * (dp[4 * j + e] - dq) * scale;
          if (info.y) {
            const int qp = q0 + c + x, qs = x ? q2.y : q2.x;
            bool ok = kseg[hh] >= 0 && qs == kseg[hh] && qp < Sq;
            if (CAUSAL) ok = ok && qp >= kpos[hh];
            if (!ok) p = 0.f, ds = 0.f;
          }
          s[4 * j + e] = p;
          dp[4 * j + e] = ds;
        }
      }
      uint32_t pa[BH / 16][4], da[BH / 16][4];
      to_a_frags<BH>(pa, s);
      to_a_frags<BH>(da, dp);

      fence_regs(dka), fence_regs(dkb), fence_regs(dva), fence_regs(dvb);
#pragma unroll
      for (int kk = 0; kk < BH / 16; ++kk) fence_regs(pa[kk]), fence_regs(da[kk]);
      wgmma_fence();
      grad_product<HD, BH>(dva, dvb, pa, ga, gb, r0);
      grad_product<HD, BH>(dka, dkb, da, qa, qb, r0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dka), fence_regs(dkb), fence_regs(dva), fence_regs(dvb);
    }
    if (lane == 0) mbar_arrive(&sm.empty[stage]);  // this warp has read the stage
    if (streams && more) {  // refill the slot once every warp has read it
      mbar_wait(&sm.empty[stage], phase);
      put<HD>(st, maps, sm, w, stage);
      more = st.q0 >= 0;
      if (more) find<CAUSAL>(st, tb, sm.sums, in_table, ks, w, H, lse_g, delta_g);
    }
    if (++stage == T::STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  // stage dK and dV as fp32 rows over the K/V and ring buffers, once both
  // warpgroups have read them for the last time
  named_barrier(1, kConsumers);
  float* stk = reinterpret_cast<float*>(sm.kv);
  float* stv = stk + BK * T::PITCH;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = 64 * wg + 16 * warp + g + 8 * hh;
#pragma unroll
    for (int n = 0; n < WA / 8; ++n) {
      *reinterpret_cast<float2*>(stk + row * T::PITCH + 8 * n + 2 * t) = make_float2(dka[4 * n + 2 * hh], dka[4 * n + 2 * hh + 1]);
      *reinterpret_cast<float2*>(stv + row * T::PITCH + 8 * n + 2 * t) = make_float2(dva[4 * n + 2 * hh], dva[4 * n + 2 * hh + 1]);
    }
    if constexpr (WB > 0) {
#pragma unroll
      for (int n = 0; n < WB / 8; ++n) {
        *reinterpret_cast<float2*>(stk + row * T::PITCH + WA + 8 * n + 2 * t) = make_float2(dkb[4 * n + 2 * hh], dkb[4 * n + 2 * hh + 1]);
        *reinterpret_cast<float2*>(stv + row * T::PITCH + WA + 8 * n + 2 * t) = make_float2(dvb[4 * n + 2 * hh], dvb[4 * n + 2 * hh + 1]);
      }
    }
  }
}

// After the cluster barrier: CTA r sums rows [r * R, (r + 1) * R) of the
// staged dK and dV over the cluster's CTAs in rank order, casts them to
// bf16 once and stores them (8 columns, 16 bytes, per step).
template <int HD>
__device__ __forceinline__ void fold(const Smem& sm, const Item& w, int Sk, int Hkv, bf16* dk, bf16* dv) {
  using T = Tiles<HD>;
  cg::cluster_group cluster = cg::this_cluster();
  const int R = (BK + w.C - 1) / w.C;
  const int r0 = w.r * R, n_rows = min(BK, r0 + R) - r0;
  constexpr int COLS = HD / 8;
  float* stk = reinterpret_cast<float*>(sm.kv);
  for (int i = threadIdx.x; i < 2 * n_rows * COLS; i += kConsumers) {
    const int which = i / (n_rows * COLS), rem = i % (n_rows * COLS);
    const int row = r0 + rem / COLS, c8 = 8 * (rem % COLS);
    const int key = w.k0 + row;
    if (key >= Sk) continue;
    float* src = stk + which * BK * T::PITCH + row * T::PITCH + c8;
    float acc[8];
    fold::fold8(cluster, src, w.C, acc);
    uint4 out;
    out.x = pack_bf16x2(acc[0], acc[1]), out.y = pack_bf16x2(acc[2], acc[3]);
    out.z = pack_bf16x2(acc[4], acc[5]), out.w = pack_bf16x2(acc[6], acc[7]);
    bf16* dst = (which ? dv : dk) + (((long long)w.b * Sk + key) * Hkv + w.hk) * HD + c8;
    *reinterpret_cast<uint4*>(dst) = out;
  }
}

// Grid (C, Hkv * B, ceil(Sk / 128)) in clusters of (C, 1, 1). Two
// warpgroups and no producer warp: each of the SM's four register files
// then holds two warps, so a thread may have 255 registers, which the
// consumers need at hd 128 (dK and dV take 128 of them). A ninth warp
// leaves 168; with a producer warpgroup and setmaxnreg, ptxas spilled
// them all the same.
template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(kConsumers, 1)
    dkv_kernel(const __grid_constant__ Maps maps, const int* __restrict__ q_seg, const int* __restrict__ k_seg,
               const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dk,
               bf16* __restrict__ dv, int Sq, int Sk, int H, int Hkv, float scale) {
  using T = Tiles<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  Smem sm;
  sm.kv = base;
  sm.ring = base + T::RING0;
  sm.vec = reinterpret_cast<float*>(base + T::VEC0);
  sm.info = reinterpret_cast<int2*>(base + T::INFO0);
  sm.sums = reinterpret_cast<int4*>(base + T::SUM0);
  sm.kv_full = reinterpret_cast<uint64_t*>(base + T::BAR0);
  sm.full = sm.kv_full + 1;
  sm.empty = sm.full + T::STAGES;
  const Item w(H, Hkv);
  // the table: this batch row's query tiles of 64, then its key tiles of 128
  const Tables tb(q_seg + (long long)w.b * Sq, k_seg + (long long)w.b * Sk, Sq, Sk, BQ, BK, 1);
  const bool in_table = tb.n_all <= kTable;

  if (threadIdx.x == 0) {
    mbar_init(sm.kv_full, 1);
    for (int i = 0; i < T::STAGES; ++i) {
      mbar_init(&sm.full[i], 1);   // warp 0's arrive (+ the TMA bytes)
      mbar_init(&sm.empty[i], 8);  // one arrive per consumer warp
    }
    fence_barrier_init();
    // the item's K and V, while the table fills
    mbar_arrive_expect_tx(sm.kv_full, 2 * T::KV_TILE);
    tma_load_4d(sm.kv, &maps.k[0], sm.kv_full, 0, w.hk, w.k0, w.b);
    tma_load_4d(sm.kv + T::KV_TILE, &maps.v[0], sm.kv_full, 0, w.hk, w.k0, w.b);
    if constexpr (T::WB > 0) {
      tma_load_4d(sm.kv + T::K_A, &maps.k[1], sm.kv_full, T::WA, w.hk, w.k0, w.b);
      tma_load_4d(sm.kv + T::KV_TILE + T::K_A, &maps.v[1], sm.kv_full, T::WA, w.hk, w.k0, w.b);
    }
  }
  if (in_table) fill_table(tb, sm.sums, threadIdx.x >> 5, kConsumers / 32);
  __syncthreads();

  cg::cluster_group cluster = cg::this_cluster();
  consume<HD, CAUSAL>(maps, sm, tb, in_table, k_seg, w, H, lse, delta, scale);
  cluster.sync();  // every CTA has staged its dK, dV
  fold<HD>(sm, w, Sk, Hkv, dk, dv);
  cluster.sync();  // ... and every CTA has read them
}

}  // namespace dkv

// ===========================================================================
// H8: dq
// ===========================================================================

namespace dq {

constexpr int BM = 128;  // query rows per item: two consumer warpgroups of 64
constexpr int BN = 64;   // keys per ring stage: S's N

template <int HD>
struct Tiles {
  static constexpr int WA = Chunks<HD>::WA, WB = Chunks<HD>::WB;
  static constexpr int STAGES = HD > 80 ? 3 : 4;
  // bytes; every tile region is a multiple of 1024, so every tile is atom-aligned
  static constexpr int Q_A = BM * WA * 2, Q_B = BM * WB * 2;
  static constexpr int Q_BYTES = Q_A + Q_B;          // Q (chunk A, chunk B), then dO
  static constexpr int T_A = BN * WA * 2, T_B = BN * WB * 2;
  static constexpr int STAGE = 2 * (T_A + T_B);      // K_A K_B V_A V_B
  static constexpr int RING0 = 2 * Q_BYTES;
  static constexpr int SEG0 = RING0 + STAGES * STAGE;  // int k_seg[STAGES][kVec]
  static constexpr int INFO0 = SEG0 + STAGES * kVec * 4;  // int2 {first key or -1 = end, masked}
  static constexpr int SUM0 = INFO0 + align_up(STAGES * 8, 16);  // int4 summaries[kTable]
  static constexpr int BAR0 = SUM0 + kTable * 16;    // q_full, full[STAGES], empty[STAGES]
  static constexpr int SMEM = BAR0 + (1 + 2 * STAGES) * 8 + 1024;  // + alignment slack
};

struct Maps {
  CUtensorMap q[2], g[2], k[2], v[2], o[2];  // [0]: first head-dim chunk, [1]: second
};

struct Smem {
  uint8_t* q;  // Q, then dO; each consumer's Q rows also stage its dQ
  uint8_t* ring;
  int* seg;
  int2* info;
  int4* sums;
  uint64_t* q_full;
  uint64_t* full;
  uint64_t* empty;
};

// This CTA's item: query tile qt (the last first) of head h of batch row b;
// the head is the fastest index, so the items that share a kv head run side
// by side and share its K/V tiles through L2.
struct Item {
  int h, b, qt, q0, hk;
  __device__ __forceinline__ Item(int H, int Hkv, int B, int n_qt) {
    const int i = blockIdx.x, hb = H * B;
    qt = n_qt - 1 - i / hb, q0 = qt * BM;
    b = (i % hb) / H, h = i % H, hk = h / (H / Hkv);
  }
};

// Warp 0 of the producer warpgroup: every live key tile's K and V (TMA)
// and, for a tile to mask, its segment ids (the lanes' loads) into the
// ring, then an end marker. A key tile is live if its valid
// ids meet the query tile's, and, when causal, it starts at or before the
// query tile's last row.
template <int HD, bool CAUSAL>
__device__ __forceinline__ void produce(const Maps& maps, const Smem& sm, const Tables& tb, bool in_table,
                                        const Item& w) {
  using T = Tiles<HD>;
  const int lane = threadIdx.x & 31;
  const int4 qs = summary(tb, sm.sums, in_table, w.qt);
  int n_kt = tb.n_kt;
  if (CAUSAL) n_kt = min(n_kt, (w.q0 + BM - 1) / BN + 1);
  int stage = 0;
  uint32_t phase = 0;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int4 ks = summary(tb, sm.sums, in_table, tb.n_q + kt);
    if (!meets(ks, qs)) continue;
    const int k0 = kt * BN;
    const bool plain = one_segment(qs) && one_segment(ks) && qs.z == ks.z && (!CAUSAL || k0 + BN - 1 <= w.q0);
    int sg[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int p = k0 + lane + 32 * u;
      sg[u] = !plain && p < tb.Sk ? __ldg(tb.k_seg + p) : -1;
    }
    mbar_wait(&sm.empty[stage], phase ^ 1);
    if (!plain) {  // the consumers mask this tile by its keys' ids
#pragma unroll
      for (int u = 0; u < 2; ++u) sm.seg[stage * kVec + lane + 32 * u] = sg[u];
    }
    __syncwarp();
    if (lane == 0) {
      sm.info[stage] = make_int2(k0, plain ? 0 : 1);
      uint8_t* st = sm.ring + stage * T::STAGE;
      uint64_t* bar = &sm.full[stage];
      mbar_arrive_expect_tx(bar, T::STAGE);
      tma_load_4d(st, &maps.k[0], bar, 0, w.hk, k0, w.b);
      tma_load_4d(st + T::T_A + T::T_B, &maps.v[0], bar, 0, w.hk, k0, w.b);
      if constexpr (T::WB > 0) {
        tma_load_4d(st + T::T_A, &maps.k[1], bar, T::WA, w.hk, k0, w.b);
        tma_load_4d(st + 2 * T::T_A + T::T_B, &maps.v[1], bar, T::WA, w.hk, k0, w.b);
      }
    }
    __syncwarp();
    if (++stage == T::STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  mbar_wait(&sm.empty[stage], phase ^ 1);
  if (lane == 0) {
    sm.info[stage] = make_int2(-1, 0);
    mbar_arrive(&sm.full[stage]);
  }
}

// One consumer warpgroup: its 64 query rows against every key tile the
// producer delivers, dQ summed in fp32 registers, then stored by TMA from
// its rows of the Q buffer.
template <int HD, bool CAUSAL>
__device__ __forceinline__ void consume(const Maps& maps, const Smem& sm, const int* q_seg, const float* lse,
                                        const float* delta, const Item& w, int Sq, int Sk, int H, float scale) {
  using T = Tiles<HD>;
  constexpr int WA = T::WA, WB = T::WB, NB = Chunks<HD>::NB;
  const int wg = (threadIdx.x >> 7) - 1;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const float sl2 = scale * kLog2e;
  // this thread's two query rows (accumulator rows g and g + 8 of its warp)
  int qpos[2], qseg[2];
  float nlse[2], dlt[2];
  const long long row0 = ((long long)w.b * H + w.h) * Sq;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    qpos[hh] = w.q0 + 64 * wg + 16 * warp + g + 8 * hh;
    const bool in = qpos[hh] < Sq;
    qseg[hh] = in ? __ldg(q_seg + (long long)w.b * Sq + qpos[hh]) : -1;
    nlse[hh] = in ? -__ldg(lse + row0 + qpos[hh]) * kLog2e : 0.f;
    dlt[hh] = in ? __ldg(delta + row0 + qpos[hh]) : 0.f;
  }
  float dqa[WA / 2], dqb[NB];
  zero(dqa), zero(dqb);
  uint8_t* qa = sm.q + 64 * wg * 2 * WA;  // this warpgroup's 64 rows of each chunk
  uint8_t* qb = sm.q + T::Q_A + 64 * wg * 2 * WB;
  const uint8_t* ga = qa + T::Q_BYTES;
  const uint8_t* gb = qb + T::Q_BYTES;
  mbar_wait(sm.q_full, 0);

  int stage = 0;
  uint32_t phase = 0;
  for (;;) {
    mbar_wait(&sm.full[stage], phase);
    const int2 info = sm.info[stage];
    if (info.x < 0) break;  // the end marker
    const int k0 = info.x;
    const uint8_t* ka = sm.ring + stage * T::STAGE;
    const uint8_t* kb = ka + T::T_A;
    const uint8_t* va = kb + T::T_B;
    const uint8_t* vb = va + T::T_A;
    const int* seg = sm.seg + stage * kVec;

    // S = Q K^T and dP = dO V^T: this warpgroup's 64 rows x the 64 keys
    float s[BN / 2], dp[BN / 2];
    score_products<HD, BN>(s, dp, qa, qb, ka, kb, ga, gb, va, vb);

    // dS in place; column 8j + 2t + e is key k0 + 8j + 2t + e
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = 8 * j + 2 * t;
      const int2 k2 = *reinterpret_cast<const int2*>(seg + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = e & 1, hh = e >> 1;
        const float p = exp2f(fmaf(s[4 * j + e], sl2, nlse[hh]));
        float ds = p * (dp[4 * j + e] - dlt[hh]) * scale;
        if (info.y) {
          const int kp = k0 + c + x, ks = x ? k2.y : k2.x;
          bool ok = ks >= 0 && ks == qseg[hh] && kp < Sk;
          if (CAUSAL) ok = ok && qpos[hh] >= kp;
          if (!ok) ds = 0.f;
        }
        dp[4 * j + e] = ds;
      }
    }
    uint32_t da[BN / 16][4];
    to_a_frags<BN>(da, dp);

    // dQ += bf16(dS) K over the tile's 64 keys
    fence_regs(dqa), fence_regs(dqb);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) fence_regs(da[kk]);
    wgmma_fence();
    grad_product<HD, BN>(dqa, dqb, da, ka, kb, 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dqa), fence_regs(dqb);
    if (lane == 0) mbar_arrive(&sm.empty[stage]);  // this warp has read the stage
    if (++stage == T::STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  // dQ as bf16 into this warpgroup's rows of the Q buffer (their last
  // reader, its last S wgmma, has completed), swizzled as TMA stores them
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = 16 * warp + g + 8 * hh;
#pragma unroll
    for (int n = 0; n < WA / 8; ++n)
      *reinterpret_cast<uint32_t*>(qa + swizzle<2 * WA>(row * 2 * WA + (8 * n + 2 * t) * 2)) =
          pack_bf16x2(dqa[4 * n + 2 * hh], dqa[4 * n + 2 * hh + 1]);
    if constexpr (WB > 0) {
#pragma unroll
      for (int n = 0; n < WB / 8; ++n)
        *reinterpret_cast<uint32_t*>(qb + swizzle<2 * WB>(row * 2 * WB + (8 * n + 2 * t) * 2)) =
            pack_bf16x2(dqb[4 * n + 2 * hh], dqb[4 * n + 2 * hh + 1]);
    }
  }
  fence_proxy_async();
  named_barrier(1 + wg, 128);
  if (tid == 0) {  // rows past Sq are not written
    tma_store_4d(&maps.o[0], qa, 0, w.h, w.q0 + 64 * wg, w.b);
    if constexpr (WB > 0) tma_store_4d(&maps.o[1], qb, WA, w.h, w.q0 + 64 * wg, w.b);
    tma_store_commit();
    tma_store_wait_read();
  }
}

// Grid (ceil(Sq / 128) * H * B): one CTA per item.
template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1)
    dq_kernel(const __grid_constant__ Maps maps, const int* __restrict__ q_seg, const int* __restrict__ k_seg,
              const float* __restrict__ lse, const float* __restrict__ delta, int Sq, int Sk, int H, int Hkv,
              int B, float scale) {
  using T = Tiles<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  Smem sm;
  sm.q = base;
  sm.ring = base + T::RING0;
  sm.seg = reinterpret_cast<int*>(base + T::SEG0);
  sm.info = reinterpret_cast<int2*>(base + T::INFO0);
  sm.sums = reinterpret_cast<int4*>(base + T::SUM0);
  sm.q_full = reinterpret_cast<uint64_t*>(base + T::BAR0);
  sm.full = sm.q_full + 1;
  sm.empty = sm.full + T::STAGES;
  const Item w(H, Hkv, B, (Sq + BM - 1) / BM);
  // the table: this batch row's query tiles of 128, then its key tiles of 64
  const Tables tb(q_seg + (long long)w.b * Sq, k_seg + (long long)w.b * Sk, Sq, Sk, BM, BN, 1);
  const bool in_table = tb.n_all <= kTable;

  if (threadIdx.x == 0) {
    mbar_init(sm.q_full, 1);
    for (int i = 0; i < T::STAGES; ++i) {
      mbar_init(&sm.full[i], 1);   // the producer's arrive (+ the TMA bytes)
      mbar_init(&sm.empty[i], 8);  // one arrive per consumer warp
    }
    fence_barrier_init();
    // the item's Q and dO, while the table fills
    mbar_arrive_expect_tx(sm.q_full, 2 * T::Q_BYTES);
    tma_load_4d(sm.q, &maps.q[0], sm.q_full, 0, w.h, w.q0, w.b);
    tma_load_4d(sm.q + T::Q_BYTES, &maps.g[0], sm.q_full, 0, w.h, w.q0, w.b);
    if constexpr (T::WB > 0) {
      tma_load_4d(sm.q + T::Q_A, &maps.q[1], sm.q_full, T::WA, w.h, w.q0, w.b);
      tma_load_4d(sm.q + T::Q_BYTES + T::Q_A, &maps.g[1], sm.q_full, T::WA, w.h, w.q0, w.b);
    }
  }
  if (in_table) fill_table(tb, sm.sums, threadIdx.x >> 5, kThreads / 32);
  __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < 32) produce<HD, CAUSAL>(maps, sm, tb, in_table, w);
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    consume<HD, CAUSAL>(maps, sm, q_seg, lse, delta, w, Sq, Sk, H, scale);
  }
}

}  // namespace dq

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *g, *q_seg, *k_seg, *lse, *delta;
  int B, Sq, Sk, H, Hkv, hd;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, g_sb, g_ss, g_sh;
  float scale;
  cudaStream_t stream;
};

// TMA maps of the four bf16 inputs by head-dim chunk: q and dO in boxes of
// q_rows rows, k and v in boxes of k_rows
static int encode_inputs(const Args& a, CUtensorMap (&q)[2], CUtensorMap (&g)[2], CUtensorMap (&k)[2],
                         CUtensorMap (&v)[2], int q_rows, int k_rows) {
  const int wa = a.hd < 64 ? a.hd : 64, wb = a.hd - wa;
  int rc = 0;
  for (int c = 0; c < (wb > 0 ? 2 : 1) && rc == 0; ++c) {
    const int w = c == 0 ? wa : wb;
    rc = hopper::encode_bf16_4d(&q[c], a.q, a.hd, a.H, a.Sq, a.B, a.q_sh, a.q_ss, a.q_sb, w, q_rows);
    if (rc == 0) rc = hopper::encode_bf16_4d(&g[c], a.g, a.hd, a.H, a.Sq, a.B, a.g_sh, a.g_ss, a.g_sb, w, q_rows);
    if (rc == 0) rc = hopper::encode_bf16_4d(&k[c], a.k, a.hd, a.Hkv, a.Sk, a.B, a.k_sh, a.k_ss, a.k_sb, w, k_rows);
    if (rc == 0) rc = hopper::encode_bf16_4d(&v[c], a.v, a.hd, a.Hkv, a.Sk, a.B, a.v_sh, a.v_ss, a.v_sb, w, k_rows);
  }
  return rc;
}

template <int HD>
static int launch_dq(const Args& a, bool causal, bf16* out) {
  dq::Maps maps = {};
  int rc = encode_inputs(a, maps.q, maps.g, maps.k, maps.v, dq::BM, dq::BN);
  const int wa = Chunks<HD>::WA, wb = Chunks<HD>::WB;
  const long long o_ss = (long long)a.H * HD, o_sb = (long long)a.Sq * a.H * HD;
  if (rc == 0) rc = hopper::encode_bf16_4d(&maps.o[0], out, HD, a.H, a.Sq, a.B, HD, o_ss, o_sb, wa, dq::BM / 2);
  if (rc == 0 && wb > 0) rc = hopper::encode_bf16_4d(&maps.o[1], out, HD, a.H, a.Sq, a.B, HD, o_ss, o_sb, wb, dq::BM / 2);
  if (rc != 0) return rc;
  constexpr int smem = dq::Tiles<HD>::SMEM;
  auto kernel = causal ? dq::dq_kernel<HD, true> : dq::dq_kernel<HD, false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const long long n_items = (long long)((a.Sq + dq::BM - 1) / dq::BM) * a.H * a.B;
  kernel<<<(unsigned)n_items, kThreads, smem, a.stream>>>(maps, static_cast<const int*>(a.q_seg),
                                                         static_cast<const int*>(a.k_seg),
                                                         static_cast<const float*>(a.lse),
                                                         static_cast<const float*>(a.delta), a.Sq, a.Sk, a.H,
                                                         a.Hkv, a.B, a.scale);
  return (int)cudaGetLastError();
}

template <int HD>
static int launch_dkv(const Args& a, bool causal, bf16* dk, bf16* dv) {
  dkv::Maps maps = {};
  const int rc = encode_inputs(a, maps.q, maps.g, maps.k, maps.v, dkv::BQ, dkv::BK);
  if (rc != 0) return rc;
  constexpr int smem = dkv::Tiles<HD>::SMEM;
  auto kernel = causal ? dkv::dkv_kernel<HD, true> : dkv::dkv_kernel<HD, false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  // the cluster: the smallest power of two of CTAs per (key tile, kv head)
  // that gives every SM a CTA, at most G and 8. The fold reads (C - 1) / C
  // of each CTA's 128 staged rows through distributed shared memory, which
  // bounds it: the smaller C, the faster H9 at the train shapes (PERF.md
  // section 6 has C = 8 / 4 / 2 timed on an H100)
  int dev = 0, n_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int G = a.H / a.Hkv, n_kt = (a.Sk + dkv::BK - 1) / dkv::BK;
  const long long base = (long long)a.Hkv * a.B * n_kt;
  int C = 1;
  while (C < G && C < kMaxCluster && base * C < n_sm) C *= 2;
  if (C > G) C = G;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, a.Hkv * a.B, n_kt);
  cfg.blockDim = dim3(kConsumers);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, maps, static_cast<const int*>(a.q_seg), static_cast<const int*>(a.k_seg),
                         static_cast<const float*>(a.lse), static_cast<const float*>(a.delta), dk, dv, a.Sq, a.Sk,
                         a.H, a.Hkv, a.scale);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace fbwd
}  // namespace padt

// C entry points (loaded with ctypes). strides: q_sb, q_ss, q_sh, k_sb, k_ss,
// k_sh, v_sb, v_ss, v_sh, g_sb, g_ss, g_sh in elements. Each returns the
// CUDA error of the launch, or an error code for a head dim it was not built
// for or a view TMA cannot take.
#define PADT_BWD_ARGS                                                                        \
  const void *q, const void *k, const void *v, const void *g, const void *q_seg,             \
      const void *k_seg, const void *lse, const void *delta
#define PADT_BWD_DIMS                                                                        \
  int B, int Sq, int Sk, int H, int Hkv, int hd, long long q_sb, long long q_ss,             \
      long long q_sh, long long k_sb, long long k_ss, long long k_sh, long long v_sb,        \
      long long v_ss, long long v_sh, long long g_sb, long long g_ss, long long g_sh,        \
      int causal, float scale, void *stream
#define PADT_BWD_PACK                                                                        \
  const padt::fbwd::Args a{q,    k,    v,    g,    q_seg, k_seg, lse,  delta, B,    Sq,      \
                           Sk,   H,    Hkv,  hd,   q_sb,  q_ss,  q_sh, k_sb,  k_ss, k_sh,    \
                           v_sb, v_ss, v_sh, g_sb, g_ss,  g_sh,  scale, static_cast<cudaStream_t>(stream)}

extern "C" int padt_flash_bwd_dq(PADT_BWD_ARGS, void* dq, PADT_BWD_DIMS) {
  using namespace padt::fbwd;
  if (B == 0 || Sq == 0 || H == 0) return 0;
  PADT_BWD_PACK;
  auto o = static_cast<bf16*>(dq);
  if (Sk == 0)  // no key: dq is 0
    return (int)cudaMemsetAsync(o, 0, (size_t)B * Sq * H * hd * 2, a.stream);
  switch (hd) {
    case 16: return launch_dq<16>(a, causal, o);
    case 32: return launch_dq<32>(a, causal, o);
    case 64: return launch_dq<64>(a, causal, o);
    case 80: return launch_dq<80>(a, causal, o);
    case 128: return launch_dq<128>(a, causal, o);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int padt_flash_bwd_dkv(PADT_BWD_ARGS, void* dk, void* dv, PADT_BWD_DIMS) {
  using namespace padt::fbwd;
  if (B == 0 || Sk == 0 || Hkv == 0) return 0;
  PADT_BWD_PACK;
  auto ok = static_cast<bf16*>(dk);
  auto ov = static_cast<bf16*>(dv);
  if (Sq == 0 || H == 0) {  // no query: dk and dv are 0
    const size_t n = (size_t)B * Sk * Hkv * hd * 2;
    cudaError_t e = cudaMemsetAsync(ok, 0, n, a.stream);
    return (int)(e == cudaSuccess ? cudaMemsetAsync(ov, 0, n, a.stream) : e);
  }
  switch (hd) {
    case 16: return launch_dkv<16>(a, causal, ok, ov);
    case 32: return launch_dkv<32>(a, causal, ok, ov);
    case 64: return launch_dkv<64>(a, causal, ok, ov);
    case 80: return launch_dkv<80>(a, causal, ok, ov);
    case 128: return launch_dkv<128>(a, causal, ok, ov);
    default: return (int)cudaErrorInvalidValue;
  }
}
