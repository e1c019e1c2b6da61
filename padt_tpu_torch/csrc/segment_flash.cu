// H2 segment_flash_fwd: segment-id flash attention forward, causal or not,
// with a GQA head map, written for Hopper (sm_90a): wgmma, a TMA ring of K/V
// stages, and an in-kernel segment-tile skip.
//
// Replaces, in padt_tpu/ops/pallas_attention.py:
//   _fwd_kernel :65      causal GQA text prefill, and its return_lse output
//   _vis_fwd_kernel :769 the vision tower's full-attention layers
//   _kblock_ranges :139  the k-block range both loop over
// Key c is visible to query r iff q_seg[r] == k_seg[c] && k_seg[c] >= 0, and
// r >= c when causal. Query head h reads kv head h / (H / Hkv). fp32 online
// softmax in base 2 (scale * log2 e folded into the exponent); a row with no
// visible key returns 0 (the TPU kernels' l > 0 guard). With a non-null
// `lse` it also writes each row's natural-log m + log(l) of the scaled
// scores into lse (B, H, Sq) fp32, and 1e30 for a row with no visible key,
// so that exp(s - lse) is exactly 0 there in the backward (H8/H9).
//
// Bound on the H100: tensor-core operations (4 * hd per visible pair and
// head against 989 TFLOP/s; the bytes are 10-20x below that at the main
// path's shapes). The design:
//   - a warp-specialised CTA of three warpgroups: warp 0 of the first issues
//     every TMA copy (setmaxnreg 56); the other two each own 64 of the CTA's
//     128 query rows, wgmma's M (setmaxnreg 224);
//   - a ring of STAGES K/V stages of 128 keys, each with a full and an empty
//     mbarrier, so that the next tiles' copies overlap this tile's math;
//   - S = Q K^T by SS-wgmma m64n128k16 on the tiles as TMA writes them (K is
//     K-major, no transpose); O += P V by RS-wgmma, P the bf16 of S's
//     accumulator kept in registers, V read MN-major (the transpose bit);
//   - masking only on the tiles that straddle a segment edge, the diagonal,
//     padding or the end of the keys: the producer flags them;
//   - the segment-tile skip: the producer warpgroup first summarises the
//     segment ids of every 128-row query and key tile into a table in shared
//     memory (lowest and highest valid id, and whether all are one valid id;
//     all loads in flight), and the producer loads a key tile only if its
//     valid ids [lo, hi] meet the query tile's: JAX's per-block intersection
//     test, without its closure into one [lo, hi) range. The visited tiles
//     hold every visible pair and lie inside _kblock_ranges's range at the
//     same blocks (`segment_tiles_plain` in ops/cuda_attention.py states the
//     rule in PyTorch). No extra launch, no host work;
//   - persistent CTAs, at most one per SM, walk the work items (query tile,
//     head, batch row) with two Q buffers: the producer loads the next
//     item's Q and first K/V tiles while the consumers finish this one and
//     store its output from its Q buffer (what a CTA with a single live tile
//     of the window layout would otherwise wait for). Causal items stop at
//     the diagonal tile, and the longest query tiles come first;
//   - head dims 16, 32 and 64 are one tile of that width; 80 is a 64-wide
//     chunk (128-byte swizzle) and a 16-wide one (32-byte swizzle); 128 is
//     two 64-wide chunks. Each chunk has its own TMA box, descriptor and
//     wgmma (S's k-steps, P V's N).
// GQA: one query head per work item, chosen by measurement. The G = H / Hkv
// items that read one kv head are consecutive, so they run side by side and
// share its K/V tiles through L2. Packing the G heads into one 128-row item
// (16 positions x G = 8 at 3B; G = 7 at 7B does not divide 128) streams as
// many key tiles per item over as many items, so it could save only K/V
// reads from HBM. chip_smoke's [gqa] lines bound that: H2 with K/V already
// in L2 ("warm") against K/V read from HBM ("cold") differs by 1-2% (3B
// prefill 2x640: 0.0180 / 0.0182 ms; train 8x704 with LSE: 0.0656 / 0.0663;
// 7B prefill 4x640: 0.0448 / 0.0456; NVIDIA H100 80GB HBM3, 700 W), while
// G = 1 (G times the distinct K/V bytes) costs 3-21% more. So packing is not
// done: it pays where a head has fewer than 128 query rows, which H2 never
// gets on the main path.
//
// Layout: q (B, Sq, H, HD), k/v (B, Sk, Hkv, HD) with unit last stride and
// every other stride a multiple of 8 elements (16 bytes, as TMA requires),
// so q/k/v can be views of the fused vision qkv buffer. Rows past Sq / Sk
// read as 0 and count as segment -1. out is contiguous (B, Sq, H, HD),
// written from shared memory by TMA stores.
#include <climits>

#include "hopper.cuh"

namespace padt {
namespace sflash {

using namespace hopper;

constexpr int BM = 128;        // query rows per work item: two consumer warpgroups of 64
constexpr int BN = 128;        // keys per tile: S is one m64n128k16 wgmma per k-step
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kTable = 1024;   // tile summaries a CTA keeps in shared memory
constexpr int kSumBatch = 8;   // tiles a producer warp summarises per round of loads
constexpr float kBigLse = 1e30f;  // a row with no visible key; flash_bwd.cu reads it as such
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Tiles {
  static constexpr int WA = HD < 64 ? HD : 64;  // first head-dim chunk
  static constexpr int WB = HD - WA;            // second chunk: 0, 16 or 64
  static constexpr int STAGES = HD > 80 ? 2 : 3;
  // bytes; every region is a multiple of 1024, so every tile is atom-aligned
  static constexpr int Q_A = BM * WA * 2, Q_B = BM * WB * 2;
  static constexpr int Q_BYTES = Q_A + Q_B;                   // one Q buffer: chunk A, chunk B
  static constexpr int T_A = BN * WA * 2, T_B = BN * WB * 2;  // one K or V tile's chunks
  static constexpr int STAGE = 2 * (T_A + T_B);                // K_A K_B V_A V_B
  static constexpr int KV0 = 2 * Q_BYTES;                      // after the two Q buffers
  static constexpr int SEG0 = KV0 + STAGES * STAGE;            // int k_seg[STAGES][BN]
  static constexpr int INFO0 = SEG0 + STAGES * BN * 4;         // int2 {first key or -1 = end, masked}
  static constexpr int SUM0 = INFO0 + (STAGES * 8 + 15) / 16 * 16;  // int4 summaries[kTable]
  static constexpr int BAR0 = SUM0 + kTable * 16;  // full[STAGES], empty[STAGES], q_full[2], q_empty[2]
  static constexpr int SMEM = BAR0 + (2 * STAGES + 4) * 8 + 1024;  // + alignment slack
};

struct Maps {
  CUtensorMap q[2], k[2], v[2], o[2];  // [0]: first head-dim chunk, [1]: second
};

struct Smem {
  uint8_t* q;  // two Q buffers; each consumer's rows also stage its output
  uint8_t* kv;
  int* seg;
  int2* info;
  int4* sums;
  uint64_t* full;
  uint64_t* empty;
  uint64_t* q_full;
  uint64_t* q_empty;
};

// The work items, longest causal query tiles first; the head is the fastest
// index, so the items that share a kv head run side by side.
struct Item {
  int h, b, qt, q0;
  __device__ __forceinline__ Item(int i, int H, int B, int n_qt) {
    const int hb = H * B;
    qt = n_qt - 1 - i / hb;
    q0 = qt * BM;
    b = (i % hb) / H;
    h = i % H;
  }
};

// The r-th item of this CTA, in snake order over the CTAs (c, 2G - 1 - c,
// 2G + c, ...), so that the CTAs that take the longest items first take the
// shortest next; n_items or more when there is none.
__device__ __forceinline__ int item_of(int r) {
  return r * gridDim.x + ((r & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}

// A warp's summary of the segment ids seg[p0, p0 + 128), those at or past
// n counting as -1: {lowest valid id (INT_MAX if none), highest id (-1 if
// none is valid), lowest id (-1 if any is padding)}. v holds this lane's
// four ids, p0 + lane + 32 r.
__device__ __forceinline__ int4 summarize(const int (&v)[4]) {
  int lo = INT_MAX, hi = -1, lo_all = INT_MAX;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    lo_all = min(lo_all, v[r]);
    hi = max(hi, v[r]);
    if (v[r] >= 0) lo = min(lo, v[r]);
  }
  return make_int4(__reduce_min_sync(0xffffffffu, lo), __reduce_max_sync(0xffffffffu, hi),
                   __reduce_min_sync(0xffffffffu, lo_all), 0);
}

__device__ __forceinline__ void load_ids(int (&v)[4], const int* seg, int p0, int n, bool any) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int p = p0 + lane + 32 * r;
    v[r] = any && p < n ? __ldg(seg + p) : -1;
  }
}

// The summary of table entry e: the B * n_qt query tiles, then the
// B * n_kt key tiles.
struct Tables {
  const int *q_seg, *k_seg;
  int Sq, Sk, n_qt, n_kt, n_q, n_all;
  __device__ __forceinline__ void locate(int e, const int*& seg, int& p0, int& n) const {
    if (e < n_q) {
      seg = q_seg + (long long)(e / n_qt) * Sq, p0 = (e % n_qt) * BM, n = Sq;
    } else {
      e -= n_q;
      seg = k_seg + (long long)(e / n_kt) * Sk, p0 = (e % n_kt) * BN, n = Sk;
    }
  }
};

// The producer warpgroup's four warps fill the summary table, kSumBatch
// tiles per warp at a time with all their loads in flight.
__device__ __forceinline__ void fill_table(const Tables& tb, int4* sums) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int e0 = warp * kSumBatch; e0 < tb.n_all; e0 += 4 * kSumBatch) {
    int v[kSumBatch][4];
#pragma unroll
    for (int u = 0; u < kSumBatch; ++u) {
      const int* seg;
      int p0, n;
      tb.locate(min(e0 + u, tb.n_all - 1), seg, p0, n);
      load_ids(v[u], seg, p0, n, e0 + u < tb.n_all);
    }
#pragma unroll
    for (int u = 0; u < kSumBatch; ++u) {
      const int4 sm = summarize(v[u]);
      if (lane == 0 && e0 + u < tb.n_all) sums[e0 + u] = sm;
    }
  }
}

// Entry e of the table, or computed here when the table did not fit.
__device__ __forceinline__ int4 summary(const Tables& tb, const int4* sums, bool in_table, int e) {
  if (in_table) return sums[e];
  const int* seg;
  int p0, n;
  tb.locate(e, seg, p0, n);
  int v[4];
  load_ids(v, seg, p0, n, true);
  return summarize(v);
}

// Warp 0 of the producer warpgroup. For each of this CTA's items: its Q into
// the item's buffer once the item two back has stored its output from it,
// then each live key tile into the ring, then an end marker. A key tile is
// live if its valid segment ids [lo, hi] meet the query tile's.
template <int HD, bool CAUSAL>
__device__ __forceinline__ void produce(const Maps& maps, const Smem& sm, const Tables& tb, bool in_table,
                                        int H, int Hkv, int B) {
  using T = Tiles<HD>;
  const int lane = threadIdx.x & 31;
  int stage = 0;
  uint32_t phase = 0;
  const int n_items = tb.n_qt * H * B;
  for (int r = 0, i = item_of(0); i < n_items; i = item_of(++r)) {
    const Item w(i, H, B, tb.n_qt);
    const int* ksb = tb.k_seg + (long long)w.b * tb.Sk;
    const int hk = w.h / (H / Hkv);
    const int4 qs = summary(tb, sm.sums, in_table, w.b * tb.n_qt + w.qt);
    const bool q_one = qs.z == qs.y && qs.z >= 0;  // every row valid, one segment

    const int qbuf = r & 1;
    mbar_wait(&sm.q_empty[qbuf], ((r >> 1) & 1) ^ 1);
    if (lane == 0) {
      uint8_t* dst = sm.q + qbuf * T::Q_BYTES;
      mbar_arrive_expect_tx(&sm.q_full[qbuf], T::Q_BYTES);
      tma_load_4d(dst, &maps.q[0], &sm.q_full[qbuf], 0, w.h, w.q0, w.b);
      if constexpr (T::WB > 0) tma_load_4d(dst + T::Q_A, &maps.q[1], &sm.q_full[qbuf], T::WA, w.h, w.q0, w.b);
    }

    int n_kt = tb.n_kt;
    if (CAUSAL) n_kt = min(n_kt, (w.q0 + BM - 1) / BN + 1);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int4 ks = summary(tb, sm.sums, in_table, tb.n_q + w.b * tb.n_kt + kt);
      if (!(ks.y >= qs.x && ks.x <= qs.y)) continue;  // no key meets the query tile's segments
      const int k0 = kt * BN;
      const bool plain = q_one && ks.z == ks.y && ks.z == qs.z && (!CAUSAL || k0 + BN - 1 <= w.q0);
      mbar_wait(&sm.empty[stage], phase ^ 1);
      if (!plain) {  // the consumers mask this tile by its keys' ids
        int v[4];
        load_ids(v, ksb, k0, tb.Sk, true);
        int* seg = sm.seg + stage * BN;
#pragma unroll
        for (int q = 0; q < 4; ++q) seg[lane + 32 * q] = v[q];
      }
      if (lane == 0) sm.info[stage] = make_int2(k0, plain ? 0 : 1);
      __syncwarp();
      if (lane == 0) {
        uint8_t* st = sm.kv + stage * T::STAGE;
        uint64_t* bar = &sm.full[stage];
        mbar_arrive_expect_tx(bar, T::STAGE);
        tma_load_4d(st, &maps.k[0], bar, 0, hk, k0, w.b);
        tma_load_4d(st + T::T_A + T::T_B, &maps.v[0], bar, 0, hk, k0, w.b);
        if constexpr (T::WB > 0) {
          tma_load_4d(st + T::T_A, &maps.k[1], bar, T::WA, hk, k0, w.b);
          tma_load_4d(st + 2 * T::T_A + T::T_B, &maps.v[1], bar, T::WA, hk, k0, w.b);
        }
      }
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
    if (++stage == T::STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// One consumer warpgroup. For each item: its 64 query rows against every
// tile the producer delivers up to the end marker, then the output (and
// LSE) of those rows, stored from the item's Q buffer.
template <int HD, bool CAUSAL>
__device__ __forceinline__ void consume(const Maps& maps, const Smem& sm, const int* q_seg, float* lse, int Sq,
                                        int H, int B, int n_qt, float scale) {
  using T = Tiles<HD>;
  constexpr int WA = T::WA, WB = T::WB;
  const int wg = (threadIdx.x >> 7) - 1;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const float sl2 = scale * kLog2e;
  int stage = 0;
  uint32_t phase = 0;
  const int n_items = n_qt * H * B;
  for (int it = 0, i = item_of(0); i < n_items; i = item_of(++it)) {
    const Item w(i, H, B, n_qt);
    // this thread's two query rows (accumulator rows g and g + 8 of its warp)
    int qpos[2], qseg[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      qpos[r] = w.q0 + 64 * wg + 16 * warp + g + 8 * r;
      qseg[r] = qpos[r] < Sq ? __ldg(q_seg + (long long)w.b * Sq + qpos[r]) : -1;
    }
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float oa[WA / 2], ob[WB > 0 ? WB / 2 : 1];
#pragma unroll
    for (int r = 0; r < WA / 2; ++r) oa[r] = 0.f;
#pragma unroll
    for (int r = 0; r < (WB > 0 ? WB / 2 : 1); ++r) ob[r] = 0.f;

    const int qbuf = it & 1;
    uint8_t* qa = sm.q + qbuf * T::Q_BYTES + 64 * wg * 2 * WA;  // this warpgroup's 64 rows of each chunk
    uint8_t* qb = sm.q + qbuf * T::Q_BYTES + T::Q_A + 64 * wg * 2 * WB;
    mbar_wait(&sm.q_full[qbuf], (it >> 1) & 1);

    for (;;) {
      mbar_wait(&sm.full[stage], phase);
      const int2 info = sm.info[stage];
      if (info.x < 0) {  // the item's end marker: release its slot
        if (lane == 0) mbar_arrive(&sm.empty[stage]);
        if (++stage == T::STAGES) {
          stage = 0;
          phase ^= 1;
        }
        break;
      }
      const int k0 = info.x;
      uint8_t* st = sm.kv + stage * T::STAGE;

      // S = Q K^T over the head-dim chunks (k16 steps of 32 bytes in a row)
      float s[BN / 2];
      wgmma_fence();
      {
        const uint64_t dq = smem_desc<2 * WA>(qa), dk = smem_desc<2 * WA>(st);
#pragma unroll
        for (int kk = 0; kk < WA / 16; ++kk)
          wgmma_ss_n128<0>(s, desc_advance(dq, 32 * kk), desc_advance(dk, 32 * kk), kk > 0);
      }
      if constexpr (WB > 0) {
        const uint64_t dq = smem_desc<2 * WB>(qb), dk = smem_desc<2 * WB>(st + T::T_A);
#pragma unroll
        for (int kk = 0; kk < WB / 16; ++kk)
          wgmma_ss_n128<0>(s, desc_advance(dq, 32 * kk), desc_advance(dk, 32 * kk), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      if (info.y) {  // a tile with masked pairs
        const int* seg = sm.seg + stage * BN;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int2 kv = *reinterpret_cast<const int2*>(seg + 8 * j + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ks = (e & 1) ? kv.y : kv.x;
            bool ok = ks >= 0 && ks == qseg[e >> 1];
            if (CAUSAL) ok = ok && qpos[e >> 1] >= k0 + 8 * j + 2 * t + (e & 1);
            if (!ok) s[4 * j + e] = -INFINITY;
          }
        }
      }

      // online softmax, base 2; a row with no valid key so far keeps m = -inf
      // and takes base 0, so its p, l and O stay exactly 0
      float corr[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[hh], mx);
        const float base = m_new == -INFINITY ? 0.f : m_new * sl2;
        corr[hh] = exp2f(m[hh] * sl2 - base);
        m[hh] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp2f(fmaf(s[4 * j + 2 * hh + e], sl2, -base));  // masked: exp2(-inf) = 0
            s[4 * j + 2 * hh + e] = p;
            sum += p;
          }
        }
        l[hh] = l[hh] * corr[hh] + sum;
      }
#pragma unroll
      for (int r = 0; r < WA / 2; ++r) oa[r] *= corr[(r >> 1) & 1];
      if constexpr (WB > 0) {
#pragma unroll
        for (int r = 0; r < WB / 2; ++r) ob[r] *= corr[(r >> 1) & 1];
      }

      // P as the register A operand: key block kk's two n8 blocks of S
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16x2(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
      }

      // O += P V, V MN-major: a k16 step is 16 rows of the tile
      fence_regs(oa);
      fence_regs(ob);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) fence_regs(pa[kk]);
      wgmma_fence();
      {
        const uint64_t dv = smem_desc<2 * WA>(st + T::T_A + T::T_B);
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs<WA, 1>(oa, pa[kk], desc_advance(dv, kk * 16 * 2 * WA));
      }
      if constexpr (WB > 0) {
        const uint64_t dv = smem_desc<2 * WB>(st + 2 * T::T_A + T::T_B);
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs<WB, 1>(ob, pa[kk], desc_advance(dv, kk * 16 * 2 * WB));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(oa);
      fence_regs(ob);
      if (lane == 0) mbar_arrive(&sm.empty[stage]);  // this warp has read the stage
      if (++stage == T::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    float inv[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float x = l[hh];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      inv[hh] = x > 0.f ? 1.f / x : 0.f;
      if (lse != nullptr && t == 0 && qpos[hh] < Sq)
        lse[((long long)w.b * H + w.h) * Sq + qpos[hh]] = x > 0.f ? m[hh] * scale + logf(x) : kBigLse;
    }

    // O / l as bf16 into this warpgroup's rows of the Q buffer (their last
    // reader, its last S wgmma, has completed), swizzled as TMA stores them
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = 16 * warp + g + 8 * hh;
#pragma unroll
      for (int n = 0; n < WA / 8; ++n)
        *reinterpret_cast<uint32_t*>(qa + swizzle<2 * WA>(row * 2 * WA + (8 * n + 2 * t) * 2)) =
            pack_bf16x2(oa[4 * n + 2 * hh] * inv[hh], oa[4 * n + 2 * hh + 1] * inv[hh]);
      if constexpr (WB > 0) {
#pragma unroll
        for (int n = 0; n < WB / 8; ++n)
          *reinterpret_cast<uint32_t*>(qb + swizzle<2 * WB>(row * 2 * WB + (8 * n + 2 * t) * 2)) =
              pack_bf16x2(ob[4 * n + 2 * hh] * inv[hh], ob[4 * n + 2 * hh + 1] * inv[hh]);
      }
    }
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    if (tid == 0) {  // rows past Sq are not written
      tma_store_4d(&maps.o[0], qa, 0, w.h, w.q0 + 64 * wg, w.b);
      if constexpr (WB > 0) tma_store_4d(&maps.o[1], qb, WA, w.h, w.q0 + 64 * wg, w.b);
      tma_store_commit();
      tma_store_wait_read();
      mbar_arrive(&sm.q_empty[qbuf]);  // the buffer may take the next item's Q
    }
  }
}

// Persistent: gridDim.x CTAs (at most one per SM) walk the n_qt * H * B work
// items in snake order (item_of), so that the producer loads the next item's
// Q and first tiles while the consumers finish this one.
template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1)
    segment_flash_kernel(const __grid_constant__ Maps maps, const int* __restrict__ q_seg,
                         const int* __restrict__ k_seg, float* __restrict__ lse, int Sq, int Sk, int H, int Hkv,
                         int B, float scale) {
  using T = Tiles<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  Smem sm;
  sm.q = base;
  sm.kv = base + T::KV0;
  sm.seg = reinterpret_cast<int*>(base + T::SEG0);
  sm.info = reinterpret_cast<int2*>(base + T::INFO0);
  sm.sums = reinterpret_cast<int4*>(base + T::SUM0);
  sm.full = reinterpret_cast<uint64_t*>(base + T::BAR0);
  sm.empty = sm.full + T::STAGES;
  sm.q_full = sm.empty + T::STAGES;
  sm.q_empty = sm.q_full + 2;
  Tables tb;
  tb.q_seg = q_seg, tb.k_seg = k_seg, tb.Sq = Sq, tb.Sk = Sk;
  tb.n_qt = (Sq + BM - 1) / BM, tb.n_kt = (Sk + BN - 1) / BN;
  tb.n_q = B * tb.n_qt, tb.n_all = tb.n_q + B * tb.n_kt;
  const bool in_table = tb.n_all <= kTable;

  if (threadIdx.x == 0) {
    for (int i = 0; i < T::STAGES; ++i) {
      mbar_init(&sm.full[i], 1);   // the producer's arrive (+ the TMA bytes)
      mbar_init(&sm.empty[i], 8);  // one arrive per consumer warp
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&sm.q_full[i], 1);   // the producer's arrive + the Q bytes
      mbar_init(&sm.q_empty[i], 2);  // one arrive per consumer warpgroup, after its store has read
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<56>();
    if (in_table) {
      fill_table(tb, sm.sums);
      named_barrier(3, 128);
    }
    if (threadIdx.x < 32) produce<HD, CAUSAL>(maps, sm, tb, in_table, H, Hkv, B);
  } else {
    setmaxnreg_inc<224>();
    consume<HD, CAUSAL>(maps, sm, q_seg, lse, Sq, H, B, tb.n_qt, scale);
  }
}

template <int HD>
static int launch(bool causal, const Maps& maps, int n_ctas, cudaStream_t st, const int* qs, const int* ks,
                  float* lse, int Sq, int Sk, int H, int Hkv, int B, float scale) {
  constexpr int smem = Tiles<HD>::SMEM;
  auto kernel = causal ? segment_flash_kernel<HD, true> : segment_flash_kernel<HD, false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<n_ctas, kThreads, smem, st>>>(maps, qs, ks, lse, Sq, Sk, H, Hkv, B, scale);
  return (int)cudaGetLastError();
}

}  // namespace sflash
}  // namespace padt

// C entry point (loaded with ctypes). strides: q_sb, q_ss, q_sh, k_sb, k_ss,
// k_sh, v_sb, v_ss, v_sh in elements; out contiguous (B, Sq, H, hd); lse
// (B, H, Sq) fp32 or null. Returns cudaGetLastError() after the launch, or an
// error code for a head dim it was not built for or a view TMA cannot take.
extern "C" int padt_segment_flash_fwd(const void* q, const void* k, const void* v, const void* q_seg,
                                      const void* k_seg, void* out, void* lse, int B, int Sq, int Sk, int H,
                                      int Hkv, int hd, long long q_sb, long long q_ss, long long q_sh,
                                      long long k_sb, long long k_ss, long long k_sh, long long v_sb,
                                      long long v_ss, long long v_sh, int causal, float scale, void* stream) {
  using namespace padt::sflash;
  if (hd != 16 && hd != 32 && hd != 64 && hd != 80 && hd != 128) return (int)cudaErrorInvalidValue;
  const int wa = hd < 64 ? hd : 64, wb = hd - wa;
  Maps maps = {};
  const long long o_ss = (long long)H * hd, o_sb = (long long)Sq * H * hd;
  int rc = 0;
  for (int c = 0; c < (wb > 0 ? 2 : 1) && rc == 0; ++c) {
    const int w = c == 0 ? wa : wb;
    if (rc == 0) rc = padt::hopper::encode_bf16_4d(&maps.q[c], q, hd, H, Sq, B, q_sh, q_ss, q_sb, w, BM);
    if (rc == 0) rc = padt::hopper::encode_bf16_4d(&maps.k[c], k, hd, Hkv, Sk, B, k_sh, k_ss, k_sb, w, BN);
    if (rc == 0) rc = padt::hopper::encode_bf16_4d(&maps.v[c], v, hd, Hkv, Sk, B, v_sh, v_ss, v_sb, w, BN);
    if (rc == 0) rc = padt::hopper::encode_bf16_4d(&maps.o[c], out, hd, H, Sq, B, hd, o_ss, o_sb, w, BM / 2);
  }
  if (rc != 0) return rc;
  int dev = 0, n_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long n_items = (long long)((Sq + BM - 1) / BM) * H * B;
  const int n_ctas = (int)(n_items < n_sm ? n_items : n_sm);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto qs = static_cast<const int*>(q_seg);
  auto ks = static_cast<const int*>(k_seg);
  auto ls = static_cast<float*>(lse);
  switch (hd) {
    case 16: return launch<16>(causal, maps, n_ctas, st, qs, ks, ls, Sq, Sk, H, Hkv, B, scale);
    case 32: return launch<32>(causal, maps, n_ctas, st, qs, ks, ls, Sq, Sk, H, Hkv, B, scale);
    case 64: return launch<64>(causal, maps, n_ctas, st, qs, ks, ls, Sq, Sk, H, Hkv, B, scale);
    case 80: return launch<80>(causal, maps, n_ctas, st, qs, ks, ls, Sq, Sk, H, Hkv, B, scale);
    default: return launch<128>(causal, maps, n_ctas, st, qs, ks, ls, Sq, Sk, H, Hkv, B, scale);
  }
}

extern "C" const char* padt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
