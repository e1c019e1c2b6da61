// The int8 KV cache kernels:
//   H4 int8_decode_attn  one query token per slot over the int8 cache, with
//                        the token's own K/V as one extra softmax column or
//                        without it; optionally reading only the columns
//                        below n_valid[b], and optionally scoring with q
//                        quantized to int8 per row (int8 x int8 -> int32)
//   H5 int8_verify_attn  kq query tokens per slot (speculative verify, the
//                        shared-prefix suffix pass, the older multi-query
//                        form), plus kq fresh columns that are causal inside
//                        the block, or, without them, a causal limit over a
//                        cache that already holds the kq new rows
//   H6 store_kv_rows     in-place write of up to kq new rows per slot at its
//                        own position, in every layer of a stack (a single
//                        layer, or an unstacked cache, is a one-layer view)
//
// Replaces (padt_tpu/ops/kv_cache.py):
//   H4 <- _decode_kernel_stacked_fresh (:206) and _decode_kernel_stacked_fresh_bb
//         (:288), both with quantize_q (_scores_vs_cache :173); _decode_kernel
//         (:87, K13), _decode_kernel_stacked (:135, K14) and
//         _decode_kernel_tiled (:545, K15). The batch blocking of _bb and
//         K15's 256-row tiles are TPU launch-granularity choices: here the
//         columns at or past n_valid[b] are simply never read
//   H5 <- _decode_kernel_multi_stacked_fresh (:402), _decode_kernel_multi
//         (:1304) and _decode_kernel_multi_stacked (:1340, K16)
//   H6 <- _store_rows_kernel_all_layers (:750), _store_rows_k_kernel_all_layers
//         (:856), _store_rows_kernel(_stacked) (:662, :683, K17) and
//         _store_rows_k_kernel(_stacked) (:1090, :1220, K18); the TPU's two
//         passes over the straddled pair of 32-row tiles are not needed: rows
//         are written where they are
//
// Cache layout (as in the JAX package): k8/v8 (L, B, Hkv, C, hd) int8,
// ks/vs (L, B, Hkv, C) fp32 per-token scales. The attention kernels read
// layer `layer`. With fresh columns, the cache is the PRE-update one and
// valid (B, C) excludes the new positions, whose K/V arrive separately as
// kn/vn (B, Hkv, kq, hd) with scales ksn/vsn (B, Hkv, kq); without them
// (kn == nullptr) the cache already holds the new rows.
//
// Numerics follow the TPU kernels: scores are bf16 q times int8 k, summed in
// fp32, times ks * hd^-0.5; keys with valid == 0 (or past a causal limit)
// get -1e30. With quantize_q each q row is quantized as quantize_kv does
// (qs = max(amax, 1e-8) / 127, q8 = round-half-even(q / qs) clipped to
// +-127, IEEE division), the dot is exact in int32, and the score is
// (float(dot) * qs) * (ks * hd^-0.5), in JAX's order; the fresh column then
// uses the dequantized q8 * qs. One max and one denominator over the cache
// and fresh columns. The cache side's p / denom * vs is rounded to bf16
// before its product with v8. The fresh side stays fp32 in H4,
// (p / denom) * (vn * vsn), and is rounded through bf16 in H5,
// bf16(p / denom * vsn) * vn. A row with no visible key gives the mean of
// the V rows (softmax over all -1e30 scores is uniform), except with an
// n_valid bound, where it gives 0 as K15 does (a masked key's p is 0 there).
//
// Bound on the H100: the bytes of the layer's cache (C * hd * 2 per slot and
// kv head), and the latency of reaching them: a (slot, kv head) has G = 8
// query rows at decode and 8 * kq at a suffix or verify pass, so the work per
// byte is small and the kernels win by keeping many bytes in flight and the
// products on the tensor cores. Design (both kernels):
//   - the cache columns of a (slot, kv head) are split over a cluster of S
//     CTAs (S in {1, 2, 4, 8}, the wrapper's plan, ops/cuda_kv.py), each
//     owning a chunk; a cluster barrier's arrive is issued as a CTA starts,
//     its wait before the CTA first writes another's shared memory;
//   - a CTA copies its chunk in 64-column tiles of int8 K and V into a ring
//     of shared-memory slots with cp.async (rows padded by 16 bytes). When the
//     chunk fits the ring (a decode step: 96 columns at S = 8, C = 768),
//     every copy is issued before the first product and each tile is read
//     once; otherwise the ring keeps stages - 1 tiles in flight ahead;
//   - two sweeps over the tiles instead of a stored score row (whose size
//     would bound the capacity): sweep 1 computes the scores and an
//     online (m, l) per row; each CTA pushes its (m_k, l_k) into every
//     rank's shared memory, and after one cluster barrier each combines m =
//     max m_k, l = sum l_k e^(m_k - m) in rank order (one exchange); sweep 2
//     computes the same scores bit for bit, forms bf16(e^(s - m) / l * vs)
//     against that global denominator as the one-pass softmax rounds it
//     (e^x by ex2.approx, relative error ~1e-6; p / l as IEEE division gives
//     it, by a refined reciprocal: no division subroutine, whose saved
//     registers ptxas counts as spills), and sums P.V on the tensor cores;
//     the ranks' partial rows are then summed in rank order by the rank that
//     owns them. The online l differs from the twin's single sum only in
//     fp32 rounding, which can move the bf16 rounding of p by one ulp on a
//     few entries (the tolerances allow it). No atomics: a rerun gives the
//     same bits;
//   - H5 (one warpgroup per 64-row tile; two row tiles a CTA at a suffix
//     pass, which share each converted tile; at hd 256 two warpgroups split
//     the output dims of one row tile): each int8 tile is converted once per
//     CTA (an exact magic-number conversion, four values a word) into a bf16
//     tile in wgmma's swizzled layout; S = Q K^T by SS-wgmma m64n64k16
//     (K-major), O += P V by RS-wgmma, P the bf16 of S's accumulator in
//     registers, V read MN-major (the transpose bit). A suffix pass's 256
//     rows of a (slot, kv head) take 2 CTAs, so each K/V tile is read twice
//     (from L2) instead of 32 times, and with two row tiles a CTA takes an
//     SM and its ring holds the whole chunk. Past write_pos + kq, under
//     K16's causal limit, no tile is read (unless the first query row sees
//     no key at all: then every row sweeps the whole cache, whose uniform
//     softmax the twin gives);
//   - H4 (8 query rows a CTA, 4 warps, swap-AB): each warp owns 16 columns of
//     a tile, the m16 of mma.sync m16n8k16; the G query rows are its n8. K's
//     int8 words go straight from the ring into A fragments (the head dim
//     permuted alike in K and q, so one 32-bit load gives a k16 fragment's
//     four values), or, with quantize_q, into mma.sync m16n8k32.s8 (exact
//     int32 sums). Resident tiles keep their sweep-1 scores in registers for
//     sweep 2. P.V is O^T = V^T P^T: each warp converts its 16 V columns to a
//     transposed bf16 tile and its P to bf16 through shared memory, and the
//     four warps' partial O^T are summed in warp order. The fresh column
//     (rank 0) is scored by one warp and enters the rank's (m_k, l_k). What
//     holds H4 back is fixed cost: a launch with its two cluster barriers
//     takes about half of a decode call (tools/attn_sweep.py, n_valid = 0).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_attn.cuh"

namespace padt {

using namespace i8attn;

constexpr int kRowsV = 64;  // H5: query rows of a row tile (a warpgroup's wgmma m64)
constexpr int kRowsD = 8;   // H4: query rows per CTA (mma's n)
constexpr int kLdP = 24;    // H4: row pitch (bf16) of a warp's 8 x 16 P tile

// H5's output-dim parts (warpgroups) per CTA: 2 at hd 256 (see verify_kernel)
template <int HD>
struct VerifyParts {
  static constexpr int value = HD >= 256 ? 2 : 1;
};

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// shared memory of one CTA; ops/cuda_kv.py (`attn_smem_bytes`) mirrors both
template <int HD>
size_t verify_smem(int rt, int stages, int chunk, int n_fresh) {
  const int cap = round_up(chunk, kTile) + round_up(n_fresh, kTile);
  return 1024 + (size_t)(rt + 2) * kTile * HD * 2 + (size_t)kMaxSplit * 2 * kRowsV * rt * 4 + (size_t)stages * SlotBytes<HD>::value +
         8 * (size_t)cap + round_up(cap, 16);
}

template <int HD>
size_t decode_smem(int stages, int chunk) {
  const int cap = round_up(chunk, kTile);
  return (size_t)kRowsD * (HD + 8) * 2 + kRowsD * (HD + 16) + HD + kRowsD * HD * 4 + (size_t)HD * kLdVt * 2 +
         4 * kRowsD * kLdP * 2 + 16 * HD * 4 + 896 + (size_t)stages * SlotBytes<HD>::value + 8 * (size_t)cap +
         round_up(cap, 16);
}

// ---------------------------------------------------------------------------
// H5 int8_verify_attn
// ---------------------------------------------------------------------------

// Rows r of one (slot b, kv head h) are the flattened (G, kq) query rows,
// r = gi * kq + i; fresh column j is visible to row r iff r % kq >= j, and
// without fresh columns (write_pos given) cache column c is visible to row r
// iff c <= write_pos[b] + r % kq. Grid (S * row tiles, Hkv, B) in clusters
// of (S, 1, 1); the S CTAs of a cluster share one row tile and split the
// cache columns; rank 0 also owns the fresh columns, as tiles after its own.
// A CTA has RT * DS warpgroups over 64 RT query rows: warpgroup w scores
// the 64 rows 64 (w % RT).. (wgmma's m64; its warp v holds rows 16 v..) and
// sums P.V into the output dims [w / RT, w / RT + 1) HD / DS. RT = 2 lets
// two row tiles share each converted K / V tile; DS = 2 at hd 256 only,
// where one warpgroup's fp32 accumulators for all 256 dims leave too few
// registers: the two then both score the tile (the same bits) and split P.V.
template <int HD, int RT>
__global__ void __launch_bounds__(kThreads * RT * VerifyParts<HD>::value, 1)
    verify_kernel(const bf16* __restrict__ q,         // (B, Hkv, R, hd)
                  const int8_t* __restrict__ k8,      // (L, B, Hkv, C, hd)
                  const float* __restrict__ ks,       // (L, B, Hkv, C)
                  const int8_t* __restrict__ v8, const float* __restrict__ vs,
                  const int8_t* __restrict__ kn,      // (B, Hkv, kq, hd) or null
                  const float* __restrict__ ksn,      // (B, Hkv, kq)
                  const int8_t* __restrict__ vn, const float* __restrict__ vsn,
                  const uint8_t* __restrict__ valid,  // (B, C)
                  const int* __restrict__ write_pos,  // (B,) or null: the causal limit
                  bf16* __restrict__ out,             // (B, Hkv, R, hd)
                  int B, int Hkv, int R, int C, int kq, int n_fresh, int layer, int stages, float scale) {
  constexpr int DS = VerifyParts<HD>::value;
  constexpr int NT = kThreads * RT * DS;
  constexpr int ROWS = kRowsV * RT;  // query rows of the CTA
  using CK = Chunks<HD>;
  constexpr int CW = CK::W;       // head dims of a chunk
  constexpr int NC = CK::N / DS;  // chunks of this warpgroup's output dims
  constexpr int RP = RingPitch<HD>::value;
  constexpr int SLOT = SlotBytes<HD>::value;
  extern __shared__ __align__(16) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int nsplit = (int)cluster.num_blocks();
  const int b = blockIdx.z, h = blockIdx.y;
  const int r0 = (blockIdx.x / nsplit) * ROWS;
  const int nr = min(ROWS, R - r0);
  const int chunk = (C + nsplit - 1) / nsplit;
  const int c0 = min(C, rank * chunk);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  // the warp's 16 rows (row0..) and its warpgroup's output-dim part
  const int row0 = 64 * ((warp >> 2) % RT) + 16 * (warp & 3), part_d = (warp >> 2) / RT;
  const long long bh = (long long)b * Hkv + h;
  const long long lbh = ((long long)layer * B + b) * Hkv + h;
  const uint8_t* val = valid + (long long)b * C;
  const bool causal = write_pos != nullptr;
  const int wp = causal ? write_pos[b] : 0;
  if (nsplit > 1) cluster_arrive_relaxed();
  int nc = min(C, c0 + chunk) - c0;  // this CTA's cache columns [c0, c0 + nc)
  if (causal) {
    // K16: no row sees a column past wp + kq - 1, so those tiles are never
    // read, provided row r % kq == 0 sees some valid column <= wp (else every
    // row sweeps the whole cache: a row with no visible key is uniform)
    const int last = min(wp, C - 1);
    int any = 0;
    for (int c = last - tid; c >= 0 && !any; c -= NT) any = val[c];
    if (__syncthreads_or(any)) nc = max(0, min(nc, wp + kq - c0));
  }
  const int nf = rank == 0 ? n_fresh : 0;
  const int ntc = (nc + kTile - 1) / kTile, nt = ntc + (nf + kTile - 1) / kTile;
  const int cap = round_up(chunk, kTile) + round_up(n_fresh, kTile);

  // the wgmma tiles start on 1024-byte boundaries (the swizzle atom)
  uint8_t* base = smem + ((1024 - (hopper::smem_u32(smem) & 1023)) & 1023);
  uint8_t* sQ = base;                // q rows in 64-row blocks, chunked and swizzled (wgmma's A)
  uint8_t* sK = sQ + ROWS * HD * 2;  // the K tile in bf16 (K-major B of Q K^T)
  uint8_t* sV = sK + kTile * HD * 2; // the V tile in bf16 (MN-major B of P V)
  int8_t* ring = reinterpret_cast<int8_t*>(sV + kTile * HD * 2);
  float* xbuf = reinterpret_cast<float*>(ring + (size_t)stages * SLOT);  // [kMaxSplit][2][ROWS]: the ranks' (m, l)
  float* sks = xbuf + kMaxSplit * 2 * ROWS;  // [cap]: cache columns, then fresh
  float* svs = sks + cap;
  uint8_t* sval = reinterpret_cast<uint8_t*>(svs + cap);

  const int8_t* kc = k8 + (lbh * C + c0) * HD;
  const int8_t* vc = v8 + (lbh * C + c0) * HD;
  const int8_t* kf = kn != nullptr ? kn + bh * kq * HD : nullptr;
  const int8_t* vf = vn != nullptr ? vn + bh * kq * HD : nullptr;
  const bool resident = nt <= stages;

  // group 0: the q rows, the scales and the valid bytes; then the tiles
  const bf16* qb = q + (bh * R + r0) * HD;
  if ((reinterpret_cast<uintptr_t>(q) & 15) == 0) {
    for (int i = tid; i < ROWS * (HD / 8); i += NT) {
      const int rr = i / (HD / 8), d = (i % (HD / 8)) * 8;
      uint8_t* dst = sQ + (rr / 64) * (64 * HD * 2) + chunk_offset<HD>(rr % 64, d);
      if (rr < nr) cp_async16(dst, qb + (long long)rr * HD + d);
      else *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int i = tid; i < ROWS * HD; i += NT) {
      const int rr = i / HD, d = i % HD;
      reinterpret_cast<bf16*>(sQ + (rr / 64) * (64 * HD * 2) + chunk_offset<HD>(rr % 64, d & ~7))[d & 7] =
          rr < nr ? qb[(long long)rr * HD + d] : __float2bfloat16(0.f);
    }
  }
  for (int i = tid; i < nc; i += NT) {
    cp_async4(sks + i, ks + lbh * C + c0 + i);
    cp_async4(svs + i, vs + lbh * C + c0 + i);
  }
  for (int j = tid; j < nf; j += NT) {
    cp_async4(sks + ntc * kTile + j, ksn + bh * kq + j);
    cp_async4(svs + ntc * kTile + j, vsn + bh * kq + j);
  }
  load_bytes<NT>(sval, val + c0, nc);
  cp_async_commit();
  for (int i = 0; i < (resident ? nt : stages - 1); ++i)
    issue_item<HD, NT>(ring, stages, resident, nt, i, kc, vc, nc, kf, vf, nf);
  if (resident) {
    cp_async_wait<0>();
    __syncthreads();
  }

  const bool rows_here = row0 < nr;
  int rel[2];  // r % kq of this thread's rows row0 + g + 8 h
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) rel[hh] = (r0 + row0 + g + 8 * hh) % kq;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[NC][CW / 2];  // P V over this warpgroup's head-dim chunks (wgmma accumulators)
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int r = 0; r < CW / 2; ++r) acc[c][r] = 0.f;
  Divisor dl[2];

  for (int i = 0;; ++i) {
    if (i == nt) {  // every CTA pushes its (m, l) to the cluster and combines the ranks', once
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
        l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
      }
      if (nsplit > 1) cluster_wait();
      if (t == 0 && part_d == 0) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) push_stat(cluster, xbuf, ROWS, row0 + g + 8 * hh, rank, nsplit, m[hh], l[hh]);
      }
      if (nsplit > 1) cluster.sync();
      else __syncthreads();
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        combine_stat(xbuf, ROWS, row0 + g + 8 * hh, nsplit, m[hh], l[hh]);
        dl[hh] = divisor(l[hh]);
      }
    }
    if (i == 2 * nt) break;
    const bool sweep2 = i >= nt;
    const int tt = sweep2 ? i - nt : i;
    const int8_t* slot;
    if (resident) {
      if (i > 0) __syncthreads();  // the previous tile's products are done with sK / sV
      slot = ring + (size_t)tt * SLOT;
    } else {
      cp_async_wait_n(stages - 2);
      __syncthreads();  // item i has landed for every thread; slot (i - 1) % stages is free
      issue_item<HD, NT>(ring, stages, resident, nt, i + stages - 1, kc, vc, nc, kf, vf, nf);
      slot = ring + (size_t)(i % stages) * SLOT;
    }
    convert_tile_sw<HD, NT>(sK, slot);
    if (sweep2) convert_tile_sw<HD, NT>(sV, slot + kTile * RP);
    hopper::fence_proxy_async();  // the converted tiles, to wgmma's (async) proxy
    __syncthreads();
    const bool fresh_tile = tt >= ntc;
    const int ncol = fresh_tile ? min(kTile, nf - (tt - ntc) * kTile) : min(kTile, nc - tt * kTile);

    // S = Q K^T, one m64n64k16 wgmma per k16 step of each head-dim chunk;
    // s[4j + 2h + e] is row row0 + g + 8h, column 8j + 2t + e
    const int cb = tt * kTile;  // the tile's first column in sks / svs / sval
    float s[32];
    hopper::wgmma_fence();
#pragma unroll
    for (int c = 0; c < CK::N; ++c) {
      const uint64_t dq = hopper::smem_desc<CK::SPAN>(sQ + (row0 / 64) * (64 * HD * 2) + c * CK::TILE);
      const uint64_t dk = hopper::smem_desc<CK::SPAN>(sK + c * CK::TILE);
#pragma unroll
      for (int kk = 0; kk < CW / 16; ++kk)
        hopper::wgmma_ss_n64(s, hopper::desc_advance(dq, 32 * kk), hopper::desc_advance(dk, 32 * kk), c > 0 || kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    // scale and mask: a column past the tile's end is not a column (-inf:
    // p = 0 in every sum); a masked one gets -1e30 as in JAX (the rule is
    // K8's cache columns, its fresh columns, or K16's causal limit: column
    // cl is visible to r % kq = rel iff cl <= lim0 + rel)
    const int lim0 = fresh_tile ? -(tt - ntc) * kTile : wp - c0 - cb;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        const int cl = 8 * j + 2 * t + e1;
        const bool in = cl < ncol;
        const float f = in ? sks[cb + cl] * scale : 0.f;
        const bool ok = in && (fresh_tile || sval[cb + cl] != 0);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const bool vis = (fresh_tile || causal) ? ok && cl <= lim0 + rel[hh] : ok;
          float& x = s[4 * j + 2 * hh + e1];
          x = !in ? -INFINITY : vis ? x * f : kNegInf;
        }
      }
    }
    if (!sweep2) {  // online (m, l): this thread's partial l of its rows g and g + 8
      float tmax[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i2 = 0; i2 < 32; ++i2) tmax[(i2 >> 1) & 1] = fmaxf(tmax[(i2 >> 1) & 1], s[i2]);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        tmax[hh] = fmaxf(tmax[hh], __shfl_xor_sync(0xffffffffu, tmax[hh], 1));
        tmax[hh] = fmaxf(tmax[hh], __shfl_xor_sync(0xffffffffu, tmax[hh], 2));
        const float mn = fmaxf(m[hh], tmax[hh]);
        l[hh] *= exp_fast(m[hh] - mn);
        m[hh] = mn;
      }
#pragma unroll
      for (int i2 = 0; i2 < 32; ++i2) l[(i2 >> 1) & 1] += exp_fast(s[i2] - m[(i2 >> 1) & 1]);
      continue;
    }
    // sweep 2: bf16(p / l * vs) as the register A operand, then P V
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        const int cl = 8 * j + 2 * t + e1;
        const float v = cl < ncol ? svs[cb + cl] : 0.f;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float& x = s[4 * j + 2 * hh + e1];
          x = (cl < ncol && l[hh] > 0.f) ? div_by(exp_fast(x - m[hh]), dl[hh]) * v : 0.f;
        }
      }
    }
    uint32_t pa[4][4];  // key block kk: S's n8 blocks 2kk and 2kk + 1
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kk][r] = hopper::pack_bf16x2(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
#pragma unroll
    for (int c = 0; c < NC; ++c) hopper::fence_regs(acc[c]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hopper::fence_regs(pa[kk]);
    hopper::wgmma_fence();
#pragma unroll
    for (int c = 0; c < NC; ++c) {  // V MN-major: a k16 step is 16 rows of the tile
      const uint64_t dv = hopper::smem_desc<CK::SPAN>(sV + (part_d * NC + c) * CK::TILE);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_rs<CW, 1>(acc[c], pa[kk], hopper::desc_advance(dv, kk * 16 * CK::SPAN));
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < NC; ++c) hopper::fence_regs(acc[c]);
  }

  // this CTA's P.V rows: written out, or (S > 1) staged for the cluster's
  // fold over the now idle q, K, V tiles and ring (at least 256 ROWS HD bytes)
  bf16* ob = out + (bh * R + r0) * HD;
  float* part = reinterpret_cast<float*>(base);
  if (nsplit > 1) {
    cp_async_wait<0>();
    __syncthreads();
  }
  if (rows_here) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int rr = row0 + g + 8 * hh;
#pragma unroll
      for (int n = 0; n < NC * CW / 8; ++n) {
        const int c = n / (CW / 8), j = n % (CW / 8);
        const int d = (part_d * NC + c) * CW + 8 * j + 2 * t;
        const float x = acc[c][4 * j + 2 * hh], y = acc[c][4 * j + 2 * hh + 1];
        if (nsplit > 1) *reinterpret_cast<float2*>(part + rr * HD + d) = make_float2(x, y);
        else if (rr < nr) *reinterpret_cast<__nv_bfloat162*>(ob + (long long)rr * HD + d) = __floats2bfloat162_rn(x, y);
      }
    }
  }
  if (nsplit == 1) return;
  // the cluster's P.V shares: rank k sums its share of the rows over the
  // ranks in order and writes them
  cluster.sync();
  const int rpr = (nr + nsplit - 1) / nsplit;
  fold_rows<HD, NT>(cluster, part, nsplit, min(nr, rank * rpr), min(nr, (rank + 1) * rpr), ob);
  cluster.sync();  // no CTA leaves while another still reads its shared memory
}

// ---------------------------------------------------------------------------
// H4 int8_decode_attn
// ---------------------------------------------------------------------------

// Grid (S * row blocks, Hkv, B) in clusters of (S, 1, 1): a row block is 8
// of the G query rows of (slot b, kv head h); the S CTAs of a cluster split
// the cache columns, and rank 0 also owns the fresh column. Swap-AB: S^T
// (16 columns x 8 rows) = K (16 x hd) q^T per warp and k16 step, the head
// dim permuted alike in K and q (k16 logical 2t, 2t+1, 2t+8, 2t+9 <->
// physical 4t..4t+3), so one 32-bit load of four int8 values gives a row's
// A fragment for the step.
template <int HD, bool QI8>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const bf16* __restrict__ q,         // (B, Hkv, G, hd)
                  const int8_t* __restrict__ k8,      // (L, B, Hkv, C, hd)
                  const float* __restrict__ ks,       // (L, B, Hkv, C)
                  const int8_t* __restrict__ v8, const float* __restrict__ vs,
                  const int8_t* __restrict__ kn,      // (B, Hkv, 1, hd) or null
                  const float* __restrict__ ksn,      // (B, Hkv, 1)
                  const int8_t* __restrict__ vn, const float* __restrict__ vsn,
                  const uint8_t* __restrict__ valid,  // (B, C)
                  const int* __restrict__ nvalid,     // (B,) or null: columns read are < nvalid[b]
                  bf16* __restrict__ out,             // (B, Hkv, G, hd)
                  int B, int Hkv, int G, int C, int layer, int stages, float scale) {
  constexpr int LDQ = HD + 8;
  constexpr int LDQ8 = HD + 16;
  constexpr int RP = RingPitch<HD>::value;
  constexpr int SLOT = SlotBytes<HD>::value;
  constexpr int KK8 = (HD + 31) / 32;  // k32 steps of the int8 x int8 scores
  constexpr int NT = kThreads;
  extern __shared__ __align__(16) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int nsplit = (int)cluster.num_blocks();
  const int b = blockIdx.z, h = blockIdx.y;
  const int r0 = (blockIdx.x / nsplit) * kRowsD;
  const int nr = min(kRowsD, G - r0);
  const int chunk = (C + nsplit - 1) / nsplit;
  const int c0 = min(C, rank * chunk);
  int nc = min(C, c0 + chunk) - c0;
  if (nvalid != nullptr) nc = max(0, min(nc, nvalid[b] - c0));  // columns at or past n_valid are never read
  const bool fresh_here = rank == 0 && kn != nullptr;
  const int nt = (nc + kTile - 1) / kTile;
  const int cap = round_up(chunk, kTile);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const long long bh = (long long)b * Hkv + h;
  const long long lbh = ((long long)layer * B + b) * Hkv + h;
  if (nsplit > 1) cluster_arrive_relaxed();

  bf16* sQ = reinterpret_cast<bf16*>(smem);                                // [8][LDQ]
  int8_t* q8 = reinterpret_cast<int8_t*>(sQ + kRowsD * LDQ);              // [8][LDQ8]
  int8_t* skn = q8 + kRowsD * LDQ8;                                       // [HD]: the fresh key row
  float* qf = reinterpret_cast<float*>(skn + HD);                         // [8][HD]: the q the fresh column sees
  bf16* sVt = reinterpret_cast<bf16*>(qf + kRowsD * HD);                  // [HD][kLdVt]; warp w: columns 16w..
  bf16* sP = sVt + HD * kLdVt;                                            // [4][8][kLdP]
  float* fbuf = reinterpret_cast<float*>(sP + 4 * kRowsD * kLdP);         // [16][HD]: the ranks' rows this rank sums
  float* wst = fbuf + 16 * HD;                                            // [4][2][8]: each warp's (m, l)
  float* xbuf = wst + 64;                                                 // [kMaxSplit][2][8]: the ranks' (m, l)
  float* gst = xbuf + kMaxSplit * 2 * kRowsD;                             // [2][8]: the cluster's (m, l)
  float* sf = gst + 16;                                                   // [8]: the fresh column's scores
  float* qsc = sf + 8;                                                    // [8]: the q rows' int8 scales
  int8_t* ring = reinterpret_cast<int8_t*>(qsc + 8);
  float* sks = reinterpret_cast<float*>(ring + (size_t)stages * SLOT);  // [cap]
  float* svs = sks + cap;
  uint8_t* sval = reinterpret_cast<uint8_t*>(svs + cap);

  const int8_t* kc = k8 + (lbh * C + c0) * HD;
  const int8_t* vc = v8 + (lbh * C + c0) * HD;
  const bool resident = nt <= stages;

  // group 0: the q rows, the fresh key row, the scales and the valid bytes;
  // then the tiles (the whole chunk when it fits the ring)
  const bf16* qb = q + (bh * G + r0) * HD;
  if ((reinterpret_cast<uintptr_t>(q) & 15) == 0) {
    for (int i = tid; i < kRowsD * (HD / 8); i += NT) {
      const int rr = i / (HD / 8), c = i % (HD / 8);
      if (rr < nr) cp_async16(sQ + rr * LDQ + c * 8, qb + (long long)rr * HD + c * 8);
      else *reinterpret_cast<uint4*>(sQ + rr * LDQ + c * 8) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int i = tid; i < kRowsD * HD; i += NT) {
      const int rr = i / HD, d = i % HD;
      sQ[rr * LDQ + d] = rr < nr ? qb[(long long)rr * HD + d] : __float2bfloat16(0.f);
    }
  }
  if (fresh_here)
    for (int i = tid; i < HD / 16; i += NT) cp_async16(skn + i * 16, kn + bh * HD + i * 16);
  for (int i = tid; i < nc; i += NT) {
    cp_async4(sks + i, ks + lbh * C + c0 + i);
    cp_async4(svs + i, vs + lbh * C + c0 + i);
  }
  load_bytes<NT>(sval, valid + (long long)b * C + c0, nc);
  cp_async_commit();
  for (int i = 0; i < (resident ? nt : stages - 1); ++i)
    issue_item<HD, NT>(ring, stages, resident, nt, i, kc, vc, nc, nullptr, nullptr, 0);
  cp_async_wait_n(resident ? nt : stages - 1);  // group 0 has landed (the tiles may still be in flight)
  __syncthreads();
  for (int i = tid; i < kRowsD * HD; i += NT) qf[i] = __bfloat162float(sQ[(i / HD) * LDQ + i % HD]);
  __syncthreads();
  if (QI8) {  // each row to int8 with its own scale (one warp per row); qf keeps q8 * qs
    for (int rr = warp; rr < kRowsD; rr += 4) {
      float* qrow = qf + rr * HD;
      float amax = 0.f;
      for (int d = lane; d < HD; d += 32) amax = fmaxf(amax, fabsf(qrow[d]));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      const float sc = div_rn(fmaxf(amax, 1e-8f), 127.f);
      for (int d = lane; d < HD; d += 32) {
        const float v = fminf(fmaxf(rintf(div_rn(qrow[d], sc)), -127.f), 127.f);
        q8[rr * LDQ8 + d] = (int8_t)v;
        qrow[d] = v * sc;
      }
      if (lane == 0) qsc[rr] = sc;
    }
    __syncthreads();
  }
  if (fresh_here) {  // the fresh column's fp32 scores, one warp per row
    for (int rr = warp; rr < kRowsD; rr += 4) {
      float dot = 0.f;
      for (int d = lane; d < HD; d += 32) dot += qf[rr * HD + d] * (float)skn[d];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (lane == 0) sf[rr] = dot * (ksn[bh] * scale);
    }
  }

  // q^T as the B fragments of every k step, held in registers
  uint32_t qb16[QI8 ? 1 : HD / 16][2];
  uint32_t qb8[QI8 ? KK8 : 1][2];
  float qsr[2] = {1.f, 1.f};  // the int8 scales of rows 2t, 2t + 1
  if constexpr (QI8) {
#pragma unroll
    for (int kk = 0; kk < KK8; ++kk) {
      qb8[kk][0] = ld32(q8 + g * LDQ8 + 32 * kk + 4 * t);
      qb8[kk][1] = 32 * kk + 16 < HD ? ld32(q8 + g * LDQ8 + 32 * kk + 16 + 4 * t) : 0u;
    }
    qsr[0] = qsc[2 * t], qsr[1] = qsc[2 * t + 1];
  } else {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      qb16[kk][0] = ld32(sQ + g * LDQ + 16 * kk + 4 * t);
      qb16[kk][1] = ld32(sQ + g * LDQ + 16 * kk + 4 * t + 2);
    }
  }

  if (resident) cp_async_wait<0>();
  __syncthreads();

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // rows 2t, 2t + 1 over this warp's columns
  float kept[2][4];  // sweep 1's scores of tiles 0 and 1, which sweep 2 reuses when they stay resident
  float acc[HD / 16][4];                                // O^T: dims 16 mb + g (+ 8), rows 2t, 2t + 1
#pragma unroll
  for (int mb = 0; mb < HD / 16; ++mb) acc[mb][0] = acc[mb][1] = acc[mb][2] = acc[mb][3] = 0.f;
  const int wc0 = 16 * warp;  // this warp's columns of a tile
  bf16* sPw = sP + warp * kRowsD * kLdP;

  for (int i = 0;; ++i) {
    if (i == nt) {  // every CTA publishes its (m, l) over its columns and the fresh one, and combines the cluster's, once
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 4);
        l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 8);
        l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 16);
      }
      if (g == 0) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          wst[warp * 16 + 2 * t + hh] = m[hh];
          wst[warp * 16 + 8 + 2 * t + hh] = l[hh];
        }
      }
      __syncthreads();
      if (nsplit > 1) cluster_wait();
      if (tid < kRowsD) {
        float mm = kNegInf;
        for (int w = 0; w < 4; ++w) mm = fmaxf(mm, wst[w * 16 + tid]);
        if (fresh_here) mm = fmaxf(mm, sf[tid]);
        float ll = 0.f;
        for (int w = 0; w < 4; ++w) ll += wst[w * 16 + 8 + tid] * exp_fast(wst[w * 16 + tid] - mm);
        if (fresh_here) ll += exp_fast(sf[tid] - mm);
        push_stat(cluster, xbuf, kRowsD, tid, rank, nsplit, mm, ll);
      }
      if (nsplit > 1) cluster.sync();
      else __syncthreads();
      if (tid < kRowsD) combine_stat(xbuf, kRowsD, tid, nsplit, gst[tid], gst[kRowsD + tid]);
      __syncthreads();
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) m[hh] = gst[2 * t + hh], l[hh] = gst[kRowsD + 2 * t + hh];
    }
    if (i == 2 * nt) break;
    const bool sweep2 = i >= nt;
    const int tt = sweep2 ? i - nt : i;
    const int8_t* slot;
    if (resident) {
      slot = ring + (size_t)tt * SLOT;
    } else {
      cp_async_wait_n(stages - 2);
      __syncthreads();  // item i has landed for every thread; slot (i - 1) % stages is free
      issue_item<HD, NT>(ring, stages, resident, nt, i + stages - 1, kc, vc, nc, nullptr, nullptr, 0);
      slot = ring + (size_t)(i % stages) * SLOT;
    }
    const int ncol = min(kTile, nc - tt * kTile);
    if (wc0 >= ncol) continue;
    const int cb = tt * kTile;
    const int8_t* k0 = slot + (wc0 + g) * RP;  // this lane's columns wc0 + g and wc0 + g + 8
    float s[4];
    if (sweep2 && resident && tt < 2) {  // the same bits sweep 1 computed
#pragma unroll
      for (int e = 0; e < 4; ++e) s[e] = tt == 0 ? kept[0][e] : kept[1][e];
    } else if constexpr (QI8) {
      int si[4] = {0, 0, 0, 0};
#pragma unroll
      for (int kk = 0; kk < KK8; ++kk) {
        const bool hi = 32 * kk + 16 < HD;
        const uint32_t a[4] = {ld32(k0 + 32 * kk + 4 * t), ld32(k0 + 8 * RP + 32 * kk + 4 * t),
                               hi ? ld32(k0 + 32 * kk + 16 + 4 * t) : 0u,
                               hi ? ld32(k0 + 8 * RP + 32 * kk + 16 + 4 * t) : 0u};
        mma_s8(si, a, qb8[kk][0], qb8[kk][1]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) s[e] = (float)si[e] * qsr[e & 1];
    } else {
      s[0] = s[1] = s[2] = s[3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t a[4];
        i8x4_to_bf16(ld32(k0 + 16 * kk + 4 * t), a[0], a[2]);
        i8x4_to_bf16(ld32(k0 + 8 * RP + 16 * kk + 4 * t), a[1], a[3]);
        mma_bf16(s, a, qb16[kk][0], qb16[kk][1]);
      }
    }
    if (!sweep2 && tt < 2) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (tt == 0) kept[0][e] = s[e];
        else kept[1][e] = s[e];
      }
    }
    // s[e]: column wc0 + g + 8 (e >> 1), row 2t + (e & 1)
    bool live[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int cl = wc0 + g + 8 * (e >> 1);
      float x = -INFINITY;  // past the tile's end: not a column
      live[e] = false;
      if (cl < ncol) {
        live[e] = sval[cb + cl] != 0;
        x = live[e] ? s[e] * (sks[cb + cl] * scale) : kNegInf;
      }
      s[e] = x;
    }
    if (!sweep2) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float tmax = fmaxf(s[hh], s[hh + 2]);
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 4));
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 8));
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 16));
        const float mn = fmaxf(m[hh], tmax);
        l[hh] *= exp_fast(m[hh] - mn);
        m[hh] = mn;
#pragma unroll
        for (int e = hh; e < 4; e += 2) l[hh] += (nvalid != nullptr && !live[e]) ? 0.f : exp_fast(s[e] - mn);
      }
      continue;
    }
    // sweep 2: bf16(p / l * vs) -> this warp's P tile [row][column]
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int cl = wc0 + g + 8 * (e >> 1);
      const float lr = l[e & 1];
      const bool on = cl < ncol && lr > 0.f && !(nvalid != nullptr && !live[e]);
      const float pv = on ? div_rn(exp_fast(s[e] - m[e & 1]), lr) * svs[cb + cl] : 0.f;
      sPw[(2 * t + (e & 1)) * kLdP + g + 8 * (e >> 1)] = __float2bfloat16(pv);
    }
    convert_v_tile_t<HD>(sVt, slot + kTile * RP, wc0, 16, lane, 32);
    __syncwarp();
    const uint32_t b0 = ld32(sPw + g * kLdP + 2 * t), b1 = ld32(sPw + g * kLdP + 2 * t + 8);
#pragma unroll
    for (int mb = 0; mb < HD / 16; ++mb) {
      const bf16* vp = sVt + (16 * mb + g) * kLdVt + wc0 + 2 * t;
      const uint32_t a[4] = {ld32(vp), ld32(vp + 8 * kLdVt), ld32(vp + 8), ld32(vp + 8 * kLdVt + 8)};
      mma_bf16(acc[mb], a, b0, b1);
    }
    __syncwarp();  // the next tile rewrites this warp's P and V^T
  }

  // the four warps' O^T partials, summed in warp order (in the idle ring),
  // plus the fresh column's fp32 term on rank 0
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);  // [4][8][HD]
#pragma unroll
  for (int mb = 0; mb < HD / 16; ++mb)
#pragma unroll
    for (int e = 0; e < 4; ++e) red[(warp * kRowsD + 2 * t + (e & 1)) * HD + 16 * mb + g + 8 * (e >> 1)] = acc[mb][e];
  __syncthreads();
  // written out, or (S > 1) pushed to the rank that owns the row: rank k
  // owns rows [k rpr, (k + 1) rpr) and sums the ranks' copies in rank order
  bf16* ob = out + (bh * G + r0) * HD;
  const int rpr = (nr + nsplit - 1) / nsplit;
  for (int i = tid; i < nr * HD; i += NT) {
    const int rr = i / HD, d = i % HD;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) o += red[w * kRowsD * HD + i];
    if (fresh_here) o += div_rn(exp_fast(sf[rr] - gst[rr]), gst[kRowsD + rr]) * ((float)vn[bh * HD + d] * vsn[bh]);
    if (nsplit == 1) ob[(long long)rr * HD + d] = __float2bfloat16(o);
    else cluster.map_shared_rank(fbuf, rr / rpr)[(rank * rpr + rr % rpr) * HD + d] = o;
  }
  if (nsplit == 1) return;
  cluster.sync();  // every push has landed; nothing reads another CTA's memory after this
  const int row0 = min(nr, rank * rpr), row1 = min(nr, (rank + 1) * rpr);
  for (int i = tid; i < (row1 - row0) * HD; i += NT) {
    const int lr = i / HD, d = i % HD;
    float o = 0.f;
    for (int k = 0; k < nsplit; ++k) o += fbuf[(k * rpr + lr) * HD + d];
    ob[(long long)(row0 + lr) * HD + d] = __float2bfloat16(o);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// `opted`: the dynamic shared memory the kernel instance may use so far (one
// per instance, kept by its launcher)
template <class Kernel, class... Args>
int launch_in_clusters(Kernel kernel, size_t& opted, dim3 grid, int threads, int nsplit, size_t bytes, void* stream,
                       Args... args) {
  if (bytes > opted) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    opted = bytes;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int HD, int RT>
int launch_verify(const void* q, const void* k8, const void* ks, const void* v8, const void* vs, const void* kn,
                  const void* ksn, const void* vn, const void* vsn, const void* valid, const void* write_pos,
                  void* out, int B, int Hkv, int R, int kq, int C, int layer, int nsplit, int stages, float scale,
                  void* stream) {
  const int n_fresh = kn != nullptr ? kq : 0;
  const size_t bytes = verify_smem<HD>(RT, stages, (C + nsplit - 1) / nsplit, n_fresh);
  const dim3 grid(nsplit * ((R + kRowsV * RT - 1) / (kRowsV * RT)), Hkv, B);
  static size_t opted = 48 * 1024;
  return launch_in_clusters(verify_kernel<HD, RT>, opted, grid, kThreads * RT * VerifyParts<HD>::value, nsplit,
                            bytes, stream, static_cast<const bf16*>(q), static_cast<const int8_t*>(k8),
                            static_cast<const float*>(ks), static_cast<const int8_t*>(v8),
                            static_cast<const float*>(vs), static_cast<const int8_t*>(kn),
                            static_cast<const float*>(ksn), static_cast<const int8_t*>(vn),
                            static_cast<const float*>(vsn), static_cast<const uint8_t*>(valid),
                            static_cast<const int*>(write_pos), static_cast<bf16*>(out), B, Hkv, R, C, kq, n_fresh,
                            layer, stages, scale);
}

template <int HD, bool QI8>
int launch_decode(const void* q, const void* k8, const void* ks, const void* v8, const void* vs, const void* kn,
                  const void* ksn, const void* vn, const void* vsn, const void* valid, const void* nvalid, void* out,
                  int B, int Hkv, int G, int C, int layer, int nsplit, int stages, float scale, void* stream) {
  const size_t bytes = decode_smem<HD>(stages, (C + nsplit - 1) / nsplit);
  const dim3 grid(nsplit * ((G + kRowsD - 1) / kRowsD), Hkv, B);
  static size_t opted = 48 * 1024;
  return launch_in_clusters(decode_kernel<HD, QI8>, opted, grid, kThreads, nsplit, bytes, stream, static_cast<const bf16*>(q),
                            static_cast<const int8_t*>(k8), static_cast<const float*>(ks),
                            static_cast<const int8_t*>(v8), static_cast<const float*>(vs),
                            static_cast<const int8_t*>(kn), static_cast<const float*>(ksn),
                            static_cast<const int8_t*>(vn), static_cast<const float*>(vsn),
                            static_cast<const uint8_t*>(valid), static_cast<const int*>(nvalid),
                            static_cast<bf16*>(out), B, Hkv, G, C, layer, stages, scale);
}

static bool plan_ok(int nsplit, int stages, int hd) {
  return nsplit >= 1 && nsplit <= kMaxSplit && (nsplit & (nsplit - 1)) == 0 && hd % nsplit == 0 && stages >= 2;
}

// H6 (store_kv_rows): one thread per 16-byte chunk of RPT new K or V rows
// (rows j = jg * RPT + r, r < RPT), over every (layer, slot, kv head, row
// group) of the call, flat:
//   t = ((((l * B + b) * Hkv + h) * G + jg) * 2 + kv) * chunks + e,
// G = ceil(kq / RPT), so a warp writes whole 16-byte-aligned rows; the
// thread of chunk 0 also copies its rows' fp32 scales. A thread issues the
// loads of all its rows before its first store. Rows j >= n_rows[b] and
// rows whose position pos[b] + j falls outside [0, C) are dropped.
// Launched under programmatic dependent launch: only index arithmetic runs
// before griddepcontrol.wait, which every memory access follows (the new
// rows are the preceding kernels' outputs, and they read the cache that
// this kernel writes). ops/cuda_kv.py (`store_plan`) mirrors the mapping.
template <int RPT>
__global__ void store_rows_flat_kernel(int8_t* __restrict__ k8, float* __restrict__ ks, int8_t* __restrict__ v8,
                                       float* __restrict__ vs, const int8_t* __restrict__ k8r,
                                       const float* __restrict__ ksr, const int8_t* __restrict__ v8r,
                                       const float* __restrict__ vsr, const int* __restrict__ pos,
                                       const int* __restrict__ n_rows, unsigned B, unsigned Hkv, int C, unsigned kq,
                                       unsigned groups, unsigned chunks, unsigned n_threads) {
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned e = t % chunks;
  unsigned u = t / chunks;
  const unsigned kv = u & 1u;
  u >>= 1;
  const unsigned jg = u % groups;
  u /= groups;
  const unsigned h = u % Hkv;
  u /= Hkv;
  const unsigned b = u % B, l = u / B;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (t >= n_threads) return;
  const int n = min(n_rows[b], (int)kq), p = pos[b];
  const size_t lbh = ((size_t)l * B + b) * Hkv + h;
  const size_t src = lbh * kq + jg * RPT;     // row jg * RPT of the new rows
  const size_t dst = lbh * C + p + jg * RPT;  // its place in the cache
  const int8_t* from = kv ? v8r : k8r;
  const float* from_s = kv ? vsr : ksr;
  int8_t* to = kv ? v8 : k8;
  float* to_s = kv ? vs : ks;
  int4 val[RPT];
  float sc[RPT];
  bool keep[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int j = (int)(jg * RPT) + r, row = p + j;
    keep[r] = j < n && row >= 0 && row < C;
    if (keep[r]) {
      val[r] = __ldg(reinterpret_cast<const int4*>(from + (src + r) * chunks * 16) + e);
      if (e == 0) sc[r] = __ldg(from_s + src + r);
    }
  }
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    if (keep[r]) {
      reinterpret_cast<int4*>(to + (dst + r) * chunks * 16)[e] = val[r];
      if (e == 0) to_s[dst + r] = sc[r];
    }
  }
}

}  // namespace padt

// C entry points (loaded with ctypes). Every tensor is contiguous in the
// layout named above (the cache and the fresh rows 16-byte aligned); valid
// is bool (one byte); nvalid, write_pos, pos and n_rows are int32; nsplit is
// the attention kernels' cluster size S (1, 2, 4 or 8) and stages their ring
// slots (>= 2), both from the wrapper's plan. A null kn drops the fresh
// columns (then ksn, vn, vsn are not read); the verify kernel then needs
// write_pos. Each returns the launch's CUDA error code (0 on success).
extern "C" int padt_int8_decode_attn(const void* q, const void* k8, const void* ks, const void* v8, const void* vs,
                                     const void* kn, const void* ksn, const void* vn, const void* vsn,
                                     const void* valid, const void* nvalid, void* out, int B, int Hkv, int G, int C,
                                     int hd, int layer, int nsplit, int stages, int quantize_q, float scale,
                                     void* stream) {
  using namespace padt;
  if (B == 0 || G == 0 || Hkv == 0) return 0;
  if (!plan_ok(nsplit, stages, hd) || (kn != nullptr && (ksn == nullptr || vn == nullptr || vsn == nullptr)))
    return (int)cudaErrorInvalidValue;
#define PADT_DECODE(HD)                                                                                              \
  case HD:                                                                                                           \
    return quantize_q ? launch_decode<HD, true>(q, k8, ks, v8, vs, kn, ksn, vn, vsn, valid, nvalid, out, B, Hkv, G, \
                                                C, layer, nsplit, stages, scale, stream)                             \
                      : launch_decode<HD, false>(q, k8, ks, v8, vs, kn, ksn, vn, vsn, valid, nvalid, out, B, Hkv, \
                                                 G, C, layer, nsplit, stages, scale, stream);
  switch (hd) {
    PADT_DECODE(16)
    PADT_DECODE(32)
    PADT_DECODE(64)
    PADT_DECODE(128)
    PADT_DECODE(256)
    default: return (int)cudaErrorInvalidValue;
  }
#undef PADT_DECODE
}

extern "C" int padt_int8_verify_attn(const void* q, const void* k8, const void* ks, const void* v8, const void* vs,
                                     const void* kn, const void* ksn, const void* vn, const void* vsn,
                                     const void* valid, const void* write_pos, void* out, int B, int Hkv, int R,
                                     int kq, int C, int hd, int layer, int nsplit, int stages, int row_tiles,
                                     float scale, void* stream) {
  using namespace padt;
  if (B == 0 || R == 0 || Hkv == 0) return 0;
  if (row_tiles != 1 && row_tiles != 2) return (int)cudaErrorInvalidValue;
  if (kn == nullptr && write_pos == nullptr) return (int)cudaErrorInvalidValue;
  if (!plan_ok(nsplit, stages, hd) || kq < 1 || (kn != nullptr && (ksn == nullptr || vn == nullptr || vsn == nullptr)))
    return (int)cudaErrorInvalidValue;
  const void* wp = kn == nullptr ? write_pos : nullptr;
#define PADT_VERIFY(HD)                                                                                           \
  case HD:                                                                                                        \
    return row_tiles == 2 ? launch_verify<HD, 2>(q, k8, ks, v8, vs, kn, ksn, vn, vsn, valid, wp, out, B, Hkv, R, kq, C, \
                                                 layer, nsplit, stages, scale, stream)                            \
                          : launch_verify<HD, 1>(q, k8, ks, v8, vs, kn, ksn, vn, vsn, valid, wp, out, B, Hkv, R, kq, C, \
                                                 layer, nsplit, stages, scale, stream);
  switch (hd) {
    PADT_VERIFY(16)
    PADT_VERIFY(32)
    PADT_VERIFY(64)
    PADT_VERIFY(128)
    case 256:  // two warpgroups split its output dims (VerifyParts); no second row tile
      if (row_tiles != 1) return (int)cudaErrorInvalidValue;
      return launch_verify<256, 1>(q, k8, ks, v8, vs, kn, ksn, vn, vsn, valid, wp, out, B, Hkv, R, kq, C, layer,
                                   nsplit, stages, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PADT_VERIFY
}

// H6: the new rows k8r / v8r (L, B, Hkv, kq, hd) int8, 16-byte aligned,
// and their scales ksr / vsr (L, B, Hkv, kq) fp32, all contiguous; rpt rows
// a thread (1 or 2), `block` threads a CTA (a multiple of 32, <= 1024), pdl
// 1 to launch under programmatic dependent launch.
extern "C" int padt_store_kv_rows(void* k8, void* ks, void* v8, void* vs, const void* k8r,
                                  const void* ksr, const void* v8r, const void* vsr,
                                  const void* pos, const void* n_rows, int L, int B, int Hkv,
                                  int C, int kq, int hd, int rpt, int block, int pdl, void* stream) {
  using namespace padt;
  if (L == 0 || B == 0 || Hkv == 0 || kq == 0) return 0;
  const int groups = (kq + rpt - 1) / rpt;
  const long long n_threads = 2LL * L * B * Hkv * groups * (hd / 16);
  if (hd % 16 != 0 || rpt <= 0 || block <= 0 || block > 1024 || block % 32 != 0 || n_threads >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((n_threads + block - 1) / block));
  cfg.blockDim = dim3(block);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  cudaError_t e = cudaSuccess;
#define PADT_STORE(RPT_)                                                                                          \
  e = cudaLaunchKernelEx(&cfg, store_rows_flat_kernel<RPT_>, static_cast<int8_t*>(k8), static_cast<float*>(ks),  \
                         static_cast<int8_t*>(v8), static_cast<float*>(vs), static_cast<const int8_t*>(k8r),     \
                         static_cast<const float*>(ksr), static_cast<const int8_t*>(v8r),                         \
                         static_cast<const float*>(vsr), static_cast<const int*>(pos),                            \
                         static_cast<const int*>(n_rows), (unsigned)B, (unsigned)Hkv, C, (unsigned)kq,            \
                         (unsigned)groups, (unsigned)(hd / 16), (unsigned)n_threads)
  switch (rpt) {
    case 1: PADT_STORE(1); break;
    case 2: PADT_STORE(2); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef PADT_STORE
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
