// The segment-tile skip of the attention kernels H2 (segment_flash.cu), H8
// and H9 (flash_bwd.cu): a summary of the segment ids of each query and key
// tile, and the test that decides whether a pair of tiles can hold a visible
// (query, key) pair.
//
// A tile's summary is {lowest valid id (INT_MAX if none), highest id (-1 if
// none is valid), lowest id (-1 if any row is padding or past the end), 0}.
// Two tiles can hold a visible pair only if the intervals [lo, hi] of their
// valid ids meet (`meets`): JAX's per-block intersection test in
// `_kblock_ranges` (padt_tpu/ops/pallas_attention.py:139), without its
// closure into one [lo, hi) range, so the tiles visited lie inside that
// range. Two tiles whose rows all carry one and the same valid id
// (`one_segment`) need no mask between them, except on the causal diagonal.
// `segment_tiles_plain` (ops/cuda_attention.py) states the rule in PyTorch.
//
// A CTA keeps the summaries of the tiles it reads in a table in shared
// memory, filled once by several warps with all their loads in flight; past
// the table's size, a tile is summarised where it is needed.
#pragma once

#include <climits>
#include <cuda_runtime.h>

namespace padt {
namespace segtiles {

constexpr int kSumBatch = 8;  // tiles a warp summarises per round of loads

// A warp's summary of one tile; v holds this lane's four of its ids.
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

// This lane's four ids of the tile of `rows` (64 or 128) ids seg[p0, ...):
// p0 + lane + 32 r, a 64-row tile's two read twice; those at or past n, or
// all when !any, count as -1.
__device__ __forceinline__ void load_ids(int (&v)[4], const int* seg, int p0, int n, int rows, bool any) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int p = p0 + lane + 32 * (r & (rows / 32 - 1));
    v[r] = any && p < n ? __ldg(seg + p) : -1;
  }
}

// The tiles of a table: the query tiles of `bq` rows of B batch rows, then
// their key tiles of `bk` rows, each row's tiles in order.
struct Tables {
  const int *q_seg, *k_seg;
  int Sq, Sk, bq, bk, n_qt, n_kt, n_q, n_all;

  __device__ __forceinline__ Tables(const int* qs, const int* ks, int sq, int sk, int bq_, int bk_, int B)
      : q_seg(qs), k_seg(ks), Sq(sq), Sk(sk), bq(bq_), bk(bk_) {
    n_qt = (Sq + bq - 1) / bq, n_kt = (Sk + bk - 1) / bk;
    n_q = B * n_qt, n_all = n_q + B * n_kt;
  }

  __device__ __forceinline__ void locate(int e, const int*& seg, int& p0, int& n, int& rows) const {
    if (e < n_q) {
      seg = q_seg + (long long)(e / n_qt) * Sq, p0 = (e % n_qt) * bq, n = Sq, rows = bq;
    } else {
      e -= n_q;
      seg = k_seg + (long long)(e / n_kt) * Sk, p0 = (e % n_kt) * bk, n = Sk, rows = bk;
    }
  }
};

// Warps warp, warp + n_warps, ... fill the table, kSumBatch tiles per warp
// at a time with all their loads in flight.
__device__ __forceinline__ void fill_table(const Tables& tb, int4* sums, int warp, int n_warps) {
  const int lane = threadIdx.x & 31;
  for (int e0 = warp * kSumBatch; e0 < tb.n_all; e0 += n_warps * kSumBatch) {
    int v[kSumBatch][4];
#pragma unroll
    for (int u = 0; u < kSumBatch; ++u) {
      const int* seg;
      int p0, n, rows;
      tb.locate(min(e0 + u, tb.n_all - 1), seg, p0, n, rows);
      load_ids(v[u], seg, p0, n, rows, e0 + u < tb.n_all);
    }
#pragma unroll
    for (int u = 0; u < kSumBatch; ++u) {
      const int4 sm = summarize(v[u]);
      if (lane == 0 && e0 + u < tb.n_all) sums[e0 + u] = sm;
    }
  }
}

// Entry e of the table, or computed here (by a whole warp) when the table
// did not fit.
__device__ __forceinline__ int4 summary(const Tables& tb, const int4* sums, bool in_table, int e) {
  if (in_table) return sums[e];
  const int* seg;
  int p0, n, rows;
  tb.locate(e, seg, p0, n, rows);
  int v[4];
  load_ids(v, seg, p0, n, rows, true);
  return summarize(v);
}

// the valid ids of two tiles can meet
__device__ __forceinline__ bool meets(int4 a, int4 b) { return a.y >= b.x && a.x <= b.y; }

// every row of the tile is valid and carries one id (a.z)
__device__ __forceinline__ bool one_segment(int4 a) { return a.z == a.y && a.z >= 0; }

}  // namespace segtiles
}  // namespace padt
