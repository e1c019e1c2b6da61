// The deterministic fold of fp32 partial sums across a thread-block
// cluster: each CTA stages its partial tile in its own shared memory, a
// cluster barrier follows, and the CTA that owns a piece of the output reads
// that piece from every CTA's shared memory (distributed shared memory) and
// sums it in rank order, 0 first. No atomics: every sum is taken in one
// fixed order, so a rerun gives the same bits. Used by H9 (flash_bwd.cu, the
// GQA heads) and by the GEMMs of gemm_sm90.cuh (the K splits).
#pragma once

#include <cooperative_groups.h>

namespace padt {
namespace fold {

namespace cg = cooperative_groups;

// acc[0..7] = the sum over ranks 0, 1, ..., C - 1, in that order, of the 8
// floats at `src` (16-byte aligned, in this CTA's shared memory) at the same
// offset in each rank's shared memory. The loads of four ranks are issued
// before their adds, so their latencies overlap (four, not all eight: the
// registers they hold are the caller's occupancy).
__device__ __forceinline__ void fold8(cg::cluster_group& cluster, float* src, int C, float (&acc)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  for (int c0 = 0; c0 < C; c0 += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (c0 + j < C) {
        const float4* p = reinterpret_cast<const float4*>(cluster.map_shared_rank(src, c0 + j));
        a[j] = p[0], b[j] = p[1];
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // in rank order
      if (c0 + j < C) {
        acc[0] += a[j].x, acc[1] += a[j].y, acc[2] += a[j].z, acc[3] += a[j].w;
        acc[4] += b[j].x, acc[5] += b[j].y, acc[6] += b[j].z, acc[7] += b[j].w;
      }
    }
  }
}

}  // namespace fold
}  // namespace padt
