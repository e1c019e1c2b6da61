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
// +-127, IEEE division), the dot is exact in int32 (dp4a), and the score is
// (float(dot) * qs) * (ks * hd^-0.5), in JAX's order; the fresh column then
// uses the dequantized q8 * qs. One max and one denominator over the cache
// and fresh columns. The cache side's p / denom * vs is rounded to bf16
// before its product with v8. The fresh side stays fp32 in H4,
// (p / denom) * (vn * vsn), and is rounded through bf16 in H5,
// bf16(p / denom * vsn) * vn. A row with no visible key gives the mean of
// the V rows (softmax over all -1e30 scores is uniform), except with an
// n_valid bound, where it gives 0 as K15 does (a masked key's p is 0 there).
//
// Bound on the H100: at decode the cache bytes (C * hd * 2 per slot and kv
// head) and memory latency: one (slot, kv head) has only G = 8 query rows,
// so a grid of one CTA per (slot, head) would give 2 * n_slots CTAs that each
// stream a whole (C, hd) tile with few loads in flight. The columns are
// therefore split over a cluster of S CTAs (Hopper thread-block clusters;
// the wrapper picks S in {1, 2, 4, 8} so that the grid has about two CTAs
// per SM): each CTA scores its C / S columns, the CTAs exchange row maxima
// and then row sums through distributed shared memory, so every CTA rounds
// p / denom * vs to bf16 against the global denominator exactly as the
// one-pass softmax does; each then sums P.V over its own columns, and rank k
// adds the S partial rows for its hd / S output dims. A suffix pass (kq = 32:
// 32x the rows) already fills the card with S = 1.
// Within a CTA: scores one thread per key column, 16-byte loads of its int8
// row, q broadcast from shared memory (fp32 FMAs, or four dp4a per 16 bytes
// with quantize_q); P.V with hd / 4 lanes per V row in 4-byte (char4)
// loads, the column groups summed through shared memory. Rank 0 also owns
// the fresh columns. No tensor cores and no load pipelining yet.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace padt {

namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;  // the JAX package's finite mask value
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;  // query rows per CTA (G = 8 at decode)
constexpr int kMaxSplit = 8;  // the largest portable cluster

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared floats one CTA needs: q rows, score rows over its columns and the
// fresh ones, the P.V group partials, its P.V share, the row statistics, the
// int8 q rows (four to a word) and their scales.
inline size_t attn_smem_floats(int C, int n_fresh, int hd, int nsplit) {
  const int chunk = (C + nsplit - 1) / nsplit;
  const int groups = kThreads / (hd / 4);
  return (size_t)kRows * hd + (size_t)kRows * (chunk + n_fresh) + (size_t)groups * kRows * hd +
         (size_t)kRows * hd + 2 * kRows + (size_t)kRows * hd / 4 + kRows;
}

// Rows r of one (slot b, kv head h) are the flattened (G, kq) query rows,
// r = gi * kq + i; fresh column j is visible to row r iff r % kq >= j, and
// without fresh columns (write_pos given) cache column c is visible to row r
// iff c <= write_pos[b] + r % kq. Grid (S * row blocks, Hkv, B) in clusters
// of (S, 1, 1); the S CTAs of a cluster share one row block and split the
// cache columns.
__global__ void __launch_bounds__(kThreads)
    int8_attn_kernel(const bf16* __restrict__ q,          // (B, Hkv, R, hd)
                     const int8_t* __restrict__ k8,       // (L, B, Hkv, C, hd)
                     const float* __restrict__ ks,        // (L, B, Hkv, C)
                     const int8_t* __restrict__ v8,
                     const float* __restrict__ vs,
                     const int8_t* __restrict__ kn,       // (B, Hkv, kq, hd) or null
                     const float* __restrict__ ksn,       // (B, Hkv, kq)
                     const int8_t* __restrict__ vn,
                     const float* __restrict__ vsn,
                     const uint8_t* __restrict__ valid,   // (B, C)
                     const int* __restrict__ nvalid,      // (B,) or null: columns read are < nvalid[b]
                     const int* __restrict__ write_pos,   // (B,) or null: the causal limit
                     bf16* __restrict__ out,              // (B, Hkv, R, hd)
                     int B, int Hkv, int R, int C, int kq, int n_fresh, int hd, int layer,
                     int fresh_bf16, int quantize_q, float scale) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int nsplit = (int)cluster.num_blocks();
  const int b = blockIdx.z, h = blockIdx.y;
  const int r0 = (blockIdx.x / nsplit) * kRows;
  const int nr = min(kRows, R - r0);
  const int chunk = (C + nsplit - 1) / nsplit;
  const int c0 = min(C, rank * chunk);
  int nc = min(C, c0 + chunk) - c0;  // this CTA's cache columns [c0, c0 + nc)
  if (nvalid != nullptr) nc = max(0, min(nc, nvalid[b] - c0));  // columns at or past n_valid are never read
  const int W = chunk + n_fresh;  // a score row: this CTA's columns, then the fresh columns
  const int tpc = hd / 4;         // threads per V row in the P.V step
  const int groups = kThreads / tpc;
  float* qs = smem;                         // [kRows][hd]
  float* s = qs + kRows * hd;               // [kRows][W]
  float* red = s + kRows * W;               // [groups][kRows][hd]
  float* part = red + groups * kRows * hd;  // [kRows][hd]: P.V over this CTA's columns
  float* stat = part + kRows * hd;          // [2][kRows]: row max, then row sum
  int* q8w = reinterpret_cast<int*>(stat + 2 * kRows);                // [kRows][hd / 4]
  float* qsc = reinterpret_cast<float*>(q8w + kRows * (hd / 4));     // [kRows]

  const long long bh = (long long)b * Hkv + h;
  const long long lbh = ((long long)layer * B + b) * Hkv + h;
  const int8_t* kc = k8 + (lbh * C + c0) * hd;
  const int8_t* vc = v8 + (lbh * C + c0) * hd;
  const float* ksc = ks + lbh * C + c0;
  const float* vsc = vs + lbh * C + c0;
  const uint8_t* val = valid + (long long)b * C + c0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bool fresh_here = rank == 0 && n_fresh > 0;
  const bool zero_empty = nvalid != nullptr;  // K15: a masked key's p is 0
  const int wp = write_pos != nullptr ? write_pos[b] : 0;

  // 1. this block's query rows in fp32 (rows past R are zero)
  for (int i = tid; i < kRows * hd; i += kThreads) {
    const int rr = i / hd;
    qs[i] = rr < nr ? __bfloat162float(q[(bh * R + r0) * hd + i]) : 0.f;
  }
  __syncthreads();

  // 1b. quantize_q: each row to int8 with its own scale (one warp per row);
  //     qs keeps the dequantized row q8 * qs for the fresh columns
  if (quantize_q) {
    for (int rr = warp; rr < kRows; rr += kWarps) {
      float* qrow = qs + rr * hd;
      float amax = 0.f;
      for (int d = lane; d < hd; d += 32) amax = fmaxf(amax, fabsf(qrow[d]));
      amax = warp_max(amax);
      const float sc = fmaxf(amax, 1e-8f) / 127.f;
      int8_t* q8 = reinterpret_cast<int8_t*>(q8w + rr * (hd / 4));
      for (int d = lane; d < hd; d += 32) {
        const float v = fminf(fmaxf(rintf(qrow[d] / sc), -127.f), 127.f);
        q8[d] = (int8_t)v;
        qrow[d] = v * sc;
      }
      if (lane == 0) qsc[rr] = sc;
    }
    __syncthreads();
  }

  // 2. cache scores, one thread per key column
  for (int c = tid; c < nc; c += kThreads) {
    float dot[kRows];
    const int4* krow = reinterpret_cast<const int4*>(kc + (long long)c * hd);
    if (quantize_q) {
      int acc[kRows];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) acc[rr] = 0;
      for (int d0 = 0; d0 < hd; d0 += 16) {
        const int4 raw = krow[d0 / 16];
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) {
          const int* qw = q8w + rr * (hd / 4) + d0 / 4;
          int a = acc[rr];
          a = __dp4a(raw.x, qw[0], a);
          a = __dp4a(raw.y, qw[1], a);
          a = __dp4a(raw.z, qw[2], a);
          a = __dp4a(raw.w, qw[3], a);
          acc[rr] = a;
        }
      }
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) dot[rr] = (float)acc[rr] * qsc[rr];
    } else {
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) dot[rr] = 0.f;
      for (int d0 = 0; d0 < hd; d0 += 16) {
        const int4 raw = krow[d0 / 16];
        const int8_t* kv = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const float kf = (float)kv[e];
#pragma unroll
          for (int rr = 0; rr < kRows; ++rr) dot[rr] += qs[rr * hd + d0 + e] * kf;
        }
      }
    }
    const bool ok = val[c] != 0;
    const float f = ksc[c] * scale;
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const bool vis = ok && (write_pos == nullptr || c0 + c <= wp + (r0 + rr) % kq);
      s[rr * W + c] = vis ? dot[rr] * f : kNegInf;
    }
  }

  // 3. fresh scores (rank 0), fp32 dot of q with the new int8 key rows
  if (fresh_here) {
    for (int i = tid; i < nr * n_fresh; i += kThreads) {
      const int rr = i / n_fresh, j = i % n_fresh;
      float sc = kNegInf;
      if ((r0 + rr) % kq >= j) {
        const int8_t* knr = kn + (bh * kq + j) * hd;
        float acc = 0.f;
        for (int d = 0; d < hd; ++d) acc += qs[rr * hd + d] * (float)knr[d];
        sc = acc * (ksn[bh * kq + j] * scale);
      }
      s[rr * W + chunk + j] = sc;
    }
  }
  __syncthreads();

  // 4. softmax over the whole row, across the cluster (one warp per row):
  //    a. the row max over this CTA's columns
  for (int rr = warp; rr < kRows; rr += kWarps) {
    const float* row = s + rr * W;
    float m = kNegInf;
    if (rr < nr) {
      for (int c = lane; c < nc; c += 32) m = fmaxf(m, row[c]);
      if (fresh_here)
        for (int j = lane; j < n_fresh; j += 32) m = fmaxf(m, row[chunk + j]);
    }
    m = warp_max(m);
    if (lane == 0) stat[rr] = m;
  }
  cluster.sync();
  //    b. the global max; exp and the row sum over this CTA's columns
  for (int rr = warp; rr < kRows; rr += kWarps) {
    float* row = s + rr * W;
    float m = kNegInf;
    for (int k = 0; k < nsplit; ++k) m = fmaxf(m, cluster.map_shared_rank(stat, k)[rr]);
    float l = 0.f;
    if (rr < nr) {
      for (int c = lane; c < nc; c += 32) {
        const float p = (zero_empty && row[c] == kNegInf) ? 0.f : expf(row[c] - m);
        row[c] = p;
        l += p;
      }
      if (fresh_here) {
        for (int j = lane; j < n_fresh; j += 32) {
          const float p = expf(row[chunk + j] - m);
          row[chunk + j] = p;
          l += p;
        }
      }
    }
    l = warp_sum(l);
    if (lane == 0) stat[kRows + rr] = l;
  }
  cluster.sync();
  //    c. the global denominator; the P.V operands bf16(p / denom * vs) for
  //       the cache, and for the fresh columns p / denom (H4) or
  //       bf16(p / denom * vsn) (H5); a row whose denominator is 0 (no
  //       visible key under an n_valid bound) gives 0
  for (int rr = warp; rr < nr; rr += kWarps) {
    float* row = s + rr * W;
    float l = 0.f;
    for (int k = 0; k < nsplit; ++k) l += cluster.map_shared_rank(stat, k)[kRows + rr];
    for (int c = lane; c < nc; c += 32) row[c] = l > 0.f ? bf16_round(row[c] / l * vsc[c]) : 0.f;
    if (fresh_here) {
      for (int j = lane; j < n_fresh; j += 32) {
        const float pf = row[chunk + j] / l;
        row[chunk + j] = fresh_bf16 ? bf16_round(pf * vsn[bh * kq + j]) : pf;
      }
    }
  }
  __syncthreads();

  // 5. P.V over this CTA's columns: thread (group g, quad dq) sums output
  //    dims 4*dq..4*dq+3 of every row over the columns c = g, g + groups, ...
  const int g = tid / tpc, dq = tid % tpc;
  float acc[kRows][4];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[rr][e] = 0.f;
  for (int c = g; c < nc; c += groups) {
    const char4 v4 = reinterpret_cast<const char4*>(vc + (long long)c * hd)[dq];
    const float vf[4] = {(float)v4.x, (float)v4.y, (float)v4.z, (float)v4.w};
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const float p = s[rr * W + c];
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[rr][e] += p * vf[e];
    }
  }
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr)
#pragma unroll
    for (int e = 0; e < 4; ++e) red[(g * kRows + rr) * hd + dq * 4 + e] = acc[rr][e];
  __syncthreads();
  for (int i = tid; i < kRows * hd; i += kThreads) {
    float o = 0.f;
    for (int gg = 0; gg < groups; ++gg) o += red[gg * kRows * hd + i];
    part[i] = o;
  }
  cluster.sync();

  // 6. rank k owns output dims [k * dpr, (k + 1) * dpr): it sums the cluster's
  //    P.V shares, adds the fresh columns' term (rank 0's score rows), and
  //    writes bf16
  const int dpr = hd / nsplit;
  const float* s0 = cluster.map_shared_rank(s, 0);
  for (int i = tid; i < nr * dpr; i += kThreads) {
    const int rr = i / dpr, d = rank * dpr + i % dpr;
    float o = 0.f;
    for (int k = 0; k < nsplit; ++k) o += cluster.map_shared_rank(part, k)[rr * hd + d];
    if (n_fresh > 0) {
      const float* fr = s0 + rr * W + chunk;
      if (fresh_bf16) {
        float f = 0.f;
        for (int j = 0; j < n_fresh; ++j) f += fr[j] * (float)vn[(bh * kq + j) * hd + d];
        o += f;
      } else {  // kq == 1
        o += fr[0] * ((float)vn[bh * hd + d] * vsn[bh]);
      }
    }
    out[(bh * R + r0 + rr) * hd + d] = __float2bfloat16(o);
  }
  cluster.sync();  // no CTA leaves while another still reads its shared memory
}

int launch_attn(const void* q, const void* k8, const void* ks, const void* v8, const void* vs,
                const void* kn, const void* ksn, const void* vn, const void* vsn,
                const void* valid, const void* nvalid, const void* write_pos, void* out, int B,
                int Hkv, int R, int C, int kq, int hd, int layer, int nsplit, int fresh_bf16,
                int quantize_q, float scale, void* stream) {
  if (B == 0 || R == 0) return 0;
  const int n_fresh = kn != nullptr ? kq : 0;
  if (nsplit < 1 || nsplit > kMaxSplit || hd % nsplit != 0 || kq < 1 ||
      (n_fresh > 0 && (ksn == nullptr || vn == nullptr || vsn == nullptr)))
    return (int)cudaErrorInvalidValue;
  const size_t bytes = sizeof(float) * attn_smem_floats(C, n_fresh, hd, nsplit);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        int8_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nsplit * ((R + kRows - 1) / kRows), Hkv, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, int8_attn_kernel, static_cast<const bf16*>(q), static_cast<const int8_t*>(k8),
      static_cast<const float*>(ks), static_cast<const int8_t*>(v8), static_cast<const float*>(vs),
      static_cast<const int8_t*>(kn), static_cast<const float*>(ksn),
      static_cast<const int8_t*>(vn), static_cast<const float*>(vsn),
      static_cast<const uint8_t*>(valid), static_cast<const int*>(nvalid),
      static_cast<const int*>(write_pos), static_cast<bf16*>(out), B, Hkv, R, C, kq, n_fresh, hd,
      layer, fresh_bf16, quantize_q, scale);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// H6: block (h, b, l) copies rows j < n_rows[b] of the new K/V and scales to
// rows pos[b] + j of layer l; rows outside [0, C) are dropped.
__global__ void store_rows_kernel(int8_t* __restrict__ k8, float* __restrict__ ks,
                                  int8_t* __restrict__ v8, float* __restrict__ vs,
                                  const int8_t* __restrict__ k8r, const float* __restrict__ ksr,
                                  const int8_t* __restrict__ v8r, const float* __restrict__ vsr,
                                  const int* __restrict__ pos, const int* __restrict__ n_rows,
                                  int B, int Hkv, int C, int kq, int hd) {
  const int h = blockIdx.x, b = blockIdx.y, l = blockIdx.z;
  const int p = pos[b];
  const int n = min(n_rows[b], kq);
  const long long lbh = ((long long)l * B + b) * Hkv + h;
  const int chunks = hd / 16;
  for (int i = threadIdx.x; i < n * chunks; i += blockDim.x) {
    const int j = i / chunks, e = i % chunks;
    const int row = p + j;
    if (row < 0 || row >= C) continue;
    reinterpret_cast<int4*>(k8 + (lbh * C + row) * hd)[e] =
        reinterpret_cast<const int4*>(k8r + (lbh * kq + j) * hd)[e];
    reinterpret_cast<int4*>(v8 + (lbh * C + row) * hd)[e] =
        reinterpret_cast<const int4*>(v8r + (lbh * kq + j) * hd)[e];
  }
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const int row = p + j;
    if (row < 0 || row >= C) continue;
    ks[lbh * C + row] = ksr[lbh * kq + j];
    vs[lbh * C + row] = vsr[lbh * kq + j];
  }
}

}  // namespace padt

// C entry points (loaded with ctypes). Every tensor is contiguous in the
// layout named above; valid is bool (one byte); nvalid, write_pos, pos and
// n_rows are int32; nsplit is the attention kernels' cluster size S. A null
// kn drops the fresh columns (then ksn, vn, vsn are not read); the verify
// kernel then needs write_pos. Each returns the launch's CUDA error code (0
// on success).
extern "C" int padt_int8_decode_attn(const void* q, const void* k8, const void* ks,
                                     const void* v8, const void* vs, const void* kn,
                                     const void* ksn, const void* vn, const void* vsn,
                                     const void* valid, const void* nvalid, void* out, int B,
                                     int Hkv, int G, int C, int hd, int layer, int nsplit,
                                     int quantize_q, float scale, void* stream) {
  return padt::launch_attn(q, k8, ks, v8, vs, kn, ksn, vn, vsn, valid, nvalid, nullptr, out, B, Hkv,
                           G, C, 1, hd, layer, nsplit, 0, quantize_q, scale, stream);
}

extern "C" int padt_int8_verify_attn(const void* q, const void* k8, const void* ks,
                                     const void* v8, const void* vs, const void* kn,
                                     const void* ksn, const void* vn, const void* vsn,
                                     const void* valid, const void* write_pos, void* out, int B,
                                     int Hkv, int R, int kq, int C, int hd, int layer, int nsplit,
                                     float scale, void* stream) {
  if (kn == nullptr && write_pos == nullptr) return (int)cudaErrorInvalidValue;
  return padt::launch_attn(q, k8, ks, v8, vs, kn, ksn, vn, vsn, valid, nullptr,
                           kn == nullptr ? write_pos : nullptr, out, B, Hkv, R, C, kq, hd, layer,
                           nsplit, 1, 0, scale, stream);
}

extern "C" int padt_store_kv_rows(void* k8, void* ks, void* v8, void* vs, const void* k8r,
                                  const void* ksr, const void* v8r, const void* vsr,
                                  const void* pos, const void* n_rows, int L, int B, int Hkv,
                                  int C, int kq, int hd, void* stream) {
  using namespace padt;
  if (L == 0 || B == 0 || Hkv == 0 || kq == 0) return 0;
  const dim3 grid(Hkv, B, L);
  store_rows_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(k8), static_cast<float*>(ks), static_cast<int8_t*>(v8),
      static_cast<float*>(vs), static_cast<const int8_t*>(k8r), static_cast<const float*>(ksr),
      static_cast<const int8_t*>(v8r), static_cast<const float*>(vsr),
      static_cast<const int*>(pos), static_cast<const int*>(n_rows), B, Hkv, C, kq, hd);
  return (int)cudaGetLastError();
}
