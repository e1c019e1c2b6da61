// The pieces of H3's mma.sync attention kernel (window_attn.cu): bf16
// tiles in shared memory, mma.sync m16n8k16 with fp32 accumulation, and one
// online-softmax step over a 64-key tile.
//
// CTA shape: 4 warps, 64 query rows (16 per warp), 64 keys per tile. Each
// warp owns its 16 rows end to end, so the softmax statistics never leave
// the warp (quad shuffles only).
//
// mma.sync fragment layouts (PTX ISA, m16n8k16 .bf16), lane = 4*g + t:
//   A 16x16 row-major: {a0,a1} (g, 2t..2t+1), {a2,a3} (g+8, 2t..),
//                      {a4,a5} (g, 2t+8..),   {a6,a7} (g+8, 2t+8..)
//   B 16x8 "col":      {b0,b1} (k=2t..2t+1, n=g), {b2,b3} (k=2t+8.., n=g)
//   C 16x8 fp32:       c0,c1 (g, 2t..2t+1), c2,c3 (g+8, 2t..2t+1)
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace padt {

typedef __nv_bfloat16 bf16;

constexpr int kRows = 64;     // query rows per CTA
constexpr int kCols = 64;     // keys per tile
constexpr int kThreads = 128; // 4 warps
constexpr int kLdT = kCols + 8;  // row pitch of the transposed V tile

// row pitch of a [64 x HD] tile: +8 elements (16 bytes) shifts consecutive
// rows by 4 banks, so the 8 rows a fragment load touches hit distinct banks
template <int HD>
struct Pitch {
  static constexpr int value = HD + 8;
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows [row0, row0 + 64) of a strided (seq, HD) bf16 matrix -> row-major
// smem tile; rows at or past n_rows are zero. 16-byte loads: the wrapper
// checks that the base pointer is 16-byte aligned and every stride is a
// multiple of 8 elements.
template <int HD>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, long long row_stride,
                                          int row0, int n_rows) {
  constexpr int CH = HD / 8;
  constexpr int LD = Pitch<HD>::value;
  for (int i = threadIdx.x; i < kRows * CH; i += kThreads) {
    const int r = i / CH, c = i % CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows)
      val = *reinterpret_cast<const uint4*>(g + (long long)(row0 + r) * row_stride + c * 8);
    *reinterpret_cast<uint4*>(s + r * LD + c * 8) = val;
  }
}

// the same rows, stored transposed (sT[d][r], pitch kLdT) so that the P.V
// B-fragments (two consecutive keys of one dim) are single 32-bit loads
template <int HD>
__device__ __forceinline__ void load_tile_t(bf16* sT, const bf16* g, long long row_stride,
                                            int row0, int n_rows) {
  constexpr int CH = HD / 8;
  for (int i = threadIdx.x; i < kRows * CH; i += kThreads) {
    const int r = i / CH, c = i % CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows)
      val = *reinterpret_cast<const uint4*>(g + (long long)(row0 + r) * row_stride + c * 8);
    const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j) sT[(c * 8 + j) * kLdT + r] = e[j];
  }
}

// this warp's 16 query rows of the smem Q tile -> A fragments, one per
// 16-wide slice of the head dim
template <int HD>
__device__ __forceinline__ void load_q_frags(uint32_t (&qf)[HD / 16][4], const bf16* sQ,
                                             int warp, int lane) {
  constexpr int LD = Pitch<HD>::value;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const bf16* p = sQ + (16 * warp + g) * LD + ks * 16 + 2 * t;
    qf[ks][0] = ld32(p);
    qf[ks][1] = ld32(p + 8 * LD);
    qf[ks][2] = ld32(p + 8);
    qf[ks][3] = ld32(p + 8 * LD + 8);
  }
}

// One online-softmax step of this warp's 16 rows against the 64-key tile in
// smem. valid(row, key) takes the CTA-local query row in [0, 64) and the
// tile-local key in [0, 64). m/l are the running max and this thread's
// partial row sums for its rows g and g+8.
template <int HD, class Valid>
__device__ __forceinline__ void attend_tile(const uint32_t (&qf)[HD / 16][4], const bf16* sK,
                                            const bf16* sVt, float scale, Valid valid,
                                            float (&m)[2], float (&l)[2],
                                            float (&acc)[HD / 8][4], int warp, int lane) {
  constexpr int LD = Pitch<HD>::value;
  const int g = lane >> 2, t = lane & 3;
  float s[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      const bf16* p = sK + (8 * j + g) * LD + ks * 16 + 2 * t;
      mma_16816(s[j], qf[ks], ld32(p), ld32(p + 8));
    }
  }
  const int r0 = 16 * warp + g;
  float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + (e >> 1) * 8;
      const int c = 8 * j + 2 * t + (e & 1);
      const float x = valid(r, c) ? s[j][e] * scale : -INFINITY;
      s[j][e] = x;
      tmax[e >> 1] = fmaxf(tmax[e >> 1], x);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 1));
    tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 2));
  }
  float corr[2], base[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m_new = fmaxf(m[h], tmax[h]);
    // a row with no valid key so far keeps m = -inf; exp(-inf - 0) = 0
    // keeps its p, l and acc at exactly 0 instead of NaN
    base[h] = (m_new == -INFINITY) ? 0.f : m_new;
    corr[h] = __expf(m[h] - base[h]);
    m[h] = m_new;
    l[h] *= corr[h];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = __expf(s[j][e] - base[e >> 1]);  // masked: exp(-inf) = 0
      s[j][e] = p;
      l[e >> 1] += p;
    }
  }
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    acc[n][0] *= corr[0];
    acc[n][1] *= corr[0];
    acc[n][2] *= corr[1];
    acc[n][3] *= corr[1];
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const bf16* p = sVt + (8 * n + g) * kLdT + 16 * kk + 2 * t;
      mma_16816(acc[n], a, ld32(p), ld32(p + 8));
    }
  }
}

// acc / l -> bf16 rows of a contiguous (.., HD) output; a row whose l is 0
// (no valid key) is written as zeros, like the TPU kernels' l > 0 guard.
// row_ptr(r) gives the output row for CTA-local row r, or nullptr to skip.
template <int HD, class RowPtr>
__device__ __forceinline__ void store_rows(float (&acc)[HD / 8][4], float (&l)[2],
                                           RowPtr row_ptr, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float x = l[h];
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    inv[h] = x > 0.f ? 1.f / x : 0.f;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    bf16* o = row_ptr(16 * warp + g + 8 * h);
    if (o == nullptr) continue;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * n + 2 * t) =
          __floats2bfloat162_rn(acc[n][2 * h] * inv[h], acc[n][2 * h + 1] * inv[h]);
    }
  }
}

}  // namespace padt
