// H8 flash_bwd_dq and H9 flash_bwd_dkv: the flash-attention backward of the
// segment-id attention that H2 (segment_flash.cu) runs forward, from the
// forward's saved log-sum-exp and delta = rowsum(dO * O).
//
// Replaces the two TPU kernels of the flash VJP:
//   padt_tpu/ops/pallas_attention.py::_bwd_dq_kernel   (dq)
//   padt_tpu/ops/pallas_attention.py::_bwd_dkv_kernel  (dk, dv; GQA heads
//                                                       folded in-kernel)
// Same visibility rule as H2: key c is visible to query r iff
// q_seg[r] == k_seg[c] && k_seg[c] >= 0, and r >= c when causal; query head
// h reads kv head h / (H / Hkv). For each visible (r, c):
//   p  = exp(s * scale - lse[r])            (0 where not visible)
//   dp = dO[r] . v[c]
//   ds = p * (dp - delta[r]) * scale,        rounded to bf16 before ds.k, ds^T.q
//   dq[r] += ds * k[c];  dk[c] += ds * q[r];  dv[c] += bf16(p) * dO[r]
// A row with no visible key carries lse = +1e30 (H2's LSE output), so its p
// is exactly 0.
//
// Bound on the H100: compute. Each visible (r, c) pair costs 4 products of
// length hd in each kernel (s and dp in both; dq, or dk and dv); at PaDT-3B's
// train step (B 8, L 640, 16/2 heads of 128, causal) that is ~27 GFLOP per
// layer per kernel against ~50 MB of q/k/v/dO/dq/dk/dv.
//
// Layout and design (JAX's, not its block structure):
//   dq:  one CTA per (q-block of 64 rows, h, b), looping over k-blocks up to
//        the causal diagonal; 4 warps own 16 query rows each, the dq sums stay
//        in registers.
//   dkv: one CTA per (k-block of 64 keys, hkv, b), looping over the H / Hkv
//        query heads of its group and the q-blocks from the causal diagonal
//        on; 4 warps own 16 keys each, the dk and dv sums stay in fp32
//        registers across the whole group and are rounded to bf16 once.
// Neither kernel needs atomics, so the gradients are the same bits from run
// to run. bf16 mma.sync m16n8k16 with fp32 accumulation; the A operands are
// read from row-major tiles in shared memory, the k-pair B operands that run
// along a row-major tile's rows come from ldmatrix.trans. Not yet: the
// segment-range k-block skip of `_kblock_ranges`, cp.async/TMA load
// pipelining, wgmma.
//
// Tensors: q, dO (B, Sq, H, HD), k, v (B, Sk, Hkv, HD) bf16 with unit last
// stride and other strides multiples of 8 elements; segment ids (B, S)
// int32; lse, delta (B, H, Sq) fp32; outputs dq (B, Sq, H, HD), dk, dv
// (B, Sk, Hkv, HD) bf16, contiguous.
#include "attn_mma.cuh"

namespace padt {

// four 8x8 bf16 matrices, transposed: lane l gives the address of row l % 8
// of matrix l / 8; register i holds matrix i's (row 2t..2t+1, column g)
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// A fragment (16 rows from row r0, head-dim slice ks) of a row-major
// [64 x HD] smem tile of pitch LD
template <int LD>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const bf16* s, int r0, int ks, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bf16* p = s + (r0 + g) * LD + ks * 16 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * LD);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * LD + 8);
}

// acc[n] (16 x HD, n8 tiles) += A (16 x 16, registers) . T[k0 .. k0+16][0 .. HD)
// where T is a row-major [rows x HD] smem tile of pitch LD
template <int HD, int LD>
__device__ __forceinline__ void mma_rows(float (&acc)[HD / 8][4], const uint32_t (&a)[4],
                                         const bf16* T, int k0, int lane) {
  const int mi = lane >> 3;
#pragma unroll
  for (int jp = 0; jp < HD / 16; ++jp) {
    uint32_t b[4];
    ldsm_x4_trans(b, T + (k0 + (mi & 1) * 8 + (lane & 7)) * LD + 16 * jp + (mi >> 1) * 8);
    mma_16816(acc[2 * jp], a, b[0], b[1]);
    mma_16816(acc[2 * jp + 1], a, b[2], b[3]);
  }
}

// C fragments of two adjacent n8 tiles (16 x 16) -> the A fragment of the
// next product, rounded to bf16
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&lo)[4], const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// 16 x HD fp32 accumulators of this warp -> bf16 rows; row_ptr(r) gives the
// output row for CTA-local row r, or nullptr to skip it
template <int HD, class RowPtr>
__device__ __forceinline__ void store_acc(const float (&acc)[HD / 8][4], RowPtr row_ptr, int warp,
                                          int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    bf16* o = row_ptr(16 * warp + g + 8 * hh);
    if (o == nullptr) continue;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * n + 2 * t) =
          __floats2bfloat162_rn(acc[n][2 * hh], acc[n][2 * hh + 1]);
  }
}

struct Strides {
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, g_sb, g_ss, g_sh;
};

template <int HD>
constexpr int tile_bytes() {
  return kRows * Pitch<HD>::value * (int)sizeof(bf16);
}

// ---------------------------------------------------------------------------
// H8: dq
// ---------------------------------------------------------------------------

template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ go,
                    const int* __restrict__ q_seg, const int* __restrict__ k_seg,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int Sq, int Sk, int H, int Hkv, Strides st,
                    float scale) {
  constexpr int LD = Pitch<HD>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sG = sQ + kRows * LD;
  bf16* sK = sG + kRows * LD;
  bf16* sV = sK + kRows * LD;
  int* sSeg = reinterpret_cast<int*>(sV + kRows * LD);

  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const bf16* kb = k + b * st.k_sb + hk * st.k_sh;
  const bf16* vb = v + b * st.v_sb + hk * st.v_sh;
  const int* ksb = k_seg + (long long)b * Sk;
  load_tile<HD>(sQ, q + b * st.q_sb + h * st.q_sh, st.q_ss, q0, Sq);
  load_tile<HD>(sG, go + b * st.g_sb + h * st.g_sh, st.g_ss, q0, Sq);

  // this thread's two query rows: g and g + 8 of the warp's 16
  int qseg[2], qpos[2];
  float rlse[2], rdelta[2];
  const long long row0 = ((long long)b * H + h) * Sq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qpos[i] = q0 + 16 * warp + g + 8 * i;
    const bool in = qpos[i] < Sq;
    qseg[i] = in ? q_seg[(long long)b * Sq + qpos[i]] : -1;
    rlse[i] = in ? lse[row0 + qpos[i]] : kBigLse;
    rdelta[i] = in ? delta[row0 + qpos[i]] : 0.f;
  }

  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  int n_tiles = (Sk + kCols - 1) / kCols;
  if (CAUSAL) n_tiles = min(n_tiles, q0 / kCols + 1);  // kRows == kCols
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kCols;
    load_tile<HD>(sK, kb, st.k_ss, k0, Sk);
    load_tile<HD>(sV, vb, st.v_ss, k0, Sk);
    for (int i = threadIdx.x; i < kCols; i += kThreads) sSeg[i] = k0 + i < Sk ? ksb[k0 + i] : -1;
    __syncthreads();

    // s = q k^T and dp = dO v^T for the warp's 16 rows x 64 keys
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      uint32_t qa[4], ga[4];
      a_frag<LD>(qa, sQ, 16 * warp, ks, lane);
      a_frag<LD>(ga, sG, 16 * warp, ks, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bf16* pk = sK + (8 * j + g) * LD + ks * 16 + 2 * t;
        const bf16* pv = sV + (8 * j + g) * LD + ks * 16 + 2 * t;
        mma_16816(s[j], qa, ld32(pk), ld32(pk + 8));
        mma_16816(dp[j], ga, ld32(pv), ld32(pv + 8));
      }
    }
    // ds = p * (dp - delta) * scale, p = exp(s * scale - lse) where visible
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int c = 8 * j + 2 * t + (e & 1);
        const int ks_ = sSeg[c];
        bool ok = ks_ >= 0 && ks_ == qseg[i];
        if (CAUSAL) ok = ok && qpos[i] >= k0 + c;
        const float p = ok ? __expf(s[j][e] * scale - rlse[i]) : 0.f;
        s[j][e] = p * (dp[j][e] - rdelta[i]) * scale;
      }
    }
    // dq += ds . k
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      c_to_a(a, s[2 * kk], s[2 * kk + 1]);
      mma_rows<HD, LD>(acc, a, sK, 16 * kk, lane);
    }
    __syncthreads();
  }

  bf16* ob = dq + ((long long)b * Sq * H + h) * HD;
  store_acc<HD>(acc, [&](int r) -> bf16* {
    const int qi = q0 + r;
    return qi < Sq ? ob + (long long)qi * H * HD : nullptr;
  }, warp, lane);
}

// ---------------------------------------------------------------------------
// H9: dk, dv
// ---------------------------------------------------------------------------

template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ go,
                     const int* __restrict__ q_seg, const int* __restrict__ k_seg,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk, int H,
                     int Hkv, Strides st, float scale) {
  constexpr int LD = Pitch<HD>::value;
  constexpr int kHalf = kRows / 2;  // queries per inner step (bounds the registers)
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kRows * LD;
  bf16* sQ = sV + kRows * LD;
  bf16* sG = sQ + kRows * LD;
  float* sLse = reinterpret_cast<float*>(sG + kRows * LD);
  float* sDelta = sLse + kRows;
  int* sQseg = reinterpret_cast<int*>(sDelta + kRows);

  const int k0 = blockIdx.x * kRows;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = H / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  load_tile<HD>(sK, k + b * st.k_sb + hk * st.k_sh, st.k_ss, k0, Sk);
  load_tile<HD>(sV, v + b * st.v_sb + hk * st.v_sh, st.v_ss, k0, Sk);

  // this thread's two keys: g and g + 8 of the warp's 16
  int kseg[2], kpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    kpos[i] = k0 + 16 * warp + g + 8 * i;
    kseg[i] = kpos[i] < Sk ? k_seg[(long long)b * Sk + kpos[i]] : -1;
  }

  float dk_acc[HD / 8][4], dv_acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  const int n_qt = (Sq + kRows - 1) / kRows;
  const int qt0 = CAUSAL ? k0 / kRows : 0;  // earlier q-blocks see none of these keys
  const int* qsb = q_seg + (long long)b * Sq;
  for (int r = 0; r < rep; ++r) {
    const int h = hk * rep + r;
    const bf16* qb = q + b * st.q_sb + h * st.q_sh;
    const bf16* gb = go + b * st.g_sb + h * st.g_sh;
    const long long row0 = ((long long)b * H + h) * Sq;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * kRows;
      __syncthreads();  // the previous step's tiles are no longer read
      load_tile<HD>(sQ, qb, st.q_ss, q0, Sq);
      load_tile<HD>(sG, gb, st.g_ss, q0, Sq);
      for (int i = threadIdx.x; i < kRows; i += kThreads) {
        const bool in = q0 + i < Sq;
        sQseg[i] = in ? qsb[q0 + i] : -1;
        sLse[i] = in ? lse[row0 + q0 + i] : kBigLse;
        sDelta[i] = in ? delta[row0 + q0 + i] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int c0 = hf * kHalf;
        // s^T = k q^T and dp^T = v dO^T: the warp's 16 keys x 32 queries
        float s[4][4], dp[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < HD / 16; ++ks) {
          uint32_t ka[4], va[4];
          a_frag<LD>(ka, sK, 16 * warp, ks, lane);
          a_frag<LD>(va, sV, 16 * warp, ks, lane);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const bf16* pq = sQ + (c0 + 8 * j + g) * LD + ks * 16 + 2 * t;
            const bf16* pg = sG + (c0 + 8 * j + g) * LD + ks * 16 + 2 * t;
            mma_16816(s[j], ka, ld32(pq), ld32(pq + 8));
            mma_16816(dp[j], va, ld32(pg), ld32(pg + 8));
          }
        }
        // p^T where visible, ds^T = p^T * (dp^T - delta) * scale
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            const int c = c0 + 8 * j + 2 * t + (e & 1);
            const int qs = sQseg[c];
            bool ok = kseg[i] >= 0 && qs == kseg[i];
            if (CAUSAL) ok = ok && q0 + c >= kpos[i];
            const float p = ok ? __expf(s[j][e] * scale - sLse[c]) : 0.f;
            s[j][e] = p;
            dp[j][e] = p * (dp[j][e] - sDelta[c]) * scale;
          }
        }
        // dv += bf16(p^T) . dO and dk += bf16(ds^T) . q over the 32 queries
#pragma unroll
        for (int kk = 0; kk < kHalf / 16; ++kk) {
          uint32_t a[4];
          c_to_a(a, s[2 * kk], s[2 * kk + 1]);
          mma_rows<HD, LD>(dv_acc, a, sG, c0 + 16 * kk, lane);
          c_to_a(a, dp[2 * kk], dp[2 * kk + 1]);
          mma_rows<HD, LD>(dk_acc, a, sQ, c0 + 16 * kk, lane);
        }
      }
    }
  }

  const long long kv_row = (long long)Hkv * HD;
  bf16* dkb = dk + ((long long)b * Sk * Hkv + hk) * HD;
  bf16* dvb = dv + ((long long)b * Sk * Hkv + hk) * HD;
  store_acc<HD>(dk_acc, [&](int r) -> bf16* {
    return k0 + r < Sk ? dkb + (long long)(k0 + r) * kv_row : nullptr;
  }, warp, lane);
  store_acc<HD>(dv_acc, [&](int r) -> bf16* {
    return k0 + r < Sk ? dvb + (long long)(k0 + r) * kv_row : nullptr;
  }, warp, lane);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <class Kernel>
static cudaError_t allow_smem(Kernel kernel, int bytes) {
  return bytes > 48 * 1024
             ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)
             : cudaSuccess;
}

template <int HD, bool CAUSAL>
static cudaError_t launch_dq(cudaStream_t stream, const bf16* q, const bf16* k, const bf16* v,
                             const bf16* g, const int* qs, const int* ks, const float* lse,
                             const float* delta, bf16* dq, int B, int Sq, int Sk, int H, int Hkv,
                             const Strides& st, float scale) {
  const int bytes = 4 * tile_bytes<HD>() + kCols * (int)sizeof(int);
  const cudaError_t e = allow_smem(flash_bwd_dq_kernel<HD, CAUSAL>, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((Sq + kRows - 1) / kRows, H, B);
  flash_bwd_dq_kernel<HD, CAUSAL><<<grid, kThreads, bytes, stream>>>(
      q, k, v, g, qs, ks, lse, delta, dq, Sq, Sk, H, Hkv, st, scale);
  return cudaGetLastError();
}

template <int HD, bool CAUSAL>
static cudaError_t launch_dkv(cudaStream_t stream, const bf16* q, const bf16* k, const bf16* v,
                              const bf16* g, const int* qs, const int* ks, const float* lse,
                              const float* delta, bf16* dk, bf16* dv, int B, int Sq, int Sk,
                              int H, int Hkv, const Strides& st, float scale) {
  const int bytes = 4 * tile_bytes<HD>() + 3 * kRows * 4;
  const cudaError_t e = allow_smem(flash_bwd_dkv_kernel<HD, CAUSAL>, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((Sk + kRows - 1) / kRows, Hkv, B);
  flash_bwd_dkv_kernel<HD, CAUSAL><<<grid, kThreads, bytes, stream>>>(
      q, k, v, g, qs, ks, lse, delta, dk, dv, Sq, Sk, H, Hkv, st, scale);
  return cudaGetLastError();
}

}  // namespace padt

// C entry points (loaded with ctypes). strides: q_sb, q_ss, q_sh, k_sb, k_ss,
// k_sh, v_sb, v_ss, v_sh, g_sb, g_ss, g_sh in elements. Each returns the
// CUDA error of the launch, or cudaErrorInvalidValue for a head dim it was
// not built for.
#define PADT_BWD_ARGS                                                                        \
  const void *q, const void *k, const void *v, const void *g, const void *q_seg,             \
      const void *k_seg, const void *lse, const void *delta
#define PADT_BWD_DIMS                                                                        \
  int B, int Sq, int Sk, int H, int Hkv, int hd, long long q_sb, long long q_ss,             \
      long long q_sh, long long k_sb, long long k_ss, long long k_sh, long long v_sb,        \
      long long v_ss, long long v_sh, long long g_sb, long long g_ss, long long g_sh,        \
      int causal, float scale, void *stream

#define PADT_BWD_CASTS                                                                       \
  const Strides st{q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, g_sb, g_ss, g_sh}; \
  cudaStream_t s = static_cast<cudaStream_t>(stream);                                        \
  auto qq = static_cast<const bf16*>(q);                                                     \
  auto kk = static_cast<const bf16*>(k);                                                     \
  auto vv = static_cast<const bf16*>(v);                                                     \
  auto gg = static_cast<const bf16*>(g);                                                     \
  auto qs = static_cast<const int*>(q_seg);                                                  \
  auto ks = static_cast<const int*>(k_seg);                                                  \
  auto ls = static_cast<const float*>(lse);                                                  \
  auto dl = static_cast<const float*>(delta)

extern "C" int padt_flash_bwd_dq(PADT_BWD_ARGS, void* dq, PADT_BWD_DIMS) {
  using namespace padt;
  if (B == 0 || Sq == 0 || H == 0) return 0;
  PADT_BWD_CASTS;
  auto o = static_cast<bf16*>(dq);
#define PADT_DQ(HD)                                                                       \
  case HD:                                                                                \
    return (int)(causal ? launch_dq<HD, true>(s, qq, kk, vv, gg, qs, ks, ls, dl, o, B, Sq, \
                                              Sk, H, Hkv, st, scale)                      \
                        : launch_dq<HD, false>(s, qq, kk, vv, gg, qs, ks, ls, dl, o, B, Sq, \
                                               Sk, H, Hkv, st, scale));
  switch (hd) {
    PADT_DQ(16)
    PADT_DQ(32)
    PADT_DQ(64)
    PADT_DQ(80)
    PADT_DQ(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef PADT_DQ
}

extern "C" int padt_flash_bwd_dkv(PADT_BWD_ARGS, void* dk, void* dv, PADT_BWD_DIMS) {
  using namespace padt;
  if (B == 0 || Sk == 0 || Hkv == 0) return 0;
  PADT_BWD_CASTS;
  auto ok = static_cast<bf16*>(dk);
  auto ov = static_cast<bf16*>(dv);
#define PADT_DKV(HD)                                                                         \
  case HD:                                                                                   \
    return (int)(causal ? launch_dkv<HD, true>(s, qq, kk, vv, gg, qs, ks, ls, dl, ok, ov, B, \
                                               Sq, Sk, H, Hkv, st, scale)                    \
                        : launch_dkv<HD, false>(s, qq, kk, vv, gg, qs, ks, ls, dl, ok, ov, B, \
                                                Sq, Sk, H, Hkv, st, scale));
  switch (hd) {
    PADT_DKV(16)
    PADT_DKV(32)
    PADT_DKV(64)
    PADT_DKV(80)
    PADT_DKV(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef PADT_DKV
}
