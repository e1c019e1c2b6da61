// H2 segment_flash_fwd: segment-id flash attention forward, causal or not,
// with a GQA head map.
//
// Replaces two TPU kernels that compute the same thing:
//   padt_tpu/ops/pallas_attention.py::_fwd_kernel      (causal GQA text prefill)
//   padt_tpu/ops/pallas_attention.py::_vis_fwd_kernel  (the 4 full-attention
//                                                       vision layers)
// Key c is visible to query r iff q_seg[r] == k_seg[c] && k_seg[c] >= 0, and
// r >= c when causal. Query head h reads kv head h / (H / Hkv). f32 online
// softmax; a row with no visible key returns 0 (the TPU kernels' l > 0
// guard). With a non-null `lse` it also writes each row's f32 log-sum-exp
// m + log(l) into lse (B, H, Sq), and +1e30 for a row with no visible key,
// so that exp(s - lse) is exactly 0 there in the backward (H8/H9,
// flash_bwd.cu): `_fwd_kernel`'s return_lse output, without its Mosaic
// (B*H, 1, S) layout.
//
// Bound on the H100: compute. Vision full layers at B=2, S=2304, 16 heads of
// 80 are ~2 * 2 * S^2 * 80 * 16 * B = 54 GFLOP per layer against ~35 MB of
// q/k/v; text prefill at L=640, hd 128 is causal and smaller. The design:
// bf16 mma.sync tiles with fp32 accumulation (tensor cores, not CUDA-core
// FMAs), a 64x64 score tile per CTA step that never leaves registers, and
// causal CTAs stop at the diagonal tile. It does not yet pipeline the K/V
// loads (no cp.async/TMA) or use wgmma; that is later work.
//
// Layout: q (B, Sq, H, HD), k/v (B, Sk, Hkv, HD) with unit last stride and
// any other strides (multiples of 8 elements), so v can be a view of the
// fused vision qkv buffer; out is contiguous (B, Sq, H, HD).
#include "attn_mma.cuh"

namespace padt {

template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
segment_flash_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const int* __restrict__ q_seg,
                     const int* __restrict__ k_seg, bf16* __restrict__ out,
                     float* __restrict__ lse, int Sq, int Sk, int H, int Hkv,
                     long long q_sb, long long q_ss, long long q_sh, long long k_sb,
                     long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                     long long v_sh, float scale) {
  constexpr int LD = Pitch<HD>::value;
  __shared__ __align__(16) bf16 sK[kRows * LD];  // also stages the Q tile
  __shared__ __align__(16) bf16 sVt[HD * kLdT];
  __shared__ int sSeg[kCols];

  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2;

  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + hk * k_sh;
  const bf16* vb = v + b * v_sb + hk * v_sh;
  const int* qsb = q_seg + (long long)b * Sq;
  const int* ksb = k_seg + (long long)b * Sk;

  load_tile<HD>(sK, qb, q_ss, q0, Sq);
  __syncthreads();
  uint32_t qf[HD / 16][4];
  load_q_frags<HD>(qf, sK, warp, lane);
  __syncthreads();

  // this thread's two query rows; rows past Sq see no key and are not stored
  int qseg[2], qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qpos[i] = q0 + 16 * warp + g + 8 * i;
    qseg[i] = qpos[i] < Sq ? qsb[qpos[i]] : -1;
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  int n_tiles = (Sk + kCols - 1) / kCols;
  if (CAUSAL) n_tiles = min(n_tiles, q0 / kCols + 1);  // kRows == kCols
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kCols;
    load_tile<HD>(sK, kb, k_ss, k0, Sk);
    load_tile_t<HD>(sVt, vb, v_ss, k0, Sk);
    for (int i = threadIdx.x; i < kCols; i += kThreads)
      sSeg[i] = k0 + i < Sk ? ksb[k0 + i] : -1;
    __syncthreads();
    auto valid = [&](int r, int c) {
      const int i = (r - 16 * warp - g) >> 3;  // 0 for row g, 1 for row g + 8
      const int ks = sSeg[c];
      bool ok = ks >= 0 && ks == qseg[i];
      if (CAUSAL) ok = ok && qpos[i] >= k0 + c;
      return ok;
    };
    attend_tile<HD>(qf, sK, sVt, scale, valid, m, l, acc, warp, lane);
    __syncthreads();
  }

  if (lse != nullptr) {
    float* lb = lse + ((long long)b * H + h) * Sq;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float x = l[i];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      if ((lane & 3) == 0 && qpos[i] < Sq) lb[qpos[i]] = x > 0.f ? m[i] + logf(x) : kBigLse;
    }
  }

  bf16* ob = out + ((long long)b * Sq * H + h) * HD;
  auto row_ptr = [&](int r) -> bf16* {
    const int qi = q0 + r;
    return qi < Sq ? ob + (long long)qi * H * HD : nullptr;
  };
  store_rows<HD>(acc, l, row_ptr, warp, lane);
}

template <int HD>
static void launch(bool causal, dim3 grid, cudaStream_t st, const bf16* q, const bf16* k,
                   const bf16* v, const int* qs, const int* ks, bf16* o, float* lse, int Sq,
                   int Sk, int H, int Hkv, const long long* st9, float scale) {
  if (causal)
    segment_flash_kernel<HD, true><<<grid, kThreads, 0, st>>>(
        q, k, v, qs, ks, o, lse, Sq, Sk, H, Hkv, st9[0], st9[1], st9[2], st9[3], st9[4], st9[5],
        st9[6], st9[7], st9[8], scale);
  else
    segment_flash_kernel<HD, false><<<grid, kThreads, 0, st>>>(
        q, k, v, qs, ks, o, lse, Sq, Sk, H, Hkv, st9[0], st9[1], st9[2], st9[3], st9[4], st9[5],
        st9[6], st9[7], st9[8], scale);
}

}  // namespace padt

// C entry point (loaded with ctypes). strides: q_sb, q_ss, q_sh, k_sb, k_ss,
// k_sh, v_sb, v_ss, v_sh in elements; lse (B, H, Sq) fp32 or null. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a head
// dim it was not built for.
extern "C" int padt_segment_flash_fwd(const void* q, const void* k, const void* v,
                                      const void* q_seg, const void* k_seg, void* out,
                                      void* lse, int B, int Sq, int Sk, int H, int Hkv, int hd,
                                      long long q_sb, long long q_ss, long long q_sh,
                                      long long k_sb, long long k_ss, long long k_sh,
                                      long long v_sb, long long v_ss, long long v_sh,
                                      int causal, float scale, void* stream) {
  using namespace padt;
  const long long st9[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  const dim3 grid((Sq + kRows - 1) / kRows, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto qq = static_cast<const bf16*>(q);
  auto kk = static_cast<const bf16*>(k);
  auto vv = static_cast<const bf16*>(v);
  auto qs = static_cast<const int*>(q_seg);
  auto ks = static_cast<const int*>(k_seg);
  auto oo = static_cast<bf16*>(out);
  auto ls = static_cast<float*>(lse);
  switch (hd) {
    case 16: launch<16>(causal, grid, st, qq, kk, vv, qs, ks, oo, ls, Sq, Sk, H, Hkv, st9, scale); break;
    case 32: launch<32>(causal, grid, st, qq, kk, vv, qs, ks, oo, ls, Sq, Sk, H, Hkv, st9, scale); break;
    case 64: launch<64>(causal, grid, st, qq, kk, vv, qs, ks, oo, ls, Sq, Sk, H, Hkv, st9, scale); break;
    case 80: launch<80>(causal, grid, st, qq, kk, vv, qs, ks, oo, ls, Sq, Sk, H, Hkv, st9, scale); break;
    case 128: launch<128>(causal, grid, st, qq, kk, vv, qs, ks, oo, ls, Sq, Sk, H, Hkv, st9, scale); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* padt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
