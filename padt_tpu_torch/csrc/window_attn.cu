// H3 window_slot_attn: exact softmax attention inside each 64-token window
// slot of the vision tower's slot layout (padt_tpu/models/vision_geom.py,
// window_slots): every window sits alone in its own 64-token slot, so a
// query sees only the keys of its slot, and only those with seg >= 0.
//
// Replaces padt_tpu/ops/pallas_attention.py::_vis_win_kernel (the 28
// windowed vision layers). There the TPU paired two windows into one
// 128x128 tile to fill its matrix unit; here one CTA takes one
// (batch, head, slot): Q, K and V (64 x HD each) go to shared memory, the
// 64x64 f32 score tile stays in registers, softmax is exact (one tile),
// rows with no valid key return 0, then P.V.
//
// Bound on the H100: memory and launch overhead more than compute. Per
// layer at B=2, S=2304, 16 heads of 80: 2 * 2 * 64 * 80 * S * 16 * B = 1.5
// GFLOP against ~28 MB of q/k/v/out traffic. The design reads each q/k/v
// element once (q/k from the rope kernel's output, v straight out of the
// fused qkv buffer through its strides) and writes each output once.
//
// Layout: q/k/v (B, S, H, HD) with unit last stride and strides that are
// multiples of 8 elements; seg (B, S) int32; out contiguous (B, S, H, HD).
// S is a multiple of 64.
#include "attn_mma.cuh"

namespace padt {

template <int HD>
__global__ void __launch_bounds__(kThreads)
window_slot_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const int* __restrict__ seg,
                   bf16* __restrict__ out, int S, int H, long long q_sb, long long q_ss,
                   long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                   long long v_sb, long long v_ss, long long v_sh, float scale) {
  constexpr int LD = Pitch<HD>::value;
  __shared__ __align__(16) bf16 sK[kRows * LD];  // stages Q, then holds K
  __shared__ __align__(16) bf16 sVt[HD * kLdT];
  __shared__ int sValid[kCols];

  const int s0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  load_tile<HD>(sK, q + b * q_sb + h * q_sh, q_ss, s0, S);
  __syncthreads();
  uint32_t qf[HD / 16][4];
  load_q_frags<HD>(qf, sK, warp, lane);
  __syncthreads();

  load_tile<HD>(sK, k + b * k_sb + h * k_sh, k_ss, s0, S);
  load_tile_t<HD>(sVt, v + b * v_sb + h * v_sh, v_ss, s0, S);
  for (int i = threadIdx.x; i < kCols; i += kThreads)
    sValid[i] = seg[(long long)b * S + s0 + i] >= 0;
  __syncthreads();

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  auto valid = [&](int, int c) { return sValid[c] != 0; };
  attend_tile<HD>(qf, sK, sVt, scale, valid, m, l, acc, warp, lane);

  bf16* ob = out + (((long long)b * S + s0) * H + h) * HD;
  auto row_ptr = [&](int r) -> bf16* { return ob + (long long)r * H * HD; };
  store_rows<HD>(acc, l, row_ptr, warp, lane);
}

}  // namespace padt

// C entry point (loaded with ctypes); strides in elements. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a head
// dim it was not built for or an S that is not a multiple of 64.
extern "C" int padt_window_slot_attn(const void* q, const void* k, const void* v,
                                     const void* seg, void* out, int B, int S, int H, int hd,
                                     long long q_sb, long long q_ss, long long q_sh,
                                     long long k_sb, long long k_ss, long long k_sh,
                                     long long v_sb, long long v_ss, long long v_sh,
                                     float scale, void* stream) {
  using namespace padt;
  if (S % kRows != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(S / kRows, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto qq = static_cast<const bf16*>(q);
  auto kk = static_cast<const bf16*>(k);
  auto vv = static_cast<const bf16*>(v);
  auto sg = static_cast<const int*>(seg);
  auto oo = static_cast<bf16*>(out);
#define PADT_WIN(HD_)                                                                     \
  window_slot_kernel<HD_><<<grid, kThreads, 0, st>>>(qq, kk, vv, sg, oo, S, H, q_sb, q_ss, \
                                                     q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,  \
                                                     v_sh, scale)
  switch (hd) {
    case 16: PADT_WIN(16); break;
    case 32: PADT_WIN(32); break;
    case 64: PADT_WIN(64); break;
    case 80: PADT_WIN(80); break;
    case 128: PADT_WIN(128); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef PADT_WIN
  return (int)cudaGetLastError();
}
