// H1 rope_qk: fp32 rotate-half rotary embedding over the q heads and k heads
// of bf16 projection outputs, written back as bf16.
//
// Replaces two TPU kernels that compute the same rotation:
//   padt_tpu/ops/pallas_attention.py::_unpack_rope_kernel  (vision, hd 80:
//       also unpacked q/k/v from the fused qkv buffer and padded each head
//       to 128 lanes, a Mosaic layout need this card does not have)
//   padt_tpu/ops/pallas_attention.py::_rope_pair_kernel    (text prefill)
// out[j]        = x[j] * cos[j]        - x[j + half] * sin[j]
// out[j + half] = x[j + half] * cos[j + half] + x[j] * sin[j + half]
//
// Bound on the H100: memory. Each element of q and k is read once and
// written once, and each row's cos/sin (fp32, hd values each) is read once
// per row by one CTA and reused across all heads from L1. q and k come in as
// strided row views (base pointer + row stride), so the vision path reads
// them straight out of the fused (B, S, 3*H*hd) qkv buffer and v is never
// copied. Scalar bf16 loads: the simple form first; vectorized loads are
// later work.
//
// One CTA per (batch, seq) row; each thread rotates (j, j + half) pairs.
//
// sin_sign -1 rotates by the negated angle: with tables whose two halves
// repeat (every rope table of this model), that is the transpose of the
// rotation, so the same kernel is the VJP of `rope_pair_packed`
// (padt_tpu/ops/pallas_attention.py:669-676 runs `_rope_pair_kernel` with
// -sin).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace padt {

typedef __nv_bfloat16 bf16;

__global__ void rope_qk_kernel(const bf16* __restrict__ q, long long q_rs,
                               const bf16* __restrict__ k, long long k_rs,
                               const float* __restrict__ cos, const float* __restrict__ sin,
                               bf16* __restrict__ q_out, bf16* __restrict__ k_out, int hq,
                               int hk, int hd, float sin_sign) {
  const long long row = blockIdx.x;
  const int half = hd / 2;
  const float* c = cos + row * hd;
  const float* s = sin + row * hd;
  const int n_pairs = (hq + hk) * half;
  for (int i = threadIdx.x; i < n_pairs; i += blockDim.x) {
    const int head = i / half, j = i % half;
    const bf16* x;
    bf16* o;
    if (head < hq) {
      x = q + row * q_rs + (long long)head * hd;
      o = q_out + (row * hq + head) * hd;
    } else {
      x = k + row * k_rs + (long long)(head - hq) * hd;
      o = k_out + (row * hk + head - hq) * hd;
    }
    const float x1 = __bfloat162float(x[j]);
    const float x2 = __bfloat162float(x[j + half]);
    o[j] = __float2bfloat16(x1 * c[j] - x2 * (sin_sign * s[j]));
    o[j + half] = __float2bfloat16(x2 * c[j + half] + x1 * (sin_sign * s[j + half]));
  }
}

}  // namespace padt

// C entry point (loaded with ctypes). rows = B * S; q row r starts at
// q + r * q_row_stride (elements), likewise k (k may be null when hk == 0);
// cos/sin are (rows, hd) fp32; q_out (rows, hq*hd) and k_out (rows, hk*hd)
// are contiguous; sin_sign is 1 (rope) or -1 (its VJP). Returns
// cudaGetLastError() after the launch.
extern "C" int padt_rope_qk(const void* q, long long q_row_stride, const void* k,
                            long long k_row_stride, const void* cos, const void* sin,
                            void* q_out, void* k_out, int rows, int hq, int hk, int hd,
                            float sin_sign, void* stream) {
  using namespace padt;
  if (rows == 0) return 0;
  rope_qk_kernel<<<rows, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), q_row_stride, static_cast<const bf16*>(k), k_row_stride,
      static_cast<const float*>(cos), static_cast<const float*>(sin),
      static_cast<bf16*>(q_out), static_cast<bf16*>(k_out), hq, hk, hd, sin_sign);
  return (int)cudaGetLastError();
}
