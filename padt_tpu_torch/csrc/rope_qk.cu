// H1 rope_qk: fp32 rotate-half rotary embedding over the q heads and k heads
// of bf16 projection outputs, written back as bf16.
//
// Replaces three TPU kernels that compute the same rotation:
//   padt_tpu/ops/pallas_attention.py::_unpack_rope_kernel  :700 (vision, hd 80:
//       also unpacked q/k/v from the fused qkv buffer and padded each head
//       to 128 lanes, a Mosaic layout need this card does not have)
//   padt_tpu/ops/pallas_attention.py::_rope_pair_kernel    :574 (text)
//   and its VJP, _rope_pair_pk_bwd :669 (the same kernel with -sin)
// out[j]        = x[j] * cos[j]        - x[j + half] * sin[j]
// out[j + half] = x[j + half] * cos[j + half] + x[j] * sin[j + half]
// in fp32, rounded once to bf16 at the store.
//
// Bound on the H100: memory. Each element of q and k is read once and
// written once, and each row's cos/sin (fp32, hd values each) is read once
// from HBM. q and k come in as strided row views (base pointer + row
// stride), so the vision path reads them straight out of the fused
// (B, S, 3*H*hd) qkv buffer and v is never copied. The design:
//   - 16-byte lanes: a thread owns 8 consecutive pairs (j .. j + 7) of a
//     head, one uint4 of bf16 from each half of the head, and writes two
//     uint4. Rows and row strides are 16-byte aligned and hd % 16 == 0 (the
//     wrapper requires both), so every access is one vector;
//   - table reuse: the thread keeps its 8 + 8 cos and sin values in
//     registers and applies them to HPT heads of its row (heads g, g + G,
//     g + 2G, ... for its head group g of G), so the tables are read once per
//     thread, not once per pair; no division or modulo in the loop;
//   - all of a thread's loads are issued before its first store (the HPT
//     loop is unrolled into registers), so a call costs one memory round
//     trip per thread;
//   - the launch plan (heads per thread, groups, block) is chosen in
//     Python (ops/cuda_attention.py::rope_plan): at decode one head per
//     thread and small blocks, so the loads of a few rows issue at once
//     over >= 32 SMs; at large row counts two heads per thread and blocks
//     of 128;
//   - programmatic dependent launch: the launch overlaps the previous
//     kernel's tail and the kernel waits for it before its loads (at
//     decode, where a call is one round trip and its launch, that halves
//     the time between back-to-back calls). Thread t of the grid takes row
//     t / (V * G), vector (t % (V * G)) % V and group (t % (V * G)) / V,
//     V = hd / 16 vectors per half; consecutive threads read consecutive
//     16-byte vectors of a row.
//
// sin_sign -1 rotates by the negated angle: with tables whose two halves
// repeat (every rope table of this model), that is the transpose of the
// rotation, so the same kernel is the VJP of `rope_pair_packed`.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace padt {
namespace rope {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float lo_bf16(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void unpack8(const uint4& v, float (&x)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = lo_bf16(w[i]);
    x[2 * i + 1] = hi_bf16(w[i]);
  }
}

__device__ __forceinline__ void load8f(const float* p, float (&x)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w, x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}

template <int HPT>
__global__ void __launch_bounds__(256)
    rope_qk_kernel(const bf16* __restrict__ q, long long q_rs, const bf16* __restrict__ k, long long k_rs,
                   const float* __restrict__ cos, const float* __restrict__ sin, bf16* __restrict__ q_out,
                   bf16* __restrict__ k_out, long long n_threads, int hq, int hk, int nv, int groups,
                   float sin_sign) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // under programmatic dependent launch: the grid before this one (which
  // writes q and k) has completed and its writes are visible; otherwise a
  // no-op
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (t >= n_threads) return;
  const int per_row = nv * groups;
  const long long row = t / per_row;
  const int u = (int)(t - row * per_row);
  const int g = u / nv, v = u - g * nv;
  const int half = 8 * nv, hd = 2 * half, nh = hq + hk;

  // this thread's heads: every load in flight before the first store
  uint4 x1[HPT], x2[HPT];
#pragma unroll
  for (int i = 0; i < HPT; ++i) {
    const int h = g + i * groups;
    if (h < nh) {
      const bf16* x = h < hq ? q + row * q_rs + (long long)h * hd : k + row * k_rs + (long long)(h - hq) * hd;
      x1[i] = __ldg(reinterpret_cast<const uint4*>(x + 8 * v));
      x2[i] = __ldg(reinterpret_cast<const uint4*>(x + half + 8 * v));
    }
  }
  float c1[8], c2[8], s1[8], s2[8];
  const float* cr = cos + row * hd + 8 * v;
  const float* sr = sin + row * hd + 8 * v;
  load8f(cr, c1);
  load8f(cr + half, c2);
  load8f(sr, s1);
  load8f(sr + half, s2);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    s1[e] *= sin_sign;
    s2[e] *= sin_sign;
  }

#pragma unroll
  for (int i = 0; i < HPT; ++i) {
    const int h = g + i * groups;
    if (h < nh) {
      float a[8], b[8];
      unpack8(x1[i], a);
      unpack8(x2[i], b);
      uint32_t o1[4], o2[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o1[e] = pack_bf16x2(a[2 * e] * c1[2 * e] - b[2 * e] * s1[2 * e],
                            a[2 * e + 1] * c1[2 * e + 1] - b[2 * e + 1] * s1[2 * e + 1]);
        o2[e] = pack_bf16x2(b[2 * e] * c2[2 * e] + a[2 * e] * s2[2 * e],
                            b[2 * e + 1] * c2[2 * e + 1] + a[2 * e + 1] * s2[2 * e + 1]);
      }
      bf16* o = h < hq ? q_out + (row * hq + h) * hd : k_out + (row * hk + h - hq) * hd;
      *reinterpret_cast<uint4*>(o + 8 * v) = make_uint4(o1[0], o1[1], o1[2], o1[3]);
      *reinterpret_cast<uint4*>(o + half + 8 * v) = make_uint4(o2[0], o2[1], o2[2], o2[3]);
    }
  }
}

}  // namespace rope
}  // namespace padt

// C entry point (loaded with ctypes). rows = B * S; q row r starts at
// q + r * q_row_stride (elements), likewise k (k may be null when hk == 0);
// cos/sin are (rows, hd) fp32; q_out (rows, hq*hd) and k_out (rows, hk*hd)
// are contiguous; sin_sign is 1 (rope) or -1 (its VJP). The launch plan:
// hpt heads per thread (1 or 2), `groups` threads per (row, vector) with
// hpt * groups >= hq + hk, `block` threads per CTA (<= 256), and pdl 1 to
// launch under programmatic dependent launch (0: a plain launch, for the
// launch-plan sweep's comparison). Every
// pointer and row stride must be 16-byte aligned and hd a multiple of 16.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a plan or shape the kernel does not take.
extern "C" int padt_rope_qk(const void* q, long long q_row_stride, const void* k, long long k_row_stride,
                            const void* cos, const void* sin, void* q_out, void* k_out, int rows, int hq, int hk,
                            int hd, int hpt, int groups, int block, int pdl, float sin_sign, void* stream) {
  using namespace padt::rope;
  if (rows == 0) return 0;
  if (hd % 16 != 0 || hd <= 0 || block <= 0 || block > 256 || groups <= 0 || (long long)hpt * groups < hq + hk)
    return (int)cudaErrorInvalidValue;
  const int nv = hd / 16;
  const long long n_threads = (long long)rows * nv * groups;
  const long long grid = (n_threads + block - 1) / block;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(block);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  auto qq = static_cast<const bf16*>(q);
  auto kk = static_cast<const bf16*>(k);
  auto cc = static_cast<const float*>(cos);
  auto ss = static_cast<const float*>(sin);
  auto qo = static_cast<bf16*>(q_out);
  auto ko = static_cast<bf16*>(k_out);
#define PADT_ROPE(HPT_)                                                                                     \
  e = cudaLaunchKernelEx(&cfg, rope_qk_kernel<HPT_>, qq, q_row_stride, kk, k_row_stride, cc, ss, qo, ko, n_threads, \
                         hq, hk, nv, groups, sin_sign)
  cudaError_t e = cudaSuccess;
  switch (hpt) {
    case 1: PADT_ROPE(1); break;
    case 2: PADT_ROPE(2); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef PADT_ROPE
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
