// H10 stream_matmul: one layer's product of the decode weight stream,
//   out = bf16(rms_norm(x, ln_w[li]) @ w[li]) + bias[li]
// with x (M, K) bf16, w the full (L, K, N) bf16 stack, ln_w (L, K) and bias
// (L, N) bf16, both optional; the sum in fp32, rounded to bf16, then the bias
// added in bf16. The norm is ops/norms.py's: the fp32 mean of x^2 over K,
// y = bf16(x * (1 / sqrt(mean + eps))), then bf16(y * ln_w).
//
// Replaces padt_tpu/ops/matmul.py::stream_matmul_stacked (:76, pallas_call
// :125, body _kernel :39). The TPU kernel's whole-K weight tiles, its choice
// of N tile and its padding of M to 8 are Mosaic layout needs: here K runs in
// stages of 64 rows, the M, N and K tails read as zeros, and layer li is a
// coordinate of the stack's TMA descriptor (no slice is copied).
//
// Layout: x (M, K) with unit column stride and any row stride (a multiple of
// 8 elements); w (L, K, N), ln_w (L, K), bias (L, N) contiguous; out (M, N)
// bf16 contiguous. K % 8 == 0 and N % 8 == 0 (TMA's 16-byte strides).
//
// Bound on the H100: at decode (M = 96 slots) the weight stream, K * N * 2
// bytes per call (5.55 GB per 36-layer PaDT-3B pass over 144 calls). The
// product is gemm_sm90.cuh's (wgmma on a TMA ring, swap-AB at M <= 128, the
// K splits folded across a cluster). The fused norm needs each row's 1 / rms
// over the whole K before its first product: a row-norm pass (norm_kernel)
// writes the normalised rows once, bf16(bf16(x * rs) * ln_w[li]), to a
// scratch (M, K), and the GEMM reads them instead of x. It is launched
// behind the pass with programmatic dependent launch: its producer puts the
// first round of W tiles in flight, then waits for the pass
// (griddepcontrol.wait) before it loads the first x tile.
#include "gemm_sm90.cuh"

namespace padt {
namespace {

using gemm::bf16;

// xn = bf16(bf16(x * rs) * ln) row by row, rs = 1 / sqrt(mean(x^2) + eps)
// in fp32: one warp per row, 16-byte loads. It lets the GEMM behind it
// start at once (launch_dependents); the GEMM waits for it to end only
// before it loads xn.
__global__ void norm_kernel(const bf16* __restrict__ x, long long x_rs, const bf16* __restrict__ ln,
                            bf16* __restrict__ xn, int M, int K, float eps) {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const bf16* xr = x + (long long)row * x_rs;
  float s = 0.f;
  for (int k = lane * 8; k < K; k += 32 * 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(xr + k);
    const bf16* v = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float f = __bfloat162float(v[e]);
      s += f * f;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const float rs = 1.f / sqrtf(s / (float)K + eps);
  for (int k = lane * 8; k < K; k += 32 * 8) {
    uint4 raw = *reinterpret_cast<const uint4*>(xr + k);
    const uint4 l = *reinterpret_cast<const uint4*>(ln + k);
    bf16* v = reinterpret_cast<bf16*>(&raw);
    const bf16* w = reinterpret_cast<const bf16*>(&l);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = __float2bfloat16(gemm::bf16_round(__bfloat162float(v[e]) * rs) * __bfloat162float(w[e]));
    *reinterpret_cast<uint4*>(xn + (long long)row * K + k) = raw;
  }
}

}  // namespace
}  // namespace padt

// C entry point (loaded with ctypes). x_row_stride in elements; w, ln and
// bias are the full (L, ...) stacks and li the layer; ln (fused norm) and
// bias may be null; xn is a bf16 (M, K) scratch for the normalised rows when
// ln is given. swap, nt, splits, stages: the wrapper's launch plan
// (ops/cuda_matmul.py gemm_plan). Returns the CUDA error code of the launches
// (0 on success), or cudaErrorInvalidValue for shapes or a plan the kernel
// does not take.
extern "C" int padt_stream_matmul(const void* x, long long x_row_stride, const void* w, const void* ln,
                                  const void* bias, void* out, void* xn, int M, int N, int K, int L, int li,
                                  float eps, int swap, int nt, int splits, int stages, void* stream) {
  using namespace padt::gemm;
  if (M == 0 || N == 0) return 0;
  if (K % 8 != 0 || N % 8 != 0 || x_row_stride % 8 != 0 || li < 0 || li >= L || (ln != nullptr && xn == nullptr))
    return (int)cudaErrorInvalidValue;
  const Plan pl{swap, nt, splits, stages};
  const bool fused = ln != nullptr;
  Params p = {};
  int rc = fused ? encode_x(&p.x_map, xn, K, M, K, pl) : encode_x(&p.x_map, x, x_row_stride, M, K, pl);
  if (rc == 0)
    rc = padt::hopper::encode_cached(&p.w_map, 2, w, N, K, L, (long long)N * 2, (long long)K * N * 2, 64, BK, 1,
                                     128);
  if (rc != 0) return rc;
  p.bias = bias != nullptr ? static_cast<const bf16*>(bias) + (long long)li * N : nullptr;
  p.out = static_cast<bf16*>(out);
  p.M = M, p.N = N, p.K = K, p.li = li, p.k_tiles = (K + BK - 1) / BK, p.stages = stages;
  p.x_after = fused;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fused) {
    padt::norm_kernel<<<(M + 7) / 8, 256, 0, st>>>(static_cast<const bf16*>(x), x_row_stride,
                                                   static_cast<const bf16*>(ln) + (long long)li * K,
                                                   static_cast<bf16*>(xn), M, K, eps);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return launch<false>(p, pl, st);
}
