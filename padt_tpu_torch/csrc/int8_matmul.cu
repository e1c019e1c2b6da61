// H7 int8_matmul: bf16 activations times a per-output-channel int8 weight,
//   out[m, n] = bf16( s[n] * sum_k x[m, k] * bf16(wq[k, n]) ),
// the sum in fp32 and the scale applied once to the fp32 sum.
//
// Replaces padt_tpu/ops/quant.py::int8_matmul (:70, pallas_call :102, body
// _kernel :33). The TPU kernel's padding of N to 128 and of M to its block,
// and its VMEM budget for the K block, are Mosaic layout needs: here the M,
// N and K tails read as zeros.
//
// Layout (the JAX package's): x (M, K) bf16 with unit column stride and any
// row stride (a multiple of 8 elements), wq (K, N) int8 row-major as JAX
// stores (in, out), s (N,) fp32, out (M, N) bf16 contiguous. K % 8 == 0 and
// N % 16 == 0 (TMA's 16-byte strides); the wrapper checks both.
//
// Bound on the H100: at decode (M = 4 or 8 slots) the int8 weight stream,
// K * N bytes per call (6.53 GB per PaDT-7B decode step over 112 calls); at
// prefill (M = 2560) the tensor cores, 2 * M * N * K operations. The
// product is gemm_sm90.cuh's (wgmma on a TMA ring, swap-AB at M <= 128, the
// K splits folded across a cluster). The int8 W tile lands by TMA as it is
// (half the bytes of bf16 in flight); the producer warpgroup's three
// converter warps write it once per stage as one of two bf16 tiles, in the
// swizzled layout the wgmma descriptor reads (an integer and a float add per
// value, no conversion instruction), fence it to the async proxy and release
// it to the consumers. Converting into registers for RS-wgmma instead would put W
// in the A operand under swap-AB with its K pairs in separate rows of the
// N-contiguous tile: byte loads, bank conflicts, and the work repeated by
// each consumer warpgroup at prefill.
#include "gemm_sm90.cuh"

// C entry point (loaded with ctypes). x_row_stride in elements; swap, nt,
// splits, stages: the wrapper's launch plan (ops/cuda_matmul.py
// gemm_plan). Returns the CUDA error code of the launch (0 on success), or
// cudaErrorInvalidValue for shapes or a plan the kernel does not take.
extern "C" int padt_int8_matmul(const void* x, long long x_row_stride, const void* wq, const void* s, void* out,
                                int M, int N, int K, int swap, int nt, int splits, int stages,
                                void* stream) {
  using namespace padt::gemm;
  if (M == 0 || N == 0) return 0;
  if (K % 8 != 0 || N % 16 != 0 || x_row_stride % 8 != 0) return (int)cudaErrorInvalidValue;
  const Plan pl{swap, nt, splits, stages};
  const int tn = swap ? 64 : nt;  // the int8 W box: the CTA's columns
  Params p = {};
  int rc = encode_x(&p.x_map, x, x_row_stride, M, K, pl);
  if (rc == 0) rc = padt::hopper::encode_cached(&p.w_map, 1, wq, N, K, 1, N, (long long)K * N, tn, BK, 1, 0);
  if (rc != 0) return rc;
  p.scale = static_cast<const float*>(s);
  p.out = static_cast<bf16*>(out);
  p.M = M, p.N = N, p.K = K, p.li = 0, p.k_tiles = (K + BK - 1) / BK, p.stages = stages;
  return launch<true>(p, pl, static_cast<cudaStream_t>(stream));
}
