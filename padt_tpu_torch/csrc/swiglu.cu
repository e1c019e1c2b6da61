// H12 swiglu: the SwiGLU activation of the vision tower's packed MLP,
//   out[r, j] = bf16( silu(g) * u ),  g = gu[r, j],  u = gu[r, ff + j],  silu(g) = g / (1 + exp(-g)),
// in fp32, rounded once to bf16 at the store.
//
// Replaces no TPU kernel. The JAX package writes `jax.nn.silu(gate) * up`
// (padt_tpu/models/vision.py :141-143), which XLA fuses into one elementwise
// pass on the TPU; eager PyTorch runs it as a SiLU pass and a multiply pass
// over two separate (rows, ff) tensors. Here gate and up are the two halves
// of one GEMM's output row, [gate | up] (models/padt.py::pack_vision_blocks
// pads each half to a width ff that is a multiple of 8), and one pass reads
// each row once and writes the product once.
//
// Bound on the H100: memory. rows * 2ff bf16 read and rows * ff written,
// 191 MB at the tower's 4 x 2304 rows and ff 3456 (57 us at 3.35 TB/s); the
// SiLU is a handful of fp32 operations a value. The design: a thread owns
// one 16-byte vector of output (8 values), loads the matching 16-byte
// vectors of gate and up (ff % 8 == 0 and 16-byte aligned rows, which the
// wrapper requires), and stores one; consecutive threads take consecutive
// vectors of a row, so every warp reads and writes whole 512-byte runs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace padt {
namespace swiglu {

__device__ __forceinline__ float lo_bf16(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// silu(g) * u as PyTorch's fp32 SiLU computes it: g / (1 + exp(-g)), then the product
__device__ __forceinline__ float swiglu1(float g, float u) { return g / (1.0f + expf(-g)) * u; }

__global__ void __launch_bounds__(256)
    swiglu_kernel(const uint4* __restrict__ gu, uint4* __restrict__ out, long long n_vec, int nv) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_vec) return;
  const long long row = t / nv;
  const int v = (int)(t - row * nv);
  const uint4 g = __ldg(gu + row * 2 * nv + v);
  const uint4 u = __ldg(gu + row * 2 * nv + nv + v);
  const uint32_t gw[4] = {g.x, g.y, g.z, g.w}, uw[4] = {u.x, u.y, u.z, u.w};
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    o[i] = pack_bf16x2(swiglu1(lo_bf16(gw[i]), lo_bf16(uw[i])), swiglu1(hi_bf16(gw[i]), hi_bf16(uw[i])));
  out[t] = make_uint4(o[0], o[1], o[2], o[3]);
}

}  // namespace swiglu
}  // namespace padt

// C entry point (loaded with ctypes). gu (rows, 2 * ff) and out (rows, ff),
// both bf16, contiguous and 16-byte aligned; ff a multiple of 8. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a shape
// the kernel does not take.
extern "C" int padt_swiglu(const void* gu, void* out, long long rows, int ff, void* stream) {
  using namespace padt::swiglu;
  if (rows == 0) return 0;
  if (rows < 0 || ff <= 0 || ff % 8 != 0) return (int)cudaErrorInvalidValue;
  const int nv = ff / 8;
  const long long n_vec = rows * nv;
  const int block = 256;
  const long long grid = (n_vec + block - 1) / block;
  if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  swiglu_kernel<<<(unsigned)grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(gu), static_cast<uint4*>(out), n_vec, nv);
  return (int)cudaGetLastError();
}
