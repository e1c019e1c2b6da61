// H7 int8_matmul: bf16 activations times a per-output-channel int8 weight,
//   out[m, n] = bf16( s[n] * sum_k x[m, k] * bf16(wq[k, n]) ),
// the sum in fp32 and the scale applied once to the fp32 sum.
//
// Replaces padt_tpu/ops/quant.py::int8_matmul (:70, pallas_call :102, body
// _kernel :33). The TPU kernel's padding of N to 128 and of M to its block,
// and its VMEM budget for the K block, are Mosaic layout needs: here the M,
// N and K tails are predicated inside the tiles.
//
// Layout (the JAX package's): x (M, K) bf16 with unit column stride and any
// row stride (a multiple of 8 elements), wq (K, N) int8 row-major as JAX
// stores (in, out), s (N,) fp32, out (M, N) bf16 contiguous. K % 8 == 0 and
// N % 16 == 0 (16-byte loads); the wrapper checks both.
//
// Bound on the H100: at decode (M = 8 slots) the int8 weight stream, K * N
// bytes per call (6.53 GB per PaDT-7B decode step over 112 calls); at
// prefill (M = 2560) the tensor cores, 2 * M * N * K operations. The design:
// a 64 x 128 output tile per CTA of 8 warps, K in steps of 64; each step
// stages the x tile (bf16) and the int8 W tile, converted to bf16 on the
// way into shared memory (exact: |q| <= 127), and runs mma.sync m16n8k16
// bf16 -> fp32 (a 32 x 32 warp tile). W stays N-contiguous in shared memory
// and ldmatrix.trans builds the k-pair B fragments from it. The next step's
// tiles are loaded into registers while the current one computes. When the
// output tiles are too few to fill the card (decode), K is split over
// grid.z: each split writes its fp32 partial sums, and a second pass adds
// them, scales and rounds. Not yet: wgmma, TMA, a deeper load pipeline.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace padt {
namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBM = 64;        // output rows per CTA
constexpr int kBN = 128;       // output columns per CTA
constexpr int kBK = 64;        // K per step
constexpr int kThreads = 256;  // 8 warps: 2 (rows) x 4 (columns) of 32 x 32
constexpr int kLdX = kBK + 8;  // smem pitches (bf16): +16 bytes spreads rows over the banks
constexpr int kLdW = kBN + 8;
constexpr int kXChunks = kBM * kBK / 8 / kThreads;   // 16-byte x loads per thread (2)
constexpr int kWChunks = kBK * kBN / 16 / kThreads;  // 16-byte wq loads per thread (2)

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices, transposed: lane l gives the address of row l % 8
// of matrix l / 8; register i holds matrix i's (row 2t..2t+1, column g)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// The step's global tiles, held in registers between the load and the store
// to shared memory. Chunks outside [0, M) x [0, K) (x) or [0, K) x [0, N)
// (wq) are zero.
struct Stage {
  uint4 x[kXChunks];
  uint4 w[kWChunks];
};

__device__ __forceinline__ void load_stage(Stage& st, const bf16* __restrict__ x, long long x_rs,
                                           const int8_t* __restrict__ wq, int M, int N, int K,
                                           int m0, int n0, int k0) {
#pragma unroll
  for (int j = 0; j < kXChunks; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
    st.x[j] = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + r < M && k0 + c < K)
      st.x[j] = *reinterpret_cast<const uint4*>(x + (long long)(m0 + r) * x_rs + k0 + c);
  }
#pragma unroll
  for (int j = 0; j < kWChunks; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / (kBN / 16), c = (i % (kBN / 16)) * 16;
    st.w[j] = make_uint4(0u, 0u, 0u, 0u);
    if (k0 + r < K && n0 + c < N)
      st.w[j] = *reinterpret_cast<const uint4*>(wq + (long long)(k0 + r) * N + n0 + c);
  }
}

__device__ __forceinline__ void store_stage(const Stage& st, bf16* sX, bf16* sW) {
#pragma unroll
  for (int j = 0; j < kXChunks; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
    *reinterpret_cast<uint4*>(sX + r * kLdX + c) = st.x[j];
  }
#pragma unroll
  for (int j = 0; j < kWChunks; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / (kBN / 16), c = (i % (kBN / 16)) * 16;
    const int8_t* q = reinterpret_cast<const int8_t*>(&st.w[j]);
    uint4 lo, hi;
    lo.x = pack_bf16((float)q[0], (float)q[1]);
    lo.y = pack_bf16((float)q[2], (float)q[3]);
    lo.z = pack_bf16((float)q[4], (float)q[5]);
    lo.w = pack_bf16((float)q[6], (float)q[7]);
    hi.x = pack_bf16((float)q[8], (float)q[9]);
    hi.y = pack_bf16((float)q[10], (float)q[11]);
    hi.z = pack_bf16((float)q[12], (float)q[13]);
    hi.w = pack_bf16((float)q[14], (float)q[15]);
    *reinterpret_cast<uint4*>(sW + r * kLdW + c) = lo;
    *reinterpret_cast<uint4*>(sW + r * kLdW + c + 8) = hi;
  }
}

// Grid (N tiles, M tiles, splits). Split z sums K rows [z * k_per, (z + 1) *
// k_per). With one split the epilogue scales and writes bf16 out; with more,
// it writes the fp32 partial sums to ws (splits, M, N) for reduce_kernel.
__global__ void __launch_bounds__(kThreads, 2)
    int8_matmul_kernel(const bf16* __restrict__ x, long long x_rs, const int8_t* __restrict__ wq,
                       const float* __restrict__ s, bf16* __restrict__ out,
                       float* __restrict__ ws, int M, int N, int K, int k_per) {
  __shared__ __align__(16) bf16 sX[kBM * kLdX];
  __shared__ __align__(16) bf16 sW[kBK * kLdW];

  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int kb = blockIdx.z * k_per;
  const int ke = min(K, kb + k_per);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 32;  // this warp's 32 x 32 tile

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  // tiles past ke are masked as past K: the split's last step may be partial
  Stage st;
  if (kb < ke) load_stage(st, x, x_rs, wq, M, N, ke, m0, n0, kb);
  for (int k0 = kb; k0 < ke; k0 += kBK) {
    __syncthreads();  // the previous step's fragments are read
    store_stage(st, sX, sW);
    __syncthreads();
    if (k0 + kBK < ke) load_stage(st, x, x_rs, wq, M, N, ke, m0, n0, k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const bf16* p = sX + (wm + 16 * i + g) * kLdX + kk + 2 * t;
        a[i][0] = ld32(p);
        a[i][1] = ld32(p + 8 * kLdX);
        a[i][2] = ld32(p + 8);
        a[i][3] = ld32(p + 8 * kLdX + 8);
      }
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {  // two n8 tiles per ldmatrix
        const int mi = lane >> 3;
        const bf16* p = sW + (kk + (mi & 1) * 8 + (lane & 7)) * kLdW + wn + 16 * jp + (mi >> 1) * 8;
        uint32_t b[4];
        ldmatrix_x4_trans(b, p);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_16816(acc[i][2 * jp], a[i], b[0], b[1]);
          mma_16816(acc[i][2 * jp + 1], a[i], b[2], b[3]);
        }
      }
    }
  }

  // epilogue: c0,c1 at (row g, columns 2t, 2t+1), c2,c3 at row g + 8
  const bool split = gridDim.z > 1;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + wn + 8 * j + 2 * t;
    if (n >= N) continue;  // N % 16 == 0: n < N implies n + 1 < N
    const float s0 = split ? 1.f : s[n], s1 = split ? 1.f : s[n + 1];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + 16 * i + g + 8 * h;
        if (m >= M) continue;
        const float v0 = acc[i][j][2 * h] * s0, v1 = acc[i][j][2 * h + 1] * s1;
        if (split) {
          *reinterpret_cast<float2*>(ws + ((long long)blockIdx.z * M + m) * N + n) = make_float2(v0, v1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(out + (long long)m * N + n) = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

// out[m, n] = bf16(s[n] * sum_z ws[z, m, n]), two columns per thread
__global__ void reduce_kernel(const float* __restrict__ ws, const float* __restrict__ s,
                              bf16* __restrict__ out, int M, int N, int splits) {
  const long long pairs = (long long)M * N / 2;
  const long long mn = (long long)M * N;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < pairs;
       i += (long long)gridDim.x * blockDim.x) {
    const long long e = 2 * i;
    const int n = (int)(e % N);
    float2 a = make_float2(0.f, 0.f);
    for (int z = 0; z < splits; ++z) {
      const float2 p = *reinterpret_cast<const float2*>(ws + z * mn + e);
      a.x += p.x;
      a.y += p.y;
    }
    *reinterpret_cast<__nv_bfloat162*>(out + e) = __floats2bfloat162_rn(a.x * s[n], a.y * s[n + 1]);
  }
}

}  // namespace
}  // namespace padt

// C entry point (loaded with ctypes). x_row_stride in elements; ws is an fp32
// (splits, M, N) scratch buffer when splits > 1 (may be null otherwise).
// Returns the CUDA error code of the launches (0 on success), or
// cudaErrorInvalidValue for shapes the kernel does not take.
extern "C" int padt_int8_matmul(const void* x, long long x_row_stride, const void* wq,
                                const void* s, void* out, void* ws, int M, int N, int K,
                                int splits, void* stream) {
  using namespace padt;
  if (M == 0 || N == 0) return 0;
  if (K % 8 != 0 || N % 16 != 0 || x_row_stride % 8 != 0 || splits < 1 ||
      (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const int k_tiles = (K + kBK - 1) / kBK;
  const int k_per = (k_tiles + splits - 1) / splits * kBK;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  int8_matmul_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const bf16*>(x), x_row_stride, static_cast<const int8_t*>(wq),
      static_cast<const float*>(s), static_cast<bf16*>(out), static_cast<float*>(ws), M, N, K,
      k_per);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const long long pairs = (long long)M * N / 2;
  const long long need = (pairs + 255) / 256;
  const int blocks = (int)(need < 132 * 8 ? need : 132 * 8);  // grid-stride beyond 8 blocks per SM
  reduce_kernel<<<blocks, 256, 0, st>>>(static_cast<const float*>(ws),
                                        static_cast<const float*>(s), static_cast<bf16*>(out), M,
                                        N, splits);
  return (int)cudaGetLastError();
}
