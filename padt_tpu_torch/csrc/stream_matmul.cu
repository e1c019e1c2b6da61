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
// steps, the M, N and K tails are predicated inside the tiles, and layer li
// is reached by a pointer offset into the stacks (no slice is copied).
//
// Layout: x (M, K) with unit column stride and any row stride (a multiple of
// 8 elements); w (L, K, N), ln_w (L, K), bias (L, N) contiguous; out (M, N)
// bf16 contiguous. K % 8 == 0 and N % 8 == 0 (16-byte loads).
//
// Bound on the H100: at decode (M = 96 slots) the weight stream, K * N * 2
// bytes per call (5.55 GB per 36-layer PaDT-3B pass over 144 calls). The
// design, from H7's skeleton (csrc/int8_matmul.cu) without its int8
// conversion: a 128 x 128 output tile per CTA of 8 warps (4 x 2 warps of
// 32 x 64), so every decode row of M <= 128 shares one pass over its W tile;
// K in steps of 32; each step stages the x tile (normalized on the way in
// when fused) and the W tile in shared memory, and runs mma.sync m16n8k16
// bf16 -> fp32, with ldmatrix.trans building the B fragments from the
// N-contiguous W tile. The next step's tiles are loaded into registers while
// the current one computes. The fused norm needs each row's mean over the
// whole K first: a small pass (rms_kernel) writes one fp32 1/rms per row.
// When the output tiles are too few to fill the card (every decode product
// but gate-up), K is split over grid.z: each split writes fp32 partial sums
// and a reduce pass adds them, rounds, and adds the bias. Not yet: wgmma,
// TMA, a deeper load pipeline, a reduction without the fp32 workspace.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace padt {
namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBM = 128;       // output rows per CTA
constexpr int kBN = 128;       // output columns per CTA
constexpr int kBK = 32;        // K per step
constexpr int kThreads = 256;  // 8 warps: 4 (rows) x 2 (columns) of 32 x 64
constexpr int kLdX = kBK + 8;  // smem pitches (bf16): +16 bytes spreads rows over the banks
constexpr int kLdW = kBN + 8;
constexpr int kXChunks = kBM * kBK / 8 / kThreads;  // 16-byte x loads per thread (2)
constexpr int kWChunks = kBK * kBN / 8 / kThreads;  // 16-byte w loads per thread (2)

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
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

// 1 / rms of each x row: one warp per row, 16-byte loads
__global__ void rms_kernel(const bf16* __restrict__ x, long long x_rs, float* __restrict__ rstd,
                           int M, int K, float eps) {
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
  if (lane == 0) rstd[row] = 1.f / sqrtf(s / (float)K + eps);
}

// The step's global tiles, held in registers between the load and the store
// to shared memory. Chunks outside [0, M) x [0, K) (x) or [0, K) x [0, N)
// (w) are zero.
struct Stage {
  uint4 x[kXChunks];
  uint4 ln[kXChunks];  // ln_w at the x chunk's K columns (fused norm only)
  uint4 w[kWChunks];
};

__device__ __forceinline__ void load_stage(Stage& st, const bf16* __restrict__ x, long long x_rs,
                                           const bf16* __restrict__ w, const bf16* __restrict__ ln,
                                           int M, int N, int K, int m0, int n0, int k0) {
#pragma unroll
  for (int j = 0; j < kXChunks; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
    st.x[j] = st.ln[j] = make_uint4(0u, 0u, 0u, 0u);  // zero: 0 * anything stays finite
    if (m0 + r < M && k0 + c < K) {
      st.x[j] = *reinterpret_cast<const uint4*>(x + (long long)(m0 + r) * x_rs + k0 + c);
      if (ln != nullptr) st.ln[j] = *reinterpret_cast<const uint4*>(ln + k0 + c);
    }
  }
#pragma unroll
  for (int j = 0; j < kWChunks; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / (kBN / 8), c = (i % (kBN / 8)) * 8;
    st.w[j] = make_uint4(0u, 0u, 0u, 0u);
    if (k0 + r < K && n0 + c < N)
      st.w[j] = *reinterpret_cast<const uint4*>(w + (long long)(k0 + r) * N + n0 + c);
  }
}

// x chunks are normalized on the way into shared memory when fused: rows
// outside [0, M) are zero and stay zero
__device__ __forceinline__ void store_stage(const Stage& st, const float (&rs)[kXChunks], bool fused,
                                            bf16* sX, bf16* sW) {
#pragma unroll
  for (int j = 0; j < kXChunks; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
    uint4 v = st.x[j];
    if (fused) {
      bf16* e = reinterpret_cast<bf16*>(&v);
      const bf16* l = reinterpret_cast<const bf16*>(&st.ln[j]);
#pragma unroll
      for (int t = 0; t < 8; ++t)
        e[t] = __float2bfloat16(bf16_round(__bfloat162float(e[t]) * rs[j]) * __bfloat162float(l[t]));
    }
    *reinterpret_cast<uint4*>(sX + r * kLdX + c) = v;
  }
#pragma unroll
  for (int j = 0; j < kWChunks; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / (kBN / 8), c = (i % (kBN / 8)) * 8;
    *reinterpret_cast<uint4*>(sW + r * kLdW + c) = st.w[j];
  }
}

// Grid (N tiles, M tiles, splits). Split z sums K rows [z * k_per, (z + 1) *
// k_per). With one split the epilogue rounds, adds the bias and writes bf16
// out; with more, it writes the fp32 partial sums to ws (splits, M, N) for
// reduce_kernel.
__global__ void __launch_bounds__(kThreads, 2)
    stream_matmul_kernel(const bf16* __restrict__ x, long long x_rs, const bf16* __restrict__ w,
                         const bf16* __restrict__ ln, const float* __restrict__ rstd,
                         const bf16* __restrict__ bias, bf16* __restrict__ out,
                         float* __restrict__ ws, int M, int N, int K, int k_per) {
  __shared__ __align__(16) bf16 sX[kBM * kLdX];
  __shared__ __align__(16) bf16 sW[kBK * kLdW];

  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int kb = blockIdx.z * k_per;
  const int ke = min(K, kb + k_per);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;  // this warp's 32 x 64 tile
  const bool fused = ln != nullptr;

  float rs[kXChunks];  // 1 / rms of this thread's x rows (fixed across the K steps)
#pragma unroll
  for (int j = 0; j < kXChunks; ++j) {
    const int r = m0 + (threadIdx.x + j * kThreads) / (kBK / 8);
    rs[j] = fused && r < M ? rstd[r] : 0.f;
  }

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  // tiles past ke are masked as past K: the split's last step may be partial
  Stage st;
  if (kb < ke) load_stage(st, x, x_rs, w, ln, M, N, ke, m0, n0, kb);
  for (int k0 = kb; k0 < ke; k0 += kBK) {
    __syncthreads();  // the previous step's fragments are read
    store_stage(st, rs, fused, sX, sW);
    __syncthreads();
    if (k0 + kBK < ke) load_stage(st, x, x_rs, w, ln, M, N, ke, m0, n0, k0 + kBK);
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
      for (int jp = 0; jp < 4; ++jp) {  // two n8 tiles per ldmatrix
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
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + wn + 8 * j + 2 * t;
    if (n >= N) continue;  // N % 8 == 0: n < N implies n + 1 < N
    const float b0 = (!split && bias != nullptr) ? __bfloat162float(bias[n]) : 0.f;
    const float b1 = (!split && bias != nullptr) ? __bfloat162float(bias[n + 1]) : 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + 16 * i + g + 8 * h;
        if (m >= M) continue;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (split) {
          *reinterpret_cast<float2*>(ws + ((long long)blockIdx.z * M + m) * N + n) = make_float2(v0, v1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(out + (long long)m * N + n) =
              __floats2bfloat162_rn(bf16_round(v0) + b0, bf16_round(v1) + b1);
        }
      }
    }
  }
}

// out[m, n] = bf16(bf16(sum_z ws[z, m, n]) + bias[n]), two columns per thread
__global__ void reduce_kernel(const float* __restrict__ ws, const bf16* __restrict__ bias,
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
    const float b0 = bias != nullptr ? __bfloat162float(bias[n]) : 0.f;
    const float b1 = bias != nullptr ? __bfloat162float(bias[n + 1]) : 0.f;
    *reinterpret_cast<__nv_bfloat162*>(out + e) =
        __floats2bfloat162_rn(bf16_round(a.x) + b0, bf16_round(a.y) + b1);
  }
}

}  // namespace
}  // namespace padt

// C entry point (loaded with ctypes). x_row_stride in elements; w, ln and
// bias are the full (L, ...) stacks and li the layer; ln (fused norm) and
// bias may be null. rstd is an fp32 (M,) scratch buffer when ln is given, ws
// an fp32 (splits, M, N) one when splits > 1 (either may be null otherwise).
// Returns the CUDA error code of the launches (0 on success), or
// cudaErrorInvalidValue for shapes the kernel does not take.
extern "C" int padt_stream_matmul(const void* x, long long x_row_stride, const void* w,
                                  const void* ln, const void* bias, void* out, void* rstd, void* ws,
                                  int M, int N, int K, int L, int li, int splits, float eps,
                                  void* stream) {
  using namespace padt;
  if (M == 0 || N == 0) return 0;
  if (K % 8 != 0 || N % 8 != 0 || x_row_stride % 8 != 0 || splits < 1 || li < 0 || li >= L ||
      (splits > 1 && ws == nullptr) || (ln != nullptr && rstd == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* wl = static_cast<const bf16*>(w) + (long long)li * K * N;
  const bf16* lnl = ln != nullptr ? static_cast<const bf16*>(ln) + (long long)li * K : nullptr;
  const bf16* bl = bias != nullptr ? static_cast<const bf16*>(bias) + (long long)li * N : nullptr;
  if (lnl != nullptr) {
    rms_kernel<<<(M + 7) / 8, 256, 0, st>>>(static_cast<const bf16*>(x), x_row_stride,
                                            static_cast<float*>(rstd), M, K, eps);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int k_tiles = (K + kBK - 1) / kBK;
  const int k_per = (k_tiles + splits - 1) / splits * kBK;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  stream_matmul_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const bf16*>(x), x_row_stride, wl, lnl, static_cast<const float*>(rstd),
      bl, static_cast<bf16*>(out), static_cast<float*>(ws), M, N, K, k_per);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const long long pairs = (long long)M * N / 2;
  const long long need = (pairs + 255) / 256;
  const int blocks = (int)(need < 132 * 8 ? need : 132 * 8);  // grid-stride beyond 8 blocks per SM
  reduce_kernel<<<blocks, 256, 0, st>>>(static_cast<const float*>(ws), bl,
                                        static_cast<bf16*>(out), M, N, splits);
  return (int)cudaGetLastError();
}
