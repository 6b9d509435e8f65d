// Weight-only quantized matmuls for Hopper (sm_90a):
//   int8 / fp8 (e4m3, e5m2):  y = (x @ w_q.to(cd)) * scale[n] + b[n]
//   int4:                     y = x @ (decode(w_q) * scale[k / g, n]).to(cd) + b[n]
//
// Replaces tinyfusers_tpu/kernels/quant_matmul.py::_kernel (int8 and fp8)
// and ::_int4_kernel, and computes what they compute. The weight bytes are
// what device memory holds and what the kernel reads: each weight tile is
// converted to the compute dtype on its way from registers into shared
// memory and never reaches device memory dequantized.
// - int8, e4m3 and e5m2 convert to bf16 exactly (dequantize to the compute
//   dtype, no native-fp8 MMA); sums are fp32; the epilogue is acc * scale[n], then
//   + bias[n], each rounded in fp32, then one rounding to the output dtype.
// - int4: byte r of a row holds k = 2r (low nibble) and 2r + 1 (high), each
//   decoded as ((v & 0xF) ^ 8) - 8, multiplied by its group's fp32 scale and
//   rounded to the compute dtype BEFORE the MMA, as the Pallas kernel does
//   (quant_matmul.py:130-133); the bias is the only epilogue.
//
// What bounds it on an H100: at SD1.5's UNet shapes in bf16 the large-M
// calls (M = 8192 / 2048 / 512 rows of activations) are bound by the bytes of
// x and the output more than by the weight; the small-M calls (M = 2 for the
// time and ResBlock embeddings, M = 154 for the cross-attention k/v
// projections of the 77-token CFG context) by the weight bytes, which int8 /
// fp8 halve and int4 quarters against bf16. Design, bf16 (the main path), as
// csrc/geglu_ff.cu: 64 x 64 output tiles, 4 warps of 32 x 32, 64-deep K
// steps, mma.sync m16n8k16 with ldmatrix operands; x and the weight bytes
// arrive as 16-byte loads into registers one K step ahead, so the next
// step's device-memory reads are in flight while the tensor cores work on
// this one; the weight is decoded between registers and shared memory.
// fp32 keeps exact fp32 arithmetic with plain FMA loops (no TF32): it serves
// the comparisons. Ragged M, N and K are masked in the loads and the
// epilogue (element-wise loads when K breaks 16-byte vectors); the int4
// group size may be any divisor of K (per-element scale lookup unless it is
// a multiple of 32).
// Later work: wgmma, TMA, a deeper pipeline, and split-K for the small-M
// calls (N = 320 gives 5 output tiles for 132 SMs).
#include <cuda_fp8.h>
#include <stdint.h>

#include "common.cuh"

namespace tf {
namespace {

// weight formats passed through the C interface
constexpr int kInt8 = 0;
constexpr int kE4M3 = 1;
constexpr int kE5M2 = 2;
constexpr int kInt4 = 3;

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int NT = 128;

struct Params {
  const void* x;         // (M, K) row-major, compute dtype
  const uint8_t* w;      // int8 / fp8: (N, K); int4: (N, K/2) nibble pairs
  const float* scales;   // int8 / fp8: (N,); int4: (N, K/g)
  const float* bias;     // (N,) fp32, or null
  void* out;             // (M, N)
  int M, N, K, g;
  int vec_x, vec_w;      // 16-byte loads are aligned and stay inside rows
};

__device__ __forceinline__ int decode_int4(int nibble) { return ((nibble & 0xF) ^ 8) - 8; }

template <int FMT>
__device__ __forceinline__ float decode_byte(uint8_t b) {
  if constexpr (FMT == kInt8) {
    return static_cast<float>(static_cast<int8_t>(b));
  } else {
    constexpr __nv_fp8_interpretation_t kind = FMT == kE4M3 ? __NV_E4M3 : __NV_E5M2;
    return __half2float(__half(__nv_cvt_fp8_to_halfraw(b, kind)));
  }
}

// Weight element (n, k) in fp32, scaled for int4 (its value in the
// compute dtype when that is fp32).
template <int FMT>
__device__ __forceinline__ float weight_at(const Params& p, int n, int k) {
  if constexpr (FMT == kInt4) {
    const uint8_t b = p.w[(long long)n * (p.K / 2) + k / 2];
    const int q = decode_int4((k & 1) ? (b >> 4) : b);
    return static_cast<float>(q) * p.scales[(long long)n * (p.K / p.g) + k / p.g];
  } else {
    return decode_byte<FMT>(p.w[(long long)n * p.K + k]);
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16, register-prefetched K steps
// ---------------------------------------------------------------------------

constexpr int BK = 64;                 // K depth of a step
constexpr int LDB = BK + 8;            // shared row stride (ldmatrix bank spread)
constexpr int XV = BM * BK / 8 / NT;   // 16-byte x vectors per thread per step: 4

// 16-byte weight vectors per thread per step: 64 rows x 64 bytes (int8,
// fp8) or x 32 bytes (int4).
template <int FMT>
struct WV {
  static constexpr int kRowBytes = FMT == kInt4 ? BK / 2 : BK;
  static constexpr int kPerRow = kRowBytes / 16;
  static constexpr int kCount = BN * kPerRow / NT;
};

// 8 consecutive bf16 of row `row` from column `col`, zero past the edges.
__device__ __forceinline__ uint4 load_x8(const bf16* base, int K, int row, int nrows,
                                         int col, bool vec) {
  uint4 r = make_uint4(0, 0, 0, 0);
  if (row >= nrows) return r;
  const bf16* src = base + (long long)row * K + col;
  if (vec) {
    if (col < K) r = *reinterpret_cast<const uint4*>(src);
  } else {
    bf16* e = reinterpret_cast<bf16*>(&r);
    for (int i = 0; i < 8; ++i) e[i] = (col + i < K) ? src[i] : __float2bfloat16(0.f);
  }
  return r;
}

// 16 bytes of weight row `row` from byte `cb`, zero past the edges (a zero
// byte decodes to 0 in every format).
__device__ __forceinline__ uint4 load_w16(const uint8_t* base, int row_bytes, int row,
                                          int nrows, int cb, bool vec) {
  uint4 r = make_uint4(0, 0, 0, 0);
  if (row >= nrows) return r;
  const uint8_t* src = base + (long long)row * row_bytes + cb;
  if (vec) {
    if (cb < row_bytes) r = *reinterpret_cast<const uint4*>(src);
  } else {
    uint8_t* e = reinterpret_cast<uint8_t*>(&r);
    for (int i = 0; i < 16; ++i) e[i] = (cb + i < row_bytes) ? src[i] : 0;
  }
  return r;
}

template <int FMT>
struct Stage {
  uint4 x[XV];
  uint4 w[WV<FMT>::kCount];
  float s[WV<FMT>::kCount];  // int4 with g % 32 == 0: each vector's group scale
};

// Weight vector i of this thread: row (i*NT + tid) / kPerRow, bytes at
// 16 * (.. % kPerRow) of the step's row.
template <int FMT>
__device__ __forceinline__ void fetch(Stage<FMT>& s, const Params& p, int m0, int n0,
                                      int k0) {
  const bf16* x = static_cast<const bf16*>(p.x);
#pragma unroll
  for (int i = 0; i < XV; ++i) {
    const int v = i * NT + threadIdx.x;
    s.x[i] = load_x8(x, p.K, m0 + v / 8, p.M, k0 + (v % 8) * 8, p.vec_x);
  }
  constexpr int kPerRow = WV<FMT>::kPerRow;
  const int row_bytes = FMT == kInt4 ? p.K / 2 : p.K;
  const int kb0 = FMT == kInt4 ? k0 / 2 : k0;
#pragma unroll
  for (int i = 0; i < WV<FMT>::kCount; ++i) {
    const int v = i * NT + threadIdx.x;
    const int n = n0 + v / kPerRow, cb = kb0 + (v % kPerRow) * 16;
    s.w[i] = load_w16(p.w, row_bytes, n, p.N, cb, p.vec_w);
    if (FMT == kInt4 && p.g % 32 == 0) {
      const int k = 2 * cb;  // the vector's 32 values lie in one group
      s.s[i] = (n < p.N && k < p.K) ? p.scales[(long long)n * (p.K / p.g) + k / p.g] : 0.f;
    }
  }
}

// As = x, Bs = the weight in bf16 (int4 scaled, then rounded), for the
// fetched step k0.
template <int FMT>
__device__ __forceinline__ void stage(const Stage<FMT>& s, const Params& p, int n0, int k0,
                                      bf16* As, bf16* Bs) {
#pragma unroll
  for (int i = 0; i < XV; ++i) {
    const int v = i * NT + threadIdx.x;
    *reinterpret_cast<uint4*>(As + (v / 8) * LDB + (v % 8) * 8) = s.x[i];
  }
  constexpr int kPerRow = WV<FMT>::kPerRow;
#pragma unroll
  for (int i = 0; i < WV<FMT>::kCount; ++i) {
    const int v = i * NT + threadIdx.x;
    const int r = v / kPerRow;
    const uint8_t* b = reinterpret_cast<const uint8_t*>(&s.w[i]);
    if constexpr (FMT == kInt4) {
      const int kl = (v % kPerRow) * 32;  // the vector's first k in the step
      uint4 d[4];
      uint32_t* dp = reinterpret_cast<uint32_t*>(d);
      const int n = n0 + r;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float s0, s1;
        if (p.g % 32 == 0) {
          s0 = s1 = s.s[i];
        } else {
          const int k = k0 + kl + 2 * j;
          const long long row = (long long)n * (p.K / p.g);
          s0 = (n < p.N && k < p.K) ? p.scales[row + k / p.g] : 0.f;
          s1 = (n < p.N && k + 1 < p.K) ? p.scales[row + (k + 1) / p.g] : 0.f;
        }
        dp[j] = pack_bf16(static_cast<float>(decode_int4(b[j])) * s0,
                          static_cast<float>(decode_int4(b[j] >> 4)) * s1);
      }
      uint4* dst = reinterpret_cast<uint4*>(Bs + r * LDB + kl);
#pragma unroll
      for (int j = 0; j < 4; ++j) dst[j] = d[j];
    } else {
      const int kl = (v % kPerRow) * 16;
      uint4 d[2];
      uint32_t* dp = reinterpret_cast<uint32_t*>(d);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dp[j] = pack_bf16(decode_byte<FMT>(b[2 * j]), decode_byte<FMT>(b[2 * j + 1]));
      uint4* dst = reinterpret_cast<uint4*>(Bs + r * LDB + kl);
      dst[0] = d[0];
      dst[1] = d[1];
    }
  }
}

template <int FMT>
__global__ void __launch_bounds__(NT) quant_mm_bf16(Params p) {
  __shared__ __align__(128) bf16 As[BM * LDB];
  __shared__ __align__(128) bf16 Bs[BN * LDB];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;  // 2 x 2 warps, 32 x 32 each
  const int g = lane / 4, t = lane % 4;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  Stage<FMT> st;
  fetch<FMT>(st, p, m0, n0, 0);
  stage<FMT>(st, p, n0, 0, As, Bs);
  __syncthreads();
  for (int k0 = 0; k0 < p.K; k0 += BK) {
    const bool more = k0 + BK < p.K;
    if (more) fetch<FMT>(st, p, m0, n0, k0 + BK);  // in flight during the products
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[2][4], b[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4(a[i], As + (wm * 32 + i * 16 + lane % 16) * LDB + kk + (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j < 2; ++j)  // output columns wn*32 + 16j .. + 15
        ldsm_x4(b[j], Bs + (wn * 32 + 16 * j + lane % 8 + (lane / 16) * 8) * LDB + kk +
                          ((lane / 8) % 2) * 8);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mma_bf16(acc[i][2 * j], a[i], b[j][0], b[j][1]);
          mma_bf16(acc[i][2 * j + 1], a[i], b[j][2], b[j][3]);
        }
    }
    __syncthreads();
    if (more) {
      stage<FMT>(st, p, n0, k0 + BK, As, Bs);
      __syncthreads();
    }
  }

  bf16* out = static_cast<bf16*>(p.out);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + wn * 32 + 8 * j + 2 * t;
    float sc[2], bi[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool in = n + e < p.N;
      sc[e] = (FMT != kInt4 && in) ? p.scales[n + e] : 1.f;
      bi[e] = (p.bias && in) ? p.bias[n + e] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 32 + i * 16 + g + 8 * h;
        if (m >= p.M) continue;
        float y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          y[e] = acc[i][j][2 * h + e];
          if (FMT != kInt4) y[e] = __fmul_rn(y[e], sc[e]);
          y[e] = __fadd_rn(y[e], bi[e]);
        }
        bf16* dst = out + (long long)m * p.N + n;
        if (n + 1 < p.N && p.N % 2 == 0) {
          *reinterpret_cast<uint32_t*>(dst) = pack_bf16(y[0], y[1]);
        } else {
          if (n < p.N) dst[0] = __float2bfloat16(y[0]);
          if (n + 1 < p.N) dst[1] = __float2bfloat16(y[1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: exact fp32 FMA loops through shared memory
// ---------------------------------------------------------------------------

constexpr int BKF = 32;

template <int FMT>
__global__ void __launch_bounds__(NT) quant_mm_f32(Params p) {
  constexpr int LD = BKF + 1;
  __shared__ float As[BM * LD];
  __shared__ float Bs[BN * LD];
  const float* x = static_cast<const float*>(p.x);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;  // rows tr+8i, cols tc+16j
  float acc[8][4] = {};

  for (int k0 = 0; k0 < p.K; k0 += BKF) {
    __syncthreads();
    for (int i = threadIdx.x; i < BM * BKF; i += NT) {
      const int r = i / BKF, c = i % BKF;
      const int m = m0 + r, n = n0 + r, k = k0 + c;
      As[r * LD + c] = (m < p.M && k < p.K) ? x[(long long)m * p.K + k] : 0.f;
      Bs[r * LD + c] = (n < p.N && k < p.K) ? weight_at<FMT>(p, n, k) : 0.f;
    }
    __syncthreads();
    for (int k = 0; k < BKF; ++k) {
      float b[4];
      for (int j = 0; j < 4; ++j) b[j] = Bs[(tc + 16 * j) * LD + k];
      for (int i = 0; i < 8; ++i) {
        const float a = As[(tr + 8 * i) * LD + k];
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
      }
    }
  }
  float* out = static_cast<float*>(p.out);
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + tr + 8 * i;
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tc + 16 * j;
      if (m >= p.M || n >= p.N) continue;
      float y = acc[i][j];
      if (FMT != kInt4) y = __fmul_rn(y, p.scales[n]);
      if (p.bias) y = __fadd_rn(y, p.bias[n]);
      out[(long long)m * p.N + n] = y;
    }
  }
}

template <int FMT>
int launch(int dtype, const Params& p, cudaStream_t st) {
  const dim3 grid((p.M + BM - 1) / BM, (p.N + BN - 1) / BN);
  if (dtype == kBFloat16) {
    quant_mm_bf16<FMT><<<grid, NT, 0, st>>>(p);
  } else if (dtype == kFloat32) {
    quant_mm_f32<FMT><<<grid, NT, 0, st>>>(p);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace tf

// x (M, K) contiguous in the compute dtype (0 fp32, 1 bf16); w (N, K)
// contiguous bytes, format 0 int8, 1 e4m3 or 2 e5m2; scales (N,) fp32; bias (N,)
// fp32 or null; out (M, N) contiguous, in x's dtype.
extern "C" int tf_quant_matmul(int dtype, int fmt, const void* x, const void* w,
                               const float* scales, const float* bias, void* out, int M,
                               int N, int K, void* stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  const int xbytes = dtype == tf::kBFloat16 ? 2 : 4;
  tf::Params p{x, static_cast<const uint8_t*>(w), scales, bias, out, M, N, K, 1,
               (K * xbytes) % 16 == 0 && tf::aligned16(x),
               K % 16 == 0 && tf::aligned16(w)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fmt == tf::kInt8) return tf::launch<tf::kInt8>(dtype, p, st);
  if (fmt == tf::kE4M3) return tf::launch<tf::kE4M3>(dtype, p, st);
  if (fmt == tf::kE5M2) return tf::launch<tf::kE5M2>(dtype, p, st);
  return cudaErrorInvalidValue;
}

// x as above; packed (N, K/2) contiguous bytes, byte r of a row holding
// k = 2r (low nibble) and 2r + 1 (high); scales (N, K/g) fp32 contiguous;
// g divides K; bias and out as above.
extern "C" int tf_quant_matmul_int4(int dtype, const void* x, const void* packed,
                                    const float* scales, const float* bias, void* out,
                                    int M, int N, int K, int g, void* stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  if (K % 2 != 0 || g <= 0 || K % g != 0) return cudaErrorInvalidValue;
  const int xbytes = dtype == tf::kBFloat16 ? 2 : 4;
  tf::Params p{x, static_cast<const uint8_t*>(packed), scales, bias, out, M, N, K, g,
               (K * xbytes) % 16 == 0 && tf::aligned16(x),
               (K / 2) % 16 == 0 && tf::aligned16(packed)};
  return tf::launch<tf::kInt4>(dtype, p, static_cast<cudaStream_t>(stream));
}
