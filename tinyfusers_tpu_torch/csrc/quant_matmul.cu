// Weight-only quantized matmuls for Hopper (sm_90a):
//   int8 / fp8 (e4m3, e5m2):  y = (x @ w_q.to(cd)) * scale[n] + b[n]
//   int4:                     y = x @ (decode(w_q) * scale[k / g, n]).to(cd) + b[n]
//
// Replaces tinyfusers_tpu/kernels/quant_matmul.py::_kernel (int8 and fp8)
// and ::_int4_kernel, and computes what they compute. The weight bytes are
// what device memory holds and what the kernel reads: each weight tile is
// converted to the compute dtype on chip and never reaches device memory
// dequantized.
// - int8, e4m3 and e5m2 convert to bf16 exactly (dequantize to the compute
//   dtype, no native-fp8 MMA); sums are fp32; the epilogue is acc * scale[n], then
//   + bias[n], each rounded in fp32, then one rounding to the output dtype.
// - int4: byte r of a row holds k = 2r (low nibble) and 2r + 1 (high), each
//   decoded as ((v & 0xF) ^ 8) - 8, multiplied by its group's fp32 scale in
//   fp32 and rounded once to the compute dtype BEFORE the MMA, as the Pallas
//   kernel does (quant_matmul.py:130-133); the bias is the only epilogue.
//   Rounding the scale to bf16 first (a bf16 __hmul2 / __hfma2 decode) would
//   change the result, so every variant keeps the fp32 product.
//
// What bounds it on an H100: at SD1.5's UNet shapes in bf16 the large-M
// calls (M = 8192 / 2048 / 512 rows of activations) are bound by the bytes of
// x and the output, or by the tensor cores, more than by the weight; the
// small-M calls (M = 2 for the time and ResBlock embeddings, M = 128 / 154
// for the mid block and the cross-attention k/v projections of the 77-token
// CFG context) by the weight bytes, which int8 / fp8 halve and int4
// quarters against bf16, and in practice by latency: a few K steps per
// output tile, and few output tiles for 132 SMs.
//
// Three kernels; kernels/quant_matmul.py::_plan names the one a call runs:
//   mma    (bf16, every format, where wgmma does not take the shape)
//          as csrc/geglu_ff.cu: 64 x 64 output tiles, 4 warps of 32 x 32,
//          64-deep K steps, mma.sync m16n8k16 with ldmatrix operands; x and
//          the weight bytes arrive as 16-byte loads into registers one K
//          step ahead and are decoded between registers and shared memory.
//          Ragged M, N and K are masked in the loads and the epilogue
//          (element-wise loads when K breaks 16-byte vectors); the int4
//          group size may be any divisor of K.
//   wgmma  (bf16, every format, where TMA reads the operands in place and K
//          is a whole number of 64-deep steps: K % 64 == 0, N % 8 == 0; for
//          int4 also g % 16 == 0 with g dividing or a multiple of 64; every
//          SD1.5 UNet shape). One kernel template over the format. It
//          computes out^T (N x M) = W^T . x^T, so the weight is wgmma's A
//          operand, from registers:
//          * one producer warp issues TMA copies of (x tile: BN rows x 64 of
//            K, 128-byte swizzled; weight tile: 64 rows x 32 bytes of int4
//            or 64 bytes of int8 / fp8, the latter 64-byte swizzled) into a
//            ring of stages with full / empty mbarriers;
//          * one consumer warpgroup owns 64 weight rows (output columns).
//            In the m64k16 A fragment a thread holds rows g and g + 8 at k
//            2t..2t+1 and 2t+8..2t+9. For int4 each pair is one packed byte
//            (the nibble to float step exact through the 2^23 magic number,
//            the scale an fp32 product, then cvt.rn.bf16x2); for int8 / fp8
//            it is two bytes, read as 4-byte words of the swizzled tile
//            (the 8 rows of a warp on distinct banks) and converted exactly,
//            unscaled (int8 through the magic number, e4m3 / e5m2 through
//            cvt.rn.f16x2.e4m3x2 / e5m2x2). The next stage decodes while
//            this stage's wgmmas run, and the decoded weight never touches
//            shared memory; it serves the whole n = BN tile of x rows (8,
//            64, 128 or 160 by M), so at large M a weight tile is decoded
//            once per 160 rows of x. No fp8 or int8 MMA: x stays bf16, as
//            in the reference;
//          * TMA fills x rows past M with zeros, so M = 2 runs as n = 8
//            with no pad in device memory; int4's group scales are read
//            once into shared memory (a (N, K/g) row of 5 fp32 is no TMA
//            box), the byte formats' per-channel scales into registers;
//          * split-K for shapes whose output tiles do not fill the card
//            (the plan's `split`, up to 8): the splits of one tile form a
//            thread block cluster. After a cluster barrier each block
//            stores its fp32 partial of every 8-row group j of x rows into
//            the shared memory of the group's owner, the block of rank
//            j % split (distributed shared memory, one slot per sender);
//            after a second barrier each owner sums its slots in rank order
//            0, 1, ..., then (int8 / fp8) multiplies by the scale and adds
//            the bias. Stores, not loads, cross the cluster, so no block
//            waits on a remote round trip. One launch, no workspace, no
//            atomics: every call and every CUDA-graph replay gives the same
//            bits;
//          * the epilogue writes the bf16 tile into 128-byte swizzled
//            shared memory (conflict-free) and TMA stores it (the map
//            clips rows past M and columns past N).
//          Two blocks fit an SM (160 threads of <= 200 registers, <= 113 KB
//          of shared memory each), so one block's loads and epilogue
//          overlap the other's products.
//   fma    (fp32, every format) exact fp32 arithmetic with plain FMA loops
//          (no TF32): it serves the comparisons.
#include <cuda_fp8.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

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
// bf16, every format: TMA ring + wgmma with the decoded weight as A from
// registers
// ---------------------------------------------------------------------------

namespace wg {

constexpr int NW = 64;              // weight rows (output columns) per block
constexpr int KS = 64;              // K per stage
constexpr int MAX_GROUPS = 32;      // int4 group scales a block holds (8 KB of fp32)
// A consumer warpgroup and one producer warp: two blocks an SM leave up to
// 200 registers a thread, and the 160-row tile takes 136. A producer
// warpgroup would cap the block at 128 (setmaxnreg does not help: ptxas
// sizes every instruction to the launch bound).
constexpr int THREADS = 160;
constexpr int MAX_SMEM = 115712;    // two blocks an SM (228 KB, 1 KB each reserved)

// What the weight format changes: the bytes of one weight row per K step
// (int4: two values a byte; int8 / fp8: one), hence the tile and its
// layout, and the shared memory for int4's group scales (the byte formats'
// per-channel scale is two registers a thread, applied in the epilogue).
// The byte formats' 64-byte rows are stored with TMA's 64-byte swizzle
// (the 16-byte chunk c of row r at chunk c ^ ((r / 2) % 4)), so the 8 rows
// a warp decodes at once fall on distinct banks; int4's 32-byte rows do
// without.
template <int FMT>
struct Fmt {
  static constexpr bool NIBBLES = FMT == kInt4;
  static constexpr int ROW = NIBBLES ? KS / 2 : KS;
  static constexpr int WT = NW * ROW;  // 2 KB int4, 4 KB int8 / fp8
  static constexpr int SCALE_BYTES = NIBBLES ? MAX_GROUPS * NW * 4 : 0;
  static constexpr CUtensorMapSwizzle SWIZZLE =
      NIBBLES ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_64B;
};

struct Params {
  const float* scales;  // int4: (N, K/g); int8 / fp8: (N,)
  const void* bias;     // (N,) fp32, or bf16 when bias_bf16 (converts exactly), or null
  int bias_bf16;
  int M, N, K, g;
};

// Ring stages by x-row tile: as many as two blocks an SM leave room for,
// up to 8 (int4's were fitted first and stay as they were).
constexpr int stages(int fmt, int bn) {
  return fmt == kInt4 ? (bn == 8 ? 8 : bn == 64 ? 6 : 4)
                      : (bn == 8 ? 8 : bn == 64 ? 8 : bn == 128 ? 5 : 4);
}

// Format FMT, BN x rows (wgmma's n) per block.
template <int FMT_, int BN_>
struct Cfg {
  static constexpr int FMT = FMT_, BN = BN_, ST = stages(FMT_, BN_);
  static constexpr int WT = Fmt<FMT>::WT;
  static_assert(BN % 8 == 0 && BN <= 256, "wgmma n");
  static constexpr int XT = BN * 128;  // x tile: BN rows x 64 bf16, 128-byte swizzled
  static constexpr int OFF_W = ST * XT;
  static constexpr int RING = ST * (XT + WT);
  // After the main loop the ring holds the epilogue: with split-K, the
  // partials the cluster sends this block (split x JL 8-row groups of 2 KB,
  // JL = ceil(NJ / split) the groups it owns, split x JL <= NJ + 7), then
  // its bf16 output groups of 1 KB each.
  static constexpr int NJ = BN / 8;
  static constexpr int EPI = (NJ + 7) * 2048 + NJ * 1024;
  static constexpr int OFF_S = RING > EPI ? RING : EPI;
  static constexpr int OFF_BAR = OFF_S + Fmt<FMT>::SCALE_BYTES;
  // + 1024 so the base can be rounded up to the swizzle's 1024-byte period
  static constexpr int SMEM = OFF_BAR + 16 * ST + 1024;
  static_assert(SMEM <= MAX_SMEM, "two blocks an SM");
};

// Byte `t` of `word` (k pair 2j, 2j + 1 of one weight row) times fp32 scale
// `s`, as the A fragment's bf16 pair (the lower k in the low half).
// (v ^ 8) - 8 of a nibble v is exactly 2^23 + (v ^ 8) - (2^23 + 8) in fp32.
__device__ __forceinline__ uint32_t decode_pair(uint32_t word, int t, float s) {
  const uint32_t b = word >> (8 * t);
  const float lo = __uint_as_float(0x4B000000u | ((b & 0xFu) ^ 8u)) - 8388616.f;
  const float hi = __uint_as_float(0x4B000000u | (((b >> 4) & 0xFu) ^ 8u)) - 8388616.f;
  return pack_bf16(__fmul_rn(lo, s), __fmul_rn(hi, s));
}

// The low two bytes of `v` (weights at k and k + 1 of one row, k in the low
// byte) as the A fragment's bf16 pair, exactly and unscaled: an int8 byte b
// is 2^23 + (b ^ 0x80) - (2^23 + 128) in fp32; an fp8 pair converts to f16
// (cvt.rn.f16x2.e4m3x2 / .e5m2x2, NaN and inf kept), then through fp32.
template <int FMT>
__device__ __forceinline__ uint32_t decode_bytes(uint32_t v) {
  if constexpr (FMT == kInt8) {
    const float lo = __uint_as_float(0x4B000000u | ((v & 0xFFu) ^ 0x80u)) - 8388736.f;
    const float hi = __uint_as_float(0x4B000000u | (((v >> 8) & 0xFFu) ^ 0x80u)) - 8388736.f;
    return pack_bf16(lo, hi);
  } else {
    constexpr __nv_fp8_interpretation_t kind = FMT == kE4M3 ? __NV_E4M3 : __NV_E5M2;
    const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(v), kind);
    const float2 f = __half22float2(__half2(h));
    return pack_bf16(f.x, f.y);
  }
}

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragments of the four k16 steps of global stage `kt` for this thread's
// weight rows r0 and r0 + 8: a[4kk + 0..3] = (r0, 2t), (r0 + 8, 2t),
// (r0, 2t + 8), (r0 + 8, 2t + 8) of step kk, each a k pair: one byte of
// int4 (times its group's scale), two bytes of int8 / fp8.
template <int FMT>
__device__ __forceinline__ void decode_stage(uint32_t (&a)[16], const unsigned char* ws,
                                             const float* ssc, const Params& p, int kt,
                                             int gb, int r0, int t) {
  if constexpr (FMT == kInt4) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // bytes 8kk .. 8kk + 7 of each row: k 16kk .. 16kk + 15
      const uint2 w0 = *reinterpret_cast<const uint2*>(ws + r0 * 32 + 8 * kk);
      const uint2 w8 = *reinterpret_cast<const uint2*>(ws + (r0 + 8) * 32 + 8 * kk);
      const float* sc = ssc + ((kt * KS + 16 * kk) / p.g - gb) * NW;
      const float s0 = sc[r0], s8 = sc[r0 + 8];
      a[4 * kk + 0] = decode_pair(w0.x, t, s0);
      a[4 * kk + 1] = decode_pair(w8.x, t, s8);
      a[4 * kk + 2] = decode_pair(w0.y, t, s0);
      a[4 * kk + 3] = decode_pair(w8.y, t, s8);
    }
  } else {
    // chunk kk (16 bytes) of a 64-byte row holds k 16kk .. 16kk + 15; the
    // pair 2t, 2t + 1 is half (t & 1) of the chunk's word t / 2, the pair
    // 2t + 8, 2t + 9 the same half of word 2 + t / 2. Rows r0 and r0 + 8
    // share the swizzle's XOR.
    const int xr = (r0 >> 1) & 3;
    const int sh = 16 * (t & 1);
    const unsigned char* w0 = ws + r0 * KS + 4 * (t >> 1);
    const unsigned char* w8 = w0 + 8 * KS;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int c = (kk ^ xr) * 16;
      a[4 * kk + 0] = decode_bytes<FMT>(lds32(w0 + c) >> sh);
      a[4 * kk + 1] = decode_bytes<FMT>(lds32(w8 + c) >> sh);
      a[4 * kk + 2] = decode_bytes<FMT>(lds32(w0 + c + 8) >> sh);
      a[4 * kk + 3] = decode_bytes<FMT>(lds32(w8 + c + 8) >> sh);
    }
  }
}

// One 8-row group of the bf16 output tile in shared memory (1 KB, 1 KB
// aligned): row m (x row, 0..7), 64 columns (weight rows) of 128 bytes,
// 16-byte chunks XOR-swizzled by m as TMA's 128-byte swizzle lays them out.
__device__ __forceinline__ void put_out(unsigned char* tile, int m, int r, float v) {
  const int chunk = (r / 8) ^ m;
  *reinterpret_cast<bf16*>(tile + m * 128 + chunk * 16 + (r % 8) * 2) = __float2bfloat16(v);
}

template <class C>
__global__ void __launch_bounds__(THREADS, 2)
    quant_mm_wgmma(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                   const __grid_constant__ CUtensorMap to, const Params p) {
  constexpr int FMT = C::FMT, BN = C::BN, ST = C::ST, NA = BN / 2;
  constexpr int ROW = Fmt<FMT>::ROW;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* empty = full + ST;
  float* ssc = reinterpret_cast<float*>(smem + C::OFF_S);

  const int n0 = blockIdx.x * NW, m0 = blockIdx.y * BN;
  const int split = gridDim.z, rank = blockIdx.z;  // the cluster is (1, 1, split)
  const int ks = p.K / KS;
  const int kb = rank * ks / split, ke = (rank + 1) * ks / split;  // this block's stages
  const int nst = ke - kb;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // producer warp: one thread issues every copy
    if (threadIdx.x == 128) {
      for (int i = 0; i < nst; ++i) {
        const int s = i % ST;
        mbar_wait(&empty[s], ((i / ST) & 1) ^ 1);  // the first round passes
        mbar_expect_tx(&full[s], C::XT + C::WT);
        tma_load_2d(smem + s * C::XT, &tx, &full[s], (kb + i) * KS, m0);
        tma_load_2d(smem + C::OFF_W + s * C::WT, &tw, &full[s], (kb + i) * ROW, n0);
      }
    }
    if (split > 1) {  // the consumers' two cluster barriers
      cluster_sync();
      cluster_sync();
    }
  } else {
    const int t = threadIdx.x, warp = t / 32, lane = t % 32;
    const int tq = lane % 4;
    const int r0 = 16 * warp + lane / 4;  // this thread's weight rows: r0, r0 + 8

    // int4: the group scales of this block's rows over its K range,
    // group-major; int8 / fp8: the per-channel scales of rows r0, r0 + 8
    int gb = 0;
    if constexpr (FMT == kInt4) {
      const int G = p.K / p.g;
      gb = kb * KS / p.g;
      const int ng = min(G, (ke * KS + p.g - 1) / p.g) - gb;  // <= MAX_GROUPS (host)
      for (int i = t; i < ng * NW; i += 128) {
        const int r = i / ng, j = i - (i / ng) * ng, n = n0 + r;
        ssc[j * NW + r] = n < p.N ? p.scales[(long long)n * G + gb + j] : 0.f;
      }
    }
    float scale[2], bias[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + r0 + 8 * h;
      scale[h] = (FMT != kInt4 && n < p.N) ? p.scales[n] : 1.f;
      if (p.bias == nullptr || n >= p.N) bias[h] = 0.f;
      else if (p.bias_bf16) bias[h] = __bfloat162float(static_cast<const bf16*>(p.bias)[n]);
      else bias[h] = static_cast<const float*>(p.bias)[n];
    }
    // the sum over all of K, then (int8 / fp8) times the scale, then plus
    // the bias, each rounded in fp32 as the reference does: no FMA
    auto finish = [&](float y, int h) {
      if constexpr (C::FMT != kInt4) y = __fmul_rn(y, scale[h]);
      return __fadd_rn(y, bias[h]);
    };
    bar_sync(1, 128);

    float acc[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] = 0.f;
    uint32_t fa[16], fb[16];
    mbar_wait(&full[0], 0);
    decode_stage<FMT>(fa, smem + C::OFF_W, ssc, p, kb, gb, r0, tq);
    for (int i = 0; i < nst; ++i) {
      const int s = i % ST;
      const unsigned char* xs = smem + s * C::XT;
      fence_regs(acc);
      fence_regs(fa);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, fa + 4 * kk, sw128_desc(xs + 32 * kk));
      wg_commit();
      if (i + 1 < nst) {  // decode the next stage while the tensor cores run
        const int s1 = (i + 1) % ST;
        mbar_wait(&full[s1], ((i + 1) / ST) & 1);
        decode_stage<FMT>(fb, smem + C::OFF_W + s1 * C::WT, ssc, p, kb + i + 1, gb, r0, tq);
      }
      wg_wait0();
      fence_regs(acc);
      fence_regs(fa);
      if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with stage s
#pragma unroll
      for (int j = 0; j < 16; ++j) fa[j] = fb[j];
    }

    // acc[4j + e]: weight row r0 + 8 (e / 2), x row 8j + 2 tq + e % 2. The
    // block of rank r owns the 8-row groups j with j % split == r; its jl-th
    // (j = r + jl * split) goes out from tile + jl * 1 KB.
    const int nj = min(C::NJ, (p.M - m0 + 7) / 8);  // groups holding rows < M
    const int jl_count = (C::NJ + split - 1) / split;
    unsigned char* tile = smem + split * jl_count * (split > 1 ? 2048 : 0);
    if (split == 1) {
#pragma unroll
      for (int j = 0; j < C::NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          put_out(tile + j * 1024, 2 * tq + (e & 1), r0 + 8 * (e / 2),
                  finish(acc[4 * j + e], e / 2));
    } else {
      // each block sends its partial of group j into the owner's slot
      // [rank][j / split]; the owner then sums the slots in rank order
      float4* slots = reinterpret_cast<float4*>(smem);
      cluster_sync();  // every block is done with its ring
#pragma unroll
      for (int j = 0; j < C::NJ; ++j)
        if (j < nj)
          st_cluster(slots + (rank * jl_count + j / split) * 128 + t, j % split,
                     make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]));
      cluster_sync();  // every partial has arrived; no remote access follows
      for (int jl = 0; rank + jl * split < nj; ++jl) {
        float4 v = slots[jl * 128 + t];
        for (int q = 1; q < split; ++q) {
          const float4 o = slots[(q * jl_count + jl) * 128 + t];
          v = make_float4(__fadd_rn(v.x, o.x), __fadd_rn(v.y, o.y), __fadd_rn(v.z, o.z),
                          __fadd_rn(v.w, o.w));
        }
        const float y[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          put_out(tile + jl * 1024, 2 * tq + (e & 1), r0 + 8 * (e / 2), finish(y[e], e / 2));
      }
    }
    fence_async_smem();
    bar_sync(1, 128);
    if (t == 0) {
      for (int jl = 0; rank + jl * split < nj; ++jl)
        tma_store_2d(&to, tile + jl * 1024, n0, m0 + 8 * (rank + jl * split));
      tma_store_wait();
    }
  }
}

// A 2-D row-major tensor (dim0 contiguous, dim1 rows of `row_bytes`) as a
// tensor map with boxes of box0 x box1; zeros outside on loads.
int encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base, int dim0, int dim1,
              long long row_bytes, int box0, int box1, CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)dim0, (cuuint64_t)dim1};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box0, (cuuint32_t)box1};
  const cuuint32_t ones[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(base), dims, strides, box, ones,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Groups of scales the block of split rank `r` reads (kernel: ng).
inline int groups_of(int K, int g, int split, int r) {
  const int ks = K / KS, kb = r * ks / split, ke = (r + 1) * ks / split;
  return std::min(K / g, (ke * KS + g - 1) / g) - kb * KS / g;
}

template <class C>
int run(const void* x, const void* w, void* out, const Params& p, int split,
        cudaStream_t stream) {
  using F = Fmt<C::FMT>;
  const int row_bytes = p.K / KS * F::ROW;  // K / 2 int4, K int8 / fp8
  CUtensorMap tx, tw, to;
  int err = encode_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, p.K, p.M, 2ll * p.K, KS, C::BN,
                      CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = encode_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, row_bytes, p.N, row_bytes, F::ROW,
                    NW, F::SWIZZLE);
  if (err == cudaSuccess)
    err = encode_2d(&to, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, out, p.N, p.M, 2ll * p.N, NW, 8,
                    CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  auto kernel = quant_mm_wgmma<C>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.N + NW - 1) / NW, (p.M + C::BN - 1) / C::BN, split);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = split;
  cfg.attrs = cluster;
  cfg.numAttrs = split > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, tx, tw, to, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Calls run<Cfg> for x-row tile `bn` (the plan's tile); cudaErrorInvalidValue
// for a tile no configuration has.
template <int FMT>
int launch(int bn, const void* x, const void* w, void* out, const Params& p, int split,
           cudaStream_t st) {
  if (bn == 8) return run<Cfg<FMT, 8>>(x, w, out, p, split, st);
  if (bn == 64) return run<Cfg<FMT, 64>>(x, w, out, p, split, st);
  if (bn == 128) return run<Cfg<FMT, 128>>(x, w, out, p, split, st);
  if (bn == 160) return run<Cfg<FMT, 160>>(x, w, out, p, split, st);
  return cudaErrorInvalidValue;
}

}  // namespace wg

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

// Kernel variants, as kernels/quant_matmul.py::_VARIANTS numbers them.
constexpr int kVarFma = 0;
constexpr int kVarMma = 1;
constexpr int kVarWgmma = 2;

// x (M, K) contiguous in the compute dtype (0 fp32, 1 bf16). w: format 0
// int8, 1 e4m3 or 2 e5m2, (N, K) contiguous bytes with scales (N,) fp32;
// format 3 int4, (N, K/2) contiguous bytes, byte r of a row holding k = 2r
// (low nibble) and 2r + 1 (high), with scales (N, K/g) fp32 contiguous, g
// dividing K (g is not read for the byte formats). bias (N,) of dtype code
// `bias_dtype` (fp32; bf16 for wgmma only) or null; out (M, N) contiguous,
// in x's dtype. `variant` comes from the wrapper's shape rule (fma: fp32;
// mma, wgmma: bf16), and for wgmma `tile` (x rows per block: 8, 64, 128 or
// 160) and `split` (K splits, 1..8, one cluster); a shape the variant does
// not take is refused.
extern "C" int tf_quant_matmul(int variant, int dtype, int fmt, const void* x, const void* w,
                               const float* scales, const void* bias, int bias_dtype,
                               void* out, int M, int N, int K, int g, int tile, int split,
                               void* stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  if (fmt < tf::kInt8 || fmt > tf::kInt4) return cudaErrorInvalidValue;
  const bool int4 = fmt == tf::kInt4;
  if (int4 && (K % 2 != 0 || g <= 0 || K % g != 0)) return cudaErrorInvalidValue;
  if ((variant == kVarFma) != (dtype == tf::kFloat32)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == kVarWgmma) {
    namespace wg = tf::wg;
    const bool takes = K % wg::KS == 0 && N % 8 == 0 && split >= 1 && split <= 8 &&
                       split <= K / wg::KS && tf::aligned16(x) && tf::aligned16(w) &&
                       tf::aligned16(out) &&
                       (!int4 || (g % 16 == 0 && (wg::KS % g == 0 || g % wg::KS == 0)));
    if (!takes) return cudaErrorInvalidValue;
    if (int4)
      for (int r = 0; r < split; ++r)
        if (wg::groups_of(K, g, split, r) > wg::MAX_GROUPS) return cudaErrorInvalidValue;
    const wg::Params p{scales, bias, bias_dtype == tf::kBFloat16, M, N, K, g};
    if (fmt == tf::kInt8) return wg::launch<tf::kInt8>(tile, x, w, out, p, split, st);
    if (fmt == tf::kE4M3) return wg::launch<tf::kE4M3>(tile, x, w, out, p, split, st);
    if (fmt == tf::kE5M2) return wg::launch<tf::kE5M2>(tile, x, w, out, p, split, st);
    return wg::launch<tf::kInt4>(tile, x, w, out, p, split, st);
  }
  if ((variant != kVarMma && variant != kVarFma) || bias_dtype != tf::kFloat32)
    return cudaErrorInvalidValue;
  const int xbytes = dtype == tf::kBFloat16 ? 2 : 4;
  const int row_bytes = int4 ? K / 2 : K;
  tf::Params p{x, static_cast<const uint8_t*>(w), scales, static_cast<const float*>(bias),
               out, M, N, K, int4 ? g : 1,
               (K * xbytes) % 16 == 0 && tf::aligned16(x),
               row_bytes % 16 == 0 && tf::aligned16(w)};
  if (fmt == tf::kInt8) return tf::launch<tf::kInt8>(dtype, p, st);
  if (fmt == tf::kE4M3) return tf::launch<tf::kE4M3>(dtype, p, st);
  if (fmt == tf::kE5M2) return tf::launch<tf::kE5M2>(dtype, p, st);
  return tf::launch<tf::kInt4>(dtype, p, st);
}
