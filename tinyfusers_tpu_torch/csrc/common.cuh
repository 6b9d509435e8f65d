// Helpers shared by the port's CUDA kernels: dtype codes, float
// conversion for the two element types the kernels take, and the warp-level
// bf16 tensor-core pieces (ldmatrix, mma.sync m16n8k16, 16-byte tile loads).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace tf {

// dtype codes passed through the C interface
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

using bf16 = __nv_bfloat16;

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<bf16>(bf16 x) { return __bfloat162float(x); }

// Round to T (round-to-nearest-even for bf16, as astype does).
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// ---- bf16 tensor-core fragments (PTX ISA, "mma.m16n8k16") -----------------
// Within a warp, lane = 4 * g + t. An m16n8 fp32 accumulator c[4] holds
// rows g (c[0], c[1]) and g + 8 (c[2], c[3]), columns 2t and 2t + 1.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same, each matrix transposed.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a (16x16, row-major) . b (16x8, column-major); bf16 in, fp32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16, `lo` in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// dst[r][c] = src[(r0 + r) * rstride + c] for r < rows, c < wp, zero where
// r0 + r >= nrows or c >= w. With vec, 16-byte copies (w, wp, rstride and
// ld multiples of 8, src and dst 16-byte aligned); else element by element.
template <int NT>
__device__ __forceinline__ void load_rows_bf16(bf16* dst, int ld, const bf16* src,
                                               long long rstride, int r0, int nrows,
                                               int w, int wp, int rows, bool vec) {
  if (vec) {
    const int cpr = wp / 8;
    for (int i = threadIdx.x; i < rows * cpr; i += NT) {
      const int r = i / cpr, c = (i - r * cpr) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (r0 + r < nrows && c < w)
        val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * rstride + c);
      *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int i = threadIdx.x; i < rows * wp; i += NT) {
      const int r = i / wp, c = i - r * wp;
      bf16 val = zero;
      if (r0 + r < nrows && c < w) val = src[(long long)(r0 + r) * rstride + c];
      dst[r * ld + c] = val;
    }
  }
}

}  // namespace tf

extern "C" const char* tf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
