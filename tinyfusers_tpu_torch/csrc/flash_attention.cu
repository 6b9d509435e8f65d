// Flash attention forward for Hopper (sm_90a): two kernels (bf16, fp32)
// behind two C entry points.
//
// Replaces tinyfusers_tpu/kernels/flash_attention.py:
//   tf_flash_packed -> _kernel_packed and _kernel_packed_multik
//                      (heads-packed (B, S, H*d) layout; the TPU split it
//                      in two by whether all keys fit one VMEM block, the
//                      64-key tile walk below takes any key length, so
//                      SD3's joint attention, (2, 4224, 24 x 64) with
//                      kv_len 4173, runs here as SD1.5's UNet does)
//   tf_flash_bhsd   -> _kernel         ((N, S, d) layout, causal, kv_len)
// and computes what they compute: q arrives prescaled by scale*log2(e)
// (rounded in q's dtype by the caller), logits are fp32, softmax runs in
// base 2 (exp2) with fp32 statistics, P is rounded to v's dtype before
// the P.V product, key columns >= sk_real (and, when causal, above the
// diagonal) are masked with -1e30, and a row with no unmasked key gives 0.
// The packed layout is read in place through a row stride of H*d and a
// head offset of h*d: no head transpose is ever materialized.
//
// What bounds it on an H100: at SD1.5's shapes the self-attention calls
// are bound by tensor-core operations (4096 x 4096 x d per head), the
// cross-attention calls (77 keys) by the bytes of q and o; SD3's joint
// calls (4224 x 4173 x 64 per head, 24 heads) by operations. Design:
//   * a block of 4 warps owns 64 query rows of one (batch, head) and walks
//     the keys in 64-row tiles with an online softmax, so any key length
//     runs; tiles wholly past kv_len or above the causal diagonal are
//     skipped;
//   * bf16 (the main path) is register-resident, in the FlashAttention-2
//     form: each warp owns 16 query rows; Q.K^T, the softmax statistics,
//     P and the output accumulator stay in registers; the fp32 logits of
//     an m16n8k16 accumulator are re-packed as P's bf16 A fragments
//     without a trip through shared memory; K and V come from shared
//     memory through ldmatrix (V transposed on the way);
//   * d is zero-padded to a multiple of 16 in shared memory (d = 40 -> 48),
//     so ragged head widths and ragged key counts (77) need no padding in
//     device memory;
//   * the output's d is split across blocks in chunks of at most 128
//     columns (grid.y), each block recomputing the logits for its chunk:
//     the accumulator stays at 16 x 128 per warp, and the VAE's d = 512
//     single head runs as 4 chunks (its Q.K^T computed 4 times);
//   * fp32 keeps exact fp32 arithmetic with plain FMA loops through shared
//     memory (no TF32): it serves the comparisons, not the main path.
// Later work: wgmma, TMA, a multi-stage K/V pipeline.
#include <stdint.h>

#include "common.cuh"

namespace tf {
namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per tile
constexpr int NT = 128;  // threads per block, 4 warps
constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, Sq, Sk, sk_real, d, causal;
  long long q_bstride, q_rstride;    // elements; a head starts at h*d
  long long kv_bstride, kv_rstride;
  int DO;     // output columns per block (multiple of 16, <= 128)
  int n_out;  // output column chunks per head
  int vec;    // 16-byte loads are aligned (bf16)
};

struct Block {
  int q0, o0, ow;
  const void *q, *k, *v;
  void* o;
};

// This block's query tile, output chunk and (batch, head) base pointers.
template <typename T>
__device__ __forceinline__ Block block_of(const Params& p) {
  Block s;
  s.q0 = blockIdx.x * BQ;
  const int h = blockIdx.y / p.n_out;
  s.o0 = (blockIdx.y % p.n_out) * p.DO;
  s.ow = min(p.DO, p.d - s.o0);  // real output columns of this block
  const long long hoff = (long long)h * p.d;
  const int b = blockIdx.z;
  s.q = static_cast<const T*>(p.q) + b * p.q_bstride + hoff;
  s.k = static_cast<const T*>(p.k) + b * p.kv_bstride + hoff;
  s.v = static_cast<const T*>(p.v) + b * p.kv_bstride + hoff;
  s.o = static_cast<T*>(p.o) + b * p.q_bstride + hoff;
  return s;
}

// Key tiles this block visits: later tiles are past kv_len, or all above
// the causal diagonal.
__device__ __forceinline__ int key_tiles(const Params& p, int q0) {
  int kend = p.sk_real;
  if (p.causal) kend = min(kend, q0 + BQ);
  return (kend + BK - 1) / BK;
}

__device__ __forceinline__ bool masked(const Params& p, int row, int col) {
  return col >= p.sk_real || (p.causal && col > row);
}

// ---------------------------------------------------------------------------
// bf16: register-resident (FlashAttention-2 form), mma.sync m16n8k16
// ---------------------------------------------------------------------------

// Shared memory: Q [BQ][dp + 8], K [BK][dp + 8], V [BK][DO + 8] (bf16).
// The 8-element pad makes ldmatrix's 8 rows fall in 8 distinct 16-byte
// bank groups.
__host__ __device__ inline size_t smem_bf16(int dp, int DO) {
  return sizeof(bf16) * ((size_t)(BQ + BK) * (dp + 8) + (size_t)BK * (DO + 8));
}

template <int NO>  // 8-column output tiles per block: DO = 8 * NO
__global__ void __launch_bounds__(NT) flash_fwd_bf16(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int DO = 8 * NO;
  const int dp = (p.d + 15) / 16 * 16;
  const int ldq = dp + 8, ldv = DO + 8;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BQ * ldq;
  bf16* Vs = Ks + BK * ldq;

  const Block blk = block_of<bf16>(p);
  const bf16* qb = static_cast<const bf16*>(blk.q);
  const bf16* kb = static_cast<const bf16*>(blk.k);
  const bf16* vb = static_cast<const bf16*>(blk.v) + blk.o0;
  const bool vec = p.vec;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = blk.q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8

  load_rows_bf16<NT>(Qs, ldq, qb, p.q_rstride, blk.q0, p.Sq, p.d, dp, BQ, vec);

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};

  const int nkt = key_tiles(p, blk.q0);
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K and V
    load_rows_bf16<NT>(Ks, ldq, kb, p.kv_rstride, k0, p.Sk, p.d, dp, BK, vec);
    load_rows_bf16<NT>(Vs, ldv, vb, p.kv_rstride, k0, p.Sk, blk.ow, DO, BK, vec);
    __syncthreads();

    // S (16 x 64 per warp) = Q . K^T
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    for (int kk = 0; kk < dp; kk += 16) {
      uint32_t a[4];
      ldsm_x4(a, Qs + (warp * 16 + lane % 16) * ldq + kk + (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j < 8; j += 2) {  // keys 8j .. 8j + 15
        uint32_t b[4];
        ldsm_x4(b, Ks + (8 * j + lane % 8 + (lane / 16) * 8) * ldq + kk + ((lane / 8) % 2) * 8);
        mma_bf16(s[j], a, b[0], b[1]);
        mma_bf16(s[j + 1], a, b[2], b[3]);
      }
    }

    // mask, then the online-softmax update of rows row0 (i = 0), row0 + 8
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2;
        if (masked(p, row0 + 8 * i, k0 + 8 * j + 2 * t + (e & 1))) s[j][e] = NEG_INF;
        mx[i] = fmaxf(mx[i], s[j][e]);
      }
    }
    float m_new[2], corr[2], sum[2] = {0.f, 0.f};
    bool none[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      m_new[i] = fmaxf(m_run[i], mx[i]);
      none[i] = m_new[i] <= NEG_INF;  // no unmasked key yet
      corr[i] = none[i] ? 1.f : exp2f(m_run[i] - m_new[i]);
      m_run[i] = m_new[i];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2;
        const float pe = none[i] ? 0.f : exp2f(s[j][e] - m_new[i]);
        s[j][e] = pe;
        sum[i] += pe;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l_run[i] = corr[i] * l_run[i] + sum[i];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // O += P . V, P rounded to bf16 straight from S's accumulators
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // keys 16kk .. 16kk + 15
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < NO; n += 2) {  // output columns 8n .. 8n + 15
        uint32_t b[4];
        ldsm_x4_t(b, Vs + (16 * kk + lane % 8 + ((lane / 8) % 2) * 8) * ldv + 8 * n + (lane / 16) * 8);
        mma_bf16(acc[n], a, b[0], b[1]);
        mma_bf16(acc[n + 1], a, b[2], b[3]);
      }
    }
  }

  bf16* ob = static_cast<bf16*>(blk.o) + blk.o0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= p.Sq) continue;
    const float inv = 1.f / (l_run[i] == 0.f ? 1.f : l_run[i]);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * n + 2 * t + e;
        if (col < blk.ow)
          ob[(long long)row * p.q_rstride + col] = __float2bfloat16(acc[n][2 * i + e] * inv);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: exact fp32 FMA loops through shared memory
// ---------------------------------------------------------------------------

constexpr int DC = 64;  // d chunk of the Q.K^T sum

// Shared-memory layout, computed identically on host and device.
struct LayoutF32 {
  int ld_in, ld_v, ld_s, ld_o;
  size_t off_q, off_k, off_v, off_s, off_o, off_m, off_l, off_c, total;
  __host__ __device__ explicit LayoutF32(int DO) {
    ld_in = DC + 1;
    ld_v = DO + 1;
    ld_s = (DO > BK ? DO : BK) + 4;
    ld_o = DO + 4;
    size_t o = 0;
    off_q = o; o += align128(sizeof(float) * BQ * ld_in);
    off_k = o; o += align128(sizeof(float) * BK * ld_in);
    off_v = o; o += align128(sizeof(float) * BK * ld_v);
    off_s = o; o += align128(sizeof(float) * BQ * ld_s);
    off_o = o; o += align128(sizeof(float) * BQ * ld_o);
    off_m = o; o += align128(sizeof(float) * BQ);
    off_l = o; o += align128(sizeof(float) * BQ);
    off_c = o; o += align128(sizeof(float) * BQ);
    total = o;
  }
};

// dst[r][c] = src[(r0 + r) * rstride + c0 + c] for r < rows, c < w;
// zero where the row is past nrows or the column past w.
__device__ void load_tile_f32(float* dst, int ld, const float* src, long long rstride,
                              int r0, int nrows, int c0, int w, int wp, int rows) {
  for (int i = threadIdx.x; i < rows * wp; i += NT) {
    const int r = i / wp, c = i - (i / wp) * wp;
    float val = 0.f;
    if (r0 + r < nrows && c < w) val = src[(long long)(r0 + r) * rstride + c0 + c];
    dst[r * ld + c] = val;
  }
}

__global__ void __launch_bounds__(NT) flash_fwd_f32(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const LayoutF32 L(p.DO);
  float* Qs = reinterpret_cast<float*>(smem + L.off_q);
  float* Ks = reinterpret_cast<float*>(smem + L.off_k);
  float* Vs = reinterpret_cast<float*>(smem + L.off_v);
  float* Ss = reinterpret_cast<float*>(smem + L.off_s);
  float* Os = reinterpret_cast<float*>(smem + L.off_o);
  float* m_s = reinterpret_cast<float*>(smem + L.off_m);
  float* l_s = reinterpret_cast<float*>(smem + L.off_l);
  float* c_s = reinterpret_cast<float*>(smem + L.off_c);

  const int tid = threadIdx.x;
  const int DO = p.DO;
  const Block blk = block_of<float>(p);
  const float* qb = static_cast<const float*>(blk.q);
  const float* kb = static_cast<const float*>(blk.k);
  const float* vb = static_cast<const float*>(blk.v);

  for (int i = tid; i < BQ * DO; i += NT) Os[(i / DO) * L.ld_o + i % DO] = 0.f;
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  const int nkt = key_tiles(p, blk.q0);
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    // S = Q . K^T, summed over d in DC-wide chunks
    for (int dc = 0; dc < p.d; dc += DC) {
      const int w = min(DC, p.d - dc);
      __syncthreads();
      load_tile_f32(Qs, L.ld_in, qb, p.q_rstride, blk.q0, p.Sq, dc, w, w, BQ);
      load_tile_f32(Ks, L.ld_in, kb, p.kv_rstride, k0, p.Sk, dc, w, w, BK);
      __syncthreads();
      for (int i = tid; i < BQ * BK; i += NT) {
        const int r = i / BK, c = i % BK;
        const float* a = Qs + r * L.ld_in;
        const float* b = Ks + c * L.ld_in;
        float s = dc > 0 ? Ss[r * L.ld_s + c] : 0.f;
        for (int k = 0; k < w; ++k) s = fmaf(a[k], b[k], s);
        Ss[r * L.ld_s + c] = s;
      }
    }
    __syncthreads();
    // online softmax update, one thread per query row
    if (tid < BQ) {
      const int row = blk.q0 + tid;
      float* srow = Ss + tid * L.ld_s;
      float mx = NEG_INF;
      for (int c = 0; c < BK; ++c) {
        const float s = masked(p, row, k0 + c) ? NEG_INF : srow[c];
        srow[c] = s;
        mx = fmaxf(mx, s);
      }
      const float m_prev = m_s[tid];
      const float m_new = fmaxf(m_prev, mx);
      const bool none = m_new <= NEG_INF;  // no unmasked key yet
      float sum = 0.f;
      for (int c = 0; c < BK; ++c) {
        const float e = none ? 0.f : exp2f(srow[c] - m_new);
        sum += e;
        srow[c] = e;
      }
      const float corr = none ? 1.f : exp2f(m_prev - m_new);
      l_s[tid] = corr * l_s[tid] + sum;
      m_s[tid] = m_new;
      c_s[tid] = corr;
    }
    load_tile_f32(Vs, L.ld_v, vb, p.kv_rstride, k0, p.Sk, blk.o0, blk.ow, DO, BK);
    __syncthreads();
    // O = O * corr + P . V
    for (int i = tid; i < BQ * DO; i += NT) {
      const int r = i / DO, c = i % DO;
      const float* a = Ss + r * L.ld_s;
      float s = 0.f;
      for (int k = 0; k < BK; ++k) s = fmaf(a[k], Vs[k * L.ld_v + c], s);
      Os[r * L.ld_o + c] = Os[r * L.ld_o + c] * c_s[r] + s;
    }
  }
  __syncthreads();
  float* ob = static_cast<float*>(blk.o);
  for (int i = tid; i < BQ * DO; i += NT) {
    const int r = i / DO, c = i % DO;
    const int row = blk.q0 + r;
    if (row < p.Sq && c < blk.ow) {
      float l = l_s[r];
      l = (l == 0.f) ? 1.f : l;
      ob[(long long)row * p.q_rstride + blk.o0 + c] = Os[r * L.ld_o + c] / l;
    }
  }
}

// ---------------------------------------------------------------------------

template <typename K>
int run(K kernel, const Params& p, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H * p.n_out, p.B);
  kernel<<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int NO>
int run_bf16(const Params& p, cudaStream_t stream) {
  const int dp = (p.d + 15) / 16 * 16;
  return run(flash_fwd_bf16<NO>, p, smem_bf16(dp, 8 * NO), stream);
}

int dispatch(int dtype, Params p, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.Sq == 0 || p.B == 0) return cudaSuccess;
  const int dp = (p.d + 15) / 16 * 16;
  p.DO = dp <= 128 ? dp : 128;
  p.n_out = (dp + p.DO - 1) / p.DO;
  if (dtype == kFloat32) return run(flash_fwd_f32, p, LayoutF32(p.DO).total, st);
  if (dtype != kBFloat16) return cudaErrorInvalidValue;
  p.vec = p.d % 8 == 0 && p.q_rstride % 8 == 0 && p.kv_rstride % 8 == 0 &&
          aligned16(p.q) && aligned16(p.k) && aligned16(p.v);
  switch (p.DO / 8) {
    case 2: return run_bf16<2>(p, st);
    case 4: return run_bf16<4>(p, st);
    case 6: return run_bf16<6>(p, st);
    case 8: return run_bf16<8>(p, st);
    case 10: return run_bf16<10>(p, st);
    case 12: return run_bf16<12>(p, st);
    case 14: return run_bf16<14>(p, st);
    default: return run_bf16<16>(p, st);
  }
}

}  // namespace
}  // namespace tf

// q (B, Sq, H*d), k/v (B, Sk, H*d), o like q; all contiguous.
extern "C" int tf_flash_packed(int dtype, const void* q, const void* k,
                               const void* v, void* o, int B, int Sq, int Sk,
                               int sk_real, int H, int d, void* stream) {
  tf::Params p{};
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.B = B; p.H = H; p.Sq = Sq; p.Sk = Sk; p.sk_real = sk_real; p.d = d;
  p.causal = 0;
  p.q_rstride = (long long)H * d;
  p.q_bstride = (long long)Sq * H * d;
  p.kv_rstride = (long long)H * d;
  p.kv_bstride = (long long)Sk * H * d;
  return tf::dispatch(dtype, p, stream);
}

// q (N, Sq, d), k/v (N, Sk, d), o like q; all contiguous.
extern "C" int tf_flash_bhsd(int dtype, const void* q, const void* k,
                             const void* v, void* o, int N, int Sq, int Sk,
                             int sk_real, int d, int causal, void* stream) {
  tf::Params p{};
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.B = N; p.H = 1; p.Sq = Sq; p.Sk = Sk; p.sk_real = sk_real; p.d = d;
  p.causal = causal;
  p.q_rstride = d;
  p.q_bstride = (long long)Sq * d;
  p.kv_rstride = d;
  p.kv_bstride = (long long)Sk * d;
  return tf::dispatch(dtype, p, stream);
}
