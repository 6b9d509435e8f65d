// Flash attention forward for Hopper (sm_90a) behind one C entry point,
// tf_flash, in three variants (kernels/flash_attention.py::_plan picks one
// by a shape rule and passes its code):
//
//   wgmma       bf16, head width d <= 128 (every UNet and MMDiT call)
//   wgmma_wide  bf16, 128 < d <= 512 (the VAE's single d = 512 head)
//   fma         fp32, any d (exact fp32 for the comparisons; not on a
//               main path)
//
// Replaces tinyfusers_tpu/kernels/flash_attention.py:
//   _kernel_packed, _kernel_packed_multik -> the heads-packed (B, S, H*d)
//       calls (flash_packed): any key length, kv_len, so SD1.5's UNet and
//       SD3's joint attention, (2, 4224, 24 x 64) with kv_len 4173, take
//       the same kernel;
//   _kernel -> the (N, S, d) calls (flash_bhsd, causal, kv_len), read as
//       the packed layout with one head.
// and computes what they compute: q is prescaled by scale*log2(e) and
// rounded in q's dtype (here, in shared memory: q * f in fp32, rounded to
// bf16, as torch computes the wrapper's plain `q * f`), logits are fp32,
// softmax runs in base 2 (exp2) with fp32 statistics, P is rounded to v's
// dtype before the P.V product, key columns >= sk_real (and, when causal,
// above the diagonal) are masked with -1e30, and a row with no unmasked
// key gives 0.
//
// What bounds it on an H100: tensor-core operations and, at d = 40 and 64,
// the exp2 unit (one exp per logit against 4d multiply-adds) at every
// self- and joint-attention shape of the main paths (SD1.5 64^2: 4096 x
// 4096 x 40 per head; SD3: 4224 x 4173 x 64 per head, 24 heads; the VAE:
// 4096^2 or 16384^2 x 512); the bytes of q and o at the 77-key
// cross-attention shapes. The bf16 design, in FlashAttention-3's shape:
//   * TMA reads q, k and v in place: each is described to the copy engine
//     as a 4-D map (d, H, S, B) with byte strides 2d, 2Hd and 2SHd, and
//     boxes of 64 head columns by 32 to 128 rows, 128-byte swizzled. The
//     engine fills what lies outside the map with zeros, so a box past
//     d = 40 or 80 gets zero columns (never the next head's), a key tile
//     past Sk = 77 zero rows (never the next batch's), and no head is
//     transposed or padded in device memory;
//   * one producer thread keeps K and V tiles in flight in two rings of
//     stages (full and empty mbarriers each, so a K tile is refilled as
//     soon as Q.K^T has read it); its warpgroup gives registers to the
//     consumers (setmaxnreg);
//   * consumer warpgroups run S = Q.K^T as wgmma from shared memory, keep
//     the online softmax in registers (m, l per row), re-pack S's fp32
//     accumulator as P's bf16 A fragments in registers and run O += P.V
//     as wgmma with V read transposed from shared memory. Each step issues
//     S of key tile j, then P.V of tile j - 1, and runs tile j's softmax
//     while the tensor cores work on that P.V;
//   * wgmma: each consumer warpgroup owns 64 query rows, and a block takes
//     128-key tiles and 192 rows at d <= 64 (three warpgroups, so one's
//     softmax hides under another's products), 128 rows at d <= 128;
//   * wgmma_wide: the 64 x 512 fp32 accumulator of one query tile does not
//     fit one warpgroup's registers, so two warpgroups share the 64 rows:
//     each owns half of d, computes the partial S over its half, and the
//     two add their partials through shared memory, so Q.K^T is computed
//     once per key tile; both then run the same softmax and multiply P by
//     their own half of V. 32-key tiles keep Q (64 KB) and two stages of
//     K and V (32 KB each) in shared memory.
#include <stdint.h>

#include "hopper.cuh"

namespace tf {
namespace {

constexpr float NEG_INF = -1e30f;

// Variant codes, as kernels/flash_attention.py::_VARIANTS numbers them.
constexpr int kFma = 0;
constexpr int kWgmma = 1;
constexpr int kWgmmaWide = 2;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, Sq, Sk, sk_real, d, causal;
  float qscale;      // bf16 (or fp32) value of scale * log2(e)
  long long rstride;  // elements between rows of q, k, v and o: H*d
  int DO;     // fma: output columns per block (<= 128)
  int n_out;  // fma: output column chunks per head
};

// Key tiles a block of query rows q0 .. q0 + bq - 1 visits: later tiles are
// past kv_len, or all above the causal diagonal.
__device__ __forceinline__ int key_tiles(const Params& p, int q0, int bq, int bk) {
  int kend = p.sk_real;
  if (p.causal) kend = min(kend, q0 + bq);
  return (kend + bk - 1) / bk;
}

__device__ __forceinline__ bool masked(const Params& p, int row, int col) {
  return col >= p.sk_real || (p.causal && col > row);
}

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma, warp-specialized (variants wgmma and wgmma_wide)
// ---------------------------------------------------------------------------

// 2^x in one MUFU op; flushes results below 2^-126 to 0 (a P that small
// is lost in the row sum anyway).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// NR consumer row groups of 64 query rows; NCG consumer warpgroups share a
// row group, each owning DW of the padded head's columns (for both Q.K^T
// and P.V); BK keys per tile; ST stages in each of the K and V rings.
template <int NR_, int NCG_, int DW_, int BK_, int ST_>
struct Cfg {
  static constexpr int NR = NR_, NCG = NCG_, DW = DW_, BK = BK_, ST = ST_;
  static_assert(NCG == 1 || (NCG == 2 && NR == 1), "two column groups: one row group");
  static_assert(DW % 64 == 0 && (BK == 32 || BK == 128), "tile shapes (wgmma_ss's widths)");
  static constexpr int NCONS = NR * NCG;  // consumer warpgroups
  static_assert(NCONS == 2 || NCONS == 3, "two or three consumer warpgroups");
  static constexpr int THREADS = 128 * (NCONS + 1);
  // Registers per thread after setmaxnreg: the consumers take what the
  // producer warpgroup gives up, so the two must fit the block's allocation
  // at launch, THREADS x LAUNCH.
  static constexpr int LAUNCH = (65536 / THREADS) / 8 * 8;
  static constexpr int PROD_REGS = NCONS == 2 ? 24 : 32;
  static constexpr int CONS_REGS = NCONS == 2 ? 240 : 160;
  static_assert(128 * PROD_REGS + NCONS * 128 * CONS_REGS <= THREADS * LAUNCH,
                "setmaxnreg asks for more registers than the block holds");
  static constexpr int BQ = 64 * NR;
  static constexpr int NB = NCG * DW / 64;  // 64-column boxes across the head
  static constexpr int QBOX = 64 * 128;     // bytes of a 64-row box
  static constexpr int KVBOX = BK * 128;    // bytes of a BK-row box
  static constexpr int TILE = NB * KVBOX;   // one K (or V) tile
  static constexpr int XS = 64 * BK * 4;    // one partial S, fp32
  static constexpr int OFF_K = NR * NB * QBOX;
  static constexpr int OFF_V = OFF_K + ST * TILE;
  static constexpr int OFF_X = OFF_V + ST * TILE;
  static constexpr int OFF_BAR = OFF_X + (NCG > 1 ? NCONS * 2 * XS : 0);
  // + 1024 so the base can be rounded up to the swizzle's 1024-byte period
  static constexpr int SMEM = OFF_BAR + 8 * (4 * ST + 1) + 1024;
  static_assert(SMEM <= 232448, "shared memory");
};

// The online-softmax update of one S tile in place (rows row0 and row0 + 8
// of this thread; sc[4j + e] is row row0 + 8 (e / 2), key k0 + 8j + 2 tq4 +
// e % 2): masks, updates the running max and sum, leaves P = 2^(S - m) in
// sc and the factor the earlier output must be scaled by in corr.
template <int NJ>
__device__ __forceinline__ void softmax_tile(float (&sc)[NJ * 4], float (&m_run)[2],
                                             float (&l_run)[2], float (&corr)[2],
                                             const Params& p, bool edge, int row0, int k0,
                                             int tq4) {
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e / 2;
      if (edge && masked(p, row0 + 8 * i, k0 + 8 * j + 2 * tq4 + (e & 1)))
        sc[4 * j + e] = NEG_INF;
      mx[i] = fmaxf(mx[i], sc[4 * j + e]);
    }
  }
  float m_new[2], sum[2] = {0.f, 0.f};
  bool none[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    m_new[i] = fmaxf(m_run[i], mx[i]);
    none[i] = m_new[i] <= NEG_INF;  // no unmasked key yet
    corr[i] = none[i] ? 1.f : ex2(m_run[i] - m_new[i]);
    m_run[i] = m_new[i];
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e / 2;
      const float pe = none[i] ? 0.f : ex2(sc[4 * j + e] - m_new[i]);
      sc[4 * j + e] = pe;
      sum[i] += pe;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
    l_run[i] = corr[i] * l_run[i] + sum[i];
  }
}

template <class C>
__global__ void __launch_bounds__(C::THREADS, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const Params p) {
  constexpr int NR = C::NR, NCG = C::NCG, DW = C::DW, BK = C::BK, ST = C::ST;
  constexpr int NJ = BK / 8;   // 8-key column blocks of S
  constexpr int NO = DW / 64;  // 64-column blocks of this warpgroup's O
  constexpr int NP = BK / 16;  // 16-key steps of P.V
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  // full / empty barriers of the K ring, then of the V ring, then Q's
  uint64_t* full_k = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* empty_k = full_k + ST;
  uint64_t* full_v = empty_k + ST;
  uint64_t* empty_v = full_v + ST;
  uint64_t* qbar = empty_v + ST;

  const int q0 = blockIdx.x * C::BQ, h = blockIdx.y, b = blockIdx.z;
  const int nkt = key_tiles(p, q0, C::BQ, BK);
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], C::NCONS * 4);  // one arrival per consumer warp
      mbar_init(&empty_v[s], C::NCONS * 4);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == C::NCONS) {
    // producer warpgroup: one thread issues every copy, K(kt) ahead of V(kt)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(C::PROD_REGS));
    if (threadIdx.x == C::NCONS * 128) {
      mbar_expect_tx(qbar, NR * C::NB * C::QBOX);
      for (int r = 0; r < NR; ++r)
        for (int c = 0; c < C::NB; ++c)
          tma_load(smem + (r * C::NB + c) * C::QBOX, &tq, qbar, 64 * c, h, q0 + 64 * r, b);
      for (int kt = 0; kt < nkt; ++kt) {
        const int s = kt % ST, free = ((kt / ST) & 1) ^ 1;  // the first round passes
        mbar_wait(&empty_k[s], free);
        mbar_expect_tx(&full_k[s], C::TILE);
        for (int c = 0; c < C::NB; ++c)
          tma_load(smem + C::OFF_K + s * C::TILE + c * C::KVBOX, &tk, &full_k[s], 64 * c, h,
                   kt * BK, b);
        mbar_wait(&empty_v[s], free);
        mbar_expect_tx(&full_v[s], C::TILE);
        for (int c = 0; c < C::NB; ++c)
          tma_load(smem + C::OFF_V + s * C::TILE + c * C::KVBOX, &tv, &full_v[s], 64 * c, h,
                   kt * BK, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(C::CONS_REGS));
    const int r = wg / NCG, cg = wg % NCG;
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int g = lane / 4, tq4 = lane % 4;
    const int rq0 = q0 + 64 * r;           // this warpgroup's first row
    const int row0 = rq0 + 16 * warp + g;  // this thread's rows: row0, row0 + 8
    unsigned char* qs = smem + (r * C::NB + cg * NO) * C::QBOX;
    // k16 steps of Q.K^T over this warpgroup's columns that hold real d
    const int dk = min(DW, max(0, (p.d + 15) / 16 * 16 - cg * DW)) / 16;

    // Q arrives, then is prescaled in place: q * f in fp32, rounded to bf16.
    mbar_wait(qbar, 0);
    {
      uint4* q4 = reinterpret_cast<uint4*>(qs);
      for (int i = t; i < NO * C::QBOX / 16; i += 128) {
        uint4 v = q4[i];
        __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(e[j]);
          e[j] = __floats2bfloat162_rn(f.x * p.qscale, f.y * p.qscale);
        }
        q4[i] = v;
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma
      bar_sync(1 + wg, 128);
    }

    float o[NO][32];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[n][i] = 0.f;
    float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f}, corr[2];
    float sc[NJ * 4];
    uint32_t pa[NP * 4];  // P of the previous tile, as P.V's A fragments

    // Tile kt: S(kt) = Q.K^T is issued, then P.V of tile kt - 1, so the
    // softmax of S(kt) runs while the tensor cores multiply P(kt - 1) by V.
    for (int kt = 0; kt <= nkt; ++kt) {
      const int s = kt % ST, sp = (kt + ST - 1) % ST;
      const bool has_s = kt < nkt, has_pv = kt > 0;
      if (has_s) mbar_wait(&full_k[s], (kt / ST) & 1);
      if (has_pv) mbar_wait(&full_v[sp], ((kt - 1) / ST) & 1);
#pragma unroll
      for (int i = 0; i < NJ * 4; ++i) sc[i] = 0.f;
      fence_regs(sc);
      fence_regs(pa);
#pragma unroll
      for (int n = 0; n < NO; ++n) fence_regs(o[n]);
      wg_fence();
      if (has_s) {
        const unsigned char* ks = smem + C::OFF_K + s * C::TILE + cg * NO * C::KVBOX;
        for (int kk = 0; kk < dk; ++kk)
          wgmma_ss(sc, sw128_desc(qs + (kk / 4) * C::QBOX + (kk % 4) * 32),
                   sw128_desc(ks + (kk / 4) * C::KVBOX + (kk % 4) * 32));
      }
      wg_commit();
      if (has_pv) {
        const unsigned char* vs = smem + C::OFF_V + sp * C::TILE + cg * NO * C::KVBOX;
#pragma unroll
        for (int kk = 0; kk < NP; ++kk)
#pragma unroll
          for (int n = 0; n < NO; ++n)
            wgmma_rs_t(o[n], pa + 4 * kk, sw128_desc(vs + n * C::KVBOX + kk * 2048));
      }
      wg_commit();
      wg_wait1();  // S(kt) is done; P.V may still run
      fence_regs(sc);
      if (has_s) {
        if (lane == 0) mbar_arrive(&empty_k[s]);  // this warp is done with K(kt)
        if constexpr (NCG > 1) {
          // add the partner's partial S: both then hold the same sums
          float* x = reinterpret_cast<float*>(smem + C::OFF_X);
          float* mine = x + (wg * 2 + (kt & 1)) * (C::XS / 4);
          const float* other = x + ((r * NCG + (cg ^ 1)) * 2 + (kt & 1)) * (C::XS / 4);
#pragma unroll
          for (int i = 0; i < NJ * 4; ++i) mine[i * 128 + t] = sc[i];
          bar_sync(1 + C::NCONS + r, 128 * NCG);  // double-buffered: one barrier a tile
#pragma unroll
          for (int i = 0; i < NJ * 4; ++i) sc[i] += other[i * 128 + t];
        }
        const int k0 = kt * BK;
        const bool edge = k0 + BK > p.sk_real || (p.causal && k0 + BK - 1 > rq0);
        softmax_tile<NJ>(sc, m_run, l_run, corr, p, edge, row0, k0, tq4);
      }
      wg_wait0();
#pragma unroll
      for (int n = 0; n < NO; ++n) fence_regs(o[n]);
      fence_regs(pa);
      if (has_pv && lane == 0) mbar_arrive(&empty_v[sp]);  // done with V(kt - 1)
      if (has_s) {
#pragma unroll
        for (int n = 0; n < NO; ++n)
#pragma unroll
          for (int i = 0; i < 32; ++i) o[n][i] *= corr[(i / 2) % 2];
        // P rounded to bf16 straight from S's accumulator: the A fragments
        // of each 16-key step (rows row0 / row0 + 8, keys 2 tq4 and
        // 2 tq4 + 8 of the step)
#pragma unroll
        for (int kk = 0; kk < NP; ++kk) {
          pa[4 * kk + 0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
          pa[4 * kk + 1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
          pa[4 * kk + 2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
          pa[4 * kk + 3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
        }
      }
    }

    bf16* ob = static_cast<bf16*>(p.o) + (long long)b * p.Sq * p.rstride + (long long)h * p.d;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row >= p.Sq) continue;
      const float inv = 1.f / (l_run[i] == 0.f ? 1.f : l_run[i]);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = cg * DW + 64 * n + 8 * j + 2 * tq4;  // d is even: both or neither
          if (col < p.d)
            *reinterpret_cast<uint32_t*>(ob + (long long)row * p.rstride + col) =
                pack_bf16(o[n][4 * j + 2 * i] * inv, o[n][4 * j + 2 * i + 1] * inv);
        }
      }
    }
  }
}

// The (B, S, H*d) bf16 tensor at `base` as a 4-D map (d, H, S, B), boxes of
// 64 columns of one head by `rows` rows, 128-byte swizzled; zeros outside.
int encode(CUtensorMap* map, const void* base, const Params& p, int S, int rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)p.d, (cuuint64_t)p.H, (cuuint64_t)S, (cuuint64_t)p.B};
  const cuuint64_t strides[3] = {2ull * p.d, 2ull * p.H * p.d, 2ull * S * p.H * p.d};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <class C>
int run_wgmma(const Params& p, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = encode(&tq, p.q, p, p.Sq, 64);
  if (err == cudaSuccess) err = encode(&tk, p.k, p, p.Sk, C::BK);
  if (err == cudaSuccess) err = encode(&tv, p.v, p, p.Sk, C::BK);
  if (err != cudaSuccess) return err;
  auto kernel = flash_fwd_wgmma<C>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + C::BQ - 1) / C::BQ, p.H, p.B);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

// Calls f(Cfg<...>{}) with the configuration that bf16 variant `variant`
// runs for head width d (a multiple of 8); cudaErrorInvalidValue for a
// width the variant does not take.
template <typename F>
int with_config(int variant, int d, F&& f) {
  if (variant == kWgmma && d <= 64) return f(Cfg<3, 1, 64, 128, 2>{});
  if (variant == kWgmma && d > 64 && d <= 128) return f(Cfg<2, 1, 128, 128, 2>{});
  if (variant == kWgmmaWide && d > 128 && d <= 256) return f(Cfg<1, 2, 128, 32, 2>{});
  if (variant == kWgmmaWide && d > 256 && d <= 512) return f(Cfg<1, 2, 256, 32, 2>{});
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// fp32: exact fp32 FMA loops through shared memory
// ---------------------------------------------------------------------------

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per tile
constexpr int NT = 128;  // threads per block
constexpr int DC = 64;   // d chunk of the Q.K^T sum

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

// dst[r][c] = src[(r0 + r) * rstride + c0 + c] * mul for r < rows, c < w;
// zero where the row is past nrows or the column past w.
__device__ void load_tile_f32(float* dst, int ld, const float* src, long long rstride,
                              int r0, int nrows, int c0, int w, int wp, int rows,
                              float mul) {
  for (int i = threadIdx.x; i < rows * wp; i += NT) {
    const int r = i / wp, c = i - (i / wp) * wp;
    float val = 0.f;
    if (r0 + r < nrows && c < w) val = src[(long long)(r0 + r) * rstride + c0 + c] * mul;
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
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y / p.n_out;
  const int o0 = (blockIdx.y % p.n_out) * DO;
  const int ow = min(DO, p.d - o0);  // real output columns of this block
  const long long hoff = (long long)h * p.d;
  const int b = blockIdx.z;
  const float* qb = static_cast<const float*>(p.q) + (long long)b * p.Sq * p.rstride + hoff;
  const float* kb = static_cast<const float*>(p.k) + (long long)b * p.Sk * p.rstride + hoff;
  const float* vb = static_cast<const float*>(p.v) + (long long)b * p.Sk * p.rstride + hoff;

  for (int i = tid; i < BQ * DO; i += NT) Os[(i / DO) * L.ld_o + i % DO] = 0.f;
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  const int nkt = key_tiles(p, q0, BQ, BK);
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    // S = Q . K^T, summed over d in DC-wide chunks; q prescaled as it loads
    for (int dc = 0; dc < p.d; dc += DC) {
      const int w = min(DC, p.d - dc);
      __syncthreads();
      load_tile_f32(Qs, L.ld_in, qb, p.rstride, q0, p.Sq, dc, w, w, BQ, p.qscale);
      load_tile_f32(Ks, L.ld_in, kb, p.rstride, k0, p.Sk, dc, w, w, BK, 1.f);
      __syncthreads();
      for (int i = tid; i < BQ * BK; i += NT) {
        const int r = i / BK, c = i % BK;
        const float* a = Qs + r * L.ld_in;
        const float* bk = Ks + c * L.ld_in;
        float s = dc > 0 ? Ss[r * L.ld_s + c] : 0.f;
        for (int k = 0; k < w; ++k) s = fmaf(a[k], bk[k], s);
        Ss[r * L.ld_s + c] = s;
      }
    }
    __syncthreads();
    // online softmax update, one thread per query row
    if (tid < BQ) {
      const int row = q0 + tid;
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
    load_tile_f32(Vs, L.ld_v, vb, p.rstride, k0, p.Sk, o0, ow, DO, BK, 1.f);
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
  float* ob = static_cast<float*>(p.o) + (long long)b * p.Sq * p.rstride + hoff;
  for (int i = tid; i < BQ * DO; i += NT) {
    const int r = i / DO, c = i % DO;
    const int row = q0 + r;
    if (row < p.Sq && c < ow) {
      float l = l_s[r];
      l = (l == 0.f) ? 1.f : l;
      ob[(long long)row * p.rstride + o0 + c] = Os[r * L.ld_o + c] / l;
    }
  }
}

int run_f32(Params p, cudaStream_t stream) {
  p.DO = p.d <= 128 ? p.d : 128;
  p.n_out = (p.d + p.DO - 1) / p.DO;
  const size_t smem = LayoutF32(p.DO).total;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H * p.n_out, p.B);
  flash_fwd_f32<<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tf

// q (B, Sq, H*d), k/v (B, Sk, H*d), o like q; all contiguous, 16-byte
// aligned for the bf16 variants (the (N, S, d) layout is H = 1). `variant`
// comes from the wrapper's shape rule; a shape the variant does not take is
// refused.
extern "C" int tf_flash(int variant, const void* q, const void* k, const void* v, void* o,
                        int B, int H, int Sq, int Sk, int sk_real, int d, int causal,
                        float qscale, void* stream) {
  tf::Params p{};
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.B = B; p.H = H; p.Sq = Sq; p.Sk = Sk; p.sk_real = sk_real; p.d = d;
  p.causal = causal;
  p.qscale = qscale;
  p.rstride = (long long)H * d;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Sq == 0 || B == 0 || H == 0) return cudaSuccess;
  if (variant == tf::kFma) return tf::run_f32(p, st);
  if (d % 8 != 0 || !tf::aligned16(q) || !tf::aligned16(k) || !tf::aligned16(v))
    return cudaErrorInvalidValue;
  return tf::with_config(variant, d,
                         [&](auto c) { return tf::run_wgmma<decltype(c)>(p, st); });
}

