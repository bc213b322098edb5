// Flash-attention forward for Hopper (sm_90a), bf16 in / bf16 out, fp32 softmax.
//
// Replaces the TPU Pallas forwards of gligen_tpu/ops/pallas_attention.py:
//   * the single-KV forwards: _packed_fwd_impl's pallas_call at :836 and
//     _fwd_impl's at :428, kernel bodies _fwd_kernel_single :252 and
//     _fwd_kernel_single_chunked :163 -- UNet attn1, the gated
//     self-attention fuser and the 77-token cross-attention;
//   * the streamed forwards: _fwd_impl's pallas_call at :466 and
//     _packed_fwd_impl's at :876, kernel body _fwd_kernel :328 -- the VAE
//     decoder's single 512-wide head, and attn1 at 1024^2.
// Both compute, per (batch, head):
//   out = softmax(scale * q k^T + bias) v,   lse = log2(sum_j exp(scale q.k_j + bias_j))
// The LSE is in LOG2 units, as the TPU kernel stores it; the backward kernels
// (flash_bwd.cu) recompute the probabilities from it.
//
// What bounds it on the H100.  Every shape of the 512^2 path does many
// operations per byte: ds1 attn1 (4 x 8 heads x 4096 queries x 4096 keys x
// d 40) does 86 GFLOP over 42 MB of q/k/v/o, so its bound (timing.bound) is
// the tensor cores', 0.087 ms at 989 TFLOP/s, against 0.013 ms of bytes;
// the VAE head (2 x 4096^2 x 512) is 0.069 ms of operations.  At d = 40 a
// score costs 88 tensor-core multiply-adds but one exp2 on the 16-lane
// special-function unit and a handful of fp32 operations, so the softmax,
// not the products, sets the pace there: the card's exp2 rate alone gives
// ds1 attn1 about 0.15 ms.
//
// The design, per block of BQ = 64 * ROWWG query rows of one (batch, head):
//   * one producer warpgroup and ROWWG * SPLIT consumer warpgroups
//     (warp-specialised; setmaxnreg moves registers to the consumers at run
//     time, though ptxas compiles every class at the launch bound's 168
//     registers, and the d = 512 class spills a few hundred bytes);
//   * the producer loads Q once and K, V tiles of BK keys into a ring of
//     STAGES shared-memory stages, by TMA with mbarriers: each stage has a
//     "full" barrier (TMA bytes arrived) and an "empty" one (every consumer
//     thread done with it).  Tiles are stored 128-byte swizzled in 64-column
//     atoms, the layout wgmma reads; the tensor maps are 4-D (head dim, head,
//     row, batch) with the head dim's extent d, so TMA zero-fills the padded
//     columns d..63 and the rows past N or M, exactly;
//   * each consumer warpgroup owns 64 query rows.  S = Q K^T is wgmma
//     m64nBKk16 from shared memory, into registers.  The online softmax
//     (running max, the textbook form; no clamp) runs in registers, a row
//     spread over the 4 threads of a quad: two shuffles per reduction.  P is
//     converted to bf16 in registers and is the A operand of O += P V
//     (wgmma, A from registers, V from shared memory, MN-major).  O stays in
//     registers in fp32 for the whole key loop and is normalised once, at
//     the end.  Nothing of S, P or O passes through shared memory.
//   * head-dim classes, each a template: d <= 40 (QK depth 48, PV N 40),
//     <= 80 (80, 80), <= 160 (160, 160) and <= 512.  At d = 512 a 64 x 512
//     fp32 O is 256 registers a thread, too many for one warpgroup, so two
//     consumer warpgroups split O's columns (256 each) over the same 64
//     rows; each computes the whole S itself (SPLIT = 2).  That costs 50%
//     more tensor-core work at the one such launch of a request, and keeps
//     one code path: no S or P exchange, no barrier between warpgroups, and
//     both read the same K/V stage.  Q (64 KB) and two stages of 32 keys
//     (64 KB each) fill 192 KB.
//   * ragged edges in the kernel: keys at or past M are set to -inf after
//     the product (TMA's zero fill gives s = 0); query rows past N are not
//     stored and get no LSE.  The optional fp32 (B, M) bias row is read per
//     key tile from global memory (natural-log units).
//   * inputs TMA cannot take (a base not 16-byte aligned, a row or batch
//     stride not a multiple of 8 elements, d not a multiple of 8) take the
//     copy route: the producer warpgroup fills the same swizzled stages with
//     plain loads, orders them for the tensor cores with a proxy fence, and
//     arrives on the same barriers.  The wrapper chooses the route from the
//     shape (ops/flash_attention.py:tma_ok) and counts launches per route.
//
// fp32 q/k/v (flash_fwd_f32, below): the inpaint image's fp32 VAE encode
// runs its mid-attention (B, 4096, 1 x 512) in fp32, as the TPU kernel
// computes it (pallas_attention.py:328-380, q/k/v cast to fp32).  TF32
// wgmma would not be fp32, so this route is a plain CUDA-core kernel: a
// block of 256 threads owns 32 query rows, 4 a warp, held in registers
// (each lane 16 columns of the 4 rows, as it holds O); K and V tiles of 32
// keys stream through shared memory by cp.async (V's copy runs under
// S = Q K^T, the next K's under P V).  Each lane sums its columns' share of
// the 4 x 8 scores of 8 keys and a reduce-scatter over the warp leaves the
// lane one whole score; the online softmax runs in registers, a row over 8
// lanes.  Its bound is the fp32 FMA rate: 4 B N M d operations, 68.7 GFLOP
// at (2, 4096, 512), 1.0 ms at 67 TFLOP/s.  Every warp reads every K and V
// row of a tile from shared memory for 4 rows' FMAs, 1 byte an FMA: shared
// memory's 128 bytes a cycle match the SM's 128 FMAs, so the two limits
// meet at this tile (more rows a warp would not fit the registers).
//
// The tile configuration per class comes from the wrapper's fixed table
// (ops/flash_attention.py:FWD_TILES), which this library is built at
// (dispatch below); flash_fwd_sweep.cu builds the d <= 40 class at every
// (BQ, BK, stages) of tools/bench_sweep_attn.py.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "hopper.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kMaxD = 512;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kMaxThreads = 384;

struct Params {
  CUtensorMap tq, tk, tv;  // TMA route: (d, head, row, batch) maps, 64-column swizzled boxes
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const float* bias;  // (B, M) rows at stride bias_sb, or null
  bf16* o;
  float* lse;  // (B, H, N) contiguous
  int heads, n, m, d;
  long long q_sb, q_sh, q_sn;
  long long k_sb, k_sh, k_sn;
  long long v_sb, v_sh, v_sn;
  long long o_sb, o_sh, o_sn;
  long long bias_sb;
  float scale_log2;  // softmax scale * log2(e)
  int tma;           // 1: Q/K/V by TMA; 0: plain copies by the producer
  int o_pairs;       // 1: O rows and columns allow bf16x2 stores
};

// DK: QK depth (d padded to 16); NV: PV width of one consumer warpgroup;
// ATOMS: 64-column swizzle atoms per tile row; SPLIT: warpgroups splitting
// O's columns; ROWWG: warpgroups owning distinct 64-row slabs.
template <int DK_, int NV_, int ATOMS_, int SPLIT_, int ROWWG_, int BK_, int STAGES_>
struct Cfg {
  static constexpr int DK = DK_, NV = NV_, ATOMS = ATOMS_, SPLIT = SPLIT_, ROWWG = ROWWG_;
  static constexpr int BQ = 64 * ROWWG, BK = BK_, STAGES = STAGES_;
  static constexpr int kConsumers = ROWWG * SPLIT;
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kQBytes = ATOMS * BQ * 128;
  static constexpr int kKvBytes = ATOMS * BK * 128;  // one of K or V, one stage
  static constexpr int kBarOffset = kQBytes + 2 * STAGES * kKvBytes;
  static constexpr int kSmem = kBarOffset + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack
  static_assert(DK % 16 == 0 && DK <= ATOMS * 64, "QK depth");
  static_assert(NV % 8 == 0 && NV * SPLIT <= ATOMS * 64, "PV width");
  static_assert(BK % 16 == 0 && BK <= 256 && BQ <= 256, "TMA box rows");
  static_assert(kThreads <= kMaxThreads, "threads");
  static_assert(kSmem <= 232448, "shared memory");
};

// ------------------------------------------------------------ the softmax

// One key tile of the online softmax on a warpgroup's S fragment: mask
// keys >= m (MASK: the last tile), add the bias (BIAS), update the running
// max (log2 units) and the thread-partial sum, rescale O, and leave P in s.
// Without a bias the max is taken on the raw products and the scale is
// folded into the exponent's FMA (scale > 0 keeps the order).
template <int BK, int NV, bool MASK, bool BIAS>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float (&o)[NV / 2],
                                             float (&mrow)[2], float (&lrow)[2],
                                             const float* bias, int k0, int m, float scale,
                                             int quad) {
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = k0 + 8 * j + 2 * quad + e;
      float v0 = s[4 * j + e], v1 = s[4 * j + 2 + e];
      if (BIAS) {
        const float b = (!MASK || col < m) ? bias[col] * kLog2e : 0.0f;
        v0 = fmaf(v0, scale, b);
        v1 = fmaf(v1, scale, b);
      }
      if (MASK && col >= m) v0 = v1 = -INFINITY;
      s[4 * j + e] = v0;
      s[4 * j + 2 + e] = v1;
      mx0 = fmaxf(mx0, v0);
      mx1 = fmaxf(mx1, v1);
    }
  }
  if (!BIAS) {
    mx0 *= scale;
    mx1 *= scale;
  }
  mx0 = fmaxf(mrow[0], quad_max(mx0));
  mx1 = fmaxf(mrow[1], quad_max(mx1));
  // a row whose keys are all masked so far keeps O = 0, l = 0 and gets p = 0
  const float use0 = mx0 == -INFINITY ? 0.0f : mx0, use1 = mx1 == -INFINITY ? 0.0f : mx1;
  const float a0 = ex2(mrow[0] - use0), a1 = ex2(mrow[1] - use1);
  mrow[0] = mx0;
  mrow[1] = mx1;
  float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float p0 = BIAS ? ex2(s[4 * j + e] - use0) : ex2(fmaf(s[4 * j + e], scale, -use0));
      const float p1 =
          BIAS ? ex2(s[4 * j + 2 + e] - use1) : ex2(fmaf(s[4 * j + 2 + e], scale, -use1));
      s[4 * j + e] = p0;
      s[4 * j + 2 + e] = p1;
      sum0 += p0;
      sum1 += p1;
    }
  }
  lrow[0] = lrow[0] * a0 + sum0;
  lrow[1] = lrow[1] * a1 + sum1;
#pragma unroll
  for (int j = 0; j < NV / 8; ++j) {
    o[4 * j] *= a0;
    o[4 * j + 1] *= a0;
    o[4 * j + 2] *= a1;
    o[4 * j + 3] *= a1;
  }
}

// ------------------------------------------------------------ the kernel

template <class C>
__global__ void __launch_bounds__(kMaxThreads, 1) flash_fwd_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = smem;
  uint8_t* sK = smem + C::kQBytes;
  uint8_t* sV = sK + C::STAGES * C::kKvBytes;
  const uint32_t bars = smem_u32(smem + C::kBarOffset);
  const uint32_t q_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + C::STAGES + s); };

  const int q0 = blockIdx.x * C::BQ, h = blockIdx.y, b = blockIdx.z;
  const int ntiles = (p.m + C::BK - 1) / C::BK;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 128 * C::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    // ---------------- producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int tid = threadIdx.x;
    if (p.tma) {
      if (tid == 0) {
        mbar_expect_tx(q_full, C::kQBytes);
        for (int a = 0; a < C::ATOMS; ++a)
          tma_load_4d(smem_u32(sQ + a * C::BQ * 128), &p.tq, q_full, 64 * a, h, q0, b);
        for (int it = 0; it < ntiles; ++it) {
          const int s = it % C::STAGES;
          mbar_wait(empty(s), ((it / C::STAGES) & 1) ^ 1);
          mbar_expect_tx(full(s), 2 * C::kKvBytes);
          for (int a = 0; a < C::ATOMS; ++a) {
            const int off = s * C::kKvBytes + a * C::BK * 128;
            tma_load_4d(smem_u32(sK + off), &p.tk, full(s), 64 * a, h, it * C::BK, b);
            tma_load_4d(smem_u32(sV + off), &p.tv, full(s), 64 * a, h, it * C::BK, b);
          }
        }
      }
    } else {
      copy_tile<C::ATOMS>(sQ, C::BQ, p.q + b * p.q_sb + h * p.q_sh + q0 * p.q_sn, p.q_sn,
                          min(C::BQ, p.n - q0), p.d, tid);
      fence_proxy_async();
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
      if (tid == 0) mbar_arrive(q_full);
      const bf16* kb = p.k + b * p.k_sb + h * p.k_sh;
      const bf16* vb = p.v + b * p.v_sb + h * p.v_sh;
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % C::STAGES, k0 = it * C::BK, valid = min(C::BK, p.m - k0);
        mbar_wait(empty(s), ((it / C::STAGES) & 1) ^ 1);
        copy_tile<C::ATOMS>(sK + s * C::kKvBytes, C::BK, kb + k0 * p.k_sn, p.k_sn, valid, p.d, tid);
        copy_tile<C::ATOMS>(sV + s * C::kKvBytes, C::BK, vb + k0 * p.v_sn, p.v_sn, valid, p.d, tid);
        fence_proxy_async();
        asm volatile("bar.sync 1, 128;\n" ::: "memory");
        if (tid == 0) mbar_arrive(full(s));
      }
    }
  } else {
    // ---------------- consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = warp / 4 - 1;
    const int rs = wg / C::SPLIT, cs = wg % C::SPLIT;
    const int t = threadIdx.x % 128, w = t / 32, lane = t % 32, quad = lane % 4;
    const uint32_t q_base = smem_u32(sQ) + rs * 64 * 128;
    const float* bias = p.bias ? p.bias + b * p.bias_sb : nullptr;

    float o[C::NV / 2];
#pragma unroll
    for (int i = 0; i < C::NV / 2; ++i) o[i] = 0.0f;
    float s[C::BK / 2];
    float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.0f, 0.0f};

    mbar_wait(q_full, 0);
    for (int it = 0; it < ntiles; ++it) {
      const int st = it % C::STAGES, k0 = it * C::BK;
      mbar_wait(full(st), (it / C::STAGES) & 1);
      uint32_t k_base = smem_u32(sK + st * C::kKvBytes);
      uint32_t v_base = smem_u32(sV + st * C::kKvBytes) + cs * 4 * C::BK * 128;
      uint32_t qb = q_base;
      // opaque to the compiler: the descriptors are rebuilt each tile (an
      // add each) instead of being hoisted out of the loop into registers
      asm volatile("" : "+r"(qb), "+r"(k_base), "+r"(v_base));

      // S = Q K^T (both K-major)
      pin(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::DK / 16; ++kk) {
        const uint64_t da = sw128_desc(qb + (kk / 4) * C::BQ * 128 + (kk % 4) * 32, 16, 1024);
        const uint64_t db = sw128_desc(k_base + (kk / 4) * C::BK * 128 + (kk % 4) * 32, 16, 1024);
        Wgmma<C::BK>::template ss<0>(s, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(s);

      const bool last = k0 + C::BK > p.m;
      if (bias) {
        if (last)
          softmax_tile<C::BK, C::NV, true, true>(s, o, mrow, lrow, bias, k0, p.m, p.scale_log2, quad);
        else
          softmax_tile<C::BK, C::NV, false, true>(s, o, mrow, lrow, bias, k0, p.m, p.scale_log2, quad);
      } else {
        if (last)
          softmax_tile<C::BK, C::NV, true, false>(s, o, mrow, lrow, bias, k0, p.m, p.scale_log2, quad);
        else
          softmax_tile<C::BK, C::NV, false, false>(s, o, mrow, lrow, bias, k0, p.m, p.scale_log2, quad);
      }

      // P (bf16) as wgmma's A fragments: key block kk is S's n8 blocks 2kk, 2kk+1
      uint32_t pa[C::BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < C::BK / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }

      // O += P V (V MN-major: 16 keys of 128-byte rows per step)
      pin(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::BK / 16; ++kk) {
        const uint64_t db = sw128_desc(v_base + kk * 16 * 128, C::BK * 128, 1024);
        WgmmaRs<C::NV>::template rs<1>(o, pa[kk], db, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(o);
      mbar_arrive(empty(st));
    }

    // normalise once, store the rows < N, the LSE from the first column part
    const float l0 = quad_sum(lrow[0]), l1 = quad_sum(lrow[1]);
    const int r0 = q0 + rs * 64 + w * 16 + lane / 4, r1 = r0 + 8;
    const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
    bf16* ob = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int j = 0; j < C::NV / 8; ++j) {
      const int col = cs * 256 + 8 * j + 2 * quad;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = half ? r1 : r0;
        const float inv = half ? inv1 : inv0;
        if (r >= p.n || col >= p.d) continue;
        const float x0 = o[4 * j + 2 * half] * inv, x1 = o[4 * j + 2 * half + 1] * inv;
        bf16* dst = ob + r * p.o_sn + col;
        if (p.o_pairs) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);
        } else {
          dst[0] = __float2bfloat16(x0);
          if (col + 1 < p.d) dst[1] = __float2bfloat16(x1);
        }
      }
    }
    if (cs == 0 && quad == 0) {
      float* lb = p.lse + ((long long)b * p.heads + h) * p.n;
      if (r0 < p.n) lb[r0] = mrow[0] + log2f(l0);
      if (r1 < p.n) lb[r1] = mrow[1] + log2f(l1);
    }
  }
}

// ------------------------------------------------------------ host side

// What TMA takes: every operand as hopper.cuh:tma_operand_ok has it.
bool tma_ok(const Params& p) {
  return tma_operand_ok(p.q, p.d, p.q_sh, p.q_sb, p.q_sn) &&
         tma_operand_ok(p.k, p.d, p.k_sh, p.k_sb, p.k_sn) &&
         tma_operand_ok(p.v, p.d, p.v_sh, p.v_sb, p.v_sn);
}

template <class C>
cudaError_t launch(Params& p, int batch, cudaStream_t stream) {
  if (p.tma) {
    if (!tma_ok(p) ||
        !make_map(&p.tq, p.q, p.d, p.heads, p.n, batch, p.q_sh, p.q_sn, p.q_sb, C::BQ) ||
        !make_map(&p.tk, p.k, p.d, p.heads, p.m, batch, p.k_sh, p.k_sn, p.k_sb, C::BK) ||
        !make_map(&p.tv, p.v, p.d, p.heads, p.m, batch, p.v_sh, p.v_sn, p.v_sb, C::BK))
      return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.n + C::BQ - 1) / C::BQ, p.heads, batch);
  flash_fwd_kernel<C><<<grid, C::kThreads, C::kSmem, stream>>>(p);
  return cudaGetLastError();
}

// The head-dim classes.
template <int BQ, int BK, int STAGES>
using D40 = Cfg<48, 40, 1, 1, BQ / 64, BK, STAGES>;
template <int BQ, int BK, int STAGES>
using D80 = Cfg<80, 80, 2, 1, BQ / 64, BK, STAGES>;
template <int BQ, int BK, int STAGES>
using D160 = Cfg<160, 160, 3, 1, BQ / 64, BK, STAGES>;
using D512 = Cfg<512, 256, 8, 2, 1, 32, 2>;

bool make_params(Params& p, const void* q, const void* k, const void* v, const float* bias,
                 void* o, float* lse, int heads, int n, int m, int d, long long q_sb,
                 long long q_sh, long long q_sn, long long k_sb, long long k_sh, long long k_sn,
                 long long v_sb, long long v_sh, long long v_sn, long long o_sb, long long o_sh,
                 long long o_sn, long long bias_sb, float scale, int tma) {
  if (d < 1 || d > kMaxD || n < 1 || m < 1) return false;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.bias = bias;
  p.o = static_cast<bf16*>(o);
  p.lse = lse;
  p.heads = heads;
  p.n = n;
  p.m = m;
  p.d = d;
  p.q_sb = q_sb, p.q_sh = q_sh, p.q_sn = q_sn;
  p.k_sb = k_sb, p.k_sh = k_sh, p.k_sn = k_sn;
  p.v_sb = v_sb, p.v_sh = v_sh, p.v_sn = v_sn;
  p.o_sb = o_sb, p.o_sh = o_sh, p.o_sn = o_sn;
  p.bias_sb = bias_sb;
  p.scale_log2 = scale * kLog2e;
  p.tma = tma;
  p.o_pairs = d % 2 == 0 && reinterpret_cast<uintptr_t>(o) % 4 == 0 && o_sb % 2 == 0 &&
              o_sh % 2 == 0 && o_sn % 2 == 0;
  return true;
}

constexpr int tiles_key(int bq, int bk, int stages) { return (bq * 1000 + bk) * 10 + stages; }

// Launch the head-dim class of p.d at (bq, bk, stages), if this library
// holds that configuration: the serving library holds the wrapper's table
// (ops/flash_attention.py:FWD_TILES), the sweep library (flash_fwd_sweep.cu)
// the d <= 40 class at every configuration of tools/bench_sweep_attn.py.
// Any other configuration returns cudaErrorInvalidValue.
cudaError_t dispatch(Params& p, int batch, int bq, int bk, int stages, cudaStream_t s) {
  const int key = tiles_key(bq, bk, stages);
#ifndef FLASH_FWD_SWEEP
  if (p.d <= 40) {
    if (key == tiles_key(128, 128, 3)) return launch<D40<128, 128, 3>>(p, batch, s);
  } else if (p.d <= 80) {
    if (key == tiles_key(128, 128, 2)) return launch<D80<128, 128, 2>>(p, batch, s);
  } else if (p.d <= 160) {
    if (key == tiles_key(128, 64, 2)) return launch<D160<128, 64, 2>>(p, batch, s);
  } else if (key == tiles_key(64, 32, 2)) {
    return launch<D512>(p, batch, s);
  }
#else
  if (p.d <= 40) switch (key) {
      case tiles_key(64, 64, 2): return launch<D40<64, 64, 2>>(p, batch, s);
      case tiles_key(64, 64, 3): return launch<D40<64, 64, 3>>(p, batch, s);
      case tiles_key(64, 128, 2): return launch<D40<64, 128, 2>>(p, batch, s);
      case tiles_key(64, 128, 3): return launch<D40<64, 128, 3>>(p, batch, s);
      case tiles_key(128, 64, 2): return launch<D40<128, 64, 2>>(p, batch, s);
      case tiles_key(128, 64, 3): return launch<D40<128, 64, 3>>(p, batch, s);
      case tiles_key(128, 128, 2): return launch<D40<128, 128, 2>>(p, batch, s);
      case tiles_key(128, 128, 3): return launch<D40<128, 128, 3>>(p, batch, s);
    }
#endif
  return cudaErrorInvalidValue;
}

}  // namespace

#ifndef FLASH_FWD_SWEEP
// ------------------------------------------------------------ the fp32 route

namespace f32 {

constexpr int kBQ = 32, kBK = 32, kThreads = 256;
constexpr int kChunks = 4;  // O columns a thread: 4 x 4 of 512, lane-strided

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* bias;  // (B, M) rows at stride bias_sb, or null
  float* o;
  float* lse;  // (B, H, N) contiguous
  int heads, n, m, d;
  long long q_sb, q_sh, q_sn, k_sb, k_sh, k_sn, v_sb, v_sh, v_sn, o_sb, o_sh, o_sn, bias_sb;
  float scale_log2;
};

// 16 bytes from global to shared memory, or zeros past the tensor's rows.
__device__ __forceinline__ void cp16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows row0..row0+31 of a (rows, d) operand at row stride sn into a tile of
// row stride ld; rows at or past `rows` are zeros.
__device__ __forceinline__ void load_tile(float* tile, int ld, const float* base, long long sn,
                                          int row0, int rows, int d) {
  const int per_row = d / 4;
  for (int i = threadIdx.x; i < 32 * per_row; i += kThreads) {
    const int r = i / per_row, c = 4 * (i - r * per_row);
    const bool valid = row0 + r < rows;
    cp16(tile + r * ld + c, valid ? base + (row0 + r) * sn + c : base, valid);
  }
}

// One step of a reduce-scatter over the warp: the lane keeps the half of
// a[0..2W) that its lane bit W selects, plus its partner's same half.
template <int W>
__device__ __forceinline__ void reduce_half(float (&a)[32], int lane) {
  const bool upper = lane & W;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float send = upper ? a[i] : a[i + W];
    a[i] = (upper ? a[i + W] : a[i]) + __shfl_xor_sync(0xffffffffu, send, W);
  }
}

// 32 values a lane -> lane l holds the warp's sum of value l, in 31 shuffles.
__device__ __forceinline__ float reduce_scatter(float (&a)[32], int lane) {
  reduce_half<16>(a, lane);
  reduce_half<8>(a, lane);
  reduce_half<4>(a, lane);
  reduce_half<2>(a, lane);
  reduce_half<1>(a, lane);
  return a[0];
}

__global__ void __launch_bounds__(kThreads, 1) flash_fwd_f32_kernel(const Params p) {
  extern __shared__ __align__(16) float sm[];
  const int ld = p.d + 4;  // rows 4 banks apart
  float* sK = sm;
  float* sV = sK + kBK * ld;
  float* sP = sV + kBK * ld;      // (BK, BQ): P transposed, a key's 4 rows in one read
  float* sAlpha = sP + kBK * kBQ;  // (BQ): each row's rescale of O this tile

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* kb = p.k + b * p.k_sb + h * p.k_sh;
  const float* vb = p.v + b * p.v_sb + h * p.v_sh;
  const float* bias = p.bias ? p.bias + b * p.bias_sb : nullptr;
  const int ntiles = (p.m + kBK - 1) / kBK;

  // The warp's 4 query rows in registers, each lane the columns 4 lane +
  // 128 c (+0..3), scaled by scale * log2(e); zeros past N and d.  O has
  // the same layout.
  float q[4][kChunks][4], o[4][kChunks][4];
  const float* qb = p.q + b * p.q_sb + h * p.q_sh;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + warp * 4 + r;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int col = 4 * lane + 128 * c;
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (row < p.n && col < p.d) x = *reinterpret_cast<const float4*>(qb + row * p.q_sn + col);
      q[r][c][0] = x.x * p.scale_log2, q[r][c][1] = x.y * p.scale_log2;
      q[r][c][2] = x.z * p.scale_log2, q[r][c][3] = x.w * p.scale_log2;
      o[r][c][0] = o[r][c][1] = o[r][c][2] = o[r][c][3] = 0.0f;
    }
  }
  // the softmax's row and keys: row warp * 4 + lane / 8, keys lane % 8 + 8 j
  const int sr = warp * 4 + lane / 8, sc = lane % 8;
  float mrow = -INFINITY, lrow = 0.0f;

  load_tile(sK, ld, kb, p.k_sn, 0, p.m, p.d);
  cp_commit();
  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * kBK;
    load_tile(sV, ld, vb, p.v_sn, k0, p.m, p.d);  // under the S product
    cp_commit();
    cp_wait<1>();  // this K
    __syncthreads();

    // S = Q K^T, 8 keys at a time: each lane's partial sums over its
    // columns for the warp's 4 rows (value r * 8 + key), then summed over
    // the warp so that the lane holds (row lane / 8, key lane % 8)
    float s[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float part[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) part[i] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const float* kr = sK + (8 * j + kk) * ld;
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          if (4 * lane + 128 * c < p.d) {
            const float4 kv = *reinterpret_cast<const float4*>(kr + 4 * lane + 128 * c);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              float acc = part[r * 8 + kk];
              acc = fmaf(q[r][c][0], kv.x, acc);
              acc = fmaf(q[r][c][1], kv.y, acc);
              acc = fmaf(q[r][c][2], kv.z, acc);
              part[r * 8 + kk] = fmaf(q[r][c][3], kv.w, acc);
            }
          }
        }
      }
      s[j] = reduce_scatter(part, lane);
    }
    // the online softmax in log2 units, the row over the 8 lanes lane / 8
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + sc + 8 * j;
      float x = s[j];
      if (bias && col < p.m) x = fmaf(bias[col], kLog2e, x);
      s[j] = col < p.m ? x : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float mnew = fmaxf(mrow, mx);
    const float use = mnew == -INFINITY ? 0.0f : mnew;  // a row with no key yet keeps O = 0
    const float alpha = exp2f(mrow - use);
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[j] = exp2f(s[j] - use);
      sum += s[j];
      sP[(sc + 8 * j) * kBQ + sr] = s[j];
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    lrow = lrow * alpha + sum;
    mrow = mnew;
    if (sc == 0) sAlpha[sr] = alpha;
    __syncthreads();  // every thread is done with this K; P and alpha are written

    if (it + 1 < ntiles) {
      load_tile(sK, ld, kb, p.k_sn, k0 + kBK, p.m, p.d);  // under the P V product
      cp_commit();
      cp_wait<1>();  // this V
    } else {
      cp_wait<0>();
    }
    __syncthreads();

    const float4 al = *reinterpret_cast<const float4*>(sAlpha + warp * 4);
    const float a4[4] = {al.x, al.y, al.z, al.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[r][c][e] *= a4[r];
    const int kvalid = min(kBK, p.m - k0);
    for (int j = 0; j < kvalid; ++j) {
      const float4 pj = *reinterpret_cast<const float4*>(sP + j * kBQ + warp * 4);
      const float pr[4] = {pj.x, pj.y, pj.z, pj.w};
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        if (4 * lane + 128 * c < p.d) {
          const float4 vv = *reinterpret_cast<const float4*>(sV + j * ld + 4 * lane + 128 * c);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            o[r][c][0] = fmaf(pr[r], vv.x, o[r][c][0]);
            o[r][c][1] = fmaf(pr[r], vv.y, o[r][c][1]);
            o[r][c][2] = fmaf(pr[r], vv.z, o[r][c][2]);
            o[r][c][3] = fmaf(pr[r], vv.w, o[r][c][3]);
          }
        }
      }
    }
    __syncthreads();  // done with this V and P before the next tile's copies
  }

  // normalise once: row warp * 4 + r's sum is held by lane 8 r
  float* ob = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float l = __shfl_sync(0xffffffffu, lrow, 8 * r);
    const int row = q0 + warp * 4 + r;
    if (row >= p.n) continue;
    const float inv = 1.0f / l;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int col = 4 * lane + 128 * c;
      if (col >= p.d) break;
      *reinterpret_cast<float4*>(ob + row * p.o_sn + col) =
          make_float4(o[r][c][0] * inv, o[r][c][1] * inv, o[r][c][2] * inv, o[r][c][3] * inv);
    }
  }
  if (sc == 0 && q0 + sr < p.n)
    p.lse[((long long)b * p.heads + h) * p.n + q0 + sr] = mrow + log2f(lrow);
}

}  // namespace f32
#endif  // FLASH_FWD_SWEEP

// Plain C entry point for ctypes.  Returns a cudaError_t (0 = launched).
// Strides are in elements.  tma: 1 for the TMA route (the caller checked
// tma_ok), 0 for the copy route.  (bq, bk, stages): the tile configuration,
// one this library holds (dispatch).  The caller checks shapes, dtypes and
// devices.
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v, const float* bias,
                              void* o, float* lse, int batch, int heads, int n, int m, int d,
                              long long q_sb, long long q_sh, long long q_sn, long long k_sb,
                              long long k_sh, long long k_sn, long long v_sb, long long v_sh,
                              long long v_sn, long long o_sb, long long o_sh, long long o_sn,
                              long long bias_sb, float scale, int tma, int bq, int bk, int stages,
                              void* stream) {
  Params p;
  if (!make_params(p, q, k, v, bias, o, lse, heads, n, m, d, q_sb, q_sh, q_sn, k_sb, k_sh, k_sn,
                   v_sb, v_sh, v_sn, o_sb, o_sh, o_sn, bias_sb, scale, tma))
    return (int)cudaErrorInvalidValue;
  return (int)dispatch(p, batch, bq, bk, stages, static_cast<cudaStream_t>(stream));
}

#ifndef FLASH_FWD_SWEEP
// The fp32 route: q, k, v, bias, o and lse fp32, the rest as flash_fwd_bf16.
// d <= 512 and a multiple of 4; every base 16-byte aligned and every batch,
// head and row stride a multiple of 4 elements (the wrapper checks).
extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v, const float* bias,
                             void* o, float* lse, int batch, int heads, int n, int m, int d,
                             long long q_sb, long long q_sh, long long q_sn, long long k_sb,
                             long long k_sh, long long k_sn, long long v_sb, long long v_sh,
                             long long v_sn, long long o_sb, long long o_sh, long long o_sn,
                             long long bias_sb, float scale, void* stream) {
  if (d < 4 || d > f32::kChunks * 128 || d % 4 || n < 1 || m < 1 || batch < 1)
    return (int)cudaErrorInvalidValue;
  f32::Params p{static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), bias, static_cast<float*>(o), lse, heads, n, m, d,
                q_sb, q_sh, q_sn, k_sb, k_sh, k_sn, v_sb, v_sh, v_sn, o_sb, o_sh, o_sn, bias_sb,
                scale * kLog2e};
  const int smem = (2 * f32::kBK * (d + 4) + f32::kBK * f32::kBQ + f32::kBQ) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(f32::flash_fwd_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + f32::kBQ - 1) / f32::kBQ, heads, batch);
  f32::flash_fwd_f32_kernel<<<grid, f32::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
#endif
