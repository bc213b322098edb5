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
