// Flash-attention forward for Hopper (sm_90a), bf16 in / bf16 out, fp32 softmax;
// and its fp32 route (3xTF32 on the tensor cores).
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
// computes it (_fwd_kernel, pallas_attention.py:328-380, behind _fwd_impl's
// streamed pallas_call at :466, q/k/v cast to fp32).  wgmma has no fp32
// operands, and one TF32 pass keeps ~3 digits, so both products run as
// 3xTF32: x = hi + lo with hi = rna(x) and lo = rna(x - hi) (TF32 rounded
// to nearest, ties away, as cvt.rna.tf32.f32 rounds; wgmma reads only a
// TF32 operand's top 19 bits, so lo is rounded too) and a b ~ hi_a hi_b +
// hi_a lo_b + lo_a hi_b, which drops ~2^-22 of each product.  Its bound is
// the tensor cores': 3 x 4 B N M d = 206 GFLOP at (2, 4096, 512), 0.42 ms
// at 495 TFLOP/s of TF32 (1.03 ms at the 67 TFLOP/s of fp32 FMAs).  What
// the design does about d = 512 in fp32:
//   * keys are the products' M rows and 32 queries their N (a block):
//     S^T = K Q^T and O^T = V^T P^T.  A 64 x 512 fp32 O would be 256
//     registers a thread, and Q's 64 rows as hi + lo 256 KB; O^T over 32
//     queries is 64 registers a thread over two warpgroups (256 head-dim
//     rows each), and Q's hi + lo 128 KB, split once a block;
//   * TF32 wgmma has no transposed operand: B must be K-major.  Q as
//     stored is K-major for S^T; P^T is written K-major (keys contiguous
//     per query) by the softmax.  The A operands, K and V^T, come from
//     registers: K by ldmatrix from its 128-byte swizzled fp32 tile, V^T by
//     16-byte loads of V rows, which is the transpose (the thread's 8
//     head-dim rows of O^T are two 4-column chunks of one swizzle atom, so
//     one load feeds two tiles and 8 lanes' loads hit 32 banks);
//   * the split runs ~3 operations an operand value on the CUDA cores, as
//     integer adds and masks: cvt's conversion pipe runs at a quarter of
//     their rate and set the pace;
//   * each consumer warpgroup computes S^T for 64 of a tile's 128 keys; the
//     column (query) maxima meet through shared memory, each warpgroup
//     writes its half of P hi / lo, and both read all of it for their half
//     of O^T.  The online softmax, the rescale of O and the final
//     normalisation stay fp32.  The tensor cores do not round a chain of
//     accumulations to nearest, so each K slice's S^T (12 wgmmas) and each
//     tile's O^T (48) starts from zero and is added by fp32 adds;
//   * K (32 columns x 64 keys, one TMA request) and V (8 keys x 256
//     columns, one request through a 5-D map) arrive from fp32 tensor maps
//     into a ring of 4 stages a warpgroup, fed by the warpgroup's thread 0
//     while the step's products run (no producer warp: a ninth warp would
//     cap the block at 168 registers; the kernel uses ~250).  Rows past M
//     and columns past d are TMA's zeros, keys at or past M get -inf
//     (P = 0), queries past N are not stored.  Blocks start their key loop
//     at different tiles, so the 256 blocks do not read the same lines at
//     once.  A two-block cluster sharing each K/V stage by multicast was
//     slower (each refill then waits for the other block) and is not used.
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

constexpr int kBQ = 32;          // query rows a block: the products' N
constexpr int kKeys = 128;       // keys a tile: 64 a consumer warpgroup in S^T
constexpr int kThreads = 256;    // two consumer warpgroups; thread 0 of each feeds its ring
constexpr int kStages = 4;       // ring stages a warpgroup
constexpr int kStageBytes = 8192;
constexpr int kMaxSlices = 16;   // 32-column slices of d <= 512
constexpr int kQBytes = kMaxSlices * kBQ * 128;  // Q's hi (or lo): 32 rows x 512, 64 KB
constexpr int kPBytes = kKeys * kBQ * 4;         // P's hi (or lo): 128 keys x 32, 16 KB
constexpr int kOffP = 2 * kQBytes;
constexpr int kOffRing = kOffP + 2 * kPBytes;
constexpr int kOffRed = kOffRing + 2 * kStages * kStageBytes;
constexpr int kOffBar = kOffRed + 8 * kBQ * 4;  // a row of 32 per warp
constexpr int kSmem = kOffBar + 8 * 2 * kStages + 1024;  // + alignment slack
static_assert(kSmem <= 232448, "shared memory");

struct Params {
  // K: 32 columns x 64 keys a box; V: 32 columns x 8 keys; V as (32, key,
  // atom, head, batch): 8 atoms x 8 keys a box, one request for a whole
  // V chunk (d % 32 == 0)
  CUtensorMap tk, tv, tv5;
  const float* q;
  const float* bias;  // (B, M) rows at stride bias_sb, or null
  float* o;
  float* lse;  // (B, H, N) contiguous
  int heads, n, m, d;
  long long q_sb, q_sh, q_sn, o_sb, o_sh, o_sn, bias_sb;
  float scale_log2;  // softmax scale * log2(e)
};

template <int N>
__device__ __forceinline__ void pin_u(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

template <int ID>
__device__ __forceinline__ void bar_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(ID), "n"(kThreads) : "memory");
}

// The feeder's TMA requests as predicated instructions, so that the ring's
// refill is the same code in every thread of a warpgroup: a branch on the
// thread inside the products' pipeline would make ptxas serialize them.
__device__ __forceinline__ void expect_tx_if(bool pred, uint32_t bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n"
      "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n}\n" ::"r"(bar),
      "r"(bytes), "r"((int)pred)
      : "memory");
}
__device__ __forceinline__ void tma_load_5d_if(bool pred, uint32_t dst, const CUtensorMap* map,
                                               uint32_t bar, int c0, int c1, int c2, int c3,
                                               int c4) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %8, 0;\n"
      "@p cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n}\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4),
      "r"(bar), "r"((int)pred)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d_if(bool pred, uint32_t dst, const CUtensorMap* map,
                                               uint32_t bar, int c0, int c1, int c2, int c3) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %7, 0;\n"
      "@p cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n}\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar),
      "r"((int)pred)
      : "memory");
}

// The A fragments of one warpgroup product step, as hi and lo: four
// fragments of four TF32 values a thread.
struct Frags {
  uint32_t hi[4][4], lo[4][4];
};

// Which item of a warpgroup's stream comes next: per key tile, the K
// slices (32 columns x the warpgroup's 64 keys) and then the V chunks (8
// keys x the warpgroup's 256 columns), as many as the tile has keys.
struct Feed {
  int i = 0, j = 0, tile;  // i: tiles done; tile = (first + i) % tiles
  int first, tiles;
  __device__ Feed(int first_, int tiles_) : tile(first_), first(first_), tiles(tiles_) {}
  __device__ void advance(int slices, int m) {
    if (++j == slices + min(16, (m - tile * kKeys + 7) / 8)) {
      j = 0;
      tile = (first + ++i) % tiles;
    }
  }
};

// Load `item` into a ring stage.  A TMA request takes its thread hundreds
// of cycles to issue, so a V chunk is one request where d % 32 == 0 (the
// 5-D map puts its 8 atoms where the 4-D boxes would), and otherwise one
// per atom from as many threads at once.  `lead`: the warpgroup's thread 0.
__device__ __forceinline__ void issue(bool lead, int wtid, const Params& p, const Feed& item,
                                      int slices, int wg, uint8_t* stage, uint32_t full, int h,
                                      int b) {
  const int k0 = item.tile * kKeys;
  if (item.j < slices) {
    expect_tx_if(lead, full, kStageBytes);
    tma_load_4d_if(lead, smem_u32(stage), &p.tk, full, 32 * item.j, h, k0 + 64 * wg, b);
    return;
  }
  // the 32-column atoms of this warpgroup's 256 that hold columns < d; the
  // rest of the stage feeds only O rows at or past d, never stored
  const int atoms = max(0, min(8, (p.d - 256 * wg + 31) / 32));
  const int key0 = k0 + 8 * (item.j - slices);
  if (p.d % 32 == 0) {
    expect_tx_if(lead, full, atoms ? kStageBytes : 0);
    tma_load_5d_if(lead && atoms, smem_u32(stage), &p.tv5, full, 0, key0, 8 * wg, h, b);
  } else {
    expect_tx_if(lead, full, atoms * 1024);
    tma_load_4d_if(wtid < atoms, smem_u32(stage + wtid * 1024), &p.tv, full, 256 * wg + 32 * wtid,
                   h, key0, b);
  }
}

// The V map of a d % 32 == 0 head: (32 columns, key, 32-column atom, head,
// batch), boxes of 32 x 8 keys x 8 atoms, laid out in shared memory atom by
// atom as the 4-D map's boxes would be, 128-byte swizzled by key.
bool make_map_v5(CUtensorMap* map, const void* base, int d, int heads, int m, int batch,
                 long long sh, long long sn, long long sb) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[5] = {32, (cuuint64_t)m, (cuuint64_t)(d / 32), (cuuint64_t)heads,
                              (cuuint64_t)batch};
  const cuuint64_t strides[4] = {(cuuint64_t)(sn * 4), 128, (cuuint64_t)(sh * 4),
                                 (cuuint64_t)(sb * 4)};
  const cuuint32_t box[5] = {32, 8, 8, 1, 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 5, const_cast<void*>(base), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

__global__ void __launch_bounds__(kThreads, 1) flash_fwd_f32_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, wg = tid / 128, w = tid / 32 % 4, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int slices = (p.d + 31) / 32;
  const int ntiles = (p.m + kKeys - 1) / kKeys;
  const int total = ntiles * slices + (p.m + 7) / 8;  // items of each warpgroup's stream
  uint8_t* ring = smem + kOffRing + wg * kStages * kStageBytes;
  const uint32_t bars = smem_u32(smem + kOffBar);
  auto full = [&](int s) { return bars + 8 * (wg * kStages + s); };
  float* red = reinterpret_cast<float*>(smem + kOffRed);
  const uint32_t sq = smem_u32(smem), sp = smem_u32(smem + kOffP);

  if (tid == 0) {
    for (int s = 0; s < 2 * kStages; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const bool feeder = tid % 128 == 0;
  // Blocks start their key loop at different tiles, so that the blocks in
  // flight do not all read the same K and V lines at once.
  const int first = blockIdx.x % ntiles;
  Feed feed(first, ntiles);  // every thread of the warpgroup tracks its stream
  for (int u = 0; u < min(kStages, total); ++u, feed.advance(slices, p.m))
    issue(feeder, tid % 128, p, feed, slices, wg, ring + u * kStageBytes, full(u), h, b);

  // Q's 32 rows split once into hi and lo, K-major 128-byte swizzled atoms
  // of 32 columns (wgmma's B of S^T = K Q^T); zeros past N and d
  {
    const float* qb = p.q + b * p.q_sb + h * p.q_sh;
    const int per_row = slices * 8;
    for (int i = tid; i < kBQ * per_row; i += kThreads) {
      const int r = i / per_row, c4 = i % per_row;
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (q0 + r < p.n && 4 * c4 < p.d)
        x = *reinterpret_cast<const float4*>(qb + (q0 + r) * p.q_sn + 4 * c4);
      uint4 hi, lo;
      split(x.x, hi.x, lo.x);
      split(x.y, hi.y, lo.y);
      split(x.z, hi.z, lo.z);
      split(x.w, hi.w, lo.w);
      const int off = (c4 / 8) * kBQ * 128 + r * 128 + (((c4 % 8) ^ (r & 7)) << 4);
      *reinterpret_cast<uint4*>(smem + off) = hi;
      *reinterpret_cast<uint4*>(smem + kQBytes + off) = lo;
    }
    fence_proxy_async();
    __syncthreads();
  }

  // S^T: s[4j + 2hf + e] = (key 16w + g + 8hf of the warpgroup's 64, query
  // 8j + 2t + e).  O^T: o[i][4j + 2hf + e] = (head-dim column col(i, hf),
  // query 8j + 2t + e), where the thread's 8 columns are two 4-column
  // chunks, L1 and L2 = L1 + 2, of 32-column atom 2w + g / 4 of the
  // warpgroup's 256: i = 0, 1 in L1, i = 2, 3 in L2, at 2 (i % 2) + hf.
  // So one 16-byte load of a V row gives a key's values for two tiles, and
  // the chunks {0, 4, 1, 5}[g % 4] keep 8 lanes' loads on 32 banks.
  //
  // The tensor cores sum a product's terms into the accumulator without
  // rounding to nearest, so the error of a chain of wgmmas grows with its
  // length (~1536 steps of O over 4096 keys lost ~5e-5 of O).  So each K
  // slice's S^T (12 steps) and each tile's O^T (48) start from zero and are
  // added to s and o by fp32 adds, in a fixed order.
  const int atom = 2 * w + g / 4, l1 = (g % 4) / 2 + 4 * (g % 2);
  float o[4][16], ot[4][16], s[16];
  float mrow[8], lrow[8], alpha[8];  // per query column 2j + e
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 16; ++e) o[i][e] = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) mrow[c] = -INFINITY, lrow[c] = 0.0f;
  const float* bias = p.bias ? p.bias + b * p.bias_sb : nullptr;
  Frags f;  // the current item's A fragments
  int u = 0;  // items consumed

  // Refill the stage of the item before the current one with the item
  // kStages after it.  That stage is free: the warpgroup's products of its
  // item completed (wgmma_wait) before this item began, and they took their
  // A fragments from all four warps' registers, so every warp had finished
  // its loads from the stage.  Called with the current item's products in
  // flight, so that the requests' issue runs under them.
  auto refill = [&]() {
    if (u > 1 && u - 2 + kStages < total) {
      const int prev = (u - 2) % kStages;
      issue(feeder, tid % 128, p, feed, slices, wg, ring + prev * kStageBytes, full(prev), h, b);
      feed.advance(slices, p.m);
    }
  };
  // Lane 0 of each warp waits for the stage's bytes; the warp follows it.
  auto wait_full = [&](int st) {
    if (lane == 0) mbar_wait(full(st), (u / kStages) & 1);
    __syncwarp();
  };

  // One K slice: four k8 steps of K Q^T, 3 passes each, into a fresh
  // accumulator added to s.  The A fragments by ldmatrix (four 8-row x
  // 16-byte matrices: rows g and g + 8, columns t and t + 4 of the step),
  // split in registers.
  auto s_slice = [&](int j) {
    float part[16];
    const int st = u % kStages;
    wait_full(st);
    const uint32_t base = smem_u32(ring + st * kStageBytes);
    const int row = 16 * w + 8 * ((lane / 8) & 1) + lane % 8;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t addr = base + row * 128 + (((2 * kk + lane / 16) ^ (lane % 8)) << 4);
      asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(f.hi[kk][0]), "=r"(f.hi[kk][1]), "=r"(f.hi[kk][2]), "=r"(f.hi[kk][3])
                   : "r"(addr)
                   : "memory");
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) split(__uint_as_float(f.hi[kk][e]), f.hi[kk][e], f.lo[kk][e]);
    ++u;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t qa = sq + j * kBQ * 128 + kk * 32;
      const uint64_t qhi = sw128_desc(qa, 16, 1024), qlo = sw128_desc(qa + kQBytes, 16, 1024);
      WgmmaRsTf32<kBQ>::rs(part, f.hi[kk], qhi, kk > 0);
      WgmmaRsTf32<kBQ>::rs(part, f.hi[kk], qlo, 1);
      WgmmaRsTf32<kBQ>::rs(part, f.lo[kk], qhi, 1);
    }
    wgmma_commit();
    refill();
    wgmma_wait<0>();
    pin_u(f.hi), pin_u(f.lo), pin(part);
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = j == 0 ? part[i] : s[i] + part[i];
  };

  // One V chunk (key step c of the tile): O^T += V^T P^T for the
  // warpgroup's four 64-row tiles, 3 passes each.  Keys t and t + 4 of the
  // chunk are rows t and t + 4 of each atom.
  auto o_chunk = [&](int c) {
    const int st = u % kStages;
    wait_full(st);
    const uint8_t* at = ring + st * kStageBytes + atom * 1024;
    float4 v[2][2];  // [chunk L1, L2][key t, t + 4]
#pragma unroll
    for (int ch = 0; ch < 2; ++ch)
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) {
        const int key = t + 4 * kh;
        v[ch][kh] = *reinterpret_cast<const float4*>(at + key * 128 + (((l1 + 2 * ch) ^ key) << 4));
      }
#pragma unroll
    for (int ch = 0; ch < 2; ++ch) {
      split(v[ch][0].x, f.hi[2 * ch][0], f.lo[2 * ch][0]);
      split(v[ch][0].y, f.hi[2 * ch][1], f.lo[2 * ch][1]);
      split(v[ch][1].x, f.hi[2 * ch][2], f.lo[2 * ch][2]);
      split(v[ch][1].y, f.hi[2 * ch][3], f.lo[2 * ch][3]);
      split(v[ch][0].z, f.hi[2 * ch + 1][0], f.lo[2 * ch + 1][0]);
      split(v[ch][0].w, f.hi[2 * ch + 1][1], f.lo[2 * ch + 1][1]);
      split(v[ch][1].z, f.hi[2 * ch + 1][2], f.lo[2 * ch + 1][2]);
      split(v[ch][1].w, f.hi[2 * ch + 1][3], f.lo[2 * ch + 1][3]);
    }
    ++u;
    pin(ot[0]), pin(ot[1]), pin(ot[2]), pin(ot[3]);
    wgmma_fence();
    const uint32_t pa = sp + (c / 4) * kBQ * 128 + (c % 4) * 32;
    const uint64_t phi = sw128_desc(pa, 16, 1024), plo = sw128_desc(pa + kPBytes, 16, 1024);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      WgmmaRsTf32<kBQ>::rs(ot[i], f.hi[i], phi, c > 0);
      WgmmaRsTf32<kBQ>::rs(ot[i], f.hi[i], plo, 1);
      WgmmaRsTf32<kBQ>::rs(ot[i], f.lo[i], phi, 1);
    }
    wgmma_commit();
    refill();
    wgmma_wait<0>();
    pin_u(f.hi), pin_u(f.lo);
  };

  for (int i = 0; i < ntiles; ++i) {
    const int tile = (first + i) % ntiles;
    for (int j = 0; j < slices; ++j) s_slice(j);  // S^T = K Q^T

    // the online softmax down the key rows, in log2 units: keys at or past
    // M get -inf (TMA's zero fill gives s = 0), the bias a per-row add
    float bl[2];
    bool valid[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int key = tile * kKeys + 64 * wg + 16 * w + 8 * hf + g;
      valid[hf] = key < p.m;
      bl[hf] = bias && valid[hf] ? bias[key] * kLog2e : 0.0f;
    }
    float cmax[8];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x0 = s[4 * j + e];
        float& x1 = s[4 * j + 2 + e];
        x0 = valid[0] ? fmaf(x0, p.scale_log2, bl[0]) : -INFINITY;
        x1 = valid[1] ? fmaf(x1, p.scale_log2, bl[1]) : -INFINITY;
        float mx = fmaxf(x0, x1);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        cmax[2 * j + e] = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      }
    if (g == 0)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float2*>(red + (4 * wg + w) * kBQ + 8 * j + 2 * t) =
            make_float2(cmax[2 * j], cmax[2 * j + 1]);
    bar_sync<1>();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float2 mx = make_float2(-INFINITY, -INFINITY);
#pragma unroll
      for (int wi = 0; wi < 8; ++wi) {
        const float2 r = *reinterpret_cast<const float2*>(red + wi * kBQ + 8 * j + 2 * t);
        mx.x = fmaxf(mx.x, r.x);
        mx.y = fmaxf(mx.y, r.y);
      }
      cmax[2 * j] = mx.x;
      cmax[2 * j + 1] = mx.y;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 2 * j + e;
        const float mnew = fmaxf(mrow[c], cmax[c]);
        const float use = mnew == -INFINITY ? 0.0f : mnew;  // no key yet: O = 0, p = 0
        alpha[c] = ex2(mrow[c] - use);
        mrow[c] = mnew;
        const float p0 = ex2(s[4 * j + e] - use), p1 = ex2(s[4 * j + 2 + e] - use);
        lrow[c] = lrow[c] * alpha[c] + p0 + p1;
        s[4 * j + e] = p0;
        s[4 * j + 2 + e] = p1;
      }
    // P^T as wgmma's B (keys K-major): row = query, 32-key swizzled atoms;
    // every earlier product that read P finished before the barrier above
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int key = 64 * wg + 16 * w + 8 * hf + g, n = 8 * j + 2 * t + e;
          const int off = (key / 32) * kBQ * 128 + n * 128 +
                          ((((key % 32) / 4) ^ (n & 7)) << 4) + (key % 4) * 4;
          uint32_t hi, lo;
          split(s[4 * j + 2 * hf + e], hi, lo);
          *reinterpret_cast<uint32_t*>(smem + kOffP + off) = hi;
          *reinterpret_cast<uint32_t*>(smem + kOffP + kPBytes + off) = lo;
        }
    fence_proxy_async();
    bar_sync<2>();

    // O^T = V^T P^T over the tile's key steps, then o = alpha o + O^T
    const int chunks = min(16, (p.m - tile * kKeys + 7) / 8);
    for (int c = 0; c < chunks; ++c) o_chunk(c);
    pin(ot[0]), pin(ot[1]), pin(ot[2]), pin(ot[3]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          o[i][4 * j + e] = fmaf(o[i][4 * j + e], alpha[2 * j + e], ot[i][4 * j + e]);
          o[i][4 * j + 2 + e] = fmaf(o[i][4 * j + 2 + e], alpha[2 * j + e], ot[i][4 * j + 2 + e]);
        }
  }

  // the sums over the block: the warp's 16 keys, then its 8 warps
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    lrow[c] += __shfl_xor_sync(0xffffffffu, lrow[c], 4);
    lrow[c] += __shfl_xor_sync(0xffffffffu, lrow[c], 8);
    lrow[c] += __shfl_xor_sync(0xffffffffu, lrow[c], 16);
  }
  if (g == 0)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float2*>(red + (4 * wg + w) * kBQ + 8 * j + 2 * t) =
          make_float2(lrow[2 * j], lrow[2 * j + 1]);
  bar_sync<1>();
  float* ob = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = 8 * j + 2 * t + e;
      float l = 0.0f;
#pragma unroll
      for (int wi = 0; wi < 8; ++wi) l += red[wi * kBQ + n];
      if (q0 + n >= p.n) continue;
      if (wg == 0 && w == 0 && g == 0)
        p.lse[((long long)b * p.heads + h) * p.n + q0 + n] = mrow[2 * j + e] + log2f(l);
      const float inv = 1.0f / l;
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        const int col = 256 * wg + 32 * atom + 4 * (l1 + 2 * ch);
        if (col < p.d)
          *reinterpret_cast<float4*>(ob + (q0 + n) * p.o_sn + col) =
              make_float4(o[2 * ch][4 * j + e] * inv, o[2 * ch][4 * j + 2 + e] * inv,
                          o[2 * ch + 1][4 * j + e] * inv, o[2 * ch + 1][4 * j + 2 + e] * inv);
      }
    }
}

}  // namespace f32

// ------------------------------------------------------------ the fp32 route, d <= 160
//
// The UNet's heads in fp32 (d = 40, 80, 160 at ds1, ds2, ds4 and the middle
// block: attn1, cross-attention and every fuser of a model served in fp32),
// the same function as the TPU's single-KV forwards (_fwd_kernel_single
// :252 and _fwd_kernel_single_chunked :163, behind the pallas_calls at
// pallas_attention.py:428 and :836) on fp32 q/k/v.  Its bound is the tensor
// cores': 3 x 4 B N M d at 495 TFLOP/s of TF32, 0.52 ms at ds1 attn1 (4 x 8
// heads, 4096 x 4096, d = 40).  The kernel above lays its products out for
// d = 512 (O^T over 512 head-dim rows whatever d is, keys as the M rows, P
// through shared memory); at d = 40 most of its tensor-core work lands on
// rows that are never stored.  This one is laid out for the small heads:
//   * queries are the products' M rows: each consumer warpgroup owns 64 of
//     the block's BQ = 64 NW queries.  S = Q K^T is wgmma m64nBKk8 with both
//     operands from shared memory (TF32 takes only K-major operands: Q and
//     K as stored, d contiguous), D / 8 k-steps; O = P V is m64nDk8 with P
//     from registers and N = the class's head dim D (two halves of 80 at
//     D = 160, where a whole tile part beside O spilled), so no product runs
//     on a row or column past D.  A query row's running max and sum stay in
//     the 4 threads of a quad (softmax_tile, the bf16 kernel's), and O stays
//     in registers in fp32;
//   * 3xTF32: x = hi + lo, hi = rna(x) (hopper.cuh:tf32), lo = x - hi, which
//     the tensor cores truncate to TF32 (as gemm_tf32.cuh splits); a b ~
//     hi hi + hi lo + lo hi.  A tile's S is one chain of 3 D / 8 products
//     (15, 30, 60) and its part of O one chain of 3 BK / 8 (12 or 24), from
//     zero and added to O by fp32 adds: the tensor cores do not round a
//     chain of accumulations to nearest, so no chain runs over all M keys;
//   * P feeds the RS wgmma from S's accumulator registers: a thread holds
//     keys 2t and 2t + 1 of each 8-key step, where the TF32 A fragment reads
//     k = t and t + 4.  So V^T's 8 keys of a step are stored in the order
//     0, 2, 4, 6, 1, 3, 5, 7 (key 2i at k = i, 2i + 1 at k = 4 + i), and P
//     never touches shared memory;
//   * V is not K-major for O = P V, and K and V need their lo halves, so the
//     consumers convert each K/V tile themselves: K as hi and lo (32-column
//     128-byte swizzled atoms, as TMA would write them) and V^T as hi and lo
//     (rows = head-dim columns, 32-key atoms), from plain 32-byte loads of K
//     and V rows (a sector a lane; a warp's 32 lanes are 32 keys, so the
//     transposed stores of one V column fill one 128-byte row, no bank
//     conflict).  The next tile's loads are issued a tile ahead into
//     registers and stored, split, into the other of two buffers under this
//     tile's O product (NBUF = 2); an mbarrier pair per buffer (full: every
//     consumer thread stored it; empty: every warp's products that read it
//     completed) stands in for a block barrier, so the warpgroups run out of
//     step.  With no TMA there is no producer warp and no raw stage: Q's hi
//     and lo (split once a block) and the converted tiles are the whole of
//     shared memory.  At d = 160, Q's hi and lo take 80 KB for 64 queries, so
//     one warpgroup and one buffer (NBUF = 1) fit;
//   * ragged edges: rows past N and M load as zeros; keys at or past M get
//     -inf after the product (softmax_tile's mask), queries past N are not
//     stored.  The optional fp32 (B, M) bias row is read per key tile from
//     global memory (natural-log units).  No atomics: a run repeats bit for
//     bit.
// Tiles by head-dim class come from the wrapper's table
// (ops/flash_attention.py:FWD_TILES_F32), which this library holds
// (dispatch below); flash_fwd_f32_sweep.cu builds the d <= 40 and d <= 80
// classes at every configuration of tools/bench_sweep_attn.py --fp32.

namespace f32qm {

// D: the class's head dim (O's wgmma N, V^T's rows); NW: consumer
// warpgroups (BQ = 64 NW queries); BK: keys a tile (S's wgmma N); NBUF:
// converted K/V buffers.
template <int D_, int NW_, int BK_, int NBUF_>
struct Cfg {
  static constexpr int D = D_, NW = NW_, BK = BK_, NBUF = NBUF_;
  static constexpr int BQ = 64 * NW, kThreads = 128 * NW;
  static constexpr int kSteps = D / 8;                  // k8 steps of S
  // O's wgmma N: the whole head dim, or halves of 80 at d = 160, where a
  // whole tile part beside O would spill
  static constexpr int kON = D > 80 ? D / 2 : D;
  static constexpr int kAtoms = (D + 31) / 32;          // 32-column atoms of Q and K
  static constexpr int kQBytes = kAtoms * BQ * 128;     // Q's hi (or lo)
  static constexpr int kKBytes = kAtoms * BK * 128;     // a tile's K hi (or lo)
  static constexpr int kVBytes = (BK / 32) * D * 128;   // a tile's V^T hi (or lo)
  static constexpr int kBufBytes = 2 * kKBytes + 2 * kVBytes;
  static constexpr int kOffBuf = 2 * kQBytes;
  static constexpr int kOffBar = kOffBuf + NBUF * kBufBytes;
  static constexpr int kSmem = kOffBar + 8 * 4 + 1024;  // + alignment slack
  // a tile's load units: (32-key group, 8-column group), one key a lane
  static constexpr int kUnits = (BK / 32) * (D / 8);
  static constexpr int kRounds = (kUnits + 4 * NW - 1) / (4 * NW);
  static constexpr int kQUnits = (BQ / 32) * (D / 8);
  static_assert(D % 8 == 0 && kON % 8 == 0 && kON <= 256, "O's wgmma N");
  static_assert(BK == 32 || BK == 64, "S's wgmma N and V^T's 32-key atoms");
  static_assert(NBUF == 1 || NBUF == 2, "buffers");
  static_assert(kSmem <= 232448, "shared memory");
};

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* bias;  // (B, M) rows at stride bias_sb, or null
  float* o;
  float* lse;  // (B, H, N) contiguous
  int heads, n, m, d;
  long long q_sb, q_sh, q_sn, k_sb, k_sh, k_sn, v_sb, v_sh, v_sn, o_sb, o_sh, o_sn, bias_sb;
  float scale_log2;  // softmax scale * log2(e)
};

// x = hi + lo: hi = rna(x) as TF32, lo = x - hi (exact), left for the
// tensor cores to truncate to TF32.
__device__ __forceinline__ void split_tc(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

// Columns col..col + 7 of row `row` (zeros at rows >= rows, columns >= d).
__device__ __forceinline__ void load8(float4 (&x)[2], const float* base, long long sn, int row,
                                      int rows, int col, int d) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
    x[i] = row < rows && col + 4 * i < d
               ? *reinterpret_cast<const float4*>(base + row * sn + col + 4 * i)
               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// Row r, columns 8 cg..8 cg + 7, of a K-major operand of `rows` rows in
// 32-column atoms of 128-byte rows, 128-byte swizzled: hi at `hi`, lo at the
// same offset of `lo`.
__device__ __forceinline__ void store_row8(uint8_t* hi, uint8_t* lo, int rows, int r, int cg,
                                           const float4 (&x)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int off = (cg / 4) * rows * 128 + r * 128 + ((((cg % 4) * 2 + i) ^ (r & 7)) << 4);
    uint4 h, l;
    split_tc(x[i].x, h.x, l.x);
    split_tc(x[i].y, h.y, l.y);
    split_tc(x[i].z, h.z, l.z);
    split_tc(x[i].w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

// Key `key` of a tile, columns 8 cg..8 cg + 7 of V, into V^T: row n = the
// column, 32-key atoms of D rows, 128-byte swizzled; within an 8-key step
// key 2i at k = i and key 2i + 1 at k = 4 + i (P's fragment order).
template <int D>
__device__ __forceinline__ void store_vt8(uint8_t* hi, uint8_t* lo, int key, int cg,
                                          const float4 (&x)[2]) {
  const int kk = key % 8, word = (key % 32) / 8 * 8 + (kk & 1) * 4 + kk / 2;
  const int base = (key / 32) * D * 128 + 8 * cg * 128 + (word % 4) * 4;
  const float v[8] = {x[0].x, x[0].y, x[0].z, x[0].w, x[1].x, x[1].y, x[1].z, x[1].w};
#pragma unroll
  for (int e = 0; e < 8; ++e) {  // row 8 cg + e, whose swizzle is e
    const int off = base + e * 128 + (((word / 4) ^ e) << 4);
    uint32_t h, l;
    split_tc(v[e], h, l);
    *reinterpret_cast<uint32_t*>(hi + off) = h;
    *reinterpret_cast<uint32_t*>(lo + off) = l;
  }
}

// A thread's share of one K/V tile, as loaded: its warp's units, one key
// (its lane) of 8 columns each, in rounds of one unit a warp.
template <class C>
struct Share {
  float4 k[C::kRounds][2], v[C::kRounds][2];

  __device__ __forceinline__ void load_round(int r, const Params& p, const float* kb,
                                             const float* vb, int k0, int warp, int lane) {
    const int u = warp + 4 * C::NW * r;
    if (u < C::kUnits) {
      const int key = k0 + 32 * (u / (C::D / 8)) + lane, col = 8 * (u % (C::D / 8));
      load8(k[r], kb, p.k_sn, key, p.m, col, p.d);
      load8(v[r], vb, p.v_sn, key, p.m, col, p.d);
    }
  }

  // split into a buffer: K hi, K lo, V^T hi, V^T lo
  __device__ __forceinline__ void store_round(int r, uint8_t* buf, int warp, int lane) const {
    const int u = warp + 4 * C::NW * r;
    if (u < C::kUnits) {
      const int key = 32 * (u / (C::D / 8)) + lane, cg = u % (C::D / 8);
      store_row8(buf, buf + C::kKBytes, C::BK, key, cg, k[r]);
      store_vt8<C::D>(buf + 2 * C::kKBytes, buf + 2 * C::kKBytes + C::kVBytes, key, cg, v[r]);
    }
  }

  __device__ __forceinline__ void load(const Params& p, const float* kb, const float* vb, int k0,
                                       int warp, int lane) {
#pragma unroll
    for (int r = 0; r < C::kRounds; ++r) load_round(r, p, kb, vb, k0, warp, lane);
  }

  __device__ __forceinline__ void store(uint8_t* buf, int warp, int lane) const {
#pragma unroll
    for (int r = 0; r < C::kRounds; ++r) store_round(r, buf, warp, lane);
  }

  // load and store one round at a time, each round's loads kept below the
  // last round's stores (a memory clobber): with one buffer (d = 160) O's 80
  // registers leave no room for a whole share (80 more), which spilled
  __device__ __forceinline__ void copy(const Params& p, const float* kb, const float* vb, int k0,
                                       uint8_t* buf, int warp, int lane) {
#pragma unroll
    for (int r = 0; r < C::kRounds; ++r) {
      load_round(r, p, kb, vb, k0, warp, lane);
      store_round(r, buf, warp, lane);
      asm volatile("" ::: "memory");
    }
  }
};

template <class C>
__global__ void __launch_bounds__(C::kThreads, 1)
    flash_fwd_f32_qm_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, wg = tid / 128, warp = tid / 32, w = warp % 4, lane = tid % 32;
  const int quad = lane % 4;
  const int q0 = blockIdx.x * C::BQ, h = blockIdx.y, b = blockIdx.z;
  const int ntiles = (p.m + C::BK - 1) / C::BK;
  const uint32_t bars = smem_u32(smem + C::kOffBar);
  auto full = [&](int i) { return bars + 8 * i; };         // every thread stored buffer i
  auto empty = [&](int i) { return bars + 8 * (2 + i); };  // every warp's products read it
  auto buf = [&](int i) { return smem + C::kOffBuf + i * C::kBufBytes; };

  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(full(i), C::kThreads);
      mbar_init(empty(i), 4 * C::NW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Q's rows split once into hi and lo, then K/V tile 0 into buffer 0; the
  // first tile's full barrier covers both
  const float* kb = p.k + b * p.k_sb + h * p.k_sh;
  const float* vb = p.v + b * p.v_sb + h * p.v_sh;
  {
    const float* qb = p.q + b * p.q_sb + h * p.q_sh;
    for (int u = warp; u < C::kQUnits; u += 4 * C::NW) {
      const int r = 32 * (u / (C::D / 8)) + lane, cg = u % (C::D / 8);
      float4 x[2];
      load8(x, qb, p.q_sn, q0 + r, p.n, 8 * cg, p.d);
      store_row8(smem, smem + C::kQBytes, C::BQ, r, cg, x);
    }
  }
  Share<C> next;
  next.copy(p, kb, vb, 0, buf(0), warp, lane);
  fence_proxy_async();
  mbar_arrive(full(0));
  if (C::NBUF == 2 && ntiles > 1) next.load(p, kb, vb, C::BK, warp, lane);

  float o[C::D / 2], s[C::BK / 2];
#pragma unroll
  for (int i = 0; i < C::D / 2; ++i) o[i] = 0.0f;
  float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.0f, 0.0f};
  const float* bias = p.bias ? p.bias + b * p.bias_sb : nullptr;
  const uint32_t q_hi = smem_u32(smem) + wg * 64 * 128, q_lo = q_hi + C::kQBytes;

  for (int it = 0; it < ntiles; ++it) {
    const int cur = it % C::NBUF, k0 = it * C::BK;
    mbar_wait(full(cur), (it / C::NBUF) & 1);
    const uint32_t k_hi = smem_u32(buf(cur)), k_lo = k_hi + C::kKBytes;
    const uint32_t v_hi = k_lo + C::kKBytes, v_lo = v_hi + C::kVBytes;
    uint32_t qh0 = q_hi, ql0 = q_lo;
    // opaque to the compiler: Q's descriptors are rebuilt each tile (an add
    // each) instead of being hoisted out of the loop into 4 D / 8 registers
    asm volatile("" : "+r"(qh0), "+r"(ql0));

    // S = Q K^T, one chain of 3 passes a k8 step
    pin(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::kSteps; ++kk) {
      const uint32_t qo = (kk / 4) * C::BQ * 128 + (kk % 4) * 32;
      const uint32_t ko = (kk / 4) * C::BK * 128 + (kk % 4) * 32;
      const uint64_t qh = sw128_desc(qh0 + qo, 16, 1024), ql = sw128_desc(ql0 + qo, 16, 1024);
      const uint64_t kh = sw128_desc(k_hi + ko, 16, 1024), kl = sw128_desc(k_lo + ko, 16, 1024);
      WgmmaSsTf32<C::BK>::ss(s, qh, kh, kk > 0);
      WgmmaSsTf32<C::BK>::ss(s, qh, kl, 1);
      WgmmaSsTf32<C::BK>::ss(s, ql, kh, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin(s);

    const bool last = k0 + C::BK > p.m;
    if (bias) {
      if (last)
        softmax_tile<C::BK, C::D, true, true>(s, o, mrow, lrow, bias, k0, p.m, p.scale_log2, quad);
      else
        softmax_tile<C::BK, C::D, false, true>(s, o, mrow, lrow, bias, k0, p.m, p.scale_log2, quad);
    } else {
      if (last)
        softmax_tile<C::BK, C::D, true, false>(s, o, mrow, lrow, bias, k0, p.m, p.scale_log2, quad);
      else
        softmax_tile<C::BK, C::D, false, false>(s, o, mrow, lrow, bias, k0, p.m, p.scale_log2,
                                                quad);
    }

    // P as the A fragments of each 8-key step: (row g, k t) = key 2t,
    // (row g, k t + 4) = key 2t + 1, as V^T was stored
    uint32_t ph[C::BK / 8][4], pl[C::BK / 8][4];
#pragma unroll
    for (int j = 0; j < C::BK / 8; ++j) {
      split_tc(s[4 * j], ph[j][0], pl[j][0]);
      split_tc(s[4 * j + 2], ph[j][1], pl[j][1]);
      split_tc(s[4 * j + 1], ph[j][2], pl[j][2]);
      split_tc(s[4 * j + 3], ph[j][3], pl[j][3]);
    }
    // this tile's part of O, from zero: a chain of 3 passes a step, over
    // each kON columns of the head dim in turn
#pragma unroll
    for (int part = 0; part < C::D / C::kON; ++part) {
      float ot[C::kON / 2];
      pin(ot);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < C::BK / 8; ++j) {
        const uint32_t vo = (j / 4) * C::D * 128 + part * C::kON * 128 + (j % 4) * 32;
        const uint64_t vh = sw128_desc(v_hi + vo, 16, 1024), vl = sw128_desc(v_lo + vo, 16, 1024);
        WgmmaRsTf32<C::kON>::rs(ot, ph[j], vh, j > 0);
        WgmmaRsTf32<C::kON>::rs(ot, ph[j], vl, 1);
        WgmmaRsTf32<C::kON>::rs(ot, pl[j], vh, 1);
      }
      wgmma_commit();
      if (C::NBUF == 2 && part == C::D / C::kON - 1 && it + 1 < ntiles) {
        // under the product: the next tile, loaded a tile ago, into the
        // other buffer once every warp's products of the tile before this
        // one are done
        const int nb = (it + 1) % 2;
        if (it >= 1) mbar_wait(empty(nb), ((it - 1) / 2) & 1);
        next.store(buf(nb), warp, lane);
        fence_proxy_async();
        mbar_arrive(full(nb));
      }
      wgmma_wait<0>();
      pin(ot), f32::pin_u(ph), f32::pin_u(pl);
#pragma unroll
      for (int i = 0; i < C::kON / 2; ++i) o[part * C::kON / 2 + i] += ot[i];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(cur));
    if (C::NBUF == 2 && it + 2 < ntiles) next.load(p, kb, vb, (it + 2) * C::BK, warp, lane);
    if (C::NBUF == 1 && it + 1 < ntiles) {
      mbar_wait(empty(0), it & 1);
      next.copy(p, kb, vb, (it + 1) * C::BK, buf(0), warp, lane);
      fence_proxy_async();
      mbar_arrive(full(0));
    }
  }

  // normalise once, store the rows < N and columns < d, and the LSE
  const float l0 = quad_sum(lrow[0]), l1 = quad_sum(lrow[1]);
  const int r0 = q0 + wg * 64 + w * 16 + lane / 4, r1 = r0 + 8;
  const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
  float* ob = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int j = 0; j < C::D / 8; ++j) {
    const int col = 8 * j + 2 * quad;
    if (col >= p.d) continue;
    if (r0 < p.n)
      *reinterpret_cast<float2*>(ob + r0 * p.o_sn + col) =
          make_float2(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    if (r1 < p.n)
      *reinterpret_cast<float2*>(ob + r1 * p.o_sn + col) =
          make_float2(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
  if (quad == 0) {
    float* lb = p.lse + ((long long)b * p.heads + h) * p.n;
    if (r0 < p.n) lb[r0] = mrow[0] + log2f(l0);
    if (r1 < p.n) lb[r1] = mrow[1] + log2f(l1);
  }
}

template <class C>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32_qm_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.n + C::BQ - 1) / C::BQ, p.heads, batch);
  flash_fwd_f32_qm_kernel<C><<<grid, C::kThreads, C::kSmem, stream>>>(p);
  return cudaGetLastError();
}

// The head-dim classes at (BQ, BK, buffers).
template <int BQ, int BK, int NBUF>
using Q40 = Cfg<40, BQ / 64, BK, NBUF>;
template <int BQ, int BK, int NBUF>
using Q80 = Cfg<80, BQ / 64, BK, NBUF>;
template <int BQ, int BK, int NBUF>
using Q160 = Cfg<160, BQ / 64, BK, NBUF>;

// Launch the class of p.d (<= 160) at (bq, bk, nbuf), if this library holds
// that configuration: the serving library the wrapper's table
// (ops/flash_attention.py:FWD_TILES_F32), the sweep library
// (flash_fwd_f32_sweep.cu) the d <= 40 and d <= 80 classes at every
// configuration of tools/bench_sweep_attn.py:F32_CONFIGS.  Any other
// configuration returns cudaErrorInvalidValue.
cudaError_t dispatch(const Params& p, int batch, int bq, int bk, int nbuf, cudaStream_t s) {
  const int key = tiles_key(bq, bk, nbuf);
#ifndef FLASH_FWD_F32_SWEEP
  if (p.d <= 40) {
    if (key == tiles_key(192, 64, 2)) return launch<Q40<192, 64, 2>>(p, batch, s);
  } else if (p.d <= 80) {
    if (key == tiles_key(128, 32, 2)) return launch<Q80<128, 32, 2>>(p, batch, s);
  } else if (key == tiles_key(64, 32, 1)) {
    return launch<Q160<64, 32, 1>>(p, batch, s);
  }
#else
  if (p.d <= 40) switch (key) {
      case tiles_key(64, 32, 2): return launch<Q40<64, 32, 2>>(p, batch, s);
      case tiles_key(64, 64, 2): return launch<Q40<64, 64, 2>>(p, batch, s);
      case tiles_key(128, 32, 2): return launch<Q40<128, 32, 2>>(p, batch, s);
      case tiles_key(128, 64, 2): return launch<Q40<128, 64, 2>>(p, batch, s);
      case tiles_key(192, 32, 2): return launch<Q40<192, 32, 2>>(p, batch, s);
      case tiles_key(192, 64, 2): return launch<Q40<192, 64, 2>>(p, batch, s);
    }
  else if (p.d <= 80) switch (key) {
      case tiles_key(64, 32, 2): return launch<Q80<64, 32, 2>>(p, batch, s);
      case tiles_key(128, 32, 2): return launch<Q80<128, 32, 2>>(p, batch, s);
      case tiles_key(128, 64, 1): return launch<Q80<128, 64, 1>>(p, batch, s);
      case tiles_key(192, 32, 1): return launch<Q80<192, 32, 1>>(p, batch, s);
    }
#endif
  return cudaErrorInvalidValue;
}

}  // namespace f32qm
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
// head and row stride a multiple of 4 elements (the wrapper checks), which
// is what TMA takes of an fp32 operand.  (bq, bk, stages): the tile
// configuration, which names the kernel: d <= 160 runs
// flash_fwd_f32_qm_kernel at a configuration this library holds
// (f32qm::dispatch), d > 160 flash_fwd_f32_kernel at its one configuration
// (32 queries, 128 keys, 4 stages); anything else returns
// cudaErrorInvalidValue.
extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v, const float* bias,
                             void* o, float* lse, int batch, int heads, int n, int m, int d,
                             long long q_sb, long long q_sh, long long q_sn, long long k_sb,
                             long long k_sh, long long k_sn, long long v_sb, long long v_sh,
                             long long v_sn, long long o_sb, long long o_sh, long long o_sn,
                             long long bias_sb, float scale, int bq, int bk, int stages,
                             void* stream) {
  if (d < 4 || d > 32 * f32::kMaxSlices || d % 4 || n < 1 || m < 1 || batch < 1)
    return (int)cudaErrorInvalidValue;
  if (d <= 160) {
    f32qm::Params p;
    p.q = static_cast<const float*>(q);
    p.k = static_cast<const float*>(k);
    p.v = static_cast<const float*>(v);
    p.bias = bias;
    p.o = static_cast<float*>(o);
    p.lse = lse;
    p.heads = heads, p.n = n, p.m = m, p.d = d;
    p.q_sb = q_sb, p.q_sh = q_sh, p.q_sn = q_sn;
    p.k_sb = k_sb, p.k_sh = k_sh, p.k_sn = k_sn;
    p.v_sb = v_sb, p.v_sh = v_sh, p.v_sn = v_sn;
    p.o_sb = o_sb, p.o_sh = o_sh, p.o_sn = o_sn;
    p.bias_sb = bias_sb;
    p.scale_log2 = scale * kLog2e;
    return (int)f32qm::dispatch(p, batch, bq, bk, stages, static_cast<cudaStream_t>(stream));
  }
  if (tiles_key(bq, bk, stages) != tiles_key(f32::kBQ, f32::kKeys, f32::kStages))
    return (int)cudaErrorInvalidValue;
  f32::Params p;
  p.q = static_cast<const float*>(q);
  p.bias = bias;
  p.o = static_cast<float*>(o);
  p.lse = lse;
  p.heads = heads, p.n = n, p.m = m, p.d = d;
  p.q_sb = q_sb, p.q_sh = q_sh, p.q_sn = q_sn;
  p.o_sb = o_sb, p.o_sh = o_sh, p.o_sn = o_sn;
  p.bias_sb = bias_sb;
  p.scale_log2 = scale * kLog2e;
  if (!make_map(&p.tk, k, d, heads, m, batch, k_sh, k_sn, k_sb, 64, 4) ||
      !(d % 32 ? make_map(&p.tv, v, d, heads, m, batch, v_sh, v_sn, v_sb, 8, 4)
               : f32::make_map_v5(&p.tv5, v, d, heads, m, batch, v_sh, v_sn, v_sb)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(f32::flash_fwd_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, f32::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + f32::kBQ - 1) / f32::kBQ, heads, batch);
  f32::flash_fwd_f32_kernel<<<grid, f32::kThreads, f32::kSmem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
#endif
