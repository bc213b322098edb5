// Flash-attention backward for Hopper (sm_90a): dq, and dk/dv (+ dbias), bf16
// in / bf16 out, fp32 probabilities and score gradients.
//
// Replaces the TPU Pallas backward of gligen_tpu/ops/pallas_attention.py:
//   * _flash_bwd (:583-701): the dq pallas_call at :627 over _bwd_dq_kernel
//     :491, and the dk/dv(/dbias) pallas_call at :684 over _bwd_dkv_kernel
//     :521, for the (B*H, N, D) layout;
//   * _flash_packed_bwd (:953-1086): the same kernel bodies at :1004 and
//     :1063 over the packed (B, N, H*C) layout, reached from
//     flash_attention_packed :1093 -- UNet attn1, the gated fuser's N+30
//     keys and the 77-token cross-attention.
// With s = scale q.k + bias (natural log units), P = softmax_j(s), the
// forward's LSE in LOG2 units and delta_i = sum_c dO_ic O_ic (computed by the
// caller), both kernels recompute
//   P_ij  = exp2(s_ij log2e - lse_i),   dS_ij = P_ij (dO_i . v_j - delta_i)
// and accumulate
//   dq_i = scale sum_j dS_ij k_j                     (flash_bwd_dq_kernel)
//   dv_j = sum_i P_ij dO_i,  dk_j = scale sum_i dS_ij q_i,
//   dbias_j (per head) = sum_i dS_ij                 (flash_bwd_dkv_kernel)
// The caller sums dbias over heads (the bias is shared by the heads), as
// pallas_attention.py:1078 does.
//
// What bounds it on the H100.  The training shapes do many operations per
// byte: ds1 attn1 (4 x 8 heads x 4096 x 4096 x d 40) is 3 products of 42.9
// GFLOP for dq and 4 for dk/dv over ~60 MB, so the bound is the tensor
// cores' (0.13 + 0.17 ms at 989 TFLOP/s).  As in the forward (flash_fwd.cu),
// at d = 40 a score costs ~130 (dq) or ~180 (dk/dv) tensor-core
// multiply-adds but one exp2 on the 16-lane special-function unit and a few
// fp32 operations, so exp2 and the fp32 work pace ds1 (~0.15 ms of exp2 per
// kernel), with the products behind them.
//
// Two kernels, so that neither needs atomics and two runs give the same
// bits: each recomputes S and dP (7 products in all, against 5 for one
// fused pass whose dq would be summed by atomics).  Both have the forward's
// structure (flash_fwd.cu), built from hopper.cuh:
//   * one producer warp and two consumer warpgroups (one at d = 160 for
//     dq).  The producer is a single warp, placed after the consumers so
//     that they stay aligned warpgroups.  That leaves no idle producer
//     threads, but buys no registers: the ninth warp shares one of the SM's
//     four 16K-register sub-partitions with two others, so 288 threads get
//     at most 168 registers each, as 384 do (a 224-register build fails to
//     launch).  The tile table (BWD_TILES) keeps every class free of
//     spills;
//   * the producer loads a fixed pair of 128 (or 64) rows once and streams
//     a pair of tiles through a ring of STAGES shared-memory stages by TMA
//     with mbarriers ("full": the TMA bytes arrived; "empty": every consumer
//     thread is done with the stage), 128-byte swizzled in 64-column atoms,
//     from 4-D (head dim, head, row, batch) tensor maps that zero-fill the
//     columns d..63 and the rows past N or M.  With each tile it writes a
//     side vector of fp32 per tile row into the stage (a "side" barrier,
//     one arrival per producer lane): plain loads, since the (B, H, N)
//     rows of the LSE and delta are not 16-byte aligned when N % 4 != 0;
//   * dq: the fixed pair is Q and dO (64 query rows per consumer
//     warpgroup), the tiles K and V (BK keys), the side vector the key
//     tile's bias in log2 units, -inf for keys at or past M (so P = 0
//     there: TMA's zero fill alone would give s = 0 and P != 0).  Per tile
//     S = Q K^T and dP = dO V^T are wgmma m64nBKk16 from shared memory into
//     registers; P = exp2(S scale log2e + bias - lse) and dS = P (dP -
//     delta) in fp32 registers, each thread's two rows' lse and delta held
//     in registers; dS, rounded to bf16, is wgmma's A fragment straight
//     from S's accumulator layout, and dQ += dS K reads the same K stage
//     MN-major (the forward's V descriptor).  dQ stays in fp32 registers for
//     the whole key loop, is scaled once and stored for rows < N;
//   * dk/dv, the same transposed so that keys are wgmma's 64 M rows: the
//     fixed pair is K and V (64 keys per warpgroup), the tiles Q and dO
//     (BQ queries), the side vectors the query tile's lse and delta (+inf
//     and 0 past N: P = 0).  S^T = K Q^T and dP^T = V dO^T (the Q and dO stages K-major), P^T
//     and dS^T with the bias a constant per thread row, dV += P^T dO and dK
//     += dS^T Q (the same stages read MN-major); dbias is the row sums of
//     the fp32 dS^T, summed by each thread in a fixed order and across the
//     quad once at the end.  At d = 160 one warpgroup cannot hold dK and dV
//     (2 x 80 registers) beside S^T and dP^T, so two warpgroups share the
//     same 64 keys: one computes S^T and accumulates dV, the other S^T and
//     dP^T and accumulates dK and dbias (SPLIT = 2);
//   * nothing of S, P, dP, dS, dQ, dK or dV passes through shared memory;
//   * inputs TMA cannot take (a base not 16-byte aligned, a row or batch
//     stride not a multiple of 8 elements, d not a multiple of 8) take the
//     copy route: the producer warp fills the same swizzled stages with
//     plain loads, orders them for the tensor cores with a proxy fence, and
//     arrives on the same barriers (32 arrivals instead of TMA's one).  The
//     wrapper chooses the route from the layout (ops/flash_attention.py:
//     tma_ok) and counts launches per route.
//
// The tile configuration per head-dim class comes from the wrapper's fixed
// table (ops/flash_attention.py:BWD_TILES), which this library is built at
// (dispatch below); flash_bwd_sweep.cu builds every class at the
// configurations of tools/bench_sweep_attn.py --bwd.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "hopper.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kMaxD = 160;

// strides[] as the host passes them: (batch, head, row) of each tensor, in
// this order, then the bias row stride.
enum { kQ = 0, kK = 3, kV = 6, kDO = 9, kDQ = 12, kDK = 15, kDV = 18, kBiasRow = 21, kStrides = 22 };

struct Params {
  CUtensorMap tq, tk, tv, tdo;  // TMA route: (d, head, row, batch) maps
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* bias;   // (B, M) rows at stride s[kBiasRow], natural-log units, or null
  const float* lse;    // (B, H, N) contiguous, log2 units
  const float* delta;  // (B, H, N) contiguous
  bf16* dq;
  bf16* dk;
  bf16* dv;
  float* dbias;  // (B, H, M) contiguous, or null
  int heads, n, m, d;
  long long s[kStrides];
  float scale, scale_log2;
  int tma;    // 1: every bf16 operand by TMA; 0: plain copies by the producer
  int pairs;  // 1: the gradients' rows and columns allow bf16x2 stores
};

// DK: QK depth (d padded to 16); NV: width of the accumulated gradient;
// ATOMS: 64-column swizzle atoms per tile row; ROWWG: warpgroups owning
// distinct 64-row slabs of the fixed pair; SPLIT: warpgroups sharing one
// slab (dk/dv at d = 160: one accumulates dV, the other dK); TILE: rows of a
// streamed tile; STAGES: ring stages.
template <int DK_, int NV_, int ATOMS_, int ROWWG_, int SPLIT_, int TILE_, int STAGES_>
struct Cfg {
  static constexpr int DK = DK_, NV = NV_, ATOMS = ATOMS_, ROWWG = ROWWG_, SPLIT = SPLIT_;
  static constexpr int ROWS = 64 * ROWWG, TILE = TILE_, STAGES = STAGES_;
  static constexpr int kConsumers = ROWWG * SPLIT;
  static constexpr int kThreads = 128 * kConsumers + 32;
  static constexpr int kFixedBytes = ATOMS * ROWS * 128;  // one of the fixed pair
  static constexpr int kTileBytes = ATOMS * TILE * 128;   // one of a stage's pair
  static constexpr int kSideOffset = 2 * kFixedBytes + 2 * STAGES * kTileBytes;
  static constexpr int kBarOffset = kSideOffset + STAGES * 2 * TILE * 4;
  static constexpr int kSmem = kBarOffset + 8 * (1 + 3 * STAGES) + 1024;  // + alignment slack
  static_assert(DK % 16 == 0 && DK <= ATOMS * 64, "QK depth");
  static_assert(NV % 8 == 0 && NV <= ATOMS * 64, "gradient width");
  static_assert(TILE % 16 == 0 && TILE <= 256 && ROWS <= 256, "TMA box rows");
  static_assert(kSmem <= 232448, "shared memory");
};

// The shared-memory carve-up and barriers of a block: the fixed pair (A, B),
// the ring's pairs, the side vectors (2 x TILE floats a stage) and the
// barriers: "once" (the fixed pair), then full, side and empty per stage.
template <class C>
struct Smem {
  uint8_t* fixed_a;
  uint8_t* fixed_b;
  uint8_t* ring_a;
  uint8_t* ring_b;
  float* side;
  uint32_t bars;
  __device__ explicit Smem(uint8_t* raw) {
    uint8_t* base = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
    fixed_a = base;
    fixed_b = base + C::kFixedBytes;
    ring_a = base + 2 * C::kFixedBytes;
    ring_b = ring_a + C::STAGES * C::kTileBytes;
    side = reinterpret_cast<float*>(base + C::kSideOffset);
    bars = smem_u32(base + C::kBarOffset);
  }
  __device__ uint32_t once() const { return bars; }
  __device__ uint32_t full(int s) const { return bars + 8 * (1 + s); }
  __device__ uint32_t side_full(int s) const { return bars + 8 * (1 + C::STAGES + s); }
  __device__ uint32_t empty(int s) const { return bars + 8 * (1 + 2 * C::STAGES + s); }

  // Thread 0 sets the barriers' arrival counts: one TMA arrival, or every
  // producer lane on the copy route; every producer lane for the side
  // vectors; every consumer thread for "empty".
  __device__ void init(int tma) const {
    if (threadIdx.x == 0) {
      const uint32_t arrivals = tma ? 1 : 32;
      mbar_init(once(), arrivals);
      for (int s = 0; s < C::STAGES; ++s) {
        mbar_init(full(s), arrivals);
        mbar_init(side_full(s), 32);
        mbar_init(empty(s), 128 * C::kConsumers);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
};

// The producer warp's loads of one (row-strided) operand pair: `rows` rows
// from row `row0` of (batch b, head h), by TMA on `bar` (lane 0; the caller
// expects the bytes) or by plain copies of every lane.
template <class C>
__device__ __forceinline__ void load_pair(const Params& p, uint8_t* dst_a, uint8_t* dst_b,
                                          const CUtensorMap* map_a, const CUtensorMap* map_b,
                                          const bf16* src_a, const bf16* src_b, int ia, int ib,
                                          int rows, int row0, int len, int h, int b, uint32_t bar,
                                          int lane) {
  if (p.tma) {
    if (lane == 0) {
      mbar_expect_tx(bar, 2 * C::ATOMS * rows * 128);
      for (int a = 0; a < C::ATOMS; ++a) {
        tma_load_4d(smem_u32(dst_a + a * rows * 128), map_a, bar, 64 * a, h, row0, b);
        tma_load_4d(smem_u32(dst_b + a * rows * 128), map_b, bar, 64 * a, h, row0, b);
      }
    }
  } else {
    const int valid = min(rows, len - row0);
    copy_tile<C::ATOMS, 32>(dst_a, rows, src_a + b * p.s[ia] + h * p.s[ia + 1] + row0 * p.s[ia + 2],
                            p.s[ia + 2], valid, p.d, lane);
    copy_tile<C::ATOMS, 32>(dst_b, rows, src_b + b * p.s[ib] + h * p.s[ib + 1] + row0 * p.s[ib + 2],
                            p.s[ib + 2], valid, p.d, lane);
    fence_proxy_async();
    mbar_arrive(bar);
  }
}

// The two rows (r0, r0 + 8) of a warpgroup's 64-row accumulator fragment
// that this thread holds, times `mul`, as bf16 into a row-strided matrix:
// rows < valid and columns < d only.
template <int NV>
__device__ __forceinline__ void store_rows(const float (&acc)[NV / 2], bf16* base, long long sn,
                                           int r0, int valid, int d, float mul, int quad,
                                           int pairs) {
#pragma unroll
  for (int j = 0; j < NV / 8; ++j) {
    const int col = 8 * j + 2 * quad;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half;
      if (r >= valid || col >= d) continue;
      const float x0 = acc[4 * j + 2 * half] * mul, x1 = acc[4 * j + 2 * half + 1] * mul;
      bf16* dst = base + r * sn + col;
      if (pairs) {
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);
      } else {
        dst[0] = __float2bfloat16(x0);
        if (col + 1 < d) dst[1] = __float2bfloat16(x1);
      }
    }
  }
}

// A = (kk-th 16-column step of) a 64-row K-major slab at `base`, in atoms of
// `rows` rows; the same for B over a tile.
__device__ __forceinline__ uint64_t kmajor(uint32_t base, int rows, int kk) {
  return sw128_desc(base + (kk / 4) * rows * 128 + (kk % 4) * 32, 16, 1024);
}

// B = the kk-th 16-row step of a tile of `rows` rows read MN-major (its
// columns are the product's N).
__device__ __forceinline__ uint64_t mnmajor(uint32_t base, int rows, int kk) {
  return sw128_desc(base + kk * 16 * 128, rows * 128, 1024);
}

// An fp32 accumulator fragment (m64nN) as bf16 A fragments of the next
// product: k-step kk is the fragment's n8 blocks 2kk and 2kk+1.
template <int N>
__device__ __forceinline__ void pack_a(const float (&x)[N / 2], uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(x[8 * kk + 0], x[8 * kk + 1]);
    a[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// ------------------------------------------------------------ dq

template <class C>
__global__ void __launch_bounds__(C::kThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const Smem<C> sm(smem_raw);  // fixed: Q, dO; ring: K, V; side: the key tile's bias
  const int q0 = blockIdx.x * C::ROWS, h = blockIdx.y, b = blockIdx.z;
  const int ntiles = (p.m + C::TILE - 1) / C::TILE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  sm.init(p.tma);

  if (warp == 4 * C::kConsumers) {
    // ---------------- producer warp
    load_pair<C>(p, sm.fixed_a, sm.fixed_b, &p.tq, &p.tdo, p.q, p.dout, kQ, kDO, C::ROWS, q0, p.n,
                 h, b, sm.once(), lane);
    const float* bias = p.bias ? p.bias + b * p.s[kBiasRow] : nullptr;
    for (int it = 0; it < ntiles; ++it) {
      const int s = it % C::STAGES, k0 = it * C::TILE;
      mbar_wait(sm.empty(s), ((it / C::STAGES) & 1) ^ 1);
      load_pair<C>(p, sm.ring_a + s * C::kTileBytes, sm.ring_b + s * C::kTileBytes, &p.tk, &p.tv,
                   p.k, p.v, kK, kV, C::TILE, k0, p.m, h, b, sm.full(s), lane);
      float* side = sm.side + s * 2 * C::TILE;
      for (int j = lane; j < C::TILE; j += 32)
        side[j] = k0 + j < p.m ? (bias ? bias[k0 + j] * kLog2e : 0.0f) : -INFINITY;
      mbar_arrive(sm.side_full(s));
    }
    return;
  }

  // ---------------- consumer warpgroups: 64 query rows each
  const int wg = warp / 4, t = threadIdx.x % 128, w = t / 32, quad = lane % 4;
  const int r0 = q0 + wg * 64 + w * 16 + lane / 4, r1 = r0 + 8;
  const float* lse = p.lse + ((long long)b * p.heads + h) * p.n;
  const float* delta = p.delta + ((long long)b * p.heads + h) * p.n;
  // rows past N are never stored: any finite lse and delta will do there
  const float lse0 = r0 < p.n ? lse[r0] : 0.0f, lse1 = r1 < p.n ? lse[r1] : 0.0f;
  const float dl0 = r0 < p.n ? delta[r0] : 0.0f, dl1 = r1 < p.n ? delta[r1] : 0.0f;
  const uint32_t q_base = smem_u32(sm.fixed_a) + wg * 64 * 128;
  const uint32_t do_base = smem_u32(sm.fixed_b) + wg * 64 * 128;

  float acc[C::NV / 2];
#pragma unroll
  for (int i = 0; i < C::NV / 2; ++i) acc[i] = 0.0f;
  float s[C::TILE / 2], dp[C::TILE / 2];

  mbar_wait(sm.once(), 0);
  for (int it = 0; it < ntiles; ++it) {
    const int st = it % C::STAGES;
    const uint32_t parity = (it / C::STAGES) & 1;
    mbar_wait(sm.full(st), parity);
    uint32_t k_base = smem_u32(sm.ring_a + st * C::kTileBytes);
    uint32_t v_base = smem_u32(sm.ring_b + st * C::kTileBytes);
    uint32_t qb = q_base, dob = do_base;
    // opaque to the compiler: the descriptors are rebuilt each tile (an
    // add each) instead of being hoisted out of the loop into registers
    asm volatile("" : "+r"(qb), "+r"(dob), "+r"(k_base), "+r"(v_base));

    // S = Q K^T and dP = dO V^T (all K-major)
    pin(s);
    pin(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::DK / 16; ++kk)
      Wgmma<C::TILE>::template ss<0>(s, kmajor(qb, C::ROWS, kk), kmajor(k_base, C::TILE, kk),
                                     kk > 0);
#pragma unroll
    for (int kk = 0; kk < C::DK / 16; ++kk)
      Wgmma<C::TILE>::template ss<0>(dp, kmajor(dob, C::ROWS, kk), kmajor(v_base, C::TILE, kk),
                                     kk > 0);
    wgmma_commit();
    mbar_wait(sm.side_full(st), parity);
    wgmma_wait_all();
    pin(s);
    pin(dp);

    // P and dS = P (dP - delta) in place of S; the side vector masks keys >= M
    const float* side = sm.side + st * 2 * C::TILE;
#pragma unroll
    for (int j = 0; j < C::TILE / 8; ++j) {
      const float2 bb = *reinterpret_cast<const float2*>(side + 8 * j + 2 * quad);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float bcol = e ? bb.y : bb.x;
        const float p0 = ex2(fmaf(s[4 * j + e], p.scale_log2, bcol - lse0));
        const float p1 = ex2(fmaf(s[4 * j + 2 + e], p.scale_log2, bcol - lse1));
        s[4 * j + e] = p0 * (dp[4 * j + e] - dl0);
        s[4 * j + 2 + e] = p1 * (dp[4 * j + 2 + e] - dl1);
      }
    }
    uint32_t dsa[C::TILE / 16][4];
    pack_a<C::TILE>(s, dsa);

    // dQ += dS K (K MN-major: 16 keys of 128-byte rows per step)
    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::TILE / 16; ++kk)
      WgmmaRs<C::NV>::template rs<1>(acc, dsa[kk], mnmajor(k_base, C::TILE, kk), 1);
    wgmma_commit();
    wgmma_wait_all();
    pin(acc);
    mbar_arrive(sm.empty(st));
  }

  bf16* dq = p.dq + b * p.s[kDQ] + h * p.s[kDQ + 1];
  store_rows<C::NV>(acc, dq, p.s[kDQ + 2], r0, p.n, p.d, p.scale, quad, p.pairs);
}

// ------------------------------------------------------------ dk/dv

// One consumer warpgroup's pass over every query tile, for 64 keys: dV when
// ACC_DV, dK and dbias when ACC_DK.
template <class C, bool ACC_DV, bool ACC_DK>
__device__ __forceinline__ void dkv_consumer(const Params& p, const Smem<C>& sm, int key0, int h,
                                             int b, int ntiles, uint32_t k_base, uint32_t v_base) {
  const int t = threadIdx.x % 128, w = t / 32, lane = t % 32, quad = lane % 4;
  const int r0 = key0 + w * 16 + lane / 4, r1 = r0 + 8;
  // the bias is per key row: one constant per thread row (log2 units)
  const float* bias = p.bias ? p.bias + b * p.s[kBiasRow] : nullptr;
  const float b0 = bias && r0 < p.m ? bias[r0] * kLog2e : 0.0f;
  const float b1 = bias && r1 < p.m ? bias[r1] * kLog2e : 0.0f;

  float dv[ACC_DV ? C::NV / 2 : 1], dk[ACC_DK ? C::NV / 2 : 1];
#pragma unroll
  for (int i = 0; i < C::NV / 2; ++i) {
    if constexpr (ACC_DV) dv[i] = 0.0f;
    if constexpr (ACC_DK) dk[i] = 0.0f;
  }
  float db0 = 0.0f, db1 = 0.0f;
  float s[C::TILE / 2], dp[ACC_DK ? C::TILE / 2 : 1];

  mbar_wait(sm.once(), 0);
  for (int it = 0; it < ntiles; ++it) {
    const int st = it % C::STAGES;
    const uint32_t parity = (it / C::STAGES) & 1;
    mbar_wait(sm.full(st), parity);
    uint32_t q_t = smem_u32(sm.ring_a + st * C::kTileBytes);
    uint32_t do_t = smem_u32(sm.ring_b + st * C::kTileBytes);
    uint32_t kb = k_base, vb = v_base;
    asm volatile("" : "+r"(kb), "+r"(vb), "+r"(q_t), "+r"(do_t));

    // S^T = K Q^T and dP^T = V dO^T (all K-major)
    pin(s);
    if constexpr (ACC_DK) pin(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::DK / 16; ++kk)
      Wgmma<C::TILE>::template ss<0>(s, kmajor(kb, C::ROWS, kk), kmajor(q_t, C::TILE, kk),
                                     kk > 0);
    if constexpr (ACC_DK) {
#pragma unroll
      for (int kk = 0; kk < C::DK / 16; ++kk)
        Wgmma<C::TILE>::template ss<0>(dp, kmajor(vb, C::ROWS, kk), kmajor(do_t, C::TILE, kk),
                                       kk > 0);
    }
    wgmma_commit();
    mbar_wait(sm.side_full(st), parity);
    wgmma_wait_all();
    pin(s);
    if constexpr (ACC_DK) pin(dp);

    // P^T in s, dS^T in dp; the side vectors (lse +inf past N) mask queries >= N
    const float* lse = sm.side + st * 2 * C::TILE;
    const float* delta = lse + C::TILE;
#pragma unroll
    for (int j = 0; j < C::TILE / 8; ++j) {
      const float2 ll = *reinterpret_cast<const float2*>(lse + 8 * j + 2 * quad);
      const float2 dd = *reinterpret_cast<const float2*>(delta + 8 * j + 2 * quad);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float l = e ? ll.y : ll.x;
        const float p0 = ex2(fmaf(s[4 * j + e], p.scale_log2, b0 - l));
        const float p1 = ex2(fmaf(s[4 * j + 2 + e], p.scale_log2, b1 - l));
        s[4 * j + e] = p0;
        s[4 * j + 2 + e] = p1;
        if constexpr (ACC_DK) {
          const float dl = e ? dd.y : dd.x;
          const float ds0 = p0 * (dp[4 * j + e] - dl), ds1 = p1 * (dp[4 * j + 2 + e] - dl);
          dp[4 * j + e] = ds0;
          dp[4 * j + 2 + e] = ds1;
          db0 += ds0;
          db1 += ds1;
        }
      }
    }

    // dV += P^T dO and dK += dS^T Q (the tiles MN-major)
    uint32_t pa[C::TILE / 16][4], dsa[ACC_DK ? C::TILE / 16 : 1][4];
    if constexpr (ACC_DV) pack_a<C::TILE>(s, pa);
    if constexpr (ACC_DK) pack_a<C::TILE>(dp, dsa);
    if constexpr (ACC_DV) pin(dv);
    if constexpr (ACC_DK) pin(dk);
    wgmma_fence();
    if constexpr (ACC_DV) {
#pragma unroll
      for (int kk = 0; kk < C::TILE / 16; ++kk)
        WgmmaRs<C::NV>::template rs<1>(dv, pa[kk], mnmajor(do_t, C::TILE, kk), 1);
    }
    if constexpr (ACC_DK) {
#pragma unroll
      for (int kk = 0; kk < C::TILE / 16; ++kk)
        WgmmaRs<C::NV>::template rs<1>(dk, dsa[kk], mnmajor(q_t, C::TILE, kk), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    if constexpr (ACC_DV) pin(dv);
    if constexpr (ACC_DK) pin(dk);
    mbar_arrive(sm.empty(st));
  }

  if constexpr (ACC_DV) {
    bf16* out = p.dv + b * p.s[kDV] + h * p.s[kDV + 1];
    store_rows<C::NV>(dv, out, p.s[kDV + 2], r0, p.m, p.d, 1.0f, quad, p.pairs);
  }
  if constexpr (ACC_DK) {
    bf16* out = p.dk + b * p.s[kDK] + h * p.s[kDK + 1];
    store_rows<C::NV>(dk, out, p.s[kDK + 2], r0, p.m, p.d, p.scale, quad, p.pairs);
    // each row's sum over its quad's columns, in a fixed order
    db0 = quad_sum(db0);
    db1 = quad_sum(db1);
    if (p.dbias && quad == 0) {
      float* out_b = p.dbias + ((long long)b * p.heads + h) * p.m;
      if (r0 < p.m) out_b[r0] = db0;
      if (r1 < p.m) out_b[r1] = db1;
    }
  }
}

template <class C>
__global__ void __launch_bounds__(C::kThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const Smem<C> sm(smem_raw);  // fixed: K, V; ring: Q, dO; side: the query tile's lse, delta
  const int k0 = blockIdx.x * C::ROWS, h = blockIdx.y, b = blockIdx.z;
  const int ntiles = (p.n + C::TILE - 1) / C::TILE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  sm.init(p.tma);

  if (warp == 4 * C::kConsumers) {
    // ---------------- producer warp
    load_pair<C>(p, sm.fixed_a, sm.fixed_b, &p.tk, &p.tv, p.k, p.v, kK, kV, C::ROWS, k0, p.m, h,
                 b, sm.once(), lane);
    const long long rows = ((long long)b * p.heads + h) * p.n;
    for (int it = 0; it < ntiles; ++it) {
      const int s = it % C::STAGES, q0 = it * C::TILE;
      mbar_wait(sm.empty(s), ((it / C::STAGES) & 1) ^ 1);
      load_pair<C>(p, sm.ring_a + s * C::kTileBytes, sm.ring_b + s * C::kTileBytes, &p.tq, &p.tdo,
                   p.q, p.dout, kQ, kDO, C::TILE, q0, p.n, h, b, sm.full(s), lane);
      float* side = sm.side + s * 2 * C::TILE;
      for (int j = lane; j < C::TILE; j += 32) {
        const bool valid = q0 + j < p.n;
        side[j] = valid ? p.lse[rows + q0 + j] : INFINITY;
        side[C::TILE + j] = valid ? p.delta[rows + q0 + j] : 0.0f;
      }
      mbar_arrive(sm.side_full(s));
    }
    return;
  }

  // ---------------- consumer warpgroups
  const int wg = warp / 4, rs = wg / C::SPLIT, cs = wg % C::SPLIT;
  const uint32_t k_base = smem_u32(sm.fixed_a) + rs * 64 * 128;
  const uint32_t v_base = smem_u32(sm.fixed_b) + rs * 64 * 128;
  const int key0 = k0 + rs * 64;
  if constexpr (C::SPLIT == 1)
    dkv_consumer<C, true, true>(p, sm, key0, h, b, ntiles, k_base, v_base);
  else if (cs == 0)
    dkv_consumer<C, true, false>(p, sm, key0, h, b, ntiles, k_base, v_base);
  else
    dkv_consumer<C, false, true>(p, sm, key0, h, b, ntiles, k_base, v_base);
}

// ------------------------------------------------------------ host side

// What TMA takes: every bf16 operand as hopper.cuh:tma_operand_ok has it.
bool tma_ok(const Params& p) {
  const bf16* ptrs[4] = {p.q, p.k, p.v, p.dout};
  const int at[4] = {kQ, kK, kV, kDO};
  for (int i = 0; i < 4; ++i)
    if (!tma_operand_ok(ptrs[i], p.d, p.s[at[i] + 1], p.s[at[i]], p.s[at[i] + 2])) return false;
  return true;
}

bool map_of(CUtensorMap* map, const Params& p, const bf16* base, int i, int len, int batch,
            int rows) {
  return make_map(map, base, p.d, p.heads, len, batch, p.s[i + 1], p.s[i + 2], p.s[i], rows);
}

template <class C, class Kernel>
cudaError_t run(Kernel kernel, int blocks, int batch, const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         C::kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(blocks, p.heads, batch), C::kThreads, C::kSmem, stream>>>(p);
  return cudaGetLastError();
}

// DQ: the dq kernel (fixed Q, dO; tiles of keys), else dk/dv (fixed K, V;
// tiles of queries).
template <class C, bool DQ>
cudaError_t launch(Params& p, int batch, cudaStream_t stream) {
  const int qrows = DQ ? C::ROWS : C::TILE, krows = DQ ? C::TILE : C::ROWS;
  if (p.tma && !(tma_ok(p) && map_of(&p.tq, p, p.q, kQ, p.n, batch, qrows) &&
                 map_of(&p.tdo, p, p.dout, kDO, p.n, batch, qrows) &&
                 map_of(&p.tk, p, p.k, kK, p.m, batch, krows) &&
                 map_of(&p.tv, p, p.v, kV, p.m, batch, krows)))
    return cudaErrorInvalidValue;
  if constexpr (DQ)
    return run<C>(flash_bwd_dq_kernel<C>, (p.n + C::ROWS - 1) / C::ROWS, batch, p, stream);
  else
    return run<C>(flash_bwd_dkv_kernel<C>, (p.m + C::ROWS - 1) / C::ROWS, batch, p, stream);
}

// The head-dim classes: dq at (BQ query rows, BK keys, stages), dk/dv at
// (BK keys, BQ query rows, stages); at d = 160 dk/dv splits 64 keys over
// two warpgroups.
template <int BQ, int BK, int ST>
using Dq40 = Cfg<48, 40, 1, BQ / 64, 1, BK, ST>;
template <int BQ, int BK, int ST>
using Dq80 = Cfg<80, 80, 2, BQ / 64, 1, BK, ST>;
template <int BQ, int BK, int ST>
using Dq160 = Cfg<160, 160, 3, BQ / 64, 1, BK, ST>;
template <int BK, int BQ, int ST>
using Dkv40 = Cfg<48, 40, 1, BK / 64, 1, BQ, ST>;
template <int BK, int BQ, int ST>
using Dkv80 = Cfg<80, 80, 2, BK / 64, 1, BQ, ST>;
template <int BK, int BQ, int ST>
using Dkv160 = Cfg<160, 160, 3, BK / 64, 2, BQ, ST>;

// The configurations each library holds, per kernel and class, as X-macro
// lists of (rows, tile, stages): the serving library the wrapper's table
// (ops/flash_attention.py:BWD_TILES), the sweep library (flash_bwd_sweep.cu)
// tools/bench_sweep_attn.py:BWD_CONFIGS.
#ifndef FLASH_BWD_SWEEP
#define DQ40(X) X(128, 64, 3)
#define DKV40(X) X(128, 64, 3)
#define DQ80(X) X(128, 64, 2)
#define DKV80(X) X(64, 64, 2)
#define DQ160(X) X(64, 64, 2)
#define DKV160(X) X(64, 32, 3)
#else
#define DQ40(X) X(64, 64, 2) X(128, 64, 2) X(128, 64, 3) X(128, 128, 2)
#define DKV40(X) X(64, 64, 2) X(128, 64, 2) X(128, 64, 3) X(128, 32, 2)
#define DQ80(X) X(64, 64, 2) X(128, 64, 2) X(128, 64, 3) X(128, 128, 2)
#define DKV80(X) X(64, 64, 2) X(128, 64, 2) X(128, 64, 3) X(128, 32, 2)
#define DQ160(X) X(64, 64, 2) X(128, 64, 2) X(128, 32, 2)
#define DKV160(X) X(64, 64, 2) X(64, 32, 2) X(64, 32, 3)
#endif

constexpr int tiles_key(int rows, int tile, int stages) { return (rows * 1000 + tile) * 10 + stages; }

// Launch the dq kernel (DQ) or the dk/dv kernel of p.d's head-dim class at
// (rows, tile, stages), if this library holds that configuration (the
// lists above).  Any other returns cudaErrorInvalidValue.
template <bool DQ>
cudaError_t dispatch(Params& p, int batch, int rows, int tile, int stages, cudaStream_t s) {
  const int key = tiles_key(rows, tile, stages);
#define CASE(CFG, R, T, ST) \
  case tiles_key(R, T, ST): return launch<CFG<R, T, ST>, DQ>(p, batch, s);
#define CASE_DQ40(R, T, ST) CASE(Dq40, R, T, ST)
#define CASE_DQ80(R, T, ST) CASE(Dq80, R, T, ST)
#define CASE_DQ160(R, T, ST) CASE(Dq160, R, T, ST)
#define CASE_DKV40(R, T, ST) CASE(Dkv40, R, T, ST)
#define CASE_DKV80(R, T, ST) CASE(Dkv80, R, T, ST)
#define CASE_DKV160(R, T, ST) CASE(Dkv160, R, T, ST)
  if constexpr (DQ) {
    if (p.d <= 40) {
      switch (key) { DQ40(CASE_DQ40) }
    } else if (p.d <= 80) {
      switch (key) { DQ80(CASE_DQ80) }
    } else {
      switch (key) { DQ160(CASE_DQ160) }
    }
  } else {
    if (p.d <= 40) {
      switch (key) { DKV40(CASE_DKV40) }
    } else if (p.d <= 80) {
      switch (key) { DKV80(CASE_DKV80) }
    } else {
      switch (key) { DKV160(CASE_DKV160) }
    }
  }
  return cudaErrorInvalidValue;
}

bool make_params(Params& p, const void* q, const void* k, const void* v, const void* dout,
                 const float* bias, const float* lse, const float* delta, int batch, int heads,
                 int n, int m, int d, const long long* strides, float scale, int tma) {
  if (d < 1 || d > kMaxD || n < 1 || m < 1 || batch < 1 || heads < 1) return false;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.dout = static_cast<const bf16*>(dout);
  p.bias = bias;
  p.lse = lse;
  p.delta = delta;
  p.dq = p.dk = p.dv = nullptr;
  p.dbias = nullptr;
  p.heads = heads;
  p.n = n;
  p.m = m;
  p.d = d;
  for (int i = 0; i < kStrides; ++i) p.s[i] = strides[i];
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  p.tma = tma;
  return true;
}

// bf16x2 stores need even columns, even strides and 4-byte aligned bases.
bool pairs_ok(const Params& p, const void* out, int i) {
  return p.d % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 4 == 0 && p.s[i] % 2 == 0 &&
         p.s[i + 1] % 2 == 0 && p.s[i + 2] % 2 == 0;
}

}  // namespace

// Plain C entry points for ctypes.  Each returns a cudaError_t (0 =
// launched).  Strides are in elements, kStrides of them in the order of the
// enum above (the unused outputs' may be 0).  tma: 1 for the TMA route (the
// caller checked tma_ok), 0 for the copy route.  The tile triple is the
// kernel's (dq: BQ, BK, stages; dk/dv: BK, BQ, stages), one this library
// holds (dispatch).  The caller checks shapes, dtypes and devices, and
// computes delta.
extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                                 const float* bias, const float* lse, const float* delta,
                                 void* dq, int batch, int heads, int n, int m, int d,
                                 const long long* strides, float scale, int tma, int bq, int bk,
                                 int stages, void* stream) {
  Params p;
  if (!make_params(p, q, k, v, dout, bias, lse, delta, batch, heads, n, m, d, strides, scale, tma))
    return (int)cudaErrorInvalidValue;
  p.dq = static_cast<bf16*>(dq);
  p.pairs = pairs_ok(p, dq, kDQ);
  return (int)dispatch<true>(p, batch, bq, bk, stages, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                                  const float* bias, const float* lse, const float* delta,
                                  void* dk, void* dv, float* dbias, int batch, int heads, int n,
                                  int m, int d, const long long* strides, float scale, int tma,
                                  int bk, int bq, int stages, void* stream) {
  Params p;
  if (!make_params(p, q, k, v, dout, bias, lse, delta, batch, heads, n, m, d, strides, scale, tma))
    return (int)cudaErrorInvalidValue;
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.dbias = dbias;
  p.pairs = pairs_ok(p, dk, kDK) && pairs_ok(p, dv, kDV);
  return (int)dispatch<false>(p, batch, bk, bq, stages, static_cast<cudaStream_t>(stream));
}
