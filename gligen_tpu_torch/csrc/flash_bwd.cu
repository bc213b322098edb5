// Flash-attention backward for Hopper (sm_90a): dq, and dk/dv (+ dbias), bf16
// in / bf16 out, fp32 probabilities and score gradients; and its fp32 route
// (fp32 in / out: 3xTF32 wgmma; "the fp32 route" below).
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
#include <type_traits>

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

// ------------------------------------------------------------ the fp32 route
//
// fp32 q/k/v/dO (a model trained in fp32: python -m gligen_tpu_torch.main
// --dtype float32), the same function as the TPU's _bwd_dq_kernel :491 and
// _bwd_dkv_kernel :521, which cast every operand to fp32 (behind the
// pallas_calls at pallas_attention.py:627/:684 and :1004/:1063).  fp32 in,
// fp32 out, from the fp32 forward's LSE (log2 units) and delta.
//
// What bounds it on the H100: the same 3 (dq) and 4 (dk/dv) products of
// 2 B H N M d operations, fp32-accurate.  As 3xTF32 on the tensor cores
// that is 3 x those operations at 495 TFLOP/s: at ds1 attn1 (4 x 8 heads x
// 4096^2 x d 40) 0.78 ms for dq and 1.04 ms for dk/dv (fp32 FMAs on the
// CUDA cores, at 67 TFLOP/s, could not go below 1.92 and 2.56 ms).
//
// Every head-dim class runs two 3xTF32 wgmma kernels, laid out as the
// fp32 forward's queries-as-rows kernel (flash_fwd.cu:
// flash_fwd_f32_qm_kernel): no producer warp and no TMA; the consumers
// load the next tile a tile ahead into registers and store it, split, into
// one of NBUF buffers under an mbarrier pair per buffer (full: every
// thread stored it; empty: every warp's products that read it completed),
// so the warpgroups run out of step.
//   * The split: x = hi + lo, hi = rna(x) (hopper.cuh:tf32), lo = x - hi,
//     which the tensor cores truncate to TF32; a b ~ hi hi + hi lo + lo hi
//     (gemm_tf32.cuh).  Every chain of products runs its hi.lo and lo.hi
//     steps first and its hi.hi steps last (fault F10: the tensor cores
//     truncate the running sum at every step, so small steps after a large
//     one each cost an ulp of it), and starts from zero: a score is one
//     chain of 3 D / 8 products (15, 30), a tile's part of a gradient one
//     chain of 3 x (tile / 8) (12, 24), added to the gradient in fp32, so
//     no chain runs over a whole key (or query) loop.
//   * TF32 wgmma reads both operands K-major, so every operand is stored in
//     the form its product reads: the products' K-major operands as
//     "quartets" (hi and lo of two matrices in 32-column atoms, 128-byte
//     swizzled; the columns past D / 32 whole atoms of the four halves
//     share tail atoms, so no atom holds columns past D: at d = 40 the four
//     halves take 5 atoms, not 8), and the operands of the products summed
//     over keys (or queries) transposed: rows = the head dim's D columns,
//     32-key atoms, the keys of each 8-key step in the order 0, 2, 4, 6, 1,
//     3, 5, 7, so that dS (and P) feed the RS wgmma straight from the
//     accumulator registers they were computed in (a thread holds keys 2t
//     and 2t + 1 of each step, where the TF32 A fragment reads k = t and
//     t + 4; flash_fwd.cu's V^T trick).  Nothing of S, P, dP or dS passes
//     through shared memory.
//   * dq (flash_bwd_dq_tf32_kernel): queries are the wgmma rows, 64 a
//     consumer warpgroup; Q and dO split once into a resident quartet.  Per
//     tile of BK keys: K and V as a quartet, K^T hi/lo, and the keys' bias
//     in log2 units (-inf at or past M: P = 0 there) as a side vector.  S =
//     Q K^T and dP = dO V^T from shared memory (SS); P = exp2(S scale log2e
//     + bias - lse) and dS = P (dP - delta) in fp32 registers (each row's
//     lse and delta in registers); dQ's part = dS K (RS, B = K^T, N = D).
//     dQ is scaled once and stored for rows < N.
//   * dk/dv (flash_bwd_dkv_tf32_kernel): keys are the wgmma rows, 64 a
//     slab; K and V split once into a resident quartet, each key's bias in
//     log2 units a constant per thread row.  Per tile of BQ queries: Q and
//     dO as a quartet, Q^T and dO^T hi/lo, and the queries' lse and delta
//     (+inf and 0 past N: P = 0 there) as side vectors.  S^T = K Q^T, dP^T
//     = V dO^T (SS); P^T, dS^T in registers; dV's part = P^T dO and dK's
//     part = dS^T Q (RS, B = dO^T, Q^T); dbias is the row sums of the fp32
//     dS^T, each thread's in a fixed order, across the quad at the end.  At
//     d = 80 one warpgroup holding dK, dV, their parts and S^T, dP^T would
//     spill, so two warpgroups share each slab (SPLIT = 2): one computes S^T
//     and accumulates dV, the other S^T and dP^T and accumulates dK and
//     dbias: 5 products for the function's 4.
//   * Ragged edges: rows past N or M load as zeros; P = 0 past M (dq) and
//     past N (dk/dv) by the side vectors; rows past N or M are not stored.
//     No atomics: a second run gives the same bits.
//
// The d <= 160 class (ds4 and the middle block, short sequences) runs the
// same two kernels in a raw-resident form (kRaw in DqCfg and DkvCfg): a
// resident quartet of 64 rows takes 160 KB at d = 160, which leaves no room
// for a tile's quartet and transposed halves in the 227 KB a block has.
//   * The resident pair (dq: Q and dO; dk/dv: K and V) stays raw, fp32 and
//     unsplit (Raw: 40 KB a matrix for 64 rows).  Its products over the head
//     dim (S, dP; S^T, dP^T) take it as the A operand from registers (RS):
//     each k-step's fragments are read by ldmatrix and split into hi and lo
//     in registers (flash_fwd.cu's K slices do the same), one (dq) or two
//     (dk/dv) k-steps a commit group, two groups in flight over a ring of
//     fragment sets (raw_chains).  Each score is two chains from zero,
//     hi.hi and hi.lo + lo.hi, summed in fp32: the same error as one chain
//     with the hi.hi steps last (F10), without reading a fragment twice.
//   * Tiles of 16 keys (queries): dq's buffer (a K/V quartet of 16 rows, K^T
//     hi/lo) takes 60 KB, dk/dv's (a Q/dO quartet, Q^T and dO^T hi/lo) 80
//     KB, one a part beside the 80 KB of the raw pair.  The transposed
//     operands of 16 keys are 64-byte rows, 64-byte swizzled
//     (hopper.cuh:store_vt8, sw64_desc), and S (S^T) is wgmma m64n16k8.
//   * The products over the tile (dQ, dK, dV += ...) run in two halves of
//     N = 80 (a whole part of 80 registers beside the gradient's 80 would
//     spill), each a chain from zero added to its half of the gradient.
//   * One warpgroup a block leaves every latency (the small products'
//     chains, the loads, the conversions) exposed: on an H100 two
//     warpgroups a block ran ~1.6x the work per SM of one
//     (tools/bench_bwd_variants.py: ks1 against base).  So dq's 64-query blocks
//     split their key tiles over two warpgroups (KS = 2), each with its own
//     buffer and barriers, their dQ summed in part order at the end; and
//     dk/dv keeps d = 80's two warpgroups a slab (SPLIT = 2) but hands P^T
//     from the dV warpgroup to the dK warpgroup through shared memory, so
//     that each computes one product over the head dim (S^T; dP^T): 4
//     products for the function's 4, against 5 at d = 80 (kShareP).
//
// The wrapper (ops/flash_attention.py) checks what the route takes: d, the
// bases and the strides multiples of 4 elements (16-byte loads).  Tiles per
// head-dim class: BWD_TILES_F32 there, held by f32::dispatch below (its
// *_F32 lists); flash_bwd_f32_sweep.cu builds every class at
// tools/bench_sweep_attn.py:BWD_F32_CONFIGS.

#ifndef FLASH_BWD_SWEEP  // the bf16 sweep library holds the bf16 kernels only
namespace f32 {

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* bias;   // (B, M) rows at stride s[kBiasRow], natural-log units, or null
  const float* lse;    // (B, H, N) contiguous, log2 units
  const float* delta;  // (B, H, N) contiguous
  float* dq;
  float* dk;
  float* dv;
  float* dbias;  // (B, H, M) contiguous, or null
  int heads, n, m, d;
  long long s[kStrides];
  float scale, scale_log2;
};

constexpr int kSmemLimit = 232448;  // bytes of shared memory a block can have

// ---------------------------------------------------------------- 3xTF32

// A K-major quartet of R rows: hi and lo of two matrices X and Y (halves 0:
// X hi, 1: X lo, 2: Y hi, 3: Y lo) of the class's D columns, in 32-column
// atoms of R rows of 128 bytes, the 16-byte chunk c of row r at c ^ (r &
// 7), as wgmma's 128-byte swizzled K-major descriptors read them.  Each
// half holds D / 32 whole atoms; the D % 32 columns past them take a slot
// of kTail columns in a tail atom shared by kSlots halves (D = 40: one atom
// of four 8-column slots; D = 80: two atoms of two 16-column slots).
template <int D>
struct Quartet {
  static constexpr int kWhole = D / 32, kTail = D % 32;
  static constexpr int kSlots = kTail ? 32 / kTail : 1;
  static constexpr int kAtoms = 4 * kWhole + (kTail ? (4 + kSlots - 1) / kSlots : 0);
  static_assert(D % 8 == 0 && kTail % 8 == 0, "8-column k-steps");

  // the atom, and the column within it, of column c of half hf
  static __device__ __forceinline__ int atom(int hf, int c) {
    return c < 32 * kWhole ? hf * kWhole + c / 32 : 4 * kWhole + hf / kSlots;
  }
  static __device__ __forceinline__ int col(int hf, int c) {
    return c < 32 * kWhole ? c % 32 : (hf % kSlots) * kTail + c - 32 * kWhole;
  }
  // k-step kk (columns 8 kk .. 8 kk + 7) of half hf, rows row0 .. row0 + 63
  template <int R>
  static __device__ __forceinline__ uint64_t desc(uint32_t base, int hf, int kk, int row0) {
    return sw128_desc(base + atom(hf, 8 * kk) * R * 128 + row0 * 128 + col(hf, 8 * kk) * 4, 16,
                      1024);
  }
  // columns 8 cg .. 8 cg + 7 of row r of matrix mx (0: X, 1: Y), split into
  // its halves 2 mx (hi) and 2 mx + 1 (lo)
  template <int R>
  static __device__ __forceinline__ void store8(uint8_t* base, int mx, int r, int cg,
                                                const float4 (&x)[2]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = 8 * cg + 4 * i;
      const int oh = atom(2 * mx, c) * R * 128 + r * 128 + (((col(2 * mx, c) / 4) ^ (r & 7)) << 4);
      const int ol =
          atom(2 * mx + 1, c) * R * 128 + r * 128 + (((col(2 * mx + 1, c) / 4) ^ (r & 7)) << 4);
      uint4 hv, lv;
      split_tc(x[i].x, hv.x, lv.x);
      split_tc(x[i].y, hv.y, lv.y);
      split_tc(x[i].z, hv.z, lv.z);
      split_tc(x[i].w, hv.w, lv.w);
      *reinterpret_cast<uint4*>(base + oh) = hv;
      *reinterpret_cast<uint4*>(base + ol) = lv;
    }
  }
};

// The raw resident pair of the d <= 160 class: two fp32 matrices (0: X,
// 1: Y) of R rows, unsplit, each D / 32 atoms of 32 columns (R rows of 128
// bytes, the 16-byte chunk c of row r at c ^ (r & 7), so that ldmatrix's
// eight rows of a chunk hit 32 banks).
template <int D>
struct Raw {
  static_assert(D % 32 == 0, "whole 32-column atoms");
  static __host__ __device__ constexpr int bytes(int rows) { return (D / 32) * rows * 128; }

  // columns 8 cg .. 8 cg + 7 of row r of matrix mx
  template <int R>
  static __device__ __forceinline__ void store8(uint8_t* base, int mx, int r, int cg,
                                                const float4 (&x)[2]) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float4*>(base + mx * bytes(R) + (cg / 4) * R * 128 + r * 128 +
                                 (((2 * (cg % 4) + i) ^ (r & 7)) << 4)) = x[i];
  }
  // The TF32 A fragments of k-step kk (columns 8 kk .. 8 kk + 7) of matrix
  // mx for a warp's 16 rows from row0, split: (g, t), (g + 8, t), (g, t + 4),
  // (g + 8, t + 4) as hi and lo.  ldmatrix's four 8-row x 16-byte matrices:
  // lanes 8i .. 8i + 7 give matrix i's rows (row0 + 8 (i & 1) + lane % 8,
  // chunk 2 (kk % 4) + i / 2).
  template <int R>
  static __device__ __forceinline__ void frag(uint32_t (&hi)[4], uint32_t (&lo)[4], uint32_t base,
                                              int mx, int kk, int row0, int lane) {
    const int row = row0 + 8 * ((lane / 8) & 1) + lane % 8;
    ldmatrix_x4(hi, base + mx * bytes(R) + (kk / 4) * R * 128 + row * 128 +
                        (((2 * (kk % 4) + lane / 16) ^ (row & 7)) << 4));
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tc(__uint_as_float(hi[e]), hi[e], lo[e]);
  }
};

// Transposed operands of T keys (or queries): hi and lo of matrices (half
// 2 mx: matrix mx's hi, 2 mx + 1 its lo), rows = the head dim's D columns,
// atoms of 32 keys (D rows of 128 bytes, 128-byte swizzled) or, at T = 16,
// one atom of 16 (rows of 64 bytes, 64-byte swizzled); within an 8-key step
// key 2i at k = i and key 2i + 1 at k = 4 + i (the A fragment's order of
// the accumulator registers it comes from).
template <int D, int T>
struct Trans {
  static constexpr int kKeys = T < 32 ? T : 32;           // keys an atom
  static constexpr int kRow = 4 * kKeys;                  // bytes a row
  static constexpr int kHalf = (T / kKeys) * D * kRow;  // bytes of a half
  static_assert(T % 32 == 0 || T == 16, "32- or 16-key atoms");

  // key `key`'s columns 8 cg .. 8 cg + 7 of matrix mx (hopper.cuh:store_vt8)
  static __device__ __forceinline__ void store8(uint8_t* base, int mx, int key, int cg,
                                                const float4 (&x)[2]) {
    store_vt8<D, kKeys>(base + 2 * mx * kHalf, base + (2 * mx + 1) * kHalf, key, cg, x);
  }
  // 8-key step j of half hf, its rows n0 .. (N = the product's width)
  static __device__ __forceinline__ uint64_t desc(uint32_t base, int hf, int j, int n0) {
    constexpr int steps = kKeys / 8;
    const uint32_t addr = base + hf * kHalf + (j / steps) * D * kRow + n0 * kRow + (j % steps) * 32;
    return kKeys == 32 ? sw128_desc(addr, 16, 1024) : sw64_desc(addr, 16, 512);
  }
};

// A thread's share of the next streamed tile of T rows (dq: K and V; dk/dv:
// Q and dO), as loaded: its warp's units, each a lane's row (lane % kRows)
// and 8 columns (8 (kLanes (u % kCols) + lane / kRows)) of both matrices,
// in rounds of one unit a warp; and its entry of the tile's side vector(s).
// A unit is 32 rows of 8 columns, or at T = 16 16 rows of 16 columns.
template <int D, int T, int WARPS>
struct Share {
  static constexpr int kRows = T < 32 ? T : 32, kLanes = 32 / kRows;
  static constexpr int kCols = D / (8 * kLanes);  // units across the head dim
  static constexpr int kUnits = (T / kRows) * kCols;
  static constexpr int kRounds = (kUnits + WARPS - 1) / WARPS;
  static_assert(D % (8 * kLanes) == 0, "whole units");
  float4 x[kRounds][2], y[kRounds][2];
  float side;

  __device__ __forceinline__ void load(const float* xb, long long xs, const float* yb,
                                       long long ys, int row0, int len, int d, int warp,
                                       int lane) {
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int u = warp + WARPS * r;
      if (u < kUnits) {
        const int row = row0 + kRows * (u / kCols) + lane % kRows;
        const int col = 8 * (kLanes * (u % kCols) + lane / kRows);
        load8(x[r], xb, xs, row, len, col, d);
        load8(y[r], yb, ys, row, len, col, d);
      }
    }
  }
  // split into a buffer: the quartet (X, Y) at `quartet`, and X^T (TX), Y^T
  // (TY) at `trans` as matrices 0 and 1
  template <bool TX, bool TY>
  __device__ __forceinline__ void store(uint8_t* quartet, uint8_t* trans, int warp,
                                        int lane) const {
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int u = warp + WARPS * r;
      if (u < kUnits) {
        const int row = kRows * (u / kCols) + lane % kRows;
        const int cg = kLanes * (u % kCols) + lane / kRows;
        Quartet<D>::template store8<T>(quartet, 0, row, cg, x[r]);
        Quartet<D>::template store8<T>(quartet, 1, row, cg, y[r]);
        if constexpr (TX) Trans<D, T>::store8(trans, 0, row, cg, x[r]);
        if constexpr (TY) Trans<D, T>::store8(trans, 1, row, cg, y[r]);
      }
    }
  }
};

// Rows row0 + 32 (u / (D / 8)) + lane of X and Y (R rows from row0) into
// the resident pair, by every warp of the block: split into a quartet
// (Quartet<D>), or raw (Raw<D>) in the d <= 160 class.
template <class L, int D, int R, int WARPS>
__device__ __forceinline__ void load_resident(uint8_t* res, const float* xb, long long xs,
                                              const float* yb, long long ys, int row0, int len,
                                              int d, int warp, int lane) {
  for (int u = warp; u < (R / 32) * (D / 8); u += WARPS) {
    const int r = 32 * (u / (D / 8)) + lane, cg = u % (D / 8);
    float4 x[2];
    load8(x, xb, xs, row0 + r, len, 8 * cg, d);
    L::template store8<R>(res, 0, r, cg, x);
    load8(x, yb, ys, row0 + r, len, 8 * cg, d);
    L::template store8<R>(res, 1, r, cg, x);
  }
}

// One warpgroup's chain of 3xTF32 SS products into acc, from zero: over the
// D / 8 k-steps of A (halves ah, ah + 1 of a quartet of RA rows, rows row0
// ..) and B (halves bh, bh + 1 of a quartet of RB rows), every step's hi.lo
// and lo.hi, then its hi.hi.  Issued, not committed.
template <int D, int N, int RA, int RB>
__device__ __forceinline__ void ss_chain(float (&acc)[N / 2], uint32_t a, int ah, int row0,
                                         uint32_t bq, int bh) {
  using Q = Quartet<D>;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    WgmmaSsTf32<N>::ss(acc, Q::template desc<RA>(a, ah, kk, row0),
                       Q::template desc<RB>(bq, bh + 1, kk, 0), kk > 0);
    WgmmaSsTf32<N>::ss(acc, Q::template desc<RA>(a, ah + 1, kk, row0),
                       Q::template desc<RB>(bq, bh, kk, 0), 1);
  }
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    WgmmaSsTf32<N>::ss(acc, Q::template desc<RA>(a, ah, kk, row0),
                       Q::template desc<RB>(bq, bh, kk, 0), 1);
}

// One warpgroup's two products over the head dim in the d <= 160 class, X
// B^T into x and (TWO) Y C^T into y: A the raw resident X and Y (matrices
// 0, 1 of a Raw<D> pair of RA rows; from matrix MX0 on), the warpgroup's
// 64 rows from row0, split in registers a k-step at a time; B and C the
// halves (0, 1) and (2, 3) of a quartet of RB rows (from 2 MX0 on).  Each product is two chains from zero, its
// hi.hi steps and its hi.lo and lo.hi steps, summed in fp32 at the end (the
// small terms never follow a large running sum: F10).  STEPS k-steps'
// fragments are one commit group; RING groups are in flight, their
// fragments in a ring of RING sets (3 measured no faster on an H100:
// tools/bench_bwd_variants.py).  Waits for every product.
template <int D, int N, int RA, int RB, bool TWO, int STEPS, int MX0 = 0>
__device__ __forceinline__ void raw_chains(float (&x)[N / 2], float (&y)[TWO ? N / 2 : 1],
                                           uint32_t raw, int row0, uint32_t bq, int lane) {
  using Q = Quartet<D>;
  constexpr int M = TWO ? 2 : 1, RING = 2, G = D / 8 / STEPS;
  static_assert(D / 8 % STEPS == 0, "whole groups");
  float big[M][N / 2], small[M][N / 2];
  uint32_t fh[RING][STEPS][M][4], fl[RING][STEPS][M][4];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    pin(big[i]);
    pin(small[i]);
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int r = g % RING;
#pragma unroll
    for (int st = 0; st < STEPS; ++st)
#pragma unroll
      for (int i = 0; i < M; ++i)
        Raw<D>::template frag<RA>(fh[r][st][i], fl[r][st][i], raw, MX0 + i, g * STEPS + st, row0,
                                  lane);
    wgmma_fence();
#pragma unroll
    for (int st = 0; st < STEPS; ++st) {
      const int kk = g * STEPS + st;
#pragma unroll
      for (int i = 0; i < M; ++i) {
        const uint64_t bh = Q::template desc<RB>(bq, 2 * (MX0 + i), kk, 0);
        const uint64_t bl = Q::template desc<RB>(bq, 2 * (MX0 + i) + 1, kk, 0);
        WgmmaRsTf32<N>::rs(small[i], fh[r][st][i], bl, kk > 0);
        WgmmaRsTf32<N>::rs(small[i], fl[r][st][i], bh, 1);
        WgmmaRsTf32<N>::rs(big[i], fh[r][st][i], bh, kk > 0);
      }
    }
    wgmma_commit();
    if (g >= RING - 1) {  // the group RING - 1 back is done: its set is free for the next
      wgmma_wait<RING - 1>();
#pragma unroll
      for (int st = 0; st < STEPS; ++st) {
        pin_u(fh[(g + 1) % RING][st]);
        pin_u(fl[(g + 1) % RING][st]);
      }
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int r = 0; r < RING; ++r)
#pragma unroll
    for (int st = 0; st < STEPS; ++st) {
      pin_u(fh[r][st]);
      pin_u(fl[r][st]);
    }
#pragma unroll
  for (int i = 0; i < M; ++i) {
    pin(big[i]);
    pin(small[i]);
  }
#pragma unroll
  for (int e = 0; e < N / 2; ++e) {
    x[e] = big[0][e] + small[0][e];
    if constexpr (TWO) y[e] = big[M - 1][e] + small[M - 1][e];
  }
}

// One warpgroup's chain of 3xTF32 RS products into part, from zero: A the
// hi/lo fragments of T / 8 steps (from accumulator registers), B the halves
// 2 mx (hi) and 2 mx + 1 (lo) of a transposed operand, its rows n0 .. n0 +
// N - 1 (N = D, or a half of D).  Issued, not committed.
template <int D, int T, int N>
__device__ __forceinline__ void rs_chain(float (&part)[N / 2], const uint32_t (&fh)[T / 8][4],
                                         const uint32_t (&fl)[T / 8][4], uint32_t trans, int mx,
                                         int n0) {
  using TT = Trans<D, T>;
#pragma unroll
  for (int j = 0; j < T / 8; ++j) {
    WgmmaRsTf32<N>::rs(part, fh[j], TT::desc(trans, 2 * mx + 1, j, n0), j > 0);
    WgmmaRsTf32<N>::rs(part, fl[j], TT::desc(trans, 2 * mx, j, n0), 1);
  }
#pragma unroll
  for (int j = 0; j < T / 8; ++j)
    WgmmaRsTf32<N>::rs(part, fh[j], TT::desc(trans, 2 * mx, j, n0), 1);
}

// An accumulator fragment (m64nT) as the hi/lo A fragments of T / 8 steps:
// (row g, k t) = column 2t of the step, (row g, k t + 4) = column 2t + 1.
template <int T>
__device__ __forceinline__ void frags(const float (&x)[T / 2], uint32_t (&fh)[T / 8][4],
                                      uint32_t (&fl)[T / 8][4]) {
#pragma unroll
  for (int j = 0; j < T / 8; ++j) {
    split_tc(x[4 * j], fh[j][0], fl[j][0]);
    split_tc(x[4 * j + 2], fh[j][1], fl[j][1]);
    split_tc(x[4 * j + 1], fh[j][2], fl[j][2]);
    split_tc(x[4 * j + 3], fh[j][3], fl[j][3]);
  }
}

// The two rows (r0, r0 + 8) of a 64-row accumulator fragment (m64nD) that
// this thread holds, times `mul`, into a row-strided fp32 matrix: rows <
// valid and columns < d (an even column's pair at once).
template <int D>
__device__ __forceinline__ void store_frag(const float (&acc)[D / 2], float* base, long long sn,
                                           int r0, int valid, int d, float mul, int quad) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * quad;
    if (col >= d) continue;
    if (r0 < valid)
      *reinterpret_cast<float2*>(base + r0 * sn + col) =
          make_float2(acc[4 * j] * mul, acc[4 * j + 1] * mul);
    if (r0 + 8 < valid)
      *reinterpret_cast<float2*>(base + (r0 + 8) * sn + col) =
          make_float2(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
  }
}

// The shared memory of a block: a resident pair of RES rows (a quartet, or
// RAW: two raw fp32 matrices); for each of PARTS key parts NBUF buffers (a
// quartet of T rows and TRANS transposed matrices of T rows each, hi and
// lo), NBUF side vectors of SIDE floats, two full and two empty barriers;
// XCHG bytes of an exchange area; 1 KB of alignment slack.
constexpr int tc_smem(int d, int res, int t, int trans, int side, int nbuf, bool raw,
                      int parts = 1, int xchg = 0) {
  const int atoms = 4 * (d / 32) + (d % 32 ? (4 + 32 / (d % 32) - 1) / (32 / (d % 32)) : 0);
  return (raw ? 2 * d * res * 4 : atoms * res * 128) +
         parts * (nbuf * (atoms * t * 128 + trans * 2 * t * d * 4) + nbuf * side * 4 + 8 * 4) +
         xchg + 1024;
}

// dq: D the class's head dim (dQ's wgmma N, K^T's rows); NW consumer
// warpgroups (BQ = 64 NW queries); BK keys a tile (S's wgmma N); NBUF
// buffers a key part; KS key parts: KS groups of NW warpgroups share the
// block's queries, each takes every KS-th key tile into buffers and
// barriers of its own, and their dQ are summed in part order at the end
// (the d <= 160 class: one warpgroup's every latency is exposed, two keep
// the SM's tensor cores and load units busier).  Above d = 80 Q and dO
// stay raw (kRaw) and dQ's part runs in halves.
template <int D_, int NW_, int BK_, int NBUF_, int KS_>
struct DqCfg {
  static constexpr int D = D_, NW = NW_, BK = BK_, NBUF = NBUF_, KS = KS_;
  static constexpr bool kRaw = D > 80;
  static constexpr int BQ = 64 * NW, kPartThreads = 128 * NW, kWarps = 4 * NW;  // a part's
  static constexpr int kThreads = KS * kPartThreads;
  static constexpr int kPN = kRaw ? D / 2 : D;  // the N of dQ's part
  static constexpr int kResBytes = kRaw ? 2 * D * BQ * 4 : Quartet<D>::kAtoms * BQ * 128;  // Q, dO
  static constexpr int kTileBytes = Quartet<D>::kAtoms * BK * 128;  // K, V
  static constexpr int kBufBytes = kTileBytes + 2 * Trans<D, BK>::kHalf;
  static constexpr int kOffSide = kResBytes + KS * NBUF * kBufBytes;  // BK floats a buffer
  static constexpr int kOffBar = kOffSide + KS * NBUF * BK * 4;     // 4 barriers a part
  static constexpr int kSmem = kOffBar + KS * 8 * 4 + 1024;
  static_assert(kSmem == tc_smem(D, BQ, BK, 1, BK, NBUF, kRaw, KS), "tc_smem");
  static_assert(BK == 32 || BK == 64 || (kRaw && BK == 16), "S's wgmma N, the key atoms");
  static_assert(NBUF == 1 || NBUF == 2, "buffers");
  static_assert(KS == 1 || (KS == 2 && kPartThreads * D / 2 * 4 <= kBufBytes), "parts");
  static_assert(kSmem <= kSmemLimit, "shared memory");
};

template <class C>
__global__ void __launch_bounds__(C::kThreads, 1)
    flash_bwd_dq_tf32_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // tid, warp: within the key part (a constant 0 with one part, so that the
  // one-part kernels compute no part offsets)
  const int part = C::KS > 1 ? threadIdx.x / C::kPartThreads : 0;
  const int tid = C::KS > 1 ? threadIdx.x % C::kPartThreads : threadIdx.x;
  const int wg = tid / 128, warp = tid / 32, w = warp % 4, lane = tid % 32;
  const int quad = lane % 4;
  const int q0 = blockIdx.x * C::BQ, h = blockIdx.y, b = blockIdx.z;
  // the part's key tiles: part, part + KS, ...
  const int ntiles = ((p.m + C::BK - 1) / C::BK - part + C::KS - 1) / C::KS;
  const uint32_t bars = smem_u32(smem + C::kOffBar) + 32 * part;
  auto full = [&](int i) { return bars + 8 * i; };         // every thread stored buffer i
  auto empty = [&](int i) { return bars + 8 * (2 + i); };  // every warp's products read it
  auto buf = [&](int i) { return smem + C::kResBytes + (part * C::NBUF + i) * C::kBufBytes; };
  auto side = [&](int i) {
    return reinterpret_cast<float*>(smem + C::kOffSide) + (part * C::NBUF + i) * C::BK;
  };

  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(full(i), C::kPartThreads);
      mbar_init(empty(i), C::kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const float* kb = p.k + b * p.s[kK] + h * p.s[kK + 1];
  const float* vb = p.v + b * p.s[kV] + h * p.s[kV + 1];
  const float* bias = p.bias ? p.bias + b * p.s[kBiasRow] : nullptr;
  // a key's bias in log2 units, -inf at or past M (P = 0 there)
  auto side_of = [&](int key) {
    return key < p.m ? (bias ? bias[key] * kLog2e : 0.0f) : -INFINITY;
  };
  Share<C::D, C::BK, C::kWarps> next;
  auto load_tile = [&](int it) {  // the part's tile it
    const int k0 = (part + C::KS * it) * C::BK;
    next.load(kb, p.s[kK + 2], vb, p.s[kV + 2], k0, p.m, p.d, warp, lane);
    next.side = tid < C::BK ? side_of(k0 + tid) : 0.0f;
  };
  auto store_tile = [&](int i) {
    next.template store<true, false>(buf(i), buf(i) + C::kTileBytes, warp, lane);
    if (tid < C::BK) side(i)[tid] = next.side;
    fence_proxy_async();
    mbar_arrive(full(i));
  };

  // Q and dO split once (or raw) by the whole block, then each part's first
  // key tile into its buffer 0; with one part that tile's full barrier
  // covers both
  using Res = std::conditional_t<C::kRaw, Raw<C::D>, Quartet<C::D>>;
  load_resident<Res, C::D, C::BQ, C::KS * C::kWarps>(
      smem, p.q + b * p.s[kQ] + h * p.s[kQ + 1], p.s[kQ + 2],
      p.dout + b * p.s[kDO] + h * p.s[kDO + 1], p.s[kDO + 2], q0, p.n, p.d, threadIdx.x / 32,
      lane);
  if constexpr (C::KS > 1) {
    fence_proxy_async();
    __syncthreads();
  }
  if (ntiles > 0) {
    load_tile(0);
    store_tile(0);
  }
  if (ntiles > 1) load_tile(1);

  // rows past N are never stored: any finite lse and delta will do there
  const int r0 = q0 + wg * 64 + w * 16 + lane / 4, r1 = r0 + 8;
  const float* lse = p.lse + ((long long)b * p.heads + h) * p.n;
  const float* delta = p.delta + ((long long)b * p.heads + h) * p.n;
  const float lse0 = r0 < p.n ? lse[r0] : 0.0f, lse1 = r1 < p.n ? lse[r1] : 0.0f;
  const float dl0 = r0 < p.n ? delta[r0] : 0.0f, dl1 = r1 < p.n ? delta[r1] : 0.0f;

  float acc[C::D / 2];
#pragma unroll
  for (int i = 0; i < C::D / 2; ++i) acc[i] = 0.0f;

  for (int it = 0; it < ntiles; ++it) {
    const int cur = it % C::NBUF;
    mbar_wait(full(cur), (it / C::NBUF) & 1);
    uint32_t kv = smem_u32(buf(cur)), kt = kv + C::kTileBytes, res = smem_u32(smem);
    // opaque to the compiler: the descriptors are rebuilt each tile (an add
    // each) instead of being hoisted out of the loop into registers (the
    // raw form's buffers too: with one buffer a part they stay put)
    asm volatile("" : "+r"(res));
    if constexpr (C::kRaw) asm volatile("" : "+r"(kv), "+r"(kt));

    // S = Q K^T and dP = dO V^T, one chain each (two from raw Q and dO)
    float s[C::BK / 2], dp[C::BK / 2];
    if constexpr (C::kRaw) {
      raw_chains<C::D, C::BK, C::BQ, C::BK, true, 1>(s, dp, res, wg * 64 + w * 16, kv, lane);
    } else {
      pin(s);
      pin(dp);
      wgmma_fence();
      ss_chain<C::D, C::BK, C::BQ, C::BK>(s, res, 0, wg * 64, kv, 0);
      ss_chain<C::D, C::BK, C::BQ, C::BK>(dp, res, 2, wg * 64, kv, 2);
      wgmma_commit();
      wgmma_wait<0>();
      pin(s);
      pin(dp);
    }

    // P and dS = P (dP - delta) in place of S
    const float* sd = side(cur);
#pragma unroll
    for (int j = 0; j < C::BK / 8; ++j) {
      const float2 bb = *reinterpret_cast<const float2*>(sd + 8 * j + 2 * quad);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float bcol = e ? bb.y : bb.x;
        const float p0 = ex2(fmaf(s[4 * j + e], p.scale_log2, bcol - lse0));
        const float p1 = ex2(fmaf(s[4 * j + 2 + e], p.scale_log2, bcol - lse1));
        s[4 * j + e] = p0 * (dp[4 * j + e] - dl0);
        s[4 * j + 2 + e] = p1 * (dp[4 * j + 2 + e] - dl1);
      }
    }
    uint32_t fh[C::BK / 8][4], fl[C::BK / 8][4];
    frags<C::BK>(s, fh, fl);

    // this tile's part of dQ = dS K, from zero (kPN columns at a time)
#pragma unroll
    for (int n0 = 0; n0 < C::D; n0 += C::kPN) {
      float part[C::kPN / 2];
      pin(part);
      wgmma_fence();
      rs_chain<C::D, C::BK, C::kPN>(part, fh, fl, kt, 0, n0);
      wgmma_commit();
      if (n0 == 0 && C::NBUF == 2 && it + 1 < ntiles) {
        // under the product: the next tile, loaded a tile ago, into the
        // other buffer once every warp's products of the tile before this
        // one are done
        const int nb = (it + 1) % 2;
        if (it >= 1) mbar_wait(empty(nb), ((it - 1) / 2) & 1);
        store_tile(nb);
      }
      wgmma_wait<0>();
      pin(part);
      pin_u(fh);
      pin_u(fl);
#pragma unroll
      for (int i = 0; i < C::kPN / 2; ++i) acc[n0 / 2 + i] += part[i];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(cur));
    if (C::NBUF == 1 && it + 1 < ntiles) {
      mbar_wait(empty(0), it & 1);
      store_tile(0);
    }
    if (it + 2 < ntiles) load_tile(it + 2);
  }

  if constexpr (C::KS > 1) {
    // the parts' dQ summed in part order, part 1's handed over through its
    // buffer 0 once every part's products are done
    float* red = reinterpret_cast<float*>(smem + C::kResBytes + C::NBUF * C::kBufBytes);
    __syncthreads();
    if (part == 1) {
#pragma unroll
      for (int i = 0; i < C::D / 2; ++i) red[i * C::kPartThreads + tid] = acc[i];
    }
    __syncthreads();
    if (part == 1) return;
#pragma unroll
    for (int i = 0; i < C::D / 2; ++i) acc[i] += red[i * C::kPartThreads + tid];
  }
  float* dq = p.dq + b * p.s[kDQ] + h * p.s[kDQ + 1];
  store_frag<C::D>(acc, dq, p.s[kDQ + 2], r0, p.n, p.d, p.scale, quad);
}

// dk/dv: D the class's head dim; NW slabs of 64 keys (BK = 64 NW keys a
// block); SPLIT warpgroups a slab (2: one accumulates dV, the other dK and
// dbias); BQ queries a tile (S^T's wgmma N); NBUF.  Above d = 80 K and V
// stay raw (kRaw) and the parts run in halves.
template <int D_, int NW_, int SPLIT_, int BQ_, int NBUF_>
struct DkvCfg {
  static constexpr int D = D_, NW = NW_, SPLIT = SPLIT_, BQ = BQ_, NBUF = NBUF_;
  static constexpr bool kRaw = D > 80;
  static constexpr int BK = 64 * NW, kThreads = 128 * NW * SPLIT, kWarps = 4 * NW * SPLIT;
  static constexpr int kPN = kRaw ? D / 2 : D;  // the N of dK's and dV's parts
  static constexpr int kResBytes = kRaw ? 2 * D * BK * 4 : Quartet<D>::kAtoms * BK * 128;  // K, V
  static constexpr int kTileBytes = Quartet<D>::kAtoms * BQ * 128;  // Q, dO
  static constexpr int kBufBytes = kTileBytes + 4 * Trans<D, BQ>::kHalf;
  // the raw form's split slabs: the dV warpgroup computes P^T and hands it
  // to the dK warpgroup (two tiles' worth, 128 threads x BQ / 2 floats a
  // slab), which computes dP^T alone: 4 products for the function's 4
  // (kXPBytes a slab), then a barrier a slab (its phase: the tile's P^T is
  // there)
  static constexpr bool kShareP = kRaw && SPLIT == 2;
  // k-steps a commit group of raw_chains (1 and 4 measured slower on an
  // H100, 4 at 254 registers: tools/bench_bwd_variants.py)
  static constexpr int kSteps = 2;
  static constexpr int kXPBytes = 2 * 128 * (BQ / 2) * 4;
  static constexpr int kXBytes = kShareP ? NW * (kXPBytes + 8) : 0;
  static constexpr int kOffSide = kResBytes + NBUF * kBufBytes;      // lse, delta: 2 BQ floats
  static constexpr int kOffX = kOffSide + NBUF * 2 * BQ * 4;
  static constexpr int kOffBar = kOffX + kXBytes;
  static constexpr int kSmem = kOffBar + 8 * 4 + 1024;
  static_assert(kSmem == tc_smem(D, BK, BQ, 2, 2 * BQ, NBUF, kRaw, 1, kXBytes), "tc_smem");
  static_assert(!kShareP || NBUF == 1, "two exchange slots: the warpgroups at most a tile apart");
  static_assert(BQ == 32 || BQ == 64 || (kRaw && BQ == 16), "S^T's wgmma N, the query atoms");
  static_assert(SPLIT == 1 || SPLIT == 2, "warpgroups a slab");
  static_assert(NBUF == 1 || NBUF == 2, "buffers");
  static_assert(kSmem <= kSmemLimit, "shared memory");
};

// One warpgroup's pass over every query tile for its slab of 64 keys: dV
// when DV, dK and dbias when DK; with the block's loads and stores of the
// resident K and V and the streamed tiles, which every thread shares.
template <class C, bool DV, bool DK>
__device__ __forceinline__ void dkv_pass(const Params& p, uint8_t* smem, int slab) {
  const int tid = threadIdx.x, warp = tid / 32, w = warp % 4, lane = tid % 32, quad = lane % 4;
  const int k0 = blockIdx.x * C::BK, h = blockIdx.y, b = blockIdx.z;
  const int ntiles = (p.n + C::BQ - 1) / C::BQ;
  const uint32_t bars = smem_u32(smem + C::kOffBar);
  auto full = [&](int i) { return bars + 8 * i; };
  auto empty = [&](int i) { return bars + 8 * (2 + i); };
  auto buf = [&](int i) { return smem + C::kResBytes + i * C::kBufBytes; };
  auto side = [&](int i) { return reinterpret_cast<float*>(smem + C::kOffSide) + i * 2 * C::BQ; };

  const float* qb = p.q + b * p.s[kQ] + h * p.s[kQ + 1];
  const float* dob = p.dout + b * p.s[kDO] + h * p.s[kDO + 1];
  const long long rows = ((long long)b * p.heads + h) * p.n;  // (b, h)'s lse and delta
  Share<C::D, C::BQ, C::kWarps> next;
  auto load_tile = [&](int it) {
    const int q0 = it * C::BQ;
    next.load(qb, p.s[kQ + 2], dob, p.s[kDO + 2], q0, p.n, p.d, warp, lane);
    // the tile's lse (+inf past N: P = 0 there) and delta (0 past N)
    const int i = tid % C::BQ;
    const bool valid = q0 + i < p.n;
    next.side = tid < C::BQ ? (valid ? p.lse[rows + q0 + i] : INFINITY)
                            : (valid ? p.delta[rows + q0 + i] : 0.0f);
  };
  auto store_tile = [&](int i) {
    next.template store<true, true>(buf(i), buf(i) + C::kTileBytes, warp, lane);
    if (tid < 2 * C::BQ) side(i)[tid] = next.side;
    fence_proxy_async();
    mbar_arrive(full(i));
  };

  // K and V split once (or raw), then query tile 0 into buffer 0
  using Res = std::conditional_t<C::kRaw, Raw<C::D>, Quartet<C::D>>;
  load_resident<Res, C::D, C::BK, C::kWarps>(
      smem, p.k + b * p.s[kK] + h * p.s[kK + 1], p.s[kK + 2], p.v + b * p.s[kV] + h * p.s[kV + 1],
      p.s[kV + 2], k0, p.m, p.d, warp, lane);
  load_tile(0);
  store_tile(0);
  if (ntiles > 1) load_tile(1);

  // the bias is per key row: one constant per thread row (log2 units)
  const int r0 = k0 + slab * 64 + w * 16 + lane / 4, r1 = r0 + 8;
  const float* bias = p.bias ? p.bias + b * p.s[kBiasRow] : nullptr;
  const float b0 = bias && r0 < p.m ? bias[r0] * kLog2e : 0.0f;
  const float b1 = bias && r1 < p.m ? bias[r1] * kLog2e : 0.0f;

  float dv[DV ? C::D / 2 : 1], dk[DK ? C::D / 2 : 1];
#pragma unroll
  for (int i = 0; i < C::D / 2; ++i) {
    if constexpr (DV) dv[i] = 0.0f;
    if constexpr (DK) dk[i] = 0.0f;
  }
  float db0 = 0.0f, db1 = 0.0f;

  for (int it = 0; it < ntiles; ++it) {
    const int cur = it % C::NBUF;
    mbar_wait(full(cur), (it / C::NBUF) & 1);
    uint32_t qd = smem_u32(buf(cur)), tr = qd + C::kTileBytes, res = smem_u32(smem);
    asm volatile("" : "+r"(res));
    if constexpr (C::kRaw) asm volatile("" : "+r"(qd), "+r"(tr));

    // S^T = K Q^T and dP^T = V dO^T, one chain each (two from raw K and V;
    // the dK warpgroup of a split raw slab dP^T alone)
    float s[C::BQ / 2], dp[DK ? C::BQ / 2 : 1];
    if constexpr (C::kShareP && DK) {
      float none[1];
      raw_chains<C::D, C::BQ, C::BK, C::BQ, false, C::kSteps, 1>(dp, none, res,
                                                                  slab * 64 + w * 16, qd, lane);
    } else if constexpr (C::kRaw) {
      raw_chains<C::D, C::BQ, C::BK, C::BQ, DK, C::kSteps>(s, dp, res, slab * 64 + w * 16, qd,
                                                           lane);
    } else {
      pin(s);
      if constexpr (DK) pin(dp);
      wgmma_fence();
      ss_chain<C::D, C::BQ, C::BK, C::BQ>(s, res, 0, slab * 64, qd, 0);
      if constexpr (DK) ss_chain<C::D, C::BQ, C::BK, C::BQ>(dp, res, 2, slab * 64, qd, 2);
      wgmma_commit();
      wgmma_wait<0>();
      pin(s);
      if constexpr (DK) pin(dp);
    }

    // P^T in s, dS^T in dp; the side vectors (lse +inf past N) mask queries
    // >= N.  A split raw slab's P^T goes from the dV warpgroup to the dK
    // warpgroup through the exchange (the same thread of the other
    // warpgroup holds the same entries), slot it % 2: the dV warpgroup
    // reaches tile it + 2 only after every thread stored tile it + 1, so
    // after the dK warpgroup read this slot
    float* xp = reinterpret_cast<float*>(smem + C::kOffX + slab * C::kXPBytes) +
                (it % 2) * (C::BQ / 2) * 128 + tid % 128;
    const uint32_t ready = smem_u32(smem + C::kOffX + C::NW * C::kXPBytes) + 8 * slab;
    if constexpr (C::kShareP && DK) mbar_wait(ready, it & 1);
    const float* ls = side(cur);
    const float* dls = ls + C::BQ;
#pragma unroll
    for (int j = 0; j < C::BQ / 8; ++j) {
      const float2 ll = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * quad);
      const float2 dd = *reinterpret_cast<const float2*>(dls + 8 * j + 2 * quad);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float l = e ? ll.y : ll.x;
        float p0, p1;
        if constexpr (C::kShareP && DK) {
          p0 = xp[(4 * j + e) * 128];
          p1 = xp[(4 * j + 2 + e) * 128];
        } else {
          p0 = ex2(fmaf(s[4 * j + e], p.scale_log2, b0 - l));
          p1 = ex2(fmaf(s[4 * j + 2 + e], p.scale_log2, b1 - l));
        }
        if constexpr (C::kShareP && DV) {
          xp[(4 * j + e) * 128] = p0;
          xp[(4 * j + 2 + e) * 128] = p1;
        }
        s[4 * j + e] = p0;
        s[4 * j + 2 + e] = p1;
        if constexpr (DK) {
          const float dl = e ? dd.y : dd.x;
          const float ds0 = p0 * (dp[4 * j + e] - dl), ds1 = p1 * (dp[4 * j + 2 + e] - dl);
          dp[4 * j + e] = ds0;
          dp[4 * j + 2 + e] = ds1;
          db0 += ds0;
          db1 += ds1;
        }
      }
    }
    if constexpr (C::kShareP && DV) mbar_arrive(ready);

    // this tile's parts of dV = P^T dO and dK = dS^T Q, from zero (kPN
    // columns at a time)
    uint32_t ph[DV ? C::BQ / 8 : 1][4], pl[DV ? C::BQ / 8 : 1][4];
    uint32_t dh[DK ? C::BQ / 8 : 1][4], dl[DK ? C::BQ / 8 : 1][4];
    if constexpr (DV) frags<C::BQ>(s, ph, pl);
    if constexpr (DK) frags<C::BQ>(dp, dh, dl);
#pragma unroll
    for (int n0 = 0; n0 < C::D; n0 += C::kPN) {
      float pv[DV ? C::kPN / 2 : 1], pk[DK ? C::kPN / 2 : 1];
      if constexpr (DV) pin(pv);
      if constexpr (DK) pin(pk);
      wgmma_fence();
      if constexpr (DV) rs_chain<C::D, C::BQ, C::kPN>(pv, ph, pl, tr, 1, n0);
      if constexpr (DK) rs_chain<C::D, C::BQ, C::kPN>(pk, dh, dl, tr, 0, n0);
      wgmma_commit();
      if (n0 == 0 && C::NBUF == 2 && it + 1 < ntiles) {
        const int nb = (it + 1) % 2;
        if (it >= 1) mbar_wait(empty(nb), ((it - 1) / 2) & 1);
        store_tile(nb);
      }
      wgmma_wait<0>();
      if constexpr (DV) {
        pin(pv);
        pin_u(ph);
        pin_u(pl);
#pragma unroll
        for (int i = 0; i < C::kPN / 2; ++i) dv[n0 / 2 + i] += pv[i];
      }
      if constexpr (DK) {
        pin(pk);
        pin_u(dh);
        pin_u(dl);
#pragma unroll
        for (int i = 0; i < C::kPN / 2; ++i) dk[n0 / 2 + i] += pk[i];
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(cur));
    if (C::NBUF == 1 && it + 1 < ntiles) {
      mbar_wait(empty(0), it & 1);
      store_tile(0);
    }
    if (it + 2 < ntiles) load_tile(it + 2);
  }

  if constexpr (DV)
    store_frag<C::D>(dv, p.dv + b * p.s[kDV] + h * p.s[kDV + 1], p.s[kDV + 2], r0, p.m, p.d, 1.0f,
                     quad);
  if constexpr (DK) {
    store_frag<C::D>(dk, p.dk + b * p.s[kDK] + h * p.s[kDK + 1], p.s[kDK + 2], r0, p.m, p.d,
                     p.scale, quad);
    // each row's sum over its quad's columns, in a fixed order
    db0 = quad_sum(db0);
    db1 = quad_sum(db1);
    if (p.dbias && quad == 0) {
      float* out = p.dbias + ((long long)b * p.heads + h) * p.m;
      if (r0 < p.m) out[r0] = db0;
      if (r1 < p.m) out[r1] = db1;
    }
  }
}

template <class C>
__global__ void __launch_bounds__(C::kThreads, 1)
    flash_bwd_dkv_tf32_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, wg = tid / 128;
  if (tid == 0) {
    const uint32_t bars = smem_u32(smem + C::kOffBar);
    for (int i = 0; i < 2; ++i) {
      mbar_init(bars + 8 * i, C::kThreads);
      mbar_init(bars + 8 * (2 + i), C::kWarps);
    }
    if constexpr (C::kShareP)
      for (int i = 0; i < C::NW; ++i)
        mbar_init(smem_u32(smem + C::kOffX + C::NW * C::kXPBytes) + 8 * i, 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int slab = wg / C::SPLIT;
  if constexpr (C::SPLIT == 1)
    dkv_pass<C, true, true>(p, smem, slab);
  else if (wg % 2 == 0)
    dkv_pass<C, true, false>(p, smem, slab);
  else
    dkv_pass<C, false, true>(p, smem, slab);
}

}  // namespace f32

namespace f32 {  // host side

// Launch `kernel` over (blocks, heads, batch) blocks of `threads` threads
// with `smem` bytes of dynamic shared memory.
template <class Kernel>
cudaError_t run(Kernel kernel, int smem, int threads, int blocks, int batch, const Params& p,
                cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(blocks, p.heads, batch), threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The 3xTF32 kernels of class D at (fixed rows R, tile rows T): dq (BQ
// queries, BK keys), dk/dv (BK keys, BQ queries), with two buffers where
// they fit in shared memory, else one; above d = 40 dk/dv splits each slab
// of 64 keys over two warpgroups; above d = 80 the resident pair is raw,
// and dq's 64-query blocks split their key tiles over two warpgroups.
template <int D, bool DQ, int R, int T>
cudaError_t launch_tc(const Params& p, int batch, cudaStream_t s) {
  constexpr bool raw = D > 80;
  if constexpr (DQ) {
    // a 64-query block of the d <= 160 class splits its keys over two parts
    constexpr int ks = raw && R == 64 ? 2 : 1;
    constexpr int nbuf = tc_smem(D, R, T, 1, T, 2, raw, ks) <= kSmemLimit ? 2 : 1;
    using C = DqCfg<D, R / 64, T, nbuf, ks>;
    return run(flash_bwd_dq_tf32_kernel<C>, C::kSmem, C::kThreads, (p.n + R - 1) / R, batch, p,
               s);
  } else {
    constexpr int nbuf = tc_smem(D, R, T, 2, 2 * T, 2, raw) <= kSmemLimit ? 2 : 1;
    using C = DkvCfg<D, R / 64, (D > 40 ? 2 : 1), T, nbuf>;
    return run(flash_bwd_dkv_tf32_kernel<C>, C::kSmem, C::kThreads, (p.m + R - 1) / R, batch, p,
               s);
  }
}

// The configurations the library holds, as X-macro lists of (kernel, fixed
// rows, tile rows) per kernel and head-dim class: the serving library the
// wrapper's table (ops/flash_attention.py:BWD_TILES_F32, "tc": the 3xTF32
// kernels), the fp32 sweep library (flash_bwd_f32_sweep.cu)
// tools/bench_sweep_attn.py:BWD_F32_CONFIGS.
#ifndef FLASH_BWD_F32_SWEEP
#define DQ40_F32(X) X(tc, 128, 64)
#define DKV40_F32(X) X(tc, 128, 32)
#define DQ80_F32(X) X(tc, 128, 32)
#define DKV80_F32(X) X(tc, 64, 32)
#define DQ160_F32(X) X(tc, 64, 16)
#define DKV160_F32(X) X(tc, 64, 16)
#else
#define DQ40_F32(X) X(tc, 64, 64) X(tc, 128, 32) X(tc, 128, 64) X(tc, 192, 32)
#define DKV40_F32(X) X(tc, 128, 32)
#define DQ80_F32(X) X(tc, 64, 32) X(tc, 128, 32)
#define DKV80_F32(X) X(tc, 64, 32)
#define DQ160_F32(X) X(tc, 64, 16) X(tc, 128, 16)
#define DKV160_F32(X) X(tc, 64, 16)
#endif

// Launch the dq (DQ) or dk/dv kernel of p.d's head-dim class at (rows,
// tile), if the lists above hold it; anything else returns
// cudaErrorInvalidValue.
template <bool DQ>
cudaError_t dispatch(const Params& p, int batch, int rows, int tile, cudaStream_t s) {
  const int key = tiles_key(rows, tile, 0);
#define CASE_F32(D, K, R, T) \
  case tiles_key(R, T, 0): return launch_##K<D, DQ, R, T>(p, batch, s);
#define CASE40_F32(K, R, T) CASE_F32(40, K, R, T)
#define CASE80_F32(K, R, T) CASE_F32(80, K, R, T)
#define CASE160_F32(K, R, T) CASE_F32(160, K, R, T)
  if constexpr (DQ) {
    if (p.d <= 40) {
      switch (key) { DQ40_F32(CASE40_F32) }
    } else if (p.d <= 80) {
      switch (key) { DQ80_F32(CASE80_F32) }
    } else {
      switch (key) { DQ160_F32(CASE160_F32) }
    }
  } else {
    if (p.d <= 40) {
      switch (key) { DKV40_F32(CASE40_F32) }
    } else if (p.d <= 80) {
      switch (key) { DKV80_F32(CASE80_F32) }
    } else {
      switch (key) { DKV160_F32(CASE160_F32) }
    }
  }
  return cudaErrorInvalidValue;
}

// What the route takes: a head dim that is a multiple of 4 up to 160, and
// every base and stride of q, k, v, dO a multiple of 4 elements (16-byte
// loads); the wrapper checks the same (ops/flash_attention.py:_check_f32).
// The gradients' strides must be even (the 3xTF32 kernels store pairs).
bool make_params(Params& p, const void* q, const void* k, const void* v, const void* dout,
                 const float* bias, const float* lse, const float* delta, int heads, int n,
                 int m, int d, const long long* strides, float scale) {
  if (d < 4 || d > kMaxD || d % 4 || n < 1 || m < 1 || heads < 1) return false;
  const void* ptrs[4] = {q, k, v, dout};
  const int at[4] = {kQ, kK, kV, kDO};
  for (int i = 0; i < 4; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 || strides[at[i]] % 4 ||
        strides[at[i] + 1] % 4 || strides[at[i] + 2] % 4)
      return false;
  for (int i = kDQ; i < kBiasRow; ++i)
    if (strides[i] % 2) return false;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.dout = static_cast<const float*>(dout);
  p.bias = bias;
  p.lse = lse;
  p.delta = delta;
  p.dq = p.dk = p.dv = p.dbias = nullptr;
  p.heads = heads, p.n = n, p.m = m, p.d = d;
  for (int i = 0; i < kStrides; ++i) p.s[i] = strides[i];
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  return true;
}

}  // namespace f32
#endif  // FLASH_BWD_SWEEP

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

#ifndef FLASH_BWD_SWEEP
// The fp32 route: q, k, v, dO, bias, lse, delta and the gradients fp32,
// strides as above.  (bq, bk) / (bk, bq): the kernel's (fixed rows, tile
// rows), one this library holds for d's class (f32::dispatch: the 3xTF32
// kernels); d, every base and every
// q/k/v/dO stride a multiple of 4 elements, and the gradients' strides
// even, else cudaErrorInvalidValue.
extern "C" int flash_bwd_dq_f32(const void* q, const void* k, const void* v, const void* dout,
                                const float* bias, const float* lse, const float* delta, void* dq,
                                int batch, int heads, int n, int m, int d,
                                const long long* strides, float scale, int bq, int bk,
                                void* stream) {
  f32::Params p;
  if (batch < 1 || reinterpret_cast<uintptr_t>(dq) % 8 ||
      !f32::make_params(p, q, k, v, dout, bias, lse, delta, heads, n, m, d, strides, scale))
    return (int)cudaErrorInvalidValue;
  p.dq = static_cast<float*>(dq);
  return (int)f32::dispatch<true>(p, batch, bq, bk, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_bwd_dkv_f32(const void* q, const void* k, const void* v, const void* dout,
                                 const float* bias, const float* lse, const float* delta,
                                 void* dk, void* dv, float* dbias, int batch, int heads, int n,
                                 int m, int d, const long long* strides, float scale, int bk,
                                 int bq, void* stream) {
  f32::Params p;
  if (batch < 1 || reinterpret_cast<uintptr_t>(dk) % 8 || reinterpret_cast<uintptr_t>(dv) % 8 ||
      !f32::make_params(p, q, k, v, dout, bias, lse, delta, heads, n, m, d, strides, scale))
    return (int)cudaErrorInvalidValue;
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.dbias = dbias;
  return (int)f32::dispatch<false>(p, batch, bk, bq, static_cast<cudaStream_t>(stream));
}
#endif  // FLASH_BWD_SWEEP
