// The Hopper (sm_90a) GEMM core of the fused projections (fused_proj.cu):
// tiles of y = A @ W^T with bf16 operands and fp32 accumulators that stay
// in registers, A (M, K) and W (F, K) both row-major, so both K-major: W is
// nn.Linear's weight, the B operand of the product as it is stored.
//
// A block is warp-specialised: NC = BM / 64 consumer warpgroups, each
// owning 64 of the block's BM rows, and one producer warp placed after them
// (so the consumers stay aligned warpgroups).  The block walks row blocks
// (persistent: blockIdx.y, + gridDim.y, ...) and, in each, a range of
// output tiles of BN wgmma columns (OUT output
// columns: BN, or BN / 2 for GEGLU, whose a and gate halves share one
// accumulator).  The producer's first lane keeps STAGES k-steps of 64
// columns in flight by TMA through a ring of shared-memory stages with
// full/empty mbarriers: each stage holds the W tile (BN rows) and, for a
// streamed A, the block's A tile (BM rows), 128-byte swizzled in 64-column
// atoms, the layout wgmma's descriptors read.  The ring runs on across
// output tiles and row blocks, so the next tile's loads overlap this tile's
// epilogue.  A resident A ("panel", the LayerNorm modes) is loaded once per
// row block, by TMA, as BM rows of every K atom in the same layout, once the
// consumers' last products of the previous row block are done with it
// (panel_empty); the caller rewrites it in place (normalised, bf16) before
// the first product.  Tensor maps zero-
// fill rows past M or F and columns past K, so ragged edges need no masks
// in the products.
//
// Each consumer warpgroup runs Wgmma<BN>::ss on its 64 rows of the A tile
// (or panel) against the stage's W tile, keeping one wgmma group in flight
// (a stage is released when the next k-step's products are issued).  The
// epilogue is the caller's, on the register accumulators: it writes bf16
// results into the warpgroup's staging tile, and one thread stores the tile
// with TMA (store_tile), which clips rows past M and columns past F.  The
// store is asynchronous: it drains to memory while the next tile's products
// run, and only the next epilogue waits for it to have read the staging
// tile.  No fp32 value passes through shared memory.  The staging tile
// holds 32-column atoms of 64 rows x 64 bytes, 64-byte swizzled as TMA
// reads them (staged()), so the fragment's 4-byte writes of 8 rows x 4
// lanes fall in 32 distinct banks; matmul_residual's x tile arrives in the
// same tile by TMA (load_x_tile) while the products run.
//
// Shared memory, from a 1024-byte aligned base: the ring, one staging tile
// per consumer warpgroup, the barriers, then the panel (its size follows
// K).  Header only.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "wgmma.cuh"

namespace {

constexpr size_t kMaxBlockSmem = 232448;  // a block's dynamic shared memory on the H100
constexpr size_t kSmemPerSM = 233472;     // an SM's, of which each block also takes 1 KB

// A barrier over `threads` threads (a multiple of 32) under id (1..15):
// wait for all of them, or arrive without waiting.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The byte offset of 16-byte chunk (row r, column c, c % 8 == 0) in a tile
// of `rows` rows stored as TMA writes it: 64-column atoms of rows x 128
// bytes, 128-byte swizzled.
__device__ __forceinline__ int swizzled(int rows, int r, int c) {
  return (c >> 6) * rows * 128 + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4);
}

// The byte offset of (row r, column c) in a staging tile: 32-column atoms
// of 64 rows x 64 bytes, 64-byte swizzled.
__device__ __forceinline__ int staged(int r, int c) {
  return (c >> 5) * 4096 + r * 64 + (((((c & 31) >> 3) ^ (r >> 1)) & 3) << 4) + (c & 7) * 2;
}

// BM rows (64, 128 or 192: one consumer warpgroup per 64), BN wgmma
// columns, STAGES ring stages; PANEL: A is resident (else streamed with W);
// OUT output columns per tile.
template <int BM_, int BN_, int STAGES_, bool PANEL_, int OUT_>
struct Sm90Tile {
  static constexpr int BM = BM_, BN = BN_, STAGES = STAGES_, OUT = OUT_;
  static constexpr bool PANEL = PANEL_;
  static constexpr int kConsumers = BM / 64;
  static constexpr int kThreads = 128 * kConsumers + 32;
  // 64-row blocks ask ptxas for two blocks an SM (their registers then fit
  // twice); larger ones for one.
  static constexpr int kMinBlocks = kConsumers == 1 ? 2 : 1;
  static constexpr int kATile = PANEL ? 0 : BM * 128;  // bytes of a streamed A tile
  static constexpr int kWTile = BN * 128;
  static constexpr int kStage = kATile + kWTile;
  static constexpr int kStaging = 64 * OUT * 2;  // one warpgroup's
  static constexpr int kStagingOffset = STAGES * kStage;
  static constexpr int kBarOffset = kStagingOffset + kConsumers * kStaging;
  static constexpr int kBars = 2 * STAGES + 2 + kConsumers;
  static constexpr int kPanelOffset = (kBarOffset + 8 * kBars + 1023) / 1024 * 1024;
  static_assert(BM == 64 || BM == 128 || BM == 192, "row block");
  static_assert(BN % 8 == 0 && BN >= 32 && BN <= 256, "wgmma width");
  static_assert(OUT % 32 == 0 && OUT <= BN, "output columns: whole staging atoms");
  static_assert(STAGES >= 2, "ring");

  // Dynamic shared memory for input width k: + 1 KB to align the base.
  static size_t smem(int k) {
    return kPanelOffset + (PANEL ? (size_t)BM * ((k + 63) / 64) * 128 : 0) + 1024;
  }
};

// A block's shared memory: the ring's stages, the staging tiles, the
// barriers (full and empty per stage, the panel's full and empty, and each
// warpgroup's x tile's) and the panel.
template <class C>
struct Sm90Smem {
  uint8_t* base;
  uint32_t bars;
  __device__ explicit Sm90Smem(uint8_t* raw) {
    base = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
    bars = smem_u32(base + C::kBarOffset);
  }
  __device__ uint8_t* stage(int s) const { return base + s * C::kStage; }
  __device__ uint8_t* staging(int wg) const { return base + C::kStagingOffset + wg * C::kStaging; }
  __device__ uint8_t* panel() const { return base + C::kPanelOffset; }
  __device__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ uint32_t empty(int s) const { return bars + 8 * (C::STAGES + s); }
  __device__ uint32_t panel_full() const { return bars + 16 * C::STAGES; }
  __device__ uint32_t panel_empty() const { return bars + 8 * (2 * C::STAGES + 1); }
  __device__ uint32_t x_full(int wg) const { return bars + 8 * (2 * C::STAGES + 2 + wg); }

  // Thread 0 sets the arrival counts (TMA: one; "empty": every consumer
  // warp), then the block syncs.
  __device__ void init() const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < C::STAGES; ++s) {
        mbar_init(full(s), 1);
        mbar_init(empty(s), 4 * C::kConsumers);
      }
      mbar_init(panel_full(), 1);
      mbar_init(panel_empty(), 4 * C::kConsumers);
      for (int wg = 0; wg < C::kConsumers; ++wg) mbar_init(x_full(wg), 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
};

// Producer (one lane): the panel, kblocks atoms of BM rows from row m0 of
// map_a, on panel_full.
template <class C>
__device__ __forceinline__ void load_panel(const Sm90Smem<C>& sm, const CUtensorMap* map_a,
                                           int m0, int kblocks) {
  mbar_expect_tx(sm.panel_full(), C::BM * 128 * kblocks);
  for (int a = 0; a < kblocks; ++a)
    tma_load_2d(smem_u32(sm.panel() + a * C::BM * 128), map_a, sm.panel_full(), 64 * a, m0);
}

// Producer (one lane): the kblocks k-steps of one output tile into the
// ring, from ring position `it` on.  Each step: the A tile (rows m0.. of
// map_a, streamed A only) and the W tile, BN rows from row n0 of map_w, or
// for GEGLU (map_g set) BN / 2 rows of each of map_w and map_g.
template <class C>
__device__ __forceinline__ void load_tile(const Sm90Smem<C>& sm, int& it, int kblocks,
                                          const CUtensorMap* map_a, int m0,
                                          const CUtensorMap* map_w, const CUtensorMap* map_g,
                                          int n0) {
  for (int kb = 0; kb < kblocks; ++kb, ++it) {
    const int s = it % C::STAGES;
    mbar_wait(sm.empty(s), ((it / C::STAGES) & 1) ^ 1);
    mbar_expect_tx(sm.full(s), C::kStage);
    const uint32_t dst = smem_u32(sm.stage(s));
    if (!C::PANEL) tma_load_2d(dst, map_a, sm.full(s), 64 * kb, m0);
    if (map_g) {
      tma_load_2d(dst + C::kATile, map_w, sm.full(s), 64 * kb, n0);
      tma_load_2d(dst + C::kATile + C::BN / 2 * 128, map_g, sm.full(s), 64 * kb, n0);
    } else {
      tma_load_2d(dst + C::kATile, map_w, sm.full(s), 64 * kb, n0);
    }
  }
}

// Consumer warpgroup wg: acc = (its 64 rows of A) @ (the tile's W)^T over
// kblocks k-steps from ring position `it` on, each stage released as soon as
// the products that read it are done (each warp's first lane arrives).
// issued() runs once the last k-step's products are issued, before they
// complete.
template <class C, class Issued>
__device__ __forceinline__ void mma_tile(const Sm90Smem<C>& sm, float (&acc)[C::BN / 2], int& it,
                                         int kblocks, int wg, Issued&& issued) {
  const bool leader = threadIdx.x % 32 == 0;
  pin(acc);
  for (int kb = 0; kb < kblocks; ++kb, ++it) {
    const int s = it % C::STAGES;
    mbar_wait(sm.full(s), (it / C::STAGES) & 1);
    uint32_t a = C::PANEL ? smem_u32(sm.panel()) + kb * C::BM * 128 : smem_u32(sm.stage(s));
    uint32_t b = smem_u32(sm.stage(s)) + C::kATile;
    a += wg * 64 * 128;
    // opaque to the compiler: the descriptors are rebuilt each step (an add
    // each) instead of being hoisted out of the loop into registers
    asm volatile("" : "+r"(a), "+r"(b));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<C::BN>::template ss<0>(acc, sw128_desc(a + 32 * kk, 16, 1024),
                                   sw128_desc(b + 32 * kk, 16, 1024), kb > 0 || kk > 0);
    wgmma_commit();
    if (kb + 1 == kblocks) issued();
    if (kb > 0) {
      wgmma_wait<1>();
      if (leader) mbar_arrive(sm.empty((it - 1) % C::STAGES));
    }
  }
  wgmma_wait<0>();
  pin(acc);
  if (leader) mbar_arrive(sm.empty((it - 1) % C::STAGES));
}

// Thread 0 of a consumer warpgroup: the 64 x OUT tile of map_x at rows
// row0.., columns n0.. into the warpgroup's staging tile, on `bar`, once
// the previous tile's store has read it.
template <class C>
__device__ __forceinline__ void load_x_tile(uint8_t* stg, const CUtensorMap* map_x, uint32_t bar,
                                            int row0, int n0) {
  bulk_wait_read<0>();
  mbar_expect_tx(bar, C::kStaging);
  for (int a = 0; a < C::OUT / 32; ++a)
    tma_load_2d(smem_u32(stg + a * 4096), map_x, bar, n0 + 32 * a, row0);
}

// Consumer warpgroup, once its staging tile is written: fence the writes for
// the async proxy, sync the warpgroup (named barrier `bar`), and thread tid
// 0 stores the tile to rows row0.., columns n0.. of map_out by TMA.
template <class C>
__device__ __forceinline__ void store_tile(const uint8_t* stg, const CUtensorMap* map_out, int row0,
                                           int n0, int tid, int bar) {
  fence_proxy_async();
  named_sync(bar, 128);
  if (tid == 0) {
    for (int a = 0; a < C::OUT / 32; ++a)
      tma_store_2d(map_out, smem_u32(stg + a * 4096), n0 + 32 * a, row0);
    bulk_commit();
  }
}

}  // namespace
