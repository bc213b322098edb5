// Fused projection kernels for Hopper (sm_90a): bf16 in / bf16 out, fp32 accumulation.
//
// Replaces the TPU Pallas kernels of gligen_tpu/ops/pallas_matmul.py:
//   * _ln_matmuls (pallas_call at :132, body _ln_matmuls_kernel :83, LayerNorm
//     _ln_rows :70): y_i = LN(x) @ W_i for up to 3 weights (to_q/to_k/to_v);
//   * _matmul_residual (:212, body _matmul_residual_kernel :191):
//     y = x + g * (h @ W + b) (to_out and FF net_2 with their gated residual);
//   * _ln_geglu (:297, body _ln_geglu_kernel :270, _erf :259):
//     y = a * gelu(g) with [a | g] = LN(x) @ W + b (FF net_0);
// and tools/bench_proj.py's mm_only (pallas_call at :90, body _mm_kernel
// :81, "K7"): y = x @ W alone, the yardstick of the projection budget tool
// (gligen_tpu_torch/tools/bench_proj.py).  It is a fourth mode of the same
// kernel, with no LayerNorm, the A tiles streamed as they are and the
// product stored: the same core and tile table as the three above, so K2 -
// K7 is the cost of their prologues and epilogues and K7 - cuBLAS that of
// the core.  It must stay on K2's core to measure that.
// Numerics are the TPU kernels': per-row fp32 LayerNorm statistics in one pass
// (mean and mean of squares), the normalised row rounded to bf16 before the
// product, fp32 products, fp32 bias and gate, one rounding of the output.  The
// GELU is the exact erf form (erff); the TPU's polynomial _erf exists only
// because Mosaic has no erf.
//
// Layout.  Rows are the flattened (B, N) token axis, M = B*N of them; TMA
// zero-fills the rows past M and the stores skip them, so M needs no padding
// (the fuser's k/v run over B*(N+30) rows as they are).  Weights are
// nn.Linear's (F, K) rows, the K-major B operand of the product: no
// transpose copy.  Every operand is read by TMA with no copy route: the
// wrapper (ops/launch.py:check, check_widths) refuses any operand that is
// not contiguous and 16-byte aligned and any K or F that is not a multiple
// of 8, so every accepted operand has 16-byte aligned rows, which is all a
// 2-D tensor map (hopper.cuh:make_map_2d) needs.
//
// Design: the Hopper GEMM core of gemm_sm90.cuh (one producer warp keeping a
// TMA ring of W tiles in flight, one or two consumer warpgroups running
// wgmma into register accumulators, each block walking several output
// tiles) with each mode's A operand and epilogue:
//   * LN modes (ln_matmuls, ln_geglu): the block's BM rows of x, every K
//     atom, arrive once by TMA into a resident panel; the consumer threads
//     compute each row's fp32 mean and rstd from it (eight lanes a row) and
//     rewrite the row in place, normalised and rounded to bf16, then fence
//     the panel for the tensor cores (fence.proxy.async) before the first
//     product.  So the statistics are computed once per row block and every
//     column tile, of every weight, reads the same panel: q, k and v share
//     one normalisation.  Columns from K up to the 64-column atom are written
//     as zeros, so the panel is finite everywhere; TMA zero-fills W there.
//     The panel is BM x K bf16: 80 KB at BM 128 and K 320, 160 KB at BM 64
//     and K 1280, which bounds the K the LN modes take (the tile table).
//   * matmul_residual and mm_only stream the A tile (h or x) with the W tile
//     through the same stages.
//   * epilogues on the register accumulators, into the warpgroup's bf16
//     staging tile, which a TMA store moves out while the next tile's
//     products run (rows past M and columns past F are clipped):
//     ln_matmuls and mm_only store the product; matmul_residual computes
//     (acc + b) g + x in fp32, g from the device scalar (the sampler's
//     gate * tanh(alpha), never synchronised to the host) or a constant,
//     with the x tile brought into the staging tile by TMA while the
//     tile's products run; ln_geglu loads each stage's W tile as
//     two boxes, BN / 2 rows of W[:F] and the same rows of W[F:], through two
//     tensor maps of extent F each (one of extent 2F would read gate rows
//     into a ragged a-half box instead of zeros), so that a column j and
//     its gate column F + j sit in the same thread's accumulator, and stores
//     (a + b_a) * 0.5 g (1 + erf(g / sqrt 2)), g = gate + b_g.
//   * where the ring holds a whole tile's k-steps (K up to 64 x stages),
//     the consumer warpgroups take the tensor cores in turns, tile by tile,
//     so that one warpgroup's epilogue (ln_geglu's erf above all) runs
//     while the next one's products do; with a longer K the products
//     outweigh the epilogue and the warpgroups run side by side.
//   * the tile configuration (BM, BN, stages) comes from the wrapper's
//     table by shape class (ops/fused_proj.py:PROJ_TILES), which this
//     library is built at (dispatch below); fused_proj_sweep.cu builds the
//     configurations of tools/bench_proj.py --sweep.  A block covers every
//     column tile of its row block, of every weight, unless the row blocks
//     alone would leave SMs idle: then the host splits each row block's
//     tiles into groups (gridDim.y), as few as fill the card.  There is no
//     split-K: each output is one sum, in a fixed order, with no atomics,
//     so two runs give the same bits.
//
// fp32 routes (ln_matmuls_f32, matmul_residual_f32, ln_geglu_f32): fp32 x, h,
// weights and outputs, for a model served in fp32 (the JAX package runs the
// same Pallas kernels in x.dtype, pallas_matmul.py:174-185, 246-252).  The
// statistics and epilogues are the bf16 kernels' in fp32 (no rounding of the
// normalised row), and the products are 3xTF32 wgmma on the tensor cores
// (gemm_tf32.cuh), never one-pass TF32: the JAX kernels' fp32 dot answers to
// an fp32 plain version.
//
// What bounds it on the H100: the tensor cores at the TF32 rate, three
// products per fp32 one (q/k/v at ds1: 3 x 30.2 GFLOP, 0.061 ms at 495
// TFLOP/s, over 0.15 ms of fp32 FMAs); beside them the CUDA cores' work on
// every operand value (the LayerNorm, the split) and the L2 traffic of
// fp32 operands read again for every column tile and row block.  What the
// design does about it:
//   * the products are WgmmaRsTf32, 64 rows a consumer warpgroup, 80 wgmma
//     columns (GEGLU: 40 of W[:F] and the same 40 of W[F:], so a column and
//     its gate share a thread; 80 and 40 divide every UNet width); each
//     32-column k-slice's 12 products start from zero and are added in fp32;
//   * A comes from registers: each consumer thread loads its fragments of
//     the fp32 slice by ldmatrix and splits them in registers, so A never
//     passes through shared memory as hi and lo; two splitter warps split
//     each stage's W tile (the B operand, which wgmma reads from shared
//     memory) as the producer warp's TMA ring brings it;
//   * the row block's A slices stay resident (the panel: K = 320 at 128
//     rows, 160 KB) where they fit, so A is read from memory once per row
//     block, not once per column tile, and is normalised in place once per
//     row block; else the slices stream with W and each tile normalises
//     its fragments as it splits them;
//   * the LayerNorm statistics are taken once per row block by the
//     consumers, from the rows in memory; a block walks all of its row
//     block's column tiles where that fills the card;
//   * the two consumer warpgroups issue their products in turns (Turns), so
//     that one's fragment work runs under the other's products;
//   * at the narrow shapes (the middle block's 256 rows, ds4's net_2) the
//     k-slices are split into ranges (ops/fused_proj.py:proj_plan_f32) whose
//     raw partial products proj_split_reduce_f32 adds in order before the
//     epilogue: no atomics, so two runs give the same bits.
//
// What bounds it on the H100.  At ds1 most sites are bound by bytes: 320 ->
// 320 does 160 FLOP per byte, below the card's ~295; ln_geglu (320 -> 2 x
// 1280) and the tools' K7 at 320 -> 2560 are bound by the tensor cores.  The
// middle block's 256 rows are launch- and occupancy-bound.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cstring>

#include "common.cuh"
#include "gemm_sm90.cuh"
#include "gemm_tf32.cuh"

namespace {

constexpr int kMaxWeights = 3;

enum Mode { kLnMatmuls = 0, kResidual = 1, kGeglu = 2, kMatmul = 3 };

struct Params {
  CUtensorMap ta;               // A (m, k): x (LN modes, the panel) or h / x (streamed)
  CUtensorMap tw[kMaxWeights];  // W_i (f, k); GEGLU: W[:F] and W[F:]
  CUtensorMap to[kMaxWeights];  // y_i (m, f), stored from the staging tiles
  CUtensorMap tx;               // the residual input x (m, f), into the staging tiles
  const float* ln_s;            // (K,) LayerNorm scale (LN modes)
  const float* ln_b;            // (K,) LayerNorm shift (LN modes)
  const float* bias;            // (F,) residual, (2F,) GEGLU
  const float* gate;            // device fp32 scalar, or null
  float gate_value;             // the gate when `gate` is null
  float eps;
  int m, k, f, n_w;
  int col_tiles;  // output column tiles per weight
};

template <int MODE, int BM, int BN, int STAGES>
using Tile = Sm90Tile<BM, BN, STAGES, MODE == kLnMatmuls || MODE == kGeglu,
                      MODE == kGeglu ? BN / 2 : BN>;

// _ln_rows on the panel in place, by consumer threads 0 .. nthreads - 1:
// eight lanes a row, each lane taking every eighth 16-byte chunk, so a warp
// normalises four rows at once (three shuffle steps per sum) and an 8-lane
// group reads whole 128-byte atom rows, conflict-free through the swizzle.
// Every warp walks BM / (nthreads / 8) rows, the same count, so the full-
// warp shuffles stay converged.  Rows past M hold TMA's zeros and become
// the LayerNorm shift: finite, and never stored.
template <int BM>
__device__ __forceinline__ void normalise_panel(uint8_t* panel, const Params& p, int kblocks,
                                                int tid, int nthreads) {
  const int lane8 = tid % 8, kpad = 64 * kblocks;
  for (int r = tid / 8; r < BM; r += nthreads / 8) {
    float s = 0.0f, ss = 0.0f;
    for (int c = lane8 * 8; c < p.k; c += 64) {
      float v[8];
      gligen::unpack8(*reinterpret_cast<const uint4*>(panel + swizzled(BM, r, c)), v);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s += v[i];
        ss += v[i] * v[i];
      }
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    }
    const float mean = s / p.k;
    const float rstd = rsqrtf(fmaxf(ss / p.k - mean * mean, 0.0f) + p.eps);
    for (int c = lane8 * 8; c < kpad; c += 64) {
      uint4* chunk = reinterpret_cast<uint4*>(panel + swizzled(BM, r, c));
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (c < p.k) {
        float v[8], sc[8], sb[8];
        gligen::unpack8(*chunk, v);
        gligen::load8f(p.ln_s + c, sc);
        gligen::load8f(p.ln_b + c, sb);
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = (v[i] - mean) * rstd * sc[i] + sb[i];
        u = gligen::pack8(v);
      }
      *chunk = u;
    }
  }
}

template <int MODE, int BM, int BN, int STAGES>
__global__ void __launch_bounds__(Tile<MODE, BM, BN, STAGES>::kThreads,
                                  Tile<MODE, BM, BN, STAGES>::kMinBlocks)
    fused_proj_kernel(const __grid_constant__ Params p) {
  typedef Tile<MODE, BM, BN, STAGES> C;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const Sm90Smem<C> sm(smem_raw);
  const int kblocks = (p.k + 63) / 64;
  const int tiles = p.n_w * p.col_tiles;
  const int t0 = (int)((long long)blockIdx.x * tiles / gridDim.x);
  const int t1 = (int)((long long)(blockIdx.x + 1) * tiles / gridDim.x);
  const int row_blocks = (p.m + BM - 1) / BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  sm.init();

  if (warp == 4 * C::kConsumers) {
    // ---------------- producer warp (one lane)
    if (lane == 0) {
      int it = 0, pass = 0;
      for (int rb = blockIdx.y; rb < row_blocks; rb += gridDim.y, ++pass) {
        const int m0 = rb * BM;
        if (C::PANEL) {
          if (pass > 0) mbar_wait(sm.panel_empty(), (pass - 1) & 1);
          load_panel(sm, &p.ta, m0, kblocks);
        }
        for (int t = t0; t < t1; ++t) {
          const int wsel = t / p.col_tiles, n0 = (t % p.col_tiles) * C::OUT;
          // selects, not an indexed address, keep the maps in parameter space
          const CUtensorMap* mw = wsel == 0 ? &p.tw[0] : wsel == 1 ? &p.tw[1] : &p.tw[2];
          load_tile(sm, it, kblocks, &p.ta, m0, mw, MODE == kGeglu ? &p.tw[1] : nullptr, n0);
        }
      }
    }
    return;
  }

  // ---------------- consumer warpgroups: 64 rows each
  const int wg = warp / 4, tid = threadIdx.x % 128, quad = lane % 4;
  const int r0 = (tid / 32) * 16 + lane / 4;  // the fragment's rows r0 and r0 + 8
  uint8_t* stg = sm.staging(wg);
  const float g = MODE == kResidual ? (p.gate ? *p.gate : p.gate_value) : 1.0f;
  const bool turns = C::kConsumers > 1 && kblocks <= STAGES;
  float acc[BN / 2];
  int it = 0, x_phase = 0, pass = 0;
  for (int rb = blockIdx.y; rb < row_blocks; rb += gridDim.y, ++pass) {
    const int m0 = rb * BM, row0 = m0 + wg * 64;
    const bool last_rb = rb + (int)gridDim.y >= row_blocks;
    if (C::PANEL) {
      mbar_wait(sm.panel_full(), pass & 1);
      normalise_panel<BM>(sm.panel(), p, kblocks, threadIdx.x, 128 * C::kConsumers);
      fence_proxy_async();
      named_sync(1, 128 * C::kConsumers);
    }
    for (int t = t0; t < t1; ++t) {
      const int wsel = t / p.col_tiles, n0 = (t % p.col_tiles) * C::OUT;
      // the x tile into the staging tile while the products run
      if (MODE == kResidual && tid == 0) load_x_tile<C>(stg, &p.tx, sm.x_full(wg), row0, n0);

      // Turns: warpgroup wg issues its products once wg - 1 has issued its
      // own for the same tile (warpgroup 0 once the last has, for the tile
      // before), so the tensor cores serve one warpgroup at a time and each
      // one's epilogue runs under the next one's products.  Only where the
      // ring holds a whole tile's k-steps: the warpgroups share its stages,
      // so a tile's stages must stay resident until the last has read them.
      if (turns && (wg > 0 || pass > 0 || t > t0)) named_sync(5 + wg, 256);
      mma_tile(sm, acc, it, kblocks, wg, [&] {
        if (turns && (wg + 1 < C::kConsumers || t + 1 < t1 || !last_rb))
          named_arrive(5 + (wg + 1) % C::kConsumers, 256);
      });
      // the row block's last products are done with the panel
      if (C::PANEL && t + 1 == t1 && lane == 0) mbar_arrive(sm.panel_empty());

      if constexpr (MODE == kResidual) {
        mbar_wait(sm.x_full(wg), x_phase);
        x_phase ^= 1;
      } else {
        // the previous tile's store has read the staging tile
        if (tid == 0) bulk_wait_read<0>();
        named_sync(2 + wg, 128);
      }
#pragma unroll
      for (int j = 0; j < C::OUT / 8; ++j) {
        const int col = 8 * j + 2 * quad, gc = n0 + col;
        float2 ba = make_float2(0.0f, 0.0f), bg = ba;
        if (MODE == kResidual || MODE == kGeglu) {
          if (gc < p.f) ba = __ldg(reinterpret_cast<const float2*>(p.bias + gc));
          if (MODE == kGeglu && gc < p.f) bg = __ldg(reinterpret_cast<const float2*>(p.bias + p.f + gc));
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t* dst = reinterpret_cast<uint32_t*>(stg + staged(r0 + 8 * h, col));
          float y0 = acc[4 * j + 2 * h], y1 = acc[4 * j + 2 * h + 1];
          if constexpr (MODE == kResidual) {
            const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dst));
            y0 = x.x + (y0 + ba.x) * g;
            y1 = x.y + (y1 + ba.y) * g;
          } else if constexpr (MODE == kGeglu) {
            const float g0 = acc[4 * (j + C::OUT / 8) + 2 * h] + bg.x;
            const float g1 = acc[4 * (j + C::OUT / 8) + 2 * h + 1] + bg.y;
            y0 = (y0 + ba.x) * (0.5f * g0 * (1.0f + erff(g0 * 0.7071067811865476f)));
            y1 = (y1 + ba.y) * (0.5f * g1 * (1.0f + erff(g1 * 0.7071067811865476f)));
          }
          *dst = pack_bf16(y0, y1);
        }
      }
      const CUtensorMap* mo = wsel == 0 ? &p.to[0] : wsel == 1 ? &p.to[1] : &p.to[2];
      store_tile<C>(stg, mo, row0, n0, tid, 2 + wg);
    }
  }
  // the stores have read the staging tiles before the block exits (their
  // writes to memory complete on their own)
  if (tid == 0) bulk_wait_read<0>();
}

// ------------------------------------------------------------ host side

// The configurations each library holds, per mode, as X-macro lists of
// (BM, BN, stages): the serving library the wrapper's table
// (ops/fused_proj.py:PROJ_TILES), the sweep library (fused_proj_sweep.cu)
// tools/bench_proj.py:SWEEP_TILES.
#ifndef FUSED_PROJ_SWEEP
#define LN_MATMULS(X) X(128, 160, 4) X(64, 160, 4) X(64, 128, 3)
#define RESIDUAL(X) X(128, 160, 5) X(64, 160, 4)
#define GEGLU(X) X(64, 128, 3)
#define MATMUL(X) X(128, 256, 3) X(128, 160, 5) X(64, 160, 4)
#else
#define LN_MATMULS(X) X(128, 160, 3) X(128, 160, 5) X(64, 160, 2) X(64, 128, 2)
#define RESIDUAL(X) X(128, 160, 4) X(128, 160, 3) X(192, 160, 3) X(64, 160, 3)
#define GEGLU(X) X(128, 128, 6) X(64, 64, 3) X(64, 64, 4) X(64, 128, 2)
#define MATMUL(X) X(128, 160, 4) X(128, 160, 3) X(192, 160, 3) X(128, 192, 3)
#endif

// Each row block's output tiles are split into as few groups (blockIdx.x)
// as give every SM its blocks, at the blocks an SM holds by shared memory
// (up to Tile::kMinBlocks); the blocks of a group walk the row blocks.  A
// streamed A is read again by each of a block's tiles: when K > 640, 132
// blocks' rows (BM x K, 42 MB at BM 128 and K 1280) outgrow the L2 and the
// second read comes from memory, so there each block takes one tile, and
// the blocks of a row block, neighbours in launch order, read its rows at
// the same time.
template <int MODE, int BM, int BN, int STAGES>
cudaError_t launch(Params& p, const bf16* a, const bf16* const* w, bf16* const* y, const bf16* x,
                   cudaStream_t stream) {
  typedef Tile<MODE, BM, BN, STAGES> C;
  const size_t smem = C::smem(p.k);
  if (smem > kMaxBlockSmem || !make_map_2d(&p.ta, a, p.k, p.m, BM)) return cudaErrorInvalidValue;
  if (MODE == kGeglu) {
    if (!make_map_2d(&p.tw[0], w[0], p.k, p.f, C::OUT) ||
        !make_map_2d(&p.tw[1], w[0] + (size_t)p.f * p.k, p.k, p.f, C::OUT))
      return cudaErrorInvalidValue;
  } else {
    for (int i = 0; i < p.n_w; ++i)
      if (!make_map_2d(&p.tw[i], w[i], p.k, p.f, BN)) return cudaErrorInvalidValue;
  }
  for (int i = 0; i < p.n_w; ++i)
    if (!make_map_2d(&p.to[i], y[i], p.f, p.m, 64, 32)) return cudaErrorInvalidValue;
  if (MODE == kResidual && !make_map_2d(&p.tx, x, p.f, p.m, 64, 32)) return cudaErrorInvalidValue;
  p.col_tiles = (p.f + C::OUT - 1) / C::OUT;
  const long long tiles = (long long)p.n_w * p.col_tiles;
  const long long row_blocks = (p.m + BM - 1) / BM;
  const long long per_sm = std::max<long long>(
      1, std::min<long long>(kSmemPerSM / (smem + 1024), C::kMinBlocks));
  const long long groups =
      !C::PANEL && p.k > 640
          ? tiles
          : std::max<long long>(1, std::min<long long>(gligen::kSMs * per_sm / row_blocks, tiles));
  auto kernel = fused_proj_kernel<MODE, BM, BN, STAGES>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // persistent: as many blocks a group as fill the card once, each walking
  // every gridDim.y-th row block
  const long long slots =
      std::max<long long>(1, std::min<long long>(row_blocks, gligen::kSMs * per_sm / groups));
  kernel<<<dim3((unsigned)groups, (unsigned)slots), C::kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

constexpr int tiles_key(int bm, int bn, int stages) { return (bm * 1000 + bn) * 10 + stages; }

// Launch MODE at (bm, bn, stages) if this library holds that configuration
// (the lists above); any other, or a shape the kernel does not take,
// returns cudaErrorInvalidValue.  a: the A operand; w: the weights; y: the
// outputs; x: the residual input.
template <int MODE>
int dispatch(Params& p, const bf16* a, const bf16* const* w, bf16* const* y, const bf16* x, int bm,
             int bn, int stages, void* stream) {
  if (p.m < 1 || p.k < 8 || p.f < 8 || p.k % 8 || p.f % 8 || p.n_w < 1 || p.n_w > kMaxWeights)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int key = tiles_key(bm, bn, stages);
#define CASE(BM, BN, ST) \
  case tiles_key(BM, BN, ST): return (int)launch<MODE, BM, BN, ST>(p, a, w, y, x, s);
  if constexpr (MODE == kLnMatmuls) {
    switch (key) { LN_MATMULS(CASE) }
  } else if constexpr (MODE == kResidual) {
    switch (key) { RESIDUAL(CASE) }
  } else if constexpr (MODE == kGeglu) {
    switch (key) { GEGLU(CASE) }
  } else {
    switch (key) { MATMUL(CASE) }
  }
#undef CASE
  return (int)cudaErrorInvalidValue;
}

Params empty_params() {
  Params p;
  memset(&p, 0, sizeof(p));
  p.gate_value = 1.0f;
  return p;
}

}  // namespace

// Plain C entry points for ctypes.  Each returns a cudaError_t (0 = launched).
// Every tensor is contiguous and 16-byte aligned; the caller checks shapes,
// dtypes and devices.  m is the number of rows, k the input width, f the
// output width; (bm, bn, stages) the tile configuration, one this library
// holds (dispatch).

// y_i = LN(x) @ w_i^T for i < n_w (1..3); x (m, k), w_i (f, k), y_i (m, f).
extern "C" int ln_matmuls_bf16(const void* x, const float* ln_s, const float* ln_b, int n_w,
                               const void* w0, const void* w1, const void* w2, void* y0, void* y1,
                               void* y2, int m, int k, int f, float eps, int bm, int bn,
                               int stages, void* stream) {
  Params p = empty_params();
  p.ln_s = ln_s;
  p.ln_b = ln_b;
  const bf16* ws[kMaxWeights] = {static_cast<const bf16*>(w0), static_cast<const bf16*>(w1),
                                 static_cast<const bf16*>(w2)};
  bf16* ys[kMaxWeights] = {static_cast<bf16*>(y0), static_cast<bf16*>(y1), static_cast<bf16*>(y2)};
  p.n_w = n_w;
  p.m = m, p.k = k, p.f = f;
  p.eps = eps;
  return dispatch<kLnMatmuls>(p, static_cast<const bf16*>(x), ws, ys, nullptr, bm, bn, stages,
                              stream);
}

// y = x + g * (h @ w^T + bias); h (m, k), w (f, k), bias (f,) fp32, x/y (m, f).
// g = *gate (a device fp32 scalar) when gate is not null, else gate_value.
extern "C" int matmul_residual_bf16(const void* h, const void* w, const float* bias, const void* x,
                                    const float* gate, float gate_value, void* y, int m, int k,
                                    int f, int bm, int bn, int stages, void* stream) {
  Params p = empty_params();
  const bf16* ws[1] = {static_cast<const bf16*>(w)};
  bf16* ys[1] = {static_cast<bf16*>(y)};
  p.bias = bias;
  p.gate = gate;
  p.gate_value = gate_value;
  p.n_w = 1;
  p.m = m, p.k = k, p.f = f;
  return dispatch<kResidual>(p, static_cast<const bf16*>(h), ws, ys, static_cast<const bf16*>(x),
                             bm, bn, stages, stream);
}

// y = a * gelu(g), [a | g] = LN(x) @ w^T + bias; x (m, k), w (2f, k),
// bias (2f,) fp32, y (m, f).
extern "C" int ln_geglu_bf16(const void* x, const float* ln_s, const float* ln_b, const void* w,
                             const float* bias, void* y, int m, int k, int f, float eps, int bm,
                             int bn, int stages, void* stream) {
  Params p = empty_params();
  const bf16* ws[1] = {static_cast<const bf16*>(w)};
  bf16* ys[1] = {static_cast<bf16*>(y)};
  p.ln_s = ln_s;
  p.ln_b = ln_b;
  p.bias = bias;
  p.n_w = 1;
  p.m = m, p.k = k, p.f = f;
  p.eps = eps;
  return dispatch<kGeglu>(p, static_cast<const bf16*>(x), ws, ys, nullptr, bm, bn, stages, stream);
}

// y = a @ w^T; a (m, k), w (f, k), y (m, f): the matmul-only mode (K7).
extern "C" int matmul_bf16(const void* a, const void* w, void* y, int m, int k, int f, int bm,
                           int bn, int stages, void* stream) {
  Params p = empty_params();
  const bf16* ws[1] = {static_cast<const bf16*>(w)};
  bf16* ys[1] = {static_cast<bf16*>(y)};
  p.n_w = 1;
  p.m = m, p.k = k, p.f = f;
  return dispatch<kMatmul>(p, static_cast<const bf16*>(a), ws, ys, nullptr, bm, bn, stages, stream);
}

#ifndef FUSED_PROJ_SWEEP
// ------------------------------------------------------------ the fp32 routes

// The fp32 routes' configurations, one X-macro list of (BM, BN, stages)
// that every mode is built at: the wrapper's table
// (ops/fused_proj.py:PROJ_TILES_F32).
#define PROJ_F32_CONFIGS(X) X(128, 80, 3)

namespace {

struct ParamsF32 {
  CUtensorMap ta;               // A (m, k): x or h, boxes of 32 columns x BM rows
  CUtensorMap tw[kMaxWeights];  // W_i (f, k), boxes of 32 columns x BN rows; GEGLU: W[:F], W[F:]
  const float* a;               // A (the LN modes' rows, for their statistics)
  float* y[kMaxWeights];        // y_i (m, f)
  const float* x;               // the residual input (m, f)
  const float* ln_s;            // (k,) LayerNorm scale (LN modes)
  const float* ln_b;            // (k,) LayerNorm shift (LN modes)
  const float* bias;            // (f,) residual, (2f,) GEGLU
  const float* gate;            // device fp32 scalar, or null
  float* part;                  // (split, n_w, m, fw) fp32 partial products (split > 1)
  float gate_value;             // the gate when `gate` is null
  float eps;
  int m, k, f, n_w;
  int col_tiles;  // output column tiles per weight
  int kslices;    // 32-column slices of k
  int split;      // ranges of the slices, one per blockIdx.z
};

// BM rows (64 or 128: one consumer warpgroup per 64), BN wgmma columns (OUT
// output columns: BN, or BN / 2 for GEGLU, whose a and gate halves share one
// accumulator), STAGES ring stages; PANEL: the row block's A slices resident
// (else streamed with W).  Warps: the consumer warpgroups, two W splitter
// warps, one producer warp.  Shared memory, from a 1024-byte aligned base:
// the stages (each [A], W hi, W lo), the barriers, the LN statistics of
// the row block ((mean, rstd) a row), the panel (`slices` A slices).
template <int MODE, int BM_, int BN_, int STAGES_, bool PANEL_>
struct ProjTf32Tile {
  static constexpr int BM = BM_, BN = BN_, STAGES = STAGES_;
  static constexpr bool PANEL = PANEL_;
  static constexpr int OUT = MODE == kGeglu ? BN / 2 : BN;
  static constexpr int kConsumers = BM / 64;
  static constexpr int kSplitters = 64;
  static constexpr int kThreads = 128 * kConsumers + kSplitters + 32;
  static constexpr int kATile = BM * 128, kWTile = BN * 128;
  static constexpr int kStage = (PANEL ? 0 : kATile) + 2 * kWTile;
  static constexpr int kBarOffset = STAGES * kStage;
  static constexpr int kBars = 3 * STAGES + 2;
  static constexpr int kStatsOffset = kBarOffset + 8 * kBars;
  static constexpr int kPanelOffset = (kStatsOffset + 8 * BM + 1023) / 1024 * 1024;
  static_assert(BM == 64 || BM == 128, "row block");
  static_assert(BN == 80, "a width gen_wgmma.py writes for WgmmaRsTf32");
  static_assert(OUT % 8 == 0 && STAGES >= 2, "output columns, ring");

  // Dynamic shared memory with `slices` resident A slices: + 1 KB to align the base.
  static size_t smem(int slices) { return kPanelOffset + (PANEL ? (size_t)slices * kATile : 0) + 1024; }
};

// _ln_rows' statistics of a consumer warpgroup's 64 rows (from row r0 of
// the row block at m0), by its 128 threads: eight lanes a row, one pass of
// fp32 sums and sums of squares over the row as it is in memory, the
// variance clamped at 0.  Rows past M get mean 0: TMA zero-fills their A
// tiles, so they normalise to the shift, finite, and are never stored.
__device__ __forceinline__ void row_stats(const ParamsF32& p, int m0, int r0, float2* stats,
                                          int wtid) {
  const int lane8 = wtid % 8;
  for (int r = r0 + wtid / 8; r < r0 + 64; r += 16) {
    const long long row = m0 + r;
    float s = 0.0f, ss = 0.0f;
    if (row < p.m)
      for (int c = 4 * lane8; c < p.k; c += 32) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(p.a + row * p.k + c));
        s += (v.x + v.y) + (v.z + v.w);
        ss += (v.x * v.x + v.y * v.y) + (v.z * v.z + v.w * v.w);
      }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    }
    if (lane8 == 0) {
      const float mu = s / p.k;
      stats[r] = make_float2(mu, rsqrtf(fmaxf(ss / p.k - mu * mu, 0.0f) + p.eps));
    }
  }
}

// A consumer warpgroup's 64 rows (from r0) of the resident panel's slices
// kb0 .. kb1 - 1 normalised in place by its 128 threads (wtid): (x - mean)
// rstd s + b in fp32, the rows' statistics from `stats`; columns past K
// keep TMA's zeros.  A thread keeps one 4-column chunk of a slice, so it
// loads that chunk's LN scale and shift once a slice.
template <int BM>
__device__ __forceinline__ void normalise_panel_rows(uint8_t* panel, const ParamsF32& p,
                                                     const float2* stats, int r0, int kb0,
                                                     int kb1, int wtid) {
  const int c = wtid % 8;
  for (int kb = kb0; kb < kb1; ++kb) {
    const int col = 32 * kb + 4 * c;
    if (col >= p.k) continue;
    const float4 sc = __ldg(reinterpret_cast<const float4*>(p.ln_s + col));
    const float4 sb = __ldg(reinterpret_cast<const float4*>(p.ln_b + col));
    uint8_t* slice = panel + (kb - kb0) * BM * 128;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = r0 + wtid / 8 + 16 * u;
      float4* v = reinterpret_cast<float4*>(slice + r * 128 + ((c ^ (r & 7)) << 4));
      const float2 st = stats[r];
      const float4 x = *v;
      *v = make_float4((x.x - st.x) * st.y * sc.x + sb.x, (x.y - st.x) * st.y * sc.y + sb.y,
                       (x.z - st.x) * st.y * sc.z + sb.z, (x.w - st.x) * st.y * sc.w + sb.w);
    }
  }
}

// A consumer thread's fragments of slice kb, as ldmatrix brought them from
// the fp32 A tile (f[kk][e]: rows g and g + 8 of its warp's 16, e = 0 / 1,
// columns 8 kk + t, e = 2 / 3 the same rows at column 8 kk + t + 4):
// normalised (LN modes, the rows' (mean, rstd) in st; columns past K become
// 0, where TMA's zero fill would normalise to the shift) and split in place
// into hi (f) and lo.
template <bool LN>
__device__ __forceinline__ void convert_frags(uint32_t (&f)[4][4], uint32_t (&lo)[4][4],
                                              const ParamsF32& p, const float2 (&st)[2], int kb,
                                              int t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int col = 32 * kb + 8 * kk + t;
    float sc[2] = {0.0f, 0.0f}, sb[2] = {0.0f, 0.0f};
    const bool in = 32 * kb + 8 * kk < p.k;  // K % 8 == 0: all 8 columns, or none
    if (LN && in) {
      sc[0] = __ldg(p.ln_s + col), sc[1] = __ldg(p.ln_s + col + 4);
      sb[0] = __ldg(p.ln_b + col), sb[1] = __ldg(p.ln_b + col + 4);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float y = __uint_as_float(f[kk][e]);
      if (LN) y = in ? (y - st[e & 1].x) * st[e & 1].y * sc[e >> 1] + sb[e >> 1] : 0.0f;
      f[kk][e] = tf32(y);
      lo[kk][e] = __float_as_uint(__fsub_rn(y, __uint_as_float(f[kk][e])));
    }
  }
}

// y_i's tiles for the column tiles [t0, t1) of blockIdx.x's group (every
// weight's), the row blocks blockIdx.y, + gridDim.y, ..., and the k-slices
// of range blockIdx.z.  With split > 1 each block writes its raw partial
// product to p.part and proj_split_reduce_f32 finishes the tiles.
//
// The products are WgmmaRsTf32 with A from registers: each consumer thread
// loads its fragments of A by ldmatrix from the fp32 slice (the resident
// panel, read from memory and normalised in place once per row block, or
// the stage's tile, normalised fragment by fragment), and splits them in
// registers, so A never passes through shared memory as hi and lo; the
// splitter warps split each stage's W tile (the B operand, which wgmma
// reads from shared memory) ahead of them.
template <int MODE, int BM, int BN, int STAGES, bool PANEL>
__global__ void __launch_bounds__(ProjTf32Tile<MODE, BM, BN, STAGES, PANEL>::kThreads, 1)
    proj_tf32_kernel(const __grid_constant__ ParamsF32 p) {
  typedef ProjTf32Tile<MODE, BM, BN, STAGES, PANEL> C;
  constexpr bool LN = MODE == kLnMatmuls || MODE == kGeglu;
  constexpr int OUT = C::OUT;
  constexpr int kWOffset = PANEL ? 0 : C::kATile;  // W hi's offset in a stage
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const Tf32Ring ring{smem_u32(smem + C::kBarOffset), STAGES};
  const uint32_t panel_full = ring.bars + 8 * 3 * STAGES, panel_empty = panel_full + 8;
  float2* stats = reinterpret_cast<float2*>(smem + C::kStatsOffset);
  uint8_t* panel = smem + C::kPanelOffset;
  const int tiles = p.n_w * p.col_tiles;
  const int t0 = range_start(blockIdx.x, tiles, gridDim.x);
  const int t1 = range_start(blockIdx.x + 1, tiles, gridDim.x);
  const int kb0 = range_start(blockIdx.z, p.kslices, p.split);
  const int kb1 = range_start(blockIdx.z + 1, p.kslices, p.split);
  const int row_blocks = (p.m + BM - 1) / BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    ring.init(4 * C::kConsumers, C::kSplitters);
    mbar_init(panel_full, 1);
    mbar_init(panel_empty, 4 * C::kConsumers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * C::kConsumers + C::kSplitters / 32) {
    // ---------------- producer warp (one lane): the panel, and the A and W
    // slices, by TMA
    if (lane == 0) {
      int it = 0, pass = 0;
      for (int rb = blockIdx.y; rb < row_blocks; rb += gridDim.y, ++pass) {
        if (PANEL) {
          if (pass > 0) mbar_wait(panel_empty, (pass - 1) & 1);
          mbar_expect_tx(panel_full, (kb1 - kb0) * C::kATile);
          for (int kb = kb0; kb < kb1; ++kb)
            tma_load_2d(smem_u32(panel + (kb - kb0) * C::kATile), &p.ta, panel_full, 32 * kb,
                        rb * BM);
        }
        for (int t = t0; t < t1; ++t) {
          const int wsel = t / p.col_tiles, n0 = (t % p.col_tiles) * OUT;
          // selects, not an indexed address, keep the maps in parameter space
          const CUtensorMap* mw = wsel == 0 ? &p.tw[0] : wsel == 1 ? &p.tw[1] : &p.tw[2];
          for (int kb = kb0; kb < kb1; ++kb, ++it) {
            const int s = it % STAGES;
            mbar_wait(ring.empty(s), ((it / STAGES) & 1) ^ 1);
            mbar_expect_tx(ring.full(s), kWOffset + C::kWTile);
            const uint32_t dst = smem_u32(smem + s * C::kStage);
            if (!PANEL) tma_load_2d(dst, &p.ta, ring.full(s), 32 * kb, rb * BM);
            if (MODE == kGeglu) {
              tma_load_2d(dst + kWOffset, &p.tw[0], ring.full(s), 32 * kb, n0);
              tma_load_2d(dst + kWOffset + BN / 2 * 128, &p.tw[1], ring.full(s), 32 * kb, n0);
            } else {
              tma_load_2d(dst + kWOffset, mw, ring.full(s), 32 * kb, n0);
            }
          }
        }
      }
    }
    return;
  }

  if (warp >= 4 * C::kConsumers) {
    // ---------------- splitter warps: every stage's W tile
    const int stid = threadIdx.x - 128 * C::kConsumers;
    int it = 0;
    for (int rb = blockIdx.y; rb < row_blocks; rb += gridDim.y)
      for (int t = t0; t < t1; ++t)
        for (int kb = kb0; kb < kb1; ++kb, ++it) {
          const int s = it % STAGES;
          mbar_wait(ring.full(s), (it / STAGES) & 1);
          uint8_t* w = smem + s * C::kStage + kWOffset;
          split_tile<BN, C::kSplitters>(w, w + C::kWTile, stid);
          fence_proxy_async();
          mbar_arrive(ring.ready(s));
        }
    return;
  }

  // ---------------- consumer warpgroups: 64 rows each
  const int wg = warp / 4, tid = threadIdx.x % 128, quad = lane % 4;
  const int r0 = (tid / 32) * 16 + lane / 4;  // the fragment's rows r0 and r0 + 8
  const int bar = 1 + wg;                     // the warpgroup's named barrier
  // this lane's ldmatrix row of the block's BM and which half of a k8 step
  const int lrow = wg * 64 + (tid / 32) * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int khalf = lane >> 4;
  const float g = MODE == kResidual ? (p.gate ? *p.gate : p.gate_value) : 1.0f;
  float acc[BN / 2], part[BN / 2];
  uint32_t fh[4][4], fl[4][4];
  float2 st[2] = {make_float2(0.0f, 1.0f), make_float2(0.0f, 1.0f)};
  const Turns turns{wg, C::kConsumers, 3};
  const int total = (row_blocks - (int)blockIdx.y + (int)gridDim.y - 1) / (int)gridDim.y *
                    (t1 - t0) * (kb1 - kb0);  // this block's steps
  int it = 0, pass = 0;
  for (int rb = blockIdx.y; rb < row_blocks; rb += gridDim.y, ++pass) {
    const int row0 = rb * BM + wg * 64;
    if constexpr (LN) {
      named_sync(bar, 128);  // every thread has its rows' statistics of the row block before
      row_stats(p, rb * BM, wg * 64, stats, tid);
      named_sync(bar, 128);
      st[0] = stats[wg * 64 + r0];
      st[1] = stats[wg * 64 + r0 + 8];
    }
    if (PANEL) {
      mbar_wait(panel_full, pass & 1);
      // a resident panel is normalised in place, once per row block, each
      // warpgroup its own rows: the tiles then only split their fragments
      if (LN) {
        normalise_panel_rows<BM>(panel, p, stats, wg * 64, kb0, kb1, tid);
        named_sync(bar, 128);
      }
    }
    for (int t = t0; t < t1; ++t) {
      const int wsel = t / p.col_tiles, n0 = (t % p.col_tiles) * OUT;
      for (int kb = kb0; kb < kb1; ++kb, ++it) {
        const int s = it % STAGES;
        uint8_t* stage = smem + s * C::kStage;
        if (!PANEL) mbar_wait(ring.full(s), (it / STAGES) & 1);  // the A tile
        const uint32_t a = smem_u32(PANEL ? panel + (kb - kb0) * C::kATile : stage) + lrow * 128;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          ldmatrix_x4(fh[kk], a + (((2 * kk + khalf) ^ (lrow & 7)) << 4));
        convert_frags<LN && !PANEL>(fh, fl, p, st, kb, quad);
        mbar_wait(ring.ready(s), (it / STAGES) & 1);
        uint32_t b = smem_u32(stage) + kWOffset;
        asm volatile("" : "+r"(b));
        pin(part);
        turns.wait(it);
        slice_rs<BN>(part, fh, fl, b, b + C::kWTile, true);
        turns.pass(it, total);
        wgmma_wait<0>();
        pin(part);
        if (lane == 0) mbar_arrive(ring.empty(s));
        add_slice(acc, part, kb == kb0);
      }
      // the row block's last products are done with the panel: each thread
      // orders its generic-proxy accesses (the in-place LayerNorm's stores,
      // ldmatrix) before the producer's next TMA into it, then one lane a
      // warp arrives
      if (PANEL && t + 1 == t1) {
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(panel_empty);
      }

      if (p.split > 1) {
        // the raw partial product, in wgmma column order: GEGLU's a half
        // at columns n0.., its gate half at f + n0..
        const int fw = MODE == kGeglu ? 2 * p.f : p.f;
        float* out = p.part + ((long long)blockIdx.z * p.n_w + wsel) * p.m * fw;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int c = 8 * j + 2 * quad;
          const int gate_half = MODE == kGeglu && c >= OUT;
          const int col = n0 + c - gate_half * OUT;
          if (col >= p.f) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = row0 + r0 + 8 * h;
            if (row < p.m)
              *reinterpret_cast<float2*>(out + (long long)row * fw + gate_half * p.f + col) =
                  make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          }
        }
        continue;
      }
      float* y = wsel == 0 ? p.y[0] : wsel == 1 ? p.y[1] : p.y[2];
#pragma unroll
      for (int j = 0; j < OUT / 8; ++j) {
        const int col = n0 + 8 * j + 2 * quad;
        if (col >= p.f) continue;
        float2 ba = make_float2(0.0f, 0.0f), bg = ba;
        if (MODE == kResidual || MODE == kGeglu)
          ba = __ldg(reinterpret_cast<const float2*>(p.bias + col));
        if (MODE == kGeglu) bg = __ldg(reinterpret_cast<const float2*>(p.bias + p.f + col));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long row = row0 + r0 + 8 * h;
          if (row >= p.m) continue;
          float y0 = acc[4 * j + 2 * h], y1 = acc[4 * j + 2 * h + 1];
          if constexpr (MODE == kResidual) {
            const float2 x = *reinterpret_cast<const float2*>(p.x + row * p.f + col);
            y0 = x.x + (y0 + ba.x) * g;
            y1 = x.y + (y1 + ba.y) * g;
          } else if constexpr (MODE == kGeglu) {
            const float g0 = acc[4 * (j + OUT / 8) + 2 * h] + bg.x;
            const float g1 = acc[4 * (j + OUT / 8) + 2 * h + 1] + bg.y;
            y0 = (y0 + ba.x) * (0.5f * g0 * (1.0f + erff(g0 * 0.7071067811865476f)));
            y1 = (y1 + ba.y) * (0.5f * g1 * (1.0f + erff(g1 * 0.7071067811865476f)));
          }
          *reinterpret_cast<float2*>(y + row * p.f + col) = make_float2(y0, y1);
        }
      }
    }
  }
}

// y_i = the partials summed in order 0, 1, ..., split - 1, then the mode's
// epilogue (as the kernel's); 4 columns a thread.
template <int MODE>
__global__ void proj_split_reduce_f32(const ParamsF32 p) {
  const int fw = MODE == kGeglu ? 2 * p.f : p.f;
  const long long per_w = (long long)p.m * p.f / 4, plane = (long long)p.n_w * p.m * fw;
  const float g = MODE == kResidual ? (p.gate ? *p.gate : p.gate_value) : 1.0f;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < per_w * p.n_w;
       i += (long long)gridDim.x * blockDim.x) {
    const int w = (int)(i / per_w);
    const long long e = (i - w * per_w) * 4, row = e / p.f;
    const int col = (int)(e - row * p.f);
    const float* src = p.part + ((long long)w * p.m + row) * fw + col;
    float4 y = *reinterpret_cast<const float4*>(src), gt = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (MODE == kGeglu) gt = *reinterpret_cast<const float4*>(src + p.f);
    for (int z = 1; z < p.split; ++z) {
      const float4 t = *reinterpret_cast<const float4*>(src + z * plane);
      y = make_float4(y.x + t.x, y.y + t.y, y.z + t.z, y.w + t.w);
      if (MODE == kGeglu) {
        const float4 u = *reinterpret_cast<const float4*>(src + z * plane + p.f);
        gt = make_float4(gt.x + u.x, gt.y + u.y, gt.z + u.z, gt.w + u.w);
      }
    }
    float v[4] = {y.x, y.y, y.z, y.w};
    if (MODE == kResidual || MODE == kGeglu) {
      const float4 ba = __ldg(reinterpret_cast<const float4*>(p.bias + col));
      const float b[4] = {ba.x, ba.y, ba.z, ba.w};
      if constexpr (MODE == kResidual) {
        const float4 x4 = *reinterpret_cast<const float4*>(p.x + row * p.f + col);
        const float x[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c] = x[c] + (v[c] + b[c]) * g;
      } else {
        const float4 bg4 = __ldg(reinterpret_cast<const float4*>(p.bias + p.f + col));
        const float gg[4] = {gt.x + bg4.x, gt.y + bg4.y, gt.z + bg4.z, gt.w + bg4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c)
          v[c] = (v[c] + b[c]) * (0.5f * gg[c] * (1.0f + erff(gg[c] * 0.7071067811865476f)));
      }
    }
    float* y_w = w == 0 ? p.y[0] : w == 1 ? p.y[1] : p.y[2];
    *reinterpret_cast<float4*>(y_w + row * p.f + col) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// Each row block's column tiles are cut into as few groups (blockIdx.x) as
// give the card's SMs a block each, with the split's ranges (blockIdx.z);
// the blocks of a group walk the row blocks (blockIdx.y, + gridDim.y, ...),
// so a block takes the LN statistics of each of its row blocks once, for
// all of its tiles.  The row block's A slices of a range stay resident
// (the panel, read once per row block) wherever they fit in shared memory
// (K = 320 at BM 128: 160 KB), else they stream with W.
template <int MODE, int BM, int BN, int STAGES, bool PANEL>
cudaError_t launch_f32_at(ParamsF32& p, cudaStream_t stream, size_t smem) {
  typedef ProjTf32Tile<MODE, BM, BN, STAGES, PANEL> C;
  const long long tiles = (long long)p.n_w * p.col_tiles;
  const long long row_blocks = (p.m + BM - 1) / BM;
  const long long groups = std::max<long long>(
      1, std::min<long long>(gligen::kSMs / (row_blocks * p.split), tiles));
  const long long slots = std::max<long long>(
      1, std::min<long long>(row_blocks, gligen::kSMs / (groups * p.split)));
  auto kernel = proj_tf32_kernel<MODE, BM, BN, STAGES, PANEL>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)groups, (unsigned)slots, (unsigned)p.split), C::kThreads, smem,
           stream>>>(p);
  return cudaGetLastError();
}

template <int MODE, int BM, int BN, int STAGES>
cudaError_t launch_f32(ParamsF32& p, const float* a, const float* const* w, cudaStream_t stream) {
  typedef ProjTf32Tile<MODE, BM, BN, STAGES, true> Panel;
  typedef ProjTf32Tile<MODE, BM, BN, STAGES, false> Stream;
  if (!make_map_2d_f32(&p.ta, a, p.k, p.m, BM)) return cudaErrorInvalidValue;
  if (MODE == kGeglu) {
    if (!make_map_2d_f32(&p.tw[0], w[0], p.k, p.f, BN / 2) ||
        !make_map_2d_f32(&p.tw[1], w[0] + (size_t)p.f * p.k, p.k, p.f, BN / 2))
      return cudaErrorInvalidValue;
  } else {
    for (int i = 0; i < p.n_w; ++i)
      if (!make_map_2d_f32(&p.tw[i], w[i], p.k, p.f, BN)) return cudaErrorInvalidValue;
  }
  p.a = a;
  p.col_tiles = (p.f + Panel::OUT - 1) / Panel::OUT;
  p.kslices = (p.k + 31) / 32;
  if (p.split < 1 || p.split > p.kslices || p.split > 65535 || (p.split > 1 && !p.part))
    return cudaErrorInvalidValue;
  const size_t panel = Panel::smem((p.kslices + p.split - 1) / p.split);
  cudaError_t err = panel <= kMaxBlockSmem
                        ? launch_f32_at<MODE, BM, BN, STAGES, true>(p, stream, panel)
                        : launch_f32_at<MODE, BM, BN, STAGES, false>(p, stream, Stream::smem(0));
  if (err != cudaSuccess || p.split == 1) return err;
  const long long vecs = (long long)p.n_w * p.m * p.f / 4;
  const int blocks = (int)std::min<long long>((vecs + 255) / 256, 8LL * gligen::kSMs);
  proj_split_reduce_f32<MODE><<<blocks, 256, 0, stream>>>(p);
  return cudaGetLastError();
}

// Launch MODE's fp32 route at (bm, bn, stages) if this library holds that
// configuration (the list above); any other, or a shape the kernel does
// not take, returns cudaErrorInvalidValue.
template <int MODE>
int dispatch_f32(ParamsF32& p, const float* a, const float* const* w, int bm, int bn, int stages,
                 void* stream) {
  if (p.m < 1 || p.k < 8 || p.f < 8 || p.k % 8 || p.f % 8 || p.n_w < 1 || p.n_w > kMaxWeights)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CASE(BM, BN, ST) \
  case tiles_key(BM, BN, ST): return (int)launch_f32<MODE, BM, BN, ST>(p, a, w, s);
  switch (tiles_key(bm, bn, stages)) { PROJ_F32_CONFIGS(CASE) }
#undef CASE
  return (int)cudaErrorInvalidValue;
}

ParamsF32 empty_params_f32(float* part, int split) {
  ParamsF32 p;
  memset(&p, 0, sizeof(p));
  p.gate_value = 1.0f;
  p.part = part;
  p.split = split;
  return p;
}

}  // namespace

// The fp32 routes: the same functions with fp32 x, h, weights, outputs (and
// fp32 norm parameters, bias and gate as above), at a configuration (bm,
// bn, stages) of the list above and `split` ranges of the 32-column
// k-slices (1 .. ceil(k / 32)); part is a (split, n_w, m, fw) fp32 scratch
// when split > 1 (fw = f, 2f for GEGLU), else unused.

extern "C" int ln_matmuls_f32(const float* x, const float* ln_s, const float* ln_b, int n_w,
                              const float* w0, const float* w1, const float* w2, float* y0,
                              float* y1, float* y2, int m, int k, int f, float eps, float* part,
                              int bm, int bn, int stages, int split, void* stream) {
  ParamsF32 p = empty_params_f32(part, split);
  p.ln_s = ln_s;
  p.ln_b = ln_b;
  const float* ws[kMaxWeights] = {w0, w1, w2};
  p.y[0] = y0, p.y[1] = y1, p.y[2] = y2;
  p.n_w = n_w;
  p.m = m, p.k = k, p.f = f;
  p.eps = eps;
  return dispatch_f32<kLnMatmuls>(p, x, ws, bm, bn, stages, stream);
}

extern "C" int matmul_residual_f32(const float* h, const float* w, const float* bias,
                                   const float* x, const float* gate, float gate_value, float* y,
                                   int m, int k, int f, float* part, int bm, int bn, int stages,
                                   int split, void* stream) {
  ParamsF32 p = empty_params_f32(part, split);
  const float* ws[1] = {w};
  p.y[0] = y;
  p.x = x;
  p.bias = bias;
  p.gate = gate;
  p.gate_value = gate_value;
  p.n_w = 1;
  p.m = m, p.k = k, p.f = f;
  return dispatch_f32<kResidual>(p, h, ws, bm, bn, stages, stream);
}

extern "C" int ln_geglu_f32(const float* x, const float* ln_s, const float* ln_b, const float* w,
                            const float* bias, float* y, int m, int k, int f, float eps,
                            float* part, int bm, int bn, int stages, int split, void* stream) {
  ParamsF32 p = empty_params_f32(part, split);
  const float* ws[1] = {w};
  p.ln_s = ln_s;
  p.ln_b = ln_b;
  p.y[0] = y;
  p.bias = bias;
  p.n_w = 1;
  p.m = m, p.k = k, p.f = f;
  p.eps = eps;
  return dispatch_f32<kGeglu>(p, x, ws, bm, bn, stages, stream);
}
#endif
