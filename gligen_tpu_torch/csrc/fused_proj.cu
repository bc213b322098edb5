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
// normalised row), and the products are fp32 FMAs on the CUDA cores
// (gemm_f32.cuh), never one-pass TF32: the JAX kernels' fp32 dot answers to
// an fp32 plain version.  A simple kernel: 64 x 64 output tiles, the LN
// statistics of a tile's 64 rows computed by its block (a warp a row) and
// applied as the A tile is staged, so each column tile recomputes them.
// Bound by the fp32 FMA rate.
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
#include "gemm_f32.cuh"
#include "gemm_sm90.cuh"

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

namespace {

struct ParamsF32 {
  const float* a;                // A (m, k): x (LN modes) or h
  const float* w[kMaxWeights];   // W_i (f, k); GEGLU: w[0] (2f, k), a rows then gate rows
  float* y[kMaxWeights];         // y_i (m, f)
  const float* x;                // the residual input (m, f)
  const float* ln_s;             // (k,) LayerNorm scale (LN modes)
  const float* ln_b;             // (k,) LayerNorm shift (LN modes)
  const float* bias;             // (f,) residual, (2f,) GEGLU
  const float* gate;             // device fp32 scalar, or null
  float gate_value;              // the gate when `gate` is null
  float eps;
  int m, k, f;
};

// One 64 x 64 tile of output blockIdx.z (a weight of ln_matmuls) at row block
// blockIdx.x and column tile blockIdx.y.
template <int MODE>
__global__ void __launch_bounds__(gemm32::kThreads) fused_proj_f32_kernel(const ParamsF32 p) {
  constexpr bool LN = MODE == kLnMatmuls || MODE == kGeglu, PAIR = MODE == kGeglu;
  __shared__ gemm32::Smem<PAIR> sm;
  __shared__ float mean[gemm32::kBM], rstd[gemm32::kBM];
  const int m0 = blockIdx.x * gemm32::kBM, n0 = blockIdx.y * gemm32::kBN, wsel = blockIdx.z;
  if constexpr (LN) {
    // _ln_rows' statistics of the tile's rows in fp32, a warp a row: one
    // pass of sums and sums of squares, the variance clamped at 0
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int r = warp; r < gemm32::kBM; r += gemm32::kThreads / 32) {
      const long long row = m0 + r;
      float s = 0.0f, ss = 0.0f;
      if (row < p.m)
        for (int c = lane; c < p.k; c += 32) {
          const float v = p.a[row * p.k + c];
          s += v;
          ss += v * v;
        }
      s = gligen::warp_sum(s);
      ss = gligen::warp_sum(ss);
      if (lane == 0) {
        const float mu = s / p.k;
        mean[r] = mu;
        rstd[r] = rsqrtf(fmaxf(ss / p.k - mu * mu, 0.0f) + p.eps);
      }
    }
    __syncthreads();
  }
  auto load_a = [&](int row, int col) {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row >= p.m || col >= p.k) return v;
    v = __ldg(reinterpret_cast<const float4*>(p.a + (long long)row * p.k + col));
    if constexpr (LN) {
      const float mu = mean[row - m0], rs = rstd[row - m0];
      const float4 s = __ldg(reinterpret_cast<const float4*>(p.ln_s + col));
      const float4 b = __ldg(reinterpret_cast<const float4*>(p.ln_b + col));
      v = make_float4((v.x - mu) * rs * s.x + b.x, (v.y - mu) * rs * s.y + b.y,
                      (v.z - mu) * rs * s.z + b.z, (v.w - mu) * rs * s.w + b.w);
    }
    return v;
  };
  // selects, not an indexed address: the pointers stay in parameter space
  const float* w = wsel == 0 ? p.w[0] : wsel == 1 ? p.w[1] : p.w[2];
  float* y = wsel == 0 ? p.y[0] : wsel == 1 ? p.y[1] : p.y[2];
  float acc[PAIR ? 2 : 1][4][4];
  gemm32::mainloop<PAIR>(sm, load_a, w, PAIR ? w + (long long)p.f * p.k : nullptr, m0, n0, p.f,
                         p.k, acc);
  const float g = MODE == kResidual ? (p.gate ? *p.gate : p.gate_value) : 1.0f;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (row >= p.m || col >= p.f) continue;
      float out = acc[0][i][j];
      if constexpr (MODE == kResidual) {
        out = p.x[row * p.f + col] + (out + p.bias[col]) * g;
      } else if constexpr (MODE == kGeglu) {
        const float gg = acc[PAIR][i][j] + p.bias[p.f + col];
        out = (out + p.bias[col]) * (0.5f * gg * (1.0f + erff(gg * 0.7071067811865476f)));
      }
      y[row * p.f + col] = out;
    }
  }
}

template <int MODE>
int launch_f32(const ParamsF32& p, int n_w, void* stream) {
  if (p.m < 1 || p.k < 8 || p.f < 8 || p.k % 8 || p.f % 8 || n_w < 1 || n_w > kMaxWeights)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((p.m + gemm32::kBM - 1) / gemm32::kBM, (p.f + gemm32::kBN - 1) / gemm32::kBN,
                  n_w);
  fused_proj_f32_kernel<MODE>
      <<<grid, gemm32::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

ParamsF32 empty_params_f32() {
  ParamsF32 p;
  memset(&p, 0, sizeof(p));
  p.gate_value = 1.0f;
  return p;
}

}  // namespace

// The fp32 routes: the same functions with fp32 x, h, weights, outputs (and
// fp32 norm parameters, bias and gate as above), no tile arguments.

extern "C" int ln_matmuls_f32(const float* x, const float* ln_s, const float* ln_b, int n_w,
                              const float* w0, const float* w1, const float* w2, float* y0,
                              float* y1, float* y2, int m, int k, int f, float eps, void* stream) {
  ParamsF32 p = empty_params_f32();
  p.a = x;
  p.ln_s = ln_s;
  p.ln_b = ln_b;
  p.w[0] = w0, p.w[1] = w1, p.w[2] = w2;
  p.y[0] = y0, p.y[1] = y1, p.y[2] = y2;
  p.m = m, p.k = k, p.f = f;
  p.eps = eps;
  return launch_f32<kLnMatmuls>(p, n_w, stream);
}

extern "C" int matmul_residual_f32(const float* h, const float* w, const float* bias,
                                   const float* x, const float* gate, float gate_value, float* y,
                                   int m, int k, int f, void* stream) {
  ParamsF32 p = empty_params_f32();
  p.a = h;
  p.w[0] = w;
  p.y[0] = y;
  p.x = x;
  p.bias = bias;
  p.gate = gate;
  p.gate_value = gate_value;
  p.m = m, p.k = k, p.f = f;
  return launch_f32<kResidual>(p, 1, stream);
}

extern "C" int ln_geglu_f32(const float* x, const float* ln_s, const float* ln_b, const float* w,
                            const float* bias, float* y, int m, int k, int f, float eps,
                            void* stream) {
  ParamsF32 p = empty_params_f32();
  p.a = x;
  p.ln_s = ln_s;
  p.ln_b = ln_b;
  p.w[0] = w;
  p.y[0] = y;
  p.bias = bias;
  p.m = m, p.k = k, p.f = f;
  p.eps = eps;
  return launch_f32<kGeglu>(p, 1, stream);
}
#endif
