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
