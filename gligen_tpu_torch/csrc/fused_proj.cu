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
// kernel, with no LayerNorm statistics, the A tile copied as it is and the
// product stored: the same grid, row-block rule and GEMM core as the three
// above, so K2 - K7 is the cost of their prologues and epilogues and K7 -
// cuBLAS that of the core.  It must stay on K2's core to measure that.
// Numerics are the TPU kernels': per-row fp32 LayerNorm statistics in one pass
// (mean and mean of squares), the normalised row rounded to bf16 before the
// product, fp32 products, fp32 bias and gate, one rounding of the output.  The
// GELU is the exact erf form (erff); the TPU's polynomial _erf exists only
// because Mosaic has no erf.
//
// Layout.  Rows are the flattened (B, N) token axis, M = B*N of them; the last
// row tile is masked, so M needs no padding (the fuser's k/v run over
// B*(N+30) rows as they are).  Weights are nn.Linear's (F, K) rows, which is
// the column-major B operand of the product: no transpose copy.  K and F are
// multiples of 8, so every row moves in 16-byte vectors.
//
// Design.  One GEMM core (gemm_core.cuh, shared with fused_conv.cu) serves
// the three kernels: a block owns BM rows x 64 output columns (BM = 128
// with 8 warps, or 64 with 4 warps when 128-row blocks would not give two
// blocks per SM), walks K in steps of 32 through shared memory, and each
// warp multiplies its 32 x 32 part with WMMA bf16 16x16x16 (mma.sync) into
// fp32 fragments.  Each kernel adds its own A loader and epilogue:
//   * LN prologue: the block first computes its rows' fp32 mean and rstd over
//     the whole K (one warp per row, from L2), then normalises each A tile as
//     it loads it and rounds it to bf16 in shared memory.  The statistics are
//     recomputed by every column block instead of holding the normalised
//     (BM x K) tile whole: that tile would take 160 KB at K = 1280 and allow
//     one block per SM, while the recompute is one more read of rows that sit
//     in L2 (x is at most 10.5 MB at 512^2).
//   * residual epilogue: (acc + b) * g + x in fp32, g read from a device
//     scalar (the sampler's gate * tanh(alpha), never synchronised to the
//     host), or a constant when there is none.
//   * GEGLU epilogue: the block accumulates the a columns j and the gate
//     columns F + j side by side from one A tile (two weight slabs of the
//     core), adds the fp32 bias and stores a * 0.5 g (1 + erf(g / sqrt 2))
//     for F columns.
//   * ln_matmuls with k weights is one launch whose column blocks span all k
//     outputs, so one x row block feeds q, k and v from L2.
// The TPU kernel keeps the whole weight resident in VMEM with row blocks of
// 1024; here a block holds 64-row tiles of W, and the grid spans output
// columns as well as rows.  The middle block's 256 rows give 240 to 320
// blocks for the 3-weight q/k/v, the fuser's k/v and GEGLU, but only 80
// (4 row blocks x 20 column blocks) on 132 SMs for the single-weight q,
// to_out and net_2 launches: split-K, or a narrower column tile when the
// grid has fewer blocks than SMs, is the first lever there.
//
// What bounds it on the H100.  With K = C the products at ds1 (16,384 rows x
// 320) are compute-bound in principle: ln_geglu there is 26.8 GFLOP over
// 11 MB in and 42 MB out.  The mid shapes (256 rows) are launch- and
// occupancy-bound.  This first version is simple: WMMA instead of wgmma, no
// TMA, no cp.async pipeline over K, one block per output tile.  A pipelined K
// loop, wgmma on TMA-fed tiles and persistent blocks are the levers for a
// perf_opt change; PERF.md has the measured times beside the plain version's.

#include "gemm_core.cuh"

using namespace gligen;

namespace {

constexpr int kMaxWeights = 3;

enum Mode { kLnMatmuls = 0, kResidual = 1, kGeglu = 2, kMatmul = 3 };

struct Params {
  const bf16* a;                 // (M, K): x (LN modes) or h (residual, matmul)
  const float* ln_s;             // (K,) LayerNorm scale (LN modes)
  const float* ln_b;             // (K,) LayerNorm shift (LN modes)
  const bf16* w[kMaxWeights];    // (F, K) rows; GEGLU: one (2F, K)
  bf16* out[kMaxWeights];        // (M, F)
  const float* bias;             // (F,) residual, (2F,) GEGLU
  const bf16* res;               // (M, F) residual input
  const float* gate;             // device fp32 scalar, or null
  float gate_value;              // the gate when `gate` is null
  float eps;
  int m, k, f, n_w, col_blocks;
};

// Shared memory: the GEMM core's tiles and staging, then the LN statistics.
template <int MODE, int BM>
struct Smem {
  typedef GemmTile<BM, MODE == kGeglu ? 2 : 1> Tile;  // GEGLU: the a and gate slabs
  static constexpr size_t kStats = (Tile::kBytes + 127) / 128 * 128;
  static constexpr size_t kTotal = kStats + 2 * BM * sizeof(float);
};

template <int MODE, int BM>
__global__ void __launch_bounds__(BM * 2) fused_proj_kernel(const Params p) {
  typedef Smem<MODE, BM> L;
  typedef typename L::Tile T;
  constexpr int kWarps = T::kThreads / 32;
  constexpr bool kLn = MODE == kLnMatmuls || MODE == kGeglu;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sMean = reinterpret_cast<float*>(smem + L::kStats);
  float* sRstd = sMean + BM;

  const int wsel = blockIdx.x / p.col_blocks;
  const int n0 = (blockIdx.x % p.col_blocks) * T::kBN;
  const int m0 = blockIdx.y * BM;
  const int m_valid = min(BM, p.m - m0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16* a = p.a + (long long)m0 * p.k;
  // selects, not an indexed read, keep the pointer arrays out of local memory
  const bf16* w = wsel == 0 ? p.w[0] : wsel == 1 ? p.w[1] : p.w[2];

  if constexpr (kLn) {
    // _ln_rows: fp32 mean and mean of squares in one pass over the row.
    for (int r = warp; r < BM; r += kWarps) {
      float s = 0.0f, ss = 0.0f;
      if (r < m_valid) {
        const bf16* row = a + (long long)r * p.k;
        for (int c = lane * 8; c < p.k; c += 32 * 8) {
          float v[8];
          unpack8(*reinterpret_cast<const uint4*>(row + c), v);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            s += v[i];
            ss += v[i] * v[i];
          }
        }
      }
      s = warp_sum(s);
      ss = warp_sum(ss);
      if (lane == 0) {
        const float mean = s / p.k;
        const float var = fmaxf(ss / p.k - mean * mean, 0.0f);
        sMean[r] = mean;
        sRstd[r] = rsqrtf(var + p.eps);
      }
    }
  }

  // The A tile: rows of h (or x), or of x normalised with the row's statistics
  // (set before the core's first barrier) and rounded to bf16.
  T::product(smem, w, p.f, p.k, n0, [&](int k0, bf16* sA) {
    for (int i = threadIdx.x; i < BM * T::kChunks; i += T::kThreads) {
      const int r = i / T::kChunks, c = (i % T::kChunks) * 8, kc = k0 + c;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (r < m_valid && kc < p.k) {
        u = *reinterpret_cast<const uint4*>(a + (long long)r * p.k + kc);
        if constexpr (kLn) {
          float v[8], s[8], b[8];
          unpack8(u, v);
          load8f(p.ln_s + kc, s);
          load8f(p.ln_b + kc, b);
          const float mean = sMean[r], rstd = sRstd[r];
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = (v[j] - mean) * rstd * s[j] + b[j];
          u = pack8(v);
        }
      }
      *reinterpret_cast<uint4*>(sA + r * T::kLdt + c) = u;
    }
  });

  const float g = MODE == kResidual ? (p.gate ? *p.gate : p.gate_value) : 1.0f;
  bf16* out = wsel == 0 ? p.out[0] : wsel == 1 ? p.out[1] : p.out[2];
  T::epilogue(smem, m_valid, n0, p.f, [&](int r, int n, const float* row) {
    const long long off = (long long)(m0 + r) * p.f + n;
    float y[8];
    if constexpr (MODE == kLnMatmuls || MODE == kMatmul) {
#pragma unroll
      for (int j = 0; j < 8; ++j) y[j] = row[j];
    } else if constexpr (MODE == kResidual) {
      float x[8], b[8];
      unpack8(*reinterpret_cast<const uint4*>(p.res + off), x);
      load8f(p.bias + n, b);
#pragma unroll
      for (int j = 0; j < 8; ++j) y[j] = x[j] + (row[j] + b[j]) * g;
    } else {
      float ba[8], bg[8];
      load8f(p.bias + n, ba);
      load8f(p.bias + p.f + n, bg);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float av = row[j] + ba[j];
        const float gv = row[T::kBN + j] + bg[j];
        y[j] = av * (0.5f * gv * (1.0f + erff(gv * 0.7071067811865476f)));
      }
    }
    *reinterpret_cast<uint4*>(out + off) = pack8(y);
  });
}

template <int MODE, int BM>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const dim3 grid(p.n_w * p.col_blocks, (p.m + BM - 1) / BM);
  return launch_with_smem(fused_proj_kernel<MODE, BM>, grid, BM * 2, Smem<MODE, BM>::kTotal,
                          stream, p);
}

// 128-row blocks where they give at least two blocks per SM, else 64-row ones
// (the middle block's 256 rows, and ds4's single-weight launches).
template <int MODE>
int dispatch(Params& p, void* stream) {
  if (p.m < 1 || p.k < 8 || p.f < 8 || p.k % 8 || p.f % 8 || p.n_w < 1 || p.n_w > kMaxWeights ||
      (p.m + 63) / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  p.col_blocks = (p.f + kGemmBN - 1) / kGemmBN;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(wide_rows(p.m, (long long)p.n_w * p.col_blocks) ? launch<MODE, 128>(p, s)
                                                                 : launch<MODE, 64>(p, s));
}

Params empty_params() {
  Params p = {};
  p.gate_value = 1.0f;
  return p;
}

}  // namespace

// Plain C entry points for ctypes.  Each returns a cudaError_t (0 = launched).
// Every tensor is contiguous and 16-byte aligned; the caller checks shapes,
// dtypes and devices.  m is the number of rows, k the input width, f the
// output width.

// y_i = LN(x) @ w_i^T for i < n_w (1..3); x (m, k), w_i (f, k), y_i (m, f).
extern "C" int ln_matmuls_bf16(const void* x, const float* ln_s, const float* ln_b, int n_w,
                               const void* w0, const void* w1, const void* w2, void* y0, void* y1,
                               void* y2, int m, int k, int f, float eps, void* stream) {
  Params p = empty_params();
  p.a = static_cast<const bf16*>(x);
  p.ln_s = ln_s;
  p.ln_b = ln_b;
  const void* ws[kMaxWeights] = {w0, w1, w2};
  void* ys[kMaxWeights] = {y0, y1, y2};
  for (int i = 0; i < kMaxWeights; ++i) {
    p.w[i] = static_cast<const bf16*>(ws[i]);
    p.out[i] = static_cast<bf16*>(ys[i]);
  }
  p.n_w = n_w;
  p.m = m, p.k = k, p.f = f;
  p.eps = eps;
  return dispatch<kLnMatmuls>(p, stream);
}

// y = x + g * (h @ w^T + bias); h (m, k), w (f, k), bias (f,) fp32, x/y (m, f).
// g = *gate (a device fp32 scalar) when gate is not null, else gate_value.
extern "C" int matmul_residual_bf16(const void* h, const void* w, const float* bias, const void* x,
                                    const float* gate, float gate_value, void* y, int m, int k,
                                    int f, void* stream) {
  Params p = empty_params();
  p.a = static_cast<const bf16*>(h);
  p.w[0] = static_cast<const bf16*>(w);
  p.bias = bias;
  p.res = static_cast<const bf16*>(x);
  p.gate = gate;
  p.gate_value = gate_value;
  p.out[0] = static_cast<bf16*>(y);
  p.n_w = 1;
  p.m = m, p.k = k, p.f = f;
  return dispatch<kResidual>(p, stream);
}

// y = a * gelu(g), [a | g] = LN(x) @ w^T + bias; x (m, k), w (2f, k),
// bias (2f,) fp32, y (m, f).
extern "C" int ln_geglu_bf16(const void* x, const float* ln_s, const float* ln_b, const void* w,
                             const float* bias, void* y, int m, int k, int f, float eps,
                             void* stream) {
  Params p = empty_params();
  p.a = static_cast<const bf16*>(x);
  p.ln_s = ln_s;
  p.ln_b = ln_b;
  p.w[0] = static_cast<const bf16*>(w);
  p.bias = bias;
  p.out[0] = static_cast<bf16*>(y);
  p.n_w = 1;
  p.m = m, p.k = k, p.f = f;
  p.eps = eps;
  return dispatch<kGeglu>(p, stream);
}

// y = a @ w^T; a (m, k), w (f, k), y (m, f): the matmul-only mode (K7).
extern "C" int matmul_bf16(const void* a, const void* w, void* y, int m, int k, int f,
                           void* stream) {
  Params p = empty_params();
  p.a = static_cast<const bf16*>(a);
  p.w[0] = static_cast<const bf16*>(w);
  p.out[0] = static_cast<bf16*>(y);
  p.n_w = 1;
  p.m = m, p.k = k, p.f = f;
  return dispatch<kMatmul>(p, stream);
}
