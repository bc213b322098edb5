// A plain fp32 GEMM tile on the CUDA cores, for the fp32 routes of the fused
// projections (fused_proj.cu: ln_matmuls_f32, matmul_residual_f32,
// ln_geglu_f32) and of the fused conv (fused_conv.cu: gn_silu_conv3x3_f32).
//
// y = A @ W^T for a BM x BN output tile: A (M, K) is the caller's operand,
// produced element by element by a loader (the LayerNorm of x, h as it is, or
// the activated 3x3 neighbourhood of a pixel), and W (F, K) is row-major, so
// both are K-major.  Every product is an fp32 FMA of fp32 operands, summed in
// k order 0, 1, ..., K - 1 into one fp32 accumulator per output: no TF32, no
// split, no atomics, so a run repeats bit for bit and the result is the fp32
// product to the rounding of a K-long fp32 sum (what the JAX kernels' fp32
// dot, preferred_element_type=float32 on fp32 operands, answers to).
//
// 256 threads; the block stages BK = 16 columns of A (BM rows) and of W (BN
// rows, and BN more for ln_geglu's gate half, PAIR) in shared memory, k-major,
// and each thread accumulates a 4 x 4 register tile at rows ty + 16 i and
// columns tx + 16 j (tx = tid % 16, ty = tid / 16), so a warp reads 16
// consecutive W values and 2 A values a step.  Each thread brings 4 A and 4 W
// elements a stage as one float4 of a row (4 threads a row of 16 columns).
// A simple kernel: no ring and no overlap of loads with the FMAs.  What
// bounds it on the H100 is the fp32 FMA rate (67 TFLOP/s; 16 FMAs per 8
// shared-memory reads here hold it well below that).

#pragma once

#include <cuda_runtime.h>

namespace gemm32 {

constexpr int kBM = 64, kBN = 64, kBK = 16, kThreads = 256;

template <bool PAIR>
struct Smem {
  float a[kBK][kBM];
  float b[PAIR ? 2 : 1][kBK][kBN];
};

// W rows n0 + n (< f), columns k0 .. k0 + 3 (< k, which is a multiple of 4),
// as a float4; zeros past either edge.
__device__ __forceinline__ float4 load_w(const float* __restrict__ w, int f, int k, int n, int kk) {
  if (n >= f || kk >= k) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  return __ldg(reinterpret_cast<const float4*>(w + (long long)n * k + kk));
}

// acc[p][i][j] += sum over k of A(m0 + ty + 16 i, k) * W_p(n0 + tx + 16 j, k).
// load_a(row, col) gives A's float4 at (row, col .. col + 3), zeros for a
// row past M or a column past K; W_0 = w0, W_1 = w1 (PAIR), f rows each.
template <bool PAIR, typename LoadA>
__device__ __forceinline__ void mainloop(Smem<PAIR>& sm, LoadA load_a, const float* __restrict__ w0,
                                         const float* __restrict__ w1, int m0, int n0, int f,
                                         int k, float (&acc)[PAIR ? 2 : 1][4][4]) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int lr = tid / 4, lc = (tid % 4) * 4;  // the float4 this thread stages
#pragma unroll
  for (int p = 0; p < (PAIR ? 2 : 1); ++p)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[p][i][j] = 0.0f;
  for (int k0 = 0; k0 < k; k0 += kBK) {
    const float4 av = load_a(m0 + lr, k0 + lc);
    const float4 bv = load_w(w0, f, k, n0 + lr, k0 + lc);
    float4 gv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if constexpr (PAIR) gv = load_w(w1, f, k, n0 + lr, k0 + lc);
    __syncthreads();  // the previous stage's reads are done
    sm.a[lc][lr] = av.x, sm.a[lc + 1][lr] = av.y, sm.a[lc + 2][lr] = av.z, sm.a[lc + 3][lr] = av.w;
    sm.b[0][lc][lr] = bv.x, sm.b[0][lc + 1][lr] = bv.y;
    sm.b[0][lc + 2][lr] = bv.z, sm.b[0][lc + 3][lr] = bv.w;
    if constexpr (PAIR) {
      sm.b[1][lc][lr] = gv.x, sm.b[1][lc + 1][lr] = gv.y;
      sm.b[1][lc + 2][lr] = gv.z, sm.b[1][lc + 3][lr] = gv.w;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sm.a[kk][ty + 16 * i];
#pragma unroll
      for (int p = 0; p < (PAIR ? 2 : 1); ++p)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float b = sm.b[p][kk][tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[p][i][j] = fmaf(a[i], b, acc[p][i][j]);
        }
    }
  }
}

}  // namespace gemm32
