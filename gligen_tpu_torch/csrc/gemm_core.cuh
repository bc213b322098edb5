// The WMMA GEMM core of fused_conv.cu (K6), its only user since the fused
// projections moved to the Hopper core of gemm_sm90.cuh: one block computes
// a BM x (NB * 64) tile of A @ W^T, bf16 operands, fp32 accumulate.
//
// A block of BM * 2 threads (BM = 128: 8 warps, or 64: 4 warps) walks K in
// steps of 32 through shared memory, and each warp multiplies its 32 x 32
// part of each of the NB 64-column slabs with WMMA bf16 16x16x16 (mma.sync)
// into fp32 fragments.  Per K step the caller's A loader fills the BM x 32 A
// tile, so a prologue (fused_conv's shifted GroupNorm affine and SiLU) runs
// as the tile is loaded; the core loads the weight
// tiles, rows n0 .. n0 + 63 of each slab of the (NB * f, k) row-major weight,
// which is the column-major B operand: no transpose copy.  After the loop the
// fp32 product is staged in the same shared bytes for the caller's epilogue.
// Header only.

#pragma once

#include <mma.h>

#include "common.cuh"

namespace gligen {

constexpr int kGemmBN = 64;  // output columns per slab of a block

template <int BM, int NB>
struct GemmTile {
  static constexpr int kBN = kGemmBN;
  static constexpr int kBK = 32;             // K step
  static constexpr int kLdt = kBK + 8;       // shared tile row, bf16 elements (80 bytes)
  static constexpr int kChunks = kBK / 8;    // 16-byte chunks per tile row
  static constexpr int kThreads = BM * 2;
  static constexpr int kLdc = NB * kBN + 4;  // fp32 staging row
  static constexpr size_t kTiles = (size_t)(BM + NB * kBN) * kLdt * sizeof(bf16);
  static constexpr size_t kStage = (size_t)BM * kLdc * sizeof(float);
  // shared bytes the core uses, from the start of the block's dynamic smem
  static constexpr size_t kBytes = kTiles > kStage ? kTiles : kStage;

  // load_a(k0, sA) stores the A tile for k0 .. k0 + 31: row r (0 .. BM-1),
  // k offset c at sA[r * kLdt + c], bf16, zeros past M or K.  Every thread
  // calls it once per step.  On return the product is staged at
  // staged(smem)[r * kLdc + t * kBN + j] (row r, slab t, column n0 + j) and
  // every thread can read it.
  template <class LoadA>
  static __device__ __forceinline__ void product(unsigned char* smem, const bf16* w, int f, int k,
                                                 int n0, LoadA&& load_a) {
    using namespace nvcuda;
    bf16* sA = reinterpret_cast<bf16*>(smem);
    bf16* sW = sA + BM * kLdt;
    const int warp = threadIdx.x / 32;
    const int wr = warp / 2, wc = warp % 2;  // the warp's 32 x 32 part of each slab

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NB][2][2];
#pragma unroll
    for (int t = 0; t < NB; ++t)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[t][i][j], 0.0f);

    for (int k0 = 0; k0 < k; k0 += kBK) {
      __syncthreads();  // the previous step's products are done with sA/sW
      load_a(k0, sA);
      for (int i = threadIdx.x; i < NB * kBN * kChunks; i += kThreads) {
        const int t = i / (kBN * kChunks), rem = i % (kBN * kChunks);
        const int r = rem / kChunks, c = (rem % kChunks) * 8, kc = k0 + c;
        const int n = n0 + r;
        uint4 u = make_uint4(0u, 0u, 0u, 0u);
        if (n < f && kc < k) u = *reinterpret_cast<const uint4*>(w + ((long long)t * f + n) * k + kc);
        *reinterpret_cast<uint4*>(sW + (t * kBN + r) * kLdt + c) = u;
      }
      __syncthreads();

#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], sA + (wr * 32 + i * 16) * kLdt + kk, kLdt);
#pragma unroll
        for (int t = 0; t < NB; ++t)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            // the weight's (F, K) rows are B = W^T in column-major order
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
            wmma::load_matrix_sync(fb, sW + (t * kBN + wc * 32 + j * 16) * kLdt + kk, kLdt);
#pragma unroll
            for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[t][i][j], fa[i], fb, acc[t][i][j]);
          }
      }
    }
    __syncthreads();  // every warp is done with the tiles: the staging reuses their bytes

    float* sC = staged(smem);
#pragma unroll
    for (int t = 0; t < NB; ++t)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::store_matrix_sync(sC + (wr * 32 + i * 16) * kLdc + t * kBN + wc * 32 + j * 16,
                                  acc[t][i][j], kLdc, wmma::mem_row_major);
    __syncthreads();
  }

  static __device__ __forceinline__ float* staged(unsigned char* smem) {
    return reinterpret_cast<float*>(smem);
  }

  // epi(r, n, st) for each 8-column chunk of the staged product that lies
  // in the output: block row r < m_valid, output column n = n0 + c < f, st
  // the chunk's 8 fp32 values of slab 0 (slab t's at st + t * kBN).
  template <class Epilogue>
  static __device__ __forceinline__ void epilogue(unsigned char* smem, int m_valid, int n0, int f,
                                                  Epilogue&& epi) {
    const float* sC = staged(smem);
    for (int i = threadIdx.x; i < BM * (kBN / 8); i += kThreads) {
      const int r = i / (kBN / 8), c = (i % (kBN / 8)) * 8, n = n0 + c;
      if (r < m_valid && n < f) epi(r, n, sC + r * kLdc + c);
    }
  }
};

// Launches kernel<<<grid, threads, smem>>>(p) after allowing it `smem`
// bytes of dynamic shared memory.
template <class Kernel, class P>
cudaError_t launch_with_smem(Kernel kernel, dim3 grid, int threads, size_t smem,
                             cudaStream_t stream, const P& p) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// 128-row blocks where they give at least two blocks per SM, else 64-row ones.
inline bool wide_rows(long long m, long long col_blocks) {
  return (m + 127) / 128 * col_blocks >= 2 * kSMs;
}

}  // namespace gligen
