// The 3xTF32 core of the fp32 routes of the fused projections (fused_proj.cu:
// ln_matmuls_f32, matmul_residual_f32, ln_geglu_f32) and of the fused conv
// (fused_conv.cu: gn_silu_conv3x3_f32): y = A @ W^T with fp32 operands on
// the tensor cores, at fp32 accuracy.
//
// wgmma has no fp32 operands and one TF32 pass keeps ~3 digits, so each
// operand value is split, x = hi + lo, and a b ~ hi_a hi_b + hi_a lo_b +
// lo_a hi_b, which drops ~2^-22 of each product, as the flash kernel's fp32
// route does (flash_fwd.cu).  split4: hi = rna(x), TF32 (hopper.cuh:tf32);
// lo = x - hi, exact in fp32, left to the tensor cores, which read a TF32
// operand's top 19 bits, to truncate (2^-21 of x at most, one rounding op a
// value fewer than rounding it).  TF32 wgmma has no transposed operand, so
// both operands are K-major: A (M, K) and W (F, K) as they are stored.
//
// Operand tiles are k-slices of 32 fp32 columns: rows of 128 bytes, the
// 16-byte chunk c of row r stored at chunk c ^ (r & 7), as TMA writes a box
// of 32 fp32 columns with a 128-byte swizzle and as wgmma's descriptors
// (sw128_desc) and ldmatrix read it.  The products are WgmmaRsTf32: A (the
// activations) from registers, split by the consumer threads that load it,
// and B (the weights) from shared memory, split in place by splitter warps
// (split_tile: hi over the fp32 value, lo into the stage's lo tile at the
// same offset, so the swizzle carries over) once a producer warp's TMA has
// brought the stage; they fence their writes for the tensor cores
// (fence.proxy.async) and arrive on the stage's "ready" barrier.  Barriers
// per stage: full (TMA bytes), ready (the splitting threads), empty (every
// consumer warp).  A block of two consumer warpgroups stays within 12
// warps, at most three on each of the SM's four schedulers, whose 16K
// registers then give a thread up to 168 (a thirteenth warp would cut that
// to 128).
//
// The tensor cores do not round a chain of accumulations to nearest, so the
// error of one accumulator over a long K grows with K (~2^-24 of the
// running sum per step, one-sided).  Each chain starts from zero in `part`
// (the projections': one k-slice's 12 products, 4 k8 steps x 3 passes; the
// conv's: a 32-channel slice's nine taps, 108) and the chains are added in
// fp32 in a fixed order into `acc`.  No atomics: a run repeats bit for bit.
//
// Header only.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_sm90.cuh"
#include "hopper.cuh"
#include "wgmma.cuh"

namespace {

// The ring's barriers: full(s), ready(s) and empty(s) of each of `stages`.
struct Tf32Ring {
  uint32_t bars;
  int stages;
  __device__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ uint32_t ready(int s) const { return bars + 8 * (stages + s); }
  __device__ uint32_t empty(int s) const { return bars + 8 * (2 * stages + s); }
  // thread 0, before the block's first __syncthreads: `splitters` threads
  // arrive on ready, each consumer warp's first lane on empty
  __device__ void init(int consumer_warps, int splitters) const {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(ready(s), splitters);
      mbar_init(empty(s), consumer_warps);
    }
  }
};

// 4 fp32 values into their hi (TF32) and lo (for the tensor cores to
// truncate) halves.
__device__ __forceinline__ void split4(const float4& v, uint4& hi, uint4& lo) {
  hi = make_uint4(tf32(v.x), tf32(v.y), tf32(v.z), tf32(v.w));
  lo = make_uint4(__float_as_uint(__fsub_rn(v.x, __uint_as_float(hi.x))),
                  __float_as_uint(__fsub_rn(v.y, __uint_as_float(hi.y))),
                  __float_as_uint(__fsub_rn(v.z, __uint_as_float(hi.z))),
                  __float_as_uint(__fsub_rn(v.w, __uint_as_float(hi.w))));
}

// NT threads (tid 0..NT - 1): a tile of ROWS 128-byte rows of fp32 as TMA
// wrote it, split in place into hi, and lo at the same offsets of `lo`;
// each thread's loads are all issued before any chunk is split.
template <int ROWS, int NT>
__device__ __forceinline__ void split_tile(uint8_t* hi, uint8_t* lo, int tid) {
  constexpr int kIters = (ROWS * 8 + NT - 1) / NT;
  float4 v[kIters];
#pragma unroll
  for (int u = 0; u < kIters; ++u) {
    const int i = tid + NT * u;
    if (i < ROWS * 8) v[u] = *reinterpret_cast<const float4*>(hi + 16 * i);
  }
#pragma unroll
  for (int u = 0; u < kIters; ++u) {
    const int i = tid + NT * u;
    if (i >= ROWS * 8) break;
    uint4 h, l;
    split4(v[u], h, l);
    *reinterpret_cast<uint4*>(hi + 16 * i) = h;
    *reinterpret_cast<uint4*>(lo + 16 * i) = l;
  }
}

// One consumer warpgroup: the 3xTF32 product of one 32-column k-slice into
// part, from zero where `fresh`, else onto it: A from registers, hi[kk] /
// lo[kk] the fragments of k8 step kk (four TF32 values a thread, as
// ldmatrix gives them: rows g and g + 8, columns t and t + 4), against the
// W tile's BN rows at b_hi / b_lo (shared memory, by descriptor).  Issued
// and committed; the caller waits.
template <int BN>
__device__ __forceinline__ void slice_rs(float (&part)[BN / 2], const uint32_t (&hi)[4][4],
                                         const uint32_t (&lo)[4][4], uint32_t b_hi, uint32_t b_lo,
                                         bool fresh) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t bh = sw128_desc(b_hi + 32 * kk, 16, 1024);
    const uint64_t bl = sw128_desc(b_lo + 32 * kk, 16, 1024);
    WgmmaRsTf32<BN>::rs(part, hi[kk], bh, kk > 0 || !fresh);
    WgmmaRsTf32<BN>::rs(part, hi[kk], bl, 1);
    WgmmaRsTf32<BN>::rs(part, lo[kk], bh, 1);
  }
  wgmma_commit();
}

// Turns between a block's n consumer warpgroups (named barriers first ..
// first + n - 1): warpgroup wg issues a step's products once warpgroup wg - 1
// has issued its own (warpgroup 0 once the last has, for the step before),
// so the tensor cores serve them in turn and each one's CUDA-core work (its
// next fragments) runs under the next one's products, where issuing at once
// would make them all wait at once.  The projections take turns; the conv,
// whose consumers convert under their own products, ran slower with them
// and does not.
struct Turns {
  int wg, n, first;
  // before issuing step `step` of `total`, and after
  __device__ void wait(int step) const {
    if (n > 1 && (wg > 0 || step > 0)) named_sync(first + wg, 128 * n);
  }
  __device__ void pass(int step, int total) const {
    if (n > 1 && (wg + 1 < n || step + 1 < total)) named_arrive(first + (wg + 1) % n, 128 * n);
  }
};

// acc = part (the first slice) or acc + part, in fp32.
template <int N>
__device__ __forceinline__ void add_slice(float (&acc)[N], const float (&part)[N], bool first) {
  if (first) {
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = part[i];
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] += part[i];
  }
}

// Ranges of `total` items cut into `parts` in order: part z's first item.
__device__ __forceinline__ int range_start(int z, int total, int parts) {
  return (int)((long long)z * total / parts);
}

}  // namespace
