// Helpers shared by the package's CUDA sources: 16-byte bf16 / fp32 vectors
// and a warp sum.  Header only; every function is inline.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gligen {

typedef __nv_bfloat16 bf16;

constexpr int kSMs = 132;  // H100 SXM

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// 8 bf16 (one 16-byte vector) to fp32, and back with round-to-nearest-even.
__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

// 8 fp32 from a 16-byte aligned address, through the read-only cache.
__device__ __forceinline__ void load8f(const float* p, float* f) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(p));
  const float4 hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = lo.x, f[1] = lo.y, f[2] = lo.z, f[3] = lo.w;
  f[4] = hi.x, f[5] = hi.y, f[6] = hi.z, f[7] = hi.w;
}

__device__ __forceinline__ void store8f(float* p, const float* f) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// y * sigmoid(y) as two SFU operations: exp(-y) = 2^(-y log2 e) by
// ex2.approx and 1 / (1 + exp(-y)) by rcp.approx, each within ~2^-22 of
// the exact value, and no cancellation at negative y, so the result is the
// fp32 silu to a few fp32 ulps (the bf16 rounding that follows is 2^-9).
// -0 where exp(-y) overflows, as the limit is; y where it underflows.
__device__ __forceinline__ float silu(float y) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(e) : "f"(y * -1.4426950408889634f));
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(1.0f + e));
  return y * r;
}

}  // namespace gligen
