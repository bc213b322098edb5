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

// y * sigmoid(y); -0 where exp(-y) overflows, as the limit is
__device__ __forceinline__ float silu(float y) { return y / (1.0f + expf(-y)); }

}  // namespace gligen
