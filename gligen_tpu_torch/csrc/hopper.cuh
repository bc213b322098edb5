// Hopper (sm_90a) building blocks shared by the flash-attention kernels
// (flash_fwd.cu, flash_bwd.cu) and the projection GEMM core (gemm_sm90.cuh):
// mbarriers, 2-D and 4-D TMA loads, 2-D TMA stores, the wgmma fence/commit/wait and
// shared-memory descriptors, the fp32 helpers of a register-resident
// softmax, the copy route's plain loads into TMA's swizzled layout, and on
// the host the tensor maps and the rule for which operands TMA can read.
//
// Tiles are stored as TMA writes them with a 128-byte swizzle: 64-column
// (128-byte) atoms, each `rows` rows of 128 bytes, atoms one after another.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------- PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spin until the barrier's phase of this parity completes.  A wait that
// outlasts ~2^28 polls (seconds) is a protocol fault: trap, so the launch
// fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// A 2-D store of a shared-memory box to global memory (rows and columns
// past the map's extent are not written), its bulk group, and the wait
// until at most N groups are still reading shared memory.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(c0), "r"(c1), "r"(src)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Order this thread's plain shared-memory stores before the tensor cores'
// (async proxy) reads of the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses of wgmma's registers across the
// fence, commit and wait above.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle.  K-major operands
// (Q, K): LBO unused (1), SBO = 1024 B between 8-row groups.  MN-major (V):
// LBO = bytes between 64-column atoms, SBO = 1024 B between 8-key groups.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the special-function unit, one instruction (2^-inf = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Copy route: rows x (ATOMS*64) of a row-strided matrix into the swizzled
// stage layout TMA would write, by NT threads (tid in [0, NT)); rows >=
// valid and columns >= d become 0.
template <int ATOMS, int NT = 128>
__device__ __forceinline__ void copy_tile(uint8_t* dst, int rows, const bf16* src, long long sn,
                                          int valid, int d, int tid) {
  const bf16 zero = __float2bfloat16(0.0f);
  for (int i = tid; i < rows * ATOMS * 64; i += NT) {
    const int r = i / (ATOMS * 64), c = i % (ATOMS * 64), cc = c & 63;
    const int off = (c >> 6) * rows * 128 + r * 128 + (((cc >> 3) ^ (r & 7)) << 4) + (cc & 7) * 2;
    *reinterpret_cast<bf16*>(dst + off) = (r < valid && c < d) ? src[r * sn + c] : zero;
  }
}

// ------------------------------------------------------------ host side

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no link against libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A (d, head, row, batch) map of a bf16 tensor with a unit stride along d;
// boxes of 64 columns x `rows` rows of one (head, batch), 128-byte swizzled.
// Columns >= d and rows >= `len` read as zeros.
bool make_map(CUtensorMap* map, const void* base, int d, int heads, int len, int batch,
              long long sh, long long sn, long long sb, int rows) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)len, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)sn * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A (rows, cols) row-major bf16 matrix: boxes of `box_cols` (64 or 32)
// columns x `box_rows` rows, swizzled by the box row's bytes (128 or 64);
// columns >= cols and rows >= rows read as zeros and are not written.  The
// row stride is cols elements, so cols must be a multiple of 8 (16 bytes)
// and the base 16-byte aligned.
bool make_map_2d(CUtensorMap* map, const void* base, int cols, int rows, int box_rows,
                 int box_cols = 64) {
  EncodeTiled enc = encode_tiled();
  if (!enc || cols % 8 || reinterpret_cast<uintptr_t>(base) % 16) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// What TMA takes of one operand read through make_map: d a multiple of 8
// elements (16 bytes), heads packed at stride d, a 16-byte aligned base and
// positive batch and row strides that are multiples of 8 elements.
// ops/flash_attention.py:tma_ok is the same rule.
bool tma_operand_ok(const void* ptr, int d, long long sh, long long sb, long long sn) {
  return d % 8 == 0 && sh == d && reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && sb % 8 == 0 &&
         sn % 8 == 0 && sb > 0 && sn > 0;
}

}  // namespace
