// Hopper (sm_90a) building blocks shared by the flash-attention kernels
// (flash_fwd.cu, flash_bwd.cu), the projection GEMM core (gemm_sm90.cuh)
// and the fp32 routes' 3xTF32 core (gemm_tf32.cuh): mbarriers, 2-D and 4-D
// TMA loads, 2-D TMA stores, the wgmma fence/commit/wait and shared-memory
// descriptors, the TF32 split of an fp32 operand, the fp32 flash kernels'
// row loads and transposed operand stores, the fp32 helpers of a
// register-resident softmax, the copy route's plain loads into TMA's
// swizzled layout, and on the host the tensor maps and the rule for which
// operands TMA can read.
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

// Four 8 x 8 matrices of 16-bit pairs (or 32-bit values: a row of 16 bytes)
// from shared memory, each lane giving one row's address: lanes 8i..8i+7
// matrix i's rows; r[i] is matrix i's (row lane / 4, word lane % 4).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// Keep the compiler from moving accesses of wgmma's registers across the
// fence, commit and wait above.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// The same for TF32 A fragments held as 32-bit words.
template <int N>
__device__ __forceinline__ void pin_u(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle.  K-major operands
// (Q, K): LBO unused (1), SBO = 1024 B between 8-row groups.  MN-major (V):
// LBO = bytes between 64-column atoms, SBO = 1024 B between 8-key groups.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// The same with a 64-byte swizzle (rows of 64 bytes, the 16-byte chunk c
// of row r at c ^ ((r >> 1) & 3), a pattern of 8 rows = 512 bytes): K-major,
// SBO = 512 B between 8-row groups.
__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (2ull << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// TF32 of x, rounded to nearest with ties away from zero, as a 32-bit
// operand: what cvt.rna.tf32.f32 gives, by two integer operations (half a
// TF32 ulp added to the magnitude's bits, the low 13 bits cleared), since
// cvt runs on the conversion pipe at a quarter of the integer rate.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to ~2^-22 relative: lo = x - hi is exact in fp32 and is
// rounded too, since wgmma reads only a TF32 operand's top 19 bits.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// x = hi + lo: hi = rna(x) as TF32, lo = x - hi (exact), left for the
// tensor cores to truncate to TF32.
__device__ __forceinline__ void split_tc(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

// Columns col..col + 7 of row `row` (zeros at rows >= rows, columns >= d).
__device__ __forceinline__ void load8(float4 (&x)[2], const float* base, long long sn, int row,
                                      int rows, int col, int d) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
    x[i] = row < rows && col + 4 * i < d
               ? *reinterpret_cast<const float4*>(base + row * sn + col + 4 * i)
               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// Row `key` of a tile, its columns 8 cg..8 cg + 7, split into a transposed
// operand (V^T of the fp32 flash forward; K^T, Q^T, dO^T of its backward):
// row n = the column, atoms of KEYS keys (32: rows of 128 bytes, 128-byte
// swizzled; 16: rows of 64 bytes, 64-byte swizzled) and D rows; within an
// 8-key step key 2i at k = i and key 2i + 1 at k = 4 + i, the order of the
// TF32 A fragment a thread takes from an accumulator (keys 2t and 2t + 1
// of each step), so P and dS feed the products from registers.
template <int D, int KEYS = 32>
__device__ __forceinline__ void store_vt8(uint8_t* hi, uint8_t* lo, int key, int cg,
                                          const float4 (&x)[2]) {
  static_assert(KEYS == 32 || KEYS == 16, "32- or 16-key atoms");
  constexpr int kRow = 4 * KEYS;
  const int kk = key % 8, word = (key % KEYS) / 8 * 8 + (kk & 1) * 4 + kk / 2;
  const int base = (key / KEYS) * D * kRow + 8 * cg * kRow + (word % 4) * 4;
  const float v[8] = {x[0].x, x[0].y, x[0].z, x[0].w, x[1].x, x[1].y, x[1].z, x[1].w};
#pragma unroll
  for (int e = 0; e < 8; ++e) {  // row 8 cg + e, whose swizzle is e (128 B) or e / 2 (64 B)
    const int off = base + e * kRow + (((word / 4) ^ (KEYS == 32 ? e : e / 2)) << 4);
    uint32_t h, l;
    split_tc(v[e], h, l);
    *reinterpret_cast<uint32_t*>(hi + off) = h;
    *reinterpret_cast<uint32_t*>(lo + off) = l;
  }
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

// A (d, head, row, batch) map of a tensor with a unit stride along d and
// `elem` bytes an element (2: bf16, 4: fp32); boxes of 128 bytes (64 bf16
// or 32 fp32 columns) x `rows` rows of one (head, batch), 128-byte
// swizzled.  Columns >= d and rows >= `len` read as zeros.
bool make_map(CUtensorMap* map, const void* base, int d, int heads, int len, int batch,
              long long sh, long long sn, long long sb, int rows, int elem = 2) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)len, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)(sh * elem), (cuuint64_t)(sn * elem),
                                 (cuuint64_t)(sb * elem)};
  const cuuint32_t box[4] = {(cuuint32_t)(128 / elem), 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, elem == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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

// A (rows, cols) row-major fp32 matrix: boxes of 32 columns (128 bytes) x
// `box_rows` rows, 128-byte swizzled (or, with swizzle false, rows as they
// are); columns outside [0, cols) and rows outside [0, rows) read as
// zeros.  The row stride is cols elements, so cols must be a multiple of 4
// (16 bytes) and the base 16-byte aligned.
bool make_map_2d_f32(CUtensorMap* map, const void* base, int cols, int rows, int box_rows,
                     bool swizzle = true) {
  EncodeTiled enc = encode_tiled();
  if (!enc || cols % 4 || reinterpret_cast<uintptr_t>(base) % 16) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t box[2] = {32, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
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
