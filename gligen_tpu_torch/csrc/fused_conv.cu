// Fused GroupNorm-affine -> SiLU -> SAME 3x3 conv (-> + residual) for Hopper
// (sm_90a): bf16 in / bf16 out, fp32 accumulation.
//
// Replaces the TPU Pallas kernel of gligen_tpu/ops/pallas_conv.py: _fused
// (pallas_call at :141, body _kernel :79), reached from gn_silu_conv3x3 :174.
// It computes, for x (B, H, W, C) NHWC and the per-(sample, channel) GroupNorm
// affine a, v (B, C) of fused_norm.cu's gn_affine_bf16:
//   xn  = bf16(silu(x * a + v))                      (fp32, one rounding: :85-89)
//   out = conv3x3_SAME(xn, w) + bias (+ residual)    (fp32 accumulate, one cast)
// The zero padding comes after the activation (:90): a tap outside the image
// adds exactly 0, not silu(v).
//
// Design.  The TPU kernel keeps one whole image in VMEM and runs nine shifted
// (H*W, C) @ (C, F) matmuls.  Here the conv is an implicit GEMM: M = B*H*W
// output pixels (rows, in (b, y, x) order), N = F output channels, K = 9*C
// with k = (tap, c), tap = 3 * (dy + 1) + (dx + 1), on the pieces of the
// Hopper core (gemm_sm90.cuh, hopper.cuh, wgmma.cuh).  A block owns BM rows
// x BN columns and a range of 64-channel slices (all of them, or 1 / split
// of them), and is warp-specialised:
//   * one TMA warp keeps the weight ring full: per (slice, tap) step the BN x
//     64 tile of the (F, 9C) weight at column tap * C + 64 * slice, 128-byte
//     swizzled, as gemm_sm90.cuh's load_tile does;
//   * one activation warpgroup brings in, per slice, the halo the block's rows
//     need -- their pixels shifted by -W-1 .. W+1 in (b, y, x) order, which
//     is every in-image neighbour -- with plain 16-byte loads (the values
//     have to pass through registers for the transform anyway), applies
//     x * a + v and SiLU once per element in fp32 with each pixel's own
//     sample's a and v (a tile may span samples: at 8^2 a sample is 64
//     rows), rounds to bf16 and stores it swizzled into one of two halo
//     buffers; channels past C are stored as 0;
//   * BM / 64 consumer warpgroups run the nine taps of each slice as nine
//     k-steps of wgmma with A from registers (WgmmaRs): each lane's ldmatrix
//     row address is its output pixel's neighbour row in the halo, or a row
//     of zeros where that neighbour lies outside the image (or the row past
//     M).  So the zero padding is applied after the activation, per row and
//     tap, for any H and W: no shift has to keep an 8-row swizzle atom
//     whole, which a shared-memory A descriptor would need (and which a one-
//     pixel shift breaks), and no ragged W needs its own route.
// The halo is one window of BM + 2W + 2 rows (each element activated
// (1 + (2W + 2) / BM) times per column tile instead of 9), or, where W is so
// wide that three separate windows of BM + 2 rows (one per dy) are smaller,
// those.  Its rows are 128 bytes with the 16-byte chunks XOR-swizzled by row,
// so the 8 rows of an ldmatrix phase fall in distinct banks.
//   * split-K (split > 1, the 8^2 and 16^2 shapes whose row and column tiles
//     alone leave SMs idle): each block writes its fp32 partial product to a
//     (split, M, F) workspace, and conv_split_reduce adds the partials in
//     order 0 .. split-1, then the bias and the residual: no float atomics,
//     so two runs give the same bits.  Without split the epilogue adds the
//     bias and the residual (brought into the staging tile by TMA while the
//     products run) in registers and stores bf16 by TMA, as fused_proj.cu's.
// The tile configuration (BM, BN, stages) and split come from the wrapper's
// table (ops/fused_conv.py:CONV_TILES, conv_plan); this library is built at
// exactly the table's configurations (CONV_CONFIGS below), and
// fused_conv_sweep.cu at those of perf_probe.py convs --sweep.
//
// fp32 route (gn_silu_conv3x3_f32): fp32 x, a, v, weights, residual and
// output, for a model served in fp32 (the JAX kernel computes in x.dtype,
// pallas_conv.py:191-200): the same function with no bf16 rounding of the
// activation, the implicit GEMM as 3xTF32 wgmma (gemm_tf32.cuh), never
// one-pass TF32.  Its affine comes from fused_norm.cu's gn_affine_f32.
//
// What bounds it on the H100: the tensor cores at the TF32 rate, three
// products per fp32 one (64^2, 320 -> 320 at 4 UNet rows: 3 x 30.2 GFLOP,
// 0.183 ms at 495 TFLOP/s; 8^2, 2560 -> 1280: 3 x 15.1 GFLOP, 0.092 ms
// over 118 MB of fp32 weights, 0.035 ms); beside them the CUDA cores' work
// (each halo value activated, by two SFU operations, and split; each weight
// tile split) and shared memory, through which every operand passes as
// fp32 and again as hi and lo.  What the design does about it: the bf16
// kernel's implicit GEMM with fp32 operands split into TF32 halves --
//   * the consumers' ldmatrix rows are the bf16 kernel's (a k8 step of fp32
//     is the same 32 bytes as a k16 step of bf16), so the zero padding after
//     the activation is its zero row, and the nine taps are WgmmaRsTf32 with
//     A from registers (hi and lo fragments) against the weight tile's hi
//     and lo; a slice's nine taps (108 products) start from zero and are
//     added in fp32 (K is 23,040 at 8^2);
//   * the producer warp brings each slice's raw halo rows by TMA (two or
//     three boxes), and the consumer warps activate them, once per halo
//     element and 32-channel slice, into hi and lo halo buffers: the next
//     slice's, in five parts, under the products of this slice's last five
//     taps (4-8), where the work is spread over all 8 consumer warps instead of
//     waiting on a few warps of its own;
//   * one splitter warp splits each (F, 9C) weight tile in place as the
//     producer's TMA ring brings it;
//   * split-K wherever the tiles leave the card's SMs idle or end in a
//     ragged last wave (8^2, 16^2: ops/fused_conv.py:conv_plan_f32), summed
//     in order by conv_split_reduce_f32; 64-row blocks where a 128-row
//     block's halo outgrows shared memory (W > 64).
//
// What bounds it on the H100: the tensor cores at 16^2 and up (64^2, 320 ->
// 320 at 4 UNet rows: 30.2 GFLOP, 30.5 us at 989 TFLOP/s, over 21 MB of
// activations and 1.8 MB of bf16 weights, 7 us at 3.35 TB/s); at 8^2 the
// weights (2560 -> 1280: 59 MB of bf16 weights, 17.6 us at 3.35 TB/s, for
// 15.1 GFLOP, 15.3 us), which split-K spreads over the card.  What holds it
// below that: the activation warpgroup.  Its transform is two SFU operations
// (common.cuh's silu: ex2 and rcp) and a few fp32 operations per element,
// done once per halo element
// instead of nine times, beside the products; even so, the same kernel with
// the transform replaced by a raw copy of the halo ran markedly faster at
// 64^2 (the widest halo), and dropping a division per halo row was a gain of
// its own.  A second activation warpgroup (with the weight loads moved to a
// consumer thread, to stay in the register budget) helped 64^2 only and
// slowed the rest: not taken.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cstring>

#include "common.cuh"
#include "gemm_sm90.cuh"
#include "gemm_tf32.cuh"

namespace {

struct Params {
  CUtensorMap tw;     // W (f, 9c): boxes of 64 columns x BN rows
  CUtensorMap to;     // y (m, f), stored from the staging tiles (split 1)
  CUtensorMap tr;     // the residual (m, f), into the staging tiles (split 1)
  const bf16* x;      // (B, H, W, C)
  const float* a;     // (B, C) GroupNorm affine
  const float* v;     // (B, C)
  const float* bias;  // (F,)
  const bf16* res;    // (B, H, W, F) or null
  float* part;        // (split, M, F) fp32 partial products (split > 1)
  int h, w, c, f, m, hw;
  int slices;          // 64-channel slices of C
  int split;           // slices ranges, one per blockIdx.z
  int halo_rows;       // rows of one halo buffer
  int contiguous;      // 1: one window of BM + 2W + 2 rows; 0: three of BM + 2
};

// BM rows (64 or 128: one consumer warpgroup per 64), BN columns, STAGES
// weight-ring stages.  Shared memory, from a 1024-byte aligned base: the
// ring, one bf16 staging tile per consumer warpgroup, the barriers, a row of
// zeros, the two halo buffers.
template <int BM_, int BN_, int STAGES_>
struct ConvTile {
  static constexpr int BM = BM_, BN = BN_, STAGES = STAGES_, OUT = BN_;
  static constexpr int kConsumers = BM / 64;
  static constexpr int kActivators = 128;
  static constexpr int kThreads = 128 * kConsumers + kActivators + 32;
  static constexpr int kWTile = BN * 128;
  static constexpr int kStaging = 64 * BN * 2;  // one warpgroup's
  static constexpr int kStagingOffset = STAGES * kWTile;
  static constexpr int kBarOffset = kStagingOffset + kConsumers * kStaging;
  static constexpr int kBars = 2 * STAGES + 4 + kConsumers;
  static constexpr int kZeroOffset = (kBarOffset + 8 * kBars + 127) / 128 * 128;
  static constexpr int kHaloOffset = (kZeroOffset + 128 + 1023) / 1024 * 1024;
  static_assert(BM == 64 || BM == 128, "row block");
  static_assert(BN % 32 == 0 && BN <= 256, "wgmma width, whole staging atoms");
  static_assert(STAGES >= 2, "ring");

  // Dynamic shared memory for halo buffers of `rows` rows: + 1 KB to align the base.
  static size_t smem(int rows) { return kHaloOffset + 2 * (size_t)rows * 128 + 1024; }
};

template <class C>
struct ConvSmem {
  uint8_t* base;
  uint32_t bars;
  __device__ explicit ConvSmem(uint8_t* raw) {
    base = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
    bars = smem_u32(base + C::kBarOffset);
  }
  __device__ uint8_t* stage(int s) const { return base + s * C::kWTile; }
  __device__ uint8_t* staging(int wg) const { return base + C::kStagingOffset + wg * C::kStaging; }
  __device__ uint8_t* zero_row() const { return base + C::kZeroOffset; }
  __device__ uint8_t* halo(int hb, int rows) const { return base + C::kHaloOffset + hb * rows * 128; }
  __device__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ uint32_t empty(int s) const { return bars + 8 * (C::STAGES + s); }
  __device__ uint32_t halo_full(int hb) const { return bars + 8 * (2 * C::STAGES + hb); }
  __device__ uint32_t halo_empty(int hb) const { return bars + 8 * (2 * C::STAGES + 2 + hb); }
  __device__ uint32_t x_full(int wg) const { return bars + 8 * (2 * C::STAGES + 4 + wg); }

  __device__ void init() const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < C::STAGES; ++s) {
        mbar_init(full(s), 1);
        mbar_init(empty(s), 4 * C::kConsumers);
      }
      for (int hb = 0; hb < 2; ++hb) {
        mbar_init(halo_full(hb), C::kActivators);
        mbar_init(halo_empty(hb), 4 * C::kConsumers);
      }
      for (int wg = 0; wg < C::kConsumers; ++wg) mbar_init(x_full(wg), 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
};

// The input pixel (flat (b, y, x) index, M < 2^31) of halo row j of the row
// block at m0 (P: the bf16 kernel's Params or the fp32 route's).
template <class P>
__device__ __forceinline__ int halo_source(const P& p, int bm, int m0, int j) {
  if (p.contiguous) return m0 - p.w - 1 + j;
  const int d = j / (bm + 2), i = j - d * (bm + 2);
  return m0 + (d - 1) * p.w - 1 + i;
}

// The activation warpgroup (atid 0..127): slice cs of the halo, activated,
// into buffer `dst`: 8 threads a 128-byte row, eight rows' loads in flight
// per thread before any is stored.  A thread's 8 channels are the same for
// the whole slice, so it keeps one sample's a and v in registers and loads
// another's only where its rows cross into that sample.  The warpgroup's
// arithmetic is on the conv's critical path, so it holds no division per row.
template <int BM>
__device__ __forceinline__ void fill_halo(uint8_t* dst, const Params& p, int m0, int cs, int atid) {
  constexpr int kBatch = 8;
  const int total = p.halo_rows * 8;
  const int ch = 64 * cs + 8 * (atid & 7);
  // this thread's rows only grow (the windows are ordered, and each is
  // increasing), so its sample, and the a and v it holds for it, only move
  // forward: no division per row
  int b = -1, next = 0;
  float av[8], vv[8];
  for (int i0 = atid; i0 < total; i0 += 128 * kBatch) {
    uint4 raw[kBatch];
    int px[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + 128 * u;
      px[u] = i < total ? halo_source(p, BM, m0, i >> 3) : -1;
      if (px[u] >= p.m || ch >= p.c) px[u] = -1;
      raw[u] = make_uint4(0u, 0u, 0u, 0u);
      if (px[u] >= 0)
        raw[u] = __ldg(reinterpret_cast<const uint4*>(p.x + (long long)px[u] * p.c + ch));
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + 128 * u;
      if (i >= total) break;
      uint4 out = make_uint4(0u, 0u, 0u, 0u);
      if (px[u] >= 0) {
        if (px[u] >= next) {
          b = b < 0 ? px[u] / p.hw : b + 1;
          while ((b + 1) * p.hw <= px[u]) ++b;
          next = (b + 1) * p.hw;
          gligen::load8f(p.a + (long long)b * p.c + ch, av);
          gligen::load8f(p.v + (long long)b * p.c + ch, vv);
        }
        float f[8];
        gligen::unpack8(raw[u], f);
#pragma unroll
        for (int e = 0; e < 8; ++e) f[e] = gligen::silu(f[e] * av[e] + vv[e]);
        out = gligen::pack8(f);
      }
      const int j = i >> 3, k = i & 7;
      *reinterpret_cast<uint4*>(dst + j * 128 + ((k ^ (j & 7)) << 4)) = out;
    }
  }
}

template <int BM, int BN, int STAGES>
__global__ void __launch_bounds__(ConvTile<BM, BN, STAGES>::kThreads, 1)
    conv3x3_kernel(const __grid_constant__ Params p) {
  typedef ConvTile<BM, BN, STAGES> C;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const ConvSmem<C> sm(smem_raw);
  const int m0 = blockIdx.x * BM;  // M < 2^31
  const int n0 = blockIdx.y * BN;
  const int s0 = (int)((long long)blockIdx.z * p.slices / p.split);
  const int s1 = (int)((long long)(blockIdx.z + 1) * p.slices / p.split);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  sm.init();

  const int steps = 9 * (s1 - s0);
  // step q's weight tile (slice s0 + q / 9, tap q % 9) into its stage,
  // once every consumer warp is done with the step STAGES before it
  auto load_w = [&](int q) {
    const int s = q % STAGES, tap = q % 9;
    mbar_wait(sm.empty(s), ((q / STAGES) & 1) ^ 1);
    mbar_expect_tx(sm.full(s), C::kWTile);
    tma_load_2d(smem_u32(sm.stage(s)), &p.tw, sm.full(s), tap * p.c + 64 * (s0 + q / 9), n0);
  };
  if (warp == 4 * C::kConsumers + 4) {
    // ---------------- TMA warp (one lane): the weight ring
    if (lane == 0)
      for (int q = 0; q < steps; ++q) load_w(q);
    return;
  }
  if (warp >= 4 * C::kConsumers) {
    // ---------------- activation warpgroup: the halo of each slice
    const int atid = threadIdx.x - 128 * C::kConsumers;
    if (atid < 8) *reinterpret_cast<uint4*>(sm.zero_row() + 16 * atid) = make_uint4(0u, 0u, 0u, 0u);
    for (int cs = s0, hp = 0; cs < s1; ++cs, ++hp) {
      const int hb = hp & 1;
      mbar_wait(sm.halo_empty(hb), ((hp >> 1) & 1) ^ 1);
      fill_halo<BM>(sm.halo(hb, p.halo_rows), p, m0, cs, atid);
      mbar_arrive(sm.halo_full(hb));
    }
    return;
  }

  // ---------------- consumer warpgroups: 64 rows each
  const int wg = warp / 4, tid = threadIdx.x % 128, quad = lane % 4;
  const int row0 = m0 + wg * 64;
  uint8_t* stg = sm.staging(wg);
  const bool leader = lane == 0;
  if (p.split == 1 && p.res && tid == 0) load_x_tile<C>(stg, &p.tr, sm.x_full(wg), row0, n0);

  // This lane's ldmatrix row (its output pixel) and which 8 of a k16 step's
  // 16 channels it addresses; which of its nine neighbours lie in the image.
  const int rel = wg * 64 + (tid / 32) * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int khalf = lane >> 4;
  uint32_t inside = 0;  // bit 3 * (dy + 1) + (dx + 1)
  if (m0 + rel < p.m) {
    const int pix = (m0 + rel) % p.hw, y = pix / p.w, x = pix - y * p.w;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int yy = y + tap / 3 - 1, xx = x + tap % 3 - 1;
      if (yy >= 0 && yy < p.h && xx >= 0 && xx < p.w) inside |= 1u << tap;
    }
  }
  // halo row of the (dy, dx) neighbour: base[dy + 1] + rel + dx
  int base[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) base[d] = (p.contiguous ? 1 + d * p.w : d * (BM + 2) + 1) + rel;
  const uint32_t zero = smem_u32(sm.zero_row());

  // Each step's products complete before the next step's ldmatrix writes
  // the A registers: a wgmma still reading its register operands may not
  // have them redefined (ptxas otherwise serialises the instructions
  // itself), and the two consumer warpgroups keep the tensor cores fed
  // between one warpgroup's steps.
  float acc[BN / 2];
  uint32_t fa[4][4];
  int it = 0;
  for (int cs = s0, hp = 0; cs < s1; ++cs, ++hp) {
    const int hb = hp & 1;
    mbar_wait(sm.halo_full(hb), (hp >> 1) & 1);
    const uint32_t halo = smem_u32(sm.halo(hb, p.halo_rows));
#pragma unroll
    for (int tap = 0; tap < 9; ++tap, ++it) {
      uint32_t addr = zero, swz = 0;
      if (inside >> tap & 1) {
        const uint32_t r = base[tap / 3] + tap % 3 - 1;
        addr = halo + r * 128;
        swz = r & 7;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) ldmatrix_x4(fa[kk], addr + (((2 * kk + khalf) ^ swz) << 4));
      // this warp's reads of the halo are done after its last tap's ldmatrix
      if (tap == 8 && leader) mbar_arrive(sm.halo_empty(hb));
      const int s = it % STAGES;
      mbar_wait(sm.full(s), (it / STAGES) & 1);
      uint32_t b = smem_u32(sm.stage(s));
      asm volatile("" : "+r"(b));
      pin(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaRs<BN>::template rs<0>(acc, fa[kk], sw128_desc(b + 32 * kk, 16, 1024),
                                    it > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      pin(acc);
      if (leader) mbar_arrive(sm.empty(s));
    }
  }

  const int r0 = (tid / 32) * 16 + lane / 4;  // the fragment's rows r0 and r0 + 8
  if (p.split > 1) {
    // fp32 partial product, reduced in order by conv_split_reduce
    float* part = p.part + (long long)blockIdx.z * p.m * p.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int gc = n0 + 8 * j + 2 * quad;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + r0 + 8 * h;
        if (row < p.m && gc < p.f)
          *reinterpret_cast<float2*>(part + (long long)row * p.f + gc) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
    return;
  }

  // + fp32 bias, + the residual in fp32 when given, one cast, by TMA
  if (p.res) mbar_wait(sm.x_full(wg), 0);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * quad, gc = n0 + col;
    const float2 ba = gc < p.f ? __ldg(reinterpret_cast<const float2*>(p.bias + gc))
                               : make_float2(0.0f, 0.0f);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t* dst = reinterpret_cast<uint32_t*>(stg + staged(r0 + 8 * h, col));
      float y0 = acc[4 * j + 2 * h] + ba.x, y1 = acc[4 * j + 2 * h + 1] + ba.y;
      if (p.res) {
        const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dst));
        y0 += x.x;
        y1 += x.y;
      }
      *dst = pack_bf16(y0, y1);
    }
  }
  store_tile<C>(stg, &p.to, row0, n0, tid, 2 + wg);
  if (tid == 0) bulk_wait_read<0>();
}

// out = sum_s part[s] (s = 0, 1, ...) + bias (+ residual), one cast; 8
// columns a thread.
__global__ void conv_split_reduce(const float* __restrict__ part, const float* __restrict__ bias,
                                  const bf16* __restrict__ res, bf16* __restrict__ out, int m,
                                  int f, int split) {
  const long long vecs = (long long)m * f / 8, plane = (long long)m * f;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < vecs;
       i += (long long)gridDim.x * blockDim.x) {
    float y[8], t[8], b[8];
    gligen::load8f(part + 8 * i, y);
    for (int s = 1; s < split; ++s) {
      gligen::load8f(part + s * plane + 8 * i, t);
#pragma unroll
      for (int e = 0; e < 8; ++e) y[e] += t[e];
    }
    gligen::load8f(bias + (8 * i) % f, b);
#pragma unroll
    for (int e = 0; e < 8; ++e) y[e] += b[e];
    if (res) {
      gligen::unpack8(reinterpret_cast<const uint4*>(res)[i], t);
#pragma unroll
      for (int e = 0; e < 8; ++e) y[e] += t[e];
    }
    reinterpret_cast<uint4*>(out)[i] = gligen::pack8(y);
  }
}

// ------------------------------------------------------------ host side

// The configurations each library holds, as an X-macro list of (BM, BN,
// stages): the serving library the wrapper's table (ops/fused_conv.py:
// CONV_TILES), the sweep library (fused_conv_sweep.cu) SWEEP_CONV_TILES.
#ifndef FUSED_CONV_SWEEP
#define CONV_CONFIGS(X) X(128, 160, 4)
#else
#define CONV_CONFIGS(X) \
  X(128, 128, 4) X(128, 160, 3) X(128, 160, 5) X(64, 128, 4) X(64, 160, 4)
#endif

// Rows of one halo buffer: one window of BM + 2W + 2 rows, or three of BM + 2.
inline bool halo_contiguous(int bm, int w) { return bm + 2LL * w + 2 <= 3LL * (bm + 2); }
inline int halo_rows(int bm, int w) { return halo_contiguous(bm, w) ? bm + 2 * w + 2 : 3 * (bm + 2); }

template <int BM, int BN, int STAGES>
cudaError_t launch(Params& p, const bf16* wt, bf16* y, cudaStream_t stream) {
  typedef ConvTile<BM, BN, STAGES> C;
  p.contiguous = halo_contiguous(BM, p.w);
  p.halo_rows = halo_rows(BM, p.w);
  const size_t smem = C::smem(p.halo_rows);
  const long long row_blocks = ((long long)p.m + BM - 1) / BM;
  const long long col_tiles = (p.f + BN - 1) / BN;
  if (smem > kMaxBlockSmem || col_tiles > 65535 || !make_map_2d(&p.tw, wt, 9 * p.c, p.f, BN))
    return cudaErrorInvalidValue;
  if (p.split == 1) {
    if (!make_map_2d(&p.to, y, p.f, p.m, 64, 32)) return cudaErrorInvalidValue;
    if (p.res && !make_map_2d(&p.tr, p.res, p.f, p.m, 64, 32)) return cudaErrorInvalidValue;
  }
  auto kernel = conv3x3_kernel<BM, BN, STAGES>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)row_blocks, (unsigned)col_tiles, (unsigned)p.split), C::kThreads, smem,
           stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.split == 1) return err;
  const long long vecs = (long long)p.m * p.f / 8;
  const int blocks = (int)std::min<long long>((vecs + 255) / 256, 8LL * gligen::kSMs);
  conv_split_reduce<<<blocks, 256, 0, stream>>>(p.part, p.bias, p.res, y, p.m, p.f, p.split);
  return cudaGetLastError();
}

constexpr int tiles_key(int bm, int bn, int stages) { return (bm * 1000 + bn) * 10 + stages; }

}  // namespace

// Plain C entry point for ctypes.  Returns a cudaError_t (0 = launched).
// Every tensor is contiguous and 16-byte aligned; the caller checks shapes,
// dtypes and devices.  x (b, h, w, c) bf16; a, v (b, c) fp32; wt (f, 3, 3, c)
// bf16; bias (f,) fp32; res (b, h, w, f) bf16 or null; y (b, h, w, f) bf16;
// part a (split, b*h*w, f) fp32 scratch when split > 1, else unused.
// (bm, bn, stages) is the tile configuration, one this library holds
// (CONV_CONFIGS; any other returns cudaErrorInvalidValue); split (1 ..
// ceil(c / 64)) the number of ranges the channel slices are cut into.
extern "C" int gn_silu_conv3x3_bf16(const void* x, const float* a, const float* v, const void* wt,
                                    const float* bias, const void* res, void* y, float* part,
                                    int b, int h, int w, int c, int f, int bm, int bn, int stages,
                                    int split, void* stream) {
  const long long m = (long long)b * h * w;
  const int slices = (c + 63) / 64;
  if (b < 1 || h < 1 || w < 1 || c < 8 || c % 8 || f < 8 || f % 8 || m > (1LL << 30) ||
      9LL * c >= (1LL << 31) || split < 1 || split > slices || split > 65535 ||
      (split > 1 && !part))
    return (int)cudaErrorInvalidValue;
  Params p;
  memset(&p, 0, sizeof(p));
  p.x = static_cast<const bf16*>(x);
  p.a = a;
  p.v = v;
  p.bias = bias;
  p.res = static_cast<const bf16*>(res);
  p.part = part;
  p.h = h, p.w = w, p.c = c, p.f = f, p.m = (int)m, p.hw = h * w;
  p.slices = slices;
  p.split = split;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* wb = static_cast<const bf16*>(wt);
  bf16* yb = static_cast<bf16*>(y);
  switch (tiles_key(bm, bn, stages)) {
#define CASE(BM, BN, ST) \
  case tiles_key(BM, BN, ST): return (int)launch<BM, BN, ST>(p, wb, yb, s);
    CONV_CONFIGS(CASE)
#undef CASE
  }
  return (int)cudaErrorInvalidValue;
}

#ifndef FUSED_CONV_SWEEP
// ------------------------------------------------------------ the fp32 route

// The fp32 route's configurations, an X-macro list of (BM, BN, stages):
// the wrapper's table (ops/fused_conv.py:CONV_TILES_F32).
#define CONV_F32_CONFIGS(X) X(128, 64, 3) X(64, 64, 3)

namespace {

struct ConvF32 {
  CUtensorMap tw;     // W (f, 9c) fp32: boxes of 32 columns x BN rows
  CUtensorMap tx;     // x (m, c) fp32: boxes of 32 columns x (BM + 2) rows, unswizzled
  const float* x;     // (B, H, W, C)
  const float* a;     // (B, C) GroupNorm affine
  const float* v;     // (B, C)
  const float* bias;  // (F,)
  const float* res;   // (B, H, W, F) or null
  float* y;           // (B, H, W, F)
  float* part;        // (split, M, F) fp32 partial products (split > 1)
  int h, w, c, f, m, hw;
  int slices;      // 32-channel slices of C
  int split;       // slice ranges, one per blockIdx.z
  int halo_rows;   // rows of one halo buffer
  int contiguous;  // 1: one window of BM + 2W + 2 rows; 0: three of BM + 2
  int boxes;       // TMA boxes of BM + 2 rows that bring a slice's raw halo
};

// BM rows (64 or 128: one consumer warpgroup per 64), BN columns, STAGES
// weight-ring stages.  Warps: the consumer warpgroups, one W splitter warp,
// one producer warp.  Shared memory, from a 1024-byte aligned base: the
// ring (each stage W hi, W lo), the barriers (the ring's, then the raw
// halo's full and empty), a row of zeros, two halo buffers (each hi, lo),
// the raw halo (`boxes` TMA boxes of BM + 2 rows).
template <int BM_, int BN_, int STAGES_>
struct ConvTf32Tile {
  static constexpr int BM = BM_, BN = BN_, STAGES = STAGES_;
  static constexpr int kConsumers = BM / 64;
  static constexpr int kThreads = 128 * kConsumers + 64;
  static constexpr int kWTile = BN * 128;
  static constexpr int kStage = 2 * kWTile;
  static constexpr int kBarOffset = STAGES * kStage;
  static constexpr int kBars = 3 * STAGES + 2;
  static constexpr int kZeroOffset = (kBarOffset + 8 * kBars + 127) / 128 * 128;
  static constexpr int kHaloOffset = (kZeroOffset + 128 + 1023) / 1024 * 1024;
  static_assert(BM == 64 || BM == 128, "row block");
  static_assert(BN == 64, "a width gen_wgmma.py writes for WgmmaRsTf32");
  static_assert(STAGES >= 2, "ring");

  // Dynamic shared memory for halo buffers of `rows` rows and a raw halo of
  // `boxes` boxes: + 1 KB to align the base.
  static size_t smem(int rows, int boxes) {
    return kHaloOffset + (4 * (size_t)rows + boxes * (BM + 2)) * 128 + 1024;
  }
};

// A thread's place in the pixels' samples while it activates a slice's
// halo: its rows only grow (the windows are ordered, and each is
// increasing), so its sample, and the a and v it holds for its 4 channels,
// only move forward: no division per row.
struct HaloCursor {
  int b = -1, next = 0;
  float4 a, v;
};

// NT threads (ctid 0..NT - 1) activate rows [j0, j1) of slice cs's halo (32
// channels) from its raw rows (as TMA brought them, 128 bytes a row): each
// value silu(x * a + v) in fp32 with its pixel's own sample's a and v, split
// into hi and lo, stored in 128-byte rows swizzled by row.  8 threads a row
// (NT is a multiple of 8, so a thread keeps its 4 channels), every load of
// the thread's rows issued before any is converted.  Pixels outside the
// image's flat range and channels past C are 0.
template <int BM, int NT, int ROWS>
__device__ __forceinline__ void fill_halo_f32(uint8_t* hi, uint8_t* lo, const uint8_t* rows,
                                              const ConvF32& p, int m0, int cs, int j0, int j1,
                                              int ctid, HaloCursor& cur) {
  constexpr int kBatch = (ROWS * 8 + NT - 1) / NT;
  const int end = 8 * j1, ch = 32 * cs + 4 * (ctid & 7);
  // the pixel of chunk i, or -1 (outside the image's flat range, or
  // channels past C); recomputed rather than kept, to spare registers
  auto pixel = [&](int i) {
    const int px = i < end && ch < p.c ? halo_source(p, BM, m0, i >> 3) : -1;
    return px < p.m ? px : -1;
  };
  float4 raw[kBatch];
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const int i = 8 * j0 + ctid + NT * u;
    raw[u] = pixel(i) >= 0 ? *reinterpret_cast<const float4*>(rows + 16 * i)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const int i = 8 * j0 + ctid + NT * u, px = pixel(i);
    if (i >= end) break;
    uint4 h = make_uint4(0u, 0u, 0u, 0u), l = h;
    if (px >= 0) {
      if (px >= cur.next) {
        cur.b = cur.b < 0 ? px / p.hw : cur.b + 1;
        while ((cur.b + 1) * p.hw <= px) ++cur.b;
        cur.next = (cur.b + 1) * p.hw;
        cur.a = __ldg(reinterpret_cast<const float4*>(p.a + (long long)cur.b * p.c + ch));
        cur.v = __ldg(reinterpret_cast<const float4*>(p.v + (long long)cur.b * p.c + ch));
      }
      const float4 r = raw[u], a = cur.a, v = cur.v;
      const float4 f = make_float4(
          gligen::silu(r.x * a.x + v.x), gligen::silu(r.y * a.y + v.y),
          gligen::silu(r.z * a.z + v.z), gligen::silu(r.w * a.w + v.w));
      split4(f, h, l);
    }
    const int j = i >> 3, off = j * 128 + (((i & 7) ^ (j & 7)) << 4);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

// The consumers activate the next slice's halo under taps kFirstFill .. 8
// of this one's, from raw rows the producer requests at tap kRawRequestTap.
constexpr int kFirstFill = 4, kRawRequestTap = 2;

template <int BM, int BN, int STAGES>
__global__ void __launch_bounds__(ConvTf32Tile<BM, BN, STAGES>::kThreads, 1)
    conv3x3_tf32_kernel(const __grid_constant__ ConvF32 p) {
  typedef ConvTf32Tile<BM, BN, STAGES> C;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const Tf32Ring ring{smem_u32(smem + C::kBarOffset), STAGES};
  const uint32_t raw_full = ring.bars + 8 * 3 * STAGES, raw_empty = raw_full + 8;
  const int halo_bytes = p.halo_rows * 128;
  // halo buffer hb's hi rows; its lo rows follow them
  auto halo = [&](int hb) { return smem + C::kHaloOffset + hb * 2 * halo_bytes; };
  uint8_t* raw = smem + C::kHaloOffset + 4 * halo_bytes;
  const int m0 = blockIdx.x * BM;  // M < 2^31
  const int n0 = blockIdx.y * BN;
  const int s0 = range_start(blockIdx.z, p.slices, p.split);
  const int s1 = range_start(blockIdx.z + 1, p.slices, p.split);
  const int steps = 9 * (s1 - s0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    ring.init(4 * C::kConsumers, 32);
    mbar_init(raw_full, 1);
    mbar_init(raw_empty, 4 * C::kConsumers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * C::kConsumers + 1) {
    // ---------------- producer warp (one lane): step q's weight tile, the
    // BN x 32 box at column tap * C + 32 * slice, tap = q % 9; and each
    // slice's raw halo: `boxes` boxes of BM + 2 rows, from the window's first
    // row (one window) or from each of the three (TMA zero-fills rows
    // outside the image's flat range), the next slice's once the consumers
    // have activated this one's (requested at its tap kRawRequestTap, when
    // they are done with it or nearly)
    if (lane == 0) {
      auto request = [&](int cs) {
        mbar_expect_tx(raw_full, p.boxes * (BM + 2) * 128);
        for (int b = 0; b < p.boxes; ++b)
          tma_load_2d(smem_u32(raw + b * (BM + 2) * 128), &p.tx, raw_full, 32 * cs,
                      p.contiguous ? m0 - p.w - 1 + b * (BM + 2) : m0 + (b - 1) * p.w - 1);
      };
      request(s0);
      for (int q = 0; q < steps; ++q) {
        const int cs = s0 + q / 9;
        if (q % 9 == kRawRequestTap && cs + 1 < s1) {
          mbar_wait(raw_empty, (cs - s0) & 1);
          request(cs + 1);
        }
        const int s = q % STAGES;
        mbar_wait(ring.empty(s), ((q / STAGES) & 1) ^ 1);
        mbar_expect_tx(ring.full(s), C::kWTile);
        tma_load_2d(smem_u32(smem + s * C::kStage), &p.tw, ring.full(s),
                    (q % 9) * p.c + 32 * (s0 + q / 9), n0);
      }
    }
    return;
  }
  if (warp == 4 * C::kConsumers) {
    // ---------------- splitter warp: every weight tile, as it arrives
    for (int q = 0; q < steps; ++q) {
      const int s = q % STAGES;
      mbar_wait(ring.full(s), (q / STAGES) & 1);
      split_tile<BN, 32>(smem + s * C::kStage, smem + s * C::kStage + C::kWTile, lane);
      fence_proxy_async();
      mbar_arrive(ring.ready(s));
    }
    return;
  }

  // ---------------- consumer warpgroups: 64 rows each
  const int wg = warp / 4, tid = threadIdx.x % 128, quad = lane % 4;
  const int row0 = m0 + wg * 64;
  const bool leader = lane == 0;
  const int ctid = threadIdx.x;  // among the 128 * kConsumers consumer threads
  constexpr int kConsumerThreads = 128 * C::kConsumers;
  // This lane's ldmatrix row (its output pixel) and which 4 of a k8 step's
  // 8 channels it addresses; which of its nine neighbours lie in the image
  // (fused_conv.cu's bf16 kernel, byte for byte: a k8 step of fp32 is a
  // k16 step of bf16, 32 bytes).
  const int rel = wg * 64 + (tid / 32) * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int khalf = lane >> 4;
  uint32_t inside = 0;  // bit 3 * (dy + 1) + (dx + 1)
  if (m0 + rel < p.m) {
    const int pix = (m0 + rel) % p.hw, y = pix / p.w, x = pix - y * p.w;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int yy = y + tap / 3 - 1, xx = x + tap % 3 - 1;
      if (yy >= 0 && yy < p.h && xx >= 0 && xx < p.w) inside |= 1u << tap;
    }
  }
  int base[3];  // halo row of the (dy, dx) neighbour: base[dy + 1] + dx
#pragma unroll
  for (int d = 0; d < 3; ++d) base[d] = (p.contiguous ? 1 + d * p.w : d * (BM + 2) + 1) + rel;
  const uint32_t zero = smem_u32(smem + C::kZeroOffset);
  if (ctid < 8)
    *reinterpret_cast<uint4*>(smem + C::kZeroOffset + 16 * ctid) = make_uint4(0u, 0u, 0u, 0u);

  // The consumers activate each slice's halo themselves: the next slice's
  // raw rows, in five parts, under the products of this slice's last five
  // taps (wgmma runs asynchronously), into the other halo buffer.  A
  // slice's nine taps (108 products) accumulate in part from zero, and part
  // is added to acc in fp32; each tap's products complete before the next
  // tap's ldmatrix writes the A registers.
  constexpr int kFirstFillTap = kFirstFill, kFillParts = 9 - kFirstFillTap;
  constexpr int kMaxRows = 3 * (BM + 2);
  auto fill = [&](int cs, int part_lo, int part_hi, HaloCursor& cur) {
    const int j0 = p.halo_rows * part_lo / kFillParts, j1 = p.halo_rows * part_hi / kFillParts;
    uint8_t* hb = halo((cs - s0) & 1);
    fill_halo_f32<BM, kConsumerThreads, (kMaxRows + kFillParts - 1) / kFillParts + 1>(
        hb, hb + halo_bytes, raw, p, m0, cs, j0, j1, ctid, cur);
  };
  // the first slice's halo, whole, before any product
  {
    HaloCursor cur;
    mbar_wait(raw_full, 0);
    for (int part_i = 0; part_i < kFillParts; ++part_i) fill(s0, part_i, part_i + 1, cur);
    __syncwarp();
    if (leader) mbar_arrive(raw_empty);
  }
  float acc[BN / 2], part[BN / 2];
  uint32_t fh[4][4], fl[4][4];
  for (int cs = s0, q = 0; cs < s1; ++cs) {
    // every consumer has activated its rows of this slice's halo, and has
    // read the other buffer for the last time (the slice before)
    named_sync(1, kConsumerThreads);
    const uint32_t hsrc = smem_u32(halo((cs - s0) & 1));
    const bool next = cs + 1 < s1;
    HaloCursor cur;
    pin(part);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap, ++q) {
      uint32_t addr = zero, addr_lo = zero, swz = 0;
      if (inside >> tap & 1) {
        const uint32_t r = base[tap / 3] + tap % 3 - 1;
        addr = hsrc + r * 128;
        addr_lo = addr + halo_bytes;
        swz = r & 7;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t chunk = ((2 * kk + khalf) ^ swz) << 4;
        ldmatrix_x4(fh[kk], addr + chunk);
        ldmatrix_x4(fl[kk], addr_lo + chunk);
      }
      const int s = q % STAGES;
      mbar_wait(ring.ready(s), (q / STAGES) & 1);
      uint32_t b = smem_u32(smem + s * C::kStage);
      asm volatile("" : "+r"(b));
      slice_rs<BN>(part, fh, fl, b, b + C::kWTile, tap == 0);
      if (next && tap >= kFirstFillTap) {
        if (tap == kFirstFillTap) mbar_wait(raw_full, (cs + 1 - s0) & 1);
        fill(cs + 1, tap - kFirstFillTap, tap - kFirstFillTap + 1, cur);
        if (tap == 8) {
          __syncwarp();
          if (leader) mbar_arrive(raw_empty);  // this warp is done with the raw rows
        }
      }
      wgmma_wait<0>();
      if (leader) mbar_arrive(ring.empty(s));
    }
    pin(part);
    add_slice(acc, part, cs == s0);
  }

  const int r0 = (tid / 32) * 16 + lane / 4;  // the fragment's rows r0 and r0 + 8
  float* out = p.split > 1 ? p.part + (long long)blockIdx.z * p.m * p.f : p.y;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * quad;
    if (col >= p.f) continue;
    float2 ba = make_float2(0.0f, 0.0f);
    if (p.split == 1) ba = __ldg(reinterpret_cast<const float2*>(p.bias + col));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = row0 + r0 + 8 * h;
      if (row >= p.m) continue;
      float y0 = acc[4 * j + 2 * h] + ba.x, y1 = acc[4 * j + 2 * h + 1] + ba.y;
      if (p.split == 1 && p.res) {
        const float2 r = *reinterpret_cast<const float2*>(p.res + row * p.f + col);
        y0 += r.x;
        y1 += r.y;
      }
      *reinterpret_cast<float2*>(out + row * p.f + col) = make_float2(y0, y1);
    }
  }
}

// out = sum_s part[s] (s = 0, 1, ...) + bias (+ residual), fp32; 4 columns
// a thread.
__global__ void conv_split_reduce_f32(const float* __restrict__ part,
                                      const float* __restrict__ bias,
                                      const float* __restrict__ res, float* __restrict__ out,
                                      int m, int f, int split) {
  const long long vecs = (long long)m * f / 4, plane = (long long)m * f;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < vecs;
       i += (long long)gridDim.x * blockDim.x) {
    float4 y = reinterpret_cast<const float4*>(part)[i];
    for (int s = 1; s < split; ++s) {
      const float4 t = reinterpret_cast<const float4*>(part + s * plane)[i];
      y = make_float4(y.x + t.x, y.y + t.y, y.z + t.z, y.w + t.w);
    }
    const float4 b = __ldg(reinterpret_cast<const float4*>(bias + (4 * i) % f));
    y = make_float4(y.x + b.x, y.y + b.y, y.z + b.z, y.w + b.w);
    if (res) {
      const float4 r = reinterpret_cast<const float4*>(res)[i];
      y = make_float4(y.x + r.x, y.y + r.y, y.z + r.z, y.w + r.w);
    }
    reinterpret_cast<float4*>(out)[i] = y;
  }
}

template <int BM, int BN, int STAGES>
cudaError_t launch_f32(ConvF32& p, const float* wt, cudaStream_t stream) {
  typedef ConvTf32Tile<BM, BN, STAGES> C;
  p.contiguous = halo_contiguous(BM, p.w);
  p.halo_rows = halo_rows(BM, p.w);
  p.boxes = p.contiguous ? (p.halo_rows + BM + 1) / (BM + 2) : 3;
  const size_t smem = C::smem(p.halo_rows, p.boxes);
  const long long row_blocks = ((long long)p.m + BM - 1) / BM;
  const long long col_tiles = (p.f + BN - 1) / BN;
  if (smem > kMaxBlockSmem || col_tiles > 65535 || !make_map_2d_f32(&p.tw, wt, 9 * p.c, p.f, BN) ||
      !make_map_2d_f32(&p.tx, p.x, p.c, p.m, BM + 2, false))
    return cudaErrorInvalidValue;
  auto kernel = conv3x3_tf32_kernel<BM, BN, STAGES>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)row_blocks, (unsigned)col_tiles, (unsigned)p.split), C::kThreads, smem,
           stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.split == 1) return err;
  const long long vecs = (long long)p.m * p.f / 4;
  const int blocks = (int)std::min<long long>((vecs + 255) / 256, 8LL * gligen::kSMs);
  conv_split_reduce_f32<<<blocks, 256, 0, stream>>>(p.part, p.bias, p.res, p.y, p.m, p.f, p.split);
  return cudaGetLastError();
}

}  // namespace

// The fp32 route: y = conv3x3_SAME(silu(x * a + v), wt) + bias (+ res), every
// tensor fp32, the arguments as gn_silu_conv3x3_bf16's: (bm, bn, stages) a
// configuration of CONV_F32_CONFIGS, split (1 .. ceil(c / 32)) the ranges
// the 32-channel slices are cut into, part a (split, b*h*w, f) fp32 scratch
// when split > 1.
extern "C" int gn_silu_conv3x3_f32(const float* x, const float* a, const float* v, const float* wt,
                                   const float* bias, const float* res, float* y, float* part,
                                   int b, int h, int w, int c, int f, int bm, int bn, int stages,
                                   int split, void* stream) {
  const long long m = (long long)b * h * w;
  const int slices = (c + 31) / 32;
  if (b < 1 || h < 1 || w < 1 || c < 8 || c % 8 || f < 8 || f % 8 || m > (1LL << 30) ||
      9LL * c >= (1LL << 31) || split < 1 || split > slices || split > 65535 ||
      (split > 1 && !part))
    return (int)cudaErrorInvalidValue;
  ConvF32 p;
  memset(&p, 0, sizeof(p));
  p.x = x, p.a = a, p.v = v, p.bias = bias, p.res = res, p.y = y, p.part = part;
  p.h = h, p.w = w, p.c = c, p.f = f, p.m = (int)m, p.hw = h * w;
  p.slices = slices;
  p.split = split;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tiles_key(bm, bn, stages)) {
#define CASE(BM, BN, ST) \
  case tiles_key(BM, BN, ST): return (int)launch_f32<BM, BN, ST>(p, wt, s);
    CONV_F32_CONFIGS(CASE)
#undef CASE
  }
  return (int)cudaErrorInvalidValue;
}
#endif
