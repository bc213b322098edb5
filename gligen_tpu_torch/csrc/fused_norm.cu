// GroupNorm (+SiLU) and LayerNorm for Hopper (sm_90a): bf16 in / bf16 out, fp32 statistics;
// and the GroupNorm (+SiLU), its affine and the LayerNorm of fp32 x into fp32 y (the
// inpaint image's fp32 VAE encode, a model served in fp32).
//
// Replaces the TPU Pallas kernels of gligen_tpu/ops/pallas_norm.py:
//   * _group_norm_pallas_flat (pallas_call at :107, body _gn_kernel :62), reached
//     from group_norm_fused :127 / group_norm_silu :232: GroupNorm(32) over the
//     channel-last axis of (B, N, C) with single-pass fp32 moments and the
//     variance clamped at 0, then y = x * a + v (+ SiLU), one cast;
//   * _layer_norm_pallas_flat (:169, body _ln_kernel :155), reached from
//     layer_norm_fused :184 / layer_norm_f :253: row LayerNorm, fp32 stats.
// Statistics fold as gligen_tpu/ops/basic.py:group_norm_rowsum and
// ops/pallas_conv.py:gn_affine do: per-channel sums of x and x^2 over the
// spatial axis, then a per-group combine on (B, C), folded into a per-(sample,
// channel) affine a = rstd * scale, v = bias - mean * a.  That affine is an
// entry point of its own (gn_affine_bf16): the fused conv of fused_conv.cu
// applies it in its operand loader.
//
// Design.  The TPU kernel holds one whole sample in VMEM, one program per
// sample.  Here that would be 4 blocks on 132 SMs, and the VAE's top level,
// (2, 512, 512, 128) bf16, is 67 MB a sample.  So a sample's rows are cut
// into chunks, one block each, and the statistics are summed across blocks.
// Two routes, by the wrapper's plan (ops/fused_norm.py:gn_plan):
//   * one launch (every UNet map: the maps up to 32 MB): gn_fused_kernel,
//     one thread-block cluster per sample of up to 16 blocks, a block a row
//     chunk.  Each block streams its chunk's rows through a ring of shared-
//     memory slots, whole rows a slot, each brought in by one bulk async
//     copy (cp.async.bulk), 128 KB in flight a block, where per-thread
//     16-byte loads kept an eighth of that in flight.  It sums the
//     rows per channel (a thread owns an 8-channel vector column and takes
//     every RB-th row), folds its row lanes and then each group's channels
//     in a fixed order into (sum, sum of squares) per group in its shared
//     memory; after a cluster barrier every block reads the cluster's group
//     sums through distributed shared memory in rank order, computes mean,
//     var = max(E[x^2] - mean^2, 0), rstd = rsqrt(var + eps) and a, v for
//     the sample's channels, and normalises its own chunk's rows, streamed
//     again through the ring (from L2; the copies start during the first
//     pass).  gn_affine stops after the affine.  A cluster was taken over a
//     grid-wide barrier (a counter and a generation word in memory, over a
//     cooperative launch of every block): that version spent most of a
//     small map's time in the barrier even with no data to move, where a
//     cluster's barrier is in hardware and needs no co-resident grid.  A
//     cluster holds at most 16 blocks, so the UNet's 4 rows stream on 64
//     SMs, with 1024 threads each: with 256, the passes were bound by
//     instruction issue, not by bytes.
//   * three launches (the VAE's top levels, 134-268 MB, read from HBM twice
//     either way):
//     1. gn_partial_kernel, grid (row chunks, B): the per-channel sums of each
//        chunk, as above, one (2, C) partial per block;
//     2. gn_combine_kernel, grid (groups, B): one block folds a group's
//        partials over chunks and channels (a fixed strided order, then a
//        fixed shuffle tree) into its a, v;
//     3. gn_normalize_kernel, grid (blocks, B): y = x * a + v (then y *
//        sigmoid(y)), 8 channels per thread, the sample's a/v in shared memory.
//   * fp32 x and y (group_norm_f32): the three launches above, each kernel
//     templated on the element type (8 channels a thread: one 16-byte load
//     of bf16, two of fp32); the sums and the affine are the same fp32 code.
//     It serves the VAE encoder's maps of the inpaint encode, 2 samples of
//     up to 268 MB in fp32 (512^2 x 128), read twice and written once.
// No float atomics on either route: a run repeats bit for bit.  LayerNorm
// gives each row to a warp: one pass for the fp32 sums, a second over the
// same row (from L1/L2) to normalise and store; any row count, the fuser's
// ragged N+30 included.  It is templated on the element type, as the
// three-launch GroupNorm is: layer_norm_f32 serves a model in fp32, and
// gn_affine_f32 (launches 1 and 2 in fp32) the fused conv's fp32 route.
//
// What bounds it on the H100: bytes.  GroupNorm reads x twice (stats, then
// normalise) and writes y once; the second read comes from L2 where the
// activation fits its 50 MB (every UNet activation: at most 31.5 MB), and
// from HBM for the VAE's top levels (134-268 MB).  The least traffic, one read
// and one write, is 21 MB (6.3 us at 3.35 TB/s) at ResBlock ds1 (4, 64, 64,
// 320) and 268 MB (80 us) at the VAE's (2, 512, 512, 128); the small maps
// (8^2: 0.7 MB) are bound by the launch, not by bytes.
// LayerNorm moves one read and one write, 21 MB (6.3 us) at (4*4096, 320).

#include <cstring>

#include "common.cuh"

using namespace gligen;

namespace {

constexpr int kMaxC = 4096;      // (RB, 2, C) fp32 partials stay under 48 KB of shared memory
constexpr int kGnThreads = 256;  // target threads of a partial-sum block
constexpr int kCombineThreads = 128;
constexpr int kLnWarps = 8;

// Row lanes of a partial-sum block: RB rows side by side, V = C / 8 vector
// columns each, RB * V threads (V threads when V > 256).
__host__ __device__ inline int gn_row_lanes(int c) {
  const int v = c / 8;
  return v >= kGnThreads ? 1 : kGnThreads / v;
}

// 8 consecutive elements of x as fp32, and 8 fp32 values stored as T.
__device__ __forceinline__ void load8(const bf16* p, float* f) {
  unpack8(*reinterpret_cast<const uint4*>(p), f);
}
__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 lo = reinterpret_cast<const float4*>(p)[0], hi = reinterpret_cast<const float4*>(p)[1];
  f[0] = lo.x, f[1] = lo.y, f[2] = lo.z, f[3] = lo.w;
  f[4] = hi.x, f[5] = hi.y, f[6] = hi.z, f[7] = hi.w;
}
__device__ __forceinline__ void store8(bf16* p, const float* f) {
  *reinterpret_cast<uint4*>(p) = pack8(f);
}
__device__ __forceinline__ void store8(float* p, const float* f) { store8f(p, f); }

// ws: (B, chunks, 2, C) fp32: [.., 0, :] sums of x, [.., 1, :] sums of x^2.
template <typename T>
__global__ void gn_partial_kernel(const T* __restrict__ x, float* __restrict__ ws, int n, int c,
                                  int chunks) {
  extern __shared__ __align__(16) float red[];  // (RB, 2, C)
  const int v = c / 8;
  const int rb = blockDim.x / v;
  const int cv = threadIdx.x % v, lane_row = threadIdx.x / v;
  const int b = blockIdx.y, chunk = blockIdx.x;
  const int rows = (n + chunks - 1) / chunks;
  const int r0 = chunk * rows, r1 = min(n, r0 + rows);
  float s[8], ss[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = ss[i] = 0.0f;
  const T* xb = x + (long long)b * n * c + cv * 8;
  for (int r = r0 + lane_row; r < r1; r += rb) {
    float f[8];
    load8(xb + (long long)r * c, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s[i] += f[i];
      ss[i] += f[i] * f[i];
    }
  }
  float* mine = red + lane_row * 2 * c + cv * 8;
  store8f(mine, s);
  store8f(mine + c, ss);
  __syncthreads();
  float* out = ws + ((long long)b * chunks + chunk) * 2 * c;
  for (int i = threadIdx.x; i < 2 * c; i += blockDim.x) {
    float acc = 0.0f;
    for (int k = 0; k < rb; ++k) acc += red[k * 2 * c + i];
    out[i] = acc;
  }
}

__global__ void __launch_bounds__(kCombineThreads)
    gn_combine_kernel(const float* __restrict__ ws, const float* __restrict__ scale,
                      const float* __restrict__ bias, float* __restrict__ a,
                      float* __restrict__ v, int n, int c, int groups, int chunks, float eps) {
  __shared__ float warp_s[kCombineThreads / 32], warp_ss[kCombineThreads / 32];
  __shared__ float stat[2];
  const int g = blockIdx.x, b = blockIdx.y;
  const int cpg = c / groups;
  const float* w = ws + (long long)b * chunks * 2 * c + g * cpg;
  float s = 0.0f, ss = 0.0f;
  for (int i = threadIdx.x; i < chunks * cpg; i += kCombineThreads) {
    const int k = i / cpg, j = i - k * cpg;
    s += w[(long long)k * 2 * c + j];
    ss += w[(long long)k * 2 * c + c + j];
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    warp_s[warp] = s;
    warp_ss[warp] = ss;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ts = 0.0f, tss = 0.0f;
    for (int k = 0; k < kCombineThreads / 32; ++k) {
      ts += warp_s[k];
      tss += warp_ss[k];
    }
    const float count = (float)n * (float)cpg;
    const float mean = ts / count;
    const float var = fmaxf(tss / count - mean * mean, 0.0f);
    stat[0] = mean;
    stat[1] = rsqrtf(var + eps);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < cpg; j += kCombineThreads) {
    const int ch = g * cpg + j;
    const float av = stat[1] * scale[ch];
    a[(long long)b * c + ch] = av;
    v[(long long)b * c + ch] = bias[ch] - stat[0] * av;
  }
}

template <typename T, bool SILU>
__global__ void gn_normalize_kernel(const T* __restrict__ x, const float* __restrict__ a,
                                    const float* __restrict__ v, T* __restrict__ y, int n,
                                    int c) {
  extern __shared__ __align__(16) float av[];  // (2, C): the sample's a, then v
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < c; i += blockDim.x) {
    av[i] = a[(long long)b * c + i];
    av[c + i] = v[(long long)b * c + i];
  }
  __syncthreads();
  const int vpr = c / 8;
  const int vecs = n * vpr;  // the wrapper keeps n * c < 2^31
  const T* xs = x + (long long)b * n * c;
  T* ys = y + (long long)b * n * c;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < vecs; i += gridDim.x * blockDim.x) {
    const int ch = (i % vpr) * 8;
    float f[8];
    load8(xs + (long long)i * 8, f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float t = f[j] * av[ch + j] + av[c + ch + j];
      f[j] = SILU ? silu(t) : t;
    }
    store8(ys + (long long)i * 8, f);
  }
}

template <typename T>
__global__ void __launch_bounds__(kLnWarps * 32)
    layer_norm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ bias, T* __restrict__ y, int rows, int c,
                      float eps) {
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * kLnWarps + threadIdx.x / 32;
  if (r >= rows) return;
  const T* xr = x + (long long)r * c;
  float s = 0.0f, ss = 0.0f;
  for (int k = lane * 8; k < c; k += 32 * 8) {
    float f[8];
    load8(xr + k, f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s += f[j];
      ss += f[j] * f[j];
    }
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mean = s / c;
  const float rstd = rsqrtf(fmaxf(ss / c - mean * mean, 0.0f) + eps);
  T* yr = y + (long long)r * c;
  for (int k = lane * 8; k < c; k += 32 * 8) {
    float f[8], sc[8], bi[8];
    load8(xr + k, f);
    load8f(scale + k, sc);
    load8f(bias + k, bi);
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = (f[j] - mean) * rstd * sc[j] + bi[j];
    store8(yr + k, f);
  }
}

// ------------------------------------------------ one launch: gn_fused_kernel

constexpr int kFusedThreads = 1024;  // 32 warps an SM: the passes are bound by issue, not bytes
constexpr int kMaxCluster = 16;      // blocks a sample: a cluster (non-portable size above 8)
// A block streams its rows through a ring of shared-memory slots, each a
// whole number of rows brought in by one bulk async copy: 128 KB in flight a
// block.
constexpr int kSlots = 4;
constexpr int kSlotBytes = 32768;
constexpr int kRingBytes = kSlots * kSlotBytes;

__device__ __forceinline__ uint32_t shared_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The slot's barrier: one arrival (the copy's issuer) plus its bytes.
__device__ __forceinline__ void slot_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Spin until the barrier's phase of this parity completes; a wait of ~2^28
// polls traps instead of hanging the card.
__device__ __forceinline__ void slot_wait(uint32_t bar, uint32_t parity) {
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

// Every thread of every block of the cluster: the shared-memory writes
// before it are visible to the whole cluster after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Two adjacent floats of block `rank`'s shared memory, at the address of
// `local` in this one: one round trip through distributed shared memory.
__device__ __forceinline__ float2 cluster_load2(const float* local, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(shared_u32(local)), "r"(rank));
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(remote)
               : "memory");
  return v;
}

// Shared memory of gn_fused_kernel after the ring, in floats: the (RB, 2, C)
// partials, later the sample's (2, groups) mean, rstd; then the block's
// (groups, 2) group sums (sum, sum of squares), which the cluster reads.
__host__ __device__ inline int gn_fused_floats(int c, int groups) {
  const int rb = kFusedThreads / (c / 8);
  return (rb * 2 * c > 2 * groups ? rb * 2 * c : 2 * groups) + 2 * groups;
}

// MODE 0: the affine a, v only (gn_affine); 1: normalise; 2: normalise + SiLU.
// Grid (chunks, B), one cluster of `chunks` blocks a sample, a block a row
// chunk.  A thread owns one 8-channel vector column of RB rows side by side
// (V = C / 8 columns, RB = 1024 / V) in both passes.
template <int MODE>
__global__ void __launch_bounds__(kFusedThreads, 1)
    gn_fused_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
                    const float* __restrict__ bias, float* __restrict__ a_out,
                    float* __restrict__ v_out, bf16* __restrict__ y, int n, int c, int groups,
                    float eps) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) uint64_t slot_bars[kSlots];
  uint8_t* ring = smem;
  float* red = reinterpret_cast<float*>(smem + kRingBytes);
  float* mine = red + gn_fused_floats(c, groups) - 2 * groups;  // this block's group sums
  const int tid = threadIdx.x, b = blockIdx.y, chunk = blockIdx.x, chunks = gridDim.x;
  const int v = c / 8, cpg = c / groups;
  const int rb = kFusedThreads / v, lane_row = tid / v, cv = tid % v;
  const bool active = lane_row < rb;
  const int rows = (n + chunks - 1) / chunks;
  const int r0 = min(n, chunk * rows), r1 = min(n, r0 + rows);
  const int piece_rows = max(1, kSlotBytes / (2 * c));
  const int pieces = (r1 - r0 + piece_rows - 1) / piece_rows;
  const int loads = MODE == 0 ? pieces : 2 * pieces;
  const bf16* xb = x + (long long)b * n * c;
  if (tid == 0) {
    for (int k = 0; k < kSlots; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(shared_u32(&slot_bars[k]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // load q of the stream (q < pieces: the statistics pass; then the
  // normalising pass, rows again) into slot q % kSlots, by thread 0
  auto issue = [&](int q) {
    const int pr0 = r0 + (q % pieces) * piece_rows;
    const int bytes = min(piece_rows, r1 - pr0) * c * 2;
    slot_load(shared_u32(ring + q % kSlots * kSlotBytes), xb + (long long)pr0 * c, bytes,
              shared_u32(&slot_bars[q % kSlots]));
  };
  if (tid == 0)
    for (int q = 0; q < min(kSlots, loads); ++q) issue(q);
  // this thread's 8 channels' scale and shift, loaded while the rows arrive
  float sc[8], sh[8];
  if (active) {
    load8f(scale + cv * 8, sc);
    load8f(bias + cv * 8, sh);
  }

  float s[8], ss[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = ss[i] = 0.0f;
  for (int q = 0; q < pieces; ++q) {
    slot_wait(shared_u32(&slot_bars[q % kSlots]), (q / kSlots) & 1);
    const uint8_t* tile = ring + q % kSlots * kSlotBytes;
    const int prn = min(piece_rows, r1 - r0 - q * piece_rows);
    if (active) {
      for (int rr = lane_row; rr < prn; rr += rb) {  // the rows in order
        float f[8];
        unpack8(*reinterpret_cast<const uint4*>(tile + (rr * c + cv * 8) * 2), f);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          s[i] += f[i];
          ss[i] += f[i] * f[i];
        }
      }
    }
    __syncthreads();  // every thread is done with the slot
    if (tid == 0 && q + kSlots < loads) issue(q + kSlots);
  }
  if (active) {
    store8f(red + lane_row * 2 * c + cv * 8, s);
    store8f(red + lane_row * 2 * c + c + cv * 8, ss);
  }
  __syncthreads();
  // row lanes, in order, into lane 0's row
  for (int i = tid; i < 2 * c; i += kFusedThreads) {
    float acc = red[i];
    for (int k = 1; k < rb; ++k) acc += red[k * 2 * c + i];
    red[i] = acc;
  }
  __syncthreads();
  // each group's channels: a warp a group, lanes strided over its channels,
  // then a fixed shuffle tree
  const int warp = tid / 32, lane = tid % 32;
  for (int g = warp; g < groups; g += kFusedThreads / 32) {
    float gs = 0.0f, gss = 0.0f;
    for (int j = lane; j < cpg; j += 32) {
      gs += red[g * cpg + j];
      gss += red[c + g * cpg + j];
    }
    gs = warp_sum(gs);
    gss = warp_sum(gss);
    if (lane == 0) *reinterpret_cast<float2*>(mine + 2 * g) = make_float2(gs, gss);
  }
  cluster_sync();  // every block's group sums are written

  // the cluster's group sums, a warp a group, lane k reading block k's, then
  // the same shuffle tree: each group's mean and rstd
  float* stat = red;  // (2, groups): mean, rstd
  const float count = (float)n * (float)cpg;
  for (int g = warp; g < groups; g += kFusedThreads / 32) {
    float2 sums = make_float2(0.0f, 0.0f);
    if (lane < chunks) sums = cluster_load2(mine + 2 * g, lane);
    const float gs = warp_sum(sums.x), gss = warp_sum(sums.y);
    if (lane == 0) {
      const float mean = gs / count;
      stat[g] = mean;
      stat[groups + g] = rsqrtf(fmaxf(gss / count - mean * mean, 0.0f) + eps);
    }
  }
  // this block is done reading the cluster's sums; it waits for the others
  // to be done with its own only before it exits
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  __syncthreads();
  // this thread's 8 channels: a, v in registers
  float av[8], vv[8];
  if (active) {
    int g = cv * 8 / cpg, next = (g + 1) * cpg;  // the group of channel cv * 8 + j
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      while (cv * 8 + j >= next) ++g, next += cpg;
      av[j] = stat[groups + g] * sc[j];
      vv[j] = sh[j] - stat[g] * av[j];
    }
    if (chunk == 0 && lane_row == 0) {
      store8f(a_out + (long long)b * c + cv * 8, av);
      store8f(v_out + (long long)b * c + cv * 8, vv);
    }
  }
  if (MODE == 0) {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    return;
  }

  // the normalising pass over the same rows, streamed again (from L2)
  bf16* yb = y + (long long)b * n * c;
  for (int p = 0; p < pieces; ++p) {
    const int q = pieces + p;
    slot_wait(shared_u32(&slot_bars[q % kSlots]), (q / kSlots) & 1);
    const uint8_t* tile = ring + q % kSlots * kSlotBytes;
    const int pr0 = r0 + p * piece_rows, prn = min(piece_rows, r1 - pr0);
    if (active) {
      for (int rr = lane_row; rr < prn; rr += rb) {
        float f[8];
        unpack8(*reinterpret_cast<const uint4*>(tile + (rr * c + cv * 8) * 2), f);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float t = f[j] * av[j] + vv[j];
          f[j] = MODE == 2 ? silu(t) : t;
        }
        *reinterpret_cast<uint4*>(yb + (long long)(pr0 + rr) * c + cv * 8) = pack8(f);
      }
    }
    __syncthreads();
    if (tid == 0 && q + kSlots < loads) issue(q + kSlots);
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One launch of gn_fused_kernel<MODE>: b clusters of `chunks` blocks.
template <int MODE>
cudaError_t launch_fused(const bf16* x, const float* scale, const float* bias, float* a, float* v,
                         bf16* y, int b, int n, int c, int groups, int chunks, float eps,
                         cudaStream_t stream) {
  const size_t smem = kRingBytes + gn_fused_floats(c, groups) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gn_fused_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gn_fused_kernel<MODE>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;

  cudaLaunchConfig_t cfg;
  memset(&cfg, 0, sizeof(cfg));
  cfg.gridDim = dim3(chunks, b);
  cfg.blockDim = dim3(kFusedThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = chunks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, gn_fused_kernel<MODE>, x, scale, bias, a, v, y, n, c, groups,
                            eps);
}

bool gn_shape_ok(int b, int n, int c, int groups, int chunks) {
  return b >= 1 && b <= 65535 && n >= 1 && c >= 8 && c % 8 == 0 && c <= kMaxC && groups >= 1 &&
         groups <= 65535 && c % groups == 0 && chunks >= 1 && chunks <= n &&
         (long long)n * c < (1LL << 31);
}

// Launches 1 and 2: the (B, C) affine a, v.
template <typename T>
cudaError_t launch_affine(const T* x, const float* scale, const float* bias, float* ws, float* a,
                          float* v, int b, int n, int c, int groups, int chunks, float eps,
                          cudaStream_t stream) {
  const int threads = gn_row_lanes(c) * (c / 8);
  const size_t smem = (size_t)gn_row_lanes(c) * 2 * c * sizeof(float);
  gn_partial_kernel<T><<<dim3(chunks, b), threads, smem, stream>>>(x, ws, n, c, chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_combine_kernel<<<dim3(groups, b), kCombineThreads, 0, stream>>>(ws, scale, bias, a, v, n, c,
                                                                     groups, chunks, eps);
  return cudaGetLastError();
}

// The three launches: the affine, then y = x * a + v (then SiLU), ~8 blocks
// an SM in all.
template <typename T>
cudaError_t launch_three(const T* x, const float* scale, const float* bias, float* ws, float* a,
                         float* v, T* y, int b, int n, int c, int groups, int chunks, float eps,
                         int silu, cudaStream_t s) {
  cudaError_t err = launch_affine(x, scale, bias, ws, a, v, b, n, c, groups, chunks, eps, s);
  if (err != cudaSuccess) return err;
  const int threads = 256;
  const int vecs = n * (c / 8);
  const int per_sample = max(1, (8 * kSMs + b - 1) / b);
  const dim3 grid(min((vecs + threads - 1) / threads, per_sample), b);
  const size_t smem = 2 * (size_t)c * sizeof(float);
  if (silu)
    gn_normalize_kernel<T, true><<<grid, threads, smem, s>>>(x, a, v, y, n, c);
  else
    gn_normalize_kernel<T, false><<<grid, threads, smem, s>>>(x, a, v, y, n, c);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes.  Each returns a cudaError_t (0 = launched).
// Every tensor is contiguous and 16-byte aligned; the caller checks shapes,
// dtypes and devices.  x is (b, n, c) bf16 with n the flattened spatial axis;
// scale/bias (c,) fp32; a, v (b, c) fp32.  The route is the caller's
// (ops/fused_norm.py:gn_plan): one_launch != 0 runs one launch of b clusters
// of `chunks` blocks (at most 16; ws unused); else three launches, chunks row
// chunks per sample, with ws a (b, chunks, 2, c) fp32 scratch.

// a, v such that GroupNorm(x) * scale + bias == x * a + v.
extern "C" int gn_affine_bf16(const void* x, const float* scale, const float* bias, float* ws,
                              float* a, float* v, int b, int n, int c, int groups, int chunks,
                              float eps, int one_launch, void* stream) {
  if (!gn_shape_ok(b, n, c, groups, chunks) || (one_launch && chunks > kMaxCluster))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  if (one_launch)
    return (int)launch_fused<0>(xb, scale, bias, a, v, nullptr, b, n, c, groups, chunks, eps, s);
  return (int)launch_affine<bf16>(xb, scale, bias, ws, a, v, b, n, c, groups, chunks, eps, s);
}

// y = GroupNorm(x) * scale + bias, then SiLU when silu != 0; y (b, n, c) bf16.
extern "C" int group_norm_bf16(const void* x, const float* scale, const float* bias, float* ws,
                               float* a, float* v, void* y, int b, int n, int c, int groups,
                               int chunks, float eps, int silu, int one_launch, void* stream) {
  if (!gn_shape_ok(b, n, c, groups, chunks) || (one_launch && chunks > kMaxCluster))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* yb = static_cast<bf16*>(y);
  if (one_launch)
    return (int)(silu ? launch_fused<2>(xb, scale, bias, a, v, yb, b, n, c, groups, chunks, eps, s)
                      : launch_fused<1>(xb, scale, bias, a, v, yb, b, n, c, groups, chunks, eps, s));
  return (int)launch_three<bf16>(xb, scale, bias, ws, a, v, yb, b, n, c, groups, chunks, eps, silu,
                                 s);
}

// The same with fp32 x and y (b, n, c), on the three launches only (ws a
// (b, chunks, 2, c) fp32 scratch).
extern "C" int group_norm_f32(const void* x, const float* scale, const float* bias, float* ws,
                              float* a, float* v, void* y, int b, int n, int c, int groups,
                              int chunks, float eps, int silu, void* stream) {
  if (!gn_shape_ok(b, n, c, groups, chunks)) return (int)cudaErrorInvalidValue;
  return (int)launch_three<float>(static_cast<const float*>(x), scale, bias, ws, a, v,
                                  static_cast<float*>(y), b, n, c, groups, chunks, eps, silu,
                                  static_cast<cudaStream_t>(stream));
}

// The affine a, v of fp32 x (b, n, c): launches 1 and 2 of the three-launch
// route (ws a (b, chunks, 2, c) fp32 scratch), the statistics of the fused
// conv's fp32 route (fused_conv.cu: gn_silu_conv3x3_f32).
extern "C" int gn_affine_f32(const void* x, const float* scale, const float* bias, float* ws,
                             float* a, float* v, int b, int n, int c, int groups, int chunks,
                             float eps, void* stream) {
  if (!gn_shape_ok(b, n, c, groups, chunks)) return (int)cudaErrorInvalidValue;
  return (int)launch_affine<float>(static_cast<const float*>(x), scale, bias, ws, a, v, b, n, c,
                                   groups, chunks, eps, static_cast<cudaStream_t>(stream));
}

// y = LayerNorm(x) * scale + bias over rows of c, x and y (rows, c) of type T.
template <typename T>
int launch_layer_norm(const void* x, const float* scale, const float* bias, void* y, int rows,
                      int c, float eps, void* stream) {
  if (rows < 1 || c < 8 || c % 8) return (int)cudaErrorInvalidValue;
  const int blocks = (rows + kLnWarps - 1) / kLnWarps;
  layer_norm_kernel<T><<<blocks, kLnWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), scale, bias, static_cast<T*>(y), rows, c, eps);
  return (int)cudaGetLastError();
}

// bf16 x and y.
extern "C" int layer_norm_bf16(const void* x, const float* scale, const float* bias, void* y,
                               int rows, int c, float eps, void* stream) {
  return launch_layer_norm<bf16>(x, scale, bias, y, rows, c, eps, stream);
}

// fp32 x and y (a model served in fp32; pallas_norm.py:155-178 computes in x.dtype).
extern "C" int layer_norm_f32(const void* x, const float* scale, const float* bias, void* y,
                              int rows, int c, float eps, void* stream) {
  return launch_layer_norm<float>(x, scale, bias, y, rows, c, eps, stream);
}
