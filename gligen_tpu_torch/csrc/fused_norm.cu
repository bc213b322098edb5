// GroupNorm (+SiLU) and LayerNorm for Hopper (sm_90a): bf16 in / bf16 out, fp32 statistics.
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
// (2, 512, 512, 128) bf16, is 67 MB a sample.  So GroupNorm runs in three
// launches from one entry point:
//   1. gn_partial_kernel, grid (row chunks, B): each thread owns one 8-channel
//      vector column and strides over the chunk's rows with 16-byte loads,
//      keeping 8 sums and 8 sums of squares; the block folds its row lanes
//      through shared memory in a fixed order and writes one (2, C) partial.
//   2. gn_combine_kernel, grid (groups, B): one block folds a group's
//      partials over chunks and channels (a fixed strided order, then a
//      fixed shuffle tree), computes mean, var = max(E[x^2] - mean^2, 0),
//      rstd = rsqrt(var + eps), and writes a, v for the group's channels.
//   3. gn_normalize_kernel, grid (blocks, B): y = x * a + v (then y *
//      sigmoid(y)), 8 channels per thread, the sample's a/v in shared memory.
// No float atomics: a run repeats bit for bit.  LayerNorm gives each row to a
// warp: one pass for the fp32 sums, a second over the same row (from L1/L2)
// to normalise and store; any row count, the fuser's ragged N+30 included.
//
// What bounds it on the H100: bytes.  GroupNorm reads x twice (stats, then
// normalise) and writes y once; the second read comes from L2 where the
// activation fits its 50 MB (every UNet activation: at most 10.5 MB), and
// from HBM for the VAE's top levels (134-268 MB).  The least traffic, one read
// and one write, is 21 MB (6.3 us at 3.35 TB/s) at ResBlock ds1 (4, 64, 64,
// 320) and 268 MB (80 us) at the VAE's (2, 512, 512, 128).  LayerNorm moves
// one read and one write, 21 MB (6.3 us) at (4*4096, 320).

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

// ws: (B, chunks, 2, C) fp32: [.., 0, :] sums of x, [.., 1, :] sums of x^2.
__global__ void gn_partial_kernel(const bf16* __restrict__ x, float* __restrict__ ws, int n, int c,
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
  const bf16* xb = x + (long long)b * n * c + cv * 8;
  for (int r = r0 + lane_row; r < r1; r += rb) {
    float f[8];
    unpack8(*reinterpret_cast<const uint4*>(xb + (long long)r * c), f);
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

template <bool SILU>
__global__ void gn_normalize_kernel(const bf16* __restrict__ x, const float* __restrict__ a,
                                    const float* __restrict__ v, bf16* __restrict__ y, int n,
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
  const uint4* xs = reinterpret_cast<const uint4*>(x + (long long)b * n * c);
  uint4* ys = reinterpret_cast<uint4*>(y + (long long)b * n * c);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < vecs; i += gridDim.x * blockDim.x) {
    const int ch = (i % vpr) * 8;
    float f[8];
    unpack8(xs[i], f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float t = f[j] * av[ch + j] + av[c + ch + j];
      f[j] = SILU ? silu(t) : t;
    }
    ys[i] = pack8(f);
  }
}

__global__ void __launch_bounds__(kLnWarps * 32)
    layer_norm_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ bias, bf16* __restrict__ y, int rows, int c,
                      float eps) {
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * kLnWarps + threadIdx.x / 32;
  if (r >= rows) return;
  const bf16* xr = x + (long long)r * c;
  float s = 0.0f, ss = 0.0f;
  for (int k = lane * 8; k < c; k += 32 * 8) {
    float f[8];
    unpack8(*reinterpret_cast<const uint4*>(xr + k), f);
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
  bf16* yr = y + (long long)r * c;
  for (int k = lane * 8; k < c; k += 32 * 8) {
    float f[8], sc[8], bi[8];
    unpack8(*reinterpret_cast<const uint4*>(xr + k), f);
    load8f(scale + k, sc);
    load8f(bias + k, bi);
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = (f[j] - mean) * rstd * sc[j] + bi[j];
    *reinterpret_cast<uint4*>(yr + k) = pack8(f);
  }
}

bool gn_shape_ok(int b, int n, int c, int groups, int chunks) {
  return b >= 1 && b <= 65535 && n >= 1 && c >= 8 && c % 8 == 0 && c <= kMaxC && groups >= 1 &&
         groups <= 65535 && c % groups == 0 && chunks >= 1 && chunks <= n &&
         (long long)n * c < (1LL << 31);
}

// Launches 1 and 2: the (B, C) affine a, v.
cudaError_t launch_affine(const bf16* x, const float* scale, const float* bias, float* ws,
                          float* a, float* v, int b, int n, int c, int groups, int chunks,
                          float eps, cudaStream_t stream) {
  const int threads = gn_row_lanes(c) * (c / 8);
  const size_t smem = (size_t)gn_row_lanes(c) * 2 * c * sizeof(float);
  gn_partial_kernel<<<dim3(chunks, b), threads, smem, stream>>>(x, ws, n, c, chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_combine_kernel<<<dim3(groups, b), kCombineThreads, 0, stream>>>(ws, scale, bias, a, v, n, c,
                                                                     groups, chunks, eps);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes.  Each returns a cudaError_t (0 = launched).
// Every tensor is contiguous and 16-byte aligned; the caller checks shapes,
// dtypes and devices.  x is (b, n, c) bf16 with n the flattened spatial axis;
// scale/bias (c,) fp32; ws a (b, chunks, 2, c) fp32 scratch; a, v (b, c) fp32.

// a, v such that GroupNorm(x) * scale + bias == x * a + v.
extern "C" int gn_affine_bf16(const void* x, const float* scale, const float* bias, float* ws,
                              float* a, float* v, int b, int n, int c, int groups, int chunks,
                              float eps, void* stream) {
  if (!gn_shape_ok(b, n, c, groups, chunks)) return (int)cudaErrorInvalidValue;
  return (int)launch_affine(static_cast<const bf16*>(x), scale, bias, ws, a, v, b, n, c, groups,
                            chunks, eps, static_cast<cudaStream_t>(stream));
}

// y = GroupNorm(x) * scale + bias, then SiLU when silu != 0; y (b, n, c) bf16.
extern "C" int group_norm_bf16(const void* x, const float* scale, const float* bias, float* ws,
                               float* a, float* v, void* y, int b, int n, int c, int groups,
                               int chunks, float eps, int silu, void* stream) {
  if (!gn_shape_ok(b, n, c, groups, chunks)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  cudaError_t err = launch_affine(xb, scale, bias, ws, a, v, b, n, c, groups, chunks, eps, s);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const int vecs = n * (c / 8);
  const int per_sample = max(1, (8 * kSMs + b - 1) / b);  // ~8 blocks per SM in all
  const dim3 grid(min((vecs + threads - 1) / threads, per_sample), b);
  const size_t smem = 2 * (size_t)c * sizeof(float);
  bf16* yb = static_cast<bf16*>(y);
  if (silu)
    gn_normalize_kernel<true><<<grid, threads, smem, s>>>(xb, a, v, yb, n, c);
  else
    gn_normalize_kernel<false><<<grid, threads, smem, s>>>(xb, a, v, yb, n, c);
  return (int)cudaGetLastError();
}

// y = LayerNorm(x) * scale + bias over rows of c; x, y (rows, c) bf16.
extern "C" int layer_norm_bf16(const void* x, const float* scale, const float* bias, void* y,
                               int rows, int c, float eps, void* stream) {
  if (rows < 1 || c < 8 || c % 8) return (int)cudaErrorInvalidValue;
  const int blocks = (rows + kLnWarps - 1) / kLnWarps;
  layer_norm_kernel<<<blocks, kLnWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), scale, bias, static_cast<bf16*>(y), rows, c, eps);
  return (int)cudaGetLastError();
}
