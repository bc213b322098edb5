// Flash-attention forward for Hopper (sm_90a), bf16 in / bf16 out, fp32 softmax.
//
// Replaces the TPU Pallas forwards of gligen_tpu/ops/pallas_attention.py:
//   * _packed_fwd_impl single-KV branch (pallas_call at :836, kernel bodies
//     _fwd_kernel_single :252 / _fwd_kernel_single_chunked :163), reached from
//     flash_attention_packed :1093 -- UNet attn1 and the gated self-attention
//     fuser;
//   * _fwd_impl streamed branch (pallas_call at :466, kernel body _fwd_kernel
//     :328), reached from flash_attention :719 / mha_flash :1226 -- the VAE
//     decoder's single-head, dim-512 mid-attention.
// Both compute, per (batch, head):
//   out = softmax(scale * q k^T + bias) v,   lse = log2(sum_j exp(scale q.k_j + bias_j))
// The LSE is in LOG2 units, as the TPU kernel stores it; the backward kernels
// recompute probabilities from it.
//
// Layout.  q/k/v/o are read and written through (batch, head, row) strides
// with a unit stride along the head dim, so the packed (B, N, H*C) layout and
// the (B*H, N, D) layout (H = 1) are both used in place, with no transpose.
// Head dims that are not multiples of 16 (40, 80) are zero-padded in shared
// memory by masked loads, which is exact: the padded lanes add zero to every
// dot product.  Keys at or past M are masked to -inf, so M needs no padding
// (the fuser's N+30 keys are used as they are).  `bias` is an optional fp32
// additive row per (batch, key) in natural-log units.
//
// Algorithm.  One block of 4 warps owns BQ query rows of one (batch, head) and
// walks the keys in tiles of BK with the online softmax: a running row max m,
// a running sum l and an fp32 accumulator O kept in shared memory (a 64 x 512
// fp32 accumulator does not fit in the registers of a 128-thread block, and
// the VAE's head is 512 wide).  Per KV tile: S = Q K^T on the tensor cores
// (WMMA bf16 16x16x16, fp32 accumulate) into shared memory; one warp per row
// turns S into P = exp2(S*scale*log2e + bias*log2e - m_new) (bf16), rescales
// its O row by exp2(m_old - m_new) and updates l; then O += P V on the tensor
// cores, with O loaded from and stored back to shared memory.
//
// What bounds it on the H100.  The shapes of the 512^2 path are compute-bound
// in principle: the largest call (ds1 attn1, 4 x 8 heads x 4096 queries x
// 4096 keys x d 40) does 86 GFLOP over 42 MB of q/k/v/o, and one head's K+V
// (0.7 MB) stays in the 50 MB L2 while its 64 query tiles re-read it.  So the
// limit is the tensor-core issue rate.  This first version is simple rather
// than fast: WMMA (mma.sync) instead of wgmma, no TMA, no double buffering,
// the O accumulator and the softmax between the two products go through
// shared memory, and 133 KB of shared memory at d = 160 leaves one block per
// SM.  Those are the levers for a later change; PERF.md has its measured
// times beside the plain version's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <cmath>

using namespace nvcuda;

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxDpad = 512;

typedef __nv_bfloat16 bf16;

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const float* bias;  // (B, M) rows at stride bias_sb, or null
  bf16* o;
  float* lse;  // (B, H, N) contiguous
  int heads, n, m, d, dpad;
  long long q_sb, q_sh, q_sn;
  long long k_sb, k_sh, k_sn;
  long long v_sb, v_sh, v_sn;
  long long o_sb, o_sh, o_sn;
  long long bias_sb;
  float scale_log2;  // softmax scale * log2(e)
  int vec;           // 1: every row start is 16-byte aligned and d % 8 == 0
};

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

// Shared-memory carve-up, shared by the kernel and the host-side size query.
struct Smem {
  size_t q, k, v, o, s, p, bias, m, l, total;
  __host__ __device__ Smem(int bq, int bk, int dpad) {
    const size_t ldh = dpad + 8, ldo = dpad + 4, lds = bk + 4, ldp = bk + 8;
    q = 0;
    k = align128(q + bq * ldh * sizeof(bf16));
    v = align128(k + bk * ldh * sizeof(bf16));
    o = align128(v + bk * ldh * sizeof(bf16));
    s = align128(o + bq * ldo * sizeof(float));
    p = align128(s + bq * lds * sizeof(float));
    bias = align128(p + bq * ldp * sizeof(bf16));
    m = align128(bias + bk * sizeof(float));
    l = align128(m + bq * sizeof(float));
    total = align128(l + bq * sizeof(float));
  }
};

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// rows x dpad tile of a (row-strided, unit-column-stride) matrix into shared
// memory at leading dimension ld; rows >= valid and columns >= d become 0.
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src, long long sn,
                                          int rows, int valid, int d, int dpad, int vec) {
  if (vec) {
    const int chunks = dpad / 8;
    for (int i = threadIdx.x; i < rows * chunks; i += kThreads) {
      const int r = i / chunks, c = (i % chunks) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < valid && c < d) val = *reinterpret_cast<const uint4*>(src + r * sn + c);
      *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
    }
  } else {
    const bf16 zero = __float2bfloat16(0.0f);
    for (int i = threadIdx.x; i < rows * dpad; i += kThreads) {
      const int r = i / dpad, c = i % dpad;
      dst[r * ld + c] = (r < valid && c < d) ? src[r * sn + c] : zero;
    }
  }
}

template <int BQ, int BK>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int dpad = p.dpad;
  const int ldh = dpad + 8, ldo = dpad + 4;
  constexpr int lds = BK + 4, ldp = BK + 8;
  const Smem lay(BQ, BK, dpad);
  bf16* sQ = reinterpret_cast<bf16*>(smem + lay.q);
  bf16* sK = reinterpret_cast<bf16*>(smem + lay.k);
  bf16* sV = reinterpret_cast<bf16*>(smem + lay.v);
  float* sO = reinterpret_cast<float*>(smem + lay.o);
  float* sS = reinterpret_cast<float*>(smem + lay.s);
  bf16* sP = reinterpret_cast<bf16*>(smem + lay.p);
  float* sBias = reinterpret_cast<float*>(smem + lay.bias);
  float* sM = reinterpret_cast<float*>(smem + lay.m);
  float* sL = reinterpret_cast<float*>(smem + lay.l);

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ksteps = dpad / 16;
  const int q_valid = min(BQ, p.n - q0);

  load_tile(sQ, ldh, p.q + b * p.q_sb + h * p.q_sh + q0 * p.q_sn, p.q_sn, BQ, q_valid, p.d,
            dpad, p.vec);
  for (int i = threadIdx.x; i < BQ * ldo; i += kThreads) sO[i] = 0.0f;
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    sM[r] = -INFINITY;
    sL[r] = 0.0f;
  }
  const bf16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const bf16* vb = p.v + b * p.v_sb + h * p.v_sh;
  const float* biasb = p.bias ? p.bias + b * p.bias_sb : nullptr;

  for (int k0 = 0; k0 < p.m; k0 += BK) {
    __syncthreads();  // the previous tile's P V product is done with sK/sV/sP
    const int k_valid = min(BK, p.m - k0);
    load_tile(sK, ldh, kb + k0 * p.k_sn, p.k_sn, BK, k_valid, p.d, dpad, p.vec);
    load_tile(sV, ldh, vb + k0 * p.v_sn, p.v_sn, BK, k_valid, p.d, dpad, p.vec);
    for (int j = threadIdx.x; j < BK; j += kThreads)
      sBias[j] = j < k_valid ? (biasb ? biasb[k0 + j] * kLog2e : 0.0f) : -INFINITY;
    __syncthreads();

    // S = Q K^T: K is stored row-major (BK x dpad), i.e. K^T column-major.
    for (int t = warp; t < (BQ / 16) * (BK / 16); t += kWarps) {
      const int tr = t / (BK / 16), tc = t % (BK / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
      for (int kk = 0; kk < ksteps; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, sQ + tr * 16 * ldh + kk * 16, ldh);
        wmma::load_matrix_sync(fb, sK + tc * 16 * ldh + kk * 16, ldh);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(sS + tr * 16 * lds + tc * 16, acc, lds, wmma::mem_row_major);
    }
    __syncthreads();

    // Online softmax, one warp per row (log2 domain).
    for (int r = warp; r < BQ; r += kWarps) {
      const float m_old = sM[r];
      float mx = m_old;
      for (int j = lane; j < BK; j += 32) {
        const float s = sS[r * lds + j] * p.scale_log2 + sBias[j];
        sS[r * lds + j] = s;
        mx = fmaxf(mx, s);
      }
      mx = warp_max(mx);
      // Every key so far masked: keep O = 0, l = 0 and make p = 0.
      const float m_use = mx == -INFINITY ? 0.0f : mx;
      const float alpha = mx == -INFINITY ? 1.0f : exp2f(m_old - mx);
      float sum = 0.0f;
      for (int j = lane; j < BK; j += 32) {
        const float pv = exp2f(sS[r * lds + j] - m_use);
        sP[r * ldp + j] = __float2bfloat16(pv);
        sum += pv;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        sM[r] = mx;
        sL[r] = sL[r] * alpha + sum;
      }
      for (int c = lane; c < dpad; c += 32) sO[r * ldo + c] *= alpha;
    }
    __syncthreads();

    // O += P V, accumulating through shared memory.
    for (int t = warp; t < (BQ / 16) * ksteps; t += kWarps) {
      const int tr = t / ksteps, tc = t % ksteps;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, sO + tr * 16 * ldo + tc * 16, ldo, wmma::mem_row_major);
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, sP + tr * 16 * ldp + kk * 16, ldp);
        wmma::load_matrix_sync(fb, sV + kk * 16 * ldh + tc * 16, ldh);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(sO + tr * 16 * ldo + tc * 16, acc, ldo, wmma::mem_row_major);
    }
  }
  __syncthreads();

  bf16* ob = p.o + b * p.o_sb + h * p.o_sh + q0 * p.o_sn;
  for (int i = threadIdx.x; i < q_valid * p.d; i += kThreads) {
    const int r = i / p.d, c = i % p.d;
    ob[r * p.o_sn + c] = __float2bfloat16(sO[r * ldo + c] / sL[r]);
  }
  float* lb = p.lse + ((long long)b * p.heads + h) * p.n + q0;
  for (int r = threadIdx.x; r < q_valid; r += kThreads) lb[r] = sM[r] + log2f(sL[r]);
}

template <int BQ, int BK>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = Smem(BQ, BK, p.dpad).total;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<BQ, BK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.n + BQ - 1) / BQ, p.heads, batch);
  flash_fwd_kernel<BQ, BK><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.  Returns a cudaError_t (0 = launched).
// Strides are in elements.  The caller checks shapes, dtypes and devices.
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v, const float* bias,
                              void* o, float* lse, int batch, int heads, int n, int m, int d,
                              long long q_sb, long long q_sh, long long q_sn, long long k_sb,
                              long long k_sh, long long k_sn, long long v_sb, long long v_sh,
                              long long v_sn, long long o_sb, long long o_sh, long long o_sn,
                              long long bias_sb, float scale, int vec, void* stream) {
  if (d < 1 || d > kMaxDpad || n < 1 || m < 1) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.bias = bias;
  p.o = static_cast<bf16*>(o);
  p.lse = lse;
  p.heads = heads;
  p.n = n;
  p.m = m;
  p.d = d;
  p.dpad = (d + 15) / 16 * 16;
  p.q_sb = q_sb, p.q_sh = q_sh, p.q_sn = q_sn;
  p.k_sb = k_sb, p.k_sh = k_sh, p.k_sn = k_sn;
  p.v_sb = v_sb, p.v_sh = v_sh, p.v_sn = v_sn;
  p.o_sb = o_sb, p.o_sh = o_sh, p.o_sn = o_sn;
  p.bias_sb = bias_sb;
  p.scale_log2 = scale * kLog2e;
  p.vec = vec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 64 x 64 tiles up to d = 256 (<= 195 KB of shared memory); 32 x 32 above,
  // which keeps the d = 512 VAE head at 173 KB.
  return (int)(p.dpad <= 256 ? launch<64, 64>(p, batch, s) : launch<32, 32>(p, batch, s));
}
