// Flash-attention backward for Hopper (sm_90a): dq, and dk/dv (+ dbias), bf16
// in / bf16 out, fp32 probabilities and score gradients.
//
// Replaces the TPU Pallas backward of gligen_tpu/ops/pallas_attention.py:
//   * _flash_bwd (:583-701): the dq pallas_call at :627 over _bwd_dq_kernel
//     :491, and the dk/dv(/dbias) pallas_call at :684 over _bwd_dkv_kernel
//     :521, for the (B*H, N, D) layout;
//   * _flash_packed_bwd (:953-1086): the same kernel bodies at :1004 and
//     :1063 over the packed (B, N, H*C) layout, reached from
//     flash_attention_packed :1093 -- UNet attn1, the gated fuser's N+30
//     keys and the 77-token cross-attention.
// With s = scale q.k + bias (natural log units), P = softmax_j(s), the
// forward's LSE in LOG2 units and delta_i = sum_c dO_ic O_ic (computed by the
// caller), both kernels recompute
//   P_ij  = exp2(s_ij log2e - lse_i),   dS_ij = P_ij (dO_i . v_j - delta_i)
// and accumulate
//   dq_i = scale sum_j dS_ij k_j                     (flash_bwd_dq_kernel)
//   dv_j = sum_i P_ij dO_i,  dk_j = scale sum_i dS_ij q_i,
//   dbias_j (per head) = sum_i dS_ij                 (flash_bwd_dkv_kernel)
// The caller sums dbias over heads (the bias is shared by the heads), as
// pallas_attention.py:1078 does.
//
// Layout.  Every (B, L, H*C) tensor is read and written through (batch, head,
// row) strides with a unit stride along the head dim, as in flash_fwd.cu, so
// the packed layout and (B*H, N, D) (H = 1) are both used in place.  Head
// dims that are not multiples of 16 (40, 80) are zero-padded in shared memory
// by masked loads.  Keys at or past M get a -inf score (P = 0, dS = 0), so
// the fuser's N+30 keys need no padding: an unmasked out-of-range key would
// score 0 and give P = exp2(0 - lse) != 0.  Query rows at or past N get
// lse = +inf (P = 0).  Out-of-range rows are never written.
//
// Algorithm.  Two kernels, so that neither needs atomics and runs repeat bit
// for bit.  dq: one block of 4 warps per (batch, head, 64 query rows),
// streaming 64-key tiles; dk/dv: one block per (batch, head, 64 keys),
// streaming 64-row query tiles.  Per tile both recompute S = Q K^T and
// dP = dO V^T on the tensor cores (WMMA bf16 16x16x16, fp32 accumulate) into
// shared memory, turn them into P and dS in fp32 (one warp per row), round P
// and dS to bf16 only as the operands of the next products, and accumulate
// dQ += dS K (dq) or dV += P^T dO and dK += dS^T Q (dk/dv) in fp32
// accumulators kept in shared memory.  dbias sums the fp32 dS columns in a
// fixed order.
//
// What bounds it on the H100.  Like the forward, the training shapes are
// compute-bound in principle (ds1 attn1 backward: 5 products of 4 x 8 heads x
// 4096 x 4096 x 40, 107 GFLOP, over ~60 MB), so the limit is the tensor-core
// issue rate.  This first version is simple rather than fast: WMMA instead of
// wgmma, no TMA or double buffering, S and dP and the accumulators through
// shared memory, and both S and dP recomputed by both kernels.  At head dim
// 160 the dk/dv block takes 219 KB of shared memory (one block per SM).
// Those are the levers for a later change; PERF.md has its measured times.

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
constexpr int kMaxDpad = 160;
constexpr int kBQ = 64;  // query rows per tile
constexpr int kBK = 64;  // keys per tile
constexpr int kLds = kBK + 4, kLdp = kBK + 8;  // fp32 score and bf16 operand rows

typedef __nv_bfloat16 bf16;

// strides[] as the host passes them: (batch, head, row) of each tensor, in
// this order, then the bias row stride.
enum { kQ = 0, kK = 3, kV = 6, kDO = 9, kDQ = 12, kDK = 15, kDV = 18, kBiasRow = 21, kStrides = 22 };

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* bias;   // (B, M) rows at stride s[kBiasRow], natural-log units, or null
  const float* lse;    // (B, H, N) contiguous, log2 units
  const float* delta;  // (B, H, N) contiguous
  bf16* dq;
  bf16* dk;
  bf16* dv;
  float* dbias;        // (B, H, M) contiguous, or null
  int heads, n, m, d, dpad;
  long long s[kStrides];
  float scale, scale_log2;
  int vec;  // 1: every bf16 row start is 16-byte aligned and d % 8 == 0
};

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

// Shared-memory carve-ups, shared by the kernels and the host-side size query.
struct DqSmem {
  size_t q, dout, k, v, s, dp, ds, acc, bias, lse, delta, total;
  __host__ __device__ explicit DqSmem(int dpad) {
    const size_t ldh = dpad + 8, ldo = dpad + 4;
    q = 0;
    dout = align128(q + kBQ * ldh * sizeof(bf16));
    k = align128(dout + kBQ * ldh * sizeof(bf16));
    v = align128(k + kBK * ldh * sizeof(bf16));
    s = align128(v + kBK * ldh * sizeof(bf16));
    dp = align128(s + kBQ * kLds * sizeof(float));
    ds = align128(dp + kBQ * kLds * sizeof(float));
    acc = align128(ds + kBQ * kLdp * sizeof(bf16));
    bias = align128(acc + kBQ * ldo * sizeof(float));
    lse = align128(bias + kBK * sizeof(float));
    delta = align128(lse + kBQ * sizeof(float));
    total = align128(delta + kBQ * sizeof(float));
  }
};

struct DkvSmem {
  size_t k, v, q, dout, s, dp, p, ds, dk, dv, bias, lse, delta, db, total;
  __host__ __device__ explicit DkvSmem(int dpad) {
    const size_t ldh = dpad + 8, ldo = dpad + 4;
    k = 0;
    v = align128(k + kBK * ldh * sizeof(bf16));
    q = align128(v + kBK * ldh * sizeof(bf16));
    dout = align128(q + kBQ * ldh * sizeof(bf16));
    s = align128(dout + kBQ * ldh * sizeof(bf16));
    dp = align128(s + kBQ * kLds * sizeof(float));
    p = align128(dp + kBQ * kLds * sizeof(float));
    ds = align128(p + kBQ * kLdp * sizeof(bf16));
    dk = align128(ds + kBQ * kLdp * sizeof(bf16));
    dv = align128(dk + kBK * ldo * sizeof(float));
    bias = align128(dv + kBK * ldo * sizeof(float));
    lse = align128(bias + kBK * sizeof(float));
    delta = align128(lse + kBQ * sizeof(float));
    db = align128(delta + kBQ * sizeof(float));
    total = align128(db + kBK * sizeof(float));
  }
};

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

// The key tile's bias row in log2 units: -inf for keys at or past M.
__device__ __forceinline__ void load_bias(float* dst, const float* biasb, int k0, int k_valid) {
  for (int j = threadIdx.x; j < kBK; j += kThreads)
    dst[j] = j < k_valid ? (biasb ? biasb[k0 + j] * kLog2e : 0.0f) : -INFINITY;
}

// The query tile's lse and delta: +inf and 0 for rows at or past N (P = 0).
__device__ __forceinline__ void load_rows(float* lse, float* delta, const Params& p,
                                          long long row0, int q_valid) {
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    lse[r] = r < q_valid ? p.lse[row0 + r] : INFINITY;
    delta[r] = r < q_valid ? p.delta[row0 + r] : 0.0f;
  }
}

// S = Q K^T and dP = dO V^T for one (query tile, key tile) pair, fp32 into
// sS and sDP.  K and V are stored row-major (keys x dpad), i.e. K^T and V^T
// column-major.
__device__ __forceinline__ void scores(const bf16* sQ, const bf16* sDO, const bf16* sK,
                                       const bf16* sV, float* sS, float* sDP, int ldh,
                                       int ksteps, int warp) {
  constexpr int tiles = (kBQ / 16) * (kBK / 16);
  for (int t = warp; t < 2 * tiles; t += kWarps) {
    const bool is_dp = t >= tiles;
    const int tt = is_dp ? t - tiles : t;
    const int tr = tt / (kBK / 16), tc = tt % (kBK / 16);
    const bf16* a = is_dp ? sDO : sQ;
    const bf16* bm = is_dp ? sV : sK;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < ksteps; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, a + tr * 16 * ldh + kk * 16, ldh);
      wmma::load_matrix_sync(fb, bm + tc * 16 * ldh + kk * 16, ldh);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync((is_dp ? sDP : sS) + tr * 16 * kLds + tc * 16, acc, kLds,
                            wmma::mem_row_major);
  }
}

__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int dpad = p.dpad;
  const int ldh = dpad + 8, ldo = dpad + 4;
  const DqSmem lay(dpad);
  bf16* sQ = reinterpret_cast<bf16*>(smem + lay.q);
  bf16* sDO = reinterpret_cast<bf16*>(smem + lay.dout);
  bf16* sK = reinterpret_cast<bf16*>(smem + lay.k);
  bf16* sV = reinterpret_cast<bf16*>(smem + lay.v);
  float* sS = reinterpret_cast<float*>(smem + lay.s);
  float* sDP = reinterpret_cast<float*>(smem + lay.dp);
  bf16* sDS = reinterpret_cast<bf16*>(smem + lay.ds);
  float* sAcc = reinterpret_cast<float*>(smem + lay.acc);
  float* sBias = reinterpret_cast<float*>(smem + lay.bias);
  float* sLse = reinterpret_cast<float*>(smem + lay.lse);
  float* sDelta = reinterpret_cast<float*>(smem + lay.delta);

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ksteps = dpad / 16;
  const int q_valid = min(kBQ, p.n - q0);

  load_tile(sQ, ldh, p.q + b * p.s[kQ] + h * p.s[kQ + 1] + q0 * p.s[kQ + 2], p.s[kQ + 2], kBQ, q_valid,
            p.d, dpad, p.vec);
  load_tile(sDO, ldh, p.dout + b * p.s[kDO] + h * p.s[kDO + 1] + q0 * p.s[kDO + 2], p.s[kDO + 2], kBQ,
            q_valid, p.d, dpad, p.vec);
  load_rows(sLse, sDelta, p, ((long long)b * p.heads + h) * p.n + q0, q_valid);
  for (int i = threadIdx.x; i < kBQ * ldo; i += kThreads) sAcc[i] = 0.0f;
  const bf16* kb = p.k + b * p.s[kK] + h * p.s[kK + 1];
  const bf16* vb = p.v + b * p.s[kV] + h * p.s[kV + 1];
  const float* biasb = p.bias ? p.bias + b * p.s[kBiasRow] : nullptr;

  for (int k0 = 0; k0 < p.m; k0 += kBK) {
    __syncthreads();  // the previous tile's dS K product is done with sK and sDS
    const int k_valid = min(kBK, p.m - k0);
    load_tile(sK, ldh, kb + k0 * p.s[kK + 2], p.s[kK + 2], kBK, k_valid, p.d, dpad, p.vec);
    load_tile(sV, ldh, vb + k0 * p.s[kV + 2], p.s[kV + 2], kBK, k_valid, p.d, dpad, p.vec);
    load_bias(sBias, biasb, k0, k_valid);
    __syncthreads();
    scores(sQ, sDO, sK, sV, sS, sDP, ldh, ksteps, warp);
    __syncthreads();

    // dS = P (dP - delta), one warp per row
    for (int r = warp; r < kBQ; r += kWarps) {
      const float l = sLse[r], dl = sDelta[r];
      for (int j = lane; j < kBK; j += 32) {
        const float pv = exp2f(sS[r * kLds + j] * p.scale_log2 + sBias[j] - l);
        sDS[r * kLdp + j] = __float2bfloat16(pv * (sDP[r * kLds + j] - dl));
      }
    }
    __syncthreads();

    // dQ += dS K, accumulating through shared memory
    for (int t = warp; t < (kBQ / 16) * ksteps; t += kWarps) {
      const int tr = t / ksteps, tc = t % ksteps;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, sAcc + tr * 16 * ldo + tc * 16, ldo, wmma::mem_row_major);
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, sDS + tr * 16 * kLdp + kk * 16, kLdp);
        wmma::load_matrix_sync(fb, sK + kk * 16 * ldh + tc * 16, ldh);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(sAcc + tr * 16 * ldo + tc * 16, acc, ldo, wmma::mem_row_major);
    }
  }
  __syncthreads();

  bf16* dqb = p.dq + b * p.s[kDQ] + h * p.s[kDQ + 1] + q0 * p.s[kDQ + 2];
  for (int i = threadIdx.x; i < q_valid * p.d; i += kThreads) {
    const int r = i / p.d, c = i % p.d;
    dqb[r * p.s[kDQ + 2] + c] = __float2bfloat16(sAcc[r * ldo + c] * p.scale);
  }
}

__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int dpad = p.dpad;
  const int ldh = dpad + 8, ldo = dpad + 4;
  const DkvSmem lay(dpad);
  bf16* sK = reinterpret_cast<bf16*>(smem + lay.k);
  bf16* sV = reinterpret_cast<bf16*>(smem + lay.v);
  bf16* sQ = reinterpret_cast<bf16*>(smem + lay.q);
  bf16* sDO = reinterpret_cast<bf16*>(smem + lay.dout);
  float* sS = reinterpret_cast<float*>(smem + lay.s);
  float* sDP = reinterpret_cast<float*>(smem + lay.dp);
  bf16* sP = reinterpret_cast<bf16*>(smem + lay.p);
  bf16* sDS = reinterpret_cast<bf16*>(smem + lay.ds);
  float* sDK = reinterpret_cast<float*>(smem + lay.dk);
  float* sDV = reinterpret_cast<float*>(smem + lay.dv);
  float* sBias = reinterpret_cast<float*>(smem + lay.bias);
  float* sLse = reinterpret_cast<float*>(smem + lay.lse);
  float* sDelta = reinterpret_cast<float*>(smem + lay.delta);
  float* sDB = reinterpret_cast<float*>(smem + lay.db);

  const int k0 = blockIdx.x * kBK, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ksteps = dpad / 16;
  const int k_valid = min(kBK, p.m - k0);

  load_tile(sK, ldh, p.k + b * p.s[kK] + h * p.s[kK + 1] + k0 * p.s[kK + 2], p.s[kK + 2], kBK, k_valid,
            p.d, dpad, p.vec);
  load_tile(sV, ldh, p.v + b * p.s[kV] + h * p.s[kV + 1] + k0 * p.s[kV + 2], p.s[kV + 2], kBK, k_valid,
            p.d, dpad, p.vec);
  load_bias(sBias, p.bias ? p.bias + b * p.s[kBiasRow] : nullptr, k0, k_valid);
  for (int i = threadIdx.x; i < kBK * ldo; i += kThreads) {
    sDK[i] = 0.0f;
    sDV[i] = 0.0f;
  }
  for (int j = threadIdx.x; j < kBK; j += kThreads) sDB[j] = 0.0f;
  const bf16* qb = p.q + b * p.s[kQ] + h * p.s[kQ + 1];
  const bf16* dob = p.dout + b * p.s[kDO] + h * p.s[kDO + 1];
  const long long rows = ((long long)b * p.heads + h) * p.n;
  constexpr int out_tiles = kBK / 16;

  for (int q0 = 0; q0 < p.n; q0 += kBQ) {
    __syncthreads();  // the previous tile's products and column sums are done
    const int q_valid = min(kBQ, p.n - q0);
    load_tile(sQ, ldh, qb + q0 * p.s[kQ + 2], p.s[kQ + 2], kBQ, q_valid, p.d, dpad, p.vec);
    load_tile(sDO, ldh, dob + q0 * p.s[kDO + 2], p.s[kDO + 2], kBQ, q_valid, p.d, dpad, p.vec);
    load_rows(sLse, sDelta, p, rows + q0, q_valid);
    __syncthreads();
    scores(sQ, sDO, sK, sV, sS, sDP, ldh, ksteps, warp);
    __syncthreads();

    // P and dS = P (dP - delta), one warp per row; the fp32 dS goes back
    // into sDP for the dbias column sums
    for (int r = warp; r < kBQ; r += kWarps) {
      const float l = sLse[r], dl = sDelta[r];
      for (int j = lane; j < kBK; j += 32) {
        const float pv = exp2f(sS[r * kLds + j] * p.scale_log2 + sBias[j] - l);
        const float ds = pv * (sDP[r * kLds + j] - dl);
        sP[r * kLdp + j] = __float2bfloat16(pv);
        sDS[r * kLdp + j] = __float2bfloat16(ds);
        sDP[r * kLds + j] = ds;
      }
    }
    __syncthreads();

    if (p.dbias) {  // column sums of dS in row order: the same sum every run
      for (int j = threadIdx.x; j < kBK; j += kThreads) {
        float acc = sDB[j];
        for (int r = 0; r < kBQ; ++r) acc += sDP[r * kLds + j];
        sDB[j] = acc;
      }
    }

    // dV += P^T dO and dK += dS^T Q: P^T and dS^T are P and dS read
    // column-major
    for (int t = warp; t < 2 * out_tiles * ksteps; t += kWarps) {
      const bool is_dk = t >= out_tiles * ksteps;
      const int tt = is_dk ? t - out_tiles * ksteps : t;
      const int tr = tt / ksteps, tc = tt % ksteps;
      const bf16* a = is_dk ? sDS : sP;
      const bf16* bm = is_dk ? sQ : sDO;
      float* out = (is_dk ? sDK : sDV) + tr * 16 * ldo + tc * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, out, ldo, wmma::mem_row_major);
      for (int kk = 0; kk < kBQ / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, a + kk * 16 * kLdp + tr * 16, kLdp);
        wmma::load_matrix_sync(fb, bm + kk * 16 * ldh + tc * 16, ldh);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(out, acc, ldo, wmma::mem_row_major);
    }
  }
  __syncthreads();

  bf16* dkb = p.dk + b * p.s[kDK] + h * p.s[kDK + 1] + k0 * p.s[kDK + 2];
  bf16* dvb = p.dv + b * p.s[kDV] + h * p.s[kDV + 1] + k0 * p.s[kDV + 2];
  for (int i = threadIdx.x; i < k_valid * p.d; i += kThreads) {
    const int r = i / p.d, c = i % p.d;
    dkb[r * p.s[kDK + 2] + c] = __float2bfloat16(sDK[r * ldo + c] * p.scale);
    dvb[r * p.s[kDV + 2] + c] = __float2bfloat16(sDV[r * ldo + c]);
  }
  if (p.dbias) {
    float* dbb = p.dbias + ((long long)b * p.heads + h) * p.m + k0;
    for (int j = threadIdx.x; j < k_valid; j += kThreads) dbb[j] = sDB[j];
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, int tiles, int heads, int batch,
                   const Params& p, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(tiles, heads, batch), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

Params make_params(const void* q, const void* k, const void* v, const void* dout,
                   const float* bias, const float* lse, const float* delta, int heads, int n,
                   int m, int d, const long long* strides, float scale, int vec) {
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.dout = static_cast<const bf16*>(dout);
  p.bias = bias;
  p.lse = lse;
  p.delta = delta;
  p.dq = p.dk = p.dv = nullptr;
  p.dbias = nullptr;
  p.heads = heads;
  p.n = n;
  p.m = m;
  p.d = d;
  p.dpad = (d + 15) / 16 * 16;
  for (int i = 0; i < kStrides; ++i) p.s[i] = strides[i];
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  p.vec = vec;
  return p;
}

bool bad_dims(int batch, int heads, int n, int m, int d) {
  return d < 1 || d > kMaxDpad || n < 1 || m < 1 || batch < 1 || heads < 1;
}

}  // namespace

// Plain C entry points for ctypes.  Each returns a cudaError_t (0 =
// launched).  Strides are in elements, kStrides of them in the order of the
// enum above (the unused output's may be 0).  The caller checks shapes,
// dtypes and devices, and computes delta.
extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                                 const float* bias, const float* lse, const float* delta,
                                 void* dq, int batch, int heads, int n, int m, int d,
                                 const long long* strides, float scale, int vec, void* stream) {
  if (bad_dims(batch, heads, n, m, d)) return (int)cudaErrorInvalidValue;
  Params p = make_params(q, k, v, dout, bias, lse, delta, heads, n, m, d, strides, scale, vec);
  p.dq = static_cast<bf16*>(dq);
  return (int)launch(flash_bwd_dq_kernel, DqSmem(p.dpad).total, (n + kBQ - 1) / kBQ, heads,
                     batch, p, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                                  const float* bias, const float* lse, const float* delta,
                                  void* dk, void* dv, float* dbias, int batch, int heads, int n,
                                  int m, int d, const long long* strides, float scale, int vec,
                                  void* stream) {
  if (bad_dims(batch, heads, n, m, d)) return (int)cudaErrorInvalidValue;
  Params p = make_params(q, k, v, dout, bias, lse, delta, heads, n, m, d, strides, scale, vec);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.dbias = dbias;
  return (int)launch(flash_bwd_dkv_kernel, DkvSmem(p.dpad).total, (m + kBK - 1) / kBK, heads,
                     batch, p, static_cast<cudaStream_t>(stream));
}
