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
// output pixels, N = F output channels, K = 9*C with k = (dy, dx, c), on
// the WMMA GEMM core of gemm_core.cuh: a block owns BM rows x 64
// columns (BM = 128 with 8 warps, or 64 with 4 warps when 128-row blocks
// would not give two blocks per SM), walks K in steps of 32 through shared
// memory, and each warp multiplies its 32 x 32 part with WMMA bf16 16x16x16
// (mma.sync) into fp32 fragments.  This file adds the A loader: a thread
// owns two tile rows (pixels) for the whole K loop, with their (b, y, x)
// worked out once; per K step it takes the tap and channel of its 8-wide
// chunk of k, reads the shifted pixel's 8 channels with one 16-byte load
// (C % 8 == 0, so a chunk never straddles two taps), applies x * a + v and
// SiLU in fp32 and rounds to bf16 into shared memory.  The B operand is the weight in (F, 3, 3, C) order,
// K-contiguous per output channel like nn.Linear's (F, K) in fused_proj.cu.
// Epilogue: + fp32 bias, + the residual in fp32 when given, one cast.
// W need not be a multiple of 8 (a TPU sublane rule the routing keeps); C and
// F must be multiples of 8 for the 16-byte loads and stores.
//
// What bounds it on the H100: the tensor cores.  64^2, 320 -> 320 at 4 UNet
// rows is 30.2 GFLOP (30.5 us at 989 TFLOP/s) over ~21 MB of activations (6 us
// at 3.35 TB/s); every 3x3 ResBlock conv of one 512^2 UNet call adds up to
// ~1.31 TFLOP, ~1.3 ms.  This first version is simple: WMMA, no wgmma, no
// TMA, no pipelined K loop, the GroupNorm affine re-applied to each operand
// chunk as it is loaded (9 times per input element) and one block per output
// tile, so at 8^2 (256 rows) a launch has only 40 blocks.  A pipelined K loop,
// wgmma on TMA-fed tiles and split-K at 8^2 are the levers for a perf_opt
// change; PERF.md has the measured times beside the plain version's.

#include "gemm_core.cuh"

using namespace gligen;

namespace {

struct Params {
  const bf16* x;      // (B, H, W, C)
  const float* a;     // (B, C) GroupNorm affine
  const float* v;     // (B, C)
  const bf16* w;      // (F, 3, 3, C) = (F, K) rows
  const float* bias;  // (F,)
  const bf16* res;    // (B, H, W, F) or null
  bf16* out;          // (B, H, W, F)
  int h, wd, c, f, m, k;
};

template <int BM>
__global__ void __launch_bounds__(BM * 2) conv3x3_kernel(const Params p) {
  typedef GemmTile<BM, 1> T;
  constexpr int kRows = BM * T::kChunks / T::kThreads;  // A-tile rows per thread (2)
  extern __shared__ __align__(128) unsigned char smem[];

  const int n0 = blockIdx.x * T::kBN;
  const int m0 = blockIdx.y * BM;
  const int hw = p.h * p.wd;

  // this thread's A-tile rows: chunk i = threadIdx.x + j * kThreads is row i / 4,
  // k offset (i % 4) * 8, the same offset for every j
  const int koff = (threadIdx.x % T::kChunks) * 8;
  int row[kRows], pb[kRows], py[kRows], px[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    row[j] = (threadIdx.x + j * T::kThreads) / T::kChunks;
    const int m = m0 + row[j];
    const int mm = m < p.m ? m : 0;
    pb[j] = mm / hw;
    const int rem = mm - pb[j] * hw;
    py[j] = m < p.m ? rem / p.wd : -4;  // -4: every tap of a row past M is outside the image
    px[j] = rem % p.wd;
  }

  // The A tile: per row, the shifted pixel's 8 channels of this thread's
  // chunk of k = (tap, channel), through the affine and SiLU, rounded to
  // bf16; 0 outside the image.
  T::product(smem, p.w, p.f, p.k, n0, [&](int k0, bf16* sA) {
    const int kc = k0 + koff;
    const int tap = kc < p.k ? kc / p.c : 9;  // 9: past K, no tap
    const int ch = kc - tap * p.c;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      const int yy = py[j] + dy, xx = px[j] + dx;
      if (tap < 9 && yy >= 0 && yy < p.h && xx >= 0 && xx < p.wd) {
        const long long pix = ((long long)pb[j] * p.h + yy) * p.wd + xx;
        float f[8], av[8], vv[8];
        unpack8(*reinterpret_cast<const uint4*>(p.x + pix * p.c + ch), f);
        load8f(p.a + (long long)pb[j] * p.c + ch, av);
        load8f(p.v + (long long)pb[j] * p.c + ch, vv);
#pragma unroll
        for (int i = 0; i < 8; ++i) f[i] = silu(f[i] * av[i] + vv[i]);
        u = pack8(f);
      }
      *reinterpret_cast<uint4*>(sA + row[j] * T::kLdt + koff) = u;
    }
  });

  // + fp32 bias, + the residual in fp32 when given, one cast
  T::epilogue(smem, min(BM, p.m - m0), n0, p.f, [&](int r, int n, const float* st) {
    const long long off = (long long)(m0 + r) * p.f + n;
    float y[8], b[8];
    load8f(p.bias + n, b);
#pragma unroll
    for (int j = 0; j < 8; ++j) y[j] = st[j] + b[j];
    if (p.res) {
      float x[8];
      unpack8(*reinterpret_cast<const uint4*>(p.res + off), x);
#pragma unroll
      for (int j = 0; j < 8; ++j) y[j] += x[j];
    }
    *reinterpret_cast<uint4*>(p.out + off) = pack8(y);
  });
}

template <int BM>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  typedef GemmTile<BM, 1> T;
  const dim3 grid((p.f + T::kBN - 1) / T::kBN, (p.m + BM - 1) / BM);
  return launch_with_smem(conv3x3_kernel<BM>, grid, T::kThreads, T::kBytes, stream, p);
}

}  // namespace

// Plain C entry point for ctypes.  Returns a cudaError_t (0 = launched).
// Every tensor is contiguous and 16-byte aligned; the caller checks shapes,
// dtypes and devices.  x (b, h, w, c) bf16; a, v (b, c) fp32; wt (f, 3, 3, c)
// bf16; bias (f,) fp32; res (b, h, w, f) bf16 or null; y (b, h, w, f) bf16.
extern "C" int gn_silu_conv3x3_bf16(const void* x, const float* a, const float* v, const void* wt,
                                    const float* bias, const void* res, void* y, int b, int h,
                                    int w, int c, int f, void* stream) {
  const long long m = (long long)b * h * w;
  if (b < 1 || h < 1 || w < 1 || c < 8 || c % 8 || f < 8 || f % 8 || m >= (1LL << 31) ||
      9LL * c >= (1LL << 31) || (m + 63) / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const bf16*>(x);
  p.a = a;
  p.v = v;
  p.w = static_cast<const bf16*>(wt);
  p.bias = bias;
  p.res = static_cast<const bf16*>(res);
  p.out = static_cast<bf16*>(y);
  p.h = h, p.wd = w, p.c = c, p.f = f, p.m = (int)m, p.k = 9 * c;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(wide_rows(m, (f + kGemmBN - 1) / kGemmBN) ? launch<128>(p, s) : launch<64>(p, s));
}
