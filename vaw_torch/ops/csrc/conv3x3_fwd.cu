// Stride-1, pad-1 3x3 convolution over NHWC images, forward (and, on the
// rotated filter, the input gradient): an implicit GEMM.
//
// Replaces vaw_tpu/ops/conv2d.py:_fwd_kernel (conv3x3_pallas). Contract:
//   x  [N, H, W, Cin] contiguous, bf16 or f32.
//   wk [Cout, Kpad] contiguous in x's dtype: row co holds w[dy, dx, ci, co]
//      at k = (3 * dy + dx) * Cin + ci, zeros for k >= 9 * Cin; Kpad % 8 == 0.
//   y  [N, H, W, Cout] contiguous in x's dtype: f32 sums, rounded once, no
//      bias.
// The GEMM: M = N*H*W output pixels, N = Cout, K = 9*Cin (tap-major).
//
// Bound. At the ADM-64 sampling shape (N = 128 with CFG, 64x64 pixels,
// 192 -> 192 channels, bf16) a call does 2*9*Cin*Cout*N*H*W = 347.9 GFLOP,
// 0.352 ms at the bf16 tensor-core peak of 989 TFLOP/s, against 402.7 MB of
// x and y (0.120 ms at 3.35 TB/s): it is bound by operations.
//
// Design. The TPU kernel pads x in device memory (one pixel of halo, Cin to
// 128, W + 2 to a multiple of 8), DMAs a (TH + 2)-row slab into VMEM and
// multiplies it by all nine taps at once, [(TH+2)*WP, Cin] x [Cin, 9*Cout],
// then adds the nine shifted slices: 9*(TH+2)*WP/(TH*W) times the useful
// work, laid out for the TPU's lanes. None of that carries over. Here a
// block owns 128 output pixels x 64 output channels and walks K in steps of
// 32. Each step gathers its A tile straight from the unpadded NHWC x: with
// Cin % 8 == 0 the 8 values of a 16-byte chunk share one tap, so a chunk is
// one cp.async whose source is the pixel shifted by that tap, zero-filled
// when the shifted pixel lies outside the image. The B tile is 16-byte
// copies of wk. Three stages of cp.async keep two tiles in flight while the
// third is multiplied.
// bf16: four warps, 32 pixels x 64 channels each, on the tensor cores
// (mma.sync m16n8k16, A and B fragments by ldmatrix from rows padded to 80
// bytes, which keeps ldmatrix free of bank conflicts), f32 accumulators,
// one rounding at the store. Cin % 8 != 0 (the 3-channel image at the stem)
// gathers A one value at a time instead.
// f32: plain FMAs, 256 threads each owning a TM x TN block of the output;
// 128 x 64 tiles, or 256 x 8 when Cout <= 8 (the 3-channel head).
// wgmma, TMA and a deeper pipeline are later work.

#include "flash_common.cuh"

namespace {

using namespace vaw_flash;
using bf16 = __nv_bfloat16;

struct ConvGeom {
  int n, h, w, cin, cout, kpad;
  int m;  // output pixels, N*H*W
};

// ------------------------------------------------------------------ bf16
constexpr int kBM = 128;   // output pixels of a block
constexpr int kBN = 64;    // output channels of a block
constexpr int kBK = 32;    // K of a stage
constexpr int kStages = 3;
constexpr int kThreads = 128;
constexpr int kLD = kBK + 8;                        // 80-byte smem rows
constexpr int kChunks = kBK / 8;                    // 16-byte chunks of a row
constexpr int kRowStep = kThreads / kChunks;        // 32
constexpr int kARows = kBM / kRowStep;              // A rows a thread copies: 4
constexpr int kBRows = kBN / kRowStep;              // B rows: 2

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
conv3x3_fwd_bf16(const bf16* __restrict__ x, const bf16* __restrict__ wk,
                 bf16* __restrict__ y, ConvGeom g) {
  __shared__ __align__(16) bf16 As[kStages][kBM][kLD];
  __shared__ __align__(16) bf16 Bs[kStages][kBN][kLD];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int quad = lane / 4;
  const int pair = lane % 4;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int kdim = 9 * g.cin;
  const int ktiles = (g.kpad + kBK - 1) / kBK;
  const int chunk = tid % kChunks;     // this thread's 8-wide K column
  const int row0 = tid / kChunks;      // and its first row, then every kRowStep

  // The output pixels of this thread's A rows, fixed over the K loop.
  int pix_oh[kARows], pix_ow[kARows];
  bool pix_ok[kARows];
#pragma unroll
  for (int i = 0; i < kARows; ++i) {
    const int m = m0 + row0 + kRowStep * i;
    pix_ok[i] = m < g.m;
    const int mm = pix_ok[i] ? m : 0;
    pix_ow[i] = mm % g.w;
    pix_oh[i] = (mm / g.w) % g.h;
  }

  auto load_tile = [&](int stage, int kt) {
    const int k = kt * kBK + chunk * 8;
    if (VEC) {
      // Cin % 8 == 0: the chunk's 8 values share one tap.
      const bool kok = k < kdim;
      const int tap = kok ? k / g.cin : 0;
      const int ci = k - tap * g.cin;
      const int dy = tap / 3 - 1;
      const int dx = tap % 3 - 1;
      const long long shift = ((long long)dy * g.w + dx) * g.cin + ci;
#pragma unroll
      for (int i = 0; i < kARows; ++i) {
        const int r = row0 + kRowStep * i;
        const int ih = pix_oh[i] + dy;
        const int iw = pix_ow[i] + dx;
        const bool ok = kok && pix_ok[i] && (unsigned)ih < (unsigned)g.h &&
                        (unsigned)iw < (unsigned)g.w;
        const bf16* src = ok ? x + (long long)(m0 + r) * g.cin + shift : x;
        cp_async_16(&As[stage][r][chunk * 8], src, ok);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kARows; ++i) {
        const int r = row0 + kRowStep * i;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int kk = k + e;
          bf16 v = __float2bfloat16_rn(0.f);
          if (kk < kdim && pix_ok[i]) {
            const int tap = kk / g.cin;
            const int ci = kk - tap * g.cin;
            const int dy = tap / 3 - 1;
            const int dx = tap % 3 - 1;
            const int ih = pix_oh[i] + dy;
            const int iw = pix_ow[i] + dx;
            if ((unsigned)ih < (unsigned)g.h && (unsigned)iw < (unsigned)g.w) {
              v = x[((long long)(m0 + r) + (long long)dy * g.w + dx) * g.cin + ci];
            }
          }
          As[stage][r][chunk * 8 + e] = v;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kBRows; ++j) {
      const int r = row0 + kRowStep * j;
      const int co = n0 + r;
      const bool ok = co < g.cout && k < g.kpad;
      const bf16* src = ok ? wk + (long long)co * g.kpad + k : wk;
      cp_async_16(&Bs[stage][r][chunk * 8], src, ok);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load_tile(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt is in; every warp is done with tile kt - 1
    const int next = kt + kStages - 1;
    if (next < ktiles) load_tile(next % kStages, next);
    cp_async_commit();
    const int stage = kt % kStages;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        ldmatrix_x4(a[mi], &As[stage][warp * 32 + mi * 16 + (lane & 15)]
                              [kk * 16 + (lane >> 4) * 8]);
      }
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        // b[0], b[1]: n-tile 2*nj (k 0-7, 8-15); b[2], b[3]: n-tile 2*nj + 1.
        uint32_t b[4];
        ldmatrix_x4(b, &Bs[stage][nj * 16 + (lane & 7) + ((lane >> 4) << 3)]
                         [kk * 16 + ((lane >> 3) & 1) * 8]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_16816(acc[mi][2 * nj], a[mi], b[0], b[1]);
          mma_16816(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const bool even = g.cout % 2 == 0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = m0 + warp * 32 + mi * 16 + quad + 8 * r;
      if (m >= g.m) continue;
      bf16* row = y + (long long)m * g.cout;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int col = n0 + ni * 8 + 2 * pair;
        const float v0 = acc[mi][ni][2 * r];
        const float v1 = acc[mi][ni][2 * r + 1];
        if (even) {
          if (col < g.cout) {
            *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(v0, v1);
          }
        } else {
          if (col < g.cout) row[col] = __float2bfloat16_rn(v0);
          if (col + 1 < g.cout) row[col + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

// ------------------------------------------------------------------- f32
constexpr int kFmaThreads32 = 256;
constexpr int kFmaBK = 16;

template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kFmaThreads32)
conv3x3_fwd_f32(const float* __restrict__ x, const float* __restrict__ wk,
                float* __restrict__ y, ConvGeom g) {
  static_assert((BM / TM) * (BN / TN) == kFmaThreads32, "one output block a thread");
  static_assert(TM % 4 == 0, "A rows are read as float4");
  __shared__ __align__(16) float As[kFmaBK][BM + 4];  // [k][pixel]
  __shared__ __align__(16) float Bs[kFmaBK][BN + 4];  // [k][channel]

  const int tid = threadIdx.x;
  const int tn = tid % (BN / TN);
  const int tm = tid / (BN / TN);
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int kdim = 9 * g.cin;
  const bool vec = g.cin % 4 == 0;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < kdim; k0 += kFmaBK) {
    if (vec) {
      // Four values of one tap a load: Cin % 4 == 0.
      for (int idx = tid; idx < BM * (kFmaBK / 4); idx += kFmaThreads32) {
        const int r = idx / (kFmaBK / 4);
        const int c4 = (idx % (kFmaBK / 4)) * 4;
        const int m = m0 + r;
        const int k = k0 + c4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (m < g.m && k < kdim) {
          const int tap = k / g.cin;
          const int ci = k - tap * g.cin;
          const int dy = tap / 3 - 1;
          const int dx = tap % 3 - 1;
          const int ih = (m / g.w) % g.h + dy;
          const int iw = m % g.w + dx;
          if ((unsigned)ih < (unsigned)g.h && (unsigned)iw < (unsigned)g.w) {
            v = *reinterpret_cast<const float4*>(
                x + ((long long)m + (long long)dy * g.w + dx) * g.cin + ci);
          }
        }
        As[c4][r] = v.x;
        As[c4 + 1][r] = v.y;
        As[c4 + 2][r] = v.z;
        As[c4 + 3][r] = v.w;
      }
    } else {
      for (int idx = tid; idx < BM * kFmaBK; idx += kFmaThreads32) {
        const int r = idx / kFmaBK;
        const int kk = idx % kFmaBK;
        const int m = m0 + r;
        const int k = k0 + kk;
        float v = 0.f;
        if (m < g.m && k < kdim) {
          const int tap = k / g.cin;
          const int ci = k - tap * g.cin;
          const int dy = tap / 3 - 1;
          const int dx = tap % 3 - 1;
          const int ih = (m / g.w) % g.h + dy;
          const int iw = m % g.w + dx;
          if ((unsigned)ih < (unsigned)g.h && (unsigned)iw < (unsigned)g.w) {
            v = x[((long long)m + (long long)dy * g.w + dx) * g.cin + ci];
          }
        }
        As[kk][r] = v;
      }
    }
    for (int idx = tid; idx < BN * kFmaBK; idx += kFmaThreads32) {
      const int kk = idx % kFmaBK;
      const int nn = idx / kFmaBK;
      const int co = n0 + nn;
      const int k = k0 + kk;
      Bs[kk][nn] = (co < g.cout && k < kdim) ? wk[(long long)co * g.kpad + k] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFmaBK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; i += 4) {
        const float4 v = *reinterpret_cast<const float4*>(&As[kk][tm * TM + i]);
        a[i] = v.x;
        a[i + 1] = v.y;
        a[i + 2] = v.z;
        a[i + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tn * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + tm * TM + i;
    if (m >= g.m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int co = n0 + tn * TN + j;
      if (co < g.cout) y[(long long)m * g.cout + co] = acc[i][j];
    }
  }
}

template <int BM, int BN, int TM, int TN>
int launch_f32(const void* x, const void* wk, void* y, const ConvGeom& g,
               cudaStream_t stream) {
  const dim3 grid((g.m + BM - 1) / BM, (g.cout + BN - 1) / BN);
  conv3x3_fwd_f32<BM, BN, TM, TN><<<grid, kFmaThreads32, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(wk),
      static_cast<float*>(y), g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes: y = conv3x3(x, w) with the filter laid out
// as wk (see the contract above). Launches on `stream` and returns
// cudaGetLastError() after the launch (0 on success). is_bf16 selects
// __nv_bfloat16 over float for x, wk and y.
extern "C" int vaw_conv3x3_fwd(const void* x, const void* wk, void* y, int n, int h,
                               int w, int cin, int cout, int kpad, int is_bf16,
                               void* stream) {
  const long long m = (long long)n * h * w;
  if (n <= 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0 || kpad < 9 * cin ||
      kpad % 8 != 0 || m >= (1LL << 31) || (m + kBM - 1) / kBM > 0x7fffffffLL ||
      (cout + kBN - 1) / kBN > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ConvGeom g{n, h, w, cin, cout, kpad, static_cast<int>(m)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) {
    if (cout <= 8) return launch_f32<256, 8, 4, 2>(x, wk, y, g, s);
    return launch_f32<128, 64, 8, 4>(x, wk, y, g, s);
  }
  const dim3 grid((g.m + kBM - 1) / kBM, (cout + kBN - 1) / kBN);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(wk);
  bf16* yb = static_cast<bf16*>(y);
  if (cin % 8 == 0) {
    conv3x3_fwd_bf16<true><<<grid, kThreads, 0, s>>>(xb, wb, yb, g);
  } else {
    conv3x3_fwd_bf16<false><<<grid, kThreads, 0, s>>>(xb, wb, yb, g);
  }
  return static_cast<int>(cudaGetLastError());
}
