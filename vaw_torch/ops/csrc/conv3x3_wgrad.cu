// Filter gradient of the stride-1, pad-1 3x3 convolution over NHWC images:
// dw[dy, dx, ci, co] = sum over every pixel (n, oh, ow) of
// x[n, oh + dy - 1, ow + dx - 1, ci] * g[n, oh, ow, co], zero outside x.
//
// Replaces vaw_tpu/ops/conv2d.py:_wgrad_kernel (conv3x3_wgrad_pallas).
// Contract:
//   x  [N, H, W, Cin], g [N, H, W, Cout], contiguous, one dtype (bf16 or
//      f32).
//   ws [S, 9*Cin, Cout] f32 workspace, S = vaw_conv3x3_wgrad_splits(...).
//   dw [3, 3, Cin, Cout] in x's dtype: f32 sums, rounded once.
// The GEMM: M = 9*Cin rows (tap-major, m = (3*dy + dx)*Cin + ci), N = Cout,
// K = N*H*W pixels.
//
// Bound. At the ADM-64 training shape (N = 64, 64x64 pixels, 192 -> 192
// channels, bf16) a call does 2*9*Cin*Cout*N*H*W = 173.9 GFLOP, 0.176 ms
// at the bf16 tensor-core peak of 989 TFLOP/s, against 201.3 MB of x and g
// (0.060 ms at 3.35 TB/s): it is bound by operations.
//
// Design. The TPU kernel walks the grid in order on one core and adds every
// spatial tile's product into one f32 output block that stays in VMEM. On
// the card blocks run in parallel and in no order, and one 128 x 64 output
// tile a block gives only 42 blocks at 192 -> 192, a third of the 132 SMs.
// So the pixels (K) are split over S blocks per output tile (S chosen from
// the shape alone, about four blocks an SM in all); each block writes its
// f32 partial tile to the workspace, and a second kernel adds the S
// partials in a fixed order and rounds once. No atomics: the result does not
// change from run to run.
// bf16: four warps, 32 rows x 64 channels each, on the tensor cores
// (mma.sync m16n8k16). Both operands arrive pixel-major, [k][m] and [k][n],
// transposed against the mma.sync fragments, so both come from shared
// memory through ldmatrix .trans. A 16-byte chunk of the A tile is 8
// neighbouring channels of one tap of one pixel (Cin % 8 == 0), one
// cp.async zero-filled outside the image; three stages keep two tiles in
// flight. Cin or Cout not a multiple of 8 copies that operand one value at a
// time instead.
// f32: plain FMAs, 256 threads each owning a TM x TN block of the partial
// tile; 128 x 64 tiles, or 256 x 8 when Cout <= 8 (the 3-channel head).

#include "flash_common.cuh"

namespace {

using namespace vaw_flash;
using bf16 = __nv_bfloat16;

struct WgradGeom {
  int h, w, cin, cout;
  int m;       // rows of dw, 9*Cin
  int pixels;  // N*H*W
  int chunk;   // pixels of one split, a multiple of kSplitAlign
};

constexpr int kTargetBlocks = 4 * 132;  // about four blocks on each of the 132 SMs
constexpr int kSplitAlign = 32;
constexpr int kMinSplitPixels = 512;

// ------------------------------------------------------------------ bf16
constexpr int kBM = 128;
constexpr int kBN = 64;
constexpr int kBK = 32;    // pixels of a stage
constexpr int kStages = 3;
constexpr int kThreads = 128;
constexpr int kLDA = kBM + 8;  // 272-byte rows: ldmatrix .trans without bank conflicts
constexpr int kLDB = kBN + 8;  // 144-byte rows
constexpr int kAChunks = kBM / 8;                  // 16-byte chunks of an A row: 16
constexpr int kARowStep = kThreads / kAChunks;     // 8
constexpr int kBChunks = kBN / 8;                  // 8
constexpr int kBRowStep = kThreads / kBChunks;     // 16

template <bool VEC_A, bool VEC_B>
__global__ void __launch_bounds__(kThreads)
conv3x3_wgrad_bf16(const bf16* __restrict__ x, const bf16* __restrict__ gr,
                   float* __restrict__ ws, WgradGeom g) {
  __shared__ __align__(16) bf16 As[kStages][kBK][kLDA];  // [pixel][row of dw]
  __shared__ __align__(16) bf16 Bs[kStages][kBK][kLDB];  // [pixel][channel]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int quad = lane / 4;
  const int pair = lane % 4;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int split = blockIdx.z;
  const int p_begin = split * g.chunk;
  const int p_end = min(p_begin + g.chunk, g.pixels);
  const int ktiles = (p_end - p_begin + kBK - 1) / kBK;

  // This thread's A chunk: rows m .. m + 7 of dw, one tap when Cin % 8 == 0.
  const int a_chunk = tid % kAChunks;
  const int a_row0 = tid / kAChunks;
  const int am = m0 + a_chunk * 8;
  const bool am_ok = am < g.m;
  const int a_tap = am_ok ? am / g.cin : 0;
  const int a_ci = am - a_tap * g.cin;
  const int a_dy = a_tap / 3 - 1;
  const int a_dx = a_tap % 3 - 1;
  const long long a_shift = ((long long)a_dy * g.w + a_dx) * g.cin + a_ci;
  const int b_chunk = tid % kBChunks;
  const int b_row0 = tid / kBChunks;
  const int bn = n0 + b_chunk * 8;

  auto load_tile = [&](int stage, int kt) {
    // The A rows of this thread are pixels p, p + 8, p + 16, p + 24.
    const int p0 = p_begin + kt * kBK + a_row0;
    int ow = p0 % g.w;
    int oh = (p0 / g.w) % g.h;
#pragma unroll
    for (int i = 0; i < kBK / kARowStep; ++i) {
      const int r = a_row0 + kARowStep * i;
      const int p = p0 + kARowStep * i;
      if (i > 0) {
        ow += kARowStep;
        while (ow >= g.w) {
          ow -= g.w;
          if (++oh == g.h) oh = 0;
        }
      }
      const bool p_ok = p < p_end;
      if (VEC_A) {
        const int ih = oh + a_dy;
        const int iw = ow + a_dx;
        const bool ok = am_ok && p_ok && (unsigned)ih < (unsigned)g.h &&
                        (unsigned)iw < (unsigned)g.w;
        const bf16* src = ok ? x + (long long)p * g.cin + a_shift : x;
        cp_async_16(&As[stage][r][a_chunk * 8], src, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int mm = am + e;
          bf16 v = __float2bfloat16_rn(0.f);
          if (mm < g.m && p_ok) {
            const int tap = mm / g.cin;
            const int ci = mm - tap * g.cin;
            const int dy = tap / 3 - 1;
            const int dx = tap % 3 - 1;
            const int ih = oh + dy;
            const int iw = ow + dx;
            if ((unsigned)ih < (unsigned)g.h && (unsigned)iw < (unsigned)g.w) {
              v = x[((long long)p + (long long)dy * g.w + dx) * g.cin + ci];
            }
          }
          As[stage][r][a_chunk * 8 + e] = v;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kBK / kBRowStep; ++j) {
      const int r = b_row0 + kBRowStep * j;
      const int p = p_begin + kt * kBK + r;
      const bool p_ok = p < p_end;
      if (VEC_B) {
        const bool ok = p_ok && bn < g.cout;
        const bf16* src = ok ? gr + (long long)p * g.cout + bn : gr;
        cp_async_16(&Bs[stage][r][b_chunk * 8], src, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int co = bn + e;
          Bs[stage][r][b_chunk * 8 + e] = (p_ok && co < g.cout)
                                              ? gr[(long long)p * g.cout + co]
                                              : __float2bfloat16_rn(0.f);
        }
      }
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
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < ktiles) load_tile(next % kStages, next);
    cp_async_commit();
    const int stage = kt % kStages;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        load_a_trans<kLDA>(a[mi], As[stage], warp * 32 + mi * 16, kk, lane);
      }
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        // b[0], b[1]: n-tile 2*nj (k 0-7, 8-15); b[2], b[3]: n-tile 2*nj + 1.
        uint32_t b[4];
        ldmatrix_x4_trans(b, &Bs[stage][kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)]
                               [nj * 16 + (lane >> 4) * 8]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_16816(acc[mi][2 * nj], a[mi], b[0], b[1]);
          mma_16816(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  float* part = ws + (long long)split * g.m * g.cout;
  const bool even = g.cout % 2 == 0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = m0 + warp * 32 + mi * 16 + quad + 8 * r;
      if (m >= g.m) continue;
      float* row = part + (long long)m * g.cout;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int col = n0 + ni * 8 + 2 * pair;
        const float v0 = acc[mi][ni][2 * r];
        const float v1 = acc[mi][ni][2 * r + 1];
        if (even) {
          if (col < g.cout) *reinterpret_cast<float2*>(row + col) = make_float2(v0, v1);
        } else {
          if (col < g.cout) row[col] = v0;
          if (col + 1 < g.cout) row[col + 1] = v1;
        }
      }
    }
  }
}

// ------------------------------------------------------------------- f32
constexpr int kFmaThreads32 = 256;
constexpr int kFmaBK = 16;  // pixels of a step

template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kFmaThreads32)
conv3x3_wgrad_f32(const float* __restrict__ x, const float* __restrict__ gr,
                  float* __restrict__ ws, WgradGeom g) {
  static_assert((BM / TM) * (BN / TN) == kFmaThreads32, "one output block a thread");
  static_assert(TM % 4 == 0, "A rows are read as float4");
  __shared__ __align__(16) float As[kFmaBK][BM + 4];  // [pixel][row of dw]
  __shared__ __align__(16) float Bs[kFmaBK][BN + 4];  // [pixel][channel]

  const int tid = threadIdx.x;
  const int tn = tid % (BN / TN);
  const int tm = tid / (BN / TN);
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int split = blockIdx.z;
  const int p_begin = split * g.chunk;
  const int p_end = min(p_begin + g.chunk, g.pixels);
  const bool vec_a = g.cin % 4 == 0;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = p_begin; k0 < p_end; k0 += kFmaBK) {
    // A: 4 neighbouring rows of dw (channels of one tap) a load when
    // Cin % 4 == 0, else one value.
    const int per = vec_a ? 4 : 1;
    for (int idx = tid; idx < kFmaBK * (BM / per); idx += kFmaThreads32) {
      const int r = idx / (BM / per);
      const int mm = (idx % (BM / per)) * per;
      const int p = k0 + r;
      const int m = m0 + mm;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (p < p_end) {
        const int ow = p % g.w;
        const int oh = (p / g.w) % g.h;
        for (int e = 0; e < per; ++e) {
          if (m + e >= g.m) break;
          const int tap = (m + e) / g.cin;
          const int ci = m + e - tap * g.cin;
          const int dy = tap / 3 - 1;
          const int dx = tap % 3 - 1;
          const int ih = oh + dy;
          const int iw = ow + dx;
          if ((unsigned)ih >= (unsigned)g.h || (unsigned)iw >= (unsigned)g.w) continue;
          const float* src = x + ((long long)p + (long long)dy * g.w + dx) * g.cin + ci;
          if (vec_a) {
            const float4 q = *reinterpret_cast<const float4*>(src);
            v[0] = q.x;
            v[1] = q.y;
            v[2] = q.z;
            v[3] = q.w;
            break;
          }
          v[e] = *src;
        }
      }
      for (int e = 0; e < per; ++e) As[r][mm + e] = v[e];
    }
    for (int idx = tid; idx < kFmaBK * BN; idx += kFmaThreads32) {
      const int r = idx / BN;
      const int nn = idx % BN;
      const int p = k0 + r;
      const int co = n0 + nn;
      Bs[r][nn] = (p < p_end && co < g.cout) ? gr[(long long)p * g.cout + co] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFmaBK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; i += 4) {
        const float4 q = *reinterpret_cast<const float4*>(&As[kk][tm * TM + i]);
        a[i] = q.x;
        a[i + 1] = q.y;
        a[i + 2] = q.z;
        a[i + 3] = q.w;
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

  float* part = ws + (long long)split * g.m * g.cout;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + tm * TM + i;
    if (m >= g.m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int co = n0 + tn * TN + j;
      if (co < g.cout) part[(long long)m * g.cout + co] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------- reduce
// dw[i] = sum of the S partials at i, in split order, rounded once.
template <typename T>
__global__ void conv3x3_wgrad_reduce(const float* __restrict__ ws, T* __restrict__ dw,
                                     int count, int splits) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < count; i += stride) {
    float s = 0.f;
    for (int sp = 0; sp < splits; ++sp) s += ws[(long long)sp * count + i];
    if constexpr (sizeof(T) == 2) {
      dw[i] = __float2bfloat16_rn(s);
    } else {
      dw[i] = s;
    }
  }
}

// Output tiles of the GEMM for this shape and dtype (the launch's tiling).
long long output_tiles(int cin, int cout, int is_bf16) {
  const long long m = 9LL * cin;
  if (!is_bf16 && cout <= 8) return ((m + 255) / 256) * ((cout + 7) / 8);
  return ((m + kBM - 1) / kBM) * ((cout + kBN - 1) / kBN);
}

// Splits of the pixels and pixels a split, from the shape alone: enough
// blocks for about four an SM, and at least kMinSplitPixels pixels a split.
// Returns the split count, 0 for a shape the kernels refuse.
int plan(int n, int h, int w, int cin, int cout, int is_bf16, int* chunk) {
  const long long pixels = (long long)n * h * w;
  if (n <= 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0 || pixels >= (1LL << 31) ||
      9LL * cin * cout >= (1LL << 31)) {
    return 0;
  }
  const long long tiles = output_tiles(cin, cout, is_bf16);
  long long splits = (kTargetBlocks + tiles - 1) / tiles;
  const long long most = pixels / kMinSplitPixels > 1 ? pixels / kMinSplitPixels : 1;
  if (splits > most) splits = most;
  long long per = (pixels + splits - 1) / splits;
  per = (per + kSplitAlign - 1) / kSplitAlign * kSplitAlign;
  *chunk = static_cast<int>(per);
  return static_cast<int>((pixels + per - 1) / per);
}

template <int BM, int BN, int TM, int TN>
void launch_f32(const void* x, const void* gr, float* ws, const WgradGeom& g, int splits,
                cudaStream_t stream) {
  const dim3 grid((g.m + BM - 1) / BM, (g.cout + BN - 1) / BN, splits);
  conv3x3_wgrad_f32<BM, BN, TM, TN><<<grid, kFmaThreads32, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(gr), ws, g);
}

}  // namespace

// The workspace's split count S for this shape and dtype (ws is
// [S, 9*Cin, Cout] f32); 0 for a shape the kernels refuse.
extern "C" int vaw_conv3x3_wgrad_splits(int n, int h, int w, int cin, int cout,
                                        int is_bf16) {
  int chunk = 0;
  return plan(n, h, w, cin, cout, is_bf16, &chunk);
}

// Plain C entry point for ctypes: dw = wgrad(x, g) through the workspace ws
// of `splits` partials (which must be vaw_conv3x3_wgrad_splits(...)).
// Launches the partial-sum kernel and the reduction on `stream`; returns
// cudaGetLastError() after them (0 on success). is_bf16 selects
// __nv_bfloat16 over float for x, g and dw.
extern "C" int vaw_conv3x3_wgrad(const void* x, const void* gr, void* ws, void* dw, int n,
                                 int h, int w, int cin, int cout, int splits, int is_bf16,
                                 void* stream) {
  int chunk = 0;
  const int want = plan(n, h, w, cin, cout, is_bf16, &chunk);
  if (want == 0 || splits != want) return static_cast<int>(cudaErrorInvalidValue);
  const WgradGeom g{h, w, cin, cout, 9 * cin, n * h * w, chunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(ws);
  if (!is_bf16) {
    if (cout <= 8) {
      launch_f32<256, 8, 4, 2>(x, gr, part, g, splits, s);
    } else {
      launch_f32<128, 64, 8, 4>(x, gr, part, g, splits, s);
    }
  } else {
    const dim3 grid((g.m + kBM - 1) / kBM, (cout + kBN - 1) / kBN, splits);
    const bf16* xb = static_cast<const bf16*>(x);
    const bf16* gb = static_cast<const bf16*>(gr);
    const bool va = cin % 8 == 0;
    const bool vb = cout % 8 == 0;
    if (va && vb) {
      conv3x3_wgrad_bf16<true, true><<<grid, kThreads, 0, s>>>(xb, gb, part, g);
    } else if (va) {
      conv3x3_wgrad_bf16<true, false><<<grid, kThreads, 0, s>>>(xb, gb, part, g);
    } else if (vb) {
      conv3x3_wgrad_bf16<false, true><<<grid, kThreads, 0, s>>>(xb, gb, part, g);
    } else {
      conv3x3_wgrad_bf16<false, false><<<grid, kThreads, 0, s>>>(xb, gb, part, g);
    }
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int count = g.m * cout;
  const int blocks = (count + 255) / 256 < 4096 ? (count + 255) / 256 : 4096;
  if (is_bf16) {
    conv3x3_wgrad_reduce<bf16><<<blocks, 256, 0, s>>>(part, static_cast<bf16*>(dw), count,
                                                      splits);
  } else {
    conv3x3_wgrad_reduce<float><<<blocks, 256, 0, s>>>(part, static_cast<float*>(dw), count,
                                                       splits);
  }
  return static_cast<int>(cudaGetLastError());
}
