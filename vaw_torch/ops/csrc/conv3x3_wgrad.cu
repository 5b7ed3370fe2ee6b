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
// the card blocks run in parallel and in no order, and there are few output
// tiles (9 at 192 -> 192 with 192 x 192 tiles), far fewer than the 132
// SMs. So the pixels (K) are split over S blocks per output tile (S chosen
// from the shape alone); each block writes its f32 partial tile to the
// workspace, and a second kernel adds the S partials in a fixed order and
// rounds once. No atomics: the result does not change from run to run.
// Three kernels, chosen by shape (vaw_torch/ops/conv2d.py:
// conv3x3_wgrad_design):
//
// wgmma (bf16, Cin % 64 == 0, Cout % 64 == 0: every ADM-64 wgrad but the
// stem's and the f32 head's), for Hopper:
// - Tile. Three 64-row slabs of dw (M = 9*Cin is tap-major, so a slab is 64
//   input channels of one tap and never straddles a tap) x BN output
//   channels (192, 128 or 64, the largest that divides Cout), one consumer
//   warpgroup a slab. The three slabs share each g tile.
// - K step: one TMA box of 64 output pixels (1 x 64 at W = 64, 2 x 32,
//   4 x 16, one 8 x 8 image; the caller's plan, conv2d.py:
//   conv3x3_wgrad_plan). Two 4-D tensor maps, over x (Cin, W, H, N) and g
//   (Cout, W, H, N), 64-channel inner boxes, 128-byte swizzle. A slab's x
//   box is read at the box corner shifted by its tap (dx - 1, dy - 1), so
//   TMA's zero fill outside each image is the pad of 1, as in
//   conv3x3_fwd.cu; g's box is read unshifted and a box past the image is
//   zeros in both. In shared memory both operands are pixel-major, channels
//   along the 128-byte row: the products read A and B MN-major
//   (wgmma.m64nBNk16 with imm-trans-a and imm-trans-b), with no transpose.
// - Pipeline. One producer warp keeps a ring of stages (x of the three
//   slabs and g, 48 KB at BN = 192) loading on mbarriers; the consumers
//   keep one group of products in flight behind the one being issued. A
//   step moves 48 KB from L2 for 2.4 M multiply-adds (49 a byte; the
//   forward's 128 x 192 tile does 39).
// - Split: the boxes are cut into S runs of the same length, S about
//   132 / tiles (one wave), and each block writes its three slabs'
//   partials from registers.
//
// mma.sync (bf16, other shapes: the 3-channel stem): four warps, 32 rows x
// 64 channels each, on the tensor cores (mma.sync m16n8k16), 128 x 64
// output tiles, S about four blocks an SM in all. Both operands arrive
// pixel-major, [k][m] and [k][n], transposed against the mma.sync
// fragments, so both come from shared memory through ldmatrix .trans. A
// 16-byte chunk of the A tile is 8 neighbouring channels of one tap of one
// pixel (Cin % 8 == 0), one cp.async zero-filled outside the image; three
// stages keep two tiles in flight. Cin or Cout not a multiple of 8 copies
// that operand one value at a time instead.
// f32: plain FMAs, 256 threads each owning a TM x TN block of the partial
// tile; 128 x 64 tiles, or 256 x 8 when Cout <= 8 (the 3-channel head).

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace vaw_flash;
using namespace vaw_hopper;
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

// ----------------------------------------------------------- bf16, wgmma
constexpr int kWgSlabs = 3;                      // 64-row slabs of dw a tile
constexpr int kWgConsumers = kWgSlabs * 128;     // one warpgroup a slab
constexpr int kWgThreads = kWgConsumers + 32;    // and one producer warp
constexpr int kWgPixels = 64;                    // pixels of a K step (a box)
constexpr uint32_t kBoxBytes = kWgPixels * kSwizzleRowBytes;  // 64 px x 64 channels

// The wgmma kernel's geometry: the images, the pixel box (images x rows x
// columns, 64 pixels), the output tiles (three slabs x BN channels) and the
// split of the boxes (`per` consecutive boxes a split).
struct WgGeom {
  int n, h, w, cin, cout;
  int bni, bh, bw;
  int boxes_w, boxes_h, boxes;
  int tiles_c, tiles;
  int per;
};

template <int BN>
constexpr int wg_stages() { return BN == 192 ? 4 : BN == 128 ? 5 : 6; }

// A ring of NS stages: the x boxes of the three slabs and BN / 64 g boxes.
// Every box is 8 KB, so each starts on the swizzle's 1024-byte period.
template <int BN, int NS>
struct WgSmem {
  bf16 x[NS][kWgSlabs][kWgPixels][64];
  bf16 g[NS][BN / 64][kWgPixels][64];
  uint64_t full[NS];
  uint64_t empty[NS];
};

template <int BN, int NS>
__global__ void __launch_bounds__(kWgThreads, 1)
conv3x3_wgrad_wgmma(const __grid_constant__ CUtensorMap x_map,
                    const __grid_constant__ CUtensorMap g_map, float* __restrict__ ws,
                    WgGeom g) {
  using Smem = WgSmem<BN, NS>;
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  const int tid = threadIdx.x;
  // Consecutive blocks take the same pixels for different output tiles, so
  // the boxes they load meet in L2.
  const int tile = blockIdx.x % g.tiles;
  const int split = blockIdx.x / g.tiles;
  const int m_tile = tile / g.tiles_c;
  const int co0 = (tile % g.tiles_c) * BN;
  const int box_begin = split * g.per;
  const int box_end = min(box_begin + g.per, g.boxes);

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kWgConsumers / 32);  // every consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kWgConsumers) {
    // The producer warp: one thread issues every load, up to NS stages
    // ahead of the consumers.
    if (tid == kWgConsumers) {
      prefetch_tensor_map(&x_map);
      prefetch_tensor_map(&g_map);
      // Each slab's tap shift and channel block.
      int sx[kWgSlabs], sy[kWgSlabs], sc[kWgSlabs];
#pragma unroll
      for (int s = 0; s < kWgSlabs; ++s) {
        const int m0 = 64 * (kWgSlabs * m_tile + s);
        const int tap = m0 / g.cin;
        sc[s] = m0 - tap * g.cin;
        sx[s] = tap % 3 - 1;
        sy[s] = tap / 3 - 1;
      }
      int it = 0;
      for (int box = box_begin; box < box_end; ++box, ++it) {
        const int w0 = (box % g.boxes_w) * g.bw;
        const int h0 = ((box / g.boxes_w) % g.boxes_h) * g.bh;
        const int n0 = (box / (g.boxes_w * g.boxes_h)) * g.bni;
        const int stage = it % NS;
        if (it >= NS) mbar_wait(&sm.empty[stage], (it / NS - 1) & 1);
        mbar_arrive_expect_tx(&sm.full[stage], (kWgSlabs + BN / 64) * kBoxBytes);
#pragma unroll
        for (int s = 0; s < kWgSlabs; ++s) {
          tma_load_4d(&sm.x[stage][s][0][0], &x_map, &sm.full[stage], sc[s], w0 + sx[s],
                      h0 + sy[s], n0);
        }
#pragma unroll
        for (int j = 0; j < BN / 64; ++j) {
          tma_load_4d(&sm.g[stage][j][0][0], &g_map, &sm.full[stage], co0 + 64 * j, w0, h0,
                      n0);
        }
      }
    }
    return;
  }

  const int wg = tid / 128;  // this warpgroup's slab
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int quad = lane / 4;
  const int pair = lane % 4;
  // One consumer warp's release of a stage.
  auto release = [&](int stage) {
    if (lane == 0) mbar_arrive(&sm.empty[stage]);
  };
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  const int steps = box_end - box_begin;
  for (int it = 0; it < steps; ++it) {
    const int stage = it % NS;
    mbar_wait(&sm.full[stage], (it / NS) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgPixels / 16; ++kk) {
      // 16 pixels a product: 16 rows of both tiles, 2048 bytes a step.
      const uint64_t da = desc_mn_major(&sm.x[stage][wg][16 * kk][0], kBoxBytes);
      const uint64_t db = desc_mn_major(&sm.g[stage][0][16 * kk][0], kBoxBytes);
      Wgmma<BN>::template ss<1, 1>(acc, da, db, 1);
    }
    wgmma_commit();
    // The previous step's products are done: release its stage.
    wgmma_wait<1>();
    fence_regs(acc);
    if (it > 0) release((it - 1) % NS);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (steps > 0) release((steps - 1) % NS);

  // The slab's partial tile, straight from the accumulators.
  const int m9 = 9 * g.cin;
  float* part = ws + ((long long)split * m9 + 64 * (kWgSlabs * m_tile + wg)) * g.cout + co0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float* row = part + (long long)(16 * warp + quad + 8 * r) * g.cout + 2 * pair;
#pragma unroll
    for (int c = 0; c < BN / 8; ++c) {
      *reinterpret_cast<float2*>(row + 8 * c) =
          make_float2(acc[4 * c + 2 * r], acc[4 * c + 2 * r + 1]);
    }
  }
}

template <int BN>
int launch_wgmma(const void* x, const void* gr, float* ws, const WgGeom& g, int splits,
                 cudaStream_t stream) {
  constexpr int NS = wg_stages<BN>();
  // x and g as (C, W, H, N): innermost first, strides in bytes.
  const uint64_t xdims[4] = {static_cast<uint64_t>(g.cin), static_cast<uint64_t>(g.w),
                             static_cast<uint64_t>(g.h), static_cast<uint64_t>(g.n)};
  const uint64_t xstrides[3] = {2ull * g.cin, 2ull * g.cin * g.w, 2ull * g.cin * g.w * g.h};
  const uint64_t gdims[4] = {static_cast<uint64_t>(g.cout), xdims[1], xdims[2], xdims[3]};
  const uint64_t gstrides[3] = {2ull * g.cout, 2ull * g.cout * g.w,
                                2ull * g.cout * g.w * g.h};
  const uint32_t box[4] = {64, static_cast<uint32_t>(g.bw), static_cast<uint32_t>(g.bh),
                           static_cast<uint32_t>(g.bni)};
  CUtensorMap x_map, g_map;
  if (!make_tensor_map(&x_map, x, 4, xdims, xstrides, box) ||
      !make_tensor_map(&g_map, gr, 4, gdims, gstrides, box)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = conv3x3_wgrad_wgmma<BN, NS>;
  const int smem = static_cast<int>(sizeof(WgSmem<BN, NS>)) + 1024;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<g.tiles * splits, kWgThreads, smem, stream>>>(x_map, g_map, ws, g);
  return static_cast<int>(cudaGetLastError());
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

// The fixed-order sum of the partials into dw, rounded once.
int launch_reduce(const float* ws, void* dw, int count, int splits, int is_bf16,
                  cudaStream_t stream) {
  const int blocks = (count + 255) / 256 < 4096 ? (count + 255) / 256 : 4096;
  if (is_bf16) {
    conv3x3_wgrad_reduce<bf16><<<blocks, 256, 0, stream>>>(ws, static_cast<bf16*>(dw),
                                                           count, splits);
  } else {
    conv3x3_wgrad_reduce<float><<<blocks, 256, 0, stream>>>(ws, static_cast<float*>(dw),
                                                            count, splits);
  }
  return static_cast<int>(cudaGetLastError());
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
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_reduce(part, dw, g.m * cout, splits, is_bf16, s);
}

// Plain C entry point of the wgmma kernel: dw = wgrad(x, g) in bf16 through
// the workspace ws [splits, 9*Cin, Cout] f32. Takes Cin % 64 == 0,
// Cout % bn == 0 with bn in {64, 128, 192}, a pixel box of bni images x bh
// rows x bw columns with bni * bh * bw == 64, and a split of the boxes into
// `splits` runs of `per` boxes (the last may be shorter, none empty): the
// plan vaw_torch/ops/conv2d.py:conv3x3_wgrad_plan makes from the shape.
// Launches the partial-sum kernel and the reduction on `stream`; returns
// cudaGetLastError() after them (0 on success), or cudaErrorInvalidValue
// for what it does not take.
extern "C" int vaw_conv3x3_wgrad_wgmma(const void* x, const void* gr, void* ws, void* dw,
                                       int n, int h, int w, int cin, int cout, int bni,
                                       int bh, int bw, int bn, int splits, int per,
                                       void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || cin <= 0 || cin % 64 != 0 || cout <= 0 ||
      (bn != 64 && bn != 128 && bn != 192) || cout % bn != 0 || bni <= 0 || bh <= 0 ||
      bw <= 0 || bni * bh * bw != kWgPixels || splits <= 0 || per <= 0 ||
      (long long)n * h * w * (cin > cout ? cin : cout) >= (1LL << 31) ||
      9LL * cin * cout * splits >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  WgGeom g{n, h, w, cin, cout, bni, bh, bw, 0, 0, 0, 0, 0, per};
  g.boxes_w = (w + bw - 1) / bw;
  g.boxes_h = (h + bh - 1) / bh;
  g.boxes = ((n + bni - 1) / bni) * g.boxes_h * g.boxes_w;
  g.tiles_c = cout / bn;
  g.tiles = 3 * (cin / 64) * g.tiles_c;
  // Every box in exactly one split, no split empty.
  if ((long long)(splits - 1) * per >= g.boxes || (long long)splits * per < g.boxes ||
      (long long)g.tiles * splits >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(ws);
  int err;
  if (bn == 192) {
    err = launch_wgmma<192>(x, gr, part, g, splits, s);
  } else if (bn == 128) {
    err = launch_wgmma<128>(x, gr, part, g, splits, s);
  } else {
    err = launch_wgmma<64>(x, gr, part, g, splits, s);
  }
  if (err != 0) return err;
  return launch_reduce(part, dw, 9 * cin * cout, splits, 1, s);
}
