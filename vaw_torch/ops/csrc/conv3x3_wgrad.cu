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
// Four kernels, chosen by shape and dtype (vaw_torch/ops/conv2d.py:
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
// tf32x3 (f32, Cin % 64 == 0, Cout % 64 == 0: ADM-64's f32 wgrads but the
// stem's and the head's), for Hopper's tensor cores. Bound: at ADM-64's f32
// training batch (64, 64 x 64, 192 -> 192) the 173.9 GFLOP as three TF32
// passes at 495 TFLOP/s take 1.054 ms, against 2.596 ms on plain FMAs at 67
// TFLOP/s and 0.120 ms for x and g's 402.7 MB: bound by operations.
// - Each f32 product as three TF32 passes (3xTF32): x = hi + lo with hi
//   rounded to TF32 (hopper_common.cuh:tf32_hi) and lo = x - hi rounded in
//   turn; lo.hi + hi.lo + hi.hi misses a product by about 2^-22 of it (the
//   lo.lo term), where one TF32 pass misses it by up to 2^-11.
// - The wgmma kernel's tiles (three 64-row slabs by BN = 96 or 64 output
//   channels) and split (conv2d.py:conv3x3_wgrad_plan with "tf32x3"), on
//   32-pixel K steps: an f32 tile row of 128 bytes holds 32 channels, and
//   a 64-pixel step would leave room for one stage beside the split.
// - TF32 wgmma reads shared-memory operands K-major only, and TMA lands x
//   and g pixel-major. x enters as the A operand from registers (each
//   consumer thread reads its fragment values from the swizzled tile and
//   splits them); three splitter warps of a producer warpgroup write g^T's
//   hi and lo halves (channels as rows, the step's pixels along them) once a
//   step for the three slabs, into one of two buffers, while one thread
//   keeps NS stages of TMA loads in flight; setmaxnreg moves registers from
//   the producer warpgroup (56 a thread) to the consumers (152).
// - The tensor core's f32 sums cover one step (12 products a slab): each
//   step's accumulator is added to running sums in registers, so the
//   thousands of pixels of a split are summed with round-to-nearest adds.
// f32 otherwise: plain FMAs, 256 threads each owning a TM x TN block of the
// partial tile; 128 x 64 tiles, or 256 x 8 when Cout <= 8 (the 3-channel
// head).

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

// ------------------------------------------------------------ f32, 3xTF32
constexpr int kTfPixels = 32;                                // pixels of a K step (a box)
constexpr uint32_t kTfBox = kTfPixels * kSwizzleRowBytes;    // 32 px x 32 f32 channels
constexpr int kTfSplitters = 96;                             // warps 1-3 of the producer warpgroup
constexpr int kTfThreads = kWgConsumers + 128;               // and the producer warpgroup
// Registers a thread keeps after setmaxnreg: the producer warpgroup (an
// address and one 16-byte vector) gives to the three consumer warpgroups
// (the product's accumulator, the running sums and x's fragments);
// 56 + 3 * 152 = 4 * 128, the 128 a thread that 512 threads get at launch.
constexpr int kTfProducerRegs = 56;
constexpr int kTfConsumerRegs = 152;
constexpr int kTfSmemBudget = 232448 - 1024 - 256;  // less the alignment and barriers

// A ring of NS stages of what TMA lands (x of the three slabs, each 64
// channels in two 32-channel boxes; g in BN / 32 boxes), and two buffers of
// g^T's hi and lo halves, written by the splitter warps: row co, the step's
// 32 pixels along it in the order of x's A fragments. Every tile is 128-byte
// rows, 128-byte swizzled, a multiple of 4096 bytes.
template <int BN, int NS>
struct TfSmem {
  float x[NS][kWgSlabs][2][kTfPixels][32];
  float g[NS][BN / 32][kTfPixels][32];
  float gt[2][BN][32];
  float gt_lo[2][BN][32];
  uint64_t full[NS];
  uint64_t empty[NS];
  uint64_t split_full[2];
  uint64_t split_empty[2];
};

// Stages that fit beside the split buffers, at most 4.
template <int BN>
constexpr int tf_stages() {
  constexpr int fixed = 2 * 2 * BN * 32 * 4;
  constexpr int room = (kTfSmemBudget - fixed) / ((2 * kWgSlabs + BN / 32) * kTfBox);
  return room > 4 ? 4 : room;
}

// k steps of x's fragments loaded at a time: two at BN = 96, where four
// (32 registers) beside the accumulator and the running sums spilled more
// and ran slower; four at BN = 64, where two ran slower (build-time
// variants on the card, whose numbers are not kept).
template <int BN>
__host__ __device__ constexpr int tf_frag_steps() { return BN == 96 ? 2 : 4; }

// The 3xTF32 wgrad: the wgmma kernel's tiles (three 64-row slabs of dw, one
// consumer warpgroup a slab, by BN output channels) and split, on 32-pixel
// K steps. A step's product is x^T g over its 32 pixels: TF32 wgmma reads
// shared-memory operands K-major only, and TMA lands both pixel-major, so
// x enters as the A operand from registers (each thread reads its fragment
// values from the swizzled tile and splits them, hi = tf32_hi, lo =
// tf32_lo) and g as the B operand from g^T's halves, which three splitter
// warps write once a step for all slabs. Fragment column j of an 8-pixel
// k step holds pixel 2j (j < 4) or 2(j - 4) + 1, so the fragment reads are
// free of bank conflicts; g^T holds each 8-pixel group in the same order.
// x's stage is released once its fragments are in registers, g^T's buffer
// once the step's products are in.
// Each product is lo.hi + hi.lo + hi.hi. The tensor core's f32 sums run
// over one step only (12 products): each step's accumulator is added into
// running f32 sums in registers, so the sum over a split's thousands of
// pixels is taken with the FMA pipes' rounding to nearest. Summed in the
// accumulator over a whole split (a build-time variant on the card), the
// error grew with the pixels a block sums and passed WGRAD_RTOL at
// ADM-64's training batch: the tensor core's own f32 sums drift over
// thousands of additions.
template <int BN, int NS>
__global__ void __launch_bounds__(kTfThreads, 1)
conv3x3_wgrad_tf32x3(const __grid_constant__ CUtensorMap x_map,
                     const __grid_constant__ CUtensorMap g_map, float* __restrict__ ws,
                     WgGeom g) {
  static_assert(NS >= 2, "two stages at least");
  constexpr int KH = tf_frag_steps<BN>();
  using Smem = TfSmem<BN, NS>;
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  const int tid = threadIdx.x;
  const int tile = blockIdx.x % g.tiles;
  const int split = blockIdx.x / g.tiles;
  const int m_tile = tile / g.tiles_c;
  const int co0 = (tile % g.tiles_c) * BN;
  const int box_begin = split * g.per;
  const int box_end = min(box_begin + g.per, g.boxes);
  const int steps = box_end - box_begin;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kWgConsumers + kTfSplitters);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mbar_init(&sm.split_full[i], kTfSplitters);
      mbar_init(&sm.split_empty[i], kWgConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kWgConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kTfProducerRegs));
    const int pt = tid - kWgConsumers;
    if (pt == 0) {
      // One thread issues every load, up to NS stages ahead.
      prefetch_tensor_map(&x_map);
      prefetch_tensor_map(&g_map);
      int sx[kWgSlabs], sy[kWgSlabs], sc[kWgSlabs];
#pragma unroll
      for (int s = 0; s < kWgSlabs; ++s) {
        const int m0 = 64 * (kWgSlabs * m_tile + s);
        const int tap = m0 / g.cin;
        sc[s] = m0 - tap * g.cin;
        sx[s] = tap % 3 - 1;
        sy[s] = tap / 3 - 1;
      }
      for (int it = 0; it < steps; ++it) {
        const int box = box_begin + it;
        const int w0 = (box % g.boxes_w) * g.bw;
        const int h0 = ((box / g.boxes_w) % g.boxes_h) * g.bh;
        const int n0 = (box / (g.boxes_w * g.boxes_h)) * g.bni;
        const int stage = it % NS;
        if (it >= NS) mbar_wait(&sm.empty[stage], (it / NS - 1) & 1);
        mbar_arrive_expect_tx(&sm.full[stage], (2 * kWgSlabs + BN / 32) * kTfBox);
#pragma unroll
        for (int s = 0; s < kWgSlabs; ++s) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            tma_load_4d(&sm.x[stage][s][half][0][0], &x_map, &sm.full[stage],
                        sc[s] + 32 * half, w0 + sx[s], h0 + sy[s], n0);
          }
        }
#pragma unroll
        for (int j = 0; j < BN / 32; ++j) {
          tma_load_4d(&sm.g[stage][j][0][0], &g_map, &sm.full[stage], co0 + 32 * j, w0, h0,
                      n0);
        }
      }
    } else if (pt >= 32) {
      // A splitter: a warp takes the step's 32 pixels (one a lane) by 4
      // channels: one 16-byte read of the pixel's row, four 4-byte writes of
      // each half at the pixel's place in rows co .. co + 3 (both free of
      // bank conflicts under the swizzle).
      const int st = pt - 32;
      const int lane = st % 32;
      const int pos = 8 * (lane / 8) + 4 * (lane & 1) + (lane % 8) / 2;
      for (int it = 0; it < steps; ++it) {
        const int stage = it % NS;
        const int db = it & 1;
        mbar_wait(&sm.full[stage], (it / NS) & 1);
        if (it >= 2) mbar_wait(&sm.split_empty[db], ((it >> 1) - 1) & 1);
        uint8_t* hi = reinterpret_cast<uint8_t*>(&sm.gt[db][0][0]);
        uint8_t* lo = reinterpret_cast<uint8_t*>(&sm.gt_lo[db][0][0]);
        for (int c4 = st / 32; c4 < BN / 4; c4 += kTfSplitters / 32) {
          const float4 v = *reinterpret_cast<const float4*>(
              reinterpret_cast<const uint8_t*>(&sm.g[stage][c4 / 8][0][0]) +
              swizzled<128>(lane, c4 % 8));
          const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint32_t at = swizzled<128>(4 * c4 + e, pos / 4) + 4 * (pos % 4);
            *reinterpret_cast<float*>(hi + at) = tf32_hi(vs[e]);
            *reinterpret_cast<float*>(lo + at) = tf32_lo(vs[e]);
          }
        }
        fence_proxy_async();  // the writes, before the consumers' wgmma reads
        mbar_arrive(&sm.split_full[db]);
        mbar_arrive(&sm.empty[stage]);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kTfConsumerRegs));
  const int wg = tid / 128;  // this warpgroup's slab
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int quad = lane / 4;
  const int pair = lane % 4;
  float acc[BN / 2], sum[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sum[i] = 0.f;
  for (int it = 0; it < steps; ++it) {
    const int stage = it % NS;
    const int db = it & 1;
    mbar_wait(&sm.full[stage], (it / NS) & 1);
    mbar_wait(&sm.split_full[db], (it >> 1) & 1);
    // x's A fragments, KH of the step's four k steps at a time: rows
    // (channels of the slab) 16 warp + quad (+ 8), columns (pixels) 8 kk +
    // 2 pair (+ 1); each group's products are waited for before the next
    // group's fragments are loaded.
#pragma unroll
    for (int k0 = 0; k0 < 4; k0 += KH) {
      uint32_t hi[KH][4], lo[KH][4];
#pragma unroll
      for (int i = 0; i < KH; ++i) {
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int c = 16 * warp + quad + 8 * (f & 1);
          const int p = 8 * (k0 + i) + 2 * pair + (f >> 1);
          const float v = *reinterpret_cast<const float*>(
              reinterpret_cast<const uint8_t*>(&sm.x[stage][wg][c / 32][0][0]) +
              swizzled<128>(p, (c % 32) / 4) + 4 * (c % 4));
          hi[i][f] = __float_as_uint(tf32_hi(v));
          lo[i][f] = __float_as_uint(tf32_lo(v));
        }
      }
      if (k0 + KH == 4) mbar_arrive(&sm.empty[stage]);  // x's last read
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < KH; ++i) {
        const int kk = k0 + i;
        const uint64_t gb =
            desc_k_major<128>(reinterpret_cast<const uint8_t*>(&sm.gt[db][0][0]) + 32 * kk);
        const uint64_t gb_lo =
            desc_k_major<128>(reinterpret_cast<const uint8_t*>(&sm.gt_lo[db][0][0]) + 32 * kk);
        WgmmaTf32<BN>::rs(acc, lo[i], gb, kk > 0);
        WgmmaTf32<BN>::rs(acc, hi[i], gb_lo, 1);
        WgmmaTf32<BN>::rs(acc, hi[i], gb, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_p(hi, lo);
    }
    mbar_arrive(&sm.split_empty[db]);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sum[i] += acc[i];
  }

  // The slab's partial tile, straight from the sums.
  const int m9 = 9 * g.cin;
  float* part = ws + ((long long)split * m9 + 64 * (kWgSlabs * m_tile + wg)) * g.cout + co0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float* row = part + (long long)(16 * warp + quad + 8 * r) * g.cout + 2 * pair;
#pragma unroll
    for (int c = 0; c < BN / 8; ++c) {
      *reinterpret_cast<float2*>(row + 8 * c) =
          make_float2(sum[4 * c + 2 * r], sum[4 * c + 2 * r + 1]);
    }
  }
}

template <int BN>
int launch_tf32x3(const void* x, const void* gr, float* ws, const WgGeom& g, int splits,
                  cudaStream_t stream) {
  constexpr int NS = tf_stages<BN>();
  // x and g as (C, W, H, N), f32: innermost first, strides in bytes.
  const uint64_t xdims[4] = {static_cast<uint64_t>(g.cin), static_cast<uint64_t>(g.w),
                             static_cast<uint64_t>(g.h), static_cast<uint64_t>(g.n)};
  const uint64_t xstrides[3] = {4ull * g.cin, 4ull * g.cin * g.w, 4ull * g.cin * g.w * g.h};
  const uint64_t gdims[4] = {static_cast<uint64_t>(g.cout), xdims[1], xdims[2], xdims[3]};
  const uint64_t gstrides[3] = {4ull * g.cout, 4ull * g.cout * g.w,
                                4ull * g.cout * g.w * g.h};
  const uint32_t box[4] = {32, static_cast<uint32_t>(g.bw), static_cast<uint32_t>(g.bh),
                           static_cast<uint32_t>(g.bni)};
  CUtensorMap x_map, g_map;
  if (!make_tensor_map(&x_map, x, 4, xdims, xstrides, box, CU_TENSOR_MAP_SWIZZLE_128B,
                       CU_TENSOR_MAP_DATA_TYPE_FLOAT32) ||
      !make_tensor_map(&g_map, gr, 4, gdims, gstrides, box, CU_TENSOR_MAP_SWIZZLE_128B,
                       CU_TENSOR_MAP_DATA_TYPE_FLOAT32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = conv3x3_wgrad_tf32x3<BN, NS>;
  const int smem = static_cast<int>(sizeof(TfSmem<BN, NS>)) + 1024;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<g.tiles * splits, kTfThreads, smem, stream>>>(x_map, g_map, ws, g);
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

// Plain C entry point of the 3xTF32 kernel: dw = wgrad(x, g) in f32 through
// the workspace ws [splits, 9*Cin, Cout] f32. Takes Cin % 64 == 0,
// Cout % bn == 0 with bn in {64, 96}, a pixel box of bni images x bh rows x
// bw columns with bni * bh * bw == 32, and a split of the boxes into
// `splits` runs of `per` boxes (the last may be shorter, none empty): the
// plan vaw_torch/ops/conv2d.py:conv3x3_wgrad_plan makes for "tf32x3".
// Launches the partial-sum kernel and the reduction on `stream`; returns
// cudaGetLastError() after them (0 on success), or cudaErrorInvalidValue
// for what it does not take.
extern "C" int vaw_conv3x3_wgrad_tf32x3(const void* x, const void* gr, void* ws, void* dw,
                                        int n, int h, int w, int cin, int cout, int bni,
                                        int bh, int bw, int bn, int splits, int per,
                                        void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || cin <= 0 || cin % 64 != 0 || cout <= 0 ||
      (bn != 64 && bn != 96) || cout % bn != 0 || bni <= 0 || bh <= 0 || bw <= 0 ||
      bni * bh * bw != kTfPixels || splits <= 0 || per <= 0 ||
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
  if ((long long)(splits - 1) * per >= g.boxes || (long long)splits * per < g.boxes ||
      (long long)g.tiles * splits >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(ws);
  const int err = bn == 96 ? launch_tf32x3<96>(x, gr, part, g, splits, s)
                           : launch_tf32x3<64>(x, gr, part, g, splits, s);
  if (err != 0) return err;
  return launch_reduce(part, dw, 9 * cin * cout, splits, 0, s);
}
