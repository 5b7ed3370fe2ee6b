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
// The TPU kernel pads x in device memory (one pixel of halo, Cin to 128,
// W + 2 to a multiple of 8), DMAs a (TH + 2)-row slab into VMEM and
// multiplies it by all nine taps at once, [(TH+2)*WP, Cin] x [Cin, 9*Cout],
// then adds the nine shifted slices: 9*(TH+2)*WP/(TH*W) times the useful
// work, laid out for the TPU's lanes. None of that carries over. Three
// kernels here, chosen by shape (vaw_torch/ops/conv2d.py:conv3x3_design):
//
// wgmma (bf16, Cin % 64 == 0, Cout % 64 == 0: every ADM-64 conv but the
// stem and the f32 head, and their dgrads), for Hopper:
// - A tile. A tile is 128 output pixels, a box of images x rows x columns
//   chosen by the caller to fit the image (2x64 at W = 64, 4x32, 8x16, two
//   images of 8x8). Each K step, 64 channels of one tap, is one TMA load of
//   a 4-D tensor map over x (Cin, W, H, N) at the box's corner shifted by
//   the tap (dy - 1, dx - 1). TMA fills rows and columns outside the image
//   with zeros, per dimension and so per image: that is the pad of 1, with
//   no padded copy of x and no address arithmetic. The box lands
//   128-byte swizzled, one pixel a 128-byte row: wgmma's K-major A layout.
// - B tile. BN (64, 128 or 192) filter rows of the same 64 k by TMA from wk.
// - Block. A persistent block on each SM walks the output tiles (128
//   pixels x BN channels, channel blocks innermost so neighbouring blocks
//   share x in L2); one producer warp keeps a ring of stages loading while
//   two consumer warpgroups (64 pixels each) run wgmma.m64nBNk16 on f32
//   accumulators, one group of products in flight behind the one being
//   issued. At Cout = 192 a tile owns all output channels, so x is read
//   once per tap, not once per 64 channels. A step moves 40 KB from L2 for
//   1.6 M multiply-adds; the loads alone take about as long as the
//   products at the tensor cores' peak, so the two overlapping is what
//   sets the pace.
// - Epilogue. The tile goes to shared memory in bf16 and out by TMA stores
//   while the consumers start the next unit; pixels outside the image lie
//   outside y and are not written.
//
// mma.sync (bf16, other shapes: the 3-channel stem): a block owns 128
// output pixels x 64 output channels and walks K in steps of 32. Each step
// gathers its A tile straight from the unpadded NHWC x: with Cin % 8 == 0
// the 8 values of a 16-byte chunk share one tap, so a chunk is one cp.async
// whose source is the pixel shifted by that tap, zero-filled when the
// shifted pixel lies outside the image; Cin % 8 != 0 (the stem) gathers A
// one value at a time. The B tile is 16-byte copies of wk. Three stages of
// cp.async keep two tiles in flight while the third is multiplied on
// mma.sync m16n8k16 (ldmatrix fragments from rows padded to 80 bytes), f32
// accumulators, one rounding at the store.
//
// f32: plain FMAs, 256 threads each owning a TM x TN block of the output;
// 128 x 64 tiles, or 256 x 8 when Cout <= 8 (the 3-channel head).

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace vaw_flash;
using namespace vaw_hopper;
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

// ----------------------------------------------------------- bf16, wgmma
constexpr int kWgM = 128;                    // output pixels of a tile
constexpr int kWgRows = 64;                  // of them, a consumer warpgroup's
constexpr int kWgConsumers = 2 * 128;        // two consumer warpgroups
constexpr int kWgThreads = kWgConsumers + 32;  // and one producer warp
constexpr uint32_t kATileBytes = kWgM * kSwizzleRowBytes;  // 64 channels a pixel
constexpr int kStoreBarrier = 1;             // named barrier of the consumers

// The wgmma kernel's geometry: the image, the pixel box (images x rows x
// columns, 128 pixels) and the output tiles, BN channels each.
struct WgGeom {
  int n, h, w, cin, cout;
  int bni, bh, bw;
  int tiles_w, tiles_h, tiles_c, tiles;
};

template <int BN>
constexpr int wg_stages() { return BN == 192 ? 4 : BN == 128 ? 5 : 8; }

// A ring of NS stages of one A tile and one B tile, and the output tile
// staged for its TMA store (BN / 64 boxes of 128 pixels x 64 channels).
// Every tile is a multiple of 1024 bytes, so each starts on the swizzle's
// period.
template <int BN, int NS>
struct WgSmem {
  bf16 a[NS][kWgM][64];
  bf16 b[NS][BN][64];
  bf16 out[BN / 64][kWgM][64];
  uint64_t full[NS];
  uint64_t empty[NS];
};

// The output tile `t`: first channel, image, row and column of its corner.
struct WgTile {
  int co0, n0, h0, w0;
};

__device__ __forceinline__ WgTile wg_tile(const WgGeom& g, int t, int bn) {
  WgTile o;
  o.co0 = (t % g.tiles_c) * bn;
  t /= g.tiles_c;
  o.w0 = (t % g.tiles_w) * g.bw;
  t /= g.tiles_w;
  o.h0 = (t % g.tiles_h) * g.bh;
  o.n0 = (t / g.tiles_h) * g.bni;
  return o;
}

template <int BN, int NS>
__global__ void __launch_bounds__(kWgThreads, 1)
conv3x3_fwd_wgmma(const __grid_constant__ CUtensorMap x_map,
                  const __grid_constant__ CUtensorMap w_map,
                  const __grid_constant__ CUtensorMap y_map, WgGeom g) {
  using Smem = WgSmem<BN, NS>;
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  const int tid = threadIdx.x;
  const int cblocks = g.cin / 64;
  const int ksteps = 9 * cblocks;  // tap-major: all channels of tap 0, then tap 1, ...

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
    // The producer warp: one thread issues every load, running ahead of the
    // consumers by up to NS stages, across output tiles.
    if (tid == kWgConsumers) {
      prefetch_tensor_map(&x_map);
      prefetch_tensor_map(&w_map);
      int it = 0;
      for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
        const WgTile o = wg_tile(g, t, BN);
        for (int ks = 0; ks < ksteps; ++ks, ++it) {
          const int tap = ks / cblocks;
          const int cb = ks - tap * cblocks;
          const int stage = it % NS;
          if (it >= NS) mbar_wait(&sm.empty[stage], (it / NS - 1) & 1);
          mbar_arrive_expect_tx(&sm.full[stage], kATileBytes + BN * kSwizzleRowBytes);
          tma_load_4d(&sm.a[stage][0][0], &x_map, &sm.full[stage], 64 * cb,
                      o.w0 + tap % 3 - 1, o.h0 + tap / 3 - 1, o.n0);
          tma_load_2d(&sm.b[stage][0][0], &w_map, &sm.full[stage],
                      tap * g.cin + 64 * cb, o.co0);
        }
      }
    }
  } else {
    const int wg = tid / 128;
    const int warp = (tid % 128) / 32;
    const int lane = tid % 32;
    const int quad = lane / 4;
    const int pair = lane % 4;
    int it = 0;
    // One consumer warp's release of a stage.
    auto release = [&](int stage) {
      if (lane == 0) mbar_arrive(&sm.empty[stage]);
    };
    for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      for (int ks = 0; ks < ksteps; ++ks, ++it) {
        const int stage = it % NS;
        mbar_wait(&sm.full[stage], (it / NS) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t da = desc_k_major(
              reinterpret_cast<const uint8_t*>(&sm.a[stage][kWgRows * wg][0]) + 32 * kk);
          const uint64_t db =
              desc_k_major(reinterpret_cast<const uint8_t*>(&sm.b[stage][0][0]) + 32 * kk);
          Wgmma<BN>::template ss<0, 0>(acc, da, db, 1);
        }
        wgmma_commit();
        // The previous step's products are done: release its stage.
        wgmma_wait<1>();
        fence_regs(acc);
        if (ks > 0) release((it - 1) % NS);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      release((it - 1) % NS);

      // Epilogue: the tile goes to shared memory, 128-byte swizzled as the
      // store's tensor map reads it (row = pixel of the box, 16-byte chunk
      // c stored at c ^ (row % 8)), and one thread stores it with TMA while
      // the consumers go on to the next tile. Pixels outside the image lie
      // outside y and are not written.
      if (tid == 0) bulk_wait<true>();  // the previous store has read the tile
      named_barrier(kStoreBarrier, kWgConsumers);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = kWgRows * wg + 16 * warp + quad + 8 * r;
#pragma unroll
        for (int c = 0; c < BN / 8; ++c) {
          uint8_t* line = reinterpret_cast<uint8_t*>(&sm.out[c / 8][row][0]);
          *reinterpret_cast<__nv_bfloat162*>(line + 16 * ((c % 8) ^ (row % 8)) + 4 * pair) =
              __floats2bfloat162_rn(acc[4 * c + 2 * r], acc[4 * c + 2 * r + 1]);
        }
      }
      fence_proxy_async();
      named_barrier(kStoreBarrier, kWgConsumers);
      if (tid == 0) {
        const WgTile o = wg_tile(g, t, BN);
#pragma unroll
        for (int slab = 0; slab < BN / 64; ++slab) {
          tma_store_4d(&y_map, &sm.out[slab][0][0], o.co0 + 64 * slab, o.w0, o.h0, o.n0);
        }
        bulk_commit();
      }
    }
    if (tid == 0) bulk_wait<false>();
  }
}

template <int BN>
int launch_wgmma(const void* x, const void* wk, void* y, WgGeom g, cudaStream_t stream) {
  constexpr int NS = wg_stages<BN>();
  // x and y as (C, W, H, N), wk as (9 * Cin, Cout): innermost first,
  // strides in bytes.
  const uint64_t xdims[4] = {static_cast<uint64_t>(g.cin), static_cast<uint64_t>(g.w),
                             static_cast<uint64_t>(g.h), static_cast<uint64_t>(g.n)};
  const uint64_t xstrides[3] = {2ull * g.cin, 2ull * g.cin * g.w, 2ull * g.cin * g.w * g.h};
  const uint64_t ydims[4] = {static_cast<uint64_t>(g.cout), xdims[1], xdims[2], xdims[3]};
  const uint64_t ystrides[3] = {2ull * g.cout, 2ull * g.cout * g.w,
                                2ull * g.cout * g.w * g.h};
  const uint32_t box[4] = {64, static_cast<uint32_t>(g.bw), static_cast<uint32_t>(g.bh),
                           static_cast<uint32_t>(g.bni)};
  const uint64_t wdims[2] = {9ull * g.cin, static_cast<uint64_t>(g.cout)};
  const uint64_t wstrides[1] = {18ull * g.cin};
  const uint32_t wbox[2] = {64, BN};
  CUtensorMap x_map, w_map, y_map;
  if (!make_tensor_map(&x_map, x, 4, xdims, xstrides, box) ||
      !make_tensor_map(&w_map, wk, 2, wdims, wstrides, wbox) ||
      !make_tensor_map(&y_map, y, 4, ydims, ystrides, box)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = conv3x3_fwd_wgmma<BN, NS>;
  const int smem = static_cast<int>(sizeof(WgSmem<BN, NS>)) + 1024;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);

  static const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  // A persistent grid: one block an SM walks the tiles.
  const int grid = g.tiles < sms ? g.tiles : sms;
  kernel<<<grid, kWgThreads, smem, stream>>>(x_map, w_map, y_map, g);
  return static_cast<int>(cudaGetLastError());
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

// Plain C entry point of the wgmma kernel: y = conv3x3(x, w) in bf16 with
// wk [Cout, 9 * Cin] (Kpad = 9 * Cin). Takes Cin % 64 == 0, Cout % bn == 0
// with bn in {64, 128, 192}, and a pixel box of bni images x bh rows x bw
// columns with bni * bh * bw == 128 and each side at most 128 (the box the
// caller chose, vaw_torch/ops/conv2d.py:conv3x3_wgmma_tiling). Launches on
// `stream` and returns cudaGetLastError() after the launch (0 on success),
// or cudaErrorInvalidValue for what it does not take.
extern "C" int vaw_conv3x3_fwd_wgmma(const void* x, const void* wk, void* y, int n,
                                     int h, int w, int cin, int cout, int bni, int bh,
                                     int bw, int bn, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || cin <= 0 || cin % 64 != 0 || cout <= 0 ||
      (bn != 64 && bn != 128 && bn != 192) || cout % bn != 0 || bni <= 0 ||
      bh <= 0 || bw <= 0 || bni * bh * bw != kWgM || bw > 128 || bh > 128 ||
      bni > 128 || (long long)n * h * w * (cin > cout ? cin : cout) >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  WgGeom g{n, h, w, cin, cout, bni, bh, bw, 0, 0, 0, 0};
  g.tiles_w = (w + bw - 1) / bw;
  g.tiles_h = (h + bh - 1) / bh;
  g.tiles_c = cout / bn;
  const long long tiles =
      (long long)((n + bni - 1) / bni) * g.tiles_h * g.tiles_w * g.tiles_c;
  if (tiles >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  g.tiles = static_cast<int>(tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 192) return launch_wgmma<192>(x, wk, y, g, s);
  if (bn == 128) return launch_wgmma<128>(x, wk, y, g, s);
  return launch_wgmma<64>(x, wk, y, g, s);
}
