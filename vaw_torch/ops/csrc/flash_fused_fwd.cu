// Fused multi-head softmax attention, forward only, read straight from the
// raw fused QKV projection.
//
// Replaces vaw_tpu/ops/flash_attention.py:_fwd_kernel_p6 (the forward of
// _flash_p6). Same contract:
//   qkv2d [B, T, 3*H*D] (bf16 or f32), last axis laid out (3, H, D): q, k
//     and v of head h sit at column offsets h*D, H*D + h*D and 2*H*D + h*D
//     of each row, row stride 3*H*D. They are read in place, never copied.
//   o   [B, T, H*D] in the input dtype, t-major, so the out-projection takes
//       it as it is.
//   lse [B*H, T] f32, the natural-log log-sum-exp of the scaled scores,
//       kept for the backward.
//   Scores, softmax and the P.V sums are f32. Any T; D % 8 == 0, D <= 128
//   (bf16: D <= 64).
//
// Bound. At the DiT-B/2 sampling shape (B = 128 with CFG, T = 256, H = 12,
// D = 64, bf16) one call moves 151 MB of qkv + 50 MB of o + 1.6 MB of lse,
// about 203 MB, or 61 us at 3.35 TB/s; it does 4*B*H*T*T*D = 25.8 GFLOP,
// 26 us at the bf16 tensor-core peak of 989 TFLOP/s (39 GFLOP, 39 us, with
// P.V done twice for P's hi and lo halves). So it is memory-bound at that
// shape, but only by a factor of 1.6: the products and the exponentials
// (B*H*T*T of them) must overlap the loads to come near the bound.
//
// Design. The TPU kernel holds all 256 keys of up to 48 (batch, head) rows
// in VMEM at once, and its T == 256 gate is a VMEM limit. Here a work item
// is 128 queries of one (b, h), and the keys stream through in tiles of 64
// with an online softmax (running max and sum, as in
// vaw_tpu/ops/flash_attention.py:_fwd_kernel), so any T works.
//
// bf16 (the sampling path), for Hopper:
// - Loads. One 5-D TMA tensor map views qkv2d as [B, T, 3, H, D] (D
//   innermost) with a box of 64 rows x 64 columns. A column past D lies
//   outside the tensor and a row past T outside its batch, so TMA fills both
//   with zeros: no other head is read, D pads to 64 for free, and a ragged
//   key tail reads zeros (masked to -inf below).
//   Tiles land 128-byte swizzled, which is wgmma's operand layout.
// - Pipeline. A persistent block on each SM walks the work items. One
//   producer warp issues the loads: each item's q into one of two buffers,
//   K and V into a ring of stages, each guarded by a full and an empty
//   mbarrier, so the next item's tiles load while this one is computed (a
//   block per item would load, then compute, in step with every other
//   block). Two consumer warpgroups take 64 query rows each, so K and V
//   are read once per 128 queries.
// - Products. S = q k^T is wgmma.m64n64k16 with q and k in shared memory
//   (k stored [key][d] is the K-major B operand). O += P v is
//   wgmma.m64nDk16 with P from registers (the S accumulator's layout is the
//   A fragment's) and v as the MN-major (transposed) B operand as it lies.
//   A warpgroup issues the next tile's S before this tile's P v, so the
//   tensor cores run the product while it computes the next softmax.
//   P stays f32 for the softmax and enters P.V as two bf16 terms, P = hi +
//   lo with hi = P cut to bf16 and lo = bf16(P - hi), about 16 significant
//   bits.
// - Softmax in registers, in the log2 domain with exp2. o goes to shared
//   memory and out by a TMA store (rows past T and columns past D are not
//   written); lse is stored from registers.
//
// f32 with scale > 0 (every model call: REPA's teacher) does not come here:
// vaw_torch/ops/flash_attention.py:_fused_forward sends it to the general
// forward's 3xTF32 design (flash_fwd.cu, flash_fwd_tf32x3) on the packed
// row's three views, the same contract. Nor does bf16 with D > 64
// (DiT-XL/2's 72): the general forward's TMA + wgmma kernel takes it on
// those views, padded to 80 (or to 128 for D > 80), and this kernel keeps
// one 64-column slab.
//
// f32 with scale <= 0: the same tiling on plain f32 FMAs, which keeps every
// operand f32 (64 queries a block). Four neighbouring threads share one
// query; each holds a quarter of q and of the accumulator (interleaved
// 4-float chunks, so the four read neighbouring shared-memory words), and
// two warp shuffles complete each score.

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace vaw_flash;
using namespace vaw_hopper;
using bf16 = __nv_bfloat16;

constexpr int kBlockQ = 64;  // queries of an f32 block

// ------------------------------------------------------------------ bf16
constexpr int kWgQueries = 64;                    // query rows of a consumer warpgroup
constexpr int kConsumers = 2 * 128;               // two consumer warpgroups
constexpr int kWgBlockQ = 2 * kWgQueries;         // queries of a work item
constexpr int kWgThreads = kConsumers + 32;       // and one producer warp
constexpr int kKeys = 64;                         // keys of a stage
constexpr uint32_t kBoxBytes = 64 * kSwizzleRowBytes;  // one 64 x 64 box

constexpr int kStages = 8;                        // K/V stages of the ring

// Shared memory of a block: one 64-column slab of the head dim; q of two
// work items (the next one loads while this one is computed), kStages
// stages of K and V, and o staged for its TMA store. Every tile is a
// multiple of 1024 bytes, so each starts on the swizzle's period.
struct FwdSmem {
  bf16 q[2][kWgBlockQ][64];
  bf16 k[kStages][kKeys][64];
  bf16 v[kStages][kKeys][64];
  bf16 o[kWgBlockQ][64];
  uint64_t q_full[2];
  uint64_t q_empty[2];
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

// Work item `item`: 128 queries of one (b, h), the query tiles innermost.
struct FwdItem {
  int b, h, q0;
};

__device__ __forceinline__ FwdItem fwd_item(int item, int q_tiles, int heads) {
  FwdItem w;
  w.q0 = (item % q_tiles) * kWgBlockQ;
  item /= q_tiles;
  w.h = item % heads;
  w.b = item / heads;
  return w;
}

__global__ void __launch_bounds__(kWgThreads, 1)
flash_fused_fwd_bf16(const __grid_constant__ CUtensorMap qkv_map,
                     const __grid_constant__ CUtensorMap out_map,
                     float* __restrict__ lse, int batch, int seq, int heads,
                     float scale) {
  constexpr int NS = kStages;
  constexpr int DP = 64;  // the head dim padded to one slab: the P.V product's N
  using Smem = FwdSmem;
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  const int tid = threadIdx.x;
  const int n_tiles = (seq + kKeys - 1) / kKeys;
  const int q_tiles = (seq + kWgBlockQ - 1) / kWgBlockQ;
  const int items = batch * heads * q_tiles;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mbar_init(&sm.q_full[i], 1);
      mbar_init(&sm.q_empty[i], kConsumers);
    }
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // The producer warp: one thread issues every load, running ahead of the
    // consumers by up to NS stages and one work item's q.
    if (tid == kConsumers) {
      prefetch_tensor_map(&qkv_map);
      int it = 0;
      int k = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++k) {
        const FwdItem w = fwd_item(item, q_tiles, heads);
        const int qb = k & 1;
        if (k >= 2) mbar_wait(&sm.q_empty[qb], (k / 2 - 1) & 1);
        mbar_arrive_expect_tx(&sm.q_full[qb], 2 * kBoxBytes);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          tma_load_5d(&sm.q[qb][kWgQueries * half][0], &qkv_map, &sm.q_full[qb], 0, w.h,
                      0, w.q0 + kWgQueries * half, w.b);
        }
        for (int j = 0; j < n_tiles; ++j, ++it) {
          const int stage = it % NS;
          if (it >= NS) mbar_wait(&sm.empty[stage], (it / NS - 1) & 1);
          mbar_arrive_expect_tx(&sm.full[stage], 2 * kBoxBytes);
          tma_load_5d(&sm.k[stage][0][0], &qkv_map, &sm.full[stage], 0, w.h, 1, j * kKeys,
                      w.b);
          tma_load_5d(&sm.v[stage][0][0], &qkv_map, &sm.full[stage], 0, w.h, 2, j * kKeys,
                      w.b);
        }
      }
    }
    return;
  }

  // A consumer warpgroup: query rows 64 * wg .. of each work item. This
  // thread holds rows r0 and r0 + 8 of them (the accumulator layout).
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int quad = lane / 4;
  const int pair = lane % 4;
  const int wg_leader = tid % 128 == 0;
  const float scale_log2 = scale * kLog2e;

  float o[DP / 2];
  float s[32];                   // S of one key tile: 64 rows x 64 keys
  uint32_t hi[4][4], lo[4][4];   // P of the previous tile, bf16 hi + lo
  float m[2], l[2];              // running max (log2 domain) and this thread's sum

  // S = q k^T into s for the tile in `stage` (issued, not waited for).
  auto issue_s = [&](int qb, int stage) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = desc_k_major(
          reinterpret_cast<const uint8_t*>(&sm.q[qb][kWgQueries * wg][0]) + 32 * kk);
      const uint64_t db = desc_k_major(
          reinterpret_cast<const uint8_t*>(&sm.k[stage][0][0]) + 32 * kk);
      Wgmma<64>::ss<0, 0>(s, da, db, kk > 0);
    }
  };
  // O += P v for the tile in `stage`: v [key][d] is the MN-major B operand,
  // 16 keys a step, P's hi and lo halves one product each.
  auto issue_pv = [&](int stage) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = desc_mn_major(&sm.v[stage][16 * kk][0], kBoxBytes);
      Wgmma<DP>::rs<1>(o, hi[kk], db, 1);
      Wgmma<DP>::rs<1>(o, lo[kk], db, 1);
    }
  };
  int it = 0;
  int k = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++k) {
    const FwdItem w = fwd_item(item, q_tiles, heads);
    const int qb = k & 1;
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
    mbar_wait(&sm.q_full[qb], (k / 2) & 1);

    // Tile 0: S, its softmax, P.
    mbar_wait(&sm.full[it % NS], (it / NS) & 1);
    wgmma_fence();
    issue_s(qb, it % NS);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    if (n_tiles == 1) mbar_arrive(&sm.q_empty[qb]);
    softmax_tile(s, m, l, 0, seq, pair, scale_log2);
    split_p(s, hi, lo);
    // Tile j: S_j is issued before P_{j-1} v_{j-1}, so the tensor cores work
    // on the latter while the softmax of S_j runs.
    for (int j = 1; j < n_tiles; ++j) {
      const int prev = (it + j - 1) % NS;
      const int stage = (it + j) % NS;
      mbar_wait(&sm.full[stage], ((it + j) / NS) & 1);
      wgmma_fence();
      issue_s(qb, stage);
      wgmma_commit();
      issue_pv(prev);
      wgmma_commit();
      wgmma_wait<1>();  // S_j is in
      fence_regs(s);
      if (j == n_tiles - 1) mbar_arrive(&sm.q_empty[qb]);  // q's last use
      const float2 alpha = softmax_tile(s, m, l, j * kKeys, seq, pair, scale_log2);
      wgmma_wait<0>();  // P_{j-1} v_{j-1} is in
      fence_regs(o);
      fence_p(hi, lo);
      mbar_arrive(&sm.empty[prev]);
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] *= ((i >> 1) & 1) ? alpha.y : alpha.x;
      split_p(s, hi, lo);
    }
    const int last = (it + n_tiles - 1) % NS;
    wgmma_fence();
    issue_pv(last);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_p(hi, lo);
    mbar_arrive(&sm.empty[last]);
    it += n_tiles;

    // Epilogue: o / l in bf16 to shared memory, 128-byte swizzled as the
    // store's tensor map reads it (row = query, 16-byte chunk c at c ^ (row
    // % 8)), then one TMA store a warpgroup; rows past T and columns past D
    // lie outside o and are not written. lse straight from registers.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    if (wg_leader) bulk_wait<true>();  // the previous item's store has read o
    named_barrier(1 + wg, 128);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = kWgQueries * wg + 16 * warp + quad + 8 * r;
      const float inv = 1.f / l[r];
#pragma unroll
      for (int c = 0; c < DP / 8; ++c) {
        uint8_t* line = reinterpret_cast<uint8_t*>(&sm.o[row][0]);
        *reinterpret_cast<__nv_bfloat162*>(line + 16 * ((c % 8) ^ (row % 8)) + 4 * pair) =
            __floats2bfloat162_rn(o[4 * c + 2 * r] * inv, o[4 * c + 2 * r + 1] * inv);
      }
      const int t = w.q0 + row;
      if (pair == 0 && t < seq) {
        lse[((long long)w.b * heads + w.h) * seq + t] = (m[r] + log2f(l[r])) * kLn2;
      }
    }
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    if (wg_leader) {
      tma_store_4d(&out_map, &sm.o[kWgQueries * wg][0], 0, w.h, w.q0 + kWgQueries * wg,
                   w.b);
      bulk_commit();
    }
  }
  if (wg_leader) bulk_wait<false>();
}

// ------------------------------------------------------------------- f32
constexpr int kLanesPerQuery = kFmaThreads / kBlockQ;  // 4
constexpr int kFmaBlockK = 32;

// NCH: 4-float chunks of the head dim per thread; the head dim is padded
// with zeros to DP = 16 * NCH (4 threads x NCH chunks x 4 floats).
template <int NCH>
__global__ void __launch_bounds__(kFmaThreads)
flash_fused_fwd_f32(const float* __restrict__ qkv, float* __restrict__ out,
                    float* __restrict__ lse, int seq, int heads, int dim,
                    float scale) {
  constexpr int DP = 16 * NCH;
  __shared__ __align__(16) float ks[kFmaBlockK][DP];
  __shared__ __align__(16) float vs[kFmaBlockK][DP];

  const int tid = threadIdx.x;
  const int part = tid & (kLanesPerQuery - 1);
  const int qrow = blockIdx.x * kBlockQ + tid / kLanesPerQuery;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hd = heads * dim;
  const long long row_stride = 3LL * hd;
  const float* base = qkv + (long long)b * seq * row_stride + (long long)h * dim;
  const bool q_valid = qrow < seq;

  // Thread `part` owns dims 4 * (part + 4 * i) + e of q and of acc.
  float q[NCH][4];
  float acc[NCH][4];
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * (part + kLanesPerQuery * i) + e;
      q[i][e] = (q_valid && d < dim)
                    ? base[(long long)qrow * row_stride + d] * scale
                    : 0.f;
      acc[i][e] = 0.f;
    }
  }
  float m = -INFINITY;
  float l = 0.f;

  // Padded dims [dim, DP) stay zero for the whole kernel.
  if (dim < DP) {
    for (int idx = tid; idx < kFmaBlockK * DP; idx += kFmaThreads) {
      const int d = idx % DP;
      if (d >= dim) {
        ks[idx / DP][d] = 0.f;
        vs[idx / DP][d] = 0.f;
      }
    }
  }

  const int vec_per_row = dim / 4;
  const int n_tiles = (seq + kFmaBlockK - 1) / kFmaBlockK;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kFmaBlockK;
    __syncthreads();  // the previous tile has been consumed
    for (int idx = tid; idx < kFmaBlockK * vec_per_row; idx += kFmaThreads) {
      const int j = idx / vec_per_row;
      const int d0 = (idx - j * vec_per_row) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + j < seq) {
        const float* r = base + (long long)(k0 + j) * row_stride + d0;
        kv = *reinterpret_cast<const float4*>(r + hd);
        vv = *reinterpret_cast<const float4*>(r + 2 * hd);
      }
      *reinterpret_cast<float4*>(&ks[j][d0]) = kv;
      *reinterpret_cast<float4*>(&vs[j][d0]) = vv;
    }
    __syncthreads();

    float s[kFmaBlockK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kFmaBlockK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < NCH; ++i) {
        const float4 k4 = *reinterpret_cast<const float4*>(
            &ks[j][4 * (part + kLanesPerQuery * i)]);
        dot = fmaf(q[i][0], k4.x, dot);
        dot = fmaf(q[i][1], k4.y, dot);
        dot = fmaf(q[i][2], k4.z, dot);
        dot = fmaf(q[i][3], k4.w, dot);
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      s[j] = (k0 + j < seq) ? dot * kLog2e : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    // Every tile holds at least one valid key, so m_new is finite.
    const float m_new = fmaxf(m, tile_max);
    const float alpha = exp2f(m - m_new);  // 0 on the first tile
    l *= alpha;
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kFmaBlockK; ++j) {
      const float p = exp2f(s[j] - m_new);  // 0 for masked keys
      l += p;
#pragma unroll
      for (int i = 0; i < NCH; ++i) {
        const float4 v4 = *reinterpret_cast<const float4*>(
            &vs[j][4 * (part + kLanesPerQuery * i)]);
        acc[i][0] = fmaf(p, v4.x, acc[i][0]);
        acc[i][1] = fmaf(p, v4.y, acc[i][1]);
        acc[i][2] = fmaf(p, v4.z, acc[i][2]);
        acc[i][3] = fmaf(p, v4.w, acc[i][3]);
      }
    }
    m = m_new;
  }

  if (q_valid) {
    float* o = out + ((long long)b * seq + qrow) * hd + (long long)h * dim;
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * (part + kLanesPerQuery * i) + e;
        if (d < dim) o[d] = acc[i][e] / l;
      }
    }
    if (part == 0) {
      lse[((long long)b * heads + h) * seq + qrow] = (m + log2f(l)) * kLn2;
    }
  }
}

int launch_bf16(const void* qkv, void* out, float* lse, int batch, int seq,
                int heads, int dim, float scale, cudaStream_t stream) {
  // qkv2d as [B, T, 3, H, D] and o as [B, T, H, D], innermost first,
  // strides in bytes.
  const uint64_t hd = static_cast<uint64_t>(heads) * dim;
  const uint64_t dims[5] = {static_cast<uint64_t>(dim), static_cast<uint64_t>(heads), 3,
                            static_cast<uint64_t>(seq), static_cast<uint64_t>(batch)};
  const uint64_t strides[4] = {2ull * dim, 2 * hd, 6 * hd, 6 * hd * seq};
  const uint32_t box[5] = {64, 1, 1, kKeys, 1};
  const uint64_t odims[4] = {dims[0], dims[1], dims[3], dims[4]};
  const uint64_t ostrides[3] = {2ull * dim, 2 * hd, 2 * hd * seq};
  const uint32_t obox[4] = {64, 1, kWgQueries, 1};
  CUtensorMap qkv_map, out_map;
  if (!make_tensor_map(&qkv_map, qkv, 5, dims, strides, box) ||
      !make_tensor_map(&out_map, out, 4, odims, ostrides, obox)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = flash_fused_fwd_bf16;
  const int smem = static_cast<int>(sizeof(FwdSmem)) + 1024;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  static const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  // A persistent grid: one block an SM walks the work items.
  const long long items =
      (long long)batch * heads * ((seq + kWgBlockQ - 1) / kWgBlockQ);
  if (items >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = items < sms ? static_cast<int>(items) : sms;
  kernel<<<grid, kWgThreads, smem, stream>>>(qkv_map, out_map, lse, batch, seq, heads,
                                             scale);
  return static_cast<int>(cudaGetLastError());
}

template <int NCH>
int launch_f32(const void* qkv, void* out, float* lse, int batch, int seq,
               int heads, int dim, float scale, cudaStream_t stream) {
  const dim3 grid((seq + kBlockQ - 1) / kBlockQ, heads, batch);
  flash_fused_fwd_f32<NCH><<<grid, kFmaThreads, 0, stream>>>(
      static_cast<const float*>(qkv), static_cast<float*>(out), lse, seq, heads,
      dim, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream` and returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a shape the kernels do not take (or a tensor
// map the driver refuses). is_bf16 selects __nv_bfloat16 over float for qkv
// and o.
extern "C" int vaw_flash_fused_fwd(const void* qkv, void* out, void* lse,
                                   int batch, int seq, int heads, int dim,
                                   float scale, int is_bf16, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || dim <= 0 || dim % 8 != 0 ||
      dim > 128 || batch > 65535 || heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (!is_bf16) {
    if (dim <= 32) return launch_f32<2>(qkv, out, l, batch, seq, heads, dim, scale, s);
    if (dim <= 64) return launch_f32<4>(qkv, out, l, batch, seq, heads, dim, scale, s);
    return launch_f32<8>(qkv, out, l, batch, seq, heads, dim, scale, s);
  }
  if (dim > 64) return static_cast<int>(cudaErrorInvalidValue);
  return launch_bf16(qkv, out, l, batch, seq, heads, dim, scale, s);
}
