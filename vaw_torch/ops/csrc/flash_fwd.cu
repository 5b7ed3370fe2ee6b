// General multi-head softmax attention, forward only: separate, strided q,
// k and v, with any number of queries and keys.
//
// Replaces vaw_tpu/ops/flash_attention.py:_fwd_kernel (the forward of
// _flash, the general-T kernel). Same contract:
//   q [B, Tq, H, D], k and v [B, Tk, H, D] (bf16 or f32, one dtype), each a
//     view with its own batch, token and head strides and unit stride over
//     D, so one kernel reads [B, T, H, D] tensors and the q, k and v views of
//     a packed [B, T, 3, H, D] projection without a copy. D % 8 == 0 and
//     D <= 256; Tq and Tk independent.
//   o   [B, Tq, H, D] contiguous, in the input dtype.
//   lse [B*H, Tq] f32, the natural-log log-sum-exp of the scaled scores,
//       kept for the backward.
//   Scores, softmax and the P.V sums are f32. A ragged key tail is masked; a
//   ragged query tail is neither written nor counted.
//
// Bound. At the U-ViT-L/2 sampling shape (B = 128 with CFG, T = 258,
// H = 16, D = 64, bf16) one call reads 203 MB of q, k and v and writes
// 68 MB of o and 2 MB of lse, 81 us at 3.35 TB/s; its 4*B*H*T*T*D =
// 34.9 GFLOP take 35 us at the bf16 tensor-core peak of 989 TFLOP/s, and
// its 137 M exponentials 33 us at 16 a clock on each SM. So the bytes bind
// there. At T = 1024 the products (ADM-64: 128 x 6 heads of 64) or the
// exponentials (LDM: 128 x 8 heads of 32, 1.07 G of them, 0.26 ms) bind.
//
// Design. The TPU kernel holds the whole (padded) K/V sequence of several
// (batch, head) rows in VMEM and walks 256-key blocks of it. Here the keys
// stream through in 64-key tiles with an online softmax (running max and
// sum), so any T works. Three kernels, chosen by the call
// (vaw_torch/ops/flash_attention.py:flash_fwd_design):
//
// wgmma (bf16 with D <= 128 and scale > 0: every model call), for Hopper,
// B1's design (flash_fused_fwd.cu) on three strided views:
// - Loads. One 4-D TMA tensor map for each of q, k and v views it as
//   [D, H, T, B] (innermost first) with that view's own byte strides
//   (vaw_torch/ops/flash_attention.py:general_tensor_map), so the views of
//   a packed projection are read in place; a box is 64 rows of one slab of
//   the head dim. A head dim of 32 (LDM) is one 64-byte slab, swizzled 64
//   bytes wide, so it is neither padded nor multiplied twice; larger ones
//   are 128-byte slabs of 64 columns (D = 40 pads to 64, D = 96 to 128).
//   TMA fills columns past D and rows past T with zeros: the ragged key
//   tail is masked to -inf, the query tail is never stored.
// - Pipeline. A persistent block on each SM walks work items of 64 * NWG
//   queries of one (b, h). One producer warp loads each item's q (two
//   buffers) and streams K and V through a ring of stages guarded by full
//   and empty mbarriers. NWG consumer warpgroups take 64 queries each and
//   read every stage, so K and V are read once per item: three for D <= 64
//   (more warps to hide the softmax's latencies; ptxas then allows 128
//   registers a thread), two for D = 128. A warpgroup whose 64 rows all lie
//   past Tq (the last item at T = 258) only keeps the stages' accounting.
// - Products. S = q k^T is wgmma.m64n64k16 with both operands K-major in
//   shared memory; O += P v is wgmma.m64nDPk16 with P from registers (the
//   S accumulator's layout is the A fragment's) and v as the MN-major B
//   operand as it lies. A warpgroup issues tile j's S before tile j-1's
//   P v, so the tensor cores run the product while the softmax runs. P
//   stays f32 for the softmax and enters P.V as two bf16 terms (hi + lo,
//   about 16 significant bits).
// - Softmax in registers in the log2 domain (hopper_common.cuh:
//   softmax_tile); o goes to shared memory and out by a 4-D TMA store; lse
//   from the row owners.
//
// mma.sync (other bf16 calls: D in (128, 256] or scale <= 0): one thread
// block takes one (b, h, 64-query tile) and stages each 64-key tile
// synchronously in shared memory (the key tail zero-filled and masked).
// Four warps, 16 query rows each, on mma.sync m16n8k16 with f32
// accumulators; products of bf16 values are exact in f32, so the scores are
// the f32 scores, and the scale multiplies them in f32. P enters P.V split
// into bf16 hi + lo. For D in (128, 256] the output columns are split over
// two blocks that each compute the full scores (they need all of D) and
// only their own half of P.V, keeping the accumulator at <= 64 floats a
// thread.
// f32: plain FMAs with every operand f32, q * scale formed at load as the
// TPU kernel does. L = 4 neighbouring threads share one query for D <= 128
// (8 for larger D), each holding a 1/L share of q and of the accumulator.

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace vaw_flash;
using namespace vaw_hopper;
using bf16 = __nv_bfloat16;

// ------------------------------------------------------------------ bf16
template <int NK>
using FwdSplit = Split<NK, 16>;  // at most 128 output columns per block

template <int NK>
constexpr int fwd_smem_bytes() {
  using S = FwdSplit<NK>;
  return 2 * kTile * S::LD * 2 + kTile * (8 * S::NDO + kRowPad) * 2;
}

// NK: 16-wide steps of the head dim, zero-padded to 16 * NK.
template <int NK>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_bf16(View<const bf16> q, View<const bf16> k, View<const bf16> v,
               bf16* __restrict__ out, float* __restrict__ lse, int tq, int tk,
               int heads, int dim, float scale) {
  using S = FwdSplit<NK>;
  constexpr int NDO = S::NDO;     // 8-wide output column tiles of this block
  constexpr int LD = S::LD;
  constexpr int LDV = 8 * NDO + kRowPad;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16 (*qs)[LD] = reinterpret_cast<bf16 (*)[LD]>(smem);
  bf16 (*ks)[LD] = qs + kTile;
  bf16 (*vs)[LDV] = reinterpret_cast<bf16 (*)[LDV]>(ks + kTile);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int quad = lane / 4;   // row within an 8-row half of the warp's tile
  const int pair = lane % 4;   // column pair within an 8-column tile
  const int split = blockIdx.x % S::kSplits;
  const int q0 = (blockIdx.x / S::kSplits) * kTile;
  const int c0 = split * 8 * NDO;  // this block's first output column
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bf16* qb = q.head(b, h);
  const bf16* kb = k.head(b, h);
  const bf16* vb = v.head(b, h);
  const int qr = warp * 16;  // this warp's first query row in the tile

  stage_tile<LD>(qs, qb, q.st, q0, tq, 0, 16 * NK, dim, tid);
  float acc[NDO][4];
#pragma unroll
  for (int nd = 0; nd < NDO; ++nd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;
  }
  // Per row (qr + quad, + 8): running max in the log2 domain, partial sum.
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  const float scale_log2 = scale * kLog2e;

  const int n_tiles = (tk + kTile - 1) / kTile;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kTile;
    __syncthreads();  // the previous tile has been consumed (and qs staged)
    stage_tile<LD>(ks, kb, k.st, k0, tk, 0, 16 * NK, dim, tid);
    stage_tile<LDV>(vs, vb, v.st, k0, tk, c0, 8 * NDO, dim, tid);
    __syncthreads();

    // S = q k^T for this warp's 16 rows x 64 keys.
    float s[kTile / 8][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t qa[4];
      load_a<LD>(qa, qs, qr, kk, quad, pair);
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt) {
        const bf16* krow = &ks[nt * 8 + quad][kk * 16 + 2 * pair];
        mma_16816(s[nt], qa, ld_u32(krow), ld_u32(krow + 8));
      }
    }
    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * pair + (e & 1);
        s[nt][e] = key < tk ? s[nt][e] * scale_log2 : -INFINITY;
        tile_max[e >> 1] = fmaxf(tile_max[e >> 1], s[nt][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
      const float m_new = fmaxf(m[r], tile_max[r]);  // finite: a valid key per tile
      alpha[r] = exp2f(m[r] - m_new);               // 0 on the first tile
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int nd = 0; nd < NDO; ++nd) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nd][e] *= alpha[e >> 1];
    }
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(s[nt][e] - m[e >> 1]);  // 0 for masked keys
        l[e >> 1] += s[nt][e];
      }
    }

    // acc += P v[:, c0 : c0 + 8 NDO], P split into bf16 hi + lo, 16 keys a step.
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_a(hi, lo, s, kk);
#pragma unroll
      for (int nd = 0; nd < NDO; ++nd) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, &vs[kk * 16 + (lane & 15)][nd * 8]);
        mma_16816(acc[nd], hi, b0, b1);
        mma_16816(acc[nd], lo, b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const int hd = heads * dim;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + qr + quad + 8 * r;
    if (row >= tq) continue;
    bf16* o = out + ((long long)b * tq + row) * hd + (long long)h * dim;
#pragma unroll
    for (int nd = 0; nd < NDO; ++nd) {
      const int col = c0 + nd * 8 + 2 * pair;
      if (col < dim) {
        *reinterpret_cast<__nv_bfloat162*>(o + col) = __floats2bfloat162_rn(
            acc[nd][2 * r] / l[r], acc[nd][2 * r + 1] / l[r]);
      }
    }
    if (split == 0 && pair == 0) {
      lse[((long long)b * heads + h) * tq + row] = (m[r] + log2f(l[r])) * kLn2;
    }
  }
}

// ------------------------------------------------------------------- f32
// NCH 4-float chunks a thread, L threads a query, BK keys a streamed tile.
template <int NCH, int L, int BK>
__global__ void __launch_bounds__(kFmaThreads)
flash_fwd_f32(View<const float> q, View<const float> k, View<const float> v,
              float* __restrict__ out, float* __restrict__ lse, int tq, int tk,
              int heads, int dim, float scale) {
  constexpr int DP = 4 * L * NCH;
  constexpr int R = kFmaThreads / L;  // queries per block
  __shared__ __align__(16) float ks[BK][DP];
  __shared__ __align__(16) float vs[BK][DP];

  const int tid = threadIdx.x;
  const int part = tid % L;
  const int qrow = blockIdx.x * R + tid / L;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bool q_valid = qrow < tq;
  const float* kb = k.head(b, h);
  const float* vb = v.head(b, h);

  float qr[NCH][4], acc[NCH][4];
  load_row<NCH, L>(qr, q.head(b, h) + (long long)qrow * q.st, q_valid, dim, part, scale);
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;
  zero_pad<BK, DP>(ks, vs, dim, tid);

  const int n_tiles = (tk + BK - 1) / BK;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();  // the previous tile has been consumed
    stage_rows<BK, DP>(ks, kb, k.st, k0, tk, dim, 1.f, tid);
    stage_rows<BK, DP>(vs, vb, v.st, k0, tk, dim, 1.f, tid);
    __syncthreads();

    float s[BK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float dot = row_dot<NCH, L>(qr, ks[j], part);
      s[j] = (k0 + j < tk) ? dot * kLog2e : -INFINITY;
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
    for (int j = 0; j < BK; ++j) {
      const float p = exp2f(s[j] - m_new);  // 0 for masked keys
      l += p;
      row_axpy<NCH, L>(acc, p, vs[j], part);
    }
    m = m_new;
  }

  if (q_valid) {
    const long long row = ((long long)b * tq + qrow) * heads + h;
    store_row<NCH, L>(out + row * dim, acc, dim, part, 1.f / l);
    if (part == 0) {
      lse[((long long)b * heads + h) * tq + qrow] = (m + log2f(l)) * kLn2;
    }
  }
}

// ----------------------------------------------------------- bf16, wgmma
constexpr int kWgRows = 64;   // query rows of a consumer warpgroup; keys of a stage
constexpr int kSmemBudget = 232448 - 1024 - 256;  // less the alignment and barriers

// Shared memory of a block with NWG consumer warpgroups: q of two work
// items of 64 * NWG queries (the next one loads while this one is
// computed), NS stages of K and V, and o staged for its TMA store; each
// tile a 64-row box of one slab (AttnGeo), a multiple of 4096 bytes, so
// every tile starts on the swizzle's period.
template <int DP, int NWG, int NS>
struct WgSmem {
  using G = AttnGeo<DP>;
  bf16 q[2][G::kSlabs][kWgRows * NWG][G::kSlab];
  bf16 k[NS][G::kSlabs][kWgRows][G::kSlab];
  bf16 v[NS][G::kSlabs][kWgRows][G::kSlab];
  bf16 o[G::kSlabs][kWgRows * NWG][G::kSlab];
  uint64_t q_full[2];
  uint64_t q_empty[2];
  uint64_t full[NS];
  uint64_t empty[NS];
};

// K/V stages that fit beside q and o, at most 8.
template <int DP, int NWG>
constexpr int wg_stages() {
  constexpr int fixed = 3 * kWgRows * NWG * DP * 2;
  constexpr int room = (kSmemBudget - fixed) / (2 * kWgRows * DP * 2);
  return room > 8 ? 8 : room;
}

// Consumer warpgroups of a block: three for a head dim of up to 64 (more
// warps to hide the softmax's latencies; ptxas then allows 128 registers a
// thread, as four warps share each quarter of the register file), two for
// 128 (its accumulator alone is 64 registers; 168 a thread).
template <int DP>
constexpr int wg_consumers() { return DP == 128 ? 2 : 3; }

template <int DP, int NWG, int NS>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                const __grid_constant__ CUtensorMap out_map, float* __restrict__ lse,
                int batch, int tq, int tk, int heads, float scale) {
  using G = AttnGeo<DP>;
  constexpr int SW = G::kSwizzle;
  constexpr int SLAB = G::kSlab;
  constexpr int NSLAB = G::kSlabs;
  constexpr uint32_t kBox = G::kBox;
  constexpr int kConsumers = 128 * NWG;
  constexpr int kItemRows = kWgRows * NWG;
  using Smem = WgSmem<DP, NWG, NS>;
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  const int tid = threadIdx.x;
  const int n_tiles = (tk + kWgRows - 1) / kWgRows;
  const int q_tiles = (tq + kItemRows - 1) / kItemRows;
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
      prefetch_tensor_map(&q_map);
      prefetch_tensor_map(&k_map);
      prefetch_tensor_map(&v_map);
      int it = 0;
      int n = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
        const int q0 = (item % q_tiles) * kItemRows;
        const int h = (item / q_tiles) % heads;
        const int b = item / q_tiles / heads;
        const int qb = n & 1;
        if (n >= 2) mbar_wait(&sm.q_empty[qb], (n / 2 - 1) & 1);
        mbar_arrive_expect_tx(&sm.q_full[qb], NWG * NSLAB * kBox);
#pragma unroll
        for (int s = 0; s < NSLAB; ++s) {
#pragma unroll
          for (int w = 0; w < NWG; ++w) {
            tma_load_4d(&sm.q[qb][s][kWgRows * w][0], &q_map, &sm.q_full[qb], SLAB * s, h,
                        q0 + kWgRows * w, b);
          }
        }
        for (int j = 0; j < n_tiles; ++j, ++it) {
          const int stage = it % NS;
          if (it >= NS) mbar_wait(&sm.empty[stage], (it / NS - 1) & 1);
          mbar_arrive_expect_tx(&sm.full[stage], 2 * NSLAB * kBox);
#pragma unroll
          for (int s = 0; s < NSLAB; ++s) {
            tma_load_4d(&sm.k[stage][s][0][0], &k_map, &sm.full[stage], SLAB * s, h,
                        j * kWgRows, b);
            tma_load_4d(&sm.v[stage][s][0][0], &v_map, &sm.full[stage], SLAB * s, h,
                        j * kWgRows, b);
          }
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

  // S = q k^T into s for the tile in `stage` (issued, not waited for): 16
  // columns of the head dim a step, 32 bytes along a slab's rows.
  auto issue_s = [&](int qb, int stage) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      constexpr int kSteps = SLAB / 16;  // k steps of a slab
      const uint64_t da = desc_k_major<SW>(
          reinterpret_cast<const uint8_t*>(&sm.q[qb][kk / kSteps][kWgRows * wg][0]) +
          32 * (kk % kSteps));
      const uint64_t db = desc_k_major<SW>(
          reinterpret_cast<const uint8_t*>(&sm.k[stage][kk / kSteps][0][0]) +
          32 * (kk % kSteps));
      Wgmma<64>::ss<0, 0>(s, da, db, kk > 0);
    }
  };
  // O += P v for the tile in `stage`: v [key][d] is the MN-major B operand,
  // 16 keys a step, P's hi and lo halves one product each.
  auto issue_pv = [&](int stage) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = desc_mn_major<SW>(&sm.v[stage][0][16 * kk][0], kBox);
      Wgmma<DP>::template rs<1>(o, hi[kk], db, 1);
      Wgmma<DP>::template rs<1>(o, lo[kk], db, 1);
    }
  };
  int it = 0;
  int n = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    const int q0 = (item % q_tiles) * kItemRows;
    const int h = (item / q_tiles) % heads;
    const int b = item / q_tiles / heads;
    const int qb = n & 1;
    mbar_wait(&sm.q_full[qb], (n / 2) & 1);
    if (q0 + kWgRows * wg >= tq) {
      // No query of this warpgroup lies inside Tq (the ragged last item):
      // it only keeps the stages' accounting.
      mbar_arrive(&sm.q_empty[qb]);
      for (int j = 0; j < n_tiles; ++j, ++it) {
        mbar_wait(&sm.full[it % NS], (it / NS) & 1);
        mbar_arrive(&sm.empty[it % NS]);
      }
      continue;
    }
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;

    // Tile 0: S, its softmax, P.
    mbar_wait(&sm.full[it % NS], (it / NS) & 1);
    wgmma_fence();
    issue_s(qb, it % NS);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    if (n_tiles == 1) mbar_arrive(&sm.q_empty[qb]);
    softmax_tile(s, m, l, 0, tk, pair, scale_log2);
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
      const float2 alpha = softmax_tile(s, m, l, j * kWgRows, tk, pair, scale_log2);
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

    // Epilogue: o / l in bf16 to shared memory, swizzled as the store's
    // tensor map reads it, then one TMA store a slab and warpgroup; rows
    // past Tq and columns past D lie outside o and are not written. lse
    // straight from registers.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    if (wg_leader) bulk_wait<true>();  // the previous item's store has read o
    named_barrier(1 + wg, 128);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = kWgRows * wg + 16 * warp + quad + 8 * r;
      const float inv = 1.f / l[r];
#pragma unroll
      for (int c = 0; c < DP / 8; ++c) {
        uint8_t* tile = reinterpret_cast<uint8_t*>(&sm.o[c / (SLAB / 8)][0][0]);
        *reinterpret_cast<__nv_bfloat162*>(tile + swizzled<SW>(row, c % (SLAB / 8)) +
                                           4 * pair) =
            __floats2bfloat162_rn(o[4 * c + 2 * r] * inv, o[4 * c + 2 * r + 1] * inv);
      }
      const int t = q0 + row;
      if (pair == 0 && t < tq) {
        lse[((long long)b * heads + h) * tq + t] = (m[r] + log2f(l[r])) * kLn2;
      }
    }
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    if (wg_leader) {
#pragma unroll
      for (int sl = 0; sl < NSLAB; ++sl) {
        tma_store_4d(&out_map, &sm.o[sl][kWgRows * wg][0], SLAB * sl, h,
                     q0 + kWgRows * wg, b);
      }
      bulk_commit();
    }
  }
  if (wg_leader) bulk_wait<false>();
}

template <int DP, int NWG>
int launch_wgmma(const void* const* qkv, void* out, float* lse, const long long* strides,
                 int batch, int tq, int tk, int heads, int dim, float scale,
                 cudaStream_t stream) {
  constexpr int NS = wg_stages<DP, NWG>();
  // q, k and v with their own byte strides, o contiguous [B, Tq, H, D].
  const int seqs[3] = {tq, tk, tk};
  CUtensorMap maps[4];
  for (int i = 0; i < 3; ++i) {
    if (!make_view_map<DP>(&maps[i], qkv[i], batch, seqs[i], heads, dim, strides + 3 * i)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (!make_view_map<DP>(&maps[3], out, batch, tq, heads, dim, nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = flash_fwd_wgmma<DP, NWG, NS>;
  const int smem = static_cast<int>(sizeof(WgSmem<DP, NWG, NS>)) + 1024;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  static const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  // A persistent grid: one block an SM walks the work items.
  const long long items =
      (long long)batch * heads * ((tq + kWgRows * NWG - 1) / (kWgRows * NWG));
  if (items >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = items < sms ? static_cast<int>(items) : sms;
  kernel<<<grid, NWG * 128 + 32, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], lse,
                                                  batch, tq, tk, heads, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int NK>
int launch_bf16(const View<const bf16>* qkv, void* out, float* lse, int batch, int tq,
                int tk, int heads, int dim, float scale, cudaStream_t stream) {
  constexpr int bytes = fwd_smem_bytes<NK>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16<NK>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(((tq + kTile - 1) / kTile) * FwdSplit<NK>::kSplits, heads, batch);
  flash_fwd_bf16<NK><<<grid, kMmaThreads, bytes, stream>>>(
      qkv[0], qkv[1], qkv[2], static_cast<bf16*>(out), lse, tq, tk, heads, dim, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int NCH, int L, int BK>
int launch_f32(const View<const float>* qkv, void* out, float* lse, int batch, int tq,
               int tk, int heads, int dim, float scale, cudaStream_t stream) {
  constexpr int R = kFmaThreads / L;
  const dim3 grid((tq + R - 1) / R, heads, batch);
  flash_fwd_f32<NCH, L, BK><<<grid, kFmaThreads, 0, stream>>>(
      qkv[0], qkv[1], qkv[2], static_cast<float*>(out), lse, tq, tk, heads, dim, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
void make_views(View<const T> views[3], const void* q, const void* k, const void* v,
                const long long* strides) {
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    views[i] = View<const T>{static_cast<const T*>(ptrs[i]), strides[3 * i],
                             strides[3 * i + 1], strides[3 * i + 2]};
  }
}

}  // namespace

// Plain C entry point for ctypes. `strides` holds the batch, token and head
// strides (in elements) of q, k and v, in that order (9 values); o is a
// contiguous [B, Tq, H, D] and lse a contiguous [B*H, Tq] f32. Launches on
// `stream` and returns cudaGetLastError() after the launch (0 on success).
// is_bf16 selects __nv_bfloat16 over float for q, k, v and o.
extern "C" int vaw_flash_fwd(const void* q, const void* k, const void* v, void* out,
                             void* lse, const long long* strides, int batch, int tq,
                             int tk, int heads, int dim, float scale, int is_bf16,
                             void* stream) {
  if (batch <= 0 || tq <= 0 || tk <= 0 || heads <= 0 || dim <= 0 || dim % 8 != 0 ||
      dim > 256 || batch > 65535 || heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (!is_bf16) {
    View<const float> views[3];
    make_views<float>(views, q, k, v, strides);
    if (dim <= 32) return launch_f32<2, 4, 32>(views, out, l, batch, tq, tk, heads, dim, scale, s);
    if (dim <= 64) return launch_f32<4, 4, 32>(views, out, l, batch, tq, tk, heads, dim, scale, s);
    if (dim <= 128) return launch_f32<8, 4, 32>(views, out, l, batch, tq, tk, heads, dim, scale, s);
    return launch_f32<8, 8, 16>(views, out, l, batch, tq, tk, heads, dim, scale, s);
  }
  View<const bf16> views[3];
  make_views<bf16>(views, q, k, v, strides);
#define VAW_CASE(NK) \
  case NK: return launch_bf16<NK>(views, out, l, batch, tq, tk, heads, dim, scale, s);
  switch ((dim + 15) / 16) {
    VAW_CASE(1) VAW_CASE(2) VAW_CASE(3) VAW_CASE(4) VAW_CASE(5) VAW_CASE(6) VAW_CASE(7)
    VAW_CASE(8) VAW_CASE(9) VAW_CASE(10) VAW_CASE(11) VAW_CASE(12) VAW_CASE(13)
    VAW_CASE(14) VAW_CASE(15) VAW_CASE(16)
  }
#undef VAW_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// Plain C entry point of the wgmma kernel, bf16 only: the contract of
// vaw_flash_fwd for D <= 128 and scale > 0 (the softmax takes its max on
// the raw scores), except that `strides` holds the head, token and batch
// strides of q, k and v in BYTES, in that order (9 values: each view's
// tensor map over [D, H, T, B], vaw_torch/ops/flash_attention.py:
// general_tensor_map). Launches on `stream` and returns cudaGetLastError()
// after the launch (0 on success), or cudaErrorInvalidValue for a call the
// kernel does not take or a tensor map cuTensorMapEncodeTiled refuses.
extern "C" int vaw_flash_fwd_wgmma(const void* q, const void* k, const void* v, void* out,
                                   void* lse, const long long* strides, int batch, int tq,
                                   int tk, int heads, int dim, float scale, void* stream) {
  if (batch <= 0 || tq <= 0 || tk <= 0 || heads <= 0 || dim <= 0 || dim % 8 != 0 ||
      dim > 128 || !(scale > 0.f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const void* qkv[3] = {q, k, v};
#define VAW_LAUNCH(DP)                                                                 \
  launch_wgmma<DP, wg_consumers<DP>()>(qkv, out, l, strides, batch, tq, tk, heads, dim, \
                                       scale, s)
  if (dim <= 32) return VAW_LAUNCH(32);
  if (dim <= 64) return VAW_LAUNCH(64);
  return VAW_LAUNCH(128);
#undef VAW_LAUNCH
}
