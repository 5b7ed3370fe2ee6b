// Multi-head softmax attention over the d-major packed projection, forward
// only.
//
// Replaces vaw_tpu/ops/flash_attention.py:_fwd_kernel_p5 (the forward of
// _flash_p5, the zero-copy packed kernel). Same contract:
//   f5  [B, 3, H, D, T] contiguous (bf16 or f32): q, k and v are its three
//       sections, each head a [D, T] matrix with T the unit stride. D % 8 == 0
//       and D <= 128; T % 8 == 0 (the JAX gate admits T = 256 only).
//   o   [B*H, D, T] contiguous, d-major, in the input dtype.
//   lse [B*H, T] f32, the natural-log log-sum-exp of the scaled scores, kept
//       for the backward.
//   Scores, softmax and the P.V sums are f32. A ragged key tail is masked and
//   a ragged query tail is neither written nor counted.
//
// Bound. At the LDM sampling shape (B = 128 with CFG, T = 256, H = 16,
// D = 32, bf16) one call reads 101 MB of q, k and v and writes 34 MB of o
// and 2 MB of lse, 41 us at 3.35 TB/s; its 4*B*H*T*T*D = 17.2 GFLOP take
// 17 us at the bf16 tensor-core peak of 989 TFLOP/s. So it is memory-bound
// at that shape.
//
// In f32 at LDM's shape (B = 128, T = 256, H = 16, D = 32) one call moves
// 67.6 MB (0.020 ms) and does 17.2 GFLOP: 0.257 ms on plain f32 FMAs at 67
// TFLOP/s, 0.104 ms as three TF32 passes at 495 TFLOP/s, so the operations
// bind.
//
// Design. The TPU kernel holds the whole K/V of a few (batch, head) rows in
// VMEM. Four kernels here, chosen by the call (vaw_torch/ops/
// flash_attention.py:flash_p5_fwd_design):
//
// wgmma (bf16, the sampling and training path), for Hopper:
// - Loads. One 5-D TMA tensor map views f5 as (T, D, H, 3, B), innermost
//   first, with a box of 64 tokens (128 bytes, swizzled) x DP rows of D, DP
//   = D rounded up to 16. The map's D extent is D, so TMA fills the pad rows
//   of D = 8, 24, 40, ... with zeros, and tokens past T (T % 64 != 0) too.
//   A tile lands d-major, [DP][64 tokens], as it lies in f5.
// - Work. A persistent block on each SM walks the work items: 128 queries
//   of one (b, h), half a head at T = 256. One producer warp loads each
//   item's q (two buffers, so the next item's q loads while this one is
//   computed) and streams the head's K and V in 64-key stages through a
//   ring (up to 8) guarded by full and empty mbarriers. Two consumer
//   warpgroups take 64 queries each and read every stage, so K and V are
//   read once per item.
// - Products. S = q k^T is wgmma.m64n64k16 with both operands read
//   MN-major from the d-major tiles (imm-trans-a for q [d][query],
//   imm-trans-b for k [d][key]), DP / 16 steps. O += P v is
//   wgmma.m64nDPk16 with P from registers and v [d][key] as the K-major B
//   operand as it lies (N = DP). A warpgroup issues tile j's S before tile
//   j-1's P v, so the tensor cores run the product while the softmax runs.
//   P stays f32 for the softmax and enters P.V as two bf16 terms, hi = P
//   cut to bf16 and lo = bf16(P - hi), about 16 significant bits.
// - Softmax in registers, in the log2 domain: ex2.approx.ftz, the scale
//   folded into one FFMA (the max is taken on the raw scores, so the
//   kernel takes scale > 0), the mask only in a ragged key tile. At D = 32
//   its instructions, about nine an element of S (max, FFMA, exp2, sum and
//   the hi/lo split), and not the bytes set the pace: a call stays near
//   three times its byte bound. Four consumer warpgroups a block, deeper q
//   and K/V rings, and loads issued by a consumer thread instead of a
//   producer warp were each no faster.
// - o goes to shared memory transposed, a [DP][64 queries] swizzled tile a
//   warpgroup, and out by a 3-D TMA store over o (T, D, B*H), which writes
//   neither rows past D nor tokens past T; lse from the row owners.
//
// mma.sync (bf16 with scale <= 0): one thread block takes one (b, h,
// 64-query tile) and streams 64-key tiles of k and v with an online
// softmax, as flash_fwd.cu does, every tile staged d-major ([D][64 tokens]
// rows, 16-byte copies along T). Four warps, 16 query rows each,
// mma.sync m16n8k16 with f32 accumulators: the d-major q and k are read
// with ldmatrix .trans, the d-major v is the column-major B operand as it
// lies. The head dim is zero-padded to a multiple of 16 in shared memory.
// o is staged back d-major through shared memory so its stores also run
// along T.
// tf32x3 (f32 with D <= 64 and scale > 0, at or above the crossover's
// score tiles), for Hopper: the wgmma design's ring on f32 tiles with each
// product taken as three TF32 passes, hi.hi + hi.lo + lo.hi with x = hi +
// lo, hi and lo rounded to TF32 (hopper_common.cuh:tf32_hi; about 2^-22 of
// a product from the exact one), the consumers' walk over the key tiles
// the general 3xTF32 forward's (hopper_common.cuh:tf32x3_walk).
// - Loads. The 5-D map over f5 with f32 boxes of 32 tokens (128 bytes,
//   swizzled) x DP rows of d (DP = 32 or 64, rows past D zero-filled); an
//   item is 128 queries of one (b, h), a tile 64 keys.
// - Operands. TF32 wgmma reads shared-memory operands K-major only, and
//   the tiles land d-major. S = q k^T reduces over d: q enters as the A
//   operand, its hi half from registers (each consumer thread reads its
//   fragments from the raw tile) and its lo half from a [query][d] copy the
//   consumers write once an item; three splitter warps of the producer
//   warpgroup write each tile's K^T hi and lo halves ([key][d]). O += P v
//   reduces over keys: v [d][key] is K-major as it lies, so its hi half is
//   written in place and its lo half beside it, and P enters from
//   registers. K^T's rows hold each 8-key group in the order 0, 4, 1, 5,
//   2, 6, 3, 7, so that P's fragments (split_p_tf32) take keys in order.
// - Two consumer warpgroups of 64 queries; setmaxnreg moves registers from
//   the producer to them. Shared memory: 224 KB at D = 64 (two stages), 144
//   KB at D = 32 (four).
// - o from registers to the d-major o: each store instruction of a warp
//   writes 8 neighbouring queries of 4 rows of d, four whole 32-byte
//   sectors, so no shared-memory staging (none is left at D = 64); lse
//   from the row owners.
// f32 otherwise: plain FMAs with every operand f32, q * scale formed at load
// as the TPU kernel does; L = 4 neighbouring threads share one query, each
// holding a 1/L share of q and of the accumulator; k and v tiles are
// transposed into shared memory one value at a time.

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace vaw_flash;
using namespace vaw_hopper;
using bf16 = __nv_bfloat16;

constexpr int kLdT = kTile + kRowPad;  // a d-major row: 64 tokens and the pad

// ------------------------------------------------------------------ bf16
template <int NK>
constexpr int p5_fwd_smem_bytes() {
  return 3 * 16 * NK * kLdT * 2;
}

// NK: 16-wide steps of the head dim, zero-padded to 16 * NK (<= 128).
template <int NK>
__global__ void __launch_bounds__(kMmaThreads)
flash_p5_fwd_bf16(const bf16* __restrict__ f5, bf16* __restrict__ out,
                  float* __restrict__ lse, int heads, int dim, int seq, float scale) {
  constexpr int DP = 16 * NK;
  constexpr int NDO = 2 * NK;  // 8-wide output column tiles (all of D)
  extern __shared__ __align__(16) unsigned char smem[];
  bf16 (*qs)[kLdT] = reinterpret_cast<bf16 (*)[kLdT]>(smem);  // [DP][64] q^T
  bf16 (*ks)[kLdT] = qs + DP;
  bf16 (*vs)[kLdT] = ks + DP;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int quad = lane / 4;
  const int pair = lane % 4;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long head = (long long)dim * seq;
  const bf16* qb = f5 + ((long long)(3 * b) * heads + h) * head;
  const bf16* kb = qb + (long long)heads * head;
  const bf16* vb = kb + (long long)heads * head;
  const int qr = warp * 16;  // this warp's first query row in the tile

  stage_dmajor<kLdT>(qs, qb, seq, q0, DP, dim, tid);
  float acc[NDO][4];
#pragma unroll
  for (int nd = 0; nd < NDO; ++nd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;
  }
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  const float scale_log2 = scale * kLog2e;

  const int n_tiles = (seq + kTile - 1) / kTile;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kTile;
    __syncthreads();  // the previous tile has been consumed (and qs staged)
    stage_dmajor<kLdT>(ks, kb, seq, k0, DP, dim, tid);
    stage_dmajor<kLdT>(vs, vb, seq, k0, DP, dim, tid);
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
      load_a_trans<kLdT>(qa, qs, qr, kk, lane);
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, &ks[kk * 16 + (lane & 15)][nt * 8]);
        mma_16816(s[nt], qa, b0, b1);
      }
    }
    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * pair + (e & 1);
        s[nt][e] = key < seq ? s[nt][e] * scale_log2 : -INFINITY;
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

    // acc += P v, 16 keys a step: vs[d][key] is the column-major B operand
    // as it lies.
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_a(hi, lo, s, kk);
#pragma unroll
      for (int nd = 0; nd < NDO; ++nd) {
        const bf16* vrow = &vs[nd * 8 + quad][kk * 16 + 2 * pair];
        mma_16816(acc[nd], hi, ld_u32(vrow), ld_u32(vrow + 8));
        mma_16816(acc[nd], lo, ld_u32(vrow), ld_u32(vrow + 8));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float inv_l[2] = {1.f / l[0], 1.f / l[1]};
  __syncthreads();  // every warp is done with qs, ks and vs
  stage_acc_dmajor<NDO, kLdT>(qs, acc, qr, quad, pair, inv_l);
  __syncthreads();
  store_dmajor<kLdT>(out + ((long long)b * heads + h) * head, qs, seq, q0, 0, DP, dim, tid);
  if (pair == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + qr + quad + 8 * r;
      if (row < seq) {
        lse[((long long)b * heads + h) * seq + row] = (m[r] + log2f(l[r])) * kLn2;
      }
    }
  }
}

// ----------------------------------------------------------- bf16, wgmma
constexpr int kKeys = 64;                     // keys of a stage; queries of a warpgroup
constexpr int kConsumers = 2 * 128;           // two consumer warpgroups
constexpr int kItemQueries = 2 * kKeys;       // queries of a work item
constexpr int kWgThreads = kConsumers + 32;   // and one producer warp

// Stages of the K/V ring that fit beside q (two items) and o in 200 KB of
// shared memory, at most 8 (two work items' keys at T = 256).
template <int DP>
constexpr int p5_stages() {
  constexpr int tile = DP * kSwizzleRowBytes;
  constexpr int room = (200 * 1024 - 3 * 2 * tile) / (2 * tile);
  return room > 8 ? 8 : room;
}

// Shared memory of a block: q of two work items, NS stages of K and V and o
// staged for its TMA store, each tile [DP][64 tokens], 128-byte swizzled.
// Every tile is a multiple of 2048 bytes, so each starts on the swizzle's
// period.
template <int DP, int NS>
struct P5Smem {
  bf16 q[2][2][DP][64];
  bf16 k[NS][DP][64];
  bf16 v[NS][DP][64];
  bf16 o[2][DP][64];
  uint64_t q_full[2];
  uint64_t q_empty[2];
  uint64_t full[NS];
  uint64_t empty[NS];
};

template <int DP, int NS>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_p5_fwd_wgmma(const __grid_constant__ CUtensorMap f5_map,
                   const __grid_constant__ CUtensorMap out_map, float* __restrict__ lse,
                   int batch, int heads, int seq, float scale) {
  constexpr uint32_t kTileBytes = DP * kSwizzleRowBytes;
  using Smem = P5Smem<DP, NS>;
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  const int tid = threadIdx.x;
  const int n_tiles = (seq + kKeys - 1) / kKeys;
  const int q_tiles = (seq + kItemQueries - 1) / kItemQueries;
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
      prefetch_tensor_map(&f5_map);
      int it = 0;
      int k = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++k) {
        const int q0 = (item % q_tiles) * kItemQueries;
        const int h = (item / q_tiles) % heads;
        const int b = item / q_tiles / heads;
        const int qb = k & 1;
        if (k >= 2) mbar_wait(&sm.q_empty[qb], (k / 2 - 1) & 1);
        mbar_arrive_expect_tx(&sm.q_full[qb], 2 * kTileBytes);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          tma_load_5d(&sm.q[qb][half][0][0], &f5_map, &sm.q_full[qb], q0 + kKeys * half, 0,
                      h, 0, b);
        }
        for (int j = 0; j < n_tiles; ++j, ++it) {
          const int stage = it % NS;
          if (it >= NS) mbar_wait(&sm.empty[stage], (it / NS - 1) & 1);
          mbar_arrive_expect_tx(&sm.full[stage], 2 * kTileBytes);
          tma_load_5d(&sm.k[stage][0][0], &f5_map, &sm.full[stage], j * kKeys, 0, h, 1, b);
          tma_load_5d(&sm.v[stage][0][0], &f5_map, &sm.full[stage], j * kKeys, 0, h, 2, b);
        }
      }
    }
    return;
  }

  // A consumer warpgroup: queries 64 * wg .. of each work item. This
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
  // rows of d a step, 2048 bytes into both d-major tiles.
  auto issue_s = [&](int qb, int stage) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint64_t da = desc_mn_major(&sm.q[qb][wg][16 * kk][0], kTileBytes);
      const uint64_t db = desc_mn_major(&sm.k[stage][16 * kk][0], kTileBytes);
      Wgmma<64>::ss<1, 1>(s, da, db, kk > 0);
    }
  };
  // O += P v for the tile in `stage`: v [d][key] is the K-major B operand,
  // 16 keys (32 bytes along the row) a step, P's hi and lo halves one
  // product each.
  auto issue_pv = [&](int stage) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db =
          desc_k_major(reinterpret_cast<const uint8_t*>(&sm.v[stage][0][0]) + 32 * kk);
      Wgmma<DP>::template rs<0>(o, hi[kk], db, 1);
      Wgmma<DP>::template rs<0>(o, lo[kk], db, 1);
    }
  };
  int it = 0;
  int k = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++k) {
    const int q0 = (item % q_tiles) * kItemQueries;
    const int bh = item / q_tiles;
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

    // Epilogue: o / l in bf16 to shared memory transposed, d-major as the
    // store's tensor map reads it (row d, query q at byte 2 * q of the row,
    // its 16-byte chunk q / 8 stored at (q / 8) ^ (d % 8)), then one TMA
    // store a warpgroup. lse straight from registers.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    if (wg_leader) bulk_wait<true>();  // the previous item's store has read o
    named_barrier(1 + wg, 128);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * warp + quad + 8 * r;  // this thread's query in the tile
      const float inv = 1.f / l[r];
#pragma unroll
      for (int c = 0; c < DP / 8; ++c) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = 8 * c + 2 * pair + e;
          uint8_t* line = reinterpret_cast<uint8_t*>(&sm.o[wg][d][0]);
          *reinterpret_cast<bf16*>(line + 16 * ((row / 8) ^ (d % 8)) + 2 * (row % 8)) =
              __float2bfloat16_rn(o[4 * c + 2 * r + e] * inv);
        }
      }
      const int t = q0 + kKeys * wg + row;
      if (pair == 0 && t < seq) {
        lse[(long long)bh * seq + t] = (m[r] + log2f(l[r])) * kLn2;
      }
    }
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    if (wg_leader) {
      tma_store_3d(&out_map, &sm.o[wg][0][0], q0 + kKeys * wg, 0, bh);
      bulk_commit();
    }
  }
  if (wg_leader) bulk_wait<false>();
}

template <int DP>
int launch_wgmma(const void* f5, void* out, float* lse, int batch, int heads, int dim,
                 int seq, float scale, cudaStream_t stream) {
  constexpr int NS = p5_stages<DP>();
  // f5 as (T, D, H, 3, B) and o as (T, D, B*H), innermost first, strides
  // in bytes.
  const uint64_t head = 2ull * dim * seq;
  const uint64_t dims[5] = {static_cast<uint64_t>(seq), static_cast<uint64_t>(dim),
                            static_cast<uint64_t>(heads), 3, static_cast<uint64_t>(batch)};
  const uint64_t strides[4] = {2ull * seq, head, head * heads, 3 * head * heads};
  const uint32_t box[5] = {64, DP, 1, 1, 1};
  const uint64_t odims[3] = {dims[0], dims[1], static_cast<uint64_t>(batch) * heads};
  const uint64_t ostrides[2] = {2ull * seq, head};
  const uint32_t obox[3] = {64, DP, 1};
  CUtensorMap f5_map, out_map;
  if (!make_tensor_map(&f5_map, f5, 5, dims, strides, box) ||
      !make_tensor_map(&out_map, out, 3, odims, ostrides, obox)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = flash_p5_fwd_wgmma<DP, NS>;
  const int smem = static_cast<int>(sizeof(P5Smem<DP, NS>)) + 1024;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  static const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  // A persistent grid: one block an SM walks the work items.
  const long long items =
      (long long)batch * heads * ((seq + kItemQueries - 1) / kItemQueries);
  if (items >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = items < sms ? static_cast<int>(items) : sms;
  kernel<<<grid, kWgThreads, smem, stream>>>(f5_map, out_map, lse, batch, heads, seq, scale);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ f32, 3xTF32
constexpr int kTf32Keys = 64;                      // keys of a tile; queries of a warpgroup
constexpr int kTf32Budget = 232448 - 1024 - 256;  // less the alignment and barriers

// Shared memory of the 3xTF32 forward for a head dim padded to DP (32 or
// 64): an item's 128 queries as TMA lands them (four 32-query boxes,
// [DP][32], d-major), q's lo half [query][d] (the K-major A operand of S),
// NS stages of K and V as they land (two 32-key boxes each), and two
// buffers of one tile's split by the producer warpgroup: K^T's hi and lo
// halves [key][d] (the K-major B operand of S) and V's lo half (V's hi half
// is written in place: V [d][key] is the K-major B operand of P V as it
// lies). Every tile has 128-byte rows (32 floats), 128-byte swizzled, and
// is a multiple of 4096 bytes.
template <int DP, int NS>
struct P5Tf32Smem {
  static constexpr int kSlabs = DP / 32;  // 32-float slabs of the head dim
  float q[4][DP][32];
  float q_lo[kSlabs][2 * kTf32Keys][32];
  float k[NS][2][DP][32];
  float v[NS][2][DP][32];
  float kt[2][kSlabs][kTf32Keys][32];
  float kt_lo[2][kSlabs][kTf32Keys][32];
  float v_lo[2][2][DP][32];
  uint64_t q_full;
  uint64_t q_empty;
  uint64_t full[NS];
  uint64_t empty[NS];
  uint64_t split_full[2];
  uint64_t split_empty[2];
};

// K/V stages that fit beside the rest, at most 4: 2 at D = 64 (224 KB in
// all), 4 at D = 32 (144 KB).
template <int DP>
constexpr int p5_tf32_stages() {
  constexpr int stage = 2 * 2 * DP * 32 * 4;
  constexpr int fixed = static_cast<int>(sizeof(P5Tf32Smem<DP, 1>)) - stage;
  constexpr int room = (kTf32Budget - fixed) / stage;
  return room > 4 ? 4 : room;
}

template <int DP, int NS>
__global__ void __launch_bounds__(3 * 128, 1)
flash_p5_fwd_tf32x3(const __grid_constant__ CUtensorMap f5_map, float* __restrict__ out,
                    float* __restrict__ lse, int batch, int heads, int dim, int seq,
                    float scale) {
  static_assert(NS >= 2, "two K/V stages at least");
  using Smem = P5Tf32Smem<DP, NS>;
  constexpr int KT = kTf32Keys;
  constexpr int kConsumers = 2 * 128;
  constexpr int kSplitters = 96;      // warps 1-3 of the producer warpgroup
  constexpr int kItemRows = 2 * KT;   // queries of a work item
  constexpr uint32_t kBox = DP * 128;  // bytes of a box: 32 tokens of DP rows
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  const int tid = threadIdx.x;
  const int n_tiles = (seq + KT - 1) / KT;
  const int q_tiles = (seq + kItemRows - 1) / kItemRows;
  const int items = batch * heads * q_tiles;

  if (tid == 0) {
    mbar_init(&sm.q_full, 1);
    mbar_init(&sm.q_empty, kConsumers);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumers + kSplitters);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mbar_init(&sm.split_full[i], kSplitters);
      mbar_init(&sm.split_empty[i], kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // The producer warpgroup. Warp 0: one thread issues every load, each
    // item's q once the consumers have taken the last one into registers
    // and q_lo, K and V up to NS stages ahead. Warps 1-3 split each tile,
    // once for all consumers, into one of two buffers.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kTf32SplitRegs));
    const int pt = tid - kConsumers;
    if (pt == 0) {
      prefetch_tensor_map(&f5_map);
      int it = 0;
      int n = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
        const int q0 = (item % q_tiles) * kItemRows;
        const int h = (item / q_tiles) % heads;
        const int b = item / q_tiles / heads;
        if (n >= 1) mbar_wait(&sm.q_empty, (n - 1) & 1);
        mbar_arrive_expect_tx(&sm.q_full, 4 * kBox);
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          tma_load_5d(&sm.q[s][0][0], &f5_map, &sm.q_full, q0 + 32 * s, 0, h, 0, b);
        }
        for (int j = 0; j < n_tiles; ++j, ++it) {
          const int stage = it % NS;
          if (it >= NS) mbar_wait(&sm.empty[stage], (it / NS - 1) & 1);
          mbar_arrive_expect_tx(&sm.full[stage], 4 * kBox);
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            tma_load_5d(&sm.k[stage][s][0][0], &f5_map, &sm.full[stage], j * KT + 32 * s, 0,
                        h, 1, b);
            tma_load_5d(&sm.v[stage][s][0][0], &f5_map, &sm.full[stage], j * KT + 32 * s, 0,
                        h, 2, b);
          }
        }
      }
    } else if (pt >= 32) {
      // A splitter. K^T's hi and lo halves: a warp takes 32 keys (one a
      // lane) by 4 rows of d a step, four 4-byte reads along those rows
      // (each a whole row: conflict-free) and one 16-byte write of each
      // half into the key's row. The key goes to row `place` of its 8-key
      // group, so that S's column 8 g + 2 p + e holds key 8 g + p + 4 e:
      // P's fragment columns t % 4 and t % 4 + 4 (split_p_tf32 takes the
      // accumulator's columns 2 (t % 4) and + 1) are then keys in order, and
      // V serves P V as it lies. V: its hi half in place and its lo half,
      // elementwise on the tile as it lies.
      const int st = pt - 32;
      const int lane = st % 32;
      const int key = lane % 8;
      const int place = 8 * (lane / 8) + (key < 4 ? 2 * key : 2 * key - 7);
      const int tiles = (items - static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) - 1) /
                        static_cast<int>(gridDim.x) * n_tiles;
      for (int it = 0; it < tiles; ++it) {
        const int stage = it % NS;
        const int db = it & 1;
        mbar_wait(&sm.full[stage], (it / NS) & 1);
        if (it >= 2) mbar_wait(&sm.split_empty[db], ((it >> 1) - 1) & 1);
        for (int blk = st / 32; blk < 2 * (DP / 4); blk += kSplitters / 32) {
          const int ks = blk / (DP / 4);
          const int c4 = blk % (DP / 4);  // 16-byte chunk of a K^T row
          const uint8_t* raw = reinterpret_cast<const uint8_t*>(&sm.k[stage][ks][0][0]);
          float x[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            x[e] = *reinterpret_cast<const float*>(
                raw + swizzled<128>(4 * c4 + e, lane / 4) + 4 * (lane % 4));
          }
          const uint32_t at = swizzled<128>(32 * ks + place, c4 % 8);
          *reinterpret_cast<float4*>(reinterpret_cast<uint8_t*>(&sm.kt[db][c4 / 8][0][0]) +
                                     at) =
              make_float4(tf32_hi(x[0]), tf32_hi(x[1]), tf32_hi(x[2]), tf32_hi(x[3]));
          *reinterpret_cast<float4*>(reinterpret_cast<uint8_t*>(&sm.kt_lo[db][c4 / 8][0][0]) +
                                     at) =
              make_float4(tf32_lo(x[0]), tf32_lo(x[1]), tf32_lo(x[2]), tf32_lo(x[3]));
        }
        float4* vs = reinterpret_cast<float4*>(&sm.v[stage][0][0][0]);
        float4* vl = reinterpret_cast<float4*>(&sm.v_lo[db][0][0][0]);
        for (int i = st; i < 2 * DP * 8; i += kSplitters) {
          const float4 x = vs[i];
          vs[i] = make_float4(tf32_hi(x.x), tf32_hi(x.y), tf32_hi(x.z), tf32_hi(x.w));
          vl[i] = make_float4(tf32_lo(x.x), tf32_lo(x.y), tf32_lo(x.z), tf32_lo(x.w));
        }
        fence_proxy_async();  // the writes, before the consumers' wgmma reads
        mbar_arrive(&sm.split_full[db]);
        mbar_arrive(&sm.empty[stage]);
      }
    }
    return;
  }

  // A consumer warpgroup: queries 64 * wg .. of each work item; this thread
  // holds rows r0 and r0 + 8 of them (the accumulator layout).
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kTf32MmaRegs));
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int quad = lane / 4;
  const int pair = lane % 4;
  const float scale_log2 = scale * kLog2e;

  float o[DP / 2];
  float s[KT / 2];                                  // S of one key tile
  uint32_t p_hi[KT / 8][4], p_lo[KT / 8][4];      // P of the previous tile
  uint32_t q_hi[DP / 8][4];                         // q's hi half
  float m[2], l[2];  // running max (log2 domain) and this thread's sum

  // q's hi half as A fragments for this item: step kk holds columns (of d)
  // 8 * kk + t % 4 and + 4 of query rows r0 and r0 + 8, read from the
  // d-major tiles as they landed.
  auto load_q = [&]() {
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int r = KT * wg + 16 * warp + quad + 8 * (f & 1);
        const int c = 8 * kk + pair + 4 * (f >> 1);
        const float x = *reinterpret_cast<const float*>(
            reinterpret_cast<const uint8_t*>(&sm.q[r / 32][0][0]) +
            swizzled<128>(c, (r % 32) / 4) + 4 * (r % 4));
        q_hi[kk][f] = __float_as_uint(tf32_hi(x));
      }
    }
  };
  // S = q k^T into s (issued, not waited for): 8 columns of d a step,
  // lo.hi + hi.lo + hi.hi, the small terms first.
  auto issue_s = [&](int, int db) {
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
      const int sl = kk / 4;
      const int at = 32 * (kk % 4);
      const uint64_t qa_lo = desc_k_major<128>(
          reinterpret_cast<const uint8_t*>(&sm.q_lo[sl][KT * wg][0]) + at);
      const uint64_t kb =
          desc_k_major<128>(reinterpret_cast<const uint8_t*>(&sm.kt[db][sl][0][0]) + at);
      const uint64_t kb_lo =
          desc_k_major<128>(reinterpret_cast<const uint8_t*>(&sm.kt_lo[db][sl][0][0]) + at);
      WgmmaTf32<KT>::ss(s, qa_lo, kb, kk > 0);
      WgmmaTf32<KT>::rs(s, q_hi[kk], kb_lo, 1);
      WgmmaTf32<KT>::rs(s, q_hi[kk], kb, 1);
    }
  };
  auto fence_q = [&]() {
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) fence_regs(q_hi[kk]);
  };
  // O += P v for the tile in (stage, db): V [d][key] is the K-major B
  // operand, its hi half in the stage and its lo half in the split, 8 keys
  // a step, lo.hi + hi.lo + hi.hi.
  auto issue_pv = [&](int stage, int db) {
#pragma unroll
    for (int kk = 0; kk < KT / 8; ++kk) {
      const int at = 32 * (kk % 4);
      const uint64_t vb =
          desc_k_major<128>(reinterpret_cast<const uint8_t*>(&sm.v[stage][kk / 4][0][0]) + at);
      const uint64_t vb_lo =
          desc_k_major<128>(reinterpret_cast<const uint8_t*>(&sm.v_lo[db][kk / 4][0][0]) + at);
      WgmmaTf32<DP>::rs(o, p_lo[kk], vb, 1);
      WgmmaTf32<DP>::rs(o, p_hi[kk], vb_lo, 1);
      WgmmaTf32<DP>::rs(o, p_hi[kk], vb, 1);
    }
  };

  int it = 0;
  int n = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    const int q0 = (item % q_tiles) * kItemRows;
    const int bh = item / q_tiles;
    mbar_wait(&sm.q_full, n & 1);
    if (q0 + KT * wg >= seq) {
      // No query of this warpgroup lies inside T (the ragged last item):
      // it only keeps the barriers' accounting, each arrival after the
      // phase it belongs to has begun.
      mbar_arrive(&sm.q_empty);
      for (int j = 0; j < n_tiles; ++j, ++it) {
        mbar_wait(&sm.split_full[it & 1], (it >> 1) & 1);
        mbar_arrive(&sm.split_empty[it & 1]);
        mbar_arrive(&sm.empty[it % NS]);
      }
      continue;
    }
    load_q();
    // This warpgroup's rows of q's lo half, transposed to [query][d]: a
    // thread takes one query (32 neighbouring ones a warp: whole rows of
    // the raw tile) by 4 columns of d, one 16-byte write a step.
    for (int i = tid % 128; i < KT * (DP / 4); i += 128) {
      const int r = KT * wg + i % KT;
      const int c4 = i / KT;
      const uint8_t* raw = reinterpret_cast<const uint8_t*>(&sm.q[r / 32][0][0]);
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[e] = *reinterpret_cast<const float*>(
            raw + swizzled<128>(4 * c4 + e, (r % 32) / 4) + 4 * (r % 4));
      }
      *reinterpret_cast<float4*>(reinterpret_cast<uint8_t*>(&sm.q_lo[c4 / 8][0][0]) +
                                 swizzled<128>(r, c4 % 8)) =
          make_float4(tf32_lo(x[0]), tf32_lo(x[1]), tf32_lo(x[2]), tf32_lo(x[3]));
    }
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    mbar_arrive(&sm.q_empty);  // q's last read: its halves are in q_hi and q_lo
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
    tf32x3_walk<false, NS, DP, KT>(o, s, p_hi, p_lo, m, l, it, n_tiles, seq, pair,
                                   scale_log2, sm.full, sm.empty, sm.split_full,
                                   sm.split_empty, nullptr, issue_s, issue_pv, fence_q);

    // Epilogue: o / l straight from registers into the d-major o: for each
    // column d a warp writes 8 neighbouring queries, 32 bytes, so each
    // store instruction fills four whole sectors; rows past T and columns
    // past D are not written. lse from the row owners.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = q0 + KT * wg + 16 * warp + quad + 8 * r;
      if (t >= seq) continue;
      const float inv = 1.f / l[r];
      float* ob = out + (long long)bh * dim * seq + t;
#pragma unroll
      for (int c = 0; c < DP / 8; ++c) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = 8 * c + 2 * pair + e;
          if (d < dim) ob[(long long)d * seq] = o[4 * c + 2 * r + e] * inv;
        }
      }
      if (pair == 0) lse[(long long)bh * seq + t] = (m[r] + log2f(l[r])) * kLn2;
    }
  }
}

template <int DP>
int launch_tf32x3(const void* f5, void* out, float* lse, int batch, int heads, int dim,
                  int seq, float scale, cudaStream_t stream) {
  constexpr int NS = p5_tf32_stages<DP>();
  // f5 as (T, D, H, 3, B), innermost first, strides in bytes; a box is 32
  // tokens (128 bytes) of DP rows of d, rows past D zero-filled.
  const uint64_t head = 4ull * dim * seq;
  const uint64_t dims[5] = {static_cast<uint64_t>(seq), static_cast<uint64_t>(dim),
                            static_cast<uint64_t>(heads), 3, static_cast<uint64_t>(batch)};
  const uint64_t strides[4] = {4ull * seq, head, head * heads, 3 * head * heads};
  const uint32_t box[5] = {32, DP, 1, 1, 1};
  CUtensorMap f5_map;
  if (!make_tensor_map(&f5_map, f5, 5, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B,
                       CU_TENSOR_MAP_DATA_TYPE_FLOAT32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = flash_p5_fwd_tf32x3<DP, NS>;
  const int smem = static_cast<int>(sizeof(P5Tf32Smem<DP, NS>)) + 1024;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  static const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  // A persistent grid: one block an SM walks the work items.
  const long long items =
      (long long)batch * heads * ((seq + 2 * kTf32Keys - 1) / (2 * kTf32Keys));
  if (items >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = items < sms ? static_cast<int>(items) : sms;
  kernel<<<grid, 3 * 128, smem, stream>>>(f5_map, static_cast<float*>(out), lse, batch,
                                          heads, dim, seq, scale);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------- f32
// NCH 4-float chunks a thread, L threads a query, BK keys a streamed tile.
template <int NCH, int L, int BK>
__global__ void __launch_bounds__(kFmaThreads)
flash_p5_fwd_f32(const float* __restrict__ f5, float* __restrict__ out,
                 float* __restrict__ lse, int heads, int dim, int seq, float scale) {
  constexpr int DP = 4 * L * NCH;
  constexpr int R = kFmaThreads / L;  // queries per block
  __shared__ __align__(16) float ks[BK][DP];
  __shared__ __align__(16) float vs[BK][DP];

  const int tid = threadIdx.x;
  const int part = tid % L;
  const int qrow = blockIdx.x * R + tid / L;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bool q_valid = qrow < seq;
  const long long head = (long long)dim * seq;
  const float* qb = f5 + ((long long)(3 * b) * heads + h) * head;
  const float* kb = qb + (long long)heads * head;
  const float* vb = kb + (long long)heads * head;

  float qr[NCH][4], acc[NCH][4];
  load_row<NCH, L>(qr, qb + qrow, q_valid, dim, part, scale, seq);
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;
  zero_pad<BK, DP>(ks, vs, dim, tid);

  const int n_tiles = (seq + BK - 1) / BK;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();  // the previous tile has been consumed
    stage_cols<BK, DP>(ks, kb, seq, k0, dim, 1.f, tid);
    stage_cols<BK, DP>(vs, vb, seq, k0, dim, 1.f, tid);
    __syncthreads();

    float s[BK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float dot = row_dot<NCH, L>(qr, ks[j], part);
      s[j] = (k0 + j < seq) ? dot * kLog2e : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);  // finite: a valid key per tile
    const float alpha = exp2f(m - m_new);    // 0 on the first tile
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
    store_row<NCH, L>(out + ((long long)b * heads + h) * head + qrow, acc, dim, part,
                      1.f / l, seq);
    if (part == 0) {
      lse[((long long)b * heads + h) * seq + qrow] = (m + log2f(l)) * kLn2;
    }
  }
}

template <int NK>
int launch_bf16(const void* f5, void* out, float* lse, int batch, int heads, int dim,
                int seq, float scale, cudaStream_t stream) {
  constexpr int bytes = p5_fwd_smem_bytes<NK>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_p5_fwd_bf16<NK>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq + kTile - 1) / kTile, heads, batch);
  flash_p5_fwd_bf16<NK><<<grid, kMmaThreads, bytes, stream>>>(
      static_cast<const bf16*>(f5), static_cast<bf16*>(out), lse, heads, dim, seq, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int NCH, int L, int BK>
int launch_f32(const void* f5, void* out, float* lse, int batch, int heads, int dim,
               int seq, float scale, cudaStream_t stream) {
  constexpr int R = kFmaThreads / L;
  const dim3 grid((seq + R - 1) / R, heads, batch);
  flash_p5_fwd_f32<NCH, L, BK><<<grid, kFmaThreads, 0, stream>>>(
      static_cast<const float*>(f5), static_cast<float*>(out), lse, heads, dim, seq, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes. f5 is a contiguous [B, 3, H, D, T], o a
// contiguous [B*H, D, T] and lse a contiguous [B*H, T] f32. Launches on
// `stream` and returns cudaGetLastError() after the launch (0 on success).
// is_bf16 selects __nv_bfloat16 over float for f5 and o.
extern "C" int vaw_flash_p5_fwd(const void* f5, void* out, void* lse, int batch,
                                int heads, int dim, int seq, float scale, int is_bf16,
                                void* stream) {
  if (batch <= 0 || heads <= 0 || seq <= 0 || seq % 8 != 0 || dim <= 0 || dim % 8 != 0 ||
      dim > 128 || batch > 65535 || heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (!is_bf16) {
    if (dim <= 32) return launch_f32<2, 4, 32>(f5, out, l, batch, heads, dim, seq, scale, s);
    if (dim <= 64) return launch_f32<4, 4, 32>(f5, out, l, batch, heads, dim, seq, scale, s);
    return launch_f32<8, 4, 32>(f5, out, l, batch, heads, dim, seq, scale, s);
  }
#define VAW_CASE(NK) \
  case NK: return launch_bf16<NK>(f5, out, l, batch, heads, dim, seq, scale, s);
  switch ((dim + 15) / 16) {
    VAW_CASE(1) VAW_CASE(2) VAW_CASE(3) VAW_CASE(4) VAW_CASE(5) VAW_CASE(6) VAW_CASE(7)
    VAW_CASE(8)
  }
#undef VAW_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// Plain C entry point of the wgmma kernel, bf16 only: the contract of
// vaw_flash_p5_fwd (f5 [B, 3, H, D, T], o [B*H, D, T], lse [B*H, T] f32)
// with scale > 0 (the softmax's max is taken on the raw scores). Launches
// on `stream` and returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue for what it does not take (or a
// tensor map the driver refuses).
extern "C" int vaw_flash_p5_fwd_wgmma(const void* f5, void* out, void* lse, int batch,
                                      int heads, int dim, int seq, float scale,
                                      void* stream) {
  if (batch <= 0 || heads <= 0 || seq <= 0 || seq % 8 != 0 || dim <= 0 || dim % 8 != 0 ||
      dim > 128 || !(scale > 0.f) || (long long)batch * heads * seq >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
#define VAW_CASE(NK) \
  case NK: return launch_wgmma<16 * NK>(f5, out, l, batch, heads, dim, seq, scale, s);
  switch ((dim + 15) / 16) {
    VAW_CASE(1) VAW_CASE(2) VAW_CASE(3) VAW_CASE(4) VAW_CASE(5) VAW_CASE(6) VAW_CASE(7)
    VAW_CASE(8)
  }
#undef VAW_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// Plain C entry point of the 3xTF32 kernel, f32 only: the contract of
// vaw_flash_p5_fwd (f5 [B, 3, H, D, T], o [B*H, D, T], lse [B*H, T] f32)
// with D <= 64 and scale > 0 (the softmax's max is taken on the raw
// scores). Launches on `stream` and returns cudaGetLastError() after the
// launch (0 on success), or cudaErrorInvalidValue for what it does not take
// (or a tensor map cuTensorMapEncodeTiled refuses).
extern "C" int vaw_flash_p5_fwd_tf32x3(const void* f5, void* out, void* lse, int batch,
                                       int heads, int dim, int seq, float scale,
                                       void* stream) {
  if (batch <= 0 || heads <= 0 || seq <= 0 || seq % 8 != 0 || dim <= 0 || dim % 8 != 0 ||
      dim > 64 || !(scale > 0.f) || (long long)batch * heads * seq >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dim <= 32) return launch_tf32x3<32>(f5, out, l, batch, heads, dim, seq, scale, s);
  return launch_tf32x3<64>(f5, out, l, batch, heads, dim, seq, scale, s);
}
