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
// exponentials (LDM: 128 x 8 heads of 32, 1.07 G of them, 0.26 ms) bind. At
// the DiT-B/2 sampling shape (B = 128, T = 256, H = 12, D = 64, the views of
// the packed projection [B, T, 3*H*D]) one call moves 151 MB of qkv and
// 50 MB of o, 61 us, against 26 us of products: the bytes bind there too.
//
// In f32 at REPA's teacher shape (B = 256, T = 257, H = 12, D = 64) one call
// moves 811 MB (0.24 ms) and does 51.9 GFLOP: 0.78 ms on plain f32 FMAs at
// 67 TFLOP/s, 0.31 ms as three TF32 passes at 495 TFLOP/s, so the
// operations bind.
//
// Design. The TPU kernel holds the whole (padded) K/V sequence of several
// (batch, head) rows in VMEM and walks 256-key blocks of it. Here the keys
// stream through in 64-key tiles with an online softmax (running max and
// sum), so any T works. Four kernels, chosen by the call
// (vaw_torch/ops/flash_attention.py:flash_fwd_design):
//
// wgmma (bf16 with D <= 128 and scale > 0: every bf16 model call, the
// fused attention's (the DiT's) on the packed row's three views,
// vaw_torch/ops/flash_attention.py:_fused_forward, included), for Hopper:
// - Loads. One 4-D TMA tensor map for each of q, k and v views it as
//   [D, H, T, B] (innermost first) with that view's own byte strides
//   (vaw_torch/ops/flash_attention.py:general_tensor_map), so the views of
//   a packed projection are read in place; a box is 64 rows of one slab of
//   the head dim. A head dim of 32 (LDM) is one 64-byte slab, swizzled 64
//   bytes wide, so it is neither padded nor multiplied twice; one of 72
//   (the XL models: DiT-XL/2, U-ViT-H/2, ViT-XL) is a 128-byte slab of 64
//   columns and a 32-byte slab of 16, swizzled 32 bytes wide and read
//   through a tensor map of its own, so it pads to 80 and not to 128 (S
//   takes five 16-deep steps, P.V a wgmma N = 64 and an N = 16; on an
//   H100 faster than the 128-wide pad and than five 16-column slabs of one
//   32-byte swizzle); others are 128-byte slabs of 64 columns (D = 40 pads
//   to 64, D = 96 to 128).
//   TMA fills columns past D and rows past T with zeros: the ragged key
//   tail is masked to -inf, the query tail is never stored.
// - Pipeline. A persistent block on each SM walks work items of 64 * NWG
//   queries of one (b, h). One producer warp loads each item's q (two
//   buffers) and streams K and V through a ring of stages guarded by full
//   and empty mbarriers. NWG consumer warpgroups take 64 queries each and
//   read every stage, so K and V are read once per item. NWG is the call's
//   (vaw_torch/ops/flash_attention.py:flash_fwd_consumers, a rule of Tq
//   set from timings on an H100): two or three for D <= 64 (three hide
//   more of the softmax's latencies, ptxas then allowing 128 registers a
//   thread; two waste no rows where Tq is a multiple of 128, such as the
//   DiT's 256, where three leave a third of the last 192-query item
//   empty), two for D in (64, 128] (168 registers a thread). A warpgroup
//   whose 64 rows all lie past Tq (the last item at T = 258) only keeps
//   the stages' accounting, or computes rows that are never stored where
//   that ran faster (wg_skips_idle).
// - Key tiles. KT = 128 keys a tile where the head dim is at most 64, the
//   block runs two consumer warpgroups and Tk is a multiple of 128 (the
//   DiT's 256, LDM's and ADM-64's 1024), 64 elsewhere (at T = 258 128-key
//   tiles would compute 384 keys, a third of them masked, against 320; with
//   three warpgroups, or above 64 columns, S's 64 floats would spill):
//   the launch plan's choice (flash_attention.py:flash_fwd_key_tile). A
//   128-key tile halves the barrier round trips and O's rescales a key.
// - Products. S = q k^T is wgmma.m64nKTk16 with both operands K-major in
//   shared memory; O += P v is wgmma.m64nDPk16 with P from registers (the
//   S accumulator's layout is the A fragment's) and v as the MN-major B
//   operand as it lies, KT / 16 steps. A warpgroup issues tile j's S before
//   tile j-1's P v, so the tensor cores run the product while the softmax
//   runs. P stays f32 for the softmax and the row sums and enters P.V as
//   one bf16 term, rounded to nearest once (as FlashAttention and SDPA
//   round it; hopper_common.cuh:round_p): 2 units of tensor work a score,
//   where two terms (hi + lo) took 3, and o's max error against the f32
//   plain version equal to SDPA's at every model shape timed on an H100
//   80GB HBM3 at 700 W (PERF.md).
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
// tf32x3 (f32 with D <= 128, scale > 0 and views TMA maps: every f32 model
// call, also the fused forward's f32 calls on the packed row's views), for
// Hopper: the wgmma design's pipeline on f32 tiles, with each product taken
// as three TF32 passes (3xTF32). Every f32 operand is x = hi + lo: hi is x
// rounded to TF32 (to nearest, hopper_common.cuh:tf32_hi), lo = x - hi,
// exact in f32 and rounded in turn; hi.hi + hi.lo + lo.hi (the small terms
// first) in f32 accumulators miss a product by about 2^-22 of it (the lo.lo
// term), so the error stays at f32 level, where one TF32 pass would keep 3
// digits.
// - Loads. A 4-D tensor map a view, as in the wgmma design, with f32 boxes
//   of 128-byte rows (32 floats), 128-byte swizzled: a head dim of 64 is two
//   slabs. TMA zero-fills columns past D and rows past T.
// - Operands. TF32 wgmma reads both shared-memory operands K-major only. q
//   and K as they lie ([token][d]) are K-major for S = q k^T; each consumer
//   warpgroup holds its rows of q's hi half as A fragments in registers (in
//   shared memory at D = 128) and writes its lo half once an item. V as it
//   lies is MN-major for P V, so V^T's hi and lo halves are written, with
//   K's (its hi half in place), once a tile for all consumers. V^T holds each 8-key group in the order
//   of the S accumulator's columns (0, 2, 4, 6, 1, 3, 5, 7), so P enters
//   P.V as the A operand from registers with no shuffles.
// - Pipeline. A persistent block on each SM walks work items of 64 * NWG
//   queries of one (b, h). A producer warpgroup: one thread loads q and
//   streams K and V through NS stages; its other three warps split each
//   tile into one of two buffers (full and empty mbarriers each), so the
//   next tile is split while the consumers multiply this one. Two consumer
//   warpgroups on 64-key tiles for D <= 64, with setmaxnreg moving
//   registers from the producer (56 a thread) to them (224: O, S and P's
//   two fragments); one on 32-key tiles for D = 128 (224 KB of shared
//   memory either way). P_{j-1} V_{j-1} runs before S_j, so the last
//   tile's split buffer is free early; the softmax is the wgmma design's, in
//   f32; o is stored from registers.
// fma (other f32 calls: D > 128, scale <= 0, a stride-0 view): plain FMAs
// with every operand f32, q * scale formed at load as the TPU kernel does.
// L = 4 neighbouring threads share one query for D <= 128 (8 for larger
// D), each holding a 1/L share of q and of the accumulator.

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
// computed), NS stages of KT keys of K and V, and o staged for its TMA
// store; each tile its slabs one after another (AttnGeo), every 64-row box
// of a slab a multiple of 1024 bytes, so every box starts on the swizzle's
// period.
template <int DP, int NWG, int KT, int NS>
struct WgSmem {
  bf16 q[2][kWgRows * NWG * DP];
  bf16 k[NS][KT * DP];
  bf16 v[NS][KT * DP];
  bf16 o[kWgRows * NWG * DP];
  uint64_t q_full[2];
  uint64_t q_empty[2];
  uint64_t full[NS];
  uint64_t empty[NS];
};

// K/V stages of KT keys that fit beside q and o, at most 8.
template <int DP, int NWG, int KT>
constexpr int wg_stages() {
  constexpr int fixed = 3 * kWgRows * NWG * DP * 2;
  constexpr int room = (kSmemBudget - fixed) / (2 * KT * DP * 2);
  return room > 8 ? 8 : room;
}

// Whether a consumer warpgroup none of whose rows lies inside Tq skips the
// item (keeping only the stages' accounting) or computes rows on TMA's zero
// fill that are never stored. Set from timings on an H100: the skip pays
// with three warpgroups (the DiT's T = 256 leaves a third of an item idle)
// and at DP = 80 (DiT-XL/2's forward ran 7 % slower without it, though no
// row idles at its T = 256); with two at DP <= 64 the branch cost the loop
// a tenth of its speed at every T, idle rows or none; at DP = 128 it made
// no difference.
template <int DP, int NWG>
__host__ __device__ constexpr bool wg_skips_idle() { return NWG > 2 || DP == 80; }

// KT keys a tile: 64, or 128 for DP <= 64 with two consumer warpgroups.
template <int DP, int NWG, int KT, int NS>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
flash_fwd_wgmma(const __grid_constant__ ViewMaps<DP> q_map,
                const __grid_constant__ ViewMaps<DP> k_map,
                const __grid_constant__ ViewMaps<DP> v_map,
                const __grid_constant__ ViewMaps<DP> out_map, float* __restrict__ lse,
                int batch, int tq, int tk, int heads, float scale) {
  static_assert(KT == 64 || (KT == 128 && DP <= 64 && NWG == 2), "key tile of 64 or 128");
  using G = AttnGeo<DP>;
  constexpr uint32_t kTileBytes = kWgRows * DP * 2;  // 64 rows of every slab
  constexpr int kConsumers = 128 * NWG;
  constexpr int kItemRows = kWgRows * NWG;
  using Smem = WgSmem<DP, NWG, KT, NS>;
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  const int tid = threadIdx.x;
  const int n_tiles = (tk + KT - 1) / KT;
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
      for (int m = 0; m < G::kMaps; ++m) {
        prefetch_tensor_map(&q_map.m[m]);
        prefetch_tensor_map(&k_map.m[m]);
        prefetch_tensor_map(&v_map.m[m]);
      }
      int it = 0;
      int n = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
        const int q0 = (item % q_tiles) * kItemRows;
        const int h = (item / q_tiles) % heads;
        const int b = item / q_tiles / heads;
        const int qb = n & 1;
        if (n >= 2) mbar_wait(&sm.q_empty[qb], (n / 2 - 1) & 1);
        mbar_arrive_expect_tx(&sm.q_full[qb], NWG * kTileBytes);
        attn_load<DP>(sm.q[qb], &q_map, &sm.q_full[qb], kItemRows, h, q0, b);
        for (int j = 0; j < n_tiles; ++j, ++it) {
          const int stage = it % NS;
          if (it >= NS) mbar_wait(&sm.empty[stage], (it / NS - 1) & 1);
          mbar_arrive_expect_tx(&sm.full[stage], 2 * (KT / kWgRows) * kTileBytes);
          attn_load<DP>(sm.k[stage], &k_map, &sm.full[stage], KT, h, j * KT, b);
          attn_load<DP>(sm.v[stage], &v_map, &sm.full[stage], KT, h, j * KT, b);
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
  float s[KT / 2];                  // S of one key tile: 64 rows x KT keys
  uint32_t p[KT / 16][4];           // P of the previous tile in bf16 (round_p)
  float m[2], l[2];                 // running max (log2 domain) and this thread's sum

  // S = q k^T into s for the tile in `stage` (issued, not waited for): 16
  // columns of the head dim a step, 32 bytes along a slab's rows; one
  // wgmma N = KT.
  auto issue_s = [&](int qb, int stage) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint64_t da = attn_k_desc<DP>(smem_u32(sm.q[qb]), kItemRows, kWgRows * wg, kk);
      const uint64_t db = attn_k_desc<DP>(smem_u32(sm.k[stage]), KT, 0, kk);
      Wgmma<KT>::template ss<0, 0>(s, da, db, kk > 0);
    }
  };
  // O += P v for the tile in `stage`: v [key][d] is the MN-major B operand,
  // 16 keys a step.
  auto issue_pv = [&](int stage) {
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      attn_mn_rs<DP>(o, p[kk], smem_u32(sm.v[stage]), KT, 16 * kk);
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
    if (wg_skips_idle<DP, NWG>() && q0 + kWgRows * wg >= tq) {
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
    round_p(s, p);
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
      const float2 alpha = softmax_tile(s, m, l, j * KT, tk, pair, scale_log2);
      wgmma_wait<0>();  // P_{j-1} v_{j-1} is in
      fence_regs(o);
      fence_p(p);
      mbar_arrive(&sm.empty[prev]);
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] *= ((i >> 1) & 1) ? alpha.y : alpha.x;
      round_p(s, p);
    }
    const int last = (it + n_tiles - 1) % NS;
    wgmma_fence();
    issue_pv(last);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_p(p);
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
        *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<uint8_t*>(sm.o) +
                                           attn_chunk<DP>(kItemRows, row, c) + 4 * pair) =
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
      attn_store<DP>(&out_map, sm.o, kItemRows, kWgRows * wg, h, q0 + kWgRows * wg, b);
      bulk_commit();
    }
  }
  if (wg_leader) bulk_wait<false>();
}

template <int DP, int NWG, int KT>
int launch_wgmma(const void* const* qkv, void* out, float* lse, const long long* strides,
                 int batch, int tq, int tk, int heads, int dim, float scale,
                 cudaStream_t stream) {
  constexpr int NS = wg_stages<DP, NWG, KT>();
  // q, k and v with their own byte strides, o contiguous [B, Tq, H, D].
  const int seqs[3] = {tq, tk, tk};
  ViewMaps<DP> maps[4];
  for (int i = 0; i < 3; ++i) {
    if (!make_view_maps<DP>(&maps[i], qkv[i], batch, seqs[i], heads, dim,
                            strides + 3 * i)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (!make_view_maps<DP>(&maps[3], out, batch, tq, heads, dim, nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = flash_fwd_wgmma<DP, NWG, KT, NS>;
  const int smem = static_cast<int>(sizeof(WgSmem<DP, NWG, KT, NS>)) + 1024;
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

// ------------------------------------------------------------ f32, 3xTF32
// Shared memory of the 3xTF32 forward: q and q's lo half for one work item
// of 64 * NWG queries, NS stages of K and V as TMA lands them, and two
// buffers of one tile's split (K's lo half, V^T and V^T's lo half, written
// by the producer warpgroup). Every tile is a box of 128-byte rows (32
// floats), 128-byte swizzled, a multiple of 4096 bytes.
template <int DP, int NWG, int KT, int NS>
struct Tf32Smem {
  static constexpr int kSlabs = DP / 32;     // 32-float slabs of the head dim
  static constexpr int kKeySlabs = KT / 32;  // 32-key slabs of a V^T row
  float q[kSlabs][kWgRows * NWG][32];
  float q_lo[kSlabs][kWgRows * NWG][32];
  float k[NS][kSlabs][KT][32];
  float v[NS][kSlabs][KT][32];
  float k_lo[2][kSlabs][KT][32];
  float vt[2][kKeySlabs][DP][32];     // V^T: row d, a tile's keys along it
  float vt_lo[2][kKeySlabs][DP][32];
  uint64_t q_full;
  uint64_t q_empty;
  uint64_t full[NS];
  uint64_t empty[NS];
  uint64_t split_full[2];
  uint64_t split_empty[2];
};

// K/V stages that fit beside the rest, at most 4.
template <int DP, int NWG, int KT>
constexpr int tf32_stages() {
  constexpr int fixed = (2 * kWgRows * NWG * DP + 2 * 3 * KT * DP) * 4;
  constexpr int room = (kSmemBudget - fixed) / (2 * KT * DP * 4);
  return room > 4 ? 4 : room;
}

// Consumer warpgroups and keys of a tile by head dim: two warpgroups on
// 64-key tiles up to D = 64 (224 KB of shared memory at D = 64), one on
// 32-key tiles at D = 128, which keeps the same 224 KB and its 64-float
// accumulator beside P's fragments. Up to D = 64 q's hi half is the A
// operand of S from registers (a TF32 product reading A from shared memory
// ran markedly slower); at D = 128 it would spill. q's lo half stays in
// shared memory: in registers it spilled and ran slower.
template <int DP>
struct Tf32Config {
  static constexpr int kWarpgroups = DP == 128 ? 1 : 2;
  static constexpr int kKeys = DP == 128 ? 32 : 64;
  static constexpr bool kQInRegs = DP <= 64;
};

template <int DP, int NWG, int KT, int NS, bool QREG>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
flash_fwd_tf32x3(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map, float* __restrict__ out,
                 float* __restrict__ lse, int batch, int tq, int tk, int heads, int dim,
                 float scale) {
  static_assert(NS >= 2, "two K/V stages at least");
  using Smem = Tf32Smem<DP, NWG, KT, NS>;
  constexpr int NSLAB = Smem::kSlabs;
  constexpr int kConsumers = 128 * NWG;
  constexpr int kSplitters = 96;  // warps 1-3 of the producer warpgroup
  constexpr int kItemRows = kWgRows * NWG;
  constexpr uint32_t kQBox = kWgRows * 128;  // bytes of a q box: 64 rows of a slab
  constexpr uint32_t kKvBox = KT * 128;
  constexpr int kKeySteps = KT / 8;  // k8 steps of P.V over a tile's keys
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  const int tid = threadIdx.x;
  const int n_tiles = (tk + KT - 1) / KT;
  const int q_tiles = (tq + kItemRows - 1) / kItemRows;
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
    // item's q once the consumers have read the last one, K and V up to NS
    // stages ahead. Warps 1-3 split each tile of K and V, once for all
    // consumers, into one of two buffers.
    if constexpr (NWG == 2) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kTf32SplitRegs));
    }
    const int pt = tid - kConsumers;
    if (pt == 0) {
      prefetch_tensor_map(&q_map);
      prefetch_tensor_map(&k_map);
      prefetch_tensor_map(&v_map);
      int it = 0;
      int n = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
        const int q0 = (item % q_tiles) * kItemRows;
        const int h = (item / q_tiles) % heads;
        const int b = item / q_tiles / heads;
        if (n >= 1) mbar_wait(&sm.q_empty, (n - 1) & 1);
        mbar_arrive_expect_tx(&sm.q_full, NWG * NSLAB * kQBox);
#pragma unroll
        for (int s = 0; s < NSLAB; ++s) {
#pragma unroll
          for (int w = 0; w < NWG; ++w) {
            tma_load_4d(&sm.q[s][kWgRows * w][0], &q_map, &sm.q_full, 32 * s, h,
                        q0 + kWgRows * w, b);
          }
        }
        for (int j = 0; j < n_tiles; ++j, ++it) {
          const int stage = it % NS;
          if (it >= NS) mbar_wait(&sm.empty[stage], (it / NS - 1) & 1);
          mbar_arrive_expect_tx(&sm.full[stage], 2 * NSLAB * kKvBox);
#pragma unroll
          for (int s = 0; s < NSLAB; ++s) {
            tma_load_4d(&sm.k[stage][s][0][0], &k_map, &sm.full[stage], 32 * s, h, j * KT, b);
            tma_load_4d(&sm.v[stage][s][0][0], &v_map, &sm.full[stage], 32 * s, h, j * KT, b);
          }
        }
      }
    } else if (pt >= 32) {
      // A splitter. K: its hi half in place and its lo half, elementwise on
      // the tile as it lies (the swizzled layout is K's). V^T's hi and lo
      // halves a warp taking 32 keys (one a lane) by 4 columns a step: one
      // 16-byte read of the key's row, four 4-byte writes of each half at
      // the key's place in rows d .. d + 3, in the order split_p_tf32 gives
      // P's fragments (0, 2, 4, 6, 1, 3, 5, 7 in each 8-key group). Both
      // conflict-free under the swizzle.
      const int st = pt - 32;
      const int lane = st % 32;
      const int pos = 8 * (lane / 8) + 4 * (lane & 1) + (lane % 8) / 2;
      const int tiles = (items - static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) - 1) /
                        static_cast<int>(gridDim.x) * n_tiles;
      for (int it = 0; it < tiles; ++it) {
        const int stage = it % NS;
        const int db = it & 1;
        mbar_wait(&sm.full[stage], (it / NS) & 1);
        if (it >= 2) mbar_wait(&sm.split_empty[db], ((it >> 1) - 1) & 1);
        float4* ks = reinterpret_cast<float4*>(&sm.k[stage][0][0][0]);
        float4* kl = reinterpret_cast<float4*>(&sm.k_lo[db][0][0][0]);
        for (int i = st; i < NSLAB * KT * 8; i += kSplitters) {
          const float4 x = ks[i];
          ks[i] = make_float4(tf32_hi(x.x), tf32_hi(x.y), tf32_hi(x.z), tf32_hi(x.w));
          kl[i] = make_float4(tf32_lo(x.x), tf32_lo(x.y), tf32_lo(x.z), tf32_lo(x.w));
        }
        for (int blk = st / 32; blk < (KT / 32) * (DP / 4); blk += kSplitters / 32) {
          const int kslab = blk / (DP / 4);
          const int c4 = blk % (DP / 4);  // 16-byte chunk of the head dim
          const uint8_t* vrow = reinterpret_cast<const uint8_t*>(&sm.v[stage][c4 / 8][0][0]);
          const float4 x =
              *reinterpret_cast<const float4*>(vrow + swizzled<128>(32 * kslab + lane, c4 % 8));
          uint8_t* hi = reinterpret_cast<uint8_t*>(&sm.vt[db][kslab][0][0]);
          uint8_t* lo = reinterpret_cast<uint8_t*>(&sm.vt_lo[db][kslab][0][0]);
          const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint32_t at = swizzled<128>(4 * c4 + e, pos / 4) + 4 * (pos % 4);
            *reinterpret_cast<float*>(hi + at) = tf32_hi(xs[e]);
            *reinterpret_cast<float*>(lo + at) = tf32_lo(xs[e]);
          }
        }
        fence_proxy_async();  // the writes, before the consumers' wgmma reads
        mbar_arrive(&sm.split_full[db]);
        mbar_arrive(&sm.empty[stage]);
      }
    }
    return;
  }

  // A consumer warpgroup: query rows 64 * wg .. of each work item; this
  // thread holds rows r0 and r0 + 8 of them (the accumulator layout).
  if constexpr (NWG == 2) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kTf32MmaRegs));
  }
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int quad = lane / 4;
  const int pair = lane % 4;
  const float scale_log2 = scale * kLog2e;

  float o[DP / 2];
  float s[KT / 2];                                    // S of one key tile
  uint32_t p_hi[kKeySteps][4], p_lo[kKeySteps][4];  // P of the previous tile
  uint32_t q_hi[DP / 8][4];                         // q's hi half (QREG)
  float m[2], l[2];  // running max (log2 domain) and this thread's sum

  // q's hi half as A fragments for this item: step kk holds columns
  // 8 * kk + t % 4 and + 4 of rows r0 and r0 + 8, read from the swizzled
  // tile (conflict-free: 8 rows, 8 distinct 16-byte chunks).
  auto load_q = [&]() {
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int r = kWgRows * wg + 16 * warp + quad + 8 * (f & 1);
        const int c = 8 * kk + pair + 4 * (f >> 1);
        const float x = *reinterpret_cast<const float*>(
            reinterpret_cast<const uint8_t*>(&sm.q[c / 32][0][0]) +
            swizzled<128>(r, (c % 32) / 4) + 4 * (c % 4));
        q_hi[kk][f] = __float_as_uint(tf32_hi(x));
      }
    }
  };
  // S = q k^T into s (issued, not waited for): 8 columns of the head dim a
  // step, lo.hi + hi.lo + hi.hi, the small terms first.
  auto issue_s = [&](int stage, int db) {
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
      const int sl = kk / 4;
      const int at = 32 * (kk % 4);
      const uint64_t qa = desc_k_major<128>(
          reinterpret_cast<const uint8_t*>(&sm.q[sl][kWgRows * wg][0]) + at);
      const uint64_t qa_lo = desc_k_major<128>(
          reinterpret_cast<const uint8_t*>(&sm.q_lo[sl][kWgRows * wg][0]) + at);
      const uint64_t kb = desc_k_major<128>(
          reinterpret_cast<const uint8_t*>(&sm.k[stage][sl][0][0]) + at);
      const uint64_t kb_lo = desc_k_major<128>(
          reinterpret_cast<const uint8_t*>(&sm.k_lo[db][sl][0][0]) + at);
      WgmmaTf32<KT>::ss(s, qa_lo, kb, kk > 0);
      if constexpr (QREG) {
        WgmmaTf32<KT>::rs(s, q_hi[kk], kb_lo, 1);
        WgmmaTf32<KT>::rs(s, q_hi[kk], kb, 1);
      } else {
        WgmmaTf32<KT>::ss(s, qa, kb_lo, 1);
        WgmmaTf32<KT>::ss(s, qa, kb, 1);
      }
    }
  };
  // Keeps q's fragments live (unmoved) until the S product that reads them
  // is in.
  auto fence_q = [&]() {
    if constexpr (QREG) {
#pragma unroll
      for (int kk = 0; kk < DP / 8; ++kk) fence_regs(q_hi[kk]);
    }
  };
  // O += P v for the tile split into `db`: V^T is the K-major B operand, 8
  // keys a step, lo.hi + hi.lo + hi.hi.
  auto issue_pv = [&](int, int db) {
#pragma unroll
    for (int kk = 0; kk < kKeySteps; ++kk) {
      const int at = 32 * (kk % 4);
      const uint64_t vb = desc_k_major<128>(
          reinterpret_cast<const uint8_t*>(&sm.vt[db][kk / 4][0][0]) + at);
      const uint64_t vb_lo = desc_k_major<128>(
          reinterpret_cast<const uint8_t*>(&sm.vt_lo[db][kk / 4][0][0]) + at);
      WgmmaTf32<DP>::rs(o, p_lo[kk], vb, 1);
      WgmmaTf32<DP>::rs(o, p_hi[kk], vb_lo, 1);
      WgmmaTf32<DP>::rs(o, p_hi[kk], vb, 1);
    }
  };

  int it = 0;
  int n = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    const int q0 = (item % q_tiles) * kItemRows;
    const int h = (item / q_tiles) % heads;
    const int b = item / q_tiles / heads;
    mbar_wait(&sm.q_full, n & 1);
    if (q0 + kWgRows * wg >= tq) {
      // No query of this warpgroup lies inside Tq (the ragged last item):
      // it only keeps the barriers' accounting, each arrival after the
      // phase it belongs to has begun.
      mbar_arrive(&sm.q_empty);
      for (int j = 0; j < n_tiles; ++j, ++it) {
        mbar_wait(&sm.full[it % NS], (it / NS) & 1);
        mbar_arrive(&sm.empty[it % NS]);
        mbar_wait(&sm.split_full[it & 1], (it >> 1) & 1);
        mbar_arrive(&sm.split_empty[it & 1]);
      }
      continue;
    }
    if constexpr (QREG) load_q();
    // This warpgroup's rows of q's lo half in shared memory (and its hi
    // half in place where q is read from there), elementwise on the tile
    // as it lies (the swizzled layout is q's).
#pragma unroll
    for (int sl = 0; sl < NSLAB; ++sl) {
      float4* src = reinterpret_cast<float4*>(&sm.q[sl][kWgRows * wg][0]);
      float4* dst = reinterpret_cast<float4*>(&sm.q_lo[sl][kWgRows * wg][0]);
#pragma unroll
      for (int i = tid % 128; i < kWgRows * 8; i += 128) {
        const float4 x = src[i];
        if constexpr (!QREG) {
          src[i] = make_float4(tf32_hi(x.x), tf32_hi(x.y), tf32_hi(x.z), tf32_hi(x.w));
        }
        dst[i] = make_float4(tf32_lo(x.x), tf32_lo(x.y), tf32_lo(x.z), tf32_lo(x.w));
      }
    }
    fence_proxy_async();
    named_barrier(1 + wg, 128);
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
    tf32x3_walk<true, NS, DP, KT>(o, s, p_hi, p_lo, m, l, it, n_tiles, tk, pair, scale_log2,
                                  sm.full, sm.empty, sm.split_full, sm.split_empty,
                                  &sm.q_empty, issue_s, issue_pv, fence_q);

    // Epilogue: o / l straight from registers into the contiguous
    // [B, Tq, H, D] o (8 bytes a thread, each 32-byte sector whole); rows
    // past Tq and columns past D are not written. lse from the row owners.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = q0 + kWgRows * wg + 16 * warp + quad + 8 * r;
      if (t >= tq) continue;
      const float inv = 1.f / l[r];
      float* orow = out + (((long long)b * tq + t) * heads + h) * dim;
#pragma unroll
      for (int c = 0; c < DP / 8; ++c) {
        const int col = 8 * c + 2 * pair;
        if (col < dim) {
          *reinterpret_cast<float2*>(orow + col) =
              make_float2(o[4 * c + 2 * r] * inv, o[4 * c + 2 * r + 1] * inv);
        }
      }
      if (pair == 0) lse[((long long)b * heads + h) * tq + t] = (m[r] + log2f(l[r])) * kLn2;
    }
  }
}

template <int DP>
int launch_tf32x3(const void* const* qkv, void* out, float* lse, const long long* strides,
                  int batch, int tq, int tk, int heads, int dim, float scale,
                  cudaStream_t stream) {
  constexpr int NWG = Tf32Config<DP>::kWarpgroups;
  constexpr int KT = Tf32Config<DP>::kKeys;
  constexpr bool QREG = Tf32Config<DP>::kQInRegs;
  constexpr int NS = tf32_stages<DP, NWG, KT>();
  const int seqs[3] = {tq, tk, tk};
  const int rows[3] = {kWgRows, KT, KT};
  CUtensorMap maps[3];
  for (int i = 0; i < 3; ++i) {
    if (!make_view_map_f32(&maps[i], qkv[i], batch, seqs[i], heads, dim, strides + 3 * i,
                           rows[i])) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  auto kernel = flash_fwd_tf32x3<DP, NWG, KT, NS, QREG>;
  const int smem = static_cast<int>(sizeof(Tf32Smem<DP, NWG, KT, NS>)) + 1024;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  static const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const long long items =
      (long long)batch * heads * ((tq + kWgRows * NWG - 1) / (kWgRows * NWG));
  if (items >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = items < sms ? static_cast<int>(items) : sms;
  kernel<<<grid, (NWG + 1) * 128, smem, stream>>>(maps[0], maps[1], maps[2],
                                                  static_cast<float*>(out), lse, batch, tq,
                                                  tk, heads, dim, scale);
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
// general_tensor_map); `consumers` is the block's consumer warpgroups:
// 2 or 3 for D <= 64, 2 above (their accumulators alone are 40 and 64
// registers at 80 and 128 wide); `key_tile` the keys of a streamed tile,
// 64, or 128 for D <= 64 with two consumers (with three, S's 64 floats
// spill; flash_attention.py:flash_fwd_key_tile). Launches on `stream` and
// returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a call the kernel does not take or a tensor map
// cuTensorMapEncodeTiled refuses.
extern "C" int vaw_flash_fwd_wgmma(const void* q, const void* k, const void* v, void* out,
                                   void* lse, const long long* strides, int batch, int tq,
                                   int tk, int heads, int dim, float scale, int consumers,
                                   int key_tile, void* stream) {
  if (batch <= 0 || tq <= 0 || tk <= 0 || heads <= 0 || dim <= 0 || dim % 8 != 0 ||
      dim > 128 || !(scale > 0.f) || (consumers != 2 && (consumers != 3 || dim > 64)) ||
      (key_tile != 64 && (key_tile != 128 || consumers != 2 || dim > 64))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const void* qkv[3] = {q, k, v};
#define VAW_LAUNCH(DP, NWG, KT) \
  launch_wgmma<DP, NWG, KT>(qkv, out, l, strides, batch, tq, tk, heads, dim, scale, s)
  if (key_tile == 128) return dim <= 32 ? VAW_LAUNCH(32, 2, 128) : VAW_LAUNCH(64, 2, 128);
  if (dim <= 32) return consumers == 2 ? VAW_LAUNCH(32, 2, 64) : VAW_LAUNCH(32, 3, 64);
  if (dim <= 64) return consumers == 2 ? VAW_LAUNCH(64, 2, 64) : VAW_LAUNCH(64, 3, 64);
  if (dim <= 80) return VAW_LAUNCH(80, 2, 64);
  return VAW_LAUNCH(128, 2, 64);
#undef VAW_LAUNCH
}

// Plain C entry point of the 3xTF32 kernel, f32 only: the contract of
// vaw_flash_fwd_wgmma (D <= 128, scale > 0, `strides` the head, token and
// batch strides of q, k and v in BYTES) with f32 q, k, v and o. Launches on
// `stream` and returns cudaGetLastError() after the launch (0 on success),
// or cudaErrorInvalidValue for a call the kernel does not take or a tensor
// map cuTensorMapEncodeTiled refuses.
extern "C" int vaw_flash_fwd_tf32x3(const void* q, const void* k, const void* v, void* out,
                                    void* lse, const long long* strides, int batch, int tq,
                                    int tk, int heads, int dim, float scale, void* stream) {
  if (batch <= 0 || tq <= 0 || tk <= 0 || heads <= 0 || dim <= 0 || dim % 8 != 0 ||
      dim > 128 || !(scale > 0.f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const void* qkv[3] = {q, k, v};
  if (dim <= 32) return launch_tf32x3<32>(qkv, out, l, strides, batch, tq, tk, heads, dim, scale, s);
  if (dim <= 64) return launch_tf32x3<64>(qkv, out, l, strides, batch, tq, tk, heads, dim, scale, s);
  return launch_tf32x3<128>(qkv, out, l, strides, batch, tq, tk, heads, dim, scale, s);
}
