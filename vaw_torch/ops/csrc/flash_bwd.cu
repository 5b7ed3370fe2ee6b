// Backward of the general multi-head softmax attention: separate, strided
// q, k and v in, separate, strided dq, dk and dv out, any number of queries
// and keys.
//
// Replaces vaw_tpu/ops/flash_attention.py:_bwd_kernel (the backward of
// _flash, the general-T kernel). Same contract:
//   q [B, Tq, H, D], k and v [B, Tk, H, D] (bf16 or f32), views with their
//        own batch, token and head strides, as the forward reads them.
//   out, dout [B, Tq, H, D] contiguous, in the input dtype: the forward's
//        output and the incoming gradient.
//   lse  [B*H, Tq] f32, the forward's natural-log log-sum-exp.
//   dq [B, Tq, H, D], dk and dv [B, Tk, H, D] in the input dtype, written
//        through their own strides: three tensors, or the three thirds of
//        one packed [B, T, 3, H, D] gradient, with no concatenation.
// The math, all in f32 (vaw_tpu/ops/flash_attention.py:130-175):
//   q^ = q * scale, S = q^ k^T, P = exp(S - lse), delta = rowsum(dout * out),
//   dV = P^T dout, dS = P * (dout v^T - delta), dK = dS^T q^,
//   dQ = (dS k) * scale.
// delta is formed in f32 from the input-dtype out that the forward wrote.
// f32 accumulators, each gradient cast once to the input dtype at the end.
//
// Bound. At the U-ViT-L/2 training shape (B = 128, T = 258, H = 16, D = 64,
// bf16) one call reads 203 MB of q, k and v, 68 MB each of out and dout and
// 2 MB of lse, and writes 203 MB of dq, dk and dv: about 543 MB, or 162 us
// at 3.35 TB/s. Its five products are 10*B*H*T*T*D = 87 GFLOP, 88 us at the
// bf16 peak. So it is memory-bound at that shape; at T = 1024 the products
// bind.
//
// Design (deterministic, no atomics). The TPU kernel accumulates dK and dV
// across its sequential grid of query blocks; on the card blocks run in
// parallel, so the work is split into kernels that each own their outputs,
// run in order on one stream, and recompute S and dP where they need them.
// Four designs, chosen by the call (vaw_torch/ops/flash_attention.py:
// flash_bwd_design):
//
// wgmma (bf16 with D <= 128 and scale > 0: every model call, and also the
// fused attention's backward, whose packed [B, T, 3, H, D] row gives the
// six views, flash_attention.py:flash_attention_fused_bwd), for Hopper; TMA
// loads through 4-D tensor maps of each view (q, k, v, dq, dk, dv with
// their own byte strides; out and dout contiguous), the head dim in slabs
// as in flash_fwd.cu (hopper_common.cuh:AttnGeo: one slab, 64-byte
// swizzle, for D <= 32; one 128-byte slab for D <= 64; for the XL models'
// D = 72 a 128-byte slab of 64 columns and a 32-byte slab of 16, a map
// each, padded to 80; for UNet-64's D = 96 (and 88) a 128-byte slab of 64
// and a 64-byte slab of 32; for ViT-S's D = 128 (and 104-120) two 128-byte
// slabs; each padded by TMA's zero fill past D, never from the next head's
// columns of a packed row), persistent blocks of two consumer warpgroups
// and one producer warp (a producer warpgroup from D = 80, whose registers
// setmaxnreg moves to the consumers: 56 and 224 a thread) with a ring of
// stages:
//   1. dQ: an item is 128 queries of one (b, h); k and v stream through.
//      Each item first forms its rows' delta from out and dout (loaded
//      with q) and writes delta and lse (log2 domain) to a scratch the
//      next kernel reads; then per key tile S = q k^T and dP = dout v^T,
//      dS = P (dP - delta), dQ += dS k with dS from registers. Up to DP =
//      80 tile j's S and dP are issued before tile j-1's dS k; wider, a
//      warpgroup runs each tile's products in turn (dq_pipelined). At DP =
//      128 two items' q, dout and out and two K/V stages pass shared
//      memory, so a pre-pass (flash_bwd_rows) forms lse2 and delta and the
//      dQ kernel loads no out (delta_pass).
//   2. dK/dV: q, dout and their rows' lse and delta stream through. Per
//      query tile S^T = k q^T and dP^T = v dout^T, then dV += P^T dout and
//      dK += dS^T q with P^T and dS^T from registers; see the kernel for why
//      its tiles run in order. Up to DP = 80 an item is 128 keys, each
//      warpgroup accumulating dV and dK for 64 of them; from DP = 96 two
//      DP-wide accumulators and P's and dS's fragments do not fit a
//      warpgroup's registers, so an item is 64 keys and warpgroup 0
//      accumulates dV, warpgroup 1 dK, each over all DP columns
//      (dkdv_split). That recomputes S^T, a sixth more products than one
//      warpgroup doing both; halving the columns instead would recompute
//      S^T and dP^T, a third more. One bf16 term of P^T and dS^T (16
//      registers a fragment, not 32) still leaves one warpgroup of both at
//      DP = 96 spilling (520 bytes) and slower (0.0559 against 0.0377 ms
//      on the device at UNet-64's (128, 64, 4, 96), an H100 80GB HBM3 at
//      700 W; probes/_torch_bwd_variant.py --variant unsplit96), so the
//      split stays.
//   Both write their gradients by 4-D TMA stores through the gradients'
//   own strides (three tensors, or the thirds of one packed gradient).
//   P^T and dS (dS^T) stay f32 in registers and enter the three products
//   that reduce over them (dQ += dS k, dV += P^T dout, dK += dS^T q) as one
//   bf16 term, rounded to nearest once, as FlashAttention and SDPA round
//   them: 5 units of tensor work a score where hi + lo (two terms, each
//   product run twice) took 8. At every width each gradient's root mean
//   square error against the f32 plain version is SDPA's to 0.4 % (hi + lo:
//   0.71 times SDPA's) over the models' shapes and eight draws of the
//   inputs on an H100 80GB HBM3 at 700 W (PERF.md, the design gate;
//   probes/_torch_attention_ab.py --set gate --errors --draws 8; hi + lo is
//   probes/_torch_bwd_variant.py --variant hilo).
//   At D = 80 the products whose depth is D (S, dP and their transposes)
//   take five 16-deep steps, four on the 64-column slab and one on the
//   16-column slab, and those whose width is D (dQ += dS k, dV += P^T dout,
//   dK += dS^T q) a wgmma N = 64 and an N = 16 into the two parts of one
//   N = 80 accumulator (five 32-byte slabs of 16 columns, one swizzle for
//   all, ran slower on an H100, as did a producer warp instead of the
//   warpgroup); D = 96 likewise, N = 64 and N = 32. At DiT-XL/2's (128,
//   256, 16, 72) a call moves about 606 MB (0.181 ms at 3.35 TB/s) and does
//   96.6 GFLOP (0.098 ms at the bf16 peak), at ViT-S's (128, 258, 4, 128)
//   271 MB (0.081 ms) and 43.6 GFLOP (0.044 ms): bound by bytes.
//   The wide design was chosen on an H100 80GB HBM3 at 700 W by each
//   kernel's device ms a call (probes/_torch_attention_ab.py --set wide_new
//   --profile on trees from probes/_torch_bwd_variant.py, in one run). At
//   ViT-S's shape the dQ kernel ran 0.1705-0.1709 ms one tile at a time
//   against 0.2310 pipelined, and 0.1797 with setmaxnreg 24 / 240 instead
//   of 56 / 224 (the dK/dV kernel 0.219-0.221, the pre-pass 0.031, in
//   every variant). At UNet-64's (128, 64, 4, 96) the 96-wide tiles ran
//   0.0187-0.0190 (dQ) + 0.0156-0.0157 (dK/dV) against 128-wide ones'
//   0.0262 + 0.0184 and their pre-pass's 0.0077.
// tf32x3 (f32 with D <= 64, scale > 0, mapped views and work at or above
// the crossover, flash_attention.py:TF32X3_MIN_TILES: the classifier's
// T = 1024 blocks, every f32 model gradient's large calls), for Hopper's
// tensor cores: the wgmma pair's work items, scratch and order on f32
// operands, each of the five products as three TF32 passes (lo.hi + hi.lo
// + hi.hi; hi rounded to TF32 by hopper_common.cuh:tf32_hi, lo = x - hi
// rounded in turn: about 2^-22 of a product, where one pass misses it by
// up to 2^-11). Bound: at the classifier's (4, 1024, 6, 64) its 16.1 GFLOP
// take 0.098 ms as three TF32 passes at 495 TFLOP/s (0.240 ms on plain
// FMAs), its 50.4 MB 0.015 ms: bound by operations.
// - TF32 wgmma reads shared-memory operands K-major only. S = q k^T and
//   dP = dout v^T (and S^T, dP^T) read k, v (q, dout) as they lie; the
//   item's own rows (q and dout in the dQ kernel, k and v in the dK/dV
//   kernel) enter as A fragments from registers, read from the raw tiles
//   and split by each consumer thread, two head-dim steps in flight. dQ +=
//   dS k, dV += P^T dout and dK += dS^T q read k^T, dout^T and q^T: three
//   splitter warps of a producer warpgroup write the streamed tile's hi
//   half in place, its lo half, and its transpose's hi and lo halves (each
//   8-row group in the order of the accumulator's columns, so P and dS
//   enter as A fragments with no shuffles), into one of two buffers.
// - Shared memory: a 32-row tile of a 64-wide f32 head is 8 KB, and the
//   dK/dV kernel's split of q and dout (their lo halves, q^T's and dout^T's
//   halves) 48 KB a buffer; with the item's k and v (64 KB) and four stages
//   of q and dout (16.25 KB each) that is 225 KB of the 227. The dQ kernel
//   takes 192 KB. Streamed tiles are therefore 32 rows, not 64.
// - Registers: setmaxnreg gives the producer warpgroup 56 a thread and
//   the consumers 224. The dQ kernel issues tile j's S and dP before tile
//   j - 1's dS k has finished; the dK/dV warpgroup (two accumulators, P's
//   and dS's fragments) waits for its dV and dK products before the next
//   tile.
// - No atomics: each kernel owns its outputs, stored from registers
//   through each gradient's strides, so a repeat is bit-equal.
// - The kernels' bodies are shared with flash_p5_bwd.cu's 3xTF32 pair
//   (hopper_common.cuh:tf32x3_bwd_dq and tf32x3_bwd_dkdv); this file gives
//   them the layout of its tiles (GeneralTf).
// mma.sync (other bf16 calls: scale <= 0, D > 128, a view without a
// tensor map) and f32 otherwise (FMA), FlashAttention-2
// style: three kernels run in order on one stream:
//   1. delta: one thread per (b, t, h) query row, 16-byte loads.
//   2. dK/dV: one block per (b, h, 64-key tile, column split). Each of its
//      four warps owns 16 keys; the block loops over 64-query tiles of q and
//      dout staged in shared memory, recomputes S^T and P^T, and accumulates
//      dV and dK in registers; dK is multiplied by the scale at the end.
//   3. dQ: one block per (b, h, 64-query tile, column split), looping over
//      64-key tiles of k and v; dQ is multiplied by the scale at the end.
// Queries past Tq get lse = +inf in the dK/dV kernel and keys past Tk get
// P = 0 in the dQ kernel, so Tq != Tk works; both tails are zero-filled in
// shared memory. The scores need all of D, the dV, dK and dQ columns do
// not: a block owns at most 64 output columns (its two accumulators stay at
// <= 64 floats a thread), and for D > 64 the columns are split over blocks
// that each recompute the scores.
// bf16: mma.sync m16n8k16 with f32 accumulators, as the forward; the scale
// multiplies S in f32 and P and dS enter their products split into bf16
// hi + lo. f32: plain FMAs with every operand f32, q^ formed at load as the
// TPU kernel does; L = 4 threads share a row for D <= 128, 8 for larger D.

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace vaw_flash;
using namespace vaw_hopper;
using bf16 = __nv_bfloat16;

// delta[(b*H + h)*Tq + t] = sum_d dout[b, t, h, d] * out[b, t, h, d] in f32.
template <typename T>
__global__ void flash_bwd_delta(const T* __restrict__ out, const T* __restrict__ dout,
                                float* __restrict__ delta, long long rows, int tq,
                                int heads, int dim) {
  bwd_delta_row<T>(out, dout, delta, rows, tq, heads, dim);
}

// ------------------------------------------------------------------ bf16
template <int NK>
using BwdSplit = Split<NK, 8>;  // at most 64 output columns per block

template <int NK>
constexpr int bwd_smem_bytes() {
  return 4 * kTile * BwdSplit<NK>::LD * 2 + 2 * kTile * 4;
}

// NK: 16-wide steps of the head dim, zero-padded to 16 * NK.
template <int NK>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkdv_bf16(View<const bf16> q, View<const bf16> k, View<const bf16> v,
                    const bf16* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, View<bf16> dk_out,
                    View<bf16> dv_out, int tq, int tk, int heads, int dim,
                    float scale) {
  using S = BwdSplit<NK>;
  constexpr int NDO = S::NDO;
  constexpr int LD = S::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16 (*ks)[LD] = reinterpret_cast<bf16 (*)[LD]>(smem);
  bf16 (*vs)[LD] = ks + kTile;
  bf16 (*qs)[LD] = vs + kTile;
  bf16 (*dos)[LD] = qs + kTile;  // dout rows of the query tile
  float* lse_s = reinterpret_cast<float*>(dos + kTile);
  float* delta_s = lse_s + kTile;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int quad = lane / 4;
  const int pair = lane % 4;
  const int split = blockIdx.x % S::kSplits;
  const int k0 = (blockIdx.x / S::kSplits) * kTile;
  const int c0 = split * 8 * NDO;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hd = heads * dim;
  const bf16* qb = q.head(b, h);
  const bf16* dob = dout + (long long)b * tq * hd + (long long)h * dim;
  const float* lse_row = lse + ((long long)b * heads + h) * tq;
  const float* delta_row = delta + ((long long)b * heads + h) * tq;
  const int kr = warp * 16;  // this warp's first key row in the tile
  const float scale_log2 = scale * kLog2e;

  stage_tile<LD>(ks, k.head(b, h), k.st, k0, tk, 0, 16 * NK, dim, tid);
  stage_tile<LD>(vs, v.head(b, h), v.st, k0, tk, 0, 16 * NK, dim, tid);

  float dk[NDO][4], dv[NDO][4];
#pragma unroll
  for (int nd = 0; nd < NDO; ++nd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nd][e] = dv[nd][e] = 0.f;
  }

  const int n_tiles = (tq + kTile - 1) / kTile;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int q0 = tile * kTile;
    __syncthreads();  // the previous query tile has been consumed
    stage_tile<LD>(qs, qb, q.st, q0, tq, 0, S::kWidth, dim, tid);
    stage_tile<LD>(dos, dob, hd, q0, tq, 0, S::kWidth, dim, tid);
    for (int i = tid; i < kTile; i += kMmaThreads) {
      const bool valid = q0 + i < tq;
      lse_s[i] = valid ? lse_row[q0 + i] * kLog2e : INFINITY;  // P = 0 past Tq
      delta_s[i] = valid ? delta_row[q0 + i] : 0.f;
    }
    __syncthreads();

    // S^T = k q^T and dP^T = v dout^T: this warp's 16 keys x 64 queries.
    float st[kTile / 8][4], dpt[kTile / 8][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t ka[4], va[4];
      load_a<LD>(ka, ks, kr, kk, quad, pair);
      load_a<LD>(va, vs, kr, kk, quad, pair);
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt) {
        const bf16* qrow = &qs[nt * 8 + quad][kk * 16 + 2 * pair];
        mma_16816(st[nt], ka, ld_u32(qrow), ld_u32(qrow + 8));
        const bf16* drow = &dos[nt * 8 + quad][kk * 16 + 2 * pair];
        mma_16816(dpt[nt], va, ld_u32(drow), ld_u32(drow + 8));
      }
    }
    // P^T = exp(S^T - lse) and dS^T = P^T (dP^T - delta), per query column.
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * pair + (e & 1);
        const float p = exp2f(st[nt][e] * scale_log2 - lse_s[col]);
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - delta_s[col]);
      }
    }
    // dV += P^T dout and dK += dS^T q over this block's columns, 16
    // queries a step.
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t phi[4], plo[4], shi[4], slo[4];
      split_a(phi, plo, st, kk);
      split_a(shi, slo, dpt, kk);
#pragma unroll
      for (int nd = 0; nd < NDO; ++nd) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, &dos[kk * 16 + (lane & 15)][c0 + nd * 8]);
        mma_16816(dv[nd], phi, b0, b1);
        mma_16816(dv[nd], plo, b0, b1);
        ldmatrix_x2_trans(b0, b1, &qs[kk * 16 + (lane & 15)][c0 + nd * 8]);
        mma_16816(dk[nd], shi, b0, b1);
        mma_16816(dk[nd], slo, b0, b1);
      }
    }
  }

  bf16* dkb = dk_out.head(b, h);
  bf16* dvb = dv_out.head(b, h);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + kr + quad + 8 * r;
    if (key >= tk) continue;
#pragma unroll
    for (int nd = 0; nd < NDO; ++nd) {
      const int col = c0 + nd * 8 + 2 * pair;
      if (col < dim) {
        *reinterpret_cast<__nv_bfloat162*>(dkb + (long long)key * dk_out.st + col) =
            __floats2bfloat162_rn(dk[nd][2 * r] * scale, dk[nd][2 * r + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dvb + (long long)key * dv_out.st + col) =
            __floats2bfloat162_rn(dv[nd][2 * r], dv[nd][2 * r + 1]);
      }
    }
  }
}

template <int NK>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_bf16(View<const bf16> q, View<const bf16> k, View<const bf16> v,
                  const bf16* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ delta, View<bf16> dq_out, int tq, int tk,
                  int heads, int dim, float scale) {
  using S = BwdSplit<NK>;
  constexpr int NDO = S::NDO;
  constexpr int LD = S::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16 (*qs)[LD] = reinterpret_cast<bf16 (*)[LD]>(smem);
  bf16 (*dos)[LD] = qs + kTile;  // dout rows of this block's queries
  bf16 (*ks)[LD] = dos + kTile;
  bf16 (*vs)[LD] = ks + kTile;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int quad = lane / 4;
  const int pair = lane % 4;
  const int split = blockIdx.x % S::kSplits;
  const int q0 = (blockIdx.x / S::kSplits) * kTile;
  const int c0 = split * 8 * NDO;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hd = heads * dim;
  const bf16* kb = k.head(b, h);
  const bf16* vb = v.head(b, h);
  const long long lrow = ((long long)b * heads + h) * tq;
  const int qr = warp * 16;  // this warp's first query row in the tile
  const float scale_log2 = scale * kLog2e;

  stage_tile<LD>(qs, q.head(b, h), q.st, q0, tq, 0, 16 * NK, dim, tid);
  stage_tile<LD>(dos, dout + (long long)b * tq * hd + (long long)h * dim, hd, q0, tq, 0,
                 16 * NK, dim, tid);
  // lse (log2 domain) and delta of this thread's rows qr + quad (+ 8).
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + qr + quad + 8 * r;
    lse_r[r] = row < tq ? lse[lrow + row] * kLog2e : 0.f;
    delta_r[r] = row < tq ? delta[lrow + row] : 0.f;
  }

  float dq[NDO][4];
#pragma unroll
  for (int nd = 0; nd < NDO; ++nd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[nd][e] = 0.f;
  }

  const int n_tiles = (tk + kTile - 1) / kTile;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kTile;
    __syncthreads();  // the previous key tile has been consumed
    stage_tile<LD>(ks, kb, k.st, k0, tk, 0, S::kWidth, dim, tid);
    stage_tile<LD>(vs, vb, v.st, k0, tk, 0, 16 * NK, dim, tid);
    __syncthreads();

    // S = q k^T and dP = dout v^T: this warp's 16 queries x 64 keys.
    float s[kTile / 8][4], dp[kTile / 8][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t qa[4], da[4];
      load_a<LD>(qa, qs, qr, kk, quad, pair);
      load_a<LD>(da, dos, qr, kk, quad, pair);
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt) {
        const bf16* krow = &ks[nt * 8 + quad][kk * 16 + 2 * pair];
        mma_16816(s[nt], qa, ld_u32(krow), ld_u32(krow + 8));
        const bf16* vrow = &vs[nt * 8 + quad][kk * 16 + 2 * pair];
        mma_16816(dp[nt], da, ld_u32(vrow), ld_u32(vrow + 8));
      }
    }
    // dS = P (dP - delta), P = exp(S - lse), 0 for keys past Tk.
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * pair + (e & 1);
        const int r = e >> 1;
        const float p = key < tk ? exp2f(s[nt][e] * scale_log2 - lse_r[r]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - delta_r[r]);
      }
    }
    // dQ += dS k over this block's columns, 16 keys a step.
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_a(hi, lo, s, kk);
#pragma unroll
      for (int nd = 0; nd < NDO; ++nd) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, &ks[kk * 16 + (lane & 15)][c0 + nd * 8]);
        mma_16816(dq[nd], hi, b0, b1);
        mma_16816(dq[nd], lo, b0, b1);
      }
    }
  }

  bf16* dqb = dq_out.head(b, h);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + qr + quad + 8 * r;
    if (row >= tq) continue;
#pragma unroll
    for (int nd = 0; nd < NDO; ++nd) {
      const int col = c0 + nd * 8 + 2 * pair;
      if (col < dim) {
        *reinterpret_cast<__nv_bfloat162*>(dqb + (long long)row * dq_out.st + col) =
            __floats2bfloat162_rn(dq[nd][2 * r] * scale, dq[nd][2 * r + 1] * scale);
      }
    }
  }
}

// ------------------------------------------------------------------- f32
// NCH 4-float chunks a thread, L threads a row, BT rows a streamed tile.
template <int NCH, int L, int BT>
__global__ void __launch_bounds__(kFmaThreads)
flash_bwd_dkdv_f32(View<const float> q, View<const float> k, View<const float> v,
                   const float* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ delta, View<float> dk_out,
                   View<float> dv_out, int tq, int tk, int heads, int dim, float scale) {
  constexpr int DP = 4 * L * NCH;
  constexpr int R = kFmaThreads / L;  // keys per block
  __shared__ __align__(16) float qs[BT][DP];  // q^ = q * scale
  __shared__ __align__(16) float ds[BT][DP];  // dout
  __shared__ float lse_s[BT];
  __shared__ float delta_s[BT];

  const int tid = threadIdx.x;
  const int part = tid % L;
  const int key = blockIdx.x * R + tid / L;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hd = heads * dim;
  const float* qb = q.head(b, h);
  const float* dob = dout + (long long)b * tq * hd + (long long)h * dim;
  const long long lrow = ((long long)b * heads + h) * tq;
  const bool k_valid = key < tk;

  float kr[NCH][4], vr[NCH][4], dk[NCH][4], dv[NCH][4];
  load_row<NCH, L>(kr, k.head(b, h) + (long long)key * k.st, k_valid, dim, part, 1.f);
  load_row<NCH, L>(vr, v.head(b, h) + (long long)key * v.st, k_valid, dim, part, 1.f);
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;
  }
  zero_pad<BT, DP>(qs, ds, dim, tid);

  const int n_tiles = (tq + BT - 1) / BT;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int q0 = tile * BT;
    __syncthreads();
    stage_rows<BT, DP>(qs, qb, q.st, q0, tq, dim, scale, tid);
    stage_rows<BT, DP>(ds, dob, hd, q0, tq, dim, 1.f, tid);
    for (int i = tid; i < BT; i += kFmaThreads) {
      const bool valid = q0 + i < tq;
      lse_s[i] = valid ? lse[lrow + q0 + i] * kLog2e : INFINITY;  // P = 0 past Tq
      delta_s[i] = valid ? delta[lrow + q0 + i] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BT; ++j) {
      const float s = row_dot<NCH, L>(kr, qs[j], part);
      const float dp = row_dot<NCH, L>(vr, ds[j], part);
      const float p = exp2f(s * kLog2e - lse_s[j]);
      row_axpy<NCH, L>(dv, p, ds[j], part);
      row_axpy<NCH, L>(dk, p * (dp - delta_s[j]), qs[j], part);
    }
  }
  if (k_valid) {
    store_row<NCH, L>(dk_out.head(b, h) + (long long)key * dk_out.st, dk, dim, part, 1.f);
    store_row<NCH, L>(dv_out.head(b, h) + (long long)key * dv_out.st, dv, dim, part, 1.f);
  }
}

template <int NCH, int L, int BT>
__global__ void __launch_bounds__(kFmaThreads)
flash_bwd_dq_f32(View<const float> q, View<const float> k, View<const float> v,
                 const float* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, View<float> dq_out, int tq, int tk,
                 int heads, int dim, float scale) {
  constexpr int DP = 4 * L * NCH;
  constexpr int R = kFmaThreads / L;  // queries per block
  __shared__ __align__(16) float ks[BT][DP];
  __shared__ __align__(16) float vs[BT][DP];

  const int tid = threadIdx.x;
  const int part = tid % L;
  const int row = blockIdx.x * R + tid / L;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hd = heads * dim;
  const float* kb = k.head(b, h);
  const float* vb = v.head(b, h);
  const long long lrow = ((long long)b * heads + h) * tq;
  const bool q_valid = row < tq;

  float qr[NCH][4], d_o[NCH][4], dq[NCH][4];
  load_row<NCH, L>(qr, q.head(b, h) + (long long)row * q.st, q_valid, dim, part, scale);
  load_row<NCH, L>(d_o, dout + ((long long)b * tq + row) * hd + (long long)h * dim,
                   q_valid, dim, part, 1.f);
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[i][e] = 0.f;
  }
  const float lse_q = q_valid ? lse[lrow + row] * kLog2e : 0.f;
  const float delta_q = q_valid ? delta[lrow + row] : 0.f;
  zero_pad<BT, DP>(ks, vs, dim, tid);

  const int n_tiles = (tk + BT - 1) / BT;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BT;
    __syncthreads();
    stage_rows<BT, DP>(ks, kb, k.st, k0, tk, dim, 1.f, tid);
    stage_rows<BT, DP>(vs, vb, v.st, k0, tk, dim, 1.f, tid);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BT; ++j) {
      const float s = row_dot<NCH, L>(qr, ks[j], part);
      const float dp = row_dot<NCH, L>(d_o, vs[j], part);
      const float p = k0 + j < tk ? exp2f(s * kLog2e - lse_q) : 0.f;
      row_axpy<NCH, L>(dq, p * (dp - delta_q), ks[j], part);
    }
  }
  if (q_valid) {
    store_row<NCH, L>(dq_out.head(b, h) + (long long)row * dq_out.st, dq, dim, part, scale);
  }
}

// ----------------------------------------------------------- bf16, wgmma
constexpr int kWgRows = 64;                   // rows of a warpgroup, and of a stage
constexpr int kConsumers = 2 * 128;           // two consumer warpgroups
constexpr int kItemRows = 2 * kWgRows;        // queries (dQ) or keys (dK/dV) of an item
constexpr int kSmemBudget = 232448 - 1024 - 512;  // less the alignment and barriers

// The producer of a block: one warp for a head dim of up to 64 (the three
// warps that share a quarter of the register file leave 168 registers a
// thread); a whole warpgroup from DP = 80, so that setmaxnreg can move its
// registers to the consumers, whose accumulators grow from 32 to DP / 2
// floats (dQ's, and dK's and dV's each); on an H100 that ran faster at DP
// = 80 than a producer warp.
template <int DP>
__host__ __device__ constexpr bool producer_wg() { return DP > 64; }

template <int DP>
__host__ __device__ constexpr int wg_threads() {
  return kConsumers + (producer_wg<DP>() ? 128 : 32);
}

// Registers a thread keeps after setmaxnreg where the producer is a
// warpgroup (the wgmma pair from DP = 80): 56 in it, 224 in
// the two consumer warpgroups; 56 + 2 * 224 = 3 * 168, the 168 a thread
// that 384 threads get at launch.
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;

// Rows of the lse / delta scratch per (b, h): Tq rounded up to a work item.
__host__ __device__ constexpr long long padded_rows(int tq) {
  return (tq + kItemRows - 1) / kItemRows * (long long)kItemRows;
}

// Whether a pre-pass forms lse2 and delta (flash_bwd_rows) because the dQ
// kernel has no room for out: its q, dout and out of two work items, dq's
// staging tile and two stages of K and V would pass the budget (DP = 128).
template <int DP>
__host__ __device__ constexpr bool delta_pass() {
  return 7 * kItemRows * DP * 2 + 2 * (2 * kWgRows * DP * 2) > kSmemBudget - 1024;
}

// Whether the dQ kernel issues key tile j's S and dP before tile j-1's
// dS k (DP <= 80); wider, a warpgroup runs each tile's products in turn,
// which keeps S, dP and dS's fragments of one tile live, not of two.
template <int DP>
__host__ __device__ constexpr bool dq_pipelined() { return DP <= 80; }

// Whether the dK/dV kernel splits its work by gradient (DP = 96 and 128): an
// item is 64 keys, one consumer warpgroup accumulates dV and the other dK,
// each over all DP columns, both computing S^T (and the dK warpgroup dP^T)
// for the same keys. Two DP-wide accumulators, P's and dS's fragments do
// not fit one warpgroup's registers there.
template <int DP>
__host__ __device__ constexpr bool dkdv_split() { return DP > 80; }

// The bf16 terms P^T and dS (dS^T) enter dQ += dS k, dV += P^T dout and
// dK += dS^T q as: one, rounded to nearest once (2: hi + lo; the design
// notes at the top of this file).
constexpr int kBwdTerms = 1;

// Keys of a dK/dV work item.
template <int DP>
__host__ __device__ constexpr int dkv_item_rows() {
  return dkdv_split<DP>() ? kWgRows : kItemRows;
}

// dQ kernel: q and dout of two work items, NS stages of K and V, dq staged
// for its TMA store; each tile its slabs of the head dim one after another
// (AttnGeo), every 64-row box of a slab a multiple of 1024 bytes. Unless
// delta_pass<DP>(), out of two work items follows on the next 1024-byte
// boundary (dq_o_offset).
template <int DP, int NS>
struct DqSmem {
  bf16 q[2][kItemRows * DP];
  bf16 dout[2][kItemRows * DP];
  bf16 k[NS][kWgRows * DP];
  bf16 v[NS][kWgRows * DP];
  bf16 dq[kItemRows * DP];
  uint64_t q_full[2];
  uint64_t q_empty[2];
  uint64_t full[NS];
  uint64_t empty[NS];
};

template <int DP, int NS>
__host__ __device__ constexpr int dq_o_offset() {
  return (static_cast<int>(sizeof(DqSmem<DP, NS>)) + 1023) / 1024 * 1024;
}

// dK/dV kernel: k and v of two work items, NS stages of q, dout and their
// rows' lse (log2 domain) and delta, dk and dv staged for their stores.
template <int DP, int NS>
struct DkvSmem {
  bf16 k[2][dkv_item_rows<DP>() * DP];
  bf16 v[2][dkv_item_rows<DP>() * DP];
  bf16 q[NS][kWgRows * DP];
  bf16 dout[NS][kWgRows * DP];
  bf16 dk[dkv_item_rows<DP>() * DP];
  bf16 dv[dkv_item_rows<DP>() * DP];
  float lse2[NS][kWgRows];
  float delta[NS][kWgRows];
  uint64_t kv_full[2];
  uint64_t kv_empty[2];
  uint64_t full[NS];
  uint64_t empty[NS];
};

template <int DP>
constexpr int dq_stages() {
  constexpr int tiles = delta_pass<DP>() ? 5 : 7;
  constexpr int room =
      (kSmemBudget - 1024 - tiles * kItemRows * DP * 2) / (2 * kWgRows * DP * 2);
  return room > 8 ? 8 : room;
}

template <int DP>
constexpr int dkv_stages() {
  constexpr int room = (kSmemBudget - 6 * dkv_item_rows<DP>() * DP * 2) /
                       (2 * kWgRows * DP * 2 + 2 * kWgRows * 4);
  return room > 8 ? 8 : room;
}

// acc (a warpgroup's 64 x DP accumulator, times `mul`) in bf16 to rows
// row0 .. row0 + 63 of a staging tile of `rows` rows of AttnGeo<DP>,
// swizzled as the store's tensor maps read it.
template <int DP>
__device__ __forceinline__ void stage_acc(bf16* tile, int rows, int row0,
                                          const float (&acc)[DP / 2], int warp, int quad,
                                          int pair, float mul) {
  uint8_t* base = reinterpret_cast<uint8_t*>(tile);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 16 * warp + quad + 8 * r;
#pragma unroll
    for (int c = 0; c < DP / 8; ++c) {
      *reinterpret_cast<__nv_bfloat162*>(base + attn_chunk<DP>(rows, row, c) + 4 * pair) =
          __floats2bfloat162_rn(acc[4 * c + 2 * r] * mul, acc[4 * c + 2 * r + 1] * mul);
    }
  }
}

// lse2 = lse * log2(e) and delta = rowsum(dout * out) in f32 of every row
// of the wgmma pair's scratch (B*H rows of padded_rows(Tq); +inf and 0 past
// Tq), where the dQ kernel has no room for out (delta_pass): eight threads
// a row, each every eighth 16-byte chunk of it.
__global__ void flash_bwd_rows(const bf16* __restrict__ out, const bf16* __restrict__ dout,
                               const float* __restrict__ lse, float* __restrict__ lse2,
                               float* __restrict__ delta, int tq, int heads, int dim) {
  const long long idx = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 8;
  const int part = threadIdx.x % 8;
  const long long tq_pad = padded_rows(tq);
  const long long bh = idx / tq_pad;
  const int t = static_cast<int>(idx % tq_pad);
  const long long b = bh / heads;
  const int h = static_cast<int>(bh % heads);
  float s = 0.f;
  if (t < tq) {
    const long long off = ((b * tq + t) * heads + h) * dim;
    for (int c = part; c < dim / 8; c += 8) {
      s += dot_chunk<bf16>(out + off + 8 * c, dout + off + 8 * c);
    }
  }
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  s += __shfl_xor_sync(0xffffffffu, s, 4);
  if (part == 0) {
    lse2[idx] = t < tq ? lse[bh * tq + t] * kLog2e : INFINITY;
    delta[idx] = s;
  }
}

// The dQ kernel, which runs first. A work item is 128 queries of one
// (b, h), 64 a consumer warpgroup; the keys stream through in 64-key
// stages. Each warpgroup first forms its rows' delta = rowsum(dout * out)
// in f32 from the input-dtype out and dout (both loaded by TMA with q),
// and writes it, with lse in the log2 domain, to the scratch the dK/dV
// kernel reads (+inf and 0 past Tq, so P = dS = 0 there). Per key tile:
// S = q k^T and dP = dout v^T (both K-major from shared memory), dS =
// P (dP - delta) with P = exp2(S * scale * log2(e) - lse2) (0 past Tk),
// then dQ += dS k with dS from registers (kBwdTerms bf16 terms) and
// k as the MN-major B operand; tile j's S and dP are issued before tile
// j-1's dS k. dQ is scaled once at the end. 168 registers a thread
// suffice here up to DP = 64; from DP = 80 (dQ 40 floats) the consumers
// take 224 (setmaxnreg), though ptxas still reports spill stores at 80
// (16 bytes, 284 in the dK/dV kernel; 0 and 180 at DP = 64). Where
// delta_pass<DP>() (DP = 128) out is not loaded: flash_bwd_rows has
// written lse2 and delta to the scratch, and each warpgroup reads its
// rows' from there.
template <int DP, int NS>
__global__ void __launch_bounds__(wg_threads<DP>(), 1)
flash_bwd_dq_wgmma(const __grid_constant__ ViewMaps<DP> q_map,
                   const __grid_constant__ ViewMaps<DP> k_map,
                   const __grid_constant__ ViewMaps<DP> v_map,
                   const __grid_constant__ ViewMaps<DP> dout_map,
                   const __grid_constant__ ViewMaps<DP> out_map,
                   const __grid_constant__ ViewMaps<DP> dq_map,
                   const float* __restrict__ lse, float* __restrict__ lse2_out,
                   float* __restrict__ delta_out, int batch, int tq, int tk, int heads,
                   float scale) {
  using G = AttnGeo<DP>;
  constexpr uint32_t kTileBytes = kWgRows * DP * 2;  // 64 rows of every slab
  using Smem = DqSmem<DP, NS>;
  constexpr bool kPass = delta_pass<DP>();
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  bf16(*o_tiles)[kItemRows * DP] = reinterpret_cast<bf16(*)[kItemRows * DP]>(
      reinterpret_cast<uint8_t*>(&sm) + dq_o_offset<DP, NS>());

  const int tid = threadIdx.x;
  const int n_tiles = (tk + kWgRows - 1) / kWgRows;
  const int q_tiles = (tq + kItemRows - 1) / kItemRows;
  const int items = batch * heads * q_tiles;
  const long long tq_pad = padded_rows(tq);

  if (tid == 0) init_barriers(sm.q_full, sm.q_empty, sm.full, sm.empty, NS, kConsumers);
  __syncthreads();

  if (tid >= kConsumers) {
    if constexpr (producer_wg<DP>()) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    }
    if (tid == kConsumers) {
      for (int m = 0; m < G::kMaps; ++m) {
        prefetch_tensor_map(&q_map.m[m]);
        prefetch_tensor_map(&dout_map.m[m]);
        if constexpr (!kPass) prefetch_tensor_map(&out_map.m[m]);
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
        mbar_arrive_expect_tx(&sm.q_full[qb], (kPass ? 4 : 6) * kTileBytes);
        attn_load<DP>(sm.q[qb], &q_map, &sm.q_full[qb], kItemRows, h, q0, b);
        attn_load<DP>(sm.dout[qb], &dout_map, &sm.q_full[qb], kItemRows, h, q0, b);
        if constexpr (!kPass) {
          attn_load<DP>(o_tiles[qb], &out_map, &sm.q_full[qb], kItemRows, h, q0, b);
        }
        for (int j = 0; j < n_tiles; ++j, ++it) {
          const int stage = it % NS;
          if (it >= NS) mbar_wait(&sm.empty[stage], (it / NS - 1) & 1);
          mbar_arrive_expect_tx(&sm.full[stage], 2 * kTileBytes);
          attn_load<DP>(sm.k[stage], &k_map, &sm.full[stage], kWgRows, h, j * kWgRows, b);
          attn_load<DP>(sm.v[stage], &v_map, &sm.full[stage], kWgRows, h, j * kWgRows, b);
        }
      }
    }
    return;
  }
  if constexpr (producer_wg<DP>()) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  }

  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int quad = lane / 4;
  const int pair = lane % 4;
  const int wg_leader = tid % 128 == 0;
  const float scale_log2 = scale * kLog2e;

  float dq[DP / 2];
  constexpr int TERMS = kBwdTerms;
  float s[32], dp[32];           // S and dP of one key tile: 64 rows x 64 keys
  uint32_t ds[TERMS][4][4];      // dS of the previous tile in bf16 (p_frags)

  auto issue_s_dp = [&](int qb, int stage) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint64_t dq_ = attn_k_desc<DP>(smem_u32(sm.q[qb]), kItemRows, kWgRows * wg, kk);
      const uint64_t dk_ = attn_k_desc<DP>(smem_u32(sm.k[stage]), kWgRows, 0, kk);
      Wgmma<64>::ss<0, 0>(s, dq_, dk_, kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint64_t ddo =
          attn_k_desc<DP>(smem_u32(sm.dout[qb]), kItemRows, kWgRows * wg, kk);
      const uint64_t dv_ = attn_k_desc<DP>(smem_u32(sm.v[stage]), kWgRows, 0, kk);
      Wgmma<64>::ss<0, 0>(dp, ddo, dv_, kk > 0);
    }
  };
  // dQ += dS k: k [key][d] is the MN-major B operand, one product a term
  // of dS.
  auto issue_dq = [&](int stage) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int t = 0; t < TERMS; ++t) {
        attn_mn_rs<DP>(dq, ds[t][kk], smem_u32(sm.k[stage]), kWgRows, 16 * kk);
      }
    }
  };

  // lse of this thread's rows (with kPass lse2 and delta from the
  // scratch), loaded one work item ahead so that its latency hides behind a
  // whole item.
  float lse_next[2] = {0.f, 0.f}, delta_next[2] = {0.f, 0.f};
  auto load_lse = [&](int item) {
    if (item >= items) return;
    const int q0 = (item % q_tiles) * kItemRows;
    const long long bh = item / q_tiles;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + kWgRows * wg + 16 * warp + quad + 8 * r;
      if constexpr (kPass) {
        load_if(lse_next[r], lse2_out + bh * tq_pad + row, true);
        load_if(delta_next[r], delta_out + bh * tq_pad + row, true);
      } else {
        load_if(lse_next[r], lse + bh * tq + row, row < tq);
      }
    }
  };
  load_lse(blockIdx.x);

  int it = 0;
  int n = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    const int q0 = (item % q_tiles) * kItemRows;
    const int h = (item / q_tiles) % heads;
    const int b = item / q_tiles / heads;
    const long long bh = (long long)b * heads + h;
    const int qb = n & 1;

    // lse (log2 domain) of this thread's rows, and their delta from out
    // and dout in shared memory (zero-filled past Tq and D): the four
    // threads of a row each take every fourth 16-byte chunk.
    float lse2[2], delta[2];
    if constexpr (kPass) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lse2[r] = lse_next[r];
        delta[r] = delta_next[r];
      }
      load_lse(item + gridDim.x);
      mbar_wait(&sm.q_full[qb], (n / 2) & 1);
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + kWgRows * wg + 16 * warp + quad + 8 * r;
        lse2[r] = row < tq ? lse_next[r] * kLog2e : INFINITY;
      }
      load_lse(item + gridDim.x);
      mbar_wait(&sm.q_full[qb], (n / 2) & 1);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = kWgRows * wg + 16 * warp + quad + 8 * r;
        float d = 0.f;
#pragma unroll
        for (int c = pair; c < DP / 8; c += 4) {
          const uint32_t off = attn_chunk<DP>(kItemRows, row, c);
          const uint8_t* o_tile = reinterpret_cast<const uint8_t*>(o_tiles[qb]);
          const uint8_t* do_tile = reinterpret_cast<const uint8_t*>(sm.dout[qb]);
          d += dot_chunk<bf16>(reinterpret_cast<const bf16*>(o_tile + off),
                               reinterpret_cast<const bf16*>(do_tile + off));
        }
        d += __shfl_xor_sync(0xffffffffu, d, 1);
        d += __shfl_xor_sync(0xffffffffu, d, 2);
        delta[r] = d;
        if (pair == 0) {
          lse2_out[bh * tq_pad + q0 + row] = lse2[r];
          delta_out[bh * tq_pad + q0 + row] = d;
        }
      }
    }
    if (q0 + kWgRows * wg >= tq) {
      // No query of this warpgroup lies inside Tq.
      mbar_arrive(&sm.q_empty[qb]);
      for (int j = 0; j < n_tiles; ++j, ++it) {
        mbar_wait(&sm.full[it % NS], (it / NS) & 1);
        mbar_arrive(&sm.empty[it % NS]);
      }
      continue;
    }
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;

    // dS = P (dP - delta) of the tile of keys k0 .. k0 + 63 into s.
    auto ds_tile = [&](int k0) {
      const bool ragged = k0 + kWgRows > tk;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        float p = exp2_approx(fmaf(s[i], scale_log2, -lse2[r]));
        if (ragged && k0 + 8 * (i / 4) + 2 * pair + (i & 1) >= tk) p = 0.f;
        s[i] = p * (dp[i] - delta[r]);
      }
    };

    if constexpr (dq_pipelined<DP>()) {
      mbar_wait(&sm.full[it % NS], (it / NS) & 1);
      wgmma_fence();
      issue_s_dp(qb, it % NS);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      if (n_tiles == 1) mbar_arrive(&sm.q_empty[qb]);
      ds_tile(0);
      p_frags(s, ds);
      for (int j = 1; j < n_tiles; ++j) {
        const int prev = (it + j - 1) % NS;
        const int stage = (it + j) % NS;
        mbar_wait(&sm.full[stage], ((it + j) / NS) & 1);
        wgmma_fence();
        issue_s_dp(qb, stage);
        wgmma_commit();
        issue_dq(prev);
        wgmma_commit();
        wgmma_wait<1>();  // S_j and dP_j are in
        fence_regs(s);
        fence_regs(dp);
        if (j == n_tiles - 1) mbar_arrive(&sm.q_empty[qb]);  // q's and dout's last use
        ds_tile(j * kWgRows);
        wgmma_wait<0>();  // dS_{j-1} k_{j-1} is in
        fence_regs(dq);
        fence_p(ds);
        mbar_arrive(&sm.empty[prev]);
        p_frags(s, ds);
      }
      const int last = (it + n_tiles - 1) % NS;
      wgmma_fence();
      issue_dq(last);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      fence_p(ds);
      mbar_arrive(&sm.empty[last]);
      it += n_tiles;
    } else {
      // One tile at a time: S_j and dP_j, dS_j, then dS_j k_j (the other
      // warpgroup's products fill the tensor cores meanwhile).
      for (int j = 0; j < n_tiles; ++j, ++it) {
        const int stage = it % NS;
        mbar_wait(&sm.full[stage], (it / NS) & 1);
        wgmma_fence();
        issue_s_dp(qb, stage);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        if (j == n_tiles - 1) mbar_arrive(&sm.q_empty[qb]);  // q's and dout's last use
        ds_tile(j * kWgRows);
        p_frags(s, ds);
        wgmma_fence();
        issue_dq(stage);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
        fence_p(ds);
        mbar_arrive(&sm.empty[stage]);
      }
    }

    // dq * scale in bf16 to shared memory and out by a TMA store through
    // dq's own strides; rows past Tq and columns past D are not written.
    if (wg_leader) bulk_wait<true>();
    named_barrier(1 + wg, 128);
    stage_acc<DP>(sm.dq, kItemRows, kWgRows * wg, dq, warp, quad, pair, scale);
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    if (wg_leader) {
      attn_store<DP>(&dq_map, sm.dq, kItemRows, kWgRows * wg, h, q0 + kWgRows * wg, b);
      bulk_commit();
    }
  }
  if (wg_leader) bulk_wait<false>();
}

// The dK/dV kernel, after the dQ kernel. A work item is 128 keys of one
// (b, h), 64 a consumer warpgroup; 64-query stages of q, dout and their
// rows' lse2 and delta (from the dQ kernel's scratch) stream through. Per
// query tile: S^T = k q^T and dP^T = v dout^T (K-major from shared memory),
// P^T = exp2(S^T * scale * log2(e) - lse2) and dS^T = P^T (dP^T - delta),
// then dV += P^T dout and dK += dS^T q with P^T and dS^T from registers
// (kBwdTerms bf16 terms) and dout and q as MN-major B operands. dK
// is scaled once at the end (dK = dS^T q^ with q^ = q * scale). Keys past
// Tk compute values that are never stored.
// Registers set the design: with the producer warp, three warps share one
// quarter of the register file, so a thread has at most 168, and dK and
// dV alone take 2 * DP / 2 of them (at DP = 80, with a producer warpgroup,
// setmaxnreg gives the consumers 224 instead). A warpgroup therefore runs a tile's
// steps in order (S^T and dP^T, then the dV and dK products), issuing the
// dV products before it splits dS^T; the other warpgroup's softmax runs
// while its products are on the tensor cores. Issuing tile j+1's S^T and
// dP^T before tile j's products (as the dQ kernel does) needs about 200
// registers a thread.
// From DP = 96 (dkdv_split) two DP-wide accumulators do not fit: an item
// is 64 keys, and the warpgroups split it by gradient, warpgroup 0
// accumulating dV (S^T, then dV += P^T dout) and warpgroup 1 dK (S^T and
// dP^T, then dK += dS^T q), each over all DP columns. S^T is computed
// twice, a sixth more products than one warpgroup doing both (a split by
// columns computes S^T and dP^T twice: a third more).
template <int DP, int NS>
__global__ void __launch_bounds__(wg_threads<DP>(), 1)
flash_bwd_dkdv_wgmma(const __grid_constant__ ViewMaps<DP> q_map,
                     const __grid_constant__ ViewMaps<DP> k_map,
                     const __grid_constant__ ViewMaps<DP> v_map,
                     const __grid_constant__ ViewMaps<DP> dout_map,
                     const __grid_constant__ ViewMaps<DP> dk_map,
                     const __grid_constant__ ViewMaps<DP> dv_map,
                     const float* __restrict__ lse2_in, const float* __restrict__ delta_in,
                     int batch, int tq, int tk, int heads, float scale) {
  using G = AttnGeo<DP>;
  constexpr bool kSplit = dkdv_split<DP>();
  constexpr int kKeys = dkv_item_rows<DP>();
  constexpr int TERMS = kBwdTerms;
  constexpr uint32_t kTileBytes = kWgRows * DP * 2;  // 64 rows of every slab
  constexpr uint32_t kRowBytes = kWgRows * 4;  // lse2 or delta of a stage
  using Smem = DkvSmem<DP, NS>;
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  const int tid = threadIdx.x;
  const int n_tiles = (tq + kWgRows - 1) / kWgRows;
  const int k_tiles = (tk + kKeys - 1) / kKeys;
  const int items = batch * heads * k_tiles;
  const long long tq_pad = padded_rows(tq);

  if (tid == 0) init_barriers(sm.kv_full, sm.kv_empty, sm.full, sm.empty, NS, kConsumers);
  __syncthreads();

  if (tid >= kConsumers) {
    if constexpr (producer_wg<DP>()) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    }
    if (tid == kConsumers) {
      for (int m = 0; m < G::kMaps; ++m) {
        prefetch_tensor_map(&k_map.m[m]);
        prefetch_tensor_map(&v_map.m[m]);
        prefetch_tensor_map(&q_map.m[m]);
        prefetch_tensor_map(&dout_map.m[m]);
      }
      int it = 0;
      int n = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
        const int k0 = (item % k_tiles) * kKeys;
        const int h = (item / k_tiles) % heads;
        const int b = item / k_tiles / heads;
        const long long bh = (long long)b * heads + h;
        const int kb = n & 1;
        if (n >= 2) mbar_wait(&sm.kv_empty[kb], (n / 2 - 1) & 1);
        mbar_arrive_expect_tx(&sm.kv_full[kb], 2 * (kKeys / kWgRows) * kTileBytes);
        attn_load<DP>(sm.k[kb], &k_map, &sm.kv_full[kb], kKeys, h, k0, b);
        attn_load<DP>(sm.v[kb], &v_map, &sm.kv_full[kb], kKeys, h, k0, b);
        for (int j = 0; j < n_tiles; ++j, ++it) {
          const int stage = it % NS;
          if (it >= NS) mbar_wait(&sm.empty[stage], (it / NS - 1) & 1);
          mbar_arrive_expect_tx(&sm.full[stage], 2 * kTileBytes + 2 * kRowBytes);
          attn_load<DP>(sm.q[stage], &q_map, &sm.full[stage], kWgRows, h, j * kWgRows, b);
          attn_load<DP>(sm.dout[stage], &dout_map, &sm.full[stage], kWgRows, h, j * kWgRows,
                        b);
          bulk_load(&sm.lse2[stage][0], lse2_in + bh * tq_pad + j * kWgRows, kRowBytes,
                    &sm.full[stage]);
          bulk_load(&sm.delta[stage][0], delta_in + bh * tq_pad + j * kWgRows, kRowBytes,
                    &sm.full[stage]);
        }
      }
    }
    return;
  }
  if constexpr (producer_wg<DP>()) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  }

  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int quad = lane / 4;
  const int pair = lane % 4;
  const int wg_leader = tid % 128 == 0;
  const float scale_log2 = scale * kLog2e;

  if constexpr (kSplit) {
    // Warpgroup 0 accumulates dV, warpgroup 1 dK, over the item's 64 keys.
    const bool dk_wg = wg == 1;
    float acc[DP / 2];
    float st[32], dpt[32];         // S^T and dP^T of one query tile: 64 keys x 64 queries
    uint32_t fr[TERMS][4][4];      // P^T (dV) or dS^T (dK) in bf16 (p_frags)

    int it = 0;
    for (int item = blockIdx.x, n = 0; item < items; item += gridDim.x, ++n) {
      const int k0 = (item % k_tiles) * kKeys;
      const int h = (item / k_tiles) % heads;
      const int b = item / k_tiles / heads;
      const int kb = n & 1;
      mbar_wait(&sm.kv_full[kb], (n / 2) & 1);
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

      for (int j = 0; j < n_tiles; ++j, ++it) {
        const int stage = it % NS;
        mbar_wait(&sm.full[stage], (it / NS) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const uint64_t da = attn_k_desc<DP>(smem_u32(sm.k[kb]), kKeys, 0, kk);
          const uint64_t db = attn_k_desc<DP>(smem_u32(sm.q[stage]), kWgRows, 0, kk);
          Wgmma<64>::ss<0, 0>(st, da, db, kk > 0);
        }
        if (dk_wg) {
#pragma unroll
          for (int kk = 0; kk < DP / 16; ++kk) {
            const uint64_t da = attn_k_desc<DP>(smem_u32(sm.v[kb]), kKeys, 0, kk);
            const uint64_t db = attn_k_desc<DP>(smem_u32(sm.dout[stage]), kWgRows, 0, kk);
            Wgmma<64>::ss<0, 0>(dpt, da, db, kk > 0);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        if (dk_wg) fence_regs(dpt);
        if (j == n_tiles - 1) mbar_arrive(&sm.kv_empty[kb]);  // k's and v's last use
        // P^T (warpgroup 0) or dS^T (warpgroup 1) in bf16; this
        // thread's columns (queries) are 8 c + 2 pair + e.
        if (dk_wg) {
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int col = 8 * c + 2 * pair;
            const float2 l2 = *reinterpret_cast<const float2*>(&sm.lse2[stage][col]);
            const float2 dl = *reinterpret_cast<const float2*>(&sm.delta[stage][col]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = 4 * c + e;
              const float p = exp2_approx(fmaf(st[i], scale_log2, (e & 1) ? -l2.y : -l2.x));
              dpt[i] = p * (dpt[i] - ((e & 1) ? dl.y : dl.x));
            }
          }
          p_frags(dpt, fr);
        } else {
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int col = 8 * c + 2 * pair;
            const float2 l2 = *reinterpret_cast<const float2*>(&sm.lse2[stage][col]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = 4 * c + e;
              st[i] = exp2_approx(fmaf(st[i], scale_log2, (e & 1) ? -l2.y : -l2.x));
            }
          }
          p_frags(st, fr);
        }
        // dV += P^T dout or dK += dS^T q.
        const uint32_t operand = smem_u32(dk_wg ? sm.q[stage] : sm.dout[stage]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int t = 0; t < TERMS; ++t) {
            attn_mn_rs<DP>(acc, fr[t][kk], operand, kWgRows, 16 * kk);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        fence_p(fr);
        mbar_arrive(&sm.empty[stage]);
      }

      if (wg_leader) bulk_wait<true>();
      named_barrier(1 + wg, 128);
      bf16* tile = dk_wg ? sm.dk : sm.dv;
      stage_acc<DP>(tile, kKeys, 0, acc, warp, quad, pair, dk_wg ? scale : 1.f);
      fence_proxy_async();
      named_barrier(1 + wg, 128);
      if (wg_leader) {
        attn_store<DP>(dk_wg ? &dk_map : &dv_map, tile, kKeys, 0, h, k0, b);
        bulk_commit();
      }
    }
    if (wg_leader) bulk_wait<false>();
  } else {
    float dk[DP / 2], dv[DP / 2];
    float st[32], dpt[32];         // S^T and dP^T of one query tile: 64 keys x 64 queries
    uint32_t pt[TERMS][4][4];      // P^T in bf16 (p_frags)

    int it = 0;
    int n = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
      const int k0 = (item % k_tiles) * kItemRows;
      const int h = (item / k_tiles) % heads;
      const int b = item / k_tiles / heads;
      const int kb = n & 1;
      mbar_wait(&sm.kv_full[kb], (n / 2) & 1);
      if (k0 + kWgRows * wg >= tk) {
        // No key of this warpgroup lies inside Tk.
        mbar_arrive(&sm.kv_empty[kb]);
        for (int j = 0; j < n_tiles; ++j, ++it) {
          mbar_wait(&sm.full[it % NS], (it / NS) & 1);
          mbar_arrive(&sm.empty[it % NS]);
        }
        continue;
      }
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;

      for (int j = 0; j < n_tiles; ++j, ++it) {
        const int stage = it % NS;
        mbar_wait(&sm.full[stage], (it / NS) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const uint64_t da =
              attn_k_desc<DP>(smem_u32(sm.k[kb]), kItemRows, kWgRows * wg, kk);
          const uint64_t db = attn_k_desc<DP>(smem_u32(sm.q[stage]), kWgRows, 0, kk);
          Wgmma<64>::ss<0, 0>(st, da, db, kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const uint64_t da =
              attn_k_desc<DP>(smem_u32(sm.v[kb]), kItemRows, kWgRows * wg, kk);
          const uint64_t db = attn_k_desc<DP>(smem_u32(sm.dout[stage]), kWgRows, 0, kk);
          Wgmma<64>::ss<0, 0>(dpt, da, db, kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);
        if (j == n_tiles - 1) mbar_arrive(&sm.kv_empty[kb]);  // k's and v's last use
        // P^T into st and dS^T into dpt; this thread's columns (queries) are
        // 8 c + 2 pair + e.
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int col = 8 * c + 2 * pair;
          const float2 l2 = *reinterpret_cast<const float2*>(&sm.lse2[stage][col]);
          const float2 dl = *reinterpret_cast<const float2*>(&sm.delta[stage][col]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * c + e;
            const float p = exp2_approx(fmaf(st[i], scale_log2, (e & 1) ? -l2.y : -l2.x));
            st[i] = p;
            dpt[i] = p * (dpt[i] - ((e & 1) ? dl.y : dl.x));
          }
        }
        // dV += P^T dout, issued before dS^T is split; then dK += dS^T q.
        p_frags(st, pt);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int t = 0; t < TERMS; ++t) {
            attn_mn_rs<DP>(dv, pt[t][kk], smem_u32(sm.dout[stage]), kWgRows, 16 * kk);
          }
        }
        wgmma_commit();
        uint32_t dst[TERMS][4][4];     // dS^T in bf16
        p_frags(dpt, dst);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int t = 0; t < TERMS; ++t) {
            attn_mn_rs<DP>(dk, dst[t][kk], smem_u32(sm.q[stage]), kWgRows, 16 * kk);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dk);
        fence_regs(dv);
        fence_p(pt);
        fence_p(dst);
        mbar_arrive(&sm.empty[stage]);
      }

      if (wg_leader) bulk_wait<true>();
      named_barrier(1 + wg, 128);
      stage_acc<DP>(sm.dk, kItemRows, kWgRows * wg, dk, warp, quad, pair, scale);
      stage_acc<DP>(sm.dv, kItemRows, kWgRows * wg, dv, warp, quad, pair, 1.f);
      fence_proxy_async();
      named_barrier(1 + wg, 128);
      if (wg_leader) {
        attn_store<DP>(&dk_map, sm.dk, kItemRows, kWgRows * wg, h, k0 + kWgRows * wg, b);
        attn_store<DP>(&dv_map, sm.dv, kItemRows, kWgRows * wg, h, k0 + kWgRows * wg, b);
        bulk_commit();
      }
    }
    if (wg_leader) bulk_wait<false>();
  }
}

template <int DP>
int launch_wgmma(const void* const* in, const void* out, const void* dout, const float* lse,
                 float* scratch, void* const* grads, const long long* strides, int batch,
                 int tq, int tk, int heads, int dim, float scale, cudaStream_t stream) {
  constexpr int NQ = dq_stages<DP>();
  constexpr int NK = dkv_stages<DP>();
  // q, k, v, dq, dk and dv with their own byte strides; dout and out
  // contiguous [B, Tq, H, D].
  const int seqs[6] = {tq, tk, tk, tq, tk, tk};
  const void* ptrs[6] = {in[0], in[1], in[2], grads[0], grads[1], grads[2]};
  ViewMaps<DP> maps[8];
  for (int i = 0; i < 6; ++i) {
    if (!make_view_maps<DP>(&maps[i], ptrs[i], batch, seqs[i], heads, dim,
                            strides + 3 * i)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (!make_view_maps<DP>(&maps[6], dout, batch, tq, heads, dim, nullptr) ||
      !make_view_maps<DP>(&maps[7], out, batch, tq, heads, dim, nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const long long q_items = (long long)batch * heads * ((tq + kItemRows - 1) / kItemRows);
  constexpr int kKeys = dkv_item_rows<DP>();
  const long long k_items = (long long)batch * heads * ((tk + kKeys - 1) / kKeys);
  if (q_items >= (1LL << 31) || k_items >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* lse2 = scratch;
  float* delta = scratch + (long long)batch * heads * padded_rows(tq);
  if constexpr (delta_pass<DP>()) {
    const long long threads = 8 * (long long)batch * heads * padded_rows(tq);
    flash_bwd_rows<<<static_cast<unsigned>(threads / 256), 256, 0, stream>>>(
        static_cast<const bf16*>(out), static_cast<const bf16*>(dout), lse, lse2, delta, tq,
        heads, dim);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  auto dq_kernel = flash_bwd_dq_wgmma<DP, NQ>;
  const int dq_smem = dq_o_offset<DP, NQ>() +
                      (delta_pass<DP>() ? 0 : 2 * kItemRows * DP * 2) + 1024;
  static const cudaError_t dq_attr = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem);
  if (dq_attr != cudaSuccess) return static_cast<int>(dq_attr);
  dq_kernel<<<q_items < sms ? static_cast<int>(q_items) : sms, wg_threads<DP>(), dq_smem,
              stream>>>(maps[0], maps[1], maps[2], maps[6], maps[7], maps[3], lse, lse2,
                        delta, batch, tq, tk, heads, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  auto dkv_kernel = flash_bwd_dkdv_wgmma<DP, NK>;
  const int dkv_smem = static_cast<int>(sizeof(DkvSmem<DP, NK>)) + 1024;
  static const cudaError_t dkv_attr = cudaFuncSetAttribute(
      dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_smem);
  if (dkv_attr != cudaSuccess) return static_cast<int>(dkv_attr);
  dkv_kernel<<<k_items < sms ? static_cast<int>(k_items) : sms, wg_threads<DP>(), dkv_smem,
               stream>>>(maps[0], maps[1], maps[2], maps[6], maps[4], maps[5], lse2, delta,
                         batch, tq, tk, heads, scale);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ f32, 3xTF32
// The pair's body is hopper_common.cuh's (tf32x3_bwd_dq, tf32x3_bwd_dkdv);
// GeneralTf is its layout here: every tile is rows of tokens by DP / 32
// slabs of 32 columns of the head dim, 128-byte swizzled, as TMA lands it
// from a [B, T, H, D] view (K-major over d: the B operands of S = q k^T and
// dP = dout v^T, and of S^T = k q^T and dP^T = v dout^T, as they lie), so
// the splitters write each streamed tile's transpose for the products that
// reduce over its rows.
static_assert(kItemRows == kTfBwdItemRows, "the scratch rows of both pairs");
constexpr uint32_t kTfBox = kTfBwdRows * 128;  // 32 rows of a 32-float slab

// A gradient written from registers: its base and byte strides of H, T, B.
struct GradView {
  float* p;
  long long sh, st, sb;
};

// dQ kernel: q and dout of one work item (raw, as TMA lands them), NS stages
// of a 32-key tile of k and v (their hi halves written in place), and two
// buffers of the splitters' output: k's and v's lo halves and k^T's hi and
// lo halves (row d, the tile's keys along it in the dS fragments' order).
template <int DP, int NS>
struct TfDqSmem {
  float q[DP / 32][kItemRows][32];
  float dout[DP / 32][kItemRows][32];
  float k[NS][DP / 32][kTfBwdRows][32];
  float v[NS][DP / 32][kTfBwdRows][32];
  float k_lo[2][DP / 32][kTfBwdRows][32];
  float v_lo[2][DP / 32][kTfBwdRows][32];
  float kt[2][DP][32];
  float kt_lo[2][DP][32];
  TfBwdBarriers<NS> bar;
};

// dK/dV kernel: k and v of one work item, NS stages of a 32-query tile of q
// and dout (hi halves in place) with the rows' lse2 and delta, and two
// buffers of q's and dout's lo halves and of q^T's and dout^T's hi and lo
// halves (row d, the tile's queries along it in the P and dS fragments'
// order).
template <int DP, int NS>
struct TfDkvSmem {
  float k[DP / 32][kItemRows][32];
  float v[DP / 32][kItemRows][32];
  float q[NS][DP / 32][kTfBwdRows][32];
  float dout[NS][DP / 32][kTfBwdRows][32];
  float q_lo[2][DP / 32][kTfBwdRows][32];
  float dout_lo[2][DP / 32][kTfBwdRows][32];
  float qt[2][DP][32];
  float qt_lo[2][DP][32];
  float dot[2][DP][32];
  float dot_lo[2][DP][32];
  float lse2[NS][kTfBwdRows];
  float delta[NS][kTfBwdRows];
  TfBwdBarriers<NS> bar;
};

template <int DP>
constexpr int tf_dq_stages() {
  constexpr int fixed =
      (2 * kItemRows * DP + 2 * 2 * kTfBwdRows * DP + 2 * 2 * DP * 32) * 4;
  constexpr int room = (kSmemBudget - fixed) / (2 * kTfBwdRows * DP * 4);
  return room > 4 ? 4 : room;
}

template <int DP>
constexpr int tf_dkv_stages() {
  constexpr int fixed =
      (2 * kItemRows * DP + 2 * 2 * kTfBwdRows * DP + 4 * 2 * DP * 32) * 4;
  constexpr int room = (kSmemBudget - fixed) / (2 * kTfBwdRows * DP * 4 + 2 * kTfBwdRows * 4);
  return room > 4 ? 4 : room;
}

// A splitter thread's share (st of kTfBwdSplitters) of one 32-row tile of DP
// columns as TMA lands it: its hi half in place, its lo half into `lo` at
// the same offsets and, with TRANS, the hi and lo halves of its transpose
// into t_hi and t_lo ([DP][32]: row d, the tile's rows along it, each
// 8-row group in the order 0, 2, 4, 6, 1, 3, 5, 7 that split_p_tf32 gives
// a fragment's columns). A warp takes the tile's 32 rows (one a lane) by 4
// columns: one 16-byte read, a 16-byte write of each half in place of it,
// and four 4-byte writes of each transposed half in one row (all free of
// bank conflicts under the swizzle).
template <int DP, bool TRANS>
__device__ __forceinline__ void split_tile(float* tile, float* lo, float* t_hi, float* t_lo,
                                           int st) {
  const int lane = st % 32;
  const int pos = 8 * (lane / 8) + 4 * (lane & 1) + (lane % 8) / 2;
  for (int c4 = st / 32; c4 < DP / 4; c4 += kTfBwdSplitters / 32) {
    const uint32_t off = (c4 / 8) * kTfBox + swizzled<128>(lane, c4 % 8);
    float4* src = reinterpret_cast<float4*>(reinterpret_cast<uint8_t*>(tile) + off);
    const float4 x = *src;
    *src = make_float4(tf32_hi(x.x), tf32_hi(x.y), tf32_hi(x.z), tf32_hi(x.w));
    *reinterpret_cast<float4*>(reinterpret_cast<uint8_t*>(lo) + off) =
        make_float4(tf32_lo(x.x), tf32_lo(x.y), tf32_lo(x.z), tf32_lo(x.w));
    if constexpr (TRANS) {
      const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t at = swizzled<128>(4 * c4 + e, pos / 4) + 4 * (pos % 4);
        *reinterpret_cast<float*>(reinterpret_cast<uint8_t*>(t_hi) + at) = tf32_hi(xs[e]);
        *reinterpret_cast<float*>(reinterpret_cast<uint8_t*>(t_lo) + at) = tf32_lo(xs[e]);
      }
    }
  }
}

// acc (a warpgroup's 64 x DP accumulator, rows row0 + quad (+ 8)) times
// `mul` into the rows of g it holds below `rows`, columns below `dim`, 8
// bytes a store (each 32-byte sector written whole).
template <int DP>
__device__ __forceinline__ void store_grad(const GradView& g, const float (&acc)[DP / 2],
                                           int b, int h, int row0, int rows, int dim,
                                           int quad, int pair, float mul) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = row0 + quad + 8 * r;
    if (t >= rows) continue;
    float* row = reinterpret_cast<float*>(reinterpret_cast<uint8_t*>(g.p) + b * g.sb +
                                          t * g.st + h * g.sh);
#pragma unroll
    for (int c = 0; c < DP / 8; ++c) {
      const int col = 8 * c + 2 * pair;
      if (col < dim) {
        *reinterpret_cast<float2*>(row + col) =
            make_float2(acc[4 * c + 2 * r] * mul, acc[4 * c + 2 * r + 1] * mul);
      }
    }
  }
}

// The layout of the shared 3xTF32 backward (hopper_common.cuh) on
// [B, T, H, D] views: q, k, v and dout through a tensor map each, out and
// the gradients through their strides.
template <int DP>
struct GeneralTf {
  static constexpr int kDp = DP;
  // The products read the splitters' transposes, never a stage.
  static constexpr bool kProductsReadStage = false;
  const CUtensorMap* q_map;
  const CUtensorMap* k_map;
  const CUtensorMap* v_map;
  const CUtensorMap* dout_map;
  const float* out;  // [B, Tq, H, D] contiguous (the dQ kernel's delta)
  GradView dq, dk, dv;
  int tq, tk, heads, dim;

  // Score column 8 (i / 4) + 2 pair + i % 2, the accumulator's own.
  static __device__ __forceinline__ int col(int i, int pair) {
    return 8 * (i / 4) + 2 * pair + (i & 1);
  }

  // The TF32 A fragments (hi and lo halves) of step kk (head-dim columns
  // 8 kk .. 8 kk + 7) for rows row0 + quad (+ 8) of a raw [DP / 32][128][32]
  // item tile: column pair (+ 4), read from the swizzled tile (8 rows, 8
  // distinct 16-byte chunks: no bank conflicts) and split.
  static __device__ __forceinline__ void frag(float (*tile)[kItemRows][32], int row0, int kk,
                                              int quad, int pair, uint32_t (&hi)[4],
                                              uint32_t (&lo)[4]) {
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int r = row0 + quad + 8 * (f & 1);
      const int c = 8 * kk + pair + 4 * (f >> 1);
      const float x = *reinterpret_cast<const float*>(
          reinterpret_cast<const uint8_t*>(&tile[c / 32][0][0]) +
          swizzled<128>(r, (c % 32) / 4) + 4 * (c % 4));
      hi[f] = __float_as_uint(tf32_hi(x));
      lo[f] = __float_as_uint(tf32_lo(x));
    }
  }

  __device__ __forceinline__ void prefetch() const {
    prefetch_tensor_map(q_map);
    prefetch_tensor_map(dout_map);
    prefetch_tensor_map(k_map);
    prefetch_tensor_map(v_map);
  }

  // An item's 128 rows (four 32-row boxes of each slab) of views a and b.
  static __device__ __forceinline__ void load_item(float (&a)[DP / 32][kItemRows][32],
                                                   const CUtensorMap* am,
                                                   float (&b)[DP / 32][kItemRows][32],
                                                   const CUtensorMap* bm, uint64_t* full, int r0,
                                                   int h, int bi) {
#pragma unroll
    for (int s = 0; s < DP / 32; ++s) {
#pragma unroll
      for (int i = 0; i < kItemRows / kTfBwdRows; ++i) {
        tma_load_4d(&a[s][kTfBwdRows * i][0], am, full, 32 * s, h, r0 + kTfBwdRows * i, bi);
        tma_load_4d(&b[s][kTfBwdRows * i][0], bm, full, 32 * s, h, r0 + kTfBwdRows * i, bi);
      }
    }
  }

  // Tile j (32 rows) of views a and b into one stage.
  static __device__ __forceinline__ void load_tile(float (&a)[DP / 32][kTfBwdRows][32],
                                                   const CUtensorMap* am,
                                                   float (&b)[DP / 32][kTfBwdRows][32],
                                                   const CUtensorMap* bm, uint64_t* full, int j,
                                                   int h, int bi) {
#pragma unroll
    for (int s = 0; s < DP / 32; ++s) {
      tma_load_4d(&a[s][0][0], am, full, 32 * s, h, j * kTfBwdRows, bi);
      tma_load_4d(&b[s][0][0], bm, full, 32 * s, h, j * kTfBwdRows, bi);
    }
  }

  // ---- dQ: item q and dout, tiles of k and v.
  template <class S>
  __device__ __forceinline__ void load_dq_item(S& sm, uint64_t* full, int q0, int h,
                                               int b) const {
    load_item(sm.q, q_map, sm.dout, dout_map, full, q0, h, b);
  }
  template <class S>
  __device__ __forceinline__ void load_dq_tile(S& sm, int stage, uint64_t* full, int j, int h,
                                               int b) const {
    load_tile(sm.k[stage], k_map, sm.v[stage], v_map, full, j, h, b);
  }
  // k's halves and k^T's, v's halves.
  template <class S>
  __device__ __forceinline__ void split_dq(S& sm, int stage, int db, int st) const {
    split_tile<DP, true>(&sm.k[stage][0][0][0], &sm.k_lo[db][0][0][0], &sm.kt[db][0][0],
                         &sm.kt_lo[db][0][0], st);
    split_tile<DP, false>(&sm.v[stage][0][0][0], &sm.v_lo[db][0][0][0], nullptr, nullptr, st);
  }
  template <class S>
  static __device__ __forceinline__ TfHalves s_b(S& sm, int stage, int db) {
    return {&sm.k[stage][0][0][0], &sm.k_lo[db][0][0][0]};
  }
  template <class S>
  static __device__ __forceinline__ TfHalves dp_b(S& sm, int stage, int db) {
    return {&sm.v[stage][0][0][0], &sm.v_lo[db][0][0][0]};
  }
  template <class S>
  static __device__ __forceinline__ TfHalves dq_b(S& sm, int, int db) {
    return {&sm.kt[db][0][0], &sm.kt_lo[db][0][0]};
  }
  // Item row `row`'s share of delta: dout from shared memory (zero past D),
  // out from device memory (read-only), every fourth 16-byte chunk from
  // `pair`.
  template <class S>
  __device__ __forceinline__ float delta_part(S& sm, int row, int t, int b, int h,
                                              int pair) const {
    float d = 0.f;
    const float* orow = out + ((long long)b * tq + t) * heads * dim + (long long)h * dim;
#pragma unroll
    for (int c = pair; c < DP / 4; c += 4) {
      if (4 * c < dim) {
        const float4 o4 = __ldg(reinterpret_cast<const float4*>(orow + 4 * c));
        const float4 d4 = *reinterpret_cast<const float4*>(
            reinterpret_cast<const uint8_t*>(&sm.dout[c / 8][0][0]) + swizzled<128>(row, c % 8));
        d += o4.x * d4.x + o4.y * d4.y + o4.z * d4.z + o4.w * d4.w;
      }
    }
    return d;
  }
  __device__ __forceinline__ void store_dq(const float (&acc)[DP / 2], int b, int h, int row0,
                                           int quad, int pair, float mul) const {
    store_grad<DP>(dq, acc, b, h, row0, tq, dim, quad, pair, mul);
  }

  // ---- dK/dV: item k and v, tiles of q and dout.
  template <class S>
  __device__ __forceinline__ void load_dkv_item(S& sm, uint64_t* full, int k0, int h,
                                                int b) const {
    load_item(sm.k, k_map, sm.v, v_map, full, k0, h, b);
  }
  template <class S>
  __device__ __forceinline__ void load_dkv_tile(S& sm, int stage, uint64_t* full, int j, int h,
                                                int b) const {
    load_tile(sm.q[stage], q_map, sm.dout[stage], dout_map, full, j, h, b);
  }
  // q's and dout's halves and their transposes'.
  template <class S>
  __device__ __forceinline__ void split_dkv(S& sm, int stage, int db, int st) const {
    split_tile<DP, true>(&sm.q[stage][0][0][0], &sm.q_lo[db][0][0][0], &sm.qt[db][0][0],
                         &sm.qt_lo[db][0][0], st);
    split_tile<DP, true>(&sm.dout[stage][0][0][0], &sm.dout_lo[db][0][0][0], &sm.dot[db][0][0],
                         &sm.dot_lo[db][0][0], st);
  }
  template <class S>
  static __device__ __forceinline__ TfHalves st_b(S& sm, int stage, int db) {
    return {&sm.q[stage][0][0][0], &sm.q_lo[db][0][0][0]};
  }
  template <class S>
  static __device__ __forceinline__ TfHalves dpt_b(S& sm, int stage, int db) {
    return {&sm.dout[stage][0][0][0], &sm.dout_lo[db][0][0][0]};
  }
  template <class S>
  static __device__ __forceinline__ TfHalves dv_b(S& sm, int, int db) {
    return {&sm.dot[db][0][0], &sm.dot_lo[db][0][0]};
  }
  template <class S>
  static __device__ __forceinline__ TfHalves dk_b(S& sm, int, int db) {
    return {&sm.qt[db][0][0], &sm.qt_lo[db][0][0]};
  }
  __device__ __forceinline__ void store_dk(const float (&acc)[DP / 2], int b, int h, int row0,
                                           int quad, int pair, float mul) const {
    store_grad<DP>(dk, acc, b, h, row0, tk, dim, quad, pair, mul);
  }
  __device__ __forceinline__ void store_dv(const float (&acc)[DP / 2], int b, int h, int row0,
                                           int quad, int pair, float mul) const {
    store_grad<DP>(dv, acc, b, h, row0, tk, dim, quad, pair, mul);
  }
};

// The 3xTF32 dQ kernel, which runs first: the bf16 dQ kernel's work items
// and scratch, on f32 operands (hopper_common.cuh:tf32x3_bwd_dq). dQ is
// stored through dq's strides.
template <int DP, int NS>
__global__ void __launch_bounds__(kTfBwdThreads, 1)
flash_bwd_dq_tf32x3(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap dout_map,
                    const float* __restrict__ out, const float* __restrict__ lse,
                    float* __restrict__ lse2_out, float* __restrict__ delta_out,
                    GradView dq_out, int batch, int tq, int tk, int heads, int dim,
                    float scale) {
  extern __shared__ uint8_t smem_raw[];
  const GeneralTf<DP> lay{&q_map, &k_map, &v_map, &dout_map, out, dq_out, {}, {},
                          tq, tk, heads, dim};
  tf32x3_bwd_dq<NS, TfDqSmem<DP, NS>>(lay, smem_raw, lse, lse2_out, delta_out, batch, tq, tk,
                                      heads, scale);
}

// The 3xTF32 dK/dV kernel, after the dQ kernel: the bf16 kernel's work
// items on f32 operands (hopper_common.cuh:tf32x3_bwd_dkdv). dK and dV are
// stored through their strides.
template <int DP, int NS>
__global__ void __launch_bounds__(kTfBwdThreads, 1)
flash_bwd_dkdv_tf32x3(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const __grid_constant__ CUtensorMap dout_map,
                      const float* __restrict__ lse2_in, const float* __restrict__ delta_in,
                      GradView dk_out, GradView dv_out, int batch, int tq, int tk,
                      int heads, int dim, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const GeneralTf<DP> lay{&q_map, &k_map, &v_map, &dout_map, nullptr, {}, dk_out, dv_out,
                          tq, tk, heads, dim};
  tf32x3_bwd_dkdv<NS, TfDkvSmem<DP, NS>>(lay, smem_raw, lse2_in, delta_in, batch, tq, tk,
                                         heads, scale);
}

template <int DP>
int launch_tf32x3(const void* const* in, const void* out, const void* dout, const float* lse,
                  float* scratch, void* const* grads, const long long* strides, int batch,
                  int tq, int tk, int heads, int dim, float scale, cudaStream_t stream) {
  constexpr int NQ = tf_dq_stages<DP>();
  constexpr int NK = tf_dkv_stages<DP>();
  // q, k and v with their own byte strides, dout contiguous [B, Tq, H, D];
  // boxes of 32 rows of a 32-float slab.
  const int seqs[3] = {tq, tk, tk};
  CUtensorMap maps[4];
  for (int i = 0; i < 3; ++i) {
    if (!make_view_map_f32(&maps[i], in[i], batch, seqs[i], heads, dim, strides + 3 * i,
                           kTfBwdRows)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const long long row = 4LL * dim;
  const long long dout_strides[3] = {row, row * heads, row * heads * tq};
  if (!make_view_map_f32(&maps[3], dout, batch, tq, heads, dim, dout_strides, kTfBwdRows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  GradView g[3];
  for (int i = 0; i < 3; ++i) {
    g[i] = GradView{static_cast<float*>(grads[i]), strides[9 + 3 * i],
                    strides[10 + 3 * i], strides[11 + 3 * i]};
  }
  static const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const long long q_items = (long long)batch * heads * ((tq + kItemRows - 1) / kItemRows);
  const long long k_items = (long long)batch * heads * ((tk + kItemRows - 1) / kItemRows);
  if (q_items >= (1LL << 31) || k_items >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* lse2 = scratch;
  float* delta = scratch + (long long)batch * heads * padded_rows(tq);

  auto dq_kernel = flash_bwd_dq_tf32x3<DP, NQ>;
  const int dq_smem = static_cast<int>(sizeof(TfDqSmem<DP, NQ>)) + 1024;
  static const cudaError_t dq_attr = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem);
  if (dq_attr != cudaSuccess) return static_cast<int>(dq_attr);
  dq_kernel<<<q_items < sms ? static_cast<int>(q_items) : sms, kTfBwdThreads, dq_smem,
              stream>>>(maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(out),
                        lse, lse2, delta, g[0], batch, tq, tk, heads, dim, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  auto dkv_kernel = flash_bwd_dkdv_tf32x3<DP, NK>;
  const int dkv_smem = static_cast<int>(sizeof(TfDkvSmem<DP, NK>)) + 1024;
  static const cudaError_t dkv_attr = cudaFuncSetAttribute(
      dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_smem);
  if (dkv_attr != cudaSuccess) return static_cast<int>(dkv_attr);
  dkv_kernel<<<k_items < sms ? static_cast<int>(k_items) : sms, kTfBwdThreads, dkv_smem,
               stream>>>(maps[0], maps[1], maps[2], maps[3], lse2, delta, g[1], g[2], batch,
                         tq, tk, heads, dim, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- launch
template <typename T>
struct Args {
  View<const T> q, k, v;
  const T* dout;
  const float* lse;
  const float* delta;
  View<T> dq, dk, dv;
  int tq, tk, heads, dim;
  float scale;
};

template <typename T>
int launch_delta(const void* out, const T* dout, float* delta, int batch, int tq,
                 int heads, int dim, cudaStream_t stream) {
  const long long rows = (long long)batch * tq * heads;
  const int threads = 256;
  const long long blocks = (rows + threads - 1) / threads;
  flash_bwd_delta<T><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const T*>(out), dout, delta, rows, tq, heads, dim);
  return static_cast<int>(cudaGetLastError());
}

template <int NK>
int launch_bf16(const Args<bf16>& a, int batch, cudaStream_t stream) {
  constexpr int bytes = bwd_smem_bytes<NK>();
  constexpr int splits = BwdSplit<NK>::kSplits;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_bf16<NK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dq_bf16<NK>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 kgrid(((a.tk + kTile - 1) / kTile) * splits, a.heads, batch);
  flash_bwd_dkdv_bf16<NK><<<kgrid, kMmaThreads, bytes, stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dk, a.dv, a.tq, a.tk, a.heads, a.dim,
      a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 qgrid(((a.tq + kTile - 1) / kTile) * splits, a.heads, batch);
  flash_bwd_dq_bf16<NK><<<qgrid, kMmaThreads, bytes, stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dq, a.tq, a.tk, a.heads, a.dim, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int NCH, int L, int BT>
int launch_f32(const Args<float>& a, int batch, cudaStream_t stream) {
  constexpr int R = kFmaThreads / L;
  const dim3 kgrid((a.tk + R - 1) / R, a.heads, batch);
  flash_bwd_dkdv_f32<NCH, L, BT><<<kgrid, kFmaThreads, 0, stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dk, a.dv, a.tq, a.tk, a.heads, a.dim,
      a.scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 qgrid((a.tq + R - 1) / R, a.heads, batch);
  flash_bwd_dq_f32<NCH, L, BT><<<qgrid, kFmaThreads, 0, stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dq, a.tq, a.tk, a.heads, a.dim, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
Args<T> make_args(const void* const* in, void* const* grads, const long long* s,
                  const void* dout, const void* lse, float* delta, int tq, int tk,
                  int heads, int dim, float scale) {
  auto view = [&](const void* p, int i) {
    return View<const T>{static_cast<const T*>(p), s[3 * i], s[3 * i + 1], s[3 * i + 2]};
  };
  auto grad = [&](void* p, int i) {
    return View<T>{static_cast<T*>(p), s[3 * i], s[3 * i + 1], s[3 * i + 2]};
  };
  return Args<T>{view(in[0], 0), view(in[1], 1), view(in[2], 2),
                 static_cast<const T*>(dout), static_cast<const float*>(lse), delta,
                 grad(grads[0], 3), grad(grads[1], 4), grad(grads[2], 5),
                 tq, tk, heads, dim, scale};
}

}  // namespace

// Plain C entry point for ctypes. `strides` holds the batch, token and head
// strides (in elements) of q, k, v, dq, dk and dv, in that order (18
// values); out and dout are contiguous [B, Tq, H, D], lse a contiguous
// [B*H, Tq] f32, and `delta` f32 scratch of B*H*Tq floats that the caller
// allocates. Launches the delta, dK/dV and dQ kernels on `stream` and
// returns the first CUDA error (0 on success). is_bf16 selects
// __nv_bfloat16 over float for q, k, v, out, dout, dq, dk and dv.
extern "C" int vaw_flash_bwd(const void* q, const void* k, const void* v,
                             const void* out, const void* dout, const void* lse,
                             void* delta, void* dq, void* dk, void* dv,
                             const long long* strides, int batch, int tq, int tk,
                             int heads, int dim, float scale, int is_bf16,
                             void* stream) {
  if (batch <= 0 || tq <= 0 || tk <= 0 || heads <= 0 || dim <= 0 || dim % 8 != 0 ||
      dim > 256 || batch > 65535 || heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* in[3] = {q, k, v};
  void* grads[3] = {dq, dk, dv};
  float* dl = static_cast<float*>(delta);
  if (!is_bf16) {
    const Args<float> a = make_args<float>(in, grads, strides, dout, lse, dl, tq, tk,
                                           heads, dim, scale);
    int err = launch_delta<float>(out, a.dout, dl, batch, tq, heads, dim, s);
    if (err) return err;
    if (dim <= 32) return launch_f32<2, 4, 32>(a, batch, s);
    if (dim <= 64) return launch_f32<4, 4, 32>(a, batch, s);
    if (dim <= 128) return launch_f32<8, 4, 32>(a, batch, s);
    return launch_f32<8, 8, 16>(a, batch, s);
  }
  const Args<bf16> a = make_args<bf16>(in, grads, strides, dout, lse, dl, tq, tk, heads,
                                       dim, scale);
  int err = launch_delta<bf16>(out, a.dout, dl, batch, tq, heads, dim, s);
  if (err) return err;
#define VAW_CASE(NK) \
  case NK: return launch_bf16<NK>(a, batch, s);
  switch ((dim + 15) / 16) {
    VAW_CASE(1) VAW_CASE(2) VAW_CASE(3) VAW_CASE(4) VAW_CASE(5) VAW_CASE(6) VAW_CASE(7)
    VAW_CASE(8) VAW_CASE(9) VAW_CASE(10) VAW_CASE(11) VAW_CASE(12) VAW_CASE(13)
    VAW_CASE(14) VAW_CASE(15) VAW_CASE(16)
  }
#undef VAW_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The f32 scratch of vaw_flash_bwd_wgmma, in floats: lse in the log2
// domain and delta for B*H rows of Tq rounded up to a 128-query work item,
// from the dQ kernel to the dK/dV kernel.
extern "C" long long vaw_flash_bwd_wgmma_scratch_floats(int batch, int tq, int heads) {
  return 2LL * batch * heads * padded_rows(tq);
}

// Plain C entry point of the wgmma kernels, bf16 only: the contract of
// vaw_flash_bwd for D <= 128 (padded to 32, 64, 80, 96 or 128) and scale >
// 0, except
// that `strides` holds the
// head, token and batch strides of q, k, v, dq, dk and dv in BYTES, in that
// order (18 values: each view's tensor map over [D, H, T, B],
// vaw_torch/ops/flash_attention.py:general_tensor_map), and `scratch` is
// f32 scratch of `scratch_floats` >= vaw_flash_bwd_wgmma_scratch_floats()
// floats (checked). Launches the dQ kernel (which also forms delta; at D >
// 96 flash_bwd_rows forms it first) and then the dK/dV kernel on `stream`;
// returns the first CUDA
// error (0 on success), or cudaErrorInvalidValue for a call the kernels do
// not take or a tensor map cuTensorMapEncodeTiled refuses.
extern "C" int vaw_flash_bwd_wgmma(const void* q, const void* k, const void* v,
                                   const void* out, const void* dout, const void* lse,
                                   void* scratch, long long scratch_floats, void* dq,
                                   void* dk, void* dv, const long long* strides,
                                   int batch, int tq, int tk, int heads, int dim,
                                   float scale, void* stream) {
  if (batch <= 0 || tq <= 0 || tk <= 0 || heads <= 0 || dim <= 0 || dim % 8 != 0 ||
      dim > 128 || !(scale > 0.f) ||
      scratch_floats < vaw_flash_bwd_wgmma_scratch_floats(batch, tq, heads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* in[3] = {q, k, v};
  void* grads[3] = {dq, dk, dv};
  const float* l = static_cast<const float*>(lse);
  float* sc = static_cast<float*>(scratch);
  if (dim <= 32) {
    return launch_wgmma<32>(in, out, dout, l, sc, grads, strides, batch, tq, tk, heads, dim,
                            scale, s);
  }
  if (dim <= 64) {
    return launch_wgmma<64>(in, out, dout, l, sc, grads, strides, batch, tq, tk, heads, dim,
                            scale, s);
  }
  if (dim <= 80) {
    return launch_wgmma<80>(in, out, dout, l, sc, grads, strides, batch, tq, tk, heads, dim,
                            scale, s);
  }
  if (dim <= 96) {
    return launch_wgmma<96>(in, out, dout, l, sc, grads, strides, batch, tq, tk, heads, dim,
                            scale, s);
  }
  return launch_wgmma<128>(in, out, dout, l, sc, grads, strides, batch, tq, tk, heads, dim,
                           scale, s);
}

// Plain C entry point of the 3xTF32 kernels, f32 only: the contract of
// vaw_flash_bwd_wgmma (D <= 64, scale > 0, `strides` the head, token and
// batch strides of q, k, v, dq, dk and dv in BYTES, `scratch` of at least
// vaw_flash_bwd_wgmma_scratch_floats() floats) with f32 q, k, v, out, dout,
// dq, dk and dv. Launches the dQ kernel (which also forms delta) and then
// the dK/dV kernel on `stream`; returns the first CUDA error (0 on
// success), or cudaErrorInvalidValue for a call the kernels do not take or
// a tensor map cuTensorMapEncodeTiled refuses.
extern "C" int vaw_flash_bwd_tf32x3(const void* q, const void* k, const void* v,
                                    const void* out, const void* dout, const void* lse,
                                    void* scratch, long long scratch_floats, void* dq,
                                    void* dk, void* dv, const long long* strides,
                                    int batch, int tq, int tk, int heads, int dim,
                                    float scale, void* stream) {
  if (batch <= 0 || tq <= 0 || tk <= 0 || heads <= 0 || dim <= 0 || dim % 8 != 0 ||
      dim > 64 || !(scale > 0.f) ||
      scratch_floats < vaw_flash_bwd_wgmma_scratch_floats(batch, tq, heads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* in[3] = {q, k, v};
  void* grads[3] = {dq, dk, dv};
  const float* l = static_cast<const float*>(lse);
  float* sc = static_cast<float*>(scratch);
  if (dim <= 32) {
    return launch_tf32x3<32>(in, out, dout, l, sc, grads, strides, batch, tq, tk, heads,
                             dim, scale, s);
  }
  return launch_tf32x3<64>(in, out, dout, l, sc, grads, strides, batch, tq, tk, heads, dim,
                           scale, s);
}
