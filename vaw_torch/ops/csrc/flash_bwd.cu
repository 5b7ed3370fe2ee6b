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
// Three designs, chosen by the call (vaw_torch/ops/flash_attention.py:
// flash_bwd_design):
//
// wgmma (bf16 with D <= 64 and scale > 0: every model call, and also the
// fused attention's backward, whose packed [B, T, 3, H, D] row gives the six
// views, flash_attention.py:flash_attention_fused_bwd), for Hopper;
// TMA loads through one 4-D tensor map a view (q, k, v, dq, dk, dv with
// their own byte strides; out and dout contiguous), the head dim one slab
// as in flash_fwd.cu (64-byte swizzle for D <= 32), persistent blocks of
// two consumer warpgroups and one producer warp with a ring of stages:
//   1. dQ: an item is 128 queries of one (b, h); k and v stream through.
//      Each item first forms its rows' delta from out and dout (loaded
//      with q) and writes delta and lse (log2 domain) to a scratch the
//      next kernel reads; then per key tile S = q k^T and dP = dout v^T,
//      dS = P (dP - delta), dQ += dS k with dS from registers; tile j's S
//      and dP are issued before tile j-1's dS k.
//   2. dK/dV: an item is 128 keys of one (b, h); q, dout and their rows'
//      lse and delta stream through. Per query tile S^T = k q^T and dP^T =
//      v dout^T, then dV += P^T dout and dK += dS^T q with P^T and dS^T
//      from registers; see the kernel for why its tiles run in order.
//   Both write their gradients by 4-D TMA stores through the gradients'
//   own strides (three tensors, or the thirds of one packed gradient).
// mma.sync (other bf16 calls) and f32, FlashAttention-2 style: three
// kernels run in order on one stream:
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
constexpr int kWgThreads = kConsumers + 32;   // and one producer warp
constexpr int kSmemBudget = 232448 - 1024 - 512;  // less the alignment and barriers

// Rows of the lse / delta scratch per (b, h): Tq rounded up to a work item.
__host__ __device__ constexpr long long padded_rows(int tq) {
  return (tq + kItemRows - 1) / kItemRows * (long long)kItemRows;
}

// dQ kernel: q, dout and out of two work items, NS stages of K and V, dq
// staged for its TMA store. Every tile is a multiple of 4096 bytes.
template <int DP, int NS>
struct DqSmem {
  bf16 q[2][kItemRows][DP];
  bf16 dout[2][kItemRows][DP];
  bf16 o[2][kItemRows][DP];
  bf16 k[NS][kWgRows][DP];
  bf16 v[NS][kWgRows][DP];
  bf16 dq[kItemRows][DP];
  uint64_t q_full[2];
  uint64_t q_empty[2];
  uint64_t full[NS];
  uint64_t empty[NS];
};

// dK/dV kernel: k and v of two work items, NS stages of q, dout and their
// rows' lse (log2 domain) and delta, dk and dv staged for their stores.
template <int DP, int NS>
struct DkvSmem {
  bf16 k[2][kItemRows][DP];
  bf16 v[2][kItemRows][DP];
  bf16 q[NS][kWgRows][DP];
  bf16 dout[NS][kWgRows][DP];
  bf16 dk[kItemRows][DP];
  bf16 dv[kItemRows][DP];
  float lse2[NS][kWgRows];
  float delta[NS][kWgRows];
  uint64_t kv_full[2];
  uint64_t kv_empty[2];
  uint64_t full[NS];
  uint64_t empty[NS];
};

template <int DP>
constexpr int dq_stages() {
  constexpr int room = (kSmemBudget - 7 * kItemRows * DP * 2) / (2 * kWgRows * DP * 2);
  return room > 8 ? 8 : room;
}

template <int DP>
constexpr int dkv_stages() {
  constexpr int room =
      (kSmemBudget - 6 * kItemRows * DP * 2) / (2 * kWgRows * DP * 2 + 2 * kWgRows * 4);
  return room > 8 ? 8 : room;
}

// acc (a warpgroup's 64 x DP accumulator, times `mul`) in bf16 to rows
// 64 * wg .. of a [128][DP] staging tile, swizzled as the store's tensor
// map reads it.
template <int DP>
__device__ __forceinline__ void stage_acc(bf16 (*tile)[DP], const float (&acc)[DP / 2],
                                          int wg, int warp, int quad, int pair, float mul) {
  constexpr int SW = AttnGeo<DP>::kSwizzle;
  uint8_t* base = reinterpret_cast<uint8_t*>(&tile[0][0]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = kWgRows * wg + 16 * warp + quad + 8 * r;
#pragma unroll
    for (int c = 0; c < DP / 8; ++c) {
      *reinterpret_cast<__nv_bfloat162*>(base + swizzled<SW>(row, c) + 4 * pair) =
          __floats2bfloat162_rn(acc[4 * c + 2 * r] * mul, acc[4 * c + 2 * r + 1] * mul);
    }
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
// then dQ += dS k with dS from registers (bf16 hi + lo) and k as the
// MN-major B operand; tile j's S and dP are issued before tile j-1's dS k.
// dQ is scaled once at the end. 168 registers a thread suffice here.
template <int DP, int NS>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   const __grid_constant__ CUtensorMap dout_map,
                   const __grid_constant__ CUtensorMap out_map,
                   const __grid_constant__ CUtensorMap dq_map,
                   const float* __restrict__ lse, float* __restrict__ lse2_out,
                   float* __restrict__ delta_out, int batch, int tq, int tk, int heads,
                   float scale) {
  using G = AttnGeo<DP>;
  constexpr int SW = G::kSwizzle;
  constexpr uint32_t kBox = G::kBox;
  using Smem = DqSmem<DP, NS>;
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  const int tid = threadIdx.x;
  const int n_tiles = (tk + kWgRows - 1) / kWgRows;
  const int q_tiles = (tq + kItemRows - 1) / kItemRows;
  const int items = batch * heads * q_tiles;
  const long long tq_pad = padded_rows(tq);

  if (tid == 0) init_barriers(sm.q_full, sm.q_empty, sm.full, sm.empty, NS, kConsumers);
  __syncthreads();

  if (tid >= kConsumers) {
    if (tid == kConsumers) {
      prefetch_tensor_map(&q_map);
      prefetch_tensor_map(&dout_map);
      prefetch_tensor_map(&out_map);
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
        mbar_arrive_expect_tx(&sm.q_full[qb], 6 * kBox);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t0 = q0 + kWgRows * half;
          tma_load_4d(&sm.q[qb][kWgRows * half][0], &q_map, &sm.q_full[qb], 0, h, t0, b);
          tma_load_4d(&sm.dout[qb][kWgRows * half][0], &dout_map, &sm.q_full[qb], 0, h, t0,
                      b);
          tma_load_4d(&sm.o[qb][kWgRows * half][0], &out_map, &sm.q_full[qb], 0, h, t0, b);
        }
        for (int j = 0; j < n_tiles; ++j, ++it) {
          const int stage = it % NS;
          if (it >= NS) mbar_wait(&sm.empty[stage], (it / NS - 1) & 1);
          mbar_arrive_expect_tx(&sm.full[stage], 2 * kBox);
          tma_load_4d(&sm.k[stage][0][0], &k_map, &sm.full[stage], 0, h, j * kWgRows, b);
          tma_load_4d(&sm.v[stage][0][0], &v_map, &sm.full[stage], 0, h, j * kWgRows, b);
        }
      }
    }
    return;
  }

  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int quad = lane / 4;
  const int pair = lane % 4;
  const int wg_leader = tid % 128 == 0;
  const float scale_log2 = scale * kLog2e;

  float dq[DP / 2];
  float s[32], dp[32];           // S and dP of one key tile: 64 rows x 64 keys
  uint32_t hi[4][4], lo[4][4];   // dS of the previous tile, bf16 hi + lo

  auto issue_s_dp = [&](int qb, int stage) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint64_t dq_ = desc_k_major<SW>(
          reinterpret_cast<const uint8_t*>(&sm.q[qb][kWgRows * wg][0]) + 32 * kk);
      const uint64_t dk_ = desc_k_major<SW>(
          reinterpret_cast<const uint8_t*>(&sm.k[stage][0][0]) + 32 * kk);
      Wgmma<64>::ss<0, 0>(s, dq_, dk_, kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint64_t ddo = desc_k_major<SW>(
          reinterpret_cast<const uint8_t*>(&sm.dout[qb][kWgRows * wg][0]) + 32 * kk);
      const uint64_t dv_ = desc_k_major<SW>(
          reinterpret_cast<const uint8_t*>(&sm.v[stage][0][0]) + 32 * kk);
      Wgmma<64>::ss<0, 0>(dp, ddo, dv_, kk > 0);
    }
  };
  auto issue_dq = [&](int stage) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = desc_mn_major<SW>(&sm.k[stage][16 * kk][0], kBox);
      Wgmma<DP>::template rs<1>(dq, hi[kk], db, 1);
      Wgmma<DP>::template rs<1>(dq, lo[kk], db, 1);
    }
  };

  // lse of this thread's rows, loaded one work item ahead so that its
  // latency hides behind a whole item.
  float lse_next[2] = {0.f, 0.f};
  auto load_lse = [&](int item) {
    if (item >= items) return;
    const int q0 = (item % q_tiles) * kItemRows;
    const long long bh = item / q_tiles;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + kWgRows * wg + 16 * warp + quad + 8 * r;
      load_if(lse_next[r], lse + bh * tq + row, row < tq);
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
        const uint32_t off = swizzled<SW>(row, c);
        const uint8_t* o_tile = reinterpret_cast<const uint8_t*>(&sm.o[qb][0][0]);
        const uint8_t* do_tile = reinterpret_cast<const uint8_t*>(&sm.dout[qb][0][0]);
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

    mbar_wait(&sm.full[it % NS], (it / NS) & 1);
    wgmma_fence();
    issue_s_dp(qb, it % NS);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    if (n_tiles == 1) mbar_arrive(&sm.q_empty[qb]);
    ds_tile(0);
    split_p(s, hi, lo);
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
      fence_p(hi, lo);
      mbar_arrive(&sm.empty[prev]);
      split_p(s, hi, lo);
    }
    const int last = (it + n_tiles - 1) % NS;
    wgmma_fence();
    issue_dq(last);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    fence_p(hi, lo);
    mbar_arrive(&sm.empty[last]);
    it += n_tiles;

    // dq * scale in bf16 to shared memory and out by a TMA store through
    // dq's own strides; rows past Tq and columns past D are not written.
    if (wg_leader) bulk_wait<true>();
    named_barrier(1 + wg, 128);
    stage_acc<DP>(sm.dq, dq, wg, warp, quad, pair, scale);
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    if (wg_leader) {
      tma_store_4d(&dq_map, &sm.dq[kWgRows * wg][0], 0, h, q0 + kWgRows * wg, b);
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
// (bf16 hi + lo) and dout and q as MN-major B operands. dK is scaled once
// at the end (dK = dS^T q^ with q^ = q * scale). Keys past Tk compute
// values that are never stored.
// Registers set the design: with the producer warp, three warps share one
// quarter of the register file, so a thread has at most 168, and dK and
// dV alone take 2 * DP / 2 of them. A warpgroup therefore runs a tile's
// steps in order (S^T and dP^T, then the dV and dK products), issuing the
// dV products before it splits dS^T; the other warpgroup's softmax runs
// while its products are on the tensor cores. Issuing tile j+1's S^T and
// dP^T before tile j's products (as the dQ kernel does) needs about 200
// registers a thread.
template <int DP, int NS>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap dout_map,
                     const __grid_constant__ CUtensorMap dk_map,
                     const __grid_constant__ CUtensorMap dv_map,
                     const float* __restrict__ lse2_in, const float* __restrict__ delta_in,
                     int batch, int tq, int tk, int heads, float scale) {
  using G = AttnGeo<DP>;
  constexpr int SW = G::kSwizzle;
  constexpr uint32_t kBox = G::kBox;
  constexpr uint32_t kRowBytes = kWgRows * 4;  // lse2 or delta of a stage
  using Smem = DkvSmem<DP, NS>;
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  const int tid = threadIdx.x;
  const int n_tiles = (tq + kWgRows - 1) / kWgRows;
  const int k_tiles = (tk + kItemRows - 1) / kItemRows;
  const int items = batch * heads * k_tiles;
  const long long tq_pad = padded_rows(tq);

  if (tid == 0) init_barriers(sm.kv_full, sm.kv_empty, sm.full, sm.empty, NS, kConsumers);
  __syncthreads();

  if (tid >= kConsumers) {
    if (tid == kConsumers) {
      prefetch_tensor_map(&k_map);
      prefetch_tensor_map(&v_map);
      prefetch_tensor_map(&q_map);
      prefetch_tensor_map(&dout_map);
      int it = 0;
      int n = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
        const int k0 = (item % k_tiles) * kItemRows;
        const int h = (item / k_tiles) % heads;
        const int b = item / k_tiles / heads;
        const long long bh = (long long)b * heads + h;
        const int kb = n & 1;
        if (n >= 2) mbar_wait(&sm.kv_empty[kb], (n / 2 - 1) & 1);
        mbar_arrive_expect_tx(&sm.kv_full[kb], 4 * kBox);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          tma_load_4d(&sm.k[kb][kWgRows * half][0], &k_map, &sm.kv_full[kb], 0, h,
                      k0 + kWgRows * half, b);
          tma_load_4d(&sm.v[kb][kWgRows * half][0], &v_map, &sm.kv_full[kb], 0, h,
                      k0 + kWgRows * half, b);
        }
        for (int j = 0; j < n_tiles; ++j, ++it) {
          const int stage = it % NS;
          if (it >= NS) mbar_wait(&sm.empty[stage], (it / NS - 1) & 1);
          mbar_arrive_expect_tx(&sm.full[stage], 2 * kBox + 2 * kRowBytes);
          tma_load_4d(&sm.q[stage][0][0], &q_map, &sm.full[stage], 0, h, j * kWgRows, b);
          tma_load_4d(&sm.dout[stage][0][0], &dout_map, &sm.full[stage], 0, h,
                      j * kWgRows, b);
          bulk_load(&sm.lse2[stage][0], lse2_in + bh * tq_pad + j * kWgRows, kRowBytes,
                    &sm.full[stage]);
          bulk_load(&sm.delta[stage][0], delta_in + bh * tq_pad + j * kWgRows, kRowBytes,
                    &sm.full[stage]);
        }
      }
    }
    return;
  }

  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int quad = lane / 4;
  const int pair = lane % 4;
  const int wg_leader = tid % 128 == 0;
  const float scale_log2 = scale * kLog2e;

  float dk[DP / 2], dv[DP / 2];
  float st[32], dpt[32];         // S^T and dP^T of one query tile: 64 keys x 64 queries
  uint32_t hi[4][4], lo[4][4];   // P^T, then dS^T, in bf16 hi + lo

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
        const uint64_t da = desc_k_major<SW>(
            reinterpret_cast<const uint8_t*>(&sm.k[kb][kWgRows * wg][0]) + 32 * kk);
        const uint64_t db = desc_k_major<SW>(
            reinterpret_cast<const uint8_t*>(&sm.q[stage][0][0]) + 32 * kk);
        Wgmma<64>::ss<0, 0>(st, da, db, kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint64_t da = desc_k_major<SW>(
            reinterpret_cast<const uint8_t*>(&sm.v[kb][kWgRows * wg][0]) + 32 * kk);
        const uint64_t db = desc_k_major<SW>(
            reinterpret_cast<const uint8_t*>(&sm.dout[stage][0][0]) + 32 * kk);
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
      split_p(st, hi, lo);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = desc_mn_major<SW>(&sm.dout[stage][16 * kk][0], kBox);
        Wgmma<DP>::template rs<1>(dv, hi[kk], db, 1);
        Wgmma<DP>::template rs<1>(dv, lo[kk], db, 1);
      }
      wgmma_commit();
      uint32_t shi[4][4], slo[4][4];
      split_p(dpt, shi, slo);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = desc_mn_major<SW>(&sm.q[stage][16 * kk][0], kBox);
        Wgmma<DP>::template rs<1>(dk, shi[kk], db, 1);
        Wgmma<DP>::template rs<1>(dk, slo[kk], db, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
      fence_p(hi, lo);
      fence_p(shi, slo);
      mbar_arrive(&sm.empty[stage]);
    }

    if (wg_leader) bulk_wait<true>();
    named_barrier(1 + wg, 128);
    stage_acc<DP>(sm.dk, dk, wg, warp, quad, pair, scale);
    stage_acc<DP>(sm.dv, dv, wg, warp, quad, pair, 1.f);
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    if (wg_leader) {
      tma_store_4d(&dk_map, &sm.dk[kWgRows * wg][0], 0, h, k0 + kWgRows * wg, b);
      tma_store_4d(&dv_map, &sm.dv[kWgRows * wg][0], 0, h, k0 + kWgRows * wg, b);
      bulk_commit();
    }
  }
  if (wg_leader) bulk_wait<false>();
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
  CUtensorMap maps[8];
  for (int i = 0; i < 6; ++i) {
    if (!make_view_map<DP>(&maps[i], ptrs[i], batch, seqs[i], heads, dim, strides + 3 * i)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (!make_view_map<DP>(&maps[6], dout, batch, tq, heads, dim, nullptr) ||
      !make_view_map<DP>(&maps[7], out, batch, tq, heads, dim, nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
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

  auto dq_kernel = flash_bwd_dq_wgmma<DP, NQ>;
  const int dq_smem = static_cast<int>(sizeof(DqSmem<DP, NQ>)) + 1024;
  static const cudaError_t dq_attr = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem);
  if (dq_attr != cudaSuccess) return static_cast<int>(dq_attr);
  dq_kernel<<<q_items < sms ? static_cast<int>(q_items) : sms, kWgThreads, dq_smem,
              stream>>>(maps[0], maps[1], maps[2], maps[6], maps[7], maps[3], lse, lse2,
                        delta, batch, tq, tk, heads, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  auto dkv_kernel = flash_bwd_dkdv_wgmma<DP, NK>;
  const int dkv_smem = static_cast<int>(sizeof(DkvSmem<DP, NK>)) + 1024;
  static const cudaError_t dkv_attr = cudaFuncSetAttribute(
      dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_smem);
  if (dkv_attr != cudaSuccess) return static_cast<int>(dkv_attr);
  dkv_kernel<<<k_items < sms ? static_cast<int>(k_items) : sms, kWgThreads, dkv_smem,
               stream>>>(maps[0], maps[1], maps[2], maps[6], maps[4], maps[5], lse2, delta,
                         batch, tq, tk, heads, scale);
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
// vaw_flash_bwd for D <= 64 and scale > 0, except that `strides` holds the
// head, token and batch strides of q, k, v, dq, dk and dv in BYTES, in that
// order (18 values: each view's tensor map over [D, H, T, B],
// vaw_torch/ops/flash_attention.py:general_tensor_map), and `scratch` is
// f32 scratch of `scratch_floats` >= vaw_flash_bwd_wgmma_scratch_floats()
// floats (checked). Launches the dQ kernel (which also forms
// delta) and then the dK/dV kernel on `stream`; returns the first CUDA
// error (0 on success), or cudaErrorInvalidValue for a call the kernels do
// not take or a tensor map cuTensorMapEncodeTiled refuses.
extern "C" int vaw_flash_bwd_wgmma(const void* q, const void* k, const void* v,
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
    return launch_wgmma<32>(in, out, dout, l, sc, grads, strides, batch, tq, tk, heads, dim,
                            scale, s);
  }
  return launch_wgmma<64>(in, out, dout, l, sc, grads, strides, batch, tq, tk, heads, dim,
                          scale, s);
}
