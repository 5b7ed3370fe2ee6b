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
// bf16 peak. So it is memory-bound at that shape.
//
// Design (FlashAttention-2 style, deterministic, no atomics). The TPU
// kernel accumulates dK and dV across its sequential grid of query blocks;
// on the card blocks run in parallel, so three kernels run in order on one
// stream:
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
// wgmma, TMA and a cp.async pipeline are later work.

#include "flash_common.cuh"

namespace {

using namespace vaw_flash;
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
