// Backward of the fused multi-head softmax attention, read straight from the
// raw fused QKV projection and written straight into one fused gradient.
//
// Replaces vaw_tpu/ops/flash_attention.py:_bwd_kernel_p6 (the backward of
// _flash_p6). Same contract:
//   qkv  [B, T, 3*H*D] (bf16 or f32), last axis laid out (3, H, D), row
//        stride 3*H*D: q, k and v of head h are read in place.
//   out  [B, T, H*D] the forward's output, in the input dtype.
//   dout [B, T, H*D] the incoming gradient, in the input dtype.
//   lse  [B*H, T] f32, the forward's natural-log log-sum-exp.
//   dqkv [B, T, 3*H*D] in the input dtype, laid out like qkv: dq, dk and dv
//        of head h go to column offsets h*D, H*D + h*D and 2*H*D + h*D.
// The math, all in f32 (vaw_tpu/ops/flash_attention.py:597-623):
//   q^ = q * scale, S = q^ k^T, P = exp(S - lse), delta = rowsum(dout * out),
//   dV = P^T dout, dS = P * (dout v^T - delta), dK = dS^T q^,
//   dQ = (dS k) * scale.
// delta is formed in f32 from the input-dtype out that the forward wrote.
//
// Bound. At the DiT-B/2 training shape (B = 256, T = 256, H = 12, D = 64,
// bf16) one call reads 302 MB of qkv, 101 MB each of out and dout and 3 MB
// of lse, and writes 302 MB of dqkv: about 809 MB, or 241 us at 3.35 TB/s.
// Its five products are 10*B*H*T*T*D = 129 GFLOP, 131 us at the bf16 peak.
// So it is memory-bound at that shape.
//
// Which kernels. For bf16 with D <= 64 and scale > 0 (every DiT-B/2 call)
// the wrapper launches flash_bwd.cu's TMA + wgmma pair instead
// (vaw_torch/ops/flash_attention.py:flash_fused_bwd_design): this contract
// is the general backward's at Tq = Tk, with q, k, v, dq, dk and dv the
// strided thirds of the packed [B, T, 3, H, D] row. This file keeps the
// kernels of the other calls (bf16 with D = 72 or 128 or scale <= 0, and
// f32).
//
// Design (FlashAttention-2 style, deterministic, no atomics). The TPU kernel
// holds all 256 keys of several (batch, head) rows in VMEM; its T == 256
// gate is a VMEM limit. Here three kernels run in order on one stream:
//   1. delta: one thread per (b, t, h) row, 16-byte loads of out and dout.
//   2. dK/dV: one block per (b, h, 64-key tile). Each of its four warps owns
//      16 keys; the block loops over 64-query tiles of q and dout staged in
//      shared memory, recomputes S^T and P^T, and accumulates dV and dK in
//      registers. dK is multiplied by the scale once at the end.
//   3. dQ: one block per (b, h, 64-query tile), looping over 64-key tiles of
//      k and v in shared memory; dQ is multiplied by the scale at the end.
// Key and query tails are zero-filled in shared memory and masked (P = 0),
// so any T works. Each block reads its own tile once and the other side's
// tiles once per tile (T/64 times per head, mostly from L2).
//
// bf16: mma.sync m16n8k16 with f32 accumulators, as the forward. Products
// of bf16 inputs are exact in f32, so S and dP are the f32 values; the scale
// multiplies S in f32. P and dS enter their products split into two bf16
// terms, x = hi + lo with hi = bf16(x) and lo = bf16(x - hi), which keeps
// about 16 significant bits instead of 8.
// f32: plain FMAs with every operand f32, q^ = q * scale formed at load as
// the TPU kernel does. Four neighbouring threads share one row; each holds
// a quarter of the head dim (interleaved 4-float chunks) and two warp
// shuffles complete each dot product.

#include "flash_common.cuh"

namespace {

using namespace vaw_flash;

// delta[(b*H + h)*T + t] = sum_d dout[b, t, h, d] * out[b, t, h, d] in f32.
template <typename T>
__global__ void flash_fused_bwd_delta(const T* __restrict__ out,
                                      const T* __restrict__ dout,
                                      float* __restrict__ delta, long long rows,
                                      int seq, int heads, int dim) {
  bwd_delta_row<T>(out, dout, delta, rows, seq, heads, dim);
}

// ------------------------------------------------------------------ bf16
template <int NK>
constexpr int bf16_smem_bytes() {
  return 4 * kTile * (16 * NK + kRowPad) * 2 + 2 * kTile * 4;
}

// NK: 16-wide steps of the head dim, zero-padded to DP = 16 * NK.
template <int NK>
__global__ void __launch_bounds__(kMmaThreads)
flash_fused_bwd_dkdv_bf16(const __nv_bfloat16* __restrict__ qkv,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dqkv, int seq, int heads,
                          int dim, float scale) {
  constexpr int DP = 16 * NK;
  constexpr int ND = 2 * NK;  // 8-wide output column tiles
  constexpr int LD = DP + kRowPad;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16 (*ks)[LD] = reinterpret_cast<__nv_bfloat16 (*)[LD]>(smem);
  __nv_bfloat16 (*vs)[LD] = ks + kTile;
  __nv_bfloat16 (*qs)[LD] = vs + kTile;
  __nv_bfloat16 (*dos)[LD] = qs + kTile;  // dout rows of the query tile
  float* lse_s = reinterpret_cast<float*>(dos + kTile);
  float* delta_s = lse_s + kTile;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int quad = lane / 4;
  const int pair = lane % 4;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hd = heads * dim;
  const long long row_stride = 3LL * hd;
  const __nv_bfloat16* base = qkv + (long long)b * seq * row_stride + (long long)h * dim;
  const __nv_bfloat16* dbase = dout + (long long)b * seq * hd + (long long)h * dim;
  const float* lse_row = lse + ((long long)b * heads + h) * seq;
  const float* delta_row = delta + ((long long)b * heads + h) * seq;
  const int k0 = blockIdx.x * kTile;
  const int kr = warp * 16;  // this warp's first key row in the tile
  const float scale_log2 = scale * kLog2e;

  stage_tile<LD>(ks, base + hd, row_stride, k0, seq, 0, 16 * NK, dim, tid);
  stage_tile<LD>(vs, base + 2 * hd, row_stride, k0, seq, 0, 16 * NK, dim, tid);

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nd][e] = dv[nd][e] = 0.f;
  }

  const int n_tiles = (seq + kTile - 1) / kTile;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int q0 = tile * kTile;
    __syncthreads();  // the previous query tile has been consumed
    stage_tile<LD>(qs, base, row_stride, q0, seq, 0, 16 * NK, dim, tid);
    stage_tile<LD>(dos, dbase, hd, q0, seq, 0, 16 * NK, dim, tid);
    for (int i = tid; i < kTile; i += kMmaThreads) {
      const bool valid = q0 + i < seq;
      lse_s[i] = valid ? lse_row[q0 + i] * kLog2e : INFINITY;  // P = 0 past seq
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
        const __nv_bfloat16* qrow = &qs[nt * 8 + quad][kk * 16 + 2 * pair];
        mma_16816(st[nt], ka, ld_u32(qrow), ld_u32(qrow + 8));
        const __nv_bfloat16* drow = &dos[nt * 8 + quad][kk * 16 + 2 * pair];
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
    // dV += P^T dout and dK += dS^T q, 16 queries per step.
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t phi[4], plo[4], shi[4], slo[4];
      split_a(phi, plo, st, kk);
      split_a(shi, slo, dpt, kk);
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, &dos[kk * 16 + (lane & 15)][nd * 8]);
        mma_16816(dv[nd], phi, b0, b1);
        mma_16816(dv[nd], plo, b0, b1);
        ldmatrix_x2_trans(b0, b1, &qs[kk * 16 + (lane & 15)][nd * 8]);
        mma_16816(dk[nd], shi, b0, b1);
        mma_16816(dk[nd], slo, b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + kr + quad + 8 * r;
    if (key >= seq) continue;
    __nv_bfloat16* o = dqkv + ((long long)b * seq + key) * row_stride + (long long)h * dim;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const int col = nd * 8 + 2 * pair;
      if (col < dim) {
        *reinterpret_cast<__nv_bfloat162*>(o + hd + col) =
            __floats2bfloat162_rn(dk[nd][2 * r] * scale, dk[nd][2 * r + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(o + 2 * hd + col) =
            __floats2bfloat162_rn(dv[nd][2 * r], dv[nd][2 * r + 1]);
      }
    }
  }
}

template <int NK>
__global__ void __launch_bounds__(kMmaThreads)
flash_fused_bwd_dq_bf16(const __nv_bfloat16* __restrict__ qkv,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dqkv, int seq, int heads,
                        int dim, float scale) {
  constexpr int DP = 16 * NK;
  constexpr int ND = 2 * NK;
  constexpr int LD = DP + kRowPad;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16 (*qs)[LD] = reinterpret_cast<__nv_bfloat16 (*)[LD]>(smem);
  __nv_bfloat16 (*dos)[LD] = qs + kTile;  // dout rows of this block's queries
  __nv_bfloat16 (*ks)[LD] = dos + kTile;
  __nv_bfloat16 (*vs)[LD] = ks + kTile;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int quad = lane / 4;
  const int pair = lane % 4;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hd = heads * dim;
  const long long row_stride = 3LL * hd;
  const __nv_bfloat16* base = qkv + (long long)b * seq * row_stride + (long long)h * dim;
  const __nv_bfloat16* dbase = dout + (long long)b * seq * hd + (long long)h * dim;
  const long long lrow = ((long long)b * heads + h) * seq;
  const int q0 = blockIdx.x * kTile;
  const int qr = warp * 16;  // this warp's first query row in the tile
  const float scale_log2 = scale * kLog2e;

  stage_tile<LD>(qs, base, row_stride, q0, seq, 0, 16 * NK, dim, tid);
  stage_tile<LD>(dos, dbase, hd, q0, seq, 0, 16 * NK, dim, tid);
  // lse (log2 domain) and delta of this thread's rows qr + quad (+ 8).
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + qr + quad + 8 * r;
    lse_r[r] = row < seq ? lse[lrow + row] * kLog2e : 0.f;
    delta_r[r] = row < seq ? delta[lrow + row] : 0.f;
  }

  float dq[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[nd][e] = 0.f;
  }

  const int n_tiles = (seq + kTile - 1) / kTile;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kTile;
    __syncthreads();  // the previous key tile has been consumed
    stage_tile<LD>(ks, base + hd, row_stride, k0, seq, 0, 16 * NK, dim, tid);
    stage_tile<LD>(vs, base + 2 * hd, row_stride, k0, seq, 0, 16 * NK, dim, tid);
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
        const __nv_bfloat16* krow = &ks[nt * 8 + quad][kk * 16 + 2 * pair];
        mma_16816(s[nt], qa, ld_u32(krow), ld_u32(krow + 8));
        const __nv_bfloat16* vrow = &vs[nt * 8 + quad][kk * 16 + 2 * pair];
        mma_16816(dp[nt], da, ld_u32(vrow), ld_u32(vrow + 8));
      }
    }
    // dS = P (dP - delta), P = exp(S - lse), 0 for keys past seq.
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * pair + (e & 1);
        const int r = e >> 1;
        const float p = key < seq ? exp2f(s[nt][e] * scale_log2 - lse_r[r]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - delta_r[r]);
      }
    }
    // dQ += dS k, 16 keys per step.
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_a(hi, lo, s, kk);
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, &ks[kk * 16 + (lane & 15)][nd * 8]);
        mma_16816(dq[nd], hi, b0, b1);
        mma_16816(dq[nd], lo, b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + qr + quad + 8 * r;
    if (row >= seq) continue;
    __nv_bfloat16* o = dqkv + ((long long)b * seq + row) * row_stride + (long long)h * dim;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const int col = nd * 8 + 2 * pair;
      if (col < dim) {
        *reinterpret_cast<__nv_bfloat162*>(o + col) =
            __floats2bfloat162_rn(dq[nd][2 * r] * scale, dq[nd][2 * r + 1] * scale);
      }
    }
  }
}

// ------------------------------------------------------------------- f32
constexpr int kLanesPerRow = 4;
constexpr int kFmaBlock = 32;  // rows per streamed tile

template <int NCH>
__global__ void __launch_bounds__(kFmaThreads)
flash_fused_bwd_dkdv_f32(const float* __restrict__ qkv, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dqkv, int seq, int heads, int dim,
                         float scale) {
  constexpr int DP = 16 * NCH;
  __shared__ __align__(16) float qs[kFmaBlock][DP];  // q^ = q * scale
  __shared__ __align__(16) float ds[kFmaBlock][DP];  // dout
  __shared__ float lse_s[kFmaBlock];
  __shared__ float delta_s[kFmaBlock];

  const int tid = threadIdx.x;
  const int part = tid & (kLanesPerRow - 1);
  const int key = blockIdx.x * kTile + tid / kLanesPerRow;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hd = heads * dim;
  const long long row_stride = 3LL * hd;
  const float* base = qkv + (long long)b * seq * row_stride + (long long)h * dim;
  const float* dbase = dout + (long long)b * seq * hd + (long long)h * dim;
  const long long lrow = ((long long)b * heads + h) * seq;
  const bool k_valid = key < seq;

  float k[NCH][4], v[NCH][4], dk[NCH][4], dv[NCH][4];
  const float* krow = base + (long long)key * row_stride;
  load_row<NCH, kLanesPerRow>(k, krow + hd, k_valid, dim, part, 1.f);
  load_row<NCH, kLanesPerRow>(v, krow + 2 * hd, k_valid, dim, part, 1.f);
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;
  }
  zero_pad<kFmaBlock, DP>(qs, ds, dim, tid);

  const int n_tiles = (seq + kFmaBlock - 1) / kFmaBlock;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int q0 = tile * kFmaBlock;
    __syncthreads();
    stage_rows<kFmaBlock, DP>(qs, base, row_stride, q0, seq, dim, scale, tid);
    stage_rows<kFmaBlock, DP>(ds, dbase, hd, q0, seq, dim, 1.f, tid);
    for (int i = tid; i < kFmaBlock; i += kFmaThreads) {
      const bool valid = q0 + i < seq;
      lse_s[i] = valid ? lse[lrow + q0 + i] * kLog2e : INFINITY;  // P = 0 past seq
      delta_s[i] = valid ? delta[lrow + q0 + i] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kFmaBlock; ++j) {
      const float s = row_dot<NCH, kLanesPerRow>(k, qs[j], part);
      const float dp = row_dot<NCH, kLanesPerRow>(v, ds[j], part);
      const float p = exp2f(s * kLog2e - lse_s[j]);
      row_axpy<NCH, kLanesPerRow>(dv, p, ds[j], part);
      row_axpy<NCH, kLanesPerRow>(dk, p * (dp - delta_s[j]), qs[j], part);
    }
  }
  if (k_valid) {
    float* o = dqkv + ((long long)b * seq + key) * row_stride + (long long)h * dim;
    store_row<NCH, kLanesPerRow>(o + hd, dk, dim, part, 1.f);
    store_row<NCH, kLanesPerRow>(o + 2 * hd, dv, dim, part, 1.f);
  }
}

template <int NCH>
__global__ void __launch_bounds__(kFmaThreads)
flash_fused_bwd_dq_f32(const float* __restrict__ qkv, const float* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       float* __restrict__ dqkv, int seq, int heads, int dim,
                       float scale) {
  constexpr int DP = 16 * NCH;
  __shared__ __align__(16) float ks[kFmaBlock][DP];
  __shared__ __align__(16) float vs[kFmaBlock][DP];

  const int tid = threadIdx.x;
  const int part = tid & (kLanesPerRow - 1);
  const int row = blockIdx.x * kTile + tid / kLanesPerRow;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hd = heads * dim;
  const long long row_stride = 3LL * hd;
  const float* base = qkv + (long long)b * seq * row_stride + (long long)h * dim;
  const float* dbase = dout + (long long)b * seq * hd + (long long)h * dim;
  const long long lrow = ((long long)b * heads + h) * seq;
  const bool q_valid = row < seq;

  float q[NCH][4], d_o[NCH][4], dq[NCH][4];
  load_row<NCH, kLanesPerRow>(q, base + (long long)row * row_stride, q_valid, dim, part,
                              scale);
  load_row<NCH, kLanesPerRow>(d_o, dbase + (long long)row * hd, q_valid, dim, part, 1.f);
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[i][e] = 0.f;
  }
  const float lse_q = q_valid ? lse[lrow + row] * kLog2e : 0.f;
  const float delta_q = q_valid ? delta[lrow + row] : 0.f;
  zero_pad<kFmaBlock, DP>(ks, vs, dim, tid);

  const int n_tiles = (seq + kFmaBlock - 1) / kFmaBlock;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kFmaBlock;
    __syncthreads();
    stage_rows<kFmaBlock, DP>(ks, base + hd, row_stride, k0, seq, dim, 1.f, tid);
    stage_rows<kFmaBlock, DP>(vs, base + 2 * hd, row_stride, k0, seq, dim, 1.f, tid);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kFmaBlock; ++j) {
      const float s = row_dot<NCH, kLanesPerRow>(q, ks[j], part);
      const float dp = row_dot<NCH, kLanesPerRow>(d_o, vs[j], part);
      const float p = k0 + j < seq ? exp2f(s * kLog2e - lse_q) : 0.f;
      row_axpy<NCH, kLanesPerRow>(dq, p * (dp - delta_q), ks[j], part);
    }
  }
  if (q_valid) {
    store_row<NCH, kLanesPerRow>(dqkv + ((long long)b * seq + row) * row_stride + (long long)h * dim,
                   dq, dim, part, scale);
  }
}

// ---------------------------------------------------------------- launch
template <typename T>
int launch_delta(const void* out, const void* dout, float* delta, int batch, int seq,
                 int heads, int dim, cudaStream_t stream) {
  const long long rows = (long long)batch * seq * heads;
  const int threads = 256;
  const long long blocks = (rows + threads - 1) / threads;
  flash_fused_bwd_delta<T><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), delta, rows, seq, heads,
      dim);
  return static_cast<int>(cudaGetLastError());
}

template <int NK>
int launch_bf16(const void* qkv, const void* dout, const float* lse, const float* delta,
                void* dqkv, int batch, int seq, int heads, int dim, float scale,
                cudaStream_t stream) {
  constexpr int bytes = bf16_smem_bytes<NK>();
  const dim3 grid((seq + kTile - 1) / kTile, heads, batch);
  const auto* q = static_cast<const __nv_bfloat16*>(qkv);
  const auto* d = static_cast<const __nv_bfloat16*>(dout);
  auto* g = static_cast<__nv_bfloat16*>(dqkv);
  cudaError_t err = cudaFuncSetAttribute(flash_fused_bwd_dkdv_bf16<NK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_fused_bwd_dq_bf16<NK>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fused_bwd_dkdv_bf16<NK><<<grid, kMmaThreads, bytes, stream>>>(
      q, d, lse, delta, g, seq, heads, dim, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fused_bwd_dq_bf16<NK><<<grid, kMmaThreads, bytes, stream>>>(
      q, d, lse, delta, g, seq, heads, dim, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int NCH>
int launch_f32(const void* qkv, const void* dout, const float* lse, const float* delta,
               void* dqkv, int batch, int seq, int heads, int dim, float scale,
               cudaStream_t stream) {
  const dim3 grid((seq + kTile - 1) / kTile, heads, batch);
  const auto* q = static_cast<const float*>(qkv);
  const auto* d = static_cast<const float*>(dout);
  auto* g = static_cast<float*>(dqkv);
  flash_fused_bwd_dkdv_f32<NCH><<<grid, kFmaThreads, 0, stream>>>(
      q, d, lse, delta, g, seq, heads, dim, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fused_bwd_dq_f32<NCH><<<grid, kFmaThreads, 0, stream>>>(
      q, d, lse, delta, g, seq, heads, dim, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes. Launches the delta, dK/dV and dQ kernels
// on `stream` and returns the first CUDA error (0 on success). `delta` is
// f32 scratch of B*H*T floats that the caller allocates; is_bf16 selects
// __nv_bfloat16 over float for qkv, out, dout and dqkv.
extern "C" int vaw_flash_fused_bwd(const void* qkv, const void* out, const void* dout,
                                   const void* lse, void* delta, void* dqkv, int batch,
                                   int seq, int heads, int dim, float scale, int is_bf16,
                                   void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || dim <= 0 || dim % 8 != 0 || dim > 128 ||
      batch > 65535 || heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  int err = is_bf16 ? launch_delta<__nv_bfloat16>(out, dout, dl, batch, seq, heads, dim, s)
                    : launch_delta<float>(out, dout, dl, batch, seq, heads, dim, s);
  if (err) return err;
  if (!is_bf16) {
    if (dim <= 32) return launch_f32<2>(qkv, dout, l, dl, dqkv, batch, seq, heads, dim, scale, s);
    if (dim <= 64) return launch_f32<4>(qkv, dout, l, dl, dqkv, batch, seq, heads, dim, scale, s);
    return launch_f32<8>(qkv, dout, l, dl, dqkv, batch, seq, heads, dim, scale, s);
  }
  switch ((dim + 15) / 16) {
    case 1: return launch_bf16<1>(qkv, dout, l, dl, dqkv, batch, seq, heads, dim, scale, s);
    case 2: return launch_bf16<2>(qkv, dout, l, dl, dqkv, batch, seq, heads, dim, scale, s);
    case 3: return launch_bf16<3>(qkv, dout, l, dl, dqkv, batch, seq, heads, dim, scale, s);
    case 4: return launch_bf16<4>(qkv, dout, l, dl, dqkv, batch, seq, heads, dim, scale, s);
    case 5: return launch_bf16<5>(qkv, dout, l, dl, dqkv, batch, seq, heads, dim, scale, s);
    case 6: return launch_bf16<6>(qkv, dout, l, dl, dqkv, batch, seq, heads, dim, scale, s);
    case 7: return launch_bf16<7>(qkv, dout, l, dl, dqkv, batch, seq, heads, dim, scale, s);
    default: return launch_bf16<8>(qkv, dout, l, dl, dqkv, batch, seq, heads, dim, scale, s);
  }
}
