// Backward of the multi-head softmax attention over the d-major packed
// projection: one packed gradient out.
//
// Replaces vaw_tpu/ops/flash_attention.py:_bwd_kernel_p5 (the backward of
// _flash_p5). Same contract:
//   f5    [B, 3, H, D, T] contiguous (bf16 or f32), as the forward read it.
//   out, dout [B*H, D, T] contiguous, d-major, in the input dtype: the
//         forward's output and the incoming gradient.
//   lse   [B*H, T] f32, the forward's natural-log log-sum-exp.
//   dqkv  [B, 3, H, D, T] in the input dtype: dq | dk | dv in the sections
//         of f5, each written once.
// The math, all in f32 (vaw_tpu/ops/flash_attention.py:443-477):
//   q^ = q * scale, S = q^ k^T, P = exp(S - lse), delta = rowsum(dout * out),
//   dV = P^T dout, dS = P * (dout v^T - delta), dK = dS^T q^,
//   dQ = (dS k) * scale.
// delta is formed in f32 from the input-dtype out that the forward wrote.
// f32 accumulators, each gradient cast once to the input dtype at the end.
//
// Bound. At the LDM training shape (B = 256, T = 256, H = 16, D = 32,
// bf16) one call reads 201 MB of f5, 67 MB each of out and dout and 4 MB of
// lse, and writes 201 MB of dqkv: 541 MB, or 161 us at 3.35 TB/s. Its five
// products are 10*B*H*T*T*D = 85.9 GFLOP, 87 us at the bf16 peak. So it is
// memory-bound at that shape.
//
// Design (FlashAttention-2 style, deterministic, no atomics), as
// flash_bwd.cu, on d-major tiles. The TPU kernel walks a few (batch, head)
// rows whole in one grid step and writes each dqkv section once; on the
// card three kernels run in order on one stream:
//   1. delta: one thread per (b*h, t), reading down D (coalesced along T).
//   2. dK/dV: one block per (b, h, 64-key tile, column split). Each of its
//      four warps owns 16 keys; the block loops over 64-query tiles of q and
//      dout, recomputes S^T and P^T, and accumulates dV and dK in registers.
//   3. dQ: one block per (b, h, 64-query tile, column split), looping over
//      64-key tiles of k and v.
// Every tile is staged d-major ([D][64 tokens], 16-byte copies along T).
// k^T and v^T in S^T = k q^T and dP^T = v dout^T are read as transposed A
// operands and q and dout as row-major B operands, all with ldmatrix .trans;
// in dV += P^T dout, dK += dS^T q and dQ += dS k the d-major dout, q and k
// are column-major B operands as they lie. dK, dV and dQ are staged back
// d-major through shared memory and stored 16 bytes at a time along T. A
// block owns at most 64 output columns (its accumulators stay at <= 64
// floats a thread); for D > 64 the columns are split over blocks that each
// recompute the scores. The head dim is zero-padded to a multiple of 16 in
// shared memory. Queries past T get lse = +inf in the dK/dV kernel and keys
// past T get P = 0 in the dQ kernel.
// bf16: mma.sync m16n8k16 with f32 accumulators; the scale multiplies S in
// f32 and P and dS enter their products split into bf16 hi + lo. f32: plain
// FMAs with every operand f32, q^ formed at load as the TPU kernel does;
// L = 4 threads share a row. wgmma, TMA and a cp.async pipeline are later
// work.

#include "flash_common.cuh"

namespace {

using namespace vaw_flash;
using bf16 = __nv_bfloat16;

constexpr int kLdT = kTile + kRowPad;  // a d-major row: 64 tokens and the pad

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// delta[bh * T + t] = sum_d dout[bh, d, t] * out[bh, d, t] in f32.
template <typename T>
__global__ void flash_p5_bwd_delta(const T* __restrict__ out, const T* __restrict__ dout,
                                   float* __restrict__ delta, long long rows, int seq,
                                   int dim) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows) return;
  const long long off = (idx / seq) * dim * seq + idx % seq;
  float s = 0.f;
  for (int d = 0; d < dim; ++d) {
    s = fmaf(to_f32(out[off + (long long)d * seq]), to_f32(dout[off + (long long)d * seq]), s);
  }
  delta[idx] = s;
}

// Pointers of one (b, h): its q, k and v heads in f5 (and dq, dk, dv in
// dqkv, at the same offsets) and its out / dout head.
struct Heads {
  long long q, k, v, o;
};

__device__ __forceinline__ Heads heads_of(int b, int h, int heads, int dim, int seq) {
  const long long head = (long long)dim * seq;
  const long long q = ((long long)(3 * b) * heads + h) * head;
  return Heads{q, q + heads * head, q + 2 * heads * head, ((long long)b * heads + h) * head};
}

// ------------------------------------------------------------------ bf16
template <int NK>
using BwdSplit = Split<NK, 8>;  // at most 64 output columns per block

template <int NK>
constexpr int p5_bwd_smem_bytes() {
  return (2 * 16 * NK + 2 * BwdSplit<NK>::kWidth) * kLdT * 2 + 2 * kTile * 4;
}

// NK: 16-wide steps of the head dim, zero-padded to 16 * NK (<= 128).
template <int NK>
__global__ void __launch_bounds__(kMmaThreads)
flash_p5_bwd_dkdv_bf16(const bf16* __restrict__ f5, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       bf16* __restrict__ dqkv, int heads, int dim, int seq, float scale) {
  using S = BwdSplit<NK>;
  constexpr int NDO = S::NDO;
  constexpr int DP = 16 * NK;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16 (*ks)[kLdT] = reinterpret_cast<bf16 (*)[kLdT]>(smem);  // [DP][64 keys]
  bf16 (*vs)[kLdT] = ks + DP;
  bf16 (*qs)[kLdT] = vs + DP;           // [kWidth][64 queries]
  bf16 (*dos)[kLdT] = qs + S::kWidth;   // dout of the query tile
  float* lse_s = reinterpret_cast<float*>(dos + S::kWidth);
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
  const Heads hp = heads_of(b, h, heads, dim, seq);
  const float* lse_row = lse + ((long long)b * heads + h) * seq;
  const float* delta_row = delta + ((long long)b * heads + h) * seq;
  const int kr = warp * 16;  // this warp's first key row in the tile
  const float scale_log2 = scale * kLog2e;

  stage_dmajor<kLdT>(ks, f5 + hp.k, seq, k0, DP, dim, tid);
  stage_dmajor<kLdT>(vs, f5 + hp.v, seq, k0, DP, dim, tid);

  float dk[NDO][4], dv[NDO][4];
#pragma unroll
  for (int nd = 0; nd < NDO; ++nd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nd][e] = dv[nd][e] = 0.f;
  }

  const int n_tiles = (seq + kTile - 1) / kTile;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int q0 = tile * kTile;
    __syncthreads();  // the previous query tile has been consumed
    stage_dmajor<kLdT>(qs, f5 + hp.q, seq, q0, S::kWidth, dim, tid);
    stage_dmajor<kLdT>(dos, dout + hp.o, seq, q0, S::kWidth, dim, tid);
    for (int i = tid; i < kTile; i += kMmaThreads) {
      const bool valid = q0 + i < seq;
      lse_s[i] = valid ? lse_row[q0 + i] * kLog2e : INFINITY;  // P = 0 past T
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
      load_a_trans<kLdT>(ka, ks, kr, kk, lane);
      load_a_trans<kLdT>(va, vs, kr, kk, lane);
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, &qs[kk * 16 + (lane & 15)][nt * 8]);
        mma_16816(st[nt], ka, b0, b1);
        ldmatrix_x2_trans(b0, b1, &dos[kk * 16 + (lane & 15)][nt * 8]);
        mma_16816(dpt[nt], va, b0, b1);
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
    // dV += P^T dout and dK += dS^T q over this block's columns, 16 queries
    // a step; dout[d][query] and q[d][query] are column-major B operands.
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t phi[4], plo[4], shi[4], slo[4];
      split_a(phi, plo, st, kk);
      split_a(shi, slo, dpt, kk);
#pragma unroll
      for (int nd = 0; nd < NDO; ++nd) {
        const bf16* drow = &dos[c0 + nd * 8 + quad][kk * 16 + 2 * pair];
        mma_16816(dv[nd], phi, ld_u32(drow), ld_u32(drow + 8));
        mma_16816(dv[nd], plo, ld_u32(drow), ld_u32(drow + 8));
        const bf16* qrow = &qs[c0 + nd * 8 + quad][kk * 16 + 2 * pair];
        mma_16816(dk[nd], shi, ld_u32(qrow), ld_u32(qrow + 8));
        mma_16816(dk[nd], slo, ld_u32(qrow), ld_u32(qrow + 8));
      }
    }
  }

  const float dk_mul[2] = {scale, scale};
  const float dv_mul[2] = {1.f, 1.f};
  __syncthreads();  // every warp is done with qs and dos
  stage_acc_dmajor<NDO, kLdT>(qs, dk, kr, quad, pair, dk_mul);
  stage_acc_dmajor<NDO, kLdT>(dos, dv, kr, quad, pair, dv_mul);
  __syncthreads();
  store_dmajor<kLdT>(dqkv + hp.k, qs, seq, k0, c0, 8 * NDO, dim, tid);
  store_dmajor<kLdT>(dqkv + hp.v, dos, seq, k0, c0, 8 * NDO, dim, tid);
}

template <int NK>
__global__ void __launch_bounds__(kMmaThreads)
flash_p5_bwd_dq_bf16(const bf16* __restrict__ f5, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dqkv, int heads, int dim, int seq, float scale) {
  using S = BwdSplit<NK>;
  constexpr int NDO = S::NDO;
  constexpr int DP = 16 * NK;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16 (*qs)[kLdT] = reinterpret_cast<bf16 (*)[kLdT]>(smem);  // [DP][64 queries]
  bf16 (*dos)[kLdT] = qs + DP;          // dout of this block's queries
  bf16 (*ks)[kLdT] = dos + DP;          // [kWidth][64 keys]
  bf16 (*vs)[kLdT] = ks + S::kWidth;

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
  const Heads hp = heads_of(b, h, heads, dim, seq);
  const long long lrow = ((long long)b * heads + h) * seq;
  const int qr = warp * 16;  // this warp's first query row in the tile
  const float scale_log2 = scale * kLog2e;

  stage_dmajor<kLdT>(qs, f5 + hp.q, seq, q0, DP, dim, tid);
  stage_dmajor<kLdT>(dos, dout + hp.o, seq, q0, DP, dim, tid);
  // lse (log2 domain) and delta of this thread's rows qr + quad (+ 8).
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + qr + quad + 8 * r;
    lse_r[r] = row < seq ? lse[lrow + row] * kLog2e : 0.f;
    delta_r[r] = row < seq ? delta[lrow + row] : 0.f;
  }

  float dq[NDO][4];
#pragma unroll
  for (int nd = 0; nd < NDO; ++nd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[nd][e] = 0.f;
  }

  const int n_tiles = (seq + kTile - 1) / kTile;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kTile;
    __syncthreads();  // the previous key tile has been consumed
    stage_dmajor<kLdT>(ks, f5 + hp.k, seq, k0, S::kWidth, dim, tid);
    stage_dmajor<kLdT>(vs, f5 + hp.v, seq, k0, DP, dim, tid);
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
      load_a_trans<kLdT>(qa, qs, qr, kk, lane);
      load_a_trans<kLdT>(da, dos, qr, kk, lane);
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, &ks[kk * 16 + (lane & 15)][nt * 8]);
        mma_16816(s[nt], qa, b0, b1);
        ldmatrix_x2_trans(b0, b1, &vs[kk * 16 + (lane & 15)][nt * 8]);
        mma_16816(dp[nt], da, b0, b1);
      }
    }
    // dS = P (dP - delta), P = exp(S - lse), 0 for keys past T.
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
    // dQ += dS k over this block's columns, 16 keys a step; k[d][key] is the
    // column-major B operand.
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_a(hi, lo, s, kk);
#pragma unroll
      for (int nd = 0; nd < NDO; ++nd) {
        const bf16* krow = &ks[c0 + nd * 8 + quad][kk * 16 + 2 * pair];
        mma_16816(dq[nd], hi, ld_u32(krow), ld_u32(krow + 8));
        mma_16816(dq[nd], lo, ld_u32(krow), ld_u32(krow + 8));
      }
    }
  }

  const float dq_mul[2] = {scale, scale};
  __syncthreads();  // every warp is done with qs
  stage_acc_dmajor<NDO, kLdT>(qs, dq, qr, quad, pair, dq_mul);
  __syncthreads();
  store_dmajor<kLdT>(dqkv + hp.q, qs, seq, q0, c0, 8 * NDO, dim, tid);
}

// ------------------------------------------------------------------- f32
// NCH 4-float chunks a thread, L threads a row, BT rows a streamed tile.
template <int NCH, int L, int BT>
__global__ void __launch_bounds__(kFmaThreads)
flash_p5_bwd_dkdv_f32(const float* __restrict__ f5, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dqkv, int heads, int dim, int seq, float scale) {
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
  const Heads hp = heads_of(b, h, heads, dim, seq);
  const long long lrow = ((long long)b * heads + h) * seq;
  const bool k_valid = key < seq;

  float kr[NCH][4], vr[NCH][4], dk[NCH][4], dv[NCH][4];
  load_row<NCH, L>(kr, f5 + hp.k + key, k_valid, dim, part, 1.f, seq);
  load_row<NCH, L>(vr, f5 + hp.v + key, k_valid, dim, part, 1.f, seq);
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;
  }
  zero_pad<BT, DP>(qs, ds, dim, tid);

  const int n_tiles = (seq + BT - 1) / BT;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int q0 = tile * BT;
    __syncthreads();
    stage_cols<BT, DP>(qs, f5 + hp.q, seq, q0, dim, scale, tid);
    stage_cols<BT, DP>(ds, dout + hp.o, seq, q0, dim, 1.f, tid);
    for (int i = tid; i < BT; i += kFmaThreads) {
      const bool valid = q0 + i < seq;
      lse_s[i] = valid ? lse[lrow + q0 + i] * kLog2e : INFINITY;  // P = 0 past T
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
    store_row<NCH, L>(dqkv + hp.k + key, dk, dim, part, 1.f, seq);
    store_row<NCH, L>(dqkv + hp.v + key, dv, dim, part, 1.f, seq);
  }
}

template <int NCH, int L, int BT>
__global__ void __launch_bounds__(kFmaThreads)
flash_p5_bwd_dq_f32(const float* __restrict__ f5, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dqkv, int heads, int dim, int seq, float scale) {
  constexpr int DP = 4 * L * NCH;
  constexpr int R = kFmaThreads / L;  // queries per block
  __shared__ __align__(16) float ks[BT][DP];
  __shared__ __align__(16) float vs[BT][DP];

  const int tid = threadIdx.x;
  const int part = tid % L;
  const int row = blockIdx.x * R + tid / L;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const Heads hp = heads_of(b, h, heads, dim, seq);
  const long long lrow = ((long long)b * heads + h) * seq;
  const bool q_valid = row < seq;

  float qr[NCH][4], d_o[NCH][4], dq[NCH][4];
  load_row<NCH, L>(qr, f5 + hp.q + row, q_valid, dim, part, scale, seq);
  load_row<NCH, L>(d_o, dout + hp.o + row, q_valid, dim, part, 1.f, seq);
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[i][e] = 0.f;
  }
  const float lse_q = q_valid ? lse[lrow + row] * kLog2e : 0.f;
  const float delta_q = q_valid ? delta[lrow + row] : 0.f;
  zero_pad<BT, DP>(ks, vs, dim, tid);

  const int n_tiles = (seq + BT - 1) / BT;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BT;
    __syncthreads();
    stage_cols<BT, DP>(ks, f5 + hp.k, seq, k0, dim, 1.f, tid);
    stage_cols<BT, DP>(vs, f5 + hp.v, seq, k0, dim, 1.f, tid);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BT; ++j) {
      const float s = row_dot<NCH, L>(qr, ks[j], part);
      const float dp = row_dot<NCH, L>(d_o, vs[j], part);
      const float p = k0 + j < seq ? exp2f(s * kLog2e - lse_q) : 0.f;
      row_axpy<NCH, L>(dq, p * (dp - delta_q), ks[j], part);
    }
  }
  if (q_valid) store_row<NCH, L>(dqkv + hp.q + row, dq, dim, part, scale, seq);
}

// ---------------------------------------------------------------- launch
template <typename T>
struct Args {
  const T* f5;
  const T* dout;
  const float* lse;
  const float* delta;
  T* dqkv;
  int heads, dim, seq;
  float scale;
};

template <typename T>
int launch_delta(const void* out, const Args<T>& a, float* delta, int batch,
                 cudaStream_t stream) {
  const long long rows = (long long)batch * a.heads * a.seq;
  const int threads = 256;
  const long long blocks = (rows + threads - 1) / threads;
  flash_p5_bwd_delta<T><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const T*>(out), a.dout, delta, rows, a.seq, a.dim);
  return static_cast<int>(cudaGetLastError());
}

template <int NK>
int launch_bf16(const Args<bf16>& a, int batch, cudaStream_t stream) {
  constexpr int bytes = p5_bwd_smem_bytes<NK>();
  constexpr int splits = BwdSplit<NK>::kSplits;
  cudaError_t err = cudaFuncSetAttribute(flash_p5_bwd_dkdv_bf16<NK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_p5_bwd_dq_bf16<NK>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(((a.seq + kTile - 1) / kTile) * splits, a.heads, batch);
  flash_p5_bwd_dkdv_bf16<NK><<<grid, kMmaThreads, bytes, stream>>>(
      a.f5, a.dout, a.lse, a.delta, a.dqkv, a.heads, a.dim, a.seq, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_p5_bwd_dq_bf16<NK><<<grid, kMmaThreads, bytes, stream>>>(
      a.f5, a.dout, a.lse, a.delta, a.dqkv, a.heads, a.dim, a.seq, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int NCH, int L, int BT>
int launch_f32(const Args<float>& a, int batch, cudaStream_t stream) {
  constexpr int R = kFmaThreads / L;
  const dim3 grid((a.seq + R - 1) / R, a.heads, batch);
  flash_p5_bwd_dkdv_f32<NCH, L, BT><<<grid, kFmaThreads, 0, stream>>>(
      a.f5, a.dout, a.lse, a.delta, a.dqkv, a.heads, a.dim, a.seq, a.scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_p5_bwd_dq_f32<NCH, L, BT><<<grid, kFmaThreads, 0, stream>>>(
      a.f5, a.dout, a.lse, a.delta, a.dqkv, a.heads, a.dim, a.seq, a.scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes. f5 and dqkv are contiguous [B, 3, H, D, T];
// out and dout contiguous [B*H, D, T]; lse a contiguous [B*H, T] f32, and
// `delta` f32 scratch of B*H*T floats that the caller allocates. Launches
// the delta, dK/dV and dQ kernels on `stream` and returns the first CUDA
// error (0 on success). is_bf16 selects __nv_bfloat16 over float for f5,
// out, dout and dqkv.
extern "C" int vaw_flash_p5_bwd(const void* f5, const void* out, const void* dout,
                                const void* lse, void* delta, void* dqkv, int batch,
                                int heads, int dim, int seq, float scale, int is_bf16,
                                void* stream) {
  if (batch <= 0 || heads <= 0 || seq <= 0 || seq % 8 != 0 || dim <= 0 || dim % 8 != 0 ||
      dim > 128 || batch > 65535 || heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dl = static_cast<float*>(delta);
  if (!is_bf16) {
    const Args<float> a{static_cast<const float*>(f5), static_cast<const float*>(dout),
                        static_cast<const float*>(lse), dl, static_cast<float*>(dqkv),
                        heads, dim, seq, scale};
    const int err = launch_delta<float>(out, a, dl, batch, s);
    if (err) return err;
    if (dim <= 32) return launch_f32<2, 4, 32>(a, batch, s);
    if (dim <= 64) return launch_f32<4, 4, 32>(a, batch, s);
    return launch_f32<8, 4, 32>(a, batch, s);
  }
  const Args<bf16> a{static_cast<const bf16*>(f5), static_cast<const bf16*>(dout),
                     static_cast<const float*>(lse), dl, static_cast<bf16*>(dqkv),
                     heads, dim, seq, scale};
  const int err = launch_delta<bf16>(out, a, dl, batch, s);
  if (err) return err;
#define VAW_CASE(NK) \
  case NK: return launch_bf16<NK>(a, batch, s);
  switch ((dim + 15) / 16) {
    VAW_CASE(1) VAW_CASE(2) VAW_CASE(3) VAW_CASE(4) VAW_CASE(5) VAW_CASE(6) VAW_CASE(7)
    VAW_CASE(8)
  }
#undef VAW_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
