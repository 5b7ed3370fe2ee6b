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
// Design (deterministic, no atomics). The TPU kernel walks a few (batch,
// head) rows whole in one grid step and writes each dqkv section once; on
// the card blocks run in parallel, so the work is split into kernels that
// each own their outputs, run in order on one stream, and recompute S and
// dP where they need them. Three designs, chosen by the call
// (vaw_torch/ops/flash_attention.py:flash_p5_bwd_design):
//
// wgmma (bf16 with D <= 64 and scale > 0: LDM's calls), for Hopper: the
// split of flash_bwd.cu's wgmma pair on the d-major tiles of
// flash_p5_fwd.cu.
// - Loads. q, k and v through one 5-D tensor map over f5 as (T, D, H, 3,
//   B), innermost first, out and dout through 3-D maps over (T, D, B*H),
//   each box [DP][64 tokens] (DP = D rounded up to 16; a row is 128 bytes,
//   swizzled): TMA zero-fills D's pad rows and tokens past T. Persistent
//   blocks of two consumer warpgroups (64 tokens each) and one producer
//   warp that streams the other side's tiles through a ring of up to 8
//   stages on full / empty mbarriers.
// - 1. dQ (runs first): an item is 128 queries of one (b, h); k and v
//   stream through. Each warpgroup first forms its rows' delta in f32 down
//   the DP rows of its d-major out and dout tiles (loaded by TMA with q)
//   and writes it, with lse in the log2 domain, to an f32 scratch padded to
//   128 rows (+inf and 0 past T). Per key tile S = q k^T and dP = dout v^T
//   with both operands read MN-major (imm-trans-a, imm-trans-b, as in
//   flash_p5_fwd.cu), dS = P (dP - delta) with P = exp2(S * scale *
//   log2(e) - lse2) (0 past T), then dQ += dS k with dS from registers
//   (bf16 hi + lo) and k [d][key] as the K-major B operand as it lies (N =
//   DP); tile j's S and dP are issued before tile j-1's dS k.
// - 2. dK/dV: an item is 128 keys of one (b, h); q, dout and their rows'
//   lse2 and delta (by bulk copy from the scratch) stream through. Per
//   query tile S^T = k q^T and dP^T = v dout^T, both MN-major, then dV +=
//   P^T dout and dK += dS^T q with P^T and dS^T from registers and dout and
//   q as K-major B operands. As in flash_bwd.cu, a warpgroup runs a tile's
//   steps in order: with a producer warp ptxas caps a thread at 168
//   registers, and dK and dV alone take DP of them.
// - Stores. dq, dk and dv (dq and dk times the scale) go to shared memory
//   transposed, a [DP][64 tokens] swizzled tile a warpgroup, as
//   flash_p5_fwd.cu stages o, and out by a 3-D TMA store over dqkv viewed
//   as (T, D, B*3*H): section j of head h of batch b is plane (3 b + j) H +
//   h. TMA writes neither D's pad rows nor tokens past T.
//
// mma.sync (other bf16 calls: D > 64, scale <= 0) and f32, FlashAttention-2
// style; three kernels run in order on one stream:
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
// L = 4 threads share a row.

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace vaw_flash;
using namespace vaw_hopper;
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

// ----------------------------------------------------------- bf16, wgmma
constexpr int kWgRows = 64;                   // tokens of a warpgroup, and of a stage
constexpr int kConsumers = 2 * 128;           // two consumer warpgroups
constexpr int kItemRows = 2 * kWgRows;        // queries (dQ) or keys (dK/dV) of an item
constexpr int kWgThreads = kConsumers + 32;   // and one producer warp
constexpr int kSmemBudget = 232448 - 1024 - 512;  // less the alignment and barriers

// Rows of the lse / delta scratch per (b, h): T rounded up to a work item.
__host__ __device__ constexpr long long padded_rows(int seq) {
  return (seq + kItemRows - 1) / kItemRows * (long long)kItemRows;
}

// Every tile below is d-major, [DP][64 tokens], as TMA lands it: row d is
// 128 bytes, its 16-byte chunk c stored at chunk c ^ (d % 8). Each tile is
// a multiple of 2048 bytes, so each starts on the swizzle's period.

// dQ kernel: q, dout and out of two work items (a tile a warpgroup), NS
// stages of K and V, dq staged for its TMA store.
template <int DP, int NS>
struct P5DqSmem {
  bf16 q[2][2][DP][kWgRows];
  bf16 dout[2][2][DP][kWgRows];
  bf16 o[2][2][DP][kWgRows];
  bf16 k[NS][DP][kWgRows];
  bf16 v[NS][DP][kWgRows];
  bf16 dq[2][DP][kWgRows];
  uint64_t q_full[2];
  uint64_t q_empty[2];
  uint64_t full[NS];
  uint64_t empty[NS];
};

// dK/dV kernel: k and v of two work items, NS stages of q, dout and their
// rows' lse (log2 domain) and delta, dk and dv staged for their stores.
template <int DP, int NS>
struct P5DkvSmem {
  bf16 k[2][2][DP][kWgRows];
  bf16 v[2][2][DP][kWgRows];
  bf16 q[NS][DP][kWgRows];
  bf16 dout[NS][DP][kWgRows];
  bf16 dk[2][DP][kWgRows];
  bf16 dv[2][DP][kWgRows];
  float lse2[NS][kWgRows];
  float delta[NS][kWgRows];
  uint64_t kv_full[2];
  uint64_t kv_empty[2];
  uint64_t full[NS];
  uint64_t empty[NS];
};

template <int DP>
constexpr int dq_stages() {
  constexpr int tile = DP * kSwizzleRowBytes;
  constexpr int room = (kSmemBudget - 14 * tile) / (2 * tile);
  return room > 8 ? 8 : room;
}

template <int DP>
constexpr int dkv_stages() {
  constexpr int tile = DP * kSwizzleRowBytes;
  constexpr int room = (kSmemBudget - 12 * tile) / (2 * tile + 2 * kWgRows * 4);
  return room > 8 ? 8 : room;
}

// Byte offset of element (d, t) in a d-major tile.
__device__ __forceinline__ uint32_t dmajor_offset(int d, int t) {
  return d * kSwizzleRowBytes + 16 * ((t / 8) ^ (d % 8)) + 2 * (t % 8);
}

// acc (a warpgroup's 64 tokens x DP accumulator, times `mul`) in bf16 to a
// d-major tile, transposed, as the store's tensor map reads it.
template <int DP>
__device__ __forceinline__ void stage_acc_dmajor_tile(bf16 (*tile)[kWgRows],
                                                      const float (&acc)[DP / 2], int warp,
                                                      int quad, int pair, float mul) {
  uint8_t* base = reinterpret_cast<uint8_t*>(&tile[0][0]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = 16 * warp + quad + 8 * r;
#pragma unroll
    for (int c = 0; c < DP / 8; ++c) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        *reinterpret_cast<bf16*>(base + dmajor_offset(8 * c + 2 * pair + e, t)) =
            __float2bfloat16_rn(acc[4 * c + 2 * r + e] * mul);
      }
    }
  }
}

// The dQ kernel, which runs first. A work item is 128 queries of one
// (b, h), 64 a consumer warpgroup; the keys stream through in 64-key
// stages. Each warpgroup first forms its rows' delta = rowsum(dout * out)
// in f32 down the DP rows of its d-major out and dout tiles, and writes
// it, with lse in the log2 domain, to the scratch the dK/dV kernel reads
// (+inf and 0 past T, so P = dS = 0 there). Per key tile: S = q k^T and
// dP = dout v^T (all four operands MN-major from shared memory), dS = P
// (dP - delta) with P = exp2(S * scale * log2(e) - lse2) (0 past T), then
// dQ += dS k with dS from registers (bf16 hi + lo) and k [d][key] as the
// K-major B operand; tile j's S and dP are issued before tile j-1's dS k.
// dQ is scaled once at the end.
template <int DP, int NS>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_p5_bwd_dq_wgmma(const __grid_constant__ CUtensorMap f5_map,
                      const __grid_constant__ CUtensorMap out_map,
                      const __grid_constant__ CUtensorMap dout_map,
                      const __grid_constant__ CUtensorMap grad_map,
                      const float* __restrict__ lse, float* __restrict__ lse2_out,
                      float* __restrict__ delta_out, int batch, int heads, int seq,
                      float scale) {
  constexpr uint32_t kTileBytes = DP * kSwizzleRowBytes;
  using Smem = P5DqSmem<DP, NS>;
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  const int tid = threadIdx.x;
  const int n_tiles = (seq + kWgRows - 1) / kWgRows;
  const int q_tiles = (seq + kItemRows - 1) / kItemRows;
  const int items = batch * heads * q_tiles;
  const long long t_pad = padded_rows(seq);

  if (tid == 0) init_barriers(sm.q_full, sm.q_empty, sm.full, sm.empty, NS, kConsumers);
  __syncthreads();

  if (tid >= kConsumers) {
    if (tid == kConsumers) {
      prefetch_tensor_map(&f5_map);
      prefetch_tensor_map(&out_map);
      prefetch_tensor_map(&dout_map);
      int it = 0;
      int n = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
        const int q0 = (item % q_tiles) * kItemRows;
        const int bh = item / q_tiles;
        const int h = bh % heads;
        const int b = bh / heads;
        const int qb = n & 1;
        if (n >= 2) mbar_wait(&sm.q_empty[qb], (n / 2 - 1) & 1);
        mbar_arrive_expect_tx(&sm.q_full[qb], 6 * kTileBytes);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t0 = q0 + kWgRows * half;
          tma_load_5d(&sm.q[qb][half][0][0], &f5_map, &sm.q_full[qb], t0, 0, h, 0, b);
          tma_load_3d(&sm.dout[qb][half][0][0], &dout_map, &sm.q_full[qb], t0, 0, bh);
          tma_load_3d(&sm.o[qb][half][0][0], &out_map, &sm.q_full[qb], t0, 0, bh);
        }
        for (int j = 0; j < n_tiles; ++j, ++it) {
          const int stage = it % NS;
          if (it >= NS) mbar_wait(&sm.empty[stage], (it / NS - 1) & 1);
          mbar_arrive_expect_tx(&sm.full[stage], 2 * kTileBytes);
          tma_load_5d(&sm.k[stage][0][0], &f5_map, &sm.full[stage], j * kWgRows, 0, h, 1, b);
          tma_load_5d(&sm.v[stage][0][0], &f5_map, &sm.full[stage], j * kWgRows, 0, h, 2, b);
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
  float s[32], dp[32];           // S and dP of one key tile: 64 queries x 64 keys
  uint32_t hi[4][4], lo[4][4];   // dS of the previous tile, bf16 hi + lo

  // S = q k^T and dP = dout v^T for the tile in `stage`: 16 rows of d a
  // step, 2048 bytes into each d-major tile.
  auto issue_s_dp = [&](int qb, int stage) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint64_t da = desc_mn_major(&sm.q[qb][wg][16 * kk][0], kTileBytes);
      const uint64_t db = desc_mn_major(&sm.k[stage][16 * kk][0], kTileBytes);
      Wgmma<64>::ss<1, 1>(s, da, db, kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint64_t da = desc_mn_major(&sm.dout[qb][wg][16 * kk][0], kTileBytes);
      const uint64_t db = desc_mn_major(&sm.v[stage][16 * kk][0], kTileBytes);
      Wgmma<64>::ss<1, 1>(dp, da, db, kk > 0);
    }
  };
  // dQ += dS k for the tile in `stage`: k [d][key] is the K-major B operand,
  // 16 keys (32 bytes along the row) a step.
  auto issue_dq = [&](int stage) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db =
          desc_k_major(reinterpret_cast<const uint8_t*>(&sm.k[stage][0][0]) + 32 * kk);
      Wgmma<DP>::template rs<0>(dq, hi[kk], db, 1);
      Wgmma<DP>::template rs<0>(dq, lo[kk], db, 1);
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
      load_if(lse_next[r], lse + bh * seq + row, row < seq);
    }
  };
  load_lse(blockIdx.x);

  int it = 0;
  int n = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    const int q0 = (item % q_tiles) * kItemRows;
    const int bh = item / q_tiles;
    const int h = bh % heads;
    const int b = bh / heads;
    const int qb = n & 1;

    // lse (log2 domain) of this thread's rows, and their delta down the DP
    // rows of out and dout (zero-filled past T and D): the four threads of
    // a row each take every fourth row of d.
    float lse2[2], delta[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + kWgRows * wg + 16 * warp + quad + 8 * r;
      lse2[r] = row < seq ? lse_next[r] * kLog2e : INFINITY;
    }
    load_lse(item + gridDim.x);
    mbar_wait(&sm.q_full[qb], (n / 2) & 1);
    const uint8_t* o_tile = reinterpret_cast<const uint8_t*>(&sm.o[qb][wg][0][0]);
    const uint8_t* do_tile = reinterpret_cast<const uint8_t*>(&sm.dout[qb][wg][0][0]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = 16 * warp + quad + 8 * r;
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < DP / 4; ++i) {
        const uint32_t off = dmajor_offset(4 * i + pair, t);
        d = fmaf(__bfloat162float(*reinterpret_cast<const bf16*>(o_tile + off)),
                 __bfloat162float(*reinterpret_cast<const bf16*>(do_tile + off)), d);
      }
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      delta[r] = d;
      if (pair == 0) {
        lse2_out[bh * t_pad + q0 + kWgRows * wg + t] = lse2[r];
        delta_out[bh * t_pad + q0 + kWgRows * wg + t] = d;
      }
    }
    if (q0 + kWgRows * wg >= seq) {
      // No query of this warpgroup lies inside T.
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
      const bool ragged = k0 + kWgRows > seq;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        float p = exp2_approx(fmaf(s[i], scale_log2, -lse2[r]));
        if (ragged && k0 + 8 * (i / 4) + 2 * pair + (i & 1) >= seq) p = 0.f;
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

    // dq * scale in bf16 to shared memory, transposed, and out by a TMA
    // store into section 0 of dqkv; tokens past T and rows past D are not
    // written.
    if (wg_leader) bulk_wait<true>();
    named_barrier(1 + wg, 128);
    stage_acc_dmajor_tile<DP>(sm.dq[wg], dq, warp, quad, pair, scale);
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    if (wg_leader) {
      tma_store_3d(&grad_map, &sm.dq[wg][0][0], q0 + kWgRows * wg, 0, 3 * b * heads + h);
      bulk_commit();
    }
  }
  if (wg_leader) bulk_wait<false>();
}

// The dK/dV kernel, after the dQ kernel. A work item is 128 keys of one
// (b, h), 64 a consumer warpgroup; 64-query stages of q, dout and their
// rows' lse2 and delta (from the dQ kernel's scratch) stream through. Per
// query tile: S^T = k q^T and dP^T = v dout^T (all four operands MN-major
// from shared memory), P^T = exp2(S^T * scale * log2(e) - lse2) and dS^T =
// P^T (dP^T - delta), then dV += P^T dout and dK += dS^T q with P^T and
// dS^T from registers (bf16 hi + lo) and dout and q [d][query] as K-major
// B operands. dK is scaled once at the end. Keys past T compute values that
// are never stored. A warpgroup runs a tile's steps in order, issuing the
// dV products before it splits dS^T, for flash_bwd.cu's register reason.
template <int DP, int NS>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_p5_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap f5_map,
                        const __grid_constant__ CUtensorMap dout_map,
                        const __grid_constant__ CUtensorMap grad_map,
                        const float* __restrict__ lse2_in, const float* __restrict__ delta_in,
                        int batch, int heads, int seq, float scale) {
  constexpr uint32_t kTileBytes = DP * kSwizzleRowBytes;
  constexpr uint32_t kRowBytes = kWgRows * 4;  // lse2 or delta of a stage
  using Smem = P5DkvSmem<DP, NS>;
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  const int tid = threadIdx.x;
  const int n_tiles = (seq + kWgRows - 1) / kWgRows;
  const int k_tiles = (seq + kItemRows - 1) / kItemRows;
  const int items = batch * heads * k_tiles;
  const long long t_pad = padded_rows(seq);

  if (tid == 0) init_barriers(sm.kv_full, sm.kv_empty, sm.full, sm.empty, NS, kConsumers);
  __syncthreads();

  if (tid >= kConsumers) {
    if (tid == kConsumers) {
      prefetch_tensor_map(&f5_map);
      prefetch_tensor_map(&dout_map);
      int it = 0;
      int n = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
        const int k0 = (item % k_tiles) * kItemRows;
        const int bh = item / k_tiles;
        const int h = bh % heads;
        const int b = bh / heads;
        const int kb = n & 1;
        if (n >= 2) mbar_wait(&sm.kv_empty[kb], (n / 2 - 1) & 1);
        mbar_arrive_expect_tx(&sm.kv_full[kb], 4 * kTileBytes);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t0 = k0 + kWgRows * half;
          tma_load_5d(&sm.k[kb][half][0][0], &f5_map, &sm.kv_full[kb], t0, 0, h, 1, b);
          tma_load_5d(&sm.v[kb][half][0][0], &f5_map, &sm.kv_full[kb], t0, 0, h, 2, b);
        }
        for (int j = 0; j < n_tiles; ++j, ++it) {
          const int stage = it % NS;
          if (it >= NS) mbar_wait(&sm.empty[stage], (it / NS - 1) & 1);
          mbar_arrive_expect_tx(&sm.full[stage], 2 * kTileBytes + 2 * kRowBytes);
          tma_load_5d(&sm.q[stage][0][0], &f5_map, &sm.full[stage], j * kWgRows, 0, h, 0, b);
          tma_load_3d(&sm.dout[stage][0][0], &dout_map, &sm.full[stage], j * kWgRows, 0, bh);
          bulk_load(&sm.lse2[stage][0], lse2_in + bh * t_pad + j * kWgRows, kRowBytes,
                    &sm.full[stage]);
          bulk_load(&sm.delta[stage][0], delta_in + bh * t_pad + j * kWgRows, kRowBytes,
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
  uint32_t hi[4][4], lo[4][4];   // P^T in bf16 hi + lo

  int it = 0;
  int n = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    const int k0 = (item % k_tiles) * kItemRows;
    const int bh = item / k_tiles;
    const int h = bh % heads;
    const int b = bh / heads;
    const int kb = n & 1;
    mbar_wait(&sm.kv_full[kb], (n / 2) & 1);
    if (k0 + kWgRows * wg >= seq) {
      // No key of this warpgroup lies inside T.
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
        const uint64_t da = desc_mn_major(&sm.k[kb][wg][16 * kk][0], kTileBytes);
        const uint64_t db = desc_mn_major(&sm.q[stage][16 * kk][0], kTileBytes);
        Wgmma<64>::ss<1, 1>(st, da, db, kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint64_t da = desc_mn_major(&sm.v[kb][wg][16 * kk][0], kTileBytes);
        const uint64_t db = desc_mn_major(&sm.dout[stage][16 * kk][0], kTileBytes);
        Wgmma<64>::ss<1, 1>(dpt, da, db, kk > 0);
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
      // dout and q [d][query] are K-major B operands, 16 queries (32 bytes
      // along the row) a step.
      split_p(st, hi, lo);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db =
            desc_k_major(reinterpret_cast<const uint8_t*>(&sm.dout[stage][0][0]) + 32 * kk);
        Wgmma<DP>::template rs<0>(dv, hi[kk], db, 1);
        Wgmma<DP>::template rs<0>(dv, lo[kk], db, 1);
      }
      wgmma_commit();
      uint32_t shi[4][4], slo[4][4];
      split_p(dpt, shi, slo);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db =
            desc_k_major(reinterpret_cast<const uint8_t*>(&sm.q[stage][0][0]) + 32 * kk);
        Wgmma<DP>::template rs<0>(dk, shi[kk], db, 1);
        Wgmma<DP>::template rs<0>(dk, slo[kk], db, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
      fence_p(hi, lo);
      fence_p(shi, slo);
      mbar_arrive(&sm.empty[stage]);
    }

    // dk * scale and dv in bf16 to shared memory, transposed, and out by
    // TMA stores into sections 1 and 2 of dqkv.
    if (wg_leader) bulk_wait<true>();
    named_barrier(1 + wg, 128);
    stage_acc_dmajor_tile<DP>(sm.dk[wg], dk, warp, quad, pair, scale);
    stage_acc_dmajor_tile<DP>(sm.dv[wg], dv, warp, quad, pair, 1.f);
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    if (wg_leader) {
      const int plane = (3 * b + 1) * heads + h;
      tma_store_3d(&grad_map, &sm.dk[wg][0][0], k0 + kWgRows * wg, 0, plane);
      tma_store_3d(&grad_map, &sm.dv[wg][0][0], k0 + kWgRows * wg, 0, plane + heads);
      bulk_commit();
    }
  }
  if (wg_leader) bulk_wait<false>();
}

template <int DP>
int launch_wgmma(const void* f5, const void* out, const void* dout, const float* lse,
                 float* scratch, void* dqkv, int batch, int heads, int dim, int seq,
                 float scale, cudaStream_t stream) {
  constexpr int NQ = dq_stages<DP>();
  constexpr int NK = dkv_stages<DP>();
  // f5 as (T, D, H, 3, B); out, dout as (T, D, B*H) and dqkv as
  // (T, D, B*3*H), innermost first, strides in bytes, boxes [DP][64].
  const uint64_t head = 2ull * dim * seq;
  const uint64_t dims[5] = {static_cast<uint64_t>(seq), static_cast<uint64_t>(dim),
                            static_cast<uint64_t>(heads), 3, static_cast<uint64_t>(batch)};
  const uint64_t strides[4] = {2ull * seq, head, head * heads, 3 * head * heads};
  const uint32_t box[5] = {kWgRows, DP, 1, 1, 1};
  const uint64_t odims[3] = {dims[0], dims[1], static_cast<uint64_t>(batch) * heads};
  const uint64_t gdims[3] = {dims[0], dims[1], 3ull * batch * heads};
  const uint64_t ostrides[2] = {2ull * seq, head};
  const uint32_t obox[3] = {kWgRows, DP, 1};
  CUtensorMap f5_map, out_map, dout_map, grad_map;
  if (!make_tensor_map(&f5_map, f5, 5, dims, strides, box) ||
      !make_tensor_map(&out_map, out, 3, odims, ostrides, obox) ||
      !make_tensor_map(&dout_map, dout, 3, odims, ostrides, obox) ||
      !make_tensor_map(&grad_map, dqkv, 3, gdims, ostrides, obox)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const long long items = (long long)batch * heads * ((seq + kItemRows - 1) / kItemRows);
  if (items >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = items < sms ? static_cast<int>(items) : sms;
  float* lse2 = scratch;
  float* delta = scratch + (long long)batch * heads * padded_rows(seq);

  auto dq_kernel = flash_p5_bwd_dq_wgmma<DP, NQ>;
  const int dq_smem = static_cast<int>(sizeof(P5DqSmem<DP, NQ>)) + 1024;
  static const cudaError_t dq_attr = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem);
  if (dq_attr != cudaSuccess) return static_cast<int>(dq_attr);
  dq_kernel<<<grid, kWgThreads, dq_smem, stream>>>(f5_map, out_map, dout_map, grad_map, lse,
                                                   lse2, delta, batch, heads, seq, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  auto dkv_kernel = flash_p5_bwd_dkdv_wgmma<DP, NK>;
  const int dkv_smem = static_cast<int>(sizeof(P5DkvSmem<DP, NK>)) + 1024;
  static const cudaError_t dkv_attr = cudaFuncSetAttribute(
      dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_smem);
  if (dkv_attr != cudaSuccess) return static_cast<int>(dkv_attr);
  dkv_kernel<<<grid, kWgThreads, dkv_smem, stream>>>(f5_map, dout_map, grad_map, lse2, delta,
                                                     batch, heads, seq, scale);
  return static_cast<int>(cudaGetLastError());
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

// The f32 scratch of vaw_flash_p5_bwd_wgmma, in floats: lse in the log2
// domain and delta for B*H rows of T rounded up to a 128-query work item,
// from the dQ kernel to the dK/dV kernel.
extern "C" long long vaw_flash_p5_bwd_wgmma_scratch_floats(int batch, int heads, int seq) {
  return 2LL * batch * heads * padded_rows(seq);
}

// Plain C entry point of the wgmma kernels, bf16 only: the contract of
// vaw_flash_p5_bwd (f5 and dqkv [B, 3, H, D, T], out and dout [B*H, D, T],
// lse [B*H, T] f32) for D <= 64 and scale > 0, with `scratch` f32 scratch
// of `scratch_floats` >= vaw_flash_p5_bwd_wgmma_scratch_floats() floats
// (checked) in place of `delta`. Launches the dQ kernel (which also forms
// delta) and then the dK/dV kernel on `stream`; returns the first CUDA
// error (0 on success), or cudaErrorInvalidValue for a call the kernels do
// not take or a tensor map cuTensorMapEncodeTiled refuses.
extern "C" int vaw_flash_p5_bwd_wgmma(const void* f5, const void* out, const void* dout,
                                      const void* lse, void* scratch,
                                      long long scratch_floats, void* dqkv, int batch,
                                      int heads, int dim, int seq, float scale,
                                      void* stream) {
  if (batch <= 0 || heads <= 0 || seq <= 0 || seq % 8 != 0 || dim <= 0 || dim % 8 != 0 ||
      dim > 64 || !(scale > 0.f) || 3LL * batch * heads >= (1LL << 31) ||
      scratch_floats < vaw_flash_p5_bwd_wgmma_scratch_floats(batch, heads, seq)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* sc = static_cast<float*>(scratch);
#define VAW_CASE(NK)                                                                     \
  case NK:                                                                               \
    return launch_wgmma<16 * NK>(f5, out, dout, l, sc, dqkv, batch, heads, dim, seq, scale, \
                                 s);
  switch ((dim + 15) / 16) {
    VAW_CASE(1) VAW_CASE(2) VAW_CASE(3) VAW_CASE(4)
  }
#undef VAW_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
