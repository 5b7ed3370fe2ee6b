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
// Design. The TPU kernel holds the whole K/V of a few (batch, head) rows in
// VMEM. Here one thread block takes one (b, h, 64-query tile) and streams
// 64-key tiles of k and v with an online softmax, as flash_fwd.cu does, but
// every tile is staged d-major: shared memory holds [D][64 tokens] rows,
// copied 16 bytes at a time along T, so global loads and shared stores are
// both contiguous and nothing is transposed on the way in.
//
// bf16: four warps, 16 query rows each, mma.sync m16n8k16 with f32
// accumulators. In S = q k^T the d-major q is the transposed A operand and
// the d-major k the row-major B operand, so both are read with ldmatrix
// .trans; in O = P v the d-major v is already the column-major B operand and
// is read as it lies. The head dim is zero-padded to a multiple of 16 in
// shared memory (D = 8, 24, 40, ... take the same path). P stays f32 for the
// softmax and enters P.V split into two bf16 terms (hi + lo). o is staged
// back d-major through shared memory so its stores also run along T.
// f32: plain FMAs with every operand f32, q * scale formed at load as the
// TPU kernel does; L = 4 neighbouring threads share one query, each holding
// a 1/L share of q and of the accumulator; k and v tiles are transposed into
// shared memory one value at a time. wgmma, TMA and a cp.async pipeline are
// later work.

#include "flash_common.cuh"

namespace {

using namespace vaw_flash;
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
