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
// 34.9 GFLOP take 35 us at the bf16 tensor-core peak of 989 TFLOP/s. So it
// is memory-bound at that shape.
//
// Design. The TPU kernel holds the whole (padded) K/V sequence of several
// (batch, head) rows in VMEM and walks 256-key blocks of it. Here one thread
// block takes one (b, h, 64-query tile) and streams 64-key K/V tiles through
// shared memory with an online softmax (running max and sum), so any T
// works; the key tail is zero-filled in shared memory and masked to -inf.
//
// bf16: four warps, 16 query rows each, on the tensor cores with mma.sync
// m16n8k16 and f32 accumulators; products of bf16 values are exact in f32,
// so the scores are the f32 scores, and the scale multiplies them in f32.
// P stays f32 for the softmax and enters P.V split into two bf16 terms
// (hi + lo, about 16 significant bits). The q tile sits in shared memory,
// so the registers hold only the accumulator: for D <= 128 one block owns
// all output columns; for D in (128, 256] the columns are split over two
// blocks that each compute the full scores (they need all of D) and only
// their own half of P.V, keeping the accumulator at <= 64 floats a thread.
// f32: plain FMAs with every operand f32, q * scale formed at load as the
// TPU kernel does. L = 4 neighbouring threads share one query for D <= 128
// (8 for larger D), each holding a 1/L share of q and of the accumulator.
// wgmma, TMA and a cp.async pipeline are later work.

#include "flash_common.cuh"

namespace {

using namespace vaw_flash;
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
