// Fused multi-head softmax attention, forward only, read straight from the
// raw fused QKV projection.
//
// Replaces vaw_tpu/ops/flash_attention.py:_fwd_kernel_p6 (the forward of
// _flash_p6). Same contract:
//   qkv2d [B, T, 3*H*D] (bf16 or f32), last axis laid out (3, H, D): q, k
//     and v of head h sit at column offsets h*D, H*D + h*D and 2*H*D + h*D
//     of each row, row stride 3*H*D. They are read in place, never copied.
//   o   [B, T, H*D] in the input dtype, t-major, so the out-projection takes
//       it as it is.
//   lse [B*H, T] f32, the natural-log log-sum-exp of the scaled scores,
//       kept for the backward.
//   Scores, softmax and the P.V sums are f32.
//
// Bound. At the DiT-B/2 sampling shape (B = 128 with CFG, T = 256, H = 12,
// D = 64, bf16) one call moves 151 MB of qkv + 50 MB of o + 1.6 MB of lse,
// about 203 MB, or 61 us at 3.35 TB/s; it does 4*B*H*T*T*D = 25.8 GFLOP,
// 26 us at the bf16 tensor-core peak of 989 TFLOP/s. So it is memory-bound
// at that shape (bound about 61 us per call, about 485 us at B = 1024).
//
// Design. The TPU kernel holds all 256 keys of up to 48 (batch, head) rows
// in VMEM at once, and its T == 256 gate is a VMEM limit. Here one thread
// block takes one (b, h, 64-query tile) and streams K/V tiles of 64 keys
// through shared memory with an online softmax (running max and sum, as in
// vaw_tpu/ops/flash_attention.py:_fwd_kernel). So any T works; the ragged
// key tail is zero-filled in shared memory and masked to -inf. Each block
// reads its q rows once and K/V once per query tile (T/64 times per head,
// mostly from L2), so device-memory traffic stays near the bound.
//
// bf16 (the sampling path): four warps, 16 query rows each, on the tensor
// cores with mma.sync m16n8k16 and f32 accumulators. q.k products of bf16
// values are exact in f32, so the scores are the f32 scores; the scale
// multiplies them in f32 (for D = 64 it is 1/8, and this equals scaling q
// first). P stays f32 for the softmax; for P.V it is split into two bf16
// terms, P = hi + lo with hi = bf16(P) and lo = bf16(P - hi), so P enters
// the f32 sums with about 16 significant bits instead of 8. wgmma, TMA and
// a cp.async pipeline are later work.
//
// f32: the same tiling on plain f32 FMAs, which keeps every operand f32.
// Four neighbouring threads share one query; each holds a quarter of q and
// of the accumulator (interleaved 4-float chunks, so the four read
// neighbouring shared-memory words), and two warp shuffles complete each
// score.

#include "flash_common.cuh"

namespace {

using namespace vaw_flash;

constexpr int kBlockQ = 64;  // queries per block (both paths)

// ------------------------------------------------------------------ bf16
constexpr int kMmaBlockK = 64;            // keys per shared-memory tile

// NK: 16-wide steps of the head dim, which is zero-padded to DP = 16 * NK.
template <int NK>
__global__ void __launch_bounds__(kMmaThreads)
flash_fused_fwd_bf16(const __nv_bfloat16* __restrict__ qkv,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                     int seq, int heads, int dim, float scale) {
  constexpr int DP = 16 * NK;
  constexpr int ND = 2 * NK;  // 8-wide output column tiles
  constexpr int LD = DP + kRowPad;
  __shared__ __align__(16) __nv_bfloat16 ks[kMmaBlockK][LD];
  __shared__ __align__(16) __nv_bfloat16 vs[kMmaBlockK][LD];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int quad = lane / 4;   // row within an 8-row half of the warp's tile
  const int pair = lane % 4;   // column pair within an 8-column tile
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hd = heads * dim;
  const long long row_stride = 3LL * hd;
  const __nv_bfloat16* base =
      qkv + (long long)b * seq * row_stride + (long long)h * dim;
  const int r0 = blockIdx.x * kBlockQ + warp * 16 + quad;  // and r0 + 8

  // q as A fragments (row-major 16 x 16 per k-step), straight from memory.
  uint32_t qa[NK][4];
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int row = r0 + (f & 1) * 8;
      const int col = kk * 16 + (f >> 1) * 8 + 2 * pair;
      qa[kk][f] = (row < seq && col < dim)
                      ? *reinterpret_cast<const uint32_t*>(
                            base + (long long)row * row_stride + col)
                      : 0u;
    }
  }
  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;
  }
  // Per row (r0, r0 + 8): running max in the log2 domain, partial sum.
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  const float scale_log2 = scale * kLog2e;

  const int vec_per_row = DP / 8;
  const int n_tiles = (seq + kMmaBlockK - 1) / kMmaBlockK;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kMmaBlockK;
    __syncthreads();  // the previous tile has been consumed
    for (int idx = tid; idx < kMmaBlockK * vec_per_row; idx += kMmaThreads) {
      const int j = idx / vec_per_row;
      const int c8 = (idx - j * vec_per_row) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + j < seq && c8 < dim) {
        const __nv_bfloat16* r = base + (long long)(k0 + j) * row_stride + c8;
        kv = *reinterpret_cast<const uint4*>(r + hd);
        vv = *reinterpret_cast<const uint4*>(r + 2 * hd);
      }
      *reinterpret_cast<uint4*>(&ks[j][c8]) = kv;
      *reinterpret_cast<uint4*>(&vs[j][c8]) = vv;
    }
    __syncthreads();

    // S = q k^T for this warp's 16 rows x 64 keys.
    float s[kMmaBlockK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kMmaBlockK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        const __nv_bfloat16* krow = &ks[nt * 8 + quad][kk * 16 + 2 * pair];
        mma_16816(s[nt], qa[kk], *reinterpret_cast<const uint32_t*>(krow),
                  *reinterpret_cast<const uint32_t*>(krow + 8));
      }
    }
    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kMmaBlockK / 8; ++nt) {
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
    for (int nd = 0; nd < ND; ++nd) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nd][e] *= alpha[e >> 1];
    }
#pragma unroll
    for (int nt = 0; nt < kMmaBlockK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(s[nt][e] - m[e >> 1]);  // 0 for masked keys
        l[e >> 1] += s[nt][e];
      }
    }

    // acc += P v, P split into bf16 hi + lo, 16 keys per step.
#pragma unroll
    for (int kk = 0; kk < kMmaBlockK / 16; ++kk) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const float* p = &s[2 * kk + (f >> 1)][(f & 1) * 2];
        const __nv_bfloat162 ph = __floats2bfloat162_rn(p[0], p[1]);
        hi[f] = as_u32(ph);
        lo[f] = as_u32(__floats2bfloat162_rn(p[0] - __low2float(ph),
                                             p[1] - __high2float(ph)));
      }
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
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
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= seq) continue;
    __nv_bfloat16* o = out + ((long long)b * seq + row) * hd + (long long)h * dim;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const int col = nd * 8 + 2 * pair;
      if (col < dim) {
        *reinterpret_cast<__nv_bfloat162*>(o + col) = __floats2bfloat162_rn(
            acc[nd][2 * r] / l[r], acc[nd][2 * r + 1] / l[r]);
      }
    }
    if (pair == 0) {
      lse[((long long)b * heads + h) * seq + row] = (m[r] + log2f(l[r])) * kLn2;
    }
  }
}

// ------------------------------------------------------------------- f32
constexpr int kLanesPerQuery = kFmaThreads / kBlockQ;  // 4
constexpr int kFmaBlockK = 32;

// NCH: 4-float chunks of the head dim per thread; the head dim is padded
// with zeros to DP = 16 * NCH (4 threads x NCH chunks x 4 floats).
template <int NCH>
__global__ void __launch_bounds__(kFmaThreads)
flash_fused_fwd_f32(const float* __restrict__ qkv, float* __restrict__ out,
                    float* __restrict__ lse, int seq, int heads, int dim,
                    float scale) {
  constexpr int DP = 16 * NCH;
  __shared__ __align__(16) float ks[kFmaBlockK][DP];
  __shared__ __align__(16) float vs[kFmaBlockK][DP];

  const int tid = threadIdx.x;
  const int part = tid & (kLanesPerQuery - 1);
  const int qrow = blockIdx.x * kBlockQ + tid / kLanesPerQuery;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hd = heads * dim;
  const long long row_stride = 3LL * hd;
  const float* base = qkv + (long long)b * seq * row_stride + (long long)h * dim;
  const bool q_valid = qrow < seq;

  // Thread `part` owns dims 4 * (part + 4 * i) + e of q and of acc.
  float q[NCH][4];
  float acc[NCH][4];
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * (part + kLanesPerQuery * i) + e;
      q[i][e] = (q_valid && d < dim)
                    ? base[(long long)qrow * row_stride + d] * scale
                    : 0.f;
      acc[i][e] = 0.f;
    }
  }
  float m = -INFINITY;
  float l = 0.f;

  // Padded dims [dim, DP) stay zero for the whole kernel.
  if (dim < DP) {
    for (int idx = tid; idx < kFmaBlockK * DP; idx += kFmaThreads) {
      const int d = idx % DP;
      if (d >= dim) {
        ks[idx / DP][d] = 0.f;
        vs[idx / DP][d] = 0.f;
      }
    }
  }

  const int vec_per_row = dim / 4;
  const int n_tiles = (seq + kFmaBlockK - 1) / kFmaBlockK;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kFmaBlockK;
    __syncthreads();  // the previous tile has been consumed
    for (int idx = tid; idx < kFmaBlockK * vec_per_row; idx += kFmaThreads) {
      const int j = idx / vec_per_row;
      const int d0 = (idx - j * vec_per_row) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + j < seq) {
        const float* r = base + (long long)(k0 + j) * row_stride + d0;
        kv = *reinterpret_cast<const float4*>(r + hd);
        vv = *reinterpret_cast<const float4*>(r + 2 * hd);
      }
      *reinterpret_cast<float4*>(&ks[j][d0]) = kv;
      *reinterpret_cast<float4*>(&vs[j][d0]) = vv;
    }
    __syncthreads();

    float s[kFmaBlockK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kFmaBlockK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < NCH; ++i) {
        const float4 k4 = *reinterpret_cast<const float4*>(
            &ks[j][4 * (part + kLanesPerQuery * i)]);
        dot = fmaf(q[i][0], k4.x, dot);
        dot = fmaf(q[i][1], k4.y, dot);
        dot = fmaf(q[i][2], k4.z, dot);
        dot = fmaf(q[i][3], k4.w, dot);
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      s[j] = (k0 + j < seq) ? dot * kLog2e : -INFINITY;
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
    for (int j = 0; j < kFmaBlockK; ++j) {
      const float p = exp2f(s[j] - m_new);  // 0 for masked keys
      l += p;
#pragma unroll
      for (int i = 0; i < NCH; ++i) {
        const float4 v4 = *reinterpret_cast<const float4*>(
            &vs[j][4 * (part + kLanesPerQuery * i)]);
        acc[i][0] = fmaf(p, v4.x, acc[i][0]);
        acc[i][1] = fmaf(p, v4.y, acc[i][1]);
        acc[i][2] = fmaf(p, v4.z, acc[i][2]);
        acc[i][3] = fmaf(p, v4.w, acc[i][3]);
      }
    }
    m = m_new;
  }

  if (q_valid) {
    float* o = out + ((long long)b * seq + qrow) * hd + (long long)h * dim;
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * (part + kLanesPerQuery * i) + e;
        if (d < dim) o[d] = acc[i][e] / l;
      }
    }
    if (part == 0) {
      lse[((long long)b * heads + h) * seq + qrow] = (m + log2f(l)) * kLn2;
    }
  }
}

template <int NK>
int launch_bf16(const void* qkv, void* out, float* lse, int batch, int seq,
                int heads, int dim, float scale, cudaStream_t stream) {
  const dim3 grid((seq + kBlockQ - 1) / kBlockQ, heads, batch);
  flash_fused_fwd_bf16<NK><<<grid, kMmaThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out),
      lse, seq, heads, dim, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int NCH>
int launch_f32(const void* qkv, void* out, float* lse, int batch, int seq,
               int heads, int dim, float scale, cudaStream_t stream) {
  const dim3 grid((seq + kBlockQ - 1) / kBlockQ, heads, batch);
  flash_fused_fwd_f32<NCH><<<grid, kFmaThreads, 0, stream>>>(
      static_cast<const float*>(qkv), static_cast<float*>(out), lse, seq, heads,
      dim, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream` and returns
// cudaGetLastError() after the launch (0 on success). is_bf16 selects
// __nv_bfloat16 over float for qkv and o.
extern "C" int vaw_flash_fused_fwd(const void* qkv, void* out, void* lse,
                                   int batch, int seq, int heads, int dim,
                                   float scale, int is_bf16, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || dim <= 0 || dim % 8 != 0 ||
      dim > 128 || batch > 65535 || heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (!is_bf16) {
    if (dim <= 32) return launch_f32<2>(qkv, out, l, batch, seq, heads, dim, scale, s);
    if (dim <= 64) return launch_f32<4>(qkv, out, l, batch, seq, heads, dim, scale, s);
    return launch_f32<8>(qkv, out, l, batch, seq, heads, dim, scale, s);
  }
  switch ((dim + 15) / 16) {
    case 1: return launch_bf16<1>(qkv, out, l, batch, seq, heads, dim, scale, s);
    case 2: return launch_bf16<2>(qkv, out, l, batch, seq, heads, dim, scale, s);
    case 3: return launch_bf16<3>(qkv, out, l, batch, seq, heads, dim, scale, s);
    case 4: return launch_bf16<4>(qkv, out, l, batch, seq, heads, dim, scale, s);
    case 5: return launch_bf16<5>(qkv, out, l, batch, seq, heads, dim, scale, s);
    case 6: return launch_bf16<6>(qkv, out, l, batch, seq, heads, dim, scale, s);
    case 7: return launch_bf16<7>(qkv, out, l, batch, seq, heads, dim, scale, s);
    default: return launch_bf16<8>(qkv, out, l, batch, seq, heads, dim, scale, s);
  }
}
