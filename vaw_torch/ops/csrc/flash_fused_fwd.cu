// Fused multi-head softmax attention, forward only, read straight from the
// raw fused QKV projection: the f32 kernel for a scale <= 0.
//
// Replaces vaw_tpu/ops/flash_attention.py:_fwd_kernel_p6 (the forward of
// _flash_p6) with the kernels of flash_fwd.cu on the packed row's three
// views (vaw_torch/ops/flash_attention.py:_fused_forward): bf16 with
// scale > 0 (every model call: the DiT's sampling and training, REPA's
// teacher) on its TMA + wgmma kernel, f32 with scale > 0 on its 3xTF32
// kernel, bf16 with scale <= 0 on its mma.sync kernel. This file keeps the
// rest: f32 with scale <= 0, which the 3xTF32 kernel's softmax (its max on
// the raw scores) does not take. Same contract:
//   qkv2d [B, T, 3*H*D] f32, last axis laid out (3, H, D): q, k and v of
//     head h sit at column offsets h*D, H*D + h*D and 2*H*D + h*D of each
//     row, row stride 3*H*D. They are read in place, never copied.
//   o   [B, T, H*D] f32, t-major, so the out-projection takes it as it is.
//   lse [B*H, T] f32, the natural-log log-sum-exp of the scaled scores,
//       kept for the backward.
//   Any T; D % 8 == 0, D <= 128.
//
// Design. The TPU kernel holds all 256 keys of up to 48 (batch, head) rows
// in VMEM at once, and its T == 256 gate is a VMEM limit. Here a block takes
// 64 queries of one (b, h), and the keys stream through in tiles of 32 with
// an online softmax (running max and sum, as in
// vaw_tpu/ops/flash_attention.py:_fwd_kernel), so any T works. Plain f32
// FMAs keep every operand f32. Four neighbouring threads share one query;
// each holds a quarter of q and of the accumulator (interleaved 4-float
// chunks, so the four read neighbouring shared-memory words), and two warp
// shuffles complete each score.

#include "flash_common.cuh"

namespace {

using namespace vaw_flash;

constexpr int kBlockQ = 64;  // queries of a block

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

// Plain C entry point for ctypes, f32 only. Launches on `stream` and
// returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int vaw_flash_fused_fwd(const void* qkv, void* out, void* lse,
                                   int batch, int seq, int heads, int dim,
                                   float scale, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || dim <= 0 || dim % 8 != 0 ||
      dim > 128 || batch > 65535 || heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dim <= 32) return launch_f32<2>(qkv, out, l, batch, seq, heads, dim, scale, s);
  if (dim <= 64) return launch_f32<4>(qkv, out, l, batch, seq, heads, dim, scale, s);
  return launch_f32<8>(qkv, out, l, batch, seq, heads, dim, scale, s);
}
