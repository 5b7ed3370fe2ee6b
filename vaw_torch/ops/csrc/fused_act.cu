// Fused bias + leaky ReLU x scale over a [rows, C] view (the StyleGAN2
// fused_bias_act op): out = where(x + b >= 0, x + b, (x + b) * slope) * scale,
// the bias broadcast over the trailing (channel) axis.
//
// Replaces vaw_tpu/ops/fused_act.py:_kernel (_fused_forward). Contract:
//   x   [rows * C] contiguous, bf16 or f32; out the same shape and dtype.
//   b   [C] in x's dtype.
// Arithmetic is the JAX kernel's: in bf16 the add, the slope multiply and
// the scale multiply each round to bf16 (the caller passes slope and scale
// rounded to bf16, as JAX rounds its weak-typed constants).
//
// Bound. One read of x and one write of out: at (128, 64, 64, 192) bf16 that
// is 402.7 MB, 0.120 ms at 3.35 TB/s; 4 operations an element are nothing
// next to it. So it is bound by bytes.
//
// Design. The TPU kernel takes the whole array as one VMEM block. Here a
// grid-stride loop walks 16-byte chunks of x (8 bf16 or 4 f32 values): one
// vector load, the channel of the chunk's first value found once and then
// stepped, one vector store. The values past the last whole chunk (the
// scalar tail) go one at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// ROUND: every step rounds to bf16.
template <bool ROUND>
__device__ __forceinline__ float act(float x, float b, float slope, float scale) {
  float t = x + b;
  if (ROUND) t = round_bf16(t);
  if (!(t >= 0.f)) {
    t = t * slope;
    if (ROUND) t = round_bf16(t);
  }
  return t * scale;
}

template <typename T>
__global__ void fused_leaky_relu_kernel(const T* __restrict__ x, const T* __restrict__ bias,
                                        T* __restrict__ out, long long total, int c,
                                        float slope, float scale) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr bool ROUND = sizeof(T) == 2;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long chunks = total / kVec;
  for (long long v = first; v < chunks; v += stride) {
    uint4 raw = reinterpret_cast<const uint4*>(x)[v];
    T* vals = reinterpret_cast<T*>(&raw);
    int ch = static_cast<int>((v * kVec) % c);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      vals[e] = from_f<T>(act<ROUND>(to_f(vals[e]), to_f(bias[ch]), slope, scale));
      if (++ch == c) ch = 0;
    }
    reinterpret_cast<uint4*>(out)[v] = raw;
  }
  for (long long i = chunks * kVec + first; i < total; i += stride) {
    const int ch = static_cast<int>(i % c);
    out[i] = from_f<T>(act<ROUND>(to_f(x[i]), to_f(bias[ch]), slope, scale));
  }
}

template <typename T>
int launch(const void* x, const void* bias, void* out, long long total, int c, float slope,
           float scale, cudaStream_t stream) {
  constexpr int kThreads = 256;
  const long long chunks = total / (16 / sizeof(T));
  long long blocks = (chunks + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 16) blocks = 132 * 16;
  fused_leaky_relu_kernel<T><<<static_cast<int>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(bias), static_cast<T*>(out), total, c,
      slope, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes. x and out are 16-byte aligned and hold
// `total` values, a whole number of rows of `c`; is_bf16 selects
// __nv_bfloat16 over float for x, b and out. Launches on `stream`; returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int vaw_fused_leaky_relu(const void* x, const void* bias, void* out,
                                    long long total, int c, float slope, float scale,
                                    int is_bf16, void* stream) {
  if (total <= 0 || c <= 0 || total % c != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<bf16>(x, bias, out, total, c, slope, scale, s);
  return launch<float>(x, bias, out, total, c, slope, scale, s);
}
