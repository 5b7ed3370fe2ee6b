// Device helpers shared by the attention kernels (flash_fused_fwd.cu,
// flash_fused_bwd.cu, flash_fwd.cu, flash_bwd.cu, flash_p5_fwd.cu,
// flash_p5_bwd.cu): the bf16 tensor-core product, fragment loads, the
// hi + lo split of f32 values into bf16, strided [B, T, H, D] views, the
// staging of tiles into padded shared memory (token-major and d-major), the
// backward's delta pass and the f32 FMA path's row helpers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace vaw_flash {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kTile = 64;                  // rows of a bf16 tile (queries or keys)
constexpr int kMmaWarps = kTile / 16;      // 16 rows per warp
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kRowPad = 8;                 // bf16 pad per smem row: no bank conflicts
constexpr int kFmaThreads = 256;           // threads of an f32 block

// A [B, T, H, D] view: element (b, t, h, d) at p[b*sb + t*st + h*sh + d].
template <typename T>
struct View {
  T* p;
  long long sb, st, sh;
  __device__ __forceinline__ T* head(int b, int h) const {
    return p + (long long)b * sb + (long long)h * sh;
  }
};

// Padded width of a bf16 tile and the split of the output columns. Scores
// use all NK 16-wide steps of the head dim; a block owns NDO 8-wide output
// column tiles, so the 2*NK tiles are split over kSplits blocks of at most
// max_tiles each. The smem width covers every split's columns.
template <int NK, int MAX_TILES>
struct Split {
  static constexpr int kSplits = (2 * NK + MAX_TILES - 1) / MAX_TILES;
  static constexpr int NDO = (2 * NK + kSplits - 1) / kSplits;
  static constexpr int kWidth = (16 * NK > 8 * NDO * kSplits) ? 16 * NK : 8 * NDO * kSplits;
  static constexpr int LD = kWidth + kRowPad;
};

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const void* smem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* smem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragments (16 rows x 16 of the head dim, k-step kk) of the rows
// [row0, row0 + 16) of a padded shared-memory tile.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t a[4], __nv_bfloat16 (*tile)[LD],
                                       int row0, int kk, int quad, int pair) {
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    a[f] = ld_u32(&tile[row0 + quad + (f & 1) * 8][kk * 16 + (f >> 1) * 8 + 2 * pair]);
  }
}

// The same A fragments from a d-major tile, tile[k][m] (the contraction dim
// on the rows, the 16 rows of A on the unit-stride columns): ldmatrix .trans
// of four 8x8 blocks; lane l addresses a row of block l / 8, which is
// fragment a0 (m 0-7, k 0-7), a1 (m 8-15, k 0-7), a2 (m 0-7, k 8-15) or a3.
template <int LD>
__device__ __forceinline__ void load_a_trans(uint32_t a[4], __nv_bfloat16 (*tile)[LD],
                                             int row0, int kk, int lane) {
  const int j = lane >> 3;
  ldmatrix_x4_trans(a, &tile[kk * 16 + (j >> 1) * 8 + (lane & 7)][row0 + (j & 1) * 8]);
}

// The accumulator tile x (16 rows x 64 columns, as 8 n-tiles of 8) as bf16
// A fragments of k-step kk (columns kk*16 .. kk*16+15), split hi + lo:
// hi = bf16(x), lo = bf16(x - hi), about 16 significant bits in all.
__device__ __forceinline__ void split_a(uint32_t hi[4], uint32_t lo[4],
                                        float (*x)[4], int kk) {
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    const float* p = &x[2 * kk + (f >> 1)][(f & 1) * 2];
    const __nv_bfloat162 ph = __floats2bfloat162_rn(p[0], p[1]);
    hi[f] = as_u32(ph);
    lo[f] = as_u32(__floats2bfloat162_rn(p[0] - __low2float(ph), p[1] - __high2float(ph)));
  }
}

// Rows [row0, row0 + 64) and columns [col0, col0 + width) of the rows of one
// head (row r at base + r * stride) into a padded tile; rows at or past
// `rows` and columns at or past `dim` are zeros. 16-byte loads: dim % 8 == 0
// and 16-byte aligned rows are the caller's contract.
template <int LD>
__device__ __forceinline__ void stage_tile(__nv_bfloat16 (*tile)[LD],
                                           const __nv_bfloat16* base, long long stride,
                                           int row0, int rows, int col0, int width,
                                           int dim, int tid) {
  const int vec_per_row = width / 8;
  for (int idx = tid; idx < kTile * vec_per_row; idx += kMmaThreads) {
    const int j = idx / vec_per_row;
    const int c8 = (idx - j * vec_per_row) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + j < rows && col0 + c8 < dim) {
      v = *reinterpret_cast<const uint4*>(base + (long long)(row0 + j) * stride + col0 + c8);
    }
    *reinterpret_cast<uint4*>(&tile[j][c8]) = v;
  }
}

// d-major tiles: one head of a [D, T] matrix with T the unit stride. Rows
// [0, rows) of the tile take dims 0 .. rows - 1 and its 64 columns the
// tokens [col0, col0 + 64): tile[d][j] = base[d * seq + col0 + j], zeros for
// d >= dim or col0 + j >= seq. 16-byte loads along T: seq % 8 == 0 and a
// 16-byte aligned base are the caller's contract.
template <int LD>
__device__ __forceinline__ void stage_dmajor(__nv_bfloat16 (*tile)[LD],
                                             const __nv_bfloat16* base, int seq, int col0,
                                             int rows, int dim, int tid) {
  constexpr int kVec = kTile / 8;
  for (int idx = tid; idx < rows * kVec; idx += kMmaThreads) {
    const int d = idx / kVec;
    const int c8 = (idx - d * kVec) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (d < dim && col0 + c8 < seq) {
      v = *reinterpret_cast<const uint4*>(base + (long long)d * seq + col0 + c8);
    }
    *reinterpret_cast<uint4*>(&tile[d][c8]) = v;
  }
}

// The accumulator x of a warp's 16 rows (row0 ..., NDO 8-wide column tiles),
// row r times mul[r] (r = 0 for row0 + quad, 1 for row0 + quad + 8), into a
// d-major staging tile: tile[column][row].
template <int NDO, int LD>
__device__ __forceinline__ void stage_acc_dmajor(__nv_bfloat16 (*tile)[LD], float (*x)[4],
                                                 int row0, int quad, int pair,
                                                 const float mul[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + quad + 8 * r;
#pragma unroll
    for (int nd = 0; nd < NDO; ++nd) {
      const int col = nd * 8 + 2 * pair;
      tile[col][row] = __float2bfloat16_rn(x[nd][2 * r] * mul[r]);
      tile[col + 1][row] = __float2bfloat16_rn(x[nd][2 * r + 1] * mul[r]);
    }
  }
}

// Rows [0, rows) of a staged d-major tile to dims d0 + r of one head,
// base[(d0 + r) * seq + col0 + j], 16 bytes a store along T; dims past `dim`
// and tokens past `seq` are not written.
template <int LD>
__device__ __forceinline__ void store_dmajor(__nv_bfloat16* base,
                                             __nv_bfloat16 (*tile)[LD], int seq, int col0,
                                             int d0, int rows, int dim, int tid) {
  constexpr int kVec = kTile / 8;
  for (int idx = tid; idx < rows * kVec; idx += kMmaThreads) {
    const int r = idx / kVec;
    const int c8 = (idx - r * kVec) * 8;
    if (d0 + r < dim && col0 + c8 < seq) {
      *reinterpret_cast<uint4*>(base + (long long)(d0 + r) * seq + col0 + c8) =
          *reinterpret_cast<const uint4*>(&tile[r][c8]);
    }
  }
}

// ------------------------------------------------------------------ delta
template <typename T>
__device__ __forceinline__ float dot_chunk(const T* a, const T* b);

// Dot product of 8 neighbouring values (one 16-byte bf16 or two f32 loads).
template <>
__device__ __forceinline__ float dot_chunk<__nv_bfloat16>(const __nv_bfloat16* a,
                                                          const __nv_bfloat16* b) {
  const uint4 av = *reinterpret_cast<const uint4*>(a);
  const uint4 bv = *reinterpret_cast<const uint4*>(b);
  const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&av);
  const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&bv);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(a2[i]);
    const float2 y = __bfloat1622float2(b2[i]);
    s = fmaf(x.x, y.x, s);
    s = fmaf(x.y, y.y, s);
  }
  return s;
}

template <>
__device__ __forceinline__ float dot_chunk<float>(const float* a, const float* b) {
  const float4 x0 = *reinterpret_cast<const float4*>(a);
  const float4 y0 = *reinterpret_cast<const float4*>(b);
  const float4 x1 = *reinterpret_cast<const float4*>(a + 4);
  const float4 y1 = *reinterpret_cast<const float4*>(b + 4);
  float s = x0.x * y0.x;
  s = fmaf(x0.y, y0.y, s);
  s = fmaf(x0.z, y0.z, s);
  s = fmaf(x0.w, y0.w, s);
  s = fmaf(x1.x, y1.x, s);
  s = fmaf(x1.y, y1.y, s);
  s = fmaf(x1.z, y1.z, s);
  s = fmaf(x1.w, y1.w, s);
  return s;
}

// The body of a backward's delta pass, one thread per (b, t, h) row of the
// contiguous [B, T, H, D] out and dout: delta[(b*H + h)*T + t] =
// sum_d dout * out in f32.
template <typename T>
__device__ __forceinline__ void bwd_delta_row(const T* __restrict__ out,
                                              const T* __restrict__ dout,
                                              float* __restrict__ delta, long long rows,
                                              int seq, int heads, int dim) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows) return;
  const int h = static_cast<int>(idx % heads);
  const long long bt = idx / heads;
  const int t = static_cast<int>(bt % seq);
  const long long b = bt / seq;
  const long long off = idx * dim;
  float s = 0.f;
  for (int d = 0; d < dim; d += 8) s += dot_chunk<T>(out + off + d, dout + off + d);
  delta[(b * heads + h) * seq + t] = s;
}

// ------------------------------------------------------------------- f32
// L neighbouring threads share one row; thread `part` owns dims
// 4 * (part + L * i) + e of it, i < NCH, so the head dim is padded with
// zeros to DP = 4 * L * NCH and the L threads read neighbouring 16-byte
// words of a shared-memory row. A row's dims lie `stride` apart in device
// memory (1 for a token-major row, T for a d-major one).
template <int NCH, int L>
__device__ __forceinline__ void load_row(float x[NCH][4], const float* row, bool valid,
                                         int dim, int part, float mul,
                                         long long stride = 1) {
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * (part + L * i) + e;
      x[i][e] = (valid && d < dim) ? row[d * stride] * mul : 0.f;
    }
  }
}

// Dot product of a thread's dims with a shared-memory row, completed across
// the row's L threads.
template <int NCH, int L>
__device__ __forceinline__ float row_dot(float x[NCH][4], const float* srow, int part) {
  float dot = 0.f;
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const float4 y = *reinterpret_cast<const float4*>(srow + 4 * (part + L * i));
    dot = fmaf(x[i][0], y.x, dot);
    dot = fmaf(x[i][1], y.y, dot);
    dot = fmaf(x[i][2], y.z, dot);
    dot = fmaf(x[i][3], y.w, dot);
  }
#pragma unroll
  for (int off = 1; off < L; off <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
  return dot;
}

template <int NCH, int L>
__device__ __forceinline__ void row_axpy(float acc[NCH][4], float a, const float* srow,
                                         int part) {
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const float4 y = *reinterpret_cast<const float4*>(srow + 4 * (part + L * i));
    acc[i][0] = fmaf(a, y.x, acc[i][0]);
    acc[i][1] = fmaf(a, y.y, acc[i][1]);
    acc[i][2] = fmaf(a, y.z, acc[i][2]);
    acc[i][3] = fmaf(a, y.w, acc[i][3]);
  }
}

template <int NCH, int L>
__device__ __forceinline__ void store_row(float* row, float x[NCH][4], int dim,
                                          int part, float mul, long long stride = 1) {
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * (part + L * i) + e;
      if (d < dim) row[d * stride] = x[i][e] * mul;
    }
  }
}

// Rows [row0, row0 + R) of one head's rows into an [R][DP] tile, each value
// times `mul`; rows past `rows` are zeros. Columns [dim, DP) are zeroed once
// by zero_pad and never written here.
template <int R, int DP>
__device__ __forceinline__ void stage_rows(float (*tile)[DP], const float* base,
                                           long long stride, int row0, int rows, int dim,
                                           float mul, int tid) {
  const int vec_per_row = dim / 4;
  for (int idx = tid; idx < R * vec_per_row; idx += kFmaThreads) {
    const int j = idx / vec_per_row;
    const int d0 = (idx - j * vec_per_row) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + j < rows) {
      v = *reinterpret_cast<const float4*>(base + (long long)(row0 + j) * stride + d0);
      v.x *= mul;
      v.y *= mul;
      v.z *= mul;
      v.w *= mul;
    }
    *reinterpret_cast<float4*>(&tile[j][d0]) = v;
  }
}

// The same tile from one head of a d-major [D, T] matrix: tile[j][d] =
// base[d * seq + row0 + j] * mul, rows past `seq` zeros; 16-byte loads
// along T (seq % 4 == 0), transposed into the tile one value at a time.
template <int R, int DP>
__device__ __forceinline__ void stage_cols(float (*tile)[DP], const float* base, int seq,
                                           int row0, int dim, float mul, int tid) {
  constexpr int kVec = R / 4;
  for (int idx = tid; idx < dim * kVec; idx += kFmaThreads) {
    const int d = idx / kVec;
    const int j = (idx - d * kVec) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + j < seq) {
      v = *reinterpret_cast<const float4*>(base + (long long)d * seq + row0 + j);
    }
    tile[j][d] = v.x * mul;
    tile[j + 1][d] = v.y * mul;
    tile[j + 2][d] = v.z * mul;
    tile[j + 3][d] = v.w * mul;
  }
}

template <int R, int DP>
__device__ __forceinline__ void zero_pad(float (*a)[DP], float (*b)[DP], int dim, int tid) {
  if (dim >= DP) return;
  for (int idx = tid; idx < R * DP; idx += kFmaThreads) {
    const int d = idx % DP;
    if (d >= dim) {
      a[idx / DP][d] = 0.f;
      b[idx / DP][d] = 0.f;
    }
  }
}

}  // namespace vaw_flash
