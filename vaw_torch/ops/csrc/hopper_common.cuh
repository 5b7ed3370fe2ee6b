// Device and host helpers shared by the Hopper (sm_90a) kernels that load
// their tiles with the Tensor Memory Accelerator and multiply on warpgroup
// tensor-core instructions: flash_p5_fwd.cu and flash_p5_bwd.cu (the
// d-major attention forward and backward), flash_fwd.cu and flash_bwd.cu
// (the general-T attention forward and backward, also the fused
// attention's on the packed row's views), conv3x3_fwd.cu (the 3x3 conv
// forward and dgrad) and
// conv3x3_wgrad.cu (its filter gradient). The mma.sync kernels keep their
// helpers in flash_common.cuh.
//
// What is here:
// - mbarrier init, arrive, expect-tx and parity wait; named barriers; the
//   barrier setup of the backward kernels' pipelines;
// - TMA tile loads (2- to 5-D) and plain bulk copies into shared memory,
//   completing on an mbarrier, and a predicated global load; TMA stores (3-
//   and 4-D) from shared memory in bulk groups;
// - wgmma fences, commit and wait, the shared-memory matrix descriptors of
//   the 128-byte-swizzled layout TMA writes, and the m64nNk16 bf16 products
//   (both operands in shared memory, either one read MN-major, or A from
//   registers); the m64nNk8 TF32 products (K-major operands only) of the
//   general forward's 3xTF32 f32 design and its hi + lo split;
// - the general-T attention's bf16 tile geometry over slabs of the head dim
//   (AttnGeo: 32, 64, 80, 96 or 128 columns), its tensor maps, loads, stores,
//   swizzled chunk offsets, K-major descriptors and the products whose
//   width is the head dim;
// - the attention forwards' online softmax of a 64 x 64 (or 64 x 32) score
//   tile in the accumulator layout, and its split into the bf16 (or TF32)
//   hi + lo A fragments of the P.V product; the 3xTF32 forwards' walk of a
//   consumer warpgroup over one work item's key tiles;
// - the 3xTF32 backward pairs' dQ and dK/dV kernels (producer, splitters
//   and consumer loop) over a layout that each pair supplies;
// - on the host, cuTensorMapEncodeTiled fetched from the driver through
//   the runtime (cudaGetDriverEntryPoint), so the libraries need no -lcuda.
//
// Layout. Every tile here is loaded by TMA with CU_TENSOR_MAP_SWIZZLE_128B
// and a 64-element (128-byte) inner box: row r of the tile is 128 bytes at
// r * 128, its 16-byte chunk c stored at chunk c ^ (r % 8). Tiles start on
// 1024-byte boundaries, so the pattern is the same for every 8 rows. As a
// wgmma operand such a tile is:
// - K-major (the reduced dimension along the row; A = q or x, B = k, the
//   filter, or the d-major v): 8-row groups 1024 bytes apart (SBO), a
//   16-wide k step 32 bytes further along the row (the start address
//   moves, the swizzle is applied by the hardware on the address);
// - MN-major (the output dimension along the row; A = the d-major q or the
//   pixel-major x of the filter gradient, B = the token-major v, the
//   d-major k or the pixel-major g): 8-row groups of the reduced dimension
//   1024 bytes apart (SBO), the next 64 output columns in the next tile
//   (LBO), a 16-row k step 2048 bytes further. The descriptor is the same
//   for A and B; the product's TRANS_A or TRANS_B says which it is.
// The general-T attention kernels also load tiles whose rows are 64 bytes
// (a head dim of 32, the last 32 columns of one padded to 96) with
// CU_TENSOR_MAP_SWIZZLE_64B: chunk c of row r at
// c ^ ((r / 2) % 4), the pattern repeating every 8 rows (512 bytes); and
// tiles whose rows are 32 bytes (the last 16 columns of a head dim padded
// to 80) with CU_TENSOR_MAP_SWIZZLE_32B: chunk c of row r at c ^ ((r / 4)
// % 2), repeating every 8 rows (256 bytes). The descriptors below take the
// swizzle width SW (32, 64 or 128 bytes) as a template argument or, where
// a loop's step picks the slab, as an argument: 8-row groups 8 * SW bytes
// apart, and for MN-major operands SW / 2 output columns to a tile.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only; nothing links to libcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"  // kLog2e

namespace vaw_hopper {

constexpr int kSwizzleRowBytes = 128;   // one tile row: 64 bf16
constexpr int kSwizzleAtomBytes = 1024;  // 8 rows: the swizzle's period

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async (TMA) proxy.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA transactions to come.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// The barriers of a backward kernel's pipeline (flash_bwd.cu,
// flash_p5_bwd.cu): a full / empty pair for each of two work items' tiles
// and for each of `ns` ring stages. A full barrier completes on the
// producer's one arrival and its TMA bytes, an empty one on an arrival of
// each of `consumers` threads.
__device__ __forceinline__ void init_barriers(uint64_t* item_full, uint64_t* item_empty,
                                              uint64_t* full, uint64_t* empty, int ns,
                                              int consumers) {
  for (int i = 0; i < 2; ++i) {
    mbar_init(&item_full[i], 1);
    mbar_init(&item_empty[i], consumers);
  }
  for (int s = 0; s < ns; ++s) {
    mbar_init(&full[s], 1);
    mbar_init(&empty[s], consumers);
  }
  fence_barrier_init();
}

// Waits until the barrier's phase with the given parity has completed. A
// phase that never completes (a load that was never issued) ends the kernel
// with an error after some seconds instead of hanging the device.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  uint32_t tries = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (++tries == (1u << 26)) __trap();
  } while (!done);
}

// -------------------------------------------------------------- TMA loads
// Coordinates are element indices, innermost first, and may be negative or
// past the end: TMA fills what lies outside the tensor with zeros. The
// transaction count is the whole box either way.

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1, int c2,
                                            int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// A plain (non-tensor) bulk copy of `bytes` (a multiple of 16, both
// addresses 16-byte aligned) from global to shared memory.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// x = *p where `valid` (else x keeps its value), as one predicated load:
// nothing waits for it until x is next used.
__device__ __forceinline__ void load_if(float& x, const float* p, bool valid) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %2, 0;\n@q ld.global.nc.f32 %0, [%1];\n}\n"
      : "+f"(x)
      : "l"(p), "r"(static_cast<int>(valid)));
}

// ------------------------------------------------------------- TMA stores
// A box of shared memory to the tensor; what lies outside the tensor is not
// written. Completion is tracked per thread in bulk groups.

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src,
                                             int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.tile.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src,
                                             int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.tile.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until the committed stores have read their shared memory (READ) or
// completed.
template <bool READ>
__device__ __forceinline__ void bulk_wait() {
  if (READ) {
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  } else {
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// Orders this thread's ordinary shared-memory writes before later accesses
// by the async proxy (a TMA store, a wgmma read).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A barrier among `count` threads (a multiple of 32) of the block, id > 0.
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void prefetch_tensor_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map))
               : "memory");
}

// ------------------------------------------------------------------ wgmma

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the fence (the accumulator is written
// asynchronously).
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Shared-memory matrix descriptor of an operand starting at shared address
// `addr`, swizzled `sw` bytes wide (128, 64 or 32: the layout type 1, 2 or
// 3; see the layout note above; byte offsets, multiples of 16).
__device__ __forceinline__ uint64_t smem_desc_at(uint32_t addr, uint32_t lbo_bytes,
                                                 uint32_t sbo_bytes, int sw) {
  return ((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo_bytes >> 4) << 16) |
         (static_cast<uint64_t>(sbo_bytes >> 4) << 32) |
         (static_cast<uint64_t>(sw == 128 ? 1 : sw == 64 ? 2 : 3) << 62);
}

template <int SW = 128>
__device__ __forceinline__ uint64_t smem_desc(const void* smem, uint32_t lbo_bytes,
                                              uint32_t sbo_bytes) {
  static_assert(SW == 32 || SW == 64 || SW == 128, "swizzle of 32, 64 or 128 bytes");
  return smem_desc_at(smem_u32(smem), lbo_bytes, sbo_bytes, SW);
}

// K-major operand: one slab of the reduced dimension, rows SW bytes apart.
template <int SW = 128>
__device__ __forceinline__ uint64_t desc_k_major(const void* smem) {
  return smem_desc<SW>(smem, 16, 8 * SW);
}

// MN-major operand (A or B): output columns SW / 2 to a tile, tiles
// `tile_bytes` apart.
template <int SW = 128>
__device__ __forceinline__ uint64_t desc_mn_major(const void* smem, uint32_t tile_bytes) {
  return smem_desc<SW>(smem, tile_bytes, 8 * SW);
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a tile that TMA
// reads or writes with a SW-byte swizzle (rows SW bytes apart; the tile
// starts on a 1024-byte boundary).
template <int SW>
__device__ __forceinline__ uint32_t swizzled(int row, int chunk) {
  const uint32_t a = static_cast<uint32_t>(row * SW + chunk * 16);
  return a ^ (((a >> 7) & (SW / 16 - 1)) << 4);
}

// Tile geometry of the general-T attention kernels (flash_fwd.cu,
// flash_bwd.cu) for a head dim padded to DP (32, 64, 80, 96 or 128). A tile
// row is kSlabs slabs: slab s holds columns 64 s .. 64 s + width(s) - 1,
// its rows swizzle(s) = 2 width(s) bytes apart and swizzled that wide. So
// a head dim of 32 (DP = 32) is one 64-byte slab, neither padded nor
// multiplied twice; DP = 64 and 128 are one and two 128-byte slabs; DP =
// 80, the XL models' head dim of 72, is a 128-byte slab of 64 columns and
// a 32-byte slab of 16, padded to 80 and not to 128; DP = 96 (UNet-64's
// head dim) a 128-byte slab of 64 and a 64-byte slab of 32. Slab s of a
// tile of R rows starts 2 R col(s) bytes in (every slab of a 64-row tile
// on a 1024-byte boundary). A box is 64 rows of one slab, read through the
// view's tensor map of that slab's width: kMaps maps a view, two for DP =
// 80 and 96 (map(s) says which).
template <int DP>
struct AttnGeo {
  static_assert(DP == 32 || DP == 64 || DP == 80 || DP == 96 || DP == 128,
                "DP of 32, 64, 80, 96 or 128");
  static constexpr int kSlabs = DP == 32 ? 1 : (DP + 63) / 64;
  static constexpr int kMaps = DP > 64 && DP % 64 != 0 ? 2 : 1;
  __host__ __device__ static constexpr int col(int s) { return 64 * s; }
  __host__ __device__ static constexpr int width(int s) {
    return DP == 32 ? 32 : (DP - col(s) < 64 ? DP - col(s) : 64);
  }
  __host__ __device__ static constexpr int swizzle(int s) { return 2 * width(s); }
  __host__ __device__ static constexpr int map(int s) {
    return width(s) == width(0) ? 0 : 1;
  }
  // The slab that holds column c.
  __host__ __device__ static constexpr int slab_of(int c) { return c / 64; }
  // Byte offset of slab s in a tile of `rows` rows.
  __host__ __device__ static constexpr uint32_t offset(int s, int rows) {
    return 2u * col(s) * rows;
  }
};

// The tensor maps of one view, one for each slab width of AttnGeo<DP>.
template <int DP>
struct ViewMaps {
  CUtensorMap m[AttnGeo<DP>::kMaps];
};

// Byte offset of 16-byte chunk c (of DP / 8) of row `row` in a tile of
// `rows` rows of AttnGeo<DP>, swizzled as TMA reads and writes it.
template <int DP>
__device__ __forceinline__ uint32_t attn_chunk(int rows, int row, int c) {
  using G = AttnGeo<DP>;
  const int s = G::slab_of(8 * c);
  const int sw = G::swizzle(s);
  const uint32_t a = static_cast<uint32_t>(row * sw + (c - G::col(s) / 8) * 16);
  return G::offset(s, rows) + (a ^ (((a >> 7) & (sw / 16 - 1)) << 4));
}

// The descriptor of 16-deep step kk (columns 16 kk ..) of a K-major
// operand: rows row0 .. of a tile of `rows` rows of AttnGeo<DP> at shared
// address `tile`.
template <int DP>
__device__ __forceinline__ uint64_t attn_k_desc(uint32_t tile, int rows, int row0, int kk) {
  using G = AttnGeo<DP>;
  const int s = G::slab_of(16 * kk);
  const int sw = G::swizzle(s);
  return smem_desc_at(tile + G::offset(s, rows) + row0 * sw + 2 * (16 * kk - G::col(s)), 16,
                      8 * sw, sw);
}

// Issues the loads of `rows` rows (a multiple of 64) from token t0 of one
// (b, h) of a view into a tile of that many rows of AttnGeo<DP>, completing
// on `bar`.
template <int DP>
__device__ __forceinline__ void attn_load(void* tile, const ViewMaps<DP>* maps,
                                          uint64_t* bar, int rows, int h, int t0, int b) {
  using G = AttnGeo<DP>;
  uint8_t* base = static_cast<uint8_t*>(tile);
#pragma unroll
  for (int s = 0; s < G::kSlabs; ++s) {
    for (int r = 0; r < rows; r += 64) {
      tma_load_4d(base + G::offset(s, rows) + r * G::swizzle(s), &maps->m[G::map(s)], bar,
                  G::col(s), h, t0 + r, b);
    }
  }
}

// Stores rows r0 .. r0 + 63 of a tile of `rows` rows of AttnGeo<DP> to
// tokens t0 .. t0 + 63 of one (b, h) of a view (rows past T and columns past
// D are not written).
template <int DP>
__device__ __forceinline__ void attn_store(const ViewMaps<DP>* maps, const void* tile,
                                           int rows, int r0, int h, int t0, int b) {
  using G = AttnGeo<DP>;
  const uint8_t* base = static_cast<const uint8_t*>(tile);
#pragma unroll
  for (int s = 0; s < G::kSlabs; ++s) {
    tma_store_4d(&maps->m[G::map(s)], base + G::offset(s, rows) + r0 * G::swizzle(s),
                 G::col(s), h, t0, b);
  }
}

// The m64nNk16 bf16 products with f32 accumulators: `ss` with both
// operands in shared memory (N = 64, 128, 192: the scores, the convs),
// `rs` with A from registers (the accumulator fragment layout, two bf16 a
// register; the attention's P.V at N = 16, 32, ..., 128, the padded head
// dim).
// Thread t of the warpgroup holds rows 16 * (t / 32) + (t % 32) / 4 (+ 8)
// of D: d[4 * c + e] is row ... + 8 * (e / 2), column 8 * c + 2 * (t % 4) +
// e % 2 (the mma.sync m16n8 accumulator, repeated over N / 8 columns).
// `accumulate` 0 overwrites D. TRANS_A 1 reads A MN-major, TRANS_B 1 reads
// B MN-major (A from registers has no such choice).
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  template <int TRANS_B>
  static __device__ __forceinline__ void rs(float (&d)[8], const uint32_t (&a)[4], uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
          "n"(TRANS_B));
  }
};

template <>
struct Wgmma<32> {
  template <int TRANS_B>
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
          "n"(TRANS_B));
  }
};

template <>
struct Wgmma<48> {
  template <int TRANS_B>
  static __device__ __forceinline__ void rs(float (&d)[24], const uint32_t (&a)[4], uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23"
        "}, {%24, %25, %26, %27}, %28, p, 1, 1, %30;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
          "n"(TRANS_B));
  }
};

template <>
struct Wgmma<64> {
  template <int TRANS_A, int TRANS_B>
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_A), "n"(TRANS_B));
  }
  template <int TRANS_B>
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
          "n"(TRANS_B));
  }
};

template <>
struct Wgmma<80> {
  template <int TRANS_B>
  static __device__ __forceinline__ void rs(float (&d)[40], const uint32_t (&a)[4], uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39"
        "}, {%40, %41, %42, %43}, %44, p, 1, 1, %46;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
          "n"(TRANS_B));
  }
};

template <>
struct Wgmma<96> {
  template <int TRANS_B>
  static __device__ __forceinline__ void rs(float (&d)[48], const uint32_t (&a)[4], uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, {%48, %49, %50, %51}, %52, p, 1, 1, %54;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
          "n"(TRANS_B));
  }
};

template <>
struct Wgmma<112> {
  template <int TRANS_B>
  static __device__ __forceinline__ void rs(float (&d)[56], const uint32_t (&a)[4], uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55"
        "}, {%56, %57, %58, %59}, %60, p, 1, 1, %62;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
          "n"(TRANS_B));
  }
};

template <>
struct Wgmma<128> {
  template <int TRANS_A, int TRANS_B>
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_A), "n"(TRANS_B));
  }
  template <int TRANS_B>
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
          "n"(TRANS_B));
  }
};

template <>
struct Wgmma<192> {
  template <int TRANS_A, int TRANS_B>
  static __device__ __forceinline__ void ss(float (&d)[96], uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, %96, %97, p, 1, 1, %99, %100;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_A), "n"(TRANS_B));
  }
};

// acc += A B for one 16-deep step of an attention product whose width is
// the head dim (O += P v, dQ += dS k, dV += P^T dout, dK += dS^T q), A (P or
// dS, bf16 hi or lo) from registers, B the MN-major rows k0 .. k0 + 15 of a
// tile of `rows` rows of AttnGeo<DP> at shared address `tile`: one wgmma
// N = DP over slabs of one width (the next slab's 64 columns `rows *
// swizzle` bytes on, the LBO); over the two slabs of DP = 80 or 96, N = 64
// into acc[0..31] and N = DP - 64 into acc[32..], together the N = DP
// accumulator's layout.
template <int DP>
__device__ __forceinline__ void attn_mn_rs(float (&acc)[DP / 2], const uint32_t (&a)[4],
                                           uint32_t tile, int rows, int k0) {
  using G = AttnGeo<DP>;
  if constexpr (G::kMaps == 1) {
    constexpr int sw = G::swizzle(0);
    const uint64_t db = smem_desc_at(tile + k0 * sw, rows * sw, 8 * sw, sw);
    Wgmma<DP>::template rs<1>(acc, a, db, 1);
  } else {
    constexpr int sw = G::swizzle(1);
    const uint64_t db64 = smem_desc_at(tile + k0 * 128, rows * 128, 1024, 128);
    const uint64_t dbr =
        smem_desc_at(tile + G::offset(1, rows) + k0 * sw, rows * sw, 8 * sw, sw);
    Wgmma<64>::template rs<1>(*reinterpret_cast<float(*)[32]>(&acc[0]), a, db64, 1);
    Wgmma<DP - 64>::template rs<1>(*reinterpret_cast<float(*)[DP / 2 - 32]>(&acc[32]), a,
                                   dbr, 1);
  }
}

// The m64nNk8 TF32 products with f32 accumulators (N = 32, 64 with both
// operands in shared memory or A from registers; N = 96, 128 with A from
// registers). A 32-bit operand is read as TF32: the tensor core takes its
// sign, exponent and top ten mantissa bits and ignores the low 13 bits, so
// a raw f32 value would enter cut (truncated) to TF32; tf32_hi below rounds
// instead. Both shared-memory
// operands must be K-major (TF32 has no transposed read); a k8 step is 32
// bytes of a row, as a bf16 k16 step, so the descriptors above serve both.
// The accumulator layout is the bf16 products'. An A fragment from
// registers holds, in thread t of warp w, rows 16 * w + (t % 32) / 4 (a[0],
// a[2]) and + 8 (a[1], a[3]), columns t % 4 (a[0], a[1]) and t % 4 + 4
// (a[2], a[3]).
template <int N>
struct WgmmaTf32;

template <>
struct WgmmaTf32<32> {
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(accumulate));
  }
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  }
};

template <>
struct WgmmaTf32<64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate));
  }
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  }
};

template <>
struct WgmmaTf32<96> {
  static __device__ __forceinline__ void rs(float (&d)[48], const uint32_t (&a)[4], uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  }
};

template <>
struct WgmmaTf32<128> {
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  }
};


// ------------------------------------------------------ attention softmax
// Shared by the wgmma attention forwards (flash_p5_fwd.cu, flash_fwd.cu;
// split_p, round_p and p_frags also by the backwards). A 64 x 64 tile of
// scores S lies in a consumer thread's s[32] as the m64n64 accumulator (a
// 64 x 128 tile of flash_fwd.cu's 128-key tiles in s[64], a 64 x 32 tile
// of the 3xTF32 forward in s[16]): rows r0 and r0 + 8 (s[i] with
// (i >> 1) & 1 = 0 or 1), keys 8 * c + 2 * (t % 4) + i % 2 for c = i / 4.
// The softmax's instruction count, not the tensor cores, sets a tile's
// pace, hence the choices below.

// 2^x on the special-function unit, subnormal results flushed to zero (P
// below 2^-126 adds nothing to sums of order one). exp2f() without fast
// math wraps the same instruction in range fix-ups that cost three more
// instructions an element.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of the tile of keys k0 .. k0 + 2R - 1 in s: masks keys
// at or past `seq` (only a last, ragged tile holds any), updates the running
// max m (log2 domain, scaled) and this thread's share of the sum l, leaves
// P = exp2(s * scale_log2 - m) in s (one FFMA and one exp2 an element: the
// max is taken on the raw scores, so scale_log2 must be > 0) and returns
// the factors that rescale the rows' accumulators. Every tile holds a valid
// key, so m stays finite after the first tile.
template <int R>
__device__ __forceinline__ float2 softmax_tile(float (&s)[R], float (&m)[2], float (&l)[2],
                                               int k0, int seq, int pair,
                                               float scale_log2) {
  if (k0 + 2 * R > seq) {
#pragma unroll
    for (int c = 0; c < R / 4; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (k0 + 8 * c + 2 * pair + (e & 1) >= seq) s[4 * c + e] = -INFINITY;
      }
    }
  }
  float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < R; ++i) tile_max[(i >> 1) & 1] = fmaxf(tile_max[(i >> 1) & 1], s[i]);
  float alpha[2], neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
    tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
    const float m_new = fmaxf(m[r], tile_max[r] * scale_log2);
    alpha[r] = exp2_approx(m[r] - m_new);  // 0 on the first tile
    m[r] = m_new;
    neg_m[r] = -m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    s[i] = exp2_approx(fmaf(s[i], scale_log2, neg_m[(i >> 1) & 1]));  // 0 if masked
    l[(i >> 1) & 1] += s[i];
  }
  return make_float2(alpha[0], alpha[1]);
}

// P in s -> the A fragments of the P.V product, 16 keys a step, as two
// bf16 terms: hi is P cut to its bf16 bits (a mask and a byte permute, no
// conversion), lo = bf16(P - hi), so hi + lo keeps about 16 significant
// bits of P. The p5 kernels (flash_p5_fwd.cu, flash_p5_bwd.cu) and the
// 80-wide general backward run each such product on both terms.
__device__ __forceinline__ void split_p(const float (&s)[32], uint32_t (&hi)[4][4],
                                        uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int idx = 4 * (2 * kk + (f >> 1)) + 2 * (f & 1);
      const uint32_t h0 = __float_as_uint(s[idx]) & 0xffff0000u;
      const uint32_t h1 = __float_as_uint(s[idx + 1]) & 0xffff0000u;
      hi[kk][f] = __byte_perm(h0, h1, 0x7632);
      const __nv_bfloat162 l2 =
          __floats2bfloat162_rn(s[idx] - __uint_as_float(h0), s[idx + 1] - __uint_as_float(h1));
      lo[kk][f] = *reinterpret_cast<const uint32_t*>(&l2);
    }
  }
}

// P in s (a tile of 2R keys) -> the same fragments as one bf16 term, P
// rounded to nearest once (as FlashAttention rounds P and dS before their
// products): 8 significant bits, half the tensor-core work of hi + lo.
template <int R>
__device__ __forceinline__ void round_p(const float (&s)[R], uint32_t (&p)[R / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < R / 8; ++kk) {
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int idx = 4 * (2 * kk + (f >> 1)) + 2 * (f & 1);
      const __nv_bfloat162 p2 = __floats2bfloat162_rn(s[idx], s[idx + 1]);
      p[kk][f] = *reinterpret_cast<const uint32_t*>(&p2);
    }
  }
}

// The bf16 A fragments of P^T or dS (dS^T) in s for the general backward
// pair (flash_bwd.cu): TERMS = 1 one term (round_p), TERMS = 2 hi + lo
// (split_p), in p[0] and p[1]; a product takes each 16-column step once a
// term, hi before lo. The pair takes one (flash_bwd.cu:kBwdTerms).
template <int TERMS>
__device__ __forceinline__ void p_frags(const float (&s)[32], uint32_t (&p)[TERMS][4][4]) {
  static_assert(TERMS == 1 || TERMS == 2, "one or two bf16 terms");
  if constexpr (TERMS == 1) {
    round_p(s, p[0]);
  } else {
    split_p(s, p[0], p[1]);
  }
}

// x rounded to TF32 (to nearest, ties away from zero, as cvt.rna.tf32.f32
// rounds): its low 13 mantissa bits zero, so the tensor core reads it as it
// is.
__device__ __forceinline__ float tf32_hi(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// The rest of x in TF32: x - tf32_hi(x) is exact in f32 (the two lie within
// a factor of two), rounded in turn. x = hi + lo to about 2^-22 of x, and
// hi.hi + hi.lo + lo.hi misses a product by about 2^-22 of it (the lo.lo
// term), where one TF32 pass misses it by up to 2^-11.
__device__ __forceinline__ float tf32_lo(float x) { return tf32_hi(x - tf32_hi(x)); }

// P in s (a tile of 2R keys) -> the TF32 A fragments of the 3xTF32 P.V
// product, 8 keys a step: step kk takes keys 8 * kk + 2 * (t % 4) (fragment
// column t % 4) and + 1 (column t % 4 + 4), the accumulator's own two
// columns, so no value moves between threads; the B operand (V^T) holds each
// 8-key group in the matching order 0, 2, 4, 6, 1, 3, 5, 7. hi =
// tf32_hi(P), lo = tf32_lo(P).
template <int R>
__device__ __forceinline__ void split_p_tf32(const float (&s)[R], uint32_t (&hi)[R / 4][4],
                                             uint32_t (&lo)[R / 4][4]) {
#pragma unroll
  for (int kk = 0; kk < R / 4; ++kk) {
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const float x = s[4 * kk + 2 * (f & 1) + (f >> 1)];
      hi[kk][f] = __float_as_uint(tf32_hi(x));
      lo[kk][f] = __float_as_uint(tf32_lo(x));
    }
  }
}

// Keeps the compiler from touching P's fragments while a P.V product that
// reads them is in flight.
template <int K>
__device__ __forceinline__ void fence_p(uint32_t (&hi)[K][4], uint32_t (&lo)[K][4]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    fence_regs(hi[kk]);
    fence_regs(lo[kk]);
  }
}

template <int K>
__device__ __forceinline__ void fence_p(uint32_t (&p)[K][4]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk) fence_regs(p[kk]);
}

template <int TERMS, int K>
__device__ __forceinline__ void fence_p(uint32_t (&p)[TERMS][K][4]) {
#pragma unroll
  for (int t = 0; t < TERMS; ++t) fence_p(p[t]);
}

// ------------------------------------------------- 3xTF32 attention forward
// Shared by the 3xTF32 forwards of flash_fwd.cu ([B, T, H, D] views) and
// flash_p5_fwd.cu (the d-major f5). Each runs a producer warpgroup (one
// thread loads, three warps split each K/V tile into TF32 hi and lo halves)
// beside two consumer warpgroups.

// Registers a thread of the producer warpgroup and of a consumer warpgroup
// keep after setmaxnreg with two consumer warpgroups: the 168 a thread that
// 384 threads get at launch, moved from the producer (which holds addresses
// and one 16-byte vector) to the consumers (O, S and P's two fragments);
// 56 + 2 * 224 = 3 * 168.
constexpr int kTf32SplitRegs = 56;
constexpr int kTf32MmaRegs = 224;

// A consumer warpgroup's walk over the key tiles of one work item: tile j
// lies in ring stage it % NS (complete when `full` is) and was split into
// buffer it & 1 (when `split_full` is); o (zeroed by the caller), m and l
// are the accumulator, running max and this thread's sum, s, p_hi and p_lo
// S's and P's fragments. P_{j-1} V_{j-1} is issued first and waited for,
// so the last tile's split buffer is free early and the next tile's split
// overlaps S_j and its softmax (P's fragments are dead before S_j's
// accumulator lives). issue_s(stage, db) issues S_j = q k^T and
// issue_pv(stage, db) O += P V for the tile in (stage, db); fence_q()
// keeps q's register fragments until S_j is in. K_IN_STAGE: K's hi half
// lies in the stage (flash_fwd.cu), whose consumers' last read is then S,
// and q (`q_empty`) is released at the item's last S; otherwise V's does
// (flash_p5_fwd.cu), the stage is released after P V and q by the caller.
template <bool K_IN_STAGE, int NS, int DP, int KT, typename IssueS, typename IssuePv,
          typename FenceQ>
__device__ __forceinline__ void tf32x3_walk(
    float (&o)[DP / 2], float (&s)[KT / 2], uint32_t (&p_hi)[KT / 8][4],
    uint32_t (&p_lo)[KT / 8][4], float (&m)[2], float (&l)[2], int& it, int n_tiles,
    int seq, int pair, float scale_log2, uint64_t* full, uint64_t* empty,
    uint64_t* split_full, uint64_t* split_empty, uint64_t* q_empty, IssueS issue_s,
    IssuePv issue_pv, FenceQ fence_q) {
  for (int j = 0; j < n_tiles; ++j, ++it) {
    const int stage = it % NS;
    const int db = it & 1;
    mbar_wait(&full[stage], (it / NS) & 1);
    mbar_wait(&split_full[db], (it >> 1) & 1);
    wgmma_fence();
    if (j > 0) {
      issue_pv((it - 1) % NS, db ^ 1);
      wgmma_commit();
      wgmma_wait<0>();  // P_{j-1} v_{j-1} is in
      fence_regs(o);
      fence_p(p_hi, p_lo);
      mbar_arrive(&split_empty[db ^ 1]);
      if constexpr (!K_IN_STAGE) mbar_arrive(&empty[(it - 1) % NS]);  // V's last read
    }
    issue_s(stage, db);
    wgmma_commit();
    wgmma_wait<0>();  // S_j is in
    fence_regs(s);
    fence_q();
    if constexpr (K_IN_STAGE) {
      mbar_arrive(&empty[stage]);                      // K's last read
      if (j == n_tiles - 1) mbar_arrive(q_empty);      // q's last use
    }
    const float2 alpha = softmax_tile(s, m, l, j * KT, seq, pair, scale_log2);
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] *= ((i >> 1) & 1) ? alpha.y : alpha.x;
    split_p_tf32(s, p_hi, p_lo);
  }
  const int last = it - 1;
  wgmma_fence();
  issue_pv(last % NS, last & 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
  fence_p(p_hi, p_lo);
  mbar_arrive(&split_empty[last & 1]);
  if constexpr (!K_IN_STAGE) mbar_arrive(&empty[last % NS]);
}

// ------------------------------------------------ 3xTF32 attention backward
// Shared by the 3xTF32 backward pairs of flash_bwd.cu ([B, T, H, D] views,
// also the fused attention's packed row) and flash_p5_bwd.cu (the d-major
// f5). A pair is a dQ kernel, which also forms each query's delta =
// rowsum(dout * out) and writes it with lse in the log2 domain to a scratch
// (B*H rows of Tq rounded up to a work item), then a dK/dV kernel that reads
// them back. Both stream 32-row tiles (keys for dQ, queries for dK/dV) past
// a 128-row work item of one (b, h), 64 rows a consumer warpgroup, beside a
// producer warpgroup: one thread issues the loads, three splitter warps
// split each tile into its TF32 hi half (in place) and lo half and the two
// halves of its transpose, into one of two buffers. Every product is three
// TF32 passes (lo.hi + hi.lo + hi.hi, the small terms first).
//
// What differs between the pairs is the tiles' layout, a struct L the kernel
// builds from its arguments:
//   kDp                the head dim padded to a multiple of 32;
//   kProductsReadStage whether dQ += dS k, dV += P^T dout and dK += dS^T q
//                      read the stage's hi half as it lies (the stage is
//                      then released after them) or a split buffer (the
//                      stage is released once S and dP are in);
//   col(i, pair)       the key (dQ) or query (dK/dV) of element i of this
//                      thread's score accumulator, from the tile's first;
//   frag(tile, row0, kk, quad, pair, hi, lo)   the TF32 A fragments of
//                      head-dim step kk of an item tile (q or dout, k or v)
//                      for rows row0 + quad (+ 8), split;
//   prefetch(), load_dq_item / load_dq_tile, load_dkv_item / load_dkv_tile
//                      the TMA loads (the bytes are expected here);
//   split_dq / split_dkv  a splitter thread's share of one tile's split;
//   s_b, dp_b, dq_b / st_b, dpt_b, dv_b, dk_b   the K-major B operand
//                      (hi and lo halves) of each product for the tile in
//                      (stage, split buffer);
//   delta_part(sm, row, t, b, h, pair)   this thread's share of the delta
//                      of item row `row` (query t < Tq);
//   store_dq / store_dk / store_dv   a warpgroup's accumulator (times a
//                      factor) into the gradient, rows below T only.
// The smem structs hold the item tiles as q and dout (dQ) or k and v
// (dK/dV), the dK/dV kernel's lse2 and delta of each stage, and the
// barriers last.

constexpr int kTfBwdRows = 32;                         // rows of a streamed tile
constexpr int kTfBwdWgRows = 64;                       // rows of a consumer warpgroup
constexpr int kTfBwdItemRows = 2 * kTfBwdWgRows;       // rows of a work item
constexpr int kTfBwdConsumers = 2 * 128;               // two consumer warpgroups
constexpr int kTfBwdSplitters = 96;                    // warps 1-3 of the producer warpgroup
constexpr int kTfBwdThreads = kTfBwdConsumers + 128;   // and the producer warpgroup

// A block's mbarriers: the work item's tiles (q and dout, or k and v), NS
// stages of streamed tiles, and two split buffers.
template <int NS>
struct TfBwdBarriers {
  uint64_t item_full;
  uint64_t item_empty;
  uint64_t full[NS];
  uint64_t empty[NS];
  uint64_t split_full[2];
  uint64_t split_empty[2];
};

// A K-major TF32 B operand's two halves in shared memory: 32-float slabs of
// `rows` rows each (128-byte rows, 128-byte swizzled).
struct TfHalves {
  const float* hi;
  const float* lo;
};

// The descriptor of head-dim (or key) step kk of one half: 8 columns of
// slab kk / 4, 32 bytes a step along its rows.
__device__ __forceinline__ uint64_t tf32_step_desc(const float* half, int rows, int kk) {
  return desc_k_major<128>(reinterpret_cast<const uint8_t*>(half + (kk / 4) * rows * 32) +
                           32 * (kk % 4));
}

// The descriptors of step kk of both halves of B operand b.
struct TfStep {
  uint64_t hi, lo;
};

__device__ __forceinline__ TfStep tf32_step(const TfHalves& b, int rows, int kk) {
  return {tf32_step_desc(b.hi, rows, kk), tf32_step_desc(b.lo, rows, kk)};
}

// The three passes of acc (+)= a b for one step of B operand b.
template <int N>
__device__ __forceinline__ void tf32x3_step(float (&acc)[N / 2], const uint32_t (&a_hi)[4],
                                            const uint32_t (&a_lo)[4], const TfStep& b,
                                            int accumulate) {
  WgmmaTf32<N>::rs(acc, a_lo, b.hi, accumulate);
  WgmmaTf32<N>::rs(acc, a_hi, b.lo, 1);
  WgmmaTf32<N>::rs(acc, a_hi, b.hi, 1);
}

template <int NS>
__device__ __forceinline__ void tf32x3_bwd_init(TfBwdBarriers<NS>& bar) {
  if (threadIdx.x == 0) {
    mbar_init(&bar.item_full, 1);
    mbar_init(&bar.item_empty, kTfBwdConsumers);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      mbar_init(&bar.full[s], 1);
      mbar_init(&bar.empty[s], kTfBwdConsumers);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mbar_init(&bar.split_full[i], kTfBwdSplitters);
      mbar_init(&bar.split_empty[i], kTfBwdConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();
}

// The producer warpgroup (thread pt of it), its registers already given up:
// thread 0 loads each work item's tiles once the consumers are done with the
// last item's, and streams the item's n_tiles tiles through NS stages; warps
// 1-3 split each landed tile into one of two buffers. load_item(full, r0, h,
// b), load_tile(stage, full, j, h, b, bh) (bh = b * heads + h) and
// split(stage, db, st) are the layout's.
template <int NS, typename LoadItem, typename LoadTile, typename Split>
__device__ __forceinline__ void tf32x3_bwd_produce(TfBwdBarriers<NS>& bar, int pt, int items,
                                                   int item_tiles, int heads, int n_tiles,
                                                   uint32_t item_bytes, uint32_t tile_bytes,
                                                   LoadItem load_item, LoadTile load_tile,
                                                   Split split) {
  if (pt == 0) {
    int it = 0;
    int n = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
      const int r0 = (item % item_tiles) * kTfBwdItemRows;
      const int bh = item / item_tiles;
      const int h = bh % heads;
      const int b = bh / heads;
      if (n >= 1) mbar_wait(&bar.item_empty, (n - 1) & 1);
      mbar_arrive_expect_tx(&bar.item_full, item_bytes);
      load_item(&bar.item_full, r0, h, b);
      for (int j = 0; j < n_tiles; ++j, ++it) {
        const int stage = it % NS;
        if (it >= NS) mbar_wait(&bar.empty[stage], (it / NS - 1) & 1);
        mbar_arrive_expect_tx(&bar.full[stage], tile_bytes);
        load_tile(stage, &bar.full[stage], j, h, b, bh);
      }
    }
  } else if (pt >= 32) {
    const int st = pt - 32;
    const int tiles = (items - static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) - 1) /
                      static_cast<int>(gridDim.x) * n_tiles;
    for (int it = 0; it < tiles; ++it) {
      const int stage = it % NS;
      const int db = it & 1;
      mbar_wait(&bar.full[stage], (it / NS) & 1);
      if (it >= 2) mbar_wait(&bar.split_empty[db], ((it >> 1) - 1) & 1);
      split(stage, db, st);
      fence_proxy_async();  // the writes, before the consumers' wgmma reads
      mbar_arrive(&bar.split_full[db]);
    }
  }
}

// A consumer warpgroup none of whose rows lies inside the work item: it only
// keeps the barriers' accounting, each arrival after its phase has begun.
template <int NS>
__device__ __forceinline__ void tf32x3_bwd_idle(TfBwdBarriers<NS>& bar, int& it, int n_tiles) {
  mbar_arrive(&bar.item_empty);
  for (int j = 0; j < n_tiles; ++j, ++it) {
    mbar_wait(&bar.full[it % NS], (it / NS) & 1);
    mbar_arrive(&bar.empty[it % NS]);
    mbar_wait(&bar.split_full[it & 1], (it >> 1) & 1);
    mbar_arrive(&bar.split_empty[it & 1]);
  }
}

template <class Smem>
__device__ __forceinline__ Smem& tf32x3_bwd_smem(uint8_t* raw) {
  return *reinterpret_cast<Smem*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                  ~static_cast<uintptr_t>(1023));
}

// The dQ kernel's body. Work items are 128 queries. Each warpgroup first
// forms its rows' delta (the layout's read of dout in shared memory and of
// out) and writes it, with lse in the log2 domain, to the scratch. Per
// 32-key tile: S = q k^T and dP = dout v^T with q's and dout's fragments as
// A from registers (8 head-dim columns a step, two steps in flight); dS =
// P (dP - delta), P = exp2(S * scale * log2(e) - lse2), 0 past Tk, is split
// into fragments and dQ += dS k issued; tile j - 1's dS k runs while tile
// j's S and dP are issued. dQ is scaled once at the end and stored from
// registers.
template <int NS, class Smem, class L>
__device__ __forceinline__ void tf32x3_bwd_dq(const L& lay, uint8_t* smem_raw,
                                              const float* __restrict__ lse,
                                              float* __restrict__ lse2_out,
                                              float* __restrict__ delta_out, int batch, int tq,
                                              int tk, int heads, float scale) {
  static_assert(NS >= 2, "two stages at least");
  constexpr int DP = L::kDp;
  Smem& sm = tf32x3_bwd_smem<Smem>(smem_raw);
  auto& bar = sm.bar;
  const int tid = threadIdx.x;
  const int n_tiles = (tk + kTfBwdRows - 1) / kTfBwdRows;
  const int q_tiles = (tq + kTfBwdItemRows - 1) / kTfBwdItemRows;
  const int items = batch * heads * q_tiles;
  const long long tq_pad = (long long)q_tiles * kTfBwdItemRows;
  tf32x3_bwd_init(bar);

  if (tid >= kTfBwdConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kTf32SplitRegs));
    const int pt = tid - kTfBwdConsumers;
    if (pt == 0) lay.prefetch();
    tf32x3_bwd_produce<NS>(
        bar, pt, items, q_tiles, heads, n_tiles, 2 * kTfBwdItemRows * DP * 4,
        2 * kTfBwdRows * DP * 4,
        [&](uint64_t* full, int q0, int h, int b) { lay.load_dq_item(sm, full, q0, h, b); },
        [&](int stage, uint64_t* full, int j, int h, int b, int) {
          lay.load_dq_tile(sm, stage, full, j, h, b);
        },
        [&](int stage, int db, int st) { lay.split_dq(sm, stage, db, st); });
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kTf32MmaRegs));
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int quad = lane / 4;
  const int pair = lane % 4;
  const int row0 = kTfBwdWgRows * wg + 16 * warp;  // this warp's first row of the item
  const float scale_log2 = scale * vaw_flash::kLog2e;

  float dq[DP / 2];
  float s[16], dp[16];                          // S and dP of one 32-key tile
  uint32_t ds_hi[4][4], ds_lo[4][4];            // dS of the tile, 8 keys a step
  uint32_t qa_hi[2][4], qa_lo[2][4], da_hi[2][4], da_lo[2][4];  // q's, dout's fragments

  // S_j and dP_j (issued and waited for): 8 head-dim columns a step, the
  // step's q and dout fragments loaded while the step before is in flight.
  auto s_dp = [&](int stage, int db) {
    const TfHalves kb = lay.s_b(sm, stage, db);
    const TfHalves vb = lay.dp_b(sm, stage, db);
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
      const int buf = kk & 1;
      if (kk >= 2) {
        wgmma_wait<1>();  // step kk - 2, which read this buffer, is in
        fence_regs(qa_hi[buf]);
        fence_regs(qa_lo[buf]);
        fence_regs(da_hi[buf]);
        fence_regs(da_lo[buf]);
      }
      L::frag(sm.q, row0, kk, quad, pair, qa_hi[buf], qa_lo[buf]);
      L::frag(sm.dout, row0, kk, quad, pair, da_hi[buf], da_lo[buf]);
      const TfStep ks = tf32_step(kb, kTfBwdRows, kk);
      const TfStep vs = tf32_step(vb, kTfBwdRows, kk);
      wgmma_fence();
      tf32x3_step<32>(s, qa_hi[buf], qa_lo[buf], ks, kk > 0);
      tf32x3_step<32>(dp, da_hi[buf], da_lo[buf], vs, kk > 0);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
#pragma unroll
    for (int buf = 0; buf < 2; ++buf) {
      fence_regs(qa_hi[buf]);
      fence_regs(qa_lo[buf]);
      fence_regs(da_hi[buf]);
      fence_regs(da_lo[buf]);
    }
  };
  // dQ += dS k for the tile in (stage, db) (issued, not waited for), 8 keys
  // a step.
  auto issue_dq = [&](int stage, int db) {
    const TfHalves kb = lay.dq_b(sm, stage, db);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      tf32x3_step<DP>(dq, ds_hi[kk], ds_lo[kk], tf32_step(kb, DP, kk), 1);
    }
    wgmma_commit();
  };

  int it = 0;
  int n = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    const int q0 = (item % q_tiles) * kTfBwdItemRows;
    const int bh = item / q_tiles;
    const int h = bh % heads;
    const int b = bh / heads;
    mbar_wait(&bar.item_full, n & 1);

    // lse (log2 domain) of this thread's rows and their delta; the four
    // threads of a row each take a quarter of the head dim.
    float lse2[2], delta[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + quad + 8 * r;
      const int t = q0 + row;
      lse2[r] = t < tq ? lse[(long long)bh * tq + t] * vaw_flash::kLog2e : INFINITY;
      float d = t < tq ? lay.delta_part(sm, row, t, b, h, pair) : 0.f;
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      delta[r] = d;
      if (pair == 0) {
        lse2_out[bh * tq_pad + q0 + row] = lse2[r];
        delta_out[bh * tq_pad + q0 + row] = d;
      }
    }
    if (q0 + kTfBwdWgRows * wg >= tq) {
      tf32x3_bwd_idle(bar, it, n_tiles);
      continue;
    }
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;

    for (int j = 0; j < n_tiles; ++j, ++it) {
      const int stage = it % NS;
      const int db = it & 1;
      mbar_wait(&bar.full[stage], (it / NS) & 1);
      mbar_wait(&bar.split_full[db], (it >> 1) & 1);
      s_dp(stage, db);
      // dS_{j-1} k_{j-1} is in too: its split buffer (and its stage, where
      // the product read it) is free.
      if (j > 0) {
        fence_regs(dq);
        fence_p(ds_hi, ds_lo);
        mbar_arrive(&bar.split_empty[db ^ 1]);
        if constexpr (L::kProductsReadStage) mbar_arrive(&bar.empty[(it - 1) % NS]);
      }
      if constexpr (!L::kProductsReadStage) mbar_arrive(&bar.empty[stage]);
      if (j == n_tiles - 1) mbar_arrive(&bar.item_empty);  // q's and dout's last use
      const int k0 = j * kTfBwdRows;
      const bool ragged = k0 + kTfBwdRows > tk;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int r = (i >> 1) & 1;
        float p = exp2_approx(fmaf(s[i], scale_log2, -lse2[r]));
        if (ragged && k0 + L::col(i, pair) >= tk) p = 0.f;
        s[i] = p * (dp[i] - delta[r]);
      }
      split_p_tf32<16>(s, ds_hi, ds_lo);
      issue_dq(stage, db);
    }
    wgmma_wait<0>();
    fence_regs(dq);
    fence_p(ds_hi, ds_lo);
    mbar_arrive(&bar.split_empty[(it - 1) & 1]);
    if constexpr (L::kProductsReadStage) mbar_arrive(&bar.empty[(it - 1) % NS]);
    lay.store_dq(dq, b, h, q0 + row0, quad, pair, scale);
  }
}

// The dK/dV kernel's body, after the dQ kernel. Work items are 128 keys.
// Per 32-query tile (q, dout and their rows' lse2 and delta from the dQ
// kernel's scratch): S^T = k q^T and dP^T = v dout^T with k's and v's
// fragments as A from registers (two steps in flight); then P^T and dS^T
// are split into fragments and dV += P^T dout and dK += dS^T q issued. A
// warpgroup waits for its dV and dK products before the next tile (its P and
// dS fragments and both accumulators would not fit beside the next tile's
// S^T and dP^T); the other warpgroup's products run meanwhile. dK is scaled
// once at the end; both are stored from registers. Keys past Tk compute
// values that are never stored.
template <int NS, class Smem, class L>
__device__ __forceinline__ void tf32x3_bwd_dkdv(const L& lay, uint8_t* smem_raw,
                                                const float* __restrict__ lse2_in,
                                                const float* __restrict__ delta_in, int batch,
                                                int tq, int tk, int heads, float scale) {
  static_assert(NS >= 2, "two stages at least");
  constexpr int DP = L::kDp;
  constexpr uint32_t kRowBytes = kTfBwdRows * 4;  // lse2 or delta of a tile
  Smem& sm = tf32x3_bwd_smem<Smem>(smem_raw);
  auto& bar = sm.bar;
  const int tid = threadIdx.x;
  const int n_tiles = (tq + kTfBwdRows - 1) / kTfBwdRows;
  const int k_tiles = (tk + kTfBwdItemRows - 1) / kTfBwdItemRows;
  const int items = batch * heads * k_tiles;
  const long long tq_pad = (tq + kTfBwdItemRows - 1) / kTfBwdItemRows * (long long)kTfBwdItemRows;
  tf32x3_bwd_init(bar);

  if (tid >= kTfBwdConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kTf32SplitRegs));
    const int pt = tid - kTfBwdConsumers;
    if (pt == 0) lay.prefetch();
    tf32x3_bwd_produce<NS>(
        bar, pt, items, k_tiles, heads, n_tiles, 2 * kTfBwdItemRows * DP * 4,
        2 * kTfBwdRows * DP * 4 + 2 * kRowBytes,
        [&](uint64_t* full, int k0, int h, int b) { lay.load_dkv_item(sm, full, k0, h, b); },
        [&](int stage, uint64_t* full, int j, int h, int b, int bh) {
          lay.load_dkv_tile(sm, stage, full, j, h, b);
          bulk_load(&sm.lse2[stage][0], lse2_in + bh * tq_pad + j * kTfBwdRows, kRowBytes,
                    full);
          bulk_load(&sm.delta[stage][0], delta_in + bh * tq_pad + j * kTfBwdRows, kRowBytes,
                    full);
        },
        [&](int stage, int db, int st) { lay.split_dkv(sm, stage, db, st); });
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kTf32MmaRegs));
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int quad = lane / 4;
  const int pair = lane % 4;
  const int row0 = kTfBwdWgRows * wg + 16 * warp;
  const float scale_log2 = scale * vaw_flash::kLog2e;

  float dk[DP / 2], dv[DP / 2];
  float st[16], dpt[16];                        // S^T and dP^T of one 32-query tile
  uint32_t p_hi[4][4], p_lo[4][4], s_hi[4][4], s_lo[4][4];  // P^T, dS^T, 8 queries a step
  uint32_t ka_hi[2][4], ka_lo[2][4], va_hi[2][4], va_lo[2][4];  // k's, v's fragments

  int it = 0;
  int n = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    const int k0 = (item % k_tiles) * kTfBwdItemRows;
    const int bh = item / k_tiles;
    const int h = bh % heads;
    const int b = bh / heads;
    mbar_wait(&bar.item_full, n & 1);
    if (k0 + kTfBwdWgRows * wg >= tk) {
      tf32x3_bwd_idle(bar, it, n_tiles);
      continue;
    }
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;

    for (int j = 0; j < n_tiles; ++j, ++it) {
      const int stage = it % NS;
      const int db = it & 1;
      mbar_wait(&bar.full[stage], (it / NS) & 1);
      mbar_wait(&bar.split_full[db], (it >> 1) & 1);
      // S^T and dP^T: 8 head-dim columns a step, two steps in flight.
      const TfHalves qb = lay.st_b(sm, stage, db);
      const TfHalves ob = lay.dpt_b(sm, stage, db);
#pragma unroll
      for (int kk = 0; kk < DP / 8; ++kk) {
        const int buf = kk & 1;
        if (kk >= 2) {
          wgmma_wait<1>();
          fence_regs(ka_hi[buf]);
          fence_regs(ka_lo[buf]);
          fence_regs(va_hi[buf]);
          fence_regs(va_lo[buf]);
        }
        L::frag(sm.k, row0, kk, quad, pair, ka_hi[buf], ka_lo[buf]);
        L::frag(sm.v, row0, kk, quad, pair, va_hi[buf], va_lo[buf]);
        const TfStep qs = tf32_step(qb, kTfBwdRows, kk);
        const TfStep os = tf32_step(ob, kTfBwdRows, kk);
        wgmma_fence();
        tf32x3_step<32>(st, ka_hi[buf], ka_lo[buf], qs, kk > 0);
        tf32x3_step<32>(dpt, va_hi[buf], va_lo[buf], os, kk > 0);
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
#pragma unroll
      for (int buf = 0; buf < 2; ++buf) {
        fence_regs(ka_hi[buf]);
        fence_regs(ka_lo[buf]);
        fence_regs(va_hi[buf]);
        fence_regs(va_lo[buf]);
      }
      if (j == n_tiles - 1) mbar_arrive(&bar.item_empty);  // k's and v's last use
      // P^T into st and dS^T into dpt.
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int col = L::col(i, pair);
        const float p = exp2_approx(fmaf(st[i], scale_log2, -sm.lse2[stage][col]));
        st[i] = p;
        dpt[i] = p * (dpt[i] - sm.delta[stage][col]);
      }
      // q's and dout's hi halves (where the products do not read them),
      // lse2 and delta read.
      if constexpr (!L::kProductsReadStage) mbar_arrive(&bar.empty[stage]);
      split_p_tf32<16>(st, p_hi, p_lo);
      split_p_tf32<16>(dpt, s_hi, s_lo);
      const TfHalves vb = lay.dv_b(sm, stage, db);
      const TfHalves kb = lay.dk_b(sm, stage, db);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        tf32x3_step<DP>(dv, p_hi[kk], p_lo[kk], tf32_step(vb, DP, kk), 1);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        tf32x3_step<DP>(dk, s_hi[kk], s_lo[kk], tf32_step(kb, DP, kk), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
      fence_p(p_hi, p_lo);
      fence_p(s_hi, s_lo);
      mbar_arrive(&bar.split_empty[db]);
      if constexpr (L::kProductsReadStage) mbar_arrive(&bar.empty[stage]);
    }
    lay.store_dk(dk, b, h, k0 + row0, quad, pair, scale);
    lay.store_dv(dv, b, h, k0 + row0, quad, pair, 1.f);
  }
}

// ------------------------------------------------------------------- host

using TensorMapEncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled from the driver the runtime has loaded; null if
// the driver has none.
inline TensorMapEncodeTiled tensor_map_encoder() {
  static TensorMapEncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                                    cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<TensorMapEncodeTiled>(ptr)
               : nullptr;
  }();
  return fn;
}

// A tensor map of `rank` dimensions (innermost first; strides in bytes of
// dimensions 1..rank-1) with a swizzled box: bf16 and 128 bytes wide by
// default, the box's inner side 64 elements (32 with
// CU_TENSOR_MAP_SWIZZLE_64B, or in f32; 16 with CU_TENSOR_MAP_SWIZZLE_32B).
// Returns false if cuTensorMapEncodeTiled refuses it (a stride or the base
// not a multiple of 16 bytes, a box side over 256).
// cuTensorMapEncodeTiled encodes a tensor map only in a thread with a
// current context. A thread that has made no CUDA call yet has none
// (autograd's worker thread, when an attention backward is the first work
// of a graph: PyTorch makes no context current there for device 0 until it
// launches something), so each thread first makes the runtime's device
// context current.
inline bool make_tensor_map(CUtensorMap* map, const void* base, int rank,
                            const uint64_t* dims, const uint64_t* strides,
                            const uint32_t* box,
                            CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B,
                            CUtensorMapDataType dtype = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  static thread_local const bool context = cudaFree(nullptr) == cudaSuccess;
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (!context || encode == nullptr) return false;
  uint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUresult res = encode(
      map, dtype, static_cast<cuuint32_t>(rank),
      const_cast<void*>(base), reinterpret_cast<const cuuint64_t*>(dims),
      reinterpret_cast<const cuuint64_t*>(strides),
      reinterpret_cast<const cuuint32_t*>(box), ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS;
}

// The tensor maps of one bf16 [B, T, H, D] view of the general-T attention
// kernels (flash_fwd.cu, flash_bwd.cu) as [D, H, T, B], innermost first:
// `strides` holds the view's byte strides of H, T and B, or is null for a
// contiguous view; a box is 64 rows of one slab of AttnGeo<DP>, one map for
// each slab width. Columns past D lie outside the view: TMA fills them with
// zeros (never another head's columns) and stores none of them. Returns
// false if cuTensorMapEncodeTiled refuses one.
template <int DP>
inline bool make_view_maps(ViewMaps<DP>* maps, const void* base, int batch, int seq,
                           int heads, int dim, const long long* strides) {
  using G = AttnGeo<DP>;
  const uint64_t dims[4] = {static_cast<uint64_t>(dim), static_cast<uint64_t>(heads),
                            static_cast<uint64_t>(seq), static_cast<uint64_t>(batch)};
  const uint64_t row = 2ull * dim;
  const uint64_t st[3] = {
      strides ? static_cast<uint64_t>(strides[0]) : row,
      strides ? static_cast<uint64_t>(strides[1]) : row * heads,
      strides ? static_cast<uint64_t>(strides[2]) : row * heads * seq};
  for (int s = 0; s < G::kSlabs; ++s) {
    if (s > 0 && G::map(s) == G::map(s - 1)) continue;
    const int sw = G::swizzle(s);
    const uint32_t box[4] = {static_cast<uint32_t>(G::width(s)), 1, 64, 1};
    const CUtensorMapSwizzle mode = sw == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                    : sw == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_32B;
    if (!make_tensor_map(&maps->m[G::map(s)], base, 4, dims, st, box, mode)) return false;
  }
  return true;
}

// The tensor map of one f32 [B, T, H, D] view of the 3xTF32 forward
// (flash_fwd.cu) as [D, H, T, B], innermost first: `strides` holds the
// view's byte strides of H, T and B; a box is `rows` tokens of one
// 128-byte slab (32 floats), 128-byte swizzled. Returns false if
// cuTensorMapEncodeTiled refuses it.
inline bool make_view_map_f32(CUtensorMap* map, const void* base, int batch, int seq,
                              int heads, int dim, const long long* strides, int rows) {
  const uint64_t dims[4] = {static_cast<uint64_t>(dim), static_cast<uint64_t>(heads),
                            static_cast<uint64_t>(seq), static_cast<uint64_t>(batch)};
  const uint64_t st[3] = {static_cast<uint64_t>(strides[0]),
                          static_cast<uint64_t>(strides[1]),
                          static_cast<uint64_t>(strides[2])};
  const uint32_t box[4] = {32, 1, static_cast<uint32_t>(rows), 1};
  return make_tensor_map(map, base, 4, dims, st, box, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
}

// Streaming multiprocessors of the current device (for persistent grids).
inline int sm_count() {
  int device = 0, count = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess) {
    return 0;
  }
  return count;
}

}  // namespace vaw_hopper
