// Hopper (sm_90a) building blocks shared by the attention kernels of
// flash_fwd.cu, flash_bwd.cu and flash_decode.cu: mbarriers, TMA loads and
// their tensor maps, 1-D bulk copies, bulk reductions, named barriers, wgmma
// and its shared-memory descriptors, the walk of a CTA that owns a pair of
// tiles, and the constants of the step tables and masks that they read.
// Header-only, in an anonymous namespace: each source that includes it gets
// its own copy, and only what it uses is compiled. The build
// (kernels/_build.py) hashes this header with every source, so an edit here
// rebuilds every library.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kMaskValue = -0.7f * 3.402823466e38f;  // DEFAULT_MASK_VALUE
constexpr int kSegActive = 1;       // schedule.SEG_ACTIVE
constexpr int kSegUniform = 2;      // schedule.SEG_UNIFORM
constexpr int kQPadSegment = -2;    // masks.Q_PAD_SEGMENT
constexpr int kKvPadSegment = -1;   // masks.KV_PAD_SEGMENT
constexpr float kLog2e = 1.4426950408889634f;
// The score a hidden element takes in the exp2 domain. The finite mask
// value's log2(e) multiple overflows f32; a power of two has an exact one,
// so kHidden log2(e) - kHidden log2(e) is 0 and a row that sees no key in a
// tile still gets P = 1 on every column there, as with the mask value.
constexpr float kHidden = -0x1p126f;
// Step flags of a pair CTA's record: tile 0 / 1 of the pair takes the step,
// and needs the element mask.
constexpr int kTake0 = 1, kTake1 = 2, kMask0 = 4, kMask1 = 8;

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// A box of the 4-d tensor map (D, H, S, B) at (d0, h, s0, b) into shared
// memory; completion counts its bytes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap& map, uint64_t* bar, int d0,
                                         int h, int s0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(smem_u32(bar)), "r"(d0), "r"(h), "r"(s0), "r"(b)
      : "memory");
}

// The boxes of one tile of map `full` (and at head_dim 160 its tail map) at
// rows s0 .. of head h, batch row b, into shared memory at dst, BOX bytes
// apart (8192: a 64-row box of 128-byte rows), counted on `bar`: D * 2
// bytes a row in all, the tile's expect_tx. A tail box follows the D / 64
// full boxes; only 64-row tiles have one.
template <int D, uint32_t BOX = 8192>
__device__ __forceinline__ void load_tile(unsigned char* dst, const CUtensorMap& full,
                                          const CUtensorMap& tail, uint64_t* bar, int h, int s0,
                                          int b) {
  for (int box = 0; box < D / 64; ++box) tma_load(dst + box * BOX, full, bar, box * 64, h, s0, b);
  if constexpr (D % 64 != 0) tma_load(dst + (D / 64) * BOX, tail, bar, D / 64 * 64, h, s0, b);
}

// A 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global memory into shared memory; completion counts its bytes on
// `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// dst[0 .. bytes) += the f32 values at shared address src, by the async proxy.
__device__ __forceinline__ void bulk_reduce_add(float* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n" ::"l"(
                   dst),
               "r"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, float a, float b) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(a), "f"(b) : "memory");
}

__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// Generic-proxy stores to shared memory become visible to wgmma and TMA.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the fence (CUTLASS's warpgroup_fence_operand).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// A wgmma shared-memory descriptor of a 128-byte-swizzled operand: rows of
// 128 bytes in atoms of 8 rows (1024 bytes, 1024-aligned). K-major: `addr`
// steps 32 bytes a k-step inside an atom, SBO = 1024 (the next 8 rows).
// MN-major: LBO = the stride of the next 64 MN elements, SBO = 1024 (the
// next 8 k rows).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// The same for a 64-byte-swizzled operand (layout type 2): rows of 64 bytes
// in atoms of 8 rows (512 bytes). K-major: `addr` steps 32 bytes a k-step
// inside a row, SBO = 512 (the next 8 rows). MN-major: LBO = the stride of
// the next 32 MN elements, SBO = 512 (the next 8 k rows). The last 32
// columns of a head_dim-160 tile (make_map's tail box).
__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (static_cast<uint64_t>(2) << 62);
}

// Byte offset of the 16-byte chunk holding column `col` (a multiple of 8)
// of row `row` in a 64-row bf16 tile of D columns, as TMA lands it: D / 64
// boxes of 64 rows x 128 bytes, 128-byte swizzled, 8 KB apart, then at D =
// 160 a tail box of 64 rows x 64 bytes, 64-byte swizzled (chunk c of row r
// at c ^ ((r >> 1) & 3)).
template <int D>
__device__ __forceinline__ uint32_t tile_off(int row, int col) {
  constexpr int kWide = D / 64 * 64;  // columns in 128-byte boxes
  if (D % 64 == 0 || col < kWide)
    return (col >> 6) * 8192 + row * 128 + ((((col & 63) >> 3) ^ (row & 7)) << 4);
  return (D / 64) * 8192 + row * 64 + (((((col - kWide) & 31) >> 3) ^ ((row >> 1) & 3)) << 4);
}

// The K-major descriptor of k-step kk (16 columns) of such a tile: the
// operand B of S = Q K^T (and A, with Q in shared memory).
template <int D>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int kk) {
  if (D % 64 == 0 || kk < D / 64 * 4) return sw128_desc(tile + (kk >> 2) * 8192 + (kk & 3) * 32, 16);
  return sw64_desc(tile + (D / 64) * 8192 + (kk - D / 64 * 4) * 32, 16);
}

// d (64 x 64 f32) (+)= A (64 x 16, shared) * B (16 x 64, shared); TA/TB: MN-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (64 x 32 f32) (+)= A (64 x 16, shared) * B (16 x 32, shared); TA/TB: MN-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (64 x 64 f32) (+)= A (64 x 16 bf16, registers) * B (16 x 64, shared); TB: MN-major.
template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
}

// d (64 x 128 f32) += A (64 x 16 bf16, registers) * B (16 x 128, shared, MN-major).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 32 f32) += A (64 x 16 bf16, registers) * B (16 x 32, shared,
// MN-major, 64-byte swizzled).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x D f32) += A (64 x 64 bf16: four k-steps of register fragments) *
// B (64 x D at shared address b, MN-major, as TMA lands a 64-row tile:
// D / 64 boxes of 64 rows x 128 bytes, 8 KB apart, and at D = 160 a 64-byte
// swizzled tail box of 64 rows x 64 bytes after them); D = 64, 128, 160 or
// 256. P V of the forward, P^T dO and dS^T Q of the KV-stationary backward,
// dS K of the dq kernel. At 256 each k-step is two n128 products, columns
// 0-127 into d[0 .. 63] and 128-255 into d[64 .. 127]; at 160 an n128 and an
// n32 (columns 128-159 into d[64 .. 79]): the accumulator layout of one
// m64nDk16, whose fragment puts column block t at d[4 t .. 4 t + 3].
template <int D>
__device__ __forceinline__ void wgmma_rs_k64(float (&d)[D / 2], const uint32_t (&a)[4][4],
                                             uint32_t b) {
  static_assert(D == 64 || D == 128 || D == 160 || D == 256,
                "wgmma_rs_k64 takes D = 64, 128, 160 or 256");
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (D == 160) {
      wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(d), a[kk], sw128_desc(b + kk * 2048, 8192));
      wgmma_rs_n32(*reinterpret_cast<float(*)[16]>(d + 64), a[kk],
                   sw64_desc(b + 2 * 8192 + kk * 1024, 4096));
    } else if constexpr (D == 256) {
      wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(d), a[kk], sw128_desc(b + kk * 2048, 8192));
      wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(d + 64), a[kk],
                    sw128_desc(b + 2 * 8192 + kk * 2048, 8192));
    } else if constexpr (D == 128) {
      wgmma_rs_n128(d, a[kk], sw128_desc(b + kk * 2048, 8192));
    } else {
      wgmma_rs_n64<1>(d, a[kk], sw128_desc(b + kk * 2048, 8192), 1);
    }
  }
}

// d (64 x 32 f32) += A (64 x 64 bf16: four k-steps of register fragments) *
// B (64 x 32: the tail box of a head_dim-160 tile at shared address b,
// 64 rows x 64 bytes, 64-byte swizzled, MN-major): the n32 half of
// wgmma_rs_k64<160>, for a warpgroup that holds the tail columns alone.
__device__ __forceinline__ void wgmma_rs_k64_tail(float (&d)[16], const uint32_t (&a)[4][4],
                                                  uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs_n32(d, a[kk], sw64_desc(b + kk * 1024, 4096));
}

// The min and max of (lo, hi) over the 32 lanes of a warp.
__device__ __forceinline__ void warp_range(int& lo, int& hi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
}

// The walk of a CTA that owns a pair of tiles (a0 slice, b0 slice of one
// CSR; kernels/schedule.py pair_walk states it in Python): per head g of
// `group`, the ascending union of the two tiles' slices. Kv-major (the
// KV-stationary backward): the owners are kv tiles j0, j0 + 1, the partners
// q tiles, and g runs over the q heads of a kv head. Q-major (the forward):
// the owners are q tiles 2m, 2m + 1 (with kv splits, their owners in one
// split), the partners kv tiles, and group is 1. A step names its partner
// tile and, per owner, the table entry that put it there (-1: not in that
// owner's slice, or with SKIP inactive there); with SKIP a step that
// neither owner needs is never produced. DENSE: every partner tile
// 0 .. n_tiles - 1 of every head, which the caller classifies.
template <bool SKIP, bool DENSE>
struct PairWalk {
  const int* steps;  // the table's entries
  const int* bits;   // SKIP: this batch row's step bits
  int a0, a1, b0, b1, group, n_tiles;
  int g, ia, ib;

  __device__ __forceinline__ bool next(int& g_out, int& tile, int& ea, int& eb) {
    if (DENSE) {
      if (g >= group) return false;
      g_out = g;
      tile = ia;
      ea = eb = -1;
      if (++ia == n_tiles) {
        ia = 0;
        ++g;
      }
      return true;
    }
    constexpr int kNone = 0x7fffffff;
    while (g < group) {
      const int qa = ia < a1 ? steps[ia] >> 1 : kNone;
      const int qb = ib < b1 ? steps[ib] >> 1 : kNone;
      if (qa == kNone && qb == kNone) {
        ++g;
        ia = a0;
        ib = b0;
        continue;
      }
      const int q = min(qa, qb);
      ea = qa == q ? ia++ : -1;
      eb = qb == q ? ib++ : -1;
      if (SKIP) {
        if (ea >= 0 && !(bits[ea] & kSegActive)) ea = -1;
        if (eb >= 0 && !(bits[eb] & kSegActive)) eb = -1;
        if (ea < 0 && eb < 0) continue;
      }
      g_out = g;
      tile = q;
      return true;
    }
    return false;
  }
};

// cuTensorMapEncodeTiled, found through the runtime (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                              &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// The (D, H, S, B) map of a strided bf16 tensor (B, S, H, D) with unit last
// stride: boxes of `cols` columns (64, 128-byte swizzled; or 32, 64-byte
// swizzled: the tail box of D = 160) x `rows` rows of one head, rows past S
// read as zeros. The strides (elements) are multiples of 8 and the base
// 16-byte aligned (the wrappers check both), as TMA needs.
bool make_map(CUtensorMap* map, const void* base, int B, int S, int H, int D, long long sb,
              long long ss, long long sh, int rows, int cols = 64) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2, static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
