// FlashAttention-2 backward for Hopper (sm_90a), bf16 in, f32 gradients.
//
// Four kernels:
//
// fa2_bwd_delta_kernel replaces the Pallas TPU kernel
// src/repro/kernels/flash_bwd.py:80 flash_bwd_delta: delta = rowsum(dO o O)
// (Algorithm 2 line 4). It reads O and dO once and writes 4 bytes a row, so
// on an H100 it is bound by HBM (3.35 TB/s): one CTA per (64-row q tile,
// batch * q head), each thread loads 16 bytes of O and 16 of dO per row
// and 16 threads finish a row with shuffles.
//
// fa2_bwd_fused_kernel replaces src/repro/kernels/flash_bwd.py:718
// flash_bwd_fused (compact body _fused_kernel_compact :672): dK, dV and dQ
// in one pass, with S and P recomputed once per visible tile. Five
// products per tile of 64 q rows x 64 kv rows at head_dim 128, so at
// training lengths it is bound by the tensor cores (989 TFLOP/s bf16), not
// by HBM. The TPU kernel is a sequential kv-major grid that zeroes each dq
// block at its first visit and adds to it on later visits; on Hopper CTAs
// run in parallel and in no order, so delta is the pre-pass above (it
// lives in HBM), dq is an f32 buffer the wrapper zeroes and every CTA adds
// into, and dK and dV are owned by one CTA each. Only the Hopper paths reach
// the tensor cores' rate: wgmma (mma.sync tops out well below it), TMA
// copies that cost the SMs no instructions, and warps that wait on
// mbarriers instead of CTA-wide barriers. The design, FlashAttention-3's
// backward at head_dim 128:
//   * one CTA per (pair of 64-row kv tiles j0 = 2m, j0 + 1, batch * kv
//     head): 384 threads, a producer warpgroup (one warp works; setmaxnreg
//     lowers it to 24 registers) and two consumer warpgroups (raised to
//     240), one per kv tile, each holding its tile's dK and dV as f32 wgmma
//     accumulators (64 + 64 registers a thread). Low pairs (the longest
//     causal walks) start first. An odd t_kv leaves the last CTA one tile;
//     its second warpgroup computes and writes nothing;
//   * the producer loads K and V (128 rows, 64 KB) once by TMA, then streams
//     Q_i and dO_i through a 2-stage ring: TMA boxes of 64 rows x 64
//     columns over 4-d (D, H, S, B) maps of the strided tensors, 128-byte
//     swizzled, rows past the end zero-filled, completion counted in bytes
//     on the stage's mbarrier; its lanes add the stage's lse (times log2 e,
//     +inf past Sq, 0 for -inf), delta and q ids, bound-checked, and a step
//     record (q head, q tile, which tiles take the step and which need the
//     element mask). Consumers release a stage on a second mbarrier;
//   * the producer walks the ascending union of the two tiles' CSR slices
//     per q head of the group (PairWalk; kernels/schedule.py pair_walk), or
//     under DENSE every q tile, classifying both tiles. A step is fetched if
//     either tile takes it; a warpgroup whose tile does not skips its
//     products (a decision uniform in the warpgroup). The consumers read no
//     table: they read the step record;
//   * per step and warpgroup (m64 = its 64 kv rows): S^T = K Q^T and
//     dP^T = V dO^T (wgmma m64n64k16, both operands from shared memory);
//     P^T = exp2(S^T log2 e - lse log2 e) with the element mask where the
//     step needs it (kHidden below keeps the finite mask value's P in the
//     log2 domain); dS^T = P^T o (dP^T - delta); dV += P^T dO and
//     dK += dS^T Q (m64n128k16, P^T and dS^T as bf16 A fragments from the
//     registers, dO and Q read MN-major). The accumulator fragment is the
//     mma.sync C layout, row 16 (warp % 4) + lane / 4 (+8), column
//     8 t + 2 (lane % 4) (+1), so the mask and the bf16 A fragments carry
//     over from the mma.sync design;
//   * dQ: both warpgroups write bf16 dS^T into a double-buffered 128 x 64
//     tile (swizzled like TMA's; a tile that does not take the step writes
//     zeros), meet at a named barrier, and each computes dQ_i = dS K for
//     half of head_dim over the pair's 128 kv rows (m64n64k16, both
//     operands MN-major). The 64 x 64 f32 half goes to padded shared
//     memory, and a writer warp of the producer warpgroup (one a consumer
//     warpgroup) adds it into dq with cp.reduce.async.bulk .add.f32, 256
//     bytes a row: 128 bulk reductions a step where the mma.sync kernel
//     issued 16,384 scalar atomics. An mbarrier pair hands the staging back
//     and forth, so no consumer waits on a bulk read it did not need. The
//     adds' order varies, so dQ is allclose-only; bwd="split" is the
//     deterministic mode.
// What bounds it now: the steps are serial within a warpgroup (S and dP,
// then P, dV, dS, dK, then the barrier and dQ) and the two warpgroups meet
// every step, so exp2 and the elementwise work sit between products; the
// dq reductions (a 64 MB f32 buffer at the training shape, more than the
// 50 MB L2) share the TMA engine and L2 with the Q/dO stream. One CTA an
// SM (about 200 KB of shared memory).
//
// The split backward (bwd="split", the deterministic mode) is the other
// two, with no atomics anywhere:
//
// fa2_bwd_dkv_kernel replaces src/repro/kernels/flash_bwd.py:234
// flash_bwd_dkv (compact body _dkv_kernel_compact :193): the fused
// kernel's body with the dS buffer, the dQ product and its staging compiled
// out (a template flag). Same CTA, walk, products and k-step order, so its
// dK and dV are bitwise the fused kernel's. Four products per tile: bound
// by the tensor cores.
//
// fa2_bwd_dq_kernel replaces src/repro/kernels/flash_bwd.py:459
// flash_bwd_dq (compact body _dq_kernel_compact :422). It is Q-stationary:
// one CTA of 4 warps per (q tile of 64 rows, batch * q head) walks its
// slice of the forward's q-major table (build_q_tile_schedule) over the
// visible kv tiles in ascending order, reading kv head h / G. The Q and
// dO tiles stay in shared memory, lse and delta in registers (one value a
// row), and K and V tiles stream through a 2-stage cp.async ring. Per
// tile and warp (16 q rows): S = Q K^T and dP = dO V^T, P = exp(S - lse),
// dS = P o (dP - delta), then dQ += dS K with dS taken from the registers
// as bf16 A fragments and K through ldmatrix.trans (the shapes of the
// forward's S = Q K^T and O += P V). dQ stays in f32 registers (64 a
// thread) and is written once: a fixed order, so dQ is bitwise
// reproducible. Three products per tile: bound by the tensor cores.
// A CTA whose slice is empty still writes its zeros.
//
// Packed (varlen) batches take the SEG instantiation of the fused, dkv and
// dq kernels, which replaces the segment branches of the same Pallas
// kernels (flash_bwd.py:833, :330 and :539). Beside the table each reads
// int32 segment ids of q and kv and a (B, n_visible) table of per-step bits
// computed before the launch (kernels/schedule.py segment_step_bits, in
// the kernel's orientation), indexed by b = blockIdx.x / Hkv in the
// KV-stationary kernels and by b = bh / Hq in the dq kernel:
//   * a step without SEG_ACTIVE is skipped before its tiles are prefetched,
//     so it costs neither a copy nor a product. In the KV-stationary walk a
//     tile's entry without the bit is dropped from the union, and a step
//     that neither tile keeps is never fetched; the ring's stage alternates
//     with the count of fetched steps. The bits are read by every thread,
//     so the barriers stay uniform;
//   * a step applies the element mask when it is flagged masked or lacks
//     SEG_UNIFORM, and the mask then also needs q_id == kv_id. The owner
//     tile's ids sit in registers (two rows a thread); the streamed tile's
//     64 ids travel with it in the same stage (the KV-stationary
//     producer's lanes copy them, the dq kernel's cp.async group). Rows past
//     the end read as the masks.py sentinels;
//   * a kv tile with no active step writes zero dK and dV, a q tile zero
//     dQ, as every CTA writes its whole tile anyway.
// The SEG code of the fused and dkv kernels is one source, so split dK and
// dV stay bitwise the fused kernel's. With SEG false the kernels are the
// ones described above.
//
// The DENSE instantiations of the fused, dkv and dq kernels (each with and
// without SEG) replace the dense bodies of the same Pallas kernels:
// _fused_kernel_dense (flash_bwd.py:633), _dkv_kernel_dense (:157) and
// _dq_kernel_dense (:390), segment branches included. They read no table
// and no step bits: a KV-stationary CTA walks, for each q head g of the
// group, every q tile i = 0 .. t_q - 1 (the (g, i) order of the JAX dense
// grid (BHk, t_kv, G, t_q), flash_bwd.py:291), a dq CTA every kv tile in
// ascending order. Each step fetches its tiles (Q and dO, or K and V, with
// SEG their ids) through the same ring, then classifies the tile in the
// kernel (classify_tile: the spec, q_offset and the ragged kv edge; with
// SEG the min and max of the owner's ids, reduced once, and of the staged
// ids: the KV-stationary producer reduces them with shuffles, every dq
// thread reads them from shared memory) and skips the products of an empty
// one; a KV-stationary warpgroup classifies both tiles of its pair, so the
// two agree on whether the step has a dQ product. The cost of the hidden tiles' copies is the point: this is
// the baseline the compact schedule is measured against. Visible tiles
// come in the compact order with the compact mask decisions, so dense dK,
// dV and split dQ are the compact kernels' to the bit; the dense fused dQ
// goes through the same bulk reductions and agrees up to their order.
//
// The delta and dq kernels still run on mma.sync and cp.async; the dq
// kernel's redesign comes next.
//
// Semantics match the JAX kernels: masked scores take the finite
// DEFAULT_MASK_VALUE, K/V rows past the end read as zeros and are masked,
// a fully masked row's lse = -inf is replaced by 0 (P stays 0), P is
// rounded to bf16 before dV += P^T dO, dS before dK += dS^T Q and
// dQ += dS K. q is the pre-scaled q, so dQ is with respect to it. q rows
// past the end take lse = +inf, so their P is 0.

#include <math.h>

#include "sm90.cuh"

namespace {

constexpr int kBlockM = 64;  // q rows of a streamed tile
constexpr int kBlockN = 64;  // kv rows a CTA owns
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kDqThreads = 4 * 32;  // the dq kernel: one warp per 16 q rows

struct DeltaParams {
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  float* delta;  // (B, Hq, Sq)
  long long o_sb, o_ss, o_sh;
  long long d_sb, d_ss, d_sh;
  int Hq, Sq;
};

struct BwdParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* lse;    // (B, Hq, Sq), raw (-inf on fully masked rows)
  const float* delta;  // (B, Hq, Sq)
  float* dq;           // (B, Sq, Hq, D); fused: zeroed by the caller, null
                       // skips dQ's staging and bulk reduction (a timing
                       // variant that isolates their cost); dq kernel:
                       // written once
  float* dk;           // (B, Skv, Hkv, D)
  float* dv;           // (B, Skv, Hkv, D)
  const int* table;    // kv-major: row_ptr[t_kv + 1], then (q_tile << 1) | masked;
                       // q-major (dq): row_ptr[t_q + 1], then (kv_tile << 1) | masked
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long d_sb, d_ss, d_sh;
  int Hq, Hkv, group, Sq, Skv, t_kv, t_q;
  int causal, window, sink, q_offset;  // window < 0: no window
  // SEG only: segment ids (batch strides q_seg_sb / kv_seg_sb) and the
  // (B, n_vis) SEG_* bits of the table's steps.
  const int* q_seg;
  const int* kv_seg;
  const int* bits;
  long long q_seg_sb, kv_seg_sb;
  int n_vis;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = valid ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* smem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* smem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// Copy rows [row0, row0 + ROWS) of a (rows, D) slice with row stride
// `stride` into shared memory; rows at or past `nrows` are zero-filled.
template <int ROWS, int D, int STRIDE, int THREADS = kThreads>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long stride, int row0, int nrows) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < ROWS * CHUNKS; idx += THREADS) {
    const int r = idx / CHUNKS, c = idx % CHUNKS;
    const int g = row0 + r;
    const bool valid = g < nrows;
    const __nv_bfloat16* from = valid ? src + g * stride + c * 8 : src;
    cp_async16(dst + r * STRIDE + c * 8, from, valid);
  }
}

// Copy the N segment ids of rows [row0, row0 + N) into shared memory in the
// current cp.async group; ids at or past `nrows` read as `pad`.
template <int N, int THREADS>
__device__ __forceinline__ void load_ids(int* dst, const int* src, int row0, int nrows,
                                         int pad) {
  for (int r = threadIdx.x; r < N; r += THREADS) {
    if (row0 + r < nrows)
      cp_async4(dst + r, src + row0 + r);
    else
      dst[r] = pad;
  }
}

// (empty, needs the element mask) of the tile of BM q positions from q_lo
// and BN kv rows from kv_lo: the dense schedule's in-kernel test, the JAX
// _visibility (flash_fwd.py:71) on inclusive corners (the forward's
// classify_tile, csrc/flash_fwd.cu). A tile that reaches past Skv needs the
// mask; one that starts past it is never walked.
struct TileClass {
  bool empty, mask;
};

__device__ __forceinline__ TileClass classify_tile(const BwdParams& p, int q_lo, int kv_lo) {
  const int q_hi = q_lo + kBlockM - 1, kv_hi = kv_lo + kBlockN - 1;
  bool empty = false, full = true;
  if (p.causal) {
    empty = q_hi < kv_lo;
    full = q_lo >= kv_hi;
    if (p.window >= 0) {
      empty = empty || (q_lo - kv_hi >= p.window && kv_lo >= p.sink);
      full = full && (q_hi - kv_lo < p.window || kv_hi < p.sink);
    }
  } else if (p.window >= 0) {
    empty = (q_lo - kv_hi >= p.window || kv_lo - q_hi >= p.window) && kv_lo >= p.sink;
    full = (abs(q_lo - kv_hi) < p.window && abs(q_hi - kv_lo) < p.window) || kv_hi < p.sink;
  }
  if (kv_lo + kBlockN > p.Skv) full = false;
  return {empty, !full};
}

// The id-range test on top: disjoint id ranges share no segment (empty); a
// tile is mask-free only if both tiles hold one and the same id.
__device__ __forceinline__ TileClass with_ids(TileClass c, int q_lo, int q_hi, int kv_lo,
                                              int kv_hi) {
  c.empty = c.empty || q_hi < kv_lo || q_lo > kv_hi;
  c.mask = c.mask || !(q_lo == q_hi && kv_lo == kv_hi && q_lo == kv_lo);
  return c;
}

// min and max of the N ids of rows [row0, row0 + N), rows at or past
// `nrows` counting as `pad` (from global memory: an owner tile's ids, read
// once by every thread).
template <int N>
__device__ __forceinline__ void id_range(const int* g, int row0, int nrows, int pad, int& lo,
                                         int& hi) {
  lo = hi = row0 < nrows ? g[row0] : pad;
  for (int r = 1; r < N; ++r) {
    const int id = row0 + r < nrows ? g[row0 + r] : pad;
    lo = min(lo, id);
    hi = max(hi, id);
  }
}

// min and max of N staged ids in shared memory (broadcast reads).
template <int N>
__device__ __forceinline__ void id_range(const int* s, int& lo, int& hi) {
  lo = hi = s[0];
#pragma unroll 8
  for (int r = 1; r < N; ++r) {
    lo = min(lo, s[r]);
    hi = max(hi, s[r]);
  }
}

__device__ __forceinline__ bool visible(const BwdParams& p, int qpos, int col) {
  if (col >= p.Skv) return false;
  if (p.causal) {
    if (qpos < col) return false;
    return p.window < 0 || qpos - col < p.window || col < p.sink;
  }
  if (p.window < 0) return true;
  const int d = qpos > col ? qpos - col : col - qpos;
  return d < p.window || col < p.sink;
}

// ------------------------------------------------------------------ delta

template <int D>
__global__ void __launch_bounds__(kThreads) fa2_bwd_delta_kernel(const DeltaParams p) {
  constexpr int TPR = D / 8;                 // threads per row, 8 values each
  constexpr int ROWS_PER_PASS = kThreads / TPR;
  const int bh = blockIdx.y;
  const int b = bh / p.Hq, h = bh % p.Hq;
  const int c = threadIdx.x % TPR;
  const __nv_bfloat16* og = p.o + b * p.o_sb + h * p.o_sh + c * 8;
  const __nv_bfloat16* dg = p.dout + b * p.d_sb + h * p.d_sh + c * 8;
  for (int r = threadIdx.x / TPR; r < kBlockM; r += ROWS_PER_PASS) {
    const int row = blockIdx.x * kBlockM + r;
    float acc = 0.f;
    if (row < p.Sq) {
      const uint4 ov = *reinterpret_cast<const uint4*>(og + row * p.o_ss);
      const uint4 dv = *reinterpret_cast<const uint4*>(dg + row * p.d_ss);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = __bfloat1622float2(o2[e]);
        const float2 d = __bfloat1622float2(d2[e]);
        acc += a.x * d.x + a.y * d.y;
      }
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (c == 0 && row < p.Sq) p.delta[static_cast<long long>(bh) * p.Sq + row] = acc;
  }
}

// ------------------------------------------------------- fused and dkv

// The Hopper primitives (mbarriers, TMA, bulk reductions, named barriers,
// wgmma and its descriptors) and the pair walk live in sm90.cuh.

constexpr int kPairRows = 2 * kBlockN;  // kv rows of a KV-stationary CTA: two tiles
constexpr int kKvThreads = 3 * 128;     // producer warpgroup, two consumer warpgroups
constexpr int kConsumers = 2 * 128;
constexpr int kStages = 2;              // the Q/dO ring
constexpr int kDqRow = 72;              // f32 dQ staging row: 64 values + 32 bytes of padding
// A hidden element scores kHidden (sm90.cuh). A row that sees no key has
// lse = kMaskValue + log n, so P = exp(kMaskValue - lse) = 1 there; the
// producer stages such a row's lse as (kHidden + lse - kMaskValue) log2(e),
// the two terms scaled apart, and a hidden element's exp2(kHidden log2(e) -
// lse') is exp(kMaskValue - lse) on every row: 1 there, 0 elsewhere.

// The TMA maps of one launch: q, dO (64-row boxes) and k, v (128-row boxes),
// each a 4-d (D, H, S, B) view of the strided tensor, 64 columns a box,
// 128-byte swizzled.
struct KvMaps {
  CUtensorMap q, dout, k, v;
};

// Shared memory of the KV-stationary kernels, in bytes from a 1024-aligned
// base: K and V (two 64-column halves of 128 rows), the Q/dO ring (halves of
// 64 rows), with DQ two bf16 dS^T buffers (128 kv rows x 64 q) and the f32
// dQ staging of each consumer warpgroup, then each stage's lse, delta, q
// ids and step record, then the mbarriers and the staged dQ's (q0, head).
template <bool DQ>
struct KvSmem {
  static constexpr uint32_t K = 0, V = 32768, Q = 65536, DO = 98304, DS = 131072;
  static constexpr uint32_t DQS = DS + (DQ ? 2 * 16384 : 0);
  static constexpr uint32_t LSE = DQS + (DQ ? 2 * kBlockM * kDqRow * 4 : 0);
  static constexpr uint32_t DELTA = LSE + kStages * kBlockM * 4;
  static constexpr uint32_t QID = DELTA + kStages * kBlockM * 4;
  static constexpr uint32_t STEP = QID + kStages * kBlockM * 4;  // per stage: the step's record
  static constexpr uint32_t BARS = STEP + kStages * 16;  // full, empty, kv, dq_full, dq_empty
  static constexpr uint32_t DQ_META = BARS + (2 * kStages + 5) * 8;  // per warpgroup: (q0, h)
  static constexpr uint32_t BYTES = DQ_META + 2 * 8;
};


// The KV-stationary body: with DQ, the fused kernel; without, the dkv
// kernel (no dS buffer, no dQ product, no staging; dK and dV bitwise the
// same). SEG: the segment variant of either. DENSE: every q tile, no table.
template <bool DQ, bool SEG, bool DENSE>
__device__ __forceinline__ void kv_stationary(const BwdParams& p, const KvMaps& maps) {
  using L = KvSmem<DQ>;
  constexpr bool SKIP = SEG && !DENSE;  // inactive steps are skipped before their fetch
  constexpr int BM = kBlockM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t* empty = full + kStages;
  uint64_t* kv_bar = empty + kStages;
  uint64_t* dq_full = kv_bar + 1;   // per consumer warpgroup: its dQ half is staged
  uint64_t* dq_empty = dq_full + 2;  // the staging is read: it may be refilled
  int2* dq_meta = reinterpret_cast<int2*>(sm + L::DQ_META);
  float* sLse = reinterpret_cast<float*>(sm + L::LSE);  // lse * log2(e), +inf past Sq
  float* sDelta = reinterpret_cast<float*>(sm + L::DELTA);
  int* sQid = reinterpret_cast<int*>(sm + L::QID);
  // Per stage: (q head of the group, q tile, step flags); a negative head ends
  // the walk. The producer walks and classifies; the consumers read this.
  int4* sStep = reinterpret_cast<int4*>(sm + L::STEP);

  const int b = blockIdx.x / p.Hkv, hk = blockIdx.x % p.Hkv;
  const int j0 = 2 * blockIdx.y;  // low kv tiles (the longest causal runs) first
  const int k0 = j0 * kBlockN;
  const bool has1 = j0 + 1 < p.t_kv;  // an odd t_kv leaves the last pair one tile
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes; TMA bytes on top
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init(kv_bar, 1);
    for (int w = 0; w < 2; ++w) {
      mbar_init(&dq_full[w], 128);
      mbar_init(&dq_empty[w], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer: one warp. K and V once; then, per step of the walk, Q_i and
    // dO_i by TMA (rows past Sq zero-filled), the stage's lse, delta and q
    // ids by the lanes, bound-checked, and the step's record.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      PairWalk<SKIP, DENSE> walk;
      walk.group = p.group;
      walk.n_tiles = (p.Sq + BM - 1) / BM;
      walk.g = 0;
      if (DENSE) {
        walk.steps = walk.bits = nullptr;
        walk.a0 = walk.a1 = walk.b0 = walk.b1 = 0;
      } else {
        walk.steps = p.table + p.t_kv + 1;
        walk.bits = SKIP ? p.bits + static_cast<long long>(b) * p.n_vis : nullptr;
        walk.a0 = p.table[j0];
        walk.a1 = p.table[j0 + 1];
        walk.b0 = has1 ? p.table[j0 + 1] : 0;
        walk.b1 = has1 ? p.table[j0 + 2] : 0;
      }
      walk.ia = walk.a0;
      walk.ib = walk.b0;
      if (lane == 0) {
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                         smem_u32(kv_bar)),
                     "r"(4 * 16384)
                     : "memory");
        for (int half = 0; half < 2; ++half) {
          tma_load(sm + L::K + half * 16384, maps.k, kv_bar, half * 64, hk, k0, b);
          tma_load(sm + L::V + half * 16384, maps.v, kv_bar, half * 64, hk, k0, b);
        }
      }
      const int* qid_g = SEG ? p.q_seg + b * p.q_seg_sb : nullptr;
      int kv_lo[2] = {0, 0}, kv_hi[2] = {0, 0};  // DENSE with SEG: each tile's id range
      if (DENSE && SEG) {
        const int* kvid_g = p.kv_seg + b * p.kv_seg_sb;
        for (int x = 0; x < 2; ++x)
          id_range<kBlockN>(kvid_g, k0 + x * kBlockN, p.Skv, kKvPadSegment, kv_lo[x], kv_hi[x]);
      }
      int g, qt, ea, eb;
      // (A `break` out of this loop crashes ptxas 12.9; the loop ends on `more`.)
      bool more = true;
      for (int n = 0; more; ++n) {
        more = walk.next(g, qt, ea, eb);
        const int stage = n & 1;
        mbar_wait(&empty[stage], ((n >> 1) & 1) ^ 1);
        if (!more) {  // the walk's end: a record with a negative head, no copies
          if (lane == 0) sStep[stage] = make_int4(-1, 0, 0, 0);
          mbar_arrive(&full[stage]);
          continue;
        }
        const int h = hk * p.group + g, q0 = qt * BM;
        if (lane == 0) {
          mbar_expect_tx(&full[stage], 4 * 8192);
          for (int half = 0; half < 2; ++half) {
            tma_load(sm + L::Q + stage * 16384 + half * 8192, maps.q, &full[stage], half * 64, h,
                     q0, b);
            tma_load(sm + L::DO + stage * 16384 + half * 8192, maps.dout, &full[stage],
                     half * 64, h, q0, b);
          }
        }
        const long long row0 = (static_cast<long long>(b) * p.Hq + h) * p.Sq;
        int lo = 0x7fffffff, hi = -0x7fffffff;
        for (int r = lane; r < BM; r += 32) {
          const int qr = q0 + r;
          float l = INFINITY, d = 0.f;
          if (qr < p.Sq) {
            l = p.lse[row0 + qr];
            l = l == -INFINITY        ? 0.f
                : l < 0.5f * kMaskValue ? kHidden * kLog2e + (l - kMaskValue) * kLog2e
                                        : l * kLog2e;  // kHidden: a row that sees no key
            d = p.delta[row0 + qr];
          }
          sLse[stage * BM + r] = l;
          sDelta[stage * BM + r] = d;
          if (SEG) {
            const int id = qr < p.Sq ? qid_g[qr] : kQPadSegment;
            sQid[stage * BM + r] = id;
            lo = min(lo, id);
            hi = max(hi, id);
          }
        }
        // Which tiles take the step, and which need the element mask: the
        // table's flags and step bits, or under DENSE the classifier (with
        // SEG on both tiles' id ranges).
        int flags = 0;
        if (DENSE) {
          TileClass c0 = classify_tile(p, q0 + p.q_offset, k0);
          TileClass c1 = classify_tile(p, q0 + p.q_offset, k0 + kBlockN);
          if (SEG) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
              lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
              hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
            }
            c0 = with_ids(c0, lo, hi, kv_lo[0], kv_hi[0]);
            c1 = with_ids(c1, lo, hi, kv_lo[1], kv_hi[1]);
          }
          if (!c0.empty) flags |= kTake0 | (c0.mask ? kMask0 : 0);
          if (has1 && !c1.empty) flags |= kTake1 | (c1.mask ? kMask1 : 0);
        } else {
          if (ea >= 0)
            flags |= kTake0 | ((walk.steps[ea] & 1) || (SEG && !(walk.bits[ea] & kSegUniform))
                                   ? kMask0 : 0);
          if (eb >= 0)
            flags |= kTake1 | ((walk.steps[eb] & 1) || (SEG && !(walk.bits[eb] & kSegUniform))
                                   ? kMask1 : 0);
        }
        if (lane == 0) sStep[stage] = make_int4(g, qt, flags, 0);
        mbar_arrive(&full[stage]);
      }
    } else if (DQ && threadIdx.x < 96 && p.dq != nullptr) {
      // dQ writers: warp 1 + w adds consumer warpgroup w's staged 64 x 64
      // f32 half into dq by bulk reduction, 256 bytes a row, then frees the
      // staging; (q0, head) = (-1, -1) ends the walk.
      const int w = threadIdx.x / 32 - 1, lane = threadIdx.x % 32;
      const uint32_t stg = smem_u32(sm + L::DQS) + w * BM * kDqRow * 4;
      for (int u = 0;; ++u) {
        mbar_wait(&dq_full[w], u & 1);
        const int2 m = dq_meta[w];
        if (m.x < 0) break;
        for (int r = lane; r < BM; r += 32)
          if (m.x + r < p.Sq)
            bulk_reduce_add(
                p.dq + ((static_cast<long long>(b) * p.Sq + m.x + r) * p.Hq + m.y) * 128 + w * 64,
                stg + r * kDqRow * 4, 256);
        bulk_commit();
        bulk_wait_read();
        __syncwarp();
        if (lane == 0) mbar_arrive(&dq_empty[w]);
      }
      bulk_wait();
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    // Consumer warpgroup w owns kv tile j0 + w: rows kw0 .. kw0 + 63.
    const int w = wg - 1;
    const int t = threadIdx.x - 128 * wg;
    const int wq = t / 32, lane = t % 32, g8 = lane / 4, t4 = lane % 4;
    const int kw0 = k0 + w * kBlockN;
    const int kv_a = kw0 + wq * 16 + g8, kv_b = kv_a + 8;  // this thread's two kv rows
    int kvid[2] = {0, 0};
    if (SEG) {
      const int* kvid_g = p.kv_seg + b * p.kv_seg_sb;
      kvid[0] = kv_a < p.Skv ? kvid_g[kv_a] : kKvPadSegment;
      kvid[1] = kv_b < p.Skv ? kvid_g[kv_b] : kKvPadSegment;
    }
    const uint32_t sK = smem_u32(sm + L::K), sV = smem_u32(sm + L::V);
    const uint32_t sQ = smem_u32(sm + L::Q), sdO = smem_u32(sm + L::DO);
    const uint32_t sdS = smem_u32(sm + L::DS);
    const uint32_t stg = smem_u32(sm + L::DQS) + w * BM * kDqRow * 4;  // f32 dQ staging

    // dV and dK of the tile: rows kv_a / kv_b, columns 8 tt + 2 t4 (+1).
    float dv[64], dk[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dv[i] = dk[i] = 0.f;

    mbar_wait(kv_bar, 0);
    int n_dq = 0;  // steps with a dQ product: the dS buffer alternates with it
    for (int n = 0;; ++n) {
      const int stage = n & 1;
      mbar_wait(&full[stage], (n >> 1) & 1);
      const int4 step = sStep[stage];
      if (step.x < 0) break;
      const int h = hk * p.group + step.x, q0 = step.y * BM;
      const bool vis0 = step.z & kTake0, vis1 = step.z & kTake1;
      const bool masked = step.z & (w ? kMask1 : kMask0);
      const bool mine = w ? vis1 : vis0;  // uniform in the warpgroup
      const uint32_t cQ = sQ + stage * 16384, cdO = sdO + stage * 16384;
      const uint32_t cdS = sdS + (n_dq & 1) * 16384;
      // This thread's dS^T pair (row R, columns 8 tt + 2 t4, +1) of n-block
      // tt sits at ds_at ^ (tt << 4) in the 128-byte swizzle (R & 7 == g8);
      // row R + 8 is 1024 bytes on.
      const uint32_t ds_at = cdS + (w * 64 + wq * 16 + g8) * 128 + (g8 << 4) + t4 * 4;
      if (mine) {
        float s[32], dp[32];
        uint32_t pP[4][4], pS[4][4];  // bf16 P^T and dS^T: the A operands of dV and dK
        // S^T = K Q^T (line 11) and dP^T = V dO^T (line 13): 64 kv rows x 64
        // q columns, k over head_dim in two swizzled halves.
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          wgmma_ss_n64<0, 0>(s, sw128_desc(sK + (kk >> 2) * 16384 + w * 8192 + (kk & 3) * 32, 16),
                             sw128_desc(cQ + (kk >> 2) * 8192 + (kk & 3) * 32, 16), kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          wgmma_ss_n64<0, 0>(dp, sw128_desc(sV + (kk >> 2) * 16384 + w * 8192 + (kk & 3) * 32, 16),
                             sw128_desc(cdO + (kk >> 2) * 8192 + (kk & 3) * 32, 16), kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(s);

        // P^T = exp2(S^T log2(e) - lse log2(e)); element i of n-block tt is
        // kv row kv_a (i < 2) or kv_b, q column q0 + 8 tt + 2 t4 + (i & 1).
        // A hidden element scores kHidden: P^T is exp(mask - lse), 1 on a row
        // that sees no key.
        const float* cl = sLse + stage * BM;
        const float* cd = sDelta + stage * BM;
        const int* cq = sQid + stage * BM;
#pragma unroll
        for (int tt = 0; tt < 8; ++tt) {
          const int cc = tt * 8 + 2 * t4;
          const float2 l2 = *reinterpret_cast<const float2*>(cl + cc);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float x = s[4 * tt + i];
            if (masked) {
              bool v = visible(p, q0 + cc + (i & 1) + p.q_offset, i < 2 ? kv_a : kv_b);
              if (SEG) v = v && cq[cc + (i & 1)] == kvid[i >> 1];
              if (!v) x = kHidden;
            }
            s[4 * tt + i] = exp2f(fmaf(x, kLog2e, -((i & 1) ? l2.y : l2.x)));
          }
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          pP[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
          pP[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
          pP[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
          pP[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
        }
        // dV += P^T dO (line 12): k over the tile's 64 q rows.
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs_n128(dv, pP[kk], sw128_desc(cdO + kk * 2048, 8192));
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(dp);

        // dS^T = P^T o (dP^T - delta) (line 14), rounded to bf16.
#pragma unroll
        for (int tt = 0; tt < 8; ++tt) {
          const float2 d2 = *reinterpret_cast<const float2*>(cd + tt * 8 + 2 * t4);
#pragma unroll
          for (int i = 0; i < 4; ++i) dp[4 * tt + i] = s[4 * tt + i] * (dp[4 * tt + i] - ((i & 1) ? d2.y : d2.x));
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          pS[kk][0] = pack_bf16(dp[8 * kk], dp[8 * kk + 1]);
          pS[kk][1] = pack_bf16(dp[8 * kk + 2], dp[8 * kk + 3]);
          pS[kk][2] = pack_bf16(dp[8 * kk + 4], dp[8 * kk + 5]);
          pS[kk][3] = pack_bf16(dp[8 * kk + 6], dp[8 * kk + 7]);
        }
        // dK += dS^T Q (line 16).
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs_n128(dk, pS[kk], sw128_desc(cQ + kk * 2048, 8192));
        wgmma_commit();
        if (DQ) {
#pragma unroll
          for (int tt = 0; tt < 8; ++tt) {
            st_shared(ds_at ^ (tt << 4), pS[tt >> 1][(tt & 1) * 2]);
            st_shared((ds_at ^ (tt << 4)) + 1024, pS[tt >> 1][(tt & 1) * 2 + 1]);
          }
        }
        wgmma_wait<0>();  // dV and dK: P^T and dS^T are free
        fence_regs(dv);
        fence_regs(dk);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          fence_regs(pP[kk]);
          fence_regs(pS[kk]);
        }
      }
      mbar_arrive(&empty[stage]);  // this stage's Q, dO, lse, delta and ids are read
      if (DQ && (vis0 || vis1)) {
        // dQ_i += dS K_j (line 15) over the pair's 128 kv rows, both
        // warpgroups, each a half of head_dim; a hidden tile's dS rows are
        // zeros.
        if (!mine) {
#pragma unroll
          for (int tt = 0; tt < 8; ++tt) {
            st_shared(ds_at ^ (tt << 4), 0u);
            st_shared((ds_at ^ (tt << 4)) + 1024, 0u);
          }
        }
        fence_async_smem();
        named_sync(1, kConsumers);  // both tiles' dS are in the buffer
        float dq[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          wgmma_ss_n64<1, 1>(dq, sw128_desc(cdS + kk * 2048, 8192),
                             sw128_desc(sK + w * 16384 + kk * 2048, 8192), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
        if (p.dq != nullptr) {
          // Stage this warpgroup's 64 x 64 f32 half for its writer warp.
          mbar_wait(&dq_empty[w], (n_dq & 1) ^ 1);
          const uint32_t at = stg + ((wq * 16 + g8) * kDqRow + 2 * t4) * 4;
#pragma unroll
          for (int tt = 0; tt < 8; ++tt) {
            st_shared(at + tt * 32, dq[4 * tt], dq[4 * tt + 1]);
            st_shared(at + 8 * kDqRow * 4 + tt * 32, dq[4 * tt + 2], dq[4 * tt + 3]);
          }
          if (t == 0) dq_meta[w] = make_int2(q0, h);
          fence_async_smem();
          mbar_arrive(&dq_full[w]);
        }
        ++n_dq;
      }
    }
    if (DQ && p.dq != nullptr) {  // end the writer's walk
      mbar_wait(&dq_empty[w], (n_dq & 1) ^ 1);
      if (t == 0) dq_meta[w] = make_int2(-1, -1);
      mbar_arrive(&dq_full[w]);
    }

    // dK and dV of the tile, summed over the group's q heads: written once.
    if (w == 0 || has1) {
      const long long rs = static_cast<long long>(p.Hkv) * 128;
      const long long base = static_cast<long long>(b) * p.Skv * rs + hk * 128 + 2 * t4;
#pragma unroll
      for (int tt = 0; tt < 16; ++tt) {
        if (kv_a < p.Skv) {
          *reinterpret_cast<float2*>(p.dv + base + kv_a * rs + tt * 8) = make_float2(dv[4 * tt], dv[4 * tt + 1]);
          *reinterpret_cast<float2*>(p.dk + base + kv_a * rs + tt * 8) = make_float2(dk[4 * tt], dk[4 * tt + 1]);
        }
        if (kv_b < p.Skv) {
          *reinterpret_cast<float2*>(p.dv + base + kv_b * rs + tt * 8) = make_float2(dv[4 * tt + 2], dv[4 * tt + 3]);
          *reinterpret_cast<float2*>(p.dk + base + kv_b * rs + tt * 8) = make_float2(dk[4 * tt + 2], dk[4 * tt + 3]);
        }
      }
    }
  }
}

template <int D, bool SEG, bool DENSE>
__global__ void __launch_bounds__(kKvThreads, 1)
    fa2_bwd_fused_kernel(const BwdParams p, const __grid_constant__ KvMaps maps) {
  static_assert(D == 128, "the KV-stationary kernels take head_dim 128");
  kv_stationary<true, SEG, DENSE>(p, maps);
}

template <int D, bool SEG, bool DENSE>
__global__ void __launch_bounds__(kKvThreads, 1)
    fa2_bwd_dkv_kernel(const BwdParams p, const __grid_constant__ KvMaps maps) {
  static_assert(D == 128, "the KV-stationary kernels take head_dim 128");
  kv_stationary<false, SEG, DENSE>(p, maps);
}


// --------------------------------------------------------------------- dq

template <int D, bool SEG, bool DENSE>
__global__ void __launch_bounds__(kDqThreads) fa2_bwd_dq_kernel(const BwdParams p) {
  constexpr int BM = kBlockM;
  constexpr int BN = kBlockN;
  constexpr int STRIDE = D + 8;   // padded row: ldmatrix rows hit distinct banks
  constexpr int KSTEPS = D / 16;  // k-steps of S and dP over head_dim
  constexpr int NT_S = BN / 8;    // n-tiles over a tile's kv columns
  constexpr int NT_D = D / 8;     // n-tiles over head_dim

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BM][STRIDE]
  __nv_bfloat16* sdO = sQ + BM * STRIDE;                             // [BM][STRIDE]
  __nv_bfloat16* sK = sdO + BM * STRIDE;                             // [2][BN][STRIDE]
  __nv_bfloat16* sV = sK + 2 * BN * STRIDE;                          // [2][BN][STRIDE]
  int* sKid = reinterpret_cast<int*>(sV + 2 * BN * STRIDE);          // SEG: [2][BN] kv ids

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;  // this warp's 16 q rows within the tile
  const int g8 = lane / 4, t4 = lane % 4;
  const int qt = p.t_q - 1 - blockIdx.x;  // longest causal rows start first
  const int bh = blockIdx.y;
  const int b = bh / p.Hq, h = bh % p.Hq, hk = h / p.group;
  const __nv_bfloat16* kg = p.k + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vg = p.v + b * p.v_sb + hk * p.v_sh;
  const int q0 = qt * BM;
  // The walk: the table's steps [beg, end) of this q tile, or under DENSE
  // every kv tile (step = kv tile).
  const int beg = DENSE ? 0 : p.table[qt];
  const int end = DENSE ? (p.Skv + BN - 1) / BN : p.table[qt + 1];
  const int* steps = DENSE ? nullptr : p.table + p.t_q + 1;
  const int row_a = q0 + warp * 16 + g8;  // this thread's two q rows
  const int row_b = row_a + 8;
  // SEG: this batch row's step bits (compact), and the ids of the thread's
  // two rows; DENSE with SEG: the range of the q tile's ids.
  constexpr bool SKIP = SEG && !DENSE;  // inactive steps are skipped before their fetch
  const int* bits = SKIP ? p.bits + static_cast<long long>(b) * p.n_vis : nullptr;
  const int* kid_g = SEG ? p.kv_seg + b * p.kv_seg_sb : nullptr;
  int qid[2] = {0, 0};
  int qid_lo = 0, qid_hi = 0;
  if (SEG) {
    const int* qid_g = p.q_seg + b * p.q_seg_sb;
    qid[0] = row_a < p.Sq ? qid_g[row_a] : kQPadSegment;
    qid[1] = row_b < p.Sq ? qid_g[row_b] : kQPadSegment;
    if (DENSE) id_range<BM>(qid_g, q0, p.Sq, kQPadSegment, qid_lo, qid_hi);
  }
  // The first active step at or after `it` (every step without SKIP).
  auto next_active = [&](int it) {
    if (SKIP)
      while (it < end && !(bits[it] & kSegActive)) ++it;
    return it;
  };
  auto tile_of = [&](int it) { return DENSE ? it : steps[it] >> 1; };
  const int first = next_active(beg);

  // dQ: rows row_a / row_b, columns t * 8 + 2 * t4.
  float acc[NT_D][4];
#pragma unroll
  for (int t = 0; t < NT_D; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

  if (first < end) {
    load_tile<BM, D, STRIDE, kDqThreads>(sQ, p.q + b * p.q_sb + h * p.q_sh, p.q_ss, q0, p.Sq);
    load_tile<BM, D, STRIDE, kDqThreads>(sdO, p.dout + b * p.d_sb + h * p.d_sh, p.d_ss, q0,
                                         p.Sq);
    const int j0 = tile_of(first);
    load_tile<BN, D, STRIDE, kDqThreads>(sK, kg, p.k_ss, j0 * BN, p.Skv);
    load_tile<BN, D, STRIDE, kDqThreads>(sV, vg, p.v_ss, j0 * BN, p.Skv);
    if (SEG) load_ids<BN, kDqThreads>(sKid, kid_g, j0 * BN, p.Skv, kKvPadSegment);
    cp_async_commit();

    // lse (-inf -> 0; +inf past the end) and delta of the two rows.
    float lse_r[2], delta_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r ? row_b : row_a;
      const long long at = static_cast<long long>(bh) * p.Sq + row;
      const float l = row < p.Sq ? p.lse[at] : INFINITY;
      lse_r[r] = l == -INFINITY ? 0.f : l;
      delta_r[r] = row < p.Sq ? p.delta[at] : 0.f;
    }

    // With SKIP, `nxt` skips inactive steps before their tiles are fetched,
    // and `n` counts the tiles computed (the stage alternates with it).
    for (int it = first, n = 0; it < end; ++n) {
      const int nxt = SKIP ? next_active(it + 1) : it + 1;
      const int stage = SKIP ? (n & 1) : ((it - beg) & 1);
      if (nxt < end) {
        const int jn = tile_of(nxt);
        load_tile<BN, D, STRIDE, kDqThreads>(sK + (stage ^ 1) * BN * STRIDE, kg, p.k_ss,
                                             jn * BN, p.Skv);
        load_tile<BN, D, STRIDE, kDqThreads>(sV + (stage ^ 1) * BN * STRIDE, vg, p.v_ss,
                                             jn * BN, p.Skv);
        if (SEG) load_ids<BN, kDqThreads>(sKid + (stage ^ 1) * BN, kid_g, jn * BN, p.Skv,
                                          kKvPadSegment);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();

      const int j = tile_of(it);
      const __nv_bfloat16* cK = sK + stage * BN * STRIDE;
      const __nv_bfloat16* cV = sV + stage * BN * STRIDE;
      const int* cKid = sKid + stage * BN;
      bool masked, empty = false;
      if (DENSE) {
        TileClass c = classify_tile(p, q0 + p.q_offset, j * BN);
        if (SEG) {
          int lo, hi;
          id_range<BN>(cKid, lo, hi);
          c = with_ids(c, qid_lo, qid_hi, lo, hi);
        }
        empty = c.empty;
        masked = c.mask;
      } else {
        masked = (steps[it] & 1) || (SEG && !(bits[it] & kSegUniform));
      }
      if (empty) {  // DENSE: fetched, nothing to compute
        __syncthreads();  // this stage (its ids were read) is refilled next
        it = nxt;
        continue;
      }

      // S = Q K^T (line 11) and dP = dO V^T (line 13): this warp's 16 q
      // rows x the tile's 64 kv columns, A fragments from sQ / sdO.
      float s[NT_S][4], dp[NT_S][4];
#pragma unroll
      for (int t = 0; t < NT_S; ++t) {
        s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
        dp[t][0] = dp[t][1] = dp[t][2] = dp[t][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        unsigned qa[4], da[4];
        ldmatrix_x4(qa, sQ + (warp * 16 + (lane & 15)) * STRIDE + kk * 16 + (lane >> 4) * 8);
        ldmatrix_x4(da, sdO + (warp * 16 + (lane & 15)) * STRIDE + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < NT_S / 2; ++np) {
          const int off = (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * STRIDE + kk * 16 +
                          ((lane >> 3) & 1) * 8;
          unsigned kb[4], vb[4];
          ldmatrix_x4(kb, cK + off);
          mma_bf16(s[2 * np], qa, kb[0], kb[1]);
          mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
          ldmatrix_x4(vb, cV + off);
          mma_bf16(dp[2 * np], da, vb[0], vb[1]);
          mma_bf16(dp[2 * np + 1], da, vb[2], vb[3]);
        }
      }

      // P = exp(S - lse) (line 11), dS = P o (dP - delta) (line 14), into s.
      // Element e is q row row_a (e < 2) or row_b, kv column
      // j * BN + t * 8 + 2 * t4 + (e & 1).
#pragma unroll
      for (int t = 0; t < NT_S; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float x = s[t][e];
          if (masked) {
            bool vis = visible(p, (r ? row_b : row_a) + p.q_offset,
                               j * BN + t * 8 + 2 * t4 + (e & 1));
            if (SEG) vis = vis && qid[r] == cKid[t * 8 + 2 * t4 + (e & 1)];
            if (!vis) x = kMaskValue;
          }
          s[t][e] = expf(x - lse_r[r]) * (dp[t][e] - delta_r[r]);
        }
      }

      // dQ += dS K (line 15): A = bf16 dS from the registers, B = K
      // (kv rows x head_dim) through ldmatrix.trans.
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const unsigned a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                               pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dpair = 0; dpair < NT_D / 2; ++dpair) {
          unsigned bfr[4];
          ldmatrix_x4_trans(bfr, cK + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * STRIDE +
                                     dpair * 16 + (lane >> 4) * 8);
          mma_bf16(acc[2 * dpair], a, bfr[0], bfr[1]);
          mma_bf16(acc[2 * dpair + 1], a, bfr[2], bfr[3]);
        }
      }
      __syncthreads();  // this stage is refilled two iterations on
      it = nxt;
    }
  }

  // dQ of the tile, written once (zeros where the slice is empty).
  const long long rs = static_cast<long long>(p.Hq) * D;
  float* out = p.dq + static_cast<long long>(b) * p.Sq * rs + h * D + 2 * t4;
#pragma unroll
  for (int t = 0; t < NT_D; ++t) {
    if (row_a < p.Sq)
      *reinterpret_cast<float2*>(out + row_a * rs + t * 8) = make_float2(acc[t][0], acc[t][1]);
    if (row_b < p.Sq)
      *reinterpret_cast<float2*>(out + row_b * rs + t * 8) = make_float2(acc[t][2], acc[t][3]);
  }
}

template <int D, bool SEG>
size_t dq_smem_bytes() {
  return static_cast<size_t>(2 * kBlockM + 4 * kBlockN) * (D + 8) * sizeof(__nv_bfloat16) +
         (SEG ? 2 * kBlockN * sizeof(int) : 0);
}

// Fill the fields every backward kernel reads (all but dq, dk, dv, t_q, t_kv).
BwdParams bwd_params(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, const void* table, long long q_sb,
                     long long q_ss, long long q_sh, long long k_sb, long long k_ss,
                     long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                     long long d_sb, long long d_ss, long long d_sh, int Hq, int Hkv, int Sq,
                     int Skv, int causal, int window, int sink, int q_offset, const void* q_seg,
                     const void* kv_seg, long long q_seg_sb, long long kv_seg_sb,
                     const void* bits, int n_vis) {
  BwdParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = p.dk = p.dv = nullptr;
  p.table = static_cast<const int*>(table);
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.d_sb = d_sb; p.d_ss = d_ss; p.d_sh = d_sh;
  p.Hq = Hq; p.Hkv = Hkv; p.group = Hq / Hkv; p.Sq = Sq; p.Skv = Skv;
  p.t_kv = p.t_q = 0;
  p.causal = causal; p.window = window; p.sink = sink; p.q_offset = q_offset;
  p.q_seg = static_cast<const int*>(q_seg);
  p.kv_seg = static_cast<const int*>(kv_seg);
  p.bits = static_cast<const int*>(bits);
  p.q_seg_sb = q_seg_sb; p.kv_seg_sb = kv_seg_sb; p.n_vis = n_vis;
  return p;
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, const BwdParams& p, dim3 grid, int threads, size_t smem,
                   void* stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

// Whether an entry's arguments are consistent: segments are on with q ids;
// the compact schedule reads a table (with segments, step bits too), the
// dense one neither.
bool schedule_args_ok(const BwdParams& p, int dense) {
  if (dense) return p.table == nullptr && p.bits == nullptr;
  return p.table != nullptr && (p.q_seg == nullptr || p.bits != nullptr);
}


bool make_kv_maps(KvMaps* maps, const BwdParams& p, int batch) {
  return make_map(&maps->q, p.q, batch, p.Sq, p.Hq, 128, p.q_sb, p.q_ss, p.q_sh, kBlockM) &&
         make_map(&maps->dout, p.dout, batch, p.Sq, p.Hq, 128, p.d_sb, p.d_ss, p.d_sh, kBlockM) &&
         make_map(&maps->k, p.k, batch, p.Skv, p.Hkv, 128, p.k_sb, p.k_ss, p.k_sh, kPairRows) &&
         make_map(&maps->v, p.v, batch, p.Skv, p.Hkv, 128, p.v_sb, p.v_ss, p.v_sh, kPairRows);
}

// The KV-stationary kernels (fused: DQ) of one (SEG, DENSE) pair: one CTA
// per (pair of kv tiles, batch * kv head).
template <bool DQ, bool SEG, bool DENSE>
cudaError_t launch_kv(const BwdParams& p, int batch, int t_kv, void* stream) {
  KvMaps maps;
  if (!make_kv_maps(&maps, p, batch)) return cudaErrorInvalidValue;
  auto kernel = DQ ? fa2_bwd_fused_kernel<128, SEG, DENSE> : fa2_bwd_dkv_kernel<128, SEG, DENSE>;
  const size_t smem = KvSmem<DQ>::BYTES + 1024;  // + the 1024-byte alignment of the base
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(batch * p.Hkv, (t_kv + 1) / 2), kKvThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(p, maps);
  return cudaGetLastError();
}


template <bool DQ>
cudaError_t dispatch_kv(const BwdParams& p, int batch, int t_kv, bool seg, bool dense,
                        void* stream) {
  if (dense)
    return seg ? launch_kv<DQ, true, true>(p, batch, t_kv, stream)
               : launch_kv<DQ, false, true>(p, batch, t_kv, stream);
  return seg ? launch_kv<DQ, true, false>(p, batch, t_kv, stream)
             : launch_kv<DQ, false, false>(p, batch, t_kv, stream);
}

}  // namespace

extern "C" int fa2_bwd_delta_bf16(const void* o, const void* dout, void* delta, long long o_sb,
                                  long long o_ss, long long o_sh, long long d_sb, long long d_ss,
                                  long long d_sh, int batch, int Hq, int Sq, int head_dim,
                                  void* stream) {
  DeltaParams p;
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.delta = static_cast<float*>(delta);
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.d_sb = d_sb; p.d_ss = d_ss; p.d_sh = d_sh;
  p.Hq = Hq; p.Sq = Sq;
  if (head_dim != 128) return cudaErrorInvalidValue;
  const dim3 grid((Sq + kBlockM - 1) / kBlockM, batch * Hq);
  fa2_bwd_delta_kernel<128><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

// The entries below take the instantiations the training path needs
// (qwen3: head_dim 128, 64 x 64 tiles), without and with segments (null
// q ids: none), on the compact schedule (table, step bits) or the dense
// one (dense != 0: neither).

extern "C" int fa2_bwd_fused_bf16(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dq, void* dk,
                                  void* dv, const void* table, long long q_sb, long long q_ss,
                                  long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                                  long long v_sb, long long v_ss, long long v_sh, long long d_sb,
                                  long long d_ss, long long d_sh, int batch, int Hq, int Hkv,
                                  int Sq, int Skv, int head_dim, int block_q, int block_kv,
                                  int causal, int window, int sink, int q_offset, int t_kv,
                                  int dense, const void* q_seg, const void* kv_seg,
                                  long long q_seg_sb, long long kv_seg_sb, const void* bits,
                                  int n_vis, void* stream) {
  if (head_dim != 128 || block_q != kBlockM || block_kv != kBlockN) return cudaErrorInvalidValue;
  BwdParams p = bwd_params(q, k, v, dout, lse, delta, table, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                           v_sb, v_ss, v_sh, d_sb, d_ss, d_sh, Hq, Hkv, Sq, Skv, causal, window,
                           sink, q_offset, q_seg, kv_seg, q_seg_sb, kv_seg_sb, bits,
                           n_vis);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.t_kv = t_kv;
  if (!schedule_args_ok(p, dense)) return cudaErrorInvalidValue;
  return dispatch_kv<true>(p, batch, t_kv, q_seg != nullptr, dense != 0, stream);
}

extern "C" int fa2_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dk, void* dv,
                                const void* table, long long q_sb, long long q_ss, long long q_sh,
                                long long k_sb, long long k_ss, long long k_sh, long long v_sb,
                                long long v_ss, long long v_sh, long long d_sb, long long d_ss,
                                long long d_sh, int batch, int Hq, int Hkv, int Sq, int Skv,
                                int head_dim, int block_q, int block_kv, int causal, int window,
                                int sink, int q_offset, int t_kv, int dense, const void* q_seg,
                                const void* kv_seg, long long q_seg_sb, long long kv_seg_sb,
                                const void* bits, int n_vis, void* stream) {
  if (head_dim != 128 || block_q != kBlockM || block_kv != kBlockN) return cudaErrorInvalidValue;
  BwdParams p = bwd_params(q, k, v, dout, lse, delta, table, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                           v_sb, v_ss, v_sh, d_sb, d_ss, d_sh, Hq, Hkv, Sq, Skv, causal, window,
                           sink, q_offset, q_seg, kv_seg, q_seg_sb, kv_seg_sb, bits,
                           n_vis);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.t_kv = t_kv;
  if (!schedule_args_ok(p, dense)) return cudaErrorInvalidValue;
  return dispatch_kv<false>(p, batch, t_kv, q_seg != nullptr, dense != 0, stream);
}

extern "C" int fa2_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, void* dq, const void* table,
                               long long q_sb, long long q_ss, long long q_sh, long long k_sb,
                               long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                               long long v_sh, long long d_sb, long long d_ss, long long d_sh,
                               int batch, int Hq, int Hkv, int Sq, int Skv, int head_dim,
                               int block_q, int block_kv, int causal, int window, int sink,
                               int q_offset, int t_q, int dense, const void* q_seg,
                               const void* kv_seg, long long q_seg_sb, long long kv_seg_sb,
                               const void* bits, int n_vis, void* stream) {
  if (head_dim != 128 || block_q != kBlockM || block_kv != kBlockN) return cudaErrorInvalidValue;
  BwdParams p = bwd_params(q, k, v, dout, lse, delta, table, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                           v_sb, v_ss, v_sh, d_sb, d_ss, d_sh, Hq, Hkv, Sq, Skv, causal, window,
                           sink, q_offset, q_seg, kv_seg, q_seg_sb, kv_seg_sb, bits,
                           n_vis);
  p.dq = static_cast<float*>(dq);
  p.t_q = t_q;
  if (!schedule_args_ok(p, dense)) return cudaErrorInvalidValue;
  const dim3 grid(t_q, batch * Hq);
  const bool seg = q_seg != nullptr;
  if (dense)
    return seg ? launch(fa2_bwd_dq_kernel<128, true, true>, p, grid, kDqThreads,
                        dq_smem_bytes<128, true>(), stream)
               : launch(fa2_bwd_dq_kernel<128, false, true>, p, grid, kDqThreads,
                        dq_smem_bytes<128, false>(), stream);
  return seg ? launch(fa2_bwd_dq_kernel<128, true, false>, p, grid, kDqThreads,
                      dq_smem_bytes<128, true>(), stream)
             : launch(fa2_bwd_dq_kernel<128, false, false>, p, grid, kDqThreads,
                      dq_smem_bytes<128, false>(), stream);
}
