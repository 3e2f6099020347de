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
// run in parallel and in no order, so:
//   * one CTA per (kv tile of 64 rows, batch * kv head); K and V stay in
//     shared memory for its lifetime, and it loops over the G q heads that
//     share the kv head and, for each, over the visible q tiles of its own
//     CSR slice (kernels/schedule.py build_kv_tile_schedule). dK and dV are
//     summed over the group in registers and written once, in f32: no
//     atomics for them;
//   * delta is the pre-pass above (it lives in HBM, so the TPU wrapper's
//     VMEM budget for a per-q-tile delta scratch has no counterpart here);
//   * dQ is an f32 buffer the wrapper zeroes; each CTA atomicAdds its
//     dS K contribution into it (the paper's choice). The order of those
//     sums changes from run to run, so dQ is not bitwise reproducible;
//   * Q and dO tiles stream through a 2-stage cp.async ring (padded rows,
//     conflict-free ldmatrix); all products run on mma.sync m16n8k16
//     (bf16 in, f32 accumulate);
//   * 8 warps. Register pressure is the constraint: dK and dV are two
//     64 x 128 f32 tiles, 128 registers a thread if 4 warps held both. So
//     warps 0-3 own dV and warps 4-7 own dK, each warp 16 kv rows x 128:
//       phase 1  warps 0-3: S^T = K Q^T, P^T = exp(S^T - lse);
//                warps 4-7: dP^T = V dO^T;                  (in parallel)
//       phase 2  warps 0-3: dV += P^T dO (P^T from registers);
//                warps 4-7: dS^T = P^T o (dP^T - delta), taking the f32
//                P^T of their twin warp from shared memory fragment by
//                fragment, then dK += dS^T Q;              (in parallel)
//       phase 3  all warps: dQ += dS K from a bf16 dS^T tile in shared
//                memory, then the atomics.
//
// The split backward (bwd="split", the deterministic mode) is the other
// two, with no atomics anywhere:
//
// fa2_bwd_dkv_kernel replaces src/repro/kernels/flash_bwd.py:234
// flash_bwd_dkv (compact body _dkv_kernel_compact :193): the fused
// kernel's body with phase 3 and the dS^T staging compiled out (a template
// flag). Same CTA, warp split and loop order, so its dK and dV are bitwise
// the fused kernel's. Four products per tile: bound by the tensor cores.
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
//     so it costs neither a copy nor a product. The KV-stationary walk over
//     (q head of the group, visible q tile) reads the bit of the tile only,
//     and `it / nvis` still names the head; the stage alternates with the
//     count of computed tiles. The bits are uniform across a CTA, so the
//     barriers stay uniform;
//   * a step applies the element mask when it is flagged masked or lacks
//     SEG_UNIFORM, and the mask then also needs q_id == kv_id. The owner
//     tile's ids sit in registers (two rows a thread); the streamed tile's
//     64 ids travel with it through the same cp.async group (256 bytes a
//     stage). Rows past the end read as the masks.py sentinels;
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
// ids, read by every thread from shared memory) and skips the products of
// an empty one. The cost of the hidden tiles' copies is the point: this is
// the baseline the compact schedule is measured against. Visible tiles
// come in the compact order with the compact mask decisions, so dense dK,
// dV and split dQ are the compact kernels' to the bit; the dense fused dQ
// goes through the same atomics and agrees up to their order.
//
// None of them uses wgmma or TMA yet; those are the next step for speed.
//
// Semantics match the JAX kernels: masked scores take the finite
// DEFAULT_MASK_VALUE, K/V rows past the end read as zeros and are masked,
// a fully masked row's lse = -inf is replaced by 0 (P stays 0), P is
// rounded to bf16 before dV += P^T dO, dS before dK += dS^T Q and
// dQ += dS K. q is the pre-scaled q, so dQ is with respect to it. q rows
// past the end take lse = +inf, so their P is 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMaskValue = -0.7f * 3.402823466e38f;  // DEFAULT_MASK_VALUE
constexpr int kBlockM = 64;  // q rows of a streamed tile
constexpr int kBlockN = 64;  // kv rows a CTA owns
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kDqThreads = 4 * 32;  // the dq kernel: one warp per 16 q rows
constexpr int kSegActive = 1;       // schedule.SEG_ACTIVE
constexpr int kSegUniform = 2;      // schedule.SEG_UNIFORM
constexpr int kQPadSegment = -2;    // masks.Q_PAD_SEGMENT
constexpr int kKvPadSegment = -1;   // masks.KV_PAD_SEGMENT

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
                       // skips the atomics (a timing variant that isolates
                       // their cost); dq kernel: written once
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

// The KV-stationary body: with DQ, the fused kernel; without, the dkv
// kernel (no phase 3 and no dS^T tile; dK and dV bitwise the same). SEG:
// the segment variant of either. DENSE: every q tile, no table.
template <int D, bool DQ, bool SEG, bool DENSE>
__device__ __forceinline__ void kv_stationary(const BwdParams& p) {
  constexpr int BM = kBlockM;
  constexpr int BN = kBlockN;
  constexpr int STRIDE = D + 8;     // padded row: ldmatrix rows hit distinct banks
  constexpr int DS_STRIDE = BM + 8;
  constexpr int KSTEPS = D / 16;    // k-steps of the products over head_dim
  constexpr int NT_Q = BM / 8;      // n-tiles over a tile's q columns
  constexpr int NT_D = D / 8;       // n-tiles over head_dim
  constexpr int NT_DQ = NT_D / 2;   // dQ: each warp takes half of head_dim

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BN][STRIDE]
  __nv_bfloat16* sV = sK + BN * STRIDE;                             // [BN][STRIDE]
  __nv_bfloat16* sQ = sV + BN * STRIDE;                             // [2][BM][STRIDE]
  __nv_bfloat16* sdO = sQ + 2 * BM * STRIDE;                        // [2][BM][STRIDE]
  __nv_bfloat16* sdS = sdO + 2 * BM * STRIDE;                       // [BN][DS_STRIDE], dS^T
  float4* sP = reinterpret_cast<float4*>(sdS + (DQ ? BN * DS_STRIDE : 0));  // [4][NT_Q][32], P^T
  int* sQid = reinterpret_cast<int*>(sP + 4 * NT_Q * 32);  // SEG: [2][BM] q ids

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const bool owns_dv = warp < 4;  // warps 0-3: S, P, dV; warps 4-7: dP, dS, dK
  const int wr = warp % 4;        // this warp's 16 kv rows within the tile
  const int g8 = lane / 4, t4 = lane % 4;
  const int j = blockIdx.y;       // low kv tiles (the longest causal runs) first
  const int b = blockIdx.x / p.Hkv, hk = blockIdx.x % p.Hkv;
  const int k0 = j * BN;
  // Per q head, the table's visible q tiles of this kv tile, or under DENSE
  // every q tile: step it is (head it / nvis, q tile of entry it % nvis).
  const int beg = DENSE ? 0 : p.table[j];
  const int nvis = DENSE ? (p.Sq + BM - 1) / BM : p.table[j + 1] - beg;
  const int* steps = DENSE ? nullptr : p.table + p.t_kv + 1 + beg;
  const int n_steps = nvis * p.group;  // (q head of the group, q tile)
  const int kv_a = k0 + wr * 16 + g8;  // this thread's two kv rows
  const int kv_b = kv_a + 8;
  // SEG: the bits of this tile's slice (compact), the q ids, the ids of the
  // two kv rows; DENSE with SEG: the range of the kv tile's ids.
  constexpr bool SKIP = SEG && !DENSE;  // inactive steps are skipped before their fetch
  const int* bits = SKIP ? p.bits + static_cast<long long>(b) * p.n_vis + beg : nullptr;
  const int* qid_g = SEG ? p.q_seg + b * p.q_seg_sb : nullptr;
  int kvid[2] = {0, 0};
  int kvid_lo = 0, kvid_hi = 0;
  if (SEG) {
    const int* kvid_g = p.kv_seg + b * p.kv_seg_sb;
    kvid[0] = kv_a < p.Skv ? kvid_g[kv_a] : kKvPadSegment;
    kvid[1] = kv_b < p.Skv ? kvid_g[kv_b] : kKvPadSegment;
    if (DENSE) id_range<BN>(kvid_g, k0, p.Skv, kKvPadSegment, kvid_lo, kvid_hi);
  }
  // The first active step at or after `it` (every step without SKIP); a
  // step's bit is its q tile's, the same for every head of the group.
  auto next_active = [&](int it) {
    if (SKIP)
      while (it < n_steps && !(bits[it % nvis] & kSegActive)) ++it;
    return it;
  };
  auto q_tile_of = [&](int it) { return DENSE ? it % nvis : steps[it % nvis] >> 1; };
  const int first = next_active(0);

  // dV (warps 0-3) or dK (warps 4-7): rows kv_a / kv_b, columns t * 8 + 2 * t4.
  float acc[NT_D][4];
#pragma unroll
  for (int t = 0; t < NT_D; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

  auto load_q_stage = [&](int it, int stage) {
    const int h = hk * p.group + it / nvis;
    const int q0 = q_tile_of(it) * BM;
    load_tile<BM, D, STRIDE>(sQ + stage * BM * STRIDE, p.q + b * p.q_sb + h * p.q_sh, p.q_ss,
                             q0, p.Sq);
    load_tile<BM, D, STRIDE>(sdO + stage * BM * STRIDE, p.dout + b * p.d_sb + h * p.d_sh,
                             p.d_ss, q0, p.Sq);
    if (SEG) load_ids<BM, kThreads>(sQid + stage * BM, qid_g, q0, p.Sq, kQPadSegment);
  };

  if (first < n_steps) {
    load_tile<BN, D, STRIDE>(sK, p.k + b * p.k_sb + hk * p.k_sh, p.k_ss, k0, p.Skv);
    load_tile<BN, D, STRIDE>(sV, p.v + b * p.v_sb + hk * p.v_sh, p.v_ss, k0, p.Skv);
    load_q_stage(first, 0);
    cp_async_commit();

    // With SKIP, `nxt` skips inactive steps before their tiles are fetched,
    // and `n` counts the tiles computed (the stage alternates with it).
    for (int it = first, n = 0; it < n_steps; ++n) {
      const int nxt = SKIP ? next_active(it + 1) : it + 1;
      const int stage = SKIP ? (n & 1) : (it & 1);
      if (nxt < n_steps) {
        load_q_stage(nxt, stage ^ 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();

      const int h = hk * p.group + it / nvis;
      const int q0 = q_tile_of(it) * BM;
      const long long bh = static_cast<long long>(b) * p.Hq + h;
      const __nv_bfloat16* cQ = sQ + stage * BM * STRIDE;
      const __nv_bfloat16* cdO = sdO + stage * BM * STRIDE;
      const int* cQid = sQid + stage * BM;
      bool masked, empty = false;
      if (DENSE) {
        TileClass c = classify_tile(p, q0 + p.q_offset, k0);
        if (SEG) {
          int lo, hi;
          id_range<BM>(cQid, lo, hi);
          c = with_ids(c, lo, hi, kvid_lo, kvid_hi);
        }
        empty = c.empty;
        masked = c.mask;
      } else {
        masked = (steps[it % nvis] & 1) || (SEG && !(bits[it % nvis] & kSegUniform));
      }
      if (empty) {  // DENSE: fetched, nothing to compute
        __syncthreads();  // this stage (its ids were read) is refilled next
        it = nxt;
        continue;
      }

      // Phase 1: S^T = K Q^T (warps 0-3) or dP^T = V dO^T (warps 4-7), this
      // warp's 16 kv rows x the tile's 64 q columns.
      float s[NT_Q][4];
#pragma unroll
      for (int t = 0; t < NT_Q; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
      {
        const __nv_bfloat16* a_src = owns_dv ? sK : sV;
        const __nv_bfloat16* b_src = owns_dv ? cQ : cdO;
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
          unsigned af[4];
          ldmatrix_x4(af, a_src + (wr * 16 + (lane & 15)) * STRIDE + kk * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int np = 0; np < NT_Q / 2; ++np) {
            unsigned bfr[4];
            ldmatrix_x4(bfr, b_src + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * STRIDE +
                                 kk * 16 + ((lane >> 3) & 1) * 8);
            mma_bf16(s[2 * np], af, bfr[0], bfr[1]);
            mma_bf16(s[2 * np + 1], af, bfr[2], bfr[3]);
          }
        }
      }

      if (owns_dv) {
        // P^T = exp(S^T - lse) (Algorithm 2 line 11); element (e) is kv row
        // kv_a (e < 2) or kv_b, q column q0 + t * 8 + 2 * t4 + (e & 1).
        const float* lse_row = p.lse + bh * p.Sq;
#pragma unroll
        for (int t = 0; t < NT_Q; ++t) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qc = q0 + t * 8 + 2 * t4 + e;
            float l = qc < p.Sq ? lse_row[qc] : INFINITY;
            l = l == -INFINITY ? 0.f : l;
            float sa = s[t][e], sb = s[t][e + 2];
            if (masked) {
              bool va = visible(p, qc + p.q_offset, kv_a);
              bool vb = visible(p, qc + p.q_offset, kv_b);
              if (SEG) {
                const int qid = cQid[t * 8 + 2 * t4 + e];
                va = va && qid == kvid[0];
                vb = vb && qid == kvid[1];
              }
              if (!va) sa = kMaskValue;
              if (!vb) sb = kMaskValue;
            }
            s[t][e] = expf(sa - l);
            s[t][e + 2] = expf(sb - l);
          }
          sP[(wr * NT_Q + t) * 32 + lane] = make_float4(s[t][0], s[t][1], s[t][2], s[t][3]);
        }
      }
      __syncthreads();  // P^T is in shared memory

      if (!owns_dv) {
        // dS^T = P^T o (dP^T - delta) (line 14), then bf16 dS^T for dQ.
        const float* delta_row = p.delta + bh * p.Sq;
#pragma unroll
        for (int t = 0; t < NT_Q; ++t) {
          const float4 pv = sP[(wr * NT_Q + t) * 32 + lane];
          const int qc = q0 + t * 8 + 2 * t4;
          const float d0 = qc < p.Sq ? delta_row[qc] : 0.f;
          const float d1 = qc + 1 < p.Sq ? delta_row[qc + 1] : 0.f;
          s[t][0] = pv.x * (s[t][0] - d0);
          s[t][1] = pv.y * (s[t][1] - d1);
          s[t][2] = pv.z * (s[t][2] - d0);
          s[t][3] = pv.w * (s[t][3] - d1);
          if (DQ) {
            *reinterpret_cast<unsigned*>(sdS + (wr * 16 + g8) * DS_STRIDE + t * 8 + 2 * t4) =
                pack_bf16(s[t][0], s[t][1]);
            *reinterpret_cast<unsigned*>(sdS + (wr * 16 + g8 + 8) * DS_STRIDE + t * 8 + 2 * t4) =
                pack_bf16(s[t][2], s[t][3]);
          }
        }
      }

      // Phase 2: dV += P^T dO (line 12) or dK += dS^T Q (line 16); the A
      // operand comes from the registers as bf16 fragments, the B operand
      // (q rows x head_dim) from shared memory through ldmatrix.trans.
      {
        const __nv_bfloat16* b_src = owns_dv ? cdO : cQ;
#pragma unroll
        for (int kk = 0; kk < BM / 16; ++kk) {
          const unsigned a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                 pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                 pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                 pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
          for (int dp = 0; dp < NT_D / 2; ++dp) {
            unsigned bfr[4];
            ldmatrix_x4_trans(bfr, b_src + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * STRIDE +
                                       dp * 16 + (lane >> 4) * 8);
            mma_bf16(acc[2 * dp], a, bfr[0], bfr[1]);
            mma_bf16(acc[2 * dp + 1], a, bfr[2], bfr[3]);
          }
        }
      }

      // Phase 3 (DQ only): dQ_i += dS K_j (line 15), all warps: warp -> 16
      // q rows (wr) x half of head_dim (warp / 4); A = dS from the dS^T
      // tile through ldmatrix.trans, B = K through ldmatrix.trans.
      if (DQ) {
        __syncthreads();  // dS^T is in shared memory
        const int dcol0 = (warp / 4) * (D / 2);
        float dqa[NT_DQ][4];
#pragma unroll
        for (int t = 0; t < NT_DQ; ++t) dqa[t][0] = dqa[t][1] = dqa[t][2] = dqa[t][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
          unsigned a[4];
          ldmatrix_x4_trans(a, sdS + (kk * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) * DS_STRIDE +
                                   wr * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int dp = 0; dp < NT_DQ / 2; ++dp) {
            unsigned bfr[4];
            ldmatrix_x4_trans(bfr, sK + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * STRIDE +
                                       dcol0 + dp * 16 + (lane >> 4) * 8);
            mma_bf16(dqa[2 * dp], a, bfr[0], bfr[1]);
            mma_bf16(dqa[2 * dp + 1], a, bfr[2], bfr[3]);
          }
        }
        const long long rs = static_cast<long long>(p.Hq) * D;
        float* dqg = p.dq + static_cast<long long>(b) * p.Sq * rs + h * D + dcol0 + 2 * t4;
        const int qa = q0 + wr * 16 + g8, qb = qa + 8;
        if (p.dq != nullptr) {
#pragma unroll
          for (int t = 0; t < NT_DQ; ++t) {
            if (qa < p.Sq) {
              atomicAdd(dqg + qa * rs + t * 8, dqa[t][0]);
              atomicAdd(dqg + qa * rs + t * 8 + 1, dqa[t][1]);
            }
            if (qb < p.Sq) {
              atomicAdd(dqg + qb * rs + t * 8, dqa[t][2]);
              atomicAdd(dqg + qb * rs + t * 8 + 1, dqa[t][3]);
            }
          }
        }
      }
      __syncthreads();  // this stage, P^T and dS^T are refilled next
      it = nxt;
    }
  }

  // dK and dV of the tile, summed over the group's q heads: written once.
  const long long rs = static_cast<long long>(p.Hkv) * D;
  float* out = (owns_dv ? p.dv : p.dk) + static_cast<long long>(b) * p.Skv * rs + hk * D +
               2 * t4;
#pragma unroll
  for (int t = 0; t < NT_D; ++t) {
    if (kv_a < p.Skv)
      *reinterpret_cast<float2*>(out + kv_a * rs + t * 8) = make_float2(acc[t][0], acc[t][1]);
    if (kv_b < p.Skv)
      *reinterpret_cast<float2*>(out + kv_b * rs + t * 8) = make_float2(acc[t][2], acc[t][3]);
  }
}

template <int D, bool SEG, bool DENSE>
__global__ void __launch_bounds__(kThreads, 1) fa2_bwd_fused_kernel(const BwdParams p) {
  kv_stationary<D, true, SEG, DENSE>(p);
}

template <int D, bool SEG, bool DENSE>
__global__ void __launch_bounds__(kThreads, 1) fa2_bwd_dkv_kernel(const BwdParams p) {
  kv_stationary<D, false, SEG, DENSE>(p);
}

template <int D, bool DQ, bool SEG>
size_t kv_stationary_smem_bytes() {
  return static_cast<size_t>(2 * kBlockN + 4 * kBlockM) * (D + 8) * sizeof(__nv_bfloat16) +
         (DQ ? static_cast<size_t>(kBlockN) * (kBlockM + 8) * sizeof(__nv_bfloat16) : 0) +
         static_cast<size_t>(4 * (kBlockM / 8) * 32) * sizeof(float4) +
         (SEG ? 2 * kBlockM * sizeof(int) : 0);
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

// The KV-stationary kernels (fused: DQ) of one (SEG, DENSE) pair.
template <bool DQ, bool SEG, bool DENSE>
cudaError_t launch_kv(const BwdParams& p, int batch, int t_kv, void* stream) {
  auto kernel = DQ ? fa2_bwd_fused_kernel<128, SEG, DENSE> : fa2_bwd_dkv_kernel<128, SEG, DENSE>;
  return launch(kernel, p, dim3(batch * p.Hkv, t_kv), kThreads,
                kv_stationary_smem_bytes<128, DQ, SEG>(), stream);
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
