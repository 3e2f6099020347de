// FlashAttention-2 forward for Hopper (sm_90a), bf16 in, f32 softmax.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_fwd.py:354
// flash_fwd: its compact body _fwd_kernel_compact (:248) and the banded
// launch _flash_fwd_partitioned (:510) with kv_splits == 1. On the TPU the
// q tiles are dealt into bands to fill the cores; here the q tile is an
// ordinary parallel grid axis, so one launch covers both.
//
// What bounds it on an H100: a causal prefill at head_dim 128 does about
// 4 * S^2/2 * D flops per head against 2 * S * D * 2 bytes of K/V, so for
// S in the hundreds and up it is bound by the tensor cores (989 TFLOP/s
// bf16), not by HBM (3.35 TB/s). The design follows from that:
//   * one CTA per (q tile of 16 * NWARPS rows, batch * q head); each warp
//     owns 16 q rows and keeps them in registers as mma.sync A fragments;
//   * K and V tiles of 64 rows stream through a 2-stage cp.async ring in
//     shared memory (padded rows, conflict-free ldmatrix), so the next
//     tile's copy overlaps this tile's two products;
//   * S = Q K^T and O += P V run on mma.sync m16n8k16 (bf16 in, f32
//     accumulate); P goes from the S accumulators to A fragments in
//     registers and never touches shared memory;
//   * the CTA reads its own list of visible kv tiles (kernels/schedule.py),
//     so fully hidden tiles are never loaded, and only tiles flagged masked
//     (partial under the mask, or on the ragged kv edge) apply the element
//     mask;
//   * online softmax in f32 with the un-rescaled accumulator (paper C1): the
//     running max is corrected per tile and 1/l is applied once at the end.
// It uses neither wgmma nor TMA yet; those are the next step for speed.
//
// Semantics match the JAX kernel: masked scores take the finite
// DEFAULT_MASK_VALUE, K/V rows past the end read as zeros, the kv head of
// q head h is h / group, rows that visit no tile give O = 0, lse = -inf.
//
// Packed (varlen) batches take the SEG instantiation, which replaces the
// segment branch of the same Pallas kernel (flash_fwd.py:388/:478,
// fa2_fwd_compact_varlen). Beside the table it reads int32 segment ids of
// q and kv and a (B, n_visible) table of per-step bits computed before the
// launch (kernels/schedule.py segment_step_bits): a step without
// SEG_ACTIVE is skipped before its tiles are prefetched, so it costs
// neither a copy nor a product; a step applies the element mask when it is
// flagged masked or lacks SEG_UNIFORM, and the mask then also needs
// q_id == kv_id. The CTA's q ids sit in registers (two rows a thread), the
// kv tile's 64 ids travel with its K/V tile through the same cp.async
// group (256 bytes a stage). The bits are the same for the whole CTA, so
// the barriers stay uniform. With SEG false the kernel is the one above.
//
// The SPLIT instantiation replaces the kv_splits > 1 mode of
// src/repro/kernels/flash_fwd.py:510 _flash_fwd_partitioned (body
// _fwd_kernel_partitioned :290). Its grid gains a third axis, the kv split:
// the CTA of (q tile i, split s) reads owner i * ks + s of the split table
// (kernels/schedule.py build_split_schedule), which holds q tile i's visible
// kv tiles inside split s, and writes its locally normalised o and lse as
// f32 partials (B, Hq, ks, Sq, D) / (B, Hq, ks, Sq); an owner with no step
// writes (0, -inf), the merge identity. A second launch on the same stream,
// fa2_fwd_fold_kernel, folds the splits in one pass (one CTA of D threads
// per (q row, batch * q head), the logsumexp of the split lse, then
// o = sum_s exp(lse_s - m) o_s / l) into the single-pass kernel's outputs,
// bf16 o (B, Sq, Hq, D) and f32 lse (B, Hq, Sq). What it is for: a short query against a long
// key set (whisper's cross-attention, 4 prompt rows against 1500 frames) is
// one q tile, so the single-pass grid has only batch * heads CTAs (32 at
// B = 4) on 132 SMs, each walking every kv tile in series; the work is
// bound by the bytes of K and V (12.3 MB, 3.7 us at 3.35 TB/s), and those
// bytes are read at the card's rate only when enough CTAs are in flight.
// Splits multiply the CTAs by ks and cut each CTA's walk to 1/ks.
//
// The DENSE instantiation (with and without SEG; never with SPLIT, which
// the JAX package refuses under the dense schedule, flash_fwd.py:391)
// replaces the dense body _fwd_kernel_dense (src/repro/kernels/flash_fwd.py
// :206, segment branch included). It reads no table: the same CTA walks
// every kv tile j = 0 .. t_kv - 1 in ascending order, copies each tile (and
// with SEG its ids) through the same 2-stage cp.async ring, and only after
// the wait classifies it in the kernel, from the mask spec, q_offset and
// the ragged kv edge (classify_tile below, the JAX _visibility :71 and
// kernels/flash_fwd.py visibility) and with SEG from the min and max of
// the CTA's q ids (reduced once) and of the staged kv ids (every thread
// reads the 64 ids from shared memory, so the decision is the same in
// every thread and the barriers stay uniform). An empty tile skips both
// products and the softmax update; a tile that is not full applies the
// element mask of the compact kernel. Hidden tiles are fetched on purpose:
// the TPU dense grid DMAs every block (flash_fwd.py:27-30), and that cost
// is what the compact schedule saves, so this instantiation is its
// measurable baseline. The visible tiles come in the compact order with
// the compact mask decisions, so o and lse are the compact kernel's to the
// bit, with and without segments.
//
// Head dims: every variant is instantiated at 128 (qwen3) and 64
// (whisper). At 64 a CTA holds 46 KB of shared memory instead of 87 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMaskValue = -0.7f * 3.402823466e38f;  // DEFAULT_MASK_VALUE
constexpr int kBlockN = 64;
constexpr int kSegActive = 1;   // schedule.SEG_ACTIVE
constexpr int kSegUniform = 2;  // schedule.SEG_UNIFORM
constexpr int kQPadSegment = -2;   // masks.Q_PAD_SEGMENT
constexpr int kKvPadSegment = -1;  // masks.KV_PAD_SEGMENT

struct FwdParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  void* o;             // bf16 (B, Sq, Hq, D); SPLIT: f32 (B, Hq, ks, Sq, D)
  float* lse;          // (B, Hq, ks, Sq); ks == 1 without SPLIT
  const int* table;    // row_ptr[t_q * ks + 1], then (kv_tile << 1) | masked
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh, o_split;
  int Hq, group, Sq, Skv, t_q, ks;
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
template <int ROWS, int D, int THREADS, int STRIDE>
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

// (empty, needs the element mask) of the tile of q positions [q_lo, q_lo +
// BM) and kv rows [kv_lo, kv_lo + BN): the dense schedule's in-kernel test,
// the JAX _visibility (flash_fwd.py:71) on inclusive corners. A tile that
// reaches past Skv needs the mask; one that starts past it is never walked.
struct TileClass {
  bool empty, mask;
};

template <int BM, int BN>
__device__ __forceinline__ TileClass classify_tile(int causal, int window, int sink, int Skv,
                                                   int q_lo, int kv_lo) {
  const int q_hi = q_lo + BM - 1, kv_hi = kv_lo + BN - 1;
  bool empty = false, full = true;
  if (causal) {
    empty = q_hi < kv_lo;
    full = q_lo >= kv_hi;
    if (window >= 0) {
      empty = empty || (q_lo - kv_hi >= window && kv_lo >= sink);
      full = full && (q_hi - kv_lo < window || kv_hi < sink);
    }
  } else if (window >= 0) {
    empty = (q_lo - kv_hi >= window || kv_lo - q_hi >= window) && kv_lo >= sink;
    full = (abs(q_lo - kv_hi) < window && abs(q_hi - kv_lo) < window) || kv_hi < sink;
  }
  if (kv_lo + BN > Skv) full = false;
  return {empty, !full};
}

// The id-range test on top: tiles whose id ranges [lo, hi] do not overlap
// share no segment (empty); a tile is mask-free only if both hold one and
// the same id. On a spec-visible tile: SEG_ACTIVE and SEG_UNIFORM.
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

__device__ __forceinline__ bool visible(const FwdParams& p, int qpos, int col) {
  if (col >= p.Skv) return false;
  if (p.causal) {
    if (qpos < col) return false;
    return p.window < 0 || qpos - col < p.window || col < p.sink;
  }
  if (p.window < 0) return true;
  const int d = qpos > col ? qpos - col : col - qpos;
  return d < p.window || col < p.sink;
}

template <int D, int NWARPS, bool SEG, bool SPLIT, bool DENSE>
__global__ void __launch_bounds__(NWARPS * 32) fa2_fwd_kernel(const FwdParams p) {
  constexpr int BM = 16 * NWARPS;
  constexpr int BN = kBlockN;
  constexpr int THREADS = NWARPS * 32;
  constexpr int STRIDE = D + 8;  // padded row: ldmatrix rows hit distinct banks
  constexpr int KSTEPS = D / 16;
  constexpr int NT_S = BN / 8;
  constexpr int NT_O = D / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + BM * STRIDE;      // [2][BN][STRIDE]
  __nv_bfloat16* sV = sK + 2 * BN * STRIDE;  // [2][BN][STRIDE]
  int* sKid = reinterpret_cast<int*>(sV + 2 * BN * STRIDE);  // SEG: [2][BN] kv ids

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int qt = p.t_q - 1 - blockIdx.x;  // longest causal rows start first
  const int bh = blockIdx.y;
  const int split = SPLIT ? blockIdx.z : 0;
  const int owner = SPLIT ? qt * p.ks + split : qt;
  const int b = bh / p.Hq, h = bh % p.Hq, hk = h / p.group;
  const __nv_bfloat16* qg = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg = p.k + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vg = p.v + b * p.v_sb + hk * p.v_sh;
  const int q0 = qt * BM;
  // The walk: the table's steps [beg, end) of this owner, or under DENSE
  // every kv tile (step = kv tile).
  const int beg = DENSE ? 0 : p.table[owner];
  const int end = DENSE ? (p.Skv + BN - 1) / BN : p.table[owner + 1];
  const int* steps = DENSE ? nullptr : p.table + p.t_q * p.ks + 1;
  const int row_a = q0 + warp * 16 + lane / 4;  // this thread's two rows
  const int row_b = row_a + 8;
  // SEG: this batch row's step bits (compact), and the ids of the thread's
  // two rows; DENSE with SEG: the range of the CTA's q ids.
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

  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};
  float acc[NT_O][4];
#pragma unroll
  for (int t = 0; t < NT_O; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

  if (first < end) {
    load_tile<BM, D, THREADS, STRIDE>(sQ, qg, p.q_ss, q0, p.Sq);
    cp_async_commit();
    const int j0 = tile_of(first);
    load_tile<BN, D, THREADS, STRIDE>(sK, kg, p.k_ss, j0 * BN, p.Skv);
    load_tile<BN, D, THREADS, STRIDE>(sV, vg, p.v_ss, j0 * BN, p.Skv);
    if (SEG) load_ids<BN, THREADS>(sKid, kid_g, j0 * BN, p.Skv, kKvPadSegment);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    unsigned qf[KSTEPS][4];
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      ldmatrix_x4(qf[kk], sQ + (warp * 16 + (lane & 15)) * STRIDE + kk * 16 + (lane >> 4) * 8);

    // With SKIP, `nxt` skips inactive steps before their tiles are fetched,
    // and `n` counts the tiles computed (the stage alternates with it).
    for (int it = first, n = 0; it < end; ++n) {
      const int nxt = SKIP ? next_active(it + 1) : it + 1;
      const int stage = SKIP ? (n & 1) : ((it - beg) & 1);
      if (nxt < end) {
        const int jn = tile_of(nxt);
        load_tile<BN, D, THREADS, STRIDE>(sK + (stage ^ 1) * BN * STRIDE, kg, p.k_ss, jn * BN,
                                          p.Skv);
        load_tile<BN, D, THREADS, STRIDE>(sV + (stage ^ 1) * BN * STRIDE, vg, p.v_ss, jn * BN,
                                          p.Skv);
        if (SEG) load_ids<BN, THREADS>(sKid + (stage ^ 1) * BN, kid_g, jn * BN, p.Skv,
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
        TileClass c = classify_tile<BM, BN>(p.causal, p.window, p.sink, p.Skv, q0 + p.q_offset,
                                            j * BN);
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

      // S = Q K^T for this warp's 16 rows x BN columns.
      float s[NT_S][4];
#pragma unroll
      for (int t = 0; t < NT_S; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
        for (int np = 0; np < NT_S / 2; ++np) {
          unsigned bfr[4];
          ldmatrix_x4(bfr, cK + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * STRIDE + kk * 16 +
                               ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * np], qf[kk], bfr[0], bfr[1]);
          mma_bf16(s[2 * np + 1], qf[kk], bfr[2], bfr[3]);
        }
      }

      if (masked) {
#pragma unroll
        for (int t = 0; t < NT_S; ++t) {
          const int col = j * BN + t * 8 + (lane & 3) * 2;
          int kid[2] = {0, 0};
          if (SEG) {
            kid[0] = cKid[t * 8 + (lane & 3) * 2];
            kid[1] = cKid[t * 8 + (lane & 3) * 2 + 1];
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = (e < 2 ? row_a : row_b) + p.q_offset;
            bool vis = visible(p, row, col + (e & 1));
            if (SEG) vis = vis && qid[e >> 1] == kid[e & 1];
            if (!vis) s[t][e] = kMaskValue;
          }
        }
      }

      // Online softmax (FA2 Algorithm 1 lines 8-10, un-rescaled accumulator).
      float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
      for (int t = 0; t < NT_S; ++t) {
        mx[0] = fmaxf(mx[0], fmaxf(s[t][0], s[t][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[t][2], s[t][3]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) alpha[r] = m_r[r] == -INFINITY ? 0.f : expf(m_r[r] - mx[r]);
#pragma unroll
      for (int t = 0; t < NT_S; ++t) {
        s[t][0] = expf(s[t][0] - mx[0]);
        s[t][1] = expf(s[t][1] - mx[0]);
        s[t][2] = expf(s[t][2] - mx[1]);
        s[t][3] = expf(s[t][3] - mx[1]);
        rs[0] += s[t][0] + s[t][1];
        rs[1] += s[t][2] + s[t][3];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
        l_r[r] = l_r[r] * alpha[r] + rs[r];
        m_r[r] = mx[r];
      }
#pragma unroll
      for (int t = 0; t < NT_O; ++t) {
        acc[t][0] *= alpha[0];
        acc[t][1] *= alpha[0];
        acc[t][2] *= alpha[1];
        acc[t][3] *= alpha[1];
      }

      // O += P V, P taken from the S accumulators as bf16 A fragments.
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const unsigned a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                               pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < NT_O / 2; ++dp) {
          unsigned bfr[4];
          ldmatrix_x4_trans(bfr, cV + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * STRIDE +
                                     dp * 16 + (lane >> 4) * 8);
          mma_bf16(acc[2 * dp], a, bfr[0], bfr[1]);
          mma_bf16(acc[2 * dp + 1], a, bfr[2], bfr[3]);
        }
      }
      __syncthreads();  // this stage is refilled two iterations on
      it = nxt;
    }
  }

  // Finalize: one 1/l per row (C1), then the f32 logsumexp. SPLIT writes
  // the f32 partial of its split; a row that saw nothing has acc = 0, l = 0.
  const float l_a = l_r[0] == 0.f ? 1.f : l_r[0];
  const float l_b = l_r[1] == 0.f ? 1.f : l_r[1];
  const int col0 = (lane & 3) * 2;
  if (SPLIT) {
    float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh + split * p.o_split;
#pragma unroll
    for (int t = 0; t < NT_O; ++t) {
      if (row_a < p.Sq)
        *reinterpret_cast<float2*>(og + row_a * p.o_ss + t * 8 + col0) =
            make_float2(acc[t][0] / l_a, acc[t][1] / l_a);
      if (row_b < p.Sq)
        *reinterpret_cast<float2*>(og + row_b * p.o_ss + t * 8 + col0) =
            make_float2(acc[t][2] / l_b, acc[t][3] / l_b);
    }
  } else {
    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int t = 0; t < NT_O; ++t) {
      if (row_a < p.Sq)
        *reinterpret_cast<unsigned*>(og + row_a * p.o_ss + t * 8 + col0) =
            pack_bf16(acc[t][0] / l_a, acc[t][1] / l_a);
      if (row_b < p.Sq)
        *reinterpret_cast<unsigned*>(og + row_b * p.o_ss + t * 8 + col0) =
            pack_bf16(acc[t][2] / l_b, acc[t][3] / l_b);
    }
  }
  if ((lane & 3) == 0) {
    float* lg = p.lse + (static_cast<long long>(bh) * p.ks + split) * p.Sq;
    if (row_a < p.Sq) lg[row_a] = l_r[0] == 0.f ? -INFINITY : m_r[0] + logf(l_a);
    if (row_b < p.Sq) lg[row_b] = l_r[1] == 0.f ? -INFINITY : m_r[1] + logf(l_b);
  }
}

// The fold of SPLIT's partials: CTA (row, bh) of D threads, thread d folds
// column d of q row `row` of batch * q head `bh` over the ks splits. The
// partials are contiguous (B, Hq, ks, Sq, D) / (B, Hq, ks, Sq), the outputs
// contiguous (B, Sq, Hq, D) bf16 / (B, Hq, Sq) f32. A row that no split saw
// (every lse -inf) gives o = 0, lse = -inf.
template <int D>
__global__ void __launch_bounds__(D) fa2_fwd_fold_kernel(const FwdParams p,
                                                         __nv_bfloat16* o, float* lse) {
  const int row = blockIdx.x, bh = blockIdx.y, d = threadIdx.x;
  const long long base = static_cast<long long>(bh) * p.ks * p.Sq + row;
  const float* lp = p.lse + base;
  const float* op = static_cast<const float*>(p.o) + base * D + d;
  float m = -INFINITY;
  for (int s = 0; s < p.ks; ++s) m = fmaxf(m, lp[static_cast<long long>(s) * p.Sq]);
  const float m_safe = m == -INFINITY ? 0.f : m;
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < p.ks; ++s) {
    const float w = expf(lp[static_cast<long long>(s) * p.Sq] - m_safe);
    l += w;
    acc += w * op[static_cast<long long>(s) * p.Sq * D];
  }
  const float l_safe = l == 0.f ? 1.f : l;
  const int b = bh / p.Hq, h = bh % p.Hq;
  o[((static_cast<long long>(b) * p.Sq + row) * p.Hq + h) * D + d] =
      __float2bfloat16(acc / l_safe);
  if (d == 0)
    lse[static_cast<long long>(bh) * p.Sq + row] = l == 0.f ? -INFINITY : m_safe + logf(l_safe);
}

constexpr int kWarps = 4;  // 64 q rows per CTA (block_q)

template <int D, bool SEG>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(16 * kWarps + 4 * kBlockN) * (D + 8) * sizeof(__nv_bfloat16) +
         (SEG ? 2 * kBlockN * sizeof(int) : 0);
}

template <int D, bool SEG, bool SPLIT, bool DENSE = false>
cudaError_t launch(const FwdParams& p, int batch, cudaStream_t stream, __nv_bfloat16* o_fold,
                   float* lse_fold) {
  constexpr size_t smem = smem_bytes<D, SEG>();
  cudaError_t err = cudaFuncSetAttribute(fa2_fwd_kernel<D, kWarps, SEG, SPLIT, DENSE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.t_q, batch * p.Hq, p.ks);
  fa2_fwd_kernel<D, kWarps, SEG, SPLIT, DENSE><<<grid, kWarps * 32, smem, stream>>>(p);
  if (SPLIT) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    fa2_fwd_fold_kernel<D><<<dim3(p.Sq, batch * p.Hq), D, 0, stream>>>(p, o_fold, lse_fold);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch(const FwdParams& p, int batch, bool seg, bool split, bool dense,
                     cudaStream_t s, __nv_bfloat16* of, float* lf) {
  if (dense)
    return seg ? launch<D, true, false, true>(p, batch, s, of, lf)
               : launch<D, false, false, true>(p, batch, s, of, lf);
  if (seg)
    return split ? launch<D, true, true>(p, batch, s, of, lf)
                 : launch<D, true, false>(p, batch, s, of, lf);
  return split ? launch<D, false, true>(p, batch, s, of, lf)
               : launch<D, false, false>(p, batch, s, of, lf);
}

}  // namespace

extern "C" int fa2_fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                            const void* table, long long q_sb, long long q_ss, long long q_sh,
                            long long k_sb, long long k_ss, long long k_sh, long long v_sb,
                            long long v_ss, long long v_sh, long long o_sb, long long o_ss,
                            long long o_sh, long long o_split, int batch, int Hq, int Hkv,
                            int Sq, int Skv, int head_dim, int block_q, int block_kv, int causal,
                            int window, int sink, int q_offset, int t_q, int split, int ks,
                            int dense, const void* q_seg,
                            const void* kv_seg, long long q_seg_sb, long long kv_seg_sb,
                            const void* bits, int n_vis, void* o_fold, void* lse_fold,
                            void* stream) {
  FwdParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.table = static_cast<const int*>(table);
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh; p.o_split = o_split;
  p.Hq = Hq; p.group = Hq / Hkv; p.Sq = Sq; p.Skv = Skv; p.t_q = t_q;
  p.ks = split ? ks : 1;
  p.causal = causal; p.window = window; p.sink = sink; p.q_offset = q_offset;
  p.q_seg = static_cast<const int*>(q_seg);
  p.kv_seg = static_cast<const int*>(kv_seg);
  p.bits = static_cast<const int*>(bits);
  p.q_seg_sb = q_seg_sb; p.kv_seg_sb = kv_seg_sb; p.n_vis = n_vis;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // Head dims 128 (qwen3) and 64 (whisper); without and with segments (null
  // ids: none); the compact schedule (table; with segments, step bits) or
  // the dense one (no table, no bits); single-pass, or (compact only)
  // split-KV partials (o, lse) folded into (o_fold, lse_fold).
  if (block_q != 16 * kWarps || block_kv != kBlockN || ks < 1) return cudaErrorInvalidValue;
  if (split && (dense || o_fold == nullptr || lse_fold == nullptr))
    return cudaErrorInvalidValue;
  const bool seg = q_seg != nullptr;
  if (dense ? table != nullptr : table == nullptr || (seg && bits == nullptr))
    return cudaErrorInvalidValue;
  auto* of = static_cast<__nv_bfloat16*>(o_fold);
  auto* lf = static_cast<float*>(lse_fold);
  if (head_dim == 128) return dispatch<128>(p, batch, seg, split != 0, dense != 0, s, of, lf);
  if (head_dim == 64) return dispatch<64>(p, batch, seg, split != 0, dense != 0, s, of, lf);
  return cudaErrorInvalidValue;
}
