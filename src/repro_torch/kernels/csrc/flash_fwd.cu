// FlashAttention-2 forward for Hopper (sm_90a), bf16 in, f32 softmax.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_fwd.py:354
// flash_fwd: its compact body _fwd_kernel_compact (:248), its dense body
// _fwd_kernel_dense (:206), their segment branches (:388/:478), and the
// banded and kv-split launch _flash_fwd_partitioned (:510, body
// _fwd_kernel_partitioned :290). On the TPU the q tiles are dealt into
// bands to fill the cores; here the q tile is an ordinary parallel grid
// axis, so one launch covers the bands.
//
// What bounds it on an H100: a causal prefill at head_dim 128 does about
// 4 * S^2/2 * D flops per head against 2 * S * D * 2 bytes of K/V, so for
// S in the hundreds and up it is bound by the tensor cores (989 TFLOP/s
// bf16), not by HBM (3.35 TB/s). Only wgmma reaches that rate, fed by TMA
// copies that cost the SMs no instructions, with warps that wait on
// mbarriers instead of CTA-wide barriers. The design is FlashAttention-3's
// forward (Shah et al., 2024), built from the primitives of sm90.cuh that
// the backward uses:
//   * one CTA per (pair of 64-row q tiles 2m, 2m + 1, batch * q head, kv
//     split): 384 threads, a producer warpgroup (one warp works;
//     setmaxnreg lowers it to 24 registers) and two consumer warpgroups
//     (raised to 240), one per q tile, each holding its 64 rows' O as an
//     f32 wgmma accumulator in registers. High pairs (the longest causal
//     walks) start first. An odd t_q leaves the last CTA one tile; its
//     second warpgroup computes and writes nothing;
//   * the producer walks the ascending union of the two q tiles' slices of
//     the q-major CSR (with kv splits, of owners 2m ks + s and (2m + 1) ks
//     + s; PairWalk with group 1, kernels/schedule.py pair_walk), reading
//     each slice once, or under DENSE every kv tile, which it classifies
//     for both q tiles. It loads the pair's Q once, then K_j and V_j of
//     every step by TMA (boxes of 64 rows x 64 columns over 4-d (D, H, S,
//     B) maps of the strided tensors, 128-byte swizzled, rows past the end
//     zero-filled) into a 4-stage ring with full and empty mbarriers, and
//     hands each step over as a record (kv tile; per q tile: takes it,
//     needs the element mask). Under SEG, when a tile needs the element
//     mask, its lanes copy the kv tile's 64 segment ids into the stage by
//     cp.async, which the stage's full barrier also waits for (the id loads
//     stay off the producer's path); a step that neither tile takes
//     actively is never produced. The consumers read no table;
//   * per step and consumer warpgroup: S = Q K^T (wgmma m64n64k16, Q as
//     bf16 A fragments in registers, read once with ldmatrix, K K-major
//     from shared memory); the element mask where the record asks for it,
//     on the accumulator fragment (row 16 (warp % 4) + lane / 4 (+8),
//     column 8 t + 2 (lane % 4) (+1)); the online softmax in the exp2
//     domain, p = exp2(s log2 e - m log2 e) with one FFMA and one MUFU.EX2
//     a score, the row sums kept per thread and reduced once at the end; P
//     rounded to bf16 in registers as the A operand of O += P V (m64nDk16,
//     V read MN-major). A warpgroup whose tile does not take a step only
//     releases the stage (a decision uniform in the warpgroup);
//   * the warpgroup overlaps its own steps (FlashAttention-3's
//     intra-warpgroup pipelining): it issues step j's S = Q K^T and step
//     j - 1's O += P V together, then runs step j's mask and softmax while
//     the P V product runs, and only then rescales O and releases step
//     j - 1's stage. When its tile skips a step it first finishes the
//     pending product, so it never holds a stage the producer waits for;
//   * ptxas serialises every wgmma of a kernel whose products it cannot
//     prove warp-uniform and whose accumulators it sees defined between a
//     product's issue and its wait. So the step record and the warpgroup
//     index are broadcast from lane 0 (uniform branches), and every taken
//     step issues both products, the first of a run with P = 0 (O += 0);
//     with both in place ptxas reports no serialisation;
//   * the epilogue applies 1/l once (paper C1), writes bf16 O through the
//     warpgroup's own Q tile in shared memory (free by then) with 16-byte
//     coalesced stores, and lse in natural log. No atomics: the forward is
//     bitwise the same from run to run.
// FlashAttention-3's ping-pong (the warpgroups taking turns at the tensor
// cores by named barriers) was measured and not kept: it lost at head_dim
// 128 and won a little at 64 (PERF.md).
// What bounds it now: one CTA an SM (384 threads at 168 registers; 162 KB
// of shared memory at head_dim 128, 82 KB at 64), so a CTA's prologue (Q's
// and the first tiles' loads) and epilogue are not hidden behind another
// CTA; 64-column steps (the tables' granularity), so the O rescale, the
// waits and the record hand-over come every 64 keys; 32 KB of K and V a
// step from L2 for 128 q rows at head_dim 128; causal pairs finish
// unevenly in the last wave. Under SEG the producer reads each step's bits
// from memory before it can hand the step over, which shows at head_dim 64
// (shorter steps); a register window over the slices spilled or lost.
//
// Semantics match the JAX kernel: masked scores take the finite
// DEFAULT_MASK_VALUE, K/V rows past the end read as zeros, the kv head of
// q head h is h / group, rows that visit no tile give O = 0, lse = -inf.
// In the exp2 domain a hidden score is kHidden (sm90.cuh), so a row that
// sees no key inside a visited tile gets P = 1 on its 64 columns and lse =
// DEFAULT_MASK_VALUE + log(l), and a later tile with keys rescales that by
// exp2(kHidden log2 e - m) = 0, as the natural-log kernel does.
//
// Packed (varlen) batches take the SEG instantiation, which replaces the
// segment branch of the same Pallas kernel (fa2_fwd_compact_varlen). Beside
// the table it reads int32 segment ids of q and kv and a (B, n_visible)
// table of per-step bits computed before the launch (kernels/schedule.py
// segment_step_bits): a step without SEG_ACTIVE is dropped from its tile's
// slice, so a step that neither tile needs costs neither a copy nor a
// product; a step applies the element mask when it is flagged masked or
// lacks SEG_UNIFORM, and the mask then also needs q_id == kv_id. A
// consumer's q ids sit in registers (two rows a thread), the kv tile's ids
// travel with its stage (256 bytes) when the step needs the mask.
//
// The SPLIT instantiation replaces the kv_splits > 1 mode of
// _flash_fwd_partitioned. Its grid gains a third axis, the kv split: the
// CTA of (pair m, split s) walks owners 2m ks + s and (2m + 1) ks + s of
// the split table (kernels/schedule.py build_split_schedule), and writes
// each tile's locally normalised o and lse as f32 partials (B, Hq, ks, Sq,
// D) / (B, Hq, ks, Sq); an owner with no step writes (0, -inf), the merge
// identity. A second launch on the same stream, fa2_fwd_fold_kernel, folds
// the splits in one pass (one CTA of D threads per (q row, batch * q
// head), the logsumexp of the split lse, then o = sum_s exp(lse_s - m) o_s
// / l) into the single-pass kernel's outputs, bf16 o (B, Sq, Hq, D) and
// f32 lse (B, Hq, Sq). What it is for: a short query against a long key
// set (whisper's cross-attention, 4 prompt rows against 1500 frames) is one
// q tile, so the single-pass grid has only batch * heads CTAs (32 at B =
// 4) on 132 SMs, each walking every kv tile in series; the work is bound by
// the bytes of K and V, read at the card's rate only when enough CTAs are
// in flight. Splits multiply the CTAs by ks and cut each walk to 1/ks. At
// Sq <= 64 the pair has one tile, so half of each such CTA idles. SPLIT is
// instantiated at every head dim, with and without SEG. Its epilogue writes
// O's f32 partial straight from the accumulator registers: register 4 tt +
// i of a consumer thread is column 8 tt + 2 t4 (+1), the mapping that the
// bf16 epilogue's staging uses, and at 160 (an n128 and an n32 accumulator)
// and 256 (two n128) the second accumulator's registers follow the first's,
// so tt runs over every column, the tail's 128-159 included. A split whose
// range holds no step of a tile hands over only the end record: its
// consumers read that record and write the merge identity (0, -inf). The
// fold kernel runs D threads a row (five warps at 160).
//
// The DENSE instantiation (with and without SEG; never with SPLIT, which
// the JAX package refuses under the dense schedule, flash_fwd.py:391) reads
// no table: the producer walks every kv tile j = 0 .. t_kv - 1, fetches it
// (and with SEG its ids), and classifies it for both q tiles (classify_tile
// below, the JAX _visibility :71 and kernels/flash_fwd.py visibility; with
// SEG on the min and max of each q tile's ids, reduced once, and of the
// staged kv ids). Hidden tiles are fetched on purpose: the TPU dense grid
// DMAs every block (flash_fwd.py:27-30), and that cost is what the compact
// schedule saves, so this instantiation is its measurable baseline. A q
// tile takes exactly the compact walk's steps, in the same order with the
// same mask decisions and the same products, so o and lse are the compact
// kernel's to the bit, with and without segments.
//
// Head dims: every variant is instantiated at 128 (qwen3) and 64
// (whisper); a 64-row tile is D / 64 TMA boxes of 64 rows x 128 bytes. At
// 256 (gemma3) and 160 (stablelm, below) every variant is instantiated
// too: compact without SEG (the serving prefill's) and with it (packed
// training's), DENSE without and with SEG (dense-schedule training), and
// SPLIT without and with SEG (the short-q/long-kv corner, a split prefill,
// packed training with a split forward). At 256 the same design needs two
// changes to fit an SM:
//   * registers: a consumer's O is 64 x 256 f32, 128 registers a thread;
//     with Q as register fragments (64 more), S (32) and P (16) it would
//     exceed setmaxnreg's 240. So Q stays in shared memory and S = Q K^T
//     reads both operands from there (wgmma with A from shared memory, as
//     FlashAttention-3 does at 256); P V is two n128 products a k-step;
//   * shared memory: a 64-row tile is 32 KB, so the pair's Q (64 KB) and a
//     4-stage K/V ring (256 KB) exceed the 227 KB a CTA may use; the ring
//     has 2 stages (192 KB in all). A warpgroup holds two stages at once
//     (the pending P V's and the step's S), so the producer can refill a
//     stage only after the step's softmax: at 256 the copies of the next
//     step are not hidden behind a whole step.
// At gemma3's prefill (B 1, S 1536, 4 q heads: 48 CTAs on 132 SMs) the 256
// kernel takes about 14x its bound, 1.54x SDPA's forward (PERF.md row 1g).
// At 160 (stablelm-12b), 160 is not a whole number of 64-column boxes. Of
// the two layouts a tile could take, three 128-byte-swizzled boxes (the
// third half past the tensor, zero-filled by TMA: 24 KB a tile, a 3-stage
// ring, P V as n128 + n64 into a 96-column accumulator a third of which is
// zeros) or two such
// boxes and a tail box of the last 32 columns, 64-byte swizzled, this
// kernel takes the second: a tile is exactly 20 KB, so the pair's Q (40 KB)
// and a 4-stage K/V ring (160 KB) fit in 206 KB; S = Q K^T takes its k-steps
// 8 and 9 from the tail box through a 64-byte-swizzle descriptor
// (sm90.cuh kmajor_desc), P V is an n128 and an n32 product a k-step
// (wgmma_rs_k64<160>), and no product or register holds a column that is
// not there. The cost is a second tensor map per operand (load_tile) and a
// second swizzle in the Q fragments' and the epilogue's addressing
// (tile_off). O is 80 registers a consumer thread, Q's fragments 40, S 32
// and P 16, within setmaxnreg's 240, so Q stays in registers. Every
// expect_tx counts the whole tile, boxes and tail alike (D * 64 * 2 bytes).
// SEG at 160 and 256 is the 64/128 code unchanged: ids are per row, so the
// tail box and Q in shared memory change no id addressing; the element mask
// acts on S's n64 fragment only, never on O's (the n128 + n32 or 2 x n128
// P V products); a consumer adds its two q ids to O's registers, and each
// stage's 64 kv ids (256 bytes) sit beside its step record.
// DENSE at 160 and 256 (with and without SEG) is the 64/128 code unchanged
// too: only the producer walks and classifies, the consumers read records.
// The 2-stage ring at 256 holds under it: a warpgroup holds at most the
// pending step's stage and the current one and frees them in the order it
// took them (the pending one after the step's softmax, or at once when its
// tile skips the step), so when both warpgroups have read step n's record
// step n - 1's stage is free, and that is the one the producer waits on
// for step n + 1. Long runs of steps hidden from both tiles (past the
// diagonal, outside the window) are fetched and freed one a step. The
// stages' kv ids fit beside the ring at 256 (512 bytes of 232,448).

#include <math.h>

#include "sm90.cuh"

namespace {

constexpr int kBlockM = 64;             // q rows of a tile: one consumer warpgroup's
constexpr int kBlockN = 64;             // kv rows of a step
constexpr int kThreads = 3 * 128;       // producer warpgroup, two consumer warpgroups
constexpr int kConsumers = 2 * 128;

// Stages of the K/V ring: 4, or 2 at head_dim 256 (shared memory).
template <int D>
__host__ __device__ constexpr int fwd_stages() {
  return D == 256 ? 2 : 4;
}

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

// The TMA maps of one launch: q, k and v, each a 4-d (D, H, S, B) view of
// the strided tensor, boxes of 64 rows x 64 columns, 128-byte swizzled; at
// head_dim 160 also their tail maps, boxes of 64 rows x 32 columns (columns
// 128-159), 64-byte swizzled.
struct FwdMaps {
  CUtensorMap q, k, v;
  CUtensorMap q_tail, k_tail, v_tail;
};

// Shared memory, in bytes from a 1024-aligned base: the pair's two Q tiles,
// the K and V stages, each stage's kv ids (SEG) and step record, then the
// mbarriers. A 64-row tile is D / 64 boxes of 64 rows x 128 bytes (8 KB),
// and at 160 a tail box of 64 rows x 64 bytes (4 KB): 20 KB, every tile
// 1024-aligned.
template <int D>
struct FwdSmem {
  static constexpr int STAGES = fwd_stages<D>();
  static constexpr uint32_t TILE = D * kBlockM * 2;
  static constexpr uint32_t Q = 0;
  static constexpr uint32_t K = 2 * TILE;
  static constexpr uint32_t V = K + STAGES * TILE;
  static constexpr uint32_t KID = V + STAGES * TILE;
  static constexpr uint32_t STEP = KID + STAGES * kBlockN * 4;
  static constexpr uint32_t BARS = STEP + STAGES * 8;  // full, empty, q
  static constexpr uint32_t BYTES = BARS + (2 * STAGES + 1) * 8;
};

// 2^x, flushing results below the normal range to 0 (one MUFU.EX2).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
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

template <int D, bool SEG, bool SPLIT, bool DENSE>
__global__ void __launch_bounds__(kThreads, 1)
    fa2_fwd_kernel(const FwdParams p, const __grid_constant__ FwdMaps maps) {
  static_assert(D == 64 || D == 128 || D == 160 || D == 256,
                "the forward takes head_dim 64, 128, 160 or 256");
  using L = FwdSmem<D>;
  constexpr int kStages = L::STAGES;
  constexpr bool QSS = D == 256;  // Q read from shared memory by every S = Q K^T
  constexpr bool SKIP = SEG && !DENSE;  // inactive steps are dropped before their fetch
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t* empty = full + kStages;
  uint64_t* q_bar = empty + kStages;
  int* sKid = reinterpret_cast<int*>(sm + L::KID);
  // Per stage: (kv tile, step flags); a negative tile ends the walk. The
  // producer walks and classifies; the consumers read this.
  int2* sStep = reinterpret_cast<int2*>(sm + L::STEP);

  const int i0 = 2 * ((p.t_q + 1) / 2 - 1 - static_cast<int>(blockIdx.x));  // longest walks first
  const bool has1 = i0 + 1 < p.t_q;  // an odd t_q leaves the last pair one tile
  const int bh = blockIdx.y;
  const int split = SPLIT ? blockIdx.z : 0;
  const int b = bh / p.Hq, h = bh % p.Hq, hk = h / p.group;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes; TMA bytes on top
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warp-uniform (see rec)
  if (wg == 0) {
    // Producer: one warp. Q once; then, per step of the walk, K_j and V_j
    // by TMA, the kv tile's ids by the lanes (SEG), and the step's record.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                         smem_u32(q_bar)),
                     "r"((has1 ? 2 : 1) * L::TILE)
                     : "memory");
        for (int x = 0; x < (has1 ? 2 : 1); ++x)
          load_tile<D>(sm + L::Q + x * L::TILE, maps.q, maps.q_tail, q_bar, h, (i0 + x) * kBlockM,
                       b);
      }
      PairWalk<SKIP, DENSE> walk;
      walk.group = 1;
      walk.n_tiles = (p.Skv + kBlockN - 1) / kBlockN;
      walk.g = 0;
      if (DENSE) {
        walk.steps = walk.bits = nullptr;
        walk.a0 = walk.a1 = walk.b0 = walk.b1 = 0;
      } else {
        const int own = i0 * p.ks + split;  // tile i0's owner; tile i0 + 1's is ks on
        walk.steps = p.table + p.t_q * p.ks + 1;
        walk.bits = SKIP ? p.bits + static_cast<long long>(b) * p.n_vis : nullptr;
        walk.a0 = p.table[own];
        walk.a1 = p.table[own + 1];
        walk.b0 = has1 ? p.table[own + p.ks] : 0;
        walk.b1 = has1 ? p.table[own + p.ks + 1] : 0;
      }
      walk.ia = walk.a0;
      walk.ib = walk.b0;
      const int* kid_g = SEG ? p.kv_seg + b * p.kv_seg_sb : nullptr;
      int q_lo[2] = {0, 0}, q_hi[2] = {0, 0};  // DENSE with SEG: each q tile's id range
      if (DENSE && SEG) {
        const int* qid_g = p.q_seg + b * p.q_seg_sb;
        for (int x = 0; x < 2; ++x) {
          int lo = 0x7fffffff, hi = -0x7fffffff;
          for (int r = (i0 + x) * kBlockM + lane; r < (i0 + x + 1) * kBlockM; r += 32) {
            const int id = r < p.Sq ? qid_g[r] : kQPadSegment;
            lo = min(lo, id);
            hi = max(hi, id);
          }
          warp_range(lo, hi);
          q_lo[x] = lo;
          q_hi[x] = hi;
        }
      }
      int g, j, ea, eb;
      // (A `break` out of this loop crashes ptxas 12.9; the loop ends on `more`.)
      bool more = true;
      for (int n = 0; more; ++n) {
        more = walk.next(g, j, ea, eb);
        const int stage = n % kStages;
        mbar_wait(&empty[stage], ((n / kStages) & 1) ^ 1);
        if (!more) {  // the walk's end: a record with a negative tile, no copies
          if (lane == 0) sStep[stage] = make_int2(-1, 0);
          mbar_arrive(&full[stage]);
          continue;
        }
        const int k0 = j * kBlockN;
        if (lane == 0) {
          mbar_expect_tx(&full[stage], 2 * L::TILE);
          load_tile<D>(sm + L::K + stage * L::TILE, maps.k, maps.k_tail, &full[stage], hk, k0, b);
          load_tile<D>(sm + L::V + stage * L::TILE, maps.v, maps.v_tail, &full[stage], hk, k0, b);
        }
        // Which tiles take the step, and which need the element mask: the
        // table's flags and step bits, or under DENSE the classifier (with
        // SEG on both tiles' id ranges, so it reads the kv ids first).
        int flags = 0;
        if (DENSE) {
          int lo = 0x7fffffff, hi = -0x7fffffff;
          if (SEG) {
            for (int r = lane; r < kBlockN; r += 32) {
              const int id = k0 + r < p.Skv ? kid_g[k0 + r] : kKvPadSegment;
              sKid[stage * kBlockN + r] = id;
              lo = min(lo, id);
              hi = max(hi, id);
            }
            warp_range(lo, hi);
          }
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            TileClass c = classify_tile<kBlockM, kBlockN>(p.causal, p.window, p.sink, p.Skv,
                                                          (i0 + x) * kBlockM + p.q_offset, k0);
            if (SEG) c = with_ids(c, q_lo[x], q_hi[x], lo, hi);
            if ((x == 0 || has1) && !c.empty)
              flags |= (x ? kTake1 : kTake0) | (c.mask ? (x ? kMask1 : kMask0) : 0);
          }
        } else {
          if (ea >= 0)
            flags |= kTake0 | ((walk.steps[ea] & 1) || (SEG && !(walk.bits[ea] & kSegUniform))
                                   ? kMask0 : 0);
          if (eb >= 0)
            flags |= kTake1 | ((walk.steps[eb] & 1) || (SEG && !(walk.bits[eb] & kSegUniform))
                                   ? kMask1 : 0);
          // Only the element mask reads the kv ids: copy them when a tile
          // needs it, by cp.async, whose completion the stage's full barrier
          // also waits for. A row past Skv reads 0; the mask hides its
          // column anyway (visible() is false past Skv).
          if (SEG && (flags & (kMask0 | kMask1))) {
            for (int r = lane; r < kBlockN; r += 32) {
              const bool in = k0 + r < p.Skv;
              asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                               smem_u32(sKid + stage * kBlockN + r)),
                           "l"(kid_g + (in ? k0 + r : 0)), "r"(in ? 4 : 0)
                           : "memory");
            }
            asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(
                             smem_u32(&full[stage]))
                         : "memory");
          }
        }
        if (lane == 0) sStep[stage] = make_int2(j, flags);
        mbar_arrive(&full[stage]);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    // Consumer warpgroup w owns q tile i0 + w: rows q0 .. q0 + 63.
    const int w = wg - 1;
    const int t = threadIdx.x - 128 * wg;
    const int wq = t / 32, lane = t % 32, g8 = lane / 4, t4 = lane % 4;
    const int q0 = (i0 + w) * kBlockM;
    const int r_a = wq * 16 + g8;  // this thread's rows of the tile: r_a, r_a + 8
    const int row_a = q0 + r_a, row_b = row_a + 8;
    int qid[2] = {0, 0};
    if (SEG) {
      const int* qid_g = p.q_seg + b * p.q_seg_sb;
      qid[0] = row_a < p.Sq ? qid_g[row_a] : kQPadSegment;
      qid[1] = row_b < p.Sq ? qid_g[row_b] : kQPadSegment;
    }
    const int take = w ? kTake1 : kTake0, needs_mask = w ? kMask1 : kMask0;
    const uint32_t sQ = smem_u32(sm + L::Q) + w * L::TILE;
    const uint32_t sK = smem_u32(sm + L::K), sV = smem_u32(sm + L::V);

    // O of the tile: rows r_a / r_a + 8, columns 8 tt + 2 t4 (+1).
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m_r[2] = {-INFINITY, -INFINITY};  // the rows' running max
    float m_s[2] = {-INFINITY, -INFINITY};  // the same times log2(e)
    float l_r[2] = {0.f, 0.f};              // this thread's share of the row sums
    uint32_t pc[4][4];  // P of the pending step: bf16 A fragments of O += P V
    int pend = -1;      // the stage whose O += P V is not issued yet

    mbar_wait(q_bar, 0);
    // Q as bf16 A fragments in registers, read once from its swizzled tile
    // (QSS: left in shared memory).
    uint32_t qf[QSS ? 1 : D / 16][4];
    if constexpr (!QSS) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int row = wq * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int col = kk * 16 + (lane >> 4) * 8;
        const uint32_t at = sQ + tile_off<D>(row, col);
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                     : "=r"(qf[kk][0]), "=r"(qf[kk][1]), "=r"(qf[kk][2]), "=r"(qf[kk][3])
                     : "r"(at));
      }
    }
    for (int n = 0;; ++n) {
      const int stage = n % kStages;
      mbar_wait(&full[stage], (n / kStages) & 1);
      // The record, broadcast from lane 0: ptxas then sees the branches
      // around the wgmmas as warp-uniform and does not serialise them.
      int2 rec = sStep[stage];
      rec.x = __shfl_sync(0xffffffffu, rec.x, 0);
      rec.y = __shfl_sync(0xffffffffu, rec.y, 0);
      if (rec.x < 0) break;
      if (!(rec.y & take)) {
        // Not this tile's step: finish the pending product, so that no stage
        // stays held while the producer waits for it, and release both.
        if (pend >= 0) {
          wgmma_fence();
          wgmma_rs_k64<D>(o, pc, sV + pend * L::TILE);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(o);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) fence_regs(pc[kk]);
          mbar_arrive(&empty[pend]);
          pend = -1;
        }
        mbar_arrive(&empty[stage]);
        continue;
      }
      const int j = rec.x;
      const uint32_t cK = sK + stage * L::TILE;

      // S = Q K^T (64 x 64, Q from registers or with QSS from its tile, K
      // over head_dim in its tile's swizzled boxes, both K-major), issued
      // together with the pending step's O += P V.
      // The first step of a run has none pending: it issues one with P = 0
      // (O += 0 exactly), so the products and their waits are the same on
      // every taken step; with them conditional, ptxas serialises every
      // wgmma of the kernel.
      const bool first = pend < 0;
      if (first)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) pc[kk][e] = 0u;
      float s[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t kd = kmajor_desc<D>(cK, kk);
        if constexpr (QSS)
          wgmma_ss_n64<0, 0>(s, kmajor_desc<D>(sQ, kk), kd, kk > 0);
        else
          wgmma_rs_n64<0>(s, qf[kk], kd, kk > 0);
      }
      wgmma_commit();
      wgmma_rs_k64<D>(o, pc, sV + (first ? stage : pend) * L::TILE);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);

      // The element mask: element i of n-block tt is row row_a (i < 2) or
      // row_b, kv column j * 64 + 8 tt + 2 t4 + (i & 1); hidden: kHidden.
      if (rec.y & needs_mask) {
        const int* cKid = sKid + stage * kBlockN;
#pragma unroll
        for (int tt = 0; tt < 8; ++tt) {
          const int cc = tt * 8 + 2 * t4;
          int2 kid = make_int2(0, 0);
          if (SEG) kid = *reinterpret_cast<const int2*>(cKid + cc);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            bool vis = visible(p, (i < 2 ? row_a : row_b) + p.q_offset, j * kBlockN + cc + (i & 1));
            if (SEG) vis = vis && qid[i >> 1] == ((i & 1) ? kid.y : kid.x);
            if (!vis) s[4 * tt + i] = kHidden;
          }
        }
      }

      // Online softmax (FA2 Algorithm 1 lines 8-10, un-rescaled accumulator)
      // in the exp2 domain.
      float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
      for (int tt = 0; tt < 8; ++tt) {
        mx[0] = fmaxf(mx[0], fmaxf(s[4 * tt], s[4 * tt + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[4 * tt + 2], s[4 * tt + 3]));
      }
      float ms[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        ms[r] = mx[r] * kLog2e;
        alpha[r] = exp2_ftz(m_s[r] - ms[r]);  // 0 on the first visit (m_s = -inf)
      }
#pragma unroll
      for (int tt = 0; tt < 8; ++tt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[4 * tt + i] = exp2_ftz(fmaf(s[4 * tt + i], kLog2e, -ms[i >> 1]));
          rs[i >> 1] += s[4 * tt + i];
        }
      }
      uint32_t pn[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pn[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pn[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pn[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pn[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
      wgmma_wait<0>();  // the pending O += P V is done: its stage is free
      fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(pc[kk]);
      if (!first) mbar_arrive(&empty[pend]);
#pragma unroll
      for (int tt = 0; tt < D / 8; ++tt) {
        o[4 * tt] *= alpha[0];
        o[4 * tt + 1] *= alpha[0];
        o[4 * tt + 2] *= alpha[1];
        o[4 * tt + 3] *= alpha[1];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l_r[r] = l_r[r] * alpha[r] + rs[r];
        m_r[r] = mx[r];
        m_s[r] = ms[r];
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) pc[kk][e] = pn[kk][e];
      pend = stage;
    }
    if (pend >= 0) {  // the last step's O += P V
      wgmma_fence();
      wgmma_rs_k64<D>(o, pc, sV + pend * L::TILE);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(pc[kk]);
      mbar_arrive(&empty[pend]);
    }

    // Finalize: the row sums over the row's four threads, one 1/l per row
    // (C1), the natural-log lse. A row that saw nothing has o = 0, l = 0.
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
      inv[r] = l_r[r] == 0.f ? 1.f : 1.f / l_r[r];
    }
    if (t4 == 0) {
      float* lg = p.lse + (static_cast<long long>(bh) * p.ks + split) * p.Sq;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r ? row_b : row_a;
        if (row < p.Sq)
          lg[row] = l_r[r] == 0.f ? -INFINITY
                                  : (m_r[r] == kHidden ? kMaskValue : m_r[r]) + logf(l_r[r]);
      }
    }
    if (SPLIT) {
      float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh + split * p.o_split;
#pragma unroll
      for (int tt = 0; tt < D / 8; ++tt) {
        const int col = tt * 8 + 2 * t4;
        if (row_a < p.Sq)
          *reinterpret_cast<float2*>(og + row_a * p.o_ss + col) =
              make_float2(o[4 * tt] * inv[0], o[4 * tt + 1] * inv[0]);
        if (row_b < p.Sq)
          *reinterpret_cast<float2*>(og + row_b * p.o_ss + col) =
              make_float2(o[4 * tt + 2] * inv[1], o[4 * tt + 3] * inv[1]);
      }
    } else {
      // bf16 O through this warpgroup's Q tile (its values are in registers
      // since the start; with QSS its last reader, the last S = Q K^T, has
      // completed), in TMA's 128-byte swizzle (conflict-free pair stores),
      // then 16-byte chunks of rows to memory.
      unsigned char* stg = sm + L::Q + w * L::TILE;
      named_sync(1 + w, 128);  // every warp has read its Q fragments
#pragma unroll
      for (int tt = 0; tt < D / 8; ++tt) {
        *reinterpret_cast<uint32_t*>(stg + tile_off<D>(r_a, 8 * tt) + t4 * 4) =
            pack_bf16(o[4 * tt] * inv[0], o[4 * tt + 1] * inv[0]);
        *reinterpret_cast<uint32_t*>(stg + tile_off<D>(r_a + 8, 8 * tt) + t4 * 4) =
            pack_bf16(o[4 * tt + 2] * inv[1], o[4 * tt + 3] * inv[1]);
      }
      named_sync(1 + w, 128);
      __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
      constexpr int CH = D / 8;  // 16-byte chunks a row
      for (int idx = t; idx < kBlockM * CH; idx += 128) {
        const int r = idx / CH, c = idx % CH;
        if (q0 + r < p.Sq)
          *reinterpret_cast<uint4*>(og + (q0 + r) * p.o_ss + c * 8) =
              *reinterpret_cast<const uint4*>(stg + tile_off<D>(r, 8 * c));
      }
    }
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

template <int D, bool SEG, bool SPLIT, bool DENSE = false>
cudaError_t launch(const FwdParams& p, int batch, int Hkv, cudaStream_t stream,
                   __nv_bfloat16* o_fold, float* lse_fold) {
  FwdMaps maps;
  if (!make_map(&maps.q, p.q, batch, p.Sq, p.Hq, D, p.q_sb, p.q_ss, p.q_sh, kBlockM) ||
      !make_map(&maps.k, p.k, batch, p.Skv, Hkv, D, p.k_sb, p.k_ss, p.k_sh, kBlockN) ||
      !make_map(&maps.v, p.v, batch, p.Skv, Hkv, D, p.v_sb, p.v_ss, p.v_sh, kBlockN))
    return cudaErrorInvalidValue;
  if (D % 64 != 0 &&  // the tail boxes of head_dim 160
      (!make_map(&maps.q_tail, p.q, batch, p.Sq, p.Hq, D, p.q_sb, p.q_ss, p.q_sh, kBlockM, 32) ||
       !make_map(&maps.k_tail, p.k, batch, p.Skv, Hkv, D, p.k_sb, p.k_ss, p.k_sh, kBlockN, 32) ||
       !make_map(&maps.v_tail, p.v, batch, p.Skv, Hkv, D, p.v_sb, p.v_ss, p.v_sh, kBlockN, 32)))
    return cudaErrorInvalidValue;
  auto kernel = fa2_fwd_kernel<D, SEG, SPLIT, DENSE>;
  const size_t smem = FwdSmem<D>::BYTES + 1024;  // + the 1024-byte alignment of the base
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.t_q + 1) / 2, batch * p.Hq, p.ks);
  kernel<<<grid, kThreads, smem, stream>>>(p, maps);
  if constexpr (SPLIT) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    fa2_fwd_fold_kernel<D><<<dim3(p.Sq, batch * p.Hq), D, 0, stream>>>(p, o_fold, lse_fold);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch(const FwdParams& p, int batch, int Hkv, bool seg, bool split, bool dense,
                     cudaStream_t s, __nv_bfloat16* of, float* lf) {
  if (dense)
    return seg ? launch<D, true, false, true>(p, batch, Hkv, s, of, lf)
               : launch<D, false, false, true>(p, batch, Hkv, s, of, lf);
  if (seg)
    return split ? launch<D, true, true>(p, batch, Hkv, s, of, lf)
                 : launch<D, true, false>(p, batch, Hkv, s, of, lf);
  return split ? launch<D, false, true>(p, batch, Hkv, s, of, lf)
               : launch<D, false, false>(p, batch, Hkv, s, of, lf);
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
  // Head dims 128 (qwen3), 64 (whisper), 256 (gemma3) and 160 (stablelm);
  // without and with segments (null ids: none); the compact schedule
  // (table; with segments, step bits) or the dense one (no table, no bits);
  // single-pass, or (compact only) split-KV partials (o, lse) folded into
  // (o_fold, lse_fold).
  if (block_q != kBlockM || block_kv != kBlockN || ks < 1 || t_q < 1) return cudaErrorInvalidValue;
  if (split && (dense || o_fold == nullptr || lse_fold == nullptr))
    return cudaErrorInvalidValue;
  const bool seg = q_seg != nullptr;
  if (dense ? table != nullptr : table == nullptr || (seg && bits == nullptr))
    return cudaErrorInvalidValue;
  auto* of = static_cast<__nv_bfloat16*>(o_fold);
  auto* lf = static_cast<float*>(lse_fold);
  if (head_dim == 128)
    return dispatch<128>(p, batch, Hkv, seg, split != 0, dense != 0, s, of, lf);
  if (head_dim == 64) return dispatch<64>(p, batch, Hkv, seg, split != 0, dense != 0, s, of, lf);
  if (head_dim == 256)
    return dispatch<256>(p, batch, Hkv, seg, split != 0, dense != 0, s, of, lf);
  if (head_dim == 160)
    return dispatch<160>(p, batch, Hkv, seg, split != 0, dense != 0, s, of, lf);
  return cudaErrorInvalidValue;
}
