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
// unevenly in the last wave (at 160 and 256 the grid's order answers that,
// below). Under SEG the producer reads each step's bits
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
// the splits in one pass (the logsumexp of the split lse, then o = sum_s
// exp(lse_s - m) o_s / l) into the single-pass kernel's outputs, bf16 o
// (B, Sq, Hq, D) and f32 lse (B, Hq, Sq). What it is for: a short query
// against a long key set (whisper's cross-attention, 4 prompt rows against
// 1500 frames) is one q tile, so the single-pass grid has only batch *
// heads CTAs (32 at B = 4) on 132 SMs, each walking every kv tile in
// series; the work is bound by the bytes of K and V, read at the card's
// rate only when enough CTAs are in flight. Splits multiply the CTAs by ks
// and cut each walk to 1/ks. At Sq <= 64 the pair kernel (64, 128) has one
// tile, so half of each such CTA idles (the wide kernel takes one q tile a
// CTA there). SPLIT is
// instantiated at every head dim, with and without SEG. Its epilogue writes
// O's f32 partial straight from the accumulator registers: register 4 tt +
// i of a consumer thread is column 8 tt + 2 t4 (+1), the mapping that the
// bf16 epilogue's staging uses, and at 160 (an n128 and an n32 accumulator)
// and 256 (two n128) the second accumulator's registers follow the first's,
// so tt runs over every column, the tail's 128-159 included. A split whose
// range holds no step of a tile hands over only the end record: its
// consumers read that record and write the merge identity (0, -inf).
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
// packed training with a split forward).
// At 256 and 160 the kernel is fa2_fwd_wide_kernel<D>, the same walk,
// records and consumer math redesigned around three limits of the SM:
//   * registers: at 256 a consumer's O is 64 x 256 f32, 128 registers a
//     thread; with Q as register fragments (64 more), S (32) and P (16) it
//     would exceed setmaxnreg's 240. So Q stays in shared memory there and
//     S = Q K^T reads both operands from it (wgmma with A from shared
//     memory, as FlashAttention-3 does at 256); P V is two n128 products a
//     k-step. At 160 O is 80 registers, Q's fragments 40, S 32 and P 16,
//     so Q is read once into registers (tools/ab_forward.py q_in_smem);
//   * shared memory: a tile is 32 KB at 256, so a pair's Q (64 KB) leaves
//     room for 2 stages of K and V; at 160 (20 KB) for 4. With one barrier
//     a stage, a warpgroup held two stages (the pending P V's and the
//     step's S) and the producer refilled a stage only after a step's
//     softmax. So K and V have their own full and empty barriers
//     (FlashAttention-3's two pipelines): a consumer frees K_j once S_j has
//     completed (and the mask has read the stage's ids), before its
//     softmax, and V_j after the O += P V that reads it. The producer loads
//     K of a position, then V of the one before: the next K lands while a
//     step's softmax and P V run. In pair mode a warpgroup whose tile skips
//     a step never touches that V; the producer frees it on its behalf
//     (count 128), after its own wait on the stage, so the arrival falls in
//     that use's phase;
//   * the grid: a pair of q tiles a CTA gives gemma3's prefill (B 1, S
//     1536, 4 q heads) 48 CTAs on 132 SMs, with causal walks of 1 to 47
//     tile-steps, and stablelm's short-q/long-kv corner (one q tile, 4
//     splits, 32 heads) 128 CTAs each with an idle warpgroup. Where the
//     pair grid is under one wave (kernels/flash_fwd.py single_q_tile: B Hq
//     ceil(t_q / 2) ks < 132, or t_q = 1), the wrapper launches one q tile
//     a CTA (SINGLE) and the producer deals the tile's taken steps to the
//     two warpgroups in turn, by their ordinal (the record's kTake0 /
//     kTake1; under DENSE only taken steps are produced, under SEG only
//     active ones, so dense and compact deal alike and stay bitwise
//     equal). Each warpgroup keeps its own m, l and O; a warpgroup reads
//     only its own positions of the ring (every second one), which has 3
//     stages at 256 (32 KB of Q + 6 x 32 KB) and 4 at 160. Under the deal a
//     warpgroup holds its pending V until its next step, two positions on:
//     with 2 V stages the producer would wait for a stage only the waiting
//     warpgroup could free; with 3 or more it waits for the other
//     warpgroup's previous step. A warpgroup waits on a barrier by parity,
//     which tells apart only adjacent phases, so it must see each phase of
//     every barrier it waits on: the 3-stage ring at 256 has 6 barrier
//     slots (position p: stage p mod 3, slot p mod 6, each slot one
//     warpgroup's); with one slot a stage a warpgroup's wait on stage s
//     could pass while the other's load three positions before was still
//     landing, and it then took that position's record and tiles for its
//     own: a wrong split partial in about one of 2000 launches at gemma3's
//     corner (32,768 keys, 33 splits; tools/stress_kernels.py), a hang of
//     the same launch in an earlier build. At the walk's end warpgroup 1
//     hands (O, m, l) to warpgroup 0 through the freed ring (named
//     barriers 3 and 4) and warpgroup 0 merges them in that fixed order (no atomics: the forward
//     stays bitwise the same from run to run) and writes the tile; SPLIT
//     merges before it writes its f32 partials, and a split with no step
//     writes (0, -inf). gemma3's prefill then runs 96 CTAs whose longest
//     walk is 24 tile-steps, 12 a warpgroup (47 before), and at the corner
//     (t_q = 1) the second warpgroup takes half of each split.
//     The grid puts batch * q head on x, the fastest axis of the block
//     dispatch, and the tiles, longest walks first, on y: the first wave
//     then holds the longest walks of every head (stablelm's prefill: 384
//     pair CTAs, 12 per head, walks of 2 to 24 tile-steps), where with the
//     tiles on x it held every walk of the first 11 heads and the longest
//     walks started last (tools/ab_forward.py tile_major_grid).
// At 160, 160 is not a whole number of 64-column boxes. Of the two layouts
// a tile could take, three 128-byte-swizzled boxes (the third half past the
// tensor, zero-filled by TMA: 24 KB a tile, P V as n128 + n64 into a
// 96-column accumulator a third of which is zeros) or two such boxes and a
// tail box of the last 32 columns, 64-byte swizzled, this kernel takes the
// second: a tile is exactly 20 KB; S = Q K^T takes its k-steps 8 and 9 from
// the tail box through a 64-byte-swizzle descriptor (sm90.cuh kmajor_desc),
// P V is an n128 and an n32 product a k-step (wgmma_rs_k64<160>), and no
// product or register holds a column that is not there. The cost is a
// second tensor map per operand (load_tile) and a second swizzle in the Q
// fragments' and the epilogue's addressing (tile_off). Every expect_tx
// counts the whole tile, boxes and tail alike (D * 64 * 2 bytes). The
// first step of a warpgroup's run issues its P = 0 product on a zero tile
// that the CTA clears at its start (there is room for one at 160), so a
// non-finite q row spoils only its own row; at 256 there is no room and the
// product reads the Q tile, so a non-finite q row turns its whole tile to
// NaN (the wrappers' stated precondition there).
// SEG at 160 and 256 works as at 64/128: ids are per row, so the tail box
// and Q in shared memory change no id addressing; the element mask acts on
// S's n64 fragment only, never on O's (the n128 + n32 or 2 x n128 P V
// products); a consumer adds its two q ids to O's registers, and each
// stage's 64 kv ids (256 bytes) sit beside its step record.
// DENSE at 160 and 256: only the producer walks and classifies, the
// consumers read records. In pair mode a step hidden from both tiles (past
// the diagonal, outside the window) fetches its K and no V (nothing would
// wait for V's bytes); in single mode the producer classifies first and
// produces only the steps its tile takes.
//
// The fold of SPLIT's partials (fa2_fwd_fold_kernel) is its own launch
// (fa2_fwd_fold_f32) after the walk's on the same stream; see its note.

#include <math.h>

#include "sm90.cuh"

namespace {

constexpr int kBlockM = 64;             // q rows of a tile: one consumer warpgroup's
constexpr int kBlockN = 64;             // kv rows of a step
constexpr int kThreads = 3 * 128;       // producer warpgroup, two consumer warpgroups
constexpr int kConsumers = 2 * 128;

// Stages of the K/V ring of the pair kernel (head_dim 64 and 128).
constexpr int kFwdStages = 4;

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
  // Head dims 160 and 256 only: one q tile a CTA
  // (fa2_fwd_wide_kernel<D, ..., true>) instead of a pair.
  int single;
};

// The TMA maps of one launch: q, k and v, each a 4-d (D, H, S, B) view of
// the strided tensor, boxes of 64 rows x 64 columns, 128-byte swizzled; at
// head_dim 160 also their tail maps, boxes of 64 rows x 32 columns (columns
// 128-159), 64-byte swizzled.
struct FwdMaps {
  CUtensorMap q, k, v;
  CUtensorMap q_tail, k_tail, v_tail;
};

// Shared memory of the pair kernel, in bytes from a 1024-aligned base: the
// pair's two Q tiles, the K and V stages, each stage's kv ids (SEG) and
// step record, then the mbarriers. A 64-row tile is D / 64 boxes of 64 rows
// x 128 bytes (8 KB), every tile 1024-aligned.
template <int D>
struct FwdSmem {
  static constexpr int STAGES = kFwdStages;
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
  static_assert(D == 64 || D == 128,
                "the pair kernel takes head_dim 64 or 128 (160, 256: fa2_fwd_wide_kernel)");
  using L = FwdSmem<D>;
  constexpr int kStages = L::STAGES;
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
    // Q as bf16 A fragments in registers, read once from its swizzled tile.
    uint32_t qf[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int row = wq * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      const int col = kk * 16 + (lane >> 4) * 8;
      const uint32_t at = sQ + tile_off<D>(row, col);
      asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                   : "=r"(qf[kk][0]), "=r"(qf[kk][1]), "=r"(qf[kk][2]), "=r"(qf[kk][3])
                   : "r"(at));
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

      // S = Q K^T (64 x 64, Q from registers, K over head_dim in its tile's
      // swizzled boxes, K-major), issued together with the pending step's
      // O += P V.
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
      for (int kk = 0; kk < D / 16; ++kk) wgmma_rs_n64<0>(s, qf[kk], kmajor_desc<D>(cK, kk), kk > 0);
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
      // since the start), in TMA's 128-byte swizzle (conflict-free pair
      // stores), then 16-byte chunks of rows to memory.
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

// ----------------------------------------------------- head dims 160 and 256

// Arrivals of the wide kernel's barriers: one that also sets the phase's
// expected bytes, and `count` at once.
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_cnt(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Shared memory of the wide kernel at head_dim D, in bytes from a
// 1024-aligned base: the tiles (pair mode: the two Q tiles, then
// PAIR_STAGES K stages and as many V stages; single mode: one Q tile, then
// SINGLE_STAGES of each; at 160 a zero tile last), each stage's kv ids and
// step record, the q tiles' id ranges (DENSE with SEG), then the mbarriers:
// per barrier slot K full, K empty, V full, V empty, and Q's. A position's
// slot is its stage in pair mode; in single mode, where each warpgroup
// waits on every second position only, a ring of an odd number of stages
// has twice as many slots, so that every slot serves one warpgroup and it
// waits on each of its phases in turn (with one slot a stage, stage s's
// next user is the other warpgroup, whose parity wait can pass while the
// slot is still a phase behind: it then reads the record and tiles of the
// position three before). At 256: seven 32 KB tiles, 230,384 bytes
// (231,408 with the base's alignment, of the 232,448 a CTA may use); at
// 160: eleven 20 KB tiles, 226,488 (227,512).
template <int D>
struct WideSmem {
  static constexpr uint32_t TILE = D * kBlockM * 2;
  static constexpr int PAIR_STAGES = D == 256 ? 2 : 4;
  static constexpr int SINGLE_STAGES = D == 256 ? 3 : 4;
  static constexpr int STAGES = PAIR_STAGES > SINGLE_STAGES ? PAIR_STAGES : SINGLE_STAGES;
  static constexpr int SINGLE_SLOTS = SINGLE_STAGES % 2 ? 2 * SINGLE_STAGES : SINGLE_STAGES;
  static constexpr int SLOTS = PAIR_STAGES > SINGLE_SLOTS ? PAIR_STAGES : SINGLE_SLOTS;
  // The first step's P = 0 product reads a zero tile where one fits.
  static constexpr bool ZERO_TILE = D != 256;
  static constexpr int RING_TILES = 2 + 2 * PAIR_STAGES > 1 + 2 * SINGLE_STAGES
                                        ? 2 + 2 * PAIR_STAGES : 1 + 2 * SINGLE_STAGES;
  static constexpr uint32_t ZERO = RING_TILES * TILE;
  static constexpr uint32_t KID = (RING_TILES + (ZERO_TILE ? 1 : 0)) * TILE;
  static constexpr uint32_t STEP = KID + STAGES * kBlockN * 4;
  static constexpr uint32_t QRANGE = STEP + STAGES * 8;
  static constexpr uint32_t BARS = QRANGE + 4 * 4;
  static constexpr uint32_t BYTES = BARS + (4 * SLOTS + 1) * 8;
  static_assert(BYTES + 1024 <= 232448, "the wide kernel's shared memory exceeds a CTA's");
};

// The head_dim-160 and -256 forward (see the note at the top of this file):
// the pair kernel's walk, step records and consumer math, with K and V each
// on their own full and empty barriers, and with SINGLE one q tile a CTA
// whose steps the producer deals to the two consumer warpgroups in turn.
// The tile mode is a template flag: at run time it would hold registers the
// producer's 24 cannot spare.
template <int D, bool SEG, bool SPLIT, bool DENSE, bool SINGLE>
__global__ void __launch_bounds__(kThreads, 1)
    fa2_fwd_wide_kernel(const FwdParams p, const __grid_constant__ FwdMaps maps) {
  static_assert(D == 160 || D == 256, "the wide kernel takes head_dim 160 or 256");
  using L = WideSmem<D>;
  constexpr bool QREG = D == 160;  // Q as register fragments (at 256 they do not fit)
  constexpr bool SKIP = SEG && !DENSE;  // inactive steps are dropped before their fetch
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* k_full = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t* k_empty = k_full + L::SLOTS;
  uint64_t* v_full = k_empty + L::SLOTS;
  uint64_t* v_empty = v_full + L::SLOTS;
  uint64_t* q_bar = v_empty + L::SLOTS;
  int* sKid = reinterpret_cast<int*>(sm + L::KID);
  int2* sStep = reinterpret_cast<int2*>(sm + L::STEP);
  int* sQr = reinterpret_cast<int*>(sm + L::QRANGE);

  constexpr bool single = SINGLE;
  constexpr int nst = single ? L::SINGLE_STAGES : L::PAIR_STAGES;  // stages of each ring
  constexpr int nb = single ? L::SINGLE_SLOTS : nst;  // barrier slots: nst or 2 nst
  constexpr int nq = single ? 1 : 2;  // Q tiles in front of the rings
  // A position in slot b holds stage b mod nst; its stage's previous user,
  // nst positions before, was in slot back(b, ph).x at phase back(b, ph).y.
  auto stage = [](int b) { return nb == nst || b < nst ? b : b - nst; };
  auto back = [](int b, int ph) {
    return nb == nst ? make_int2(b, ph ^ 1) : b >= nst ? make_int2(b - nst, ph)
                                                       : make_int2(b + nst, ph ^ 1);
  };
  // batch * q head on x, the fastest axis of the dispatch order, then the
  // CTA's q tile i0 (single) or its pair i0, i0 + 1 on y, longest walks
  // first: the first wave holds every head's longest walks.
  const int bh = blockIdx.x;
  const int i0 = single ? p.t_q - 1 - static_cast<int>(blockIdx.y)
                        : 2 * ((p.t_q + 1) / 2 - 1 - static_cast<int>(blockIdx.y));
  const bool has1 = !single && i0 + 1 < p.t_q;
  const int split = SPLIT ? blockIdx.z : 0;
  const int b = bh / p.Hq, h = bh % p.Hq, hk = h / p.group;
  if constexpr (L::ZERO_TILE) {
    uint4* zero = reinterpret_cast<uint4*>(sm + L::ZERO);
    for (int i = threadIdx.x; i < static_cast<int>(L::TILE / 16); i += kThreads)
      zero[i] = make_uint4(0u, 0u, 0u, 0u);
    fence_async_smem();  // the zeros are read by wgmma
  }
  if (threadIdx.x == 0) {
    // A stage is freed by every consumer thread that reads its records
    // (pair), or by the one warpgroup it was dealt to (single).
    constexpr int users = single ? 128 : kConsumers;
    for (int s = 0; s < nb; ++s) {
      mbar_init(&k_full[s], 32);  // the producer warp's lanes; TMA bytes on top
      mbar_init(&k_empty[s], users);
      mbar_init(&v_full[s], 1);   // the producer's lane 0 with the bytes
      mbar_init(&v_empty[s], users);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warp-uniform (see rec)
  if (wg == 0) {
    // Producer: one warp. Q once; then per position of the ring, K_j of the
    // next step and its record, then V of the previous position's step.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_arrive_tx(q_bar, (has1 ? 2 : 1) * L::TILE);
        for (int x = 0; x < (has1 ? 2 : 1); ++x)
          load_tile<D>(sm + x * L::TILE, maps.q, maps.q_tail, q_bar, h, (i0 + x) * kBlockM, b);
      }
      // The compact walk; DENSE counts every kv tile in jn instead.
      PairWalk<SKIP, false> walk;
      int jn = -1;
      if (!DENSE) {
        walk.group = 1;
        walk.g = 0;
        const int own = i0 * p.ks + split;  // tile i0's owner; tile i0 + 1's is ks on
        walk.steps = p.table + p.t_q * p.ks + 1;
        walk.bits = SKIP ? p.bits + static_cast<long long>(b) * p.n_vis : nullptr;
        walk.a0 = p.table[own];
        walk.a1 = p.table[own + 1];
        walk.b0 = has1 ? p.table[own + p.ks] : 0;
        walk.b1 = has1 ? p.table[own + p.ks + 1] : 0;
        walk.ia = walk.a0;
        walk.ib = walk.b0;
      }
      if (DENSE && SEG) {  // each q tile's id range, kept in shared memory
        const int* qid_g = p.q_seg + b * p.q_seg_sb;
        for (int x = 0; x < (has1 ? 2 : 1); ++x) {
          int lo = 0x7fffffff, hi = -0x7fffffff;
#pragma unroll
          for (int k = 0; k < kBlockM / 32; ++k) {
            const int r = (i0 + x) * kBlockM + lane + 32 * k;
            const int id = r < p.Sq ? qid_g[r] : kQPadSegment;
            lo = min(lo, id);
            hi = max(hi, id);
          }
          warp_range(lo, hi);
          if (lane == 0) {
            sQr[2 * x] = lo;
            sQr[2 * x + 1] = hi;
          }
        }
      }
      // The producer has 24 registers: the previous position's step is read
      // back from its record, the id loops have fixed trip counts and the
      // tile mode is a template flag (each of these kept ptxas from spilling).
      int kb = 0, kph = 0;  // the barrier slot and parity of this position
      if (lane == 0) sStep[nst - 1] = make_int2(-1, 0);  // no step before the first position
      __syncwarp();
      int j;  // this position's kv tile; -1: an end record
      bool more = true;
      // (A `break` out of this loop crashes ptxas 12.9; it ends on its condition.)
      do {
        const int kst = stage(kb);
        const int2 free_k = back(kb, kph);
        mbar_wait(&k_empty[free_k.x], free_k.y);
        // The step this position carries (j < 0: the walk has ended) and
        // which q tile takes it and needs the element mask: the table's
        // flags and step bits, or under DENSE the classifier (with SEG on
        // the id ranges; the kv ids go to this stage as it reads them). In
        // single mode DENSE skips the tiles its q tile does not take.
        int flags = 0;
        j = -1;
        while (more && j < 0) {
          int g, jj, ea = -1, eb = -1;
          if (DENSE) {
            jj = ++jn;
            more = jj < (p.Skv + kBlockN - 1) / kBlockN;
          } else {
            more = walk.next(g, jj, ea, eb);
          }
          if (more) {
            flags = 0;
            if (DENSE) {
              const int k0 = jj * kBlockN;
              int lo = 0x7fffffff, hi = -0x7fffffff;
              if (SEG) {
                const int* kid_g = p.kv_seg + b * p.kv_seg_sb;
#pragma unroll
                for (int k = 0; k < kBlockN / 32; ++k) {
                  const int r = lane + 32 * k;
                  const int id = k0 + r < p.Skv ? kid_g[k0 + r] : kKvPadSegment;
                  sKid[kst * kBlockN + r] = id;
                  lo = min(lo, id);
                  hi = max(hi, id);
                }
                warp_range(lo, hi);
              }
#pragma unroll
              for (int x = 0; x < 2; ++x) {
                TileClass c = classify_tile<kBlockM, kBlockN>(
                    p.causal, p.window, p.sink, p.Skv, (i0 + x) * kBlockM + p.q_offset, k0);
                if (SEG) c = with_ids(c, sQr[2 * x], sQr[2 * x + 1], lo, hi);
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
            }
            if (!(DENSE && single) || flags) j = jj;
          }
        }
        if (j >= 0) {
          // Single mode: tile 0's flags move to the warpgroup dealt, that of
          // the position's parity, its slot's (single mode has an even
          // number of slots).
          if (single) flags <<= kb & 1;
          if (lane == 0) {
            mbar_expect_tx(&k_full[kb], L::TILE);
            load_tile<D>(sm + (nq + kst) * L::TILE, maps.k, maps.k_tail, &k_full[kb], hk,
                         j * kBlockN, b);
          }
          // Only the element mask reads the kv ids: copy them when a tile
          // needs it, by cp.async, whose completion K's full barrier also
          // waits for. A row past Skv reads 0; the mask hides its column.
          if (SKIP && (flags & (kMask0 | kMask1))) {
            const int k0 = j * kBlockN;
            const int* kid_g = p.kv_seg + b * p.kv_seg_sb;
            for (int r = lane; r < kBlockN; r += 32) {
              const bool in = k0 + r < p.Skv;
              asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                               smem_u32(sKid + kst * kBlockN + r)),
                           "l"(kid_g + (in ? k0 + r : 0)), "r"(in ? 4 : 0)
                           : "memory");
            }
            asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(
                             smem_u32(&k_full[kb]))
                         : "memory");
          }
        }
        if (lane == 0) sStep[kst] = make_int2(j, flags);
        mbar_arrive(&k_full[kb]);
        // V of the previous position's step (its record, which lane 0 wrote,
        // is still in its stage), once the stage's last reader has freed V
        // there. The warpgroups that skip the step (pair mode) never read
        // it: lane 0 frees the stage for them, after the wait, so their
        // arrivals fall in this use's phase. A step that neither takes
        // (DENSE) loads no V: nothing would wait for its bytes.
        const int vb = kb == 0 ? nb - 1 : kb - 1;  // the previous position's slot
        const int vst = stage(vb);
        int px = 0, py = 0;
        if (lane == 0) {
          px = sStep[vst].x;
          py = sStep[vst].y;
        }
        px = __shfl_sync(0xffffffffu, px, 0);
        if (px >= 0) {
          const int2 free_v = back(vb, kb == 0 ? kph ^ 1 : kph);
          mbar_wait(&v_empty[free_v.x], free_v.y);
          if (lane == 0) {
            const int skip = single ? 0 : 2 - __popc(py & (kTake0 | kTake1));
            if (skip < 2) {
              mbar_arrive_tx(&v_full[vb], L::TILE);
              load_tile<D>(sm + (nq + nst + vst) * L::TILE, maps.v, maps.v_tail, &v_full[vb],
                           hk, px * kBlockN, b);
            } else {
              mbar_arrive(&v_full[vb]);
            }
            if (skip) mbar_arrive_cnt(&v_empty[vb], 128 * skip);
          }
        }
        if (++kb == nb) {
          kb = 0;
          kph ^= 1;
        }
      } while (j >= 0);
      if (single) {  // a second end record: each warpgroup reads every second position
        const int2 free_k = back(kb, kph);
        mbar_wait(&k_empty[free_k.x], free_k.y);
        if (lane == 0) sStep[stage(kb)] = make_int2(-1, 0);
        mbar_arrive(&k_full[kb]);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    // Consumer warpgroup w: pair mode, q tile i0 + w and every position;
    // single mode, the CTA's tile i0 and positions w, w + 2, ...
    const int w = wg - 1;
    const int t = threadIdx.x - 128 * wg;
    const int wq = t / 32, lane = t % 32, g8 = lane / 4, t4 = lane % 4;
    const int q0 = (single ? i0 : i0 + w) * kBlockM;
    const int r_a = wq * 16 + g8;  // this thread's rows of the tile: r_a, r_a + 8
    const int row_a = q0 + r_a, row_b = row_a + 8;
    int qid[2] = {0, 0};
    if (SEG) {
      const int* qid_g = p.q_seg + b * p.q_seg_sb;
      qid[0] = row_a < p.Sq ? qid_g[row_a] : kQPadSegment;
      qid[1] = row_b < p.Sq ? qid_g[row_b] : kQPadSegment;
    }
    const int take = w ? kTake1 : kTake0, needs_mask = w ? kMask1 : kMask0;
    const uint32_t sQ = smem_u32(sm) + (single ? 0 : w * L::TILE);
    const uint32_t sK = smem_u32(sm) + nq * L::TILE, sV = sK + nst * L::TILE;
    // What a run's first P = 0 product reads: any finite tile that has landed.
    const uint32_t sZ = L::ZERO_TILE ? smem_u32(sm) + L::ZERO : sQ;

    // O of the tile: rows r_a / r_a + 8, columns 8 tt + 2 t4 (+1).
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m_r[2] = {-INFINITY, -INFINITY};  // the rows' running max
    float m_s[2] = {-INFINITY, -INFINITY};  // the same times log2(e)
    float l_r[2] = {0.f, 0.f};              // this thread's share of the row sums
    uint32_t pc[4][4];  // P of the pending step: bf16 A fragments of O += P V
    int pend = -1;      // the slot whose O += P V is not issued yet
    int pph = 0;        // its parity
    constexpr int stride = single ? 2 : 1;
    int cb = single ? w : 0, ph = 0;  // this warpgroup's position: slot and parity

    mbar_wait(q_bar, 0);
    // QREG: Q as bf16 A fragments in registers, read once from its swizzled
    // tile.
    [[maybe_unused]] uint32_t qf[QREG ? D / 16 : 1][4];
    if constexpr (QREG) {
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
    for (;;) {
      const int st = stage(cb);
      mbar_wait(&k_full[cb], ph);
      // The record, broadcast from lane 0: ptxas then sees the branches
      // around the wgmmas as warp-uniform and does not serialise them.
      int2 rec = sStep[st];
      rec.x = __shfl_sync(0xffffffffu, rec.x, 0);
      rec.y = __shfl_sync(0xffffffffu, rec.y, 0);
      if (rec.x < 0) break;
      if (!(rec.y & take)) {
        // Pair mode, not this tile's step: finish the pending product, so
        // that no V stays held while the producer waits for it; free K.
        if (pend >= 0) {
          mbar_wait(&v_full[pend], pph);
          wgmma_fence();
          wgmma_rs_k64<D>(o, pc, sV + stage(pend) * L::TILE);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(o);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) fence_regs(pc[kk]);
          mbar_arrive(&v_empty[pend]);
          pend = -1;
        }
        mbar_arrive(&k_empty[cb]);
      } else {
        const int j = rec.x;
        const uint32_t cK = sK + st * L::TILE;
        // S = Q K^T (64 x 64, K-major from its swizzled tile; Q from
        // registers or its tile), then the pending step's O += P V once its
        // V has landed: the producer loads that V after this step's K, so S
        // runs while it lands (tools/ab_forward.py v_wait_before_s). The
        // first step of a run has none pending: it issues one with P = 0 on
        // the zero tile (at 256 on the Q tile: O += 0 exactly for finite q,
        // a non-finite q row turns its whole tile to NaN, the wrappers'
        // stated precondition there; this step's own V would cost a wait,
        // tools/ab_forward.py first_pv_on_own_v), so the products and their
        // waits are the same on every taken step; with them conditional,
        // ptxas serialises every wgmma.
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
          if constexpr (QREG)
            wgmma_rs_n64<0>(s, qf[kk], kmajor_desc<D>(cK, kk), kk > 0);
          else
            wgmma_ss_n64<0, 0>(s, kmajor_desc<D>(sQ, kk), kmajor_desc<D>(cK, kk), kk > 0);
        }
        wgmma_commit();
        mbar_wait(first ? q_bar : &v_full[pend], first ? 0 : pph);
        wgmma_rs_k64<D>(o, pc, first ? sZ : sV + stage(pend) * L::TILE);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(s);

        // The element mask: element i of n-block tt is row row_a (i < 2) or
        // row_b, kv column j * 64 + 8 tt + 2 t4 + (i & 1); hidden: kHidden.
        if (rec.y & needs_mask) {
          const int* cKid = sKid + st * kBlockN;
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
        // S has completed and the stage's ids are read: K's stage is free
        // while this step's softmax and P V run.
        mbar_arrive(&k_empty[cb]);

        // Online softmax (FA2 Algorithm 1 lines 8-10, un-rescaled
        // accumulator) in the exp2 domain.
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
        wgmma_wait<0>();  // the pending O += P V is done: its V stage is free
        fence_regs(o);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) fence_regs(pc[kk]);
        if (!first) mbar_arrive(&v_empty[pend]);
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
        pend = cb;
        pph = ph;
      }
      cb += stride;
      if (cb >= nb) {
        cb -= nb;
        ph ^= 1;
      }
    }
    if (pend >= 0) {  // the last step's O += P V
      mbar_wait(&v_full[pend], pph);
      wgmma_fence();
      wgmma_rs_k64<D>(o, pc, sV + stage(pend) * L::TILE);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(pc[kk]);
      mbar_arrive(&v_empty[pend]);
    }

    if (single) {
      // The two warpgroups' states of the one tile, merged once in a fixed
      // order through the ring, which every load and product has left by
      // now: warpgroup 1 writes (o, m, l) after warpgroup 0 has passed its
      // walk (named barrier 3), warpgroup 0 reads them after the writes
      // (barrier 4), then o = o0 a0 + o1 a1 and l = l0 a0 + l1 a1 with a_w =
      // exp2(m_w log2 e - m log2 e), m = max(m0, m1). A warpgroup dealt no
      // step (m = -inf, l = 0) adds nothing; rows that saw no key in either
      // (m = kHidden) add both l's, as the single walk would.
      float4* xo = reinterpret_cast<float4*>(sm + L::TILE);      // K stages 0-1: 2 tiles
      float4* xs = reinterpret_cast<float4*>(sm + 3 * L::TILE);  // K stage 2
      if (w == 1) {
        named_sync(3, 256);
#pragma unroll
        for (int c = 0; c < D / 8; ++c)
          xo[c * 128 + t] = make_float4(o[4 * c], o[4 * c + 1], o[4 * c + 2], o[4 * c + 3]);
        xs[t] = make_float4(m_r[0], m_r[1], l_r[0], l_r[1]);
        asm volatile("bar.arrive 4, 256;\n" ::: "memory");
        return;
      }
      asm volatile("bar.arrive 3, 256;\n" ::: "memory");
      named_sync(4, 256);
      const float4 ml = xs[t];
      const float m1[2] = {ml.x, ml.y}, l1[2] = {ml.z, ml.w};
      float a0[2], a1[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m = fmaxf(m_r[r], m1[r]);
        const float base = m == -INFINITY ? 0.f : m * kLog2e;
        a0[r] = exp2_ftz(m_s[r] - base);
        a1[r] = exp2_ftz(m1[r] * kLog2e - base);
        l_r[r] = l_r[r] * a0[r] + l1[r] * a1[r];
        m_r[r] = m;
      }
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        const float4 x = xo[c * 128 + t];
        o[4 * c] = o[4 * c] * a0[0] + x.x * a1[0];
        o[4 * c + 1] = o[4 * c + 1] * a0[0] + x.y * a1[0];
        o[4 * c + 2] = o[4 * c + 2] * a0[1] + x.z * a1[1];
        o[4 * c + 3] = o[4 * c + 3] * a0[1] + x.w * a1[1];
      }
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
      // bf16 O through the warpgroup's Q tile (its last readers, the Q
      // fragments' reads or the last S = Q K^T, have completed; in single
      // mode both warpgroups' have), in TMA's swizzle, then 16-byte chunks
      // of rows to memory.
      unsigned char* stg = sm + (single ? 0 : w * L::TILE);
      named_sync(1 + w, 128);
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

// The fold of SPLIT's partials, o_parts (B, Hq, ks, Sq, D) and lse_parts
// (B, Hq, ks, Sq), contiguous f32, into o (B, Sq, Hq, D) bf16 and lse (B,
// Hq, Sq) f32, contiguous: thread (row, c) of grid column bh folds columns
// 4 c .. 4 c + 3 of q row `row` of batch * q head bh over the ks splits, m
// = the max of the split lse, then o = sum_s exp(lse_s - m) o_s / l. It is
// bound by the bytes of the partials, read once: every thread loads 16
// bytes a split, neighbouring threads neighbouring chunks of a row and
// then of the next rows (a CTA reads 4 KB of each split in one run), the
// loads of four splits in flight at once; a row's lse comes from L1 after
// its first reader. A row that no split saw (every lse -inf) gives o = 0,
// lse = -inf.
constexpr int kFoldThreads = 256;

template <int D>
__global__ void __launch_bounds__(kFoldThreads)
    fa2_fwd_fold_kernel(const float* __restrict__ o_parts, const float* __restrict__ lse_parts,
                        __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int Hq, int Sq,
                        int ks) {
  constexpr int C = D / 4;  // 16-byte chunks of a row
  const int bh = blockIdx.y;
  const int idx = blockIdx.x * kFoldThreads + threadIdx.x;
  const int row = idx / C, c = idx % C;
  if (row >= Sq) return;
  const long long base = static_cast<long long>(bh) * ks * Sq + row;
  const float* lp = lse_parts + base;
  const float4* op = reinterpret_cast<const float4*>(o_parts + base * D) + c;
  const long long step = static_cast<long long>(Sq) * C;  // float4s from a split to the next
  float m = -INFINITY;
  for (int s = 0; s < ks; ++s) m = fmaxf(m, __ldg(lp + static_cast<long long>(s) * Sq));
  const float m_safe = m == -INFINITY ? 0.f : m;
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int s = 0; s < ks; ++s) {
    const float w = expf(__ldg(lp + static_cast<long long>(s) * Sq) - m_safe);
    const float4 x = __ldcs(op + s * step);  // read once: do not keep it in L1
    l += w;
    acc.x += w * x.x;
    acc.y += w * x.y;
    acc.z += w * x.z;
    acc.w += w * x.w;
  }
  const float l_safe = l == 0.f ? 1.f : l;
  const int b = bh / Hq, h = bh % Hq;
  uint2 out;
  out.x = pack_bf16(acc.x / l_safe, acc.y / l_safe);
  out.y = pack_bf16(acc.z / l_safe, acc.w / l_safe);
  *reinterpret_cast<uint2*>(o + ((static_cast<long long>(b) * Sq + row) * Hq + h) * D + 4 * c) =
      out;
  if (c == 0)
    lse[static_cast<long long>(bh) * Sq + row] = l == 0.f ? -INFINITY : m_safe + logf(l_safe);
}

template <int D, bool SEG, bool SPLIT, bool DENSE = false>
cudaError_t launch(const FwdParams& p, int batch, int Hkv, cudaStream_t stream) {
  constexpr bool kWide = D == 160 || D == 256;
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
  auto kernel = [&p] {
    if constexpr (D == 160 || D == 256)
      return p.single ? fa2_fwd_wide_kernel<D, SEG, SPLIT, DENSE, true>
                      : fa2_fwd_wide_kernel<D, SEG, SPLIT, DENSE, false>;
    else
      return fa2_fwd_kernel<D, SEG, SPLIT, DENSE>;
  }();
  constexpr size_t smem = [] {
    if constexpr (D == 160 || D == 256)
      return WideSmem<D>::BYTES;
    else
      return FwdSmem<D>::BYTES;
  }() + 1024;  // + the 1024-byte alignment of the base
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // The wide kernel takes batch * q head on x (see its note), the pair
  // kernel its q tiles.
  const int tiles = p.single ? p.t_q : (p.t_q + 1) / 2;
  const dim3 grid = kWide ? dim3(batch * p.Hq, tiles, p.ks) : dim3(tiles, batch * p.Hq, p.ks);
  kernel<<<grid, kThreads, smem, stream>>>(p, maps);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch(const FwdParams& p, int batch, int Hkv, bool seg, bool split, bool dense,
                     cudaStream_t s) {
  if (dense)
    return seg ? launch<D, true, false, true>(p, batch, Hkv, s)
               : launch<D, false, false, true>(p, batch, Hkv, s);
  if (seg)
    return split ? launch<D, true, true>(p, batch, Hkv, s)
                 : launch<D, true, false>(p, batch, Hkv, s);
  return split ? launch<D, false, true>(p, batch, Hkv, s)
               : launch<D, false, false>(p, batch, Hkv, s);
}

template <int D>
cudaError_t fold(const float* o_parts, const float* lse_parts, __nv_bfloat16* o, float* lse,
                 int batch, int Hq, int Sq, int ks, cudaStream_t stream) {
  const long long chunks = static_cast<long long>(Sq) * (D / 4);
  const dim3 grid(static_cast<unsigned>((chunks + kFoldThreads - 1) / kFoldThreads), batch * Hq);
  fa2_fwd_fold_kernel<D><<<grid, kFoldThreads, 0, stream>>>(o_parts, lse_parts, o, lse, Hq, Sq,
                                                            ks);
  return cudaGetLastError();
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
                            const void* bits, int n_vis, void* stream, int single) {
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
  p.single = single;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // Head dims 128 (qwen3), 64 (whisper), 256 (gemma3) and 160 (stablelm);
  // without and with segments (null ids: none); the compact schedule
  // (table; with segments, step bits) or the dense one (no table, no bits);
  // single-pass (o, lse), or (compact only) split-KV f32 partials (o, lse),
  // which fa2_fwd_fold_f32 folds; at 160 and 256 a pair of q tiles a CTA
  // or (single) one.
  if (block_q != kBlockM || block_kv != kBlockN || ks < 1 || t_q < 1) return cudaErrorInvalidValue;
  if (single && head_dim != 256 && head_dim != 160) return cudaErrorInvalidValue;
  if (split && dense) return cudaErrorInvalidValue;
  const bool seg = q_seg != nullptr;
  // (No step bits where no step is visible: bits may be null when n_vis is 0.)
  if (dense ? table != nullptr : table == nullptr || (seg && bits == nullptr && n_vis > 0))
    return cudaErrorInvalidValue;
  if (head_dim == 128) return dispatch<128>(p, batch, Hkv, seg, split != 0, dense != 0, s);
  if (head_dim == 64) return dispatch<64>(p, batch, Hkv, seg, split != 0, dense != 0, s);
  if (head_dim == 256) return dispatch<256>(p, batch, Hkv, seg, split != 0, dense != 0, s);
  if (head_dim == 160) return dispatch<160>(p, batch, Hkv, seg, split != 0, dense != 0, s);
  return cudaErrorInvalidValue;
}

// The fold of a split-KV launch's partials (fa2_fwd_fold_kernel), on the
// walk's stream after it: o_parts (B, Hq, ks, Sq, D), lse_parts (B, Hq, ks,
// Sq) f32 -> o (B, Sq, Hq, D) bf16, lse (B, Hq, Sq) f32, all contiguous.
extern "C" int fa2_fwd_fold_f32(const void* o_parts, const void* lse_parts, void* o, void* lse,
                                int batch, int Hq, int Sq, int ks, int head_dim, void* stream) {
  const auto* op = static_cast<const float*>(o_parts);
  const auto* lp = static_cast<const float*>(lse_parts);
  auto* of = static_cast<__nv_bfloat16*>(o);
  auto* lf = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ks < 1 || Sq < 1 || batch * Hq < 1) return cudaErrorInvalidValue;
  if (head_dim == 128) return fold<128>(op, lp, of, lf, batch, Hq, Sq, ks, s);
  if (head_dim == 64) return fold<64>(op, lp, of, lf, batch, Hq, Sq, ks, s);
  if (head_dim == 256) return fold<256>(op, lp, of, lf, batch, Hq, Sq, ks, s);
  if (head_dim == 160) return fold<160>(op, lp, of, lf, batch, Hq, Sq, ks, s);
  return cudaErrorInvalidValue;
}
