// Split-KV flash decode for Hopper (sm_90a): one new token per sequence,
// against a contiguous cache or through a block table into a page pool.
//
// Two entries, each with its own body:
//   * fa2_decode_bf16 replaces the Pallas TPU kernel
//     src/repro/kernels/flash_decode.py:77 flash_decode_kernel (body
//     _decode_kernel :34). It reads the (B, S, Hkv, D) serving cache in
//     place: row g of (b, h) sits at base + g * stride. Splits are
//     ceil-div, 8-aligned chunks of S. Its SEG instantiation is the packed
//     cache of the same kernel (segment branch, mask at :52-55): with int32
//     ids kv_seg (B, S) and q_seg (B,), a position is visible only where
//     kv_seg[b, g] == q_seg[b], ANDed into the length and window mask. The
//     tile's 64 ids travel with its K/V tile in the same cp.async group
//     (256 bytes a stage); ids at or past the split's end read as -1. A
//     split that sees nothing writes (0, -inf), and with all ids equal the
//     arithmetic is the unsegmented kernel's, bit for bit. Its body is
//     decode_split below.
//   * fa2_decode_paged_bf16 replaces src/repro/kernels/flash_decode.py:250
//     flash_decode_paged_kernel (body _paged_decode_kernel :161). K/V live
//     in the pool's page planes (Hkv, P, ps, D); logical row g of sequence
//     b sits in physical page tbl[b, g / ps] at offset g % ps. Split c
//     covers the pp logical pages [c * pp, c * pp + pp), the JAX geometry
//     (ns = ceil(n_pages / pp)). Its body is fa2_decode_paged_kernel below.
// Both write, per (batch * kv head, split), the G q heads of one GQA group
// as a locally normalized f32 partial (o, lse) in the JAX layout, o_parts
// (B*Hkv, ns, G, D) and lse_parts (B*Hkv, ns, G); the caller folds the
// splits with combine_lse_outputs.
//
// What bounds them on an H100: decode does 4 * G * D flops per cached
// position against 2 * D * 2 bytes of K/V, so it is bound by HBM (3.35
// TB/s) by two orders of magnitude. Both move only the bytes the data needs,
// once: K/V in place (the JAX wrapper transposed the whole contiguous cache
// to head-major every step), one K/V row for all G q heads of its group, no
// position at or past the sequence's length and no tile (contiguous) or page
// (paged) without a visible position, so a short sequence in a long cache
// costs what its length costs.
//
// decode_split: one CTA of D threads per (batch * kv head, split); each
// 64-row K and V tile is copied to shared memory with cp.async, every
// 16-byte chunk in flight at once, in a two-stage ring so the next tile's
// copy overlaps this tile's math; scores with f32 FMAs, the softmax one warp
// per q head and P V one thread per output column, with CTA-wide barriers
// between them. Head dims 128 (qwen3) and 64 (whisper; one thread per
// output column, so 64 threads and one thread per cache row in the scores).
//
// The paged body (head_dim 128) answers what held that design back at the
// serving shape (B = 4, lengths 15 to 1508 of 2048, pages of 16, 8 splits):
// one CTA of 4 warps per split left 88 of 256 CTAs with work and long
// splits ran their tiles one after another; three CTA-wide barriers a tile
// kept the 4 warps waiting on latency; each 16-byte chunk paid two integer
// divisions by a run-time page size to find its page. Now:
//   * a split is a cluster of two CTAs of four warps; its visible pages (at
//     most two ascending runs: the sink's and the window's) are dealt to the
//     eight warps in contiguous runs of ordinals (kernels/flash_decode.py
//     paged_deal states the dealing), so at the serving shape 168 CTAs have
//     work and a warp of a long split holds two pages;
//   * each warp reads its own pages' table entries, once, and lane 0 moves
//     each page of K and of V as one 1-D bulk copy (cp.async.bulk, ps * 256
//     bytes; a page of more than 64 rows as pieces of 64) into the warp's
//     own ring of stages (two, or one for pages over 32 rows), counted on an
//     mbarrier; a page, or piece, without a visible row is never fetched;
//   * the math is mma.sync (m16n8k16) on 16-row units with no CTA-wide
//     barrier: S^T = K q^T with the unit's 16 kv rows as the fragment's
//     rows and the G <= 8 q heads as its 8 columns (K read straight from the
//     bulk-copied rows: the head_dim order of the fragments is permuted, the
//     same for K and q, so each thread reads 16-byte runs); the online
//     softmax in the exp2 domain per q head over the unit; O^T += V^T P^T
//     with P^T moved between lanes by shuffles and V's rows reordered in
//     registers (byte permutes). The unswizzled 256-byte rows cost 2-way
//     (K) and 4-way (V) bank conflicts, which a bulk copy cannot avoid;
//   * rows inside a fetched page that are not visible (past the length:
//     stale pool data, possibly not finite) take the mask value in S and
//     zeros in V, so their P is exactly 0 and nothing of them reaches O;
//   * each warp keeps its own (m, l, acc) and leaves it in its CTA's shared
//     memory; after a cluster barrier rank 0 merges the eight in worker
//     order (by logical position), the other CTA's over distributed shared
//     memory, a warp per q head so that a head's loads go out together, and
//     a second barrier keeps the other CTA alive until it has read them.
// What bounds it now (tools/ab_kernels.py on an H100 80GB HBM3 at 700 W,
// serving shape, L2 flushed before each launch): a launch whose lengths are
// all 0 takes 0.0065 ms, the copies and the merge without the math 0.0143,
// the whole kernel 0.0160: the bulk copies' HBM latency, on top of the
// launch, then the last warps' math and the merge. Measured slower: 8 warps
// a CTA (1.25x), one CTA a split (1.04x), one stage a warp (1.01x), the
// partials stored into rank 0's shared memory (1.06x), rank 0 merging a
// head at a time (1.06x); the table read beside the length gains 1%.
//
// Scores are f32 sums of bf16 products; P is rounded to bf16 before P V, as
// the JAX kernels do. Splits with no visible position give (o = 0, lse =
// -inf). The arithmetic depends on logical positions only, so the physical
// order of pages does not change a paged result by one bit.

#include <cooperative_groups.h>
#include <math.h>

#include "sm90.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kTile = 64;  // cache rows per tile
constexpr int kMaxGroup = 8;

struct DecodeParams {
  const __nv_bfloat16* q;  // (B * Hkv, G, D), pre-scaled, contiguous
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int* lengths;  // (B,)
  float* o_parts;      // (B * Hkv, ns, G, D)
  float* lse_parts;    // (B * Hkv, ns, G)
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int Hkv, G, S, chunk, ns;
  int window, sink;  // window < 0: no window
  const int* kv_seg;  // SEG: (B, S) with batch stride kv_seg_sb
  long long kv_seg_sb;
  const int* q_seg;   // SEG: (B,)
};

struct PagedParams {
  const __nv_bfloat16* q;  // (B * Hkv, G, D), pre-scaled, contiguous
  const __nv_bfloat16* k;  // (Hkv, P, ps, D) page planes, contiguous
  const __nv_bfloat16* v;
  const int* lengths;  // (B,)
  const int* table;    // (B, n_pages) physical page of each logical page
  float* o_parts;      // (B * Hkv, ns, G, D)
  float* lse_parts;    // (B * Hkv, ns, G)
  int Hkv, G, P, ps, n_pages, pp, ns;
  int window, sink;  // window < 0: no window
  int slots;         // ring stages of each warp
};

// Row g of one kv head in a contiguous cache.
struct ContiguousRows {
  const __nv_bfloat16* base;
  long long stride;
  __device__ __forceinline__ const __nv_bfloat16* operator()(int g) const {
    return base + g * stride;
  }
  __device__ __forceinline__ const __nv_bfloat16* any() const { return base; }
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

// Copy cache rows [row0, row0 + kTile) of one kv head into shared memory;
// rows for which load(g) is false are zero-filled and never read from
// global memory.
template <int D, int STRIDE, class Rows, class Load>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const Rows& rows, int row0,
                                          const Load& load) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < kTile * CHUNKS; idx += D) {
    const int r = idx / CHUNKS, c = idx % CHUNKS;
    const int g = row0 + r;
    const bool valid = load(g);
    cp_async16(dst + r * STRIDE + c * 8, valid ? rows(g) + c * 8 : rows.any(), valid);
  }
}

// Segment ids of a packed cache (SEG), or none: ``load`` stages the ids of
// rows [row0, row0 + kTile) in the current cp.async group (rows at or past
// `end` read as -1), ``match`` says whether staged row r is in the query's
// segment.
template <bool SEG>
struct Segments {
  const int* kv;  // this batch row's kv ids
  int q;          // this batch row's query id
  __device__ __forceinline__ void load(int* dst, int row0, int end) const {
    if (!SEG) return;
    for (int r = threadIdx.x; r < kTile; r += static_cast<int>(blockDim.x)) {
      if (row0 + r < end)
        cp_async4(dst + r, kv + row0 + r);
      else
        dst[r] = -1;
    }
  }
  __device__ __forceinline__ bool match(const int* ids, int r) const {
    return !SEG || ids[r] == q;
  }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// One CTA's split: the G q heads at qg against rows [lo, end) (nothing at or
// past `end` is visible), with the window counted back from L. blockDim.x ==
// D: one thread per output column in P V, and D / 64 threads per cache row
// (64 elements each) for the scores. Writes o_out (G, D) and lse_out (G).
template <int D, bool SEG, class Rows, class Load>
__device__ __forceinline__ void decode_split(const __nv_bfloat16* qg, const Rows& krows,
                                             const Rows& vrows, const Load& load,
                                             const Segments<SEG>& seg, int G, int L, int lo,
                                             int end, int window, int sink, float* o_out,
                                             float* lse_out, __nv_bfloat16* sK,
                                             __nv_bfloat16* sV) {
  constexpr int NWARPS = D / 32;
  constexpr int TPR = D / 64;     // threads per cache row in the scores
  constexpr int STRIDE = D + 8;   // padded row: 16-byte reads hit distinct banks

  __shared__ __align__(16) float sq[kMaxGroup][D];
  __shared__ float sp[kMaxGroup][kTile];
  __shared__ float s_alpha[kMaxGroup];
  __shared__ float s_m[kMaxGroup];
  __shared__ float s_l[kMaxGroup];
  __shared__ int s_kid[2][kTile];  // SEG: the staged tiles' kv ids

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int win_lo = window < 0 ? 0 : L - window;  // first in-window position
  const int ntiles = lo < end ? (end - lo + kTile - 1) / kTile : 0;

  // A tile wholly before the window and past the sink holds nothing visible.
  auto next_tile = [&](int t) {
    for (; t < ntiles; ++t) {
      const int c0 = lo + t * kTile;
      if (!(min(c0 + kTile, end) <= win_lo && c0 >= sink)) break;
    }
    return t;
  };

  int t = next_tile(0);
  if (t < ntiles) {
    load_tile<D, STRIDE>(sK, krows, lo + t * kTile, load);
    load_tile<D, STRIDE>(sV, vrows, lo + t * kTile, load);
    seg.load(s_kid[0], lo + t * kTile, end);
    cp_async_commit();
  }
  for (int i = tid; i < G * D; i += D) sq[i / D][i % D] = __bfloat162float(qg[i]);
  if (tid < kMaxGroup) {
    s_m[tid] = -INFINITY;
    s_l[tid] = 0.f;
  }

  float acc[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) acc[g] = 0.f;
  int any = 0;
  int stage = 0;

  while (t < ntiles) {
    const int tn = next_tile(t + 1);
    if (tn < ntiles) {
      load_tile<D, STRIDE>(sK + (stage ^ 1) * kTile * STRIDE, krows, lo + tn * kTile, load);
      load_tile<D, STRIDE>(sV + (stage ^ 1) * kTile * STRIDE, vrows, lo + tn * kTile, load);
      seg.load(s_kid[stage ^ 1], lo + tn * kTile, end);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int c0 = lo + t * kTile;
    const int c1 = min(c0 + kTile, end);
    const __nv_bfloat16* cK = sK + stage * kTile * STRIDE;
    const __nv_bfloat16* cV = sV + stage * kTile * STRIDE;

    // Scores: TPR threads per cache row, 64 of its D elements each.
    const int r = tid / TPR, part = tid % TPR;
    float sc[kMaxGroup];
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) sc[g] = 0.f;
    const __nv_bfloat16* krow = cK + r * STRIDE + part * 64;
#pragma unroll
    for (int c8 = 0; c8 < 8; ++c8) {
      const uint4 raw = *reinterpret_cast<const uint4*>(krow + c8 * 8);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
      float kf[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) kf[i] = __bfloat162float(e[i]);
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < G) {
          const float* qv = &sq[g][part * 64 + c8 * 8];
#pragma unroll
          for (int i = 0; i < 8; ++i) sc[g] += qv[i] * kf[i];
        }
      }
    }
    if (TPR == 2) {
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) sc[g] += __shfl_xor_sync(0xffffffffu, sc[g], 1);
    }
    const int c = c0 + r;
    const bool in_tile = c < c1;
    const bool vis =
        in_tile && (window < 0 || c >= win_lo || c < sink) && seg.match(s_kid[stage], r);
    if (part == 0) {
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g)
        if (g < G) sp[g][r] = in_tile ? (vis ? sc[g] : kMaskValue) : -INFINITY;
    }
    any |= __syncthreads_or(vis);

    // Per-row running max, rescale and probabilities of this tile.
    for (int g = warp; g < G; g += NWARPS) {
      const float x0 = sp[g][lane], x1 = sp[g][lane + 32];
      const float m_old = s_m[g];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(x0, x1)));
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);  // 0 past the tile
      const float tile_sum = warp_sum(p0 + p1);
      // P V takes P in the storage type, as the JAX kernel does.
      sp[g][lane] = __bfloat162float(__float2bfloat16_rn(p0));
      sp[g][lane + 32] = __bfloat162float(__float2bfloat16_rn(p1));
      if (lane == 0) {
        const float alpha = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
        s_alpha[g] = alpha;
        s_l[g] = s_l[g] * alpha + tile_sum;
        s_m[g] = m_new;
      }
    }
    __syncthreads();

    // acc[g] (column tid) = alpha * acc[g] + sum_c p[g][c] * v[c][tid]
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g)
      if (g < G) acc[g] *= s_alpha[g];
    const int n = c1 - c0;
#pragma unroll 8
    for (int cc = 0; cc < n; ++cc) {
      const float vv = __bfloat162float(cV[cc * STRIDE + tid]);
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g)
        if (g < G) acc[g] += sp[g][cc] * vv;
    }
    __syncthreads();  // sp, s_alpha and this stage are rewritten next
    t = tn;
    stage ^= 1;
  }

#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g >= G) break;
    const float l = any ? s_l[g] : 0.f;
    const float l_safe = l == 0.f ? 1.f : l;
    o_out[g * D + tid] = any ? acc[g] / l_safe : 0.f;
    if (tid == 0) lse_out[g] = l == 0.f ? -INFINITY : s_m[g] + logf(l_safe);
  }
}

template <int D>
constexpr size_t ring_bytes() {  // two stages of K and V tiles
  return static_cast<size_t>(4) * kTile * (D + 8) * sizeof(__nv_bfloat16);
}

template <int D, bool SEG>
__global__ void __launch_bounds__(D) fa2_decode_kernel(const DecodeParams p) {
  constexpr int STRIDE = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2][kTile][STRIDE]
  __nv_bfloat16* sV = sK + 2 * kTile * STRIDE;                     // [2][kTile][STRIDE]

  const int bhk = blockIdx.x, split = blockIdx.y;
  const int b = bhk / p.Hkv, hk = bhk % p.Hkv;
  const int L = min(p.lengths[b], p.S);
  const int lo = split * p.chunk;
  const int end = min(min(lo + p.chunk, p.S), L);  // past it nothing is visible
  const ContiguousRows krows{p.k + b * p.k_sb + hk * p.k_sh, p.k_ss};
  const ContiguousRows vrows{p.v + b * p.v_sb + hk * p.v_sh, p.v_ss};
  const auto load = [end](int g) { return g < end; };
  Segments<SEG> seg{nullptr, 0};
  if (SEG) seg = Segments<SEG>{p.kv_seg + b * p.kv_seg_sb, p.q_seg[b]};
  const long long part_idx = static_cast<long long>(bhk) * p.ns + split;
  decode_split<D, SEG>(p.q + static_cast<long long>(bhk) * p.G * D, krows, vrows, load, seg,
                       p.G, L, lo, end, p.window, p.sink, p.o_parts + part_idx * p.G * D,
                       p.lse_parts + part_idx * p.G, sK, sV);
}

// ------------------------------------------------------------ paged decode

constexpr int kPagedWarps = 4;    // workers of a CTA, each owning whole pages
constexpr int kPagedCluster = 2;  // CTAs of a split, merged through distributed shared memory
constexpr int kPagedWorkers = kPagedWarps * kPagedCluster;
constexpr int kPieceRows = 64;    // rows of one bulk copy: a page of up to 64 rows
constexpr int kPartFloats = kMaxGroup * 128 + 2 * kMaxGroup;  // a worker's acc, m, l

// The visible positions of a sequence of length L: [0, L), and with a window
// only those at or past L - window or before the sink. The logical pages of
// a split [page0, page1) that hold one form at most two ascending ranges
// (the sink's pages, the window's pages), numbered by ordinal.
struct VisiblePages {
  int L, ps, win_lo, sink;  // win_lo: the first in-window position (0: no window)
  int a0, a1, b0, b1, count;

  __device__ VisiblePages(int L_, int ps_, int page0, int page1, int window, int sink_)
      : L(L_), ps(ps_), win_lo(window < 0 ? 0 : max(L_ - window, 0)), sink(window < 0 ? 0 : sink_) {
    const int past = (L + ps - 1) / ps;  // pages with a row before L
    a0 = a1 = page0;
    if (window >= 0) a1 = max(page0, min(page1, (min(sink, L) + ps - 1) / ps));
    b0 = max(page0, win_lo / ps);
    b1 = max(b0, min(page1, past));
    if (a1 >= b0) {  // the ranges meet: one
      b0 = a0;
      b1 = max(a1, b1);
      a1 = a0;
    }
    count = (a1 - a0) + (b1 - b0);
  }
  __device__ __forceinline__ int page(int ordinal) const {
    return ordinal < a1 - a0 ? a0 + ordinal : b0 + ordinal - (a1 - a0);
  }
  // Whether positions [lo, hi) hold a visible one.
  __device__ __forceinline__ bool any(int lo, int hi) const {
    hi = min(hi, L);
    return lo < hi && (hi > win_lo || lo < sink);
  }
  __device__ __forceinline__ bool visible(int pos) const {
    return pos < L && (pos >= win_lo || pos < sink);
  }
};

// The pieces (bulk copies of at most kPieceRows rows) with a visible row of
// visible pages o .. o1 - 1, in logical order; a page of at most
// kPieceRows rows is one piece.
struct PieceWalk {
  const VisiblePages* vis;
  int o, o1, piece, pieces;
  __device__ __forceinline__ bool next(int& page, int& pc) {
    while (o < o1) {
      page = vis->page(o);
      pc = piece;
      if (++piece == pieces) {
        piece = 0;
        ++o;
      }
      const int lo = page * vis->ps + pc * kPieceRows;
      if (vis->any(lo, min(lo + kPieceRows, (page + 1) * vis->ps))) return true;
    }
    return false;
  }
};

// c (16 x 8 f32) += a (16 x 16 bf16) b (16 x 8 bf16), mma.sync fragments.
__device__ __forceinline__ void mma16816(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Word x (0 .. 3, known at compile time) of a 16-byte load.
__device__ __forceinline__ uint32_t word(const uint4& v, int x) {
  return x == 0 ? v.x : x == 1 ? v.y : x == 2 ? v.z : v.w;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The paged split: a cluster of kPagedCluster CTAs of kPagedWarps warps, the
// split's visible pages dealt to its kPagedWorkers warps in contiguous runs
// of ordinals (kernels/flash_decode.py paged_deal). Each warp streams its
// pages through its own ring of bulk copies and keeps its own (m, l, acc);
// the CTA of rank 0 merges the workers in order and writes the partial.
template <int D>
__global__ void __cluster_dims__(1, kPagedCluster, 1) __launch_bounds__(kPagedWarps * 32)
    fa2_decode_paged_kernel(const PagedParams p) {
  static_assert(D == 128, "the paged decode takes head_dim 128");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int bhk = blockIdx.x, split = blockIdx.y / kPagedCluster;
  const int b = bhk / p.Hkv, hk = bhk % p.Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g8 = lane / 4, c4 = lane % 4;
  // q as the B operand of S^T = K q^T: column g8 (a q head; zeros past G),
  // head_dim in the order of the K fragments below (words 16 kk2 + 4 c4 ..
  // + 3 of a row feed k-steps 2 kk2 and 2 kk2 + 1). Loaded first, so that
  // its latency overlaps the length's.
  uint4 qb[4];
#pragma unroll
  for (int kk2 = 0; kk2 < 4; ++kk2) {
    qb[kk2] = make_uint4(0u, 0u, 0u, 0u);
    if (g8 < p.G)
      qb[kk2] = *reinterpret_cast<const uint4*>(p.q + (static_cast<long long>(bhk) * p.G + g8) * D +
                                                kk2 * 32 + c4 * 8);
  }
  const int L = max(min(p.lengths[b], p.n_pages * p.ps), 0);
  const int page0 = split * p.pp;
  const VisiblePages vis(L, p.ps, page0, min(page0 + p.pp, p.n_pages), p.window, p.sink);
  const long long part = static_cast<long long>(bhk) * p.ns + split;
  if (vis.count == 0) {  // nothing visible (the same in every CTA of the cluster): (0, -inf)
    if (rank == 0)
      for (int i = threadIdx.x; i < p.G * D; i += blockDim.x) {
        p.o_parts[part * p.G * D + i] = 0.f;
        if (i < p.G) p.lse_parts[part * p.G + i] = -INFINITY;
      }
    return;
  }

  // Shared memory: per warp `slots` stages of a K and a V piece (rows
  // rounded up to 16), then each worker's (acc, m, l), then the warps'
  // full barriers.
  const int piece_rows = min(p.ps, kPieceRows);
  const uint32_t half = static_cast<uint32_t>((piece_rows + 15) / 16 * 16) * D * 2;
  unsigned char* ring = smem_raw + static_cast<size_t>(warp) * p.slots * 2 * half;
  float* parts = reinterpret_cast<float*>(smem_raw + static_cast<size_t>(kPagedWarps) * p.slots * 2 * half);
  uint64_t* full = reinterpret_cast<uint64_t*>(parts + kPagedWarps * kPartFloats) + warp * p.slots;
  if (lane == 0) {
    for (int s = 0; s < p.slots; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();

  // This warp's visible ordinals and their pieces; lane 0 issues the
  // copies `slots` pieces ahead of the math.
  const int worker = rank * kPagedWarps + warp;
  const int o0 = worker * vis.count / kPagedWorkers, o1 = (worker + 1) * vis.count / kPagedWorkers;
  const int pieces = (p.ps + kPieceRows - 1) / kPieceRows;
  PieceWalk walk{&vis, o0, o1, 0, pieces}, ahead = walk;
  const __nv_bfloat16* kplane = p.k + static_cast<long long>(hk) * p.P * p.ps * D;
  const __nv_bfloat16* vplane = p.v + static_cast<long long>(hk) * p.P * p.ps * D;
  const int* tbl = p.table + static_cast<long long>(b) * p.n_pages;
  int cur_page = -1, phys = 0;  // lane 0: the table entry of the last page issued
  auto issue = [&](int n) {     // lane 0: the next piece of `ahead` into stage n % slots
    int page, pc;
    if (!ahead.next(page, pc)) return;
    if (page != cur_page) {
      cur_page = page;
      phys = tbl[page];
      if (phys < 0 || phys >= p.P) phys = 0;  // outside the pool: the null page
    }
    const int rows = min(kPieceRows, p.ps - pc * kPieceRows);
    const long long at = (static_cast<long long>(phys) * p.ps + pc * kPieceRows) * D;
    const uint32_t bytes = static_cast<uint32_t>(rows) * D * 2;
    unsigned char* st = ring + static_cast<size_t>(n % p.slots) * 2 * half;
    uint64_t* bar = &full[n % p.slots];
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
                 "r"(2 * bytes)
                 : "memory");
    bulk_load(st, kplane + at, bytes, bar);
    bulk_load(st + half, vplane + at, bytes, bar);
  };
  if (lane == 0)
    for (int n = 0; n < p.slots; ++n) issue(n);

  // O^T (D x G) accumulators: m-tile mt, rows (head_dim) 16 g8 + 2 mt (+1),
  // columns (q heads) 2 c4 (+1); the running max of heads 2 c4, 2 c4 + 1
  // (natural log, and times log2 e) and this thread's share of their sums.
  float acc[8][4];
#pragma unroll
  for (int mt = 0; mt < 8; ++mt) acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, ms[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  int page, pc;
  for (int n = 0; walk.next(page, pc); ++n) {
    mbar_wait(&full[n % p.slots], (n / p.slots) & 1);
    const unsigned char* sk = ring + static_cast<size_t>(n % p.slots) * 2 * half;
    const unsigned char* sv = sk + half;
    const int base = page * p.ps + pc * kPieceRows;
    const int rows = min(kPieceRows, p.ps - pc * kPieceRows);
    for (int u = 0; u < rows; u += 16) {
      // Units of 16 rows; row r is visible if it is one of the piece's and
      // its position is. Rows that are not (past the length: stale pool
      // data) take the mask value in S and zeros in V.
      auto row_ok = [&](int r) { return u + r < rows && vis.visible(base + u + r); };
      if (!vis.any(base + u, base + min(u + 16, rows))) continue;  // uniform in the warp
      const unsigned char* ku = sk + u * D * 2;
      const unsigned char* vu = sv + u * D * 2;
      // S^T (16 kv rows x 8 heads) = K q^T: rows 2 g8, 2 g8 + 1 of the unit
      // are the fragment's rows g8, g8 + 8.
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk2 = 0; kk2 < 4; ++kk2) {
        const uint4 x = *reinterpret_cast<const uint4*>(ku + (2 * g8) * D * 2 + kk2 * 64 + c4 * 16);
        const uint4 y =
            *reinterpret_cast<const uint4*>(ku + (2 * g8 + 1) * D * 2 + kk2 * 64 + c4 * 16);
        mma16816(c, x.x, y.x, x.y, y.y, qb[kk2].x, qb[kk2].y);
        mma16816(c, x.z, y.z, x.w, y.w, qb[kk2].z, qb[kk2].w);
      }
      const bool va = row_ok(2 * g8), vb = row_ok(2 * g8 + 1);
      if (!va) c[0] = c[1] = kMaskValue;
      if (!vb) c[2] = c[3] = kMaskValue;
      // Online softmax of heads 2 c4 (c0, c2) and 2 c4 + 1 (c1, c3) over the
      // unit's rows: the max over the 8 lanes of the same c4.
      float mx[2] = {fmaxf(c[0], c[2]), fmaxf(c[1], c[3])}, alpha[2], pr[2][2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], off));
        const float m_new = fmaxf(m[e], mx[e]), ms_new = m_new * kLog2e;
        alpha[e] = exp2f(ms[e] - ms_new);  // 0 on the first unit (ms = -inf)
        pr[e][0] = exp2f(fmaf(c[e], kLog2e, -ms_new));
        pr[e][1] = exp2f(fmaf(c[e + 2], kLog2e, -ms_new));
        l[e] = l[e] * alpha[e] + pr[e][0] + pr[e][1];
        m[e] = m_new;
        ms[e] = ms_new;
      }
#pragma unroll
      for (int mt = 0; mt < 8; ++mt) {
        acc[mt][0] *= alpha[0];
        acc[mt][1] *= alpha[1];
        acc[mt][2] *= alpha[0];
        acc[mt][3] *= alpha[1];
      }
      // P^T as the B operand of O^T += V^T P^T (bf16, as the JAX kernel
      // casts P): column g8, rows 2 c4 (+1) and 2 c4 + 8 (+9), from the lanes
      // whose S^T rows those are.
      const uint32_t pk[2] = {pack_bf16(pr[0][0], pr[0][1]), pack_bf16(pr[1][0], pr[1][1])};
      const int src = 4 * c4 + (g8 >> 1);
      const uint32_t e0 = __shfl_sync(0xffffffffu, pk[0], src);
      const uint32_t d0 = __shfl_sync(0xffffffffu, pk[1], src);
      const uint32_t e1 = __shfl_sync(0xffffffffu, pk[0], src + 16);
      const uint32_t d1 = __shfl_sync(0xffffffffu, pk[1], src + 16);
      const uint32_t b0 = (g8 & 1) ? d0 : e0, b1 = (g8 & 1) ? d1 : e1;
      // V rows 2 c4, 2 c4 + 1, 2 c4 + 8, 2 c4 + 9, head_dim 16 g8 .. + 15
      // (m-tile mt: word mt), zeros where the row is not visible.
      uint4 vr[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 2 * c4 + (i & 1) + (i >> 1) * 8;
        const bool ok = row_ok(r);
#pragma unroll
        for (int hlf = 0; hlf < 2; ++hlf) {
          const uint4 x = *reinterpret_cast<const uint4*>(vu + r * D * 2 + g8 * 32 + hlf * 16);
          vr[i][hlf] = ok ? x : make_uint4(0u, 0u, 0u, 0u);
        }
      }
#pragma unroll
      for (int mt = 0; mt < 8; ++mt) {
        const uint32_t w0 = word(vr[0][mt >> 2], mt & 3), w1 = word(vr[1][mt >> 2], mt & 3);
        const uint32_t w2 = word(vr[2][mt >> 2], mt & 3), w3 = word(vr[3][mt >> 2], mt & 3);
        mma16816(acc[mt], __byte_perm(w0, w1, 0x5410), __byte_perm(w0, w1, 0x7632),
                 __byte_perm(w2, w3, 0x5410), __byte_perm(w2, w3, 0x7632), b0, b1);
      }
    }
    __syncwarp();  // every lane has read this stage
    if (lane == 0) issue(n + p.slots);
  }

  // This worker's (acc, m, l) into its CTA's shared memory: acc[g][d], then
  // m[g], l[g].
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 4);
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 8);
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 16);
  }
  float* mine = parts + warp * kPartFloats;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    float* row = mine + (2 * c4 + e) * D + 16 * g8;
#pragma unroll
    for (int mt = 0; mt < 8; ++mt)
      *reinterpret_cast<float2*>(row + 2 * mt) = make_float2(acc[mt][e], acc[mt][e + 2]);
    if (g8 == 0) {
      mine[kMaxGroup * D + 2 * c4 + e] = m[e];
      mine[kMaxGroup * D + kMaxGroup + 2 * c4 + e] = l[e];
    }
  }
  cluster.sync();  // every worker's partial is in its CTA's shared memory

  // Rank 0 merges the workers in order (by logical position), the other
  // CTA's over distributed shared memory: warp w takes heads w, w + 4, ..,
  // lane l columns 4 l .. 4 l + 3, so that all the loads of a head go out
  // together.
  auto part_of = [&](int k) -> const float* {
    return cluster.map_shared_rank(parts, k / kPagedWarps) + (k % kPagedWarps) * kPartFloats;
  };
  if (rank == 0) {
    for (int g = warp; g < p.G; g += kPagedWarps) {
      float mk[kPagedWorkers], lk[kPagedWorkers];
      float4 ak[kPagedWorkers];
#pragma unroll
      for (int k = 0; k < kPagedWorkers; ++k) {
        const float* w = part_of(k);
        mk[k] = w[kMaxGroup * D + g];
        lk[k] = w[kMaxGroup * D + kMaxGroup + g];
        ak[k] = *reinterpret_cast<const float4*>(w + g * D + 4 * lane);
      }
      float mx = -INFINITY;
#pragma unroll
      for (int k = 0; k < kPagedWorkers; ++k) mx = fmaxf(mx, mk[k]);
      float sum = 0.f;
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int k = 0; k < kPagedWorkers; ++k) {
        const float e = expf(mk[k] - mx);  // 0 for a worker with no rows
        sum += e * lk[k];
        o.x += e * ak[k].x;
        o.y += e * ak[k].y;
        o.z += e * ak[k].z;
        o.w += e * ak[k].w;
      }
      *reinterpret_cast<float4*>(p.o_parts + (part * p.G + g) * D + 4 * lane) =
          make_float4(o.x / sum, o.y / sum, o.z / sum, o.w / sum);
      if (lane == 0) p.lse_parts[part * p.G + g] = mx + logf(sum);
    }
  }
  cluster.sync();  // rank 0 has read the other CTA's shared memory
}

template <class Kernel, class Params>
cudaError_t launch(Kernel kernel, const Params& p, dim3 grid, int threads, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fa2_decode_bf16(const void* q, const void* k, const void* v, const void* lengths,
                               void* o_parts, void* lse_parts, long long k_sb, long long k_ss,
                               long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                               int batch, int Hkv, int G, int S, int head_dim, int chunk, int ns,
                               int window, int sink, const void* kv_seg, long long kv_seg_sb,
                               const void* q_seg, void* stream) {
  DecodeParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.lengths = static_cast<const int*>(lengths);
  p.o_parts = static_cast<float*>(o_parts);
  p.lse_parts = static_cast<float*>(lse_parts);
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.Hkv = Hkv; p.G = G; p.S = S; p.chunk = chunk; p.ns = ns;
  p.window = window; p.sink = sink;
  p.kv_seg = static_cast<const int*>(kv_seg);
  p.kv_seg_sb = kv_seg_sb;
  p.q_seg = static_cast<const int*>(q_seg);
  if (G < 1 || G > kMaxGroup) return cudaErrorInvalidValue;
  const bool seg = kv_seg != nullptr;  // null ids: the unsegmented kernel
  const dim3 grid(batch * Hkv, ns);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 128)
    return seg ? launch(fa2_decode_kernel<128, true>, p, grid, 128, ring_bytes<128>(), s)
               : launch(fa2_decode_kernel<128, false>, p, grid, 128, ring_bytes<128>(), s);
  if (head_dim == 64)
    return seg ? launch(fa2_decode_kernel<64, true>, p, grid, 64, ring_bytes<64>(), s)
               : launch(fa2_decode_kernel<64, false>, p, grid, 64, ring_bytes<64>(), s);
  return cudaErrorInvalidValue;
}

extern "C" int fa2_decode_paged_bf16(const void* q, const void* k_pages, const void* v_pages,
                                     const void* lengths, const void* table, void* o_parts,
                                     void* lse_parts, int batch, int Hkv, int G, int P, int ps,
                                     int n_pages, int head_dim, int pp, int ns, int window,
                                     int sink, void* stream) {
  PagedParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k_pages);
  p.v = static_cast<const __nv_bfloat16*>(v_pages);
  p.lengths = static_cast<const int*>(lengths);
  p.table = static_cast<const int*>(table);
  p.o_parts = static_cast<float*>(o_parts);
  p.lse_parts = static_cast<float*>(lse_parts);
  p.Hkv = Hkv; p.G = G; p.P = P; p.ps = ps; p.n_pages = n_pages; p.pp = pp; p.ns = ns;
  p.window = window; p.sink = sink;
  if (G < 1 || G > kMaxGroup || head_dim != 128 || ps < 1 || pp < 1) return cudaErrorInvalidValue;
  // Two stages a warp where the ring stays within 128 KB (pieces of up to
  // 32 rows), else one (pieces of 64 rows: 128 KB for the four warps).
  const size_t half = static_cast<size_t>((min(ps, kPieceRows) + 15) / 16 * 16) * 128 * 2;
  p.slots = 2 * kPagedWarps * 2 * half <= 128 * 1024 ? 2 : 1;
  const size_t smem = kPagedWarps * (p.slots * (2 * half + sizeof(uint64_t)) +
                                     kPartFloats * sizeof(float));
  return launch(fa2_decode_paged_kernel<128>, p, dim3(batch * Hkv, ns * kPagedCluster),
                kPagedWarps * 32, smem, static_cast<cudaStream_t>(stream));
}
