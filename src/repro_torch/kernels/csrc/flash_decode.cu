// Split-KV flash decode for Hopper (sm_90a): one new token per sequence,
// against a contiguous cache or through a block table into a page pool.
//
// Two entries, one unit math:
//   * fa2_decode_bf16 replaces the Pallas TPU kernel
//     src/repro/kernels/flash_decode.py:77 flash_decode_kernel (body
//     _decode_kernel :34). It reads the (B, S, Hkv, D) serving cache in
//     place, at head_dim 128 (qwen3), 64 (whisper), 256 (gemma3) and 160
//     (stablelm). Splits are ceil-div, 8-aligned chunks of S (kernels/flash_decode.py decode_geometry). Its
//     SEG instantiation is the packed cache of the same kernel (segment
//     branch, mask at :52-55): with int32 ids kv_seg (B, S) and q_seg (B,),
//     a position is visible only where kv_seg[b, g] == q_seg[b], ANDed into
//     the length and window mask. With all ids equal its arithmetic is the
//     unsegmented kernel's, bit for bit. Its body is fa2_decode_kernel.
//   * fa2_decode_paged_bf16 replaces src/repro/kernels/flash_decode.py:250
//     flash_decode_paged_kernel (body _paged_decode_kernel :161). K/V live
//     in the pool's page planes (Hkv, P, ps, D); logical row g of sequence
//     b sits in physical page tbl[b, g / ps] at offset g % ps. Split c
//     covers the pp logical pages [c * pp, c * pp + pp), the JAX geometry
//     (ns = ceil(n_pages / pp)). Its body is fa2_decode_paged_kernel, at
//     head_dim 128 (qwen3), 64 (granite-moe), 160 and 256.
// Both write, per (batch * kv head, split), the G q heads of one GQA group
// as a locally normalized f32 partial (o, lse) in the JAX layout, o_parts
// (B*Hkv, ns, G, D) and lse_parts (B*Hkv, ns, G); the caller folds the
// splits with combine_lse_outputs.
//
// What bounds them on an H100: decode does 4 * G * D flops per cached
// position against 2 * D * 2 bytes of K/V, so it is bound by HBM (3.35
// TB/s) by two orders of magnitude. Both move only the bytes the data
// needs, once: K/V in place, one K/V row for all G q heads of its group, no
// position at or past the sequence's length and no unit (contiguous) or
// page (paged) without a visible position, so a short sequence in a long
// cache costs what its length costs. At the serving shape (B 4, lengths 15
// to 1508 of 2048, 8 splits, 8 kv heads, D 128) the bound is 0.0030 ms,
// below the card's own floor for a launch that reads its lengths and
// writes its partials; what is left is latency: the launch, one round trip
// to HBM for the copies, the last warps' math, the merge.
//
// The two share one design, built from the device functions below
// (unit_scores, unit_softmax, unit_pv, store_worker, merge_workers):
//   * a split is a cluster of two CTAs of four warps; its visible units (16
//     rows of the cache, or pages) form at most two ascending runs, the
//     sink's and the window's (VisibleUnits), dealt to the eight warps in
//     contiguous runs of ordinals (kernels/flash_decode.py decode_deal and
//     paged_deal state the dealing). At the serving shape 168 of the 512
//     CTAs have work (the earlier design, one CTA of D threads a split
//     that walked its 64-row tiles one after another, had 88 of 256), and a
//     warp of a full 256-row split holds two units;
//   * each warp streams its units through its own ring of stages on
//     mbarriers, with no CTA-wide barrier in the loop. Contiguous: rows of
//     one kv head sit Hkv * D * 2 bytes apart (2 KB for qwen3, 1 KB for
//     whisper), so a unit is sixteen 1-D bulk copies (cp.async.bulk, D * 2
//     bytes each) of K and sixteen of V, issued by the warp's 32 lanes at
//     once and counted on the stage's barrier; no row at or past min(end,
//     S) is read. Paged: lane 0 moves each page of K and of V as one bulk
//     copy (ps * D * 2 bytes; a page of more than 64 rows in pieces of 64,
//     at head_dim 160 and 256 of more than 32 rows in pieces of 32, so that
//     a piece of K and V stays within 32 KB);
//   * the math is mma.sync (m16n8k16) on 16-row units: S^T = K q^T with the
//     unit's 16 kv rows as the fragment's rows and the G <= 8 q heads as
//     its 8 columns (K read straight from the copied rows: the head_dim
//     order of the fragments is permuted, the same for K and q, so each
//     thread reads 16-byte runs; at G 1, seven columns are zeros: the
//     kernel is bound by HBM, not by the tensor cores); the online softmax
//     in the exp2 domain per q head over the unit; O^T += V^T P^T with P^T
//     moved between lanes by shuffles and V's rows reordered in registers
//     (byte permutes). The unswizzled rows cost 2-way (K) and 4-way (V)
//     bank conflicts, which a bulk copy cannot avoid;
//   * rows inside a fetched unit that are not visible (past the length,
//     outside the window, with SEG of another segment) take the finite
//     mask value in S and a select to zero in V, never a multiply, since
//     shared memory there holds stale or uninitialised bytes (stale pool or
//     cache rows may be NaN); a unit none of whose rows is visible (with
//     SEG: of other segments only) skips its softmax by a warp vote, as
//     the mask value's log2(e) multiple overflows f32 to -inf;
//   * each warp keeps its own (m, l, acc) and leaves it in its CTA's shared
//     memory; after a cluster barrier rank 0 merges the eight in worker
//     order (by position), the other CTA's over distributed shared memory,
//     a warp per q head so that a head's loads go out together, and a
//     second barrier keeps the other CTA alive until it has read them. A
//     split in which no worker saw a visible row (every length-0 row; with
//     SEG a split of other segments only) gives (o = 0, lse = -inf).
// What bounds them now (tools/ab_kernels.py on an H100 80GB HBM3 at 700 W,
// serving shape, L2 flushed before each launch; PERF.md has the runs): a
// contiguous launch whose lengths are all 0 takes 0.0067 ms, the copies and
// the merge without the math 0.0129, the math on whatever the stages hold
// without copies 0.0115, the whole kernel 0.0152 (the paged one 0.0160):
// the launch of 512 clustered CTAs, one round trip to HBM, then the last
// warps' math and the merge. Measured slower for the contiguous kernel:
// one CTA a split (1.16x), 8 warps a CTA (1.28x), one stage a warp
// (1.12x), four (1.28x: fewer CTAs fit an SM); 16-byte cp.async copies
// instead of a bulk copy a row 0.98x (0.95x at whisper's self shape, 0.99x
// at its cross shape), evict-first copies 1.00x.
//
// Scores are f32 sums of bf16 products; P is rounded to bf16 before P V, as
// the JAX kernels do; masked scores take the finite DEFAULT_MASK_VALUE.
// The arithmetic depends on positions only, so the physical order of pages
// does not change a paged result by one bit.

#include <cooperative_groups.h>
#include <math.h>

#include "sm90.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxGroup = 8;  // q heads of a GQA group: the mma fragment's 8 columns
constexpr int kUnit = 16;     // kv rows of an mma unit

// A worker's partial in its CTA's shared memory: acc[g][d], then m[g], l[g].
template <int D>
__host__ __device__ constexpr int part_floats() {
  return kMaxGroup * D + 2 * kMaxGroup;
}

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

// The visible positions of one split, in units of `size` positions: unit u
// holds positions [u * size, u * size + size). Nothing at or past `limit`
// is visible; below it a position is visible at or past `win_lo` or before
// `sink` (no window: win_lo = sink = 0). The units [u0, u1) of a split that
// hold a visible position form at most two ascending ranges (the sink's,
// the window's), numbered by ordinal. The contiguous kernel counts
// positions from its split's start (16-row units), the paged one from 0
// (pages).
struct VisibleUnits {
  int limit, size, win_lo, sink;
  int a0, a1, b0, b1, count;

  __device__ VisibleUnits(int limit_, int size_, int u0, int u1, int win_lo_, int sink_)
      : limit(limit_), size(size_), win_lo(win_lo_), sink(sink_) {
    const int past = (limit + size - 1) / size;  // units with a position before the limit
    a0 = u0;
    a1 = max(u0, min(u1, (min(sink, limit) + size - 1) / size));
    b0 = max(u0, max(win_lo, 0) / size);
    b1 = max(b0, min(u1, past));
    if (a1 >= b0) {  // the ranges meet: one
      b0 = a0;
      b1 = max(a1, b1);
      a1 = a0;
    }
    count = (a1 - a0) + (b1 - b0);
  }
  __device__ __forceinline__ int unit(int ordinal) const {
    return ordinal < a1 - a0 ? a0 + ordinal : b0 + ordinal - (a1 - a0);
  }
  // Whether positions [lo, hi) hold a visible one.
  __device__ __forceinline__ bool any(int lo, int hi) const {
    hi = min(hi, limit);
    return lo < hi && (hi > win_lo || lo < sink);
  }
  __device__ __forceinline__ bool visible(int pos) const {
    return pos < limit && (pos >= win_lo || pos < sink);
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

// ------------------------------------------------------- the unit math
// A warp's lanes: g8 = lane / 4, c4 = lane % 4, the mma fragments' row and
// column groups. `rows` has bit r set where row r of a 16-row unit is
// visible.

// q (the G q heads at qg, (G, D)) as the B operand of S^T = K q^T: column
// g8 (a q head; zeros past G), head_dim in the order of the K fragments
// (words 16 kk2 + 4 c4 .. + 3 of a row feed k-steps 2 kk2 and 2 kk2 + 1).
template <int D>
__device__ __forceinline__ void load_q(uint4 (&qb)[D / 32], const __nv_bfloat16* qg, int G,
                                       int g8, int c4) {
#pragma unroll
  for (int kk2 = 0; kk2 < D / 32; ++kk2) {
    qb[kk2] = make_uint4(0u, 0u, 0u, 0u);
    if (g8 < G) qb[kk2] = *reinterpret_cast<const uint4*>(qg + g8 * D + kk2 * 32 + c4 * 8);
  }
}

// S^T (16 kv rows x 8 q heads) = K q^T of the unit whose K rows (D bf16
// each, unpadded) start at ku: rows 2 g8, 2 g8 + 1 of the unit are the
// fragment's rows g8, g8 + 8. Rows that are not visible take the mask
// value.
template <int D>
__device__ __forceinline__ void unit_scores(float (&c)[4], const unsigned char* ku,
                                            const uint4 (&qb)[D / 32], unsigned rows, int g8,
                                            int c4) {
  c[0] = c[1] = c[2] = c[3] = 0.f;
#pragma unroll
  for (int kk2 = 0; kk2 < D / 32; ++kk2) {
    const uint4 x = *reinterpret_cast<const uint4*>(ku + (2 * g8) * D * 2 + kk2 * 64 + c4 * 16);
    const uint4 y = *reinterpret_cast<const uint4*>(ku + (2 * g8 + 1) * D * 2 + kk2 * 64 + c4 * 16);
    mma16816(c, x.x, y.x, x.y, y.y, qb[kk2].x, qb[kk2].y);
    mma16816(c, x.z, y.z, x.w, y.w, qb[kk2].z, qb[kk2].w);
  }
  if (!((rows >> (2 * g8)) & 1u)) c[0] = c[1] = kMaskValue;
  if (!((rows >> (2 * g8 + 1)) & 1u)) c[2] = c[3] = kMaskValue;
}

// What one unit's softmax hands to P V: the rescale of heads 2 c4 and
// 2 c4 + 1, and P^T as the B operand of O^T += V^T P^T.
struct UnitP {
  float alpha[2];
  uint32_t b0, b1;
};

// The online softmax in the exp2 domain of heads 2 c4 (c0, c2) and 2 c4 + 1
// (c1, c3) over the unit's rows (the max over the 8 lanes of the same c4):
// m is the running max (natural log), ms the same times log2 e (-inf before
// the first unit, so alpha is 0 there), l this thread's share of the sums.
// P^T (bf16, as the JAX kernel casts P): column g8, rows 2 c4 (+1) and
// 2 c4 + 8 (+9), from the lanes whose S^T rows those are.
__device__ __forceinline__ UnitP unit_softmax(const float (&c)[4], float (&m)[2], float (&ms)[2],
                                              float (&l)[2], int g8, int c4) {
  UnitP u;
  float mx[2] = {fmaxf(c[0], c[2]), fmaxf(c[1], c[3])}, pr[2][2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], off));
    const float m_new = fmaxf(m[e], mx[e]), ms_new = m_new * kLog2e;
    u.alpha[e] = exp2f(ms[e] - ms_new);  // 0 on the first unit (ms = -inf)
    pr[e][0] = exp2f(fmaf(c[e], kLog2e, -ms_new));
    pr[e][1] = exp2f(fmaf(c[e + 2], kLog2e, -ms_new));
    l[e] = l[e] * u.alpha[e] + pr[e][0] + pr[e][1];
    m[e] = m_new;
    ms[e] = ms_new;
  }
  const uint32_t pk[2] = {pack_bf16(pr[0][0], pr[0][1]), pack_bf16(pr[1][0], pr[1][1])};
  const int src = 4 * c4 + (g8 >> 1);
  const uint32_t e0 = __shfl_sync(0xffffffffu, pk[0], src);
  const uint32_t d0 = __shfl_sync(0xffffffffu, pk[1], src);
  const uint32_t e1 = __shfl_sync(0xffffffffu, pk[0], src + 16);
  const uint32_t d1 = __shfl_sync(0xffffffffu, pk[1], src + 16);
  u.b0 = (g8 & 1) ? d0 : e0;
  u.b1 = (g8 & 1) ? d1 : e1;
  return u;
}

// O^T (D x 8 f32) = alpha O^T + V^T P^T over the unit whose V rows start at
// vu. acc[mt] (m-tile mt): rows (head_dim) (D / 8) g8 + 2 mt (+1), columns
// (q heads) 2 c4 (+1). A thread reads V rows 2 c4, 2 c4 + 1, 2 c4 + 8,
// 2 c4 + 9 at head_dim (D / 8) g8 .. + D / 8 - 1 (m-tile mt: word mt), and
// zeros where the row is not visible (a select: the bytes there may be NaN).
// Its D / 4 bytes of a row are 16-byte loads where D / 4 is a multiple of 16
// (D 64, 128, 256); at 160 they are 40 bytes at an 8-byte-aligned offset,
// read as five 8-byte loads.
template <int D>
__device__ __forceinline__ void unit_pv(float (&acc)[D / 16][4], const unsigned char* vu,
                                        const UnitP& u, unsigned rows, int g8, int c4) {
#pragma unroll
  for (int mt = 0; mt < D / 16; ++mt) {
    acc[mt][0] *= u.alpha[0];
    acc[mt][1] *= u.alpha[1];
    acc[mt][2] *= u.alpha[0];
    acc[mt][3] *= u.alpha[1];
  }
  uint32_t vr[4][D / 16];  // word mt of each row: m-tile mt
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 2 * c4 + (i & 1) + (i >> 1) * 8;
    const bool ok = (rows >> r) & 1u;
    const unsigned char* at = vu + r * D * 2 + g8 * (D / 4);
    if constexpr ((D / 4) % 16 == 0) {
#pragma unroll
      for (int h = 0; h < D / 64; ++h) {
        const uint4 x = *reinterpret_cast<const uint4*>(at + h * 16);
#pragma unroll
        for (int e = 0; e < 4; ++e) vr[i][4 * h + e] = ok ? word(x, e) : 0u;
      }
    } else {
#pragma unroll
      for (int h = 0; h < D / 32; ++h) {
        const uint2 x = *reinterpret_cast<const uint2*>(at + h * 8);
        vr[i][2 * h] = ok ? x.x : 0u;
        vr[i][2 * h + 1] = ok ? x.y : 0u;
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < D / 16; ++mt) {
    const uint32_t w0 = vr[0][mt], w1 = vr[1][mt], w2 = vr[2][mt], w3 = vr[3][mt];
    mma16816(acc[mt], __byte_perm(w0, w1, 0x5410), __byte_perm(w0, w1, 0x7632),
             __byte_perm(w2, w3, 0x5410), __byte_perm(w2, w3, 0x7632), u.b0, u.b1);
  }
}

// A worker's (acc, m, l) into its slot `mine` of its CTA's shared memory
// (part_floats<D>() floats: acc[g][d], then m[g], then l[g]).
template <int D>
__device__ __forceinline__ void store_worker(float* mine, const float (&acc)[D / 16][4],
                                             const float (&m)[2], float (&l)[2], int g8, int c4) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 4);
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 8);
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 16);
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    float* row = mine + (2 * c4 + e) * D + (D / 8) * g8;
#pragma unroll
    for (int mt = 0; mt < D / 16; ++mt)
      *reinterpret_cast<float2*>(row + 2 * mt) = make_float2(acc[mt][e], acc[mt][e + 2]);
    if (g8 == 0) {
      mine[kMaxGroup * D + 2 * c4 + e] = m[e];
      mine[kMaxGroup * D + kMaxGroup + 2 * c4 + e] = l[e];
    }
  }
}

// N floats, aligned as far as N allows (N 5 at head_dim 160: 4 bytes).
template <int N>
struct alignas(4 * (N & -N)) Floats {
  float v[N];
};

// Rank 0's merge of the WARPS * CLUSTER workers' partials (worker k: warp
// k % WARPS of CTA k / WARPS, slots of `parts` in each CTA's shared memory)
// in worker order, the other CTAs' over distributed shared memory: warp w
// takes heads w, w + WARPS, .., lane l columns D / 32 l .. + D / 32 - 1, so
// that all the loads of a head go out together. Writes o_out (G, D) and
// lse_out (G); (0, -inf) where no worker saw a visible row.
template <int D, int WARPS, int CLUSTER>
__device__ __forceinline__ void merge_workers(float* parts, int G, int warp, int lane,
                                              float* o_out, float* lse_out) {
  constexpr int WORKERS = WARPS * CLUSTER, CPL = D / 32;
  cg::cluster_group cluster = cg::this_cluster();
  for (int g = warp; g < G; g += WARPS) {
    float mk[WORKERS], lk[WORKERS];
    Floats<CPL> ak[WORKERS];
#pragma unroll
    for (int k = 0; k < WORKERS; ++k) {
      const float* w = cluster.map_shared_rank(parts, k / WARPS) + (k % WARPS) * part_floats<D>();
      mk[k] = w[kMaxGroup * D + g];
      lk[k] = w[kMaxGroup * D + kMaxGroup + g];
      ak[k] = *reinterpret_cast<const Floats<CPL>*>(w + g * D + CPL * lane);
    }
    float mx = -INFINITY;
#pragma unroll
    for (int k = 0; k < WORKERS; ++k) mx = fmaxf(mx, mk[k]);
    Floats<CPL> o;
    if (mx == -INFINITY) {  // no worker saw a visible row
#pragma unroll
      for (int i = 0; i < CPL; ++i) o.v[i] = 0.f;
      *reinterpret_cast<Floats<CPL>*>(o_out + g * D + CPL * lane) = o;
      if (lane == 0) lse_out[g] = -INFINITY;
      continue;
    }
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < CPL; ++i) o.v[i] = 0.f;
#pragma unroll
    for (int k = 0; k < WORKERS; ++k) {
      const float e = expf(mk[k] - mx);  // 0 for a worker with no rows
      sum += e * lk[k];
#pragma unroll
      for (int i = 0; i < CPL; ++i) o.v[i] += e * ak[k].v[i];
    }
#pragma unroll
    for (int i = 0; i < CPL; ++i) o.v[i] = o.v[i] / sum;
    *reinterpret_cast<Floats<CPL>*>(o_out + g * D + CPL * lane) = o;
    if (lane == 0) lse_out[g] = mx + logf(sum);
  }
}

// A split with no visible position: (o = 0, lse = -inf), by one CTA.
__device__ __forceinline__ void write_empty(float* o_out, float* lse_out, int G, int D) {
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    o_out[i] = 0.f;
    if (i < G) lse_out[i] = -INFINITY;
  }
}

// ------------------------------------------------------ contiguous decode

constexpr int kDecodeWarps = 4;    // workers of a CTA, each owning a run of units
constexpr int kDecodeCluster = 2;  // CTAs of a split, merged through distributed shared memory
constexpr int kDecodeStages = 2;   // ring stages of each warp
constexpr int kUnitArrivals = 1;   // arrivals that open a stage: lane 0's expect_tx

template <int D>
constexpr size_t decode_smem() {  // per warp: the ring and its barriers; per worker: its partial
  return kDecodeWarps * (kDecodeStages * (2 * kUnit * D * 2 + sizeof(uint64_t)) +
                         part_floats<D>() * sizeof(float));
}

// One unit into a warp's stage (K rows, then V rows, D * 2 bytes each):
// rows r0 .. r0 + rows - 1 of the split whose row 0 is at k0 / v0, row
// strides k_ss / v_ss; lane r < 16 copies K row r, lane 16 + r V row r,
// each as one 1-D bulk copy counted on the stage's barrier. Rows past
// `rows` are never read.
template <int D>
__device__ __forceinline__ void issue_unit(unsigned char* stage, uint64_t* bar,
                                           const __nv_bfloat16* k0, long long k_ss,
                                           const __nv_bfloat16* v0, long long v_ss, int r0,
                                           int rows, int lane) {
  if (lane == 0)
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
                 "r"(2 * rows * D * 2)
                 : "memory");
  __syncwarp();
  const int r = lane % kUnit;
  if (r < rows) {
    const bool is_v = lane >= kUnit;
    const __nv_bfloat16* src = is_v ? v0 + (r0 + r) * v_ss : k0 + (r0 + r) * k_ss;
    bulk_load(stage + (is_v ? kUnit * D * 2 : 0) + r * D * 2, src, D * 2, bar);
  }
}

// The contiguous split: a cluster of kDecodeCluster CTAs of kDecodeWarps
// warps; the split's visible 16-row units (positions counted from the
// split's start lo) dealt to its warps in contiguous runs of ordinals
// (kernels/flash_decode.py decode_deal). Each warp streams its units
// through its own ring and keeps its own (m, l, acc); the CTA of rank 0
// merges the workers in order and writes the partial.
template <int D, bool SEG>
__global__ void __cluster_dims__(1, kDecodeCluster, 1) __launch_bounds__(kDecodeWarps * 32)
    fa2_decode_kernel(const DecodeParams p) {
  static_assert(D == 64 || D == 128 || D == 160 || D == 256,
                "the decode takes head_dim 64, 128, 160 or 256");
  constexpr int STAGE = 2 * kUnit * D * 2;  // a unit's K rows, then its V rows
  constexpr int WORKERS = kDecodeWarps * kDecodeCluster;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int bhk = blockIdx.x, split = blockIdx.y / kDecodeCluster;
  const int b = bhk / p.Hkv, hk = bhk % p.Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g8 = lane / 4, c4 = lane % 4;
  uint4 qb[D / 32];  // loaded first, so that its latency overlaps the length's
  load_q<D>(qb, p.q + static_cast<long long>(bhk) * p.G * D, p.G, g8, c4);
  const int L = max(min(p.lengths[b], p.S), 0);
  const int lo = split * p.chunk;
  const int end = min(min(lo + p.chunk, p.S), L);  // nothing at or past it is visible
  const int win_lo = p.window < 0 ? 0 : max(L - p.window, 0);
  const int sink = p.window < 0 ? 0 : p.sink;
  const VisibleUnits vis(end - lo, kUnit, 0, end > lo ? (end - lo + kUnit - 1) / kUnit : 0,
                         win_lo - lo, sink - lo);
  const long long part = static_cast<long long>(bhk) * p.ns + split;
  float* o_out = p.o_parts + part * p.G * D;
  float* lse_out = p.lse_parts + part * p.G;
  if (vis.count == 0) {  // the same in every CTA of the cluster
    if (rank == 0) write_empty(o_out, lse_out, p.G, D);
    return;
  }

  // Shared memory: per warp its ring, then each worker's partial, then the
  // warps' full barriers.
  unsigned char* ring = smem_raw + static_cast<size_t>(warp) * kDecodeStages * STAGE;
  float* parts = reinterpret_cast<float*>(smem_raw + kDecodeWarps * kDecodeStages * STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(parts + kDecodeWarps * part_floats<D>()) +
                   warp * kDecodeStages;
  if (lane == 0) {
    for (int s = 0; s < kDecodeStages; ++s) mbar_init(&full[s], kUnitArrivals);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();

  // This warp's visible ordinals; its lanes issue each unit's copies
  // kDecodeStages units ahead of the math.
  const int worker = rank * kDecodeWarps + warp;
  const int o0 = worker * vis.count / WORKERS, o1 = (worker + 1) * vis.count / WORKERS;
  const __nv_bfloat16* k0 = p.k + b * p.k_sb + hk * p.k_sh + lo * p.k_ss;
  const __nv_bfloat16* v0 = p.v + b * p.v_sb + hk * p.v_sh + lo * p.v_ss;
  auto issue = [&](int n) {
    if (o0 + n >= o1) return;
    const int r0 = vis.unit(o0 + n) * kUnit;
    issue_unit<D>(ring + (n % kDecodeStages) * STAGE, &full[n % kDecodeStages], k0, p.k_ss, v0,
                  p.v_ss, r0, min(kUnit, vis.limit - r0), lane);
  };
  for (int n = 0; n < kDecodeStages; ++n) issue(n);

  // SEG: lane r < 16 holds the id of row r of a unit, read a unit ahead.
  const int q_id = SEG ? p.q_seg[b] : 0;
  const int* kv_ids = SEG ? p.kv_seg + b * p.kv_seg_sb + lo : nullptr;
  auto unit_id = [&](int n) {
    if (!SEG || o0 + n >= o1 || lane >= kUnit) return -1;
    const int pos = vis.unit(o0 + n) * kUnit + lane;
    return pos < vis.limit ? kv_ids[pos] : -1;
  };
  int id_next = unit_id(0);

  float acc[D / 16][4];
#pragma unroll
  for (int mt = 0; mt < D / 16; ++mt) acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, ms[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int n = 0; o0 + n < o1; ++n) {
    const int r0 = vis.unit(o0 + n) * kUnit;
    const int id = id_next;
    if (SEG) id_next = unit_id(n + 1);
    const bool ok = lane < kUnit && vis.visible(r0 + lane) && (!SEG || id == q_id);
    const unsigned rows = __ballot_sync(0xffffffffu, ok);
    mbar_wait(&full[n % kDecodeStages], (n / kDecodeStages) & 1);
    // Without SEG every dealt unit has a visible row; with SEG a unit of
    // other segments only skips (uniform in the warp).
    if (rows != 0u) {
      const unsigned char* ku = ring + (n % kDecodeStages) * STAGE;
      float c[4];
      unit_scores<D>(c, ku, qb, rows, g8, c4);
      const UnitP u = unit_softmax(c, m, ms, l, g8, c4);
      unit_pv<D>(acc, ku + kUnit * D * 2, u, rows, g8, c4);
    }
    __syncwarp();  // every lane has read this stage
    issue(n + kDecodeStages);
  }

  store_worker<D>(parts + warp * part_floats<D>(), acc, m, l, g8, c4);
  cg::this_cluster().sync();  // every worker's partial is in its CTA's shared memory
  if (rank == 0)
    merge_workers<D, kDecodeWarps, kDecodeCluster>(parts, p.G, warp, lane, o_out, lse_out);
  cg::this_cluster().sync();  // rank 0 has read the other CTA's shared memory
}

// ------------------------------------------------------------ paged decode

constexpr int kPagedWarps = 4;    // workers of a CTA, each owning whole pages
constexpr int kPagedCluster = 2;  // CTAs of a split, merged through distributed shared memory
constexpr int kPagedWorkers = kPagedWarps * kPagedCluster;

// Rows of one bulk copy: a page of up to 64 rows (32 at head_dim 160 and
// 256, where 64 rows of K and V would be 40 or 64 KB) is one piece, a longer
// page several, so that a piece of K and V stays within 32 KB.
template <int D>
__host__ __device__ constexpr int paged_piece_rows() {
  return D > 128 ? 32 : 64;
}

// The pieces (bulk copies of at most `rows` rows) with a visible row of
// visible pages o .. o1 - 1, in logical order.
struct PieceWalk {
  const VisibleUnits* vis;
  int o, o1, piece, pieces, rows;
  __device__ __forceinline__ bool next(int& page, int& pc) {
    while (o < o1) {
      page = vis->unit(o);
      pc = piece;
      if (++piece == pieces) {
        piece = 0;
        ++o;
      }
      const int lo = page * vis->size + pc * rows;
      if (vis->any(lo, min(lo + rows, (page + 1) * vis->size))) return true;
    }
    return false;
  }
};

// The paged split: a cluster of kPagedCluster CTAs of kPagedWarps warps, the
// split's visible pages dealt to its kPagedWorkers warps in contiguous runs
// of ordinals (kernels/flash_decode.py paged_deal). Each warp streams its
// pages through its own ring of bulk copies and keeps its own (m, l, acc);
// the CTA of rank 0 merges the workers in order and writes the partial.
template <int D>
__global__ void __cluster_dims__(1, kPagedCluster, 1) __launch_bounds__(kPagedWarps * 32)
    fa2_decode_paged_kernel(const PagedParams p) {
  static_assert(D == 64 || D == 128 || D == 160 || D == 256,
                "the paged decode takes head_dim 64, 128, 160 or 256");
  constexpr int kPieceRows = paged_piece_rows<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int bhk = blockIdx.x, split = blockIdx.y / kPagedCluster;
  const int b = bhk / p.Hkv, hk = bhk % p.Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g8 = lane / 4, c4 = lane % 4;
  uint4 qb[D / 32];  // loaded first, so that its latency overlaps the length's
  load_q<D>(qb, p.q + static_cast<long long>(bhk) * p.G * D, p.G, g8, c4);
  const int L = max(min(p.lengths[b], p.n_pages * p.ps), 0);
  const int page0 = split * p.pp;
  const VisibleUnits vis(L, p.ps, page0, min(page0 + p.pp, p.n_pages),
                         p.window < 0 ? 0 : max(L - p.window, 0), p.window < 0 ? 0 : p.sink);
  const long long part = static_cast<long long>(bhk) * p.ns + split;
  float* o_out = p.o_parts + part * p.G * D;
  float* lse_out = p.lse_parts + part * p.G;
  if (vis.count == 0) {  // nothing visible (the same in every CTA of the cluster): (0, -inf)
    if (rank == 0) write_empty(o_out, lse_out, p.G, D);
    return;
  }

  // Shared memory: per warp `slots` stages of a K and a V piece (rows
  // rounded up to 16), then each worker's (acc, m, l), then the warps'
  // full barriers.
  const int piece_rows = min(p.ps, kPieceRows);
  const uint32_t half = static_cast<uint32_t>((piece_rows + 15) / 16 * 16) * D * 2;
  unsigned char* ring = smem_raw + static_cast<size_t>(warp) * p.slots * 2 * half;
  float* parts = reinterpret_cast<float*>(smem_raw + static_cast<size_t>(kPagedWarps) * p.slots * 2 * half);
  uint64_t* full = reinterpret_cast<uint64_t*>(parts + kPagedWarps * part_floats<D>()) + warp * p.slots;
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
  PieceWalk walk{&vis, o0, o1, 0, pieces, kPieceRows}, ahead = walk;
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

  float acc[D / 16][4];
#pragma unroll
  for (int mt = 0; mt < D / 16; ++mt) acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, ms[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  int page, pc;
  for (int n = 0; walk.next(page, pc); ++n) {
    mbar_wait(&full[n % p.slots], (n / p.slots) & 1);
    const unsigned char* sk = ring + static_cast<size_t>(n % p.slots) * 2 * half;
    const int base = page * p.ps + pc * kPieceRows;
    const int rows = min(kPieceRows, p.ps - pc * kPieceRows);
    for (int u = 0; u < rows; u += kUnit) {
      // Units of 16 rows; row r is visible if it is one of the piece's and
      // its position is. Rows that are not (past the length: stale pool
      // data) take the mask value in S and zeros in V.
      const bool ok = lane < kUnit && u + lane < rows && vis.visible(base + u + lane);
      const unsigned vrows = __ballot_sync(0xffffffffu, ok);
      if (vrows == 0u) continue;  // uniform in the warp
      float c[4];
      unit_scores<D>(c, sk + u * D * 2, qb, vrows, g8, c4);
      const UnitP up = unit_softmax(c, m, ms, l, g8, c4);
      unit_pv<D>(acc, sk + half + u * D * 2, up, vrows, g8, c4);
    }
    __syncwarp();  // every lane has read this stage
    if (lane == 0) issue(n + p.slots);
  }

  store_worker<D>(parts + warp * part_floats<D>(), acc, m, l, g8, c4);
  cg::this_cluster().sync();  // every worker's partial is in its CTA's shared memory
  if (rank == 0)
    merge_workers<D, kPagedWarps, kPagedCluster>(parts, p.G, warp, lane, o_out, lse_out);
  cg::this_cluster().sync();  // rank 0 has read the other CTA's shared memory
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

// The paged kernel at head_dim D: two stages a warp where the ring stays
// within 128 KB (pieces of up to 64 rows at 64, 32 at 128, 16 at 160 and
// 256), else one (pieces of 64 rows at 128, 32 at 160 and 256: 128 KB for
// the four warps at 128 and 256, 80 KB at 160). At 64 a piece of 64 rows
// is 8 KB of K and 8 of V, so every page size runs two stages (128 KB).
template <int D>
cudaError_t launch_paged(PagedParams& p, dim3 grid, cudaStream_t stream) {
  const size_t half =
      static_cast<size_t>((min(p.ps, paged_piece_rows<D>()) + 15) / 16 * 16) * D * 2;
  p.slots = 2 * kPagedWarps * 2 * half <= 128 * 1024 ? 2 : 1;
  const size_t smem = kPagedWarps * (p.slots * (2 * half + sizeof(uint64_t)) +
                                     part_floats<D>() * sizeof(float));
  return launch(fa2_decode_paged_kernel<D>, p, grid, kPagedWarps * 32, smem, stream);
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
  const dim3 grid(batch * Hkv, ns * kDecodeCluster);
  const int threads = kDecodeWarps * 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 128)
    return seg ? launch(fa2_decode_kernel<128, true>, p, grid, threads, decode_smem<128>(), s)
               : launch(fa2_decode_kernel<128, false>, p, grid, threads, decode_smem<128>(), s);
  if (head_dim == 64)
    return seg ? launch(fa2_decode_kernel<64, true>, p, grid, threads, decode_smem<64>(), s)
               : launch(fa2_decode_kernel<64, false>, p, grid, threads, decode_smem<64>(), s);
  if (head_dim == 256)
    return seg ? launch(fa2_decode_kernel<256, true>, p, grid, threads, decode_smem<256>(), s)
               : launch(fa2_decode_kernel<256, false>, p, grid, threads, decode_smem<256>(), s);
  if (head_dim == 160)
    return seg ? launch(fa2_decode_kernel<160, true>, p, grid, threads, decode_smem<160>(), s)
               : launch(fa2_decode_kernel<160, false>, p, grid, threads, decode_smem<160>(), s);
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
  if (G < 1 || G > kMaxGroup || ps < 1 || pp < 1) return cudaErrorInvalidValue;
  const dim3 grid(batch * Hkv, ns * kPagedCluster);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 128) return launch_paged<128>(p, grid, s);
  if (head_dim == 256) return launch_paged<256>(p, grid, s);
  if (head_dim == 160) return launch_paged<160>(p, grid, s);
  if (head_dim == 64) return launch_paged<64>(p, grid, s);
  return cudaErrorInvalidValue;
}
