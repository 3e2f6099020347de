// Split-KV flash decode for Hopper (sm_90a): one new token per sequence,
// against a contiguous cache or through a block table into a page pool.
//
// Two entries share one tile body (decode_split), templated on how a cache
// row's address is found:
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
//     arithmetic is the unsegmented kernel's, bit for bit.
//   * fa2_decode_paged_bf16 replaces src/repro/kernels/flash_decode.py:250
//     flash_decode_paged_kernel (body _paged_decode_kernel :161). K/V live
//     in the pool's page planes (Hkv, P, ps, D); logical row g of sequence
//     b sits in physical page tbl[b, g / ps] at offset g % ps. Split c
//     covers the pp logical pages [c * pp, c * pp + pp), the JAX geometry
//     (ns = ceil(n_pages / pp)). The CTA reads its split's pp table entries
//     once into shared memory.
// Grid (batch * kv heads, splits): each CTA runs the G q heads of one GQA
// group against one split and writes a locally normalized f32 partial
// (o, lse) in the JAX layout, o_parts (B*Hkv, ns, G, D) and lse_parts
// (B*Hkv, ns, G); the caller folds the splits with combine_lse_outputs.
//
// What bounds it on an H100: decode does 4 * G * D flops per cached
// position against 2 * D * 2 bytes of K/V, so it is bound by HBM (3.35
// TB/s) by two orders of magnitude. The design therefore tries to move only
// the bytes the data needs, once, with many of them in flight:
//   * K/V are read in place (the JAX wrapper transposed the whole contiguous
//     cache to head-major every step);
//   * one K/V row is read once for all G q heads of its group;
//   * positions at or past the sequence's length, and whole 64-row tiles
//     outside the sliding window, are never read, so a short sequence in a
//     long cache costs what its length costs; the paged entry reads no row
//     that is not visible at all, so a page with no visible column, and a
//     slot of length 0, cost no K/V traffic;
//   * each 64-row K and V tile is copied to shared memory with cp.async,
//     every 16-byte chunk of it in flight at once (with pages, each chunk's
//     source comes from its row's page), in a two-stage ring so the next
//     tile's copy overlaps this tile's math; scores and P V then read
//     shared memory only.
// Head dims: the contiguous kernel is instantiated at 128 (qwen3) and 64
// (whisper; one thread per output column, so 64 threads and one thread per
// cache row in the scores), the paged one at 128.
//
// Scores are f32 dot products of bf16 values; P is rounded to bf16 before
// P V, as the JAX kernels do. Splits with no visible position give
// (o = 0, lse = -inf). The arithmetic depends on logical positions only, so
// the physical order of pages does not change a paged result by one bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMaskValue = -0.7f * 3.402823466e38f;  // DEFAULT_MASK_VALUE
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

// Logical row g of one kv head through the split's table entries (logical
// pages page0 .. page0 + pp - 1, in shared memory).
template <int D>
struct PagedRows {
  const __nv_bfloat16* plane;  // (P, ps, D) of this kv head
  const int* tbl;
  int page0, ps;
  __device__ __forceinline__ const __nv_bfloat16* operator()(int g) const {
    const long long page = tbl[g / ps - page0];
    return plane + (page * ps + g % ps) * D;
  }
  __device__ __forceinline__ const __nv_bfloat16* any() const { return plane; }
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

template <int D>
__global__ void __launch_bounds__(D) fa2_decode_paged_kernel(const PagedParams p) {
  constexpr int STRIDE = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2][kTile][STRIDE]
  __nv_bfloat16* sV = sK + 2 * kTile * STRIDE;                     // [2][kTile][STRIDE]
  int* s_tbl = reinterpret_cast<int*>(sV + 2 * kTile * STRIDE);    // [pp]

  const int bhk = blockIdx.x, split = blockIdx.y;
  const int b = bhk / p.Hkv, hk = bhk % p.Hkv;
  const int S = p.n_pages * p.ps;  // logical capacity: no column past it exists
  const int L = min(p.lengths[b], S);
  const int page0 = split * p.pp;
  const int lo = page0 * p.ps;
  const int end = min(min(lo + p.pp * p.ps, S), L);  // past it nothing is visible
  const int n_tbl = min(p.pp, p.n_pages - page0);
  for (int i = threadIdx.x; i < n_tbl; i += D) {
    const int page = p.table[static_cast<long long>(b) * p.n_pages + page0 + i];
    // An id outside the pool reads the null page rather than past the planes.
    s_tbl[i] = (page >= 0 && page < p.P) ? page : 0;
  }
  __syncthreads();

  const long long plane = static_cast<long long>(hk) * p.P * p.ps * D;
  const PagedRows<D> krows{p.k + plane, s_tbl, page0, p.ps};
  const PagedRows<D> vrows{p.v + plane, s_tbl, page0, p.ps};
  const int win_lo = p.window < 0 ? 0 : L - p.window;
  const int window = p.window, sink = p.sink;
  // Only visible rows are fetched: below the length, and inside the window
  // or the sink.
  const auto load = [=](int g) { return g < end && (window < 0 || g >= win_lo || g < sink); };
  const long long part_idx = static_cast<long long>(bhk) * p.ns + split;
  decode_split<D, false>(p.q + static_cast<long long>(bhk) * p.G * D, krows, vrows, load,
                         Segments<false>{nullptr, 0}, p.G, L, lo, end, p.window, p.sink,
                         p.o_parts + part_idx * p.G * D, p.lse_parts + part_idx * p.G, sK, sV);
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
  const size_t smem = ring_bytes<128>() + static_cast<size_t>(pp) * sizeof(int);
  return launch(fa2_decode_paged_kernel<128>, p, dim3(batch * Hkv, ns), 128, smem,
                static_cast<cudaStream_t>(stream));
}
