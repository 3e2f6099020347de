// Split-KV flash decode for Hopper (sm_90a): one new token per sequence.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py:77
// flash_decode_kernel (body _decode_kernel :34), without packed-cache
// segments. Grid (batch * kv heads, splits): each CTA runs the G q heads of
// one GQA group against one ceil-div, 8-aligned chunk of the cache and
// writes a locally normalized f32 partial (o, lse) in the JAX layout,
// o_parts (B*Hkv, ns, G, D) and lse_parts (B*Hkv, ns, G); the caller folds
// the splits with combine_lse_outputs.
//
// What bounds it on an H100: decode does 4 * G * D flops per cached
// position against 2 * D * 2 bytes of K/V, so it is bound by HBM (3.35
// TB/s) by two orders of magnitude. The design therefore tries to move only
// the bytes the data needs, once, with many of them in flight:
//   * K/V are read in place from the (B, S, Hkv, D) cache with its strides
//     (the JAX wrapper transposed the whole cache to head-major every step);
//   * one K/V row is read once for all G q heads of its group;
//   * positions at or past the sequence's length, and whole 64-row tiles
//     outside the sliding window, are never read, so a short sequence in a
//     long cache costs what its length costs;
//   * each 64-row K and V tile is copied to shared memory with cp.async,
//     every 16-byte chunk of it in flight at once, in a two-stage ring so
//     the next tile's copy overlaps this tile's math; scores and P V then
//     read shared memory only.
// Scores are f32 dot products of bf16 values; P is rounded to bf16 before
// P V, as the JAX kernel does. Splits with no visible position give
// (o = 0, lse = -inf).

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
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = valid ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy cache rows [row0, row0 + kTile) of one kv head into shared memory;
// rows at or past `end` are zero-filled and never read from global memory.
template <int D, int STRIDE>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long stride, int row0, int end) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < kTile * CHUNKS; idx += D) {
    const int r = idx / CHUNKS, c = idx % CHUNKS;
    const int g = row0 + r;
    const bool valid = g < end;
    cp_async16(dst + r * STRIDE + c * 8, valid ? src + g * stride + c * 8 : src, valid);
  }
}

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

// blockDim.x == D: one thread per output column in P V, and D / 64 threads
// per cache row (64 elements each) for the scores.
template <int D>
__global__ void __launch_bounds__(D) fa2_decode_kernel(const DecodeParams p) {
  constexpr int NWARPS = D / 32;
  constexpr int TPR = D / 64;     // threads per cache row in the scores
  constexpr int STRIDE = D + 8;   // padded row: 16-byte reads hit distinct banks

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2][kTile][STRIDE]
  __nv_bfloat16* sV = sK + 2 * kTile * STRIDE;                     // [2][kTile][STRIDE]
  __shared__ __align__(16) float sq[kMaxGroup][D];
  __shared__ float sp[kMaxGroup][kTile];
  __shared__ float s_alpha[kMaxGroup];
  __shared__ float s_m[kMaxGroup];
  __shared__ float s_l[kMaxGroup];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int bhk = blockIdx.x, split = blockIdx.y;
  const int b = bhk / p.Hkv, hk = bhk % p.Hkv;
  const int G = p.G;
  const int L = min(p.lengths[b], p.S);
  const int lo = split * p.chunk;
  const int end = min(min(lo + p.chunk, p.S), L);  // past it nothing is visible
  const int win_lo = p.window < 0 ? 0 : L - p.window;  // first in-window position
  const int ntiles = lo < end ? (end - lo + kTile - 1) / kTile : 0;
  const __nv_bfloat16* kg = p.k + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vg = p.v + b * p.v_sb + hk * p.v_sh;

  // A tile wholly before the window and past the sink holds nothing visible.
  auto next_tile = [&](int t) {
    for (; t < ntiles; ++t) {
      const int c0 = lo + t * kTile;
      if (!(min(c0 + kTile, end) <= win_lo && c0 >= p.sink)) break;
    }
    return t;
  };

  int t = next_tile(0);
  if (t < ntiles) {
    load_tile<D, STRIDE>(sK, kg, p.k_ss, lo + t * kTile, end);
    load_tile<D, STRIDE>(sV, vg, p.v_ss, lo + t * kTile, end);
    cp_async_commit();
  }
  for (int i = tid; i < G * D; i += D)
    sq[i / D][i % D] = __bfloat162float(p.q[static_cast<long long>(bhk) * G * D + i]);
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
      load_tile<D, STRIDE>(sK + (stage ^ 1) * kTile * STRIDE, kg, p.k_ss, lo + tn * kTile, end);
      load_tile<D, STRIDE>(sV + (stage ^ 1) * kTile * STRIDE, vg, p.v_ss, lo + tn * kTile, end);
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
    const bool vis = in_tile && (p.window < 0 || c >= win_lo || c < p.sink);
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

  const long long part_idx = static_cast<long long>(bhk) * p.ns + split;
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g >= G) break;
    const float l = any ? s_l[g] : 0.f;
    const float l_safe = l == 0.f ? 1.f : l;
    p.o_parts[(part_idx * G + g) * D + tid] = any ? acc[g] / l_safe : 0.f;
    if (tid == 0) p.lse_parts[part_idx * G + g] = l == 0.f ? -INFINITY : s_m[g] + logf(l_safe);
  }
}

template <int D>
cudaError_t launch(const DecodeParams& p, int bhk, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(4) * kTile * (D + 8) * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(fa2_decode_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(bhk, p.ns);
  fa2_decode_kernel<D><<<grid, D, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fa2_decode_bf16(const void* q, const void* k, const void* v, const void* lengths,
                               void* o_parts, void* lse_parts, long long k_sb, long long k_ss,
                               long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                               int batch, int Hkv, int G, int S, int head_dim, int chunk, int ns,
                               int window, int sink, void* stream) {
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
  if (G < 1 || G > kMaxGroup || head_dim != 128) return cudaErrorInvalidValue;
  return launch<128>(p, batch * Hkv, static_cast<cudaStream_t>(stream));
}
