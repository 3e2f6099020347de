// FlashAttention-2 backward for Hopper (sm_90a), bf16 in, f32 gradients.
//
// Two kernels:
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
// It uses neither wgmma nor TMA yet; those are the next step for speed.
//
// Semantics match the JAX kernel: masked scores take the finite
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
  float* dq;           // (B, Sq, Hq, D), zeroed by the caller; null: skip the
                       // atomics (a timing variant that isolates their cost)
  float* dk;           // (B, Skv, Hkv, D)
  float* dv;           // (B, Skv, Hkv, D)
  const int* table;    // row_ptr[t_kv + 1], then (q_tile << 1) | masked
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long d_sb, d_ss, d_sh;
  int Hq, Hkv, group, Sq, Skv, t_kv;
  int causal, window, sink, q_offset;  // window < 0: no window
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
template <int ROWS, int D, int STRIDE>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long stride, int row0, int nrows) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < ROWS * CHUNKS; idx += kThreads) {
    const int r = idx / CHUNKS, c = idx % CHUNKS;
    const int g = row0 + r;
    const bool valid = g < nrows;
    const __nv_bfloat16* from = valid ? src + g * stride + c * 8 : src;
    cp_async16(dst + r * STRIDE + c * 8, from, valid);
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

// ------------------------------------------------------------------ fused

template <int D>
__global__ void __launch_bounds__(kThreads, 1) fa2_bwd_fused_kernel(const BwdParams p) {
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
  float4* sP = reinterpret_cast<float4*>(sdS + BN * DS_STRIDE);    // [4][NT_Q][32], P^T

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const bool owns_dv = warp < 4;  // warps 0-3: S, P, dV; warps 4-7: dP, dS, dK
  const int wr = warp % 4;        // this warp's 16 kv rows within the tile
  const int g8 = lane / 4, t4 = lane % 4;
  const int j = blockIdx.y;       // low kv tiles (the longest causal runs) first
  const int b = blockIdx.x / p.Hkv, hk = blockIdx.x % p.Hkv;
  const int k0 = j * BN;
  const int beg = p.table[j], nvis = p.table[j + 1] - beg;
  const int* steps = p.table + p.t_kv + 1 + beg;
  const int n_steps = nvis * p.group;  // (q head of the group, visible q tile)
  const int kv_a = k0 + wr * 16 + g8;  // this thread's two kv rows
  const int kv_b = kv_a + 8;

  // dV (warps 0-3) or dK (warps 4-7): rows kv_a / kv_b, columns t * 8 + 2 * t4.
  float acc[NT_D][4];
#pragma unroll
  for (int t = 0; t < NT_D; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

  auto load_q_stage = [&](int it, int stage) {
    const int h = hk * p.group + it / nvis;
    const int q0 = (steps[it % nvis] >> 1) * BM;
    load_tile<BM, D, STRIDE>(sQ + stage * BM * STRIDE, p.q + b * p.q_sb + h * p.q_sh, p.q_ss,
                             q0, p.Sq);
    load_tile<BM, D, STRIDE>(sdO + stage * BM * STRIDE, p.dout + b * p.d_sb + h * p.d_sh,
                             p.d_ss, q0, p.Sq);
  };

  if (n_steps > 0) {
    load_tile<BN, D, STRIDE>(sK, p.k + b * p.k_sb + hk * p.k_sh, p.k_ss, k0, p.Skv);
    load_tile<BN, D, STRIDE>(sV, p.v + b * p.v_sb + hk * p.v_sh, p.v_ss, k0, p.Skv);
    load_q_stage(0, 0);
    cp_async_commit();

    for (int it = 0; it < n_steps; ++it) {
      const int stage = it & 1;
      if (it + 1 < n_steps) {
        load_q_stage(it + 1, stage ^ 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();

      const int h = hk * p.group + it / nvis;
      const int entry = steps[it % nvis];
      const int q0 = (entry >> 1) * BM;
      const bool masked = entry & 1;
      const long long bh = static_cast<long long>(b) * p.Hq + h;
      const __nv_bfloat16* cQ = sQ + stage * BM * STRIDE;
      const __nv_bfloat16* cdO = sdO + stage * BM * STRIDE;

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
              if (!visible(p, qc + p.q_offset, kv_a)) sa = kMaskValue;
              if (!visible(p, qc + p.q_offset, kv_b)) sb = kMaskValue;
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
          *reinterpret_cast<unsigned*>(sdS + (wr * 16 + g8) * DS_STRIDE + t * 8 + 2 * t4) =
              pack_bf16(s[t][0], s[t][1]);
          *reinterpret_cast<unsigned*>(sdS + (wr * 16 + g8 + 8) * DS_STRIDE + t * 8 + 2 * t4) =
              pack_bf16(s[t][2], s[t][3]);
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
      __syncthreads();  // dS^T is in shared memory

      // Phase 3: dQ_i += dS K_j (line 15), all warps: warp -> 16 q rows
      // (wr) x half of head_dim (warp / 4); A = dS from the dS^T tile
      // through ldmatrix.trans, B = K through ldmatrix.trans.
      {
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

template <int D>
size_t fused_smem_bytes() {
  return static_cast<size_t>(2 * kBlockN + 4 * kBlockM) * (D + 8) * sizeof(__nv_bfloat16) +
         static_cast<size_t>(kBlockN) * (kBlockM + 8) * sizeof(__nv_bfloat16) +
         static_cast<size_t>(4 * (kBlockM / 8) * 32) * sizeof(float4);
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

extern "C" int fa2_bwd_fused_bf16(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dq, void* dk,
                                  void* dv, const void* table, long long q_sb, long long q_ss,
                                  long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                                  long long v_sb, long long v_ss, long long v_sh, long long d_sb,
                                  long long d_ss, long long d_sh, int batch, int Hq, int Hkv,
                                  int Sq, int Skv, int head_dim, int block_q, int block_kv,
                                  int causal, int window, int sink, int q_offset, int t_kv,
                                  void* stream) {
  BwdParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.table = static_cast<const int*>(table);
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.d_sb = d_sb; p.d_ss = d_ss; p.d_sh = d_sh;
  p.Hq = Hq; p.Hkv = Hkv; p.group = Hq / Hkv; p.Sq = Sq; p.Skv = Skv; p.t_kv = t_kv;
  p.causal = causal; p.window = window; p.sink = sink; p.q_offset = q_offset;
  // The one instantiation the training path needs (qwen3: head_dim 128).
  if (head_dim != 128 || block_q != kBlockM || block_kv != kBlockN) return cudaErrorInvalidValue;
  const size_t smem = fused_smem_bytes<128>();
  cudaError_t err = cudaFuncSetAttribute(fa2_bwd_fused_kernel<128>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * Hkv, t_kv);
  fa2_bwd_fused_kernel<128><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}
