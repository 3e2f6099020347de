#!/usr/bin/env python3
"""A/B the split dQ kernel, the KV-stationary kernels, the two decode kernels and delta against variants of themselves.

Each variant is ``csrc/flash_bwd.cu`` (the dQ kernel, the fused and dK/dV
kernels, delta) or
``csrc/flash_decode.cu`` (the contiguous and the paged decode) with one
design decision changed, stated as text edits of that source (``VARIANTS``
below). The script writes each variant beside a copy of ``sm90.cuh`` under
``build/ab_kernels/<name>/``, builds every one with the nvcc line of
``kernels/_build.py`` (all at once), prints what ptxas says of it (spills,
serialised wgmmas), holds it against the plain version, and times it in
turns with the committed kernel (each variant in order, then in reverse)
after an L2 flush: the dQ variants at the training shape (B 2, S 2048,
causal, 32 q heads, 8 kv heads); the fused and dK/dV variants there at
head_dim 128 and 160 (with, for the committed source, the fused kernel
without its dQ staging and bulk reduction); the decode variants at the serving path's
decode shape (B 4, lengths 15/108/708/1508 of 2048, 8 splits; the paged
ones through pages of 16) and the contiguous ones also at whisper's cross
and self shapes; delta at the training shape and at whisper's encoder
shape, each variant on the (B, S, H, D) tensors and on a strided view of a
head-major copy of them, after the usual flush (zeroing 96 MB, which
leaves L2 full of dirty lines) and after one that only reads 96 MB; the
"wide" group, the fused and dK/dV kernels at head_dim 256 and 160 against
an earlier design of them (wide_parent: that commit's flash_bwd.cu and
sm90.cuh, which the caller copies under ``build/ab_kernels/parent/``;
``PARENT`` says how) at gemma3-1b's and stablelm-12b's training shapes,
beside the committed kernel without its head split and without dQ's bulk
reductions; the "hd64" group, the fused and dK/dV kernels at head_dim 64
at whisper-base's encoder, cross-attention and decoder shapes and gpt-20m's
training shape (``HD64_SHAPES``), the committed kernel and each design
element of it undone alone (``hd64_*``), the parent design (hd64_parent,
from ``PARENT`` as wide_parent), each design's fused kernel without dQ's
staging and bulk reduction, and SDPA's backward, all in the same turns;
the "wide_dq" group, the dQ kernel at head_dim 256 and 160 in every mode
(compact, SEG on the packed source's ids, DENSE, DENSE+SEG) at gemma3-1b's
training shape (causal and window 512) and stablelm-12b's, the committed
kernel, each design element undone alone (``wide_dq_*``) and the parent
design (wide_dq_parent, from ``PARENT``), each against the plain version
and bitwise against the committed kernel's dQ, then at the causal shapes
the split backward (delta, dK/dV, dQ) through the committed and the parent
library beside SDPA's backward, and rows 6, 8, 7 and 7w (head_dim 128 and
64) through both libraries, all in turns.

Run from the repository root on a machine with an H100 and nvcc:

    python3 tools/ab_kernels.py [variant ...]     # default: all

It prints the card (``nvidia-smi`` name and power limit), a line per
measurement and, last, a JSON object of the times.
"""

from __future__ import annotations

import ctypes
import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "ab_kernels"

_S_SS = "\n        wgmma_ss_n64<0, 0>(s, kmajor_desc<D>(sQ, kk), kmajor_desc<D>(cK, kk), kk > 0);"
_DP_SS = "\n        wgmma_ss_n64<0, 0>(dp, kmajor_desc<D>(sdO, kk), kmajor_desc<D>(cV, kk), kk > 0);"
_DQ_LOOP = """    for (int n = 0;; ++n) {
      const int stage = n % kDqStages;"""


def _fragments(name: str, tile: str) -> str:
    """Register A fragments of a warpgroup's 64 x D bf16 tile, read once
    from its swizzled shared-memory copy with ldmatrix (the forward's Q)."""
    return f"""    uint32_t {name}[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {{
      const int row = wq * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      const int col = kk * 16 + (lane >> 4) * 8;
      const uint32_t at = {tile} + tile_off<D>(row, col);
      asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {{%0,%1,%2,%3}}, [%4];\\n"
                   : "=r"({name}[kk][0]), "=r"({name}[kk][1]), "=r"({name}[kk][2]), "=r"({name}[kk][3])
                   : "r"(at));
    }}
"""


_S_RS = "\n        wgmma_rs_n64<0>(s, qf[kk], kmajor_desc<D>(cK, kk), kk > 0);"
_DP_RS = "\n        wgmma_rs_n64<0>(dp, dof[kk], kmajor_desc<D>(cV, kk), kk > 0);"
_SLOTS = "  p.slots = 2 * kPagedWarps * 2 * half <= 128 * 1024 ? 2 : 1;"
_COPY_WAIT = "    mbar_wait(&full[n % p.slots], (n / p.slots) & 1);\n"
_COPY_FIRST = "  if (lane == 0)\n    for (int n = 0; n < p.slots; ++n) issue(n);\n"
_COPY_NEXT = "    if (lane == 0) issue(n + p.slots);\n"
_UNIT_SKIP = "      if (vrows == 0u) continue;  // uniform in the warp\n"
_KV_WG = ("  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);"
          "  // warp-uniform (wg_ss_k64)\n")

_ISSUE_BULK = """  if (lane == 0)
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\\n" ::"r"(smem_u32(bar)),
                 "r"(2 * rows * D * 2)
                 : "memory");
  __syncwarp();
  const int r = lane % kUnit;
  if (r < rows) {
    const bool is_v = lane >= kUnit;
    const __nv_bfloat16* src = is_v ? v0 + (r0 + r) * v_ss : k0 + (r0 + r) * k_ss;
    bulk_load(stage + (is_v ? kUnit * D * 2 : 0) + r * D * 2, src, D * 2, bar);
  }
"""
_ISSUE_CP_ASYNC = """  constexpr int CHUNKS = D / 8;  // 16-byte chunks of a row
  for (int i = lane; i < 2 * kUnit * CHUNKS; i += 32) {
    const int is_v = i / (kUnit * CHUNKS), r = i / CHUNKS % kUnit, c = i % CHUNKS;
    if (r < rows) {
      const __nv_bfloat16* src = (is_v ? v0 + (r0 + r) * v_ss : k0 + (r0 + r) * k_ss) + c * 8;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(
                       smem_u32(stage + is_v * kUnit * D * 2 + r * D * 2 + c * 16)),
                   "l"(src)
                   : "memory");
    }
  }
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\\n" ::"r"(smem_u32(bar))
               : "memory");
"""
_DECODE_MATH = "    if (rows != 0u) {\n"
_DECODE_WAIT = "    mbar_wait(&full[n % kDecodeStages], (n / kDecodeStages) & 1);\n"
_DECODE_FIRST = "  for (int n = 0; n < kDecodeStages; ++n) issue(n);\n"
_DECODE_NEXT = "    issue(n + kDecodeStages);\n"


def _delta_body() -> str:
    """The committed delta kernel's body, between its signature and the
    next section (read from the source, so the edit below follows it)."""
    text = (CSRC / "flash_bwd.cu").read_text()
    head = "fa2_bwd_delta_kernel(const DeltaParams p) {\n"
    tail = "\n// ------------------------------------------------------- fused and dkv"
    if text.count(head) != 1 or text.count(tail) != 1:
        return "<delta body not found>"
    start = text.index(head) + len(head)
    return text[start:text.index(tail)]


# The earlier delta: a CTA per 64 positions of one head (grid (Sq / 64,
# B Hq)), one 16-byte load of O and of dO per row and pass.
_DELTA_PER_HEAD = """  constexpr int TPR = D / 8;                 // threads per row, 8 values each
  constexpr int ROWS_PER_PASS = kDeltaThreads / TPR;
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
"""
_DELTA_GRID = """  const dim3 grid((Sq + R - 1) / R, batch);
  const size_t smem = static_cast<size_t>(R) * Hq * sizeof(float);"""

# Copies that mark their lines evict-first in L2 (the stream then replaces
# its own lines, not the rest of the cache).
_POLICY = ('  uint64_t pol;\n  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\\n"'
           ' : "=l"(pol));\n')
_BULK_COPY = "    bulk_load(stage + (is_v ? kUnit * D * 2 : 0) + r * D * 2, src, D * 2, bar);\n"
_BULK_COPY_EF = _POLICY.replace("  ", "    ", 1).replace("\n  asm", "\n    asm") + (
    '    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes'
    '.L2::cache_hint [%0], [%1], %2, [%3], %4;\\n" ::"r"(smem_u32(stage + (is_v ? kUnit * D * 2 '
    ': 0) + r * D * 2)), "l"(src), "r"(D * 2), "r"(smem_u32(bar)), "l"(pol) : "memory");\n')
_CP_ASYNC = [(_ISSUE_BULK, _ISSUE_CP_ASYNC),
             ("constexpr int kUnitArrivals = 1;", "constexpr int kUnitArrivals = 32;")]
_UNROLL = "constexpr int kDeltaUnroll = 4;"
_DELTA_LOADS = """        ov[u] = load_evict_first(og + s * p.o_ss + h * p.o_sh, policy);
        dv[u] = load_evict_first(dg + s * p.d_ss + h * p.d_sh, policy);
"""
_DELTA_LOADS_NORMAL = """        ov[u] = *reinterpret_cast<const uint4*>(og + s * p.o_ss + h * p.o_sh);
        dv[u] = *reinterpret_cast<const uint4*>(dg + s * p.d_ss + h * p.d_sh);
"""

# The head_dim-64 dQ: by one warpgroup a step in turn over the pair's 128 kv
# rows, or by each over its own tile.
_DQ_TURNS = """            const int who = __shfl_sync(0xffffffffu, n_dq & 1, 0);
            if (who != w) {
              named_arrive(1 + who, kConsumers);
            } else {
              named_sync(1 + w, kConsumers);  // both tiles' dS are in the buffer
              float dq[32];
              wgmma_fence();
#pragma unroll
              for (int kk = 0; kk < 8; ++kk)
                wgmma_ss_n64<1, 1>(dq, sw128_desc(cdS + kk * 2048, 8192),
                                   sw128_desc(sK + kk * 2048, 8192), kk > 0);
"""
_DQ_EACH_TILE = """            {
              named_sync(1, kConsumers);  // both tiles' dS are in the buffer
              float dq[32];
              wgmma_fence();
#pragma unroll
              for (int kk = 0; kk < 4; ++kk)
                wgmma_ss_n64<1, 1>(dq, sw128_desc(cdS + w * 8192 + kk * 2048, 8192),
                                   sw128_desc(sK + w * 8192 + kk * 2048, 8192), kk > 0);
"""

# The grid orders of the dQ kernel: the 64/128 pair kernel with batch *
# head on x, and the 160/256 kernel with its tiles on x (the parent's order).
_DQ_HEAD_MAJOR = ("__host__ __device__ constexpr bool dq_head_major(int D) "
                  "{ return D == 160 || D == 256; }")
_DQ_HEAD_GRID = [(_DQ_HEAD_MAJOR, _DQ_HEAD_MAJOR.replace("D == 160 || D == 256", "D > 0"))]
_DQ_TILE_GRID = [(_DQ_HEAD_MAJOR, _DQ_HEAD_MAJOR.replace("D == 160 || D == 256", "D == 0"))]
_DQ_KST = "  static constexpr int KST = 3;  // K stages\n"
_DQ_VST = "  static constexpr int VST = 1;  // V stages\n"
_DQ_REGS = [("  static constexpr int PRODUCER_REGS = 40;\n", "  static constexpr int PRODUCER_REGS = 24;\n"),
            ("  static constexpr int CONSUMER_REGS = 232;\n", "  static constexpr int CONSUMER_REGS = 240;\n")]
# At 256 V freed with K, after the dQ += dS K that reads K (the parent's
# hold), with K 2 stages and V 2 (the parent's ring).
_DQ_V_LATE = [
    (_DQ_KST, "  static constexpr int KST = 2;\n"),
    (_DQ_VST, "  static constexpr int VST = 2;\n"),
    ("      mbar_arrive(&v_empty[vs]);  // dP has read V_j\n", ""),
    ("mbar_arrive(&k_empty[pend]);",
     "{ mbar_arrive(&k_empty[pend]); mbar_arrive(&v_empty[pend]); }", 3)]
# At 256 the parent's step on this design's rings: both warpgroups compute
# the whole of S and dP (m64n64 over head_dim) and add dS K from registers
# into their columns of dQ, with no dS slots and no barrier; the committed
# step is compiled out.
_DQ_STEP = "    // S and dP once a step: each warpgroup computes them for its 32 of the\n"
_DQ_WRITE = "    // dQ of the tile, written once (zeros where the tile took no step), each\n"
_DQ_TWICE = """    {  // wide_dq_twice: each warpgroup S and dP over all 64 kv columns
      uint32_t pc[4][4];  // dS of the pending step: bf16 A fragments of dQ += dS K
      int pend = -1;      // the K stage whose dQ += dS K is not issued yet
      const uint32_t sKc = sK + w * 16384;  // dS K's B: the warpgroup's columns
      for (int n = 0;; ++n) {
        const int ks = n % L::KST, vs = n % L::VST;
        mbar_wait(&k_full[ks], (n / L::KST) & 1);
        int2 rec = sStep[ks];
        rec.x = __shfl_sync(0xffffffffu, rec.x, 0);
        rec.y = __shfl_sync(0xffffffffu, rec.y, 0);
        if (rec.x < 0) break;
        mbar_wait(&v_full[vs], (n / L::VST) & 1);
        if (!(rec.y & take)) {
          if (pend >= 0) {
            wgmma_fence();
            wgmma_rs_k64<DC>(dq, pc, sKc + pend * L::TILE);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(dq);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) fence_regs(pc[kk]);
            mbar_arrive(&k_empty[pend]);
            pend = -1;
          }
          mbar_arrive(&k_empty[ks]);
          mbar_arrive(&v_empty[vs]);
          continue;
        }
        const int j = rec.x;
        const uint32_t cK = sK + ks * L::TILE, cV = sV + vs * L::TILE;
        const bool first = pend < 0;
        if (first)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int e = 0; e < 4; ++e) pc[kk][e] = 0u;
        float s[32], dp[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n64<0, 0>(s, kmajor_desc<D>(sQ, kk), kmajor_desc<D>(cK, kk), kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n64<0, 0>(dp, kmajor_desc<D>(sdO, kk), kmajor_desc<D>(cV, kk), kk > 0);
        wgmma_commit();
        wgmma_rs_k64<DC>(dq, pc, sKc + (first ? ks : pend) * L::TILE);
        wgmma_commit();
        wgmma_wait<2>();
        fence_regs(s);
        const bool masked = rec.y & needs_mask;
        const int* cKid = sKid + ks * BN;
#pragma unroll
        for (int tt = 0; tt < 8; ++tt) {
          const int cc = tt * 8 + 2 * t4;
          int2 kid = make_int2(0, 0);
          if (SEG && masked) kid = *reinterpret_cast<const int2*>(cKid + cc);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float x = s[4 * tt + i];
            if (masked) {
              bool vis = visible(p, (i < 2 ? row_a : row_b) + p.q_offset, j * BN + cc + (i & 1));
              if (SEG) vis = vis && qid[i >> 1] == ((i & 1) ? kid.y : kid.x);
              if (!vis) x = kHidden;
            }
            s[4 * tt + i] = exp2f(fmaf(x, kLog2e, -lse_r[i >> 1]));
          }
        }
        wgmma_wait<1>();
        fence_regs(dp);
        mbar_arrive(&v_empty[vs]);
        uint32_t pn[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 8 * kk + 2 * e;
            const float d = delta_r[e & 1];
            pn[kk][e] = pack_bf16(s[i] * (dp[i] - d), s[i + 1] * (dp[i + 1] - d));
          }
        }
        wgmma_wait<0>();
        fence_regs(dq);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) fence_regs(pc[kk]);
        if (!first) mbar_arrive(&k_empty[pend]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) pc[kk][e] = pn[kk][e];
        pend = ks;
      }
      if (pend >= 0) {
        wgmma_fence();
        wgmma_rs_k64<DC>(dq, pc, sKc + pend * L::TILE);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) fence_regs(pc[kk]);
        mbar_arrive(&k_empty[pend]);
      }
    }
#if 0
"""
_DQ_TWICE_EDITS = [(_DQ_STEP, _DQ_TWICE + _DQ_STEP), (_DQ_WRITE, "#endif\n" + _DQ_WRITE),
                   *_DQ_REGS]
# At 160 K and V on their own rings in the pair kernel, K 4 stages and V 2
# (the same 200 KB as 3 of each): the producer loads V_j after the step's
# record, on V's barriers; a consumer frees V_j once dP has completed.
_DQ_SPLIT160 = [
    ("  static constexpr int STAGES = D == 160 ? 3 : 4;\n",
     "  static constexpr int STAGES = 4;\n  static constexpr int VST = D == 160 ? 2 : STAGES;\n"),
    ("  static constexpr uint32_t KID = V + STAGES * TILE;\n",
     "  static constexpr uint32_t KID = V + VST * TILE;\n"),
    ("  static constexpr uint32_t BYTES = BARS + (2 * STAGES + 1) * 8;\n",
     "  static constexpr uint32_t BYTES = BARS + (2 * STAGES + 2 * VST + 1) * 8;\n"),
    ("  uint64_t* q_bar = empty + kDqStages;\n",
     "  uint64_t* v_full = empty + kDqStages;\n  uint64_t* v_empty = v_full + L::VST;\n"
     "  uint64_t* q_bar = v_empty + L::VST;\n  constexpr bool VSPLIT = D == 160;\n"),
    ("      mbar_init(&empty[s], kConsumers);\n    }\n    mbar_init(q_bar, 32);\n",
     "      mbar_init(&empty[s], kConsumers);\n    }\n    for (int s = 0; s < L::VST; ++s) {\n"
     "      mbar_init(&v_full[s], 1);\n      mbar_init(&v_empty[s], kConsumers);\n    }\n"
     "    mbar_init(q_bar, 32);\n"),
    ("          mbar_expect_tx(&full[stage], 2 * L::TILE);\n",
     "          mbar_expect_tx(&full[stage], (VSPLIT ? 1 : 2) * L::TILE);\n"),
    ("          load_tile<D>(sm + L::V + stage * L::TILE, maps.v, maps.v_tail, &full[stage], hk, k0, b);\n",
     "          if (!VSPLIT)\n"
     "          load_tile<D>(sm + L::V + stage * L::TILE, maps.v, maps.v_tail, &full[stage], hk, k0, b);\n"),
    ("        if (lane == 0) sStep[stage] = make_int2(j, flags);\n        mbar_arrive(&full[stage]);\n      }\n",
     "        if (lane == 0) sStep[stage] = make_int2(j, flags);\n        mbar_arrive(&full[stage]);\n"
     "        if constexpr (VSPLIT) {\n          const int vs = n % L::VST;\n"
     "          mbar_wait(&v_empty[vs], ((n / L::VST) & 1) ^ 1);\n          if (lane == 0) {\n"
     "            mbar_expect_tx(&v_full[vs], L::TILE);\n"
     "            load_tile<D>(sm + L::V + vs * L::TILE, maps.v, maps.v_tail, &v_full[vs], hk, k0, b);\n"
     "            mbar_arrive(&v_full[vs]);\n          }\n        }\n      }\n"),
    ("      if (rec.x < 0) break;\n      if (!(rec.y & take)) {\n",
     "      if (rec.x < 0) break;\n      const int vs = n % L::VST;\n"
     "      if constexpr (VSPLIT) mbar_wait(&v_full[vs], (n / L::VST) & 1);\n"
     "      if (!(rec.y & take)) {\n"),
    ("          pend = -1;\n        }\n        mbar_arrive(&empty[stage]);\n        continue;\n",
     "          pend = -1;\n        }\n        mbar_arrive(&empty[stage]);\n"
     "        if constexpr (VSPLIT) mbar_arrive(&v_empty[vs]);\n        continue;\n"),
    ("const uint32_t cK = sK + stage * L::TILE, cV = sV + stage * L::TILE;",
     "const uint32_t cK = sK + stage * L::TILE, cV = sV + (VSPLIT ? vs : stage) * L::TILE;"),
    ("      wgmma_wait<1>();\n      fence_regs(dp);\n      // dS = P o (dP - delta) (line 14), rounded to bf16 as dS K's A operand.\n",
     "      wgmma_wait<1>();\n      fence_regs(dp);\n      if constexpr (VSPLIT) mbar_arrive(&v_empty[vs]);\n"
     "      // dS = P o (dP - delta) (line 14), rounded to bf16 as dS K's A operand.\n")]
# name -> (source, what it changes, [(old text, new text[, occurrences]), ...]).
VARIANTS = {
    "dq_final": ("flash_bwd", "the dQ kernel as committed", []),
    "dq_q_regs": ("flash_bwd", "S = Q K^T takes Q from registers (wgmma RS), as the forward", [
        (_DQ_LOOP, _fragments("qf", "sQ") + _DQ_LOOP), (_S_SS, _S_RS)]),
    "dq_q_do_regs": ("flash_bwd", "Q and dO from registers (both products wgmma RS)", [
        (_DQ_LOOP, _fragments("qf", "sQ") + _fragments("dof", "sdO") + _DQ_LOOP),
        (_S_SS, _S_RS), (_DP_SS, _DP_RS)]),
    "dq_stages2": ("flash_bwd", "a 2-stage K/V ring instead of 4",
                   [("static constexpr int STAGES = D == 160 ? 3 : 4;",
                     "static constexpr int STAGES = 2;")]),
    "dq_head_grid": ("flash_bwd", "the 64/128 dQ kernel with batch * head on the grid's x (the "
                     "160/256 order)", _DQ_HEAD_GRID),
    "kv_final": ("flash_bwd", "the fused and dK/dV kernels as committed", []),
    "kv_wg_thread": ("flash_bwd", "the KV-stationary warpgroup index read from threadIdx.x, "
                     "not broadcast from lane 0", [(_KV_WG, "  const int wg = threadIdx.x / 128;\n")]),
    "paged_final": ("flash_decode", "the paged decode as committed", []),
    "paged_cluster1": ("flash_decode", "one CTA of 4 warps a split, no cluster",
                       [("constexpr int kPagedCluster = 2;", "constexpr int kPagedCluster = 1;")]),
    "paged_warps8": ("flash_decode", "8 warps a CTA (16 workers a split)",
                     [("constexpr int kPagedWarps = 4;", "constexpr int kPagedWarps = 8;")]),
    "paged_slots1": ("flash_decode", "one ring stage a warp at every page size",
                     [(_SLOTS, "  p.slots = 1;")]),
    "paged_copies_only": ("flash_decode", "diagnostic: the copies and their waits, no math",
                          [(_UNIT_SKIP, "      continue;\n")]),
    "paged_math_only": ("flash_decode", "diagnostic: the math on whatever the stages hold, no "
                        "copies and no waits",
                        [(_COPY_WAIT, ""), (_COPY_FIRST, ""), (_COPY_NEXT, "")]),
    "decode_final": ("flash_decode", "the contiguous decode as committed", []),
    "decode_cp_async": (
        "flash_decode", "16-byte cp.async copies (every lane 16 chunks a unit at D 128), each "
        "lane's arrival counted on the stage's barrier, instead of one bulk copy a row",
        _CP_ASYNC),
    "decode_evict_first": ("flash_decode", "the bulk copies mark their lines evict-first in L2",
                           [(_BULK_COPY, _BULK_COPY_EF)]),
    "decode_cluster1": ("flash_decode", "one CTA of 4 warps a split, no cluster",
                        [("constexpr int kDecodeCluster = 2;", "constexpr int kDecodeCluster = 1;")]),
    "decode_warps8": ("flash_decode", "8 warps a CTA (16 workers a split)",
                      [("constexpr int kDecodeWarps = 4;", "constexpr int kDecodeWarps = 8;")]),
    "decode_stages1": ("flash_decode", "one ring stage a warp",
                       [("constexpr int kDecodeStages = 2;", "constexpr int kDecodeStages = 1;")]),
    "decode_stages4": ("flash_decode", "four ring stages a warp",
                       [("constexpr int kDecodeStages = 2;", "constexpr int kDecodeStages = 4;")]),
    "decode_copies_only": ("flash_decode", "diagnostic: the copies and their waits, no math",
                           [(_DECODE_MATH, "    if (rows != 0u && p.G < 0) {\n")]),
    "decode_math_only": ("flash_decode", "diagnostic: the math on whatever the stages hold, no "
                         "copies and no waits",
                         [(_DECODE_WAIT, ""), (_DECODE_FIRST, ""), (_DECODE_NEXT, "")]),
    "delta_final": ("flash_bwd", "delta as committed", []),
    "delta_per_head": ("flash_bwd", "the earlier delta: a CTA per 64 positions of one head",
                       [(_delta_body(), _DELTA_PER_HEAD),
                        (_DELTA_GRID, "  const dim3 grid((Sq + kBlockM - 1) / kBlockM, batch * Hq);\n"
                                      "  const size_t smem = 0;")]),
    "delta_per_head_evict_first": (
        "flash_bwd", "the earlier walk (a CTA per 64 positions of one head) with evict-first "
        "loads", [(_delta_body(), _DELTA_PER_HEAD.replace(
            "*reinterpret_cast<const uint4*>(og + row * p.o_ss)",
            "load_evict_first(og + row * p.o_ss, evict_first_policy())").replace(
            "*reinterpret_cast<const uint4*>(dg + row * p.d_ss)",
            "load_evict_first(dg + row * p.d_ss, evict_first_policy())")),
            (_DELTA_GRID, "  const dim3 grid((Sq + kBlockM - 1) / kBlockM, batch * Hq);\n"
                          "  const size_t smem = 0;")]),
    "delta_unroll8": ("flash_bwd", "8 loads of O and of dO in flight a thread (100 registers)",
                      [(_UNROLL, "constexpr int kDeltaUnroll = 8;")]),
    "delta_unroll2": ("flash_bwd", "2 loads of O and of dO in flight a thread",
                      [(_UNROLL, "constexpr int kDeltaUnroll = 2;")]),
    "delta_evict_normal": ("flash_bwd", "plain loads (L2's normal eviction)",
                           [(_DELTA_LOADS, _DELTA_LOADS_NORMAL)]),
    "delta_r8": ("flash_bwd", "8 positions a CTA at every shape",
                 [("  while (R * Hq < 256 && batch * ((Sq + 2 * R - 1) / (2 * R)) >= 132) R *= 2;\n",
                   "")]),
    "wide_final": ("flash_bwd", "the fused and dK/dV kernels at 256 and 160 as committed", []),
    "wide_parent": ("flash_bwd", "the fused and dK/dV kernels of the parent design (PARENT's "
                    "sources: both warpgroups compute S^T and dP^T, one dQ staging a "
                    "warpgroup, no head split)", []),
    "wide_dq_final": ("flash_bwd", "the dQ kernel at 256 and 160 as committed", []),
    "wide_dq_parent": ("flash_bwd", "the dQ kernel of the parent design (PARENT's sources: at "
                       "256 both warpgroups compute S and dP, one barrier pair a K/V stage, the "
                       "tiles on the grid's x)", []),
    "wide_dq_twice": ("flash_bwd", "at 256 both warpgroups compute the whole of S and dP and "
                      "add dS K from registers (the parent's step)",
                      _DQ_TWICE_EDITS),
    "wide_dq_v_late": ("flash_bwd", "256: V freed with K, after the dQ that reads K (one "
                       "release of both a stage, as the parent), 2 stages of each", _DQ_V_LATE),
    "wide_dq_regs24": ("flash_bwd", "256: setmaxnreg 24 for the producer, 240 for the "
                       "consumers, as at 160", _DQ_REGS),
    "wide_dq_tile_grid": ("flash_bwd", "the q tiles (256) or pairs (160) on the grid's x, "
                          "batch * head on y (the parent's order)", _DQ_TILE_GRID),
    "wide_dq_split160": ("flash_bwd", "160: K and V on their own rings, K 4 stages, V 2",
                         _DQ_SPLIT160),
    "wide_dq_k2v2": ("flash_bwd", "256: K 2 stages, V 2",
                     [(_DQ_KST, "  static constexpr int KST = 2;\n"),
                      (_DQ_VST, "  static constexpr int VST = 2;\n")]),
    "hd64_final": ("flash_bwd", "the head_dim-64 fused and dK/dV kernels as committed", []),
    "hd64_parent": ("flash_bwd", "the head_dim-64 fused and dK/dV kernels of the parent design "
                    "(PARENT's sources)", []),
    "hd64_rows_in_producer": ("flash_bwd", "the producer warp stages lse and delta, as at 128 "
                              "(warp 3 idle)", [("static constexpr bool ROWS_WARP = D == 64 && DQ;",
                                                 "static constexpr bool ROWS_WARP = false;")]),
    "hd64_dq_each_tile": ("flash_bwd", "each warpgroup computes dQ over its own kv tile every "
                          "step, both wait at the barrier (the parent's dQ: twice the "
                          "reductions)", [(_DQ_TURNS, _DQ_EACH_TILE)]),
}

# The parent commit's flash_bwd.cu and sm90.cuh, for the wide_parent and
# hd64_parent variants:
# write them here first, e.g.
#   mkdir -p build/ab_kernels/parent
#   git show <commit>:src/repro_torch/kernels/csrc/flash_bwd.cu > build/ab_kernels/parent/flash_bwd.cu
#   git show <commit>:src/repro_torch/kernels/csrc/sm90.cuh > build/ab_kernels/parent/sm90.cuh
PARENT = OUT / "parent"


class _ParentLib:
    """The parent design's library behind the committed wrappers. Its
    KV-stationary entries take no head split: the calls drop the wrappers'
    (always 1 for this library, see ``use``), the other entries pass
    through."""

    def __init__(self, lib):
        from repro_torch.kernels import _build

        P, I, L = _build.VOIDP, _build.INT, _build.I64
        seg = [P, P, L, L, P, I]
        lib.fa2_bwd_fused_bf16.argtypes = [P] * 10 + [L] * 12 + [I] * 14 + seg + [P]
        lib.fa2_bwd_dkv_bf16.argtypes = [P] * 9 + [L] * 12 + [I] * 14 + seg + [P]
        lib.fa2_bwd_delta_bf16.argtypes = [P] * 3 + [L] * 6 + [I] * 4 + [P]
        lib.fa2_bwd_dq_bf16.argtypes = [P] * 8 + [L] * 12 + [I] * 14 + seg + [P]
        self.lib = lib

    def __getattr__(self, name):
        return getattr(self.lib, name)

    def fa2_bwd_fused_bf16(self, *args):  # the head split is argument 36
        assert args[36] == 1
        return self.lib.fa2_bwd_fused_bf16(*args[:36], *args[37:])

    def fa2_bwd_dkv_bf16(self, *args):  # argument 35 (no dq)
        assert args[35] == 1
        return self.lib.fa2_bwd_dkv_bf16(*args[:35], *args[36:])

DIAGNOSTICS = {"paged_copies_only", "paged_math_only", "decode_copies_only", "decode_math_only"}

# Variant groups: name prefix -> (kernel whose ptxas lines are printed,
# the wrapper module's name).
GROUPS = {"dq": ("fa2_bwd_dq_kernel", "flash_bwd"),
          "kv": ("fa2_bwd_fused_kernel", "flash_bwd"),
          "paged": ("fa2_decode_paged_kernel", "flash_decode"),
          "decode": ("fa2_decode_kernel", "flash_decode"),
          "delta": ("fa2_bwd_delta_kernel", "flash_bwd"),
          "wide": ("fa2_bwd_fused_kernel", "flash_bwd"),
          "hd64": ("fa2_bwd_fused_kernel", "flash_bwd"),
          "wide_dq": ("fa2_bwd_dq_kernel", "flash_bwd")}

# The head_dim-64 backward's shapes (B, Sq, Skv, heads, causal), as
# chip_smoke.py HD64_SHAPES: whisper-base's encoder, cross-attention and
# decoder, and the gpt-20m preset's training step.
HD64_SHAPES = {
    "encoder": (8, 1500, 1500, 8, False),
    "cross": (8, 448, 1500, 8, False),
    "decoder": (8, 448, 448, 8, True),
    "gpt20m": (8, 512, 512, 4, True),
}


def group(name: str) -> str:
    """The variant's group: the longest GROUPS key it starts with."""
    return max((g for g in GROUPS if name.startswith(g + "_")), key=len)


def nvidia_smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]


def build(names):
    """Write and build every variant; returns {name: configured ctypes library}."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_bwd as bwd
    from repro_torch.kernels import flash_decode as dec

    nvcc = _build._nvcc()
    procs = {}
    for name in names:
        src, _, edits = VARIANTS[name]
        srcdir = PARENT if name.endswith("_parent") else CSRC
        if not (srcdir / f"{src}.cu").exists():
            raise SystemExit(f"variant {name}: no {srcdir / src}.cu (see PARENT)")
        text = (srcdir / f"{src}.cu").read_text()
        for old, new, *count in edits:
            if text.count(old) != (count[0] if count else 1) or new == old:
                raise SystemExit(f"variant {name}: an edit no longer matches {src}.cu, or "
                                 f"changes nothing")
            text = text.replace(old, new)
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / f"{src}.cu").write_text(text)
        shutil.copy(srcdir / "sm90.cuh", d / "sm90.cuh")
        procs[name] = subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
                                        str(d / f"{src}.cu")], stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        kernel = GROUPS[group(name)][0]
        regs = []
        kernels = (kernel, "fa2_bwd_dkv_kernel") if group(name) == "hd64" else (kernel,)
        for block in log.split("Compiling entry function")[1:]:
            head = block.splitlines()[0]
            for k in kernels:
                m = re.search(k + r"I(.*?)EEv", head)
                if m:
                    args = ",".join(re.findall(r"L[ib](\d+)", m.group(1)))
                    regs.append(f"{k.split('_')[2]}<{args}> " + "/".join(
                        re.findall(r"Used (\d+) registers", block)[:1]
                        + re.findall(r"(\d+) bytes spill stores", block)[:1]
                        + re.findall(r"(\d+) bytes spill loads", block)[:1]))
        notes = sorted(set(re.findall(r"\((C75\d+)\) Potential Performance Loss", log)))
        print(f"{name}: {VARIANTS[name][1]}; registers/spill-store/spill-load bytes per "
              f"instantiation {regs}; ptxas performance notes {notes or 'none'}", flush=True)
        module = bwd if GROUPS[group(name)][1] == "flash_bwd" else dec
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        if name.endswith("_parent") and "int hsplit" not in text:
            libs[name] = _ParentLib(lib)  # a design before the head split
            continue
        load = _build.load
        _build.load = lambda _name, lib=lib: lib
        try:
            libs[name] = module._lib.__wrapped__()  # the module's argument types on this library
        finally:
            _build.load = load
    return libs


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script times kernels on an NVIDIA GPU")
    from repro_torch.core.masks import MaskSpec
    from repro_torch.kernels import flash_bwd as bwd
    from repro_torch.kernels import flash_decode as dec
    from repro_torch.kernels import flash_fwd as fwd
    from repro_torch.kernels import ops

    names = sys.argv[1:] or list(VARIANTS)
    for final in (f"{g}_final" for g in GROUPS):
        if final not in names and any(group(n) == group(final) for n in names):
            names.insert(0, final)
    print(nvidia_smi(), flush=True)
    libs = build(names)
    (dq_names, kv_names, paged_names, decode_names, delta_names, wide_names, hd64_names,
     wide_dq_names) = ([n for n in names if group(n) == g] for g in GROUPS)
    originals = {bwd: bwd._lib, dec: dec._lib}
    head_split = bwd.kv_head_split

    def use(name):
        module = bwd if GROUPS[group(name)][1] == "flash_bwd" else dec
        module._lib = lambda: libs[name]
        # A parent design before the head split has none.
        bwd.kv_head_split = ((lambda *a, **kw: 1) if isinstance(libs[name], _ParentLib)
                             else head_split)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()

    scratch = torch.empty(96 * 2**20, dtype=torch.uint8, device=dev)
    # Two flushes of the 50 MB L2: zeroing 96 MB (chip_smoke.py's; it leaves
    # the L2 full of dirty lines that the timed kernel's misses write back)
    # and reading 96 MB (it leaves clean lines).
    flushes = {"write": scratch.zero_, "read": lambda: scratch.view(torch.int32).amax()}

    def time_ms(fn, iters=30, flush="write", spin=1_000_000):
        fn()
        fn()
        torch.cuda.synchronize()
        events = []
        for _ in range(iters):
            flushes[flush]()
            torch.cuda._sleep(spin)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in events) / iters

    def in_turns(calls, flush="write", spin=1_000_000):
        runs = {n: [] for n in calls}
        for name in list(calls) + list(calls)[::-1]:
            if name.split(" ")[0] in libs:
                use(name.split(" ")[0])
            runs[name].append(time_ms(calls[name], flush=flush, spin=spin))
        return {n: sum(r) / 2 for n, r in runs.items()}

    def check(name, what, got, want, tol):
        """Print and count a variant's max |error| against the plain version
        (a diagnostic's may be anything)."""
        (o, lse), (o_p, lse_p) = got, want
        fin = torch.isfinite(lse_p)
        eo = (o - o_p).abs().max().item()
        el = (lse[fin] - lse_p[fin]).abs().max().item() if fin.any() else 0.0
        ok = eo <= tol[0] and el <= tol[1] and torch.equal(torch.isfinite(lse), fin)
        print(f"{name}: {what}, max|o-plain| {eo:.3e} (tol {tol[0]}), max|lse-plain| {el:.3e} "
              f"(tol {tol[1]}){'' if ok else ' (a diagnostic)' if name in DIAGNOSTICS else ' FAILS'}",
              flush=True)
        return not ok and name not in DIAGNOSTICS

    bad, result = 0, {}
    tiles = dict(block_q=64, block_kv=64)
    causal = MaskSpec(causal=True)
    if dq_names:
        def dq_inputs(B, S):
            q = ops._prep(randn(B, S, 32, 128), 1 / math.sqrt(128))
            k, v, do = randn(B, S, 8, 128), randn(B, S, 8, 128), randn(B, S, 32, 128)
            o, lse = fwd.flash_fwd(q, k, v, causal, **tiles)
            return q, k, v, do, lse, bwd.flash_bwd_delta(o, do), causal

        args = dq_inputs(1, 700)
        want = bwd.flash_bwd_dq_plain(*args, **tiles)
        for name in dq_names:
            use(name)
            got = bwd.flash_bwd_dq(*args, **tiles)
            torch.cuda.synchronize()
            rel = (got - want).abs().max().item() / want.abs().max().item()
            bad += not rel <= 3e-3
            print(f"{name}: B=1 S=700 causal dq, max|dq-plain| / max|dq| {rel:.3e} (tol 3e-3)"
                  f"{'' if rel <= 3e-3 else ' FAILS'}", flush=True)
        args = dq_inputs(2, 2048)
        ms = in_turns({n: (lambda: bwd.flash_bwd_dq(*args, **tiles)) for n in dq_names})
        result["dq, training shape"] = ms
        print("flash_bwd_dq B=2 S=2048 causal, in turns: " + "; ".join(
            f"{n} {ms[n]:.4f} ms ({ms[n] / ms['dq_final']:.4f}x final)" for n in dq_names),
            flush=True)
    if kv_names:
        def kv_inputs(B, S, D):
            q = ops._prep(randn(B, S, 32, D), 1 / math.sqrt(D))
            k, v, do = randn(B, S, 8, D), randn(B, S, 8, D), randn(B, S, 32, D)
            o, lse = fwd.flash_fwd(q, k, v, causal, **tiles)
            return q, k, v, do, lse, bwd.flash_bwd_delta(o, do), causal

        for D in (128, 160):
            args = kv_inputs(1, 700, D)
            want = bwd.flash_bwd_fused_plain(*args, **tiles)
            for name in kv_names:
                use(name)
                got = bwd.flash_bwd_fused(*args, **tiles)
                dk, dv = bwd.flash_bwd_dkv(*args, **tiles)
                torch.cuda.synchronize()
                rel = max((a - b).abs().max().item() / b.abs().max().item()
                          for a, b in zip(got, want))
                ok = rel <= 3e-3 and torch.equal(dk, got[1]) and torch.equal(dv, got[2])
                bad += not ok
                print(f"{name}: B=1 S=700 causal D={D} fused dq, dk, dv, max|x-plain| / max|x| "
                      f"{rel:.3e} (tol 3e-3); dK/dV bitwise the fused kernel's"
                      f"{'' if ok else ' FAILS'}", flush=True)
            args = kv_inputs(2, 2048, D)
            calls = {}
            for name in kv_names:
                calls[f"{name} fused"] = lambda: bwd.flash_bwd_fused(*args, **tiles)
                calls[f"{name} dkv"] = lambda: bwd.flash_bwd_dkv(*args, **tiles)
            calls["kv_final fused without dQ's bulk reduction"] = (
                lambda: bwd._launch_fused(*args, tiles["block_q"], tiles["block_kv"], None))
            ms = in_turns(calls)
            result[f"fused and dkv, training shape, D {D}"] = ms
            print(f"flash_bwd_fused and flash_bwd_dkv B=2 S=2048 causal D={D}, in turns: "
                  + "; ".join(f"{n} {v:.4f} ms" for n, v in ms.items()), flush=True)
    if paged_names:
        lens = torch.tensor([15, 108, 708, 1508], dtype=torch.int32, device=dev)
        B, S, ps = 4, 2048, 16
        q = ops._prep(randn(B, 1, 32, 128), 1 / math.sqrt(128)).reshape(B * 8, 4, 128)
        kc, vc = randn(B, S, 8, 128), randn(B, S, 8, 128)
        perm = torch.randperm(B * (S // ps), generator=torch.Generator().manual_seed(2)) + 1
        table = perm.reshape(B, S // ps).to(device=dev, dtype=torch.int32)
        kp, vp = (torch.zeros((8, B * (S // ps) + 1, ps, 128), dtype=torch.bfloat16, device=dev)
                  for _ in range(2))
        kp[:, table.long()] = kc.reshape(B, S // ps, ps, 8, 128).permute(3, 0, 1, 2, 4)
        vp[:, table.long()] = vc.reshape(B, S // ps, ps, 8, 128).permute(3, 0, 1, 2, 4)
        o_p, lse_p = dec.flash_decode_paged_plain(q, kp, vp, lens, table, num_splits=8)
        for name in paged_names:
            use(name)
            o, lse = dec.flash_decode_paged(q, kp, vp, lens, table, num_splits=8)
            torch.cuda.synchronize()
            fin = torch.isfinite(lse_p)
            eo = (o - o_p).abs().max().item()
            el = (lse[fin] - lse_p[fin]).abs().max().item()
            ok = eo <= 2e-2 and el <= 1e-3 and torch.equal(torch.isfinite(lse), fin)
            bad += not ok and name not in DIAGNOSTICS
            print(f"{name}: timing shape, max|o-plain| {eo:.3e} (tol 2e-2), max|lse-plain| "
                  f"{el:.3e} (tol 1e-3)"
                  f"{'' if ok else ' (a diagnostic)' if name in DIAGNOSTICS else ' FAILS'}",
                  flush=True)
        calls = {n: (lambda: dec.flash_decode_paged(q, kp, vp, lens, table, num_splits=8))
                 for n in paged_names}
        calls["contiguous"] = lambda: dec.flash_decode(q, kc, vc, lens, num_splits=8)
        ms = in_turns(calls)
        result["paged decode, timing shape"] = ms
        print("flash_decode_paged B=4 lengths 15/108/708/1508, pages of 16, in turns: " + "; ".join(
            f"{n} {ms[n]:.4f} ms ({ms[n] / ms['paged_final']:.4f}x final)" for n in calls),
            flush=True)
        # The floor of the same launches: every length 0, so every CTA reads
        # its length and writes (0, -inf).
        zeros = torch.zeros_like(lens)
        use("paged_final")
        floor = in_turns({
            "paged_final": lambda: dec.flash_decode_paged(q, kp, vp, zeros, table, num_splits=8),
            "contiguous": lambda: dec.flash_decode(q, kc, vc, zeros, num_splits=8)})
        result["every length 0"] = floor
        print("every length 0, in turns: " + "; ".join(f"{n} {v:.4f} ms" for n, v in floor.items()),
              flush=True)
    if decode_names:
        B = 4
        shapes = {  # (S, lengths, Hkv, G, D)
            "serving": (2048, [15, 108, 708, 1508], 8, 4, 128),
            "whisper cross": (1500, [1500] * 4, 8, 1, 64),
            "whisper self": (448, [5, 12, 21, 36], 8, 1, 64),
        }
        for shape, (S, lengths, Hkv, G, D) in shapes.items():
            lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
            q = ops._prep(randn(B * Hkv, G, D), 1 / math.sqrt(D))
            kc, vc = randn(B, S, Hkv, D), randn(B, S, Hkv, D)
            want = dec.flash_decode_plain(q, kc, vc, lens, num_splits=8)
            for name in decode_names:
                use(name)
                got = dec.flash_decode(q, kc, vc, lens, num_splits=8)
                torch.cuda.synchronize()
                bad += check(name, shape, got, want, (2e-2, 1e-3))

            def call(lengths):
                return lambda: dec.flash_decode(q, kc, vc, lengths, num_splits=8)

            ms = in_turns({n: call(lens) for n in decode_names})
            result[f"decode, {shape}"] = ms
            print(f"flash_decode {shape} B={B} S={S} lengths {lengths}, in turns: " + "; ".join(
                f"{n} {ms[n]:.4f} ms ({ms[n] / ms['decode_final']:.4f}x final)"
                for n in decode_names), flush=True)
            if shape == "serving":
                floor = in_turns({n: call(torch.zeros_like(lens)) for n in decode_names})
                result["decode, every length 0"] = floor
                print("flash_decode every length 0, in turns: " + "; ".join(
                    f"{n} {v:.4f} ms" for n, v in floor.items()), flush=True)
    if delta_names:
        for shape, (B, S, H, D) in {"training": (2, 2048, 32, 128),
                                     "whisper encoder": (8, 1500, 8, 64),
                                     "whisper cross": (8, 448, 8, 64),
                                     "gpt-20m": (8, 512, 4, 64)}.items():
            o, do = randn(B, S, H, D), randn(B, S, H, D)
            # The same values through a head-major copy: (B, S, H, D) views
            # whose heads sit S * D * 2 bytes apart.
            oh, doh = (x.transpose(1, 2).contiguous().transpose(1, 2) for x in (o, do))
            want = bwd.flash_bwd_delta_plain(o, do)
            for name in delta_names:
                use(name)
                for layout, args in (("", (o, do)), ("head-major", (oh, doh))):
                    got = bwd.flash_bwd_delta(*args)
                    torch.cuda.synchronize()
                    err = (got - want).abs().max().item()
                    bad += not err <= 2e-5
                    print(f"{name} {layout} {shape}: max|delta-plain| {err:.3e} (tol 2e-5)"
                          f"{'' if err <= 2e-5 else ' FAILS'}", flush=True)
            bound = (2 * B * S * H * D * 2 + B * H * S * 4) / 3.35e12 * 1e3
            calls = {}
            for name in delta_names:
                calls[name] = lambda: bwd.flash_bwd_delta(o, do)
                calls[f"{name} head-major"] = lambda: bwd.flash_bwd_delta(oh, doh)
            for flush in ("write", "read"):
                ms = in_turns(calls, flush)
                result[f"delta, {shape}, {flush} flush"] = ms
                print(f"flash_bwd_delta {shape} B={B} S={S} H={H} D={D}, bound {bound:.4f} ms "
                      f"(bytes), after the {flush} flush, in turns: " + "; ".join(
                          f"{n} {ms[n]:.4f} ms ({ms[n] / bound:.2f}x the bound, "
                          f"{ms[n] / ms['delta_final']:.4f}x final)" for n in calls), flush=True)
    if wide_names:
        # The fused and dK/dV kernels at gemma3-1b's and stablelm-12b's
        # training shapes (causal; gemma3 also under its 512 window), each
        # variant in turns with the others; beside the committed kernel, the
        # same without its head split (hsplit 1: the plain grid) and without
        # dQ's staging and bulk reduction.
        shapes = {"gemma3-1b causal": (4, 2048, 4, 1, 256, MaskSpec(causal=True)),
                  "gemma3-1b window 512": (4, 2048, 4, 1, 256, MaskSpec(causal=True, window=512)),
                  "stablelm-12b causal": (2, 2048, 32, 8, 160, causal)}
        for shape, (B, S, hq, hkv, D, spec) in shapes.items():
            q = ops._prep(randn(B, S, hq, D), 1 / math.sqrt(D))
            k, v, do = randn(B, S, hkv, D), randn(B, S, hkv, D), randn(B, S, hq, D)
            o, lse = fwd.flash_fwd(q, k, v, spec, **tiles)
            args = (q, k, v, do, lse, bwd.flash_bwd_delta(o, do), spec)
            want = bwd.flash_bwd_fused_plain(*args, **tiles)
            split = bwd.kv_head_split(spec, B, S, S, hq, hkv, D, 64, 64)
            for name in wide_names:
                use(name)
                got = bwd.flash_bwd_fused(*args, **tiles)
                dk, dv = bwd.flash_bwd_dkv(*args, **tiles)
                torch.cuda.synchronize()
                rel = max((a - b).abs().max().item() / b.abs().max().item()
                          for a, b in zip(got, want))
                ok = rel <= 1e-2 and torch.equal(dk, got[1]) and torch.equal(dv, got[2])
                bad += not ok
                print(f"{name}: {shape} B={B} S={S} Hq={hq} Hkv={hkv} D={D} fused dq, dk, dv, "
                      f"max|x-plain| / max|x| {rel:.3e} (tol 1e-2); dK/dV bitwise the fused "
                      f"kernel's{'' if ok else ' FAILS'}", flush=True)
            calls = {}
            for name in wide_names:
                calls[f"{name} fused"] = lambda: bwd.flash_bwd_fused(*args, **tiles)
                calls[f"{name} dkv"] = lambda: bwd.flash_bwd_dkv(*args, **tiles)

            def fused_as(hsplit, with_dq=True):
                dq = torch.zeros(q.shape, dtype=torch.float32, device=dev) if with_dq else None
                bwd._launch_fused(*args, 64, 64, dq, hsplit=hsplit)

            if "wide_final" in wide_names:
                if split > 1:
                    calls["wide_final fused without the head split"] = lambda: fused_as(1)
                calls["wide_final fused without dQ's bulk reduction"] = (
                    lambda: fused_as(None, with_dq=False))
            ms = in_turns(calls)
            result[f"wide, {shape}"] = dict(ms, head_split=split)
            print(f"flash_bwd_fused and flash_bwd_dkv {shape} B={B} S={S} Hq={hq} Hkv={hkv} "
                  f"D={D} (head split {split}), in turns: " + "; ".join(
                      f"{n} {v:.4f} ms" for n, v in ms.items()), flush=True)
    if hd64_names:
        # The fused and dK/dV kernels at head_dim 64 at whisper-base's and
        # gpt-20m's shapes, each variant in turns with the others, beside
        # each variant built from a design's sources (final, parent) without
        # dQ's staging and bulk reduction, and SDPA's backward (its forward
        # and backward less its forward, both in the same turns).
        for shape, (B, Sq, Skv, H, causal_) in HD64_SHAPES.items():
            spec = MaskSpec(causal=causal_)
            q = ops._prep(randn(B, Sq, H, 64), 1 / 8)
            k, v, do = randn(B, Skv, H, 64), randn(B, Skv, H, 64), randn(B, Sq, H, 64)
            o, lse = fwd.flash_fwd(q, k, v, spec, **tiles)
            args = (q, k, v, do, lse, bwd.flash_bwd_delta(o, do), spec)
            want = bwd.flash_bwd_fused_plain(*args, **tiles)
            what = f"{shape} B={B} Sq={Sq} Skv={Skv} H={H} D=64 {'causal' if causal_ else 'FULL'}"
            for name in hd64_names:
                use(name)
                got = bwd.flash_bwd_fused(*args, **tiles)
                dk, dv = bwd.flash_bwd_dkv(*args, **tiles)
                torch.cuda.synchronize()
                rel = max((a - b).abs().max().item() / b.abs().max().item()
                          for a, b in zip(got, want))
                ok = rel <= 3e-3 and torch.equal(dk, got[1]) and torch.equal(dv, got[2])
                bad += not ok and name not in DIAGNOSTICS
                print(f"{name}: {what} fused dq, dk, dv, max|x-plain| / max|x| {rel:.3e} "
                      f"(tol 3e-3); dK/dV bitwise the fused kernel's"
                      f"{'' if ok else ' (a diagnostic)' if name in DIAGNOSTICS else ' FAILS'}",
                      flush=True)
            calls = {}
            for name in hd64_names:
                calls[f"{name} fused"] = lambda: bwd.flash_bwd_fused(*args, **tiles)
                calls[f"{name} dkv"] = lambda: bwd.flash_bwd_dkv(*args, **tiles)
                if name in ("hd64_final", "hd64_parent"):
                    calls[f"{name} fused without dQ's bulk reduction"] = (
                        lambda: bwd._launch_fused(*args, 64, 64, None))
            qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
            dot = do.transpose(1, 2).contiguous()

            def sdpa(backward):
                with torch.set_grad_enabled(backward):
                    out = torch.nn.functional.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal_, scale=1.0)
                    if backward:
                        torch.autograd.grad(out, (qt, kt, vt), dot)

            calls["sdpa fwd+bwd"] = lambda: sdpa(True)
            calls["sdpa fwd"] = lambda: sdpa(False)
            # A spin of about 2 ms before each timed call: the host enqueues
            # SDPA's backward (autograd) before the start event runs.
            ms = in_turns(calls, spin=4_000_000)
            ms["sdpa bwd (fwd+bwd less fwd)"] = ms["sdpa fwd+bwd"] - ms["sdpa fwd"]
            result[f"hd64, {shape}"] = ms
            print(f"flash_bwd_fused and flash_bwd_dkv at {what}, in turns: " + "; ".join(
                f"{n} {v:.4f} ms" for n, v in ms.items()), flush=True)
        # Rows 6 and 8 (head_dim 128, qwen3's training shape): the committed
        # kernels against the parent design's, which the head_dim-64 design
        # must leave as they were.
        both = [n for n in ("hd64_final", "hd64_parent") if n in hd64_names]
        if len(both) == 2:
            q = ops._prep(randn(2, 2048, 32, 128), 1 / math.sqrt(128))
            k, v, do = randn(2, 2048, 8, 128), randn(2, 2048, 8, 128), randn(2, 2048, 32, 128)
            o, lse = fwd.flash_fwd(q, k, v, causal, **tiles)
            args = (q, k, v, do, lse, bwd.flash_bwd_delta(o, do), causal)
            calls = {}
            for name in both:
                calls[f"{name} fused"] = lambda: bwd.flash_bwd_fused(*args, **tiles)
                calls[f"{name} dkv"] = lambda: bwd.flash_bwd_dkv(*args, **tiles)
            ms = in_turns(calls)
            result["hd64, head_dim 128 training shape"] = ms
            print("flash_bwd_fused and flash_bwd_dkv at head_dim 128, B=2 S=2048 causal, in "
                  "turns: " + "; ".join(f"{n} {v:.4f} ms" for n, v in ms.items())
                  + f"; final / parent: fused {ms['hd64_final fused'] / ms['hd64_parent fused']:.4f}"
                  f", dkv {ms['hd64_final dkv'] / ms['hd64_parent dkv']:.4f}", flush=True)
    if wide_dq_names:
        # The dQ kernel at head_dim 256 and 160 in every mode (rows 7g-7gds,
        # 7l-7lds) at gemma3-1b's and stablelm-12b's training shapes, causal
        # and (gemma3) under its 512 window, each variant in turns with the
        # others; SEG on the packed source's step-0 ids (chip_smoke.py
        # packed_ids). At the causal shapes also the split backward (delta,
        # dK/dV, dQ) through the committed and the parent library, and SDPA's
        # backward (its forward and backward less its forward), in the same
        # turns.
        sys.path.insert(0, str(ROOT))
        from chip_smoke import packed_ids, sdpa_calls

        shapes = {  # (B, S, Hq, Hkv, D, spec, vocab)
            "gemma3-1b causal": (4, 2048, 4, 1, 256, causal, 262_144),
            "gemma3-1b window 512": (4, 2048, 4, 1, 256, MaskSpec(causal=True, window=512),
                                     262_144),
            "stablelm-12b causal": (2, 2048, 32, 8, 160, causal, 100_352)}
        both = [n for n in ("wide_dq_final", "wide_dq_parent") if n in wide_dq_names]
        for shape, (B, S, hq, hkv, D, spec, vocab) in shapes.items():
            q = ops._prep(randn(B, S, hq, D), 1 / math.sqrt(D))
            k, v, do = randn(B, S, hkv, D), randn(B, S, hkv, D), randn(B, S, hq, D)
            ids = torch.from_numpy(packed_ids(B, S, vocab=vocab)).to(dev)
            use("wide_dq_final")
            o, lse = fwd.flash_fwd(q, k, v, spec, **tiles)
            o_s, lse_s = fwd.flash_fwd_varlen(q, k, v, spec, ids, ids, **tiles)
            args = (q, k, v, do, lse, bwd.flash_bwd_delta(o, do), spec)
            args_s = (q, k, v, do, lse_s, bwd.flash_bwd_delta(o_s, do), spec, ids, ids)
            modes = {
                "compact": (lambda: bwd.flash_bwd_dq(*args, **tiles),
                            lambda: bwd.flash_bwd_dq_plain(*args, **tiles)),
                "SEG": (lambda: bwd.flash_bwd_dq_varlen(*args_s, **tiles),
                        lambda: bwd.flash_bwd_dq_plain(*args_s[:7], **tiles, q_seg=ids,
                                                       kv_seg=ids)),
                "DENSE": (lambda: bwd.flash_bwd_dq(*args, **tiles, schedule="dense"), None),
                "DENSE+SEG": (lambda: bwd.flash_bwd_dq_varlen(*args_s, **tiles,
                                                              schedule="dense"), None)}
            wants = {}  # the dense forms hold to their compact twin's plain version
            for mode, (call, plain) in modes.items():
                want = wants[mode] = (plain() if plain is not None
                                      else wants[mode.replace("DENSE", "compact").replace(
                                          "compact+", "")])
                outs = {}
                for name in wide_dq_names:
                    use(name)
                    outs[name] = call()
                    torch.cuda.synchronize()
                    rel = (outs[name] - want).abs().max().item() / want.abs().max().item()
                    same = torch.equal(outs[name], outs["wide_dq_final"])
                    diff = (outs[name] - outs["wide_dq_final"]).abs().max().item()
                    bad += not rel <= 3e-3
                    print(f"{name}: {shape} {mode} dq, max|dq-plain| / max|dq| {rel:.3e} (tol "
                          f"3e-3); bitwise the committed kernel's: {same} (max|diff| "
                          f"{diff:.3e}){'' if rel <= 3e-3 else ' FAILS'}", flush=True)
                ms = in_turns({n: call for n in wide_dq_names})
                result[f"wide_dq, {shape}, {mode}"] = ms
                print(f"flash_bwd_dq {mode} {shape} B={B} S={S} Hq={hq} Hkv={hkv} D={D}, in "
                      "turns: " + "; ".join(f"{n} {ms[n]:.4f} ms ({ms[n] / ms['wide_dq_final']:.4f}"
                                           "x final)" for n in wide_dq_names), flush=True)
            if spec.window is not None:
                continue
            d_args = args[:5]

            def split_backward():
                delta = bwd.flash_bwd_delta(o, do)
                bwd.flash_bwd_dkv(*d_args, delta, spec, **tiles)
                bwd.flash_bwd_dq(*d_args, delta, spec, **tiles)

            calls = {f"{n} split backward": split_backward for n in both}
            calls.update({f"{n} dq": modes["compact"][0] for n in both})
            sdpa_fwd, sdpa_fwd_bwd = sdpa_calls(torch, q, k, v, do)
            calls["sdpa fwd+bwd"], calls["sdpa fwd"] = sdpa_fwd_bwd, sdpa_fwd
            # A spin of about 2 ms before each timed call: the host enqueues
            # SDPA's backward (autograd) before the start event runs.
            ms = in_turns(calls, spin=4_000_000)
            ms["sdpa bwd (fwd+bwd less fwd)"] = ms["sdpa fwd+bwd"] - ms["sdpa fwd"]
            result[f"wide_dq, {shape}, split backward"] = ms
            print(f"the split backward at {shape}, in turns: " + "; ".join(
                f"{n} {v:.4f} ms" for n, v in ms.items()) + "; " + "; ".join(
                f"{n} split / sdpa bwd {ms[f'{n} split backward'] / ms['sdpa bwd (fwd+bwd less fwd)']:.4f}"
                for n in both), flush=True)
        # Rows 6, 8 and 7 (head_dim 128, qwen3's training shape) and 7w (64,
        # whisper's encoder): the committed library against the parent's,
        # whose bodies there this design leaves as they were.
        if len(both) == 2:
            for shape, (B, S, H, Hk, D, causal_) in {
                    "head_dim 128 training": (2, 2048, 32, 8, 128, True),
                    "head_dim 64 whisper encoder": (8, 1500, 8, 8, 64, False)}.items():
                spec = MaskSpec(causal=causal_)
                q = ops._prep(randn(B, S, H, D), 1 / math.sqrt(D))
                k, v, do = randn(B, S, Hk, D), randn(B, S, Hk, D), randn(B, S, H, D)
                o, lse = fwd.flash_fwd(q, k, v, spec, **tiles)
                args = (q, k, v, do, lse, bwd.flash_bwd_delta(o, do), spec)
                calls = {}
                for name in both:
                    calls[f"{name} fused"] = lambda: bwd.flash_bwd_fused(*args, **tiles)
                    calls[f"{name} dkv"] = lambda: bwd.flash_bwd_dkv(*args, **tiles)
                    calls[f"{name} dq"] = lambda: bwd.flash_bwd_dq(*args, **tiles)
                ms = in_turns(calls)
                result[f"wide_dq, {shape}"] = ms
                print(f"flash_bwd_fused, flash_bwd_dkv and flash_bwd_dq at {shape}, in turns: "
                      + "; ".join(f"{n} {v:.4f} ms" for n, v in ms.items()) + "; final / parent: "
                      + ", ".join(f"{k} {ms[f'wide_dq_final {k}'] / ms[f'wide_dq_parent {k}']:.4f}"
                                  for k in ("fused", "dkv", "dq")), flush=True)
    bwd.kv_head_split = head_split
    for module, lib in originals.items():
        module._lib = lib
    print(json.dumps({"device": torch.cuda.get_device_name(0), "ms": result}), flush=True)
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
