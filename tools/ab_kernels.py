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
leaves L2 full of dirty lines) and after one that only reads 96 MB.

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

_S_SS = "        wgmma_ss_n64<0, 0>(s, kmajor_desc<D>(sQ, kk), kmajor_desc<D>(cK, kk), kk > 0);"
_DP_SS = "        wgmma_ss_n64<0, 0>(dp, kmajor_desc<D>(sdO, kk), kmajor_desc<D>(cV, kk), kk > 0);"
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


_S_RS = "        wgmma_rs_n64<0>(s, qf[kk], kmajor_desc<D>(cK, kk), kk > 0);"
_DP_RS = "        wgmma_rs_n64<0>(dp, dof[kk], kmajor_desc<D>(cV, kk), kk > 0);"
_SLOTS = "  p.slots = 2 * kPagedWarps * 2 * half <= 128 * 1024 ? 2 : 1;"
_COPY_WAIT = "    mbar_wait(&full[n % p.slots], (n / p.slots) & 1);\n"
_COPY_FIRST = "  if (lane == 0)\n    for (int n = 0; n < p.slots; ++n) issue(n);\n"
_COPY_NEXT = "    if (lane == 0) issue(n + p.slots);\n"
_UNIT_SKIP = "      if (vrows == 0u) continue;  // uniform in the warp\n"
_KV_WG = ("  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);"
          "  // warp-uniform (wg_rs_k64)\n")

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

# name -> (source, what it changes, [(old text, new text), ...]).
VARIANTS = {
    "dq_final": ("flash_bwd", "the dQ kernel as committed", []),
    "dq_q_regs": ("flash_bwd", "S = Q K^T takes Q from registers (wgmma RS), as the forward", [
        (_DQ_LOOP, _fragments("qf", "sQ") + _DQ_LOOP), (_S_SS, _S_RS)]),
    "dq_q_do_regs": ("flash_bwd", "Q and dO from registers (both products wgmma RS)", [
        (_DQ_LOOP, _fragments("qf", "sQ") + _fragments("dof", "sdO") + _DQ_LOOP),
        (_S_SS, _S_RS), (_DP_SS, _DP_RS)]),
    "dq_stages2": ("flash_bwd", "a 2-stage K/V ring instead of 4",
                   [("STAGES = D == 256 ? 2 : D == 160 ? 3 : 4;", "STAGES = 2;")]),
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
}

DIAGNOSTICS = {"paged_copies_only", "paged_math_only", "decode_copies_only", "decode_math_only"}

# Variant groups: name prefix -> (kernel whose ptxas lines are printed,
# the wrapper module's name).
GROUPS = {"dq": ("fa2_bwd_dq_kernel", "flash_bwd"),
          "kv": ("fa2_bwd_fused_kernel", "flash_bwd"),
          "paged": ("fa2_decode_paged_kernel", "flash_decode"),
          "decode": ("fa2_decode_kernel", "flash_decode"),
          "delta": ("fa2_bwd_delta_kernel", "flash_bwd")}


def group(name: str) -> str:
    return name.split("_")[0]


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
        text = (CSRC / f"{src}.cu").read_text()
        for old, new in edits:
            if text.count(old) != 1 or new == old:
                raise SystemExit(f"variant {name}: an edit no longer matches {src}.cu, or "
                                 f"changes nothing")
            text = text.replace(old, new)
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / f"{src}.cu").write_text(text)
        shutil.copy(CSRC / "sm90.cuh", d / "sm90.cuh")
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
        for block in log.split("Compiling entry function")[1:]:
            if kernel in block.splitlines()[0]:
                regs.append("/".join(re.findall(r"Used (\d+) registers", block)[:1]
                                     + re.findall(r"(\d+) bytes spill stores", block)[:1]))
        notes = sorted(set(re.findall(r"\((C75\d+)\) Potential Performance Loss", log)))
        print(f"{name}: {VARIANTS[name][1]}; {kernel} registers/spill-store bytes per "
              f"instantiation {regs}; ptxas performance notes {notes or 'none'}", flush=True)
        module = bwd if GROUPS[group(name)][1] == "flash_bwd" else dec
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
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
    dq_names, kv_names, paged_names, decode_names, delta_names = (
        [n for n in names if group(n) == g] for g in GROUPS)
    originals = {bwd: bwd._lib, dec: dec._lib}

    def use(name):
        module = bwd if GROUPS[group(name)][1] == "flash_bwd" else dec
        module._lib = lambda: libs[name]

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()

    scratch = torch.empty(96 * 2**20, dtype=torch.uint8, device=dev)
    # Two flushes of the 50 MB L2: zeroing 96 MB (chip_smoke.py's; it leaves
    # the L2 full of dirty lines that the timed kernel's misses write back)
    # and reading 96 MB (it leaves clean lines).
    flushes = {"write": scratch.zero_, "read": lambda: scratch.view(torch.int32).amax()}

    def time_ms(fn, iters=30, flush="write"):
        fn()
        fn()
        torch.cuda.synchronize()
        events = []
        for _ in range(iters):
            flushes[flush]()
            torch.cuda._sleep(1_000_000)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in events) / iters

    def in_turns(calls, flush="write"):
        runs = {n: [] for n in calls}
        for name in list(calls) + list(calls)[::-1]:
            if name.split(" ")[0] in libs:
                use(name.split(" ")[0])
            runs[name].append(time_ms(calls[name], flush=flush))
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
    for module, lib in originals.items():
        module._lib = lib
    print(json.dumps({"device": torch.cuda.get_device_name(0), "ms": result}), flush=True)
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
