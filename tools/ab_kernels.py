#!/usr/bin/env python3
"""A/B the split dQ kernel and the paged decode against variants of themselves.

Each variant is ``csrc/flash_bwd.cu`` (the dQ kernel) or
``csrc/flash_decode.cu`` (the paged decode) with one design decision
changed, stated as text edits of that source (``VARIANTS`` below). The
script writes each variant beside a copy of ``sm90.cuh`` under
``build/ab_kernels/<name>/``, builds every one with the nvcc line of
``kernels/_build.py`` (all at once), prints what ptxas says of it (spills,
serialised wgmmas), holds it against the plain version, and times it in
turns with the committed kernel (each variant in order, then in reverse)
after an L2 flush: the dQ variants at the training shape (B 2, S 2048,
causal, 32 q heads, 8 kv heads), the paged ones at the serving path's
decode shape (B 4, lengths 15/108/708/1508 of 2048, pages of 16, 8
splits), the contiguous decode kernel beside them.

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

_S_SS = """        wgmma_ss_n64<0, 0>(s, sw128_desc(sQ + (kk >> 2) * 8192 + (kk & 3) * 32, 16),
                           sw128_desc(cK + (kk >> 2) * 8192 + (kk & 3) * 32, 16), kk > 0);"""
_DP_SS = """        wgmma_ss_n64<0, 0>(dp, sw128_desc(sdO + (kk >> 2) * 8192 + (kk & 3) * 32, 16),
                           sw128_desc(cV + (kk >> 2) * 8192 + (kk & 3) * 32, 16), kk > 0);"""
_DQ_LOOP = """    for (int n = 0;; ++n) {
      const int stage = n % kDqStages;"""


def _fragments(name: str, tile: str) -> str:
    """Register A fragments of a warpgroup's 64 x 128 bf16 tile, read once
    from its swizzled shared-memory copy with ldmatrix (the forward's Q)."""
    return f"""    uint32_t {name}[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {{
      const int row = wq * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      const int col = kk * 16 + (lane >> 4) * 8;
      const uint32_t at = {tile} + (col >> 6) * 8192 + row * 128 + ((((col & 63) >> 3) ^ (row & 7)) << 4);
      asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {{%0,%1,%2,%3}}, [%4];\\n"
                   : "=r"({name}[kk][0]), "=r"({name}[kk][1]), "=r"({name}[kk][2]), "=r"({name}[kk][3])
                   : "r"(at));
    }}
"""


_S_RS = ("        wgmma_rs_n64<0>(s, qf[kk], sw128_desc(cK + (kk >> 2) * 8192 + (kk & 3) * 32, 16),"
         " kk > 0);")
_DP_RS = ("        wgmma_rs_n64<0>(dp, dof[kk], sw128_desc(cV + (kk >> 2) * 8192 + (kk & 3) * 32, 16),"
          " kk > 0);")
_SLOTS = "  p.slots = 2 * kPagedWarps * 2 * half <= 128 * 1024 ? 2 : 1;"
_FULL = ("  uint64_t* full = reinterpret_cast<uint64_t*>(parts + kPagedWarps * kPartFloats) + "
         "warp * p.slots;")
_SMEM = """  const size_t smem = kPagedWarps * (p.slots * (2 * half + sizeof(uint64_t)) +
                                     kPartFloats * sizeof(float));"""
_PART_OF = """  auto part_of = [&](int k) -> const float* {
    return cluster.map_shared_rank(parts, k / kPagedWarps) + (k % kPagedWarps) * kPartFloats;
  };"""
_MERGE_END = """  cluster.sync();  // rank 0 has read the other CTA's shared memory\n}\n"""
_MERGE_BY_HEAD = """  // Rank 0 merges the workers in order (by logical position), the other
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
"""
_MERGE_BY_COLUMN = """  // Rank 0 merges the workers in order (by logical position), the other
  // CTA's over distributed shared memory: thread d of column d of every head.
  auto part_of = [&](int k) -> const float* {
    return cluster.map_shared_rank(parts, k / kPagedWarps) + (k % kPagedWarps) * kPartFloats;
  };
  if (rank == 0) {
    for (int g = 0; g < p.G; ++g) {
      for (int d = threadIdx.x; d < D; d += blockDim.x) {
        float mx = -INFINITY;
#pragma unroll
        for (int k = 0; k < kPagedWorkers; ++k) mx = fmaxf(mx, part_of(k)[kMaxGroup * D + g]);
        float sum = 0.f, o = 0.f;
#pragma unroll
        for (int k = 0; k < kPagedWorkers; ++k) {
          const float* w = part_of(k);
          const float scale = expf(w[kMaxGroup * D + g] - mx);  // 0 for a worker with no rows
          sum += scale * w[kMaxGroup * D + kMaxGroup + g];
          o += scale * w[g * D + d];
        }
        p.o_parts[(part * p.G + g) * D + d] = o / sum;
        if (d == 0) p.lse_parts[part * p.G + g] = mx + logf(sum);
      }
    }
  }
"""
_COPY_WAIT = "    mbar_wait(&full[n % p.slots], (n / p.slots) & 1);\n"
_COPY_FIRST = "  if (lane == 0)\n    for (int n = 0; n < p.slots; ++n) issue(n);\n"
_COPY_NEXT = "    if (lane == 0) issue(n + p.slots);\n"
_UNIT_SKIP = "      if (!vis.any(base + u, base + min(u + 16, rows))) continue;  // uniform in the warp\n"
_ENTRY = "      phys = tbl[page];"
_LENGTH = "  const int L = max(min(p.lengths[b], p.n_pages * p.ps), 0);"

# name -> (source, what it changes, [(old text, new text), ...]).
VARIANTS = {
    "dq_final": ("flash_bwd", "the dQ kernel as committed", []),
    "dq_q_regs": ("flash_bwd", "S = Q K^T takes Q from registers (wgmma RS), as the forward", [
        (_DQ_LOOP, _fragments("qf", "sQ") + _DQ_LOOP), (_S_SS, _S_RS)]),
    "dq_q_do_regs": ("flash_bwd", "Q and dO from registers (both products wgmma RS)", [
        (_DQ_LOOP, _fragments("qf", "sQ") + _fragments("dof", "sdO") + _DQ_LOOP),
        (_S_SS, _S_RS), (_DP_SS, _DP_RS)]),
    "dq_stages2": ("flash_bwd", "a 2-stage K/V ring instead of 4",
                   [("constexpr int kDqStages = 4;", "constexpr int kDqStages = 2;")]),
    "paged_final": ("flash_decode", "the paged decode as committed", []),
    "paged_cluster1": ("flash_decode", "one CTA of 4 warps a split, no cluster",
                       [("constexpr int kPagedCluster = 2;", "constexpr int kPagedCluster = 1;")]),
    "paged_warps8": ("flash_decode", "8 warps a CTA (16 workers a split)",
                     [("constexpr int kPagedWarps = 4;", "constexpr int kPagedWarps = 8;")]),
    "paged_slots1": ("flash_decode", "one ring stage a warp at every page size",
                     [(_SLOTS, "  p.slots = 1;")]),
    "paged_merge_by_column": (
        "flash_decode", "rank 0's thread d merges column d of every head, one head after "
        "another (each head's loads wait for the last's)", [(_MERGE_BY_HEAD, _MERGE_BY_COLUMN)]),
    "paged_merge_push": (
        "flash_decode", "each warp stores its partial into rank 0's shared memory (the other "
        "CTA's over distributed shared memory, after a cluster barrier that says both CTAs "
        "have started); rank 0 then merges from its own shared memory, one barrier fewer", [
            (_FULL, _FULL.replace("kPagedWarps * kPartFloats", "kPagedWorkers * kPartFloats")),
            (_SMEM, "  const size_t smem = kPagedWarps * p.slots * (2 * half + sizeof(uint64_t)) +\n"
                    "                      kPagedWorkers * kPartFloats * sizeof(float);"),
            ("  __syncwarp();\n\n  // This warp's visible ordinals",
             "  __syncwarp();\n  asm volatile(\"barrier.cluster.arrive.relaxed.aligned;\\n\" ::: "
             "\"memory\");\n\n  // This warp's visible ordinals"),
            ("  float* mine = parts + warp * kPartFloats;",
             "  asm volatile(\"barrier.cluster.wait.aligned;\\n\" ::: \"memory\");\n"
             "  float* mine = cluster.map_shared_rank(parts, 0) + worker * kPartFloats;"),
            (_PART_OF, "  auto part_of = [&](int k) -> const float* { return parts + k * "
                       "kPartFloats; };"),
            (_MERGE_END, "}\n")]),
    # Diagnostics: each leaves a part out, so its partials are wrong.
    "paged_no_merge": ("flash_decode", "diagnostic: the cluster barriers, no merge",
                       [("  if (rank == 0) {\n    for (int g = warp; g < p.G; g += kPagedWarps) {",
                         "  if (rank == 0 && p.G < 0) {\n    for (int g = warp; g < p.G; g += "
                         "kPagedWarps) {")]),
    "paged_tbl_prefetch": (
        "flash_decode", "the lanes read the split's first 32 table entries beside the length; "
        "lane 0 takes a page's entry from them", [
            (_LENGTH, "  const int* tbl = p.table + static_cast<long long>(b) * p.n_pages;\n"
                      "  const int pre = split * p.pp + lane < p.n_pages ? tbl[split * p.pp + lane] : 0;\n"
             + _LENGTH),
            ("  const int* tbl = p.table + static_cast<long long>(b) * p.n_pages;\n"
             "  int cur_page", "  int cur_page"),
            (_FULL, _FULL + "\n  int* s_tbl = reinterpret_cast<int*>(full + (kPagedWarps - warp) * "
                            "p.slots) + warp * 32;\n  s_tbl[lane] = pre;"),
            (_ENTRY, "      phys = page - page0 < 32 && page - page0 < p.pp ? s_tbl[page - page0] : "
                     "tbl[page];"),
            (_SMEM, _SMEM.replace("sizeof(float));", "sizeof(float)) + kPagedWarps * 32 * "
                                  "sizeof(int);"))]),
    "paged_copies_only": ("flash_decode", "diagnostic: the copies and their waits, no math",
                          [(_UNIT_SKIP, "      continue;\n")]),
    "paged_math_only": ("flash_decode", "diagnostic: the math on whatever the stages hold, no "
                        "copies and no waits",
                        [(_COPY_WAIT, ""), (_COPY_FIRST, ""), (_COPY_NEXT, "")]),
}

DIAGNOSTICS = {"paged_no_merge", "paged_copies_only", "paged_math_only"}


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
        kernel = "fa2_bwd_dq_kernel" if name.startswith("dq") else "fa2_decode_paged_kernel"
        regs = []
        for block in log.split("Compiling entry function")[1:]:
            if kernel in block.splitlines()[0]:
                regs.append("/".join(re.findall(r"Used (\d+) registers", block)[:1]
                                     + re.findall(r"(\d+) bytes spill stores", block)[:1]))
        notes = sorted(set(re.findall(r"\((C75\d+)\) Potential Performance Loss", log)))
        print(f"{name}: {VARIANTS[name][1]}; {kernel} registers/spill-store bytes per "
              f"instantiation {regs}; ptxas performance notes {notes or 'none'}", flush=True)
        module = bwd if name.startswith("dq") else dec
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
    for final in ("dq_final", "paged_final"):
        if final not in names and any(n.startswith(final.split("_")[0]) for n in names):
            names.insert(0, final)
    print(nvidia_smi(), flush=True)
    libs = build(names)
    dq_names = [n for n in names if n.startswith("dq")]
    paged_names = [n for n in names if n.startswith("paged")]
    originals = {bwd: bwd._lib, dec: dec._lib}

    def use(name):
        module = bwd if name.startswith("dq") else dec
        module._lib = lambda: libs[name]

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()

    scratch = torch.empty(96 * 2**20, dtype=torch.uint8, device=dev)

    def time_ms(fn, iters=30):
        fn()
        fn()
        torch.cuda.synchronize()
        events = []
        for _ in range(iters):
            scratch.zero_()
            torch.cuda._sleep(1_000_000)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in events) / iters

    def in_turns(calls):
        runs = {n: [] for n in calls}
        for name in list(calls) + list(calls)[::-1]:
            if name in libs:
                use(name)
            runs[name].append(time_ms(calls[name]))
        return {n: sum(r) / 2 for n, r in runs.items()}

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
    for module, lib in originals.items():
        module._lib = lib
    print(json.dumps({"device": torch.cuda.get_device_name(0), "ms": result}), flush=True)
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
