#!/usr/bin/env python3
"""A/B the CUDA forward against variants of itself on one NVIDIA card.

Each variant is the forward of ``src/repro_torch/kernels/csrc/flash_fwd.cu``
with one design decision undone, stated as text edits of that source
(``VARIANTS`` below). The script writes each variant beside a copy of
``sm90.cuh`` under ``build/ab_forward/<name>/``, builds every one with the
nvcc line of ``kernels/_build.py`` (all at once), prints what ptxas says of
it (spills, serialised wgmmas), holds it against the plain version on one
case, and times it in turns with the others and SDPA's forward (each
variant, SDPA, then the same in reverse) after an L2 flush, at the
training shape, the serving shape and whisper's encoder shape. Segment
variants are also timed on the packed source's ids.

Run from the repository root on a machine with an H100 and nvcc:

    python3 tools/ab_forward.py [variant ...]     # default: all

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
OUT = ROOT / "build" / "ab_forward"

_PV_ALWAYS = """      const bool first = pend < 0;
      if (first)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) pc[kk][e] = 0u;
"""
_PV_PRODUCT = """      wgmma_rs_k64<D>(o, pc, sV + (first ? stage : pend) * L::TILE);
      wgmma_commit();
      wgmma_wait<1>();
"""
_PV_WAIT = """      wgmma_wait<0>();  // the pending O += P V is done: its stage is free
      fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(pc[kk]);
      if (!first) mbar_arrive(&empty[pend]);
"""
_IDS_MASKED = """          if (SEG && (flags & (kMask0 | kMask1))) {
            for (int r = lane; r < kBlockN; r += 32) {
              const bool in = k0 + r < p.Skv;
              asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\\n" ::"r"(
                               smem_u32(sKid + stage * kBlockN + r)),
                           "l"(kid_g + (in ? k0 + r : 0)), "r"(in ? 4 : 0)
                           : "memory");
            }
            asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\\n" ::"r"(
                             smem_u32(&full[stage]))
                         : "memory");
          }
"""

# name -> (what it undoes, [(old text, new text), ...]) on flash_fwd.cu.
VARIANTS = {
    "final": ("the forward as committed", []),
    "pingpong": (
        "adds FlashAttention-3's ping-pong: the consumer warpgroups take turns at issuing "
        "their products (named barriers 3 and 4), warpgroup 0 first",
        [("    mbar_wait(q_bar, 0);\n    // Q as bf16",
          "    if (w == 1) asm volatile(\"bar.arrive 3, 256;\\n\" ::: \"memory\");\n"
          "    mbar_wait(q_bar, 0);\n    // Q as bf16"),
         ("      if (rec.x < 0) break;\n",
          "      if (rec.x < 0) break;\n"
          "      asm volatile(\"bar.sync %0, 256;\\n\" ::\"r\"(3 + w) : \"memory\");\n"),
         ("      if (!(rec.y & take)) {\n",
          "      if (!(rec.y & take)) {\n"
          "        asm volatile(\"bar.arrive %0, 256;\\n\" ::\"r\"(3 + (w ^ 1)) : \"memory\");\n"),
         (_PV_PRODUCT, _PV_PRODUCT.replace(
             "      wgmma_wait<1>();\n",
             "      asm volatile(\"bar.arrive %0, 256;\\n\" ::\"r\"(3 + (w ^ 1)) : \"memory\");\n"
             "      wgmma_wait<1>();\n"))]),
    "conditional_pv": (
        "issues P V (and waits for it) only when a step is pending, instead of a P = 0 "
        "product on a run's first step",
        [(_PV_ALWAYS, "      const bool first = pend < 0;\n"),
         (_PV_PRODUCT, """      if (!first) {
        wgmma_rs_k64<D>(o, pc, sV + pend * L::TILE);
        wgmma_commit();
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
"""),
         (_PV_WAIT, """      if (!first) {
        wgmma_wait<0>();
        fence_regs(o);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) fence_regs(pc[kk]);
        mbar_arrive(&empty[pend]);
      }
""")]),
    "divergent": (
        "reads the warpgroup index and the step record without the broadcast from lane 0",
        [("  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);",
          "  const int wg = threadIdx.x / 128;"),
         ("      rec.x = __shfl_sync(0xffffffffu, rec.x, 0);\n"
          "      rec.y = __shfl_sync(0xffffffffu, rec.y, 0);\n", "")]),
    "q_in_smem": (
        "reads Q for S = Q K^T from its shared-memory tile (wgmma SS) instead of registers, "
        "as the head_dim-256 instantiation does",
        [("  constexpr bool QSS = D == 256;", "  constexpr bool QSS = true;")]),
    "stages3": ("a 3-stage K/V ring instead of 4 (at head_dim 64 and 128)",
                [("  return D == 256 ? 2 : 4;", "  return D == 256 ? 2 : 3;")]),
    "ids_every_step": (
        "SEG: the producer's lanes load the kv tile's ids at every step (plain loads on its "
        "path), instead of a cp.async copy only when a tile needs the element mask",
        [(_IDS_MASKED, """          if (SEG) {
            for (int r = lane; r < kBlockN; r += 32)
              sKid[stage * kBlockN + r] = k0 + r < p.Skv ? kid_g[k0 + r] : kKvPadSegment;
          }
""")]),
}


def nvidia_smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]


def write_variants(names):
    source = (CSRC / "flash_fwd.cu").read_text()
    for name in names:
        text = source
        for old, new in VARIANTS[name][1]:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: its edit no longer matches flash_fwd.cu")
            text = text.replace(old, new)
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "flash_fwd.cu").write_text(text)
        shutil.copy(CSRC / "sm90.cuh", d / "sm90.cuh")


def build(names):
    from repro_torch.kernels import _build

    nvcc = _build._nvcc()
    procs = {n: subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-o", str(OUT / n / "lib.so"),
                                  str(OUT / n / "flash_fwd.cu")], stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True) for n in names}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        spills = sorted({m for m in re.findall(r"(\d+) bytes spill stores", log)}, key=int)
        notes = sorted({m for m in re.findall(r"\((C75\d+)\) Potential Performance Loss", log)})
        print(f"{name}: {VARIANTS[name][0]}; spill stores (bytes) per instantiation "
              f"{spills}; ptxas performance notes {notes or 'none'}", flush=True)
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        P, I, L = _build.VOIDP, _build.INT, _build.I64
        lib.fa2_fwd_bf16.argtypes = [P] * 6 + [L] * 13 + [I] * 16 + [P, P, L, L, P, I, P, P, P]
        lib.fa2_fwd_bf16.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> None:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script times kernels on an NVIDIA GPU")
    from repro_torch.core.masks import MaskSpec
    from repro_torch.data.pipeline import DataConfig, SyntheticVarlenLM
    from repro_torch.kernels import flash_fwd as fwd
    from repro_torch.kernels import ops

    names = sys.argv[1:] or list(VARIANTS)
    if "final" not in names:
        names.insert(0, "final")
    print(nvidia_smi(), flush=True)
    write_variants(names)
    libs = build(names)

    def use(name):
        fwd._lib = lambda: libs[name]

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs(B, S, Hq, Hkv, D):
        q = ops._prep(torch.randn((B, S, Hq, D), generator=gen, device=dev).bfloat16(),
                      1 / math.sqrt(D))
        return (q, torch.randn((B, S, Hkv, D), generator=gen, device=dev).bfloat16(),
                torch.randn((B, S, Hkv, D), generator=gen, device=dev).bfloat16())

    def packed(B, S):
        ids = SyntheticVarlenLM(DataConfig(B, S, 512, seed=0, source="packed")).batch(0)
        return torch.from_numpy(ids["segment_ids"]).to(dev)

    tiles = dict(block_q=64, block_kv=64)
    bad = 0
    q, k, v = inputs(2, 700, 32, 8, 128)
    causal = MaskSpec(causal=True)
    ids = packed(2, 700)
    want = fwd.flash_fwd_plain(q, k, v, causal, **tiles)
    want_s = fwd.flash_fwd_plain(q, k, v, causal, q_seg=ids, kv_seg=ids, **tiles)
    for name in names:
        use(name)
        got = fwd.flash_fwd(q, k, v, causal, **tiles)
        got_s = fwd.flash_fwd_varlen(q, k, v, causal, ids, ids, **tiles)
        torch.cuda.synchronize()
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in ((got[0], want[0]), (got_s[0], want_s[0])))
        ok = err <= 2e-2
        bad += not ok
        print(f"{name}: B=2 S=700 causal, max|o-plain| (unsegmented and packed) {err:.3e} "
              f"(tol 2e-2){'' if ok else ' FAILS'}", flush=True)

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

    result = {}
    shapes = {"training B=2 S=2048 causal D=128": (2, 2048, 32, 8, 128, True),
              "serving B=1 S=1536 causal D=128": (1, 1536, 32, 8, 128, True),
              "whisper encoder B=4 S=1500 FULL D=64": (4, 1500, 8, 8, 64, False)}
    for label, (B, S, Hq, Hkv, D, is_causal) in shapes.items():
        q, k, v = inputs(B, S, Hq, Hkv, D)
        spec = MaskSpec(causal=is_causal)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=is_causal,
                                                  enable_gqa=True, scale=1.0)

        runs = {n: [] for n in names + ["sdpa"]}
        order = names + ["sdpa"]
        for name in order + order[::-1]:
            if name == "sdpa":
                runs[name].append(time_ms(sdpa))
            else:
                use(name)
                runs[name].append(time_ms(lambda: fwd.flash_fwd(q, k, v, spec, **tiles)))
        ms = {n: sum(r) / 2 for n, r in runs.items()}
        result[label] = ms
        print(f"{label}: sdpa {ms['sdpa']:.4f} ms; " + "; ".join(
            f"{n} {ms[n]:.4f} ms ({ms[n] / ms['sdpa']:.4f}x sdpa, {ms[n] / ms['final']:.4f}x "
            f"final)" for n in names), flush=True)

    B, S = 2, 2048
    q, k, v = inputs(B, S, 32, 8, 128)
    ids = packed(B, S)
    ones = torch.ones_like(ids)
    for label, seg in (("packed step 0", ids), ("all-ones ids", ones)):
        runs = {n: [] for n in names}
        for name in names + names[::-1]:
            use(name)
            runs[name].append(time_ms(lambda: fwd.flash_fwd_varlen(q, k, v, causal, seg, seg,
                                                                  **tiles)))
        ms = {n: sum(r) / 2 for n, r in runs.items()}
        result[f"segments, training shape, {label}"] = ms
        print(f"flash_fwd_varlen B={B} S={S} causal, {label}: " + "; ".join(
            f"{n} {ms[n]:.4f} ms" for n in names), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "ms": result}), flush=True)
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
