#!/usr/bin/env python3
"""A/B the CUDA forward against variants of itself on one NVIDIA card.

Each variant is the forward of ``src/repro_torch/kernels/csrc/flash_fwd.cu``
with one design decision undone, stated as text edits of that source
(``VARIANTS`` below) inside one kernel: the pair kernel
(``fa2_fwd_kernel``, head_dim 64, 128 and 160) or the head_dim-256 kernel
(``fa2_fwd_wide_kernel``). A variant may instead keep the source and pass
the wrappers an option (the 256 kernel's tile mode), or build the parent
design's forward (the parent commit's ``flash_fwd.cu`` and ``sm90.cuh``,
written under ``build/ab_forward/parent_src/`` first, see ``PARENT``;
its C entry lacks the one-q-tile flag). The script
writes each variant beside a copy of ``sm90.cuh`` under
``build/ab_forward/<name>/``, builds every one with the nvcc line of
``kernels/_build.py`` (all at once), prints what ptxas says of it (spills,
serialised wgmmas), holds it against the plain version on one case, and
times it in turns with the others and SDPA's forward (each variant, SDPA,
then the same in reverse) after an L2 flush: the pair kernel's variants at
qwen3-8b's training and serving shapes and whisper's encoder shape (the
segment variants also on the packed source's ids), the 256 kernel's at
gemma3-1b's prefill (causal, the 512 window, 3 kv splits), its training
shape (causal, the window, SEG on the packed source's ids, DENSE, both, SEG
with 2 splits, and B 8) and its short-q/long-kv corner (64 q rows against
32,768 keys, split).

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

# The wide kernel's K stage, freed as soon as S has completed; undone, it is
# freed with V after the P V that reads V, as one barrier a stage would.
_K_EARLY = """        // S has completed and the stage's ids are read: K's stage is free
        // while this step's softmax and P V run.
        mbar_arrive(&k_empty[st]);
"""
_V_FREE = "        if (!first) mbar_arrive(&v_empty[pend]);\n"
_V_DRAIN = "          mbar_arrive(&v_empty[pend]);\n          pend = -1;\n"
_V_LAST = "      mbar_arrive(&v_empty[pend]);\n    }\n\n    if (single) {"
_PV_OWN = """        const int vs = first ? st : pend;
        mbar_wait(&v_full[vs], first ? ph : pph);
        wgmma_rs_k64<D>(o, pc, sV + vs * L::TILE);
"""

# name -> (what it undoes, [(old text, new text), ...] on flash_fwd.cu, the
# text the edits apply to: the pair kernel (the default), the wide kernel
# or the whole file; wrapper options). A variant's edits match exactly once
# inside that text; "file" edits are timed with the pair kernel's.
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
    "stages3": ("a 3-stage K/V ring instead of 4 (at head_dim 64 and 128)",
                [("constexpr int kFwdStages = 4;", "constexpr int kFwdStages = 3;")], "file"),
    "ids_every_step": (
        "SEG: the producer's lanes load the kv tile's ids at every step (plain loads on its "
        "path), instead of a cp.async copy only when a tile needs the element mask",
        [(_IDS_MASKED, """          if (SEG) {
            for (int r = lane; r < kBlockN; r += 32)
              sKid[stage * kBlockN + r] = k0 + r < p.Skv ? kid_g[k0 + r] : kKvPadSegment;
          }
""")]),
    # The head_dim-256 kernel: each of its two changes undone alone, and the
    # parent design.
    "kv_one_barrier": (
        "256: frees K's stage with V's, after the P V that reads V (one barrier a stage), "
        "instead of once S has completed",
        [(_K_EARLY, ""),
         (_V_FREE, "        if (!first) {\n          mbar_arrive(&v_empty[pend]);\n"
                   "          mbar_arrive(&k_empty[pend]);\n        }\n"),
         (_V_DRAIN, "          mbar_arrive(&v_empty[pend]);\n          mbar_arrive(&k_empty[pend]);"
                    "\n          pend = -1;\n"),
         (_V_LAST, "      mbar_arrive(&v_empty[pend]);\n      mbar_arrive(&k_empty[pend]);\n    }"
                   "\n\n    if (single) {")], "wide"),
    "pair_grid": ("256: a pair of q tiles a CTA at every shape (the wrappers' single_tile=False), "
                  "instead of one q tile a CTA where the pair grid is under one wave", [], "wide",
                  dict(single_tile=False)),
    "single_grid": ("256: one q tile a CTA at every shape (single_tile=True), the pair grid's "
                    "counterpart: what the rule's choice of the pair at the training shape keeps",
                    [], "wide", dict(single_tile=True)),
    "first_pv_on_own_v": (
        "256: a run's first P = 0 product reads the step's own V stage (waited for after S is "
        "issued), instead of the Q tile (landed before the walk)",
        [("        mbar_wait(first ? q_bar : &v_full[pend], first ? 0 : pph);\n", ""),
         ("        wgmma_rs_k64<D>(o, pc, first ? sQ : sV + pend * L::TILE);\n", _PV_OWN)],
        "wide"),
    "parent": ("256: the parent design (the parent commit's flash_fwd.cu, see PARENT: a pair of "
               "q tiles a CTA, K and V of a stage on one barrier, 2 stages)", [], "wide",
               dict(single_tile=False)),
}

# The parent commit's flash_fwd.cu and sm90.cuh, for the parent variant:
# write them here first, e.g.
#   mkdir -p build/ab_forward/parent_src
#   git show <commit>:src/repro_torch/kernels/csrc/flash_fwd.cu > build/ab_forward/parent_src/flash_fwd.cu
#   git show <commit>:src/repro_torch/kernels/csrc/sm90.cuh > build/ab_forward/parent_src/sm90.cuh
PARENT = OUT / "parent_src"
_SCOPES = {"pair": ("fa2_fwd_kernel(const FwdParams p", "// ---------------------------------------"),
           "wide": ("fa2_fwd_wide_kernel(const FwdParams p", "// The fold of SPLIT's partials:"),
           "file": ("", None)}


def scope(name: str) -> str:
    """The kernel a variant's edits apply to."""
    return VARIANTS[name][2] if len(VARIANTS[name]) > 2 else "pair"


def options(name: str) -> dict:
    """The wrapper options a variant passes."""
    return VARIANTS[name][3] if len(VARIANTS[name]) > 3 else {}


def nvidia_smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]


def write_variants(names):
    source = (CSRC / "flash_fwd.cu").read_text()
    for name in names:
        if name == "parent" and not (PARENT / "flash_fwd.cu").exists():
            raise SystemExit(f"variant parent: no {PARENT / 'flash_fwd.cu'} (see PARENT)")
        text = (PARENT / "flash_fwd.cu").read_text() if name == "parent" else source
        if VARIANTS[name][1]:
            start, end = _SCOPES[scope(name)]
            a = text.index(start)
            b = len(text) if end is None else text.index(end, a)
            body = text[a:b]
            for old, new in VARIANTS[name][1]:
                if body.count(old) != 1:
                    raise SystemExit(f"variant {name}: its edit no longer matches the "
                                     f"{scope(name)} kernel of flash_fwd.cu")
                body = body.replace(old, new)
            text = text[:a] + body + text[b:]
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "flash_fwd.cu").write_text(text)
        shutil.copy((PARENT if name == "parent" else CSRC) / "sm90.cuh", d / "sm90.cuh")


class _Parent:
    """The parent design's library behind the committed wrappers: its entry
    lacks the trailing one-q-tile flag, so a call drops it (it must be 0)."""

    def __init__(self, lib):
        self.lib = lib

    def fa2_fwd_bf16(self, *args):
        if args[-1]:
            raise ValueError("the parent design has no one-q-tile mode")
        return self.lib.fa2_fwd_bf16(*args[:-1])


def build(names):
    """Build every variant with edits (and the committed source, "final",
    and the parent) at once; a variant of options only reuses "final"."""
    from repro_torch.kernels import _build

    nvcc = _build._nvcc()
    own = [n for n in names if n in ("final", "parent") or VARIANTS[n][1]]
    procs = {n: subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-o", str(OUT / n / "lib.so"),
                                  str(OUT / n / "flash_fwd.cu")], stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True) for n in own}
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
        tail = [] if name == "parent" else [I]  # the one-q-tile flag
        lib.fa2_fwd_bf16.argtypes = [P] * 6 + [L] * 13 + [I] * 16 + [P, P, L, L, P, I, P, P,
                                                                       P] + tail
        lib.fa2_fwd_bf16.restype = ctypes.c_int
        libs[name] = _Parent(lib) if name == "parent" else lib
    for name in names:
        if name not in libs:
            print(f"{name}: {VARIANTS[name][0]}", flush=True)
            libs[name] = libs["final"]
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

    def in_scope(name, D):
        return name == "final" or (scope(name) == "wide") == (D == 256)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs(B, S, Hq, Hkv, D, Skv=None):
        q = ops._prep(torch.randn((B, S, Hq, D), generator=gen, device=dev).bfloat16(),
                      1 / math.sqrt(D))
        Skv = S if Skv is None else Skv
        return (q, torch.randn((B, Skv, Hkv, D), generator=gen, device=dev).bfloat16(),
                torch.randn((B, Skv, Hkv, D), generator=gen, device=dev).bfloat16())

    def packed(B, S):
        ids = SyntheticVarlenLM(DataConfig(B, S, 512, seed=0, source="packed")).batch(0)
        return torch.from_numpy(ids["segment_ids"]).to(dev)

    tiles = dict(block_q=64, block_kv=64)
    bad = 0
    causal = MaskSpec(causal=True)
    for D, Hq, Hkv in ((128, 32, 8), (256, 4, 1)):
        q, k, v = inputs(2, 700, Hq, Hkv, D)
        ids = packed(2, 700)
        for name in [n for n in names if in_scope(n, D)]:
            use(name)
            kw = dict(tiles, **options(name))
            want = fwd.flash_fwd_plain(q, k, v, causal, **kw)
            want_s = fwd.flash_fwd_plain(q, k, v, causal, q_seg=ids, kv_seg=ids, **kw)
            got = fwd.flash_fwd(q, k, v, causal, **kw)
            got_s = fwd.flash_fwd_varlen(q, k, v, causal, ids, ids, **kw)
            torch.cuda.synchronize()
            err = max((a.float() - b.float()).abs().max().item()
                      for a, b in ((got[0], want[0]), (got_s[0], want_s[0])))
            ok = err <= 2e-2
            bad += not ok
            print(f"{name}: D={D} B=2 S=700 causal, max|o-plain| (unsegmented and packed) "
                  f"{err:.3e} (tol 2e-2){'' if ok else ' FAILS'}", flush=True)

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

    # label -> (B, Sq, Skv, Hq, Hkv, D, spec, kv splits or None, form): form
    # "" the compact schedule, "seg" the packed source's ids (Sq == Skv),
    # "dense" the dense schedule, "dense seg" both.
    window = MaskSpec(causal=True, window=512)
    shapes = {
        "training B=2 S=2048 causal D=128": (2, 2048, 2048, 32, 8, 128, causal, None, ""),
        "serving B=1 S=1536 causal D=128": (1, 1536, 1536, 32, 8, 128, causal, None, ""),
        "whisper encoder B=4 S=1500 FULL D=64": (4, 1500, 1500, 8, 8, 64, MaskSpec(), None, ""),
        "gemma3 prefill B=1 S=1536 causal D=256": (1, 1536, 1536, 4, 1, 256, causal, None, ""),
        "gemma3 prefill B=1 S=1536 window 512 D=256": (1, 1536, 1536, 4, 1, 256, window, None, ""),
        "gemma3 split prefill B=1 S=1536 causal D=256, 3 splits": (
            1, 1536, 1536, 4, 1, 256, causal, 3, ""),
        "gemma3 training B=4 S=2048 causal D=256": (4, 2048, 2048, 4, 1, 256, causal, None, ""),
        "gemma3 training B=4 S=2048 window 512 D=256": (
            4, 2048, 2048, 4, 1, 256, window, None, ""),
        "gemma3 training B=4 S=2048 causal D=256 SEG": (
            4, 2048, 2048, 4, 1, 256, causal, None, "seg"),
        "gemma3 training B=4 S=2048 causal D=256 DENSE": (
            4, 2048, 2048, 4, 1, 256, causal, None, "dense"),
        "gemma3 training B=4 S=2048 causal D=256 DENSE SEG": (
            4, 2048, 2048, 4, 1, 256, causal, None, "dense seg"),
        "gemma3 packed split B=4 S=2048 causal D=256 SEG, 2 splits": (
            4, 2048, 2048, 4, 1, 256, causal, 2, "seg"),
        "gemma3 B=8 S=2048 causal D=256": (8, 2048, 2048, 4, 1, 256, causal, None, ""),
        "gemma3 corner Sq=64 Skv=32768 causal D=256, 33 splits": (
            1, 64, 32768, 4, 1, 256, MaskSpec(causal=True, q_offset=32768 - 64), 33, ""),
    }
    result = {}
    for label, (B, Sq, Skv, Hq, Hkv, D, spec, ks, form) in shapes.items():
        here = [n for n in names if in_scope(n, D)]
        if here == ["final"] and len(names) > 1:
            continue
        q, k, v = inputs(B, Sq, Hq, Hkv, D, Skv)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        ids = packed(B, Sq) if "seg" in form else None
        sched = dict(schedule="dense") if "dense" in form else {}
        sdpa_kw = dict(is_causal=spec.causal) if ks is None else dict(
            attn_mask=torch.ones(Sq, Skv, dtype=torch.bool, device=dev).tril(Skv - Sq))
        if spec.window is not None or ids is not None:
            ago = torch.arange(Sq, device=dev)[:, None] - torch.arange(Skv, device=dev)[None, :]
            mask = (ago >= 0) & (ago < (spec.window or Skv))
            if ids is not None:
                mask = mask & (ids[:, None, :, None] == ids[:, None, None, :])
            sdpa_kw = dict(attn_mask=mask)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, scale=1.0,
                                                  **sdpa_kw)

        def call(name):
            kw = dict(tiles, **options(name))
            if ids is not None and ks is None:
                return lambda: fwd.flash_fwd_varlen(q, k, v, spec, ids, ids, **sched, **kw)
            if ids is not None:
                return lambda: fwd.flash_fwd_splitkv_varlen(q, k, v, spec, ids, ids,
                                                            kv_splits=ks, **kw)
            if ks is None:
                return lambda: fwd.flash_fwd(q, k, v, spec, **sched, **kw)
            return lambda: fwd.flash_fwd_splitkv(q, k, v, spec, kv_splits=ks, **kw)

        runs = {n: [] for n in here + ["sdpa"]}
        order = here + ["sdpa"]
        for name in order + order[::-1]:
            if name == "sdpa":
                runs[name].append(time_ms(sdpa))
            else:
                use(name)
                runs[name].append(time_ms(call(name)))
        ms = {n: sum(r) / 2 for n, r in runs.items()}
        result[label] = ms
        n_ks = fwd.split_count(Skv, 64, ks) if ks else 1
        mode = ("one q tile a CTA" if fwd.single_q_tile(B, Hq, -(-Sq // 64), D, n_ks)
                else "a pair of q tiles a CTA")
        print(f"{label} (final: {mode}): sdpa {ms['sdpa']:.4f} ms; " + "; ".join(
            f"{n} {ms[n]:.4f} ms ({ms[n] / ms['sdpa']:.4f}x sdpa, {ms[n] / ms['final']:.4f}x "
            f"final)" for n in here), flush=True)

    B, S = 2, 2048
    q, k, v = inputs(B, S, 32, 8, 128)
    ids = packed(B, S)
    ones = torch.ones_like(ids)
    seg_names = [n for n in names if in_scope(n, 128)]
    for label, seg in (("packed step 0", ids), ("all-ones ids", ones)):
        if seg_names == ["final"] and len(names) > 1:
            break
        runs = {n: [] for n in seg_names}
        for name in seg_names + seg_names[::-1]:
            use(name)
            runs[name].append(time_ms(lambda: fwd.flash_fwd_varlen(q, k, v, causal, seg, seg,
                                                                  **tiles)))
        ms = {n: sum(r) / 2 for n, r in runs.items()}
        result[f"segments, training shape, {label}"] = ms
        print(f"flash_fwd_varlen B={B} S={S} causal, {label}: " + "; ".join(
            f"{n} {ms[n]:.4f} ms" for n in seg_names), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "ms": result}), flush=True)
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
