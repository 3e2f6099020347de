"""Repeat launches of the head_dim-160 and -256 kernels (the forward,
``fa2_fwd_wide_kernel``, in every mode and both tile modes, with the split
fold; the fused, dK/dV and dQ backward in every mode) and of the head_dim-64
fused and dK/dV backward (compact, SEG and DENSE at whisper-base's encoder,
cross-attention and decoder shapes and gpt-20m's), and hold each launch
bitwise to the first: a race inside a kernel shows either as a launch fault
or as an output that differs from launch to launch. The fused kernel's dQ
(f32 bulk reductions in no fixed order) is held within 3e-3 of the first
launch's, relative to its largest value, at head_dim 64.

    python tools/stress_kernels.py [--reps N] [--only SUBSTRING] [--flush] [--detail]

``--flush`` writes 96 MB before every launch, as ``chip_smoke.py``'s timing
loops do, so each launch starts on a cold L2 (longer loads, other
interleavings of the warps than back-to-back launches give).

Every case runs in a child process (a fault ends the CUDA context); the
parent starts a new child after the faulting case, so one run names every
faulting case. Prints a line per case (launches, launches that differed,
the fault if any) and the card's name and power limit. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SL = dict(D=160, hq=32, hkv=8, vocab=100_352, train=(2, 2048),
          corner=((1536, None), (4096, None), (32768, None)))
G3 = dict(D=256, hq=4, hkv=1, vocab=262_144, train=(4, 2048),
          corner=((1536, None), (8192, None), (32768, None), (8192, 512)))
W64 = dict(D=64, hq=8, hkv=8, vocab=51_865)
CORNER_ROWS = 64
DQ_REL_TOL = 3e-3  # chip_smoke.py GRAD_REL_TOL
# The head_dim-64 backward's shapes (B, Sq, Skv, heads, causal), as
# chip_smoke.py HD64_SHAPES.
HD64_SHAPES = {
    "encoder": (8, 1500, 1500, 8, False),
    "cross": (8, 448, 1500, 8, False),
    "decoder": (8, 448, 448, 8, True),
    "gpt20m": (8, 512, 512, 4, True),
}


def cases():
    """(name, builder args) of every case: each model's forward shapes,
    each schedule and mode, each tile mode."""
    out = []
    for m in (SL, G3):
        D, (Bt, St) = m["D"], m["train"]
        for single in (False, True):
            tm = "single" if single else "pair"
            for B, S in ((1, 1536), (Bt, St), (1, 260), (2, 333)):
                for sched in ("compact", "dense"):
                    out.append((f"D{D} fwd {sched} B{B} S{S} {tm}",
                                dict(m=m, kind="fwd", B=B, Sq=S, Skv=S, sched=sched,
                                     single=single)))
            out.append((f"D{D} fwd window+sink B1 S1500 {tm}",
                        dict(m=m, kind="fwd", B=1, Sq=1500, Skv=1500, sched="compact",
                             single=single, window=512, sink=4)))
            out.append((f"D{D} fwd q_offset-100 B1 S64 Skv300 {tm}",
                        dict(m=m, kind="fwd", B=1, Sq=64, Skv=300, sched="compact",
                             single=single, q_offset=-100)))
            for sched in ("compact", "dense"):
                out.append((f"D{D} varlen {sched} B{Bt} S{St} {tm}",
                            dict(m=m, kind="varlen", B=Bt, Sq=St, Skv=St, sched=sched,
                                 single=single)))
            for ks in (2, 3):
                out.append((f"D{D} split{ks} B1 S1536 {tm}",
                            dict(m=m, kind="split", B=1, Sq=1536, Skv=1536, ks=ks,
                                 single=single)))
            for Skv, w in m["corner"]:
                out.append((f"D{D} corner Skv{Skv} window{w} {tm}",
                            dict(m=m, kind="split", B=1, Sq=CORNER_ROWS, Skv=Skv, ks=None,
                                 single=single, window=w, q_offset=Skv - CORNER_ROWS)))
            out.append((f"D{D} split varlen 2 B{Bt} S{St} {tm}",
                        dict(m=m, kind="split_varlen", B=Bt, Sq=St, Skv=St, ks=2,
                             single=single)))
    for m in (SL, G3):
        D, (Bt, St) = m["D"], m["train"]
        shapes = [(Bt, St, {}), (1, 1500, {}), (1, 300, dict(q_offset=-100)), (2, 333, {})]
        if D == 256:
            shapes += [(Bt, St, dict(window=512)), (1, 700, dict(window=512))]
        for B, S, extra in shapes:
            for kind in ("fused", "dkv", "dq"):
                out.append((f"D{D} bwd {kind} compact B{B} S{S} {extra}",
                            dict(m=m, kind=f"bwd_{kind}", B=B, Sq=S, Skv=S, sched="compact",
                                 single=None, **extra)))
        for sched in ("compact", "dense"):
            for kind in ("fused", "dkv", "dq"):
                out.append((f"D{D} bwd {kind} varlen {sched} B{Bt} S{St}",
                            dict(m=m, kind=f"bwd_{kind}", B=Bt, Sq=St, Skv=St, sched=sched,
                                 single=None, varlen=True)))
            if sched == "dense":
                for kind in ("fused", "dkv", "dq"):
                    out.append((f"D{D} bwd {kind} dense B{Bt} S{St}",
                                dict(m=m, kind=f"bwd_{kind}", B=Bt, Sq=St, Skv=St,
                                     sched=sched, single=None)))
    for shape, (B, Sq, Skv, H, causal) in HD64_SHAPES.items():
        for mode in ("compact", "SEG", "DENSE"):
            for kind in ("fused", "dkv"):
                out.append((f"D64 bwd {kind} {mode} {shape}",
                            dict(m=W64, kind=f"bwd_{kind}", B=B, Sq=Sq, Skv=Skv, hq=H, hkv=H,
                                 causal=causal, single=None, varlen=mode == "SEG",
                                 sched="dense" if mode == "DENSE" else "compact")))
    return out


def run_case(torch, a, reps: int, flush=None, detail: bool = False) -> dict:
    """Launch the case ``reps`` times (``flush()`` before each); count the
    launches whose outputs are not bitwise the first's (on the device,
    without a sync per launch; with ``detail``, after each launch, and the
    first three differing launches are described). The fused backward's dQ
    (f32 sums in no fixed order) is not compared bitwise: at head_dim 64 its
    largest distance from the first launch's, relative to the first's
    largest value, is reported (``dq_rel``)."""
    from repro_torch.core.masks import MaskSpec
    from repro_torch.data.pipeline import DataConfig, SyntheticVarlenLM
    from repro_torch.kernels import flash_bwd as bwd
    from repro_torch.kernels import flash_fwd as fwd
    from repro_torch.kernels import ops

    m, dev = a["m"], torch.device("cuda", 0)
    D, hq, hkv = m["D"], a.get("hq", m["hq"]), a.get("hkv", m["hkv"])
    gen = torch.Generator(device=dev).manual_seed(7)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    B, Sq, Skv = a["B"], a["Sq"], a["Skv"]
    q = ops._prep(randn(B, Sq, hq, D), 1 / math.sqrt(D))
    k, v = randn(B, Skv, hkv, D), randn(B, Skv, hkv, D)
    spec = MaskSpec(causal=a.get("causal", True), window=a.get("window"),
                    sink=a.get("sink", 0), q_offset=a.get("q_offset", 0))
    kw = dict(block_q=ops.BLOCK_Q, block_kv=ops.BLOCK_KV, single_tile=a["single"])
    seg = ()
    if a["kind"] in ("varlen", "split_varlen") or a.get("varlen"):
        seg = tuple(torch.from_numpy(SyntheticVarlenLM(DataConfig(
            B, S, m["vocab"], seed=0, source="packed")).batch(0)["segment_ids"]).to(dev)
            for S in (Sq, Skv))
    if a["kind"] == "fwd":
        def call():
            return fwd.flash_fwd(q, k, v, spec, schedule=a["sched"], **kw)
    elif a["kind"] == "varlen":
        def call():
            return fwd.flash_fwd_varlen(q, k, v, spec, *seg, schedule=a["sched"], **kw)
    elif a["kind"].startswith("bwd_"):
        do = randn(B, Sq, hq, D)
        o, lse = fwd.flash_fwd(q, k, v, spec, **kw)
        delta = bwd.flash_bwd_delta(o, do)
        sfx = "_varlen" if seg else ""
        wrapper = getattr(bwd, f"flash_{a['kind']}{sfx}")
        tiles = dict(block_q=ops.BLOCK_Q, block_kv=ops.BLOCK_KV)

        def call():
            got = wrapper(q, k, v, do, lse, delta, spec, *seg, schedule=a["sched"], **tiles)
            return got if isinstance(got, tuple) else (got,)
    else:
        ks = a["ks"] or ops.resolve_kv_splits(None, (B, Sq, hq, D), (B, Skv, hkv, D))
        wrapper = fwd.flash_fwd_splitkv_varlen if seg else fwd.flash_fwd_splitkv

        def call():
            return tuple(wrapper(q, k, v, spec, *seg, kv_splits=ks, **kw))
    ref = call()
    torch.cuda.synchronize()
    # The fused backward's dq: compared within DQ_REL_TOL (at 64), not bitwise.
    loose = 1 if a["kind"] == "bwd_fused" else 0
    dq_worst = torch.zeros((), dtype=torch.float32, device=dev)
    bad = torch.zeros(reps, dtype=torch.bool, device=dev)
    diffs = []
    for r in range(reps):
        if flush is not None:
            flush()
        got = call()
        if loose:
            dq_worst = torch.maximum(dq_worst, (got[0] - ref[0]).abs().max())
        for x, y in zip(got[loose:], ref[loose:]):
            bad[r] |= torch.ne(x.nan_to_num(), y.nan_to_num()).any()
        if detail and len(diffs) < 3 and bool(bad[r].item()):
            diffs.append({"launch": r, "outputs": [
                where(torch, i, x, y) for i, (x, y) in enumerate(zip(got[loose:], ref[loose:]))
                if not torch.equal(x.nan_to_num(), y.nan_to_num())]})
    torch.cuda.synchronize()
    out = {"launches": reps, "differed": int(bad.sum().item()),
           "finite": bool(torch.isfinite(ref[0]).all().item())}
    if loose and D == 64:
        rel = dq_worst.item() / max(ref[0].abs().max().item(), 1e-6)
        out.update(dq_rel=rel, differed=out["differed"] + reps * (not rel <= DQ_REL_TOL))
    return {**out, "diffs": diffs} if diffs else out


def where(torch, i: int, x, y) -> dict:
    """Where two outputs differ: the output's index and shape, how many
    elements differ, by how much at most, and (up to 8 of) the distinct
    indices of the differing elements along each dimension."""
    ne = torch.ne(x.nan_to_num(), y.nan_to_num())
    idx = ne.nonzero()
    return {"output": i, "shape": list(x.shape), "n": int(idx.shape[0]),
            "max_abs": float((x.float() - y.float()).abs().nan_to_num().max().item()),
            "at": [sorted(set(idx[:, d].tolist()))[:8] for d in range(idx.shape[1])]}


def child(start: int, reps: int, only: str | None, flush: bool, detail: bool) -> None:
    import time

    import torch

    from repro_torch.kernels import _build

    _build.build(["flash_fwd", "flash_bwd"])
    scratch = torch.empty(96 * 2**20, dtype=torch.uint8, device="cuda") if flush else None
    for i, (name, a) in enumerate(cases()):
        if i < start or (only and only not in name):
            continue
        print(json.dumps({"start": i, "name": name}), flush=True)
        t0 = time.perf_counter()
        try:
            res = run_case(torch, a, reps, None if scratch is None else scratch.zero_, detail)
        except Exception as e:  # noqa: BLE001 - the fault is the result
            print(json.dumps({"case": i, "name": name, "fault": f"{type(e).__name__}: {e}"}),
                  flush=True)
            sys.exit(3)
        print(json.dumps({"case": i, "name": name, **res,
                          "s": round(time.perf_counter() - t0, 1)}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=500)
    ap.add_argument("--only", default=None)
    ap.add_argument("--flush", action="store_true")
    ap.add_argument("--detail", action="store_true",
                    help="sync after each launch and describe the first differing ones")
    ap.add_argument("--child", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        child(args.child, args.reps, args.only, args.flush, args.detail)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"nvidia-smi: {smi.stdout.strip()}", flush=True)
    n, start, faults, differed = len(cases()), 0, [], []
    while start < n:
        cmd = [sys.executable, __file__, "--child", str(start), "--reps", str(args.reps)]
        if args.only:
            cmd += ["--only", args.only]
        cmd += ["--flush"] * args.flush + ["--detail"] * args.detail
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True, cwd=ROOT,
                                env={**os.environ, "PYTHONUNBUFFERED": "1"})
        last = None
        for line in proc.stdout:
            line = line.strip()
            if not line.startswith("{"):
                continue
            rec = json.loads(line)
            if "start" in rec:
                last = rec["start"]
                continue
            print(line, flush=True)
            if rec.get("fault"):
                faults.append(rec["name"])
            elif rec.get("differed"):
                differed.append(rec["name"])
        rc = proc.wait()
        if rc == 0:
            break
        if last is None:
            sys.exit(f"the child failed before its first case (rc {rc})")
        if not faults or faults[-1] != cases()[last][0]:
            print(json.dumps({"case": last, "name": cases()[last][0], "fault": f"rc {rc}"}),
                  flush=True)
            faults.append(cases()[last][0])
        start = last + 1
    print(json.dumps({"faults": faults, "differed": differed}), flush=True)
    sys.exit(1 if faults or differed else 0)


if __name__ == "__main__":
    main()
