#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero; there is no CPU fallback):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc
     for sm_90a, all sources at once, and print nvcc's -Xptxas -v report;
  3. kernels: hold each kernel against its plain PyTorch version on the
     card in bf16 at qwen3-8b widths, then time kernel, plain version,
     the one PyTorch call that computes the same function (a yardstick the
     port never calls) and the roofline bound at the serving path's shapes;
  4. the serving slice: qwen3-8b at full width (36 layers, bf16, random
     weights from a seed) serves 6 requests through the port's
     ServingEngine; every prefill and decode must go through the kernels
     (launch counts > 0, plain versions 0), and a prefill and a decode step
     through the dense reference must give the same last-position logits;
  5. the device busy share of a decode tick, from torch.profiler.
The last two lines are the kernels' JSON record and the result line.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3 bandwidth
HQ, HKV, HD = 32, 8, 128  # qwen3-8b attention widths
FWD_TOL = dict(o=2e-2, lse=1e-3)  # bf16 outputs; f32 lse
DEC_TOL = dict(o=2e-2, lse=1e-3)
PROMPT_LENS = (7, 100, 700, 1500, 33, 260)
MAX_NEW = 16
CACHE = 2048
SPIN_CYCLES = 1_000_000  # about 0.5 ms at the H100's clock
# Logits of flash_cuda against the dense reference at full depth (bf16):
# the first chip run read cosine 0.999744 and max|diff| 0.024 x max|logit|.
LOGIT_COS = 0.999
LOGIT_REL = 0.05
PROFILED_TICKS = 8


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def time_ms(torch, fn, iters: int, flush) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, each bracketed by its
    own CUDA events after an L2 flush (the serving path finds K/V cold).
    Before each start event the card spins for about half a millisecond, so
    the host has enqueued the call before the event runs and the host's
    dispatch time stays out of the measurement."""
    fn()
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        flush()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def max_err(torch, a, b) -> float:
    fin = torch.isfinite(b)
    if not torch.equal(torch.isfinite(a), fin):
        return float("inf")
    return (a.float()[fin] - b.float()[fin]).abs().max().item() if fin.any() else 0.0


def kernel_phase(torch, dev, flush):
    import torch.nn.functional as F

    from repro_torch.core.masks import MaskSpec
    from repro_torch.kernels import flash_decode as dec
    from repro_torch.kernels import flash_fwd as fwd
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import attention_reference

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    spec = MaskSpec(causal=True)
    bq, bk = ops.BLOCK_Q, ops.BLOCK_KV
    scale = 1.0 / math.sqrt(HD)

    def fwd_inputs(B, S):
        return ops._prep(randn(B, S, HQ, HD), scale), randn(B, S, HKV, HD), randn(B, S, HKV, HD)

    fwd_err = 0.0
    for B in (1, 4):
        for S in (64, 700, 2048):
            q, k, v = fwd_inputs(B, S)
            o, lse = fwd.flash_fwd(q, k, v, spec, block_q=bq, block_kv=bk)
            torch.cuda.synchronize()
            o_p, lse_p = fwd.flash_fwd_plain(q, k, v, spec, block_q=bq, block_kv=bk)
            eo, el = max_err(torch, o, o_p), max_err(torch, lse, lse_p)
            log(f"flash_fwd B={B} S={S} causal Hq={HQ} Hkv={HKV} D={HD}: "
                f"max|o-plain|={eo:.3e} (tol {FWD_TOL['o']}), "
                f"max|lse-plain|={el:.3e} (tol {FWD_TOL['lse']})")
            if not (eo <= FWD_TOL["o"] and el <= FWD_TOL["lse"]):
                fail(f"flash_fwd disagrees with its plain version at B={B} S={S}")
            fwd_err = max(fwd_err, eo)

    # Decode: B=4 slots of a 2048 cache, ragged lengths including 1 and 0.
    B, S = 4, CACHE
    G = HQ // HKV
    qd = ops._prep(randn(B, 1, HQ, HD), scale)
    kc, vc = randn(B, S, HKV, HD), randn(B, S, HKV, HD)
    lens = torch.tensor([1, 0, 1337, 2048], dtype=torch.int32, device=dev)
    qh = qd.reshape(B * HKV, G, HD).contiguous()
    o_parts, lse_parts = dec.flash_decode(qh, kc, vc, lens, num_splits=8)
    torch.cuda.synchronize()
    o_pp, lse_pp = dec.flash_decode_plain(qh, kc, vc, lens, num_splits=8)
    eo, el = max_err(torch, o_parts, o_pp), max_err(torch, lse_parts, lse_pp)
    o_m, lse_m = ops.flash_decode(qd, kc, vc, lens, scale=1.0)
    log(f"flash_decode B={B} S={S} lengths={lens.tolist()} splits=8 G={G}: "
        f"partials max|o-plain|={eo:.3e} (tol {DEC_TOL['o']}), "
        f"max|lse-plain|={el:.3e} (tol {DEC_TOL['lse']})")
    if not (eo <= DEC_TOL["o"] and el <= DEC_TOL["lse"]):
        fail("flash_decode disagrees with its plain version")
    if not (o_m[1] == 0).all() or not torch.isneginf(lse_m[1]).all():
        fail("a length-0 row must give o = 0, lse = -inf after the merge")
    # The merged output of every live row against the dense oracle, the query
    # at position L - 1 (the split merge, reshape and cast run on the card).
    em = el_m = 0.0
    for b, L in enumerate(lens.tolist()):
        if L > 0:
            o_r, lse_r = attention_reference(qd[b:b + 1], kc[b:b + 1, :L], vc[b:b + 1, :L],
                                             MaskSpec(causal=True, q_offset=L - 1), scale=1.0)
            em = max(em, max_err(torch, o_m[b:b + 1], o_r))
            el_m = max(el_m, max_err(torch, lse_m[b:b + 1].flatten(), lse_r.flatten()))
    log(f"flash_decode merged vs dense reference: max|o-ref|={em:.3e} (tol {DEC_TOL['o']}), "
        f"max|lse-ref|={el_m:.3e} (tol {DEC_TOL['lse']})")
    if not (em <= DEC_TOL["o"] and el_m <= DEC_TOL["lse"]):
        fail("the merged flash_decode output disagrees with the dense reference")
    dec_err = max(eo, em)

    # Timing at the serving path's shapes: the longest prefill bucket, and a
    # decode tick with the slots' lengths mid-run.
    Bf, Sf = 1, 1536
    q, k, v = fwd_inputs(Bf, Sf)
    fwd_ms = time_ms(torch, lambda: fwd.flash_fwd(q, k, v, spec, block_q=bq, block_kv=bk),
                     20, flush)
    fwd_plain_ms = time_ms(
        torch, lambda: fwd.flash_fwd_plain(q, k, v, spec, block_q=bq, block_kv=bk), 3, flush)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    fwd_lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), 20, flush)
    pairs = Sf * (Sf + 1) // 2
    fwd_bound, fwd_by = bound(
        4 * HD * pairs * Bf * HQ,
        2 * Bf * Sf * HQ * HD * 2 + 2 * Bf * Sf * HKV * HD * 2 + Bf * HQ * Sf * 4,
    )

    lens_run = torch.tensor([n + 8 for n in PROMPT_LENS[:4]], dtype=torch.int32, device=dev)
    ns, _ = dec.decode_geometry(S, 8)
    dec_ms = time_ms(torch, lambda: dec.flash_decode(qh, kc, vc, lens_run, num_splits=8),
                     50, flush)
    dec_plain_ms = time_ms(
        torch, lambda: dec.flash_decode_plain(qh, kc, vc, lens_run, num_splits=8), 5, flush)
    kq = kc.transpose(1, 2).contiguous()
    vq = vc.transpose(1, 2).contiguous()
    qq = qd.transpose(1, 2).contiguous()
    mask = (torch.arange(S, device=dev)[None, :] < lens_run[:, None])[:, None, None, :]
    dec_lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qq, kq, vq, attn_mask=mask, enable_gqa=True), 50, flush)
    n_pos = int(lens_run.clamp(max=S).sum())
    dec_bound, dec_by = bound(
        4 * G * HD * n_pos * HKV,
        n_pos * HKV * HD * 2 * 2 + B * HQ * HD * 2 + B * HKV * ns * G * (HD + 1) * 4 + B * 4,
    )
    log(f"flash_fwd  B={Bf} S={Sf}: kernel {fwd_ms:.4f} ms, plain {fwd_plain_ms:.4f} ms, "
        f"sdpa {fwd_lib_ms:.4f} ms, bound {fwd_bound:.4f} ms ({fwd_by})")
    log(f"flash_decode B={B} S={S} lengths={lens_run.tolist()}: kernel {dec_ms:.4f} ms, "
        f"plain {dec_plain_ms:.4f} ms, sdpa {dec_lib_ms:.4f} ms, "
        f"bound {dec_bound:.4f} ms ({dec_by})")
    return {
        "flash_fwd": dict(max_abs_err=fwd_err, ms=fwd_ms, plain_ms=fwd_plain_ms,
                          bound_ms=fwd_bound, bound_by=fwd_by, library_ms=fwd_lib_ms),
        "flash_decode": dict(max_abs_err=dec_err, ms=dec_ms, plain_ms=dec_plain_ms,
                             bound_ms=dec_bound, bound_by=dec_by, library_ms=dec_lib_ms),
    }


def slice_phase(torch, dev):
    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.core.attention import AttentionConfig
    from repro_torch.kernels import flash_decode as dec
    from repro_torch.kernels import flash_fwd as fwd
    from repro_torch.models.lm import init_lm
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = registry.get("qwen3-8b")
    t0 = time.perf_counter()
    model = init_lm(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"qwen3-8b: {cfg.num_layers} layers, d_model {cfg.d_model}, {n_params / 1e9:.3f} B "
        f"params ({cfg.dtype}), initialised in {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in PROMPT_LENS]
    engine = ServingEngine(cfg, model, AttentionConfig(impl="flash_cuda"),
                           max_batch=4, cache_size=CACHE)
    for rid, prompt in enumerate(prompts):
        engine.submit(Request(rid=rid, prompt=prompt, max_new_tokens=MAX_NEW))

    fwd.flash_fwd.launches = fwd.flash_fwd_plain.calls = 0
    dec.flash_decode.launches = dec.flash_decode_plain.calls = 0
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    decode_ticks, admit_ticks = [], []  # seconds of each engine tick
    t0 = time.perf_counter()
    while (engine.queue or any(s is not None for s in engine.slots)) and engine.ticks < 1000:
        queued, t_tick = len(engine.queue), time.perf_counter()
        engine.tick()
        torch.cuda.synchronize()
        (admit_ticks if len(engine.queue) < queued else decode_ticks).append(
            time.perf_counter() - t_tick)
    dt = time.perf_counter() - t0
    finished = engine.finished
    counts = dict(flash_fwd=fwd.flash_fwd.launches, flash_decode=dec.flash_decode.launches,
                  flash_fwd_plain=fwd.flash_fwd_plain.calls,
                  flash_decode_plain=dec.flash_decode_plain.calls)
    tokens = sum(len(r.generated) for r in finished.values())
    log(f"served {len(finished)} requests (prompt lengths {list(PROMPT_LENS)}) in "
        f"{engine.ticks} ticks: {tokens} tokens in {dt:.3f} s = {tokens / dt:.1f} tokens/s; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    decode_ticks.sort()
    log(f"ticks with admission (prefill + decode): {len(admit_ticks)}, "
        f"{sum(admit_ticks):.3f} s in all; decode-only ticks: {len(decode_ticks)}, "
        f"median {decode_ticks[len(decode_ticks) // 2] * 1e3:.2f} ms "
        f"(min {decode_ticks[0] * 1e3:.2f} ms)")
    log(f"launches on the serving path: {counts}")
    if sorted(finished) != list(range(len(prompts))):
        fail(f"finished requests {sorted(finished)}")
    for rid, req in finished.items():
        if len(req.generated) != MAX_NEW + 1 or not all(
                0 <= t < cfg.vocab_size for t in req.generated):
            fail(f"request {rid} generated {req.generated}")
    if counts["flash_fwd"] <= 0 or counts["flash_decode"] <= 0:
        fail("the serving path did not launch both kernels")
    if counts["flash_fwd_plain"] or counts["flash_decode_plain"]:
        fail("a plain version ran on the serving path")

    # The dense reference on the card gives the same last-position logits,
    # for a prefill and for one decode step from the same cache.
    ref_cfg, fl_cfg = AttentionConfig(impl="ref"), AttentionConfig(impl="flash_cuda")
    tokens_in = torch.tensor([prompts[2]], device=dev)
    h_ref, _, _ = model.prefill(tokens_in, ref_cfg, CACHE)
    h_fl, cache_fl, _ = model.prefill(tokens_in, fl_cfg, CACHE)
    l_ref = model.logits_from_hidden(h_ref)
    l_fl = model.logits_from_hidden(h_fl)
    compare_logits(torch, f"prefill of {len(prompts[2])} tokens", l_ref, l_fl)
    # Four rows share the prompt's cache (a prefix of a causal prefill's K/V
    # is the K/V of the shorter prompt); ragged lengths leave splits empty.
    cache_fl = [{"kv": {n: t.expand(4, -1, -1, -1).clone() for n, t in c["kv"].items()}}
                for c in cache_fl]
    cache_ref = [{"kv": {n: t.clone() for n, t in c["kv"].items()}} for c in cache_fl]
    step_len = torch.tensor([len(prompts[2]), 1, 350, 64], dtype=torch.int32, device=dev)
    first = int(l_fl[..., :cfg.vocab_size].argmax())
    step_tok = torch.tensor([[first], [5], [17], [99]], device=dev)
    d_ref, _ = model.decode_step(step_tok, cache_ref, step_len, ref_cfg)
    d_fl, _ = model.decode_step(step_tok, cache_fl, step_len, fl_cfg)
    compare_logits(torch, f"decode step, B=4, lengths {step_len.tolist()}", d_ref, d_fl)
    del cache_fl, cache_ref
    return counts, decode_ticks[len(decode_ticks) // 2], cfg, model


def compare_logits(torch, what, l_ref, l_fl) -> None:
    """Fail unless the flash_cuda logits match the dense reference's row by
    row: cosine >= LOGIT_COS and max|diff| <= LOGIT_REL x max|logit|."""
    l_ref = l_ref.float().reshape(l_ref.shape[0], -1)
    l_fl = l_fl.float().reshape(l_fl.shape[0], -1)
    diff = (l_ref - l_fl).abs().max().item()
    top = l_ref.abs().max().item()
    cos = torch.nn.functional.cosine_similarity(l_ref, l_fl, dim=1).min().item()
    same = bool((l_ref.argmax(dim=1) == l_fl.argmax(dim=1)).all())
    log(f"{what}, ref vs flash_cuda last-position logits: max|diff|={diff:.4f} "
        f"(max|logit|={top:.3f}, limit {LOGIT_REL * top:.4f}), min cosine {cos:.6f} "
        f"(limit {LOGIT_COS}), same argmax {same}")
    if not (torch.isfinite(l_fl).all() and cos >= LOGIT_COS and diff <= LOGIT_REL * top):
        fail(f"{what}: flash_cuda logits disagree with the dense reference")


def busy_share_phase(torch, cfg, model, median_tick_s: float) -> None:
    """Device busy share of a decode tick: a fresh engine admits four short
    requests, then a few decode-only ticks run under torch.profiler. The
    union of the device-side events is the busy time; it is divided by the
    profiled ticks' wall time and by the slice phase's unprofiled median."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.attention import AttentionConfig
    from repro_torch.serving.engine import Request, ServingEngine

    rng = np.random.default_rng(1)
    engine = ServingEngine(cfg, model, AttentionConfig(impl="flash_cuda"),
                           max_batch=4, cache_size=CACHE)
    for rid, n in enumerate((7, 100, 33, 260)):
        engine.submit(Request(rid=rid, prompt=rng.integers(1, cfg.vocab_size, n).tolist(),
                              max_new_tokens=MAX_NEW))
    for _ in range(3):  # admission, then two warm decode ticks
        engine.tick()
    torch.cuda.synchronize()
    walls = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_TICKS):
            t0 = time.perf_counter()
            engine.tick()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        log("decode-tick device busy share: not measured (the profiler recorded no "
            "device events)")
        return
    busy_us, cur_s, cur_e, by_name = 0.0, spans[0][0], spans[0][1], {}
    for s, e, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
        if s > cur_e:
            busy_us += cur_e - cur_s
            cur_s = s
        cur_e = max(cur_e, e)
    busy_us += cur_e - cur_s
    busy_ms = busy_us / 1e3 / PROFILED_TICKS
    wall_ms = sum(walls) / PROFILED_TICKS * 1e3
    log(f"decode tick under torch.profiler ({PROFILED_TICKS} ticks, B=4): "
        f"{len(spans) / PROFILED_TICKS:.0f} device events per tick, device busy "
        f"{busy_ms:.3f} ms per tick; wall {wall_ms:.3f} ms per profiled tick -> busy share "
        f"{busy_ms / wall_ms:.4f}; against the unprofiled median tick "
        f"{median_tick_s * 1e3:.2f} ms -> busy share {busy_ms / (median_tick_s * 1e3):.4f}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    for name, us in top:
        log(f"  device {us / 1e3 / PROFILED_TICKS:8.3f} ms/tick "
            f"({us / 1e3 / PROFILED_TICKS / busy_ms:6.1%}): {name[:90]}")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py runs on an NVIDIA GPU")
    try:
        from repro_torch.kernels import _build
    except ImportError as e:
        fail(f"the port is not next to this script ({e})")
    dev = torch.device("cuda", 0)
    smi = smi_line()
    name = torch.cuda.get_device_name(0)
    log(f"nvidia-smi: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {name}")

    t0 = time.perf_counter()
    secs = _build.build(["flash_fwd", "flash_decode"])
    log(f"built {sorted(secs)} in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in secs.items())})")
    for src in ("flash_fwd", "flash_decode"):
        log(f"ptxas report of csrc/{src}.cu:\n{_build.report_path(src).read_text()}")

    scratch = torch.empty(96 * 2**20, dtype=torch.uint8, device=dev)  # > 50 MB L2
    results = kernel_phase(torch, dev, scratch.zero_)
    del scratch
    counts, median_tick_s, cfg, model = slice_phase(torch, dev)
    busy_share_phase(torch, cfg, model, median_tick_s)

    replaces = {"flash_fwd": "src/repro/kernels/flash_fwd.py:354",
                "flash_decode": "src/repro/kernels/flash_decode.py:77"}
    kernels = [
        {"name": k, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{k}.cu",
         "replaces": replaces[k], "launches": counts[k], **results[k]}
        for k in ("flash_fwd", "flash_decode")
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
