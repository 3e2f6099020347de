"""Serving driver of the port: build a model with random weights from a seed
and run a continuous-batching engine over a synthetic stream of requests.

Usage:
  python -m repro_torch.launch.serve --arch qwen3-8b --reduce --device cpu
  python -m repro_torch.launch.serve --arch qwen3-8b --reduce --device cpu --engine paged
  python -m repro_torch.launch.serve --arch qwen3-8b --requests 6 --cache 2048
  python -m repro_torch.launch.serve --arch qwen3-8b --engine paged \
      --num-pages 150 --page-size 16 --pages-per-seq 128
  python -m repro_torch.launch.serve --arch stablelm-12b [--engine paged]
  python -m repro_torch.launch.serve --arch granite-moe-1b-a400m [--engine paged]
  python -m repro_torch.launch.serve --arch qwen3-8b --reduce --device cpu --attn flash_torch
  python -m repro_torch.launch.serve --arch qwen3-8b --reduce --device cpu --engine paged \
      --arrival-rate 1.0 --trace-out trace.json --metrics-out metrics.json

``--attn`` takes ``flash_cuda`` (the default: the hand-written kernels),
``flash_torch`` (the blocked PyTorch prefill and the split decode of
``core/flash.py`` and ``core/decode.py``, on the CPU or the card: the
counterpart of the JAX CLI's default ``flash_xla``) or ``ref`` (dense
attention). The JAX CLI defaults to its XLA program because there the
Pallas kernels run interpreted off the TPU; here the kernels are the main
path on the card, so they are the default.

``--engine fixed`` (default) reserves a worst-case contiguous cache slot
per request; ``--engine paged`` serves from a shared page pool and decodes
through a block table (attention-only archs).

``--device cuda`` (the default) needs a card and raises without one. The
CUDA kernels serve bfloat16 at head_dim 64, 128, 160 and 256 (both decodes),
so on the card serve a full-width config, e.g. ``--arch gemma3-1b
[--engine paged]``, ``--arch stablelm-12b [--engine paged]`` (40 layers,
12.1 B parameters, 24.3 GB in bf16: one H100 holds it) or ``--arch
granite-moe-1b-a400m [--engine paged]`` (24 MoE layers of 32 experts, top
8; its experts are plain batched products, only attention runs the
kernels) (``--reduce`` shrinks to float32 at head_dim 16, which the plain
CPU path serves); a model they cannot take (float32 on the card) is
refused before anything reaches the card
(``core.attention.check_card_support``). Whisper (encoder-decoder) has no
engine here, as in the JAX package: the decoder-only LM refuses it.

Telemetry (``repro_torch.obs``), as in the JAX CLI: every run collects the
engine's metrics registry (the ``metrics`` block of the JSON summary, with
the kv-split knob counters of the default registry folded in; written to
``--metrics-out``); ``--trace-out PATH`` records each request's lifecycle
(submit -> queue_wait -> prefill -> decode -> retire, preempt/resume) and
the decode ticks as Chrome/Perfetto ``trace_event`` JSON. ``--arrival-rate
R`` submits the requests on a Poisson schedule of R requests per expected
tick, drawn as the JAX CLI draws it, in place of all at once.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core.attention import IMPLS, AttentionConfig, check_card_support
from repro_torch.models.lm import init_lm
from repro_torch.obs import MetricsRegistry, TraceRecorder, default_registry
from repro_torch.serving.engine import PagedServingEngine, Request, ServingEngine


def _drive_poisson(engine, requests, rate: float, seed: int, max_ticks: int) -> None:
    """Submit ``requests`` on a Poisson schedule (in engine ticks) while
    ticking; an idle engine fast-forwards to the next arrival (JAX
    ``serve.py:44``, the same draws from ``np.random.default_rng(seed)``)."""
    rng = np.random.default_rng(seed)
    arrivals = []
    tick = 0
    for req in requests:
        tick += int(rng.poisson(1.0 / rate))
        arrivals.append((tick, req))
    it = iter(arrivals)
    pending = next(it, None)
    while engine.ticks < max_ticks:
        while pending is not None and pending[0] <= engine.ticks:
            engine.submit(pending[1])
            pending = next(it, None)
        if not engine.queue and not any(s is not None for s in engine.slots):
            if pending is None:
                break
            engine.submit(pending[1])  # fast-forward to the next arrival
            pending = next(it, None)
            continue
        engine.tick()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduce", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--cache", type=int, default=256)
    ap.add_argument("--attn", choices=IMPLS, default="flash_cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--engine", choices=("fixed", "paged"), default="fixed")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="paged: pool size; default matches the fixed "
                         "engine's memory (max_batch * cache / page_size + 1)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--pages-per-seq", type=int, default=None,
                    help="paged: block-table width; default cache/page_size")
    ap.add_argument("--arrival-rate", type=float, default=None,
                    help="Poisson arrivals (requests per expected tick); "
                         "default submits every request upfront")
    ap.add_argument("--trace-out", default=None,
                    help="write the request-lifecycle Perfetto trace here")
    ap.add_argument("--metrics-out", default=None,
                    help="write the final metrics snapshot (JSON) here")
    args = ap.parse_args(argv)

    cfg = registry.get(args.arch)
    if args.reduce:
        cfg = registry.reduce_config(cfg)
    attn_cfg = AttentionConfig(impl=args.attn)
    check_card_support(cfg, attn_cfg, args.device, training=False,
                       paged=args.engine == "paged")
    model = init_lm(cfg, args.seed, args.device)
    obs_registry = MetricsRegistry()
    tracer = TraceRecorder(process=f"serve:{args.engine}") if args.trace_out else None
    if args.engine == "paged":
        num_pages = args.num_pages or (args.max_batch * args.cache // args.page_size + 1)
        n_max = args.pages_per_seq or max(1, args.cache // args.page_size)
        engine = PagedServingEngine(cfg, model, attn_cfg, max_batch=args.max_batch,
                                    num_pages=num_pages, page_size=args.page_size,
                                    pages_per_seq_max=n_max, registry=obs_registry,
                                    tracer=tracer)
    else:
        engine = ServingEngine(cfg, model, attn_cfg, max_batch=args.max_batch,
                               cache_size=args.cache, registry=obs_registry, tracer=tracer)
    rng = np.random.default_rng(args.seed)
    requests = [
        Request(rid=rid,
                prompt=rng.integers(1, min(cfg.vocab_size, 1000),
                                    size=int(rng.integers(2, 12))).tolist(),
                max_new_tokens=args.max_new)
        for rid in range(args.requests)
    ]
    t0 = time.perf_counter()
    if args.arrival_rate:
        _drive_poisson(engine, requests, args.arrival_rate, args.seed, max_ticks=10_000)
    else:
        for req in requests:
            engine.submit(req)
        engine.run(max_ticks=10_000)
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    dt = time.perf_counter() - t0
    finished = engine.finished
    toks = sum(len(r.generated) for r in finished.values())
    snap = engine.snapshot()
    # The kv-split knob counters live on the process-wide default registry
    # (they count inside the attention call); fold them in.
    snap.update(default_registry().snapshot())
    summary = {
        "arch": cfg.name, "device": str(model.device), "attn": args.attn,
        "engine": args.engine, "requests": len(finished), "ticks": engine.ticks,
        "generated_tokens": toks, "tok_per_s": round(toks / dt, 1),
        "decode_mfu": snap["decode/mfu"],
        "decode_tok_per_s": round(snap["decode/tokens_per_s"], 1),
    }
    if args.engine == "paged":
        summary.update(preemptions=engine.preemptions, kv_capacity=engine.kv_capacity(),
                       pool_used_pages=engine.pool.used_pages)
    summary["metrics"] = snap
    print(json.dumps(summary))
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(snap, f, indent=1, sort_keys=True)
        print(f"[serve] wrote metrics snapshot to {args.metrics_out}")
    if tracer is not None:
        tracer.save(args.trace_out)
        print(f"[serve] wrote Perfetto trace ({len(tracer.events)} events) to {args.trace_out}")
    for rid in sorted(finished)[:4]:
        print(f"  req {rid}: {finished[rid].generated}")


if __name__ == "__main__":
    main()
