"""Serving driver of the port: build a model with random weights from a seed
and run the fixed-slot engine over a synthetic stream of requests.

Usage:
  python -m repro_torch.launch.serve --arch qwen3-8b --reduce --device cpu
  python -m repro_torch.launch.serve --arch qwen3-8b --requests 6 --cache 2048

``--device cuda`` (the default) needs a card and raises without one; the
CUDA kernels take bfloat16 at head_dim 128, so on the card serve a
full-width config (``--reduce`` shrinks to float32 at head_dim 16, which
the plain CPU path serves).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core.attention import IMPLS, AttentionConfig
from repro_torch.models.lm import init_lm
from repro_torch.serving.engine import Request, ServingEngine


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
    args = ap.parse_args(argv)

    cfg = registry.get(args.arch)
    if args.reduce:
        cfg = registry.reduce_config(cfg)
    model = init_lm(cfg, args.seed, args.device)
    engine = ServingEngine(cfg, model, AttentionConfig(impl=args.attn),
                           max_batch=args.max_batch, cache_size=args.cache)
    rng = np.random.default_rng(args.seed)
    requests = [
        Request(rid=rid,
                prompt=rng.integers(1, min(cfg.vocab_size, 1000),
                                    size=int(rng.integers(2, 12))).tolist(),
                max_new_tokens=args.max_new)
        for rid in range(args.requests)
    ]
    t0 = time.perf_counter()
    for req in requests:
        engine.submit(req)
    finished = engine.run(max_ticks=10_000)
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    dt = time.perf_counter() - t0
    toks = sum(len(r.generated) for r in finished.values())
    print(json.dumps({
        "arch": cfg.name, "device": str(model.device), "attn": args.attn,
        "requests": len(finished), "ticks": engine.ticks,
        "generated_tokens": toks, "tok_per_s": round(toks / dt, 1),
    }))
    for rid in sorted(finished)[:4]:
        print(f"  req {rid}: {finished[rid].generated}")


if __name__ == "__main__":
    main()
