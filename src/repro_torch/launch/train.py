"""Trainer entry point of the port: synthetic data -> train step -> log line.

The counterpart of ``repro/launch/train.py`` without what waits for later
slices (ROADMAP.md, modules to port): checkpointing and restarts, fault
injection, a mesh, packed data and telemetry. ``--device`` is the one flag
the JAX CLI lacks, as in the serving CLI.

Usage:
  python -m repro_torch.launch.train --arch qwen3-8b --reduce --device cpu --steps 4
  python -m repro_torch.launch.train --preset gpt-20m --device cpu --steps 2

``--device cuda`` (the default) needs a card and raises without one; the
CUDA kernels take bfloat16 at head_dim 128, so on the card train a
full-width config (``--reduce`` and the presets are float32 at head_dim 16
or 64, which the plain CPU path runs).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import IMPLS, AttentionConfig
from repro_torch.data.pipeline import DataConfig, make_source
from repro_torch.launch.steps import build_train_step
from repro_torch.models.lm import init_lm
from repro_torch.training.optimizer import AdamWConfig, init_opt_state

PRESETS: Dict[str, ModelConfig] = {
    # GPT-style models small enough to train on a CPU (paper Table 1 ladder).
    "gpt-20m": ModelConfig(
        name="gpt-20m", family="dense", num_layers=4, d_model=256,
        num_heads=4, num_kv_heads=4, head_dim=64, d_ff=1024,
        vocab_size=8192, vocab_pad_to=256, dtype="float32", remat=False,
    ),
    "gpt-100m": ModelConfig(
        name="gpt-100m", family="dense", num_layers=12, d_model=768,
        num_heads=12, num_kv_heads=12, head_dim=64, d_ff=3072,
        vocab_size=32768, vocab_pad_to=256, dtype="float32", remat=False,
    ),
}


@dataclasses.dataclass
class TrainLoopConfig:
    steps: int = 100
    seq_len: int = 512
    batch_size: int = 8
    microbatches: int = 1
    attn_impl: str = "flash_cuda"
    log_every: int = 10
    seed: int = 0
    device: str = "cuda"


def resolve_model(arch: Optional[str], preset: Optional[str], reduce: bool) -> ModelConfig:
    if preset:
        return PRESETS[preset]
    if not arch:
        raise ValueError("--arch or --preset required")
    cfg = registry.get(arch)
    return registry.reduce_config(cfg) if reduce else cfg


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(cfg: ModelConfig, loop: TrainLoopConfig, opt_cfg: Optional[AdamWConfig] = None):
    """Run the loop; returns (model, opt_state, history). ``history`` holds
    per-step ``loss``, ``grad_norm``, ``lr`` and ``step_time`` (seconds of
    the step, data excluded, ending in a device synchronise)."""
    opt_cfg = opt_cfg or AdamWConfig(total_steps=loop.steps)
    attn_cfg = AttentionConfig(impl=loop.attn_impl)
    data = make_source(DataConfig(batch_size=loop.batch_size, seq_len=loop.seq_len,
                                  vocab_size=cfg.vocab_size, seed=loop.seed))
    model = init_lm(cfg, loop.seed, loop.device)
    params = dict(model.named_parameters())
    opt_state = init_opt_state(params)
    step_fn = build_train_step(cfg, attn_cfg, opt_cfg, microbatches=loop.microbatches)
    n_params = sum(p.numel() for p in params.values())
    print(f"[train] {cfg.name}: {n_params / 1e6:.1f}M params on {model.device}, "
          f"{loop.steps} steps x {loop.batch_size}x{loop.seq_len} tokens, "
          f"attn={loop.attn_impl}", flush=True)
    history = {"loss": [], "grad_norm": [], "lr": [], "step_time": []}
    tokens = loop.batch_size * loop.seq_len
    for step in range(loop.steps):
        inputs, targets = data.batch(step)
        batch = {"inputs": torch.from_numpy(inputs).to(model.device),
                 "targets": torch.from_numpy(targets).to(model.device)}
        _sync(model.device)
        t0 = time.perf_counter()
        opt_state, metrics = step_fn(model, opt_state, batch)
        _sync(model.device)
        dt = time.perf_counter() - t0
        for key in ("loss", "grad_norm", "lr"):
            history[key].append(metrics[key])
        history["step_time"].append(dt)
        if step % loop.log_every == 0 or step == loop.steps - 1:
            print(f"[train] step {step:5d} loss {metrics['loss']:8.4f} "
                  f"gnorm {metrics['grad_norm']:7.3f} lr {metrics['lr']:.2e} "
                  f"{tokens / dt:8.0f} tok/s", flush=True)
    return model, opt_state, history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="registry architecture id")
    ap.add_argument("--preset", default=None, choices=sorted(PRESETS))
    ap.add_argument("--reduce", action="store_true", help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--attn", default="flash_cuda", choices=IMPLS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)

    cfg = resolve_model(args.arch, args.preset, args.reduce)
    loop = TrainLoopConfig(
        steps=args.steps, seq_len=args.seq, batch_size=args.batch,
        microbatches=args.microbatches, attn_impl=args.attn, log_every=args.log_every,
        seed=args.seed, device=args.device,
    )
    _, _, history = train(cfg, loop)
    loss = history["loss"]
    print(json.dumps({
        "first5_loss": round(float(np.mean(loss[:5])), 4),
        "last5_loss": round(float(np.mean(loss[-5:])), 4),
        "median_step_s": round(float(np.median(history["step_time"])), 4),
        "tokens_per_s": round(args.batch * args.seq / float(np.median(history["step_time"])), 1),
    }))


if __name__ == "__main__":
    main()
