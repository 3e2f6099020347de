"""Trainer entry point of the port: synthetic data -> train step -> log line.

The counterpart of ``repro/launch/train.py`` without what waits for later
slices (ROADMAP.md, modules to port): checkpointing and restarts, fault
injection and a mesh. ``--device`` and ``--dtype`` are the flags the JAX
CLI lacks. ``--packed`` trains on packed (varlen) rows: ragged
documents back to back, attention kept inside each, RoPE positions
restarting at each document.

Usage:
  python -m repro_torch.launch.train --preset gpt-20m --dtype bfloat16 --steps 4
  python -m repro_torch.launch.train --arch qwen3-8b --reduce --device cpu --steps 4
  python -m repro_torch.launch.train --preset gpt-20m --device cpu --steps 2
  python -m repro_torch.launch.train --arch qwen3-8b --reduce --device cpu --packed --steps 2
  python -m repro_torch.launch.train --arch gemma3-1b --steps 4
  python -m repro_torch.launch.train --arch stablelm-12b --steps 4
  python -m repro_torch.launch.train --arch granite-moe-1b-a400m --dtype bfloat16 --seq 2048 \
      --batch 2 --steps 8 --trace-out trace.json --metrics-out metrics.json
  python -m repro_torch.launch.train --preset gpt-20m --device cpu --attn flash_torch --steps 2

``--attn`` takes ``flash_cuda`` (the default: the hand-written kernels),
``flash_torch`` (the paper's algorithm as a blocked PyTorch loop, 512 x 512
tiles, on the CPU or the card: the counterpart of the JAX CLI's default
``flash_xla``) or ``ref`` (dense attention). The JAX CLI defaults to its
XLA program because there the Pallas kernels run interpreted off the TPU;
here the kernels are the main path on the card, so they are the default.

``--device cuda`` (the default) needs a card and raises without one. The
CUDA kernels take bfloat16 at head_dim 64, 128, 160 and 256: the presets
and the reduced configs are float32 (their CPU parity with the JAX package
holds in f32), so on the card train a preset with ``--dtype bfloat16``.
gemma3-1b (bfloat16, head_dim 256) trains at its published widths and
depth through the head_dim-256 forward, delta and fused backward kernels
(``attn_bwd="split"``: delta, dK/dV and dQ), and stablelm-12b (head_dim
160) through the head_dim-160 ones on a card that holds its 40 layers with
AdamW's state (about 194 GB; there is no depth flag, as in the JAX CLI:
``chip_smoke.py`` trains 8 of its layers through ``train``); both train
``--packed`` too, through the segment variants of those kernels.
granite-moe-1b-a400m (an MoE layer of 32 experts top 8 in each of its 24
layers, head_dim 64) trains at its published widths and depth through the
head_dim-64 kernels; its experts are batched products in PyTorch. A model
the kernels cannot take (float32) is refused before anything reaches the
card (``core.attention.check_card_support``).

Telemetry (``repro_torch.obs``), as in the JAX CLI: a metrics registry and
an MFU meter are always on (``train/{steps, tokens, model_flops,
compute_seconds, mfu, hfu, tokens_per_s, model_tflops_per_s, loss}``;
``history["registry"]``); ``--metrics-out`` writes the final snapshot with
the kv-split knob counters folded in, ``--trace-out`` each step's ``step``
span with its ``data`` and ``compute`` children as Perfetto JSON. The JAX
loop's ``train/stragglers``, ``checkpoints``, ``preemptions`` and
``restarts`` come with its fault-tolerance modules (ROADMAP.md queue 1,
item 4).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import IMPLS, AttentionConfig, check_card_support
from repro_torch.data.pipeline import DataConfig, make_source
from repro_torch.launch.steps import build_train_step
from repro_torch.models.lm import init_lm
from repro_torch.obs import MetricsRegistry, TraceRecorder, TrainEfficiency, default_registry
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
    # flash_cuda backward mode (AttentionConfig.bwd; None: fused); set
    # through the library only, as the JAX trainer has no flag for it.
    attn_bwd: Optional[str] = None
    log_every: int = 10
    seed: int = 0
    device: str = "cuda"
    packed: bool = False  # varlen packing: segment-masked attention
    # Telemetry: metrics always collect into ``registry`` (or a fresh one);
    # trace_out records step -> data/compute spans as Perfetto JSON.
    trace_out: Optional[str] = None
    metrics_out: Optional[str] = None
    registry: Optional[Any] = None


def resolve_model(arch: Optional[str], preset: Optional[str], reduce: bool,
                  dtype: Optional[str] = None) -> ModelConfig:
    """The config of ``--preset`` or ``--arch`` (``--reduce``: its smoke
    size), in ``dtype`` where given, else in its own dtype."""
    if preset:
        cfg = PRESETS[preset]
    elif not arch:
        raise ValueError("--arch or --preset required")
    else:
        cfg = registry.get(arch)
        cfg = registry.reduce_config(cfg) if reduce else cfg
    return dataclasses.replace(cfg, dtype=dtype) if dtype else cfg


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(cfg: ModelConfig, loop: TrainLoopConfig, opt_cfg: Optional[AdamWConfig] = None):
    """Run the loop; returns (model, opt_state, history). ``history`` holds
    per-step ``loss``, ``grad_norm``, ``lr`` and ``step_time`` (seconds of
    the step, data excluded, ending in a device synchronise), and the run's
    metrics ``registry``."""
    opt_cfg = opt_cfg or AdamWConfig(total_steps=loop.steps)
    attn_cfg = AttentionConfig(impl=loop.attn_impl, bwd=loop.attn_bwd)
    check_card_support(cfg, attn_cfg, loop.device, training=True, packed=loop.packed)
    obs = loop.registry if loop.registry is not None else MetricsRegistry()
    eff = TrainEfficiency(cfg, loop.batch_size, loop.seq_len, obs, device=loop.device)
    g_loss = obs.gauge("train/loss")
    tracer = TraceRecorder(process="train") if loop.trace_out else None
    data = make_source(DataConfig(batch_size=loop.batch_size, seq_len=loop.seq_len,
                                  vocab_size=cfg.vocab_size, seed=loop.seed,
                                  source="packed" if loop.packed else "synthetic"))
    model = init_lm(cfg, loop.seed, loop.device)
    params = dict(model.named_parameters())
    opt_state = init_opt_state(params)
    step_fn = build_train_step(cfg, attn_cfg, opt_cfg, microbatches=loop.microbatches)
    n_params = sum(p.numel() for p in params.values())
    print(f"[train] {cfg.name}: {n_params / 1e6:.1f}M params ({cfg.dtype}) on {model.device}, "
          f"{loop.steps} steps x {loop.batch_size}x{loop.seq_len} tokens, "
          f"attn={loop.attn_impl}{' packed' if loop.packed else ''}", flush=True)
    history = {"loss": [], "grad_norm": [], "lr": [], "step_time": [], "registry": obs}
    tokens = loop.batch_size * loop.seq_len
    for step in range(loop.steps):
        t_step0 = tracer.now_us() if tracer else 0.0
        t_data0 = time.perf_counter()
        out = data.batch(step)
        if not isinstance(out, dict):
            out = {"inputs": out[0], "targets": out[1]}
        batch = {k: torch.from_numpy(v).to(model.device) for k, v in out.items()}
        _sync(model.device)
        t0 = time.perf_counter()
        opt_state, metrics = step_fn(model, opt_state, batch)
        _sync(model.device)
        dt = time.perf_counter() - t0
        eff.step(dt)
        g_loss.set(metrics["loss"])
        if tracer:
            t_data = (t0 - t_data0) * 1e6
            tracer.complete("data", 0, t_step0, t_data)
            tracer.complete("compute", 0, t_step0 + t_data, dt * 1e6,
                            args={"loss": metrics["loss"], "step": step})
            tracer.complete("step", 0, t_step0, tracer.now_us() - t_step0, args={"step": step})
        for key in ("loss", "grad_norm", "lr"):
            history[key].append(metrics[key])
        history["step_time"].append(dt)
        if step % loop.log_every == 0 or step == loop.steps - 1:
            print(f"[train] step {step:5d} loss {metrics['loss']:8.4f} "
                  f"gnorm {metrics['grad_norm']:7.3f} lr {metrics['lr']:.2e} "
                  f"{tokens / dt:8.0f} tok/s mfu {obs.snapshot()['train/mfu']:.4f}", flush=True)
    if loop.metrics_out:
        snap = obs.snapshot()
        snap.update(default_registry().snapshot())  # the kv-split knob counters
        with open(loop.metrics_out, "w") as f:
            json.dump(snap, f, indent=1, sort_keys=True)
        print(f"[train] wrote metrics snapshot to {loop.metrics_out}")
    if tracer is not None:
        tracer.save(loop.trace_out)
        print(f"[train] wrote Perfetto trace ({len(tracer.events)} events) to {loop.trace_out}")
    return model, opt_state, history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="registry architecture id")
    ap.add_argument("--preset", default=None, choices=sorted(PRESETS))
    ap.add_argument("--reduce", action="store_true", help="use the reduced smoke config")
    ap.add_argument("--dtype", default=None, choices=("float32", "bfloat16"),
                    help="compute dtype (default: the config's own); the CUDA kernels take "
                         "bfloat16")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--attn", default="flash_cuda", choices=IMPLS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--packed", action="store_true",
                    help="varlen sequence packing (segment-masked attention)")
    ap.add_argument("--trace-out", default=None,
                    help="write step/data/compute spans as Perfetto trace_event JSON here")
    ap.add_argument("--metrics-out", default=None,
                    help="write the final metrics snapshot (JSON) here")
    args = ap.parse_args(argv)

    cfg = resolve_model(args.arch, args.preset, args.reduce, args.dtype)
    loop = TrainLoopConfig(
        steps=args.steps, seq_len=args.seq, batch_size=args.batch,
        microbatches=args.microbatches, attn_impl=args.attn, log_every=args.log_every,
        seed=args.seed, device=args.device, packed=args.packed,
        trace_out=args.trace_out, metrics_out=args.metrics_out,
    )
    _, _, history = train(cfg, loop)
    loss = history["loss"]
    print(json.dumps({
        "first5_loss": round(float(np.mean(loss[:5])), 4),
        "last5_loss": round(float(np.mean(loss[-5:])), 4),
        "median_step_s": round(float(np.median(history["step_time"])), 4),
        "tokens_per_s": round(args.batch * args.seq / float(np.median(history["step_time"])), 1),
        "mfu": history["registry"].snapshot()["train/mfu"],
    }))


if __name__ == "__main__":
    main()
