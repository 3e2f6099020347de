"""AdamW with f32 master weights and moments.

The counterpart of ``repro/training/optimizer.py``. Parameters are in the
compute dtype (bf16 for the registry's models); the optimizer keeps f32
master copies, mu and nu, keyed by the model's parameter names. The JAX
version returns new parameters; this one writes the rounded masters into
the parameters in place, and updates the state in place, so a step holds
no second copy of either (16 bytes a parameter in all: bf16 parameter and
gradient, f32 master, mu and nu).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


@dataclasses.dataclass
class OptState:
    step: int                       # updates taken (skipped ones included)
    master: Dict[str, torch.Tensor]  # f32 master parameters
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def init_opt_state(params: Dict[str, torch.Tensor]) -> OptState:
    return OptState(
        step=0,
        master={n: p.detach().float().clone() for n, p in params.items()},
        mu={n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()},
        nu={n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()},
    )


def lr_schedule(cfg: AdamWConfig, step: int) -> float:
    """Linear warmup + cosine decay to min_lr_ratio."""
    warm = min(1.0, (step + 1) / max(cfg.warmup_steps, 1))
    t = min(max((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0),
            1.0)
    cos = 0.5 * (1.0 + math.cos(math.pi * t))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32."""
    sq = [torch.linalg.vector_norm(t, dtype=torch.float32) ** 2 for t in tensors]
    return torch.stack(sq).sum().sqrt()


def _no_decay(name: str) -> bool:
    """Parameters without weight decay, by name: the JAX rule (``_no_decay``,
    ``optimizer.py:62``) on the port's dotted names. The JAX rule's
    ``'d'`` matches a tree key named ``d`` (Mamba's D), here the last
    component of the name."""
    p = name.lower()
    return (any(t in p for t in ("norm", "bias", "scale", "a_log", "dt_bias", "meta"))
            or p.rsplit(".", 1)[-1] == "d")


@torch.no_grad()
def apply_updates(
    cfg: AdamWConfig, state: OptState, params: Dict[str, torch.Tensor],
    grads: Dict[str, torch.Tensor], skip_update: bool = False,
) -> Tuple[OptState, dict]:
    """One AdamW step from ``grads`` (compute dtype or f32): updates
    ``state`` and ``params`` in place and returns (state, metrics).

    When the gradient norm is not finite, or ``skip_update`` is set, the
    step changes nothing but the step counter (the JAX rule)."""
    gnorm = global_norm(grads.values())
    gnorm_f = float(gnorm)
    skip = skip_update or not math.isfinite(gnorm_f)
    lr = lr_schedule(cfg, state.step)
    step1 = state.step + 1
    if not skip:
        clip = min(1.0, cfg.grad_clip / (gnorm_f + 1e-9))
        bc1 = 1 - cfg.b1 ** step1
        bc2 = 1 - cfg.b2 ** step1
        for name, g in grads.items():
            m, mu, nu = state.master[name], state.mu[name], state.nu[name]
            gf = g.float() * clip
            mu.mul_(cfg.b1).add_(gf, alpha=1 - cfg.b1)
            nu.mul_(cfg.b2).addcmul_(gf, gf, value=1 - cfg.b2)
            upd = (mu / bc1).div_((nu / bc2).sqrt_().add_(cfg.eps))
            if cfg.weight_decay and not _no_decay(name):
                upd.add_(m, alpha=cfg.weight_decay)
            m.sub_(upd, alpha=lr)
            params[name].copy_(m)
    state.step = step1
    return state, {"grad_norm": gnorm_f, "lr": lr, "skipped": float(skip)}
