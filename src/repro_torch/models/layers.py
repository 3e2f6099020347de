"""Shared layers: RMSNorm, rotary embedding, the SwiGLU MLP, token embedding.

The counterpart of ``repro/models/layers.py``. Parameters live in small
``nn.Module``s whose names match the JAX parameter tree's leaves, weights
keep the JAX (in, out) layout, and the math is plain functions on tensors
that round where the JAX functions round.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def new_param(shape, device, dtype) -> nn.Parameter:
    """A serving parameter: uninitialized, no gradient."""
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype), requires_grad=False)


def normal_(p: torch.Tensor, std: float, gen: torch.Generator) -> None:
    p.normal_(0.0, std, generator=gen)


# --------------------------------------------------------------------- norms


class Norm(nn.Module):
    """RMSNorm over d_model (the JAX ``apply_norm`` with kind 'rmsnorm')."""

    def __init__(self, cfg, device, dtype):
        super().__init__()
        self.eps = cfg.norm_eps
        self.scale = new_param((cfg.d_model,), device, dtype)

    def init_(self, gen):
        self.scale.fill_(1.0)

    def forward(self, x):
        return rms_norm_vec(x, self.scale, self.eps)


def rms_norm_vec(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm over the last axis (the model norms and qk-norm)."""
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------- rope


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split (NeoX-style) rotary embedding. x (B, S, H, D); positions
    (B, S) or (S,) absolute token positions."""
    D = x.shape[-1]
    half = D // 2
    freqs = torch.exp(
        -math.log(theta) * torch.arange(half, dtype=torch.float32, device=x.device) / half
    )
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs  # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ----------------------------------------------------------------------- mlp


class MLP(nn.Module):
    """SwiGLU: down(silu(x @ gate) * (x @ up))."""

    def __init__(self, cfg, device, dtype):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.std_in, self.std_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
        self.w_gate = new_param((d, f), device, dtype)
        self.w_up = new_param((d, f), device, dtype)
        self.w_down = new_param((f, d), device, dtype)

    def init_(self, gen):
        normal_(self.w_gate, self.std_in, gen)
        normal_(self.w_up, self.std_in, gen)
        normal_(self.w_down, self.std_out, gen)

    def forward(self, x):
        g = x @ self.w_gate
        u = x @ self.w_up
        h = F.silu(g.float()).to(x.dtype) * u
        return h @ self.w_down


# ----------------------------------------------------------------- embedding


class Embedding(nn.Module):
    """Token table (padded vocab) plus the untied unembedding."""

    def __init__(self, cfg, device, dtype):
        super().__init__()
        V, d = cfg.padded_vocab, cfg.d_model
        self.tie = cfg.tie_embeddings
        self.tokens = new_param((V, d), device, dtype)
        self.unembed = None if self.tie else new_param((d, V), device, dtype)
        self.std_unembed = 1.0 / math.sqrt(d)

    def init_(self, gen):
        normal_(self.tokens, 1.0, gen)
        if self.unembed is not None:
            normal_(self.unembed, self.std_unembed, gen)

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.tokens[tokens]

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        if self.tie:
            return x @ self.tokens.t()
        return x @ self.unembed
