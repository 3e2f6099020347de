"""Shared layers: RMSNorm and LayerNorm, rotary embedding, the SwiGLU and
GELU MLPs, token embedding with learned positions, sinusoidal positions.

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
    """An uninitialized trainable parameter (the serving entry points run
    under ``torch.no_grad``, so serving records no autograd graph)."""
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype))


def normal_(p: torch.Tensor, std: float, gen: torch.Generator) -> None:
    p.normal_(0.0, std, generator=gen)


# --------------------------------------------------------------------- norms


class Norm(nn.Module):
    """The norm over d_model that ``cfg.norm`` names: RMSNorm, or LayerNorm
    with a bias (the JAX ``init_norm``/``apply_norm``, ``layers.py:24``/
    ``:31``), in f32 and cast back."""

    def __init__(self, cfg, device, dtype):
        super().__init__()
        self.eps = cfg.norm_eps
        self.kind = cfg.norm
        self.scale = new_param((cfg.d_model,), device, dtype)
        if cfg.norm == "layernorm":
            self.bias = new_param((cfg.d_model,), device, dtype)

    def init_(self, gen):
        self.scale.fill_(1.0)
        if self.kind == "layernorm":
            self.bias.zero_()

    def forward(self, x):
        if self.kind == "rmsnorm":
            return rms_norm_vec(x, self.scale, self.eps)
        return layer_norm(x, self.scale, self.bias, self.eps)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm over the last axis in f32: (x - mean) / sqrt(var + eps) *
    scale + bias, cast back to x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


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
    """``cfg.mlp``: SwiGLU, down(silu(x @ gate) * (x @ up)), or GELU with
    biases, (gelu(x @ w_in + b_in) @ w_out + b_out), the JAX ``init_mlp``/
    ``apply_mlp`` (``layers.py:72``/``:91``). ``jax.nn.gelu`` defaults to
    the tanh approximation, and so does this one."""

    def __init__(self, cfg, device, dtype):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.kind = cfg.mlp
        self.std_in, self.std_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
        if self.kind == "swiglu":
            self.w_gate = new_param((d, f), device, dtype)
            self.w_up = new_param((d, f), device, dtype)
            self.w_down = new_param((f, d), device, dtype)
        else:
            self.w_in = new_param((d, f), device, dtype)
            self.b_in = new_param((f,), device, dtype)
            self.w_out = new_param((f, d), device, dtype)
            self.b_out = new_param((d,), device, dtype)

    def init_(self, gen):
        if self.kind == "swiglu":
            normal_(self.w_gate, self.std_in, gen)
            normal_(self.w_up, self.std_in, gen)
            normal_(self.w_down, self.std_out, gen)
            return
        normal_(self.w_in, self.std_in, gen)
        self.b_in.zero_()
        normal_(self.w_out, self.std_out, gen)
        self.b_out.zero_()

    def forward(self, x):
        if self.kind == "swiglu":
            g = x @ self.w_gate
            u = x @ self.w_up
            h = F.silu(g.float()).to(x.dtype) * u
            return h @ self.w_down
        h = x @ self.w_in + self.b_in
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
        return h @ self.w_out + self.b_out


# ----------------------------------------------------------------- embedding


class Embedding(nn.Module):
    """Token table (padded vocab), the untied unembedding, and the learned
    position table where ``cfg.learned_pos_embed`` asks for one (the JAX
    ``init_embedding``, ``layers.py:117``: std 0.02)."""

    def __init__(self, cfg, device, dtype):
        super().__init__()
        V, d = cfg.padded_vocab, cfg.d_model
        self.tie = cfg.tie_embeddings
        self.tokens = new_param((V, d), device, dtype)
        self.unembed = None if self.tie else new_param((d, V), device, dtype)
        self.positions = (new_param((cfg.learned_pos_embed, d), device, dtype)
                          if cfg.learned_pos_embed else None)
        self.std_unembed = 1.0 / math.sqrt(d)

    def init_(self, gen):
        normal_(self.tokens, 1.0, gen)
        if self.unembed is not None:
            normal_(self.unembed, self.std_unembed, gen)
        if self.positions is not None:
            normal_(self.positions, 0.02, gen)

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.tokens[tokens]

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        if self.tie:
            return x @ self.tokens.t()
        return x @ self.unembed


def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style sinusoidal table (n, d) f32: sin of the first d/2
    timescales then their cos (the JAX ``sinusoidal_positions``,
    ``layers.py:131``)."""
    half = d // 2
    log_timescale = math.log(10_000.0) / max(half - 1, 1)
    inv = torch.exp(-log_timescale * torch.arange(half, dtype=torch.float32, device=device))
    ang = torch.arange(n, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
