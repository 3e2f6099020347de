"""GQA attention layer on the FA2 kernels: projections with qk-norm, RoPE,
full-sequence self-attention for training, prefill with a KV cache, and
single-token decode.

The counterpart of ``repro/models/attention_layer.py`` for the contiguous
cache (the paged branch comes with paged serving). The attention math is
always ``repro_torch.core.attention``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.attention import AttentionConfig, attention, decode_attention
from repro_torch.core.masks import MaskSpec
from repro_torch.models.layers import apply_rope, new_param, normal_, rms_norm_vec


class Attention(nn.Module):
    def __init__(self, cfg, device, dtype):
        super().__init__()
        d, qd, kd = cfg.d_model, cfg.q_dim, cfg.kv_dim
        self.cfg = cfg
        self.wq = new_param((d, qd), device, dtype)
        self.wk = new_param((d, kd), device, dtype)
        self.wv = new_param((d, kd), device, dtype)
        self.wo = new_param((qd, d), device, dtype)
        if cfg.qk_norm:
            self.q_norm = new_param((cfg.head_dim,), device, dtype)
            self.k_norm = new_param((cfg.head_dim,), device, dtype)

    def init_(self, gen):
        std = 1.0 / math.sqrt(self.cfg.d_model)
        normal_(self.wq, std, gen)
        normal_(self.wk, std, gen)
        normal_(self.wv, std, gen)
        normal_(self.wo, 1.0 / math.sqrt(self.cfg.q_dim), gen)
        if self.cfg.qk_norm:
            self.q_norm.fill_(1.0)
            self.k_norm.fill_(1.0)


def _project_q(p: Attention, cfg, x):
    B, S, _ = x.shape
    q = (x @ p.wq).reshape(B, S, cfg.num_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm_vec(q, p.q_norm, cfg.norm_eps)
    return q


def _project_kv(p: Attention, cfg, x):
    B, S, _ = x.shape
    k = (x @ p.wk).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = (x @ p.wv).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        k = rms_norm_vec(k, p.k_norm, cfg.norm_eps)
    return k, v


def _out(p: Attention, cfg, o):
    B, S = o.shape[:2]
    return o.reshape(B, S, cfg.q_dim) @ p.wo


def _self_attention(p: Attention, cfg, x, positions, spec, attn_cfg, rope_theta):
    q = _project_q(p, cfg, x)
    k, v = _project_kv(p, cfg, x)
    if rope_theta is not None:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    o = attention(q, k, v, spec, attn_cfg)
    return _out(p, cfg, o), k, v


def apply_attention(
    p: Attention, cfg, x, positions, spec: MaskSpec, attn_cfg: AttentionConfig, *,
    rope_theta: Optional[float] = None,
) -> torch.Tensor:
    """Full-sequence self-attention (training). x (B,S,d). The counterpart
    of ``apply_attention`` (JAX ``attention_layer.py:116``) without packed
    segments or cross-attention."""
    return _self_attention(p, cfg, x, positions, spec, attn_cfg, rope_theta)[0]


def prefill_attention(
    p: Attention, cfg, x, positions, spec: MaskSpec, attn_cfg: AttentionConfig, *,
    rope_theta: Optional[float] = None, cache_size: Optional[int] = None,
):
    """Causal self-attention over the prompt; also returns the KV cache,
    padded with zeros to ``cache_size`` along the sequence."""
    y, k, v = _self_attention(p, cfg, x, positions, spec, attn_cfg, rope_theta)
    S = k.shape[1]
    if cache_size is not None and cache_size > S:
        k = F.pad(k, (0, 0, 0, 0, 0, cache_size - S))
        v = F.pad(v, (0, 0, 0, 0, 0, cache_size - S))
    return y, {"k": k, "v": v}


def decode_attention_step(
    p: Attention, cfg, x_new, cache: dict, cache_len: torch.Tensor,
    attn_cfg: AttentionConfig, *, rope_theta=None, window=None, sink: int = 0,
) -> Tuple[torch.Tensor, dict]:
    """One decode step. x_new (B,1,d); cache k/v (B,S,Hkv,hd); cache_len (B,)
    = valid entries BEFORE this token.

    The new K/V row is written into ``cache`` IN PLACE at position
    ``cache_len`` (the JAX version returns an updated copy; here the cache
    is a mutable buffer the caller owns, and the returned dict is the same
    one)."""
    q = _project_q(p, cfg, x_new)
    k_new, v_new = _project_kv(p, cfg, x_new)
    if rope_theta is not None:
        pos = cache_len[:, None]  # (B, 1) absolute position of the new token
        q = apply_rope(q, pos, rope_theta)
        k_new = apply_rope(k_new, pos, rope_theta)
    rows = torch.arange(x_new.shape[0], device=x_new.device)
    cache["k"][rows, cache_len] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][rows, cache_len] = v_new[:, 0].to(cache["v"].dtype)
    o = decode_attention(q, cache["k"], cache["v"], cache_len + 1, attn_cfg,
                         window=window, sink=sink)
    return _out(p, cfg, o), cache
