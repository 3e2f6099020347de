"""GQA attention layer on the FA2 kernels: projections with qk-norm and
biases, RoPE, full-sequence self- and cross-attention, prefill with a KV
cache, single-token decode, and decode-time cross-attention against cached
encoder K/V.

The counterpart of ``repro/models/attention_layer.py``, with the
contiguous cache and the paged one (decode through a block table). The
attention math is always ``repro_torch.core.attention``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.attention import (
    AttentionConfig,
    attention,
    decode_attention,
    decode_attention_paged,
)
from repro_torch.core.masks import MaskSpec
from repro_torch.models.layers import apply_rope, new_param, normal_, rms_norm_vec


class Attention(nn.Module):
    """Projection weights (the JAX ``init_attention``, ``attention_layer.py:
    61``): wq/wk/wv/wo, biases bq/bk/bv/bo with ``cfg.attn_bias``, and the
    qk-norm scales with ``cfg.qk_norm`` on a self-attention layer (a
    ``cross`` layer has none)."""

    def __init__(self, cfg, device, dtype, cross: bool = False):
        super().__init__()
        d, qd, kd = cfg.d_model, cfg.q_dim, cfg.kv_dim
        self.cfg = cfg
        self.qk_norm = cfg.qk_norm and not cross
        self.wq = new_param((d, qd), device, dtype)
        self.wk = new_param((d, kd), device, dtype)
        self.wv = new_param((d, kd), device, dtype)
        self.wo = new_param((qd, d), device, dtype)
        if cfg.attn_bias:
            self.bq = new_param((qd,), device, dtype)
            self.bk = new_param((kd,), device, dtype)
            self.bv = new_param((kd,), device, dtype)
            self.bo = new_param((d,), device, dtype)
        if self.qk_norm:
            self.q_norm = new_param((cfg.head_dim,), device, dtype)
            self.k_norm = new_param((cfg.head_dim,), device, dtype)

    def init_(self, gen):
        std = 1.0 / math.sqrt(self.cfg.d_model)
        normal_(self.wq, std, gen)
        normal_(self.wk, std, gen)
        normal_(self.wv, std, gen)
        normal_(self.wo, 1.0 / math.sqrt(self.cfg.q_dim), gen)
        if self.cfg.attn_bias:
            for b in (self.bq, self.bk, self.bv, self.bo):
                b.zero_()
        if self.qk_norm:
            self.q_norm.fill_(1.0)
            self.k_norm.fill_(1.0)


def _project_q(p: Attention, cfg, x):
    B, S, _ = x.shape
    q = x @ p.wq
    if cfg.attn_bias:
        q = q + p.bq
    q = q.reshape(B, S, cfg.num_heads, cfg.head_dim)
    if p.qk_norm:
        q = rms_norm_vec(q, p.q_norm, cfg.norm_eps)
    return q


def _project_kv(p: Attention, cfg, x):
    B, S, _ = x.shape
    k, v = x @ p.wk, x @ p.wv
    if cfg.attn_bias:
        k, v = k + p.bk, v + p.bv
    k = k.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    if p.qk_norm:
        k = rms_norm_vec(k, p.k_norm, cfg.norm_eps)
    return k, v


def _out(p: Attention, cfg, o):
    B, S = o.shape[:2]
    y = o.reshape(B, S, cfg.q_dim) @ p.wo
    return y + p.bo if cfg.attn_bias else y


def _self_attention(p: Attention, cfg, x, positions, spec, attn_cfg, rope_theta,
                    segment_ids=None):
    q = _project_q(p, cfg, x)
    k, v = _project_kv(p, cfg, x)
    if rope_theta is not None:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    o = attention(q, k, v, spec, attn_cfg, segment_ids=segment_ids)
    return _out(p, cfg, o), k, v


def apply_attention(
    p: Attention, cfg, x, positions, spec: MaskSpec, attn_cfg: AttentionConfig, *,
    rope_theta: Optional[float] = None, x_kv: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full-sequence attention (training, encoder, cross). x (B,S,d). The
    counterpart of ``apply_attention`` (JAX ``attention_layer.py:116``).
    With ``x_kv`` (B, Skv, d) it is cross-attention: K/V are projected from
    ``x_kv`` and no RoPE is applied. ``segment_ids`` (B, S) enables packed
    varlen training: attention never crosses a segment boundary (the caller
    supplies the within-segment RoPE positions)."""
    if x_kv is not None:
        k, v = _project_kv(p, cfg, x_kv)
        return cross_attention(p, cfg, x, {"k": k, "v": v}, spec, attn_cfg)
    return _self_attention(p, cfg, x, positions, spec, attn_cfg, rope_theta, segment_ids)[0]


def cross_attention(p: Attention, cfg, x, kv: dict, spec: MaskSpec,
                    attn_cfg: AttentionConfig) -> torch.Tensor:
    """Full-sequence cross-attention of x (B, S, d) against K/V already
    projected from the encoder output, ``kv = {"k", "v"}`` (B, Skv, Hkv,
    hd): whisper's prefill projects them once and keeps them as the cache."""
    o = attention(_project_q(p, cfg, x), kv["k"], kv["v"], spec, attn_cfg)
    return _out(p, cfg, o)


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
    block_table: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, dict]:
    """One decode step. x_new (B,1,d); cache_len (B,) = valid entries BEFORE
    this token. The new K/V row is written into ``cache`` IN PLACE (the JAX
    version returns an updated copy; here the cache is a mutable buffer the
    caller owns, and the returned dict is the same one).

    Contiguous cache (``block_table=None``): k/v (B,S,Hkv,hd), the new row
    goes to position ``cache_len``.

    Paged cache (``block_table`` (B, n_pages) int32): k/v are the pool's
    page planes (Hkv,P,ps,hd); the new row goes to page
    ``block_table[b, cache_len // ps]`` at offset ``cache_len % ps``, and
    attention reads through the table. A row with cache_len == 0 is an
    inactive slot (a real sequence always has a prompt): its all-null table
    row sends its write to the null page 0 and its attention length is 0,
    so it reads no K/V and its output is 0."""
    q = _project_q(p, cfg, x_new)
    k_new, v_new = _project_kv(p, cfg, x_new)
    if rope_theta is not None:
        pos = cache_len[:, None]  # (B, 1) absolute position of the new token
        q = apply_rope(q, pos, rope_theta)
        k_new = apply_rope(k_new, pos, rope_theta)
    rows = torch.arange(x_new.shape[0], device=x_new.device)
    if block_table is not None:
        ps = cache["k"].shape[2]
        page = block_table[rows, cache_len // ps]
        off = cache_len % ps
        # Inactive rows all write cell (page 0, offset 0): on the card the
        # winner of that duplicate write is not fixed, and it does not
        # matter, because no row ever reads the null page.
        cache["k"][:, page, off] = k_new[:, 0].transpose(0, 1).to(cache["k"].dtype)
        cache["v"][:, page, off] = v_new[:, 0].transpose(0, 1).to(cache["v"].dtype)
        lengths = torch.where(cache_len > 0, cache_len + 1, torch.zeros_like(cache_len))
        o = decode_attention_paged(q, cache["k"], cache["v"], lengths, block_table, attn_cfg,
                                   window=window, sink=sink)
        return _out(p, cfg, o), cache
    cache["k"][rows, cache_len] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][rows, cache_len] = v_new[:, 0].to(cache["v"].dtype)
    o = decode_attention(q, cache["k"], cache["v"], cache_len + 1, attn_cfg,
                         window=window, sink=sink)
    return _out(p, cfg, o), cache


def cross_attention_step(p: Attention, cfg, x_new, enc_cache: dict, enc_len: torch.Tensor,
                         attn_cfg: AttentionConfig) -> torch.Tensor:
    """Decode-time cross-attention (JAX ``attention_layer.py:234``): q from
    x_new (B, 1, d) against the cached encoder K/V ``enc_cache = {"k",
    "v"}`` (B, T, Hkv, hd), the first ``enc_len`` (B,) positions visible."""
    q = _project_q(p, cfg, x_new)
    o = decode_attention(q, enc_cache["k"], enc_cache["v"], enc_len, attn_cfg)
    return _out(p, cfg, o)
