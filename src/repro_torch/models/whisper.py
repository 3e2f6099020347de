"""Whisper-style encoder-decoder (whisper-base), as an ``nn.Module``.

The counterpart of ``repro/models/whisper.py``. As there, the conv/mel
frontend is a stub: the encoder takes precomputed frame embeddings
(B, T, d_model) and adds sinusoidal positions. The backbone: pre-LN,
bidirectional encoder self-attention, causal decoder self-attention,
encoder-decoder cross-attention, GELU MLPs, LayerNorm, learned decoder
positions, biases on the projections, the decoder's unembedding tied to
its token table.

Every attention site runs on the FA2 kernels through
``repro_torch.core.attention``: the encoder's self-attention (FULL) and the
decoder prefill's (causal) on the forward kernel, the prefill's
cross-attention (a few prompt rows against every frame) on the split-KV
forward where the auto policy splits it, and every decode tick's self- and
cross-attention on the decode kernel. Layers run in a Python loop (the JAX
package scans over the vmap-stacked layer tree). The serving entry points
run under ``torch.no_grad``. Training goes through :meth:`Whisper.forward`
(``launch/steps.loss_fn``'s encoder-decoder branch); with ``cfg.remat`` each
encoder and decoder layer is recomputed in the backward, as the JAX package
checkpoints each layer body.

Weights: :func:`init_whisper` draws them on the target device from a seeded
``torch.Generator``; :func:`params_from_jax` converts the JAX
``init_whisper`` tree (as numpy) into this module's state dict.
"""

from __future__ import annotations

from typing import Any, Dict, List, Union

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.registry import torch_dtype
from repro_torch.core.attention import AttentionConfig
from repro_torch.core.masks import CAUSAL, FULL
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models.attention_layer import (
    Attention,
    _project_kv,
    apply_attention,
    cross_attention,
    cross_attention_step,
    decode_attention_step,
    prefill_attention,
)
from repro_torch.models.layers import MLP, Embedding, Norm, sinusoidal_positions


def check_supported(cfg) -> None:
    """Raise unless ``cfg`` is an encoder-decoder config of attention layers."""
    if cfg.family != "encdec" or cfg.encoder is None:
        raise ValueError(f"{cfg.name}: Whisper builds encoder-decoder configs only "
                         f"(family {cfg.family!r}); decoder-only models are models/lm.py")
    if any(k != "attn" for k in cfg.layer_kinds()):
        raise NotImplementedError(f"{cfg.name}: whisper's decoder layers are 'attn' layers")


class EncoderLayer(nn.Module):
    def __init__(self, cfg, device, dtype):
        super().__init__()
        self.ln1 = Norm(cfg, device, dtype)
        self.attn = Attention(cfg, device, dtype)
        self.ln2 = Norm(cfg, device, dtype)
        self.mlp = MLP(cfg, device, dtype)


class DecoderLayer(nn.Module):
    """A decoder layer; ``self_attn`` is the JAX tree's ``self``."""

    def __init__(self, cfg, device, dtype):
        super().__init__()
        self.ln1 = Norm(cfg, device, dtype)
        self.self_attn = Attention(cfg, device, dtype)
        self.lnx = Norm(cfg, device, dtype)
        self.cross = Attention(cfg, device, dtype, cross=True)
        self.ln2 = Norm(cfg, device, dtype)
        self.mlp = MLP(cfg, device, dtype)


class Encoder(nn.Module):
    def __init__(self, cfg, device, dtype):
        super().__init__()
        self.layers = nn.ModuleList(
            EncoderLayer(cfg, device, dtype) for _ in range(cfg.encoder.num_layers))
        self.ln_post = Norm(cfg, device, dtype)


class Decoder(nn.Module):
    def __init__(self, cfg, device, dtype):
        super().__init__()
        self.embed = Embedding(cfg, device, dtype)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, device, dtype) for _ in range(cfg.num_layers))
        self.ln_f = Norm(cfg, device, dtype)


class Whisper(nn.Module):
    def __init__(self, cfg, device=DEFAULT_DEVICE):
        super().__init__()
        cfg.validate()
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        dtype = torch_dtype(cfg)
        self.encoder = Encoder(cfg, self.device, dtype)
        self.decoder = Decoder(cfg, self.device, dtype)

    @torch.no_grad()
    def init_weights_(self, seed: int) -> "Whisper":
        gen = torch.Generator(device=self.device).manual_seed(seed)
        for m in self.modules():
            if hasattr(m, "init_"):
                m.init_(gen)
        return self

    def _layer(self, body, layer, *args):
        """``body(layer, *args)``, recomputed in the backward when ``cfg.remat``
        and autograd records (JAX ``whisper.py:89``, ``:120``: ``jax.checkpoint``
        of each layer body)."""
        if self.cfg.remat and torch.is_grad_enabled():
            return checkpoint(body, layer, *args, use_reentrant=False)
        return body(layer, *args)

    def _enc_body(self, layer, h, positions, attn_cfg):
        h = h + apply_attention(layer.attn, self.cfg, layer.ln1(h), positions, FULL, attn_cfg)
        return self._mlp_block(layer, h)

    def _dec_body(self, layer, h, enc, positions, attn_cfg):
        cfg = self.cfg
        h = h + apply_attention(layer.self_attn, cfg, layer.ln1(h), positions, CAUSAL, attn_cfg)
        h = h + apply_attention(layer.cross, cfg, layer.lnx(h), positions, FULL, attn_cfg,
                                x_kv=enc)
        return self._mlp_block(layer, h)

    def encode(self, frames: torch.Tensor, attn_cfg: AttentionConfig) -> torch.Tensor:
        """frames (B, T, d_model), precomputed frame embeddings (the stub
        frontend) -> encoder output (B, T, d_model) (JAX ``whisper.py:75``)."""
        T, d = frames.shape[1], frames.shape[2]
        h = frames + sinusoidal_positions(T, d, frames.device)[None].to(frames.dtype)
        positions = torch.arange(T, device=h.device)
        for layer in self.encoder.layers:
            h = self._layer(self._enc_body, layer, h, positions, attn_cfg)
        return self.encoder.ln_post(h)

    def _dec_embed(self, tokens: torch.Tensor, start: Union[int, torch.Tensor] = 0):
        """Token embeddings plus learned positions from ``start`` (an int, or
        (B,) per-row decode positions) (JAX ``whisper.py:94``)."""
        embed = self.decoder.embed
        h = embed.embed(tokens)
        if isinstance(start, int):
            pos = embed.positions[start:start + tokens.shape[1]][None]
        else:
            pos = embed.positions[start.long()][:, None]
        return h + pos.to(h.dtype)

    def _mlp_block(self, layer, x):
        return x + layer.mlp(layer.ln2(x))

    def forward(self, frames: torch.Tensor, tokens: torch.Tensor, attn_cfg: AttentionConfig):
        """Teacher-forced forward -> (decoder hidden (B, S, d), aux loss 0,
        prefix 0), the counterpart of JAX ``whisper.py:105``; the caller
        unembeds. Gradients reach the encoder through every decoder layer's
        cross-attention."""
        enc = self.encode(frames, attn_cfg)
        h = self._dec_embed(tokens)
        positions = torch.arange(tokens.shape[1], device=h.device)
        for layer in self.decoder.layers:
            h = self._layer(self._dec_body, layer, h, enc, positions, attn_cfg)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        return self.decoder.ln_f(h), aux, 0

    @torch.no_grad()
    def logits_from_hidden(self, hidden: torch.Tensor) -> torch.Tensor:
        return self.decoder.embed.logits(hidden)

    @torch.no_grad()
    def prefill(self, frames: torch.Tensor, tokens: torch.Tensor, attn_cfg: AttentionConfig,
                cache_size: int):
        """-> (hidden_last (B, 1, d), caches, prompt length) (JAX
        ``whisper.py:126``). ``caches`` holds per decoder layer the causal
        self-attention K/V padded to ``cache_size`` and the cross-attention
        K/V over the encoder output, ``{"kv": {"k", "v"}, "cross": {"k",
        "v"}}``; the cross K/V are projected once here and reused by every
        decode tick."""
        cfg = self.cfg
        enc = self.encode(frames, attn_cfg)
        h = self._dec_embed(tokens)
        positions = torch.arange(tokens.shape[1], device=h.device)
        caches: List[Dict[str, Any]] = []
        for layer in self.decoder.layers:
            mix, kv = prefill_attention(layer.self_attn, cfg, layer.ln1(h), positions, CAUSAL,
                                        attn_cfg, cache_size=cache_size)
            h = h + mix
            xk, xv = _project_kv(layer.cross, cfg, enc)
            cross = {"k": xk, "v": xv}
            h = h + cross_attention(layer.cross, cfg, layer.lnx(h), cross, FULL, attn_cfg)
            h = self._mlp_block(layer, h)
            caches.append({"kv": kv, "cross": cross})
        h = self.decoder.ln_f(h)
        return h[:, -1:], caches, tokens.shape[1]

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, caches, cache_len: torch.Tensor,
                    attn_cfg: AttentionConfig):
        """token (B, 1); cache_len (B,) valid self-attention entries before
        this token -> (logits (B, 1, V), caches), the counterpart of JAX
        ``whisper.py:151``. The self-attention caches are written in place;
        the cross K/V are read whole."""
        cfg = self.cfg
        B = token.shape[0]
        h = self._dec_embed(token, start=cache_len)
        for layer, cache in zip(self.decoder.layers, caches):
            mix, _ = decode_attention_step(layer.self_attn, cfg, layer.ln1(h), cache["kv"],
                                           cache_len, attn_cfg)
            h = h + mix
            enc_len = torch.full((B,), cache["cross"]["k"].shape[1], dtype=torch.int32,
                                 device=h.device)
            h = h + cross_attention_step(layer.cross, cfg, layer.lnx(h), cache["cross"],
                                         enc_len, attn_cfg)
            h = self._mlp_block(layer, h)
        h = self.decoder.ln_f(h)
        return self.logits_from_hidden(h), caches


def init_whisper(cfg, seed: int = 0, device=DEFAULT_DEVICE) -> Whisper:
    """Whisper with random weights drawn on ``device`` from ``seed``."""
    return Whisper(cfg, device).init_weights_(seed)


def params_from_jax(cfg, tree) -> Dict[str, torch.Tensor]:
    """State dict of :class:`Whisper` from ``repro.models.whisper.
    init_whisper``'s tree (leaves as numpy arrays). The JAX tree stacks the
    layers with ``vmap``: every leaf under ``encoder.layers`` and
    ``decoder.layers`` has a leading layer axis, unstacked here."""
    check_supported(cfg)
    state: Dict[str, torch.Tensor] = {}

    def put(prefix, sub):
        for key, val in sub.items():
            name = "self_attn" if key == "self" else key
            if isinstance(val, dict):
                put(f"{prefix}{name}.", val)
            else:
                state[f"{prefix}{name}"] = torch.from_numpy(np.array(val))

    for part, n in (("encoder", cfg.encoder.num_layers), ("decoder", cfg.num_layers)):
        stacked = tree[part]["layers"]
        for i in range(n):
            put(f"{part}.layers.{i}.", _index_tree(stacked, i))
        put(f"{part}.", {k: v for k, v in tree[part].items() if k != "layers"})
    return state


def _index_tree(tree, i):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return tree[i]
