"""Decoder-only LM for attention-only configs, as an ``nn.Module``.

The counterpart of ``repro/models/lm.py``: embed -> layers (``attn`` /
``attn_local``, each attention + MLP with pre-norms; the MoE layer of
``models/moe.py`` in place of the MLP when ``cfg.moe`` is set) -> final
norm, with ``forward`` (training: hidden and the summed MoE aux loss),
``prefill``, ``decode_step`` and ``logits_from_hidden``. Layers run in a
Python loop (the JAX package scans over layer groups). The serving entry
points run under ``torch.no_grad``. SSM, hybrid and VLM configs are not
ported yet and raise; the encoder-decoder family is ``models/whisper.py``.

Weights: :func:`init_lm` draws them on the target device from a seeded
``torch.Generator`` with the same std rules as the JAX ``init_lm``;
:func:`params_from_jax` converts the JAX ``init_lm`` tree (as numpy) into
this module's state dict, so the tests can run both on identical weights.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.registry import torch_dtype
from repro_torch.core.attention import AttentionConfig
from repro_torch.core.masks import MaskSpec, segment_positions
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models.attention_layer import (
    Attention,
    apply_attention,
    decode_attention_step,
    prefill_attention,
)
from repro_torch.models.layers import MLP, Embedding, Norm
from repro_torch.models.moe import MoE

SUPPORTED_KINDS = ("attn", "attn_local")


def check_supported(cfg) -> None:
    """Raise for what this decoder-only LM cannot build. Every dense arch of
    the registry (qwen3, deepseek-coder, stablelm, gemma3) and both MoE
    archs (granite-moe-1b-a400m, mixtral-8x22b) pass here, and run on the
    plain CPU path. On the card the CUDA kernels serve head_dim 64, 128, 160
    and 256 (the paged decode too) and train all four, on packed batches
    too: gemma3-1b (256) and stablelm-12b (160) serve and train there
    through ``flash_cuda``, granite-moe-1b-a400m (64) serves there; the
    entry points refuse what the kernels lack up front
    (``core.attention.check_card_support``). The encoder-decoder family is
    :class:`repro_torch.models.whisper.Whisper`."""
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"{cfg.name} is an encoder-decoder model: build it with "
            "repro_torch.models.whisper.Whisper (init_whisper), not the decoder-only LM")
    unsupported = [k for k in cfg.layer_kinds() if k not in SUPPORTED_KINDS]
    if cfg.family not in ("dense", "moe") or unsupported:
        raise NotImplementedError(
            f"{cfg.name}: the port builds dense and MoE attention-only decoders and whisper "
            f"so far (family {cfg.family!r}, layer kinds {sorted(set(cfg.layer_kinds()))}); "
            "SSM, hybrid and VLM models come in later slices"
        )
    if (cfg.meta_tokens or cfg.learned_pos_embed or cfg.num_patches or cfg.attn_bias
            or cfg.mlp != "swiglu" or cfg.norm != "rmsnorm"):
        raise NotImplementedError(
            f"{cfg.name}: the decoder-only LM does not take prefix tokens, learned positions, "
            "attention biases, GELU or LayerNorm yet (whisper's layers in "
            "models/whisper.py have the last four)")


def spec_for(cfg, kind: str) -> MaskSpec:
    return MaskSpec(causal=True, window=cfg.kind_window(kind))


def theta_for(cfg, kind: str) -> float:
    if kind == "attn_local" and cfg.rope_theta_local is not None:
        return cfg.rope_theta_local
    return cfg.rope_theta


class Layer(nn.Module):
    def __init__(self, kind, cfg, device, dtype):
        super().__init__()
        self.kind = kind
        self.ln1 = Norm(cfg, device, dtype)
        self.mixer = Attention(cfg, device, dtype)
        self.ln2 = Norm(cfg, device, dtype)
        self.mlp = MoE(cfg, device, dtype) if cfg.moe is not None else MLP(cfg, device, dtype)


class LM(nn.Module):
    def __init__(self, cfg, device=DEFAULT_DEVICE):
        super().__init__()
        cfg.validate()
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        dtype = torch_dtype(cfg)
        self.embed = Embedding(cfg, self.device, dtype)
        self.layers = nn.ModuleList(
            Layer(kind, cfg, self.device, dtype) for kind in cfg.layer_kinds()
        )
        self.ln_f = Norm(cfg, self.device, dtype)

    @torch.no_grad()
    def init_weights_(self, seed: int) -> "LM":
        gen = torch.Generator(device=self.device).manual_seed(seed)
        for m in self.modules():
            if hasattr(m, "init_"):
                m.init_(gen)
        return self

    def _embed(self, tokens):
        h = self.embed.embed(tokens)
        if self.cfg.embed_scale_by_dim:
            h = (h.float() * (self.cfg.d_model ** 0.5)).to(h.dtype)
        return h

    @torch.no_grad()
    def logits_from_hidden(self, hidden: torch.Tensor) -> torch.Tensor:
        """Serving: logits of the hidden states (training unembeds inside
        the chunked loss, ``training/losses.py``)."""
        return self.embed.logits(hidden)

    def _mlp_block(self, layer: Layer, x, with_aux: bool = False):
        """The second residual sub-block (JAX ``_apply_mlp_block``, ``lm.py:88``):
        (x + delta, aux). aux is the MoE layer's load-balancing loss when
        ``with_aux`` (training), else None."""
        h = layer.ln2(x)
        if self.cfg.moe is None:
            return x + layer.mlp(h), None
        delta, aux = layer.mlp(h, with_aux=with_aux)
        return x + delta, aux

    def _apply_group(self, layers, x, positions, attn_cfg: AttentionConfig, segment_ids=None):
        """-> (x, the summed aux of the layers), as the JAX scan body carries it."""
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for layer in layers:
            mix = apply_attention(
                layer.mixer, cfg, layer.ln1(x), positions, spec_for(cfg, layer.kind),
                attn_cfg, rope_theta=theta_for(cfg, layer.kind), segment_ids=segment_ids,
            )
            x, a = self._mlp_block(layer, x + mix, with_aux=True)
            if a is not None:
                aux = aux + a
        return x, aux

    def forward(self, tokens: torch.Tensor, attn_cfg: AttentionConfig,
                segment_ids: Optional[torch.Tensor] = None):
        """tokens (B, S) -> (hidden (B, S, d), aux_loss, n_prefix), the
        counterpart of ``lm.forward`` (JAX ``lm.py:269``); the caller
        unembeds. aux_loss is the MoE layers' load-balancing losses summed
        over the layers in order (0 without MoE). With ``cfg.remat`` each
        group of ``cfg.group_size`` layers is recomputed in the backward
        (``torch.utils.checkpoint``), as the JAX package checkpoints each
        scan group (``lm.py:255``); the tail layers are not checkpointed
        there either.

        ``segment_ids`` (B, S) int turns on packed (varlen) training:
        attention stays within segments (through every layer, the recomputed
        groups included) and RoPE positions restart at each segment start."""
        cfg = self.cfg
        h = self._embed(tokens)
        if segment_ids is not None:
            # The JAX asserts (lm.py:280): no prefix tokens, RoPE positions.
            assert not (cfg.meta_tokens or cfg.num_patches), \
                "packed mode does not support prefix tokens"
            assert not cfg.learned_pos_embed, "packed mode needs RoPE positions"
            segment_ids = segment_ids.to(device=h.device, dtype=torch.int32)
            positions = segment_positions(segment_ids)
        else:
            positions = torch.arange(h.shape[1], device=h.device)
        U = cfg.group_size
        n_grouped = cfg.num_groups * U
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for g0 in range(0, n_grouped, U):
            group = self.layers[g0:g0 + U]
            if cfg.remat:
                h, a = checkpoint(self._apply_group, group, h, positions, attn_cfg, segment_ids,
                                  use_reentrant=False)
            else:
                h, a = self._apply_group(group, h, positions, attn_cfg, segment_ids)
            aux = aux + a
        h, a = self._apply_group(self.layers[n_grouped:], h, positions, attn_cfg, segment_ids)
        return self.ln_f(h), aux + a, 0

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, attn_cfg: AttentionConfig, cache_size: int,
                lens: Optional[torch.Tensor] = None):
        """tokens (B, S) -> (hidden_last (B,1,d), caches, lens (B,) int32).

        ``caches`` holds one ``{"kv": {"k", "v"}}`` per layer, padded to
        ``cache_size``. ``lens`` marks the real token count of right-padded
        (bucketed) prompts: the hidden is taken at each row's last real
        position; causality keeps the padding out of every real row."""
        cfg = self.cfg
        h = self._embed(tokens)
        S = h.shape[1]
        positions = torch.arange(S, device=h.device)
        caches: List[Dict[str, Any]] = []
        for layer in self.layers:
            mix, kv = prefill_attention(
                layer.mixer, cfg, layer.ln1(h), positions, spec_for(cfg, layer.kind),
                attn_cfg, rope_theta=theta_for(cfg, layer.kind), cache_size=cache_size,
            )
            h, _ = self._mlp_block(layer, h + mix)
            caches.append({"kv": kv})
        h = self.ln_f(h)
        B = h.shape[0]
        if lens is None:
            return h[:, -1:], caches, torch.full((B,), S, dtype=torch.int32, device=h.device)
        lens = lens.to(device=h.device, dtype=torch.int32)
        h_last = h[torch.arange(B, device=h.device), lens.long() - 1][:, None]
        return h_last, caches, lens

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, caches, cache_len: torch.Tensor,
                    attn_cfg: AttentionConfig, block_table: Optional[torch.Tensor] = None):
        """token (B,1); cache_len (B,) valid entries per row ->
        (logits (B,1,V), caches). The caches are updated in place.

        ``block_table`` (B, n_pages) int32 switches every attention layer to
        the paged cache (the pool's page planes, ``registry.paged_cache_specs``,
        in place of per-slot contiguous caches); all layers share the table."""
        cfg = self.cfg
        h = self._embed(token)
        for layer, cache in zip(self.layers, caches):
            spec = spec_for(cfg, layer.kind)
            mix, _ = decode_attention_step(
                layer.mixer, cfg, layer.ln1(h), cache["kv"], cache_len, attn_cfg,
                rope_theta=theta_for(cfg, layer.kind), window=spec.window, sink=spec.sink,
                block_table=block_table,
            )
            h, _ = self._mlp_block(layer, h + mix)
        h = self.ln_f(h)
        return self.logits_from_hidden(h), caches


def init_lm(cfg, seed: int = 0, device=DEFAULT_DEVICE) -> LM:
    """The LM with random weights drawn on ``device`` from ``seed``."""
    return LM(cfg, device).init_weights_(seed)


def params_from_jax(cfg, tree) -> Dict[str, torch.Tensor]:
    """State dict of :class:`LM` from ``repro.models.lm.init_lm``'s tree
    (leaves as numpy arrays). Scan-stacked ``groups`` leaves carry a leading
    ``num_groups`` axis and are unstacked into consecutive layers. An MoE
    layer's ``mlp`` carries ``router`` (float32, as the JAX tree keeps it),
    ``we_gate``, ``we_up`` and ``we_down``."""
    check_supported(cfg)
    U, NG = cfg.group_size, cfg.num_groups
    per_layer: List[Dict[str, Any]] = []
    groups = tree.get("groups")
    if NG:
        if isinstance(groups, (list, tuple)):
            group_list = list(groups)
        else:
            group_list = [_index_tree(groups, g) for g in range(NG)]
        for gp in group_list:
            per_layer.extend(gp[f"slot_{u}"] for u in range(U))
    per_layer.extend(tree.get("tail", []))
    if len(per_layer) != cfg.num_layers:
        raise ValueError(f"tree has {len(per_layer)} layers, config {cfg.num_layers}")

    state: Dict[str, torch.Tensor] = {}

    def put(name, arr):
        state[name] = torch.from_numpy(np.array(arr))

    put("embed.tokens", tree["embed"]["tokens"])
    if not cfg.tie_embeddings:
        put("embed.unembed", tree["embed"]["unembed"])
    for key, arr in tree["ln_f"].items():
        put(f"ln_f.{key}", arr)
    for i, lp in enumerate(per_layer):
        for block in ("ln1", "ln2", "mixer", "mlp"):
            for key, arr in lp[block].items():
                put(f"layers.{i}.{block}.{key}", arr)
    return state


def _index_tree(tree, i):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return tree[i]
