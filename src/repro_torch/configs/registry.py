"""Arch registry: ``--arch`` lookup, reduced configs and decode-cache specs.

The counterpart of ``repro/configs/registry.py`` for the PyTorch port. A
cache spec is a ``TensorSpec`` (shape + torch dtype) instead of a
``ShapeDtypeStruct``, and the cache is a flat list with one entry per layer
(the port runs its layers in a Python loop, not a scan over groups).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Tuple

import torch

from repro_torch.configs import archs
from repro_torch.configs.base import EncoderConfig, ModelConfig, MoEConfig, SSMConfig

_BY_NAME = {c.name: c for c in archs.ALL}

TORCH_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float32": torch.float32,
}


def names():
    return list(_BY_NAME)


def get(name: str) -> ModelConfig:
    if name not in _BY_NAME:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_BY_NAME)}")
    return _BY_NAME[name]


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return TORCH_DTYPES[cfg.dtype]


class TensorSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


def cache_specs(cfg: ModelConfig, B: int, cache: int,
                enc_frames: int = 1500) -> List[Dict[str, Any]]:
    """Decode-cache spec of every layer, in layer order: ``{"kv": {"k", "v"}}``
    of shape (B, cache, Hkv, head_dim). An encoder-decoder config (whisper)
    adds per decoder layer the cross-attention K/V over the encoder output,
    ``"cross": {"k", "v"}`` of shape (B, enc_frames, Hkv, head_dim) (JAX
    ``registry.py:137``, which stacks the layers where this keeps a list).
    SSM state comes with that family."""
    kinds = cfg.layer_kinds()
    if any(k not in ("attn", "attn_local") for k in kinds):
        raise NotImplementedError(f"{cfg.name}: only attention-layer caches are ported "
                                  f"(layer kinds {sorted(set(kinds))})")
    spec = TensorSpec((B, cache, cfg.num_kv_heads, cfg.head_dim), torch_dtype(cfg))
    if cfg.family == "encdec":
        cross = TensorSpec((B, enc_frames, cfg.num_kv_heads, cfg.head_dim), torch_dtype(cfg))
        return [{"kv": {"k": spec, "v": spec}, "cross": {"k": cross, "v": cross}}
                for _ in kinds]
    return [{"kv": {"k": spec, "v": spec}} for _ in kinds]


def paged_cache_specs(cfg: ModelConfig, num_pages: int, page_size: int) -> List[Dict[str, Any]]:
    """Cache spec of the paged serving engine, in layer order: per layer the
    pool's physical page planes ``{"kv": {"k", "v"}}`` of shape
    (Hkv, num_pages, page_size, head_dim), shared by every resident sequence
    through one block table (``serving/kv_pool.py``). Attention-only: a page
    holds no recurrent state."""
    kinds = cfg.layer_kinds()
    assert cfg.family != "encdec" and cfg.ssm is None and all(
        k in ("attn", "attn_local") for k in kinds
    ), "paged caches serve attention-only decoder configs"
    spec = TensorSpec((cfg.num_kv_heads, num_pages, page_size, cfg.head_dim), torch_dtype(cfg))
    return [{"kv": {"k": spec, "v": spec}} for _ in kinds]


def reduce_config(cfg: ModelConfig) -> ModelConfig:
    """Same family/features, tiny dims: one fwd/serve step runs on CPU.

    Identical to ``repro.configs.registry.reduce_config`` so one test can
    key both packages by the same reduced config."""
    heads = min(cfg.num_heads, 4) or 1
    kv = max(1, min(cfg.num_kv_heads, heads))
    while heads % kv:
        kv -= 1
    kw: Dict[str, Any] = dict(
        d_model=64,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=512,
        vocab_pad_to=64,
        window=32 if cfg.window else None,
        meta_tokens=8 if cfg.meta_tokens else 0,
        learned_pos_embed=128 if cfg.learned_pos_embed else None,
        max_seq_len=256,
        dtype="float32",
        num_patches=4 if cfg.num_patches else 0,
    )
    unit = cfg.layer_pattern
    if len(unit) == cfg.num_layers:  # unrolled pattern (hymba): shrink it
        kinds = sorted(set(unit), reverse=True)
        pattern = tuple(kinds) + (unit[1],) * (4 - len(set(unit)))
        kw["layer_pattern"] = pattern[:4]
        kw["num_layers"] = 4
    else:
        kw["layer_pattern"] = unit
        kw["num_layers"] = len(unit) * 2 + (1 if cfg.tail_pattern else 0)
    if cfg.moe:
        kw["moe"] = MoEConfig(
            num_experts=min(cfg.moe.num_experts, 8),
            top_k=min(cfg.moe.top_k, 2),
            d_expert=64,
            capacity_factor=2.0,
        )
    if cfg.ssm:
        kw["ssm"] = SSMConfig(
            d_state=8, d_conv=4, expand=2,
            dt_rank=8, bcdt_norm=cfg.ssm.bcdt_norm,
        )
    if cfg.encoder:
        kw["encoder"] = EncoderConfig(num_layers=2, max_frames=64)
    return dataclasses.replace(cfg, name=cfg.name + "-reduced", **kw)
