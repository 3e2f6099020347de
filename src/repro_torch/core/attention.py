"""Unified attention entry point of the port.

Every model calls :func:`attention` / :func:`decode_attention`; the backend
is chosen by config, never by model code:

  impl = 'ref'         dense O(N^2)-memory attention (the oracle),
                       differentiated by autograd
  impl = 'flash_cuda'  the hand-written Hopper kernels (kernels/ops.py),
                       forward and backward; on CPU tensors their plain
                       PyTorch versions

The counterpart of ``repro/core/attention.py`` (``flash_cuda`` stands where
``flash_pallas`` stands there). There is no ring routing yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.masks import MaskSpec
from repro_torch.kernels import ops
from repro_torch.kernels.ref import attention_reference

IMPLS = ("ref", "flash_cuda")


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    impl: str = "flash_cuda"

    def __post_init__(self):
        if self.impl not in IMPLS:
            raise ValueError(f"unknown attention impl {self.impl!r}; have {IMPLS}")


def attention(q, k, v, spec: MaskSpec, cfg: AttentionConfig = AttentionConfig(), *,
              scale: Optional[float] = None) -> torch.Tensor:
    """Attention output. q (B,Sq,Hq,D); k/v (B,Skv,Hkv,D) GQA."""
    if cfg.impl == "ref":
        return attention_reference(q, k, v, spec, scale=scale)[0]
    return ops.flash_attention(q, k, v, spec, scale=scale)


def decode_attention(q, k_cache, v_cache, cache_length,
                     cfg: AttentionConfig = AttentionConfig(), *,
                     window: Optional[int] = None, sink: int = 0,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-token decode against a padded cache. q (B,1,Hq,D); caches
    (B,S,Hkv,D); cache_length (B,) valid entries. Returns (B,1,Hq,D).

    The query sits at position ``cache_length - 1`` and attends to
    [max(0, L - window), L) plus the first ``sink`` positions."""
    if cfg.impl == "ref":
        return _decode_reference(q, k_cache, v_cache, cache_length,
                                 window=window, sink=sink, scale=scale)
    return ops.flash_decode(q, k_cache, v_cache, cache_length, window=window,
                            sink=sink, scale=scale)[0]


def _decode_reference(q, k_cache, v_cache, cache_length, *, window, sink, scale):
    """Row by row through the dense oracle, the query at position L - 1."""
    out = torch.zeros_like(q)
    for b, L in enumerate(cache_length.tolist()):
        if L <= 0:
            continue
        spec = MaskSpec(causal=True, window=window, sink=sink, q_offset=L - 1)
        out[b:b + 1] = attention_reference(
            q[b:b + 1], k_cache[b:b + 1, :L], v_cache[b:b + 1, :L], spec, scale=scale
        )[0]
    return out
