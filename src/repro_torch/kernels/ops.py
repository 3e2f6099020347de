"""Public wrappers of the attention kernels: knob resolution, q pre-scaling,
the decode split merge.

The counterpart of ``repro/kernels/ops.py`` for the serving slice (forward
only). Knobs are an explicit value or the H100 default; the TPU-measured
``tuned.json`` is not consulted.

Inputs keep the repo-wide public layout, q (B, Sq, Hq, D) and k/v
(B, Skv, Hkv, D). The kernels read it in place through strides, so the
JAX wrapper's head-major transpose and block padding (``_prep``) reduce to
the q pre-scale.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.masks import MaskSpec
from repro_torch.core.online_softmax import combine_lse_outputs
from repro_torch.kernels import flash_decode as _dec
from repro_torch.kernels import flash_fwd as _fwd

# Split-KV decode fan-out when none is given (the JAX package's fallback
# when its tuned cache has no entry).
DEFAULT_DECODE_SPLITS = 8


# H100 forward tiles (block_q, block_kv), sized for a CTA's 227 KB of shared
# memory (the TPU table sized tiles for 16 MB of VMEM): the kernel holds a
# block_q x D Q tile plus two stages of block_kv x D K and V tiles, rows
# padded by 8. At D = 128, (64, 64) takes 87 KB, so two CTAs share an SM, and
# 64 q rows per CTA keep enough CTAs in flight for a B = 1 prefill
# (32 heads x S / 64). The sequence lengths do not enter: the kernel masks the
# ragged edge itself. The CPU path takes any block sizes (the parity tests
# match the JAX kernel's); the CUDA kernel checks ``flash_fwd.KERNEL_BLOCKS``.
BLOCK_Q = BLOCK_KV = 64


def _prep(q: torch.Tensor, scale: float) -> torch.Tensor:
    """q pre-scaled in f32 and cast back to its dtype, exactly as the JAX
    wrapper does, so both round the same way."""
    return (q.float() * scale).to(q.dtype)


def _no_grad_inputs(*ts):
    if any(t.requires_grad for t in ts):
        raise NotImplementedError(
            "the CUDA attention kernels are forward-only so far; the backward "
            "kernels come with the training slice of the port"
        )


def flash_attention_with_lse(
    q, k, v, spec: MaskSpec = MaskSpec(causal=True), *,
    scale: Optional[float] = None,
    block_q: int = BLOCK_Q, block_kv: int = BLOCK_KV,
):
    """FA2 forward. q (B,Sq,Hq,D), k/v (B,Skv,Hkv,D) -> (o (B,Sq,Hq,D),
    lse (B,Hq,Sq) f32). The counterpart of ``flash_attention_pallas_with_lse``."""
    _no_grad_inputs(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _fwd.flash_fwd(_prep(q, scale), k, v, spec, block_q=block_q, block_kv=block_kv)


def flash_attention(
    q, k, v, spec: MaskSpec = MaskSpec(causal=True), *,
    scale: Optional[float] = None,
    block_q: int = BLOCK_Q, block_kv: int = BLOCK_KV,
):
    """FA2 forward, output only (the counterpart of ``flash_attention_pallas``)."""
    return flash_attention_with_lse(
        q, k, v, spec, scale=scale, block_q=block_q, block_kv=block_kv
    )[0]


def flash_decode(
    q, k_cache, v_cache, cache_length, *,
    window: Optional[int] = None, sink: int = 0, scale: Optional[float] = None,
    num_splits: int = DEFAULT_DECODE_SPLITS,
):
    """Split-KV decode. q (B,1,Hq,D); caches (B,S,Hkv,D); cache_length (B,)
    valid entries. Returns (o (B,1,Hq,D), lse (B,Hq,1)), the counterpart of
    ``flash_decode_pallas``."""
    _no_grad_inputs(q, k_cache, v_cache)
    B, one, Hq, D = q.shape
    if one != 1:
        raise ValueError("flash_decode is a single-token step; q must be (B, 1, Hq, D)")
    Hk = k_cache.shape[2]
    G = Hq // Hk
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    qh = _prep(q, scale).reshape(B * Hk, G, D).contiguous()
    lengths = cache_length.to(device=q.device, dtype=torch.int32).contiguous()
    o_parts, lse_parts = _dec.flash_decode(
        qh, k_cache, v_cache, lengths, num_splits=num_splits, window=window, sink=sink
    )
    o, lse = combine_lse_outputs(o_parts.movedim(1, 0), lse_parts.movedim(1, 0))
    return o.reshape(B, 1, Hq, D).to(q.dtype), lse.reshape(B, Hq, 1)
