"""Public wrappers of the attention kernels: knob resolution, q pre-scaling,
the differentiable FA2 core, the decode split merge.

The counterpart of ``repro/kernels/ops.py``. Knobs are an explicit value or
the H100 default; the TPU-measured ``tuned.json`` is not consulted.

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
from repro_torch.kernels import flash_bwd as _bwd
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


# Backward modes: "fused" is the one-pass kernel (the JAX default). The JAX
# wrapper falls back to "split" when the fused kernel's per-q-tile delta
# scratch, O(G * Sq) f32, would not fit in VMEM (``ops._resolve_bwd``); here
# delta is a pre-pass that lives in HBM, so no such budget exists and
# "fused" serves every shape.
BWD_MODES = ("fused", "split")


def _check_bwd(bwd: str) -> None:
    if bwd not in BWD_MODES:
        raise ValueError(f"unknown backward mode {bwd!r}; have {BWD_MODES}")
    if bwd == "split":
        raise NotImplementedError(
            'bwd="split" (the deterministic delta + dkv + dq backward) is not '
            "ported yet; see ROADMAP.md, kernels to port"
        )


class _FlashCore(torch.autograd.Function):
    """FA2 on pre-scaled q: the counterpart of ``_flash_core`` (JAX
    ``ops.py:457``) and its ``_core_bwd`` (``:424``). Forward: the forward
    kernel, saving (q, k, v, o, lse). Backward: the delta pre-pass, then the
    fused kernel; the f32 gradients are cast to the inputs' dtypes. dq is
    with respect to the scaled q: the scale is applied by autograd through
    ``_prep``, which stays outside this Function."""

    @staticmethod
    def forward(ctx, qs, k, v, spec, block_q, block_kv):
        o, lse = _fwd.flash_fwd(qs, k, v, spec, block_q=block_q, block_kv=block_kv)
        ctx.save_for_backward(qs, k, v, o, lse)
        ctx.meta = (spec, block_q, block_kv)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        qs, k, v, o, lse = ctx.saved_tensors
        spec, block_q, block_kv = ctx.meta
        do = do.to(qs.dtype).contiguous()
        delta = _bwd.flash_bwd_delta(o, do)  # Algorithm 2 line 4
        dq, dk, dv = _bwd.flash_bwd_fused(qs, k, v, do, lse, delta, spec,
                                          block_q=block_q, block_kv=block_kv)
        return dq.to(qs.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


def flash_attention_with_lse(
    q, k, v, spec: MaskSpec = MaskSpec(causal=True), *,
    scale: Optional[float] = None,
    block_q: int = BLOCK_Q, block_kv: int = BLOCK_KV, bwd: str = "fused",
):
    """Differentiable FA2. q (B,Sq,Hq,D), k/v (B,Skv,Hkv,D) -> (o (B,Sq,Hq,D),
    lse (B,Hq,Sq) f32; lse carries no gradient). The counterpart of
    ``flash_attention_pallas_with_lse``."""
    _check_bwd(bwd)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashCore.apply(_prep(q, scale), k, v, spec, block_q, block_kv)


def flash_attention(
    q, k, v, spec: MaskSpec = MaskSpec(causal=True), *,
    scale: Optional[float] = None,
    block_q: int = BLOCK_Q, block_kv: int = BLOCK_KV, bwd: str = "fused",
):
    """Differentiable FA2, output only (the counterpart of
    ``flash_attention_pallas``)."""
    return flash_attention_with_lse(
        q, k, v, spec, scale=scale, block_q=block_q, block_kv=block_kv, bwd=bwd
    )[0]


def flash_decode(
    q, k_cache, v_cache, cache_length, *,
    window: Optional[int] = None, sink: int = 0, scale: Optional[float] = None,
    num_splits: int = DEFAULT_DECODE_SPLITS,
):
    """Split-KV decode. q (B,1,Hq,D); caches (B,S,Hkv,D); cache_length (B,)
    valid entries. Returns (o (B,1,Hq,D), lse (B,Hq,1)), the counterpart of
    ``flash_decode_pallas``."""
    if any(t.requires_grad for t in (q, k_cache, v_cache)):
        raise NotImplementedError("split-KV decode is forward-only, as in the JAX package")
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
