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

from repro_torch.core.masks import MaskSpec, SegmentInfo
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


# Backward modes. "fused" is the one-pass kernel (the JAX default): dq by
# f32 atomics, so not bitwise reproducible. "split" is the deterministic
# mode: the delta pre-pass, then the KV-stationary dK/dV kernel, then the
# Q-stationary dQ kernel, each output written once with no atomics. The JAX
# wrapper also falls back to "split" when the fused kernel's per-q-tile
# delta scratch, O(G * Sq) f32, would not fit in VMEM (``ops._resolve_bwd``);
# here delta is a pre-pass that lives in HBM, so no such budget exists and
# there is no fallback: each mode serves every shape, and the caller chooses.
BWD_MODES = ("fused", "split")


def _check_bwd(bwd: str) -> None:
    if bwd not in BWD_MODES:
        raise ValueError(f"unknown backward mode {bwd!r}; have {BWD_MODES}")


class _FlashCore(torch.autograd.Function):
    """FA2 on pre-scaled q: the counterpart of ``_flash_core`` (JAX
    ``ops.py:457``), ``_flash_core_varlen`` (``:476``) and their
    ``_core_bwd`` (``:424``). Forward: the forward kernel, saving (q, k, v,
    o, lse). Backward: the delta pre-pass, then the fused kernel
    (``bwd="fused"``) or the dK/dV and dQ kernels (``bwd="split"``); the f32
    gradients are cast to the inputs' dtypes. dq is with respect to the
    scaled q: the scale is applied by autograd through ``_prep``, which
    stays outside this Function. With int32 segment ids q_seg (B, Sq) and
    kv_seg (B, Skv) every kernel is its segment variant; the ids carry no
    gradient."""

    @staticmethod
    def forward(ctx, qs, k, v, q_seg, kv_seg, spec, block_q, block_kv, bwd):
        tiles = dict(block_q=block_q, block_kv=block_kv)
        if q_seg is None:
            o, lse = _fwd.flash_fwd(qs, k, v, spec, **tiles)
        else:
            o, lse = _fwd.flash_fwd_varlen(qs, k, v, spec, q_seg, kv_seg, **tiles)
        ctx.save_for_backward(qs, k, v, o, lse, q_seg, kv_seg)
        ctx.meta = (spec, block_q, block_kv, bwd)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        qs, k, v, o, lse, q_seg, kv_seg = ctx.saved_tensors
        spec, block_q, block_kv, bwd = ctx.meta
        do = do.to(qs.dtype).contiguous()
        delta = _bwd.flash_bwd_delta(o, do)  # Algorithm 2 line 4
        args = (qs, k, v, do, lse, delta, spec)
        tiles = dict(block_q=block_q, block_kv=block_kv)
        if q_seg is not None:
            args += (q_seg, kv_seg)
            fused, dkv, dq_fn = (_bwd.flash_bwd_fused_varlen, _bwd.flash_bwd_dkv_varlen,
                                 _bwd.flash_bwd_dq_varlen)
        else:
            fused, dkv, dq_fn = _bwd.flash_bwd_fused, _bwd.flash_bwd_dkv, _bwd.flash_bwd_dq
        if bwd == "fused":
            dq, dk, dv = fused(*args, **tiles)
        else:
            dk, dv = dkv(*args, **tiles)
            dq = dq_fn(*args, **tiles)
        return (dq.to(qs.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None, None,
                None)


def flash_attention_with_lse(
    q, k, v, spec: MaskSpec = MaskSpec(causal=True), *,
    scale: Optional[float] = None,
    block_q: int = BLOCK_Q, block_kv: int = BLOCK_KV, bwd: str = "fused",
):
    """Differentiable FA2. q (B,Sq,Hq,D), k/v (B,Skv,Hkv,D) -> (o (B,Sq,Hq,D),
    lse (B,Hq,Sq) f32; lse carries no gradient). ``bwd`` is one of
    ``BWD_MODES``. The counterpart of ``flash_attention_pallas_with_lse``."""
    _check_bwd(bwd)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashCore.apply(_prep(q, scale), k, v, None, None, spec, block_q, block_kv, bwd)


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


def _segment_ids(q, k, segment_ids, kv_segment_ids):
    """(q ids, kv ids) as contiguous int32 on q's device, from raw ids or a
    ``SegmentInfo``; kv ids default to q's. Shapes checked as the JAX
    wrapper asserts them (``ops.py:558``)."""
    if isinstance(segment_ids, SegmentInfo):
        segment_ids, kv_segment_ids = segment_ids.q, segment_ids.kv
    if kv_segment_ids is None:
        kv_segment_ids = segment_ids
    if tuple(segment_ids.shape) != tuple(q.shape[:2]):
        raise ValueError(f"segment_ids {tuple(segment_ids.shape)} must be q's (B, Sq) "
                         f"{tuple(q.shape[:2])}")
    if tuple(kv_segment_ids.shape) != tuple(k.shape[:2]):
        raise ValueError(f"kv_segment_ids {tuple(kv_segment_ids.shape)} must be k's (B, Skv) "
                         f"{tuple(k.shape[:2])}")
    return tuple(x.to(device=q.device, dtype=torch.int32).contiguous()
                 for x in (segment_ids, kv_segment_ids))


def flash_attention_varlen(
    q, k, v, segment_ids, spec: MaskSpec = MaskSpec(causal=True), *,
    kv_segment_ids=None, scale: Optional[float] = None,
    block_q: int = BLOCK_Q, block_kv: int = BLOCK_KV, bwd: str = "fused",
):
    """Differentiable segment-packed (varlen) FA2, the counterpart of
    ``flash_attention_pallas_varlen`` (JAX ``ops.py:526``). Each batch row
    packs back-to-back sequences; ``segment_ids`` (B, Sq) int marks which
    tokens belong together (or a ``SegmentInfo``), ``kv_segment_ids``
    (B, Skv) defaults to it. Query i attends key j iff their ids match and
    the MaskSpec admits the global positions. Tiles that share no segment
    are skipped in every kernel. Returns o (B, Sq, Hq, D)."""
    _check_bwd(bwd)
    q_seg, kv_seg = _segment_ids(q, k, segment_ids, kv_segment_ids)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashCore.apply(_prep(q, scale), k, v, q_seg, kv_seg, spec, block_q, block_kv,
                            bwd)[0]


def flash_attention_varlen_with_lse(
    q, k, v, segment_ids, spec: MaskSpec = MaskSpec(causal=True), *,
    kv_segment_ids=None, scale: Optional[float] = None,
    block_q: int = BLOCK_Q, block_kv: int = BLOCK_KV,
):
    """Forward-only varlen FA2, as the JAX one is (``ops.py:578``): returns
    (o (B, Sq, Hq, D), lse (B, Hq, Sq) f32) and raises on inputs that
    require a gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError("flash_attention_varlen_with_lse is forward-only, as in "
                                  "the JAX package; use flash_attention_varlen to train")
    q_seg, kv_seg = _segment_ids(q, k, segment_ids, kv_segment_ids)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _fwd.flash_fwd_varlen(_prep(q, scale), k, v, spec, q_seg, kv_seg,
                                 block_q=block_q, block_kv=block_kv)


def _split_decode(what, q, k, v, Hk, scale, run):
    """The common frame of the decode kernels: q pre-scaled and laid out
    (B*Hkv, G, D), ``run(qh)`` for the per-split partials, the split merge.
    Returns (o (B,1,Hq,D), lse (B,Hq,1))."""
    if any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(f"{what} is forward-only, as in the JAX package")
    B, one, Hq, D = q.shape
    if one != 1:
        raise ValueError(f"{what} is a single-token step; q must be (B, 1, Hq, D)")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    qh = _prep(q, scale).reshape(B * Hk, Hq // Hk, D).contiguous()
    o_parts, lse_parts = run(qh)
    o, lse = combine_lse_outputs(o_parts.movedim(1, 0), lse_parts.movedim(1, 0))
    return o.reshape(B, 1, Hq, D).to(q.dtype), lse.reshape(B, Hq, 1)


def flash_decode(
    q, k_cache, v_cache, cache_length, *,
    window: Optional[int] = None, sink: int = 0, scale: Optional[float] = None,
    num_splits: int = DEFAULT_DECODE_SPLITS,
):
    """Split-KV decode. q (B,1,Hq,D); caches (B,S,Hkv,D); cache_length (B,)
    valid entries. Returns (o (B,1,Hq,D), lse (B,Hq,1)), the counterpart of
    ``flash_decode_pallas``."""
    lengths = cache_length.to(device=q.device, dtype=torch.int32).contiguous()
    return _split_decode(
        "split-KV decode", q, k_cache, v_cache, k_cache.shape[2], scale,
        lambda qh: _dec.flash_decode(qh, k_cache, v_cache, lengths, num_splits=num_splits,
                                     window=window, sink=sink),
    )


def flash_decode_paged(
    q, k_pages, v_pages, cache_length, block_table, *,
    window: Optional[int] = None, sink: int = 0, scale: Optional[float] = None,
    num_splits: int = DEFAULT_DECODE_SPLITS,
):
    """Page-indirect split-KV decode. q (B,1,Hq,D); k/v_pages (Hkv,P,ps,D)
    pool planes; cache_length (B,) logical lengths; block_table (B, n_pages)
    int32 physical page ids (0 = the null page). Returns (o (B,1,Hq,D),
    lse (B,Hq,1)), the counterpart of ``flash_decode_paged_pallas``."""
    lengths = cache_length.to(device=q.device, dtype=torch.int32).contiguous()
    table = block_table.to(device=q.device, dtype=torch.int32).contiguous()
    return _split_decode(
        "paged decode", q, k_pages, v_pages, k_pages.shape[0], scale,
        lambda qh: _dec.flash_decode_paged(qh, k_pages, v_pages, lengths, table,
                                           num_splits=num_splits, window=window, sink=sink),
    )
