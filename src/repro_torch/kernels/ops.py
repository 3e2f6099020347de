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
from repro_torch.kernels.schedule import SCHEDULES, SMS, check_schedule  # noqa: F401 (re-export)

# Split-KV decode fan-out when none is given (the JAX package's fallback
# when its tuned cache has no entry).
DEFAULT_DECODE_SPLITS = 8


# H100 forward tiles (block_q, block_kv), sized for a CTA's 227 KB of shared
# memory (the TPU table sized tiles for 16 MB of VMEM): a forward CTA holds
# two block_q x D Q tiles (one per consumer warpgroup) and four stages of
# block_kv x D K and V tiles, 162 KB at D = 128. 64 q rows per warpgroup (the
# wgmma M) and CTAs of two q tiles keep enough CTAs in flight for a B = 1
# prefill (32 heads x S / 128). The sequence lengths do not enter: the kernel
# masks the ragged edge itself. The CPU path takes any block sizes (the
# parity tests match the JAX kernel's); the CUDA kernel checks
# ``flash_fwd.KERNEL_BLOCKS``, the granularity of its tables.
BLOCK_Q = BLOCK_KV = 64


# Forward partitions (paper Section 3.2), the JAX ``default_forward_partitions``
# (``ops.py:170``) restated for the H100. The TPU deals q tiles into bands
# to fill its cores; here every pair of q tiles is its own CTA on the grid's
# first axis, which does the banding, so only the kv split is left to
# choose. Its rule keeps the JAX form: split the kv axis only when all q
# rows fit one q tile (Sq <= 64 here), there are at least 4 kv tiles, and
# batch * q heads is below the target. The TPU target (64 cells,
# ``ops.py:167``) becomes the number of forward CTAs that fill the card
# once: 132 SMs times the CTAs one SM holds at once. A forward CTA has 384
# threads (a producer and two consumer warpgroups) launched at 168
# registers each (ptxas for sm_90a, ``__launch_bounds__(384, 1)``;
# ``setmaxnreg`` moves them to 24 / 240), 64,512 of the SM's 65,536, so
# one fits at either head dim (shared memory: 82 KB at 64, 162 KB at 128)
# and the target is the same at every head dim.
FWD_CTAS_PER_SM = 1
FWD_TARGET_CTAS = SMS * FWD_CTAS_PER_SM
MIN_SPLIT_KV_TILES = 4


def default_kv_splits(bh: int, t_q: int, t_kv: int) -> int:
    """The kv splits when none is given: ``min(t_kv, floor(FWD_TARGET_CTAS /
    bh))`` in the short-q, long-kv corner (``t_q == 1``, ``t_kv >= 4``,
    ``bh`` below the target), else 1. Splits change the summation order
    (exact up to rounding), so other shapes split only when asked.

    The floor keeps the split CTAs within one wave of the card: a sweep at
    whisper's cross-attention prefill (4 q rows against 1500 frames, head_dim
    64; PERF.md, split sweep on an H100) measured 4 splits at 0.0190 ms
    against 0.0231 for the 5 that the ceiling gave at B = 4 (bh 32), and 16
    at 0.0172 against 0.0207 for 17 at B = 1 (bh 8)."""
    if t_q == 1 and t_kv >= MIN_SPLIT_KV_TILES and bh < FWD_TARGET_CTAS:
        return min(t_kv, FWD_TARGET_CTAS // bh)
    return 1


def check_kv_splits(kv_splits) -> None:
    if kv_splits is not None and (isinstance(kv_splits, bool) or not isinstance(kv_splits, int)
                                  or kv_splits < 1):
        raise ValueError(f"kv_splits must be an int >= 1 (or None for auto), got {kv_splits!r}")


def resolve_kv_splits(kv_splits, q_shape, k_shape, block_q=None, block_kv=None,
                      schedule: str = "compact") -> int:
    """The knob (explicit > auto) -> the concrete kv split count, clamped to
    the kv tile count as the JAX ``_resolve_partitions`` (``ops.py:193``)
    clamps it. Public layouts: q (B, Sq, Hq, D), k (B, Skv, Hkv, D). Under
    the dense schedule, which has no split-KV kernel, an explicit count
    above 1 raises and None resolves to 1, as in the JAX package. Otherwise
    None resolves through :func:`default_kv_splits` at every head dim: the
    split-KV kernel is built wherever the forward is. Each call counts its
    tier on the default metrics registry: ``knobs/flash_cuda/explicit``
    or ``/heuristic`` (the JAX ``count_knob`` at its resolution)."""
    from repro_torch.obs.metrics import count_knob  # here: obs.mfu imports this module

    check_kv_splits(kv_splits)
    check_schedule(schedule)
    count_knob("flash_cuda", "heuristic" if kv_splits is None else "explicit")
    if schedule == "dense":
        if (kv_splits or 1) > 1:
            raise ValueError("kv_splits > 1 requires schedule='compact'")
        return 1
    B, Sq, Hq, _ = q_shape
    t_q = -(-Sq // (block_q or BLOCK_Q))
    t_kv = -(-k_shape[1] // (block_kv or BLOCK_KV))
    ks = kv_splits if kv_splits is not None else default_kv_splits(B * Hq, t_q, t_kv)
    return max(1, min(ks, t_kv))


def _prep(q: torch.Tensor, scale: float) -> torch.Tensor:
    """q pre-scaled in f32 and cast back to its dtype, exactly as the JAX
    wrapper does, so both round the same way."""
    return (q.float() * scale).to(q.dtype)


# Backward modes. "fused" is the one-pass kernel (the JAX default): dq by
# f32 bulk reductions in no fixed order, so not bitwise reproducible. "split" is the deterministic
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
    gradient. With ``kv_splits > 1`` the forward is the split-KV kernel and
    its fold, as the JAX ``_core_fwd`` (``ops.py:399``) folds the partials;
    the backward reads the folded (o, lse) and is unchanged. ``schedule``
    picks the compact or dense form of every kernel but the delta
    pre-pass, forward and backward alike."""

    @staticmethod
    def forward(ctx, qs, k, v, q_seg, kv_seg, spec, block_q, block_kv, bwd, kv_splits=1,
                schedule="compact"):
        o, lse = _forward(qs, k, v, q_seg, kv_seg, spec, block_q, block_kv, kv_splits, schedule)
        ctx.save_for_backward(qs, k, v, o, lse, q_seg, kv_seg)
        ctx.meta = (spec, block_q, block_kv, bwd, schedule)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        qs, k, v, o, lse, q_seg, kv_seg = ctx.saved_tensors
        spec, block_q, block_kv, bwd, schedule = ctx.meta
        do = do.to(qs.dtype).contiguous()
        delta = _bwd.flash_bwd_delta(o, do)  # Algorithm 2 line 4
        args = (qs, k, v, do, lse, delta, spec)
        tiles = dict(block_q=block_q, block_kv=block_kv, schedule=schedule)
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
                None, None, None)


def _forward(qs, k, v, q_seg, kv_seg, spec, block_q, block_kv, kv_splits, schedule="compact"):
    """(o (B, Sq, Hq, D) in q's dtype, lse (B, Hq, Sq) f32): the forward
    kernel of ``schedule``, or with ``kv_splits > 1`` (compact only) the
    split-KV kernel and its fold."""
    tiles = dict(block_q=block_q, block_kv=block_kv)
    if kv_splits == 1:
        if q_seg is None:
            return _fwd.flash_fwd(qs, k, v, spec, schedule=schedule, **tiles)
        return _fwd.flash_fwd_varlen(qs, k, v, spec, q_seg, kv_seg, schedule=schedule, **tiles)
    if q_seg is None:
        out = _fwd.flash_fwd_splitkv(qs, k, v, spec, kv_splits=kv_splits, **tiles)
    else:
        out = _fwd.flash_fwd_splitkv_varlen(qs, k, v, spec, q_seg, kv_seg, kv_splits=kv_splits,
                                            **tiles)
    return out.o, out.lse


def flash_attention_with_lse(
    q, k, v, spec: MaskSpec = MaskSpec(causal=True), *,
    scale: Optional[float] = None,
    block_q: int = BLOCK_Q, block_kv: int = BLOCK_KV, bwd: str = "fused",
    kv_splits: Optional[int] = None, schedule: str = "compact",
):
    """Differentiable FA2. q (B,Sq,Hq,D), k/v (B,Skv,Hkv,D) -> (o (B,Sq,Hq,D),
    lse (B,Hq,Sq) f32; lse carries no gradient). ``bwd`` is one of
    ``BWD_MODES``, ``schedule`` one of ``SCHEDULES``; ``kv_splits`` (None:
    the auto policy of :func:`default_kv_splits`) as
    :func:`resolve_kv_splits` resolves it. The counterpart of
    ``flash_attention_pallas_with_lse``; its ``num_q_bands`` has none,
    since the q tile is already a grid axis."""
    _check_bwd(bwd)
    ks = resolve_kv_splits(kv_splits, q.shape, k.shape, block_q, block_kv, schedule)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashCore.apply(_prep(q, scale), k, v, None, None, spec, block_q, block_kv, bwd, ks,
                            schedule)


def flash_attention(
    q, k, v, spec: MaskSpec = MaskSpec(causal=True), *,
    scale: Optional[float] = None,
    block_q: int = BLOCK_Q, block_kv: int = BLOCK_KV, bwd: str = "fused",
    kv_splits: Optional[int] = None, schedule: str = "compact",
):
    """Differentiable FA2, output only (the counterpart of
    ``flash_attention_pallas``)."""
    return flash_attention_with_lse(
        q, k, v, spec, scale=scale, block_q=block_q, block_kv=block_kv, bwd=bwd,
        kv_splits=kv_splits, schedule=schedule,
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
    kv_splits: Optional[int] = None, schedule: str = "compact",
):
    """Differentiable segment-packed (varlen) FA2, the counterpart of
    ``flash_attention_pallas_varlen`` (JAX ``ops.py:526``). Each batch row
    packs back-to-back sequences; ``segment_ids`` (B, Sq) int marks which
    tokens belong together (or a ``SegmentInfo``), ``kv_segment_ids``
    (B, Skv) defaults to it. Query i attends key j iff their ids match and
    the MaskSpec admits the global positions. Tiles that share no segment
    are skipped in every kernel: under the compact schedule by the step
    bits computed before the launch, under the dense one by the kernel's
    own test of the tiles' id ranges. Returns o (B, Sq, Hq, D)."""
    _check_bwd(bwd)
    ks = resolve_kv_splits(kv_splits, q.shape, k.shape, block_q, block_kv, schedule)
    q_seg, kv_seg = _segment_ids(q, k, segment_ids, kv_segment_ids)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashCore.apply(_prep(q, scale), k, v, q_seg, kv_seg, spec, block_q, block_kv,
                            bwd, ks, schedule)[0]


def flash_attention_varlen_with_lse(
    q, k, v, segment_ids, spec: MaskSpec = MaskSpec(causal=True), *,
    kv_segment_ids=None, scale: Optional[float] = None,
    block_q: int = BLOCK_Q, block_kv: int = BLOCK_KV,
    kv_splits: Optional[int] = None, schedule: str = "compact",
):
    """Forward-only varlen FA2, as the JAX one is (``ops.py:578``): returns
    (o (B, Sq, Hq, D), lse (B, Hq, Sq) f32) and raises on inputs that
    require a gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError("flash_attention_varlen_with_lse is forward-only, as in "
                                  "the JAX package; use flash_attention_varlen to train")
    ks = resolve_kv_splits(kv_splits, q.shape, k.shape, block_q, block_kv, schedule)
    q_seg, kv_seg = _segment_ids(q, k, segment_ids, kv_segment_ids)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _forward(_prep(q, scale), k, v, q_seg, kv_seg, spec, block_q, block_kv, ks,
                    schedule)


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
    num_splits: int = DEFAULT_DECODE_SPLITS, kv_segment_ids=None, q_segment=None,
):
    """Split-KV decode. q (B,1,Hq,D); caches (B,S,Hkv,D); cache_length (B,)
    valid entries. Returns (o (B,1,Hq,D), lse (B,Hq,1)), the counterpart of
    ``flash_decode_pallas``.

    ``kv_segment_ids`` (B, S) and ``q_segment`` (B,) make it packed decode
    (JAX ``ops.py:672``): each query sees only the cache positions of its
    own segment. The JAX wrapper repeats the ids per kv head (``:695``);
    the kernel reads row b's ids for every kv head of b, which is the same."""
    lengths = cache_length.to(device=q.device, dtype=torch.int32).contiguous()
    if (kv_segment_ids is None) != (q_segment is None):
        raise ValueError("packed decode needs both kv_segment_ids (B, S) and q_segment (B,)")
    knobs = dict(num_splits=num_splits, window=window, sink=sink)
    if kv_segment_ids is None:
        return _split_decode(
            "split-KV decode", q, k_cache, v_cache, k_cache.shape[2], scale,
            lambda qh: _dec.flash_decode(qh, k_cache, v_cache, lengths, **knobs))
    B, S = k_cache.shape[:2]
    if tuple(kv_segment_ids.shape) != (B, S) or tuple(q_segment.shape) != (B,):
        raise ValueError(f"kv_segment_ids must be {(B, S)} and q_segment {(B,)}, got "
                         f"{tuple(kv_segment_ids.shape)} and {tuple(q_segment.shape)}")
    kv_seg, q_seg = (x.to(device=q.device, dtype=torch.int32).contiguous()
                     for x in (kv_segment_ids, q_segment))
    return _split_decode(
        "packed decode", q, k_cache, v_cache, k_cache.shape[2], scale,
        lambda qh: _dec.flash_decode_varlen(qh, k_cache, v_cache, lengths, kv_seg, q_seg,
                                            **knobs))


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
