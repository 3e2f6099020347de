"""FlashAttention-2 as a blocked PyTorch program: ``impl="flash_torch"``.

The counterpart of ``repro/core/flash.py`` (``impl="flash_xla"`` there,
``lax.scan`` over tiles): the paper's algorithm written out tile by tile in
eager PyTorch, independent of the CUDA kernels in ``repro_torch.kernels``.
It is the port's algorithmic reproduction and a baseline beside them; on
the card every tile step is a handful of library calls, not one kernel.

  * C1a -- the output accumulator stays un-rescaled through the KV loop and
    is divided by ``l`` once at the end (``_finalize``).
  * C1b -- only the logsumexp ``L = m + log(l)`` is kept for the backward,
    which recomputes ``P = exp(S - L)`` (Algorithm 2, line 11).
  * C2 -- causal/window block skipping: in ``packed`` mode the loop visits
    only the visible (q tile, kv tile) pairs, interior tiles first without
    a mask, then boundary tiles with it (Section 3.1).
  * The backward is Algorithm 2 (five products per tile, recompute from the
    LSE). dQ accumulates in a carried f32 buffer, updated in place by tile
    index where the JAX scan carries it (the TPU adaptation of the paper's
    atomic adds).

Numerics follow the JAX program: q is pre-scaled in f32 and cast back to
the input dtype; P is cast to v's dtype before P V; dS is cast to the input
dtype before both of its products; every product accumulates in f32 (the
operands are widened to f32, as ``preferred_element_type=float32`` does);
a row that sees no key gets lse = -inf, which the backward maps to 0.

Layout: q (B, Sq, Hq, D); k, v (B, Skv, Hkv, D) with Hq % Hkv == 0; the
output (B, Sq, Hq, D) in q's dtype and lse (B, Hq, Sq) f32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.masks import (
    DEFAULT_MASK_VALUE,
    MaskSpec,
    SegmentInfo,
    make_segment_mask,
    make_tile_mask,
    pad_segments,
    segment_tile_visibility,
    tile_visibility,
)

MODES = ("auto", "dense", "packed")
# The tile size where none is given (JAX ``attention.py:104``: the XLA scan
# path's fixed 512).
DEFAULT_BLOCK = 512


@dataclasses.dataclass(frozen=True)
class FlashConfig:
    spec: MaskSpec = MaskSpec()
    block_q: int = DEFAULT_BLOCK
    block_kv: int = DEFAULT_BLOCK
    mode: str = "auto"  # 'dense' | 'packed' | 'auto'
    scale: Optional[float] = None  # default 1/sqrt(D)

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown tile mode {self.mode!r}; have {MODES}")

    def resolve_mode(self, t_q: int, t_kv: int) -> str:
        """'auto' takes 'packed' where the visible tile pairs are at most
        0.75 of all (packing pays a gather and a scatter per tile)."""
        if self.mode != "auto":
            return self.mode
        if self.spec.is_trivial:
            return "dense"
        pairs = _visible_pairs(self.spec, t_q, t_kv, self.block_q, self.block_kv)
        return "packed" if len(pairs[0]) <= 0.75 * t_q * t_kv else "dense"


# ---------------------------------------------------------------------------
# Tile schedules (numpy, exact: the same integers as the JAX package)
# ---------------------------------------------------------------------------


def _visible_pairs(spec: MaskSpec, t_q: int, t_kv: int, bq: int, bk: int, segments=None):
    """(i, j) tile pairs that are not fully masked, row-major, as int32
    arrays. ``segments``: concrete segment ids, one (Sq,) vector (packed
    self-attention) or a (q_segs, kv_segs) pair; a tile whose every (q, kv)
    pair crosses a segment boundary is dropped too."""
    q_segs = kv_segs = None
    if segments is not None:
        if isinstance(segments, tuple):
            q_segs, kv_segs = np.asarray(segments[0]), np.asarray(segments[1])
        else:
            q_segs = kv_segs = np.asarray(segments)
    ii, jj = [], []
    for i in range(t_q):
        q_lo = i * bq + spec.q_offset
        for j in range(t_kv):
            if tile_visibility(spec, q_lo, q_lo + bq, j * bk, j * bk + bk) == "empty":
                continue
            if q_segs is not None and segment_tile_visibility(
                    q_segs, kv_segs, i * bq, i * bq + bq, j * bk, j * bk + bk) == "empty":
                continue  # segment positions are layout-local (no q_offset)
            ii.append(i)
            jj.append(j)
    return np.asarray(ii, np.int32), np.asarray(jj, np.int32)


def _classified_pairs(spec: MaskSpec, t_q: int, t_kv: int, bq: int, bk: int, sk: int):
    """Visible pairs split into interior (fully visible, the mask apply is
    skipped) and boundary (partial, or touching KV padding):
    ((ii_f, jj_f), (ii_p, jj_p))."""
    f_ii, f_jj, p_ii, p_jj = [], [], [], []
    for i in range(t_q):
        q_lo = i * bq + spec.q_offset
        for j in range(t_kv):
            vis = tile_visibility(spec, q_lo, q_lo + bq, j * bk, j * bk + bk)
            if vis == "empty":
                continue
            if vis == "full" and (j + 1) * bk <= sk:
                f_ii.append(i)
                f_jj.append(j)
            else:
                p_ii.append(i)
                p_jj.append(j)
    return (
        (np.asarray(f_ii, np.int32), np.asarray(f_jj, np.int32)),
        (np.asarray(p_ii, np.int32), np.asarray(p_jj, np.int32)),
    )


def _pairs(spec: MaskSpec, bl: dict, segmented: bool):
    """The packed mode's two lists: (interior, boundary). With segments every
    kept tile needs the element mask, so all go through the masked list."""
    if segmented:
        empty = np.asarray([], np.int32)
        return (empty, empty), _visible_pairs(spec, bl["t_q"], bl["t_kv"], bl["bq"], bl["bk"])
    return _classified_pairs(spec, bl["t_q"], bl["t_kv"], bl["bq"], bl["bk"], bl["Sk"])


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------


def _pad_axis(x: torch.Tensor, axis: int, block: int) -> torch.Tensor:
    pad = (-x.shape[axis]) % block
    if not pad:
        return x
    widths = [0, 0] * (x.ndim - axis - 1) + [0, pad]
    return F.pad(x, widths)


def _blocked(q, k, v, cfg: FlashConfig) -> dict:
    """q (B, Hk, G, Sqp, D) pre-scaled, k/v (B, Hk, Skp, D), padded to whole
    tiles, with the shapes and tile counts."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hk, _ = k.shape
    if Hq % Hk:
        raise ValueError(f"GQA requires Hq % Hkv == 0, got {Hq} % {Hk}")
    G = Hq // Hk
    scale = cfg.scale if cfg.scale is not None else 1.0 / math.sqrt(D)
    bq = min(cfg.block_q, max(Sq, 1))
    bk = min(cfg.block_kv, max(Sk, 1))
    qt = _pad_axis(q.reshape(B, Sq, Hk, G, D).permute(0, 2, 3, 1, 4), 3, bq)
    kt = _pad_axis(k.transpose(1, 2), 2, bk)
    vt = _pad_axis(v.transpose(1, 2), 2, bk)
    # Pre-scale q (O(N d) multiplies instead of O(N^2)), rounded to the input
    # dtype as the JAX program rounds it.
    qt = (qt.float() * scale).to(q.dtype)
    return dict(q=qt, k=kt, v=vt, B=B, Sq=Sq, Sk=Sk, Hq=Hq, Hk=Hk, G=G, D=D, bq=bq, bk=bk,
                t_q=qt.shape[3] // bq, t_kv=kt.shape[2] // bk, pad_k=kt.shape[2] - Sk,
                scale=scale)


def _blocked_segments(q_seg, kv_seg, bl):
    return pad_segments(q_seg, kv_seg, bl["q"].shape[3], bl["k"].shape[2])


def _seg_tile_mask(q_segs, kv_segs):
    """(B, X) x (B, Y) -> (B, 1, 1, X, Y): broadcasts over (Hk, G)."""
    return make_segment_mask(q_segs, kv_segs)[:, None, None]


def _and(a, b):
    return b if a is None else a & b


def _mask(spec: MaskSpec, bl: dict, segs, rows: slice, j: int):
    """The element mask of q rows ``rows`` (padded positions) against kv tile
    j: the spec's, the KV padding's (where there is any) and the segment
    ids' (with ``segs``), or None where nothing is masked."""
    bk, dev = bl["bk"], bl["q"].device
    q_ids = torch.arange(rows.start, rows.stop, dtype=torch.int32, device=dev) + spec.q_offset
    kv_ids = j * bk + torch.arange(bk, dtype=torch.int32, device=dev)
    mask = make_tile_mask(spec, q_ids, kv_ids)
    if bl["pad_k"]:
        mask = _and(mask, (kv_ids < bl["Sk"])[None, :])
    if segs is not None:
        mask = _and(mask, _seg_tile_mask(segs[0][:, rows], segs[1][:, j * bk:(j + 1) * bk]))
    return mask


def _pair_mask(spec: MaskSpec, bl: dict, segs, i: int, j: int):
    """The mask of tile pair (i, j) (the packed mode)."""
    return _mask(spec, bl, segs, slice(i * bl["bq"], (i + 1) * bl["bq"]), j)


def _column_mask(spec: MaskSpec, bl: dict, segs, j: int):
    """The mask of every q row against kv tile j (the dense mode)."""
    return _mask(spec, bl, segs, slice(0, bl["q"].shape[3]), j)


def _mm(eq: str, a, b):
    """An einsum accumulated in f32 with f32 output (the operands widened
    exactly, as the JAX program's ``preferred_element_type=float32``)."""
    return torch.einsum(eq, a.float(), b.float())


def _update(m, l, acc, s, v_blk, mask, p_dtype):
    """One online-softmax tile update (FA2 Algorithm 1, lines 8-10)."""
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, DEFAULT_MASK_VALUE))
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.where(torch.isneginf(m), torch.zeros_like(m), torch.exp(m - m_new))
    p = torch.exp(s - m_new[..., None])
    l_new = l * alpha + p.sum(dim=-1)
    acc_new = acc * alpha[..., None] + _mm("bhgqk,bhkd->bhgqd", p.to(p_dtype), v_blk)
    return m_new, l_new, acc_new


def _finalize(m, l, acc):
    """C1a: the single end-of-loop rescale by diag(l)^-1, and the LSE."""
    empty = l == 0.0
    l_safe = torch.where(empty, torch.ones_like(l), l)
    lse = torch.where(empty, torch.full_like(m, float("-inf")), m + torch.log(l_safe))
    return acc / l_safe[..., None], lse


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _fwd(q, k, v, cfg: FlashConfig, q_seg=None, kv_seg=None):
    bl = _blocked(q, k, v, cfg)
    segs = None if q_seg is None else _blocked_segments(q_seg, kv_seg, bl)
    if cfg.resolve_mode(bl["t_q"], bl["t_kv"]) == "packed":
        o, lse = _fwd_packed(bl, cfg, segs)
    else:
        o, lse = _fwd_dense(bl, cfg, segs)
    B, Sq, Hq, D = bl["B"], bl["Sq"], bl["Hq"], bl["D"]
    o = o[:, :, :, :Sq].permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D).to(q.dtype)
    return o, lse[:, :, :, :Sq].reshape(B, Hq, Sq)


def _fwd_dense(bl, cfg: FlashConfig, segs=None):
    """Every kv tile against the whole (padded) q: one loop over kv tiles."""
    B, Hk, G, Sqp, D = bl["q"].shape
    bk, t_kv, dev = bl["bk"], bl["t_kv"], bl["q"].device
    m = torch.full((B, Hk, G, Sqp), float("-inf"), device=dev)
    l = torch.zeros((B, Hk, G, Sqp), device=dev)
    acc = torch.zeros((B, Hk, G, Sqp, D), device=dev)
    for j in range(t_kv):
        k_j, v_j = bl["k"][:, :, j * bk:(j + 1) * bk], bl["v"][:, :, j * bk:(j + 1) * bk]
        s = _mm("bhgqd,bhkd->bhgqk", bl["q"], k_j)
        m, l, acc = _update(m, l, acc, s, v_j, _column_mask(cfg.spec, bl, segs, j),
                            bl["v"].dtype)
    return _finalize(m, l, acc)


def _fwd_packed(bl, cfg: FlashConfig, segs=None):
    """Triangular tile packing: the loop visits only the visible (i, j)
    pairs, interior ones first without a mask, then boundary ones with it
    (the online-softmax combine is order-independent). The carried state
    holds (m, l, acc) of every q tile, O(N d) like the output; each step
    updates tile i's state in place."""
    B, Hk, G, Sqp, D = bl["q"].shape
    bq, bk, t_q, dev = bl["bq"], bl["bk"], bl["t_q"], bl["q"].device
    spec = cfg.spec
    interior, boundary = _pairs(spec, bl, segs is not None)
    m = torch.full((t_q, B, Hk, G, bq), float("-inf"), device=dev)
    l = torch.zeros((t_q, B, Hk, G, bq), device=dev)
    acc = torch.zeros((t_q, B, Hk, G, bq, D), device=dev)
    for (ii, jj), masked in ((interior, False), (boundary, True)):
        for i, j in zip(ii.tolist(), jj.tolist()):
            q_i = bl["q"][:, :, :, i * bq:(i + 1) * bq]
            k_j, v_j = bl["k"][:, :, j * bk:(j + 1) * bk], bl["v"][:, :, j * bk:(j + 1) * bk]
            s = _mm("bhgqd,bhkd->bhgqk", q_i, k_j)
            mask = _pair_mask(spec, bl, segs, i, j) if masked else None
            m[i], l[i], acc[i] = _update(m[i], l[i], acc[i], s, v_j, mask, bl["v"].dtype)
    return _finalize(m.permute(1, 2, 3, 0, 4).reshape(B, Hk, G, Sqp),
                     l.permute(1, 2, 3, 0, 4).reshape(B, Hk, G, Sqp),
                     acc.permute(1, 2, 3, 0, 4, 5).reshape(B, Hk, G, Sqp, D))


# ---------------------------------------------------------------------------
# Backward: the paper's Algorithm 2 over the same tile schedule.
# ---------------------------------------------------------------------------


def _bwd_rows(bl, x, Hn):
    """(B, S, Hn, D) -> (B, Hk, G, Sqp, D) f32, padded to whole q tiles."""
    B, S, _, D = x.shape
    y = x.reshape(B, S, bl["Hk"], Hn // bl["Hk"], D).permute(0, 2, 3, 1, 4)
    return _pad_axis(y, 3, bl["bq"]).float()


def _bwd_stats(bl, o, lse, do):
    """dO (f32, blocked), delta = rowsum(dO o O) (Algorithm 2, line 4) and
    the LSE blocked with -inf (rows that saw no key) mapped to 0."""
    do_b = _bwd_rows(bl, do, bl["Hq"])
    delta = (do_b * _bwd_rows(bl, o, bl["Hq"])).sum(dim=-1)
    lse_b = _pad_axis(lse.reshape(bl["B"], bl["Hk"], bl["G"], bl["Sq"]), 3, bl["bq"])
    lse_b = torch.where(torch.isneginf(lse_b), torch.zeros_like(lse_b), lse_b)
    return do_b, delta, lse_b


def _tile_grads(s, mask, q_i, k_j, v_j, do_i, lse_i, dl_i, in_dtype):
    """Algorithm 2, lines 11-16, on one tile of scaled scores ``s``:
    (dq_i, dk_j, dv_j) in f32, dq_i still without the scale."""
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, DEFAULT_MASK_VALUE))
    p = torch.exp(s - lse_i[..., None])  # line 11: recompute from the LSE only
    dv_j = _mm("bhgqk,bhgqd->bhkd", p, do_i)  # line 12 (sums the GQA group)
    dp = _mm("bhgqd,bhkd->bhgqk", do_i, v_j)  # line 13
    ds = (p * (dp - dl_i[..., None])).to(in_dtype)  # line 14
    dq_i = _mm("bhgqk,bhkd->bhgqd", ds, k_j)  # line 15
    dk_j = _mm("bhgqk,bhgqd->bhkd", ds, q_i)  # line 16 (q pre-scaled)
    return dq_i, dk_j, dv_j


def _from_rows(bl, x, dtype):
    """(B, Hk, G, Sqp, D) -> (B, Sq, Hq, D) in ``dtype``, dQ's scale applied."""
    y = x[:, :, :, :bl["Sq"]].permute(0, 3, 1, 2, 4).reshape(bl["B"], bl["Sq"], bl["Hq"], bl["D"])
    return (y * bl["scale"]).to(dtype)


def _from_kv(bl, x, dtype):
    """(B, Hk, Skp, D) -> (B, Sk, Hk, D) in ``dtype``."""
    return x[:, :, :bl["Sk"]].transpose(1, 2).to(dtype)


def _bwd_dense_unblocked(bl, q, k, v, o, lse, do, cfg: FlashConfig, segs=None):
    """Algorithm 2 with the KV loop outer and Q whole: the same five products
    a tile; dQ accumulates in a carried f32 buffer, dK_j and dV_j are each
    kv tile's own."""
    B, Hk, G, Sqp, D = bl["q"].shape
    bk, t_kv, dev = bl["bk"], bl["t_kv"], bl["q"].device
    do_b, delta, lse_b = _bwd_stats(bl, o, lse, do)
    dq = torch.zeros((B, Hk, G, Sqp, D), device=dev)
    dk = torch.empty(bl["k"].shape, device=dev)
    dv = torch.empty(bl["v"].shape, device=dev)
    for j in range(t_kv):
        cols = slice(j * bk, (j + 1) * bk)
        k_j, v_j = bl["k"][:, :, cols], bl["v"][:, :, cols]
        s = _mm("bhgqd,bhkd->bhgqk", bl["q"], k_j)
        dq_j, dk[:, :, cols], dv[:, :, cols] = _tile_grads(
            s, _column_mask(cfg.spec, bl, segs, j), bl["q"], k_j, v_j, do_b, lse_b, delta,
            q.dtype)
        dq += dq_j
    return _from_rows(bl, dq, q.dtype), _from_kv(bl, dk, k.dtype), _from_kv(bl, dv, v.dtype)


def _bwd_impl(q, k, v, o, lse, do, cfg: FlashConfig, q_seg=None, kv_seg=None):
    """(dq, dk, dv) in the inputs' dtypes. The packed mode walks the forward's
    pairs, interior first, and adds each tile's dQ_i, dK_j and dV_j into
    carried f32 buffers by tile index; the dense mode is
    :func:`_bwd_dense_unblocked`."""
    bl = _blocked(q, k, v, cfg)  # bl["q"] is pre-scaled
    segs = None if q_seg is None else _blocked_segments(q_seg, kv_seg, bl)
    if cfg.resolve_mode(bl["t_q"], bl["t_kv"]) != "packed":
        return _bwd_dense_unblocked(bl, q, k, v, o, lse, do, cfg, segs)
    bq, bk, dev = bl["bq"], bl["bk"], bl["q"].device
    spec = cfg.spec
    interior, boundary = _pairs(spec, bl, segs is not None)
    do_b, delta, lse_b = _bwd_stats(bl, o, lse, do)
    dq = torch.zeros(bl["q"].shape, device=dev)
    dk = torch.zeros(bl["k"].shape, device=dev)
    dv = torch.zeros(bl["v"].shape, device=dev)
    for (ii, jj), masked in ((interior, False), (boundary, True)):
        for i, j in zip(ii.tolist(), jj.tolist()):
            rows, cols = slice(i * bq, (i + 1) * bq), slice(j * bk, (j + 1) * bk)
            q_i, k_j, v_j = bl["q"][:, :, :, rows], bl["k"][:, :, cols], bl["v"][:, :, cols]
            s = _mm("bhgqd,bhkd->bhgqk", q_i, k_j)  # q pre-scaled: scaled scores
            mask = _pair_mask(spec, bl, segs, i, j) if masked else None
            dq_i, dk_j, dv_j = _tile_grads(s, mask, q_i, k_j, v_j, do_b[:, :, :, rows],
                                           lse_b[..., rows], delta[..., rows], q.dtype)
            dq[:, :, :, rows] += dq_i
            dk[:, :, cols] += dk_j
            dv[:, :, cols] += dv_j
    # dS was taken against the scaled scores: dq is d/d(q * scale), so it
    # takes the scale once here; dk already has it through the pre-scaled q.
    return _from_rows(bl, dq, q.dtype), _from_kv(bl, dk, k.dtype), _from_kv(bl, dv, v.dtype)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


class _Flash(torch.autograd.Function):
    """The forward keeps only q, k, v, o, lse and the segment ids (memory
    O(N)); the backward is :func:`_bwd_impl`, never autograd through the
    forward's loop."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, cfg):
        with torch.no_grad():
            o, lse = _fwd(q, k, v, cfg, q_seg, kv_seg)
        ctx.save_for_backward(q, k, v, o, lse, q_seg, kv_seg)
        ctx.cfg = cfg
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, q_seg, kv_seg = ctx.saved_tensors
        with torch.no_grad():
            dq, dk, dv = _bwd_impl(q, k, v, o, lse, do, ctx.cfg, q_seg, kv_seg)
        return dq, dk, dv, None, None, None  # integer segment ids carry no gradient


def _segments(segment_ids, kv_segment_ids):
    if segment_ids is None:
        return None, None
    if isinstance(segment_ids, SegmentInfo):
        segment_ids, kv_segment_ids = segment_ids.q, segment_ids.kv
    if kv_segment_ids is None:
        kv_segment_ids = segment_ids
    return segment_ids.to(torch.int32), kv_segment_ids.to(torch.int32)


def _config(spec, block_q, block_kv, mode, scale) -> FlashConfig:
    return FlashConfig(spec=spec, block_q=block_q or DEFAULT_BLOCK,
                       block_kv=block_kv or DEFAULT_BLOCK, mode=mode, scale=scale)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    spec: MaskSpec = MaskSpec(causal=True),
    *,
    scale: Optional[float] = None,
    block_q: Optional[int] = None,
    block_kv: Optional[int] = None,
    mode: str = "auto",
    segment_ids=None,
    kv_segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Differentiable FlashAttention-2 (blocked PyTorch). q (B, Sq, Hq, D);
    k/v (B, Skv, Hkv, D), GQA. ``block_q`` / ``block_kv`` None take
    DEFAULT_BLOCK.

    ``segment_ids`` (B, Sq) int (or a SegmentInfo) turns on packed varlen
    semantics: query i sees key j only within its segment;
    ``kv_segment_ids`` defaults to ``segment_ids``."""
    cfg = _config(spec, block_q, block_kv, mode, scale)
    q_seg, kv_seg = _segments(segment_ids, kv_segment_ids)
    return _Flash.apply(q, k, v, q_seg, kv_seg, cfg)


def flash_attention_with_lse(
    q, k, v, spec: MaskSpec = MaskSpec(causal=True), *, scale=None,
    block_q: Optional[int] = None, block_kv: Optional[int] = None, mode: str = "auto",
    segment_ids=None, kv_segment_ids=None,
):
    """Forward only (serving, comparisons): returns (o, lse)."""
    cfg = _config(spec, block_q, block_kv, mode, scale)
    q_seg, kv_seg = _segments(segment_ids, kv_segment_ids)
    with torch.no_grad():
        return _fwd(q, k, v, cfg, q_seg, kv_seg)
