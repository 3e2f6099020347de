"""Attention mask specifications and tile classification.

The counterpart of ``repro/core/masks.py``. Masks are symbolic (causal
flag, window, sink, query offset) so that a kernel can decide per tile
whether it is fully visible (no mask applied), partially visible (apply the
element mask) or fully hidden (never visited) -- the paper's causal block
skipping, Section 3.1. Packed (varlen) rows add segment ids: a query sees
a key only inside its own segment (``SegmentInfo`` and the helpers beside
it).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = float("-inf")
# Large-but-finite mask value used inside the kernels: subtracting a true
# -inf can produce NaN via (-inf) - (-inf) in the running-max update when a
# whole row is masked. The same constant as the JAX package (0.7 * f32 max).
DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


@dataclasses.dataclass(frozen=True)
class MaskSpec:
    """Symbolic attention mask.

    Attributes:
      causal: apply a causal (lower triangular) mask.
      window: if set, sliding-window attention -- query i sees keys in
        (i - window, i]. Implies causal when ``causal`` is True; a
        non-causal window masks |i - j| >= window.
      q_offset: absolute position of the first query row relative to the
        first key row.
      sink: number of always-visible prefix keys; the flag matters only to
        *window* masking.
    """

    causal: bool = False
    window: Optional[int] = None
    q_offset: int = 0
    sink: int = 0

    @property
    def is_trivial(self) -> bool:
        return not self.causal and self.window is None


FULL = MaskSpec(causal=False)
CAUSAL = MaskSpec(causal=True)


class SegmentInfo(NamedTuple):
    """Per-token segment ids for packed (varlen) attention (JAX
    ``masks.py:65``): query i attends key j only when ``q[.., i] ==
    kv[.., j]``, on top of what the MaskSpec admits on global positions
    (with contiguous packing, global causality is within-segment causality).
    Ids are non-negative ints, constant within a segment; id 0 is the data
    pipeline's padding segment."""

    q: torch.Tensor   # (B, Sq) int32
    kv: torch.Tensor  # (B, Skv) int32

    @classmethod
    def packed(cls, segment_ids: torch.Tensor) -> "SegmentInfo":
        """Self-attention over one packed layout: q and kv share the ids."""
        return cls(q=segment_ids, kv=segment_ids)


def make_segment_mask(q_segs: torch.Tensor, kv_segs: torch.Tensor) -> torch.Tensor:
    """(.., Sq) x (.., Skv) -> (.., Sq, Skv) bool; True = same segment."""
    return q_segs[..., :, None] == kv_segs[..., None, :]


# Padding sentinels of block-padded segment ids: they never equal a real
# (non-negative) id nor each other, so padded tiles are cross-segment and
# padded q rows attend nothing. The JAX package's values.
Q_PAD_SEGMENT = -2
KV_PAD_SEGMENT = -1


def pad_segments(q_seg: torch.Tensor, kv_seg: torch.Tensor, Sqp: int, Skp: int):
    """Pad (.., Sq) / (.., Skv) segment ids to the blocked lengths with the
    sentinels above, as int32."""
    qs, ks = q_seg.to(torch.int32), kv_seg.to(torch.int32)
    if Sqp > qs.shape[-1]:
        qs = F.pad(qs, (0, Sqp - qs.shape[-1]), value=Q_PAD_SEGMENT)
    if Skp > ks.shape[-1]:
        ks = F.pad(ks, (0, Skp - ks.shape[-1]), value=KV_PAD_SEGMENT)
    return qs, ks


def segment_positions(segment_ids: torch.Tensor) -> torch.Tensor:
    """Within-segment positions of a packed row: (B, S) -> (B, S) int32.

    The position restarts at 0 at every segment boundary (RoPE in packed
    mode: each document sees positions 0..len-1). Assumes contiguous
    packing. The running maximum of the start indices is a ``cummax``
    where the JAX package takes an associative scan."""
    S = segment_ids.shape[-1]
    idx = torch.arange(S, dtype=torch.int32, device=segment_ids.device)
    starts = torch.ones_like(segment_ids, dtype=torch.bool)
    starts[..., 1:] = segment_ids[..., 1:] != segment_ids[..., :-1]
    start_idx = torch.where(starts, idx, torch.zeros_like(idx))
    return idx - torch.cummax(start_idx, dim=-1).values


def segment_tile_visibility(q_segs, kv_segs, q_lo: int, q_hi: int, kv_lo: int,
                            kv_hi: int) -> str:
    """Classification of a tile by segment ids alone: 'full' | 'partial' |
    'empty' (host-side accounting; the kernels decide the same from the
    per-tile id ranges). Ids are 1-D numpy-convertible vectors; positions
    half-open as in :func:`tile_visibility`."""
    qs = np.asarray(q_segs)[q_lo:q_hi]
    ks = np.asarray(kv_segs)[kv_lo:kv_hi]
    if qs.size == 0 or ks.size == 0:
        return "empty"
    eq = qs[:, None] == ks[None, :]
    if not eq.any():
        return "empty"
    return "full" if eq.all() else "partial"


def make_tile_mask(
    spec: MaskSpec, q_ids: torch.Tensor, kv_ids: torch.Tensor
) -> Optional[torch.Tensor]:
    """(Bq, Bc) bool visibility mask from absolute row/col ids (True =
    visible), or None when the spec masks nothing."""
    if spec.is_trivial:
        return None
    qi = q_ids[:, None]
    kj = kv_ids[None, :]
    if spec.causal:
        mask = qi >= kj
        if spec.window is not None:
            in_win = (qi - kj) < spec.window
            if spec.sink:
                in_win = in_win | (kj < spec.sink)
            mask = mask & in_win
        return mask
    in_win = (qi - kj).abs() < spec.window
    if spec.sink:
        in_win = in_win | (kj < spec.sink)
    return in_win


def tile_visibility(spec: MaskSpec, q_lo: int, q_hi: int, kv_lo: int, kv_hi: int) -> str:
    """Static classification of a tile: 'full' | 'partial' | 'empty'.

    Positions are absolute and half-open: queries in [q_lo, q_hi), keys in
    [kv_lo, kv_hi). 'empty' tiles are skipped entirely, 'full' tiles skip
    the mask apply.
    """
    if spec.is_trivial:
        return "full"
    has_sink = spec.sink > 0 and kv_lo < spec.sink
    if spec.causal:
        if q_hi - 1 < kv_lo:
            return "empty"
        if (
            spec.window is not None
            and (q_lo - (kv_hi - 1)) >= spec.window
            and not has_sink
        ):
            return "empty"
        lo_vis = q_lo >= kv_hi - 1
        if spec.window is not None and not (spec.sink >= kv_hi):
            lo_vis = lo_vis and ((q_hi - 1) - kv_lo) < spec.window
        return "full" if lo_vis else "partial"
    assert spec.window is not None
    if (
        (q_lo - (kv_hi - 1)) >= spec.window or (kv_lo - (q_hi - 1)) >= spec.window
    ) and not has_sink:
        return "empty"
    if spec.sink >= kv_hi:
        return "full"
    full = (
        abs(q_lo - (kv_hi - 1)) < spec.window
        and abs((q_hi - 1) - kv_lo) < spec.window
        and abs(q_lo - kv_lo) < spec.window
        and abs((q_hi - 1) - (kv_hi - 1)) < spec.window
    )
    return "full" if full else "partial"


def apply_mask(scores: torch.Tensor, mask: Optional[torch.Tensor],
               value: float = DEFAULT_MASK_VALUE) -> torch.Tensor:
    """``scores`` where ``mask`` holds, ``value`` elsewhere (no mask: as is)."""
    if mask is None:
        return scores
    return torch.where(mask, scores, torch.full_like(scores, value))
