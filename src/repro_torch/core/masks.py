"""Attention mask specifications and tile classification.

The counterpart of ``repro/core/masks.py``. Masks are symbolic (causal
flag, window, sink, query offset) so that a kernel can decide per tile
whether it is fully visible (no mask applied), partially visible (apply the
element mask) or fully hidden (never visited) -- the paper's causal block
skipping, Section 3.1.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

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
