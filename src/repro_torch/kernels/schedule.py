"""Per-tile lists of visible partner tiles: the loop bounds of the kernels.

The counterpart of the compact schedule in ``repro/kernels/schedule.py``
(``_tile_class`` :114, ``build_tile_schedule`` :129). On the TPU the
visible (i, j) tile pairs are flattened into one scalar-prefetched table
that *is* the sequential grid axis. On Hopper the owning tile is an
ordinary parallel grid axis, so the same classification is stored per
owning tile instead (CSR form): CTA ``a`` reads its own
``row_ptr[a]:row_ptr[a+1]`` slice of visible partner tiles and loops over
exactly those. A fully hidden tile is never visited; a tile flagged masked
(partial under the spec, or touching the ragged kv edge) is the only kind
that applies the element mask. A list rather than a [lo, hi) range keeps
sink + window specs exact: their visible tiles are not contiguous.

Two orientations, as in the JAX package:

  * q-major (:func:`build_q_tile_schedule`): a forward CTA owns a q tile
    and streams its visible kv tiles.
  * kv-major (:func:`build_kv_tile_schedule`): a backward CTA owns a kv
    tile and streams its visible q tiles. The TPU's kv-major table also
    carries QFIRST/QLAST bits and placeholder steps for q tiles no step
    visits, which its fused kernel needs to zero dq and compute delta at a
    first visit; on Hopper the wrapper zeroes dq and delta is a pre-pass,
    so the CSR holds the visible pairs only.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

from repro_torch.core.masks import MaskSpec, tile_visibility


class TileCSR(NamedTuple):
    """Visible partner tiles of every owning tile (host-side numpy; static
    per call). Owners are q tiles (q-major) or kv tiles (kv-major)."""

    row_ptr: np.ndarray  # (n_outer + 1,) int32 -- owner a holds [row_ptr[a], row_ptr[a+1])
    inner: np.ndarray    # (n_visible,) int32 -- partner tile index, ascending per owner
    masked: np.ndarray   # (n_visible,) bool -- apply the element mask

    def pairs(self):
        """The visible (owner, partner) tile pairs, owner-major."""
        return [
            (a, int(self.inner[s]))
            for a in range(len(self.row_ptr) - 1)
            for s in range(self.row_ptr[a], self.row_ptr[a + 1])
        ]

    def device_table(self) -> np.ndarray:
        """The int32 table the CUDA kernels read: ``row_ptr`` followed by
        one entry per visible tile, ``(partner << 1) | masked``."""
        steps = (self.inner.astype(np.int64) << 1) | self.masked.astype(np.int64)
        return np.concatenate([self.row_ptr, steps.astype(np.int32)]).astype(np.int32)


def _tile_class(spec: MaskSpec, i: int, j: int, bq: int, bk: int, kv_valid: int):
    """None if tile (i, j) is spec-empty, else whether it needs the mask
    (the same predicate as the JAX package's ``_tile_class``)."""
    q_lo = i * bq + spec.q_offset
    vis = tile_visibility(spec, q_lo, q_lo + bq, j * bk, j * bk + bk)
    if vis == "empty":
        return None
    return vis == "partial" or (j + 1) * bk > kv_valid


def _build(spec, t_q, t_kv, bq, bk, kv_valid, kv_major: bool) -> TileCSR:
    n_outer, n_inner = (t_kv, t_q) if kv_major else (t_q, t_kv)
    row_ptr = [0]
    inner, masked = [], []
    for a in range(n_outer):
        for b in range(n_inner):
            i, j = (b, a) if kv_major else (a, b)
            m = _tile_class(spec, i, j, bq, bk, kv_valid)
            if m is None:
                continue
            inner.append(b)
            masked.append(m)
        row_ptr.append(len(inner))
    return TileCSR(
        row_ptr=np.asarray(row_ptr, np.int32),
        inner=np.asarray(inner, np.int32),
        masked=np.asarray(masked, bool),
    )


@functools.lru_cache(maxsize=256)
def build_q_tile_schedule(
    spec: MaskSpec, t_q: int, t_kv: int, bq: int, bk: int, kv_valid: int
) -> TileCSR:
    """Visible kv tiles of each of ``t_q`` q tiles over ``t_kv`` kv tiles.

    ``kv_valid`` is the real KV length: tiles reaching past it are flagged
    masked (never dropped -- such a tile always holds some real keys)."""
    return _build(spec, t_q, t_kv, bq, bk, kv_valid, kv_major=False)


@functools.lru_cache(maxsize=256)
def build_kv_tile_schedule(
    spec: MaskSpec, t_q: int, t_kv: int, bq: int, bk: int, kv_valid: int
) -> TileCSR:
    """Visible q tiles of each of ``t_kv`` kv tiles: the pair set of
    ``build_tile_schedule(..., kv_major=True)``'s active steps, in its
    order."""
    return _build(spec, t_q, t_kv, bq, bk, kv_valid, kv_major=True)
