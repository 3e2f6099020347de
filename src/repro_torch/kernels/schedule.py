"""Per-q-tile visible kv tiles: the loop bounds of the forward kernel.

The counterpart of the q-major compact schedule in
``repro/kernels/schedule.py`` (``_tile_class`` :114, ``build_tile_schedule``
:129). On the TPU the visible (i, j) tile pairs are flattened into one
scalar-prefetched table that *is* the sequential grid axis. On Hopper the
q tiles are an ordinary parallel grid axis, so the same classification is
stored per q tile instead (CSR form): CTA ``i`` reads its own
``row_ptr[i]:row_ptr[i+1]`` slice of visible kv tiles and loops over
exactly those. A fully hidden tile is never visited; a tile flagged masked
(partial under the spec, or touching the ragged kv edge) is the only kind
that applies the element mask. A list rather than a [lo, hi) range keeps
sink + window specs exact: their visible tiles are not contiguous.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

from repro_torch.core.masks import MaskSpec, tile_visibility


class QTileSchedule(NamedTuple):
    """Visible kv tiles of every q tile (host-side numpy; static per call)."""

    row_ptr: np.ndarray  # (t_q + 1,) int32 -- q tile i owns [row_ptr[i], row_ptr[i+1])
    kv_tile: np.ndarray  # (n_visible,) int32 -- kv tile index, ascending per q tile
    masked: np.ndarray   # (n_visible,) bool -- apply the element mask

    def pairs(self):
        """The visible (i, j) tile pairs, q-row-major."""
        return [
            (i, int(self.kv_tile[s]))
            for i in range(len(self.row_ptr) - 1)
            for s in range(self.row_ptr[i], self.row_ptr[i + 1])
        ]

    def device_table(self) -> np.ndarray:
        """The int32 table the CUDA kernel reads: ``row_ptr`` followed by
        one entry per visible tile, ``(kv_tile << 1) | masked``."""
        steps = (self.kv_tile.astype(np.int64) << 1) | self.masked.astype(np.int64)
        return np.concatenate([self.row_ptr, steps.astype(np.int32)]).astype(np.int32)


def _tile_class(spec: MaskSpec, i: int, j: int, bq: int, bk: int, kv_valid: int):
    """None if tile (i, j) is spec-empty, else whether it needs the mask
    (the same predicate as the JAX package's ``_tile_class``)."""
    q_lo = i * bq + spec.q_offset
    vis = tile_visibility(spec, q_lo, q_lo + bq, j * bk, j * bk + bk)
    if vis == "empty":
        return None
    return vis == "partial" or (j + 1) * bk > kv_valid


@functools.lru_cache(maxsize=256)
def build_q_tile_schedule(
    spec: MaskSpec, t_q: int, t_kv: int, bq: int, bk: int, kv_valid: int
) -> QTileSchedule:
    """Visible kv tiles of each of ``t_q`` q tiles over ``t_kv`` kv tiles.

    ``kv_valid`` is the real KV length: tiles reaching past it are flagged
    masked (never dropped -- such a tile always holds some real keys)."""
    row_ptr = [0]
    kv_tile, masked = [], []
    for i in range(t_q):
        for j in range(t_kv):
            m = _tile_class(spec, i, j, bq, bk, kv_valid)
            if m is None:
                continue
            kv_tile.append(j)
            masked.append(m)
        row_ptr.append(len(kv_tile))
    return QTileSchedule(
        row_ptr=np.asarray(row_ptr, np.int32),
        kv_tile=np.asarray(kv_tile, np.int32),
        masked=np.asarray(masked, bool),
    )
