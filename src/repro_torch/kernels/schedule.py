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

  * q-major (:func:`build_q_tile_schedule`): a forward CTA, or a dQ CTA of
    the split backward, owns a q tile and streams its visible kv tiles. A
    q tile with no visible kv tile (the TPU table's placeholder step)
    needs no entry: its CTA writes its zeros and stops.
  * kv-major (:func:`build_kv_tile_schedule`): a backward CTA owns a kv
    tile and streams its visible q tiles. The TPU's kv-major table also
    carries QFIRST/QLAST bits and placeholder steps for q tiles no step
    visits, which its fused kernel needs to zero dq and compute delta at a
    first visit; on Hopper the wrapper zeroes dq and delta is a pre-pass,
    so the CSR holds the visible pairs only.

The split-KV forward (``kv_splits > 1``, the counterpart of
``build_partitioned_schedule`` :283 with one band) cuts each q tile's list
at the contiguous kv ranges of :func:`kv_split_edges`: owner ``i * ks + s``
of :func:`build_split_schedule` holds the visible kv tiles of q tile ``i``
inside split ``s``, exactly the ACTIVE steps of that q tile in the TPU's
partition of split ``s``. The TPU's q bands have no table here: every q
tile is already its own CTA.

Packed (varlen) batches add data-dependent skipping on top of the static
table (:func:`segment_step_bits`, the counterpart of
``segment_step_tables`` :388): per batch row and visible step, whether the
two tiles' segment-id ranges overlap (``SEG_ACTIVE``; a step without it is
skipped, its tiles not even loaded) and whether both tiles hold one and the
same id (``SEG_UNIFORM``; such a step needs no element mask). As in the
JAX package, the bits are computed outside the kernel, before its launch,
and the kernel reads them beside its table.

The dense schedule (``schedule="dense"``, JAX ``flash_fwd.py:27``) has no
table: its CTAs walk every partner tile and classify each one in the
kernel (``flash_fwd.visibility`` is the plain form of that test). The
TPU's flattened step table and its ``STEP_*`` flags have no counterpart
in either schedule: the CSR replaces them for compact, the in-kernel
classifier for dense.
"""

from __future__ import annotations

import functools
from collections import OrderedDict
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.masks import MaskSpec, pad_segments, tile_visibility

# Per-(batch row, visible step) segment bits (JAX ``schedule.py:64``).
SEG_ACTIVE = 1   # the tiles' id ranges overlap
SEG_UNIFORM = 2  # both tiles hold one and the same id: no element mask

# Tile schedules: "compact" walks the CSR's visible tiles only; "dense"
# visits (and fetches) every tile and skips the products of the empty ones.
SCHEDULES = ("compact", "dense")


def check_schedule(schedule: str) -> None:
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown tile schedule {schedule!r}; have {SCHEDULES}")


class TileCSR(NamedTuple):
    """Visible partner tiles of every owning tile (host-side numpy; static
    per call). Owners are q tiles (q-major) or kv tiles (kv-major)."""

    row_ptr: np.ndarray  # (n_outer + 1,) int32 -- owner a holds [row_ptr[a], row_ptr[a+1])
    inner: np.ndarray    # (n_visible,) int32 -- partner tile index, ascending per owner
    masked: np.ndarray   # (n_visible,) bool -- apply the element mask
    splits: int = 1      # kv splits: owner a is (tile a // splits, split a % splits)

    def pairs(self):
        """The visible (owner, partner) tile pairs, owner-major."""
        return [
            (a, int(self.inner[s]))
            for a in range(len(self.row_ptr) - 1)
            for s in range(self.row_ptr[a], self.row_ptr[a + 1])
        ]

    @property
    def owner(self) -> np.ndarray:
        """(n_visible,) int32: the owning tile of every visible step (the q
        tile, not the owner index, of a split schedule)."""
        return np.repeat(np.arange(len(self.row_ptr) - 1, dtype=np.int32) // self.splits,
                         np.diff(self.row_ptr))

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


def kv_split_edges(t_kv: int, kv_splits: int):
    """Ceil-div contiguous kv-tile ranges [(j0, j1), ...] covering 0..t_kv:
    the first ``t_kv % kv_splits`` splits carry one extra tile (the JAX
    ``kv_split_edges``, ``schedule.py:266``)."""
    base, extra = divmod(t_kv, kv_splits)
    edges, j0 = [], 0
    for s in range(kv_splits):
        j1 = j0 + base + (1 if s < extra else 0)
        edges.append((j0, j1))
        j0 = j1
    return edges


@functools.lru_cache(maxsize=256)
def build_split_schedule(
    spec: MaskSpec, t_q: int, t_kv: int, bq: int, bk: int, kv_valid: int, kv_splits: int
) -> TileCSR:
    """The split-KV forward's walk: owner ``i * ks + s`` holds q tile i's
    visible kv tiles inside split s of :func:`kv_split_edges` (``ks`` is
    ``kv_splits`` clamped to [1, t_kv]), ascending, each with its masked
    flag. An owner with none has an empty slice: its CTA writes the merge
    identity (o = 0, lse = -inf)."""
    ks = max(1, min(kv_splits, t_kv))
    q_major = build_q_tile_schedule(spec, t_q, t_kv, bq, bk, kv_valid)
    edges = kv_split_edges(t_kv, ks)
    row_ptr, inner, masked = [0], [], []
    for i in range(t_q):
        lo, hi = q_major.row_ptr[i], q_major.row_ptr[i + 1]
        for j0, j1 in edges:
            for s in range(lo, hi):
                if j0 <= q_major.inner[s] < j1:
                    inner.append(int(q_major.inner[s]))
                    masked.append(bool(q_major.masked[s]))
            row_ptr.append(len(inner))
    return TileCSR(
        row_ptr=np.asarray(row_ptr, np.int32),
        inner=np.asarray(inner, np.int32),
        masked=np.asarray(masked, bool),
        splits=ks,
    )


class DeviceCSR(NamedTuple):
    """A :class:`TileCSR` on the device: the table the kernels read and the
    per-step owner and partner indices that :func:`segment_step_bits`
    gathers with."""

    table: torch.Tensor  # int32, TileCSR.device_table()
    owner: torch.Tensor  # (n_visible,) int64
    inner: torch.Tensor  # (n_visible,) int64


@functools.lru_cache(maxsize=128)
def device_schedule(spec: MaskSpec, t_q: int, t_kv: int, bq: int, bk: int, kv_valid: int,
                    kv_major: bool, device: str, kv_splits: int = 1) -> DeviceCSR:
    """The q-major, kv-major or (``kv_splits > 1``) split schedule on
    ``device``, built and copied once per shape."""
    if kv_splits > 1:
        sched = build_split_schedule(spec, t_q, t_kv, bq, bk, kv_valid, kv_splits)
    else:
        build = build_kv_tile_schedule if kv_major else build_q_tile_schedule
        sched = build(spec, t_q, t_kv, bq, bk, kv_valid)
    return DeviceCSR(
        table=torch.from_numpy(sched.device_table()).to(device),
        owner=torch.from_numpy(sched.owner.astype(np.int64)).to(device),
        inner=torch.from_numpy(sched.inner.astype(np.int64)).to(device),
    )


def segment_step_bits(q_seg: torch.Tensor, kv_seg: torch.Tensor, csr, bq: int, bk: int,
                      kv_major: bool) -> torch.Tensor:
    """(B, n_visible) int32 segment bits of every visible step of ``csr``
    (a :class:`TileCSR` or :class:`DeviceCSR` of that orientation).

    The ids (B, Sq) / (B, Skv) are padded with the sentinels to whole tiles,
    reduced to per-tile min and max, and gathered at each step's q and kv
    tile: ``SEG_ACTIVE`` where the ranges overlap (sound for any layout,
    exact for contiguous packing), ``SEG_UNIFORM`` where both tiles are
    constant and equal. A few torch ops on the ids' device, no host sync.
    The bits of a step equal ``segment_step_tables``'s at the same pair."""
    B = q_seg.shape[0]
    t_q, t_kv = -(-q_seg.shape[-1] // bq), -(-kv_seg.shape[-1] // bk)
    qs, ks = pad_segments(q_seg, kv_seg, t_q * bq, t_kv * bk)
    qt, kt = qs.reshape(B, t_q, bq), ks.reshape(B, t_kv, bk)
    q_lo, q_hi = qt.amin(dim=-1), qt.amax(dim=-1)  # (B, t_q)
    k_lo, k_hi = kt.amin(dim=-1), kt.amax(dim=-1)  # (B, t_kv)
    dev = q_seg.device
    owner = torch.as_tensor(csr.owner, dtype=torch.long, device=dev)
    inner = torch.as_tensor(csr.inner, dtype=torch.long, device=dev)
    ii, jj = (inner, owner) if kv_major else (owner, inner)
    qlo, qhi = q_lo[:, ii], q_hi[:, ii]  # (B, n_visible)
    klo, khi = k_lo[:, jj], k_hi[:, jj]
    overlap = ~((qhi < klo) | (qlo > khi))
    uniform = (qlo == qhi) & (klo == khi) & (qlo == klo)
    return (overlap.to(torch.int32) | (uniform.to(torch.int32) << 1)).contiguous()


# Recent results of :func:`device_step_bits`: (q ids, kv ids, schedule,
# kv_major) -> (the ids' version counters, bits). The entries hold the ids
# and the schedule, so their identities stay unique while cached.
_STEP_BITS_MEMO: "OrderedDict[tuple, tuple]" = OrderedDict()
_STEP_BITS_MEMO_SIZE = 8


def device_step_bits(q_seg: torch.Tensor, kv_seg: torch.Tensor, sched: DeviceCSR, bq: int,
                     bk: int, kv_major: bool) -> torch.Tensor:
    """:func:`segment_step_bits` for the kernels, remembered for the same id
    tensors (unchanged since: their version counters match) and schedule.
    A packed training step hands every layer, its recompute and its
    backward the same ids, so the bits are computed once per orientation
    and step instead of at every launch."""
    key = (id(q_seg), id(kv_seg), id(sched), kv_major)
    versions = (q_seg._version, kv_seg._version)
    hit = _STEP_BITS_MEMO.get(key)
    if hit is not None and hit[0] is q_seg and hit[1] is kv_seg and hit[2] is sched \
            and hit[3] == versions:
        _STEP_BITS_MEMO.move_to_end(key)
        return hit[4]
    bits = segment_step_bits(q_seg, kv_seg, sched, bq, bk, kv_major)
    _STEP_BITS_MEMO[key] = (q_seg, kv_seg, sched, versions, bits)
    while len(_STEP_BITS_MEMO) > _STEP_BITS_MEMO_SIZE:
        _STEP_BITS_MEMO.popitem(last=False)
    return bits


def decode_step_bits(masked: bool, seg_bits: Optional[int] = None):
    """(active, needs_mask) of a visible step: the rule of the JAX package's
    ``decode_step_bits`` (:373) on the port's tables, where every step in a
    CSR is visible. With segments a step is active iff ``SEG_ACTIVE`` is
    set, and needs the element mask iff it is flagged masked or
    ``SEG_UNIFORM`` is clear."""
    if seg_bits is None:
        return True, bool(masked)
    return bool(seg_bits & SEG_ACTIVE), bool(masked) or not seg_bits & SEG_UNIFORM
