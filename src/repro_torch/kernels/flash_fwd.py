"""FlashAttention-2 forward: the Hopper CUDA kernel and its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/flash_fwd.py:354 flash_fwd``
(compact schedule; banded launches included, since on Hopper the q tile is
a parallel grid axis anyway). The kernel source is ``csrc/flash_fwd.cu``
(FlashAttention-3's forward: a CTA per pair of q tiles, a TMA producer
warp, two consumer warpgroups on wgmma; at head_dim 160 and 256 its own
kernel, ``fa2_fwd_wide_kernel``; its Hopper helpers are
``csrc/sm90.cuh``); its header says what bounds it on an H100 and how the
design answers.

Layout (the public one, read in place through strides -- no head-major
transpose and no padding copy): q (B, Sq, Hq, D) already multiplied by the
softmax scale, k/v (B, Skv, Hkv, D); q head ``h`` reads kv head ``h // G``.
Returns o (B, Sq, Hq, D) in q's dtype and lse (B, Hq, Sq) f32.

:func:`flash_fwd_varlen` is the segment variant (JAX ``flash_fwd`` with
``q_seg``/``kv_seg``, ``fa2_fwd_compact_varlen``): int32 segment ids q_seg
(B, Sq) and kv_seg (B, Skv); a query sees a key only inside its segment.
Its steps carry the per-batch-row bits of
:func:`~repro_torch.kernels.schedule.segment_step_bits`: steps whose tiles
share no segment are skipped, and only a step flagged masked or not
uniform applies the element mask. The same kernel source, instantiated
with ``SEG``.

The split-KV forward :func:`flash_fwd_splitkv` replaces the ``kv_splits >
1`` mode of ``flash_fwd.py:510 _flash_fwd_partitioned`` (body
``_fwd_kernel_partitioned`` :290): the kv tiles are cut into ``ks``
contiguous ranges (:func:`~repro_torch.kernels.schedule.kv_split_edges`),
one CTA per (pair of q tiles, batch * q head, split) walks the union of
the two tiles' visible tiles in its range, and each tile writes its
locally normalised f32 partial, o_parts
(B, Hq, ks, Sq, D) and lse_parts (B, Hq, ks, Sq) -- the JAX layout
(BH, ks, Sq, D) / (BH, ks, Sq). A (q tile, split) with no visible tile
writes (0, -inf). A second kernel on the same stream (its own C entry,
:func:`_fold`) folds the partials in one pass into the single-pass
kernel's (o, lse)
(:func:`~repro_torch.core.online_softmax.fold_partials` is its plain
version); the wrapper returns both as a :class:`SplitForward`.
:func:`flash_fwd_splitkv_varlen` is its segment variant. Both are the same
kernel source instantiated with ``SPLIT``.

The kernels are instantiated at head_dim 64, 128, 160 and 256
(``KERNEL_HEAD_DIMS``) in every mode: the single pass, compact and dense,
and the split-KV forward, each without and with segments.

At head_dim 160 and 256, where a CTA per pair of q tiles would leave the
card short (:func:`single_q_tile`), a CTA takes one q tile and deals its
steps to its two consumer warpgroups in turn, each with its own running
state, merged once at the end (``csrc/flash_fwd.cu``,
``fa2_fwd_wide_kernel``). The plain versions follow the same rule and
deal, so they stay the kernels' oracles; every wrapper and plain version
takes a private ``single_tile`` override (None: the rule) for tests and A/B
runs. The 256 kernel takes finite q only: a run's first zero product reads
the Q tile, so a non-finite q row turns its whole 64-row q tile to NaN,
not only its own row (at 160 that product reads a tile of zeros).

``schedule="dense"`` on :func:`flash_fwd` and :func:`flash_fwd_varlen`
replaces the dense body ``_fwd_kernel_dense`` (``flash_fwd.py:206``, with
its segment branch): the same CTAs walk every kv tile in ascending order
with no table, fetch each one, and classify it in the kernel by
:func:`visibility` (with segments, by the min and max of the two tiles'
ids); an empty tile skips its products. The visible tiles, their order and
their mask decisions are the compact walk's, so the dense outputs are the
compact ones to the bit. The dense schedule has no split-KV form, as in the
JAX package.

Each wrapper takes its plain version (:func:`flash_fwd_plain`,
:func:`flash_fwd_splitkv_plain`) only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.masks import (MaskSpec, apply_mask, make_segment_mask, make_tile_mask,
                                    pad_segments)
from repro_torch.core.online_softmax import fold_partials, merge_running
from repro_torch.kernels import _build
from repro_torch.kernels.schedule import (SMS, build_kv_tile_schedule, build_q_tile_schedule,
                                          build_split_schedule, check_schedule, decode_step_bits,
                                          device_schedule, device_step_bits, segment_step_bits)

# (block_q, block_kv) and head dims the CUDA kernels are instantiated for:
# 128 (qwen3), 64 (whisper), 160 (stablelm) and 256 (gemma3), each in every
# mode (single pass and split-KV, compact and dense, with and without
# segments).
KERNEL_BLOCKS = ((64, 64),)
KERNEL_HEAD_DIMS = (64, 128, 160, 256)
# The head dims of ``fa2_fwd_wide_kernel``, which takes one q tile a CTA
# where the pair grid is short of the card.
WIDE_HEAD_DIMS = (160, 256)


def _tiles(n: int, block: int) -> int:
    return -(-n // block)


def _check_layout(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B,Sq,Hq,D), k/v (B,Skv,Hkv,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, _, Hq, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or Hq % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not match k/v {tuple(k.shape)}")


def single_q_tile(B: int, Hq: int, t_q: int, D: int, ks: int = 1) -> bool:
    """Whether the forward takes one q tile a CTA (True) or a pair (False):
    at head_dim 160 and 256 only (``WIDE_HEAD_DIMS``), where the pair grid,
    B * Hq * ceil(t_q / 2) * ks CTAs, is under one wave of the card's SMs,
    or where there is one q tile (t_q == 1: a pair would leave its second
    warpgroup idle). A fixed rule of the shape, never of the schedule, the
    mask or the segment ids, so dense, compact and segment launches take
    the same mode and stay bitwise comparable. gemma3-1b's prefill (B 1, S
    1536: 48 pair CTAs), a split prefill (96), short stablelm-12b prompts
    (S up to 512 at B 1) and both models' short-q/long-kv corners take one
    tile; gemma3's training shape (B 4, S 2048: 256) and stablelm's prefill
    (B 1, S 1536: 384) keep the pair, which reads each K/V tile once for
    two q tiles and is the faster mode where the grid fills the card
    (``tools/ab_forward.py single_grid``)."""
    return D in WIDE_HEAD_DIMS and (t_q == 1 or B * Hq * -(-t_q // 2) * ks < SMS)


def _tile_mode(single_tile, B: int, Hq: int, t_q: int, D: int, ks: int = 1) -> bool:
    """The mode a launch takes: :func:`single_q_tile`'s, or the private
    override ``single_tile`` (one q tile a CTA is built at head_dim 160 and
    256 only)."""
    if single_tile is None:
        return single_q_tile(B, Hq, t_q, D, ks)
    if single_tile and D not in WIDE_HEAD_DIMS:
        raise ValueError(f"one q tile a CTA is built at head_dim 160 and head_dim 256 only, "
                         f"not {D}")
    return bool(single_tile)


def count_launch(wrapper, schedule: str) -> None:
    """One more launch of ``wrapper``'s kernel: ``wrapper.launches`` counts
    the compact schedule's, ``wrapper.dense_launches`` the dense one's."""
    if schedule == "dense":
        wrapper.dense_launches += 1
    else:
        wrapper.launches += 1


def count_head_dim(wrapper, D: int) -> None:
    """One more of ``wrapper``'s launches at head_dim ``D``, where the
    wrapper counts that head dim apart (``hd160_launches``,
    ``hd256_launches``: subsets of its other counts)."""
    name = f"hd{D}_launches"
    if hasattr(wrapper, name):
        setattr(wrapper, name, getattr(wrapper, name) + 1)


def flash_fwd(q, k, v, spec: MaskSpec, *, block_q: int, block_kv: int,
              schedule: str = "compact", single_tile=None):
    """FA2 forward on pre-scaled q. See the module docstring for layouts
    (and, at head_dim 256, its precondition of finite q); ``schedule`` is
    one of ``schedule.SCHEDULES``."""
    _check_layout(q, k, v)
    check_schedule(schedule)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, spec, block_q=block_q, block_kv=block_kv,
                               schedule=schedule, single_tile=single_tile)
    out = _launch(q, k, v, spec, block_q, block_kv, None, schedule=schedule,
                  single_tile=single_tile)
    count_launch(flash_fwd, schedule)
    return out


flash_fwd.launches = 0  # compact kernel launches (CUDA tensors only)
flash_fwd.dense_launches = 0  # dense kernel launches (CUDA tensors only)


def flash_fwd_varlen(q, k, v, spec: MaskSpec, q_seg, kv_seg, *, block_q: int, block_kv: int,
                     schedule: str = "compact", single_tile=None):
    """The segment variant of :func:`flash_fwd`: int32 q_seg (B, Sq) and
    kv_seg (B, Skv). Rows that share a segment with no key of any visited
    tile give o = 0, lse = -inf."""
    _check_layout(q, k, v)
    check_segments(q, k, q_seg, kv_seg)
    check_schedule(schedule)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, spec, block_q=block_q, block_kv=block_kv,
                               q_seg=q_seg, kv_seg=kv_seg, schedule=schedule,
                               single_tile=single_tile)
    out = _launch(q, k, v, spec, block_q, block_kv, (q_seg, kv_seg), schedule=schedule,
                  single_tile=single_tile)
    count_launch(flash_fwd_varlen, schedule)
    count_head_dim(flash_fwd_varlen, q.shape[3])
    return out


flash_fwd_varlen.launches = 0  # compact kernel launches (CUDA tensors only)
flash_fwd_varlen.dense_launches = 0  # dense kernel launches (CUDA tensors only)
flash_fwd_varlen.hd160_launches = 0  # of the launches of either schedule, those at head_dim 160
flash_fwd_varlen.hd256_launches = 0  # and at head_dim 256


def split_count(Skv: int, block_kv: int, kv_splits: int) -> int:
    """The number of kv splits a split-KV launch makes: ``kv_splits``
    clamped to [1, t_kv], as the JAX ``_resolve_partitions`` clamps it."""
    return max(1, min(kv_splits, _tiles(Skv, block_kv)))


class SplitForward(NamedTuple):
    """What a split-KV forward returns: the folded outputs, as the
    single-pass kernel gives them, and the per-split partials they were
    folded from (``ks = split_count(Skv, block_kv, kv_splits)``)."""

    o: torch.Tensor          # (B, Sq, Hq, D), q's dtype
    lse: torch.Tensor        # (B, Hq, Sq) f32
    o_parts: torch.Tensor    # (B, Hq, ks, Sq, D) f32
    lse_parts: torch.Tensor  # (B, Hq, ks, Sq) f32


def flash_fwd_splitkv(q, k, v, spec: MaskSpec, *, block_q: int, block_kv: int,
                      kv_splits: int, single_tile=None) -> SplitForward:
    """Split-KV forward on pre-scaled q, partials and their fold. See the
    module docstring."""
    _check_layout(q, k, v)
    if q.device.type == "cpu":
        return flash_fwd_splitkv_plain(q, k, v, spec, block_q=block_q, block_kv=block_kv,
                                       kv_splits=kv_splits, single_tile=single_tile)
    out = _launch(q, k, v, spec, block_q, block_kv, None, kv_splits, single_tile=single_tile)
    flash_fwd_splitkv.launches += 1
    count_head_dim(flash_fwd_splitkv, q.shape[3])
    return out


flash_fwd_splitkv.launches = 0  # kernel launches (CUDA tensors only)
flash_fwd_splitkv.hd160_launches = 0  # of those, the launches at head_dim 160
flash_fwd_splitkv.hd256_launches = 0  # and at head_dim 256


def flash_fwd_splitkv_varlen(q, k, v, spec: MaskSpec, q_seg, kv_seg, *, block_q: int,
                             block_kv: int, kv_splits: int, single_tile=None):
    """The segment variant of :func:`flash_fwd_splitkv` (int32 q_seg (B, Sq),
    kv_seg (B, Skv))."""
    _check_layout(q, k, v)
    check_segments(q, k, q_seg, kv_seg)
    if q.device.type == "cpu":
        return flash_fwd_splitkv_plain(q, k, v, spec, block_q=block_q, block_kv=block_kv,
                                       kv_splits=kv_splits, q_seg=q_seg, kv_seg=kv_seg,
                                       single_tile=single_tile)
    out = _launch(q, k, v, spec, block_q, block_kv, (q_seg, kv_seg), kv_splits,
                  single_tile=single_tile)
    flash_fwd_splitkv_varlen.launches += 1
    count_head_dim(flash_fwd_splitkv_varlen, q.shape[3])
    return out


flash_fwd_splitkv_varlen.launches = 0  # kernel launches (CUDA tensors only)
flash_fwd_splitkv_varlen.hd160_launches = 0  # of those, the launches at head_dim 160
flash_fwd_splitkv_varlen.hd256_launches = 0  # and at head_dim 256


def _launch(q, k, v, spec, block_q, block_kv, segments, kv_splits=None, schedule="compact",
            single_tile=None):
    """One launch of the forward kernel; ``kv_splits`` None is the
    single-pass kernel, (o in q's dtype, lse), an int the split-KV one and
    its fold, a :class:`SplitForward`. The dense schedule reads no table.
    At head_dim 160 and 256 a CTA takes one q tile or a pair
    (:func:`_tile_mode`)."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd runs on cuda (kernel) or cpu (plain), not {q.device}")
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    split = kv_splits is not None
    dense = schedule == "dense"
    _check_kernel_inputs("the CUDA forward", (block_q, block_kv), q=q, k=k, v=v)
    t_q, t_kv = _tiles(Sq, block_q), _tiles(Skv, block_kv)
    if split and dense:
        raise ValueError("the dense schedule has no split-KV kernel")
    ks = split_count(Skv, block_kv, kv_splits) if split else 1
    if ks > 65535:
        raise ValueError(f"{ks} kv splits exceed the grid's z limit (65535)")
    single = _tile_mode(single_tile, B, Hq, t_q, D, ks)
    if D in WIDE_HEAD_DIMS and (t_q if single else -(-t_q // 2)) > 65535:
        raise ValueError(f"{t_q} q tiles exceed the grid's y limit (65535)")
    sched = None if dense else device_schedule(spec, t_q, t_kv, block_q, block_kv, Skv, False,
                                               str(q.device), ks)
    seg = segment_args(segments, sched, block_q, block_kv, kv_major=False)
    if split:  # the f32 partials, contiguous as the fold reads them
        o = torch.empty((B, Hq, ks, Sq, D), dtype=torch.float32, device=q.device)
        lse = torch.empty((B, Hq, ks, Sq), dtype=torch.float32, device=q.device)
        o_strides = (o.stride(0), o.stride(3), o.stride(1), o.stride(2))
    else:
        o = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
        lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
        o_strides = (o.stride(0), o.stride(1), o.stride(2), 0)
    lib = _lib()
    err = lib.fa2_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        None if dense else sched.table.data_ptr(),
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        *o_strides,
        B, Hq, Hkv, Sq, Skv, D, block_q, block_kv,
        int(spec.causal), -1 if spec.window is None else int(spec.window),
        int(spec.sink), int(spec.q_offset), t_q, int(split), ks, int(dense), *seg.args,
        torch.cuda.current_stream(q.device).cuda_stream, int(single),
    )
    _build.check(err, "fa2_fwd_bf16")
    if not split:
        return o, lse
    o_fold = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    lse_fold = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    _fold(o, lse, o_fold, lse_fold)
    return SplitForward(o_fold, lse_fold, o, lse)


def _fold(o_parts, lse_parts, o, lse) -> None:
    """The fold kernel's launch, on the current stream after the split walk's:
    contiguous f32 partials o_parts (B, Hq, ks, Sq, D) and lse_parts (B, Hq,
    ks, Sq) into the contiguous o (B, Sq, Hq, D) bf16 and lse (B, Hq, Sq) f32
    given. Part of every split-KV launch (the wrappers count the walk and
    its fold as one); the A/B and smoke tools time it alone."""
    B, Hq, ks, Sq, D = o_parts.shape
    err = _lib().fa2_fwd_fold_f32(o_parts.data_ptr(), lse_parts.data_ptr(), o.data_ptr(),
                                  lse.data_ptr(), B, Hq, Sq, ks, D,
                                  torch.cuda.current_stream(o.device).cuda_stream)
    _build.check(err, "fa2_fwd_fold_f32")


def check_segments(q, k, q_seg, kv_seg) -> None:
    """Raise unless q_seg (B, Sq) and kv_seg (B, Skv) are int32 on q's device."""
    for name, ids, x in (("q_seg", q_seg, q), ("kv_seg", kv_seg, k)):
        if tuple(ids.shape) != tuple(x.shape[:2]):
            raise ValueError(f"{name} must be {tuple(x.shape[:2])}, got {tuple(ids.shape)}")
        if ids.dtype != torch.int32 or ids.device != q.device:
            raise ValueError(f"{name} must be int32 on {q.device}, got {ids.dtype} on "
                             f"{ids.device}")


class _SegmentArgs(NamedTuple):
    """The segment arguments of a C entry (null pointers without segments);
    ``keep`` holds the tensors alive until the launch."""

    args: tuple
    keep: tuple


def segment_args(segments, sched, block_q, block_kv, *, kv_major: bool) -> _SegmentArgs:
    """(q ids, kv ids, their batch strides, the step bits, the visible-step
    count) for a C entry; the bits come from ``sched``'s steps, computed on
    the device (or remembered from an earlier launch on the same ids).
    ``sched`` None (the dense schedule): no bits, the kernel reads the ids."""
    if segments is None:
        return _SegmentArgs((None, None, 0, 0, None, 0), ())
    q_seg, kv_seg = segments
    if q_seg.stride(1) != 1 or kv_seg.stride(1) != 1:
        raise ValueError("segment ids need a unit stride along the sequence")
    ids = (q_seg.data_ptr(), kv_seg.data_ptr(), q_seg.stride(0), kv_seg.stride(0))
    if sched is None:
        return _SegmentArgs((*ids, None, 0), (q_seg, kv_seg))
    bits = device_step_bits(q_seg, kv_seg, sched, block_q, block_kv, kv_major)
    return _SegmentArgs((*ids, bits.data_ptr(), bits.shape[1]), (q_seg, kv_seg, bits))


def _check_kernel_inputs(what: str, blocks, head_dims=KERNEL_HEAD_DIMS, **tensors):
    """Raise on what the CUDA kernels do not take: bf16 tensors on the first
    one's device, unit last stride, 16-byte aligned rows, the head dims
    (``head_dims``) and (block_q, block_kv) they are instantiated for
    (``blocks`` None: no tiles to check)."""
    first = next(iter(tensors.values()))
    for name, t in tensors.items():
        if t.device != first.device:
            raise ValueError(f"{name} is on {t.device}, the others on {first.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{what} takes bfloat16; {name} is {t.dtype}")
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]):
            raise ValueError(f"{name} needs a unit last stride and the others multiples "
                             f"of 8, got strides {t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if first.shape[3] not in head_dims:
        raise ValueError(f"{what} supports head_dim in {head_dims}, got {first.shape[3]}")
    if blocks is not None and tuple(blocks) not in KERNEL_BLOCKS:
        raise ValueError(f"{what} supports (block_q, block_kv) in "
                         f"{KERNEL_BLOCKS}, got {tuple(blocks)}")
    if first.shape[0] * first.shape[2] > 65535:
        raise ValueError("batch * heads exceeds the grid's y limit (65535)")


@functools.lru_cache(maxsize=1)
def _lib():
    lib = _build.load("flash_fwd")
    P, I, L = _build.VOIDP, _build.INT, _build.I64
    lib.fa2_fwd_bf16.argtypes = [P] * 6 + [L] * 13 + [I] * 16 + [P, P, L, L, P, I, P, I]
    lib.fa2_fwd_bf16.restype = ctypes.c_int
    lib.fa2_fwd_fold_f32.argtypes = [P] * 4 + [I] * 5 + [P]
    lib.fa2_fwd_fold_f32.restype = ctypes.c_int
    return lib


def flash_fwd_plain(q, k, v, spec: MaskSpec, *, block_q: int, block_kv: int,
                    q_seg=None, kv_seg=None, schedule: str = "compact", single_tile=None):
    """The kernel's algorithm in plain PyTorch (f32 math, any device).

    Same tiles, same visit order (the per-q-tile schedule), same mask value
    and the same bf16 rounding of P before P V, so it matches the kernel up
    to summation order and the JAX kernel up to the same. With segment ids
    (both or neither) it is the varlen kernel's: a batch row skips the
    steps whose bits lack ``SEG_ACTIVE`` (its state stays as it was), and
    the element mask, ANDed with ``q_seg == kv_seg`` on the sentinel-padded
    ids, applies where the rule of ``schedule.decode_step_bits`` says.
    ``schedule="dense"`` walks every kv tile and classifies it by
    :func:`visibility` instead (:class:`_Walk`): the same steps, so the
    same result to the bit. In one-q-tile mode (:func:`_tile_mode`) a
    tile's steps are dealt to two running states, as the kernel deals
    them to its warpgroups (:func:`_plain_walk`)."""
    flash_fwd_plain.calls += 1
    _check_layout(q, k, v)
    B, Sq, Hq, D = q.shape
    t_q, t_kv = _tiles(Sq, block_q), _tiles(k.shape[1], block_kv)
    walk = _Walk.of(schedule, spec, t_q, t_kv, block_q, block_kv, k.shape[1], q_seg, kv_seg,
                    kv_major=False)
    o, lse = _plain_walk(q, k, v, spec, block_q, block_kv, walk,
                         _tile_mode(single_tile, B, Hq, t_q, D))
    return o[0].reshape(B, Sq, Hq, D).to(q.dtype), lse[0].reshape(B, Hq, Sq)


flash_fwd_plain.calls = 0


def flash_fwd_splitkv_plain(q, k, v, spec: MaskSpec, *, block_q: int, block_kv: int,
                            kv_splits: int, q_seg=None, kv_seg=None,
                            single_tile=None) -> SplitForward:
    """The split-KV kernels' algorithm in plain PyTorch: the walk of
    :func:`flash_fwd_plain` over :func:`build_split_schedule`'s owners, each
    (q tile, split) finalised on its own into f32 partials o_parts
    (B, Hq, ks, Sq, D) and lse_parts (B, Hq, ks, Sq), then
    :func:`fold_partials`."""
    flash_fwd_splitkv_plain.calls += 1
    _check_layout(q, k, v)
    B, Sq, Hq, D = q.shape
    t_q, t_kv = _tiles(Sq, block_q), _tiles(k.shape[1], block_kv)
    sched = build_split_schedule(spec, t_q, t_kv, block_q, block_kv, k.shape[1], kv_splits)
    walk = _Walk(spec, block_q, block_kv, k.shape[1], q_seg, kv_seg, kv_major=False, csr=sched)
    o, lse = _plain_walk(q, k, v, spec, block_q, block_kv, walk,
                         _tile_mode(single_tile, B, Hq, t_q, D, sched.splits))
    ks = sched.splits  # o (ks, B, Sq, Hk, G, D), lse (ks, B, Hk, G, Sq)
    o_parts = o.permute(1, 3, 4, 0, 2, 5).reshape(B, Hq, ks, Sq, D)
    lse_parts = lse.permute(1, 2, 3, 0, 4).reshape(B, Hq, ks, Sq)
    o_f, lse_f = fold_partials(o_parts, lse_parts, dim=2)
    return SplitForward(o_f.transpose(1, 2).to(q.dtype).contiguous(), lse_f, o_parts, lse_parts)


flash_fwd_splitkv_plain.calls = 0


def _plain_walk(q, k, v, spec, block_q, block_kv, walk, single=False):
    """Every owner of the q-major ``walk`` (q tile ``a // splits``, split
    ``a % splits``) walked and finalised as the kernel does: o (ks, B, Sq,
    Hk, G, D) f32 and lse (ks, B, Hk, G, Sq); an owner with no step gives
    (0, -inf). ``single``: the kernel's one-q-tile mode, where an owner's
    steps go to two running states in turn, by their ordinal among the
    steps each batch row takes (a CTA is one batch row and head), and the
    two are merged at the end, state 0 first (:func:`merge_running`)."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hk, _ = k.shape
    G = Hq // Hk
    ks = walk.splits
    t_kv = _tiles(Skv, block_kv)
    seg = walk.seg
    # K/V rows past the end read as zeros and are masked, as in the kernel.
    pad = t_kv * block_kv - Skv
    kp = F.pad(k, (0, 0, 0, 0, 0, pad)).float()
    vp = F.pad(v, (0, 0, 0, 0, 0, pad))
    qh = q.reshape(B, Sq, Hk, G, D).float()
    o = torch.zeros((ks, B, Sq, Hk, G, D), dtype=torch.float32, device=q.device)
    lse = torch.full((ks, B, Hk, G, Sq), float("-inf"), device=q.device)
    for a in range(walk.owners):
        i, split = divmod(a, ks)
        r0, r1 = i * block_q, min((i + 1) * block_q, Sq)
        qi = qh[:, r0:r1]
        rows = torch.arange(r0, r1, device=q.device) + spec.q_offset
        m = torch.full((B, Hk, G, r1 - r0), float("-inf"), device=q.device)
        state = (m, torch.zeros_like(m), torch.zeros((B, Hk, G, r1 - r0, D), device=q.device))
        states = [state, state] if single else [state]
        dealt = torch.zeros(B, dtype=torch.long, device=q.device)  # steps taken per batch row
        for j, active, needs_mask in walk.steps(a):
            c0, c1 = j * block_kv, (j + 1) * block_kv
            sc = torch.einsum("bqhgd,bkhd->bhgqk", qi, kp[:, c0:c1])
            if needs_mask:
                cols = torch.arange(c0, c1, device=q.device)
                vis = (cols < Skv)[None, :]
                tm = make_tile_mask(spec, rows, cols)
                vis = vis if tm is None else vis & tm
                sc = apply_mask(sc, seg.mask(vis, r0, r1, c0, c1))
            vt = vp[:, c0:c1].float()
            if not single:
                states[0] = _online_step(states[0], sc, vt, v.dtype, active, seg.select)
                continue
            took = torch.ones(B, dtype=torch.bool, device=q.device) if active is True else active
            for w in (0, 1):
                sel = took & (dealt % 2 == w)
                if sel.any():
                    states[w] = _online_step(states[w], sc, vt, v.dtype,
                                             True if sel.all() else sel, seg.select)
            dealt += took
        m, l, acc = merge_running(*states) if single else states[0]
        l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
        o[split, :, r0:r1] = (acc / l_safe[..., None]).permute(0, 3, 1, 2, 4)
        lse[split, ..., r0:r1] = torch.where(
            l == 0.0, torch.full_like(l, float("-inf")), m + torch.log(l_safe)
        )
    return o, lse


def _online_step(state, sc, vt, p_dtype, active, select):
    """One step of the online softmax (FA2 Algorithm 1 lines 8-10, the
    accumulator un-rescaled) on the running ``state`` (m, l, acc), for the
    batch rows in ``active``: scores ``sc``, V tile ``vt``, P rounded to
    ``p_dtype`` before P V, as the kernel rounds it."""
    m, l, acc = state
    m_new = torch.maximum(m, sc.amax(dim=-1))
    alpha = torch.where(torch.isneginf(m), torch.zeros_like(m), torch.exp(m - m_new))
    p = torch.exp(sc - m_new[..., None])
    l_new = l * alpha + p.sum(dim=-1)
    pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(p_dtype).float(), vt)
    return (select(active, m_new, m), select(active, l_new, l),
            select(active, acc * alpha[..., None] + pv, acc))


def visibility(spec: MaskSpec, i: int, j: int, bq: int, bk: int, kv_valid: int,
               q_ids=None, kv_ids=None):
    """(empty, needs_mask) of tile (i, j) under the dense schedule: the test
    its kernels make in the kernel, restating the JAX ``_visibility``
    (``flash_fwd.py:71``). Positions are inclusive: q rows ``i * bq +
    q_offset`` up to ``bq - 1`` on, kv rows ``j * bk`` up to ``bk - 1`` on;
    a tile that reaches past ``kv_valid`` keys needs the mask.

    ``q_ids``/``kv_ids`` (both or neither; arrays of the tiles' segment ids,
    rows past the ends padded with the ``masks`` sentinels): a tile whose
    id ranges do not overlap is empty, and it needs no mask only if both
    tiles hold one and the same id. On a spec-visible tile this is the
    compact schedule's ``SEG_ACTIVE`` and ``SEG_UNIFORM``."""
    q_lo = i * bq + spec.q_offset
    q_hi = q_lo + bq - 1
    kv_lo = j * bk
    kv_hi = kv_lo + bk - 1
    w, sink = spec.window, spec.sink
    empty, full = False, True
    if spec.causal:
        empty = q_hi < kv_lo
        full = q_lo >= kv_hi
        if w is not None:
            empty = empty or (q_lo - kv_hi >= w and not kv_lo < sink)
            full = full and (q_hi - kv_lo < w or kv_hi < sink)
    elif w is not None:
        empty = (q_lo - kv_hi >= w or kv_lo - q_hi >= w) and not kv_lo < sink
        full = (abs(q_lo - kv_hi) < w and abs(q_hi - kv_lo) < w) or kv_hi < sink
    if kv_valid % bk:
        empty = empty or kv_lo >= kv_valid
        full = full and j != kv_valid // bk
    if q_ids is not None:
        qs_lo, qs_hi = int(q_ids.min()), int(q_ids.max())
        ks_lo, ks_hi = int(kv_ids.min()), int(kv_ids.max())
        empty = empty or qs_hi < ks_lo or qs_lo > ks_hi
        full = full and qs_lo == qs_hi == ks_lo == ks_hi
    return bool(empty), not full


class _Walk:
    """The steps a plain version takes, owner tile by owner tile, in its
    kernel's order: :meth:`steps` yields (partner tile, active rows, needs
    mask) for each step that some batch row computes.

    Compact (``csr`` given): the CSR's visible steps, each classified by its
    masked flag and, with segment ids, its step bits. Dense (``csr`` None):
    every partner tile, classified by :func:`visibility` on each batch row's
    id tiles. Both keep the same steps with the same decisions, so their
    results agree to the bit."""

    def __init__(self, spec, bq, bk, kv_valid, q_seg, kv_seg, *, kv_major: bool, csr=None,
                 t_q: int = 0, t_kv: int = 0):
        self.spec, self.bq, self.bk, self.kv_valid = spec, bq, bk, kv_valid
        self.kv_major, self.csr = kv_major, csr
        self.n_inner = t_q if kv_major else t_kv
        self.owners = len(csr.row_ptr) - 1 if csr is not None else (t_kv if kv_major else t_q)
        self.splits = csr.splits if csr is not None else 1
        self.seg = _PlainSegments.of(q_seg, kv_seg, csr, bq, bk, kv_major=kv_major)

    @classmethod
    def of(cls, schedule, spec, t_q, t_kv, bq, bk, kv_valid, q_seg, kv_seg, *,
           kv_major: bool) -> "_Walk":
        """The walk of ``schedule`` in one orientation (kv-major: owners are
        kv tiles)."""
        check_schedule(schedule)
        csr = None
        if schedule == "compact":
            build = build_kv_tile_schedule if kv_major else build_q_tile_schedule
            csr = build(spec, t_q, t_kv, bq, bk, kv_valid)
        return cls(spec, bq, bk, kv_valid, q_seg, kv_seg, kv_major=kv_major, csr=csr, t_q=t_q,
                   t_kv=t_kv)

    def steps(self, a: int):
        if self.csr is not None:
            for s in range(self.csr.row_ptr[a], self.csr.row_ptr[a + 1]):
                active, needs = self.seg.step(s, self.csr.masked[s])
                if active is not None:
                    yield int(self.csr.inner[s]), active, needs
            return
        for b in range(self.n_inner):
            i, j = (b, a) if self.kv_major else (a, b)
            active, needs = self.seg.tile(self.spec, i, j, self.bq, self.bk, self.kv_valid)
            if active is not None:
                yield b, active, needs


class _PlainSegments:
    """The segment side of a plain version's walk. Without ids every step is
    active for every row and needs the mask iff flagged. With ids, per step:
    the batch rows where it is active (None when none is, so the step is
    skipped; True when all are), whether any row needs the element mask,
    and that mask ANDed with the rows' segment equality."""

    def __init__(self, bits=None, qs=None, ks=None, bq=1, bk=1):
        self.bits, self.qs, self.ks = bits, qs, ks
        self.bq, self.bk = bq, bk

    @functools.cached_property
    def tiles(self):
        """The padded ids per tile on the host, (B, t_q, bq) and (B, t_kv,
        bk): what the dense classifier reads."""
        return (self.qs.reshape(self.qs.shape[0], -1, self.bq).cpu().numpy(),
                self.ks.reshape(self.ks.shape[0], -1, self.bk).cpu().numpy())

    @classmethod
    def of(cls, q_seg, kv_seg, csr, bq, bk, *, kv_major: bool) -> "_PlainSegments":
        """``csr`` None (the dense walk): no step bits, the tiles' ids."""
        if (q_seg is None) != (kv_seg is None):
            raise ValueError("give both q_seg and kv_seg, or neither")
        if q_seg is None:
            return cls()
        bits = None
        if csr is not None:
            bits = segment_step_bits(q_seg, kv_seg, csr, bq, bk, kv_major).cpu()
        qs, ks = pad_segments(q_seg, kv_seg, _tiles(q_seg.shape[1], bq) * bq,
                              _tiles(kv_seg.shape[1], bk) * bk)
        return cls(bits, qs, ks, bq, bk)

    def step(self, s: int, masked: bool):
        """A compact step ``s`` flagged ``masked``."""
        if self.qs is None:
            return True, bool(masked)
        return self._rows([decode_step_bits(masked, int(b)) for b in self.bits[:, s]])

    def tile(self, spec, i, j, bq, bk, kv_valid):
        """A dense step: tile (i, j) classified by :func:`visibility`."""
        if self.qs is None:
            empty, needs = visibility(spec, i, j, bq, bk, kv_valid)
            return (None, False) if empty else (True, needs)
        return self._rows([
            (not empty, needs) for empty, needs in (
                visibility(spec, i, j, bq, bk, kv_valid, qt[i], kt[j])
                for qt, kt in zip(*self.tiles))])

    def _rows(self, rules):
        """Per-row (active, needs mask) -> the step's (active rows, needs)."""
        active = torch.tensor([a for a, _ in rules])
        if not active.any():
            return None, False
        needs = any(n for a, n in rules if a)
        if active.all():
            return True, needs
        return active.to(self.qs.device), needs

    def mask(self, vis, r0, r1, c0, c1):
        """``vis`` (rows, cols) ANDed with the (B, 1, 1, rows, cols) segment
        equality, broadcast over (kv head, group)."""
        if self.qs is None:
            return vis
        return vis & make_segment_mask(self.qs[:, r0:r1], self.ks[:, c0:c1])[:, None, None]

    @staticmethod
    def select(active, new, old):
        """``new`` for the active batch rows, ``old`` for the others."""
        if active is True:
            return new
        return torch.where(active.view(-1, *([1] * (new.ndim - 1))), new, old)
