"""FlashAttention-2 backward (Algorithm 2): the Hopper CUDA kernels and
their plain versions.

Replaces four Pallas TPU kernels of ``repro/kernels/flash_bwd.py``:

  * :func:`flash_bwd_delta` <- ``flash_bwd_delta`` (:80): delta =
    rowsum(dO o O), Algorithm 2 line 4, as f32 (B, Hq, Sq).
  * :func:`flash_bwd_fused` <- ``flash_bwd_fused`` (:718, compact body
    ``_fused_kernel_compact`` :672): dK, dV and dQ in one pass over the
    visible tiles, one (S, P) recompute per tile.
  * :func:`flash_bwd_dkv` <- ``flash_bwd_dkv`` (:234, compact body
    ``_dkv_kernel_compact`` :193) and :func:`flash_bwd_dq` <-
    ``flash_bwd_dq`` (:459, compact body ``_dq_kernel_compact`` :422):
    the split backward. dK/dV KV-stationary (the fused kernel without its
    dQ phase, so bitwise its dK and dV), dQ Q-stationary over the forward's
    q-major table, each written once: no atomics, so all three are bitwise
    reproducible (``bwd="split"``, the deterministic mode).

The TPU kernel runs a sequential kv-major grid and uses each q tile's first
visit to zero its f32 dq block and compute its delta into VMEM scratch. On
Hopper the kv-tile CTAs run in parallel and in no order, so nothing marks a
first visit: delta is this pre-pass, and dq is an f32 buffer that the
wrapper zeroes and every CTA adds its dS K contribution into, a 64-row tile
at a time by bulk reduction (``cp.reduce.async.bulk``). dK and dV need no
atomics: a CTA owns a pair of kv tiles (one at head_dim 160 and 256, whose
columns its two warpgroups split) and walks the G q heads that share
them and, per head, the union of the two tiles' visible q tiles
(``schedule.build_kv_tile_schedule``, ``schedule.pair_walk``), on wgmma with
TMA loads. At 160 and 256, where :func:`kv_head_split` finds a CTA a kv
tile short of the card, the G heads are split over CTAs, each writing f32
dK/dV partials into scratch that :func:`flash_bwd_group_sum`, a kernel that
replaces no TPU kernel, adds in a fixed order: still no atomics. The sums
in dq come in no fixed order, so dq is not bitwise reproducible from run
to run; it is held to ``allclose``. The split kernels write every output element exactly once,
zeros included where a tile sees nothing, so their outputs need no
zeroing. The sources are ``csrc/flash_bwd.cu``; its header says what
bounds each kernel on an H100 and how the design answers.

Layouts are the public ones, read in place through strides: q and dO
(B, Sq, Hq, D), q pre-scaled by the softmax scale; k, v (B, Skv, Hkv, D);
o (B, Sq, Hq, D); lse and delta (B, Hq, Sq) f32. Outputs are f32: dq
(B, Sq, Hq, D) with respect to the *scaled* q, dk and dv (B, Skv, Hkv, D).

The ``_varlen`` wrappers are the segment variants of the fused, dK/dV and
dQ kernels (the ``has_segments`` branches of the three JAX kernels,
:330, :539 and :833): int32 segment ids q_seg (B, Sq) and kv_seg (B, Skv),
step bits from :func:`~repro_torch.kernels.schedule.segment_step_bits` in
the kernel's orientation (kv-major for fused and dK/dV, q-major for dQ).
Inactive steps are skipped; a kv tile with no active step gets zero dK and
dV, a q tile with none zero dQ. The delta pre-pass is row-wise and serves
both. Each is the same kernel source instantiated with ``SEG``, so the
split dK/dV stay bitwise the fused kernel's with segments too; the segment
kernels are built at every head dim of ``KERNEL_HEAD_DIMS`` (160 and 256
since packed training of stablelm-12b and gemma3-1b), and so are the dense
ones.

Every wrapper takes ``schedule="compact" | "dense"``. The dense one
replaces the dense bodies of the same three JAX kernels
(``_fused_kernel_dense`` :633, ``_dkv_kernel_dense`` :157,
``_dq_kernel_dense`` :390, each with its segment branch): the same CTAs,
with no table, walk every partner tile (the KV-stationary kernels every q
tile of every q head of the group, in JAX's ``(g, i)`` grid order; the dQ
kernel every kv tile, ascending), fetch it, classify it in the kernel
(``flash_fwd.visibility``) and skip the products of an empty one. The
visible tiles come in the compact order with the compact mask decisions,
so dense dK/dV and split dQ are the compact kernels' to the bit; the dense
fused dQ, summed by bulk reductions in no fixed order, agrees up to that
order.

Each wrapper takes its plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.masks import MaskSpec, apply_mask, make_tile_mask
from repro_torch.kernels import _build
from repro_torch.kernels.flash_fwd import (_check_kernel_inputs, _check_layout, _tiles, _Walk,
                                           check_segments, count_head_dim, count_launch,
                                           segment_args)
from repro_torch.kernels.schedule import (SMS, build_kv_tile_schedule, check_schedule,
                                          device_schedule)

# Head dims the backward kernels are instantiated for: 128 (qwen3), 64
# (whisper-base, the gpt presets), 160 (stablelm-12b) and 256 (gemma3-1b),
# each on the compact and the dense schedule, without and with segments
# (as the forward). Each wrapper also counts its
# head_dim-64, 160 and 256 launches apart (``hd64_launches``,
# ``hd160_launches``, ``hd256_launches``: subsets of its other counts).
KERNEL_HEAD_DIMS = (64, 128, 160, 256)


def kv_head_split(spec: MaskSpec, B: int, Sq: int, Skv: int, Hq: int, Hkv: int, D: int,
                  block_q: int, block_kv: int) -> int:
    """How many CTAs a kv tile the KV-stationary kernels (fused, dK/dV)
    take: 1, or at head_dim 160 and 256 (one kv tile a CTA) the group's
    size G, one q head a CTA, each writing f32 dK/dV partials that
    :func:`flash_bwd_group_sum` adds in a fixed order. A fixed rule of the
    shape and mask, never of the schedule or the segment ids (so dense,
    compact and segment kernels, fused and dK/dV, split alike and stay
    bitwise comparable): split where the plain grid, B * Hkv * t_kv CTAs,
    is under two waves of the card's SMs and its longest walk (G times the
    most visible q tiles of a kv tile) exceeds 1.5 times the balanced share
    of the steps (all of them over the SMs). gemma3-1b's causal training
    shape (128 CTAs, walks of 4 to 128 steps) splits; its 512 window (128
    even walks) and stablelm-12b's (512 CTAs) do not."""
    G = Hq // Hkv
    t_q, t_kv = _tiles(Sq, block_q), _tiles(Skv, block_kv)
    if D not in (160, 256) or G == 1 or B * Hkv * t_kv >= 2 * SMS:
        return 1
    steps = np.diff(build_kv_tile_schedule(spec, t_q, t_kv, block_q, block_kv, Skv).row_ptr)
    total = B * Hkv * G * int(steps.sum())
    return G if total and G * int(steps.max()) * SMS > 1.5 * total else 1


def kv_grid(B: int, Hkv: int, Skv: int, D: int, block_kv: int, hsplit: int) -> tuple:
    """The KV-stationary kernels' launch grid (``launch_kv`` in
    csrc/flash_bwd.cu): (B * Hkv, hsplit, t_kv) at head_dim 160 and 256,
    one kv tile a CTA; (B * Hkv, pairs of kv tiles, 1) at 64 and 128."""
    t_kv = _tiles(Skv, block_kv)
    return (B * Hkv, hsplit, t_kv) if D in (160, 256) else (B * Hkv, -(-t_kv // 2), 1)


def dq_grid(B: int, Hq: int, Sq: int, D: int, block_q: int) -> tuple:
    """The dQ kernel's launch grid (``launch_dq`` in csrc/flash_bwd.cu),
    (x, y), x fastest in CUDA's issue order: at head_dim 256 (B * Hq, t_q),
    one q tile a CTA, and at 160 (B * Hq, pairs of q tiles), batch * head on
    x, so that the first wave holds every head's longest causal walk
    (blockIdx.y = c takes q tile t_q - 1 - c, or the pair from q tile
    2 (pairs - 1 - c)); at 64 and 128 (pairs of q tiles, B * Hq)."""
    t_q = _tiles(Sq, block_q)
    ctas = t_q if D == 256 else -(-t_q // 2)
    return (B * Hq, ctas) if D in (160, 256) else (ctas, B * Hq)


def _count(wrapper, schedule: str, head_dim: int) -> None:
    count_launch(wrapper, schedule)
    count_head_dim(wrapper, head_dim)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_device(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda (kernel) or cpu (plain), not {t.device}")


# ------------------------------------------------------------------ delta


def flash_bwd_delta(o, do):
    """delta = rowsum(dO o O) in f32: o, do (B, Sq, Hq, D) -> (B, Hq, Sq)."""
    if o.shape != do.shape or o.ndim != 4:
        raise ValueError(f"want o and do (B,Sq,Hq,D); got {tuple(o.shape)}, {tuple(do.shape)}")
    if o.device.type == "cpu":
        return flash_bwd_delta_plain(o, do)
    _check_device("flash_bwd_delta", o)
    B, Sq, Hq, D = o.shape
    _check_kernel_inputs("the CUDA delta pre-pass", None, KERNEL_HEAD_DIMS, o=o, do=do)
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=o.device)
    err = _lib().fa2_bwd_delta_bf16(
        o.data_ptr(), do.data_ptr(), delta.data_ptr(),
        o.stride(0), o.stride(1), o.stride(2),
        do.stride(0), do.stride(1), do.stride(2),
        B, Hq, Sq, D, _stream(o),
    )
    _build.check(err, "fa2_bwd_delta_bf16")
    _count(flash_bwd_delta, "compact", D)
    return delta


flash_bwd_delta.launches = 0  # kernel launches (CUDA tensors only)
flash_bwd_delta.hd64_launches = 0  # of which at head_dim 64
flash_bwd_delta.hd160_launches = 0  # of which at head_dim 160
flash_bwd_delta.hd256_launches = 0  # of which at head_dim 256


def flash_bwd_delta_plain(o, do):
    """The pre-pass in plain PyTorch: f32 products summed over D."""
    flash_bwd_delta_plain.calls += 1
    return (o.float() * do.float()).sum(dim=-1).transpose(1, 2).contiguous()


flash_bwd_delta_plain.calls = 0


# ------------------------------------------------- fused, dkv and dq


def _check_bwd_inputs(q, k, v, do, lse, delta, segments=None):
    _check_layout(q, k, v)
    if segments is not None:
        check_segments(q, k, *segments)
    B, Sq, Hq, _ = q.shape
    if do.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} must match q {tuple(q.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B, Hq, Sq) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be f32 (B, Hq, Sq) = {(B, Hq, Sq)}; got "
                             f"{t.dtype} {tuple(t.shape)}")


def flash_bwd_fused(q, k, v, do, lse, delta, spec: MaskSpec, *, block_q: int, block_kv: int,
                    schedule: str = "compact"):
    """dq, dk, dv (f32) of FA2 on pre-scaled q. ``lse`` is the forward's raw
    logsumexp (-inf on fully masked rows); ``delta`` is the pre-pass's.
    ``schedule`` is one of ``schedule.SCHEDULES``."""
    return _fused(flash_bwd_fused, q, k, v, do, lse, delta, spec, None, block_q, block_kv,
                  schedule)


flash_bwd_fused.launches = 0  # compact kernel launches (CUDA tensors only)
flash_bwd_fused.dense_launches = 0  # dense kernel launches (CUDA tensors only)
flash_bwd_fused.hd64_launches = 0  # launches of either schedule at head_dim 64
flash_bwd_fused.hd160_launches = 0  # launches of either schedule at head_dim 160
flash_bwd_fused.hd256_launches = 0  # launches of either schedule at head_dim 256


def flash_bwd_fused_varlen(q, k, v, do, lse, delta, spec: MaskSpec, q_seg, kv_seg, *,
                           block_q: int, block_kv: int, schedule: str = "compact"):
    """The segment variant of :func:`flash_bwd_fused`."""
    return _fused(flash_bwd_fused_varlen, q, k, v, do, lse, delta, spec, (q_seg, kv_seg),
                  block_q, block_kv, schedule)


flash_bwd_fused_varlen.launches = 0  # compact kernel launches (CUDA tensors only)
flash_bwd_fused_varlen.dense_launches = 0  # dense kernel launches (CUDA tensors only)
flash_bwd_fused_varlen.hd64_launches = 0  # launches of either schedule at head_dim 64
flash_bwd_fused_varlen.hd160_launches = 0  # launches of either schedule at head_dim 160
flash_bwd_fused_varlen.hd256_launches = 0  # launches of either schedule at head_dim 256


def flash_bwd_dkv(q, k, v, do, lse, delta, spec: MaskSpec, *, block_q: int, block_kv: int,
                  schedule: str = "compact"):
    """dk, dv (f32, summed over the GQA group) of the split backward;
    arguments as :func:`flash_bwd_fused`."""
    return _dkv(flash_bwd_dkv, q, k, v, do, lse, delta, spec, None, block_q, block_kv,
                schedule)


flash_bwd_dkv.launches = 0  # compact kernel launches (CUDA tensors only)
flash_bwd_dkv.dense_launches = 0  # dense kernel launches (CUDA tensors only)
flash_bwd_dkv.hd64_launches = 0  # launches of either schedule at head_dim 64
flash_bwd_dkv.hd160_launches = 0  # launches of either schedule at head_dim 160
flash_bwd_dkv.hd256_launches = 0  # launches of either schedule at head_dim 256


def flash_bwd_dkv_varlen(q, k, v, do, lse, delta, spec: MaskSpec, q_seg, kv_seg, *,
                         block_q: int, block_kv: int, schedule: str = "compact"):
    """The segment variant of :func:`flash_bwd_dkv`."""
    return _dkv(flash_bwd_dkv_varlen, q, k, v, do, lse, delta, spec, (q_seg, kv_seg),
                block_q, block_kv, schedule)


flash_bwd_dkv_varlen.launches = 0  # compact kernel launches (CUDA tensors only)
flash_bwd_dkv_varlen.dense_launches = 0  # dense kernel launches (CUDA tensors only)
flash_bwd_dkv_varlen.hd64_launches = 0  # launches of either schedule at head_dim 64
flash_bwd_dkv_varlen.hd160_launches = 0  # launches of either schedule at head_dim 160
flash_bwd_dkv_varlen.hd256_launches = 0  # launches of either schedule at head_dim 256


def flash_bwd_dq(q, k, v, do, lse, delta, spec: MaskSpec, *, block_q: int, block_kv: int,
                 schedule: str = "compact"):
    """dq (f32, with respect to the scaled q) of the split backward;
    arguments as :func:`flash_bwd_fused`."""
    return _dq(flash_bwd_dq, q, k, v, do, lse, delta, spec, None, block_q, block_kv, schedule)


flash_bwd_dq.launches = 0  # compact kernel launches (CUDA tensors only)
flash_bwd_dq.dense_launches = 0  # dense kernel launches (CUDA tensors only)
flash_bwd_dq.hd64_launches = 0  # launches of either schedule at head_dim 64
flash_bwd_dq.hd160_launches = 0  # launches of either schedule at head_dim 160
flash_bwd_dq.hd256_launches = 0  # launches of either schedule at head_dim 256


def flash_bwd_dq_varlen(q, k, v, do, lse, delta, spec: MaskSpec, q_seg, kv_seg, *,
                        block_q: int, block_kv: int, schedule: str = "compact"):
    """The segment variant of :func:`flash_bwd_dq`."""
    return _dq(flash_bwd_dq_varlen, q, k, v, do, lse, delta, spec, (q_seg, kv_seg),
               block_q, block_kv, schedule)


flash_bwd_dq_varlen.launches = 0  # compact kernel launches (CUDA tensors only)
flash_bwd_dq_varlen.dense_launches = 0  # dense kernel launches (CUDA tensors only)
flash_bwd_dq_varlen.hd64_launches = 0  # launches of either schedule at head_dim 64
flash_bwd_dq_varlen.hd160_launches = 0  # launches of either schedule at head_dim 160
flash_bwd_dq_varlen.hd256_launches = 0  # launches of either schedule at head_dim 256


def _plain_kw(segments, block_q, block_kv, schedule):
    q_seg, kv_seg = segments if segments is not None else (None, None)
    return dict(block_q=block_q, block_kv=block_kv, q_seg=q_seg, kv_seg=kv_seg,
                schedule=schedule)


def _fused(wrapper, q, k, v, do, lse, delta, spec, segments, block_q, block_kv, schedule):
    _check_bwd_inputs(q, k, v, do, lse, delta, segments)
    check_schedule(schedule)
    if q.device.type == "cpu":
        return flash_bwd_fused_plain(q, k, v, do, lse, delta, spec,
                                     **_plain_kw(segments, block_q, block_kv, schedule))
    _check_device(wrapper.__name__, q)
    B, Sq, Hq, D = q.shape
    # dq is summed into by every kv-tile pair's CTA; dk and dv are written once.
    dq = torch.zeros((B, Sq, Hq, D), dtype=torch.float32, device=q.device)
    dk, dv = _launch_fused(q, k, v, do, lse, delta, spec, block_q, block_kv, dq, segments,
                           schedule)
    _count(wrapper, schedule, D)
    return dq, dk, dv


def _dkv(wrapper, q, k, v, do, lse, delta, spec, segments, block_q, block_kv, schedule):
    _check_bwd_inputs(q, k, v, do, lse, delta, segments)
    check_schedule(schedule)
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, spec,
                                   **_plain_kw(segments, block_q, block_kv, schedule))
    _check_device(wrapper.__name__, q)
    dk, dv = _launch_kv(False, q, k, v, do, lse, delta, spec, block_q, block_kv, None, segments,
                        schedule)
    _count(wrapper, schedule, q.shape[3])
    return dk, dv


def _dq(wrapper, q, k, v, do, lse, delta, spec, segments, block_q, block_kv, schedule):
    _check_bwd_inputs(q, k, v, do, lse, delta, segments)
    check_schedule(schedule)
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, spec,
                                  **_plain_kw(segments, block_q, block_kv, schedule))
    _check_device(wrapper.__name__, q)
    B, Sq, Hq, D = q.shape
    grid = dq_grid(B, Hq, Sq, D, block_q)
    if grid[1] > 65535:
        raise ValueError(f"the dQ kernel's grid {grid} exceeds the grid's y limit (65535)")
    # lse, delta and ``held`` (segment ids, step bits) stay alive until the launch.
    lse, delta = lse.contiguous(), delta.contiguous()
    args, held = _kernel_args("the CUDA dQ kernel", q, k, v, do, lse, delta, spec, block_q,
                              block_kv, segments, q_major=True, schedule=schedule)
    # Every q row is written once, zeros where it sees no key.
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    err = _lib().fa2_bwd_dq_bf16(*args[:6], dq.data_ptr(), *args[6:])
    _build.check(err, "fa2_bwd_dq_bf16")
    _count(wrapper, schedule, q.shape[3])
    return dq


def _launch_fused(q, k, v, do, lse, delta, spec, block_q, block_kv, dq, segments=None,
                  schedule="compact", hsplit=None):
    """Launch the fused kernel; returns (dk, dv). ``dq`` None launches the
    timing variant that computes dS K but skips its staging and bulk
    reduction into dq. ``hsplit`` None: :func:`kv_head_split`'s."""
    return _launch_kv(True, q, k, v, do, lse, delta, spec, block_q, block_kv, dq, segments,
                      schedule, hsplit)


def _launch_kv(fused, q, k, v, do, lse, delta, spec, block_q, block_kv, dq, segments, schedule,
               hsplit=None):
    """Launch the fused (``fused``: adding into ``dq``, or None) or the
    dK/dV kernel; returns (dk, dv). With a head split (``hsplit`` > 1;
    None: :func:`kv_head_split`'s) the kernel writes f32 partials (B, Skv,
    Hkv * hsplit, D) into scratch, which :func:`flash_bwd_group_sum` adds
    into dk and dv."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    if hsplit is None:
        hsplit = kv_head_split(spec, B, Sq, Skv, Hq, Hkv, D, block_q, block_kv)
    what = "the CUDA fused backward" if fused else "the CUDA dK/dV kernel"
    # lse, delta and ``held`` (segment ids, step bits) stay alive until the launch.
    lse, delta = lse.contiguous(), delta.contiguous()
    args, held = _kernel_args(what, q, k, v, do, lse, delta, spec, block_q, block_kv, segments,
                              q_major=False, schedule=schedule, hsplit=hsplit)
    dk, dv = _empty_dkv(q, k, hsplit)
    if fused:
        err = _lib().fa2_bwd_fused_bf16(*args[:6], None if dq is None else dq.data_ptr(),
                                        dk.data_ptr(), dv.data_ptr(), *args[6:])
        _build.check(err, "fa2_bwd_fused_bf16")
    else:
        err = _lib().fa2_bwd_dkv_bf16(*args[:6], dk.data_ptr(), dv.data_ptr(), *args[6:])
        _build.check(err, "fa2_bwd_dkv_bf16")
    return (dk, dv) if hsplit == 1 else flash_bwd_group_sum(dk, dv, Hkv)


def _empty_dkv(q, k, hsplit=1):
    """dk and dv (B, Skv, Hkv, D) f32, or with a head split their partials
    (B, Skv, Hkv * hsplit, D), the two halves of one scratch buffer:
    written once by the kernel, zeros where a kv tile sees no q row of the
    CTA's heads."""
    B, Skv, Hkv, D = k.shape
    if hsplit == 1:
        dk = torch.empty((B, Skv, Hkv, D), dtype=torch.float32, device=q.device)
        return dk, torch.empty_like(dk)
    parts = torch.empty((2, B, Skv, Hkv * hsplit, D), dtype=torch.float32, device=q.device)
    return parts[0], parts[1]


def flash_bwd_group_sum(part_k, part_v, hkv: int):
    """dk, dv (B, Skv, hkv, D) f32: each kv head's partials of a head split,
    ``part_k``, ``part_v`` (B, Skv, hkv * hsplit, D) f32, added in order
    (partial 0 first). A kernel that replaces no TPU kernel: the TPU's
    sequential grid sums a kv tile's q heads in one VMEM block; the Hopper
    grid splits them over CTAs where that fills the card
    (:func:`kv_head_split`)."""
    B, Skv, H, D = part_k.shape
    if part_v.shape != part_k.shape or H % hkv or part_k.dtype != torch.float32:
        raise ValueError(f"want f32 partials (B, Skv, {hkv} * hsplit, D) twice; got "
                         f"{part_k.dtype} {tuple(part_k.shape)}, {tuple(part_v.shape)}")
    if part_k.device.type == "cpu":
        return flash_bwd_group_sum_plain(part_k, part_v, hkv)
    _check_device("flash_bwd_group_sum", part_k)
    if not (part_k.is_contiguous() and part_v.is_contiguous()) or D % 4:
        raise ValueError("the group sum takes contiguous partials of a head_dim divisible by 4")
    dk = torch.empty((B, Skv, hkv, D), dtype=torch.float32, device=part_k.device)
    dv = torch.empty_like(dk)
    err = _lib().fa2_bwd_group_sum_f32(part_k.data_ptr(), part_v.data_ptr(), dk.data_ptr(),
                                       dv.data_ptr(), B * Skv * hkv, H // hkv, D,
                                       _stream(part_k))
    _build.check(err, "fa2_bwd_group_sum_f32")
    _count(flash_bwd_group_sum, "compact", D)
    return dk, dv


flash_bwd_group_sum.launches = 0  # kernel launches (CUDA tensors only)
flash_bwd_group_sum.hd160_launches = 0  # of which at head_dim 160
flash_bwd_group_sum.hd256_launches = 0  # of which at head_dim 256


def flash_bwd_group_sum_plain(part_k, part_v, hkv: int):
    """The group sum in plain PyTorch: the same f32 adds in the same order,
    so the same result to the bit."""
    flash_bwd_group_sum_plain.calls += 1
    out = []
    for part in (part_k, part_v):
        B, Skv, H, D = part.shape
        x = part.reshape(B, Skv, hkv, H // hkv, D)
        acc = x[:, :, :, 0].clone()
        for i in range(1, H // hkv):
            acc = acc + x[:, :, :, i]
        out.append(acc)
    return tuple(out)


flash_bwd_group_sum_plain.calls = 0


def _kernel_args(what, q, k, v, do, lse, delta, spec, block_q, block_kv, segments, *,
                 q_major: bool, schedule: str, hsplit: int = 1):
    """Check what the kernels take and build the arguments of a C entry
    around its outputs: the six input pointers, then the table (none for
    the dense schedule), strides, sizes, tiles, mask, owner-tile count,
    dense flag, the KV-stationary kernels' head split (``hsplit``), segment
    arguments and stream. ``lse`` and ``delta`` must be contiguous (the
    caller holds them until the launch). Returns (arguments, tensors to
    hold until the launch)."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    _check_kernel_inputs(what, (block_q, block_kv), KERNEL_HEAD_DIMS, q=q, k=k, v=v, do=do)
    if lse.device != q.device or delta.device != q.device:
        raise ValueError("lse and delta must lie on q's device")
    if not (lse.is_contiguous() and delta.is_contiguous()):
        raise ValueError("lse and delta must be contiguous")
    t_q, t_kv = _tiles(Sq, block_q), _tiles(Skv, block_kv)
    if not q_major and t_kv > 65535:
        raise ValueError("kv tiles exceed the grid's y limit (65535)")
    if hsplit != 1 and (q_major or D not in (160, 256) or (Hq // Hkv) % hsplit):
        raise ValueError(f"a head split of {hsplit} is taken by the KV-stationary kernels at "
                         f"head_dim 160 and 256 in whole shares of the group ({Hq // Hkv}); "
                         f"got head_dim {D}")
    dense = schedule == "dense"
    sched = None if dense else device_schedule(spec, t_q, t_kv, block_q, block_kv, Skv,
                                               not q_major, str(q.device))
    seg = segment_args(segments, sched, block_q, block_kv, kv_major=not q_major)
    return (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), None if dense else sched.table.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
        B, Hq, Hkv, Sq, Skv, D, block_q, block_kv,
        int(spec.causal), -1 if spec.window is None else int(spec.window),
        int(spec.sink), int(spec.q_offset), t_q if q_major else t_kv, int(dense),
        *(() if q_major else (hsplit,)), *seg.args, _stream(q),
    ), seg.keep


@functools.lru_cache(maxsize=1)
def _lib():
    lib = _build.load("flash_bwd")
    P, I, L = _build.VOIDP, _build.INT, _build.I64
    lib.fa2_bwd_delta_bf16.argtypes = [P] * 3 + [L] * 6 + [I] * 4 + [P]
    seg = [P, P, L, L, P, I]  # q ids, kv ids, their batch strides, step bits, steps
    lib.fa2_bwd_fused_bf16.argtypes = [P] * 10 + [L] * 12 + [I] * 15 + seg + [P]
    lib.fa2_bwd_dkv_bf16.argtypes = [P] * 9 + [L] * 12 + [I] * 15 + seg + [P]
    lib.fa2_bwd_dq_bf16.argtypes = [P] * 8 + [L] * 12 + [I] * 14 + seg + [P]
    lib.fa2_bwd_group_sum_f32.argtypes = [P] * 4 + [L, I, I, P]
    for fn in (lib.fa2_bwd_delta_bf16, lib.fa2_bwd_fused_bf16, lib.fa2_bwd_dkv_bf16,
               lib.fa2_bwd_dq_bf16, lib.fa2_bwd_group_sum_f32):
        fn.restype = ctypes.c_int
    return lib


# ------------------------------------------------------------ plain versions


class _Padded(NamedTuple):
    """The f32 operands of the plain versions, padded to whole tiles: rows
    past the ends read as zeros, as in the kernels; a q row past Sq gets
    lse = +inf (so P = 0 there) and delta = 0; a fully masked row's
    lse = -inf becomes 0. q-side tensors are split into (kv head, group)."""

    qh: torch.Tensor   # (B, t_q * bq, Hk, G, D)
    doh: torch.Tensor  # (B, t_q * bq, Hk, G, D)
    kp: torch.Tensor   # (B, t_kv * bk, Hk, D)
    vp: torch.Tensor   # (B, t_kv * bk, Hk, D)
    lse: torch.Tensor  # (B, Hk, G, t_q * bq)
    dl: torch.Tensor   # (B, Hk, G, t_q * bq)


def _padded(q, k, v, do, lse, delta, block_q, block_kv) -> _Padded:
    _check_bwd_inputs(q, k, v, do, lse, delta)
    B, Sq, Hq, D = q.shape
    _, Skv, Hk, _ = k.shape
    pq = _tiles(Sq, block_q) * block_q - Sq
    pk = _tiles(Skv, block_kv) * block_kv - Skv
    lse_s = torch.where(torch.isneginf(lse), torch.zeros_like(lse), lse)
    return _Padded(
        qh=F.pad(q, (0, 0, 0, 0, 0, pq)).reshape(B, -1, Hk, Hq // Hk, D).float(),
        doh=F.pad(do, (0, 0, 0, 0, 0, pq)).reshape(B, -1, Hk, Hq // Hk, D).float(),
        kp=F.pad(k, (0, 0, 0, 0, 0, pk)).float(),
        vp=F.pad(v, (0, 0, 0, 0, 0, pk)).float(),
        lse=F.pad(lse_s, (0, pq), value=float("inf")).reshape(B, Hk, Hq // Hk, -1),
        dl=F.pad(delta, (0, pq)).reshape(B, Hk, Hq // Hk, -1),
    )


def _tile_terms(x: _Padded, spec, i, j, block_q, block_kv, step, Skv, dt, seg):
    """P and the dS rounded to ``dt`` of tile (i, j), in f32 (B, Hk, G, bq,
    bk): Algorithm 2 lines 11, 13 and 14 (``_recompute_p`` and
    ``_dkv_tile_math`` of the JAX kernels). ``step`` is ``seg.step``'s
    (active rows, needs mask); the rows where the step is inactive get
    P = dS = 0, so they add nothing."""
    active, needs_mask = step
    r0, r1 = i * block_q, (i + 1) * block_q
    c0, c1 = j * block_kv, (j + 1) * block_kv
    sc = torch.einsum("bqhgd,bkhd->bhgqk", x.qh[:, r0:r1], x.kp[:, c0:c1])
    if needs_mask:
        rows = torch.arange(r0, r1, device=sc.device) + spec.q_offset
        cols = torch.arange(c0, c1, device=sc.device)
        vis = (cols < Skv)[None, :]
        tm = make_tile_mask(spec, rows, cols)
        vis = vis if tm is None else vis & tm
        sc = apply_mask(sc, seg.mask(vis, r0, r1, c0, c1))
    p = torch.exp(sc - x.lse[..., r0:r1, None])
    dp = torch.einsum("bqhgd,bkhd->bhgqk", x.doh[:, r0:r1], x.vp[:, c0:c1])
    ds = (p * (dp - x.dl[..., r0:r1, None])).to(dt).float()
    if active is not True:
        zero = torch.zeros_like(p)
        p, ds = seg.select(active, p, zero), seg.select(active, ds, zero)
    return p, ds


def _kv_major_walk(q, k, v, do, lse, delta, spec, block_q, block_kv, q_seg, kv_seg,
                   with_dq: bool, schedule: str):
    """The kv-major walk of the fused and dkv kernels in plain PyTorch
    (with segment ids: their varlen variants, steps skipped per batch row
    as ``flash_fwd_plain`` skips them; ``schedule="dense"``: every q tile,
    classified by ``flash_fwd.visibility``)."""
    B, Sq, Hq, D = q.shape
    _, Skv, _, _ = k.shape
    x = _padded(q, k, v, do, lse, delta, block_q, block_kv)
    t_q, t_kv = _tiles(Sq, block_q), _tiles(Skv, block_kv)
    walk = _Walk.of(schedule, spec, t_q, t_kv, block_q, block_kv, Skv, q_seg, kv_seg,
                    kv_major=True)
    dq = torch.zeros_like(x.qh)
    dk = torch.zeros_like(x.kp)
    dv = torch.zeros_like(x.vp)
    for j in range(t_kv):
        c0, c1 = j * block_kv, (j + 1) * block_kv
        for i, *step in walk.steps(j):
            r0, r1 = i * block_q, (i + 1) * block_q
            p, ds = _tile_terms(x, spec, i, j, block_q, block_kv, step, Skv, q.dtype, walk.seg)
            dv[:, c0:c1] += torch.einsum("bhgqk,bqhgd->bkhd", p.to(q.dtype).float(),
                                         x.doh[:, r0:r1])
            dk[:, c0:c1] += torch.einsum("bhgqk,bqhgd->bkhd", ds, x.qh[:, r0:r1])
            if with_dq:
                dq[:, r0:r1] += torch.einsum("bhgqk,bkhd->bqhgd", ds, x.kp[:, c0:c1])
    dk, dv = dk[:, :Skv].contiguous(), dv[:, :Skv].contiguous()
    return (dq[:, :Sq].reshape(B, Sq, Hq, D), dk, dv) if with_dq else (dk, dv)


def flash_bwd_fused_plain(q, k, v, do, lse, delta, spec: MaskSpec, *,
                          block_q: int, block_kv: int, q_seg=None, kv_seg=None,
                          schedule: str = "compact"):
    """The fused kernel's algorithm in plain PyTorch (f32 math, any device).

    The same kv-major walk over the same visible tiles, the same mask value,
    the lse = -inf -> 0 substitution of fully masked rows, and the same
    roundings to the input dtype: P before dV += P^T dO, dS before
    dK += dS^T Q and dQ += dS K (``_dkv_tile_math``/``_fused_compute`` of
    the JAX kernel). The G q heads of a kv head are summed together. With
    segment ids (both or neither) it is the varlen kernel's algorithm; with
    ``schedule="dense"``, the dense kernel's (the same steps, found by
    classifying every tile, so the same result to the bit)."""
    flash_bwd_fused_plain.calls += 1
    return _kv_major_walk(q, k, v, do, lse, delta, spec, block_q, block_kv, q_seg, kv_seg,
                          with_dq=True, schedule=schedule)


flash_bwd_fused_plain.calls = 0


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, spec: MaskSpec, *,
                        block_q: int, block_kv: int, q_seg=None, kv_seg=None,
                        schedule: str = "compact"):
    """The dkv kernel's algorithm in plain PyTorch: the fused walk without
    its dq line, so its dk and dv are bitwise the fused plain version's."""
    flash_bwd_dkv_plain.calls += 1
    return _kv_major_walk(q, k, v, do, lse, delta, spec, block_q, block_kv, q_seg, kv_seg,
                          with_dq=False, schedule=schedule)


flash_bwd_dkv_plain.calls = 0


def flash_bwd_dq_plain(q, k, v, do, lse, delta, spec: MaskSpec, *,
                       block_q: int, block_kv: int, q_seg=None, kv_seg=None,
                       schedule: str = "compact"):
    """The dq kernel's algorithm in plain PyTorch: the q-major walk over the
    forward's table, visible kv tiles in ascending order, each tile's terms
    by the fused walk's einsums. A q tile meets its kv tiles in the same
    ascending order in both walks, and skips the same steps of the same
    batch rows, so dq is bitwise the fused plain version's."""
    flash_bwd_dq_plain.calls += 1
    B, Sq, Hq, D = q.shape
    _, Skv, _, _ = k.shape
    x = _padded(q, k, v, do, lse, delta, block_q, block_kv)
    t_q, t_kv = _tiles(Sq, block_q), _tiles(Skv, block_kv)
    walk = _Walk.of(schedule, spec, t_q, t_kv, block_q, block_kv, Skv, q_seg, kv_seg,
                    kv_major=False)
    dq = torch.zeros_like(x.qh)
    for i in range(t_q):
        r0, r1 = i * block_q, (i + 1) * block_q
        for j, *step in walk.steps(i):
            _, ds = _tile_terms(x, spec, i, j, block_q, block_kv, step, Skv, q.dtype, walk.seg)
            dq[:, r0:r1] += torch.einsum("bhgqk,bkhd->bqhgd", ds,
                                         x.kp[:, j * block_kv:(j + 1) * block_kv])
    return dq[:, :Sq].reshape(B, Sq, Hq, D)


flash_bwd_dq_plain.calls = 0
