"""Split-KV flash decode: the Hopper CUDA kernels and their plain versions.

Two kernels, both in ``csrc/flash_decode.cu`` (its header says what bounds
them on an H100 and how the design answers):

* :func:`flash_decode` replaces the Pallas TPU kernel
  ``repro/kernels/flash_decode.py:77 flash_decode_kernel``, and
  :func:`flash_decode_varlen` its packed-cache segment branch (the same
  kernel source instantiated with ``SEG``). k/v are the contiguous serving cache
  (B, S, Hkv, D), read in place. Its split geometry is the kernel's
  (ceil-div, 8-aligned chunks with a masked tail), not ``core/decode.py``'s
  (which degrades ``num_splits`` until it divides S): :func:`decode_geometry`.
  Inside the kernel a split's visible 16-row units are dealt to eight warps
  (two CTAs of a cluster) and merged back into the split's one partial:
  :func:`decode_deal`.
* :func:`flash_decode_paged` replaces ``flash_decode.py:250
  flash_decode_paged_kernel``. k/v are the page pool's planes
  (Hkv, P, page_size, D), read through an int32 block table (B, n_pages) of
  physical page ids (0 = the null page); each split covers ``pp`` logical
  pages, the JAX geometry: :func:`paged_geometry`. Its pages are dealt to
  the warps in the same way: :func:`paged_deal`.

Common layouts: q (B*Hkv, G, D) pre-scaled, the G q heads of each kv head
together; lengths (B,) int32 visible entries per row (the JAX kernels take
them repeated per kv head). Both return per-split partials in the JAX
layout, o_parts (B*Hkv, ns, G, D) f32 and lse_parts (B*Hkv, ns, G) f32, for
``online_softmax.combine_lse_outputs`` to fold.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.masks import DEFAULT_MASK_VALUE
from repro_torch.kernels import _build

# Head dims the kernels are instantiated for: the contiguous decode at 128
# (qwen3), 64 (whisper, granite-moe), 160 (stablelm) and 256 (gemma3), the
# paged decode at 128, 64, 160 and 256.
KERNEL_HEAD_DIMS = (64, 128, 160, 256)
PAGED_HEAD_DIMS = (64, 128, 160, 256)
KERNEL_MAX_GROUP = 8


def decode_geometry(S: int, num_splits: int):
    """(ns, chunk): ``ns`` splits of ``chunk`` (a multiple of 8) positions
    covering a cache of S, as ``flash_decode_kernel`` resolves them."""
    ns = max(1, min(num_splits, -(-S // 8)))
    chunk = -(-(-(-S // ns)) // 8) * 8
    return -(-S // chunk), chunk


# Both kernels' workers per split (a cluster of 2 CTAs of 4 warps), and the
# contiguous kernel's unit of work: 16 cache rows, an mma.sync fragment.
DECODE_WORKERS = PAGED_WORKERS = 8
DECODE_UNIT = 16


def _unit_runs(limit: int, size: int, u0: int, u1: int, win_lo: int, sink: int):
    """The units in [u0, u1) (unit u: positions [u size, u size + size))
    that hold a visible position, as ascending, disjoint (start, stop) runs:
    at most two, the sink's and the window's. A position is visible below
    ``limit`` and at or past ``win_lo`` or before ``sink`` (no window:
    ``win_lo = sink = 0``). ``VisibleUnits`` in ``csrc/flash_decode.cu``."""
    past = -(-limit // size)  # units with a position before the limit
    sink_end = max(u0, min(u1, -(-min(sink, limit) // size)))
    win0 = max(u0, max(win_lo, 0) // size)
    win1 = max(win0, min(u1, past))
    runs = [(u0, sink_end), (win0, win1)]
    if sink_end >= win0:  # the two meet: one run
        runs = [(u0, max(sink_end, win1))]
    return [(a, b) for a, b in runs if b > a]


def _deal(units, workers: int):
    """Visible units, in order, dealt to ``workers`` in contiguous runs:
    worker ``k`` of ``n`` takes ordinals ``[k n // workers, (k + 1) n //
    workers)``."""
    n = len(units)
    return [units[k * n // workers:(k + 1) * n // workers] for k in range(workers)]


def decode_deal(length: int, S: int, num_splits: int = 8, window: Optional[int] = None,
                sink: int = 0, workers: int = DECODE_WORKERS, unit: int = DECODE_UNIT):
    """How the contiguous kernel deals a sequence's cache: per split of
    :func:`decode_geometry`, per worker (warp ``w`` of cluster rank ``r`` is
    worker ``4 r + w``), the starts of the ``unit``-row units it reads,
    ascending. Units are counted from the split's start ``lo``; a unit holds
    positions ``[start, start + unit)`` cut at the split's end ``min(lo +
    chunk, S, length)``, past which nothing is read. The split's units with
    a visible position (below the length; with a window at or past ``length
    - window`` or before the sink) go to the workers as :func:`paged_deal`
    deals pages, and the kernel merges the workers in worker order, which is
    position order."""
    ns, chunk = decode_geometry(S, num_splits)
    L = max(min(length, S), 0)
    win_lo = 0 if window is None else max(L - window, 0)
    sk = 0 if window is None else sink
    deal = []
    for c in range(ns):
        lo = c * chunk
        end = min(lo + chunk, S, L)
        n_units = -(-(end - lo) // unit) if end > lo else 0
        runs = _unit_runs(end - lo, unit, 0, n_units, win_lo - lo, sk - lo)
        deal.append(_deal([lo + u * unit for a, b in runs for u in range(a, b)], workers))
    return deal


def _check_layout(q, k, v, lengths, segments=None):
    if q.ndim != 3 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B*Hkv,G,D), k/v (B,S,Hkv,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, Hkv, D = k.shape
    if q.shape[0] != B * Hkv or q.shape[2] != D or lengths.shape != (B,):
        raise ValueError(f"q {tuple(q.shape)} / lengths {tuple(lengths.shape)} "
                         f"do not match the cache {tuple(k.shape)}")
    if segments is not None and (tuple(segments[0].shape) != (B, S)
                                 or tuple(segments[1].shape) != (B,)):
        raise ValueError(f"segments must be kv_seg {(B, S)} and q_seg {(B,)}, got "
                         f"{tuple(segments[0].shape)} and {tuple(segments[1].shape)}")


def flash_decode(q, k, v, lengths, *, num_splits: int = 8,
                 window: Optional[int] = None, sink: int = 0):
    """Per-split decode partials. See the module docstring for layouts."""
    _check_layout(q, k, v, lengths)
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, lengths, num_splits=num_splits,
                                  window=window, sink=sink)
    out = _launch(q, k, v, lengths, num_splits, window, sink, None)
    flash_decode.launches += 1
    return out


flash_decode.launches = 0  # kernel launches (CUDA tensors only)


def flash_decode_varlen(q, k, v, lengths, kv_seg, q_seg, *, num_splits: int = 8,
                        window: Optional[int] = None, sink: int = 0):
    """Packed decode: :func:`flash_decode` over a packed cache, int32 ids
    kv_seg (B, S) and q_seg (B,) on q's device; a position is visible only
    where ``kv_seg[b] == q_seg[b]``. The kernel's ``SEG`` instantiation."""
    segments = (kv_seg, q_seg)
    _check_layout(q, k, v, lengths, segments)
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, lengths, num_splits=num_splits, window=window,
                                  sink=sink, segments=segments)
    for name, t in (("kv_seg", kv_seg), ("q_seg", q_seg)):
        if t.dtype != torch.int32 or t.device != q.device or t.stride(-1) != 1:
            raise ValueError(f"{name} must be int32 on {q.device} with a unit last stride")
    out = _launch(q, k, v, lengths, num_splits, window, sink, segments)
    flash_decode_varlen.launches += 1
    return out


flash_decode_varlen.launches = 0  # kernel launches (CUDA tensors only)


def _launch(q, k, v, lengths, num_splits, window, sink, segments):
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode runs on cuda (kernel) or cpu (plain), not {q.device}")
    B, S, Hkv, D = k.shape
    G = q.shape[1]
    _check_kernel_inputs(q, k, v, lengths)
    seg_args = (None, 0, None)
    if segments is not None:
        kv_seg, q_seg = segments
        seg_args = (kv_seg.data_ptr(), kv_seg.stride(0), q_seg.data_ptr())
    ns, chunk = decode_geometry(S, num_splits)
    o_parts = torch.empty((B * Hkv, ns, G, D), dtype=torch.float32, device=q.device)
    lse_parts = torch.empty((B * Hkv, ns, G), dtype=torch.float32, device=q.device)
    err = _lib().fa2_decode_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        o_parts.data_ptr(), lse_parts.data_ptr(),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        B, Hkv, G, S, D, chunk, ns,
        -1 if window is None else int(window), int(sink), *seg_args,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "fa2_decode_bf16")
    return o_parts, lse_parts



def _check_kernel_inputs(q, k, v, lengths):
    _check_kernel_common(q, k, v, lengths, KERNEL_HEAD_DIMS)
    for name, t in (("k", k), ("v", v)):
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]):
            raise ValueError(f"{name} needs a unit last stride and the others multiples "
                             f"of 8, got strides {t.stride()}")


def _check_kernel_common(q, k, v, lengths, head_dims):
    for name, t in (("q", q), ("k", k), ("v", v), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the CUDA decode takes bfloat16; {name} is {t.dtype}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous (B*Hkv, G, D)")
    if lengths.dtype != torch.int32 or not lengths.is_contiguous():
        raise TypeError("lengths must be a contiguous int32 tensor")
    if q.shape[2] not in head_dims:
        raise ValueError(f"the CUDA decode supports head_dim in {head_dims}, got {q.shape[2]}")
    if q.shape[1] > KERNEL_MAX_GROUP:
        raise ValueError(f"the CUDA decode supports up to {KERNEL_MAX_GROUP} q heads "
                         f"per kv head, got {q.shape[1]}")


@functools.lru_cache(maxsize=1)
def _lib():
    lib = _build.load("flash_decode")
    P, I, L = _build.VOIDP, _build.INT, _build.I64
    lib.fa2_decode_bf16.argtypes = [P] * 6 + [L] * 6 + [I] * 9 + [P, L, P, P]
    lib.fa2_decode_bf16.restype = ctypes.c_int
    lib.fa2_decode_paged_bf16.argtypes = [P] * 7 + [I] * 11 + [P]
    lib.fa2_decode_paged_bf16.restype = ctypes.c_int
    return lib


def flash_decode_plain(q, k, v, lengths, *, num_splits: int = 8,
                       window: Optional[int] = None, sink: int = 0, segments=None):
    """The JAX decode kernel's function in plain PyTorch, all splits at
    once: per split, the max over the whole chunk (masked positions take
    DEFAULT_MASK_VALUE), P rounded to the cache dtype before P V, and
    (0, -inf) for a split with no visible position. ``segments`` (kv_seg
    (B, S), q_seg (B,)): only positions with ``kv_seg == q_seg`` are
    visible; ids past S read as -1."""
    flash_decode_plain.calls += 1
    _check_layout(q, k, v, lengths, segments)
    B, S, Hk, D = k.shape
    G = q.shape[1]
    ns, chunk = decode_geometry(S, num_splits)
    pad = ns * chunk - S

    def split(x):  # (B, S, Hk, D) -> (B, Hk, ns, chunk, D), zero tail
        return F.pad(x, (0, 0, 0, 0, 0, pad)).permute(0, 2, 1, 3).reshape(B, Hk, ns, chunk, D)

    kc, vc = split(k), split(v)
    s = torch.einsum("bhgd,bhncd->bhngc", q.reshape(B, Hk, G, D).float(), kc.float())
    cols = torch.arange(ns * chunk, device=q.device).reshape(ns, chunk)
    L = lengths.to(q.device).long()[:, None, None]
    valid = cols[None] < L  # (B, ns, chunk)
    if window is not None:
        in_win = cols[None] >= L - window
        if sink:
            in_win = in_win | (cols[None] < sink)
        valid = valid & in_win
    if segments is not None:
        kv_seg, q_seg = (x.to(q.device).long() for x in segments)
        ids = F.pad(kv_seg, (0, pad), value=-1).reshape(B, ns, chunk)
        valid = valid & (ids == q_seg[:, None, None])
    valid = valid[:, None, :, None, :]  # (B, 1, ns, 1, chunk)
    s = s.masked_fill(~valid, DEFAULT_MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    any_valid = valid.any(dim=-1, keepdim=True)
    l = torch.where(any_valid, p.sum(dim=-1, keepdim=True), torch.zeros_like(m))
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.einsum("bhngc,bhncd->bhngd", p.to(v.dtype).float(), vc.float()) / l_safe
    lse = torch.where(l == 0.0, torch.full_like(l, float("-inf")), m + torch.log(l_safe))
    o = torch.where(any_valid, o, torch.zeros_like(o))
    return o.reshape(B * Hk, ns, G, D), lse.reshape(B * Hk, ns, G)


flash_decode_plain.calls = 0




def paged_geometry(n_pages: int, num_splits: int):
    """(ns, pp): ``ns`` splits of ``pp`` logical pages each over a block
    table of ``n_pages`` columns, as ``flash_decode_paged_kernel`` resolves
    them (the last split may hold fewer)."""
    ns = max(1, min(num_splits, n_pages))
    pp = -(-n_pages // ns)
    return -(-n_pages // pp), pp


def paged_visible_runs(length: int, ps: int, page0: int, page1: int,
                       window: Optional[int] = None, sink: int = 0):
    """The logical pages in [page0, page1) that hold a visible position of a
    sequence of ``length``, as ascending, disjoint (start, stop) runs: at most
    two, the sink's pages and the window's (one without a window). A page is
    visible as in ``flash_decode_paged_plain``: it starts before the length
    and, with a window, ends past ``length - window`` or starts before the
    sink."""
    if window is None:
        return _unit_runs(length, ps, page0, page1, 0, 0)
    return _unit_runs(length, ps, page0, page1, max(length - window, 0), sink)


def paged_deal(length: int, ps: int, n_pages: int, num_splits: int = 8,
               window: Optional[int] = None, sink: int = 0, workers: int = PAGED_WORKERS):
    """How the paged kernel deals a sequence's pages: per split of
    :func:`paged_geometry`, per worker (warp ``w`` of cluster rank ``r`` is
    worker ``4 r + w``), the logical pages it reads, ascending. The split's
    visible pages, in logical order, go to the workers in contiguous runs:
    worker ``k`` of ``n`` visible pages takes ordinals ``[k n // workers,
    (k + 1) n // workers)``. The kernel merges the workers' partials in
    worker order, which is logical order."""
    ns, pp = paged_geometry(n_pages, num_splits)
    length = max(min(length, n_pages * ps), 0)
    return [_deal([p for a, b in paged_visible_runs(length, ps, c * pp, min(c * pp + pp, n_pages),
                                                    window, sink) for p in range(a, b)], workers)
            for c in range(ns)]


def _check_paged_layout(q, k_pages, v_pages, lengths, block_table):
    if q.ndim != 3 or k_pages.ndim != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(f"want q (B*Hkv,G,D), k/v pages (Hkv,P,ps,D); got "
                         f"{tuple(q.shape)}, {tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    Hkv, _, _, D = k_pages.shape
    if block_table.ndim != 2:
        raise ValueError(f"want block_table (B, n_pages), got {tuple(block_table.shape)}")
    B = block_table.shape[0]
    if q.shape[0] != B * Hkv or q.shape[2] != D or lengths.shape != (B,):
        raise ValueError(f"q {tuple(q.shape)} / lengths {tuple(lengths.shape)} / table "
                         f"{tuple(block_table.shape)} do not match the pages {tuple(k_pages.shape)}")


def flash_decode_paged(q, k_pages, v_pages, lengths, block_table, *, num_splits: int = 8,
                       window: Optional[int] = None, sink: int = 0):
    """Per-split decode partials read through a block table. See the module
    docstring for layouts. The table is trusted (the serving engine builds
    it): an entry outside the pool reads the null page on the card."""
    _check_paged_layout(q, k_pages, v_pages, lengths, block_table)
    if q.device.type == "cpu":
        return flash_decode_paged_plain(q, k_pages, v_pages, lengths, block_table,
                                        num_splits=num_splits, window=window, sink=sink)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_paged runs on cuda (kernel) or cpu (plain), "
                         f"not {q.device}")
    Hkv, P, ps, D = k_pages.shape
    B, n_pages = block_table.shape
    G = q.shape[1]
    _check_kernel_common(q, k_pages, v_pages, lengths, PAGED_HEAD_DIMS)
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages), ("block_table", block_table)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if block_table.dtype != torch.int32 or block_table.device != q.device:
        raise TypeError(f"block_table must be int32 on {q.device}")
    ns, pp = paged_geometry(n_pages, num_splits)
    o_parts = torch.empty((B * Hkv, ns, G, D), dtype=torch.float32, device=q.device)
    lse_parts = torch.empty((B * Hkv, ns, G), dtype=torch.float32, device=q.device)
    err = _lib().fa2_decode_paged_bf16(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), lengths.data_ptr(),
        block_table.data_ptr(), o_parts.data_ptr(), lse_parts.data_ptr(),
        B, Hkv, G, P, ps, n_pages, D, pp, ns,
        -1 if window is None else int(window), int(sink),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "fa2_decode_paged_bf16")
    flash_decode_paged.launches += 1
    return o_parts, lse_parts


flash_decode_paged.launches = 0  # kernel launches (CUDA tensors only)


def flash_decode_paged_plain(q, k_pages, v_pages, lengths, block_table, *,
                             num_splits: int = 8, window: Optional[int] = None,
                             sink: int = 0):
    """The JAX paged decode kernel's function in plain PyTorch: every
    (row, split) at once, a loop over the ``pp`` logical pages of a split,
    each page one online-softmax step as in ``_paged_decode_kernel``: a page
    with no visible column is skipped, masked columns of an active page take
    DEFAULT_MASK_VALUE, alpha = 0 while the running max is -inf, P is cast
    to the cache dtype before P V, and a split that saw nothing gives
    (0, -inf)."""
    flash_decode_paged_plain.calls += 1
    _check_paged_layout(q, k_pages, v_pages, lengths, block_table)
    Hk, _, ps, D = k_pages.shape
    B, n_pages = block_table.shape
    G = q.shape[1]
    ns, pp = paged_geometry(n_pages, num_splits)
    dev = q.device
    qf = q.float().reshape(B, Hk, 1, G, D)
    L = lengths.to(dev).long().reshape(B, 1, 1)
    tbl = block_table.to(dev).long()
    heads = torch.arange(Hk, device=dev).reshape(1, Hk, 1)
    splits = torch.arange(ns, device=dev)
    m = torch.full((B, Hk, ns, G, 1), float("-inf"), device=dev)
    l = torch.zeros((B, Hk, ns, G, 1), device=dev)
    acc = torch.zeros((B, Hk, ns, G, D), device=dev)
    for p in range(pp):
        logical = splits * pp + p  # (ns,) logical page of this step in each split
        exists = logical < n_pages
        phys = tbl[:, logical.clamp(max=n_pages - 1)]  # (B, ns)
        k = k_pages[heads, phys[:, None]].float()  # (B, Hk, ns, ps, D)
        v = v_pages[heads, phys[:, None]]
        base = (logical * ps).reshape(1, ns, 1)
        active = exists.reshape(1, ns, 1) & (base < L)  # (B, ns, 1)
        cols = base + torch.arange(ps, device=dev)  # (1, ns, ps)
        valid = cols < L
        if window is not None:
            in_win = base + ps > L - window
            col_win = cols >= L - window
            if sink:
                in_win = in_win | (base < sink)
                col_win = col_win | (cols < sink)
            active = active & in_win
            valid = valid & col_win
        s = torch.einsum("bhngd,bhncd->bhngc", qf.expand(-1, -1, ns, -1, -1), k)
        s = s.masked_fill(~valid[:, None, :, None, :], DEFAULT_MASK_VALUE)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.where(torch.isneginf(m), torch.zeros_like(m), torch.exp(m - m_new))
        pexp = torch.exp(s - m_new)
        pv = torch.einsum("bhngc,bhncd->bhngd", pexp.to(v.dtype).float(), v.float())
        on = active[:, None, :, None, :]  # (B, 1, ns, 1, 1)
        l = torch.where(on, l * alpha + pexp.sum(dim=-1, keepdim=True), l)
        acc = torch.where(on, acc * alpha + pv, acc)
        m = torch.where(on, m_new, m)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = acc / l_safe
    lse = torch.where(l == 0.0, torch.full_like(l, float("-inf")), m + torch.log(l_safe))
    return o.reshape(B * Hk, ns, G, D), lse.reshape(B * Hk, ns, G)


flash_decode_paged_plain.calls = 0
