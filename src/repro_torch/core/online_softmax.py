"""Online-softmax algebra (Milakov & Gimelshein 2018; FA2 Section 3.1).

The counterpart of ``repro/core/online_softmax.py``. The state of a row
block is a triple ``(m, l, o)``: the running row max, the running row sum
of exp(scores - m), and the output NOT yet divided by l, all f32. FA2's
tweak C1 keeps ``o`` unscaled through the KV loop and divides by ``l`` once
at the end (:func:`finalize`), which also gives the logsumexp the backward
keeps. :func:`combine` is associative, which is what lets the KV loop,
the split-KV decode and a merge of partials reach the same result.

Finalized partials ``(o, lse)`` merge with :func:`merge_partials` /
:func:`combine_lse_outputs`; :func:`fold_partials` is the one-pass fold
the split-KV forward's kernel does on the card, here as its plain version;
:func:`merge_running` merges two running states, as the head_dim-256
forward's warpgroups do in one-q-tile mode.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SoftmaxState(NamedTuple):
    m: torch.Tensor  # (..., rows)
    l: torch.Tensor  # (..., rows)
    o: torch.Tensor  # (..., rows, d) -- unscaled


def init_state(rows_shape, d, dtype=torch.float32, device=None) -> SoftmaxState:
    """The state of rows that have seen no key: m = -inf, l = 0, o = 0."""
    return SoftmaxState(
        m=torch.full(rows_shape, float("-inf"), dtype=dtype, device=device),
        l=torch.zeros(rows_shape, dtype=dtype, device=device),
        o=torch.zeros((*rows_shape, d), dtype=dtype, device=device),
    )


def block_state(s: torch.Tensor, v: torch.Tensor) -> SoftmaxState:
    """State for a single block of scores s (..., rows, cols) against v
    (..., cols, d)."""
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    return SoftmaxState(m=m, l=p.sum(dim=-1), o=p @ v)


def combine(a: SoftmaxState, b: SoftmaxState) -> SoftmaxState:
    """Merge two online-softmax states (associative); a state whose m is
    -inf adds nothing."""
    m = torch.maximum(a.m, b.m)
    zero = torch.zeros_like(m)
    alpha_a = torch.where(torch.isneginf(a.m), zero, torch.exp(a.m - m))
    alpha_b = torch.where(torch.isneginf(b.m), zero, torch.exp(b.m - m))
    return SoftmaxState(m=m, l=a.l * alpha_a + b.l * alpha_b,
                        o=a.o * alpha_a[..., None] + b.o * alpha_b[..., None])


def finalize(s: SoftmaxState):
    """-> (o, lse): the softmax-weighted output and the row logsumexp; a row
    with l = 0 (no key seen) gives o = 0 and lse = -inf."""
    empty = s.l == 0.0
    l_safe = torch.where(empty, torch.ones_like(s.l), s.l)
    o = s.o / l_safe[..., None]
    lse = torch.where(empty, torch.full_like(s.m, float("-inf")), s.m + torch.log(l_safe))
    return o, lse


def merge_running(a, b):
    """Merge two running (un-normalised) online-softmax states of the same
    rows, each (m, l, acc): m (..., rows) the running max, l (..., rows) the
    row sums and acc (..., rows, d) the output, both relative to m. The
    result is the state one walk over both states' steps would reach, up to
    summation order: a state with no step (m = -inf, l = 0) adds nothing,
    and rows whose max is the mask value in both add both sums, as one walk
    would (finalised partials cannot: their lse has absorbed log l). The
    merge of the forward's one-q-tile mode, whose two warpgroups each walk
    every second step of a tile (``kernels/flash_fwd.py``)."""
    (m_a, l_a, acc_a), (m_b, l_b, acc_b) = a, b
    m = torch.maximum(m_a, m_b)
    m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    w_a, w_b = torch.exp(m_a - m_safe), torch.exp(m_b - m_safe)  # exp(-inf) = 0
    return m, l_a * w_a + l_b * w_b, acc_a * w_a[..., None] + acc_b * w_b[..., None]


def merge_partials(o_a, lse_a, o_b, lse_b):
    """Pairwise merge of two *finalized* partials (o (..., rows, d), lse
    (..., rows); -inf marks rows that saw no keys). Associative and
    commutative; an all -inf partial is the identity."""
    m = torch.maximum(lse_a, lse_b)
    m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    w_a = torch.where(torch.isneginf(lse_a), torch.zeros_like(m), torch.exp(lse_a - m_safe))
    w_b = torch.where(torch.isneginf(lse_b), torch.zeros_like(m), torch.exp(lse_b - m_safe))
    l = w_a + w_b
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = (o_a * w_a[..., None] + o_b * w_b[..., None]) / l_safe[..., None]
    lse = torch.where(l == 0.0, torch.full_like(l, float("-inf")), m + torch.log(l_safe))
    return o, lse


def combine_lse_outputs(o_parts: torch.Tensor, lse_parts: torch.Tensor):
    """Fold partials stacked on axis 0 (o (P, ..., rows, d), lse (P, ...,
    rows)) by the same balanced tree of :func:`merge_partials` as the JAX
    package, so both merge in the same order."""
    o, lse = o_parts, lse_parts
    while o.shape[0] > 1:
        h = o.shape[0] // 2
        o_m, lse_m = merge_partials(o[:h], lse[:h], o[h: 2 * h], lse[h: 2 * h])
        if o.shape[0] % 2:
            o_m = torch.cat([o_m, o[2 * h:]], dim=0)
            lse_m = torch.cat([lse_m, lse[2 * h:]], dim=0)
        o, lse = o_m, lse_m
    return o[0], lse[0]


def fold_partials(o_parts: torch.Tensor, lse_parts: torch.Tensor, dim: int):
    """Fold partials stacked on ``dim`` of lse (o has it at the same place,
    with a trailing head dim) in one pass: with m the largest lse, o = sum
    of exp(lse_s - m) * o_s over l = sum of exp(lse_s - m), lse = m +
    log(l). The same function as :func:`combine_lse_outputs`, in the
    summation order of the split-KV forward's fold kernel; rows with every
    split at -inf give (0, -inf)."""
    m = lse_parts.amax(dim=dim, keepdim=True)
    m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    w = torch.exp(lse_parts - m_safe)  # exp(-inf) = 0 for splits that saw nothing
    l = w.sum(dim=dim, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = (o_parts * w.unsqueeze(-1)).sum(dim=dim) / l_safe.squeeze(dim).unsqueeze(-1)
    lse = torch.where(l == 0.0, torch.full_like(l, float("-inf")), m_safe + torch.log(l_safe))
    return o, lse.squeeze(dim)
