"""Online-softmax merge of finalized attention partials.

The counterpart of ``merge_partials`` / ``combine_lse_outputs`` in
``repro/core/online_softmax.py``. Split-KV decode folds its per-split
``(o, lse)`` partials with these, as plain torch outside the kernel (the
JAX package leaves the same merge to XLA). :func:`fold_partials` is the
one-pass fold the split-KV forward's kernel does on the card, here as its
plain version; :func:`merge_running` merges two running states, as the
head_dim-256 forward's warpgroups do in one-q-tile mode.
"""

from __future__ import annotations

import torch


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
