"""Online-softmax merge of finalized attention partials.

The counterpart of ``merge_partials`` / ``combine_lse_outputs`` in
``repro/core/online_softmax.py``. Split-KV decode folds its per-split
``(o, lse)`` partials with these, as plain torch outside the kernel (the
JAX package leaves the same merge to XLA). :func:`fold_partials` is the
one-pass fold the split-KV forward's kernel does on the card, here as its
plain version.
"""

from __future__ import annotations

import torch


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
