"""Chunked softmax cross-entropy over the (padded) vocabulary.

The counterpart of ``repro/training/losses.py``. Materializing the f32
logits of a whole batch, (B, S, V) with V = 152,064 for qwen3, would take
2.5 GB per 2,048-token row; the sequence is cut into chunks, each chunk's
logits are computed, reduced to its loss and freed, and recomputed in the
backward (``torch.utils.checkpoint``), so one chunk's logits are live at a
time.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint


def _chunk_ce(embed, hidden_c, targets_c, mask_c, vocab_valid: int):
    logits = embed.logits(hidden_c).float()
    V = logits.shape[-1]
    if vocab_valid < V:  # padded vocab entries out of the logsumexp
        pad = torch.arange(V, device=logits.device) >= vocab_valid
        logits = logits.masked_fill(pad, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets_c[..., None].long())[..., 0]
    nll = (lse - gold) * mask_c
    correct = (logits.argmax(dim=-1) == targets_c).float() * mask_c
    return nll.sum(), correct.sum()


def chunked_cross_entropy(
    embed,
    hidden: torch.Tensor,   # (B, S, d)
    targets: torch.Tensor,  # (B, S) int (padded-vocab ids never appear)
    *,
    vocab_valid: int,
    mask: Optional[torch.Tensor] = None,  # (B, S) 1.0 = count this position
    chunk: int = 512,
) -> Tuple[torch.Tensor, dict]:
    """Mean next-token NLL over the masked positions, and its metrics (the
    counterpart of ``chunked_cross_entropy``, JAX ``losses.py:37``).
    ``embed`` is the model's :class:`Embedding` (its ``logits`` unembeds,
    tied or not)."""
    B, S, _ = hidden.shape
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=hidden.device)
    n = S // chunk if S % chunk == 0 and S > chunk else 1
    c = S // n
    nll = torch.zeros((), dtype=torch.float32, device=hidden.device)
    correct = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n):
        sl = slice(i * c, (i + 1) * c)
        nll_c, correct_c = checkpoint(_chunk_ce, embed, hidden[:, sl], targets[:, sl],
                                      mask[:, sl], vocab_valid, use_reentrant=False)
        nll = nll + nll_c
        correct = correct + correct_c
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = nll / denom
    return loss, {"nll_sum": nll.detach(), "tokens": denom, "accuracy": correct / denom}
