"""Split-KV flash decode in PyTorch: FA2's sequence-dimension parallelism
(C2) applied to autoregressive inference.

The counterpart of ``repro/core/decode.py``, and the decode that
``impl="flash_torch"`` takes. At decode there is one query per sequence,
so the (batch x heads) grid alone under-fills the device; the paper's fix
splits the KV axis into ``num_splits`` chunks, computes a locally
normalised (o_i, lse_i) per chunk, all chunks at once, and merges them with
the associative online-softmax combine (``combine_lse_outputs``). Plain
PyTorch: the CUDA decode kernels are ``kernels/flash_decode.py``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.core.masks import DEFAULT_MASK_VALUE
from repro_torch.core.online_softmax import SoftmaxState, combine_lse_outputs, finalize


def flash_decode(
    q: torch.Tensor,  # (B, 1, Hq, D) -- one new token per sequence
    k_cache: torch.Tensor,  # (B, S, Hkv, D)
    v_cache: torch.Tensor,  # (B, S, Hkv, D)
    cache_length: torch.Tensor,  # (B,) int: number of valid cache entries
    *,
    window: Optional[int] = None,
    sink: int = 0,
    scale: Optional[float] = None,
    num_splits: int = 8,
    kv_segment_ids: Optional[torch.Tensor] = None,  # (B, S) int
    q_segment: Optional[torch.Tensor] = None,  # (B,) int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact attention of one query against a (padded) KV cache.

    The query attends to cache positions [max(0, L - window), L) where L =
    cache_length[b] (it sits at position L - 1, after its own K/V row was
    appended), plus the first ``sink`` positions under a window.
    ``kv_segment_ids`` / ``q_segment`` restrict it to its own segment of a
    packed cache; the window still counts global tail positions. A row of
    length 0 gets lse = -inf and an o that means nothing (0 where more
    than one split is merged), as in the JAX package.

    The split count is the largest divisor of S at most ``num_splits``.
    Returns (o (B, 1, Hq, D), lse (B, Hq, 1) f32)."""
    B, one, Hq, D = q.shape
    if one != 1:
        raise ValueError("flash_decode is a single-step primitive; loop outside")
    _, S, Hk, _ = k_cache.shape
    G = Hq // Hk
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    ns = num_splits
    while S % ns:
        ns -= 1
    sc = S // ns

    qf = (q.float() * scale).reshape(B, Hk, G, D)
    kc = k_cache.transpose(1, 2).reshape(B, Hk, ns, sc, D)
    vc = v_cache.transpose(1, 2).reshape(B, Hk, ns, sc, D)
    # (B, Hk, G, ns, sc): every split at once -- C2 for decode.
    s = torch.einsum("bhgd,bhcsd->bhgcs", qf, kc.float())
    pos = torch.arange(S, dtype=torch.int32, device=q.device).reshape(ns, sc)
    length = cache_length.to(device=q.device, dtype=torch.int32)[:, None, None]
    valid = pos[None] < length  # (B, ns, sc)
    if kv_segment_ids is not None:
        if q_segment is None:
            raise ValueError("packed decode needs the query's segment id (q_segment)")
        valid = valid & (kv_segment_ids.to(q.device).reshape(B, ns, sc)
                         == q_segment.to(q.device)[:, None, None])
    if window is not None:
        in_win = pos[None] >= length - window
        if sink:
            in_win = in_win | (pos[None] < sink)
        valid = valid & in_win
    s = torch.where(valid[:, None, None], s, torch.full_like(s, DEFAULT_MASK_VALUE))

    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    # A split with no valid position has m == the mask value and p == 1:
    # its l is set to 0, so it finalises to lse = -inf and vanishes below.
    any_valid = valid.any(dim=-1)[:, None, None]  # (B, 1, 1, ns)
    l = torch.where(any_valid, p.sum(dim=-1), torch.zeros_like(m))
    o_unscaled = torch.einsum("bhgcs,bhcsd->bhgcd", p.to(v_cache.dtype).float(), vc.float())
    o_part, lse_part = finalize(SoftmaxState(m=m, l=l, o=o_unscaled))
    o, lse = combine_lse_outputs(o_part.movedim(3, 0), lse_part.movedim(3, 0))
    return o.reshape(B, 1, Hq, D).to(q.dtype), lse.reshape(B, Hq, 1)


def flash_decode_paged(
    q: torch.Tensor,  # (B, 1, Hq, D)
    k_pages: torch.Tensor,  # (Hkv, P, page_size, D) physical page planes
    v_pages: torch.Tensor,
    cache_length: torch.Tensor,  # (B,) int logical lengths
    block_table: torch.Tensor,  # (B, n_pages) int logical -> physical page
    *,
    window: Optional[int] = None,
    sink: int = 0,
    scale: Optional[float] = None,
    num_splits: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Page-indirect decode: gather the block table's pages into a
    contiguous (B, n_pages * page_size, Hkv, D) view, then run
    :func:`flash_decode`. Positions at or past ``cache_length`` are masked,
    so stale or null-page contents never contribute."""
    return flash_decode(q, gather_pages(k_pages, block_table),
                        gather_pages(v_pages, block_table), cache_length, window=window,
                        sink=sink, scale=scale, num_splits=num_splits)


def gather_pages(pages: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """Page planes (Hkv, P, ps, D) read through ``block_table`` (B, n_pages)
    -> the contiguous cache (B, n_pages * ps, Hkv, D)."""
    B, n_pages = block_table.shape
    Hk, _, ps, D = pages.shape
    g = pages[:, block_table.to(pages.device).long()]  # (Hk, B, n_pages, ps, D)
    return g.permute(1, 2, 3, 0, 4).reshape(B, n_pages * ps, Hk, D)
