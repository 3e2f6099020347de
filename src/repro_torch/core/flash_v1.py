"""FlashAttention-1-style forward loop: the paper's baseline for C1.

The counterpart of ``repro/core/flash_v1.py``, an eager PyTorch loop over
KV blocks (not a CUDA kernel). Deliberate differences from ``core/flash.py``
(per FA1, Dao et al. 2022):

  * the output accumulator is **renormalised on every KV block** (the
    running ``diag(l)^-1`` re-applied each step) instead of FA2's single
    end-of-loop rescale;
  * both the row max ``m`` and the row sum ``l`` are returned (FA2 keeps only
    ``L = m + log l``).

Both are exact; the difference is non-matmul work, which is the paper's
point (Section 3.1).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.core.flash import DEFAULT_BLOCK
from repro_torch.core.masks import DEFAULT_MASK_VALUE, MaskSpec, make_tile_mask


def flash_v1_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    spec: MaskSpec = MaskSpec(causal=True),
    *,
    scale: Optional[float] = None,
    block_kv: int = DEFAULT_BLOCK,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q (B, Sq, Hq, D); k/v (B, Sk, Hkv, D), GQA. Returns (o (B, Sq, Hq, D)
    in q's dtype, m (B, Hq, Sq), l (B, Hq, Sq)): FA1 keeps both softmax
    statistics. Sk must be a whole number of ``block_kv`` blocks."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hk, _ = k.shape
    G = Hq // Hk
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    bk = min(block_kv, Sk)
    if Sk % bk:
        raise ValueError(f"flash_v1 baseline: Sk ({Sk}) must be a multiple of block_kv ({bk})")
    dev = q.device
    qt = q.reshape(B, Sq, Hk, G, D).permute(0, 2, 3, 1, 4).reshape(B * Hk, G, Sq, D).float()
    kt = k.transpose(1, 2).reshape(B * Hk, Sk, D)
    vt = v.transpose(1, 2).reshape(B * Hk, Sk, D)
    q_ids = torch.arange(Sq, dtype=torch.int32, device=dev) + spec.q_offset

    m = torch.full((B * Hk, G, Sq), float("-inf"), device=dev)
    l = torch.zeros((B * Hk, G, Sq), device=dev)
    o = torch.zeros((B * Hk, G, Sq, D), device=dev)  # normalised at every step: FA1
    for j in range(Sk // bk):
        k_j, v_j = kt[:, j * bk:(j + 1) * bk].float(), vt[:, j * bk:(j + 1) * bk]
        s = torch.einsum("ngqd,nkd->ngqk", qt, k_j) * scale
        mask = make_tile_mask(spec, q_ids, j * bk + torch.arange(bk, dtype=torch.int32,
                                                                 device=dev))
        if mask is not None:
            s = torch.where(mask, s, torch.full_like(s, DEFAULT_MASK_VALUE))
        m_tile = s.amax(dim=-1)
        p = torch.exp(s - m_tile[..., None])
        l_tile = p.sum(dim=-1)
        m_new = torch.maximum(m, m_tile)
        alpha = torch.where(torch.isneginf(m), torch.zeros_like(m), torch.exp(m - m_new))
        beta = torch.exp(m_tile - m_new)
        l_new = alpha * l + beta * l_tile
        pv = torch.einsum("ngqk,nkd->ngqd", p.to(v.dtype).float(), v_j.float())
        # FA1: renormalise the running output every block,
        #   o <- diag(l_new)^-1 (diag(l) alpha o + beta P V)
        l_safe = torch.where(l_new == 0.0, torch.ones_like(l_new), l_new)
        o = (l[..., None] * alpha[..., None] * o + beta[..., None] * pv) / l_safe[..., None]
        m, l = m_new, l_new
    o = o.reshape(B, Hk, G, Sq, D).permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D)
    return o.to(q.dtype), m.reshape(B, Hq, Sq), l.reshape(B, Hq, Sq)
