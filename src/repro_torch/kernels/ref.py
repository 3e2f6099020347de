"""Dense reference attention: the oracle and the ``impl="ref"`` path.

The counterpart of ``repro/kernels/ref.py``: ``attention_reference`` (plain
torch ops, so autograd differentiates it for ``impl="ref"``) and
``attention_reference_bwd``, the paper's Section 2.2 backward written out.
Both materialize the N x N score matrix on purpose.

Layout convention (whole repo): q (B, Sq, Hq, D); k, v (B, Skv, Hkv, D)
with Hq % Hkv == 0 (GQA). Output (B, Sq, Hq, D); lse (B, Hq, Sq) f32.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.core.masks import MaskSpec, make_segment_mask, make_tile_mask


def _mask(spec, Sq, Sk, device, segment_ids, kv_segment_ids):
    """The (Sq, Sk) spec mask ANDed with the (B, 1, 1, Sq, Sk) segment mask
    (broadcast over the kv heads and the group), or None."""
    mask = make_tile_mask(spec, torch.arange(Sq, device=device) + spec.q_offset,
                          torch.arange(Sk, device=device))
    if segment_ids is None:
        return mask
    if kv_segment_ids is None:
        kv_segment_ids = segment_ids
    seg = make_segment_mask(segment_ids.to(device), kv_segment_ids.to(device))[:, None, None]
    return seg if mask is None else mask & seg


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    spec: MaskSpec = MaskSpec(),
    scale: Optional[float] = None,
    segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Naive exact attention in f32. Returns (o, lse).

    ``segment_ids`` / ``kv_segment_ids`` (B, Sq) / (B, Skv): packed varlen
    ids (kv defaults to q); visibility also needs equal ids."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hk, _ = k.shape
    if Hq % Hk:
        raise ValueError(f"q heads {Hq} not a multiple of kv heads {Hk}")
    G = Hq // Hk
    if scale is None:
        scale = 1.0 / math.sqrt(D)

    qf = (q.float() * scale).reshape(B, Sq, Hk, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())  # (B, Hk, G, Sq, Sk)

    mask = _mask(spec, Sq, Sk, q.device, segment_ids, kv_segment_ids)
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))

    m = s.amax(dim=-1)
    m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(torch.isneginf(s), torch.zeros_like(p), p)
    l = p.sum(dim=-1)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p / l_safe[..., None], v.float())
    lse = torch.where(l == 0.0, torch.full_like(l, float("-inf")), m_safe + torch.log(l_safe))
    return o.reshape(B, Sq, Hq, D).to(q.dtype), lse.reshape(B, Hq, Sq)


def attention_reference_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    spec: MaskSpec = MaskSpec(),
    scale: Optional[float] = None,
    segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense backward in f32, recomputing P from (q, k, lse) as Algorithm 2
    does (the counterpart of ``attention_reference_bwd``, ``ref.py:83``).
    Returns (dq, dk, dv) in the inputs' dtypes; dq is with respect to the
    unscaled q."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hk, _ = k.shape
    G = Hq // Hk
    if scale is None:
        scale = 1.0 / math.sqrt(D)

    qf = q.float().reshape(B, Sq, Hk, G, D)
    kf, vf = k.float(), v.float()
    dof = do.float().reshape(B, Sq, Hk, G, D)
    of = o.float().reshape(B, Sq, Hk, G, D)
    lsef = lse.float().reshape(B, Hk, G, Sq)

    s = torch.einsum("bqhgd,bkhd->bhgqk", qf * scale, kf)
    mask = _mask(spec, Sq, Sk, q.device, segment_ids, kv_segment_ids)
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    # P = exp(S - L): Algorithm 2 line 11, from the logsumexp only.
    lse_safe = torch.where(torch.isneginf(lsef), torch.zeros_like(lsef), lsef)
    p = torch.exp(s - lse_safe[..., None])
    p = torch.where(torch.isneginf(s), torch.zeros_like(p), p)

    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, vf)
    delta = (dof * of).sum(dim=-1)  # D = rowsum(dO o O), line 4: (B, Sq, Hk, G)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf) * scale
    return dq.reshape(B, Sq, Hq, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
