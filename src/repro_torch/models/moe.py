"""Mixture-of-Experts layer (granite 32 experts top-8, mixtral 8 top-2).

The counterpart of ``repro/models/moe.py``'s single-device path
(``apply_moe`` without a mesh, ``moe.py:149``): GShard-style capacity
dispatch with static shapes. Each token picks its ``top_k`` experts by the
router's f32 logits, its gates are the softmax over those ``top_k`` logits
only, and every expert takes at most ``capacity(m, T)`` assignments, where
``T`` counts every token of the call (padding and empty serving slots
included, so the tokens of one call compete for capacity). Assignments are
ordered by a stable sort on their expert; an expert's first ``cap`` of
that order are kept and the rest dropped (their token gets nothing from
that expert). The expert-parallel ``shard_map`` path of the JAX package
(``moe.py:157``) is not ported yet.

No step of the layer reads a value back to the host: no ``bincount``,
``nonzero``, ``.item()`` or boolean-mask indexing. The stable sort is
computed from a one-hot cumulative count (each assignment's sorted slot is
its expert's offset plus the number of same-expert assignments before
it), which gives ``jnp.argsort(stable=True)``'s order exactly. The JAX
``.at[dest].set(..., mode="drop")`` scatters write into a buffer one row
longer, whose last row (every dropped assignment's ``dest``) is sliced
off. The combine reads each token's ``top_k`` expert outputs back through
the sort's inverse and sums them in f32, so that it is deterministic on
the card, where a scatter-add would sum in the order of its atomics. The
dispatch gather's backward (:class:`_Dispatch`) does the same for the
gradient of the tokens: ``index_select``'s own backward would add each
token's ``top_k`` slot gradients with atomics in the activation dtype, in
no fixed order (bf16 rounding at every addition during training).

The expert products are batched matrix products over (E, cap, d), as the
JAX package leaves its einsums to XLA; the layer holds no kernel.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import new_param, normal_


class MoE(nn.Module):
    """The parameters of the JAX ``init_moe`` (``moe.py:38``): ``router`` (d,
    E) in float32 whatever the model's dtype, ``we_gate`` and ``we_up`` (E,
    d, d_expert) and ``we_down`` (E, d_expert, d) in ``dtype``; std 1/sqrt(d)
    for the router, gate and up, 1/sqrt(d_expert) for down."""

    def __init__(self, cfg, device, dtype):
        super().__init__()
        m = cfg.moe
        d, de, E = cfg.d_model, m.d_expert, m.num_experts
        self.m = m
        self.std_in, self.std_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(de)
        self.router = new_param((d, E), device, torch.float32)
        self.we_gate = new_param((E, d, de), device, dtype)
        self.we_up = new_param((E, d, de), device, dtype)
        self.we_down = new_param((E, de, d), device, dtype)

    def init_(self, gen):
        normal_(self.router, self.std_in, gen)
        normal_(self.we_gate, self.std_in, gen)
        normal_(self.we_up, self.std_in, gen)
        normal_(self.we_down, self.std_out, gen)

    def forward(self, x: torch.Tensor, with_aux: bool = True):
        """x (B, S, d) -> (y (B, S, d), aux): ``apply_moe`` without a mesh.
        ``aux`` is the load-balancing loss, or None when ``with_aux`` is
        false (serving: the JAX jit drops it there)."""
        B, S, d = x.shape
        xf = x.reshape(B * S, d)
        aux = None
        if with_aux:
            logits = route(self.router, xf)
            aux = aux_loss(self.m, logits, top_k(logits, self.m.top_k)[1])
        y = moe_body(xf, self.router, self.we_gate, self.we_up, self.we_down, self.m, 0,
                     capacity(self.m, B * S), self.m.top_k)
        return y.reshape(B, S, d), aux


def route(router: torch.Tensor, xf: torch.Tensor) -> torch.Tensor:
    """Router logits (T, E) in f32 (``_route``, ``moe.py:50``)."""
    return xf.float() @ router


def top_k(logits: torch.Tensor, k: int):
    """(the k largest logits of each token, their experts), descending
    (``jax.lax.top_k``): the layer's only discrete decision, in one place so
    that a check can record or replay it."""
    return torch.topk(logits, k, dim=-1)


def capacity(m, T: int) -> int:
    """Assignments an expert takes in a call of ``T`` tokens (``_capacity``,
    ``moe.py:55``): ceil(T k / E * capacity_factor), at least 4, rounded up
    to a multiple of 4."""
    cap = int(math.ceil(T * m.top_k / m.num_experts * m.capacity_factor))
    return max(4, -(-cap // 4) * 4)


def dispatch_indices(flat_e: torch.Tensor, e_lo: int, E_local: int, cap: int, k: int):
    """Sorted-dispatch bookkeeping for experts [e_lo, e_lo + E_local) over the
    flat assignments ``flat_e`` (T k,) (``_dispatch_indices``, ``moe.py:60``).

    Returns, over the assignments in stable order by expert (experts outside
    the range last): ``token_of`` (the token of each), ``dest`` (its slot in
    the (E_local cap) group buffer; E_local cap when dropped or foreign),
    ``keep``, ``order`` (the assignment at each sorted position), and
    ``rank`` (n,), the inverse of ``order``: the sorted position of each
    assignment. All int64 (``keep`` bool)."""
    n = flat_e.shape[0]
    dev = flat_e.device
    local_e = flat_e.long() - e_lo
    mine = (local_e >= 0) & (local_e < E_local)
    sort_key = torch.where(mine, local_e, torch.full_like(local_e, E_local))
    one_hot = (sort_key[:, None] == torch.arange(E_local + 1, device=dev)).long()  # (n, E+1)
    counts = one_hot.sum(0)
    offsets = counts.cumsum(0) - counts
    earlier = (one_hot.cumsum(0) - one_hot).gather(1, sort_key[:, None])[:, 0]
    rank = offsets.index_select(0, sort_key) + earlier
    slots = torch.arange(n, device=dev)
    order = torch.empty_like(rank).scatter_(0, rank, slots)
    sorted_e = sort_key.index_select(0, order)
    pos_in_e = slots - offsets.index_select(0, sorted_e)
    keep = (sorted_e < E_local) & (pos_in_e < cap)
    token_of = order // k
    dest = torch.where(keep, sorted_e * cap + pos_in_e, torch.full_like(pos_in_e, E_local * cap))
    return token_of, dest, keep, order, rank


def expert_ffn(x_groups, wg, wu, wd):
    """SwiGLU of every expert over its (cap, d) group (``_expert_ffn``,
    ``moe.py:81``): g and u in the activation dtype, silu in f32 and cast
    back, the down product in the activation dtype."""
    g = torch.bmm(x_groups, wg)
    u = torch.bmm(x_groups, wu)
    h = F.silu(g.float()).to(x_groups.dtype) * u
    return torch.bmm(h, wd)


class _Dispatch(torch.autograd.Function):
    """x_groups = xf[token_at] * slot_used: the dispatch gather. Its
    backward reads each token's ``k`` slot gradients back through
    ``assign_slot`` (each assignment's slot; the extra last row, zero, for
    a dropped one) and sums them in f32 in assignment order, as the combine
    sums the forward's expert outputs."""

    @staticmethod
    def forward(ctx, xf, token_at, slot_used, assign_slot):
        ctx.save_for_backward(assign_slot)
        ctx.tokens = xf.shape[0]
        return xf.index_select(0, token_at) * slot_used[:, None]

    @staticmethod
    def backward(ctx, g):
        (assign_slot,) = ctx.saved_tensors
        rows = torch.cat([g, g.new_zeros((1, g.shape[1]))])
        dx = rows.index_select(0, assign_slot).float().reshape(ctx.tokens, -1, g.shape[1])
        return dx.sum(dim=1).to(g.dtype), None, None, None


def moe_body(xf, router, wg, wu, wd, m, e_lo: int, cap: int, k: int) -> torch.Tensor:
    """xf (T, d) -> y (T, d) through experts [e_lo, e_lo + E_local), E_local
    = ``wg.shape[0]`` (``_moe_body``, ``moe.py:88``)."""
    T, d = xf.shape
    E_local = wg.shape[0]
    logits = route(router, xf)
    top_logit, top_e = top_k(logits, k)
    gates = torch.softmax(top_logit, dim=-1)
    token_of, dest, keep, _, rank = dispatch_indices(top_e.reshape(-1), e_lo, E_local, cap, k)
    # Dispatch: the slot -> token map, then a gather of the tokens.
    n_slots = E_local * cap
    token_at = torch.zeros(n_slots + 1, dtype=torch.long, device=xf.device)
    token_at = token_at.scatter_(0, dest, token_of)[:n_slots]
    slot_used = torch.zeros(n_slots + 1, dtype=xf.dtype, device=xf.device)
    slot_used = slot_used.scatter_(0, dest, keep.to(xf.dtype))[:n_slots]
    assign_slot = dest.index_select(0, rank)  # each assignment's slot, n_slots if dropped
    x_groups = _Dispatch.apply(xf, token_at, slot_used, assign_slot)
    y_groups = expert_ffn(x_groups.reshape(E_local, cap, d), wg, wu, wd)
    # Combine: each token's k outputs (a zero row where dropped), weighted
    # by its gates, summed in f32.
    y_rows = torch.cat([y_groups.reshape(n_slots, d), y_groups.new_zeros((1, d))])
    w = torch.where(keep.index_select(0, rank), gates.reshape(-1), 0.0)
    y = y_rows.index_select(0, assign_slot).float() * w[:, None]
    return y.reshape(T, k, d).sum(dim=1).to(xf.dtype)


def aux_loss(m, logits: torch.Tensor, top_e: torch.Tensor) -> torch.Tensor:
    """Switch load-balancing loss (``_aux_loss``, ``moe.py:120``): weight * E
    * sum over experts of (share of assignments) * (mean router
    probability)."""
    E = m.num_experts
    probs = torch.softmax(logits, dim=-1)
    chosen = (top_e[..., None] == torch.arange(E, device=top_e.device)).float()
    f = chosen.sum(dim=-2).mean(dim=0) / m.top_k
    p = probs.mean(dim=0)
    return m.router_aux_weight * E * (f * p).sum()
