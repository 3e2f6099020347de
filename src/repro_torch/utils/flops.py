"""Analytic model-FLOPs formulas (the paper's Section 4 accounting) and the
flash kernels' HBM traffic.

The counterpart of ``repro/utils/flops.py`` on the port's configs. Training
model FLOPs are 6 * N * tokens (dense) or 6 * N_active * tokens (MoE), plus
12 * L * d_attn * S^2-style attention FLOPs (the paper's Megatron formula,
causal halving NOT applied, "for consistency with the literature").
"""

from __future__ import annotations

from typing import Tuple, Union

from torch import nn

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.masks import MaskSpec, tile_visibility
from repro_torch.kernels import ops


def param_count(cfg: ModelConfig) -> Tuple[int, int]:
    """(total_params, active_params_per_token), analytic, from the config."""
    d, V = cfg.d_model, cfg.padded_vocab
    total = active = V * d  # embed
    if not cfg.tie_embeddings:
        total += V * d
        active += V * d
    for kind in cfg.layer_kinds():
        layer_t = layer_a = 0
        if kind.startswith("attn") or kind.startswith("hybrid"):
            attn = d * cfg.q_dim * 2 + d * cfg.kv_dim * 2
            layer_t += attn
            layer_a += attn
        if kind in ("mamba", "hybrid", "hybrid_global") and cfg.ssm:
            s = cfg.ssm
            din = s.expand * d
            dtr = s.dt_rank or (d + 15) // 16
            ssm = (d * 2 * din + s.d_conv * din + din * (dtr + 2 * s.d_state)
                   + dtr * din + din * s.d_state + din * d)
            layer_t += ssm
            layer_a += ssm
        if kind != "mamba":
            if cfg.moe:
                m = cfg.moe
                ffn1 = 3 * d * m.d_expert
                layer_t += m.num_experts * ffn1 + d * m.num_experts
                layer_a += m.top_k * ffn1
            elif cfg.d_ff:
                ffn = (3 if cfg.mlp == "swiglu" else 2) * d * cfg.d_ff
                layer_t += ffn
                layer_a += ffn
        total += layer_t
        active += layer_a
    if cfg.encoder:  # whisper encoder, and the decoder's cross-attention
        enc = cfg.encoder.num_layers * (4 * d * d + 2 * d * cfg.d_ff)
        cross = cfg.num_layers * 4 * d * d
        total += enc + cross
        active += enc + cross
    return total, active


def _attention_layers(cfg: ModelConfig):
    return [k for k in cfg.layer_kinds() if k.startswith("attn") or k.startswith("hybrid")]


def train_model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6 * N_active * tokens + the attention term, per training step (paper
    Section 4.2): 12 * q_dim * S_eff * S per attention layer and sequence
    (forward 4, backward 8), S_eff the window where one applies."""
    tokens = shape.global_batch * shape.seq_len
    _, active = param_count(cfg)
    flops = 6.0 * active * tokens
    s_full = shape.seq_len
    for kind in _attention_layers(cfg):
        w = cfg.kind_window(kind)
        s_eff = min(w, s_full) if w else s_full
        flops += 12.0 * cfg.q_dim * s_eff * s_full * shape.global_batch
    if cfg.encoder:
        flops += cfg.encoder.num_layers * 12.0 * cfg.q_dim * s_full * s_full * shape.global_batch
    return flops


def prefill_model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    return train_model_flops(cfg, shape) / 3.0  # forward only (1 of forward + 2x backward)


def decode_model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """One serve step: 2 * N_active matmul FLOPs + attention over the cache."""
    B = shape.global_batch
    _, active = param_count(cfg)
    flops = 2.0 * active * B
    for kind in _attention_layers(cfg):
        w = cfg.kind_window(kind)
        s_eff = min(w, shape.seq_len) if w else shape.seq_len
        flops += 4.0 * cfg.q_dim * s_eff * B
    return flops


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    if shape.kind == "train":
        return train_model_flops(cfg, shape)
    if shape.kind == "prefill":
        return prefill_model_flops(cfg, shape)
    return decode_model_flops(cfg, shape)


def count_params(params: Union[nn.Module, dict]) -> int:
    """Elements of an ``nn.Module``'s parameters or of a dict of tensors."""
    tensors = params.parameters() if isinstance(params, nn.Module) else params.values()
    return sum(t.numel() for t in tensors)


# ---------------------------------------------------------------------------
# Analytic flash-kernel HBM traffic
# ---------------------------------------------------------------------------
#
# A flash kernel keeps its Q tile, accumulator and (m, l) on chip across the
# KV loop, so per (arch x shape) its HBM traffic is the boundary tensors:
#
#   fwd:  read Q once, write O + LSE once, stream K/V once per visible q-row
#         block (f * t_q * (K + V))
#   bwd:  dK/dV pass -- read K/V and write dK/dV once, stream Q/dO/stats per
#         kv block; dQ pass -- read Q/dO and write dQ once, stream K/V per
#         q block (the paper's five-product recompute form).
#
# The JAX package counts this per chip of a sharded TPU mesh; the port runs
# on one device, so the whole batch and every head are counted, at the CUDA
# kernels' tiles. Each q head's tiles stream their own kv head's K/V, so the
# stream scales with the q heads; K/V, dK/dV are read or written once per
# kv head.


def _visible_fraction(spec_kind: str, window, sink, t_q: int, t_kv: int, bq: int, bk: int,
                      q_offset: int = 0) -> float:
    """Share of the t_q x t_kv tiles that are not empty under a 'full',
    'causal' or 'window' (causal) mask."""
    spec = MaskSpec(causal=spec_kind in ("causal", "window"),
                    window=window if spec_kind == "window" else None, sink=sink)
    if spec.is_trivial:
        return 1.0
    vis = 0
    for i in range(t_q):
        q_lo = i * bq + q_offset
        for j in range(t_kv):
            if tile_visibility(spec, q_lo, q_lo + bq, j * bk, j * bk + bk) != "empty":
                vis += 1
    return vis / max(t_q * t_kv, 1)


def flash_kernel_bytes(cfg: ModelConfig, shape: ShapeConfig, *, block_q: int = ops.BLOCK_Q,
                       block_kv: int = ops.BLOCK_KV) -> float:
    """HBM bytes of all flash-attention kernel calls in one step of this cell
    on one device: train, the forward and the backward, and the forward once
    more in every layer that ``cfg.remat`` recomputes (the LM's scan groups,
    not its tail layers; every whisper layer); prefill, the forward; decode,
    0 (the decode kernels are not counted)."""
    if shape.kind == "decode":
        return 0.0
    B, S, D = shape.global_batch, shape.seq_len, cfg.head_dim
    Hq, Hkv = cfg.num_heads, cfg.num_kv_heads
    dt = 2  # bf16
    fractions = {}

    def attn_bytes(s_q, s_kv, kind_spec, window, sink, train: bool, remat: bool):
        bq, bk = min(block_q, s_q), min(block_kv, s_kv)
        t_q, t_kv = -(-s_q // bq), -(-s_kv // bk)
        key = (kind_spec, window, sink, t_q, t_kv, bq, bk)
        if key not in fractions:
            fractions[key] = _visible_fraction(kind_spec, window, sink, t_q, t_kv, bq, bk)
        f = fractions[key]
        q_b = B * s_q * Hq * D * dt
        o_b = q_b
        lse_b = B * Hq * s_q * 4
        k_b = B * s_kv * Hkv * D * dt  # once per kv head
        k_stream = B * s_kv * Hq * D * dt  # once per q head
        fwd = q_b + o_b + lse_b + f * t_q * 2 * k_stream
        if not train:
            return fwd
        bwd = (2 * k_b + 2 * k_b  # read K, V; write dK, dV
               + f * t_kv * (2 * q_b + 2 * lse_b)  # stream Q, dO and (lse, delta)
               + 2 * q_b + q_b  # read Q, dO; write dQ
               + f * t_q * 2 * k_stream)  # stream K, V
        return (2 if remat else 1) * fwd + bwd

    train = shape.kind == "train"
    remat = train and cfg.remat
    grouped = cfg.num_groups * cfg.group_size
    total = 0.0
    for i, kind in enumerate(cfg.layer_kinds()):
        if kind == "mamba":
            continue
        window = cfg.kind_window(kind)
        sink = cfg.meta_tokens if (window is not None and cfg.meta_tokens) else 0
        spec_kind = "window" if window is not None else "causal"
        layer_remat = remat and (cfg.encoder is not None or i < grouped)
        total += attn_bytes(S, S, spec_kind, window, sink, train, layer_remat)
    if cfg.encoder:  # whisper: encoder self-attention (full) + decoder cross-attention
        frames = S
        total += cfg.encoder.num_layers * attn_bytes(frames, frames, "full", None, 0, train,
                                                     remat)
        total += cfg.num_layers * attn_bytes(S, frames, "full", None, 0, train, remat)
    return total
