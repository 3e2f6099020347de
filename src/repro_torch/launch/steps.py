"""Serving steps: bucketed prefill and one decode tick, each ending in the
greedy next token.

The counterpart of ``build_prefill_step`` / ``build_serve_step`` in
``repro/launch/steps.py``. PyTorch runs eagerly, so a "step" is a plain
function of the model and its inputs (there is nothing to jit).
"""

from __future__ import annotations

import torch

from repro_torch.core.attention import AttentionConfig


def greedy(cfg, logits: torch.Tensor) -> torch.Tensor:
    """argmax over the real vocabulary (padded ids never win) -> int32."""
    return logits[..., : cfg.vocab_size].argmax(dim=-1).to(torch.int32)


def build_prefill_step(cfg, attn_cfg: AttentionConfig, cache_size: int):
    def prefill_step(model, batch):
        # batch['lens'] (B,) marks true token counts of bucket-padded prompts.
        h_last, caches, lens = model.prefill(
            batch["inputs"], attn_cfg, cache_size, lens=batch.get("lens")
        )
        return greedy(cfg, model.logits_from_hidden(h_last)), caches, lens

    return prefill_step


def build_serve_step(cfg, attn_cfg: AttentionConfig):
    def serve_step(model, token, caches, cache_len):
        logits, caches = model.decode_step(token, caches, cache_len, attn_cfg)
        return greedy(cfg, logits), caches

    return serve_step
