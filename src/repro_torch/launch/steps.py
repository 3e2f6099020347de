"""Step builders: the train step, and the serving steps (bucketed prefill
and one decode tick, each ending in the greedy next token).

The counterpart of ``repro/launch/steps.py``. PyTorch runs eagerly, so a
"step" is a plain function of the model and its inputs (there is nothing to
jit):

  train_step(model, opt_state, batch)         -> (opt_state, metrics)
  prefill_step(model, batch)                  -> (next_token, caches, lens)
  serve_step(model, token, caches, cache_len) -> (next_token, caches)

The JAX train step returns new parameters; here the model's parameters are
updated in place (``training/optimizer.apply_updates``). Gradient
accumulation: ``microbatches > 1`` runs the batch in slices and sums their
gradients in f32 (the JAX scan's numerics; the loss is a token mean, so the
sum is divided by the count).
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.attention import AttentionConfig
from repro_torch.training.losses import chunked_cross_entropy
from repro_torch.training.optimizer import AdamWConfig, OptState, apply_updates

METRIC_KEYS = ("ce_loss", "aux_loss", "nll_sum", "tokens", "accuracy")


def loss_fn(cfg, attn_cfg: AttentionConfig, model, batch: Dict[str, torch.Tensor],
            ce_chunk: int = 512):
    """(loss, metrics) of one batch {"inputs", "targets"[, "loss_mask"]}
    (the counterpart of ``loss_fn``, JAX ``steps.py:35``)."""
    hidden, aux, nprefix = model(batch["inputs"], attn_cfg)
    if nprefix:
        hidden = hidden[:, nprefix:]
    loss, metrics = chunked_cross_entropy(
        model.embed, hidden, batch["targets"], vocab_valid=cfg.vocab_size,
        mask=batch.get("loss_mask"), chunk=ce_chunk,
    )
    return loss + aux, {"ce_loss": loss, "aux_loss": aux, **metrics}


def build_train_step(cfg, attn_cfg: AttentionConfig, opt_cfg: AdamWConfig, *,
                     microbatches: int = 1, ce_chunk: int = 512):
    def train_step(model, opt_state: OptState, batch: Dict[str, torch.Tensor]):
        params = dict(model.named_parameters())
        if microbatches > 1:
            B = batch["inputs"].shape[0]
            if B % microbatches:
                raise ValueError(f"batch {B} is not a multiple of {microbatches} microbatches")
            n = B // microbatches
            grads = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for k, p in params.items()}
            loss = torch.zeros((), dtype=torch.float32)
            metrics = {k: torch.zeros((), dtype=torch.float32) for k in METRIC_KEYS}
            for m in range(microbatches):
                micro = {k: v[m * n:(m + 1) * n] for k, v in batch.items()}
                l, mm = loss_fn(cfg, attn_cfg, model, micro, ce_chunk)
                l.backward()
                for k, p in params.items():
                    grads[k] += p.grad.float()
                model.zero_grad(set_to_none=True)
                loss += l.detach().float().cpu()
                for k in METRIC_KEYS:
                    metrics[k] += mm[k].detach().float().cpu()
            grads = {k: g / microbatches for k, g in grads.items()}
            loss = loss / microbatches
            metrics = {k: v / microbatches for k, v in metrics.items()}
        else:
            loss, metrics = loss_fn(cfg, attn_cfg, model, batch, ce_chunk)
            loss.backward()
            grads = {k: p.grad for k, p in params.items()}
        opt_state, om = apply_updates(opt_cfg, opt_state, params, grads)
        model.zero_grad(set_to_none=True)
        out = {"loss": float(loss.detach()),
               **{k: float(v.detach()) for k, v in metrics.items()}, **om}
        return opt_state, out

    return train_step


def greedy(cfg, logits: torch.Tensor) -> torch.Tensor:
    """argmax over the real vocabulary (padded ids never win) -> int32."""
    return logits[..., : cfg.vocab_size].argmax(dim=-1).to(torch.int32)


def build_prefill_step(cfg, attn_cfg: AttentionConfig, cache_size: int):
    @torch.no_grad()
    def prefill_step(model, batch):
        # batch['lens'] (B,) marks true token counts of bucket-padded prompts.
        h_last, caches, lens = model.prefill(
            batch["inputs"], attn_cfg, cache_size, lens=batch.get("lens")
        )
        return greedy(cfg, model.logits_from_hidden(h_last)), caches, lens

    return prefill_step


def build_serve_step(cfg, attn_cfg: AttentionConfig):
    @torch.no_grad()
    def serve_step(model, token, caches, cache_len):
        logits, caches = model.decode_step(token, caches, cache_len, attn_cfg)
        return greedy(cfg, logits), caches

    return serve_step
