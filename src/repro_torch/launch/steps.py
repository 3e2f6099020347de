"""Step builders: the train step, and the serving steps (bucketed prefill
and one decode tick, each ending in the greedy next token).

The counterpart of ``repro/launch/steps.py``. PyTorch runs eagerly, so a
"step" is a plain function of the model and its inputs (there is nothing to
jit):

  train_step(model, opt_state, batch)         -> (opt_state, metrics)
  prefill_step(model, batch)                  -> (next_token, caches, lens)
  serve_step(model, token, caches, cache_len) -> (next_token, caches)
  paged_serve_step(model, token, caches, block_table, cache_len)
                                              -> (next_token, caches)
  paged_admit_step(model, batch, caches, dest)
                                              -> (next_token, lens, caches)

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
    """(loss, metrics) of one batch {"inputs", "targets"[, "loss_mask",
    "segment_ids"]} (the counterpart of ``loss_fn``, JAX ``steps.py:35``);
    segment ids make it a packed (varlen) batch. An encoder-decoder config
    (whisper) also reads ``batch["frames"]`` (B, T, d_model) and unembeds
    through the decoder's token table (JAX ``_embed_params``, ``steps.py:31``)."""
    if cfg.family == "encdec":
        hidden, aux, nprefix = model(batch["frames"], batch["inputs"], attn_cfg)
        embed = model.decoder.embed
    else:
        hidden, aux, nprefix = model(batch["inputs"], attn_cfg,
                                     segment_ids=batch.get("segment_ids"))
        embed = model.embed
    if nprefix:
        hidden = hidden[:, nprefix:]
    loss, metrics = chunked_cross_entropy(
        embed, hidden, batch["targets"], vocab_valid=cfg.vocab_size,
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
    """Prefill and the first greedy token. An encoder-decoder config
    (whisper) reads ``batch["frames"]`` (B, T, d_model) beside the prompt
    ``batch["inputs"]`` (B, S); every row's prompt has S tokens."""
    @torch.no_grad()
    def prefill_step(model, batch):
        if cfg.family == "encdec":
            h_last, caches, tlen = model.prefill(batch["frames"], batch["inputs"], attn_cfg,
                                                 cache_size)
            lens = torch.full((h_last.shape[0],), tlen, dtype=torch.int32,
                              device=h_last.device)
        else:
            # batch['lens'] (B,) marks true token counts of bucket-padded prompts.
            h_last, caches, lens = model.prefill(
                batch["inputs"], attn_cfg, cache_size, lens=batch.get("lens")
            )
        return greedy(cfg, model.logits_from_hidden(h_last)), caches, lens

    return prefill_step


def build_serve_step(cfg, attn_cfg: AttentionConfig):
    """One decode tick and its greedy tokens. ``LM.decode_step`` and
    ``Whisper.decode_step`` share a signature, so the JAX encoder-decoder
    branch (``steps.py:135``) is the model's own method here."""
    @torch.no_grad()
    def serve_step(model, token, caches, cache_len):
        logits, caches = model.decode_step(token, caches, cache_len, attn_cfg)
        return greedy(cfg, logits), caches

    return serve_step


def build_paged_serve_step(cfg, attn_cfg: AttentionConfig):
    """Decode step over the paged cache (the counterpart of
    ``build_paged_serve_step``, JAX ``steps.py:149``): the caches are the
    pool's page planes, written in place."""
    @torch.no_grad()
    def paged_serve_step(model, token, caches, block_table, cache_len):
        logits, caches = model.decode_step(token, caches, cache_len, attn_cfg,
                                           block_table=block_table)
        return greedy(cfg, logits), caches

    return paged_serve_step


def build_paged_admit_step(cfg, attn_cfg: AttentionConfig, page_size: int):
    """Batched admission (the counterpart of ``build_paged_admit_step``, JAX
    ``steps.py:167``): one lens-masked prefill of a same-bucket group, its
    contiguous caches scattered into the pool's page planes at the ``dest``
    physical pages, in place.

    ``batch["inputs"]`` (W, pad_to) right-padded prompts, ``batch["lens"]``
    (W,) true lengths, ``dest`` (W, ceil(pad_to / page_size)) int32 physical
    page per logical prefill page. Width-padding rows and pages past a
    prompt point at the null page 0: those writes land there in no fixed
    order, and nothing reads the null page."""
    @torch.no_grad()
    def paged_admit_step(model, batch, caches, dest):
        tokens = batch["inputs"]
        cache_size = -(-tokens.shape[1] // page_size) * page_size
        h_last, prefill_caches, lens = model.prefill(tokens, attn_cfg, cache_size,
                                                     lens=batch.get("lens"))
        next_token = greedy(cfg, model.logits_from_hidden(h_last))
        for layer, new in zip(caches, prefill_caches):
            for name, planes in layer["kv"].items():
                contig = new["kv"][name]  # (W, S, Hk, hd)
                W, S, Hk, hd = contig.shape
                pages = contig.reshape(W, S // page_size, page_size, Hk, hd)
                planes[:, dest] = pages.permute(3, 0, 1, 2, 4).to(planes.dtype)
        return next_token, lens, caches

    return paged_admit_step
