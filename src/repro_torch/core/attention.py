"""Unified attention entry point of the port.

Every model calls :func:`attention` / :func:`decode_attention`; the backend
is chosen by config, never by model code:

  impl = 'ref'          dense O(N^2)-memory attention (the oracle),
                        differentiated by autograd
  impl = 'flash_torch'  the FA2 algorithm as a blocked PyTorch loop over
                        tiles with its own backward (core/flash.py) and the
                        split decode (core/decode.py); plain PyTorch on any
                        device, never a CUDA kernel
  impl = 'flash_cuda'   the hand-written Hopper kernels (kernels/ops.py),
                        forward and backward; on CPU tensors their plain
                        PyTorch versions

The counterpart of ``repro/core/attention.py`` (``flash_torch`` stands where
``flash_xla`` stands there, ``flash_cuda`` where ``flash_pallas`` does).
No impl falls back to another. There is no ring routing yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import decode as _decode
from repro_torch.core import flash as _flash
from repro_torch.core.masks import MaskSpec
from repro_torch.kernels import flash_bwd, flash_decode, flash_fwd, ops
from repro_torch.kernels.ref import attention_reference

IMPLS = ("ref", "flash_torch", "flash_cuda")


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    impl: str = "flash_cuda"
    # flash_cuda backward: 'fused' (one pass, dq by bulk reductions) | 'split' (the
    # deterministic dK/dV + dQ kernels). None -> 'fused': the port has no
    # tuned cache to consult.
    bwd: Optional[str] = None
    # Forward kv splits (flash_cuda; paper Section 3.2): None -> the auto
    # policy (kernels/ops.default_kv_splits, at every head dim); an int
    # overrides (1 disables). Splits run the split-KV kernel, exact up to
    # the fold's rounding. The JAX config's q bands have no counterpart:
    # every q tile is its own CTA.
    kv_splits: Optional[int] = None
    # flash_cuda tile schedule: 'compact' (the CSR of visible tiles) |
    # 'dense' (every tile visited, empty ones skipped in the kernel; no kv
    # splits). None -> 'compact': the port has no tuned cache to consult.
    schedule: Optional[str] = None
    # flash_torch tile sizes (None -> core/flash.DEFAULT_BLOCK); its tile
    # mode is the 'auto' rule (core/flash.FlashConfig.resolve_mode).
    # flash_cuda takes the kernels' fixed 64 x 64 tiles (ops.BLOCK_Q,
    # ops.BLOCK_KV; ROADMAP.md queue 1, item 7): there these raise rather
    # than be ignored.
    block_q: Optional[int] = None
    block_kv: Optional[int] = None

    def __post_init__(self):
        if self.impl not in IMPLS:
            raise ValueError(f"unknown attention impl {self.impl!r}; have {IMPLS}")
        if self.bwd is not None and self.bwd not in ops.BWD_MODES:
            raise ValueError(f"unknown backward mode {self.bwd!r}; have {ops.BWD_MODES}")
        ops.check_kv_splits(self.kv_splits)
        if self.schedule is not None:
            ops.check_schedule(self.schedule)
        if self.impl != "flash_torch":
            if self.block_q is not None or self.block_kv is not None:
                raise ValueError(
                    f"impl={self.impl!r} takes no block_q / block_kv: the CUDA kernels' tiles "
                    "are fixed at 64 x 64 until the tuned block sizes are ported (ROADMAP.md "
                    "queue 1, item 7); the blocked path takes them (impl='flash_torch')")
        elif self.bwd is not None or self.kv_splits is not None or self.schedule is not None:
            raise ValueError("bwd, kv_splits and schedule are the CUDA kernels' knobs "
                             "(impl='flash_cuda'); impl='flash_torch' takes block_q and "
                             "block_kv")


def check_card_support(cfg, attn_cfg: AttentionConfig, device, *, training: bool,
                       paged: bool = False, packed: bool = False) -> None:
    """Refuse up front, before any tensor reaches the device, a model that
    the CUDA kernels cannot run: ``attn_cfg.impl == "flash_cuda"`` on a CUDA
    ``device`` (a name or a ``torch.device``) with ``cfg.dtype`` other than
    bfloat16, or a ``cfg.head_dim`` that the forward kernels, and for
    ``training`` the backward kernels, else the decode kernels (``paged``:
    the paged decode's) are not instantiated for: gemma3-1b's 256 and
    stablelm-12b's 160 serve (fixed and paged) and train (fused and split
    backward), and so does granite-moe-1b-a400m's 64 (an MoE model trains
    under the same rules as a dense one). ``packed`` adds no condition: the
    forward and backward kernels are built with segments at each of their
    head dims. The plain CPU path, ``impl="ref"`` and ``impl="flash_torch"``
    (plain PyTorch on any device) take any of them."""
    if attn_cfg.impl != "flash_cuda" or torch.device(device).type != "cuda":
        return
    if cfg.dtype != "bfloat16":
        raise ValueError(
            f"{cfg.name} is {cfg.dtype}, and the CUDA kernels take bfloat16 only (as the "
            "paper's kernels take fp16/bf16): run it in bfloat16 (the train CLI's --dtype "
            "bfloat16) or through the dense reference (--attn ref)")
    kernels = {"forward": flash_fwd.KERNEL_HEAD_DIMS}
    if training:
        kernels["backward"] = flash_bwd.KERNEL_HEAD_DIMS
    else:
        kernels["decode"] = (flash_decode.PAGED_HEAD_DIMS if paged
                             else flash_decode.KERNEL_HEAD_DIMS)
    for what, dims in kernels.items():
        if cfg.head_dim not in dims:
            raise ValueError(
                f"{cfg.name} has head_dim {cfg.head_dim}; the CUDA {what} kernels take head_dim "
                f"{dims} (ROADMAP.md queue 2, item 2). Use --attn ref, or --device cpu for the "
                "plain path")


def attention(q, k, v, spec: MaskSpec, cfg: AttentionConfig = AttentionConfig(), *,
              scale: Optional[float] = None,
              segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention output. q (B,Sq,Hq,D); k/v (B,Skv,Hkv,D) GQA.

    ``segment_ids`` (B, S) int turns on packed (varlen) semantics on both
    backends: self-attention over one packed layout, q and kv share the ids
    (JAX ``attention.py:64``)."""
    if cfg.impl == "ref":
        return attention_reference(q, k, v, spec, scale=scale, segment_ids=segment_ids)[0]
    if cfg.impl == "flash_torch":
        return _flash.flash_attention(
            q, k, v, spec, scale=scale, block_q=cfg.block_q, block_kv=cfg.block_kv,
            segment_ids=segment_ids)
    knobs = dict(scale=scale, bwd=cfg.bwd or "fused", kv_splits=cfg.kv_splits,
                 schedule=cfg.schedule or "compact")
    if segment_ids is not None:
        return ops.flash_attention_varlen(q, k, v, segment_ids, spec, **knobs)
    return ops.flash_attention(q, k, v, spec, **knobs)


def decode_attention(q, k_cache, v_cache, cache_length,
                     cfg: AttentionConfig = AttentionConfig(), *,
                     window: Optional[int] = None, sink: int = 0,
                     scale: Optional[float] = None,
                     kv_segment_ids: Optional[torch.Tensor] = None,
                     q_segment: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-token decode against a padded cache. q (B,1,Hq,D); caches
    (B,S,Hkv,D); cache_length (B,) valid entries. Returns (B,1,Hq,D).

    The query sits at position ``cache_length - 1`` and attends to
    [max(0, L - window), L) plus the first ``sink`` positions.
    ``kv_segment_ids`` (B, S) and ``q_segment`` (B,) restrict it to its
    own segment of a packed cache (JAX ``attention.py:131``)."""
    if cfg.impl == "ref":
        return _decode_reference(q, k_cache, v_cache, cache_length, window=window, sink=sink,
                                 scale=scale, kv_segment_ids=kv_segment_ids,
                                 q_segment=q_segment)
    if cfg.impl == "flash_torch":
        return _decode.flash_decode(q, k_cache, v_cache, cache_length, window=window, sink=sink,
                                    scale=scale, num_splits=ops.DEFAULT_DECODE_SPLITS,
                                    kv_segment_ids=kv_segment_ids, q_segment=q_segment)[0]
    return ops.flash_decode(q, k_cache, v_cache, cache_length, window=window,
                            sink=sink, scale=scale, kv_segment_ids=kv_segment_ids,
                            q_segment=q_segment)[0]


def decode_attention_paged(q, k_pages, v_pages, cache_length, block_table,
                           cfg: AttentionConfig = AttentionConfig(), *,
                           window: Optional[int] = None, sink: int = 0,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Single-token decode against a *paged* cache: the pool's page planes
    k/v_pages (Hkv,P,ps,D) read through block_table (B, n_pages) int32
    (``serving/kv_pool.py``); cache_length (B,) logical lengths. Returns
    (B,1,Hq,D). A row of length 0 (an inactive slot, all-null table) reads
    no K/V on the kernel path and gives 0.

    ``ref`` gathers the table's pages into a contiguous (B, n_pages*ps, Hkv,
    D) view and runs the dense oracle; ``flash_torch`` gathers the same way
    for its split decode (``core/decode.py``, JAX ``decode.py:103``). The
    split fan-out is ``ops.DEFAULT_DECODE_SPLITS``: the TPU-tuned cache is
    not consulted."""
    if cfg.impl == "ref":
        return _decode_reference(q, _decode.gather_pages(k_pages, block_table),
                                 _decode.gather_pages(v_pages, block_table), cache_length,
                                 window=window, sink=sink, scale=scale)
    if cfg.impl == "flash_torch":
        return _decode.flash_decode_paged(q, k_pages, v_pages, cache_length, block_table,
                                          window=window, sink=sink, scale=scale,
                                          num_splits=ops.DEFAULT_DECODE_SPLITS)[0]
    return ops.flash_decode_paged(q, k_pages, v_pages, cache_length, block_table,
                                  window=window, sink=sink, scale=scale,
                                  num_splits=ops.DEFAULT_DECODE_SPLITS)[0]


def _decode_reference(q, k_cache, v_cache, cache_length, *, window, sink, scale,
                      kv_segment_ids=None, q_segment=None):
    """Row by row through the dense oracle, the query at position L - 1
    (with segments, seeing only the cache positions of its own segment)."""
    out = torch.zeros_like(q)
    for b, L in enumerate(cache_length.tolist()):
        if L <= 0:
            continue
        spec = MaskSpec(causal=True, window=window, sink=sink, q_offset=L - 1)
        seg = {}
        if kv_segment_ids is not None:
            seg = dict(segment_ids=q_segment[b:b + 1, None],
                       kv_segment_ids=kv_segment_ids[b:b + 1, :L])
        out[b:b + 1] = attention_reference(
            q[b:b + 1], k_cache[b:b + 1, :L], v_cache[b:b + 1, :L], spec, scale=scale, **seg
        )[0]
    return out
