"""Unified attention entry point of the port.

Every model calls :func:`attention` / :func:`decode_attention`; the backend
is chosen by config, never by model code:

  impl = 'ref'         dense O(N^2)-memory attention (the oracle),
                       differentiated by autograd
  impl = 'flash_cuda'  the hand-written Hopper kernels (kernels/ops.py),
                       forward and backward; on CPU tensors their plain
                       PyTorch versions

The counterpart of ``repro/core/attention.py`` (``flash_cuda`` stands where
``flash_pallas`` stands there). There is no ring routing yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.masks import MaskSpec
from repro_torch.kernels import flash_bwd, flash_decode, flash_fwd, ops
from repro_torch.kernels.ref import attention_reference

IMPLS = ("ref", "flash_cuda")


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    impl: str = "flash_cuda"
    # flash_cuda backward: 'fused' (one pass, dq by bulk reductions) | 'split' (the
    # deterministic dK/dV + dQ kernels). None -> 'fused': the port has no
    # tuned cache to consult.
    bwd: Optional[str] = None
    # Forward kv splits (flash_cuda; paper Section 3.2): None -> the auto
    # policy (kernels/ops.default_kv_splits; 1 at head dims 160 and 256,
    # which have no split-KV kernel: ops.resolve_kv_splits); an int
    # overrides (1 disables). Splits run the split-KV kernel, exact up to
    # the fold's rounding. The JAX config's q bands have no counterpart:
    # every q tile is its own CTA.
    kv_splits: Optional[int] = None
    # flash_cuda tile schedule: 'compact' (the CSR of visible tiles) |
    # 'dense' (every tile visited, empty ones skipped in the kernel; no kv
    # splits). None -> 'compact': the port has no tuned cache to consult.
    schedule: Optional[str] = None

    def __post_init__(self):
        if self.impl not in IMPLS:
            raise ValueError(f"unknown attention impl {self.impl!r}; have {IMPLS}")
        if self.bwd is not None and self.bwd not in ops.BWD_MODES:
            raise ValueError(f"unknown backward mode {self.bwd!r}; have {ops.BWD_MODES}")
        ops.check_kv_splits(self.kv_splits)
        if self.schedule is not None:
            ops.check_schedule(self.schedule)


def check_card_support(cfg, attn_cfg: AttentionConfig, device, *, training: bool,
                       paged: bool = False, packed: bool = False) -> None:
    """Refuse up front, before any tensor reaches the device, a model that
    the CUDA kernels cannot run: ``attn_cfg.impl == "flash_cuda"`` on a CUDA
    ``device`` (a name or a ``torch.device``) with ``cfg.dtype`` other than
    bfloat16, or a ``cfg.head_dim`` that the forward kernels, and for
    ``training`` the backward kernels (``packed``: their segment variants),
    else the decode kernels (``paged``: the paged decode's) are not
    instantiated for: gemma3-1b's 256 and stablelm-12b's 160 serve (fixed
    and paged) and train (fused and split backward) but not packed, since
    the segment kernels are built at 64 and 128 only (ROADMAP.md queue 2,
    item 2); whisper's 64 has no paged decode (item 3). The plain CPU path
    and ``impl="ref"`` take any of them."""
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
        if packed:  # the segment variants of the forward and backward kernels
            kernels["segment (packed)"] = flash_bwd.ALL_MODES_HEAD_DIMS
    else:
        kernels["decode"] = (flash_decode.PAGED_HEAD_DIMS if paged
                             else flash_decode.KERNEL_HEAD_DIMS)
    for what, dims in kernels.items():
        if cfg.head_dim not in dims:
            item = 3 if what == "decode" and paged and cfg.head_dim == 64 else 2
            raise ValueError(
                f"{cfg.name} has head_dim {cfg.head_dim}; the CUDA {what} kernels take head_dim "
                f"{dims} (ROADMAP.md queue 2, item {item}). Use --attn ref, or --device cpu for "
                "the plain path")


def attention(q, k, v, spec: MaskSpec, cfg: AttentionConfig = AttentionConfig(), *,
              scale: Optional[float] = None,
              segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention output. q (B,Sq,Hq,D); k/v (B,Skv,Hkv,D) GQA.

    ``segment_ids`` (B, S) int turns on packed (varlen) semantics on both
    backends: self-attention over one packed layout, q and kv share the ids
    (JAX ``attention.py:64``)."""
    if cfg.impl == "ref":
        return attention_reference(q, k, v, spec, scale=scale, segment_ids=segment_ids)[0]
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
    D) view and runs the dense oracle, as ``repro/core/decode.py:103
    flash_decode_paged`` gathers for its split decode. The split fan-out is
    ``ops.DEFAULT_DECODE_SPLITS``: the TPU-tuned cache is not consulted."""
    if cfg.impl == "ref":
        B, n_pages = block_table.shape
        Hk, _, ps, D = k_pages.shape
        tbl = block_table.to(k_pages.device).long()

        def gather(pages):  # (Hk, B, n_pages, ps, D) -> (B, n_pages*ps, Hk, D)
            return pages[:, tbl].permute(1, 2, 3, 0, 4).reshape(B, n_pages * ps, Hk, D)

        return _decode_reference(q, gather(k_pages), gather(v_pages), cache_length,
                                 window=window, sink=sink, scale=scale)
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
