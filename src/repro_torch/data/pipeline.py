"""Deterministic synthetic token streams for training.

A copy of the synthetic and packed (varlen) sources of
``repro/data/pipeline.py`` and of its ``pack_documents`` (numpy only): the
port keeps its own so that it never imports the JAX package, and the two
give the same batches as integers for the same (seed, step). The file
source is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class DataConfig:
    batch_size: int  # global batch (sequences per step)
    seq_len: int
    vocab_size: int
    seed: int = 0
    source: str = "synthetic"  # 'synthetic' | 'packed' ('file' is not ported)
    path: Optional[str] = None
    # 'packed' (varlen) source: ragged document lengths, uniform in
    # [min_doc_len, max_doc_len] (max defaults to seq_len).
    min_doc_len: int = 16
    max_doc_len: Optional[int] = None


def pack_documents(docs, seq_len: int, pad_id: int = 0):
    """Greedy first-fit packing of ragged token docs into fixed-width rows
    (JAX ``pipeline.py:38``).

    A doc of ``L`` tokens contributes its ``L - 1`` (input, target) pairs.
    Segment ids are 1-based per row; 0 marks padding, which the loss mask
    excludes. Returns (inputs, targets, segment_ids, loss_mask) as
    (N, seq_len) arrays (loss_mask float32, the others int32)."""
    rows = []   # the docs of each row
    space = []  # remaining capacity per row
    for doc in docs:
        doc = np.asarray(doc)
        if doc.ndim != 1 or len(doc) < 2:
            raise ValueError("docs need >= 2 tokens")
        n = len(doc) - 1
        if n > seq_len:
            raise ValueError(f"doc of {n} pairs exceeds seq_len {seq_len}")
        for r in range(len(rows)):  # first fit
            if space[r] >= n:
                rows[r].append(doc)
                space[r] -= n
                break
        else:
            rows.append([doc])
            space.append(seq_len - n)
    N = len(rows)
    inputs = np.full((N, seq_len), pad_id, np.int32)
    targets = np.full((N, seq_len), pad_id, np.int32)
    segment_ids = np.zeros((N, seq_len), np.int32)
    for r, row_docs in enumerate(rows):
        ofs = 0
        for s, doc in enumerate(row_docs, start=1):
            n = len(doc) - 1
            inputs[r, ofs:ofs + n] = doc[:-1]
            targets[r, ofs:ofs + n] = doc[1:]
            segment_ids[r, ofs:ofs + n] = s
            ofs += n
    loss_mask = (segment_ids != 0).astype(np.float32)
    return inputs, targets, segment_ids, loss_mask


class SyntheticLM:
    """Order-2 bigram-ish synthetic stream: next = f(prev, noise).

    A fixed random permutation map gives it learnable structure, so a loss
    that drops below the uniform entropy is a real end-to-end signal. The
    batch of a step is a pure function of (seed, step)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed ^ 0xC0FFEE)
        self.perm = rng.permutation(cfg.vocab_size).astype(np.int64)
        self.step_ = 0

    def batch(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        """(inputs, targets), each (batch_size, seq_len) int32."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, S = cfg.batch_size, cfg.seq_len
        toks = np.empty((B, S + 1), np.int64)
        toks[:, 0] = rng.integers(0, cfg.vocab_size, size=B)
        noise = rng.random((B, S)) < 0.1
        jumps = rng.integers(0, cfg.vocab_size, size=(B, S))
        for t in range(1, S + 1):
            nxt = self.perm[toks[:, t - 1]]
            toks[:, t] = np.where(noise[:, t - 1], jumps[:, t - 1], nxt)
        return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        while True:
            out = self.batch(self.step_)
            self.step_ += 1
            yield out


class SyntheticVarlenLM(SyntheticLM):
    """Packed (varlen) synthetic stream (JAX ``pipeline.py:123``): the same
    learnable permutation process and (seed, step) determinism as
    :class:`SyntheticLM`, but each row packs back-to-back documents of random
    length, and ``batch(step)`` returns a dict with inputs, targets,
    segment_ids (1-based per row, 0 = padding) and loss_mask. Attention
    must not cross a segment boundary; padding is left out of the loss."""

    def _doc(self, rng, length: int) -> np.ndarray:
        toks = np.empty(length + 1, np.int64)
        toks[0] = rng.integers(0, self.cfg.vocab_size)
        noise = rng.random(length) < 0.1
        jumps = rng.integers(0, self.cfg.vocab_size, size=length)
        for t in range(1, length + 1):
            nxt = self.perm[toks[t - 1]]
            toks[t] = jumps[t - 1] if noise[t - 1] else nxt
        return toks

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, S = cfg.batch_size, cfg.seq_len
        lo = cfg.min_doc_len
        hi = min(cfg.max_doc_len or S, S)
        inputs = np.zeros((B, S), np.int32)
        targets = np.zeros((B, S), np.int32)
        segment_ids = np.zeros((B, S), np.int32)
        for b in range(B):
            ofs, seg = 0, 1
            while S - ofs >= lo:
                n = int(rng.integers(lo, min(hi, S - ofs) + 1))
                doc = self._doc(rng, n)  # n + 1 tokens -> n pairs
                inputs[b, ofs:ofs + n] = doc[:-1]
                targets[b, ofs:ofs + n] = doc[1:]
                segment_ids[b, ofs:ofs + n] = seg
                ofs += n
                seg += 1
        return {
            "inputs": inputs,
            "targets": targets,
            "segment_ids": segment_ids,
            "loss_mask": (segment_ids != 0).astype(np.float32),
        }


def make_source(cfg: DataConfig) -> SyntheticLM:
    if cfg.source == "packed":
        return SyntheticVarlenLM(cfg)
    if cfg.source != "synthetic":
        raise NotImplementedError(
            f"data source {cfg.source!r} is not ported yet (ROADMAP.md, modules to "
            "port); the port has the synthetic and packed streams"
        )
    return SyntheticLM(cfg)
