"""Deterministic synthetic token stream for training.

A copy of the synthetic source of ``repro/data/pipeline.py`` (numpy only):
the port keeps its own so that it never imports the JAX package, and the
two give the same batches as integers for the same (seed, step). The
packed (varlen) and file sources are not ported yet.
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
    source: str = "synthetic"  # 'synthetic' ('file' and 'packed' are not ported)
    path: Optional[str] = None


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


def make_source(cfg: DataConfig) -> SyntheticLM:
    if cfg.source != "synthetic":
        raise NotImplementedError(
            f"data source {cfg.source!r} is not ported yet (ROADMAP.md, modules to "
            "port); the port has the synthetic stream"
        )
    return SyntheticLM(cfg)
