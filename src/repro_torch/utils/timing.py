"""Interleaved min-of-N wall-clock timing.

The counterpart of ``repro/utils/timing.py``: the port's timing discipline
for comparisons on one device. Two rules:

  * **min, not mean.** On a shared host every sample is the true cost plus
    non-negative noise (preemption, page faults, GC, clock changes); the
    minimum over N samples estimates the true cost, the mean is biased up
    by exactly that noise.
  * **interleave competitors.** Candidates that will be compared run
    round-robin inside each round instead of back to back in blocks, so
    slow drift (thermal, co-tenant load) hits every one alike.

The clock is the host's: every call ends by synchronising the device of
its outputs (``torch.cuda.synchronize`` for CUDA tensors; nothing for CPU
tensors), so asynchronous launches never let a sample stop before the work
does. A sample therefore includes the host's launch overhead.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Mapping

import torch

__all__ = ["TimingResult", "interleaved_timeit", "time_min"]

DEFAULT_ITERS = 5


class TimingResult(Dict[str, float]):
    """``{name: best_seconds}`` plus the discipline that produced it:
    ``iters`` timed rounds per competitor after ``warmup`` untimed calls;
    ``provenance`` renders the tag ``min_of_{iters}w{warmup}``."""

    def __init__(self, best: Dict[str, float], iters: int, warmup: int):
        super().__init__(best)
        self.iters = iters
        self.warmup = warmup

    @property
    def provenance(self) -> str:
        return f"min_of_{self.iters}w{self.warmup}"


def _cuda_devices(out, found: set) -> set:
    """The CUDA devices of every tensor in ``out`` (nested tuples, lists and
    dict values)."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, (tuple, list)):
        for x in out:
            _cuda_devices(x, found)
    elif isinstance(out, dict):
        for x in out.values():
            _cuda_devices(x, found)
    return found


def block_until_ready(out):
    """Wait until the work that produced ``out`` has finished on its devices;
    returns ``out``."""
    for dev in _cuda_devices(out, set()):
        torch.cuda.synchronize(dev)
    return out


def interleaved_timeit(fns: Mapping[str, Callable], *args, iters: int = DEFAULT_ITERS,
                       warmup: int = 1) -> TimingResult:
    """Time competing callables interleaved; return best seconds per name.

    Every callable is invoked as ``fn(*args)``: ``warmup`` untimed calls
    each (first-call allocations, kernel builds), then ``iters`` rounds in
    which the callables run round-robin in insertion order, each keeping
    the minimum of its samples."""
    iters, warmup = max(1, iters), max(1, warmup)
    items = list(fns.items())
    if not items:
        return TimingResult({}, iters, warmup)
    for _, fn in items:
        for _ in range(warmup):
            block_until_ready(fn(*args))
    best = {name: float("inf") for name, _ in items}
    for _ in range(iters):
        for name, fn in items:
            t0 = time.perf_counter()
            block_until_ready(fn(*args))
            best[name] = min(best[name], time.perf_counter() - t0)
    return TimingResult(best, iters, warmup)


def time_min(fn: Callable, *args, iters: int = DEFAULT_ITERS, warmup: int = 1) -> float:
    """Min-of-N timing of a single callable (a degenerate interleave)."""
    return interleaved_timeit({"fn": fn}, *args, iters=iters, warmup=warmup)["fn"]
