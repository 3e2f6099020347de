"""Metrics registry: counters, gauges, fixed-bucket histograms.

The counterpart of ``repro/obs/metrics.py``, the same classes, names and
snapshot schema (that module imports no JAX; the port keeps its own copy).
One registry per component (each serving engine owns one; the train loop
builds one per run) plus a process-wide *default* registry for code that
has no owner to hand it one (the kernel knob counters). Everything is
plain host-side Python: no tensor is read or written, so attaching a
registry adds no kernel launch and no host synchronisation
(``tests/test_torch_obs.py`` counts the aten calls with it on and off).

Snapshot schema (the single flat dict every exporter consumes):

  * counter ``name``      -> ``{name: float}``
  * gauge ``name``        -> ``{name: float}`` (callable gauges are
    sampled at snapshot time; a raising sampler yields ``nan``, never an
    exception -- a metrics read must not take the server down)
  * histogram ``name``    -> ``{name/le_B: count}`` per finite bucket
    bound ``B``, plus ``{name/le_inf, name/count, name/sum}``

Names are flat ``component/metric`` strings. Re-requesting a name returns
the existing instrument; re-requesting it as a *different kind* raises.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "default_registry",
    "reset_default_registry",
    "count_knob",
]


class Counter:
    """Monotonically increasing count (events, tokens, hits)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative increment {n}")
        self.value += n


class Gauge:
    """Last-written point-in-time value (occupancy, MFU, queue depth)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-bucket histogram: cumulative-style ``le`` bucket counts.

    ``buckets`` are the finite upper bounds, ascending; an implicit
    ``+inf`` bucket always exists. ``observe(v)`` increments the count of
    every bucket whose bound is >= v (Prometheus cumulative semantics, so
    quantile estimates need no re-summing).
    """

    __slots__ = ("name", "buckets", "counts", "inf_count", "total", "sum")

    def __init__(self, name: str, buckets: Sequence[float]):
        bounds = [float(b) for b in buckets]
        if not bounds or bounds != sorted(bounds) or len(set(bounds)) != len(bounds):
            raise ValueError(
                f"histogram {name}: buckets must be non-empty, ascending, "
                f"unique finite bounds, got {buckets!r}"
            )
        self.name = name
        self.buckets = bounds
        self.counts = [0] * len(bounds)
        self.inf_count = 0
        self.total = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        self.total += 1
        self.sum += v
        self.inf_count += 1
        for i, b in enumerate(self.buckets):
            if v <= b:
                self.counts[i] += 1


def _fmt_bound(b: float) -> str:
    return str(int(b)) if float(b).is_integer() else repr(b)


class MetricsRegistry:
    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._gauge_fns: Dict[str, Callable[[], float]] = {}
        self._histograms: Dict[str, Histogram] = {}

    # ------------------------------------------------------- registration
    def _claim(self, name: str, kind: str) -> None:
        kinds = {
            "counter": self._counters,
            "gauge": self._gauges,
            "gauge_fn": self._gauge_fns,
            "histogram": self._histograms,
        }
        for k, store in kinds.items():
            if k != kind and name in store:
                raise ValueError(
                    f"metric {name!r} already registered as a {k}, "
                    f"cannot re-register as a {kind}"
                )

    def counter(self, name: str) -> Counter:
        self._claim(name, "counter")
        return self._counters.setdefault(name, Counter(name))

    def gauge(self, name: str) -> Gauge:
        self._claim(name, "gauge")
        return self._gauges.setdefault(name, Gauge(name))

    def gauge_fn(self, name: str, fn: Callable[[], float]) -> None:
        """Register a lazily sampled gauge: ``fn`` runs at snapshot time.

        The natural fit for state someone else already owns (pool
        occupancy, queue depth) -- no per-event write traffic, the
        snapshot reads the live value. Re-registering a name replaces the
        sampler (an engine rebuilt on the same registry wins).
        """
        self._claim(name, "gauge_fn")
        self._gauge_fns[name] = fn

    def histogram(self, name: str, buckets: Sequence[float]) -> Histogram:
        self._claim(name, "histogram")
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(name, buckets)
        elif list(h.buckets) != [float(b) for b in buckets]:
            raise ValueError(
                f"histogram {name!r} re-requested with different buckets"
            )
        return h

    # ------------------------------------------------------------ export
    def snapshot(self) -> Dict[str, float]:
        """The flat-dict schema documented in the module docstring."""
        out: Dict[str, float] = {}
        for name, c in self._counters.items():
            out[name] = c.value
        for name, g in self._gauges.items():
            out[name] = g.value
        for name, fn in self._gauge_fns.items():
            try:
                out[name] = float(fn())
            except Exception:
                out[name] = math.nan
        for name, h in self._histograms.items():
            for b, n in zip(h.buckets, h.counts):
                out[f"{name}/le_{_fmt_bound(b)}"] = float(n)
            out[f"{name}/le_inf"] = float(h.inf_count)
            out[f"{name}/count"] = float(h.total)
            out[f"{name}/sum"] = h.sum
        return out

    def names(self) -> List[str]:
        return sorted(
            list(self._counters) + list(self._gauges)
            + list(self._gauge_fns) + list(self._histograms)
        )


# ---------------------------------------------------------------------------
# Process-wide default registry (kernel knob-source counters live here: the
# knob resolution runs deep inside the attention call with no registry
# argument).
# ---------------------------------------------------------------------------

_default = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _default


def reset_default_registry() -> MetricsRegistry:
    """Fresh default registry (tests); returns the new one."""
    global _default
    _default = MetricsRegistry()
    return _default


_KNOB_SOURCES = ("explicit", "tuned", "heuristic")


def count_knob(family: str, source: str, n: int = 1,
               registry: Optional[MetricsRegistry] = None) -> None:
    """Count one kernel-knob resolution hit: ``knobs/<family>/<source>``.

    ``family`` is the kernel family (``flash_cuda``: the kv split count
    of the forward kernels); ``source`` is which precedence tier won
    (explicit > tuned > heuristic). Called from
    ``kernels/ops.resolve_kv_splits`` on every attention call, which the
    port runs eagerly (the JAX package counts once per jit trace). The
    ``tuned`` tier has no source in the port yet (ROADMAP.md queue 1,
    item 7).
    """
    if source not in _KNOB_SOURCES:
        raise ValueError(f"unknown knob source {source!r}; want {_KNOB_SOURCES}")
    (registry or _default).counter(f"knobs/{family}/{source}").inc(n)
