"""Span-based event log exported as Chrome/Perfetto ``trace_event`` JSON.

The counterpart of ``repro/obs/trace.py`` (which imports no JAX; the port
keeps its own copy). One :class:`TraceRecorder` per run collects events
host-side (a plain list of dicts: no tensor is touched, so recording
around a step adds no kernel launch) and serializes to the JSON Object Format the
Perfetto UI / ``chrome://tracing`` load directly::

    {"traceEvents": [{"name", "ph", "ts", "pid", "tid", ...}, ...],
     "displayTimeUnit": "ms"}

Event vocabulary (the JAX package's, DESIGN.md §9 span taxonomy):

  * serving (pid ``serve``): per-request *tracks* (tid = request id)
    carry ``queue_wait`` -> ``prefill`` -> ``decode`` complete spans plus
    ``submit`` / ``retire`` / ``preempt`` / ``resume`` instants; the
    engine track (tid 0) carries per-tick ``decode_tick`` spans,
    ``admit`` batch spans and ``page_oom`` instants.
  * training (pid ``train``): per-step ``step`` spans with nested
    ``data`` / ``compute`` child spans on one track (the JAX package's
    ``checkpoint`` span comes with the checkpoint store, ROADMAP.md queue 1
    item 4; so does its process-wide default recorder, which only the
    checkpoint store and ring attention write to).

Timestamps are microseconds from the recorder's construction
(``time.perf_counter`` based -- monotonic, so spans always nest even
across NTP adjustments). Durations use ``X`` (complete) events recorded
at span *exit* with the entry timestamp carried along: emission order
never has to match nesting order, and a crashed span simply never emits
(the trace stays schema-valid).
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

__all__ = ["TraceRecorder", "validate_trace"]


class TraceRecorder:
    def __init__(self, process: str = "repro", pid: int = 1, clock=None):
        self.pid = pid
        self.events: List[dict] = []
        self._clock = clock or time.perf_counter
        self._t0 = self._clock()
        self._thread_names: Dict[int, str] = {}
        self.events.append({
            "name": "process_name", "ph": "M", "ts": 0, "pid": pid, "tid": 0,
            "args": {"name": process},
        })

    # ------------------------------------------------------------- clock
    def now_us(self) -> float:
        """Microseconds since recorder construction (event timebase),
        rounded to a multiple of 2^-10 us. On such values (below 2^43 us)
        a sum or difference is exact, so a span written as (ts, end - ts)
        ends exactly where the next one, written from the same end, starts:
        unrounded, ts + dur could land one ulp past it, and
        :func:`validate_trace` refuse the two adjacent spans as overlapping
        (which the JAX recorder does now and then)."""
        return round((self._clock() - self._t0) * 1e6 * 1024) / 1024

    # ------------------------------------------------------------ events
    def name_thread(self, tid: int, name: str) -> None:
        """Label a track (idempotent; Perfetto shows it as the row name)."""
        if self._thread_names.get(tid) == name:
            return
        self._thread_names[tid] = name
        self.events.append({
            "name": "thread_name", "ph": "M", "ts": 0, "pid": self.pid,
            "tid": tid, "args": {"name": name},
        })

    def complete(self, name: str, tid: int, ts_us: float, dur_us: float,
                 cat: str = "repro", args: Optional[dict] = None) -> None:
        """A finished span: ``X`` event with explicit start + duration."""
        ev = {
            "name": name, "ph": "X", "ts": ts_us, "dur": max(0.0, dur_us),
            "pid": self.pid, "tid": tid, "cat": cat,
        }
        if args:
            ev["args"] = args
        self.events.append(ev)

    def instant(self, name: str, tid: int, cat: str = "repro",
                args: Optional[dict] = None) -> None:
        ev = {
            "name": name, "ph": "i", "ts": self.now_us(), "pid": self.pid,
            "tid": tid, "cat": cat, "s": "t",
        }
        if args:
            ev["args"] = args
        self.events.append(ev)

    def counter(self, name: str, values: Dict[str, float], tid: int = 0,
                cat: str = "repro") -> None:
        """A ``C`` sample: Perfetto renders these as stacked area tracks."""
        self.events.append({
            "name": name, "ph": "C", "ts": self.now_us(), "pid": self.pid,
            "tid": tid, "cat": cat,
            "args": {k: float(v) for k, v in values.items()},
        })

    @contextmanager
    def span(self, name: str, tid: int = 0, cat: str = "repro",
             args: Optional[dict] = None):
        """Context-managed span; emits one ``X`` event on normal exit."""
        t0 = self.now_us()
        try:
            yield
        finally:
            self.complete(name, tid, t0, self.now_us() - t0, cat=cat, args=args)

    # ------------------------------------------------------------ export
    def to_json(self) -> dict:
        return {"traceEvents": list(self.events), "displayTimeUnit": "ms"}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f)


def validate_trace(doc: dict) -> List[dict]:
    """Schema-check a trace document; returns the event list.

    Every event must carry ``ph``/``ts``/``pid`` (the fields the Perfetto
    JSON importer requires), ``X`` events a non-negative ``dur``, and on
    each (pid, tid) track the ``X`` spans must properly nest (equal-time
    zero-duration overlaps allowed). Raises ``ValueError`` on violation.
    Used by tests and the CI smoke -- an exporter regression fails fast
    instead of producing a trace the UI silently refuses.
    """
    if not isinstance(doc, dict) or not isinstance(doc.get("traceEvents"), list):
        raise ValueError("trace must be {'traceEvents': [...]}")
    events = doc["traceEvents"]
    for ev in events:
        for field in ("ph", "ts", "pid"):
            if field not in ev:
                raise ValueError(f"event missing {field!r}: {ev}")
        if ev["ph"] == "X" and not (isinstance(ev.get("dur"), (int, float))
                                    and ev["dur"] >= 0):
            raise ValueError(f"X event needs dur >= 0: {ev}")
    tracks: Dict[tuple, List[tuple]] = {}
    for ev in events:
        if ev["ph"] == "X":
            tracks.setdefault((ev["pid"], ev.get("tid", 0)), []).append(
                (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]), ev)
            )
    for key, spans in tracks.items():
        spans.sort(key=lambda s: (s[0], -s[1]))
        stack: List[tuple] = []
        for t0, t1, ev in spans:
            while stack and stack[-1][1] <= t0:
                stack.pop()
            if stack and t1 > stack[-1][1]:
                raise ValueError(
                    f"spans overlap without nesting on track {key}: "
                    f"{stack[-1][2].get('name')} vs {ev.get('name')}"
                )
            stack.append((t0, t1, ev))
    return events
