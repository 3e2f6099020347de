"""Telemetry on the CPU: the port's ``repro_torch.obs`` (metrics registry,
trace recorder, MFU meters), the engines' telemetry, the pool's gauges and
the CLIs' ``--arrival-rate``, ``--trace-out`` and ``--metrics-out``, held
to the JAX package's ``repro.obs`` on the same inputs; and the port's form
of the JAX package's zero-recompile rule (``tests/test_obs.py``): with
telemetry on, a decode tick and a train step make the same aten calls, in
the same order, as with it off, and reading the registry or the trace
makes none."""

import dataclasses
import json
import math

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.obs as jax_obs
import repro_torch.obs as obs
from repro.configs import registry as jax_registry
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.core.attention import AttentionConfig as JaxAttentionConfig
from repro.distributed import sharding as jax_sharding
from repro.launch import serve as jax_serve
from repro.launch import train as jax_train
from repro.models import lm as jax_lm
from repro.serving.engine import PagedServingEngine as JaxPagedServingEngine
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import AttentionConfig
from repro_torch.kernels import ops
from repro_torch.launch import serve, train
from repro_torch.models.lm import LM, params_from_jax
from repro_torch.obs import mfu as mfu_mod
from repro_torch.serving.engine import PagedServingEngine, Request, ServingEngine

JAX_ENGINE_ATTN = JaxAttentionConfig(impl="flash_xla", decode_splits=8, use_tuned=False)
ATTN = AttentionConfig(impl="flash_cuda")
# The snapshot entries that depend on the host clock.
TIMED = ("decode/compute_seconds", "decode/mfu", "decode/tokens_per_s")


@pytest.fixture
def jax_trace_state(monkeypatch):
    """jax 0.9 removed ``jax.core.trace_state_clean``, which the JAX package's
    context-parallel check calls on every attention layer. Alias it for this
    test only (never process-wide: other tests in the worker must see the
    JAX package as it is), and restore the trace-mode records the alias lets
    the JAX package make."""
    if not hasattr(jax.core, "trace_state_clean"):
        monkeypatch.setattr(jax.core, "trace_state_clean",
                            jax._src.core.trace_state_clean, raising=False)
    saved = set(jax_sharding._traced_modes)
    yield
    jax_sharding._traced_modes.clear()
    jax_sharding._traced_modes.update(saved)


class AtenCalls(TorchDispatchMode):
    """Every aten call made while the mode is on, by name, in order."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls.append(str(func))
        return func(*args, **(kwargs or {}))


# ---------------------------------------------------------------------------
# Registry, histogram, knob and trace-validator cases (tests/test_obs.py),
# each run on both packages; the outcomes must be equal.
# ---------------------------------------------------------------------------


def _raises(fn):
    try:
        fn()
    except ValueError:
        return "ValueError"
    return None


def _counter_gauge(o):
    reg = o.MetricsRegistry()
    c = reg.counter("x/hits")
    c.inc()
    c.inc(2.5)
    reg.gauge("x/level").set(0.75)
    return reg.snapshot(), reg.counter("x/hits") is c, _raises(lambda: c.inc(-1))


def _histogram(o):
    reg = o.MetricsRegistry()
    h = reg.histogram("lat", (1.0, 4.0, 16.0))
    for v in (0.5, 3.0, 3.0, 20.0):
        h.observe(v)
    return (reg.snapshot(), _raises(lambda: reg.histogram("lat", (1.0, 2.0))),
            _raises(lambda: o.MetricsRegistry().histogram("bad", (4.0, 1.0))))


def _gauge_fn(o):
    reg = o.MetricsRegistry()
    state = {"v": 1.0}
    reg.gauge_fn("pool/fill", lambda: state["v"])
    state["v"] = 0.5
    first = reg.snapshot()

    def boom():
        raise RuntimeError("pool is gone")

    reg.gauge_fn("pool/fill", boom)
    return first, math.isnan(reg.snapshot()["pool/fill"])


def _kind_conflict(o):
    reg = o.MetricsRegistry()
    reg.counter("n")
    return (_raises(lambda: reg.gauge("n")), _raises(lambda: reg.histogram("n", (1.0,))),
            reg.names())


def _count_knob(o):
    o.reset_default_registry()
    o.count_knob("flash_pallas", "tuned", 3)
    o.count_knob("flash_pallas", "explicit")
    first = o.default_registry().snapshot()
    bad = _raises(lambda: o.count_knob("flash_pallas", "vibes"))
    o.reset_default_registry()
    return first, bad, o.default_registry().snapshot()


class _FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _trace_nest(o):
    clk = _FakeClock()
    tr = o.TraceRecorder(process="unit", clock=clk)
    with tr.span("outer", tid=1):
        clk.t += 1e-3
        with tr.span("inner", tid=1):
            clk.t += 1e-3
        tr.instant("mark", tid=1, args={"rid": 7})
        clk.t += 1e-3
    tr.counter("occupancy", {"slots": 2})
    tr.name_thread(1, "req 1")
    doc = json.loads(json.dumps(tr.to_json()))
    n = len(o.validate_trace(doc))
    for ev in doc["traceEvents"]:  # the port rounds its times to 2^-10 us
        for key in ("ts", "dur"):
            if key in ev:
                ev[key] = round(ev[key], 2)
    return doc, n


BAD_TRACES = (
    {"traceEvents": [{"name": "x", "ph": "X", "ts": 0}]},
    {"traceEvents": [{"ph": "X", "ts": 0, "pid": 1, "dur": -5}]},
    {"traceEvents": [{"ph": "i", "pid": 1}]},
    {"traceEvents": [{"name": "a", "ph": "X", "ts": 0, "dur": 10, "pid": 1, "tid": 1},
                     {"name": "b", "ph": "X", "ts": 5, "dur": 10, "pid": 1, "tid": 1}]},
    {"traces": []},
)


def _trace_validator(o):
    ok = o.validate_trace({"traceEvents": [
        {"name": "a", "ph": "X", "ts": 0, "dur": 10, "pid": 1, "tid": 1},
        {"name": "b", "ph": "X", "ts": 5, "dur": 10, "pid": 1, "tid": 2},
    ]})
    return [_raises(lambda d=d: o.validate_trace(d)) for d in BAD_TRACES], len(ok)


CASES = {"counter_gauge": _counter_gauge, "histogram": _histogram, "gauge_fn": _gauge_fn,
         "kind_conflict": _kind_conflict, "count_knob": _count_knob,
         "trace_nest": _trace_nest, "trace_validator": _trace_validator}


@pytest.mark.parametrize("case", list(CASES))
def test_obs_case_matches_jax(case):
    got, want = CASES[case](obs), CASES[case](jax_obs)
    assert got == want


def test_histogram_and_trace_values():
    """The cases' values, as tests/test_obs.py pins them for the JAX side."""
    snap = _histogram(obs)[0]
    assert [snap[f"lat/le_{b}"] for b in (1, 4, 16, "inf")] == [1.0, 3.0, 3.0, 4.0]
    assert snap["lat/count"] == 4.0 and snap["lat/sum"] == pytest.approx(26.5)
    doc, _ = _trace_nest(obs)
    outer = next(e for e in doc["traceEvents"] if e["name"] == "outer")
    assert outer["dur"] == pytest.approx(3e3) and doc["traceEvents"][0]["ph"] == "M"
    assert _counter_gauge(obs)[2] == "ValueError"
    assert all(r == "ValueError" for r in _trace_validator(obs)[0])


def test_kv_split_knob_is_counted_on_the_default_registry():
    """``resolve_kv_splits`` counts its tier, as the JAX knob resolution
    does: an explicit count, and the auto policy (heuristic), whether it
    splits (the short-q corner) or not."""
    obs.reset_default_registry()
    ops.resolve_kv_splits(2, (1, 128, 4, 64), (1, 128, 4, 64))
    ops.resolve_kv_splits(None, (1, 128, 4, 64), (1, 128, 4, 64))
    assert ops.resolve_kv_splits(None, (1, 64, 1, 64), (1, 4096, 1, 64)) > 1
    assert obs.default_registry().snapshot() == {
        "knobs/flash_cuda/explicit": 1.0, "knobs/flash_cuda/heuristic": 2.0}
    obs.reset_default_registry()


# ---------------------------------------------------------------------------
# MFU meters: host arithmetic, exactly equal for the same config and times.
# ---------------------------------------------------------------------------

TINY = dict(name="obs-tiny", family="dense", num_layers=2, d_model=64, num_heads=2,
            num_kv_heads=2, head_dim=32, d_ff=128, vocab_size=256, vocab_pad_to=64,
            dtype="float32")
WINDOWED = dict(TINY, name="obs-window", layer_pattern=("attn_local", "attn"), window=48)


@pytest.mark.parametrize("kw", [TINY, WINDOWED], ids=["causal", "window"])
def test_efficiency_gauges_equal_jax(kw):
    jcfg, cfg = JaxModelConfig(**kw), ModelConfig(**kw)
    snaps = []
    for o, c in ((jax_obs, jcfg), (obs, cfg)):
        reg = o.MetricsRegistry()
        train_eff = o.TrainEfficiency(c, batch_size=2, seq_len=128, registry=reg, peak=1e12)
        for dt in (0.5, 0.25, 0.125):
            train_eff.step(dt)
        dec = o.DecodeEfficiency(c, reg, peak=1e12)
        lives = [dec.tick(lens, dt) for lens, dt in (([16, 0, 16], 0.25), ([17, 5, 0], 0.5),
                                                     ([80, 0, 0], 0.125))]
        snaps.append((reg.snapshot(), train_eff.hardware_flops_per_step, lives,
                      dec.tick_model_flops([0, 0]), dec.tick_model_flops([100])))
    assert snaps[1] == snaps[0]
    snap = snaps[1][0]
    assert 0 < snap["train/hfu"] <= snap["train/mfu"] and snap["decode/tokens"] == 5.0


def test_peak_flops_table_env_and_unknown_card(monkeypatch):
    monkeypatch.setenv("REPRO_PEAK_FLOPS", "2.5e12")
    assert obs.peak_flops("cuda") == 2.5e12
    monkeypatch.delenv("REPRO_PEAK_FLOPS")
    assert obs.peak_flops("cpu") == jax_obs.peak_flops("cpu") == 1e11
    monkeypatch.setattr(mfu_mod, "resolve_device", lambda d: torch.device("cuda", 0))
    names = {"h100": "NVIDIA H100 80GB HBM3", "a100": "NVIDIA A100-SXM4-80GB"}
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d: names[card])
    card = "h100"
    assert obs.peak_flops() == 989e12
    card = "a100"  # no number may silently stand for a card the table lacks
    with pytest.raises(ValueError, match="REPRO_PEAK_FLOPS"):
        obs.peak_flops()


# ---------------------------------------------------------------------------
# Engines against the JAX engines, registry and tracer on.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    jcfg = jax_registry.reduce_config(jax_registry.get("qwen3-8b"))
    cfg = registry.reduce_config(registry.get("qwen3-8b"))
    jparams = jax_lm.init_lm(jcfg, jax.random.PRNGKey(0))
    model = LM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jparams)))
    return jcfg, jparams, cfg, model


def _prompts(lengths, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 100, n).tolist() for n in lengths]


# name: (prompt lengths, max_new, engine keyword arguments). "preempt" is the
# JAX package's own case (tests/test_obs.py): four prompts into a pool too
# small for their growth.
ENGINES = {
    "fixed": ((3, 9, 17, 5, 30), 5, dict(max_batch=2, cache_size=64, prompt_pad=16)),
    "paged_preempt": ((6, 6, 6, 6), 24, dict(max_batch=4, num_pages=14, page_size=4,
                                             pages_per_seq_max=8, prompt_pad=16)),
}


def _engines(case, models, **telemetry):
    jcfg, jparams, cfg, model = models
    _, _, kw = ENGINES[case]
    jax_cls, cls = ((JaxServingEngine, ServingEngine) if case == "fixed"
                    else (JaxPagedServingEngine, PagedServingEngine))
    jt = {k: (jax_obs.MetricsRegistry() if k == "registry" else jax_obs.TraceRecorder("test"))
          for k in telemetry}
    return (jax_cls(jcfg, jparams, JAX_ENGINE_ATTN, **kw, **jt),
            cls(cfg, model, ATTN, **kw, **telemetry))


def _events(tracer):
    """(name, ph, tid, args) of every event, in emission order: the times
    aside, what the trace says."""
    return [(e["name"], e["ph"], e.get("tid"), e.get("args")) for e in tracer.events]


@pytest.mark.parametrize("case", list(ENGINES))
def test_engine_telemetry_matches_jax(models, jax_trace_state, case):
    """The same requests through the JAX and the port engine, registry and
    tracer on: the same greedy tokens; the same snapshot keys; every
    counter, histogram and gauge equal but the three the host clock sets;
    the same events in the same order with the same arguments, per
    request track and on the engine track; the port's trace valid."""
    lengths, max_new, _ = ENGINES[case]
    jeng, eng = _engines(case, models, registry=obs.MetricsRegistry(),
                         tracer=obs.TraceRecorder("test"))
    for rid, prompt in enumerate(_prompts(lengths)):
        jeng.submit(JaxRequest(rid=rid, prompt=list(prompt), max_new_tokens=max_new))
        eng.submit(Request(rid=rid, prompt=list(prompt), max_new_tokens=max_new))
    want, got = jeng.run(max_ticks=500), eng.run(max_ticks=500)
    assert sorted(got) == sorted(want) == list(range(len(lengths)))
    for rid in want:
        assert got[rid].generated == want[rid].generated, rid
    jsnap, snap = jeng.snapshot(), eng.snapshot()
    assert sorted(snap) == sorted(jsnap)
    assert {k: v for k, v in snap.items() if k not in TIMED} == {
        k: v for k, v in jsnap.items() if k not in TIMED}
    assert snap["decode/compute_seconds"] > 0 and snap["decode/mfu"] > 0
    assert snap["serving/admissions"] == len(lengths) + getattr(eng, "preemptions", 0)
    assert snap["serving/ticks"] == eng.ticks and snap["serving/retirements"] == len(lengths)
    if case == "paged_preempt":
        assert eng.preemptions > 0 and snap["serving/preemptions"] == eng.preemptions
        assert snap["kv_pool/used_pages"] == 0.0
    else:
        assert snap["serving/queue_wait_ticks/sum"] > 0
    assert _events(eng.tracer) == _events(jeng.tracer)
    # Only the port's trace is validated: the JAX recorder's unrounded times
    # can put a span's end one ulp past the start of the next on its track,
    # which the validator refuses now and then (obs/trace.py, now_us).
    events = obs.validate_trace(json.loads(json.dumps(eng.tracer.to_json())))
    for rid in range(len(lengths)):
        names = {e["name"] for e in events if e.get("tid") == rid}
        assert {"submit", "queue_wait", "prefill", "decode", "retire"} <= names


@pytest.mark.parametrize("case", list(ENGINES))
def test_engine_telemetry_adds_no_aten_call(models, case):
    """Every tick of an engine with a registry and a tracer makes the same
    aten calls, in the same order, as the same engine without them; taking
    the snapshot and exporting the trace make none. (The JAX package pins
    ``decode_compiles == 1`` with telemetry on; an eager tick has no
    compile, so the port pins its dispatches.)"""
    lengths, max_new, _ = ENGINES[case]
    per_tick, tokens = [], []
    for telemetry in ({}, dict(registry=obs.MetricsRegistry(), tracer=obs.TraceRecorder("t"))):
        _, eng = _engines(case, models, **telemetry)
        for rid, prompt in enumerate(_prompts(lengths)):
            eng.submit(Request(rid=rid, prompt=list(prompt), max_new_tokens=max_new))
        ticks = []
        with AtenCalls() as mode:
            while eng.queue or any(s is not None for s in eng.slots):
                n = len(mode.calls)
                eng.tick()
                ticks.append(mode.calls[n:])
            n = len(mode.calls)
            eng.snapshot()
            if eng.tracer:
                json.dumps(eng.tracer.to_json())
            assert mode.calls[n:] == []
        per_tick.append(ticks)
        tokens.append({rid: r.generated for rid, r in eng.finished.items()})
    assert len(per_tick[0]) > 10 and all(per_tick[0])
    assert per_tick[1] == per_tick[0] and tokens[1] == tokens[0]


def test_arrival_rate_matches_jax(models, jax_trace_state):
    """``--arrival-rate``'s driver submits each request at the JAX driver's
    tick (the same draws from the seed), and the greedy tokens agree."""
    submitted = {}
    for name, (drive, eng, req_cls) in {
            "jax": (jax_serve._drive_poisson, *_engines("paged_preempt", models)[:1],
                    JaxRequest),
            "torch": (serve._drive_poisson, _engines("paged_preempt", models)[1], Request),
    }.items():
        ticks, submit = [], eng.submit

        def record(req, eng=eng, ticks=ticks, submit=submit):
            ticks.append((req.rid, eng.ticks))
            submit(req)

        eng.submit = record
        reqs = [req_cls(rid=rid, prompt=p, max_new_tokens=6)
                for rid, p in enumerate(_prompts((5, 9, 3, 12, 7, 4)))]
        drive(eng, reqs, 0.5, 7, max_ticks=500)
        submitted[name] = (ticks, {rid: r.generated for rid, r in eng.finished.items()})
    assert submitted["torch"] == submitted["jax"]
    assert len({t for _, t in submitted["torch"][0]}) > 2  # arrivals spread over ticks


# ---------------------------------------------------------------------------
# The CLIs' --metrics-out and --trace-out, and the train loop's registry.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["fixed", "paged"])
def test_serve_cli_writes_metrics_and_trace(tmp_path, capsys, engine):
    m, t = tmp_path / "m.json", tmp_path / "t.json"
    serve.main(["--arch", "qwen3-8b", "--reduce", "--device", "cpu", "--engine", engine,
                "--requests", "4", "--max-new", "4", "--arrival-rate", "1.0",
                "--metrics-out", str(m), "--trace-out", str(t)])
    summary = json.loads(capsys.readouterr().out.splitlines()[0])
    snap = json.loads(m.read_text())
    assert summary["metrics"] == snap and summary["requests"] == 4
    assert snap["serving/retirements"] == 4.0 and snap["knobs/flash_cuda/heuristic"] > 0
    events = obs.validate_trace(json.loads(t.read_text()))
    assert sum(e["name"] == "retire" for e in events) == 4
    assert events[0]["args"]["name"] == f"serve:{engine}"


def _loop_kwargs():
    return dict(steps=2, seq_len=32, batch_size=2, log_every=1, seed=0)


def test_train_cli_writes_metrics_and_trace(tmp_path, capsys):
    m, t = tmp_path / "m.json", tmp_path / "t.json"
    train.main(["--arch", "granite-moe-1b-a400m", "--reduce", "--device", "cpu", "--steps",
                "3", "--seq", "32", "--batch", "2", "--metrics-out", str(m),
                "--trace-out", str(t)])
    summary = json.loads(capsys.readouterr().out.splitlines()[-1])
    snap = json.loads(m.read_text())
    assert snap["train/steps"] == 3.0 and snap["train/tokens"] == 3 * 2 * 32
    assert summary["mfu"] == snap["train/mfu"] > 0
    assert snap["train/loss"] > 0 and snap["knobs/flash_cuda/heuristic"] > 0
    events = obs.validate_trace(json.loads(t.read_text()))
    assert [e["name"] for e in events if e["ph"] == "X"] == ["data", "compute", "step"] * 3


def test_train_snapshot_keys_match_jax(jax_trace_state):
    """The train loop's snapshot has the JAX loop's keys but the four
    counters of the fault-tolerance modules, which come with them
    (ROADMAP.md queue 1, item 4)."""
    cfg, jcfg = ModelConfig(**TINY), JaxModelConfig(**TINY)
    port = train.train(cfg, train.TrainLoopConfig(device="cpu", **_loop_kwargs()))[2]
    ref = jax_train.train(jcfg, jax_train.TrainLoopConfig(attn_impl="ref", **_loop_kwargs()))[2]
    snap, jsnap = port["registry"].snapshot(), ref["registry"].snapshot()
    assert set(jsnap) - set(snap) == {"train/stragglers", "train/checkpoints",
                                      "train/preemptions", "train/restarts"}
    assert set(snap) <= set(jsnap)
    for key in ("train/steps", "train/tokens", "train/model_flops"):
        assert snap[key] == jsnap[key], key
    assert snap["train/loss"] == port["loss"][-1]


def test_train_telemetry_adds_no_aten_call(tmp_path):
    """Two train steps with a tracer, a metrics file and a given registry
    make the same aten calls, in the same order, as without them."""
    cfg = ModelConfig(**TINY)
    calls = []
    for extra in ({}, dict(trace_out=str(tmp_path / "t.json"),
                           metrics_out=str(tmp_path / "m.json"),
                           registry=obs.MetricsRegistry())):
        with AtenCalls() as mode:
            history = train.train(cfg, train.TrainLoopConfig(device="cpu", **_loop_kwargs(),
                                                             **extra))[2]
        calls.append(mode.calls)
        assert history["registry"].snapshot()["train/steps"] == 2.0
    assert len(calls[0]) > 100 and calls[1] == calls[0]
