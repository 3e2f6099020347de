"""The port's timing and FLOP utilities (``utils/timing.py``,
``utils/flops.py``) against the JAX package's: the parameter and
model-FLOP counts are equal exactly for every registry config and shape
cell, the one-device flash-kernel byte count equals the JAX package's
one-chip count where the two models agree and a tile-by-tile hand count;
the interleaved timer keeps its order, minimum and provenance."""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.utils import flops as jax_flops
from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.models.lm import init_lm
from repro_torch.utils import flops, timing


@pytest.mark.parametrize("name", registry.names())
def test_counts_equal_jax(name):
    cfg, jcfg = registry.get(name), jax_registry.get(name)
    assert flops.param_count(cfg) == jax_flops.param_count(jcfg)
    assert sorted(SHAPES) == sorted(JAX_SHAPES)
    for shape in SHAPES:
        s, js = SHAPES[shape], JAX_SHAPES[shape]
        for fn in ("train_model_flops", "prefill_model_flops", "decode_model_flops",
                   "model_flops"):
            assert getattr(flops, fn)(cfg, s) == getattr(jax_flops, fn)(jcfg, js), (fn, shape)
        # The port counts one device; the JAX package's count on a one-chip
        # mesh is the same where their models agree: every kv head streamed
        # per q head (MHA) and the forward recomputed in every layer (no tail
        # layers outside the scan groups). Large tiles keep JAX's per-layer
        # tile loop short.
        mha = dict(num_kv_heads=cfg.num_heads, attn_sharding="heads",
                   num_layers=max(cfg.num_groups, 1) * cfg.group_size)
        for bq, bk in ((1024, 1024), (512, 256)):
            assert (flops.flash_kernel_bytes(dataclasses.replace(cfg, **mha), s, block_q=bq,
                                             block_kv=bk)
                    == jax_flops.flash_kernel_bytes(dataclasses.replace(jcfg, **mha), js,
                                                    block_q=bq, block_kv=bk, model_axis=1,
                                                    data_axis=1)), (shape, bq, bk)


def test_flash_kernel_bytes_hand_count():
    """One device at the CUDA kernels' 64 x 64 tiles, counted tile by tile:
    gemma3-1b's GQA (4 q heads on 1 kv head) at S 256, so 10 of the 4 x 4
    causal tile pairs are visible (its 512 window covers the sequence), 7
    layers of which the scan group's 6 recompute the forward under remat and
    the tail layer does not."""
    cfg = dataclasses.replace(registry.get("gemma3-1b"), num_layers=7)
    B, S, bq, bk, pairs, dt = 2, 256, 64, 64, 10, 2
    Hq, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    assert (Hq, Hkv, cfg.num_groups * cfg.group_size, cfg.window) == (4, 1, 6, 512)
    q_once = B * S * Hq * D * dt  # Q, O, dO or dQ, each once
    lse = B * Hq * S * 4
    kv_once = B * S * Hkv * D * dt  # K, V, dK or dV, each once per kv head
    kv_tile = B * Hq * bk * D * dt  # K or V tile of a pair, read by each q head
    q_tile = B * Hq * bq * D * dt  # Q or dO tile of a pair
    lse_tile = B * Hq * bq * 4  # lse or delta tile of a pair
    fwd = 2 * q_once + lse + pairs * 2 * kv_tile
    bwd = 4 * kv_once + pairs * (2 * q_tile + 2 * lse_tile) + 3 * q_once + pairs * 2 * kv_tile
    train = ShapeConfig("t", "train", S, B)
    assert flops.flash_kernel_bytes(cfg, train) == 7 * (fwd + bwd) + 6 * fwd
    assert (flops.flash_kernel_bytes(dataclasses.replace(cfg, remat=False), train)
            == 7 * (fwd + bwd))
    assert flops.flash_kernel_bytes(cfg, ShapeConfig("p", "prefill", S, B)) == 7 * fwd
    assert flops.flash_kernel_bytes(cfg, ShapeConfig("d", "decode", S, B)) == 0.0


@pytest.mark.parametrize("kind,window,sink", [("causal", None, 0), ("full", None, 0),
                                              ("window", 64, 0), ("window", 64, 16)])
def test_visible_fraction_equals_jax(kind, window, sink):
    for t_q, t_kv, bq, bk, off in ((8, 8, 64, 64, 0), (3, 7, 128, 32, 0), (4, 4, 64, 64, 96)):
        assert (flops._visible_fraction(kind, window, sink, t_q, t_kv, bq, bk, off)
                == jax_flops._visible_fraction(kind, window, sink, t_q, t_kv, bq, bk, off))


def test_count_params_takes_a_module_or_a_dict():
    cfg = registry.reduce_config(registry.get("qwen3-8b"))
    model = init_lm(cfg, seed=0, device="cpu")
    params = dict(model.named_parameters())
    n = sum(p.numel() for p in params.values())
    assert flops.count_params(model) == flops.count_params(params) == n
    # The analytic count of an untied LM equals its parameters once the
    # norms (not counted analytically) are taken out.
    norms = sum(p.numel() for name, p in params.items() if "ln" in name or "norm" in name)
    assert flops.param_count(cfg)[0] == n - norms


class _Clock:
    """A fake ``time.perf_counter`` and callables that advance it by fixed
    costs, recording the order of calls."""

    def __init__(self):
        self.now, self.calls = 0.0, []

    def __call__(self):
        return self.now

    def fn(self, name, costs):
        it = itertools.cycle(costs)

        def run():
            self.calls.append(name)
            self.now += next(it)
            return torch.zeros(1)
        return run


def test_interleaved_timeit_order_min_and_provenance(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(timing.time, "perf_counter", clock)
    fns = {"b": clock.fn("b", [3.0, 1.0, 2.0]), "a": clock.fn("a", [5.0, 4.0, 6.0])}
    best = timing.interleaved_timeit(fns, iters=3, warmup=2)
    # Warm-up calls per callable in insertion order, then round-robin rounds.
    assert clock.calls == ["b", "b", "a", "a"] + ["b", "a"] * 3
    assert list(best) == ["b", "a"]
    # Two warm-ups take costs 3 and 1 of b's cycle; its timed samples are 2, 3, 1.
    assert best == {"b": 1.0, "a": 4.0}
    assert (best.iters, best.warmup, best.provenance) == (3, 2, "min_of_3w2")
    assert isinstance(best, dict)
    assert timing.interleaved_timeit({}).provenance == "min_of_5w1"
    assert timing.time_min(clock.fn("c", [7.0, 0.5]), iters=1) == 0.5  # after the warm-up


def test_time_min_runs_real_work():
    x = torch.randn(64, 64)
    t = timing.time_min(lambda a: a @ a, x, iters=3)
    assert np.isfinite(t) and t > 0
    # CPU outputs need no synchronisation; nested outputs are walked.
    assert timing.block_until_ready({"a": (x, [x])}) == {"a": (x, [x])}
