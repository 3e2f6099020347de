"""The paged serving slice of the port against the JAX package on the CPU:
the page pool (state exactly), the paged decode partials (the port's plain
version against the Pallas kernel in interpret mode), the paged decode
entry points, one paged admission and decode step of the LM, and the paged
engine as a whole (greedy tokens, block tables and pool state tick by tick,
through batched admission and a forced preemption), at G = 1 and G = 2.
Inputs are made from numpy seeds and handed to both sides."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.core.attention import AttentionConfig as JaxAttentionConfig
from repro.core.decode import flash_decode_paged as jax_decode_paged_gather
from repro.distributed import sharding as jax_sharding
from repro.kernels.flash_decode import flash_decode_paged_kernel as jax_paged_kernel
from repro.kernels.ops import flash_decode_paged_pallas
from repro.launch.steps import build_paged_admit_step as jax_build_paged_admit_step
from repro.models import lm as jax_lm
from repro.serving.engine import PagedServingEngine as JaxPagedServingEngine
from repro.serving.engine import Request as JaxRequest
from repro.serving.kv_pool import KVPagePool as JaxKVPagePool
from repro_torch.configs import registry
from repro_torch.core.attention import AttentionConfig, decode_attention_paged
from repro_torch.kernels import flash_decode as dec_mod
from repro_torch.kernels import ops
from repro_torch.launch.steps import build_paged_admit_step
from repro_torch.models.lm import LM, params_from_jax
from repro_torch.serving.engine import PagedServingEngine, Request
from repro_torch.serving.kv_pool import NULL_PAGE, KVPagePool

KERNEL_TOL = dict(atol=2e-5, rtol=2e-5)  # f32 on both sides, summation order only
# f32 logits and K/V of a 2-layer model; differences are summation order only.
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
# The port decodes with ops.DEFAULT_DECODE_SPLITS; the JAX side is given the
# same count so that both split the cache the same way (its tuned cache is
# keyed on TPU measurements).
JAX_ATTN = JaxAttentionConfig(impl="flash_pallas", decode_splits=ops.DEFAULT_DECODE_SPLITS,
                              use_tuned=False)
# The engine runs many admission widths and buckets: its JAX side takes the
# XLA paths (the gather oracle for paged decode), as the JAX package's own
# engine tests do, to keep compiles few; the Pallas kernels are held to the
# port above and in the step test.
JAX_ENGINE_ATTN = JaxAttentionConfig(impl="flash_xla", decode_splits=ops.DEFAULT_DECODE_SPLITS,
                                     use_tuned=False)
ATTN = AttentionConfig(impl="flash_cuda")
D = 16


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


# ---------------------------------------------------------------------------
# Pool
# ---------------------------------------------------------------------------

def _pool_state(pool):
    return (list(pool._free), {r: list(p) for r, p in pool._owned.items()},
            pool.free_pages, pool.used_pages, pool.usable_pages, pool.page_utilization())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pool_matches_jax_step_by_step(seed):
    """A random run of alloc / extend / free (OOM included): every result
    and the whole state, LIFO free-list order included, equal after every
    operation."""
    rng = np.random.default_rng(seed)
    ours, theirs = KVPagePool(12, 8), JaxKVPagePool(12, 8)
    assert NULL_PAGE == 0 and _pool_state(ours) == _pool_state(theirs)
    live, next_rid, ooms = [], 0, 0
    for _ in range(200):
        op = rng.integers(3)
        if op == 0 or not live:
            n = int(rng.integers(1, 6))
            got, want = ours.alloc(next_rid, n), theirs.alloc(next_rid, n)
            if want is not None:
                live.append(next_rid)
            next_rid += 1
        elif op == 1:
            rid = live[int(rng.integers(len(live)))]
            got, want = ours.extend(rid), theirs.extend(rid)
        else:
            rid = live.pop(int(rng.integers(len(live))))
            got, want = ours.free(rid), theirs.free(rid)
        ooms += want is None
        assert got == want
        assert _pool_state(ours) == _pool_state(theirs)
        for rid in live:
            assert ours.pages_of(rid) == theirs.pages_of(rid)
    assert ooms > 0  # the run reached exhaustion
    for n in (0, 1, 8, 9, 17):
        assert ours.pages_for_tokens(n) == theirs.pages_for_tokens(n)


def test_paged_cache_specs_match_jax():
    cfg = registry.reduce_config(registry.get("qwen3-8b"))
    jcfg = jax_registry.reduce_config(jax_registry.get("qwen3-8b"))
    ours = registry.paged_cache_specs(cfg, 9, 4)
    theirs = jax_registry.paged_cache_specs(jcfg, 9, 4)["groups"]["slot_0"]["kv"]
    assert len(ours) == cfg.num_layers
    for layer in ours:
        for name in ("k", "v"):
            assert layer["kv"][name].shape == theirs[name].shape[1:]
            assert layer["kv"][name].dtype == torch.float32


# ---------------------------------------------------------------------------
# Paged decode: partials and entry points
# ---------------------------------------------------------------------------

# name: (Hq, Hkv, page_size, n_pages, lengths, num_splits, window, sink)
CASES = {
    "pp1_g1": (4, 4, 8, 8, [64, 0, 37], 8, None, 0),
    "pp2_g4": (8, 2, 8, 8, [5, 64, 0], 4, None, 0),
    "pp4_g4_window_sink": (8, 2, 8, 8, [64, 50, 3], 2, 20, 4),
    "pp4_g1_window": (4, 4, 8, 8, [61, 0, 17], 2, 12, 0),
    "pp3_ragged_last_split": (8, 2, 4, 7, [28, 13, 1], 3, None, 0),
}


def _paged_inputs(Hq, Hkv, ps, n_pages, lengths, seed=0, perm_seed=0):
    """q (B,1,Hq,D); shuffled physical page planes (Hkv,P,ps,D) with the null
    page 0 poisoned (a read of it would show); the block table (B, n_pages)
    with an all-null row for every length-0 slot."""
    rng = np.random.default_rng(seed)
    B = len(lengths)
    q = rng.standard_normal((B, 1, Hq, D), dtype=np.float32)
    kc = rng.standard_normal((B, n_pages * ps, Hkv, D), dtype=np.float32)
    vc = rng.standard_normal((B, n_pages * ps, Hkv, D), dtype=np.float32)
    P = B * n_pages + 1
    table = (np.random.default_rng(perm_seed).permutation(P - 1) + 1).reshape(B, n_pages)
    table = table.astype(np.int32)
    k_pages = np.full((Hkv, P, ps, D), 1e9, np.float32)
    v_pages = np.full((Hkv, P, ps, D), 1e9, np.float32)
    for b in range(B):
        for i in range(n_pages):
            k_pages[:, table[b, i]] = kc[b, i * ps:(i + 1) * ps].transpose(1, 0, 2)
            v_pages[:, table[b, i]] = vc[b, i * ps:(i + 1) * ps].transpose(1, 0, 2)
    table[np.asarray(lengths) == 0] = NULL_PAGE
    return q, k_pages, v_pages, table, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("name", list(CASES))
def test_paged_partials_match_pallas_kernel(name):
    """flash_decode_paged (the plain version on the CPU) against the Pallas
    paged kernel in interpret mode: the same geometry, layout and partials;
    a length-0 row gives (0, -inf) in every split; a second shuffle of the
    physical pages gives bitwise the same partials."""
    Hq, Hkv, ps, n_pages, lengths, ns, window, sink = CASES[name]
    G = Hq // Hkv
    q, kp, vp, table, lens = _paged_inputs(Hq, Hkv, ps, n_pages, lengths)
    B = len(lengths)
    qh = q.reshape(B * Hkv, G, D)  # taken as pre-scaled by both sides
    before = dec_mod.flash_decode_paged_plain.calls
    o_p, lse_p = dec_mod.flash_decode_paged(
        torch.from_numpy(qh), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(lens), torch.from_numpy(table), num_splits=ns, window=window, sink=sink)
    assert dec_mod.flash_decode_paged_plain.calls == before + 1
    o_j, lse_j = jax.jit(functools.partial(
        jax_paged_kernel, num_splits=ns, window=window, sink=sink, interpret=True
    ))(qh, kp, vp, np.repeat(lens, Hkv), table)
    assert o_p.shape == tuple(o_j.shape) and lse_p.shape == tuple(lse_j.shape)
    assert o_p.shape[1] == dec_mod.paged_geometry(n_pages, ns)[0]
    np.testing.assert_allclose(o_p.numpy(), np.asarray(o_j), **KERNEL_TOL)
    np.testing.assert_allclose(lse_p.numpy(), np.asarray(lse_j), **KERNEL_TOL)
    empty = np.repeat(lens == 0, Hkv)
    assert np.all(o_p.numpy()[empty] == 0.0) and np.all(np.isneginf(lse_p.numpy()[empty]))

    q2, kp2, vp2, table2, _ = _paged_inputs(Hq, Hkv, ps, n_pages, lengths, perm_seed=1)
    assert not np.array_equal(table2, table)
    o_s, lse_s = dec_mod.flash_decode_paged_plain(
        torch.from_numpy(q2.reshape(B * Hkv, G, D)), torch.from_numpy(kp2),
        torch.from_numpy(vp2), torch.from_numpy(lens), torch.from_numpy(table2),
        num_splits=ns, window=window, sink=sink)
    assert torch.equal(o_s, o_p) and torch.equal(lse_s, lse_p)


@pytest.mark.parametrize("name", ["pp2_g4", "pp4_g4_window_sink", "pp3_ragged_last_split"])
def test_paged_decode_entry_points_match_jax(name):
    """ops.flash_decode_paged (q pre-scale, kernel, split merge) against
    flash_decode_paged_pallas, and the ``ref`` branch of
    decode_attention_paged (gather + dense oracle) against the JAX gather
    oracle core/decode.flash_decode_paged. A length-0 row merges to exactly
    0 with lse -inf (an all -inf partial is the merge's identity)."""
    Hq, Hkv, ps, n_pages, lengths, ns, window, sink = CASES[name]
    q, kp, vp, table, lens = _paged_inputs(Hq, Hkv, ps, n_pages, lengths, seed=1)
    t = [torch.from_numpy(x) for x in (q, kp, vp, lens, table)]
    o, lse = ops.flash_decode_paged(*t, window=window, sink=sink, num_splits=ns)
    o_j, lse_j = jax.jit(functools.partial(
        flash_decode_paged_pallas, window=window, sink=sink, num_splits=ns, interpret=True
    ))(q, kp, vp, lens, table)
    assert o.shape == (len(lengths), 1, Hq, D) and lse.shape == (len(lengths), Hq, 1)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), **KERNEL_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), **KERNEL_TOL)
    assert np.all(o.numpy()[lens == 0] == 0.0)
    assert np.all(np.isneginf(lse.numpy()[lens == 0]))

    o_ref = decode_attention_paged(*t, AttentionConfig(impl="ref"), window=window, sink=sink)
    o_x, _ = jax_decode_paged_gather(q, kp, vp, lens, table, window=window, sink=sink,
                                     num_splits=ns)
    np.testing.assert_allclose(o_ref.numpy(), np.asarray(o_x), **KERNEL_TOL)
    assert np.all(o_ref.numpy()[lens == 0] == 0.0)


def test_paged_decode_is_forward_only():
    q, kp, vp, table, lens = _paged_inputs(4, 4, 8, 2, [5])
    qt = torch.from_numpy(q).requires_grad_()
    with pytest.raises(NotImplementedError, match="forward-only"):
        ops.flash_decode_paged(qt, torch.from_numpy(kp), torch.from_numpy(vp),
                               torch.from_numpy(lens), torch.from_numpy(table))


# ---------------------------------------------------------------------------
# The LM and the engine, on the same weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[None, 2], ids=["g1", "g2"])
def models(request):
    kv = request.param
    jcfg = jax_registry.reduce_config(jax_registry.get("qwen3-8b"))
    cfg = registry.reduce_config(registry.get("qwen3-8b"))
    if kv is not None:
        jcfg = dataclasses.replace(jcfg, num_kv_heads=kv)
        cfg = dataclasses.replace(cfg, num_kv_heads=kv)
    jparams = jax_lm.init_lm(jcfg, jax.random.PRNGKey(0))
    model = LM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jparams)))
    return jcfg, jparams, cfg, model


def _jax_layers(jcfg, caches):
    """Per-layer {"k", "v"} numpy planes of the JAX package's cache tree, in
    the port's layer order."""
    layers = []
    groups = caches.get("groups")
    for g in range(jcfg.num_groups):
        for u in range(len(jcfg.layer_pattern)):
            if isinstance(groups, (list, tuple)):
                kv = groups[g][f"slot_{u}"]["kv"]
            else:
                kv = {n: x[g] for n, x in groups[f"slot_{u}"]["kv"].items()}
            layers.append(kv)
    layers.extend(t["kv"] for t in caches.get("tail", []))
    return [{n: np.asarray(x) for n, x in kv.items()} for kv in layers]


def _assert_planes_match(jcfg, jcaches, caches):
    """Every page but the null page: width-padding rows and pages past a
    prompt all write page 0 in one scatter, in an order neither package
    fixes, and no decode reads it."""
    theirs = _jax_layers(jcfg, jcaches)
    assert len(theirs) == len(caches)
    for want, got in zip(theirs, caches):
        for name in ("k", "v"):
            np.testing.assert_allclose(got["kv"][name][:, 1:].numpy(), want[name][:, 1:],
                                       **MODEL_TOL)


def test_paged_admission_and_decode_step_match_jax(models, jax_trace_state):
    """One W = 4 admission (three prompts of one bucket and a width-padding
    row) into shuffled pages, then three decode steps through the block
    table with an inactive slot: tokens, lengths, logits and page planes."""
    jcfg, jparams, cfg, model = models
    ps, P, pad_to, n_pages = 4, 16, 16, 6
    rng = np.random.default_rng(7)
    lens = np.asarray([5, 9, 13, 1], np.int32)  # row 3 pads the width
    inputs = np.zeros((4, pad_to), np.int32)
    for i in range(3):
        inputs[i, :lens[i]] = rng.integers(1, cfg.vocab_size, lens[i])
    phys = list(rng.permutation(P - 1) + 1)
    table = np.zeros((4, n_pages), np.int32)
    dest = np.zeros((4, pad_to // ps), np.int32)
    for i in range(3):
        need = int(lens[i]) // ps + 1
        table[i, :need] = [phys.pop() for _ in range(need)]
        dest[i, :need] = table[i, :need]

    jspec = jax_registry.paged_cache_specs(jcfg, P, ps)
    jcaches = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), jspec)
    jadmit = jax.jit(jax_build_paged_admit_step(jcfg, JAX_ATTN, ps))
    tok_j, lens_j, jcaches = jadmit(jparams, {"inputs": inputs, "lens": lens}, jcaches, dest)
    caches = [{"kv": {n: torch.zeros(s.shape, dtype=s.dtype) for n, s in layer["kv"].items()}}
              for layer in registry.paged_cache_specs(cfg, P, ps)]
    tok, lens_t, caches = build_paged_admit_step(cfg, ATTN, ps)(
        model, {"inputs": torch.from_numpy(inputs).long(), "lens": torch.from_numpy(lens)},
        caches, torch.from_numpy(dest))
    assert tok.numpy().tolist() == np.asarray(tok_j).tolist()
    assert lens_t.numpy().tolist() == np.asarray(lens_j).tolist() == lens.tolist()
    _assert_planes_match(jcfg, jcaches, caches)

    jstep = jax.jit(lambda p, t, c, n, tb: jax_lm.decode_step(jcfg, p, t, c, n, JAX_ATTN,
                                                              block_table=tb))
    cache_len = np.where(np.arange(4) < 3, lens, 0).astype(np.int32)
    token = np.array(tok_j, np.int32)
    table[3] = NULL_PAGE
    for _ in range(3):
        logits_j, jcaches = jstep(jparams, token, jcaches, cache_len, table)
        logits, caches = model.decode_step(torch.from_numpy(token).long(), caches,
                                           torch.from_numpy(cache_len), ATTN,
                                           block_table=torch.from_numpy(table))
        np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), **MODEL_TOL)
        _assert_planes_match(jcfg, jcaches, caches)
        token = np.array(jnp.argmax(logits_j[..., :cfg.vocab_size], -1), np.int32)
        cache_len = np.where(cache_len > 0, cache_len + 1, 0).astype(np.int32)


def _engine_state(eng):
    return dict(
        table=eng.table.tolist(), cache_len=eng.cache_len.tolist(),
        next_token=eng.next_token.tolist(), ticks=eng.ticks, preemptions=eng.preemptions,
        slots=[s.rid if s is not None else None for s in eng.slots],
        queue=[r.rid for r in eng.queue], finished=sorted(eng.finished),
        pool=_pool_state(eng.pool), resident=eng.resident_tokens(),
        cells=eng.active_kv_cells(), capacity=eng.kv_capacity(),
    )


# name: (prompt lengths, max_new, engine keyword arguments). "preempt" is the
# JAX package's own preemption case (tests/test_paged.py): four same-bucket
# prompts admitted in one W = 4 prefill into a pool too small for their
# growth. "join_leave" trickles five prompts of two buckets through two slots.
ENGINE_CASES = {
    "preempt": ((6, 6, 6, 6), 24, dict(max_batch=4, num_pages=14, page_size=4,
                                       pages_per_seq_max=8, prompt_pad=16)),
    "join_leave": ((3, 19, 11, 7, 15), 6, dict(max_batch=2, num_pages=17, page_size=8,
                                               pages_per_seq_max=8, prompt_pad=16)),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_paged_engine_matches_jax(models, jax_trace_state, case):
    """The port's PagedServingEngine and the JAX package's, tick by tick:
    block tables, lengths, next tokens, slots, queue, pool state (free-list
    order included), preemptions; the page planes after the first tick and
    at the end; identical greedy token streams."""
    jcfg, jparams, cfg, model = models
    lengths, max_new, kw = ENGINE_CASES[case]
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 100, n).tolist() for n in lengths]
    jeng = JaxPagedServingEngine(jcfg, jparams, JAX_ENGINE_ATTN, **kw)
    eng = PagedServingEngine(cfg, model, ATTN, **kw)
    for rid, prompt in enumerate(prompts):
        jeng.submit(JaxRequest(rid=rid, prompt=list(prompt), max_new_tokens=max_new))
        eng.submit(Request(rid=rid, prompt=list(prompt), max_new_tokens=max_new))
    widths = []
    while jeng.queue or any(s is not None for s in jeng.slots):
        queued = len(eng.queue)
        jeng.tick()
        eng.tick()
        widths.append(queued - len(eng.queue))
        assert _engine_state(eng) == _engine_state(jeng), eng.ticks
        if eng.ticks == 1:
            _assert_planes_match(jcfg, jeng.caches, eng.caches)
        assert eng.ticks < 300
    _assert_planes_match(jcfg, jeng.caches, eng.caches)
    assert sorted(eng.finished) == list(range(len(prompts)))
    for rid, req in jeng.finished.items():
        assert eng.finished[rid].generated == req.generated, rid
    assert eng.pool.used_pages == 0
    if case == "preempt":
        assert eng.preemptions > 0 and widths[0] == 4  # one W = 4 admission
