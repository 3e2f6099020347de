"""The granite-moe-1b-a400m serving slice on the CPU: the port's LM with its
MoE layers, and both port engines, against the JAX package on the same
weights (``init_lm`` -> numpy -> ``params_from_jax``).

Reduced granite as the registry shrinks it (2 layers, 8 experts top 2,
d_model 64), with granite's grouping of two q heads a kv head (16 over 8
at full width). The JAX LM runs its Pallas kernels in interpret mode; its
engines take the XLA attention paths (as the JAX package's own engine
tests do), to keep compiles few. The engines are held at a capacity factor
of 0.5: a prefill of T tokens then keeps at most max(4, T / 8) of its T k
assignments an expert, and a decode call of 8 slots 4, so that padding
and the tokens of empty slots compete with real tokens, as they do in the
JAX engines."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.core.attention import AttentionConfig as JaxAttentionConfig
from repro.distributed import sharding as jax_sharding
from repro.models import lm as jax_lm
from repro.serving.engine import PagedServingEngine as JaxPagedServingEngine
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.configs import registry
from repro_torch.core.attention import AttentionConfig
from repro_torch.models import moe
from repro_torch.models.lm import LM, init_lm, params_from_jax
from repro_torch.serving.engine import PagedServingEngine, Request, ServingEngine

# f32 on both sides, summation order only: the hidden states and aux of a
# 2-layer model, and its logits (larger: the tied unembedding sums d_model
# products of O(1) values).
HIDDEN_RTOL = 1e-5
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
JAX_ATTN = JaxAttentionConfig(impl="flash_pallas", decode_splits=8, use_tuned=False)
JAX_ENGINE_ATTN = JaxAttentionConfig(impl="flash_xla", decode_splits=8, use_tuned=False)
ATTN = AttentionConfig(impl="flash_cuda")
ARCH = "granite-moe-1b-a400m"


def _granite(reg, capacity_factor=None):
    cfg = dataclasses.replace(reg.reduce_config(reg.get(ARCH)), num_kv_heads=2)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    return cfg


def _models(capacity_factor=None, seed=0):
    jcfg = _granite(jax_registry, capacity_factor)
    cfg = _granite(registry, capacity_factor)
    jparams = jax_lm.init_lm(jcfg, jax.random.PRNGKey(seed))
    model = LM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jparams)))
    return jcfg, jparams, cfg, model


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


@pytest.fixture(scope="module")
def models():
    return _models()


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def test_granite_weights_carry_over(models):
    """``params_from_jax`` carries each MoE layer's router (float32),
    we_gate, we_up and we_down; the port's own init draws the same shapes
    and dtypes, the router float32 in a bfloat16 model."""
    _, jparams, cfg, model = models
    sd = model.state_dict()
    for name in ("router", "we_gate", "we_up", "we_down"):
        got = sd[f"layers.1.mlp.{name}"].numpy()
        want = np.asarray(jparams["groups"]["slot_0"]["mlp"][name][1])
        assert got.shape == want.shape and (got == want).all()
    bf = dataclasses.replace(cfg, dtype="bfloat16")
    ours = init_lm(bf, seed=0, device="cpu")
    assert ours.layers[0].mlp.router.dtype == torch.float32
    assert ours.layers[0].mlp.we_gate.dtype == torch.bfloat16
    assert {k: v.shape for k, v in ours.state_dict().items()} == {k: v.shape for k, v in sd.items()}


@pytest.mark.parametrize("impl", ["flash_cuda", "ref"])
def test_granite_forward_and_aux_match_jax(models, jax_trace_state, impl):
    """``LM.forward`` (training's path: remat groups, grad enabled) against
    the JAX ``lm.forward``: the hidden states and the aux loss summed over
    the MoE layers, at 1e-5 relative."""
    jcfg, jparams, cfg, model = models
    tokens = np.random.default_rng(1).integers(1, cfg.vocab_size, (2, 32)).astype(np.int32)
    h_j, aux_j, _ = jax.jit(lambda p, t: jax_lm.forward(jcfg, p, t, JAX_ATTN))(jparams, tokens)
    h, aux, n_prefix = model(torch.from_numpy(tokens).long(), AttentionConfig(impl=impl))
    assert n_prefix == 0 and aux.requires_grad
    assert _rel(h.detach().numpy(), h_j) <= HIDDEN_RTOL
    assert float(aux_j) > 0 and _rel(aux.item(), float(aux_j)) <= HIDDEN_RTOL


def test_granite_prefill_and_decode_logits_match_jax(models, jax_trace_state):
    """A bucket-padded B = 2 prefill (the second row ragged), then three
    decode steps, logits at 1e-4."""
    jcfg, jparams, cfg, model = models
    cache, bucket = 64, 32
    lens = np.array([21, 32], np.int32)
    tokens = np.zeros((2, bucket), np.int32)
    rng = np.random.default_rng(2)
    for b, n in enumerate(lens):
        tokens[b, :n] = rng.integers(1, cfg.vocab_size, n)
    h_j, caches_j, lens_j = jax.jit(
        lambda p, t, n: jax_lm.prefill(jcfg, p, t, JAX_ATTN, cache, lens=n))(
            jparams, tokens, jnp.asarray(lens))
    logits_j = jax_lm.logits_from_hidden(jcfg, jparams, h_j)
    h, caches, lens_t = model.prefill(torch.from_numpy(tokens).long(), ATTN, cache,
                                      lens=torch.from_numpy(lens))
    np.testing.assert_allclose(model.logits_from_hidden(h).numpy(), np.asarray(logits_j),
                               **LOGIT_TOL)
    assert lens_t.tolist() == np.asarray(lens_j).tolist() == lens.tolist()
    step = jax.jit(lambda p, t, c, n: jax_lm.decode_step(jcfg, p, t, c, n, JAX_ATTN))
    tok = np.array(jnp.argmax(logits_j[..., : cfg.vocab_size], -1), np.int32)
    cache_len = lens.copy()
    for _ in range(3):
        logits_j, caches_j = step(jparams, tok, caches_j, cache_len)
        logits, caches = model.decode_step(torch.from_numpy(tok).long(), caches,
                                           torch.from_numpy(cache_len), ATTN)
        np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), **LOGIT_TOL)
        tok = np.array(jnp.argmax(logits_j[..., : cfg.vocab_size], -1), np.int32)
        cache_len = cache_len + 1


def test_empty_slots_displace_real_tokens_in_a_decode_call(jax_trace_state):
    """A decode call of 8 slots (capacity 4 an expert), the first 4 empty and
    the last 4 live: the empty slots' token (one token in all four, so
    that their four rows fill the capacity of the same two experts) comes
    first in each expert's order and changes the live rows' logits; the
    port follows the JAX decode step for each choice."""
    jcfg, jparams, cfg, model = _models(capacity_factor=0.5, seed=1)
    cache = 32
    rng = np.random.default_rng(4)
    tokens = rng.integers(1, cfg.vocab_size, (8, 16)).astype(np.int32)
    _, caches_j, _ = jax.jit(lambda p, t: jax_lm.prefill(jcfg, p, t, JAX_ATTN, cache))(
        jparams, tokens)
    _, caches, _ = model.prefill(torch.from_numpy(tokens).long(), ATTN, cache)
    step = jax.jit(lambda p, t, c, n: jax_lm.decode_step(jcfg, p, t, c, n, JAX_ATTN))
    cache_len = np.array([0, 0, 0, 0, 16, 16, 16, 16], np.int32)
    live = []
    for fill in (1, 2, 3, 4):
        tok = np.concatenate([np.full((4, 1), fill), tokens[4:, -1:]]).astype(np.int32)
        logits_j, _ = step(jparams, tok, caches_j, cache_len)
        c = [{"kv": {k: t.clone() for k, t in layer["kv"].items()}} for layer in caches]
        logits, _ = model.decode_step(torch.from_numpy(tok).long(), c,
                                      torch.from_numpy(cache_len), ATTN)
        np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), **LOGIT_TOL)
        live.append(logits[4:].numpy())
    assert any(not np.allclose(live[0], other) for other in live[1:])


PROMPT_LENS = (3, 19, 11, 7, 15, 30, 5)


def _prompts(cfg):
    rng = np.random.default_rng(5)
    return [rng.integers(1, cfg.vocab_size, n).tolist() for n in PROMPT_LENS]


def _run_both(jeng, eng, prompts, max_new):
    for rid, prompt in enumerate(prompts):
        jeng.submit(JaxRequest(rid=rid, prompt=list(prompt), max_new_tokens=max_new))
        eng.submit(Request(rid=rid, prompt=list(prompt), max_new_tokens=max_new))
    want = jeng.run(max_ticks=200)
    got = eng.run(max_ticks=200)
    assert sorted(got) == sorted(want) == list(range(len(prompts)))
    for rid in want:
        assert got[rid].generated == want[rid].generated, rid
        assert len(got[rid].generated) == max_new + 1
    assert eng.ticks == jeng.ticks


@pytest.fixture(scope="module")
def tight_models():
    return _models(capacity_factor=0.5, seed=2)


@pytest.fixture
def drops(monkeypatch):
    """Counts the assignments the port's MoE calls drop (a list of one
    int), so that a test can show that capacity bit in its run."""
    seen = [0]
    dispatch = moe.dispatch_indices

    def counted(*args, **kw):
        out = dispatch(*args, **kw)
        seen[0] += int((~out[2]).sum())
        return out

    monkeypatch.setattr(moe, "dispatch_indices", counted)
    return seen


@pytest.mark.parametrize("max_batch", [4, 8])
def test_fixed_engine_matches_jax(tight_models, jax_trace_state, drops, max_batch):
    """The fixed-slot engines over seven prompts of two buckets: slots are
    reused (at 4), or stay empty and feed the decode calls their dummy
    tokens (at 8). Identical greedy token streams; the run drops
    assignments."""
    jcfg, jparams, cfg, model = tight_models
    jeng = JaxServingEngine(jcfg, jparams, JAX_ENGINE_ATTN, max_batch=max_batch,
                            cache_size=64, prompt_pad=16)
    eng = ServingEngine(cfg, model, ATTN, max_batch=max_batch, cache_size=64, prompt_pad=16)
    _run_both(jeng, eng, _prompts(cfg), max_new=6)
    assert drops[0] > 0


@pytest.mark.parametrize("max_batch", [4, 8])
def test_paged_engine_matches_jax(tight_models, jax_trace_state, drops, max_batch):
    """The paged engines over the same prompts: same-bucket prompts prefill
    together (one row's padding ahead of the next row's real tokens in one
    MoE call, dummy rows up to a power of two), lengths, tables, slots and
    preemptions tick by tick, and identical greedy token streams; the run
    drops assignments."""
    jcfg, jparams, cfg, model = tight_models
    kw = dict(max_batch=max_batch, num_pages=40, page_size=8, pages_per_seq_max=8,
              prompt_pad=16)
    jeng = JaxPagedServingEngine(jcfg, jparams, JAX_ENGINE_ATTN, **kw)
    eng = PagedServingEngine(cfg, model, ATTN, **kw)
    prompts = _prompts(cfg)
    for rid, prompt in enumerate(prompts):
        jeng.submit(JaxRequest(rid=rid, prompt=list(prompt), max_new_tokens=6))
        eng.submit(Request(rid=rid, prompt=list(prompt), max_new_tokens=6))
    while jeng.queue or any(s is not None for s in jeng.slots):
        jeng.tick()
        eng.tick()
        assert (eng.table == jeng.table).all() and (eng.cache_len == jeng.cache_len).all()
        assert (eng.next_token == jeng.next_token).all(), eng.ticks
        assert [s and s.rid for s in eng.slots] == [s and s.rid for s in jeng.slots]
        assert eng.ticks < 200
    assert eng.preemptions == jeng.preemptions
    assert sorted(eng.finished) == list(range(len(prompts)))
    for rid, req in jeng.finished.items():
        assert eng.finished[rid].generated == req.generated, rid
    assert eng.pool.used_pages == 0
    assert drops[0] > 0
