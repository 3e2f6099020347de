"""The serving slice as a whole: the port's LM and fixed-slot engine against
the JAX package's, on the same weights (``init_lm`` -> numpy ->
``params_from_jax``), with the JAX side on its Pallas kernels in interpret
mode. Reduced qwen3-8b as the registry shrinks it (G = 1) and with two kv
heads (G = 2), so the kv-head indexing h // G is exercised."""

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
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.configs import registry
from repro_torch.core.attention import AttentionConfig
from repro_torch.models.lm import LM, params_from_jax
from repro_torch.serving.engine import Request, ServingEngine

# f32 logits of a 2-layer model; differences are summation order only.
TOL = dict(atol=1e-4, rtol=1e-4)
JAX_ATTN = JaxAttentionConfig(impl="flash_pallas", decode_splits=8, use_tuned=False)
ATTN = AttentionConfig(impl="flash_cuda")
PROMPTS = [[5, 7, 9], list(range(1, 10)), list(range(3, 20)), [11, 2, 8, 4, 1], list(range(40, 70))]


@pytest.fixture
def jax_trace_state(monkeypatch):
    """jax 0.9 removed ``jax.core.trace_state_clean``, which the JAX package's
    context-parallel check calls on every attention layer. Alias it for this
    test only (never process-wide: other tests in the worker must see the
    JAX package as it is). The trace-time mode records that the alias lets
    the JAX package make are restored afterwards for the same reason."""
    if not hasattr(jax.core, "trace_state_clean"):
        monkeypatch.setattr(jax.core, "trace_state_clean",
                            jax._src.core.trace_state_clean, raising=False)
    saved = set(jax_sharding._traced_modes)
    yield
    jax_sharding._traced_modes.clear()
    jax_sharding._traced_modes.update(saved)


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


def test_prefill_and_decode_logits_match(models, jax_trace_state):
    jcfg, jparams, cfg, model = models
    cache, L, bucket = 64, 21, 32
    tokens = np.zeros((1, bucket), np.int32)
    tokens[0, :L] = np.random.default_rng(0).integers(1, cfg.vocab_size, L)

    jprefill = jax.jit(lambda p, t, n: jax_lm.prefill(jcfg, p, t, JAX_ATTN, cache, lens=n))
    jstep = jax.jit(lambda p, t, c, n: jax_lm.decode_step(jcfg, p, t, c, n, JAX_ATTN))
    h_j, caches_j, lens_j = jprefill(jparams, tokens, jnp.asarray([L], jnp.int32))
    logits_j = jax_lm.logits_from_hidden(jcfg, jparams, h_j)

    h, caches, lens = model.prefill(torch.from_numpy(tokens).long(), ATTN, cache,
                                    lens=torch.tensor([L], dtype=torch.int32))
    logits = model.logits_from_hidden(h)
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), **TOL)
    assert lens.tolist() == np.asarray(lens_j).tolist() == [L]

    tok = np.array(jnp.argmax(logits_j[..., : cfg.vocab_size], -1), np.int32)
    cache_len = np.asarray([L], np.int32)
    for _ in range(3):
        logits_j, caches_j = jstep(jparams, tok, caches_j, cache_len)
        logits, caches = model.decode_step(torch.from_numpy(tok).long(), caches,
                                           torch.from_numpy(cache_len), ATTN)
        np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), **TOL)
        tok = np.array(jnp.argmax(logits_j[..., : cfg.vocab_size], -1), np.int32)
        cache_len = cache_len + 1


def test_engine_token_streams_match(models, jax_trace_state):
    """More requests than slots (slots are reused), bucketed admission:
    every request's greedy token stream is identical."""
    jcfg, jparams, cfg, model = models
    jeng = JaxServingEngine(jcfg, jparams, JAX_ATTN, max_batch=2, cache_size=64,
                            prompt_pad=16)
    eng = ServingEngine(cfg, model, ATTN, max_batch=2, cache_size=64, prompt_pad=16)
    for rid, prompt in enumerate(PROMPTS):
        jeng.submit(JaxRequest(rid=rid, prompt=list(prompt), max_new_tokens=5))
        eng.submit(Request(rid=rid, prompt=list(prompt), max_new_tokens=5))
    want = jeng.run(max_ticks=100)
    got = eng.run(max_ticks=100)
    assert sorted(got) == sorted(want) == list(range(len(PROMPTS)))
    for rid in want:
        assert got[rid].generated == want[rid].generated, rid
        assert len(got[rid].generated) == 6
    assert eng.ticks == jeng.ticks
