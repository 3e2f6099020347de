"""Head dim 160 (stablelm-12b's) on the port against the JAX package on the
CPU: the forward, decode and paged decode (the port's plain versions, which
the CUDA kernels are held to on the card) against the Pallas kernels in
interpret mode on the same numpy inputs, then reduced stablelm-12b with its
head_dim put back to 160 (2 layers, qk-norm, untied embeddings, four q heads
over one kv head) against the JAX LM, and the port's two serving engines
against each other on it."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.core.attention import AttentionConfig as JaxAttentionConfig
from repro.core.masks import MaskSpec as JaxMaskSpec
from repro.distributed import sharding as jax_sharding
from repro.kernels.flash_decode import flash_decode_kernel as jax_decode_kernel
from repro.kernels.flash_decode import flash_decode_paged_kernel as jax_paged_kernel
from repro.kernels.ops import flash_attention_pallas_with_lse
from repro.models import lm as jax_lm
from repro_torch.configs import registry
from repro_torch.core.attention import AttentionConfig
from repro_torch.core.masks import MaskSpec
from repro_torch.kernels import flash_decode as dec_mod
from repro_torch.kernels import ops
from repro_torch.models.lm import LM, params_from_jax
from repro_torch.serving.engine import PagedServingEngine, Request, ServingEngine

D = 160
TOL = dict(atol=2e-5, rtol=2e-5)  # f32 on both sides: summation order and tiling only
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)  # f32 logits of a 2-layer model
BLOCK = 32

# name: (B, S, Hq, Hkv, spec): stablelm's grouping (G 4, here over one kv
# head), causal with a ragged last tile, a window with sinks, and G 1
# without a mask.
FWD_CASES = {
    "causal_g4": (1, 80, 4, 1, dict(causal=True)),
    "window_sink_g4": (2, 96, 4, 1, dict(causal=True, window=24, sink=4)),
    "full_g1": (1, 64, 2, 2, dict(causal=False)),
}


def _randn(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


@pytest.mark.parametrize("name", list(FWD_CASES))
def test_forward_at_head_dim_160_matches_pallas(name):
    B, S, Hq, Hkv, spec = FWD_CASES[name]
    rng = np.random.default_rng(0)
    q, k, v = _randn(rng, B, S, Hq, D), _randn(rng, B, S, Hkv, D), _randn(rng, B, S, Hkv, D)
    o, lse = ops.flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), MaskSpec(**spec),
        block_q=BLOCK, block_kv=BLOCK)
    o_j, lse_j = flash_attention_pallas_with_lse(
        q, k, v, JaxMaskSpec(**spec), block_q=BLOCK, block_kv=BLOCK, interpret=True,
        use_tuned=False)
    assert o.shape == (B, S, Hq, D) and lse.shape == (B, Hq, S)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), **TOL)


# name: (S, Hkv, G, lengths, num_splits, window, sink): stablelm's decode
# grouping (G 4), lengths 0 and 1, a window with sinks, the cache's full
# length, and G 1.
DECODE_CASES = {
    "ragged_g4": (64, 1, 4, [0, 1, 37, 64], 8, None, 0),
    "window_sink_g4": (96, 1, 4, [96, 50, 3], 4, 20, 4),
    "ragged_g1": (48, 2, 1, [48, 0, 17, 1], 3, None, 0),
}


@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_decode_partials_at_head_dim_160_match_pallas_kernel(name):
    S, Hkv, G, lengths, ns, window, sink = DECODE_CASES[name]
    B = len(lengths)
    rng = np.random.default_rng(1)
    qh = _randn(rng, B * Hkv, G, D)  # pre-scaled: both sides take it as is
    k, v = _randn(rng, B, S, Hkv, D), _randn(rng, B, S, Hkv, D)
    lens = np.asarray(lengths, np.int32)
    o, lse = dec_mod.flash_decode(torch.from_numpy(qh), torch.from_numpy(k), torch.from_numpy(v),
                                  torch.from_numpy(lens), num_splits=ns, window=window, sink=sink)
    heads = lambda x: x.transpose(0, 2, 1, 3).reshape(B * Hkv, S, D)
    o_j, lse_j = jax.jit(functools.partial(
        jax_decode_kernel, num_splits=ns, window=window, sink=sink, interpret=True
    ))(qh, heads(k), heads(v), np.repeat(lens, Hkv))
    assert o.shape == tuple(o_j.shape) and lse.shape == tuple(lse_j.shape)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), **TOL)


# name: (page size, n_pages, Hkv, G, lengths, num_splits, window, sink).
PAGED_CASES = {
    "ps16_g4": (16, 6, 1, 4, [96, 0, 37, 1], 3, None, 0),
    "ps8_g4_window_sink": (8, 8, 1, 4, [64, 50, 3], 4, 20, 4),
    "ps4_g1_ragged_last_split": (4, 7, 2, 1, [28, 13, 1], 3, None, 0),
}


@pytest.mark.parametrize("name", list(PAGED_CASES))
def test_paged_partials_at_head_dim_160_match_pallas_kernel(name):
    ps, n_pages, Hkv, G, lengths, ns, window, sink = PAGED_CASES[name]
    B = len(lengths)
    rng = np.random.default_rng(2)
    qh = _randn(rng, B * Hkv, G, D)
    P = B * n_pages + 1
    table = (rng.permutation(P - 1) + 1).reshape(B, n_pages).astype(np.int32)
    # Every page a row does not name, the null page 0 included, is poisoned.
    kp = np.full((Hkv, P, ps, D), 1e9, np.float32)
    vp = np.full((Hkv, P, ps, D), 1e9, np.float32)
    kp[:, table] = _randn(rng, Hkv, B, n_pages, ps, D)
    vp[:, table] = _randn(rng, Hkv, B, n_pages, ps, D)
    lens = np.asarray(lengths, np.int32)
    table[lens == 0] = 0
    o, lse = dec_mod.flash_decode_paged(
        torch.from_numpy(qh), torch.from_numpy(kp), torch.from_numpy(vp), torch.from_numpy(lens),
        torch.from_numpy(table), num_splits=ns, window=window, sink=sink)
    o_j, lse_j = jax.jit(functools.partial(
        jax_paged_kernel, num_splits=ns, window=window, sink=sink, interpret=True
    ))(qh, kp, vp, np.repeat(lens, Hkv), table)
    assert o.shape == tuple(o_j.shape) and lse.shape == tuple(lse_j.shape)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), **TOL)


# ---------------------------------------------------------------------------
# stablelm-12b at head_dim 160, reduced otherwise
# ---------------------------------------------------------------------------

CACHE, L = 64, 45


def _stablelm_160(reg):
    """Reduced stablelm-12b with head_dim 160 and stablelm's grouping (four
    q heads over one kv head); 2 layers, qk-norm, untied embeddings."""
    cfg = reg.reduce_config(reg.get("stablelm-12b"))
    return dataclasses.replace(cfg, head_dim=160, num_kv_heads=1)


@pytest.fixture(scope="module")
def stablelm():
    """The JAX LM's prefill and two decode steps on its Pallas kernels,
    computed once. jax 0.9 removed ``jax.core.trace_state_clean``, which the
    JAX package calls in every attention layer: alias it only while this
    fixture runs (never process-wide), and restore the trace-mode records it
    lets the package make."""
    jcfg = _stablelm_160(jax_registry)
    jparams = jax_lm.init_lm(jcfg, jax.random.PRNGKey(3))
    jattn = JaxAttentionConfig(impl="flash_pallas", decode_splits=8, use_tuned=False)
    tokens = np.random.default_rng(3).integers(1, jcfg.vocab_size, (1, L)).astype(np.int32)
    saved = set(jax_sharding._traced_modes)
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.core, "trace_state_clean"):
            mp.setattr(jax.core, "trace_state_clean", jax._src.core.trace_state_clean,
                       raising=False)
        h, caches, _ = jax.jit(lambda p, t: jax_lm.prefill(jcfg, p, t, jattn, CACHE))(
            jparams, tokens)
        logits = [np.asarray(jax_lm.logits_from_hidden(jcfg, jparams, h))]
        step = jax.jit(lambda p, t, c, n: jax_lm.decode_step(jcfg, p, t, c, n, jattn))
        fed = []
        for i in range(2):
            tok = np.array(jnp.argmax(logits[-1][..., : jcfg.vocab_size], -1), np.int32)
            out, caches = step(jparams, tok, caches, np.asarray([L + i], np.int32))
            fed.append(tok)
            logits.append(np.asarray(out))
    jax_sharding._traced_modes.clear()
    jax_sharding._traced_modes.update(saved)
    return jax.tree.map(np.asarray, jparams), tokens, fed, logits


def _model(params):
    cfg = _stablelm_160(registry)
    assert (cfg.head_dim, cfg.num_heads, cfg.num_kv_heads, cfg.num_layers) == (160, 4, 1, 2)
    assert cfg.qk_norm and not cfg.tie_embeddings
    model = LM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(cfg, params))
    return cfg, model


@pytest.mark.parametrize("impl", ["flash_cuda", "ref"])
def test_stablelm_at_head_dim_160_matches_jax(stablelm, impl):
    params, tokens, fed, want = stablelm
    _, model = _model(params)
    attn = AttentionConfig(impl=impl)
    h, caches, _ = model.prefill(torch.from_numpy(tokens).long(), attn, CACHE)
    np.testing.assert_allclose(model.logits_from_hidden(h).numpy(), want[0], **MODEL_TOL)
    for i, tok in enumerate(fed):
        logits, caches = model.decode_step(torch.from_numpy(tok).long(), caches,
                                           torch.tensor([L + i], dtype=torch.int32), attn)
        np.testing.assert_allclose(logits.numpy(), want[i + 1], **MODEL_TOL)


def test_stablelm_at_head_dim_160_fixed_and_paged_engines_agree(stablelm):
    """The same requests through the fixed-slot and the paged engine on the
    kernels' plain versions: the same greedy tokens. The pool is small
    enough that admission waits for pages."""
    cfg, model = _model(stablelm[0])
    attn = AttentionConfig(impl="flash_cuda")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (40, 7, 33, 50)]
    engines = (ServingEngine(cfg, model, attn, max_batch=2, cache_size=CACHE, prompt_pad=16),
               PagedServingEngine(cfg, model, attn, max_batch=2, num_pages=12, page_size=8,
                                  pages_per_seq_max=8, prompt_pad=16))
    out = []
    for engine in engines:
        for rid, prompt in enumerate(prompts):
            engine.submit(Request(rid=rid, prompt=list(prompt), max_new_tokens=6))
        finished = engine.run(max_ticks=100)
        assert sorted(finished) == list(range(len(prompts)))
        out.append({rid: req.generated for rid, req in finished.items()})
    assert all(len(g) == 7 for g in out[0].values())
    assert out[0] == out[1]
