"""The port's LM on a config with sliding-window layers: reduced gemma3-1b
(5 local : 1 global layers, window 32, tied embeddings, embeddings scaled
by sqrt(d), a separate RoPE base for local layers) against the JAX LM on
its Pallas kernels, same weights, prompts longer than the window."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.core.attention import AttentionConfig as JaxAttentionConfig
from repro.distributed import sharding as jax_sharding
from repro.models import lm as jax_lm
from repro_torch.configs import registry
from repro_torch.core.attention import AttentionConfig
from repro_torch.models.lm import LM, params_from_jax

TOL = dict(atol=1e-4, rtol=1e-4)  # f32 logits; summation order only
CACHE, L = 64, 45  # prompt longer than the window


@pytest.fixture(scope="module")
def gemma3():
    """The JAX LM's prefill and two decode steps, computed once. jax 0.9
    removed ``jax.core.trace_state_clean``, which the JAX package calls in
    every attention layer: alias it only while this fixture runs (never
    process-wide), and restore the trace-mode records it lets the package
    make, as in test_torch_serving.py."""
    jcfg = jax_registry.reduce_config(jax_registry.get("gemma3-1b"))
    jparams = jax_lm.init_lm(jcfg, jax.random.PRNGKey(1))
    jattn = JaxAttentionConfig(impl="flash_pallas", decode_splits=8, use_tuned=False)
    tokens = np.random.default_rng(1).integers(1, jcfg.vocab_size, (1, L)).astype(np.int32)
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


@pytest.mark.parametrize("impl", ["flash_cuda", "ref"])
def test_windowed_lm_matches_jax(gemma3, impl):
    params, tokens, fed, want = gemma3
    cfg = registry.reduce_config(registry.get("gemma3-1b"))
    assert cfg.window == 32 < L and "attn_local" in cfg.layer_pattern and cfg.tie_embeddings
    model = LM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(cfg, params))
    attn = AttentionConfig(impl=impl)
    h, caches, _ = model.prefill(torch.from_numpy(tokens).long(), attn, CACHE)
    np.testing.assert_allclose(model.logits_from_hidden(h).numpy(), want[0], **TOL)
    for i, tok in enumerate(fed):
        logits, caches = model.decode_step(torch.from_numpy(tok).long(), caches,
                                           torch.tensor([L + i], dtype=torch.int32), attn)
        np.testing.assert_allclose(logits.numpy(), want[i + 1], **TOL)
