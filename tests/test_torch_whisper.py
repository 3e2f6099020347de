"""The whisper serving slice as a whole, and its layers: the port's Whisper
against the JAX package's on the same weights (``init_whisper`` -> numpy ->
``params_from_jax``) and the same numpy inputs, the JAX side on its Pallas
kernels in interpret mode. Reduced whisper-base in f32 as the registry
shrinks it (2 encoder and 2 decoder layers, d_model 64, 4 heads of 16).
JAX's initialiser sets every bias to 0 and every norm to (1, 0); the slice
tests add seeded noise to those leaves on both sides, so the bias and norm
paths carry weight.

The frames are 320 a row and the prompt 4 tokens: at the port's 64-row
tiles the prefill's cross-attention is one q tile against 5 kv tiles,
which the port's auto policy splits 5 ways, while the JAX default (512-row
tiles, one kv tile) does not split; the two agree to rounding, not bit for
bit. The ``split3`` runs force 3 splits on both sides (JAX at 64-row
tiles), which gives the same kv ranges."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.core.attention import AttentionConfig as JaxAttentionConfig
from repro.core.masks import MaskSpec as JaxMaskSpec
from repro.launch import steps as jax_steps
from repro.models import attention_layer as jax_attn_layer
from repro.models import layers as jax_layers
from repro.models import whisper as jax_whisper
from repro_torch.configs import registry
from repro_torch.core.attention import AttentionConfig
from repro_torch.core.masks import MaskSpec
from repro_torch.kernels import flash_decode as dec_mod
from repro_torch.kernels import flash_fwd as fwd_mod
from repro_torch.launch import steps
from repro_torch.models import attention_layer, layers
from repro_torch.models.lm import LM, check_supported
from repro_torch.models.whisper import Whisper, params_from_jax
from test_torch_serving import jax_trace_state  # noqa: F401  (the per-test JAX shim)

LAYER_TOL = dict(atol=1e-5, rtol=1e-5)  # one layer in f32, summation order only
TOL = dict(atol=1e-4, rtol=1e-4)        # whole-model f32 logits and caches
FRAMES, PROMPT, CACHE, STEPS = 320, 4, 64, 8
RUNS = {
    "auto": (JaxAttentionConfig(impl="flash_pallas", decode_splits=8, use_tuned=False),
             AttentionConfig(impl="flash_cuda")),
    "split3": (JaxAttentionConfig(impl="flash_pallas", decode_splits=8, use_tuned=False,
                                  kv_splits=3, block_q=64, block_kv=64),
               AttentionConfig(impl="flash_cuda", kv_splits=3)),
}


def _cfgs():
    return (jax_registry.reduce_config(jax_registry.get("whisper-base")),
            registry.reduce_config(registry.get("whisper-base")))


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------------ layers


def _rng_tree(rng, tree):
    """``tree`` with seeded noise (std 0.1) on its biases and norm scales,
    which the JAX initialiser sets to constants; weights as initialised."""
    def perturb(path, x):
        name = jax.tree_util.keystr(path)
        if any(s in name for s in ("'b", "'scale'")):
            return x + jnp.asarray(rng.standard_normal(np.shape(x)).astype(np.float32) * 0.1)
        return x

    return jax.tree_util.tree_map_with_path(perturb, tree)


def _load(module, tree):
    state = {}

    def put(prefix, sub):
        for k, val in sub.items():
            if isinstance(val, dict):
                put(f"{prefix}{k}.", val)
            else:
                state[prefix + k] = _t(val)

    put("", tree)
    module.load_state_dict(state)
    return module


def test_layer_norm_matches_jax():
    _, cfg = _cfgs()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, cfg.d_model), dtype=np.float32) * 3 + 1
    p = _rng_tree(rng, jax_layers.init_norm(cfg, jnp.float32))
    want = jax_layers.apply_norm(p, x, cfg.norm_eps, "layernorm")
    norm = _load(layers.Norm(cfg, "cpu", torch.float32), p)
    np.testing.assert_allclose(norm(_t(x)).detach().numpy(), np.asarray(want), **LAYER_TOL)


def test_gelu_mlp_matches_jax():
    """``jax.nn.gelu`` is the tanh approximation; so is the port's."""
    _, cfg = _cfgs()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, cfg.d_model), dtype=np.float32)
    p = _rng_tree(rng, jax_layers.init_mlp(jax.random.PRNGKey(1), cfg, cfg.d_ff, jnp.float32))
    want = jax_layers.apply_mlp(p, x, "gelu")
    mlp = _load(layers.MLP(cfg, "cpu", torch.float32), p)
    np.testing.assert_allclose(mlp(_t(x)).detach().numpy(), np.asarray(want), **LAYER_TOL)


@pytest.mark.parametrize("n,d", [(128, 512), (128, 64), (7, 6)])
def test_sinusoidal_positions_match_jax(n, d):
    np.testing.assert_allclose(layers.sinusoidal_positions(n, d).numpy(),
                               np.asarray(jax_layers.sinusoidal_positions(n, d)), **LAYER_TOL)


def test_long_sinusoidal_table_matches_jax_to_its_angle_rounding():
    """Whisper's 1500-frame table. The angle at position p is the f32
    product p * inv; XLA's and PyTorch's f32 exp may round an ``inv`` one
    bit apart, and at p = 1499 one bit of the angle is 2**-13 = 1.2e-4, so
    sin and cos can differ by that much there. Held to two bits of the
    largest angle (and to 1e-5 below position 128 by the test above)."""
    n, d = 1500, 512
    got = layers.sinusoidal_positions(n, d).numpy()
    want = np.asarray(jax_layers.sinusoidal_positions(n, d))
    np.testing.assert_allclose(got, want, rtol=0, atol=2 * 2.0 ** (np.floor(np.log2(n)) - 23))


def test_learned_positions_match_jax(jax_trace_state):
    """The decoder embedding with learned positions (JAX ``_dec_embed``): a
    prompt from position 0, and per-row decode positions."""
    jcfg, cfg = _cfgs()
    p = jax_whisper.init_whisper(jcfg, jax.random.PRNGKey(0))
    model = Whisper(cfg, "cpu")
    model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, p)))
    assert model.decoder.embed.positions.shape == (cfg.learned_pos_embed, cfg.d_model)
    np.testing.assert_allclose(model.decoder.embed.positions.detach().numpy().std(), 0.02,
                               rtol=0.1)
    tok = np.array([[3, 9, 27, 81], [5, 25, 125, 1]], np.int32)
    want = jax_whisper._dec_embed(jcfg, p, tok)
    np.testing.assert_array_equal(model._dec_embed(_t(tok).long()).detach().numpy(),
                                  np.asarray(want))
    start = np.array([4, 17], np.int32)
    want = jax_whisper._dec_embed(jcfg, p, tok[:, :1], start=jnp.asarray(start))
    got = model._dec_embed(_t(tok[:, :1]).long(), start=_t(start))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))


@pytest.fixture
def attn_params():
    """A biased attention layer (random biases) and its JAX tree."""
    _, cfg = _cfgs()
    rng = np.random.default_rng(2)
    p = _rng_tree(rng, jax_attn_layer.init_attention(jax.random.PRNGKey(2), cfg, jnp.float32))
    return cfg, p, _load(attention_layer.Attention(cfg, "cpu", torch.float32), p)


JAX_LAYER_ATTN = JaxAttentionConfig(impl="flash_pallas", use_tuned=False)


def test_biased_self_attention_matches_jax(attn_params, jax_trace_state):
    cfg, p, layer = attn_params
    assert set(p) == {"wq", "wk", "wv", "wo", "bq", "bk", "bv", "bo"}
    x = np.random.default_rng(3).standard_normal((2, 40, cfg.d_model), dtype=np.float32)
    pos = np.arange(40, dtype=np.int32)
    for spec in ({}, dict(causal=True)):
        want = jax_attn_layer.apply_attention(p, cfg, x, pos, JaxMaskSpec(**spec), JAX_LAYER_ATTN)
        got = attention_layer.apply_attention(layer, cfg, _t(x), _t(pos), MaskSpec(**spec),
                                              AttentionConfig())
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **LAYER_TOL)


def test_cross_attention_matches_jax(attn_params, jax_trace_state):
    """Cross-attention (``x_kv``, no RoPE), its cached-K/V form, and the
    decode-time ``cross_attention_step``."""
    cfg, p, layer = attn_params
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, cfg.d_model), dtype=np.float32)
    enc = rng.standard_normal((2, 150, cfg.d_model), dtype=np.float32)
    pos = np.arange(5, dtype=np.int32)
    want = jax_attn_layer.apply_attention(p, cfg, x, pos, JaxMaskSpec(), JAX_LAYER_ATTN,
                                          x_kv=enc)
    got = attention_layer.apply_attention(layer, cfg, _t(x), _t(pos), MaskSpec(),
                                          AttentionConfig(), x_kv=_t(enc))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **LAYER_TOL)
    k, v = attention_layer._project_kv(layer, cfg, _t(enc))
    jk, jv = jax_attn_layer._project_kv(p, cfg, enc)
    np.testing.assert_allclose(k.detach().numpy(), np.asarray(jk), **LAYER_TOL)
    cached = attention_layer.cross_attention(layer, cfg, _t(x), {"k": k, "v": v}, MaskSpec(),
                                             AttentionConfig())
    np.testing.assert_allclose(cached.detach().numpy(), got.detach().numpy(), **LAYER_TOL)
    n = np.array([150, 150], np.int32)
    jcfg = JaxAttentionConfig(impl="flash_pallas", decode_splits=8, use_tuned=False)
    want = jax_attn_layer.cross_attention_step(p, cfg, x[:, :1], {"k": jk, "v": jv}, n, jcfg)
    with torch.no_grad():  # decode is forward-only
        got = attention_layer.cross_attention_step(layer, cfg, _t(x[:, :1]),
                                                   {"k": k.detach(), "v": v.detach()}, _t(n),
                                                   AttentionConfig())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **LAYER_TOL)


# ---------------------------------------------------------------- the slice


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = _cfgs()
    p = _rng_tree(np.random.default_rng(0), jax_whisper.init_whisper(jcfg, jax.random.PRNGKey(0)))
    model = Whisper(cfg, "cpu")
    model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, p)))
    rng = np.random.default_rng(1)
    frames = rng.standard_normal((2, FRAMES, cfg.d_model), dtype=np.float32)
    tokens = rng.integers(1, cfg.vocab_size, (2, PROMPT)).astype(np.int32)
    return jcfg, p, cfg, model, frames, tokens


@pytest.mark.parametrize("run", list(RUNS))
def test_encode_forward_prefill_and_decode_match_jax(models, run, jax_trace_state):
    jcfg, p, cfg, model, frames, tokens = models
    jattn, attn = RUNS[run]
    f, tk = _t(frames), _t(tokens).long()
    enc_j = jax.jit(lambda p, f: jax_whisper.encode(jcfg, p, f, jattn))(p, frames)
    with torch.no_grad():
        enc = model.encode(f, attn)
        hid, aux, nprefix = model(f, tk, attn)
    np.testing.assert_allclose(enc.numpy(), np.asarray(enc_j), **TOL)
    hid_j, _, _ = jax.jit(lambda p, f, t: jax_whisper.forward(jcfg, p, f, t, jattn))(
        p, frames, tokens)
    np.testing.assert_allclose(hid.numpy(), np.asarray(hid_j), **TOL)
    assert nprefix == 0 and float(aux) == 0.0

    splits_before = fwd_mod.flash_fwd_splitkv_plain.calls
    h, caches, n = model.prefill(f, tk, attn, CACHE)
    # Auto splits the cross-attention of every decoder layer and nothing
    # else; an explicit kv_splits also splits the encoder's self-attention
    # (5 kv tiles), not the 4-token causal prefill (one kv tile).
    n_split = cfg.num_layers + (cfg.encoder.num_layers if attn.kv_splits else 0)
    assert fwd_mod.flash_fwd_splitkv_plain.calls - splits_before == n_split
    h_j, caches_j, n_j = jax.jit(
        lambda p, f, t: jax_whisper.prefill(jcfg, p, f, t, jattn, CACHE))(p, frames, tokens)
    assert n == n_j == PROMPT
    logits = model.logits_from_hidden(h)
    logits_j = jax_layers.unembed(p["decoder"]["embed"], h_j, jcfg.tie_embeddings)
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), **TOL)
    for i, c in enumerate(caches):
        for part in ("kv", "cross"):
            for name in ("k", "v"):
                np.testing.assert_allclose(c[part][name].numpy(),
                                           np.asarray(caches_j[part][name][i]), **TOL)

    jstep = jax.jit(lambda p, t, c, n: jax_whisper.decode_step(jcfg, p, t, c, n, jattn))
    lens = np.full((2,), PROMPT, np.int32)
    tok = np.asarray(jnp.argmax(logits_j[..., :cfg.vocab_size], -1), np.int32)
    decodes_before = dec_mod.flash_decode_plain.calls
    for _ in range(4):
        logits_j, caches_j = jstep(p, tok, caches_j, lens)
        logits, caches = model.decode_step(_t(tok).long(), caches, _t(lens), attn)
        np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), **TOL)
        tok = np.asarray(jnp.argmax(logits_j[..., :cfg.vocab_size], -1), np.int32)
        lens = lens + 1
    # Every tick: self- and cross-attention of every decoder layer.
    assert dec_mod.flash_decode_plain.calls - decodes_before == 4 * 2 * cfg.num_layers
    for i, c in enumerate(caches):
        np.testing.assert_allclose(c["kv"]["k"].numpy(), np.asarray(caches_j["kv"]["k"][i]),
                                   **TOL)


@pytest.mark.parametrize("run", list(RUNS))
def test_greedy_tokens_through_the_step_builders_match_jax(models, run, jax_trace_state):
    """Prefill, then 8 greedy ticks, through the port's and JAX's step
    builders: the same tokens at every step."""
    jcfg, p, cfg, model, frames, tokens = models
    jattn, attn = RUNS[run]
    jprefill = jax.jit(jax_steps.build_prefill_step(jcfg, jattn, CACHE))
    jserve = jax.jit(jax_steps.build_serve_step(jcfg, jattn))
    prefill = steps.build_prefill_step(cfg, attn, CACHE)
    serve = steps.build_serve_step(cfg, attn)
    tok_j, caches_j, lens_j = jprefill(p, {"frames": frames, "inputs": tokens})
    tok, caches, lens = prefill(model, {"frames": _t(frames), "inputs": _t(tokens).long()})
    want, got = [np.asarray(tok_j)], [tok.numpy()]
    assert lens.tolist() == np.asarray(lens_j).tolist() == [PROMPT, PROMPT]
    for _ in range(STEPS):
        tok_j, caches_j = jserve(p, tok_j, caches_j, lens_j)
        tok, caches = serve(model, tok, caches, lens)
        lens_j, lens = lens_j + 1, lens + 1
        want.append(np.asarray(tok_j))
        got.append(tok.numpy())
    np.testing.assert_array_equal(np.concatenate(got, 1), np.concatenate(want, 1))
    assert len({int(t) for t in np.concatenate(got, 1).ravel()}) > 1


def test_whisper_cache_specs_match_jax():
    jcfg, cfg = _cfgs()
    specs = registry.cache_specs(cfg, 3, CACHE, enc_frames=FRAMES)
    jspecs = jax_registry.cache_specs(jcfg, 3, CACHE, enc_frames=FRAMES)
    assert len(specs) == cfg.num_layers
    for part in ("kv", "cross"):
        for name in ("k", "v"):
            assert specs[0][part][name].shape == jspecs[part][name].shape[1:]
            assert specs[0][part][name].dtype == torch.float32


# ----------------------------------------------------------------- refusals


@pytest.mark.parametrize("name", ["falcon-mamba-7b", "hymba-1.5b", "internvl2-76b"])
def test_unported_families_are_refused(name):
    cfg = registry.get(name)
    with pytest.raises(NotImplementedError, match="SSM, hybrid and VLM"):
        check_supported(cfg)
    with pytest.raises(NotImplementedError):
        LM(registry.reduce_config(cfg), device="cpu")
    if cfg.ssm is not None:  # recurrent state has no cache spec yet
        with pytest.raises(NotImplementedError, match="attention-layer caches"):
            registry.cache_specs(cfg, 1, 16)
    with pytest.raises(ValueError, match="encoder-decoder"):
        Whisper(registry.reduce_config(cfg), device="cpu")


@pytest.mark.parametrize("name", ["granite-moe-1b-a400m", "mixtral-8x22b"])
def test_whisper_refuses_the_moe_families(name):
    """The MoE archs are decoder-only LMs (``models/lm.py`` builds them):
    Whisper refuses them as it refuses every decoder-only config."""
    cfg = registry.get(name)
    check_supported(cfg)
    with pytest.raises(ValueError, match="encoder-decoder"):
        Whisper(registry.reduce_config(cfg), device="cpu")


def test_the_decoder_only_lm_points_to_whisper():
    cfg = registry.reduce_config(registry.get("whisper-base"))
    with pytest.raises(NotImplementedError, match="models.whisper.Whisper"):
        LM(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        check_supported(dataclasses.replace(cfg, encoder=None))
