"""The training slice as a whole: the port's loss, gradients and train steps
against the JAX package's, on the same weights (``init_lm`` -> numpy ->
``params_from_jax``) and the same synthetic batches, with the JAX side on
its Pallas kernels in interpret mode (``flash_pallas``, fused backward) and
the port on its kernels' plain versions (``flash_cuda`` on CPU tensors).
Reduced qwen3-8b in f32 as the registry shrinks it (G = 1) and with two kv
heads (G = 2), remat on as in the published config. Also the pieces around
the step: data, loss chunking, learning rate, weight-decay selection, CLI."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.core.attention import AttentionConfig as JaxAttentionConfig
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.launch import steps as jax_steps
from repro.launch.train import PRESETS as JAX_PRESETS
from repro.models import lm as jax_lm
from repro.training import losses as jax_losses
from repro.training import optimizer as jax_opt
from repro_torch.configs import registry
from repro_torch.core.attention import AttentionConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import steps
from repro_torch.launch.train import PRESETS
from repro_torch.models.layers import Embedding
from repro_torch.models.lm import LM, params_from_jax
from repro_torch.training import losses, optimizer
from test_torch_serving import jax_trace_state  # noqa: F401  (the per-test JAX shim)

ROOT = Path(__file__).resolve().parents[1]
# f32 whole-model sums in different orders (XLA against PyTorch, one 128-row
# tile against two 64-row tiles): relative differences stay near 1e-6.
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
# Parameters after Adam steps at lr 1e-2: the update divides by sqrt(nu), so
# where a gradient is near zero its last-digit difference can move that
# element's update by a fraction of lr; 1% of lr bounds it.
PARAM_TOL = dict(atol=1e-4, rtol=1e-4)
B, S = 2, 128
JAX_ATTN = JaxAttentionConfig(impl="flash_pallas", interpret=True, use_tuned=False)
ATTN = AttentionConfig(impl="flash_cuda")


@pytest.fixture(scope="module", params=[None, 2], ids=["g1", "g2"])
def models(request):
    kv = request.param
    jcfg = jax_registry.reduce_config(jax_registry.get("qwen3-8b"))
    cfg = registry.reduce_config(registry.get("qwen3-8b"))
    if kv is not None:
        jcfg = dataclasses.replace(jcfg, num_kv_heads=kv)
        cfg = dataclasses.replace(cfg, num_kv_heads=kv)
    assert cfg.remat and cfg.dtype == "float32"
    jparams = jax_lm.init_lm(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, cfg


def _port_model(cfg, jparams):
    model = LM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jparams)))
    return model


def _batch(cfg, step, seed=0):
    inputs, targets = JaxSyntheticLM(
        JaxDataConfig(batch_size=B, seq_len=S, vocab_size=cfg.vocab_size, seed=seed)
    ).batch(step)
    return inputs, targets


def test_loss_and_gradients_match_jax(models, jax_trace_state):
    jcfg, jparams, cfg = models
    inputs, targets = _batch(cfg, 0)
    jbatch = {"inputs": jnp.asarray(inputs), "targets": jnp.asarray(targets)}
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: jax_steps.loss_fn(jcfg, JAX_ATTN, p, b), has_aux=True))
    (jloss, jm), jgrads = grad_fn(jparams, jbatch)

    model = _port_model(cfg, jparams)
    batch = {"inputs": torch.from_numpy(inputs).long(), "targets": torch.from_numpy(targets)}
    loss, metrics = steps.loss_fn(cfg, ATTN, model, batch)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **LOSS_TOL)
    for key in ("ce_loss", "nll_sum", "tokens", "accuracy"):
        np.testing.assert_allclose(metrics[key].item(), float(jm[key]), err_msg=key, **LOSS_TOL)
    want = params_from_jax(cfg, jax.tree.map(np.asarray, jgrads))
    got = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), err_msg=name, **GRAD_TOL)


def test_three_train_steps_match_jax(models, jax_trace_state):
    jcfg, jparams, cfg = models
    opt_cfg = dict(warmup_steps=2, total_steps=3, lr=1e-2)
    jstep = jax.jit(jax_steps.build_train_step(jcfg, JAX_ATTN, jax_opt.AdamWConfig(**opt_cfg)))
    jstate = jax_opt.init_opt_state(jparams)
    model = _port_model(cfg, jparams)
    params = dict(model.named_parameters())
    state = optimizer.init_opt_state(params)
    step_fn = steps.build_train_step(cfg, ATTN, optimizer.AdamWConfig(**opt_cfg))
    data = SyntheticLM(DataConfig(batch_size=B, seq_len=S, vocab_size=cfg.vocab_size))
    jp, want, got = jparams, [], []
    for step in range(3):
        inputs, targets = data.batch(step)
        jp, jstate, jm = jstep(jp, jstate, {"inputs": jnp.asarray(inputs),
                                            "targets": jnp.asarray(targets)})
        want.append([float(jm[k]) for k in ("loss", "grad_norm", "lr")])
        state, m = step_fn(model, state, {"inputs": torch.from_numpy(inputs).long(),
                                          "targets": torch.from_numpy(targets)})
        got.append([m[k] for k in ("loss", "grad_norm", "lr")])
    np.testing.assert_allclose(np.array(got), np.array(want), **LOSS_TOL)
    assert got[2][0] < got[0][0]
    assert state.step == int(jstate.step) == 3
    final = params_from_jax(cfg, jax.tree.map(np.asarray, jp))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), final[name].numpy(), err_msg=name,
                                   **PARAM_TOL)


def test_microbatches_match_one_batch(models):
    """Two microbatches sum their f32 gradients into the same update as the
    whole batch (up to summation order)."""
    jcfg, jparams, cfg = models
    inputs, targets = _batch(cfg, 1)
    batch = {"inputs": torch.from_numpy(inputs).long(), "targets": torch.from_numpy(targets)}
    opt_cfg = optimizer.AdamWConfig(warmup_steps=1, lr=1e-2)
    results = []
    for micro in (1, 2):
        model = _port_model(cfg, jparams)
        state = optimizer.init_opt_state(dict(model.named_parameters()))
        _, m = steps.build_train_step(cfg, ATTN, opt_cfg, microbatches=micro)(model, state, batch)
        results.append((m, {n: p.detach().clone() for n, p in model.named_parameters()}))
    (m1, p1), (m2, p2) = results
    np.testing.assert_allclose(m2["loss"], m1["loss"], **LOSS_TOL)
    np.testing.assert_allclose(m2["grad_norm"], m1["grad_norm"], **LOSS_TOL)
    for name in p1:
        np.testing.assert_allclose(p2[name].numpy(), p1[name].numpy(), err_msg=name,
                                   **PARAM_TOL)


@pytest.mark.parametrize("seed,vocab", [(0, 512), (3, 151_936)])
def test_synthetic_batches_equal(seed, vocab):
    cfg = dict(batch_size=3, seq_len=40, vocab_size=vocab, seed=seed)
    ours, theirs = SyntheticLM(DataConfig(**cfg)), JaxSyntheticLM(JaxDataConfig(**cfg))
    for step in (0, 1, 7):
        for a, b in zip(ours.batch(step), theirs.batch(step)):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)


def _no_decay_flags(tree):
    """The JAX rule per leaf, as a leaf-shaped array of 0/1 (so it survives
    ``params_from_jax``'s unstacking of scan groups)."""
    flat, tdef = jax.tree_util.tree_flatten_with_path(tree)
    flags = [np.full(np.shape(x), float(jax_opt._no_decay("/".join(str(k) for k in path))))
             for path, x in flat]
    return jax.tree_util.tree_unflatten(tdef, flags)


@pytest.mark.parametrize("arch", ["qwen3-8b", "gemma3-1b", "deepseek-coder-33b", "gpt-20m"])
def test_no_decay_sets_equal(arch):
    if arch in PRESETS:
        jcfg, cfg = JAX_PRESETS[arch], PRESETS[arch]
    else:
        jcfg = jax_registry.reduce_config(jax_registry.get(arch))
        cfg = registry.reduce_config(registry.get(arch))
    tree = jax.eval_shape(lambda: jax_lm.init_lm(jcfg, jax.random.PRNGKey(0)))
    want = params_from_jax(cfg, _no_decay_flags(tree))
    names = [n for n, _ in LM(cfg, device="cpu").named_parameters()]
    assert sorted(names) == sorted(want)
    got = {n: optimizer._no_decay(n) for n in names}
    assert got == {n: bool(t.flatten()[0]) for n, t in want.items()}
    assert any(got.values()) and not all(got.values())


@pytest.mark.parametrize("tie", [False, True])
def test_chunked_cross_entropy_matches_on_padded_vocab(tie):
    cfg = dataclasses.replace(registry.reduce_config(registry.get("qwen3-8b")),
                              vocab_size=500, tie_embeddings=tie)
    assert cfg.padded_vocab == 512
    rng = np.random.default_rng(4)
    Bc, Sc, d = 2, 64, cfg.d_model
    hidden = rng.standard_normal((Bc, Sc, d), dtype=np.float32)
    targets = rng.integers(0, cfg.vocab_size, (Bc, Sc)).astype(np.int32)
    mask = (rng.random((Bc, Sc)) < 0.8).astype(np.float32)
    tokens = rng.standard_normal((cfg.padded_vocab, d), dtype=np.float32)
    unembed = rng.standard_normal((d, cfg.padded_vocab), dtype=np.float32) / 8
    jembed = {"tokens": tokens} if tie else {"tokens": tokens, "unembed": unembed}

    def jax_loss(h):
        return jax_losses.chunked_cross_entropy(
            jembed, tie, h, targets, vocab_valid=cfg.vocab_size, mask=mask, chunk=16)

    (jloss, jm), jgrad = jax.value_and_grad(jax_loss, has_aux=True)(hidden)
    emb = Embedding(cfg, "cpu", torch.float32)
    emb.load_state_dict({k: torch.from_numpy(v) for k, v in jembed.items()})
    h = torch.from_numpy(hidden).requires_grad_()
    loss, m = losses.chunked_cross_entropy(emb, h, torch.from_numpy(targets),
                                           vocab_valid=cfg.vocab_size,
                                           mask=torch.from_numpy(mask), chunk=16)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **LOSS_TOL)
    for key in ("nll_sum", "tokens", "accuracy"):
        np.testing.assert_allclose(m[key].item(), float(jm[key]), err_msg=key, **LOSS_TOL)
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(jgrad), **GRAD_TOL)
    # The padded ids take no probability: their unembedding gets no gradient.
    g = emb.tokens.grad if tie else emb.unembed.grad.t()
    assert (g[cfg.vocab_size:] == 0).all() and (g[:cfg.vocab_size] != 0).any()


@pytest.mark.parametrize("warmup,total", [(100, 10_000), (2, 8), (0, 5)])
def test_lr_schedule_matches(warmup, total):
    ours = optimizer.AdamWConfig(warmup_steps=warmup, total_steps=total)
    theirs = jax_opt.AdamWConfig(warmup_steps=warmup, total_steps=total)
    for step in sorted({0, max(warmup - 1, 0), warmup, (warmup + total) // 2, total,
                        total + 3}):
        np.testing.assert_allclose(optimizer.lr_schedule(ours, step),
                                   float(jax_opt.lr_schedule(theirs, jnp.asarray(step))),
                                   rtol=1e-6, err_msg=f"step {step}")


def test_nonfinite_gradients_skip_the_update():
    p = {"w": torch.ones(3), "ln.scale": torch.ones(2)}
    state = optimizer.init_opt_state(p)
    state, m = optimizer.apply_updates(
        optimizer.AdamWConfig(), state, p,
        {"w": torch.tensor([1.0, float("nan"), 0.0]), "ln.scale": torch.ones(2)})
    assert m["skipped"] == 1.0 and state.step == 1
    assert (p["w"] == 1).all() and (state.mu["w"] == 0).all()


def test_train_cli_runs():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--preset", "gpt-20m",
         "--device", "cpu", "--steps", "2", "--seq", "64", "--batch", "2"],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert np.isfinite(out["first5_loss"]) and out["tokens_per_s"] > 0
