"""The whisper training slice: the port's loss, gradients and train steps
against the JAX package's ``build_train_step`` on reduced whisper-base (2
encoder and 2 decoder layers, d_model 64, 4 heads of 16, f32, remat on as
in the published config), from the same weights (``init_whisper`` -> numpy
-> ``params_from_jax``) and the same seeded numpy frames and tokens. The
JAX side runs its Pallas kernels in interpret mode (``flash_pallas``, fused
or split backward), the port its kernels' plain versions (``flash_cuda`` on
CPU tensors).

160 frames a row leave a ragged 32-row tail tile in the encoder and in the
cross-attention's kv axis; 48 decoder tokens a ragged causal q axis. The
batch is a dict {"frames", "inputs", "targets"}, as the JAX package trains
whisper (its data stream carries no frames; neither does the port's).

The key biases (``bk``) have an exact gradient of zero: adding one vector
to every key adds the same q . b to every score of a row, which the softmax
cancels. Both packages compute it as f32 sum-order noise (a few 1e-8), and
Adam turns noise into steps of up to lr, so after the first step the key
biases follow each package's own noise: they are held to a zero gradient
and a bounded drift, not to each other."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.core.attention import AttentionConfig as JaxAttentionConfig
from repro.launch import steps as jax_steps
from repro.models import whisper as jax_whisper
from repro.training import optimizer as jax_opt
from repro_torch.configs import registry
from repro_torch.core.attention import AttentionConfig
from repro_torch.launch import steps
from repro_torch.models.whisper import Whisper, params_from_jax
from repro_torch.training import optimizer
from test_torch_serving import jax_trace_state  # noqa: F401  (the per-test JAX shim)
from test_torch_train import GRAD_TOL, LOSS_TOL, PACKED_MOVE_TOL

B, FRAMES, S = 2, 160, 48
JAX_ATTN = JaxAttentionConfig(impl="flash_pallas", interpret=True, use_tuned=False)
ATTN = AttentionConfig(impl="flash_cuda")


@pytest.fixture(scope="module")
def models():
    jcfg = jax_registry.reduce_config(jax_registry.get("whisper-base"))
    cfg = registry.reduce_config(registry.get("whisper-base"))
    assert cfg.remat and cfg.dtype == "float32" and cfg.family == "encdec"
    return jcfg, jax_whisper.init_whisper(jcfg, jax.random.PRNGKey(0)), cfg


def _port_model(cfg, jparams):
    model = Whisper(cfg, device="cpu")
    model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jparams)))
    return model


def _batch(cfg, step):
    """Seeded frame embeddings (the stub frontend's input) and a token row
    shifted by one into inputs and targets, as numpy."""
    rng = np.random.default_rng(100 + step)
    tokens = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"frames": rng.standard_normal((B, FRAMES, cfg.d_model), dtype=np.float32),
            "inputs": tokens[:, :-1], "targets": tokens[:, 1:]}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("bwd", ["fused", "split"])
def test_whisper_loss_and_gradients_match_jax(models, jax_trace_state, bwd):
    """One loss, its metrics and every parameter's gradient (the encoder's
    through the cross-attention), the JAX side through the Pallas backward
    of the same mode as the port's."""
    jcfg, jparams, cfg = models
    batch = _batch(cfg, 0)
    jattn = dataclasses.replace(JAX_ATTN, bwd=bwd)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: jax_steps.loss_fn(jcfg, jattn, p, b), has_aux=True))
    (jloss, jm), jgrads = grad_fn(jparams, {k: jnp.asarray(v) for k, v in batch.items()})

    model = _port_model(cfg, jparams)
    loss, metrics = steps.loss_fn(cfg, dataclasses.replace(ATTN, bwd=bwd), model,
                                  _torch_batch(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **LOSS_TOL)
    for key in ("ce_loss", "nll_sum", "tokens", "accuracy"):
        np.testing.assert_allclose(metrics[key].item(), float(jm[key]), err_msg=key, **LOSS_TOL)
    want = params_from_jax(cfg, jax.tree.map(np.asarray, jgrads))
    got = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), err_msg=name, **GRAD_TOL)
        if name.endswith(".bk"):  # zero up to sum-order noise on both sides
            assert g.abs().max() <= GRAD_TOL["atol"], name
    enc = [n for n in got if n.startswith("encoder.layers.0.attn.")]
    assert enc and all(got[n].abs().max() > 0 for n in enc)


def test_three_whisper_train_steps_match_jax(models, jax_trace_state):
    """Three AdamW steps through both packages' ``build_train_step``: the
    same losses, gradient norms and learning rates each step at LOSS_TOL.
    The parameters after the third are held as the packed steps of
    ``test_torch_train.py`` hold them, each tensor as a whole: its distance
    from the JAX tensor at most PACKED_MOVE_TOL of the distance the steps
    moved it (Adam divides by sqrt(nu), so an element whose gradient is
    near zero follows the gradients' sum-order noise: one w_out element
    lands 2e-4 from JAX's; measured worst ratio 1.3e-4). The key biases,
    whose exact gradient is zero (module docstring), drift by less than one
    lr from where they started on both sides (measured 1.2e-3)."""
    jcfg, jparams, cfg = models
    opt_cfg = dict(warmup_steps=2, total_steps=3, lr=1e-2)
    jstep = jax.jit(jax_steps.build_train_step(jcfg, JAX_ATTN, jax_opt.AdamWConfig(**opt_cfg)))
    jstate = jax_opt.init_opt_state(jparams)
    model = _port_model(cfg, jparams)
    state = optimizer.init_opt_state(dict(model.named_parameters()))
    step_fn = steps.build_train_step(cfg, ATTN, optimizer.AdamWConfig(**opt_cfg))
    jp, want, got = jparams, [], []
    for step in range(3):
        batch = _batch(cfg, step)
        jp, jstate, jm = jstep(jp, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        want.append([float(jm[k]) for k in ("loss", "grad_norm", "lr")])
        state, m = step_fn(model, state, _torch_batch(batch))
        got.append([m[k] for k in ("loss", "grad_norm", "lr")])
    np.testing.assert_allclose(np.array(got), np.array(want), **LOSS_TOL)
    assert state.step == int(jstate.step) == 3
    final = params_from_jax(cfg, jax.tree.map(np.asarray, jp))
    start = params_from_jax(cfg, jax.tree.map(np.asarray, jparams))
    for name, p in model.named_parameters():
        ours, theirs, init = p.detach().numpy(), final[name].numpy(), start[name].numpy()
        if name.endswith(".bk"):
            drift = max(np.abs(ours - init).max(), np.abs(theirs - init).max())
            assert drift < opt_cfg["lr"], (name, drift)
            continue
        moved = np.linalg.norm(theirs - init)
        apart = np.linalg.norm(ours - theirs)
        assert moved > 0 and apart <= PACKED_MOVE_TOL * moved, (name, apart, moved)


def test_whisper_remat_recomputes_each_layer(models):
    """With ``cfg.remat`` every encoder and decoder layer runs its attention
    forward again in the backward (the JAX package checkpoints each layer
    body); without it, once. The gradients are the same either way."""
    from repro_torch.kernels import flash_fwd

    _, jparams, cfg = models
    batch = _torch_batch(_batch(cfg, 1))
    calls, grads = {}, {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        model = _port_model(c, jparams)
        flash_fwd.flash_fwd_plain.calls = 0
        loss, _ = steps.loss_fn(c, ATTN, model, batch)
        loss.backward()
        calls[remat] = flash_fwd.flash_fwd_plain.calls
        grads[remat] = {n: p.grad for n, p in model.named_parameters()}
    n_attn = cfg.encoder.num_layers + 2 * cfg.num_layers
    assert calls == {True: 2 * n_attn, False: n_attn}
    for name, g in grads[True].items():
        np.testing.assert_allclose(g.numpy(), grads[False][name].numpy(), err_msg=name,
                                   **GRAD_TOL)
