"""MoE training on the CPU: a reduced granite-moe-1b-a400m's loss, every
parameter gradient and three AdamW steps against the JAX package's, on the
same weights (``init_lm`` -> numpy -> ``params_from_jax``) and the same
synthetic batches. The JAX side takes ``jax.value_and_grad`` over
``steps.loss_fn`` (``lm.forward`` with the summed aux loss, then the
chunked cross-entropy) on its Pallas kernels in interpret mode, fused or
split backward; the port runs its kernels' plain versions.

The reduced granite of the registry (8 experts top 2, d_model 64), with
granite's two q heads a kv head, three layers (each a remat group, as in
the published config) and a capacity factor of 0.5, so that every layer
drops assignments: the dropped tokens' gradients (none from that expert)
are held too."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.core.attention import AttentionConfig as JaxAttentionConfig
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.distributed import sharding as jax_sharding
from repro.launch import steps as jax_steps
from repro.models import lm as jax_lm
from repro.training import optimizer as jax_opt
from repro_torch.configs import registry
from repro_torch.core.attention import AttentionConfig
from repro_torch.launch import steps
from repro_torch.models import moe
from repro_torch.models.lm import LM, params_from_jax
from repro_torch.training import optimizer

# The tolerances of tests/test_torch_train.py: f32 on both sides, summation
# order only.
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
B, S = 2, 128
ARCH = "granite-moe-1b-a400m"
JAX_ATTN = JaxAttentionConfig(impl="flash_pallas", interpret=True, use_tuned=False)
ATTN = AttentionConfig(impl="flash_cuda")


def _granite(reg):
    cfg = reg.reduce_config(reg.get(ARCH))
    return dataclasses.replace(cfg, num_kv_heads=2, num_layers=3, moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.5))


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
    jcfg, cfg = _granite(jax_registry), _granite(registry)
    assert cfg.remat and cfg.group_size == 1 and cfg.dtype == "float32"
    jparams = jax_lm.init_lm(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, cfg


def _port_model(cfg, jparams):
    model = LM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jparams)))
    return model


def _batch(cfg, step):
    return JaxSyntheticLM(JaxDataConfig(batch_size=B, seq_len=S,
                                        vocab_size=cfg.vocab_size)).batch(step)


def test_every_layer_drops_assignments(models):
    """The capacity factor of 0.5 makes every MoE layer drop assignments on
    the first batch (the premise of the gradient tests below)."""
    _, jparams, cfg = models
    model = _port_model(cfg, jparams)
    inputs, _ = _batch(cfg, 0)
    dropped = []

    def record(xf, router, wg, wu, wd, m, e_lo, cap, k):
        top_e = moe.top_k(moe.route(router, xf), k)[1]
        keep = moe.dispatch_indices(top_e.reshape(-1), e_lo, wg.shape[0], cap, k)[2]
        dropped.append(int((~keep).sum()))
        return body(xf, router, wg, wu, wd, m, e_lo, cap, k)

    body = moe.moe_body
    moe.moe_body = record
    try:
        with torch.no_grad():
            model(torch.from_numpy(inputs).long(), ATTN)
    finally:
        moe.moe_body = body
    assert len(dropped) == cfg.num_layers and min(dropped) > 0, dropped


def test_dispatch_backward_sums_each_token_in_f32():
    """The dispatch gather's backward (``moe._Dispatch``) gives each token
    the sum of its kept slots' gradients, added in f32 and rounded to bf16
    once: the f64 sum of ``index_select``'s own backward, rounded to bf16,
    here at a capacity that drops assignments."""
    gen = torch.Generator().manual_seed(5)
    T, d, E, k, cap = 64, 32, 8, 2, 12
    top_e = torch.stack([torch.randperm(E, generator=gen)[:k] for _ in range(T)])
    token_of, dest, keep, _, rank = moe.dispatch_indices(top_e.reshape(-1), 0, E, cap, k)
    assert not keep.all()
    n_slots = E * cap
    token_at = torch.zeros(n_slots + 1, dtype=torch.long).scatter_(0, dest, token_of)[:n_slots]
    used = torch.zeros(n_slots + 1).scatter_(0, dest, keep.float())[:n_slots]
    x = torch.randn((T, d), generator=gen).to(torch.bfloat16).requires_grad_()
    g = torch.randn((n_slots, d), generator=gen).to(torch.bfloat16)
    y = moe._Dispatch.apply(x, token_at, used.to(torch.bfloat16), dest.index_select(0, rank))
    assert torch.equal(y, x.detach().index_select(0, token_at) * used.to(torch.bfloat16)[:, None])
    y.backward(g)
    x64 = x.detach().double().requires_grad_()
    (x64.index_select(0, token_at) * used.double()[:, None]).backward(g.double())
    assert torch.equal(x.grad, x64.grad.to(torch.bfloat16))


@pytest.mark.parametrize("bwd", ["fused", "split"])
def test_loss_and_gradients_match_jax(models, jax_trace_state, bwd):
    """One loss (cross-entropy plus the summed aux loss) and every parameter
    gradient (routers, experts, attention, embeddings), the JAX side
    through the Pallas backward of the same mode as the port's."""
    jcfg, jparams, cfg = models
    inputs, targets = _batch(cfg, 0)
    jattn = dataclasses.replace(JAX_ATTN, bwd=bwd)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: jax_steps.loss_fn(jcfg, jattn, p, b), has_aux=True))
    (jloss, jm), jgrads = grad_fn(jparams, {"inputs": jnp.asarray(inputs),
                                            "targets": jnp.asarray(targets)})

    model = _port_model(cfg, jparams)
    batch = {"inputs": torch.from_numpy(inputs).long(), "targets": torch.from_numpy(targets)}
    loss, metrics = steps.loss_fn(cfg, dataclasses.replace(ATTN, bwd=bwd), model, batch)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **LOSS_TOL)
    assert float(jm["aux_loss"]) > 0
    for key in ("ce_loss", "aux_loss", "nll_sum", "tokens", "accuracy"):
        np.testing.assert_allclose(metrics[key].item(), float(jm[key]), err_msg=key, **LOSS_TOL)
    want = params_from_jax(cfg, jax.tree.map(np.asarray, jgrads))
    got = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    assert any(".mlp.router" in n for n in got)
    for name, g in got.items():
        assert g is not None and bool(g.abs().max() > 0), name
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), err_msg=name, **GRAD_TOL)


def test_three_train_steps_match_jax(models, jax_trace_state):
    """Three AdamW steps of the train step on the synthetic stream: loss,
    gradient norm and learning rate every step."""
    jcfg, jparams, cfg = models
    opt_cfg = dict(warmup_steps=2, total_steps=3, lr=1e-2)
    jstep = jax.jit(jax_steps.build_train_step(jcfg, JAX_ATTN, jax_opt.AdamWConfig(**opt_cfg)))
    jstate = jax_opt.init_opt_state(jparams)
    model = _port_model(cfg, jparams)
    state = optimizer.init_opt_state(dict(model.named_parameters()))
    step_fn = steps.build_train_step(cfg, ATTN, optimizer.AdamWConfig(**opt_cfg))
    jp, want, got = jparams, [], []
    for step in range(3):
        inputs, targets = _batch(cfg, step)
        jp, jstate, jm = jstep(jp, jstate, {"inputs": jnp.asarray(inputs),
                                            "targets": jnp.asarray(targets)})
        want.append([float(jm[k]) for k in ("loss", "grad_norm", "lr")])
        state, m = step_fn(model, state, {"inputs": torch.from_numpy(inputs).long(),
                                          "targets": torch.from_numpy(targets)})
        got.append([m[k] for k in ("loss", "grad_norm", "lr")])
    np.testing.assert_allclose(np.array(got), np.array(want), **LOSS_TOL)
