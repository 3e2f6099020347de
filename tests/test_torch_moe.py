"""The port's MoE layer (``repro_torch/models/moe.py``) against the JAX
package's ``repro/models/moe.py`` on the CPU, in float32, from the same
numpy inputs and weights: the output and the load-balancing loss at
reduced granite-moe-1b-a400m and reduced mixtral-8x22b (the registry cuts
both to 8 experts, top 2), the dispatch bookkeeping to the integer, with
and without dropped tokens, and the capacity rule."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.models import moe as jax_moe
from repro_torch.configs import registry
from repro_torch.models import moe

# f32 on both sides: the router and expert products and the f32 combine
# differ in summation order only.
RTOL = 1e-5
ARCHS = ["granite-moe-1b-a400m", "mixtral-8x22b"]


def _configs(name, capacity_factor=None):
    jcfg = jax_registry.reduce_config(jax_registry.get(name))
    cfg = registry.reduce_config(registry.get(name))
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity_factor))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    return jcfg, cfg


def _layer(cfg, params):
    layer = moe.MoE(cfg, "cpu", torch.float32)
    layer.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in params.items()})
    return layer


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rtol * scale, np.abs(got - want).max() / scale


@pytest.mark.parametrize("capacity_factor", [None, 0.5], ids=["reduced", "cf0.5"])
@pytest.mark.parametrize("name", ARCHS)
def test_moe_layer_matches_jax(name, capacity_factor):
    """y and aux of ``MoE.forward`` against ``apply_moe`` (no mesh), and the
    dispatch integers (``token_of``, ``dest``, ``keep``, ``order``) exactly
    against ``_dispatch_indices`` on the same assignments. At
    ``capacity_factor`` 0.5 experts overflow: tokens must be dropped, and
    the result still matches."""
    jcfg, cfg = _configs(name, capacity_factor)
    m = cfg.moe
    params = jax_moe.init_moe(jax.random.PRNGKey(1), jcfg, jnp.float32)
    x = np.random.default_rng(0).standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    y_j, aux_j = jax_moe.apply_moe(params, jcfg, jnp.asarray(x))
    with torch.no_grad():
        y, aux = _layer(cfg, params)(torch.from_numpy(x))
    _close(y.numpy(), y_j)
    _close(float(aux), float(aux_j))

    T = x.shape[0] * x.shape[1]
    cap = moe.capacity(m, T)
    assert cap == jax_moe._capacity(jcfg.moe, T)
    logits_j = jax_moe._route(params["router"], jnp.asarray(x.reshape(T, -1)))
    _, top_e_j = jax.lax.top_k(logits_j, m.top_k)
    with torch.no_grad():
        logits = moe.route(torch.from_numpy(np.array(params["router"])),
                           torch.from_numpy(x.reshape(T, -1)))
    top_e = torch.topk(logits, m.top_k, dim=-1)[1]
    assert (top_e.numpy() == np.asarray(top_e_j)).all()
    want = jax_moe._dispatch_indices(top_e_j.reshape(-1).astype(jnp.int32), m.num_experts,
                                     0, m.num_experts, cap, m.top_k)
    got = moe.dispatch_indices(top_e.reshape(-1), 0, m.num_experts, cap, m.top_k)
    for w, g in zip(want, got[:4]):
        assert (np.asarray(w) == g.numpy()).all()
    dropped = int((~got[2]).sum())
    if capacity_factor == 0.5:
        assert dropped > 0
    else:
        assert dropped == 0


@pytest.mark.parametrize("e_lo,E_local", [(0, 8), (2, 3), (5, 3), (0, 1)])
@pytest.mark.parametrize("cap", [4, 8])
def test_dispatch_indices_match_jax_with_foreign_experts(e_lo, E_local, cap):
    """The bookkeeping for a slice of the experts (the expert-parallel
    shard's view): assignments to experts outside [e_lo, e_lo + E_local)
    sort last and are never kept; ``rank`` inverts ``order``."""
    k, n_tok = 2, 40
    rng = np.random.default_rng(e_lo * 10 + cap)
    flat_e = np.stack([rng.choice(8, k, replace=False) for _ in range(n_tok)]).reshape(-1)
    want = jax_moe._dispatch_indices(jnp.asarray(flat_e, jnp.int32), 8, e_lo, E_local, cap, k)
    got = moe.dispatch_indices(torch.from_numpy(flat_e), e_lo, E_local, cap, k)
    for w, g in zip(want, got[:4]):
        assert (np.asarray(w) == g.numpy()).all()
    order, rank = got[3], got[4]
    assert (order[rank] == torch.arange(len(flat_e))).all()


@pytest.mark.parametrize("T", [1, 4, 8, 37, 1536, 6144])
@pytest.mark.parametrize("name", ARCHS)
def test_capacity_matches_jax(name, T):
    """At the published configs (granite: 32 experts top 8, mixtral: 8 top
    2, capacity_factor 1.25) and the reduced ones."""
    for jcfg, cfg in ((jax_registry.get(name), registry.get(name)), _configs(name)):
        assert moe.capacity(cfg.moe, T) == jax_moe._capacity(jcfg.moe, T)


def test_moe_config_mirrors_the_jax_one():
    """Field for field, the published and the reduced granite config's MoE."""
    for jcfg, cfg in ((jax_registry.get(ARCHS[0]), registry.get(ARCHS[0])), _configs(ARCHS[0])):
        assert dataclasses.asdict(cfg.moe) == dataclasses.asdict(jcfg.moe)
    m = registry.get(ARCHS[0]).moe
    assert (m.num_experts, m.top_k, m.d_expert, m.capacity_factor, m.router_aux_weight) == (
        32, 8, 512, 1.25, 0.01)
    assert registry.reduce_config(registry.get(ARCHS[0])).moe.capacity_factor == 2.0


def test_router_stays_float32_in_a_bf16_model():
    """The JAX ``init_moe`` keeps the router in float32 whatever the model's
    dtype; the experts take the model's. Std rules: 1/sqrt(d) for the
    router, gate and up, 1/sqrt(d_expert) for down."""
    cfg = dataclasses.replace(registry.get(ARCHS[0]), num_layers=1)
    layer = moe.MoE(cfg, "cpu", torch.bfloat16)
    with torch.no_grad():
        layer.init_(torch.Generator().manual_seed(0))
    assert layer.router.dtype == torch.float32
    assert {p.dtype for n, p in layer.named_parameters() if n != "router"} == {torch.bfloat16}
    d, de = cfg.d_model, cfg.moe.d_expert
    for name, std in (("router", d ** -0.5), ("we_gate", d ** -0.5), ("we_up", d ** -0.5),
                      ("we_down", de ** -0.5)):
        assert abs(getattr(layer, name).float().std().item() / std - 1) < 0.02, name


def test_bf16_layer_keeps_the_activation_dtype():
    """A bf16 call returns bf16 (the f32 combine is cast back) and equals
    the f32 layer on the same weights up to bf16 rounding."""
    _, cfg = _configs(ARCHS[0])
    layer = moe.MoE(cfg, "cpu", torch.float32)
    with torch.no_grad():
        layer.init_(torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 8, cfg.d_model),
                                                                 ).astype(np.float32))
    with torch.no_grad():
        y32, _ = layer(x, with_aux=False)
        bf = moe.MoE(cfg, "cpu", torch.bfloat16)
        bf.load_state_dict(layer.state_dict())
        y16, aux = bf(x.bfloat16(), with_aux=False)
    assert aux is None and y16.dtype == torch.bfloat16
    assert (y16.float() - y32).abs().max() <= 0.05 * y32.abs().max()


def test_padding_tokens_compete_for_capacity():
    """T counts every token of the call: the same real tokens followed by
    240 padding rows (one repeated vector, as a padding token's embedding
    is) get a capacity of 16 in place of 4 and keep what the tighter call
    drops. Both packages agree on each call."""
    jcfg, cfg = _configs(ARCHS[0], capacity_factor=0.25)
    params = jax_moe.init_moe(jax.random.PRNGKey(2), jcfg, jnp.float32)
    layer = _layer(cfg, params)
    rng = np.random.default_rng(3)
    real = rng.standard_normal((1, 16, cfg.d_model)).astype(np.float32)
    pad_row = rng.standard_normal((1, 1, cfg.d_model)).astype(np.float32)
    outs = []
    for pad in (0, 240):
        x = np.concatenate([real, np.repeat(pad_row, pad, axis=1)], axis=1)
        y_j, _ = jax_moe.apply_moe(params, jcfg, jnp.asarray(x))
        with torch.no_grad():
            y, _ = layer(torch.from_numpy(x), with_aux=False)
        _close(y.numpy(), y_j)
        outs.append(y[:, :16].numpy())
    assert not np.allclose(outs[0], outs[1])
