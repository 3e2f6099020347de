"""Packed (varlen) attention and training at head_dim 256 (gemma3-1b) and
160 (stablelm-12b) on the port against the JAX package on the CPU.

Kernel level: the segment variants' plain versions (the forward, the fused
backward, and the split backward's dK/dV and dQ), which the CUDA ``SEG``
kernels at 256 and 160 are held to on the card, against the segment
branches of the Pallas kernels in interpret mode, on the same numpy
inputs: four q heads over one kv head with packed ids, a window with sinks
at a ragged length, and distinct q and kv ids where a tile sees nothing.
Model level: reduced gemma3-1b at head_dim 256 and stablelm-12b at 160 on a
packed batch of the JAX ``SyntheticVarlenLM``, the JAX side through
``loss_fn`` (``lm.forward(segment_ids=)``) on its Pallas kernels, fused and
split; then three packed AdamW steps at 256."""

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
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticVarlenLM as JaxSyntheticVarlenLM
from repro.kernels.ops import flash_attention_pallas_varlen, flash_attention_pallas_varlen_with_lse
from repro.launch import steps as jax_steps
from repro.models import lm as jax_lm
from repro.training import optimizer as jax_opt
from repro_torch.configs import registry
from repro_torch.core.attention import AttentionConfig
from repro_torch.core.masks import MaskSpec
from repro_torch.kernels import flash_bwd as bwd_mod
from repro_torch.kernels import flash_fwd as fwd_mod
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.models.lm import LM, params_from_jax
from repro_torch.training import optimizer
from test_torch_hd160 import _stablelm_160
from test_torch_hd256_train import _gemma3_256
from test_torch_serving import jax_trace_state  # noqa: F401  (the per-test JAX shim)
from test_torch_train import GRAD_TOL, LOSS_TOL, PACKED_MOVE_TOL

TOL = dict(atol=2e-5, rtol=2e-5)  # f32 on both sides: summation order and tiling only
BLOCK = 32

# name: (B, S, Hq, Hkv, spec, ids): gemma3's and stablelm's grouping (G 4,
# here over one kv head) with packed ids, causal; a window with sinks at a
# ragged S (100: no block divides it); distinct q and kv ids ("distinct").
CASES = {
    "packed_g4": (1, 128, 4, 1, dict(causal=True), "packed"),
    "window_sink_ragged": (1, 100, 4, 1, dict(causal=True, window=40, sink=8), "packed"),
    "distinct": (1, 128, 4, 1, dict(causal=True), "distinct"),
}


def _ids(B, S, kind):
    """(q ids, kv ids) int32 numpy. "packed": three runs with cuts off the
    tile grid and two padding positions at the end. "distinct": q rows
    0-31 (one whole q tile) carry an id no key has and the last 32 keys an
    id no query has, so that q tile gets o = 0, lse = -inf and dq = 0 and
    that kv tile dk = dv = 0."""
    if kind == "packed":
        seg = np.zeros((B, S), np.int32)
        a, b = S // 3 + 5, 2 * S // 3 + 3
        seg[:, :a], seg[:, a:b], seg[:, b:S - 2] = 1, 2, 3
        return seg, seg
    q_seg = np.ones((B, S), np.int32)
    q_seg[:, S // 2:] = 2
    kv_seg = q_seg.copy()
    q_seg[:, :32] = 7
    kv_seg[:, -32:] = 9
    return q_seg, kv_seg


def _inputs(name, D):
    B, S, Hq, Hk, spec_kw, kind = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name) + D)
    q, do = (rng.standard_normal((B, S, Hq, D), dtype=np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, S, Hk, D), dtype=np.float32) for _ in range(2))
    return q, k, v, do, *_ids(B, S, kind), spec_kw


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


@functools.partial(jax.jit, static_argnums=(6, 7))
def _pallas_grads(q, k, v, do, q_seg, kv_seg, spec, bwd):
    f = functools.partial(flash_attention_pallas_varlen, segment_ids=q_seg, spec=spec,
                          kv_segment_ids=kv_seg, block_q=BLOCK, block_kv=BLOCK, interpret=True,
                          bwd=bwd, use_tuned=False)
    o, vjp = jax.vjp(f, q, k, v)
    return (o, *vjp(do))


@pytest.mark.parametrize("D", [256, 160])
@pytest.mark.parametrize("name", list(CASES))
def test_varlen_forward_at_wide_head_dims_matches_pallas(name, D):
    """The segment forward's plain version (``flash_fwd_varlen`` on CPU
    tensors) against the Pallas forward's segment branch: o and lse."""
    q, k, v, _, q_seg, kv_seg, spec_kw = _inputs(name, D)
    o_j, lse_j = flash_attention_pallas_varlen_with_lse(
        q, k, v, jnp.asarray(q_seg), JaxMaskSpec(**spec_kw), kv_segment_ids=jnp.asarray(kv_seg),
        block_q=BLOCK, block_kv=BLOCK, interpret=True, use_tuned=False)
    before = fwd_mod.flash_fwd_plain.calls
    o, lse = ops.flash_attention_varlen_with_lse(
        _t(q), _t(k), _t(v), torch.from_numpy(q_seg), MaskSpec(**spec_kw),
        kv_segment_ids=torch.from_numpy(kv_seg), block_q=BLOCK, block_kv=BLOCK)
    assert fwd_mod.flash_fwd_plain.calls == before + 1
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_array_equal(np.isneginf(lse.numpy()), np.isneginf(np.asarray(lse_j)))
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), **TOL)
    if CASES[name][-1] == "distinct":
        assert (o[:, :32] == 0).all() and torch.isneginf(lse[..., :32]).all()


@pytest.mark.parametrize("bwd", ["fused", "split"])
@pytest.mark.parametrize("D", [256, 160])
@pytest.mark.parametrize("name", list(CASES))
def test_varlen_backward_at_wide_head_dims_matches_pallas(name, D, bwd):
    """The segment backward's plain versions (fused: ``flash_bwd_fused_varlen``;
    split: ``flash_bwd_dkv_varlen`` and ``flash_bwd_dq_varlen``) through the
    port's autograd core against the Pallas kernels' segment branches of the
    same mode: o, dq, dk, dv."""
    q, k, v, do, q_seg, kv_seg, spec_kw = _inputs(name, D)
    want = _pallas_grads(q, k, v, do, jnp.asarray(q_seg), jnp.asarray(kv_seg),
                         JaxMaskSpec(**spec_kw), bwd)
    plains = ((bwd_mod.flash_bwd_fused_plain,) if bwd == "fused"
              else (bwd_mod.flash_bwd_dkv_plain, bwd_mod.flash_bwd_dq_plain))
    before = [f.calls for f in plains]
    qt, kt, vt = (_t(x).requires_grad_() for x in (q, k, v))
    o = ops.flash_attention_varlen(qt, kt, vt, torch.from_numpy(q_seg), MaskSpec(**spec_kw),
                                   kv_segment_ids=torch.from_numpy(kv_seg), block_q=BLOCK,
                                   block_kv=BLOCK, bwd=bwd)
    o.backward(_t(do))
    assert [f.calls - b for f, b in zip(plains, before)] == [1] * len(plains)
    for label, a, b in zip(("o", "dq", "dk", "dv"), (o, qt.grad, kt.grad, vt.grad), want):
        assert np.isfinite(a.detach().numpy()).all(), label
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), err_msg=label, **TOL)
    if CASES[name][-1] == "distinct":
        assert (qt.grad[:, :32] == 0).all()
        assert (kt.grad[:, -32:] == 0).all() and (vt.grad[:, -32:] == 0).all()


# ---------------------------------------------------------------------------
# Reduced gemma3-1b at 256 and stablelm-12b at 160 on packed batches
# ---------------------------------------------------------------------------

B, S = 2, 64  # above gemma3's reduced window (32)
JAX_ATTN = JaxAttentionConfig(impl="flash_pallas", interpret=True, use_tuned=False)
MODELS = {"gemma3_256": _gemma3_256, "stablelm_160": _stablelm_160}


@pytest.fixture(scope="module", params=list(MODELS))
def model_pair(request):
    """(name, JAX config, JAX params, port config) of one reduced model."""
    build = MODELS[request.param]
    jcfg, cfg = build(jax_registry), build(registry)
    assert cfg.head_dim == {"gemma3_256": 256, "stablelm_160": 160}[request.param]
    return request.param, jcfg, jax_lm.init_lm(jcfg, jax.random.PRNGKey(5)), cfg


def _port_model(cfg, jparams):
    model = LM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jparams)))
    return model


def _packed_batch(cfg, step):
    """A packed batch of the JAX package's varlen source (numpy), documents
    of 8 tokens and up so that a row of 64 holds several."""
    return JaxSyntheticVarlenLM(JaxDataConfig(batch_size=B, seq_len=S, vocab_size=cfg.vocab_size,
                                              seed=0, source="packed", min_doc_len=8)).batch(step)


@pytest.mark.parametrize("bwd", ["fused", "split"])
def test_packed_loss_and_gradients_at_wide_head_dims_match_jax(model_pair, jax_trace_state, bwd):
    """One packed loss and its gradients: the JAX side through
    ``lm.forward(segment_ids=)`` and the Pallas varlen kernels of the same
    backward mode, the port through its segment variants at 256 or 160."""
    name, jcfg, jparams, cfg = model_pair
    batch = _packed_batch(cfg, 1)  # 3 and 2 documents, 1 and 2 padding positions
    assert (batch["segment_ids"] == 0).any() and batch["segment_ids"].max() > 2
    jattn = dataclasses.replace(JAX_ATTN, bwd=bwd)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: jax_steps.loss_fn(jcfg, jattn, p, b), has_aux=True))
    (jloss, jm), jgrads = grad_fn(jparams, {k: jnp.asarray(v) for k, v in batch.items()})

    model = _port_model(cfg, jparams)
    plain = (fwd_mod.flash_fwd_plain, bwd_mod.flash_bwd_fused_plain, bwd_mod.flash_bwd_dq_plain)
    before = [f.calls for f in plain]
    loss, metrics = steps.loss_fn(cfg, AttentionConfig(impl="flash_cuda", bwd=bwd), model,
                                  {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    calls = [f.calls - b for f, b in zip(plain, before)]
    assert calls[0] > 0 and (calls[1] > 0) == (bwd == "fused") and (calls[2] > 0) == (bwd == "split")
    np.testing.assert_allclose(loss.item(), float(jloss), **LOSS_TOL)
    for key in ("ce_loss", "nll_sum", "tokens", "accuracy"):
        np.testing.assert_allclose(metrics[key].item(), float(jm[key]), err_msg=key, **LOSS_TOL)
    want = params_from_jax(cfg, jax.tree.map(np.asarray, jgrads))
    got = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    for pname, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[pname].numpy(), err_msg=pname, **GRAD_TOL)


def test_three_packed_train_steps_at_head_dim_256_match_jax(jax_trace_state):
    """Three packed AdamW steps of reduced gemma3-1b at head_dim 256 on both
    sides (the fused backward; the split one is held above): losses,
    gradient norms and learning rates every step, and each parameter tensor
    after the third within PACKED_MOVE_TOL of the distance it moved
    (tests/test_torch_train.py says why)."""
    jcfg, cfg = _gemma3_256(jax_registry), _gemma3_256(registry)
    jparams = jax_lm.init_lm(jcfg, jax.random.PRNGKey(5))
    opt_cfg = dict(warmup_steps=2, total_steps=3, lr=1e-2)
    jstep = jax.jit(jax_steps.build_train_step(jcfg, JAX_ATTN, jax_opt.AdamWConfig(**opt_cfg)))
    jstate = jax_opt.init_opt_state(jparams)
    model = _port_model(cfg, jparams)
    state = optimizer.init_opt_state(dict(model.named_parameters()))
    step_fn = steps.build_train_step(cfg, AttentionConfig(impl="flash_cuda"),
                                     optimizer.AdamWConfig(**opt_cfg))
    jp, want, got = jparams, [], []
    for step in range(3):
        batch = _packed_batch(cfg, step)
        jp, jstate, jm = jstep(jp, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        want.append([float(jm[k]) for k in ("loss", "grad_norm", "lr")])
        state, m = step_fn(model, state, {k: torch.from_numpy(v) for k, v in batch.items()})
        got.append([m[k] for k in ("loss", "grad_norm", "lr")])
    np.testing.assert_allclose(np.array(got), np.array(want), **LOSS_TOL)
    final = params_from_jax(cfg, jax.tree.map(np.asarray, jp))
    start = params_from_jax(cfg, jax.tree.map(np.asarray, jparams))
    for name, p in model.named_parameters():
        moved = np.linalg.norm(final[name].numpy() - start[name].numpy())
        apart = np.linalg.norm(p.detach().numpy() - final[name].numpy())
        assert moved > 0 and apart <= PACKED_MOVE_TOL * moved, (name, apart, moved)
