"""The dense tile schedule at head_dim 256 (gemma3-1b) and 160 (stablelm-12b)
on the port against the JAX package's dense Pallas kernels on the CPU.

Kernel level: the dense plain versions (the forward, the fused backward,
and the split backward's dK/dV and dQ), which the CUDA ``DENSE`` kernels at
256 and 160 are held to on the card, against the dense bodies of the Pallas
kernels in interpret mode (``use_tuned=False``, ``schedule="dense"``), on
the same numpy inputs: four q heads over one kv head, causal; a window with
sinks at a ragged length; each without and with segment ids; and distinct q
and kv ids where a tile sees nothing. The dense plain versions are also the
compact ones to the bit, as the kernels are on the card. Model level:
reduced gemma3-1b at 256 and stablelm-12b at 160, loss and gradients with
``schedule="dense"`` against the JAX ``loss_fn`` on its dense Pallas
kernels, fused and split."""

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
from repro.kernels import flash_bwd as jax_bwd
from repro.kernels.ops import (flash_attention_pallas, flash_attention_pallas_varlen,
                               flash_attention_pallas_varlen_with_lse,
                               flash_attention_pallas_with_lse)
from repro.launch import steps as jax_steps
from repro.models import lm as jax_lm
from repro_torch.configs import registry
from repro_torch.core.attention import AttentionConfig
from repro_torch.core.masks import MaskSpec, pad_segments
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels import flash_bwd as bwd_mod
from repro_torch.kernels import flash_fwd as fwd_mod
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.models.lm import LM, params_from_jax
from test_torch_flash_bwd import _heads
from test_torch_hd160 import _stablelm_160
from test_torch_hd256_train import _gemma3_256
from test_torch_packed_wide import _ids
from test_torch_serving import jax_trace_state  # noqa: F401  (the per-test JAX shim)
from test_torch_train import GRAD_TOL, LOSS_TOL

TOL = dict(atol=2e-5, rtol=2e-5)  # f32 on both sides: summation order and tiling only
BLOCK = 32

# name: (B, S, Hq, Hkv, spec, ids): gemma3's and stablelm's grouping (G 4,
# here over one kv head), causal; a window with sinks at a ragged S (100: no
# block divides it; tiles past the window hidden); each without segment ids
# (None) and with packed ids; distinct q and kv ids ("distinct": a whole q
# tile and a whole kv tile that see nothing).
CASES = {
    "causal_g4": (1, 128, 4, 1, dict(causal=True), None),
    "causal_g4_packed": (1, 128, 4, 1, dict(causal=True), "packed"),
    "window_sink_ragged": (1, 100, 4, 1, dict(causal=True, window=40, sink=8), None),
    "window_sink_ragged_packed": (1, 100, 4, 1, dict(causal=True, window=40, sink=8), "packed"),
    "distinct": (1, 128, 4, 1, dict(causal=True), "distinct"),
}


def _inputs(name, D):
    """q, k, v, dO (f32 numpy), (q ids, kv ids) or None, spec kwargs."""
    B, S, Hq, Hk, spec_kw, kind = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name) + D)
    q, do = (rng.standard_normal((B, S, Hq, D), dtype=np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, S, Hk, D), dtype=np.float32) for _ in range(2))
    return q, k, v, do, None if kind is None else _ids(B, S, kind), spec_kw


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


@functools.partial(jax.jit, static_argnums=(6, 7))
def _pallas_dense_grads(q, k, v, do, q_seg, kv_seg, spec, bwd):
    kw = dict(spec=spec, block_q=BLOCK, block_kv=BLOCK, interpret=True, bwd=bwd,
              use_tuned=False, schedule="dense")
    if q_seg is None:
        f = functools.partial(flash_attention_pallas, **kw)
    else:
        f = functools.partial(flash_attention_pallas_varlen, segment_ids=q_seg,
                              kv_segment_ids=kv_seg, **kw)
    o, vjp = jax.vjp(f, q, k, v)
    return (o, *vjp(do))


@pytest.mark.parametrize("D", [256, 160])
@pytest.mark.parametrize("name", list(CASES))
def test_dense_forward_at_wide_head_dims_matches_pallas(name, D):
    """The dense forward's plain version (``flash_fwd`` or
    ``flash_fwd_varlen`` on CPU tensors with ``schedule="dense"``) against
    the Pallas dense forward: o and lse."""
    q, k, v, _, ids, spec_kw = _inputs(name, D)
    jkw = dict(block_q=BLOCK, block_kv=BLOCK, interpret=True, use_tuned=False, schedule="dense")
    kw = dict(block_q=BLOCK, block_kv=BLOCK, schedule="dense")
    before = fwd_mod.flash_fwd_plain.calls
    if ids is None:
        o_j, lse_j = flash_attention_pallas_with_lse(q, k, v, JaxMaskSpec(**spec_kw), **jkw)
        o, lse = ops.flash_attention_with_lse(_t(q), _t(k), _t(v), MaskSpec(**spec_kw), **kw)
    else:
        o_j, lse_j = flash_attention_pallas_varlen_with_lse(
            q, k, v, jnp.asarray(ids[0]), JaxMaskSpec(**spec_kw),
            kv_segment_ids=jnp.asarray(ids[1]), **jkw)
        o, lse = ops.flash_attention_varlen_with_lse(
            _t(q), _t(k), _t(v), torch.from_numpy(ids[0]), MaskSpec(**spec_kw),
            kv_segment_ids=torch.from_numpy(ids[1]), **kw)
    assert fwd_mod.flash_fwd_plain.calls == before + 1
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_array_equal(np.isneginf(lse.numpy()), np.isneginf(np.asarray(lse_j)))
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), **TOL)
    if name == "distinct":
        assert (o[:, :32] == 0).all() and torch.isneginf(lse[..., :32]).all()


@pytest.mark.parametrize("bwd", ["fused", "split"])
@pytest.mark.parametrize("D", [256, 160])
@pytest.mark.parametrize("name", list(CASES))
def test_dense_backward_at_wide_head_dims_matches_pallas(name, D, bwd):
    """The dense backward's plain versions (fused: ``flash_bwd_fused``;
    split: ``flash_bwd_dkv`` and ``flash_bwd_dq``; their ``_varlen`` forms
    with ids) through the port's autograd core with ``schedule="dense"``
    against the Pallas dense kernels of the same mode: o, dq, dk, dv."""
    q, k, v, do, ids, spec_kw = _inputs(name, D)
    jids = (None, None) if ids is None else tuple(jnp.asarray(x) for x in ids)
    want = _pallas_dense_grads(q, k, v, do, *jids, JaxMaskSpec(**spec_kw), bwd)
    plains = ((bwd_mod.flash_bwd_fused_plain,) if bwd == "fused"
              else (bwd_mod.flash_bwd_dkv_plain, bwd_mod.flash_bwd_dq_plain))
    before = [f.calls for f in plains]
    qt, kt, vt = (_t(x).requires_grad_() for x in (q, k, v))
    kw = dict(block_q=BLOCK, block_kv=BLOCK, bwd=bwd, schedule="dense")
    if ids is None:
        o = ops.flash_attention(qt, kt, vt, MaskSpec(**spec_kw), **kw)
    else:
        o = ops.flash_attention_varlen(qt, kt, vt, torch.from_numpy(ids[0]), MaskSpec(**spec_kw),
                                       kv_segment_ids=torch.from_numpy(ids[1]), **kw)
    o.backward(_t(do))
    assert [f.calls - b for f, b in zip(plains, before)] == [1] * len(plains)
    for label, a, b in zip(("o", "dq", "dk", "dv"), (o, qt.grad, kt.grad, vt.grad), want):
        assert np.isfinite(a.detach().numpy()).all(), label
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), err_msg=label, **TOL)
    if name == "distinct":
        assert (qt.grad[:, :32] == 0).all()
        assert (kt.grad[:, -32:] == 0).all() and (vt.grad[:, -32:] == 0).all()


def _port_args(name, D):
    """(q pre-scaled, k, v, dO, lse, delta, spec, *ids) as CPU tensors, lse
    and delta from the port's dense forward; and the numpy inputs."""
    q, k, v, do, ids, spec_kw = _inputs(name, D)
    q = q / np.sqrt(D, dtype=np.float32)
    spec = MaskSpec(**spec_kw)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    seg = () if ids is None else tuple(torch.from_numpy(x) for x in ids)
    tiles = dict(block_q=BLOCK, block_kv=BLOCK, schedule="dense")
    fwd = fwd_mod.flash_fwd_varlen if seg else fwd_mod.flash_fwd
    o, lse = fwd(tq, tk, tv, spec, *seg, **tiles)
    return (tq, tk, tv, tdo, lse, bwd_mod.flash_bwd_delta(o, tdo), spec, *seg), (q, k, v, do)


@pytest.mark.parametrize("D", [256, 160])
@pytest.mark.parametrize("name", list(CASES))
def test_dense_dkv_and_dq_at_wide_head_dims_match_pallas_kernels(name, D):
    """``flash_bwd_dkv`` and ``flash_bwd_dq`` (``_varlen`` with ids) called
    directly with ``schedule="dense"`` on CPU tensors against the JAX dense
    dK/dV and dQ kernels on the heads layout, from the same pre-scaled q,
    lse and delta (ids padded with the sentinels, as the JAX wrapper pads
    them)."""
    args, (q, k, v, do) = _port_args(name, D)
    seg = args[7:]
    tiles = dict(block_q=BLOCK, block_kv=BLOCK, schedule="dense")
    dkv_fn = bwd_mod.flash_bwd_dkv_varlen if seg else bwd_mod.flash_bwd_dkv
    dq_fn = bwd_mod.flash_bwd_dq_varlen if seg else bwd_mod.flash_bwd_dq
    dk, dv = dkv_fn(*args, **tiles)
    dq = dq_fn(*args, **tiles)
    B, S, Hq, _, _, _ = CASES[name]
    Hk = k.shape[2]
    Sp = -(-S // BLOCK) * BLOCK
    lse = args[4]
    lse_s = torch.where(torch.isneginf(lse), torch.zeros_like(lse), lse)
    lanes = lambda x: np.pad(x.reshape(B * Hq, S).numpy(), ((0, 0), (0, Sp - S)))
    jargs = (_heads(q, Sp), _heads(k, Sp), _heads(v, Sp), _heads(do, Sp), lanes(lse_s),
             lanes(args[5]))
    kw = dict(group=Hq // Hk, block_q=BLOCK, block_kv=BLOCK, kv_valid=S, interpret=True,
              schedule="dense")
    if seg:
        q_seg, kv_seg = pad_segments(*seg, Sp, Sp)
        kw.update(q_seg=jnp.asarray(q_seg.numpy()), kv_seg=jnp.asarray(kv_seg.numpy()))
    jspec = JaxMaskSpec(**CASES[name][4])
    jdk, jdv = jax_bwd.flash_bwd_dkv(*jargs, jspec, **kw)
    jdq = jax_bwd.flash_bwd_dq(*jargs, jspec, **kw)
    unheads = lambda x, H: np.asarray(x)[:, :S].reshape(B, H, S, D).transpose(0, 2, 1, 3)
    # dq is with respect to the pre-scaled q; times the scale it is the
    # gradient of the model's q that the autograd tests above compare (at
    # 256 the kernels' dq is 16 times it, and so is its f32 rounding).
    scale = np.float32(1 / np.sqrt(D))
    for label, a, b in (("dq", dq * scale, unheads(jdq, Hq) * scale),
                        ("dk", dk, unheads(jdk, Hk)), ("dv", dv, unheads(jdv, Hk))):
        assert a.dtype == torch.float32 and a.shape == b.shape, label
        np.testing.assert_allclose(a.numpy(), b, err_msg=label, **TOL)


@pytest.mark.parametrize("D", [256, 160])
@pytest.mark.parametrize("name", list(CASES))
def test_dense_plain_versions_at_wide_head_dims_are_the_compact_ones(name, D):
    """Every dense plain version (forward, fused, dK/dV, dQ; with ids their
    segment forms) gives the compact one's outputs to the bit at 256 and
    160: the invariant the CUDA kernels keep on the card."""
    args, _ = _port_args(name, D)
    q, k, v, spec, seg = args[0], args[1], args[2], args[6], args[7:]
    tiles = dict(block_q=BLOCK, block_kv=BLOCK)
    sfx = "_varlen" if seg else ""
    fwd = getattr(fwd_mod, "flash_fwd" + sfx)
    pairs = [(fwd(q, k, v, spec, *seg, schedule="dense", **tiles),
              fwd(q, k, v, spec, *seg, **tiles))]
    for n in ("fused", "dkv", "dq"):
        fn = getattr(bwd_mod, f"flash_bwd_{n}{sfx}")
        pairs.append((fn(*args, schedule="dense", **tiles), fn(*args, **tiles)))
    for i, (dense, compact) in enumerate(pairs):
        dense = dense if isinstance(dense, tuple) else (dense,)
        compact = compact if isinstance(compact, tuple) else (compact,)
        assert all(torch.equal(a, b) for a, b in zip(dense, compact)), i


# ---------------------------------------------------------------------------
# Reduced gemma3-1b at 256 and stablelm-12b at 160, schedule="dense"
# ---------------------------------------------------------------------------

B, S = 2, 64  # above gemma3's reduced window (32): windowed layers hide tiles
JAX_DENSE = JaxAttentionConfig(impl="flash_pallas", interpret=True, use_tuned=False,
                               schedule="dense")
MODELS = {"gemma3_256": _gemma3_256, "stablelm_160": _stablelm_160}


@pytest.fixture(scope="module", params=list(MODELS))
def model_pair(request):
    """(JAX config, JAX params, port config) of one reduced model."""
    build = MODELS[request.param]
    jcfg, cfg = build(jax_registry), build(registry)
    assert cfg.head_dim == {"gemma3_256": 256, "stablelm_160": 160}[request.param]
    return jcfg, jax_lm.init_lm(jcfg, jax.random.PRNGKey(7)), cfg


@pytest.mark.parametrize("bwd", ["fused", "split"])
def test_dense_loss_and_gradients_at_wide_head_dims_match_jax(model_pair, jax_trace_state, bwd):
    """One loss and its gradients with ``schedule="dense"``: the JAX side
    through ``loss_fn`` on its dense Pallas kernels of the same backward
    mode, the port through its dense plain versions at 256 or 160."""
    jcfg, jparams, cfg = model_pair
    inputs, targets = SyntheticLM(DataConfig(batch_size=B, seq_len=S,
                                             vocab_size=cfg.vocab_size)).batch(0)
    jattn = dataclasses.replace(JAX_DENSE, bwd=bwd)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: jax_steps.loss_fn(jcfg, jattn, p, b), has_aux=True))
    (jloss, _), jgrads = grad_fn(jparams, {"inputs": jnp.asarray(inputs),
                                           "targets": jnp.asarray(targets)})
    model = LM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jparams)))
    plains = (fwd_mod.flash_fwd_plain, bwd_mod.flash_bwd_fused_plain, bwd_mod.flash_bwd_dq_plain)
    before = [f.calls for f in plains]
    attn = AttentionConfig(impl="flash_cuda", bwd=bwd, schedule="dense")
    loss, _ = steps.loss_fn(cfg, attn, model, {"inputs": torch.from_numpy(inputs).long(),
                                               "targets": torch.from_numpy(targets)})
    loss.backward()
    calls = [f.calls - b for f, b in zip(plains, before)]
    assert calls[0] > 0
    assert (calls[1] > 0) == (bwd == "fused") and (calls[2] > 0) == (bwd == "split")
    np.testing.assert_allclose(loss.item(), float(jloss), **LOSS_TOL)
    want = params_from_jax(cfg, jax.tree.map(np.asarray, jgrads))
    got = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    for pname, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[pname].numpy(), err_msg=pname, **GRAD_TOL)
