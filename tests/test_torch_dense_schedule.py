"""The port's dense tile schedule (``schedule="dense"``) against the JAX
package's dense Pallas kernels: the tile classifier, the forward, the fused
and split backward and the dK/dV and dQ kernels called directly, their
segment (varlen) forms, the knob rules, and train steps of reduced qwen3.
The Pallas side runs in interpret mode (``use_tuned=False``); on the CPU the
port runs its kernels' plain versions, whose dense walk classifies every
tile as the CUDA kernels do (tests/test_torch_kernels_gpu.py holds the dense
kernels against them and against the compact kernels on the card). Inputs
come from numpy seeds."""

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
from repro.kernels.flash_fwd import _visibility as jax_visibility
from repro.kernels.ops import (flash_attention_pallas, flash_attention_pallas_varlen,
                               flash_attention_pallas_varlen_with_lse,
                               flash_attention_pallas_with_lse)
from repro.launch import steps as jax_steps
from repro.models import lm as jax_lm
from repro.training import optimizer as jax_opt
from repro_torch.configs import registry
from repro_torch.core.attention import AttentionConfig
from repro_torch.core.masks import MaskSpec, pad_segments
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels import flash_bwd as bwd_mod
from repro_torch.kernels import flash_fwd as fwd_mod
from repro_torch.kernels import ops
from repro_torch.kernels.schedule import (SEG_ACTIVE, SEG_UNIFORM, _tile_class,
                                          build_q_tile_schedule, segment_step_bits)
from repro_torch.launch import steps
from repro_torch.models.lm import LM, params_from_jax
from repro_torch.training import optimizer
from test_torch_flash_bwd import CASES as BWD_CASES
from test_torch_flash_bwd import _heads
from test_torch_flash_fwd import CASES as FWD_CASES
from test_torch_serving import jax_trace_state  # noqa: F401  (the per-test JAX shim)
from test_torch_train import GRAD_TOL, LOSS_TOL, PARAM_TOL
from test_torch_varlen import CASES as VARLEN_CASES
from test_torch_varlen import _segments

# f32 on both sides: the differences are summation order and tiling only.
TOL_F32 = dict(atol=2e-5, rtol=2e-5)
# bf16 inputs: both round P (and dS) to bf16 at the same places, but a value
# near a rounding boundary can land one bf16 ulp (0.8% near 1) apart.
TOL_BF16 = dict(atol=2e-2, rtol=2e-2)
FWD_D, FWD_BLOCK = 16, 16
BWD_D, BWD_BLOCK = 16, 32


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


def _f32(x):
    return np.asarray(x.detach().float() if torch.is_tensor(x) else jnp.asarray(x, jnp.float32))


# ------------------------------------------------------------ (a) classifier


def _geometries(case):
    """(bq, bk, kv_valid) of a forward case: its own tiles, and 8 x 16 tiles
    over a kv length cut so that the last kv tile is ragged."""
    return [(FWD_BLOCK, FWD_BLOCK, case.Skv), (8, 16, case.Skv - 3)]


@pytest.mark.parametrize("case", FWD_CASES, ids=lambda c: c.name)
def test_visibility_is_jax_visibility_and_the_compact_class(case):
    """Every (i, j) tile: the port's visibility equals the JAX _visibility
    (evaluated eagerly on Python ints) and the compact schedule's
    classification: empty iff _tile_class says spec-empty, needs_mask iff
    it says masked."""
    spec, jspec = MaskSpec(**case.spec), JaxMaskSpec(**case.spec)
    for bq, bk, kv_valid in _geometries(case):
        t_q, t_kv = -(-case.Sq // bq), -(-kv_valid // bk)
        for i in range(t_q):
            for j in range(t_kv):
                empty, needs = fwd_mod.visibility(spec, i, j, bq, bk, kv_valid)
                je, jn = jax_visibility(jspec, i, j, bq, bk, kv_valid)
                assert (empty, needs) == (bool(je), bool(jn)), (bq, bk, kv_valid, i, j)
                cls = _tile_class(spec, i, j, bq, bk, kv_valid)
                assert empty == (cls is None), (i, j)
                if not empty:
                    assert needs == cls, (i, j)


@pytest.mark.parametrize("case", FWD_CASES, ids=lambda c: c.name)
def test_visibility_with_ids_is_jax_and_the_segment_bits(case):
    """With id tiles (sentinel-padded, one batch row at a time): the port's
    visibility equals the JAX _visibility, and on every spec-visible tile
    not empty is SEG_ACTIVE and not needs_mask is SEG_UNIFORM and not
    masked, the compact schedule's step bits."""
    spec, jspec = MaskSpec(**case.spec), JaxMaskSpec(**case.spec)
    for bq, bk, kv_valid in _geometries(case):
        Sq, B = case.Sq, 2
        t_q, t_kv = -(-Sq // bq), -(-kv_valid // bk)
        q_seg = torch.from_numpy(_segments(B, Sq, 3, seed=Sq + bq, pad=False))
        kv_seg = torch.from_numpy(_segments(B, kv_valid, 3, seed=kv_valid, pad=False))
        if Sq == kv_valid:
            kv_seg = q_seg
        qs, ks = pad_segments(q_seg, kv_seg, t_q * bq, t_kv * bk)
        qt, kt = qs.reshape(B, t_q, bq).numpy(), ks.reshape(B, t_kv, bk).numpy()
        csr = build_q_tile_schedule(spec, t_q, t_kv, bq, bk, kv_valid)
        bits = segment_step_bits(q_seg, kv_seg, csr, bq, bk, kv_major=False).numpy()
        step = {pair: s for s, pair in enumerate(csr.pairs())}
        for b in range(B):
            for i in range(t_q):
                for j in range(t_kv):
                    empty, needs = fwd_mod.visibility(spec, i, j, bq, bk, kv_valid, qt[b, i],
                                                      kt[b, j])
                    je, jn = jax_visibility(jspec, i, j, bq, bk, kv_valid,
                                            jnp.asarray(qt[b, i]), jnp.asarray(kt[b, j]))
                    assert (empty, needs) == (bool(je), bool(jn)), (bq, bk, b, i, j)
                    if (i, j) not in step:
                        assert empty
                        continue
                    s = step[(i, j)]
                    assert (not empty) == bool(bits[b, s] & SEG_ACTIVE), (b, i, j)
                    assert (not needs) == (bool(bits[b, s] & SEG_UNIFORM)
                                           and not csr.masked[s]), (b, i, j)


# ----------------------------------------------------------- (b) forward


def _fwd_inputs(case, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((case.B, case.Sq, case.Hq, FWD_D), dtype=np.float32)
    k = rng.standard_normal((case.B, case.Skv, case.Hkv, FWD_D), dtype=np.float32)
    v = rng.standard_normal((case.B, case.Skv, case.Hkv, FWD_D), dtype=np.float32)
    return q, k, v


def _pallas_dense_fwd(q, k, v, jspec, bq, bk):
    return flash_attention_pallas_with_lse(q, k, v, jspec, block_q=bq, block_kv=bk,
                                           interpret=True, use_tuned=False, schedule="dense")


@pytest.mark.parametrize("case", FWD_CASES, ids=lambda c: c.name)
def test_dense_forward_matches_pallas_dense(case):
    """The dense forward against the JAX dense kernel, and to the bit the
    port's compact forward."""
    q, k, v = _fwd_inputs(case)
    spec = MaskSpec(**case.spec)
    args = (_t(q), _t(k), _t(v), spec)
    o, lse = ops.flash_attention_with_lse(*args, block_q=FWD_BLOCK, block_kv=FWD_BLOCK,
                                          schedule="dense")
    o_p, lse_p = _pallas_dense_fwd(q, k, v, JaxMaskSpec(**case.spec), FWD_BLOCK, FWD_BLOCK)
    np.testing.assert_allclose(_f32(o), _f32(o_p), **TOL_F32)
    np.testing.assert_allclose(_f32(lse), _f32(lse_p), **TOL_F32)
    o_c, lse_c = ops.flash_attention_with_lse(*args, block_q=FWD_BLOCK, block_kv=FWD_BLOCK)
    assert torch.equal(o, o_c) and torch.equal(lse, lse_c)


@pytest.mark.parametrize("case", [FWD_CASES[1], FWD_CASES[4]], ids=lambda c: c.name)
def test_dense_forward_bf16_matches_pallas_dense(case):
    q, k, v = _fwd_inputs(case, seed=1)
    qb, kb, vb = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    o, lse = ops.flash_attention_with_lse(
        *(_t(x, torch.bfloat16) for x in (q, k, v)), MaskSpec(**case.spec), block_q=FWD_BLOCK,
        block_kv=FWD_BLOCK, schedule="dense")
    o_p, lse_p = _pallas_dense_fwd(qb, kb, vb, JaxMaskSpec(**case.spec), FWD_BLOCK, FWD_BLOCK)
    assert o.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(o), _f32(o_p), **TOL_BF16)
    np.testing.assert_allclose(_f32(lse), _f32(lse_p), **TOL_BF16)


# ---------------------------------------------------------- (c) backward


def _bwd_inputs(case, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    shapes = [(case.B, case.S, case.Hq, BWD_D), (case.B, case.S, case.Hkv, BWD_D),
              (case.B, case.S, case.Hkv, BWD_D), (case.B, case.S, case.Hq, BWD_D)]
    return tuple(rng.standard_normal(s, dtype=np.float32).astype(dtype) for s in shapes)


@functools.partial(jax.jit, static_argnums=(4, 5))
def _pallas_dense_grads(q, k, v, do, spec, bwd):
    f = functools.partial(flash_attention_pallas, spec=spec, block_q=BWD_BLOCK,
                          block_kv=BWD_BLOCK, interpret=True, bwd=bwd, use_tuned=False,
                          schedule="dense")
    o, vjp = jax.vjp(f, q, k, v)
    return (o, *vjp(do))


def _port_grads(q, k, v, do, spec, schedule, bwd, dtype=torch.float32, seg=None):
    qt, kt, vt = (_t(x, dtype).requires_grad_() for x in (q, k, v))
    kw = dict(block_q=BWD_BLOCK, block_kv=BWD_BLOCK, bwd=bwd, schedule=schedule)
    if seg is None:
        o = ops.flash_attention(qt, kt, vt, spec, **kw)
    else:
        o = ops.flash_attention_varlen(qt, kt, vt, torch.from_numpy(seg), spec, **kw)
    o.backward(_t(do, dtype))
    return o, qt.grad, kt.grad, vt.grad


@pytest.mark.parametrize("bwd", ops.BWD_MODES)
@pytest.mark.parametrize("case", BWD_CASES, ids=lambda c: c.name)
def test_dense_backward_matches_pallas_dense(case, bwd):
    """Output and gradients through the dense kernels, fused or split,
    against the JAX dense kernels of the same mode; and to the bit the
    port's compact run."""
    q, k, v, do = _bwd_inputs(case)
    spec = MaskSpec(**case.spec)
    ours = _port_grads(q, k, v, do, spec, "dense", bwd)
    theirs = _pallas_dense_grads(q, k, v, do, JaxMaskSpec(**case.spec), bwd)
    for name, a, b in zip(("o", "dq", "dk", "dv"), ours, theirs):
        assert a.dtype == torch.float32 and np.isfinite(_f32(a)).all(), name
        np.testing.assert_allclose(_f32(a), _f32(b), err_msg=name, **TOL_F32)
    compact = _port_grads(q, k, v, do, spec, "compact", bwd)
    for name, a, b in zip(("o", "dq", "dk", "dv"), ours, compact):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("case", [BWD_CASES[3], BWD_CASES[5]], ids=lambda c: c.name)
def test_dense_backward_bf16_matches_pallas_dense(case):
    q, k, v, do = _bwd_inputs(case, seed=1)
    qb, kb, vb, dob = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    ours = _port_grads(qb, kb, vb, dob, MaskSpec(**case.spec), "dense", "fused", torch.bfloat16)
    theirs = _pallas_dense_grads(qb, kb, vb, dob, JaxMaskSpec(**case.spec), "fused")
    for name, a, b in zip(("o", "dq", "dk", "dv"), ours, theirs):
        assert a.dtype == torch.bfloat16, name
        np.testing.assert_allclose(_f32(a), _f32(b), err_msg=name, **TOL_BF16)


@pytest.mark.parametrize("case", [BWD_CASES[2], BWD_CASES[5], BWD_CASES[6], BWD_CASES[-1]],
                         ids=lambda c: c.name)
def test_dense_dkv_and_dq_match_pallas_dense_kernels(case):
    """flash_bwd_dkv and flash_bwd_dq with schedule="dense" on CPU tensors
    (their plain dense walks) against the JAX dense dK/dV and dQ kernels on
    the heads layout, from the same pre-scaled q, lse and delta; and to the
    bit the compact plain versions."""
    q, k, v, do = _bwd_inputs(case, seed=5)
    q = q / np.sqrt(BWD_D, dtype=np.float32)
    spec, jspec = MaskSpec(**case.spec), JaxMaskSpec(**case.spec)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    tiles = dict(block_q=BWD_BLOCK, block_kv=BWD_BLOCK)
    o, lse = fwd_mod.flash_fwd(tq, tk, tv, spec, schedule="dense", **tiles)
    delta = bwd_mod.flash_bwd_delta(o, tdo)
    args = (tq, tk, tv, tdo, lse, delta, spec)
    dk, dv = bwd_mod.flash_bwd_dkv(*args, schedule="dense", **tiles)
    dq = bwd_mod.flash_bwd_dq(*args, schedule="dense", **tiles)
    B, S, Hq, Hk = case.B, case.S, case.Hq, case.Hkv
    Sp = -(-S // BWD_BLOCK) * BWD_BLOCK
    lse_s = torch.where(torch.isneginf(lse), torch.zeros_like(lse), lse)
    lanes = lambda x: np.pad(x.reshape(B * Hq, S).numpy(), ((0, 0), (0, Sp - S)))
    jargs = (_heads(q, Sp), _heads(k, Sp), _heads(v, Sp), _heads(do, Sp), lanes(lse_s),
             lanes(delta))
    kw = dict(group=Hq // Hk, block_q=BWD_BLOCK, block_kv=BWD_BLOCK, kv_valid=S,
              interpret=True, schedule="dense")
    jdk, jdv = jax_bwd.flash_bwd_dkv(*jargs, jspec, **kw)
    jdq = jax_bwd.flash_bwd_dq(*jargs, jspec, **kw)
    unheads = lambda x, H: np.asarray(x)[:, :S].reshape(B, H, S, BWD_D).transpose(0, 2, 1, 3)
    for name, a, b in (("dq", dq, unheads(jdq, Hq)), ("dk", dk, unheads(jdk, Hk)),
                       ("dv", dv, unheads(jdv, Hk))):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, err_msg=name, **TOL_F32)
    assert all(torch.equal(a, b) for a, b in zip(
        (dk, dv, dq), (*bwd_mod.flash_bwd_dkv(*args, **tiles), bwd_mod.flash_bwd_dq(*args,
                                                                                   **tiles))))


# ------------------------------------------------------------ (d) varlen


def _varlen_inputs(case, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    shapes = [(case.B, case.S, case.Hq, BWD_D), (case.B, case.S, case.Hkv, BWD_D),
              (case.B, case.S, case.Hkv, BWD_D), (case.B, case.S, case.Hq, BWD_D)]
    xs = tuple(rng.standard_normal(s, dtype=np.float32).astype(dtype) for s in shapes)
    return (*xs, _segments(case.B, case.S, case.n_seg, seed=seed + case.n_seg))


@functools.partial(jax.jit, static_argnums=(5, 6))
def _pallas_dense_varlen_grads(q, k, v, do, seg, spec, bwd):
    f = functools.partial(flash_attention_pallas_varlen, segment_ids=seg, spec=spec,
                          block_q=BWD_BLOCK, block_kv=BWD_BLOCK, interpret=True, bwd=bwd,
                          use_tuned=False, schedule="dense")
    o, vjp = jax.vjp(f, q, k, v)
    return (o, *vjp(do))


@pytest.mark.parametrize("case", VARLEN_CASES, ids=lambda c: c.name)
def test_dense_varlen_forward_matches_pallas_dense(case):
    q, k, v, _, seg = _varlen_inputs(case)
    spec = MaskSpec(**case.spec)
    kw = dict(block_q=BWD_BLOCK, block_kv=BWD_BLOCK)
    o, lse = ops.flash_attention_varlen_with_lse(_t(q), _t(k), _t(v), torch.from_numpy(seg),
                                                 spec, schedule="dense", **kw)
    o_j, lse_j = flash_attention_pallas_varlen_with_lse(
        q, k, v, jnp.asarray(seg), JaxMaskSpec(**case.spec), interpret=True, use_tuned=False,
        schedule="dense", **kw)
    np.testing.assert_allclose(_f32(o), _f32(o_j), **TOL_F32)
    np.testing.assert_allclose(_f32(lse), _f32(lse_j), **TOL_F32)
    o_c, lse_c = ops.flash_attention_varlen_with_lse(_t(q), _t(k), _t(v), torch.from_numpy(seg),
                                                     spec, **kw)
    assert torch.equal(o, o_c) and torch.equal(lse, lse_c)


@pytest.mark.parametrize("bwd", ops.BWD_MODES)
@pytest.mark.parametrize("case", VARLEN_CASES, ids=lambda c: c.name)
def test_dense_varlen_backward_matches_pallas_dense(case, bwd):
    q, k, v, do, seg = _varlen_inputs(case)
    spec = MaskSpec(**case.spec)
    ours = _port_grads(q, k, v, do, spec, "dense", bwd, seg=seg)
    theirs = _pallas_dense_varlen_grads(q, k, v, do, jnp.asarray(seg), JaxMaskSpec(**case.spec),
                                        bwd)
    for name, a, b in zip(("o", "dq", "dk", "dv"), ours, theirs):
        assert np.isfinite(_f32(a)).all(), name
        np.testing.assert_allclose(_f32(a), _f32(b), err_msg=name, **TOL_F32)
    compact = _port_grads(q, k, v, do, spec, "compact", bwd, seg=seg)
    for name, a, b in zip(("o", "dq", "dk", "dv"), ours, compact):
        assert torch.equal(a, b), name


def test_dense_varlen_bf16_matches_pallas_dense():
    case = VARLEN_CASES[3]
    q, k, v, do, seg = _varlen_inputs(case, seed=1)
    qb, kb, vb, dob = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    ours = _port_grads(qb, kb, vb, dob, MaskSpec(**case.spec), "dense", "fused",
                       torch.bfloat16, seg=seg)
    theirs = _pallas_dense_varlen_grads(qb, kb, vb, dob, jnp.asarray(seg),
                                        JaxMaskSpec(**case.spec), "fused")
    for name, a, b in zip(("o", "dq", "dk", "dv"), ours, theirs):
        np.testing.assert_allclose(_f32(a), _f32(b), err_msg=name, **TOL_BF16)


def test_dense_dkv_and_dq_with_segments_are_the_compact_plain_versions():
    """The varlen dK/dV and dQ wrappers called directly with
    schedule="dense": to the bit the compact ones, rows of a tile that
    shares no segment with any key skipped as the step bits skip them."""
    case = VARLEN_CASES[2]
    q, k, v, do, seg = _varlen_inputs(case, seed=3)
    spec = MaskSpec(**case.spec)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    ids = torch.from_numpy(seg)
    tiles = dict(block_q=BWD_BLOCK, block_kv=BWD_BLOCK)
    o, lse = fwd_mod.flash_fwd_varlen(tq, tk, tv, spec, ids, ids, schedule="dense", **tiles)
    args = (tq, tk, tv, tdo, lse, bwd_mod.flash_bwd_delta(o, tdo), spec, ids, ids)
    for fn in (bwd_mod.flash_bwd_dkv_varlen, bwd_mod.flash_bwd_dq_varlen,
               bwd_mod.flash_bwd_fused_varlen):
        dense, compact = fn(*args, schedule="dense", **tiles), fn(*args, **tiles)
        dense = dense if isinstance(dense, tuple) else (dense,)
        compact = compact if isinstance(compact, tuple) else (compact,)
        assert all(torch.equal(a, b) for a, b in zip(dense, compact)), fn.__name__


# -------------------------------------------------------- (e) knob rules


def test_schedule_knob_rules():
    q = torch.zeros((1, 64, 2, BWD_D))
    k = torch.zeros((1, 640, 2, BWD_D))
    with pytest.raises(ValueError, match="tile schedule"):
        AttentionConfig(schedule="bogus")
    with pytest.raises(ValueError, match="tile schedule"):
        ops.flash_attention(q, q, q, schedule="bogus")
    with pytest.raises(ValueError, match="tile schedule"):
        fwd_mod.flash_fwd(q, q, q, MaskSpec(causal=True), block_q=16, block_kv=16,
                          schedule="bogus")
    assert AttentionConfig().schedule is None
    assert AttentionConfig(schedule="dense").schedule == "dense"
    assert ops.SCHEDULES == ("compact", "dense")
    # The auto policy splits this short-q, long-kv shape under compact ...
    assert ops.resolve_kv_splits(None, q.shape, k.shape) > 1
    # ... and never under dense: None resolves to 1, an explicit split raises.
    assert ops.resolve_kv_splits(None, q.shape, k.shape, schedule="dense") == 1
    assert ops.resolve_kv_splits(1, q.shape, k.shape, schedule="dense") == 1
    with pytest.raises(ValueError, match="compact"):
        ops.resolve_kv_splits(2, q.shape, k.shape, schedule="dense")
    with pytest.raises(ValueError, match="compact"):
        ops.flash_attention(q, k, k, MaskSpec(), kv_splits=2, schedule="dense")
    o = ops.flash_attention(q, k, k, MaskSpec(), schedule="dense")
    assert torch.equal(o, ops.flash_attention(q, k, k, MaskSpec(), kv_splits=1))


# ------------------------------------------------------- (f) train steps


JAX_DENSE = JaxAttentionConfig(impl="flash_pallas", interpret=True, use_tuned=False,
                               schedule="dense")
B, S = 2, 128


@pytest.fixture(scope="module")
def qwen3_g2():
    """Reduced qwen3-8b with two kv heads (G = 2), remat on, f32."""
    jcfg = dataclasses.replace(jax_registry.reduce_config(jax_registry.get("qwen3-8b")),
                               num_kv_heads=2)
    cfg = dataclasses.replace(registry.reduce_config(registry.get("qwen3-8b")), num_kv_heads=2)
    return jcfg, jax_lm.init_lm(jcfg, jax.random.PRNGKey(0)), cfg


def _port_model(cfg, jparams):
    model = LM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jparams)))
    return model


@pytest.mark.parametrize("bwd", ops.BWD_MODES)
def test_dense_loss_and_gradients_match_jax(qwen3_g2, jax_trace_state, bwd):
    jcfg, jparams, cfg = qwen3_g2
    inputs, targets = SyntheticLM(DataConfig(batch_size=B, seq_len=S,
                                             vocab_size=cfg.vocab_size)).batch(0)
    jattn = dataclasses.replace(JAX_DENSE, bwd=bwd)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: jax_steps.loss_fn(jcfg, jattn, p, b), has_aux=True))
    (jloss, _), jgrads = grad_fn(jparams, {"inputs": jnp.asarray(inputs),
                                           "targets": jnp.asarray(targets)})
    model = _port_model(cfg, jparams)
    attn = AttentionConfig(impl="flash_cuda", bwd=bwd, schedule="dense")
    loss, _ = steps.loss_fn(cfg, attn, model, {"inputs": torch.from_numpy(inputs).long(),
                                               "targets": torch.from_numpy(targets)})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **LOSS_TOL)
    want = params_from_jax(cfg, jax.tree.map(np.asarray, jgrads))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), err_msg=name, **GRAD_TOL)


def test_three_dense_train_steps_match_jax(qwen3_g2, jax_trace_state):
    """Three AdamW steps through build_train_step with schedule="dense" (the
    fused backward) against the JAX step on its dense kernels."""
    jcfg, jparams, cfg = qwen3_g2
    opt_cfg = dict(warmup_steps=2, total_steps=3, lr=1e-2)
    jstep = jax.jit(jax_steps.build_train_step(jcfg, JAX_DENSE, jax_opt.AdamWConfig(**opt_cfg)))
    jstate = jax_opt.init_opt_state(jparams)
    model = _port_model(cfg, jparams)
    state = optimizer.init_opt_state(dict(model.named_parameters()))
    step_fn = steps.build_train_step(cfg, AttentionConfig(impl="flash_cuda", schedule="dense"),
                                     optimizer.AdamWConfig(**opt_cfg))
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
    final = params_from_jax(cfg, jax.tree.map(np.asarray, jp))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), final[name].numpy(), err_msg=name,
                                   **PARAM_TOL)
