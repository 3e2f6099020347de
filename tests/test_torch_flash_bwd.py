"""The port's FA2 backward (repro_torch.kernels) against the JAX package: the
fused Pallas backward in interpret mode (``jax.vjp`` of
``flash_attention_pallas(..., bwd="fused")``), its delta kernel, and the
dense reference backward, on the same numpy inputs. On the CPU the port
runs the kernels' plain PyTorch versions through its autograd Function
(tests/test_torch_kernels_gpu.py holds the CUDA kernels against them on the
card)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.masks import MaskSpec as JaxMaskSpec
from repro.kernels import flash_bwd as jax_bwd
from repro.kernels.ops import (PallasFlashConfig, flash_attention_pallas,
                               resolve_pallas_knobs)
from repro.kernels.ref import attention_reference as jax_attention_reference
from repro.kernels.ref import attention_reference_bwd as jax_reference_bwd
from repro.kernels.schedule import STEP_ACTIVE, STEP_MASKED, build_tile_schedule
from repro_torch.core.masks import MaskSpec
from repro_torch.kernels import flash_bwd as bwd_mod
from repro_torch.kernels import ops
from repro_torch.kernels.ref import attention_reference, attention_reference_bwd
from repro_torch.kernels.schedule import build_kv_tile_schedule

# f32 on both sides: the differences are summation order and tiling only.
TOL_F32 = dict(atol=2e-5, rtol=2e-5)
# bf16 inputs, f32 sums: both round P and dS to bf16 at the same places, but
# a value near a rounding boundary can land one bf16 ulp (0.8% near 1) apart.
TOL_BF16 = dict(atol=2e-2, rtol=2e-2)
D = 16
BLOCK = 32


@dataclasses.dataclass(frozen=True)
class Case:
    name: str
    B: int
    S: int
    Hq: int
    Hkv: int
    spec: dict


CASES = [
    Case("full_g1", 1, 100, 2, 2, dict()),
    Case("causal_g1", 2, 64, 2, 2, dict(causal=True)),
    Case("causal_g2_ragged130", 2, 130, 4, 2, dict(causal=True)),
    Case("causal_g4_ragged100", 1, 100, 8, 2, dict(causal=True)),
    Case("window_g2", 1, 130, 4, 2, dict(causal=True, window=40)),
    Case("sink_g4", 1, 130, 4, 1, dict(causal=True, window=40, sink=8)),
    Case("noncausal_window_g1", 1, 100, 2, 2, dict(causal=False, window=30)),
    # Rows 0-63 see no key and fill whole q tiles, which no CTA visits.
    Case("masked_rows_g2", 1, 100, 4, 2, dict(causal=True, q_offset=-64)),
]


def _inputs(case: Case, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((case.B, case.S, case.Hq, D), dtype=np.float32)
    k = rng.standard_normal((case.B, case.S, case.Hkv, D), dtype=np.float32)
    v = rng.standard_normal((case.B, case.S, case.Hkv, D), dtype=np.float32)
    do = rng.standard_normal((case.B, case.S, case.Hq, D), dtype=np.float32)
    return tuple(x.astype(dtype) for x in (q, k, v, do))


@functools.partial(jax.jit, static_argnums=(4, 5, 6))
def _pallas_grads(q, k, v, do, spec, bq, bk):
    f = functools.partial(flash_attention_pallas, spec=spec, block_q=bq, block_kv=bk,
                          interpret=True, bwd="fused", use_tuned=False)
    o, vjp = jax.vjp(f, q, k, v)
    return (o, *vjp(do))


def _resolved_blocks(jspec, q, k):
    r = resolve_pallas_knobs(
        PallasFlashConfig(spec=jspec, block_q=BLOCK, block_kv=BLOCK, use_tuned=False),
        q.shape, k.shape, q.dtype)
    assert r["bwd"] == "fused"
    return r["block_q"], r["block_kv"]


def _port_grads(q, k, v, do, spec, bq, bk, dtype=torch.float32):
    qt, kt, vt = (torch.from_numpy(np.asarray(x, np.float32)).to(dtype).requires_grad_()
                  for x in (q, k, v))
    o = ops.flash_attention(qt, kt, vt, spec, block_q=bq, block_kv=bk)
    o.backward(torch.from_numpy(np.asarray(do, np.float32)).to(dtype))
    return o, qt.grad, kt.grad, vt.grad


def _f32(x):
    return np.asarray(x.detach().float() if torch.is_tensor(x) else jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_backward_matches_pallas_fused_and_reference(case):
    q, k, v, do = _inputs(case)
    jspec = JaxMaskSpec(**case.spec)
    bq, bk = _resolved_blocks(jspec, q, k)
    ours = _port_grads(q, k, v, do, MaskSpec(**case.spec), bq, bk)
    theirs = _pallas_grads(q, k, v, do, jspec, bq, bk)
    for name, a, b in zip(("o", "dq", "dk", "dv"), ours, theirs):
        assert a.dtype == torch.float32 and np.isfinite(_f32(a)).all(), name
        np.testing.assert_allclose(_f32(a), _f32(b), err_msg=name, **TOL_F32)
    o_r, lse_r = jax_attention_reference(q, k, v, jspec)
    ref = jax_reference_bwd(q, k, v, o_r, do, lse_r, jspec)
    for name, a, b in zip(("dq", "dk", "dv"), ours[1:], ref):
        np.testing.assert_allclose(_f32(a), _f32(b), err_msg=name, **TOL_F32)


@pytest.mark.parametrize("case", [CASES[3], CASES[5]], ids=lambda c: c.name)
def test_backward_bf16_matches_pallas_fused(case):
    q, k, v, do = _inputs(case, seed=1)
    jspec = JaxMaskSpec(**case.spec)
    qb, kb, vb, dob = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    bq, bk = _resolved_blocks(jspec, qb, kb)
    ours = _port_grads(qb, kb, vb, dob, MaskSpec(**case.spec), bq, bk, torch.bfloat16)
    theirs = _pallas_grads(qb, kb, vb, dob, jspec, bq, bk)
    for name, a, b in zip(("o", "dq", "dk", "dv"), ours, theirs):
        assert a.dtype == torch.bfloat16, name
        np.testing.assert_allclose(_f32(a), _f32(b), err_msg=name, **TOL_BF16)


def test_fully_masked_rows_get_zero_gradients():
    """Rows that see no key (causal, q_offset = -64: rows 0-63) carry
    lse = -inf; the backward replaces it by 0, so their P is 0 -- no NaN,
    dq exactly zero there. (A row that sees no key inside a tile that other
    rows do see gets lse = mask value + log(tile width) from the forward,
    in the JAX kernels as here, not -inf: such rows are left out.)"""
    case = CASES[-1]
    q, k, v, do = _inputs(case, seed=2)
    _, dq, dk, dv = _port_grads(q, k, v, do, MaskSpec(**case.spec), BLOCK, BLOCK)
    for g in (dq, dk, dv):
        assert torch.isfinite(g).all()
    assert (dq[:, :64] == 0).all() and (dq[:, 64:] != 0).any()
    # Keys past the last row's position (99 - 64 = 35) get no gradient.
    assert (dk[:, 36:] == 0).all() and (dv[:, 36:] == 0).all()


@pytest.mark.parametrize("S,bq", [(128, 32), (100, 32), (64, 64)])
def test_delta_matches_pallas_delta(S, bq):
    rng = np.random.default_rng(S)
    B, Hq = 2, 4
    o = rng.standard_normal((B, S, Hq, D), dtype=np.float32)
    do = rng.standard_normal((B, S, Hq, D), dtype=np.float32)
    ours = bwd_mod.flash_bwd_delta(torch.from_numpy(o), torch.from_numpy(do))
    assert ours.shape == (B, Hq, S) and ours.dtype == torch.float32
    # The Pallas kernel takes the prepped (B*Hq, Sqp, D) layout.
    Sqp = -(-S // bq) * bq
    pad = ((0, 0), (0, Sqp - S), (0, 0))
    heads = lambda x: np.pad(x.transpose(0, 2, 1, 3).reshape(B * Hq, S, D), pad)
    theirs = jax_bwd.flash_bwd_delta(heads(o), heads(do), block_q=bq, interpret=True)
    np.testing.assert_allclose(ours.numpy(),
                               np.asarray(theirs)[:, :S].reshape(B, Hq, S), **TOL_F32)


@pytest.mark.parametrize("case", [CASES[0], CASES[4], CASES[5], CASES[-1]],
                         ids=lambda c: c.name)
def test_reference_backward_matches_jax_and_autograd(case):
    q, k, v, do = _inputs(case, seed=3)
    jspec, spec = JaxMaskSpec(**case.spec), MaskSpec(**case.spec)
    o_j, lse_j = jax_attention_reference(q, k, v, jspec)
    want = jax_reference_bwd(q, k, v, o_j, do, lse_j, jspec)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o, lse = attention_reference(qt, kt, vt, spec)
    got = attention_reference_bwd(qt.detach(), kt.detach(), vt.detach(), o.detach(),
                                  torch.from_numpy(do), lse.detach(), spec)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **TOL_F32)
    # impl="ref" trains through plain autograd of the forward: same answer.
    o.backward(torch.from_numpy(do))
    for name, a, b in zip(("dq", "dk", "dv"), (qt.grad, kt.grad, vt.grad), got):
        assert torch.isfinite(a).all(), name
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name, **TOL_F32)


# The specs of tests/test_schedule.py, and the q_offset / ragged geometries.
SCHEDULE_SPECS = [
    dict(causal=True), dict(causal=True, window=64), dict(causal=True, window=64, sink=16),
    dict(), dict(causal=False, window=48), dict(causal=True, q_offset=-100),
    dict(causal=True, window=64, q_offset=4096),
]


@pytest.mark.parametrize("spec", SCHEDULE_SPECS, ids=str)
@pytest.mark.parametrize("geom", [(16, 16, 128, 128, 2048), (4, 7, 16, 16, 101),
                                  (6, 3, 16, 32, 90), (32, 32, 64, 64, 2048)])
def test_kv_tile_schedule_is_the_kv_major_schedule(spec, geom):
    """Per kv tile, the visible q tiles and their mask flags are exactly the
    active steps of the JAX package's kv-major compact schedule, in order."""
    t_q, t_kv, bq, bk, kv_valid = geom
    ours = build_kv_tile_schedule(MaskSpec(**spec), t_q, t_kv, bq, bk, kv_valid)
    ref = build_tile_schedule(JaxMaskSpec(**spec), t_q, t_kv, bq, bk, kv_valid,
                              kv_major=True)
    active = (ref.flags & STEP_ACTIVE) != 0
    want = list(zip(ref.outer[active].tolist(), ref.inner[active].tolist(),
                    ((ref.flags[active] & STEP_MASKED) != 0).tolist()))
    got = [(j, i, bool(m)) for (j, i), m in zip(ours.pairs(), ours.masked)]
    assert got == want
    assert ours.row_ptr[-1] == ref.n_active
    assert len(ours.row_ptr) == t_kv + 1


def test_split_backward_is_not_ported():
    q = torch.zeros((1, 4, 2, D))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ops.flash_attention(q, q, q, bwd="split")
    with pytest.raises(ValueError, match="backward mode"):
        ops.flash_attention(q, q, q, bwd="bogus")
