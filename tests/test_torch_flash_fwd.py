"""The port's FA2 forward (repro_torch.kernels) against the JAX package:
the Pallas kernel in interpret mode and the dense reference, on the same
numpy inputs. On the CPU the port runs the kernel's plain PyTorch version
(tests/test_torch_kernels_gpu.py holds the CUDA kernel against it on the
card)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core.masks import MaskSpec as JaxMaskSpec
from repro.kernels.ops import flash_attention_pallas_with_lse
from repro.kernels.ref import attention_reference
from repro.kernels.schedule import STEP_ACTIVE, STEP_MASKED, build_tile_schedule
from repro_torch.core.masks import MaskSpec
from repro_torch.kernels import ops
from repro_torch.kernels.schedule import build_q_tile_schedule

# f32 on both sides; the only differences are summation order and tiling.
TOL = dict(atol=2e-5, rtol=2e-5)
# One compile per case instead of one per eager op (spec is static).
jax_reference = jax.jit(attention_reference, static_argnums=(3,))


@dataclasses.dataclass(frozen=True)
class Case:
    name: str
    B: int
    Sq: int
    Skv: int
    Hq: int
    Hkv: int
    spec: dict
    zero_tail: int = 0  # bucket padding: rows past this many are zeros


CASES = [
    Case("causal_g1", 2, 40, 40, 4, 4, dict(causal=True)),
    Case("causal_g4", 1, 40, 40, 8, 2, dict(causal=True)),
    Case("full_g4", 2, 40, 40, 8, 2, dict(causal=False)),
    Case("window", 1, 48, 48, 4, 2, dict(causal=True, window=12)),
    Case("window_sink", 1, 56, 56, 4, 1, dict(causal=True, window=12, sink=4)),
    Case("noncausal_window", 1, 40, 40, 4, 4, dict(causal=False, window=10)),
    Case("q_offset", 2, 8, 40, 4, 2, dict(causal=True, q_offset=32)),
    Case("ragged_short", 1, 7, 7, 4, 4, dict(causal=True)),
    Case("bucket_padded", 1, 48, 48, 8, 2, dict(causal=True), zero_tail=29),
]
D = 16
BLOCK = 16


def _inputs(case: Case, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((case.B, case.Sq, case.Hq, D), dtype=np.float32)
    k = rng.standard_normal((case.B, case.Skv, case.Hkv, D), dtype=np.float32)
    v = rng.standard_normal((case.B, case.Skv, case.Hkv, D), dtype=np.float32)
    if case.zero_tail:
        for x in (q, k, v):
            x[:, case.zero_tail:] = 0.0
    return q, k, v


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_forward_matches_pallas_and_reference(case):
    q, k, v = _inputs(case)
    o, lse = ops.flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        MaskSpec(**case.spec), block_q=BLOCK, block_kv=BLOCK,
    )
    assert o.shape == (case.B, case.Sq, case.Hq, D) and o.dtype == torch.float32
    assert lse.shape == (case.B, case.Hq, case.Sq)
    jspec = JaxMaskSpec(**case.spec)
    o_p, lse_p = flash_attention_pallas_with_lse(
        q, k, v, jspec, block_q=BLOCK, block_kv=BLOCK, interpret=True, use_tuned=False
    )
    np.testing.assert_allclose(o.numpy(), np.asarray(o_p), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_p), **TOL)
    o_r, lse_r = jax_reference(q, k, v, jspec)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_r), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_r), **TOL)


def test_default_blocks_match_reference():
    """No explicit blocks: the H100 heuristic (64 x 64) tiles a 100-long
    causal GQA prefill into ragged tiles; still the reference's answer."""
    case = Case("default_blocks", 1, 100, 100, 8, 2, dict(causal=True))
    q, k, v = _inputs(case, seed=3)
    o, lse = ops.flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), MaskSpec(causal=True)
    )
    o_r, lse_r = jax_reference(q, k, v, JaxMaskSpec(causal=True))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_r), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_r), **TOL)


SCHEDULE_SPECS = [
    dict(), dict(causal=True), dict(causal=True, window=20),
    dict(causal=True, window=20, sink=5), dict(causal=False, window=24),
    dict(causal=False, window=24, sink=8), dict(causal=True, q_offset=48),
]


@pytest.mark.parametrize("spec", SCHEDULE_SPECS, ids=str)
@pytest.mark.parametrize("geom", [(5, 5, 16, 16, 80), (4, 7, 16, 16, 101),
                                  (3, 6, 32, 16, 90), (2, 2, 64, 64, 100)])
def test_q_tile_schedule_is_the_compact_schedule(spec, geom):
    """Per q tile, the visible kv tiles and their mask flags are exactly the
    active steps of the JAX package's q-major compact schedule."""
    t_q, t_kv, bq, bk, kv_valid = geom
    ours = build_q_tile_schedule(MaskSpec(**spec), t_q, t_kv, bq, bk, kv_valid)
    ref = build_tile_schedule(JaxMaskSpec(**spec), t_q, t_kv, bq, bk, kv_valid)
    active = (ref.flags & STEP_ACTIVE) != 0
    want = list(zip(ref.outer[active].tolist(), ref.inner[active].tolist(),
                    ((ref.flags[active] & STEP_MASKED) != 0).tolist()))
    got = [(i, j, bool(m)) for (i, j), m in zip(ours.pairs(), ours.masked)]
    assert got == want
    assert ours.row_ptr[-1] == ref.n_active


def test_forward_is_forward_only():
    """Of the forward kernels, split-KV decode stays forward-only (as in the
    JAX package); the FA2 forward now carries its backward
    (tests/test_torch_flash_bwd.py)."""
    q = torch.zeros((1, 1, 2, D), requires_grad=True)
    k = torch.zeros((1, 4, 2, D))
    with pytest.raises(NotImplementedError, match="forward-only"):
        ops.flash_decode(q, k, k, torch.tensor([4]))
    assert ops.flash_attention(q, k, k).grad_fn is not None
