"""The port's split-KV decode (repro_torch.kernels) against the JAX Pallas
decode kernel in interpret mode, on the same numpy inputs: the per-split
partials (same geometry, same layout) and the merged output. On the CPU
the port runs the kernel's plain PyTorch version."""

import functools

import jax
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode import flash_decode_kernel as jax_decode_kernel
from repro.kernels.ops import flash_decode_pallas
from repro_torch.kernels import flash_decode as dec_mod
from repro_torch.kernels import ops
from repro_torch.kernels.flash_decode import decode_geometry

TOL = dict(atol=2e-5, rtol=2e-5)  # f32 on both sides
D = 16

CASES = {
    # name: (B, S, Hq, Hkv, lengths, num_splits, window, sink)
    "ragged_g1": (4, 64, 4, 4, [0, 1, 37, 64], 8, None, 0),
    "ragged_g4": (4, 64, 8, 2, [5, 0, 64, 1], 8, None, 0),
    "s100_splits8": (3, 100, 8, 2, [100, 61, 9], 8, None, 0),
    "window": (3, 96, 4, 2, [96, 40, 7], 4, 20, 0),
    "window_sink": (3, 96, 8, 2, [96, 50, 3], 8, 20, 4),
    "one_split": (2, 40, 4, 1, [40, 17], 1, None, 0),
}


def _inputs(B, S, Hq, Hkv, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, Hq, D), dtype=np.float32)
    k = rng.standard_normal((B, S, Hkv, D), dtype=np.float32)
    v = rng.standard_normal((B, S, Hkv, D), dtype=np.float32)
    return q, k, v


@pytest.mark.parametrize("name", list(CASES))
def test_decode_matches_pallas(name):
    B, S, Hq, Hkv, lengths, ns, window, sink = CASES[name]
    q, k, v = _inputs(B, S, Hq, Hkv)
    lens = np.asarray(lengths, np.int32)
    o, lse = ops.flash_decode(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              torch.from_numpy(lens), window=window, sink=sink,
                              num_splits=ns)
    # jitted whole: one compile per case instead of one per eager op
    o_j, lse_j = jax.jit(functools.partial(
        flash_decode_pallas, window=window, sink=sink, num_splits=ns, interpret=True
    ))(q, k, v, lens)
    assert o.shape == (B, 1, Hq, D) and lse.shape == (B, Hq, 1)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), **TOL)
    assert np.all(o.numpy()[lens == 0] == 0.0)
    assert np.all(np.isneginf(lse.numpy()[lens == 0]))


@pytest.mark.parametrize("name", list(CASES))
def test_decode_partials_match_pallas_kernel(name):
    """Same split geometry and the JAX layout: partial for partial."""
    B, S, Hq, Hkv, lengths, ns, window, sink = CASES[name]
    G = Hq // Hkv
    q, k, v = _inputs(B, S, Hq, Hkv, seed=1)
    qh = q.reshape(B * Hkv, G, D)  # already "pre-scaled": both sides take it as is
    lens = np.asarray(lengths, np.int32)
    o_p, lse_p = dec_mod.flash_decode(torch.from_numpy(qh), torch.from_numpy(k),
                                      torch.from_numpy(v), torch.from_numpy(lens),
                                      num_splits=ns, window=window, sink=sink)
    heads = lambda x: x.transpose(0, 2, 1, 3).reshape(B * Hkv, S, D)
    o_j, lse_j = jax.jit(functools.partial(
        jax_decode_kernel, num_splits=ns, window=window, sink=sink, interpret=True
    ))(qh, heads(k), heads(v), np.repeat(lens, Hkv))
    assert o_p.shape == tuple(o_j.shape) and lse_p.shape == tuple(lse_j.shape)
    assert o_p.shape[1] == decode_geometry(S, ns)[0]
    np.testing.assert_allclose(o_p.numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(lse_p.numpy(), np.asarray(lse_j), **TOL)


@pytest.mark.parametrize("S,splits,want", [(2048, 8, (8, 256)), (100, 8, (7, 16)),
                                           (97, 8, (7, 16)), (5, 8, (1, 8)),
                                           (64, 1, (1, 64))])
def test_decode_geometry_is_the_kernels(S, splits, want):
    assert decode_geometry(S, splits) == want
