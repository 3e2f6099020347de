"""Packed decode: the port's split-KV decode over a packed cache (segment
ids per cache position and one per query) against the JAX Pallas decode
kernel in interpret mode and the dense reference, on the same numpy
inputs. On the CPU the port runs the kernel's plain version
(tests/test_torch_kernels_gpu.py holds the CUDA SEG kernel against it)."""

import functools

import jax
import numpy as np
import pytest
import torch

from repro.core.attention import AttentionConfig as JaxAttentionConfig
from repro.core.attention import decode_attention as jax_decode_attention
from repro.kernels.flash_decode import flash_decode_kernel as jax_decode_kernel
from repro.kernels.ops import flash_decode_pallas
from repro_torch.core.attention import AttentionConfig, decode_attention
from repro_torch.kernels import flash_decode as dec_mod
from repro_torch.kernels import ops

TOL = dict(atol=2e-5, rtol=2e-5)  # f32 on both sides
D = 16


def _varlen_setting():
    """The setting of tests/test_varlen.py:220: a cache of 128, lengths 100
    and 120, two segments a row, the queries in segment 2."""
    kseg = np.zeros((2, 128), np.int32)
    kseg[0, :60], kseg[0, 60:100] = 1, 2
    kseg[1, :50], kseg[1, 50:120] = 1, 2
    return kseg, np.array([2, 2], np.int32), np.array([100, 120], np.int32)


def _ragged_setting():
    """Four rows, three or four segments each, queries in various segments:
    one whose segment lies wholly in one split, one whose segment is absent
    (it sees nothing), one in a middle segment."""
    rng = np.random.default_rng(2)
    kseg = np.zeros((4, 96), np.int32)
    for b in range(4):
        cuts = np.sort(rng.choice(np.arange(5, 90), 3, replace=False))
        kseg[b, :cuts[0]], kseg[b, cuts[0]:cuts[1]] = 1, 2
        kseg[b, cuts[1]:cuts[2]], kseg[b, cuts[2]:] = 3, 4
    return kseg, np.array([4, 7, 2, 1], np.int32), np.array([96, 80, 61, 33], np.int32)


CASES = {
    # name: (setting, Hq, Hkv, num_splits, window, sink)
    "varlen_g2": (_varlen_setting, 4, 2, 8, None, 0),
    "varlen_g1_splits3": (_varlen_setting, 2, 2, 3, None, 0),
    "ragged_g4": (_ragged_setting, 8, 2, 8, None, 0),
    "ragged_window_sink": (_ragged_setting, 4, 2, 4, 24, 4),
}


def _inputs(B, S, Hq, Hkv, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, Hq, D), dtype=np.float32)
    k = rng.standard_normal((B, S, Hkv, D), dtype=np.float32)
    v = rng.standard_normal((B, S, Hkv, D), dtype=np.float32)
    return q, k, v


def _case(name):
    setting, Hq, Hkv, ns, window, sink = CASES[name]
    kseg, qseg, lens = setting()
    q, k, v = _inputs(kseg.shape[0], kseg.shape[1], Hq, Hkv)
    return q, k, v, kseg, qseg, lens, ns, window, sink


@pytest.mark.parametrize("name", list(CASES))
def test_packed_decode_matches_pallas(name):
    q, k, v, kseg, qseg, lens, ns, window, sink = _case(name)
    o, lse = ops.flash_decode(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(lens),
        window=window, sink=sink, num_splits=ns, kv_segment_ids=torch.from_numpy(kseg),
        q_segment=torch.from_numpy(qseg))
    o_j, lse_j = jax.jit(functools.partial(
        flash_decode_pallas, window=window, sink=sink, num_splits=ns, interpret=True
    ))(q, k, v, lens, kv_segment_ids=kseg, q_segment=qseg)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), **TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_packed_decode_partials_match_the_pallas_kernel(name):
    """The per-split partials of the plain SEG walk against the JAX kernel's,
    its ids repeated per kv head as the JAX wrapper repeats them."""
    q, k, v, kseg, qseg, lens, ns, window, sink = _case(name)
    B, S, Hkv, _ = k.shape
    G = q.shape[2] // Hkv
    qh = q.reshape(B * Hkv, G, D)
    o, lse = dec_mod.flash_decode_varlen(
        torch.from_numpy(qh), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(lens),
        torch.from_numpy(kseg), torch.from_numpy(qseg), num_splits=ns, window=window, sink=sink)

    def heads(x):  # (B, S, Hkv, D) -> (B*Hkv, S, D)
        return x.transpose(0, 2, 1, 3).reshape(B * Hkv, S, D)

    o_j, lse_j = jax_decode_kernel(
        qh, heads(k), heads(v), np.repeat(lens, Hkv), num_splits=ns, window=window, sink=sink,
        kv_seg=np.repeat(kseg, Hkv, axis=0), q_seg=np.repeat(qseg, Hkv), interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), **TOL)
    # Splits holding no position of the query's segment give (0, -inf).
    empty = np.isneginf(lse.numpy())
    assert empty.any() and np.all(o.numpy()[empty] == 0.0)


@pytest.mark.parametrize("name", list(CASES))
def test_decode_attention_with_segments(name):
    """``core.attention.decode_attention`` with segments, flash_cuda and ref,
    against the JAX ``decode_attention`` on the Pallas kernel."""
    q, k, v, kseg, qseg, lens, ns, window, sink = _case(name)
    seg = dict(kv_segment_ids=torch.from_numpy(kseg), q_segment=torch.from_numpy(qseg))
    t = [torch.from_numpy(x) for x in (q, k, v, lens)]
    got = decode_attention(*t, AttentionConfig(impl="flash_cuda"), window=window, sink=sink,
                           **seg)
    ref = decode_attention(*t, AttentionConfig(impl="ref"), window=window, sink=sink, **seg)
    jcfg = JaxAttentionConfig(impl="flash_pallas", decode_splits=8, use_tuned=False)
    want = jax.jit(lambda q, k, v, n, ks, qs: jax_decode_attention(
        q, k, v, n, jcfg, window=window, sink=sink, kv_segment_ids=ks, q_segment=qs
    ))(q, k, v, lens, kseg, qseg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(ref.numpy(), got.numpy(), **TOL)


def test_packed_decode_isolates_segments():
    """A query sees only its own segment: changing K/V of the other segments
    does not change its output; a query whose segment has no position in
    the cache gets 0."""
    q, k, v, kseg, qseg, lens, ns, window, sink = _case("ragged_g4")
    seg = dict(kv_segment_ids=torch.from_numpy(kseg), q_segment=torch.from_numpy(qseg))
    t = [torch.from_numpy(x) for x in (q, k, v, lens)]
    o = decode_attention(*t, **seg)
    k2, v2 = k.copy(), v.copy()
    other = kseg != qseg[:, None]
    k2[other], v2[other] = 7.0, -3.0
    o2 = decode_attention(t[0], torch.from_numpy(k2), torch.from_numpy(v2), t[3], **seg)
    assert torch.equal(o, o2)
    absent = [b for b in range(4) if not (kseg[b, :lens[b]] == qseg[b]).any()]
    assert absent and all(bool((o[b] == 0).all()) for b in absent)


def test_equal_ids_are_bitwise_the_unsegmented_decode():
    q, k, v, _, _, lens, ns, window, sink = _case("ragged_window_sink")
    B, S = k.shape[:2]
    t = [torch.from_numpy(x) for x in (q, k, v, lens)]
    o1, l1 = ops.flash_decode(*t, window=window, sink=sink, num_splits=ns)
    o2, l2 = ops.flash_decode(*t, window=window, sink=sink, num_splits=ns,
                              kv_segment_ids=torch.full((B, S), 5, dtype=torch.int32),
                              q_segment=torch.full((B,), 5, dtype=torch.int32))
    assert torch.equal(o1, o2) and torch.equal(l1, l2)


def test_packed_decode_checks_its_ids():
    q, k, v, kseg, qseg, lens, *_ = _case("varlen_g2")
    t = [torch.from_numpy(x) for x in (q, k, v, lens)]
    with pytest.raises(ValueError, match="both"):
        ops.flash_decode(*t, kv_segment_ids=torch.from_numpy(kseg))
    with pytest.raises(ValueError, match="kv_segment_ids must be"):
        ops.flash_decode(*t, kv_segment_ids=torch.from_numpy(kseg[:, :64]),
                         q_segment=torch.from_numpy(qseg))
