"""The port's split-KV forward (the ``kv_splits > 1`` mode of the JAX
partitioned forward) against the JAX package: the split edges and walk
exactly against the JAX partition tables, the per-split partials and the
folded (o, lse) of the Pallas kernel in interpret mode, the one-pass fold
against the merge tree, gradients through a split forward, and the port's
auto policy restated for the H100. On the CPU the port runs the kernel's
plain version (tests/test_torch_kernels_gpu.py holds the CUDA kernel
against it on the card)."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro.core.masks import MaskSpec as JaxMaskSpec
from repro.kernels import flash_fwd as jax_fwd
from repro.kernels import schedule as jax_schedule
from repro.kernels.ops import (flash_attention_pallas_varlen_with_lse,
                               flash_attention_pallas_with_lse)
from repro_torch.core.attention import AttentionConfig
from repro_torch.core.masks import MaskSpec
from repro_torch.core.online_softmax import combine_lse_outputs, fold_partials
from repro_torch.kernels import flash_fwd as fwd_mod
from repro_torch.kernels import ops, schedule

# f32 on both sides; the only differences are summation order and tiling.
TOL = dict(atol=2e-5, rtol=2e-5)
D = 16
BLOCK = 16

SPECS = {
    "causal": dict(causal=True),
    "full": dict(causal=False),
    "window": dict(causal=True, window=20),
    "window_sink": dict(causal=True, window=20, sink=4),
}


# ------------------------------------------------------------ the tables


@pytest.mark.parametrize("ks", [1, 2, 3, 5, 13])
@pytest.mark.parametrize("t_kv", [1, 3, 5, 6, 8, 24])
def test_kv_split_edges_equal_jax(t_kv, ks):
    """The kv ranges of the splits equal the JAX ``kv_split_edges``."""
    assert schedule.kv_split_edges(t_kv, ks) == jax_schedule.kv_split_edges(t_kv, ks)


@pytest.mark.parametrize("ks", [1, 2, 3, 5])
@pytest.mark.parametrize("spec_name", ["causal", "full", "window", "window_sink"])
def test_split_walk_is_the_partitioned_schedule(spec_name, ks):
    """The tiles the split kernel visits per (q tile, split) are exactly the
    ACTIVE steps of that q tile in the JAX partition of that split, in
    order, with the same masked flags."""
    spec = SPECS[spec_name]
    for t_q, t_kv in ((1, 7), (3, 7), (8, 8)):
        kv_valid = t_kv * BLOCK - 3
        sp = dict(spec, q_offset=(t_kv - t_q) * BLOCK if spec["causal"] else 0)
        want = jax_schedule.build_partitioned_schedule(
            JaxMaskSpec(**sp), t_q, t_kv, BLOCK, BLOCK, kv_valid, 1, ks)
        got = schedule.build_split_schedule(MaskSpec(**sp), t_q, t_kv, BLOCK, BLOCK, kv_valid, ks)
        assert got.splits == want.kv_splits
        for i in range(t_q):
            for s in range(got.splits):
                a = i * got.splits + s
                walk = [(int(got.inner[x]), bool(got.masked[x]))
                        for x in range(got.row_ptr[a], got.row_ptr[a + 1])]
                flags, outer, inner = want.flags[s], want.outer[s], want.inner[s]
                act = (flags & jax_schedule.STEP_ACTIVE != 0) & (outer == i)
                ref = [(int(j), bool(f & jax_schedule.STEP_MASKED))
                       for j, f in zip(inner[act], flags[act])]
                assert walk == ref, (t_q, i, s)


# ------------------------------------------------------- the split forward


@dataclasses.dataclass(frozen=True)
class Case:
    name: str
    B: int
    Sq: int
    Skv: int
    Hq: int
    Hkv: int
    spec: dict
    ks: int
    segments: bool = False


CASES = [
    Case("cross_full_g1", 2, 5, 100, 4, 4, dict(causal=False), 3),
    Case("cross_full_g4", 1, 16, 128, 8, 2, dict(causal=False), 5),
    Case("prefill_causal", 2, 40, 40, 4, 2, dict(causal=True), 2),
    Case("chunk_q_offset", 1, 20, 100, 4, 2, dict(causal=True, q_offset=80), 3),
    Case("window_sink", 1, 56, 56, 4, 1, dict(causal=True, window=12, sink=4), 3),
    Case("packed", 2, 48, 48, 4, 2, dict(causal=True), 3, segments=True),
    Case("packed_cross", 2, 8, 90, 4, 4, dict(causal=False), 4, segments=True),
]


def _inputs(case: Case, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((case.B, case.Sq, case.Hq, D), dtype=np.float32)
    k = rng.standard_normal((case.B, case.Skv, case.Hkv, D), dtype=np.float32)
    v = rng.standard_normal((case.B, case.Skv, case.Hkv, D), dtype=np.float32)
    return q, k, v


def _segments(case: Case, seed=1):
    """Ids of two or three documents a row; the q rows take the kv ids of
    the positions they sit at (the last Sq keys)."""
    rng = np.random.default_rng(seed)
    kv = np.zeros((case.B, case.Skv), np.int32)
    for b in range(case.B):
        cuts = np.sort(rng.choice(np.arange(4, case.Skv - 4), 2, replace=False))
        kv[b, :cuts[0]], kv[b, cuts[0]:cuts[1]], kv[b, cuts[1]:] = 1, 2, 3 + b
    return kv[:, case.Skv - case.Sq:].copy(), kv


def _heads(x, S_pad):
    """(B, S, H, D) -> the JAX kernels' (B*H, S_pad, D), zero-padded."""
    B, S, H, Dh = x.shape
    h = x.transpose(0, 2, 1, 3).reshape(B * H, S, Dh)
    return np.pad(h, ((0, 0), (0, S_pad - S), (0, 0)))


def _pad_ids(q_seg, kv_seg, Sqp, Skp):
    from repro.core.masks import pad_segments
    return pad_segments(q_seg, kv_seg, Sqp, Skp)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_split_partials_match_the_pallas_kernel(case):
    """The per-split (o, lse) partials of the plain split walk against the
    JAX partitioned kernel's (``flash_fwd(kv_splits=ks)``, interpret mode),
    on the same pre-scaled inputs."""
    q, k, v = _inputs(case)
    qs = q * np.float32(1.0 / math.sqrt(D))
    seg = _segments(case) if case.segments else None
    kw = dict(block_q=BLOCK, block_kv=BLOCK, kv_splits=case.ks)
    if seg is None:
        out = fwd_mod.flash_fwd_splitkv(torch.from_numpy(qs), torch.from_numpy(k),
                                        torch.from_numpy(v), MaskSpec(**case.spec), **kw)
    else:
        out = fwd_mod.flash_fwd_splitkv_varlen(
            torch.from_numpy(qs), torch.from_numpy(k), torch.from_numpy(v),
            MaskSpec(**case.spec), torch.from_numpy(seg[0]), torch.from_numpy(seg[1]), **kw)
    o, lse = out.o_parts, out.lse_parts
    Sqp = -(-case.Sq // BLOCK) * BLOCK
    Skp = -(-case.Skv // BLOCK) * BLOCK
    jseg = {} if seg is None else dict(zip(("q_seg", "kv_seg"),
                                           _pad_ids(seg[0], seg[1], Sqp, Skp)))
    o_j, lse_j = jax_fwd.flash_fwd(
        _heads(qs, Sqp), _heads(k, Skp), _heads(v, Skp), JaxMaskSpec(**case.spec),
        group=case.Hq // case.Hkv, block_q=BLOCK, block_kv=BLOCK, kv_valid=case.Skv,
        interpret=True, num_q_bands=1, kv_splits=case.ks, **jseg)
    ks = fwd_mod.split_count(case.Skv, BLOCK, case.ks)
    assert o.shape == (case.B, case.Hq, ks, case.Sq, D) and o.dtype == torch.float32
    assert lse.shape == (case.B, case.Hq, ks, case.Sq)
    BH = case.B * case.Hq
    np.testing.assert_allclose(o.reshape(BH, ks, case.Sq, D).numpy(),
                               np.asarray(o_j)[:, :, :case.Sq], **TOL)
    np.testing.assert_allclose(lse.reshape(BH, ks, case.Sq).numpy(),
                               np.asarray(lse_j)[:, :, :case.Sq], **TOL)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_split_forward_folded_matches_pallas(case):
    """The folded (o, lse) through the public wrappers against the JAX
    wrappers with the same kv_splits, and against the port's single pass."""
    q, k, v = _inputs(case)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    kw = dict(block_q=BLOCK, block_kv=BLOCK)
    if case.segments:
        qseg, kvseg = _segments(case)
        ids = dict(kv_segment_ids=torch.from_numpy(kvseg))
        o, lse = ops.flash_attention_varlen_with_lse(
            tq, tk, tv, torch.from_numpy(qseg), MaskSpec(**case.spec), kv_splits=case.ks,
            **ids, **kw)
        o1, lse1 = ops.flash_attention_varlen_with_lse(
            tq, tk, tv, torch.from_numpy(qseg), MaskSpec(**case.spec), kv_splits=1, **ids, **kw)
        o_j, lse_j = flash_attention_pallas_varlen_with_lse(
            q, k, v, qseg, JaxMaskSpec(**case.spec), kv_segment_ids=kvseg, num_q_bands=1,
            kv_splits=case.ks, interpret=True, use_tuned=False, **kw)
    else:
        o, lse = ops.flash_attention_with_lse(tq, tk, tv, MaskSpec(**case.spec),
                                              kv_splits=case.ks, **kw)
        o1, lse1 = ops.flash_attention_with_lse(tq, tk, tv, MaskSpec(**case.spec),
                                                kv_splits=1, **kw)
        o_j, lse_j = flash_attention_pallas_with_lse(
            q, k, v, JaxMaskSpec(**case.spec), num_q_bands=1, kv_splits=case.ks,
            interpret=True, use_tuned=False, **kw)
    assert o.shape == (case.B, case.Sq, case.Hq, D) and o.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), **TOL)
    np.testing.assert_allclose(o.numpy(), o1.numpy(), **TOL)
    np.testing.assert_allclose(lse.numpy(), lse1.numpy(), **TOL)


def test_split_counts_its_plain_calls():
    case = CASES[0]
    q, k, v = (torch.from_numpy(x) for x in _inputs(case))
    before = fwd_mod.flash_fwd_splitkv_plain.calls
    ops.flash_attention(q, k, v, MaskSpec(), block_q=BLOCK, block_kv=BLOCK, kv_splits=3)
    assert fwd_mod.flash_fwd_splitkv_plain.calls == before + 1
    before = fwd_mod.flash_fwd_plain.calls
    ops.flash_attention(q, k, v, MaskSpec(), block_q=BLOCK, block_kv=BLOCK, kv_splits=1)
    assert fwd_mod.flash_fwd_plain.calls == before + 1


@pytest.mark.parametrize("spec", [dict(causal=False), dict(causal=True, q_offset=112)],
                         ids=["full", "causal_offset"])
def test_short_q_long_kv(spec):
    """The shape the split exists for (JAX ``test_occupancy.py:241``): one q
    tile against many kv tiles. Four splits against the single pass and the
    JAX split kernel; the auto policy splits here."""
    B, Sq, Sk, Hq, Hk = 1, 16, 128, 2, 2
    rng = np.random.default_rng(4)
    q = rng.standard_normal((B, Sq, Hq, D), dtype=np.float32)
    k = rng.standard_normal((B, Sk, Hk, D), dtype=np.float32)
    v = rng.standard_normal((B, Sk, Hk, D), dtype=np.float32)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    kw = dict(block_q=BLOCK, block_kv=BLOCK)
    o1, l1 = ops.flash_attention_with_lse(*t, MaskSpec(**spec), kv_splits=1, **kw)
    o4, l4 = ops.flash_attention_with_lse(*t, MaskSpec(**spec), kv_splits=4, **kw)
    o_j, l_j = flash_attention_pallas_with_lse(q, k, v, JaxMaskSpec(**spec), num_q_bands=1,
                                               kv_splits=4, interpret=True, use_tuned=False,
                                               **kw)
    np.testing.assert_allclose(o4.numpy(), o1.numpy(), **TOL)
    np.testing.assert_allclose(l4.numpy(), l1.numpy(), **TOL)
    np.testing.assert_allclose(o4.numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(l4.numpy(), np.asarray(l_j), **TOL)
    # t_kv = 8 tiles, each its own split at bh = 2
    assert ops.resolve_kv_splits(None, q.shape, k.shape, BLOCK, BLOCK) == 8


@pytest.mark.parametrize("bwd", ["fused", "split"])
def test_split_forward_gradients_match_single_pass(bwd):
    """Gradients through a split forward equal the single-pass ones (JAX
    ``test_occupancy.py:262``): the backward reads the folded (o, lse)."""
    rng = np.random.default_rng(5)
    shapes = ((2, 48, 4, D), (2, 48, 2, D), (2, 48, 2, D), (2, 48, 4, D))
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)) for s in shapes)

    def grads(ks):
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        o = ops.flash_attention(*xs, MaskSpec(causal=True), block_q=BLOCK, block_kv=BLOCK,
                                bwd=bwd, kv_splits=ks)
        (o * do).sum().backward()
        return [x.grad for x in xs]

    for a, b in zip(grads(3), grads(1)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def _partials(rng, P, lead, rows, d, dead):
    """P partials (P, *lead, rows, d) / (P, *lead, rows); ``dead`` marks
    (partial, row) pairs that saw nothing: (0, -inf)."""
    o = rng.standard_normal((P, *lead, rows, d)).astype(np.float32)
    lse = (3 * rng.standard_normal((P, *lead, rows))).astype(np.float32)
    for p, r in dead:
        o[p, ..., r, :] = 0.0
        lse[p, ..., r] = -np.inf
    return torch.from_numpy(o), torch.from_numpy(lse)


@pytest.mark.parametrize("P", [1, 2, 3, 13])
def test_fold_partials_matches_the_merge_tree(P):
    """The one-pass fold of the split-KV forward equals the merge tree of
    ``combine_lse_outputs`` (the JAX package's order) up to rounding; rows
    no partial saw give (0, -inf), rows some partials missed ignore them."""
    rng = np.random.default_rng(P)
    dead = [(p, 0) for p in range(P)] + [(p, 1) for p in range(0, P - 1, 2)]
    o, lse = _partials(rng, P, (2, 3), 5, D, dead)
    want_o, want_lse = combine_lse_outputs(o, lse)
    got_o, got_lse = fold_partials(o.movedim(0, 2), lse.movedim(0, 2), dim=2)
    np.testing.assert_allclose(got_o.numpy(), want_o.numpy(), **TOL)
    np.testing.assert_allclose(got_lse.numpy(), want_lse.numpy(), **TOL)
    assert torch.isneginf(got_lse[..., 0]).all() and (got_o[..., 0, :] == 0).all()
    assert torch.isfinite(got_lse[..., 1:]).all()


# (B * Hq, t_q, t_kv) -> splits. Target: 132 SMs x 1 CTA = 132 at every head
# dim (a forward CTA of 384 threads at 168 registers fills an SM's register
# file); before the forward's Hopper redesign 396 at head_dim 64, 264 at 128.
# floor(132 / bh), not the ceiling, so the split CTAs fit one wave: the
# H100 sweep at whisper's cross-attention prefill measured 4 splits faster
# than 5 at B = 4 and 16 faster than 17 at B = 1.
POLICY = [
    ((32, 1, 24), 4),     # whisper-base cross-attention prefill, B = 4
    ((8, 1, 24), 16),     # B = 1
    ((33, 1, 24), 4),
    ((8, 1, 5), 5),       # the reduced whisper of the CPU tests: every kv tile
    ((32, 24, 24), 1),    # encoder self-attention: q tiles fill the card
    ((32, 2, 24), 1),     # more than one q tile: no split
    ((32, 1, 3), 1),      # fewer than 4 kv tiles
    ((132, 1, 24), 1),    # batch x heads alone fill the card
    ((131, 1, 24), 1),
    ((264, 1, 24), 1),
]


@pytest.mark.parametrize("args,want", POLICY, ids=lambda x: str(x))
def test_auto_policy_table(args, want):
    assert ops.default_kv_splits(*args) == want


def test_partition_knobs_are_checked():
    for bad in (0, -1, True, 1.5):
        with pytest.raises(ValueError, match="kv_splits"):
            AttentionConfig(kv_splits=bad)
    q = torch.zeros((1, 8, 2, D))
    with pytest.raises(ValueError, match="kv_splits"):
        ops.flash_attention(q, q, q, MaskSpec(), kv_splits=0)
    # Explicit values are clamped to the tile count, as in the JAX package.
    assert ops.resolve_kv_splits(99, (1, 100, 2, D), (1, 300, 2, D)) == 5
