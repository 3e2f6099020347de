"""The CUDA kernels against their plain PyTorch versions on the card.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed. On a machine with an NVIDIA GPU, from the repo
root (``--noconftest`` because tests/conftest.py imports JAX):

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_kernels_gpu.py

Without a card every test skips (decided inside the fixture, never at
import, so every pytest worker collects the same tests).
"""

import dataclasses
import math

import pytest
import torch

from repro_torch.configs import registry
from repro_torch.core.attention import AttentionConfig
from repro_torch.core.masks import MaskSpec
from repro_torch.kernels import flash_bwd as bwd_mod
from repro_torch.kernels import flash_decode as dec_mod
from repro_torch.kernels import flash_fwd as fwd_mod
from repro_torch.kernels import ops
from repro_torch.launch.steps import build_train_step
from repro_torch.models.lm import init_lm
from repro_torch.models.moe import MoE
from repro_torch.serving.engine import PagedServingEngine, Request, ServingEngine
from repro_torch.training.optimizer import AdamWConfig, init_opt_state

# bf16 outputs (one bf16 ulp near |o| ~ 1 is 0.008); f32 lse.
O_TOL, LSE_TOL = 2e-2, 1e-3
# f32 delta from bf16 O and dO: summation order only.
DELTA_TOL = 1e-4
# f32 gradients, relative to the largest |gradient| of the tensor: the kernel
# and its plain version round P and dS to bf16 at the same places, so the
# differences are summation order, the order of the fused dq's adds, and
# a value that lands one bf16 ulp apart.
GRAD_REL_TOL = 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _randn(gen, shape, dev):
    return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)


def _err(a, b):
    fin = torch.isfinite(b)
    assert torch.equal(torch.isfinite(a), fin)
    return (a.float()[fin] - b.float()[fin]).abs().max().item()


# (B, S, Hkv, spec, view) at 32 q heads: an odd number of q tiles (S 64, 300,
# 700: the last CTA of q-tile pairs holds one), an even one (S 333, 2048,
# 200), GQA G 4 and G 1, q_offset -100 (rows 64-99 see no key inside a
# visited tile), and strided views (q a head slice, k and v from one packed
# tensor) that the TMA maps read in place.
FWD_CASES = [
    (1, 64, 8, dict(causal=True), "contiguous"),
    (1, 700, 8, dict(causal=True), "contiguous"),
    (4, 2048, 8, dict(causal=True), "contiguous"),
    (2, 300, 8, dict(causal=True), "contiguous"),
    (1, 333, 8, dict(causal=True, window=100, sink=4), "contiguous"),
    (2, 200, 8, dict(causal=False), "contiguous"),
    (1, 700, 8, dict(causal=True, q_offset=-100), "contiguous"),
    (1, 700, 32, dict(causal=True), "contiguous"),
    (2, 700, 8, dict(causal=True), "strided"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("D", [128, 256, 160])
@pytest.mark.parametrize("B,S,Hkv,spec,view", FWD_CASES)
def test_forward_kernel_matches_plain(cuda, B, S, Hkv, spec, view, D):
    """The forward against its plain version; ``_err`` also asserts that the
    kernel's outputs are finite exactly where the plain version's are."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = ops._prep(_randn(gen, (B, S, 32, D), cuda), 1 / math.sqrt(D))
    k, v = _randn(gen, (B, S, Hkv, D), cuda), _randn(gen, (B, S, Hkv, D), cuda)
    if view == "strided":
        wide = torch.zeros((B, S, 64, D), dtype=q.dtype, device=cuda)
        wide[:, :, 32:] = q
        kv = torch.stack((k, v), dim=2)  # (B, S, 2, Hkv, D)
        q, k, v = wide[:, :, 32:], kv[:, :, 0], kv[:, :, 1]
        assert not any(x.is_contiguous() for x in (q, k, v))
    spec = MaskSpec(**spec)
    before = fwd_mod.flash_fwd.launches
    o, lse = fwd_mod.flash_fwd(q, k, v, spec, block_q=64, block_kv=64)
    torch.cuda.synchronize()
    assert fwd_mod.flash_fwd.launches == before + 1
    o_p, lse_p = fwd_mod.flash_fwd_plain(q, k, v, spec, block_q=64, block_kv=64)
    assert _err(o, o_p) < O_TOL
    assert _err(lse, lse_p) < LSE_TOL


def _past_lengths(x, lengths, value):
    """The cache x (B, S, Hkv, D) with ``value`` in every row at or past its
    batch row's length."""
    rows = torch.arange(x.shape[1], device=x.device)[None, :]
    past = rows >= torch.tensor(lengths, device=x.device)[:, None]
    return x.masked_fill(past[:, :, None, None], value)


# (S, lengths, window, sink, splits, stale): a length 0, 1, one that ends
# inside a 16-row unit and the full cache; S 700 (chunks of 88 and 48
# rows: units cut at the split's end); a window with sinks; and NaN in every
# cache row at or past its length ("stale": the partials must be those with
# zeros there, bit for bit).
DECODE_CASES = [
    (2048, [1, 0, 777, 2048], None, 0, 8, False),
    (2048, [2048, 5, 1500, 64], 300, 4, 8, False),
    (700, [700, 0, 333, 17], None, 0, 8, False),
    (700, [700, 1, 333, 16], 100, 4, 17, False),
    (700, [699, 0, 333, 17], None, 0, 17, True),
    (2048, [2048, 5, 1500, 64], 300, 4, 8, True),
]


@pytest.mark.gpu
@pytest.mark.parametrize("D", [128, 64, 256, 160])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("S,lengths,window,sink,splits,stale", DECODE_CASES)
def test_decode_kernel_matches_plain(cuda, S, lengths, window, sink, splits, stale, G, D):
    gen = torch.Generator(device=cuda).manual_seed(1)
    B, Hkv = 4, 8
    q = _randn(gen, (B * Hkv, G, D), cuda)
    k, v = _randn(gen, (B, S, Hkv, D), cuda), _randn(gen, (B, S, Hkv, D), cuda)
    k, v = _past_lengths(k, lengths, 0.0), _past_lengths(v, lengths, 0.0)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = dec_mod.flash_decode.launches
    o, lse = dec_mod.flash_decode(q, k, v, lens, num_splits=splits, window=window, sink=sink)
    torch.cuda.synchronize()
    assert dec_mod.flash_decode.launches == before + 1
    o_p, lse_p = dec_mod.flash_decode_plain(q, k, v, lens, num_splits=splits,
                                            window=window, sink=sink)
    assert _err(o, o_p) < O_TOL
    assert _err(lse, lse_p) < LSE_TOL
    ns, _ = dec_mod.decode_geometry(S, splits)
    empty = lens == 0
    assert (o.reshape(B, Hkv, ns, G, D)[empty] == 0).all()
    assert torch.isneginf(lse.reshape(B, Hkv, ns, G)[empty]).all()
    if stale:
        nan = float("nan")
        o_n, lse_n = dec_mod.flash_decode(q, _past_lengths(k, lengths, nan),
                                          _past_lengths(v, lengths, nan), lens,
                                          num_splits=splits, window=window, sink=sink)
        torch.cuda.synchronize()
        assert torch.equal(o, o_n) and torch.equal(lse, lse_n)


@pytest.mark.gpu
def test_kernels_reject_what_they_do_not_take(cuda):
    q = torch.zeros((1, 64, 4, 128), device=cuda)  # float32
    with pytest.raises(TypeError, match="bfloat16"):
        fwd_mod.flash_fwd(q, q, q, MaskSpec(causal=True), block_q=64, block_kv=64)
    qb = q.to(torch.bfloat16)
    with pytest.raises(ValueError, match="block_q"):
        fwd_mod.flash_fwd(qb, qb, qb, MaskSpec(causal=True), block_q=32, block_kv=64)
    # Every mode of the forward is built at 64, 128, 160 and 256 (split-KV
    # too, with and without segments; test_split_forward_kernel_matches_plain
    # runs it at 160 and 256): a head dim with no kernel refuses in each,
    # before the launch.
    ids = torch.zeros((1, 256), dtype=torch.int32, device=cuda)
    spec = MaskSpec(causal=True)
    qd = torch.zeros((1, 256, 4, 96), dtype=torch.bfloat16, device=cuda)
    for call in (
            lambda: fwd_mod.flash_fwd(qd, qd, qd, spec, block_q=64, block_kv=64),
            lambda: fwd_mod.flash_fwd_splitkv(qd, qd, qd, spec, block_q=64, block_kv=64,
                                              kv_splits=2),
            lambda: fwd_mod.flash_fwd_splitkv_varlen(qd, qd, qd, spec, ids, ids, block_q=64,
                                                     block_kv=64, kv_splits=2)):
        with pytest.raises(ValueError, match=r"head_dim in \(64, 128, 160, 256\), got 96"):
            call()


def _rel_err(a, b):
    assert torch.isfinite(a).all()
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-6)


# (B, S, Hq, view): the training shapes at 32 heads, whisper's and gpt-20m's
# head counts (the kernel takes 8 to 64 positions a CTA by Hq), lengths no
# block of positions divides, and a transposed dO (head stride above the
# row stride), which the kernel reads through its strides.
DELTA_CASES = [
    (1, 64, 32, "contiguous"),
    (2, 700, 32, "contiguous"),
    (2, 2048, 32, "contiguous"),
    (8, 1500, 8, "contiguous"),
    (8, 448, 8, "contiguous"),
    (8, 512, 4, "contiguous"),
    (3, 333, 4, "contiguous"),
    (1, 13, 8, "contiguous"),
    (2, 700, 32, "transposed"),
    (3, 333, 8, "transposed"),
]


def _counts(wrapper):
    """A backward wrapper's (launches, and those at head_dim 64, 160, 256)."""
    return (wrapper.launches, wrapper.hd64_launches, wrapper.hd160_launches,
            wrapper.hd256_launches)


def _after_one(before, D):
    """The counts of ``_counts`` after one launch at head_dim D."""
    return (before[0] + 1, before[1] + (D == 64), before[2] + (D == 160),
            before[3] + (D == 256))


@pytest.mark.gpu
@pytest.mark.parametrize("D", [128, 64, 256, 160])
@pytest.mark.parametrize("B,S,Hq,view", DELTA_CASES)
def test_delta_kernel_matches_plain(cuda, B, S, Hq, view, D):
    gen = torch.Generator(device=cuda).manual_seed(2)
    o, do = _randn(gen, (B, S, Hq, D), cuda), _randn(gen, (B, S, Hq, D), cuda)
    if view == "transposed":
        do = do.transpose(1, 2).contiguous().transpose(1, 2)
        assert not do.is_contiguous()
    before = _counts(bwd_mod.flash_bwd_delta)
    delta = bwd_mod.flash_bwd_delta(o, do)
    torch.cuda.synchronize()
    assert _counts(bwd_mod.flash_bwd_delta) == _after_one(before, D)
    assert _err(delta, bwd_mod.flash_bwd_delta_plain(o, do)) < DELTA_TOL


# The backward kernels' cases: GQA and MHA, ragged lengths, a window with
# sinks, non-causal, and rows that see no key: whole q tiles (q_offset
# -128) and, off the tile grid (q_offset -100), rows 64-99 of a tile the
# kernels visit, whose lse is the finite mask value. The KV-stationary kernels run
# one CTA per pair of kv tiles, so also: an odd number of kv tiles (the last
# CTA holds one tile: S = 700 and 333 at G = 1 and 4; 64 < S <= 128 is one
# whole pair), and in every causal case the pair's second tile is hidden at
# the pair's first q tile. "strided": q, k, v and dO are views through
# strides (a head slice, a packed kv tensor, a transposed dO), as TMA reads
# them.
BWD_CASES = [
    (1, 64, 32, 8, dict(causal=True), "contiguous"),
    (2, 700, 32, 8, dict(causal=True), "contiguous"),
    (1, 256, 8, 8, dict(causal=True), "contiguous"),
    (1, 333, 32, 8, dict(causal=True, window=100, sink=4), "contiguous"),
    (2, 200, 16, 4, dict(causal=False), "contiguous"),
    (1, 300, 32, 8, dict(causal=True, q_offset=-128), "contiguous"),  # rows 0-127 see nothing
    (1, 300, 32, 8, dict(causal=True, q_offset=-100), "contiguous"),  # rows 0-99 see nothing
    (1, 700, 8, 8, dict(causal=True), "contiguous"),
    (2, 333, 32, 8, dict(causal=True), "contiguous"),
    (1, 128, 32, 8, dict(causal=True), "contiguous"),
    (1, 700, 32, 8, dict(causal=True, window=256), "contiguous"),
    (2, 700, 32, 8, dict(causal=True), "strided"),
    (1, 333, 8, 8, dict(causal=True, window=100, sink=4), "strided"),
    # G 1 and 4 at q_offset -100 with an odd number of q tiles (the dQ
    # kernel's last CTA holds one), one through strided views
    (1, 700, 8, 8, dict(causal=True, q_offset=-100), "strided"),
    (2, 333, 32, 8, dict(causal=True, q_offset=-100), "contiguous"),
]


def _bwd_inputs(cuda, B, S, Hq, Hkv, spec, view="contiguous", D=128, Skv=None):
    """q, k, v, dO at head_dim D (S q rows, Skv kv rows: S unless given),
    the forward kernel's lse and the delta kernel's delta."""
    Skv = S if Skv is None else Skv
    gen = torch.Generator(device=cuda).manual_seed(3)
    q = ops._prep(_randn(gen, (B, S, Hq, D), cuda), 1 / math.sqrt(D))
    k, v = _randn(gen, (B, Skv, Hkv, D), cuda), _randn(gen, (B, Skv, Hkv, D), cuda)
    do = _randn(gen, (B, S, Hq, D), cuda)
    if view == "strided":
        wide = torch.zeros((B, S, 2 * Hq, D), dtype=q.dtype, device=cuda)
        wide[:, :, Hq:] = q
        kv = torch.stack((k, v), dim=2)  # (B, Skv, 2, Hkv, D)
        q, k, v = wide[:, :, Hq:], kv[:, :, 0], kv[:, :, 1]
        do = do.transpose(1, 2).contiguous().transpose(1, 2)  # head stride > row stride
        assert not any(x.is_contiguous() for x in (q, k, v, do))
    o, lse = fwd_mod.flash_fwd(q, k, v, spec, block_q=64, block_kv=64)
    return q, k, v, do, lse, bwd_mod.flash_bwd_delta(o, do)


def _unseen_rows(spec):
    """The q rows of whole tiles that see no key (q_offset < 0): no CTA
    visits them, so their dq is 0. A row that sees no key inside a visited
    tile is not among them: its P is 1 (the finite mask value), as in the
    plain version, and its dq need not be 0."""
    return max(-spec.q_offset, 0) // 64 * 64


# Head dim 256 (gemma3-1b): its grouping (4 q heads over one kv head), its
# 512-token window and the window with sinks, at the training length and at
# ragged ones (odd numbers of tiles: the KV-stationary and dq kernels own
# one tile a CTA at 256), rows that see no key (q_offset -100), G 1, and
# strided views.
G3_BWD_CASES = [
    (4, 2048, 4, 1, dict(causal=True), "contiguous"),
    (4, 2048, 4, 1, dict(causal=True, window=512), "contiguous"),
    (1, 700, 4, 1, dict(causal=True, window=512), "contiguous"),
    (2, 333, 4, 1, dict(causal=True, window=100, sink=4), "strided"),
    (1, 300, 4, 1, dict(causal=True, q_offset=-100), "contiguous"),
    (2, 200, 4, 4, dict(causal=False), "contiguous"),
    (1, 64, 4, 1, dict(causal=True), "contiguous"),
]

# Head dim 160 (stablelm-12b): 32 q heads over 8 kv heads, causal, at the
# training shape and a ragged length (the KV-stationary kernels own one
# tile a CTA at 160, the dq kernel a pair of q tiles: odd tile counts at
# 1500 and 333), a window with sinks through strided views, rows that see
# no key (q_offset -100), G 1 without a mask, and one tile.
SL_BWD_CASES = [
    (2, 2048, 32, 8, dict(causal=True), "contiguous"),
    (1, 1500, 32, 8, dict(causal=True), "contiguous"),
    (2, 333, 32, 8, dict(causal=True, window=100, sink=4), "strided"),
    (1, 300, 32, 8, dict(causal=True, q_offset=-100), "contiguous"),
    (2, 200, 8, 8, dict(causal=False), "contiguous"),
    (1, 64, 32, 8, dict(causal=True), "contiguous"),
]


# Rectangular and ragged shapes at whisper's sizes and beyond, (B, Sq, Skv,
# H, spec): the cross-attention (448 decoder rows against 1500 frames,
# FULL), the encoder (1500 frames, FULL: a 28-row tail tile on both axes),
# and a causal chunk of 300 q rows at the end of 700 keys (q_offset 400).
RECT_CASES = [
    (2, 448, 1500, 8, dict()),
    (2, 1500, 1500, 8, dict()),
    (1, 300, 700, 8, dict(causal=True, q_offset=400)),
]


@pytest.mark.gpu
@pytest.mark.parametrize("D", [128, 64, 256])
@pytest.mark.parametrize("B,S,Hq,Hkv,spec,view", BWD_CASES)
def test_fused_backward_kernel_matches_plain(cuda, B, S, Hq, Hkv, spec, view, D):
    _check_fused(cuda, B, S, S, Hq, Hkv, spec, view, D)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,Hq,Hkv,spec,view", G3_BWD_CASES)
def test_fused_backward_kernel_at_gemma3_shapes_matches_plain(cuda, B, S, Hq, Hkv, spec, view):
    _check_fused(cuda, B, S, S, Hq, Hkv, spec, view, 256)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,Hq,Hkv,spec,view", SL_BWD_CASES)
def test_fused_backward_kernel_at_stablelm_shapes_matches_plain(cuda, B, S, Hq, Hkv, spec, view):
    _check_fused(cuda, B, S, S, Hq, Hkv, spec, view, 160)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [128, 64])
@pytest.mark.parametrize("B,Sq,Skv,H,spec", RECT_CASES)
def test_fused_backward_kernel_on_rectangular_shapes(cuda, B, Sq, Skv, H, spec, D):
    _check_fused(cuda, B, Sq, Skv, H, H, spec, "contiguous", D)


def _check_fused(cuda, B, Sq, Skv, Hq, Hkv, spec, view, D):
    spec = MaskSpec(**spec)
    args = (*_bwd_inputs(cuda, B, Sq, Hq, Hkv, spec, view, D, Skv), spec)
    before = _counts(bwd_mod.flash_bwd_fused)
    got = bwd_mod.flash_bwd_fused(*args, block_q=64, block_kv=64)
    torch.cuda.synchronize()
    assert _counts(bwd_mod.flash_bwd_fused) == _after_one(before, D)
    want = bwd_mod.flash_bwd_fused_plain(*args, block_q=64, block_kv=64)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        assert torch.isfinite(a).all(), name
        assert _rel_err(a, b) < GRAD_REL_TOL, name
    assert (got[0][:, :_unseen_rows(spec)] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("D", [128, 64, 256])
@pytest.mark.parametrize("B,S,Hq,Hkv,spec,view", BWD_CASES)
def test_split_backward_kernels_match_plain_and_fused(cuda, B, S, Hq, Hkv, spec, view, D):
    """dkv and dq against their plain versions; dk and dv bitwise the fused
    kernel's (the same body without its dQ phase), the dense schedule's and,
    through the SEG kernels, all-ones ids' (the same walk, products and
    order); dq bitwise the same from a second launch (no atomics), the
    dense schedule's and all-ones ids'; zeros where a row sees no key
    (every head dim has its dense kernels)."""
    _check_split(cuda, B, S, S, Hq, Hkv, spec, view, D)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,Hq,Hkv,spec,view", G3_BWD_CASES)
def test_split_backward_kernels_at_gemma3_shapes_match_plain_and_fused(cuda, B, S, Hq, Hkv,
                                                                       spec, view):
    _check_split(cuda, B, S, S, Hq, Hkv, spec, view, 256)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,Hq,Hkv,spec,view", SL_BWD_CASES)
def test_split_backward_kernels_at_stablelm_shapes_match_plain_and_fused(cuda, B, S, Hq, Hkv,
                                                                         spec, view):
    _check_split(cuda, B, S, S, Hq, Hkv, spec, view, 160)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [128, 64])
@pytest.mark.parametrize("B,Sq,Skv,H,spec", RECT_CASES)
def test_split_backward_kernels_on_rectangular_shapes(cuda, B, Sq, Skv, H, spec, D):
    _check_split(cuda, B, Sq, Skv, H, H, spec, "contiguous", D)


def _check_split(cuda, B, S, Skv, Hq, Hkv, spec, view, D):
    spec = MaskSpec(**spec)
    args = (*_bwd_inputs(cuda, B, S, Hq, Hkv, spec, view, D, Skv), spec)
    tiles = dict(block_q=64, block_kv=64)
    before = (_counts(bwd_mod.flash_bwd_dkv), _counts(bwd_mod.flash_bwd_dq))
    dk, dv = bwd_mod.flash_bwd_dkv(*args, **tiles)
    dq = bwd_mod.flash_bwd_dq(*args, **tiles)
    dq2 = bwd_mod.flash_bwd_dq(*args, **tiles)
    _, dk_f, dv_f = bwd_mod.flash_bwd_fused(*args, **tiles)
    torch.cuda.synchronize()
    assert _counts(bwd_mod.flash_bwd_dkv) == _after_one(before[0], D)
    assert _counts(bwd_mod.flash_bwd_dq) == _after_one(_after_one(before[1], D), D)
    # The SEG kernels on all-ones ids (every head dim), and the dense ones.
    ones = torch.ones((B, S), dtype=torch.int32, device=cuda)
    kv_ones = torch.ones((B, Skv), dtype=torch.int32, device=cuda)
    same_dkv = [(dk_f, dv_f), bwd_mod.flash_bwd_fused_varlen(*args, ones, kv_ones, **tiles)[1:],
                bwd_mod.flash_bwd_dkv_varlen(*args, ones, kv_ones, **tiles)]
    same_dq = [dq2, bwd_mod.flash_bwd_dq_varlen(*args, ones, kv_ones, **tiles)]
    same_dkv += [bwd_mod.flash_bwd_fused(*args, schedule="dense", **tiles)[1:],
                 bwd_mod.flash_bwd_dkv(*args, schedule="dense", **tiles)]
    same_dq += [bwd_mod.flash_bwd_dq(*args, schedule="dense", **tiles)]
    torch.cuda.synchronize()
    dk_p, dv_p = bwd_mod.flash_bwd_dkv_plain(*args, **tiles)
    dq_p = bwd_mod.flash_bwd_dq_plain(*args, **tiles)
    for name, a, b in (("dq", dq, dq_p), ("dk", dk, dk_p), ("dv", dv, dv_p)):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        assert torch.isfinite(a).all(), name
        assert _rel_err(a, b) < GRAD_REL_TOL, name
    for dk_x, dv_x in same_dkv:
        assert torch.equal(dk, dk_x) and torch.equal(dv, dv_x)
    assert all(torch.equal(dq, dq_x) for dq_x in same_dq)
    assert (dq[:, :_unseen_rows(spec)] == 0).all()


@pytest.mark.gpu
def test_backward_dense_kernels_are_the_compact_ones_at_head_dim_256(cuda):
    """At head_dim 256 the backward kernels are built in both schedules,
    without and with segments: each dense kernel launches (counted as a
    dense launch and as one at 256) and gives the compact kernel's dK, dV
    and split dQ to the bit, the fused dQ within the tolerance."""
    _check_dense_modes(cuda, 256)


@pytest.mark.gpu
def test_backward_dense_kernels_are_the_compact_ones_at_head_dim_160(cuda):
    """The same at head_dim 160."""
    _check_dense_modes(cuda, 160)


def _check_dense_modes(cuda, D):
    spec = MaskSpec(causal=True)
    args = (*_bwd_inputs(cuda, 1, 256, 4, 1, spec, D=D), spec)
    ids = torch.ones((1, 256), dtype=torch.int32, device=cuda)
    ids[:, 100:] = 2  # two documents: a tile that needs the element mask
    tiles = dict(block_q=64, block_kv=64)
    dense = dict(schedule="dense", **tiles)
    wrappers = (bwd_mod.flash_bwd_fused, bwd_mod.flash_bwd_dkv, bwd_mod.flash_bwd_dq,
                bwd_mod.flash_bwd_fused_varlen, bwd_mod.flash_bwd_dkv_varlen,
                bwd_mod.flash_bwd_dq_varlen)
    before = [(f.launches, f.dense_launches, getattr(f, f"hd{D}_launches")) for f in wrappers]
    for seg in ((), (ids, ids)):
        fused, dkv, dq = wrappers[3:] if seg else wrappers[:3]
        got = fused(*args, *seg, **dense), dkv(*args, *seg, **dense), dq(*args, *seg, **dense)
        want = fused(*args, *seg, **tiles), dkv(*args, *seg, **tiles), dq(*args, *seg, **tiles)
        torch.cuda.synchronize()
        assert torch.equal(got[0][1], want[0][1]) and torch.equal(got[0][2], want[0][2])
        assert _rel_err(got[0][0], want[0][0]) < GRAD_REL_TOL
        assert torch.equal(got[1][0], want[1][0]) and torch.equal(got[1][1], want[1][1])
        assert torch.equal(got[2], want[2])
        assert all(torch.isfinite(x).all() for x in (*got[0], *got[1], got[2]))
    assert [(f.launches, f.dense_launches, getattr(f, f"hd{D}_launches")) for f in wrappers] == [
        (n + 1, d + 1, w + 2) for n, d, w in before]


# The head split at 160 and 256 (``flash_bwd.kv_head_split``), (B, Sq, Skv,
# Hq, Hkv, spec): an odd number of kv tiles with Skv not a multiple of 64
# (700), a causal chunk of 300 q rows at the end of 700 keys (q_offset 400),
# gemma3's 512 window at its training length (most of a CTA's q heads'
# steps hidden), q_offset -100 (rows that see no key), G 4 at stablelm's
# grouping, and G 1 (no split to take).
SPLIT_CASES = [
    (1, 700, 700, 4, 1, dict(causal=True)),
    (2, 300, 700, 4, 1, dict(causal=True, q_offset=400)),
    (1, 2048, 2048, 4, 1, dict(causal=True, window=512)),
    (1, 300, 300, 4, 1, dict(causal=True, q_offset=-100)),
    (1, 333, 333, 32, 8, dict(causal=True)),
    (2, 333, 333, 4, 4, dict(causal=True)),
]


@pytest.mark.gpu
@pytest.mark.parametrize("D", [256, 160])
@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,spec", SPLIT_CASES)
def test_head_split_layout_against_the_plain_grid(cuda, B, Sq, Skv, Hq, Hkv, spec, D):
    """The fused and dK/dV kernels with the group's q heads split one a CTA
    (the partials summed by the group-sum kernel) and on the plain grid, in
    every mode (compact and dense, without and with segments): each against
    the plain version; dK and dV of the two layouts equal up to the group
    sum's order; within a layout, split dK/dV bitwise the fused kernel's
    and bitwise over two launches; one group-sum launch a split launch and
    none on the plain grid."""
    spec = MaskSpec(**spec)
    args = (*_bwd_inputs(cuda, B, Sq, Hq, Hkv, spec, D=D, Skv=Skv), spec)
    G = Hq // Hkv
    q_ids = torch.ones((B, Sq), dtype=torch.int32, device=cuda)
    kv_ids = torch.ones((B, Skv), dtype=torch.int32, device=cuda)
    q_ids[:, Sq // 3:] = 2  # two documents: steps that need the element mask
    kv_ids[:, Skv // 3:] = 2
    want = {seg: bwd_mod.flash_bwd_fused_plain(*args, block_q=64, block_kv=64,
                                               **(dict(q_seg=q_ids, kv_seg=kv_ids) if seg else {}))
            for seg in (False, True)}
    for seg in (False, True):
        for schedule in ("compact", "dense"):
            segments = (q_ids, kv_ids) if seg else None
            got = {}
            for hsplit in ((1, G) if G > 1 else (1,)):
                before = bwd_mod.flash_bwd_group_sum.launches
                dq = torch.zeros(args[0].shape, dtype=torch.float32, device=cuda)
                fused = bwd_mod._launch_kv(True, *args, 64, 64, dq, segments, schedule, hsplit)
                dkv = [bwd_mod._launch_kv(False, *args, 64, 64, None, segments, schedule, hsplit)
                       for _ in range(2)]
                torch.cuda.synchronize()
                assert bwd_mod.flash_bwd_group_sum.launches == before + (3 if hsplit > 1 else 0)
                for name, a, b in zip(("dq", "dk", "dv"), (dq, *fused), want[seg]):
                    assert torch.isfinite(a).all(), name
                    assert _rel_err(a, b) < GRAD_REL_TOL, (name, hsplit, schedule, seg)
                for dk, dv in dkv:
                    assert torch.equal(dk, fused[0]) and torch.equal(dv, fused[1])
                got[hsplit] = fused
            if G > 1:
                for a, b in zip(got[1], got[G]):
                    assert _rel_err(a, b) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("D", [256, 160])
@pytest.mark.parametrize("G", [2, 4])
def test_group_sum_kernel_matches_plain(cuda, G, D):
    """The group-sum kernel against its plain version: the same f32 adds in
    the same order, so bitwise; at (B, Skv, Hkv) = (2, 700, 3)."""
    gen = torch.Generator(device=cuda).manual_seed(G)
    pk, pv = (torch.randn((2, 700, 3 * G, D), generator=gen, device=cuda) for _ in range(2))
    before = (bwd_mod.flash_bwd_group_sum.launches,
              getattr(bwd_mod.flash_bwd_group_sum, f"hd{D}_launches"))
    dk, dv = bwd_mod.flash_bwd_group_sum(pk, pv, 3)
    torch.cuda.synchronize()
    assert (bwd_mod.flash_bwd_group_sum.launches,
            getattr(bwd_mod.flash_bwd_group_sum, f"hd{D}_launches")) == (before[0] + 1,
                                                                         before[1] + 1)
    want = bwd_mod.flash_bwd_group_sum_plain(pk, pv, 3)
    assert dk.shape == (2, 700, 3, D)
    assert torch.equal(dk, want[0]) and torch.equal(dv, want[1])


def _zeroed(counters, plains):
    """Zero the wrappers' launch counts (their head_dim-64, 160 and 256 ones
    too, where they keep them) and the plain versions' call counts."""
    for f in counters:
        f.launches = 0
        for attr in ("hd64_launches", "hd160_launches", "hd256_launches"):
            if hasattr(f, attr):
                setattr(f, attr, 0)
    for f in plains:
        f.calls = 0


BWD_COUNTERS = (fwd_mod.flash_fwd, bwd_mod.flash_bwd_delta, bwd_mod.flash_bwd_fused,
                bwd_mod.flash_bwd_dkv, bwd_mod.flash_bwd_dq)
BWD_PLAINS = (fwd_mod.flash_fwd_plain, bwd_mod.flash_bwd_delta_plain,
              bwd_mod.flash_bwd_fused_plain, bwd_mod.flash_bwd_dkv_plain,
              bwd_mod.flash_bwd_dq_plain)


@pytest.mark.gpu
@pytest.mark.parametrize("bwd", ["fused", "split"])
def test_training_step_runs_through_the_kernels(cuda, bwd):
    """A 2-layer, full-width qwen3-8b step through flash_cuda launches the
    forward twice a layer (remat), the delta kernel once a layer, then the
    fused kernel or the dkv and dq kernels once a layer, and no plain
    version."""
    cfg = dataclasses.replace(registry.get("qwen3-8b"), num_layers=2)
    model = init_lm(cfg, seed=0, device=cuda)
    state = init_opt_state(dict(model.named_parameters()))
    step = build_train_step(cfg, AttentionConfig(impl="flash_cuda", bwd=bwd), AdamWConfig())
    tokens = torch.randint(0, cfg.vocab_size, (1, 257), generator=torch.Generator().manual_seed(0))
    batch = {"inputs": tokens[:, :-1].to(cuda), "targets": tokens[:, 1:].to(cuda)}
    _zeroed(BWD_COUNTERS, BWD_PLAINS)
    state, metrics = step(model, state, batch)
    torch.cuda.synchronize()
    want = [4, 2, 2, 0, 0] if bwd == "fused" else [4, 2, 0, 2, 2]
    assert [f.launches for f in BWD_COUNTERS] == want
    assert [f.calls for f in BWD_PLAINS] == [0] * 5
    assert math.isfinite(metrics["loss"]) and math.isfinite(metrics["grad_norm"])
    assert metrics["skipped"] == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("bwd", ["fused", "split"])
def test_gpt20m_bf16_training_runs_through_the_head_dim_64_kernels(cuda, bwd):
    """Two steps of the gpt-20m preset (4 layers, 4 heads of 64, no remat)
    in bf16 through the train CLI's ``train``: per layer and step the
    forward once, delta once, then the fused kernel or dK/dV and dQ once,
    all at head_dim 64; no plain version."""
    from repro_torch.launch.train import PRESETS, TrainLoopConfig, train

    cfg = dataclasses.replace(PRESETS["gpt-20m"], dtype="bfloat16")
    _zeroed(BWD_COUNTERS, BWD_PLAINS)
    loop = TrainLoopConfig(steps=2, seq_len=256, batch_size=2, attn_bwd=bwd, log_every=1)
    _, _, history = train(cfg, loop)
    torch.cuda.synchronize()
    n = 2 * cfg.num_layers
    want = [n, n, n, 0, 0] if bwd == "fused" else [n, n, 0, n, n]
    assert [f.launches for f in BWD_COUNTERS] == want
    assert [f.hd64_launches for f in BWD_COUNTERS[1:]] == want[1:]
    assert [f.calls for f in BWD_PLAINS] == [0] * 5
    assert all(math.isfinite(x) for x in history["loss"] + history["grad_norm"])


@pytest.mark.gpu
def test_whisper_training_step_runs_through_the_kernels(cuda):
    """A whisper-base step at full width and depth (6 + 6 layers, d_model
    512, 8 heads of 64, remat) on 1500 frames and 448 tokens: every
    attention call (encoder FULL, decoder causal, cross 448 x 1500) runs the
    forward twice (remat), delta once and the fused kernel once, at head_dim
    64; no plain version; the loss and gradient norm are finite. (At 448
    rows the cross-attention has 7 q tiles, so the forward does not split
    the kv axis.)"""
    from repro_torch.models.whisper import init_whisper

    cfg = registry.get("whisper-base")
    model = init_whisper(cfg, seed=0, device=cuda)
    state = init_opt_state(dict(model.named_parameters()))
    step = build_train_step(cfg, AttentionConfig(impl="flash_cuda"), AdamWConfig())
    gen = torch.Generator(device=cuda).manual_seed(15)
    frames = torch.randn((2, 1500, cfg.d_model), generator=gen, device=cuda).to(torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab_size, (2, 449), generator=gen, device=cuda)
    batch = {"frames": frames, "inputs": tokens[:, :-1], "targets": tokens[:, 1:]}
    _zeroed(BWD_COUNTERS, BWD_PLAINS)
    state, metrics = step(model, state, batch)
    torch.cuda.synchronize()
    n = cfg.encoder.num_layers + 2 * cfg.num_layers  # attention calls a step
    assert [f.launches for f in BWD_COUNTERS] == [2 * n, n, n, 0, 0]
    assert [f.hd64_launches for f in BWD_COUNTERS[1:]] == [n, n, 0, 0]
    assert [f.calls for f in BWD_PLAINS] == [0] * 5
    assert math.isfinite(metrics["loss"]) and math.isfinite(metrics["grad_norm"])
    assert metrics["skipped"] == 0.0


@pytest.mark.gpu
def test_gemma3_training_step_runs_through_the_head_dim_256_kernels(cuda):
    """One step of one layer pattern (5 windowed layers, 1 global) of
    full-width gemma3-1b (head_dim 256, 4 q heads over 1 kv head) from the
    same weights and batch through impl="ref" and through flash_cuda with
    the fused and with the split backward: per layer the forward twice
    (remat), delta once, then the fused kernel or dK/dV and dQ once, all at
    head_dim 256; no plain version; the loss within 1e-4 of the
    reference's (only attention's rounding differs) and the gradient
    norms within 1%."""
    cfg = dataclasses.replace(registry.get("gemma3-1b"), num_layers=6)
    assert cfg.head_dim == 256 and cfg.window == 512 and cfg.remat
    _training_step_against_ref(cuda, cfg, 256)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,layers,D", [("gemma3-1b", 6, 256), ("stablelm-12b", 2, 160)])
def test_packed_training_step_at_head_dims_256_and_160_runs_through_the_varlen_kernels(
        cuda, arch, layers, D):
    """The gemma3-1b and stablelm-12b steps above on a packed batch of the
    varlen source: only the segment variants at head_dim 256 or 160 run (no
    unsegmented kernel, no plain version), against impl="ref" with the
    segment mask."""
    cfg = dataclasses.replace(registry.get(arch), num_layers=layers)
    assert cfg.head_dim == D
    _training_step_against_ref(cuda, cfg, D, packed=True)


@pytest.mark.gpu
def test_stablelm_training_step_runs_through_the_head_dim_160_kernels(cuda):
    """The same for two layers of full-width stablelm-12b (head_dim 160, 32
    q heads over 8 kv heads, qk-norm, untied), all at head_dim 160."""
    cfg = dataclasses.replace(registry.get("stablelm-12b"), num_layers=2)
    assert cfg.head_dim == 160 and cfg.qk_norm and cfg.remat
    _training_step_against_ref(cuda, cfg, 160)


VARLEN_COUNTERS = (fwd_mod.flash_fwd_varlen, bwd_mod.flash_bwd_delta,
                   bwd_mod.flash_bwd_fused_varlen, bwd_mod.flash_bwd_dkv_varlen,
                   bwd_mod.flash_bwd_dq_varlen)


def _training_step_against_ref(cuda, cfg, D, packed=False):
    if packed:
        from repro_torch.data.pipeline import DataConfig, SyntheticVarlenLM

        data = SyntheticVarlenLM(DataConfig(2, 1024, cfg.vocab_size, seed=0, source="packed"))
        batch = {k: torch.from_numpy(x).to(cuda) for k, x in data.batch(0).items()}
    else:
        tokens = torch.randint(0, cfg.vocab_size, (2, 1025),
                               generator=torch.Generator().manual_seed(0))
        batch = {"inputs": tokens[:, :-1].to(cuda), "targets": tokens[:, 1:].to(cuda)}
    counters = VARLEN_COUNTERS if packed else BWD_COUNTERS
    # Every counter of the other kind but delta's (both kinds share it).
    others = (BWD_COUNTERS if packed else VARLEN_COUNTERS)[:1] + \
        (BWD_COUNTERS if packed else VARLEN_COUNTERS)[2:]
    out = {}
    for run in ("ref", "fused", "split"):
        model = init_lm(cfg, seed=0, device=cuda)
        state = init_opt_state(dict(model.named_parameters()))
        attn = AttentionConfig(impl="ref") if run == "ref" else AttentionConfig(bwd=run)
        _zeroed(counters + others, BWD_PLAINS)
        state, out[run] = build_train_step(cfg, attn, AdamWConfig())(model, state, batch)
        torch.cuda.synchronize()
        n = cfg.num_layers
        want = {"ref": [0] * 5, "fused": [2 * n, n, n, 0, 0], "split": [2 * n, n, 0, n, n]}[run]
        assert [f.launches for f in counters] == want
        assert [f.launches for f in others] == [0] * 4
        wide = counters if packed else counters[1:]
        assert [getattr(f, f"hd{D}_launches") for f in wide] == want[len(want) - len(wide):]
        assert [f.calls for f in BWD_PLAINS] == [0] * 5
        assert math.isfinite(out[run]["loss"]) and out[run]["skipped"] == 0.0
        del model, state
    for run in ("fused", "split"):
        assert abs(out[run]["loss"] - out["ref"]["loss"]) <= 1e-4 * abs(out["ref"]["loss"])
        assert abs(out[run]["grad_norm"] / out["ref"]["grad_norm"] - 1) <= 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("D,hq,hkv", [(160, 32, 8), (256, 4, 1)])
def test_default_splits_at_head_dims_160_and_256_run_the_split_kv_kernel(cuda, D, hq, hkv):
    """A default ``ops.flash_attention`` of a short q against a long kv at
    head_dim 160 and 256: the auto policy takes ``default_kv_splits`` (4 at
    stablelm's 32 q heads, 24 at gemma3's 4: one kv tile a split), so the
    split-KV kernel runs once and the single-pass kernel never; its output
    matches its plain version and the single pass's (``kv_splits=1``)."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    q = _randn(gen, (1, 64, hq, D), cuda)
    k, v = _randn(gen, (1, 1536, hkv, D), cuda), _randn(gen, (1, 1536, hkv, D), cuda)
    spec = MaskSpec(causal=True, q_offset=1536 - 64)
    ks = ops.resolve_kv_splits(None, q.shape, k.shape)
    assert ks == ops.default_kv_splits(hq, 1, 24) == {160: 4, 256: 24}[D]
    before = (fwd_mod.flash_fwd.launches, fwd_mod.flash_fwd_splitkv.launches)
    o = ops.flash_attention(q, k, v, spec)
    torch.cuda.synchronize()
    assert (fwd_mod.flash_fwd.launches, fwd_mod.flash_fwd_splitkv.launches) == (
        before[0], before[1] + 1)
    ref = fwd_mod.flash_fwd_splitkv_plain(ops._prep(q, 1 / math.sqrt(D)), k, v, spec,
                                          block_q=64, block_kv=64, kv_splits=ks)
    assert _err(o, ref.o) < O_TOL
    assert _err(o, ops.flash_attention(q, k, v, spec, kv_splits=1)) < O_TOL


@pytest.mark.gpu
def test_split_backward_is_bitwise_reproducible(cuda):
    """ops.flash_attention(bwd="split") forward and backward twice: the same
    dq, dk and dv to the bit."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    q0, k0, v0 = (_randn(gen, (2, 1000, h, 128), cuda) for h in (32, 8, 8))
    do = _randn(gen, (2, 1000, 32, 128), cuda)
    grads = []
    for _ in range(2):
        q, k, v = (x.clone().requires_grad_() for x in (q0, k0, v0))
        ops.flash_attention(q, k, v, bwd="split").backward(do)
        grads.append((q.grad, k.grad, v.grad))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    assert all(torch.isfinite(g.float()).all() for g in grads[0])


def _planes(c, table, ps):
    """Page planes (Hkv, B * n_pages + 1, ps, D) holding the contiguous cache
    c (B, n_pages * ps, Hkv, D) at the physical pages of table (B, n_pages)."""
    B, S, Hkv, D = c.shape
    out = torch.zeros((Hkv, B * (S // ps) + 1, ps, D), dtype=c.dtype, device=c.device)
    out[:, table.long()] = c.reshape(B, S // ps, ps, Hkv, D).permute(3, 0, 1, 2, 4)
    return out


# (ps, G, window, sink, S, stale): S / ps pages a row; "stale" fills every
# pool row that no length reaches (past each length inside its last page,
# the unused pages, the null page) with NaN, and the kernel must give the
# partials it gives with zeros there; 25 and 10 pages are not a multiple of
# the 8 splits; pages of 128 rows go as two bulk copies each, the window
# leaving some of them out.
PAGED_CASES = [
    (16, 4, None, 0, 512, False),
    (64, 1, None, 0, 512, False),
    (16, 8, 256, 4, 512, False),
    (64, 4, 100, 0, 512, False),
    (8, 2, None, 0, 512, False),
    (16, 4, None, 0, 400, True),
    (64, 8, 100, 4, 640, True),
    (128, 4, 100, 4, 640, True),
]


@pytest.mark.gpu
@pytest.mark.parametrize("D", [128, 256, 160, 64])
@pytest.mark.parametrize("ps,G,window,sink,S,stale", PAGED_CASES)
def test_paged_decode_kernel_matches_plain(cuda, ps, G, window, sink, S, stale, D):
    """The paged kernel against its plain version (ragged lengths with 0 and
    an odd-page length); bitwise the same partials under a second shuffle
    of the physical pages; (0, -inf) partials for the length-0 row; with
    ``stale``, the same partials with NaN in the rows no length reaches.
    At D 160 and 256 a page of more than 32 rows goes as pieces of 32, at
    64 and 128 a page of more than 64 rows as pieces of 64."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    B, Hkv = 4, 8
    q = _randn(gen, (B * Hkv, G, D), cuda)
    kc, vc = _randn(gen, (B, S, Hkv, D), cuda), _randn(gen, (B, S, Hkv, D), cuda)
    lens = torch.tensor([0, 1, 333, S], dtype=torch.int32, device=cuda)
    if stale:
        past = torch.arange(S, device=cuda)[None] >= lens[:, None]  # (B, S)
        kc, vc = (c.masked_fill(past[..., None, None], 0.0) for c in (kc, vc))
    parts = []
    for seed in (0, 1):
        perm = torch.randperm(B * (S // ps), generator=torch.Generator().manual_seed(seed)) + 1
        table = perm.reshape(B, S // ps).to(device=cuda, dtype=torch.int32)
        kp, vp = _planes(kc, table, ps), _planes(vc, table, ps)
        table[0] = 0  # the length-0 slot's all-null row
        before = dec_mod.flash_decode_paged.launches
        parts.append(dec_mod.flash_decode_paged(q, kp, vp, lens, table, num_splits=8,
                                                window=window, sink=sink))
        torch.cuda.synchronize()
        assert dec_mod.flash_decode_paged.launches == before + 1
    (o, lse), (o2, lse2) = parts
    o_p, lse_p = dec_mod.flash_decode_paged_plain(q, kp, vp, lens, table, num_splits=8,
                                                  window=window, sink=sink)
    assert o.shape == o_p.shape and lse.shape == lse_p.shape
    assert _err(o, o_p) < O_TOL
    assert _err(lse, lse_p) < LSE_TOL
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert (o[:Hkv] == 0).all() and torch.isneginf(lse[:Hkv]).all()
    if stale:
        pos = torch.arange(S, device=cuda)
        live = torch.zeros(kp.shape[1:3], dtype=torch.bool, device=cuda)  # (pages, ps)
        for b in range(B):
            seen = pos < lens[b]
            live[table[b, pos[seen] // ps].long(), pos[seen] % ps] = True
        kn, vn = (x.masked_fill(~live[None, :, :, None], float("nan")) for x in (kp, vp))
        o3, lse3 = dec_mod.flash_decode_paged(q, kn, vn, lens, table, num_splits=8,
                                              window=window, sink=sink)
        torch.cuda.synchronize()
        assert torch.equal(o2, o3) and torch.equal(lse2, lse3)


# (S, lengths, window, sink, G, Hkv): gemma3's decode (one kv head, G 4,
# window 512), qwen3's, granite-moe's (8 kv heads, G 2); pages of 16 cut
# the cache where the contiguous kernel's 16-row units do.
PAGED_AS_CONTIGUOUS_CASES = [
    (2048, [1, 0, 777, 2048], None, 0, 4, 1),
    (2048, [15, 108, 708, 1508], 512, 0, 4, 1),
    (2048, [2048, 5, 1500, 64], 300, 4, 4, 8),
    (2048, [15, 108, 708, 1508], None, 0, 2, 8),
]


@pytest.mark.gpu
@pytest.mark.parametrize("D", [128, 256, 160, 64])
@pytest.mark.parametrize("S,lengths,window,sink,G,Hkv", PAGED_AS_CONTIGUOUS_CASES)
def test_paged_decode_at_page_size_16_is_bitwise_the_contiguous_kernel(
        cuda, S, lengths, window, sink, G, Hkv, D):
    """Both decodes share their unit math, dealing and merge: through
    shuffled pages of 16 the paged partials are the contiguous kernel's to
    the bit."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    B, ps = len(lengths), 16
    q = _randn(gen, (B * Hkv, G, D), cuda)
    kc, vc = _randn(gen, (B, S, Hkv, D), cuda), _randn(gen, (B, S, Hkv, D), cuda)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    perm = torch.randperm(B * (S // ps), generator=torch.Generator().manual_seed(0)) + 1
    table = perm.reshape(B, S // ps).to(device=cuda, dtype=torch.int32)
    kw = dict(num_splits=8, window=window, sink=sink)
    o_c, lse_c = dec_mod.flash_decode(q, kc, vc, lens, **kw)
    o_p, lse_p = dec_mod.flash_decode_paged(q, _planes(kc, table, ps), _planes(vc, table, ps),
                                            lens, table, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o_c, o_p) and torch.equal(lse_c, lse_p)


@pytest.mark.gpu
def test_paged_decode_kernel_rejects_what_it_does_not_take(cuda):
    lens = torch.ones((1,), dtype=torch.int32, device=cuda)
    table = torch.ones((1, 4), dtype=torch.int32, device=cuda)

    def call(G=4, D=128, dtype=torch.bfloat16, tbl=table):
        q = torch.zeros((2, G, D), dtype=dtype, device=cuda)
        kp = torch.zeros((2, 5, 16, D), dtype=dtype, device=cuda)
        return dec_mod.flash_decode_paged(q, kp, kp, lens, tbl)

    with pytest.raises(TypeError, match="bfloat16"):
        call(dtype=torch.float32)
    with pytest.raises(ValueError, match="head_dim"):
        call(D=96)
    with pytest.raises(ValueError, match="q heads"):
        call(G=16)
    with pytest.raises(ValueError, match="contiguous"):
        call(tbl=torch.ones((1, 8), dtype=torch.int32, device=cuda)[:, ::2])
    with pytest.raises(TypeError, match="int32"):
        call(tbl=table.long())


@pytest.mark.gpu
def test_paged_engine_runs_through_the_kernels(cuda):
    """2-layer, full-width qwen3-8b through PagedServingEngine on flash_cuda,
    with a pool that makes admission wait and growth preempt once: every
    request finishes with max_new + 1 tokens, every prefill goes through the
    forward kernel and every decode through the paged kernel, and neither
    the contiguous decode kernel nor a plain version runs."""
    cfg = dataclasses.replace(registry.get("qwen3-8b"), num_layers=2)
    model = init_lm(cfg, seed=0, device=cuda)
    engine = PagedServingEngine(cfg, model, AttentionConfig(impl="flash_cuda"), max_batch=4,
                                num_pages=150, page_size=16, pages_per_seq_max=128)
    gen = torch.Generator().manual_seed(0)
    for rid, n in enumerate((7, 100, 700, 1500, 33, 260)):
        prompt = torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()
        engine.submit(Request(rid=rid, prompt=prompt, max_new_tokens=16))
    kernels = (fwd_mod.flash_fwd, dec_mod.flash_decode, dec_mod.flash_decode_paged)
    plains = (fwd_mod.flash_fwd_plain, dec_mod.flash_decode_plain,
              dec_mod.flash_decode_paged_plain)
    for f in kernels:
        f.launches = 0
    for f in plains:
        f.calls = 0
    with torch.no_grad():
        finished = engine.run(max_ticks=200)
    torch.cuda.synchronize()
    assert sorted(finished) == list(range(6))
    for req in finished.values():
        assert len(req.generated) == 17
        assert all(0 <= t < cfg.vocab_size for t in req.generated)
    assert engine.preemptions == 1 and engine.pool.used_pages == 0
    fwd_n, dec_n, paged_n = (f.launches for f in kernels)
    assert fwd_n > 0 and paged_n == engine.ticks * cfg.num_layers and dec_n == 0
    assert [f.calls for f in plains] == [0, 0, 0]


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True])
def test_gemma3_engines_run_through_the_head_dim_256_kernels(cuda, paged):
    """One layer pattern (5 windowed layers, 1 global) of full-width
    gemma3-1b (head_dim 256, one kv head for four q heads) through both
    engines (``_engine_runs_through_the_kernels``)."""
    cfg = dataclasses.replace(registry.get("gemma3-1b"), num_layers=6)
    assert cfg.head_dim == 256 and cfg.window == 512
    _engine_runs_through_the_kernels(cuda, cfg, paged)


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True])
def test_stablelm_engines_run_through_the_head_dim_160_kernels(cuda, paged):
    """Two layers of full-width stablelm-12b (head_dim 160, 32 q heads over 8
    kv heads, qk-norm, untied) through both engines
    (``_engine_runs_through_the_kernels``)."""
    cfg = dataclasses.replace(registry.get("stablelm-12b"), num_layers=2)
    assert cfg.head_dim == 160 and cfg.qk_norm
    _engine_runs_through_the_kernels(cuda, cfg, paged)


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True])
def test_granite_engines_run_through_the_head_dim_64_kernels(cuda, paged):
    """Two layers of full-width granite-moe-1b-a400m (head_dim 64, 16 q heads
    over 8 kv heads, 32 experts top 8) through both engines
    (``_engine_runs_through_the_kernels``)."""
    cfg = dataclasses.replace(registry.get("granite-moe-1b-a400m"), num_layers=2)
    assert cfg.head_dim == 64 and cfg.moe.num_experts == 32
    _engine_runs_through_the_kernels(cuda, cfg, paged)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 1), (1, 1536)])
def test_moe_layer_reads_nothing_back_to_the_host(cuda, shape):
    """One MoE layer of full-width granite (bf16) on a decode tick's (4, 1)
    and a prefill's (1, 1536) input under the sync debug mode "error": no
    step of the layer synchronises with the host (so a CUDA graph could
    capture it), and its output is finite."""
    cfg = registry.get("granite-moe-1b-a400m")
    layer = MoE(cfg, cuda, torch.bfloat16)
    with torch.no_grad():
        layer.init_(torch.Generator(device=cuda).manual_seed(0))
        gen = torch.Generator(device=cuda).manual_seed(1)
        x = torch.randn((*shape, cfg.d_model), generator=gen, device=cuda).to(torch.bfloat16)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            y, aux = layer(x, with_aux=False)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        assert aux is None and y.shape == x.shape and torch.isfinite(y).all()


def _engine_runs_through_the_kernels(cuda, cfg, paged):
    """``cfg`` through the fixed-slot or the paged engine on flash_cuda:
    every request finishes with max_new + 1 tokens, every prefill goes
    through the forward kernel and every decode through the decode kernel
    of the engine; no plain version runs."""
    model = init_lm(cfg, seed=0, device=cuda)
    attn = AttentionConfig(impl="flash_cuda")
    if paged:
        engine = PagedServingEngine(cfg, model, attn, max_batch=4, num_pages=150, page_size=16,
                                    pages_per_seq_max=128)
    else:
        engine = ServingEngine(cfg, model, attn, max_batch=4, cache_size=2048)
    gen = torch.Generator().manual_seed(0)
    for rid, n in enumerate((7, 100, 700, 1500, 33, 260)):
        prompt = torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()
        engine.submit(Request(rid=rid, prompt=prompt, max_new_tokens=16))
    kernels = (fwd_mod.flash_fwd, dec_mod.flash_decode, dec_mod.flash_decode_paged)
    plains = (fwd_mod.flash_fwd_plain, dec_mod.flash_decode_plain,
              dec_mod.flash_decode_paged_plain)
    for f in kernels:
        f.launches = 0
    for f in plains:
        f.calls = 0
    with torch.no_grad():
        finished = engine.run(max_ticks=200)
    torch.cuda.synchronize()
    assert sorted(finished) == list(range(6))
    for req in finished.values():
        assert len(req.generated) == 17
        assert all(0 <= t < cfg.vocab_size for t in req.generated)
    fwd_n, dec_n, paged_n = (f.launches for f in kernels)
    assert fwd_n > 0 and (paged_n if paged else dec_n) == engine.ticks * cfg.num_layers
    assert (dec_n if paged else paged_n) == 0
    assert [f.calls for f in plains] == [0, 0, 0]


# ----------------------------------------------------------- packed (varlen)


def _packed_ids(B, S, seed=0):
    """Step 0's segment ids of the packed synthetic source, int32 on the CPU."""
    from repro_torch.data.pipeline import DataConfig, SyntheticVarlenLM

    ids = SyntheticVarlenLM(DataConfig(B, S, 512, seed=seed, source="packed")).batch(0)
    return torch.from_numpy(ids["segment_ids"])


def _distinct_ids(B, S, hidden=64):
    """q and kv ids that differ: q rows 0 .. hidden - 1 carry an id no key
    has (hidden = 64: a whole q tile that sees nothing; 32: half of a tile
    the kernels visit, rows whose lse is the finite mask value); the last 64
    keys an id no query has, so their kv tile gets zero dK and dV."""
    q = torch.ones((B, S), dtype=torch.int32)
    q[:, S // 2:] = 2
    kv = q.clone()
    q[:, :hidden] = 7
    kv[:, -64:] = 9
    return q, kv


# (B, S, Hq, Hkv, spec, ids, D): the training shape with the packed source's
# ids, GQA G in {1, 4} at a ragged length, a window with sinks, non-causal,
# and distinct q and kv ids ("distinct" hides a whole q tile, "half" half of
# one); at head_dim 256 gemma3-1b's training shape (4 q heads over 1, causal
# and its 512 window) and at 160 stablelm-12b's (32 over 8), each also
# ragged, windowed with sinks and with distinct and half-hidden ids.
VARLEN_CASES = [
    (2, 2048, 32, 8, dict(causal=True), "packed", 128),
    (1, 700, 32, 8, dict(causal=True), "packed", 128),
    (1, 700, 8, 8, dict(causal=True), "packed", 128),
    (1, 500, 32, 8, dict(causal=True, window=100, sink=4), "packed", 128),
    (2, 300, 16, 4, dict(causal=False), "packed", 128),
    (2, 700, 32, 8, dict(causal=True), "distinct", 128),
    (2, 700, 32, 8, dict(causal=True), "half", 128),
    (1, 700, 8, 8, dict(causal=True), "half", 128),
    (1, 333, 32, 8, dict(causal=True, window=100, sink=4), "half", 128),
    (4, 2048, 4, 1, dict(causal=True), "packed", 256),
    (4, 2048, 4, 1, dict(causal=True, window=512), "packed", 256),
    (1, 700, 4, 1, dict(causal=True, window=100, sink=4), "packed", 256),
    (2, 700, 4, 1, dict(causal=True), "distinct", 256),
    (1, 333, 4, 1, dict(causal=True, window=512), "half", 256),
    (2, 2048, 32, 8, dict(causal=True), "packed", 160),
    (1, 700, 32, 8, dict(causal=True, window=100, sink=4), "packed", 160),
    (2, 700, 32, 8, dict(causal=True), "distinct", 160),
    (1, 333, 32, 8, dict(causal=True), "half", 160),
]


def _varlen_inputs(cuda, B, S, Hq, Hkv, spec, ids, D=128):
    if ids == "packed":
        q_seg = kv_seg = _packed_ids(B, S).to(cuda)
    else:
        hidden = 64 if ids == "distinct" else 32
        q_seg, kv_seg = (x.to(cuda) for x in _distinct_ids(B, S, hidden))
    gen = torch.Generator(device=cuda).manual_seed(6)
    q = ops._prep(_randn(gen, (B, S, Hq, D), cuda), 1 / math.sqrt(D))
    k, v = _randn(gen, (B, S, Hkv, D), cuda), _randn(gen, (B, S, Hkv, D), cuda)
    do = _randn(gen, (B, S, Hq, D), cuda)
    return q, k, v, do, q_seg, kv_seg


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,Hq,Hkv,spec,ids,D", VARLEN_CASES)
def test_varlen_kernels_match_plain(cuda, B, S, Hq, Hkv, spec, ids, D):
    """The SEG forward, fused, dK/dV and dQ kernels against their plain
    versions; split dK/dV bitwise the fused kernel's, split dQ bitwise over
    two launches; with distinct ids, (0, -inf) and zero gradients where a
    tile sees nothing."""
    spec = MaskSpec(**spec)
    q, k, v, do, q_seg, kv_seg = _varlen_inputs(cuda, B, S, Hq, Hkv, spec, ids, D)
    tiles = dict(block_q=64, block_kv=64)
    counters = (fwd_mod.flash_fwd_varlen, bwd_mod.flash_bwd_fused_varlen,
                bwd_mod.flash_bwd_dkv_varlen, bwd_mod.flash_bwd_dq_varlen)
    before = [f.launches for f in counters]
    wide = [getattr(f, f"hd{D}_launches", 0) for f in counters]
    o, lse = fwd_mod.flash_fwd_varlen(q, k, v, spec, q_seg, kv_seg, **tiles)
    delta = bwd_mod.flash_bwd_delta(o, do)
    args = (q, k, v, do, lse, delta, spec, q_seg, kv_seg)
    fused = bwd_mod.flash_bwd_fused_varlen(*args, **tiles)
    dk, dv = bwd_mod.flash_bwd_dkv_varlen(*args, **tiles)
    dq = bwd_mod.flash_bwd_dq_varlen(*args, **tiles)
    dq2 = bwd_mod.flash_bwd_dq_varlen(*args, **tiles)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 1, 2]
    if D in (160, 256):
        assert [getattr(f, f"hd{D}_launches") - b for f, b in zip(counters, wide)] == [1, 1, 1, 2]
    plain = dict(q_seg=q_seg, kv_seg=kv_seg, **tiles)
    o_p, lse_p = fwd_mod.flash_fwd_plain(q, k, v, spec, **plain)
    assert _err(o, o_p) < O_TOL
    assert _err(lse, lse_p) < LSE_TOL
    want = bwd_mod.flash_bwd_fused_plain(*args[:7], **plain)
    for name, a, b in zip(("dq", "dk", "dv"), fused, want):
        assert torch.isfinite(a).all(), name
        assert _rel_err(a, b) < GRAD_REL_TOL, name
    assert _rel_err(dq, bwd_mod.flash_bwd_dq_plain(*args[:7], **plain)) < GRAD_REL_TOL
    for a, b in zip((dk, dv), bwd_mod.flash_bwd_dkv_plain(*args[:7], **plain)):
        assert _rel_err(a, b) < GRAD_REL_TOL
    assert torch.equal(dk, fused[1]) and torch.equal(dv, fused[2])
    assert torch.equal(dq, dq2)
    if ids == "distinct":
        assert (o[:, :64] == 0).all() and torch.isneginf(lse[..., :64]).all()
        assert (dq[:, :64] == 0).all() and (fused[0][:, :64] == 0).all()
        assert (dk[:, -64:] == 0).all() and (dv[:, -64:] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("D,Hq,Hkv,window", [(128, 32, 8, None), (256, 4, 1, None),
                                             (256, 4, 1, 512), (160, 32, 8, None)])
@pytest.mark.parametrize("S", [700, 2048])
def test_all_ones_ids_are_bitwise_the_unsegmented_kernels(cuda, S, D, Hq, Hkv, window):
    """One segment per row: every SEG kernel gives the unsegmented kernel's
    outputs to the bit (the fused dq excepted: the order of its adds changes
    from launch to launch, so dq is held through the split dQ kernel), at
    qwen3's, gemma3-1b's (also with its window) and stablelm-12b's widths."""
    spec = MaskSpec(causal=True, window=window)
    q, k, v, do, _, _ = _varlen_inputs(cuda, 2, S, Hq, Hkv, spec, "packed", D)
    ones = torch.ones((2, S), dtype=torch.int32, device=cuda)
    tiles = dict(block_q=64, block_kv=64)
    o, lse = fwd_mod.flash_fwd(q, k, v, spec, **tiles)
    o_s, lse_s = fwd_mod.flash_fwd_varlen(q, k, v, spec, ones, ones, **tiles)
    delta = bwd_mod.flash_bwd_delta(o, do)
    args = (q, k, v, do, lse, delta, spec)
    _, dk_f, dv_f = bwd_mod.flash_bwd_fused(*args, **tiles)
    _, dk_fs, dv_fs = bwd_mod.flash_bwd_fused_varlen(*args, ones, ones, **tiles)
    dk, dv = bwd_mod.flash_bwd_dkv(*args, **tiles)
    dk_s, dv_s = bwd_mod.flash_bwd_dkv_varlen(*args, ones, ones, **tiles)
    dq = bwd_mod.flash_bwd_dq(*args, **tiles)
    dq_s = bwd_mod.flash_bwd_dq_varlen(*args, ones, ones, **tiles)
    torch.cuda.synchronize()
    assert torch.equal(o, o_s) and torch.equal(lse, lse_s)
    assert torch.equal(dk_f, dk_fs) and torch.equal(dv_f, dv_fs)
    assert torch.equal(dk, dk_s) and torch.equal(dv, dv_s) and torch.equal(dq, dq_s)


@pytest.mark.gpu
@pytest.mark.parametrize("bwd", ["fused", "split"])
def test_packed_training_step_runs_through_the_varlen_kernels(cuda, bwd):
    """A packed 2-layer, full-width qwen3-8b step launches only the segment
    variants (forward twice a layer, then fused or dK/dV + dQ once), the
    delta kernel once a layer, no unsegmented kernel and no plain version."""
    from repro_torch.data.pipeline import DataConfig, SyntheticVarlenLM

    cfg = dataclasses.replace(registry.get("qwen3-8b"), num_layers=2)
    model = init_lm(cfg, seed=0, device=cuda)
    state = init_opt_state(dict(model.named_parameters()))
    step = build_train_step(cfg, AttentionConfig(impl="flash_cuda", bwd=bwd), AdamWConfig())
    data = SyntheticVarlenLM(DataConfig(1, 512, cfg.vocab_size, seed=0, source="packed"))
    batch = {k: torch.from_numpy(x).to(cuda) for k, x in data.batch(0).items()}
    counters = (fwd_mod.flash_fwd_varlen, bwd_mod.flash_bwd_delta,
                bwd_mod.flash_bwd_fused_varlen, bwd_mod.flash_bwd_dkv_varlen,
                bwd_mod.flash_bwd_dq_varlen, fwd_mod.flash_fwd, bwd_mod.flash_bwd_fused,
                bwd_mod.flash_bwd_dkv, bwd_mod.flash_bwd_dq)
    plains = (fwd_mod.flash_fwd_plain, bwd_mod.flash_bwd_delta_plain,
              bwd_mod.flash_bwd_fused_plain, bwd_mod.flash_bwd_dkv_plain,
              bwd_mod.flash_bwd_dq_plain)
    for f in counters:
        f.launches = 0
    for f in plains:
        f.calls = 0
    state, metrics = step(model, state, batch)
    torch.cuda.synchronize()
    want = [4, 2, 2, 0, 0] if bwd == "fused" else [4, 2, 0, 2, 2]
    assert [f.launches for f in counters] == want + [0, 0, 0, 0]
    assert [f.calls for f in plains] == [0] * 5
    assert math.isfinite(metrics["loss"]) and metrics["skipped"] == 0.0


# ------------------------------------------------- head dim 64, split-KV, SEG decode


def _qkv(cuda, seed, B, Sq, Skv, Hq, Hkv, D):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q = ops._prep(_randn(gen, (B, Sq, Hq, D), cuda), 1 / math.sqrt(D))
    return q, _randn(gen, (B, Skv, Hkv, D), cuda), _randn(gen, (B, Skv, Hkv, D), cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,spec", [
    (1, 700, dict(causal=False)),
    (2, 1500, dict(causal=False)),
    (4, 4, dict(causal=True)),
    (1, 333, dict(causal=True, window=100, sink=4)),
    (2, 300, dict(causal=True)),
    (1, 700, dict(causal=True, q_offset=-100)),
])
def test_forward_kernel_at_head_dim_64_matches_plain(cuda, B, S, spec):
    """The forward at whisper's widths (8 heads of 64): the encoder's FULL
    self-attention and the decoder prefill's causal one; odd numbers of q
    tiles (S 4, 300, 700: the last CTA of q-tile pairs holds one)."""
    q, k, v = _qkv(cuda, 7, B, S, S, 8, 8, 64)
    spec = MaskSpec(**spec)
    o, lse = fwd_mod.flash_fwd(q, k, v, spec, block_q=64, block_kv=64)
    torch.cuda.synchronize()
    o_p, lse_p = fwd_mod.flash_fwd_plain(q, k, v, spec, block_q=64, block_kv=64)
    assert _err(o, o_p) < O_TOL
    assert _err(lse, lse_p) < LSE_TOL


SPLIT_CASES = [
    # B, Sq, Skv, Hq, Hkv, D, spec, kv_splits
    (4, 4, 1500, 8, 8, 64, dict(causal=False), 13),   # whisper cross-attention
    (1, 4, 1500, 8, 8, 64, dict(causal=False), 24),
    (2, 4, 1500, 8, 8, 64, dict(causal=False), 5),
    (1, 64, 2048, 32, 8, 128, dict(causal=False), 9),  # qwen3 widths, G = 4
    (2, 300, 300, 32, 8, 128, dict(causal=True), 3),  # q tiles x splits, causal
    (1, 50, 900, 8, 8, 64, dict(causal=True, q_offset=850), 6),
    (1, 150, 1000, 32, 8, 128, dict(causal=True, q_offset=850), 4),  # t_q = 3
    # gemma3-1b's widths (4 q heads over 1, D 256): a short q against the
    # auto splits' key counts, the 512 window (most splits see nothing), the
    # causal prefill (t_q 24) with 2 and 3 splits, a window with sinks at an
    # odd t_q with empty splits.
    (1, 64, 1536, 4, 1, 256, dict(causal=True, q_offset=1472), 24),
    (1, 64, 8192, 4, 1, 256, dict(causal=True, q_offset=8128), 33),
    (1, 64, 1536, 4, 1, 256, dict(causal=True, window=512, q_offset=1472), 24),
    (1, 1536, 1536, 4, 1, 256, dict(causal=True), 2),
    (1, 1536, 1536, 4, 1, 256, dict(causal=True), 3),
    (1, 300, 700, 4, 1, 256, dict(causal=True, window=100, sink=4, q_offset=400), 5),
    # stablelm-12b's widths (32 q heads over 8, D 160: the tail box).
    (1, 64, 1536, 32, 8, 160, dict(causal=True, q_offset=1472), 4),
    (1, 64, 4096, 32, 8, 160, dict(causal=True, q_offset=4032), 4),
    (1, 1536, 1536, 32, 8, 160, dict(causal=True), 2),
    (1, 1536, 1536, 32, 8, 160, dict(causal=True), 3),
    (2, 20, 530, 8, 2, 160, dict(causal=False), 5),
    (1, 150, 1000, 32, 8, 160, dict(causal=True, q_offset=850), 4),
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,spec,ks", SPLIT_CASES)
def test_split_forward_kernel_matches_plain(cuda, B, Sq, Skv, Hq, Hkv, D, spec, ks):
    """The split-KV kernel's partials and fold against its plain version,
    and the folded output against the single-pass kernel."""
    q, k, v = _qkv(cuda, 8, B, Sq, Skv, Hq, Hkv, D)
    spec = MaskSpec(**spec)
    before = fwd_mod.flash_fwd_splitkv.launches
    out = fwd_mod.flash_fwd_splitkv(q, k, v, spec, block_q=64, block_kv=64, kv_splits=ks)
    torch.cuda.synchronize()
    assert fwd_mod.flash_fwd_splitkv.launches == before + 1
    ref = fwd_mod.flash_fwd_splitkv_plain(q, k, v, spec, block_q=64, block_kv=64, kv_splits=ks)
    assert out.o_parts.shape == ref.o_parts.shape == (B, Hq, fwd_mod.split_count(Skv, 64, ks),
                                                      Sq, D)
    # f32 partials; P rounds to bf16 (a flip moves o ~1e-2)
    assert _err(out.o_parts, ref.o_parts) < O_TOL
    assert _err(out.lse_parts, ref.lse_parts) < LSE_TOL
    assert out.o.shape == (B, Sq, Hq, D) and out.o.dtype == torch.bfloat16
    assert _err(out.o, ref.o) < O_TOL and _err(out.lse, ref.lse) < LSE_TOL
    o_1, lse_1 = fwd_mod.flash_fwd(q, k, v, spec, block_q=64, block_kv=64)
    assert _err(out.o, o_1) < O_TOL and _err(out.lse, lse_1) < LSE_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("Hq,Hkv,D,spec,ks", [
    (32, 8, 128, dict(causal=True), 3),
    (4, 1, 256, dict(causal=True), 2),
    (4, 1, 256, dict(causal=True, window=512), 3),
    (32, 8, 160, dict(causal=True), 2),
    (32, 8, 160, dict(causal=True), 3),
])
def test_split_forward_segment_kernel_matches_plain(cuda, Hq, Hkv, D, spec, ks):
    """The SEG split-KV kernel on packed ids (B 2, S 700) against its plain
    version, partials and fold, and the fold against the SEG single pass:
    at qwen3's, gemma3-1b's (with its window) and stablelm-12b's widths."""
    q, k, v = _qkv(cuda, 9, 2, 700, 700, Hq, Hkv, D)
    ids = _packed_ids(2, 700).to(cuda)
    spec = MaskSpec(**spec)
    out = fwd_mod.flash_fwd_splitkv_varlen(q, k, v, spec, ids, ids, block_q=64, block_kv=64,
                                           kv_splits=ks)
    torch.cuda.synchronize()
    ref = fwd_mod.flash_fwd_splitkv_plain(q, k, v, spec, block_q=64, block_kv=64, kv_splits=ks,
                                          q_seg=ids, kv_seg=ids)
    for got, want, tol in zip(out, ref, (O_TOL, LSE_TOL, O_TOL, LSE_TOL)):
        assert _err(got, want) < tol
    o_1, lse_1 = fwd_mod.flash_fwd_varlen(q, k, v, spec, ids, ids, block_q=64, block_kv=64)
    assert _err(out.o, o_1) < O_TOL and _err(out.lse, lse_1) < LSE_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("S,lengths", [(1500, [1500] * 4), (448, [5, 36, 448, 1])])
def test_decode_kernel_at_head_dim_64_matches_plain(cuda, S, lengths):
    """Whisper's decode: cross-attention over 1500 frames, self-attention
    over a 448-position cache."""
    gen = torch.Generator(device=cuda).manual_seed(10)
    B, Hkv, G, D = 4, 8, 1, 64
    q = _randn(gen, (B * Hkv, G, D), cuda)
    k, v = _randn(gen, (B, S, Hkv, D), cuda), _randn(gen, (B, S, Hkv, D), cuda)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    o, lse = dec_mod.flash_decode(q, k, v, lens, num_splits=8)
    torch.cuda.synchronize()
    o_p, lse_p = dec_mod.flash_decode_plain(q, k, v, lens, num_splits=8)
    assert _err(o, o_p) < O_TOL
    assert _err(lse, lse_p) < LSE_TOL


def _packed_cache_ids(B, S, seed=11):
    """Two to four segments a row, ids 1..4, and the query in each row's
    last segment but one row whose query is in its first."""
    g = torch.Generator().manual_seed(seed)
    kv = torch.zeros((B, S), dtype=torch.int32)
    q = torch.zeros((B,), dtype=torch.int32)
    for b in range(B):
        n = 2 + b % 3
        cuts = torch.sort(torch.randperm(S - 2, generator=g)[:n - 1] + 1).values.tolist()
        edges = [0, *cuts, S]
        for i in range(n):
            kv[b, edges[i]:edges[i + 1]] = i + 1
        q[b] = 1 if b == 1 else n
    return kv, q


def _other_segment_ids(B, S, rows, cuda):
    """Every position in the query's segment (id 1) but ``rows`` (a slice of
    positions), which carry id 2 in every batch row."""
    kv = torch.ones((B, S), dtype=torch.int32)
    kv[:, rows] = 2
    return kv.to(cuda), torch.ones((B,), dtype=torch.int32, device=cuda)


# ids: "packed" (2-4 segments a row), "other_split" (all of split 1's
# positions in another segment: that split gives (0, -inf) wherever the
# length reaches it), "other_unit" (one 16-row unit inside split 0 of other
# segments only: its softmax is skipped and the output stays finite).
@pytest.mark.gpu
@pytest.mark.parametrize("D,G,window,ids", [(128, 4, None, "packed"), (64, 1, None, "packed"),
                                            (128, 4, 300, "packed"),
                                            (128, 4, None, "other_split"),
                                            (64, 1, None, "other_split"),
                                            (128, 8, None, "other_unit"),
                                            (64, 1, None, "other_unit")])
def test_segment_decode_kernel_matches_plain(cuda, D, G, window, ids):
    gen = torch.Generator(device=cuda).manual_seed(12)
    B, S, Hkv = 4, 2048, 8
    q = _randn(gen, (B * Hkv, G, D), cuda)
    k, v = _randn(gen, (B, S, Hkv, D), cuda), _randn(gen, (B, S, Hkv, D), cuda)
    lens = torch.tensor([2048, 700, 1500, 64], dtype=torch.int32, device=cuda)
    ns, chunk = dec_mod.decode_geometry(S, 8)
    if ids == "packed":
        kv_seg, q_seg = (x.to(cuda) for x in _packed_cache_ids(B, S))
    elif ids == "other_split":
        kv_seg, q_seg = _other_segment_ids(B, S, slice(chunk, 2 * chunk), cuda)
    else:
        kv_seg, q_seg = _other_segment_ids(B, S, slice(32, 48), cuda)
    before = dec_mod.flash_decode_varlen.launches
    o, lse = dec_mod.flash_decode_varlen(q, k, v, lens, kv_seg, q_seg, num_splits=8,
                                         window=window)
    torch.cuda.synchronize()
    assert dec_mod.flash_decode_varlen.launches == before + 1
    o_p, lse_p = dec_mod.flash_decode_plain(q, k, v, lens, num_splits=8, window=window,
                                            segments=(kv_seg, q_seg))
    assert _err(o, o_p) < O_TOL
    assert _err(lse, lse_p) < LSE_TOL
    assert torch.isfinite(o).all()
    lse4 = lse.reshape(B, Hkv, ns, G)
    if ids == "packed":
        assert torch.isneginf(lse).any()  # splits outside the query's segment
    elif ids == "other_split":
        reached = lens > chunk  # rows whose length reaches into split 1
        assert torch.isneginf(lse4[reached][:, :, 1]).all()
        assert (o.reshape(B, Hkv, ns, G, D)[reached][:, :, 1] == 0).all()
        assert torch.isfinite(lse4[reached][:, :, 0]).all()
    else:
        assert torch.isfinite(lse4[:, :, 0]).all()


@pytest.mark.gpu
@pytest.mark.parametrize("D,G", [(128, 4), (64, 1)])
def test_segment_decode_with_equal_ids_is_bitwise_the_unsegmented_kernel(cuda, D, G):
    gen = torch.Generator(device=cuda).manual_seed(13)
    B, S, Hkv = 4, 2048, 8
    q = _randn(gen, (B * Hkv, G, D), cuda)
    k, v = _randn(gen, (B, S, Hkv, D), cuda), _randn(gen, (B, S, Hkv, D), cuda)
    lens = torch.tensor([1, 0, 1337, 2048], dtype=torch.int32, device=cuda)
    same = (torch.full((B, S), 3, dtype=torch.int32, device=cuda),
            torch.full((B,), 3, dtype=torch.int32, device=cuda))
    o, lse = dec_mod.flash_decode(q, k, v, lens, num_splits=8, window=500, sink=4)
    o_s, lse_s = dec_mod.flash_decode_varlen(q, k, v, lens, *same, num_splits=8, window=500,
                                             sink=4)
    torch.cuda.synchronize()
    assert torch.equal(o, o_s) and torch.equal(lse, lse_s)


@pytest.mark.gpu
def test_whisper_serving_runs_through_the_kernels(cuda):
    """A 2-layer whisper-base at full width (d_model 512, 8 heads of 64):
    prefill then 3 ticks launch the forward at D = 64 for the encoder and
    the causal prefill, the split-KV forward for the cross-attention, and
    the decode kernel for every tick's self- and cross-attention; no plain
    version runs."""
    from repro_torch.launch.steps import build_prefill_step, build_serve_step
    from repro_torch.models.whisper import init_whisper

    base = registry.get("whisper-base")
    cfg = dataclasses.replace(base, num_layers=2, learned_pos_embed=448,
                              encoder=dataclasses.replace(base.encoder, num_layers=2))
    model = init_whisper(cfg, seed=0, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(14)
    frames = torch.randn((2, 1500, cfg.d_model), generator=gen, device=cuda).to(torch.bfloat16)
    tokens = torch.tensor([[50258, 50259, 50359, 50363]] * 2, device=cuda)
    attn = AttentionConfig(impl="flash_cuda")
    counters = (fwd_mod.flash_fwd, fwd_mod.flash_fwd_splitkv, dec_mod.flash_decode)
    plains = (fwd_mod.flash_fwd_plain, fwd_mod.flash_fwd_splitkv_plain,
              dec_mod.flash_decode_plain)
    for f in counters:
        f.launches = 0
    for f in plains:
        f.calls = 0
    tok, caches, lens = build_prefill_step(cfg, attn, 448)(model, {"frames": frames,
                                                                   "inputs": tokens})
    serve = build_serve_step(cfg, attn)
    for _ in range(3):
        tok, caches = serve(model, tok, caches, lens)
        lens = lens + 1
    torch.cuda.synchronize()
    assert [f.launches for f in counters] == [4, 2, 3 * 2 * 2]
    assert [f.calls for f in plains] == [0, 0, 0]
    assert ((0 <= tok) & (tok < cfg.vocab_size)).all()


# ------------------------------------------------------- the dense schedule


# (B, S, Hq, Hkv, spec, ids, D): the training shape, G in {1, 4} at a
# ragged length, a window, a window with sinks, a non-causal window, no
# mask (no tile hidden), q_offset of either sign (-100: rows that see no
# key in a visited tile), then the segment variants on the packed source's
# ids and on distinct q and kv ids (a whole q tile or half of one hidden);
# at 256 (gemma3-1b: one kv head, the KV-stationary and dq kernels one tile
# a CTA, a 2-stage forward ring) and 160 (stablelm-12b: one kv tile a CTA,
# the dq kernel a pair of q tiles) the training shapes, gemma3's window 512
# at an odd q-tile count, the same corners, and the packed ids.
DENSE_CASES = [
    (2, 2048, 32, 8, dict(causal=True), None, 128),
    (1, 700, 32, 8, dict(causal=True), None, 128),
    (1, 700, 8, 8, dict(causal=True, window=256), None, 128),
    (1, 700, 32, 8, dict(causal=True, window=256, sink=4), None, 128),
    (1, 700, 32, 8, dict(causal=False, window=256), None, 128),
    (2, 300, 16, 4, dict(causal=False), None, 128),
    (1, 300, 32, 8, dict(causal=True, q_offset=100), None, 128),
    (1, 300, 32, 8, dict(causal=True, q_offset=-128), None, 128),
    (1, 300, 32, 8, dict(causal=True, q_offset=-100), None, 128),
    (2, 2048, 32, 8, dict(causal=True), "packed", 128),
    (1, 700, 8, 8, dict(causal=True, window=256, sink=4), "packed", 128),
    (2, 700, 32, 8, dict(causal=True), "distinct", 128),
    (2, 700, 32, 8, dict(causal=True), "half", 128),
    (1, 700, 8, 8, dict(causal=True), "half", 128),
    (4, 2048, 4, 1, dict(causal=True), None, 256),
    (4, 2048, 4, 1, dict(causal=True, window=512), None, 256),
    (1, 700, 4, 1, dict(causal=True, window=512), None, 256),
    (1, 700, 4, 4, dict(causal=True, window=256, sink=4), None, 256),
    (2, 700, 4, 1, dict(causal=False, window=256), None, 256),
    (2, 300, 4, 1, dict(causal=False), None, 256),
    (1, 300, 4, 1, dict(causal=True, q_offset=100), None, 256),
    (1, 300, 4, 1, dict(causal=True, q_offset=-100), None, 256),
    (4, 2048, 4, 1, dict(causal=True, window=512), "packed", 256),
    (2, 700, 4, 1, dict(causal=True), "distinct", 256),
    (1, 700, 4, 4, dict(causal=True), "half", 256),
    (2, 2048, 32, 8, dict(causal=True), None, 160),
    (1, 1500, 32, 8, dict(causal=True), None, 160),
    (1, 700, 8, 8, dict(causal=True, window=256, sink=4), None, 160),
    (1, 700, 32, 8, dict(causal=False, window=256), None, 160),
    (2, 300, 16, 4, dict(causal=False), None, 160),
    (1, 300, 32, 8, dict(causal=True, q_offset=100), None, 160),
    (1, 300, 32, 8, dict(causal=True, q_offset=-100), None, 160),
    (2, 2048, 32, 8, dict(causal=True), "packed", 160),
    (2, 700, 32, 8, dict(causal=True), "distinct", 160),
    (1, 700, 8, 8, dict(causal=True), "half", 160),
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,Hq,Hkv,spec,ids,D", DENSE_CASES)
def test_dense_kernels_match_plain_and_compact(cuda, B, S, Hq, Hkv, spec, ids, D):
    """Each dense kernel against its plain version, and against the compact
    kernel: the forward (o, lse), dK/dV, dQ and the fused dK/dV to the bit;
    the fused dQ (adds in no fixed order) within the tolerance. Dense
    launches count apart from compact ones."""
    spec = MaskSpec(**spec)
    if ids is None:
        gen = torch.Generator(device=cuda).manual_seed(15)
        q = ops._prep(_randn(gen, (B, S, Hq, D), cuda), 1 / math.sqrt(D))
        k, v = _randn(gen, (B, S, Hkv, D), cuda), _randn(gen, (B, S, Hkv, D), cuda)
        do = _randn(gen, (B, S, Hq, D), cuda)
        seg, fwd, names = (), fwd_mod.flash_fwd, ("fused", "dkv", "dq")
    else:
        q, k, v, do, q_seg, kv_seg = _varlen_inputs(cuda, B, S, Hq, Hkv, spec, ids, D)
        seg, fwd = (q_seg, kv_seg), fwd_mod.flash_fwd_varlen
        names = ("fused_varlen", "dkv_varlen", "dq_varlen")
    fused, dkv, dq_fn = (getattr(bwd_mod, f"flash_bwd_{n}") for n in names)
    tiles = dict(block_q=64, block_kv=64)
    dense = dict(schedule="dense", **tiles)
    plain = dict(q_seg=seg[0], kv_seg=seg[1], **dense) if seg else dense
    counters = (fwd, fused, dkv, dq_fn)
    before = [(f.launches, f.dense_launches) for f in counters]
    o, lse = fwd(q, k, v, spec, *seg, **dense)
    o_c, lse_c = fwd(q, k, v, spec, *seg, **tiles)
    delta = bwd_mod.flash_bwd_delta(o, do)
    args = (q, k, v, do, lse, delta, spec, *seg)
    got = fused(*args, **dense)
    got_c = fused(*args, **tiles)
    dk, dv = dkv(*args, **dense)
    dk_c, dv_c = dkv(*args, **tiles)
    dq = dq_fn(*args, **dense)
    dq_c = dq_fn(*args, **tiles)
    torch.cuda.synchronize()
    assert [(f.launches - a, f.dense_launches - b) for f, (a, b) in zip(counters, before)] == [
        (1, 1)] * 4
    o_p, lse_p = fwd_mod.flash_fwd_plain(q, k, v, spec, **plain)
    assert _err(o, o_p) < O_TOL and _err(lse, lse_p) < LSE_TOL
    pargs = args[:7]
    for name, a, b in zip(("dq", "dk", "dv"), got,
                          bwd_mod.flash_bwd_fused_plain(*pargs, **plain)):
        assert torch.isfinite(a).all(), name
        assert _rel_err(a, b) < GRAD_REL_TOL, name
    for name, a, b in zip(("dk", "dv"), (dk, dv), bwd_mod.flash_bwd_dkv_plain(*pargs, **plain)):
        assert _rel_err(a, b) < GRAD_REL_TOL, name
    assert _rel_err(dq, bwd_mod.flash_bwd_dq_plain(*pargs, **plain)) < GRAD_REL_TOL
    assert torch.equal(o, o_c) and torch.equal(lse, lse_c)
    assert torch.equal(dk, dk_c) and torch.equal(dv, dv_c) and torch.equal(dq, dq_c)
    assert torch.equal(got[1], got_c[1]) and torch.equal(got[2], got_c[2])
    assert _rel_err(got[0], got_c[0]) < GRAD_REL_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("seg", [False, True, "half"])
def test_dense_forward_at_head_dim_64_is_the_compact_kernel(cuda, seg):
    """The head_dim-64 dense forward (whisper's width) against its plain
    version and, to the bit, the compact kernel; without segments, with the
    packed source's ids, and with ids that hide half of the first q tile."""
    q, k, v = _qkv(cuda, 16, 2, 700, 700, 8, 8, 64)
    spec = MaskSpec(causal=True)
    if seg == "half":
        ids = tuple(x.to(cuda) for x in _distinct_ids(2, 700, hidden=32))
    else:
        ids = (_packed_ids(2, 700).to(cuda),) * 2 if seg else ()
    fwd = fwd_mod.flash_fwd_varlen if seg else fwd_mod.flash_fwd
    o, lse = fwd(q, k, v, spec, *ids, block_q=64, block_kv=64, schedule="dense")
    o_c, lse_c = fwd(q, k, v, spec, *ids, block_q=64, block_kv=64)
    torch.cuda.synchronize()
    plain = dict(q_seg=ids[0], kv_seg=ids[1]) if seg else {}
    o_p, lse_p = fwd_mod.flash_fwd_plain(q, k, v, spec, block_q=64, block_kv=64,
                                         schedule="dense", **plain)
    assert _err(o, o_p) < O_TOL and _err(lse, lse_p) < LSE_TOL
    assert torch.equal(o, o_c) and torch.equal(lse, lse_c)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,layers", [("qwen3-8b", 2), ("gemma3-1b", 6), ("stablelm-12b", 2)])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("bwd", ["fused", "split"])
def test_dense_training_step_runs_through_the_dense_kernels(cuda, bwd, packed, arch, layers):
    """A step of full-width qwen3-8b (head_dim 128), one layer pattern of
    gemma3-1b (256; 5 windowed layers, 1 global) or two layers of
    stablelm-12b (160) with schedule="dense" launches the dense kernels only
    (the forward twice a layer of the remat groups, the delta kernel once,
    then fused or dK/dV + dQ once), no compact kernel and no plain version;
    its loss is the compact step's to the bit."""
    from repro_torch.data.pipeline import DataConfig, SyntheticVarlenLM

    cfg = dataclasses.replace(registry.get(arch), num_layers=layers)
    if packed:
        data = SyntheticVarlenLM(DataConfig(1, 1024, cfg.vocab_size, seed=0, source="packed"))
        batch = {k: torch.from_numpy(x).to(cuda) for k, x in data.batch(0).items()}
    else:
        tokens = torch.randint(0, cfg.vocab_size, (1, 1025),
                               generator=torch.Generator().manual_seed(0))
        batch = {"inputs": tokens[:, :-1].to(cuda), "targets": tokens[:, 1:].to(cuda)}
    suffix = "_varlen" if packed else ""
    kernels = [getattr(fwd_mod, "flash_fwd" + suffix)] + [
        getattr(bwd_mod, f"flash_bwd_{n}{suffix}") for n in ("fused", "dkv", "dq")]
    plains = (fwd_mod.flash_fwd_plain, bwd_mod.flash_bwd_delta_plain,
              bwd_mod.flash_bwd_fused_plain, bwd_mod.flash_bwd_dkv_plain,
              bwd_mod.flash_bwd_dq_plain)
    losses = []
    for schedule in ("compact", "dense"):
        model = init_lm(cfg, seed=0, device=cuda)
        state = init_opt_state(dict(model.named_parameters()))
        attn = AttentionConfig(impl="flash_cuda", bwd=bwd, schedule=schedule)
        step = build_train_step(cfg, attn, AdamWConfig())
        for f in kernels:
            f.launches = f.dense_launches = 0
        bwd_mod.flash_bwd_delta.launches = 0
        for f in plains:
            f.calls = 0
        state, metrics = step(model, state, batch)
        torch.cuda.synchronize()
        losses.append(metrics["loss"])
        del model, state
    # The delta pre-pass has one form for both schedules.
    n = cfg.num_layers
    grouped = cfg.num_groups * cfg.group_size
    assert bwd_mod.flash_bwd_delta.launches == n
    assert [f.dense_launches for f in kernels] == [n + grouped] + (
        [n, 0, 0] if bwd == "fused" else [0, n, n])
    assert [f.launches for f in kernels] == [0, 0, 0, 0]
    assert [f.calls for f in plains] == [0] * 5
    assert math.isfinite(losses[1]) and metrics["skipped"] == 0.0
    assert losses[0] == losses[1]


# The head_dim-256 forward's two tile modes at gemma3-1b's widths (4 q heads
# over one kv head; ``flash_fwd.single_q_tile``): (B, S, mode) shapes whose
# pair grid is under one wave of SMs and take one q tile a CTA (B 1, S 1536:
# 48 pair CTAs; S 1450: an odd, ragged 23 q tiles) and one that keeps the
# pair (B 4, S 2048: 256), each causal, under the 512 window, and at
# q_offset -100 (a q tile and rows that see no key), without and with the
# packed source's ids.
HD256_SHAPES = [(1, 1536, "single"), (1, 1450, "single"), (4, 2048, "pair")]
HD256_SPECS = [dict(causal=True), dict(causal=True, window=512),
               dict(causal=True, q_offset=-100)]


def _fwd_counts(wrapper):
    return wrapper.launches, wrapper.dense_launches


@pytest.mark.gpu
@pytest.mark.parametrize("seg", [False, True], ids=["unsegmented", "packed"])
@pytest.mark.parametrize("spec", HD256_SPECS)
@pytest.mark.parametrize("B,S,mode", HD256_SHAPES)
def test_hd256_forward_in_both_tile_modes(cuda, B, S, mode, spec, seg):
    """Compact and DENSE (with and without SEG) in the mode the rule takes
    and in the other one (forced through the private override): each
    within the tolerance of its plain version in the same mode, dense
    bitwise the compact kernel, a second launch bitwise the first, one
    launch counted per call."""
    q, k, v = _qkv(cuda, 23, B, S, S, 4, 1, 256)
    assert fwd_mod.single_q_tile(B, 4, -(-S // 64), 256) == (mode == "single")
    spec = MaskSpec(**spec)
    ids = (_packed_ids(B, S).to(cuda),) * 2 if seg else ()
    plain_ids = dict(q_seg=ids[0], kv_seg=ids[1]) if seg else {}
    fwd = fwd_mod.flash_fwd_varlen if seg else fwd_mod.flash_fwd
    for single in (None, mode != "single"):
        kw = dict(block_q=64, block_kv=64, single_tile=single)
        before = _fwd_counts(fwd)
        o, lse = fwd(q, k, v, spec, *ids, **kw)
        o2, lse2 = fwd(q, k, v, spec, *ids, **kw)
        o_d, lse_d = fwd(q, k, v, spec, *ids, schedule="dense", **kw)
        torch.cuda.synchronize()
        assert _fwd_counts(fwd) == (before[0] + 2, before[1] + 1)
        o_p, lse_p = fwd_mod.flash_fwd_plain(q, k, v, spec, **plain_ids, **kw)
        assert _err(o, o_p) < O_TOL and _err(lse, lse_p) < LSE_TOL
        assert torch.equal(o, o2) and torch.equal(lse, lse2)
        assert torch.equal(o, o_d) and torch.equal(lse, lse_d)


# (B, Sq, Skv, kv splits, mode): the short-q/long-kv corner (one q tile:
# one tile a CTA, its splits' walks dealt to both warpgroups), gemma3-1b's
# split prefill (96 CTAs: one tile) and the split at its training shape
# (512: the pair).
HD256_SPLIT_CASES = [(1, 64, 8192, 16, "single"), (1, 1536, 1536, 2, "single"),
                     (4, 2048, 2048, 2, "pair")]


@pytest.mark.gpu
@pytest.mark.parametrize("seg", [False, True], ids=["unsegmented", "packed"])
@pytest.mark.parametrize("B,Sq,Skv,ks,mode", HD256_SPLIT_CASES)
def test_hd256_split_forward_in_both_tile_modes(cuda, B, Sq, Skv, ks, mode, seg):
    """SPLIT (with and without SEG) at 256 in the rule's mode and the other
    one: partials and fold within the tolerance of the plain version in the
    same mode, a second launch bitwise the first, one launch counted; at
    the corner also the single pass (t_q = 1: one tile a CTA)."""
    q, k, v = _qkv(cuda, 29, B, Sq, Skv, 4, 1, 256)
    t_q = -(-Sq // 64)
    n = fwd_mod.split_count(Skv, 64, ks)
    assert fwd_mod.single_q_tile(B, 4, t_q, 256, n) == (mode == "single")
    spec = MaskSpec(causal=True, q_offset=Skv - Sq)
    ids = ()
    if seg:
        kv_ids = _packed_ids(B, Skv).to(cuda)
        ids = (kv_ids[:, Skv - Sq:].contiguous(), kv_ids)
    plain_ids = dict(q_seg=ids[0], kv_seg=ids[1]) if seg else {}
    fwd = fwd_mod.flash_fwd_splitkv_varlen if seg else fwd_mod.flash_fwd_splitkv
    for single in (None, mode != "single"):
        kw = dict(block_q=64, block_kv=64, single_tile=single)
        before = fwd.hd256_launches
        out = fwd(q, k, v, spec, *ids, kv_splits=ks, **kw)
        out2 = fwd(q, k, v, spec, *ids, kv_splits=ks, **kw)
        torch.cuda.synchronize()
        assert fwd.hd256_launches == before + 2
        ref = fwd_mod.flash_fwd_splitkv_plain(q, k, v, spec, kv_splits=ks, **plain_ids, **kw)
        assert _err(out.o, ref.o) < O_TOL and _err(out.lse, ref.lse) < LSE_TOL
        assert _err(out.o_parts, ref.o_parts) < O_TOL
        assert _err(out.lse_parts, ref.lse_parts) < LSE_TOL
        assert all(torch.equal(a, b) for a, b in zip(out, out2))
        if t_q == 1:
            single_fwd = fwd_mod.flash_fwd_varlen if seg else fwd_mod.flash_fwd
            o, lse = single_fwd(q, k, v, spec, *ids, **kw)
            torch.cuda.synchronize()
            o_p, lse_p = fwd_mod.flash_fwd_plain(q, k, v, spec, **plain_ids, **kw)
            assert _err(o, o_p) < O_TOL and _err(lse, lse_p) < LSE_TOL


# The head_dim-160 forward's two tile modes at stablelm-12b's widths (32 q
# heads over 8 kv heads): (B, S, mode) shapes whose pair grid fills the card
# and keep the pair (B 1, S 1536: 384 pair CTAs; B 2, S 2048: 1024) and one
# under a wave that takes one q tile a CTA (B 1, S 260: 96 pair CTAs, an
# odd 5 q tiles and a ragged last one), each causal, under a 512 window and
# at q_offset -100, without and with the packed source's ids.
HD160_SHAPES = [(1, 1536, "pair"), (1, 260, "single"), (2, 2048, "pair")]


@pytest.mark.gpu
@pytest.mark.parametrize("seg", [False, True], ids=["unsegmented", "packed"])
@pytest.mark.parametrize("spec", HD256_SPECS)
@pytest.mark.parametrize("B,S,mode", HD160_SHAPES)
def test_hd160_forward_in_both_tile_modes(cuda, B, S, mode, spec, seg):
    """As at 256: compact and DENSE (with and without SEG) in the mode the
    rule takes and in the other one, each within the tolerance of its plain
    version in the same mode, dense bitwise the compact kernel, a second
    launch bitwise the first, one launch counted per call."""
    q, k, v = _qkv(cuda, 31, B, S, S, 32, 8, 160)
    assert fwd_mod.single_q_tile(B, 32, -(-S // 64), 160) == (mode == "single")
    spec = MaskSpec(**spec)
    ids = (_packed_ids(B, S).to(cuda),) * 2 if seg else ()
    plain_ids = dict(q_seg=ids[0], kv_seg=ids[1]) if seg else {}
    fwd = fwd_mod.flash_fwd_varlen if seg else fwd_mod.flash_fwd
    for single in (None, mode != "single"):
        kw = dict(block_q=64, block_kv=64, single_tile=single)
        before = _fwd_counts(fwd)
        o, lse = fwd(q, k, v, spec, *ids, **kw)
        o2, lse2 = fwd(q, k, v, spec, *ids, **kw)
        o_d, lse_d = fwd(q, k, v, spec, *ids, schedule="dense", **kw)
        torch.cuda.synchronize()
        assert _fwd_counts(fwd) == (before[0] + 2, before[1] + 1)
        o_p, lse_p = fwd_mod.flash_fwd_plain(q, k, v, spec, **plain_ids, **kw)
        assert _err(o, o_p) < O_TOL and _err(lse, lse_p) < LSE_TOL
        assert torch.equal(o, o2) and torch.equal(lse, lse2)
        assert torch.equal(o, o_d) and torch.equal(lse, lse_d)


# (B, Sq, Skv, kv splits, mode): stablelm-12b's short-q/long-kv corner (one
# q tile, 4 splits: one tile a CTA, each split's walk dealt to both
# warpgroups) and its split prefill (2 and 3 splits: 768 and 1152 pair CTAs).
HD160_SPLIT_CASES = [(1, 64, 8192, 4, "single"), (1, 1536, 1536, 2, "pair"),
                     (1, 1536, 1536, 3, "pair")]


@pytest.mark.gpu
@pytest.mark.parametrize("seg", [False, True], ids=["unsegmented", "packed"])
@pytest.mark.parametrize("B,Sq,Skv,ks,mode", HD160_SPLIT_CASES)
def test_hd160_split_forward_in_both_tile_modes(cuda, B, Sq, Skv, ks, mode, seg):
    """SPLIT (with and without SEG) at 160 in the rule's mode and the other
    one: partials and fold within the tolerance of the plain version in the
    same mode, a second launch bitwise the first, one launch counted; the
    fold on its own launch bitwise the wrapper's; at the corner also the
    single pass."""
    q, k, v = _qkv(cuda, 37, B, Sq, Skv, 32, 8, 160)
    t_q = -(-Sq // 64)
    n = fwd_mod.split_count(Skv, 64, ks)
    assert fwd_mod.single_q_tile(B, 32, t_q, 160, n) == (mode == "single")
    spec = MaskSpec(causal=True, q_offset=Skv - Sq)
    ids = ()
    if seg:
        kv_ids = _packed_ids(B, Skv).to(cuda)
        ids = (kv_ids[:, Skv - Sq:].contiguous(), kv_ids)
    plain_ids = dict(q_seg=ids[0], kv_seg=ids[1]) if seg else {}
    fwd = fwd_mod.flash_fwd_splitkv_varlen if seg else fwd_mod.flash_fwd_splitkv
    for single in (None, mode != "single"):
        kw = dict(block_q=64, block_kv=64, single_tile=single)
        before = fwd.hd160_launches
        out = fwd(q, k, v, spec, *ids, kv_splits=ks, **kw)
        out2 = fwd(q, k, v, spec, *ids, kv_splits=ks, **kw)
        o_f, lse_f = torch.empty_like(out.o), torch.empty_like(out.lse)
        fwd_mod._fold(out.o_parts, out.lse_parts, o_f, lse_f)
        torch.cuda.synchronize()
        assert fwd.hd160_launches == before + 2
        ref = fwd_mod.flash_fwd_splitkv_plain(q, k, v, spec, kv_splits=ks, **plain_ids, **kw)
        assert _err(out.o, ref.o) < O_TOL and _err(out.lse, ref.lse) < LSE_TOL
        assert _err(out.o_parts, ref.o_parts) < O_TOL
        assert _err(out.lse_parts, ref.lse_parts) < LSE_TOL
        assert all(torch.equal(a, b) for a, b in zip(out, out2))
        assert torch.equal(o_f, out.o) and torch.equal(lse_f, out.lse)
        if t_q == 1:
            single_fwd = fwd_mod.flash_fwd_varlen if seg else fwd_mod.flash_fwd
            o, lse = single_fwd(q, k, v, spec, *ids, **kw)
            torch.cuda.synchronize()
            o_p, lse_p = fwd_mod.flash_fwd_plain(q, k, v, spec, **plain_ids, **kw)
            assert _err(o, o_p) < O_TOL and _err(lse, lse_p) < LSE_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("single", [False, True], ids=["pair", "single"])
def test_hd160_non_finite_q_row_spoils_only_its_row(cuda, single):
    """At 160 a run's first zero product reads a tile of zeros, not the Q
    tile, so the 160 forward takes any q: a q row of NaN gives NaN in that
    row only, and every other row matches the plain version, in both tile
    modes."""
    q, k, v = _qkv(cuda, 41, 1, 700, 700, 32, 8, 160)
    q[0, 70, 3] = float("nan")
    spec = MaskSpec(causal=True)
    kw = dict(block_q=64, block_kv=64, single_tile=single)
    o, lse = fwd_mod.flash_fwd(q, k, v, spec, **kw)
    torch.cuda.synchronize()
    bad = ~torch.isfinite(o).all(dim=-1)
    assert bad[0, 70, 3] and int(bad.sum()) == 1
    o_p, lse_p = fwd_mod.flash_fwd_plain(q, k, v, spec, **kw)
    assert _err(o, o_p) < O_TOL and _err(lse, lse_p) < LSE_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("D", [128, 160])
def test_segment_backward_with_no_visible_step(cuda, D):
    """A segment launch in which no step is visible (one q tile at q_offset
    -100 against one kv tile: every q position precedes every key): the
    step bits are empty and their pointer null, which the backward's C
    entries take. The forward gives (0, -inf), the fused, dK/dV and dQ
    kernels zero gradients equal to their plain versions, each launch
    counted."""
    q, k, v = _qkv(cuda, 43, 1, 64, 64, 32, 8, D)
    do = _randn(torch.Generator(device=cuda).manual_seed(44), (1, 64, 32, D), cuda)
    ids = _packed_ids(1, 64).to(cuda)
    spec = MaskSpec(causal=True, q_offset=-100)
    tiles = dict(block_q=64, block_kv=64)
    counters = (fwd_mod.flash_fwd_varlen, bwd_mod.flash_bwd_fused_varlen,
                bwd_mod.flash_bwd_dkv_varlen, bwd_mod.flash_bwd_dq_varlen)
    before = [f.launches for f in counters]
    o, lse = fwd_mod.flash_fwd_varlen(q, k, v, spec, ids, ids, **tiles)
    delta = bwd_mod.flash_bwd_delta(o, do)
    args = (q, k, v, do, lse, delta, spec, ids, ids)
    fused = bwd_mod.flash_bwd_fused_varlen(*args, **tiles)
    dk, dv = bwd_mod.flash_bwd_dkv_varlen(*args, **tiles)
    dq = bwd_mod.flash_bwd_dq_varlen(*args, **tiles)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 1, 1]
    assert (o == 0).all() and torch.isneginf(lse).all()
    plain = dict(q_seg=ids, kv_seg=ids, **tiles)
    want = bwd_mod.flash_bwd_fused_plain(*args[:7], **plain)
    for a, b in zip(fused, want):
        assert torch.equal(a, b) and (a == 0).all()
    assert torch.equal(dq, bwd_mod.flash_bwd_dq_plain(*args[:7], **plain))
    for a, b in zip((dk, dv), bwd_mod.flash_bwd_dkv_plain(*args[:7], **plain)):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("D,Hq,Hkv,Sq,Skv,ks", [
    (256, 4, 1, 64, 32768, None),   # gemma3-1b's corner: 33 splits, 3-stage ring
    (256, 4, 1, 1536, 1536, 2),     # its split prefill, one q tile a CTA
    (160, 32, 8, 64, 32768, None),  # stablelm-12b's corner: 4 splits, 4-stage ring
], ids=["hd256-corner", "hd256-split-prefill", "hd160-corner"])
def test_wide_single_tile_split_is_bitwise_over_many_launches(cuda, D, Hq, Hkv, Sq, Skv, ks):
    """The split forward in one-q-tile mode, where each warpgroup waits on
    every second position of the ring, launched 2000 times: every launch
    bitwise the first (the partials and the fold). With one barrier slot a
    stage of the 3-stage ring at 256, about one launch in 2000 took another
    position's record and tiles at the corner and gave a different split
    partial."""
    q, k, v = _qkv(cuda, 41, 1, Sq, Skv, Hq, Hkv, D)
    ks = ks or ops.resolve_kv_splits(None, q.shape, k.shape)
    spec = MaskSpec(causal=True, q_offset=Skv - Sq)
    kw = dict(block_q=64, block_kv=64, kv_splits=ks, single_tile=True)
    first = fwd_mod.flash_fwd_splitkv(q, k, v, spec, **kw)
    differed = torch.zeros((), dtype=torch.int64, device=cuda)
    for _ in range(2000):
        out = fwd_mod.flash_fwd_splitkv(q, k, v, spec, **kw)
        differed += torch.stack([torch.ne(a, b).any() for a, b in zip(out, first)]).any()
    assert differed.item() == 0, f"{differed.item()} of 2000 launches not bitwise the first"
