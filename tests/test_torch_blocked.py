"""The port's blocked FA2 path (``core/flash.py``, ``impl="flash_torch"``),
its split decode (``core/decode.py``), the FA1 baseline (``core/flash_v1.py``)
and the online-softmax state algebra, against the JAX package's
counterparts (``flash_xla``) on the CPU, on the same numpy inputs made from
a seed. Forward cases are the non-slow cases of ``tests/test_flash_xla.py``,
with and without segment ids; the tile schedules are compared exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import decode as jax_decode
from repro.core import flash as jax_flash
from repro.core import online_softmax as jax_osm
from repro.core.flash_v1 import flash_v1_attention as jax_flash_v1
from repro.core.masks import MaskSpec as JaxMaskSpec
from repro_torch.core import decode, flash
from repro_torch.core import online_softmax as osm
from repro_torch.configs import registry
from repro_torch.core.attention import AttentionConfig, attention, check_card_support
from repro_torch.core.flash_v1 import flash_v1_attention
from repro_torch.core.masks import CAUSAL, FULL, NEG_INF, MaskSpec

# f32 on both sides, the same algorithm and tiles: summation order only.
FWD_TOL = dict(atol=2e-5, rtol=0)
GRAD_REL = 1e-4  # max |port - JAX| over max |JAX|, per gradient
BF16_TOL = dict(atol=3e-2, rtol=0)

# B, Sq, Sk, Hq, Hk, D, spec kwargs, mode: the non-slow cases of
# tests/test_flash_xla.py, then rows that see no key (a whole q tile and
# part of one), KV padding, and a windowed sink.
CASES = [
    (2, 128, 128, 4, 2, 64, dict(causal=True), "packed"),
    (2, 128, 128, 4, 2, 64, dict(causal=True), "dense"),
    (1, 128, 256, 4, 4, 64, dict(), "auto"),
    (2, 192, 192, 4, 2, 32, dict(window=48), "auto"),
    (1, 64, 192, 2, 2, 32, dict(causal=True, q_offset=128), "auto"),
    (1, 128, 128, 2, 1, 32, dict(causal=True, q_offset=-64), "packed"),
    (1, 128, 128, 2, 1, 32, dict(causal=True, q_offset=-40), "dense"),
    (2, 100, 150, 2, 1, 16, dict(causal=True, window=30, sink=4), "packed"),
]


def _inputs(B, Sq, Sk, Hq, Hk, D, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(dtype) for s in
            ((B, Sq, Hq, D), (B, Sk, Hk, D), (B, Sk, Hk, D), (B, Sq, Hq, D))]


def _segments(B, S, seed):
    """Packed ids: ragged runs of 1, 2, 3, ... and a tail of padding (0)."""
    rng = np.random.default_rng(seed)
    ids = np.zeros((B, S), np.int32)
    for b in range(B):
        pos, seg = 0, 1
        while pos < S - 8:
            n = int(rng.integers(5, S // 2))
            ids[b, pos:pos + n] = seg
            pos, seg = pos + n, seg + 1
    return ids


def _jax_run(q, k, v, do, spec, mode, seg=None, kv_seg=None):
    """(o, lse, dq, dk, dv) of the JAX package's flash_xla path, in one jit
    (one compile; eager dispatch would compile every small op apart)."""
    kw = dict(block_q=64, block_kv=64, mode=mode)

    @jax.jit
    def run(q, k, v, do, seg, kv_seg):
        ids = {} if seg is None else dict(segment_ids=seg, kv_segment_ids=kv_seg)
        o, lse = jax_flash.flash_attention_with_lse(q, k, v, spec, **kw, **ids)
        _, vjp = jax.vjp(lambda a, b, c: jax_flash.flash_attention(a, b, c, spec, **kw, **ids),
                         q, k, v)
        return (o, lse, *vjp(do))

    return [np.asarray(x) for x in run(q, k, v, do, seg, kv_seg)]


def _port_run(q, k, v, do, spec, mode, seg=None, kv_seg=None):
    kw = dict(block_q=64, block_kv=64, mode=mode)
    if seg is not None:
        kw.update(segment_ids=torch.from_numpy(seg),
                  kv_segment_ids=None if kv_seg is None else torch.from_numpy(kv_seg))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o, lse = flash.flash_attention_with_lse(qt, kt, vt, spec, **kw)
    grads = torch.autograd.grad(flash.flash_attention(qt, kt, vt, spec, **kw),
                                (qt, kt, vt), torch.from_numpy(do))
    return [x.detach().float().numpy() for x in (o, lse, *grads)]


def _check(got, want):
    o, lse, *grads = got
    o_j, lse_j, *grads_j = want
    np.testing.assert_allclose(o, o_j, **FWD_TOL)
    np.testing.assert_allclose(lse, lse_j, **FWD_TOL)  # -inf rows equal too
    for name, g, g_j in zip(("dq", "dk", "dv"), grads, grads_j):
        assert np.all(np.isfinite(g)), name
        assert np.abs(g - g_j).max() <= GRAD_REL * np.abs(g_j).max(), name


@pytest.mark.parametrize("case", CASES, ids=[str(i) for i in range(len(CASES))])
def test_forward_and_grads_match_jax(case):
    B, Sq, Sk, Hq, Hk, D, spec_kw, mode = case
    q, k, v, do = _inputs(B, Sq, Sk, Hq, Hk, D)
    _check(_port_run(q, k, v, do, MaskSpec(**spec_kw), mode),
           _jax_run(q, k, v, do, JaxMaskSpec(**spec_kw), mode))


@pytest.mark.parametrize("mode", ["dense", "packed"])
@pytest.mark.parametrize("spec_kw", [dict(causal=True), dict(), dict(causal=True, window=40)],
                         ids=["causal", "full", "window"])
def test_segments_match_jax(mode, spec_kw):
    """Packed (varlen) rows: self-attention over shared ids, S not a whole
    number of tiles (the padded q rows and kv columns take the sentinels)."""
    B, S = 2, 150
    q, k, v, do = _inputs(B, S, S, 4, 2, 32, seed=1)
    ids = _segments(B, S, seed=2)
    _check(_port_run(q, k, v, do, MaskSpec(**spec_kw), mode, ids),
           _jax_run(q, k, v, do, JaxMaskSpec(**spec_kw), mode, ids))


def test_cross_segments_match_jax():
    """Distinct q and kv ids (the SegmentInfo form on the port's side)."""
    q, k, v, do = _inputs(2, 64, 160, 2, 2, 32, seed=3)
    q_ids, kv_ids = _segments(2, 64, seed=4), _segments(2, 160, seed=5)
    got = _port_run(q, k, v, do, FULL, "auto", q_ids, kv_ids)
    _check(got, _jax_run(q, k, v, do, JaxMaskSpec(), "auto", q_ids, kv_ids))


def test_bf16_forward_matches_jax():
    """bf16 inputs: the pre-scaled q and P are rounded where the JAX program
    rounds them; o within a bf16 tolerance."""
    q, k, v, _ = _inputs(2, 256, 256, 4, 2, 64, seed=6)
    o_j = jax.jit(lambda *a: jax_flash.flash_attention(*a, JaxMaskSpec(causal=True),
                                                       block_q=64, block_kv=64))(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    o = flash.flash_attention(*(torch.from_numpy(x).bfloat16() for x in (q, k, v)), CAUSAL,
                              block_q=64, block_kv=64)
    assert o.dtype == torch.bfloat16
    np.testing.assert_allclose(o.float().numpy(), np.asarray(o_j, np.float32), **BF16_TOL)


def test_attention_entry_routes_flash_torch():
    """``attention(impl="flash_torch")`` is the blocked path at its tiles, with
    segment ids, and at DEFAULT_BLOCK where none is given; a flash_cuda config
    refuses the blocked knobs."""
    q, k, v, _ = _inputs(2, 150, 150, 4, 2, 32, seed=7)
    ids = _segments(2, 150, seed=8)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    cfg = AttentionConfig(impl="flash_torch", block_q=64, block_kv=32)
    got = attention(qt, kt, vt, CAUSAL, cfg, segment_ids=torch.from_numpy(ids))
    want = flash.flash_attention(qt, kt, vt, CAUSAL, block_q=64, block_kv=32, mode="packed",
                                 segment_ids=torch.from_numpy(ids))
    assert torch.equal(got, want)
    assert AttentionConfig(impl="flash_torch").block_q is None
    assert flash.DEFAULT_BLOCK == 512 and flash.FlashConfig().block_q == flash.DEFAULT_BLOCK
    got = attention(qt, kt, vt, CAUSAL, AttentionConfig(impl="flash_torch"))
    assert torch.equal(got, flash.flash_attention(qt, kt, vt, CAUSAL, block_q=512,
                                                  block_kv=512))
    # Plain PyTorch: the card check lets flash_torch through like ref (f32, any
    # head_dim; no tensor is made).
    f32 = registry.reduce_config(registry.get("qwen3-8b"))
    for training in (True, False):
        check_card_support(f32, AttentionConfig(impl="flash_torch"), "cuda", training=training)
    with pytest.raises(ValueError, match="bfloat16"):
        check_card_support(f32, AttentionConfig(impl="flash_cuda"), "cuda", training=True)
    for bad in (dict(impl="flash_cuda", block_q=128), dict(impl="flash_cuda", block_kv=128),
                dict(impl="ref", block_q=64), dict(impl="flash_torch", bwd="split"),
                dict(impl="flash_torch", kv_splits=2), dict(impl="flash_torch", schedule="dense")):
        with pytest.raises(ValueError):
            AttentionConfig(**bad)


# ---------------------------------------------------------------------------
# Tile schedules and the mode rule: the same integers
# ---------------------------------------------------------------------------

SCHEDULE_SPECS = [dict(), dict(causal=True), dict(causal=True, window=64),
                  dict(causal=True, window=64, sink=16), dict(window=48),
                  dict(window=48, sink=8), dict(causal=True, q_offset=128),
                  dict(causal=True, q_offset=-100)]


@pytest.mark.parametrize("spec_kw", SCHEDULE_SPECS, ids=[str(i) for i in range(8)])
def test_schedules_and_mode_equal_jax(spec_kw):
    spec, jspec = MaskSpec(**spec_kw), JaxMaskSpec(**spec_kw)
    for t_q, t_kv, bq, bk, sk in ((16, 16, 64, 64, 1024), (3, 5, 64, 32, 150),
                                  (7, 7, 32, 32, 200), (1, 9, 128, 16, 140)):
        got = flash._visible_pairs(spec, t_q, t_kv, bq, bk)
        want = jax_flash._visible_pairs(jspec, t_q, t_kv, bq, bk)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        got = flash._classified_pairs(spec, t_q, t_kv, bq, bk, sk)
        want = jax_flash._classified_pairs(jspec, t_q, t_kv, bq, bk, sk)
        for pa, pb in zip(got, want):
            for a, b in zip(pa, pb):
                assert a.dtype == b.dtype and np.array_equal(a, b)
        for mode in flash.MODES:
            cfg = flash.FlashConfig(spec=spec, block_q=bq, block_kv=bk, mode=mode)
            jcfg = jax_flash.FlashConfig(spec=jspec, block_q=bq, block_kv=bk, mode=mode)
            assert cfg.resolve_mode(t_q, t_kv) == jcfg.resolve_mode(t_q, t_kv)


def test_segment_visible_pairs_equal_jax():
    ids = _segments(1, 300, seed=9)[0]
    q_ids, kv_ids = _segments(1, 128, seed=10)[0], _segments(1, 300, seed=11)[0]
    for spec_kw in (dict(), dict(causal=True), dict(causal=True, window=50)):
        for segments in (ids, (q_ids, kv_ids)):
            t_q = -(-len(segments if not isinstance(segments, tuple) else segments[0]) // 32)
            got = flash._visible_pairs(MaskSpec(**spec_kw), t_q, 10, 32, 32, segments)
            want = jax_flash._visible_pairs(JaxMaskSpec(**spec_kw), t_q, 10, 32, 32, segments)
            assert all(np.array_equal(a, b) for a, b in zip(got, want))
    # The causal halving of the JAX package's own accounting test.
    assert len(flash._visible_pairs(CAUSAL, 16, 16, 64, 64)[0]) == 16 * 17 // 2


# ---------------------------------------------------------------------------
# The FA1 baseline and the online-softmax algebra
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec_kw,dtype", [(dict(causal=True), np.float32),
                                           (dict(), np.float32),
                                           (dict(causal=True, window=40), np.float32),
                                           (dict(causal=True), "bfloat16")],
                         ids=["causal", "full", "window", "causal-bf16"])
def test_flash_v1_matches_jax(spec_kw, dtype):
    q, k, v, _ = _inputs(2, 128, 256, 4, 2, 32, seed=12)
    spec = dict(spec_kw, q_offset=128 if spec_kw else 0)
    if dtype == "bfloat16":
        jin = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
        tin = [torch.from_numpy(x).bfloat16() for x in (q, k, v)]
    else:
        jin, tin = [jnp.asarray(x) for x in (q, k, v)], [torch.from_numpy(x) for x in (q, k, v)]
    want = jax_flash_v1(*jin, JaxMaskSpec(**spec), block_kv=64)
    got = flash_v1_attention(*tin, MaskSpec(**spec), block_kv=64)
    assert got[0].dtype == tin[0].dtype
    tol = BF16_TOL if dtype == "bfloat16" else FWD_TOL
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32), **tol)
    with pytest.raises(ValueError, match="multiple of block_kv"):
        flash_v1_attention(*tin, MaskSpec(**spec), block_kv=96)


def test_flash_v1_lse_is_flash_torch_lse():
    """FA1 keeps (m, l); FA2 keeps L = m + log l: the same information."""
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(1, 128, 128, 2, 2, 32, seed=13))
    o1, m, l = flash_v1_attention(q, k, v, CAUSAL, block_kv=32)
    o2, lse = flash.flash_attention_with_lse(q, k, v, CAUSAL, block_q=32, block_kv=32)
    torch.testing.assert_close(o1, o2, atol=2e-5, rtol=0)
    torch.testing.assert_close(m + torch.log(l), lse, atol=2e-5, rtol=0)


def test_softmax_state_matches_jax():
    rng = np.random.default_rng(14)
    s_a, s_b = (rng.standard_normal((3, 5, 7)).astype(np.float32) * 4 for _ in range(2))
    v_a, v_b = (rng.standard_normal((3, 7, 4)).astype(np.float32) for _ in range(2))
    s_b[0] = NEG_INF  # a block whose rows saw nothing: its m is -inf
    j_a, j_b = jax_osm.block_state(s_a, v_a), jax_osm.block_state(s_b, v_b)
    t_a = osm.block_state(torch.from_numpy(s_a), torch.from_numpy(v_a))
    t_b = osm.block_state(torch.from_numpy(s_b), torch.from_numpy(v_b))
    init_j, init_t = jax_osm.init_state((3, 5), 4), osm.init_state((3, 5), 4)
    pairs = [(t_a, j_a), (osm.combine(t_a, t_b), jax_osm.combine(j_a, j_b)),
             (osm.combine(init_t, t_a), jax_osm.combine(init_j, j_a)), (init_t, init_j)]
    for t, j in pairs:
        for a, b in zip(t, j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
        for a, b in zip(osm.finalize(t), jax_osm.finalize(j)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    assert torch.isneginf(osm.finalize(init_t)[1]).all()


# ---------------------------------------------------------------------------
# Split decode, contiguous and paged
# ---------------------------------------------------------------------------

DEC_B, DEC_S, DEC_HQ, DEC_HK, DEC_D = 4, 96, 4, 2, 16
DEC_LENGTHS = np.array([0, 5, 50, 96], np.int32)  # a length-0 row (an inactive slot)
DECODE_CASES = {"plain": dict(), "window": dict(window=20),
                "sink": dict(window=20, sink=4), "segments": dict()}


def _decode_inputs(seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((DEC_B, 1, DEC_HQ, DEC_D)).astype(np.float32)
    kc = rng.standard_normal((DEC_B, DEC_S, DEC_HK, DEC_D)).astype(np.float32)
    vc = rng.standard_normal((DEC_B, DEC_S, DEC_HK, DEC_D)).astype(np.float32)
    return q, kc, vc


@pytest.mark.parametrize("splits", [1, 3, 8])
@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_flash_decode_matches_jax(case, splits):
    q, kc, vc = _decode_inputs(15)
    kw = dict(DECODE_CASES[case], num_splits=splits)
    seg_kw = {}
    if case == "segments":  # the query generates into the trailing segment
        ids = _segments(DEC_B, DEC_S, seed=16)
        q_seg = ids[np.arange(DEC_B), np.maximum(DEC_LENGTHS - 1, 0)]
        seg_kw = dict(kv_segment_ids=ids, q_segment=q_seg)
    want = jax.jit(lambda *a, **ids: jax_decode.flash_decode(*a, **kw, **ids))(
        *(jnp.asarray(x) for x in (q, kc, vc, DEC_LENGTHS)),
        **{n: jnp.asarray(x) for n, x in seg_kw.items()})
    got = decode.flash_decode(*(torch.from_numpy(x) for x in (q, kc, vc, DEC_LENGTHS)), **kw,
                              **{n: torch.from_numpy(x) for n, x in seg_kw.items()})
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **FWD_TOL)
    assert torch.isneginf(got[1][0]).all()  # the length-0 row


@pytest.mark.parametrize("splits", [1, 3, 8])
@pytest.mark.parametrize("case", ["plain", "window", "sink"])
def test_flash_decode_paged_matches_jax(case, splits):
    """Pages of 8 in a shuffled pool; the null page 0, which only positions
    past a row's length read, holds large values that must not contribute
    (rows 0 and 1 read it: length 0, and length 5 in one page)."""
    q, kc, vc = _decode_inputs(17)
    ps, n_pages = 8, DEC_S // 8
    rng = np.random.default_rng(18)
    table = (1 + rng.permutation(DEC_B * n_pages)).reshape(DEC_B, n_pages).astype(np.int32)
    k_pages = np.full((DEC_HK, DEC_B * n_pages + 1, ps, DEC_D), 1e4, np.float32)
    v_pages = k_pages.copy()
    for b in range(DEC_B):
        for p in range(n_pages):
            k_pages[:, table[b, p]] = kc[b, p * ps:(p + 1) * ps].transpose(1, 0, 2)
            v_pages[:, table[b, p]] = vc[b, p * ps:(p + 1) * ps].transpose(1, 0, 2)
    table[0], table[1, 1:] = 0, 0
    kw = dict(DECODE_CASES[case], num_splits=splits)
    args = (q, k_pages, v_pages, DEC_LENGTHS, table)
    want = jax.jit(lambda *a: jax_decode.flash_decode_paged(*a, **kw))(
        *(jnp.asarray(x) for x in args))
    got = decode.flash_decode_paged(*(torch.from_numpy(x) for x in args), **kw)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **FWD_TOL)
    contiguous = decode.flash_decode(*(torch.from_numpy(x) for x in (q, kc, vc, DEC_LENGTHS)),
                                     **kw)
    torch.testing.assert_close(got[0][1:], contiguous[0][1:], atol=1e-6, rtol=0)
