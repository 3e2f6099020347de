"""The port's packed (varlen) attention against the JAX package: segment
helpers, the packed data source, the segment step bits, and the segment
variants of the forward and of the fused and split backward, fed the same
numpy inputs. The Pallas side runs in interpret mode (``use_tuned=False``);
on the CPU the port runs its kernels' plain versions
(tests/test_torch_kernels_gpu.py holds the CUDA kernels against them)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.masks import MaskSpec as JaxMaskSpec
from repro.core.masks import pad_segments as jax_pad_segments
from repro.core.masks import segment_positions as jax_segment_positions
from repro.core.masks import segment_tile_visibility as jax_segment_tile_visibility
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticVarlenLM as JaxSyntheticVarlenLM
from repro.data.pipeline import pack_documents as jax_pack_documents
from repro.kernels.ops import (PallasFlashConfig, flash_attention_pallas_varlen,
                               flash_attention_pallas_varlen_with_lse, resolve_pallas_knobs)
from repro.kernels.ref import attention_reference as jax_attention_reference
from repro.kernels.schedule import STEP_ACTIVE, build_tile_schedule, segment_step_tables
from repro_torch.core.masks import (KV_PAD_SEGMENT, Q_PAD_SEGMENT, MaskSpec, SegmentInfo,
                                    pad_segments, segment_positions, segment_tile_visibility)
from repro_torch.data.pipeline import DataConfig, SyntheticVarlenLM, make_source, pack_documents
from repro_torch.kernels import flash_bwd as bwd_mod
from repro_torch.kernels import flash_fwd as fwd_mod
from repro_torch.kernels import ops
from repro_torch.kernels.ref import attention_reference, attention_reference_bwd
from repro_torch.kernels.schedule import (build_kv_tile_schedule, build_q_tile_schedule,
                                          segment_step_bits)

# f32 on both sides: the differences are summation order and tiling only.
TOL_F32 = dict(atol=2e-5, rtol=2e-5)
# bf16 inputs: both round P (and dS) to bf16 at the same places, but a value
# near a rounding boundary can land one bf16 ulp (0.8% near 1) apart.
TOL_BF16 = dict(atol=2e-2, rtol=2e-2)
D = 16
BLOCK = 32


def _segments(B, S, n_seg, seed, *, sort=True, pad=True):
    """(B, S) int32: n_seg contiguous runs per row with cuts not aligned to
    the tiles, trailing padding (id 0) of 0-8 positions when ``pad``; with
    ``sort`` False the runs carry their ids in a random order."""
    rng = np.random.default_rng(seed)
    seg = np.zeros((B, S), np.int32)
    for b in range(B):
        tail = int(rng.integers(0, 9)) if pad else 0
        cuts = np.sort(rng.choice(np.arange(1, S - tail), n_seg - 1, replace=False))
        bounds = np.concatenate([[0], cuts, [S - tail]])
        ids = np.arange(1, n_seg + 1) if sort else rng.permutation(n_seg) + 1
        for s in range(n_seg):
            seg[b, bounds[s]:bounds[s + 1]] = ids[s]
    return seg


# ------------------------------------------------------- helpers and data


@pytest.mark.parametrize("n_seg,sort", [(1, True), (3, True), (5, False)])
def test_segment_positions_and_padding_equal_jax(n_seg, sort):
    seg = _segments(2, 100, n_seg, seed=n_seg, sort=sort)
    got = segment_positions(torch.from_numpy(seg))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_segment_positions(seg)))
    qs, ks = pad_segments(torch.from_numpy(seg), torch.from_numpy(seg[:, :70]), 128, 96)
    jqs, jks = jax_pad_segments(jnp.asarray(seg), jnp.asarray(seg[:, :70]), 128, 96)
    np.testing.assert_array_equal(qs.numpy(), np.asarray(jqs))
    np.testing.assert_array_equal(ks.numpy(), np.asarray(jks))
    assert (qs[:, 100:] == Q_PAD_SEGMENT).all() and (ks[:, 70:] == KV_PAD_SEGMENT).all()
    for lo, hi in ((0, 32), (32, 64), (90, 100)):
        assert segment_tile_visibility(seg[0], seg[1], lo, hi, 0, 32) == \
            jax_segment_tile_visibility(seg[0], seg[1], lo, hi, 0, 32)


def test_pack_documents_equals_jax():
    rng = np.random.default_rng(0)
    docs = [rng.integers(1, 500, int(n)) for n in rng.integers(2, 60, 25)]
    got, want = pack_documents(docs, 64), jax_pack_documents(docs, 64)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="exceeds"):
        pack_documents([np.arange(70)], 64)


@pytest.mark.parametrize("seed,vocab,S", [(0, 512, 128), (3, 151_936, 300), (7, 1000, 64)])
def test_synthetic_varlen_batches_equal(seed, vocab, S):
    cfg = dict(batch_size=3, seq_len=S, vocab_size=vocab, seed=seed, source="packed",
               min_doc_len=8)
    ours = make_source(DataConfig(**cfg))
    theirs = JaxSyntheticVarlenLM(JaxDataConfig(**cfg))
    assert isinstance(ours, SyntheticVarlenLM)
    for step in (0, 1, 5):
        a, b = ours.batch(step), theirs.batch(step)
        assert sorted(a) == sorted(b) == ["inputs", "loss_mask", "segment_ids", "targets"]
        for key in a:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


# ------------------------------------------------------------ step bits


@pytest.mark.parametrize("kv_major", [False, True], ids=["q_major", "kv_major"])
@pytest.mark.parametrize("S,sort,spec", [
    (128, True, dict(causal=True)),
    (100, True, dict(causal=True)),
    (100, False, dict(causal=True)),
    (130, False, dict(causal=True, window=40, sink=4)),
    (96, True, dict()),
])
def test_segment_step_bits_equal_jax(kv_major, S, sort, spec):
    """The bits at every visible step of the port's CSR equal
    ``segment_step_tables``'s at the active steps of the JAX table, which
    visits the same pairs in the same order."""
    bq, bk = 32, 16
    seg = _segments(2, S, 4, seed=S, sort=sort)
    t_q, t_kv = -(-S // bq), -(-S // bk)
    jspec, tspec = JaxMaskSpec(**spec), MaskSpec(**spec)
    sched = build_tile_schedule(jspec, t_q, t_kv, bq, bk, S, kv_major=kv_major)
    qs, ks = jax_pad_segments(jnp.asarray(seg), jnp.asarray(seg), t_q * bq, t_kv * bk)
    want = np.asarray(segment_step_tables(qs, ks, sched, bq, bk, kv_major=kv_major))
    active = (sched.flags & STEP_ACTIVE) != 0
    csr = (build_kv_tile_schedule if kv_major else build_q_tile_schedule)(
        tspec, t_q, t_kv, bq, bk, S)
    ids = torch.from_numpy(seg)
    got = segment_step_bits(ids, ids, csr, bq, bk, kv_major)
    assert got.dtype == torch.int32 and got.shape == (2, len(csr.inner))
    np.testing.assert_array_equal(csr.owner, sched.outer[active])
    np.testing.assert_array_equal(got.numpy(), want[:, active])
    assert got.numpy().min() >= 0 and got.numpy().max() <= 3


# ---------------------------------------------- forward and backward parity


@dataclasses.dataclass(frozen=True)
class Case:
    name: str
    B: int
    S: int
    Hq: int
    Hkv: int
    n_seg: int
    spec: dict


CASES = [
    Case("causal_g1_1seg", 2, 96, 2, 2, 1, dict(causal=True)),
    Case("causal_g1_3seg_ragged", 2, 100, 2, 2, 3, dict(causal=True)),
    Case("causal_g4_5seg_ragged", 1, 130, 8, 2, 5, dict(causal=True)),
    Case("window_sink_g2_2seg", 1, 130, 4, 2, 2, dict(causal=True, window=40, sink=4)),
    Case("noncausal_g1_4seg", 2, 100, 2, 2, 4, dict()),
    Case("noncausal_window_g4_3seg", 1, 96, 8, 2, 3, dict(window=30)),
]


def _inputs(case: Case, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((case.B, case.S, case.Hq, D), dtype=np.float32)
    k = rng.standard_normal((case.B, case.S, case.Hkv, D), dtype=np.float32)
    v = rng.standard_normal((case.B, case.S, case.Hkv, D), dtype=np.float32)
    do = rng.standard_normal((case.B, case.S, case.Hq, D), dtype=np.float32)
    seg = _segments(case.B, case.S, case.n_seg, seed=seed + case.n_seg)
    return (*(x.astype(dtype) for x in (q, k, v, do)), seg)


def _blocks(jspec, q, k):
    r = resolve_pallas_knobs(
        PallasFlashConfig(spec=jspec, block_q=BLOCK, block_kv=BLOCK, use_tuned=False),
        q.shape, k.shape, q.dtype)
    return r["block_q"], r["block_kv"]


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


def _f32(x):
    return np.asarray(x.detach().float() if torch.is_tensor(x) else jnp.asarray(x, jnp.float32))


@functools.partial(jax.jit, static_argnums=(5, 6, 7, 8))
def _pallas_grads(q, k, v, do, seg, spec, bq, bk, bwd):
    f = functools.partial(flash_attention_pallas_varlen, segment_ids=seg, spec=spec,
                          block_q=bq, block_kv=bk, interpret=True, bwd=bwd, use_tuned=False)
    o, vjp = jax.vjp(f, q, k, v)
    return (o, *vjp(do))


def _port_grads(q, k, v, do, seg, spec, bq, bk, bwd, dtype=torch.float32):
    qt, kt, vt = (_t(x, dtype).requires_grad_() for x in (q, k, v))
    o = ops.flash_attention_varlen(qt, kt, vt, torch.from_numpy(seg), spec, block_q=bq,
                                   block_kv=bk, bwd=bwd)
    o.backward(_t(do, dtype))
    return o, qt.grad, kt.grad, vt.grad


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_varlen_forward_matches_pallas(case):
    q, k, v, _, seg = _inputs(case)
    jspec = JaxMaskSpec(**case.spec)
    bq, bk = _blocks(jspec, q, k)
    o_j, lse_j = flash_attention_pallas_varlen_with_lse(
        q, k, v, jnp.asarray(seg), jspec, block_q=bq, block_kv=bk, interpret=True,
        use_tuned=False)
    o, lse = ops.flash_attention_varlen_with_lse(_t(q), _t(k), _t(v), torch.from_numpy(seg),
                                                 MaskSpec(**case.spec), block_q=bq, block_kv=bk)
    np.testing.assert_allclose(_f32(o), _f32(o_j), **TOL_F32)
    np.testing.assert_allclose(_f32(lse), _f32(lse_j), **TOL_F32)


@pytest.mark.parametrize("case", [CASES[2], CASES[3]], ids=lambda c: c.name)
def test_varlen_forward_bf16_matches_pallas(case):
    q, k, v, _, seg = _inputs(case, seed=1)
    qb, kb, vb = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    jspec = JaxMaskSpec(**case.spec)
    bq, bk = _blocks(jspec, qb, kb)
    o_j, lse_j = flash_attention_pallas_varlen_with_lse(
        qb, kb, vb, jnp.asarray(seg), jspec, block_q=bq, block_kv=bk, interpret=True,
        use_tuned=False)
    o, lse = ops.flash_attention_varlen_with_lse(
        *(_t(x, torch.bfloat16) for x in (q, k, v)), torch.from_numpy(seg),
        MaskSpec(**case.spec), block_q=bq, block_kv=bk)
    assert o.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(o), _f32(o_j), **TOL_BF16)
    np.testing.assert_allclose(_f32(lse), _f32(lse_j), **TOL_BF16)


@pytest.mark.parametrize("bwd", ["fused", "split"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_varlen_backward_matches_pallas(case, bwd):
    q, k, v, do, seg = _inputs(case)
    jspec = JaxMaskSpec(**case.spec)
    bq, bk = _blocks(jspec, q, k)
    ours = _port_grads(q, k, v, do, seg, MaskSpec(**case.spec), bq, bk, bwd)
    theirs = _pallas_grads(q, k, v, do, jnp.asarray(seg), jspec, bq, bk, bwd)
    for name, a, b in zip(("o", "dq", "dk", "dv"), ours, theirs):
        assert a.dtype == torch.float32 and np.isfinite(_f32(a)).all(), name
        np.testing.assert_allclose(_f32(a), _f32(b), err_msg=name, **TOL_F32)


@pytest.mark.parametrize("case", [CASES[2], CASES[3]], ids=lambda c: c.name)
def test_varlen_backward_bf16_matches_pallas(case):
    q, k, v, do, seg = _inputs(case, seed=1)
    qb, kb, vb, dob = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    jspec = JaxMaskSpec(**case.spec)
    bq, bk = _blocks(jspec, qb, kb)
    ours = _port_grads(qb, kb, vb, dob, seg, MaskSpec(**case.spec), bq, bk, "fused",
                       torch.bfloat16)
    theirs = _pallas_grads(qb, kb, vb, dob, jnp.asarray(seg), jspec, bq, bk, "fused")
    for name, a, b in zip(("o", "dq", "dk", "dv"), ours, theirs):
        assert a.dtype == torch.bfloat16, name
        np.testing.assert_allclose(_f32(a), _f32(b), err_msg=name, **TOL_BF16)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_varlen_split_equals_fused_bitwise(case):
    """On the CPU the split backward's dq, dk and dv are the fused plain
    version's to the bit with segments too: the same tiles, skipped for the
    same batch rows, summed in the same order."""
    q, k, v, do, seg = _inputs(case)
    spec = MaskSpec(**case.spec)
    fused = _port_grads(q, k, v, do, seg, spec, BLOCK, BLOCK, "fused")
    split = _port_grads(q, k, v, do, seg, spec, BLOCK, BLOCK, "split")
    for name, a, b in zip(("o", "dq", "dk", "dv"), fused, split):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("case", [CASES[1], CASES[3], CASES[5]], ids=lambda c: c.name)
def test_all_ones_ids_are_bitwise_the_unsegmented_path(case):
    q, k, v, do, _ = _inputs(case)
    spec = MaskSpec(**case.spec)
    ones = np.ones((case.B, case.S), np.int32)
    for bwd in ("fused", "split"):
        seg = _port_grads(q, k, v, do, ones, spec, BLOCK, BLOCK, bwd)
        qt, kt, vt = (_t(x).requires_grad_() for x in (q, k, v))
        o = ops.flash_attention(qt, kt, vt, spec, block_q=BLOCK, block_kv=BLOCK, bwd=bwd)
        o.backward(_t(do))
        for name, a, b in zip(("o", "dq", "dk", "dv"), seg, (o, qt.grad, kt.grad, vt.grad)):
            assert torch.equal(a, b), (bwd, name)


@pytest.mark.parametrize("case", [CASES[2], CASES[4]], ids=lambda c: c.name)
def test_reference_with_segments_matches_jax(case):
    q, k, v, do, seg = _inputs(case)
    jspec, spec = JaxMaskSpec(**case.spec), MaskSpec(**case.spec)
    o_j, lse_j = jax_attention_reference(q, k, v, jspec, segment_ids=jnp.asarray(seg))
    o, lse = attention_reference(_t(q), _t(k), _t(v), spec, segment_ids=torch.from_numpy(seg))
    np.testing.assert_allclose(_f32(o), _f32(o_j), **TOL_F32)
    np.testing.assert_allclose(_f32(lse), _f32(lse_j), **TOL_F32)
    # The written-out backward against autograd through the dense reference.
    qt, kt, vt = (_t(x).requires_grad_() for x in (q, k, v))
    attention_reference(qt, kt, vt, spec, segment_ids=torch.from_numpy(seg))[0].backward(_t(do))
    got = attention_reference_bwd(_t(q), _t(k), _t(v), o, _t(do), lse, spec,
                                  segment_ids=torch.from_numpy(seg))
    for name, a, b in zip(("dq", "dk", "dv"), got, (qt.grad, kt.grad, vt.grad)):
        np.testing.assert_allclose(_f32(a), _f32(b), err_msg=name, **TOL_F32)
    # And the flash path against the dense reference on the same ids.
    flash = _port_grads(q, k, v, do, seg, spec, BLOCK, BLOCK, "fused")
    for name, a, b in zip(("o", "dq", "dk", "dv"), flash, (o, qt.grad, kt.grad, vt.grad)):
        np.testing.assert_allclose(_f32(a), _f32(b), err_msg=name, **TOL_F32)


@pytest.mark.parametrize("bwd", ["fused", "split"])
def test_distinct_kv_ids_give_zeros_where_a_tile_sees_nothing(bwd):
    """q rows 0-31 (one whole q tile) carry an id no key has; the last 32
    keys an id no query has. That q tile gets o = 0, lse = -inf and dq = 0,
    that kv tile dk = dv = 0, as from the Pallas kernels."""
    case = Case("distinct", 2, 128, 4, 2, 2, dict(causal=True))
    q, k, v, do, _ = _inputs(case)
    q_seg = np.ones((2, 128), np.int32)
    q_seg[:, 64:] = 2
    kv_seg = q_seg.copy()
    q_seg[:, :32] = 7
    kv_seg[:, -32:] = 9
    jspec, spec = JaxMaskSpec(causal=True), MaskSpec(causal=True)
    o_j, lse_j = flash_attention_pallas_varlen_with_lse(
        q, k, v, jnp.asarray(q_seg), jspec, kv_segment_ids=jnp.asarray(kv_seg),
        block_q=BLOCK, block_kv=BLOCK, interpret=True, use_tuned=False)
    o, lse = ops.flash_attention_varlen_with_lse(
        _t(q), _t(k), _t(v), torch.from_numpy(q_seg), spec,
        kv_segment_ids=torch.from_numpy(kv_seg), block_q=BLOCK, block_kv=BLOCK)
    assert (o[:, :32] == 0).all() and torch.isneginf(lse[..., :32]).all()
    np.testing.assert_allclose(_f32(o), _f32(o_j), **TOL_F32)
    np.testing.assert_array_equal(np.isneginf(_f32(lse)), np.isneginf(_f32(lse_j)))
    qt, kt, vt = (_t(x).requires_grad_() for x in (q, k, v))
    info = SegmentInfo(torch.from_numpy(q_seg), torch.from_numpy(kv_seg))
    ops.flash_attention_varlen(qt, kt, vt, info, spec, block_q=BLOCK, block_kv=BLOCK,
                               bwd=bwd).backward(_t(do))
    assert (qt.grad[:, :32] == 0).all()
    assert (kt.grad[:, -32:] == 0).all() and (vt.grad[:, -32:] == 0).all()
    assert all(torch.isfinite(g).all() for g in (qt.grad, kt.grad, vt.grad))


def test_varlen_entry_points_check_their_inputs():
    x = torch.zeros((1, 64, 2, D))
    seg = torch.ones((1, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="segment_ids"):
        ops.flash_attention_varlen(x, x, x, seg[:, :32])
    with pytest.raises(ValueError, match="kv_segment_ids"):
        ops.flash_attention_varlen(x, x, x, seg, kv_segment_ids=seg[:, :32])
    with pytest.raises(NotImplementedError, match="forward-only"):
        ops.flash_attention_varlen_with_lse(x.clone().requires_grad_(), x, x, seg)
    with pytest.raises(ValueError, match="both"):
        fwd_mod.flash_fwd_plain(x, x, x, MaskSpec(causal=True), block_q=32, block_kv=32,
                                q_seg=seg)
    with pytest.raises(ValueError, match="int32"):
        bwd_mod.flash_bwd_dq_varlen(x, x, x, x, torch.zeros(1, 2, 64), torch.zeros(1, 2, 64),
                                    MaskSpec(), seg.long(), seg, block_q=32, block_kv=32)
    o, lse = ops.flash_attention_varlen_with_lse(x, x, x, SegmentInfo.packed(seg))
    assert o.shape == x.shape and lse.shape == (1, 2, 64)


def test_device_step_bits_are_remembered_per_ids():
    """The kernels' bits are computed once for the same id tensors and
    schedule, and again once the ids change in place or are new tensors."""
    from repro_torch.kernels.schedule import device_schedule, device_step_bits

    seg = torch.from_numpy(_segments(2, 128, 3, seed=3))
    sched = device_schedule(MaskSpec(causal=True), 4, 4, 32, 32, 128, False, "cpu")
    first = device_step_bits(seg, seg, sched, 32, 32, False)
    assert device_step_bits(seg, seg, sched, 32, 32, False) is first
    torch.testing.assert_close(first, segment_step_bits(seg, seg, sched, 32, 32, False))
    seg[:, 64:] = 1  # in place: the version counter moves
    changed = device_step_bits(seg, seg, sched, 32, 32, False)
    assert changed is not first
    torch.testing.assert_close(changed, segment_step_bits(seg, seg, sched, 32, 32, False))
    assert device_step_bits(seg.clone(), seg, sched, 32, 32, False) is not changed
