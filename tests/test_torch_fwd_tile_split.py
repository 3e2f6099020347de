"""One q tile a CTA for the head_dim-256 forward, on the CPU.

Where the pair grid of the forward (a CTA per pair of 64-row q tiles) is
short of the card, the head_dim-256 kernel takes one q tile a CTA and deals
the tile's steps to its two consumer warpgroups in turn, each with its own
running state, merged once at the end (``flash_fwd.single_q_tile`` chooses,
``csrc/flash_fwd.cu`` ``fa2_fwd_wide_kernel`` runs it). Here: the rule at
the registry's shapes, then the plain versions in both modes (the mode
forced through the private ``single_tile`` override), which the kernel is
held to on the card, against the Pallas forward in interpret mode on the
same numpy inputs (f32 on both sides, so tolerance 2e-5: summation order
and the merge only), and the dense plain version bitwise the compact one in
both modes, as the kernels are on the card."""

import functools
import math

import jax
import numpy as np
import pytest
import torch

from repro.core.masks import MaskSpec as JaxMaskSpec
from repro.core.masks import pad_segments
from repro.kernels import flash_fwd as jax_fwd
from repro_torch.configs import registry
from repro_torch.core.masks import MaskSpec
from repro_torch.kernels import flash_fwd as fwd_mod
from repro_torch.kernels import ops
from repro_torch.kernels.schedule import SMS

TOL = dict(atol=2e-5, rtol=2e-5)  # f32 on both sides: summation order and the merge only
BLOCK = 32  # small tiles: several steps a q tile at CPU sizes
D, HQ, HKV = 256, 4, 1  # gemma3-1b's attention widths

# (arch, B, S, kv splits, one q tile a CTA): gemma3-1b's prefill (B 1, S
# 1536: 48 pair CTAs; the window-512 layers take the same shape), its split
# prefill (96), the engine's prefills up to B * ceil(t_q / 2) = 32 (128 CTAs)
# and from 33 (132, one whole wave), its training shape (256), the
# short-q/long-kv corner (one q tile, 33 splits: 132 CTAs, but a pair would
# idle a warpgroup); head dims 64 and 128 always keep the pair, 160 takes the
# same rule (stablelm-12b's corner: one q tile; tests/test_torch_fwd_hd160_tile.py).
RULE_CASES = [
    ("gemma3-1b", 1, 1536, 1, True),
    ("gemma3-1b", 1, 1536, 2, True),
    ("gemma3-1b", 1, 64 * 64, 1, True),
    ("gemma3-1b", 1, 64 * 66, 1, False),
    ("gemma3-1b", 4, 2048, 1, False),
    ("gemma3-1b", 4, 2048, 2, False),
    ("gemma3-1b", 1, 64, 33, True),
    ("gemma3-1b", 4, 1, 1, True),
    ("qwen3-8b", 1, 1536, 1, False),
    ("stablelm-12b", 1, 64, 4, True),
    ("whisper-base", 4, 4, 5, False),
    ("granite-moe-1b-a400m", 1, 1536, 1, False),
]


@pytest.mark.parametrize("arch,B,S,ks,single", RULE_CASES)
def test_single_tile_rule_at_the_registry_shapes(arch, B, S, ks, single):
    cfg = registry.get(arch)
    t_q = -(-S // 64)
    assert fwd_mod.single_q_tile(B, cfg.num_heads, t_q, cfg.head_dim, ks) == single
    if cfg.head_dim == 256 and t_q > 1:  # the rule is the pair grid against one wave
        assert single == (B * cfg.num_heads * -(-t_q // 2) * ks < SMS)


def test_the_override_is_refused_where_no_single_tile_kernel_is_built():
    q = torch.zeros((1, 64, 4, 128))
    k = torch.zeros((1, 64, 1, 128))
    with pytest.raises(ValueError, match="head_dim 256 only"):
        fwd_mod.flash_fwd(q, k, k, MaskSpec(causal=True), block_q=64, block_kv=64,
                          single_tile=True)
    o, _ = fwd_mod.flash_fwd(q, k, k, MaskSpec(causal=True), block_q=64, block_kv=64,
                             single_tile=False)
    assert o.shape == q.shape


# name: (B, S, spec, ids): causal (q tile 0 takes one step, so one warpgroup
# is dealt none); a window with sinks at a ragged S; q_offset -100 (rows,
# and a whole q tile, that see no key); packed ids (steps inactive for one
# batch row and not the other, so the rows of one tile are dealt apart); a
# one-key window (every q tile takes exactly one step).
CASES = {
    "causal": (1, 160, dict(causal=True), None),
    "window_sink": (2, 150, dict(causal=True, window=40, sink=8), None),
    "q_offset": (1, 160, dict(causal=True, q_offset=-100), None),
    "packed": (2, 160, dict(causal=True), "packed"),
    "one_step": (1, 96, dict(causal=True, window=1), None),
}


def _ids(B, S):
    """Three documents a row with cuts off the tile grid (row-dependent),
    two padding positions at the end."""
    seg = np.zeros((B, S), np.int32)
    for b in range(B):
        a, c = S // 3 + 5 + 17 * b, 2 * S // 3 + 3
        seg[b, :a], seg[b, a:c], seg[b, c:S - 2] = 1, 2, 3
    return seg


def _inputs(name):
    B, S, spec_kw, ids = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    q = rng.standard_normal((B, S, HQ, D), dtype=np.float32) * np.float32(1 / math.sqrt(D))
    k, v = (rng.standard_normal((B, S, HKV, D), dtype=np.float32) for _ in range(2))
    return q, k, v, None if ids is None else _ids(B, S), spec_kw


def _heads(x, rows):
    """(B, S, H, D) numpy -> the JAX kernels' (B*H, rows, D), zero-padded."""
    B, S, H, Dh = x.shape
    return np.pad(x.transpose(0, 2, 1, 3).reshape(B * H, S, Dh), ((0, 0), (0, rows - S), (0, 0)))


@functools.partial(jax.jit, static_argnames=("spec", "kv_valid", "ks"))
def _pallas(q, k, v, seg, *, spec, kv_valid, ks=1):
    """The Pallas forward on head-major padded inputs (ks > 1: its
    partitioned form's partials), jitted whole."""
    q_seg = kv_seg = None
    if seg is not None:
        q_seg, kv_seg = pad_segments(seg, seg, q.shape[1], k.shape[1])
    return jax_fwd.flash_fwd(q, k, v, spec, group=HQ // HKV, block_q=BLOCK, block_kv=BLOCK,
                             kv_valid=kv_valid, q_seg=q_seg, kv_seg=kv_seg, interpret=True,
                             num_q_bands=1, kv_splits=ks)


def _port(q, k, v, seg, spec, single, schedule="compact"):
    kw = dict(block_q=BLOCK, block_kv=BLOCK, schedule=schedule, single_tile=single)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    if seg is None:
        return fwd_mod.flash_fwd(*t, spec, **kw)
    ids = torch.from_numpy(seg)
    return fwd_mod.flash_fwd_varlen(*t, spec, ids, ids, **kw)


@pytest.mark.parametrize("single", [True, False], ids=["single", "pair"])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_forward_in_both_modes_matches_pallas(name, single):
    """o and lse of the plain 256 forward, one q tile a CTA (two running
    states merged) and a pair (one state a tile), against the Pallas
    forward; the dense plain version bitwise the compact one in each mode."""
    q, k, v, seg, spec_kw = _inputs(name)
    B, S = q.shape[:2]
    spec = MaskSpec(**spec_kw)
    before = fwd_mod.flash_fwd_plain.calls
    o, lse = _port(q, k, v, seg, spec, single)
    assert fwd_mod.flash_fwd_plain.calls == before + 1
    Sp = -(-S // BLOCK) * BLOCK
    o_j, lse_j = (np.asarray(x) for x in _pallas(_heads(q, Sp), _heads(k, Sp), _heads(v, Sp), seg,
                                                  spec=JaxMaskSpec(**spec_kw), kv_valid=S))
    o_j = o_j[:, :S].reshape(B, HQ, S, D).transpose(0, 2, 1, 3)
    lse_j = lse_j[:, :S].reshape(B, HQ, S)
    np.testing.assert_array_equal(np.isneginf(lse.numpy()), np.isneginf(lse_j))
    np.testing.assert_allclose(o.numpy(), o_j, **TOL)
    np.testing.assert_allclose(lse.numpy(), lse_j, **TOL)
    o_d, lse_d = _port(q, k, v, seg, spec, single, schedule="dense")
    assert torch.equal(o_d, o) and torch.equal(lse_d, lse)


def test_the_modes_differ_only_by_summation_order():
    """The same inputs through both modes: not bitwise (the merge reorders
    the sums), within the f32 tolerance of each other."""
    q, k, v, seg, spec_kw = _inputs("causal")
    single = _port(q, k, v, seg, MaskSpec(**spec_kw), True)
    pair = _port(q, k, v, seg, MaskSpec(**spec_kw), False)
    assert not torch.equal(single[0], pair[0])
    for a, b in zip(single, pair):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


@pytest.mark.parametrize("single", [True, False], ids=["single", "pair"])
@pytest.mark.parametrize("packed", [False, True], ids=["plain", "packed"])
def test_split_partials_in_both_modes_match_pallas(packed, single):
    """The split-KV plain version's per-split partials, one q tile a CTA
    (each split's walk dealt and merged) and a pair, against the Pallas
    partitioned forward: three q tiles against five kv tiles, causal, 3
    splits (a split above the diagonal sees nothing and writes (0, -inf))."""
    q, k, v, _, _ = _inputs("packed" if packed else "causal")
    q, k, v = q[:, :96], k[:, :150], v[:, :150]
    seg = _ids(q.shape[0], 150) if packed else None
    B, Sq, Skv, ks = q.shape[0], 96, 150, 3
    spec_kw = dict(causal=True, q_offset=Skv - Sq)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    kw = dict(block_q=BLOCK, block_kv=BLOCK, kv_splits=ks, single_tile=single)
    if seg is None:
        out = fwd_mod.flash_fwd_splitkv(*t, MaskSpec(**spec_kw), **kw)
    else:
        ids = [torch.from_numpy(x) for x in (seg[:, Skv - Sq:].copy(), seg)]
        out = fwd_mod.flash_fwd_splitkv_varlen(*t, MaskSpec(**spec_kw), *ids, **kw)
    Skp = -(-Skv // BLOCK) * BLOCK
    jseg = None if seg is None else (seg[:, Skv - Sq:].copy(), seg)
    qs = None if jseg is None else pad_segments(*jseg, Sq, Skp)
    o_j, lse_j = jax_fwd.flash_fwd(
        _heads(q, Sq), _heads(k, Skp), _heads(v, Skp), JaxMaskSpec(**spec_kw), group=HQ // HKV,
        block_q=BLOCK, block_kv=BLOCK, kv_valid=Skv, q_seg=None if qs is None else qs[0],
        kv_seg=None if qs is None else qs[1], interpret=True, num_q_bands=1, kv_splits=ks)
    lse_p = out.lse_parts.reshape(B * HQ, ks, Sq).numpy()
    np.testing.assert_array_equal(np.isneginf(lse_p), np.isneginf(np.asarray(lse_j)))
    np.testing.assert_allclose(out.o_parts.reshape(B * HQ, ks, Sq, D).numpy(), np.asarray(o_j),
                               **TOL)
    fin = np.isfinite(lse_p)
    np.testing.assert_allclose(lse_p[fin], np.asarray(lse_j)[fin], **TOL)


def test_ops_entry_takes_the_rule():
    """The public entry at gemma3's widths (CPU tensors: the plain version)
    gives the plain version's result under the rule's own mode, bitwise."""
    q, k, v, _, _ = _inputs("causal")
    spec = MaskSpec(causal=True)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    o, lse = fwd_mod.flash_fwd(*t, spec, block_q=BLOCK, block_kv=BLOCK)
    assert fwd_mod.single_q_tile(1, HQ, -(-q.shape[1] // BLOCK), D)
    o1, lse1 = fwd_mod.flash_fwd(*t, spec, block_q=BLOCK, block_kv=BLOCK, single_tile=True)
    assert torch.equal(o, o1) and torch.equal(lse, lse1)
    assert ops.BLOCK_Q == 64  # the kernels' tiles, which the rule counts on the card
