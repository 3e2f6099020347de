"""One q tile a CTA for the head_dim-160 forward, on the CPU.

The head_dim-160 forward runs on the kernel of the 256 one
(``csrc/flash_fwd.cu`` ``fa2_fwd_wide_kernel<160>``) and takes the same
tile-mode rule (``flash_fwd.single_q_tile``): where the pair grid is short
of the card, one q tile a CTA whose steps the two consumer warpgroups take
in turn, each with its own running state, merged once at the end. Here, at
stablelm-12b's group of 4 (8 q heads over 2 kv heads) and small tiles: the
rule at the registry's stablelm shapes, then the plain versions in both
modes (the mode forced through the private ``single_tile`` override),
which the kernel is held to on the card, against the Pallas forward and its
partitioned form in interpret mode on the same numpy inputs (f32 on both
sides, so tolerance 2e-5: summation order and the merge only): o and lse,
the split partials and their fold, and the dense plain version bitwise the
compact one in both modes, as the kernels are on the card."""

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
from repro_torch.kernels.schedule import SMS

TOL = dict(atol=2e-5, rtol=2e-5)  # f32 on both sides: summation order and the merge only
BLOCK = 32  # small tiles: several steps a q tile at CPU sizes
D, HQ, HKV = 160, 8, 2  # stablelm-12b's head dim and group of 4

# (B, S, kv splits, one q tile a CTA) at stablelm-12b's 32 q heads: its
# prefill (B 1, S 1536: 384 pair CTAs), prompts up to 8 q tiles (4 pairs:
# 128 CTAs) and from 9 (160), the paged engine's batched admissions (B 4 of
# 2 and of 4 q tiles), the split prefill (768), the training shape (1024),
# and the short-q/long-kv corner (one q tile, 4 splits: a pair would idle a
# warpgroup).
RULE_CASES = [
    (1, 1536, 1, False),
    (1, 512, 1, True),
    (1, 576, 1, False),
    (4, 100, 1, True),
    (4, 200, 1, False),
    (1, 1536, 2, False),
    (2, 2048, 1, False),
    (1, 64, 4, True),
    (1, 7, 1, True),
]


@pytest.mark.parametrize("B,S,ks,single", RULE_CASES)
def test_single_tile_rule_at_stablelm_shapes(B, S, ks, single):
    cfg = registry.get("stablelm-12b")
    assert cfg.head_dim == D
    t_q = -(-S // 64)
    assert fwd_mod.single_q_tile(B, cfg.num_heads, t_q, D, ks) == single
    if t_q > 1:  # the rule is the pair grid against one wave, as at 256
        assert single == (B * cfg.num_heads * -(-t_q // 2) * ks < SMS)


# name: (B, S, spec, ids): causal (q tile 0 takes one step, so one
# warpgroup is dealt none); a window with sinks at a ragged S; q_offset -100
# (rows, and a whole q tile, that see no key); packed ids (steps inactive for
# one batch row and not the other, so the rows of one tile are dealt apart).
CASES = {
    "causal": (1, 160, dict(causal=True), None),
    "window_sink": (2, 150, dict(causal=True, window=40, sink=8), None),
    "q_offset": (1, 160, dict(causal=True, q_offset=-100), None),
    "packed": (2, 160, dict(causal=True), "packed"),
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
    rng = np.random.default_rng(sorted(CASES).index(name) + 10)
    q = rng.standard_normal((B, S, HQ, D), dtype=np.float32) * np.float32(1 / math.sqrt(D))
    k, v = (rng.standard_normal((B, S, HKV, D), dtype=np.float32) for _ in range(2))
    return q, k, v, None if ids is None else _ids(B, S), spec_kw


def _heads(x, rows):
    """(B, S, H, D) numpy -> the JAX kernels' (B*H, rows, D), zero-padded."""
    B, S, H, Dh = x.shape
    return np.pad(x.transpose(0, 2, 1, 3).reshape(B * H, S, Dh), ((0, 0), (0, rows - S), (0, 0)))


@functools.partial(jax.jit, static_argnames=("spec", "kv_valid", "ks"))
def _pallas(q, k, v, q_seg, kv_seg, *, spec, kv_valid, ks=1):
    """The Pallas forward on head-major padded inputs and padded ids (ks >
    1: its partitioned form's partials), jitted whole."""
    return jax_fwd.flash_fwd(q, k, v, spec, group=HQ // HKV, block_q=BLOCK, block_kv=BLOCK,
                             kv_valid=kv_valid, q_seg=q_seg, kv_seg=kv_seg, interpret=True,
                             num_q_bands=1, kv_splits=ks)


def _pallas_on(q, k, v, q_ids, kv_ids, spec_kw, ks=1):
    """``_pallas`` on (B, S, H, D) numpy inputs and (B, S) ids (None: none)."""
    Sq, Skv = q.shape[1], k.shape[1]
    Sqp, Skp = -(-Sq // BLOCK) * BLOCK, -(-Skv // BLOCK) * BLOCK
    segs = (None, None) if q_ids is None else pad_segments(q_ids, kv_ids, Sqp, Skp)
    return _pallas(_heads(q, Sqp), _heads(k, Skp), _heads(v, Skp), *segs,
                   spec=JaxMaskSpec(**spec_kw), kv_valid=Skv, ks=ks)


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
    """o and lse of the plain 160 forward, one q tile a CTA (two running
    states merged) and a pair (one state a tile), against the Pallas
    forward; the dense plain version bitwise the compact one in each mode."""
    q, k, v, seg, spec_kw = _inputs(name)
    B, S = q.shape[:2]
    spec = MaskSpec(**spec_kw)
    before = fwd_mod.flash_fwd_plain.calls
    o, lse = _port(q, k, v, seg, spec, single)
    assert fwd_mod.flash_fwd_plain.calls == before + 1
    o_j, lse_j = (np.asarray(x) for x in _pallas_on(q, k, v, seg, seg, spec_kw))
    o_j = o_j[:, :S].reshape(B, HQ, S, D).transpose(0, 2, 1, 3)
    lse_j = lse_j[:, :S].reshape(B, HQ, S)
    np.testing.assert_array_equal(np.isneginf(lse.numpy()), np.isneginf(lse_j))
    np.testing.assert_allclose(o.numpy(), o_j, **TOL)
    np.testing.assert_allclose(lse.numpy(), lse_j, **TOL)
    o_d, lse_d = _port(q, k, v, seg, spec, single, schedule="dense")
    assert torch.equal(o_d, o) and torch.equal(lse_d, lse)


@pytest.mark.parametrize("single", [True, False], ids=["single", "pair"])
@pytest.mark.parametrize("packed", [False, True], ids=["plain", "packed"])
def test_split_partials_and_fold_in_both_modes_match_pallas(packed, single):
    """The split-KV plain version at 160, one q tile a CTA (each split's
    walk dealt and merged) and a pair: its per-split partials against the
    Pallas partitioned forward, and its folded (o, lse) against the Pallas
    single pass: three q tiles at the last positions of five kv tiles,
    causal, 3 splits (a split above the diagonal sees nothing and writes (0,
    -inf))."""
    q, k, v, _, _ = _inputs("packed" if packed else "causal")
    q, k, v = q[:, :96], k[:, :150], v[:, :150]
    B, Sq, Skv, ks = q.shape[0], 96, 150, 3
    seg = _ids(B, Skv) if packed else None
    q_ids = None if seg is None else seg[:, Skv - Sq:].copy()
    spec_kw = dict(causal=True, q_offset=Skv - Sq)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    kw = dict(block_q=BLOCK, block_kv=BLOCK, kv_splits=ks, single_tile=single)
    if seg is None:
        out = fwd_mod.flash_fwd_splitkv(*t, MaskSpec(**spec_kw), **kw)
    else:
        ids = [torch.from_numpy(x) for x in (q_ids, seg)]
        out = fwd_mod.flash_fwd_splitkv_varlen(*t, MaskSpec(**spec_kw), *ids, **kw)
    o_j, lse_j = (np.asarray(x) for x in _pallas_on(q, k, v, q_ids, seg, spec_kw, ks))
    lse_p = out.lse_parts.reshape(B * HQ, ks, Sq).numpy()
    np.testing.assert_array_equal(np.isneginf(lse_p), np.isneginf(lse_j))
    np.testing.assert_allclose(out.o_parts.reshape(B * HQ, ks, Sq, D).numpy(), o_j, **TOL)
    fin = np.isfinite(lse_p)
    np.testing.assert_allclose(lse_p[fin], lse_j[fin], **TOL)
    o1, lse1 = (np.asarray(x) for x in _pallas_on(q, k, v, q_ids, seg, spec_kw))
    np.testing.assert_allclose(out.o.numpy(), o1.reshape(B, HQ, Sq, D).transpose(0, 2, 1, 3),
                               **TOL)
    np.testing.assert_allclose(out.lse.numpy(), lse1.reshape(B, HQ, Sq), **TOL)
