"""The pair walk (``schedule.pair_walk``, the plain statement of ``PairWalk``
in ``csrc/sm90.cuh``): a CTA owns two tiles and walks the ascending union of
their CSR slices per head. In the KV-stationary backward the owners are kv
tiles (``build_kv_tile_schedule``, a q-head group); in the forward they are
q tiles (``build_q_tile_schedule`` and, per kv split,
``build_split_schedule``; group 1). Held to those schedules on every spec of
the schedule grid, with and without packed step bits; and the plain fused
backward, the card's oracle, against the JAX fused kernel at a size where
one CTA holds both tiles."""

import numpy as np
import pytest
import torch

from repro.core.masks import MaskSpec as JaxMaskSpec
from repro_torch.core.masks import MaskSpec
from repro_torch.kernels import flash_bwd as bwd_mod
from repro_torch.kernels.schedule import (SEG_ACTIVE, build_kv_tile_schedule,
                                          build_q_tile_schedule, build_split_schedule, pair_walk,
                                          segment_step_bits)
from test_torch_flash_bwd import SCHEDULE_SPECS, TOL_F32, Case, _f32, _inputs, _pallas_grads

# (t_q, t_kv, bq, bk, kv_valid): even and odd numbers of kv and of q tiles.
GEOMS = [(16, 16, 128, 128, 2048), (4, 7, 16, 16, 101), (6, 3, 16, 32, 90), (9, 9, 16, 16, 144)]
# The walk's orientations: (schedule function, kv_major, heads in the group,
# kv splits). The split forward walks each split's owners apart.
ORIENTATIONS = {
    "kv-major": (build_kv_tile_schedule, True, 3, 1),
    "q-major": (build_q_tile_schedule, False, 1, 1),
    "q-major-split": (build_split_schedule, False, 1, 3),
}


def _packed_bits(csr, t_q, t_kv, bq, bk, kv_valid, seed, kv_major=True):
    """One batch row of segment bits for random packed documents."""
    rng = np.random.default_rng(seed)
    S_q, S_kv = t_q * bq, kv_valid
    cuts = np.sort(rng.choice(np.arange(1, max(S_q, S_kv)), size=5, replace=False))
    ids = np.searchsorted(cuts, np.arange(max(S_q, S_kv)), side="right").astype(np.int32)
    q_seg = torch.from_numpy(ids[None, :S_q])
    kv_seg = torch.from_numpy(ids[None, :S_kv])
    return segment_step_bits(q_seg, kv_seg, csr, bq, bk, kv_major=kv_major)[0].numpy()


@pytest.mark.parametrize("orientation", list(ORIENTATIONS))
@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
@pytest.mark.parametrize("spec", SCHEDULE_SPECS, ids=str)
@pytest.mark.parametrize("geom", GEOMS)
def test_pair_walk_takes_each_visible_step_once_in_order(spec, geom, packed, orientation):
    """Per owner tile of the pair, the steps that name it are exactly its
    slice's (active) entries, head by head in ascending partner order, each
    with its own masked flag and bits; every step is taken by at least one
    owner; partner tiles ascend within a head; a missing second owner takes
    nothing."""
    t_q, t_kv, bq, bk, kv_valid = geom
    build, kv_major, group, splits = ORIENTATIONS[orientation]
    args = (MaskSpec(**spec), t_q, t_kv, bq, bk, kv_valid)
    csr = build(*args, splits) if splits > 1 else build(*args)
    bits = (_packed_bits(csr, t_q, t_kv, bq, bk, kv_valid, seed=t_kv, kv_major=kv_major)
            if packed else None)
    n_owners = t_kv if kv_major else t_q
    for split in range(csr.splits):
        for pair in range((n_owners + 1) // 2):
            steps = pair_walk(csr, pair, group, bits, split)
            for prev, cur in zip(steps, steps[1:]):
                assert (prev.head, prev.tile) < (cur.head, cur.tile)
            assert all(s.entries != (-1, -1) for s in steps)
            for x in (0, 1):
                j = 2 * pair + x
                got = [(s.head, s.tile, e, bool(csr.masked[e]), None if bits is None else bits[e])
                       for s in steps for e in (s.entries[x],) if e >= 0]
                if j >= n_owners:
                    assert got == []
                    continue
                a = j * csr.splits + split
                want = [(g, int(csr.inner[e]), e, bool(csr.masked[e]),
                         None if bits is None else bits[e])
                        for g in range(group)
                        for e in range(csr.row_ptr[a], csr.row_ptr[a + 1])
                        if bits is None or bits[e] & SEG_ACTIVE]
                assert got == want


def test_pair_walk_skips_inactive_steps_before_their_fetch():
    """A step whose entries are all inactive never appears; one with a
    single active entry appears for that tile only."""
    csr = build_kv_tile_schedule(MaskSpec(causal=True), 4, 2, 16, 16, 32)
    n = int(csr.row_ptr[-1])
    bits = np.full(n, SEG_ACTIVE, np.int32)
    # tile 0 sees q tiles 0-3, tile 1 q tiles 1-3: drop q tile 2 from both,
    # q tile 3 from tile 0 only.
    for e in range(n):
        q = int(csr.inner[e])
        j = 0 if e < csr.row_ptr[1] else 1
        if q == 2 or (q == 3 and j == 0):
            bits[e] = 0
    steps = pair_walk(csr, 0, 1, bits)
    assert [(s.tile, tuple(e >= 0 for e in s.entries)) for s in steps] == [
        (0, (True, False)), (1, (True, True)), (3, (False, True))]


# One CTA of two kv tiles: S = 128 at 64-row tiles, causal, GQA group 2.
PAIR_CASE = Case("one_pair_g2", 1, 128, 4, 2, dict(causal=True))


def test_plain_fused_backward_at_one_pair_matches_pallas():
    """The fused kernel's plain version (the card tests' oracle) against the
    JAX fused kernel where the CUDA kernel runs one CTA of two tiles."""
    q, k, v, do = _inputs(PAIR_CASE, seed=4)
    jspec = JaxMaskSpec(**PAIR_CASE.spec)
    theirs = _pallas_grads(q, k, v, do, jspec, 64, 64, "fused")
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    scale = 1.0 / np.sqrt(q.shape[-1])
    from repro_torch.kernels import flash_fwd as fwd_mod
    from repro_torch.kernels import ops

    qs = ops._prep(qt, scale)
    spec = MaskSpec(**PAIR_CASE.spec)
    o, lse = fwd_mod.flash_fwd(qs, kt, vt, spec, block_q=64, block_kv=64)
    delta = bwd_mod.flash_bwd_delta(o, dot)
    dq, dk, dv = bwd_mod.flash_bwd_fused_plain(qs, kt, vt, dot, lse, delta, spec, block_q=64,
                                               block_kv=64)
    ours = (dq * scale, dk, dv)
    for name, a, b in zip(("dq", "dk", "dv"), ours, theirs[1:]):
        np.testing.assert_allclose(_f32(a), _f32(b), err_msg=name, **TOL_F32)
