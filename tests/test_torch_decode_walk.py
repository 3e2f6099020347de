"""The contiguous decode kernel's work split, held on the CPU.

``csrc/flash_decode.cu`` deals each split's visible 16-row units to the
warps of a cluster of CTAs and merges their partials back into the split's
one partial. ``kernels.flash_decode.decode_deal`` states that dealing in
plain Python; these tests hold it against a brute-force reading of which
units hold a visible position, and replay the kernel's order of work (a
running softmax per worker over its units, then the workers merged in
order) against the plain version of the decode.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_decode import (DECODE_UNIT, DECODE_WORKERS, decode_deal,
                                              decode_geometry, flash_decode_plain)

SPECS = [(None, 0), (256, 0), (256, 4), (100, 40)]  # (window, sink)
LENGTHS = (0, 1, 15, 16, 17, 700, 2048)


def _visible(pos, length, window, sink):
    return pos < length and (window is None or pos >= length - window or pos < sink)


@pytest.mark.parametrize("window,sink", SPECS)
@pytest.mark.parametrize("num_splits", [1, 8, 17])
@pytest.mark.parametrize("S", [448, 1500, 2048])
def test_decode_deal_covers_each_visible_unit_once_in_position_order(S, num_splits, window,
                                                                      sink):
    ns, chunk = decode_geometry(S, num_splits)
    for length in LENGTHS:
        L = min(length, S)
        deal = decode_deal(length, S, num_splits, window, sink)
        assert len(deal) == ns and all(len(split) == DECODE_WORKERS for split in deal)
        dealt = set()
        for c, split in enumerate(deal):
            lo, end = c * chunk, min(c * chunk + chunk, S)
            for starts in split:
                assert starts == sorted(starts), "a worker's units ascend"
                for u in starts:
                    assert u not in dealt, f"unit {u} dealt twice"
                    assert lo <= u < end and (u - lo) % DECODE_UNIT == 0, \
                        "a unit starts on its split's 16-row grid, inside the split"
                    dealt.add(u)
            # The merge visits the workers in order: their units, run after
            # run, are in position order.
            merged = [u for starts in split for u in starts]
            assert merged == sorted(merged)
            sizes = [len(starts) for starts in split]
            assert max(sizes) - min(sizes) <= 1, "the runs are balanced"
            # Exactly the units of this split with a visible position.
            want = {u for u in range(lo, end, DECODE_UNIT)
                    if any(_visible(p, L, window, sink)
                           for p in range(u, min(u + DECODE_UNIT, end)))}
            assert set(merged) == want, f"length {length}, split {c}"


def test_decode_deal_reads_nothing_past_the_length_or_the_cache():
    """A unit's rows stop at min(split end, S, length): the last batch row's
    tail is never read past the allocation."""
    for S, length in ((1500, 1500), (448, 37), (2048, 2048), (700, 699)):
        ns, chunk = decode_geometry(S, 8)
        for c, split in enumerate(decode_deal(length, S, 8)):
            for starts in split:
                assert all(u < min(c * chunk + chunk, S, length) for u in starts)


def test_decode_deal_spreads_the_serving_shape_over_168_ctas():
    """The timing shape of chip_smoke.py (lengths 15, 108, 708, 1508 of
    2048, 8 splits, 8 kv heads): CTAs (two per split) with at least one
    unit. The design it replaced ran one CTA a split: 88 of 256 had work."""
    per_cta = DECODE_WORKERS // 2
    busy = old = 0
    for length in (15, 108, 708, 1508):
        for split in decode_deal(length, 2048, 8):
            busy += sum(any(split[r * per_cta:(r + 1) * per_cta]) for r in range(2))
            old += any(split)
    assert (busy * 8, old * 8) == (168, 88)


def _replay(q, k, v, lengths, num_splits, window, sink):
    """The kernel's order of work in f64, on the plain version's layouts:
    per split, each worker runs an online softmax over its dealt units
    (masked rows of a unit take DEFAULT_MASK_VALUE's role: P = 0), then
    rank 0 merges the workers in order; a split that saw nothing gives
    (0, -inf). The cache is f32 here, so P is not rounded (the plain
    version rounds P to the cache's dtype)."""
    B, S, Hk, D = k.shape
    G = q.shape[1]
    ns, chunk = decode_geometry(S, num_splits)
    o = np.zeros((B * Hk, ns, G, D))
    lse = np.full((B * Hk, ns, G), -np.inf)
    qf = q.double().numpy().reshape(B, Hk, G, D)
    kf, vf = k.double().numpy(), v.double().numpy()
    for b, length in enumerate(lengths):
        L = min(length, S)
        for c, split in enumerate(decode_deal(length, S, num_splits, window, sink)):
            end = min(c * chunk + chunk, S, L)
            for h in range(Hk):
                parts = []
                for starts in split:
                    m, l, acc = np.full(G, -np.inf), np.zeros(G), np.zeros((G, D))
                    for u in starts:
                        pos = [p for p in range(u, min(u + DECODE_UNIT, end))
                               if _visible(p, L, window, sink)]
                        s = qf[b, h] @ kf[b, pos, h].T  # (G, rows)
                        m_new = np.maximum(m, s.max(axis=1))
                        alpha = np.exp(m - m_new)
                        p = np.exp(s - m_new[:, None])
                        l = l * alpha + p.sum(axis=1)
                        acc = acc * alpha[:, None] + p @ vf[b, pos, h]
                        m = m_new
                    parts.append((m, l, acc))
                mx = np.max([m for m, _, _ in parts], axis=0)
                if np.isneginf(mx).all():
                    continue
                e = [np.exp(m - mx) for m, _, _ in parts]
                total = sum(ei * l for ei, (_, l, _) in zip(e, parts))
                o[b * Hk + h, c] = sum(ei[:, None] * a for ei, (_, _, a) in zip(e, parts)) \
                    / total[:, None]
                lse[b * Hk + h, c] = mx + np.log(total)
    return o, lse


@pytest.mark.parametrize("S,lengths,num_splits,window,sink", [
    (448, [0, 1, 37, 448], 8, None, 0),
    (700, [700, 17, 333, 16], 17, 100, 4),
    (300, [300, 299, 150, 5], 3, 64, 0),
])
def test_the_kernels_order_of_work_gives_the_plain_partials(S, lengths, num_splits, window,
                                                            sink):
    """Units dealt to workers and merged in worker order compute the plain
    version's partials (its chunk-wide max and one softmax a split) up to
    f32 rounding."""
    rng = np.random.default_rng(0)
    B, Hk, G, D = len(lengths), 2, 4, 16
    q = torch.from_numpy(rng.standard_normal((B * Hk, G, D)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, S, Hk, D)).astype(np.float32))
            for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32)
    o_p, lse_p = flash_decode_plain(q, k, v, lens, num_splits=num_splits, window=window,
                                    sink=sink)
    o_r, lse_r = _replay(q, k, v, lengths, num_splits, window, sink)
    np.testing.assert_array_equal(np.isneginf(lse_p.numpy()), np.isneginf(lse_r))
    fin = np.isfinite(lse_r)
    np.testing.assert_allclose(lse_p.numpy()[fin], lse_r[fin], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(o_p.numpy(), o_r, rtol=1e-5, atol=1e-5)
