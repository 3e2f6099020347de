"""The paged decode kernel's work split, held on the CPU.

``csrc/flash_decode.cu`` deals each split's visible pages to the warps of a
cluster of CTAs and merges their partials back into the split's one
partial. ``kernels.flash_decode.paged_deal`` states that dealing in plain
Python; these tests hold it against a brute-force reading of which pages
hold a visible position.
"""

import pytest

from repro_torch.kernels.flash_decode import (PAGED_WORKERS, paged_deal, paged_geometry,
                                              paged_visible_runs)

CAPACITY = 2048
SPECS = [(None, 0), (256, 0), (256, 4), (100, 40)]  # (window, sink)


def _visible(length, ps, page, window, sink):
    """Whether logical page ``page`` holds a position the query sees."""
    rows = range(page * ps, (page + 1) * ps)
    if window is None:
        return any(r < length for r in rows)
    return any(r < length and (r >= length - window or r < sink) for r in rows)


@pytest.mark.parametrize("window,sink", SPECS)
@pytest.mark.parametrize("num_splits", [1, 8, 17])
@pytest.mark.parametrize("ps", [16, 64])
def test_paged_deal_covers_each_visible_page_once_in_logical_order(ps, num_splits, window, sink):
    n_pages = CAPACITY // ps
    ns, pp = paged_geometry(n_pages, num_splits)
    for length in (0, 1, ps - 1, ps, 700, 2048):
        deal = paged_deal(length, ps, n_pages, num_splits, window, sink)
        assert len(deal) == ns and all(len(split) == PAGED_WORKERS for split in deal)
        dealt = {}
        for c, split in enumerate(deal):
            for k, pages in enumerate(split):
                assert pages == sorted(pages), "a worker's pages ascend"
                for p in pages:
                    assert p not in dealt, f"page {p} dealt twice"
                    assert c * pp <= p < (c + 1) * pp, "a page goes to a worker of its split"
                    dealt[p] = (c, k)
            # The merge visits the workers in order: their pages, run after
            # run, are in logical order.
            merged = [p for pages in split for p in pages]
            assert merged == sorted(merged)
            sizes = [len(pages) for pages in split]
            assert max(sizes) - min(sizes) <= 1, "the runs are balanced"
        want = {p for p in range(n_pages) if _visible(length, ps, p, window, sink)}
        assert set(dealt) == want, f"length {length}: dealt pages differ from the visible ones"


@pytest.mark.parametrize("window,sink", SPECS)
def test_paged_visible_runs_are_at_most_two_ascending_runs(window, sink):
    ps, n_pages = 16, CAPACITY // 16
    for length in (0, 1, 15, 16, 300, 700, 2048):
        for page0, page1 in ((0, n_pages), (8, 24), (40, 41), (120, n_pages)):
            runs = paged_visible_runs(length, ps, page0, page1, window, sink)
            assert len(runs) <= (1 if window is None else 2)
            pages = [p for a, b in runs for p in range(a, b)]
            assert all(a < b for a, b in runs) and pages == sorted(set(pages))
            assert pages == [p for p in range(page0, page1)
                             if _visible(length, ps, p, window, sink)]


def test_paged_deal_spreads_the_serving_shape_over_168_ctas():
    """The timing shape of chip_smoke.py (lengths 15, 108, 708, 1508 of
    2048, pages of 16, 8 splits, 8 kv heads): CTAs (two per split) with at
    least one page."""
    workers_per_cta = PAGED_WORKERS // 2
    busy = 0
    for length in (15, 108, 708, 1508):
        for split in paged_deal(length, 16, 128, 8):
            busy += sum(any(split[r * workers_per_cta:(r + 1) * workers_per_cta])
                        for r in range(2))
    assert busy * 8 == 168
