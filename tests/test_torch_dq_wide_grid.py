"""The dQ kernel's launch grid on the CPU (``flash_bwd.dq_grid``, the grid
``launch_dq`` in ``csrc/flash_bwd.cu`` launches): at head_dim 160 and 256
batch * head is the grid's x, so that CUDA, which issues blocks x-fastest,
puts the longest causal walk of every head into the first wave (the
card's 132 SMs, one CTA an SM); at 64 and 128 the pairs of q tiles stay on
x. Each (head, q tile) is one CTA's exactly once. Then the wrapper's
refusal, before any launch, of more than 65,535 q tiles (256) or pairs
(160) on y, on meta tensors with the device check stubbed (no card)."""

import pytest
import torch

from repro_torch.core.masks import MaskSpec
from repro_torch.kernels import flash_bwd as bwd_mod
from repro_torch.kernels.schedule import SMS, build_q_tile_schedule, pair_walk

BLOCK = 64


def launch_order(B, Hq, Sq, D):
    """The CTAs of ``dq_grid`` in issue order (x fastest): (head row
    b * Hq + h, the q tiles the CTA owns), as the kernel reads its block
    index."""
    gx, gy = bwd_mod.dq_grid(B, Hq, Sq, D, BLOCK)
    t_q = -(-Sq // BLOCK)
    wide = D in (160, 256)
    ctas = []
    for y in range(gy):
        for x in range(gx):
            bh, c = (x, y) if wide else (y, x)
            i0 = t_q - 1 - c if D == 256 else 2 * ((t_q + 1) // 2 - 1 - c)
            ctas.append((bh, tuple(i for i in (i0, i0 + 1) if i < t_q and (D != 256 or i == i0))))
    return ctas


def causal_walk(Sq, D, tiles):
    """The number of kv tiles a CTA owning ``tiles`` walks under the causal
    mask (the union of its q tiles' visible kv tiles, ``pair_walk``)."""
    t_q = -(-Sq // BLOCK)
    csr = build_q_tile_schedule(MaskSpec(causal=True), t_q, t_q, BLOCK, BLOCK, Sq)
    if D == 256:
        return int(csr.row_ptr[tiles[0] + 1] - csr.row_ptr[tiles[0]])
    return len(pair_walk(csr, tiles[0] // 2))


# (B, Hq, Sq, D): gemma3-1b's and stablelm-12b's training shapes, and a
# ragged odd tile count (21 q tiles, the last pair one tile) at each.
SHAPES = [(4, 4, 2048, 256), (2, 32, 2048, 160), (3, 5, 1300, 256), (2, 7, 1300, 160)]


@pytest.mark.parametrize("B,Hq,Sq,D", SHAPES, ids=lambda v: str(v))
def test_first_wave_holds_every_heads_longest_walk(B, Hq, Sq, D):
    ctas = launch_order(B, Hq, Sq, D)
    t_q = -(-Sq // BLOCK)
    owned = sorted((bh, i) for bh, tiles in ctas for i in tiles)
    assert owned == [(bh, i) for bh in range(B * Hq) for i in range(t_q)]
    assert len(ctas) == (B * Hq * (t_q if D == 256 else -(-t_q // 2)))
    walks = [causal_walk(Sq, D, tiles) for _, tiles in ctas]
    first = ctas[:SMS]
    for bh in range(B * Hq):
        longest = max(w for (h, _), w in zip(ctas, walks) if h == bh)
        assert any(h == bh and causal_walk(Sq, D, tiles) == longest for h, tiles in first), bh
    # Within the first wave the walks never grow: the longest come first.
    assert walks[:B * Hq] == [max(walks)] * (B * Hq)


@pytest.mark.parametrize("D", [64, 128])
def test_pair_grid_keeps_the_pairs_on_x(D):
    """At 64 and 128 the grid is as it was: pairs on x, batch * head on y,
    so at stablelm-12b's heads the first wave holds every pair of the first
    heads only (the wide order is an open question there)."""
    assert bwd_mod.dq_grid(2, 32, 2048, D, BLOCK) == (16, 64)
    first = launch_order(2, 32, 2048, D)[:SMS]
    assert {bh for bh, _ in first} == set(range(SMS // 16 + 1))


@pytest.mark.parametrize("D", [160, 256])
@pytest.mark.parametrize("over", [False, True], ids=["at-the-limit", "over-the-limit"])
def test_wrapper_refuses_too_many_tiles_on_y(monkeypatch, D, over):
    """65,535 q tiles (256) or pairs (160) on y pass the check and reach the
    kernel arguments; one more is refused before them, and before the
    library is loaded."""
    class Reached(Exception):
        pass

    def reached(*a, **kw):
        raise Reached

    def no_library():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(bwd_mod, "_check_device", lambda name, t: None)
    monkeypatch.setattr(bwd_mod, "_kernel_args", reached)
    monkeypatch.setattr(bwd_mod, "_lib", no_library)
    per_cta = 1 if D == 256 else 2
    Sq = (65535 + over) * per_cta * BLOCK
    q = torch.empty((1, Sq, 1, D), dtype=torch.bfloat16, device="meta")
    k = torch.empty((1, 128, 1, D), dtype=torch.bfloat16, device="meta")
    lse = torch.empty((1, 1, Sq), dtype=torch.float32, device="meta")
    assert bwd_mod.dq_grid(1, 1, Sq, D, BLOCK)[1] == 65535 + over
    with pytest.raises(ValueError if over else Reached, match="65535" if over else None):
        bwd_mod.flash_bwd_dq(q, k, k, q, lse, lse, MaskSpec(causal=True), block_q=BLOCK,
                             block_kv=BLOCK)
