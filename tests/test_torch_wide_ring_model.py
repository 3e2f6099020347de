"""The wide forward's K/V ring protocol (``csrc/flash_fwd.cu``
``fa2_fwd_wide_kernel``) under random interleavings, through the CPU model
``tools/model_wide_ring.py``: with the kernel's barrier slots every walk
ends with each consumer reading its own positions' records and tiles; with
one slot a stage the one-q-tile mode's 3-stage ring breaks, which is why
the kernel has two there."""

import importlib.util
from pathlib import Path

import pytest

_SPEC = importlib.util.spec_from_file_location(
    "model_wide_ring", Path(__file__).resolve().parents[1] / "tools" / "model_wide_ring.py")
model = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(model)

WALKS = 150


@pytest.mark.parametrize("single,nst,nb", [
    (True, 3, 6),   # head_dim 256, one q tile a CTA: two slots a stage
    (True, 4, 4),   # head_dim 160, one q tile a CTA
    (False, 2, 2),  # head_dim 256, a pair of q tiles a CTA
    (False, 4, 4),  # head_dim 160, a pair
], ids=["256-single", "160-single", "256-pair", "160-pair"])
def test_the_kernels_rings_never_break(single, nst, nb):
    assert model.broken_walks(single, nst, nb, WALKS)[0] == 0


def test_one_slot_a_stage_breaks_the_odd_single_tile_ring():
    """The control: the model does see the fault the extra slots remove."""
    assert model.broken_walks(True, 3, 3, WALKS)[0] > 0
