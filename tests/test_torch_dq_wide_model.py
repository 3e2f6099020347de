"""The head_dim-256 dQ kernel's hand-over (``csrc/flash_bwd.cu``
``dq_wide``: each warpgroup computes S and dP for half of a
step's kv columns and writes its half of dS into one of two alternating
slots; after a named barrier both add the whole slot times K into their
columns of dQ, issued with the next step's S and dP; K and V on their own
rings) under random interleavings, through the CPU model
``tools/model_dq_wide.py``: with the kernel's protocol every walk ends with
each product reading its own step's tiles and both dS halves; one slot, or
V freed when dP is issued rather than completed, breaks, which is why the
kernel has two slots and frees V after dP's wait."""

import importlib.util
from pathlib import Path

import pytest

_SPEC = importlib.util.spec_from_file_location(
    "model_dq_wide", Path(__file__).resolve().parents[1] / "tools" / "model_dq_wide.py")
model = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(model)

WALKS = 300


@pytest.mark.parametrize("kst,vst", [(3, 1), (2, 2)], ids=["K3-V1", "K2-V2"])
def test_the_kernels_protocol_never_breaks(kst, vst):
    assert model.broken_walks(kst, vst, 2, False, WALKS)[0] == 0


@pytest.mark.parametrize("kst,vst,n_slots,v_early", [(3, 1, 1, False), (3, 1, 2, True)],
                         ids=["one-slot", "v-freed-at-issue"])
def test_one_slot_or_v_freed_early_breaks(kst, vst, n_slots, v_early):
    """The controls: the model does see the faults the second slot and
    V's release after dP's wait remove (most walks break)."""
    broke, first = model.broken_walks(kst, vst, n_slots, v_early, WALKS)
    assert broke > WALKS // 2, first
