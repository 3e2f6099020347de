"""The head_dim-64 fused backward's dQ hand-over (``csrc/flash_bwd.cu``
``kv_stationary<64, true, ...>``: one warpgroup a step computes dQ over the
pair's 128 kv rows, in turn, the other only arrives at the step's named
barrier) under random interleavings, through the CPU model
``tools/model_bwd64_dq.py``: with the kernel's protocol (a named barrier a
turn, two dS^T buffers, one staging buffer a warpgroup; two as well) every
walk ends with each product reading both halves of its own step and each
writer its own steps; one barrier for both turns, or one dS^T buffer,
breaks, which is why the kernel has two of each."""

import importlib.util
from pathlib import Path

import pytest

_SPEC = importlib.util.spec_from_file_location(
    "model_bwd64_dq", Path(__file__).resolve().parents[1] / "tools" / "model_bwd64_dq.py")
model = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(model)

WALKS = 300


@pytest.mark.parametrize("n_stg", [1, 2], ids=lambda n: f"{n}-staging")
def test_the_kernels_protocol_never_breaks(n_stg):
    assert model.broken_walks(2, 2, n_stg, WALKS)[0] == 0


@pytest.mark.parametrize("n_bar,n_ds", [(1, 2), (2, 1)], ids=["one-barrier", "one-buffer"])
def test_one_barrier_or_one_buffer_breaks(n_bar, n_ds):
    """The controls: the model does see the faults the second barrier and
    the second dS^T buffer remove."""
    assert model.broken_walks(n_bar, n_ds, 2, WALKS)[0] > 0
