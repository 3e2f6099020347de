"""The CUDA kernels against their plain PyTorch versions on the card.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed. On a machine with an NVIDIA GPU, from the repo
root (``--noconftest`` because tests/conftest.py imports JAX):

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_kernels_gpu.py

Without a card every test skips (decided inside the fixture, never at
import, so every pytest worker collects the same tests).
"""

import math

import pytest
import torch

from repro_torch.core.masks import MaskSpec
from repro_torch.kernels import flash_decode as dec_mod
from repro_torch.kernels import flash_fwd as fwd_mod
from repro_torch.kernels import ops

# bf16 outputs (one bf16 ulp near |o| ~ 1 is 0.008); f32 lse.
O_TOL, LSE_TOL = 2e-2, 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _randn(gen, shape, dev):
    return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)


def _err(a, b):
    fin = torch.isfinite(b)
    assert torch.equal(torch.isfinite(a), fin)
    return (a.float()[fin] - b.float()[fin]).abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,spec", [
    (1, 64, dict(causal=True)),
    (1, 700, dict(causal=True)),
    (4, 2048, dict(causal=True)),
    (2, 300, dict(causal=True)),
    (1, 333, dict(causal=True, window=100, sink=4)),
    (2, 200, dict(causal=False)),
])
def test_forward_kernel_matches_plain(cuda, B, S, spec):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = ops._prep(_randn(gen, (B, S, 32, 128), cuda), 1 / math.sqrt(128))
    k, v = _randn(gen, (B, S, 8, 128), cuda), _randn(gen, (B, S, 8, 128), cuda)
    spec = MaskSpec(**spec)
    before = fwd_mod.flash_fwd.launches
    o, lse = fwd_mod.flash_fwd(q, k, v, spec, block_q=64, block_kv=64)
    torch.cuda.synchronize()
    assert fwd_mod.flash_fwd.launches == before + 1
    o_p, lse_p = fwd_mod.flash_fwd_plain(q, k, v, spec, block_q=64, block_kv=64)
    assert _err(o, o_p) < O_TOL
    assert _err(lse, lse_p) < LSE_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("lengths,window,sink", [
    ([1, 0, 777, 2048], None, 0),
    ([2048, 5, 1500, 64], 300, 4),
])
def test_decode_kernel_matches_plain(cuda, lengths, window, sink):
    gen = torch.Generator(device=cuda).manual_seed(1)
    B, S, Hkv, G, D = 4, 2048, 8, 4, 128
    q = _randn(gen, (B * Hkv, G, D), cuda)
    k, v = _randn(gen, (B, S, Hkv, D), cuda), _randn(gen, (B, S, Hkv, D), cuda)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = dec_mod.flash_decode.launches
    o, lse = dec_mod.flash_decode(q, k, v, lens, num_splits=8, window=window, sink=sink)
    torch.cuda.synchronize()
    assert dec_mod.flash_decode.launches == before + 1
    o_p, lse_p = dec_mod.flash_decode_plain(q, k, v, lens, num_splits=8,
                                            window=window, sink=sink)
    assert _err(o, o_p) < O_TOL
    assert _err(lse, lse_p) < LSE_TOL


@pytest.mark.gpu
def test_kernels_reject_what_they_do_not_take(cuda):
    q = torch.zeros((1, 64, 4, 128), device=cuda)  # float32
    with pytest.raises(TypeError, match="bfloat16"):
        fwd_mod.flash_fwd(q, q, q, MaskSpec(causal=True), block_q=64, block_kv=64)
    qb = q.to(torch.bfloat16)
    with pytest.raises(ValueError, match="block_q"):
        fwd_mod.flash_fwd(qb, qb, qb, MaskSpec(causal=True), block_q=32, block_kv=64)
