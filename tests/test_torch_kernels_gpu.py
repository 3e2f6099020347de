"""The CUDA kernels against their plain PyTorch versions on the card.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed. On a machine with an NVIDIA GPU, from the repo
root (``--noconftest`` because tests/conftest.py imports JAX):

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_kernels_gpu.py

Without a card every test skips (decided inside the fixture, never at
import, so every pytest worker collects the same tests).
"""

import dataclasses
import math

import pytest
import torch

from repro_torch.configs import registry
from repro_torch.core.attention import AttentionConfig
from repro_torch.core.masks import MaskSpec
from repro_torch.kernels import flash_bwd as bwd_mod
from repro_torch.kernels import flash_decode as dec_mod
from repro_torch.kernels import flash_fwd as fwd_mod
from repro_torch.kernels import ops
from repro_torch.launch.steps import build_train_step
from repro_torch.models.lm import init_lm
from repro_torch.training.optimizer import AdamWConfig, init_opt_state

# bf16 outputs (one bf16 ulp near |o| ~ 1 is 0.008); f32 lse.
O_TOL, LSE_TOL = 2e-2, 1e-3
# f32 delta from bf16 O and dO: summation order only.
DELTA_TOL = 1e-4
# f32 gradients, relative to the largest |gradient| of the tensor: the kernel
# and its plain version round P and dS to bf16 at the same places, so the
# differences are summation order, the atomics' order in dq, and a value
# that lands one bf16 ulp apart.
GRAD_REL_TOL = 1e-2


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


def _rel_err(a, b):
    assert torch.isfinite(a).all()
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S", [(1, 64), (2, 700), (2, 2048)])
def test_delta_kernel_matches_plain(cuda, B, S):
    gen = torch.Generator(device=cuda).manual_seed(2)
    o, do = _randn(gen, (B, S, 32, 128), cuda), _randn(gen, (B, S, 32, 128), cuda)
    before = bwd_mod.flash_bwd_delta.launches
    delta = bwd_mod.flash_bwd_delta(o, do)
    torch.cuda.synchronize()
    assert bwd_mod.flash_bwd_delta.launches == before + 1
    assert _err(delta, bwd_mod.flash_bwd_delta_plain(o, do)) < DELTA_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,Hq,Hkv,spec", [
    (1, 64, 32, 8, dict(causal=True)),
    (2, 700, 32, 8, dict(causal=True)),
    (1, 256, 8, 8, dict(causal=True)),
    (1, 333, 32, 8, dict(causal=True, window=100, sink=4)),
    (2, 200, 16, 4, dict(causal=False)),
    (1, 300, 32, 8, dict(causal=True, q_offset=-128)),  # rows 0-127 see nothing
])
def test_fused_backward_kernel_matches_plain(cuda, B, S, Hq, Hkv, spec):
    gen = torch.Generator(device=cuda).manual_seed(3)
    spec = MaskSpec(**spec)
    q = ops._prep(_randn(gen, (B, S, Hq, 128), cuda), 1 / math.sqrt(128))
    k, v = _randn(gen, (B, S, Hkv, 128), cuda), _randn(gen, (B, S, Hkv, 128), cuda)
    do = _randn(gen, (B, S, Hq, 128), cuda)
    o, lse = fwd_mod.flash_fwd(q, k, v, spec, block_q=64, block_kv=64)
    delta = bwd_mod.flash_bwd_delta(o, do)
    before = bwd_mod.flash_bwd_fused.launches
    got = bwd_mod.flash_bwd_fused(q, k, v, do, lse, delta, spec, block_q=64, block_kv=64)
    torch.cuda.synchronize()
    assert bwd_mod.flash_bwd_fused.launches == before + 1
    want = bwd_mod.flash_bwd_fused_plain(q, k, v, do, lse, delta, spec, block_q=64, block_kv=64)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        assert _rel_err(a, b) < GRAD_REL_TOL, name
    if spec.q_offset < 0:
        assert (got[0][:, :-spec.q_offset] == 0).all()


@pytest.mark.gpu
def test_training_step_runs_through_the_kernels(cuda):
    """A 2-layer, full-width qwen3-8b step through flash_cuda launches the
    forward twice a layer (remat), the delta and fused kernels once a layer,
    and no plain version."""
    cfg = dataclasses.replace(registry.get("qwen3-8b"), num_layers=2)
    model = init_lm(cfg, seed=0, device=cuda)
    state = init_opt_state(dict(model.named_parameters()))
    step = build_train_step(cfg, AttentionConfig(impl="flash_cuda"), AdamWConfig())
    tokens = torch.randint(0, cfg.vocab_size, (1, 257), generator=torch.Generator().manual_seed(0))
    batch = {"inputs": tokens[:, :-1].to(cuda), "targets": tokens[:, 1:].to(cuda)}
    counters = (fwd_mod.flash_fwd, bwd_mod.flash_bwd_delta, bwd_mod.flash_bwd_fused)
    plains = (fwd_mod.flash_fwd_plain, bwd_mod.flash_bwd_delta_plain,
              bwd_mod.flash_bwd_fused_plain)
    for f in counters:
        f.launches = 0
    for f in plains:
        f.calls = 0
    state, metrics = step(model, state, batch)
    torch.cuda.synchronize()
    assert [f.launches for f in counters] == [4, 2, 2]
    assert [f.calls for f in plains] == [0, 0, 0]
    assert math.isfinite(metrics["loss"]) and math.isfinite(metrics["grad_norm"])
    assert metrics["skipped"] == 0.0


@pytest.mark.gpu
def test_split_backward_raises(cuda):
    q = torch.zeros((1, 64, 4, 128), device=cuda, dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ops.flash_attention(q, q, q, bwd="split")
