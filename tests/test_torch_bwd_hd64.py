"""The head_dim-64 backward (whisper-base's and gpt-20m's training) on the
port against the JAX package on the CPU: the fused, dK/dV and dQ kernels'
plain versions (which the CUDA kernels are held to on the card) against
the Pallas kernels in interpret mode, on the same numpy inputs, at the CUDA
kernels' 64 x 64 tiles and at small shapes of whisper's kinds: FULL with
Sq != Skv (its cross-attention), a FULL and a causal length that no tile
divides (an odd number of kv tiles, so the last pair of a KV-stationary
CTA has one tile), causal at whole tiles, G = 1 as in whisper and gpt-20m
and one grouped case; packed ids through the segment kernels; the dense
schedule against the Pallas dense bodies and bitwise the compact one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.masks import MaskSpec as JaxMaskSpec
from repro.kernels import flash_bwd as jax_bwd
from repro_torch.core.masks import MaskSpec, pad_segments
from repro_torch.kernels import flash_bwd as bwd_mod
from repro_torch.kernels import flash_fwd as fwd_mod
from test_torch_flash_bwd import _heads
from test_torch_packed_wide import _ids

D = 64
BLOCK = 64  # the CUDA kernels' tiles
TOL = dict(atol=2e-5, rtol=2e-5)  # f32 on both sides: summation order and tiling only

# name: (B, Sq, Skv, Hq, Hkv, spec, ids)
CASES = {
    "cross_full": (1, 96, 200, 2, 2, dict(), None),
    "full_ragged": (1, 150, 150, 2, 2, dict(), None),
    "causal_whole": (2, 128, 128, 2, 2, dict(causal=True), None),
    "causal_ragged": (1, 130, 130, 2, 2, dict(causal=True), None),
    "causal_g2_ragged": (1, 100, 100, 4, 2, dict(causal=True), None),
    "causal_packed": (2, 130, 130, 2, 2, dict(causal=True), "packed"),
}
KERNELS = ("fused", "dkv", "dq")


def _port_args(name, schedule="compact"):
    """(q pre-scaled, k, v, dO, lse, delta, spec, *ids) as CPU tensors, lse
    and delta from the port's forward; and the numpy inputs."""
    B, Sq, Skv, Hq, Hk, spec_kw, kind = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name) + 64)
    q, do = (rng.standard_normal((B, Sq, Hq, D), dtype=np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, Skv, Hk, D), dtype=np.float32) for _ in range(2))
    q = q / np.sqrt(D, dtype=np.float32)
    spec = MaskSpec(**spec_kw)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    seg = () if kind is None else tuple(torch.from_numpy(x) for x in _ids(B, Sq, kind))
    tiles = dict(block_q=BLOCK, block_kv=BLOCK, schedule=schedule)
    fwd = fwd_mod.flash_fwd_varlen if seg else fwd_mod.flash_fwd
    o, lse = fwd(tq, tk, tv, spec, *seg, **tiles)
    args = (tq, tk, tv, tdo, lse, bwd_mod.flash_bwd_delta(o, tdo), spec, *seg)
    return args, (q, k, v, do, o.numpy())


def _port(kernel, args, schedule):
    """The port's wrapper on CPU tensors (its plain version): {name: grad}."""
    sfx = "_varlen" if len(args) > 7 else ""
    got = getattr(bwd_mod, f"flash_bwd_{kernel}{sfx}")(
        *args, block_q=BLOCK, block_kv=BLOCK, schedule=schedule)
    names = {"fused": ("dq", "dk", "dv"), "dkv": ("dk", "dv"), "dq": ("dq",)}[kernel]
    return dict(zip(names, got if isinstance(got, tuple) else (got,)))


def _pallas(kernel, name, args, arrays, schedule):
    """The Pallas kernel in interpret mode on the heads layout, from the same
    pre-scaled q, forward outputs, lse and delta: {name: grad} in the port's
    (B, S, H, D) layout."""
    B, Sq, Skv, Hq, Hk, spec_kw, _ = CASES[name]
    q, k, v, do, o = arrays
    lse, delta, seg = args[4], args[5], args[7:]
    Sqp, Skp = -(-Sq // BLOCK) * BLOCK, -(-Skv // BLOCK) * BLOCK
    lanes = lambda x: np.pad(x.reshape(B * Hq, Sq).numpy(), ((0, 0), (0, Sqp - Sq)))
    kw = dict(group=Hq // Hk, block_q=BLOCK, block_kv=BLOCK, kv_valid=Skv, interpret=True,
              schedule=schedule)
    if seg:
        q_seg, kv_seg = pad_segments(*seg, Sqp, Skp)
        kw.update(q_seg=jnp.asarray(q_seg.numpy()), kv_seg=jnp.asarray(kv_seg.numpy()))
    jspec = JaxMaskSpec(**spec_kw)
    if kernel == "fused":
        # The fused Pallas kernel takes the raw lse and computes delta itself.
        jdk, jdv, jdq = jax_bwd.flash_bwd_fused(
            _heads(q, Sqp), _heads(k, Skp), _heads(v, Skp), _heads(o, Sqp), _heads(do, Sqp),
            lanes(lse), jspec, **kw)
        want = dict(dq=jdq, dk=jdk, dv=jdv)
    else:
        # The split Pallas kernels take lse with fully masked rows zeroed and
        # delta, as the JAX wrapper hands them over (ops._core_bwd).
        lse_s = torch.where(torch.isneginf(lse), torch.zeros_like(lse), lse)
        jargs = (_heads(q, Sqp), _heads(k, Skp), _heads(v, Skp), _heads(do, Sqp), lanes(lse_s),
                 lanes(delta))
        if kernel == "dkv":
            want = dict(zip(("dk", "dv"), jax_bwd.flash_bwd_dkv(*jargs, jspec, **kw)))
        else:
            want = dict(dq=jax_bwd.flash_bwd_dq(*jargs, jspec, **kw))
    rows = dict(dq=(Sq, Hq), dk=(Skv, Hk), dv=(Skv, Hk))
    return {g: np.asarray(x)[:, :rows[g][0]].reshape(B, rows[g][1], rows[g][0], D)
            .transpose(0, 2, 1, 3) for g, x in want.items()}


def _check(got, want):
    for g, a in got.items():
        assert a.dtype == torch.float32 and a.shape == want[g].shape, g
        np.testing.assert_allclose(a.numpy(), want[g], err_msg=g, **TOL)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("name", list(CASES))
def test_backward_kernel_at_head_dim_64_matches_pallas(name, kernel):
    """Fused, dK/dV and dQ (their segment forms with ids) at head_dim 64
    against the Pallas kernels in interpret mode."""
    args, arrays = _port_args(name)
    _check(_port(kernel, args, "compact"), _pallas(kernel, name, args, arrays, "compact"))


@pytest.mark.parametrize("name", ["cross_full", "causal_ragged", "causal_packed"])
def test_dense_fused_at_head_dim_64_matches_pallas_and_compact(name):
    """The dense fused plain version (with ids its segment form) against the
    Pallas dense body, and its dq, dk, dv bitwise the compact ones: the
    invariant the dense CUDA kernels keep for dK and dV on the card."""
    args, arrays = _port_args(name, "dense")
    dense = _port("fused", args, "dense")
    _check(dense, _pallas("fused", name, args, arrays, "dense"))
    compact = _port("fused", args, "compact")
    assert all(torch.equal(dense[g], compact[g]) for g in dense)


@pytest.mark.parametrize("name", list(CASES))
def test_split_dkv_at_head_dim_64_is_the_fused_one_bitwise(name):
    """The dK/dV plain version is the fused walk without its dq line, so its
    dk and dv are the fused plain version's to the bit, as the CUDA dK/dV
    kernel's are the fused kernel's."""
    args, _ = _port_args(name)
    fused, dkv = _port("fused", args, "compact"), _port("dkv", args, "compact")
    assert torch.equal(fused["dk"], dkv["dk"]) and torch.equal(fused["dv"], dkv["dv"])
