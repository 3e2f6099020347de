"""The head split of the KV-stationary backward at head_dim 160 and 256 on
the CPU: where the wrapper splits a group's q heads over CTAs
(``flash_bwd.kv_head_split``), the scratch the CTAs' f32 dK/dV partials go
to, the launch arguments of both layouts (no card: the stream is stubbed,
the tensors are on the meta device), and the group sum's plain version
(which the group-sum kernel is held to on the card, bitwise). Then the
layout's arithmetic against the JAX package: each q head's dK/dV through
the fused plain version, summed over the group in order by the group sum,
against the Pallas fused kernel's group-summed dK/dV in interpret mode on
the same numpy inputs."""

import numpy as np
import pytest
import torch

from repro.core.masks import MaskSpec as JaxMaskSpec
from repro.kernels import flash_bwd as jax_bwd
from repro_torch.configs import registry
from repro_torch.core.masks import MaskSpec
from repro_torch.kernels import flash_bwd as bwd_mod
from repro_torch.kernels import flash_fwd as fwd_mod

TOL = dict(atol=2e-5, rtol=2e-5)  # f32 on both sides: summation order and tiling only
BLOCK = 64

# (arch, B, S, window, split): the training shapes chip_smoke.py trains
# (gemma3-1b B 4, stablelm-12b and qwen3-8b B 2, S 2048; whisper-base's
# encoder B 8, S 1500, granite-moe-1b-a400m's serving prefill), each layer
# kind's mask. gemma3's causal layers run 128 CTAs a launch on the plain
# grid whose walks reach 4 x 32 steps against a balanced share of 64: they
# split, one q head a CTA; its 512-window layers walk evenly (36 steps a
# CTA) and do not; a batch row of them alone (32 CTAs) does. stablelm's
# 512 CTAs fill the card; 128 and 64 have pair kernels and no split.
RULE_CASES = [
    ("gemma3-1b", 4, 2048, None, 4),
    ("gemma3-1b", 4, 2048, 512, 1),
    ("gemma3-1b", 1, 2048, 512, 4),
    ("stablelm-12b", 2, 2048, None, 1),
    ("qwen3-8b", 2, 2048, None, 1),
    ("whisper-base", 8, 1500, None, 1),
    ("granite-moe-1b-a400m", 1, 1536, None, 1),
]


@pytest.mark.parametrize("arch,B,S,window,split", RULE_CASES)
def test_head_split_rule_at_the_registry_training_shapes(arch, B, S, window, split):
    cfg = registry.get(arch)
    spec = MaskSpec(causal=True, window=window)
    got = bwd_mod.kv_head_split(spec, B, S, S, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                                BLOCK, BLOCK)
    assert got == split
    # A split is whole shares of the group, and only where a CTA owns one
    # kv tile.
    assert (cfg.num_heads // cfg.num_kv_heads) % got == 0
    assert got == 1 or cfg.head_dim in (160, 256)
    # The grid the kernels launch: a CTA a kv tile and share at 160 and 256
    # (gemma3's causal launches 4 x 32 x 4 = 512 CTAs), pairs of kv tiles
    # at 64 and 128.
    t_kv = -(-S // BLOCK)
    grid = bwd_mod.kv_grid(B, cfg.num_kv_heads, S, cfg.head_dim, BLOCK, got)
    if cfg.head_dim in (160, 256):
        assert grid == (B * cfg.num_kv_heads, got, t_kv)
    else:
        assert grid == (B * cfg.num_kv_heads, -(-t_kv // 2), 1)


def test_head_split_scratch_shape_and_bytes():
    """gemma3-1b's training shape: the partials of dK and of dV are (B, Skv,
    Hkv * 4, D) f32, 33.5 MB each, where the plain grid writes (B, Skv, Hkv,
    D) itself."""
    q = torch.empty((4, 2048, 4, 256), dtype=torch.bfloat16, device="meta")
    k = torch.empty((4, 2048, 1, 256), dtype=torch.bfloat16, device="meta")
    split = bwd_mod.kv_head_split(MaskSpec(causal=True), 4, 2048, 2048, 4, 1, 256, BLOCK, BLOCK)
    pk, pv = bwd_mod._empty_dkv(q, k, split)
    assert pk.shape == pv.shape == (4, 2048, 4, 256) and pk.dtype == torch.float32
    assert pk.numel() * pk.element_size() == 33_554_432
    assert sum(t.numel() * t.element_size() for t in (pk, pv)) == 67_108_864
    dk, dv = bwd_mod._empty_dkv(q, k)
    assert dk.shape == dv.shape == (4, 2048, 1, 256)


@pytest.mark.parametrize("G", [1, 2, 4])
def test_group_sum_plain_matches_a_direct_sum(G):
    """The group sum's plain version against a direct sum over each kv
    head's G partials, and bitwise against the same adds in order."""
    rng = np.random.default_rng(G)
    B, Skv, Hkv, D = 2, 70, 2, 160
    pk, pv = (rng.standard_normal((B, Skv, Hkv * G, D), dtype=np.float32) for _ in range(2))
    before = bwd_mod.flash_bwd_group_sum_plain.calls
    dk, dv = bwd_mod.flash_bwd_group_sum(torch.from_numpy(pk), torch.from_numpy(pv), Hkv)
    assert bwd_mod.flash_bwd_group_sum_plain.calls == before + 1
    for got, part in ((dk, pk), (dv, pv)):
        x = part.reshape(B, Skv, Hkv, G, D)
        assert got.shape == (B, Skv, Hkv, D) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), x.sum(axis=3), rtol=1e-6, atol=1e-6)
        ordered = x[:, :, :, 0].copy()
        for i in range(1, G):
            ordered = ordered + x[:, :, :, i]
        assert np.array_equal(got.numpy(), ordered)
    with pytest.raises(ValueError, match="partials"):
        bwd_mod.flash_bwd_group_sum(torch.from_numpy(pk), torch.from_numpy(pv)[:, :, :1], Hkv)


@pytest.mark.parametrize("D", [160, 256])
def test_kernel_args_of_both_layouts_are_built_without_a_card(monkeypatch, D):
    """The KV-stationary entries take the head split after the dense flag
    (argument 33 of the wrapper's 41; the dQ kernel's 40 have none), in
    every mode; a split that is not whole shares of the group, one at
    head_dim 128 or one for the dQ kernel is refused before the launch."""
    monkeypatch.setattr(bwd_mod, "_stream", lambda t: 0)
    spec = MaskSpec(causal=True)
    ids = torch.empty((1, 128), dtype=torch.int32, device="meta")
    lse = torch.empty((1, 4, 128), dtype=torch.float32, device="meta")
    q = torch.empty((1, 128, 4, D), dtype=torch.bfloat16, device="meta")
    k = torch.empty((1, 128, 1, D), dtype=torch.bfloat16, device="meta")
    args = (q, k, k, q, lse, lse, spec, BLOCK, BLOCK)
    for segments in (None, (ids, ids)):
        for schedule in ("compact", "dense"):
            for hsplit in (1, 2, 4):
                out, _ = bwd_mod._kernel_args("the CUDA fused backward", *args, segments,
                                              q_major=False, schedule=schedule, hsplit=hsplit)
                assert len(out) == 41 and out[33] == hsplit
                assert out[32] == int(schedule == "dense") and out[31] == 2  # t_kv
                assert (out[6] is None) == (schedule == "dense")
            out, _ = bwd_mod._kernel_args("the CUDA dQ kernel", *args, segments, q_major=True,
                                          schedule=schedule)
            assert len(out) == 40
            for bad, q_major in ((3, False), (8, False), (4, True)):
                with pytest.raises(ValueError, match="head split"):
                    bwd_mod._kernel_args("the CUDA dK/dV kernel", *args, segments,
                                         q_major=q_major, schedule=schedule, hsplit=bad)
    q128 = torch.empty((1, 128, 4, 128), dtype=torch.bfloat16, device="meta")
    k128 = torch.empty((1, 128, 1, 128), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="head split"):
        bwd_mod._kernel_args("the CUDA dK/dV kernel", q128, k128, k128, q128, lse, lse, spec,
                             BLOCK, BLOCK, None, q_major=False, schedule="compact", hsplit=2)


def _heads(x, rows):
    """(B, S, H, D) numpy -> the JAX kernels' (B*H, rows, D), zero-padded."""
    B, S, H, D = x.shape
    return np.pad(x.transpose(0, 2, 1, 3).reshape(B * H, S, D), ((0, 0), (0, rows - S), (0, 0)))


@pytest.mark.parametrize("D", [160, 256])
@pytest.mark.parametrize("spec_kw", [dict(causal=True), dict(causal=True, window=40, sink=8)])
def test_split_partials_summed_in_order_match_the_pallas_fused_kernel(D, spec_kw):
    """The head-split layout's arithmetic: each of the group's 4 q heads
    through the fused plain version alone (one CTA's share: its dK/dV
    partial), the partials summed by the group sum in head order, against
    the Pallas fused kernel's dK/dV over the whole group (interpret mode,
    ragged S 100, blocks of 32); the shares' dQ against its dQ."""
    B, S, Hq, G, bq = 2, 100, 4, 4, 32
    rng = np.random.default_rng(D)
    scale = 1 / np.sqrt(D, dtype=np.float32)
    q = rng.standard_normal((B, S, Hq, D), dtype=np.float32) * scale
    k, v = (rng.standard_normal((B, S, 1, D), dtype=np.float32) for _ in range(2))
    do = rng.standard_normal((B, S, Hq, D), dtype=np.float32) * scale
    spec = MaskSpec(**spec_kw)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = fwd_mod.flash_fwd(tq, tk, tv, spec, block_q=bq, block_kv=bq)
    delta = bwd_mod.flash_bwd_delta(o, tdo)
    parts, dqs = [], []
    for h in range(Hq):  # head h alone: the share of a one-head CTA
        dq_h, dk_h, dv_h = bwd_mod.flash_bwd_fused(
            tq[:, :, h:h + 1], tk, tv, tdo[:, :, h:h + 1], lse[:, h:h + 1], delta[:, h:h + 1],
            spec, block_q=bq, block_kv=bq)
        parts.append((dk_h, dv_h))
        dqs.append(dq_h)
    pk = torch.cat([p[0] for p in parts], dim=2)  # (B, S, Hkv * G, D), head h at h
    pv = torch.cat([p[1] for p in parts], dim=2)
    dk, dv = bwd_mod.flash_bwd_group_sum(pk, pv, 1)
    Sp = -(-S // bq) * bq
    lanes = np.pad(lse.reshape(B * Hq, S).numpy(), ((0, 0), (0, Sp - S)))
    jdk, jdv, jdq = jax_bwd.flash_bwd_fused(
        _heads(q, Sp), _heads(k, Sp), _heads(v, Sp), _heads(o.numpy(), Sp), _heads(do, Sp),
        lanes, JaxMaskSpec(**spec_kw), group=G, block_q=bq, block_kv=bq, kv_valid=S,
        interpret=True)
    unheads = lambda x, H: np.asarray(x)[:, :S].reshape(B, H, S, D).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(dk.numpy(), unheads(jdk, 1), err_msg="dk", **TOL)
    np.testing.assert_allclose(dv.numpy(), unheads(jdv, 1), err_msg="dv", **TOL)
    np.testing.assert_allclose(torch.cat(dqs, dim=2).numpy(), unheads(jdq, Hq), err_msg="dq",
                               **TOL)
