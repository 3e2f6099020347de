"""The split-KV forward at head_dim 256 (gemma3-1b) and 160 (stablelm-12b) on
the port against the JAX package on the CPU.

Kernel level: the plain version of the split-KV kernels
(``flash_fwd_splitkv_plain``, which the CUDA ``SPLIT`` instantiations at
256 and 160 are held to on the card), its per-split partials against the
Pallas partitioned forward (``flash_fwd(kv_splits=ks)``, interpret mode) and
its folded (o, lse) against those partials folded by the JAX package's
``combine_lse_outputs``, on the same numpy inputs: a short q against ten kv
tiles, causal with ``q_offset``, a window with sinks, a window that leaves
whole splits with nothing to see, and packed ids. Policy: the auto split at
256 and 160 is ``default_kv_splits``. Model level: reduced gemma3-1b at 256
and stablelm-12b at 160 (two layers each) on a packed batch with
``kv_splits=2``, the loss and its gradients against the JAX ``loss_fn`` on
its Pallas kernels with the same splits."""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.core.attention import AttentionConfig as JaxAttentionConfig
from repro.core.masks import MaskSpec as JaxMaskSpec
from repro.core.masks import pad_segments
from repro.core.online_softmax import combine_lse_outputs
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticVarlenLM as JaxSyntheticVarlenLM
from repro.kernels import flash_fwd as jax_fwd
from repro.launch import steps as jax_steps
from repro.models import lm as jax_lm
from repro_torch.configs import registry
from repro_torch.core.attention import AttentionConfig
from repro_torch.core.masks import MaskSpec
from repro_torch.kernels import flash_fwd as fwd_mod
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.models.lm import LM, params_from_jax
from test_torch_hd160 import _stablelm_160
from test_torch_hd256_train import _gemma3_256
from test_torch_serving import jax_trace_state  # noqa: F401  (the per-test JAX shim)
from test_torch_train import GRAD_TOL, LOSS_TOL

TOL = dict(atol=2e-5, rtol=2e-5)  # f32 on both sides: summation order and tiling only
BLOCK = 64  # the CUDA kernels' tiles
HEADS = {256: (4, 1), 160: (8, 2)}  # head_dim: (q heads, kv heads)

# name: (B, Sq, Skv, spec, ids, kv splits). The short q reads 10 kv tiles
# (600 keys, the last one ragged); its rows sit at the last positions
# (q_offset). "window_sink" sees the sinks in split 0 and nothing in splits
# 1 and 2, which write the merge identity (0, -inf). "packed": the q rows
# take the kv ids of their positions. "packed_prefill": three q tiles
# against three kv tiles, causal, so a split above the diagonal sees
# nothing.
CASES = {
    "causal_offset": (1, 64, 600, dict(causal=True, q_offset=536), None, 2),
    "cross_full": (2, 20, 530, dict(causal=False), None, 3),
    "window_sink": (1, 64, 600, dict(causal=True, window=100, sink=8, q_offset=536), None, 5),
    "packed_offset": (2, 64, 600, dict(causal=True, q_offset=536), "packed", 3),
    "packed_prefill": (1, 150, 150, dict(causal=True), "packed", 2),
}


def _inputs(name, D):
    B, Sq, Skv, spec_kw, ids, _ = CASES[name]
    Hq, Hk = HEADS[D]
    rng = np.random.default_rng(sorted(CASES).index(name) + D)
    q = rng.standard_normal((B, Sq, Hq, D), dtype=np.float32)
    k, v = (rng.standard_normal((B, Skv, Hk, D), dtype=np.float32) for _ in range(2))
    seg = None
    if ids == "packed":  # three documents a row, cut off the tile grid
        kv = np.zeros((B, Skv), np.int32)
        for b in range(B):
            a, c = Skv // 3 + 7 * b + 5, 2 * Skv // 3 + 3
            kv[b, :a], kv[b, a:c], kv[b, c:] = 1, 2, 3 + b
        seg = (kv[:, Skv - Sq:].copy(), kv)
    return q * np.float32(1.0 / math.sqrt(D)), k, v, seg, spec_kw


def _heads(x, S_pad):
    """(B, S, H, D) -> the JAX kernels' (B*H, S_pad, D), zero-padded."""
    B, S, H, Dh = x.shape
    h = x.transpose(0, 2, 1, 3).reshape(B * H, S, Dh)
    return np.pad(h, ((0, 0), (0, S_pad - S), (0, 0)))


@functools.partial(jax.jit, static_argnames=("spec", "group", "kv_valid", "ks"))
def _pallas_split(q, k, v, q_seg, kv_seg, *, spec, group, kv_valid, ks):
    """The Pallas partitioned forward's partials (BH, ks, Sqp, D) / (BH, ks,
    Sqp) on head-major padded inputs, and their fold by the JAX package's
    merge tree; jitted whole (eagerly, every step of the interpreted grid
    and of the fold compiles apart)."""
    if q_seg is not None:
        q_seg, kv_seg = pad_segments(q_seg, kv_seg, q.shape[1], k.shape[1])
    o, lse = jax_fwd.flash_fwd(q, k, v, spec, group=group, block_q=BLOCK, block_kv=BLOCK,
                               kv_valid=kv_valid, q_seg=q_seg, kv_seg=kv_seg, interpret=True,
                               num_q_bands=1, kv_splits=ks)
    return (o, lse, *combine_lse_outputs(jnp.moveaxis(o, 1, 0), jnp.moveaxis(lse, 1, 0)))


@pytest.mark.parametrize("D", [256, 160])
@pytest.mark.parametrize("name", list(CASES))
def test_split_partials_and_fold_at_wide_head_dims_match_pallas(name, D):
    """The per-split (o, lse) partials of the split-KV plain version against
    the Pallas partitioned forward's, and its folded (o, lse) against those
    partials folded by the JAX package; the fold also against the port's
    single pass."""
    qs, k, v, seg, spec_kw = _inputs(name, D)
    ks = CASES[name][-1]
    B, Sq, Skv = qs.shape[0], qs.shape[1], k.shape[1]
    Hq, Hk = HEADS[D]
    spec = MaskSpec(**spec_kw)
    tq, tk, tv = (torch.from_numpy(x) for x in (qs, k, v))
    kw = dict(block_q=BLOCK, block_kv=BLOCK)
    before = fwd_mod.flash_fwd_splitkv_plain.calls
    if seg is None:
        out = fwd_mod.flash_fwd_splitkv(tq, tk, tv, spec, kv_splits=ks, **kw)
        o1, lse1 = fwd_mod.flash_fwd(tq, tk, tv, spec, **kw)
    else:
        ids = [torch.from_numpy(x) for x in seg]
        out = fwd_mod.flash_fwd_splitkv_varlen(tq, tk, tv, spec, *ids, kv_splits=ks, **kw)
        o1, lse1 = fwd_mod.flash_fwd_varlen(tq, tk, tv, spec, *ids, **kw)
    assert fwd_mod.flash_fwd_splitkv_plain.calls == before + 1

    Sqp, Skp = -(-Sq // BLOCK) * BLOCK, -(-Skv // BLOCK) * BLOCK
    o_j, lse_j, fo, flse = (np.asarray(x) for x in _pallas_split(
        _heads(qs, Sqp), _heads(k, Skp), _heads(v, Skp), *(seg or (None, None)),
        spec=JaxMaskSpec(**spec_kw), group=Hq // Hk, kv_valid=Skv, ks=ks))
    o_j, lse_j = o_j[:, :, :Sq], lse_j[:, :, :Sq]
    n = fwd_mod.split_count(Skv, BLOCK, ks)
    assert out.o_parts.shape == (B, Hq, n, Sq, D) and out.lse_parts.shape == (B, Hq, n, Sq)
    parts = out.o_parts.reshape(B * Hq, n, Sq, D).numpy()
    lse_parts = out.lse_parts.reshape(B * Hq, n, Sq).numpy()
    np.testing.assert_array_equal(np.isneginf(lse_parts), np.isneginf(lse_j))
    np.testing.assert_allclose(parts, o_j, **TOL)
    np.testing.assert_allclose(lse_parts, lse_j, **TOL)
    if name == "window_sink":  # splits with no visible tile: (0, -inf)
        assert np.isneginf(lse_parts[:, 1:3]).all() and (parts[:, 1:3] == 0).all()
        assert np.isfinite(lse_parts[:, 0]).all()

    fo = fo[:, :Sq].reshape(B, Hq, Sq, D).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(out.o.numpy(), fo, **TOL)
    np.testing.assert_allclose(out.lse.numpy(), flse[:, :Sq].reshape(B, Hq, Sq), **TOL)
    np.testing.assert_allclose(out.o.numpy(), o1.numpy(), **TOL)
    np.testing.assert_allclose(out.lse.numpy(), lse1.numpy(), **TOL)


# (B, Sq, Hq, Skv, Hkv, D) in the short-q/long-kv corner: gemma3-1b's and
# stablelm-12b's widths against the key counts the card runs.
CORNER = [(1, 64, 4, Skv, 1, 256) for Skv in (1536, 8192, 32768)] + \
         [(1, 64, 32, Skv, 8, 160) for Skv in (1536, 4096, 32768)] + [(2, 10, 8, 700, 2, 160)]


@pytest.mark.parametrize("B,Sq,Hq,Skv,Hkv,D", CORNER)
def test_auto_kv_splits_follow_the_policy_at_wide_head_dims(B, Sq, Hq, Skv, Hkv, D):
    """``resolve_kv_splits(None, ...)`` at 256 and 160 is the policy of
    ``default_kv_splits``, as at 64 and 128: gemma3's 4 q heads take
    min(t_kv, 33) splits, stablelm's 32 take 4."""
    t_kv = -(-Skv // ops.BLOCK_KV)
    want = ops.default_kv_splits(B * Hq, 1, t_kv)
    assert want == min(t_kv, 132 // (B * Hq)) > 1
    assert ops.resolve_kv_splits(None, (B, Sq, Hq, D), (B, Skv, Hkv, D)) == want


# ---------------------------------------------------------------------------
# Reduced gemma3-1b at 256 and stablelm-12b at 160 on a packed batch
# ---------------------------------------------------------------------------

B, S = 1, 128  # two 64-row tiles: with kv_splits=2 each split one kv tile
MODELS = {"gemma3_256": lambda reg: dataclasses.replace(_gemma3_256(reg), num_layers=2),
          "stablelm_160": _stablelm_160}


@pytest.mark.parametrize("name", list(MODELS))
def test_packed_split_forward_loss_and_gradients_match_jax(name, jax_trace_state):
    """One packed loss and its gradients with ``kv_splits=2`` (the fused
    backward, both packages' default): the JAX side through ``loss_fn`` on
    the Pallas kernels (the partitioned forward at the port's 64-row
    tiles), the port through the split-KV plain version at 256 or 160."""
    jcfg, cfg = MODELS[name](jax_registry), MODELS[name](registry)
    assert cfg.head_dim == {"gemma3_256": 256, "stablelm_160": 160}[name] and cfg.num_layers == 2
    jparams = jax_lm.init_lm(jcfg, jax.random.PRNGKey(5))
    batch = JaxSyntheticVarlenLM(JaxDataConfig(batch_size=B, seq_len=S, vocab_size=cfg.vocab_size,
                                               seed=0, source="packed", min_doc_len=8)).batch(1)
    assert batch["segment_ids"].max() > 2
    jattn = JaxAttentionConfig(impl="flash_pallas", interpret=True, use_tuned=False, kv_splits=2,
                               block_q=BLOCK, block_kv=BLOCK)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: jax_steps.loss_fn(jcfg, jattn, p, b), has_aux=True))
    (jloss, jm), jgrads = grad_fn(jparams, {k: jnp.asarray(v) for k, v in batch.items()})

    model = LM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jparams)))
    plain = (fwd_mod.flash_fwd_splitkv_plain, fwd_mod.flash_fwd_plain)
    before = [f.calls for f in plain]
    loss, metrics = steps.loss_fn(cfg, AttentionConfig(kv_splits=2), model,
                                  {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    calls = [f.calls - b for f, b in zip(plain, before)]
    assert calls[0] > 0 and calls[1] == 0  # every layer's forward split
    np.testing.assert_allclose(loss.item(), float(jloss), **LOSS_TOL)
    for key in ("ce_loss", "nll_sum", "tokens", "accuracy"):
        np.testing.assert_allclose(metrics[key].item(), float(jm[key]), err_msg=key, **LOSS_TOL)
    want = params_from_jax(cfg, jax.tree.map(np.asarray, jgrads))
    got = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    for pname, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[pname].numpy(), err_msg=pname, **GRAD_TOL)
