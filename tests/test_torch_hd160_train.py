"""The head_dim-160 backward (stablelm-12b's training) on the port against
the JAX package on the CPU: the delta, fused, dK/dV and dQ kernels' plain
versions (which the CUDA kernels are held to on the card) against the
Pallas kernels in interpret mode on the same numpy inputs, then reduced
stablelm-12b with its head_dim put back to 160 (2 layers, qk-norm, untied
embeddings, four q heads over one kv head) against the JAX
``build_train_step`` on its Pallas kernels (fused and split): one loss with
its gradients, and three AdamW steps."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.core.attention import AttentionConfig as JaxAttentionConfig
from repro.core.masks import MaskSpec as JaxMaskSpec
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.kernels import flash_bwd as jax_bwd
from repro.launch import steps as jax_steps
from repro.models import lm as jax_lm
from repro.training import optimizer as jax_opt
from repro_torch.configs import registry
from repro_torch.core.attention import AttentionConfig
from repro_torch.core.masks import MaskSpec
from repro_torch.kernels import flash_bwd as bwd_mod
from repro_torch.kernels import flash_fwd as fwd_mod
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.models.lm import LM, params_from_jax
from repro_torch.training import optimizer
from test_torch_hd160 import _stablelm_160
from test_torch_serving import jax_trace_state  # noqa: F401  (the per-test JAX shim)
from test_torch_train import GRAD_TOL, LOSS_TOL, PACKED_MOVE_TOL

D = 160
TOL = dict(atol=2e-5, rtol=2e-5)  # f32 on both sides: summation order and tiling only
BLOCK = 32

# name: (B, S, Hq, Hkv, spec): stablelm's grouping (G 4, here over one kv
# head), causal at a length of whole tiles and at a ragged one (100, 130:
# no block divides them), a window with sinks, and G 1 without a mask.
CASES = {
    "causal_g4": (1, 96, 4, 1, dict(causal=True)),
    "causal_g4_ragged": (2, 100, 4, 1, dict(causal=True)),
    "window_sink_g4_ragged": (1, 130, 4, 1, dict(causal=True, window=40, sink=8)),
    "full_g1": (1, 64, 2, 2, dict(causal=False)),
}
KERNELS = ("delta", "fused", "dkv", "dq")


def _heads(x, rows):
    """(B, S, H, D) numpy -> the JAX kernels' (B*H, rows, D), zero-padded."""
    B, S, H, _ = x.shape
    return np.pad(x.transpose(0, 2, 1, 3).reshape(B * H, S, D), ((0, 0), (0, rows - S), (0, 0)))


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("name", list(CASES))
def test_backward_kernel_at_head_dim_160_matches_pallas(name, kernel):
    """The port's wrapper on CPU tensors (its plain version) against the
    Pallas kernel in interpret mode on the heads layout, from the same
    pre-scaled q, forward outputs, lse and delta. dO is scaled by 1/sqrt(D)
    as q is, as in tests/test_torch_hd256_train.py (which says why)."""
    B, S, Hq, Hk, spec_kw = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    scale = 1 / np.sqrt(D, dtype=np.float32)
    q = rng.standard_normal((B, S, Hq, D), dtype=np.float32) * scale
    k, v = (rng.standard_normal((B, S, Hk, D), dtype=np.float32) for _ in range(2))
    do = rng.standard_normal((B, S, Hq, D), dtype=np.float32) * scale
    spec, jspec = MaskSpec(**spec_kw), JaxMaskSpec(**spec_kw)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = fwd_mod.flash_fwd(tq, tk, tv, spec, block_q=BLOCK, block_kv=BLOCK)
    delta = bwd_mod.flash_bwd_delta(o, tdo)
    args = (tq, tk, tv, tdo, lse, delta, spec)
    tiles = dict(block_q=BLOCK, block_kv=BLOCK)
    Sp = -(-S // BLOCK) * BLOCK
    unheads = lambda x, H: np.asarray(x)[:, :S].reshape(B, H, S, D).transpose(0, 2, 1, 3)
    lanes = lambda x: np.pad(x.reshape(B * Hq, S).numpy(), ((0, 0), (0, Sp - S)))
    kw = dict(group=Hq // Hk, block_q=BLOCK, block_kv=BLOCK, kv_valid=S, interpret=True)
    if kernel == "delta":
        want = jax_bwd.flash_bwd_delta(_heads(o.numpy(), Sp), _heads(do, Sp), block_q=BLOCK,
                                       interpret=True)
        assert delta.shape == (B, Hq, S)
        np.testing.assert_allclose(delta.numpy(), np.asarray(want)[:, :S].reshape(B, Hq, S),
                                   **TOL)
        return
    if kernel == "fused":
        got = dict(zip(("dq", "dk", "dv"), bwd_mod.flash_bwd_fused(*args, **tiles)))
        # The fused Pallas kernel takes the raw lse and computes delta itself.
        jdk, jdv, jdq = jax_bwd.flash_bwd_fused(
            _heads(q, Sp), _heads(k, Sp), _heads(v, Sp), _heads(o.numpy(), Sp), _heads(do, Sp),
            lanes(lse), jspec, **kw)
        want = dict(dq=jdq, dk=jdk, dv=jdv)
    else:
        # The split Pallas kernels take lse with fully masked rows zeroed and
        # delta, as the JAX wrapper hands them over (ops._core_bwd).
        lse_s = torch.where(torch.isneginf(lse), torch.zeros_like(lse), lse)
        jargs = (_heads(q, Sp), _heads(k, Sp), _heads(v, Sp), _heads(do, Sp), lanes(lse_s),
                 lanes(delta))
        if kernel == "dkv":
            got = dict(zip(("dk", "dv"), bwd_mod.flash_bwd_dkv(*args, **tiles)))
            want = dict(zip(("dk", "dv"), jax_bwd.flash_bwd_dkv(*jargs, jspec, **kw)))
        else:
            got = dict(dq=bwd_mod.flash_bwd_dq(*args, **tiles))
            want = dict(dq=jax_bwd.flash_bwd_dq(*jargs, jspec, **kw))
    for g, a in got.items():
        b = unheads(want[g], Hq if g == "dq" else Hk)
        assert a.dtype == torch.float32 and a.shape == b.shape, g
        np.testing.assert_allclose(a.numpy(), b, err_msg=g, **TOL)


# ---------------------------------------------------------------------------
# stablelm-12b at head_dim 160, reduced otherwise: the training step
# ---------------------------------------------------------------------------

B, S = 2, 64
JAX_ATTN = JaxAttentionConfig(impl="flash_pallas", interpret=True, use_tuned=False)


@pytest.fixture(scope="module")
def stablelm():
    jcfg = _stablelm_160(jax_registry)
    cfg = _stablelm_160(registry)
    assert (cfg.head_dim, cfg.num_heads, cfg.num_kv_heads, cfg.num_layers) == (160, 4, 1, 2)
    assert cfg.remat and cfg.dtype == "float32" and not cfg.tie_embeddings and cfg.qk_norm
    return jcfg, jax_lm.init_lm(jcfg, jax.random.PRNGKey(5)), cfg


def _port_model(cfg, jparams):
    model = LM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jparams)))
    return model


def _batch(cfg, step):
    return JaxSyntheticLM(JaxDataConfig(batch_size=B, seq_len=S, vocab_size=cfg.vocab_size,
                                        seed=0)).batch(step)


@pytest.mark.parametrize("bwd", ["fused", "split"])
def test_stablelm_loss_and_gradients_at_head_dim_160_match_jax(stablelm, jax_trace_state, bwd):
    """One loss and its gradients, the JAX side through the Pallas backward
    of the same mode as the port's."""
    jcfg, jparams, cfg = stablelm
    inputs, targets = _batch(cfg, 0)
    jattn = dataclasses.replace(JAX_ATTN, bwd=bwd)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: jax_steps.loss_fn(jcfg, jattn, p, b), has_aux=True))
    (jloss, _), jgrads = grad_fn(jparams, {"inputs": jnp.asarray(inputs),
                                           "targets": jnp.asarray(targets)})

    model = _port_model(cfg, jparams)
    batch = {"inputs": torch.from_numpy(inputs).long(), "targets": torch.from_numpy(targets)}
    loss, _ = steps.loss_fn(cfg, AttentionConfig(impl="flash_cuda", bwd=bwd), model, batch)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **LOSS_TOL)
    want = params_from_jax(cfg, jax.tree.map(np.asarray, jgrads))
    got = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), err_msg=name, **GRAD_TOL)


def test_stablelm_three_train_steps_at_head_dim_160_match_jax(stablelm, jax_trace_state):
    """Three AdamW steps through the split backward on both sides (the
    fused one is held above): losses, gradient norms and learning rates
    every step, and the parameters after the third."""
    jcfg, jparams, cfg = stablelm
    opt_cfg = dict(warmup_steps=2, total_steps=3, lr=1e-2)
    jattn = dataclasses.replace(JAX_ATTN, bwd="split")
    jstep = jax.jit(jax_steps.build_train_step(jcfg, jattn, jax_opt.AdamWConfig(**opt_cfg)))
    jstate = jax_opt.init_opt_state(jparams)
    model = _port_model(cfg, jparams)
    state = optimizer.init_opt_state(dict(model.named_parameters()))
    step_fn = steps.build_train_step(cfg, AttentionConfig(impl="flash_cuda", bwd="split"),
                                     optimizer.AdamWConfig(**opt_cfg))
    jp, want, got = jparams, [], []
    for step in range(3):
        inputs, targets = _batch(cfg, step)
        jp, jstate, jm = jstep(jp, jstate, {"inputs": jnp.asarray(inputs),
                                            "targets": jnp.asarray(targets)})
        want.append([float(jm[k]) for k in ("loss", "grad_norm", "lr")])
        state, m = step_fn(model, state, {"inputs": torch.from_numpy(inputs).long(),
                                          "targets": torch.from_numpy(targets)})
        got.append([m[k] for k in ("loss", "grad_norm", "lr")])
    np.testing.assert_allclose(np.array(got), np.array(want), **LOSS_TOL)
    assert got[2][0] < got[0][0]
    # Each parameter tensor as a whole (tests/test_torch_train.py says why).
    final = params_from_jax(cfg, jax.tree.map(np.asarray, jp))
    start = params_from_jax(cfg, jax.tree.map(np.asarray, jparams))
    for name, p in model.named_parameters():
        moved = np.linalg.norm(final[name].numpy() - start[name].numpy())
        apart = np.linalg.norm(p.detach().numpy() - final[name].numpy())
        assert moved > 0 and apart <= PACKED_MOVE_TOL * moved, (name, apart, moved)


def test_every_mode_passes_the_launch_checks_at_head_dim_160_and_only_96_is_refused(monkeypatch):
    """Every mode of the kernels is built at 160: the backward wrappers'
    checks before the launch pass on the compact and the dense schedule,
    without and with segments, and build the C entry's arguments (with no
    table under the dense schedule), and the forward's input check passes
    (the checks need no card: they read only shapes and the mode; the
    stream is stubbed). The refusal before the launch is the one head-dim
    check of ``_check_kernel_inputs``, left to a head dim with no kernel
    (96), in every mode."""
    monkeypatch.setattr(bwd_mod, "_stream", lambda t: 0)
    spec = MaskSpec(causal=True)
    ids = torch.empty((1, 64), dtype=torch.int32, device="meta")
    lse = torch.empty((1, 4, 64), dtype=torch.float32, device="meta")
    for D_ in (D, 96):
        q = torch.empty((1, 64, 4, D_), dtype=torch.bfloat16, device="meta")
        k = torch.empty((1, 64, 1, D_), dtype=torch.bfloat16, device="meta")
        calls = [functools.partial(fwd_mod._check_kernel_inputs, "the CUDA forward", (64, 64),
                                   q=q, k=k, v=k)]
        for segments in (None, (ids, ids)):
            for schedule in ("compact", "dense"):
                for q_major, kernel in ((False, "the CUDA dK/dV kernel"),
                                        (True, "the CUDA dQ kernel")):
                    calls.append(functools.partial(
                        bwd_mod._kernel_args, kernel, q, k, k, q, lse, lse, spec, 64, 64,
                        segments, q_major=q_major, schedule=schedule))
        for call, schedule in zip(calls, [None] + ["compact", "compact", "dense", "dense"] * 2):
            if D_ == D:
                out = call()
                if schedule == "dense":
                    assert out[0][6] is None  # no table under the dense schedule
            else:
                with pytest.raises(ValueError,
                                   match=r"supports head_dim in \(64, 128, 160, 256\), got 96"):
                    call()
    assert D in bwd_mod.KERNEL_HEAD_DIMS and D in fwd_mod.KERNEL_HEAD_DIMS


# ---------------------------------------------------------------------------
# The auto kv split at every head dim
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("D_", [16, 64, 128, 160, 256])
@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv", [(1, 64, 1536, 32, 8), (1, 1, 2048, 4, 1),
                                              (2, 48, 700, 8, 8)])
def test_auto_kv_splits_follow_default_kv_splits_at_every_head_dim(B, Sq, Skv, Hq, Hkv, D_):
    """``resolve_kv_splits(None, ...)`` of a short q against a long kv is
    the policy of ``default_kv_splits`` at every head dim (16: the CPU
    tests'; 64, 128, 160 and 256: the card's, where the split-KV kernel is
    built since its instantiations at 160 and 256, so no head dim is pinned
    to one split any more). An explicit count is kept (clamped to the kv
    tiles)."""
    t_kv = -(-Skv // ops.BLOCK_KV)
    auto = ops.default_kv_splits(B * Hq, -(-Sq // ops.BLOCK_Q), t_kv)
    assert auto > 1  # each shape is in the corner the policy splits
    assert ops.resolve_kv_splits(None, (B, Sq, Hq, D_), (B, Skv, Hkv, D_)) == min(auto, t_kv)
    assert ops.resolve_kv_splits(3, (B, Sq, Hq, D_), (B, Skv, Hkv, D_)) == 3


@pytest.mark.parametrize("D_", [160, 256])
def test_default_flash_attention_at_head_dims_160_and_256_takes_the_auto_split(D_):
    """The CPU path of a default ``ops.flash_attention`` of a short q
    against 5 kv tiles at 160 and 256 takes the auto split (5, one kv tile
    a split) through the split-KV plain version, as the card takes the
    split-KV kernel: bitwise the explicit ``kv_splits=5`` call and within
    2e-5 of the single pass (``kv_splits=1``), which now differs from it
    only in summation order."""
    rng = np.random.default_rng(D_)
    q = torch.from_numpy(rng.standard_normal((1, 16, 4, D_), dtype=np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, 300, 1, D_), dtype=np.float32))
            for _ in range(2))
    spec = MaskSpec(causal=True, q_offset=300 - 16)
    assert ops.resolve_kv_splits(None, q.shape, k.shape) == 5
    before = (fwd_mod.flash_fwd_plain.calls, fwd_mod.flash_fwd_splitkv_plain.calls)
    o = ops.flash_attention(q, k, v, spec)
    assert (fwd_mod.flash_fwd_plain.calls, fwd_mod.flash_fwd_splitkv_plain.calls) == (
        before[0], before[1] + 1)
    assert torch.equal(o, ops.flash_attention(q, k, v, spec, kv_splits=5))
    np.testing.assert_allclose(o.numpy(), ops.flash_attention(q, k, v, spec, kv_splits=1).numpy(),
                               **TOL)
