"""The head_dim-160 backward (stablelm-12b's training) on the port against
the JAX package on the CPU: the delta, fused, dK/dV and dQ kernels' plain
versions (which the CUDA kernels are held to on the card) against the
Pallas kernels in interpret mode on the same numpy inputs, then reduced
stablelm-12b with its head_dim put back to 160 (2 layers, qk-norm, untied
embeddings, four q heads over one kv head) against the JAX
``build_train_step`` on its Pallas kernels (fused and split): one loss with
its gradients, and three AdamW steps."""

import dataclasses

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


def test_segment_and_dense_modes_refuse_head_dim_160_before_the_launch(monkeypatch):
    """At 160 the backward wrappers take the compact and the dense kernels,
    without and with segments: the dense mode (alone or with segments)
    passes every check before the launch and builds the C entry's arguments
    with no table (the check needs no card: it reads only shapes and the
    mode; the stream is stubbed), while the forward's split-KV mode, which
    has no kernel at 160, still raises before anything is launched, naming
    the roadmap."""
    monkeypatch.setattr(bwd_mod, "_stream", lambda t: 0)
    q = torch.empty((1, 64, 4, D), dtype=torch.bfloat16, device="meta")
    k = torch.empty((1, 64, 1, D), dtype=torch.bfloat16, device="meta")
    lse = torch.empty((1, 4, 64), dtype=torch.float32, device="meta")
    ids = torch.empty((1, 64), dtype=torch.int32, device="meta")
    spec = MaskSpec(causal=True)
    for segments in (None, (ids, ids)):
        for q_major, kernel in ((False, "the CUDA dK/dV kernel"), (True, "the CUDA dQ kernel")):
            args, _ = bwd_mod._kernel_args(kernel, q, k, k, q, lse, lse, spec, 64, 64, segments,
                                           q_major=q_major, schedule="dense")
            assert args[6] is None  # no table under the dense schedule
    for modes in (["dense"], ["segment", "dense"]):
        bwd_mod.check_mode_head_dim("the CUDA dK/dV kernel", D, modes, bwd_mod.MODE_HEAD_DIMS)
        fwd_mod.check_mode_head_dim("the CUDA forward", D, modes)
    with pytest.raises(ValueError, match=f"the CUDA forward's split-KV mode takes head_dim in "
                                         f"\\(64, 128\\), got {D} .*queue 2, item 2"):
        fwd_mod.check_mode_head_dim("the CUDA forward", D, ["split-KV"])
    assert D in bwd_mod.SEGMENT_HEAD_DIMS and D in bwd_mod.DENSE_HEAD_DIMS
    assert D in fwd_mod.DENSE_HEAD_DIMS and D not in fwd_mod.SPLIT_KV_HEAD_DIMS


# ---------------------------------------------------------------------------
# The auto kv split where no split-KV kernel is built
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("D_", [16, 64, 128, 160, 256])
@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv", [(1, 64, 1536, 32, 8), (1, 1, 2048, 4, 1),
                                              (2, 48, 700, 8, 8)])
def test_auto_kv_splits_are_one_where_no_split_kv_kernel_is_built(B, Sq, Skv, Hq, Hkv, D_):
    """``resolve_kv_splits(None, ...)`` of a short q against a long kv: 1 at
    head dims 160 and 256 (a forward kernel, no split-KV one), the policy
    of ``default_kv_splits`` at every other head dim (16: the CPU tests';
    64 and 128: the card's all-modes head dims). An explicit count is
    kept (clamped to the kv tiles)."""
    t_kv = -(-Skv // ops.BLOCK_KV)
    auto = ops.default_kv_splits(B * Hq, -(-Sq // ops.BLOCK_Q), t_kv)
    assert auto > 1  # each shape is in the corner the policy splits
    want = 1 if D_ in (160, 256) else min(auto, t_kv)
    assert ops.resolve_kv_splits(None, (B, Sq, Hq, D_), (B, Skv, Hkv, D_)) == want
    assert ops.resolve_kv_splits(3, (B, Sq, Hq, D_), (B, Skv, Hkv, D_)) == 3


@pytest.mark.parametrize("D_", [160, 256])
def test_default_flash_attention_at_head_dims_160_and_256_takes_one_split(D_):
    """The CPU path of a default ``ops.flash_attention`` at 160 and 256 is
    the single-pass plain forward, bitwise the explicit ``kv_splits=1``
    call, so the CPU computes what the card does."""
    rng = np.random.default_rng(D_)
    q = torch.from_numpy(rng.standard_normal((1, 16, 4, D_), dtype=np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, 300, 1, D_), dtype=np.float32))
            for _ in range(2))
    spec = MaskSpec(causal=True, q_offset=300 - 16)
    before = fwd_mod.flash_fwd_plain.calls
    o = ops.flash_attention(q, k, v, spec)
    assert fwd_mod.flash_fwd_plain.calls == before + 1
    assert torch.equal(o, ops.flash_attention(q, k, v, spec, kv_splits=1))
