"""The blocked path as a whole: a reduced qwen3-8b (two kv heads, so G = 2)
trained and served through ``impl="flash_torch"`` against the JAX package
through ``impl="flash_xla"``, on the same weights (``init_lm`` -> numpy ->
``params_from_jax``) and batches: loss and gradients (unpacked and packed,
64 x 64 tiles), three AdamW steps, the greedy tokens of both engines (the
default 512 tiles, 8 decode splits), and both CLIs with ``--attn
flash_torch`` on the CPU."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.core.attention import AttentionConfig as JaxAttentionConfig
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.data.pipeline import SyntheticVarlenLM as JaxSyntheticVarlenLM
from repro.launch import steps as jax_steps
from repro.models import lm as jax_lm
from repro.serving.engine import PagedServingEngine as JaxPagedServingEngine
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro.training import optimizer as jax_opt
from repro_torch.configs import registry
from repro_torch.core.attention import AttentionConfig
from repro_torch.kernels import flash_bwd, flash_decode, flash_fwd
from repro_torch.launch import steps
from repro_torch.models.lm import LM, params_from_jax
from repro_torch.serving.engine import PagedServingEngine, Request, ServingEngine
from repro_torch.training import optimizer
from test_torch_serving import jax_trace_state  # noqa: F401  (the per-test JAX shim)

ROOT = Path(__file__).resolve().parents[1]
# f32 whole-model sums in different orders (XLA against PyTorch).
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
PARAM_TOL = dict(atol=1e-4, rtol=1e-4)  # as tests/test_torch_train.py: 1% of lr
B, S = 2, 128
JAX_TRAIN = JaxAttentionConfig(impl="flash_xla", block_q=64, block_kv=64, use_tuned=False)
TRAIN = AttentionConfig(impl="flash_torch", block_q=64, block_kv=64)
JAX_SERVE = JaxAttentionConfig(impl="flash_xla", decode_splits=8, use_tuned=False)
SERVE = AttentionConfig(impl="flash_torch")
PROMPTS = [[5, 7, 9], list(range(1, 10)), list(range(3, 20)), [11, 2, 8, 4, 1], list(range(40, 70))]


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jax_registry.reduce_config(jax_registry.get("qwen3-8b")),
                               num_kv_heads=2)
    cfg = dataclasses.replace(registry.reduce_config(registry.get("qwen3-8b")), num_kv_heads=2)
    jparams = jax_lm.init_lm(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, cfg


def _port_model(cfg, jparams):
    model = LM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jparams)))
    return model


@pytest.fixture
def no_kernels():
    """Fails the test if any kernel wrapper or plain version ran: the blocked
    path never reaches them."""
    plains = (flash_fwd.flash_fwd_plain, flash_fwd.flash_fwd_splitkv_plain,
              flash_decode.flash_decode_plain, flash_decode.flash_decode_paged_plain,
              flash_bwd.flash_bwd_delta_plain, flash_bwd.flash_bwd_fused_plain,
              flash_bwd.flash_bwd_dkv_plain, flash_bwd.flash_bwd_dq_plain)
    before = [f.calls for f in plains]
    yield
    assert [f.calls for f in plains] == before


def _batch(cfg, packed: bool):
    data = JaxDataConfig(batch_size=B, seq_len=S, vocab_size=cfg.vocab_size,
                         source="packed" if packed else "synthetic")
    if packed:
        return JaxSyntheticVarlenLM(data).batch(1)
    inputs, targets = JaxSyntheticLM(data).batch(0)
    return {"inputs": inputs, "targets": targets}


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
def test_loss_and_gradients_match_jax(models, jax_trace_state, no_kernels, packed):
    jcfg, jparams, cfg = models
    batch = _batch(cfg, packed)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: jax_steps.loss_fn(jcfg, JAX_TRAIN, p, b), has_aux=True))
    (jloss, jm), jgrads = grad_fn(jparams, {k: jnp.asarray(v) for k, v in batch.items()})

    model = _port_model(cfg, jparams)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tbatch["inputs"] = tbatch["inputs"].long()
    loss, metrics = steps.loss_fn(cfg, TRAIN, model, tbatch)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **LOSS_TOL)
    for key in ("ce_loss", "nll_sum", "tokens", "accuracy"):
        np.testing.assert_allclose(metrics[key].item(), float(jm[key]), err_msg=key, **LOSS_TOL)
    want = params_from_jax(cfg, jax.tree.map(np.asarray, jgrads))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), err_msg=name, **GRAD_TOL)


def test_three_train_steps_match_jax(models, jax_trace_state, no_kernels):
    jcfg, jparams, cfg = models
    opt_cfg = dict(warmup_steps=2, total_steps=3, lr=1e-2)
    jstep = jax.jit(jax_steps.build_train_step(jcfg, JAX_TRAIN, jax_opt.AdamWConfig(**opt_cfg)))
    jstate = jax_opt.init_opt_state(jparams)
    model = _port_model(cfg, jparams)
    state = optimizer.init_opt_state(dict(model.named_parameters()))
    step_fn = steps.build_train_step(cfg, TRAIN, optimizer.AdamWConfig(**opt_cfg))
    data = JaxSyntheticLM(JaxDataConfig(batch_size=B, seq_len=S, vocab_size=cfg.vocab_size))
    jp, want, got = jparams, [], []
    for step in range(3):
        inputs, targets = data.batch(step)
        jp, jstate, jm = jstep(jp, jstate, {"inputs": jnp.asarray(inputs),
                                            "targets": jnp.asarray(targets)})
        want.append([float(jm[k]) for k in ("loss", "grad_norm", "lr")])
        state, m = step_fn(model, state, {"inputs": torch.from_numpy(inputs).long(),
                                          "targets": torch.from_numpy(targets)})
        got.append([m[k] for k in ("loss", "grad_norm", "lr")])
    np.testing.assert_allclose(np.array(got), np.array(want), **LOSS_TOL)
    final = params_from_jax(cfg, jax.tree.map(np.asarray, jp))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), final[name].numpy(), err_msg=name,
                                   **PARAM_TOL)


@pytest.mark.parametrize("engine", ["fixed", "paged"])
def test_engine_tokens_match_jax(models, jax_trace_state, no_kernels, engine):
    """More requests than slots, bucketed admission (the paged engine with a
    pool small enough to preempt): every greedy token stream is the JAX
    engine's under flash_xla."""
    jcfg, jparams, cfg = models
    model = _port_model(cfg, jparams)
    if engine == "fixed":
        prompts, max_new = PROMPTS, 6
        kw = dict(max_batch=2, cache_size=64, prompt_pad=16)
        jeng = JaxServingEngine(jcfg, jparams, JAX_SERVE, **kw)
        eng = ServingEngine(cfg, model, SERVE, **kw)
    else:  # four requests that grow to 8 pages each in a pool of 13
        prompts, max_new = [list(range(1 + i, 7 + i)) for i in range(4)], 24
        kw = dict(max_batch=4, num_pages=14, page_size=4, pages_per_seq_max=8, prompt_pad=16)
        jeng = JaxPagedServingEngine(jcfg, jparams, JAX_SERVE, **kw)
        eng = PagedServingEngine(cfg, model, SERVE, **kw)
    for rid, prompt in enumerate(prompts):
        jeng.submit(JaxRequest(rid=rid, prompt=list(prompt), max_new_tokens=max_new))
        eng.submit(Request(rid=rid, prompt=list(prompt), max_new_tokens=max_new))
    want = jeng.run(max_ticks=200)
    got = eng.run(max_ticks=200)
    assert sorted(got) == sorted(want) == list(range(len(prompts)))
    for rid in want:
        assert got[rid].generated == want[rid].generated, rid
    assert eng.ticks == jeng.ticks
    if engine == "paged":
        assert eng.preemptions == jeng.preemptions > 0


@pytest.mark.parametrize("cli,args", [
    ("train", ["--arch", "qwen3-8b", "--reduce", "--steps", "2", "--seq", "64", "--batch", "2"]),
    ("serve", ["--arch", "qwen3-8b", "--reduce", "--requests", "3", "--max-new", "4"]),
], ids=["train", "serve"])
def test_cli_runs_flash_torch(cli, args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", f"repro_torch.launch.{cli}", *args, "--device", "cpu",
         "--attn", "flash_torch"], env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    if cli == "train":
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        assert np.isfinite(out["first5_loss"]) and "attn=flash_torch" in proc.stdout
    else:
        summary = json.loads(proc.stdout.strip().splitlines()[0])
        assert summary["attn"] == "flash_torch" and summary["requests"] == 3
