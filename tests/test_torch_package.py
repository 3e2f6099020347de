"""Boundaries of the port: ``repro_torch`` and ``chip_smoke.py`` never import
JAX or the JAX package, and a request for the card never falls back."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import registry
from repro_torch.core.attention import AttentionConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import flash_decode as dec_mod
from repro_torch.kernels import flash_fwd as fwd_mod
from repro_torch.core.masks import MaskSpec
from repro_torch.models.lm import LM, check_supported, init_lm
from repro_torch.models.moe import MoE

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_imports(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "repro")]
    assert not bad, f"{path.name} imports {bad}"


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "[importlib.import_module(m) for m in mods]\n"
        "assert len(mods) > 15, mods\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = registry.reduce_config(registry.get("qwen3-8b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LM(cfg)  # the default device is the card


def test_wrappers_take_cpu_or_cuda_only():
    q = torch.zeros((1, 4, 2, 16), device="meta")
    with pytest.raises(ValueError, match="cuda"):
        fwd_mod.flash_fwd(q, q, q, MaskSpec(causal=True), block_q=64, block_kv=64)
    qd = torch.zeros((2, 1, 16), device="meta")
    lens = torch.zeros((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda"):
        dec_mod.flash_decode(qd, q, q, lens)
    pages = torch.zeros((2, 5, 8, 16), device="meta")
    table = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda"):
        dec_mod.flash_decode_paged(qd, pages, pages, lens, table)


@pytest.mark.parametrize("name", ["falcon-mamba-7b", "whisper-base", "hymba-1.5b"])
def test_unported_families_raise(name):
    with pytest.raises(NotImplementedError):
        check_supported(registry.reduce_config(registry.get(name)))


@pytest.mark.parametrize("name", ["granite-moe-1b-a400m", "mixtral-8x22b"])
def test_moe_families_build_on_the_cpu(name):
    """The MoE archs build as decoder-only LMs (the MoE layer in place of the
    MLP), and a reduced one runs a prefill and a decode step on the CPU."""
    cfg = registry.reduce_config(registry.get(name))
    check_supported(registry.get(name))
    model = init_lm(cfg, seed=0, device="cpu")
    assert all(isinstance(layer.mlp, MoE) for layer in model.layers)
    attn = AttentionConfig(impl="flash_cuda")
    tokens = torch.arange(1, 9)[None]
    h, caches, lens = model.prefill(tokens, attn, 16)
    logits, _ = model.decode_step(torch.tensor([[3]]), caches, lens, attn)
    assert logits.shape == (1, 1, cfg.padded_vocab) and torch.isfinite(logits).all()


def test_registry_mirrors_the_jax_one():
    from repro.configs import registry as jax_registry

    assert registry.names() == jax_registry.names()
    for name in registry.names():
        ours = registry.reduce_config(registry.get(name))
        theirs = jax_registry.reduce_config(jax_registry.get(name))
        assert repr(ours) == repr(theirs)


@pytest.mark.parametrize("name", ["flash_fwd", "flash_bwd"])
def test_library_path_hashes_the_shared_headers(tmp_path, monkeypatch, name):
    """A kernel library's cache key covers the Hopper header both sources
    include: changing its bytes (in a copy of csrc) names another library,
    so an edited header never reuses a stale build. Needs no nvcc."""
    import shutil

    from repro_torch.kernels import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build.library_path(name)
    assert before == _build.library_path(name)
    header = csrc / "sm90.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = _build.library_path(name)
    assert after != before and after.parent == before.parent
    assert after.name.startswith(f"lib{name}-")
