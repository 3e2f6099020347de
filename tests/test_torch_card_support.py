"""What the entry points refuse before anything reaches the card, and the
train CLI's ``--dtype``.

The CUDA kernels take bfloat16 at head_dim 64 and 128, and serve (forward,
decode, paged decode) and train (unpacked) at 160 and 256; the paged
decode has no 64.
``core.attention.check_card_support`` refuses ``flash_cuda`` on a CUDA
device for anything else, and the train and serve CLIs call it before they
build a model: on this machine, which has no card, the CLIs must therefore
fail with that refusal (a ValueError naming the way out), never with the
missing card (``resolve_device``'s RuntimeError) or a TypeError from inside
a kernel wrapper; what the kernels take gets past the check and stops at
the missing card. The check takes a device name, so it runs here as it
would on a card."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.core.attention import AttentionConfig, check_card_support
from repro_torch.launch import serve
from repro_torch.launch import train as train_cli

ROOT = Path(__file__).resolve().parents[1]
FLASH, REF = AttentionConfig(impl="flash_cuda"), AttentionConfig(impl="ref")


def _gpt20m(dtype=None):
    return train_cli.resolve_model(None, "gpt-20m", False, dtype)


def test_float32_is_refused_on_the_card_with_the_way_out():
    cfg = _gpt20m()
    assert cfg.dtype == "float32"  # the preset's own dtype, as in the JAX package
    for device in ("cuda", "cuda:0"):
        with pytest.raises(ValueError, match="--dtype bfloat16") as err:
            check_card_support(cfg, FLASH, device, training=True)
        assert "--attn ref" in str(err.value)
    check_card_support(_gpt20m("bfloat16"), FLASH, "cuda", training=True)
    # The plain CPU path and the dense reference take float32.
    check_card_support(cfg, FLASH, "cpu", training=True)
    check_card_support(cfg, REF, "cuda", training=True)


# stablelm-12b's 160: the backward kernels are built there (compact and
# unsegmented), so unpacked training passes through either backward mode;
# the segment kernels are not, so packed training is what the kernels lack
# at 160 and is refused, naming them (the forward and both decodes serve it:
# test_stablelm_at_head_dim_160_serves_on_the_card).
@pytest.mark.parametrize("arch,head_dim,bwd,packed", [
    ("stablelm-12b", 160, "fused", False),
    ("stablelm-12b", 160, "split", False),
    ("stablelm-12b", 160, "fused", True),
    ("stablelm-12b", 160, "split", True),
])
def test_head_dims_the_kernels_lack_are_refused_on_the_card(arch, head_dim, bwd, packed):
    cfg = registry.get(arch)
    assert cfg.head_dim == head_dim and cfg.dtype == "bfloat16"
    flash = AttentionConfig(impl="flash_cuda", bwd=bwd)
    if packed:
        with pytest.raises(ValueError, match=f"head_dim {head_dim}; the CUDA segment \\(packed\\)"
                                             ".*queue 2, item 2.*--attn ref"):
            check_card_support(cfg, flash, "cuda", training=True, packed=packed)
    else:
        check_card_support(cfg, flash, "cuda", training=True, packed=packed)
    check_card_support(cfg, flash, "cpu", training=True, packed=packed)
    check_card_support(cfg, REF, "cuda", training=True, packed=packed)


@pytest.mark.parametrize("bwd", ["fused", "split"])
def test_stablelm_at_head_dim_160_trains_on_the_card(bwd):
    cfg = registry.get("stablelm-12b")
    assert cfg.head_dim == 160 and cfg.dtype == "bfloat16"
    check_card_support(cfg, AttentionConfig(impl="flash_cuda", bwd=bwd), "cuda", training=True)


@pytest.mark.parametrize("paged", [False, True])
def test_stablelm_at_head_dim_160_serves_on_the_card(paged):
    cfg = registry.get("stablelm-12b")
    assert cfg.head_dim == 160 and cfg.dtype == "bfloat16"
    check_card_support(cfg, FLASH, "cuda", training=False, paged=paged)


@pytest.mark.parametrize("paged", [False, True])
def test_gemma3_at_head_dim_256_serves_on_the_card(paged):
    cfg = registry.get("gemma3-1b")
    assert cfg.head_dim == 256 and cfg.dtype == "bfloat16"
    check_card_support(cfg, FLASH, "cuda", training=False, paged=paged)


@pytest.mark.parametrize("bwd", ["fused", "split"])
def test_gemma3_at_head_dim_256_trains_on_the_card(bwd):
    cfg = registry.get("gemma3-1b")
    assert cfg.head_dim == 256 and cfg.dtype == "bfloat16"
    check_card_support(cfg, AttentionConfig(impl="flash_cuda", bwd=bwd), "cuda", training=True)


def test_packed_gemma3_training_is_refused_on_the_card():
    """The segment kernels have no head_dim 256: packed training is refused
    up front, not inside the forward wrapper after the model is built."""
    cfg = registry.get("gemma3-1b")
    with pytest.raises(ValueError, match="head_dim 256.*segment.*queue 2, item 2"):
        check_card_support(cfg, FLASH, "cuda", training=True, packed=True)
    check_card_support(cfg, FLASH, "cpu", training=True, packed=True)
    check_card_support(cfg, REF, "cuda", training=True, packed=True)
    with pytest.raises(ValueError, match="head_dim 256.*segment"):
        train_cli.main(["--arch", "gemma3-1b", "--packed", "--steps", "1"])


@pytest.mark.parametrize("arch", ["qwen3-8b", "whisper-base"])
def test_head_dims_64_and_128_train_and_serve_on_the_card(arch):
    cfg = registry.get(arch)
    check_card_support(cfg, FLASH, "cuda", training=True)
    check_card_support(cfg, FLASH, "cuda", training=False)


def test_paged_decode_at_head_dim_64_is_refused_on_the_card():
    cfg = registry.get("whisper-base")
    with pytest.raises(ValueError, match="queue 2, item 3"):
        check_card_support(cfg, FLASH, "cuda", training=False, paged=True)
    check_card_support(registry.get("qwen3-8b"), FLASH, "cuda", training=False, paged=True)


def test_train_cli_refuses_before_building_the_model():
    """The preset in float32 on the default device (cuda) through the
    default flash_cuda: the refusal, not the missing card. gemma3-1b
    (bfloat16, head_dim 256) passes the check and stops only at the
    missing card, before any weight is made (where a card is present the
    CLI would train on it, so that half is left out there)."""
    with pytest.raises(ValueError, match="--dtype bfloat16"):
        train_cli.main(["--preset", "gpt-20m", "--steps", "1"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_cli.main(["--arch", "gemma3-1b", "--steps", "1"])


def test_serve_cli_refuses_before_building_the_model():
    with pytest.raises(ValueError, match="head_dim 64; the CUDA decode.*queue 2, item 3"):
        serve.main(["--arch", "whisper-base", "--engine", "paged"])
    with pytest.raises(ValueError, match="bfloat16"):
        serve.main(["--arch", "qwen3-8b", "--reduce"])


@pytest.mark.parametrize("engine", ["fixed", "paged"])
def test_serve_cli_takes_stablelm_to_the_card(engine):
    """stablelm-12b (head_dim 160) on the default device through flash_cuda
    passes the check and stops only at the missing card, before any of its
    12 B weights is made."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI would serve on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "stablelm-12b", "--engine", engine])


@pytest.mark.parametrize("engine", ["fixed", "paged"])
def test_serve_cli_takes_gemma3_to_the_card(engine):
    """gemma3-1b on the default device through flash_cuda passes the check
    and stops only at the missing card, before any weight is made."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI would serve on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "gemma3-1b", "--engine", engine])


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_train_cli_dtype(dtype):
    """``--dtype bfloat16 --device cpu`` builds the preset in bf16 and takes
    a step; without ``--dtype`` the preset stays float32."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--preset", "gpt-20m", "--device",
           "cpu", "--steps", "1", "--seq", "64", "--batch", "2"]
    if dtype:
        cmd += ["--dtype", dtype]
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert f"({dtype or 'float32'})" in proc.stdout
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert np.isfinite(out["first5_loss"]) and out["tokens_per_s"] > 0


def test_resolve_model_keeps_the_config_dtype_unless_asked():
    assert _gpt20m().dtype == "float32"
    assert _gpt20m("bfloat16").dtype == "bfloat16"
    reduced = train_cli.resolve_model("qwen3-8b", None, True, "bfloat16")
    assert reduced.dtype == "bfloat16" and reduced.d_model == 64
    assert train_cli.resolve_model("qwen3-8b", None, False).dtype == "bfloat16"
