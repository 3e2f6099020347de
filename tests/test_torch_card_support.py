"""What the entry points refuse before anything reaches the card, and the
train CLI's ``--dtype``.

The CUDA kernels take bfloat16 at head_dim 64 and 128, and serve (forward,
decode, paged decode) and train (unpacked and packed) at 160 and 256;
mixture-of-experts models serve and train on the card under the same rules.
``core.attention.check_card_support`` refuses ``flash_cuda`` on a CUDA
device for anything else, and the train and serve CLIs call it before they
build a model: on this machine, which has no card, the CLIs must therefore
fail with that refusal (a ValueError naming the way out), never with the
missing card (``resolve_device``'s RuntimeError) or a TypeError from inside
a kernel wrapper; what the kernels take gets past the check and stops at
the missing card. The check takes a device name, so it runs here as it
would on a card."""

import dataclasses
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


# stablelm-12b's 160: the backward kernels are built there, and their
# segment variants with the forward's, so unpacked and packed training pass
# through either backward mode; what the kernels lack at 160 is another
# dtype than bfloat16, refused with the way out (the forward and both
# decodes serve it: test_stablelm_at_head_dim_160_serves_on_the_card).
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
    check_card_support(cfg, flash, "cuda", training=True, packed=packed)
    with pytest.raises(ValueError, match="float32, and the CUDA kernels take bfloat16.*--attn ref"):
        check_card_support(dataclasses.replace(cfg, dtype="float32"), flash, "cuda",
                           training=True, packed=packed)
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
    """Packed gemma3-1b training is refused on the card only where the
    kernels lack its dtype (float32), up front, not inside a kernel wrapper
    after the model is built; in bfloat16 the segment kernels at head_dim
    256 take it, and the train CLI with ``--packed`` passes the check and
    stops only at the missing card."""
    cfg = registry.get("gemma3-1b")
    f32 = dataclasses.replace(cfg, dtype="float32")
    with pytest.raises(ValueError, match="float32.*--dtype bfloat16"):
        check_card_support(f32, FLASH, "cuda", training=True, packed=True)
    check_card_support(f32, FLASH, "cpu", training=True, packed=True)
    check_card_support(f32, REF, "cuda", training=True, packed=True)
    check_card_support(cfg, FLASH, "cuda", training=True, packed=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_cli.main(["--arch", "gemma3-1b", "--packed", "--steps", "1"])


@pytest.mark.parametrize("bwd", ["fused", "split"])
@pytest.mark.parametrize("arch,head_dim", [("gemma3-1b", 256), ("stablelm-12b", 160)])
def test_packed_training_is_admitted_on_the_card(arch, head_dim, bwd):
    """The segment variants of the forward and of both backward modes are
    built at 256 and 160: packed training of gemma3-1b and stablelm-12b in
    bfloat16 passes the check on the card."""
    cfg = registry.get(arch)
    assert cfg.head_dim == head_dim and cfg.dtype == "bfloat16"
    check_card_support(cfg, AttentionConfig(impl="flash_cuda", bwd=bwd), "cuda",
                       training=True, packed=True)


@pytest.mark.parametrize("arch", ["qwen3-8b", "whisper-base"])
def test_head_dims_64_and_128_train_and_serve_on_the_card(arch):
    cfg = registry.get(arch)
    check_card_support(cfg, FLASH, "cuda", training=True)
    check_card_support(cfg, FLASH, "cuda", training=False)


def test_paged_decode_at_head_dim_64_is_refused_on_the_card():
    """The paged decode is built at 64 (granite-moe-1b-a400m serves through
    it), so the card check passes whisper-base's 64 too; whisper on the
    paged engine is still refused, as an encoder-decoder model that the
    decoder-only LM (and so either engine) does not build, as in the JAX
    package, whose engines serve decoder-only families only."""
    cfg = registry.get("whisper-base")
    check_card_support(cfg, FLASH, "cuda", training=False, paged=True)
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        serve.main(["--arch", "whisper-base", "--engine", "paged", "--device", "cpu"])
    for arch in ("qwen3-8b", "granite-moe-1b-a400m"):
        check_card_support(registry.get(arch), FLASH, "cuda", training=False, paged=True)


def test_moe_training_is_refused_on_the_card():
    """granite-moe-1b-a400m trains on the card in bfloat16 (its own dtype)
    through the head_dim-64 kernels, fused and split backward, under the
    same rules as a dense model; what the card still refuses for it is
    float32, through the check and through the train CLI's early check
    before any weight is made. Without a card the bf16 CLI run passes the
    check and stops at the missing card."""
    cfg = registry.get("granite-moe-1b-a400m")
    assert cfg.family == "moe" and cfg.dtype == "bfloat16" and cfg.head_dim == 64
    for device in ("cuda", "cuda:0"):
        for bwd in (None, "split"):
            check_card_support(cfg, AttentionConfig(impl="flash_cuda", bwd=bwd), device,
                               training=True)
        check_card_support(cfg, FLASH, device, training=True, packed=True)
        with pytest.raises(ValueError, match="bfloat16"):
            check_card_support(dataclasses.replace(cfg, dtype="float32"), FLASH, device,
                               training=True)
    with pytest.raises(ValueError, match="--dtype bfloat16"):
        train_cli.main(["--arch", "granite-moe-1b-a400m", "--dtype", "float32", "--steps", "1"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_cli.main(["--arch", "granite-moe-1b-a400m", "--steps", "1"])
    check_card_support(cfg, FLASH, "cpu", training=True)
    check_card_support(cfg, REF, "cuda", training=True)
    check_card_support(cfg, FLASH, "cuda", training=False)


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
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
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
def test_serve_cli_takes_granite_to_the_card(engine):
    """granite-moe-1b-a400m (head_dim 64, 16 q heads over 8 kv heads, MoE)
    on the default device through flash_cuda passes the check (the paged
    decode is built at 64) and stops only at the missing card, before any
    weight is made."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI would serve on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "granite-moe-1b-a400m", "--engine", engine])


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
