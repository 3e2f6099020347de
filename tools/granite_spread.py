"""How far granite-moe-1b-a400m training runs drift apart on their own:
the spread against which ``chip_smoke.py``'s granite training slice holds
the kernels to ``impl="ref"``.

Five runs of ``launch/train.py``'s ``train`` at the slice's shape (the
registry's granite uncut, bf16, B 2, S 2048, seed 0, AdamW with 2 warmup
steps) over ``--steps`` steps: A, flash_cuda with the fused backward and
its own expert choices (recorded per call, ``chip_smoke.routing``); B, the
same again; C, the split backward; R and R2, impl="ref". B, C, R and R2
replay A's choices, so that only the continuous arithmetic differs. Prints
each run's relative loss difference from A by step, and R2's from R, with
the card's name and power limit. Needs a card (about two minutes with the
build):

    python3 tools/granite_spread.py [--steps 8]
"""

from __future__ import annotations

import argparse
import gc
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def main() -> None:
    import torch

    from repro_torch.configs import registry
    from repro_torch.kernels import _build
    from repro_torch.launch.train import TrainLoopConfig, train
    from repro_torch.training.optimizer import AdamWConfig

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("no CUDA device: this script runs on an NVIDIA GPU")
    cs.log(f"nvidia-smi: {cs.smi_line()}")
    _build.build(["flash_fwd", "flash_bwd"])
    cfg = registry.get("granite-moe-1b-a400m")
    opt = AdamWConfig(warmup_steps=2, total_steps=args.steps)
    losses, replay = {}, None
    for run, impl, bwd in (("A", "flash_cuda", "fused"), ("B", "flash_cuda", "fused"),
                           ("C", "flash_cuda", "split"), ("R", "ref", None),
                           ("R2", "ref", None)):
        loop = TrainLoopConfig(steps=args.steps, seq_len=cs.GR_TRAIN_S,
                               batch_size=cs.GR_TRAIN_B, log_every=args.steps, seed=0,
                               device="cuda", attn_impl=impl, attn_bwd=bwd)
        with cs.routing(replay) as calls:
            history = train(cfg, loop, opt)[2]
        torch.cuda.synchronize()
        losses[run] = history["loss"]
        if replay is None:
            replay = list(calls)
        del calls, history
        gc.collect()
        torch.cuda.empty_cache()

    def gaps(run, base):
        return ", ".join(f"{abs(a - b) / abs(b):.3e}" for a, b in zip(losses[run], losses[base]))

    for run in ("B", "C", "R", "R2"):
        cs.log(f"{run} against A (the fused run with its own choices; the others replay them), "
               f"relative loss difference by step: {gaps(run, 'A')}")
    cs.log(f"R2 against R: {gaps('R2', 'R')}")


if __name__ == "__main__":
    cs.run(main)
