"""Live efficiency accounting: achieved-vs-model FLOPs, tokens/s, MFU.

The counterpart of ``repro/obs/mfu.py`` on ``repro_torch.utils.flops``:
the paper's headline metric (Table 1: model-FLOPs utilization end to end)
as gauges a running loop updates every step or tick.

  * **model FLOPs** come from the analytic formulas in ``utils/flops.py``
    (6*N_active*D + the 12*L*H*S^2 attention term, causal halving NOT
    applied -- the literature's convention, and the MFU numerator the
    paper reports);
  * **hardware FLOPs** apply the visible-tile census
    (``utils/flops._visible_fraction``) to the attention term -- causal
    and windowed masks shrink the work the kernels launch, so HFU > MFU on
    masked workloads;
  * **MFU / HFU** divide by the device's peak FLOP/s (:func:`peak_flops`:
    ``REPRO_PEAK_FLOPS`` overrides, else a table by device name).

All accounting is host arithmetic on numbers the loop already has
(config, cache lengths, wall time): nothing here touches a tensor, so a
meter adds no kernel launch and no host synchronisation.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.utils import flops as F

__all__ = ["peak_flops", "mfu", "TrainEfficiency", "DecodeEfficiency"]

# Dense bf16 tensor-core peak FLOP/s of one device, by the name
# ``torch.cuda.get_device_name`` gives: the H100 SXM's 989 TFLOP/s from
# NVIDIA's data sheet (at its 700 W limit; a card set lower runs slower, so
# every MFU line is printed beside the card's power limit). "cpu" is an
# order-of-magnitude figure for a few AVX cores, as in the JAX package:
# on a CPU run MFU is a sanity signal (finite, > 0), not a hardware claim.
# A CUDA card missing here raises rather than borrow another card's peak.
PEAK_FLOPS_BY_DEVICE: Dict[str, float] = {
    "NVIDIA H100 80GB HBM3": 989e12,
    "cpu": 1e11,
}


def peak_flops(device=DEFAULT_DEVICE) -> float:
    """Peak FLOP/s of ``device`` (a name or ``torch.device``):
    ``REPRO_PEAK_FLOPS`` where set, else the table's entry for the card's
    name, or for the CPU."""
    env = os.environ.get("REPRO_PEAK_FLOPS")
    if env:
        return float(env)
    dev = resolve_device(device)
    if dev.type == "cpu":
        return PEAK_FLOPS_BY_DEVICE["cpu"]
    name = torch.cuda.get_device_name(dev)
    if name not in PEAK_FLOPS_BY_DEVICE:
        raise ValueError(f"no peak FLOP/s is known for {name!r}: set REPRO_PEAK_FLOPS to the "
                         "card's dense bf16 peak")
    return PEAK_FLOPS_BY_DEVICE[name]


def mfu(model_flops: float, seconds: float, peak: float) -> float:
    """Model-FLOPs utilization of ``model_flops`` of work done in
    ``seconds`` on a device of ``peak`` FLOP/s; 0.0 when no time has
    elapsed."""
    if seconds <= 0:
        return 0.0
    return model_flops / seconds / peak


def _attn_layer_dims(cfg: ModelConfig) -> Sequence[Tuple[Optional[int], int]]:
    """(window, sink) per attention-bearing layer, precomputed once."""
    dims = []
    for kind in cfg.layer_kinds():
        if kind.startswith("attn") or kind.startswith("hybrid"):
            w = cfg.kind_window(kind)
            sink = cfg.meta_tokens if (w is not None and cfg.meta_tokens) else 0
            dims.append((w, sink))
    return dims


class TrainEfficiency:
    """Per-step train gauges: ``<prefix>/mfu``, ``/hfu``, ``/tokens_per_s``.

    Model FLOPs per step are fixed by (config, batch, seq) and computed
    once; hardware FLOPs scale the attention term by the visible-tile
    fraction of each layer's mask (causal ~ 1/2, window ~ W/S) at the
    128-token tile granularity of the JAX package's census. ``step(dt)``
    feeds one measured step; gauges report *cumulative* utilization (the
    Table 1 convention), counters carry the raw totals. ``peak`` defaults
    to ``peak_flops(device)``.
    """

    def __init__(self, cfg: ModelConfig, batch_size: int, seq_len: int,
                 registry: MetricsRegistry, prefix: str = "train",
                 peak: Optional[float] = None, device=DEFAULT_DEVICE):
        self.registry = registry
        self.prefix = prefix
        self.peak = peak or peak_flops(device)
        self.tokens_per_step = batch_size * seq_len
        shape = ShapeConfig("live_train", "train", seq_len, batch_size)
        self.model_flops_per_step = F.train_model_flops(cfg, shape)
        bq = bk = min(128, max(8, seq_len))
        t = -(-seq_len // bq)
        hw = self.model_flops_per_step
        for window, sink in _attn_layer_dims(cfg):
            kind = "window" if window is not None else "causal"
            vf = F._visible_fraction(kind, window, sink, t, t, bq, bk)
            s_eff = min(window, seq_len) if window else seq_len
            term = 12.0 * cfg.q_dim * s_eff * seq_len * batch_size
            hw -= (1.0 - vf) * term
        self.hardware_flops_per_step = hw
        self._steps = registry.counter(f"{prefix}/steps")
        self._tok = registry.counter(f"{prefix}/tokens")
        self._flops = registry.counter(f"{prefix}/model_flops")
        self._secs = registry.counter(f"{prefix}/compute_seconds")
        self._g_mfu = registry.gauge(f"{prefix}/mfu")
        self._g_hfu = registry.gauge(f"{prefix}/hfu")
        self._g_tps = registry.gauge(f"{prefix}/tokens_per_s")
        self._g_tflops = registry.gauge(f"{prefix}/model_tflops_per_s")

    def step(self, seconds: float) -> None:
        self._steps.inc()
        self._tok.inc(self.tokens_per_step)
        self._flops.inc(self.model_flops_per_step)
        self._secs.inc(seconds)
        secs = self._secs.value
        if secs > 0:
            achieved = self._flops.value / secs
            self._g_mfu.set(achieved / self.peak)
            self._g_hfu.set(
                achieved / self.peak
                * self.hardware_flops_per_step / self.model_flops_per_step
            )
            self._g_tps.set(self._tok.value / secs)
            self._g_tflops.set(achieved / 1e12)


class DecodeEfficiency:
    """Per-tick decode gauges: ``<prefix>/mfu``, ``/tokens_per_s``.

    A decode tick's model FLOPs depend on the *live* cache lengths (each
    row re-reads its whole cache), so the meter takes them per tick:
    2*N_active per live row plus the 4*d_q*L attention read per attention
    layer, summed over heterogeneous rows. Decode reads every cached key,
    so hardware == model FLOPs here (windows still clip).
    """

    def __init__(self, cfg: ModelConfig, registry: MetricsRegistry,
                 prefix: str = "decode", peak: Optional[float] = None,
                 device=DEFAULT_DEVICE):
        self.registry = registry
        self.prefix = prefix
        self.peak = peak or peak_flops(device)
        _, self._active_params = F.param_count(cfg)
        self._q_dim = cfg.q_dim
        self._attn_dims = _attn_layer_dims(cfg)
        self._ticks = registry.counter(f"{prefix}/ticks")
        self._tok = registry.counter(f"{prefix}/tokens")
        self._flops = registry.counter(f"{prefix}/model_flops")
        self._secs = registry.counter(f"{prefix}/compute_seconds")
        self._g_mfu = registry.gauge(f"{prefix}/mfu")
        self._g_tps = registry.gauge(f"{prefix}/tokens_per_s")

    def tick_model_flops(self, cache_lens: Sequence[int]) -> float:
        """Model FLOPs of one decode step over rows with these live cache
        lengths (zero-length rows are dead slots and charge nothing)."""
        live = [int(n) for n in cache_lens if int(n) > 0]
        total = 2.0 * self._active_params * len(live)
        for L in live:
            for window, _sink in self._attn_dims:
                s_eff = min(window, L) if window else L
                total += 4.0 * self._q_dim * s_eff
        return total

    def tick(self, cache_lens: Sequence[int], seconds: float) -> int:
        """Feed one measured decode tick; returns the live-row count."""
        live = sum(1 for n in cache_lens if int(n) > 0)
        self._ticks.inc()
        self._tok.inc(live)
        self._flops.inc(self.tick_model_flops(cache_lens))
        self._secs.inc(seconds)
        secs = self._secs.value
        if secs > 0:
            self._g_mfu.set(self._flops.value / secs / self.peak)
            self._g_tps.set(self._tok.value / secs)
        return live
