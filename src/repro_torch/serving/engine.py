"""Continuous-batching serving engine with fixed cache slots.

The counterpart of ``repro/serving/engine.py:ServingEngine``: ``max_batch``
contiguous cache slots of ``cache_size`` positions, the same
submit -> admit (bucketed B=1 prefill) -> tick (decode every slot) ->
retire lifecycle, so that the port and the JAX engine generate the same
tokens for the same requests. Telemetry comes in a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import cache_specs
from repro_torch.core.attention import AttentionConfig
from repro_torch.launch.steps import build_prefill_step, build_serve_step


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServingEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        model,
        attn_cfg: AttentionConfig,
        *,
        max_batch: int = 4,
        cache_size: int = 512,
        prompt_pad: int = 64,
    ):
        self.cfg = cfg
        self.model = model
        self.attn = attn_cfg
        self.B = max_batch
        self.cache_size = cache_size
        self.prompt_pad = prompt_pad
        self.device = model.device
        # Bucketing needs the lens-masked prefill (attention-only configs).
        self._bucket = prompt_pad > 1 and cfg.ssm is None
        self._prefill = build_prefill_step(cfg, attn_cfg, cache_size)
        self._step = build_serve_step(cfg, attn_cfg)
        self.caches = [
            {"kv": {name: torch.zeros(s.shape, dtype=s.dtype, device=self.device)
                    for name, s in layer["kv"].items()}}
            for layer in cache_specs(cfg, max_batch, cache_size)
        ]
        self.cache_len = torch.zeros((max_batch,), dtype=torch.int32, device=self.device)
        self.next_token = torch.zeros((max_batch, 1), dtype=torch.int32, device=self.device)
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.queue: List[Request] = []
        self.finished: Dict[int, Request] = {}
        self.ticks = 0

    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self, slot: int, req: Request):
        """Bucketed (B=1) prefill into ``slot``: the prompt is right-padded
        to the next multiple of ``prompt_pad``; ``lens`` says where the real
        tokens end, and the padded cache tail sits past ``cache_len``, so
        decode never reads it (the first generated token overwrites it)."""
        L = len(req.prompt)
        pad_to = -(-L // self.prompt_pad) * self.prompt_pad if self._bucket else L
        pad_to = min(pad_to, self.cache_size - 1)
        if L > pad_to:
            raise ValueError(f"prompt ({L}) exceeds cache capacity {self.cache_size}")
        prompt = np.zeros((1, pad_to), np.int64)
        prompt[0, :L] = req.prompt
        batch = {"inputs": torch.from_numpy(prompt).to(self.device)}
        if self._bucket:
            batch["lens"] = torch.tensor([L], dtype=torch.int32, device=self.device)
        tok, cache1, lens = self._prefill(self.model, batch)
        for layer, new in zip(self.caches, cache1):
            for name, buf in layer["kv"].items():
                buf[slot].copy_(new["kv"][name][0])
        self.cache_len[slot] = lens[0]
        self.next_token[slot] = tok[0]
        req.generated.append(int(tok[0, 0]))
        self.slots[slot] = req

    def _retire(self, slot: int):
        req = self.slots[slot]
        if req is not None:
            req.done = True
            self.finished[req.rid] = req
        self.slots[slot] = None
        self.cache_len[slot] = 0

    def tick(self):
        """Admit from the queue, run one decode step, retire finished."""
        for slot in range(self.B):
            if self.slots[slot] is None and self.queue:
                self._admit(slot, self.queue.pop(0))
        if not any(self.slots):
            return
        tok, self.caches = self._step(self.model, self.next_token, self.caches,
                                      self.cache_len)
        live = torch.tensor([s is not None for s in self.slots], dtype=torch.int32,
                            device=self.device)
        self.cache_len = self.cache_len + live
        self.next_token = tok
        tok_host = tok[:, 0].tolist()
        lens_host = self.cache_len.tolist()
        self.ticks += 1
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            t = tok_host[slot]
            req.generated.append(t)
            if (req.eos_id is not None and t == req.eos_id) or len(
                req.generated
            ) >= req.max_new_tokens + 1 or lens_host[slot] >= self.cache_size - 1:
                self._retire(slot)

    def run(self, max_ticks: int = 1000) -> Dict[int, Request]:
        while (self.queue or any(s is not None for s in self.slots)) and self.ticks < max_ticks:
            self.tick()
        return self.finished
