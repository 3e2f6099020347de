"""Continuous-batching serving engines.

The counterparts of ``repro/serving/engine.py``. Both share the
submit -> admit -> tick (decode every slot) -> retire lifecycle, so that
the port and the JAX engines generate the same tokens for the same
requests:

  * :class:`ServingEngine` -- ``max_batch`` contiguous cache slots of
    ``cache_size`` positions, reserved for a request's worst case.
  * :class:`PagedServingEngine` -- vLLM-style paged KV: the cache is a pool
    of fixed-size pages (``serving/kv_pool.py``), a resident sequence holds
    ``len // page_size + 1`` of them through its row of an int32 block
    table, and decode reads pages through the table
    (``kernels/flash_decode.flash_decode_paged``).

Both carry the JAX engines' telemetry (``_EngineTelemetry``): a metrics
registry with the same names and snapshot schema, and an optional Perfetto
tracer of each request's lifecycle. It is host-side only: it reads the
cache lengths and times the engine already holds on the host, so it adds
no kernel launch and no host synchronisation to a tick.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import cache_specs, paged_cache_specs
from repro_torch.core.attention import AttentionConfig
from repro_torch.launch.steps import (
    build_paged_admit_step,
    build_paged_serve_step,
    build_prefill_step,
    build_serve_step,
)
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.mfu import DecodeEfficiency
from repro_torch.obs.trace import TraceRecorder
from repro_torch.serving.kv_pool import KVPagePool


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False

    @property
    def feed(self) -> List[int]:
        """Tokens whose KV must be (re)built at admission: the prompt plus
        anything already generated -- nonempty ``generated`` means the
        request was preempted and is resuming (greedy decoding makes the
        continuation the same as if it had never paused)."""
        return self.prompt + self.generated


# Fixed buckets for the admission-size histogram (prompt pad buckets are
# prompt_pad multiples clamped to capacity; pow2 bounds cover both engines)
ADMIT_BUCKETS = (16.0, 32.0, 64.0, 128.0, 256.0, 512.0, 1024.0)
QUEUE_WAIT_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)


class _EngineTelemetry:
    """The observability surface of both engines (JAX ``engine.py:73``).

    Host-side only (obs/metrics, obs/trace, obs/mfu): it runs around the
    steps on values the engine already holds on the host -- the cache
    lengths of the tick's read-back, the prefill's read-back, the host
    clock -- so it adds no kernel launch and no host synchronisation.

    Registry schema (``snapshot()``):

      counters   serving/{tokens, admissions, retirements, ticks}
                 decode/{ticks, tokens, model_flops, compute_seconds}
      gauges     decode/{mfu, tokens_per_s}  (cumulative; obs/mfu)
      gauge_fns  serving/{active_slots, slot_utilization, queue_depth,
                 kv_cells_active, kv_cells_capacity, token_occupancy}
                 (+ kv_pool/* and serving/{preemptions, page_fill}, and the
                 serving/page_oom counter, paged)
      histograms serving/admit_bucket (admitted pad bucket, tokens),
                 serving/queue_wait_ticks (submit -> admission, ticks)
    """

    def _obs_init(self, registry: Optional[MetricsRegistry],
                  tracer: Optional[TraceRecorder]):
        self.obs = registry if registry is not None else MetricsRegistry()
        self.tracer = tracer
        self._c_tokens = self.obs.counter("serving/tokens")
        self._c_admissions = self.obs.counter("serving/admissions")
        self._c_retirements = self.obs.counter("serving/retirements")
        self._c_ticks = self.obs.counter("serving/ticks")
        self._h_bucket = self.obs.histogram("serving/admit_bucket", ADMIT_BUCKETS)
        self._h_wait = self.obs.histogram("serving/queue_wait_ticks", QUEUE_WAIT_BUCKETS)
        self._eff = DecodeEfficiency(self.cfg, self.obs, device=self.device)
        self.obs.gauge_fn("serving/active_slots",
                          lambda: sum(s is not None for s in self.slots))
        self.obs.gauge_fn("serving/slot_utilization",
                          lambda: sum(s is not None for s in self.slots) / self.B)
        self.obs.gauge_fn("serving/queue_depth", lambda: len(self.queue))
        self.obs.gauge_fn("serving/kv_cells_active", self.active_kv_cells)
        self.obs.gauge_fn("serving/kv_cells_capacity", self.kv_capacity)
        self.obs.gauge_fn("serving/token_occupancy",
                          lambda: self.resident_tokens() / max(1, self.kv_capacity()))
        self._submit_tick: Dict[int, int] = {}  # rid -> tick at (re)submit
        self._submit_ts: Dict[int, float] = {}  # rid -> trace us at submit
        self._decode_t0: Dict[int, float] = {}  # rid -> decode-span start us
        self._preempted_rids: set = set()  # resumes owe a 'resume' instant

    def snapshot(self) -> Dict[str, float]:
        """Flat metrics snapshot (obs/metrics schema); both engines."""
        return self.obs.snapshot()

    def _note_submit(self, req: "Request", *, resumed: bool = False):
        self._submit_tick[req.rid] = self.ticks
        if self.tracer:
            self.tracer.name_thread(req.rid, f"req {req.rid}")
            self._submit_ts[req.rid] = self.tracer.now_us()
            if not resumed:
                self.tracer.instant("submit", tid=req.rid,
                                    args={"rid": req.rid, "prompt_len": len(req.prompt)})

    def _note_admission(self, req: "Request", bucket: int, t_pref0: float, t_pref1: float):
        """One request admitted: counters and the request track's
        queue_wait and prefill spans ([submit, admit) and [admit, the
        prefill's result on the host))."""
        self._c_admissions.inc()
        self._h_bucket.observe(bucket)
        self._h_wait.observe(self.ticks - self._submit_tick.pop(req.rid, self.ticks))
        if self.tracer:
            sub = self._submit_ts.pop(req.rid, t_pref0)
            self.tracer.complete("queue_wait", req.rid, sub, t_pref0 - sub)
            self.tracer.complete("prefill", req.rid, t_pref0, t_pref1 - t_pref0,
                                 args={"bucket": bucket, "feed_len": len(req.feed)})
            if req.rid in self._preempted_rids:
                self._preempted_rids.discard(req.rid)
                self.tracer.instant("resume", tid=req.rid, args={"rid": req.rid})
            self._decode_t0[req.rid] = t_pref1

    def _note_leave(self, req: "Request", *, preempted: bool):
        """The request left its slot (retire or preempt): close its decode
        span; a preempt emits the instant that its resume pairs with."""
        if not preempted:
            self._c_retirements.inc()
        if self.tracer:
            now = self.tracer.now_us()
            t0 = self._decode_t0.pop(req.rid, now)
            self.tracer.complete("decode", req.rid, t0, now - t0,
                                 args={"generated": len(req.generated), "preempted": preempted})
            self.tracer.instant("preempt" if preempted else "retire", tid=req.rid,
                                args={"rid": req.rid})

    def _note_decode_tick(self, cache_lens, t0_us: float, dt_s: float):
        self._c_ticks.inc()
        live = self._eff.tick(cache_lens, dt_s)
        self._c_tokens.inc(live)
        if self.tracer:
            self.tracer.complete("decode_tick", 0, t0_us, dt_s * 1e6, args={"live": live})
            self.tracer.counter("resident", {"slots": live, "tokens": self.resident_tokens()})

    def _now_us(self) -> float:
        return self.tracer.now_us() if self.tracer else 0.0


def _new_caches(specs, device):
    return [{"kv": {name: torch.zeros(t.shape, dtype=t.dtype, device=device)
                    for name, t in layer["kv"].items()}} for layer in specs]


class ServingEngine(_EngineTelemetry):
    def __init__(
        self,
        cfg: ModelConfig,
        model,
        attn_cfg: AttentionConfig,
        *,
        max_batch: int = 4,
        cache_size: int = 512,
        prompt_pad: int = 64,
        registry: Optional[MetricsRegistry] = None,
        tracer: Optional[TraceRecorder] = None,
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
        self.caches = _new_caches(cache_specs(cfg, max_batch, cache_size), self.device)
        self.cache_len = torch.zeros((max_batch,), dtype=torch.int32, device=self.device)
        self.next_token = torch.zeros((max_batch, 1), dtype=torch.int32, device=self.device)
        # The host's copy of cache_len: set at admission and retirement,
        # and from the tick's read-back, never by a read of its own.
        self._lens_host = [0] * max_batch
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.queue: List[Request] = []
        self.finished: Dict[int, Request] = {}
        self.ticks = 0
        self._obs_init(registry, tracer)

    def resident_tokens(self) -> int:
        return sum(self._lens_host)

    def active_kv_cells(self) -> int:
        """KV cells the decode step touches: every slot's full slice, live
        or not (the cost the paged engine's page skip removes)."""
        return self.B * self.cache_size

    def kv_capacity(self) -> int:
        return self.B * self.cache_size

    def submit(self, req: Request):
        self._note_submit(req)
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
        t_pref0 = self._now_us()
        tok, cache1, lens = self._prefill(self.model, batch)
        for layer, new in zip(self.caches, cache1):
            for name, buf in layer["kv"].items():
                buf[slot].copy_(new["kv"][name][0])
        self.cache_len[slot] = lens[0]  # the prefill's lens: L, bucketed or not
        self._lens_host[slot] = L
        self.next_token[slot] = tok[0]
        first = int(tok[0, 0])  # the read-back that ends the prefill
        self._note_admission(req, pad_to, t_pref0, self._now_us())
        req.generated.append(first)
        self.slots[slot] = req

    def _retire(self, slot: int):
        req = self.slots[slot]
        if req is not None:
            req.done = True
            self.finished[req.rid] = req
            self._note_leave(req, preempted=False)
        self.slots[slot] = None
        self.cache_len[slot] = 0
        self._lens_host[slot] = 0

    def tick(self):
        """Admit from the queue, run one decode step, retire finished."""
        for slot in range(self.B):
            if self.slots[slot] is None and self.queue:
                self._admit(slot, self.queue.pop(0))
        if not any(self.slots):
            return
        lens_before = [n for n, s in zip(self._lens_host, self.slots) if s is not None]
        t0_us, t0 = self._now_us(), time.perf_counter()
        tok, self.caches = self._step(self.model, self.next_token, self.caches,
                                      self.cache_len)
        live = torch.tensor([s is not None for s in self.slots], dtype=torch.int32,
                            device=self.device)
        self.cache_len = self.cache_len + live
        self.next_token = tok
        tok_host = tok[:, 0].tolist()
        lens_host = self.cache_len.tolist()
        self._lens_host = list(lens_host)
        self.ticks += 1
        self._note_decode_tick(lens_before, t0_us, time.perf_counter() - t0)
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


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


class PagedServingEngine(_EngineTelemetry):
    """Continuous batching over a paged KV pool (the counterpart of
    ``PagedServingEngine``, JAX ``engine.py:360``).

    The device holds ``num_pages`` physical pages of ``page_size`` positions
    per layer (``registry.paged_cache_specs``); a resident request owns
    ``len // page_size + 1`` of them (one page of write headroom) through
    its row of the int32 block table. Admission allocates, growth extends
    one page at a time, retirement frees, so a request's memory tracks its
    actual length and the engine admits by free pages, not free worst-case
    slots.

    The scheduler state (``table``, ``cache_len``, ``next_token``) lives on
    the host as numpy, as in the JAX engine: ``_grow`` and ``_need_pages``
    read the lengths every tick. A tick copies the table, the lengths and
    the tokens to the device once and the new tokens back once.

    Admission is strict FIFO and keeps one growth page in reserve per
    resident request; all admitted prompts of one bucket go through one
    lens-masked prefill of W = next_pow2(group) rows (at most
    ``max_batch``), scattered into their pages. If growth still finds the
    pool empty, the youngest resident request is preempted: its pages are
    freed and it is requeued at the front with its generated tokens, so
    re-admission re-prefills prompt + generated (``Request.feed``) and
    greedy decoding resumes where it left off.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        model,
        attn_cfg: AttentionConfig,
        *,
        max_batch: int = 4,
        num_pages: int = 64,
        page_size: int = 16,
        pages_per_seq_max: int = 16,
        prompt_pad: int = 64,
        registry: Optional[MetricsRegistry] = None,
        tracer: Optional[TraceRecorder] = None,
    ):
        self.cfg = cfg
        self.model = model
        self.attn = attn_cfg
        self.B = max_batch
        self.ps = page_size
        self.n_max = pages_per_seq_max
        self.prompt_pad = prompt_pad
        self.device = model.device
        self.pool = KVPagePool(num_pages, page_size)
        self.caches = _new_caches(paged_cache_specs(cfg, num_pages, page_size), self.device)
        self._step = build_paged_serve_step(cfg, attn_cfg)
        self._admit = build_paged_admit_step(cfg, attn_cfg, page_size)
        self.table = np.zeros((max_batch, pages_per_seq_max), np.int32)
        self.cache_len = np.zeros((max_batch,), np.int32)
        self.next_token = np.zeros((max_batch, 1), np.int32)
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.queue: List[Request] = []
        self.finished: Dict[int, Request] = {}
        self.ticks = 0
        self.preemptions = 0
        self._seq = 0  # admission order, for preempt-youngest
        self._slot_seq = np.zeros((max_batch,), np.int64)
        self._obs_init(registry, tracer)
        self.pool.register_metrics(self.obs)
        self._c_page_oom = self.obs.counter("serving/page_oom")
        self.obs.gauge_fn("serving/preemptions", lambda: float(self.preemptions))
        # the share of the allocated pages' cells that hold real KV
        self.obs.gauge_fn("serving/page_fill",
                          lambda: self.resident_tokens() / max(1, self.pool.used_pages * self.ps))

    def resident_tokens(self) -> int:
        return int(self.cache_len.sum())

    def active_kv_cells(self) -> int:
        """KV cells a decode step may touch: the live rows' allocated pages
        only -- the kernel reads nothing else."""
        return int(sum(-(-int(n) // self.ps) * self.ps for n in self.cache_len if int(n) > 0))

    def kv_capacity(self) -> int:
        return self.pool.usable_pages * self.ps

    def _need_pages(self, tokens: int) -> int:
        return tokens // self.ps + 1  # +1: the next decode write has a page

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def submit(self, req: Request):
        worst = len(req.prompt) + req.max_new_tokens
        assert worst <= self.n_max * self.ps - 1, (
            f"request {req.rid}: prompt+max_new ({worst}) exceeds per-seq "
            f"capacity {self.n_max * self.ps - 1}"
        )
        assert self._need_pages(len(req.prompt)) <= self.pool.usable_pages, (
            f"request {req.rid}: prompt alone overflows the pool"
        )
        self._note_submit(req)
        self.queue.append(req)

    def _bucket(self, L: int) -> int:
        pad = -(-L // self.prompt_pad) * self.prompt_pad
        return min(max(pad, self.prompt_pad), self.n_max * self.ps)

    def _admit_tick(self):
        """Strict-FIFO admission, then one batched prefill per bucket. A
        request is admitted only if the pool still holds one reserve page
        per resident request afterwards (those picked this tick included);
        the first request that does not fit blocks the rest."""
        free_slots = [i for i, s in enumerate(self.slots) if s is None]
        reserve = sum(s is not None for s in self.slots)
        picks: List[Tuple[int, Request, List[int]]] = []
        while self.queue and free_slots:
            req = self.queue[0]
            need = self._need_pages(len(req.feed))
            if len(req.feed) > self._bucket(len(req.feed)):
                # A resumed request grew past the largest bucket: it cannot
                # re-prefill, so it finishes as it is.
                self.queue.pop(0)
                req.done = True
                self.finished[req.rid] = req
                continue
            if self.pool.free_pages - need < reserve:
                break
            pages = self.pool.alloc(req.rid, need)
            if pages is None:
                break
            self.queue.pop(0)
            picks.append((free_slots.pop(0), req, pages))
            reserve += 1
        by_bucket: Dict[int, List[Tuple[int, Request, List[int]]]] = {}
        for pick in picks:
            by_bucket.setdefault(self._bucket(len(pick[1].feed)), []).append(pick)
        for pad_to, group in sorted(by_bucket.items()):
            W = min(_next_pow2(len(group)), self.B)
            npb = -(-pad_to // self.ps)
            inputs = np.zeros((W, pad_to), np.int64)
            lens = np.ones((W,), np.int32)  # dummy rows: 1 token, null dest
            dest = np.zeros((W, npb), np.int64)
            for i, (_, req, pages) in enumerate(group):
                feed = req.feed
                inputs[i, :len(feed)] = feed
                lens[i] = len(feed)
                n_dest = min(-(-len(feed) // self.ps), npb)
                dest[i, :n_dest] = pages[:n_dest]
            t_pref0 = self._now_us()
            tok, lens_total, self.caches = self._admit(
                self.model, {"inputs": self._to_device(inputs), "lens": self._to_device(lens)},
                self.caches, self._to_device(dest),
            )
            tok_host = tok.cpu().numpy()
            lens_host = lens_total.cpu().numpy()
            t_pref1 = self._now_us()
            for i, (slot, req, pages) in enumerate(group):
                self._note_admission(req, pad_to, t_pref0, t_pref1)
                self.table[slot] = 0
                self.table[slot, :len(pages)] = pages
                self.cache_len[slot] = int(lens_host[i])
                t = int(tok_host[i, 0])
                req.generated.append(t)
                self.next_token[slot, 0] = t
                self.slots[slot] = req
                self._slot_seq[slot] = self._seq
                self._seq += 1

    def _clear_slot(self, slot: int):
        self.slots[slot] = None
        self.table[slot] = 0
        self.cache_len[slot] = 0
        self.next_token[slot, 0] = 0

    def _retire(self, slot: int):
        req = self.slots[slot]
        assert req is not None
        self.pool.free(req.rid)
        req.done = True
        self.finished[req.rid] = req
        self._note_leave(req, preempted=False)
        self._clear_slot(slot)

    def _preempt_youngest(self) -> bool:
        """Free the most recently admitted request's pages and requeue it at
        the queue front (it keeps its place and its generated tokens)."""
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if len(active) <= 1:
            return False  # never preempt the last runner: no progress
        victim = max(active, key=lambda i: self._slot_seq[i])
        req = self.slots[victim]
        self.pool.free(req.rid)
        self._note_leave(req, preempted=True)
        self._preempted_rids.add(req.rid)
        self._note_submit(req, resumed=True)
        self.queue.insert(0, req)
        self._clear_slot(victim)
        self.preemptions += 1
        return True

    def _grow(self):
        """Give every resident request a page for its next write, extending
        from the pool and preempting the youngest when it is empty;
        oldest first, so preemption lands on the least progressed."""
        order = sorted((i for i, s in enumerate(self.slots) if s is not None),
                       key=lambda i: self._slot_seq[i])
        for slot in order:
            req = self.slots[slot]
            if req is None:  # preempted by an earlier iteration
                continue
            while self._need_pages(int(self.cache_len[slot])) > len(self.pool.pages_of(req.rid)):
                page = self.pool.extend(req.rid)
                if page is None:
                    self._c_page_oom.inc()
                    if self.tracer:
                        self.tracer.instant("page_oom", tid=0, args={"rid": req.rid})
                    if not self._preempt_youngest():
                        raise RuntimeError("page pool exhausted with a single resident "
                                           "request; pool too small for this workload")
                    if self.slots[slot] is None:
                        break  # we preempted ourselves
                    continue
                self.table[slot, len(self.pool.pages_of(req.rid)) - 1] = page

    def tick(self):
        self._admit_tick()
        if not any(s is not None for s in self.slots):
            return
        lens_before = self.cache_len.copy()
        t0_us, t0 = self._now_us(), time.perf_counter()
        tok, self.caches = self._step(
            self.model, self._to_device(self.next_token), self.caches,
            self._to_device(self.table), self._to_device(self.cache_len),
        )
        tok_host = tok.cpu().numpy()
        self.ticks += 1
        self._note_decode_tick(lens_before, t0_us, time.perf_counter() - t0)
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            self.cache_len[slot] += 1
            t = int(tok_host[slot, 0])
            req.generated.append(t)
            self.next_token[slot, 0] = t
            if ((req.eos_id is not None and t == req.eos_id)
                    or len(req.generated) >= req.max_new_tokens + 1
                    or int(self.cache_len[slot]) >= self.n_max * self.ps - 1):
                self._retire(slot)
        self._grow()

    def run(self, max_ticks: int = 10000) -> Dict[int, Request]:
        while (self.queue or any(s is not None for s in self.slots)) and self.ticks < max_ticks:
            self.tick()
        return self.finished
