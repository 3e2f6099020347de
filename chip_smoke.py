#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero; there is no CPU fallback):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc
     for sm_90a, one nvcc per source, all started together, and print
     nvcc's -Xptxas -v reports (and each instantiation's registers and
     spills); the forward's head_dim-64/128 lines must equal the numbers
     the design before the wide kernels built them with, and the fold's
     those of its redesign (``FWD_PTXAS_BEFORE``), and no head_dim-160 or
     -256 forward instantiation (either tile mode) may spill or serialise
     its wgmma (their parents spilled none);
  3. kernels: hold each kernel against its plain PyTorch version on the
     card in bf16 at qwen3-8b widths (the forward also at odd numbers of
     q tiles, q_offset -100, segment ids that hide half of every q tile,
     and strided views of a fused qkv tensor, its outputs finite where the
     plain version's are), then time kernel, plain version,
     the one PyTorch call that computes the same function (a yardstick the
     port never calls) and the roofline bound at the main paths' shapes
     (the forward in turns with SDPA's forward: fwd, SDPA, SDPA, fwd):
     the forward and decode kernels at the serving path's, the backward
     kernels (delta pre-pass, fused dK/dV/dQ, and the split backward's
     dK/dV and dQ kernels, whose dK and dV must be bitwise the fused
     kernel's and whose dQ must be bitwise the same from two launches) and
     the forward again at the training step's; the fused kernel and the
     whole split backward (delta, dK/dV, dQ) are timed in turns with SDPA's
     backward (fused, split, SDPA, SDPA, split, fused), the dK/dV kernel
     beside them, and the fused kernel once more without its dQ bulk
     reduction; ptxas's registers, spills and any serialised wgmma per
     instantiation are printed with the build's seconds;
  4. the serving slice: qwen3-8b at full width (36 layers, bf16, random
     weights from a seed) serves 6 requests through the port's
     ServingEngine; every prefill and decode must go through the kernels
     (launch counts > 0, plain versions 0), and a prefill and a decode step
     through the dense reference must give the same last-position logits;
  5. paged serving: the same model serves the same 6 requests through the
     port's PagedServingEngine (a page pool sized so that admission waits
     on pages and growth forces a preemption); every prefill must go
     through the forward kernel and every decode through the paged decode
     kernel (the contiguous decode kernel and the plain versions 0); a
     decode step through shuffled pages must give the contiguous cache's
     logits, and a W = 4 batched admission prefill the dense reference's;
  6. decode ticks of both engines: timed in turns on the host clock, then
     profiled (torch.profiler) for the device busy share, the kernels by
     device time and the host operators by host time;
  7. training parity: one step of 2-layer, full-width qwen3-8b through the
     dense reference and through the kernels (fused and split backward),
     from the same weights and batch, must give the same loss and
     attention gradients;
  8. the training slice: qwen3-8b at its published widths, depth cut to 8
     layers (one card's memory), takes 8 AdamW steps on the synthetic
     stream at B = 2, S = 2048; the loss must be finite and fall, and every
     attention forward and backward must go through the kernels (counts
     exact, plain versions 0);
  9. the deterministic training slice: phase 8's model, seed and batches
     through the split backward (bwd="split"); counts exact (dK/dV and dQ
     once a layer, the fused kernel never), the loss must fall and step 0's
     loss equal phase 8's; then attention forward and backward at the
     training shape, run twice, must give bitwise-equal gradients;
 10. packed training parity: phase 7 on a packed batch of the varlen
     source (B = 2, S = 1024): the dense reference with the segment mask
     against the segment kernels, fused and split backward;
 11. the packed training slice: phase 8's model, seed, AdamW and steps fed
     from the packed (varlen) source through launch/train.py's ``train``
     with ``packed=True``; the loss must fall, every attention forward and
     backward must go through the segment kernels (counts exact, the
     unsegmented kernels and the plain versions 0); its step is reported
     beside phase 8's;
 12. dense training parity: phases 7 and 10 with schedule="dense" (the
     dense-schedule kernels, unpacked and packed, fused and split): against
     the dense reference at phase 7's limits and against the compact run
     of each configuration (split: loss and gradients to the bit; fused:
     the loss within PARITY_LOSS_REL); launch counts exact;
 13. the dense training slice: phase 9 (split backward) with
     schedule="dense"; counts exact (the dense forward, dK/dV and dQ, the
     delta pre-pass; every compact kernel and plain version 0), every
     step's loss bitwise phase 9's, the step reported beside phase 9's;
 14. the north star's preset: gpt-20m at its published widths (4 layers,
     d_model 256, 4 heads of 64) in bf16 through the train CLI's ``train``,
     8 steps at B = 8, S = 512, with the fused and with the split backward,
     and once through impl="ref"; counts exact (per layer and step the
     forward, delta, then fused or dK/dV + dQ once, all at head_dim 64), the
     loss must fall and follow the reference's; tokens/s, MFU, peak memory;
 15. whisper-base training at its published widths and depth, B = 8
     utterances of 1500 seeded frame embeddings and 448 tokens, 8 AdamW
     steps through ``build_train_step``, then through impl="ref"; counts
     exact (remat: the forward twice an attention call), the loss must fall
     and follow the reference's; tokens/s and peak memory.
Phase 3 also holds the four backward kernels at head_dim 64 against their
plain versions at whisper's encoder (B 8, S 1500, FULL), cross-attention
(448 rows against 1500 frames), decoder (448, causal) and gpt-20m's
(B 8, S 512, 4 heads, causal) shapes, their SEG and DENSE forms at the
decoder's, with the bitwise invariants (split dK/dV the fused kernel's, dQ
over two launches, dense the compact kernels', all-ones ids the
unsegmented kernels'), and times the fused and the split backward at each
shape in turns with SDPA's backward, beside the bounds.
Phase 3 also holds this slice's kernels against their plain versions and
times them: the split-KV forward at whisper's cross-attention (B = 1 and 4,
4 prompt rows against 1500 frames, head_dim 64; the auto split count and a
sweep, in turns with the single-pass kernel, its one-pass fold included),
at qwen3 widths and with segments; the head_dim-64 forward at the encoder's
shape (dense bitwise compact, with and without segments; in turns with
SDPA); the head_dim-64 decode at the cross and self shapes; the SEG
(packed) decode at the qwen3 decode shape, bitwise the unsegmented kernel
on equal ids. Then the whisper serving slice: whisper-base at its published
widths and depth, B = 4 utterances of 1500 frames and Whisper's 4-token
prompt, prefill and 32 greedy ticks through the step builders, with exact
launch counts (forward 12, split-KV 6, decode 384, every other kernel and
every plain version 0), the prefill and one tick against the dense
reference, the prefill timed in turns through the auto split count and
through kv_splits=1, and a profile of its ticks.
Phase 3 also holds the paged decode kernel against its plain version
(page sizes 16 and 64, G in {1, 4, 8}, a window-256/sink-4 spec, shuffled
pages, NaN in every pool row no length reaches) and times it in turns
with the contiguous decode kernel (contiguous, paged, paged, contiguous),
and holds the segment (varlen) variants of the forward, fused, dK/dV and
dQ kernels against their plain versions (the packed source's ids at the
training shape, G = 1 and 4 at S = 700, distinct q and kv ids), checks that
all-ones ids give the unsegmented kernels' outputs bitwise, and times them
beside the unsegmented kernels, with bounds over the same-segment pairs.
Phase 3 also holds the dense-schedule kernels (forward, fused, dK/dV and
dQ, each with and without segments) against their plain versions at the
training shape and against the compact kernels to the bit (the fused dQ,
whose bulk reductions have no order, within GRAD_REL_TOL), there and on a grid of
specs at S = 700 with G = 1 and 4, and times dense and compact in turns,
with the FULL spec (no tile hidden) as the control.
Phase 3 also holds the head_dim-256 kernels (gemma3-1b: 4 q heads over one
kv head, a 512-token window on 5 of 6 layers) against their plain versions:
the forward (B 1, S 1536, causal and windowed, and ragged S), the decode
(B 4 of a 2048 cache, ragged lengths, 8 splits, G 4, with and without the
window, NaN in every row past each length, its SEG instantiation) and the
paged decode (pages of 16 and 64, two page orders, stale NaN rows, bitwise
the contiguous partials at 16), and times each beside its bound, the
forward and decode in turns with SDPA (the window as an explicit mask).
Phase 3 also holds the head_dim-160 kernels (stablelm-12b: 32 q heads over
8 kv heads, no window) the same way: the forward (B 1, S 1536 causal, the
ragged S 1500, S 260, B 2 S 333), the decode and its SEG instantiation, the
paged decode; each timed beside its bound, the forward (also at the
training shape, B 2, S 2048) and decode in turns with SDPA; then the
forward in both tile modes forced through the override (the prefill and
the training shape, with and without the packed source's ids, DENSE
bitwise compact; the split at the prefill with 2 and 3 splits, at every
corner shape and packed), each against its plain version in the same mode
and bitwise over two launches. Then the split forward in one-q-tile mode
at gemma3-1b's corner (32,768 keys) and split prefill and at stablelm-12b's
corner, 1000 launches each, every one bitwise the first
(``repeat_launches``).
After phase 6, the gemma3 serving slice: gemma3-1b at its published widths
and depth (26 layers, bf16, random weights from seed 0) serves the six
requests through both engines (the paged one preempting once) with exact
launch counts at head_dim 256 (no plain version, no reference), holds a
prefill and a B = 4 decode step against the dense reference and the step
through shuffled pages bitwise against the contiguous cache, times and
profiles both engines' ticks, and serves through the serve CLI once per
engine. Then the stablelm serving slice, the same at head_dim 160:
stablelm-12b at its published widths and depth (40 layers, 12.1 B
parameters in bf16, one card's 80 GB), exact launch counts (fixed: the
forward 240, the decode 1280; paged: the forward 280, the paged decode
1280).
Phase 3 also holds the head_dim-64 kernels at granite-moe-1b-a400m's shapes
(16 q heads over 8 kv heads, G 2) the same way, with a 512-token window
added: the forward (B 1, S 1536, S 700, B 2 S 333), the decode and its SEG
instantiation, and the paged decode's first instantiation at 64 (pages of
16 and 64, two page orders, stale NaN rows, bitwise the contiguous
partials at 16; timed in turns with the contiguous kernel). Then the
granite serving slice, as the gemma3 one: granite-moe-1b-a400m at its
published widths and depth (24 layers, an MoE layer of 32 experts top 8 in
each, 1.34 B parameters), exact launch counts at head_dim 64 (fixed: the
forward 144, the decode 24 a tick; paged: the forward 168, the paged decode
24 a tick). Its prefill and decode step are held against the dense
reference with the reference replaying the kernels' run's expert choices
(a top-8 choice flips where two router logits lie within bf16 rounding of
the attention outputs, which changes a token's output by a whole expert's
share); the free reference run's flipped (token, layer) choices and its
logits' gap are logged beside. Then the MoE checks: one layer on (4, 1,
1024) and (1, 1536, 1024) under torch.cuda.set_sync_debug_mode("error"),
and the 24 MoE layers' time at a decode tick's shape against the
engine's tick.
Phase 3 also holds the four backward kernels at head_dim 256 (gemma3-1b's
training: B 4, S 2048, 4 q heads over 1 kv head, causal and window 512;
the window at S 700, a ragged S, rows that see no key) against their plain
versions, split dK/dV bitwise the fused kernel's and over two launches and
dQ bitwise over two launches (each launch's grid and head split logged:
the causal training shape splits the group's q heads one a CTA), and times
them at the training shape beside their bounds, the fused and the whole
split backward in turns with SDPA's backward; the group-sum kernel that
adds the split's f32 dK/dV partials, bitwise its plain version, timed on
the training shape's partials (at 160 too); and every fused and dK/dV
instantiation's spill stores against the earlier design's
(``KV_SPILLS_BEFORE``). Last, the gemma3 training slice: gemma3-1b at its published widths and depth (26
layers, bf16, seed 0) trains 8 AdamW steps at B 4, S 2048 through the train
CLI's ``train`` with the fused and the split backward and once through
impl="ref"; launch counts exact (per step the forward twice in the 24
layers of the remat groups and once in the 2 tail layers, per layer delta
once, fused or dK/dV and dQ once, all at head_dim 256, and a group sum
for each of the 4 causal layers' fused or dK/dV launches), the loss must
fall and follow the reference's (the fused step beside the earlier
design's, from an earlier call); tokens/s, MFU, peak memory, the profiled
step's busy share and attention time; the split backward bitwise
reproducible at the training shape.
Phase 3 also holds the four backward kernels at head_dim 160 (stablelm-12b's
training: B 2, S 2048, 32 q heads over 8 kv heads, causal; the ragged S
1500, rows that see no key) the same way. Then the stablelm training
slice: stablelm-12b at its published widths, depth cut to 8 of 40 layers
(3.25 B parameters, one card's memory with AdamW's state), trains 8 AdamW
steps at B 2, S 2048 through ``train``
with the fused and the split backward and once through impl="ref", as the
gemma3 slice (launch counts exact: the forward twice a layer and step,
delta, fused or dK/dV and dQ once, all at head_dim 160).
Phase 3 also holds the segment (SEG) forward, fused, dK/dV and dQ kernels at
head_dim 256 (gemma3-1b's packed training shape, B 4, S 2048, causal and
window 512) and at 160 (stablelm-12b's, B 2, S 2048, causal), on the packed
source's step-0 ids, against their plain versions, with split dK/dV bitwise
the fused kernel's, dQ bitwise over two launches and all-ones ids bitwise
the unsegmented kernels, distinct q and kv ids at S 700 (zeros where a tile
sees nothing), and times each in turns with the unsegmented kernel beside
its bound over the same-segment pairs and SDPA with the block-diagonal
mask. Last, packed training: gemma3-1b (26 layers, B 4, S 2048) and
stablelm-12b (8 of 40 layers, B 2, S 2048) each train 8 AdamW steps on the
packed source through ``train(packed=True)``, with the fused and the split
backward and once through impl="ref" (the segment mask), as the unpacked
slices: launch counts exact through the segment kernels at head_dim 256 or
160 (gemma3: the segment forward 400, delta 208, fused or dK/dV and dQ 208;
stablelm: 128, 64, 64; no unsegmented kernel, no plain version), the loss
falls and follows the reference's, the split backward bitwise reproducible
on the step-0 ids; tokens/s with the non-padding share, MFU, peak memory,
the profiled step's busy share and attention time, each beside the
unpacked run's.
Phase 2 also checks that no dense instantiation at head_dim 256 and 160
(forward, fused, dK/dV, dQ; without and with SEG) spills more than its
compact twin or has its wgmma serialised. Phase 3 also holds those dense
kernels against their plain versions at gemma3-1b's training shape (B 4,
S 2048, causal and window 512) and stablelm-12b's (B 2, S 2048, causal),
without and with the packed source's step-0 ids, and to the bit against the
compact kernels there (the fused dQ, whose bulk reductions have no order,
within GRAD_REL_TOL) and on a grid of specs at B 2, S 700 (causal, window
512, a window with sinks, a non-causal window, FULL, q_offset +-100) with G
1 and 4, with and without packed ids; and times each in turns with its
compact twin beside the compact bound, its plain version and SDPA. Last,
dense-schedule training: gemma3-1b (26 layers, B 4, S 2048) and
stablelm-12b (8 of 40 layers, B 2, S 2048) each train 8 AdamW steps through
``build_train_step`` with AttentionConfig(schedule="dense"), each run beside
its compact counterpart through the same loop (split backward: every
step's loss bitwise; fused: step 0 equal, the rest within GPT_LOSS_REL;
packed split: every step bitwise), launch counts exact through the dense
kernels at head_dim 256 or 160 (gemma3: forward 400, delta 208, fused or
dK/dV and dQ 208; stablelm: 128, 64, 64) and through the compact ones in
the compact runs; the unpacked split steps profiled for the busy share and
attention's share, dense beside compact.
Phase 2 also checks that the split-KV forward's instantiations at 256 and
160 (without and with SEG) take their single-pass twins' registers, spill
no more and have no serialised wgmma. Phase 3 also holds them and their
fold against their plain version (partials and fold) and the fold against
the single pass (o also within 2e-2 of the reference's max|o|, and a
planted fault, the fold without its last split, must be rejected at the
corner shapes): 64 q rows at the last positions against gemma3-1b's 1536,
8192 and 32,768 keys (and 8192 under the 512 window: most splits see
nothing) and stablelm-12b's 1536, 4096 and 32,768 with the auto split
count, the causal prefill (B 1, S 1536) with 2 and 3 splits, the packed
training shapes with 2 and 3 splits; and times each corner shape, the
prefill and the packed shape in turns with the single pass, beside SDPA
(causal_lower_right where the mask is causal without window or ids, else
the boolean mask) and the bound of the function's own bytes, and the walk
and the fold each timed alone beside the fold's bound. Then the short-q/long-kv corner
of the public API (after phase 3): ops.flash_attention and
core.attention.attention with the default splits on those corner shapes,
launches exact (the split-KV kernel only), the auto count that of
default_kv_splits, o against the plain version and the single pass. In
the gemma3 and stablelm serving slices, after the engines' ticks and
before the serve CLI: the six prompts prefilled through model.prefill with
AttentionConfig(kv_splits=2) (launches exact: a prompt of one kv tile runs
the single pass), each prompt's logits against kv_splits=1 and the
1500-token one's against impl="ref", that prompt's split o in every layer
against the single pass on the same inputs (and a planted fault the same
limit must reject), the prefills timed in turns with
kv_splits=1, and the fixed engine over the six requests with kv_splits=2
(launches exact; the share of greedy tokens equal to the kv_splits=1
run's). Last, packed training with a split forward: gemma3-1b (26 layers,
B 4, S 2048) and the 8-layer stablelm-12b (B 2, S 2048) train 3 AdamW
steps with AttentionConfig(bwd="split", kv_splits=2), beside kv_splits=1
and again with kv_splits=2 in one loop: launches exact (the SEG split-KV
forward, no single pass), the two split runs' losses bitwise, step 0
within PARITY_LOSS_REL of kv_splits=1 and every step within GPT_LOSS_REL.
The last two lines are the kernels' JSON record and the result line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3 bandwidth
HQ, HKV, HD = 32, 8, 128  # qwen3-8b attention widths
FWD_TOL = dict(o=2e-2, lse=1e-3)  # bf16 outputs; f32 lse
DEC_TOL = dict(o=2e-2, lse=1e-3)
PROMPT_LENS = (7, 100, 700, 1500, 33, 260)
MAX_NEW = 16
CACHE = 2048
PAGE_SIZE, PAGES_PER_SEQ = 16, 128  # the paged engine's logical capacity is CACHE
# The paged engine's pool: 149 usable pages admit the first four requests
# (1 + 7 + 44 + 94 pages with one page of headroom each) and run out while
# they grow, so admission waits on pages and growth preempts the youngest
# request exactly once. The schedule depends only on lengths, not on the
# weights or the width: the port's engine on a reduced model on the CPU,
# at these prompt lengths and MAX_NEW, preempts once at 150 pages (also at
# 99 and 117) and never at 140 or 160.
PAGED_POOL_PAGES = 150
PAGED_PREEMPTIONS = 1
# Prefill launches a layer on that schedule: the admissions' batched
# prefills and the preempted request's second one (qwen3-8b's 252 forward
# launches over 36 layers, gemma3-1b's 182 over 26).
PAGED_PREFILLS = 7
SPIN_CYCLES = 1_000_000  # about 0.5 ms at the H100's clock
# Logits of flash_cuda against the dense reference at full depth (bf16):
# the first chip run read cosine 0.999744 and max|diff| 0.024 x max|logit|.
LOGIT_COS = 0.999
LOGIT_REL = 0.05
PROFILED_TICKS = 8
TICK_ROUNDS = 8  # rounds of fixed, paged, paged, fixed decode ticks
# f32 delta from bf16 O and dO, summation order only: the first chip run
# read at most 3.8e-6.
DELTA_TOL = 2e-5
# f32 gradients of the fused kernel against its plain version, relative to
# the largest |gradient|: both round P and dS to bf16 at the same places;
# what differs is summation order, the order of dq's reductions, and values
# that land one bf16 ulp apart. The first chip run read at most 7.3e-4.
GRAD_REL_TOL = 3e-3
TRAIN_B, TRAIN_S = 2, 2048  # the training step's batch
TRAIN_LAYERS, TRAIN_STEPS = 8, 8  # depth cut to one card's memory
PARITY_LAYERS, PARITY_S = 2, 1024
# One step through impl="ref" and impl="flash_cuda" from the same weights:
# relative loss difference, and per attention-parameter gradient the least
# cosine and the largest |diff| relative to max |grad|. The first chip run
# read 6.2e-6, cosine 0.999932 and 0.0139.
PARITY_LOSS_REL = 1e-4
PARITY_COS = 0.999
PARITY_REL = 0.03
# The gpt-20m preset in bf16 through the train CLI's train() (B, S, steps),
# and whisper-base training (B 8, WH_FRAMES frames, WH_CACHE tokens). Losses
# against impl="ref" (f32 attention inside, P never rounded) from the same
# weights and batches, relative: step 0 within the qwen3 phases'
# PARITY_LOSS_REL (the same weights and batch; only attention's rounding
# differs), every later step within one bf16 ulp (2^-8), the rounding the
# kernels' bf16 P carries through the AdamW updates. The first chip run
# read step 0 at 2.8e-5 (gpt-20m) and 1.4e-5 (whisper-base), and at most
# 3.9e-4 over 8 steps.
GPT_B, GPT_S, GPT_STEPS = 8, 512, 8
WH_TRAIN_B, WH_TRAIN_STEPS = 8, 8
GPT_LOSS_REL = WH_LOSS_REL = 2.0 ** -8


T0 = time.perf_counter()  # each log line carries the seconds since the start


def log(msg: str) -> None:
    print(f"[chip_smoke {time.perf_counter() - T0:7.1f} s] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"[chip_smoke {time.perf_counter() - T0:7.1f} s] FAIL: {msg}", file=sys.stderr,
          flush=True)
    sys.exit(1)


def run(main_fn) -> None:
    """``main_fn()``; an exception it raises is printed with its traceback
    and the last log line's phase to stderr, and the process ends at once
    with code 1: after a device fault, the teardown of every live CUDA
    object would print a warning of its own and bury the traceback."""
    try:
        main_fn()
    except SystemExit:
        raise
    except BaseException:  # noqa: BLE001 - reported, then the process ends
        import traceback

        sys.stdout.flush()
        print(f"[chip_smoke {time.perf_counter() - T0:7.1f} s] FAIL: an exception "
              f"ended the run:\n{traceback.format_exc()}", file=sys.stderr, flush=True)
        os._exit(1)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def time_ms(torch, fn, iters: int, flush) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, each bracketed by its
    own CUDA events after an L2 flush (the serving path finds K/V cold).
    Before each start event the card spins for about half a millisecond, so
    the host has enqueued the call before the event runs and the host's
    dispatch time stays out of the measurement."""
    fn()
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        flush()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def ptxas_summary(_build, sources) -> str:
    """One line per compiled kernel instantiation: its mangled name's
    template arguments, registers and spill bytes, from nvcc's -Xptxas -v,
    and the reason ptxas gives where it serialises the instantiation's
    wgmma instructions."""
    import re

    def pretty(mangled):  # ...fa2_fwd_kernelILi64ELi4ELb0ELb1EEEv... -> fa2_fwd_kernel<64,4,0,1>
        k = re.search(r"(fa2_\w+?kernel)I(.*?)EEv", mangled)
        if k:
            return f"{k.group(1)}<{','.join(re.findall(r'L[ib](\d+)', k.group(2)))}>"
        k = re.search(r"\d(fa2_\w+?_kernel)E", mangled)  # a kernel that is not a template
        return k.group(1) if k else mangled

    lines = []
    for src in sources:
        report = _build.report_path(src).read_text().splitlines()
        serialized = {}
        for line in report:
            m = re.search(r"wgmma.*serialized (.*?) in the function '(\S+?)'", line)
            if m:
                serialized[pretty(m.group(2))] = m.group(1)
        name = None
        for line in report:
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                name = pretty(m.group(1))
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and name:
                spills = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
                continue
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                note = f"; wgmma serialized {serialized[name]}" if name in serialized else ""
                lines.append(f"  {src}.cu {name}: {m.group(1)} registers, {spills}{note}")
                name = None
    n = sum(" wgmma serialized " in line for line in lines)
    lines.append(f"  instantiations whose wgmma ptxas serialises: {n}")
    return "\n".join(lines)


WIDE_DIMS = (160, 256)  # the head dims of fa2_fwd_wide_kernel (flash_fwd.WIDE_HEAD_DIMS)
# Registers at entry of the fold kernel (fa2_fwd_fold_kernel<D>, every D),
# as its redesign built it on the H100 machine's nvcc.
FOLD_REGISTERS = 40


def fwd_inst(D: int, seg: int, split: int, dense: int, single: int = 0) -> str:
    """The ptxas summary's name of a forward instantiation: the pair kernel
    at head_dim 64 and 128, ``fa2_fwd_wide_kernel`` at 160 and 256
    (``single``: its one-q-tile mode)."""
    if D in WIDE_DIMS:
        return f"fa2_fwd_wide_kernel<{D},{seg},{split},{dense},{single}>"
    return f"fa2_fwd_kernel<{D},{seg},{split},{dense}>"


# The forward's ptxas lines (registers at entry, spill stores, spill loads
# in bytes; NVIDIA's nvcc for sm_90a) that later designs must keep: the
# head_dim-64/128 pair kernel as the design before the wide kernels built
# it (the 160 and 256 redesigns left its body as it was), and the fold as
# its redesign built it (16-byte chunks of rows; before it: 32 registers, no
# spills). The wide kernel's parents spilled nothing, so no
# fa2_fwd_wide_kernel may.
FWD_PTXAS_BEFORE = {
    **{f"fa2_fwd_kernel<{D},{seg},{split},{dense}>":
       (168, 40, 48) if seg and dense else (168, 0, 0)
       for D in (64, 128) for seg in (0, 1) for split, dense in ((0, 0), (1, 0), (0, 1))},
    **{f"fa2_fwd_fold_kernel<{D}>": (FOLD_REGISTERS, 0, 0) for D in (64, 128, 160, 256)},
}


def fwd_ptxas_check(ptxas: str) -> None:
    """The forward's instantiations in the ptxas summary: at head_dim 64 and
    128 and the fold kernel every line as ``FWD_PTXAS_BEFORE``; at 160 and
    256 every ``fa2_fwd_wide_kernel`` (6 modes, 2 tile modes) without
    spills (serialised wgmma: ``wide_ptxas_check``)."""
    import re

    rows = {}
    for line in ptxas.splitlines():
        m = re.match(r"\s*flash_fwd\.cu (fa2_\w+<[\d,]+>): (\d+) registers, spill stores (\d+) "
                     r"B, loads (\d+) B", line)
        if m:
            rows[m.group(1)] = tuple(int(m.group(i)) for i in (2, 3, 4))
    changed = [(k, v, rows.get(k)) for k, v in FWD_PTXAS_BEFORE.items() if rows.get(k) != v]
    log(f"ptxas, the forward against the earlier builds: "
        f"{len(FWD_PTXAS_BEFORE) - len(changed)} of {len(FWD_PTXAS_BEFORE)} head_dim-64/128 "
        f"and fold lines equal")
    if changed:
        fail(f"the forward's ptxas lines changed at 64/128 or in the fold (instantiation, "
             f"before, now): {changed}")
    wide = [fwd_inst(D, seg, split, dense, one) for D in WIDE_DIMS for seg in (0, 1)
            for split, dense in ((0, 0), (1, 0), (0, 1)) for one in (0, 1)]
    missing = [k for k in wide if k not in rows]
    spilled = [(k, rows[k]) for k in wide if k in rows and rows[k][1:] != (0, 0)]
    log(f"ptxas, the head_dim-160 and -256 forward: {len(wide) - len(missing) - len(spilled)} "
        f"of {len(wide)} instantiations without spills")
    if missing or spilled:
        fail(f"ptxas reported no {missing} or they spill {spilled}")


def past_lengths(torch, x, lengths, value):
    """The cache x (B, S, Hkv, D) with ``value`` in every row at or past its
    batch row's length (``lengths`` (B,) on x's device)."""
    past = torch.arange(x.shape[1], device=x.device)[None, :] >= lengths[:, None].long()
    return x.masked_fill(past[:, :, None, None], value)


def stale_rows_check(torch, dec, what, q, k, v, lengths, **kw):
    """The decode's partials with NaN in every cache row at or past each
    length must be those with zeros there, bit for bit (rows inside a
    fetched unit that are not visible are selected away, never multiplied)."""
    zero = dec.flash_decode(q, past_lengths(torch, k, lengths, 0.0),
                            past_lengths(torch, v, lengths, 0.0), lengths, **kw)
    nan = dec.flash_decode(q, past_lengths(torch, k, lengths, float("nan")),
                           past_lengths(torch, v, lengths, float("nan")), lengths, **kw)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(zero, nan))
    log(f"{what}: partials with NaN in every row past each length bitwise those with zeros "
        f"there: {same}")
    if not same:
        fail(f"{what}: NaN in rows past the length changed the partials")


def max_err(torch, a, b) -> float:
    fin = torch.isfinite(b)
    if not torch.equal(torch.isfinite(a), fin):
        return float("inf")
    return (a.float()[fin] - b.float()[fin]).abs().max().item() if fin.any() else 0.0


def sdpa_calls(torch, q, k, v, do, mask=None, causal=True):
    """The library yardstick on the kernels' inputs (q pre-scaled, so scale
    1; GQA): SDPA's forward and its forward + backward as two calls.
    Causal (or with ``causal`` False, FULL), or with the boolean ``mask``
    (B, 1, Sq, Skv)."""
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    kw = dict(is_causal=causal) if mask is None else dict(attn_mask=mask)

    def fwd_only():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, scale=1.0, **kw)

    def fwd_bwd():
        out = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, scale=1.0, **kw)
        return torch.autograd.grad(out, (qt, kt, vt), dot)

    return fwd_only, fwd_bwd


def sdpa_times(torch, q, k, v, do, flush, mask=None):
    """SDPA's forward and its forward + backward (``sdpa_calls``), in ms."""
    fwd_only, fwd_bwd = sdpa_calls(torch, q, k, v, do, mask)
    return time_ms(torch, fwd_only, 20, flush), time_ms(torch, fwd_bwd, 20, flush)


def in_turns(torch, kernel, library, iters: int, flush):
    """``kernel`` and ``library`` timed in turns (kernel, library, library,
    kernel) on one card: (kernel ms, library ms, the four times rounded)."""
    runs = [time_ms(torch, fn, iters, flush) for fn in (kernel, library, library, kernel)]
    return (runs[0] + runs[3]) / 2, (runs[1] + runs[2]) / 2, [round(t, 4) for t in runs]


def tile_mode(fwd, B: int, Hq: int, Sq: int, D: int, ks: int = 1) -> str:
    """How the forward's grid takes this shape (``flash_fwd.single_q_tile``)."""
    t_q = -(-Sq // 64)
    if fwd.single_q_tile(B, Hq, t_q, D, ks):
        return f"one q tile a CTA, {B * Hq * t_q * ks} CTAs"
    return f"a pair of q tiles a CTA, {B * Hq * -(-t_q // 2) * ks} CTAs"


def attention_bounds(pairs: int, B: int, S: int, id_bytes: int = 0, *, Skv=None, Hq=HQ,
                     Hkv=HKV, D=HD) -> dict:
    """Roofline bounds (ms, what bounds) of the forward, fused, dK/dV and dQ
    kernels at qwen3 widths (or ``Hq``, ``Hkv``, ``D``), B x S q rows
    against ``Skv`` (default S) kv rows: ``pairs`` (q, k) pairs the mask
    needs per q head, summed over the batch; each input read once, each
    output written once (the gradients in f32), the segment ids'
    ``id_bytes``."""
    Skv = S if Skv is None else Skv
    q_bytes = B * S * Hq * D * 2
    kv_bytes = B * Skv * Hkv * D * 2
    row_bytes = B * Hq * S * 4
    in_bytes = 2 * q_bytes + 2 * kv_bytes + 2 * row_bytes + id_bytes  # q, dO, k, v, lse, delta
    return {
        "flash_fwd": bound(4 * D * pairs * Hq, 2 * q_bytes + 2 * kv_bytes + row_bytes + id_bytes),
        "flash_bwd_fused": bound(10 * D * pairs * Hq, in_bytes + 2 * q_bytes + 4 * kv_bytes),
        "flash_bwd_dkv": bound(8 * D * pairs * Hq, in_bytes + 4 * kv_bytes),
        "flash_bwd_dq": bound(6 * D * pairs * Hq, in_bytes + 2 * q_bytes),
    }


def check_fwd(torch, what, got, want):
    """max |o - plain| of a forward's (o, lse) against its plain version's,
    failing on a disagreement or on a non-finite output where the plain
    version is finite."""
    (o, lse), (o_p, lse_p) = got, want
    eo, el = max_err(torch, o, o_p), max_err(torch, lse, lse_p)
    log(f"{what}: max|o-plain|={eo:.3e} (tol {FWD_TOL['o']}), "
        f"max|lse-plain|={el:.3e} (tol {FWD_TOL['lse']})")
    if not (eo <= FWD_TOL["o"] and el <= FWD_TOL["lse"]):
        fail(f"{what} disagrees with its plain version")
    if not (torch.isfinite(o).all() and torch.equal(torch.isfinite(lse),
                                                    torch.isfinite(lse_p))):
        fail(f"{what}: a non-finite output where the plain version is finite")
    return eo


def kernel_phase(torch, dev, flush):
    import torch.nn.functional as F

    from repro_torch.core.masks import MaskSpec
    from repro_torch.kernels import flash_decode as dec
    from repro_torch.kernels import flash_fwd as fwd
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import attention_reference

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    spec = MaskSpec(causal=True)
    bq, bk = ops.BLOCK_Q, ops.BLOCK_KV
    scale = 1.0 / math.sqrt(HD)

    def fwd_inputs(B, S):
        return ops._prep(randn(B, S, HQ, HD), scale), randn(B, S, HKV, HD), randn(B, S, HKV, HD)

    fwd_err = 0.0
    # S 700 and S 64 give an odd number of q tiles (the last CTA holds one),
    # S 333 a ragged last tile of an even number.
    for B in (1, 4):
        for S in (64, 333, 700, 2048):
            q, k, v = fwd_inputs(B, S)
            fwd_err = max(fwd_err, check_fwd(
                torch, f"flash_fwd B={B} S={S} causal Hq={HQ} Hkv={HKV} D={HD}",
                fwd.flash_fwd(q, k, v, spec, block_q=bq, block_kv=bk),
                fwd.flash_fwd_plain(q, k, v, spec, block_q=bq, block_kv=bk)))
    # Rows 0-99 see no key; 64-99 sit in a q tile the CTAs visit, where the
    # kernel gives a uniform P over the tile and lse = mask + log(64), as the
    # plain version does.
    q, k, v = fwd_inputs(1, 700)
    off = MaskSpec(causal=True, q_offset=-100)
    fwd_err = max(fwd_err, check_fwd(
        torch, "flash_fwd B=1 S=700 causal q_offset=-100",
        fwd.flash_fwd(q, k, v, off, block_q=bq, block_kv=bk),
        fwd.flash_fwd_plain(q, k, v, off, block_q=bq, block_kv=bk)))
    # Segment ids that hide half a q tile: q rows 32-63 of each tile carry an
    # id no key has, so they see no key inside the tiles they visit.
    B, S = 2, 700
    q, k, v = fwd_inputs(B, S)
    kv_ids = torch.zeros((B, S), dtype=torch.int32, device=dev)
    q_ids = kv_ids.clone()
    q_ids[:, (torch.arange(S, device=dev) % bq) >= bq // 2] = 7
    fwd_err = max(fwd_err, check_fwd(
        torch, f"flash_fwd_varlen B={B} S={S} causal, ids hiding half of every q tile",
        fwd.flash_fwd_varlen(q, k, v, spec, q_ids, kv_ids, block_q=bq, block_kv=bk),
        fwd.flash_fwd_plain(q, k, v, spec, block_q=bq, block_kv=bk, q_seg=q_ids,
                            kv_seg=kv_ids)))
    # Strided views: q, k and v as head slices of one fused (B, S, Hq + 2 Hkv,
    # D) projection, read in place through their strides by the TMA maps.
    qkv = torch.cat([q, *fwd_inputs(B, S)[1:]], dim=2)
    qv, kv_, vv = qkv[:, :, :HQ], qkv[:, :, HQ:HQ + HKV], qkv[:, :, HQ + HKV:]
    if qv.is_contiguous():
        fail("the fused qkv slices should be strided views")
    fwd_err = max(fwd_err, check_fwd(
        torch, f"flash_fwd B={B} S={S} causal on strided views of a fused qkv tensor",
        fwd.flash_fwd(qv, kv_, vv, spec, block_q=bq, block_kv=bk),
        fwd.flash_fwd_plain(qv, kv_, vv, spec, block_q=bq, block_kv=bk)))

    # Decode: B=4 slots of a 2048 cache, ragged lengths including 1 and 0.
    B, S = 4, CACHE
    G = HQ // HKV
    qd = ops._prep(randn(B, 1, HQ, HD), scale)
    kc, vc = randn(B, S, HKV, HD), randn(B, S, HKV, HD)
    lens = torch.tensor([1, 0, 1337, 2048], dtype=torch.int32, device=dev)
    qh = qd.reshape(B * HKV, G, HD).contiguous()
    o_parts, lse_parts = dec.flash_decode(qh, kc, vc, lens, num_splits=8)
    torch.cuda.synchronize()
    o_pp, lse_pp = dec.flash_decode_plain(qh, kc, vc, lens, num_splits=8)
    eo, el = max_err(torch, o_parts, o_pp), max_err(torch, lse_parts, lse_pp)
    o_m, lse_m = ops.flash_decode(qd, kc, vc, lens, scale=1.0)
    log(f"flash_decode B={B} S={S} lengths={lens.tolist()} splits=8 G={G}: "
        f"partials max|o-plain|={eo:.3e} (tol {DEC_TOL['o']}), "
        f"max|lse-plain|={el:.3e} (tol {DEC_TOL['lse']})")
    if not (eo <= DEC_TOL["o"] and el <= DEC_TOL["lse"]):
        fail("flash_decode disagrees with its plain version")
    if not (o_m[1] == 0).all() or not torch.isneginf(lse_m[1]).all():
        fail("a length-0 row must give o = 0, lse = -inf after the merge")
    # The merged output of every live row against the dense oracle, the query
    # at position L - 1 (the split merge, reshape and cast run on the card).
    em = el_m = 0.0
    for b, L in enumerate(lens.tolist()):
        if L > 0:
            o_r, lse_r = attention_reference(qd[b:b + 1], kc[b:b + 1, :L], vc[b:b + 1, :L],
                                             MaskSpec(causal=True, q_offset=L - 1), scale=1.0)
            em = max(em, max_err(torch, o_m[b:b + 1], o_r))
            el_m = max(el_m, max_err(torch, lse_m[b:b + 1].flatten(), lse_r.flatten()))
    log(f"flash_decode merged vs dense reference: max|o-ref|={em:.3e} (tol {DEC_TOL['o']}), "
        f"max|lse-ref|={el_m:.3e} (tol {DEC_TOL['lse']})")
    if not (em <= DEC_TOL["o"] and el_m <= DEC_TOL["lse"]):
        fail("the merged flash_decode output disagrees with the dense reference")
    stale_rows_check(torch, dec, f"flash_decode B={B} S={S} G={G} D={HD}", qh, kc, vc, lens,
                     num_splits=8)
    dec_err = max(eo, em)

    # Timing at the serving path's shapes: the longest prefill bucket, and a
    # decode tick with the slots' lengths mid-run.
    Bf, Sf = 1, 1536
    q, k, v = fwd_inputs(Bf, Sf)
    fwd_plain_ms = time_ms(
        torch, lambda: fwd.flash_fwd_plain(q, k, v, spec, block_q=bq, block_kv=bk), 3, flush)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    fwd_ms, fwd_lib_ms, fwd_turns = in_turns(
        torch, lambda: fwd.flash_fwd(q, k, v, spec, block_q=bq, block_kv=bk),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True,
                                               scale=1.0), 20, flush)
    pairs = Sf * (Sf + 1) // 2
    fwd_bound, fwd_by = bound(
        4 * HD * pairs * Bf * HQ,
        2 * Bf * Sf * HQ * HD * 2 + 2 * Bf * Sf * HKV * HD * 2 + Bf * HQ * Sf * 4,
    )

    lens_run = torch.tensor([n + 8 for n in PROMPT_LENS[:4]], dtype=torch.int32, device=dev)
    ns, _ = dec.decode_geometry(S, 8)
    dec_plain_ms = time_ms(
        torch, lambda: dec.flash_decode_plain(qh, kc, vc, lens_run, num_splits=8), 5, flush)
    kq = kc.transpose(1, 2).contiguous()
    vq = vc.transpose(1, 2).contiguous()
    qq = qd.transpose(1, 2).contiguous()
    mask = (torch.arange(S, device=dev)[None, :] < lens_run[:, None])[:, None, None, :]
    # The kernel and SDPA in turns (kernel, sdpa, sdpa, kernel).
    dec_ms, dec_lib_ms, dec_turns = in_turns(
        torch, lambda: dec.flash_decode(qh, kc, vc, lens_run, num_splits=8),
        lambda: F.scaled_dot_product_attention(qq, kq, vq, attn_mask=mask, enable_gqa=True),
        50, flush)
    n_pos = int(lens_run.clamp(max=S).sum())
    dec_bound, dec_by = bound(
        4 * G * HD * n_pos * HKV,
        n_pos * HKV * HD * 2 * 2 + B * HQ * HD * 2 + B * HKV * ns * G * (HD + 1) * 4 + B * 4,
    )
    log(f"flash_fwd  B={Bf} S={Sf}: kernel {fwd_ms:.4f} ms, plain {fwd_plain_ms:.4f} ms, "
        f"sdpa {fwd_lib_ms:.4f} ms, bound {fwd_bound:.4f} ms ({fwd_by}); in turns (fwd, sdpa, "
        f"sdpa, fwd) {fwd_turns}: fwd / sdpa {fwd_ms / fwd_lib_ms:.4f}")
    log(f"flash_decode B={B} S={S} lengths={lens_run.tolist()}: kernel {dec_ms:.4f} ms, "
        f"plain {dec_plain_ms:.4f} ms, sdpa {dec_lib_ms:.4f} ms, "
        f"bound {dec_bound:.4f} ms ({dec_by}), {dec_ms / dec_bound:.2f}x the bound; in turns "
        f"(kernel, sdpa, sdpa, kernel) {dec_turns}: kernel / sdpa {dec_ms / dec_lib_ms:.4f}")
    return {
        "flash_fwd": dict(max_abs_err=fwd_err, ms=fwd_ms, plain_ms=fwd_plain_ms,
                          bound_ms=fwd_bound, bound_by=fwd_by, library_ms=fwd_lib_ms,
                          sdpa_ratio_in_turns=fwd_ms / fwd_lib_ms),
        "flash_decode": dict(max_abs_err=dec_err, ms=dec_ms, plain_ms=dec_plain_ms,
                             bound_ms=dec_bound, bound_by=dec_by, library_ms=dec_lib_ms,
                             sdpa_ratio_in_turns=dec_ms / dec_lib_ms),
    }


def paginate(torch, kc, table, num_pages: int):
    """Page planes (Hkv, num_pages, ps, D) holding the contiguous cache kc
    (B, n_pages * ps, Hkv, D) at the physical pages of ``table`` (B,
    n_pages); pages no row names stay zero."""
    B, n_pages = table.shape
    _, S, Hkv, D = kc.shape
    ps = S // n_pages
    planes = torch.zeros((Hkv, num_pages, ps, D), dtype=kc.dtype, device=kc.device)
    planes[:, table.long()] = kc.reshape(B, n_pages, ps, Hkv, D).permute(3, 0, 1, 2, 4)
    return planes


def shuffled_table(torch, B: int, n_pages: int, seed: int):
    """A block table (B, n_pages) int32 of distinct physical pages 1.. in a
    seeded random order (page 0 stays the null page)."""
    gen = torch.Generator().manual_seed(seed)
    return (torch.randperm(B * n_pages, generator=gen) + 1).reshape(B, n_pages).to(torch.int32)


def stale_nan(torch, planes, table, lengths, ps: int):
    """``planes`` (Hkv, P, ps, D) with NaN in every pool row that no length
    reaches: past each length inside its last page, unused pages, the null
    page."""
    live = torch.zeros(planes.shape[1:3], dtype=torch.bool, device=planes.device)
    for b, n in enumerate(lengths):
        pos = torch.arange(n, device=planes.device)
        live[table[b, pos // ps].long(), pos % ps] = True
    return planes.masked_fill(~live[None, :, :, None], float("nan"))


def paged_kernel_phase(torch, dev, flush):
    """The paged decode kernel against its plain version (page sizes 16 and
    64, G in {1, 4, 8}, ragged lengths with 0 and an odd-page length, a
    window-256/sink-4 spec, shuffled pages), bitwise invariance to the
    physical page order, (0, -inf) partials for a length-0 row, the same
    partials with NaN in every pool row no length reaches; then its time at
    the serving path's decode shape in turns with the contiguous kernel's."""
    from repro_torch.kernels import flash_decode as dec
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(2)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    B, S = 4, CACHE
    lengths = [0, 1, 700, 2048]  # 700 ends inside a page at both page sizes
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    err = 0.0
    for ps in (16, 64):
        n_pages = S // ps
        for G in (1, 4, 8):
            for window, sink in ((None, 0), (256, 4)):
                kc, vc = randn(B, S, HKV, HD), randn(B, S, HKV, HD)
                q = randn(B * HKV, G, HD)
                tables = [shuffled_table(torch, B, n_pages, seed).to(dev) for seed in (0, 1)]
                parts = []
                for table in tables:
                    kp = paginate(torch, kc, table, B * n_pages + 1)
                    vp = paginate(torch, vc, table, B * n_pages + 1)
                    table = table.clone()
                    table[0] = 0  # the length-0 slot: an all-null row
                    parts.append(dec.flash_decode_paged(q, kp, vp, lens, table, num_splits=8,
                                                        window=window, sink=sink))
                torch.cuda.synchronize()
                o_pp, lse_pp = dec.flash_decode_paged_plain(q, kp, vp, lens, table, num_splits=8,
                                                            window=window, sink=sink)
                (o, lse), (o2, lse2) = parts
                eo, el = max_err(torch, o, o_pp), max_err(torch, lse, lse_pp)
                log(f"flash_decode_paged ps={ps} G={G} window={window} sink={sink} "
                    f"lengths={lengths} splits=8: max|o-plain|={eo:.3e} (tol {DEC_TOL['o']}), "
                    f"max|lse-plain|={el:.3e} (tol {DEC_TOL['lse']})")
                if not (eo <= DEC_TOL["o"] and el <= DEC_TOL["lse"]):
                    fail(f"flash_decode_paged disagrees with its plain version at ps={ps} G={G} "
                         f"window={window}")
                if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
                    fail("flash_decode_paged changed with the physical page order")
                if not ((o[:HKV] == 0).all() and torch.isneginf(lse[:HKV]).all()):
                    fail("a length-0 row must give (o = 0, lse = -inf) partials")
                o3, lse3 = dec.flash_decode_paged(
                    q, stale_nan(torch, kp, table, lengths, ps),
                    stale_nan(torch, vp, table, lengths, ps), lens, table, num_splits=8,
                    window=window, sink=sink)
                torch.cuda.synchronize()
                if not (torch.equal(o2, o3) and torch.equal(lse2, lse3)):
                    fail("flash_decode_paged changed with NaN in pool rows no length reaches")
                err = max(err, eo)
    log("flash_decode_paged: partials bitwise equal under a second shuffle of the pages and "
        "with NaN in every pool row no length reaches, and (0, -inf) for the length-0 row, "
        "in every case")

    # Timing at the serving path's decode shape, as flash_decode is timed.
    G = HQ // HKV
    ps, n_pages = PAGE_SIZE, PAGES_PER_SEQ
    scale = 1.0 / math.sqrt(HD)
    qd = ops._prep(randn(B, 1, HQ, HD), scale)
    qh = qd.reshape(B * HKV, G, HD).contiguous()
    kc, vc = randn(B, S, HKV, HD), randn(B, S, HKV, HD)
    table = shuffled_table(torch, B, n_pages, 2).to(dev)
    kp = paginate(torch, kc, table, B * n_pages + 1)
    vp = paginate(torch, vc, table, B * n_pages + 1)
    lens_run = torch.tensor([n + 8 for n in PROMPT_LENS[:4]], dtype=torch.int32, device=dev)
    ns, _ = dec.paged_geometry(n_pages, 8)

    def paged():
        return dec.flash_decode_paged(qh, kp, vp, lens_run, table, num_splits=8)

    def contiguous():
        return dec.flash_decode(qh, kc, vc, lens_run, num_splits=8)

    # 16 pages of 16 per split cut the cache where the contiguous kernel's
    # 256-position chunks do, so the two kernels compute the same partials
    # (in 16-row units against 64-row tiles: equal up to rounding).
    (o_c, lse_c), (o_p, lse_p) = contiguous(), paged()
    eo, el = max_err(torch, o_p, o_c), max_err(torch, lse_p, lse_c)
    log(f"flash_decode_paged vs flash_decode on the same cache at the timing shape: "
        f"max|o diff|={eo:.3e} (tol {DEC_TOL['o']}), max|lse diff|={el:.3e} (tol "
        f"{DEC_TOL['lse']}); bitwise equal {torch.equal(o_c, o_p) and torch.equal(lse_c, lse_p)}")
    if not (eo <= DEC_TOL["o"] and el <= DEC_TOL["lse"]):
        fail("flash_decode_paged and flash_decode disagree on the same cache")
    # In turns: contiguous, paged, paged, contiguous.
    c_ms = [time_ms(torch, contiguous, 50, flush)]
    p_ms = [time_ms(torch, paged, 50, flush), time_ms(torch, paged, 50, flush)]
    c_ms.append(time_ms(torch, contiguous, 50, flush))
    plain_ms = time_ms(torch, lambda: dec.flash_decode_paged_plain(
        qh, kp, vp, lens_run, table, num_splits=8), 5, flush)
    n_pos = int(lens_run.sum())
    paged_bound, paged_by = bound(
        4 * G * HD * n_pos * HKV,
        n_pos * HKV * HD * 2 * 2 + B * HQ * HD * 2 + B * n_pages * 4 + B * 4
        + B * HKV * ns * G * (HD + 1) * 4,
    )
    ms = sum(p_ms) / 2
    log(f"flash_decode_paged B={B} lengths={lens_run.tolist()} {n_pages} pages of {ps} per row "
        f"(shuffled), splits {ns}: kernel {ms:.4f} ms (runs {p_ms[0]:.4f}, {p_ms[1]:.4f}), "
        f"plain {plain_ms:.4f} ms, bound {paged_bound:.4f} ms ({paged_by}), "
        f"{ms / paged_bound:.2f}x the bound; in turns (contiguous, paged, paged, contiguous) "
        f"with flash_decode at the same lengths: {c_ms[0]:.4f}, {c_ms[1]:.4f} ms, paged / "
        f"contiguous {ms / (sum(c_ms) / 2):.4f}")
    return {"flash_decode_paged": dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=paged_bound, bound_by=paged_by,
        library_ms=None, contiguous_ms_in_turns=sum(c_ms) / 2)}


def bwd_kernel_phase(torch, dev, flush):
    """The backward kernels against their plain versions (bf16 inputs, f32
    gradients), then their times, bounds and yardsticks at the training
    step's shape (B = 2, S = 2048, causal), with the forward's beside them."""
    from repro_torch.core.masks import MaskSpec
    from repro_torch.kernels import flash_bwd as bwd
    from repro_torch.kernels import flash_fwd as fwd
    from repro_torch.kernels import ops
    from repro_torch.kernels.schedule import build_kv_tile_schedule

    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    bq, bk = ops.BLOCK_Q, ops.BLOCK_KV
    scale = 1.0 / math.sqrt(HD)

    def inputs(B, S, spec):
        q = ops._prep(randn(B, S, HQ, HD), scale)
        k, v, do = randn(B, S, HKV, HD), randn(B, S, HKV, HD), randn(B, S, HQ, HD)
        o, lse = fwd.flash_fwd(q, k, v, spec, block_q=bq, block_kv=bk)
        return q, k, v, do, o, lse

    cases = [(B, S, MaskSpec(causal=True)) for B in (1, 2) for S in (64, 700, 2048)]
    cases += [(1, 1000, MaskSpec(causal=True, window=256, sink=4)),
              # rows 0-127 see no key: two whole q tiles no CTA visits
              (1, 700, MaskSpec(causal=True, q_offset=-128)),
              # rows 0-99 see no key, 64-99 in a q tile the CTAs visit: their
              # lse is the finite mask value and their P is 1, as in the plain
              # version
              (1, 700, MaskSpec(causal=True, q_offset=-100))]
    delta_err = grad_err = dkv_err = dq_err = 0.0
    tiles = dict(block_q=bq, block_kv=bk)

    def rel_errs(kernel, names, got, want):
        """{name: (max |got - want|, max |want|)}; fails on a non-finite
        gradient."""
        errs = {}
        for name, a, b in zip(names, got, want):
            if not torch.isfinite(a).all():
                fail(f"{kernel} gave a non-finite {name} at B={B} S={S} {spec}")
            errs[name] = (max_err(torch, a, b), b.abs().max().item())
        return errs

    def worst(errs):
        return max(e / max(top, 1e-6) for e, top in errs.values())

    for B, S, spec in cases:
        q, k, v, do, o, lse = inputs(B, S, spec)
        delta = bwd.flash_bwd_delta(o, do)
        args = (q, k, v, do, lse, delta, spec)
        got = bwd.flash_bwd_fused(*args, **tiles)
        dq_f2 = bwd.flash_bwd_fused(*args, **tiles)[0]
        dk, dv = bwd.flash_bwd_dkv(*args, **tiles)
        dq = bwd.flash_bwd_dq(*args, **tiles)
        dq2 = bwd.flash_bwd_dq(*args, **tiles)
        torch.cuda.synchronize()
        ed = max_err(torch, delta, bwd.flash_bwd_delta_plain(o, do))
        errs = rel_errs("flash_bwd_fused", ("dq", "dk", "dv"), got,
                        bwd.flash_bwd_fused_plain(*args, **tiles))
        split = rel_errs("the split backward", ("dq", "dk", "dv"), (dq, dk, dv),
                         (bwd.flash_bwd_dq_plain(*args, **tiles),
                          *bwd.flash_bwd_dkv_plain(*args, **tiles)))
        rel, rel_split = worst(errs), worst(split)
        log(f"flash_bwd B={B} S={S} {spec} Hq={HQ} Hkv={HKV} D={HD}: "
            f"max|delta-plain|={ed:.3e} (tol {DELTA_TOL}); fused: "
            + ", ".join(f"max|{n}-plain|={e:.3e} (max|{n}| {top:.3f})"
                        for n, (e, top) in errs.items())
            + f"; worst relative {rel:.3e} (tol {GRAD_REL_TOL})")
        log(f"  split (flash_bwd_dkv, flash_bwd_dq): "
            + ", ".join(f"max|{n}-plain|={e:.3e}" for n, (e, _) in split.items())
            + f"; worst relative {rel_split:.3e} (tol {GRAD_REL_TOL}); dk, dv bitwise the "
            f"fused kernel's: {torch.equal(dk, got[1])}, {torch.equal(dv, got[2])}; dq of two "
            f"split launches bitwise equal: {torch.equal(dq, dq2)}; dq elements that differ "
            f"between two fused launches: {int((got[0] != dq_f2).sum())} of {dq.numel()}")
        if not ed <= DELTA_TOL:
            fail(f"flash_bwd_delta disagrees with its plain version at B={B} S={S}")
        if not rel <= GRAD_REL_TOL:
            fail(f"flash_bwd_fused disagrees with its plain version at B={B} S={S} {spec}")
        if not rel_split <= GRAD_REL_TOL:
            fail(f"flash_bwd_dkv or flash_bwd_dq disagrees with its plain version at B={B} "
                 f"S={S} {spec}")
        if not (torch.equal(dk, got[1]) and torch.equal(dv, got[2])):
            fail(f"the split dk, dv are not bitwise the fused kernel's at B={B} S={S} {spec}")
        if not torch.equal(dq, dq2):
            fail(f"two launches of flash_bwd_dq gave different dq at B={B} S={S} {spec}")
        unseen = max(-spec.q_offset, 0) // bq * bq  # rows of whole q tiles that see nothing
        if not ((got[0][:, :unseen] == 0).all() and (dq[:, :unseen] == 0).all()):
            fail("q tiles that see no key must get dq = 0")
        delta_err = max(delta_err, ed)
        grad_err = max(grad_err, max(e for e, _ in errs.values()))
        dkv_err = max(dkv_err, split["dk"][0], split["dv"][0])
        dq_err = max(dq_err, split["dq"][0])

    # Timing at the training step's shape.
    B, S = TRAIN_B, TRAIN_S
    spec = MaskSpec(causal=True)
    q, k, v, do, o, lse = inputs(B, S, spec)
    delta = bwd.flash_bwd_delta(o, do)
    fwd_plain_ms = time_ms(
        torch, lambda: fwd.flash_fwd_plain(q, k, v, spec, block_q=bq, block_kv=bk), 3, flush)
    # The forward and SDPA's forward in turns (fwd, sdpa, sdpa, fwd).
    fwd_ms, fwd_lib_ms, fwd_turns = in_turns(
        torch, lambda: fwd.flash_fwd(q, k, v, spec, block_q=bq, block_kv=bk),
        sdpa_calls(torch, q, k, v, do)[0], 20, flush)
    delta_ms = time_ms(torch, lambda: bwd.flash_bwd_delta(o, do), 50, flush)
    delta_plain_ms = time_ms(torch, lambda: bwd.flash_bwd_delta_plain(o, do), 20, flush)
    args = (q, k, v, do, lse, delta, spec)
    # The fused kernel and the library's backward (SDPA forward + backward
    # less its forward) in turns: fused, SDPA fwd+bwd, SDPA fwd, SDPA fwd,
    # SDPA fwd+bwd, fused; dK/dV beside them.
    sdpa_fwd, sdpa_fwd_bwd = sdpa_calls(torch, q, k, v, do)

    def split_total():
        d = bwd.flash_bwd_delta(o, do)
        bwd.flash_bwd_dkv(q, k, v, do, lse, d, spec, **tiles)
        bwd.flash_bwd_dq(q, k, v, do, lse, d, spec, **tiles)

    # The whole split backward (delta, dK/dV, dQ) in the same turns.
    calls = {"fused": lambda: bwd.flash_bwd_fused(*args, **tiles), "sdpa": sdpa_fwd_bwd,
             "sdpa_fwd": sdpa_fwd, "split": split_total}
    turns = {name: [] for name in calls}
    for name in ("fused", "split", "sdpa", "sdpa_fwd", "sdpa_fwd", "sdpa", "split", "fused"):
        turns[name].append(time_ms(torch, calls[name], 20, flush))
    fused_ms, lib_fb_ms, lib_fwd_ms, split_sdpa_ms = (
        sum(turns[n]) / 2 for n in ("fused", "sdpa", "sdpa_fwd", "split"))
    lib_bwd_ms = lib_fb_ms - lib_fwd_ms
    fused_plain_ms = time_ms(torch, lambda: bwd.flash_bwd_fused_plain(*args, **tiles), 3, flush)
    # The same launch with dQ's staging and bulk reduction left out (dS K is
    # still computed): what adding dQ into the f32 buffer costs.
    no_reduce_ms = time_ms(torch, lambda: bwd._launch_fused(
        q, k, v, do, lse, delta, spec, bq, bk, None), 20, flush)
    dkv_ms = time_ms(torch, lambda: bwd.flash_bwd_dkv(*args, **tiles), 20, flush)
    dq_ms = time_ms(torch, lambda: bwd.flash_bwd_dq(*args, **tiles), 20, flush)
    dkv_plain_ms = time_ms(torch, lambda: bwd.flash_bwd_dkv_plain(*args, **tiles), 3, flush)
    dq_plain_ms = time_ms(torch, lambda: bwd.flash_bwd_dq_plain(*args, **tiles), 3, flush)

    def fused_total():
        d = bwd.flash_bwd_delta(o, do)
        bwd.flash_bwd_fused(q, k, v, do, lse, d, spec, **tiles)

    # In turns: fused, split, split, fused.
    totals = {"fused": [], "split": []}
    for name in ("fused", "split", "split", "fused"):
        totals[name].append(time_ms(torch, fused_total if name == "fused" else split_total,
                                    20, flush))
    fused_total_ms, split_total_ms = (sum(totals[n]) / 2 for n in ("fused", "split"))
    # Bounds: the causal pairs the mask needs (S (S + 1) / 2 per head); the
    # kernels compute the diagonal tiles whole, as the schedule's count says.
    pairs = S * (S + 1) // 2
    n_vis = int(build_kv_tile_schedule(spec, -(-S // bq), -(-S // bk), bq, bk, S).row_ptr[-1])
    bounds = attention_bounds(pairs * B, B, S)
    (fwd_bound, fwd_by), (fused_bound, fused_by) = bounds["flash_fwd"], bounds["flash_bwd_fused"]
    (dkv_bound, dkv_by), (dq_bound, dq_by) = bounds["flash_bwd_dkv"], bounds["flash_bwd_dq"]
    # delta reads O and dO and writes a row's f32.
    delta_bound, delta_by = bound(2 * B * S * HQ * HD, 2 * B * S * HQ * HD * 2 + B * HQ * S * 4)
    log(f"training shape B={B} S={S} causal: {pairs} visible (q, k) pairs per head; the "
        f"schedule visits {n_vis} tiles of {bq}x{bk} = {n_vis * bq * bk} pairs "
        f"({n_vis * bq * bk / pairs:.4f}x)")
    log(f"flash_fwd  B={B} S={S}: kernel {fwd_ms:.4f} ms, plain {fwd_plain_ms:.4f} ms, "
        f"sdpa fwd {fwd_lib_ms:.4f} ms, bound {fwd_bound:.4f} ms ({fwd_by}); in turns (fwd, "
        f"sdpa fwd, sdpa fwd, fwd) {fwd_turns}: fwd / sdpa fwd {fwd_ms / fwd_lib_ms:.4f}")
    log(f"flash_bwd_delta B={B} S={S}: kernel {delta_ms:.4f} ms, plain "
        f"{delta_plain_ms:.4f} ms, bound {delta_bound:.4f} ms ({delta_by}), "
        f"{delta_ms / delta_bound:.2f}x the bound")
    log(f"flash_bwd_fused B={B} S={S}: kernel {fused_ms:.4f} ms, plain "
        f"{fused_plain_ms:.4f} ms, sdpa backward {lib_bwd_ms:.4f} ms (fwd+bwd "
        f"{lib_fb_ms:.4f} less fwd {lib_fwd_ms:.4f}), bound {fused_bound:.4f} ms ({fused_by}); "
        f"delta + fused {delta_ms + fused_ms:.4f} ms")
    log(f"in turns (fused, split, sdpa, sdpa fwd, sdpa fwd, sdpa, split, fused), B={B} "
        f"S={S}: fused {turns['fused'][0]:.4f}, {turns['fused'][1]:.4f} ms; split (delta + dkv "
        f"+ dq) {turns['split'][0]:.4f}, {turns['split'][1]:.4f} ms; sdpa fwd+bwd "
        f"{turns['sdpa'][0]:.4f}, {turns['sdpa'][1]:.4f} ms; sdpa fwd "
        f"{turns['sdpa_fwd'][0]:.4f}, {turns['sdpa_fwd'][1]:.4f} ms; fused / sdpa backward "
        f"{fused_ms / lib_bwd_ms:.4f}; flash_bwd_dkv beside them {dkv_ms:.4f} ms "
        f"({dkv_ms / lib_bwd_ms:.4f} of sdpa's backward)")
    log(f"flash_bwd_fused without dQ's staging and bulk reduction: {no_reduce_ms:.4f} ms; "
        f"adding dQ into dq (and the dq memset) takes {fused_ms - no_reduce_ms:.4f} ms, "
        f"{(fused_ms - no_reduce_ms) / fused_ms:.3f} of the kernel's time")
    log(f"flash_bwd_dkv B={B} S={S}: kernel {dkv_ms:.4f} ms, plain {dkv_plain_ms:.4f} ms, "
        f"bound {dkv_bound:.4f} ms ({dkv_by}); library none (no one PyTorch call gives dK, dV "
        f"alone)")
    log(f"flash_bwd_dq B={B} S={S}: kernel {dq_ms:.4f} ms, plain {dq_plain_ms:.4f} ms, "
        f"bound {dq_bound:.4f} ms ({dq_by}), {dq_ms / dq_bound:.2f}x the bound; library none "
        f"(no one PyTorch call gives dQ alone); information: the split backward (delta + dkv + "
        f"dq) {split_sdpa_ms:.4f} ms against sdpa's backward {lib_bwd_ms:.4f} ms in the same "
        f"turns, {split_sdpa_ms / lib_bwd_ms:.4f}x")
    log(f"backward totals in turns (fused, split, split, fused), B={B} S={S}: delta + fused "
        f"{fused_total_ms:.4f} ms (runs {totals['fused'][0]:.4f}, {totals['fused'][1]:.4f}), "
        f"delta + dkv + dq (split) {split_total_ms:.4f} ms (runs {totals['split'][0]:.4f}, "
        f"{totals['split'][1]:.4f}), split / fused {split_total_ms / fused_total_ms:.4f}; "
        f"sdpa backward {lib_bwd_ms:.4f} ms")
    return {
        "flash_bwd_delta": dict(max_abs_err=delta_err, ms=delta_ms, plain_ms=delta_plain_ms,
                                bound_ms=delta_bound, bound_by=delta_by, library_ms=None),
        "flash_bwd_fused": dict(max_abs_err=grad_err, ms=fused_ms, plain_ms=fused_plain_ms,
                                bound_ms=fused_bound, bound_by=fused_by, library_ms=lib_bwd_ms,
                                no_dq_reduce_ms=no_reduce_ms,
                                sdpa_ratio_in_turns=fused_ms / lib_bwd_ms,
                                with_delta_ms_in_turns=fused_total_ms),
        "flash_bwd_dkv": dict(max_abs_err=dkv_err, ms=dkv_ms, plain_ms=dkv_plain_ms,
                              bound_ms=dkv_bound, bound_by=dkv_by, library_ms=None),
        "flash_bwd_dq": dict(max_abs_err=dq_err, ms=dq_ms, plain_ms=dq_plain_ms,
                             bound_ms=dq_bound, bound_by=dq_by, library_ms=None,
                             split_total_ms_in_turns=split_total_ms,
                             split_backward_sdpa_ratio_in_turns=split_sdpa_ms / lib_bwd_ms),
        "flash_fwd_at_training_shape": dict(ms=fwd_ms, plain_ms=fwd_plain_ms,
                                            bound_ms=fwd_bound, bound_by=fwd_by,
                                            library_ms=fwd_lib_ms,
                                            sdpa_ratio_in_turns=fwd_ms / fwd_lib_ms),
    }


def segment_pairs(ids, window=None) -> int:
    """Same-segment causal (q, k) pairs of a (B, S) id array: the sum over
    the runs of equal ids of L (L + 1) / 2 (padding is a run too: it attends
    itself); with a ``window``, of the pairs less than ``window`` apart."""
    import numpy as np

    total = 0
    for row in np.asarray(ids):
        cuts = np.flatnonzero(np.diff(row)) + 1
        L = np.diff(np.concatenate([[0], cuts, [len(row)]]))
        if window is None:
            total += int((L * (L + 1) // 2).sum())
        else:
            total += sum(causal_pairs(int(n), window) for n in L)
    return total


def packed_ids(B: int, S: int, step: int = 0, vocab: int = 151_936):
    """The packed source's segment ids (numpy, (B, S) int32) at a step:
    SyntheticVarlenLM with seed 0 at ``vocab`` (default qwen3-8b's)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticVarlenLM

    src = SyntheticVarlenLM(DataConfig(B, S, vocab, seed=0, source="packed"))
    return src.batch(step)["segment_ids"]


def distinct_ids(torch, dev, B: int, S: int, hidden: int = 64):
    """q and kv ids (B, S) that differ: two halves of ids 1 and 2, q rows
    0 .. hidden - 1 an id no key has (64: a whole q tile sees nothing), the
    last 64 keys an id no query has (their kv tile gets zero dK and dV)."""
    q_seg = torch.ones((B, S), dtype=torch.int32)
    q_seg[:, S // 2:] = 2
    kv_seg = q_seg.clone()
    q_seg[:, :hidden] = 7
    kv_seg[:, -64:] = 9
    return q_seg.to(dev), kv_seg.to(dev)


def segment_mask(torch, ids):
    """The block-diagonal causal boolean mask (B, 1, S, S) of (B, S) ids."""
    S = ids.shape[1]
    causal = torch.ones((S, S), dtype=torch.bool, device=ids.device).tril()
    return ((ids[:, :, None] == ids[:, None, :]) & causal)[:, None]


def step_shares(torch, ids, S: int):
    """(active share, uniform share of the active steps) of the causal
    q-major schedule's visible steps for (B, S) segment ids."""
    from repro_torch.core.masks import MaskSpec
    from repro_torch.kernels import ops
    from repro_torch.kernels.schedule import build_q_tile_schedule, segment_step_bits

    bq, bk = ops.BLOCK_Q, ops.BLOCK_KV
    sched = build_q_tile_schedule(MaskSpec(causal=True), -(-S // bq), -(-S // bk), bq, bk, S)
    ids = torch.as_tensor(ids)
    bits = segment_step_bits(ids, ids, sched, bq, bk, kv_major=False)
    active = (bits & 1).bool()
    return active.float().mean().item(), ((bits & 2).bool() & active).sum().item() / max(
        active.sum().item(), 1)


def varlen_kernel_phase(torch, dev, flush):
    """The segment (SEG) variants of the forward, fused, dK/dV and dQ
    kernels against their plain versions at the training shape (B = 2,
    S = 2048, causal) with the packed source's step-0 ids, at S = 700 with
    G = 1 and G = 4, and with distinct q and kv ids where a q tile sees
    nothing; the invariants (all-ones ids bitwise the unsegmented kernels,
    split dK/dV bitwise the fused kernel's, split dQ bitwise over two
    launches); then times beside the unsegmented kernels in this call, the
    plain versions, the bounds over the same-segment causal pairs and SDPA
    with the block-diagonal causal mask (forward, forward + backward)."""
    from repro_torch.core.masks import MaskSpec
    from repro_torch.kernels import flash_bwd as bwd
    from repro_torch.kernels import flash_fwd as fwd
    from repro_torch.kernels import ops
    from repro_torch.kernels.schedule import device_schedule, segment_step_bits

    gen = torch.Generator(device=dev).manual_seed(7)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    bq, bk = ops.BLOCK_Q, ops.BLOCK_KV
    tiles = dict(block_q=bq, block_kv=bk)
    scale = 1.0 / math.sqrt(HD)
    spec = MaskSpec(causal=True)

    def inputs(B, S, Hq, Hkv):
        q = ops._prep(randn(B, S, Hq, HD), scale)
        return q, randn(B, S, Hkv, HD), randn(B, S, Hkv, HD), randn(B, S, Hq, HD)

    def run(q, k, v, do, q_seg, kv_seg):
        o, lse = fwd.flash_fwd_varlen(q, k, v, spec, q_seg, kv_seg, **tiles)
        delta = bwd.flash_bwd_delta(o, do)
        args = (q, k, v, do, lse, delta, spec, q_seg, kv_seg)
        fused = bwd.flash_bwd_fused_varlen(*args, **tiles)
        dkv = bwd.flash_bwd_dkv_varlen(*args, **tiles)
        dq = bwd.flash_bwd_dq_varlen(*args, **tiles)
        dq2 = bwd.flash_bwd_dq_varlen(*args, **tiles)
        torch.cuda.synchronize()
        return o, lse, delta, fused, dkv, dq, dq2

    B, S = TRAIN_B, TRAIN_S
    ids = torch.from_numpy(packed_ids(B, S)).to(dev)
    ids700 = torch.from_numpy(packed_ids(2, 700)).to(dev)
    cases = [(B, S, HQ, HKV, ids, ids, "packed step 0"),
             (2, 700, HKV, HKV, ids700, ids700, "packed, G=1"),
             (2, 700, HQ, HKV, ids700, ids700, "packed, G=4"),
             (2, 700, HQ, HKV, *distinct_ids(torch, dev, 2, 700), "distinct q/kv ids"),
             # q rows 0-31 see no key in a tile the CTAs visit (lse = the
             # finite mask value)
             (2, 700, HQ, HKV, *distinct_ids(torch, dev, 2, 700, 32),
              "half a q tile hidden")]
    err = dict(fwd=0.0, fused=0.0, dkv=0.0, dq=0.0)
    for Bc, Sc, Hq, Hkv, q_seg, kv_seg, what in cases:
        q, k, v, do = inputs(Bc, Sc, Hq, Hkv)
        o, lse, delta, fused, (dk, dv), dq, dq2 = run(q, k, v, do, q_seg, kv_seg)
        plain = dict(q_seg=q_seg, kv_seg=kv_seg, **tiles)
        args = (q, k, v, do, lse, delta, spec)
        o_p, lse_p = fwd.flash_fwd_plain(q, k, v, spec, **plain)
        eo, el = max_err(torch, o, o_p), max_err(torch, lse, lse_p)
        want = bwd.flash_bwd_fused_plain(*args, **plain)
        want_dkv = bwd.flash_bwd_dkv_plain(*args, **plain)
        want_dq = bwd.flash_bwd_dq_plain(*args, **plain)
        rel = {}
        for name, got_t, want_t in (("fused dq", fused[0], want[0]), ("fused dk", fused[1], want[1]),
                                    ("fused dv", fused[2], want[2]), ("dkv dk", dk, want_dkv[0]),
                                    ("dkv dv", dv, want_dkv[1]), ("dq", dq, want_dq)):
            if not torch.isfinite(got_t).all():
                fail(f"a varlen kernel gave a non-finite {name} ({what})")
            rel[name] = max_err(torch, got_t, want_t) / max(want_t.abs().max().item(), 1e-6)
        bit_dkv = torch.equal(dk, fused[1]) and torch.equal(dv, fused[2])
        bit_dq = torch.equal(dq, dq2)
        log(f"varlen kernels B={Bc} S={Sc} causal Hq={Hq} Hkv={Hkv} ({what}): flash_fwd_varlen "
            f"max|o-plain|={eo:.3e} (tol {FWD_TOL['o']}), max|lse-plain|={el:.3e} (tol "
            f"{FWD_TOL['lse']}); relative to max|grad|: "
            + ", ".join(f"{n} {e:.3e}" for n, e in rel.items())
            + f" (tol {GRAD_REL_TOL}); split dk, dv bitwise the fused kernel's: {bit_dkv}; "
            f"split dq bitwise over two launches: {bit_dq}")
        if not (eo <= FWD_TOL["o"] and el <= FWD_TOL["lse"]):
            fail(f"flash_fwd_varlen disagrees with its plain version ({what})")
        if max(rel.values()) > GRAD_REL_TOL:
            fail(f"a varlen backward kernel disagrees with its plain version ({what})")
        if not (bit_dkv and bit_dq):
            fail(f"the varlen split backward lost a bitwise invariant ({what})")
        if what.startswith("distinct"):
            zeros = ((o[:, :64] == 0).all() and torch.isneginf(lse[..., :64]).all()
                     and (fused[0][:, :64] == 0).all() and (dq[:, :64] == 0).all()
                     and (dk[:, -64:] == 0).all() and (dv[:, -64:] == 0).all())
            log(f"  distinct ids: q tile 0 gives o = 0, lse = -inf, dq = 0 and the last kv "
                f"tile dk = dv = 0: {bool(zeros)}")
            if not zeros:
                fail("a tile that sees nothing must give o = 0, lse = -inf and zero gradients")
        err["fwd"] = max(err["fwd"], eo)
        err["fused"] = max(err["fused"], *(max_err(torch, a, b) for a, b in zip(fused, want)))
        err["dkv"] = max(err["dkv"], max_err(torch, dk, want_dkv[0]),
                         max_err(torch, dv, want_dkv[1]))
        err["dq"] = max(err["dq"], max_err(torch, dq, want_dq))

    # All-ones ids at the training shape: bitwise the unsegmented kernels.
    q, k, v, do = inputs(B, S, HQ, HKV)
    ones = torch.ones((B, S), dtype=torch.int32, device=dev)
    o, lse = fwd.flash_fwd(q, k, v, spec, **tiles)
    o1, lse1, delta, fused1, (dk1, dv1), dq1, _ = run(q, k, v, do, ones, ones)
    args = (q, k, v, do, lse, delta, spec)
    _, dk_f, dv_f = bwd.flash_bwd_fused(*args, **tiles)
    dk, dv = bwd.flash_bwd_dkv(*args, **tiles)
    dq = bwd.flash_bwd_dq(*args, **tiles)
    torch.cuda.synchronize()
    same = {"o": torch.equal(o, o1), "lse": torch.equal(lse, lse1),
            "fused dk": torch.equal(dk_f, fused1[1]), "fused dv": torch.equal(dv_f, fused1[2]),
            "dkv dk": torch.equal(dk, dk1), "dkv dv": torch.equal(dv, dv1),
            "dq": torch.equal(dq, dq1)}
    log(f"all-ones ids at B={B} S={S}, bitwise the unsegmented kernels (the fused dq's "
        f"reductions reorder from launch to launch; dq is the split kernel's): {same}")
    if not all(same.values()):
        fail("all-ones segment ids do not give the unsegmented kernels' outputs bitwise")

    # Times at the training shape with the packed source's step-0 ids.
    q, k, v, do = inputs(B, S, HQ, HKV)
    o, lse = fwd.flash_fwd_varlen(q, k, v, spec, ids, ids, **tiles)
    delta = bwd.flash_bwd_delta(o, do)
    seg_args = (q, k, v, do, lse, delta, spec, ids, ids)
    full_args = seg_args[:7]
    kernels = {
        "flash_fwd": (lambda: fwd.flash_fwd_varlen(q, k, v, spec, ids, ids, **tiles),
                      lambda: fwd.flash_fwd(q, k, v, spec, **tiles)),
        "flash_bwd_fused": (lambda: bwd.flash_bwd_fused_varlen(*seg_args, **tiles),
                            lambda: bwd.flash_bwd_fused(*full_args, **tiles)),
        "flash_bwd_dkv": (lambda: bwd.flash_bwd_dkv_varlen(*seg_args, **tiles),
                          lambda: bwd.flash_bwd_dkv(*full_args, **tiles)),
        "flash_bwd_dq": (lambda: bwd.flash_bwd_dq_varlen(*seg_args, **tiles),
                         lambda: bwd.flash_bwd_dq(*full_args, **tiles)),
    }
    times = {}
    for name, (seg_fn, full_fn) in kernels.items():  # in turns: seg, full, full, seg
        runs = [time_ms(torch, f, 20, flush) for f in (seg_fn, full_fn, full_fn, seg_fn)]
        times[name] = ((runs[0] + runs[3]) / 2, (runs[1] + runs[2]) / 2)
    # What the segment path adds per step: all-ones ids (every step active,
    # the element mask only where the unsegmented kernel applies it) in
    # turns with the unsegmented kernel; and the step bits' own device time
    # (the wrappers remember them per ids, so a training step pays them once
    # per orientation, not at every launch).
    ones = torch.ones((B, S), dtype=torch.int32, device=dev)
    ones_args = (*full_args, ones, ones)
    same_work = {}
    for name, seg_fn, full_fn in (
            ("flash_fwd", lambda: fwd.flash_fwd_varlen(q, k, v, spec, ones, ones, **tiles),
             kernels["flash_fwd"][1]),
            ("flash_bwd_fused", lambda: bwd.flash_bwd_fused_varlen(*ones_args, **tiles),
             kernels["flash_bwd_fused"][1])):
        runs = [time_ms(torch, f, 20, flush) for f in (seg_fn, full_fn, full_fn, seg_fn)]
        same_work[name] = ((runs[0] + runs[3]) / 2, (runs[1] + runs[2]) / 2)
        log(f"{name}_varlen with all-ones ids (every step active) at B={B} S={S}: "
            f"{same_work[name][0]:.4f} ms against the unsegmented kernel's "
            f"{same_work[name][1]:.4f} ms in turns (ratio "
            f"{same_work[name][0] / same_work[name][1]:.4f})")
    sched_q = device_schedule(spec, S // bq, S // bk, bq, bk, S, False, str(dev))
    sched_kv = device_schedule(spec, S // bq, S // bk, bq, bk, S, True, str(dev))
    bits_ms = [time_ms(torch, lambda: segment_step_bits(ids, ids, sc, bq, bk, kv_major), 50,
                       flush) for sc, kv_major in ((sched_q, False), (sched_kv, True))]
    log(f"segment_step_bits alone at B={B} S={S} (a few torch ops on the device): q-major "
        f"{bits_ms[0]:.4f} ms, kv-major {bits_ms[1]:.4f} ms")
    plain = dict(q_seg=ids, kv_seg=ids, **tiles)
    plain_ms = {
        "flash_fwd": time_ms(torch, lambda: fwd.flash_fwd_plain(q, k, v, spec, **plain), 3, flush),
        "flash_bwd_fused": time_ms(torch, lambda: bwd.flash_bwd_fused_plain(
            *full_args, **plain), 3, flush),
        "flash_bwd_dkv": time_ms(torch, lambda: bwd.flash_bwd_dkv_plain(*full_args, **plain), 3,
                                 flush),
        "flash_bwd_dq": time_ms(torch, lambda: bwd.flash_bwd_dq_plain(*full_args, **plain), 3,
                                flush),
    }
    # Yardstick: SDPA with the block-diagonal causal boolean mask (B, 1, S, S).
    lib_fwd_ms, lib_fb_ms = sdpa_times(torch, q, k, v, do, flush, segment_mask(torch, ids))
    # Bounds over the same-segment causal pairs this batch needs.
    pairs = segment_pairs(ids.cpu().numpy())
    full_pairs = B * S * (S + 1) // 2
    bounds = attention_bounds(pairs, B, S, id_bytes=2 * B * S * 4)
    active, uniform = step_shares(torch, ids.cpu(), S)
    log(f"packed step 0 at B={B} S={S}: documents per row {[int(r.max()) for r in ids]}, "
        f"padding {int((ids == 0).sum())} positions; same-segment causal pairs {pairs} of "
        f"{full_pairs} causal pairs ({pairs / full_pairs:.4f}); active steps {active:.4f} of the "
        f"causal schedule's visible steps, uniform {uniform:.4f} of the active ones")
    library = {"flash_fwd": lib_fwd_ms, "flash_bwd_fused": lib_fb_ms - lib_fwd_ms,
               "flash_bwd_dkv": None, "flash_bwd_dq": None}
    out = {}
    for name in kernels:
        seg_ms, full_ms = times[name]
        b_ms, b_by = bounds[name]
        log(f"{name}_varlen B={B} S={S} (packed step 0): kernel {seg_ms:.4f} ms, the "
            f"unsegmented kernel in turns {full_ms:.4f} ms (ratio {seg_ms / full_ms:.4f}), "
            f"plain {plain_ms[name]:.4f} ms, bound {b_ms:.4f} ms ({b_by}), library "
            + (f"{library[name]:.4f} ms" if library[name] is not None else "none"))
        key = {"flash_fwd": "fwd", "flash_bwd_fused": "fused", "flash_bwd_dkv": "dkv",
               "flash_bwd_dq": "dq"}[name]
        out[f"{name}_varlen"] = dict(
            max_abs_err=err[key], ms=seg_ms, plain_ms=plain_ms[name], bound_ms=b_ms,
            bound_by=b_by, library_ms=library[name], unsegmented_ms_same_call=full_ms,
            active_share=active, uniform_share=uniform)
    for name, (seg_ms, full_ms) in same_work.items():
        out[f"{name}_varlen"].update(all_ones_ms=seg_ms, all_ones_unsegmented_ms=full_ms)
    out["flash_fwd_varlen"]["step_bits_ms"] = bits_ms[0]
    out["flash_bwd_fused_varlen"]["step_bits_ms"] = bits_ms[1]
    log(f"sdpa with the block-diagonal causal mask: forward {lib_fwd_ms:.4f} ms, forward + "
        f"backward {lib_fb_ms:.4f} ms")
    return out


# The dense phase's spec grid (S = 700, G = 1 and 4): causal, a window, a
# window with sinks, a non-causal window, no mask, a positive q offset, a
# negative one off the tile grid (rows that see no key in a visited tile).
# Dense against compact at B 2, S 700 (11 q tiles: the pair kernels' last CTA
# holds one): causal, windows of 256 and gemma3-1b's 512, a window with
# sinks, a non-causal window, FULL, q_offset of either sign (-100: rows that
# see no key inside a visited tile).
DENSE_SPECS = (dict(causal=True), dict(causal=True, window=256), dict(causal=True, window=512),
               dict(causal=True, window=256, sink=4), dict(causal=False, window=256), dict(),
               dict(causal=True, q_offset=100), dict(causal=True, q_offset=-100))
DENSE_NAMES = ("flash_fwd", "flash_bwd_fused", "flash_bwd_dkv", "flash_bwd_dq")


def dense_wrappers(seg):
    """{name: wrapper} of DENSE_NAMES, their ``_varlen`` forms with ``seg``."""
    from repro_torch.kernels import flash_bwd as bwd
    from repro_torch.kernels import flash_fwd as fwd

    sfx = "_varlen" if seg else ""
    return {n: getattr(fwd if n == "flash_fwd" else bwd, n + sfx) for n in DENSE_NAMES}


def dense_and_compact(torch, q, k, v, do, spec, seg, tiles):
    """{name: (dense output, compact output)} of DENSE_NAMES on the same
    inputs (``seg``: () or (q ids, kv ids)); the backward reads the dense
    forward's lse and the delta of its o. Returns it and the backward's
    arguments."""
    from repro_torch.kernels import flash_bwd as bwd

    f = dense_wrappers(seg)
    out = {"flash_fwd": [f["flash_fwd"](q, k, v, spec, *seg, schedule=sch, **tiles)
                         for sch in ("dense", "compact")]}
    o, lse = out["flash_fwd"][0]
    args = (q, k, v, do, lse, bwd.flash_bwd_delta(o, do), spec, *seg)
    for n in DENSE_NAMES[1:]:
        out[n] = [f[n](*args, schedule=sch, **tiles) for sch in ("dense", "compact")]
    torch.cuda.synchronize()
    return out, args


def dense_against_compact(torch, out):
    """({equality: dense bitwise compact}, the fused dq's relative diff) of
    ``dense_and_compact``'s outputs."""
    (o_d, l_d), (o_c, l_c) = out["flash_fwd"]
    (fd, fc), (kd, kc) = out["flash_bwd_fused"], out["flash_bwd_dkv"]
    dq_d, dq_c = out["flash_bwd_dq"]
    same = {"o": torch.equal(o_d, o_c), "lse": torch.equal(l_d, l_c),
            "fused dk": torch.equal(fd[1], fc[1]), "fused dv": torch.equal(fd[2], fc[2]),
            "dkv dk": torch.equal(kd[0], kc[0]), "dkv dv": torch.equal(kd[1], kc[1]),
            "dq": torch.equal(dq_d, dq_c)}
    return same, max_err(torch, fd[0], fc[0]) / max(fc[0].abs().max().item(), 1e-6)


def dense_kernel_phase(torch, dev, flush, D, hq, hkv, B, S, specs, vocab=151_936, *,
                       seed):
    """The dense-schedule forward, fused, dK/dV and dQ kernels at head_dim
    ``D`` (``hq`` q heads over ``hkv`` kv heads), each without and with SEG
    (the packed source's step-0 ids at the model's ``vocab``), at the
    training shape (B, S) under each mask of ``specs`` ({name: MaskSpec
    kwargs}; the first gives the top-level numbers, a "window" one goes
    under ``windowed``): each against its dense plain version, and against
    the compact kernel on the same inputs (o, lse, dK, dV, split dQ and the
    fused dK/dV to the bit; the fused dQ, whose bulk reductions have no
    order, within GRAD_REL_TOL); then the same against the compact kernels
    on DENSE_SPECS at B 2, S 700 with G 1 and 4 (``hkv`` kv heads), without
    and with packed ids. Then each dense kernel timed after the L2 flush in
    turns with its compact twin (dense, compact, compact, dense), its plain
    version, its bound (the compact kernel's: the pairs the mask needs, with
    SEG the same-segment ones) and SDPA with the same mask (the forward; the
    fused kernel: forward + backward less forward); without segments also
    under the FULL spec (no tile hidden) as the control. Returns the records
    of ``<kernel>[_varlen]_dense``, with ``_hd{D}`` after it at a head dim
    other than qwen3's (HD)."""
    from repro_torch.core.masks import MaskSpec
    from repro_torch.kernels import flash_bwd as bwd
    from repro_torch.kernels import flash_fwd as fwd
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    tiles = dict(block_q=ops.BLOCK_Q, block_kv=ops.BLOCK_KV)

    def inputs(Bc, Sc, Hq, Hkv):
        return (ops._prep(randn(Bc, Sc, Hq, D), 1 / math.sqrt(D)), randn(Bc, Sc, Hkv, D),
                randn(Bc, Sc, Hkv, D), randn(Bc, Sc, Hq, D))

    def plain_kw(seg):
        kw = dict(schedule="dense", **tiles)
        if seg:
            kw.update(q_seg=seg[0], kv_seg=seg[1])
        return kw

    specs = {name: MaskSpec(**kw) for name, kw in specs.items()}
    ids = torch.from_numpy(packed_ids(B, S, vocab=vocab)).to(dev)
    err, data = {}, {}
    for name, spec in specs.items():
        for seg in ((), (ids, ids)):
            sfx = "_varlen" if seg else ""
            what = f"D={D} B={B} S={S} Hq={hq} Hkv={hkv} {name}{' (packed step 0)' if seg else ''}"
            q, k, v, do = inputs(B, S, hq, hkv)
            out, args = dense_and_compact(torch, q, k, v, do, spec, seg, tiles)
            data[name, sfx] = (q, k, v, do, args)
            same, rel_dq = dense_against_compact(torch, out)
            plain = plain_kw(seg)
            eo = check_fwd(torch, f"flash_fwd{sfx} dense {what}", out["flash_fwd"][0],
                           fwd.flash_fwd_plain(q, k, v, spec, **plain))
            pargs = args[:7]
            got = {"flash_bwd_fused": out["flash_bwd_fused"][0],
                   "flash_bwd_dkv": out["flash_bwd_dkv"][0],
                   "flash_bwd_dq": (out["flash_bwd_dq"][0],)}
            want = {"flash_bwd_fused": bwd.flash_bwd_fused_plain(*pargs, **plain),
                    "flash_bwd_dkv": bwd.flash_bwd_dkv_plain(*pargs, **plain),
                    "flash_bwd_dq": (bwd.flash_bwd_dq_plain(*pargs, **plain),)}
            rel = {}
            err[f"flash_fwd{sfx}"] = max(err.get(f"flash_fwd{sfx}", 0.0), eo)
            for n in DENSE_NAMES[1:]:
                for a in got[n]:
                    if not torch.isfinite(a).all():
                        fail(f"{n}{sfx} (dense, head_dim {D}) gave a non-finite gradient ({what})")
                rel[n] = max(max_err(torch, a, b) / max(b.abs().max().item(), 1e-6)
                             for a, b in zip(got[n], want[n]))
                err[f"{n}{sfx}"] = max(err.get(f"{n}{sfx}", 0.0),
                                       *(max_err(torch, a, b) for a, b in zip(got[n], want[n])))
            log(f"dense kernels {what}: relative to max|grad| "
                + ", ".join(f"{n}{sfx} {e:.3e}" for n, e in rel.items())
                + f" (tol {GRAD_REL_TOL}); bitwise the compact kernels: {same}; fused dq against "
                f"the compact fused dq {rel_dq:.3e} (tol {GRAD_REL_TOL})")
            if max(rel.values()) > GRAD_REL_TOL:
                fail(f"a dense backward kernel{sfx} at head_dim {D} disagrees with its plain "
                     f"version ({what})")
            if not all(same.values()) or rel_dq > GRAD_REL_TOL:
                fail(f"the dense kernels{sfx} at head_dim {D} are not the compact ones ({what})")

    ids700 = torch.from_numpy(packed_ids(2, 700, vocab=vocab)).to(dev)
    for G in (1, 4):
        for spec_kw in DENSE_SPECS:
            for seg in ((), (ids700, ids700)):
                spec = MaskSpec(**spec_kw)
                out, _ = dense_and_compact(torch, *inputs(2, 700, hkv * G, hkv), spec, seg, tiles)
                same, rel_dq = dense_against_compact(torch, out)
                log(f"  dense against compact, D={D} B=2 S=700 G={G} {spec}"
                    f"{' packed' if seg else ''}: bitwise {all(same.values())}, fused dq "
                    f"{rel_dq:.3e}")
                if not all(same.values()) or rel_dq > GRAD_REL_TOL:
                    fail(f"the dense kernels at head_dim {D} are not the compact ones at G={G} "
                         f"{spec} {'packed ' if seg else ''}({same}, fused dq {rel_dq:.3e})")

    rows = {}
    first = next(iter(specs))
    ago = torch.arange(S, device=dev)[:, None] - torch.arange(S, device=dev)[None, :]
    for (name, sfx), (q, k, v, do, args) in data.items():
        spec, seg = specs[name], args[7:]
        mask = segment_mask(torch, ids) if seg else None
        if spec.window is not None:
            mask = (ago >= 0)[None, None] if mask is None else mask
            mask = mask & (ago < spec.window)[None, None]
        lib_fwd, lib_fb = sdpa_times(torch, q, k, v, do, flush, mask)
        library = {"flash_fwd": lib_fwd, "flash_bwd_fused": lib_fb - lib_fwd,
                   "flash_bwd_dkv": None, "flash_bwd_dq": None}
        pairs = (segment_pairs(ids.cpu().numpy(), spec.window) if seg
                 else B * causal_pairs(S, spec.window))
        bounds = attention_bounds(pairs, B, S, id_bytes=2 * B * S * 4 if seg else 0, Hq=hq,
                                  Hkv=hkv, D=D)
        f = dense_wrappers(seg)
        plain = plain_kw(seg)
        for n in DENSE_NAMES:
            def call(schedule, spec_=spec, n=n):
                if n == "flash_fwd":
                    return f[n](q, k, v, spec_, *seg, schedule=schedule, **tiles)
                return f[n](*args[:6], spec_, *seg, schedule=schedule, **tiles)

            dense_ms, compact_ms, turns = in_turns(torch, lambda: call("dense"),
                                                   lambda: call("compact"), 20, flush)
            pfn = getattr(fwd if n == "flash_fwd" else bwd, n + "_plain")
            pargs = (q, k, v, spec) if n == "flash_fwd" else args[:7]
            plain_ms = time_ms(torch, lambda: pfn(*pargs, **plain), 2, flush)
            b_ms, b_by = bounds[n]
            rec = rows[name, sfx, n] = dict(
                ms=dense_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library[n], compact_ms_in_turns=compact_ms,
                dense_over_compact=dense_ms / compact_ms)
            line = (f"  {n}{sfx} dense D={D} B={B} S={S} {name}: kernel {dense_ms:.4f} ms, "
                    f"compact in turns {compact_ms:.4f} ms (ratio {dense_ms / compact_ms:.4f}; "
                    f"turns {turns}), plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
                    f"{dense_ms / b_ms:.2f}x the bound; library "
                    + ("none" if library[n] is None else f"{library[n]:.4f} ms (SDPA, same mask)"))
            if not seg and name == first:
                full, full_c, _ = in_turns(torch, lambda: call("dense", MaskSpec()),
                                           lambda: call("compact", MaskSpec()), 20, flush)
                rec.update(full_spec_ms=full, full_spec_compact_ms=full_c)
                line += (f"; FULL control: dense {full:.4f} ms, compact {full_c:.4f} ms (ratio "
                         f"{full / full_c:.4f})")
            log(line)
    key = "_dense" if D == HD else f"_dense_hd{D}"
    out = {}
    for sfx in ("", "_varlen"):
        for n in DENSE_NAMES:
            rec = dict(max_abs_err=err[f"{n}{sfx}"], **rows[first, sfx, n])
            if "window" in specs:
                rec["windowed"] = rows["window", sfx, n]
            out[f"{n}{sfx}{key}"] = rec
    return out


def serving_prompts(cfg):
    import numpy as np

    rng = np.random.default_rng(0)
    return [rng.integers(1, cfg.vocab_size, n).tolist() for n in PROMPT_LENS]


def run_engine(torch, dev, cfg, engine, n_requests: int, path: str):
    """Tick ``engine`` until every request has finished, with every kernel
    launch count and plain-version call count set to 0 just before and the
    dense reference (``impl="ref"``) counted while it runs; check that each
    request generated MAX_NEW + 1 tokens inside the vocabulary and that no
    plain version and no reference ran. Returns the counts read just after
    and the run's tokens/s, median decode-only tick (ms) and peak memory
    (GiB)."""
    import repro_torch.core.attention as attention
    from repro_torch.kernels import flash_decode as dec
    from repro_torch.kernels import flash_fwd as fwd

    kernels = {"flash_fwd": fwd.flash_fwd, "flash_decode": dec.flash_decode,
               "flash_decode_paged": dec.flash_decode_paged,
               "flash_fwd_splitkv": fwd.flash_fwd_splitkv,
               "flash_fwd_splitkv_hd160": SubCount(fwd.flash_fwd_splitkv, "hd160_launches"),
               "flash_fwd_splitkv_hd256": SubCount(fwd.flash_fwd_splitkv, "hd256_launches")}
    plains = {"flash_fwd_plain": fwd.flash_fwd_plain, "flash_decode_plain": dec.flash_decode_plain,
              "flash_decode_paged_plain": dec.flash_decode_paged_plain,
              "flash_fwd_splitkv_plain": fwd.flash_fwd_splitkv_plain}
    for f in kernels.values():
        f.launches = 0
    for f in plains.values():
        f.calls = 0
    reference, ref_calls = attention.attention_reference, [0]

    def counted_reference(*args, **kw):
        ref_calls[0] += 1
        return reference(*args, **kw)

    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    decode_ticks, admit_ticks = [], []  # seconds of each engine tick
    attention.attention_reference = counted_reference
    try:
        t0 = time.perf_counter()
        while (engine.queue or any(s is not None for s in engine.slots)) and engine.ticks < 1000:
            queued, t_tick = len(engine.queue), time.perf_counter()
            engine.tick()
            torch.cuda.synchronize()
            (admit_ticks if len(engine.queue) < queued else decode_ticks).append(
                time.perf_counter() - t_tick)
        dt = time.perf_counter() - t0
    finally:
        attention.attention_reference = reference
    counts = {k: f.launches for k, f in kernels.items()}
    counts.update({k: f.calls for k, f in plains.items()})
    counts["attention_reference"] = ref_calls[0]
    finished = engine.finished
    tokens = sum(len(r.generated) for r in finished.values())
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"{path}: served {len(finished)} requests (prompt lengths {list(PROMPT_LENS)}) in "
        f"{engine.ticks} ticks: {tokens} tokens in {dt:.3f} s = {tokens / dt:.1f} tokens/s; "
        f"max_memory_allocated {peak:.2f} GiB")
    decode_ticks.sort()
    median = decode_ticks[len(decode_ticks) // 2]
    log(f"{path}: ticks with admission (prefill + decode): {len(admit_ticks)}, "
        f"{sum(admit_ticks):.3f} s in all; decode-only ticks: {len(decode_ticks)}, "
        f"median {median * 1e3:.2f} ms (min {decode_ticks[0] * 1e3:.2f} ms)")
    log(f"launches on the {path} path: {counts}")
    if sorted(finished) != list(range(n_requests)):
        fail(f"{path}: finished requests {sorted(finished)}")
    for rid, req in finished.items():
        if len(req.generated) != MAX_NEW + 1 or not all(
                0 <= t < cfg.vocab_size for t in req.generated):
            fail(f"{path}: request {rid} generated {req.generated}")
    if any(counts[k] for k in plains) or ref_calls[0]:
        fail(f"a plain version or the dense reference ran on the {path} path")
    return counts, dict(tokens_per_s=tokens / dt, median_tick_ms=median * 1e3, peak_gib=peak)


def slice_phase(torch, dev):
    from repro_torch.configs import registry
    from repro_torch.core.attention import AttentionConfig
    from repro_torch.models.lm import init_lm
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = registry.get("qwen3-8b")
    t0 = time.perf_counter()
    model = init_lm(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"qwen3-8b: {cfg.num_layers} layers, d_model {cfg.d_model}, {n_params / 1e9:.3f} B "
        f"params ({cfg.dtype}), initialised in {time.perf_counter() - t0:.1f} s")

    prompts = serving_prompts(cfg)
    engine = ServingEngine(cfg, model, AttentionConfig(impl="flash_cuda"),
                           max_batch=4, cache_size=CACHE)
    for rid, prompt in enumerate(prompts):
        engine.submit(Request(rid=rid, prompt=prompt, max_new_tokens=MAX_NEW))

    counts, _ = run_engine(torch, dev, cfg, engine, len(prompts), "serving")
    if counts["flash_fwd"] <= 0 or counts["flash_decode"] <= 0:
        fail("the serving path did not launch both kernels")

    # The dense reference on the card gives the same last-position logits,
    # for a prefill and for one decode step from the same cache.
    ref_cfg, fl_cfg = AttentionConfig(impl="ref"), AttentionConfig(impl="flash_cuda")
    tokens_in = torch.tensor([prompts[2]], device=dev)
    h_ref, _, _ = model.prefill(tokens_in, ref_cfg, CACHE)
    h_fl, cache_fl, _ = model.prefill(tokens_in, fl_cfg, CACHE)
    l_ref = model.logits_from_hidden(h_ref)
    l_fl = model.logits_from_hidden(h_fl)
    compare_logits(torch, f"prefill of {len(prompts[2])} tokens", l_ref, l_fl)
    # Four rows share the prompt's cache (a prefix of a causal prefill's K/V
    # is the K/V of the shorter prompt); ragged lengths leave splits empty.
    cache_fl = [{"kv": {n: t.expand(4, -1, -1, -1).clone() for n, t in c["kv"].items()}}
                for c in cache_fl]
    cache_ref = [{"kv": {n: t.clone() for n, t in c["kv"].items()}} for c in cache_fl]
    step_len = torch.tensor([len(prompts[2]), 1, 350, 64], dtype=torch.int32, device=dev)
    first = int(l_fl[..., :cfg.vocab_size].argmax())
    step_tok = torch.tensor([[first], [5], [17], [99]], device=dev)
    d_ref, _ = model.decode_step(step_tok, cache_ref, step_len, ref_cfg)
    d_fl, _ = model.decode_step(step_tok, cache_fl, step_len, fl_cfg)
    compare_logits(torch, f"decode step, B=4, lengths {step_len.tolist()}", d_ref, d_fl)
    del cache_fl, cache_ref
    return counts, cfg, model


def paged_slice_phase(torch, dev, cfg, model):
    """Paged serving at full width on the model of the serving phase: the six
    requests through PagedServingEngine with a pool of PAGED_POOL_PAGES
    pages. Then, from one cache state, a decode step through shuffled pages
    against the same step through the contiguous cache (both flash_cuda),
    and a W = 4 batched admission prefill against the dense reference."""
    from repro_torch.core.attention import AttentionConfig
    from repro_torch.serving.engine import PagedServingEngine, Request

    fl_cfg, ref_cfg = AttentionConfig(impl="flash_cuda"), AttentionConfig(impl="ref")
    prompts = serving_prompts(cfg)
    engine = PagedServingEngine(cfg, model, fl_cfg, max_batch=4, num_pages=PAGED_POOL_PAGES,
                                page_size=PAGE_SIZE, pages_per_seq_max=PAGES_PER_SEQ)
    for rid, prompt in enumerate(prompts):
        engine.submit(Request(rid=rid, prompt=prompt, max_new_tokens=MAX_NEW))
    counts, _ = run_engine(torch, dev, cfg, engine, len(prompts), "paged_serving")
    log(f"paged_serving: pool of {PAGED_POOL_PAGES} pages of {PAGE_SIZE} ({engine.kv_capacity()} "
        f"positions, {engine.pool.usable_pages} usable pages) against the fixed engine's "
        f"4 x {CACHE}; preemptions {engine.preemptions} (expected {PAGED_PREEMPTIONS}); "
        f"pages in use at the end {engine.pool.used_pages}")
    if engine.preemptions != PAGED_PREEMPTIONS:
        fail(f"paged serving preempted {engine.preemptions} times, the schedule says "
             f"{PAGED_PREEMPTIONS}")
    if counts["flash_fwd"] <= 0 or counts["flash_decode_paged"] <= 0:
        fail("the paged serving path did not launch the forward and paged decode kernels")
    if counts["flash_decode"]:
        fail("the paged serving path launched the contiguous decode kernel")
    if engine.pool.used_pages:
        fail("pages were still allocated after every request finished")

    # One decode step from one cache state: through shuffled pages and through
    # the contiguous cache (four rows of the prompt's cache, ragged lengths).
    tokens_in = torch.tensor([prompts[2]], device=dev)
    h_fl, cache_c, _ = model.prefill(tokens_in, fl_cfg, CACHE)
    cache_c = [{"kv": {n: t.expand(4, -1, -1, -1).clone() for n, t in c["kv"].items()}}
               for c in cache_c]
    table = shuffled_table(torch, 4, PAGES_PER_SEQ, 3).to(dev)
    planes = [{"kv": {n: paginate(torch, t, table, 4 * PAGES_PER_SEQ + 1)
                      for n, t in c["kv"].items()}} for c in cache_c]
    step_len = torch.tensor([len(prompts[2]), 1, 350, 64], dtype=torch.int32, device=dev)
    first = int(model.logits_from_hidden(h_fl)[..., :cfg.vocab_size].argmax())
    step_tok = torch.tensor([[first], [5], [17], [99]], device=dev)
    d_c, _ = model.decode_step(step_tok, cache_c, step_len, fl_cfg)
    d_p, _ = model.decode_step(step_tok, planes, step_len, fl_cfg, block_table=table)
    compare_logits(torch, f"decode step, B=4, lengths {step_len.tolist()}", d_c, d_p,
                   names=("contiguous cache", "shuffled pages"))
    del cache_c, planes

    # A W = 4 batched admission prefill (the admit step's shapes: prompts of
    # one bucket right-padded, lens-masked, cache rounded up to whole pages).
    group = [prompts[i] for i in (0, 4, 1, 5)]  # 7, 33, 100 and 260 tokens
    pad_to = -(-max(len(p) for p in group) // engine.prompt_pad) * engine.prompt_pad
    inputs = torch.zeros((4, pad_to), dtype=torch.long, device=dev)
    for i, p in enumerate(group):
        inputs[i, :len(p)] = torch.tensor(p, device=dev)
    lens = torch.tensor([len(p) for p in group], dtype=torch.int32, device=dev)
    cache_size = -(-pad_to // PAGE_SIZE) * PAGE_SIZE
    h_ref, _, _ = model.prefill(inputs, ref_cfg, cache_size, lens=lens)
    h_fl, _, _ = model.prefill(inputs, fl_cfg, cache_size, lens=lens)
    compare_logits(torch, f"W=4 admission prefill, lengths {lens.tolist()} padded to {pad_to}",
                   model.logits_from_hidden(h_ref), model.logits_from_hidden(h_fl))
    return counts


def logit_gap(torch, l_ref, l_fl):
    """(max|diff|, max|l_ref|, the least row cosine, same argmax in every
    row) of two logits tensors, row by row."""
    l_ref = l_ref.float().reshape(l_ref.shape[0], -1)
    l_fl = l_fl.float().reshape(l_fl.shape[0], -1)
    return ((l_ref - l_fl).abs().max().item(), l_ref.abs().max().item(),
            torch.nn.functional.cosine_similarity(l_ref, l_fl, dim=1).min().item(),
            bool((l_ref.argmax(dim=1) == l_fl.argmax(dim=1)).all()))


def compare_logits(torch, what, l_ref, l_fl, names=("ref", "flash_cuda")):
    """Fail unless the second logits match the first (by default flash_cuda
    against the dense reference) row by row: cosine >= LOGIT_COS and
    max|diff| <= LOGIT_REL x max|logit|. Returns ``logit_gap``'s tuple."""
    diff, top, cos, same = logit_gap(torch, l_ref, l_fl)
    log(f"{what}, {names[0]} vs {names[1]} last-position logits: max|diff|={diff:.4f} "
        f"(max|logit|={top:.3f}, limit {LOGIT_REL * top:.4f}), min cosine {cos:.6f} "
        f"(limit {LOGIT_COS}), same argmax {same}")
    if not (torch.isfinite(l_fl).all() and cos >= LOGIT_COS and diff <= LOGIT_REL * top):
        fail(f"{what}: {names[1]} logits disagree with {names[0]}")
    return diff, top, cos, same


@contextlib.contextmanager
def routing(replay=None):
    """Every MoE layer's top-k choice (``repro_torch.models.moe.top_k``)
    while the block runs: recorded, in call order, in the list it yields;
    or, with ``replay`` (such a list), forced to the recorded experts, the
    gates still the softmax over this run's own logits at them. A model
    without MoE records nothing."""
    from repro_torch.models import moe

    calls, top_k = [], moe.top_k

    def record(logits, k):
        out = top_k(logits, k)
        calls.append(out[1])
        return out

    def force(logits, k):
        experts = replay[len(calls)]
        calls.append(experts)
        return logits.gather(-1, experts), experts

    moe.top_k = record if replay is None else force
    try:
        yield calls
    finally:
        moe.top_k = top_k


def reference_run(torch, what, run, l_fl, fl_choices):
    """``run()``, the logits of an impl="ref" run of what gave ``l_fl``
    through flash_cuda, and for an MoE model (``fl_choices``: that run's
    expert choices) how its routing differed. An MoE layer's top-k choice
    is discrete: where two experts' router logits are within the rounding
    of bf16 attention outputs apart, the two runs can pick different
    experts, and the token's output changes by a whole expert's share, a
    difference of the routing and not of the kernels. So the reference
    runs twice: free, logging how many (token, layer) choices differ from
    the kernels' run and its logits' gap to them; then with the kernels'
    choices replayed, which gives the logits returned (None and no
    routing record for a model without MoE)."""
    if not fl_choices:
        return run(), None
    with routing() as ref_choices:
        l_free = run()
    differ = [int((a.sort(dim=-1)[0] != b.sort(dim=-1)[0]).any(dim=-1).sum())
              for a, b in zip(ref_choices, fl_choices)]
    choices = sum(a.shape[0] for a in fl_choices)
    diff, top, cos, same = logit_gap(torch, l_free, l_fl)
    log(f"{what}: top-{fl_choices[0].shape[-1]} expert choices of ref vs flash_cuda differ in "
        f"{sum(differ)} of {choices} (token, layer) pairs (by layer {differ}); with its own "
        f"choices ref's logits differ by max|diff|={diff:.4f} (max|logit|={top:.3f}), min "
        f"cosine {cos:.6f}, same argmax {same}; below, ref replays flash_cuda's choices")
    with routing(replay=fl_choices):
        l_ref = run()
    return l_ref, dict(choices_differ=sum(differ), choices=choices, free_max_diff=diff,
                       free_min_cosine=cos, free_same_argmax=same)


def device_busy(torch, prof):
    """(union of the device events' intervals in us, device us by kernel
    name, number of device events) of a torch.profiler run."""
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return 0.0, {}, 0
    busy_us, cur_s, cur_e, by_name = 0.0, spans[0][0], spans[0][1], {}
    for s, e, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
        if s > cur_e:
            busy_us += cur_e - cur_s
            cur_s = s
        cur_e = max(cur_e, e)
    busy_us += cur_e - cur_s
    return busy_us, by_name, len(spans)


def tick_phase(torch, cfg, model) -> dict:
    """Decode ticks of the two engines on one model: a fresh fixed-slot and a
    fresh paged engine (the paged phase's pool) each admit the same four
    short requests. Their decode-only ticks are then timed in turns, fixed,
    paged, paged, fixed, TICK_ROUNDS times, so that the host's drift over
    the call falls on both alike. Last, PROFILED_TICKS more ticks of each
    run under torch.profiler: the union of the device-side events is the
    busy time, divided by the profiled ticks' wall time and by the engine's
    unprofiled median tick; the kernels by device time and the host
    operators by their own host time say where the tick goes. Returns each
    engine's median tick (ms) and busy share (None: not measured)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.attention import AttentionConfig
    from repro_torch.serving.engine import PagedServingEngine, Request, ServingEngine

    fl_cfg = AttentionConfig(impl="flash_cuda")
    engines = {
        "fixed": ServingEngine(cfg, model, fl_cfg, max_batch=4, cache_size=CACHE),
        "paged": PagedServingEngine(cfg, model, fl_cfg, max_batch=4,
                                    num_pages=PAGED_POOL_PAGES, page_size=PAGE_SIZE,
                                    pages_per_seq_max=PAGES_PER_SEQ),
    }
    # Enough new tokens that no request retires before the last timed tick.
    max_new = 3 + 4 * TICK_ROUNDS + PROFILED_TICKS
    for engine in engines.values():
        rng = np.random.default_rng(1)
        for rid, n in enumerate((7, 100, 33, 260)):
            engine.submit(Request(rid=rid, prompt=rng.integers(1, cfg.vocab_size, n).tolist(),
                                  max_new_tokens=max_new))
        for _ in range(3):  # admission, then two warm decode ticks
            engine.tick()
    torch.cuda.synchronize()

    def timed_tick(engine):
        t0 = time.perf_counter()
        engine.tick()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    ticks = {name: [] for name in engines}
    for _ in range(TICK_ROUNDS):
        for name in ("fixed", "paged", "paged", "fixed"):
            ticks[name].append(timed_tick(engines[name]))
    median = {name: float(np.median(t)) for name, t in ticks.items()}
    pairs = [p > f for f, p in zip(ticks["fixed"], ticks["paged"])]
    log(f"{cfg.name} decode-only ticks in turns (fixed, paged, paged, fixed) x {TICK_ROUNDS}, B=4: "
        + "; ".join(f"{name} median {median[name] * 1e3:.2f} ms (quartiles "
                    f"{np.percentile(t, 25) * 1e3:.2f}, {np.percentile(t, 75) * 1e3:.2f})"
                    for name, t in ticks.items())
        + f"; paged / fixed {median['paged'] / median['fixed']:.3f}, paged slower in "
        f"{sum(pairs)} of {len(pairs)} pairs")

    summary = {name: dict(median_tick_ms=median[name] * 1e3, busy_share=None)
               for name in engines}
    for name, engine in engines.items():
        walls = []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILED_TICKS):
                walls.append(timed_tick(engine))
        busy_us, by_name, n_events = device_busy(torch, prof)
        if not n_events:
            log(f"{cfg.name} {name} decode tick device busy share: not measured (the profiler "
                "recorded no device events)")
            continue
        busy_ms = busy_us / 1e3 / PROFILED_TICKS
        wall_ms = sum(walls) / PROFILED_TICKS * 1e3
        summary[name]["busy_share"] = busy_ms / (median[name] * 1e3)
        log(f"{cfg.name} {name} decode tick under torch.profiler ({PROFILED_TICKS} ticks, B=4): "
            f"{n_events / PROFILED_TICKS:.0f} device events per tick, device busy "
            f"{busy_ms:.3f} ms per tick; wall {wall_ms:.3f} ms per profiled tick -> busy share "
            f"{busy_ms / wall_ms:.4f}; against the unprofiled median tick "
            f"{median[name] * 1e3:.2f} ms -> busy share {busy_ms / (median[name] * 1e3):.4f}")
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        for kernel, us in top:
            log(f"  device {us / 1e3 / PROFILED_TICKS:8.3f} ms/tick "
                f"({us / 1e3 / PROFILED_TICKS / busy_ms:6.1%}): {kernel[:90]}")
        # Operators by their own host time (children excluded).
        host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:10]
        for e in host:
            log(f"  host   {e.self_cpu_time_total / 1e3 / PROFILED_TICKS:8.3f} ms/tick, "
                f"{e.count / PROFILED_TICKS:6.0f} calls/tick: {e.key[:80]}")
    return summary



# whisper-base attention widths and its serving shapes (src/repro_torch/configs/archs.py).
WH_H, WH_D = 8, 64
WH_FRAMES, WH_PROMPT, WH_CACHE, WH_TICKS, WH_B = 1500, 4, 448, 32, 4
# Whisper's start-of-transcript sequence: <|startoftranscript|> <|en|>
# <|transcribe|> <|notimestamps|>.
WH_SOT = (50258, 50259, 50359, 50363)
SPLIT_SWEEP = (2, 3, 4, 5, 6, 8, 12, 13, 16, 17, 24)
PREFILL_ROUNDS = 16  # whisper prefills in turns, auto splits against one


def packed_cache_ids(torch, B: int, S: int, seed: int = 0):
    """kv ids (B, S) with two to four segments a row and each row's query in
    its last segment (one row in its first)."""
    g = torch.Generator().manual_seed(seed)
    kv = torch.zeros((B, S), dtype=torch.int32)
    q = torch.zeros((B,), dtype=torch.int32)
    for b in range(B):
        n = 2 + b % 3
        cuts = torch.sort(torch.randperm(S - 2, generator=g)[:n - 1] + 1).values.tolist()
        edges = [0, *cuts, S]
        for i in range(n):
            kv[b, edges[i]:edges[i + 1]] = i + 1
        q[b] = 1 if b == 1 else n
    return kv, q


def whisper_kernel_phase(torch, dev, flush):
    """The kernels of the whisper path and the packed decode, each against
    its plain version on the card in bf16, then timed at the main paths'
    shapes: the split-KV forward at whisper's cross-attention (auto splits
    and a sweep, in turns with the single-pass kernel; also held at qwen3
    widths and with segments), the head_dim-64 forward at the encoder's
    shape, the head_dim-64 decode at the cross and self shapes, and the
    SEG decode at the qwen3 decode shape in turns with the unsegmented
    kernel."""
    import torch.nn.functional as F

    from repro_torch.core.attention import _decode_reference
    from repro_torch.core.masks import MaskSpec
    from repro_torch.kernels import flash_decode as dec
    from repro_torch.kernels import flash_fwd as fwd
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(5)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    full = MaskSpec()
    tiles = dict(block_q=ops.BLOCK_Q, block_kv=ops.BLOCK_KV)
    out = {}

    def qkv(B, Sq, Skv, Hq, Hkv, D):
        return (ops._prep(randn(B, Sq, Hq, D), 1 / math.sqrt(D)), randn(B, Skv, Hkv, D),
                randn(B, Skv, Hkv, D))

    def sdpa(q, k, v, **kw):  # (B, S, H, D) layouts; q already scaled
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=1.0, enable_gqa=True,
                                                      **kw)

    # --- the split-KV forward (and its fold) at whisper's cross-attention
    # prefill
    Sq, Skv = WH_PROMPT, WH_FRAMES
    split = {}
    for B in (4, 1):
        q, k, v = qkv(B, Sq, Skv, WH_H, WH_H, WH_D)
        ks = ops.resolve_kv_splits(None, q.shape, k.shape)
        got = fwd.flash_fwd_splitkv(q, k, v, full, kv_splits=ks, **tiles)
        torch.cuda.synchronize()
        ref = fwd.flash_fwd_splitkv_plain(q, k, v, full, kv_splits=ks, **tiles)
        eo, el = max_err(torch, got.o_parts, ref.o_parts), max_err(torch, got.lse_parts,
                                                                    ref.lse_parts)
        efo, efl = max_err(torch, got.o, ref.o), max_err(torch, got.lse, ref.lse)
        o_1, lse_1 = fwd.flash_fwd(q, k, v, full, **tiles)
        ef, elf = max_err(torch, got.o, o_1), max_err(torch, got.lse, lse_1)
        log(f"flash_fwd_splitkv B={B} Sq={Sq} Skv={Skv} H={WH_H} D={WH_D} FULL, auto splits "
            f"{ks}: partials max|o-plain|={eo:.3e}, max|lse-plain|={el:.3e}; fold "
            f"max|o-plain|={efo:.3e}, max|lse-plain|={efl:.3e}; fold against the single-pass "
            f"kernel max|o|={ef:.3e} (tol {FWD_TOL['o']}), max|lse|={elf:.3e} "
            f"(tol {FWD_TOL['lse']})")
        if not (max(eo, efo, ef) <= FWD_TOL["o"] and max(el, efl, elf) <= FWD_TOL["lse"]):
            fail(f"flash_fwd_splitkv disagrees at B={B}")

        def kernel(n):
            return lambda: fwd.flash_fwd_splitkv(q, k, v, full, kv_splits=n, **tiles)

        single = lambda: fwd.flash_fwd(q, k, v, full, **tiles)  # noqa: E731
        runs = [time_ms(torch, f, 30, flush) for f in (single, kernel(ks), kernel(ks), single)]
        single_ms, split_ms = (runs[0] + runs[3]) / 2, (runs[1] + runs[2]) / 2
        sweep = {n: time_ms(torch, kernel(n), 30, flush) for n in SPLIT_SWEEP}
        log(f"flash_fwd_splitkv B={B}: auto ({ks} splits, split walk + fold) {split_ms:.4f} ms "
            f"against the single-pass kernel's {single_ms:.4f} ms in turns (ratio "
            f"{split_ms / single_ms:.4f}); sweep (splits: ms): "
            + ", ".join(f"{n}: {t:.4f}" for n, t in sweep.items()))
        plain_ms = time_ms(torch, lambda: fwd.flash_fwd_splitkv_plain(
            q, k, v, full, kv_splits=ks, **tiles), 3, flush)
        lib_ms = time_ms(torch, sdpa(q, k, v), 30, flush)
        # The function's own bytes: q, K, V read, o and lse written (the
        # partials are the kernel's scratch, not the function's output).
        b_ms, b_by = bound(4 * Sq * Skv * WH_D * B * WH_H,
                           2 * 2 * B * Sq * WH_H * WH_D + 2 * 2 * B * Skv * WH_H * WH_D
                           + B * WH_H * Sq * 4)
        log(f"flash_fwd_splitkv B={B}: plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by})")
        split[B] = dict(max_abs_err=max(eo, efo, ef), ms=split_ms, plain_ms=plain_ms,
                        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, splits=ks,
                        single_pass_ms=single_ms, sweep={str(n): t for n, t in sweep.items()})
    out["flash_fwd_splitkv"] = dict(split[4], at_batch_1=split[1])

    # Held at qwen3 widths (head_dim 128, G = 4), and causal with q tiles
    # (t_q = 3: the second pair of q tiles holds one).
    for B, Sq_, Skv_, spec in ((1, 64, 2048, full), (2, 300, 300, MaskSpec(causal=True)),
                               (1, 150, 1000, MaskSpec(causal=True, q_offset=850))):
        q, k, v = qkv(B, Sq_, Skv_, HQ, HKV, HD)
        ks = max(ops.resolve_kv_splits(None, q.shape, k.shape), 3)
        got = fwd.flash_fwd_splitkv(q, k, v, spec, kv_splits=ks, **tiles)
        torch.cuda.synchronize()
        ref = fwd.flash_fwd_splitkv_plain(q, k, v, spec, kv_splits=ks, **tiles)
        eo = max(max_err(torch, got.o_parts, ref.o_parts), max_err(torch, got.o, ref.o))
        el = max(max_err(torch, got.lse_parts, ref.lse_parts), max_err(torch, got.lse, ref.lse))
        log(f"flash_fwd_splitkv B={B} Sq={Sq_} Skv={Skv_} Hq={HQ} Hkv={HKV} D={HD} "
            f"{'causal' if spec.causal else 'FULL'} splits {ks}: max|o-plain|={eo:.3e}, "
            f"max|lse-plain|={el:.3e} (partials and fold)")
        if not (eo <= FWD_TOL["o"] and el <= FWD_TOL["lse"]):
            fail("flash_fwd_splitkv disagrees at qwen3 widths")

    # The segment branch: packed ids at the qwen3 width, 3 splits, timed
    # beside the unsegmented split kernel.
    B, S = 2, 700
    q, k, v = qkv(B, S, S, HQ, HKV, HD)
    ids = torch.from_numpy(packed_ids(B, S)).to(dev)
    causal = MaskSpec(causal=True)
    got = fwd.flash_fwd_splitkv_varlen(q, k, v, causal, ids, ids, kv_splits=3, **tiles)
    ones = torch.ones_like(ids)
    got1 = fwd.flash_fwd_splitkv_varlen(q, k, v, causal, ones, ones, kv_splits=3, **tiles)
    got0 = fwd.flash_fwd_splitkv(q, k, v, causal, kv_splits=3, **tiles)
    torch.cuda.synchronize()
    ref = fwd.flash_fwd_splitkv_plain(q, k, v, causal, kv_splits=3, q_seg=ids, kv_seg=ids,
                                      **tiles)
    eo = max(max_err(torch, got.o_parts, ref.o_parts), max_err(torch, got.o, ref.o))
    el = max(max_err(torch, got.lse_parts, ref.lse_parts), max_err(torch, got.lse, ref.lse))
    same = all(torch.equal(a, b) for a, b in zip(got1, got0))
    log(f"flash_fwd_splitkv_varlen B={B} S={S} causal packed, 3 splits: max|o-plain|={eo:.3e}, "
        f"max|lse-plain|={el:.3e}; all-ones ids bitwise the unsegmented split kernel: {same}")
    if not (eo <= FWD_TOL["o"] and el <= FWD_TOL["lse"] and same):
        fail("flash_fwd_splitkv_varlen disagrees with its plain version or the unsegmented kernel")
    seg_fn = lambda: fwd.flash_fwd_splitkv_varlen(q, k, v, causal, ids, ids, kv_splits=3,  # noqa
                                                  **tiles)
    full_fn = lambda: fwd.flash_fwd_splitkv(q, k, v, causal, kv_splits=3, **tiles)  # noqa
    runs = [time_ms(torch, f, 20, flush) for f in (seg_fn, full_fn, full_fn, seg_fn)]
    seg_ms, unseg_ms = (runs[0] + runs[3]) / 2, (runs[1] + runs[2]) / 2
    plain_ms = time_ms(torch, lambda: fwd.flash_fwd_splitkv_plain(
        q, k, v, causal, kv_splits=3, q_seg=ids, kv_seg=ids, **tiles), 3, flush)
    mask = ((ids[:, :, None] == ids[:, None, :])
            & torch.ones((S, S), dtype=torch.bool, device=dev).tril())[:, None]
    lib_ms = time_ms(torch, sdpa(q, k, v, attn_mask=mask), 20, flush)
    pairs = segment_pairs(ids.cpu().numpy())
    b_ms, b_by = bound(4 * HD * pairs * HQ, 2 * 2 * B * S * HQ * HD + 2 * 2 * B * S * HKV * HD
                       + B * HQ * S * 4 + 2 * B * S * 4)
    log(f"flash_fwd_splitkv_varlen B={B} S={S}: kernel {seg_ms:.4f} ms, the unsegmented split "
        f"kernel in turns {unseg_ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa (block-diagonal "
        f"causal mask) {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    out["flash_fwd_splitkv_varlen"] = dict(max_abs_err=eo, ms=seg_ms, plain_ms=plain_ms,
                                           bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                                           unsegmented_ms_same_call=unseg_ms)

    # --- the head_dim-64 forward at the encoder's shape (and a causal check)
    B, S = WH_B, WH_FRAMES
    q, k, v = qkv(B, S, S, WH_H, WH_H, WH_D)
    err = 0.0
    for spec in (full, MaskSpec(causal=True)):
        o, lse = fwd.flash_fwd(q, k, v, spec, **tiles)
        torch.cuda.synchronize()
        o_p, lse_p = fwd.flash_fwd_plain(q, k, v, spec, **tiles)
        eo, el = max_err(torch, o, o_p), max_err(torch, lse, lse_p)
        log(f"flash_fwd B={B} S={S} H={WH_H} D={WH_D} {'causal' if spec.causal else 'FULL'}: "
            f"max|o-plain|={eo:.3e}, max|lse-plain|={el:.3e}")
        if not (eo <= FWD_TOL["o"] and el <= FWD_TOL["lse"]):
            fail("flash_fwd at head_dim 64 disagrees with its plain version")
        err = max(err, eo)
    # The dense schedule at head_dim 64: the compact kernel's o and lse to the
    # bit, without and with segments (the packed source's ids).
    wh_ids = torch.from_numpy(packed_ids(B, S)).to(dev)
    for spec in (full, MaskSpec(causal=True)):
        for seg in ((), (wh_ids, wh_ids)):
            f = fwd.flash_fwd_varlen if seg else fwd.flash_fwd
            (o_d, l_d), (o_c, l_c) = (f(q, k, v, spec, *seg, schedule=sch, **tiles)
                                      for sch in ("dense", "compact"))
            same = torch.equal(o_d, o_c) and torch.equal(l_d, l_c)
            log(f"flash_fwd{'_varlen' if seg else ''} (head_dim 64) B={B} S={S} "
                f"{'causal' if spec.causal else 'FULL'}: dense bitwise the compact kernel: {same}")
            if not same:
                fail("the dense forward at head_dim 64 is not the compact one")
    fwd_ms, lib_ms, turns = in_turns(torch, lambda: fwd.flash_fwd(q, k, v, full, **tiles),
                                     sdpa(q, k, v), 20, flush)
    plain_ms = time_ms(torch, lambda: fwd.flash_fwd_plain(q, k, v, full, **tiles), 2, flush)
    b_ms, b_by = bound(4 * S * S * WH_D * B * WH_H,
                       4 * B * S * WH_H * WH_D * 2 + B * WH_H * S * 4)
    log(f"flash_fwd (head_dim 64) B={B} S={S} FULL: kernel {fwd_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); in turns "
        f"(fwd, sdpa, sdpa, fwd) {turns}: fwd / sdpa {fwd_ms / lib_ms:.4f}")
    out["flash_fwd_hd64"] = dict(max_abs_err=err, ms=fwd_ms, plain_ms=plain_ms, bound_ms=b_ms,
                                 bound_by=b_by, library_ms=lib_ms,
                                 sdpa_ratio_in_turns=fwd_ms / lib_ms)

    # --- the head_dim-64 decode: cross-attention (1500 frames, all visible)
    # and self-attention (a 448 cache, the lengths of the serving run)
    res = {}
    for what, S, lengths in (("cross", WH_FRAMES, [WH_FRAMES] * WH_B),
                             ("self", WH_CACHE, [5, 12, 21, 36])):
        qd = ops._prep(randn(WH_B, 1, WH_H, WH_D), 1 / math.sqrt(WH_D))
        kc, vc = randn(WH_B, S, WH_H, WH_D), randn(WH_B, S, WH_H, WH_D)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        qh = qd.reshape(WH_B * WH_H, 1, WH_D).contiguous()
        o, lse = dec.flash_decode(qh, kc, vc, lens, num_splits=8)
        torch.cuda.synchronize()
        o_p, lse_p = dec.flash_decode_plain(qh, kc, vc, lens, num_splits=8)
        eo, el = max_err(torch, o, o_p), max_err(torch, lse, lse_p)
        if not (eo <= DEC_TOL["o"] and el <= DEC_TOL["lse"]):
            fail(f"flash_decode at head_dim 64 disagrees with its plain version ({what})")
        if what == "self":
            stale_rows_check(torch, dec, f"flash_decode (head_dim 64, self) B={WH_B} S={S}", qh,
                             kc, vc, lens, num_splits=8)
        p_ms = time_ms(torch, lambda: dec.flash_decode_plain(qh, kc, vc, lens, num_splits=8), 5,
                       flush)
        mask = (torch.arange(S, device=dev)[None, :] < lens[:, None])[:, None, None, :]
        # The kernel and SDPA in turns (kernel, sdpa, sdpa, kernel).
        k_ms, l_ms, turns = in_turns(
            torch, lambda: dec.flash_decode(qh, kc, vc, lens, num_splits=8),
            sdpa(qd, kc, vc, attn_mask=mask), 50, flush)
        n_pos = int(lens.sum())
        ns, _ = dec.decode_geometry(S, 8)
        b_ms, b_by = bound(4 * WH_D * n_pos * WH_H,
                           n_pos * WH_H * WH_D * 2 * 2 + WH_B * WH_H * WH_D * 2
                           + WH_B * WH_H * ns * (WH_D + 1) * 4 + WH_B * 4)
        log(f"flash_decode (head_dim 64, {what}) B={WH_B} S={S} lengths={lengths}: "
            f"max|o-plain|={eo:.3e}, max|lse-plain|={el:.3e}; kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.4f} ms, sdpa {l_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); in turns "
            f"(kernel, sdpa, sdpa, kernel) {turns}: kernel / sdpa {k_ms / l_ms:.4f}")
        res[what] = dict(max_abs_err=eo, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=l_ms, sdpa_ratio_in_turns=k_ms / l_ms)
    out["flash_decode_hd64"] = dict(res["cross"], at_self_shape=res["self"])

    # --- the SEG decode at the qwen3 decode shape, packed cache
    B, S, G = 4, CACHE, HQ // HKV
    qd = ops._prep(randn(B, 1, HQ, HD), 1 / math.sqrt(HD))
    qh = qd.reshape(B * HKV, G, HD).contiguous()
    kc, vc = randn(B, S, HKV, HD), randn(B, S, HKV, HD)
    lens = torch.tensor([n + 8 for n in PROMPT_LENS[:4]], dtype=torch.int32, device=dev)
    kv_seg, q_seg = (x.to(dev) for x in packed_cache_ids(torch, B, S))
    o, lse = dec.flash_decode_varlen(qh, kc, vc, lens, kv_seg, q_seg, num_splits=8)
    torch.cuda.synchronize()
    o_p, lse_p = dec.flash_decode_plain(qh, kc, vc, lens, num_splits=8, segments=(kv_seg, q_seg))
    eo, el = max_err(torch, o, o_p), max_err(torch, lse, lse_p)
    o_m, _ = ops.flash_decode(qd, kc, vc, lens, scale=1.0, kv_segment_ids=kv_seg, q_segment=q_seg)
    o_r = _decode_reference(qd, kc, vc, lens, window=None, sink=0, scale=1.0,
                            kv_segment_ids=kv_seg, q_segment=q_seg)
    em = max_err(torch, o_m, o_r)
    eq_ids = (torch.full_like(kv_seg, 3), torch.full_like(q_seg, 3))
    lens0 = torch.tensor([1, 0, 1337, 2048], dtype=torch.int32, device=dev)
    a = dec.flash_decode(qh, kc, vc, lens0, num_splits=8, window=500, sink=4)
    b = dec.flash_decode_varlen(qh, kc, vc, lens0, *eq_ids, num_splits=8, window=500, sink=4)
    c = dec.flash_decode(qh, kc, vc, lens, num_splits=8)
    d = dec.flash_decode_varlen(qh, kc, vc, lens, *eq_ids, num_splits=8)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(x, y) for x, y in zip((*a, *c), (*b, *d)))
    log(f"flash_decode_varlen B={B} S={S} G={G} D={HD}, 2-4 segments a row, lengths "
        f"{lens.tolist()}: partials max|o-plain|={eo:.3e}, max|lse-plain|={el:.3e}; merged "
        f"against the dense reference with the segment mask max|o|={em:.3e}; equal ids bitwise "
        f"the unsegmented kernel: {bitwise}")
    if not (eo <= DEC_TOL["o"] and el <= DEC_TOL["lse"] and em <= DEC_TOL["o"] and bitwise):
        fail("flash_decode_varlen disagrees with its plain version, the reference or the "
             "unsegmented kernel")
    # A split whose rows are all of other segments gives (0, -inf); a 16-row
    # unit of other segments only (inside split 0) leaves the output finite.
    ns, chunk = dec.decode_geometry(S, 8)
    for what, rows in (("split 1", slice(chunk, 2 * chunk)), ("unit 2 of split 0", slice(32, 48))):
        ids = torch.ones((B, S), dtype=torch.int32, device=dev)
        ids[:, rows] = 2
        ones = torch.ones((B,), dtype=torch.int32, device=dev)
        o, lse = dec.flash_decode_varlen(qh, kc, vc, lens0, ids, ones, num_splits=8)
        torch.cuda.synchronize()
        o_p, lse_p = dec.flash_decode_plain(qh, kc, vc, lens0, num_splits=8, segments=(ids, ones))
        e, e_lse = max_err(torch, o, o_p), max_err(torch, lse, lse_p)
        o5, lse5 = o.reshape(B, HKV, ns, G, HD), lse.reshape(B, HKV, ns, G)
        if rows.start == chunk:
            reached = lens0 > chunk
            ok = bool(torch.isneginf(lse5[reached][:, :, 1]).all()
                      and (o5[reached][:, :, 1] == 0).all())
        else:
            ok = bool(torch.isfinite(lse5[lens0 > 0][:, :, 0]).all())
        ok = (ok and bool(torch.isfinite(o).all()) and e <= DEC_TOL["o"]
              and e_lse <= DEC_TOL["lse"])
        log(f"flash_decode_varlen, {what} of other segments only, lengths {lens0.tolist()}: "
            f"max|o-plain|={e:.3e}, max|lse-plain|={e_lse:.3e}; "
            + ("(0, -inf) for that split" if rows.start == chunk else "split 0 finite")
            + f": {ok}")
        if not ok:
            fail(f"flash_decode_varlen with {what} of other segments only")
    seg_fn = lambda: dec.flash_decode_varlen(qh, kc, vc, lens, kv_seg, q_seg, num_splits=8)  # noqa
    full_fn = lambda: dec.flash_decode(qh, kc, vc, lens, num_splits=8)  # noqa: E731
    runs = [time_ms(torch, f, 50, flush) for f in (seg_fn, full_fn, full_fn, seg_fn)]
    seg_ms, unseg_ms = (runs[0] + runs[3]) / 2, (runs[1] + runs[2]) / 2
    p_ms = time_ms(torch, lambda: dec.flash_decode_plain(qh, kc, vc, lens, num_splits=8,
                                                         segments=(kv_seg, q_seg)), 5, flush)
    cols = torch.arange(S, device=dev)[None, :]
    visible = (cols < lens[:, None]) & (kv_seg == q_seg[:, None])
    l_ms = time_ms(torch, sdpa(qd, kc, vc, attn_mask=visible[:, None, None, :]), 50, flush)
    n_pos = int(visible.sum())
    ns, _ = dec.decode_geometry(S, 8)
    b_ms, b_by = bound(4 * G * HD * n_pos * HKV,
                       n_pos * HKV * HD * 2 * 2 + B * HQ * HD * 2 + B * HKV * ns * G * (HD + 1) * 4
                       + B * 4 + n_pos * 4 + B * 4)
    log(f"flash_decode_varlen: kernel {seg_ms:.4f} ms, the unsegmented kernel in turns "
        f"{unseg_ms:.4f} ms (ratio {seg_ms / unseg_ms:.4f}), plain {p_ms:.4f} ms, sdpa (length "
        f"and segment mask) {l_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; {n_pos} same-segment "
        f"positions of {int(lens.sum())})")
    out["flash_decode_varlen"] = dict(max_abs_err=max(eo, em), ms=seg_ms, plain_ms=p_ms,
                                      bound_ms=b_ms, bound_by=b_by, library_ms=l_ms,
                                      unsegmented_ms_same_call=unseg_ms)
    return out


# The head_dim-64 backward's shapes, (B, Sq, Skv, heads, causal): whisper-base's
# encoder (1500 frames, FULL), cross-attention (448 decoder rows against the
# frames), decoder (448 rows, causal), all at B 8 and 8 heads, and the gpt-20m
# preset's training step (B 8, S 512, 4 heads, causal).
HD64_SHAPES = {
    "encoder": (8, 1500, 1500, 8, False),
    "cross": (8, 448, 1500, 8, False),
    "decoder": (8, 448, 448, 8, True),
    "gpt20m": (8, 512, 512, 4, True),
}
BWD_NAMES = ("flash_bwd_delta", "flash_bwd_fused", "flash_bwd_dkv", "flash_bwd_dq")


def bwd_kernels_at(torch, randn, D, B, Sq, Skv, Hq, Hkv, spec, pairs, what, flush, *,
                   timed=True, sdpa_kw=None, extra=None):
    """The four backward kernels at head_dim D on one shape (``randn`` makes
    q, k, v, dO in that order) against their plain versions, with the
    bitwise invariants (split dK/dV the fused kernel's, dQ over two
    launches); ``extra(args, fused, dk, dv, dq)`` runs more checks on the
    same inputs. With ``timed``, each is then timed after an L2 flush beside
    its bound (``pairs``: the (q, k) pairs the mask needs, over the batch):
    the fused and the whole split backward in turns with SDPA's backward
    (fused, split, sdpa, sdpa fwd, sdpa fwd, sdpa, split, fused;
    ``sdpa_kw``: ``sdpa_calls``'s mask), delta, dK/dV and dQ alone, the
    plain versions. Returns ({name: max |err|}, {name: times} or None)."""
    from repro_torch.kernels import flash_bwd as bwd
    from repro_torch.kernels import flash_fwd as fwd
    from repro_torch.kernels import ops
    from repro_torch.kernels.schedule import build_kv_tile_schedule

    tiles = dict(block_q=ops.BLOCK_Q, block_kv=ops.BLOCK_KV)
    q = ops._prep(randn(B, Sq, Hq, D), 1 / math.sqrt(D))
    k, v, do = randn(B, Skv, Hkv, D), randn(B, Skv, Hkv, D), randn(B, Sq, Hq, D)
    o, lse = fwd.flash_fwd(q, k, v, spec, **tiles)
    delta = bwd.flash_bwd_delta(o, do)
    args = (q, k, v, do, lse, delta, spec)
    fused = bwd.flash_bwd_fused(*args, **tiles)
    dq_f2 = bwd.flash_bwd_fused(*args, **tiles)[0]
    (dk, dv), (dk2, dv2) = (bwd.flash_bwd_dkv(*args, **tiles) for _ in range(2))
    dq, dq2 = (bwd.flash_bwd_dq(*args, **tiles) for _ in range(2))
    torch.cuda.synchronize()
    got = {"flash_bwd_delta": (delta,), "flash_bwd_fused": fused,
           "flash_bwd_dkv": (dk, dv), "flash_bwd_dq": (dq,)}
    want = {"flash_bwd_delta": (bwd.flash_bwd_delta_plain(o, do),),
            "flash_bwd_fused": bwd.flash_bwd_fused_plain(*args, **tiles),
            "flash_bwd_dkv": bwd.flash_bwd_dkv_plain(*args, **tiles),
            "flash_bwd_dq": (bwd.flash_bwd_dq_plain(*args, **tiles),)}
    errs, rel = {}, {}
    for name in BWD_NAMES:
        for a in got[name]:
            if not torch.isfinite(a).all():
                fail(f"{name} (head_dim {D}) gave a non-finite output at {what}")
        errs[name] = max(max_err(torch, a, b) for a, b in zip(got[name], want[name]))
        rel[name] = max(max_err(torch, a, b) / max(b.abs().max().item(), 1e-6)
                        for a, b in zip(got[name], want[name]))
    bitwise = (torch.equal(dk, fused[1]) and torch.equal(dv, fused[2]) and torch.equal(dk, dk2)
               and torch.equal(dv, dv2), torch.equal(dq, dq2))
    split = bwd.kv_head_split(spec, B, Sq, Skv, Hq, Hkv, D, tiles["block_q"], tiles["block_kv"])
    grid = bwd.kv_grid(B, Hkv, Skv, D, tiles["block_kv"], split)
    log(f"backward at head_dim {D}, {what}: the fused and dK/dV launches' grid {grid} "
        f"(head split {split}{', the partials summed by flash_bwd_group_sum' if split > 1 else ''}); "
        f"max|delta-plain|="
        f"{errs['flash_bwd_delta']:.3e} (tol {DELTA_TOL}); worst relative error fused "
        f"{rel['flash_bwd_fused']:.3e}, dK/dV {rel['flash_bwd_dkv']:.3e}, dQ "
        f"{rel['flash_bwd_dq']:.3e} (tol {GRAD_REL_TOL}); split dk, dv bitwise the fused "
        f"kernel's and over two launches: {bitwise[0]}; dq of two split launches bitwise equal: "
        f"{bitwise[1]}; fused dq "
        f"elements that differ between two launches: {int((fused[0] != dq_f2).sum())} of "
        f"{dq.numel()}")
    if not errs["flash_bwd_delta"] <= DELTA_TOL:
        fail(f"flash_bwd_delta (head_dim {D}) disagrees with its plain version at {what}")
    if not max(rel[n] for n in BWD_NAMES[1:]) <= GRAD_REL_TOL:
        fail(f"a backward kernel (head_dim {D}) disagrees with its plain version at {what}")
    if not all(bitwise):
        fail(f"a bitwise invariant of the split backward fails at head_dim {D}, {what}")
    if extra is not None:
        extra(args, fused, dk, dv, dq)
    if not timed:
        return errs, None

    bounds = attention_bounds(pairs, B, Sq, Skv=Skv, Hq=Hq, Hkv=Hkv, D=D)
    bounds["flash_bwd_delta"] = bound(2 * B * Sq * Hq * D, 2 * B * Sq * Hq * D * 2 + B * Hq * Sq * 4)
    sdpa_fwd, sdpa_fwd_bwd = sdpa_calls(torch, q, k, v, do, **(sdpa_kw or {}))

    def split_total():
        d = bwd.flash_bwd_delta(o, do)
        bwd.flash_bwd_dkv(q, k, v, do, lse, d, spec, **tiles)
        bwd.flash_bwd_dq(q, k, v, do, lse, d, spec, **tiles)

    calls = {"fused": lambda: bwd.flash_bwd_fused(*args, **tiles), "split": split_total,
             "sdpa": sdpa_fwd_bwd, "sdpa_fwd": sdpa_fwd}
    turns = {name: [] for name in calls}
    for name in ("fused", "split", "sdpa", "sdpa_fwd", "sdpa_fwd", "sdpa", "split", "fused"):
        turns[name].append(time_ms(torch, calls[name], 20, flush))
    fused_ms, split_ms, fb_ms, f_ms = (sum(turns[n]) / 2
                                       for n in ("fused", "split", "sdpa", "sdpa_fwd"))
    lib_bwd_ms = fb_ms - f_ms
    ms = {"flash_bwd_fused": fused_ms,
          "flash_bwd_delta": time_ms(torch, lambda: bwd.flash_bwd_delta(o, do), 20, flush),
          "flash_bwd_dkv": time_ms(torch, lambda: bwd.flash_bwd_dkv(*args, **tiles), 20, flush),
          "flash_bwd_dq": time_ms(torch, lambda: bwd.flash_bwd_dq(*args, **tiles), 20, flush)}
    plains = {"flash_bwd_delta": lambda: bwd.flash_bwd_delta_plain(o, do),
              "flash_bwd_fused": lambda: bwd.flash_bwd_fused_plain(*args, **tiles),
              "flash_bwd_dkv": lambda: bwd.flash_bwd_dkv_plain(*args, **tiles),
              "flash_bwd_dq": lambda: bwd.flash_bwd_dq_plain(*args, **tiles)}
    t_q, t_kv = -(-Sq // tiles["block_q"]), -(-Skv // tiles["block_kv"])
    n_vis = int(build_kv_tile_schedule(spec, t_q, t_kv, tiles["block_q"], tiles["block_kv"],
                                       Skv).row_ptr[-1])
    log(f"  times at {what} (after an L2 flush): in turns (fused, split, sdpa, sdpa fwd, "
        f"sdpa fwd, sdpa, split, fused) fused {turns['fused']} ms, split (delta + dkv + dq) "
        f"{turns['split']} ms, sdpa fwd+bwd {turns['sdpa']} ms, sdpa fwd {turns['sdpa_fwd']} "
        f"ms; fused / sdpa backward {fused_ms / lib_bwd_ms:.4f}, split / sdpa backward "
        f"{split_ms / lib_bwd_ms:.4f}; {n_vis} visible 64 x 64 tiles a head")
    rows = {}
    for name in BWD_NAMES:
        plain_ms = time_ms(torch, plains[name], 2, flush)
        b_ms, b_by = bounds[name]
        lib = lib_bwd_ms if name == "flash_bwd_fused" else None
        rows[name] = dict(ms=ms[name], plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                          library_ms=lib)
        if name == "flash_bwd_fused":
            rows[name].update(sdpa_ratio_in_turns=fused_ms / lib_bwd_ms)
        if name == "flash_bwd_dq":
            rows[name].update(split_total_ms_in_turns=split_ms,
                              split_backward_sdpa_ratio_in_turns=split_ms / lib_bwd_ms)
        log(f"  {name} (head_dim {D}): kernel {ms[name]:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}), {ms[name] / b_ms:.2f}x the bound; library "
            + ("none" if lib is None else f"sdpa backward {lib:.4f} ms"))
    return errs, rows


def bwd_hd64_kernel_phase(torch, dev, flush):
    """The four backward kernels at head_dim 64 against their plain versions
    at every HD64_SHAPES shape (the SEG and DENSE forms of fused, dK/dV and
    dQ at the decoder's), with the bitwise invariants (split dK/dV the fused
    kernel's, dQ over two launches, dense the compact kernels', all-ones ids
    the unsegmented kernels'), each shape timed (``bwd_kernels_at``). The
    encoder's shape gives each kernel's top-level numbers; every shape's are
    under ``at_shapes``."""
    from repro_torch.core.masks import MaskSpec
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(7)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    tiles = dict(block_q=ops.BLOCK_Q, block_kv=ops.BLOCK_KV)
    errs = {name: 0.0 for name in BWD_NAMES}
    at = {name: {} for name in BWD_NAMES}
    for shape, (B, Sq, Skv, H, causal) in HD64_SHAPES.items():
        what = f"{shape} B={B} Sq={Sq} Skv={Skv} H={H} D=64 {'causal' if causal else 'FULL'}"
        pairs = B * (Sq * (Sq + 1) // 2 if causal else Sq * Skv)
        extra = None
        if shape == "decoder":
            def extra(args, fused, dk, dv, dq, what=what):
                seg_dense_checks(torch, dev, args, fused, dk, dv, dq, tiles, what)
        e, rows = bwd_kernels_at(torch, randn, 64, B, Sq, Skv, H, H, MaskSpec(causal=causal),
                                 pairs, what, flush, sdpa_kw=dict(causal=causal), extra=extra)
        for name in BWD_NAMES:
            errs[name] = max(errs[name], e[name])
            at[name][shape] = rows[name]
    return {f"{name}_hd64": dict(max_abs_err=errs[name], **at[name]["encoder"],
                                 at_shapes=at[name]) for name in BWD_NAMES}


def seg_dense_checks(torch, dev, args, fused, dk, dv, dq, tiles, what):
    """At one head_dim-64 shape: the SEG kernels (the packed source's ids)
    and the DENSE kernels against their plain versions; dense dK, dV and dQ
    bitwise the compact ones (the fused dQ within GRAD_REL_TOL: its bulk
    reductions have no order); all-ones ids bitwise the unsegmented
    kernels."""
    from repro_torch.kernels import flash_bwd as bwd
    from repro_torch.kernels import flash_fwd as fwd

    q, k, v, do, lse, delta, spec = args
    B, Sq = q.shape[:2]
    ids = torch.from_numpy(packed_ids(B, Sq)).to(dev)
    ones = torch.ones((B, Sq), dtype=torch.int32, device=dev)
    o_s, lse_s = fwd.flash_fwd_varlen(q, k, v, spec, ids, ids, **tiles)
    d_s = bwd.flash_bwd_delta(o_s, do)
    seg_args = (q, k, v, do, lse_s, d_s, spec)
    checks = {}
    seg = bwd.flash_bwd_fused_varlen(*seg_args, ids, ids, **tiles)
    seg_dkv = bwd.flash_bwd_dkv_varlen(*seg_args, ids, ids, **tiles)
    seg_dq = bwd.flash_bwd_dq_varlen(*seg_args, ids, ids, **tiles)
    dense = bwd.flash_bwd_fused(*args, schedule="dense", **tiles)
    dense_dkv = bwd.flash_bwd_dkv(*args, schedule="dense", **tiles)
    dense_dq = bwd.flash_bwd_dq(*args, schedule="dense", **tiles)
    ones_f = bwd.flash_bwd_fused_varlen(*args, ones, ones, **tiles)
    ones_dkv = bwd.flash_bwd_dkv_varlen(*args, ones, ones, **tiles)
    ones_dq = bwd.flash_bwd_dq_varlen(*args, ones, ones, **tiles)
    torch.cuda.synchronize()
    plain_kw = dict(q_seg=ids, kv_seg=ids, **tiles)
    pairs = {"fused SEG": (seg, bwd.flash_bwd_fused_plain(*seg_args, **plain_kw)),
             "dkv SEG": (seg_dkv, bwd.flash_bwd_dkv_plain(*seg_args, **plain_kw)),
             "dq SEG": ((seg_dq,), (bwd.flash_bwd_dq_plain(*seg_args, **plain_kw),)),
             "fused DENSE": (dense, bwd.flash_bwd_fused_plain(*args, schedule="dense", **tiles)),
             "dkv DENSE": (dense_dkv, bwd.flash_bwd_dkv_plain(*args, schedule="dense", **tiles)),
             "dq DENSE": ((dense_dq,), (bwd.flash_bwd_dq_plain(*args, schedule="dense",
                                                               **tiles),))}
    for name, (got, want) in pairs.items():
        checks[name] = max(max_err(torch, a, b) / max(b.abs().max().item(), 1e-6)
                           for a, b in zip(got, want))
    bitwise = {
        "dense dk, dv == compact (fused and dkv)": all(torch.equal(a, b) for a, b in zip(
            (dense[1], dense[2], dense_dkv[0], dense_dkv[1]), (dk, dv, dk, dv))),
        "dense dq == compact (split)": torch.equal(dense_dq, dq),
        "all-ones ids == unsegmented (fused dk, dv; dkv; dq)": all(torch.equal(a, b) for a, b in zip(
            (ones_f[1], ones_f[2], ones_dkv[0], ones_dkv[1], ones_dq), (dk, dv, dk, dv, dq))),
        "SEG split dk, dv == SEG fused": torch.equal(seg_dkv[0], seg[1])
                                         and torch.equal(seg_dkv[1], seg[2]),
    }
    dense_fused_dq = max_err(torch, dense[0], fused[0]) / max(fused[0].abs().max().item(), 1e-6)
    log(f"  SEG (packed ids, documents per row {ids.amax(dim=1).tolist()}) and DENSE at {what}: "
        "worst relative error against the plain versions "
        + ", ".join(f"{n} {e:.3e}" for n, e in checks.items()) + f" (tol {GRAD_REL_TOL}); "
        + "; ".join(f"{n}: {b}" for n, b in bitwise.items())
        + f"; dense fused dq against compact, relative {dense_fused_dq:.3e}")
    if not max(checks.values()) <= GRAD_REL_TOL or not dense_fused_dq <= GRAD_REL_TOL:
        fail(f"a SEG or DENSE backward kernel at head_dim 64 disagrees at {what}")
    if not all(bitwise.values()):
        fail(f"a bitwise invariant of the SEG or DENSE backward fails at head_dim 64, {what}")


class SubCount:
    """One of a wrapper's other launch counts (``dense_launches``: the dense
    schedule's; ``hd64_launches``, ``hd256_launches``: those at head_dim 64,
    256), read and zeroed through ``launches`` like the wrappers' own
    counts."""

    def __init__(self, wrapper, attr: str):
        self.wrapper, self.attr = wrapper, attr

    @property
    def launches(self) -> int:
        return getattr(self.wrapper, self.attr)

    @launches.setter
    def launches(self, n: int) -> None:
        setattr(self.wrapper, self.attr, n)


def with_dense(wrappers) -> dict:
    """{name: counter} of ``wrappers``, ``<name>_dense`` for each that also
    counts dense-schedule launches, and ``<name>_hd64``, ``<name>_hd160`` and
    ``<name>_hd256`` for each that counts its head_dim-64, 160 and 256
    launches apart (the backward's)."""
    counters = {f.__name__: f for f in wrappers}
    for suffix in ("dense", "hd64", "hd160", "hd256"):
        counters.update({f"{f.__name__}_{suffix}": SubCount(f, f"{suffix}_launches")
                         for f in wrappers if hasattr(f, f"{suffix}_launches")})
    return counters


def all_counters():
    """{name: counter} of every kernel of the port, and {name: plain version}."""
    from repro_torch.kernels import flash_bwd as bwd
    from repro_torch.kernels import flash_decode as dec
    from repro_torch.kernels import flash_fwd as fwd

    counters = with_dense((
        fwd.flash_fwd, fwd.flash_fwd_varlen, fwd.flash_fwd_splitkv, fwd.flash_fwd_splitkv_varlen,
        dec.flash_decode, dec.flash_decode_varlen, dec.flash_decode_paged, bwd.flash_bwd_delta,
        bwd.flash_bwd_fused, bwd.flash_bwd_dkv, bwd.flash_bwd_dq, bwd.flash_bwd_fused_varlen,
        bwd.flash_bwd_dkv_varlen, bwd.flash_bwd_dq_varlen, bwd.flash_bwd_group_sum))
    plains = {f.__name__: f for f in (
        fwd.flash_fwd_plain, fwd.flash_fwd_splitkv_plain, dec.flash_decode_plain,
        dec.flash_decode_paged_plain, bwd.flash_bwd_delta_plain, bwd.flash_bwd_fused_plain,
        bwd.flash_bwd_dkv_plain, bwd.flash_bwd_dq_plain)}
    return counters, plains


def whisper_phase(torch, dev):
    """The whisper serving slice: whisper-base at its published widths and
    depth (6 encoder and 6 decoder layers, d_model 512, 8 heads of 64, d_ff
    2048, vocab 51,865, bf16, random weights from seed 0) serves B = 4
    utterances of 1500 frame embeddings (seeded; the frontend is a stub)
    with Whisper's 4-token start-of-transcript prompt: the prefill, then
    WH_TICKS greedy decode ticks, through the port's step builders. Every
    attention call must go through the kernels, counted exactly. Then the
    prefill's logits and one decode tick through the dense reference, and a
    profile of decode ticks."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import registry
    from repro_torch.core.attention import AttentionConfig
    from repro_torch.launch.steps import build_prefill_step, build_serve_step
    from repro_torch.models.whisper import init_whisper

    cfg = registry.get("whisper-base")
    t0 = time.perf_counter()
    model = init_whisper(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"whisper-base: {cfg.encoder.num_layers} encoder + {cfg.num_layers} decoder layers, "
        f"d_model {cfg.d_model}, {cfg.num_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {n_params / 1e6:.1f} M params ({cfg.dtype}), initialised in "
        f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=dev).manual_seed(0)
    frames = torch.randn((WH_B, WH_FRAMES, cfg.d_model), generator=gen, device=dev).to(
        torch.bfloat16)
    prompt = torch.tensor([WH_SOT] * WH_B, device=dev)
    fl_cfg, ref_cfg = AttentionConfig(impl="flash_cuda"), AttentionConfig(impl="ref")
    prefill = build_prefill_step(cfg, fl_cfg, WH_CACHE)
    serve = build_serve_step(cfg, fl_cfg)

    # Warm-up outside the counted run (first-call allocations), then the run.
    warm = prefill(model, {"frames": frames, "inputs": prompt})
    serve(model, warm[0], warm[1], warm[2])
    del warm
    counters, plains = all_counters()
    zero_counts(counters, plains.values())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    tok, caches, lens = prefill(model, {"frames": frames, "inputs": prompt})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    tokens, ticks = [tok], []
    for _ in range(WH_TICKS):
        t1 = time.perf_counter()
        tok, caches = serve(model, tok, caches, lens)
        torch.cuda.synchronize()
        ticks.append(time.perf_counter() - t1)
        lens = lens + 1
        tokens.append(tok)
    total_s = time.perf_counter() - t0
    counts = read_counts(counters, plains.values())
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    gen_tokens = torch.cat(tokens, dim=1)
    median_tick = float(np.median(ticks))
    log(f"whisper serving B={WH_B}, {WH_FRAMES} frames, prompt {list(WH_SOT)}, {WH_TICKS} "
        f"ticks, cache {WH_CACHE}: prefill {prefill_s * 1e3:.2f} ms, decode tick median "
        f"{median_tick * 1e3:.2f} ms (min {min(ticks) * 1e3:.2f}), "
        f"{gen_tokens.numel()} tokens in {total_s:.3f} s = {gen_tokens.numel() / total_s:.1f} "
        f"tokens/s ({WH_B * WH_TICKS / sum(ticks):.1f} tokens/s over the ticks alone); "
        f"max_memory_allocated {peak:.3f} GiB")
    log(f"whisper greedy tokens of row 0: {gen_tokens[0].tolist()}")
    log(f"launches on the whisper serving path: {counts}")
    want = {name: 0 for name in counters}
    want.update(flash_fwd=2 * cfg.num_layers, flash_fwd_splitkv=cfg.num_layers,
                flash_decode=2 * cfg.num_layers * WH_TICKS)
    if {k: counts[k] for k in counters} != want or any(counts["plain"]):
        fail(f"the whisper serving path's launches are not exact: want {want}, plain 0")
    if not ((0 <= gen_tokens) & (gen_tokens < cfg.vocab_size)).all():
        fail("whisper generated a token outside the vocabulary")

    # The dense reference: the prefill's logits, and one tick from one cache.
    h_ref, _, _ = model.prefill(frames, prompt, ref_cfg, WH_CACHE)
    h_fl, cache_fl, n = model.prefill(frames, prompt, fl_cfg, WH_CACHE)
    compare_logits(torch, f"whisper prefill of {WH_FRAMES} frames and {n} tokens",
                   model.logits_from_hidden(h_ref), model.logits_from_hidden(h_fl))
    cache_ref = [{part: {name: t.clone() for name, t in c[part].items()} for part in c}
                 for c in cache_fl]
    first = model.logits_from_hidden(h_fl)[..., :cfg.vocab_size].argmax(-1).to(torch.int32)
    step_len = torch.full((WH_B,), n, dtype=torch.int32, device=dev)
    d_ref, _ = model.decode_step(first, cache_ref, step_len, ref_cfg)
    d_fl, _ = model.decode_step(first, cache_fl, step_len, fl_cfg)
    compare_logits(torch, "whisper decode tick", d_ref, d_fl)
    del cache_ref, cache_fl

    # The prefill end to end through the auto policy's splits and through
    # kv_splits=1 (the single-pass kernel), in turns: auto, one, one, auto.
    one = build_prefill_step(cfg, AttentionConfig(impl="flash_cuda", kv_splits=1), WH_CACHE)
    batch = {"frames": frames, "inputs": prompt}
    one(model, batch)
    prefill_ms = {"auto": [], "one": []}
    for r in range(PREFILL_ROUNDS):
        for name in ("auto", "one") if r % 2 == 0 else ("one", "auto"):
            fn = prefill if name == "auto" else one
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fn(model, batch)
            torch.cuda.synchronize()
            prefill_ms[name].append((time.perf_counter() - t1) * 1e3)
    auto_med, one_med = (float(np.median(prefill_ms[n])) for n in ("auto", "one"))
    log(f"whisper prefill in turns ({PREFILL_ROUNDS} each): auto splits median {auto_med:.3f} ms "
        f"(min {min(prefill_ms['auto']):.3f}), kv_splits=1 median {one_med:.3f} ms (min "
        f"{min(prefill_ms['one']):.3f}); ratio {auto_med / one_med:.4f}")
    # The same two prefills under torch.profiler: device busy time apiece,
    # and the cross-attention's share (the split kernel and its fold, or
    # the single-pass kernel at the cross shape).
    prefill_busy = {}
    for name, fn in (("auto", prefill), ("one", one)):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                fn(model, batch)
            torch.cuda.synchronize()
        busy_us, by_name, n_events = device_busy(torch, prof)
        fa2 = {k.replace("void (anonymous namespace)::", "").split("(")[0]: us / 2e3
               for k, us in by_name.items() if "fa2_fwd" in k}
        prefill_busy[name] = busy_us / 2e3 if n_events else None
        log(f"whisper prefill ({name}) under torch.profiler: device busy "
            + (f"{busy_us / 2e3:.3f} ms a prefill; forward kernels (ms a prefill): "
               + ", ".join(f"{k} {v:.4f}" for k, v in fa2.items())
               if n_events else "not measured (no device events)"))

    # Decode ticks under torch.profiler: device busy share and kernels.
    walls = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_TICKS):
            t1 = time.perf_counter()
            tok, caches = serve(model, tok, caches, lens)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
            lens = lens + 1
    busy_us, by_name, n_events = device_busy(torch, prof)
    summary = dict(prefill_ms=prefill_s * 1e3, tick_median_ms=median_tick * 1e3,
                   tokens_per_s=gen_tokens.numel() / total_s, peak_gib=peak,
                   prefill_auto_median_ms=auto_med, prefill_one_split_median_ms=one_med,
                   prefill_auto_busy_ms=prefill_busy["auto"],
                   prefill_one_split_busy_ms=prefill_busy["one"])
    if n_events:
        busy_ms = busy_us / 1e3 / PROFILED_TICKS
        wall_ms = sum(walls) / PROFILED_TICKS * 1e3
        log(f"whisper decode tick under torch.profiler ({PROFILED_TICKS} ticks): "
            f"{n_events / PROFILED_TICKS:.0f} device events per tick, device busy {busy_ms:.3f} "
            f"ms per tick; busy share {busy_ms / wall_ms:.4f} of the profiled tick, "
            f"{busy_ms / (median_tick * 1e3):.4f} of the unprofiled median tick")
        for kernel, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
            log(f"  device {us / 1e3 / PROFILED_TICKS:8.3f} ms/tick "
                f"({us / 1e3 / PROFILED_TICKS / busy_ms:6.1%}): {kernel[:90]}")
        summary["busy_share"] = busy_ms / (median_tick * 1e3)
    else:
        log("whisper decode tick device busy share: not measured (no device events)")
    return counts, summary

def train_model_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one training step: 6 x parameters x tokens plus
    12 x q_dim x S^2 per attention layer and sequence (no causal halving),
    the formula of the JAX package's ``utils/flops.py:64 train_model_flops``
    re-derived here (dense, untied or tied, attention-only configs)."""
    d, V = cfg.d_model, cfg.padded_vocab
    params = V * d * (1 if cfg.tie_embeddings else 2)
    params += cfg.num_layers * (2 * d * cfg.q_dim + 2 * d * cfg.kv_dim + 3 * d * cfg.d_ff)
    flops = 6.0 * params * batch * seq
    for kind in cfg.layer_kinds():
        w = cfg.kind_window(kind)
        flops += 12.0 * cfg.q_dim * (min(w, seq) if w else seq) * seq * batch
    return flops


def kernel_counters():
    """{name: counter} of every kernel the training paths launch, compact
    and (``<name>_dense``) dense, the split-KV forward (``kv_splits > 1``)
    among them, and the plain versions (each counts its calls)."""
    from repro_torch.kernels import flash_bwd as bwd
    from repro_torch.kernels import flash_fwd as fwd

    counters = with_dense((
        fwd.flash_fwd, bwd.flash_bwd_delta, bwd.flash_bwd_fused, bwd.flash_bwd_dkv,
        bwd.flash_bwd_dq, fwd.flash_fwd_varlen, bwd.flash_bwd_fused_varlen,
        bwd.flash_bwd_dkv_varlen, bwd.flash_bwd_dq_varlen, fwd.flash_fwd_splitkv,
        fwd.flash_fwd_splitkv_varlen, bwd.flash_bwd_group_sum))
    plains = (fwd.flash_fwd_plain, bwd.flash_bwd_delta_plain, bwd.flash_bwd_fused_plain,
              bwd.flash_bwd_dkv_plain, bwd.flash_bwd_dq_plain, fwd.flash_fwd_splitkv_plain)
    return counters, plains


def zero_counts(counters, plains) -> None:
    for f in counters.values():
        f.launches = 0
    for f in plains:
        f.calls = 0


def read_counts(counters, plains) -> dict:
    counts = {k: f.launches for k, f in counters.items()}
    counts["plain"] = [f.calls for f in plains]
    return counts


def training_want(counters, plains, n: int, bwds, suffix: str = "", *, remat: bool = True,
                  head_dim=None, forwards=None, forward: str = "flash_fwd",
                  group_sums: int = 0) -> dict:
    """Exact launch counts of ``n`` attention calls (layer-steps) under each
    backward mode of ``bwds``, through the kernels named with ``suffix``
    (``_varlen``, ``_dense``, both or none): the forward (``forward``:
    ``flash_fwd``, or ``flash_fwd_splitkv`` with kv splits) twice
    (``remat``) or once (``forwards``, where given: that many forward
    launches), delta once, then the fused kernel or dK/dV and dQ once; with
    ``head_dim`` (64, 160 or 256) the backward's counts at that head dim the
    same, and the forward's where it counts that head dim apart (those
    counts take both schedules); under each mode ``group_sums`` group-sum
    launches (the fused or dK/dV launches that split the group's q heads,
    ``group_sum_launches``), at ``head_dim`` too; every other kernel and
    every plain version 0."""
    want = {k: 0 for k in counters}
    by_dim = suffix.replace("_dense", "")  # a wrapper's head-dim count takes both schedules
    for bwd in bwds:
        n_fwd = (2 if remat else 1) * n if forwards is None else forwards
        want[f"{forward}{suffix}"] += n_fwd
        if f"{forward}{by_dim}_hd{head_dim}" in want:  # the segment and split forwards' 160, 256
            want[f"{forward}{by_dim}_hd{head_dim}"] += n_fwd
        names = ["flash_bwd_delta"]
        names += ["flash_bwd_fused" + suffix] if bwd == "fused" else [
            "flash_bwd_dkv" + suffix, "flash_bwd_dq" + suffix]
        for name in names:
            want[name] += n
            if head_dim is not None:
                want[f"{name.replace('_dense', '')}_hd{head_dim}"] += n
        if group_sums:
            want["flash_bwd_group_sum"] += group_sums
            want[f"flash_bwd_group_sum_hd{head_dim}"] += group_sums
    want["plain"] = [0] * len(plains)
    return want


def group_sum_launches(cfg, B: int, S: int, steps: int) -> int:
    """The group-sum launches of ``steps`` training steps of ``cfg`` at B x
    S: one for each layer's fused or dK/dV launch whose kv-head group the
    wrapper splits over CTAs (``flash_bwd.kv_head_split`` on the layer's
    mask; segment ids and the schedule do not enter the rule)."""
    from repro_torch.kernels import flash_bwd as bwd
    from repro_torch.kernels import ops
    from repro_torch.models.lm import spec_for

    return steps * sum(
        bwd.kv_head_split(spec_for(cfg, kind), B, S, S, cfg.num_heads, cfg.num_kv_heads,
                          cfg.head_dim, ops.BLOCK_Q, ops.BLOCK_KV) > 1
        for kind in cfg.layer_kinds())


def summary_line(what: str, summary: dict, other: dict) -> str:
    """``what``: each step metric of ``summary`` beside ``other``'s."""
    fmt = {"median_ms": "{:.1f} ms", "tokens_per_s": "{:.1f}", "mfu": "{:.4f}",
           "peak_gib": "{:.2f} GiB", "busy_share": "{:.4f}", "attention_ms": "{:.3f} ms"}
    return f"{what}: " + "; ".join(
        f"{k} {v.format(summary[k]) if summary[k] is not None else 'not measured'} against "
        f"{v.format(other[k]) if other[k] is not None else 'not measured'}"
        for k, v in fmt.items()) + f"; step ratio {summary['median_ms'] / other['median_ms']:.4f}"


def train_parity_phase(torch, dev, packed: bool = False, schedule: str = "compact"):
    """One step's loss and attention gradients, 2-layer full-width qwen3-8b,
    through impl="ref" (dense attention, autograd) and impl="flash_cuda"
    with the fused and with the split backward. ``packed``: a packed batch
    of the varlen source (B = 2; the reference masks by segment, the kernels
    are the segment variants). ``schedule="dense"``: the two kernel runs
    through the dense-schedule kernels, each also held against the compact
    run of its configuration (split: loss and gradients to the bit; fused:
    the loss within PARITY_LOSS_REL). Returns the launch counts of the
    schedule's two kernel runs, which must be exact."""
    from repro_torch.configs import registry
    from repro_torch.core.attention import AttentionConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, SyntheticVarlenLM
    from repro_torch.launch.steps import loss_fn
    from repro_torch.models.lm import init_lm

    cfg = dataclasses.replace(registry.get("qwen3-8b"), num_layers=PARITY_LAYERS)
    model = init_lm(cfg, seed=0, device=dev)
    if packed:
        data = SyntheticVarlenLM(DataConfig(batch_size=TRAIN_B, seq_len=PARITY_S,
                                            vocab_size=cfg.vocab_size, seed=0, source="packed"))
        batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch(0).items()}
    else:
        inputs, targets = SyntheticLM(DataConfig(batch_size=1, seq_len=PARITY_S,
                                                 vocab_size=cfg.vocab_size, seed=1)).batch(0)
        batch = {"inputs": torch.from_numpy(inputs).to(dev),
                 "targets": torch.from_numpy(targets).to(dev)}
    what = (f"packed training parity, B={TRAIN_B} S={PARITY_S} (documents per row "
            f"{batch['segment_ids'].amax(dim=1).tolist()})" if packed
            else f"training parity, B=1 S={PARITY_S}")
    dense = schedule == "dense"
    modes = {"flash_cuda": "fused", "flash_cuda bwd=split": "split"}
    attn = {"ref": AttentionConfig(impl="ref")}
    attn.update({name: AttentionConfig(impl="flash_cuda", bwd=bwd) for name, bwd in modes.items()})
    if dense:
        attn.update({f"{name} schedule=dense": AttentionConfig(impl="flash_cuda", bwd=bwd,
                                                                schedule="dense")
                     for name, bwd in modes.items()})
        what = f"dense {what}"
    counted = list(attn)[-2:]  # the schedule's two kernel runs, counted from the first
    counters, plains = kernel_counters()
    out = {}
    for name, attn_cfg in attn.items():
        if name == counted[0]:
            torch.cuda.synchronize()
            zero_counts(counters, plains)
        model.zero_grad(set_to_none=True)
        loss, _ = loss_fn(cfg, attn_cfg, model, batch)
        loss.backward()
        out[name] = (loss.item(), {n: p.grad.float().clone() for n, p in model.named_parameters()
                                   if ".mixer." in n})
    torch.cuda.synchronize()
    counts = read_counts(counters, plains)
    del model
    l_ref, g_ref = out["ref"]
    for impl in counted:
        l_fl, g_fl = out[impl]
        rel_loss = abs(l_fl - l_ref) / abs(l_ref)
        log(f"{what}, {PARITY_LAYERS}-layer full-width qwen3-8b: loss ref {l_ref:.6f}, {impl} "
            f"{l_fl:.6f}, relative difference {rel_loss:.3e} (limit {PARITY_LOSS_REL})")
        if not (math.isfinite(l_fl) and rel_loss <= PARITY_LOSS_REL):
            fail(f"training loss through {impl} disagrees with the dense reference")
        worst_cos, worst_rel = 1.0, 0.0
        for name, a in g_ref.items():
            b = g_fl[name]
            if not torch.isfinite(b).all():
                fail(f"non-finite gradient of {name} through {impl}")
            cos = torch.nn.functional.cosine_similarity(a.flatten(), b.flatten(), dim=0).item()
            rel = (a - b).abs().max().item() / max(a.abs().max().item(), 1e-30)
            worst_cos, worst_rel = min(worst_cos, cos), max(worst_rel, rel)
            log(f"  {impl} grad {name}: cosine {cos:.6f}, max|diff| / max|grad| {rel:.4f}")
            if cos < PARITY_COS or rel > PARITY_REL:
                fail(f"gradient of {name} through {impl} disagrees with the dense reference "
                     f"(limits cosine >= {PARITY_COS}, relative max diff <= {PARITY_REL})")
        log(f"{what}, {impl}: least cosine {worst_cos:.6f} (limit {PARITY_COS}), "
            f"largest max|diff| / max|grad| {worst_rel:.4f} (limit {PARITY_REL})")
    if dense:
        for impl, compact in zip(counted, modes):
            (l_d, g_d), (l_c, g_c) = out[impl], out[compact]
            rel_loss = abs(l_d - l_c) / abs(l_c)
            worst = max((g_d[n] - g_c[n]).abs().max().item() / max(g_c[n].abs().max().item(),
                                                                   1e-30) for n in g_c)
            bitwise = l_d == l_c and all(torch.equal(g_d[n], g_c[n]) for n in g_c)
            log(f"{what}, {impl} against {compact}: loss {l_d:.6f} against {l_c:.6f} "
                f"(relative {rel_loss:.3e}), largest max|diff| / max|grad| {worst:.3e}, loss "
                f"and gradients bitwise equal: {bitwise}")
            if modes[compact] == "split" and not bitwise:
                fail(f"{impl} is not the compact split run to the bit ({what})")
            if not rel_loss <= PARITY_LOSS_REL:
                fail(f"{impl}'s loss is not the compact run's ({what})")
    log(f"launches in the {what} runs: {counts}")
    want = training_want(counters, plains, PARITY_LAYERS, modes.values(),
                         ("_varlen" if packed else "") + ("_dense" if dense else ""))
    if counts != want:
        fail(f"{what} launches {counts}, want {want}")
    return counts


def run_steps(torch, dev, cfg, attn_cfg, opt_cfg, batches, counters, plains, label: str):
    """``cfg`` from seed 0 (``init_lm``, AdamW state) through
    ``build_train_step(cfg, attn_cfg, opt_cfg)``, one host-timed step per
    batch of ``batches`` (dicts on ``dev``); the launch counts zeroed just
    before the first step and read after the last. Fails on a non-finite
    loss or gradient norm or a skipped step. Returns (model, optimizer
    state, step function, losses, step seconds, launch counts)."""
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.lm import init_lm
    from repro_torch.training.optimizer import init_opt_state

    model = init_lm(cfg, seed=0, device=dev)
    opt_state = init_opt_state(dict(model.named_parameters()))
    step_fn = build_train_step(cfg, attn_cfg, opt_cfg)
    torch.cuda.synchronize()
    zero_counts(counters, plains)
    losses, times = [], []
    for step, batch in enumerate(batches):
        t_step = time.perf_counter()
        opt_state, m = step_fn(model, opt_state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t_step)
        losses.append(m["loss"])
        log(f"train ({label}) step {step}: loss {m['loss']:.5f} gnorm {m['grad_norm']:.4f} "
            f"lr {m['lr']:.3e} skipped {m['skipped']:.0f}, {times[-1] * 1e3:.1f} ms")
        if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])) or m["skipped"]:
            fail(f"training step {step} ({label}) gave a non-finite loss or gradient norm")
    return model, opt_state, step_fn, losses, times, read_counts(counters, plains)


def train_phase(torch, dev, bwd: str, schedule: str = "compact"):
    """The training slice: 8-layer, full-width qwen3-8b, TRAIN_STEPS AdamW
    steps on the synthetic stream through flash_cuda with the ``bwd``
    backward on the ``schedule`` kernels (``run_steps``). Returns the main
    path's launch counts and a summary (losses, median step, tokens/s, MFU,
    peak memory, profiled busy share, attention's device ms)."""
    from repro_torch.configs import registry
    from repro_torch.core.attention import AttentionConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.training.optimizer import AdamWConfig

    cfg = dataclasses.replace(registry.get("qwen3-8b"), num_layers=TRAIN_LAYERS)
    label = f"bwd={bwd}" + (f", schedule={schedule}" if schedule != "compact" else "")
    data = SyntheticLM(DataConfig(batch_size=TRAIN_B, seq_len=TRAIN_S,
                                  vocab_size=cfg.vocab_size, seed=0))
    batches = []
    for step in range(TRAIN_STEPS):
        inputs, targets = data.batch(step)
        batches.append({"inputs": torch.from_numpy(inputs).to(dev),
                        "targets": torch.from_numpy(targets).to(dev)})
    counters, plains = kernel_counters()
    torch.cuda.reset_peak_memory_stats(dev)
    model, opt_state, step_fn, losses, times, counts = run_steps(
        torch, dev, cfg, AttentionConfig(impl="flash_cuda", bwd=bwd, schedule=schedule),
        AdamWConfig(warmup_steps=2, total_steps=TRAIN_STEPS), batches, counters, plains, label)
    n_params = sum(p.numel() for p in model.parameters())
    peak = torch.cuda.max_memory_allocated(dev)
    med = sorted(times)[len(times) // 2]
    tokens = TRAIN_B * TRAIN_S
    mfu = train_model_flops(cfg, TRAIN_B, TRAIN_S) / med / PEAK_BF16_FLOPS
    log(f"training ({label}) qwen3-8b at published widths, {cfg.num_layers} of 36 layers, "
        f"{n_params / 1e9:.4f} B params ({cfg.dtype}, remat {cfg.remat}), f32 master + mu + nu: "
        f"losses {[round(x, 5) for x in losses]}; median step "
        f"{med * 1e3:.1f} ms (first {times[0] * 1e3:.1f} ms), {tokens / med:.1f} tokens/s, model "
        f"FLOPs {train_model_flops(cfg, TRAIN_B, TRAIN_S) / 1e12:.3f} TFLOP a step, MFU "
        f"{mfu:.4f} of {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s; max_memory_allocated "
        f"{peak / 2**30:.2f} GiB")
    log(f"launches on the training path ({label}): {counts}")
    if not sum(losses[-2:]) / 2 < losses[0]:
        fail(f"the training loss ({label}) did not fall")
    want = training_want(counters, plains, TRAIN_STEPS * TRAIN_LAYERS, (bwd,),
                         "_dense" if schedule == "dense" else "")
    if counts != want:
        fail(f"training launches ({label}) {counts}, want {want} (forward twice a layer "
             f"with remat)")
    busy, attn_ms = profile_train_step(torch, step_fn, model, opt_state, batches[0], med)
    log(f"attention device time per step ({label}): " + (
        "not measured" if attn_ms is None else f"{attn_ms:.3f} ms of the profiled step"))
    del model, opt_state, batches
    return counts, dict(losses=losses, median_ms=med * 1e3, tokens_per_s=tokens / med, mfu=mfu,
                        peak_gib=peak / 2**30, busy_share=busy, attention_ms=attn_ms)


def profile_train_step(torch, step_fn, model, opt_state, batch, median_s: float):
    """Where one training step's device time goes, from torch.profiler: the
    device busy share and the kernels by device time, the port's own apart.
    (One more step; it is not part of the counted main-path run.) Returns
    (busy share against the unprofiled median step, attention kernels' device
    ms), or (None, None) where the profiler recorded no device event."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(model, opt_state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us, by_name, n_events = device_busy(torch, prof)
    if not n_events:
        log("training step device busy share: not measured (no device events recorded)")
        return None, None
    busy_ms = busy_us / 1e3
    log(f"training step under torch.profiler: {n_events} device events, device busy "
        f"{busy_ms:.1f} ms; wall {wall * 1e3:.1f} ms -> busy share {busy_ms / wall / 1e3:.4f}; "
        f"against the unprofiled median step {median_s * 1e3:.1f} ms -> busy share "
        f"{busy_ms / median_s / 1e3:.4f}")
    ours = {k: v for k, v in by_name.items() if "fa2_" in k}
    for name, us in sorted(ours.items(), key=lambda kv: -kv[1]):
        log(f"  port kernel {us / 1e3:8.3f} ms ({us / busy_us:6.1%}): {name[:90]}")
    groups = {"matrix products (nvjet/gemm/cutlass)": ("nvjet", "gemm", "cutlass", "sm90_"),
              "attention kernels (fa2_*)": ("fa2_",)}
    for label, keys in groups.items():
        us = sum(v for k, v in by_name.items() if any(t in k for t in keys))
        log(f"  group {label}: {us / 1e3:.1f} ms ({us / busy_us:.1%})")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        log(f"  device {us / 1e3:8.3f} ms ({us / busy_us:6.1%}): {name[:90]}")
    return busy_ms / median_s / 1e3, sum(ours.values()) / 1e3


def split_train_phase(torch, dev, fused_summary):
    """The deterministic training slice: phase 8's model, seed and batches
    through bwd="split". Launch counts exact, the loss falls, step 0's loss
    equals phase 8's (the same forward); then, at the training shape,
    ops.flash_attention(bwd="split") forward and backward twice must give
    bitwise-equal dq, dk and dv. Returns the main path's launch counts and
    the run's summary."""
    from repro_torch.core.masks import MaskSpec
    from repro_torch.kernels import ops

    counts, summary = train_phase(torch, dev, "split")
    log(summary_line("training, split against fused backward (phase 8)", summary,
                     fused_summary))
    if summary["losses"][0] != fused_summary["losses"][0]:
        fail(f"step 0's loss through bwd=split ({summary['losses'][0]!r}) differs from phase "
             f"8's ({fused_summary['losses'][0]!r}); the forward is the same")

    gen = torch.Generator(device=dev).manual_seed(4)
    shapes = ((TRAIN_B, TRAIN_S, HQ, HD), (TRAIN_B, TRAIN_S, HKV, HD), (TRAIN_B, TRAIN_S, HKV, HD))
    q0, k0, v0 = (torch.randn(s, generator=gen, device=dev).to(torch.bfloat16) for s in shapes)
    do = torch.randn(shapes[0], generator=gen, device=dev).to(torch.bfloat16)
    grads = []
    for _ in range(2):
        q, k, v = (x.clone().requires_grad_() for x in (q0, k0, v0))
        ops.flash_attention(q, k, v, MaskSpec(causal=True), bwd="split").backward(do)
        grads.append((q.grad, k.grad, v.grad))
    torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip(*grads)]
    log(f"ops.flash_attention(bwd=split) forward + backward twice at B={TRAIN_B} S={TRAIN_S} "
        f"Hq={HQ} Hkv={HKV}: dq, dk, dv bitwise equal {same}")
    if not all(same) or not all(torch.isfinite(g.float()).all() for g in grads[0]):
        fail("the split backward is not bitwise reproducible (or not finite) at the training "
             "shape")
    return counts, summary


def dense_train_phase(torch, dev, split_summary):
    """The dense-schedule training slice: phase 9's model, seed and batches
    with AttentionConfig(schedule="dense", bwd="split"). Launch counts exact
    (the dense forward twice a layer, delta, dense dK/dV and dQ once; every
    compact kernel and plain version 0), and every step's loss bitwise
    phase 9's: the dense kernels compute what the compact ones do. Returns
    the launch counts."""
    counts, summary = train_phase(torch, dev, "split", "dense")
    log(summary_line("training, dense against compact schedule (phase 9, split backward)",
                     summary, split_summary))
    same = [a == b for a, b in zip(summary["losses"], split_summary["losses"])]
    log(f"dense training: every step's loss bitwise phase 9's: {same}")
    if not all(same):
        fail("the dense schedule's losses are not phase 9's to the bit")
    return counts


def packed_train_phase(torch, dev, fused_summary):
    """The packed training slice: phase 8's model, seed, AdamW and steps at
    B = 2, S = 2048, fed from the packed source through launch/train.py's
    ``train`` with ``packed=True``. Every attention forward and backward must
    go through the segment kernels (counts exact, the unsegmented kernels
    and the plain versions 0) and the loss must fall. Returns the launch
    counts."""
    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.core.attention import AttentionConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticVarlenLM
    from repro_torch.launch.steps import build_train_step
    from repro_torch.launch.train import TrainLoopConfig, train
    from repro_torch.training.optimizer import AdamWConfig

    cfg = dataclasses.replace(registry.get("qwen3-8b"), num_layers=TRAIN_LAYERS)
    opt_cfg = AdamWConfig(warmup_steps=2, total_steps=TRAIN_STEPS)
    loop = TrainLoopConfig(steps=TRAIN_STEPS, seq_len=TRAIN_S, batch_size=TRAIN_B, log_every=1,
                           seed=0, device=str(dev), packed=True)
    source = SyntheticVarlenLM(DataConfig(TRAIN_B, TRAIN_S, cfg.vocab_size, seed=0,
                                          source="packed"))
    batches = [source.batch(step) for step in range(TRAIN_STEPS)]
    shares = [step_shares(torch, b["segment_ids"], TRAIN_S) for b in batches]
    real = float(np.mean([b["loss_mask"].mean() for b in batches]))
    counters, plains = kernel_counters()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts(counters, plains)
    model, opt_state, history = train(cfg, loop, opt_cfg)
    torch.cuda.synchronize()
    counts = read_counts(counters, plains)
    peak = torch.cuda.max_memory_allocated(dev)
    losses, times = history["loss"], history["step_time"]
    med = sorted(times)[len(times) // 2]
    tokens = TRAIN_B * TRAIN_S
    mfu = train_model_flops(cfg, TRAIN_B, TRAIN_S) / med / PEAK_BF16_FLOPS
    log(f"packed training: losses {[round(x, 5) for x in losses]}; median step {med * 1e3:.1f} "
        f"ms (first {times[0] * 1e3:.1f} ms), {tokens / med:.1f} tokens/s (B x S; non-padding "
        f"share {real:.4f}: {real * tokens / med:.1f} real tokens/s), MFU {mfu:.4f} by phase 8's "
        f"formula (it still counts full causal attention, not the same-segment pairs); "
        f"max_memory_allocated {peak / 2**30:.2f} GiB")
    log("packed training: active share of the causal schedule's visible steps by step "
        + ", ".join(f"{a:.4f}" for a, _ in shares) + "; uniform share of the active ones "
        + ", ".join(f"{u:.4f}" for _, u in shares))
    log(f"launches on the packed training path: {counts}")
    if not all(math.isfinite(x) for x in losses + history["grad_norm"]):
        fail("packed training gave a non-finite loss or gradient norm")
    if not sum(losses[-2:]) / 2 < losses[0]:
        fail("the packed training loss did not fall")
    want = training_want(counters, plains, TRAIN_STEPS * TRAIN_LAYERS, ("fused",), "_varlen")
    if counts != want:
        fail(f"packed training launches {counts}, want {want} (the segment forward twice a "
             f"layer with remat; no unsegmented kernel, no plain version)")
    step_fn = build_train_step(cfg, AttentionConfig(impl="flash_cuda"), opt_cfg)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batches[0].items()}
    busy, attn_ms = profile_train_step(torch, step_fn, model, opt_state, batch, med)
    log("attention device time per step (packed): " + (
        "not measured" if attn_ms is None else f"{attn_ms:.3f} ms of the profiled step"))
    summary = dict(median_ms=med * 1e3, tokens_per_s=tokens / med, mfu=mfu,
                   peak_gib=peak / 2**30, busy_share=busy, attention_ms=attn_ms)
    log(summary_line("packed against synthetic training (phase 8, this call)", summary,
                     fused_summary))
    del model, opt_state
    return counts


def gpt_train_phase(torch, dev):
    """The north star's path: the gpt-20m preset at its published widths (4
    layers, d_model 256, 4 heads of 64, no remat) in bf16, trained through
    the train CLI's ``train`` on the synthetic stream (B 8, S 512, GPT_STEPS
    AdamW steps from seed 0), with the fused and with the split backward
    (``TrainLoopConfig.attn_bwd``), and once through ``impl="ref"`` (dense
    attention) from the same seed and batches. Each kernel run's launches
    must be exact (per layer and step: the forward once, delta once, the
    fused kernel or dK/dV and dQ once, all at head_dim 64; no plain
    version), its loss must fall, step 0's loss must be the reference's
    within PARITY_LOSS_REL (the same weights and batch; only attention's
    rounding differs) and every step's within GPT_LOSS_REL. One more fused
    step under torch.profiler gives the device busy share and attention's
    device time. Returns {bwd: launch counts} and {bwd: summary}."""
    from repro_torch.core.attention import AttentionConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.steps import build_train_step
    from repro_torch.launch.train import PRESETS, TrainLoopConfig, train
    from repro_torch.training.optimizer import AdamWConfig

    cfg = dataclasses.replace(PRESETS["gpt-20m"], dtype="bfloat16")
    opt_cfg = AdamWConfig(warmup_steps=2, total_steps=GPT_STEPS)
    counters, plains = kernel_counters()
    counts, summaries, losses = {}, {}, {}
    for run in ("fused", "split", "ref"):
        loop = TrainLoopConfig(steps=GPT_STEPS, seq_len=GPT_S, batch_size=GPT_B, log_every=1,
                               seed=0, device=str(dev), attn_impl="ref" if run == "ref" else
                               "flash_cuda", attn_bwd=None if run == "ref" else run)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        zero_counts(counters, plains)
        model, opt_state, history = train(cfg, loop, opt_cfg)
        torch.cuda.synchronize()
        losses[run] = history["loss"]
        if run == "ref":
            break
        counts[run] = read_counts(counters, plains)
        med = sorted(history["step_time"])[GPT_STEPS // 2]
        tokens = GPT_B * GPT_S
        mfu = train_model_flops(cfg, GPT_B, GPT_S) / med / PEAK_BF16_FLOPS
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        summaries[run] = dict(losses=history["loss"], median_ms=med * 1e3,
                              tokens_per_s=tokens / med, mfu=mfu, peak_gib=peak)
        log(f"gpt-20m training (bf16, bwd={run}) B={GPT_B} S={GPT_S}: losses "
            f"{[round(x, 5) for x in history['loss']]}; median step {med * 1e3:.2f} ms (first "
            f"{history['step_time'][0] * 1e3:.1f} ms), {tokens / med:.1f} tokens/s, MFU {mfu:.4f} "
            f"of {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s, max_memory_allocated {peak:.3f} GiB")
        log(f"launches on the gpt-20m training path (bwd={run}): {counts[run]}")
        if not all(math.isfinite(x) for x in history["loss"] + history["grad_norm"]):
            fail(f"gpt-20m training (bwd={run}) gave a non-finite loss or gradient norm")
        if not sum(history["loss"][-2:]) / 2 < history["loss"][0]:
            fail(f"the gpt-20m training loss (bwd={run}) did not fall")
        want = training_want(counters, plains, GPT_STEPS * cfg.num_layers, (run,), remat=False,
                             head_dim=64)
        if counts[run] != want:
            fail(f"gpt-20m training launches (bwd={run}) {counts[run]}, want {want}")
        if run == "fused":
            inputs, targets = SyntheticLM(DataConfig(GPT_B, GPT_S, cfg.vocab_size,
                                                     seed=0)).batch(0)
            batch = {"inputs": torch.from_numpy(inputs).to(dev),
                     "targets": torch.from_numpy(targets).to(dev)}
            step_fn = build_train_step(cfg, AttentionConfig(impl="flash_cuda"), opt_cfg)
            busy, attn_ms = profile_train_step(torch, step_fn, model, opt_state, batch, med)
            summaries[run].update(busy_share=busy, attention_ms=attn_ms)
            log("attention device time per gpt-20m step: " + (
                "not measured" if attn_ms is None else f"{attn_ms:.3f} ms of the profiled step"))
        del model, opt_state
    log(f"gpt-20m training through impl=ref (dense attention): losses "
        f"{[round(x, 5) for x in losses['ref']]}")
    for run in ("fused", "split"):
        rel = [abs(a - b) / abs(b) for a, b in zip(losses[run], losses["ref"])]
        log(f"gpt-20m bwd={run} against impl=ref, relative loss difference by step: "
            + ", ".join(f"{r:.3e}" for r in rel) + f" (step 0 limit {PARITY_LOSS_REL}, every "
            f"step {GPT_LOSS_REL})")
        if not (rel[0] <= PARITY_LOSS_REL and max(rel) <= GPT_LOSS_REL):
            fail(f"gpt-20m training through flash_cuda (bwd={run}) disagrees with impl=ref")
    return counts, summaries


def whisper_train_phase(torch, dev):
    """Whisper-base at its published widths and depth (6 + 6 layers, d_model
    512, 8 heads of 64, bf16, remat), random weights from seed 0, trained
    through ``build_train_step`` (the library API; the JAX package has no
    whisper CLI either): B 8 utterances of 1500 seeded frame embeddings
    (made on the card from seed 100 + step) and 448 decoder tokens of the
    synthetic stream, WH_TRAIN_STEPS AdamW steps through flash_cuda and
    again through impl="ref". Launches exact (per attention call and step:
    the forward twice, delta once, the fused kernel once, at head_dim 64;
    no plain version); the loss must fall; step 0's loss must be the
    reference's within PARITY_LOSS_REL and every step's within
    WH_LOSS_REL. One more step under torch.profiler gives the device busy
    share and attention's device time. Returns the kernel run's launch
    counts and a summary."""
    from repro_torch.configs import registry
    from repro_torch.core.attention import AttentionConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.whisper import init_whisper
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state

    cfg = registry.get("whisper-base")
    data = SyntheticLM(DataConfig(batch_size=WH_TRAIN_B, seq_len=WH_CACHE,
                                  vocab_size=cfg.vocab_size, seed=0))
    batches = []
    for step in range(WH_TRAIN_STEPS):
        gen = torch.Generator(device=dev).manual_seed(100 + step)
        inputs, targets = data.batch(step)
        batches.append({
            "frames": torch.randn((WH_TRAIN_B, WH_FRAMES, cfg.d_model), generator=gen,
                                  device=dev).to(torch.bfloat16),
            "inputs": torch.from_numpy(inputs).to(dev),
            "targets": torch.from_numpy(targets).to(dev)})
    opt_cfg = AdamWConfig(warmup_steps=2, total_steps=WH_TRAIN_STEPS)
    counters, plains = kernel_counters()
    losses, summary = {}, {}
    for impl in ("flash_cuda", "ref"):
        torch.cuda.reset_peak_memory_stats(dev)
        model = init_whisper(cfg, seed=0, device=dev)
        opt_state = init_opt_state(dict(model.named_parameters()))
        step_fn = build_train_step(cfg, AttentionConfig(impl=impl), opt_cfg)
        torch.cuda.synchronize()
        zero_counts(counters, plains)
        losses[impl], times = [], []
        for batch in batches:
            t0 = time.perf_counter()
            opt_state, m = step_fn(model, opt_state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses[impl].append(m["loss"])
            if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])) or m["skipped"]:
                fail(f"whisper training ({impl}) gave a non-finite loss or gradient norm")
        med = sorted(times)[len(times) // 2]
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        tokens = WH_TRAIN_B * WH_CACHE
        log(f"whisper-base training ({impl}) B={WH_TRAIN_B}, {WH_FRAMES} frames, {WH_CACHE} "
            f"tokens: losses {[round(x, 5) for x in losses[impl]]}; median step {med * 1e3:.1f} "
            f"ms (first {times[0] * 1e3:.1f} ms), {tokens / med:.1f} decoder tokens/s "
            f"({WH_TRAIN_B * WH_FRAMES / med:.1f} frames/s), max_memory_allocated {peak:.3f} GiB")
        if impl == "flash_cuda":
            counts = read_counts(counters, plains)
            summary = dict(losses=losses[impl], median_ms=med * 1e3, tokens_per_s=tokens / med,
                           frames_per_s=WH_TRAIN_B * WH_FRAMES / med, peak_gib=peak)
            log(f"launches on the whisper training path: {counts}")
            n = WH_TRAIN_STEPS * (cfg.encoder.num_layers + 2 * cfg.num_layers)
            want = training_want(counters, plains, n, ("fused",), head_dim=64)
            if counts != want:
                fail(f"whisper training launches {counts}, want {want} (forward twice an "
                     f"attention call with remat)")
            if not sum(losses[impl][-2:]) / 2 < losses[impl][0]:
                fail("the whisper training loss did not fall")
            busy, attn_ms = profile_train_step(torch, step_fn, model, opt_state, batches[0], med)
            summary.update(busy_share=busy, attention_ms=attn_ms)
            log("attention device time per whisper training step: " + (
                "not measured" if attn_ms is None else f"{attn_ms:.3f} ms of the profiled step"))
        del model, opt_state, step_fn
        gc.collect()
        torch.cuda.empty_cache()
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["flash_cuda"], losses["ref"])]
    log("whisper training, flash_cuda against impl=ref, relative loss difference by step: "
        + ", ".join(f"{r:.3e}" for r in rel) + f" (step 0 limit {PARITY_LOSS_REL}, every step "
        f"{WH_LOSS_REL})")
    if not (rel[0] <= PARITY_LOSS_REL and max(rel) <= WH_LOSS_REL):
        fail("whisper training through flash_cuda disagrees with impl=ref")
    return counts, summary


# gemma3-1b's attention widths (src/repro_torch/configs/archs.py): four q
# heads over one kv head of 256, a 512-token window on five of six layers.
G3_HQ, G3_HKV, G3_D, G3_WINDOW = 4, 1, 256, 512
# stablelm-12b's: 32 q heads over 8 kv heads of 160, no window.
SL_HQ, SL_HKV, SL_D = 32, 8, 160
# granite-moe-1b-a400m's: 16 q heads over 8 kv heads of 64, no window (its
# kernel phase adds a 512-token window to cover the windowed paths at 64).
GR_HQ, GR_HKV, GR_D, GR_WINDOW = 16, 8, 64, 512
# Their vocabularies, which the packed source's document lengths are drawn
# beside (the SEG kernel phases take the ids packed training gets).
G3_VOCAB, SL_VOCAB = 262_144, 100_352


def causal_pairs(S: int, window=None) -> int:
    """(q, k) pairs a causal mask with ``window`` (None: none) needs over S rows."""
    return sum(min(q + 1, window or q + 1) for q in range(S))


def hd256_kernel_phase(torch, dev, flush):
    """The head_dim-256 kernels at gemma3-1b's shapes (``head_dim_kernel_phase``;
    causal and window 512; the forward also at S 700 and at B 2, S 333, each
    shape's tile mode logged, and timed in turns with SDPA at the prefill and
    at the training shape, ``wide_fwd_at_training_shape``), then
    the split-KV forward at its corner, prefill and packed training shapes
    (``split_kernel_phase``)."""
    return {**head_dim_kernel_phase(torch, dev, flush, G3_D, G3_HQ, G3_HKV, G3_WINDOW, seed=7,
                                    fwd_shapes=((1, 1536), (1, 700), (2, 333))),
            **split_kernel_phase(torch, dev, flush, G3_D, G3_HQ, G3_HKV, G3_CORNER, G3_WINDOW,
                                 G3_TRAIN_B, G3_TRAIN_S, G3_VOCAB, seed=41)}


def hd160_kernel_phase(torch, dev, flush):
    """The head_dim-160 kernels at stablelm-12b's shapes (``head_dim_kernel_phase``;
    causal, no window; the forward also at the ragged S 1500, at S 260 (one
    q tile a CTA) and at B 2, S 333, and timed at the training shape), then
    the split-KV forward as at 256 (``split_kernel_phase``), then the
    forward in both tile modes (``wide_tile_modes``)."""
    rows = {**head_dim_kernel_phase(torch, dev, flush, SL_D, SL_HQ, SL_HKV, None, seed=8,
                                    fwd_shapes=((1, 1536), (1, 1500), (1, 260), (2, 333))),
            **split_kernel_phase(torch, dev, flush, SL_D, SL_HQ, SL_HKV, SL_CORNER, None,
                                 SL_TRAIN_B, SL_TRAIN_S, SL_VOCAB, seed=42)}
    rows[f"flash_fwd_hd{SL_D}"]["both_tile_modes_max_abs_err"] = wide_tile_modes(
        torch, dev, SL_D, SL_HQ, SL_HKV, SL_CORNER, SL_TRAIN_B, SL_TRAIN_S, SL_VOCAB, seed=43)
    return rows


def wide_tile_modes(torch, dev, D, hq, hkv, corner, B_tr, S_tr, vocab, *, seed) -> float:
    """The head_dim-``D`` forward (``fa2_fwd_wide_kernel``) in both tile
    modes, each forced through the wrappers' private ``single_tile``
    override, against its plain version in the same mode: the single pass,
    causal, at the prefill (B 1, S 1536) and the training shape (``B_tr``,
    ``S_tr``; also on the packed source's step-0 ids), each DENSE bitwise
    compact and a second launch bitwise the first; the split-KV forward at
    the prefill with 2 and 3 splits, at every ``corner`` shape with the auto
    split (with ``check_split``'s planted fault as control) and at the
    packed training shape with 2 splits, each a second launch bitwise the
    first. Returns the largest max |o - plain|."""
    from repro_torch.core.masks import MaskSpec
    from repro_torch.kernels import flash_fwd as fwd
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(seed)
    tiles = dict(block_q=ops.BLOCK_Q, block_kv=ops.BLOCK_KV)

    def inputs(B, Sq, Skv):
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

        return ops._prep(randn(B, Sq, hq, D), 1 / math.sqrt(D)), randn(B, Skv, hkv, D), \
            randn(B, Skv, hkv, D)

    def mode_name(single):
        return "one q tile a CTA" if single else "a pair of q tiles a CTA"

    causal = MaskSpec(causal=True)
    ids = torch.from_numpy(packed_ids(B_tr, S_tr, vocab=vocab)).to(dev)
    err = 0.0
    for B, S, seg in ((1, 1536, ()), (B_tr, S_tr, ()), (B_tr, S_tr, (ids, ids))):
        q, k, v = inputs(B, S, S)
        plain_ids = dict(q_seg=seg[0], kv_seg=seg[1]) if seg else {}
        wrapper = fwd.flash_fwd_varlen if seg else fwd.flash_fwd
        for single in (False, True):
            kw = dict(tiles, single_tile=single)
            got = wrapper(q, k, v, causal, *seg, **kw)
            again = wrapper(q, k, v, causal, *seg, **kw)
            dense = wrapper(q, k, v, causal, *seg, schedule="dense", **kw)
            torch.cuda.synchronize()
            what = (f"{wrapper.__name__} D={D} B={B} S={S} causal, {mode_name(single)} "
                    f"(forced; the rule's: {tile_mode(fwd, B, hq, S, D)})")
            err = max(err, check_fwd(torch, what, got, fwd.flash_fwd_plain(
                q, k, v, causal, **plain_ids, **kw)))
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            dense_same = all(torch.equal(a, b) for a, b in zip(got, dense))
            log(f"{what}: a second launch bitwise the first {same}; DENSE bitwise compact "
                f"{dense_same}")
            if not (same and dense_same):
                fail(f"{what}: not bitwise over two launches or DENSE not bitwise compact")
    cases = [(1, 1536, 1536, causal, ks, None) for ks in (2, 3)]
    cases += [(1, CORNER_ROWS, Skv, corner_spec(Skv, w), ops.resolve_kv_splits(
        None, (1, CORNER_ROWS, hq, D), (1, Skv, hkv, D)), None) for Skv, w in corner]
    cases.append((B_tr, S_tr, S_tr, causal, SPLIT_KS, ids))
    for B, Sq, Skv, spec, ks, seg_ids in cases:
        q, k, v = inputs(B, Sq, Skv)
        seg = () if seg_ids is None else (seg_ids, seg_ids)
        plain_ids = {} if seg_ids is None else dict(q_seg=seg_ids, kv_seg=seg_ids)
        sfx = "" if seg_ids is None else "_varlen"
        split_fn, single_fn = (getattr(fwd, f"flash_fwd{m}{sfx}") for m in ("_splitkv", ""))
        for single in (False, True):
            kw = dict(tiles, single_tile=single)
            out = split_fn(q, k, v, spec, *seg, kv_splits=ks, **kw)
            again = split_fn(q, k, v, spec, *seg, kv_splits=ks, **kw)
            one = single_fn(q, k, v, spec, *seg, **kw)
            torch.cuda.synchronize()
            ref = fwd.flash_fwd_splitkv_plain(q, k, v, spec, kv_splits=ks, **plain_ids, **kw)
            what = (f"{split_fn.__name__} D={D} B={B} Sq={Sq} Skv={Skv}, {ks} splits, "
                    f"{mode_name(single)} (forced; the rule's: "
                    f"{tile_mode(fwd, B, hq, Sq, D, ks)})")
            err = max(err, check_split(torch, what, out, ref, one, control=Sq == CORNER_ROWS))
            if not all(torch.equal(a, b) for a, b in zip(out, again)):
                fail(f"{what}: not bitwise over two launches")
    return err


REPEATS = 1000  # launches of each repeat_launches shape


def repeat_launches(torch, dev) -> None:
    """The split forward in one-q-tile mode (each warpgroup waits on every
    second position of the ring) at gemma3-1b's corner (32,768 keys, 33
    splits, the 3-stage ring at 256) and split prefill, and at
    stablelm-12b's corner, launched ``REPEATS`` times each: every launch
    must be bitwise the first (partials and fold). With one barrier slot a
    stage of the 3-stage ring, about one launch in 2000 at gemma3's corner
    took another position's record and tiles."""
    from repro_torch.core.masks import MaskSpec
    from repro_torch.kernels import flash_fwd as fwd
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(44)
    for D, hq, hkv, Sq, Skv, ks in ((G3_D, G3_HQ, G3_HKV, CORNER_ROWS, 32768, None),
                                    (G3_D, G3_HQ, G3_HKV, 1536, 1536, 2),
                                    (SL_D, SL_HQ, SL_HKV, CORNER_ROWS, 32768, None)):
        q = ops._prep(torch.randn((1, Sq, hq, D), generator=gen, device=dev).to(torch.bfloat16),
                      1 / math.sqrt(D))
        k, v = (torch.randn((1, Skv, hkv, D), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        ks = ks or ops.resolve_kv_splits(None, q.shape, k.shape)
        kw = dict(block_q=ops.BLOCK_Q, block_kv=ops.BLOCK_KV, kv_splits=ks, single_tile=True)
        spec = MaskSpec(causal=True, q_offset=Skv - Sq)
        first = fwd.flash_fwd_splitkv(q, k, v, spec, **kw)
        differed = torch.zeros((), dtype=torch.int64, device=dev)
        for _ in range(REPEATS):
            out = fwd.flash_fwd_splitkv(q, k, v, spec, **kw)
            differed += torch.stack([torch.ne(a, b).any() for a, b in zip(out, first)]).any()
        n = int(differed.item())
        log(f"flash_fwd_splitkv D={D} Sq={Sq} Skv={Skv}, {ks} splits, one q tile a CTA: "
            f"{REPEATS - n} of {REPEATS} launches bitwise the first")
        if n:
            fail(f"flash_fwd_splitkv D={D} Sq={Sq} Skv={Skv}: {n} of {REPEATS} launches not "
                 f"bitwise the first")


def hd64_granite_kernel_phase(torch, dev, flush):
    """The head_dim-64 kernels at granite-moe-1b-a400m's shapes
    (``head_dim_kernel_phase``: 16 q heads over 8 kv heads, G 2; causal and
    a 512-token window; the forward also at S 700 and at B 2, S 333): the
    paged decode's first instantiation at 64, and the forward and decode at
    64 at granite's widths (whisper's phase holds them at its own)."""
    return head_dim_kernel_phase(torch, dev, flush, GR_D, GR_HQ, GR_HKV, GR_WINDOW, seed=9,
                                 fwd_shapes=((1, 1536), (1, 700), (2, 333)))


def head_dim_kernel_phase(torch, dev, flush, D, hq, hkv, window, *, seed, fwd_shapes):
    """The forward, decode and paged decode at head_dim ``D``, ``hq`` q heads
    over ``hkv`` kv heads, against their plain versions: the forward at each
    (B, S) of ``fwd_shapes``, causal (and with the ``window``), the decode
    (B 4 of a 2048 cache, ragged lengths, 8 splits, with and without the
    window; NaN in every row past each length; the SEG instantiation on
    packed and on equal ids) and the paged decode (pages of 16 and 64 under
    two page orders, NaN in every pool row no length reaches, bitwise the
    contiguous partials at 16). Then each timed after the L2 flush beside
    its bound, the forward at the first shape and the decode in turns with
    SDPA (a window as an explicit mask), the paged decode in turns with the
    contiguous one. Returns the records of ``flash_fwd_hd{D}``,
    ``flash_decode_hd{D}`` and ``flash_decode_paged_hd{D}``."""
    import torch.nn.functional as F

    from repro_torch.core.masks import MaskSpec
    from repro_torch.kernels import flash_decode as dec
    from repro_torch.kernels import flash_fwd as fwd
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    bq, bk, G = ops.BLOCK_Q, ops.BLOCK_KV, hq // hkv
    scale = 1.0 / math.sqrt(D)
    windows = {"causal": None, **({"window": window} if window else {})}
    specs = {name: MaskSpec(causal=True, window=w) for name, w in windows.items()}

    def fwd_inputs(B, S):
        return (ops._prep(randn(B, S, hq, D), scale), randn(B, S, hkv, D), randn(B, S, hkv, D))

    # --- the forward: S 1536 (the longest prefill bucket), then shapes with
    # an odd number of q tiles or a ragged last one, and B 2.
    fwd_err = 0.0
    for B, S in fwd_shapes:
        q, k, v = fwd_inputs(B, S)
        for name, spec in specs.items():
            fwd_err = max(fwd_err, check_fwd(
                torch, f"flash_fwd B={B} S={S} {name} Hq={hq} Hkv={hkv} D={D} "
                f"({tile_mode(fwd, B, hq, S, D)})",
                fwd.flash_fwd(q, k, v, spec, block_q=bq, block_kv=bk),
                fwd.flash_fwd_plain(q, k, v, spec, block_q=bq, block_kv=bk)))
    Bf, Sf = fwd_shapes[0]
    q, k, v = fwd_inputs(Bf, Sf)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    library = {"causal": dict(is_causal=True)}
    if window:
        ago = torch.arange(Sf, device=dev)[:, None] - torch.arange(Sf, device=dev)[None, :]
        library["window"] = dict(attn_mask=((ago >= 0) & (ago < window))[None, None])
    fwd_rows = {}
    for name, spec in specs.items():
        plain_ms = time_ms(torch, lambda: fwd.flash_fwd_plain(q, k, v, spec, block_q=bq,
                                                              block_kv=bk), 3, flush)
        ms, lib_ms, turns = in_turns(
            torch, lambda: fwd.flash_fwd(q, k, v, spec, block_q=bq, block_kv=bk),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, scale=1.0,
                                                   **library[name]), 20, flush)
        b_ms, b_by = bound(4 * D * causal_pairs(Sf, spec.window) * Bf * hq,
                           2 * Bf * Sf * (hq + hkv) * D * 2 + Bf * hq * Sf * 4)
        log(f"flash_fwd D={D} B={Bf} S={Sf} {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), {ms / b_ms:.2f}x the bound; in "
            f"turns (fwd, sdpa, sdpa, fwd) {turns}: fwd / sdpa {ms / lib_ms:.4f}")
        fwd_rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                              library_ms=lib_ms, sdpa_ratio_in_turns=ms / lib_ms)
    if D in WIDE_DIMS:
        fwd_rows["causal"].update(wide_fwd_at_training_shape(
            torch, dev, flush, randn, D, hq, hkv, G3_TRAIN_B if D == 256 else SL_TRAIN_B))

    # --- the contiguous decode at the fixed engine's shape.
    B, S = 4, CACHE
    qd = ops._prep(randn(B, 1, hq, D), scale)
    qh = qd.reshape(B * hkv, G, D).contiguous()
    kc, vc = randn(B, S, hkv, D), randn(B, S, hkv, D)
    lens = torch.tensor([1, 0, 1337, 2048], dtype=torch.int32, device=dev)
    ns, _ = dec.decode_geometry(S, 8)
    dec_err = 0.0
    for name, w in windows.items():
        what = f"flash_decode D={D} B={B} S={S} G={G} lengths={lens.tolist()} splits=8 {name}"
        o, lse = dec.flash_decode(qh, kc, vc, lens, num_splits=8, window=w)
        torch.cuda.synchronize()
        o_p, lse_p = dec.flash_decode_plain(qh, kc, vc, lens, num_splits=8, window=w)
        eo, el = max_err(torch, o, o_p), max_err(torch, lse, lse_p)
        empty = bool((o.reshape(B, hkv, ns, G, D)[1] == 0).all()
                     and torch.isneginf(lse.reshape(B, hkv, ns, G)[1]).all())
        log(f"{what}: partials max|o-plain|={eo:.3e} (tol {DEC_TOL['o']}), max|lse-plain|="
            f"{el:.3e} (tol {DEC_TOL['lse']}); (0, -inf) for the length-0 row: {empty}")
        if not (eo <= DEC_TOL["o"] and el <= DEC_TOL["lse"] and empty):
            fail(f"{what} disagrees with its plain version")
        stale_rows_check(torch, dec, what, qh, kc, vc, lens, num_splits=8, window=w)
        dec_err = max(dec_err, eo)
    # The SEG instantiation: a packed cache against the plain version, and
    # equal ids bitwise the unsegmented kernel.
    kv_seg, q_seg = (x.to(dev) for x in packed_cache_ids(torch, B, S))
    o, lse = dec.flash_decode_varlen(qh, kc, vc, lens, kv_seg, q_seg, num_splits=8)
    torch.cuda.synchronize()
    o_p, lse_p = dec.flash_decode_plain(qh, kc, vc, lens, num_splits=8, segments=(kv_seg, q_seg))
    eo, el = max_err(torch, o, o_p), max_err(torch, lse, lse_p)
    eq = dec.flash_decode_varlen(qh, kc, vc, lens, torch.full_like(kv_seg, 3),
                                 torch.full_like(q_seg, 3), num_splits=8, window=window)
    same = all(torch.equal(a, b) for a, b in zip(
        eq, dec.flash_decode(qh, kc, vc, lens, num_splits=8, window=window)))
    log(f"flash_decode_varlen D={D} G={G}, 2-4 segments a row: max|o-plain|={eo:.3e}, "
        f"max|lse-plain|={el:.3e}; equal ids (window {window}) bitwise the unsegmented "
        f"kernel: {same}")
    if not (eo <= DEC_TOL["o"] and el <= DEC_TOL["lse"] and same):
        fail(f"flash_decode_varlen at head_dim {D} disagrees with its plain version or the "
             "unsegmented kernel")

    lens_run = torch.tensor([n + 8 for n in PROMPT_LENS[:4]], dtype=torch.int32, device=dev)
    qq = qd.transpose(1, 2).contiguous()
    kq, vq = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
    cols = torch.arange(S, device=dev)[None, :]
    dec_rows = {}
    for name, w in windows.items():
        visible = cols < lens_run[:, None]
        if w:
            visible &= cols >= lens_run[:, None] - w
        plain_ms = time_ms(torch, lambda: dec.flash_decode_plain(
            qh, kc, vc, lens_run, num_splits=8, window=w), 5, flush)
        ms, lib_ms, turns = in_turns(
            torch, lambda: dec.flash_decode(qh, kc, vc, lens_run, num_splits=8, window=w),
            lambda: F.scaled_dot_product_attention(qq, kq, vq, attn_mask=visible[:, None, None],
                                                   enable_gqa=True, scale=1.0), 50, flush)
        n_pos = int(visible.sum())
        b_ms, b_by = bound(4 * G * D * n_pos * hkv,
                           n_pos * hkv * D * 2 * 2 + B * hq * D * 2
                           + B * hkv * ns * G * (D + 1) * 4 + B * 4)
        log(f"flash_decode D={D} B={B} S={S} lengths={lens_run.tolist()} {name} ({n_pos} "
            f"visible positions): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} "
            f"ms, bound {b_ms:.4f} ms ({b_by}), {ms / b_ms:.2f}x the bound; in turns (kernel, "
            f"sdpa, sdpa, kernel) {turns}: kernel / sdpa {ms / lib_ms:.4f}")
        dec_rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                              library_ms=lib_ms, sdpa_ratio_in_turns=ms / lib_ms)

    # --- the paged decode: pages of 16 (the engine's) and 64, each under two
    # shuffles of the physical pages.
    lengths = [0, 1, 700, 2048]  # 700 ends inside a page at both page sizes
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    paged_err = 0.0
    for ps in (16, 64):
        n_pages = S // ps
        for name, w in windows.items():
            what = f"flash_decode_paged D={D} ps={ps} G={G} lengths={lengths} {name}"
            parts = []
            for seed in (0, 1):
                table = shuffled_table(torch, B, n_pages, seed).to(dev)
                kp = paginate(torch, kc, table, B * n_pages + 1)
                vp = paginate(torch, vc, table, B * n_pages + 1)
                table[0] = 0  # the length-0 slot: an all-null row
                parts.append(dec.flash_decode_paged(qh, kp, vp, lens, table, num_splits=8,
                                                    window=w))
            torch.cuda.synchronize()
            (o, lse), (o2, lse2) = parts
            o_p, lse_p = dec.flash_decode_paged_plain(qh, kp, vp, lens, table, num_splits=8,
                                                      window=w)
            eo, el = max_err(torch, o, o_p), max_err(torch, lse, lse_p)
            o3, lse3 = dec.flash_decode_paged(
                qh, stale_nan(torch, kp, table, lengths, ps), stale_nan(torch, vp, table, lengths,
                                                                         ps),
                lens, table, num_splits=8, window=w)
            o_c, lse_c = dec.flash_decode(qh, kc, vc, lens, num_splits=8, window=w)
            torch.cuda.synchronize()
            orders = torch.equal(o, o2) and torch.equal(lse, lse2)
            stale = torch.equal(o2, o3) and torch.equal(lse2, lse3)
            contiguous = torch.equal(o, o_c) and torch.equal(lse, lse_c)
            log(f"{what}: max|o-plain|={eo:.3e}, max|lse-plain|={el:.3e}; bitwise under a "
                f"second page order {orders}, with NaN in every pool row no length reaches "
                f"{stale}, the contiguous kernel's partials {contiguous}")
            if not (eo <= DEC_TOL["o"] and el <= DEC_TOL["lse"] and orders and stale):
                fail(f"{what} disagrees with its plain version or changed with the page order "
                     "or stale rows")
            if ps == 16 and not contiguous:
                fail(f"{what}: pages of 16 must give the contiguous kernel's partials to the bit")
            paged_err = max(paged_err, eo)
    ps, n_pages = PAGE_SIZE, PAGES_PER_SEQ
    table = shuffled_table(torch, B, n_pages, 2).to(dev)
    kp = paginate(torch, kc, table, B * n_pages + 1)
    vp = paginate(torch, vc, table, B * n_pages + 1)

    def paged():
        return dec.flash_decode_paged(qh, kp, vp, lens_run, table, num_splits=8)

    def contiguous():
        return dec.flash_decode(qh, kc, vc, lens_run, num_splits=8)

    runs = [time_ms(torch, f, 50, flush) for f in (contiguous, paged, paged, contiguous)]
    ms, c_ms = (runs[1] + runs[2]) / 2, (runs[0] + runs[3]) / 2
    plain_ms = time_ms(torch, lambda: dec.flash_decode_paged_plain(
        qh, kp, vp, lens_run, table, num_splits=8), 5, flush)
    n_pos = int(lens_run.sum())
    pns, _ = dec.paged_geometry(n_pages, 8)
    b_ms, b_by = bound(4 * G * D * n_pos * hkv,
                       n_pos * hkv * D * 2 * 2 + B * hq * D * 2 + B * n_pages * 4 + B * 4
                       + B * hkv * pns * G * (D + 1) * 4)
    log(f"flash_decode_paged D={D} B={B} lengths={lens_run.tolist()} {n_pages} pages of {ps} "
        f"(shuffled): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
        f"{ms / b_ms:.2f}x the bound; in turns (contiguous, paged, paged, contiguous) "
        f"{[round(t, 4) for t in runs]}: paged / contiguous {ms / c_ms:.4f}")
    windowed = lambda rows: dict(windowed=rows["window"]) if window else {}
    return {
        f"flash_fwd_hd{D}": dict(max_abs_err=fwd_err, **fwd_rows["causal"], **windowed(fwd_rows)),
        f"flash_decode_hd{D}": dict(max_abs_err=dec_err, **dec_rows["causal"],
                                    **windowed(dec_rows)),
        f"flash_decode_paged_hd{D}": dict(max_abs_err=paged_err, ms=ms, plain_ms=plain_ms,
                                          bound_ms=b_ms, bound_by=b_by, library_ms=None,
                                          contiguous_ms_in_turns=c_ms),
    }


def wide_fwd_at_training_shape(torch, dev, flush, randn, D, hq, hkv, B) -> dict:
    """The head_dim-``D`` forward (rows 1g, 1l) at the training shape (B,
    S 2048, causal: a pair of q tiles a CTA; gemma3-1b's B 4, stablelm-12b's
    B 2) in turns with SDPA (kernel, SDPA, SDPA, kernel) after the L2 flush,
    held to its plain version first. The design before this one is timed
    beside it by ``tools/ab_forward.py parent``."""
    import torch.nn.functional as F

    from repro_torch.core.masks import MaskSpec
    from repro_torch.kernels import flash_fwd as fwd
    from repro_torch.kernels import ops

    S, tiles = 2048, dict(block_q=ops.BLOCK_Q, block_kv=ops.BLOCK_KV)
    spec = MaskSpec(causal=True)
    q = ops._prep(randn(B, S, hq, D), 1.0 / math.sqrt(D))
    k, v = randn(B, S, hkv, D), randn(B, S, hkv, D)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    mode = tile_mode(fwd, B, hq, S, D)
    err = check_fwd(torch, f"flash_fwd D={D} B={B} S={S} causal ({mode})",
                    fwd.flash_fwd(q, k, v, spec, **tiles),
                    fwd.flash_fwd_plain(q, k, v, spec, **tiles))
    ms, lib_ms, order = in_turns(
        torch, lambda: fwd.flash_fwd(q, k, v, spec, **tiles),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, scale=1.0,
                                               is_causal=True), 20, flush)
    b_ms, b_by = bound(4 * D * causal_pairs(S) * B * hq,
                       2 * B * S * (hq + hkv) * D * 2 + B * hq * S * 4)
    log(f"flash_fwd D={D} B={B} S={S} causal at the training shape ({mode}): kernel {ms:.4f} "
        f"ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); in turns (fwd, sdpa, sdpa, "
        f"fwd) {order}: fwd / sdpa {ms / lib_ms:.4f}")
    return {"at_training_shape": dict(ms=ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                                      mode=mode, max_abs_err=err,
                                      sdpa_ratio_in_turns=ms / lib_ms)}


def gemma3_phase(torch, dev):
    """The gemma3 serving slice: gemma3-1b at its published widths and depth
    (26 layers, d_model 1152, 4 q heads over 1 kv head of 256, a 512-token
    window on 5 of 6 layers, vocab 262,144), ``model_serving_phase``."""
    return model_serving_phase(torch, dev, "gemma3-1b", "gemma3", split_prefill=True)


def stablelm_phase(torch, dev):
    """The stablelm serving slice: stablelm-12b at its published widths and
    depth (40 layers, d_model 5120, 32 q heads over 8 kv heads of 160,
    qk-norm, d_ff 13,824, untied embeddings over a 100,352 vocab: 12.1 B
    parameters, 24.3 GB), ``model_serving_phase``."""
    return model_serving_phase(torch, dev, "stablelm-12b", "stablelm", split_prefill=True)


def granite_phase(torch, dev):
    """The granite serving slice: granite-moe-1b-a400m at its published
    widths and depth (24 layers, d_model 1024, 16 q heads over 8 kv heads of
    64, an MoE layer of 32 experts top 8 with d_expert 512 in every layer,
    tied embeddings over a 49,155 vocab: 1.34 B parameters),
    ``model_serving_phase`` with ``moe_checks``."""
    return model_serving_phase(torch, dev, "granite-moe-1b-a400m", "granite", extra=moe_checks)


MOE_TIMED_ROUNDS = 20


def moe_checks(torch, dev, model, prompts, summary) -> dict:
    """The MoE layers of a served model: one layer on a decode tick's (4, 1,
    d) and a prefill's (1, 1536, d) input under
    torch.cuda.set_sync_debug_mode("error") (no step may read a value back
    to the host); the layers' time at the decode tick's shape (B 4), on the
    host clock around a synchronise and by CUDA events, against the fixed
    engine's median tick."""
    from repro_torch.models.moe import MoE

    layers = [m for m in model.modules() if isinstance(m, MoE)]
    gen = torch.Generator(device=dev).manual_seed(11)
    d = model.cfg.d_model
    for shape in ((4, 1, d), (1, 1536, d)):
        x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            y, _ = layers[0](x, with_aux=False)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        log(f"MoE layer on {tuple(shape)} under sync debug mode 'error': no synchronisation, "
            f"finite output {bool(torch.isfinite(y).all())}")
        if not torch.isfinite(y).all():
            fail(f"the MoE layer gave non-finite values on {tuple(shape)}")

    x = torch.randn((4, 1, d), generator=gen, device=dev).to(torch.bfloat16)
    walls, events = [], []
    for _ in range(MOE_TIMED_ROUNDS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        for m in layers:
            m(x, with_aux=False)
        end.record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        events.append(start.elapsed_time(end))
    walls.sort()
    events.sort()
    wall, device = walls[len(walls) // 2], events[len(events) // 2]
    tick = summary["ticks"]["fixed"]["median_tick_ms"]
    log(f"{len(layers)} MoE layers at B=4 (one decode tick's): host wall {wall:.3f} ms, device "
        f"(events) {device:.3f} ms (medians of {MOE_TIMED_ROUNDS}); against the fixed engine's "
        f"median tick {tick:.2f} ms: {wall / tick:.4f} of the tick")
    return dict(moe=dict(tick_ms_wall=wall, tick_ms_events=device, tick_share=wall / tick))


def model_serving_phase(torch, dev, arch: str, path: str, extra=None, split_prefill=False):
    """The registry's ``arch`` uncut (bf16, random weights from seed 0)
    serves the six requests of ``serving_prompts`` through ServingEngine (4
    slots of CACHE) and PagedServingEngine (the qwen3 paged phase's pool,
    which preempts once) on the paths ``{path}_serving`` and
    ``{path}_paged_serving``, with exact launch counts (a forward a prefill
    and layer, a decode a tick and layer) and no plain version or
    reference; the prefill of the 1500-token prompt and a B = 4 decode step
    against impl="ref", the same step through shuffled pages bitwise; the
    decode ticks of both engines (``tick_phase``); then the serve CLI once
    through each engine. ``extra(torch, dev, model, prompts, summary)``, where
    given, runs after the ticks on the same model and returns entries for
    the summary; with ``split_prefill``, then ``split_prefill_checks`` (its
    counts under the summary's "split_prefill_counts" and
    "split_serving_counts"). Returns both runs' counts and a summary."""
    from repro_torch.configs import registry
    from repro_torch.core.attention import AttentionConfig, check_card_support
    from repro_torch.kernels import flash_decode as dec
    from repro_torch.kernels import flash_fwd as fwd
    from repro_torch.launch import serve
    from repro_torch.models.lm import init_lm
    from repro_torch.serving.engine import PagedServingEngine, Request, ServingEngine

    cfg = registry.get(arch)
    fl_cfg, ref_cfg = AttentionConfig(impl="flash_cuda"), AttentionConfig(impl="ref")
    for paged in (False, True):
        check_card_support(cfg, fl_cfg, dev, training=False, paged=paged)
    t0 = time.perf_counter()
    model = init_lm(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"{arch}: {cfg.num_layers} layers {cfg.layer_pattern} (window {cfg.window}), d_model "
        f"{cfg.d_model}, {cfg.num_heads} q heads over {cfg.num_kv_heads} kv heads of "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}: {n_params / 1e9:.3f} B "
        f"params ({cfg.dtype}, {torch.cuda.memory_allocated(dev) / 1e9:.1f} GB allocated), "
        f"initialised in {time.perf_counter() - t0:.1f} s")
    n = cfg.num_layers
    prompts = serving_prompts(cfg)
    summary = {}

    engine = ServingEngine(cfg, model, fl_cfg, max_batch=4, cache_size=CACHE)
    for rid, prompt in enumerate(prompts):
        engine.submit(Request(rid=rid, prompt=prompt, max_new_tokens=MAX_NEW))
    counts, summary["fixed"] = run_engine(torch, dev, cfg, engine, len(prompts),
                                          f"{path}_serving")
    fixed_tokens = {rid: list(req.generated) for rid, req in engine.finished.items()}
    if (counts["flash_fwd"] != len(prompts) * n or counts["flash_decode"] != engine.ticks * n
            or counts["flash_decode_paged"]):
        fail(f"{arch} serving: want flash_fwd {len(prompts) * n} (a prefill a request and "
             f"layer), flash_decode {engine.ticks * n} (a tick and layer), paged 0")

    engine = PagedServingEngine(cfg, model, fl_cfg, max_batch=4, num_pages=PAGED_POOL_PAGES,
                                page_size=PAGE_SIZE, pages_per_seq_max=PAGES_PER_SEQ)
    for rid, prompt in enumerate(prompts):
        engine.submit(Request(rid=rid, prompt=prompt, max_new_tokens=MAX_NEW))
    paged_counts, summary["paged"] = run_engine(torch, dev, cfg, engine, len(prompts),
                                                f"{path}_paged_serving")
    summary["paged"]["preemptions"] = engine.preemptions
    log(f"{path}_paged_serving: preemptions {engine.preemptions} (expected "
        f"{PAGED_PREEMPTIONS}); pages in use at the end {engine.pool.used_pages}")
    if (engine.preemptions != PAGED_PREEMPTIONS or engine.pool.used_pages
            or paged_counts["flash_decode_paged"] != engine.ticks * n
            or paged_counts["flash_decode"] or paged_counts["flash_fwd"] != PAGED_PREFILLS * n):
        fail(f"{arch} paged serving: the preemption, the pool or the launch counts are wrong")

    # Logits against the dense reference on the card: the prefill of the
    # 1500-token prompt (three of gemma3's windows long), then a B = 4 decode
    # step from its cache at ragged lengths (inside and past such a window).
    # An MoE model's reference runs replay the kernels' run's expert choices
    # (``reference_run``).
    tokens_in = torch.tensor([prompts[3]], device=dev)
    what = f"{arch} prefill of {len(prompts[3])} tokens"
    with routing() as fl_choices:
        h_fl, cache_fl, _ = model.prefill(tokens_in, fl_cfg, CACHE)
    l_fl = model.logits_from_hidden(h_fl)
    l_ref, summary["prefill_routing"] = reference_run(
        torch, what, lambda: model.logits_from_hidden(model.prefill(tokens_in, ref_cfg, CACHE)[0]),
        l_fl, fl_choices)
    compare_logits(torch, what, l_ref, l_fl)
    cache_fl = [{"kv": {k: t.expand(4, -1, -1, -1).clone() for k, t in c["kv"].items()}}
                for c in cache_fl]
    cache_ref = [{"kv": {k: t.clone() for k, t in c["kv"].items()}} for c in cache_fl]
    table = shuffled_table(torch, 4, PAGES_PER_SEQ, 3).to(dev)
    planes = [{"kv": {k: paginate(torch, t, table, 4 * PAGES_PER_SEQ + 1)
                      for k, t in c["kv"].items()}} for c in cache_fl]
    step_len = torch.tensor([len(prompts[3]), 1, 700, 513], dtype=torch.int32, device=dev)
    first = int(l_fl[..., :cfg.vocab_size].argmax())
    step_tok = torch.tensor([[first], [5], [17], [99]], device=dev)
    what = f"{arch} decode step, B=4, lengths {step_len.tolist()}"
    with routing() as fl_choices:
        d_fl, _ = model.decode_step(step_tok, cache_fl, step_len, fl_cfg)
    d_ref, summary["decode_routing"] = reference_run(
        torch, what, lambda: model.decode_step(
            step_tok, [{"kv": {k: t.clone() for k, t in c["kv"].items()}} for c in cache_ref],
            step_len, ref_cfg)[0],
        d_fl, fl_choices)
    d_pg, _ = model.decode_step(step_tok, planes, step_len, fl_cfg, block_table=table)
    compare_logits(torch, what, d_ref, d_fl)
    same = torch.equal(d_fl, d_pg)
    log(f"{arch} decode step through shuffled pages of {PAGE_SIZE}: logits bitwise the "
        f"contiguous cache's {same}")
    if not same:
        fail(f"{arch}: the paged decode step's logits differ from the contiguous one's")
    del cache_fl, cache_ref, planes

    summary["ticks"] = tick_phase(torch, cfg, model)
    if extra is not None:
        summary.update(extra(torch, dev, model, prompts, summary))
    if split_prefill:
        summary["split_prefill_counts"], summary["split_serving_counts"], summary["split"] = (
            split_prefill_checks(torch, dev, cfg, model, prompts, l_ref, fixed_tokens, path))
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # The serve CLI on the card, as a user runs it (short prompts, its own
    # model from --seed 0).
    kernels = (fwd.flash_fwd, dec.flash_decode, dec.flash_decode_paged)
    for engine_name, used in (("fixed", dec.flash_decode), ("paged", dec.flash_decode_paged)):
        for f in kernels:
            f.launches = 0
        serve.main(["--arch", arch, "--engine", engine_name, "--requests", "4",
                    "--max-new", "8"])
        got = {f.__name__: f.launches for f in kernels}
        log(f"serve CLI --arch {arch} --engine {engine_name}: launches {got}")
        if not (fwd.flash_fwd.launches and used.launches) or sum(got.values()) != (
                fwd.flash_fwd.launches + used.launches):
            fail(f"the serve CLI's {engine_name} engine did not run through its kernels")
        gc.collect()
        torch.cuda.empty_cache()
    return counts, paged_counts, summary



# gemma3-1b training: the synthetic stream at B 4, S 2048 (the length the
# port's qwen3 slice trains at; four sequences fill one card's memory with
# room to spare), 8 AdamW steps, the model uncut.
G3_TRAIN_B, G3_TRAIN_S, G3_TRAIN_STEPS = 4, 2048, 8
# The median fused-backward training steps of gemma3-1b and stablelm-12b
# (unpacked, the shapes below) in this script's earlier runs on an H100
# 80GB HBM3 at 700 W, before the one-tile backward's redesign at 256 and
# 160: logged beside this run's. Another call, not in turns: a reference,
# not a comparison.
G3_TRAIN_MS_BEFORE, SL_TRAIN_MS_BEFORE = 415.3, 378.5
# stablelm-12b training: the depth cut to 8 of 40 layers (qwen3-8b's cut,
# TRAIN_LAYERS: 3.25 B parameters, about 52 GB of bf16 weights and
# gradients, f32 master, mu and nu), the qwen3 slice's B 2, S 2048, 8 AdamW
# steps. The head_dim-160 backward's shapes: the training shape (timed), a
# ragged S (1500: an odd number of tiles and a ragged last one), and rows
# that see no key (q_offset -100).
SL_TRAIN_LAYERS, SL_TRAIN_B, SL_TRAIN_S, SL_TRAIN_STEPS = TRAIN_LAYERS, TRAIN_B, TRAIN_S, 8
HD160_BWD_SHAPES = {
    "causal": (SL_TRAIN_B, SL_TRAIN_S, dict(causal=True)),
    "causal_1500": (1, 1500, dict(causal=True)),
    "masked_rows_300": (1, 300, dict(causal=True, q_offset=-100)),
}
# The head_dim-256 backward's shapes, (B, S, spec): the training shape with
# gemma3's global (causal) and local (window 512) layers, an odd number of
# tiles with the window (one tile a CTA at 256), a ragged S, and rows that
# see no key (q_offset -100: rows 64-99 inside a tile the kernels visit).
HD256_BWD_SHAPES = {
    "causal": (G3_TRAIN_B, G3_TRAIN_S, dict(causal=True)),
    "window": (G3_TRAIN_B, G3_TRAIN_S, dict(causal=True, window=G3_WINDOW)),
    "window_700": (1, 700, dict(causal=True, window=G3_WINDOW)),
    "causal_333": (2, 333, dict(causal=True)),
    "masked_rows_300": (1, 300, dict(causal=True, q_offset=-100)),
}


def hd256_bwd_kernel_phase(torch, dev, flush):
    """The four backward kernels at head_dim 256 (gemma3-1b: 4 q heads over
    1 kv head) at every HD256_BWD_SHAPES shape (``head_dim_bwd_kernel_phase``;
    the training shape timed causal and with the window 512), then the SEG
    forward, fused, dK/dV and dQ at the packed training shape, causal and
    with the window (``head_dim_seg_kernel_phase``), and the group-sum kernel
    that sums the training shape's causal launches' partials
    (``group_sum_phase``)."""
    from repro_torch.core.masks import MaskSpec

    return {**head_dim_bwd_kernel_phase(torch, dev, flush, G3_D, G3_HQ, G3_HKV, HD256_BWD_SHAPES,
                                        (G3_TRAIN_B, G3_TRAIN_S), seed=11),
            **head_dim_seg_kernel_phase(torch, dev, flush, G3_D, G3_HQ, G3_HKV, G3_TRAIN_B,
                                        G3_TRAIN_S, {"causal": MaskSpec(causal=True),
                                                     "window": MaskSpec(causal=True,
                                                                        window=G3_WINDOW)},
                                        G3_VOCAB, seed=21),
            **group_sum_phase(torch, dev, flush, G3_D, G3_TRAIN_B, G3_TRAIN_S, G3_HQ, G3_HKV,
                              seed=41)}


def hd160_bwd_kernel_phase(torch, dev, flush):
    """The four backward kernels at head_dim 160 (stablelm-12b: 32 q heads
    over 8 kv heads) at every HD160_BWD_SHAPES shape
    (``head_dim_bwd_kernel_phase``; the training shape timed), then the SEG
    kernels at the packed training shape (``head_dim_seg_kernel_phase``) and
    the group-sum kernel on partials of the training shape, one q head a
    share (``group_sum_phase``; stablelm's own launches take no split)."""
    from repro_torch.core.masks import MaskSpec

    return {**head_dim_bwd_kernel_phase(torch, dev, flush, SL_D, SL_HQ, SL_HKV, HD160_BWD_SHAPES,
                                        (SL_TRAIN_B, SL_TRAIN_S), seed=12),
            **head_dim_seg_kernel_phase(torch, dev, flush, SL_D, SL_HQ, SL_HKV, SL_TRAIN_B,
                                        SL_TRAIN_S, {"causal": MaskSpec(causal=True)}, SL_VOCAB,
                                        seed=22),
            **group_sum_phase(torch, dev, flush, SL_D, SL_TRAIN_B, SL_TRAIN_S, SL_HQ, SL_HKV,
                              seed=42)}


SEG_NAMES = ("flash_fwd", "flash_bwd_fused", "flash_bwd_dkv", "flash_bwd_dq")


def group_sum_phase(torch, dev, flush, D, B, S, hq, hkv, *, seed):
    """The group-sum kernel at head_dim ``D`` on random f32 partials of the
    training shape (B, S, ``hq`` shares over ``hkv`` kv heads: one q head a
    share, the halves of one scratch buffer as the wrapper allocates them)
    against its plain version, bitwise (the same adds in the same order),
    then timed after an L2 flush beside its bound (bytes: the partials read
    once, the sums written once; its (G - 1) f32 adds an output value are
    far below the card's f32 rate), its plain version and one PyTorch call
    that computes the same sums (``sum`` over the shares of the buffer).
    Returns {name: row}."""
    from repro_torch.kernels import flash_bwd as bwd

    gen = torch.Generator(device=dev).manual_seed(seed)
    parts = torch.randn((2, B, S, hq, D), generator=gen, device=dev)
    pk, pv = parts[0], parts[1]
    got = bwd.flash_bwd_group_sum(pk, pv, hkv)
    torch.cuda.synchronize()
    want = bwd.flash_bwd_group_sum_plain(pk, pv, hkv)
    err = max(max_err(torch, a, b) for a, b in zip(got, want))
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    G = hq // hkv
    b_ms, b_by = bound(0, parts.numel() * 4 + 2 * B * S * hkv * D * 4)
    ms = time_ms(torch, lambda: bwd.flash_bwd_group_sum(pk, pv, hkv), 20, flush)
    plain_ms = time_ms(torch, lambda: bwd.flash_bwd_group_sum_plain(pk, pv, hkv), 5, flush)
    view = parts.view(2, B, S, hkv, G, D)
    lib_ms = time_ms(torch, lambda: view.sum(dim=4), 20, flush)
    log(f"flash_bwd_group_sum (head_dim {D}) on partials (2, {B}, {S}, {hq}, {D}) f32, {G} "
        f"shares a kv head: bitwise its plain version: {same} (max|err| {err:.3e}); kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), {ms / b_ms:.2f}x "
        f"the bound; library (sum over the shares) {lib_ms:.4f} ms")
    if not same:
        fail(f"flash_bwd_group_sum (head_dim {D}) is not its plain version to the bit")
    return {f"flash_bwd_group_sum_hd{D}": dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                               bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)}


def head_dim_seg_kernel_phase(torch, dev, flush, D, hq, hkv, B, S, specs, vocab, *, seed):
    """The segment (SEG) forward, fused, dK/dV and dQ kernels at head_dim
    ``D``, ``hq`` q heads over ``hkv`` kv heads, at the packed training shape
    (B, S) with the packed source's step-0 ids (at the model's ``vocab``, as
    ``train(packed=True)`` makes them), under each mask of ``specs`` ({name:
    MaskSpec}; the first gives the top-level numbers, a "window" one goes
    under ``windowed``): each against its plain version, split dK/dV bitwise
    the fused kernel's, split dQ bitwise over two launches, all-ones ids
    bitwise the unsegmented kernels; then at S 700 distinct q and kv ids
    under the first mask: (0, -inf) and zero gradients where a tile sees
    nothing. Then each timed after the L2 flush in turns with the
    unsegmented kernel (seg, full, full, seg), its plain version, its bound
    over the same-segment pairs the mask needs, and SDPA with the
    block-diagonal mask (the forward; the fused kernel: forward + backward
    less forward; dK/dV and dQ alone have no library call). Returns the
    records of ``<kernel>_varlen_hd{D}``."""
    from repro_torch.kernels import flash_bwd as bwd
    from repro_torch.kernels import flash_fwd as fwd
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    tiles = dict(block_q=ops.BLOCK_Q, block_kv=ops.BLOCK_KV)

    def inputs(Bc, Sc):
        return (ops._prep(randn(Bc, Sc, hq, D), 1 / math.sqrt(D)), randn(Bc, Sc, hkv, D),
                randn(Bc, Sc, hkv, D), randn(Bc, Sc, hq, D))

    def run(q, k, v, do, spec, q_seg, kv_seg):
        o, lse = fwd.flash_fwd_varlen(q, k, v, spec, q_seg, kv_seg, **tiles)
        delta = bwd.flash_bwd_delta(o, do)
        args = (q, k, v, do, lse, delta, spec, q_seg, kv_seg)
        fused = bwd.flash_bwd_fused_varlen(*args, **tiles)
        dk, dv = bwd.flash_bwd_dkv_varlen(*args, **tiles)
        dq, dq2 = (bwd.flash_bwd_dq_varlen(*args, **tiles) for _ in range(2))
        torch.cuda.synchronize()
        return o, lse, delta, fused, dk, dv, dq, dq2

    ids = torch.from_numpy(packed_ids(B, S, vocab=vocab)).to(dev)
    ones = torch.ones_like(ids)
    first = next(iter(specs))
    cases = [(B, S, name, spec, ids, ids) for name, spec in specs.items()]
    cases.append((2, 700, f"{first}, distinct q/kv ids", specs[first],
                  *distinct_ids(torch, dev, 2, 700)))
    err = {name: 0.0 for name in SEG_NAMES}
    for Bc, Sc, name, spec, q_seg, kv_seg in cases:
        what = f"D={D} B={Bc} S={Sc} Hq={hq} Hkv={hkv} {name}"
        q, k, v, do = inputs(Bc, Sc)
        o, lse, delta, fused, dk, dv, dq, dq2 = run(q, k, v, do, spec, q_seg, kv_seg)
        plain = dict(q_seg=q_seg, kv_seg=kv_seg, **tiles)
        args = (q, k, v, do, lse, delta, spec)
        eo = check_fwd(torch, f"flash_fwd_varlen {what}", (o, lse),
                       fwd.flash_fwd_plain(q, k, v, spec, **plain))
        want = bwd.flash_bwd_fused_plain(*args, **plain)
        want_dkv = bwd.flash_bwd_dkv_plain(*args, **plain)
        want_dq = bwd.flash_bwd_dq_plain(*args, **plain)
        rel = {}
        for label, a, b in (("fused dq", fused[0], want[0]), ("fused dk", fused[1], want[1]),
                            ("fused dv", fused[2], want[2]), ("dkv dk", dk, want_dkv[0]),
                            ("dkv dv", dv, want_dkv[1]), ("dq", dq, want_dq)):
            if not torch.isfinite(a).all():
                fail(f"a SEG backward kernel gave a non-finite {label} ({what})")
            rel[label] = max_err(torch, a, b) / max(b.abs().max().item(), 1e-6)
        bit_dkv = torch.equal(dk, fused[1]) and torch.equal(dv, fused[2])
        bit_dq = torch.equal(dq, dq2)
        log(f"SEG backward {what}: relative to max|grad| "
            + ", ".join(f"{n} {e:.3e}" for n, e in rel.items())
            + f" (tol {GRAD_REL_TOL}); split dk, dv bitwise the fused kernel's: {bit_dkv}; "
            f"split dq bitwise over two launches: {bit_dq}")
        if max(rel.values()) > GRAD_REL_TOL:
            fail(f"a SEG backward kernel at head_dim {D} disagrees with its plain version "
                 f"({what})")
        if not (bit_dkv and bit_dq):
            fail(f"the SEG split backward at head_dim {D} lost a bitwise invariant ({what})")
        err["flash_fwd"] = max(err["flash_fwd"], eo)
        err["flash_bwd_fused"] = max(err["flash_bwd_fused"],
                                     *(max_err(torch, a, b) for a, b in zip(fused, want)))
        err["flash_bwd_dkv"] = max(err["flash_bwd_dkv"], max_err(torch, dk, want_dkv[0]),
                                   max_err(torch, dv, want_dkv[1]))
        err["flash_bwd_dq"] = max(err["flash_bwd_dq"], max_err(torch, dq, want_dq))
        if "distinct" in name:
            zeros = bool((o[:, :64] == 0).all() and torch.isneginf(lse[..., :64]).all()
                         and (fused[0][:, :64] == 0).all() and (dq[:, :64] == 0).all()
                         and (dk[:, -64:] == 0).all() and (dv[:, -64:] == 0).all())
            log(f"  distinct ids at D={D}: q tile 0 gives o = 0, lse = -inf, dq = 0 and the "
                f"last kv tile dk = dv = 0: {zeros}")
            if not zeros:
                fail(f"a tile that sees nothing must give o = 0, lse = -inf and zero gradients "
                     f"(head_dim {D})")
            continue
        # All-ones ids on the same inputs: bitwise the unsegmented kernels.
        o_u, lse_u = fwd.flash_fwd(q, k, v, spec, **tiles)
        o1, lse1, delta1, fused1, dk1, dv1, dq1, _ = run(q, k, v, do, spec, ones, ones)
        full_args = (q, k, v, do, lse_u, delta1, spec)
        _, dk_f, dv_f = bwd.flash_bwd_fused(*full_args, **tiles)
        dk_u, dv_u = bwd.flash_bwd_dkv(*full_args, **tiles)
        dq_u = bwd.flash_bwd_dq(*full_args, **tiles)
        torch.cuda.synchronize()
        same = {"o": torch.equal(o_u, o1), "lse": torch.equal(lse_u, lse1),
                "fused dk, dv": torch.equal(dk_f, fused1[1]) and torch.equal(dv_f, fused1[2]),
                "dkv dk, dv": torch.equal(dk_u, dk1) and torch.equal(dv_u, dv1),
                "dq": torch.equal(dq_u, dq1)}
        log(f"  all-ones ids at {what}, bitwise the unsegmented kernels: {same}")
        if not all(same.values()):
            fail(f"all-ones ids do not give the unsegmented kernels' outputs bitwise at head_dim "
                 f"{D} ({name})")

    rows = {}
    for name, spec in specs.items():
        q, k, v, do = inputs(B, S)
        o, lse = fwd.flash_fwd_varlen(q, k, v, spec, ids, ids, **tiles)
        delta = bwd.flash_bwd_delta(o, do)
        seg_args = (q, k, v, do, lse, delta, spec, ids, ids)
        full_args = seg_args[:7]
        kernels = {
            "flash_fwd": (lambda: fwd.flash_fwd_varlen(q, k, v, spec, ids, ids, **tiles),
                          lambda: fwd.flash_fwd(q, k, v, spec, **tiles)),
            "flash_bwd_fused": (lambda: bwd.flash_bwd_fused_varlen(*seg_args, **tiles),
                                lambda: bwd.flash_bwd_fused(*full_args, **tiles)),
            "flash_bwd_dkv": (lambda: bwd.flash_bwd_dkv_varlen(*seg_args, **tiles),
                              lambda: bwd.flash_bwd_dkv(*full_args, **tiles)),
            "flash_bwd_dq": (lambda: bwd.flash_bwd_dq_varlen(*seg_args, **tiles),
                             lambda: bwd.flash_bwd_dq(*full_args, **tiles)),
        }
        plain = dict(q_seg=ids, kv_seg=ids, **tiles)
        plains = {
            "flash_fwd": lambda: fwd.flash_fwd_plain(q, k, v, spec, **plain),
            "flash_bwd_fused": lambda: bwd.flash_bwd_fused_plain(*full_args, **plain),
            "flash_bwd_dkv": lambda: bwd.flash_bwd_dkv_plain(*full_args, **plain),
            "flash_bwd_dq": lambda: bwd.flash_bwd_dq_plain(*full_args, **plain),
        }
        mask = segment_mask(torch, ids)
        if spec.window is not None:
            ago = torch.arange(S, device=dev)[:, None] - torch.arange(S, device=dev)[None, :]
            mask = mask & (ago < spec.window)[None, None]
        lib_fwd_ms, lib_fb_ms = sdpa_times(torch, q, k, v, do, flush, mask)
        library = {"flash_fwd": lib_fwd_ms, "flash_bwd_fused": lib_fb_ms - lib_fwd_ms,
                   "flash_bwd_dkv": None, "flash_bwd_dq": None}
        pairs = segment_pairs(ids.cpu().numpy(), spec.window)
        full_pairs = B * causal_pairs(S, spec.window)
        bounds = attention_bounds(pairs, B, S, id_bytes=2 * B * S * 4, Hq=hq, Hkv=hkv, D=D)
        log(f"SEG kernels at D={D} B={B} S={S} {name}: documents per row "
            f"{[int(r.max()) for r in ids]}, same-segment pairs {pairs} of {full_pairs} "
            f"({pairs / full_pairs:.4f})")
        rows[name] = {}
        for kname, (seg_fn, full_fn) in kernels.items():
            runs = [time_ms(torch, f, 20, flush) for f in (seg_fn, full_fn, full_fn, seg_fn)]
            seg_ms, full_ms = (runs[0] + runs[3]) / 2, (runs[1] + runs[2]) / 2
            plain_ms = time_ms(torch, plains[kname], 2, flush)
            b_ms, b_by = bounds[kname]
            lib = library[kname]
            log(f"  {kname}_varlen D={D} {name}: kernel {seg_ms:.4f} ms, the unsegmented kernel "
                f"in turns {full_ms:.4f} ms (ratio {seg_ms / full_ms:.4f}; turns "
                f"{[round(t, 4) for t in runs]}), plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
                f"({b_by}), {seg_ms / b_ms:.2f}x the bound; library "
                + ("none" if lib is None else f"{lib:.4f} ms (SDPA, block-diagonal mask)"))
            rows[name][kname] = dict(ms=seg_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                     library_ms=lib, unsegmented_ms_same_call=full_ms,
                                     segment_pairs=pairs)
    out = {}
    for kname in SEG_NAMES:
        rec = dict(max_abs_err=err[kname], **rows[first][kname])
        if "window" in rows:
            rec["windowed"] = rows["window"][kname]
        out[f"{kname}_varlen_hd{D}"] = rec
    return out


def head_dim_bwd_kernel_phase(torch, dev, flush, D, hq, hkv, shapes, timed_at, *, seed):
    """The four backward kernels at head_dim ``D``, ``hq`` q heads over
    ``hkv`` kv heads, against their plain versions at every (B, S, spec) of
    ``shapes``, with the bitwise invariants (split dK/dV the fused kernel's,
    dQ over two launches); the shapes at ``timed_at`` (B, S) timed
    (``bwd_kernels_at``; SDPA with a window as an explicit mask). The
    "causal" shape gives each kernel's top-level numbers; every timed
    shape's are under ``at_shapes``."""
    from repro_torch.core.masks import MaskSpec

    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    errs = {name: 0.0 for name in BWD_NAMES}
    at = {name: {} for name in BWD_NAMES}
    for shape, (B, S, spec_kw) in shapes.items():
        spec = MaskSpec(**spec_kw)
        what = f"{shape} B={B} S={S} Hq={hq} Hkv={hkv} D={D} {spec_kw}"
        timed = (B, S) == timed_at
        sdpa_kw = None
        if timed and spec.window is not None:
            ago = torch.arange(S, device=dev)[:, None] - torch.arange(S, device=dev)[None, :]
            sdpa_kw = dict(mask=((ago >= 0) & (ago < spec.window))[None, None])
        e, rows = bwd_kernels_at(torch, randn, D, B, S, S, hq, hkv, spec,
                                 B * causal_pairs(S, spec.window), what, flush, timed=timed,
                                 sdpa_kw=sdpa_kw)
        for name in BWD_NAMES:
            errs[name] = max(errs[name], e[name])
            if timed:
                at[name][shape] = rows[name]
    return {f"{name}_hd{D}": dict(max_abs_err=errs[name], **at[name]["causal"],
                                  at_shapes=at[name]) for name in BWD_NAMES}


def gemma3_train_phase(torch, dev, packed: bool = False):
    """The gemma3 training slice: gemma3-1b at its published widths and depth
    (26 layers, d_model 1152, 4 q heads over 1 kv head of 256, a 512-token
    window on 5 of 6 layers, tied embeddings over a 262,144 vocab) at B 4,
    S 2048, ``model_train_phase`` (``packed``: on the packed source, through
    the segment kernels). Remat recomputes each group of cfg.group_size (6)
    layers in the backward; the tail layers (26 % 6 = 2) are not
    checkpointed, as in the JAX package (lm.py:255): 2 x 24 + 2 forward
    launches a step."""
    from repro_torch.configs import registry
    from repro_torch.core.masks import MaskSpec

    return model_train_phase(torch, dev, registry.get("gemma3-1b"), G3_TRAIN_B, G3_TRAIN_S,
                             G3_TRAIN_STEPS, (MaskSpec(causal=True),
                                              MaskSpec(causal=True, window=G3_WINDOW)),
                             packed=packed, before_ms=None if packed else G3_TRAIN_MS_BEFORE)


def stablelm_train_phase(torch, dev, packed: bool = False):
    """The stablelm training slice: stablelm-12b at its published widths
    (d_model 5120, 32 q heads over 8 kv heads of 160, qk-norm, d_ff 13,824,
    untied embeddings over a 100,352 vocab), depth cut to SL_TRAIN_LAYERS
    of 40 (one card's memory: AdamW's f32 master, mu and nu beside the bf16
    weights and gradients), at B 2, S 2048, ``model_train_phase``
    (``packed``: on the packed source, through the segment kernels). Its
    remat groups are single layers, so every layer runs the forward twice a
    step."""
    from repro_torch.configs import registry
    from repro_torch.core.masks import MaskSpec

    cfg = dataclasses.replace(registry.get("stablelm-12b"), num_layers=SL_TRAIN_LAYERS)
    return model_train_phase(torch, dev, cfg, SL_TRAIN_B, SL_TRAIN_S, SL_TRAIN_STEPS,
                             (MaskSpec(causal=True),), packed=packed,
                             before_ms=None if packed else SL_TRAIN_MS_BEFORE)


def model_train_phase(torch, dev, cfg, B, S, steps, specs, packed: bool = False,
                      before_ms=None):
    """``cfg`` (bf16, remat, seed 0) through the train CLI's ``train`` on the
    synthetic stream (``B`` x ``S``, ``steps`` AdamW steps; ``packed``: the
    packed (varlen) source, ``TrainLoopConfig(packed=True)``), with the
    fused and with the split backward, and once through impl="ref" from the
    same seed and batches. Each kernel run's launches must be exact (per
    layer and step: the forward twice in the layers of the remat groups and
    once in the tail layers, delta once, the fused kernel or dK/dV and dQ
    once, all at cfg.head_dim; packed: their segment variants, no
    unsegmented kernel; no plain version), its loss must fall, step 0's
    loss must be the reference's within PARITY_LOSS_REL and every step's
    within GPT_LOSS_REL, and step 0's loss the same through both backward
    modes (the same forward). One more fused step under torch.profiler
    gives the device busy share and attention's device time and share.
    Then ops.flash_attention(bwd="split") (packed: flash_attention_varlen on
    the source's step-0 ids) forward and backward twice at the training
    shape under each mask of ``specs`` must give bitwise-equal gradients.
    ``before_ms``: the earlier design's median fused step, logged beside
    this run's. Returns {bwd: launch counts} and {bwd: summary}."""
    import numpy as np

    from repro_torch.core.attention import AttentionConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, SyntheticVarlenLM
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import build_train_step
    from repro_torch.launch.train import TrainLoopConfig, train
    from repro_torch.training.optimizer import AdamWConfig

    arch, D = cfg.name, cfg.head_dim
    what = f"{arch} {'packed ' if packed else ''}training"
    opt_cfg = AdamWConfig(warmup_steps=2, total_steps=steps)
    grouped = cfg.num_groups * cfg.group_size
    forwards = steps * (2 * grouped + cfg.num_layers - grouped)
    if packed:  # the batches train() draws: the same source, seed and steps
        source = SyntheticVarlenLM(DataConfig(B, S, cfg.vocab_size, seed=0, source="packed"))
        batch0 = source.batch(0)
        real = float(np.mean([source.batch(step)["loss_mask"].mean() for step in range(steps)]))
        log(f"{what}: documents per row at step 0 {batch0['segment_ids'].max(axis=1).tolist()}, "
            f"non-padding share over the {steps} steps {real:.4f}")
    else:
        inputs, targets = SyntheticLM(DataConfig(B, S, cfg.vocab_size, seed=0)).batch(0)
        batch0 = {"inputs": inputs, "targets": targets}
    counters, plains = kernel_counters()
    counts, summaries, losses = {}, {}, {}
    for run in ("fused", "split", "ref"):
        loop = TrainLoopConfig(steps=steps, seq_len=S, batch_size=B, log_every=1, seed=0,
                               device=str(dev), attn_impl="ref" if run == "ref" else "flash_cuda",
                               attn_bwd=None if run == "ref" else run, packed=packed)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        zero_counts(counters, plains)
        model, opt_state, history = train(cfg, loop, opt_cfg)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in model.parameters())
        losses[run] = history["loss"]
        if not all(math.isfinite(x) for x in history["loss"] + history["grad_norm"]):
            fail(f"{what} ({run}) gave a non-finite loss or gradient norm")
        if run == "ref":
            del model, opt_state
            break
        counts[run] = read_counts(counters, plains)
        med = sorted(history["step_time"])[steps // 2]
        mfu = train_model_flops(cfg, B, S) / med / PEAK_BF16_FLOPS
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        summaries[run] = dict(losses=history["loss"], median_ms=med * 1e3,
                              tokens_per_s=B * S / med, mfu=mfu, peak_gib=peak, busy_share=None,
                              attention_ms=None)
        if packed:
            summaries[run].update(non_padding_share=real, real_tokens_per_s=real * B * S / med)
        log(f"{what} (bwd={run}) at published widths, {cfg.num_layers} layers, "
            f"B={B} S={S}, {n_params / 1e9:.4f} B params: losses {[round(x, 5) for x in history['loss']]}; median step "
            f"{med * 1e3:.1f} ms (first {history['step_time'][0] * 1e3:.1f} ms), "
            f"{B * S / med:.1f} tokens/s"
            + (f" (B x S; non-padding share {real:.4f}: {real * B * S / med:.1f} real tokens/s)"
               if packed else "")
            + f", model FLOPs {train_model_flops(cfg, B, S) / 1e12:.3f} TFLOP a step"
            + (" (full causal attention, not the same-segment pairs)" if packed else "")
            + f", MFU {mfu:.4f} of {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s, "
            f"max_memory_allocated {peak:.2f} GiB")
        log(f"launches on the {what} path (bwd={run}): {counts[run]}")
        if run == "fused" and before_ms is not None:
            summaries[run]["median_ms_before"] = before_ms
            log(f"{what} (bwd=fused) median step {med * 1e3:.1f} ms; the earlier backward design's "
                f"{before_ms} ms (an earlier run of this script, another call: not in turns)")
        if not sum(history["loss"][-2:]) / 2 < history["loss"][0]:
            fail(f"the {what} loss (bwd={run}) did not fall")
        want = training_want(counters, plains, steps * cfg.num_layers, (run,),
                             "_varlen" if packed else "", head_dim=D, forwards=forwards,
                             group_sums=group_sum_launches(cfg, B, S, steps))
        if counts[run] != want:
            fail(f"{what} launches (bwd={run}) {counts[run]}, want {want} "
                 "(the forward twice a layer of the remat groups, once a tail layer)")
        if run == "fused":
            batch = {k: torch.from_numpy(v).to(dev) for k, v in batch0.items()}
            step_fn = build_train_step(cfg, AttentionConfig(impl="flash_cuda"), opt_cfg)
            busy, attn_ms = profile_train_step(torch, step_fn, model, opt_state, batch, med)
            share = None if attn_ms is None else attn_ms / (busy * med * 1e3)
            summaries[run].update(busy_share=busy, attention_ms=attn_ms, attention_share=share)
            log(f"attention device time per {what} step: " + (
                "not measured" if attn_ms is None else f"{attn_ms:.3f} ms of the profiled step, "
                f"{share:.4f} of its device busy time"))
            del batch
        del model, opt_state
    log(f"{what} through impl=ref (dense attention"
        + (", segment mask" if packed else "") + f"): losses "
        f"{[round(x, 5) for x in losses['ref']]}")
    if losses["split"][0] != losses["fused"][0]:
        fail(f"{what}: step 0's loss through bwd=split ({losses['split'][0]!r}) differs from "
             f"bwd=fused's ({losses['fused'][0]!r}); the forward is the same")
    for run in ("fused", "split"):
        rel = [abs(a - b) / abs(b) for a, b in zip(losses[run], losses["ref"])]
        summaries[run]["loss_rel_to_ref"] = rel
        log(f"{what} bwd={run} against impl=ref, relative loss difference by step: "
            + ", ".join(f"{r:.3e}" for r in rel) + f" (step 0 limit {PARITY_LOSS_REL}, every "
            f"step {GPT_LOSS_REL})")
        if not (rel[0] <= PARITY_LOSS_REL and max(rel) <= GPT_LOSS_REL):
            fail(f"{what} through flash_cuda (bwd={run}) disagrees with impl=ref")
    log(summary_line(f"{what}, split against fused backward", summaries["split"],
                     summaries["fused"]))

    gen = torch.Generator(device=dev).manual_seed(4)
    shapes = ((B, S, cfg.num_heads, D), (B, S, cfg.num_kv_heads, D),
              (B, S, cfg.num_kv_heads, D))
    q0, k0, v0 = (torch.randn(s, generator=gen, device=dev).to(torch.bfloat16) for s in shapes)
    do = torch.randn(shapes[0], generator=gen, device=dev).to(torch.bfloat16)
    ids = torch.from_numpy(batch0["segment_ids"]).to(dev) if packed else None
    for spec in specs:
        grads = []
        for _ in range(2):
            q, k, v = (x.clone().requires_grad_() for x in (q0, k0, v0))
            if packed:
                o = ops.flash_attention_varlen(q, k, v, ids, spec, bwd="split")
            else:
                o = ops.flash_attention(q, k, v, spec, bwd="split")
            o.backward(do)
            grads.append((q.grad, k.grad, v.grad))
        torch.cuda.synchronize()
        same = [torch.equal(a, b) for a, b in zip(*grads)]
        log(f"ops.flash_attention{'_varlen' if packed else ''}(bwd=split) forward + backward "
            f"twice at B={B} S={S} Hq={cfg.num_heads} Hkv={cfg.num_kv_heads} D={D} "
            f"window={spec.window}: dq, dk, dv bitwise equal {same}")
        if not all(same) or not all(torch.isfinite(g.float()).all() for g in grads[0]):
            fail(f"the {'packed ' if packed else ''}split backward at head_dim {D} is not "
                 "bitwise reproducible (or not finite)")
    return counts, summaries


# Spill stores (bytes) of the KV-stationary instantiations, fa2_bwd_{fused,
# dkv}_kernel<D, SEG, DENSE>, in the design before the one-tile kernels'
# redesign at 160 and 256 (both warpgroups computing S^T and dP^T, one dQ
# staging a warpgroup, no head split), read from ptxas on the H100 machine:
# the redesigned ones may spill no more, and the pair kernels (64, 128),
# whose body the redesign leaves as it was, no more either.
KV_SPILLS_BEFORE = {
    **{f"fa2_bwd_fused_kernel<{D},{seg},{dense}>": n for D in (64, 128)
       for (seg, dense), n in {(0, 0): 56, (0, 1): 40, (1, 0): 104, (1, 1): 96}.items()},
    **{f"fa2_bwd_fused_kernel<160,{seg},{dense}>": n
       for (seg, dense), n in {(0, 0): 48, (0, 1): 32, (1, 0): 80, (1, 1): 68}.items()},
    **{f"fa2_bwd_fused_kernel<256,{seg},{dense}>": n
       for (seg, dense), n in {(0, 0): 64, (0, 1): 28, (1, 0): 88, (1, 1): 60}.items()},
    **{f"fa2_bwd_dkv_kernel<{D},{seg},{dense}>": 4 if D in (64, 128) and seg and dense else 0
       for D in (64, 128, 160, 256) for seg in (0, 1) for dense in (0, 1)},
}


def wide_ptxas_check(ptxas: str) -> None:
    """The dense instantiations at head_dim 256 and 160 (forward, fused,
    dK/dV, dQ; without and with SEG) and the split-KV forward's (without and
    with SEG; the forward's in each tile mode) against their compact
    single-pass twins in the ptxas summary:
    no more spill bytes, and for the split forward 168 registers at entry as
    its twin; every fused and dK/dV instantiation at 168 registers at entry
    and no more spill stores than KV_SPILLS_BEFORE; and no instantiation of
    any kernel with its wgmma serialised."""
    import re

    rows = {}
    for line in ptxas.splitlines():
        m = re.match(r"\s*\S+ (fa2_\w+<[\d,]+>): (\d+) registers, spill stores (\d+) B, "
                     r"loads (\d+) B(.*)", line)
        if m:
            rows[m.group(1)] = (int(m.group(2)), int(m.group(3)), int(m.group(4)),
                                "serialized" in m.group(5))
    for D in (256, 160):
        for seg in (0, 1):
            pairs = [(fwd_inst(D, seg, 0, 1, one), fwd_inst(D, seg, 0, 0, one)) for one in (0, 1)]
            pairs += [(fwd_inst(D, seg, 1, 0, one), fwd_inst(D, seg, 0, 0, one))
                      for one in (0, 1)]
            pairs += [(f"fa2_bwd_{k}_kernel<{D},{seg},1>", f"fa2_bwd_{k}_kernel<{D},{seg},0>")
                      for k in ("fused", "dkv", "dq")]
            for inst, compact in pairs:
                if inst not in rows or compact not in rows:
                    fail(f"ptxas reported no {inst} or no {compact}")
                d, c = rows[inst], rows[compact]
                log(f"ptxas {inst}: {d[0]} registers, spill stores {d[1]} B, loads {d[2]} B, "
                    f"wgmma serialized {d[3]}; compact twin {c[0]} registers, {c[1]} B, {c[2]} B")
                if d[3] or d[1] > c[1] or d[2] > c[2] or d[0] != c[0]:
                    fail(f"{inst} spills more than {compact}, takes other registers at entry "
                         "or has serialised wgmma")
    for inst, before in KV_SPILLS_BEFORE.items():
        if inst not in rows:
            fail(f"ptxas reported no {inst}")
        regs, stores, loads, _ = rows[inst]
        log(f"ptxas {inst}: {regs} registers, spill stores {stores} B (before the redesign "
            f"{before} B), loads {loads} B")
        if regs != 168 or stores > before:
            fail(f"{inst} takes other registers at entry than 168 or spills more than before")
    serialised = [k for k, row in rows.items() if row[3]]
    if serialised:
        fail(f"ptxas serialised the wgmma of {serialised}")


def dense_by_dim(counts: dict, D: int) -> dict:
    """A dense-schedule run's launch counts with its head_dim-``D`` launches
    under the dense entries' names: each ``<name>_hd{D}`` count but delta's
    and the group sum's (the wrappers count both schedules there; those two
    have one form) moves to
    ``<name>_dense_hd{D}``, and the unsegmented forward's dense launches,
    which it does not count by head dim, go to ``flash_fwd_dense_hd{D}``."""
    out = dict(counts)
    for k in counts:
        if k.endswith(f"_hd{D}") and not k.startswith(("flash_bwd_delta", "flash_bwd_group_sum")):
            out[k.replace(f"_hd{D}", f"_dense_hd{D}")] = out[k]
            out[k] = 0
    out[f"flash_fwd_dense_hd{D}"] = counts["flash_fwd_dense"]
    return out


def gemma3_dense_train_phase(torch, dev):
    """gemma3-1b at its published widths and depth (26 layers) on the dense
    schedule at B 4, S 2048 (``model_dense_train_phase``)."""
    from repro_torch.configs import registry

    return model_dense_train_phase(torch, dev, registry.get("gemma3-1b"), G3_TRAIN_B, G3_TRAIN_S,
                                   G3_TRAIN_STEPS)


def stablelm_dense_train_phase(torch, dev):
    """stablelm-12b at its published widths, SL_TRAIN_LAYERS of 40 layers,
    on the dense schedule at B 2, S 2048 (``model_dense_train_phase``)."""
    from repro_torch.configs import registry

    cfg = dataclasses.replace(registry.get("stablelm-12b"), num_layers=SL_TRAIN_LAYERS)
    return model_dense_train_phase(torch, dev, cfg, SL_TRAIN_B, SL_TRAIN_S, SL_TRAIN_STEPS)


def model_dense_train_phase(torch, dev, cfg, B, S, steps):
    """``cfg`` (bf16, remat, seed 0) trained ``steps`` AdamW steps through
    launch/steps.build_train_step(cfg, AttentionConfig(impl="flash_cuda",
    bwd=..., schedule="dense"), ...) (``run_steps``), each run beside its compact
    counterpart through the same loop in this call, from the same seed and
    batches: on the synthetic stream with the split backward (every step's
    loss bitwise the compact run's) and with the fused one (step 0's loss
    equal, every later step within GPT_LOSS_REL: the dQ bulk reductions add
    in no fixed order), and on the packed source's batches with the split
    backward (every step bitwise). Every run's launches exact (per step the
    forward twice a layer of the remat groups and once a tail layer, delta
    once a layer, the fused kernel or dK/dV and dQ once a layer, all at
    cfg.head_dim; the dense runs through the dense kernels only, the compact
    ones through the compact kernels only; no plain version). The two
    unpacked split runs are each profiled one more step: busy share,
    attention's device ms and share. Returns ({run: launch counts} of the
    dense runs, {run: summary} of all six)."""
    from repro_torch.core.attention import AttentionConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, SyntheticVarlenLM
    from repro_torch.training.optimizer import AdamWConfig

    arch, D = cfg.name, cfg.head_dim
    opt_cfg = AdamWConfig(warmup_steps=2, total_steps=steps)
    grouped = cfg.num_groups * cfg.group_size
    forwards = steps * (2 * grouped + cfg.num_layers - grouped)
    flops = train_model_flops(cfg, B, S)
    synthetic = SyntheticLM(DataConfig(B, S, cfg.vocab_size, seed=0))
    packed_src = SyntheticVarlenLM(DataConfig(B, S, cfg.vocab_size, seed=0, source="packed"))

    def batches(packed):
        out = []
        for step in range(steps):
            if packed:
                b = packed_src.batch(step)
            else:
                inputs, targets = synthetic.batch(step)
                b = {"inputs": inputs, "targets": targets}
            out.append({k: torch.from_numpy(v).to(dev) for k, v in b.items()})
        return out

    counters, plains = kernel_counters()
    counts, summaries = {}, {}
    for bwd, packed in (("split", False), ("fused", False), ("split", True)):
        data = batches(packed)
        runs = {}
        for schedule in ("compact", "dense"):
            key = f"{'packed ' if packed else ''}{bwd} {schedule}"
            what = f"{arch} training ({key})"
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            model, opt_state, step_fn, losses, times, run_counts = run_steps(
                torch, dev, cfg, AttentionConfig(impl="flash_cuda", bwd=bwd, schedule=schedule),
                opt_cfg, data, counters, plains, what)
            med = sorted(times)[steps // 2]
            peak = torch.cuda.max_memory_allocated(dev) / 2**30
            runs[schedule] = dict(losses=losses, median_ms=med * 1e3, tokens_per_s=B * S / med,
                                  mfu=flops / med / PEAK_BF16_FLOPS, peak_gib=peak,
                                  busy_share=None, attention_ms=None)
            log(f"{what}, {cfg.num_layers} layers, B={B} S={S}: losses "
                f"{[round(x, 5) for x in losses]}; median step {med * 1e3:.1f} ms (first "
                f"{times[0] * 1e3:.1f} ms), {B * S / med:.1f} tokens/s, MFU "
                f"{runs[schedule]['mfu']:.4f}, max_memory_allocated {peak:.2f} GiB")
            log(f"launches on the {what} path: {run_counts}")
            suffix = ("_varlen" if packed else "") + ("_dense" if schedule == "dense" else "")
            want = training_want(counters, plains, steps * cfg.num_layers, (bwd,), suffix,
                                 head_dim=D, forwards=forwards,
                                 group_sums=group_sum_launches(cfg, B, S, steps))
            if run_counts != want:
                fail(f"{what} launches {run_counts}, want {want}")
            if schedule == "dense":
                counts[key] = run_counts
            if bwd == "split" and not packed:
                busy, attn_ms = profile_train_step(torch, step_fn, model, opt_state, data[0], med)
                share = None if attn_ms is None else attn_ms / (busy * med * 1e3)
                runs[schedule].update(busy_share=busy, attention_ms=attn_ms, attention_share=share)
                log(f"attention device time per {what} step: " + (
                    "not measured" if attn_ms is None else f"{attn_ms:.3f} ms of the profiled "
                    f"step, {share:.4f} of its device busy time"))
            del model, opt_state, step_fn
        c, d = runs["compact"]["losses"], runs["dense"]["losses"]
        label = f"{arch} {'packed ' if packed else ''}training, bwd={bwd}"
        log(summary_line(f"{label}, dense against compact schedule (this loop, this call)",
                         runs["dense"], runs["compact"]))
        if bwd == "split":
            same = [a == b for a, b in zip(d, c)]
            log(f"{label}: every step's dense loss bitwise the compact run's: {same}")
            if not all(same):
                fail(f"{label}: the dense schedule's losses are not the compact run's to the bit")
        else:
            rel = [abs(a - b) / abs(b) for a, b in zip(d, c)]
            log(f"{label}: dense against compact loss, relative by step "
                + ", ".join(f"{r:.3e}" for r in rel)
                + f" (step 0 exact, every step {GPT_LOSS_REL})")
            if d[0] != c[0] or max(rel) > GPT_LOSS_REL:
                fail(f"{label}: the dense schedule's losses are not the compact run's")
        for schedule, summary in runs.items():
            summaries[f"{'packed ' if packed else ''}{bwd} {schedule}"] = summary
        del data
    return counts, summaries


# The short-q/long-kv corner of the public attention API at gemma3-1b's and
# stablelm-12b's widths: CORNER_ROWS q rows (one q tile, at the last
# positions, causal) against the key counts of a long context, (Skv, window).
G3_CORNER = ((1536, None), (8192, None), (32768, None), (8192, G3_WINDOW))
SL_CORNER = ((1536, None), (4096, None), (32768, None))
CORNER_ROWS = 64
# The split prefill's and the packed split-forward training's kv splits,
# and that training's steps (each run beside a kv_splits=1 one).
SPLIT_KS, SPLIT_TRAIN_STEPS = 2, 3
# The split forward's o is also held relative to its reference's largest
# |o|: against thousands of keys |o| is far below 1 (about 0.04 at most at
# 32,768 keys of randn K/V), where FWD_TOL's absolute limit alone would pass
# a fold that dropped a split (``check_split``'s control).
SPLIT_O_REL = 2e-2


def nonzero(counts: dict) -> dict:
    """The entries of a launch-count dict that are not 0 (plain calls as a list)."""
    return {k: c for k, c in counts.items() if (any(c) if isinstance(c, list) else c)}


def corner_spec(Skv: int, window=None):
    """The causal mask of CORNER_ROWS q rows at the last positions of Skv
    keys, with ``window`` (None: none)."""
    from repro_torch.core.masks import MaskSpec

    return MaskSpec(causal=True, window=window, q_offset=Skv - CORNER_ROWS)


def spec_mask(torch, dev, Sq: int, Skv: int, spec):
    """The boolean (Sq, Skv) mask of ``spec`` (causal or not, window, sink,
    q_offset) on ``dev``: what SDPA is given as ``attn_mask``."""
    pos = torch.arange(Sq, device=dev)[:, None] + spec.q_offset
    col = torch.arange(Skv, device=dev)[None, :]
    vis = col <= pos if spec.causal else torch.ones((Sq, Skv), dtype=torch.bool, device=dev)
    if spec.window is not None:
        vis = vis & (((pos - col).abs() < spec.window) | (col < spec.sink))
    return vis


def split_bound(B, Sq, hq, hkv, D, pairs, kv_rows, id_bytes=0):
    """The split-KV forward's roofline bound (ms, what bounds): ``pairs``
    visible (q, k) pairs per q head summed over the batch, 4 D flops each;
    the function's own bytes: Q read, the ``kv_rows`` visible K and V rows
    (summed over the batch) read, o in bf16 and lse written, and
    ``id_bytes`` of segment ids. The f32 partials are the kernel's scratch,
    not the function's output (as in the head_dim-64 split bound):
    ``partial_bytes`` gives their traffic apart."""
    nbytes = 2 * B * Sq * hq * D * 2 + kv_rows * hkv * D * 2 * 2 + B * hq * Sq * 4 + id_bytes
    return bound(4 * D * pairs * hq, nbytes)


def partial_bytes(B, Sq, hq, D, ks) -> int:
    """The bytes of the split-KV forward's f32 partials (o and lse of ``ks``
    splits), written by the walk and read back by the fold."""
    return 2 * B * hq * ks * Sq * (D + 1) * 4


def o_errs(torch, a, b):
    """(max|a - b|, that over max|b|) over b's finite entries."""
    e = max_err(torch, a, b)
    fin = b[torch.isfinite(b)]
    top = fin.float().abs().max().item() if fin.numel() else 0.0
    return e, (e / top if top else e)


def drop_last_split(torch, out):
    """A planted fault of the fold, for controls: the o of ``out`` (a
    SplitForward) refolded from its own partials with the last split left
    out, each weight still taken against the true lse (so lse stays
    right and only o's weights are wrong)."""
    w = torch.exp(out.lse_parts[:, :, :-1] - out.lse[:, :, None]).nan_to_num(0.0)
    o = (out.o_parts[:, :, :-1] * w[..., None]).sum(dim=2)
    return o.permute(0, 2, 1, 3).to(out.o.dtype)


def check_split(torch, what, out, ref, single, control=False) -> float:
    """Fail unless the split-KV forward's fold and partials (``out``, a
    SplitForward) match its plain version's (``ref``), finite exactly where
    the plain version's are, and the fold matches the single pass
    (``single``: (o, lse)): o and the o partials within FWD_TOL and within
    SPLIT_O_REL of the reference's largest |o|, lse within FWD_TOL. With
    ``control``, the same limits must reject a planted fault: the fold
    without its last split (``drop_last_split``). Returns max |o - plain|
    over the fold and the partials."""
    (eo, ro), (epo, rpo), (so, rso) = (o_errs(torch, a, b) for a, b in (
        (out.o, ref.o), (out.o_parts, ref.o_parts), (out.o, single[0])))
    el, epl = max_err(torch, out.lse, ref.lse), max_err(torch, out.lse_parts, ref.lse_parts)
    sl = max_err(torch, out.lse, single[1])
    empty = int(torch.isneginf(out.lse_parts).all(dim=-1).sum())
    log(f"{what}: max|o-plain|={eo:.3e} ({ro:.3e} of max|plain o|), max|lse-plain|={el:.3e}, "
        f"partials max|o-plain|={epo:.3e} ({rpo:.3e}), max|lse-plain|={epl:.3e}; against the "
        f"single pass max|o|={so:.3e} ({rso:.3e}), max|lse|={sl:.3e} (tol o {FWD_TOL['o']} "
        f"and {SPLIT_O_REL} of the reference's max|o|, lse {FWD_TOL['lse']}); (batch, q head, "
        f"split) partials that saw no key: {empty} of {out.lse_parts[..., 0].numel()}")
    if not (max(eo, epo, so) <= FWD_TOL["o"] and max(ro, rpo, rso) <= SPLIT_O_REL
            and max(el, epl, sl) <= FWD_TOL["lse"]):
        fail(f"{what} disagrees with its plain version or with the single pass")
    if not torch.isfinite(out.o).all():
        fail(f"{what}: a non-finite output")
    if control:
        fe, fr = o_errs(torch, drop_last_split(torch, out), ref.o)
        log(f"{what}, control: the fold without its last split (lse kept) reads max|o-plain|="
            f"{fe:.3e}, {fr:.3e} of max|plain o|: FWD_TOL's absolute {FWD_TOL['o']} alone "
            f"would {'accept' if fe <= FWD_TOL['o'] else 'reject'} it, the check "
            f"{'accepts' if fe <= FWD_TOL['o'] and fr <= SPLIT_O_REL else 'rejects'} it")
        if fe <= FWD_TOL["o"] and fr <= SPLIT_O_REL:
            fail(f"{what}: the check does not see a fold that drops its last split")
    return max(eo, epo)


def split_kernel_phase(torch, dev, flush, D, hq, hkv, corner, window, B_seg, S_seg, vocab, *,
                       seed):
    """The split-KV forward and its fold at head_dim ``D`` (``hq`` q heads
    over ``hkv``), the ``SPLIT`` and ``SEG``+``SPLIT`` instantiations, held
    against their plain version (partials and fold) and the fold against the
    single-pass kernel: at the corner shapes (``corner``: CORNER_ROWS q rows
    against (Skv, window)) with the auto split count, at the causal prefill
    (B 1, S 1536) with 2 and 3 splits (and 3 under the ``window``), and with
    the packed source's step-0 ids (at ``vocab``) at the packed training
    shape (``B_seg``, ``S_seg``) with 2 and 3 splits, causal (and under the
    window). Then each corner shape and the prefill timed after the L2
    flush in turns with the single pass (split, single, single, split),
    beside SDPA (``causal_sdpa_ms`` where the mask is causal without a
    window, and with the boolean mask), the plain version and the bound
    (``split_bound``); the packed shape with 2 splits in turns with the
    SEG single pass, beside SDPA with the block-diagonal mask. Returns the
    records of ``flash_fwd_splitkv_hd{D}`` (the largest corner shape on
    top) and ``flash_fwd_splitkv_varlen_hd{D}``."""
    import torch.nn.functional as F

    from repro_torch.core.masks import MaskSpec
    from repro_torch.kernels import flash_fwd as fwd
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(seed)
    tiles = dict(block_q=ops.BLOCK_Q, block_kv=ops.BLOCK_KV)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def inputs(B, Sq, Skv):
        return (ops._prep(randn(B, Sq, hq, D), 1 / math.sqrt(D)), randn(B, Skv, hkv, D),
                randn(B, Skv, hkv, D))

    def name_of(spec):
        return "causal" + (f", window {spec.window}" if spec.window else "") + (
            f", q_offset {spec.q_offset}" if spec.q_offset else "")

    ids = torch.from_numpy(packed_ids(B_seg, S_seg, vocab=vocab)).to(dev)
    seg_specs = [MaskSpec(causal=True)] + ([MaskSpec(causal=True, window=window)] if window else [])
    corner_shapes = [(1, CORNER_ROWS, Skv, corner_spec(Skv, w)) for Skv, w in corner]
    prefill = [(1, 1536, 1536, MaskSpec(causal=True), ks) for ks in (2, 3)]
    if window:
        prefill.append((1, 1536, 1536, MaskSpec(causal=True, window=window), 3))
    cases = [(B, Sq, Skv, spec, ops.resolve_kv_splits(None, (B, Sq, hq, D), (B, Skv, hkv, D)),
              None) for B, Sq, Skv, spec in corner_shapes]
    cases += [(*c, None) for c in prefill]
    cases += [(B_seg, S_seg, S_seg, spec, ks, ids) for ks in (2, 3) for spec in seg_specs]
    err = {"": 0.0, "_varlen": 0.0}
    for B, Sq, Skv, spec, ks, seg_ids in cases:
        q, k, v = inputs(B, Sq, Skv)
        seg = () if seg_ids is None else (seg_ids, seg_ids)
        sfx = "" if seg_ids is None else "_varlen"
        split_fn = getattr(fwd, f"flash_fwd_splitkv{sfx}")
        out = split_fn(q, k, v, spec, *seg, kv_splits=ks, **tiles)
        one = getattr(fwd, f"flash_fwd{sfx}")(q, k, v, spec, *seg, **tiles)
        torch.cuda.synchronize()
        ref = fwd.flash_fwd_splitkv_plain(
            q, k, v, spec, kv_splits=ks, **tiles,
            **({} if seg_ids is None else dict(q_seg=seg_ids, kv_seg=seg_ids)))
        what = (f"flash_fwd_splitkv{sfx} D={D} B={B} Sq={Sq} Skv={Skv} Hq={hq} Hkv={hkv} "
                f"{name_of(spec)}, {ks} splits ({tile_mode(fwd, B, hq, Sq, D, ks)})")
        err[sfx] = max(err[sfx], check_split(torch, what, out, ref, one,
                                             control=Sq == CORNER_ROWS))

    def timed(B, Sq, Skv, spec, ks, seg_ids=None):
        """One shape's times: the split (``ks`` splits) in turns with the
        single pass, the plain version, SDPA, the bound. SDPA takes a
        causal mask without a window or ids as ``causal_lower_right`` (q at
        the last positions), which its fused backends compute, and beside it
        the boolean mask; a window or ids only the boolean mask."""
        q, k, v = inputs(B, Sq, Skv)
        seg = () if seg_ids is None else (seg_ids, seg_ids)
        sfx = "" if seg_ids is None else "_varlen"
        split_fn, single_fn = (getattr(fwd, f"flash_fwd{m}{sfx}") for m in ("_splitkv", ""))
        plain = {} if seg_ids is None else dict(q_seg=seg_ids, kv_seg=seg_ids)
        ms, one_ms, turns = in_turns(
            torch, lambda: split_fn(q, k, v, spec, *seg, kv_splits=ks, **tiles),
            lambda: single_fn(q, k, v, spec, *seg, **tiles), 20, flush)
        plain_ms = time_ms(torch, lambda: fwd.flash_fwd_splitkv_plain(
            q, k, v, spec, kv_splits=ks, **tiles, **plain), 2, flush)
        vis = spec_mask(torch, dev, Sq, Skv, spec)[None, None]
        if seg_ids is not None:
            vis = vis & (seg_ids[:, :, None] == seg_ids[:, None, :])[:, None]
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        bool_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=vis, enable_gqa=True, scale=1.0), 20, flush)
        lib_ms, form = bool_ms, "boolean mask"
        if spec.window is None and seg_ids is None:
            lib_ms, form = causal_sdpa_ms(torch, qt, kt, vt, flush)
        vis_b = vis.expand(B, 1, Sq, Skv)
        pairs = int(vis_b.sum())
        kv_rows = int(vis_b.any(dim=2).sum())
        b_ms, b_by = split_bound(B, Sq, hq, hkv, D, pairs, kv_rows,
                                 0 if seg_ids is None else 2 * B * Skv * 4)
        scratch = partial_bytes(B, Sq, hq, D, ks)
        walk_ms, fold_ms, fold_b = split_apart(
            torch, fwd, lambda: split_fn(q, k, v, spec, *seg, kv_splits=ks, **tiles), flush)
        log(f"flash_fwd_splitkv{sfx} D={D} B={B} Sq={Sq} Skv={Skv} {name_of(spec)}, {ks} splits "
            f"({tile_mode(fwd, B, hq, Sq, D, ks)}): kernel (walk + fold) {ms:.4f} ms, the "
            f"single pass in turns {one_ms:.4f} ms (split / single {ms / one_ms:.4f}; turns "
            f"{turns}), plain {plain_ms:.4f} ms, sdpa ({form}) {lib_ms:.4f} ms (split / sdpa "
            f"{ms / lib_ms:.4f}; with the boolean mask {bool_ms:.4f} ms), bound {b_ms:.4f} ms "
            f"({b_by}; {pairs} visible pairs a q head, {kv_rows} kv rows), {ms / b_ms:.2f}x the "
            f"bound; the f32 partials (scratch, written and read back) {scratch} bytes, "
            f"{scratch / PEAK_HBM_BYTES * 1e3:.4f} ms at the memory rate; apart: the walk "
            f"{walk_ms:.4f} ms, the fold {fold_ms:.4f} ms against its bound {fold_b:.4f} ms "
            f"(bytes), {fold_ms / fold_b:.2f}x")
        return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                    library_form=form, library_bool_mask_ms=bool_ms, partials_bytes=scratch,
                    single_pass_ms_in_turns=one_ms, splits=ks, shape=[B, Sq, Skv, hq, hkv, D],
                    mask=name_of(spec), mode=tile_mode(fwd, B, hq, Sq, D, ks), walk_ms=walk_ms,
                    fold_ms=fold_ms, fold_bound_ms=fold_b)

    at_corner = [timed(B, Sq, Skv, spec, ks) for B, Sq, Skv, spec, ks, _ in
                 cases[:len(corner_shapes)]]
    top = max(range(len(corner)), key=lambda i: (corner[i][1] is None, corner[i][0]))
    rec = dict(max_abs_err=err[""], **at_corner[top],
               at_corner=[r for i, r in enumerate(at_corner) if i != top],
               at_prefill=[timed(*c) for c in prefill])
    seg_rows = [timed(B_seg, S_seg, S_seg, spec, SPLIT_KS, ids) for spec in seg_specs]
    seg_rec = dict(max_abs_err=err["_varlen"], **seg_rows[0])
    if window:
        seg_rec["windowed"] = seg_rows[1]
    return {f"flash_fwd_splitkv_hd{D}": rec, f"flash_fwd_splitkv_varlen_hd{D}": seg_rec}


def split_apart(torch, fwd, call, flush):
    """The split-KV forward's walk alone and its fold alone, each timed after
    the L2 flush: ``call`` (one split-KV wrapper call) with the fold's launch
    left out (``flash_fwd._fold`` a no-op while it runs), then the fold
    kernel on that call's partials. Returns (walk ms, fold ms, the fold's
    bound in ms: the partials read once, o and lse written once, over the
    memory rate)."""
    out = call()
    o, lse = torch.empty_like(out.o), torch.empty_like(out.lse)
    fold = fwd._fold
    fwd._fold = lambda *args: None
    try:
        walk_ms = time_ms(torch, call, 20, flush)
    finally:
        fwd._fold = fold
    fold_ms = time_ms(torch, lambda: fold(out.o_parts, out.lse_parts, o, lse), 20, flush)
    nbytes = 4 * (out.o_parts.numel() + out.lse_parts.numel() + out.lse.numel()) \
        + out.o.element_size() * out.o.numel()
    return walk_ms, fold_ms, nbytes / PEAK_HBM_BYTES * 1e3


def causal_sdpa_ms(torch, qt, kt, vt, flush):
    """SDPA's time (ms, the form timed) on (B, H, S, D) inputs with GQA
    under the causal mask aligned to the last q positions,
    ``causal_lower_right``, which its fused backends compute."""
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right

    bias = causal_lower_right(qt.shape[2], kt.shape[2])
    return time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=bias, enable_gqa=True, scale=1.0), 20, flush), \
        "causal_lower_right, GQA"


def default_split_phase(torch, dev):
    """The short-q/long-kv corner of the public attention API at gemma3-1b's
    widths (4 q heads over 1 kv head of 256; G3_CORNER) and stablelm-12b's
    (32 over 8 of 160; SL_CORNER): with every count set to 0 just before,
    ``ops.flash_attention`` and ``core.attention.attention(...,
    AttentionConfig(impl="flash_cuda"))`` with the default kv splits on each
    shape; the counts read just after must be exact (the split-KV kernel
    twice a shape, at that head dim; the single pass, every other kernel
    and every plain version 0). Then each shape: the auto split count must
    be ``default_kv_splits`` (min(t_kv, 33) for gemma3, 4 for stablelm), the
    two calls' outputs bitwise equal and within FWD_TOL and SPLIT_O_REL of
    the plain split version and of the single pass (``kv_splits=1``). The kernel times of
    these shapes, in turns with the single pass and beside SDPA, are the
    split kernel phase's. Returns {path: launch counts}."""
    from repro_torch.core.attention import AttentionConfig, attention
    from repro_torch.kernels import flash_fwd as fwd
    from repro_torch.kernels import ops

    counters, plains = all_counters()
    tiles = dict(block_q=ops.BLOCK_Q, block_kv=ops.BLOCK_KV)
    gen = torch.Generator(device=dev).manual_seed(13)
    out = {}
    for arch, D, hq, hkv, corner in (("gemma3", G3_D, G3_HQ, G3_HKV, G3_CORNER),
                                     ("stablelm", SL_D, SL_HQ, SL_HKV, SL_CORNER)):
        shapes = []
        for Skv, w in corner:
            q = torch.randn((1, CORNER_ROWS, hq, D), generator=gen, device=dev).to(torch.bfloat16)
            k, v = (torch.randn((1, Skv, hkv, D), generator=gen, device=dev).to(torch.bfloat16)
                    for _ in range(2))
            shapes.append((q, k, v, corner_spec(Skv, w)))
        zero_counts(counters, plains.values())
        outs = [(ops.flash_attention(q, k, v, spec),
                 attention(q, k, v, spec, AttentionConfig(impl="flash_cuda")))
                for q, k, v, spec in shapes]
        torch.cuda.synchronize()
        counts = read_counts(counters, plains.values())
        want = {name: 0 for name in counters}
        want.update({"flash_fwd_splitkv": 2 * len(shapes),
                     f"flash_fwd_splitkv_hd{D}": 2 * len(shapes)})
        path = f"{arch}_split_corner"
        log(f"launches on the {path} path ({len(shapes)} shapes, two public calls each; those "
            f"not 0): {nonzero(counts)}")
        if {k: counts[k] for k in counters} != want or any(counts["plain"]):
            fail(f"the {path} path's launches are not exact: want {want}, plain 0")
        for (q, k, v, spec), (o, o_attn) in zip(shapes, outs):
            Skv = k.shape[1]
            ks = ops.resolve_kv_splits(None, q.shape, k.shape)
            policy = ops.default_kv_splits(hq, 1, -(-Skv // ops.BLOCK_KV))
            ref = fwd.flash_fwd_splitkv_plain(ops._prep(q, 1 / math.sqrt(D)), k, v, spec,
                                              kv_splits=ks, **tiles)
            one = ops.flash_attention(q, k, v, spec, kv_splits=1)
            (e_plain, r_plain), (e_one, r_one) = o_errs(torch, o, ref.o), o_errs(torch, o, one)
            same = torch.equal(o, o_attn)
            log(f"default ops.flash_attention at head_dim {D}, q (1, {CORNER_ROWS}, {hq}, {D}) "
                f"against k (1, {Skv}, {hkv}, {D}), window {spec.window}: auto kv splits {ks} "
                f"(default_kv_splits {policy}); max|o-plain|={e_plain:.3e} ({r_plain:.3e} of "
                f"max|plain o|), max|o-single pass|={e_one:.3e} ({r_one:.3e}) (tol "
                f"{FWD_TOL['o']} and {SPLIT_O_REL} of the reference's max|o|); attention() "
                f"bitwise the same: {same}")
            if (ks != policy or ks < 2 or not max(e_plain, e_one) <= FWD_TOL["o"]
                    or not max(r_plain, r_one) <= SPLIT_O_REL or not same):
                fail(f"the default split call at head_dim {D} against {Skv} keys did not take "
                     "the policy's splits or disagrees with its plain version or the single pass")
        out[path] = counts
    return out


@contextlib.contextmanager
def split_layers(torch, fault=False):
    """While the block runs, ``kernels.ops`` reaches the split-KV wrapper
    through a stand-in of the kernel module that also runs the single pass
    on each call's inputs and appends ``o_errs`` of the split's o against it
    to the list it yields (one entry a layer of a prefill). With ``fault``
    the stand-in returns ``drop_last_split``'s o in place of the fold's (a
    planted fault, for controls). Its kernels launch and count."""
    import types

    from repro_torch.kernels import flash_fwd as fwd
    from repro_torch.kernels import ops

    errs = []

    def split(q, k, v, spec, **kwargs):
        out = fwd.flash_fwd_splitkv(q, k, v, spec, **kwargs)
        if fault:
            out = out._replace(o=drop_last_split(torch, out))
        tiles = {t: kwargs[t] for t in ("block_q", "block_kv")}
        errs.append(o_errs(torch, out.o, fwd.flash_fwd(q, k, v, spec, **tiles)[0]))
        return out

    ops._fwd = types.SimpleNamespace(**{**vars(fwd), "flash_fwd_splitkv": split})
    try:
        yield errs
    finally:
        ops._fwd = fwd


def split_prefill_checks(torch, dev, cfg, model, prompts, l_ref, fixed_tokens, path):
    """A split prefill through the explicit knob: with every count set to 0
    just before, ``model.prefill`` of each of ``prompts`` with
    AttentionConfig(impl="flash_cuda", kv_splits=SPLIT_KS); the counts read
    just after must be exact (a prompt of at most one kv tile clamps to one
    split and runs the single pass: per layer the split-KV kernel once a
    longer prompt, the single pass once a shorter one). Each prompt's
    last-position logits against the same prefill with kv_splits=1 and the
    1500-token prompt's against impl="ref" (``l_ref``), both within
    ``compare_logits``' limits; that prompt's split o in every layer
    against the single pass on the same inputs within SPLIT_O_REL, a
    control with a planted fault (``split_layers``) rejected by that
    limit and its logits' reading logged; the prefills of all prompts
    timed in turns (split, single, single, split) on the host clock. Then
    the fixed engine over the same requests with kv_splits=SPLIT_KS
    (``run_engine``, launches exact), its tokens/s and the share of its
    greedy tokens equal to the kv_splits=1 run's (``fixed_tokens``: {rid:
    tokens}). Returns (prefill counts, engine counts, summary)."""
    from repro_torch.core.attention import AttentionConfig
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import Request, ServingEngine

    n, D = cfg.num_layers, cfg.head_dim
    split_cfg = AttentionConfig(impl="flash_cuda", kv_splits=SPLIT_KS)
    one_cfg = AttentionConfig(impl="flash_cuda", kv_splits=1)
    tokens = [torch.tensor([p], device=dev) for p in prompts]
    n_split = sum(len(p) > ops.BLOCK_KV for p in prompts)  # prompts of two kv tiles or more

    def prefill_all(attn):
        return [model.logits_from_hidden(model.prefill(t, attn, CACHE)[0]) for t in tokens]

    counters, plains = all_counters()
    zero_counts(counters, plains.values())
    l_split = prefill_all(split_cfg)
    torch.cuda.synchronize()
    counts = read_counts(counters, plains.values())
    want = {name: 0 for name in counters}
    want.update({"flash_fwd": (len(prompts) - n_split) * n, "flash_fwd_splitkv": n_split * n,
                 f"flash_fwd_splitkv_hd{D}": n_split * n})
    log(f"launches on the {path}_split_prefill path (prompt lengths {list(PROMPT_LENS)}, "
        f"kv_splits={SPLIT_KS}; {len(prompts) - n_split} prompts of one kv tile take the single "
        f"pass; those not 0): {nonzero(counts)}")
    if {k: counts[k] for k in counters} != want or any(counts["plain"]):
        fail(f"{path} split prefill launches are not exact: want {want}, plain 0")
    # The split and the single pass differ only where the fold's bf16
    # rounding of o differs from the single pass's (one ulp in a share of
    # the elements), but 40 layers of random weights amplify that as they
    # amplify the kernels' gap to impl="ref": the first card run read
    # stablelm-12b's 100-token prompt at cosine 0.999770 and max|diff|
    # 0.021 x max|logit| (gemma3-1b: 0.999993), so the limits are the
    # reference comparison's.
    l_one = prefill_all(one_cfg)
    gaps = []
    for p, a, b in zip(prompts, l_one, l_split):
        diff, top, cos, same = compare_logits(torch, f"{path} prefill of {len(p)} tokens", a, b,
                                              names=("kv_splits=1", f"kv_splits={SPLIT_KS}"))
        gaps.append(dict(prompt=len(p), max_diff=diff, max_logit=top, min_cos=cos,
                         same_argmax=same))
    compare_logits(torch, f"{path} split prefill (kv_splits={SPLIT_KS}) of {len(prompts[3])} "
                   "tokens", l_ref, l_split[3])
    # The last-position logits of random weights barely see attention: a
    # fold that drops its last split passes their limits at gemma3-1b (the
    # control below reads them). Each layer's split o is therefore also held
    # against the single pass on the same inputs within SPLIT_O_REL of its
    # max|o|, and the same limit must reject the planted fault.
    long = tokens[3]
    with split_layers(torch) as errs:
        model.prefill(long, split_cfg, CACHE)
    with split_layers(torch, fault=True) as bad:
        l_bad = model.logits_from_hidden(model.prefill(long, split_cfg, CACHE)[0])
    worst, worst_bad = max(r for _, r in errs), max(r for _, r in bad)
    diff, top, cos, _ = logit_gap(torch, l_one[3], l_bad)
    log(f"{path} split prefill of {long.shape[1]} tokens, each of {len(errs)} layers' split o "
        f"against the single pass on its inputs: at most {worst:.3e} of max|o| (limit "
        f"{SPLIT_O_REL}); control (the fold without its last split, lse kept): at most "
        f"{worst_bad:.3e} ({'rejected' if worst_bad > SPLIT_O_REL else 'accepted'}); its "
        f"last-position logits vs kv_splits=1: max|diff|={diff:.4f} (limit "
        f"{LOGIT_REL * top:.4f}), min cosine {cos:.6f} (limit {LOGIT_COS}): "
        f"{'accepted' if cos >= LOGIT_COS and diff <= LOGIT_REL * top else 'rejected'} there")
    if len(errs) != n or worst > SPLIT_O_REL:
        fail(f"{path}: a layer's split o disagrees with the single pass on its inputs")
    if worst_bad <= SPLIT_O_REL:
        fail(f"{path}: the per-layer check does not see a fold that drops a split")
    gaps.append(dict(layers_max_rel=worst, control=dict(
        layers_max_rel=worst_bad, prompt=long.shape[1], max_diff=diff, max_logit=top,
        min_cos=cos)))
    del l_one, l_split, l_bad

    def prefill_s(attn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill_all(attn)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    prefill_s(split_cfg)
    turns = [prefill_s(a) for a in (split_cfg, one_cfg, one_cfg, split_cfg)]
    split_ms, one_ms = (turns[0] + turns[3]) / 2 * 1e3, (turns[1] + turns[2]) / 2 * 1e3
    log(f"{path} prefill of the {len(prompts)} prompts (host clock): kv_splits={SPLIT_KS} "
        f"{split_ms:.2f} ms, kv_splits=1 {one_ms:.2f} ms in turns (split, single, single, split) "
        f"{[round(t * 1e3, 2) for t in turns]}: ratio {split_ms / one_ms:.4f}")

    engine = ServingEngine(cfg, model, split_cfg, max_batch=4, cache_size=CACHE)
    for rid, prompt in enumerate(prompts):
        engine.submit(Request(rid=rid, prompt=prompt, max_new_tokens=MAX_NEW))
    engine_counts, engine_summary = run_engine(torch, dev, cfg, engine, len(prompts),
                                               f"{path}_split_serving")
    # The engine pads each prompt to a multiple of 64: the same prompts as
    # above take one kv tile.
    if (engine_counts["flash_fwd"] != (len(prompts) - n_split) * n
            or engine_counts["flash_fwd_splitkv"] != n_split * n
            or engine_counts[f"flash_fwd_splitkv_hd{D}"] != n_split * n
            or engine_counts["flash_decode"] != engine.ticks * n
            or engine_counts["flash_decode_paged"]):
        fail(f"{path} split serving: want flash_fwd {(len(prompts) - n_split) * n}, "
             f"flash_fwd_splitkv {n_split * n}, flash_decode {engine.ticks * n}")
    same = sum(a == b for rid, req in engine.finished.items()
               for a, b in zip(req.generated, fixed_tokens[rid]))
    total = sum(len(t) for t in fixed_tokens.values())
    log(f"{path}_split_serving: greedy tokens equal to the kv_splits=1 run's: {same} of {total} "
        f"({same / total:.4f}); tokens/s {engine_summary['tokens_per_s']:.1f}")
    summary = dict(prefill_split_ms=split_ms, prefill_single_ms=one_ms, logit_gaps=gaps,
                   serving=engine_summary, same_token_share=same / total)
    return counts, engine_counts, summary


def gemma3_split_train_phase(torch, dev):
    """gemma3-1b (26 layers) on packed batches with a split forward
    (``model_split_train_phase``, B 4, S 2048)."""
    from repro_torch.configs import registry

    return model_split_train_phase(torch, dev, registry.get("gemma3-1b"), G3_TRAIN_B,
                                   G3_TRAIN_S, SPLIT_TRAIN_STEPS)


def stablelm_split_train_phase(torch, dev):
    """stablelm-12b, SL_TRAIN_LAYERS of 40 layers, on packed batches with a
    split forward (``model_split_train_phase``, B 2, S 2048)."""
    from repro_torch.configs import registry

    cfg = dataclasses.replace(registry.get("stablelm-12b"), num_layers=SL_TRAIN_LAYERS)
    return model_split_train_phase(torch, dev, cfg, SL_TRAIN_B, SL_TRAIN_S, SPLIT_TRAIN_STEPS)


def model_split_train_phase(torch, dev, cfg, B, S, steps):
    """``cfg`` (bf16, remat, seed 0) trained ``steps`` AdamW steps on the
    packed source's batches through launch/steps.build_train_step(cfg,
    AttentionConfig(impl="flash_cuda", bwd="split", kv_splits=...), ...)
    (``run_steps``), three runs in one loop from the same seed and batches:
    kv_splits=SPLIT_KS, kv_splits=1, and kv_splits=SPLIT_KS again. Launches
    exact in each (the SEG split-KV forward, or the SEG single pass, twice
    a layer of the remat groups and once a tail layer; delta, the SEG dK/dV
    and dQ once a layer; all at cfg.head_dim; no plain version); the split
    runs' losses bitwise equal to each other (the fold and the split
    backward are deterministic), and against kv_splits=1 step 0 within
    PARITY_LOSS_REL and every step within GPT_LOSS_REL. Returns (launch
    counts of the first split run, {run: summary})."""
    from repro_torch.core.attention import AttentionConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticVarlenLM
    from repro_torch.training.optimizer import AdamWConfig

    arch, D = cfg.name, cfg.head_dim
    opt_cfg = AdamWConfig(warmup_steps=2, total_steps=steps)
    grouped = cfg.num_groups * cfg.group_size
    forwards = steps * (2 * grouped + cfg.num_layers - grouped)
    src = SyntheticVarlenLM(DataConfig(B, S, cfg.vocab_size, seed=0, source="packed"))
    data = [{k: torch.from_numpy(v).to(dev) for k, v in src.batch(step).items()}
            for step in range(steps)]
    counters, plains = kernel_counters()
    runs, counts = {}, None
    for key, ks in (("split", SPLIT_KS), ("single", 1), ("split again", SPLIT_KS)):
        what = f"{arch} packed training, split backward, kv_splits={ks} ({key})"
        gc.collect()
        torch.cuda.empty_cache()
        model, opt_state, step_fn, losses, times, run_counts = run_steps(
            torch, dev, cfg, AttentionConfig(impl="flash_cuda", bwd="split", kv_splits=ks),
            opt_cfg, data, counters, plains, what)
        del model, opt_state, step_fn
        med = sorted(times)[steps // 2]
        runs[key] = dict(losses=losses, median_ms=med * 1e3, first_ms=times[0] * 1e3,
                         tokens_per_s=B * S / med)
        log(f"{what}, {cfg.num_layers} layers, B={B} S={S}: losses "
            f"{[round(x, 5) for x in losses]}; median step {med * 1e3:.1f} ms (first "
            f"{times[0] * 1e3:.1f} ms), {B * S / med:.1f} tokens/s")
        log(f"launches on the {what} path (those not 0): {nonzero(run_counts)}")
        want = training_want(counters, plains, steps * cfg.num_layers, ("split",), "_varlen",
                             head_dim=D, forwards=forwards,
                             forward="flash_fwd_splitkv" if ks > 1 else "flash_fwd",
                             group_sums=group_sum_launches(cfg, B, S, steps))
        if run_counts != want:
            fail(f"{what} launches {run_counts}, want {want}")
        if key == "split":
            counts = run_counts
    split, single = runs["split"]["losses"], runs["single"]["losses"]
    bitwise = [a == b for a, b in zip(split, runs["split again"]["losses"])]
    rel = [abs(a - b) / abs(b) for a, b in zip(split, single)]
    # The split runs bracket the single one (split, single, split).
    split_ms = (runs["split"]["median_ms"] + runs["split again"]["median_ms"]) / 2
    log(f"{arch} packed training with a split forward: losses bitwise over two runs {bitwise}; "
        f"against kv_splits=1, relative by step " + ", ".join(f"{r:.3e}" for r in rel)
        + f" (step 0 {PARITY_LOSS_REL}, every step {GPT_LOSS_REL}); median step "
        f"{split_ms:.1f} ms (the two split runs' mean) against {runs['single']['median_ms']:.1f} "
        f"ms, ratio {split_ms / runs['single']['median_ms']:.4f}")
    if not all(bitwise):
        fail(f"{arch}: the split-forward training is not bitwise the same over two runs")
    if rel[0] > PARITY_LOSS_REL or max(rel) > GPT_LOSS_REL:
        fail(f"{arch}: the split-forward training's losses are not kv_splits=1's")
    return counts, runs


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py runs on an NVIDIA GPU")
    try:
        from repro_torch.kernels import _build
    except ImportError as e:
        fail(f"the port is not next to this script ({e})")
    dev = torch.device("cuda", 0)
    smi = smi_line()
    name = torch.cuda.get_device_name(0)
    log(f"nvidia-smi: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {name}")

    t0 = time.perf_counter()
    sources = ("flash_fwd", "flash_decode", "flash_bwd")
    secs = _build.build(list(sources))
    log(f"built {sorted(secs)} in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in secs.items())})")
    for src in sources:
        log(f"ptxas report of csrc/{src}.cu:\n{_build.report_path(src).read_text()}")
    ptxas = ptxas_summary(_build, sources)
    log("ptxas, registers and spills by kernel instantiation (registers at entry; the "
        "forward's, the KV-stationary backward's and the dq kernel's warpgroups then run at 24 "
        "(producer) and 240 (consumers) by setmaxnreg):\n" + ptxas)
    wide_ptxas_check(ptxas)
    fwd_ptxas_check(ptxas)

    scratch = torch.empty(96 * 2**20, dtype=torch.uint8, device=dev)  # > 50 MB L2
    results = kernel_phase(torch, dev, scratch.zero_)
    results.update(paged_kernel_phase(torch, dev, scratch.zero_))
    results.update(bwd_kernel_phase(torch, dev, scratch.zero_))
    results.update(varlen_kernel_phase(torch, dev, scratch.zero_))
    results.update(dense_kernel_phase(torch, dev, scratch.zero_, HD, HQ, HKV, TRAIN_B, TRAIN_S,
                                      {"causal": dict(causal=True)}, seed=17))
    results.update(whisper_kernel_phase(torch, dev, scratch.zero_))
    results.update(bwd_hd64_kernel_phase(torch, dev, scratch.zero_))
    results.update(hd256_kernel_phase(torch, dev, scratch.zero_))
    results.update(hd160_kernel_phase(torch, dev, scratch.zero_))
    repeat_launches(torch, dev)
    granite = hd64_granite_kernel_phase(torch, dev, scratch.zero_)
    results["flash_decode_paged_hd64"] = granite.pop("flash_decode_paged_hd64")
    for k, row in granite.items():  # the forward and decode at 64, at granite's shapes
        results[k]["at_granite_shape"] = row
    results.update(hd256_bwd_kernel_phase(torch, dev, scratch.zero_))
    results.update(hd160_bwd_kernel_phase(torch, dev, scratch.zero_))
    results.update(dense_kernel_phase(  # gemma3-1b's and stablelm-12b's training shapes
        torch, dev, scratch.zero_, G3_D, G3_HQ, G3_HKV, G3_TRAIN_B, G3_TRAIN_S,
        {"causal": dict(causal=True), "window": dict(causal=True, window=G3_WINDOW)}, G3_VOCAB,
        seed=31))
    results.update(dense_kernel_phase(torch, dev, scratch.zero_, SL_D, SL_HQ, SL_HKV, SL_TRAIN_B,
                                      SL_TRAIN_S, {"causal": dict(causal=True)}, SL_VOCAB, seed=32))
    corner_counts = default_split_phase(torch, dev)
    del scratch
    whisper_counts, whisper_summary = whisper_phase(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    serve_counts, cfg, model = slice_phase(torch, dev)
    with torch.no_grad():
        paged_counts = paged_slice_phase(torch, dev, cfg, model)
        tick_phase(torch, cfg, model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    with torch.no_grad():
        g3_counts, g3_paged_counts, g3_summary = gemma3_phase(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    with torch.no_grad():
        sl_counts, sl_paged_counts, sl_summary = stablelm_phase(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    with torch.no_grad():
        gr_counts, gr_paged_counts, gr_summary = granite_phase(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    train_parity_phase(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    train_counts, fused_summary = train_phase(torch, dev, "fused")
    gc.collect()
    torch.cuda.empty_cache()
    split_counts, split_summary = split_train_phase(torch, dev, fused_summary)
    gc.collect()
    torch.cuda.empty_cache()
    packed_parity_counts = train_parity_phase(torch, dev, packed=True)
    gc.collect()
    torch.cuda.empty_cache()
    packed_counts = packed_train_phase(torch, dev, fused_summary)
    gc.collect()
    torch.cuda.empty_cache()
    dense_parity_counts = train_parity_phase(torch, dev, schedule="dense")
    gc.collect()
    torch.cuda.empty_cache()
    packed_dense_parity_counts = train_parity_phase(torch, dev, packed=True, schedule="dense")
    gc.collect()
    torch.cuda.empty_cache()
    dense_counts = dense_train_phase(torch, dev, split_summary)
    gc.collect()
    torch.cuda.empty_cache()
    gpt_counts, gpt_summaries = gpt_train_phase(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    wh_train_counts, wh_train_summary = whisper_train_phase(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    g3_train_counts, g3_train_summaries = gemma3_train_phase(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    sl_train_counts, sl_train_summaries = stablelm_train_phase(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    g3_packed_counts, g3_packed_summaries = gemma3_train_phase(torch, dev, packed=True)
    log(summary_line("gemma3-1b packed against unpacked training (fused, this call)",
                     g3_packed_summaries["fused"], g3_train_summaries["fused"]))
    gc.collect()
    torch.cuda.empty_cache()
    sl_packed_counts, sl_packed_summaries = stablelm_train_phase(torch, dev, packed=True)
    log(summary_line("stablelm-12b packed against unpacked training (fused, this call)",
                     sl_packed_summaries["fused"], sl_train_summaries["fused"]))
    gc.collect()
    torch.cuda.empty_cache()
    g3_dense_counts, g3_dense_summaries = gemma3_dense_train_phase(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    sl_dense_counts, sl_dense_summaries = stablelm_dense_train_phase(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    g3_split_train_counts, g3_split_train_summaries = gemma3_split_train_phase(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    sl_split_train_counts, sl_split_train_summaries = stablelm_split_train_phase(torch, dev)
    split_paths = {}
    for arch, summary in (("gemma3", g3_summary), ("stablelm", sl_summary)):
        split_paths[f"{arch}_split_prefill"] = summary.pop("split_prefill_counts")
        split_paths[f"{arch}_split_serving"] = summary.pop("split_serving_counts")

    results["flash_fwd"]["at_training_shape"] = results.pop("flash_fwd_at_training_shape")
    ptxas_of = {"flash_decode_hd256": "fa2_decode_kernel<256,0>",
                "flash_decode_paged_hd256": "fa2_decode_paged_kernel<256>",
                "flash_decode_hd160": "fa2_decode_kernel<160,0>",
                "flash_decode_paged_hd160": "fa2_decode_paged_kernel<160>",
                "flash_decode_paged_hd64": "fa2_decode_paged_kernel<64>",
                "flash_bwd_delta_hd256": "fa2_bwd_delta_kernel<256>",
                "flash_bwd_delta_hd160": "fa2_bwd_delta_kernel<160>",
                "flash_bwd_group_sum_hd256": "fa2_bwd_group_sum_kernel",
                "flash_bwd_group_sum_hd160": "fa2_bwd_group_sum_kernel"}
    for D in (256, 160):  # compact (DENSE 0) and dense (1), unsegmented (SEG 0) and SEG (1)
        for seg, suffix in ((0, ""), (1, "_varlen")):
            for dense, sched in ((0, ""), (1, "_dense")):
                ptxas_of[f"flash_fwd{suffix}{sched}_hd{D}"] = tuple(
                    fwd_inst(D, seg, 0, dense, one) for one in (0, 1))
                for kernel in ("fused", "dkv", "dq"):
                    ptxas_of[f"flash_bwd_{kernel}{suffix}{sched}_hd{D}"] = (
                        f"fa2_bwd_{kernel}_kernel<{D},{seg},{dense}>")
            # The split walk (SPLIT 1) and its fold.
            ptxas_of[f"flash_fwd_splitkv{suffix}_hd{D}"] = (
                *(fwd_inst(D, seg, 1, 0, one) for one in (0, 1)),
                f"fa2_fwd_fold_kernel<{D}>")
    for k, inst in ptxas_of.items():
        insts = inst if isinstance(inst, tuple) else (inst,)
        results[k]["ptxas"] = [line.split(": ", 1)[1] for line in ptxas.splitlines()
                               if any(i in line for i in insts)]
    replaces = {"flash_fwd": "src/repro/kernels/flash_fwd.py:354",
                "flash_decode": "src/repro/kernels/flash_decode.py:77",
                "flash_decode_paged": "src/repro/kernels/flash_decode.py:250",
                "flash_bwd_delta": "src/repro/kernels/flash_bwd.py:80",
                "flash_bwd_fused": "src/repro/kernels/flash_bwd.py:718",
                "flash_bwd_dkv": "src/repro/kernels/flash_bwd.py:234",
                "flash_bwd_dq": "src/repro/kernels/flash_bwd.py:459",
                # The segment branches of the same Pallas kernels.
                "flash_fwd_varlen": "src/repro/kernels/flash_fwd.py:354",
                "flash_bwd_fused_varlen": "src/repro/kernels/flash_bwd.py:718",
                "flash_bwd_dkv_varlen": "src/repro/kernels/flash_bwd.py:234",
                "flash_bwd_dq_varlen": "src/repro/kernels/flash_bwd.py:459",
                # This slice: the split-KV mode and its segment branch, the
                # head_dim-64 instantiations, the decode kernel's segments.
                "flash_fwd_splitkv": "src/repro/kernels/flash_fwd.py:510",
                "flash_fwd_splitkv_varlen": "src/repro/kernels/flash_fwd.py:510",
                "flash_fwd_hd64": "src/repro/kernels/flash_fwd.py:354",
                "flash_decode_hd64": "src/repro/kernels/flash_decode.py:77",
                "flash_decode_varlen": "src/repro/kernels/flash_decode.py:77",
                # The dense bodies (and their segment branches).
                "flash_fwd_dense": "src/repro/kernels/flash_fwd.py:206",
                "flash_fwd_varlen_dense": "src/repro/kernels/flash_fwd.py:206",
                "flash_bwd_fused_dense": "src/repro/kernels/flash_bwd.py:633",
                "flash_bwd_dkv_dense": "src/repro/kernels/flash_bwd.py:157",
                "flash_bwd_dq_dense": "src/repro/kernels/flash_bwd.py:390",
                "flash_bwd_fused_varlen_dense": "src/repro/kernels/flash_bwd.py:633",
                "flash_bwd_dkv_varlen_dense": "src/repro/kernels/flash_bwd.py:157",
                "flash_bwd_dq_varlen_dense": "src/repro/kernels/flash_bwd.py:390",
                # The backward at head_dim 64 (whisper-base, the gpt presets).
                "flash_bwd_delta_hd64": "src/repro/kernels/flash_bwd.py:80",
                "flash_bwd_fused_hd64": "src/repro/kernels/flash_bwd.py:718",
                "flash_bwd_dkv_hd64": "src/repro/kernels/flash_bwd.py:234",
                "flash_bwd_dq_hd64": "src/repro/kernels/flash_bwd.py:459",
                # Head dim 256 (gemma3-1b serving).
                "flash_fwd_hd256": "src/repro/kernels/flash_fwd.py:354",
                "flash_decode_hd256": "src/repro/kernels/flash_decode.py:77",
                "flash_decode_paged_hd256": "src/repro/kernels/flash_decode.py:250",
                # The backward at head_dim 256 (gemma3-1b training).
                "flash_bwd_delta_hd256": "src/repro/kernels/flash_bwd.py:80",
                "flash_bwd_fused_hd256": "src/repro/kernels/flash_bwd.py:718",
                "flash_bwd_dkv_hd256": "src/repro/kernels/flash_bwd.py:234",
                "flash_bwd_dq_hd256": "src/repro/kernels/flash_bwd.py:459",
                # Head dim 160 (stablelm-12b serving).
                "flash_fwd_hd160": "src/repro/kernels/flash_fwd.py:354",
                "flash_decode_hd160": "src/repro/kernels/flash_decode.py:77",
                "flash_decode_paged_hd160": "src/repro/kernels/flash_decode.py:250",
                # The backward at head_dim 160 (stablelm-12b training).
                "flash_bwd_delta_hd160": "src/repro/kernels/flash_bwd.py:80",
                "flash_bwd_fused_hd160": "src/repro/kernels/flash_bwd.py:718",
                "flash_bwd_dkv_hd160": "src/repro/kernels/flash_bwd.py:234",
                "flash_bwd_dq_hd160": "src/repro/kernels/flash_bwd.py:459",
                # The second pass of the fused and dK/dV kernels at 256 and
                # 160 where their grid splits a group's q heads over CTAs:
                # it replaces no TPU kernel of its own (the TPU's sequential
                # grid sums the group in the fused kernel's VMEM block).
                "flash_bwd_group_sum_hd256": "src/repro/kernels/flash_bwd.py:718",
                "flash_bwd_group_sum_hd160": "src/repro/kernels/flash_bwd.py:718",
                # The segment branches at head_dim 256 and 160 (packed training of
                # gemma3-1b and stablelm-12b).
                "flash_fwd_varlen_hd256": "src/repro/kernels/flash_fwd.py:354",
                "flash_bwd_fused_varlen_hd256": "src/repro/kernels/flash_bwd.py:718",
                "flash_bwd_dkv_varlen_hd256": "src/repro/kernels/flash_bwd.py:234",
                "flash_bwd_dq_varlen_hd256": "src/repro/kernels/flash_bwd.py:459",
                "flash_fwd_varlen_hd160": "src/repro/kernels/flash_fwd.py:354",
                "flash_bwd_fused_varlen_hd160": "src/repro/kernels/flash_bwd.py:718",
                "flash_bwd_dkv_varlen_hd160": "src/repro/kernels/flash_bwd.py:234",
                "flash_bwd_dq_varlen_hd160": "src/repro/kernels/flash_bwd.py:459",
                # The paged decode at head_dim 64 (granite-moe-1b-a400m serving).
                "flash_decode_paged_hd64": "src/repro/kernels/flash_decode.py:250",
                # The dense bodies (and their segment branches) at head_dim 256
                # and 160 (dense-schedule training of gemma3-1b and stablelm-12b).
                **{f"{n}{sfx}_dense_hd{D}": f"src/repro/kernels/{path}"
                   for D in (256, 160) for sfx in ("", "_varlen")
                   for n, path in (("flash_fwd", "flash_fwd.py:206"),
                                   ("flash_bwd_fused", "flash_bwd.py:633"),
                                   ("flash_bwd_dkv", "flash_bwd.py:157"),
                                   ("flash_bwd_dq", "flash_bwd.py:390"))},
                # The split-KV forward and its segment branch at head_dim 256
                # and 160 (the short-q/long-kv corner, a split prefill of
                # gemma3-1b and stablelm-12b, packed training with a split
                # forward).
                **{f"flash_fwd_splitkv{sfx}_hd{D}": "src/repro/kernels/flash_fwd.py:510"
                   for D in (256, 160) for sfx in ("", "_varlen")}}
    source = {"flash_fwd": "flash_fwd", "flash_decode": "flash_decode",
              "flash_decode_paged": "flash_decode", "flash_bwd_delta": "flash_bwd",
              "flash_bwd_fused": "flash_bwd", "flash_bwd_dkv": "flash_bwd",
              "flash_bwd_dq": "flash_bwd", "flash_fwd_varlen": "flash_fwd",
              "flash_bwd_fused_varlen": "flash_bwd", "flash_bwd_dkv_varlen": "flash_bwd",
              "flash_bwd_dq_varlen": "flash_bwd", "flash_fwd_splitkv": "flash_fwd",
              "flash_fwd_splitkv_varlen": "flash_fwd", "flash_fwd_hd64": "flash_fwd",
              "flash_decode_hd64": "flash_decode", "flash_decode_varlen": "flash_decode",
              "flash_decode_hd256": "flash_decode", "flash_decode_paged_hd256": "flash_decode",
              "flash_decode_hd160": "flash_decode", "flash_decode_paged_hd160": "flash_decode",
              "flash_decode_paged_hd64": "flash_decode"}
    source.update({k: "flash_fwd" if k.startswith("flash_fwd") else "flash_bwd"
                   for k in replaces if k not in source})
    paths = {"serving": serve_counts, "paged_serving": paged_counts, "training": train_counts,
             "training_split": split_counts, "training_packed": packed_counts,
             "training_packed_parity": packed_parity_counts, "training_dense": dense_counts,
             "training_dense_parity": dense_parity_counts,
             "training_packed_dense_parity": packed_dense_parity_counts,
             "whisper_serving": whisper_counts, "training_gpt20m": gpt_counts["fused"],
             "training_gpt20m_split": gpt_counts["split"], "training_whisper": wh_train_counts,
             "gemma3_serving": g3_counts, "gemma3_paged_serving": g3_paged_counts,
             "training_gemma3": g3_train_counts["fused"],
             "training_gemma3_split": g3_train_counts["split"],
             "stablelm_serving": sl_counts, "stablelm_paged_serving": sl_paged_counts,
             "training_stablelm": sl_train_counts["fused"],
             "training_stablelm_split": sl_train_counts["split"],
             "training_gemma3_packed": g3_packed_counts["fused"],
             "training_gemma3_packed_split": g3_packed_counts["split"],
             "training_stablelm_packed": sl_packed_counts["fused"],
             "training_stablelm_packed_split": sl_packed_counts["split"],
             "granite_serving": gr_counts, "granite_paged_serving": gr_paged_counts,
             **{f"training_{arch}_{key.replace(' dense', '').replace(' ', '_')}_dense":
                dense_by_dim(c, D) for arch, D, runs in (("gemma3", 256, g3_dense_counts),
                                                         ("stablelm", 160, sl_dense_counts))
                for key, c in runs.items()},
             **corner_counts, **split_paths,
             "training_gemma3_packed_split_forward": g3_split_train_counts,
             "training_stablelm_packed_split_forward": sl_split_train_counts}
    # An entry named "_hd64" ("_hd160", "_hd256") counts its kernel's
    # launches at head dim 64 (160, 256), and the entry of the same kernel
    # without the suffix the other launches. The backward wrappers and the
    # segment forward count their head_dim-64 (backward only), 160 and 256
    # launches apart (``<name>_hd64``, ``<name>_hd160``, ``<name>_hd256``);
    # the unsegmented forward and the decode wrappers do not, so their
    # launches on the paths that run at one head dim only (64: whisper-base,
    # gpt-20m, granite-moe-1b-a400m; 160: stablelm-12b; 256: gemma3-1b) are
    # that head dim's entries'.
    hd64_paths = ("whisper_serving", "training_gpt20m", "training_gpt20m_split",
                  "training_whisper", "granite_serving", "granite_paged_serving")
    hd256_paths = ("gemma3_serving", "gemma3_paged_serving", "training_gemma3",
                   "training_gemma3_split", "gemma3_split_corner", "gemma3_split_prefill",
                   "gemma3_split_serving")
    hd160_paths = ("stablelm_serving", "stablelm_paged_serving", "training_stablelm",
                   "training_stablelm_split", "stablelm_split_corner", "stablelm_split_prefill",
                   "stablelm_split_serving")
    by_dim = {"flash_fwd_hd64": ("flash_fwd", hd64_paths),
              "flash_decode_hd64": ("flash_decode", hd64_paths),
              "flash_decode_paged_hd64": ("flash_decode_paged", hd64_paths),
              "flash_fwd_hd256": ("flash_fwd", hd256_paths),
              "flash_decode_hd256": ("flash_decode", hd256_paths),
              "flash_decode_paged_hd256": ("flash_decode_paged", hd256_paths),
              "flash_fwd_hd160": ("flash_fwd", hd160_paths),
              "flash_decode_hd160": ("flash_decode", hd160_paths),
              "flash_decode_paged_hd160": ("flash_decode_paged", hd160_paths)}

    def launches(k, path, counts):
        if k in by_dim:
            base, on = by_dim[k]
            return counts.get(base, 0) if path in on else 0
        if any(base == k and path in on for base, on in by_dim.values()):
            return 0
        if k.endswith(("_hd64", "_hd160", "_hd256")):
            return counts.get(k, 0)
        return counts.get(k, 0) - sum(counts.get(f"{k}_hd{d}", 0) for d in (64, 160, 256))

    kernels = []
    for k in replaces:
        by_path = {path: launches(k, path, counts) for path, counts in paths.items()}
        kernels.append({
            "name": k, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{source[k]}.cu",
            "replaces": replaces[k], "launches": sum(by_path.values()),
            "launches_by_path": by_path, **results[k],
        })
    log(f"whisper serving: {json.dumps(whisper_summary)}")
    log(f"gpt-20m training: {json.dumps(gpt_summaries)}")
    log(f"whisper training: {json.dumps(wh_train_summary)}")
    log(f"gemma3-1b serving: {json.dumps(g3_summary)}")
    log(f"gemma3-1b training: {json.dumps(g3_train_summaries)}")
    log(f"stablelm-12b serving: {json.dumps(sl_summary)}")
    log(f"granite-moe-1b-a400m serving: {json.dumps(gr_summary)}")
    log(f"stablelm-12b training: {json.dumps(sl_train_summaries)}")
    log(f"gemma3-1b packed training: {json.dumps(g3_packed_summaries)}")
    log(f"stablelm-12b packed training: {json.dumps(sl_packed_summaries)}")
    log(f"gemma3-1b dense-schedule training: {json.dumps(g3_dense_summaries)}")
    log(f"stablelm-12b dense-schedule training: {json.dumps(sl_dense_summaries)}")
    log(f"gemma3-1b packed training with a split forward: "
        f"{json.dumps(g3_split_train_summaries)}")
    log(f"stablelm-12b packed training with a split forward: "
        f"{json.dumps(sl_split_train_summaries)}")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    run(main)
