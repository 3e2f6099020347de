#!/usr/bin/env python3
"""A/B the CUDA forward against variants of itself on one NVIDIA card.

Each variant is the forward of ``src/repro_torch/kernels/csrc/flash_fwd.cu``
with one design decision undone, stated as text edits of that source
(``VARIANTS`` below) inside one kernel: the pair kernel
(``fa2_fwd_kernel``, head_dim 64 and 128), the wide kernel
(``fa2_fwd_wide_kernel``, head_dim 160 and 256) or the fold of the split
forward. A variant may instead keep the source and pass the wrappers an
option (the wide kernel's tile mode), or build the parent design's forward
(the parent commit's ``flash_fwd.cu`` and ``sm90.cuh``, written under
``build/ab_forward/parent_src/`` first, see ``PARENT``; its C entry
launches the split walk and its fold in one call). The script
writes each variant beside a copy of ``sm90.cuh`` under
``build/ab_forward/<name>/``, builds every one with the nvcc line of
``kernels/_build.py`` (all at once), prints what ptxas says of it (spills,
serialised wgmmas), holds it against the plain version on one case a head
dim, and times it in turns with the others and SDPA's forward (each
variant, SDPA, then the same in reverse) after an L2 flush: the pair
kernel's variants at qwen3-8b's training and serving shapes and whisper's
encoder shape (the segment variants also on the packed source's ids), the
wide kernel's at stablelm-12b's prefill (causal; 2 and 3 kv splits), its
training shape (causal, SEG on the packed source's ids, DENSE, both, SEG
with 2 splits) and its short-q/long-kv corner (64 q rows against 1536,
4096 and 32,768 keys, the auto split), and at gemma3-1b's prefill (causal,
the 512 window, 3 kv splits), its training shape (causal, the window, SEG,
DENSE, both, SEG with 2 splits, and B 8) and its corner (32,768 keys). At
each split shape the walk and the fold are also timed alone beside the
fold's bound (the bytes of the partials read once, o and lse written
once); the parent's walk has no launch of its own.

Run from the repository root on a machine with an H100 and nvcc:

    python3 tools/ab_forward.py [--only TEXT ...] [variant ...]   # default: all

``--only`` keeps the shapes whose label contains one of the texts (e.g.
``--only gemma3 --only D=160``). It prints the card (``nvidia-smi`` name
and power limit), a line per measurement with the seconds since the start,
and, last, a JSON object of the times.
"""

from __future__ import annotations

import ctypes
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "ab_forward"

_PV_ALWAYS = """      const bool first = pend < 0;
      if (first)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) pc[kk][e] = 0u;
"""
_PV_PRODUCT = """      wgmma_rs_k64<D>(o, pc, sV + (first ? stage : pend) * L::TILE);
      wgmma_commit();
      wgmma_wait<1>();
"""
_PV_WAIT = """      wgmma_wait<0>();  // the pending O += P V is done: its stage is free
      fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(pc[kk]);
      if (!first) mbar_arrive(&empty[pend]);
"""
_IDS_MASKED = """          if (SEG && (flags & (kMask0 | kMask1))) {
            for (int r = lane; r < kBlockN; r += 32) {
              const bool in = k0 + r < p.Skv;
              asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\\n" ::"r"(
                               smem_u32(sKid + stage * kBlockN + r)),
                           "l"(kid_g + (in ? k0 + r : 0)), "r"(in ? 4 : 0)
                           : "memory");
            }
            asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\\n" ::"r"(
                             smem_u32(&full[stage]))
                         : "memory");
          }
"""

# The wide kernel's K stage, freed as soon as S has completed; undone, it is
# freed with V after the P V that reads V, as one barrier a stage would.
_K_EARLY = """        // S has completed and the stage's ids are read: K's stage is free
        // while this step's softmax and P V run.
        mbar_arrive(&k_empty[st]);
"""
_V_FREE = "        if (!first) mbar_arrive(&v_empty[pend]);\n"
_V_DRAIN = "          mbar_arrive(&v_empty[pend]);\n          pend = -1;\n"
_V_LAST = "      mbar_arrive(&v_empty[pend]);\n    }\n\n    if (single) {"
_PV_OWN = """        const int vs = first ? st : pend;
        mbar_wait(&v_full[vs], first ? ph : pph);
        wgmma_rs_k64<D>(o, pc, sV + vs * L::TILE);
"""
_V_WAIT = "        mbar_wait(first ? q_bar : &v_full[pend], first ? 0 : pph);\n"
# The wide kernel's CTA coordinates and the launch's grid.
_WIDE_ORDER = """  const int bh = blockIdx.x;
  const int i0 = single ? p.t_q - 1 - static_cast<int>(blockIdx.y)
                        : 2 * ((p.t_q + 1) / 2 - 1 - static_cast<int>(blockIdx.y));
"""
_WIDE_GRID = ("  const dim3 grid = kWide ? dim3(batch * p.Hq, tiles, p.ks) : dim3(tiles, batch * p.Hq, "
              "p.ks);\n")
# The fold's launch, and the earlier fold kernel (one CTA of D threads a q
# row and head, thread d folding column d).
_FOLD_LAUNCH = """  const long long chunks = static_cast<long long>(Sq) * (D / 4);
  const dim3 grid(static_cast<unsigned>((chunks + kFoldThreads - 1) / kFoldThreads), batch * Hq);
  fa2_fwd_fold_kernel<D><<<grid, kFoldThreads, 0, stream>>>(o_parts, lse_parts, o, lse, Hq, Sq,
                                                            ks);
"""
_FOLD_ROW = """template <int D>
__global__ void __launch_bounds__(D)
    fa2_fwd_fold_row_kernel(const float* o_parts, const float* lse_parts, __nv_bfloat16* o,
                            float* lse, int Hq, int Sq, int ks) {
  const int row = blockIdx.x, bh = blockIdx.y, d = threadIdx.x;
  const long long base = static_cast<long long>(bh) * ks * Sq + row;
  const float* lp = lse_parts + base;
  const float* op = o_parts + base * D + d;
  float m = -INFINITY;
  for (int s = 0; s < ks; ++s) m = fmaxf(m, lp[static_cast<long long>(s) * Sq]);
  const float m_safe = m == -INFINITY ? 0.f : m;
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < ks; ++s) {
    const float w = expf(lp[static_cast<long long>(s) * Sq] - m_safe);
    l += w;
    acc += w * op[static_cast<long long>(s) * Sq * D];
  }
  const float l_safe = l == 0.f ? 1.f : l;
  const int b = bh / Hq, h = bh % Hq;
  o[((static_cast<long long>(b) * Sq + row) * Hq + h) * D + d] = __float2bfloat16(acc / l_safe);
  if (d == 0)
    lse[static_cast<long long>(bh) * Sq + row] = l == 0.f ? -INFINITY : m_safe + logf(l_safe);
}

"""

# name -> (what it undoes, [(old text, new text), ...] on flash_fwd.cu, the
# text the edits apply to: the pair kernel (the default), the wide kernel
# or the whole file; wrapper options). A variant's edits match exactly once
# inside that text; "file" edits are timed with the pair kernel's.
VARIANTS = {
    "final": ("the forward as committed", []),
    "pingpong": (
        "adds FlashAttention-3's ping-pong: the consumer warpgroups take turns at issuing "
        "their products (named barriers 3 and 4), warpgroup 0 first",
        [("    mbar_wait(q_bar, 0);\n    // Q as bf16",
          "    if (w == 1) asm volatile(\"bar.arrive 3, 256;\\n\" ::: \"memory\");\n"
          "    mbar_wait(q_bar, 0);\n    // Q as bf16"),
         ("      if (rec.x < 0) break;\n",
          "      if (rec.x < 0) break;\n"
          "      asm volatile(\"bar.sync %0, 256;\\n\" ::\"r\"(3 + w) : \"memory\");\n"),
         ("      if (!(rec.y & take)) {\n",
          "      if (!(rec.y & take)) {\n"
          "        asm volatile(\"bar.arrive %0, 256;\\n\" ::\"r\"(3 + (w ^ 1)) : \"memory\");\n"),
         (_PV_PRODUCT, _PV_PRODUCT.replace(
             "      wgmma_wait<1>();\n",
             "      asm volatile(\"bar.arrive %0, 256;\\n\" ::\"r\"(3 + (w ^ 1)) : \"memory\");\n"
             "      wgmma_wait<1>();\n"))]),
    "conditional_pv": (
        "issues P V (and waits for it) only when a step is pending, instead of a P = 0 "
        "product on a run's first step",
        [(_PV_ALWAYS, "      const bool first = pend < 0;\n"),
         (_PV_PRODUCT, """      if (!first) {
        wgmma_rs_k64<D>(o, pc, sV + pend * L::TILE);
        wgmma_commit();
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
"""),
         (_PV_WAIT, """      if (!first) {
        wgmma_wait<0>();
        fence_regs(o);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) fence_regs(pc[kk]);
        mbar_arrive(&empty[pend]);
      }
""")]),
    "divergent": (
        "reads the warpgroup index and the step record without the broadcast from lane 0",
        [("  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);",
          "  const int wg = threadIdx.x / 128;"),
         ("      rec.x = __shfl_sync(0xffffffffu, rec.x, 0);\n"
          "      rec.y = __shfl_sync(0xffffffffu, rec.y, 0);\n", "")]),
    "stages3": ("a 3-stage K/V ring instead of 4 (at head_dim 64 and 128)",
                [("constexpr int kFwdStages = 4;", "constexpr int kFwdStages = 3;")], "file"),
    "ids_every_step": (
        "SEG: the producer's lanes load the kv tile's ids at every step (plain loads on its "
        "path), instead of a cp.async copy only when a tile needs the element mask",
        [(_IDS_MASKED, """          if (SEG) {
            for (int r = lane; r < kBlockN; r += 32)
              sKid[stage * kBlockN + r] = k0 + r < p.Skv ? kid_g[k0 + r] : kKvPadSegment;
          }
""")]),
    # The wide kernel (head_dim 160 and 256): each of its changes undone
    # alone, and the parent design.
    "kv_one_barrier": (
        "wide: frees K's stage with V's, after the P V that reads V (one barrier a stage), "
        "instead of once S has completed",
        [(_K_EARLY, ""),
         (_V_FREE, "        if (!first) {\n          mbar_arrive(&v_empty[pend]);\n"
                   "          mbar_arrive(&k_empty[pend]);\n        }\n"),
         (_V_DRAIN, "          mbar_arrive(&v_empty[pend]);\n          mbar_arrive(&k_empty[pend]);"
                    "\n          pend = -1;\n"),
         (_V_LAST, "      mbar_arrive(&v_empty[pend]);\n      mbar_arrive(&k_empty[pend]);\n    }"
                   "\n\n    if (single) {")], "wide"),
    "pair_grid": ("wide: a pair of q tiles a CTA at every shape (the wrappers' single_tile=False), "
                  "instead of one q tile a CTA where the pair grid is under one wave", [], "wide",
                  dict(single_tile=False)),
    "single_grid": ("wide: one q tile a CTA at every shape (single_tile=True), the pair grid's "
                    "counterpart: what the rule's choice of the pair where the grid fills the "
                    "card keeps", [], "wide", dict(single_tile=True)),
    "first_pv_on_own_v": (
        "wide: a run's first P = 0 product reads the step's own V stage (waited for after S is "
        "issued), instead of the zero tile (160) or the Q tile (256), landed before the walk",
        [("        mbar_wait(first ? q_bar : &v_full[pend], first ? 0 : pph);\n", ""),
         ("        wgmma_rs_k64<D>(o, pc, first ? sZ : sV + pend * L::TILE);\n", _PV_OWN)],
        "wide"),
    "v_wait_before_s": (
        "wide: a taken step waits for the pending step's V before it issues S = Q K^T, instead "
        "of after (S then runs while that V lands)",
        [(_V_WAIT, ""),
         ("        float s[32];\n        wgmma_fence();\n", _V_WAIT + "        float s[32];\n"
          "        wgmma_fence();\n")], "wide"),
    "q_in_smem": (
        "wide, 160: Q stays in shared memory and S = Q K^T reads it there (as at 256), instead "
        "of as register fragments read once",
        [("  constexpr bool QREG = D == 160;", "  constexpr bool QREG = false;")], "wide"),
    "tile_major_grid": (
        "wide: the grid's q tiles on x (the fastest axis of the dispatch order), batch * q "
        "head on y, as before, instead of batch * q head on x: the first wave then holds "
        "every tile of the first heads, longest first",
        [(_WIDE_ORDER, _WIDE_ORDER.replace("blockIdx.x", "blockIdx.@").replace(
            "blockIdx.y", "blockIdx.x").replace("blockIdx.@", "blockIdx.y")),
         (_WIDE_GRID, _WIDE_GRID.replace("dim3(batch * p.Hq, tiles, p.ks)",
                                         "dim3(tiles, batch * p.Hq, p.ks)"), "file")], "wide"),
    "pair_head_major": (
        "pair (64/128; measured, not adopted): batch * q head on x and the pairs on y, as the "
        "wide kernel's grid, instead of the pairs on x",
        [("(p.t_q + 1) / 2 - 1 - static_cast<int>(blockIdx.x));  // longest walks first",
          "(p.t_q + 1) / 2 - 1 - static_cast<int>(blockIdx.y));  // longest walks first"),
         ("  const int bh = blockIdx.y;\n", "  const int bh = blockIdx.x;\n"),
         (_WIDE_GRID, _WIDE_GRID.replace(": dim3(tiles, batch * p.Hq, p.ks)",
                                         ": dim3(batch * p.Hq, tiles, p.ks)"), "file")]),
    "fold_per_row": (
        "fold: the earlier fold, one CTA of D threads a (q row, batch * q head), 4-byte loads, "
        "instead of 256 threads over 16-byte chunks of consecutive rows",
        [(_FOLD_LAUNCH, "  fa2_fwd_fold_row_kernel<D><<<dim3(Sq, batch * Hq), D, 0, stream>>>(\n"
                        "      o_parts, lse_parts, o, lse, Hq, Sq, ks);\n"),
         ("template <int D>\ncudaError_t fold(", _FOLD_ROW + "template <int D>\ncudaError_t fold(")],
        "fold"),
    "parent": ("the parent design (the parent commit's flash_fwd.cu, see PARENT: at 160 the pair "
               "kernel, K and V of a stage on one barrier, 4 stages, Q in registers; at 256 the "
               "wide kernel with the q tiles on the grid's x; the fold one CTA a row), timed at "
               "every shape (at 64 and 128 its pair kernel is the committed one: a control)", [],
               "all"),
}

# The parent commit's flash_fwd.cu and sm90.cuh, for the parent variant:
# write them here first, e.g.
#   mkdir -p build/ab_forward/parent_src
#   git show <commit>:src/repro_torch/kernels/csrc/flash_fwd.cu > build/ab_forward/parent_src/flash_fwd.cu
#   git show <commit>:src/repro_torch/kernels/csrc/sm90.cuh > build/ab_forward/parent_src/sm90.cuh
PARENT = OUT / "parent_src"
_SCOPES = {"pair": ("fa2_fwd_kernel(const FwdParams p", "// ---------------------------------------"),
           "wide": ("fa2_fwd_wide_kernel(const FwdParams p", "// The fold of SPLIT's partials"),
           "file": ("", None), "fold": ("", None)}


def scope(name: str) -> str:
    """The kernel a variant's edits apply to (an edit may name another:
    "file"), and so the shapes it is timed at: "pair" and "file" the pair
    kernel's, "wide" the wide kernel's, "fold" every split shape, "all"
    every shape."""
    return VARIANTS[name][2] if len(VARIANTS[name]) > 2 else "pair"


def options(name: str) -> dict:
    """The wrapper options a variant passes."""
    return VARIANTS[name][3] if len(VARIANTS[name]) > 3 else {}


def nvidia_smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]


def write_variants(names):
    source = (CSRC / "flash_fwd.cu").read_text()
    for name in names:
        if name == "parent" and not (PARENT / "flash_fwd.cu").exists():
            raise SystemExit(f"variant parent: no {PARENT / 'flash_fwd.cu'} (see PARENT)")
        text = (PARENT / "flash_fwd.cu").read_text() if name == "parent" else source
        if VARIANTS[name][1]:
            edits = [e if len(e) == 3 else (*e, scope(name)) for e in VARIANTS[name][1]]
            for old, new, where in edits:
                start, end = _SCOPES[where]
                a = text.index(start)
                b = len(text) if end is None else text.index(end, a)
                body = text[a:b]
                if body.count(old) != 1:
                    raise SystemExit(f"variant {name}: its edit no longer matches the "
                                     f"{where} text of flash_fwd.cu")
                text = text[:a] + body.replace(old, new) + text[b:]
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "flash_fwd.cu").write_text(text)
        shutil.copy((PARENT if name == "parent" else CSRC) / "sm90.cuh", d / "sm90.cuh")


class _Parent:
    """The parent design's library behind the committed wrappers. Its entry
    launches a split walk and its fold in one call (o_fold, lse_fold before
    the stream) and has no fold entry of its own, so a split walk waits here
    for the fold's call; at head_dim 160 it takes the pair of q tiles only,
    so the one-q-tile flag goes to 0 there."""

    def __init__(self, lib):
        self.lib = lib
        self.walk = None

    def fa2_fwd_bf16(self, *args):
        args = list(args)
        if args[24] == 160:  # head_dim
            args[-1] = 0
        if args[32]:  # split
            self.walk = args
            return 0
        return self.lib.fa2_fwd_bf16(*args[:-2], None, None, *args[-2:])

    def fa2_fwd_fold_f32(self, o_parts, lse_parts, o, lse, *rest):
        args, self.walk = self.walk, None
        return self.lib.fa2_fwd_bf16(*args[:-2], o, lse, *args[-2:])


def build(names):
    """Build every variant with edits (and the committed source, "final",
    and the parent) at once; a variant of options only reuses "final"."""
    from repro_torch.kernels import _build

    nvcc = _build._nvcc()
    own = [n for n in names if n in ("final", "parent") or VARIANTS[n][1]]
    procs = {n: subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-o", str(OUT / n / "lib.so"),
                                  str(OUT / n / "flash_fwd.cu")], stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True) for n in own}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        spills = sorted({m for m in re.findall(r"(\d+) bytes spill stores", log)}, key=int)
        notes = sorted({m for m in re.findall(r"\((C75\d+)\) Potential Performance Loss", log)})
        print(f"{name}: {VARIANTS[name][0]}; spill stores (bytes) per instantiation "
              f"{spills}; ptxas performance notes {notes or 'none'}", flush=True)
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        P, I, L = _build.VOIDP, _build.INT, _build.I64
        tail = [P, P, P, I] if name == "parent" else [P, I]  # (o_fold, lse_fold,) stream, single
        lib.fa2_fwd_bf16.argtypes = [P] * 6 + [L] * 13 + [I] * 16 + [P, P, L, L, P, I] + tail
        lib.fa2_fwd_bf16.restype = ctypes.c_int
        if name != "parent":
            lib.fa2_fwd_fold_f32.argtypes = [P] * 4 + [I] * 5 + [P]
            lib.fa2_fwd_fold_f32.restype = ctypes.c_int
        libs[name] = _Parent(lib) if name == "parent" else lib
    for name in names:
        if name not in libs:
            print(f"{name}: {VARIANTS[name][0]}", flush=True)
            libs[name] = libs["final"]
    return libs


def main() -> None:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script times kernels on an NVIDIA GPU")
    from repro_torch.core.masks import MaskSpec
    from repro_torch.data.pipeline import DataConfig, SyntheticVarlenLM
    from repro_torch.kernels import flash_fwd as fwd
    from repro_torch.kernels import ops

    args, only = sys.argv[1:], []
    while "--only" in args:
        i = args.index("--only")
        only.append(args[i + 1])
        del args[i:i + 2]
    names = args or list(VARIANTS)
    if "final" not in names:
        names.insert(0, "final")
    print(nvidia_smi(), flush=True)
    t0 = time.perf_counter()
    write_variants(names)
    libs = build(names)
    print(f"built in {time.perf_counter() - t0:.0f} s", flush=True)
    fold = fwd._fold

    def use(name):
        fwd._lib = lambda: libs[name]

    def in_scope(name, D, split=False):
        where = scope(name)
        if where in ("all", "fold"):
            return where == "all" or split
        return name == "final" or (where == "wide") == (D in fwd.WIDE_HEAD_DIMS)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs(B, S, Hq, Hkv, D, Skv=None):
        q = ops._prep(torch.randn((B, S, Hq, D), generator=gen, device=dev).bfloat16(),
                      1 / math.sqrt(D))
        Skv = S if Skv is None else Skv
        return (q, torch.randn((B, Skv, Hkv, D), generator=gen, device=dev).bfloat16(),
                torch.randn((B, Skv, Hkv, D), generator=gen, device=dev).bfloat16())

    def packed(B, S):
        ids = SyntheticVarlenLM(DataConfig(B, S, 512, seed=0, source="packed")).batch(0)
        return torch.from_numpy(ids["segment_ids"]).to(dev)

    tiles = dict(block_q=64, block_kv=64)
    bad = 0
    causal = MaskSpec(causal=True)
    for D, Hq, Hkv in ((128, 32, 8), (160, 32, 8), (256, 4, 1)):
        q, k, v = inputs(2, 700, Hq, Hkv, D)
        ids = packed(2, 700)
        plain = {}  # the plain versions' results by tile-mode option
        for name in [n for n in names if in_scope(n, D, split=True)]:
            use(name)
            kw = dict(tiles, **options(name))
            mode = kw.get("single_tile")
            if mode not in plain:
                plain[mode] = (fwd.flash_fwd_plain(q, k, v, causal, **kw),
                               fwd.flash_fwd_plain(q, k, v, causal, q_seg=ids, kv_seg=ids, **kw),
                               fwd.flash_fwd_splitkv_plain(q, k, v, causal, kv_splits=3, **kw))
            want, want_s, want_x = plain[mode]
            got = fwd.flash_fwd(q, k, v, causal, **kw)
            got_s = fwd.flash_fwd_varlen(q, k, v, causal, ids, ids, **kw)
            got_x = fwd.flash_fwd_splitkv(q, k, v, causal, kv_splits=3, **kw)
            torch.cuda.synchronize()
            err = max((a.float() - b.float()).abs().max().item()
                      for a, b in ((got[0], want[0]), (got_s[0], want_s[0]),
                                   (got_x.o, want_x.o), (got_x.o_parts, want_x.o_parts)))
            ok = err <= 2e-2
            bad += not ok
            print(f"{name}: D={D} B=2 S=700 causal, max|o-plain| (unsegmented, packed, 3 "
                  f"splits: fold and partials) {err:.3e} (tol 2e-2){'' if ok else ' FAILS'}",
                  flush=True)

    print(f"[{time.perf_counter() - t0:.0f} s] checked against the plain versions", flush=True)
    scratch = torch.empty(96 * 2**20, dtype=torch.uint8, device=dev)

    def time_ms(fn, iters=30):
        fn()
        fn()
        torch.cuda.synchronize()
        events = []
        for _ in range(iters):
            scratch.zero_()
            torch.cuda._sleep(1_000_000)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in events) / iters

    # label -> (B, Sq, Skv, Hq, Hkv, D, spec, kv splits or None, form): form
    # "" the compact schedule, "seg" the packed source's ids (Sq == Skv),
    # "dense" the dense schedule, "dense seg" both. kv splits "auto": the
    # public policy's (ops.resolve_kv_splits).
    window = MaskSpec(causal=True, window=512)

    def corner(Skv):
        return MaskSpec(causal=True, q_offset=Skv - 64)

    shapes = {
        "training B=2 S=2048 causal D=128": (2, 2048, 2048, 32, 8, 128, causal, None, ""),
        "serving B=1 S=1536 causal D=128": (1, 1536, 1536, 32, 8, 128, causal, None, ""),
        "whisper encoder B=4 S=1500 FULL D=64": (4, 1500, 1500, 8, 8, 64, MaskSpec(), None, ""),
        "whisper cross B=4 Sq=4 Skv=1500 FULL D=64, auto splits": (
            4, 4, 1500, 8, 8, 64, MaskSpec(), "auto", ""),
        "qwen3 packed split B=2 S=700 causal D=128 SEG, 3 splits": (
            2, 700, 700, 32, 8, 128, causal, 3, "seg"),
        "stablelm prefill B=1 S=1536 causal D=160": (1, 1536, 1536, 32, 8, 160, causal, None, ""),
        "stablelm split prefill B=1 S=1536 causal D=160, 2 splits": (
            1, 1536, 1536, 32, 8, 160, causal, 2, ""),
        "stablelm split prefill B=1 S=1536 causal D=160, 3 splits": (
            1, 1536, 1536, 32, 8, 160, causal, 3, ""),
        "stablelm training B=2 S=2048 causal D=160": (2, 2048, 2048, 32, 8, 160, causal, None, ""),
        "stablelm training B=2 S=2048 causal D=160 SEG": (
            2, 2048, 2048, 32, 8, 160, causal, None, "seg"),
        "stablelm training B=2 S=2048 causal D=160 DENSE": (
            2, 2048, 2048, 32, 8, 160, causal, None, "dense"),
        "stablelm training B=2 S=2048 causal D=160 DENSE SEG": (
            2, 2048, 2048, 32, 8, 160, causal, None, "dense seg"),
        "stablelm packed split B=2 S=2048 causal D=160 SEG, 2 splits": (
            2, 2048, 2048, 32, 8, 160, causal, 2, "seg"),
        "stablelm corner Sq=64 Skv=1536 causal D=160, auto splits": (
            1, 64, 1536, 32, 8, 160, corner(1536), "auto", ""),
        "stablelm corner Sq=64 Skv=4096 causal D=160, auto splits": (
            1, 64, 4096, 32, 8, 160, corner(4096), "auto", ""),
        "stablelm corner Sq=64 Skv=32768 causal D=160, auto splits": (
            1, 64, 32768, 32, 8, 160, corner(32768), "auto", ""),
        "gemma3 prefill B=1 S=1536 causal D=256": (1, 1536, 1536, 4, 1, 256, causal, None, ""),
        "gemma3 prefill B=1 S=1536 window 512 D=256": (1, 1536, 1536, 4, 1, 256, window, None, ""),
        "gemma3 split prefill B=1 S=1536 causal D=256, 3 splits": (
            1, 1536, 1536, 4, 1, 256, causal, 3, ""),
        "gemma3 training B=4 S=2048 causal D=256": (4, 2048, 2048, 4, 1, 256, causal, None, ""),
        "gemma3 training B=4 S=2048 window 512 D=256": (
            4, 2048, 2048, 4, 1, 256, window, None, ""),
        "gemma3 training B=4 S=2048 causal D=256 SEG": (
            4, 2048, 2048, 4, 1, 256, causal, None, "seg"),
        "gemma3 training B=4 S=2048 causal D=256 DENSE": (
            4, 2048, 2048, 4, 1, 256, causal, None, "dense"),
        "gemma3 training B=4 S=2048 causal D=256 DENSE SEG": (
            4, 2048, 2048, 4, 1, 256, causal, None, "dense seg"),
        "gemma3 packed split B=4 S=2048 causal D=256 SEG, 2 splits": (
            4, 2048, 2048, 4, 1, 256, causal, 2, "seg"),
        "gemma3 B=8 S=2048 causal D=256": (8, 2048, 2048, 4, 1, 256, causal, None, ""),
        "gemma3 corner Sq=64 Skv=32768 causal D=256, auto splits": (
            1, 64, 32768, 4, 1, 256, corner(32768), "auto", ""),
    }
    result = {}
    for label, (B, Sq, Skv, Hq, Hkv, D, spec, ks, form) in shapes.items():
        here = [n for n in names if in_scope(n, D, ks is not None)]
        if (here == ["final"] and len(names) > 1) or (only and not any(t in label for t in only)):
            continue
        if ks == "auto":
            ks = ops.resolve_kv_splits(None, (B, Sq, Hq, D), (B, Skv, Hkv, D))
        q, k, v = inputs(B, Sq, Hq, Hkv, D, Skv)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        ids = packed(B, Sq) if "seg" in form else None
        sched = dict(schedule="dense") if "dense" in form else {}
        sdpa_kw = dict(is_causal=spec.causal)
        if ks is not None:
            sdpa_kw = dict(attn_mask=torch.ones(Sq, Skv, dtype=torch.bool, device=dev).tril(
                Skv - Sq)) if spec.causal else {}
        if spec.window is not None or ids is not None:
            ago = torch.arange(Sq, device=dev)[:, None] - torch.arange(Skv, device=dev)[None, :]
            mask = (ago >= 0) & (ago < (spec.window or Skv))
            if ids is not None:
                mask = mask & (ids[:, None, :, None] == ids[:, None, None, :])
            sdpa_kw = dict(attn_mask=mask)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, scale=1.0,
                                                  **sdpa_kw)

        def call(name):
            kw = dict(tiles, **options(name))
            if ids is not None and ks is None:
                return lambda: fwd.flash_fwd_varlen(q, k, v, spec, ids, ids, **sched, **kw)
            if ids is not None:
                return lambda: fwd.flash_fwd_splitkv_varlen(q, k, v, spec, ids, ids,
                                                            kv_splits=ks, **kw)
            if ks is None:
                return lambda: fwd.flash_fwd(q, k, v, spec, **sched, **kw)
            return lambda: fwd.flash_fwd_splitkv(q, k, v, spec, kv_splits=ks, **kw)

        runs = {n: [] for n in here + ["sdpa"]}
        order = here + ["sdpa"]
        for name in order + order[::-1]:
            if name == "sdpa":
                runs[name].append(time_ms(sdpa))
            else:
                use(name)
                runs[name].append(time_ms(call(name)))
        ms = {n: sum(r) / 2 for n, r in runs.items()}
        n_ks = fwd.split_count(Skv, 64, ks) if ks else 1
        mode = ("one q tile a CTA" if fwd.single_q_tile(B, Hq, -(-Sq // 64), D, n_ks)
                else "a pair of q tiles a CTA")
        print(f"[{time.perf_counter() - t0:.0f} s] {label} (final: {mode}): sdpa "
              f"{ms['sdpa']:.4f} ms; " + "; ".join(
            f"{n} {ms[n]:.4f} ms ({ms[n] / ms['sdpa']:.4f}x sdpa, {ms[n] / ms['final']:.4f}x "
            f"final)" for n in here), flush=True)
        if ks is not None:
            # The walk alone (the fold a no-op) and the fold alone on the
            # walk's partials, each variant but the parent in turns, beside
            # the fold's bound: its bytes over the memory rate.
            apart = [n for n in here if n != "parent"]
            walk_runs = {n: [] for n in apart}
            fold_runs = {n: [] for n in apart}
            for name in apart + apart[::-1]:
                use(name)
                out = call(name)()
                o_f, lse_f = torch.empty_like(out.o), torch.empty_like(out.lse)
                fwd._fold = lambda *a: None
                try:
                    walk_runs[name].append(time_ms(call(name)))
                finally:
                    fwd._fold = fold
                fold_runs[name].append(time_ms(lambda: fold(out.o_parts, out.lse_parts, o_f,
                                                            lse_f)))
            nbytes = out.o_parts.numel() * 4 + out.lse_parts.numel() * 4 + out.o.numel() * 2 \
                + out.lse.numel() * 4
            fold_bound = nbytes / 3.35e12 * 1e3
            for name in apart:
                ms[f"{name} walk"] = sum(walk_runs[name]) / 2
                ms[f"{name} fold"] = sum(fold_runs[name]) / 2
            print(f"{label}, apart ({n_ks} splits; the fold's bound {fold_bound:.4f} ms, "
                  f"{nbytes} bytes): " + "; ".join(
                      f"{n} walk {ms[f'{n} walk']:.4f} ms, fold {ms[f'{n} fold']:.4f} ms "
                      f"({ms[f'{n} fold'] / fold_bound:.2f}x its bound)" for n in apart),
                  flush=True)
            ms["fold_bound"] = fold_bound
        result[label] = ms

    B, S = 2, 2048
    q, k, v = inputs(B, S, 32, 8, 128)
    ids = packed(B, S)
    ones = torch.ones_like(ids)
    seg_names = [n for n in names if in_scope(n, 128)]
    for label, seg in (("packed step 0", ids), ("all-ones ids", ones)):
        if (seg_names == ["final"] and len(names) > 1) or only:
            break
        runs = {n: [] for n in seg_names}
        for name in seg_names + seg_names[::-1]:
            use(name)
            runs[name].append(time_ms(lambda: fwd.flash_fwd_varlen(q, k, v, causal, seg, seg,
                                                                  **tiles)))
        ms = {n: sum(r) / 2 for n, r in runs.items()}
        result[f"segments, training shape, {label}"] = ms
        print(f"flash_fwd_varlen B={B} S={S} causal, {label}: " + "; ".join(
            f"{n} {ms[n]:.4f} ms" for n in seg_names), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "ms": result}), flush=True)
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
