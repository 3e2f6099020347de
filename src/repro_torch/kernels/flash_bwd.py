"""FlashAttention-2 backward (Algorithm 2): the Hopper CUDA kernels and
their plain versions.

Replaces two Pallas TPU kernels of ``repro/kernels/flash_bwd.py``:

  * :func:`flash_bwd_delta` <- ``flash_bwd_delta`` (:80): delta =
    rowsum(dO o O), Algorithm 2 line 4, as f32 (B, Hq, Sq).
  * :func:`flash_bwd_fused` <- ``flash_bwd_fused`` (:718, compact body
    ``_fused_kernel_compact`` :672): dK, dV and dQ in one pass over the
    visible tiles, one (S, P) recompute per tile.

The TPU kernel runs a sequential kv-major grid and uses each q tile's first
visit to zero its f32 dq block and compute its delta into VMEM scratch. On
Hopper the kv-tile CTAs run in parallel and in no order, so nothing marks a
first visit: delta is this pre-pass, and dq is an f32 buffer that the
wrapper zeroes and every CTA ``atomicAdd``s its dS K contribution into (the
paper's own choice). dK and dV need no atomics: a CTA owns one kv tile and
loops over the G q heads that share it and their visible q tiles
(``schedule.build_kv_tile_schedule``). The sums in dq come in no fixed
order, so dq is not bitwise reproducible from run to run; it is held to
``allclose``. The sources are ``csrc/flash_bwd.cu``; its header says what
bounds each kernel on an H100 and how the design answers.

Layouts are the public ones, read in place through strides: q and dO
(B, Sq, Hq, D), q pre-scaled by the softmax scale; k, v (B, Skv, Hkv, D);
o (B, Sq, Hq, D); lse and delta (B, Hq, Sq) f32. Outputs are f32: dq
(B, Sq, Hq, D) with respect to the *scaled* q, dk and dv (B, Skv, Hkv, D).

Each wrapper takes its plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.core.masks import DEFAULT_MASK_VALUE, MaskSpec, make_tile_mask
from repro_torch.kernels import _build
from repro_torch.kernels.flash_fwd import _check_kernel_inputs, _check_layout, _tiles
from repro_torch.kernels.schedule import build_kv_tile_schedule


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_device(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda (kernel) or cpu (plain), not {t.device}")


# ------------------------------------------------------------------ delta


def flash_bwd_delta(o, do):
    """delta = rowsum(dO o O) in f32: o, do (B, Sq, Hq, D) -> (B, Hq, Sq)."""
    if o.shape != do.shape or o.ndim != 4:
        raise ValueError(f"want o and do (B,Sq,Hq,D); got {tuple(o.shape)}, {tuple(do.shape)}")
    if o.device.type == "cpu":
        return flash_bwd_delta_plain(o, do)
    _check_device("flash_bwd_delta", o)
    B, Sq, Hq, D = o.shape
    _check_kernel_inputs("the CUDA delta pre-pass", None, o=o, do=do)
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=o.device)
    err = _lib().fa2_bwd_delta_bf16(
        o.data_ptr(), do.data_ptr(), delta.data_ptr(),
        o.stride(0), o.stride(1), o.stride(2),
        do.stride(0), do.stride(1), do.stride(2),
        B, Hq, Sq, D, _stream(o),
    )
    _build.check(err, "fa2_bwd_delta_bf16")
    flash_bwd_delta.launches += 1
    return delta


flash_bwd_delta.launches = 0  # kernel launches (CUDA tensors only)


def flash_bwd_delta_plain(o, do):
    """The pre-pass in plain PyTorch: f32 products summed over D."""
    flash_bwd_delta_plain.calls += 1
    return (o.float() * do.float()).sum(dim=-1).transpose(1, 2).contiguous()


flash_bwd_delta_plain.calls = 0


# ------------------------------------------------------------------ fused


def _check_bwd_inputs(q, k, v, do, lse, delta):
    _check_layout(q, k, v)
    B, Sq, Hq, _ = q.shape
    if do.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} must match q {tuple(q.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B, Hq, Sq) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be f32 (B, Hq, Sq) = {(B, Hq, Sq)}; got "
                             f"{t.dtype} {tuple(t.shape)}")


def flash_bwd_fused(q, k, v, do, lse, delta, spec: MaskSpec, *, block_q: int, block_kv: int):
    """dq, dk, dv (f32) of FA2 on pre-scaled q. ``lse`` is the forward's raw
    logsumexp (-inf on fully masked rows); ``delta`` is the pre-pass's."""
    _check_bwd_inputs(q, k, v, do, lse, delta)
    if q.device.type == "cpu":
        return flash_bwd_fused_plain(q, k, v, do, lse, delta, spec,
                                     block_q=block_q, block_kv=block_kv)
    _check_device("flash_bwd_fused", q)
    B, Sq, Hq, D = q.shape
    # dq is summed into by every kv tile's CTA; dk and dv are written once.
    dq = torch.zeros((B, Sq, Hq, D), dtype=torch.float32, device=q.device)
    dk, dv = _launch_fused(q, k, v, do, lse, delta, spec, block_q, block_kv, dq)
    flash_bwd_fused.launches += 1
    return dq, dk, dv


def _launch_fused(q, k, v, do, lse, delta, spec, block_q, block_kv, dq):
    """Launch the fused kernel; returns (dk, dv). ``dq`` None launches the
    timing variant that computes dS K but skips its atomics into dq."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    _check_kernel_inputs("the CUDA fused backward", (block_q, block_kv),
                         q=q, k=k, v=v, do=do)
    lse, delta = lse.contiguous(), delta.contiguous()
    if lse.device != q.device or delta.device != q.device:
        raise ValueError("lse and delta must lie on q's device")
    t_q, t_kv = _tiles(Sq, block_q), _tiles(Skv, block_kv)
    if t_kv > 65535:
        raise ValueError("kv tiles exceed the grid's y limit (65535)")
    table = _device_table(spec, t_q, t_kv, block_q, block_kv, Skv, str(q.device))
    dk = torch.empty((B, Skv, Hkv, D), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    err = _lib().fa2_bwd_fused_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(),
        None if dq is None else dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        table.data_ptr(),
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        do.stride(0), do.stride(1), do.stride(2),
        B, Hq, Hkv, Sq, Skv, D, block_q, block_kv,
        int(spec.causal), -1 if spec.window is None else int(spec.window),
        int(spec.sink), int(spec.q_offset), t_kv, _stream(q),
    )
    _build.check(err, "fa2_bwd_fused_bf16")
    return dk, dv


flash_bwd_fused.launches = 0  # kernel launches (CUDA tensors only)


@functools.lru_cache(maxsize=64)
def _device_table(spec, t_q, t_kv, bq, bk, kv_valid, device: str) -> torch.Tensor:
    sched = build_kv_tile_schedule(spec, t_q, t_kv, bq, bk, kv_valid)
    return torch.from_numpy(sched.device_table()).to(device)


@functools.lru_cache(maxsize=1)
def _lib():
    lib = _build.load("flash_bwd")
    P, I, L = _build.VOIDP, _build.INT, _build.I64
    lib.fa2_bwd_delta_bf16.argtypes = [P] * 3 + [L] * 6 + [I] * 4 + [P]
    lib.fa2_bwd_delta_bf16.restype = ctypes.c_int
    lib.fa2_bwd_fused_bf16.argtypes = [P] * 10 + [L] * 12 + [I] * 13 + [P]
    lib.fa2_bwd_fused_bf16.restype = ctypes.c_int
    return lib


def flash_bwd_fused_plain(q, k, v, do, lse, delta, spec: MaskSpec, *,
                          block_q: int, block_kv: int):
    """The fused kernel's algorithm in plain PyTorch (f32 math, any device).

    The same kv-major walk over the same visible tiles, the same mask value,
    the lse = -inf -> 0 substitution of fully masked rows, and the same
    roundings to the input dtype: P before dV += P^T dO, dS before
    dK += dS^T Q and dQ += dS K (``_dkv_tile_math``/``_fused_compute`` of
    the JAX kernel). The G q heads of a kv head are summed together."""
    flash_bwd_fused_plain.calls += 1
    _check_bwd_inputs(q, k, v, do, lse, delta)
    B, Sq, Hq, D = q.shape
    _, Skv, Hk, _ = k.shape
    G = Hq // Hk
    dt = q.dtype
    t_q, t_kv = _tiles(Sq, block_q), _tiles(Skv, block_kv)
    sched = build_kv_tile_schedule(spec, t_q, t_kv, block_q, block_kv, Skv)
    # Rows past the ends read as zeros, as in the kernel; a q row past Sq
    # gets lse = +inf (so P = 0 there) and delta = 0.
    pq, pk = t_q * block_q - Sq, t_kv * block_kv - Skv
    qh = F.pad(q, (0, 0, 0, 0, 0, pq)).reshape(B, -1, Hk, G, D).float()
    doh = F.pad(do, (0, 0, 0, 0, 0, pq)).reshape(B, -1, Hk, G, D).float()
    kp = F.pad(k, (0, 0, 0, 0, 0, pk)).float()
    vp = F.pad(v, (0, 0, 0, 0, 0, pk)).float()
    lse_s = torch.where(torch.isneginf(lse), torch.zeros_like(lse), lse)
    lse_s = F.pad(lse_s, (0, pq), value=float("inf")).reshape(B, Hk, G, -1)
    dl = F.pad(delta, (0, pq)).reshape(B, Hk, G, -1)
    dq = torch.zeros_like(qh)
    dk = torch.zeros_like(kp)
    dv = torch.zeros_like(vp)
    for j in range(t_kv):
        c0, c1 = j * block_kv, (j + 1) * block_kv
        kj, vj = kp[:, c0:c1], vp[:, c0:c1]
        cols = torch.arange(c0, c1, device=q.device)
        for s in range(sched.row_ptr[j], sched.row_ptr[j + 1]):
            i = int(sched.inner[s])
            r0, r1 = i * block_q, (i + 1) * block_q
            qi, doi = qh[:, r0:r1], doh[:, r0:r1]
            sc = torch.einsum("bqhgd,bkhd->bhgqk", qi, kj)
            if sched.masked[s]:
                rows = torch.arange(r0, r1, device=q.device) + spec.q_offset
                vis = (cols < Skv)[None, :]
                tm = make_tile_mask(spec, rows, cols)
                vis = vis if tm is None else vis & tm
                sc = sc.masked_fill(~vis, DEFAULT_MASK_VALUE)
            p = torch.exp(sc - lse_s[..., r0:r1, None])
            dv[:, c0:c1] += torch.einsum("bhgqk,bqhgd->bkhd", p.to(dt).float(), doi)
            dp = torch.einsum("bqhgd,bkhd->bhgqk", doi, vj)
            ds = (p * (dp - dl[..., r0:r1, None])).to(dt).float()
            dk[:, c0:c1] += torch.einsum("bhgqk,bqhgd->bkhd", ds, qi)
            dq[:, r0:r1] += torch.einsum("bhgqk,bkhd->bqhgd", ds, kj)
    return (dq[:, :Sq].reshape(B, Sq, Hq, D), dk[:, :Skv].contiguous(),
            dv[:, :Skv].contiguous())


flash_bwd_fused_plain.calls = 0
