"""FlashAttention-2 forward: the Hopper CUDA kernel and its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/flash_fwd.py:354 flash_fwd``
(compact schedule; banded launches included, since on Hopper the q tile is
a parallel grid axis anyway). The kernel source is ``csrc/flash_fwd.cu``;
its header says what bounds it on an H100 and how the design answers.

Layout (the public one, read in place through strides -- no head-major
transpose and no padding copy): q (B, Sq, Hq, D) already multiplied by the
softmax scale, k/v (B, Skv, Hkv, D); q head ``h`` reads kv head ``h // G``.
Returns o (B, Sq, Hq, D) in q's dtype and lse (B, Hq, Sq) f32.

:func:`flash_fwd` takes the plain version :func:`flash_fwd_plain` only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.core.masks import DEFAULT_MASK_VALUE, MaskSpec, make_tile_mask
from repro_torch.kernels import _build
from repro_torch.kernels.schedule import build_q_tile_schedule

# (block_q, block_kv) and head dims the CUDA kernel is instantiated for.
KERNEL_BLOCKS = ((64, 64),)
KERNEL_HEAD_DIMS = (128,)


def _tiles(n: int, block: int) -> int:
    return -(-n // block)


def _check_layout(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B,Sq,Hq,D), k/v (B,Skv,Hkv,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, _, Hq, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or Hq % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not match k/v {tuple(k.shape)}")


def flash_fwd(q, k, v, spec: MaskSpec, *, block_q: int, block_kv: int):
    """FA2 forward on pre-scaled q. See the module docstring for layouts."""
    _check_layout(q, k, v)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, spec, block_q=block_q, block_kv=block_kv)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd runs on cuda (kernel) or cpu (plain), not {q.device}")
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    _check_kernel_inputs("the CUDA forward", (block_q, block_kv), q=q, k=k, v=v)
    t_q, t_kv = _tiles(Sq, block_q), _tiles(Skv, block_kv)
    table = _device_table(spec, t_q, t_kv, block_q, block_kv, Skv, str(q.device))
    o = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    lib = _lib()
    err = lib.fa2_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        table.data_ptr(),
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        o.stride(0), o.stride(1), o.stride(2),
        B, Hq, Hkv, Sq, Skv, D, block_q, block_kv,
        int(spec.causal), -1 if spec.window is None else int(spec.window),
        int(spec.sink), int(spec.q_offset), t_q,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "fa2_fwd_bf16")
    flash_fwd.launches += 1
    return o, lse


flash_fwd.launches = 0  # kernel launches (CUDA tensors only)


def _check_kernel_inputs(what: str, blocks, **tensors):
    """Raise on what the CUDA kernels do not take: bf16 tensors on the first
    one's device, unit last stride, 16-byte aligned rows, the head_dim and
    (block_q, block_kv) they are instantiated for (``blocks`` None: no
    tiles to check)."""
    first = next(iter(tensors.values()))
    for name, t in tensors.items():
        if t.device != first.device:
            raise ValueError(f"{name} is on {t.device}, the others on {first.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{what} takes bfloat16; {name} is {t.dtype}")
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]):
            raise ValueError(f"{name} needs a unit last stride and the others multiples "
                             f"of 8, got strides {t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if first.shape[3] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{what} supports head_dim in {KERNEL_HEAD_DIMS}, "
                         f"got {first.shape[3]}")
    if blocks is not None and tuple(blocks) not in KERNEL_BLOCKS:
        raise ValueError(f"{what} supports (block_q, block_kv) in "
                         f"{KERNEL_BLOCKS}, got {tuple(blocks)}")
    if first.shape[0] * first.shape[2] > 65535:
        raise ValueError("batch * heads exceeds the grid's y limit (65535)")


@functools.lru_cache(maxsize=64)
def _device_table(spec, t_q, t_kv, bq, bk, kv_valid, device: str) -> torch.Tensor:
    sched = build_q_tile_schedule(spec, t_q, t_kv, bq, bk, kv_valid)
    return torch.from_numpy(sched.device_table()).to(device)


@functools.lru_cache(maxsize=1)
def _lib():
    lib = _build.load("flash_fwd")
    P, I, L = _build.VOIDP, _build.INT, _build.I64
    lib.fa2_fwd_bf16.argtypes = [P] * 6 + [L] * 12 + [I] * 13 + [P]
    lib.fa2_fwd_bf16.restype = ctypes.c_int
    return lib


def flash_fwd_plain(q, k, v, spec: MaskSpec, *, block_q: int, block_kv: int):
    """The kernel's algorithm in plain PyTorch (f32 math, any device).

    Same tiles, same visit order (the per-q-tile schedule), same mask value
    and the same bf16 rounding of P before P V, so it matches the kernel up
    to summation order and the JAX kernel up to the same."""
    flash_fwd_plain.calls += 1
    _check_layout(q, k, v)
    B, Sq, Hq, D = q.shape
    _, Skv, Hk, _ = k.shape
    G = Hq // Hk
    t_q, t_kv = _tiles(Sq, block_q), _tiles(Skv, block_kv)
    sched = build_q_tile_schedule(spec, t_q, t_kv, block_q, block_kv, Skv)
    # K/V rows past the end read as zeros and are masked, as in the kernel.
    pad = t_kv * block_kv - Skv
    kp = F.pad(k, (0, 0, 0, 0, 0, pad)).float()
    vp = F.pad(v, (0, 0, 0, 0, 0, pad))
    qh = q.reshape(B, Sq, Hk, G, D).float()
    o = torch.zeros((B, Sq, Hk, G, D), dtype=torch.float32, device=q.device)
    lse = torch.full((B, Hk, G, Sq), float("-inf"), device=q.device)
    for i in range(t_q):
        r0, r1 = i * block_q, min((i + 1) * block_q, Sq)
        qi = qh[:, r0:r1]
        rows = torch.arange(r0, r1, device=q.device) + spec.q_offset
        m = torch.full((B, Hk, G, r1 - r0), float("-inf"), device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, Hk, G, r1 - r0, D), device=q.device)
        for s in range(sched.row_ptr[i], sched.row_ptr[i + 1]):
            j = int(sched.inner[s])
            c0, c1 = j * block_kv, (j + 1) * block_kv
            sc = torch.einsum("bqhgd,bkhd->bhgqk", qi, kp[:, c0:c1])
            if sched.masked[s]:
                cols = torch.arange(c0, c1, device=q.device)
                vis = (cols < Skv)[None, :]
                tm = make_tile_mask(spec, rows, cols)
                vis = vis if tm is None else vis & tm
                sc = sc.masked_fill(~vis, DEFAULT_MASK_VALUE)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            alpha = torch.where(torch.isneginf(m), torch.zeros_like(m), torch.exp(m - m_new))
            p = torch.exp(sc - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(),
                              vp[:, c0:c1].float())
            acc = acc * alpha[..., None] + pv
            m = m_new
        l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
        o[:, r0:r1] = (acc / l_safe[..., None]).permute(0, 3, 1, 2, 4)
        lse[..., r0:r1] = torch.where(
            l == 0.0, torch.full_like(l, float("-inf")), m + torch.log(l_safe)
        )
    return o.reshape(B, Sq, Hq, D).to(q.dtype), lse.reshape(B, Hq, Sq)


flash_fwd_plain.calls = 0
