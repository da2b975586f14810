"""Paged flash-decode: the CUDA kernel's launcher and its plain PyTorch
version (the port of ``repro/kernels/flash_decode/paged.py``).

Each sequence owns a block table of page ids into a shared KV pool
``(n_pages + 1, Hkv, page, D)`` whose last page is the scratch page that
inactive slots and table padding point at. Positions ``>= lengths[b]`` are
masked. Both versions here define the output of a sequence with
``lengths[b] == 0`` as 0 — the reference's kernel returns a uniform average
of scratch values there, which the engine discards — and neither ever
multiplies a masked value, so a NaN on the scratch page stays out of live
rows.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_decode._checks import operand_codes

launches = _build.LaunchCount()

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: q, q_dtype, k_pool, v_pool, kv_dtype, tables, lengths, out, B, Hkv, G, D,
#: page, n_p, scale, kv_scale, stream
_ARGTYPES = [_P, _I, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _P]


def paged_flash_decode(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, tables: torch.Tensor,
                       lengths: torch.Tensor, kv_scale: float = 1.0, *,
                       scale: Optional[float] = None) -> torch.Tensor:
    """Launch ``csrc/paged_flash_decode.cu``: q ``(B, Hkv, G, D)`` f32 or
    bf16, contiguous (the kernel reads it as given); pools
    ``(n_pages + 1, Hkv, page, D)`` fp8 e4m3, bf16 or f32; tables ``(B, n_p)``
    int32; lengths ``(B,)`` int32. Returns f32 ``(B, Hkv, G, D)``."""
    b, hkv, g, d = q.shape
    _, hkv_pool, page, d_pool = k_pool.shape
    n_p = tables.shape[1]
    q_code, kv_code = operand_codes("paged_flash_decode", q, k_pool, v_pool,
                                    tables=tables, lengths=lengths)
    if (hkv_pool, d_pool) != (hkv, d) or v_pool.shape != k_pool.shape:
        raise ValueError(f"pool shape {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} does not fit q {tuple(q.shape)}")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("tables and lengths must be int32")
    out = torch.empty((b, hkv, g, d), dtype=torch.float32, device=q.device)
    if b == 0:
        return out
    rc = _build.function("paged_flash_decode", _ARGTYPES)(
        q.data_ptr(), q_code, k_pool.data_ptr(), v_pool.data_ptr(), kv_code,
        tables.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), b, hkv, g, d, page, n_p,
        float(scale if scale is not None else d ** -0.5), float(kv_scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "paged_flash_decode")
    launches.n += 1
    return out


def paged_flash_decode_ref(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, tables: torch.Tensor,
                           lengths: torch.Tensor, kv_scale: float = 1.0, *,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Plain version: gather each sequence's pages into a contiguous view,
    then a masked softmax in f32. Same shapes and output as the kernel."""
    b, hkv, g, d = q.shape
    page = k_pool.shape[2]
    n_p = tables.shape[1]
    scale = scale if scale is not None else d ** -0.5
    idx = tables.long()

    def view(pool):            # (B, P, H, page, D) → (B, H, P*page, D)
        return (pool[idx].float() * kv_scale).permute(0, 2, 1, 3, 4).reshape(
            b, hkv, n_p * page, d)

    mask = (torch.arange(n_p * page, device=q.device)[None, :]
            < lengths.long()[:, None])                          # (B, S)
    kf = view(k_pool)
    vf = torch.where(mask[:, None, :, None], view(v_pool), 0.0)
    s = torch.einsum("bhgd,bhsd->bhgs", q.float(), kf) * scale
    s = torch.where(mask[:, None, None, :], s, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)     # a length-0 row: all -inf
    p = torch.exp(s - m)                           # masked → exactly 0
    den = p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhgs,bhsd->bhgd", p, vf) / den.clamp_min(1e-30)
