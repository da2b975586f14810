"""Wrappers of the two decode-attention kernels (the port of
``repro/kernels/flash_decode/ops.py``): ``decode_attention`` over a
contiguous cache (``flash_decode.py``) and ``paged_decode_attention`` over
the paged pool (``paged.py``).

On CUDA tensors each launches its kernel (or raises); on CPU tensors it runs
the plain version. Each kernel's module keeps its own ``launches`` count.
"""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.kernels.flash_decode.flash_decode import flash_decode
from repro_torch.kernels.flash_decode.paged import (paged_flash_decode,
                                                    paged_flash_decode_ref)
from repro_torch.kernels.flash_decode.ref import flash_decode_ref


def _group(q: torch.Tensor, hkv: int) -> torch.Tensor:
    """q (B, Hq, D) → (B, Hkv, G, D), G = Hq / Hkv query heads per KV head."""
    b, hq, d = q.shape
    if hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} KV heads")
    return q.reshape(b, hkv, hq // hkv, d)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: Union[int, torch.Tensor], kv_scale: float = 1.0,
                     *, out_dtype: torch.dtype = torch.float32
                     ) -> torch.Tensor:
    """Single-token GQA decode attention over a contiguous KV cache.
    q ``(B, Hq, D)``; k, v ``(B, Hkv, S, D)``; ``length`` an int or 0-d
    tensor for the whole batch, or ``(B,)`` per row. Returns ``(B, Hq, D)``.
    Unlike the reference's wrapper it pads nothing: the kernel reads no
    position past a row's length."""
    qg = _group(q, k.shape[1])
    if q.is_cuda:
        lengths = torch.as_tensor(length, device=q.device).to(torch.int32)
        out = flash_decode(qg, k, v, lengths.reshape(-1).expand(q.shape[0])
                           .contiguous(), kv_scale)
    else:
        out = flash_decode_ref(qg, k, v, length, kv_scale)
    return out.reshape(q.shape).to(out_dtype)


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, tables: torch.Tensor,
                           lengths: torch.Tensor, kv_scale: float = 1.0, *,
                           out_dtype: torch.dtype = torch.float32
                           ) -> torch.Tensor:
    """Single-token GQA decode attention straight off the paged KV pool.
    q ``(B, Hq, D)``; pools ``(n_pages + 1, Hkv, page, D)``; tables
    ``(B, n_p)`` int32 (padding → scratch page); lengths ``(B,)`` int32.
    Returns ``(B, Hq, D)``."""
    qg = _group(q, k_pool.shape[1])
    fn = paged_flash_decode if q.is_cuda else paged_flash_decode_ref
    out = fn(qg, k_pool, v_pool, tables, lengths, kv_scale)
    return out.reshape(q.shape).to(out_dtype)
