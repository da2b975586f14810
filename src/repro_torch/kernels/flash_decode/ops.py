"""Wrapper of the paged flash-decode kernel (the port of
``repro/kernels/flash_decode/ops.py``'s ``paged_decode_attention``).

On CUDA tensors it launches ``csrc/paged_flash_decode.cu`` (or raises); on
CPU tensors it runs the plain version. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_decode.paged import (launches,  # noqa: F401
                                                    paged_flash_decode,
                                                    paged_flash_decode_ref)


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, tables: torch.Tensor,
                           lengths: torch.Tensor, kv_scale: float = 1.0, *,
                           out_dtype: torch.dtype = torch.float32
                           ) -> torch.Tensor:
    """Single-token GQA decode attention straight off the paged KV pool.
    q ``(B, Hq, D)``; pools ``(n_pages + 1, Hkv, page, D)``; tables
    ``(B, n_p)`` int32 (padding → scratch page); lengths ``(B,)`` int32.
    Returns ``(B, Hq, D)``."""
    b, hq, d = q.shape
    hkv = k_pool.shape[1]
    if hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} KV heads")
    qg = q.reshape(b, hkv, hq // hkv, d)
    fn = paged_flash_decode if q.is_cuda else paged_flash_decode_ref
    out = fn(qg, k_pool, v_pool, tables, lengths, kv_scale)
    return out.reshape(b, hq, d).to(out_dtype)
