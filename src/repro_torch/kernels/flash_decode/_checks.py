"""Operand checks shared by the two decode-attention launchers
(``flash_decode.py`` and ``paged.py``)."""
from __future__ import annotations

from typing import Tuple

import torch

_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}


def operand_codes(kernel: str, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, **others: torch.Tensor) -> Tuple[int, int]:
    """The checks both decode-attention launchers share: q ``(B, Hkv, G,
    D)`` on a CUDA device, D % 32 == 0, D <= 1024 and G <= 8; q f32 or bf16;
    k and v of one type in fp8 e4m3, bf16 or f32, starting on a 16-byte
    boundary (the kernels read key rows in 16-byte loads); every operand on
    q's device and contiguous. Raises on a breach, else returns the C
    entry's (q_dtype, kv_dtype) codes."""
    g, d = q.shape[2:]
    if not q.is_cuda:
        raise ValueError(f"{kernel} launches a CUDA kernel: q must be on a "
                         f"CUDA device")
    if d % 32 or d > 1024 or g > 8:
        raise ValueError(f"kernel takes head_dim % 32 == 0, head_dim <= 1024 "
                         f"and at most 8 query heads per KV head (D={d}, G={g})")
    if q.dtype not in _Q_DTYPES:
        raise TypeError(f"q must be one of {list(_Q_DTYPES)}, not {q.dtype}")
    if k.dtype not in _KV_DTYPES or v.dtype != k.dtype:
        raise TypeError(f"k and v must share a type in {list(_KV_DTYPES)}")
    for name, t in (("q", q), ("k", k), ("v", v), *others.items()):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("k and v must start on a 16-byte boundary (the "
                         "kernel reads key rows in 16-byte loads)")
    return _Q_DTYPES[q.dtype], _KV_DTYPES[k.dtype]
