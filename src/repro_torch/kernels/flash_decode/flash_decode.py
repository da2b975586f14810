"""Launcher of the flash-decode CUDA kernel (the port of
``repro/kernels/flash_decode/flash_decode.py``): one-token GQA attention
over a contiguous ``(B, Hkv, S, D)`` KV cache, each row masked at its own
live length. Its plain version is ``ref.flash_decode_ref``. ``launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_decode._checks import operand_codes

launches = _build.LaunchCount()

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: q, q_dtype, k, v, kv_dtype, lengths, out, B, Hkv, G, S, D, scale,
#: kv_scale, stream
_ARGTYPES = [_P, _I, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P]


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor, kv_scale: float = 1.0, *,
                 scale: Optional[float] = None) -> torch.Tensor:
    """Launch ``csrc/flash_decode.cu``: q ``(B, Hkv, G, D)`` f32 or bf16,
    contiguous (the kernel reads it as given); k, v ``(B, Hkv, S, D)`` fp8
    e4m3, bf16 or f32; lengths ``(B,)`` int32 (clamped to S; ``<= 0`` gives
    a zero row). Returns f32 ``(B, Hkv, G, D)``."""
    b, hkv, g, d = q.shape
    q_code, kv_code = operand_codes("flash_decode", q, k, v, lengths=lengths)
    if k.dim() != 4 or tuple(k.shape[:2]) != (b, hkv) or k.shape[3] != d \
            or v.shape != k.shape:
        raise ValueError(f"cache shape {tuple(k.shape)} / {tuple(v.shape)} "
                         f"does not fit q {tuple(q.shape)}")
    if lengths.dtype != torch.int32 or lengths.shape != (b,):
        raise TypeError(f"lengths must be int32 of shape ({b},)")
    out = torch.empty((b, hkv, g, d), dtype=torch.float32, device=q.device)
    if b == 0:
        return out
    rc = _build.function("flash_decode", _ARGTYPES)(
        q.data_ptr(), q_code, k.data_ptr(), v.data_ptr(), kv_code,
        lengths.data_ptr(), out.data_ptr(), b, hkv, g,
        k.shape[2], d, float(scale if scale is not None else d ** -0.5),
        float(kv_scale), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_decode")
    launches.n += 1
    return out
