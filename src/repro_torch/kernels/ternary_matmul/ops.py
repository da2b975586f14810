"""Wrapper of the packed-ternary matmul kernel (``csrc/ternary_matmul.cu``),
the port of ``repro/kernels/ternary_matmul/ops.py``.

On a CUDA tensor :func:`ternary_matmul` launches the hand-written kernel (or
raises); on a CPU tensor it runs the plain version, ``ref.py``. ``launches``
counts the kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.ternary import TernaryTensor
from repro_torch.kernels import _build
from repro_torch.kernels.ternary_matmul.ref import ternary_matmul_ref

launches = _build.LaunchCount()

#: K rows of x staged in shared memory per chunk (the kernel's ``kc``)
_CHUNK = 1024
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
#: x, x_bf16, packed, scale, out, out_bf16, M, K, N, strided, tile, kc, stream
_ARGTYPES = [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]


def _launch(x2: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
            layout: str, tile: int, out_dtype: torch.dtype) -> torch.Tensor:
    m, k = x2.shape
    n = packed.shape[1]
    strided = layout == "strided"
    if strided and (tile % 4 or k % tile or tile > 2 * _CHUNK):
        raise ValueError(f"strided layout needs tile % 4 == 0, K % tile == 0 "
                         f"and tile <= {2 * _CHUNK} (K={k}, tile={tile})")
    kc = min(k, tile * max(1, _CHUNK // tile) if strided else _CHUNK)
    for name, t in (("packed", packed), ("scale", scale)):
        if t.device != x2.device:
            raise ValueError(f"{name} is on {t.device}, x on {x2.device}")
    if packed.dtype != torch.uint8:
        raise TypeError(f"packed must be uint8, got {packed.dtype}")
    if x2.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise TypeError(f"x and out must be f32 or bf16, got {x2.dtype} "
                        f"→ {out_dtype}")
    x2 = x2.contiguous()
    packed = packed.contiguous()
    scale = scale.to(torch.float32).reshape(1).contiguous()
    out = torch.empty((m, n), dtype=out_dtype, device=x2.device)
    if m == 0 or n == 0:
        return out
    rc = _build.function("ternary_matmul", _ARGTYPES)(
        x2.data_ptr(), _DTYPES[x2.dtype], packed.data_ptr(), scale.data_ptr(),
        out.data_ptr(), _DTYPES[out_dtype], m, k, n, int(strided), tile, kc,
        torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check(rc, "ternary_matmul")
    launches.n += 1
    return out


def ternary_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                   *, layout: str = "interleaved", tile: int = 512,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``x (..., K) @ unpack(packed) (K, N) * scale`` → ``(..., N)`` in
    ``out_dtype``, accumulated in f32. ``packed`` is uint8 ``(K/4, N)`` in
    the ``interleaved`` or ``strided`` (pack tile ``tile``) layout; ``scale``
    an f32 scalar tensor."""
    *lead, k = x.shape
    kq, n = packed.shape
    if layout not in ("interleaved", "strided"):
        raise ValueError(f"unknown layout {layout!r}")
    if kq * 4 != k:
        raise ValueError(f"x has K={k}, packed has K/4={kq}")
    if not x.is_cuda:
        return ternary_matmul_ref(x, packed, scale, layout=layout, tile=tile,
                                  out_dtype=out_dtype)
    out = _launch(x.reshape(-1, k), packed, scale, layout, tile, out_dtype)
    return out.reshape(*lead, n)


def linear(x: torch.Tensor, w: TernaryTensor, *,
           out_dtype: torch.dtype = None) -> torch.Tensor:
    """Model-layer entry point: activation × TernaryTensor."""
    return ternary_matmul(x, w.packed, w.scale, layout=w.layout, tile=w.tile,
                          out_dtype=out_dtype or x.dtype)
