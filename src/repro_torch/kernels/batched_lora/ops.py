"""Wrapper of the batched multi-adapter ternary-LoRA kernel
(``csrc/batched_lora.cu``), the port of ``repro/kernels/batched_lora/ops.py``.

On a CUDA tensor :func:`batched_lora` launches the hand-written kernel (or
raises); on a CPU tensor it runs the plain version, ``ref.py``. ``launches``
counts the kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.batched_lora.ref import batched_lora_ref

launches = _build.LaunchCount()

_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel keeps z (r values) in shared memory sized for this rank
MAX_RANK = 64
_P, _I = ctypes.c_void_p, ctypes.c_int
#: x, x_bf16, a_codes, b_codes, scales, idx, out, rows, R, K, r, N, stream
_ARGTYPES = [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]


def _launch(x2: torch.Tensor, a_codes: torch.Tensor, b_codes: torch.Tensor,
            scales: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    rows, k = x2.shape
    n_adapters, _, r = a_codes.shape
    n = b_codes.shape[-1]
    if x2.dtype not in _X_DTYPES:
        raise TypeError(f"x must be f32 or bf16, got {x2.dtype}")
    if a_codes.dtype != torch.uint8 or b_codes.dtype != torch.uint8:
        raise TypeError("a_codes and b_codes must be uint8")
    if scales.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"scales must be f32 and idx int32, got {scales.dtype} "
                        f"and {idx.dtype}")
    for name, t in (("a_codes", a_codes), ("b_codes", b_codes),
                    ("scales", scales), ("idx", idx)):
        if t.device != x2.device:
            raise ValueError(f"{name} is on {t.device}, x on {x2.device}")
    x2, a_codes, b_codes, scales, idx = (t.contiguous() for t in (
        x2, a_codes, b_codes, scales, idx))
    out = torch.empty((rows, n), dtype=torch.float32, device=x2.device)
    if rows == 0 or n == 0:
        return out
    rc = _build.function("batched_lora", _ARGTYPES)(
        x2.data_ptr(), _X_DTYPES[x2.dtype], a_codes.data_ptr(),
        b_codes.data_ptr(), scales.data_ptr(), idx.data_ptr(), out.data_ptr(),
        rows, n_adapters, k, r, n,
        torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check(rc, "batched_lora")
    launches.n += 1
    return out


def batched_lora(x: torch.Tensor, a_codes: torch.Tensor,
                 b_codes: torch.Tensor, scales: torch.Tensor,
                 idx: torch.Tensor, *,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Per-row LoRA contribution
    ``y[b] = (x[b]·A[idx[b]])·B[idx[b]]·s[idx[b]]`` → ``(B, ..., N)`` in
    ``out_dtype``, summed in f32. x ``(B, K)`` or ``(B, S, K)``, f32 or bf16;
    a_codes ``(R, K/4, r)`` and b_codes ``(R, r/4, N)`` uint8 (interleaved
    2-bit codes); scales ``(R,)`` f32; idx ``(B,)`` int32 in ``[0, R)``,
    0 being the null adapter. On the card a 3-D x runs as ``B·S`` rows with
    each row's index repeated; an index outside ``[0, R)`` gives NaN rows."""
    *lead, k = x.shape
    n_adapters, kq, r = a_codes.shape
    rq, n = b_codes.shape[-2:]
    if x.dim() not in (2, 3):
        raise ValueError(f"x must be (B, K) or (B, S, K), got {tuple(x.shape)}")
    if kq * 4 != k or rq * 4 != r:
        raise ValueError(f"x has K={k}, a_codes (K/4, r)=({kq}, {r}), "
                         f"b_codes (r/4, N)=({rq}, {n})")
    if r > MAX_RANK:
        raise ValueError(f"rank {r} > {MAX_RANK}")
    if b_codes.shape[0] != n_adapters or scales.shape != (n_adapters,):
        raise ValueError(f"{n_adapters} A stacks, {b_codes.shape[0]} B stacks, "
                         f"scales {tuple(scales.shape)}")
    if idx.shape != (x.shape[0],):
        raise ValueError(f"idx {tuple(idx.shape)} does not index the rows of "
                         f"x {tuple(x.shape)}")
    if not x.is_cuda:
        return batched_lora_ref(x, a_codes, b_codes, scales, idx,
                                out_dtype=out_dtype)
    if x.dim() == 3 and x.shape[1] > 1:
        # (the decode tick's (B, 1, K) needs no repeat)
        idx = idx.repeat_interleave(x.shape[1])
    out = _launch(x.reshape(-1, k), a_codes, b_codes, scales, idx)
    return out.reshape(*lead, n).to(out_dtype)
