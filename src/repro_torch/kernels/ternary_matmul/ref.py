"""Plain PyTorch version of the packed-ternary matmul kernel (the port of
``repro/kernels/ternary_matmul/ref.py``): decode the 2-bit codes to a dense
ternary matrix and run one f32 matmul. It repeats the kernel's arithmetic —
ternary values are exact in every float type and both sum in f32 — so the
two differ only by summation order. On the card it runs with
``torch.backends.cuda.matmul.allow_tf32 = False`` (the callers set it), or
the f32 matmul would round its inputs to TF32."""
from __future__ import annotations

import torch

from repro_torch.core import ternary


def ternary_matmul_ref(x: torch.Tensor, packed: torch.Tensor,
                       scale: torch.Tensor, *, layout: str = "interleaved",
                       tile: int = 512,
                       out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``x (..., K) @ unpack(packed) (K, N) * scale`` in f32, cast to
    ``out_dtype``."""
    w = ternary.unpack2(packed, layout=layout, tile=tile).float()
    return ((x.float() @ w) * scale).to(out_dtype)
