"""Plain PyTorch version of the batched multi-adapter ternary-LoRA matmul
(the port of ``repro/kernels/batched_lora/ref.py``, the SGMV oracle).

Frozen adapters are stacked along a leading adapter axis; every batch row
selects its adapter by index::

    z[b] = x[b] @ unpack(a_codes[idx[b]])               # (…, K) → (…, r)
    y[b] = z[b] @ unpack(b_codes[idx[b]]) * s[idx[b]]   # (…, r) → (…, N)

``s`` is the per-adapter combined scale ``scale_a · scale_b · α/r``; index 0
is the null adapter (all-zero codes, zero scale), so rows without an adapter
contribute exactly 0. Gather, unpack and two f32 einsums, as the reference;
the CUDA kernel differs from it only in summation order. On the card it runs
with ``torch.backends.cuda.matmul.allow_tf32 = False`` (the callers set it).
"""
from __future__ import annotations

import torch

from repro_torch.core import ternary


def batched_lora_ref(x: torch.Tensor, a_codes: torch.Tensor,
                     b_codes: torch.Tensor, scales: torch.Tensor,
                     idx: torch.Tensor,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x ``(B, ..., K)``; a_codes ``(R, K/4, r)`` and b_codes ``(R, r/4, N)``
    uint8; scales ``(R,)`` f32; idx ``(B,)`` int. Returns ``(B, ..., N)``."""
    idx = idx.long()
    a = ternary.unpack2(a_codes[idx]).float()            # (B, K, r)
    b = ternary.unpack2(b_codes[idx]).float()            # (B, r, N)
    z = torch.einsum("b...k,bkr->b...r", x.float(), a)
    y = torch.einsum("b...r,brn->b...n", z, b)
    s = scales.float()[idx].reshape(idx.shape[0], *([1] * (x.dim() - 1)))
    return (y * s).to(out_dtype)
