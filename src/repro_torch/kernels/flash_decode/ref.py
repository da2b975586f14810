"""Plain PyTorch version of the flash-decode kernel (the port of
``repro/kernels/flash_decode/ref.py``)."""
from __future__ import annotations

from typing import Optional, Union

import torch


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: Union[int, torch.Tensor], kv_scale: float = 1.0, *,
                     scale: Optional[float] = None,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Materialised-softmax GQA decode attention with length masking.

    q ``(B, Hkv, G, D)``; k, v ``(B, Hkv, S, D)`` (fp8 e4m3, bf16 or f32,
    widened to f32 and times ``kv_scale``); ``length`` the live context
    length, an int or 0-d tensor for the whole batch (the reference's
    contract) or a ``(B,)`` tensor per row. Positions ``>= length`` are
    masked; the softmax is the max-subtract form of the reference's dense
    decode (``_stable_softmax_attend``: normalised after the value sum), and
    a masked value is never multiplied. A row with length 0 is 0 (the
    reference averages its masked cache there). Returns ``(B, Hkv, G, D)``."""
    b, _, _, d = q.shape
    s_len = k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    length = torch.as_tensor(length, device=q.device).long().reshape(-1)
    mask = (torch.arange(s_len, device=q.device)[None, :]
            < length.expand(b)[:, None])                        # (B, S)
    kf = k.float() * kv_scale
    vf = torch.where(mask[:, None, :, None], v.float() * kv_scale, 0.0)
    s = torch.einsum("bhgd,bhsd->bhgs", q.float(), kf) * scale
    s = torch.where(mask[:, None, None, :], s, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)     # a length-0 row: all -inf
    p = torch.exp(s - m)                           # masked → exactly 0
    den = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgs,bhsd->bhgd", p, vf) / den.clamp_min(1e-30)
    return out.to(out_dtype)
