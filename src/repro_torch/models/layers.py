"""Shared model layers in serve mode (the port of ``repro/models/layers.py``):
norms, RoPE, the packed-ternary linear, FFNs, the packed-row embedding and
the tied logits.

Parameters are plain dicts of tensors with the reference's names
(``packed``/``scale`` per linear, ``packed_rows``/``scale`` for the
embedding, ``w`` per norm). Every linear, and the tied logits, goes through
the ternary-matmul kernel on the card (``kernels/ternary_matmul``), and a
projection that carries a multi-tenant adapter stack (``lora_mt``) adds the
batched-LoRA kernel's output (``kernels/batched_lora``); with ``plain=True``
the same calls run the kernels' plain versions instead, which is also what a
CPU tensor gets.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core import ternary
from repro_torch.kernels.batched_lora import ops as blora_ops
from repro_torch.kernels.batched_lora.ref import batched_lora_ref
from repro_torch.kernels.ternary_matmul import ops as tm_ops
from repro_torch.kernels.ternary_matmul.ref import ternary_matmul_ref

Params = Dict[str, torch.Tensor]

#: Static fp8 KV-cache scale (e4m3 is floating — the scale only guards
#: overflow past ±448; post-norm K/V magnitudes are O(1..30)).
KV_CACHE_SCALE = 4.0
#: Largest finite float8 e4m3fn value; the KV write saturates here.
FP8_MAX = 448.0


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float,
               device: torch.device = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D) with positions broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    angles = positions[..., None].float() * freqs       # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]               # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_linear(p: Params, x: torch.Tensor, *, plain: bool = False,
                 adapter_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Serve-mode linear: ``x @ unpack2(p["packed"]) * p["scale"]``,
    accumulated in f32 and cast to x's type, then, where ``p`` carries a
    ``lora_mt`` stack and ``adapter_idx`` (B,) is given, plus each row's
    multi-tenant LoRA term cast to that type (``layers.py:127-171`` of the
    reference, in its rounding order). The reference decodes the base weight
    with XLA ops; here the kernel reads the 2-bit codes."""
    fn = ternary_matmul_ref if plain else tm_ops.ternary_matmul
    y = fn(x, p["packed"], p["scale"], out_dtype=x.dtype)
    if adapter_idx is not None and "lora_mt" in p:
        y = y + _multi_tenant_lora(p["lora_mt"], x, adapter_idx,
                                   plain=plain).to(y.dtype)
    return y


def _multi_tenant_lora(mt: Params, x: torch.Tensor, adapter_idx: torch.Tensor,
                       *, plain: bool = False) -> torch.Tensor:
    """Per-row gathered ternary-LoRA term (f32) from one layer's adapter
    stacks ``a (R+1, K/4, r)``, ``b (R+1, r/4, N)``, ``s (R+1,)``. Rows whose
    index is 0 hit the null adapter and contribute exactly 0."""
    fn = batched_lora_ref if plain else blora_ops.batched_lora
    return fn(x, mt["a"], mt["b"], mt["s"], adapter_idx)


ACTIVATIONS = {
    "gelu": torch.nn.functional.gelu,
    "silu": torch.nn.functional.silu,
    "relu2": lambda x: torch.square(torch.relu(x)),
}


def apply_ffn(p: Params, x: torch.Tensor, kind: str, *,
              plain: bool = False,
              adapter_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    kw = dict(plain=plain, adapter_idx=adapter_idx)
    up = apply_linear(p["up"], x, **kw)
    if kind == "swiglu":
        gate = apply_linear(p["gate"], x, **kw)
        h = torch.nn.functional.silu(gate.float()).to(up.dtype) * up
    else:
        h = ACTIVATIONS[kind if kind in ACTIVATIONS else "gelu"](up)
    return apply_linear(p["down"], h, **kw)


def pack_rows(t: torch.Tensor) -> torch.Tensor:
    """Ternary (V, D) → uint8 (V, D/4): each row packs its own features
    (byte j holds features 4j..4j+3, bits 0-1 = feature 4j), so a token
    gather returns packed rows that unpack locally."""
    v, d = t.shape
    if d % 4:
        raise ValueError(f"D={d} not divisible by 4")
    c = ternary.encode2(t.reshape(v, d // 4, 4).transpose(-1, -2))
    return c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6)


def unpack_rows(p: torch.Tensor) -> torch.Tensor:
    """uint8 (..., D/4) → int8 (..., D)."""
    slots = [ternary.decode2((p >> (2 * i)) & 3) for i in range(4)]
    return torch.stack(slots, dim=-1).reshape(*p.shape[:-1], p.shape[-1] * 4)


def logits_weight(packed_rows: torch.Tensor) -> torch.Tensor:
    """The tied head's weight for the ternary-matmul kernel: ``packed_rows``
    (V, D/4) transposed to (D/4, V) is, byte for byte, the interleaved
    :func:`ternary.pack2` of the ternary table's transpose. One copy, made
    once at load."""
    return packed_rows.t().contiguous()


def embed_tokens(p: Params, tokens: torch.Tensor,
                 dtype=torch.bfloat16) -> torch.Tensor:
    rows = p["packed_rows"][tokens.long()]           # (..., D/4) uint8 gather
    return (unpack_rows(rows).float() * p["scale"]).to(dtype)


def tied_logits(embed_p: Params, x: torch.Tensor, *,
                plain: bool = False) -> torch.Tensor:
    """f32 logits ``x · unpack_rows(packed_rows)ᵀ · scale`` through the
    ternary-matmul kernel on the transposed copy ``embed_p["packed_t"]``.
    The reference computes ``x · (t·scale)``; this is ``(x·t)·scale``, the
    same up to f32 rounding."""
    fn = ternary_matmul_ref if plain else tm_ops.ternary_matmul
    return fn(x.float(), embed_p["packed_t"], embed_p["scale"],
              out_dtype=torch.float32)
