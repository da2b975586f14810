"""Ternary quantisation core (paper C1), ported from ``repro/core/ternary.py``.

BitNet-style absmean ternary quantisation, the paper's 2-bit encoding
(``+1='01'``, ``-1='10'``, ``0='00'`` — '10' rather than '11' for −1 keeps
more zero *bits*, §III-C), and dense 2-bit packing (4 weights/byte) along the
contracting K axis in two layouts:

- ``interleaved``: byte ``k`` of a column packs rows ``4k..4k+3``
  (bits 0-1 = row 4k).
- ``strided``: within each K-tile of ``tile`` rows, byte ``j`` packs rows
  ``j, j+t/4, j+t/2, j+3t/4`` of the tile.

Both are bit-identical to the reference's (``tests/test_torch_ternary.py``).
"""
from __future__ import annotations

from typing import Tuple

import torch

EPS = 1e-8


def absmean_scale(w: torch.Tensor) -> torch.Tensor:
    """BitNet b1.58 per-tensor scale: mean of |w| (f32 scalar)."""
    return w.float().abs().mean()


def quantize(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """absmean ternary quantisation: ``(t int8 in {-1,0,1}, scale f32)``
    with ``w ≈ t*scale``."""
    s = absmean_scale(w)
    t = torch.clamp(torch.round(w.float() / (s + EPS)), -1, 1).to(torch.int8)
    return t, s


def dequantize(t: torch.Tensor, scale: torch.Tensor,
               dtype=torch.bfloat16) -> torch.Tensor:
    return (t.float() * scale).to(dtype)


def encode2(t: torch.Tensor) -> torch.Tensor:
    """Ternary {-1,0,+1} → 2-bit code {2,0,1} (uint8)."""
    t = t.to(torch.int8)
    return torch.where(t == 1, 1, torch.where(t == -1, 2, 0)).to(torch.uint8)


def decode2(c: torch.Tensor) -> torch.Tensor:
    """2-bit code → ternary int8: the paper's conditional-negation decode
    (``'11'`` decodes to 0, as in the reference)."""
    c = c.to(torch.int8)
    return ((c & 1) - ((c >> 1) & 1)).to(torch.int8)


def pack2(t: torch.Tensor, layout: str = "interleaved",
          tile: int = 512) -> torch.Tensor:
    """Pack ternary int8 ``(..., K, N)`` → uint8 ``(..., K//4, N)``."""
    k, n = t.shape[-2], t.shape[-1]
    lead = t.shape[:-2]
    if k % 4:
        raise ValueError(f"K={k} not divisible by 4")
    c = encode2(t)
    if layout == "interleaved":
        g = c.reshape(*lead, k // 4, 4, n)
        return (g[..., 0, :] | (g[..., 1, :] << 2) | (g[..., 2, :] << 4)
                | (g[..., 3, :] << 6))
    if layout == "strided":
        if k % tile:
            raise ValueError(f"K={k} not divisible by tile={tile}")
        q = tile // 4
        g = c.reshape(*lead, k // tile, 4, q, n)
        packed = (g[..., 0, :, :] | (g[..., 1, :, :] << 2)
                  | (g[..., 2, :, :] << 4) | (g[..., 3, :, :] << 6))
        return packed.reshape(*lead, k // 4, n)
    raise ValueError(f"unknown layout {layout!r}")


def unpack2(p: torch.Tensor, layout: str = "interleaved",
            tile: int = 512) -> torch.Tensor:
    """Inverse of :func:`pack2`: uint8 ``(..., K//4, N)`` → int8 ``(..., K, N)``."""
    kq, n = p.shape[-2], p.shape[-1]
    lead = p.shape[:-2]
    slots = [decode2((p >> (2 * i)) & 3) for i in range(4)]
    if layout == "interleaved":
        return torch.stack(slots, dim=-2).reshape(*lead, kq * 4, n)
    if layout == "strided":
        q = tile // 4
        if kq % q:
            raise ValueError(f"packed K={kq} not divisible by tile//4={q}")
        st = torch.cat([s.reshape(*lead, kq // q, q, n) for s in slots],
                       dim=-2)                       # (..., n_tiles, tile, N)
        return st.reshape(*lead, kq * 4, n)
    raise ValueError(f"unknown layout {layout!r}")


class TernaryTensor:
    """A ternary weight in its packed 'ROM' form: ``packed`` uint8
    ``(K//4, N)``, ``scale`` f32 scalar, logical shape ``(k, N)``."""

    __slots__ = ("packed", "scale", "k", "layout", "tile")

    def __init__(self, packed: torch.Tensor, scale: torch.Tensor, k: int,
                 layout: str = "interleaved", tile: int = 512):
        self.packed = packed
        self.scale = scale
        self.k = int(k)
        self.layout = layout
        self.tile = int(tile)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.k, self.packed.shape[-1])

    @classmethod
    def from_dense(cls, w: torch.Tensor, layout: str = "interleaved",
                   tile: int = 512) -> "TernaryTensor":
        t, s = quantize(w)
        return cls(pack2(t, layout=layout, tile=tile), s, w.shape[-2],
                   layout, tile)

    def to_dense(self, dtype=torch.bfloat16) -> torch.Tensor:
        t = unpack2(self.packed, layout=self.layout, tile=self.tile)
        return dequantize(t, self.scale, dtype=dtype)

    def __repr__(self):
        return f"TernaryTensor(shape={self.shape}, layout={self.layout!r})"
