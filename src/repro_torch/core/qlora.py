"""Ternary QLoRA adapters in their deployed form (paper C4, §IV-D.3), the
serve part of ``repro/core/qlora.py``.

TOM's hybrid ROM-SRAM split: the ternary base weight is immutable ROM, and
small LoRA adapters live in SRAM, themselves ternary, so the adapter path
reuses the base path's ternary compute. A trained float master pair
``A (K, r)``, ``B (r, N)`` is frozen to packed 2-bit codes with one absmean
scale each (:func:`freeze_adapter`); serving then adds
``B·(A·x)·(α/r)`` to the base output.

The training side (``init_adapter``, ``adapter_path``, ``two_path_linear``)
waits for the port's training slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from repro_torch.core import ternary


@dataclass(frozen=True)
class LoRASpec:
    """Adapter rank and alpha; served adapters are always ternary (the
    reference's ``ternary`` switch selects its float training path)."""
    rank: int = 16
    alpha: float = 32.0

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank


def freeze_adapter(adapter: Dict[str, torch.Tensor]
                   ) -> Dict[str, ternary.TernaryTensor]:
    """Pack float master adapters ``{"a": (K, r), "b": (r, N)}`` to 2-bit
    ternary for deployment; the contracting axis is zero-padded to a
    multiple of 4 first (padding rows quantise to code 0)."""
    out = {}
    for name, w in adapter.items():
        w = torch.as_tensor(w, dtype=torch.float32)
        pad = (-w.shape[0]) % 4
        if pad:
            w = torch.nn.functional.pad(w, (0, 0, 0, pad))
        out[name] = ternary.TernaryTensor.from_dense(w)
    return out


def nbytes_packed(k: int, n: int) -> int:
    """Bytes of a packed (K, N) ternary tensor: codes plus its f32 scale."""
    return (k // 4) * n + 4


def adapter_bytes(k: int, n: int, spec: LoRASpec) -> int:
    """SRAM footprint of one frozen adapter pair (A and B, codes and
    scales)."""
    return (nbytes_packed(-(-k // 4) * 4, spec.rank)
            + nbytes_packed(-(-spec.rank // 4) * 4, n))
