"""Adapter registry: versioned frozen ternary QLoRA adapters per tenant (the
port of ``repro/serving/adapters/registry.py``).

TOM's hybrid ROM-SRAM split amortises one immutable ternary base (ROM) over
many tenants, each owning a small adapter in SRAM. ``register`` takes a
tenant's float master A/B stacks (one (K, r)/(r, N) pair per layer per
target projection), freezes them to 2-bit ternary through
:func:`qlora.freeze_adapter` and files them under ``adapter_id`` with a
growing version (re-registering an id is a fine-tune update; old versions
stay addressable for rollback). Packs are host-side numpy arrays; the
runtime (``runtime.py``) uploads them into the device stacks.

Byte accounting uses :func:`qlora.adapter_bytes`, which equals the packed
sizes (codes plus one f32 scale per tensor); the cache evicts against it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import qlora

#: projection name → parameter group inside a layer
TARGET_GROUP = {"q": "attn", "k": "attn", "v": "attn", "o": "attn",
                "up": "ffn", "gate": "ffn", "down": "ffn"}


@dataclasses.dataclass(frozen=True)
class AdapterSpec:
    """Shape contract shared by every adapter one runtime serves (the device
    stacks are homogeneous, like TOM's fixed SRAM adapter slots)."""
    rank: int = 16
    alpha: float = 32.0
    targets: Tuple[str, ...] = ("q", "v")

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank

    @property
    def lora_spec(self) -> qlora.LoRASpec:
        return qlora.LoRASpec(rank=self.rank, alpha=self.alpha)


def target_dims(cfg, target: str) -> Tuple[int, int]:
    """(K, N) of projection ``target`` in one layer of ``cfg``."""
    dims = {
        "q": (cfg.d_model, cfg.q_dim),
        "k": (cfg.d_model, cfg.kv_dim),
        "v": (cfg.d_model, cfg.kv_dim),
        "o": (cfg.q_dim, cfg.d_model),
        "up": (cfg.d_model, cfg.d_ff),
        "gate": (cfg.d_model, cfg.d_ff),
        "down": (cfg.d_ff, cfg.d_model),
    }
    if target not in dims:
        raise KeyError(f"unknown adapter target {target!r}")
    return dims[target]


@dataclasses.dataclass
class FrozenAdapter:
    """One tenant fine-tune in its deployable (packed 2-bit) form."""
    adapter_id: str
    version: int
    spec: AdapterSpec
    # target → {a_codes (L,K//4,r) u8, a_scale (L,) f32, b_codes (L,r//4,N), b_scale (L,)}
    packs: Dict[str, Dict[str, np.ndarray]]
    nbytes: int
    n_layers: int


class AdapterRegistry:
    """Register / version / look up frozen adapters by ``adapter_id``."""

    def __init__(self, spec: AdapterSpec):
        if spec.rank % 4:
            raise ValueError(f"rank {spec.rank} must be divisible by 4 "
                             "(2-bit packing along the contracting axis)")
        for t in spec.targets:
            if t not in TARGET_GROUP:
                raise KeyError(f"unknown adapter target {t!r}")
        self.spec = spec
        self._versions: Dict[str, List[FrozenAdapter]] = {}

    # -- write side -----------------------------------------------------------
    def register(self, adapter_id: str, stacks) -> FrozenAdapter:
        """Freeze float master stacks ``{target: {"a": (L, K, r), "b":
        (L, r, N)}}`` (numpy arrays or tensors) to packed ternary and file
        them as the next version."""
        if set(stacks) != set(self.spec.targets):
            raise ValueError(f"stacks targets {sorted(stacks)} != spec "
                             f"targets {sorted(self.spec.targets)}")
        packs: Dict[str, Dict[str, np.ndarray]] = {}
        nbytes = 0
        n_layers = None
        for target, ab in stacks.items():
            a = torch.as_tensor(np.asarray(ab["a"], np.float32))
            b = torch.as_tensor(np.asarray(ab["b"], np.float32))
            l, k, r = a.shape
            if r != self.spec.rank or b.shape[1] != self.spec.rank:
                raise ValueError(f"{adapter_id}/{target}: rank {r} != spec "
                                 f"rank {self.spec.rank}")
            if k % 4:
                raise ValueError(f"{adapter_id}/{target}: K={k} not "
                                 "divisible by 4")
            if n_layers is None:
                n_layers = l
            elif l != n_layers:
                raise ValueError(f"{adapter_id}: inconsistent layer counts")
            frozen = [qlora.freeze_adapter({"a": a[li], "b": b[li]})
                      for li in range(l)]
            packs[target] = {
                "a_codes": np.stack([f["a"].packed.numpy() for f in frozen]),
                "a_scale": np.asarray([f["a"].scale.item() for f in frozen],
                                      np.float32),
                "b_codes": np.stack([f["b"].packed.numpy() for f in frozen]),
                "b_scale": np.asarray([f["b"].scale.item() for f in frozen],
                                      np.float32),
            }
            nbytes += l * qlora.adapter_bytes(k, b.shape[2],
                                              self.spec.lora_spec)
        versions = self._versions.setdefault(adapter_id, [])
        entry = FrozenAdapter(adapter_id, len(versions) + 1, self.spec, packs,
                              nbytes, n_layers or 0)
        versions.append(entry)
        return entry

    # -- read side ------------------------------------------------------------
    def __contains__(self, adapter_id: str) -> bool:
        return adapter_id in self._versions

    def __len__(self) -> int:
        return len(self._versions)

    def get(self, adapter_id: str, version: Optional[int] = None
            ) -> FrozenAdapter:
        """Latest version by default; a specific one for rollback."""
        versions = self._versions.get(adapter_id)
        if not versions:
            raise KeyError(f"unknown adapter {adapter_id!r}")
        if version is None:
            return versions[-1]
        if not 1 <= version <= len(versions):
            raise KeyError(f"{adapter_id!r} has no version {version}")
        return versions[version - 1]


def synthetic_adapter_stacks(rng: np.random.Generator, cfg, spec: AdapterSpec,
                             n_layers: int, scale: float = 0.02
                             ) -> Dict[str, Dict[str, np.ndarray]]:
    """Random float master stacks shaped for ``cfg``, drawn from ``rng`` in
    the reference's order (so one seed gives both packages the same
    tenants). B is non-zero, unlike a fresh LoRA init, so each tenant
    shifts the logits."""
    out = {}
    for target in spec.targets:
        k, n = target_dims(cfg, target)
        out[target] = {
            "a": rng.normal(size=(n_layers, k, spec.rank)).astype(np.float32)
            * (spec.rank ** -0.5),
            "b": rng.normal(size=(n_layers, spec.rank, n)).astype(np.float32)
            * scale,
        }
    return out
