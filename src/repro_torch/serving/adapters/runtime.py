"""Adapter serving runtime: device stacks and their graft into the params
(the port of ``repro/serving/adapters/runtime.py``).

The data plane of the multi-tenant subsystem. Resident adapters live on the
model's device as packed-ternary stacks, per target projection::

    a: (L, R+1, K//4, r) u8    b: (L, R+1, r//4, N) u8    s: (L, R+1) f32

Slot 0 is the null adapter (zero codes, zero scale), so slots without an
adapter contribute exactly 0. :meth:`AdapterServing.install` grafts each
layer's ``(R+1, ...)`` view of these stacks into a param tree as ``lora_mt``
leaves on the target projections; the engine passes a per-slot
``adapter_idx`` into ``Model.decode_step`` and ``models/layers.apply_linear``
adds each row's LoRA term through the batched-LoRA kernel (SGMV: one tick
serves many fine-tunes, no per-adapter dispatch).

Loading an adapter writes its slot of each stack **in place** on the device
(the reference rebuilds the stacks functionally and re-installs them), so
the views installed once stay current. The combined per-layer scale
``scale_a · scale_b · α/r`` is folded into ``s`` at upload, so the kernel
multiplies once.

The reference's tiered-memory hooks (``attach_tiered``, ``prefetch``,
``_upload_payload``) wait for the port of ``serving/memory``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.serving.adapters.cache import AdapterCache
from repro_torch.serving.adapters.registry import (AdapterRegistry,
                                                   FrozenAdapter,
                                                   TARGET_GROUP, target_dims)

Stacks = Dict[str, Dict[str, torch.Tensor]]


def install_stacks(params: Dict[str, Any], stacks: Stacks) -> Dict[str, Any]:
    """Copy-on-write graft of ``stacks`` (target → ``{"a", "b", "s"}`` with a
    leading layer axis) into the port's per-layer ``params`` as ``lora_mt``
    leaves holding each layer's view of the stacks (the original tree is
    untouched; the views share the stacks' storage)."""
    out = dict(params)
    new_layers = []
    for i, lp in enumerate(params["layers"]):
        lp = dict(lp)
        for target, st in stacks.items():
            group = dict(lp[TARGET_GROUP[target]])
            node = dict(group[target])
            node["lora_mt"] = {k: st[k][i] for k in ("a", "b", "s")}
            group[target] = node
            lp[TARGET_GROUP[target]] = group
        new_layers.append(lp)
    out["layers"] = new_layers
    return out


class AdapterServing:
    """Registry + SRAM-budget cache + device stacks for one served model."""

    def __init__(self, model, registry: AdapterRegistry, *,
                 budget_bytes: int, max_resident: int = 8):
        cfg = model.cfg
        if cfg.family != "dense" or cfg.attention_kind != "gqa":
            raise NotImplementedError(
                "multi-tenant adapters target the dense GQA family")
        self.model = model
        self.cfg = cfg
        self.registry = registry
        self.spec = registry.spec
        self.cache = AdapterCache(budget_bytes, max_resident)
        self.n_layers = cfg.num_layers
        r, n_slots = self.spec.rank, max_resident + 1      # + null slot 0
        dev = model.device
        self.pack: Stacks = {}
        for target in self.spec.targets:
            k, n = target_dims(cfg, target)
            self.pack[target] = {
                "a": torch.zeros((self.n_layers, n_slots, k // 4, r),
                                 dtype=torch.uint8, device=dev),
                "b": torch.zeros((self.n_layers, n_slots, r // 4, n),
                                 dtype=torch.uint8, device=dev),
                "s": torch.zeros((self.n_layers, n_slots),
                                 dtype=torch.float32, device=dev),
            }

    def install(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """``params`` with this runtime's stacks grafted in (see
        :func:`install_stacks`); later uploads show through the views."""
        return install_stacks(params, self.pack)

    # -- residency lifecycle ---------------------------------------------------
    # Cache keys are version-resolved ("tenant@v2"): a re-register creates a
    # distinct entry, so requests pinned on the old version keep their
    # weights while new placements load the new one.
    def _vkey(self, adapter_id: str) -> str:
        """Cache key of the adapter's latest registered version."""
        return f"{adapter_id}@v{self.registry.get(adapter_id).version}"

    def is_resident(self, adapter_id: str) -> bool:
        """Affinity predicate: is the latest version already on the device?"""
        if adapter_id not in self.registry:
            return False
        return self.cache.is_resident(self._vkey(adapter_id))

    def servable(self, adapter_id: Optional[str]) -> bool:
        """Static half of admission: registered and small enough ever to fit
        the budget (checked at submit)."""
        if adapter_id is None:
            return True
        if adapter_id not in self.registry:
            return False
        return self.registry.get(adapter_id).nbytes <= self.cache.budget_bytes

    def can_serve(self, adapter_id: Optional[str]) -> bool:
        """Admission predicate: could a request with this adapter start now?"""
        if adapter_id is None:
            return True
        if adapter_id not in self.registry:
            return False
        entry = self.registry.get(adapter_id)
        return self.cache.can_admit(self._vkey(adapter_id), entry.nbytes)

    def acquire_versioned(self, adapter_id: str) -> Tuple[int, str]:
        """Pin the adapter's latest version for an in-flight request,
        loading it (and evicting LRU unpinned residents) if cold. Returns
        the device slot and the version-resolved key to release."""
        entry = self.registry.get(adapter_id)
        key = f"{adapter_id}@v{entry.version}"
        slot = self.cache.lookup(key)
        if slot is None:
            slot, _ = self.cache.admit(key, entry.nbytes)
            self._upload(entry, slot)
        self.cache.pin(key)
        return slot, key

    def release_key(self, key: str) -> None:
        """Unpin a version-resolved key from :meth:`acquire_versioned`."""
        self.cache.unpin(key)

    def _upload(self, entry: FrozenAdapter, slot: int) -> None:
        """Write ``entry``'s codes and folded scales into ``slot`` of every
        stack, in place on the device."""
        if entry.n_layers != self.n_layers:
            raise ValueError(
                f"{entry.adapter_id} v{entry.version} has {entry.n_layers} "
                f"layers; model has {self.n_layers}")
        for target, pk in entry.packs.items():
            combined = (pk["a_scale"] * pk["b_scale"]
                        * np.float32(self.spec.scaling)).astype(np.float32)
            dev = self.pack[target]
            for name, host in (("a", pk["a_codes"]), ("b", pk["b_codes"]),
                               ("s", combined)):
                dev[name][:, slot].copy_(torch.from_numpy(host))

    def stats(self) -> Dict[str, float]:
        st = self.cache.stats()
        st["registered"] = len(self.registry)
        return st
