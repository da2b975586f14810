"""train → freeze → register: deploy a QLoRA training run's adapter as a
tenant (the port of ``repro/serving/adapters/from_checkpoint.py``, without
``register_from_checkpoint``, which waits for the port's checkpoint layer).

A ``mode="qlora"`` training run keeps float master LoRA leaves in its param
tree, ``params["layers"][group][target]["lora"]`` with ``a: (L, K, r)`` and
``b: (L, r, N)`` stacked over layers: the stack shape
:meth:`AdapterRegistry.register` freezes. The tree comes as numpy arrays or
tensors (the port has no training mode yet; the reference's trees, handed
over as numpy, are what it reads).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

from repro_torch.serving.adapters.registry import (AdapterRegistry,
                                                   AdapterSpec, FrozenAdapter,
                                                   TARGET_GROUP)


def lora_stacks_from_params(params: Dict[str, Any], spec: AdapterSpec
                            ) -> Dict[str, Dict[str, np.ndarray]]:
    """Float master LoRA stacks ``{target: {"a": (L, K, r), "b": (L, r, N)}}``
    pulled from a qlora-mode param tree, host-side."""
    stacks: Dict[str, Dict[str, np.ndarray]] = {}
    for target in spec.targets:
        group = TARGET_GROUP[target]
        node = params["layers"].get(group, {}).get(target, {})
        lora = node.get("lora") if isinstance(node, dict) else None
        if not lora:
            raise KeyError(
                f"params carry no trained LoRA leaves for target {target!r} "
                "(expected params['layers'][group][target]['lora']): was the "
                "run trained with mode='qlora' and cfg.lora.targets "
                f"including {target!r}?")
        stacks[target] = {"a": np.asarray(lora["a"]),
                          "b": np.asarray(lora["b"])}
    return stacks


def register_from_params(registry: AdapterRegistry, params: Dict[str, Any],
                         adapter_id: str) -> FrozenAdapter:
    """Freeze a qlora param tree's LoRA leaves into ``registry`` as the next
    version of ``adapter_id`` (float masters → packed 2-bit ternary)."""
    return registry.register(
        adapter_id, lora_stacks_from_params(params, registry.spec))
