"""Parameter bridge from the reference: turn ``repro``'s serve-mode
``Model.init`` pytree and its multi-tenant adapter stacks, handed over as
numpy arrays, into the port's tensors. Numpy only, so it needs no JAX; the
tests use it to give both sides the same numbers.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers
from repro_torch.models.layers import Params


def _tensor(a: Any, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _tree(node: Any, device: torch.device) -> Any:
    if isinstance(node, Mapping):
        return {k: _tree(v, device) for k, v in node.items()}
    return _tensor(node, device)


def params_from_jax(tree: Mapping[str, Any], cfg: ModelConfig,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Params:
    """``tree``: the reference's serve-mode params with numpy leaves (uint8
    ``packed``/``packed_rows`` codes, f32 ``scale`` and norm weights). The
    ``layers`` stack, scanned on its leading axis there, becomes a list of
    per-layer dicts; the tied head's transposed copy is added."""
    dev = resolve_device(device)
    if cfg.family != "dense" or "prefix" in tree or "head" in tree:
        raise NotImplementedError(
            "the port converts dense, tied-embedding models only")
    stack = tree["layers"]
    n = np.asarray(stack["norm1"]["w"]).shape[0]
    if n != cfg.num_layers:
        raise ValueError(f"tree has {n} layers, config {cfg.num_layers}")

    def layer(i: int, node: Any) -> Any:
        if isinstance(node, Mapping):
            return {k: layer(i, v) for k, v in node.items()}
        return _tensor(np.asarray(node)[i], dev)

    embed = _tree(tree["embed"], dev)
    embed["packed_t"] = layers.logits_weight(embed["packed_rows"])
    return {"embed": embed,
            "final_norm": _tree(tree["final_norm"], dev),
            "layers": [layer(i, stack) for i in range(n)]}


def adapter_stacks_from_jax(pack: Mapping[str, Mapping[str, Any]],
                            device: Optional[Union[str, torch.device]] = None
                            ) -> Dict[str, Dict[str, torch.Tensor]]:
    """``pack``: the reference's ``AdapterServing.pack`` with numpy leaves,
    target → ``{"a": (L, R+1, K/4, r) u8, "b": (L, R+1, r/4, N) u8,
    "s": (L, R+1) f32}``. Returns the same stacks as the port's device
    tensors, in the layout of its ``AdapterServing.pack`` (for
    ``serving.adapters.runtime.install_stacks``)."""
    dev = resolve_device(device)
    return {target: {k: _tensor(st[k], dev) for k in ("a", "b", "s")}
            for target, st in pack.items()}
