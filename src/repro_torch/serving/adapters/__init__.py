"""Multi-tenant QLoRA adapter serving (the port of ``repro/serving/adapters``):
registry (versioned frozen ternary adapters), SRAM-budget cache (byte-
accounted LRU with pinning), and the runtime that keeps resident adapters in
device stacks for the batched-LoRA kernel (see runtime.py)."""
from repro_torch.serving.adapters.cache import AdapterCache
from repro_torch.serving.adapters.from_checkpoint import (
    lora_stacks_from_params, register_from_params)
from repro_torch.serving.adapters.registry import (AdapterRegistry,
                                                   AdapterSpec, FrozenAdapter,
                                                   synthetic_adapter_stacks,
                                                   target_dims)
from repro_torch.serving.adapters.runtime import AdapterServing

__all__ = ["AdapterCache", "AdapterRegistry", "AdapterServing", "AdapterSpec",
           "FrozenAdapter", "lora_stacks_from_params", "register_from_params",
           "synthetic_adapter_stacks", "target_dims"]
