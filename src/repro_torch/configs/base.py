"""Config dataclasses: a copy of ``repro/configs/base.py``'s ``LoRAConfig``
and ``ModelConfig`` (the port keeps its own, it imports nothing of
``repro``). The MoE/MLA/SSM sub-configs are not ported yet: their fields
stay, typed loosely, so a config compares field for field with the
reference."""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Any, Optional, Tuple


@dataclass(frozen=True)
class LoRAConfig:
    """Ternary QLoRA adapters (paper §IV-D.3, LoTA-QAF-style)."""

    rank: int = 16
    targets: Tuple[str, ...] = ("q", "v")  # which projections carry adapters
    ternary_adapters: bool = True
    alpha: float = 32.0


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    # --- attention options -------------------------------------------------
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    attention_kind: str = "gqa"  # gqa | mla | none
    mla: Optional[Any] = None
    # --- ffn ----------------------------------------------------------------
    ffn_kind: str = "swiglu"  # swiglu | gelu | relu2
    moe: Optional[Any] = None
    # --- ssm / hybrid --------------------------------------------------------
    ssm: Optional[Any] = None
    block_pattern: str = ""
    shared_attention: bool = False
    # --- embedding / head ----------------------------------------------------
    tie_embeddings: bool = False
    frontend_stub_dim: int = 0
    # --- quantisation (the paper's technique) --------------------------------
    ternary_weights: bool = True   # C1: pack every linear as 2-bit ternary
    fp8_activations: bool = True   # activations/KV in e4m3 with scales
    fp8_kv_cache: bool = True
    # --- adapters -------------------------------------------------------------
    lora: Optional[LoRAConfig] = None
    # --- misc -----------------------------------------------------------------
    max_seq_len: int = 32_768
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    @property
    def vocab_padded(self) -> int:
        """Embedding-table vocab padded to a multiple of 128; logits at the
        pad positions are masked to −inf."""
        return ((self.vocab_size + 127) // 128) * 128

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


#: architectures the port serves so far
ARCH_IDS = ("bitnet-2b",)


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; the port knows {ARCH_IDS}")
    mod = importlib.import_module(
        f"repro_torch.configs.{arch.replace('-', '_').replace('.', '_')}")
    return mod.CONFIG
