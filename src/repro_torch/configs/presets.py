"""Size presets: a copy of ``reduce_config`` (``repro/launch/train.py:48``)
for the dense GQA family the port serves."""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.configs.base import ModelConfig


def reduce_config(cfg: ModelConfig, preset: str) -> ModelConfig:
    """Shrink an architecture to ``tiny`` (÷8) or ``small`` (÷4) while
    keeping its topology; ``full`` returns it unchanged."""
    if preset == "full":
        return cfg
    if cfg.moe is not None or cfg.mla is not None or cfg.ssm is not None:
        raise NotImplementedError(
            "the port's presets cover the dense GQA family only")
    scale = {"tiny": 8, "small": 4}[preset]
    kw: Dict[str, Any] = dict(
        num_layers=max(2, cfg.num_layers // scale),
        d_model=max(128, cfg.d_model // scale),
        d_ff=max(256, cfg.d_ff // scale) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 2048),
        max_seq_len=min(cfg.max_seq_len, 4096),
    )
    if cfg.num_heads:
        kw["num_heads"] = max(2, cfg.num_heads // scale)
        # GQA requires Hq % Hkv == 0: the largest divisor of the reduced
        # head count that doesn't exceed the original kv-head count
        kv_cap = max(1, min(cfg.num_kv_heads, kw["num_heads"]))
        kw["num_kv_heads"] = max(d for d in range(1, kv_cap + 1)
                                 if kw["num_heads"] % d == 0)
        kw["head_dim"] = max(32, min(cfg.head_dim,
                                     kw["d_model"] // kw["num_heads"]))
    return cfg.replace(**kw)
