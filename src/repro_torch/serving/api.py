"""Serving API value objects (the port of ``repro/serving/api.py``, without
its deprecated-keyword shim).

Two frozen dataclasses describe a request: :class:`SamplingParams` (how
tokens are drawn) and :class:`RequestSpec` (everything else). The deadline
is a relative millisecond budget from submit time; the engine derives the
absolute ``Request.deadline_s`` the scheduler orders by.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """How output tokens are drawn for one request.

    temperature  0 → greedy (top_k/top_p/seed are then irrelevant).
    top_k        keep the k highest logits (0 = full softmax).
    top_p        nucleus sampling: keep the smallest prefix of the sorted
                 distribution with cumulative probability >= top_p
                 (1.0 = disabled).
    seed         per-request RNG stream: draws depend only on
                 (seed, tokens-generated-so-far), reproducible within the
                 port (the draws are not the reference's threefry bits).
    spec_k       speculative-decoding draft width; the port has no
                 speculative decoding yet, so it only validates.
    """
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None
    spec_k: int = 0

    def __post_init__(self):
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if self.seed is not None and not -2**31 <= self.seed < 2**31:
            raise ValueError(f"seed must fit int32, got {self.seed}")
        if not 0 <= self.spec_k <= 15:
            raise ValueError(f"spec_k must be in [0, 15], got {self.spec_k}")


@dataclasses.dataclass(frozen=True)
class RequestSpec:
    """Per-request serving options (everything that is not sampling).
    ``deadline_ms`` is the SLO budget relative to submit time."""
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    priority: int = 1                 # lower = more urgent (0: interactive)
    deadline_ms: Optional[float] = None
    adapter_id: Optional[str] = None  # tenant fine-tune (serving/adapters)
    stream_cb: Optional[Callable] = None   # cb(req, token) per output token
