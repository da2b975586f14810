"""Paged KV cache: a block-pool allocator for decode slots (the port of
``repro/serving/paged_kv.py``'s ``PagedConfig``/``PagePool``).

One shared fp8 page pool ``(L, n_pages + 1, Hkv, page, D)`` lives on the
device; each slot owns a growable list of page ids (its block table). The
allocator is host-side control plane (Python lists). One extra *scratch*
page, id ``n_pages``, is never handed out: inactive slots write there and
table padding points there, so the decode step needs no mask.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch


@dataclasses.dataclass
class PagedConfig:
    n_layers: int
    n_kv_heads: int
    head_dim: int
    page: int = 64              # tokens per page
    n_pages: int = 256          # pool capacity (per k and v)
    dtype: torch.dtype = torch.float8_e4m3fn


class PagePool:
    """Shared fp8 KV page pool on ``device`` + per-slot block tables."""

    def __init__(self, cfg: PagedConfig, max_slots: int,
                 device: torch.device):
        self.cfg = cfg
        shape = (cfg.n_layers, cfg.n_pages + 1, cfg.n_kv_heads, cfg.page,
                 cfg.head_dim)
        self.k = torch.zeros(shape, dtype=cfg.dtype, device=device)
        self.v = torch.zeros(shape, dtype=cfg.dtype, device=device)
        self.free: List[int] = list(range(cfg.n_pages))
        self.tables: List[List[int]] = [[] for _ in range(max_slots)]
        self.lengths = np.zeros((max_slots,), np.int32)

    @property
    def scratch_page(self) -> int:
        return self.cfg.n_pages

    @property
    def pages_free(self) -> int:
        return len(self.free)

    def pages_for(self, tokens: int) -> int:
        return -(-tokens // self.cfg.page)

    def can_admit(self, tokens: int) -> bool:
        return self.pages_free >= self.pages_for(tokens)

    def reserve(self, slot: int, upto_tokens: int) -> None:
        """Grow the slot's table to cover ``upto_tokens`` positions."""
        need = self.pages_for(max(upto_tokens, 1)) - len(self.tables[slot])
        for _ in range(max(0, need)):
            if not self.free:
                raise MemoryError("page pool exhausted")
            self.tables[slot].append(self.free.pop())

    def release(self, slot: int, keep: int = 0) -> None:
        """Free the slot's pages (all but ``keep`` leading ones) and clear
        its table."""
        self.free.extend(self.tables[slot][keep:])
        self.tables[slot] = []
        self.lengths[slot] = 0

    def batch_tables(self, slots: List[int], n_pages: int,
                     batch: int) -> np.ndarray:
        """(batch, n_pages) int32 block-table matrix; rows of inactive slots
        (and padding beyond a slot's table) point at the scratch page."""
        out = np.full((batch, n_pages), self.scratch_page, np.int32)
        for s in slots:
            t = self.tables[s][:n_pages]
            out[s, :len(t)] = t
        return out
