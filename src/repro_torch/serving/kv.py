"""KV backends: the engine's cache contract behind one protocol (the port of
``repro/serving/kv.py``'s decode part).

A :class:`KVBackend` owns cache alloc / commit / free plus the admission
accounting, and hands the decode step a state object that
``Model.decode_step`` understands. :class:`DenseKV` hands it the contiguous
fp8 cache ``{"k", "v"}``; :class:`PagedKV` a
:class:`~repro_torch.models.attention.PagedKVState`: the shared fp8 pool,
this tick's block tables and write targets.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.models.attention import PagedKVState, check_dense_write
from repro_torch.serving.paged_kv import PagedConfig, PagePool


class KVBackend:
    """Owns KV storage for the engine's decode slots. Page accounting
    defaults to the dense answers (zero cost, unbounded capacity)."""

    name = "?"
    supports_paging = False
    pool: Optional[PagePool] = None

    def bind(self, model, max_slots: int, max_len: int) -> None:
        """Allocate storage for ``max_slots`` sequences of ``max_len``."""
        raise NotImplementedError

    def pages_for(self, tokens: int) -> int:
        return 0

    @property
    def pages_free(self) -> float:
        return math.inf

    @property
    def capacity_pages(self) -> float:
        return math.inf

    def slot_pages(self, slot: int) -> int:
        return 0

    def reserve(self, slot: int, upto_tokens: int) -> None:
        pass

    def release(self, slot: int, keep: int = 0) -> None:
        pass

    def decode_state(self, active: Sequence[int], pos: np.ndarray):
        """Build the state ``Model.decode_step`` consumes this tick."""
        raise NotImplementedError

    def commit(self, new_state, active: Sequence[int], pos: np.ndarray) -> None:
        """Store the decode step's updated state."""
        raise NotImplementedError


class DenseKV(KVBackend):
    """Contiguous per-slot cache ``(L, max_slots, Hkv, max_len, D)``, the
    paper's fixed on-chip SRAM budget: every slot owns ``max_len`` positions
    from the start, so admission costs no pages and capacity is unbounded
    (the :class:`KVBackend` defaults)."""

    name = "dense"

    def __init__(self):
        self.cache = None

    def bind(self, model, max_slots: int, max_len: int) -> None:
        if self.cache is not None:
            raise RuntimeError("KVBackend instances are engine-owned: build "
                               "a fresh one per engine")
        self.cache = model.init_cache(max_slots, max_len)

    def decode_state(self, active, pos):
        """The whole cache: every slot writes at its ``pos`` (inactive slots
        at 0, which their next request overwrites before reading). A ``pos``
        past the cache raises here, on the host, so the decode step needs no
        device sync to check it."""
        check_dense_write(pos, self.cache["k"].shape[3])
        return self.cache

    def commit(self, new_state, active, pos) -> None:
        """The decode step wrote the cache in place and returned it."""
        self.cache = new_state


class PagedKV(KVBackend):
    """vLLM-style paging over the shared fp8 pool: slots own block tables,
    decode attention reads pages through them."""

    name = "paged"
    supports_paging = True

    def __init__(self, page: int = 64, n_pages: Optional[int] = None):
        self.page = page
        self.n_pages = n_pages
        self.pool = None

    def bind(self, model, max_slots: int, max_len: int) -> None:
        if self.pool is not None:
            raise RuntimeError("KVBackend instances are engine-owned: build "
                               "a fresh one per engine")
        cfg = model.cfg
        pcfg = PagedConfig(
            n_layers=cfg.num_layers, n_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.head_dim, page=self.page,
            n_pages=self.n_pages or max_slots * (-(-max_len // self.page)))
        self.pool = PagePool(pcfg, max_slots, model.device)
        self.device = model.device
        self.max_slots = max_slots
        self.max_len = max_len

    def pages_for(self, tokens: int) -> int:
        return self.pool.pages_for(tokens)

    @property
    def pages_free(self) -> int:
        return self.pool.pages_free

    @property
    def capacity_pages(self) -> int:
        return self.pool.cfg.n_pages

    def slot_pages(self, slot: int) -> int:
        return len(self.pool.tables[slot])

    def reserve(self, slot: int, upto_tokens: int) -> None:
        self.pool.reserve(slot, upto_tokens)

    def release(self, slot: int, keep: int = 0) -> None:
        self.pool.release(slot, keep=keep)

    def _table_view(self, active) -> np.ndarray:
        """Bucketed (B, P) block-table matrix: the next power of two over
        the longest active table, capped at the max_len footprint (the
        reference buckets to bound recompiles; kept so both hand their
        kernels the same tables). Inactive rows point at the scratch page."""
        pool = self.pool
        max_pages = max(len(pool.tables[i]) for i in active)
        view = 1 << max(0, (max_pages - 1).bit_length())
        view = min(view, pool.pages_for(self.max_len))
        view = max(view, max_pages)
        return pool.batch_tables(active, view, self.max_slots)

    def decode_state(self, active, pos) -> PagedKVState:
        """Block tables + write targets for this tick; inactive slots write
        to the scratch page and have length 0."""
        pool = self.pool
        for i in active:
            pool.reserve(i, int(pos[i]) + 1)
        tables = self._table_view(active)
        page_ids = np.full((self.max_slots,), pool.scratch_page, np.int32)
        offsets = np.zeros((self.max_slots,), np.int32)
        lengths = np.zeros((self.max_slots,), np.int32)
        for i in active:
            p = int(pos[i])
            page_ids[i] = pool.tables[i][p // pool.cfg.page]
            offsets[i] = p % pool.cfg.page
            lengths[i] = p + 1

        def dev(a):
            return torch.from_numpy(a).to(self.device)

        return PagedKVState(k_pool=pool.k, v_pool=pool.v, tables=dev(tables),
                            write_page=dev(page_ids), write_off=dev(offsets),
                            lengths=dev(lengths))

    def commit(self, new_state: PagedKVState, active, pos) -> None:
        """The decode step wrote the pool in place; record the lengths."""
        self.pool.k = new_state.k_pool
        self.pool.v = new_state.v_pool
        for i in active:
            self.pool.lengths[i] = max(int(self.pool.lengths[i]),
                                       int(pos[i]) + 1)
