"""GQA decode attention over a dense KV cache or the paged KV pool (the port
of the decode part of ``repro/models/attention.py`` and of
``repro/models/transformer.py``'s ``_gqa_decode_gspmd``).

The dense cache is ``{"k", "v"}`` of ``(L, B, Hkv, S, D)`` float8 e4m3
(:func:`init_kv_cache`); the pool is ``(L, n_pages + 1, Hkv, page, D)`` with
one scratch page last. Both decode functions write the new token's k/v
**in place** (a cache is hundreds of MB at full width; a functional copy per
layer and tick, as the reference's JAX update is, would double that), then
run their flash-decode kernel: :func:`gqa_decode_dense` over each row's
first ``pos + 1`` positions, :func:`gqa_decode_paged` through the block
tables.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.flash_decode.paged import paged_flash_decode_ref
from repro_torch.kernels.flash_decode.ref import flash_decode_ref
from repro_torch.models import layers
from repro_torch.models.layers import FP8_MAX, KV_CACHE_SCALE, Params


@dataclasses.dataclass
class PagedKVState:
    """Block-table view of the shared KV page pool for one decode tick.

    ``k_pool``/``v_pool`` are the whole pool ``(L, n_pages+1, Hkv, page, D)``
    (last page = scratch for inactive slots); ``tables`` (B, P) int32 are the
    per-slot block tables (pad → scratch page); ``write_page``/``write_off``
    (B,) name where this tick's token lands; ``lengths`` (B,) is the live
    context length *including* the new token (0 for an inactive slot).
    ``Model.decode_step`` updates the pools in place and returns the state.
    """
    k_pool: torch.Tensor
    v_pool: torch.Tensor
    tables: torch.Tensor
    write_page: torch.Tensor
    write_off: torch.Tensor
    lengths: torch.Tensor


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, n_layers: int,
                  *, device: torch.device) -> Params:
    """Zeroed dense fp8 e4m3 KV cache ``{"k", "v"}``, each ``(n_layers,
    batch, Hkv, max_len, D)``."""
    shape = (n_layers, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    return {name: torch.zeros(shape, dtype=torch.float8_e4m3fn, device=device)
            for name in ("k", "v")}


def kv_encode(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The fp8 KV write ``t / KV_CACHE_SCALE``. Overflow policy: saturate to
    ±448. In range this is bit-identical to the reference's cast; out of
    range the reference's cast gives NaN (0x7f), which would then poison
    every attention read of that position."""
    y = t / KV_CACHE_SCALE
    if dtype == torch.float8_e4m3fn:
        y = torch.clamp(y, -FP8_MAX, FP8_MAX)
    return y.to(dtype)


def gather_pages(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """pool (L, N, H, page, D) × tables (B, P) → contiguous (L, B, H, P*page, D)."""
    l, _, h, page, d = pool.shape
    b, p = tables.shape
    pages = pool[:, tables.long()]                 # (L, B, P, H, page, D)
    return pages.permute(0, 1, 3, 2, 4, 5).reshape(l, b, h, p * page, d)


def scatter_tokens(pool: torch.Tensor, page_ids: torch.Tensor,
                   offsets: torch.Tensor, toks: torch.Tensor) -> None:
    """Write toks (..., B, H, D), already in the pool's type, at
    (page_ids[b], offsets[b]) of pool (..., N, H, page, D), in place. The
    bytes are written through a uint8 view, which every device indexes."""
    raw = pool.view(torch.uint8)
    raw[..., page_ids.long(), :, offsets.long(), :] = toks.view(torch.uint8)


def check_dense_write(pos, max_len: int) -> None:
    """Raise IndexError if a host array of write positions reaches past a
    dense cache of ``max_len`` (the reference clamps such a write)."""
    if len(pos) and int(pos.max()) >= max_len:
        raise IndexError(f"decode write at position {int(pos.max())} of a "
                         f"dense cache of {max_len}")


def write_positions(cache: torch.Tensor, pos: torch.Tensor,
                    toks: torch.Tensor) -> None:
    """Write toks (B, H, D), already in the cache's type, at position
    ``pos[b]`` of row b of a dense cache layer (B, H, S, D), in place,
    through a uint8 view as :func:`scatter_tokens` does."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache.view(torch.uint8)[rows, :, pos.long(), :] = toks.view(torch.uint8)


def _project_qkv(p: Params, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, *, plain: bool = False,
                 adapter_idx: Optional[torch.Tensor] = None):
    """x (..., D) → q (..., H, D), k/v (..., Hkv, D) with RoPE applied.
    ``adapter_idx`` (B,) adds each row's multi-tenant LoRA term on the
    projections that carry one. The reference's qk-norm and sharding
    constraints are absent: bitnet has neither."""
    b = x.shape[:-1]
    kw = dict(plain=plain, adapter_idx=adapter_idx)
    q = layers.apply_linear(p["q"], x, **kw).reshape(
        *b, cfg.num_heads, cfg.head_dim)
    k = layers.apply_linear(p["k"], x, **kw).reshape(
        *b, cfg.num_kv_heads, cfg.head_dim)
    v = layers.apply_linear(p["v"], x, **kw).reshape(
        *b, cfg.num_kv_heads, cfg.head_dim)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_decode_paged(p: Params, x: torch.Tensor, k_pool_l: torch.Tensor,
                     v_pool_l: torch.Tensor, tables: torch.Tensor,
                     write_page: torch.Tensor, write_off: torch.Tensor,
                     lengths: torch.Tensor, pos: torch.Tensor,
                     cfg: ModelConfig, *, plain: bool = False,
                     adapter_idx: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """One-token GQA decode off one layer of the paged pool. Scatters the
    new token's k/v into its page (in place), then runs paged decode
    attention. x: (B, D); pools (N+1, Hkv, page, D); ``adapter_idx`` (B,)
    as in :func:`_project_qkv`. Returns (B, D)."""
    bsz = x.shape[0]
    q, k_new, v_new = _project_qkv(p, x[:, None], cfg, pos[:, None],
                                   plain=plain, adapter_idx=adapter_idx)
    scatter_tokens(k_pool_l, write_page, write_off,
                   kv_encode(k_new[:, 0], k_pool_l.dtype))
    scatter_tokens(v_pool_l, write_page, write_off,
                   kv_encode(v_new[:, 0], v_pool_l.dtype))
    q = q[:, 0]                                          # (B, H, D)
    if plain:
        qg = q.reshape(bsz, cfg.num_kv_heads, -1, cfg.head_dim)
        out = paged_flash_decode_ref(qg, k_pool_l, v_pool_l, tables, lengths,
                                     KV_CACHE_SCALE)
    else:
        out = fd_ops.paged_decode_attention(q, k_pool_l, v_pool_l, tables,
                                            lengths, KV_CACHE_SCALE)
    out = out.reshape(bsz, cfg.q_dim).to(x.dtype)
    return layers.apply_linear(p["o"], out, plain=plain,
                               adapter_idx=adapter_idx)


def gqa_decode_dense(p: Params, x: torch.Tensor, k_cache_l: torch.Tensor,
                     v_cache_l: torch.Tensor, lengths: torch.Tensor,
                     pos: torch.Tensor, cfg: ModelConfig, *,
                     plain: bool = False,
                     adapter_idx: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """One-token GQA decode off one layer of the dense cache (the reference's
    ``_gqa_decode_gspmd`` with per-slot positions). Writes the new token's
    k/v at each row's ``pos`` (in place), then attends over the row's first
    ``lengths = pos + 1`` positions (int32, made once per tick by the
    caller). x: (B, D); caches (B, Hkv, S, D); pos (B,) with every entry
    ``< S`` (checked by ``Model.decode_step`` or ``DenseKV``; the reference
    clamps such a write silently); ``adapter_idx`` (B,) as in
    :func:`_project_qkv`. Returns (B, D)."""
    bsz = x.shape[0]
    q, k_new, v_new = _project_qkv(p, x[:, None], cfg, pos[:, None],
                                   plain=plain, adapter_idx=adapter_idx)
    write_positions(k_cache_l, pos, kv_encode(k_new[:, 0], k_cache_l.dtype))
    write_positions(v_cache_l, pos, kv_encode(v_new[:, 0], v_cache_l.dtype))
    q = q[:, 0]                                          # (B, H, D)
    if plain:
        qg = q.reshape(bsz, cfg.num_kv_heads, -1, cfg.head_dim)
        out = flash_decode_ref(qg, k_cache_l, v_cache_l, lengths,
                               KV_CACHE_SCALE)
    else:
        out = fd_ops.decode_attention(q, k_cache_l, v_cache_l, lengths,
                                      KV_CACHE_SCALE)
    out = out.reshape(bsz, cfg.q_dim).to(x.dtype)
    return layers.apply_linear(p["o"], out, plain=plain,
                               adapter_idx=adapter_idx)
