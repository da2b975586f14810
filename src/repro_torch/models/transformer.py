"""The dense GQA model in serve mode (the port of the decode paths of
``repro/models/transformer.py``: the dense cache and the paged kernel).

Parameters mirror the reference's tree, with the scanned ``layers`` stack
split into a Python list of per-layer dicts::

    {"embed": {"packed_rows", "scale", "packed_t"}, "final_norm": {"w"},
     "layers": [{"norm1": {"w"}, "norm2": {"w"},
                 "attn": {"q"|"k"|"v"|"o": {"packed", "scale"}},
                 "ffn": {"up"|"down"[|"gate"]: {"packed", "scale"}}}, ...]}

``embed.packed_t`` is the tied head's transposed copy of ``packed_rows``
(:func:`layers.logits_weight`), made once at load. Weights stay packed 2-bit
codes on the device; no unpacked copy is kept.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import ternary
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers
from repro_torch.models.layers import Params

NEG_INF = -1e30

#: a dense KV cache, ``{"k", "v"}`` of ``(L, B, Hkv, S, D)``
DenseCache = Dict[str, torch.Tensor]


def _init_linear(g: torch.Generator, k: int, n: int,
                 device: torch.device) -> Params:
    w = torch.randn((k, n), generator=g, device=device) * (k ** -0.5)
    t, s = ternary.quantize(w)
    return {"packed": ternary.pack2(t), "scale": s}


class Model:
    """``Model(cfg, device=None)`` serves on the card; pass ``device="cpu"``
    for the plain PyTorch path. ``plain=True`` runs every kernel's plain
    version on any device (the reference path the kernels are held
    against). ``kv_widen`` is the type the reference widens the dense
    cache to in attention; only ``"f32"`` is ported."""

    def __init__(self, cfg: ModelConfig, *,
                 device: Optional[Union[str, torch.device]] = None,
                 plain: bool = False, kv_widen: str = "f32"):
        if cfg.family != "dense" or cfg.attention_kind != "gqa":
            raise NotImplementedError(
                f"the port serves the dense GQA family only, not "
                f"{cfg.family}/{cfg.attention_kind}")
        if kv_widen != "f32":
            raise NotImplementedError(
                f"kv_widen={kv_widen!r}: the port widens the KV cache to f32 "
                f"only")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.plain = plain

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.cfg.dtype == "bfloat16" else torch.float32

    # -- params ------------------------------------------------------------
    def init(self, generator: torch.Generator) -> Params:
        """Seeded init with the reference's structure and distributions
        (``Model.init``, ``init_linear``, ``init_embedding``): N(0, 1/K)
        linears and an N(0, 0.02²) embedding, each absmean-quantised and
        packed; norms at one. ``generator`` must live on the model's device."""
        cfg, dev = self.cfg, self.device
        d = cfg.d_model
        w = torch.randn((cfg.vocab_padded, d), generator=generator,
                        device=dev) * 0.02
        t, s = ternary.quantize(w)
        del w
        embed = {"packed_rows": layers.pack_rows(t), "scale": s}
        del t
        embed["packed_t"] = layers.logits_weight(embed["packed_rows"])
        p: Params = {"embed": embed,
                     "final_norm": {"w": torch.ones(d, device=dev)}}
        blocks = []
        for _ in range(cfg.num_layers):
            ffn = {"up": _init_linear(generator, d, cfg.d_ff, dev),
                   "down": _init_linear(generator, cfg.d_ff, d, dev)}
            if cfg.ffn_kind == "swiglu":
                ffn["gate"] = _init_linear(generator, d, cfg.d_ff, dev)
            blocks.append({
                "norm1": {"w": torch.ones(d, device=dev)},
                "norm2": {"w": torch.ones(d, device=dev)},
                "attn": {"q": _init_linear(generator, d, cfg.q_dim, dev),
                         "k": _init_linear(generator, d, cfg.kv_dim, dev),
                         "v": _init_linear(generator, d, cfg.kv_dim, dev),
                         "o": _init_linear(generator, cfg.q_dim, d, dev)},
                "ffn": ffn})
        p["layers"] = blocks
        return p

    # -- head ----------------------------------------------------------------
    def _logits(self, p: Params, x: torch.Tensor) -> torch.Tensor:
        logits = layers.tied_logits(p["embed"], x, plain=self.plain)
        if self.cfg.vocab_padded != self.cfg.vocab_size:
            # pad slots only keep the table a multiple of 128: mask them out
            # of every softmax/argmax
            pad = torch.arange(self.cfg.vocab_padded,
                               device=logits.device) >= self.cfg.vocab_size
            logits = logits.masked_fill(pad, NEG_INF)
        return logits

    # -- caches ------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> DenseCache:
        """Zeroed dense fp8 KV cache for ``batch`` slots of ``max_len``."""
        return attn_mod.init_kv_cache(self.cfg, batch, max_len,
                                      self.cfg.num_layers, device=self.device)

    # -- decode ----------------------------------------------------------------
    @torch.no_grad()
    def decode_step(self, p: Params,
                    state: Union[DenseCache, attn_mod.PagedKVState],
                    tokens: torch.Tensor, pos: torch.Tensor,
                    adapter_idx: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor,
                               Union[DenseCache, attn_mod.PagedKVState]]:
        """One token for every slot. ``state`` is either the dense cache of
        :meth:`init_cache`, where each layer writes the new token's k/v at
        ``pos`` and attends over positions ``<= pos`` of the row, or a
        :class:`PagedKVState`, where they go into their pages and attention
        reads the pages through the block tables. Either is updated in place
        and returned as it came. tokens/pos: (B,) int. A dense write at
        ``pos >= max_len`` raises: here when ``pos`` lies on the CPU, where
        the check costs no device sync, and in ``DenseKV.decode_state`` on
        the engine's host copy of ``pos``. ``adapter_idx`` (B,) int32 selects each
        slot's resident multi-tenant adapter on the projections whose params
        carry a ``lora_mt`` stack (``serving/adapters/runtime.py``); ``None``
        runs the base model alone. Returns (logits (B, V) f32, the state)."""
        cfg, plain = self.cfg, self.plain
        kw = dict(plain=plain, adapter_idx=adapter_idx)
        if isinstance(state, attn_mod.PagedKVState):
            def attend(i, lp, h):
                return attn_mod.gqa_decode_paged(
                    lp["attn"], h, state.k_pool[i], state.v_pool[i],
                    state.tables, state.write_page, state.write_off,
                    state.lengths, pos, cfg, **kw)
        else:
            if not pos.is_cuda:
                attn_mod.check_dense_write(pos.numpy(), state["k"].shape[3])
            lengths = (pos + 1).to(torch.int32)

            def attend(i, lp, h):
                return attn_mod.gqa_decode_dense(
                    lp["attn"], h, state["k"][i], state["v"][i], lengths, pos,
                    cfg, **kw)
        x = layers.embed_tokens(p["embed"], tokens, self.dtype)
        for i, lp in enumerate(p["layers"]):
            h = layers.rms_norm(x, lp["norm1"]["w"], cfg.norm_eps)
            x = x + attend(i, lp, h)
            h2 = layers.rms_norm(x, lp["norm2"]["w"], cfg.norm_eps)
            x = x + layers.apply_ffn(lp["ffn"], h2, cfg.ffn_kind, **kw)
        x = layers.rms_norm(x, p["final_norm"]["w"], cfg.norm_eps)
        return self._logits(p, x), state
