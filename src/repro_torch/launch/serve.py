"""Serving CLI of the port: build a packed-ternary model from a seed and
run a synthetic request stream through ``ServeEngine`` over the dense fp8
KV cache (``--kv dense``, the default, as in the reference) or the paged
fp8 pool (``--kv paged``) (the port of ``repro/launch/serve.py``'s
synthetic-stream path).

On the card, at the published width of bitnet-2b::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch bitnet-2b \\
        --preset full --kv dense --slots 4 --requests 8 --max-len 1024 \\
        --prompt-len 12 --max-new 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch bitnet-2b \\
        --preset full --kv paged --page 64 --slots 4 --requests 8 \\
        --prompt-len 12 --max-new 16

Multi-tenant adapters (one ternary base, many ternary QLoRA tenants on q
and v, served through the batched-LoRA kernel)::

    PYTHONPATH=src python -m repro_torch.launch.serve --adapters 4 \\
        --adapter-rank 8 --adapter-budget-kb 64 --adapter-rate 0.8

``--device cpu`` runs the plain PyTorch path (use ``--preset tiny`` there).
Prints one ``[serve] {...}`` JSON line of the engine stats.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.models.transformer import Model
from repro_torch.serving.adapters import (AdapterRegistry, AdapterServing,
                                          AdapterSpec,
                                          synthetic_adapter_stacks)
from repro_torch.serving.api import RequestSpec, SamplingParams
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.kv import DenseKV, PagedKV


def build_adapters(model: Model, n_adapters: int, *, rank: int = 8,
                   budget_kb=None, slots: int = 4, seed: int = 0
                   ) -> AdapterServing:
    """``n_adapters`` synthetic tenants ``tenant-<i>`` on q and v (rank
    ``rank``, alpha ``2·rank``) drawn from ``seed + 1``, behind an SRAM
    budget of ``budget_kb`` KiB (default: half the tenants fit, at least
    two), as the reference CLI sets them up."""
    cfg = model.cfg
    spec = AdapterSpec(rank=rank, alpha=2.0 * rank, targets=("q", "v"))
    registry = AdapterRegistry(spec)
    rng = np.random.default_rng(seed + 1)
    for i in range(n_adapters):
        registry.register(f"tenant-{i}", synthetic_adapter_stacks(
            rng, cfg, spec, cfg.num_layers))
    per_adapter = registry.get("tenant-0").nbytes
    budget = (int(budget_kb * 1024) if budget_kb
              else per_adapter * max(2, n_adapters // 2))
    print(f"[serve] {n_adapters} tenants registered ({per_adapter}B each, "
          f"SRAM budget {budget}B)")
    return AdapterServing(model, registry, budget_bytes=budget,
                          max_resident=max(2, min(n_adapters, slots * 2)))


def build_engine(arch: str, preset: str, *, slots: int, max_len: int,
                 kv: str = "dense", page: int = 64, n_pages=None,
                 seed: int = 0, device=None, plain: bool = False,
                 n_adapters: int = 0, adapter_rank: int = 8,
                 adapter_budget_kb=None) -> ServeEngine:
    """A seeded model at ``preset`` size behind an engine over ``kv``
    (``"dense"``, or ``"paged"`` with ``page``/``n_pages``), with
    ``n_adapters`` synthetic tenants when that is above 0."""
    cfg = reduce_config(get_config(arch), preset)
    model = Model(cfg, device=device, plain=plain)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    params = model.init(gen)
    adapters = (build_adapters(model, n_adapters, rank=adapter_rank,
                               budget_kb=adapter_budget_kb, slots=slots,
                               seed=seed)
                if n_adapters > 0 else None)
    if kv not in ("dense", "paged"):
        raise ValueError(f"kv must be 'dense' or 'paged', not {kv!r}")
    backend = (DenseKV() if kv == "dense"
               else PagedKV(page=page, n_pages=n_pages))
    return ServeEngine(model, params, max_slots=slots, max_len=max_len,
                       seed=seed, kv=backend, adapters=adapters)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", default="bitnet-2b")
    ap.add_argument("--preset", default="tiny", choices=("tiny", "small", "full"))
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling mass (1.0 = disabled)")
    ap.add_argument("--kv", default="dense", choices=("dense", "paged"))
    ap.add_argument("--page", type=int, default=64, help="--kv paged only")
    ap.add_argument("--n-pages", type=int, default=None,
                    help="--kv paged pool capacity (default: slots * max_len "
                         "/ page)")
    ap.add_argument("--adapters", type=int, default=0,
                    help="register this many synthetic QLoRA tenants and "
                         "serve them multi-tenant (0 = single personality)")
    ap.add_argument("--adapter-rank", type=int, default=8)
    ap.add_argument("--adapter-budget-kb", type=float, default=None,
                    help="adapter SRAM budget (default: half the tenants fit)")
    ap.add_argument("--adapter-rate", type=float, default=1.0,
                    help="fraction of requests that carry an adapter_id")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain PyTorch path)")
    args = ap.parse_args(argv)

    torch.backends.cuda.matmul.allow_tf32 = False
    eng = build_engine(args.arch, args.preset, slots=args.slots,
                       max_len=args.max_len, kv=args.kv, page=args.page,
                       n_pages=args.n_pages, seed=args.seed,
                       device=args.device, n_adapters=args.adapters,
                       adapter_rank=args.adapter_rank,
                       adapter_budget_kb=args.adapter_budget_kb)
    rng = np.random.default_rng(args.seed)
    vocab = eng.cfg.vocab_size
    reqs = []
    for i in range(args.requests):
        plen = int(rng.integers(max(2, args.prompt_len // 2),
                                args.prompt_len + 1))
        prompt = [int(t) for t in rng.integers(0, min(vocab, 1000), size=plen)]
        adapter_id = None
        if args.adapters > 0 and rng.random() < args.adapter_rate:
            adapter_id = f"tenant-{i % args.adapters}"
        reqs.append(eng.submit(
            prompt, RequestSpec(max_new_tokens=args.max_new, priority=i % 2,
                                adapter_id=adapter_id),
            SamplingParams(temperature=args.temperature, top_p=args.top_p)))
    t0 = time.time()
    stats = eng.run_until_drained()
    wall = time.time() - t0

    done = [r for r in reqs if r.state == "done"]
    ttfts = [r.ttft_s for r in done] or [0.0]
    lats = [r.latency_s for r in done] or [0.0]
    out = {
        "device": str(eng.device),
        "kv": eng.kv.name,
        "requests": len(reqs),
        "completed": stats.completed,
        "tokens_out": stats.tokens_out,
        "ticks": stats.ticks,
        "preemptions": stats.preemptions,
        "wall_s": round(wall, 3),
        "throughput_tps": round(stats.tokens_out / wall, 1) if wall else 0.0,
        "ttft_p50_ms": round(float(np.median(ttfts)) * 1e3, 1),
        "ttft_p99_ms": round(float(np.quantile(ttfts, 0.99)) * 1e3, 1),
        "latency_p50_ms": round(float(np.median(lats)) * 1e3, 1),
    }
    if eng.adapters is not None:
        out["adapters"] = eng.adapters.stats()
    print("[serve]", json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
