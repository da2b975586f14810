#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts on the card.

    python3 chip_smoke.py

Needs one NVIDIA card and the checkout (it puts ``src/`` on ``sys.path``
itself). Imports no JAX and nothing of the JAX package. Phases, any failure
of which ends the run with a non-zero exit and no result line:

1. device: ``nvidia-smi`` name and power limit, torch's device name/count;
2. build: every kernel of the slice from ``src/repro_torch/kernels/csrc``
   with ``nvcc`` for sm_90a, all sources at once;
3. kernels: each kernel's wrapper on the shapes a full-width bitnet-2b
   decode tick gives it (4 slots), held against its plain PyTorch version
   on the same inputs with the stated tolerance, and timed with CUDA events
   beside the plain version, one PyTorch library call, and its bound;
4. serving, three paths, each with the launch counts zeroed just before it
   and read just after, every logit checked finite:
   a. ``ServeEngine`` over ``PagedKV`` (page 64, 4 slots) at full width with
      seeded random weights, 8 greedy requests of 12-32 prompt tokens and 16
      new tokens (no adapters: kernel #3 must not launch);
   b. the same engine with ``adapters=AdapterServing(...)``: 4 synthetic
      tenants (rank 8, alpha 16, on q and v) behind a budget of 2, 8 greedy
      requests of which 6 name a tenant, so that adapter-less and tenant
      rows share ticks and tenants are evicted and pinned; kernel #3
      launches once per targeted projection and tick (60);
   c. the engine over ``DenseKV`` (the contiguous fp8 cache of max_len
      positions per slot, the engine's default), the requests of pass a:
      kernel #4 launches once per layer and tick (30), kernel #2 never;
5. identity: two greedy requests through the kernels; at every tick, every
   layer's attention and FFN block and the logits run through the kernels
   and through the plain versions (``plain=True``) on the same input and a
   copy of the same KV state, within stated tolerances (with a control that
   cuts attention to one position, to show the tolerance is far below what
   a wrong attention moves); then the same requests through the plain
   versions alone, greedy tokens equal over 8 steps except at a reported
   near-tie. All of that once over the paged pool and once over the dense
   cache, and the greedy tokens of the dense and paged kernel paths equal
   except at a reported near-tie. Then the same per-layer walk on the
   paged adapter engine with a per-slot index mixing tenants and 0: the
   kernel path's targeted projections and attention blocks within the
   tolerance of the plain path's; a control with every index set to 0
   moves each tenant row's targeted projections in every layer, and its
   attention block in the layer where it moves most, by many tolerances;
   null rows equal the engine without adapters bit for bit.

Two lines before the last is ``{"kernels": [...]}``: the ``launches`` of
kernels #1-#3 are their counts in pass 4b (multi-tenant paged serving,
which runs all three), that of kernel #4 its count in pass 4c (dense
serving, the only path that runs it); ``launches_by_path`` has each
kernel's count in every pass. Then the card's name and power limit as
``nvidia-smi`` gives them, and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: H100 SXM data-sheet peaks (dense): device memory rate and arithmetic rates
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
SLOTS, PAGE, MAX_LEN = 4, 64, 1024
#: greedy picks whose top-2 logit gap is below this are near-ties
TIE_TOL = 5e-2
#: kernel vs plain output of each layer's attention and FFN block from the
#: same input and KV state: max |diff| over live rows within this fraction of
#: the plain output's max |value| (bf16 outputs, each rounded once after f32
#: sums taken in another order: a few bf16 ulps, 2^-8 each)
BLOCK_TOL = 1e-2
#: the same for the f32 logits from the same final hidden state (f32 sums in
#: another order, and (x·t)·scale against x·(t·scale))
LOGITS_TOL = 1e-4
#: attention that reads only position 0 must move each attention block's
#: output by at least this many tolerances, or the check could not see a
#: wrong attention kernel; the same margin holds for dropping the tenants'
#: LoRA terms (every index 0) against a wrong batched-LoRA kernel
CONTROL_MARGIN = 10.0
#: kernel #3 vs its plain version: max |diff| within this fraction of the
#: plain output's max |value| (f32 sums over K and r in another order; the
#: kernel reads the bf16 activations as given, as the plain version does)
LORA_TOL = 1e-5
#: the multi-tenant pass: 4 tenants at rank 8, alpha 2·rank, on q and v,
#: behind an SRAM budget of 2 tenants (``launch/serve.py``'s defaults)
TENANTS, RANK, BUDGET_TENANTS = 4, 8, 2


def _fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 2


def _time_ms(fn, args_list, reps: int):
    """(device ms, wall ms) per call over ``reps`` calls cycling through
    ``args_list`` (enough copies to keep the weights out of the 50 MB L2,
    as a decode tick that streams ~480 MB of weights finds them). Device ms
    is the kernel time ``torch.profiler`` records on the card; wall ms comes
    from CUDA events around the back-to-back calls and also holds the gaps
    in which the card waits for the host to enqueue the next call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for i in range(3):
        fn(*args_list[i % len(args_list)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(*args_list[i % len(args_list)])
    stop.record()
    torch.cuda.synchronize()
    wall = start.elapsed_time(stop) / reps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            fn(*args_list[i % len(args_list)])
        torch.cuda.synchronize()
    dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    if dev_us <= 0:
        raise AssertionError("the profiler recorded no device time")
    return dev_us / reps / 1e3, wall


def _copies(nbytes: int, floor: int = 120 << 20) -> int:
    return max(1, -(-floor // max(nbytes, 1)))


def bench_ternary_matmul(torch, cfg):
    """Kernel #1 at the decode tick's shapes; returns its JSON entry."""
    from repro_torch.core import ternary
    from repro_torch.kernels.ternary_matmul import ops as tm_ops
    from repro_torch.kernels.ternary_matmul.ref import ternary_matmul_ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    d, dff, m = cfg.d_model, cfg.d_ff, SLOTS
    # (name, K, N, x/out type, launches per tick)
    shapes = [("q,o", d, cfg.q_dim, torch.bfloat16, 2 * cfg.num_layers),
              ("k,v", d, cfg.kv_dim, torch.bfloat16, 2 * cfg.num_layers),
              ("up", d, dff, torch.bfloat16, cfg.num_layers),
              ("down", dff, d, torch.bfloat16, cfg.num_layers),
              ("logits", d, cfg.vocab_padded, torch.float32, 1)]
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    max_err, bytes_tick, ops_bound_tick, bytes_bound_tick = 0.0, 0, 0.0, 0.0
    for name, k, n, dt, per_tick in shapes:
        w = torch.randn((k, n), generator=g, device=dev) * k ** -0.5
        t, s = ternary.quantize(w)
        packed = ternary.pack2(t)
        x = torch.randn((m, k), generator=g, device=dev).to(dt)
        got = tm_ops.ternary_matmul(x, packed, s, out_dtype=dt)
        want = ternary_matmul_ref(x, packed, s, out_dtype=dt)
        torch.cuda.synchronize()
        # f32: summation order only; bf16: plus one rounding of the output
        tol = (dict(rtol=1e-5, atol=1e-4) if dt == torch.float32
               else dict(rtol=1e-2, atol=1e-2))
        err = (got.float() - want.float()).abs().max().item()
        rel = err / max(want.float().abs().max().item(), 1e-30)
        torch.testing.assert_close(got.float(), want.float(), **tol)
        max_err = max(max_err, err)
        n_pk = _copies(packed.numel())
        pk = [packed.clone() for _ in range(n_pk)]
        ms, ms_wall = _time_ms(lambda p: tm_ops.ternary_matmul(x, p, s, out_dtype=dt),
                               [(p,) for p in pk], reps=max(20, 2 * n_pk))
        plain_ms, _ = _time_ms(
            lambda p: ternary_matmul_ref(x, p, s, out_dtype=dt),
            [(p,) for p in pk[:2]], reps=5)
        del pk
        wl = (t.to(dt) * s).to(dt)             # pre-unpacked, pre-scaled weight
        n_w = _copies(wl.numel() * wl.element_size())
        wls = [wl.clone() for _ in range(n_w)]
        lib_ms, lib_wall = _time_ms(lambda wt: torch.matmul(x, wt),
                                    [(wt,) for wt in wls], reps=max(20, 2 * n_w))
        del wls, wl, w, t
        nbytes = (x.numel() * x.element_size() + packed.numel() + 4
                  + m * n * x.element_size())
        ops = 2 * m * k * n
        rate = PEAK_FLOPS["f32" if dt == torch.float32 else "bf16"]
        b_bytes, b_ops = nbytes / HBM_BYTES_S * 1e3, ops / rate * 1e3
        print(f"[kernel] ternary_matmul {name:6s} M={m} K={k} N={n} "
              f"{str(dt).split('.')[-1]}: max_abs_err={err:.3e} "
              f"max_rel_err={rel:.3e} (tol rtol={tol['rtol']} atol={tol['atol']}) "
              f"kernel={ms:.4f}ms (wall {ms_wall:.4f}) plain={plain_ms:.4f}ms "
              f"library(matmul)={lib_ms:.4f}ms (wall {lib_wall:.4f}) "
              f"bound={max(b_bytes, b_ops):.4f}ms "
              f"({'bytes' if b_bytes >= b_ops else 'operations'}) x{per_tick}/tick",
              flush=True)
        tot["ms"] += per_tick * ms
        tot["plain_ms"] += per_tick * plain_ms
        tot["library_ms"] += per_tick * lib_ms
        bytes_tick += per_tick * nbytes
        bytes_bound_tick += per_tick * b_bytes
        ops_bound_tick += per_tick * b_ops
        tot["bound_ms"] += per_tick * max(b_bytes, b_ops)
    print(f"[kernel] ternary_matmul per tick: {bytes_tick / 1e6:.1f} MB, "
          f"bytes bound {bytes_bound_tick:.4f} ms, operations bound "
          f"{ops_bound_tick:.4f} ms", flush=True)
    return {"name": "ternary_matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ternary_matmul.cu",
            "replaces": "src/repro/kernels/ternary_matmul/ternary_matmul.py:65",
            "max_abs_err": max_err,
            "bound_by": "bytes" if bytes_bound_tick >= ops_bound_tick else "operations",
            "per": f"one full-width decode tick at {SLOTS} slots "
                   f"({6 * cfg.num_layers + 1} launches)",
            **tot}


def bench_paged_decode(torch, cfg):
    """Kernel #2 at the decode tick's shape; returns its JSON entry."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.flash_decode.paged import paged_flash_decode_ref
    from repro_torch.models.layers import KV_CACHE_SCALE

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    hkv, hq, d = cfg.num_kv_heads, cfg.num_heads, cfg.head_dim
    n_pages = SLOTS * (MAX_LEN // PAGE)
    lengths_l = [37, 100, 0, 180]              # 1, 2, 0 (inactive) and 3 pages
    shape = (n_pages + 1, hkv, PAGE, d)
    n_copies = _copies(2 * n_pages * hkv * PAGE * d)
    pools = [((torch.randn(shape, generator=g, device=dev) * 4)
              .to(torch.float8_e4m3fn),
              (torch.randn(shape, generator=g, device=dev) * 4)
              .to(torch.float8_e4m3fn)) for _ in range(n_copies)]
    n_p = 4
    tables = torch.full((SLOTS, n_p), n_pages, dtype=torch.int32)
    perm = torch.randperm(n_pages, generator=torch.Generator().manual_seed(3))
    used = 0
    for b, ln in enumerate(lengths_l):
        k = -(-ln // PAGE)
        tables[b, :k] = perm[used:used + k].to(torch.int32)
        used += k
    tables, lengths = tables.to(dev), torch.tensor(lengths_l, dtype=torch.int32, device=dev)
    q = torch.randn((SLOTS, hq, d), generator=g, device=dev).to(torch.bfloat16)
    kp, vp = pools[0]
    got = fd_ops.paged_decode_attention(q, kp, vp, tables, lengths, KV_CACHE_SCALE)
    want = paged_flash_decode_ref(q.reshape(SLOTS, hkv, -1, d), kp, vp, tables, lengths,
                                  KV_CACHE_SCALE).reshape(SLOTS, hq, d)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    scale_out = want.abs().max().item()
    # f32 sums taken in another order: an error of ~1e-5 of the outputs' scale
    atol = 1e-5 * scale_out
    torch.testing.assert_close(got, want, rtol=1e-5, atol=atol)
    if not torch.isfinite(got).all() or got[2].any():
        raise AssertionError("inactive or live rows not as defined")
    args = [(q, kp_, vp_, tables, lengths, KV_CACHE_SCALE) for kp_, vp_ in pools]
    ms, ms_wall = _time_ms(fd_ops.paged_decode_attention, args,
                           reps=max(50, 2 * n_copies))
    plain_ms, _ = _time_ms(
        lambda q_, kp_, vp_, t_, l_, s_: paged_flash_decode_ref(
            q_.reshape(SLOTS, hkv, -1, d), kp_, vp_, t_, l_, s_), args[:2], reps=10)
    # library yardstick: SDPA on pre-gathered bf16 views of the same pages,
    # as many copies as the kernel's timing cycles through, so neither reads
    # from a warm L2
    s_len = n_p * PAGE
    mask = (torch.arange(s_len, device=dev)[None] < lengths[:, None])[:, None, None, :]
    views = []
    for i in range(_copies(4 * SLOTS * hkv * s_len * d)):
        kp_, vp_ = pools[i % len(pools)]
        kv = [(p[tables.long()].to(torch.bfloat16) * KV_CACHE_SCALE)
              .permute(0, 2, 1, 3, 4).reshape(SLOTS, hkv, s_len, d) for p in (kp_, vp_)]
        views.append((q[:, :, None], kv[0], kv[1]))
    lib_ms, lib_wall = _time_ms(lambda q_, k_, v_: F.scaled_dot_product_attention(
        q_, k_, v_, attn_mask=mask, enable_gqa=True), views, reps=max(50, 2 * len(views)))
    del views
    live = sum(lengths_l)
    nbytes = (q.numel() * q.element_size() + 2 * live * hkv * d + tables.numel() * 4 + SLOTS * 4
              + SLOTS * hq * d * 4)
    ops = 4 * live * hq * d
    b_bytes = nbytes / HBM_BYTES_S * 1e3
    b_ops = ops / PEAK_FLOPS["f32"] * 1e3
    L = cfg.num_layers
    print(f"[kernel] paged_flash_decode B={SLOTS} Hq={hq} Hkv={hkv} D={d} page={PAGE} "
          f"lengths={lengths_l} fp8: max_abs_err={err:.3e} "
          f"max_rel_err={err / max(scale_out, 1e-30):.3e} (tol rtol=1e-05 atol={atol:.3e}) "
          f"kernel={ms:.4f}ms "
          f"(wall {ms_wall:.4f}) plain={plain_ms:.4f}ms library(sdpa)={lib_ms:.4f}ms "
          f"(wall {lib_wall:.4f}) "
          f"bound={max(b_bytes, b_ops):.5f}ms "
          f"({'bytes' if b_bytes >= b_ops else 'operations'}) x{L}/tick", flush=True)
    return {"name": "paged_flash_decode", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_flash_decode.cu",
            "replaces": "src/repro/kernels/flash_decode/paged.py:78",
            "max_abs_err": err, "ms": L * ms, "plain_ms": L * plain_ms,
            "library_ms": L * lib_ms, "bound_ms": L * max(b_bytes, b_ops),
            "bound_by": "bytes" if b_bytes >= b_ops else "operations",
            "per": f"one full-width decode tick at {SLOTS} slots ({L} launches, "
                   f"contexts {lengths_l})"}


def bench_dense_decode(torch, cfg):
    """Kernel #4 at the dense decode tick's shape (4 slots over a cache of
    max_len positions), per-row and scalar lengths; returns its JSON entry."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    from repro_torch.models.layers import KV_CACHE_SCALE

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    hkv, hq, d = cfg.num_kv_heads, cfg.num_heads, cfg.head_dim
    lengths_l = [37, 100, 1, 180]
    shape = (SLOTS, hkv, MAX_LEN, d)
    n_copies = _copies(2 * SLOTS * hkv * MAX_LEN * d)
    caches = [((torch.randn(shape, generator=g, device=dev) * 4).to(torch.float8_e4m3fn),
               (torch.randn(shape, generator=g, device=dev) * 4).to(torch.float8_e4m3fn))
              for _ in range(n_copies)]
    q = torch.randn((SLOTS, hq, d), generator=g, device=dev).to(torch.bfloat16)
    qg = q.reshape(SLOTS, hkv, -1, d)
    lengths = torch.tensor(lengths_l, dtype=torch.int32, device=dev)
    k0, v0 = caches[0]
    errs = {}
    for label, length in (("per-row", lengths), ("scalar", 180)):
        got = fd_ops.decode_attention(q, k0, v0, length, KV_CACHE_SCALE)
        want = flash_decode_ref(qg, k0, v0, length, KV_CACHE_SCALE).reshape(SLOTS, hq, d)
        torch.cuda.synchronize()
        scale_out = want.abs().max().item()
        # f32 sums taken in another order: an error of ~1e-5 of the outputs' scale
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale_out)
        if not torch.isfinite(got).all():
            raise AssertionError(f"flash_decode {label}: non-finite output")
        errs[label] = ((got - want).abs().max().item(), scale_out)
        if label == "per-row":
            # control: every row of more than one position cut to position 0
            cut = flash_decode_ref(qg, k0, v0, torch.ones_like(lengths), KV_CACHE_SCALE)
            moved = (got - cut.reshape(SLOTS, hq, d)).abs().amax(dim=(1, 2)) / scale_out
            ctrl = moved[lengths > 1].min().item()
            if ctrl < CONTROL_MARGIN * 1e-5:
                raise AssertionError(f"flash_decode: cutting the lengths to 1 moves a row by "
                                     f"only {ctrl:.3e} of the output scale")
    args = [(q, k_, v_, lengths, KV_CACHE_SCALE) for k_, v_ in caches]
    ms, ms_wall = _time_ms(fd_ops.decode_attention, args, reps=max(50, 2 * n_copies))
    plain_ms, _ = _time_ms(lambda q_, k_, v_, l_, s_: flash_decode_ref(
        q_.reshape(SLOTS, hkv, -1, d), k_, v_, l_, s_), args[:2], reps=10)
    # library yardstick: SDPA on pre-widened bf16 views of the caches cut to
    # the longest live row (as #2's reads its live pages only), masked at
    # each row's length, in enough copies that none is read from a warm L2
    s_len = max(lengths_l)
    mask = (torch.arange(s_len, device=dev)[None] < lengths[:, None])[:, None, None, :]
    del args
    views = [(q[:, :, None], (k_[:, :, :s_len].to(torch.bfloat16) * KV_CACHE_SCALE),
              (v_[:, :, :s_len].to(torch.bfloat16) * KV_CACHE_SCALE))
             for k_, v_ in (caches[i % len(caches)]
                            for i in range(_copies(4 * SLOTS * hkv * s_len * d)))]
    del caches
    lib_ms, lib_wall = _time_ms(lambda q_, k_, v_: F.scaled_dot_product_attention(
        q_, k_, v_, attn_mask=mask, enable_gqa=True), views, reps=max(50, 2 * len(views)))
    del views
    live = sum(lengths_l)
    nbytes = (q.numel() * q.element_size() + 2 * live * hkv * d + SLOTS * 4
              + SLOTS * hq * d * 4)
    ops = 4 * live * hq * d
    b_bytes = nbytes / HBM_BYTES_S * 1e3
    b_ops = ops / PEAK_FLOPS["f32"] * 1e3
    L = cfg.num_layers
    err, scale_out = errs["per-row"]
    print(f"[kernel] flash_decode B={SLOTS} Hq={hq} Hkv={hkv} D={d} S={MAX_LEN} "
          f"lengths={lengths_l} fp8: max_abs_err={err:.3e} "
          f"max_rel_err={err / scale_out:.3e} (scalar length 180: "
          f"{errs['scalar'][0] / errs['scalar'][1]:.3e}; tol rtol=1e-05 atol=1e-05 of max "
          f"|plain|; cut-to-1 control {ctrl:.3e}) kernel={ms:.4f}ms (wall {ms_wall:.4f}) "
          f"plain={plain_ms:.4f}ms library(sdpa)={lib_ms:.4f}ms (wall {lib_wall:.4f}) "
          f"bound={max(b_bytes, b_ops):.5f}ms ({nbytes} B, {ops} ops: "
          f"{'bytes' if b_bytes >= b_ops else 'operations'}) x{L}/tick", flush=True)
    return {"name": "flash_decode", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
            "replaces": "src/repro/kernels/flash_decode/flash_decode.py:78",
            "max_abs_err": max(e for e, _ in errs.values()), "ms": L * ms,
            "plain_ms": L * plain_ms, "library_ms": L * lib_ms,
            "bound_ms": L * max(b_bytes, b_ops),
            "bound_by": "bytes" if b_bytes >= b_ops else "operations",
            "per": f"one full-width dense decode tick at {SLOTS} slots ({L} launches, "
                   f"contexts {lengths_l} of a {MAX_LEN}-position cache)"}


def bench_batched_lora(torch, cfg):
    """Kernel #3 at the decode tick's q and v shapes (4 slots, rank 8, four
    tenants plus the null slot, one adapter-less row); returns its entry."""
    from repro_torch.core import ternary
    from repro_torch.kernels.batched_lora import ops as bl_ops
    from repro_torch.kernels.batched_lora.ref import batched_lora_ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    k, r, n_stack = cfg.d_model, RANK, TENANTS + 1
    idx_l = [2, 0, 4, 1]
    idx = torch.tensor(idx_l, dtype=torch.int32, device=dev)
    tenants = idx != 0
    distinct = len({i for i in idx_l if i})
    x = torch.randn((SLOTS, k), generator=g, device=dev).to(torch.bfloat16)
    L = cfg.num_layers
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    max_err, bytes_tick, ops_tick = 0.0, 0, 0
    for name, n in (("q", cfg.q_dim), ("v", cfg.kv_dim)):
        def stacks():
            t_a = torch.randint(-1, 2, (n_stack, k, r), generator=g, device=dev)
            t_b = torch.randint(-1, 2, (n_stack, r, n), generator=g, device=dev)
            t_a[0] = 0
            t_b[0] = 0
            s = torch.rand((n_stack,), generator=g, device=dev) * 0.05 + 0.01
            s[0] = 0
            return ternary.pack2(t_a), ternary.pack2(t_b), s
        a, b, s = stacks()
        got = bl_ops.batched_lora(x, a, b, s, idx)
        want = batched_lora_ref(x, a, b, s, idx)
        torch.cuda.synchronize()
        scale_out = want.abs().max().item()
        err = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, rtol=LORA_TOL, atol=LORA_TOL * scale_out)
        if not torch.equal(got[~tenants], torch.zeros_like(got[~tenants])):
            raise AssertionError("batched_lora: a null-adapter row is not exactly 0")
        # control: the right rows for the wrong tenants are off by far more
        wrong = batched_lora_ref(x, a, b, s, torch.where(tenants, idx % TENANTS + 1, idx))
        ctrl = (got - wrong).abs().amax(dim=1)[tenants].min().item() / scale_out
        if ctrl < CONTROL_MARGIN * LORA_TOL:
            raise AssertionError(f"batched_lora: the wrong tenants move a row by only "
                                 f"{ctrl:.3e} of the output scale")
        max_err = max(max_err, err)
        nb_stack = a.numel() + b.numel() + s.numel() * 4
        n_cp = _copies(nb_stack)
        cps = [stacks() for _ in range(n_cp)]
        ms, ms_wall = _time_ms(lambda a_, b_, s_: bl_ops.batched_lora(x, a_, b_, s_, idx),
                               cps, reps=max(50, 2 * n_cp))
        plain_ms, _ = _time_ms(lambda a_, b_, s_: batched_lora_ref(x, a_, b_, s_, idx),
                               cps[:2], reps=10)
        del cps
        # library yardstick: two torch.bmm on f32 stacks pre-unpacked,
        # gathered by idx and pre-scaled (never called by the port)
        il = idx.long()
        xf = x.float()[:, None]
        lib = []
        for _ in range(_copies(SLOTS * (k * r + r * n) * 4)):
            a_, b_, s_ = stacks()
            lib.append((ternary.unpack2(a_[il]).float(),
                        ternary.unpack2(b_[il]).float() * s_[il][:, None, None]))
        lib_ms, lib_wall = _time_ms(lambda af, bf: torch.bmm(torch.bmm(xf, af), bf),
                                    lib, reps=max(50, 2 * len(lib)))
        del lib
        # bytes: x at its own size, the codes and scale of each distinct
        # tenant the batch names, idx, the f32 output
        nbytes = (x.numel() * x.element_size() + distinct * (k // 4 * r + r // 4 * n + 4)
                  + SLOTS * 4 + SLOTS * n * 4)
        ops = int(tenants.sum()) * (2 * k * r + 2 * r * n + n)
        b_bytes, b_ops = nbytes / HBM_BYTES_S * 1e3, ops / PEAK_FLOPS["f32"] * 1e3
        print(f"[kernel] batched_lora {name} B={SLOTS} K={k} r={r} N={n} bf16 x, "
              f"idx={idx_l}: max_abs_err={err:.3e} max_rel_err={err / scale_out:.3e} "
              f"(tol {LORA_TOL} of max |plain| {scale_out:.3e}; wrong-tenant control "
              f"{ctrl:.3e}) kernel={ms:.4f}ms (wall {ms_wall:.4f}) plain={plain_ms:.4f}ms "
              f"library(2x bmm)={lib_ms:.4f}ms (wall {lib_wall:.4f}) "
              f"bound={max(b_bytes, b_ops):.6f}ms ({nbytes} B, {ops} ops: "
              f"{'bytes' if b_bytes >= b_ops else 'operations'}) x{L}/tick", flush=True)
        tot["ms"] += L * ms
        tot["plain_ms"] += L * plain_ms
        tot["library_ms"] += L * lib_ms
        tot["bound_ms"] += L * max(b_bytes, b_ops)
        bytes_tick += L * nbytes
        ops_tick += L * ops
    b_bytes, b_ops = bytes_tick / HBM_BYTES_S * 1e3, ops_tick / PEAK_FLOPS["f32"] * 1e3
    return {"name": "batched_lora", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/batched_lora.cu",
            "replaces": "src/repro/kernels/batched_lora/batched_lora.py:43",
            "max_abs_err": max_err,
            "bound_by": "bytes" if b_bytes >= b_ops else "operations",
            "per": f"one full-width decode tick at {SLOTS} slots ({2 * L} launches, "
                   f"rank {r}, idx {idx_l})",
            **tot}


def _watch_logits(model):
    """Wrap ``model.decode_step`` to keep every tick's logits finite-check
    (on the device, no sync) and the top-2 values of each row. ``del
    model.decode_step`` removes the wrapper."""
    import torch
    state = {"finite": torch.ones((), dtype=torch.bool, device=model.device),
             "top2": []}
    inner = model.decode_step

    def decode_step(p, kv, tokens, pos, adapter_idx=None):
        logits, kv = inner(p, kv, tokens, pos, adapter_idx)
        state["finite"] &= torch.isfinite(logits).all()
        state["top2"].append(logits.topk(2, dim=-1))
        return logits, kv

    model.decode_step = decode_step
    return state


def _launch_counters():
    from repro_torch.kernels.batched_lora import ops as bl_ops
    from repro_torch.kernels.flash_decode import flash_decode as fd_dense
    from repro_torch.kernels.flash_decode import paged as fd_paged
    from repro_torch.kernels.ternary_matmul import ops as tm_ops
    return {"ternary_matmul": tm_ops.launches, "paged_flash_decode": fd_paged.launches,
            "batched_lora": bl_ops.launches, "flash_decode": fd_dense.launches}


def serve(torch, cfg, eng, path: str, tenants=None):
    """Phase 4: full-width serving through the kernels, 8 greedy requests
    (``tenants[i]`` names request i's adapter). Returns (launches, mean
    tick ms)."""
    from repro_torch.serving.api import RequestSpec
    import numpy as np

    watch = _watch_logits(eng.model)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, size=int(n))]
               for n in rng.integers(12, 33, size=8)]
    tenants = tenants or [None] * len(prompts)
    # warm-up request (first launches, allocator), not counted
    eng.submit(prompts[0][:4], RequestSpec(max_new_tokens=2, adapter_id=tenants[0]))
    eng.run_until_drained()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ticks0 = eng.stats.ticks
    counters = _launch_counters()
    for c in counters.values():
        c.n = 0
    ad = eng.adapters
    t0 = time.perf_counter()
    reqs = [eng.submit(p, RequestSpec(max_new_tokens=16, adapter_id=t))
            for p, t in zip(prompts, tenants)]
    while any(r.state in ("queued", "running") for r in reqs):
        if eng.stats.ticks - ticks0 > 4096:
            raise AssertionError(f"{path}: requests still pending after 4096 ticks")
        eng.tick()
        if ad is not None:
            # the budget holds, and every running tenant is resident and pinned
            if ad.cache.bytes_used > ad.cache.budget_bytes:
                raise AssertionError(f"adapter bytes {ad.cache.bytes_used} over budget")
            for r, key in zip(eng.slot_req, eng.slot_adapter_key):
                if r is not None and r.adapter_id is not None and not (
                        key is not None and ad.cache.is_resident(key)
                        and ad.cache.pinned(key)):
                    raise AssertionError(f"{r.adapter_id} in flight but not pinned")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: c.n for name, c in counters.items()}
    ticks = eng.stats.ticks - ticks0
    del eng.model.decode_step
    if not all(r.state == "done" and len(r.output) == 16 for r in reqs):
        raise AssertionError("not every request completed with 16 tokens")
    if not bool(watch["finite"]):
        raise AssertionError("non-finite logits during serving")
    dense = eng.kv.name == "dense"
    per_tick = {"ternary_matmul": 6 * cfg.num_layers + 1,
                "paged_flash_decode": 0 if dense else cfg.num_layers,
                "flash_decode": cfg.num_layers if dense else 0,
                "batched_lora": 0 if ad is None else 2 * cfg.num_layers}
    for name, n in per_tick.items():
        if launches[name] != n * ticks:
            raise AssertionError(f"{path}: {name}: {launches[name]} launches in {ticks} "
                                 f"ticks, expected {n} per tick")
    tokens = sum(len(r.output) for r in reqs)
    ttft = sorted(r.ttft_s for r in reqs)
    out = {"path": path, "kv": eng.kv.name, "requests": len(reqs), "tokens": tokens,
           "ticks": ticks,
           "wall_s": wall, "tps": tokens / wall,
           "tick_ms_mean": wall / ticks * 1e3,
           "ttft_p50_ms": float(np.median(ttft)) * 1e3,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches,
           "launches_per_tick": {k: v / ticks for k, v in launches.items()}}
    if ad is not None:
        st = ad.stats()
        if st["evictions"] < 1 or st["pinned"] != 0:
            raise AssertionError(f"adapter cache: {st} (want evictions, no pins left)")
        out["adapters"] = st
    print("[serve]", json.dumps(out), flush=True)
    return launches, out["tick_ms_mean"]


def profile_ticks(torch, eng, tick_ms: float, path: str, tenants=None,
                  n_ticks: int = 10):
    """Where a steady decode tick's time goes: ``torch.profiler`` (device
    activity only) over ``n_ticks`` ticks of 4 busy slots (``tenants[i]``
    the adapter of slot i's request); device time by kernel, and its share
    of ``tick_ms``, the unprofiled mean tick wall of phase 4."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.api import RequestSpec

    tenants = tenants or [None] * SLOTS
    for i in range(SLOTS):
        eng.submit([100 + i, 7, 8, 9], RequestSpec(max_new_tokens=n_ticks + 8,
                                                   adapter_id=tenants[i]))
    for _ in range(3):
        eng.tick()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n_ticks):
            eng.tick()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    eng.run_until_drained()

    def dev_us(e):
        return e.self_device_time_total

    # kernel events only: a CPU op's device time repeats its kernels' time
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in events)
    top = [{"name": e.key[:60], "calls": e.count, "device_ms_per_tick": dev_us(e) / n_ticks / 1e3}
           for e in events[:8] if dev_us(e) > 0]
    print("[profile]", json.dumps({
        "path": path, "ticks": n_ticks,
        "profiled_wall_ms_per_tick": wall_us / n_ticks / 1e3,
        "device_busy_ms_per_tick": busy / n_ticks / 1e3,
        "device_busy_share_of_unprofiled_tick": (busy / n_ticks / 1e3 / tick_ms
                                                 if busy else "not measured"),
        "top_device": top}), flush=True)


def _stepwise_watch(torch, model, cfg):
    """Wrap the kernel model's ``decode_step``: before each step, walk its
    layers from the kernel path's own activations and run each attention
    block (on a copy of that layer's pools or dense cache) and each FFN
    block through the kernels and through the plain versions on the same
    input and adapter index; then the logits of the final hidden state both
    ways. As a control, the plain attention also runs with every live
    length cut to 1 (position 0 only). Live rows are those of non-zero
    length (paged); under a dense cache every row is live, an idle slot
    attending its own position 0. With an adapter index, the targeted
    projections (where kernel #3 adds its term) are held the same way, and
    two more runs of each projection and attention block: the plain path
    with every index 0 (a control: how far the tenants' LoRA terms move
    their rows) and the kernel path without adapters (null rows must equal
    it bit for bit). The walk's kernel logits must equal the real step's
    bit for bit, which ties it to ``Model.decode_step``. Keeps, per tick,
    the largest relative differences and the smallest relative control
    changes over layers (for the adapter control on attention blocks, per
    tenant row its largest change over layers, beside the smallest in any
    layer)."""
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import layers
    from repro_torch.models.transformer import Model

    plain = Model(cfg, device=model.device, plain=True)
    inner = model.decode_step
    rows = []

    def rel(a, b):
        return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()

    def lengths_of(kv, pos):
        return kv.lengths if isinstance(kv, attn_mod.PagedKVState) else pos + 1

    def attend(kv, i, lp, h, pos, name, is_plain, idx):
        """One layer's attention block on a copy of its KV state; ``cut``
        reads position 0 only."""
        if isinstance(kv, attn_mod.PagedKVState):
            lengths = torch.clamp(kv.lengths, max=1) if name == "cut" else kv.lengths
            return attn_mod.gqa_decode_paged(
                lp["attn"], h, kv.k_pool[i].clone(), kv.v_pool[i].clone(), kv.tables,
                kv.write_page, kv.write_off, lengths, pos, cfg, plain=is_plain,
                adapter_idx=idx)
        k_l, v_l = kv["k"][i].clone(), kv["v"][i].clone()
        if name == "cut":
            return _dense_attention_cut(lp["attn"], h, k_l, v_l, pos, cfg, idx)
        return attn_mod.gqa_decode_dense(lp["attn"], h, k_l, v_l, lengths_of(kv, pos), pos,
                                         cfg, plain=is_plain, adapter_idx=idx)

    def walk(p, kv, tokens, pos, aidx):
        lengths = lengths_of(kv, pos)
        live = lengths > 0
        row = {"min_len": int(lengths[live].min()), "attn": 0.0, "ffn": 0.0,
               "control": float("inf")}
        runs = [("kernel", False, aidx), ("plain", True, aidx), ("cut", True, aidx)]
        if aidx is not None:
            tenant, null = live & (aidx != 0), live & (aidx == 0)
            runs += [("zero", True, torch.zeros_like(aidx)), ("none", False, None)]
            row.update(proj=0.0, null_equal=True)
            targets = [t for t in ("q", "k", "v", "o") if "lora_mt" in p["layers"][0]["attn"][t]]
            moved_blocks = []
        x = layers.embed_tokens(p["embed"], tokens, model.dtype)
        for i, lp in enumerate(p["layers"]):
            h = layers.rms_norm(x, lp["norm1"]["w"], cfg.norm_eps)
            if aidx is not None:
                for t in targets:
                    if t == "o":
                        continue   # its input is the attention output, held below
                    pr = {name: layers.apply_linear(lp["attn"][t], h, plain=is_plain,
                                                    adapter_idx=idx)
                          for name, is_plain, idx in runs if name != "cut"}
                    row["proj"] = max(row["proj"], rel(pr["kernel"][live], pr["plain"][live]))
                    scale = pr["plain"][live].float().abs().max()
                    if bool(tenant.any()):
                        moved = ((pr["zero"] - pr["plain"]).float().abs().amax(dim=1)[tenant]
                                 / scale)
                        row["proj_control"] = min(row.get("proj_control", float("inf")),
                                                  moved.min().item())
                    row["null_equal"] &= bool(torch.equal(pr["kernel"][null],
                                                          pr["none"][null]))
            out = {name: attend(kv, i, lp, h, pos, name, is_plain, idx)
                   for name, is_plain, idx in runs}
            row["attn"] = max(row["attn"], rel(out["kernel"][live], out["plain"][live]))
            row["control"] = min(row["control"], rel(out["cut"][live], out["plain"][live]))
            if aidx is not None and bool(tenant.any()):
                # each tenant row's change, over the live rows' scale
                moved_blocks.append(
                    (out["zero"] - out["plain"]).float().abs().amax(dim=1)[tenant]
                    / out["plain"][live].float().abs().max())
            if aidx is not None:
                row["null_equal"] &= bool(torch.equal(out["kernel"][null],
                                                      out["none"][null]))
            full = torch.zeros_like(x)
            full[live] = out["kernel"][live]
            x = x + full
            h2 = layers.rms_norm(x, lp["norm2"]["w"], cfg.norm_eps)
            f = layers.apply_ffn(lp["ffn"], h2, cfg.ffn_kind, adapter_idx=aidx)
            f_plain = layers.apply_ffn(lp["ffn"], h2, cfg.ffn_kind, plain=True,
                                       adapter_idx=aidx)
            row["ffn"] = max(row["ffn"], rel(f[live], f_plain[live]))
            x = x + f
        if aidx is not None and moved_blocks:
            moved = torch.stack(moved_blocks)          # (layers, tenant rows)
            # the block check holds every layer, so a wrong kernel shows in
            # the layer where the LoRA terms move a tenant row most: the gate
            # reads, per tenant row, its largest change over the tick's
            # layers; the smallest change in any one layer is only reported
            row["attn_control_best_layer"] = moved.amax(dim=0).min().item()
            row["attn_control_any_layer"] = moved.min().item()
        x = layers.rms_norm(x, p["final_norm"]["w"], cfg.norm_eps)
        logits = model._logits(p, x)
        row["logits"] = rel(logits[live, :cfg.vocab_size],
                            plain._logits(p, x)[live, :cfg.vocab_size])
        return logits, row

    def decode_step(p, kv, tokens, pos, adapter_idx=None):
        walked, row = walk(p, kv, tokens, pos, adapter_idx)
        live = lengths_of(kv, pos) > 0
        logits, kv = inner(p, kv, tokens, pos, adapter_idx)
        row["walk_is_step"] = bool(torch.equal(walked[live], logits[live]))
        rows.append(row)
        return logits, kv

    model.decode_step = decode_step
    return rows


def _dense_attention_cut(p, x, k_l, v_l, pos, cfg, adapter_idx):
    """``gqa_decode_dense``'s plain path with attention cut to position 0 of
    every row (the walk's control): the same projections and cache write,
    then the plain attention over one position."""
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import layers

    b = x.shape[0]
    q, k_new, v_new = attn_mod._project_qkv(p, x[:, None], cfg, pos[:, None], plain=True,
                                            adapter_idx=adapter_idx)
    for cache, new in ((k_l, k_new), (v_l, v_new)):
        attn_mod.write_positions(cache, pos, attn_mod.kv_encode(new[:, 0], cache.dtype))
    out = flash_decode_ref(q[:, 0].reshape(b, cfg.num_kv_heads, -1, cfg.head_dim), k_l, v_l,
                           1, layers.KV_CACHE_SCALE)
    return layers.apply_linear(p["o"], out.reshape(b, cfg.q_dim).to(x.dtype), plain=True,
                               adapter_idx=adapter_idx)


def _check_walk(rows, path: str, extra=()):
    """Print the walk's worst values and fail on any bound it misses."""
    keys = ("min_len", "attn", "ffn", "logits", "control") + tuple(extra)
    worst = {k: max(r[k] for r in rows) for k in ("attn", "ffn", "logits")}
    # the attention control is read where every live slot has more than one
    # position
    ctrl = min(r["control"] for r in rows if r["min_len"] > 1)
    report = {"path": path, "ticks": len(rows), "max_rel_err": worst,
              "tol": {"attn": BLOCK_TOL, "ffn": BLOCK_TOL, "logits": LOGITS_TOL},
              "min_control_rel_change": ctrl, "control_margin": CONTROL_MARGIN,
              "walk_is_step": all(r["walk_is_step"] for r in rows)}
    if "proj_control" in extra:
        with_t = [r for r in rows if "proj_control" in r]
        report["max_rel_err"]["proj"] = max(r["proj"] for r in rows)
        report["tol"]["proj"] = BLOCK_TOL
        # gated: every layer's projections; each tenant row's attention
        # block in its most-moved layer. Reported only: the weakest layer's
        # attention block
        report["min_proj_control_rel_change_every_layer"] = min(
            r["proj_control"] for r in with_t)
        report["min_attn_control_rel_change_best_layer"] = min(
            r["attn_control_best_layer"] for r in with_t)
        report["min_attn_control_rel_change_any_layer"] = min(
            r["attn_control_any_layer"] for r in with_t)
        report["null_rows_equal_no_adapter"] = all(r["null_equal"] for r in rows)
    report["per_tick"] = [{k: r[k] for k in keys if k in r} for r in rows]
    print("[identity] stepwise", json.dumps(report), flush=True)
    if not report["walk_is_step"]:
        raise AssertionError("the stepwise walk's logits differ from Model.decode_step's")
    for k, tol in (("attn", BLOCK_TOL), ("ffn", BLOCK_TOL), ("logits", LOGITS_TOL)):
        if worst[k] > tol:
            raise AssertionError(f"{path}: {k}: kernel path differs from the plain path on "
                                 f"the same input by {worst[k]:.3e} of its scale (tol {tol})")
    if ctrl < CONTROL_MARGIN * BLOCK_TOL:
        raise AssertionError(f"attention over one position moved an attention block by "
                             f"only {ctrl:.3e} of its scale: the tolerance {BLOCK_TOL} "
                             f"could not see a wrong attention kernel")
    if "proj_control" in extra:
        if report["max_rel_err"]["proj"] > BLOCK_TOL:
            raise AssertionError(f"{path}: a targeted projection differs from the plain "
                                 f"path by {report['max_rel_err']['proj']:.3e} of its scale")
        for key, what in (("min_proj_control_rel_change_every_layer",
                           "targeted projection in some layer"),
                          ("min_attn_control_rel_change_best_layer",
                           "attention block, in the layer where it moved most,")):
            if report[key] < CONTROL_MARGIN * BLOCK_TOL:
                raise AssertionError(
                    f"dropping the tenants' LoRA terms moved a tenant row's {what} by only "
                    f"{report[key]:.3e}: the tolerance {BLOCK_TOL} could not see a wrong "
                    f"batched-LoRA kernel")
        if not report["null_rows_equal_no_adapter"]:
            raise AssertionError("an adapter-less row differs from the engine without "
                                 "adapters")


def _greedy_agree(a_out, b_out, a_top2, prompts, what: str):
    """Greedy tokens of two runs of the same requests must be equal, except
    where they part at a near-tie of run a's top-2 logits (reported)."""
    report = []
    for r, (a, b) in enumerate(zip(a_out, b_out)):
        if a == b:
            continue
        j = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        # tick of the j-th emission of slot r: its prompt ticks, then j more
        tick = len(prompts[r]) - 1 + j
        vals = a_top2[tick].values[r]
        gap = (vals[0] - vals[1]).item()
        report.append({"request": r, "step": j, "top2_gap": gap})
        if gap >= TIE_TOL:
            raise AssertionError(f"{what}: greedy tokens diverge at request {r} step {j} "
                                 f"without a near-tie (gap {gap:.4f}): {a} vs {b}")
    print("[identity] greedy", json.dumps({"compared": what, "tokens": [a_out, b_out],
                                           "near_ties": report, "tie_tol": TIE_TOL}),
          flush=True)


def identity(torch, cfg, params):
    """Phase 5: kernels vs plain versions at full width, over the paged pool
    and over the dense cache; then the dense and paged kernel paths' greedy
    tokens against each other."""
    from repro_torch.models.transformer import Model
    from repro_torch.serving.api import RequestSpec
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.kv import DenseKV, PagedKV

    prompts = [[11, 2024, 7, 99, 5012, 3, 870, 41, 12, 9, 1000, 77],
               [5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20]]
    kernel_runs = {}
    for kind in ("paged", "dense"):
        runs = []
        for plain in (False, True):
            model = Model(cfg, device="cuda", plain=plain)
            watch = _watch_logits(model)
            rows = None if plain else _stepwise_watch(torch, model, cfg)
            kv = PagedKV(page=PAGE) if kind == "paged" else DenseKV()
            eng = ServeEngine(model, params, max_slots=2, max_len=MAX_LEN, seed=0, kv=kv)
            reqs = [eng.submit(p, RequestSpec(max_new_tokens=8)) for p in prompts]
            eng.run_until_drained()
            runs.append(([r.output for r in reqs], watch["top2"], rows))
            del eng
        (k_out, k_top2, rows), (p_out, _, _) = runs
        # every block and the logits on the same input and state, every tick
        _check_walk(rows, kind)
        # greedy tokens of the two paths, each run on its own
        _greedy_agree(k_out, p_out, k_top2, prompts, f"{kind}: kernel vs plain")
        kernel_runs[kind] = (k_out, k_top2)
    _greedy_agree(kernel_runs["dense"][0], kernel_runs["paged"][0], kernel_runs["dense"][1],
                  prompts, "kernel path: dense vs paged")


def identity_adapters(torch, cfg, params):
    """Phase 5, multi-tenant: the per-layer walk on the adapter engine, three
    requests (two tenants and one without) sharing every tick."""
    from repro_torch.launch.serve import build_adapters
    from repro_torch.models.transformer import Model
    from repro_torch.serving.api import RequestSpec
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.kv import PagedKV

    model = Model(cfg, device="cuda")
    serving = build_adapters(model, TENANTS, rank=RANK, slots=3, seed=0)
    rows = _stepwise_watch(torch, model, cfg)
    eng = ServeEngine(model, params, max_slots=3, max_len=MAX_LEN, seed=0,
                      kv=PagedKV(page=PAGE), adapters=serving)
    jobs = [([11, 2024, 7, 99, 5012, 3, 870, 41, 12, 9], "tenant-0"),
            ([5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16], None),
            ([300, 301, 302, 303, 304, 305, 306, 307], "tenant-3")]
    reqs = [eng.submit(p, RequestSpec(max_new_tokens=8, adapter_id=t)) for p, t in jobs]
    eng.run_until_drained()
    if not all(r.state == "done" for r in reqs):
        raise AssertionError("adapter identity requests did not complete")
    _check_walk(rows, "adapters", extra=("proj", "proj_control", "attn_control_best_layer",
                                         "attn_control_any_layer", "null_equal"))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        return _fail("no CUDA device: the port's smoke run needs the card")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        return _fail(f"no port sources under {SRC}: run from a checkout")
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(f"[device] {kind} x{count}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; python {sys.version.split()[0]}", flush=True)

    # 2. build
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build(["ternary_matmul", "paged_flash_decode", "batched_lora", "flash_decode"])
    print(f"[build] nvcc sm_90a, four sources in parallel: "
          f"{time.perf_counter() - t0:.1f}s {_build.BUILD_SECONDS}", flush=True)
    for name, log in _build.PTXAS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)

    from repro_torch.configs import get_config, reduce_config
    from repro_torch.launch.serve import build_adapters
    from repro_torch.models.transformer import Model
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.kv import DenseKV, PagedKV

    cfg = reduce_config(get_config("bitnet-2b"), "full")

    # 3. kernels against their plain versions, timed
    kernels = [bench_ternary_matmul(torch, cfg), bench_paged_decode(torch, cfg),
               bench_batched_lora(torch, cfg), bench_dense_decode(torch, cfg)]
    torch.cuda.empty_cache()

    # 4. full-width serving through the kernels
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    print(f"[init] bitnet-2b full width, seeded random weights: "
          f"{time.perf_counter() - t0:.1f}s, "
          f"{torch.cuda.memory_allocated() / 1e6:.1f} MB on the card", flush=True)
    # a. no adapters
    engine = ServeEngine(model, params, max_slots=SLOTS, max_len=MAX_LEN, seed=0,
                         kv=PagedKV(page=PAGE))
    by_path = {}
    by_path["paged"], tick_ms = serve(torch, cfg, engine, "paged")
    profile_ticks(torch, engine, tick_ms, "paged")
    del engine
    # b. multi-tenant: 6 of 8 requests name one of 4 tenants, budget 2
    serving = build_adapters(model, TENANTS, rank=RANK, slots=SLOTS, seed=0)
    per_adapter = serving.registry.get("tenant-0").nbytes
    if serving.cache.budget_bytes != BUDGET_TENANTS * per_adapter:
        raise AssertionError(f"budget {serving.cache.budget_bytes} B is not "
                             f"{BUDGET_TENANTS} tenants of {per_adapter} B")
    engine = ServeEngine(model, params, max_slots=SLOTS, max_len=MAX_LEN, seed=0,
                         kv=PagedKV(page=PAGE), adapters=serving)
    tenants = ["tenant-0", None, "tenant-1", "tenant-2", None, "tenant-3",
               "tenant-0", "tenant-2"]
    by_path["adapters"], tick_ms = serve(torch, cfg, engine, "adapters", tenants)
    profile_ticks(torch, engine, tick_ms, "adapters",
                  ["tenant-0", None, "tenant-1", "tenant-0"])
    del engine, serving
    # c. the dense fp8 cache (the engine's default backend): kernel #4 in
    # place of kernel #2
    engine = ServeEngine(model, params, max_slots=SLOTS, max_len=MAX_LEN, seed=0,
                         kv=DenseKV())
    by_path["dense"], tick_ms = serve(torch, cfg, engine, "dense")
    profile_ticks(torch, engine, tick_ms, "dense")
    del engine
    torch.cuda.empty_cache()

    # 5. identity between the kernel and plain paths
    identity(torch, cfg, params)
    identity_adapters(torch, cfg, params)

    for entry in kernels:
        main_path = "dense" if entry["name"] == "flash_decode" else "adapters"
        entry["launches"] = by_path[main_path][entry["name"]]
        entry["launches_by_path"] = {p: n[entry["name"]] for p, n in by_path.items()}
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
