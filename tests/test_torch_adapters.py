"""The port's multi-tenant ternary-LoRA slice (``repro_torch.core.qlora``,
``kernels/batched_lora``, ``serving/adapters``, the adapter path of the
model and engine) against ``repro``'s, on the tiny bitnet-2b preset.

Oracles are the reference's primitives: ``freeze_adapter``, the registry's
packs, ``batched_lora_ref`` (not the interpret-mode Pallas kernel, which
misses it by 7e-5 here), ``AdapterCache`` and ``Model.decode_step`` on
``AdapterServing.install``-ed params, run op by op (``jax.disable_jit()``,
see ``test_torch_model.py``). Engine contracts are held inside the port.

The absmean scale of a frozen adapter sums its ~1e3-1e4 terms in another
order than XLA's CPU reduction (a tree of 32-wide reduce-windows), so it may
differ from the reference's by a few f32 ulps (4 at most in these tests,
~3e-7 relative; as in ``test_torch_ternary.py``); codes are bit-exact.
The decode-step comparison gives both sides the reference's adapter bytes
(``convert.adapter_stacks_from_jax``)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.core import qlora as jq
from repro.kernels.batched_lora.ref import batched_lora_ref as j_blora_ref
from repro.launch.train import reduce_config as j_reduce_config
from repro.models import attention as jattn
from repro.models.transformer import Model as JModel
from repro.serving import adapters as jad
from repro.serving.api import RequestSpec as JRequestSpec
from repro.serving.engine import ServeEngine as JServeEngine
from repro.serving.kv import PagedKV as JPagedKV
from repro_torch.configs import get_config, reduce_config
from repro_torch.convert import adapter_stacks_from_jax, params_from_jax
from repro_torch.core import qlora
from repro_torch.kernels.batched_lora import ops as blora_ops
from repro_torch.kernels.batched_lora.ref import batched_lora_ref
from repro_torch.launch import serve as serve_cli
from repro_torch.models import attention as tattn
from repro_torch.models.transformer import Model
from repro_torch.serving import adapters as ad
from repro_torch.serving.adapters.runtime import install_stacks
from repro_torch.serving.api import RequestSpec
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.kv import PagedKV

# one intra-op thread per process: the suite runs several pytest workers
# on a few cores, and torch's default pool (a thread per core) in each of
# them oversubscribes the CPU many times over
torch.set_num_threads(1)

SPEC = ad.AdapterSpec(rank=8, alpha=16.0, targets=("q", "v"))
J_SPEC = jad.AdapterSpec(rank=8, alpha=16.0, targets=("q", "v"))
#: logits: f32 sums in another order than XLA's, after identical bf16 steps
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)


def _tenant_stacks(cfg, n=4, seed=7):
    rng = np.random.default_rng(seed)
    return [ad.synthetic_adapter_stacks(rng, cfg, SPEC, cfg.num_layers, scale=0.05)
            for _ in range(n)]


@pytest.fixture(scope="module")
def tiny():
    """Reference and port model on the same params, and one port registry
    of four tenants (rank 8, alpha 16, on q and v)."""
    jcfg = j_reduce_config(j_get_config("bitnet-2b"), "tiny")
    jmodel = JModel(jcfg, mode="serve", paged_attn="kernel")
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = reduce_config(get_config("bitnet-2b"), "tiny")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    registry = ad.AdapterRegistry(SPEC)
    for i, st in enumerate(_tenant_stacks(cfg)):
        registry.register(f"tenant-{i}", st)
    return jmodel, jparams, Model(cfg, device="cpu"), params, registry


def _serving(model, registry, *, budget_adapters=4, max_resident=4):
    nbytes = registry.get("tenant-0").nbytes
    return ad.AdapterServing(model, registry, budget_bytes=nbytes * budget_adapters,
                             max_resident=max_resident)


def _assert_scales_close(got, want):
    """f32 sums in another order (a wrong scale, e.g. a mean that skips the
    K padding, is off by >1e-3)."""
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=1e-6, atol=0)


# -- core/qlora --------------------------------------------------------------------


@pytest.mark.parametrize("k,r,n", [(320, 8, 256), (64, 16, 128), (30, 8, 40)])
def test_freeze_adapter_matches_reference(k, r, n):
    """Codes bit-exact (K = 30 pads to 32 in both); scales to f32 rounding."""
    rng = np.random.default_rng(k + n)
    a = rng.normal(size=(k, r)).astype(np.float32)
    b = (rng.normal(size=(r, n)) * 0.05).astype(np.float32)
    want = jq.freeze_adapter({"a": jnp.asarray(a), "b": jnp.asarray(b)})
    got = qlora.freeze_adapter({"a": torch.from_numpy(a), "b": torch.from_numpy(b)})
    for name in ("a", "b"):
        np.testing.assert_array_equal(got[name].packed.numpy(),
                                      np.asarray(want[name].packed))
        _assert_scales_close(got[name].scale.numpy(), want[name].scale)
    spec = qlora.LoRASpec(rank=r, alpha=2.0 * r)
    assert spec.scaling == jq.LoRASpec(rank=r, alpha=2.0 * r).scaling == 2.0
    assert qlora.adapter_bytes(k, n, spec) == jq.adapter_bytes(k, n, jq.LoRASpec(rank=r))


# -- serving/adapters: registry --------------------------------------------------------


def test_registry_packs_match_reference(tiny):
    """The same float masters through both registries: identical codes,
    scales to f32 rounding, equal ``nbytes`` (= the packed sizes), versions."""
    _, _, model, _, _ = tiny
    cfg = model.cfg
    reg, jreg = ad.AdapterRegistry(SPEC), jad.AdapterRegistry(J_SPEC)
    for i, st in enumerate(_tenant_stacks(cfg, n=2, seed=3)):
        got, want = reg.register("t", st), jreg.register("t", st)
        assert (got.version, got.n_layers, got.nbytes) == (want.version, want.n_layers,
                                                          want.nbytes) == (i + 1, 3, want.nbytes)
        actual = 0
        for target in SPEC.targets:
            for key in ("a_codes", "b_codes"):
                np.testing.assert_array_equal(got.packs[target][key],
                                              want.packs[target][key])
            for key in ("a_scale", "b_scale"):
                _assert_scales_close(got.packs[target][key], want.packs[target][key])
            actual += sum(v.nbytes for v in got.packs[target].values())
        assert got.nbytes == actual
    assert reg.get("t", version=1).version == 1 and reg.get("t").version == 2
    assert ad.target_dims(cfg, "q") == jad.target_dims(cfg, "q") == (320, 256)
    with pytest.raises(KeyError):
        reg.get("t", version=3)
    with pytest.raises(ValueError):
        ad.AdapterRegistry(ad.AdapterSpec(rank=6))
    with pytest.raises(ValueError):
        reg.register("partial", {"q": st["q"]})


def test_synthetic_stacks_draw_like_reference(tiny):
    """One seed gives both packages the same tenants."""
    cfg = tiny[2].cfg
    got = ad.synthetic_adapter_stacks(np.random.default_rng(5), cfg, SPEC, 3)
    want = jad.synthetic_adapter_stacks(np.random.default_rng(5), cfg, J_SPEC, 3)
    for t in SPEC.targets:
        for k in ("a", "b"):
            np.testing.assert_array_equal(got[t][k], want[t][k])


def test_register_from_params_matches_reference():
    """train → freeze → register from a qlora-shaped tree (stacked over
    layers, numpy leaves): the same stacks and codes as the reference."""
    rng = np.random.default_rng(11)
    tree = {"layers": {"attn": {t: {"lora": {
        "a": rng.normal(size=(2, 64, 8)).astype(np.float32),
        "b": rng.normal(size=(2, 8, 32)).astype(np.float32)}} for t in ("q", "v")}}}
    got = ad.lora_stacks_from_params(tree, SPEC)
    want = jad.lora_stacks_from_params(tree, J_SPEC)
    for t in SPEC.targets:
        for k in ("a", "b"):
            np.testing.assert_array_equal(got[t][k], want[t][k])
    e = ad.register_from_params(ad.AdapterRegistry(SPEC), tree, "x")
    je = jad.register_from_params(jad.AdapterRegistry(J_SPEC), tree, "x")
    assert e.nbytes == je.nbytes
    np.testing.assert_array_equal(e.packs["v"]["b_codes"], je.packs["v"]["b_codes"])
    with pytest.raises(KeyError):
        ad.lora_stacks_from_params({"layers": {"attn": {}}}, SPEC)


# -- kernels/batched_lora: the plain version ---------------------------------------------


def _stacks(n_adapters, k, r, n, seed=0):
    """Adapter stacks frozen by the reference (slot 0 the null adapter)."""
    g = np.random.default_rng(seed)
    a_codes = np.zeros((n_adapters, k // 4, r), np.uint8)
    b_codes = np.zeros((n_adapters, r // 4, n), np.uint8)
    scales = np.zeros((n_adapters,), np.float32)
    for i in range(1, n_adapters):
        frozen = jq.freeze_adapter({"a": jnp.asarray(g.normal(size=(k, r)), jnp.float32),
                                    "b": jnp.asarray(g.normal(size=(r, n)), jnp.float32)})
        a_codes[i] = np.asarray(frozen["a"].packed)
        b_codes[i] = np.asarray(frozen["b"].packed)
        scales[i] = float(frozen["a"].scale) * float(frozen["b"].scale) * 2.0
    return a_codes, b_codes, scales


def _both(x, a, b, s, idx):
    want = np.asarray(j_blora_ref(*map(jnp.asarray, (x, a, b, s, idx))))
    t = [torch.from_numpy(v) for v in (x, a, b, s, idx)]
    return batched_lora_ref(*t).numpy(), blora_ops.batched_lora(*t).numpy(), want


@pytest.mark.parametrize("k,r,n", [(64, 8, 128), (320, 16, 256), (128, 4, 384)])
def test_batched_lora_plain_matches_reference(k, r, n):
    """f32 sums in another order: rtol 1e-5, atol 1e-5 of max |want|. The
    CPU wrapper is the plain version; null rows are exactly 0."""
    a, b, s = _stacks(5, k, r, n, seed=k + n)
    x = np.random.default_rng(1).normal(size=(6, k)).astype(np.float32)
    idx = np.array([0, 1, 2, 3, 4, 2], np.int32)
    got, via_ops, want = _both(x, a, b, s, idx)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    np.testing.assert_array_equal(via_ops, got)
    assert not got[0].any() and got.dtype == np.float32
    assert np.abs(got[1:]).max(axis=1).min() > 0         # every tenant row moves


def test_batched_lora_plain_3d_and_row_independence():
    """(B, S, K) rows take their batch row's adapter, like the reference;
    each row's output depends only on its own index (the SGMV contract)."""
    a, b, s = _stacks(3, 64, 8, 128, seed=13)
    x = np.random.default_rng(4).normal(size=(2, 5, 64)).astype(np.float32)
    got, _, want = _both(x, a, b, s, np.array([1, 2], np.int32))
    assert got.shape == (2, 5, 128)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    flat, _, _ = _both(x[0], a, b, s, np.array([1] * 5, np.int32))
    np.testing.assert_allclose(got[0], flat, rtol=1e-5, atol=1e-5 * np.abs(flat).max())
    x2 = x[:, 0]
    mixed, _, _ = _both(x2, a, b, s, np.array([2, 1], np.int32))
    for row, i in enumerate([2, 1]):
        solo, _, _ = _both(x2[row:row + 1], a, b, s, np.array([i], np.int32))
        np.testing.assert_array_equal(mixed[row], solo[0])


def test_batched_lora_wrapper_rejects_bad_shapes():
    a, b, s = (torch.from_numpy(v) for v in _stacks(3, 64, 8, 128))
    x, idx = torch.zeros((2, 64)), torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        blora_ops.batched_lora(torch.zeros((2, 60)), a, b, s, idx)
    with pytest.raises(ValueError):
        blora_ops.batched_lora(x, a, b, s, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        blora_ops.batched_lora(x, torch.zeros((3, 16, 68), dtype=torch.uint8),
                               torch.zeros((3, 17, 128), dtype=torch.uint8), s, idx)


# -- serving/adapters: the SRAM-budget cache ---------------------------------------------


def _cache_lru(c):
    for name in ("a", "b"):
        c.admit(name, 100)
    c.lookup("a")
    return [c.admit("c", 100), c.resident_ids(), c.evictions, c.bytes_used]


def _cache_pinned(c):
    c.admit("a", 100)
    c.pin("a")
    c.admit("b", 100)
    c.pin("b")
    out = [c.can_admit("c", 100)]
    try:
        c.admit("c", 100)
        out.append("admitted")
    except MemoryError:
        out.append("MemoryError")
    c.unpin("b")
    out += [c.can_admit("c", 100), c.admit("c", 100), c.resident_ids(), c.pinned("a")]
    return out


def _cache_slots(c):
    c.admit("a", 10)
    c.admit("b", 10)
    c.lookup("b")
    return [c.slot_of("a"), c.slot_of("b"), c.admit("c", 10), sorted(c.resident_ids())]


def _cache_oversized(c):
    return [c.can_admit("huge", 51), c.can_admit("fits", 50)]


def _cache_stats(c):
    c.admit("a", 10)
    c.lookup("a")
    c.lookup("zz")
    return [c.stats()]


@pytest.mark.parametrize("budget,entries,seq", [
    (250, 8, _cache_lru), (250, 8, _cache_pinned), (10_000, 2, _cache_slots),
    (50, 4, _cache_oversized), (100, 2, _cache_stats),
], ids=["lru", "pinned", "slots", "oversized", "stats"])
def test_adapter_cache_matches_reference(budget, entries, seq):
    """``tests/test_adapters.py::TestAdapterCache``'s sequences of admit,
    lookup, pin and evict: the same slots, evictions and stats."""
    got = seq(ad.AdapterCache(budget, entries))
    want = seq(jad.AdapterCache(budget, entries))
    assert got == want


# -- models: decode_step with a mixed adapter_idx ---------------------------------------------


def _fp8(a):
    j8 = np.asarray(jnp.asarray(a).astype(jnp.float8_e4m3fn))
    return jnp.asarray(j8), torch.from_numpy(j8.view(np.uint8).copy()).view(torch.float8_e4m3fn)


def test_decode_step_with_adapters_matches_reference(tiny):
    """One paged decode step with slots on tenants 1 and 2 and one null
    slot, against the reference's ``decode_step`` on its
    ``AdapterServing.install``-ed params (the port gets the reference's
    device stacks through ``adapter_stacks_from_jax``): logits within the
    model tolerance, greedy picks identical. Control: the tenants move
    their rows' logits far beyond the tolerance, and the null slot's logits
    equal the no-adapter step's."""
    jmodel, jparams, model, params, _ = tiny
    cfg = model.cfg
    jreg = jad.AdapterRegistry(J_SPEC)
    for i, st in enumerate(_tenant_stacks(cfg)):
        jreg.register(f"tenant-{i}", st)
    nbytes = jreg.get("tenant-0").nbytes
    jserving = jad.AdapterServing(jmodel, jreg, budget_bytes=4 * nbytes, max_resident=4)
    slots = [jserving.acquire("tenant-2"), jserving.acquire("tenant-0")]
    assert slots == [1, 2]
    jp_mt = jserving.install(jparams)
    p_mt = install_stacks(params, adapter_stacks_from_jax(
        jax.tree.map(np.asarray, jserving.pack), "cpu"))

    rng = np.random.default_rng(0)
    page, n_pages = 8, 6
    shape = (cfg.num_layers, n_pages + 1, cfg.num_kv_heads, page, cfg.head_dim)
    kv = [_fp8(rng.normal(size=shape) * 2) for _ in range(2)]
    tables = np.array([[0, 1, 6], [2, 6, 6], [3, 4, 6], [6, 6, 6]], np.int32)
    pos = np.array([10, 3, 12, 0], np.int32)
    wp, wo = np.array([1, 2, 4, 6], np.int32), np.array([2, 3, 4, 0], np.int32)
    lengths = np.array([11, 4, 13, 0], np.int32)
    toks = np.array([5, 1700, 42, 0], np.int32)
    aidx = np.array([1, 0, 2, 0], np.int32)
    with jax.disable_jit():
        want, _ = jmodel.decode_step(
            jp_mt, jattn.PagedKVState(kv[0][0], kv[1][0],
                                      *map(jnp.asarray, (tables, wp, wo, lengths))),
            jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(aidx))
    want = np.asarray(want)[:3]

    def port(p, idx):
        state = tattn.PagedKVState(kv[0][1].clone(), kv[1][1].clone(),
                                   *map(torch.from_numpy, (tables, wp, wo, lengths)))
        logits, _ = model.decode_step(p, state, torch.from_numpy(toks),
                                      torch.from_numpy(pos), idx)
        return logits[:3].numpy()

    got = port(p_mt, torch.from_numpy(aidx))
    np.testing.assert_allclose(got, want, **LOGIT_TOL)
    assert (got.argmax(-1) == want.argmax(-1)).all()
    base = port(params, None)
    np.testing.assert_array_equal(got[1], base[1])
    tol = LOGIT_TOL["atol"] + LOGIT_TOL["rtol"] * np.abs(want).max()
    assert np.abs(got[[0, 2]] - base[[0, 2]]).max(axis=1).min() > 100 * tol


# -- serving/engine: multi-tenant contracts --------------------------------------------------


def _run(model, params, registry, jobs, *, slots=1, n_pages=None, adapters=True,
         max_new=6, **serving_kw):
    """Serve ``jobs`` [(prompt, adapter_id, priority)] to completion."""
    serving = _serving(model, registry, **serving_kw) if adapters else None
    eng = ServeEngine(model, params, max_slots=slots, max_len=64,
                      kv=PagedKV(page=8, n_pages=n_pages), adapters=serving)
    reqs = [eng.submit(p, RequestSpec(max_new_tokens=max_new, adapter_id=t, priority=pr))
            for p, t, pr in jobs]
    eng.run_until_drained()
    assert all(r.state == "done" for r in reqs)
    return [r.output for r in reqs], eng


def _prompts(seed, n):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, 100, size=int(rng.integers(4, 12)))]
            for _ in range(n)]


def test_mixed_batch_token_identical_to_solo(tiny):
    """Three tenants and two adapter-less requests on four slots: each
    request's greedy tokens equal its run alone on a one-slot engine."""
    _, _, model, params, registry = tiny
    tenants = [None, "tenant-0", "tenant-1", "tenant-2", None]
    jobs = [(p, t, 1) for p, t in zip(_prompts(3, 5), tenants)]
    mixed, eng = _run(model, params, registry, jobs, slots=4)
    for job, out in zip(jobs, mixed):
        assert out == _run(model, params, registry, [job])[0][0], job[1]
    assert eng.adapters.cache.evictions == 0
    assert not any(eng.adapters.cache.pinned(k) for k in eng.adapters.cache.resident_ids())


def test_null_slots_identical_to_engine_without_adapters(tiny):
    _, _, model, params, registry = tiny
    prompt = list(range(20, 29))
    plain, _ = _run(model, params, registry, [(prompt, None, 1)], slots=2, adapters=False)
    with_ad, _ = _run(model, params, registry,
                      [(prompt, None, 1), (list(range(5)), "tenant-1", 1)], slots=2)
    assert with_ad[0] == plain[0]


def test_tenant_changes_output(tiny):
    _, _, model, params, registry = tiny
    prompt = list(range(30, 40))
    outs = [_run(model, params, registry, [(prompt, t, 1)])[0][0]
            for t in (None, "tenant-0", "tenant-3")]
    assert outs[0] != outs[1] and outs[0] != outs[2]


def test_budget_churn_and_pinning(tiny):
    """Four tenants through a budget of two: bytes never exceed the budget,
    an in-flight request's adapter is resident, pinned and indexed, and
    every pin is gone at the end."""
    _, _, model, params, registry = tiny
    serving = _serving(model, registry, budget_adapters=2, max_resident=2)
    eng = ServeEngine(model, params, max_slots=2, max_len=64, kv=PagedKV(page=8),
                      adapters=serving)
    reqs = [eng.submit(list(range(4)), RequestSpec(max_new_tokens=3,
                                                   adapter_id=f"tenant-{i}"))
            for i in range(4)]
    while any(r.state in ("queued", "running") for r in reqs):
        eng.tick()
        assert serving.cache.bytes_used <= serving.cache.budget_bytes
        for slot, r in enumerate(eng.slot_req):
            if r is not None:
                key = eng.slot_adapter_key[slot]
                assert key == f"{r.adapter_id}@v{registry.get(r.adapter_id).version}"
                assert serving.cache.is_resident(key) and serving.cache.pinned(key)
                assert eng.slot_adapter[slot] > 0
    assert all(r.state == "done" for r in reqs)
    assert serving.cache.evictions >= 2
    assert not any(serving.cache.pinned(k) for k in serving.cache.resident_ids())
    assert (eng.slot_adapter == 0).all()


def test_pinned_budget_queues_then_completes(tiny):
    """Every budget byte pinned by running requests: a third tenant waits
    in the queue with a slot free, then completes."""
    _, _, model, params, registry = tiny
    serving = _serving(model, registry, budget_adapters=2, max_resident=2)
    eng = ServeEngine(model, params, max_slots=3, max_len=64, kv=PagedKV(page=8),
                      adapters=serving)
    reqs = [eng.submit(list(range(6)), RequestSpec(max_new_tokens=8,
                                                   adapter_id=f"tenant-{i}"))
            for i in range(3)]
    eng.tick()
    assert [r.state for r in reqs] == ["running", "running", "queued"]
    eng.run_until_drained()
    assert reqs[2].state == "done"


def test_affinity_never_starves_priority(tiny):
    """With one slot, a higher-priority request on a cold adapter goes
    ahead of queued traffic on the warm one."""
    _, _, model, params, registry = tiny
    serving = _serving(model, registry, budget_adapters=1, max_resident=1)
    eng = ServeEngine(model, params, max_slots=1, max_len=64, kv=PagedKV(page=8),
                      adapters=serving)
    eng.submit([1, 2, 3], RequestSpec(max_new_tokens=2, adapter_id="tenant-0"))
    eng.run_until_drained()
    assert serving.is_resident("tenant-0")
    hi = eng.submit([4, 5], RequestSpec(max_new_tokens=2, priority=0, adapter_id="tenant-1"))
    lo = eng.submit([6, 7], RequestSpec(max_new_tokens=2, priority=1, adapter_id="tenant-0"))
    eng.tick()
    assert (hi.state, lo.state) == ("running", "queued")
    eng.run_until_drained()
    assert (hi.state, lo.state) == ("done", "done")


def test_preemption_unpins_and_keeps_tokens(tiny):
    """A pool too small for both slots preempts the low-priority tenant
    request mid-decode: its adapter is unpinned at preemption, it replays
    prompt plus output on re-admission with the same greedy tokens as
    alone, and no pin is left at the end."""
    _, _, model, params, registry = tiny
    lo_job = (list(range(30, 49)), "tenant-1", 2)
    solo, _ = _run(model, params, registry, [lo_job], max_new=10)
    serving = _serving(model, registry)
    eng = ServeEngine(model, params, max_slots=2, max_len=64,
                      kv=PagedKV(page=8, n_pages=6), adapters=serving)
    hi = eng.submit(list(range(1, 20)), RequestSpec(max_new_tokens=10, priority=0))
    lo = eng.submit(lo_job[0], RequestSpec(max_new_tokens=10, priority=2,
                                           adapter_id="tenant-1"))
    key = f"tenant-1@v{registry.get('tenant-1').version}"
    unpinned_at_preempt, pinned_while_placed = [], []
    while hi.state != "done" or lo.state != "done":
        before = lo.n_preempts
        eng.tick()
        if lo.n_preempts > before:
            unpinned_at_preempt.append(not serving.cache.pinned(key))
        if any(r is lo for r in eng.slot_req):
            pinned_while_placed.append(serving.cache.pinned(key))
    assert lo.n_preempts >= 1 and all(unpinned_at_preempt)
    assert pinned_while_placed and all(pinned_while_placed)
    assert lo.output == solo[0]
    assert not serving.cache.pinned(key) and (eng.slot_adapter == 0).all()


def test_unknown_or_oversized_adapter_rejected(tiny):
    _, _, model, params, registry = tiny
    small = ad.AdapterServing(model, registry,
                              budget_bytes=registry.get("tenant-0").nbytes - 1)
    eng = ServeEngine(model, params, max_slots=1, max_len=64, kv=PagedKV(page=8),
                      adapters=_serving(model, registry))
    assert eng.submit([1, 2], RequestSpec(adapter_id="nope")).state == "rejected"
    assert eng.submit([1, 2], RequestSpec(adapter_id="tenant-0")).state == "queued"
    tight = ServeEngine(model, params, max_slots=1, max_len=64, kv=PagedKV(page=8),
                        adapters=small)
    assert tight.submit([1, 2], RequestSpec(adapter_id="tenant-0")).state == "rejected"
    none = ServeEngine(model, params, max_slots=1, max_len=64, kv=PagedKV(page=8))
    assert none.submit([1, 2], RequestSpec(adapter_id="tenant-0")).state == "rejected"


def test_adapter_greedy_tokens_match_reference_engine(tiny):
    """Three requests, two on tenants and one without, on two slots, 6
    greedy steps: the port's engine and the reference's give the same
    tokens. Both registries freeze the same float masters; the reference
    engine runs op by op."""
    jmodel, jparams, model, params, _ = tiny
    cfg = model.cfg
    jmodel = JModel(jmodel.cfg, mode="serve")
    reg, jreg = ad.AdapterRegistry(SPEC), jad.AdapterRegistry(J_SPEC)
    for i, st in enumerate(_tenant_stacks(cfg, n=2)):
        reg.register(f"tenant-{i}", st)
        jreg.register(f"tenant-{i}", st)
    nbytes = reg.get("tenant-0").nbytes
    jobs = list(zip(_prompts(9, 3), ["tenant-1", None, "tenant-0"]))
    jeng = JServeEngine(jmodel, jparams, max_slots=2, max_len=64, kv=JPagedKV(page=8),
                        adapters=jad.AdapterServing(jmodel, jreg, budget_bytes=2 * nbytes,
                                                    max_resident=2))
    jreqs = [jeng.submit(p, JRequestSpec(max_new_tokens=6, adapter_id=t)) for p, t in jobs]
    with jax.disable_jit():
        jeng.run_until_drained()
    got, eng = _run(model, params, reg, [(p, t, 1) for p, t in jobs], slots=2,
                    budget_adapters=2, max_resident=2)
    assert got == [r.output for r in jreqs]
    assert eng.stats.ticks == jeng.stats.ticks


def test_serve_cli_with_adapters_on_cpu(capsys):
    assert serve_cli.main(["--preset", "tiny", "--device", "cpu", "--requests", "4",
                           "--slots", "2", "--max-new", "3", "--kv", "paged", "--page", "8",
                           "--adapters", "3", "--adapter-rate", "0.75"]) == 0
    lines = capsys.readouterr().out.splitlines()
    out = json.loads([ln for ln in lines if ln.startswith("[serve] {")][-1][len("[serve] "):])
    assert out["completed"] == 4 and out["tokens_out"] == 12
    assert out["adapters"]["registered"] == 3 and out["adapters"]["pinned"] == 0
    assert out["adapters"]["budget_bytes"] == 2 * 6960      # max(2, 3 // 2) tenants
