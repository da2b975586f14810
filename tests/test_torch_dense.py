"""The port's dense-KV slice (``kernels/flash_decode`` ``flash_decode_ref`` and
``decode_attention``, ``models/attention.py`` ``init_kv_cache`` and
``gqa_decode_dense``, the dense branch of ``Model.decode_step``,
``serving/kv.py`` ``DenseKV`` and the engine and CLI defaults) against
``repro``'s, on the tiny bitnet-2b preset.

On the CPU every wrapper runs its plain version; the hand-written CUDA kernel
is held against it on the card in ``tests/test_torch_cuda.py``. The plain
version is held here against the reference's oracle and its Pallas kernel in
interpret mode, over the shapes and lengths of ``tests/test_kernels.py``'s
``TestFlashDecodeKernel``. The reference model and engine run op by op
(``jax.disable_jit()``), as in ``test_torch_model.py``."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.kernels.flash_decode import ops as jfd_ops
from repro.kernels.flash_decode.ref import flash_decode_ref as j_fd_ref
from repro.launch.train import reduce_config as j_reduce_config
from repro.models.transformer import Model as JModel
from repro.serving import adapters as jad
from repro.serving.api import RequestSpec as JRequestSpec
from repro.serving.engine import ServeEngine as JServeEngine
from repro.serving.kv import DenseKV as JDenseKV
from repro_torch.configs import get_config, reduce_config
from repro_torch.convert import adapter_stacks_from_jax, params_from_jax
from repro_torch.kernels.flash_decode import flash_decode as fd_dense
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.flash_decode.ref import flash_decode_ref
from repro_torch.launch import serve as serve_cli
from repro_torch.models import attention as tattn
from repro_torch.models.transformer import Model
from repro_torch.serving.adapters.registry import target_dims
from repro_torch.serving.adapters.runtime import install_stacks
from repro_torch.serving.api import RequestSpec
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.kv import DenseKV, PagedKV

# one intra-op thread per process: the suite runs several pytest workers
# on a few cores, and torch's default pool (a thread per core) in each of
# them oversubscribes the CPU many times over
torch.set_num_threads(1)

#: tests/test_kernels.py's tolerances: f32 (summation order only), and fp8
#: KV (the same, over values scaled by kv_scale)
TOL = dict(rtol=1e-5, atol=1e-5)
FP8_TOL = dict(rtol=1e-4, atol=1e-4)
#: logits: f32 sums in another order than XLA's, after identical bf16 steps
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)


def rng(seed):
    return np.random.default_rng(seed)


def _fp8(a):
    """numpy f32 → (jax fp8 array, torch fp8 tensor) with the same bytes."""
    j8 = np.asarray(jnp.asarray(a).astype(jnp.float8_e4m3fn))
    return jnp.asarray(j8), torch.from_numpy(j8.view(np.uint8).copy()).view(torch.float8_e4m3fn)


def _both(q, k, v, length, kv_scale=1.0):
    """Port plain version (q grouped and through ``decode_attention``) and
    the reference's oracle and interpret-mode Pallas kernel, on the same
    inputs."""
    b, hq, d = q.shape
    hkv = k.shape[1]
    qg = q.reshape(b, hkv, hq // hkv, d)
    oracle = np.asarray(j_fd_ref(jnp.asarray(qg), jnp.asarray(k), jnp.asarray(v), length,
                                 kv_scale)).reshape(b, hq, d)
    pallas = np.asarray(jfd_ops.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(length),
        jnp.float32(kv_scale)))
    tq, tk, tv = (torch.from_numpy(np.asarray(a, np.float32)) for a in (q, k, v))
    got = fd_ops.decode_attention(tq, tk, tv, length, kv_scale).numpy()
    plain = flash_decode_ref(tq.reshape(b, hkv, hq // hkv, d), tk, tv, length,
                             kv_scale).reshape(b, hq, d).numpy()
    np.testing.assert_array_equal(got, plain)
    return got, oracle, pallas


# -- kernel #4's plain version against the reference ------------------------------


@pytest.mark.parametrize("hq,hkv", [(8, 8), (8, 4), (16, 2), (4, 1)])
@pytest.mark.parametrize("s_len", [128, 300, 1024])
def test_gqa_shapes_sweep(hq, hkv, s_len):
    d = 64
    q = rng(hq + s_len).normal(size=(2, hq, d)).astype(np.float32)
    k = rng(1).normal(size=(2, hkv, s_len, d)).astype(np.float32)
    v = rng(2).normal(size=(2, hkv, s_len, d)).astype(np.float32)
    got, oracle, pallas = _both(q, k, v, s_len)
    np.testing.assert_allclose(got, oracle, **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)


@pytest.mark.parametrize("length", [1, 17, 255, 256])
def test_length_masking(length):
    d, s_len = 64, 256
    q = rng(20).normal(size=(1, 4, d)).astype(np.float32)
    k = rng(21).normal(size=(1, 4, s_len, d)).astype(np.float32)
    v = rng(22).normal(size=(1, 4, s_len, d)).astype(np.float32)
    got, oracle, pallas = _both(q, k, v, length)
    np.testing.assert_allclose(got, oracle, **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)


def test_fp8_kv_cache():
    """The port reads the fp8 bytes themselves and widens them; the
    reference gets the same values widened to f32 (its interpret-mode
    kernel rejects fp8 dots), with the common K/V scale as kv_scale."""
    d, s_len = 128, 512
    q = rng(30).normal(size=(2, 8, d)).astype(np.float32)
    kf = rng(31).normal(size=(2, 4, s_len, d)).astype(np.float32)
    vf = rng(32).normal(size=(2, 4, s_len, d)).astype(np.float32)
    sc = np.float32(max(np.abs(kf).max(), np.abs(vf).max()) / 448.0)
    (kj, kt), (vj, vt) = _fp8(kf / sc), _fp8(vf / sc)
    k32, v32 = np.asarray(kj, np.float32), np.asarray(vj, np.float32)
    want = np.asarray(j_fd_ref(jnp.asarray(q.reshape(2, 4, 2, d)), k32, v32, s_len,
                               sc)).reshape(2, 8, d)
    pallas = np.asarray(jfd_ops.decode_attention(jnp.asarray(q), jnp.asarray(k32),
                                                 jnp.asarray(v32), jnp.int32(s_len), sc))
    got = fd_ops.decode_attention(torch.from_numpy(q), kt, vt, s_len, float(sc)).numpy()
    np.testing.assert_allclose(got, want, **FP8_TOL)
    np.testing.assert_allclose(got, pallas, **FP8_TOL)


@pytest.mark.parametrize("d", [64, 128])
def test_head_dims(d):
    q = rng(40 + d).normal(size=(1, 4, d)).astype(np.float32)
    k = rng(41).normal(size=(1, 2, 256, d)).astype(np.float32)
    v = rng(42).normal(size=(1, 2, 256, d)).astype(np.float32)
    got, oracle, pallas = _both(q, k, v, 256)
    np.testing.assert_allclose(got, oracle, **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)


def test_per_row_lengths_match_per_row_reference_calls():
    """A (B,) length vector: each row equals the reference's scalar-length
    oracle on that row alone; a length-0 row is 0 (the port's contract: the
    reference averages the masked cache there, and no caller reads it); a
    scalar length equals the vector of that length; a length past S reads
    the whole cache, as the reference's mask does."""
    b, hkv, g, s_len, d = 4, 2, 3, 200, 64
    q = rng(50).normal(size=(b, hkv * g, d)).astype(np.float32)
    k8 = rng(51).normal(size=(b, hkv, s_len, d)) * 2
    v8 = rng(52).normal(size=(b, hkv, s_len, d)) * 2
    (kj, kt), (vj, vt) = _fp8(k8), _fp8(v8)
    lengths = [37, 0, 1, 250]
    got = fd_ops.decode_attention(torch.from_numpy(q), kt, vt,
                                  torch.tensor(lengths, dtype=torch.int32), 4.0).numpy()
    for row, n in enumerate(lengths):
        if n == 0:
            assert not got[row].any()
            continue
        want = j_fd_ref(jnp.asarray(q[row:row + 1].reshape(1, hkv, g, d)),
                        kj[row:row + 1], vj[row:row + 1], n, 4.0)
        np.testing.assert_allclose(got[row], np.asarray(want).reshape(hkv * g, d), **FP8_TOL)
    scalar = fd_ops.decode_attention(torch.from_numpy(q), kt, vt, 37, 4.0)
    vector = fd_ops.decode_attention(torch.from_numpy(q), kt, vt,
                                     torch.full((b,), 37, dtype=torch.int32), 4.0)
    assert torch.equal(scalar, vector)


def test_kernel_entry_needs_cuda_and_counts_only_launches():
    """On CPU tensors ``decode_attention`` runs the plain version and
    launches nothing; the kernel's own entry refuses a CPU tensor."""
    q = torch.zeros((2, 4, 2, 64))
    kv = torch.zeros((2, 4, 16, 64))
    before = fd_dense.launches.n
    fd_ops.decode_attention(q.reshape(2, 8, 64), kv, kv, 5)
    assert fd_dense.launches.n == before
    with pytest.raises(ValueError, match="CUDA"):
        fd_dense.flash_decode(q, kv, kv, torch.full((2,), 5, dtype=torch.int32))
    assert fd_dense.launches.n == before


# -- the dense model and engine ------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    jcfg = j_reduce_config(j_get_config("bitnet-2b"), "tiny")
    jmodel = JModel(jcfg, mode="serve")
    jparams = jmodel.init(jax.random.PRNGKey(1))
    cfg = reduce_config(get_config("bitnet-2b"), "tiny")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jmodel, jparams, Model(cfg, device="cpu"), params


def test_init_cache_matches_reference(tiny):
    jmodel, _, model, _ = tiny
    want = jmodel.init_cache(3, 40)
    got = model.init_cache(3, 40)
    assert set(got) == set(want) == {"k", "v"}
    for key in ("k", "v"):
        assert tuple(got[key].shape) == want[key].shape
        assert got[key].dtype == torch.float8_e4m3fn and not got[key].view(torch.uint8).any()
    two = tattn.init_kv_cache(model.cfg, 3, 40, 2, device=torch.device("cpu"))
    assert two["v"].shape == (2,) + want["v"].shape[1:]


def _one_hot_masters(g, cfg, spec, n_layers):
    """Float masters whose frozen codes hold one ±1 in each column of A and
    of B, with both absmean scales exactly 1: every sum of the LoRA term
    then has one non-zero addend, so it is exact in any summation order.
    (With dense random codes the f32 sums of XLA's einsums and torch's
    differ in the last bit, and now and then one bf16 rounding of a
    projection flips; the plain LoRA is held against the reference's at
    1e-5 in ``test_torch_adapters.py``.)"""
    out = {}
    for target in spec.targets:
        k, n = target_dims(cfg, target)
        r = spec.rank
        a = np.zeros((n_layers, k, r), np.float32)
        b = np.zeros((n_layers, r, n), np.float32)
        for layer in range(n_layers):
            a[layer, g.integers(0, k, size=r), np.arange(r)] = g.choice([-k, k], size=r)
            b[layer, g.integers(0, r, size=n), np.arange(n)] = g.choice([-r, r], size=n)
        out[target] = {"a": a, "b": b}
    return out


def _adapter_params(jmodel, jparams, params, cfg):
    """The reference's params with tenants 2 and 0 installed in device
    slots 1 and 2, and the port's params with the same stack bytes."""
    spec = jad.AdapterSpec(rank=8, alpha=16.0, targets=("q", "v"))
    g = rng(7)
    jreg = jad.AdapterRegistry(spec)
    for i in range(3):
        jreg.register(f"tenant-{i}", _one_hot_masters(g, cfg, spec, cfg.num_layers))
    jserving = jad.AdapterServing(jmodel, jreg, budget_bytes=3 * jreg.get("tenant-0").nbytes,
                                  max_resident=3)
    assert [jserving.acquire("tenant-2"), jserving.acquire("tenant-0")] == [1, 2]
    jp = jserving.install(jparams)
    p = install_stacks(params, adapter_stacks_from_jax(
        jax.tree.map(np.asarray, jserving.pack), "cpu"))
    return jp, p


@pytest.mark.parametrize("with_adapters", [False, True], ids=["base", "adapters"])
def test_decode_step_dense_matches_reference(tiny, with_adapters):
    """Three dense decode ticks at mixed positions (one slot starting at 0)
    on the same numpy-made fp8 cache: logits within f32 rounding of the
    reference's dense ``decode_step`` and every cache byte equal after each
    tick; the port updates its cache in place and returns the same dict.
    With adapters (rows 0 and 2 on tenants, row 1 on none), a control: the
    tenants move their rows' first-tick logits far beyond the tolerance."""
    jmodel, jparams, model, params = tiny
    cfg = model.cfg
    jp, p = (_adapter_params(jmodel, jparams, params, cfg) if with_adapters
             else (jparams, params))
    aidx = np.array([1, 0, 2], np.int32) if with_adapters else None
    b, s_len = 3, 24
    shape = (cfg.num_layers, b, cfg.num_kv_heads, s_len, cfg.head_dim)
    (kj, kt), (vj, vt) = _fp8(rng(0).normal(size=shape) * 2), _fp8(rng(1).normal(size=shape) * 2)
    kt0, vt0 = kt.clone(), vt.clone()
    jcache, cache = {"k": kj, "v": vj}, {"k": kt, "v": vt}
    pos = np.array([10, 3, 0], np.int32)
    g = rng(2)
    for _ in range(3):
        toks = g.integers(0, cfg.vocab_size, size=b).astype(np.int32)
        with jax.disable_jit():
            jl, jcache = jmodel.decode_step(
                jp, jcache, jnp.asarray(toks), jnp.asarray(pos),
                None if aidx is None else jnp.asarray(aidx))
        logits, out = model.decode_step(p, cache, torch.from_numpy(toks), torch.from_numpy(pos),
                                        None if aidx is None else torch.from_numpy(aidx))
        assert out is cache
        assert logits.shape == (b, cfg.vocab_padded) and logits.dtype == torch.float32
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **LOGIT_TOL)
        for key in ("k", "v"):
            np.testing.assert_array_equal(cache[key].view(torch.uint8).numpy(),
                                          np.asarray(jcache[key]).view(np.uint8))
        if with_adapters and pos[2] == 0:
            base, _ = model.decode_step(params, {"k": kt0.clone(), "v": vt0.clone()},
                                        torch.from_numpy(toks), torch.from_numpy(pos))
            moved = (logits - base).abs().amax(dim=1)
            assert (moved[[0, 2]] > 100 * LOGIT_TOL["atol"]).all() and moved[1] == 0
        pos += 1


def test_dense_write_out_of_range_raises(tiny):
    """A write at pos >= max_len raises (the reference clamps it silently
    into the last position) and leaves the cache untouched."""
    _, _, model, params = tiny
    cache = model.init_cache(2, 8)
    with pytest.raises(IndexError, match="position 8"):
        model.decode_step(params, cache, torch.tensor([1, 2]), torch.tensor([3, 8]))
    assert not cache["k"].view(torch.uint8).any()
    with pytest.raises(NotImplementedError):
        Model(model.cfg, device="cpu", kv_widen="bf16")


def test_dense_kv_checks_write_positions_on_host(tiny):
    """``DenseKV.decode_state`` refuses a ``pos`` past the cache from the
    engine's host array, before any decode work; an in-range ``pos`` gets
    the whole cache."""
    _, _, model, _ = tiny
    kv = DenseKV()
    kv.bind(model, 2, 8)
    assert kv.decode_state([0, 1], np.array([0, 7], np.int32)) is kv.cache
    with pytest.raises(IndexError, match="position 8 of a dense cache of 8"):
        kv.decode_state([1], np.array([0, 8], np.int32))
    assert not kv.cache["k"].view(torch.uint8).any()


def _prompts(seed, lens):
    g = rng(seed)
    return [[int(t) for t in g.integers(0, 1000, size=n)] for n in lens]


def _port_run(model, params, prompts, kv, max_new=8):
    eng = ServeEngine(model, params, max_slots=2, max_len=64, kv=kv)
    reqs = [eng.submit(p, RequestSpec(max_new_tokens=max_new)) for p in prompts]
    eng.run_until_drained()
    return [r.output for r in reqs], eng


def test_dense_engine_matches_reference_engine(tiny):
    """Three requests on two slots (continuous batching, token-mode
    prefill), 8 greedy steps each, over ``DenseKV`` in both: identical
    tokens and tick counts; the port's paged engine gives the same tokens."""
    jmodel, jparams, model, params = tiny
    prompts = _prompts(0, (5, 9, 13))
    jeng = JServeEngine(jmodel, jparams, max_slots=2, max_len=64, kv=JDenseKV())
    jreqs = [jeng.submit(p, JRequestSpec(max_new_tokens=8)) for p in prompts]
    with jax.disable_jit():
        jeng.run_until_drained()
    got, eng = _port_run(model, params, prompts, DenseKV())
    assert got == [r.output for r in jreqs]
    assert all(len(o) == 8 for o in got)
    assert eng.stats.completed == 3 and eng.stats.ticks == jeng.stats.ticks
    assert eng.stats.preemptions == 0
    paged, peng = _port_run(model, params, prompts, PagedKV(page=8))
    assert paged == got and peng.stats.ticks == eng.stats.ticks


def test_default_backend_is_dense(tiny, capsys):
    """``ServeEngine(kv=None)`` builds ``DenseKV`` as the reference's
    ``as_backend(None)`` does (no page pool, every request admissible), a
    backend binds to one engine only, and the CLI defaults to ``--kv
    dense``."""
    _, _, model, params = tiny
    eng = ServeEngine(model, params, max_slots=2, max_len=32)
    assert isinstance(eng.kv, DenseKV) and eng.kv.name == "dense" and eng.pool is None
    assert eng.kv.cache["k"].shape == (model.cfg.num_layers, 2, model.cfg.num_kv_heads, 32,
                                       model.cfg.head_dim)
    assert not eng.kv.supports_paging and eng.kv.capacity_pages == float("inf")
    with pytest.raises(RuntimeError, match="engine-owned"):
        eng.kv.bind(model, 2, 32)
    assert serve_cli.main(["--preset", "tiny", "--device", "cpu", "--requests", "3",
                           "--slots", "2", "--max-new", "3", "--max-len", "64"]) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[serve]")][-1]
    out = json.loads(line[len("[serve] "):])
    assert out["kv"] == "dense" and out["completed"] == 3 and out["tokens_out"] == 9
