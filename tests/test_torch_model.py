"""The port's model against ``repro``'s on the tiny bitnet-2b preset (3
layers, d_model 320, 2 heads, 2 KV heads, head_dim 128, d_ff 864, vocab
2048): the same parameters, passed through ``repro_torch.convert``, and the
same numpy-made pools and tokens through both.

The reference runs op by op (``jax.disable_jit()``): under ``jit`` XLA on
the CPU fuses bf16 chains with excess f32 precision (``xla_allow_excess_
precision``), which moves logits by ~1e-2 at this size and turns near-ties
into different greedy tokens. Op by op, the reference's bf16 rounding is the
one its code states, and the port matches it to f32 rounding."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.launch.train import reduce_config as j_reduce_config
from repro.models import attention as jattn
from repro.models import layers as jl
from repro.models.transformer import Model as JModel
from repro_torch.configs import get_config, reduce_config
from repro_torch.convert import params_from_jax
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tl
from repro_torch.models.transformer import Model

# one intra-op thread per process: the suite runs several pytest workers
# on a few cores, and torch's default pool (a thread per core) in each of
# them oversubscribes the CPU many times over
torch.set_num_threads(1)

#: logits: f32 sums in another order than XLA's, after identical bf16 steps
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def tiny():
    jcfg = j_reduce_config(j_get_config("bitnet-2b"), "tiny")
    jmodel = JModel(jcfg, mode="serve", paged_attn="kernel")
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = reduce_config(get_config("bitnet-2b"), "tiny")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jmodel, jparams, Model(cfg, device="cpu"), params


def _fp8(a):
    """numpy f32 → (jax fp8 array, torch fp8 tensor) with the same bytes."""
    j8 = np.asarray(jnp.asarray(a).astype(jnp.float8_e4m3fn))
    return jnp.asarray(j8), torch.from_numpy(j8.view(np.uint8).copy()).view(torch.float8_e4m3fn)


def test_config_copy_matches_reference():
    for preset in ("tiny", "small", "full"):
        a = reduce_config(get_config("bitnet-2b"), preset)
        b = j_reduce_config(j_get_config("bitnet-2b"), preset)
        for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff",
                  "vocab_size", "vocab_padded", "ffn_kind", "rope_theta", "tie_embeddings",
                  "norm_eps", "dtype", "max_seq_len"):
            assert getattr(a, f) == getattr(b, f), (preset, f)


def test_init_matches_param_specs(tiny):
    """The port's own seeded init has the reference's tree, shapes and
    types (the stacked ``layers`` split per layer, plus the head copy)."""
    jmodel, _, model, _ = tiny
    specs = jmodel.param_specs()
    params = model.init(torch.Generator().manual_seed(0))
    assert params["embed"]["packed_t"].shape == specs["embed"]["packed_rows"].shape[::-1]
    n = model.cfg.num_layers
    assert len(params["layers"]) == n

    def check(port, spec, stacked):
        if isinstance(spec, dict):
            assert set(spec) <= set(port), (set(spec), set(port))
            for key in spec:
                check(port[key], spec[key], stacked)
            return
        shape = spec.shape[1:] if stacked else spec.shape
        assert tuple(port.shape) == tuple(shape)
        assert str(port.dtype).split(".")[-1] == str(spec.dtype)

    check({k: v for k, v in params.items() if k != "layers"},
          {k: v for k, v in specs.items() if k != "layers"}, False)
    for lp in params["layers"]:
        check(lp, specs["layers"], True)
    t = tl.unpack_rows(params["embed"]["packed_rows"])
    assert set(t.unique().tolist()) == {-1, 0, 1}


def test_decode_step_logits_and_pools_match(tiny):
    """One paged decode step: logits of the active rows agree to f32
    rounding with ``Model(paged_attn="kernel")``, and every byte the step
    writes to a non-scratch page is the reference's. Row 2 is inactive."""
    jmodel, jparams, model, params = tiny
    cfg = model.cfg
    rng = np.random.default_rng(0)
    page, n_pages, b = 8, 6, 3
    shape = (cfg.num_layers, n_pages + 1, cfg.num_kv_heads, page, cfg.head_dim)
    kj, kt = _fp8(rng.normal(size=shape) * 2)
    vj, vt = _fp8(rng.normal(size=shape) * 2)
    tables = np.array([[0, 1, 6], [2, 6, 6], [6, 6, 6]], np.int32)
    pos = np.array([10, 3, 0], np.int32)
    wp, wo = np.array([1, 2, 6], np.int32), np.array([2, 3, 0], np.int32)
    lengths = np.array([11, 4, 0], np.int32)
    toks = np.array([5, 1700, 0], np.int32)
    with jax.disable_jit():
        jl_, js = jmodel.decode_step(
            jparams, jattn.PagedKVState(kj, vj, *map(jnp.asarray, (tables, wp, wo, lengths))),
            jnp.asarray(toks), jnp.asarray(pos))
    state = tattn.PagedKVState(kt, vt, *map(torch.from_numpy, (tables, wp, wo, lengths)))
    logits, state = model.decode_step(params, state, torch.from_numpy(toks),
                                      torch.from_numpy(pos))
    assert logits.shape == (b, cfg.vocab_padded) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits[:2].numpy(), np.asarray(jl_)[:2], **LOGIT_TOL)
    assert torch.isfinite(logits).all()
    for jp_, tp_ in ((js.k_pool, state.k_pool), (js.v_pool, state.v_pool)):
        np.testing.assert_array_equal(tp_.view(torch.uint8).numpy()[:, :n_pages],
                                      np.asarray(jp_).view(np.uint8)[:, :n_pages])


def test_tied_logits_through_kernel_layout(tiny):
    """Tied logits as ``(x·t)·scale`` on the transposed copy vs the
    reference's ``x·(t·scale)``: equal up to that reordering (f32)."""
    _, jparams, _, params = tiny
    x = np.random.default_rng(3).normal(size=(4, 320)).astype(np.float32)
    want = np.asarray(jl.tied_logits(jparams["embed"], jnp.asarray(x), "serve"))
    got = tl.tied_logits(params["embed"], torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **LOGIT_TOL)


def test_fp8_kv_overflow_policy():
    """KV writes saturate to ±448 (0x7e / 0xfe). In range they are the
    reference's bytes exactly; past 448·KV_CACHE_SCALE the reference's cast
    gives NaN (0x7f), which would poison every read of the position."""
    rng = np.random.default_rng(0)
    k = (rng.normal(size=(4096,)) * 300).astype(np.float32)
    k[:4] = [1791.0, -1796.0, 2000.0, -1e5]            # 447.75, -449, 500, far out
    kb = torch.from_numpy(k).to(torch.bfloat16)
    got = tattn.kv_encode(kb, torch.float8_e4m3fn).view(torch.uint8).numpy()
    ref = np.asarray((jnp.asarray(kb.float().numpy()).astype(jnp.bfloat16)
                      / jl.KV_CACHE_SCALE).astype(jnp.float8_e4m3fn)).view(np.uint8)
    in_range = np.abs(kb.float().numpy() / jl.KV_CACHE_SCALE) <= 448
    np.testing.assert_array_equal(got[in_range], ref[in_range])
    assert got[2] == 0x7E and got[3] == 0xFE and ref[2] == 0x7F
    assert not (got & 0x7F == 0x7F).any()               # no NaN ever written


def test_scatter_and_gather_pages_match_reference():
    rng = np.random.default_rng(1)
    pool = rng.normal(size=(2, 5, 2, 4, 8)).astype(np.float32)
    pj, pt = _fp8(pool)
    tj, tt_ = _fp8(rng.normal(size=(2, 2, 2, 8)))       # (L, B, H, D)
    pages, offs = np.array([1, 4], np.int32), np.array([2, 0], np.int32)
    want = jattn.scatter_tokens(pj, jnp.asarray(pages), jnp.asarray(offs), tj)
    for layer in range(2):
        tattn.scatter_tokens(pt[layer], torch.from_numpy(pages), torch.from_numpy(offs),
                             tt_[layer])
    np.testing.assert_array_equal(pt.view(torch.uint8).numpy(), np.asarray(want).view(np.uint8))
    tables = np.array([[1, 4], [0, 2]], np.int32)
    np.testing.assert_array_equal(
        tattn.gather_pages(pt, torch.from_numpy(tables)).view(torch.uint8).numpy(),
        np.asarray(jattn.gather_pages(want, jnp.asarray(tables))).view(np.uint8))
