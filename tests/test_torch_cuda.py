"""The port's hand-written CUDA kernels on the card, each held against its
plain PyTorch version on the same inputs, and the tiny model served through
them. Every test here needs a CUDA device (marker ``cuda``) and skips
without one; on the card run ``python -m pytest -m cuda tests/test_torch_cuda.py``.
This file imports no JAX: the machine with the card has none."""
import numpy as np
import pytest
import torch

from repro_torch.core import ternary
from repro_torch.kernels.batched_lora import ops as bl_ops
from repro_torch.kernels.batched_lora.ref import batched_lora_ref
from repro_torch.kernels.flash_decode import flash_decode as fd_dense
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.flash_decode import paged as fd_paged
from repro_torch.kernels.flash_decode.paged import paged_flash_decode_ref
from repro_torch.kernels.flash_decode.ref import flash_decode_ref
from repro_torch.kernels.ternary_matmul import ops as tm_ops
from repro_torch.kernels.ternary_matmul.ref import ternary_matmul_ref

# one intra-op thread per process: the suite runs several pytest workers
# on a few cores, and torch's default pool (a thread per core) in each of
# them oversubscribes the CPU many times over
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

#: f32: summation order only; bf16: one bf16 rounding of the output
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-4),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-1)}


@pytest.fixture
def cuda():
    """The card, decided inside the test (never at import time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _packed(k, n, seed, layout="interleaved", tile=512):
    w = torch.from_numpy(np.random.default_rng(seed).normal(size=(k, n)).astype(np.float32))
    t, s = ternary.quantize(w)
    return ternary.pack2(t, layout=layout, tile=tile), s


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,layout,tile", [
    (4, 320, 256, "interleaved", 512), (4, 864, 320, "interleaved", 512),
    (4, 2560, 640, "interleaved", 512), (5, 6912, 2560, "interleaved", 512),
    (4, 2560, 1001, "interleaved", 512), (130, 1024, 96, "strided", 512),
    (3, 768, 40, "strided", 256),
])
def test_ternary_matmul_kernel_vs_plain(cuda, m, k, n, layout, tile, dtype):
    p, s = _packed(k, n, seed=k + n, layout=layout, tile=tile)
    x = torch.from_numpy(np.random.default_rng(m).normal(size=(m, k)).astype(np.float32))
    x, p, s = x.to(cuda, dtype), p.to(cuda), s.to(cuda)
    before = tm_ops.launches.n
    got = tm_ops.ternary_matmul(x, p, s, layout=layout, tile=tile, out_dtype=dtype)
    torch.cuda.synchronize()
    assert tm_ops.launches.n == before + 1
    want = ternary_matmul_ref(x, p, s, layout=layout, tile=tile, out_dtype=dtype)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_dtype", [torch.float8_e4m3fn, torch.bfloat16, torch.float32])
def test_paged_decode_kernel_vs_plain(cuda, kv_dtype, q_dtype):
    """Row 2 is inactive (length 0, table all scratch), tables are padded
    with the scratch page, and the scratch page holds NaN bytes: live rows
    must match the plain version and every row stay finite. The kernel
    reads q as given (the decode tick hands it bf16)."""
    rng = np.random.default_rng(2)
    b, hkv, g, d, page, n_pages = 4, 5, 4, 128, 64, 6
    q = torch.from_numpy(rng.normal(size=(b, hkv * g, d)).astype(np.float32))
    shape = (n_pages + 1, hkv, page, d)
    k = torch.from_numpy((rng.normal(size=shape) * 3).astype(np.float32)).to(kv_dtype)
    v = torch.from_numpy((rng.normal(size=shape) * 3).astype(np.float32)).to(kv_dtype)
    k.view(torch.uint8)[-1] = 0x7F
    v.view(torch.uint8)[-1] = 0x7F
    tables = torch.full((b, 4), n_pages, dtype=torch.int32)
    tables[0, :3] = torch.tensor([4, 1, 2])
    tables[1, :1] = 0
    tables[3, :2] = torch.tensor([5, 3])
    lengths = torch.tensor([150, 5, 0, 64], dtype=torch.int32)
    args = [t.to(cuda) for t in (q.to(q_dtype), k, v, tables, lengths)]
    before = fd_paged.launches.n
    got = fd_ops.paged_decode_attention(*args, 4.0)
    torch.cuda.synchronize()
    assert fd_paged.launches.n == before + 1
    want = paged_flash_decode_ref(args[0].reshape(b, hkv, g, d), *args[1:], 4.0)
    # f32 sums over D and over positions taken in another order: the error
    # scales with the outputs (|v · kv_scale| reaches ~50 here), ~1e-5 of them
    torch.testing.assert_close(got, want.reshape(b, hkv * g, d), rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())
    assert torch.isfinite(got).all() and not got[2].any()


@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_dtype", [torch.float8_e4m3fn, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("lengths", [[37, 100, 1, 180], [0, 300, 2, 300], 129],
                         ids=["per-row", "edges-0-and-S", "scalar"])
def test_dense_decode_kernel_vs_plain(cuda, kv_dtype, q_dtype, lengths):
    """Kernel #4 against its plain version at the full-width head shape
    (Hkv 5, G 4, D 128) over a cache of S = 300 whose positions past every
    live length hold NaN bytes: live rows within 1e-5 of the plain output's
    max |value| (f32 sums in another order), a length-0 row exactly 0, a
    length-S row reading the whole cache, every row finite."""
    rng = np.random.default_rng(3)
    b, hkv, g, d, s_len = 4, 5, 4, 128, 300
    q = torch.from_numpy(rng.normal(size=(b, hkv * g, d)).astype(np.float32))
    shape = (b, hkv, s_len, d)
    k = torch.from_numpy((rng.normal(size=shape) * 3).astype(np.float32)).to(kv_dtype)
    v = torch.from_numpy((rng.normal(size=shape) * 3).astype(np.float32)).to(kv_dtype)
    lens = torch.as_tensor(lengths, dtype=torch.int32).expand(b)
    for row in range(b):
        k.view(torch.uint8)[row, :, int(lens[row]):] = 0x7F
        v.view(torch.uint8)[row, :, int(lens[row]):] = 0x7F
    length = lengths if isinstance(lengths, int) else torch.tensor(lengths, dtype=torch.int32,
                                                                  device=cuda)
    q, k, v = q.to(cuda, q_dtype), k.to(cuda), v.to(cuda)
    before = fd_dense.launches.n
    got = fd_ops.decode_attention(q, k, v, length, 4.0)
    torch.cuda.synchronize()
    assert fd_dense.launches.n == before + 1 and got.dtype == torch.float32
    want = flash_decode_ref(q.reshape(b, hkv, g, d), k, v, length, 4.0).reshape(b, hkv * g, d)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())
    assert torch.isfinite(got).all()
    for row in range(b):
        if int(lens[row]) == 0:
            assert not got[row].any()


def test_dense_decode_kernel_refuses_bad_input(cuda):
    """The kernel's entry takes CUDA tensors of one device and shape only,
    and raises (before any launch) on anything else."""
    q = torch.zeros((2, 2, 4, 128), device=cuda)
    kv = torch.zeros((2, 2, 64, 128), device=cuda, dtype=torch.float8_e4m3fn)
    lengths = torch.full((2,), 3, dtype=torch.int32, device=cuda)
    good = dict(q=q, k=kv, v=kv, lengths=lengths)
    before = fd_dense.launches.n
    for bad in (dict(q=q.cpu()), dict(k=kv.cpu(), v=kv.cpu()), dict(lengths=lengths.long()),
                dict(k=kv[:, :1], v=kv[:, :1]), dict(q=q[..., :96])):
        with pytest.raises((ValueError, TypeError)):
            fd_dense.flash_decode(**(good | bad))
    assert fd_dense.launches.n == before


def test_tiny_dense_engine_through_kernel(cuda):
    """The tiny preset on the card over ``DenseKV`` (the engine's default):
    every tick launches kernel #4 once per layer and kernel #2 never, and a
    decode step through the kernels agrees with the plain path on the same
    cache (logits within 1e-2 of their max |value|, as for the paged
    engine)."""
    from repro_torch.launch.serve import build_engine
    from repro_torch.serving.api import RequestSpec

    eng = build_engine("bitnet-2b", "tiny", slots=2, max_len=64, seed=0, device="cuda")
    assert eng.kv.name == "dense"
    fd, pg, ticks = fd_dense.launches.n, fd_paged.launches.n, eng.stats.ticks
    reqs = [eng.submit([3, 14, 15, 92, 65][:n], RequestSpec(max_new_tokens=6))
            for n in (2, 5, 3)]
    eng.run_until_drained()
    assert all(r.state == "done" and len(r.output) == 6 for r in reqs)
    assert fd_dense.launches.n - fd == eng.cfg.num_layers * (eng.stats.ticks - ticks)
    assert fd_paged.launches.n == pg

    eng.submit([7, 8, 9], RequestSpec(max_new_tokens=4))
    eng.tick()
    cache = eng.kv.decode_state([0], eng.pos)
    saved = {key: t.clone() for key, t in cache.items()}
    tok = torch.tensor([8, 0], device=cuda)
    pos = torch.from_numpy(eng.pos.copy()).to(cuda)
    got, _ = eng.model.decode_step(eng.params, cache, tok, pos)
    eng.model.plain = True
    want, _ = eng.model.decode_step(eng.params, saved, tok, pos)
    scale = want[0].abs().max().item()
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-2 * scale)


def _lora_stacks(n_adapters, k, r, n, seed):
    """Random packed A/B codes and positive scales; slot 0 the null adapter
    (zero codes, zero scale), as the adapter runtime keeps it."""
    g = np.random.default_rng(seed)
    t_a = g.integers(-1, 2, size=(n_adapters, k, r)).astype(np.int8)
    t_b = g.integers(-1, 2, size=(n_adapters, r, n)).astype(np.int8)
    t_a[0] = 0
    t_b[0] = 0
    s = g.uniform(0.01, 0.1, size=n_adapters).astype(np.float32)
    s[0] = 0.0
    return (ternary.pack2(torch.from_numpy(t_a)), ternary.pack2(torch.from_numpy(t_b)),
            torch.from_numpy(s))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,k,r,n", [
    (4, 320, 8, 256),                  # tiny preset: q and v (N = 256 both)
    (4, 2560, 8, 2560), (4, 2560, 8, 640),   # full width: q, v
    (6, 2560, 16, 1001), (3, 6912, 64, 2560), (5, 64, 4, 128),
])
def test_batched_lora_kernel_vs_plain(cuda, rows, k, r, n, dtype):
    """Kernel #3 against its plain version on the same inputs, within 1e-5
    of the plain output's max |value| (f32 sums in another order; x is read
    as given in both). Row 1 is a null row: exact zeros. Control: the plain
    output for the wrong tenants (indices rotated) is off by far more."""
    a, b, s = _lora_stacks(5, k, r, n, seed=k + n + r)
    x = torch.from_numpy(np.random.default_rng(rows).normal(size=(rows, k)).astype(np.float32))
    idx = torch.tensor([3, 0, 1, 4, 2, 1][:rows], dtype=torch.int32)
    x, a, b, s, idx = (t.to(cuda) for t in (x.to(dtype), a, b, s, idx))
    before = bl_ops.launches.n
    got = bl_ops.batched_lora(x, a, b, s, idx)
    torch.cuda.synchronize()
    assert bl_ops.launches.n == before + 1 and got.dtype == torch.float32
    want = batched_lora_ref(x, a, b, s, idx)
    tol = 1e-5 * want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=tol)
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    tenants = idx != 0
    wrong = batched_lora_ref(x, a, b, s, torch.where(tenants, idx % 4 + 1, idx))
    assert ((got - wrong).abs().amax(dim=1)[tenants] > 100 * tol).all()


def test_batched_lora_kernel_rows_independent_and_3d(cuda):
    """Each row depends only on its own index (a row computed in a mixed
    batch equals it computed alone, bit for bit); a (B, S, K) x runs as
    B·S rows with each row's index; an index outside [0, R) gives NaN."""
    a, b, s = (t.to(cuda) for t in _lora_stacks(4, 2560, 8, 640, seed=1))
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(4, 3, 2560)).astype(np.float32))
    x = x.to(cuda, torch.bfloat16)
    idx = torch.tensor([2, 0, 3, 1], dtype=torch.int32, device=cuda)
    mixed = bl_ops.batched_lora(x[:, 0], a, b, s, idx)
    for row in range(4):
        solo = bl_ops.batched_lora(x[row:row + 1, 0], a, b, s, idx[row:row + 1])
        assert torch.equal(mixed[row], solo[0])
    got3 = bl_ops.batched_lora(x, a, b, s, idx)
    assert got3.shape == (4, 3, 640)
    want3 = batched_lora_ref(x, a, b, s, idx)
    torch.testing.assert_close(got3, want3, rtol=1e-5, atol=1e-5 * want3.abs().max().item())
    torch.testing.assert_close(got3[:, 0], mixed, rtol=0, atol=0)
    bad = bl_ops.batched_lora(x[:, 0], a, b, s, torch.tensor([1, 7, -1, 0], dtype=torch.int32,
                                                             device=cuda))
    torch.cuda.synchronize()
    assert torch.isnan(bad[1:3]).all() and torch.isfinite(bad[[0, 3]]).all()


def test_tiny_model_kernels_vs_plain(cuda):
    """The tiny preset on the card: a decode step through both kernels
    against the plain path on the same state (logits within 1e-2 of their
    max |value|: bf16 activations are rounded after f32 sums taken in
    another order), and an engine run that goes through both kernels."""
    from repro_torch.launch.serve import build_engine
    from repro_torch.serving.api import RequestSpec

    eng = build_engine("bitnet-2b", "tiny", slots=2, max_len=64, kv="paged", page=8, seed=0,
                       device="cuda")
    mm, fd = tm_ops.launches.n, fd_paged.launches.n
    reqs = [eng.submit([3, 14, 15, 92, 65][:n], RequestSpec(max_new_tokens=6))
            for n in (2, 5, 3)]
    eng.run_until_drained()
    assert tm_ops.launches.n > mm and fd_paged.launches.n > fd
    assert all(r.state == "done" and len(r.output) == 6 for r in reqs)

    eng.submit([7, 8, 9], RequestSpec(max_new_tokens=4))
    eng.tick()                                   # admit; first prompt token in
    state = eng.kv.decode_state([0], eng.pos)
    pools = (state.k_pool.clone(), state.v_pool.clone())
    tok = torch.tensor([8, 0], device=cuda)
    pos = torch.from_numpy(eng.pos.copy()).to(cuda)
    got, _ = eng.model.decode_step(eng.params, state, tok, pos)
    state.k_pool.copy_(pools[0])
    state.v_pool.copy_(pools[1])
    eng.model.plain = True
    want, _ = eng.model.decode_step(eng.params, state, tok, pos)
    scale = want[0].abs().max().item()
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-2 * scale)


def test_tiny_engine_with_adapters_through_kernel(cuda):
    """The tiny preset with three tenants on the card: every tick of the
    adapter engine launches kernel #3 once per targeted projection (2 per
    layer), tenant and adapter-less requests complete, and the adapter-less
    request's tokens equal those of an engine without adapters."""
    from repro_torch.launch.serve import build_engine
    from repro_torch.serving.api import RequestSpec

    kw = dict(slots=3, max_len=64, kv="paged", page=8, seed=0, device="cuda")
    outs = []
    for n_adapters in (0, 3):
        eng = build_engine("bitnet-2b", "tiny", n_adapters=n_adapters, **kw)
        jobs = [([3, 14, 15, 92], None), ([65, 35], "tenant-0"), ([8, 9, 7], "tenant-2")]
        if not n_adapters:
            jobs = jobs[:1]
        bl, ticks = bl_ops.launches.n, eng.stats.ticks
        reqs = [eng.submit(p, RequestSpec(max_new_tokens=6, adapter_id=t)) for p, t in jobs]
        eng.run_until_drained()
        assert all(r.state == "done" and len(r.output) == 6 for r in reqs)
        per_tick = 2 * eng.cfg.num_layers if n_adapters else 0
        assert bl_ops.launches.n - bl == per_tick * (eng.stats.ticks - ticks)
        outs.append(reqs[0].output)
    assert outs[0] == outs[1]
