"""The port's hand-written CUDA kernels on the card, each held against its
plain PyTorch version on the same inputs, and the tiny model served through
them. Every test here needs a CUDA device (marker ``cuda``) and skips
without one; on the card run ``python -m pytest -m cuda tests/test_torch_cuda.py``.
This file imports no JAX: the machine with the card has none."""
import numpy as np
import pytest
import torch

from repro_torch.core import ternary
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.flash_decode.paged import paged_flash_decode_ref
from repro_torch.kernels.ternary_matmul import ops as tm_ops
from repro_torch.kernels.ternary_matmul.ref import ternary_matmul_ref

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
    before = fd_ops.launches.n
    got = fd_ops.paged_decode_attention(*args, 4.0)
    torch.cuda.synchronize()
    assert fd_ops.launches.n == before + 1
    want = paged_flash_decode_ref(args[0].reshape(b, hkv, g, d), *args[1:], 4.0)
    # f32 sums over D and over positions taken in another order: the error
    # scales with the outputs (|v · kv_scale| reaches ~50 here), ~1e-5 of them
    torch.testing.assert_close(got, want.reshape(b, hkv * g, d), rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())
    assert torch.isfinite(got).all() and not got[2].any()


def test_tiny_model_kernels_vs_plain(cuda):
    """The tiny preset on the card: a decode step through both kernels
    against the plain path on the same state (logits within 1e-2 of their
    max |value|: bf16 activations are rounded after f32 sums taken in
    another order), and an engine run that goes through both kernels."""
    from repro_torch.launch.serve import build_engine
    from repro_torch.serving.api import RequestSpec

    eng = build_engine("bitnet-2b", "tiny", slots=2, max_len=64, page=8, seed=0,
                       device="cuda")
    mm, fd = tm_ops.launches.n, fd_ops.launches.n
    reqs = [eng.submit([3, 14, 15, 92, 65][:n], RequestSpec(max_new_tokens=6))
            for n in (2, 5, 3)]
    eng.run_until_drained()
    assert tm_ops.launches.n > mm and fd_ops.launches.n > fd
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
