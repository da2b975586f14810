"""Parity of the port's kernel modules against ``repro``'s Pallas kernels.

On the CPU each wrapper runs its plain version, which is held here against
the reference's Pallas kernel in interpret mode and against its oracle, on
the same numpy inputs. The hand-written CUDA kernels run only on a card;
``tests/test_torch_cuda.py`` holds them against these plain versions there."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ternary as jt
from repro.kernels.flash_decode import ops as jfd_ops
from repro.kernels.ternary_matmul import ops as jtm_ops
from repro.kernels.ternary_matmul.ref import ternary_matmul_ref as j_tm_ref
from repro_torch.core import ternary as tt
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.flash_decode.paged import (paged_flash_decode,
                                                    paged_flash_decode_ref)
from repro_torch.kernels.ternary_matmul import ops as tm_ops
from repro_torch.kernels.ternary_matmul.ref import ternary_matmul_ref

# one intra-op thread per process: the suite runs several pytest workers
# on a few cores, and torch's default pool (a thread per core) in each of
# them oversubscribes the CPU many times over
torch.set_num_threads(1)

#: tests/test_kernels.py's tolerances: f32 (summation order only) and bf16
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-4),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-1)}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _packed(k, n, seed, layout="interleaved", tile=512):
    w = np.random.default_rng(seed).normal(size=(k, n)).astype(np.float32)
    t, s = jt.quantize(jnp.asarray(w))
    p = np.array(jt.pack2(t, layout=layout, tile=tile))
    return p, np.float32(s)


def _x(m, k, seed):
    return np.random.default_rng(seed).normal(size=(m, k)).astype(np.float32)


# -- kernel #1: packed-ternary matmul ----------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,layout", [
    (4, 320, 256, "interleaved"),      # tiny preset: K not a multiple of 512
    (3, 864, 320, "interleaved"),
    (1, 512, 384, "interleaved"),
    (8, 1024, 256, "strided"),
])
def test_ternary_matmul_plain_vs_pallas(m, k, n, layout, dtype):
    p, s = _packed(k, n, seed=k + n, layout=layout)
    x = _x(m, k, seed=m)
    xj = jnp.asarray(x).astype(JDT[dtype])
    pallas = jtm_ops.ternary_matmul(xj, jnp.asarray(p), jnp.float32(s), layout=layout,
                                    interpret=True, out_dtype=jnp.float32)
    oracle = j_tm_ref(xj, jnp.asarray(p), jnp.float32(s), layout=layout)
    got = tm_ops.ternary_matmul(torch.from_numpy(x).to(dtype), torch.from_numpy(p),
                                torch.tensor(s), layout=layout)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL[dtype])
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **TOL[dtype])


def test_ternary_matmul_integer_inputs_exact():
    """Ternary weights × small-integer activations are exact in f32 in any
    summation order."""
    p, _ = _packed(320, 64, seed=11)
    x = np.random.default_rng(12).integers(-8, 8, size=(4, 320)).astype(np.float32)
    got = tm_ops.ternary_matmul(torch.from_numpy(x), torch.from_numpy(p), torch.tensor(1.0))
    want = j_tm_ref(jnp.asarray(x), jnp.asarray(p), jnp.float32(1.0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_linear_takes_a_ternary_tensor():
    w = torch.from_numpy(np.random.default_rng(3).normal(size=(512, 48)).astype(np.float32))
    tt_ = tt.TernaryTensor.from_dense(w, layout="strided", tile=128)
    x = torch.from_numpy(_x(3, 512, seed=4)).to(torch.bfloat16)
    got = tm_ops.linear(x, tt_)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, tm_ops.ternary_matmul(x, tt_.packed, tt_.scale, layout="strided",
                                                  tile=128, out_dtype=torch.bfloat16))


def test_ternary_matmul_cpu_wrapper_is_plain_and_uncounted():
    p, s = _packed(320, 32, seed=1)
    x = torch.from_numpy(_x(2, 320, seed=2)).to(torch.bfloat16)
    before = tm_ops.launches.n
    got = tm_ops.ternary_matmul(x, torch.from_numpy(p), torch.tensor(s), out_dtype=torch.bfloat16)
    want = ternary_matmul_ref(x, torch.from_numpy(p), torch.tensor(s), out_dtype=torch.bfloat16)
    assert torch.equal(got, want) and got.dtype == torch.bfloat16
    assert tm_ops.launches.n == before
    with pytest.raises(ValueError):
        tm_ops.ternary_matmul(x[:, :316], torch.from_numpy(p), torch.tensor(s))


# -- kernel #2: paged flash decode ---------------------------------------------------


def _paged_case(kv_dtype, seed=0, b=4, hkv=2, g=2, d=128, page=8, n_pages=6):
    """Pools with a scratch page last; row 2 inactive (length 0, table all
    scratch); the other tables padded with the scratch page."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hkv * g, d)).astype(np.float32)
    shape = (n_pages + 1, hkv, page, d)
    k = (rng.normal(size=shape) * 3).astype(np.float32)
    v = (rng.normal(size=shape) * 3).astype(np.float32)
    scratch = n_pages
    tables = np.full((b, 3), scratch, np.int32)
    tables[0] = [4, 1, 2]
    tables[1, :1] = [0]
    tables[3, :2] = [5, 3]
    lengths = np.array([19, 5, 0, 9], np.int32)
    if kv_dtype == torch.float8_e4m3fn:
        k8 = np.asarray(jnp.asarray(k).astype(jnp.float8_e4m3fn))
        v8 = np.asarray(jnp.asarray(v).astype(jnp.float8_e4m3fn))
        kt = torch.from_numpy(k8.view(np.uint8).copy()).view(torch.float8_e4m3fn)
        vt = torch.from_numpy(v8.view(np.uint8).copy()).view(torch.float8_e4m3fn)
        kj, vj = jnp.asarray(k8), jnp.asarray(v8)
    else:
        kt, vt = torch.from_numpy(k).to(kv_dtype), torch.from_numpy(v).to(kv_dtype)
        kj, vj = (jnp.asarray(kt.float().numpy()).astype(JDT[kv_dtype]),
                  jnp.asarray(vt.float().numpy()).astype(JDT[kv_dtype]))
    return q, kt, vt, kj, vj, tables, lengths


@pytest.mark.parametrize("kv_dtype", [torch.float8_e4m3fn, torch.bfloat16, torch.float32])
def test_paged_decode_plain_vs_pallas(kv_dtype):
    """Active rows match the Pallas kernel. An inactive row (length 0) is 0
    in the port; the reference returns a uniform average of scratch values
    there, which the engine discards, so only its finiteness is checked."""
    q, kt, vt, kj, vj, tables, lengths = _paged_case(kv_dtype)
    want = np.asarray(jfd_ops.paged_decode_attention(
        jnp.asarray(q), kj, vj, jnp.asarray(tables), jnp.asarray(lengths),
        jnp.float32(4.0), interpret=True))
    got = fd_ops.paged_decode_attention(torch.from_numpy(q), kt, vt, torch.from_numpy(tables),
                                        torch.from_numpy(lengths), 4.0).numpy()
    active = lengths > 0
    np.testing.assert_allclose(got[active], want[active], rtol=1e-5, atol=1e-4)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_array_equal(got[~active], 0.0)


def test_paged_decode_scratch_nan_stays_out_of_live_rows():
    """A NaN on the scratch page (which padding and inactive slots point
    at) must not reach a live row: masked positions are never multiplied."""
    q, kt, vt, _, _, tables, lengths = _paged_case(torch.float8_e4m3fn, seed=1)
    clean = paged_flash_decode_ref(torch.from_numpy(q).reshape(4, 2, 2, 128), kt, vt,
                                   torch.from_numpy(tables), torch.from_numpy(lengths), 4.0)
    kt.view(torch.uint8)[-1] = 0x7F            # e4m3fn NaN
    vt.view(torch.uint8)[-1] = 0x7F
    dirty = paged_flash_decode_ref(torch.from_numpy(q).reshape(4, 2, 2, 128), kt, vt,
                                   torch.from_numpy(tables), torch.from_numpy(lengths), 4.0)
    assert torch.equal(clean, dirty)


def test_paged_kernel_launcher_refuses_cpu_tensors():
    q, kt, vt, _, _, tables, lengths = _paged_case(torch.float32)
    with pytest.raises(ValueError):
        paged_flash_decode(torch.from_numpy(q).reshape(4, 2, 2, 128), kt, vt,
                           torch.from_numpy(tables), torch.from_numpy(lengths))
