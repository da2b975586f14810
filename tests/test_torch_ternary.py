"""Codec parity of the PyTorch port (``repro_torch.core.ternary``,
``repro_torch.models.layers`` row packing) against ``repro``: the same numpy
inputs through both, bit-exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ternary as jt
from repro.models import layers as jl
from repro_torch.core import ternary as tt
from repro_torch.models import layers as tl

# one intra-op thread per process: the suite runs several pytest workers
# on a few cores, and torch's default pool (a thread per core) in each of
# them oversubscribes the CPU many times over
torch.set_num_threads(1)


def _ternary(shape, seed):
    return np.random.default_rng(seed).integers(-1, 2, size=shape).astype(np.int8)


def test_encode_decode_all_codes():
    t = np.array([-1, 0, 1], np.int8)
    np.testing.assert_array_equal(
        tt.encode2(torch.from_numpy(t)).numpy(), np.asarray(jt.encode2(jnp.asarray(t))))
    codes = np.arange(4, dtype=np.uint8)           # '11' decodes to 0 in both
    np.testing.assert_array_equal(
        tt.decode2(torch.from_numpy(codes)).numpy(), np.asarray(jt.decode2(jnp.asarray(codes))))


@pytest.mark.parametrize("layout,tile,shape", [
    ("interleaved", 512, (320, 96)),
    ("interleaved", 512, (864, 40)),
    ("interleaved", 512, (3, 16, 8)),              # leading (stacked) axis
    ("strided", 512, (1024, 64)),
    ("strided", 128, (384, 33)),
])
def test_pack2_unpack2_bit_exact(layout, tile, shape):
    t = _ternary(shape, seed=sum(shape))
    want = np.asarray(jt.pack2(jnp.asarray(t), layout=layout, tile=tile))
    got = tt.pack2(torch.from_numpy(t), layout=layout, tile=tile)
    np.testing.assert_array_equal(got.numpy(), want)
    back = tt.unpack2(torch.from_numpy(want.copy()), layout=layout, tile=tile)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jt.unpack2(jnp.asarray(want), layout=layout, tile=tile)))
    np.testing.assert_array_equal(back.numpy(), t)


def test_pack_errors_match_reference():
    with pytest.raises(ValueError):
        tt.pack2(torch.zeros((6, 4), dtype=torch.int8))
    with pytest.raises(ValueError):
        tt.pack2(torch.zeros((256, 4), dtype=torch.int8), layout="strided", tile=512)


def test_pack_rows_unpack_rows_bit_exact():
    t = _ternary((200, 320), seed=3)
    want = np.asarray(jl.pack_rows(jnp.asarray(t)))
    got = tl.pack_rows(torch.from_numpy(t))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tl.unpack_rows(torch.from_numpy(want.copy())).numpy(),
        np.asarray(jl.unpack_rows(jnp.asarray(want))))


def test_logits_weight_is_pack2_of_transpose():
    """The tied head's (D/4, V) copy is byte for byte the interleaved pack2
    of the table's transpose, which is what lets the logits ride kernel #1."""
    t = torch.from_numpy(_ternary((130, 64), seed=4))
    np.testing.assert_array_equal(tl.logits_weight(tl.pack_rows(t)).numpy(),
                                  tt.pack2(t.t().contiguous()).numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_matches_reference(seed):
    """Codes are bit-exact. The absmean scale sums in another order than
    XLA's reduction, so it may differ by one f32 ulp (rtol 2.4e-7)."""
    w = np.random.default_rng(seed).normal(size=(512, 96)).astype(np.float32) * (seed + 1)
    tj, sj = jt.quantize(jnp.asarray(w))
    t, s = tt.quantize(torch.from_numpy(w))
    np.testing.assert_array_equal(t.numpy(), np.asarray(tj))
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), rtol=2.4e-7, atol=0)


def test_ternary_tensor_round_trip():
    w = torch.from_numpy(np.random.default_rng(5).normal(size=(64, 24)).astype(np.float32))
    tt_ = tt.TernaryTensor.from_dense(w, layout="strided", tile=64)
    assert tt_.shape == (64, 24) and tt_.packed.shape == (16, 24)
    t, s = tt.quantize(w)
    np.testing.assert_array_equal(tt_.to_dense(torch.float32).numpy(),
                                  (t.float() * s).numpy())
