"""The wire kernels' plain versions against the Pallas kernels (interpret
mode) and ``repro.kernels.ref``: quantize and dequantize bit-equal to the
Pallas kernels and quantize to ref.py (ref.py's dequantize divides by the
level count where the Pallas kernel multiplies by its fp32 reciprocal, so
the two disagree in the last bits and the port is held to 2 ulp of ref.py),
aggregate within rtol 1e-6 / atol 1e-7 (the Pallas kernel pads K to a
multiple of 8 and sums in fp32, the plain version sums k = 0..K-1 in
order). On the CPU the wrappers run the plain versions and launch nothing.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels import stochastic_quant as jsq
from repro_torch.kernels import stochastic_quant as tsq


def _wire_inputs(m, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 0.3, (m, 128)).astype(np.float32)
    x[0, :4] = [0.0, -0.0, 1e-30, -1e-30]
    rbits = rng.integers(0, 2**32, (m, 128), dtype=np.uint64).astype(np.uint32)
    scale = np.float32(np.abs(x).max())
    return x, rbits, scale


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("q_bits", list(range(1, 9)))
def test_quantize_dequantize_bit_equal(q_bits):
    x, rbits, scale = _wire_inputs(512, q_bits)
    tsq.reset_launches()
    ji, js = jsq.quantize(jnp.asarray(x), jnp.asarray(rbits), jnp.float32(scale), q_bits,
                          interpret=True)
    ri, rs = ref.quantize_ref(jnp.asarray(x), jnp.asarray(rbits), jnp.float32(scale), q_bits)
    ti, ts = tsq.quantize(_t(x), _t(rbits), torch.tensor([scale]), q_bits)
    assert ti.dtype == torch.uint8 and ts.dtype == torch.uint8
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(rs))

    jd = jsq.dequantize(ji, js, jnp.float32(scale), q_bits, interpret=True)
    rd = ref.dequantize_ref(ji, js, jnp.float32(scale), q_bits)
    td = tsq.dequantize(ti, ts, torch.tensor([scale]), q_bits)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(td.numpy(), np.asarray(rd), rtol=2.0**-22, atol=0)
    assert tsq.launches == {"aggregate": 0, "quantize": 0, "dequantize": 0}


@pytest.mark.parametrize("q_bits", [1, 3, 8])
def test_dequantize_corrupted_plane_is_clamped(q_bits):
    rng = np.random.default_rng(q_bits)
    idx = rng.integers(0, 256, (256, 128)).astype(np.uint8)
    signs = rng.integers(0, 2, (256, 128)).astype(np.uint8)
    scale = np.float32(0.7)
    jd = jsq.dequantize(jnp.asarray(idx), jnp.asarray(signs), jnp.float32(scale), q_bits,
                        interpret=True)
    td = tsq.dequantize(_t(idx), _t(signs), torch.tensor([scale]), q_bits)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    # inside [-scale, scale] up to the last bit: L * (scale * (1 / L)) can
    # round one ulp above scale, in the Pallas kernel as here
    assert float(td.abs().max()) <= scale * (1.0 + 2.0**-22)


def _agg_inputs(k, m, q_max, dtype, seed):
    rng = np.random.default_rng(seed)
    q = rng.integers(1, q_max + 1, k)
    idx = np.stack([rng.integers(0, 2**qq, (m, 128)) for qq in q]).astype(dtype)
    signs = rng.integers(0, 2, (k, m, 128)).astype(np.uint8)
    scales = rng.uniform(0.05, 2.0, k).astype(np.float32)
    w = rng.uniform(0.1, 1.0, k).astype(np.float32)
    return idx, signs, scales, (w / w.sum()).astype(np.float32), q.astype(np.int32)


@pytest.mark.parametrize("k,m,q_max,dtype", [
    (1, 256, 8, np.uint8),
    (8, 512, 8, np.uint8),
    (13, 300, 8, np.uint8),      # K not a multiple of 8, ragged M
    (8, 70, 16, np.uint16),      # the engine's u16 planes (q_cap > 8)
], ids=["k1", "k8", "k13-ragged", "u16"])
def test_aggregate_matches_pallas(k, m, q_max, dtype):
    idx, signs, scales, w, q = _agg_inputs(k, m, q_max, dtype, seed=k + m)
    want = np.asarray(jsq.aggregate(jnp.asarray(idx), jnp.asarray(signs), jnp.asarray(scales),
                                    jnp.asarray(w), jnp.asarray(q), interpret=True))
    tsq.reset_launches()
    got = tsq.aggregate(_t(idx), _t(signs), _t(scales), _t(w), _t(q))
    assert got.shape == (m, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    assert tsq.launches["aggregate"] == 0


def test_aggregate_scalar_q_matches_ref():
    idx, signs, scales, w, _q = _agg_inputs(5, 256, 4, np.uint8, seed=3)
    want = np.asarray(ref.aggregate_ref(jnp.asarray(idx), jnp.asarray(signs),
                                        jnp.asarray(scales), jnp.asarray(w), 4))
    got = tsq.aggregate(_t(idx), _t(signs), _t(scales), _t(w), 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("q_bits", [0, 9, 16])
def test_quantize_q_range_error_matches(q_bits):
    x, rbits, scale = _wire_inputs(256, 0)
    with pytest.raises(ValueError) as jerr:
        jsq.quantize(jnp.asarray(x), jnp.asarray(rbits), jnp.float32(scale), q_bits,
                     interpret=True)
    with pytest.raises(ValueError) as terr:
        tsq.quantize(_t(x), _t(rbits), torch.tensor([scale]), q_bits)
    assert str(terr.value) == str(jerr.value)


def test_plane_in_range_matches():
    idx, _s, _sc, _w, q = _agg_inputs(6, 64, 12, np.uint16, seed=9)
    idx[2, 0, 0] = 2 ** 13                    # one corrupted plane
    want = np.asarray(jsq.plane_in_range(jnp.asarray(idx), jnp.asarray(q)))
    got = tsq.plane_in_range(_t(idx), _t(q)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[2] or q[2] >= 14


def test_wrappers_check_inputs():
    x, rbits, scale = _wire_inputs(256, 1)
    with pytest.raises(TypeError):
        tsq.quantize(_t(x).double(), _t(rbits), torch.tensor([scale]), 4)
    with pytest.raises(ValueError):
        tsq.quantize(_t(x)[:, :64], _t(rbits)[:, :64], torch.tensor([scale]), 4)
    with pytest.raises(ValueError):
        tsq.quantize(_t(x), _t(rbits), torch.tensor([scale, scale]), 4)
    idx, signs, scales, w, q = _agg_inputs(3, 16, 8, np.uint8, seed=1)
    with pytest.raises(ValueError):
        tsq.aggregate(_t(idx), _t(signs)[:2], _t(scales), _t(w), _t(q))
    with pytest.raises(ValueError):
        tsq.aggregate(_t(idx), _t(signs), _t(scales), _t(w), _t(q)[:2])
    with pytest.raises(ValueError):
        tsq.aggregate(_t(idx).transpose(1, 2), _t(signs), _t(scales), _t(w), _t(q))
