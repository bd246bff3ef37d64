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


# ---------------------------------------------------- dequantize's variants

def _plane_at(m, byte_offset, dtype=torch.uint8):
    """A contiguous (m, 128) plane starting ``byte_offset`` bytes past a
    16-byte boundary of a larger buffer."""
    es = torch.empty((), dtype=dtype).element_size()
    buf = torch.zeros(m * 128 + 64 // es, dtype=dtype)
    lead = ((-buf.data_ptr()) % 16 + byte_offset) // es
    return buf[lead:lead + m * 128].view(m, 128)


@pytest.mark.parametrize("idx_off,signs_off,out_off,want", [
    (0, 0, 0, "vec4"),        # fresh planes
    (16, 48, 0, "vec4"),      # views at other 16-byte boundaries
    (4, 8, 0, "vec4"),        # the planes need only 4-byte words
    (1, 0, 0, "scalar"),      # idx one byte off
    (0, 2, 0, "scalar"),      # signs 2 bytes off
    (0, 0, 4, "scalar"),      # out one fp32 element off a 16-byte boundary
], ids=["aligned", "offset-16", "offset-4-8", "idx-offset-1", "signs-offset-2",
        "out-offset-4"])
def test_dequantize_variant(idx_off, signs_off, out_off, want):
    idx, signs = _plane_at(4, idx_off), _plane_at(4, signs_off)
    out = _plane_at(4, out_off, torch.float32)
    assert tsq.dequantize_variant(idx, signs, out) == want


def test_dequantize_variant_of_row_slices():
    # rows of a (M, 128) plane start 128 bytes apart: every row slice of an
    # aligned plane stays aligned; a flat view 2 bytes in does not
    plane = _plane_at(8, 0)
    out = torch.empty((5, 128))
    assert tsq.dequantize_variant(plane[3:], plane[1:6], out) == "vec4"
    flat = _plane_at(8, 0).reshape(-1)
    odd = flat[2:2 + 256].view(2, 128)
    assert tsq.dequantize_variant(odd, plane[:2], out) == "scalar"


@pytest.mark.parametrize("idx_off,entry", [(0, "sq_dequantize_vec4"), (3, "sq_dequantize")])
def test_dequantize_launches_its_variant(monkeypatch, idx_off, entry):
    """The wrapper hands an aligned view to the 4-element kernel and an
    offset one to the one-element kernel, each counted as one launch; a
    strided plane is refused before any library call."""
    from repro_torch.kernels import build

    called = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: called.append(name) or 0

    monkeypatch.setattr(build, "route", lambda name, *tensors: True)
    monkeypatch.setattr(build, "library", lambda name: Lib())
    monkeypatch.setattr(build, "stream", lambda dev: 0)
    idx, signs = _plane_at(16, idx_off), _plane_at(16, 0)
    tsq.reset_launches()
    tsq.dequantize(idx, signs, torch.ones(1), 4)
    assert called == [entry] and tsq.launches["dequantize"] == 1
    with pytest.raises(ValueError, match="contiguous"):
        tsq.dequantize(_plane_at(16, 0).t().contiguous().t(), signs, torch.ones(1), 4)
    assert called == [entry]


def test_dequantize_of_an_offset_view_equals_the_aligned_copy():
    x, rbits, scale = _wire_inputs(64, 3)
    idx, signs = tsq.quantize(_t(x), _t(rbits), torch.tensor([scale]), 5)
    view = _plane_at(64, 5)
    view.copy_(idx)
    assert tsq.dequantize_variant(view, signs, torch.empty(64, 128)) == "scalar"
    assert torch.equal(tsq.dequantize(view, signs, torch.tensor([scale]), 5),
                       tsq.dequantize(idx, signs, torch.tensor([scale]), 5))


# ------------------------------------------------------ quantize's variants

@pytest.mark.parametrize("x_off,rbits_off,idx_off,signs_off,want", [
    (0, 0, 0, 0, "vec4"),       # fresh planes
    (16, 32, 4, 8, "vec4"),     # views at other 16-byte (inputs), 4-byte (planes) boundaries
    (4, 0, 0, 0, "scalar"),     # x one fp32 element off a 16-byte boundary
    (0, 8, 0, 0, "scalar"),     # rbits two elements off
    (0, 0, 1, 0, "scalar"),     # idx one byte off
    (0, 0, 0, 2, "scalar"),     # signs 2 bytes off
], ids=["aligned", "offset-16-4", "x-offset-4", "rbits-offset-8", "idx-offset-1",
        "signs-offset-2"])
def test_quantize_variant(x_off, rbits_off, idx_off, signs_off, want):
    x = _plane_at(4, x_off, torch.float32)
    rbits = _plane_at(4, rbits_off, torch.int32).view(torch.uint32)
    idx, signs = _plane_at(4, idx_off), _plane_at(4, signs_off)
    assert tsq.quantize_variant(x, rbits, idx, signs) == want


def test_quantize_variant_of_a_ragged_flat_view():
    # a size that is not a multiple of 4 takes the one-element kernel even
    # on aligned pointers (the wrappers only pass (M, 128) planes, but the
    # rule is the kernel's own)
    x = _plane_at(1, 0, torch.float32).reshape(-1)[:6]
    rbits = _plane_at(1, 0, torch.int32).view(torch.uint32).reshape(-1)[:6]
    idx, signs = _plane_at(1, 0).reshape(-1)[:6], _plane_at(1, 0).reshape(-1)[:6]
    assert tsq.quantize_variant(x, rbits, idx, signs) == "scalar"
    assert tsq.quantize_variant(x[:4], rbits[:4], idx[:4], signs[:4]) == "vec4"


@pytest.mark.parametrize("x_off,entry", [(0, "sq_quantize_vec4"), (4, "sq_quantize")])
def test_quantize_launches_its_variant(monkeypatch, x_off, entry):
    """The wrapper hands aligned planes to the 4-element kernel and an
    offset x to the one-element kernel, each counted as one launch (the
    planes it allocates are always aligned)."""
    from repro_torch.kernels import build

    called = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: called.append(name) or 0

    monkeypatch.setattr(build, "route", lambda name, *tensors: True)
    monkeypatch.setattr(build, "library", lambda name: Lib())
    monkeypatch.setattr(build, "stream", lambda dev: 0)
    x = _plane_at(16, x_off, torch.float32)
    rbits = _plane_at(16, 0, torch.int32).view(torch.uint32)
    tsq.reset_launches()
    tsq.quantize(x, rbits, torch.ones(1), 4)
    assert called == [entry] and tsq.launches["quantize"] == 1
