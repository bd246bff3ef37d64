"""The flash-attention wrapper's host side, on the CPU: which kernel a CUDA
call would take (``_kernel_route``), the tensor-map plans the wgmma kernel
is encoded from, the refusals that come before any CUDA call, and the
numerics that made the wgmma kernel split p into two bf16 halves.

Nothing here launches a kernel: tensors on the CPU stand in for tensors on
the card, since the route depends only on dtype, shapes, strides and data
pointers. The kernels themselves are held against the plain version on the
card (``tests/test_torch_cuda_kernels.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa


def _aligned(shape, dtype=torch.bfloat16):
    """A (B, L, heads, hd) tensor whose data pointer is a multiple of 16
    bytes (the CPU allocator aligns to at least 64)."""
    x = torch.zeros(shape, dtype=dtype)
    assert x.data_ptr() % 16 == 0
    return x


def _strided(shape, strides, dtype=torch.bfloat16, offset=0):
    """A view with the given element strides into an aligned buffer."""
    span = offset + 1 + sum((n - 1) * st for n, st in zip(shape, strides))
    return torch.zeros(span, dtype=dtype).as_strided(shape, strides, offset)


# name -> (q, k, v, route)
def _route_cases():
    q = _aligned((2, 300, 8, 128))
    kv = _aligned((2, 300, 2, 128))
    stack = _aligned((2, 2, 2, 300, 2, 128))           # (L, k/v, B, T, KV, hd) cache
    wide = _aligned((2, 300, 8, 80))
    return {
        "bf16 contiguous": (q, kv, kv, "wgmma"),
        "bf16 hd 64": (_aligned((1, 77, 4, 64)), _aligned((1, 99, 4, 64)),
                       _aligned((1, 99, 4, 64)), "wgmma"),
        "bf16 hd 32 (head stride 64 bytes)": (_aligned((1, 50, 4, 32)), _aligned((1, 50, 1, 32)),
                                              _aligned((1, 50, 1, 32)), "wgmma"),
        "bf16 head-slice view of q": (_aligned((2, 300, 16, 128))[:, :, ::2], kv, kv, "wgmma"),
        "bf16 per-layer k/v views": (q, stack[1, 0], stack[1, 1], "wgmma"),
        "bf16 hd slice of a wider row": (wide[..., :64], _aligned((2, 300, 2, 80))[..., :64],
                                         _aligned((2, 300, 2, 80))[..., :64], "wgmma"),
        "fp32 contiguous": (q.float(), kv.float(), kv.float(), "simt"),
        "bf16 hd 36 (head stride 72 bytes)": (_aligned((1, 50, 4, 36)), _aligned((1, 50, 2, 36)),
                                              _aligned((1, 50, 2, 36)), "simt"),
        "bf16 q 2 bytes past a boundary": (wide[..., 1:65], kv[..., :64], kv[..., :64], "simt"),
        "bf16 v misaligned, q and k aligned": (q, kv, _strided((2, 300, 2, 128),
                                                              (76800, 256, 128, 1), offset=4),
                                               "simt"),
        "bf16 position stride 8 bytes": (_strided((1, 40, 1, 4), (160, 4, 4, 1)),
                                         _aligned((1, 40, 1, 4)), _aligned((1, 40, 1, 4)), "simt"),
        "bf16 heads broadcast (stride 0)": (q, kv.expand(2, 300, 2, 128)[:, :, :1].expand(
            2, 300, 2, 128), kv, "simt"),
    }


ROUTE_CASES = _route_cases()


@pytest.mark.parametrize("name", list(ROUTE_CASES))
def test_kernel_route(name):
    q, k, v, want = ROUTE_CASES[name]
    assert fa._kernel_route(q, k, v) == want


def test_tma_plan_of_the_serve_shape():
    # Llama-3-8B prefill: q (4, 4096, 32, 128), k and v (4, 4096, 8, 128), bf16
    q = _strided((4, 4096, 32, 128), (4096 * 32 * 128, 32 * 128, 128, 1))
    k = _strided((4, 4096, 8, 128), (4096 * 8 * 128, 8 * 128, 128, 1))
    assert fa.tma_plan(q, fa.WGMMA_BLOCK_Q) == (
        128, 32, 4096, 4, 256, 8192, 33554432, 64, 1, 128, 1)
    assert fa.tma_plan(k, fa.WGMMA_BLOCK_K) == (
        128, 8, 4096, 4, 256, 2048, 8388608, 64, 1, 64, 1)


def test_tma_box_is_one_swizzled_row_and_the_tiles_fit_a_box():
    # one box row is the 128-byte swizzle span that wgmma's descriptors assume
    assert fa.TMA_BOX_COLS * torch.bfloat16.itemsize == 128
    # TMA boxes hold at most 256 rows; wgmma takes 64-row warpgroup tiles
    for rows in (fa.WGMMA_BLOCK_Q, fa.WGMMA_BLOCK_K):
        assert rows <= 256 and rows % 64 == 0


@pytest.mark.parametrize("shape,strides,want", [
    ((2, 10, 3, 16), (480, 48, 16, 1), (32, 96, 960)),
    ((1, 10, 3, 16), (7, 48, 16, 1), (32, 96, 960)),        # size-1 batch: stride replaced
    ((2, 10, 1, 16), (160, 16, 5, 1), (32, 32, 320)),       # one head: stride replaced
    ((2, 10, 1, 36), (360, 36, 9, 1), (80, 72, 720)),       # replaced by the row, rounded up
    ((2, 1, 4, 64), (512, 3, 64, 1), (128, 512, 1024)),     # one position
], ids=["contiguous", "batch-1", "head-1", "head-1-rounded", "position-1"])
def test_tma_strides(shape, strides, want):
    assert fa.tma_strides(_strided(shape, strides)) == want


@pytest.mark.parametrize("shape,strides,offset,want", [
    ((1, 8, 2, 64), (1024, 128, 64, 1), 0, True),
    ((1, 8, 2, 64), (1024, 128, 64, 1), 8, True),            # 16 bytes in
    ((1, 8, 2, 64), (1024, 128, 64, 1), 4, False),           # 8 bytes in
    ((1, 8, 2, 60), (960, 120, 60, 1), 0, False),            # 120-byte head stride
    ((1, 8, 2, 64), (1024, 128, 64, 2), 0, False),           # hd not unit-stride
    ((1, 8, 2, 64), (1024, 0, 64, 1), 0, False),             # positions broadcast
], ids=["aligned", "offset-16B", "offset-8B", "stride-120B", "hd-stride-2", "stride-0"])
def test_tma_describable(shape, strides, offset, want):
    assert fa.tma_describable(_strided(shape, strides, offset=offset)) is want


class _FakeTensor:
    """What the route reads of a tensor, for strides no real buffer could
    hold."""

    def __init__(self, shape, strides, ptr=0):
        self.shape, self._strides, self._ptr = shape, strides, ptr

    def stride(self, d):
        return self._strides[d]

    def element_size(self):
        return 2

    def data_ptr(self):
        return self._ptr


@pytest.mark.parametrize("batch_stride,want", [(2**39 - 8, True), (2**39, False)])
def test_tma_describable_bounds_the_stride(batch_stride, want):
    # byte strides must stay below 2^40
    x = _FakeTensor((2, 3, 2, 8), (batch_stride, 8, 8, 1))
    assert fa.tma_describable(x) is want


# name -> (q, k, v, the SIMT kernel's load variant)
def _variant_cases():
    q = _aligned((2, 300, 8, 128), torch.float32)
    kv = _aligned((2, 300, 2, 128), torch.float32)
    stack = _aligned((2, 2, 2, 300, 2, 128), torch.float32)
    wide = _aligned((2, 300, 2, 129), torch.float32)
    return {
        "fp32 contiguous": (q, kv, kv, "async"),
        "fp32 per-layer k/v views": (q, stack[1, 0], stack[1, 1], "async"),
        "fp32 head-slice view of q (q is not streamed)": (
            _aligned((2, 300, 16, 128), torch.float32)[:, :, 1::2], kv, kv, "async"),
        "fp32 k 4 bytes past a boundary": (q, _strided((2, 300, 2, 128), (76800, 256, 128, 1),
                                                       torch.float32, offset=1), kv, "sync"),
        "fp32 rows of 129 floats": (q, wide[..., :128], kv, "sync"),
        "fp32 hd 30": (_aligned((1, 50, 4, 30), torch.float32), _aligned((1, 50, 2, 30), torch.float32),
                       _aligned((1, 50, 2, 30), torch.float32), "sync"),
        "fp32 batch of one with an odd batch stride": (
            q[:1], _strided((1, 300, 2, 128), (7, 256, 128, 1), torch.float32), kv[:1], "async"),
        "fp32 heads broadcast (stride 0)": (q, kv[:, :, :1].expand(2, 300, 2, 128), kv, "async"),
        "bf16 aligned": (q.bfloat16(), kv.bfloat16(), kv.bfloat16(), "sync"),
    }


VARIANT_CASES = _variant_cases()


@pytest.mark.parametrize("name", list(VARIANT_CASES))
def test_load_variant(name):
    q, k, v, want = VARIANT_CASES[name]
    assert fa._load_variant(q, k, v) == want


@pytest.fixture
def as_if_on_the_card(monkeypatch):
    """CPU tensors take the kernel route; building or loading a library
    fails the test, so a refusal must come before any CUDA call."""
    def no_library(name):
        raise AssertionError(f"the library {name!r} was asked for")

    monkeypatch.setattr(build, "route", lambda name, *tensors: True)
    monkeypatch.setattr(build, "library", no_library)
    fa.reset_launches()
    yield
    assert fa.launches == {"flash_attention": 0, "flash_attention_wgmma": 0,
                           "flash_attention_simt": 0}


@pytest.mark.parametrize("case,error,match", [
    ("fp16", TypeError, "fp32 or bf16"),
    ("mixed-dtypes", TypeError, "fp32 or bf16"),
    ("hd-256", ValueError, "head dims up to 128"),
    ("hd-not-unit-stride", ValueError, "unit stride on the head dim"),
    ("grid-too-tall", ValueError, "65535"),
    ("negative-window", ValueError, "window"),
    ("heads-not-multiple", ValueError, "not a multiple"),
])
def test_refusals_come_before_any_cuda_call(as_if_on_the_card, case, error, match):
    q = _aligned((1, 64, 4, 64))
    k = v = _aligned((1, 64, 2, 64))
    kw = {}
    if case == "fp16":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "mixed-dtypes":
        q = q.float()
    elif case == "hd-256":
        q, k, v = _aligned((1, 64, 4, 256)), _aligned((1, 64, 2, 256)), _aligned((1, 64, 2, 256))
    elif case == "hd-not-unit-stride":
        q = _aligned((1, 64, 4, 128))[..., ::2]
    elif case == "grid-too-tall":
        q, k, v = _aligned((65536, 1, 1, 8)), _aligned((65536, 1, 1, 8)), _aligned((65536, 1, 1, 8))
    elif case == "negative-window":
        kw = dict(window=-1)
    elif case == "heads-not-multiple":
        q = _aligned((1, 64, 3, 64))
    with pytest.raises(error, match=match):
        fa.flash_attention(q, k, v, **kw)


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wgmma"), (torch.float32, "simt")])
def test_a_sound_call_reaches_its_library(monkeypatch, dtype, route):
    # the wrapper asks for the route's library, and nothing before that raises
    asked = []

    def library(name):
        asked.append(name)
        raise RuntimeError("stop before the launch")

    monkeypatch.setattr(build, "route", lambda name, *tensors: True)
    monkeypatch.setattr(build, "library", library)
    q = _aligned((1, 64, 4, 64), dtype)
    k = _aligned((1, 64, 2, 64), dtype)
    with pytest.raises(RuntimeError, match="stop before the launch"):
        fa.flash_attention(q, k, k)
    assert asked == ["flash_attention_wgmma" if route == "wgmma" else "flash_attention"]


@pytest.mark.parametrize("causal,window,want", [(False, 0, 0), (True, 0, 8192 - 100),
                                                (False, 300, 8192 - 100)])
def test_offset_reaches_the_kernels_only_where_the_mask_reads_it(monkeypatch, causal, window,
                                                                 want):
    """A non-causal call without a window passes the kernels no offset (the
    instantiation without it runs); a causal or windowed one passes
    ``q_offset - k_offset``."""
    seen = []
    monkeypatch.setattr(build, "route", lambda name, *tensors: True)
    monkeypatch.setattr(fa, "_launch", lambda *a, **kw: seen.append(kw["off"]))
    q = _aligned((1, 64, 4, 64))
    k = _aligned((1, 64, 2, 64))
    fa.flash_attention(q, k, k, causal=causal, window=window, q_offset=8192, k_offset=100)
    assert seen == [want]


# ------------------------------------------------------------ why p is split

def _bf16(x: np.ndarray) -> np.ndarray:
    """Round fp32 values to bf16 (nearest, ties to even), kept as fp32."""
    bits = np.asarray(x, dtype=np.float32).view(np.uint32)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & np.uint32(0xFFFF0000)
    return bits.view(np.float32)


def _serve_like(seed, rows=64, t=4096, hd=64):
    """fp32 p in [0, 1] of one softmax tile row block at T keys (scores of
    0.3-scaled bf16 q and k, as chip_smoke draws them), and bf16 v."""
    rng = np.random.default_rng(seed)
    q = _bf16(0.3 * rng.standard_normal((rows, 128)).astype(np.float32))
    k = _bf16(0.3 * rng.standard_normal((t, 128)).astype(np.float32))
    v = _bf16(0.3 * rng.standard_normal((t, hd)).astype(np.float32))
    s = (q @ k.T).astype(np.float32) * np.float32(128 ** -0.5)
    p = np.exp(s - s.max(axis=1, keepdims=True)).astype(np.float32)
    return p, v


def test_bf16_rounding_helper():
    x = np.array([1.0, 1.0 + 2**-8, 1.0 + 3 * 2**-8, 1.0 + 2**-9, -2.5], np.float32)
    # ties go to the even neighbour: 1 + 2^-8 -> 1, 1 + 3 * 2^-8 -> 1 + 2^-6
    assert _bf16(x).tolist() == [1.0, 1.0, 1.0 + 2**-6, 1.0, -2.5]
    y = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    assert np.all(np.abs(_bf16(y) - y) <= 2**-8 * np.abs(y))
    assert np.array_equal(_bf16(_bf16(y)), _bf16(y))


@pytest.mark.parametrize("seed", [0, 1])
def test_split_p_reproduces_p_v_within_2_to_minus_16(seed):
    p, v = _serve_like(seed)
    hi = _bf16(p)
    lo = _bf16(p - hi)                       # p - hi is exact in fp32
    assert np.array_equal((p - hi).astype(np.float64), p.astype(np.float64) - hi)
    exact = p.astype(np.float64) @ v.astype(np.float64)
    split = (hi.astype(np.float64) + lo) @ v.astype(np.float64)
    scale = np.abs(p).astype(np.float64) @ np.abs(v).astype(np.float64)
    assert np.all(np.abs(split - exact) <= 2.0**-16 * scale)


@pytest.mark.parametrize("seed", [0, 1])
def test_single_bf16_p_misses_the_bf16_atol_where_the_split_meets_it(seed):
    # out = (p @ v) / l at T = 4096: FLASH_TOL's bf16 atol is 1e-6
    atol = 1e-6
    p, v = _serve_like(seed)
    l = p.astype(np.float64).sum(axis=1, keepdims=True)
    exact = (p.astype(np.float64) @ v.astype(np.float64)) / l
    hi = _bf16(p)
    lo = _bf16(p - hi)
    single = (hi.astype(np.float64) @ v.astype(np.float64)) / l
    split = ((hi.astype(np.float64) + lo) @ v.astype(np.float64)) / l
    assert np.abs(single - exact).max() > 5 * atol
    assert np.abs(split - exact).max() < atol / 10
