"""The CUDA kernels (wire kernels, flash attention) against their plain
torch versions on the card, and the fleet round's policy modes, scenarios,
downlink, faults and segmented runs launching ``aggregate`` on the card.

Needs a CUDA device and nvcc (the library is built at first use); every
test here skips without a card. Run on the GPU machine with
``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_kernels.py``.
No JAX: the card's machine does not have it.
"""
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import stochastic_quant as sq


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    return torch.device("cuda")


def _planes(k, m, q_max, dtype, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randint(1, q_max + 1, (k,), generator=gen, device=dev)
    hi = ((torch.ones_like(q) << q) - 1)[:, None, None]
    idx = torch.minimum((torch.rand((k, m, 128), generator=gen, device=dev) * (hi + 1)).long(),
                        hi).to(dtype)
    signs = (torch.rand((k, m, 128), generator=gen, device=dev) < 0.5).to(torch.uint8)
    scales = torch.rand((k,), generator=gen, device=dev) + 0.1
    w = torch.rand((k,), generator=gen, device=dev)
    return idx, signs, scales, w / w.sum(), q


@pytest.mark.parametrize("k,m,q_max,dtype", [
    (8, 1984, 8, torch.uint8), (8, 1984, 16, torch.uint16), (1024, 37, 8, torch.uint8),
    (1, 1, 8, torch.uint8),
], ids=["main-path", "u16", "k1024-ragged", "k1-m1"])
def test_aggregate_kernel_matches_plain(cuda, k, m, q_max, dtype):
    idx, signs, scales, w, q = _planes(k, m, q_max, dtype, k + m, cuda)
    sq.reset_launches()
    got = sq.aggregate(idx, signs, scales, w, q)
    assert sq.launches["aggregate"] == 1
    want = sq.aggregate_plain(idx, signs, scales, w, q)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("offset", [0, 8, 3], ids=["aligned", "offset-8", "offset-3"])
def test_dequantize_variants_bit_equal(cuda, offset):
    """The 4-element kernel on planes at 4-byte boundaries, the one-element
    kernel on a view 3 bytes off; both bit-equal to the plain version, one
    launch each, the clamp included (a corrupted plane)."""
    gen = torch.Generator(device=cuda).manual_seed(offset)
    m = 2048
    buf = torch.randint(0, 256, (m * 128 + 64,), generator=gen, device=cuda).to(torch.uint8)
    idx = buf[offset:offset + m * 128].view(m, 128)
    signs = (torch.rand((m, 128), generator=gen, device=cuda) < 0.5).to(torch.uint8)
    scale = torch.rand((1,), generator=gen, device=cuda) + 0.5
    out = torch.empty((m, 128), device=cuda)
    want_variant = "scalar" if offset % 4 else "vec4"
    assert sq.dequantize_variant(idx, signs, out) == want_variant
    for q_bits in (1, 4, 8):
        sq.reset_launches()
        got = sq.dequantize(idx, signs, scale, q_bits)
        assert sq.launches["dequantize"] == 1
        assert torch.equal(got, sq.dequantize_plain(idx, signs, scale, q_bits))


@pytest.mark.parametrize("q_bits", [1, 2, 4, 8])
def test_quantize_dequantize_kernels_bit_equal(cuda, q_bits):
    gen = torch.Generator(device=cuda).manual_seed(q_bits)
    x = torch.randn((2048, 128), generator=gen, device=cuda) * 0.05
    rbits = ops.random_bits(x.shape, gen)
    scale = x.abs().amax().reshape(1)
    sq.reset_launches()
    idx, signs = sq.quantize(x, rbits, scale, q_bits)
    assert torch.equal(idx, sq.quantize_plain(x, rbits, scale, q_bits)[0])
    assert torch.equal(signs, sq.quantize_plain(x, rbits, scale, q_bits)[1])
    corrupt = torch.randint(0, 256, x.shape, generator=gen, device=cuda).to(torch.uint8)
    for planes in (idx, corrupt):
        assert torch.equal(sq.dequantize(planes, signs, scale, q_bits),
                           sq.dequantize_plain(planes, signs, scale, q_bits))
    assert sq.launches == {"aggregate": 0, "quantize": 1, "dequantize": 2}


@pytest.mark.parametrize("m,offset", [(2048, 0), (2048, 4), (37, 0), (37, 12)],
                         ids=["aligned", "offset-4", "ragged", "ragged-offset-12"])
def test_quantize_variants_bit_equal(cuda, m, offset):
    """The 4-element kernel on 16-byte aligned inputs, the one-element
    kernel on an x view ``offset`` bytes off a 16-byte boundary; both
    bit-equal to the plain version for every q, one launch each."""
    gen = torch.Generator(device=cuda).manual_seed(m + offset)
    buf = torch.empty(m * 128 + 16, device=cuda)
    x = buf[offset // 4:offset // 4 + m * 128].view(m, 128)
    x.copy_(torch.randn((m, 128), generator=gen, device=cuda) * 0.05)
    x[0, :4] = torch.tensor([0.0, -0.0, 1e-30, -1e-30], device=cuda)
    rbits = ops.random_bits(x.shape, gen)
    scale = x.abs().amax().reshape(1)
    want_variant = "scalar" if offset % 16 else "vec4"
    probe = torch.empty((m, 128), dtype=torch.uint8, device=cuda)
    assert sq.quantize_variant(x, rbits, probe, probe) == want_variant
    for q_bits in range(1, 9):
        sq.reset_launches()
        idx, signs = sq.quantize(x, rbits, scale, q_bits)
        assert sq.launches["quantize"] == 1
        want_idx, want_signs = sq.quantize_plain(x, rbits, scale, q_bits)
        assert torch.equal(idx, want_idx) and torch.equal(signs, want_signs), q_bits


def test_cuda_wrappers_reject_mixed_devices(cuda):
    x = torch.zeros((256, 128), device=cuda)
    rbits = torch.zeros((256, 128), dtype=torch.int32).view(torch.uint32)
    with pytest.raises(ValueError, match="several devices"):
        sq.quantize(x, rbits, torch.ones(1, device=cuda), 4)


# fp32 (SIMT kernel): both sides sum in fp32 in another order (64-key tiles
# against the plain version's 512-key blocks, FMAs against matmuls). bf16
# (wgmma kernel): fp32 scores and accumulator with p as two bf16 halves
# (2^-16 relative), so again only order and rounding differ; bf16 outputs may
# then round to neighbouring bf16 values, one ulp <= 2^-7 relative.
FLASH_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5), torch.bfloat16: dict(rtol=2**-7, atol=1e-6)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,s,t,h,kv,hd,causal,window", [
    (2, 256, 256, 8, 2, 128, True, 0),       # llama-style GQA 4:1, hd 128
    (1, 300, 300, 4, 4, 64, True, 100),      # ragged S = T, sliding window
    (2, 200, 333, 4, 1, 112, False, 0),      # non-causal, ragged S != T, hd 112
    (1, 130, 70, 6, 3, 32, False, 40),       # window without causality
    (1, 200, 50, 2, 1, 32, True, 30),        # rows past T + window are fully masked
    (1, 150, 150, 18, 2, 128, True, 64),     # g = 9 as StarCoder2: 126 of 128 rows used
    (2, 129, 300, 4, 4, 64, False, 0),       # g = 1: a second position tile of one row
], ids=["gqa4", "window", "ragged-noncausal", "window-noncausal", "masked-rows", "gqa9",
        "gqa1-ragged"])
def test_flash_kernel_matches_plain(cuda, dtype, b, s, t, h, kv, hd, causal, window):
    gen = torch.Generator(device=cuda).manual_seed(s + t + h)
    q = (0.3 * torch.randn((b, s, h, hd), generator=gen, device=cuda)).to(dtype)
    k = (0.3 * torch.randn((b, t, kv, hd), generator=gen, device=cuda)).to(dtype)
    v = (0.3 * torch.randn((b, t, kv, hd), generator=gen, device=cuda)).to(dtype)
    route = "wgmma" if dtype == torch.bfloat16 else "simt"
    _check_flash(q, k, v, causal, window, route)


def _check_flash(q, k, v, causal, window, route):
    """One launch through ``route``, against the plain version on the card."""
    fa.reset_launches()
    out, lse = fa.flash_attention(q, k, v, causal=causal, window=window, with_lse=True)
    assert fa.launches == {"flash_attention": 1, "flash_attention_" + route: 1,
                           "flash_attention_" + ("simt" if route == "wgmma" else "wgmma"): 0}
    want, want_lse = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                              with_lse=True)
    torch.cuda.synchronize()
    assert out.dtype == q.dtype and lse.dtype == torch.float32
    torch.testing.assert_close(out.float(), want.float(), **FLASH_TOL[q.dtype])
    torch.testing.assert_close(lse, want_lse, rtol=2e-5, atol=2e-5)


def _bf16_inputs(b, s, t, h, kv, hd, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [(0.3 * torch.randn(shape, generator=gen, device=dev)).to(torch.bfloat16)
            for shape in ((b, s, h, hd), (b, t, kv, hd), (b, t, kv, hd))]


@pytest.mark.parametrize("b,s,t,h,kv,hd,causal,window", [
    (1, 333, 333, 8, 8, 128, True, 0),       # GQA 1, S = T not a multiple of 128
    (2, 200, 461, 8, 2, 64, False, 0),       # GQA 4, hd 64, ragged S != T
    (1, 389, 389, 16, 2, 128, True, 0),      # GQA 8
    (2, 300, 300, 12, 2, 128, True, 0),      # GQA 6 (InternVL2's 48 heads over 8)
    (1, 700, 700, 8, 1, 128, True, 64),      # causal window narrower than a tile
    (1, 600, 200, 4, 2, 64, False, 50),      # query tiles past T + window: empty KV range
    (1, 130, 1000, 4, 4, 96, True, 0),       # causal with T > S, hd 96 (second box half padded)
    (2, 512, 512, 8, 8, 112, True, 512),     # Zamba2's shared attention: hd 112, window = S
    (1, 700, 700, 4, 4, 112, True, 200),     # hd 112, S > window: tiles past the window
], ids=["gqa1", "gqa4-hd64", "gqa8", "gqa6", "window64", "empty-range", "hd96", "hd112",
        "hd112-window"])
def test_flash_wgmma_matches_plain(cuda, b, s, t, h, kv, hd, causal, window):
    q, k, v = _bf16_inputs(b, s, t, h, kv, hd, s + t + hd, cuda)
    assert fa._kernel_route(q, k, v) == "wgmma"
    _check_flash(q, k, v, causal, window, "wgmma")


def test_flash_wgmma_takes_strided_views(cuda):
    # k/v as per-layer views of a stacked (L, B, T, KV, hd) tensor, q a head slice
    gen = torch.Generator(device=cuda).manual_seed(6)
    stack = (0.3 * torch.randn((2, 2, 2, 300, 2, 128), generator=gen, device=cuda)).bfloat16()
    q = (0.3 * torch.randn((2, 300, 8, 128), generator=gen, device=cuda)).bfloat16()[:, :, ::2]
    k, v = stack[1, 0], stack[1, 1]
    _check_flash(q, k, v, True, 0, "wgmma")


@pytest.mark.parametrize("case", ["hd36", "offset"])
def test_flash_bf16_that_tma_cannot_describe_takes_simt(cuda, case):
    if case == "hd36":      # head stride 72 bytes: not a multiple of 16
        q, k, v = _bf16_inputs(1, 150, 150, 4, 2, 36, 7, cuda)
    else:                   # base pointers 2 bytes past a 16-byte boundary
        q, k, v = (x[..., 1:65] for x in _bf16_inputs(1, 150, 150, 4, 2, 80, 8, cuda))
    assert fa._kernel_route(q, k, v) == "simt"
    _check_flash(q, k, v, True, 0, "simt")


def test_flash_kernel_takes_strided_views(cuda):
    # k/v as per-layer views of a stacked (L, B, T, KV, hd) tensor, q a head slice
    gen = torch.Generator(device=cuda).manual_seed(5)
    stack = 0.3 * torch.randn((2, 2, 2, 128, 2, 64), generator=gen, device=cuda)
    q = (0.3 * torch.randn((2, 128, 8, 64), generator=gen, device=cuda))[:, :, ::2]
    k, v = stack[1, 0], stack[1, 1]
    torch.testing.assert_close(fa.flash_attention(q, k, v),
                               fa.flash_attention_plain(q, k, v), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("case,variant", [
    ("contiguous", "async"), ("per-layer views", "async"), ("odd position stride", "sync"),
    ("hd 30", "sync"), ("4 bytes off", "sync"),
])
def test_flash_kernel_load_variants(cuda, case, variant):
    """fp32 K/V that cp.async can copy take the async variant, anything
    else the register-staged one; both match the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(len(case))
    b, t, kv, hd = 2, 300, 2, 64

    def randn(*shape):
        return 0.3 * torch.randn(shape, generator=gen, device=cuda)

    q = randn(b, 280, 8, hd)
    if case == "contiguous":
        k, v = randn(b, t, kv, hd), randn(b, t, kv, hd)
    elif case == "per-layer views":
        stack = randn(2, 2, b, t, kv, hd)
        k, v = stack[1, 0], stack[1, 1]
    elif case == "odd position stride":          # rows of hd + 1 floats
        k, v = randn(b, t, kv, hd + 1)[..., :hd], randn(b, t, kv, hd + 1)[..., :hd]
    elif case == "hd 30":
        q, k, v = randn(b, 280, 8, 30), randn(b, t, kv, 30), randn(b, t, kv, 30)
    else:                                        # base pointer one float past a boundary
        k = randn(b * t * kv * hd + 1)[1:].view(b, t, kv, hd)
        v = randn(b, t, kv, hd)
    assert fa._load_variant(q, k, v) == variant
    _check_flash(q, k, v, True, 0, "simt")


def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros((1, 64, 2, 64), device=cuda)
    fa.reset_launches()
    with pytest.raises(TypeError, match="fp32 or bf16"):
        fa.flash_attention(q.half(), q.half(), q.half())
    big = torch.zeros((1, 64, 2, 256), device=cuda)
    with pytest.raises(ValueError, match="head dims up to 128"):
        fa.flash_attention(big, big, big)
    with pytest.raises(ValueError, match="several devices"):
        fa.flash_attention(q, q.cpu(), q)
    assert fa.launches == {"flash_attention": 0, "flash_attention_wgmma": 0,
                           "flash_attention_simt": 0}


@pytest.mark.parametrize("mode,q_cap", [
    ("greedy", 8), ("compiled-ga", 8), ("no_quant", 16), ("channel_allocate", 16),
    ("principle", 16), ("same_size", 16),
])
def test_policy_modes_launch_aggregate_once_per_round(cuda, mode, q_cap):
    """Every mode's round launches the kernel once, on u8 planes up to
    q_cap 8 and u16 above, and replays through its numpy oracle."""
    from repro_torch.core.genetic import GAConfig
    from repro_torch.sim import build_sim

    kw = dict(n_clients=8, n_channels=4, seed=0, n_test=32, q_cap=q_cap, policy_mode=mode,
              ga_config=GAConfig(generations=3, population=6, repair_infeasible=True))
    sim = build_sim("tiny", **kw)
    real, dtypes = sq.aggregate, []

    def spy(idx, *args, **kwargs):
        dtypes.append(idx.dtype)
        return real(idx, *args, **kwargs)

    sq.reset_launches()
    with mock.patch.object(sq, "aggregate", spy):
        res = sim.run_compiled(3)
    assert sq.launches["aggregate"] == 3
    assert dtypes == [torch.uint8 if q_cap <= 8 else torch.uint16] * 3
    assert res.n_scheduled.max() > 0 and np.isfinite(res.energy).all()
    host_sim = build_sim("tiny", **kw)
    host = host_sim.run_host_policy(host_sim.make_host_policy(), 3)
    np.testing.assert_array_equal(res.q_levels, np.stack([r.q_levels for r in host.records]))
    np.testing.assert_allclose(res.energy, [r.energy for r in host.records], rtol=1e-5,
                               atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16], ids=["u8", "u16"])
def test_aggregate_with_screened_slots_bit_equal(cuda, dtype):
    """The fault path's aggregate: slots whose planes were corrupted and
    whose range went NaN enter with range and weight 0 (coefficient 0), as
    the engine's screen leaves them; the kernel equals its plain version
    bit for bit and those slots add nothing."""
    from repro_torch.sim import engine
    from repro_torch.sim.entropy import DeviceEntropy
    from repro_torch.sim.scenario import FaultSpec

    k, m = 8, 1984
    q_max = 8 if dtype == torch.uint8 else 16
    idx, signs, scales, w, q = _planes(k, m, q_max, dtype, 11, cuda)
    draws = DeviceEntropy(3, cuda).fault_draws(0, k, k, m * 128)
    fv = torch.tensor(FaultSpec(corrupt_p=1.0, corrupt_frac=0.3).dyn_vector(), device=cuda)
    bad = torch.zeros(k, dtype=torch.bool, device=cuda)
    bad[[2, 5]] = True
    draws.hit = torch.where(bad, draws.hit * 0.0, draws.hit + 2.0)   # corrupt slots 2 and 5
    idx_c, signs_c = engine.corrupt_planes(draws.hit, draws.site, draws.bits,
                                           idx.reshape(k, -1), signs.reshape(k, -1), fv)
    theta = torch.where(bad, torch.full_like(scales, float("nan")), scales)
    ok = torch.isfinite(theta)
    w_ok = torch.where(ok, w, torch.zeros_like(w))
    w_ok = w_ok / w_ok.sum()
    theta_c = torch.where(ok, theta, torch.zeros_like(theta))
    idx_c, signs_c = idx_c.reshape(k, m, 128), signs_c.reshape(k, m, 128)
    assert not torch.equal(idx_c[2].to(torch.int32), idx[2].to(torch.int32))
    sq.reset_launches()
    got = sq.aggregate(idx_c, signs_c, theta_c, w_ok, q)
    assert sq.launches["aggregate"] == 1
    assert torch.equal(got, sq.aggregate_plain(idx_c, signs_c, theta_c, w_ok, q))
    # the corrupted planes add nothing: the same sum over the clean planes
    assert torch.equal(got, sq.aggregate_plain(idx, signs, theta_c, w_ok, q))


def test_corrupt_planes_u16_card_equals_cpu(cuda):
    from repro_torch.sim import engine
    from repro_torch.sim.entropy import DeviceEntropy
    from repro_torch.sim.scenario import FaultSpec

    s, zpad = 8, 1984 * 128
    gen = torch.Generator().manual_seed(5)
    idx = torch.randint(0, 2**16, (s, zpad), generator=gen, dtype=torch.int32).to(torch.uint16)
    signs = (torch.rand((s, zpad), generator=gen) < 0.5).to(torch.uint8)
    draws = DeviceEntropy(9, "cpu").fault_draws(0, s, s, zpad)
    fv = torch.from_numpy(FaultSpec(corrupt_p=0.7, corrupt_frac=0.2).dyn_vector())
    cpu = engine.corrupt_planes(draws.hit, draws.site, draws.bits, idx, signs, fv)
    card = engine.corrupt_planes(draws.hit.to(cuda), draws.site.to(cuda), draws.bits.to(cuda),
                                 idx.to(cuda), signs.to(cuda), fv.to(cuda))
    assert card[0].dtype == torch.uint16
    for a, b in zip(cpu, card):
        assert torch.equal(a.to(torch.int32), b.cpu().to(torch.int32))
    assert not torch.equal(cpu[0].to(torch.int32), idx.to(torch.int32))


@pytest.mark.parametrize("kwargs", [
    {"scenario": "cellfree_a4"}, {"scenario": "noniid_a01"}, {"downlink": "delta"},
    {"scenario": "single_bs_faulty", "downlink": "quant"},
], ids=["cellfree", "noniid", "downlink-delta", "faulty-quant"])
def test_engine_options_launch_aggregate_once_per_round(cuda, kwargs):
    """Scenarios, the downlink and faults on the card: one ``aggregate``
    launch per round, and the compiled run equals its host replay."""
    from repro_torch.sim import build_sim

    kw = dict(n_clients=8, n_channels=4, seed=0, n_test=32, **kwargs)
    sim = build_sim("tiny", **kw)
    sq.reset_launches()
    res = sim.run_compiled(3)
    assert sq.launches["aggregate"] == 3
    assert res.n_scheduled.max() > 0 and torch.isfinite(sim.final_flat).all()
    host_sim = build_sim("tiny", **kw)
    host = host_sim.run_host_policy(host_sim.make_host_policy(), 3)
    np.testing.assert_array_equal(res.q_levels, np.stack([r.q_levels for r in host.records]))
    assert torch.equal(sim.final_flat, host_sim.final_flat)


def test_segmented_resume_on_card(cuda, tmp_path):
    """The card's generator state checkpoints and restores: segmented and
    resumed runs equal the unsegmented one bit for bit."""
    from repro_torch.sim import build_sim
    from repro_torch.sim.scenario import FaultSpec

    kw = dict(n_clients=8, n_channels=4, seed=0, n_test=32, downlink="delta",
              faults=FaultSpec(outage_p=0.2, corrupt_p=0.2, nan_p=0.1))
    full_sim = build_sim("tiny", **kw)
    full = full_sim.run_compiled(6)
    seg_sim = build_sim("tiny", **kw)
    seg = seg_sim.run_compiled(6, segment=2, ckpt_dir=str(tmp_path))
    res_sim = build_sim("tiny", **kw)
    resumed = res_sim.resume_compiled(str(tmp_path))
    for other, flat in ((seg, seg_sim.final_flat), (resumed, res_sim.final_flat)):
        for f in ("energy", "accuracy", "q_levels", "lambda1", "lambda2"):
            np.testing.assert_array_equal(getattr(full, f), getattr(other, f), err_msg=f)
        assert torch.equal(full_sim.final_flat, flat)


def test_run_compiled_twice_on_one_sim_bit_equal(cuda):
    """A run is a pure function of the sim on the card too: the generator
    rewinds to its state at build time."""
    from repro_torch.sim import build_sim

    sim = build_sim("tiny", n_clients=8, n_channels=4, seed=0, n_test=32)
    a = sim.run_compiled(3)
    flat = sim.final_flat.clone()
    b = sim.run_compiled(3)
    for f in ("energy", "accuracy", "q_levels", "lambda1", "lambda2"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert torch.equal(flat, sim.final_flat)


def test_engine_numbers_do_not_depend_on_the_callers_flags(cuda):
    """TF32 and cuDNN's autotuned algorithms set globally change nothing in
    a run, and come back as the caller set them."""
    from repro_torch.sim import build_sim

    flags = ((torch.backends.cudnn, "allow_tf32"), (torch.backends.cuda.matmul, "allow_tf32"),
             (torch.backends.cudnn, "deterministic"), (torch.backends.cudnn, "benchmark"))
    before = [getattr(mod, name) for mod, name in flags]
    sim = build_sim("tiny", n_clients=8, n_channels=4, seed=0, n_test=32)
    exact = sim.run_compiled(3)
    try:
        for (mod, name), value in zip(flags, (True, True, False, True)):
            setattr(mod, name, value)
        loose = sim.run_compiled(3)
        assert [getattr(mod, name) for mod, name in flags] == [True, True, False, True]
    finally:
        for (mod, name), value in zip(flags, before):
            setattr(mod, name, value)
    for f in ("energy", "accuracy", "loss", "q_levels", "lambda1", "lambda2"):
        np.testing.assert_array_equal(getattr(exact, f), getattr(loose, f), err_msg=f)


class _CpuDraws:
    """The default entropy source's draws made on the CPU and moved to the
    run's device, so a card run and a CPU run see the same numbers."""

    def __init__(self, seed, device):
        from repro_torch.sim.entropy import DeviceEntropy

        self.inner, self.device = DeviceEntropy(seed, "cpu"), torch.device(device)

    def rates(self, ridx, channel):
        import dataclasses

        host = dataclasses.replace(channel, distances=channel.distances.cpu())
        return self.inner.rates(ridx, host).to(self.device)

    def ga_draws(self, ridx, n_clients, n_channels, cfg):
        return self.inner.ga_draws(ridx, n_clients, n_channels, cfg).to(self.device)

    def batch_indices(self, ridx, n_s, tau, b):
        return self.inner.batch_indices(ridx, n_s.cpu(), tau, b).to(self.device)

    def uniforms(self, ridx, s, zpad):
        return self.inner.uniforms(ridx, s, zpad).to(self.device)


# card vs CPU on the same draws: q and the schedule are identical, so the
# exact-input taps are equal; the decision's float taps differ as the KKT's
# fp32 arithmetic does (and corr(q, D) by the order of its sums), within
# 1e-4; the wire error takes the SGD's last-bit differences, which move a
# coordinate whose uniform sits at a rounding boundary by one quantizer
# level (a few coordinates of ~5,000), so it is held to 5e-2
_TAP_EXACT = ("q_mean", "q_max", "n_timeout")


@pytest.mark.parametrize("mode", ["greedy", "compiled-ga"])
def test_telemetry_taps_card_equal_cpu(cuda, mode):
    from repro_torch.core.genetic import GAConfig
    from repro_torch.models import cnn
    from repro_torch.obs import METRIC_FIELDS, MetricsConfig
    from repro_torch.sim import build_sim

    params = cnn.init_params(cnn.TINY_CNN, 0, device="cpu")
    kw = dict(n_clients=8, n_channels=4, seed=0, n_test=64, init_params=params,
              policy_mode=mode, ga_config=GAConfig(generations=4, population=8, elitism=2,
                                                   repair_infeasible=True))
    runs = {}
    for dev in ("cuda", "cpu"):
        on = build_sim("tiny", device=dev, entropy=_CpuDraws(0, dev),
                       telemetry=MetricsConfig(enabled=True), **kw)
        off = build_sim("tiny", device=dev, entropy=_CpuDraws(0, dev), **kw)
        sq.reset_launches()
        runs[dev] = on.run_compiled(3)
        if dev == "cuda":
            assert sq.launches["aggregate"] == 3
        plain = off.run_compiled(3)
        # on changes only what is reported, on either device
        for f in ("energy", "accuracy", "loss", "q_levels", "rates", "lambda1", "lambda2"):
            np.testing.assert_array_equal(getattr(runs[dev], f), getattr(plain, f), err_msg=f)
        assert torch.equal(on.final_flat, off.final_flat)
    g, c = runs["cuda"].metrics, runs["cpu"].metrics
    np.testing.assert_array_equal(runs["cuda"].q_levels, runs["cpu"].q_levels)
    for f in METRIC_FIELDS:
        if f in _TAP_EXACT:
            np.testing.assert_array_equal(g[f], c[f], err_msg=f)
        elif f in ("quant_mse", "dl_mse"):
            np.testing.assert_allclose(g[f], c[f], rtol=5e-2, atol=0, equal_nan=True, err_msg=f)
        else:
            np.testing.assert_allclose(g[f], c[f], rtol=1e-4, atol=1e-12, equal_nan=True,
                                       err_msg=f)
    assert np.isfinite(g["ga_best"]).all() == (mode == "compiled-ga")


@pytest.mark.parametrize("kwargs", [
    {"policy_mode": "no_quant", "q_cap": 16}, {"scenario": "single_bs_faulty"},
    {"downlink": "delta"}, {"policy_mode": "same_size", "q_cap": 16},
], ids=["no_quant", "faults", "delta", "same_size"])
def test_telemetry_and_ledger_on_card(cuda, tmp_path, kwargs):
    """Every tap and a ledger on the card, in a baseline, under faults,
    with the downlink and a segmented run with its resume: outputs bit-equal
    to the run without telemetry, ``aggregate`` once per round, every ledger
    event valid."""
    from repro_torch.core.genetic import GAConfig
    from repro_torch.obs import Ledger, MetricsConfig, read_ledger
    from repro_torch.sim import build_sim

    kw = dict(n_clients=8, n_channels=4, seed=0, n_test=32,
              ga_config=GAConfig(generations=3, population=6, repair_infeasible=True), **kwargs)
    path = str(tmp_path / "run.jsonl")
    on = build_sim("tiny", telemetry=MetricsConfig(enabled=True), ledger=Ledger(path), **kw)
    sq.reset_launches()
    res = on.run_compiled(4, segment=2, ckpt_dir=str(tmp_path / "ck"))
    assert sq.launches["aggregate"] == 4
    plain = build_sim("tiny", **kw).run_compiled(4)
    for f in ("energy", "accuracy", "loss", "q_levels", "rates", "lambda1", "lambda2"):
        np.testing.assert_array_equal(getattr(res, f), getattr(plain, f), err_msg=f)
    resumed = build_sim("tiny", telemetry=MetricsConfig(enabled=True), ledger=Ledger(path),
                        **kw).resume_compiled(str(tmp_path / "ck"))
    for k, v in res.metrics.items():
        np.testing.assert_array_equal(resumed.metrics[k], v, err_msg=k)
    assert np.isfinite(res.metrics["q_mean"]).all() and np.isfinite(res.metrics["energy_comp"]).all()
    kinds = [e["event"] for e in read_ledger(path)]
    assert kinds.count("run_header") == 2 and kinds.count("resume") == 2
