"""The KKT wrapper (``repro_torch.kernels.kkt.solve_kkt``) on the CPU: it
runs the plain twin and never builds or loads the kernel's library; its
refusals (mixed devices, grad, dtype, contiguity, shape) come before any
launch; the case codes it returns agree with the levels it picks; a (P, U)
population is the rows' solves side by side; ``sim.policy.solve_kkt`` goes
through it; the kernel's constants are the order ``csrc/qccf_kkt.cu``
declares; and the library builds with the wire kernels' in one ``build``.

The kernel itself is held to the twin on the card by
``tests/test_torch_cuda_kkt.py``. The twin against JAX's ``solve_kkt``
through ``sim.policy.solve_kkt``: ``tests/test_torch_sim_policy.py``.
"""
import re
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

import kkt_inputs as ki
from repro_torch.kernels import build, kkt
from repro_torch.sim import policy
from torch_replay import one_torch_thread  # noqa: F401 (autouse fixture)

CSRC = Path(kkt.__file__).resolve().parent / "csrc" / "qccf_kkt.cu"


def _args(arrays, lam=20.0):
    return (*ki.tensors(arrays, "cpu"), ki.lam_tensor(lam, "cpu"), ki.SYSP, ki.Z, ki.V_WEIGHT)


def _no_library(*_a, **_k):
    raise AssertionError("the CPU path built or loaded a kernel library")


def test_cpu_runs_the_plain_twin_and_loads_no_library():
    args = _args(ki.fleet(64, 8, 0))
    kkt.reset_launches()
    with mock.patch.object(build, "build", _no_library), \
            mock.patch.object(build, "library", _no_library), \
            mock.patch.object(kkt, "solve_kkt_plain", wraps=kkt.solve_kkt_plain) as plain:
        got = kkt.solve_kkt(*args, q_cap=ki.Q_CAP)
    assert plain.call_count == 1 and kkt.launches["kkt"] == 0
    want = kkt.solve_kkt_plain(*args, q_cap=ki.Q_CAP)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert [t.dtype for t in got] == [torch.int64, torch.float32, torch.bool, torch.float32,
                                      torch.int8]


def test_policy_solve_kkt_goes_through_the_wrapper():
    args = _args(ki.fleet(64, 8, 1))
    with mock.patch.object(kkt, "solve_kkt", wraps=kkt.solve_kkt) as wrapper:
        got = policy.solve_kkt(*args, q_cap=ki.Q_CAP)
    assert wrapper.call_count == 1 and len(got) == 4
    for g, w in zip(got, kkt.solve_kkt_plain(*args, q_cap=ki.Q_CAP)):
        assert torch.equal(g, w)


def test_raises_on_mixed_devices():
    v, w, d, theta, lam, *rest = _args(ki.fleet(16, 4, 2))
    with pytest.raises(ValueError, match="several devices"):
        kkt.solve_kkt(v, w, d.to("meta"), theta, lam, *rest)


def test_raises_under_grad_and_runs_under_no_grad():
    v, *rest = _args(ki.fleet(16, 4, 3))
    v.requires_grad_()
    with pytest.raises(ValueError, match="no backward"):
        kkt.solve_kkt(v, *rest)
    with torch.no_grad():
        assert kkt.solve_kkt(v, *rest)[0].shape == (16,)


@pytest.mark.parametrize("bad,err,match", [
    ("float64", TypeError, "torch.float32"),
    ("strided", ValueError, "contiguous"),
    ("lam two elements", ValueError, "one element"),
    ("lam of more dims than the clients", ValueError, "one element"),
    ("d (1, U) beside (P, U)", ValueError, "trailing dims"),
    ("theta longer", ValueError, "trailing dims"),
    ("a grid of one point", ValueError, "grid_n"),
])
def test_refuses_what_the_kernel_does_not_take(bad, err, match):
    v, w, d, theta = ki.tensors(ki.population(2, 16, 4, 4), "cpu")
    lam = ki.lam_tensor(1.0, "cpu")
    if bad == "float64":
        w = w.double()
    elif bad == "strided":
        v = torch.stack([v, v], dim=-1)[..., 0]
    elif bad == "lam two elements":
        lam = torch.ones(2)
    elif bad == "lam of more dims than the clients":
        lam = torch.ones(1, 1, 1)
    elif bad == "d (1, U) beside (P, U)":
        d = d[None]
    elif bad == "theta longer":
        theta = torch.ones(17)
    grid_n = 1 if bad == "a grid of one point" else 512
    with mock.patch.object(kkt, "solve_kkt_plain", _no_library):
        with pytest.raises(err, match=match):
            kkt.solve_kkt(v, w, d, theta, lam, ki.SYSP, ki.Z, ki.V_WEIGHT, grid_n=grid_n)


@pytest.mark.parametrize("lam", [0.0, 1e-3, 1.0, 50.0, 1e4])
def test_case_codes_agree_with_the_levels(lam):
    """Every code is one of 1..6; Case 1 picks q_hat = 1; q_hat lies in
    [1, q_cap] with the integer level its floor or ceil; an unassigned
    client (v = 0) is infeasible and takes the grid (no case holds)."""
    arrays = ki.pool(3000, seed=11)
    q, f, feasible, q_hat, case = kkt.solve_kkt(*_args(arrays, lam), q_cap=ki.Q_CAP)
    assert set(case.unique().tolist()) <= set(kkt.CASES)
    assert bool((q_hat[case == 1] == 1.0).all())
    assert bool(((q_hat >= 1.0) & (q_hat <= ki.Q_CAP)).all())
    assert bool(((q == torch.floor(q_hat)) | (q == torch.ceil(q_hat))).all())
    unassigned = torch.from_numpy(arrays[0] == 0.0)
    assert not bool(feasible[unassigned].any())
    assert bool((case[unassigned] == kkt.GRID).all())


def test_pool_reaches_every_case_and_both_cubic_branches():
    """The card test's pool (``kkt_inputs.pool``) reaches each case code,
    both branches of Case 2's cubic, the grid over a feasible span and
    infeasible clients, so each of its case-by-case comparisons compares
    something."""
    arrays = ki.pool(20000, seed=7)
    reached = {label: 0 for label in ("cardano", "trig", "grid span", "infeasible")}
    codes = torch.zeros(7, dtype=torch.int64)
    for lam in (1e-3, 1.0, 50.0, 1e4):
        _q, _f, feasible, _qh, case = kkt.solve_kkt(*_args(arrays, lam), q_cap=ki.Q_CAP)
        codes += torch.bincount(case.long(), minlength=7)
        c = case.numpy()
        a4 = ki.a4_of(arrays[0], arrays[1], arrays[3], lam)
        reached["cardano"] += int(((c == 2) & (a4 < ki.A4_TRIG * 0.999)).sum())
        reached["trig"] += int(((c == 2) & (a4 > ki.A4_TRIG * 1.001)).sum())
        reached["grid span"] += int(((c == 6) & (ki.qmax_of(arrays[0], arrays[2]) > 1.01)).sum())
        reached["infeasible"] += int((~feasible).sum())
    assert all(int(n) >= 50 for n in codes[1:]), codes.tolist()
    assert all(n >= 50 for n in reached.values()), reached


@pytest.mark.parametrize("lam", [0.0, 50.0])
def test_population_is_its_rows_side_by_side(lam):
    """(P, U) v and w beside (U,) d and theta, as the GA's fitness passes
    them: each row equals a (U,) solve of that row."""
    arrays = ki.population(4, 96, 12, seed=6)
    got = kkt.solve_kkt(*_args(arrays, lam), q_cap=ki.Q_CAP)
    assert got[0].shape == (4, 96)
    for p in range(4):
        row = kkt.solve_kkt(*_args((arrays[0][p], arrays[1][p], arrays[2], arrays[3]), lam),
                            q_cap=ki.Q_CAP)
        for g, w in zip(got, row):
            assert torch.equal(g[p], w)


def test_empty_clients():
    out = kkt.solve_kkt(*_args((np.zeros(0),) * 4), q_cap=ki.Q_CAP)
    assert all(t.shape == (0,) for t in out)


def test_constants_follow_the_kernels_struct():
    """``kkt.CONSTANTS`` names ``KktConsts``' fields in their order, and
    ``kernel_constants`` gives one read-only fp32 value for each."""
    src = CSRC.read_text()
    body = re.search(r"struct KktConsts \{\s*float ([^;]*);", src).group(1)
    fields = [f.strip() for f in body.split(",")]
    assert tuple(fields) == kkt.CONSTANTS
    consts = kkt.kernel_constants(ki.SYSP, ki.Z, ki.V_WEIGHT, ki.Q_CAP, 512)
    assert consts.dtype == np.float32 and consts.shape == (len(kkt.CONSTANTS),)
    assert not consts.flags.writeable
    named = dict(zip(kkt.CONSTANTS, consts.tolist()))
    assert named["bits_q1"] == 2 * ki.Z + 32 and named["q_cap"] == ki.Q_CAP
    assert named["rcp_f_max"] == float(np.float32(1.0) / np.float32(ki.SYSP.f_max))


def test_entry_point_argtypes_match_the_c_signature():
    src = CSRC.read_text()
    params = re.search(r"int qccf_kkt\(([^)]*)\)", src).group(1).split(",")
    argtypes = build.LIBRARIES["qccf_kkt"][1]["qccf_kkt"]
    assert len(argtypes) == len(params)
    width = {"const void*": build._PTR, "void*": build._PTR, "int64_t": build._I64,
             "int": build._INT}
    for p, t in zip(params, argtypes):
        kind = " ".join(p.split()[:-1]).replace(" *", "*")
        assert width[kind] is t, (p, t)


def test_first_use_builds_with_the_wire_kernels():
    """Either library's first use starts one ``build`` of both, so their
    two nvcc runs overlap."""
    class Built(Exception):
        pass

    def record(*names):
        raise Built(names)

    for name in ("qccf_kkt", "stochastic_quant"):
        with mock.patch.object(build, "build", record), pytest.raises(Built) as got:
            build.library.__wrapped__(name)
        assert set(got.value.args[0]) == {"stochastic_quant", "qccf_kkt"}
    with mock.patch.object(build, "build", record), pytest.raises(Built) as got:
        build.library.__wrapped__("flash_attention")
    assert got.value.args[0] == ("flash_attention",)
