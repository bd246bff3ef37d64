"""The decision's KKT kernel (``qccf_kkt_kernel``, ``csrc/qccf_kkt.cu``)
against its plain twin ``kkt.solve_kkt_plain`` on the card.

The kernel repeats the twin's fp32 operations as torch's CUDA kernels
round them, so every output is held equal bit for bit: the integer level
``q``, ``feasible`` and the case code exactly, ``f`` and ``q_hat`` as fp32
bit patterns (largest ulp gap allowed: 0). Inputs (``kkt_inputs``): a wide
pool that reaches every case (1, both branches of Case 2's cubic, 4, 3, 5,
the grid over a feasible span, infeasible clients) at lam from 1e-3 to
1e4 and at lam = 0; rounds of the benchmark cell's fleet (U = 1,024, 128
on a channel, the cell's ``SystemParams``); a GA population of 32 of them,
(P, U) = (32, 1,024). One launch a call.

Needs a CUDA device and nvcc (the library is built at first use); every
test here skips without a card. Run on the GPU machine with
``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_kkt.py``.
No JAX: the card's machine does not have it.
"""
import numpy as np
import pytest
import torch

import kkt_inputs as ki
from repro_torch.kernels import kkt
from repro_torch.sim import policy

POOL = 20000
LAMS = (1e-3, 1.0, 50.0, 1e4)
ULP_GAP = 0           # largest gap allowed between f (and q_hat) and the twin's
MIN_PER_CASE = 50     # the pool's clients each case must reach over LAMS


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the KKT kernel has no CPU or interpret mode")
    return torch.device("cuda")


def _run(dev, arrays, lam: float):
    """(kernel outputs, twin outputs) on the card; one launch checked."""
    v, w, d, theta = ki.tensors(arrays, dev)
    lam_t = ki.lam_tensor(lam, dev)
    args = (v, w, d, theta, lam_t, ki.SYSP, ki.Z, ki.V_WEIGHT)
    kkt.reset_launches()
    got = kkt.solve_kkt(*args, q_cap=ki.Q_CAP)
    assert kkt.launches["kkt"] == 1
    want = kkt.solve_kkt_plain(*args, q_cap=ki.Q_CAP)
    assert kkt.launches["kkt"] == 1          # the twin launches no kernel of ours
    torch.cuda.synchronize()
    return got, want


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in fp32 ulps (bit patterns of same-sign values)."""
    if a.numel() == 0:
        return 0
    ia, ib = a.view(torch.int32).long(), b.view(torch.int32).long()
    return int((ia - ib).abs().max().item())


def _assert_same(got, want, label: str, mask=None) -> None:
    names = ("q", "f", "feasible", "q_hat", "case")
    for name, g, w in zip(names, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (label, name, g.dtype, w.dtype)
        if mask is not None:
            g, w = g[mask], w[mask]
        if name in ("f", "q_hat"):
            gap = _ulps(g, w)
            bad = int((g.view(torch.int32) != w.view(torch.int32)).sum().item())
            assert gap <= ULP_GAP, f"{label}: {name} differs in {bad} clients, up to {gap} ulps"
        else:
            bad = (g != w).nonzero()
            assert bad.numel() == 0, f"{label}: {name} differs at {bad[:8].tolist()}"


@pytest.fixture(scope="module")
def pool_runs(cuda):
    arrays = ki.pool(POOL, seed=7)
    return arrays, {lam: _run(cuda, arrays, lam) for lam in LAMS}


CODES = {"q = 1": 1, "cubic cardano": 2, "cubic trig": 2, "f = f_min": 4, "f = f_max": 3,
         "bisection": 5, "grid": 6, "grid over a span": 6}


def _selected(arrays, lam, want, label):
    """The clients of ``label`` by the twin's outputs (numpy bool)."""
    if label == "infeasible":
        return ~want[2].cpu().numpy()
    sel = want[4].cpu().numpy() == CODES[label]
    v, w, d, theta = arrays
    if label == "cubic trig":
        sel &= ki.a4_of(v, w, theta, lam) > ki.A4_TRIG * 1.001
    elif label == "cubic cardano":
        sel &= ki.a4_of(v, w, theta, lam) < ki.A4_TRIG * 0.999
    elif label == "grid over a span":
        sel &= ki.qmax_of(v, d) > 1.01
    return sel


@pytest.mark.parametrize("label", [*CODES, "infeasible"])
def test_each_case_bit_equal_to_plain(pool_runs, label):
    """The pool's clients of one case (the twin's case code; Case 2 split by
    the cubic's branch, the grid by whether its span is empty), at every
    lam: every output equal to the twin's."""
    arrays, runs = pool_runs
    reached = 0
    for lam, (got, want) in runs.items():
        sel = torch.from_numpy(_selected(arrays, lam, want, label)).to(got[0].device)
        reached += int(sel.sum().item())
        _assert_same(got, want, f"{label}, lam {lam}", sel)
    assert reached >= MIN_PER_CASE, f"the pool reaches {label!r} in {reached} clients only"


def test_whole_pool_bit_equal_to_plain(pool_runs):
    _arrays, runs = pool_runs
    for lam, (got, want) in runs.items():
        _assert_same(got, want, f"pool, lam {lam}")


@pytest.mark.parametrize("seed", [0, 1])
def test_lam_zero_bit_equal_to_plain(cuda, seed):
    """lam = 0 (an empty lambda2 queue): no quantization pressure, no
    bisection bracket."""
    got, want = _run(cuda, ki.pool(4096, seed), 0.0)
    _assert_same(got, want, f"lam 0, seed {seed}")
    assert not bool((got[4] == 5).any())


@pytest.mark.parametrize("lam", [0.0, 1e-3, 5.0, 50.0, 500.0])
@pytest.mark.parametrize("seed", [3, 4])
def test_cell_fleet_bit_equal_to_plain(cuda, seed, lam):
    """A round of the cell: U = 1,024, 128 clients on a channel, the rest
    unassigned (infeasible, the grid over an empty span). Prints the case
    codes' counts."""
    arrays = ki.fleet(1024, 128, seed)
    got, want = _run(cuda, arrays, lam)
    _assert_same(got, want, f"fleet seed {seed}, lam {lam}")
    counts = torch.bincount(got[4].long(), minlength=7)[1:].tolist()
    print(f"cell fleet seed {seed} lam {lam}: case codes 1..6 {counts}, "
          f"feasible {int(got[2].sum())}")
    assert int(got[2].sum()) <= 128


@pytest.mark.parametrize("lam", [0.0, 50.0])
def test_population_bit_equal_to_plain(cuda, lam):
    """The GA's (P, U) = (32, 1,024): v and w per chromosome, d and theta
    (U,) beside them, one launch."""
    arrays = ki.population(32, 1024, 128, seed=5)
    got, want = _run(cuda, arrays, lam)
    assert got[0].shape == (32, 1024)
    _assert_same(got, want, f"population, lam {lam}")


def test_policy_solve_kkt_launches_the_kernel(cuda):
    """``sim.policy.solve_kkt`` (the ``kkt_solve`` range's call) takes the
    kernel on the card and returns the twin's first four outputs."""
    v, w, d, theta = ki.tensors(ki.fleet(1024, 128, 9), cuda)
    lam = ki.lam_tensor(20.0, cuda)
    kkt.reset_launches()
    got = policy.solve_kkt(v, w, d, theta, lam, ki.SYSP, ki.Z, ki.V_WEIGHT, q_cap=ki.Q_CAP)
    assert kkt.launches["kkt"] == 1 and len(got) == 4
    want = kkt.solve_kkt_plain(v, w, d, theta, lam, ki.SYSP, ki.Z, ki.V_WEIGHT, q_cap=ki.Q_CAP)
    _assert_same(got, want[:4], "policy.solve_kkt")


def test_refusals_on_card(cuda):
    v, w, d, theta = ki.tensors(ki.fleet(64, 8, 2), cuda)
    lam = ki.lam_tensor(1.0, cuda)
    with pytest.raises(ValueError, match="several devices"):
        kkt.solve_kkt(v, w, d.cpu(), theta, lam, ki.SYSP, ki.Z, ki.V_WEIGHT)
    with pytest.raises(ValueError, match="no backward"):
        kkt.solve_kkt(v.requires_grad_(), w, d, theta, lam, ki.SYSP, ki.Z, ki.V_WEIGHT)
