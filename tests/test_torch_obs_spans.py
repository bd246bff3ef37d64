"""The fleet round's layer ranges (``repro_torch.sim.engine``'s docstring)
in a CPU ``torch.profiler`` capture of a tiny greedy sim's
``run_compiled(2)``:

  * each layer has its records a round (``kkt_solve`` exactly one), and
    ``results_to_host`` one a call;
  * the layer ranges are siblings in a round's fixed order, none inside
    another (the kernel's ``cuda_aggregate`` may sit inside
    ``wire_aggregate``; on the CPU the plain aggregate has no range);
  * the outputs are bit-equal to an uncaptured run's.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.sim import engine as teng
from torch_replay import one_torch_thread  # noqa: F401 (autouse fixture)

ROUNDS = 2
FIELDS = ("energy", "accuracy", "loss", "n_scheduled", "q_levels", "latency",
          "payload_bits", "rates", "lambda1", "lambda2")
# one greedy round's layer ranges, in the order the host enters them
ROUND = ("draw_inputs", "round_state", "greedy_assign", "decision_terms", "decision_terms",
         "kkt_solve", "decision_terms", "round_state", "gather_active", "draw_inputs",
         "fleet_local_sgd", "draw_inputs", "quantize_wire", "wire_aggregate", "eval_model",
         "round_state")
LAYERS = sorted(set(ROUND) | {"results_to_host"})


def _sim():
    return teng.build_sim("tiny", n_clients=8, n_channels=4, seed=3, n_test=64,
                          device="cpu")


@pytest.fixture(scope="module")
def runs():
    """(uncaptured result, captured result, the capture's layer records
    as (name, start, end) in time order)."""
    sim = _sim()
    plain = sim.run_compiled(ROUNDS)
    plain_flat = sim.final_flat.clone()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = sim.run_compiled(ROUNDS)
    records = sorted(((e.name, e.time_range.start, e.time_range.end)
                      for e in prof.events() if e.name in LAYERS),
                     key=lambda r: (r[1], -r[2]))
    return (plain, plain_flat), (traced, sim.final_flat.clone()), records


@pytest.mark.parametrize("name", LAYERS)
def test_each_layer_has_its_records_a_round(runs, name):
    *_, records = runs
    n = sum(1 for r in records if r[0] == name)
    want = 1 if name == "results_to_host" else ROUND.count(name) * ROUNDS
    assert n == want, (name, n, want)


def test_layers_are_siblings_in_a_rounds_order(runs):
    *_, records = runs
    assert [r[0] for r in records] == list(ROUND) * ROUNDS + ["results_to_host"]
    for (n0, _, end), (n1, start, _) in zip(records, records[1:]):
        assert start >= end, f"{n1} starts inside {n0}"


def test_outputs_bit_equal_under_capture(runs):
    (plain, plain_flat), (traced, traced_flat), _ = runs
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(plain, f), getattr(traced, f), err_msg=f)
    assert torch.equal(plain_flat, traced_flat)


def test_segments_copy_to_the_host_once_each():
    sim = _sim()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sim.run_compiled(3, segment=2)
    names = [e.name for e in prof.events()]
    assert names.count("results_to_host") == 2
    assert names.count("kkt_solve") == 3
