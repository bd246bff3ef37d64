"""The readers of the program's layer ranges (``bench/spans.py`` and
``bench/metrics/``) on a hand-built trace whose answers are known: the
decision's launches and idle time, local SGD's launches, the wire's device
time, the host's time in ``greedy_assign`` and ``results_to_host``, the
launch split by layer; ``bench/trace_audit.py``'s shared-clock check,
launch lags and host launch split. Then the tiny traced run on the CPU:
the host readers report, the device readers are left out."""
import importlib
import time
from types import SimpleNamespace

import pytest
import torch

from bench import spans, trace_audit
from bench.test_bench_run import SEED, tiny_spec  # noqa: F401 (fixture)
from bench.trace import WINDOW, TraceView

ROUNDS = 2
HOST = [  # (name, start, end) of the program's ranges on the host, us
    ("greedy_assign", 100, 200), ("kkt_solve", 200, 300), ("decision_terms", 300, 320),
    ("fleet_local_sgd", 320, 400), ("quantize_wire", 400, 420), ("wire_aggregate", 420, 440),
    ("cuda_aggregate", 424, 430), ("aten::add", 500, 501),
    ("greedy_assign", 600, 700), ("kkt_solve", 700, 800), ("decision_terms", 800, 820),
    ("fleet_local_sgd", 820, 900), ("results_to_host", 950, 990),
]
DEVICE = [  # (start, end) of the device's operations, us
    (110, 120), (130, 140), (310, 315), (322, 326), (327, 329), (330, 390), (392, 398),
    (405, 410), (421, 423), (425, 428), (500, 505),
    (610, 620), (710, 720), (830, 880), (950, 952),
]
ANNOTATIONS = [  # the ranges' spans on the device's timeline
    ("greedy_assign", 110, 140), ("kkt_solve", 310, 329), ("fleet_local_sgd", 330, 398),
    ("quantize_wire", 405, 410), ("wire_aggregate", 421, 423), ("cuda_aggregate", 425, 428),
    ("greedy_assign", 610, 620), ("kkt_solve", 710, 720), ("fleet_local_sgd", 830, 880),
    ("results_to_host", 950, 952),
]


def _event(name, a, b, device=False, annotation=False, thread=1):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=a, end=b),
                           device_type="DeviceType.CUDA" if device else "DeviceType.CPU",
                           is_user_annotation=annotation, is_async=False, thread=thread)


def _events(annotations=ANNOTATIONS, host=HOST, device=DEVICE):
    """The events above. As on the card (torch 2.11), the ranges' spans on
    the device's timeline carry the host thread's id, so each also reaches
    ``TraceView.host`` as a second record of its range."""
    events = [_event(WINDOW, 0, 1000, annotation=True)]
    events += [_event(n, a, b, annotation=not n.startswith("aten::")) for n, a, b in host]
    events += [_event(f"kernel_{i}", a, b, device=True) for i, (a, b) in enumerate(device)]
    events += [_event(n, a, b, device=True, annotation=True) for n, a, b in annotations]
    return events


def _view(**kw):
    return TraceView(_events(**kw), ROUNDS)


def _read(name, view):
    return importlib.import_module(f"bench.metrics.{name}").read({"view": view})


@pytest.mark.parametrize("name, want", [
    # 2 + 1 operations in greedy's spans, 3 + 1 in the KKT's, none in decision_terms'
    ("decision_launches_per_round", (3 + 4) / ROUNDS),
    ("local_sgd_launches_per_round", (2 + 1) / ROUNDS),
    # 5 us of quantize_wire's operation, 2 + 3 of wire_aggregate's: the
    # kernel's span is its inner cuda_aggregate range's
    ("wire_device_ms", (5 + 2 + 3) / 1e3 / ROUNDS),
    # [100, 320] less 25 us busy, [600, 820] less 20 us busy; the device
    # copy of kkt_solve, [310, 329], is no host time
    ("decision_idle_ms", (195 + 200) / 1e3 / ROUNDS),
    ("greedy_host_ms", (100 + 100) / 1e3 / ROUNDS),
    ("call_end_wait_ms", 40 / 1e3 / ROUNDS),
])
def test_reader_on_a_hand_built_trace(name, want):
    assert _read(name, _view()) == pytest.approx(want, abs=1e-12)


def test_host_records_leave_out_the_device_copy():
    view = _view()
    assert ("kkt_solve", 310, 329) in view.host
    assert spans.host_records(view, ("kkt_solve",)) == [(200, 300), (700, 800)]
    assert spans.host_ms_per_round(view, ("kkt_solve",)) == pytest.approx(0.1)


def test_launch_split_sums_to_the_calls_operations():
    view = _view()
    split = spans.launch_split(view)
    assert set(split) == set(spans.LAYERS) | {spans.OUTSIDE}
    assert split["greedy_assign"] == 3 / ROUNDS and split["kkt_solve"] == 4 / ROUNDS
    assert split["wire_aggregate"] == 2 / ROUNDS
    assert split["results_to_host"] == 1 / ROUNDS and split[spans.OUTSIDE] == 1 / ROUNDS
    assert sum(split.values()) == len(DEVICE) / ROUNDS


def _with_ids(name, a, b, id_, device=False, annotation=True):
    e = _event(name, a, b, device=device, annotation=annotation)
    e.id = id_
    return e


def test_clock_violations_pair_a_span_with_its_host_record_by_id():
    events = [_with_ids("kkt_solve", 100, 200, 1), _with_ids("kkt_solve", 110, 190, 1, True),
              _with_ids("kkt_solve", 300, 400, 2), _with_ids("kkt_solve", 290, 380, 2, True),
              # a second stream's span of record 2, and a range outside the names
              _with_ids("kkt_solve", 305, 350, 2, True), _with_ids("other", 0, 9, 3, True)]
    assert trace_audit.clock_violations(events, ("kkt_solve",)) == (1, 3)


def test_launch_lags_pair_an_operation_with_its_launch_call():
    events = [_with_ids("cudaLaunchKernel", 50, 52, 10, annotation=False),
              _with_ids("kernel", 55, 60, 10, device=True, annotation=False),
              _with_ids("cudaMemcpyAsync", 60, 61, 11, annotation=False),
              _with_ids("copy", 58, 59, 11, device=True, annotation=False),
              _with_ids("kernel", 70, 71, 12, device=True, annotation=False)]
    assert trace_audit.launch_lags(events) == [(50, 5), (60, -2)]


def test_host_launch_split_counts_launch_calls_in_host_records():
    # in greedy_assign twice, kkt_solve once, cuda_aggregate (inside
    # wire_aggregate) once, an unnamed operation once
    calls = [_event("cudaLaunchKernel", t, t + 0.5) for t in (105, 115, 210, 425, 500.2)]
    events = _events() + calls
    split = trace_audit.host_launch_split(TraceView(events, ROUNDS), events)
    assert split["greedy_assign"] == 2 / ROUNDS and split["kkt_solve"] == 1 / ROUNDS
    assert split["wire_aggregate"] == 1 / ROUNDS and split[spans.OUTSIDE] == 1 / ROUNDS
    assert sum(split.values()) == len(calls) / ROUNDS


def test_audit_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert trace_audit.main(["--seed", str(SEED)]) == 2
    assert "CUDA" in capsys.readouterr().err


def test_readers_find_nothing_without_the_ranges():
    """A program without the layer ranges (or a trace without device
    activity) leaves every new metric out."""
    bare = _view(annotations=[], host=[("aten::add", 500, 501)])
    for name in ("decision_launches_per_round", "local_sgd_launches_per_round",
                 "wire_device_ms", "decision_idle_ms", "greedy_host_ms",
                 "call_end_wait_ms"):
        assert _read(name, bare) is None, name
    host_only = _view(device=[], annotations=[])
    for name in ("decision_launches_per_round", "local_sgd_launches_per_round",
                 "wire_device_ms", "decision_idle_ms"):
        assert _read(name, host_only) is None, name


def test_tiny_traced_run_reports_the_host_readers(tiny_spec):  # noqa: F811
    from bench import harness

    out = harness.run_cell("tiny", SEED, 0.1, True, time.perf_counter(),
                           device=torch.device("cpu"), spec=tiny_spec)
    metrics = out["metrics"]
    assert metrics["greedy_host_ms"]["value"] > 0
    assert metrics["call_end_wait_ms"]["value"] > 0
    for name in ("decision_launches_per_round", "local_sgd_launches_per_round",
                 "wire_device_ms", "decision_idle_ms"):
        assert name not in metrics, name
