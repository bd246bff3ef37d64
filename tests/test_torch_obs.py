"""The telemetry layer in the port (``repro_torch.obs``: the metric taps, the
run ledger, the report, the profiler hooks; the engine's taps and ledger
calls; the GA's fitness taps) against ``repro.obs`` and ``repro.sim``.

  * ``decision_metrics`` on seeded numpy inputs (U = 8), including a round
    with one scheduled client (corr NaN) and one with nobody: exact-input
    fields (q_mean, q_max, n_timeout, corr_q_d) equal to the JAX function,
    the others within rtol 1e-5 / atol 1e-10;
  * ``run_compiled`` taps against the JAX engine's on its own draws
    (``torch_replay.ReplayEntropy``, U = 8, ``n_test=64``, 3 rounds): greedy,
    compiled-ga at P = 8, G = 4 (an even P, where ``torch.median`` would
    take the lower middle value), ``single_bs_faulty`` and
    ``downlink="delta"``; exact-input fields and the fault counters equal,
    analog fields at the tolerance of ``tests/test_obs.py`` (rtol 1e-5,
    atol 1e-10, NaN where JAX has NaN);
  * telemetry off (``None`` or ``enabled=False``) bit-equal to a sim built
    without it, and telemetry on leaving every existing output bit-equal;
  * ``last_host_metrics`` against the port's compiled taps and against the
    JAX package's ``last_host_metrics``;
  * the ledger cases of ``tests/test_obs.py`` on the port's ledger, a run's
    ledger with segments and resume events, and ledgers written by either
    package read and summarized by the other.
"""
import dataclasses
import functools
import json
import math

import jax
import numpy as np
import pytest
import torch

from repro.core.genetic import GAConfig as JGAConfig
from repro.core.genetic import SystemParams as JSystemParams
from repro.models import cnn as jcnn
from repro.obs import MetricsConfig as JMetricsConfig
from repro.obs import Ledger as JLedger
from repro.obs import metrics as jmetrics
from repro.obs import read_ledger as jread_ledger
from repro.obs import report as jreport
from repro.sim import engine as jeng
from repro_torch.core.genetic import GAConfig, SystemParams
from repro_torch.models import cnn as tcnn
from repro_torch.obs import (
    METRIC_FIELDS, METRICS_OFF, Ledger, MetricsConfig, default_ledger, pytree_hash,
    read_ledger, timed_phase, validate_event,
)
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import profile as tprofile
from repro_torch.obs import report as treport
from repro_torch.obs.ledger import REPRO_LEDGER_ENV, _sanitize
from repro_torch.sim import engine as teng
from torch_replay import ReplayEntropy, one_torch_thread  # noqa: F401 (autouse fixture)

U, C, ROUNDS, SEED = 8, 4, 3, 0
ON = MetricsConfig(enabled=True)
JON = JMetricsConfig(enabled=True)
GA_KW = dict(generations=4, population=8, elitism=2, repair_infeasible=True)
# field -> parity class, as tests/test_obs.py: exact-input fields are bit-equal,
# analog fields pass through the KKT's fp32 arithmetic (or the SGD's, for the
# wire taps) done in another order
EXACT_FIELDS = ("q_mean", "q_max", "n_timeout", "corr_q_d")
FAULT_FIELDS = ("n_dropped", "n_screened", "n_timeout_real")
ANALOG = dict(rtol=1e-5, atol=1e-10, equal_nan=True)


def _jax_params():
    return jax.tree_util.tree_map(
        np.asarray, jcnn.init_params(jcnn.TINY_CNN, jax.random.PRNGKey(SEED)))


def _check_taps(got: dict, want: dict, fields=METRIC_FIELDS, exact=EXACT_FIELDS):
    for f in fields:
        g = np.asarray(got[f], np.float32)
        w = np.asarray(want[f], np.float32)
        if f in exact or f in FAULT_FIELDS:
            np.testing.assert_array_equal(g, w, err_msg=f"exact-input field {f}")
        else:
            np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64),
                                       err_msg=f"analog field {f}", **ANALOG)


# ------------------------------------------------------------- decision taps

def _decision(seed: int, n_sched: int):
    rng = np.random.default_rng(seed)
    a = np.zeros(U, np.int32)
    a[rng.permutation(U)[:n_sched]] = 1
    q = np.where(a > 0, rng.integers(1, 9, U), 0).astype(np.int32)
    q_cont = np.where(a > 0, q + rng.uniform(-0.5, 0.5, U), 0.0).astype(np.float32)
    f = np.where(a > 0, rng.uniform(2e8, 1e9, U), 0.0).astype(np.float32)
    # a spender that was not scheduled is a timeout
    spent = (a > 0) | (rng.random(U) < 0.3)
    energy = np.where(spent, rng.uniform(1e-5, 1e-3, U), 0.0).astype(np.float32)
    d = rng.integers(50, 400, U).astype(np.float32)
    return a, q, q_cont, f, energy, d, np.float32(rng.uniform(0, 2)), np.float32(rng.uniform(0, 2))


@pytest.mark.parametrize("seed,n_sched", [(0, 8), (1, 5), (2, 3), (3, 2), (4, 1), (5, 0)],
                         ids=["all", "five", "three", "two", "one", "nobody"])
def test_decision_metrics_match_reference(seed, n_sched):
    a, q, q_cont, f, energy, d, dt, qt = _decision(seed, n_sched)
    j = jmetrics.metrics_to_dict(jmetrics.decision_metrics(
        *(jax.numpy.asarray(x) for x in (a, q, q_cont, f, energy, d)),
        jax.numpy.float32(dt), jax.numpy.float32(qt), JSystemParams()))
    t = tmetrics.metrics_to_dict(tmetrics.decision_metrics(
        *(torch.from_numpy(x) for x in (a, q, q_cont, f, energy, d)),
        torch.tensor(dt), torch.tensor(qt), SystemParams()))
    assert set(t) == set(METRIC_FIELDS) == set(jmetrics.METRIC_FIELDS)
    assert list(METRIC_FIELDS) == list(jmetrics.METRIC_FIELDS)
    assert all(v.dtype == np.float32 and v.shape == () for v in t.values())
    _check_taps(t, j)
    sched = a > 0
    degenerate = n_sched < 2 or np.ptp(q[sched]) == 0 or np.ptp(d[sched]) == 0
    assert np.isnan(t["corr_q_d"]) == degenerate
    if n_sched == 0:
        assert t["q_mean"] == 0.0 and t["q_max"] == 0.0
    for k in ("quant_mse", "ga_best", "ga_median", "dl_payload_bits", "dl_mse", *FAULT_FIELDS):
        assert np.isnan(t[k])
    # the host replay's form: the same function on fp32 tensors from host
    # arrays, the optional taps filled in
    h = tmetrics.decision_metrics_host(a, q, q_cont, f, energy, d, float(dt), float(qt),
                                       SystemParams(), quant_mse=0.5, n_dropped=2.0)
    jh = jmetrics.decision_metrics_host(a, q, q_cont, f, energy, d, float(dt), float(qt),
                                        JSystemParams(), quant_mse=0.5, n_dropped=2.0)
    for k in set(METRIC_FIELDS) - {"quant_mse", "n_dropped"}:
        np.testing.assert_array_equal(np.float32(h[k]), t[k], err_msg=k)
    _check_taps(h, jh)
    assert h["quant_mse"] == 0.5 and h["n_dropped"] == 2.0


def test_metrics_config_gate():
    assert not METRICS_OFF.enabled and METRICS_OFF == MetricsConfig()
    assert ON.quant_mse and ON.ga_fitness
    with pytest.raises(dataclasses.FrozenInstanceError):
        ON.enabled = False
    assert hash(MetricsConfig(enabled=True)) == hash(ON)


# ---------------------------------------------------------- runs vs JAX

CASES = {
    "greedy": ({}, {}),
    "compiled-ga": ({"policy_mode": "compiled-ga", "ga_config": JGAConfig(**GA_KW)},
                    {"policy_mode": "compiled-ga", "ga_config": GAConfig(**GA_KW)}),
    "single_bs_faulty": ({"scenario": "single_bs_faulty"}, {"scenario": "single_bs_faulty"}),
    "delta": ({"downlink": "delta"}, {"downlink": "delta"}),
}


@functools.lru_cache(maxsize=None)
def _runs(case):
    """(JAX sim, its result, port sim, its result), both with telemetry on,
    the port on the JAX package's draws and initial weights."""
    jkw, tkw = CASES[case]
    kw = dict(n_clients=U, n_channels=C, seed=SEED, n_test=64)
    jsim = jeng.build_sim("tiny", telemetry=JON, **kw, **jkw)
    jres = jsim.run_compiled(ROUNDS)
    tsim = teng.build_sim("tiny", device="cpu", telemetry=ON,
                          init_params=tcnn.params_from_numpy(_jax_params(), "cpu"),
                          entropy=ReplayEntropy(jsim, ROUNDS), **kw, **tkw)
    return jsim, jres, tsim, tsim.run_compiled(ROUNDS)


@pytest.mark.parametrize("case", list(CASES))
def test_run_taps_match_reference(case):
    jsim, jres, tsim, tres = _runs(case)
    assert set(tres.metrics) == set(METRIC_FIELDS)
    assert all(v.shape == (ROUNDS,) and v.dtype == np.float32 for v in tres.metrics.values())
    np.testing.assert_array_equal(tres.q_levels, jres.q_levels)
    _check_taps(tres.metrics, jres.metrics)
    m = tres.metrics
    np.testing.assert_allclose(m["energy_comp"] + m["energy_comm"], tres.energy, rtol=1e-5)
    # the wire error is defined in every round that delivered a payload
    delivered = tres.n_scheduled > 0
    if case == "single_bs_faulty":
        delivered &= m["n_screened"] < tres.n_scheduled
    assert np.isfinite(m["quant_mse"][delivered]).all() and (m["quant_mse"][delivered] >= 0).all()
    assert np.isnan(m["quant_mse"][~delivered]).all()
    ga = case == "compiled-ga"
    assert np.isfinite(m["ga_best"]).all() == ga and np.isnan(m["ga_median"]).all() != ga
    if ga:
        assert (m["ga_best"] <= m["ga_median"]).all()
    assert np.isfinite(m["dl_mse"]).all() == (case == "delta")
    assert np.isfinite(m["n_screened"]).all() == (case == "single_bs_faulty")


# ------------------------------------------------------- gating (port only)

def _port(telemetry=None, ledger=None, **kw):
    return teng.build_sim("tiny", n_clients=U, n_channels=C, seed=SEED, n_test=64,
                          device="cpu", telemetry=telemetry, ledger=ledger, **kw)


OUTPUTS = ("energy", "accuracy", "loss", "n_scheduled", "q_levels", "latency", "payload_bits",
           "rates", "lambda1", "lambda2")
MODES = {
    "greedy": {},
    "compiled-ga": {"policy_mode": "compiled-ga", "ga_config": GAConfig(**GA_KW)},
    "same_size": {"policy_mode": "same_size", "ga_config": GAConfig(**GA_KW), "q_cap": 16},
    "no_quant": {"policy_mode": "no_quant", "q_cap": 16},
    "channel_allocate": {"policy_mode": "channel_allocate", "q_cap": 16},
    "principle": {"policy_mode": "principle", "q_cap": 16},
    "single_bs_faulty": {"scenario": "single_bs_faulty"},
    "delta": {"downlink": "delta"},
}


def _same_run(a, b, sim_a, sim_b):
    for k in OUTPUTS:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
    assert torch.equal(sim_a.final_flat, sim_b.final_flat)
    assert torch.equal(sim_a.entropy.generator.get_state(), sim_b.entropy.generator.get_state())


@pytest.mark.parametrize("mode", list(MODES))
def test_telemetry_on_changes_only_what_is_reported(mode):
    """Off (None, or an explicit enabled=False) runs the untapped round: the
    same draws and numbers bit for bit; on adds ``metrics`` and changes no
    other output."""
    kw = MODES[mode]
    none_sim, off_sim, on_sim = (_port(t, **kw) for t in (None, MetricsConfig(), ON))
    res = {name: sim.run_compiled(ROUNDS)
           for name, sim in (("none", none_sim), ("off", off_sim), ("on", on_sim))}
    assert res["none"].metrics is None and res["off"].metrics is None
    _same_run(res["none"], res["off"], none_sim, off_sim)
    _same_run(res["none"], res["on"], none_sim, on_sim)
    assert set(res["on"].metrics) == set(METRIC_FIELDS)
    if mode in ("compiled-ga", "same_size"):
        m = res["on"].metrics
        assert np.isfinite(m["ga_best"]).all() and (m["ga_best"] <= m["ga_median"]).all()


def test_sub_taps_off_leave_their_fields_nan():
    """``quant_mse=False`` and ``ga_fitness=False`` drop those taps (NaN)
    and keep every other tap and output as with them on."""
    kw = MODES["compiled-ga"]
    full, part = _port(ON, **kw), _port(MetricsConfig(True, quant_mse=False, ga_fitness=False), **kw)
    a, b = full.run_compiled(ROUNDS), part.run_compiled(ROUNDS)
    _same_run(a, b, full, part)
    for k in METRIC_FIELDS:
        if k in ("quant_mse", "ga_best", "ga_median"):
            assert np.isnan(b.metrics[k]).all(), k
        else:
            np.testing.assert_array_equal(a.metrics[k], b.metrics[k], err_msg=k)


def test_every_round_still_launches_one_aggregate_with_every_tap_on(monkeypatch):
    """The fleet round's aggregate runs once per round with every tap on
    (counted through the wrapper; on the CPU it runs its plain version)."""
    from repro_torch.kernels import stochastic_quant as sq

    calls = []
    real = sq.aggregate
    monkeypatch.setattr(sq, "aggregate", lambda *a, **k: calls.append(1) or real(*a, **k))
    sim = _port(ON, scenario="single_bs_faulty", downlink="delta",
                policy_mode="compiled-ga", ga_config=GAConfig(**GA_KW))
    res = sim.run_compiled(ROUNDS)
    assert len(calls) == ROUNDS and res.metrics is not None


# ------------------------------------------------------ host replay taps

@functools.lru_cache(maxsize=None)
def _host_runs(case):
    jsim, jres, tsim, tres = _runs(case)
    jsim.run_host_policy(jsim.make_host_policy(), ROUNDS, channel="sim")
    tsim.run_host_policy(tsim.make_host_policy(), ROUNDS, channel="sim")
    return jsim.last_host_metrics, tsim.last_host_metrics, tres.metrics


@pytest.mark.parametrize("case", ["greedy", "compiled-ga"])
def test_host_metrics_match_compiled_and_reference(case):
    jhost, thost, compiled = _host_runs(case)
    assert len(thost) == len(jhost) == ROUNDS
    stack = {k: np.array([row[k] for row in thost], np.float32) for k in METRIC_FIELDS}
    jstack = {k: np.array([row[k] for row in jhost], np.float32) for k in METRIC_FIELDS}
    # against the port's own compiled taps: exact-input fields bit-equal
    # (the same function on the same device), the KKT's analog fields within
    # the parity suites' tolerance; the host GA keeps no population median
    _check_taps(stack, compiled, fields=[f for f in METRIC_FIELDS if f != "ga_median"])
    assert np.isnan(stack["ga_median"]).all()
    assert np.isfinite(stack["ga_best"]).all() == (case == "compiled-ga")
    # against the JAX package's host replay, field by field
    _check_taps(stack, jstack)


def test_host_metrics_off_and_faults():
    sim = _port()
    sim.run_host_policy(sim.make_host_policy(), 2)
    assert sim.last_host_metrics is None
    sim = _port(ON, scenario="single_bs_faulty", downlink="quant")
    res = sim.run_compiled(ROUNDS)
    sim.run_host_policy(sim.make_host_policy(), ROUNDS)
    host = sim.last_host_metrics
    for k in FAULT_FIELDS + ("dl_payload_bits",):
        np.testing.assert_array_equal(np.array([r[k] for r in host], np.float32),
                                      res.metrics[k], err_msg=k)
    np.testing.assert_allclose(np.array([r["dl_mse"] for r in host]), res.metrics["dl_mse"],
                               **ANALOG)


# ------------------------------------------------------------- the ledger

def test_ledger_smoke_run_schema_valid(tmp_path):
    """A telemetry run through a ledger file: every line validates, the
    header describes the run, and round rows carry the taps."""
    path = str(tmp_path / "run.jsonl")
    sim = _port(ON, Ledger(path))
    sim.run_compiled(ROUNDS, with_eval=False)
    events = read_ledger(path)
    kinds = [e["event"] for e in events]
    assert kinds.count("run_header") == 1 and kinds.count("round") == ROUNDS
    assert kinds.count("timing") == 1
    header = next(e for e in events if e["event"] == "run_header")
    for k in ("scenario_hash", "policy", "u", "c", "rounds", "torch_version", "git_rev"):
        assert k in header, f"run_header missing {k}"
    assert header["torch_version"] == torch.__version__ and header["entry"] == "run_compiled"
    rounds = [e for e in events if e["event"] == "round"]
    assert [e["round"] for e in rounds] == list(range(ROUNDS))
    for e in rounds:
        assert "energy" in e and "q_mean" in e and "quant_mse" in e
        assert all(not (isinstance(v, float) and math.isnan(v)) for v in e.values())
    with open(path) as f:  # strict JSON: no NaN literal on any line
        assert all("NaN" not in line for line in f)


def test_ledger_segments_and_resume(tmp_path):
    """A segmented run writes one ``resume`` save per interior boundary, a
    resume writes its load, and both runs' rows equal the unsegmented
    run's."""
    kw = dict(scenario="single_bs_faulty", downlink="delta")
    full = _port(ON, **kw).run_compiled(6)
    path, ck = str(tmp_path / "seg.jsonl"), str(tmp_path / "ck")
    seg = _port(ON, Ledger(path, run_id="seg"), **kw).run_compiled(6, segment=2, ckpt_dir=ck)
    res = _port(ON, Ledger(path, run_id="res"), **kw).resume_compiled(ck)
    for got in (seg, res):
        for k in METRIC_FIELDS:
            np.testing.assert_array_equal(got.metrics[k], full.metrics[k], err_msg=k)
    events = read_ledger(path)
    by = {r: [e for e in events if e["run_id"] == r] for r in ("seg", "res")}
    saves = [(e["step"], e["action"]) for e in by["seg"] if e["event"] == "resume"]
    assert saves == [(2, "save"), (4, "save")]
    assert [(e["step"], e["action"]) for e in by["res"] if e["event"] == "resume"][0] == (4, "load")
    header = next(e for e in by["res"] if e["event"] == "run_header")
    assert header["entry"] == "resume_compiled" and header["rounds"] == 6
    assert len([e for e in by["res"] if e["event"] == "round"]) == 6
    # a checkpoint of a run without telemetry does not resume a tapped one
    ck2 = str(tmp_path / "ck2")
    _port(**kw).run_compiled(4, segment=2, ckpt_dir=ck2)
    from repro_torch.ckpt import CheckpointError

    with pytest.raises(CheckpointError, match="telemetry"):
        _port(ON, **kw).resume_compiled(ck2)


def test_ledger_host_policy_rows(tmp_path):
    path = str(tmp_path / "host.jsonl")
    sim = _port(ON, Ledger(path))
    sim.run_host_policy(sim.make_host_policy(), 2)
    events = read_ledger(path)
    header = next(e for e in events if e["event"] == "run_header")
    assert header["entry"] == "run_host_policy"
    rows = [e for e in events if e["event"] == "round"]
    assert len(rows) == 2 and all("corr_q_d" in r and "energy" in r for r in rows)


def test_ledger_null_sink_is_noop(tmp_path):
    led = Ledger(None)
    assert not led.enabled
    assert led.write("round", round=0) is None
    assert led.run_header("x", "y") is None
    assert list(tmp_path.iterdir()) == []


def test_default_ledger_env_resolution(tmp_path, monkeypatch):
    monkeypatch.delenv(REPRO_LEDGER_ENV, raising=False)
    assert not default_ledger().enabled
    p = str(tmp_path / "env.jsonl")
    monkeypatch.setenv(REPRO_LEDGER_ENV, p)
    assert default_ledger().path == p
    q = str(tmp_path / "cli.jsonl")
    assert default_ledger(q).path == q


def test_ledger_write_failure_degrades_to_null_sink(tmp_path, monkeypatch):
    led = Ledger(str(tmp_path / "led.jsonl"))
    calls = {"n": 0}

    def boom(self, line):
        calls["n"] += 1
        raise OSError("disk on fire")

    monkeypatch.setattr(Ledger, "_append", boom)
    with pytest.warns(RuntimeWarning, match="disabling ledger"):
        assert led.write("round", round=0) is None
    assert calls["n"] == 2, "exactly one retry before degrading"
    assert not led.enabled
    assert led.write("round", round=1) is None
    assert calls["n"] == 2


def test_ledger_write_retries_transient_oserror(tmp_path, monkeypatch):
    path = str(tmp_path / "led.jsonl")
    led = Ledger(path)
    real_append = Ledger._append
    state = {"fail_next": True}

    def flaky(self, line):
        if state["fail_next"]:
            state["fail_next"] = False
            raise OSError("transient")
        return real_append(self, line)

    monkeypatch.setattr(Ledger, "_append", flaky)
    ev = led.write("round", round=0)
    assert ev is not None and led.enabled
    (read,) = read_ledger(path)
    assert read["round"] == 0


def test_ledger_resume_event_schema(tmp_path):
    path = str(tmp_path / "led.jsonl")
    led = Ledger(path)
    led.write("resume", step=4, action="save", dir="ck")
    led.write("resume", step=4, action="load", dir="ck")
    evs = read_ledger(path)
    assert [e["action"] for e in evs] == ["save", "load"]
    assert all(e["event"] == "resume" and e["step"] == 4 for e in evs)
    with pytest.raises(ValueError):
        validate_event({"schema": 1, "event": "resume", "run_id": "r", "ts": 0.0, "step": 4})


def test_validate_event_rejects_malformed():
    ok = {"schema": 1, "event": "round", "run_id": "r", "ts": 0.0, "round": 0}
    validate_event(dict(ok))
    with pytest.raises(ValueError):
        validate_event({k: v for k, v in ok.items() if k != "run_id"})
    with pytest.raises(ValueError):
        validate_event({**ok, "schema": 99})
    with pytest.raises(ValueError):
        validate_event({**ok, "event": "mystery"})
    with pytest.raises(ValueError):
        validate_event({k: v for k, v in ok.items() if k != "round"})
    with pytest.raises(ValueError):
        validate_event({**ok, "ts": "now"})
    # the JAX package's kinds, hlo included, validate here
    from repro.obs.ledger import EVENT_FIELDS as JEVENT_FIELDS
    from repro_torch.obs.ledger import EVENT_FIELDS

    assert EVENT_FIELDS == JEVENT_FIELDS


def test_sanitize_nan_numpy_and_tensors():
    out = _sanitize({
        "nan": float("nan"), "inf": float("inf"),
        "np": np.float32(1.5), "arr": np.arange(3),
        "nested": [np.int64(2), float("nan")],
        "t0": torch.tensor(2.5), "tnan": torch.tensor(float("nan")), "t1": torch.arange(2),
    })
    assert out["nan"] is None and out["inf"] is None
    assert out["np"] == 1.5 and out["arr"] == [0, 1, 2]
    assert out["nested"] == [2, None]
    assert out["t0"] == 2.5 and out["tnan"] is None and out["t1"] == [0, 1]


def test_pytree_hash_discriminates():
    from repro_torch import tree

    assert pytree_hash is tree.pytree_hash
    t1 = {"a": torch.arange(4.0), "b": np.int32(3)}
    assert pytree_hash(t1) == pytree_hash({"a": torch.arange(4.0), "b": np.int32(3)})
    assert pytree_hash(t1) != pytree_hash({"a": torch.arange(4.0) + 1, "b": np.int32(3)})
    assert pytree_hash(np.zeros(2, np.float32)) != pytree_hash(np.zeros(2, np.int32))


def test_timed_phase_warmup_and_event(tmp_path):
    path = str(tmp_path / "t.jsonl")
    led = Ledger(path)
    order = []
    with timed_phase("phase_x", led, warmup=lambda: order.append("warm"), n=7) as t:
        order.append("body")
    assert order == ["warm", "body"]
    assert t.seconds >= 0.0 and t.name == "phase_x"
    (ev,) = read_ledger(path)
    assert ev["event"] == "timing" and ev["phase"] == "phase_x"
    assert ev["n"] == 7 and ev["seconds"] == pytest.approx(t.seconds)


def test_timed_phase_without_ledger():
    with timed_phase("bare") as t:
        pass
    assert t.seconds >= 0.0


# ------------------------------------------- one schema, both packages

def test_ledgers_cross_read(tmp_path):
    """A ledger the port wrote reads and summarizes in the JAX package, and
    the reverse; the two summaries of one file agree."""
    tpath, jpath = str(tmp_path / "port.jsonl"), str(tmp_path / "jax.jsonl")
    _port(ON, Ledger(tpath)).run_compiled(ROUNDS)
    jsim = _runs("greedy")[0]         # its scan is compiled already
    jsim.ledger = JLedger(jpath)
    try:
        jsim.run_compiled(ROUNDS)
    finally:
        jsim.ledger = JLedger(None)
    for path in (tpath, jpath):
        assert read_ledger(path) == jread_ledger(path)
        (ts,), (js,) = treport.summarize(path), jreport.summarize(path)
        assert ts == js
        assert treport.render(ts) == jreport.render(js)
        assert ts["n_rounds"] == ROUNDS
        events = read_ledger(path)
        assert treport.summarize_run(events) == jreport.summarize_run(events)
    header = next(e for e in read_ledger(jpath) if e["event"] == "run_header")
    assert "jax_version" in header


def test_report_cli(tmp_path, capsys, monkeypatch):
    path = str(tmp_path / "cli.jsonl")
    _port(ON, Ledger(path)).run_compiled(2)
    monkeypatch.setattr("sys.argv", ["report", path, "--target-acc", "0.0"])
    assert treport.main() == 0
    out = capsys.readouterr().out
    assert "rounds=2" in out and "energy_to_target" in out and "Remark 1" in out


# ------------------------------------------------------ profiler hooks

def test_maybe_trace_writes_a_chrome_trace(tmp_path):
    with tprofile.maybe_trace(None):
        pass
    d = tmp_path / "trace"
    with tprofile.maybe_trace(str(d)):
        with tprofile.scope("round"), tprofile.scope("kkt_solve"):
            torch.ones(4).sum()
    (trace,) = list(d.iterdir())
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"round", "kkt_solve"} <= names


def test_maybe_trace_only_warns_when_the_profiler_fails(tmp_path, monkeypatch, capsys):
    def broken(*a, **k):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch.profiler, "profile", broken)
    ran = []
    with tprofile.maybe_trace(str(tmp_path / "t")):
        ran.append(1)
    assert ran == [1] and "trace capture unavailable" in capsys.readouterr().out
