"""The structured run ledger (the port of ``repro.obs.ledger``): one
versioned JSONL schema for every entry point.

A ledger file is a sequence of JSON objects, one per line, each carrying
the common envelope ``{schema, event, run_id, ts}`` plus the per-kind
payload fields below. ``schema`` is :data:`LEDGER_SCHEMA_VERSION`; readers
reject events of another version instead of mis-parsing them. The schema
is the JAX package's, so a ledger written by either package validates and
summarizes in the other.

Event kinds
-----------

``run_header``  one per run: run name, entry point, scenario hash, fleet
                shape / policy, git rev, torch version (the JAX package
                stamps its jax version instead).
``round``       one per FL round: the ``RoundRecord`` columns plus (when
                telemetry is on) the ``RoundMetrics`` fields.
``timing``      one per timed phase (``timed_phase``): phase name and
                seconds, with warmup excluded by construction.
``hlo``         HLO byte attribution, written by the JAX package only
                (the port lowers no HLO); accepted here so its ledgers
                validate.
``record``      a free-form record from a sweep; the payload is kept as-is
                under ``"payload"``. ``launch.dryrun`` writes one per run
                (``Ledger.record``), source ``launch.dryrun[<arch>,<shape>]``.
``resume``      one per segmented-run checkpoint boundary: the step (next
                round index) and whether the state was saved
                (``action="save"``) or restored (``action="load"``).

Telemetry must never kill a run: a failed append is retried once (a
transient NFS hiccup, fd exhaustion) and then the ledger becomes the null
sink with a single ``RuntimeWarning``: the experiment keeps its results and
loses its log.

``Ledger(None)`` is the null sink (every write is a no-op), so call sites
never branch on "is telemetry configured". ``default_ledger()`` reads the
``REPRO_LEDGER`` environment variable, the knob both packages share.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import time
import warnings
from typing import Any, Callable, Iterator, Optional

import torch

from repro_torch.tree import pytree_hash  # noqa: F401  (re-exported)

LEDGER_SCHEMA_VERSION = 1
REPRO_LEDGER_ENV = "REPRO_LEDGER"

# event kind -> required payload fields (beyond the common envelope)
EVENT_FIELDS: dict[str, tuple[str, ...]] = {
    "run_header": ("name", "entry"),
    "round": ("round",),
    "timing": ("phase", "seconds"),
    "hlo": ("source", "payload"),
    "record": ("source", "payload"),
    "resume": ("step", "action"),
}
_ENVELOPE = ("schema", "event", "run_id", "ts")


def _sanitize(obj: Any) -> Any:
    """JSON-ready copy: numpy and 0-d torch scalars -> python, NaN/inf ->
    None (strict JSON has no NaN literal, and a null metric reads as "not
    defined this round", e.g. corr_q_d with < 2 scheduled clients)."""
    if hasattr(obj, "item") and not hasattr(obj, "__len__"):
        obj = obj.item()
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {str(k): _sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_sanitize(v) for v in obj]
    if hasattr(obj, "tolist"):  # numpy arrays, tensors
        return _sanitize(obj.tolist())
    return obj


def validate_event(ev: dict) -> dict:
    """Raise ``ValueError`` unless ``ev`` is a well-formed ledger event of
    this schema version; returns the event for chaining."""
    for k in _ENVELOPE:
        if k not in ev:
            raise ValueError(f"ledger event missing envelope field {k!r}: {ev}")
    if ev["schema"] != LEDGER_SCHEMA_VERSION:
        raise ValueError(f"ledger schema {ev['schema']!r} != {LEDGER_SCHEMA_VERSION}")
    kind = ev["event"]
    if kind not in EVENT_FIELDS:
        raise ValueError(f"unknown ledger event kind {kind!r}")
    missing = [k for k in EVENT_FIELDS[kind] if k not in ev]
    if missing:
        raise ValueError(f"ledger {kind!r} event missing {missing}: {ev}")
    if not isinstance(ev["ts"], (int, float)):
        raise ValueError(f"ledger ts must be numeric: {ev['ts']!r}")
    return ev


def read_ledger(path: str) -> list[dict]:
    """Load and validate every event of a ledger file."""
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                events.append(validate_event(json.loads(line)))
    return events


def git_rev(root: Optional[str] = None) -> Optional[str]:
    """Short hash of the checkout's HEAD, or None outside a git checkout."""
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=root,
            capture_output=True, text=True, timeout=5,
        ).stdout.strip() or None
    except Exception:  # noqa: BLE001 (a header degrades, it never fails a run)
        return None


class Ledger:
    """Append-per-write JSONL sink. ``Ledger(None)`` is the null sink."""

    def __init__(self, path: Optional[str], run_id: Optional[str] = None):
        self.path = path or None
        if run_id is None:
            run_id = f"{int(time.time() * 1e3):x}-{os.getpid()}"
        self.run_id = run_id

    @property
    def enabled(self) -> bool:
        return self.path is not None

    def write(self, event: str, **fields: Any) -> Optional[dict]:
        if not self.enabled:
            return None
        ev = {
            "schema": LEDGER_SCHEMA_VERSION, "event": event,
            "run_id": self.run_id, "ts": time.time(),
            **_sanitize(fields),
        }
        validate_event(ev)
        line = json.dumps(ev) + "\n"
        # a transient OSError is retried once; a second failure turns the
        # ledger into the null sink with one warning instead of raising into
        # the experiment. A malformed event (above) still raises: that is a
        # caller's bug, not an I/O fault.
        try:
            self._append(line)
        except OSError:
            time.sleep(0.05)
            try:
                self._append(line)
            except OSError as e:
                warnings.warn(
                    f"ledger write to {self.path!r} failed twice ({e}); "
                    "disabling ledger for the rest of this run",
                    RuntimeWarning,
                    stacklevel=2,
                )
                self.path = None
                return None
        return ev

    def _append(self, line: str) -> None:
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(self.path, "a") as f:
            f.write(line)

    # ------------------------------------------------ typed conveniences

    def run_header(self, name: str, entry: str, **meta: Any) -> Optional[dict]:
        """One per run: who/what/where. ``meta`` carries scenario_hash,
        policy, u/c and so on; the git rev and the torch version are stamped
        here so every ledger describes itself."""
        return self.write("run_header", name=name, entry=entry, git_rev=git_rev(),
                          torch_version=torch.__version__, **meta)

    def round_row(self, round: int, **metrics: Any) -> Optional[dict]:  # noqa: A002
        return self.write("round", round=int(round), **metrics)

    def timing(self, phase: str, seconds: float, **meta: Any) -> Optional[dict]:
        return self.write("timing", phase=phase, seconds=float(seconds), **meta)

    def record(self, source: str, payload: dict, **meta: Any) -> Optional[dict]:
        return self.write("record", source=source, payload=payload, **meta)


def default_ledger(path: Optional[str] = None) -> Ledger:
    """The ``--ledger PATH`` / ``REPRO_LEDGER`` resolution: an explicit path
    wins, else the environment variable, else the null sink."""
    return Ledger(path or os.environ.get(REPRO_LEDGER_ENV) or None)


class PhaseTiming:
    """What ``timed_phase`` yields; ``seconds`` is set on exit."""

    def __init__(self, name: str):
        self.name = name
        self.seconds: float = 0.0


@contextlib.contextmanager
def timed_phase(
    name: str,
    ledger: Optional[Ledger] = None,
    warmup: Optional[Callable[[], Any]] = None,
    **meta: Any,
) -> Iterator[PhaseTiming]:
    """One timing block: runs ``warmup`` (a first call that builds kernels,
    warms the allocator) before the clock starts, yields a
    :class:`PhaseTiming` whose ``.seconds`` is valid after the block, and
    writes a ledger ``timing`` event when a ledger is given. The block's
    host clock includes device work only if the block waits for it.

        with timed_phase("run", ledger, warmup=warm) as t:
            do_work()
        print(t.seconds)
    """
    if warmup is not None:
        warmup()
    t = PhaseTiming(name)
    t0 = time.perf_counter()
    try:
        yield t
    finally:
        t.seconds = time.perf_counter() - t0
        if ledger is not None:
            ledger.timing(name, t.seconds, **meta)
