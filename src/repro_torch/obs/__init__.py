"""repro_torch.obs — the fleet telemetry layer (the port of ``repro.obs``).

* **metric taps** (``metrics``): a ``RoundMetrics`` record per round,
  computed on the device behind a ``MetricsConfig`` gate and stacked with
  the round's outputs, so telemetry off runs the untapped round;
* **structured run ledger** (``ledger``): the versioned JSONL sink the
  fleet engine writes through (run headers, per-round rows, timings from
  ``timed_phase``, segment save/load events), in the JAX package's
  schema, and ``report`` to summarize a ledger file;
* **profiler hooks** (``profile``): ``torch.profiler`` ranges for the hot
  kernels and an opt-in trace capture (``maybe_trace``).
"""
from repro_torch.obs.ledger import (  # noqa: F401
    LEDGER_SCHEMA_VERSION, Ledger, default_ledger, pytree_hash, read_ledger,
    timed_phase, validate_event,
)
from repro_torch.obs.metrics import (  # noqa: F401
    METRIC_FIELDS, METRICS_OFF, MetricsConfig, RoundMetrics,
    decision_metrics, decision_metrics_host, metrics_to_dict,
)
from repro_torch.obs.profile import maybe_trace, scope  # noqa: F401
