"""One reader per per-layer metric, ``read(ctx) -> float | None``, found by
the metric's name. ``ctx``: ``view`` (``bench.trace.TraceView`` of one
traced call), ``config``, ``traffic``, ``driver`` (the cell's
``bench.drivers`` module), ``untraced_round_s`` (the round time of the
untraced call before it) and ``device_kind``. A reader that finds nothing
to read returns None and the metric is left out."""
