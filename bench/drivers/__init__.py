"""Drivers: the half of a run that belongs to one kind of configuration.

A configuration file names its driver (``"driver": "fleet"``), and the
harness imports ``bench.drivers.<driver>``. A driver module gives:

- ``build(spec, seed, device)``: the program's state; data from the
  configuration's seed, weights and every draw from the run's ``--seed``;
- ``warm(state, traffic)``: one round with every shape a call uses built
  (the harness's precision round runs it too, under the profiler);
- ``call(state, traffic)``: one timed call, its results on the host on
  return;
- ``rounds_per_call(traffic)``: the rounds one call completes, which
  ``round_ms`` divides by;
- ``failed(res)``: the failed rounds of a call's results;
- ``outputs(state, res)``: a call's results in the reference's terms,
  taken before the state is freed;
- ``judge(spec, seed, run, device)``: ``(numbers, readings)`` of ``run``
  against the plain reference, each number ``{"value", "limit"}`` with
  its limit from ``limits/<workload>.json``;
- ``round_flops(config, traffic)`` and ``FLOP_PEAK``, the ``peaks.json``
  key of the precision the configuration states (``metrics/round_mfu``
  reads them; a driver without them has no ``round_mfu``);
- ``check_files(spec)``: the file checks that hold for its kind of cell
  (``bench/test_bench_spec.py`` calls it); raises ``ValueError``.
"""
