"""Faults planted under the timed path, for the check's own tests and for
reading what the check gives when the program is broken. Each is a
context manager that patches one public function the fleet round calls:

- ``stale_step``: local SGD hands back every client's model unchanged
  (a step that returns its state unchanged);
- ``half_batch``: the aggregate leaves out the second half of the slots
  and renormalizes the eq.-2 weights over the rest;
- ``altered_level``: the decision's level of its first scheduled client
  is moved by one where it is produced.
"""
from __future__ import annotations

import contextlib
from unittest import mock


@contextlib.contextmanager
def stale_step():
    from repro_torch.sim import engine

    real = engine.fleet_local_sgd

    def stale(loss_fn, tau, params, x_s, y_s, batch_idx, lr):
        stacked, g, s = real(loss_fn, tau, params, x_s, y_s, batch_idx, lr)
        same = {a: {b: params[a][b].expand_as(t).clone() for b, t in leaves.items()}
                for a, leaves in stacked.items()}
        return same, g, s

    with mock.patch.object(engine, "fleet_local_sgd", stale):
        yield


@contextlib.contextmanager
def half_batch():
    import torch
    from repro_torch.kernels import stochastic_quant as sq

    real = sq.aggregate

    def half(idx, signs, scales, weights, q_bits):
        keep = torch.arange(weights.shape[0], device=weights.device) < (weights.shape[0] + 1) // 2
        w = torch.where(keep, weights, torch.zeros_like(weights))
        return real(idx, signs, scales, w / torch.clamp(w.sum(), min=1e-12), q_bits)

    with mock.patch.object(sq, "aggregate", half):
        yield


@contextlib.contextmanager
def altered_level():
    import dataclasses

    import torch
    from repro_torch.sim import policy

    real = policy.decide

    def altered(*args, **kwargs):
        dec = real(*args, **kwargs)
        q_cap = kwargs.get("q_cap", 8)
        first = torch.clamp(dec.slots[:1], min=0)
        q = dec.q.clone()
        q[first] = torch.where(q[first] >= q_cap, q[first] - 1, q[first] + 1)
        return dataclasses.replace(dec, q=torch.where(dec.a > 0, q, dec.q))

    with mock.patch.object(policy, "decide", altered):
        yield


FAULTS = {"stale_step": stale_step, "half_batch": half_batch, "altered_level": altered_level}
