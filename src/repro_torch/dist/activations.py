"""Activation layouts inside the model forward (the port of
``repro.dist.activations``).

:func:`activation_mesh` makes a :class:`~repro_torch.dist.plan.MeshPlan`
on a ``DeviceMesh`` the active plan for the code it wraps. The port's
model code is eager and per rank, so the plan decides which code runs
rather than how XLA lays a value out: under a plan whose ``seq`` axis
resolves with more than one rank, the dense forward and prefill hold one
sequence shard each and attention runs the ring
(``models.model._flash_dispatch``).

:func:`shard_act` is the JAX package's layout hint, which changes no value
there (``with_sharding_constraint``). Here it is the identity: it checks
the pattern (an unknown one raises, as the JAX function does) and returns
``x``. The pattern table is the JAX package's.

Patterns:  ``bt``   (B, T)             token ids
           ``btd``  (B, T, D)          layer boundary, D replicated
           ``bshd`` (B, S, H, hd)      attention heads on ``model``
           ``bsf``  (B, S, F)          SwiGLU hidden on ``model``
           ``h2``   (B, S, H, ...)     head axis at index 2
           ``h3``   (B, S, ?, H, ...)  head axis at index 3
           ``bse``  (B, S, E)          MoE router plane, E replicated
           ``bsec`` (B, S, E, C)       MoE dispatch mask, seq-sharded
           ``becd`` (B, E, C, D)       expert-parallel compute layout
           ``becd_cap`` (B, E, C, D)   capacity-sharded all-to-all staging
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

from repro_torch.dist.plan import MeshPlan, make_plan

_ACTIVE_PLAN: contextvars.ContextVar[Optional[MeshPlan]] = contextvars.ContextVar(
    "repro_torch_activation_plan", default=None
)

# pattern -> logical dim names, left-aligned; trailing dims replicate.
_PATTERN_DIMS = {
    "bt": ("act_batch", "seq"),
    "btd": ("act_batch", "seq", None),
    "bshd": ("act_batch", "seq", "heads", "head_dim"),
    "bsf": ("act_batch", "seq", "mlp"),
    "h2": ("act_batch", "seq", "heads"),
    "h3": ("act_batch", "seq", None, "heads"),
    "bse": ("act_batch", "seq", None),
    "bsec": ("act_batch", "seq", None, None),
    "becd": ("act_batch", "expert", None, None),
    "becd_cap": ("act_batch", None, "moe_capacity", None),
}


@contextlib.contextmanager
def activation_mesh(mesh_or_plan):
    """Make a plan the active one for the duration of the block. A bare
    ``DeviceMesh`` is wrapped in the default train plan; a plan over axis
    sizes only raises (the per-rank paths need the mesh's groups)."""
    plan = (mesh_or_plan if isinstance(mesh_or_plan, MeshPlan)
            else make_plan(mesh_or_plan))
    if plan.mesh is None:
        raise ValueError("activation_mesh needs a plan built on a DeviceMesh")
    token = _ACTIVE_PLAN.set(plan)
    try:
        yield plan
    finally:
        _ACTIVE_PLAN.reset(token)


def current_activation_mesh():
    plan = _ACTIVE_PLAN.get()
    return None if plan is None else plan.mesh


def current_activation_plan() -> Optional[MeshPlan]:
    return _ACTIVE_PLAN.get()


def expert_dispatch_active(n_experts: int) -> bool:
    """True when the active plan shards an ``n_experts``-wide expert axis."""
    plan = _ACTIVE_PLAN.get()
    if plan is None:
        return False
    ent = plan.resolve(n_experts, "expert")
    return ent is not None and plan.axis_size(ent) > 1


def shard_act(x, pattern: str):
    """The identity on ``x`` for a known ``pattern``; an unknown one raises."""
    if pattern not in _PATTERN_DIMS:
        raise ValueError(
            f"unknown shard_act pattern {pattern!r}; known: {sorted(_PATTERN_DIMS)}"
        )
    return x
