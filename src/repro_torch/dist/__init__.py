"""Distribution substrate of the port (``repro.dist``): logical-axis mesh
plans, rule-based partition specs, activation plans, the sequence ring and
model parallelism.

  * :mod:`repro_torch.dist.plan`: the :class:`MeshPlan` logical-axis ->
    mesh-axis rule table (2D/3D/4D ``(pod, data, seq, model)``), with
    divisibility gating and no axis reuse; DTensor placements and each
    rank's local slice of a spec;
  * :mod:`repro_torch.dist.sharding`: partition specs for params,
    optimizer state, batches and KV caches through a plan, and the local
    pieces of a tree;
  * :mod:`repro_torch.dist.activations`: the active plan of a forward
    (:func:`activation_mesh`) and the ``shard_act`` pattern table;
  * :mod:`repro_torch.dist.ring`: ``merge_partials`` and
    ``ring_flash_attention`` over a process group or a single-process
    emulation, each step through the flash kernels;
  * :mod:`repro_torch.dist.collectives`: every collective the port issues,
    differentiable where a forward needs one, and their accounting
    (``CollectiveCounter``);
  * :mod:`repro_torch.dist.placement`: parameters and optimizer state as
    DTensors (``place_tree``, ``full_tree``, ``init_params_local``);
  * :mod:`repro_torch.dist.parallel`: a rank's view of a model-parallel
    forward (FSDP gathers, TP/EP on ``model``).
"""
from repro_torch.dist import activations, collectives, parallel, placement, plan, ring, sharding

__all__ = ["activations", "collectives", "parallel", "placement", "plan", "ring", "sharding"]
