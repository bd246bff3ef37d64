"""Production meshes (the port of ``repro.launch.mesh``) as
``torch.distributed`` ``DeviceMesh``es.

The canonical axis vocabulary is 4D ``(pod, data, seq, model)``; rank-2
shapes are ``(data, model)``, rank-3 ``(pod, data, model)``. The rule
tables in :mod:`repro_torch.dist.plan` skip absent axes, so every spec
path works across ranks.

The process group must be initialized by the caller (``nccl`` on the
card, ``gloo`` on the CPU); this module never initializes one. A mesh
that needs fewer ranks than the world holds takes the leading ranks in
row-major order, as the JAX package slices ``jax.devices()``; a rank
outside it gets ``None``.
"""
from __future__ import annotations

import math
from typing import Optional, Union

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

# rank -> axis names (trailing/leading degenerate axes dropped)
MESH_AXIS_NAMES = {
    2: ("data", "model"),
    3: ("pod", "data", "model"),
    4: ("pod", "data", "seq", "model"),
}


def parse_mesh_shape(shape_str: str) -> tuple:
    """``"1x4x2x16"`` -> ``(1, 4, 2, 16)`` (rank 2-4)."""
    dims = tuple(int(x) for x in shape_str.lower().split("x"))
    if len(dims) not in MESH_AXIS_NAMES:
        raise ValueError(
            f"mesh shape must have rank 2-4, got {shape_str!r}"
        )
    return dims


def mesh_label(mesh) -> str:
    """``2x16x16``-style label from a mesh's axis sizes."""
    return "x".join(str(s) for s in mesh.mesh.shape)


def _make_mesh(shape: tuple, axes: tuple, device) -> Optional["dist.DeviceMesh"]:
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    dev = resolve_device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_production_mesh: no CUDA device was found; pass "
                           "device=\"cpu\" for a gloo mesh")
    if not dist.is_initialized():
        raise RuntimeError("make_production_mesh: initialize the process group first "
                           "(torch.distributed.init_process_group)")
    n, world = math.prod(shape), dist.get_world_size()
    if n > world:
        raise ValueError(f"mesh shape {shape} needs {n} devices, have {world}")
    if n == world:
        return init_device_mesh(dev.type, shape, mesh_dim_names=axes)
    # the leading n ranks, row-major; every rank builds the mesh (its
    # subgroups are created collectively), and the others get None
    mesh = DeviceMesh(dev.type, torch.arange(n).reshape(shape), mesh_dim_names=axes)
    return mesh if dist.get_rank() < n else None


def make_production_mesh(*, multi_pod: bool = False, shape=None,
                         device: Optional[Union[str, torch.device]] = None):
    """16x16 = 256 ranks per pod; 2 pods = 512 when ``multi_pod``.

    ``shape`` (a tuple or a ``"1x4x2x16"`` string) overrides the default:
    rank 2/3/4 maps onto :data:`MESH_AXIS_NAMES`; rank 4 enables the
    ``seq`` axis. ``device`` is ``cuda`` (NCCL) unless the caller passes
    ``"cpu"`` (gloo); without CUDA the default raises."""
    if shape is None:
        shape = (2, 16, 16) if multi_pod else (16, 16)
    elif isinstance(shape, str):
        shape = parse_mesh_shape(shape)
    else:
        shape = tuple(shape)
    if len(shape) not in MESH_AXIS_NAMES:
        raise ValueError(f"mesh shape must have rank 2-4, got {shape}")
    return _make_mesh(shape, MESH_AXIS_NAMES[len(shape)], device)


def make_host_mesh(device: Optional[Union[str, torch.device]] = None):
    """The 1x1 ``(data, model)`` mesh of rank 0."""
    return _make_mesh((1, 1), ("data", "model"), device)
