"""Logical-axis mesh plan (the port of ``repro.dist.plan``): one rule table
per mesh resolves *logical* dimension names to mesh-axis entries.

Every tree the port shards or lays out (params, optimizer state, batches,
KV caches, the fleet simulator's client stacks) is annotated with logical
axis names (``"embed"``, ``"heads"``, ``"mlp"``, ``"expert"``, ``"seq"``,
``"vocab"``, ``"clients"``, ``"batch"``, ...). A :class:`MeshPlan` binds a
mesh's axis-name -> size map to the rule table and resolves names at spec
time, with the JAX package's semantics, entry for entry:

  * **divisibility-gated**: a candidate is taken only when the product of
    its mesh-axis sizes divides the tensor dim; otherwise the next one is
    tried, ending in replication;
  * **absent axes are skipped**, so one table serves 2D ``(data, model)``,
    3D ``(pod, data, model)`` and 4D ``(pod, data, seq, model)`` meshes;
  * **no axis is used twice** within one spec;
  * **progressive FSDP**: ``(pod, data) -> (data,) -> replicated``.

Resolution needs only axis sizes, so a plan over a mapping never touches a
process group. A plan built on a ``torch.distributed`` ``DeviceMesh`` also
gives the DTensor placements of a spec (:func:`placements`) and the index
ranges a rank holds (:func:`local_slice`), which the ring attention and the
client-sharded fleet read.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional, Sequence

Pytree = Any


class _Unconstrained:
    """The ``P.UNCONSTRAINED`` sentinel: the dim's layout is left to the
    caller (the batch dim of every activation pattern)."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:
        return "UNCONSTRAINED"

    def __reduce__(self):
        return (_Unconstrained, ())


UNCONSTRAINED = _Unconstrained()


class PartitionSpec(tuple):
    """The port's ``PartitionSpec``: one entry per tensor dim, each ``None``
    (replicated), a mesh-axis name, a tuple of names (one dim over several
    mesh dims, major to minor) or :data:`UNCONSTRAINED`. A one-name tuple
    becomes the name, as JAX's spec normalizes it."""

    def __new__(cls, *entries):
        norm = []
        for ent in entries:
            if isinstance(ent, (tuple, list)):
                ent = tuple(ent)
                if len(ent) == 1:
                    ent = ent[0]
            norm.append(ent)
        return super().__new__(cls, norm)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec

# Logical axis vocabulary: exactly the keys of :func:`default_rules`.
LOGICAL_AXES = (
    # weights
    "embed",          # d_model rows/cols: the FSDP target in train mode
    "heads",          # attention query heads / rwkv heads
    "kv_heads",       # GQA key/value heads
    "head_dim",       # per-head feature dim: never sharded
    "mlp",            # SwiGLU hidden f
    "expert",         # MoE expert axis E
    "vocab",          # (un)tied embedding vocab
    "mamba_inner",    # mamba inner/projection dim
    "stacked_layers", # the stacked L axis: never sharded
    # data / state
    "batch",          # global-batch leading dim: FSDP axes
    "clients",        # stacked FL client axis (fleet sim, federated round)
    "cache_seq",      # decode ring-buffer positions: never sharded
    # activations
    "act_batch",      # activation leading dim: UNCONSTRAINED
    "seq",            # sequence/token dim of activations
    "moe_capacity",   # capacity slots of the dispatched (B, E, C, D) tensor
)


def progressive(axes: Sequence[str]) -> tuple:
    """FSDP-style degradation: ``("pod", "data")`` ->
    ``(("pod", "data"), "data", None)``."""
    axes = tuple(axes)
    cands: list = []
    for i in range(len(axes)):
        tail = axes[i:]
        cands.append(tail[0] if len(tail) == 1 else tail)
    cands.append(None)
    return tuple(cands)


def default_rules(
    *, mode: str = "train", fsdp: Sequence[str] = ("pod", "data"),
    client_axis: Optional[str] = None,
) -> dict:
    """The one rule table behind every spec. ``mode="serve"`` replicates
    the FSDP dims of weights; batches keep their dp sharding in both
    modes. ``client_axis`` routes the ``clients`` logical axis."""
    if mode not in ("train", "serve"):
        raise ValueError(f"mode must be 'train' or 'serve', got {mode!r}")
    dp = progressive(fsdp)
    tp = ("model", None)
    rules = {
        # weights
        "embed": dp if mode == "train" else (None,),
        "heads": tp,
        "kv_heads": tp,
        "head_dim": (None,),
        "mlp": tp,
        "expert": tp,
        "vocab": tp,
        "mamba_inner": tp,
        "stacked_layers": (None,),
        # data / state
        "batch": dp,
        "clients": (client_axis, None) if client_axis else (None,),
        "cache_seq": (None,),
        # activations
        "act_batch": (UNCONSTRAINED,),
        "seq": ("seq", None),
        "moe_capacity": tp,
    }
    assert set(rules) == set(LOGICAL_AXES), (
        "default_rules and LOGICAL_AXES drifted apart: "
        f"{set(rules) ^ set(LOGICAL_AXES)}"
    )
    return rules


def _entry_axes(ent) -> tuple:
    if ent is None or ent is UNCONSTRAINED:
        return ()
    return (ent,) if isinstance(ent, str) else tuple(ent)


def _is_device_mesh(mesh) -> bool:
    return hasattr(mesh, "mesh_dim_names") and hasattr(mesh, "get_group")


def _as_axis_sizes(mesh_or_sizes) -> dict:
    if _is_device_mesh(mesh_or_sizes):
        return dict(zip(mesh_or_sizes.mesh_dim_names, mesh_or_sizes.mesh.shape))
    return dict(mesh_or_sizes)


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """A mesh (axis-name -> size) bound to a logical-axis rule table.

    ``mesh`` is the ``DeviceMesh`` when the plan was built on one (needed
    by :func:`placements` and the per-rank paths), else ``None``.
    """

    axis_sizes: Mapping[str, int]
    rules: Mapping[str, tuple]
    mesh: Optional[Any] = None

    @classmethod
    def build(cls, mesh, rules: Mapping[str, tuple]) -> "MeshPlan":
        """``mesh`` may be a ``DeviceMesh`` or an axis-size mapping."""
        return cls(
            axis_sizes=_as_axis_sizes(mesh),
            rules=dict(rules),
            mesh=mesh if _is_device_mesh(mesh) else None,
        )

    # ------------------------------------------------------------ resolve

    def axis_size(self, axes) -> int:
        """Product of the sizes of ``axes`` (name, tuple, or None); absent
        axes count as 1."""
        if axes is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        return math.prod(self.axis_sizes.get(a, 1) for a in axes)

    def _filter(self, cand, used: frozenset):
        """Drop absent / already-used axes from a candidate. Returns the
        normalized entry (name, tuple, None, UNCONSTRAINED) or ``"skip"``
        when nothing of the candidate survives."""
        if cand is None or cand is UNCONSTRAINED:
            return cand
        axes = (cand,) if isinstance(cand, str) else tuple(cand)
        kept = tuple(a for a in axes if a in self.axis_sizes and a not in used)
        if not kept:
            return "skip"
        return kept[0] if len(kept) == 1 else kept

    def resolve(self, dim: int, logical: Optional[str], used: frozenset = frozenset()):
        """First rule candidate for ``logical`` that survives filtering and
        divides ``dim``; ``None`` (replicate) when none does."""
        if logical is None:
            return None
        if logical not in self.rules:
            raise KeyError(
                f"unknown logical axis {logical!r}; known: {sorted(self.rules)}"
            )
        for cand in self.rules[logical]:
            ent = self._filter(cand, used)
            if ent == "skip":
                continue
            if ent is UNCONSTRAINED:
                return UNCONSTRAINED
            if ent is None:
                return None
            if dim % self.axis_size(ent) == 0:
                return ent
        return None

    def spec(
        self, shape: Sequence[int], dims: Sequence[Optional[str]], *,
        align: str = "right", protect_leading: bool = False,
    ) -> PartitionSpec:
        """Resolve logical ``dims`` against ``shape`` into a spec.

        ``align="right"`` (weights): dims are right-aligned to the leaf's
        natural trailing rank; extra leading dims (the stacked-layer axis)
        replicate, and ``protect_leading`` forces dim 0 to None even when
        the names are as long as the rank. ``align="left"`` (activations,
        client stacks): dims anchor at dim 0 and extra trailing dims
        replicate.
        """
        shape = tuple(shape)
        ndim = len(shape)
        dims = tuple(dims)
        if align == "right":
            dims = dims[-ndim:] if len(dims) > ndim else dims
            full = (None,) * (ndim - len(dims)) + dims
        elif align == "left":
            dims = dims[:ndim]
            full = dims + (None,) * (ndim - len(dims))
        else:
            raise ValueError(f"align must be 'right' or 'left', got {align!r}")
        used: set = set()
        entries: list = []
        for i, (dim, logical) in enumerate(zip(shape, full)):
            if i == 0 and protect_leading and align == "right":
                entries.append(None)
                continue
            ent = self.resolve(dim, logical, frozenset(used))
            entries.append(ent)
            if ent is not None and ent is not UNCONSTRAINED:
                used.update((ent,) if isinstance(ent, str) else ent)
        return P(*entries)

    def stack(self, spec: PartitionSpec, logical: str, dim: int) -> PartitionSpec:
        """Prepend the resolved axis for ``logical`` (e.g. ``"clients"``)
        to an existing spec."""
        used = frozenset(
            a for ent in spec if ent is not None and ent is not UNCONSTRAINED
            for a in ((ent,) if isinstance(ent, str) else ent)
        )
        return P(self.resolve(dim, logical, used), *spec)

    # ------------------------------------------------------- per rank

    def local_slice(self, spec: PartitionSpec, shape: Sequence[int],
                    coord: Mapping[str, int]) -> tuple:
        """The ``slice`` per tensor dim that the rank at mesh coordinate
        ``coord`` (axis name -> index) holds of a tensor of ``shape`` laid
        out by ``spec``: a dim over axes (a, b) is cut into size(a) *
        size(b) equal blocks, the rank's block being ``coord[a] * size(b)
        + coord[b]`` (major to minor, as JAX's ``NamedSharding`` lays it
        out). Axes absent from ``coord`` count as index 0."""
        out = []
        for i, n in enumerate(shape):
            axes = _entry_axes(spec[i] if i < len(spec) else None)
            parts, block = 1, 0
            for a in axes:
                parts *= self.axis_sizes[a]
                block = block * self.axis_sizes[a] + coord.get(a, 0)
            if n % parts:
                raise ValueError(f"local_slice: dim {i} of {tuple(shape)} does not divide "
                                 f"into {parts} parts ({spec[i]!r})")
            size = n // parts
            out.append(slice(block * size, (block + 1) * size))
        return tuple(out)


def make_plan(
    mesh, *, mode: str = "train", dp_override=None,
    client_axis: Optional[str] = None, overrides: Optional[Mapping] = None,
) -> MeshPlan:
    """Default plan for ``mesh``: the :func:`default_rules` table, with
    ``dp_override`` restricting the FSDP axes and ``overrides`` merging
    caller-specific rules on top."""
    fsdp = tuple(dp_override) if dp_override is not None else ("pod", "data")
    rules = default_rules(mode=mode, fsdp=fsdp, client_axis=client_axis)
    if overrides:
        rules.update(overrides)
    return MeshPlan.build(mesh, rules)


# ------------------------------------------------------- per-rank layout

def placements(spec: PartitionSpec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``:
    ``Shard(d)`` on each mesh dim that tensor dim ``d``'s entry names,
    ``Replicate()`` elsewhere. A tuple entry shards one tensor dim over
    several mesh dims, major to minor (DTensor splits in mesh-dim order,
    so the names must follow the mesh's order, as every plan's do)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, ent in enumerate(spec):
        axes = _entry_axes(ent)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"placements: {ent!r} is not in the mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def mesh_coord(mesh) -> dict:
    """This rank's coordinate on the ``DeviceMesh`` ``mesh``: axis name ->
    index."""
    return {name: mesh.get_local_rank(name) for name in mesh.mesh_dim_names}
