"""npz-based tree checkpointing (the port's copy of ``repro.ckpt.checkpoint``,
the same on-disk layout, so either package reads the other's files).

Layout: ``<dir>/step_<N>.npz`` holding flattened leaves keyed by path,
plus a JSON sidecar ``step_<N>.npz.json`` with the leaf paths, each
leaf's shape/dtype, and caller metadata.

Write protocol (crash-safe): the npz is written to a temp file and
``os.replace``d into place FIRST, then the sidecar the same way. A crash
mid-save therefore leaves either nothing, a stray ``.tmp`` file, or an
npz without its sidecar; :func:`latest_step` skips all three, so a
resumer always lands on the last COMPLETE step. :func:`load_checkpoint`
validates the sidecar against the npz (key set, per-leaf shape and dtype)
and raises :class:`CheckpointError` on any mismatch or unreadable file.
Leaves are numpy arrays or tensors (copied to the host); a tree is nested
dicts.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Optional

import numpy as np
import torch

Tree = Any


class CheckpointError(RuntimeError):
    """A checkpoint on disk is unreadable, incomplete, or inconsistent
    with its sidecar (or with what the resumer expects)."""


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten_with_paths(tree: Tree, prefix: str = "") -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten_with_paths(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    out[prefix] = _host(tree)
    return out


def _unflatten(flat: dict[str, np.ndarray]) -> Tree:
    root: dict = {}
    for path, arr in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return root


def _atomic_write(directory: str, path: str, writer) -> None:
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            writer(f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def save_checkpoint(directory: str, step: int, params: Tree,
                    extra: Optional[dict] = None) -> str:
    os.makedirs(directory, exist_ok=True)
    flat = _flatten_with_paths(params)
    path = os.path.join(directory, f"step_{step:08d}.npz")
    meta = {
        "step": step,
        "keys": sorted(flat),
        "arrays": {k: {"shape": list(flat[k].shape), "dtype": str(flat[k].dtype)}
                   for k in sorted(flat)},
        **(extra or {}),
    }
    # npz first, sidecar second (both atomic): an incomplete save is an
    # npz without a sidecar, which latest_step skips.
    _atomic_write(directory, path, lambda f: np.savez(f, **flat))
    _atomic_write(directory, path + ".json", lambda f: f.write(json.dumps(meta).encode()))
    return path


def latest_step(directory: str) -> Optional[int]:
    """Largest step with a COMPLETE checkpoint: both the npz and its JSON
    sidecar present."""
    if not os.path.isdir(directory):
        return None
    steps = [
        int(f[len("step_"):-len(".npz")])
        for f in os.listdir(directory)
        if f.startswith("step_") and f.endswith(".npz")
        and os.path.exists(os.path.join(directory, f + ".json"))
    ]
    return max(steps) if steps else None


def load_checkpoint(directory: str, step: Optional[int] = None) -> tuple[Tree, dict]:
    """(tree of numpy arrays, sidecar metadata) of ``step``, by default the
    latest complete one."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:08d}.npz")
    try:
        with np.load(path) as data:
            flat = {k: data[k] for k in data.files}
    except FileNotFoundError:
        raise
    except Exception as e:  # truncated / corrupted npz
        raise CheckpointError(f"unreadable checkpoint {path}: {e}") from e
    try:
        with open(path + ".json") as f:
            meta = json.load(f)
    except FileNotFoundError as e:
        raise CheckpointError(f"checkpoint {path} has no sidecar (incomplete save?)") from e
    except (json.JSONDecodeError, OSError) as e:
        raise CheckpointError(f"unreadable sidecar {path}.json: {e}") from e

    keys = meta.get("keys")
    if keys is not None and sorted(keys) != sorted(flat):
        raise CheckpointError(
            f"checkpoint {path}: sidecar keys {sorted(keys)} != npz keys {sorted(flat)}")
    for k, spec in (meta.get("arrays") or {}).items():
        if k not in flat:
            raise CheckpointError(f"checkpoint {path}: sidecar lists missing leaf {k!r}")
        arr = flat[k]
        if list(arr.shape) != list(spec.get("shape", [])):
            raise CheckpointError(
                f"checkpoint {path}: leaf {k!r} shape {list(arr.shape)} != "
                f"sidecar {spec.get('shape')}")
        if str(arr.dtype) != spec.get("dtype"):
            raise CheckpointError(
                f"checkpoint {path}: leaf {k!r} dtype {arr.dtype} != "
                f"sidecar {spec.get('dtype')}")
    return _unflatten(flat), meta
