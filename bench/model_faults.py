"""Controls of the model-round cell's check (``drivers/model_round.py``):
each a context manager under which the program computes something other
than the configuration states, which the check must refuse.

- ``tf32``: the round's matrix products and convolutions in TF32;
- ``bf16_autocast``: the round under ``torch.autocast`` to bf16;
- ``capacity_route``: the held experts take the capacity route of the
  other MoE configurations (``moe.moe_apply``, factor 1.25), which drops
  the slots past each expert's queue;
- ``no_shared_expert``: the shared expert left out;
- ``rope``: RoPE applied to the attention mixers' queries and keys;
- ``router_frozen``: the routers' gradients zeroed, so a client's step
  leaves its routers as they were (what a lost gradient of the gates does);
- ``state_unchanged``: every gradient zeroed, so a client uploads its
  start model.
"""
from __future__ import annotations

import contextlib
from unittest import mock


@contextlib.contextmanager
def _round_scope(inner):
    """The driver's ``exact_fp32`` scope with ``inner()`` entered inside it."""
    from repro_torch import device

    real = device.exact_fp32

    @contextlib.contextmanager
    def scope():
        with real(), inner():
            yield

    with mock.patch.object(device, "exact_fp32", scope):
        yield


@contextlib.contextmanager
def _tf32_on():
    import torch

    mm, cd = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = mm, cd


def tf32():
    return _round_scope(_tf32_on)


def bf16_autocast():
    import torch

    return _round_scope(lambda: torch.autocast("cuda", dtype=torch.bfloat16))


@contextlib.contextmanager
def capacity_route():
    import torch
    from repro_torch.models import moe

    def capacity(params, x, *, top_k, held):
        """The capacity route's output and its held experts' kept slots."""
        out, _ = moe.moe_apply(params, x, top_k=top_k, capacity_factor=1.25,
                               route=moe.ExpertSlots(*held))
        b, s, _d = x.shape
        g = moe.group_length(s)
        cap = moe.group_capacity(g, top_k, params["router"].shape[-1], 1.25)
        kept = 0
        for c0 in range(0, s, g):
            rt = moe._route(params, x[:, c0:c0 + g], top_k)
            keepf = moe._slots(rt, cap)[1]
            kept = kept + (rt.sel * keepf[..., None]).sum(dim=(0, 1, 2))[held[0]:held[1]]
        return out, kept

    with mock.patch.object(moe, "dropless_apply", capacity):
        yield


@contextlib.contextmanager
def no_shared_expert():
    import torch
    from repro_torch.models import model

    with mock.patch.object(model, "shared_expert", lambda p, x: torch.zeros_like(x)):
        yield


@contextlib.contextmanager
def rope():
    import torch
    from repro_torch.models import layers, model

    real = model._attend

    def with_rope(cfg, q, k, v, **kw):
        pos = torch.arange(q.shape[1], device=q.device)
        return real(cfg, layers.apply_rope(q, pos, cfg.rope_theta),
                    layers.apply_rope(k, pos, cfg.rope_theta), v, **kw)

    with mock.patch.object(model, "_attend", with_rope):
        yield


@contextlib.contextmanager
def _grads_zeroed(zeroed):
    """A client's gradient with the leaves whose key path ``zeroed(path)``
    accepts set to 0."""
    import torch
    from repro_torch import tree as tree_util
    from repro_torch.launch import steps

    real = steps.value_and_grad

    def value_and_grad(cfg, params, batch, **kw):
        loss, metrics, grads = real(cfg, params, batch, **kw)
        paths = tree_util.paths(grads)
        leaves = [torch.zeros_like(g) if zeroed(p) else g
                  for p, g in zip(paths, tree_util.leaves(grads))]
        return loss, metrics, tree_util.from_leaves(paths, leaves)

    with mock.patch.object(steps, "value_and_grad", value_and_grad):
        yield


def router_frozen():
    return _grads_zeroed(lambda path: "router" in path)


def state_unchanged():
    return _grads_zeroed(lambda path: True)


FAULTS = {"tf32": tf32, "bf16_autocast": bf16_autocast, "capacity_route": capacity_route,
          "no_shared_expert": no_shared_expert, "rope": rope, "router_frozen": router_frozen,
          "state_unchanged": state_unchanged}
