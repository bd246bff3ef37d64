"""The model-round driver: a language model's federated round on the
program's training path.

The program under test is ``repro_torch`` (``src/`` of the checkout): the
configuration's architecture from ``repro_torch.configs``, cut as its file
says (layers, experts held, vocabulary), its weights made on the card by
``models.model.init_params`` from the run's seed, and every call one QCCF
round of ``launch.steps.make_fl_round``: K clients each take one local SGD
step from the previous aggregate on their own sequences, upload their
eq.-4 wire at their level, and the server takes the eq.-2 sum, which is
the next round's start. Every round runs inside
``repro_torch.device.exact_fp32``.

Inputs, all from ``bench.inputs``' keyed generators: the weights from
(seed, 0, "init"); round r's token ids, (K, B, S + 1) uniform over the
vocabulary the chip holds, from (seed, r, "batch"); round r's wire
uniforms from (seed, r, "wire"), drawn by the program client after client,
leaf after leaf in sorted-key order.

The judge replays the last timed call after the window, on the card: the
plain reference (``bench.reference.granite_hybrid``, float32, TF32 off,
a layer at a time) takes each client's step from the same start model on
the same tokens, quantizes it with the same uniforms and sums the same
eq.-2 terms (in float64). Compared numbers (``limits/<workload>.json``):

- ``loss_err``: the mean local loss, relative;
- ``theta_err``: the largest relative gap of a client's range theta_max,k
  (at this cell's init a fixed leaf sets it, so it reads 0 where the
  program runs at all);
- ``model_err``: the norm of the gap between the two aggregates over the
  norm of the reference's (it sees a client's update only where an eq.-4
  index flips, the step being some 10^5 times an update);
- ``grad_err``: each client's gradient leaf by leaf, read in the timed
  call (``make_fl_round``'s ``grad_norm``, on the device): the largest
  relative gap, over clients and leaves, between the program's gradient
  norm and the reference's; a leaf whose gradient is lost reads 1;
- ``update_err``: the step each client took, read in the timed call
  (``update_norm``): the largest relative gap, over clients, between the
  norm of the program's new - start over the whole model and the
  reference's ``(p - lr g) - p``; a client that uploads its start reads
  1. Whole, not by leaf: at lr 1e-3 most of a small leaf's lr g is under
  half an ulp of p, so its step is a few ulps or none, on both sides;
- ``routed_off``: the (token, pick) slots the program's experts computed
  that the reference's routing does not send them, or the reverse: the
  sum over clients and layers of the gap between the program's counter of
  slots on the held experts and the reference's count. At random weights
  a layer's output is a small part of the residual stream, so a change
  inside a layer moves the loss little and the aggregate less (eq. 4's
  step, theta_max / (2^q - 1), is some 10^5 times a step's update); it
  does move the later layers' routers, whose top-k picks at near ties
  flip;
- ``below_precision``: the device kernels of one round whose names mark
  math below the stated precision.

Readings beside them: ``wire_off`` (the aggregate's coordinates that sit
a level or more apart: a client's eq.-4 index that differs), the leaf
``grad_err`` reads (``grad_worst``), the losses,
the ranges, and the program's counters (each client's routed slots on the
held experts and the largest held expert's load, by layer) beside the
reference's counts.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from pathlib import Path

import numpy as np
import torch

from bench import inputs
from bench.counts.model_flops import param_count, round_flops  # noqa: F401 (metrics/round_mfu)
from bench.reference import granite_hybrid as reference

BENCH = Path(__file__).resolve().parents[1]
FLOP_PEAK = "fp32_flop_per_s"
# a call's record of its counters in a profiler trace (metrics/_grouped.py):
# an empty range named "<ROUTED> <slots> <client layers>"
ROUTED = "routed_slots"

WIDTHS = {  # the configuration file's key -> the program's config field
    "hidden_size": "d_model", "num_attention_heads": "n_heads",
    "num_key_value_heads": "n_kv_heads", "intermediate_size": "d_ff",
    "shared_intermediate_size": "shared_ff", "num_experts_per_tok": "top_k",
    "router_experts": "n_experts", "mamba_d_state": "ssm_state", "mamba_d_head": "ssm_head_dim",
    "mamba_n_heads": "n_ssm_heads", "mamba_chunk_size": "chunk_size", "rms_norm_eps": "norm_eps",
    "embedding_multiplier": "embedding_multiplier",
    "residual_multiplier": "residual_multiplier",
    "attention_multiplier": "attention_multiplier", "logits_scaling": "logits_scaling",
    "mamba_conv_bias": "conv_bias", "tie_word_embeddings": "tie_embeddings",
}
TRAFFIC_KEYS = {"clients", "seq_len", "batch_per_client", "q_bits", "dataset_sizes",
                "wire_packed", "downlink", "rounds_per_call", "lr"}
LIMITS = {"loss_err", "theta_err", "model_err", "grad_err", "update_err", "routed_off",
          "below_precision"}


def program_config(cfg: dict):
    """The program's configuration of the file's architecture, cut as the
    file says, float32 activations; every width checked against the file."""
    from repro_torch.configs import get_config

    base = get_config(cfg["arch"])
    out = dataclasses.replace(base, n_layers=cfg["num_hidden_layers"], vocab=cfg["vocab_size"],
                              experts_held=tuple(cfg["experts_held"]), dtype="float32")
    off = {k: (cfg[k], getattr(out, f)) for k, f in WIDTHS.items() if cfg[k] != getattr(out, f)}
    if off or list(out.kinds) != cfg["layer_types"][:cfg["num_hidden_layers"]]:
        raise ValueError(f"the program's {cfg['arch']} differs from the file: {off}")
    return out


def weights(traffic: dict) -> list[float]:
    """Eq. 2's w_k = D_k / sum D."""
    sizes = traffic["dataset_sizes"]
    return [s / sum(sizes) for s in sizes]


def round_batch(cfg: dict, traffic: dict, seed: int, ridx: int, device) -> dict:
    """Round ``ridx``'s (K, B, S) tokens, next-token labels and mask."""
    k, b, s = traffic["clients"], traffic["batch_per_client"], traffic["seq_len"]
    seq = torch.randint(0, cfg["vocab_size"], (k, b, s + 1), device=device,
                        generator=inputs.generator(seed, ridx, "batch", device))
    return {"tokens": seq[..., :-1], "labels": seq[..., 1:],
            "mask": torch.ones((k, b, s), device=device)}


def build(spec: dict, seed: int, device):
    from repro_torch.launch import steps
    from repro_torch.models import model

    cfg, traffic = spec["config"], spec["traffic"]
    mcfg = program_config(cfg)
    params = model.init_params(mcfg, seed=inputs.draw_key(seed, 0, "init"), device=device,
                               param_dtype=torch.float32)
    return {
        "spec": spec, "seed": seed, "device": device, "agg": params, "round": 0,
        "fl_round": steps.make_fl_round(mcfg, lr=traffic["lr"],
                                        wire_packed=traffic["wire_packed"],
                                        downlink=traffic["downlink"]),
        "q": torch.tensor(traffic["q_bits"], device=device),
        "w": torch.tensor(weights(traffic), dtype=torch.float32, device=device),
    }


def rounds_per_call(traffic: dict) -> int:
    return 1


def call(state: dict, traffic: dict) -> dict:
    """One round from the previous aggregate; its loss, ranges and counters
    on the host on return."""
    from repro_torch import device as rdevice
    from repro_torch import tree as tree_util
    from repro_torch.obs.profile import scope

    cfg, seed, dev = state["spec"]["config"], state["seed"], state["device"]
    ridx = state["round"]
    k = traffic["clients"]
    batch = round_batch(cfg, traffic, seed, ridx, dev)
    stacked = tree_util.map(lambda t: t[None].expand((k,) + tuple(t.shape)), state["agg"])
    metrics = []
    with rdevice.exact_fp32():
        out, loss, theta_max = state["fl_round"](
            stacked, batch, state["q"], state["w"], client_metrics=metrics,
            generator=inputs.generator(seed, ridx, "wire", dev))
    del stacked
    state["start"], state["agg"] = state["agg"], tree_util.map(lambda t: t[0], out)
    state["last"], state["round"] = ridx, ridx + 1
    with scope("results_to_host"):
        host = torch.cat([loss.reshape(1), theta_max.reshape(-1)]
                         + [m["moe_routed"] for m in metrics]
                         + [m["moe_max_load"] for m in metrics]
                         + [m["grad_norm"] for m in metrics]
                         + [m["update_norm"] for m in metrics]).double().cpu().numpy()
    n_layers = metrics[0]["moe_routed"].shape[0]
    at = 1 + k + 2 * k * n_layers
    routed = host[1 + k:1 + k + k * n_layers].reshape(k, n_layers)
    with scope(f"{ROUTED} {routed.sum():.0f} {k * n_layers}"):
        pass
    return {"loss": host[0], "theta_max": host[1:1 + k], "routed": routed,
            "max_load": host[1 + k + k * n_layers:at].reshape(k, n_layers),
            "grad_norm": host[at:].reshape(2, k, -1)[0],
            "update_norm": host[at:].reshape(2, k, -1)[1]}


def warm(state: dict, traffic: dict) -> None:
    """One round: every shape a call uses, every kernel built and loaded.
    It advances the round: take a call's outputs first."""
    call(state, traffic)


def failed(res: dict) -> int:
    return int(not (np.isfinite(res["loss"]) and np.all(np.isfinite(res["theta_max"]))))


def outputs(state: dict, res: dict) -> dict:
    """The last call's start model, aggregate and results, the models
    copied to the host (the card's memory goes to the reference)."""
    from repro_torch import tree as tree_util

    host = lambda tree: tree_util.map(lambda t: t.detach().to("cpu"), tree)  # noqa: E731
    return {"start": host(state["start"]), "agg": host(state["agg"]), "round": state["last"],
            "loss": float(res["loss"]), "theta_max": np.asarray(res["theta_max"]),
            "routed": res["routed"], "max_load": res["max_load"],
            "grad_norm": res["grad_norm"], "update_norm": res["update_norm"]}


def _leaves(tree: dict, prefix=()):
    """(path, leaf) in sorted-key order: the order of the wire's draws."""
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _leaves(tree[key], prefix + (key,))
        else:
            yield prefix + (key,), tree[key]


@contextlib.contextmanager
def _tf32():
    """TF32 on for matrix products and convolutions, the flags restored."""
    mm, cd = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = mm, cd


def reference_round(spec: dict, seed: int, start: dict, ridx: int, device,
                    tf32: bool = False) -> dict:
    """The reference's round ``ridx`` from ``start``: each client's loss,
    range, each leaf's gradient norm and norm of its step, and the eq.-2
    aggregate in float64 (a leaf list, sorted-key order). ``tf32``: the reference
    computed with TF32 on (the precision below the configuration's)."""
    cfg, traffic = spec["config"], spec["traffic"]
    params = {}
    for path, leaf in _leaves(start):
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf.to(device)
    batch = round_batch(cfg, traffic, seed, ridx, device)
    gen = inputs.generator(seed, ridx, "wire", device)
    w = weights(traffic)
    agg, losses, tmaxes, routed, grad_norms, updates = None, [], [], [], [], []
    for k, q in enumerate(traffic["q_bits"]):
        counts = []
        with _tf32() if tf32 else reference.no_tf32():
            loss, grads = reference.loss_and_grads(params, cfg, batch["tokens"][k],
                                                   batch["labels"][k], counts)
        routed.append(counts)
        grad_norms.append([float(torch.linalg.vector_norm(g)) for _, g in _leaves(grads)])
        new = [p - traffic["lr"] * g for (_, p), (_, g) in zip(_leaves(params), _leaves(grads))]
        del grads
        updates.append([float(torch.linalg.vector_norm(t - p))
                        for t, (_, p) in zip(new, _leaves(params))])
        tmax = torch.stack([t.abs().max() for t in new]).max()
        levels = 2.0 ** min(q, 8) - 1.0
        coef = w[k] * tmax.double() / levels
        terms = []
        for t in new:
            u = torch.rand(t.shape, generator=gen, device=device, dtype=torch.float32)
            scaled = t.abs() * (levels / tmax)
            idx = torch.minimum(torch.floor(scaled) + (u < scaled - torch.floor(scaled)).float(),
                                torch.tensor(levels, device=device))
            terms.append(coef * torch.where(t < 0, -idx, idx).double())
            del u, scaled, idx
        agg = terms if agg is None else [a + b for a, b in zip(agg, terms)]
        del new, terms
        losses.append(float(loss))
        tmaxes.append(float(tmax))
    return {"agg": agg, "loss": np.asarray(losses), "theta_max": np.asarray(tmaxes),
            "routed": np.asarray(routed, dtype=np.float64),
            "grad_norm": np.asarray(grad_norms), "update_norm": np.asarray(updates),
            "paths": [p for p, _ in _leaves(params)]}


def compare(run: dict, ref: dict, steps: list[float]) -> dict:
    """Raw readings of a run's outputs against the reference's round;
    ``steps``: each client's eq.-2 step w_k theta_max,k / (2^q_k - 1)."""
    gap = norm = 0.0
    off = 0
    half = 0.5 * min(steps)
    for (_, a), b in zip(_leaves(run["agg"]), ref["agg"]):
        d = a.to(b.device).double() - b
        gap += float((d * d).sum())
        norm += float((b * b).sum())
        off += int((d.abs() > half).sum())
    loss_ref = float(ref["loss"].mean())
    want = ref["grad_norm"]
    # a leaf whose reference gradient is 0 reads the program's over 1e-30
    grad = np.abs(np.asarray(run["grad_norm"]) - want) / np.maximum(want, 1e-30)
    worst = np.unravel_index(np.argmax(grad), grad.shape)
    step, step_ref = (np.sqrt((np.asarray(u) ** 2).sum(-1))
                      for u in (run["update_norm"], ref["update_norm"]))
    return {
        "loss_err": abs(run["loss"] - loss_ref) / abs(loss_ref),
        "theta_err": float(np.max(np.abs(run["theta_max"] - ref["theta_max"])
                                  / ref["theta_max"])),
        "model_err": math.sqrt(gap / norm),
        "grad_err": float(grad[worst]),
        "update_err": float(np.max(np.abs(step - step_ref) / step_ref)),
        "routed_off": float(np.abs(np.asarray(run["routed"]) - ref["routed"]).sum()),
        "below_precision": int(run["below_precision"]),
        "wire_off": off,
        "grad_worst": f"client {worst[0]} {'/'.join(ref['paths'][worst[1]])}",
        "loss": run["loss"], "loss_ref": loss_ref,
        "theta_max": run["theta_max"], "theta_max_ref": ref["theta_max"],
        "routed": run["routed"], "routed_ref": ref["routed"], "max_load": run["max_load"],
    }


def judge(spec: dict, seed: int, run: dict, device, tf32_reference: bool = False
          ) -> tuple[dict, dict]:
    """(compared numbers, raw readings) of the last call against the
    reference's replay of its round."""
    ref = reference_round(spec, seed, run["start"], run["round"], device, tf32_reference)
    traffic = spec["traffic"]
    w = weights(traffic)
    steps = [w[k] * ref["theta_max"][k] / (2.0 ** min(q, 8) - 1.0)
             for k, q in enumerate(traffic["q_bits"])]
    raw = compare(run, ref, steps)
    lim = spec["limits"]["limits"]
    return {k: {"value": float(raw[k]), "limit": lim[k]} for k in lim}, raw


def check_files(spec: dict) -> None:
    """What a model-round cell's files must hold beyond what every cell's do."""
    cfg, traffic, limits = spec["config"], spec["traffic"], spec["limits"]
    missing = TRAFFIC_KEYS - set(traffic)
    if missing:
        raise ValueError(f"the traffic mix lacks {sorted(missing)}")
    k = traffic["clients"]
    if len(traffic["q_bits"]) != k or len(traffic["dataset_sizes"]) != k:
        raise ValueError("the traffic mix needs a level and a dataset size per client")
    if not all(1 <= q <= 8 for q in traffic["q_bits"]) and traffic["wire_packed"]:
        raise ValueError(f"the u8 wire takes levels 1..8, got {traffic['q_bits']}")
    if traffic["rounds_per_call"] != 1:
        raise ValueError("a model-round call is one round")
    if set(limits["limits"]) != LIMITS:
        raise ValueError(f"the limits name {sorted(limits['limits'])}")
    lo, hi = cfg["experts_held"]
    if not (0 <= lo < hi <= cfg["router_experts"]) or hi - lo != cfg["num_local_experts"]:
        raise ValueError(f"experts held {cfg['experts_held']} are not num_local_experts "
                         f"{cfg['num_local_experts']} of {cfg['router_experts']}")
    if cfg["published"]["num_local_experts"] != cfg["router_experts"]:
        raise ValueError("the router's outputs are the published experts")
    if set(cfg["reduced"]) != set(cfg["published"]):
        raise ValueError(f"reduced {cfg['reduced']} is not what the file states as cut")
    if len(cfg["layer_types"]) != cfg["published"]["num_hidden_layers"]:
        raise ValueError("layer_types is the published pattern, whole")
    if param_count(cfg) != cfg["params_held"]:
        raise ValueError(f"the widths give {param_count(cfg)} parameters, "
                         f"the file states {cfg['params_held']}")
