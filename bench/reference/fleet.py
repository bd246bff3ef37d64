"""The fleet's rounds, in plain torch and numpy: what one call of the
program's ``run_compiled(n)`` has to produce.

A round: the rates from the round's normals; the decision of the traffic's
policy (``policy_<name>.py`` beside this file); for each scheduled client,
in channel order, tau SGD steps on minibatches drawn from its own data;
the eq.-4 stochastic quantization of each client's model at its level;
the eq.-2 weighted sum of the dequantized models; the masked moving
averages of G^2, sigma^2 (decay 0.7) and theta; the Lyapunov queues
lambda1 += data_term - eps1, lambda2 += quant_term - eps2, floored at 0;
the test-set accuracy and loss of the new model.

Runs in ``dtype`` on ``device`` (float64 to judge; the control runs it in
float32 with TF32 on). Reads the seed's inputs from ``bench.inputs`` and
the set-up from ``bench.reference.data``; nothing of the program.
"""
from __future__ import annotations

import importlib

import numpy as np
import torch

from bench import inputs
from bench.reference import channel, cnn
from bench.reference.data import FleetData

SLOT_BLOCK = 64     # clients trained at once


def _quantize(flat: torch.Tensor, u: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(S, Z) models, (S, Z) uniforms, (S,) levels -> dequantized (S, Z)."""
    theta = flat.abs().amax(dim=1, keepdim=True)
    levels = (2.0 ** q.to(flat.dtype) - 1.0)[:, None]
    scaled = flat.abs() * levels / torch.where(theta > 0, theta, torch.ones_like(theta))
    low = torch.floor(scaled)
    idx = torch.minimum(low + (u.to(flat.dtype) < scaled - low).to(flat.dtype), levels)
    return torch.where(flat < 0, -idx, idx) * theta / levels


def simulate(cfg: dict, traffic: dict, seed: int, device, dtype=torch.float64,
             follow: dict | None = None, data: FleetData | None = None) -> dict:
    """``traffic["rounds_per_call"]`` rounds from the seed's weights.

    ``follow``: the judged run's outputs ({"q": (N, U), "v": (N, U)}), whose
    ties the decision takes. Returns per-round arrays (energy, accuracy,
    loss, q, v, lambda1, lambda2, n_scheduled), ``ties`` and ``model``
    ({layer: {leaf}} after the last round, float64 on the host)."""
    policy = importlib.import_module(f"bench.reference.policy_{traffic['policy']}")
    m, sysp, tr = cfg["model"], cfg["system"], cfg["train"]
    data = FleetData(cfg) if data is None else data
    u, c = cfg["n_clients"], traffic["n_channels"]
    s_all = min(u, c)
    z = inputs.param_count(m)
    d = data.sizes.astype(np.float64)
    eps1, eps2 = policy.budgets(sysp, d, z, cfg["lyapunov"]["target_q"])
    tx, ty = data.test_set(cfg["data"]["n_test"])
    test_x = torch.from_numpy(tx).to(device, dtype)
    test_y = torch.from_numpy(ty).to(device)
    dist = torch.from_numpy(data.distances).to(device, torch.float64)

    flat = inputs.init_flat(seed, m, device).to(dtype)
    g_sq, s_sq, theta = np.ones(u), np.ones(u), np.ones(u)
    lam1 = lam2 = 0.0
    keys = ("energy", "accuracy", "loss", "q", "v", "lambda1", "lambda2", "n_scheduled")
    out = {k: [] for k in keys}
    ties = 0
    for n in range(traffic["rounds_per_call"]):
        nx, ny = inputs.rate_normals(seed, n, (1, u, c), device)
        rates = channel.rates(nx, ny, dist, cfg["channel"]).cpu().numpy()
        fol = None if follow is None else (follow["q"][n], follow["v"][n])
        dec = policy.decide(rates, d, g_sq / max(g_sq.mean(), 1e-12),
                            s_sq / max(s_sq.mean(), 1e-12), theta, lam2, sysp, z,
                            cfg["lyapunov"]["v_weight"], tr["q_cap"], follow=fol)
        ties += dec["ties"]
        slots = dec["slots"]
        k = len(slots)
        u_batch = inputs.batch_uniforms(seed, n, s_all, sysp["tau"], tr["batch"], device)[:k]
        u_wire = inputs.wire_uniforms(seed, n, s_all, z, z, device)[:k]
        if k:
            rows = inputs.batch_rows(u_batch, torch.from_numpy(data.sizes[slots]).to(device))
            agg = torch.zeros_like(flat)
            w = torch.from_numpy(d[slots] / d[slots].sum()).to(device, dtype)
            theta_s, g_obs, s_obs = [], [], []
            for lo in range(0, k, SLOT_BLOCK):
                ids = slots[lo: lo + SLOT_BLOCK]
                xy = data.clients(ids)
                r = rows[lo: lo + SLOT_BLOCK].cpu().numpy()
                xb = torch.from_numpy(np.stack([x[i] for (x, _), i in zip(xy, r)])).to(device, dtype)
                yb = torch.from_numpy(np.stack([y[i] for (_, y), i in zip(xy, r)])).to(device)
                new, g_b, s_b = cnn.local_sgd(m, inputs.unflatten(flat, m), xb, yb, tr["lr"])
                models = torch.cat([new[a][b].reshape(len(ids), -1)
                                    for a, b, _, _ in inputs.cnn_layout(m)], dim=1)
                theta_s.append(models.abs().amax(dim=1))
                g_obs.append(g_b)
                s_obs.append(s_b)
                q_s = torch.from_numpy(dec["q"][ids]).to(device)
                deq = _quantize(models, u_wire[lo: lo + SLOT_BLOCK], q_s)
                agg += (w[lo: lo + SLOT_BLOCK, None] * deq).sum(dim=0)
            flat = agg
            theta_s, g_obs, s_obs = (torch.cat(t).double().cpu().numpy()
                                     for t in (theta_s, g_obs, s_obs))
            g_sq[slots] = 0.7 * g_sq[slots] + 0.3 * np.maximum(g_obs, 0.0)
            s_sq[slots] = 0.7 * s_sq[slots] + 0.3 * np.maximum(s_obs, 1e-8)
            theta[slots] = theta_s
        lam1 = max(lam1 + dec["data_term"] - eps1, 0.0)
        lam2 = max(lam2 + dec["quant_term"] - eps2, 0.0)
        acc, loss = cnn.evaluate(m, inputs.unflatten(flat, m), test_x, test_y)
        for key, val in (("energy", dec["energy"].sum()), ("accuracy", acc), ("loss", loss),
                         ("q", dec["q"]), ("v", dec["v"]), ("lambda1", lam1),
                         ("lambda2", lam2), ("n_scheduled", k)):
            out[key].append(val)
    res = {k: np.asarray(v) for k, v in out.items()}
    res["ties"] = ties
    res["model"] = {a: {b: t.double().cpu() for b, t in leaves.items()}
                    for a, leaves in inputs.unflatten(flat, m).items()}
    return res

