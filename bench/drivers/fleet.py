"""The fleet driver: the paper's CNN tasks on the program's fleet engine.

The program under test is ``repro_torch`` (``src/`` of the checkout): a
fleet built by ``repro_torch.sim.build_sim`` in set-up, driven in the
window by back-to-back calls of ``FleetSim.run_compiled(rounds_per_call)``
and judged against ``bench.reference.fleet`` in float64.
"""
from __future__ import annotations

import importlib
from pathlib import Path

import numpy as np
import torch

from bench import check, inputs
from bench.counts.cnn_flops import round_flops  # noqa: F401 (read by metrics/round_mfu)
from bench.reference import fleet
from bench.reference.data import FleetData

BENCH = Path(__file__).resolve().parents[1]
# the configurations state float32 with TF32 off
FLOP_PEAK = "fp32_flop_per_s"


class BenchEntropy:
    """The program's entropy seam (``repro_torch.sim.entropy``), fed from
    ``bench.inputs``: every draw keyed by (seed, round, kind)."""

    def __init__(self, seed: int, z: int, device) -> None:
        self.seed, self.z, self.device = int(seed), int(z), device

    def rates(self, ridx, channel):
        from repro_torch.sim.channel import draw_rates

        nx, ny = inputs.rate_normals(self.seed, ridx, channel.shape, self.device)
        return draw_rates(nx, ny, channel.params, channel.distances, channel.association)

    def batch_indices(self, ridx, n_s, tau, batch_size):
        u = inputs.batch_uniforms(self.seed, ridx, n_s.shape[0], tau, batch_size, self.device)
        return inputs.batch_rows(u, n_s)

    def uniforms(self, ridx, s, zpad):
        return inputs.wire_uniforms(self.seed, ridx, s, self.z, zpad, self.device)


def build(spec: dict, seed: int, device):
    """The fleet: its data from the configuration's data seed, its weights
    made on ``device`` from the run's seed, every draw of a round from the
    run's seed."""
    from repro_torch.sim import build_sim

    cfg, traffic = spec["config"], spec["traffic"]
    model = cfg["model"]
    flat = inputs.init_flat(seed, model, device)
    params = {a: {b: t.clone() for b, t in leaves.items()}
              for a, leaves in inputs.unflatten(flat, model).items()}
    return build_sim(
        cfg["task"], scenario=cfg["scenario"], n_clients=cfg["n_clients"],
        n_channels=traffic["n_channels"], mu=cfg["data"]["mu"], beta=cfg["data"]["beta"],
        lr=cfg["train"]["lr"], seed=cfg["data"]["seed"], batch_size=cfg["train"]["batch"],
        q_cap=cfg["train"]["q_cap"], n_test=cfg["data"]["n_test"],
        alpha_dirichlet=cfg["data"]["alpha_dirichlet"],
        v_weight=cfg["lyapunov"]["v_weight"], target_q=cfg["lyapunov"]["target_q"],
        policy_mode=traffic["policy"], init_params=params, device=device,
        entropy=BenchEntropy(seed, inputs.param_count(model), device),
    )


def rounds_per_call(traffic: dict) -> int:
    return traffic["rounds_per_call"]


def call(sim, traffic: dict):
    """One call of the timed entry; its results are on the host on return."""
    return sim.run_compiled(traffic["rounds_per_call"], with_eval=traffic["eval"])


def warm(sim, traffic: dict) -> None:
    """One round of the timed entry: every shape a call uses (each round
    has the same shapes), every kernel built and loaded. It replaces
    ``final_flat``: take a call's outputs first."""
    sim.run_compiled(1, with_eval=traffic["eval"])


def failed(res) -> int:
    """Rounds whose energy, test loss or a Lyapunov queue is not finite."""
    bad = ~(np.isfinite(res.energy) & np.isfinite(res.loss) & np.isfinite(res.lambda1)
            & np.isfinite(res.lambda2))
    return int(np.sum(bad))


def outputs(sim, res) -> dict:
    """The call's results in the reference's terms."""
    model = sim.unravel(sim.final_flat)
    return {
        "energy": res.energy, "accuracy": res.accuracy, "loss": res.loss,
        "q": np.asarray(res.q_levels), "v": np.asarray(res.rates),
        "lambda1": res.lambda1, "lambda2": res.lambda2,
        "n_scheduled": np.asarray(res.n_scheduled),
        "model": {a: {b: t.detach().double().cpu().numpy() for b, t in leaves.items()}
                  for a, leaves in model.items()},
    }


def judge(spec: dict, seed: int, run: dict, device, data=None) -> tuple[dict, dict]:
    """(compared numbers, raw readings) of a call's outputs against the
    plain reference in float64, computed after the program's state is
    freed. ``data``: the reference's ``FleetData``, to judge several runs
    of one configuration without making it again."""
    cfg = spec["config"]
    data = FleetData(cfg) if data is None else data
    ref = fleet.simulate(cfg, spec["traffic"], seed, device, torch.float64,
                         follow={"q": run["q"], "v": run["v"]}, data=data)
    policy = importlib.import_module(f"bench.reference.policy_{spec['traffic']['policy']}")
    eps2 = policy.budgets(cfg["system"], data.sizes.astype(np.float64),
                          inputs.param_count(cfg["model"]), cfg["lyapunov"]["target_q"])[1]
    raw = check.readings(run, ref, eps2)
    return check.numbers(raw, spec["limits"]), raw


def check_files(spec: dict) -> None:
    """What a fleet cell's files must hold beyond what every cell's do."""
    cfg, traffic, limits = spec["config"], spec["traffic"], spec["limits"]
    missing = {"policy", "n_channels", "rounds_per_call", "eval"} - set(traffic)
    if missing:
        raise ValueError(f"the traffic mix lacks {sorted(missing)}")
    if not (BENCH / "reference" / f"policy_{traffic['policy']}.py").is_file():
        raise ValueError(f"no plain reference of the policy {traffic['policy']!r}")
    if set(limits["limits"]) != {"rounds_off", "loss_err", "model_err", "below_precision"}:
        raise ValueError(f"the limits name {sorted(limits['limits'])}")
    if set(limits["tolerances"]) != {"v_err", "energy_err", "lambda1_err", "lambda2_err"}:
        raise ValueError(f"the tolerances name {sorted(limits['tolerances'])}")
    if inputs.param_count(cfg["model"]) != cfg["z"]:
        raise ValueError(f"the model has {inputs.param_count(cfg['model'])} parameters, "
                         f"the file states {cfg['z']}")
