"""Quickstart on the PyTorch port: 30 rounds of QCCF wireless FL on the
tiny synthetic task (the twin of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/quickstart_torch.py               # on the GPU
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

Shows the full paper pipeline: channel draws -> GA scheduling -> KKT
closed-form (q, f) -> local SGD -> stochastic quantization -> weighted
aggregation -> Lyapunov queue update, with live energy/accuracy printout.
Without ``--device`` it runs on ``cuda`` and stops if there is no GPU.
"""
import argparse
import sys

sys.path.insert(0, "src")

from repro_torch.fl import build_experiment


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    exp = build_experiment("qccf", task="tiny", n_clients=10, beta=40.0, seed=0,
                           device=args.device)
    print(f"device: {exp.device}")
    print(f"clients: {[c.d_size for c in exp.clients]}")
    print(f"model dim Z = {exp.z}")
    res = exp.run(n_rounds=30, eval_every=3, verbose=True)
    s = res.summary()
    print("\nsummary:", s)
    print(
        f"energy per round: {s['total_energy_J'] / s['rounds'] * 1e3:.3f} mJ, "
        f"final accuracy {s['final_accuracy']:.3f}"
    )


if __name__ == "__main__":
    main()
