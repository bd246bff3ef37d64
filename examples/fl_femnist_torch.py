"""End-to-end example on the PyTorch port (paper Fig. 3 setting, the twin of
``examples/fl_femnist.py``): QCCF vs all four baselines on the FEMNIST
proxy (28x28x1, 62 classes, Z = 246590 — the paper's exact model size),
D_i ~ N(1200, beta).

    PYTHONPATH=src python examples/fl_femnist_torch.py [--rounds 60] [--beta 150]
    PYTHONPATH=src python examples/fl_femnist_torch.py --device cpu --rounds 3

60 rounds x tau=6 local updates x 10 clients ~ 3.6k local SGD steps.
Without ``--device`` it runs on ``cuda`` and stops if there is no GPU.
"""
import argparse
import sys

sys.path.insert(0, "src")

from repro_torch.fl import run_policy


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--beta", type=float, default=150.0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--policies", nargs="*", default=[
        "qccf", "no_quant", "channel_allocate", "principle_24", "same_size_26",
    ])
    args = ap.parse_args()

    results = {}
    for pol in args.policies:
        print(f"=== {pol} ===", flush=True)
        res = run_policy(pol, task="femnist", beta=args.beta,
                         n_rounds=args.rounds, seed=1, device=args.device)
        results[pol] = res.summary()
        print(results[pol], flush=True)

    print("\n== comparison ==")
    e_qccf = results.get("qccf", {}).get("total_energy_J", 0.0)
    for pol, s in results.items():
        red = 100 * (1 - e_qccf / s["total_energy_J"]) if s["total_energy_J"] else 0
        print(
            f"{pol:18s} acc={s['final_accuracy']:.3f} "
            f"E={s['total_energy_J']:.4f} J "
            + (f"(QCCF saves {red:.1f}%)" if pol != "qccf" else "")
        )


if __name__ == "__main__":
    main()
