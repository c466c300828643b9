"""Convergence per cost class (JAX scripts/cost_function_comparison.py, the
reference's cost_function_comparison.ipynb): a SWAP target, the k = 3
sqiSwap template, 8 restarts, one ``TemplateOptimizer`` per cost class and
engine: Adam + LM with its loss history (``use_callback=True``:
``training_history`` / ``training_history_lm``) and L-BFGS
(``method="lbfgs"``, final loss only).

    python3 -m slam_decomposition_torch.tools.cost_function_comparison [--restarts 8] [--lbfgs-iters 400]
        [--classes basic square makhlin_functional square_reduced] [--device cuda|cpu]

Prints the table and saves the figure to
``config.studies_dir()/figures/cost_function_comparison.png`` (where
matplotlib is installed) and its data to ``cost_function_comparison.json``
beside ``figures/``; the exact-unitary classes must certify (the script's
closing check).
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from slam_decomposition_torch.config import DEFAULT_DEVICE, resolve_device
from slam_decomposition_torch.tools import no_figure, pyplot, save_figure, synchronize, write_json

# the reference pair (BasicCost, MakhlinFunctionalCost) and the other member
# of each family: exact-unitary costs beside local-equivalence-class costs
CLASSES = ["basic", "square", "makhlin_functional", "square_reduced"]
SWAP = np.zeros((4, 4), complex)
SWAP[0, 0] = SWAP[3, 3] = SWAP[1, 2] = SWAP[2, 1] = 1.0


def compare(classes=CLASSES, restarts: int = 8, lbfgs_iters: int = 400, device=DEFAULT_DEVICE) -> list:
    """Per class: {name, curve (the best restart's Adam losses then the
    polish's ||r||^2), adam_lm loss and seconds, lbfgs loss and seconds}."""
    from slam_decomposition_torch.models import gates
    from slam_decomposition_torch.models.templates import build_ansatz, cycle_gates
    from slam_decomposition_torch.opt.optimizer import TemplateOptimizer

    device = resolve_device(device)
    builder = lambda k: build_ansatz(cycle_gates([gates.SQISWAP], k))  # noqa: E731
    targets = np.asarray([SWAP])
    rows = []
    for name in classes:
        kw = dict(objective=name, spanning_range=[3], training_restarts=restarts, override_fail=True, seed=1,
                  device=device)
        opt = TemplateOptimizer(builder, use_callback=True, **kw)
        t0 = time.perf_counter()
        res = opt.approximate_from_distribution(targets)
        synchronize(device)
        t_fast = time.perf_counter() - t0
        adam = np.asarray(opt.training_history[-1])  # (B, R, iters)
        lm = np.asarray(opt.training_history_lm[-1])  # (B, lm_iters)
        best_r = int(np.argmin(adam[0, :, -1]))
        opt2 = TemplateOptimizer(builder, method="lbfgs", max_iters=lbfgs_iters, **kw)
        t0 = time.perf_counter()
        res2 = opt2.approximate_from_distribution(targets)
        synchronize(device)
        t_lbfgs = time.perf_counter() - t0
        rows.append({"name": name, "curve": np.concatenate([adam[0, best_r], lm[0]]),
                     "adam_lm_loss": float(res.loss[0]), "adam_lm_s": t_fast,
                     "lbfgs_loss": float(res2.loss[0]), "lbfgs_s": t_lbfgs})
        print(f"{name}: Adam+LM {rows[-1]['adam_lm_loss']:.2e} in {t_fast:.1f} s, L-BFGS "
              f"{rows[-1]['lbfgs_loss']:.2e} in {t_lbfgs:.1f} s", flush=True)
    return rows


def figure(rows):
    """The two panels as a PNG, or their data alone without matplotlib."""
    data = write_json("cost_function_comparison.json", rows)
    plt = pyplot()
    if plt is None:
        return no_figure("cost_function_comparison.png", data)
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4))
    for r in rows:
        ax1.semilogy(np.maximum(r["curve"], 1e-16), label=r["name"])
        ax2.scatter([r["adam_lm_s"]], [max(r["adam_lm_loss"], 1e-16)], marker="o", label=f"{r['name']} (Adam+LM)")
        ax2.scatter([r["lbfgs_s"]], [max(r["lbfgs_loss"], 1e-16)], marker="x")
    ax1.set_xlabel("iteration (Adam warm start + LM polish)")
    ax1.set_ylabel("loss")
    ax1.set_title("SWAP target, k=3 sqiSwap — convergence per cost class")
    ax1.axhline(1e-10, color="k", lw=0.5, ls="--")
    ax1.legend(fontsize=7)
    ax2.set_xlabel("wall-clock (s)")
    ax2.set_ylabel("final loss")
    ax2.set_yscale("log")
    ax2.set_title("engine comparison (o = Adam+LM, x = L-BFGS)")
    ax2.legend(fontsize=6)
    print(f"saved {save_figure(fig, 'cost_function_comparison.png')}")


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--restarts", type=int, default=8)
    ap.add_argument("--lbfgs-iters", type=int, default=400)
    ap.add_argument("--classes", nargs="+", default=CLASSES)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    a = ap.parse_args(argv)
    rows = compare(a.classes, a.restarts, a.lbfgs_iters, a.device)
    figure(rows)
    print(f"\n{'cost class':<22}{'Adam+LM loss':>14}{'s':>8}{'L-BFGS loss':>14}{'s':>8}")
    for r in rows:
        print(f"{r['name']:<22}{r['adam_lm_loss']:>14.2e}{r['adam_lm_s']:>8.1f}{r['lbfgs_loss']:>14.2e}{r['lbfgs_s']:>8.1f}")
    # the exact-unitary classes must certify; the class costs converge to the
    # local-equivalence class (their loss is the invariant mismatch)
    assert all(r["adam_lm_loss"] < 1e-9 or "reduced" in r["name"] or "makhlin" in r["name"] for r in rows)
    return rows


if __name__ == "__main__":
    main()
