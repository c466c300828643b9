"""Family extension and the E[Haar] winners (JAX scripts/haar_improvements.py,
the reference's haar_improvements.ipynb):

A. family-extension against plain decomposition cost of CPhase(pi / 2 / n),
   n = 1..15, over the weak pi/32 conversion-gain gate;
B. E[Haar] of the iSwap^t family against gate strength at 1Q durations 0,
   0.1 and 0.25, the bare gate count on a twin axis (the candidate database
   and ``atomic_cost_scaling``);
C. family-extended against plain E[Haar], D[CX] and D[SWAP] over the
   fractional iSwap^(1/n) bases, n = 1..15: ``family_costs_batch`` over a
   Haar sample, the plain curve exact from the closed-form layer volumes
   (``coverage/haar.py``).

    python3 -m slam_decomposition_torch.tools.haar_improvements [--parts A B C] [--n-haar 2000] [--fracs 15]
        [--device cuda|cpu]

Saves ``config.studies_dir()/figures/haar_improvements_{cphase,scatter,family}.png``
(where matplotlib is installed) and each figure's data beside ``figures/``
as ``haar_improvements_<name>.json``, and checks that the family extension
never costs more than the plain basis.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from slam_decomposition_torch.config import DEFAULT_DEVICE, resolve_device
from slam_decomposition_torch.tools import no_figure, pyplot, save_figure, write_json

COST_1Q = 0.1


def _figure(name: str, out: dict):
    """pyplot, or None after writing the part's data for its figure ``name``
    (``haar_improvements_<part>.json``; always written)."""
    data = write_json(f"{name}.json", out)
    plt = pyplot()
    if plt is None:
        no_figure(f"{name}.png", data)
    return plt


def cphase(theta: float) -> np.ndarray:
    return np.diag([1.0, 1.0, 1.0, np.exp(1j * theta)]).astype(complex)


def nofam_expectation(cov, bf: float, c1q: float) -> float:
    """Exact E[(k + 1) c1q + k bf] from the closed-form layer Haar volumes
    (nested layers: layer k adds V_k - V_{k-1})."""
    from slam_decomposition_torch.coverage import haar as H

    total, prev = 0.0, 0.0
    for cp in sorted(cov, key=lambda c: len(c.operations)):
        k = len(cp.operations)
        if k == 0:
            continue
        v = min(max(H.normalized_volume(cp.polytope), prev), 1.0)
        total += ((k + 1) * c1q + k * bf) * (v - prev)
        prev = v
    assert prev > 1.0 - 1e-6, f"incomplete coverage ({prev})"
    return total


def part_a(device) -> dict:
    from slam_decomposition_torch.coverage.coverage import gate_set_to_coverage, monodromy_ks_batch
    from slam_decomposition_torch.explore.family import family_costs_batch
    from slam_decomposition_torch.explore.scaling import atomic_cost_scaling
    from slam_decomposition_torch.models import gates as G

    t0 = time.perf_counter()
    params = [0, 0, 0, np.pi / 32, 1]
    base = G.conversion_gain_gate(*params)
    cov = gate_set_to_coverage(G.cg_canonicalize(base), device=device)
    bf = float(atomic_cost_scaling(params, 1, speed_method="linear", duration_1q=0, device=device)[1])
    thetas = np.array([np.pi / 2 / n for n in range(1, 16)])
    targets = np.stack([cphase(t) for t in thetas])
    fam = family_costs_batch(base, targets, cost_1q=COST_1Q, basis_factor=bf, device=device)
    ks = monodromy_ks_batch(cov, targets, device).astype(int)
    nofam = ks * bf + (ks + 1) * COST_1Q
    out = {"thetas": thetas, "fam": np.asarray(fam), "nofam": nofam, "seconds": time.perf_counter() - t0}
    print(f"A: cphase family curve done in {out['seconds']:.1f}s (max saving {100 * (1 - fam / nofam).max():.1f}%)")
    plt = _figure("haar_improvements_cphase", out)
    if plt is None:
        return out
    fig, ax = plt.subplots(figsize=(4.5, 3))
    ax.plot(thetas, fam, label="with family", marker="o")
    ax.plot(thetas, nofam, label="no family", marker="o")
    ax.invert_xaxis()
    ax.set_xticks([np.pi / 2, np.pi / 4, np.pi / 8, np.pi / 16])
    ax.set_xticklabels([r"$\pi/2$", r"$\pi/4$", r"$\pi/8$", r"$\pi/16$"])
    ax.set_xlabel(r"CPhase angle $\theta$")
    ax.set_ylabel("decomposition cost")
    ax.set_title(r"family extension on a $\pi/32$ gain gate")
    ax.legend()
    save_figure(fig, "haar_improvements_cphase.png")
    return out


def part_b(device) -> dict:
    from slam_decomposition_torch.explore.candidates import load_candidates
    from slam_decomposition_torch.explore.scaling import atomic_cost_scaling

    t0 = time.perf_counter()
    rows = sorted(((p, s) for p, s in load_candidates() if p[2] == 0 and p[3] > 0), key=lambda r: r[0][3])
    xs = np.array([p[3] / (np.pi / 2) for p, _ in rows])
    curves = {d1q: [float(atomic_cost_scaling(p, s, speed_method="linear", duration_1q=d1q, device=device)[1][0])
                    for p, s in rows] for d1q in [0, 0.1, 0.25]}
    out = {"t": xs, "curves": curves, "gate_count": [s[0] for _, s in rows], "seconds": time.perf_counter() - t0}
    print(f"B: E[Haar] scatter over {len(rows)} iSwap-family gates in {out['seconds']:.1f}s")
    plt = _figure("haar_improvements_scatter", out)
    if plt is None:
        return out
    fig, ax = plt.subplots(figsize=(4.5, 3))
    for d1q, curve in curves.items():
        ax.plot(xs, curve, marker="o", markersize=3, label=f"D[1Q]={d1q}")
    ax2 = ax.twinx()
    ax2.plot(xs, [s[0] for _, s in rows], color="gray", ls=":", marker="s", markersize=2, label="gate count (bare)")
    ax2.set_ylabel("E[Haar] gate count")
    ax.set_xlabel(r"iSwap fraction $t$ (iSwap$^t$)")
    ax.set_ylabel("E[Haar] duration")
    ax.set_title("iSwap-family Haar expectation (linear SLF)")
    h1, l1 = ax.get_legend_handles_labels()
    h2, l2 = ax2.get_legend_handles_labels()
    ax.legend(h1 + h2, l1 + l2, fontsize=7)
    save_figure(fig, "haar_improvements_scatter.png")
    return out


def part_c(device, n_haar: int = 2000, fracs: int = 15) -> dict:
    from slam_decomposition_torch.coverage.coverage import gate_set_to_coverage, monodromy_ks_batch
    from slam_decomposition_torch.explore.family import family_costs_batch
    from slam_decomposition_torch.explore.scaling import atomic_cost_scaling
    from slam_decomposition_torch.models import gates as G
    from slam_decomposition_torch.opt.samplers import haar_sample

    t0 = time.perf_counter()
    haar_targets = np.asarray(haar_sample(n_haar, seed=7))
    swap = np.zeros((4, 4), complex)
    swap[0, 0] = swap[3, 3] = swap[1, 2] = swap[2, 1] = 1.0
    pair = np.stack([np.asarray(G.CNOT.to_numpy()), swap])
    x_list = []
    curves = {k: [] for k in ("fam_haar", "nofam_haar", "fam_cx", "nofam_cx", "fam_swap", "nofam_swap")}
    for frac in range(1, fracs + 1):
        x_list.append(1 / frac)
        b = G.conversion_gain_gate(0, 0, 0, np.pi / 2, 1 / frac)
        covf = gate_set_to_coverage(G.cg_canonicalize(b), device=device)
        bf = float(atomic_cost_scaling([0, 0, 0, np.pi / 2, 1 / frac], 1, speed_method="linear", duration_1q=0,
                                       device=device)[1])
        fc = family_costs_batch(b, pair, cost_1q=COST_1Q, basis_factor=bf, device=device)
        kk = monodromy_ks_batch(covf, pair, device).astype(int)
        nf = kk * bf + (kk + 1) * COST_1Q
        curves["fam_cx"].append(fc[0])
        curves["nofam_cx"].append(nf[0])
        curves["fam_swap"].append(fc[1])
        curves["nofam_swap"].append(nf[1])
        fh = family_costs_batch(b, haar_targets, cost_1q=COST_1Q, basis_factor=bf, device=device)
        curves["fam_haar"].append(float(fh.mean()))
        curves["nofam_haar"].append(nofam_expectation(covf, bf, COST_1Q))
    out = {"x": x_list, **curves, "seconds": time.perf_counter() - t0}
    print(f"C: family curves over {len(x_list)} bases x {n_haar} Haar targets in {out['seconds']:.1f}s")
    # family extension can only help (score <= plain) wherever both are defined
    assert all(f <= n + 1e-9 for f, n in zip(curves["fam_cx"], curves["nofam_cx"]))
    assert all(f <= n + 1e-9 for f, n in zip(curves["fam_swap"], curves["nofam_swap"]))
    plt = _figure("haar_improvements_family", out)
    if plt is None:
        return out
    fig, ax = plt.subplots(figsize=(4.5, 3))
    style = dict(marker="o", markersize=2)
    for key, fmt, label in (("nofam_haar", "k--", "E[Haar]"), ("nofam_swap", "b--", "D[Swap]"),
                            ("nofam_cx", "r--", "D[CX]"), ("fam_haar", "k-", "E[Haar], family"),
                            ("fam_swap", "b-", "D[Swap], family"), ("fam_cx", "r-", "D[CX], family")):
        ax.plot(x_list, curves[key], fmt, label=label, **style)
    ax.set_xlabel(r"basis fraction $1/n$ (iSwap$^{1/n}$)")
    ax.set_ylabel("cost (linear SLF, D[1Q]=0.1)")
    ax.set_title("family extension over fractional iSwap bases")
    ax.legend(fontsize=6)
    save_figure(fig, "haar_improvements_family.png")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parts", nargs="+", default=["A", "B", "C"], choices=["A", "B", "C"])
    ap.add_argument("--n-haar", type=int, default=2000)
    ap.add_argument("--fracs", type=int, default=15)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    a = ap.parse_args(argv)
    device = resolve_device(a.device)
    out = {}
    if "A" in a.parts:
        out["A"] = part_a(device)
    if "B" in a.parts:
        out["B"] = part_b(device)
    if "C" in a.parts:
        out["C"] = part_c(device, a.n_haar, a.fracs)
    print("OK")
    return out


if __name__ == "__main__":
    main()
