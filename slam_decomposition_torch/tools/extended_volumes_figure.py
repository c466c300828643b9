"""Extended (parallel-drive) volumes per gate and k: this repository's
``extended_results.json`` against the reference's (JAX
scripts/extended_volumes_figure.py), a table and a grouped bar chart at k =
1 and 2.

    python3 -m slam_decomposition_torch.tools.extended_volumes_figure --ref PATH [--ours PATH]

``--ours`` defaults to the JAX package's ``data/extended_results.json``,
read only. The reference's file is not in this repository and has no
default: without it (or with a path that does not exist) the tool prints
the script's "not available" line and exits 0. The figure goes to
``config.studies_dir()/figures/extended_volumes.png`` (where matplotlib is
installed) and the rows to ``extended_volumes.json`` beside ``figures/``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from slam_decomposition_torch.config import JAX_DATA_DIR
from slam_decomposition_torch.tools import no_figure, pyplot, save_figure, write_json

OURS = JAX_DATA_DIR / "extended_results.json"


def rows_of(ours: dict, ref: dict) -> list:
    """(gate, k, reference volume, ours) for every gate of both and every k
    of the reference's, NaN where ours lacks the k."""
    rows = []
    for g in (g for g in ref if g in ours):
        for k in sorted(ref[g], key=int):
            o = float(ours[g][k][1]) if k in ours[g] else float("nan")
            rows.append((g, int(k), float(ref[g][k][1]), o))
    return rows


def table(rows) -> list:
    lines = [f"{'gate':8} {'k':>2} {'reference':>10} {'ours':>10}"]
    for g, k, r, o in rows:
        mark = "" if o >= r - 1e-6 else "  << BELOW"
        lines.append(f"{g:8} {k:2d} {r:10.6f} {o:10.6f}{mark}")
    return lines


def figure(ours: dict, ref: dict, rows) -> None:
    """The bar chart as a PNG, and the table's rows as JSON (alone without
    matplotlib)."""
    data = write_json("extended_volumes.json", rows)
    plt = pyplot()
    if plt is None:
        return no_figure("extended_volumes.png", data)
    gates = [g for g in ref if g in ours]
    fig, axes = plt.subplots(1, 2, figsize=(11, 4.2), sharey=False)
    for ax, kk in zip(axes, ("1", "2")):
        gs = [g for g in gates if kk in ref[g]]
        x = np.arange(len(gs))
        ax.bar(x - 0.2, [float(ref[g][kk][1]) for g in gs], 0.4, label="reference (MC only)", color="#999")
        ax.bar(x + 0.2, [float(ours[g][kk][1]) for g in gs], 0.4,
               label="this framework (MC multi-scale\n+ targeted descents)", color="#2b6cb0")
        ax.set_xticks(x)
        ax.set_xticklabels(gs, rotation=30)
        ax.set_title(f"extended Haar volume @ k={kk}")
        ax.set_yscale("log")
        ax.grid(axis="y", alpha=0.3)
    axes[0].legend(fontsize=8)
    print("wrote", save_figure(fig, "extended_volumes.png", dpi=140))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ours", default=str(OURS))
    ap.add_argument("--ref", default=None, help="the reference's extended_results.json")
    a = ap.parse_args(argv)
    ours = json.load(open(a.ours))
    try:
        if a.ref is None:
            raise OSError
        ref = json.load(open(a.ref))
    except OSError:
        print("reference JSON not available; nothing to compare")
        return None
    rows = rows_of(ours, ref)
    print("\n".join(table(rows)))
    figure(ours, ref, rows)
    return rows


if __name__ == "__main__":
    main()
