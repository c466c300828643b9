"""The measured SNAIL speed-limit frontier distilled into spline knots (JAX
scripts/distill_speed_limit.py, the reference's snail_death_gate.py:33-93).

The input is the reference's measured dataset, a g_pct heatmap over
(g2_conv, g2_gain) amplitudes; it is not in this repository. Per conversion
column the last ~0.5 crossing is the frontier point; the known outlier
(zero-gain row, column 68) is dropped; the points are sorted by conversion
amplitude, the frontier is closed at gain 0, and the larger axis intercept
is normalized to pi/2.

    python3 -m slam_decomposition_torch.tools.distill_speed_limit PATH

Writes ``config.studies_dir()/snail_speed_limit.json`` {x, y, s,
provenance}. ``explore/speed_limit.py`` keeps reading the JAX package's
knots.
"""

from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np

from slam_decomposition_torch.tools import out_path

OUTLIER = (0, 68)  # (gain row, conversion column) removed by hand in the reference


def distill(dd: dict) -> dict:
    """The dataset {g2_conv, g2_gain, g_pct (conv, gain)} -> {x, y, s}."""
    conv = np.asarray(dd["g2_conv"], dtype=float)
    gain = np.asarray(dd["g2_gain"], dtype=float)
    g_pct = np.asarray(dd["g_pct"], dtype=float).T  # (gain_idx, conv_idx)
    pts = []
    for j in range(g_pct.shape[1]):
        idx = np.where(np.isclose(g_pct[:, j], 0.5, atol=0.05))[0]
        if len(idx) == 0:
            continue
        i = idx[-1]
        if (i, j) == OUTLIER:
            continue
        pts.append((conv[j], gain[i]))
    pts.sort(key=lambda p: p[0])
    pts.append((pts[-1][0], 0.0))  # close at gain = 0
    x = np.array([p[0] for p in pts])
    y = np.array([p[1] for p in pts])
    max_intercept = max(abs(x[-1]), abs(y[0]))
    return {"x": (x / max_intercept * (np.pi / 2)).tolist(), "y": (y / max_intercept * (np.pi / 2)).tolist(), "s": 0.001}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src", help="the measured dataset (JSON)")
    a = ap.parse_args(argv)
    knots = distill(json.loads(pathlib.Path(a.src).read_text()))
    out = out_path("snail_speed_limit.json")
    out.write_text(json.dumps({**knots, "provenance": f"distilled from {pathlib.Path(a.src).name} by "
                               "slam_decomposition_torch.tools.distill_speed_limit"}))
    x, y = knots["x"], knots["y"]
    print(f"wrote {out} with {len(x)} knots; intercepts x={x[-1]:.4f}, y={y[0]:.4f}")
    return knots


if __name__ == "__main__":
    main()
