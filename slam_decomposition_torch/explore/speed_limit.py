"""Hardware speed-limit functions (SLFs) over the (conversion, gain) plane
(JAX explore/speed_limit.py).

An SLF maps a conversion amplitude gc to the largest simultaneous gain
amplitude gg the hardware sustains. A gate is re-costed against an SLF by
intersecting its gc:gg ray with the frontier and scaling its duration
inversely.

  * linear   - no rescaling (the bare pi/2-normalized cost)
  * mid      - offset circle centred at (-c, -c), c = pi/4, through (pi/2, 0)
  * squared  - quarter circle of radius pi/2
  * hardware - the measured SNAIL-pump frontier, a smoothing spline over the
    knots in the JAX package's ``data/snail_speed_limit.json`` (read only)
"""

from __future__ import annotations

import dataclasses
import json
from typing import Callable

import numpy as np

from slam_decomposition_torch.config import JAX_DATA_DIR
from slam_decomposition_torch.models.gates import Gate

HALF_PI = np.pi / 2

_HW_KNOTS_PATH = JAX_DATA_DIR / "snail_speed_limit.json"
_hw_spline = None


def mid_sl(x):
    """Offset circle with intercepts at pi/2."""
    c = np.pi / 4
    return 0.5 * (-2 * c + np.sqrt(4 * c**2 - 8 * c * x + 4 * c * np.pi - 4 * x**2 + np.pi**2))


def squared_sl(x):
    """Quarter circle of radius pi/2."""
    return np.sqrt(np.maximum(HALF_PI**2 - x**2, 0.0))


def hardware_sl(x):
    """The measured SNAIL frontier, a cubic smoothing spline over the
    distilled knots."""
    global _hw_spline
    if _hw_spline is None:
        from scipy.interpolate import UnivariateSpline

        d = json.loads(_HW_KNOTS_PATH.read_text())
        _hw_spline = UnivariateSpline(d["x"], d["y"], s=d.get("s", 0.001))
    return _hw_spline(x)


SLFS = {"linear": None, "bare": None, "mid": mid_sl, "squared": squared_sl, "hardware": hardware_sl}


def speed_limited_cost(gc: float, gg: float, t: float, slf: Callable) -> float:
    """Duration of (gc, gg, t) rescaled onto the SLF frontier: the largest
    frontier point along the gc:gg ray, found on an 800-point grid with an
    escalating tolerance band, scales the time inversely."""
    if gc == 0 and gg == 0:
        raise ValueError("null gate has no speed-limited cost")
    if gc == 0:
        scale = float(slf(0.0)) / gg
    else:
        ratio = gg / gc
        xs = np.linspace(0.0, HALF_PI, 800)
        diff = np.abs(ratio * xs - np.asarray(slf(xs)))
        tol = 0.001
        while not np.any(diff < tol):
            tol += 0.001
        idx = int(np.max(np.where(diff < tol)[0]))
        scale = xs[idx] / gc
    return t / scale


def speed_limited_gate(g: Gate, slf_name: str = "hardware") -> Gate:
    """The same gate with its duration re-costed by the named SLF."""
    _, _, gc, gg, t = g.params
    slf = SLFS[slf_name]
    if slf is None:
        return g
    return dataclasses.replace(g, duration_override=speed_limited_cost(gc, gg, t, slf))
