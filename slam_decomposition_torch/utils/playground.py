"""Interactive parallel-drive explorer (JAX utils/playground.py): the Weyl
chamber trajectory of a smush pulse for a parameter setting is one batched
evaluation (``models.trajectory.smush_prefix_unitaries``: every prefix
product, then their coordinates), drawn with plain matplotlib sliders:

    ex = ParallelDriveExplorer(N=10, device="cpu")
    ex.update(q0=0.3, q1=0.1)      # headless functional API -> (N, R, 3)
    ex.interact()                   # slider panel (needs a GUI backend)

``improved_cx_trajectory`` draws the solved parallel-driven CX pulse
(``models.trajectory.improved_cx``) beside the two-application baseline.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from slam_decomposition_torch.config import DEFAULT_DEVICE, resolve_device
from slam_decomposition_torch.models.trajectory import smush_prefix_unitaries
from slam_decomposition_torch.ops import weyl


def _fold(coords: np.ndarray) -> np.ndarray:
    """Fold the chamber's c1 -> 1 - c1 mirror symmetry: c1 <= 1/2."""
    c = np.array(coords, dtype=float)
    m = c[..., 0] > 0.5
    c[..., 0] = np.where(m, 1.0 - c[..., 0], c[..., 0])
    return c


class ParallelDriveExplorer:
    """Live Weyl-chamber trajectory of N repeated smush slices: ``N`` atomic
    pulses of duration t / N, conversion / gain strengths ``gc`` / ``gg``
    with phases ``phi_c`` / ``phi_g``, and constant drives ``q0`` / ``q1``
    on the two qubits. ``R`` points of the path per segment: the pulse is
    Trotterized at N R slices. Runs on the card unless ``device`` names
    another."""

    def __init__(self, N=10, gc=np.pi / 2, gg=0.0, t=1.0, R=5, device=DEFAULT_DEVICE):
        self.N, self.gc, self.gg, self.t, self.R = N, gc, gg, t, R
        self.device = resolve_device(device)
        self.params = dict(q0=0.0, q1=0.0, phi_c=0.0, phi_g=0.0)
        self._fig = None
        self._artists = None
        self.coordinate_list: Optional[np.ndarray] = None
        self.final_unitary: Optional[np.ndarray] = None

    def _traj(self, q0, q1, phi_c, phi_g):
        """(coordinates (N R, 3), prefix products (N R, 4, 4))."""
        n = self.N * self.R
        Us = smush_prefix_unitaries(
            phi_c, phi_g, self.gc, self.gg, np.full(n, q0), np.full(n, q1), t=self.t, device=self.device
        )
        return weyl.c1c2c3(Us).cpu().numpy(), Us

    def update(self, **kw) -> np.ndarray:
        """Set any of q0 / q1 / phi_c / phi_g and recompute; returns the
        folded segments (N, R, 3) and refreshes an open figure in place."""
        unknown = set(kw) - set(self.params)
        if unknown:
            raise TypeError(f"unknown drive parameters: {sorted(unknown)}")
        self.params.update(kw)
        coords, Us = self._traj(**self.params)
        segs = _fold(coords).reshape(self.N, self.R, 3)
        self.coordinate_list = segs
        self.final_unitary = Us[-1].cpu().numpy()
        if self._artists is not None:
            flat = segs.reshape(-1, 3)
            self._artists._offsets3d = (flat[:, 0], flat[:, 1], flat[:, 2])
            self._fig.canvas.draw_idle()
        return segs

    def compose(self, other: "ParallelDriveExplorer") -> np.ndarray:
        """Trajectory of self's pulse followed by other's: other's prefix
        products multiplied onto self's final unitary from the left."""
        a = self.update()
        _, Us_o = other._traj(**other.params)
        U0 = torch.as_tensor(self.final_unitary, device=Us_o.device)
        tail = _fold(weyl.c1c2c3(Us_o @ U0).cpu().numpy()).reshape(other.N, other.R, 3)
        return np.concatenate([a, tail], axis=0)

    def plot(self, ax=None):
        """Scatter the current trajectory into Weyl-chamber axes."""
        from slam_decomposition_torch.utils.visualize import WeylChamberAxes

        if self.coordinate_list is None:
            self.update()
        w = WeylChamberAxes(ax=ax)
        flat = self.coordinate_list.reshape(-1, 3)
        col = np.repeat(np.arange(self.N), self.R)
        self._artists = w.ax.scatter(flat[:, 0], flat[:, 1], flat[:, 2], c=col, cmap="viridis", s=12)
        self._fig = w.ax.figure
        return w

    def interact(self):
        """Slider panel (matplotlib.widgets). Needs an interactive backend;
        under Agg it raises and points at the headless ``update()``."""
        import matplotlib

        if matplotlib.get_backend().lower().startswith("agg"):
            raise RuntimeError(
                "interact() needs a GUI matplotlib backend; headless use: "
                "explorer.update(q0=..., q1=...) returns the segments"
            )
        import matplotlib.pyplot as plt
        from matplotlib.widgets import Slider

        w = self.plot()
        fig = w.ax.figure
        fig.subplots_adjust(bottom=0.32)
        sliders = []
        for i, name in enumerate(("q0", "q1", "phi_c", "phi_g")):
            sax = fig.add_axes([0.2, 0.22 - 0.05 * i, 0.6, 0.03])
            s = Slider(sax, name, 0, 2 * np.pi, valinit=self.params[name])
            s.on_changed(lambda val, name=name: self.update(**{name: float(val)}))
            sliders.append(s)
        self._sliders = sliders  # keep the references alive
        plt.show()
        return sliders


def improved_cx_trajectory(n_slices=4, R=5, device=DEFAULT_DEVICE, **kw):
    """The solved parallel-driven CX path and the two-application baseline
    it beats: (segments (n_slices, R, 3), baseline (2, 25, 3), loss)."""
    from slam_decomposition_torch.models.trajectory import improved_cx

    x, loss, _locals = improved_cx(n_slices=n_slices, device=device, **kw)
    ex = ParallelDriveExplorer(N=n_slices, R=R, device=device)
    gx = np.repeat(x[2 : 2 + n_slices], R)
    gy = np.repeat(x[2 + n_slices :], R)
    Us = smush_prefix_unitaries(x[0], x[1], ex.gc, ex.gg, gx, gy, t=1.0, device=ex.device)
    segs = _fold(weyl.c1c2c3(Us).cpu().numpy()).reshape(n_slices, R, 3)
    i = np.linspace(0.0, 1.0, 25)[:, None]
    baseline = np.stack(
        [
            np.concatenate([0.25 * i, 0.25 * i, 0 * i], axis=1),
            np.concatenate([0.25 + 0.25 * i, 0.25 - 0.25 * i, 0 * i], axis=1),
        ]
    )
    return segs, baseline, loss
