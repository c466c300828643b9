"""Weyl-chamber rendering (JAX utils/visualize.py:14-72): host-side
matplotlib, with the Agg backend. Only the chamber axes that the
parallel-drive explorer draws into are here; the JAX module's heatmaps,
convergence plots and coverage hulls are not ported yet.
"""

from __future__ import annotations

import numpy as np


def _require_mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


class WeylChamberAxes:
    """3D Weyl chamber: its edges and corner labels, with scatter and
    trajectory helpers."""

    VERTICES = np.array([[0, 0, 0], [1, 0, 0], [0.5, 0.5, 0], [0.5, 0.5, 0.5]])
    EDGES = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]

    def __init__(self, ax=None):
        plt = _require_mpl()
        if ax is None:
            fig = plt.figure()
            ax = fig.add_subplot(111, projection="3d")
        self.ax = ax
        self.draw_chamber()

    def draw_chamber(self):
        ax = self.ax
        for i, j in self.EDGES:
            seg = self.VERTICES[[i, j]]
            ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], "k-", lw=0.5)
        for label, v in zip("O A1 A2 A3".split(), self.VERTICES):
            ax.text(*v, label)
        ax.set_xlabel("c1")
        ax.set_ylabel("c2")
        ax.set_zlabel("c3")

    def scatter(self, coords, **kw):
        coords = np.atleast_2d(np.asarray(coords))
        self.ax.scatter(coords[:, 0], coords[:, 1], coords[:, 2], **kw)
        return self.ax

    def trajectory(self, coords, **kw):
        coords = np.asarray(coords)
        self.ax.plot(coords[:, 0], coords[:, 1], coords[:, 2], **kw)
        return self.ax
