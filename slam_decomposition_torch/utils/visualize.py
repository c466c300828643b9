"""Visualization (JAX utils/visualize.py, after the reference's
src/slam/utils/visualize.py and coverage_plot.py): host-side matplotlib
with the Agg backend. Matrix heatmaps, optimizer-convergence plots, Weyl
chamber scatters and trajectories, Hamiltonian sweeps, coverage-polytope
hulls and candidate scores, on the port's coordinates (``ops.weyl``) and
coverage types (``coverage.coverage.CircuitPolytope``).
"""

from __future__ import annotations

import numpy as np
import torch


def _require_mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_matrix(U, ax=None):
    """Magnitude heatmap of a unitary with each entry's phase written in it
    (reference visualize.py:12-27)."""
    plt = _require_mpl()
    U = np.asarray(U)
    if ax is None:
        _, ax = plt.subplots()
    im = ax.imshow(np.abs(U), cmap="viridis")
    for (i, j), v in np.ndenumerate(U):
        if abs(v) > 1e-3:
            ax.text(j, i, f"{np.angle(v):.2f}", ha="center", va="center", fontsize=7)
    plt.colorbar(im, ax=ax)
    return ax


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


def _scatter_lists(w, coord_lists, colors):
    for i, coords in enumerate(coord_lists):
        if len(coords) == 0:
            continue
        kw = {} if colors is None else {"c": colors[i % len(colors)]}
        w.scatter(np.asarray(coords), s=4, **kw)


def unitary_to_weyl(*unitaries, c="r"):
    """Scatter 4x4 unitaries at their positive canonical coordinates
    (``ops.weyl.c1c2c3``, on the CPU) in a new chamber (reference
    visualize.py:232-240)."""
    from slam_decomposition_torch.ops import weyl

    coords = weyl.c1c2c3(torch.as_tensor(np.stack(unitaries), dtype=torch.complex128)).numpy()
    w = WeylChamberAxes()
    w.scatter(coords, c=c)
    return w


def optimizer_training_plot(losses, coordinate_trajectories=None, title=""):
    """Loss per iteration on a log scale, one line per restart segment, and
    beside it the chamber trajectories when given (reference
    visualize.py:58-135; segments are separate lists, not the reference's
    -1 sentinels)."""
    plt = _require_mpl()
    if coordinate_trajectories:
        fig = plt.figure(figsize=(10, 4))
        ax1 = fig.add_subplot(121)
        w = WeylChamberAxes(fig.add_subplot(122, projection="3d"))
        for traj in coordinate_trajectories:
            w.trajectory(np.asarray(traj), lw=1)
    else:
        fig, ax1 = plt.subplots()
    for seg in losses:
        ax1.semilogy(np.maximum(np.asarray(seg), 1e-16))
    ax1.set_xlabel("iteration")
    ax1.set_ylabel("loss")
    ax1.set_title(title)
    return fig


def coordinate_2dlist_weyl(*coord_lists, colors=None, no_bar=False):
    """Each list of chamber coordinates as one scatter layer in a new
    chamber (reference visualize.py:168-211)."""
    w = WeylChamberAxes()
    _scatter_lists(w, coord_lists, colors)
    return w


def update_coordinate_2dlist_weyl(w, *coord_lists, colors=None):
    """Redraw the chamber ``w`` (from ``coordinate_2dlist_weyl``) with new
    layers, in the same figure: live monitoring of a running sweep
    (reference visualize.py:214-229)."""
    w.ax.cla()
    w.draw_chamber()
    _scatter_lists(w, coord_lists, colors)
    w.ax.figure.canvas.draw_idle()
    return w


def plot_hamiltonian_sweep(matrix, title="Hamiltonian Sweep", labels=None, rounder=2, vmin=0, vmax=1):
    """Heatmap of |value| over a 2D Hamiltonian-parameter sweep, each cell
    written with its rounded value (reference visualize.py:30-50);
    ``labels`` is the reference's grid of (row, col) parameter pairs."""
    plt = _require_mpl()
    arr = np.asarray(matrix)
    fig, ax = plt.subplots(figsize=(7, 7))
    pm = ax.imshow(np.abs(arr), interpolation="nearest", vmin=vmin, vmax=vmax)
    ax.set_title(title)
    if labels is not None:
        cols, rows = np.arange(arr.shape[1]), np.arange(arr.shape[0])
        ax.set_xticks(cols)
        ax.set_xticklabels([labels[0][j][1] for j in cols])
        ax.set_yticks(rows)
        ax.set_yticklabels([labels[i][0][0] for i in rows])
    for (j, i), val in np.ndenumerate(arr):
        ax.text(i, j, np.round(val, rounder), ha="center", va="center")
    fig.colorbar(pm, ax=ax)
    return fig


def coverage_hull_points(cp) -> np.ndarray:
    """The positive canonical coordinates of every vertex of a coverage
    polytope's convex pieces (exact monodromy vertices a, mapped as
    (a0 + a1, a0 + a2, a1 + a2)): the points ``plot_coverage_set`` hulls."""
    pts = [
        [float(v[0]) + float(v[1]), float(v[0]) + float(v[2]), float(v[1]) + float(v[2])]
        for sub in cp.polytope.convex_subpolytopes
        for v in sub.vertices()
    ]
    return np.asarray(pts, dtype=np.float64).reshape(-1, 3)


def plot_coverage_set(coverage, ax=None):
    """Each coverage layer (cost > 0) as the convex hull of its vertices in
    the chamber, colored by layer (reference coverage_plot.py:14-32)."""
    from scipy.spatial import ConvexHull, QhullError

    plt = _require_mpl()
    w = WeylChamberAxes(ax)
    cmap = plt.get_cmap("viridis")
    layers = [cp for cp in coverage if cp.cost > 0]
    for li, cp in enumerate(layers):
        color = cmap(li / max(len(layers) - 1, 1))
        pts = coverage_hull_points(cp)
        if len(pts) < 4:
            if len(pts):
                w.scatter(pts, c=[color])
            continue
        try:
            hull = ConvexHull(pts, qhull_options="QJ")
        except QhullError:  # a degenerate layer: its vertices only
            w.scatter(pts, c=[color])
            continue
        for simplex in hull.simplices:
            s = np.append(simplex, simplex[0])
            w.ax.plot(pts[s, 0], pts[s, 1], pts[s, 2], c=color, lw=0.6, alpha=0.6)
    return w


def plot_candidate_scores(params_list, scores_list, metric: int = 0, ax=None):
    """The candidate design space (conversion, gain) colored by one score:
    0 E[haar], 1 D[CNOT], 2 D[SWAP] (reference bare_candidates.py:128-148)."""
    plt = _require_mpl()
    if ax is None:
        _, ax = plt.subplots()
    x = [p[2] for p in params_list]
    y = [p[3] for p in params_list]
    z = [s[metric] for s in scores_list]
    sc = ax.scatter(x, y, s=80, c=z)
    ax.set_xlabel("conv")
    ax.set_ylabel("gain")
    plt.colorbar(sc, ax=ax, label=["E[haar]", "D[CNOT]", "D[SWAP]"][metric])
    return ax
