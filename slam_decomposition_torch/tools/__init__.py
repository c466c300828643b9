"""Measurement scripts of the port, run on a CUDA card as modules:
``python -m slam_decomposition_torch.tools.<name>``. The study tools (ported
from the JAX package's ``scripts/``) take ``--device`` (the card unless
``cpu`` is asked for) and write under ``config.studies_dir()``."""

from __future__ import annotations

import json
import pathlib
import subprocess

import torch


def card(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or "cpu"
    for a run on the CPU (no device measurement)."""
    if torch.device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    index = torch.device(device).index or 0
    return out[index] if index < len(out) else out[0]


def synchronize(device) -> None:
    """Waits for the card's queued work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def out_path(name: str) -> pathlib.Path:
    """``config.studies_dir() / name``, its folder made."""
    from slam_decomposition_torch.config import studies_dir

    path = studies_dir() / name
    path.parent.mkdir(parents=True, exist_ok=True)
    return path


def write_json(name: str, obj) -> pathlib.Path:
    path = out_path(name)
    path.write_text(json.dumps(obj, indent=1, default=_plain) + "\n")
    return path


def _plain(obj):
    """numpy arrays and scalars as lists and numbers."""
    return obj.tolist() if hasattr(obj, "tolist") else str(obj)


def pyplot():
    """matplotlib's pyplot on the Agg backend, or None where matplotlib is
    not installed (the GPU machine has none): a tool then writes its
    figure's data alone."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def save_figure(fig, name: str, dpi: int = 150) -> pathlib.Path:
    plt = pyplot()
    path = out_path(f"figures/{name}")
    fig.tight_layout()
    fig.savefig(path, dpi=dpi)
    plt.close(fig)
    return path


def no_figure(name: str, data: pathlib.Path) -> None:
    print(f"matplotlib is not installed: figures/{name} not drawn (its data: {data})")
