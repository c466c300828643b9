"""The PyTorch port imports torch, numpy and scipy only: never jax, never
the JAX package."""

import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "slam_decomposition_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts)
    for p in PORT.rglob("*.py")
    if p.name != "__init__.py"
)


def test_every_module_imports_without_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'slam_decomposition_tpu')))\n"
        "print(len(bad), bad[:5])\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert len(MODULES) >= 12


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")), ids=lambda p: p.name)
def test_no_jax_import_in_source(path):
    src = path.read_text()
    assert not re.search(r"^\s*(import jax|from jax)\b", src, re.M)
    assert not re.search(r"^\s*(import|from) slam_decomposition_tpu\b", src, re.M)


def test_driven_modules_are_checked():
    """The driven path's modules are among those imported without jax above."""
    driven = {
        "slam_decomposition_torch.models.hamiltonians",
        "slam_decomposition_torch.models.trajectory",
        "slam_decomposition_torch.explore.oct",
        "slam_decomposition_torch.explore.smush_volume",
        "slam_decomposition_torch.utils.playground",
        "slam_decomposition_torch.utils.visualize",
    }
    assert driven <= set(MODULES)


def test_transpilation_path_modules_are_checked():
    """The speed-limit transpilation path's modules are among those imported
    without jax above."""
    path = {
        "slam_decomposition_torch.utils.persist",
        "slam_decomposition_torch.explore.speed_limit",
        "slam_decomposition_torch.explore.candidates",
        "slam_decomposition_torch.explore.family",
        "slam_decomposition_torch.explore.scaling",
        "slam_decomposition_torch.explore.winners",
        "slam_decomposition_torch.transpile.route",
        "slam_decomposition_torch.transpile.syc_decompose",
        "slam_decomposition_torch.tools.headline",
    }
    assert path <= set(MODULES)


def test_mesh_and_utility_modules_are_checked():
    """The mesh, the entry points, the profiling and plotting utilities and
    the scaling tool are among those imported without jax above."""
    mesh = {
        "slam_decomposition_torch.parallel.mesh",
        "slam_decomposition_torch.parallel.launch",
        "slam_decomposition_torch.graft_entry",
        "slam_decomposition_torch.utils.profiling",
        "slam_decomposition_torch.utils.visualize",
        "slam_decomposition_torch.tools.scaling_curve",
        "slam_decomposition_torch.tools.mesh_readings",
    }
    assert mesh <= set(MODULES)
