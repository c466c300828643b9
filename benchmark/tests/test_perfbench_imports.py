"""What the benchmark loads: no JAX, no JAX package (top-level module names
compared whole: the port's name begins with the JAX package's), and a
reference that loads nothing of the port."""

import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "slam_decomposition_tpu"}


def _py(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT / "build"), "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("cell", ["sqiswap.haar-main", "sixteenth_iswap.circuits-ks"])
def test_a_run_loads_no_jax(cell):
    small = {"batch": 16, "chunk": 8, "restarts": 2, "pool_batches": 1, "check_per_batch": 4}
    if cell.endswith("circuits-ks"):
        small["target_params"] = {"circuits": [{"family": "qft", "qubits": 6}]}
    code = (
        "import sys, json; sys.path.insert(0, '.'); import torch; torch.set_num_threads(2); "
        "from benchmark import harness; from benchmark.tests import control; "
        f"harness.run({cell!r}, 5, 0.05, True, 'cpu', overrides={small!r}, log=lambda *a, **k: None); "
        "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))"
    )
    top = set(json.loads(_py(code)))
    assert "slam_decomposition_torch" in top
    assert not top & FORBIDDEN


def test_reference_loads_nothing_of_the_port():
    code = (
        "import sys, json; sys.path.insert(0, '.'); import benchmark.reference.judge, benchmark.reference.ks; "
        "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))"
    )
    top = set(json.loads(_py(code)))
    assert not top & (FORBIDDEN | {"slam_decomposition_torch", "torch"})


def test_command_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "sqiswap.haar-main", "--seed",
                          str(2**31 + 5), "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
