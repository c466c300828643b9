"""The port's frontier certification (``tools/certify_frontier.py``) on the
CPU, against the JAX package: the frontier targets equal to the selection
made with the JAX package's own ``monodromy_reps_float``,
``contains_float``, ``gate_set_to_coverage`` and ``load_smush_coverage``
(the protocol of scripts/certify_extended_frontier.py, which is not
imported: it reads sys.argv at import), one tiny ``certify_row`` solve
against the JAX solver from the same starts, and the rows the tool takes
and the file it writes.

JAX stays on the CPU (tests/conftest.py) and reads a copy of its data
directory; data crosses as numpy."""

import json
import shutil

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from slam_decomposition_tpu.config import config as jconfig
from slam_decomposition_tpu.coverage import coverage as jcoverage
from slam_decomposition_tpu.explore import smush_volume as jsmush
from slam_decomposition_tpu.models import gates as jG
from slam_decomposition_tpu.ops import cplx as jcplx
from slam_decomposition_tpu.opt import costs as jcosts
from slam_decomposition_tpu.opt.gauss_newton import make_solver as jmake_solver
from slam_decomposition_tpu.opt.samplers import haar_sample as jhaar_sample

from slam_decomposition_torch.config import JAX_DATA_DIR
from slam_decomposition_torch.explore.smush_volume import _smush_eval
from slam_decomposition_torch.opt.costs import makhlin_functional_cost
from slam_decomposition_torch.tools import certify_frontier as cf

CPU = "cpu"
LOSS_ATOL = 1e-10  # certified losses of the two packages (both ~1e-30)
RECOMPUTE_ATOL = 1e-12  # a returned loss against the f64 Makhlin functional of its x


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one intra-op thread beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_data_copy(tmp_path_factory):
    """The JAX package reads its sets from a copy of its data directory, so
    that none of its calls can write into the real one."""
    copy = tmp_path_factory.mktemp("jax") / "data"
    shutil.copytree(JAX_DATA_DIR, copy)
    mp = pytest.MonkeyPatch()
    mp.setattr(jconfig, "data_dir", copy)
    yield copy
    mp.undo()


def _jax_frontier(name, k, n):
    """The script's selection, one target at a time through the JAX
    package."""
    gc, gg, t, iters = jsmush.NAMED_GATES[name]
    base_gate = jG.cg_canonicalize(jG.conversion_gain_gate(0, 0, gc, gg, t))
    bare = jcoverage.gate_set_to_coverage(base_gate, max_layers=iters)
    ext = jsmush.load_smush_coverage(base_gate)[k]
    base = bare[k] if k < len(bare) else None
    picked = []
    for U in jhaar_sample(cf.HAAR_POOL, seed=20260821 + 31 * k + len(name)):
        reps = np.asarray(jcoverage.monodromy_reps_float(U))[:, :3]
        if not ext.contains_float(reps) or (base is not None and base.contains_float(reps)):
            continue
        picked.append(U)
        if len(picked) >= n:
            break
    return np.stack(picked)


@pytest.mark.parametrize("row", [("B", 1, 8), ("sqiSwap", 2, 6), ("sqiSwap", 1, 2)])
def test_frontier_targets_match_jax(row, jax_data_copy):
    got = cf.frontier_targets(*row, device=CPU)
    want = _jax_frontier(*row)
    assert got.shape == want.shape == (row[2], 4, 4)
    np.testing.assert_array_equal(got, want)


ROW = ("sqiSwap", 1, 2)  # two slices, 2 targets: the smallest solve


@pytest.fixture(scope="module")
def tiny_row():
    """certify_row of ROW at 1 restart a lane on the port."""
    return cf.certify_row(*ROW, restarts=1, device=CPU, detail=True)


def test_certify_row_certifies_and_reports_the_makhlin_functional(tiny_row):
    """Every target certified, and each returned loss is the f64 Makhlin
    functional of the returned x."""
    name, k, n = ROW
    got = tiny_row
    assert got["frontier_sampled"] == n and got["certified_frac"] == 1.0 and got["certified"].all()
    assert got["worst_loss"] == got["losses"].max() <= cf.THRESH
    gc, gg, t, _ = cf.NAMED_GATES[name]
    teval, _ = _smush_eval(gc, gg, t, k)
    again = makhlin_functional_cost(teval(torch.as_tensor(got["x"])), torch.as_tensor(got["targets"])).numpy()
    assert np.abs(again - got["losses"]).max() <= RECOMPUTE_ATOL


@pytest.mark.slow
def test_certify_row_matches_the_jax_solver(tiny_row, jax_data_copy):
    """The JAX solver from the script's starts on the same PAD-lane layout
    certifies the same targets with the same losses. Its JAX side compiles
    for ~50 s; the unmarked case above runs the same port code."""
    name, k, n = ROW
    got = tiny_row
    gc, gg, t, _ = jsmush.NAMED_GATES[name]
    jeval, n_params = jsmush._smush_eval(gc, gg, t, k)
    solve = jax.jit(jmake_solver(jeval, n_params, adam_iters=400, lm32_iters=16, lm_iters=16, residual="makhlin",
                                 final_cost_fn=jcosts.makhlin_functional_cost))
    idx = np.resize(np.arange(n), cf.PAD)
    tgt = jcplx.from_numpy(got["targets"][idx])
    rng = np.random.default_rng(7 * k + len(name))
    losses = np.full(n, np.inf)
    for _ in range(got["rounds"]):
        x0 = rng.uniform(0, 2 * np.pi, (cf.PAD, 1, n_params))
        x0[..., 2:6] = rng.uniform(-4.0, 4.0, (cf.PAD, 1, 4))  # one cycle of two slices
        _, bf = solve(jnp.asarray(x0), tgt)
        np.minimum.at(losses, idx, np.asarray(bf))
    np.testing.assert_array_equal(got["certified"], losses <= cf.THRESH)
    assert np.abs(got["losses"] - losses)[got["certified"]].max() <= LOSS_ATOL


def test_frontier_rows_and_the_file_written(tmp_path, monkeypatch):
    """The 12 rows of extended_results.json whose extended volume beats the
    base, k = 1 first; the tool writes build/slam_coverage/ (moved by
    SLAM_CACHE_DIR) after each row, skips rows already there, and never
    writes the data directory."""
    rows = cf.frontier_rows([])
    assert len(rows) == 12 and rows[0] == (1, "B") and rows[-1] == (3, "sqCNOT")
    assert [k for k, _ in rows] == sorted(k for k, _ in rows)
    monkeypatch.setenv("SLAM_CACHE_DIR", str(tmp_path))
    before = sorted(p.name for p in JAX_DATA_DIR.iterdir())
    calls = []

    def fake(name, k, n, restarts, device):
        calls.append((name, k))
        return {"name": name, "k": k, "frontier_sampled": 0}

    monkeypatch.setattr(cf, "certify_row", fake)
    out = cf.main(n_targets=3, device=CPU, log=lambda line: None)
    path = tmp_path / "slam_coverage" / "frontier_certification.json"
    assert json.loads(path.read_text()) == out and len(out) == 12
    assert calls == [(name, k) for k, name in rows]
    calls.clear()
    assert cf.main(n_targets=3, device=CPU, log=lambda line: None) == out and calls == []
    assert sorted(p.name for p in JAX_DATA_DIR.iterdir()) == before
