"""The study tools (``slam_decomposition_torch/tools/``, ported from the JAX
package's ``scripts/``) on the CPU at small sizes.

Each tool runs in this process with ``SLAM_CACHE_DIR`` at a temporary
directory, and must write there and nowhere else in the repository. Where a
script is safe to import (``parity_diagnostics``, ``distill_speed_limit``,
``extended_volumes_figure``: a main guard, module globals for its paths),
the port is held against it; for the others against the JAX library calls
they make (``fidelity_attribution``). The scripts that work at import or
point JAX's cache into the repository are never imported."""

import hashlib
import importlib.util
import json
import pathlib
import shutil

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401  (torch on one intra-op thread)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SCRIPTS = ROOT / "scripts"
# what the scripts write and the tools must not
PROTECTED = [ROOT / "docs", ROOT / "fidelity_attribution.json",
             ROOT / "slam_decomposition_tpu" / "data" / "snail_speed_limit.json"]


def _digest() -> str:
    h = hashlib.sha256()
    for p in PROTECTED:
        for f in sorted(p.rglob("*")) if p.is_dir() else [p]:
            if f.is_file():
                h.update(str(f.relative_to(ROOT)).encode())
                h.update(f.read_bytes())
    return h.hexdigest()


@pytest.fixture
def studies(tmp_path, monkeypatch):
    """``SLAM_CACHE_DIR`` at tmp_path; yields the studies folder and checks
    afterwards that the scripts' own destinations are unchanged."""
    monkeypatch.setenv("SLAM_CACHE_DIR", str(tmp_path))
    before = _digest()
    yield tmp_path / "slam_studies"
    assert _digest() == before, "a tool wrote into docs/, the repo root or the JAX data directory"


def _script(name: str):
    """A JAX script that is safe to import (it works under a main guard)."""
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------- each tool, small, on the CPU

CPU = ["--device", "cpu"]
RUNS = {
    "tune_solver_sweep": (["4", "10", "2", "0", "2", "4", "4", "--sweep", "--sweep-r", "2", "--sweep-adam", "5",
                           "--sweep-top-m", "0", "1", *CPU], ["tune_solver.jsonl"]),
    "qft64_pass_timing": (["--qubits", "4", *CPU], ["qft64_pass_timing.json"]),
    "parity_diagnostics": (["QFT", "--qubits", "4", "--seeds", "1", *CPU], ["parity_diagnostics.json"]),
    "fidelity_attribution": (["1", "--qubits", "4", *CPU], ["fidelity_attribution.json"]),
    "driven_ab": (["--grape-restarts", "2", "--grape-iters", "10", "--drive-restarts", "2", "--targeted-restarts", "1",
                   "--targeted-iters", "5", *CPU], ["driven_ab.json"]),
    "cost_function_comparison": (["--restarts", "2", "--lbfgs-iters", "20", "--classes", "square",
                                  "makhlin_functional", *CPU], ["figures/cost_function_comparison.png"]),
    "haar_improvements": (["--n-haar", "16", "--fracs", "2", *CPU],
                          [f"figures/haar_improvements_{p}.png" for p in ("cphase", "scatter", "family")]),
}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_tool_runs_small_on_the_cpu(run, studies):
    """(tune_solver, profile_solver and bench_analytic alone: below.)"""
    tool = importlib.import_module(f"slam_decomposition_torch.tools.{run.replace('_sweep', '')}")
    args, outputs = RUNS[run]
    out = tool.main(args)
    assert out
    if run == "tune_solver_sweep":
        assert [(r["R"], r["adam_iters"], r["top_m"], r["n"], r["chunk"]) for r in out] == [
            (2, 5, m, 4, 4) for m in (0, 1) for _ in (2, 3)]
    for name in outputs:
        assert (studies / name).is_file(), name


def test_tune_solver_rows_carry_the_cut_lanes(studies):
    from slam_decomposition_torch.tools import tune_solver

    rows = tune_solver.main(["4", "5", "2", "2", "2", "6", "4", *CPU])
    assert [r["k"] for r in rows] == [2, 3]
    for r in rows:
        chunks = -(-r["n"] // 4)
        assert r["lanes"] == {"adam_chain": [16] * chunks, "lm_chain": [8] * chunks, "polish_chain": [4] * chunks}
        assert r["certify"] == "f64" and r["card"] == "cpu" and 0.0 <= r["converged_frac"] <= 1.0
    assert len((studies / "tune_solver.jsonl").read_text().splitlines()) == 2


def test_profile_solver_splits_the_solve(studies):
    from slam_decomposition_torch.tools import profile_solver

    prof = profile_solver.main(["2", "2", "--reps", "1", *CPU])
    assert set(prof["seconds"]) == {"adam_only", "adam+lm32", "full"}
    names = [r[0] for r in prof["rows"]]
    assert names[:4] == ["adam_f32 (100 it)", "lm_f32 (8 it)", "lm_f64 polish (6 it)", "total"]
    # every variant runs each kernel's plain version once a solve (the later
    # phases at zero iterations)
    assert all(set(v) == {"adam_chain", "lm_chain", "polish_chain"} for v in prof["kernel_ms"].values())
    assert "| adam_f32 (100 it) |" in (studies / "profile_solver.md").read_text()


def test_bench_analytic_losses_are_f64_costs(studies):
    from slam_decomposition_torch.tools import bench_analytic

    (row,) = bench_analytic.main(["6", "--ks", "2", *CPU])
    assert row["analytic_certified"] == 6 and 0 <= row["variational_certified"] <= 6
    assert row["variational_loss_vs_f64"] <= 1e-13 and row["analytic_loss_vs_f64"] <= 1e-13
    assert json.loads((studies / "bench_analytic.json").read_text())["rows"][0]["k"] == 2


DEVICE_TOOLS = {
    "tune_solver": [], "profile_solver": [], "bench_analytic": [], "qft64_pass_timing": [],
    "parity_diagnostics": ["QFT"], "fidelity_attribution": [], "driven_ab": ["quick"],
    "cost_function_comparison": [], "haar_improvements": [],
}


@pytest.mark.parametrize("name", sorted(DEVICE_TOOLS))
def test_tool_asks_for_the_card_by_default(name, studies):
    """Without a card the default device raises: no tool falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    tool = importlib.import_module(f"slam_decomposition_torch.tools.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(DEVICE_TOOLS[name])


# ---------------------------------------------------------------- against the JAX package


def test_parity_diagnostics_rows_equal_jax(studies):
    from slam_decomposition_tpu.transpile import library as jlibrary

    from slam_decomposition_torch.tools import parity_diagnostics
    from slam_decomposition_torch.transpile import library

    want = _script("parity_diagnostics").diagnose("QFT", lambda s: jlibrary.qft(4), n_seeds=2)
    got = parity_diagnostics.diagnose("QFT", lambda s: library.qft(4), 2, device="cpu")
    assert set(got) == set(want)
    for key in ("circuit", "seed", "router_swaps", "n_blocks", "k_hist"):
        assert got[key] == want[key], key
    for key in ("duration", "duration_ref_metric"):
        assert got[key] == pytest.approx(want[key], abs=1e-9), key


@pytest.fixture(scope="module")
def jax_data_copy(tmp_path_factory):
    """The JAX package reads its coverage sets from a copy of its data
    directory, so that none of its calls can write into the real one."""
    from slam_decomposition_tpu import config as jconfig

    copy = tmp_path_factory.mktemp("jax") / "data"
    shutil.copytree(ROOT / "slam_decomposition_tpu" / "data", copy)
    mp = pytest.MonkeyPatch()
    mp.setattr(jconfig.config, "data_dir", copy)
    yield copy
    mp.undo()


@pytest.mark.parametrize("router", ["round1", "round2"])
@pytest.mark.parametrize("circuit", ["QFT", "QV"])
def test_fidelity_attribution_durations_equal_jax(circuit, router, jax_data_copy, studies):
    """The tool's (basic, optimized) durations against the JAX library calls
    the script makes, on the 4-qubit circuits over 2 seeds."""
    from slam_decomposition_tpu.transpile import library as jlibrary
    from slam_decomposition_tpu.transpile.passes import pass_manager_basic, pass_manager_optimized_sqiswap
    from slam_decomposition_tpu.transpile.route import grid_coupling, route

    from slam_decomposition_torch.tools import fidelity_attribution as fa
    from slam_decomposition_torch.tools.parity_diagnostics import suite

    jgen = {"QFT": lambda s: jlibrary.qft(4), "QV": lambda s: jlibrary.qv(4, seed=s)}[circuit]
    best = None
    for seed in range(2):
        c = route(jgen(seed), grid_coupling(4, 4), seed=seed, rows_cols=(4, 4), **fa.router_kwargs(router))
        _, mb = pass_manager_basic(c, gate="sqiswap", duration_1q=0.25)
        _, mo = pass_manager_optimized_sqiswap(c, duration_1q=0.25)
        if best is None or mb["duration"] < best[0]:
            best = (mb["duration"], mo["duration"])
    got = fa.run(suite(4)[circuit], router, 2, device="cpu")
    np.testing.assert_allclose(got, best, rtol=0, atol=1e-9)
    fa.check_identity()


def _heatmap(rng):
    """A g_pct map over (conversion, gain) amplitudes with a falling
    frontier, one column without a crossing, and the outlier the reference
    removes (a crossing only at zero gain in column 68)."""
    conv = np.linspace(0.0, 1.2, 80)
    gain = np.linspace(1.0, 0.0, 30)
    edge = np.clip((1.0 - conv / 1.2) * 29, 0, 29).astype(int)
    g = np.where(np.arange(30)[None, :] <= edge[:, None], 0.5, 0.9) + rng.uniform(-0.02, 0.02, (80, 30))
    g[10] = 0.9
    g[68] = 0.9
    g[68, 0] = 0.5
    return {"g2_conv": conv.tolist(), "g2_gain": gain.tolist(), "g_pct": g.tolist()}


def test_distill_equals_the_jax_script(tmp_path, studies, monkeypatch):
    from slam_decomposition_torch.tools import distill_speed_limit

    dd = _heatmap(np.random.default_rng(0))
    src = tmp_path / "measured.json"
    src.write_text(json.dumps(dd))
    script = _script("distill_speed_limit")
    monkeypatch.setattr(script, "OUT", tmp_path / "jax_out.json")
    script.main(str(src))
    want = json.loads((tmp_path / "jax_out.json").read_text())
    got = distill_speed_limit.distill(dd)
    assert got == {k: want[k] for k in ("x", "y", "s")}
    assert len(got["x"]) == 78 + 1  # 80 columns less the empty one and the outlier, then the closing point
    distill_speed_limit.main([str(src)])
    assert json.loads((studies / "snail_speed_limit.json").read_text())["x"] == got["x"]


def test_extended_volumes_rows_equal_the_jax_script(tmp_path, studies, monkeypatch, capsys):
    from slam_decomposition_torch.tools import extended_volumes_figure as ev

    # B lacks k = 3 in ours (a NaN row); the figure's k = 1, 2 are in both
    ours = {"iSwap": {"1": [0, 0.79], "2": [0, 1.0]}, "B": {"1": [0, 0.5], "2": [0, 1.0]}, "CNOT": {"1": [0, 0.1]}}
    ref = {"iSwap": {"1": [0, 0.7], "2": [0, 1.0]}, "B": {"1": [0, 0.6], "3": [0, 0.9]}, "SWAP": {"1": [0, 0.2]}}
    paths = {}
    for name, obj in (("ours", ours), ("ref", ref)):
        paths[name] = tmp_path / f"{name}.json"
        paths[name].write_text(json.dumps(obj))
    script = _script("extended_volumes_figure")
    monkeypatch.setattr(script, "OURS", str(paths["ours"]))
    monkeypatch.setattr(script, "REF", str(paths["ref"]))
    monkeypatch.setattr(script, "FIGDIR", str(tmp_path / "jax_figures"))
    script.main()
    want = [line for line in capsys.readouterr().out.splitlines() if not line.startswith("wrote")]
    rows = ev.main(["--ours", str(paths["ours"]), "--ref", str(paths["ref"])])
    got = [line for line in capsys.readouterr().out.splitlines() if not line.startswith("wrote")]
    assert got == want and len(rows) == 4
    assert (studies / "figures" / "extended_volumes.png").is_file()
    # without the reference's file: the script's line
    monkeypatch.setattr(script, "REF", str(tmp_path / "missing.json"))
    script.main()
    assert ev.main(["--ours", str(paths["ours"])]) is None
    assert ev.main(["--ours", str(paths["ours"]), "--ref", str(tmp_path / "missing.json")]) is None
    out = capsys.readouterr().out.splitlines()
    assert out == ["reference JSON not available; nothing to compare"] * 3


def test_kernel_clock_leaves_the_wrappers_and_their_counts(studies):
    """The clock wraps the solvers' view of the wrappers, never the module's
    own functions, whose launch counters the wrappers themselves update."""
    from slam_decomposition_torch.ops import chain_kernels as ck
    from slam_decomposition_torch.opt import gauss_newton
    from slam_decomposition_torch.tools.profile_solver import kernel_clock

    before = [ck.adam_chain, ck.lm_chain, ck.polish_chain]
    a, x0, T = _solver_inputs()
    solver = gauss_newton.make_solver(a.eval_fn, a.n_params, adam_iters=3, lm32_iters=1, lm_iters=1,
                                      chain_gates=a.chain_gates, device="cpu")
    with kernel_clock("cpu") as ms:
        assert [ck.adam_chain, ck.lm_chain, ck.polish_chain] == before
        solver.solve(x0, T)
    assert gauss_newton.ck is ck
    assert {name: len(v) for name, v in ms.items()} == {"adam_chain": 1, "lm_chain": 1, "polish_chain": 1}


def _solver_inputs(B=2, R=2, k=2):
    from slam_decomposition_torch.models import gates
    from slam_decomposition_torch.models.templates import build_ansatz, cycle_gates
    from slam_decomposition_torch.opt.samplers import haar_sample

    a = build_ansatz(cycle_gates([gates.SQISWAP], k))
    x0 = torch.as_tensor(np.random.default_rng(0).uniform(0, 2 * np.pi, (B, R, a.n_params)))
    return a, x0, torch.as_tensor(haar_sample(B, seed=0))


@pytest.mark.parametrize("run", ["cost_function_comparison", "haar_improvements"])
def test_figures_are_optional(run, studies, monkeypatch):
    """Without matplotlib (the GPU machine has none) a tool writes each
    figure's data and no PNG."""
    tool = importlib.import_module(f"slam_decomposition_torch.tools.{run}")
    monkeypatch.setattr(tool, "pyplot", lambda: None)
    args = {"cost_function_comparison": ["--restarts", "2", "--lbfgs-iters", "5", "--classes", "square", *CPU],
            "haar_improvements": ["--parts", "A", "B", *CPU]}[run]
    tool.main(args)
    assert not (studies / "figures").exists()
    data = sorted(p.name for p in studies.glob("*.json"))
    assert data == {"cost_function_comparison": ["cost_function_comparison.json"],
                    "haar_improvements": ["haar_improvements_cphase.json", "haar_improvements_scatter.json"]}[run]
