"""Parity of the port's substitution passes with the JAX package's: winner
substitution in every strategy (``speed_gate_substitute``), the batched 1Q
fit (``fit_substituted_1q``, the chain kernels' plain versions on CPU
tensors) through ``pass_manager_slam``, the parallel-drive identities
without a fit, and the SYC counts.

JAX stays on the CPU (tests/conftest.py); data crosses as numpy. The JAX
calls that may read coverage sets read a temporary copy of its data
directory."""

import shutil

import numpy as np
import pytest
import torch

from slam_decomposition_tpu.config import config as jconfig
from slam_decomposition_tpu.explore import winners as jwinners
from slam_decomposition_tpu.opt.samplers import haar_sample as jhaar_sample
from slam_decomposition_tpu.transpile import ir as jir
from slam_decomposition_tpu.transpile import library as jlibrary
from slam_decomposition_tpu.transpile import passes as jpasses
from slam_decomposition_tpu.transpile import syc_decompose as jsyc

from slam_decomposition_torch.config import JAX_DATA_DIR
from slam_decomposition_torch.models import gates as G
from slam_decomposition_torch.transpile import ir, library, passes
from slam_decomposition_torch.transpile import syc_decompose as syc

CPU = "cpu"
ATOL = 1e-12  # gate matrices: the same expm up to host rounding
FIT_DIST = 1e-9  # whole-circuit trace distance after the fit

STRATEGIES = ["basic_overall", "lambda_weight", "basic_smush", "lambda_smush", "weighted_overall",
              "weighted_pairwise"]


@pytest.fixture(scope="module")
def jax_data_copy(tmp_path_factory):
    """The JAX package reads its coverage sets from a copy of its data
    directory, so that none of its calls can write into the real one."""
    copy = tmp_path_factory.mktemp("jax") / "data"
    shutil.copytree(JAX_DATA_DIR, copy)
    mp = pytest.MonkeyPatch()
    mp.setattr(jconfig, "data_dir", copy)
    yield copy
    mp.undo()


def _same_ops(a, b, atol=ATOL):
    assert a.n_qubits == b.n_qubits and len(a.ops) == len(b.ops)
    for x, y in zip(a.ops, b.ops):
        assert (x.name, x.qubits) == (y.name, y.qubits)
        np.testing.assert_allclose(x.params, y.params, atol=atol)
        assert (x.duration is None) == (y.duration is None)
        if x.duration is not None:
            assert x.duration == pytest.approx(y.duration, abs=atol)
        assert (x.matrix is None) == (y.matrix is None)
        if x.matrix is not None:
            np.testing.assert_allclose(x.matrix, y.matrix, atol=atol)


def _analysis_equal(m, jm):
    assert m["gate_counts"] == jm["gate_counts"] and m["depth"] == jm["depth"]
    assert m["duration"] == pytest.approx(jm["duration"], abs=ATOL)
    assert m["duration_ref_metric"] == pytest.approx(jm["duration_ref_metric"], abs=ATOL)


def _gdist(A, B):
    return 1 - abs(np.trace(B.conj().T @ A)) / A.shape[0]


def _ladder(irmod):
    c = irmod.Circuit(3)
    c.cp(0.7, 0, 1)
    c.cp(1.1, 1, 2)
    c.cp(0.3, 0, 1)
    return c


@pytest.fixture
def jax_winners_kept(monkeypatch):
    """The JAX pass caches each winner's matrix by ``id()`` of its gate,
    which a freed gate hands on to the next edge's winner (a stale matrix
    under weighted_pairwise); keeping every returned gate alive gives the
    JAX package's intended output. The port's cache holds its gates."""
    kept = []
    pick = jwinners.pick_winner

    def keep(*a, **kw):
        out = pick(*a, **kw)
        kept.append(out)
        return out

    monkeypatch.setattr(jwinners, "pick_winner", keep)
    return kept


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("circ", ["qft6", "ghz3"])
def test_speed_gate_substitute_matches_jax(circ, strategy, jax_data_copy, jax_winners_kept):
    make = {"qft6": lambda lib: lib.qft(6), "ghz3": lambda lib: lib.ghz(3)}[circ]
    out = passes.speed_gate_substitute(make(library), strategy=strategy, duration_1q=0.25, device=CPU)
    jout = jpasses.speed_gate_substitute(make(jlibrary), strategy=strategy, duration_1q=0.25)
    _same_ops(out, jout)
    _analysis_equal(passes.duration_analysis(out, 0.25), jpasses.duration_analysis(jout, 0.25))


@pytest.mark.parametrize("method", ["linear", "hardware"])
def test_speed_gate_substitute_family_extension_fails_as_jax_does(method, jax_data_copy):
    """The family-extension substitution raises ValueError in both packages:
    the family winner is a weak gate, and the winner template's set, capped
    at ten layers (MixedOrderBasisTemplate's max_layers), does not cover the
    blocks (ROADMAP.md, Queue 3)."""
    kw = dict(strategy="basic_overall", speed_method=method, duration_1q=0.1, basic_metric=1, family_extension=True)
    with pytest.raises(ValueError, match="no coverage polytope"):
        passes.speed_gate_substitute(library.ghz(4), device=CPU, **kw)
    with pytest.raises(ValueError, match="no coverage polytope"):
        jpasses.speed_gate_substitute(jlibrary.ghz(4), **kw)


def test_pass_manager_slam_matches_jax_without_fit(jax_data_copy):
    out, m = passes.pass_manager_slam(library.qft(6), duration_1q=0.25, device=CPU)
    jout, jm = jpasses.pass_manager_slam(jlibrary.qft(6), duration_1q=0.25)
    _same_ops(out, jout)
    _analysis_equal(m, jm)
    assert _gdist(out.to_matrix(), library.qft(6).to_matrix()) > 1e-3  # placeholders only


@pytest.fixture(scope="module")
def fits(jax_data_copy):
    """pass_manager_slam(fit_1q=True) on ghz(3) and the cp ladder in both
    packages, each fit's input and output substitutions recorded."""
    mp = pytest.MonkeyPatch()
    seen = {"port": [], "jax": []}

    def recorder(key, fn):
        def wrapped(blocks, subs, *a, **kw):
            out = fn(blocks, subs, *a, **kw)
            seen[key].append((subs, out, kw.get("stats")))
            return out
        return wrapped

    mp.setattr(passes, "fit_substituted_1q", recorder("port", passes.fit_substituted_1q))
    mp.setattr(jpasses, "fit_substituted_1q", recorder("jax", jpasses.fit_substituted_1q))
    res = {}
    for name, (c, jc) in {"ghz3": (library.ghz(3), jlibrary.ghz(3)), "ladder": (_ladder(ir), _ladder(jir))}.items():
        stats = []
        out, m = passes.pass_manager_slam(c, duration_1q=0.25, fit_1q=True, device=CPU, stats=stats)
        jout, jm = jpasses.pass_manager_slam(jc, duration_1q=0.25, fit_1q=True)
        res[name] = dict(circ=c, out=out, m=m, jout=jout, jm=jm, stats=stats, port=seen["port"][-1],
                         jax=seen["jax"][-1])
    mp.undo()
    return res


@pytest.mark.parametrize("name", ["ghz3", "ladder"])
def test_fit_1q_is_fidelity_faithful(fits, name):
    r = fits[name]
    assert _gdist(r["out"].to_matrix(), r["circ"].to_matrix()) <= FIT_DIST
    assert _gdist(r["jout"].to_matrix(), r["circ"].to_matrix()) <= FIT_DIST
    _analysis_equal(r["m"], r["jm"])
    assert all(s["path"] == "kernels" for s in r["stats"])


@pytest.mark.parametrize("name", ["ghz3", "ladder"])
def test_fit_1q_fits_the_blocks_jax_fits(fits, name):
    r = fits[name]
    (subs, out, stats), (jsubs, jout, _) = r["port"], r["jax"]
    assert sorted(subs) == sorted(jsubs)
    fitted = sorted(i for i in subs if out[i] is not subs[i])
    jfitted = sorted(i for i in jsubs if jout[i] is not jsubs[i])
    assert fitted == jfitted and fitted  # the same fitted blocks, and the rest kept
    for i in subs:
        _same_ops(subs[i], jsubs[i])  # the same placeholders went in
    assert sum(s["fitted"] for s in stats) == len(fitted)
    assert sum(s["blocks"] for s in stats) == len([i for i in subs if any(op.n_qubits == 2 for op in subs[i].ops)])


def test_fit_substituted_1q_keeps_a_block_above_the_threshold():
    """A block whose structure cannot reach its target (one winner
    application for a CNOT) keeps its placeholders; a dummy is untouched."""
    from slam_decomposition_torch.transpile.consolidate import consolidate_2q_blocks

    c = ir.Circuit(2)
    c.cx(0, 1)
    blocks = consolidate_2q_blocks(c)
    gate = G.conversion_gain_gate(0, 0, 0.03926991, 0.74612826, 1)
    sub = ir.Circuit(2)
    passes._random_1q_layer(sub, np.random.default_rng(0), 0.25)
    sub.append("winner2q", (0, 1), matrix=gate.to_numpy(), duration=0.5)
    passes._random_1q_layer(sub, np.random.default_rng(1), 0.25)
    dummy = ir.Circuit(2)
    dummy.unitary(np.eye(4), (0, 1), name="dummy", duration=1.0)
    stats = []
    out = passes.fit_substituted_1q(blocks * 2, {0: sub, 1: dummy}, duration_1q=0.25, device=CPU, stats=stats)
    assert out[0] is sub and out[1] is dummy
    assert stats[0]["blocks"] == 1 and stats[0]["fitted"] == 0 and stats[0]["worst"] > 1e-10


@pytest.mark.parametrize("circ", ["qft8", "swap", "haar20"])
def test_optimized_sqiswap_sub_matches_jax(circ, jax_data_copy, monkeypatch):
    def make(lib, irmod):
        if circ == "qft8":
            return lib.qft(8)
        c = irmod.Circuit(2 if circ == "swap" else 4)
        if circ == "swap":
            c.unitary(G.SWAP.to_numpy(), (0, 1))
        else:
            for i, U in enumerate(jhaar_sample(20, seed=7)):
                c.unitary(U, ((0, 1), (2, 3), (1, 2))[i % 3])
        return c

    jplans = {}

    def capture(blocks, subs, plans, **kw):
        jplans.update(plans)
        return subs

    monkeypatch.setattr(jpasses, "fit_substituted_pd", capture)
    out = passes.optimized_sqiswap_sub(make(library, ir), duration_1q=0.25, device=CPU)
    jout = jpasses.optimized_sqiswap_sub(make(jlibrary, jir), duration_1q=0.25, fit_1q=True)  # captured: no fit
    _same_ops(out, jout)
    assert passes._pd_substitutions(make(library, ir), 0.25, "linear", 0, torch.device(CPU))[3] == jplans
    m = passes.duration_analysis(passes.optimize_1q_gates(out), 0.25)
    _analysis_equal(m, jpasses.duration_analysis(jpasses.optimize_1q_gates(jout), 0.25))
    _, pm = passes.pass_manager_optimized_sqiswap(make(library, ir), duration_1q=0.25, device=CPU)
    _analysis_equal(pm, m)


def test_optimized_sqiswap_fit_raises_until_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        passes.optimized_sqiswap_sub(library.qft(4), duration_1q=0.25, fit_1q=True, device=CPU)
    with pytest.raises(NotImplementedError):
        passes.pass_manager_optimized_sqiswap(library.qft(4), duration_1q=0.25, fit_1q=True, device=CPU)


def test_headline_swap_and_vqe_linear_rows():
    """SWAP 2.5 -> 2.25 and VQE(Linear)-16 on the 4x4 grid at seed 0,
    25.75 -> 21.50 (headline_results.json)."""
    from slam_decomposition_torch.tools import headline
    from slam_decomposition_torch.transpile.route import grid_coupling, route

    assert headline.gate_duration(G.SWAP.to_numpy(), CPU) == (2.5, 2.25)
    c = route(library.vqe_linear(16, seed=0), grid_coupling(4, 4), seed=0, rows_cols=(4, 4))
    mb, mo = headline.managers(c, CPU)
    assert mb["duration"] == pytest.approx(25.75, abs=ATOL) and mo["duration"] == pytest.approx(21.5, abs=ATOL)


def test_syc_counts_match_jax():
    U = jhaar_sample(64, seed=3)
    named = np.stack([np.eye(4), G.syc().to_numpy(), G.CNOT.to_numpy(), G.SWAP.to_numpy()])
    ks = syc.syc_counts_batch(np.concatenate([U, named]), device=CPU)
    np.testing.assert_array_equal(ks, jsyc.syc_counts_batch(np.concatenate([U, named])))
    assert (ks[:64] >= 1).all() and (ks[:64] <= 4).all() and (ks[:64] < 4).any()
    assert list(ks[64:66]) == [0, 1]
    steps, k = syc.syc_decompose(U[0], device=CPU)
    assert k == ks[0] and sum(s[0] == "syc" for s in steps) == k
    np.testing.assert_allclose(syc.syc_scores(device=CPU), jsyc.syc_scores(), atol=ATOL)
