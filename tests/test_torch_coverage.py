"""The coverage engine on the CPU against the JAX package.

The port builds coverage sets with its own copy of the exact-rational
engine (coverage/polytope.py over the C++ core csrc/polytope_core.cpp,
coverage/qlr.py, coverage/deduce.py, coverage/coverage.py). Exact results
are held equal to the JAX package's: Fractions, row order and names. The
float results (coordinates, volumes, membership) have their tolerances
stated where they are checked. The JAX package's own cached pickles are its
builds' output, so the port's builds are held to them too. A JAX build
writes its cache into its data directory, so the one JAX build here runs
with that directory moved to a temporary one.
"""

import math
import re
from fractions import Fraction

import numpy as np
import pytest
import torch

from slam_decomposition_tpu import config as jconfig
from slam_decomposition_tpu.coverage import coverage as jcov
from slam_decomposition_tpu.coverage import haar as jhaar
from slam_decomposition_tpu.coverage import mixed as jmixed
from slam_decomposition_tpu.coverage import polytope as jpoly
from slam_decomposition_tpu.coverage import qlr as jqlr
from slam_decomposition_tpu.models import gates as jgates
from slam_decomposition_tpu.models import templates as jtemplates
from slam_decomposition_tpu.opt import optimizer as joptimizer

from slam_decomposition_torch.config import coverage_cache_dir, data_dir
from slam_decomposition_torch.coverage import coverage as cov
from slam_decomposition_torch.coverage import haar, native, qlr
from slam_decomposition_torch.coverage import polytope as poly
from slam_decomposition_torch.coverage.mixed import MixedOrderBasisTemplate
from slam_decomposition_torch.models import gates
from slam_decomposition_torch.models.templates import build_ansatz, cycle_gates
from slam_decomposition_torch.opt.optimizer import TemplateOptimizer
from slam_decomposition_torch.opt.samplers import haar_sample

CPU = torch.device("cpu")
PD = (math.pi / 8, math.pi / 4)  # the parallel-drive gate's (gc, gg): both drives on, no cached set
PD_EXPECTED_COST = 2.041729136984176  # the JAX package's expected_cost of its set
PD_HIST = {2: 95897, 3: 4103}  # the JAX package's depths of haar_sample(100000, seed=456)
VOLUME_RTOL = 1e-12  # the closed form's float rounding (~1e-14), in a different summation order
N_POLYTOPES = 20


def _pd(pkg=gates):
    return pkg.conversion_gain_gate(0, 0, *PD, 1.0)


def _rows(p):
    """A convex polytope's exact content, None for an empty one."""
    return None if p is None else (p.inequalities, p.equalities, p.name)


def _coverage_rows(c):
    return [
        (e.operations, e.cost, [_rows(s) for s in e.polytope.convex_subpolytopes]) for e in c
    ]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module, restored after it: the batched
    coordinates run many small ops, where extra threads only add
    synchronisation (20000 targets: 0.66 s on one thread, 1.7 s on eight)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_pd(tmp_path_factory):
    """The JAX package's build of the parallel-drive set, its cache written
    to a temporary data directory (returned beside it)."""
    d = tmp_path_factory.mktemp("jax_data")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jconfig.config, "data_dir", d)
        return jcov.gate_set_to_coverage(_pd(jgates), use_cache=False), d


@pytest.fixture(scope="module")
def port_pd():
    return cov.gate_set_to_coverage(_pd(), use_cache=False, device=CPU)


def test_qlr_table_matches_jax():
    got = qlr.qlr_inequalities()
    assert len(got) == 72 and got == jqlr.qlr_inequalities()


# ---------------------------------------------------------------- exact polytopes


def _random_system(rng):
    """A small rational system over 3 variables: 4-8 inequality rows with
    entries in [-3, 3] over denominators 1..4 (a few with negative offsets,
    so some systems are empty), every third bounded by the unit box, every
    fourth with an equality row."""
    fr = lambda: Fraction(int(rng.integers(-3, 4)), int(rng.integers(1, 5)))  # noqa: E731
    m = int(rng.integers(4, 9))
    ineqs = [[Fraction(int(rng.integers(-1, 6)), int(rng.integers(1, 4)))] + [fr() for _ in range(3)] for _ in range(m)]
    return ineqs, [[fr() for _ in range(4)]] if rng.integers(4) == 0 else []


def _systems():
    rng = np.random.default_rng(2024)
    out = []
    for i in range(N_POLYTOPES + 1):
        ineqs, eqs = _random_system(rng)
        if i % 3 == 0:
            ineqs += [[1, -1, 0, 0], [1, 0, -1, 0], [1, 0, 0, -1], [1, 1, 0, 0], [1, 0, 1, 0], [1, 0, 0, 1]]
        out.append((ineqs, eqs, [Fraction(int(v)) for v in rng.integers(-3, 4, size=3)]))
    return out


SYSTEMS = _systems()


def _exact_results(P, system, next_system):
    """Every exact operation on the system, in the given polytope module."""
    ineqs, eqs, obj = system
    a = P.ConvexPolytope.make(ineqs, eqs, name="a")
    b = P.ConvexPolytope.make(next_system[0], next_system[1], name="b")
    red = a.reduce()
    return {
        "make": _rows(a),
        "lp_max": P.lp_max(obj, a.inequalities, a.equalities),
        "empty": a.is_empty(),
        "reduce": _rows(red),
        "vertices": red.vertices() if red is not None else None,
        "subtract": [_rows(p) for p in P.convex_subtract(a, b)],
        "fm": [P.fourier_motzkin(a.inequalities, a.equalities, [v], 3) for v in range(3)],
    }


@pytest.mark.parametrize("i", range(N_POLYTOPES))
def test_exact_polytope_ops_match_jax(i, monkeypatch):
    """lp_max, is_empty, reduce, vertices, convex_subtract and
    fourier_motzkin on a seeded rational system give exactly the JAX
    package's Fractions, through the C++ core and through the Fractions
    path alike."""
    want = _exact_results(jpoly, SYSTEMS[i], SYSTEMS[i + 1])
    assert _exact_results(poly, SYSTEMS[i], SYSTEMS[i + 1]) == want
    monkeypatch.setattr(native, "lp_max_native", lambda *a: None)
    monkeypatch.setattr(native, "reduce_native", lambda *a: None)
    assert _exact_results(poly, SYSTEMS[i], SYSTEMS[i + 1]) == want


def test_overflow_takes_the_fractions_path():
    """An entry past 2^62 cannot go to the core (OverflowError in packing),
    and products of entries near 2^61 overflow inside it (its code -1):
    both return None, and lp_max / reduce answer through the Fractions path
    exactly as the JAX package does."""
    big = Fraction(2**70 + 1, 3)
    near = Fraction(2**61 - 1, 2**61 - 3)
    box = [[1, -1, 0, 0], [1, 0, -1, 0], [1, 0, 0, -1], [1, 1, 0, 0], [1, 0, 1, 0], [1, 0, 0, 1]]
    for extra in ([big, 1, 1, 1], [near, near, Fraction(1, 2**61 - 5), near]):
        rows = [tuple(Fraction(x) for x in r) for r in box + [extra]]
        obj = [Fraction(1), near, Fraction(-1)]
        assert native.lp_max_native(obj, rows, []) is None
        assert poly.lp_max(obj, rows) == jpoly.lp_max(obj, rows)
        assert native.reduce_native(rows, [], 3) is None
        assert _rows(poly.ConvexPolytope(rows, []).reduce()) == _rows(jpoly.ConvexPolytope(rows, []).reduce())


def test_failed_core_build_raises(tmp_path, monkeypatch):
    """A core that does not compile raises instead of switching the engine
    to the Fractions path for good."""
    bad = tmp_path / "polytope_core.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "polytope_build_dir", lambda: tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.load.__wrapped__()


# ---------------------------------------------------------------- gates and sets


def _cached_gate_names():
    names = []
    for p in sorted(data_dir().glob("polytope_coverage_*.pkl")):
        m = re.fullmatch(r"polytope_coverage_\['([^']*)'\]\.pkl", p.name)
        if m:  # a single-gate set, smush sets excluded
            names.append(m.group(1))
    return names


def _gate(name, pkg):
    m = re.fullmatch(r"2QGate\(([-\d.]+), ([-\d.]+), ([-\d.]+)\)", name)
    if m:
        return pkg.conversion_gain_gate(0, 0, *map(float, m.groups()))
    return {"cx": pkg.CNOT, "B": pkg.berkeley(), "SYC": pkg.syc(), "riswap(0.5)": pkg.riswap(0.5)}[name]


def test_gate_monodromy_reps_match_jax():
    """Every single-gate basis of the JAX package's cached sets (its
    conversion-gain names parsed back to gates; cx, B, SYC, riswap(0.5)):
    the port's f64 coordinates through limit_denominator(10_000) give
    exactly the JAX package's Fractions."""
    names = _cached_gate_names()
    assert len(names) >= 220 and "riswap(0.5)" in names
    for name in names:
        g, jg = _gate(name, gates), _gate(name, jgates)
        assert str(g) == str(jg)
        assert cov.gate_monodromy_reps(g, CPU) == jcov.gate_monodromy_reps(jg), name


@pytest.mark.parametrize(
    "gate",
    [gates.cg_sqiswap(), gates.CNOT, gates.cg_iswap(), gates.berkeley(), gates.conversion_gain_gate(0, 0, 0, math.pi / 8, 1.0)],
    ids=["sqiswap", "cnot", "iswap", "b", "quarter_iswap"],
)
def test_builds_equal_the_cached_sets(gate):
    """The port's build, without its cache, equals the JAX package's cached
    pickle row for row: operations, cost, every convex subpolytope's exact
    rows and name, in order."""
    assert cov.coverage_path(gate).exists()
    built = cov.gate_set_to_coverage(gate, use_cache=False, device=CPU)
    assert _coverage_rows(built) == _coverage_rows(cov.load_coverage(gate))


def test_capped_build_is_the_truncated_cached_set():
    """An explicit max_layers on a cache hit returns the identity and that
    many layers: the capped build itself (which is not cached)."""
    g = gates.cg_sqiswap()
    capped = cov.gate_set_to_coverage(g, max_layers=2, use_cache=False, device=CPU)
    assert len(capped) == 3
    assert _coverage_rows(cov.gate_set_to_coverage(g, max_layers=2)) == _coverage_rows(capped)


def test_parallel_drive_build_matches_jax(jax_pd, port_pd):
    """conversion_gain_gate(0, 0, pi/8, pi/4, 1), which no cache holds: the
    port's build equals the JAX package's row for row, is written to the
    port's build directory only, and reads back from there."""
    jc, jdir = jax_pd
    name = cov._cache_name([str(_pd())], False)
    assert str(_pd()) == "2QGate(0.39269908, 0.78539816, 1.00000000)"
    assert not (data_dir() / name).exists() and (jdir / name).exists()
    assert [len(c.operations) for c in port_pd] == [0, 1, 2, 3]
    assert _coverage_rows(port_pd) == _coverage_rows(jc)
    assert (coverage_cache_dir() / name).exists()
    assert _coverage_rows(cov.gate_set_to_coverage(_pd())) == _coverage_rows(jc)


def test_parallel_drive_depths_of_haar_targets(port_pd):
    """The depths of haar_sample(100000, seed=456) over the port's set are
    the JAX package's."""
    ks = cov.monodromy_ks_batch(port_pd, haar_sample(100_000, seed=456), device=CPU)
    vals, cnt = np.unique(ks, return_counts=True)
    assert dict(zip(vals.tolist(), cnt.tolist())) == PD_HIST


# ---------------------------------------------------------------- volumes


def test_haar_volumes_match_jax(jax_pd, port_pd):
    """expected_cost of the sqiSwap and parallel-drive sets, normalized_volume
    of each layer and convex_volume of each convex subpolytope, within
    VOLUME_RTOL of the JAX package's."""
    jc, _ = jax_pd
    sq, jsq = cov.load_coverage(gates.cg_sqiswap()), jcov.gate_set_to_coverage(jgates.cg_sqiswap())
    assert haar.expected_cost(port_pd) == pytest.approx(PD_EXPECTED_COST, rel=VOLUME_RTOL)
    for c, j in ((sq, jsq), (port_pd, jc)):
        assert haar.expected_cost(c) == pytest.approx(jhaar.expected_cost(j), rel=VOLUME_RTOL)
        for layer, jlayer in zip(c[1:], j[1:]):
            assert haar.normalized_volume(layer.polytope) == pytest.approx(
                jhaar.normalized_volume(jlayer.polytope), rel=VOLUME_RTOL
            )
            for s, js in zip(layer.polytope.convex_subpolytopes, jlayer.polytope.convex_subpolytopes):
                assert haar.convex_volume(s) == pytest.approx(jhaar.convex_volume(js), rel=VOLUME_RTOL, abs=1e-300)


def test_mc_volume_matches_jax():
    """The Monte-Carlo Haar mass of the quarter-iSwap's depth-3 layer from the
    same 200000 draws: coordinates differ at ~1e-15 between the packages, so
    at most one draw on a face may fall the other way."""
    q = gates.conversion_gain_gate(0, 0, 0, math.pi / 8, 1.0)
    layer = cov.load_coverage(q)[3]
    jlayer = jcov.gate_set_to_coverage(jgates.conversion_gain_gate(0, 0, 0, math.pi / 8, 1.0))[3]
    got = haar.mc_volume(layer.polytope, n=200_000, seed=3, device=CPU)
    want = jhaar.mc_volume(jlayer.polytope, n=200_000, seed=3)
    assert 0.05 < want < 0.95
    assert abs(got - want) <= 1 / 200_000


# ---------------------------------------------------------------- ranges and costs


def _zoo(pkg):
    return np.stack(
        [np.eye(4, dtype=complex)]
        + [g.to_numpy() for g in (pkg.CNOT, pkg.SWAP, pkg.ISWAP, pkg.berkeley())]
    )


@pytest.mark.parametrize("which", ["sqiswap", "parallel"])
def test_ranges_match_jax(which, jax_pd, port_pd):
    """monodromy_ranges_batch on 2000 Haar targets and the identity, CNOT,
    SWAP, iSwap and B, and monodromy_range_from_target on the five: the
    same k and the same layer (its operations) as the JAX package."""
    if which == "sqiswap":
        c, jc = cov.load_coverage(gates.cg_sqiswap()), jcov.gate_set_to_coverage(jgates.cg_sqiswap())
    else:
        c, jc = port_pd, jax_pd[0]
    U = np.concatenate([_zoo(jgates), haar_sample(2000, seed=11)])
    got = cov.monodromy_ranges_batch(c, U, device=CPU)
    want = jcov.monodromy_ranges_batch(jc, U)
    assert [(k, p.operations) for k, p in got] == [(k, p.operations) for k, p in want]
    for u in U[:5]:
        k, p = cov.monodromy_range_from_target(c, u, device=CPU)
        jk, jp = jcov.monodromy_range_from_target(jc, u)
        assert (k, p.operations) == (jk, jp.operations)
    if which == "sqiswap":
        assert [k for k, _ in got[:5]] == [0, 2, 3, 2, 2]


@pytest.mark.parametrize("which", ["sqiswap", "parallel"])
def test_cost_from_distribution_matches_jax(which, jax_pd, port_pd):
    """TemplateOptimizer.cost_from_distribution with a coverage-backed
    template (batched here, a loop over targets in the JAX package) gives
    the JAX package's sum, exactly."""
    U = haar_sample(500, seed=12)
    if which == "sqiswap":
        g, jg = gates.cg_sqiswap(), jgates.cg_sqiswap()
        jt = jmixed.MixedOrderBasisTemplate([jg])
    else:
        g = _pd()
        with pytest.MonkeyPatch.context() as mp:  # the JAX package's set from its build's directory
            mp.setattr(jconfig.config, "data_dir", jax_pd[1])
            jt = jmixed.MixedOrderBasisTemplate([_pd(jgates)])
    t = MixedOrderBasisTemplate([g], device=CPU)
    assert _coverage_rows(t.coverage) == _coverage_rows(jt.coverage)
    opt = TemplateOptimizer(lambda k: build_ansatz(cycle_gates([gates.SQISWAP], k)), device="cpu")
    jopt = joptimizer.TemplateOptimizer(lambda k: jtemplates.build_ansatz(jtemplates.cycle_gates([jgates.SQISWAP], k)))
    got = opt.cost_from_distribution(U, t)
    assert got == jopt.cost_from_distribution(U, jt)
    assert got == float(t.ks_for_batch(U).sum())


def test_smush_template_is_not_ported():
    with pytest.raises(NotImplementedError, match="smush_volume"):
        MixedOrderBasisTemplate([gates.cg_sqiswap()], smush=True, device=CPU)
