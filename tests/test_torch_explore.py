"""Parity of the port's explore layer with the JAX package: speed limits,
duration scaling, the candidate grid and database, winner selection, family
extension and the persistence helpers.

JAX stays on the CPU (tests/conftest.py); data crosses as numpy, and the
port runs on CPU tensors. The port writes its databases only under a
temporary directory here; the JAX package's data directory is read, never
written (the last test holds its bytes)."""

import hashlib
import shutil

import h5py
import numpy as np
import pytest

from slam_decomposition_tpu.config import config as jconfig
from slam_decomposition_tpu.coverage.coverage import gate_set_to_coverage as jgate_set_to_coverage
from slam_decomposition_tpu.explore import candidates as jcand
from slam_decomposition_tpu.explore import family as jfamily
from slam_decomposition_tpu.explore import scaling as jscaling
from slam_decomposition_tpu.explore import speed_limit as jsl
from slam_decomposition_tpu.explore import winners as jwinners
from slam_decomposition_tpu.models import gates as JG
from slam_decomposition_tpu.opt.samplers import haar_sample as jhaar_sample
from slam_decomposition_tpu.utils import persist as jpersist

from slam_decomposition_torch.config import JAX_DATA_DIR
from slam_decomposition_torch.coverage.coverage import gate_set_to_coverage
from slam_decomposition_torch.explore import candidates as cand
from slam_decomposition_torch.explore import family
from slam_decomposition_torch.explore import scaling
from slam_decomposition_torch.explore import speed_limit as sl
from slam_decomposition_torch.explore import winners
from slam_decomposition_torch.models import gates as G
from slam_decomposition_torch.utils import persist

CPU = "cpu"
ATOL = 1e-12

GOLDEN_SLF = {  # the published hardware speed limits (tests/test_explore.py)
    "iSwap": ((np.pi / 2, 0, 1), 1.0013),
    "sqiSwap": ((np.pi / 2, 0, 0.5), 0.5006),
    "CNOT": ((np.pi / 4, np.pi / 4, 1), 1.7835),
    "sqCNOT": ((np.pi / 4, np.pi / 4, 0.5), 0.8917),
    "B": ((3 * np.pi / 8, np.pi / 8, 1), 1.4067),
    "sqB": ((3 * np.pi / 8, np.pi / 8, 0.5), 0.7033),
}


@pytest.fixture
def port_db(tmp_path, monkeypatch):
    """The port's own database in a temporary directory; the JAX file is
    read where it is."""
    path = tmp_path / "slam_explore" / "cg_gates.h5"
    monkeypatch.setattr(cand, "H5_PATH", path)
    return path


@pytest.fixture
def jax_data_copy(tmp_path, monkeypatch):
    """The JAX package's data directory as a temporary copy, so that no
    JAX call can write into the real one."""
    copy = tmp_path / "jax_data"
    shutil.copytree(JAX_DATA_DIR, copy)
    monkeypatch.setattr(jconfig, "data_dir", copy)
    monkeypatch.setattr(jcand, "H5_PATH", copy / "cg_gates.h5")
    return copy


@pytest.mark.parametrize("name", list(GOLDEN_SLF))
def test_hardware_slf_golden_and_jax(name):
    (gc, gg, t), expect = GOLDEN_SLF[name]
    got = sl.speed_limited_cost(gc, gg, t, sl.hardware_sl)
    assert abs(got - expect) < 2e-4, (name, got, expect)
    assert got == pytest.approx(jsl.speed_limited_cost(gc, gg, t, jsl.hardware_sl), abs=ATOL)


def test_analytic_slfs():
    d = sl.speed_limited_cost(1.0, 1.0, 1.0, sl.squared_sl)
    assert abs(d - 1.0 / (np.pi / (2 * np.sqrt(2)) / 1.0)) < 0.01
    assert abs(sl.mid_sl(0.0) - np.pi / 2) < 1e-9
    assert abs(sl.mid_sl(np.pi / 2)) < 1e-9
    xs = np.linspace(0, np.pi / 2, 37)
    for f, jf in ((sl.mid_sl, jsl.mid_sl), (sl.squared_sl, jsl.squared_sl), (sl.hardware_sl, jsl.hardware_sl)):
        np.testing.assert_allclose(f(xs), jf(xs), atol=ATOL)
    for slf in ("mid", "squared", "hardware"):
        g = sl.speed_limited_gate(G.cg_b(), slf)
        assert g.duration == pytest.approx(jsl.speed_limited_gate(JG.cg_b(), slf).duration, abs=ATOL)


@pytest.mark.parametrize("method", ["linear", "bare", "mid", "squared", "hardware"])
def test_atomic_cost_scaling_matches_jax(method):
    params = (0, 0, np.pi / 4, np.pi / 4, 1.0)
    gate, scaled = scaling.atomic_cost_scaling(params, np.array([3.0]), "linear", 0.25)
    assert abs(float(scaled[0]) - 4.0) < 1e-9  # 3 * cost(=1) + (3+1) * 0.25
    for p in (params, (0, 0, 0.1, 0.7, 1.0), (0, 0, 0.0, np.pi / 2, 0.5)):
        scores = np.array([2.3, 3.0, 4.0])
        g, s = scaling.atomic_cost_scaling(p, scores, method, 0.25)
        jg, js = jscaling.atomic_cost_scaling(p, scores, method, 0.25)
        np.testing.assert_allclose(s, js, atol=ATOL)
        assert g.duration == pytest.approx(jg.duration, abs=ATOL) and str(g) == str(jg)


def test_build_gates_matches_jax():
    gates_, coords = cand.build_gates(device=CPU)
    jgates, jcoords = jcand.build_gates()
    assert [str(g) for g in gates_] == [str(g) for g in jgates]
    np.testing.assert_allclose(np.array([g.params for g in gates_]), np.array([g.params for g in jgates]), atol=ATOL)
    np.testing.assert_allclose(coords, jcoords, atol=ATOL)
    small, c5 = cand.build_gates(n_strength=5, n_mix=5, device=CPU)
    assert len(small) == len(c5) < 25  # mirror and duplicate entries removed


def _jax_rows():
    with h5py.File(JAX_DATA_DIR / "cg_gates.h5", "r") as hf:
        return {k: np.array(v) for k, v in hf["bare_cost"].items()}


# four candidates of the JAX file whose coverage sets are cached pickles
COLLECT_KEYS = [
    "2QGate(0.00000000, 0.39269908, 1.00000000)",
    "2QGate(0.00000000, 1.57079633, 1.00000000)",
    "2QGate(0.39269908, 0.39269908, 1.00000000)",
    "2QGate(0.03926991, 0.74612826, 1.00000000)",
]


def test_collect_data_rebuilds_the_jax_rows(port_db):
    rows = _jax_rows()
    gate_list = [G.conversion_gain_gate(*rows[k][0]) for k in COLLECT_KEYS]
    assert cand.collect_data(gate_list, device=CPU) == 4
    assert cand.collect_data(gate_list, device=CPU) == 0  # resume: every key is there
    with h5py.File(port_db, "r") as hf:
        got = {k: np.array(v) for k, v in hf["bare_cost"].items()}
    assert sorted(got) == sorted(COLLECT_KEYS)
    for k in COLLECT_KEYS:
        np.testing.assert_array_equal(got[k][0], rows[k][0])
        np.testing.assert_array_equal(got[k][1][1:], rows[k][1][1:])  # counts exact, padding
        assert got[k][1][0] == pytest.approx(rows[k][1][0], abs=ATOL)  # Haar score


def test_load_candidates_prefers_the_port_row(port_db):
    jrows = _jax_rows()
    assert len(cand.load_candidates()) == len(jrows) == 176  # the JAX file alone
    key = COLLECT_KEYS[0]
    port_db.parent.mkdir(parents=True)
    with h5py.File(port_db, "w") as hf:
        g = hf.require_group("bare_cost")
        g.create_dataset(key, data=np.array([list(jrows[key][0]), [9.0, 9.0, 9.0, -1, -1]]))
        g.create_dataset("2QGate(0.00000000, 0.00100000, 1.00000000)",
                         data=np.array([[0, 0, 0, 0.001, 1.0], [99.0, 99.0, 99.0, -1, -1]]))
    rows = cand.load_candidates()
    assert len(rows) == 177
    by = {tuple(np.round(p, 8)): s for p, s in rows}
    assert by[tuple(np.round(jrows[key][0], 8))][0] == 9.0
    jax_order = list(jcand.load_candidates())
    assert [tuple(p) for p, _ in rows if tuple(np.round(p, 8)) != (0, 0, 0, 0.001, 1.0)] == [
        tuple(p) for p, _ in jax_order
    ]


def _fake_bare_db(path):
    """Three synthetic bare candidates (tests/test_explore.py) as a
    ``bare_cost`` file at ``path``."""
    rows = [
        ((0, 0, np.pi / 4, np.pi / 4, 1.0), [2.2, 2.0, 3.0]),  # B family
        ((0, 0, 0.0, np.pi / 2, 1.0), [2.5, 2.0, 3.0]),  # iSwap family
        ((0, 0, 0.1, 0.7, 1.0), [3.1, 3.0, 3.0]),  # generic (non-family)
    ]
    path.parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(path, "w") as hf:
        g = hf.require_group("bare_cost")
        for params, scores in rows:
            g.create_dataset(G.cg_hash(params[2], params[3], params[4]),
                             data=np.array([list(params), list(scores) + [-1, -1]]))
    return rows


def test_cost_scaling_cache_and_pick_winner_lookup(tmp_path, port_db, monkeypatch):
    fake = tmp_path / "jax" / "cg_gates.h5"
    rows = _fake_bare_db(fake)
    monkeypatch.setattr(cand, "JAX_H5_PATH", fake)
    monkeypatch.setattr(jcand, "H5_PATH", str(tmp_path / "jax_copy.h5"))
    shutil.copy(fake, tmp_path / "jax_copy.h5")

    assert scaling.cost_scaling("linear", 0.25, device=CPU) == 3
    assert jscaling.cost_scaling("linear", 0.25) == 3
    cached = scaling.load_scaled("linear", 0.25)
    jcached = jscaling.load_scaled("linear", 0.25)
    assert cached is not None and len(cached) == 3
    for (p, s), (jp, js) in zip(cached, jcached):
        np.testing.assert_array_equal(p, jp)
        np.testing.assert_allclose(s, js, atol=ATOL)
    assert scaling.cost_scaling("linear", 0.25, device=CPU) == 0  # skip-resume
    with h5py.File(fake, "r") as hf:
        assert list(hf.keys()) == ["bare_cost"]  # the port wrote only its own file

    # pick_winner is now a pure lookup: the rescoring path is poisoned
    monkeypatch.setattr(winners, "load_candidates", lambda: (_ for _ in ()).throw(AssertionError("rescored!")))
    for metric in (0, 1, 2, (-1, 0.5)):
        g, _ = winners.pick_winner("linear_scaling_1q0.25", metric=metric, device=CPU)
        jg, _ = jwinners.pick_winner("linear_scaling_1q0.25", metric=metric)
        assert g.params == pytest.approx(jg.params, abs=ATOL)
    best = min(rows, key=lambda r: scaling.atomic_cost_scaling(r[0], np.array(r[1]), "linear", 0.25)[1][1])
    assert np.allclose(winners.pick_winner("linear_scaling_1q0.25", metric=1, device=CPU)[0].params, best[0])


def test_cost_scaling_resume_after_kill(tmp_path, port_db, monkeypatch):
    fake = tmp_path / "jax" / "cg_gates.h5"
    _fake_bare_db(fake)
    monkeypatch.setattr(cand, "JAX_H5_PATH", fake)
    assert scaling.cost_scaling("linear", 0.0, device=CPU) == 3
    group = scaling.scaled_group_name("linear", 0.0)
    with h5py.File(port_db, "a") as hf:
        del hf[group][list(hf[group].keys())[0]]
    assert scaling.cost_scaling("linear", 0.0, device=CPU) == 1  # only the missing row
    gate, scaled = scaling.cost_scaling("linear", 0.0, query_params=(0, 0, 0.1, 0.7, 1.0), device=CPU)
    np.testing.assert_allclose(scaled, np.array([3.1, 3.0, 3.0]) * gate.cost(), atol=ATOL)
    with pytest.raises(KeyError):
        scaling.cost_scaling("linear", 0.0, query_params=(0, 0, 0.2, 0.2, 1.0), device=CPU)
    assert scaling.scaled_group_name("hardware", 0.25, True, True) == "hardware_scaling_1q0.25_fam_smush"


GROUPS = ["linear_scaling_1q0.0", "linear_scaling_1q0.25", "hardware_scaling_1q0.25", "mid_scaling_1q0.1",
          "squared_scaling_1q0.25", "bare_scaling_1q0.0"]


def _port_score(group, metric, params, **kw):
    """The port's score of one candidate, as its pick_winner ranks."""
    method, d1q = cand.get_method_duration(group)
    row = {tuple(p): s for p, s in cand.load_candidates()}[tuple(params)]
    bare = row[metric] if not isinstance(metric, tuple) else metric[1] * row[1] + (1 - metric[1]) * row[2]
    kw.setdefault("device", CPU)
    return float(np.atleast_1d(scaling.atomic_cost_scaling(params, bare, method, d1q, metric=metric, **kw)[1])[0])


def _jax_score(group, metric, params, **kw):
    """The JAX package's score of one candidate, as its pick_winner ranks."""
    method, d1q = jcand.get_method_duration(group)
    row = {tuple(p): s for p, s in jcand.load_candidates()}[tuple(params)]
    bare = row[metric] if not isinstance(metric, tuple) else metric[1] * row[1] + (1 - metric[1]) * row[2]
    return float(np.atleast_1d(jscaling.atomic_cost_scaling(params, bare, method, d1q, metric=metric, **kw)[1])[0])


@pytest.mark.parametrize("group", GROUPS)
def test_pick_winner_matches_jax_over_the_metric_grid(group, port_db):
    for metric in (0, 1, 2, (-1, 0.47)):
        g, scaled = winners.pick_winner(group, metric=metric, device=CPU)
        jg, jscaled = jwinners.pick_winner(group, metric=metric)
        assert g.params == pytest.approx(jg.params, abs=ATOL), (group, metric)
        assert scaled.duration == pytest.approx(jscaled.duration, abs=ATOL)
        assert _port_score(group, metric, g.params) == pytest.approx(_jax_score(group, metric, jg.params), abs=ATOL)


def test_pick_winner_published_winners(port_db):
    g, scaled = winners.pick_winner("linear_scaling_1q0.0", metric=0, device=CPU)
    assert g.params == pytest.approx((0, 0, 0, 0.09817477, 1), abs=1e-8) and scaled.duration == 0.0625
    g, scaled = winners.pick_winner("linear_scaling_1q0.25", metric=0, device=CPU)
    assert g.params == pytest.approx((0, 0, 0.03926991, 0.74612826, 1), abs=1e-8)
    assert scaled.duration == 0.5
    assert _port_score("linear_scaling_1q0.25", 0, g.params) == pytest.approx(1.8524037105377018, abs=ATOL)


def test_pick_winner_smush_family_and_targets_match_jax(port_db, jax_data_copy):
    group = "linear_scaling_1q0.25"
    g, s = winners.pick_winner(group, metric=0, smush=True, device=CPU)
    jg, js = jwinners.pick_winner(group, metric=0, smush=True)
    assert g.params == pytest.approx(jg.params, abs=ATOL) and s.duration == pytest.approx(js.duration, abs=ATOL)
    for metric in (1, 2):
        g, s = winners.pick_winner(group, metric=metric, family_extension=True, device=CPU)
        jg, js = jwinners.pick_winner(group, metric=metric, family_extension=True)
        assert g.params == pytest.approx(jg.params, abs=ATOL) and s.duration == pytest.approx(js.duration, abs=ATOL)
        assert _port_score(group, metric, g.params, family_extension=True) == pytest.approx(
            _jax_score(group, metric, jg.params, family_extension=True), abs=ATOL)
    targets = list(jhaar_sample(3, seed=1)) + [G.CNOT.to_numpy()]
    g, s = winners.pick_winner(group, metric=-1, target_ops=targets, device=CPU)
    jg, js = jwinners.pick_winner(group, metric=-1, target_ops=targets)
    assert g.params == pytest.approx(jg.params, abs=ATOL) and s.duration == pytest.approx(js.duration, abs=ATOL)


@pytest.mark.parametrize("gg_frac", [8, 5])
def test_family_costs_batch_matches_jax(gg_frac):
    base = G.conversion_gain_gate(0, 0, 0, np.pi / gg_frac, 1.0)
    jbase = JG.conversion_gain_gate(0, 0, 0, np.pi / gg_frac, 1.0)
    swap = G.SWAP.to_numpy()
    targets = np.stack(list(jhaar_sample(6, seed=3)) + [G.CNOT.to_numpy(), swap, np.eye(4)])
    batch = family.family_costs_batch(base, targets, cost_1q=0.1, basis_factor=0.7, device=CPU)
    jbatch = jfamily.family_costs_batch(jbase, targets, cost_1q=0.1, basis_factor=0.7)
    np.testing.assert_allclose(batch, jbatch, atol=ATOL)
    cov = gate_set_to_coverage(G.cg_canonicalize(base), device=CPU)
    for i, t in enumerate(targets):
        plan, want = family.recursive_sibling_check(cov, base, t, cost_1q=0.1, basis_factor=0.7, device=CPU)
        assert batch[i] == pytest.approx(want, abs=ATOL)
    assert batch[-1] == 0.0


def test_family_extension_prefers_sibling():
    from slam_decomposition_torch.coverage.coverage import monodromy_range_from_target

    base = G.cg_canonicalize(G.conversion_gain_gate(0, 0, 0, np.pi / 8, 1.0))
    cov = gate_set_to_coverage(base, max_layers=8, device=CPU)
    plan, cost = family.recursive_sibling_check(cov, base, G.CNOT.to_numpy(), cost_1q=0.1, basis_factor=0.25,
                                                device=CPU)
    jbase = JG.cg_canonicalize(JG.conversion_gain_gate(0, 0, 0, np.pi / 8, 1.0))
    jplan, jcost = jfamily.recursive_sibling_check(
        jgate_set_to_coverage(jbase, max_layers=8), jbase, JG.CNOT.to_numpy(), cost_1q=0.1, basis_factor=0.25
    )
    assert cost == pytest.approx(jcost, abs=ATOL)
    assert [(str(g), k) for g, k in plan] == [(str(g), k) for g, k in jplan]
    direct_k, _ = monodromy_range_from_target(cov, G.CNOT.to_numpy(), CPU)
    assert cost <= (direct_k + 1) * 0.1 + direct_k * 0.25 + 1e-9


def test_persist_round_trips(tmp_path):
    rows = [[1.0, 2.0], [3.0], [4.0, 5.0, 6.0]]
    arr = persist.ragged_to_padded(rows)
    np.testing.assert_array_equal(arr, jpersist.ragged_to_padded(rows))
    assert persist.padded_to_ragged(arr) == rows == jpersist.padded_to_ragged(arr)
    assert persist.padded_to_ragged(persist.ragged_to_padded(rows, fill=-1.0), fill=-1.0) == rows
    p = persist.filename_encode("key", directory=tmp_path)
    assert p.name == f"{hashlib.sha1(b'key').hexdigest()}.pkl" == jpersist.filename_encode("key").name
    assert persist.pickle_load(p) == {} and persist.pickle_load(p, default=3) == 3
    persist.pickle_save(p, {"a": np.arange(3)})
    np.testing.assert_array_equal(persist.pickle_load(p)["a"], np.arange(3))
    j = tmp_path / "sub" / "x.json"
    persist.json_save(j, {"a": [1, 2]})
    assert persist.json_load(j) == {"a": [1, 2]} and persist.json_load(tmp_path / "none.json") == {}
    h = tmp_path / "d" / "x.h5"
    persist.h5_save(h, "g", "k", [1.0, 2.0])
    persist.h5_save(h, "g", "k", [3.0])  # kept: no overwrite
    np.testing.assert_array_equal(persist.h5_load_group(h, "g")["k"], [1.0, 2.0])
    persist.h5_save(h, "g", "k", [3.0], overwrite=True)
    np.testing.assert_array_equal(persist.h5_load_group(h, "g")["k"], [3.0])


def test_jax_database_bytes_unchanged_by_port_writes(tmp_path, port_db, monkeypatch):
    jax_file = JAX_DATA_DIR / "cg_gates.h5"
    before = hashlib.sha256(jax_file.read_bytes()).hexdigest()
    names_before = sorted(p.name for p in JAX_DATA_DIR.iterdir())
    rows = _jax_rows()
    assert cand.collect_data([G.conversion_gain_gate(*rows[COLLECT_KEYS[1]][0])], device=CPU) == 1
    assert scaling.cost_scaling("linear", 0.25, device=CPU) == 176  # the port's row stands for the JAX one
    assert scaling.cost_scaling("hardware", 0.0, device=CPU) == 176
    assert winners.pick_winner("linear_scaling_1q0.25", metric=0, device=CPU)[0].params == pytest.approx(
        (0, 0, 0.03926991, 0.74612826, 1), abs=1e-8)
    assert hashlib.sha256(jax_file.read_bytes()).hexdigest() == before
    assert sorted(p.name for p in JAX_DATA_DIR.iterdir()) == names_before
    with h5py.File(port_db, "r") as hf:
        assert sorted(hf.keys()) == ["bare_cost", "hardware_scaling_1q0.0", "linear_scaling_1q0.25"]


def test_hdf5_reader_equals_h5py(tmp_path):
    """utils.hdf5 reads what h5py writes (default format), without h5py:
    the JAX database, and a file with groups deep enough for a multi-level
    B-tree, integer and NaN-holding datasets."""
    from slam_decomposition_torch.utils import hdf5

    def both(path, group):
        got = hdf5.read_group(path, group)
        with h5py.File(path, "r") as hf:
            want = {k: np.array(v) for k, v in hf[group].items()}
        assert list(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v)
            assert got[k].dtype == v.dtype

    both(JAX_DATA_DIR / "cg_gates.h5", "bare_cost")
    path = tmp_path / "x.h5"
    rng = np.random.default_rng(0)
    with h5py.File(path, "a") as hf:
        for name in ("b", "a"):
            g = hf.require_group(name)
            for i in range(400):
                g.create_dataset(f"k{i:04d}", data=rng.random((2, 5)))
        hf["a"].create_dataset("ints", data=np.arange(5, dtype=np.int32))
        hf["a"].create_dataset("nan", data=np.array([np.nan, 1.0]))
        del hf["b"]["k0007"]
        hf.create_group("chunked").create_dataset("x", data=np.arange(8.0), chunks=(4,))
    both(path, "a")
    both(path, "b")
    with pytest.raises(KeyError):
        hdf5.read_group(path, "none")
    with pytest.raises(ValueError):
        hdf5.read_group(path, "chunked")
    with pytest.raises(OSError):
        hdf5.read_group(tmp_path / "missing.h5", "a")
