"""The port's parallel-drive extended coverage (explore/smush_volume.py)
and the smush branch of MixedOrderBasisTemplate on the CPU, against the
JAX package: its random draws bit for bit (ops/threefry.py against
jax.random), the k-cycle circuits' coordinates and the targeted descents at
1e-9, the rational hull row for row, the cached extended sets and the
depths they give. The full extend_coverage runs on the card in
chip_smoke.py."""

import json
from fractions import Fraction

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from slam_decomposition_tpu.coverage import mixed as jmixed
from slam_decomposition_tpu.explore import smush_volume as jsv
from slam_decomposition_tpu.models import gates as jgates

from slam_decomposition_torch.coverage.mixed import MixedOrderBasisTemplate
from slam_decomposition_torch.explore import smush_volume as sv
from slam_decomposition_torch.models import gates
from slam_decomposition_torch.ops import threefry
from slam_decomposition_torch.opt.samplers import haar_sample

CPU = "cpu"


@pytest.mark.parametrize("seed,shape,lo,hi", [
    (0, (5,), 0.0, 1.0), (109, (5, 6, 22), -4 * np.pi, 4 * np.pi), (7926, (1000, 26), -2 * np.pi, 2 * np.pi),
    (2**33 + 5, (3, 7), -1.0, 1.0),
])
def test_threefry_uniform_is_jax_random(seed, shape, lo, hi):
    want = jax.random.uniform(jax.random.PRNGKey(seed), shape, dtype=jnp.float64, minval=lo, maxval=hi)
    assert np.array_equal(threefry.uniform(seed, shape, lo, hi), np.asarray(want))
    bits = jax.random.bits(jax.random.PRNGKey(seed), shape, dtype=jnp.uint64)
    assert np.array_equal(threefry.random_bits64(seed, shape), np.asarray(bits))


@pytest.mark.parametrize("name,k", [("iSwap", 1), ("CNOT", 2)])
def test_sample_coords_against_jax(name, k):
    """sample_smush_coords at the JAX package's seed (three drive scales,
    40 samples, the same draws): the same Weyl coordinates to 1e-9."""
    gc, gg, t, _ = sv.NAMED_GATES[name]
    got = sv.sample_smush_coords(gc, gg, t, k, n_samples=40, seed=11, device=CPU)
    want = jsv.sample_smush_coords(gc, gg, t, k, n_samples=40, seed=11)
    assert got.shape == want.shape == (40, 3)
    assert np.abs(got - want).max() <= 1e-9


def test_targeted_coords_against_jax():
    """The JAX test's targeted descents (iSwap, k = 1, 2 restarts, 40
    iterations, seed 3, the same starts): every iterate's coordinates to
    1e-9, finite, in the chamber, and the CNOT-bound descents close in on
    CNOT."""
    gc, gg, t, _ = sv.NAMED_GATES["iSwap"]
    cs = sv.targeted_smush_coords(gc, gg, t, 1, restarts=2, iters=40, seed=3, device=CPU)
    want = jsv.targeted_smush_coords(gc, gg, t, 1, restarts=2, iters=40, seed=3)
    assert cs.shape == want.shape == (5 * 2 * 41, 3)
    assert np.abs(cs - want).max() <= 1e-9
    assert np.isfinite(cs).all()
    assert (cs >= -1e-9).all() and (cs[:, 0] <= 1 + 1e-9).all()
    assert np.linalg.norm(cs - np.array([0.5, 0.0, 0.0]), axis=1).min() < 0.05
    # targeted_coords_from, the descent from given starts
    x0s = threefry.uniform(3, (5, 2, sv._smush_eval(gc, gg, t, 1)[1]), -4 * np.pi, 4 * np.pi)
    assert np.array_equal(sv.targeted_coords_from(gc, gg, t, 1, torch.as_tensor(x0s), iters=40), cs)


def test_targeted_smush_coords_shape():
    cs = sv.targeted_smush_coords(np.pi / 2, 0.0, 0.5, 2, restarts=1, iters=3, seed=1, device=CPU)
    assert cs.shape == (5 * 1 * 4, 3) and np.isfinite(cs).all()


def test_rational_hull_equals_jax_row_for_row():
    pts = np.random.default_rng(0).uniform(0, 0.3, size=(40, 3))
    hull, jhull = sv.rational_hull(pts), jsv.rational_hull(pts)
    assert (hull.inequalities, hull.equalities, hull.name) == (jhull.inequalities, jhull.equalities, jhull.name)
    for p in pts:
        assert hull.contains([Fraction(float(x)).limit_denominator(10**6) for x in p], Fraction(1, 10**6))


@pytest.mark.parametrize("name", sorted(sv.NAMED_GATES))
def test_cached_extended_sets_and_scores_equal_jax(name):
    gc, gg, t, _ = sv.NAMED_GATES[name]
    g = gates.cg_canonicalize(gates.conversion_gain_gate(0, 0, gc, gg, t))
    jg = jgates.cg_canonicalize(jgates.conversion_gain_gate(0, 0, gc, gg, t))
    cov, jcov = sv.load_smush_coverage(g), jsv.load_smush_coverage(jg)
    assert [(c.operations, c.cost) for c in cov] == [(c.operations, c.cost) for c in jcov]
    assert [
        [(p.inequalities, p.equalities) for p in c.polytope.convex_subpolytopes] for c in cov
    ] == [[(p.inequalities, p.equalities) for p in c.polytope.convex_subpolytopes] for c in jcov]
    assert sv.smush_scores((0, 0, gc, gg, t)) == jsv.smush_scores((0, 0, gc, gg, t))


def test_smush_template_depths_equal_jax():
    """MixedOrderBasisTemplate(smush=True) on the iSwap extended set: the
    depths of haar_sample(200, seed=5) equal the JAX package's."""
    U = haar_sample(200, seed=5)
    t = MixedOrderBasisTemplate([gates.cg_iswap()], smush=True, device=CPU)
    jt = jmixed.MixedOrderBasisTemplate([jgates.cg_iswap()], smush=True)
    ks = t.ks_for_batch(U)
    assert np.array_equal(ks, np.asarray(jt.ks_for_batch(U)))
    assert set(np.unique(ks)) <= {1, 2, 3}


def test_missing_extended_set_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(sv, "data_dir", lambda: tmp_path)
    monkeypatch.setattr(sv, "coverage_cache_dir", lambda: tmp_path)
    with pytest.raises(ValueError, match="extend_coverage"):
        sv.load_smush_coverage(gates.cg_canonicalize(gates.cg_iswap()))
    assert sv.smush_scores((0, 0, np.pi / 2, 0.0, 1.0)) is None


def test_extend_coverage_writes_the_build_directory(monkeypatch, tmp_path):
    """A small B run (k = 1 sampled, k = 2 the bare set): rows of the JAX
    package's form, written to the build directory (never to the JAX
    package's data) and read back by load_smush_coverage / smush_scores.
    The Monte-Carlo volume runs on 4000 Haar samples here, not 200000
    (their coordinates take ~2 minutes on this CPU)."""
    from slam_decomposition_torch.coverage import haar

    data = tmp_path / "data"
    data.mkdir()
    monkeypatch.setattr(sv, "data_dir", lambda: data)
    monkeypatch.setattr(sv, "coverage_cache_dir", lambda: tmp_path / "build")
    mc_volume = haar.mc_volume
    monkeypatch.setattr(haar, "mc_volume", lambda poly, device=None: mc_volume(poly, n=4000, device=device))
    res = sv.extend_coverage("B", n_samples=300, targeted=False, device=CPU)
    assert sorted(res) == ["1", "2"] and res["2"] == [1.0, 1.0, True, True, True]
    base, ext, *flags = res["1"]
    assert base == 0.0 and 0.0 < ext < 1.0 and all(isinstance(f, bool) for f in flags)
    assert not list(data.iterdir())
    g = gates.cg_canonicalize(gates.cg_b())
    cov = sv.load_smush_coverage(g)
    assert [c.operations for c in cov] == [[], ["B"], ["B", "B"]]
    haar, cnot, swap = sv.smush_scores((0, 0, 3 * np.pi / 8, np.pi / 8, 1.0))
    assert abs(haar - (ext + 2 * (1 - ext))) <= 1e-12 and swap == 2
    assert json.loads((tmp_path / "build" / "extended_results.json").read_text()) == {"B": res}


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(sv.NAMED_GATES))
def test_extend_coverage_reproduces_extended_results(name):
    """The full pipeline on the CPU (~10-80 s a gate, plus ~2 minutes once
    for mc_volume's Haar coordinates): from the JAX package's own draws,
    every row of extended_results.json, flags equal and volumes to 1e-6."""
    want = json.loads((sv.data_dir() / "extended_results.json").read_text())[name]
    got = sv.extend_coverage(name, save=False, device=CPU)
    assert sorted(got) == sorted(want)
    for k, row in want.items():
        assert got[k][2:] == row[2:], (k, got[k], row)
        assert np.abs(np.array(got[k][:2]) - row[:2]).max() <= 1e-6, (k, got[k], row)
