"""The port's mesh (slam_decomposition_torch/parallel) on the CPU, mirroring
tests/test_parallel.py: 8 gloo ranks through ``run_ranks`` on a file store
in ``tmp_path``, against the port's unsharded solver and the JAX mesh on
conftest's 8 virtual devices.

The ranks run once for the module (``tools/mesh_readings.rank_readings``,
a function of the port, so no rank imports jax or this file); each test
reads its part of their readings. The JAX comparison allows 1 certified-set
flip of 16, the bound of tests/test_torch_solver.py."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from slam_decomposition_tpu.coverage.coverage import gate_set_to_coverage as jgate_set_to_coverage
from slam_decomposition_tpu.coverage.coverage import monodromy_ranges_batch as jmonodromy_ranges_batch
from slam_decomposition_tpu.models import gates as jgates
from slam_decomposition_tpu.models.templates import build_ansatz as jbuild_ansatz
from slam_decomposition_tpu.models.templates import cycle_gates as jcycle_gates
from slam_decomposition_tpu.ops import cplx as jcplx
from slam_decomposition_tpu.opt.samplers import haar_sample
from slam_decomposition_tpu.parallel.mesh import make_mesh as jmake_mesh
from slam_decomposition_tpu.parallel.mesh import sharded_solver_smap as jsharded_solver_smap

from slam_decomposition_torch.opt.gauss_newton import ChainSolver
from slam_decomposition_torch.parallel.launch import run_ranks
from slam_decomposition_torch.parallel.mesh import make_mesh, pad_to_multiple
from slam_decomposition_torch.tools.mesh_readings import rank_readings
from torch_threads import one_torch_thread  # noqa: F401  (torch on one intra-op thread)

N, RP = 8, 2  # dp = 4
N_PARAMS = 18  # the k = 2 chain


def _x0(B, R, seed):
    return np.random.default_rng(seed).uniform(0, 2 * np.pi, (B, R, N_PARAMS))


SOLVES = [
    # as test_parallel.py: B = 8 (2 targets a dp rank), R = 4 (2 restarts an rp rank)
    dict(name="gspmd", form="gspmd", k=2, x0s=_x0(8, 4, 7), T=haar_sample(8, seed=7), adam_iters=40, lm_iters=4),
    dict(name="smap", form="smap", k=2, x0s=_x0(8, 4, 11), T=haar_sample(8, seed=11), adam_iters=40, lm_iters=4,
         lm32_iters=4),
    # against the JAX mesh at the main path's counts
    dict(name="jax", form="smap", k=2, x0s=_x0(16, 4, 13), T=haar_sample(16, seed=13), adam_iters=100, lm_iters=6,
         lm32_iters=8),
]


def _ks_targets():
    T = haar_sample(16, seed=21)
    T[:4] = np.stack([np.eye(4), jgates.SWAP.to_numpy(), jgates.CNOT.to_numpy(), jgates.SQISWAP.to_numpy()])
    return T


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    store = tmp_path_factory.mktemp("mesh") / "store"
    return run_ranks(rank_readings, N, N, RP, "cpu", SOLVES, _ks_targets(), device="cpu", init_file=store,
                     timeout=600)


def _unsharded(solve, **iters):
    a = jbuild_ansatz(jcycle_gates([jgates.SQISWAP], solve["k"]))
    solver = ChainSolver(a.chain_gates, device="cpu", **iters)
    x, f = solver.solve(torch.as_tensor(solve["x0s"]), torch.as_tensor(solve["T"]))
    return x.numpy(), f.numpy()


def test_make_mesh_shape(ranks):
    for r, got in enumerate(ranks):
        assert got["rank"] == r
        assert got["shape"] == {"dp": 4, "rp": 2}
        assert got["axis_names"] == ("dp", "rp")
        assert got["index"] == (r // RP, r % RP)
        assert got["backend"] == "gloo" and got["device"] == "cpu"


def test_make_mesh_rejects_bad_rp(ranks):
    for got in ranks:
        assert got["errors"]["rp"].startswith("ValueError") and "not divisible" in got["errors"]["rp"]


def test_make_mesh_rejects_too_many_devices(ranks):
    for got in ranks:
        assert got["errors"]["devices"].startswith("RuntimeError")
        assert "requested 64 devices" in got["errors"]["devices"]
    # without a group only a one-rank mesh can start
    with pytest.raises(RuntimeError, match="requested 2 devices"):
        make_mesh(2, device="cpu")


def test_pad_to_multiple_roundtrip():
    arr = np.arange(10 * 3, dtype=np.float64).reshape(10, 3)
    padded, orig = pad_to_multiple(arr, 8, axis=0)
    assert padded.shape == (16, 3)
    assert orig == 10
    np.testing.assert_array_equal(padded[:orig], arr)
    np.testing.assert_array_equal(padded[orig:], np.repeat(arr[:1], 6, axis=0))
    padded2, orig2 = pad_to_multiple(arr[:8], 8, axis=0)
    assert padded2.shape == (8, 3) and orig2 == 8


@pytest.mark.parametrize("name, iters", [
    ("gspmd", dict(adam_iters=40, lm_iters=4)),
    ("smap", dict(adam_iters=40, lm_iters=4, lm32_iters=4)),
])
def test_sharded_solve_matches_unsharded(ranks, name, iters):
    """The dp x rp solve against the unsharded solver on the same inputs,
    with the same global result on every rank."""
    solve = next(s for s in SOLVES if s["name"] == name)
    x_ref, f_ref = _unsharded(solve, **iters)
    for got in ranks:
        x, f = got["solves"][name]["x"], got["solves"][name]["f"]
        assert x.shape == (8, N_PARAMS) and f.shape == (8,)
        np.testing.assert_allclose(f, f_ref, atol=1e-9)
        np.testing.assert_allclose(x, x_ref, atol=1e-6)


@pytest.mark.parametrize("name", ["gspmd", "smap", "jax"])
def test_each_rank_solves_its_shard(ranks, name):
    """Each rank's kernel wrappers get (B/dp)(R/rp) lanes for Adam and the LM
    and B/dp for the polish (the local winner's zero-iteration polish, then
    the polisher's), the counterpart of test_parallel.py's dp-sharded
    outputs."""
    B, R = SOLVES[[s["name"] for s in SOLVES].index(name)]["x0s"].shape[:2]
    Bl, Rl = B // (N // RP), R // RP
    for got in ranks:
        sh = got["solves"][name]["shards"]
        assert sh["x0s"] == (Bl, Rl, N_PARAMS) and sh["tgt"] == (Bl, 4, 4) and sh["out"] == (Bl, N_PARAMS)
        assert sh["lanes"] == {"adam_chain": [Bl * Rl], "lm_chain": [Bl * Rl], "polish_chain": [Bl, Bl]}
        assert sh["launches"] == {"adam_chain": 0, "lm_chain": 0, "polish_chain": 0}  # plain versions on the CPU


@pytest.fixture(scope="module")
def jax_smap():
    """The JAX mesh solve at the main path's counts, compiled once."""
    ja = jbuild_ansatz(jcycle_gates([jgates.SQISWAP], 2))
    mesh = jmake_mesh(N, rp=RP)
    return jsharded_solver_smap(ja, mesh, adam_iters=100, lm_iters=6, lm32_iters=8, chain_gates=ja.chain_gates)


def test_sharded_solve_against_the_jax_mesh(ranks, jax_smap):
    solve = next(s for s in SOLVES if s["name"] == "jax")
    _, fj = jax_smap(jnp.asarray(solve["x0s"]), jcplx.from_numpy(solve["T"]))
    fj = np.asarray(fj)
    for got in ranks:
        f = got["solves"]["jax"]["f"]
        flips = int(((f <= 1e-10) != (fj <= 1e-10)).sum())
        assert flips <= 1, f"{flips} of 16 targets certified by only one mesh"
    assert (fj <= 1e-10).sum() >= 8  # the comparison has certified targets to compare


def test_sharded_ks_matches_jax_ranges(ranks):
    """The mesh-sharded ks of 16 targets (identity, SWAP, CNOT and sqiSwap
    among them) equal the JAX package's k of each."""
    coverage = jgate_set_to_coverage(jgates.cg_sqiswap())
    ks_ref = np.array([k for k, _ in jmonodromy_ranges_batch(coverage, _ks_targets())])
    assert set(ks_ref[:4]) == {0, 3, 2, 1}
    for got in ranks:
        np.testing.assert_array_equal(got["ks"], ks_ref)


def test_decompose_haar_on_a_one_rank_mesh():
    """make_mesh(1) without a group starts one in this process; the mesh
    path's losses equal the unsharded call's bit for bit."""
    from slam_decomposition_torch.pipeline import decompose_haar

    plain = decompose_haar(B=32, chunk=32, restarts=4, seed=456, device="cpu")
    mesh = make_mesh(1, device="cpu")
    try:
        assert mesh.shape == {"dp": 1, "rp": 1} and mesh.backend == "gloo" and mesh.device.type == "cpu"
        meshed = decompose_haar(B=32, chunk=32, restarts=4, seed=456, mesh=mesh)
    finally:
        mesh.close()
    assert not torch.distributed.is_initialized()
    np.testing.assert_array_equal(meshed.losses, plain.losses)
    np.testing.assert_array_equal(meshed.ks, plain.ks)
    assert meshed.n_certified == 32


def test_a_failed_rank_raises_with_its_traceback(tmp_path):
    """A rank that raises (here: a mesh larger than its 2-rank group) makes
    run_ranks raise with that rank's error; the other rank is stopped."""
    with pytest.raises(RuntimeError, match="requested 3 devices"):
        run_ranks(rank_readings, 2, 3, 1, "cpu", device="cpu", init_file=tmp_path / "store", timeout=120)
