"""Parity of the port's host and tensor modules with the JAX package on the
same numpy inputs (samplers, gates, templates, Weyl coordinates, coverage).

JAX stays on the CPU (tests/conftest.py) in f64; data crosses as numpy."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from slam_decomposition_tpu.coverage import coverage as jcov
from slam_decomposition_tpu.models import gates as jgates
from slam_decomposition_tpu.models import templates as jtemplates
from slam_decomposition_tpu.ops import cplx as jcplx
from slam_decomposition_tpu.ops import su2 as jsu2
from slam_decomposition_tpu.ops import weyl as jweyl
from slam_decomposition_tpu.opt import samplers as jsamplers

from slam_decomposition_torch.convert import chain_gates_from_numpy, coverage_from_jax_pickle
from slam_decomposition_torch.coverage import coverage as tcov
from slam_decomposition_torch.models import gates as tgates
from slam_decomposition_torch.models import templates as ttemplates
from slam_decomposition_torch.ops import su2 as tsu2
from slam_decomposition_torch.ops import weyl as tweyl
from slam_decomposition_torch.opt import samplers as tsamplers

# f64 on both sides: agreement is rounding-level; 1e-12 leaves ~1000 ulp of
# room for the different operation order of two eager / XLA pipelines
ATOL = 1e-12


def test_haar_sample_bit_identical():
    for seed in (0, 456):
        a = jsamplers.haar_sample(64, seed=seed)
        b = tsamplers.haar_sample(64, seed=seed)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_u3_matches_jax():
    ang = np.random.default_rng(1).uniform(-7, 7, (3, 50))
    want = jcplx.to_numpy(jsu2.u3(*[jnp.asarray(a) for a in ang]))
    got = tsu2.u3(*[torch.as_tensor(a) for a in ang]).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("k", [2, 3])
def test_eval_fn_and_chain_gates_match_jax(k):
    ja = jtemplates.build_ansatz(jtemplates.cycle_gates([jgates.SQISWAP], k))
    ta = ttemplates.build_ansatz(ttemplates.cycle_gates([tgates.SQISWAP], k))
    assert ta.n_params == ja.n_params == 6 * (k + 1)
    np.testing.assert_allclose(ta.chain_gates, ja.chain_gates, atol=ATOL)
    x = np.random.default_rng(k).uniform(0, 2 * np.pi, (32, ja.n_params))
    want = jcplx.to_numpy(jax.vmap(ja.eval_fn)(jnp.asarray(x)))
    got = ta.eval_fn(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    # the kernels' gate input round-trips from either package's numpy
    assert torch.equal(chain_gates_from_numpy(ja.chain_gates), torch.as_tensor(ta.chain_gates))


def test_unsupported_template_options_raise():
    # build_ansatz takes every option now; what both packages still refuse
    # is a parameterized gate on more than 2 qubits (the JAX package raises
    # when the template is first evaluated, the port when it is built)
    for kw in ({"vz_only": True}, {"no_exterior_1q": True}, {"n_qubits": 3}):
        ttemplates.build_ansatz(ttemplates.cycle_gates([tgates.SQISWAP], 2), **kw)
    with pytest.raises(NotImplementedError):
        ttemplates.build_ansatz_v2(lambda q, dtype: None, n_gate_params=2, k=1, n_qubits=3)
    ja = jtemplates.build_ansatz_v2(lambda q, dtype: None, n_gate_params=2, k=1, n_qubits=3)
    with pytest.raises(NotImplementedError):
        ja.eval_fn(jnp.zeros(ja.n_params))


def test_cg_sqiswap_matches_jax():
    jg, tg = jgates.cg_sqiswap(), tgates.cg_sqiswap()
    assert str(jg) == str(tg) and jg.cost() == tg.cost()
    np.testing.assert_allclose(tg.to_numpy(), jg.to_numpy(), atol=ATOL)
    np.testing.assert_allclose(tgates.SQISWAP.to_numpy(), jgates.SQISWAP.to_numpy(), atol=ATOL)


def test_monodromy_coords_match_jax():
    zoo = [
        jgates.riswap(0.5).to_numpy(),
        jgates.CNOT.to_numpy(),
        jgates.SWAP.to_numpy(),
        np.eye(4, dtype=complex),
        jgates.berkeley().to_numpy(),
    ]
    U = np.concatenate([jsamplers.haar_sample(512, seed=7), np.stack(zoo)])
    want = np.asarray(jax.jit(jweyl.monodromy_coords)(jcplx.from_numpy(U)))
    got = tweyl.monodromy_coords(torch.as_tensor(U)).numpy()
    # joint Jacobi in a different operation order: eigenphases agree to
    # ~1e-13; 1e-9 is the k-assignment's identity tolerance
    np.testing.assert_allclose(got, want, atol=1e-9)


@pytest.fixture(scope="module")
def coverages():
    return jcov.gate_set_to_coverage(jgates.cg_sqiswap()), tcov.load_coverage(tgates.cg_sqiswap())


def test_coverage_rows_match_jax(coverages):
    jc, tc = coverages
    assert [c.operations for c in jc] == [c.operations for c in tc]
    assert [c.cost for c in jc] == [c.cost for c in tc]
    for a, b in zip(jc, tc):
        a.contains_float(np.zeros((1, 3)))
        rows_j, rows_t = a._float_rows, b.float_rows()
        assert len(rows_j) == len(rows_t)
        for (ij, ej), (it, et) in zip(rows_j, rows_t):
            assert np.array_equal(ij, it) and np.array_equal(ej, et)
    # the loader is the pickle remap itself
    loaded = coverage_from_jax_pickle(tcov.coverage_path(tgates.cg_sqiswap()))
    assert type(loaded[1]).__module__ == "slam_decomposition_torch.coverage.coverage"


def test_ks_match_jax(coverages):
    jc, tc = coverages
    T = jsamplers.haar_sample(2048, seed=456)
    want = jcov.monodromy_ks_batch(jc, T)
    got = tcov.monodromy_ks_batch(tc, T, device="cpu")
    assert np.array_equal(got, want)


def test_ks_of_degenerate_classes(coverages):
    jc, tc = coverages
    zoo = np.stack(
        [np.eye(4, dtype=complex), jgates.riswap(0.5).to_numpy(), jgates.CNOT.to_numpy(),
         jgates.SWAP.to_numpy(), jgates.berkeley().to_numpy()]
    )
    got = tcov.monodromy_ks_batch(tc, zoo, device="cpu")
    assert np.array_equal(got, jcov.monodromy_ks_batch(jc, zoo))
    assert got[0] == 0 and got[1] == 1 and got[3] == 3
