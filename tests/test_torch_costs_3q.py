"""The port's 3Q entanglement-monotone costs against the JAX package's on the
same numpy unitaries made from a seed (CPU, f64): values to 1e-9."""

import numpy as np
import pytest
import torch
import jax

from slam_decomposition_tpu.ops import cplx as jcplx
from slam_decomposition_tpu.opt import costs as jcosts
from slam_decomposition_tpu.opt.samplers import haar_sample

from slam_decomposition_torch.opt import costs as tcosts
from torch_threads import one_torch_thread  # noqa: F401  (torch on one intra-op thread)


def _pair(a):
    return jcplx.from_numpy(np.asarray(a))


def test_3q_cost_table_has_the_jax_names():
    assert list(tcosts.COSTS_3Q) == list(jcosts.COSTS_3Q)


# the concurrence takes square roots of eigenvalues that are 0 up to rounding
# (a 2Q reduction of a pure 3Q state has rank 2): 1e-17 of noise becomes 3e-9
ATOL_3Q = {"entanglement_of_formation": 1e-6}


# every monotone on the W state; on GHZ the two whose JAX side is quick to trace
CASES = [(name, "w") for name in jcosts.COSTS_3Q] + [("mutual_information", "ghz"), ("mutual_information_square", "ghz")]


@pytest.mark.parametrize("name,state", CASES)
def test_3q_monotones_match_jax(name, state):
    U = haar_sample(4, n_qubits=3, seed=31)
    U[0] = np.eye(8)  # the prepared state itself
    want = np.asarray(jax.vmap(lambda u: jcosts.COSTS_3Q[name](u, state))(_pair(U)))
    got = tcosts.COSTS_3Q[name](torch.as_tensor(U), state).numpy()
    assert got.shape == (4,)
    np.testing.assert_allclose(got, want, atol=ATOL_3Q.get(name, 1e-9))
