"""The port's cost functions, invariants and eigensolvers against the JAX
package's on the same numpy inputs made from a seed (CPU, f64).

Values and gradients of every ``COSTS`` entry agree to 1e-10: both packages
differentiate the same sequence of operations (the fixed-sweep Jacobi
rotations included), so only rounding separates them."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from slam_decomposition_tpu.models import gates as jgates
from slam_decomposition_tpu.ops import cplx as jcplx
from slam_decomposition_tpu.ops import eig as jeig
from slam_decomposition_tpu.ops import weyl as jweyl
from slam_decomposition_tpu.opt import costs as jcosts
from slam_decomposition_tpu.opt.samplers import haar_sample

from slam_decomposition_torch.ops import eig as teig
from slam_decomposition_torch.ops import weyl as tweyl
from slam_decomposition_torch.opt import costs as tcosts
from torch_threads import one_torch_thread  # noqa: F401  (torch on one intra-op thread)

ATOL = 1e-10
B = 6


def _pair(a):
    return jcplx.from_numpy(np.asarray(a))


def _leaf(a):
    """A complex tensor built from real leaves, and the leaves."""
    re = torch.tensor(np.real(a), dtype=torch.float64, requires_grad=True)
    im = torch.tensor(np.imag(a), dtype=torch.float64, requires_grad=True)
    return torch.complex(re, im), re, im


def test_cost_tables_have_the_jax_names():
    assert list(tcosts.COSTS) == list(jcosts.COSTS)
    assert list(tcosts.COSTS_3Q) == list(jcosts.COSTS_3Q)


@pytest.mark.parametrize("name", list(jcosts.COSTS))
def test_cost_and_gradient_match_jax(name):
    U, V = haar_sample(B, seed=11), haar_sample(B, seed=12)
    jfn = jax.vmap(jcosts.COSTS[name])
    want = np.asarray(jfn(_pair(U), _pair(V)))
    g_re, g_im = jax.grad(lambda u: jnp.sum(jfn(u, _pair(V))))(_pair(U))
    Ut, re, im = _leaf(U)
    got = tcosts.COSTS[name](Ut, torch.as_tensor(V))
    assert got.shape == (B,)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL)
    got.sum().backward()
    np.testing.assert_allclose(re.grad.numpy(), np.asarray(g_re), atol=ATOL)
    np.testing.assert_allclose(im.grad.numpy(), np.asarray(g_im), atol=ATOL)


def test_costs_broadcast_one_target_over_a_batch():
    U, V = haar_sample(B, seed=1), haar_sample(1, seed=2)[0]
    for name, fn in tcosts.COSTS.items():
        one = fn(torch.as_tensor(U), torch.as_tensor(V))
        many = fn(torch.as_tensor(U), torch.as_tensor(np.broadcast_to(V, U.shape).copy()))
        np.testing.assert_allclose(one.numpy(), many.numpy(), atol=1e-14, err_msg=name)


def test_makhlin_invariants_and_canonical_gate_match_jax():
    zoo = [jgates.CNOT, jgates.ISWAP, jgates.SWAP, jgates.IDENTITY2, jgates.berkeley(), jgates.SQISWAP]
    U = np.concatenate([np.stack([g.to_numpy() for g in zoo]), haar_sample(B, seed=3)])
    got = tweyl.g1g2g3(torch.as_tensor(U)).numpy()
    np.testing.assert_allclose(got, np.asarray(jweyl.g1g2g3(_pair(U))), atol=1e-12)
    np.testing.assert_allclose(got[:4], [[0, 0, 1], [0, 0, -1], [-1, 0, -3], [1, 0, 3]], atol=1e-12)
    c = np.random.default_rng(0).uniform(0, 0.5, (5, 3))
    np.testing.assert_allclose(
        tweyl.canonical_gate(torch.as_tensor(c)).numpy(), jcplx.to_numpy(jweyl.canonical_gate(jnp.asarray(c))), atol=1e-14
    )
    # an f32 coordinate gives a complex64 gate
    assert tweyl.canonical_gate(torch.as_tensor(c, dtype=torch.float32)).dtype == torch.complex64
    # the canonical gate of a target's coordinates is in its class
    back = tweyl.c1c2c3(tweyl.canonical_gate(tweyl.c1c2c3(torch.as_tensor(U))))
    np.testing.assert_allclose(back.numpy(), tweyl.c1c2c3(torch.as_tensor(U)).numpy(), atol=1e-9)


def test_joint_diag_out_of_place_is_the_in_place_one():
    """Autograd cannot see through the in-place rotations; the out-of-place
    variant multiplies by Givens matrices whose entries are c, s, 0 and 1
    exactly, so it repeats their arithmetic (1e-13: the order of the sums)."""
    M = tweyl.to_magic(tweyl.su4_normalize(torch.as_tensor(haar_sample(B, seed=5)))[0])
    m = M.transpose(-2, -1) @ M
    a = teig.joint_diag(m.real, m.imag)
    b = teig._joint_diag_out_of_place(m.real, m.imag, sweeps=12)
    for u, v in zip(a, b):
        np.testing.assert_allclose(u.numpy(), v.numpy(), atol=1e-13)
    # joint_diag goes out of place exactly when an input requires grad
    X = m.real.clone().requires_grad_(True)
    x, _, _ = teig.joint_diag(X, m.imag)
    x.sum().backward()
    assert torch.isfinite(X.grad).all()


def test_eigensolvers_match_jax():
    U = haar_sample(B, seed=7)
    th, V = teig.eig_unitary(torch.as_tensor(U))
    jth, jV = jeig.eig_unitary(_pair(U))
    np.testing.assert_allclose(th.numpy(), np.asarray(jth), atol=1e-12)
    np.testing.assert_allclose(V.numpy(), jcplx.to_numpy(jV), atol=1e-12)
    rec = V @ torch.diag_embed(torch.polar(torch.ones_like(th), th)) @ V.conj().transpose(-2, -1)
    np.testing.assert_allclose(rec.numpy(), U, atol=1e-12)
    H = haar_sample(B, n_qubits=3, seed=8)
    H = H + np.conj(np.swapaxes(H, 1, 2))
    w, W = teig.eigh_hermitian(torch.as_tensor(H))
    jw, jW = jeig.eigh_hermitian(_pair(H))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-12)
    np.testing.assert_allclose(W.numpy(), jcplx.to_numpy(jW), atol=1e-11)
    np.testing.assert_allclose(w.numpy(), np.linalg.eigvalsh(H), atol=1e-12)


def test_segment_distance_and_fractional_powers_match_jax():
    U, V = haar_sample(B, seed=21), haar_sample(B, seed=22)
    a, b = tcosts.b_to_sqswap_segment()
    ja, jb = jcosts.b_to_sqswap_segment()
    assert np.array_equal(a, ja) and np.array_equal(b, jb)
    np.testing.assert_allclose(
        tcosts.line_segment_distance(torch.as_tensor(U), a, b).numpy(),
        np.asarray(jcosts.line_segment_distance(_pair(U), ja, jb)), atol=ATOL,
    )
    np.testing.assert_allclose(
        tcosts.unitary_power(torch.as_tensor(U), 0.5).numpy(), jcplx.to_numpy(jcosts.unitary_power(_pair(U), 0.5)), atol=ATOL
    )
    half = tcosts.unitary_power(torch.as_tensor(U), 0.5)
    np.testing.assert_allclose((half @ half).numpy(), U, atol=1e-12)
    for steps in (2, 3):
        np.testing.assert_allclose(
            tcosts.continuous_cost(torch.as_tensor(U), torch.as_tensor(V), steps).numpy(),
            np.asarray(jax.vmap(lambda u, v: jcosts.continuous_cost(u, v, steps))(_pair(U), _pair(V))), atol=ATOL,
        )
    # differentiable through the joint rotations
    Ut, re, _ = _leaf(U)
    tcosts.continuous_cost(Ut, torch.as_tensor(V)).sum().backward()
    assert torch.isfinite(re.grad).all()
