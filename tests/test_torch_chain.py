"""The plain versions of the three chain kernels against the JAX solver's
own phases (make_solver(adam_backend="xla")), on the same numpy inputs,
plus the wrappers' CPU routing and argument checks.

The CUDA kernels themselves are compared with these plain versions on the
card (tests/test_torch_kernels.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from slam_decomposition_tpu.models import gates as jgates
from slam_decomposition_tpu.models import templates as jtemplates
from slam_decomposition_tpu.ops import cplx as jcplx
from slam_decomposition_tpu.opt.gauss_newton import make_solver as jmake_solver
from slam_decomposition_tpu.ops.pallas_chain import make_adam_chain as jmake_adam_chain
from slam_decomposition_tpu.opt.samplers import haar_sample

from slam_decomposition_torch.ops import chain_kernels as ck
from slam_decomposition_torch.opt.gauss_newton import certificate

L = 16


def _setup(k, seed):
    ja = jtemplates.build_ansatz(jtemplates.cycle_gates([jgates.SQISWAP], k))
    js = jmake_solver(ja.eval_fn, ja.n_params, chain_gates=ja.chain_gates, adam_backend="xla")
    T = haar_sample(L, seed=seed)
    x0 = np.random.default_rng(seed).uniform(0, 2 * np.pi, (L, ja.n_params))
    g64 = torch.as_tensor(ja.chain_gates)
    return ja, js, T, x0, g64


def _sumsq(x, T, g64):
    r = ck.phase_residual(torch.as_tensor(np.asarray(x, np.float64)), torch.as_tensor(T), g64)
    return (r * r).sum(-1).numpy()


@pytest.mark.parametrize("k", [2, 3])
def test_plain_adam_matches_jax_adam_segment(k):
    ja, js, T, x0, g64 = _setup(k, 3)
    x32 = x0.astype(np.float32)
    t32 = jcplx.from_numpy(T, dtype=jnp.float32)
    z = jnp.zeros_like(jnp.asarray(x32))
    want, _, _ = jax.jit(js.adam_segment(25))(jnp.asarray(x32), z, z, jnp.float32(0.0), t32[0], t32[1])
    sched = ck.adam_schedule(100)[:25].contiguous()
    got = ck.adam_chain(torch.as_tensor(x32), torch.as_tensor(T).to(torch.complex64), g64.to(torch.complex64), sched)
    # identical math modulo f32 association; 25 steps keep the drift tiny
    # (the JAX Pallas kernel's own interpret-mode bound)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)


def test_plain_adam_with_cost_matches_jax_kernel_with_cost():
    """The JAX kernel's with_cost output, run as the JAX package's own test
    runs it on the CPU (interpret mode, 8 sublanes, 25 steps at k=2), against
    the port's (x, cost) on the same inputs: x within the 25-step f32 drift
    (5e-5), the cost within 2e-6 of the JAX kernel's (its own test's bound)
    and equal to the plain square cost of the returned x."""
    ja, _, T, x0, g64 = _setup(2, 4)
    x32 = x0[:8].astype(np.float32)
    t32 = jcplx.from_numpy(T[:8], dtype=jnp.float32)
    run = jmake_adam_chain(ja.chain_gates, adam_iters=25, interpret=True, sublanes=8, with_cost=True)
    xj, fj = run(jnp.asarray(x32), t32[0], t32[1])
    T32 = torch.as_tensor(T[:8]).to(torch.complex64)
    g32 = g64.to(torch.complex64)
    xt, ft = ck.adam_chain(torch.as_tensor(x32), T32, g32, ck.adam_schedule(25), with_cost=True)
    assert ft.shape == (8,) and ft.dtype == torch.float32
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=5e-5)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), atol=2e-6)
    assert torch.equal(ft, ck.square_cost(xt, T32, g32))
    # without the flag the wrapper returns x alone, the same x
    assert torch.equal(ck.adam_chain(torch.as_tensor(x32), T32, g32, ck.adam_schedule(25)), xt)


@pytest.mark.parametrize("k", [2, 3])
def test_plain_adam_with_cost_is_the_cost_of_the_default_x(k):
    """On CPU tensors the wrapper's with_cost returns the x it returns
    without the flag, and the f32 square cost of that x, after the full
    100-step schedule."""
    _, _, T, x0, g64 = _setup(k, 6)
    x32, T32, g32 = torch.as_tensor(x0, dtype=torch.float32), torch.as_tensor(T).to(torch.complex64), g64.to(torch.complex64)
    x, cost = ck.adam_chain(x32, T32, g32, ck.adam_schedule(100), with_cost=True)
    assert torch.equal(x, ck.adam_chain(x32, T32, g32, ck.adam_schedule(100)))
    assert cost.shape == (L,) and cost.dtype == torch.float32
    assert torch.equal(cost, ck.square_cost(x, T32, g32))
    # Adam has lowered the cost of most lanes
    assert (cost < ck.square_cost(x32, T32, g32)).float().mean().item() >= 0.9


@pytest.mark.parametrize("k", [2, 3])
def test_kernel_inputs_are_seeded_at_the_solver_shapes(k):
    """The set-up shared by the card scripts: same seeds, same data; shapes
    and types as the wrappers ask for them."""
    from slam_decomposition_torch.tools.inputs import kernel_inputs

    a, b = kernel_inputs(k, 8, 4, "cpu"), kernel_inputs(k, 8, 4, "cpu")
    assert all(torch.equal(a[key], b[key]) for key in a)
    n = 6 * (k + 1)
    assert a["x0"].shape == (32, n) and a["x0"].dtype == torch.float32
    assert 0.0 <= a["x0"].min().item() and a["x0"].max().item() < 2 * np.pi + 1e-6
    assert a["T"].shape == (8, 4, 4) and a["T"].dtype == torch.complex128
    assert torch.equal(a["lanes_t"][4:8], a["T"][1].to(torch.complex64).expand(4, 4, 4))
    assert a["g64"].shape == (k, 4, 4) and a["g32"].dtype == torch.complex64
    x, f = ck.lm_chain(a["x0"], a["lanes_t"], a["g32"], 1)  # the wrappers take them as they are
    assert x.shape == a["x0"].shape and f.shape == (32,)


def test_best_restart_takes_the_smallest_residual_per_target():
    from slam_decomposition_torch.tools.inputs import best_restart

    xl = torch.arange(24, dtype=torch.float32).view(6, 4)  # 2 targets x 3 restarts
    fl = torch.tensor([3.0, 1.0, 2.0, 0.5, 4.0, 0.7])
    got = best_restart(xl, fl, 3)
    assert got.dtype == torch.float64 and torch.equal(got, xl[[1, 3]].double())


@pytest.mark.parametrize("k", [2, 3])
def test_plain_lm_matches_jax_f32_lm(k):
    ja, js, T, x0, g64 = _setup(k, 5)
    T32 = torch.as_tensor(T).to(torch.complex64)
    g32 = g64.to(torch.complex64)
    xa = ck.adam_chain(torch.as_tensor(x0, dtype=torch.float32), T32, g32, ck.adam_schedule(100))
    want = np.asarray(jax.jit(lambda x, t: js.polish(x, t, iters=8))(
        jnp.asarray(xa.numpy()), jcplx.from_numpy(T, dtype=jnp.float32)))
    got, f = ck.lm_chain(xa, T32, g32, 8)
    # ||r||^2 of both results; accept/reject decisions at the f32 floor may
    # differ, hence the JAX kernel test's bound: rtol 1e-3 / atol 1e-5 on
    # >= 99% of lanes (all 16 here)
    fj, ft = _sumsq(want, T, g64), _sumsq(got.numpy(), T, g64)
    assert np.isclose(ft, fj, rtol=1e-3, atol=1e-5).mean() >= 0.99
    # the returned f is the f32 ||r||^2 of the returned x
    np.testing.assert_allclose(f.numpy(), ft, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("k", [2, 3])
def test_plain_polish_matches_jax_f64_polish(k):
    ja, js, T, x0, g64 = _setup(k, 9)
    T32 = torch.as_tensor(T).to(torch.complex64)
    g32 = g64.to(torch.complex64)
    xa = ck.adam_chain(torch.as_tensor(x0, dtype=torch.float32), T32, g32, ck.adam_schedule(100))
    xl, _ = ck.lm_chain(xa, T32, g32, 8)
    x64 = xl.double()
    tj = jcplx.from_numpy(T)
    xj = jax.jit(js.polish)(jnp.asarray(x64.numpy()), tj)
    cj = np.asarray(js.certify(xj, tj))
    xt, f = ck.polish_chain(x64, torch.as_tensor(T), g64, 6)
    ct = certificate(f).numpy()
    assert ((ct <= 1e-10) == (cj <= 1e-10)).all()
    assert (ct <= 1e-10).sum() >= L // 4
    # the certificate is the true f64 square cost of the returned x
    true = ck.square_cost(xt, torch.as_tensor(T), g64).numpy()
    np.testing.assert_allclose(ct, true, atol=1e-13)
    # angles come back reduced mod 4 pi
    assert xt.abs().max() <= 2 * np.pi + 1e-12


def test_wrappers_route_cpu_tensors_to_plain_versions():
    _, _, T, x0, g64 = _setup(2, 1)
    ck.reset_launch_counts()
    x32 = torch.as_tensor(x0, dtype=torch.float32)
    T32 = torch.as_tensor(T).to(torch.complex64)
    sched = ck.adam_schedule(4)
    assert torch.equal(ck.adam_chain(x32, T32, g64.to(torch.complex64), sched),
                       ck.adam_chain_ref(x32, T32, g64.to(torch.complex64), sched))
    ck.lm_chain(x32, T32, g64.to(torch.complex64), 1)
    ck.polish_chain(x32.double(), torch.as_tensor(T), g64, 1)
    assert ck.launch_counts() == {"adam_chain": 0, "lm_chain": 0, "polish_chain": 0}


@pytest.mark.parametrize(
    "mutate, err",
    [
        (lambda x, t, g: (x.double(), t, g), TypeError),  # wrong dtype
        (lambda x, t, g: (x[:, :12].contiguous(), t, g), ValueError),  # n != 6(k+1)
        (lambda x, t, g: (x, t[:4].contiguous(), g), ValueError),  # lane count
        (lambda x, t, g: (x.t().contiguous().t(), t, g), ValueError),  # not contiguous
    ],
)
def test_wrapper_argument_checks(mutate, err):
    _, _, T, x0, g64 = _setup(2, 1)
    x, t, g = mutate(torch.as_tensor(x0, dtype=torch.float32), torch.as_tensor(T).to(torch.complex64),
                     g64.to(torch.complex64))
    with pytest.raises(err):
        ck.lm_chain(x, t, g, 1)
