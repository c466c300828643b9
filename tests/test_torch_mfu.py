"""The port's flop model reckons the same work as the JAX package's
(pure arithmetic), and its launch bounds follow from it."""

import pytest

from slam_decomposition_tpu.utils import mfu as jmfu

from slam_decomposition_torch.utils import mfu


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_flop_counts_match_jax(k):
    assert mfu.chain_flops(k) == jmfu.chain_flops(k)
    assert mfu.adam_iter_flops(k) == jmfu.adam_iter_flops(k)
    assert mfu.lm_iter_flops(k) == jmfu.lm_iter_flops(k)
    assert mfu.lm_iter_flops(k, df64_residual=True) == jmfu.lm_iter_flops(k, df64_residual=True)
    for cert in ("df64", "f64"):
        assert mfu.solve_flops_per_target(k, 4, cert=cert) == jmfu.solve_flops_per_target(k, 4, cert=cert)


@pytest.mark.parametrize("k", [2, 3, 4])
def test_launch_bounds(k):
    a = mfu.adam_launch(k, 40000, 100)
    assert a["flops"] == 40000 * 100 * mfu.adam_iter_flops(k) and a["bound_by"] == "operations"
    assert a["bound_ms"] == pytest.approx(1e3 * a["flops"] / mfu.F32_PEAK)
    # the launch charges J by prefix / suffix products and A's upper
    # triangle, less than the JAX count's forward-mode J and full A
    n = 6 * (k + 1)
    rebuild = mfu.suffix_flops(k) + n * mfu.JAC_COLUMN_FLOPS + 32 * n * (n + 1) + 64 * n
    assert mfu.lm_rebuild_flops(k) == rebuild
    jax_rebuild = mfu.lm_iter_flops(k) - (n + 8) * (2 * n * n + 6 * n) - mfu.chain_flops(k)
    assert rebuild < 0.5 * jax_rebuild
    lm = mfu.lm_launch(k, 40000, 8)
    assert lm["flops"] == pytest.approx(40000 * (8 * (mfu.lm_iter_flops(k) - jax_rebuild + rebuild) + mfu.chain_flops(k)))
    assert mfu.lm_launch(k, 40000, 8, fresh=3)["flops"] < lm["flops"]
    # the polish's residuals are charged at the f64 rate
    p = mfu.polish_launch(k, 10000, 6)
    f64 = 10000 * 7 * mfu.chain_flops(k)
    assert p["bound_ms"] == pytest.approx(1e3 * ((p["flops"] - f64) / mfu.F32_PEAK + f64 / mfu.F64_PEAK))


def test_jacobian_column_count():
    """One column of J from P_i and S_i: two u3 factors (20), per column of
    P_i the Kronecker factors (112), S_i times it (120) and the trace (32),
    then the phase term (134); the suffix chain 580 per gate."""
    assert mfu.JAC_COLUMN_FLOPS == 20 + 4 * (112 + 120 + 32) + 134 == 1210
    assert mfu.suffix_flops(2) == 1160 and mfu.suffix_flops(3) == 1740


def test_counts_at_every_kernel_depth():
    """The per-lane counts of the depths the kernels are instantiated for,
    pinned: (forward chain, Adam step, J / A / b rebuild)."""
    want = {1: (1080, 3400.0, 20860), 2: (1916, 5956.0, 35036), 3: (2752, 8512.0, 51516), 4: (3588, 11068.0, 70300)}
    for k, (chain, adam, rebuild) in want.items():
        assert (mfu.chain_flops(k), mfu.adam_iter_flops(k), mfu.lm_rebuild_flops(k)) == (chain, adam, rebuild)
    # the bound of a launch grows with the depth and is by operations at every one
    bounds = [mfu.lm_launch(k, 40000, 8)["bound_ms"] for k in want]
    assert bounds == sorted(bounds) and all(mfu.polish_launch(k, 10000, 6)["bound_by"] == "operations" for k in want)


def test_eigenphase_launch_bound():
    b = mfu.gamma_eigenphases_launch(100000)
    assert b["flops"] == 100000 * mfu.GAMMA_FLOPS and b["bytes"] == 100000 * 288
    assert b["bound_by"] == "operations" and b["bound_ms"] == pytest.approx(1e3 * b["flops"] / mfu.F64_PEAK)
