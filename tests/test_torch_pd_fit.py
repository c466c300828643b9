"""The port's fidelity-faithful parallel-drive substitution
(``transpile.passes.fit_substituted_pd``) on the CPU, against the JAX
package: per-lane pulse times in ``smush_u`` against ``jax.vmap`` at 1e-12,
zero gradients and Jacobian columns for the frozen time slots, the exact
path's circuits at 1e-12, the same blocks sent to the class fit, the JAX
package's fidelity cases (trace distance 1e-9 / 5e-9), and, ``slow``
(their JAX sides compile for minutes; the unmarked cases run the same port
code), the whole fit against the JAX package's at restarts=4 and the
fallback's solve against the JAX solver on QFT-64's distinct blocks. A
``cuda`` case runs ghz(3) on the card.

JAX stays on the CPU (tests/conftest.py); data crosses as numpy. On the
card's machine, which has no jax: ``python3 -m pytest
tests/test_torch_pd_fit.py -m cuda --noconftest``."""

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from slam_decomposition_tpu.models import hamiltonians as jham
    from slam_decomposition_tpu.ops import cplx as jcplx
    from slam_decomposition_tpu.opt import gauss_newton as jgn
    from slam_decomposition_tpu.transpile import passes as jpasses
except ImportError:  # the card's machine has no jax; the cuda case needs none (run it with -m cuda)
    jax = None

from slam_decomposition_torch.models import gates as G
from slam_decomposition_torch.models import hamiltonians as ham
from slam_decomposition_torch.ops import chain_kernels as ck
from slam_decomposition_torch.opt.gauss_newton import makhlin_residual
from slam_decomposition_torch.opt.samplers import haar_sample
from slam_decomposition_torch.transpile import ir, library, passes

CPU = "cpu"
PULSE_ATOL = 1e-12  # per-lane pulses against jax.vmap: the same expm up to rounding
CIRCUIT_ATOL = 1e-12  # the exact path's KAK-sandwich locals and pulses
THRESHOLD = 1e-9  # fit_substituted_pd's default


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one intra-op thread beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gdist(A, B):
    return 1 - abs(np.trace(B.conj().T @ A)) / A.shape[0]


def _ladder():
    c = ir.Circuit(3)
    c.cp(0.7, 0, 1)
    c.cp(1.1, 1, 2)
    c.cp(0.3, 0, 1)
    return c


def _cx_swap_cx():
    c = ir.Circuit(3)
    c.cx(0, 1)
    c.swap(1, 2)
    c.cx(0, 1)
    return c


def _local(rng):
    """A random product of two 1Q unitaries, (4, 4)."""
    z = rng.normal(size=(2, 2, 2)) + 1j * rng.normal(size=(2, 2, 2))
    return np.kron(np.linalg.qr(z[0])[0], np.linalg.qr(z[1])[0])


def _iswap_blocks(n, seed):
    """A 3-qubit circuit of n iSwap-class blocks (iSwap between random local
    layers) on alternating qubit pairs, so that each is its own block."""
    rng = np.random.default_rng(seed)
    c = ir.Circuit(3)
    for j in range(n):
        c.unitary(_local(rng) @ G.ISWAP.to_numpy() @ _local(rng), (0, 1) if j % 2 == 0 else (1, 2))
    return c


def _is_iswap_class(U):
    from slam_decomposition_torch.transpile.kak import kak_form

    return np.abs(kak_form(U).t - [np.pi / 4, np.pi / 4, 0.0]).max() < 1e-9


def _same_circuit(a, b, atol):
    assert [(o.name, o.qubits) for o in a.ops] == [(o.name, o.qubits) for o in b.ops]
    for x, y in zip(a.ops, b.ops):
        np.testing.assert_allclose(x.params, y.params, atol=atol)
        assert (x.matrix is None) == (y.matrix is None)
        if x.matrix is not None:
            np.testing.assert_allclose(x.matrix, y.matrix, atol=atol)
        assert (x.duration is None) == (y.duration is None)
        if x.duration is not None:
            assert x.duration == pytest.approx(y.duration, abs=atol)


def test_smush_u_takes_a_time_per_lane():
    """A tensor t batches like the drive vectors' leading axes: equal to
    jax.vmap(smush_u) over per-lane durations at 1e-12 and to the scalar
    calls lane by lane; a number behaves as before."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-4, 4, (7, 10))
    t = rng.uniform(0.1, 1.5, 7)
    want = jcplx.to_numpy(jax.vmap(lambda p, tt: jham.smush_u(p[0], p[1], np.pi / 2, 0.0, p[2:6], p[6:], t=tt))(
        jnp.asarray(x), jnp.asarray(t)))
    X, T = torch.as_tensor(x), torch.as_tensor(t)
    got = ham.smush_u(X[:, 0], X[:, 1], np.pi / 2, 0.0, X[:, 2:6], X[:, 6:], t=T).numpy()
    assert np.abs(got - want).max() <= PULSE_ATOL
    one = np.stack([ham.smush_u(X[i, 0], X[i, 1], np.pi / 2, 0.0, X[i, 2:6], X[i, 6:], t=float(t[i])).numpy()
                    for i in range(7)])
    assert np.abs(got - one).max() <= 1e-15
    scalar = ham.smush_u(X[:, 0], X[:, 1], np.pi / 2, 0.0, X[:, 2:6], X[:, 6:], t=0.5).numpy()
    assert np.abs(scalar - ham.smush_u(X[:, 0], X[:, 1], np.pi / 2, 0.0, X[:, 2:6], X[:, 6:],
                                       t=torch.full((7,), 0.5, dtype=torch.float64)).numpy()).max() == 0.0


@pytest.mark.parametrize("m", [1, 2])
def test_frozen_time_slots_have_zero_jacobian_columns(m):
    """The pulse times ride in detached slots: the forward-mode Jacobian of
    the Makhlin residual (the general path's chain_kernels.jacobian) has
    exactly zero columns there, and so has the reverse-mode gradient of the
    Adam objective. The other columns are live, but each pulse's gain phase,
    which a zero gain coupling leaves without effect."""
    core_fn, n = passes.pd_core(m)
    per = 2 + 2 * 4
    dead = list(range(m)) + [m + j * per + 1 for j in range(m)]
    live = [p for p in range(n) if p not in dead]
    rng = np.random.default_rng(m)
    x = torch.as_tensor(rng.uniform(-2, 2, (5, n)))
    x[:, :m] = torch.as_tensor([1.0, 0.5][:m], dtype=torch.float64)
    tgt = torch.as_tensor(haar_sample(5, seed=m))
    J = ck.jacobian(lambda a: makhlin_residual(core_fn, a, tgt), x)
    assert J.shape == (5, 3, n)
    assert (J[:, :, :m] == 0).all()
    assert (J[:, :, live].abs().amax(dim=(0, 1)) > 0).all()
    xg = x.clone().requires_grad_(True)
    r = makhlin_residual(core_fn, xg, tgt)
    (g,) = torch.autograd.grad((r * r).sum(), xg)
    assert (g[:, :m] == 0).all() and (g[:, live].abs().amax(0) > 0).all()


def test_exact_path_matches_jax():
    """iSwap-class blocks take the exact path in both packages, with the
    same circuits at 1e-12 (KAK-sandwich locals, the zero pulse); the JAX
    package runs no solver for them."""
    c = _iswap_blocks(3, seed=1)
    _, blocks, subs, plans = passes._pd_substitutions(c, 0.25, "linear", 0, torch.device(CPU))
    assert all(p == [1.0] for p in plans.values())
    stats = []
    out = passes.fit_substituted_pd(blocks, subs, plans, duration_1q=0.25, device=CPU, stats=stats)
    jout = jpasses.fit_substituted_pd(blocks, subs, plans, duration_1q=0.25)
    assert [s["stage"] for s in stats] == ["exact"] and stats[0]["indices"] == sorted(plans)
    for i in plans:
        _same_circuit(out[i], jout[i], CIRCUIT_ATOL)
        assert _gdist(out[i].to_matrix(), blocks[i].unitary) <= 1e-12


def test_the_same_blocks_take_the_class_fit(monkeypatch):
    """With iSwap-class, controlled-family and SWAP-class blocks, both
    packages send the same blocks to their first class-fit group (m = 1),
    with the same frozen pulse times and the same starts (each solver
    stopped at its first call, before the JAX one compiles); the exact path
    takes the two iSwap-class blocks."""
    from slam_decomposition_torch.opt import gauss_newton as gn

    c = _iswap_blocks(1, seed=2)
    c.cp(0.9, 1, 2)
    c.unitary(G.ISWAP.to_numpy(), (0, 1))
    c.swap(1, 2)
    _, blocks, subs, plans = passes._pd_substitutions(c, 0.25, "linear", 0, torch.device(CPU))
    seen = {}

    class Stop(Exception):
        pass

    def stub(key, to_numpy):
        def make(core_fn, n_params, **kw):
            def solve(x0, tgts):
                seen[key] = (n_params, np.asarray(x0), to_numpy(tgts))
                raise Stop

            return solve

        return make

    monkeypatch.setattr(jgn, "make_driven_solver", stub("jax", jcplx.to_numpy))
    monkeypatch.setattr(gn, "make_solver", stub("port", lambda t: t.numpy()))
    with pytest.raises(Stop):
        jpasses.fit_substituted_pd(blocks, subs, plans, duration_1q=0.25, restarts=2)
    stats = []
    with pytest.raises(Stop):
        passes.fit_substituted_pd(blocks, subs, plans, duration_1q=0.25, restarts=2, device=CPU, stats=stats)
    assert stats[0]["stage"] == "exact"
    assert stats[0]["indices"] == [i for i in plans if _is_iswap_class(blocks[i].unitary)]
    assert len(stats[0]["indices"]) == 2
    (n, x0, T), (jn, jx0, jT) = seen["port"], seen["jax"]
    assert n == jn == 1 + 10
    np.testing.assert_array_equal(x0, jx0)  # the same draws, the plans' times in slot 0
    np.testing.assert_array_equal(T, jT)
    assert len(T) == 1 and not _is_iswap_class(T[0])


@pytest.mark.parametrize("name", ["ghz3", "ladder"])
def test_fidelity_faithful_substitution(name):
    """tests/test_transpile.py::test_fidelity_faithful_substitution's
    parallel-drive half on the port: the output equals the circuit within
    trace distance 5e-9."""
    circ = library.ghz(3) if name == "ghz3" else _ladder()
    stats = []
    out, m = passes.pass_manager_optimized_sqiswap(circ, duration_1q=0.25, fit_1q=True, device=CPU, stats=stats)
    assert _gdist(out.to_matrix(), circ.to_matrix()) < 5e-9
    assert all(s["path"] == "general" for s in stats if s["stage"] == "class_fit")
    _, m0 = passes.pass_manager_optimized_sqiswap(circ, duration_1q=0.25, device=CPU)
    assert m["duration"] == pytest.approx(m0["duration"], abs=1e-12)


def test_fidelity_faithful_substitution_swap_blocks():
    """tests/test_transpile.py::test_fidelity_faithful_substitution_swap_
    blocks on the port: the SWAP-class block misses the [1.0, 0.5] plan,
    lands in the exact 3-segment fallback (the chain solver: the kernels'
    plain versions here), and the output equals the circuit within 1e-9."""
    c = _cx_swap_cx()
    stats = []
    out, _ = passes.pass_manager_optimized_sqiswap(c, duration_1q=0.25, fit_1q=True, device=CPU, stats=stats)
    assert _gdist(out.to_matrix(), c.to_matrix()) < 1e-9
    by = {(s["stage"], s.get("m")): s for s in stats}
    assert by[("class_fit", 2)]["fitted"] == 0 and by[("class_fit", 2)]["failed"] == 1
    assert by[("fallback", None)]["fitted"] == 1 and by[("fallback", None)]["path"] == "kernels"


@pytest.mark.slow
def test_fit_substituted_pd_matches_jax():
    """The whole fit against the JAX package's at restarts=4 on an
    iSwap-class, a controlled-family and a SWAP-class block: the same
    blocks on the exact path (circuits at 1e-12), class-fitted, in the
    fallback and left as placeholders, and every fitted block within the
    threshold in both. Its JAX side takes ~4 minutes on the CPU."""
    c = _iswap_blocks(1, seed=3)
    c.cx(1, 2)
    c.swap(0, 1)
    _, blocks, subs, plans = passes._pd_substitutions(c, 0.25, "linear", 0, torch.device(CPU))
    stats = []
    out = passes.fit_substituted_pd(blocks, subs, plans, duration_1q=0.25, restarts=4, device=CPU, stats=stats)
    jout = jpasses.fit_substituted_pd(blocks, subs, plans, duration_1q=0.25, restarts=4)

    def path(o, i):
        if o[i] is subs[i]:
            return "placeholder"
        names = [op.name for op in o[i].ops]
        if "u1q" in names:
            return "exact"
        pulses = [op for op in o[i].ops if op.name == "pd_pulse"]
        return "fallback" if len(pulses) == 3 and not np.any([op.params for op in pulses]) else "class_fit"

    assert {i: path(out, i) for i in plans} == {i: path(jout, i) for i in plans}
    for s in stats:
        if s["stage"] == "exact":
            for i in s["indices"]:
                _same_circuit(out[i], jout[i], CIRCUIT_ATOL)
    for i in plans:
        if path(out, i) != "placeholder":
            assert _gdist(out[i].to_matrix(), blocks[i].unitary) <= THRESHOLD
            assert _gdist(jout[i].to_matrix(), blocks[i].unitary) <= THRESHOLD


@pytest.mark.slow
def test_fallback_solver_against_jax_on_qft64_blocks():
    """The exact 3-segment fallback's solve (the chain solver: the kernels'
    plain versions here) on QFT-64's 65 distinct block unitaries, 4 copies
    each at 16 restarts, against the JAX package's solver of the same
    template (its general path, as its fallback runs it) from the same
    starts: every certified cost is within the threshold and the port
    leaves no more blocks above it than the JAX package does. Its JAX side
    compiles and runs for ~30 s; the swap-block case runs the same port
    code."""
    from slam_decomposition_tpu.models.gates import _const_gate as jconst_gate
    from slam_decomposition_tpu.models.templates import build_ansatz as jbuild_ansatz

    from slam_decomposition_torch.models.templates import build_ansatz
    from slam_decomposition_torch.opt.gauss_newton import make_solver
    from slam_decomposition_torch.transpile.consolidate import consolidate_2q_blocks

    distinct = {}
    for b in consolidate_2q_blocks(ir.unroll_3q_or_more(library.qft(64))):
        distinct.setdefault(b.unitary.tobytes(), b.unitary)
    T = np.repeat(np.stack(list(distinct.values())), 4, axis=0)
    zero = np.zeros(4)
    Pm = ham.smush_u(0.0, 0.0, np.pi / 2, 0.0, zero, zero, t=0.5).numpy()
    a = build_ansatz([G._const_gate("pd_sq_zero", 2, Pm)] * 3)
    x0 = np.random.default_rng(0).uniform(0, 2 * np.pi, (len(T), 16, a.n_params))
    solver = make_solver(a.eval_fn, a.n_params, chain_gates=a.chain_gates, device=CPU)
    assert solver.path == "kernels"
    _, fs = solver(torch.as_tensor(x0), torch.as_tensor(T))
    ja = jbuild_ansatz([jconst_gate("pd_sq_zero", 2, Pm)] * 3)
    _, jfs = jax.jit(jgn.make_solver(ja.eval_fn, ja.n_params))(jnp.asarray(x0), jcplx.from_numpy(T))
    fs, jfs = fs.numpy(), np.asarray(jfs)
    print(f"above {THRESHOLD:g}: the port {(fs > THRESHOLD).sum()}, JAX {(jfs > THRESHOLD).sum()} of {len(T)} blocks")
    assert len(distinct) == 65
    assert (fs > THRESHOLD).sum() <= (jfs > THRESHOLD).sum()


@pytest.mark.cuda
def test_fit_substituted_pd_on_the_card():
    """ghz(3) through pass_manager_optimized_sqiswap(fit_1q=True) on the
    card: fidelity-faithful within 5e-9, the class fit on the general path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    circ = library.ghz(3)
    stats = []
    out, _ = passes.pass_manager_optimized_sqiswap(circ, duration_1q=0.25, fit_1q=True, device="cuda", stats=stats)
    assert _gdist(out.to_matrix(), circ.to_matrix()) < 5e-9
    assert [s["stage"] for s in stats] == ["exact", "class_fit"] and stats[1]["fitted"] == stats[1]["blocks"]
