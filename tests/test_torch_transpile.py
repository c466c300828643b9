"""Parity of the port's transpile layer with the JAX package: the host
modules (ir, qasm, library, consolidate, kak, cx_decompose) built from the
same generators and seeds, the batched sqiSwap synthesis
(transpile/batch_synth.py) against the host routine's contract, and
``pass_manager_basic``.

JAX stays on the CPU (tests/conftest.py); data crosses as numpy. The
port's batched synthesis runs its plain polish here (CPU tensors)."""

import numpy as np
import pytest

from slam_decomposition_tpu.opt import samplers as jsamplers
from slam_decomposition_tpu.transpile import batch_synth as jbatch
from slam_decomposition_tpu.transpile import consolidate as jconsolidate
from slam_decomposition_tpu.transpile import cx_decompose as jcx
from slam_decomposition_tpu.transpile import ir as jir
from slam_decomposition_tpu.transpile import kak as jkak
from slam_decomposition_tpu.transpile import library as jlibrary
from slam_decomposition_tpu.transpile import passes as jpasses
from slam_decomposition_tpu.transpile import qasm as jqasm

from slam_decomposition_torch.opt.samplers import haar_sample, sqiswap_count_batch
from slam_decomposition_torch.transpile import consolidate as tconsolidate
from slam_decomposition_torch.transpile import cx_decompose as tcx
from slam_decomposition_torch.transpile import ir as tir
from slam_decomposition_torch.transpile import kak as tkak
from slam_decomposition_torch.transpile import library as tlibrary
from slam_decomposition_torch.transpile import passes as tpasses
from slam_decomposition_torch.transpile import qasm as tqasm
from slam_decomposition_torch.transpile.batch_synth import (
    _params_to_steps_batch,
    _product_steps_batch,
    sqiswap_decompose_batch,
)
from torch_threads import one_torch_thread  # noqa: F401  (torch on one intra-op thread)

# numpy on both sides: matrices are built by the same code, so 1e-12 only
# leaves room for the order of host matrix products
ATOL = 1e-12


def _toffoli(lib, ir):
    c = ir.Circuit(3)
    c.h(0)
    c.append("ccx", (0, 1, 2))
    c.append("cswap", (2, 0, 1))
    return ir.unroll_3q_or_more(c)


CIRCUITS = {
    "qft5": lambda lib, ir: lib.qft(5),
    "ghz5": lambda lib, ir: lib.ghz(5),
    "qaoa6": lambda lib, ir: lib.qaoa(6, seed=3),
    "vqe_linear4": lambda lib, ir: lib.vqe_linear(4, seed=1),
    "hlf5": lambda lib, ir: lib.hlf(5, seed=2),
    "adder4": lambda lib, ir: lib.adder(4),
    "toffoli3": _toffoli,
}


def _pair(name):
    return CIRCUITS[name](jlibrary, jir), CIRCUITS[name](tlibrary, tir)


def _assert_same_ops(a_ops, b_ops):
    assert len(a_ops) == len(b_ops)
    for a, b in zip(a_ops, b_ops):
        assert (a.name, a.qubits, a.duration) == (b.name, b.qubits, b.duration)
        np.testing.assert_allclose(b.params, a.params, atol=ATOL)
        np.testing.assert_allclose(b.to_matrix(), a.to_matrix(), atol=ATOL)


@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_circuits_match_jax(name):
    jc, tc = _pair(name)
    assert jc.n_qubits == tc.n_qubits
    _assert_same_ops(jc.ops, tc.ops)
    assert tc.count_ops() == jc.count_ops() and tc.depth() == jc.depth()
    np.testing.assert_allclose(tc.to_matrix(), jc.to_matrix(), atol=ATOL)


@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_consolidation_and_analysis_match_jax(name):
    jc, tc = _pair(name)
    jb, tb = jconsolidate.consolidate_2q_blocks(jc), tconsolidate.consolidate_2q_blocks(tc)
    assert [b.qubits for b in tb] == [b.qubits for b in jb]
    assert [b.positions for b in tb] == [b.positions for b in jb]
    for a, b in zip(jb, tb):
        np.testing.assert_allclose(b.unitary, a.unitary, atol=ATOL)
    np.testing.assert_allclose(
        tconsolidate.consolidated_circuit(tc).to_matrix(),
        jconsolidate.consolidated_circuit(jc).to_matrix(),
        atol=ATOL,
    )
    assert tpasses.duration_analysis(tc, 0.25) == jpasses.duration_analysis(jc, 0.25)
    _assert_same_ops(jpasses.optimize_1q_gates(jc).ops, tpasses.optimize_1q_gates(tc).ops)


@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_qasm_crosses_from_jax(name):
    jc, tc = _pair(name)
    text = jqasm.to_qasm(jc)
    assert tqasm.to_qasm(tc) == text
    _assert_same_ops(jqasm.from_qasm(text).ops, tqasm.from_qasm(text).ops)


def test_block_coordinate_counts_match_jax():
    jc, tc = _pair("qft5")
    want = jconsolidate.block_coordinate_counts(jc)
    assert tconsolidate.block_coordinate_counts(tc, device="cpu") == want


def _zoo():
    return np.stack(
        [
            np.eye(4, dtype=complex),  # k=0: identity class
            np.kron(tkak._rz(0.3), tkak._rx(1.1)),  # k=0: pure local
            tkak.SQISWAP_M,  # k=1: the basis gate itself
            tkak.can_matrix(0.2, 0.2, 0.0),  # z = 0 boundary branch
            tkak.can_matrix(np.pi / 4, 0.1, 0.1),  # x = pi/4 wall
            tkak.can_matrix(0.3, 0.15, 0.15),  # |z| = x - y double root
            tkak.can_matrix(np.pi / 4, np.pi / 4, np.pi / 4),  # SWAP class
            tkak.can_matrix(np.pi / 4, np.pi / 8, np.pi / 8),  # B class
        ]
    )


def _mixed_batch():
    """tests/test_batch_synth.py's batch: 24 Haar targets and the zoo."""
    return np.concatenate([haar_sample(24, seed=11), _zoo()])


def _kak_zoo():
    """_zoo() and the rest of tests/test_kak_batch.py:63-91's classes."""
    extra = [tkak.can_matrix(0.3, 0.15, -0.15), tkak.can_matrix(np.pi / 4, np.pi / 4, 0.0), tkak.can_matrix(0.5, 0.4, 0.3)]
    return np.concatenate([_zoo(), np.stack(extra)])


def test_kak_form_matches_jax():
    U = np.concatenate([haar_sample(32, seed=21), _kak_zoo()])
    for u in U:
        jf, tf = jkak.kak_form(u), tkak.kak_form(u)
        np.testing.assert_allclose(tf.t, jf.t, atol=1e-10)
        np.testing.assert_allclose(tf.matrix(), u, atol=1e-10)


def test_sqiswap_and_cx_decompose_match_jax():
    U = np.concatenate([haar_sample(32, seed=21), _kak_zoo()])
    for u in U:
        (js, jn), (ts, tn) = jkak.sqiswap_decompose(u), tkak.sqiswap_decompose(u)
        assert tn == jn
        np.testing.assert_allclose(tkak.steps_to_matrix(ts), jkak.steps_to_matrix(js), atol=1e-10)
        (js, jn), (ts, tn) = jcx.cx_decompose(u), tcx.cx_decompose(u)
        assert tn == jn
        np.testing.assert_allclose(tcx.cx_steps_to_matrix(ts), jcx.cx_steps_to_matrix(js), atol=1e-10)
    sub = tcx.cx_decompose_to_circuit(U[0], duration_1q=0.25)
    assert abs(np.trace(sub.to_matrix().conj().T @ U[0])) / 4 > 1 - 1e-10


def test_batch_matches_host_contract():
    """tests/test_batch_synth.py:34-55 on the port, with its plain polish."""
    U = _mixed_batch()
    stats = {}
    res = sqiswap_decompose_batch(U, stats=stats, device="cpu")
    assert len(res) == len(U)
    counts = sqiswap_count_batch(U, device="cpu")
    for (steps, n), Ui, ci in zip(res, U, counts):
        assert n == ci
        V = tkak.steps_to_matrix(steps)
        # phase folded in: V reproduces Ui itself, not just its class
        infid = 1.0 - abs(np.trace(V.conj().T @ Ui)) / 4.0
        assert infid <= 1e-10, (n, infid)
        assert np.abs(V - Ui).max() < 1e-4, (n, np.abs(V - Ui).max())
        assert sum(1 for kind, _ in steps if kind == "sqiswap") == n
    # one f64 tier: every k >= 2 lane certifies from the device solve
    assert stats["fallback"] == 0 and stats["device"] == int((counts >= 2).sum()), stats
    assert stats["trivial"] == int((counts <= 1).sum())
    assert stats["device"] + stats["fallback"] + stats["trivial"] == len(U)
    assert "f64_rescue" not in stats


def test_batch_times_cover_every_stage():
    times = {}
    sqiswap_decompose_batch(_mixed_batch()[20:], device="cpu", times=times)
    assert sorted(times) == ["count", "emit", "init", "polish"]
    assert all(v >= 0 for v in times.values())
    assert sqiswap_decompose_batch(np.zeros((0, 4, 4), complex), device="cpu") == []


def test_product_steps_batch_fast_path():
    """tests/test_batch_synth.py:57-86: exact product blocks in one numpy
    pass; non-product blocks rejected for the exact host path."""
    rng = np.random.default_rng(17)

    def rand1q():
        z = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
        q, r = np.linalg.qr(z)
        return q * (np.diag(r) / np.abs(np.diag(r)))

    prods = np.stack(
        [np.exp(1j * rng.uniform(-np.pi, np.pi)) * np.kron(rand1q(), rand1q()) for _ in range(12)]
    )
    prods[0] = np.eye(4)  # degenerate: exact identity
    non_prod = np.stack([tkak.can_matrix(0.3, 0.1, 0.05), tkak.SQISWAP_M])
    batch = np.concatenate([prods, non_prod])
    out = _product_steps_batch(batch, 1e-10)
    jax_out = jbatch._product_steps_batch(batch, 1e-10)
    for i, steps in enumerate(out[:12]):
        assert steps is not None, i
        assert all(kind != "sqiswap" for kind, _ in steps)
        V = tkak.steps_to_matrix(steps)
        assert 1.0 - abs(np.trace(V.conj().T @ prods[i])) / 4.0 <= 1e-10, i
        # the JAX package's fast path emits the same matrix, phase included
        assert np.abs(V - jkak.steps_to_matrix(jax_out[i])).max() < 1e-12, i
    assert out[12] is None and out[13] is None  # entangling: rejected
    assert jax_out[12] is None and jax_out[13] is None


def test_params_to_steps_batch_matches_scalar():
    """tests/test_batch_synth.py:106-139: the port's vectorized certify +
    emit is lane-exact against the JAX package's per-lane routine and its
    batch routine, NaN and phase included."""
    rng = np.random.default_rng(5)
    for k in (2, 3):
        xs = rng.uniform(0, 2 * np.pi, (6, 6 * (k + 1)))
        # lanes 0..3: targets built from the params (certify); lane 4: a
        # random target (fails); lane 5: NaN
        Us = np.stack(
            [jkak.steps_to_matrix(jbatch._params_to_steps(xs[j], k, np.eye(4), atol=np.inf)[1:]) for j in range(6)]
        )
        Us[4] = np.linalg.qr(rng.normal(size=(4, 4)) + 1j * rng.normal(size=(4, 4)))[0]
        xs[5, 0] = np.nan
        port = _params_to_steps_batch(xs, k, Us, atol=1e-9)
        jax_batch = jbatch._params_to_steps_batch(xs, k, Us, atol=1e-9)
        for j in range(6):
            scalar = jbatch._params_to_steps(xs[j], k, Us[j], atol=1e-9)
            assert (port[j] is None) == (scalar is None) == (jax_batch[j] is None), (k, j)
            if scalar is None:
                continue
            Vp, Vs, Vb = (tkak.steps_to_matrix(port[j]), jkak.steps_to_matrix(scalar),
                          jkak.steps_to_matrix(jax_batch[j]))
            assert np.abs(Vp - Vs).max() < 1e-12 and np.abs(Vp - Vb).max() < 1e-12
            assert np.abs(Vp - Us[j]).max() < 1e-9
        assert [j for j in range(6) if port[j] is None] == [4, 5]


def _tiny_cp_blocks():
    """Blocks like QFT-64's cp(pi/2^26): chamber x ~ 7.5e-9, inside the
    count's 1e-8 identity tolerance but outside the host KAK's."""
    theta = np.pi / 2**26
    out = []
    for pre, post in [(None, None), ("h", None), (None, "h"), ("h", "h")]:
        c = tir.Circuit(2)
        if pre:
            c.h(0)
        c.cp(theta, 1, 0)
        if post:
            c.h(1)
        out.append(c.to_matrix())
    return np.stack(out)


def test_tiny_cp_blocks_take_the_product_path():
    """Why the batched QFT-64 pass emits 2646 sqiSwaps and the host loop
    2722, in both packages: the 38 blocks cp(pi/2^26) count as k=0, where
    the product fast path certifies them as local gates, while the host
    routine gives them two sqiSwaps."""
    U = _tiny_cp_blocks()
    assert list(sqiswap_count_batch(U, device="cpu")) == [0] * len(U)
    assert list(np.atleast_1d(jsamplers.sqiswap_count_batch(U))) == [0] * len(U)
    port, jax_out = _product_steps_batch(U, 1e-10), jbatch._product_steps_batch(U, 1e-10)
    for u, p, j in zip(U, port, jax_out):
        assert p is not None and j is not None
        Vp = tkak.steps_to_matrix(p)
        assert np.abs(Vp - jkak.steps_to_matrix(j)).max() < 1e-12
        assert 1.0 - np.trace(Vp.conj().T @ u).real / 4.0 <= 1e-10
        assert jkak.sqiswap_decompose(u)[1] == tkak.sqiswap_decompose(u)[1] == 2
    stats = {}
    res = sqiswap_decompose_batch(U, stats=stats, device="cpu")
    assert [n for _, n in res] == [0] * len(U) and stats["trivial"] == len(U)
    # the same split in the pass managers, batched and host loop
    def ladder(ir):
        c = ir.Circuit(4)
        for q in range(3):
            c.h(q)
            c.cp(np.pi / 2**26, q + 1, q)
        return c

    jc, c = ladder(jir), ladder(tir)
    for batched, want in [(True, 0), (False, 6)]:
        _, jm = jpasses.pass_manager_basic(jc, "sqiswap", 0.25, batched=batched)
        _, tm = tpasses.pass_manager_basic(c, "sqiswap", 0.25, batched=batched, device="cpu")
        assert tm == jm and tm["gate_counts"].get("riswap", 0) == want, (batched, tm, jm)


@pytest.mark.parametrize("name,gate", [("qft5", "sqiswap"), ("ghz5", "cx"), ("adder4", "sqiswap")])
def test_pass_manager_basic_matches_jax(name, gate):
    """Port (batched, plain polish on the CPU) vs JAX (host loop): the same
    duration and gate counts, and the same circuit unitary
    (tests/test_batch_synth.py:89-103)."""
    jc, tc = _pair(name)
    j_out, j_m = jpasses.pass_manager_basic(jc, gate=gate, duration_1q=0.25, batched=False)
    stats = {}
    t_out, t_m = tpasses.pass_manager_basic(tc, gate=gate, duration_1q=0.25, batched=True, device="cpu", stats=stats)
    assert t_m == j_m
    U0, Uj, Ut = tc.to_matrix(), j_out.to_matrix(), t_out.to_matrix()
    d = U0.shape[0]
    assert abs(np.trace(U0.conj().T @ Ut)) / d > 1 - 1e-9
    assert abs(np.trace(Uj.conj().T @ Ut)) / d > 1 - 1e-9
    if gate == "sqiswap":
        assert stats["fallback"] == 0 and stats["device"] + stats["trivial"] == len(
            tconsolidate.consolidate_2q_blocks(tc)
        )
        h_out, h_m = tpasses.pass_manager_basic(tc, gate=gate, duration_1q=0.25, batched=False, device="cpu")
        assert h_m == j_m


def test_pass_manager_basic_batches_only_on_cuda_by_default():
    # batched=None on the CPU takes the host loop: no stats are written
    c = tlibrary.qft(12)
    assert len(tconsolidate.consolidate_2q_blocks(c)) >= tpasses.BATCH_MIN_BLOCKS
    stats = {}
    tpasses.pass_manager_basic(c, device="cpu", stats=stats)
    assert stats == {}
    with pytest.raises(ValueError):
        tpasses.pass_manager_basic(tlibrary.qft(3), gate="syc")
