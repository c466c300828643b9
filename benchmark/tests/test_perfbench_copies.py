"""The benchmark's frozen copies agree with the port's originals at fixed
inputs: the Haar generator with `opt.samplers.haar_sample`, the circuits'
blocks with `transpile/library.py` and `transpile/consolidate.py`, the
launch counts and bounds with `utils/mfu.py`; and the generators' own
properties."""

import numpy as np
import pytest
import torch

from benchmark.metrics import flops
from benchmark.reference import coverage
from benchmark.traffic import circuits, haar
from slam_decomposition_torch.opt.samplers import haar_sample
from slam_decomposition_torch.utils import mfu


def test_haar_generator_is_haar_sample_on_the_same_draw():
    n, seed = 257, 12345
    rng = np.random.default_rng(seed)  # haar_sample's own draw of the Ginibre matrices
    z = (rng.standard_normal((n, 4, 4)) + 1j * rng.standard_normal((n, 4, 4))) / np.sqrt(2)
    got = haar.orthonormalize(torch.as_tensor(z)).numpy()
    np.testing.assert_allclose(got, haar_sample(n, seed=seed), rtol=0, atol=1e-12)


def test_pool_is_unitary_and_repeats_by_seed():
    a = haar.pool(300, 2**40 + 3, torch.device("cpu"))
    b = haar.pool(300, 2**40 + 3, torch.device("cpu"))
    assert torch.equal(a, b)
    eye = torch.eye(4, dtype=a.dtype)
    assert torch.allclose(a.conj().transpose(-2, -1) @ a, eye.expand_as(a), atol=1e-12)
    assert not torch.equal(a, haar.pool(300, 2**40 + 4, torch.device("cpu")))


@pytest.mark.parametrize("family, qubits", [("qv", 8), ("qv", 64), ("qft", 8), ("qft", 64)])
def test_circuit_blocks_are_the_ports(family, qubits):
    """Each circuit's consolidated blocks, bit for bit, against the port's
    `transpile/library.py` circuit through `consolidate_2q_blocks`."""
    from slam_decomposition_torch.transpile import library
    from slam_decomposition_torch.transpile.consolidate import consolidate_2q_blocks

    port = library.qv(qubits, seed=2**40 + 3) if family == "qv" else library.qft(qubits)
    want = np.stack([b.unitary for b in consolidate_2q_blocks(port)])
    got = np.stack(circuits.block_unitaries(circuits.FAMILIES[family](qubits, 2**40 + 3)))
    assert np.array_equal(got, want)


def test_circuit_pool_repeats_by_seed():
    mix = [{"family": "qv", "qubits": 8}, {"family": "qft", "qubits": 8}]
    a, sizes = circuits.batches(2**40 + 3, torch.device("cpu"), mix)
    b, _ = circuits.batches(2**40 + 3, torch.device("cpu"), mix)
    assert torch.equal(a, b) and a.dtype == torch.complex128 and sum(sizes) == len(a) and sizes[1] == 32
    assert not torch.equal(a[: sizes[0]], circuits.batches(2**40 + 4, torch.device("cpu"), mix)[0][: sizes[0]])


@pytest.mark.parametrize("k", [1, 2, 3, 8, 12, 13, 16, 24, 79])
def test_flop_counts_are_the_ports(k):
    for lanes, iters in ((40000, 100), (10000, 6), (7, 8)):
        assert flops.adam_launch(k, lanes, iters) == mfu.adam_launch(k, lanes, iters)
        assert flops.adam_launch(k, lanes, iters, True) == mfu.adam_launch(k, lanes, iters, True)
        for fresh in (None, 1.0, 3.25):
            assert flops.lm_launch(k, lanes, iters, fresh) == mfu.lm_launch(k, lanes, iters, fresh)
            assert flops.polish_launch(k, lanes, iters, fresh) == mfu.polish_launch(k, lanes, iters, fresh)
    assert (flops.F32_PEAK, flops.F64_PEAK, flops.HBM_BYTES_PER_S) == (mfu.F32_PEAK, mfu.F64_PEAK, mfu.HBM_BYTES_PER_S)
