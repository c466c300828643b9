import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the sizes of a run on the CPU (the kernels' plain versions)
TINY = {"batch": 32, "chunk": 16, "restarts": 2, "pool_batches": 2, "check_per_batch": 32}
# the circuit mixes' tiny pool: QV-8 and QFT-8, whose blocks a run judges all
TINY_CIRCUITS = {**TINY, "target_params": {"circuits": [{"family": "qv", "qubits": 8}, {"family": "qft", "qubits": 8}]}}
SEED = 2**31 + 977  # past 32 signed bits, as the benchmark's seeds may be


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
