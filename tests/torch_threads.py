"""The port's test modules run torch on one intra-op thread.

Their tensors are small and their ops many, where extra threads only add
synchronisation, and the suite runs in six test processes at once: with
torch's default of a thread per core they contend (the port's test files
summed 2818 s of test time at the default, 1476-1734 s on one thread, 6
workers on an 8-core host). A test module takes the fixture by importing
it:

    from torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
