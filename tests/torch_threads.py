"""An autouse fixture for the port's CPU tests: one torch intra-op thread
while each test runs.

The suite runs in several worker processes at once, and torch's default
of one OpenMP thread per core in each of them oversubscribes the cores:
the plain versions' many small ops then wait on each other's spinning
threads, and one test was seen to run 100x slower than alone. A test
module takes the fixture by importing it:

    from torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
