"""torch's CPU thread count for the port's test modules.

`one_torch_thread` (module scope, autouse where a test module imports
it): torch on one CPU thread. The suite runs files in parallel worker
processes, and a pool of a thread a core in each of them oversubscribes
the cores, where its OpenMP barriers spin (a 6-second HRNet training
took minutes beside the other workers). `all_torch_threads` (function
scope) gives one test torch's own thread count back, for a test whose
result depends on it.
"""

import pytest
import torch

DEFAULT_THREADS = torch.get_num_threads()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def all_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(DEFAULT_THREADS)
    yield
    torch.set_num_threads(n)
