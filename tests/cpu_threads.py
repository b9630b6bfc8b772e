"""A fixture for tests that run the port's torch code on the CPU.

Under pytest-xdist every worker process shares the host's cores, and
torch's intra-op pool (one thread per core by default) in each of them
oversubscribes the host: the workers' spinning threads then slow each
other down many times over. ``one_torch_thread`` runs a test module with
one intra-op thread and restores the count after it.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
