"""The one-thread fixture of the port's heavier CPU test files: import
``one_thread`` into a test module to run its tests, and its module-scoped
fixtures, on one intra-op torch thread. The tier-1 command runs the files
beside each other on several pytest-xdist workers, where torch's default
of one thread per core oversubscribes the machine many times over."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
