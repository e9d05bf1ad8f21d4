"""Torch's intra-op threads in the port's CPU test modules.

The tier-1 run puts six test processes on one machine. Torch's default
of one intra-op thread per core then runs six OpenMP teams against each
other, and a training loop that takes 15 s alone took 20 minutes beside
five busy workers. Two threads each keep the run inside the machine's
cores; a module imports ``torch_threads`` to take the setting for its
tests and give the process's own back after them. Results compare within
the tests' stated tolerances on any thread count; where a test holds two
port computations bitwise, both run on the same threads.
"""

import pytest
import torch

TEST_THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    previous = torch.get_num_threads()
    torch.set_num_threads(TEST_THREADS)
    yield
    torch.set_num_threads(previous)
