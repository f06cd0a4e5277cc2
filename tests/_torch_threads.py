"""One torch intra-op thread for the port's CPU tests.

The suite runs in several worker processes at once. The port's plain
versions run many small torch ops in row loops, and each op waits for
every intra-op thread; with threads that other workers keep off the
cores, those waits stretch a test a hundredfold (a banded
``profile_stages`` call on a 4 kbp genome took 288 s with 8 threads
beside 7 busy processes, and 2.4 s with one thread). A test file takes
the fixture by importing it."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
