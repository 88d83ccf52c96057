"""A fixture for the port's CPU tests: torch's intra-op pool cut to one
thread while a module runs. The tests run small ops, and under the
suite's six pytest-xdist workers a pool of one thread per core in every
worker spins against the others' (a paged engine test: 284 s with the
default pool against 48 s with one thread, six copies at once on 8
cores). Import ``one_torch_thread`` into a test module to use it."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
