"""One intra-op thread for the port's CPU tests.

The tests run in several pytest-xdist workers on one machine. torch's CPU
ops then each start as many OpenMP threads as there are cores, and on a
loaded machine those threads wait on each other: a training step of the
small test net took 4.8 s with 8 threads against 0.04 s with one (8
cores, the machine loaded by three other test workers). Importing
``one_torch_thread`` into a test module runs that module's tests with one
intra-op thread and restores the count after; results do not depend on
it beyond fp32 summation order. test_torch_parallel and
test_torch_spatial do not import it: they hold the ranks of
subprocesses, which run with the default thread count, against a serial
run in the test process within 1e-5 of the same summation order."""

import pytest
import torch


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
