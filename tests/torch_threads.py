"""One CPU thread for torch and the BLAS/OpenMP pools while a port test
module runs.

The tier-1 suite runs several pytest workers at once; torch's OpenMP pool
and numpy's OpenBLAS pool each start a thread per core in every worker, and
their spinning threads then fight over the cores: a 0.5 s test took 40 s
that way.  The port's CPU tests are small (a few rods, narrow grids),
so one thread costs them nothing.  A test module opts in with

    from torch_threads import one_cpu_thread  # noqa: F401
"""

import contextlib

import pytest
import torch

try:
    from threadpoolctl import threadpool_limits
except ImportError:          # torch's own pool is then the only one limited
    threadpool_limits = None


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    limits = threadpool_limits(1) if threadpool_limits else contextlib.nullcontext()
    with limits:
        yield
    torch.set_num_threads(threads)
