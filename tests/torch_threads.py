"""One torch thread per test process.

The tier-1 suite runs the test files in parallel processes (pytest-xdist),
each with XLA's thread pool beside torch's.  torch's default of one OpenMP
thread per core then oversubscribes the machine, and its spinning threads
slow the port's files more than tenfold: the six slice and database files
together took 1464 s with the default and 210 s with one thread each, on
an 8-core host.  A test file imports ``one_torch_thread``, an autouse
fixture, to run its tests with one torch thread; the count is restored
after the file.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
