"""One torch intra-op thread for each port test module.

The suite runs in parallel worker processes (``pytest -n``), each of which
would start torch's default intra-op pool of one thread per core. Several
such pools on one host spin against each other and against the other
workers, and a CPU render then runs many times slower than it does on one
thread. Every ``tests/test_torch_*.py`` imports :func:`one_intra_op_thread`,
which holds torch at one intra-op thread while the module runs and gives the
previous count back after it.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
