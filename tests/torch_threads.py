"""One intra-op thread for torch while a test module runs.

The plain PyTorch versions run many small tensor ops.  Beside the other
processes of a parallel test run, torch's intra-op threads only contend:
the whole suite with six workers took 1,296.6 s with the default threads
and 277.7 s with one (``OMP_NUM_THREADS=1``) on an 8-core machine, with
the same results.  A test module takes the fixture by importing it::

    from torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
