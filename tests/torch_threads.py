"""One intra-op torch thread for a port test module.

The suite runs several pytest workers on the box's cores, and torch's
intra-op thread pools then contend: the tiny models of the port's tests run
10-40x slower than alone.  A test module takes the pin by importing the
fixture, which is autouse::

    from tests.torch_threads import one_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
