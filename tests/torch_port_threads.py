"""One torch thread for the port's CPU tests: the test workers share the
machine's cores, and a full torch thread pool in each would oversubscribe
them several times over. Import the fixture into a test module to use it.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
