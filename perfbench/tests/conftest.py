"""The benchmark's CPU tests run torch on one thread: a multi-threaded
torch in several test workers runs many times slower."""

import pytest
import torch


@pytest.fixture(autouse=True)
def torch_on_one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
