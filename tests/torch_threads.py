"""An autouse fixture for the port's test files (tests/test_torch_*.py),
which import it by name: it caps torch's intra-op threads for the module."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    # several test workers share the machine: keep torch's intra-op pool
    # small so that it does not crowd out their subprocesses
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
