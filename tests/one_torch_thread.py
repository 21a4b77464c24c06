"""An autouse fixture for CPU test files whose port side is many small torch
ops (decode steps, per-chunk extraction): one intra-op thread during each
test, so that test workers running side by side do not oversubscribe the
cores. Import it into a test module to apply it there."""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
