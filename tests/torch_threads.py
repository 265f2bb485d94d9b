"""A fixture that runs a test with one PyTorch CPU thread.

The suite runs on several workers at once (pytest-xdist), each with PyTorch's
default of one intra-op thread a core. A worker's tiny-model tests run many
small ops whose threads then wait on cores the other workers hold: measured
on an 8-core machine beside six busy processes, one such test took 30.7 s
with eight threads and 1.75 s with one. The test files that drive tiny models
op by op import :func:`one_torch_thread` (an autouse fixture: importing it
into a test module applies it to every test there).
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for the test; the previous count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
