"""The port's CPU tests on one torch intra-op thread.

The suite runs its files in several processes at once; each torch's thread
pool sized to every core would oversubscribe them. A test file imports the
fixture by name, which makes it autouse there:

    from torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
