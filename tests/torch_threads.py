"""The port's test modules' one-intra-op-thread fixture.

Import it into a test module (``from tests.torch_threads import
_one_torch_thread  # noqa: F401``): pytest collects an imported autouse
fixture as the module's own.
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # one intra-op thread: under pytest-xdist every worker's own pool of
    # threads spins on the same cores, and the many small CPU ops of the
    # port ran tens of times slower for it
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
