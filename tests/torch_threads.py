"""A fixture for the port's CPU tests that run many small torch ops.

The Tier-1 command runs six pytest workers on the host's cores, and torch's
CPU thread pool, one per worker and as wide as the host, spins against the
others': six copies of chip_smoke.py's JETS phase rehearsal took 585 s each
on eight threads and 12 to 14 s on one (an 8-core host). Import the fixture
into a test module to run its torch ops on one thread; it restores the
count when the module ends.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    count = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(count)
