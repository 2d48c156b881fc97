"""A module-scoped fixture that runs a test file's torch ops on one CPU
thread, the torch thread count restored after the file.

The suite runs several pytest workers on one machine. With torch's
default of a thread a core each, the workers' parallel regions contend
for the cores, and a small op can wait tens of milliseconds for its
threads; the heaviest port files run several times sooner on one thread
each. One thread changes no check: float sums may add in another order,
inside every tolerance, and what a test compares bitwise runs in the
same setting on both sides.

Use: ``from torch_threads import one_torch_thread  # noqa: F401`` at a
test file's top (the fixture is autouse).
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
