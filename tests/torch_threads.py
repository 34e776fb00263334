"""The ``few_threads`` fixture, in a module that imports no JAX, so test
files that also run on the card (where JAX is not installed) can use it."""

import pytest
import torch


@pytest.fixture(scope="module")
def few_threads():
    """Two intra-op threads for a module's tests: convolutions on every core
    from several test processes at once take many times longer than on two
    each. Import it into a test module and name it in ``usefixtures``."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
