"""One torch intra-op thread for the port's test modules.

The suite runs its files in several worker processes at once; each torch
process would otherwise start an OpenMP pool as wide as the machine, and
the pools oversubscribe the cores.  Import :func:`one_torch_thread` into a
test module to apply it there (autouse, module scope; the old width is
restored afterwards).
"""
import pytest


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    import torch

    width = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(width)
