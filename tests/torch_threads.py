"""One torch CPU thread for the port's tests.

The tier-1 run puts several pytest workers on the same cores, each with
torch's default of one OpenMP thread per core. The port's tests run many
small ops (tiny UNets on 16³ windows), and with the cores oversubscribed
threefold the OpenMP barriers between them stall: a TTA test that takes 3 s
alone took over 600 s beside two copies of itself, while at one thread each
it takes the same 3 s alone and beside the others. Importing the fixture
into a test module applies it to that module's tests."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
