"""The port's CPU parity files that run torch models beside their JAX
oracles import ``one_torch_thread`` (an autouse fixture, module scope):
torch runs on one intra-op thread while the file runs. The suite runs
several workers on shared cores, where torch's thread pool spins against
them (these files ran ~40% faster so under load); the worker's setting is
restored for the files after it."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
