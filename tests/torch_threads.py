"""The port's CPU parity files that run torch models beside their JAX
oracles import ``one_torch_thread`` (an autouse fixture, module scope):
torch runs on one intra-op thread while the file runs. The suite runs
several workers on shared cores, where torch's thread pool spins against
them (these files ran ~40% faster so under load); the worker's setting is
restored for the files after it. They call their JAX oracles through
``jitted``: an eager call of a function with a ``lax.scan`` inside traces
and compiles the scan's body again at every call."""
import functools

import jax
import pytest
import torch


@functools.lru_cache(maxsize=None)
def jitted(fn, static=(), names=()):
    """`fn` under ``jax.jit``, one wrapper for each (fn, static, names) so
    every call site shares its compilations. static: the positions of the
    config (and other hashable) arguments; names: static keywords."""
    return jax.jit(fn, static_argnums=static, static_argnames=names)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
