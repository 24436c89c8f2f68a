"""The benchmark's CPU tests: the checkout's root and ``src`` on the path
(``import bench``, ``import repro_torch``), and torch on one thread while
they run, as the repository's port tests do under several workers."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
