"""The data-parallel process group (counterpart of
``repro.launch.mesh.make_host_mesh``: a group of ranks takes the place of
the mesh's "data" axis). Nothing here runs at import time."""
from __future__ import annotations

import atexit
import datetime
import os
import shutil
import tempfile

import torch
import torch.distributed as dist


def make_dp_group(device="cuda", *, init_method=None,
                  timeout=datetime.timedelta(minutes=10)):
    """The default process group, made if there is none yet; returns it.

    With torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``)
    this process joins that group (``init_method`` defaults to
    ``env://``, which reads ``MASTER_ADDR``/``MASTER_PORT``; a
    ``file://`` store works as well) and, on the card, takes card
    ``LOCAL_RANK``. Without it, a one-rank group is made on a FileStore in a
    temporary directory, removed at exit. The backend is ``nccl`` for a
    ``cuda`` device and ``gloo`` for ``cpu``; `timeout` bounds every
    collective, so a dead rank fails its peers instead of hanging them.
    """
    if dist.is_initialized():
        return dist.group.WORLD
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the data-parallel group runs on the card by "
                           "default and this machine has none; pass "
                           "device='cpu' for a gloo group on the CPU")
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        init_method = init_method or "env://"
    else:
        rank, world = 0, 1
        if init_method is None:
            tmp = tempfile.mkdtemp(prefix="dp-group-")
            atexit.register(shutil.rmtree, tmp, ignore_errors=True)
            init_method = f"file://{tmp}/store"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, timeout=timeout)
    return dist.group.WORLD
