"""Process groups and device meshes (counterpart of ``repro.launch.mesh``).

`make_dp_group` is the default process group (a group of ranks takes the
place of a JAX mesh's "data" axis in the paper mode); `make_host_mesh`
lays a ``DeviceMesh`` over it for the sharding plans;
`make_production_mesh` gives the reference's production mesh shapes as an
``AbstractMesh`` (axis sizes only, for the plans' rules); and
`make_dryrun_mesh` gives them as a ``DeviceMesh`` of rank 0 in a "fake"
process group of 256 (or 512) ranks, where collectives move nothing: the
dry run (``launch/dryrun.py``) traces one rank's program on it. Nothing
here runs at import time."""
from __future__ import annotations

import atexit
import datetime
import os
import shutil
import tempfile

import torch
import torch.distributed as dist

from repro_torch.core.parallelism import AbstractMesh


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


def make_production_mesh(*, multi_pod: bool = False):
    """Single pod: 16x16 = 256 chips ('data', 'model'); multi-pod adds a
    2-way 'pod' axis (512 chips). Shape only: the plans' rules run on it."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def make_fake_mesh(shape, axes, device="cuda"):
    """A ``DeviceMesh`` of `shape` named `axes` seen from rank 0 of a
    "fake" process group of prod(shape) ranks (``torch.testing``'s
    ``FakeStore`` and backend: every collective returns at once and moves
    nothing; a dry run traces one rank's program on it). A process holds
    one default group: a later call lays its mesh over the same fake group
    (meshes (2, 4) and (1, 8) share 8 ranks) and raises if the default
    group is another one or of another size."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the dry run traces the card's path by default "
                           "and this machine has no card; pass "
                           "device='cpu' to trace the CPU path")
    world = 1
    for s in shape:
        world *= s
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() != world:
            raise RuntimeError("a default process group exists already; the "
                               "fake group of a dry run needs a process of "
                               "its own")
    else:
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    return init_device_mesh(device.type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_dryrun_mesh(multi_pod: bool = False, device="cuda"):
    """The production mesh as a ``DeviceMesh`` of rank 0 in a fake group:
    16x16 = 256 ranks ('data', 'model'), or 2x16x16 = 512 ('pod', 'data',
    'model') for `multi_pod` (`make_fake_mesh`)."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    return make_fake_mesh(tuple(mesh.shape.values()), mesh.axis_names,
                          device)


def make_host_mesh(shape=(1,), axes=("data",), device="cuda", **group_kw):
    """A ``DeviceMesh`` of `shape` named `axes` over the default process
    group (made by `make_dp_group(device, **group_kw)` if there is none).
    When the shape's size is not the group's, the mesh falls back to
    ((world,), ("data",)), as the reference's falls back to its device
    count."""
    from torch.distributed.device_mesh import init_device_mesh
    make_dp_group(device, **group_kw)
    world = dist.get_world_size()
    total = 1
    for s in shape:
        total *= s
    if total != world:
        shape, axes = (world,), ("data",)
    return init_device_mesh(torch.device(device).type, tuple(shape),
                            mesh_dim_names=tuple(axes))
