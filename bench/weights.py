"""Seeded random weights, made by the benchmark in the port's parameter
layout, which the configuration's plain reference lists
(``leaf_specs(model)`` of ``bench/reference/<reference>.py``).

One ``torch.Generator`` on the run's device draws each leaf in one call,
every layer's copy stacked on a leading axis, in the type the model is
served in. The same seed on the same device gives the same weights,
so the plain references make them again instead of taking them from the
program.
"""
from __future__ import annotations

import torch


def leaves(specs: list, seed: int, device):
    """Yield (path, tensor) for every leaf of `specs` ([(path, shape, dtype
    name, scale)]; scale None is a leaf of ones, which draws nothing),
    drawn in order from one generator seeded with `seed`."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    for path, shape, dt, scale in specs:
        dtype = getattr(torch, dt)
        if scale is None:
            yield path, torch.ones(shape, dtype=dtype, device=device)
        else:
            yield path, torch.randn(shape, generator=gen, dtype=dtype,
                                    device=device).mul_(scale)


def make(specs: list, seed: int, device) -> dict:
    """The nested parameter dict of every leaf."""
    params: dict = {}
    for path, t in leaves(specs, seed, device):
        node = params
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return params


def get(tree: dict, path):
    for k in path:
        tree = tree[k]
    return tree
