"""Bring weights made by the JAX package's ``init_params`` into the port.

The reference's parameter pytree, with every leaf turned into a numpy array
(``np.asarray``), maps leaf for leaf onto the port's parameter dict, so both
packages compute the same function on the same weights. ``torch.from_numpy``
cannot read ml_dtypes' bfloat16, so every leaf goes through float32 and is
then cast to the port's dtype for that leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.transformer import param_specs


def params_from_jax(tree, cfg, device="cuda"):
    """tree: the JAX ``init_params(cfg, key)`` pytree as nested dicts of
    numpy arrays. Returns the port's params on `device`. Raises if a leaf
    is missing, extra, or of the wrong shape for `cfg`."""
    return _convert(tree, param_specs(cfg), torch.device(device), "params")


def _convert(tree, specs, device, path):
    if isinstance(specs, dict):
        if not isinstance(tree, dict) or set(tree) != set(specs):
            got = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise ValueError(f"{path}: keys {got} != expected {sorted(specs)}")
        return {k: _convert(tree[k], specs[k], device, f"{path}.{k}")
                for k in specs}
    shape, dtype, _ = specs
    a = np.asarray(tree)
    if tuple(a.shape) != tuple(shape):
        raise ValueError(f"{path}: shape {a.shape} != expected {shape}")
    f32 = np.ascontiguousarray(a.astype(np.float32))
    return torch.from_numpy(f32).to(device=device, dtype=dtype)
