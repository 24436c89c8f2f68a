"""Checkpointing in the reference's own format (counterpart of
``repro.train.checkpoint``; survey §6.2: "the simplest form of fault
tolerance in machine learning is checkpoint/restart").

A checkpoint is one ``.npz``: each leaf of the state tree under its key path
joined with ``|`` (``params|blocks|l0|attn|wq``, ``opt|m|embed|table``,
``opt|step``), bf16 stored as f32 (lossless), and the step under
``__step__``. Either package restores what the other saved, optimizer state
included.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.tree import leaves_with_path, tree_from_leaves

_SEP = "|"


def _flatten(tree):
    out = {}
    for path, leaf in leaves_with_path(tree):
        if torch.is_tensor(leaf):
            t = leaf.detach().cpu()
            arr = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        else:                         # a Python number (the optimizer step)
            arr = np.asarray(leaf, dtype=np.int32 if isinstance(leaf, int)
                             else np.float32)
        out[_SEP.join(path)] = arr
    return out


def save(path: str, tree, step: int = 0) -> str:
    arrays = _flatten(tree)
    arrays["__step__"] = np.asarray(step)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    return path


def restore(path: str, template):
    """Restore into `template`'s structure, each leaf in the template
    leaf's dtype and on its device (a Python number stays a number).
    Returns (tree, step). Raises KeyError for a missing leaf and ValueError
    for a leaf of another shape."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    step = int(arrays.pop("__step__", 0))
    out = []
    for keys, leaf in leaves_with_path(template):
        key = _SEP.join(keys)
        if key not in arrays:
            raise KeyError(f"checkpoint missing {key}")
        arr = arrays[key]
        shape = tuple(leaf.shape) if torch.is_tensor(leaf) else ()
        if arr.shape != shape:
            raise ValueError(f"shape mismatch for {key}: {arr.shape} vs "
                             f"{shape}")
        if torch.is_tensor(leaf):
            value = torch.from_numpy(np.array(arr)).to(device=leaf.device,
                                                        dtype=leaf.dtype)
        else:
            value = type(leaf)(arr)
        out.append((keys, value))
    return tree_from_leaves(out), step
