"""Fake-tensor stand-ins for every model input — nothing allocated (the
port's copy of ``repro.launch.specs``, whose ``ShapeDtypeStruct`` trees
these match key for key, in shape and dtype)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import transformer as T


def fake_mode():
    """The dry run's ``FakeTensorMode``. Real constants that model code
    caches (made outside the modes under ``core.op_analysis``) are
    converted where an op reads them."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


def input_specs(cfg: ModelConfig, shape: InputShape, *, device="cuda",
                mode=None):
    """Abstract inputs for (cfg, shape), fake tensors of `mode` (a new
    `fake_mode()` if None) on `device`. Returns a dict:
      train/prefill: {"batch"} for loss_fn / forward
      decode:        {"inputs", "cache", "index"} for decode_step
    """
    B, S = shape.global_batch, shape.seq_len
    device = torch.device(device)
    with mode or fake_mode():
        def sds(shape, dtype):
            return torch.empty(shape, dtype=dtype, device=device)

        if shape.kind in ("train", "prefill"):
            batch = {}
            if cfg.frontend != "none":
                batch["embeds"] = sds((B, S, cfg.d_model), torch.bfloat16)
                if cfg.rope_mode == "mrope":
                    batch["positions"] = sds((3, B, S), torch.int32)
            else:
                batch["tokens"] = sds((B, S), torch.int32)
            if shape.kind == "train":
                batch["labels"] = sds((B, S), torch.int32)
            return {"batch": batch}

        # decode: ONE new token against a cache of length seq_len
        cache = T.init_decode_state(cfg, B, S, device=device)
        inputs = ({"embed": sds((B, cfg.d_model), torch.bfloat16)}
                  if cfg.frontend != "none"
                  else {"token": sds((B,), torch.int32)})
        return {"inputs": inputs, "cache": cache,
                "index": sds((), torch.int32)}


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> tuple[bool, str]:
    """long_500k requires sub-quadratic attention (DESIGN.md §4)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("skipped: pure full-attention arch — 500k dense-KV "
                       "decode is memory-infeasible; no windowed variant in "
                       "the model card (DESIGN.md §Decode-shape rules)")
    return True, ""
