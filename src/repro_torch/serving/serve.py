"""Batched serving on a dense cache: prefill, then token-by-token decode
(port of ``repro.serving.serve``).

`make_serve_step` builds the one-token step (ONE new token against a cache
of seq_len), under a sharding plan if given; `jit_serve_step` places its
params, cache and token on the plan's mesh (``core.parallelism``).
`generate` drives a full sampling loop and is the oracle for the
continuous-batching engine across all families the port serves (full,
sliding, local-global, ssm, hybrid: per-layer state providers).
`engine_generate` routes the same request shape through the Engine in one
call.

Sampling is Gumbel-max, the form of the reference's
``jax.random.categorical(key, l)`` = ``argmax(l + gumbel(key, l.shape))``:
`sample_with_noise` takes the noise, and `sample` draws it on the host
from an explicit CPU ``torch.Generator`` over the logits copied to the CPU
in float32, so a request's token stream does not depend on the device
(the reference also samples on the host). The reference's ``key=``
arguments are ``generator=`` here; `generate` seeds its default generator
from 0, as the reference seeds its default key.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core import parallelism as par
from repro_torch.models import transformer as T


def make_serve_step(cfg, plan=None):
    """serve_step(params, cache, inputs, index) -> (logits (B,V), cache
    updated in place). With a sharding `plan` the step runs in its context
    (``core.parallelism.plan_context``): params, cache and token as placed
    by `jit_serve_step`, the logits a DTensor."""

    def serve_step(params, cache, inputs, index):
        with par.plan_context(plan):
            return T.decode_step(cfg, params, cache, inputs, index)

    return serve_step


def jit_serve_step(cfg, plan, params, cache, inputs):
    """(step, params, cache, inputs): the planned `make_serve_step`, and the
    params placed on the plan's mesh by ``plan.param_specs``, the
    ``decode_step`` cache by ``plan.cache_specs`` (batch over the batch
    axes, kv heads over the tensor axes, the sequence over 'data' when the
    batch does not divide: dp_tp_seq) and each input by
    ``plan.spec_for_batch_leaf("token", ...)``, as the reference's
    ``jit_serve_step`` shards them. Every rank passes equal values."""
    mesh = plan.mesh
    params = par.shard_tree(params, plan.param_specs(params), mesh)
    cache = par.shard_tree(cache, plan.cache_specs(cache), mesh)
    inputs = par.shard_tree(
        inputs, {k: plan.spec_for_batch_leaf("token", tuple(v.shape))
                 for k, v in inputs.items()}, mesh)
    return make_serve_step(cfg, plan), params, cache, inputs


def gumbel(shape, generator: torch.Generator):
    """Standard Gumbel noise on the CPU in float32, as
    ``jax.random.gumbel``: -log(-log(u)), u uniform in [tiny, 1)."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


def sample_with_noise(logits, noise, temperature):
    """argmax(logits / temperature + noise) over the last axis (greedy
    argmax at temperature 0, where `noise` is not read); int32. The divisor
    is a 0-dim tensor: a CUDA tensor divided by a Python number becomes a
    multiply by its reciprocal."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    t = torch.tensor(temperature, dtype=logits.dtype, device=logits.device)
    return torch.argmax(logits / t + noise, dim=-1).to(torch.int32)


def sample(logits, generator=None, temperature=1.0):
    """One token per row of `logits` (..., V): greedy on the logits' device
    at temperature 0; otherwise Gumbel-max on the host with noise drawn
    from `generator` (a CPU ``torch.Generator``), returned on the logits'
    device."""
    if temperature == 0.0:
        return sample_with_noise(logits, None, 0.0)
    host = logits.detach().float().cpu()
    tok = sample_with_noise(host, gumbel(host.shape, generator), temperature)
    return tok.to(logits.device)


@torch.no_grad()
def generate(cfg, params, prompt_tokens, max_new, *, generator=None,
             temperature=0.0, max_len=None, prefill_mode="auto",
             kv_quant=None):
    """Greedy/temperature generation for token-input models on the params'
    device. prompt_tokens: (B, S0) ints (tensor or array). Returns (B,
    max_new) int32 tokens.

    Prefill fills the whole prompt cache in one call (`prefill_step`);
    `prefill_mode="loop"` keeps the token-by-token path as the reference
    oracle ("auto" takes it for recurrent families, which have no batched
    prefill). ``kv_quant`` stores the dense KV caches int8 with per-vector
    scales — the non-paged reference the quantized engine must match token
    for token."""
    if prefill_mode not in ("auto", "batched", "loop"):
        raise ValueError(f"unknown prefill_mode {prefill_mode!r}")
    dev = params["embed"]["table"].device
    tokens = torch.as_tensor(np.asarray(prompt_tokens), dtype=torch.int32,
                             device=dev)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    B, S0 = tokens.shape
    max_len = max_len or (S0 + max_new)
    cache = T.init_decode_state(cfg, B, max_len, kv_quant=kv_quant,
                                device=dev)
    if prefill_mode == "auto":
        prefill_mode = ("batched" if T.supports_batched_prefill(cfg)
                        else "loop")
    # labeled spans so device traces separate the prefill and decode phases
    # (the engine labels its phases the same way — serving.telemetry)
    with record_function("serve/prefill"):
        if prefill_mode == "batched":
            logits, cache = T.prefill_step(cfg, params, cache,
                                           {"tokens": tokens})
        else:
            for i in range(S0):
                logits, cache = T.decode_step(cfg, params, cache,
                                              {"token": tokens[:, i]}, i)
    out = []
    with record_function("serve/decode"):
        for j in range(max_new):
            tok = sample(logits, generator, temperature)
            out.append(tok)
            if j + 1 < max_new:     # the last token's logits are not read
                logits, cache = T.decode_step(cfg, params, cache,
                                              {"token": tok}, S0 + j)
    return torch.stack(out, dim=1)


def engine_generate(cfg, params, prompts, max_news, *, engine_cfg=None,
                    plan=None, device="cuda", return_engine=False):
    """Greedy generation for a batch of VARIABLE-length prompts through the
    continuous-batching Engine (any family the state providers cover),
    under a sharding `plan` if given. `prompts`: list of 1-D int token
    arrays; `max_news`: per-request generation budgets. Returns a list of
    np arrays in request order — greedy outputs equal per-request
    `generate` calls. With `return_engine=True` also returns the drained
    Engine (its telemetry)."""
    from repro_torch.serving.engine import Engine, EngineConfig
    eng = Engine(cfg, params, engine_cfg or EngineConfig(), plan=plan,
                 device=device)
    rids = [eng.add_request(p, int(m)) for p, m in zip(prompts, max_news)]
    outs = eng.drain()
    outs = [outs[r] for r in rids]
    return (outs, eng) if return_engine else outs
