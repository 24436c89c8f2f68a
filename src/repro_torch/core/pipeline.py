"""Layer pipelining (survey §5.3): a GPipe microbatch schedule over a mesh
axis, one stage a rank (counterpart of ``repro.core.pipeline``, whose
``shard_map`` + ``lax.ppermute`` become point-to-point sends on the axis's
process group).

Each of the S stages holds its own slice of the stacked params; M
microbatches flow through; activations hop stage s → s+1 after every
round. The bubble fraction (S−1)/(S−1+M) matches
``costmodel.pipeline_bubble_fraction`` (the survey's "latency proportional
to the number of processors"); ``counts["rounds"]`` and ``counts["hops"]``
record the schedule of the last call (hops = M + S − 1 when S > 1).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

counts = {"rounds": 0, "hops": 0}


def _stage_slice(params, s):
    if isinstance(params, dict):
        return {k: _stage_slice(v, s) for k, v in params.items()}
    return params[s]


def pipeline_forward(stage_fn, params_stacked, x_microbatches, mesh,
                     axis="stage"):
    """Run M microbatches through S pipeline stages.

    stage_fn(stage_params, x) -> x        (one stage's computation)
    params_stacked: dict tree of tensors with leading dim S (rank s reads
      slice s, its stage)
    x_microbatches: (M, mb, ...) input microbatches, equal on every rank
    mesh: a ``DeviceMesh`` with the dim `axis` (size S)
    Returns (M, mb, ...) outputs, equal on every rank.

    Schedule: M + S − 1 rounds; in round r, stage s processes microbatch
    r − s (if valid); after each round the activation hops to stage s + 1
    on a ring (``batch_isend_irecv``), and at the end the last stage's
    outputs are summed to every rank (an all-reduce of zeros elsewhere).
    """
    S = mesh.size(mesh.mesh_dim_names.index(axis))
    M = x_microbatches.shape[0]
    group = mesh.get_group(axis)
    sid = mesh.get_local_rank(axis)
    params = _stage_slice(params_stacked, sid)
    ranks = dist.get_process_group_ranks(group)
    nxt, prv = ranks[(sid + 1) % S], ranks[(sid - 1) % S]
    xs = x_microbatches
    buf = torch.zeros_like(xs[0])            # the activation in flight
    outs = torch.zeros_like(xs)
    counts["rounds"] = counts["hops"] = 0
    for r in range(M + S - 1):
        cur = xs[min(r, M - 1)] if sid == 0 else buf
        mb = r - sid                         # which microbatch
        valid = 0 <= mb < M
        y = stage_fn(params, cur) if valid else cur
        if valid and sid == S - 1:
            outs[mb] = y
        counts["rounds"] += 1
        if S > 1:                            # a rank cannot send to itself
            y = y.contiguous()
            buf = torch.empty_like(y)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, y, nxt, group),
                dist.P2POp(dist.irecv, buf, prv, group)])
            for q in reqs:
                q.wait()
            counts["hops"] += 1
    if S > 1:
        if sid != S - 1:
            outs.zero_()
        dist.all_reduce(outs, group=group)
    return outs


def num_pipeline_rounds(stages: int, microbatches: int) -> int:
    return microbatches + stages - 1
