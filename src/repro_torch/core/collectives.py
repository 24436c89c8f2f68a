"""Allreduce algorithms from survey §2.5 on ``torch.distributed``
(counterpart of ``repro.core.collectives``).

The survey's four schedules are written out with point-to-point exchanges
(``dist.batch_isend_irecv``, one call per exchange round, in place of the
reference's ``lax.ppermute``), so their structure — the number of dependent
communication rounds and the bytes per round — is what runs:

  tree          reduce-to-root then broadcast:      2·log2(P) rounds
  butterfly     recursive doubling:                 log2(P) rounds
  ring          reduce-scatter ring + allgather ring: 2(P−1) rounds of m/P
  rabenseifner  reduce-scatter (halving) + allgather (doubling):
                                                    2·log2(P) rounds
  psum          the backend's own allreduce (``dist.all_reduce``)

A process group takes the place of the mesh axis; ``group=None`` is the
default group. Each rank's sums are taken in the reference schedule's order,
so they equal the JAX schedules' bit for bit. With P == 1 every algorithm
returns x. For a P that is not a power of two, tree, butterfly and
rabenseifner fall back to ``all_reduce``, as the reference does (the survey
analyzes them for P = 2^k). ``counts["rounds"]`` holds the exchange rounds
this rank took part in during the last call.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

ALGORITHMS = ("psum", "ring", "tree", "butterfly", "rabenseifner")

counts = {"rounds": 0}


def _is_pow2(n):
    return n & (n - 1) == 0


def _global(group, rank):
    return rank if group is None else dist.get_global_rank(group, rank)


def _exchange(group, send=None, dst=None, recv_like=None, src=None):
    """One round: send `send` to group rank `dst` and/or receive a tensor
    like `recv_like` from group rank `src`; returns what was received."""
    ops, recv = [], None
    if send is not None:
        ops.append(dist.P2POp(dist.isend, send.contiguous(),
                              _global(group, dst), group))
    if recv_like is not None:
        recv = torch.empty_like(recv_like)
        ops.append(dist.P2POp(dist.irecv, recv, _global(group, src), group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    counts["rounds"] += 1
    return recv


def allreduce_sum(x, group=None, algorithm="psum"):
    """Allreduce-sum of the tensor `x` over `group`; returns a new tensor
    (x itself when the group has one rank)."""
    if algorithm not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {algorithm!r}")
    counts["rounds"] = 0
    P = dist.get_world_size(group)
    if P == 1:
        return x
    idx = dist.get_rank(group)
    if algorithm == "ring":
        return _ring_allreduce(x, group, P, idx)
    if algorithm == "psum" or not _is_pow2(P):
        out = x.clone()
        dist.all_reduce(out, group=group)
        counts["rounds"] = 1
        return out
    if algorithm == "tree":
        return _tree_allreduce(x, group, P, idx)
    if algorithm == "butterfly":
        return _butterfly_allreduce(x, group, P, idx)
    return _rabenseifner_allreduce(x, group, P, idx)


def allreduce_mean(x, group=None, algorithm="psum"):
    return allreduce_sum(x, group, algorithm) / dist.get_world_size(group)


# ------------------------------------------------------------------ butterfly
def _butterfly_allreduce(x, group, P, idx):
    """Recursive doubling: log2(P) rounds, the full message each, with
    partner idx ^ 2^k."""
    for k in range(int(math.log2(P))):
        partner = idx ^ (1 << k)
        x = x + _exchange(group, x, partner, x, partner)
    return x


# ----------------------------------------------------------------------- tree
def _tree_allreduce(x, group, P, idx):
    """Binomial-tree reduce to rank 0, then broadcast down the same tree:
    2·log2(P) rounds with full-size messages (rank 0 takes part in all)."""
    logp = int(math.log2(P))
    # reduce: at round k, ranks with idx % 2^(k+1) == 2^k send to idx − 2^k
    for k in range(logp):
        shift = 1 << k
        if idx % (2 * shift) == 0:
            x = x + _exchange(group, recv_like=x, src=idx + shift)
        elif idx % (2 * shift) == shift:
            _exchange(group, x, idx - shift)
    # broadcast: rank idx − 2^k hands the sum to idx, largest distance first
    for k in reversed(range(logp)):
        shift = 1 << k
        if idx % (2 * shift) == shift:
            x = _exchange(group, recv_like=x, src=idx - shift)
        elif idx % (2 * shift) == 0:
            _exchange(group, x, idx + shift)
    return x


# ----------------------------------------------------------------------- ring
def _ring_allreduce(x, group, P, idx):
    """Bandwidth-optimal ring: reduce-scatter (P−1 rounds of m/P), then
    allgather (P−1 rounds of m/P) — the survey's pipeline."""
    n = x.numel()
    v = F.pad(x.reshape(-1), (0, (-n) % P)).reshape(P, -1)
    nxt, prv = (idx + 1) % P, (idx - 1) % P

    # reduce-scatter: after P−1 rounds rank r owns the full sum of chunk r
    buf = v[(idx - 1) % P]
    for k in range(1, P - 1):
        buf = _exchange(group, buf, nxt, buf, prv) + v[(idx - k - 1) % P]
    owned = _exchange(group, buf, nxt, buf, prv) + v[idx]

    # allgather: the owned chunks go once round the ring
    out = torch.empty_like(v)
    out[idx] = cur = owned
    for k in range(1, P):
        cur = _exchange(group, cur, nxt, cur, prv)
        out[(idx - k) % P] = cur
    return out.reshape(-1)[:n].reshape(x.shape)


# --------------------------------------------------------------- rabenseifner
def _rabenseifner_allreduce(x, group, P, idx):
    """Reduce-scatter by recursive halving, then allgather by recursive
    doubling: 2·log2(P) rounds, 2γm(P−1)/P bytes — the survey's allreduce
    lower bound. The message halves, then doubles, each round."""
    n = x.numel()
    v = F.pad(x.reshape(-1), (0, (-n) % P))
    logp = int(math.log2(P))

    # reduce-scatter (recursive halving), partner distance P/2 → 1
    off, seg, d = 0, v.numel(), P // 2
    for _ in range(logp):
        half = seg // 2
        bit = (idx // d) % 2                   # 0: keep the lower half
        keep_off = off + bit * half
        send_off = off + (1 - bit) * half
        partner = idx ^ d
        recv = _exchange(group, v[send_off:send_off + half], partner,
                         v[:half], partner)
        v[keep_off:keep_off + half] = v[keep_off:keep_off + half] + recv
        off, seg, d = keep_off, half, d // 2

    # allgather (recursive doubling), partner distance 1 → P/2
    d = 1
    for _ in range(logp):
        bit = (idx // d) % 2
        partner = idx ^ d
        recv = _exchange(group, v[off:off + seg], partner, v[:seg], partner)
        partner_off = off + (1 - 2 * bit) * seg
        v[partner_off:partner_off + seg] = recv
        off = off - bit * seg
        seg, d = seg * 2, d * 2
    return v[:n].reshape(x.shape)


# ------------------------------------------------------------- step counters
def schedule_steps(algorithm: str, P: int) -> int:
    """Number of dependent communication steps (for structural tests)."""
    if P == 1:
        return 0
    if algorithm == "tree":
        return 2 * int(math.log2(P))
    if algorithm == "butterfly":
        return int(math.log2(P))
    if algorithm == "ring":
        return 2 * (P - 1)
    if algorithm == "rabenseifner":
        return 2 * int(math.log2(P))
    return 1
