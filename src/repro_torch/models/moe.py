"""Mixture-of-Experts layer: top-k router and capacity-based sort dispatch
(the port's copy of ``repro.models.moe``).

  1. the router's f32 softmax, top-k experts per token and their
     probabilities renormalised over the k;
  2. each assignment's position within its expert, from a stable sort of
     the expert ids (token order within an expert);
  3. the tokens scattered into an (E, C, D) buffer of capacity C per
     expert; an assignment past its expert's capacity is dropped;
  4. every expert's SwiGLU as batched products over the buffer;
  5. each token's k expert rows gathered back and summed with their
     router weights (a dropped assignment weighs 0).

Capacity counts every row the caller passes, padding included: C =
max(ceil(T·k/E · capacity_factor), 1) with T = B·S, so which assignments
drop depends on the batch shape, as in the reference.

Determinism. The reference combines with a scatter-add; on CUDA
``index_add_`` adds with atomics in no fixed order. Each token has exactly
k (expert, slot) entries, so the combine here gathers them through the
inverse map and sums over k in a fixed order, and the dispatch is an
``index_put`` (at most one writer per kept slot). The expert products are
plain ``torch.bmm``: the reference computes them with XLA einsums outside
any Pallas kernel.

Expert parallelism (``moe_apply_ep``) needs the sharding plans of ROADMAP
A15 and raises until then.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _route(params, xt, cfg):
    """(probs (T, E), top_p (T, K) renormalised, top_e (T, K)) of the
    router for the token rows xt (T, D), in f32."""
    logits = xt.float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, cfg.experts_per_token, dim=-1)
    return probs, top_p / torch.sum(top_p, dim=-1, keepdim=True), top_e


def capacity(tokens: int, cfg) -> int:
    """Slots per expert for `tokens` rows: max(ceil(T·k/E · factor), 1)."""
    return max(math.ceil(tokens * cfg.experts_per_token / cfg.num_experts
                         * cfg.capacity_factor), 1)


def _counts(flat_e, E):
    """Assignments per expert (E,) int64. A scatter of ones, not
    ``bincount``, which reads the largest id back to the host on CUDA;
    integer sums do not depend on the order of the atomics."""
    return torch.zeros(E, dtype=torch.int64, device=flat_e.device
                       ).scatter_add_(0, flat_e, torch.ones_like(flat_e))


def _slots(flat_e, E, C):
    """Each assignment's (expert, slot): its rank among the assignments to
    its expert in token order; ranks at or past C go to (0, C), the drop
    slot. Returns (expert, slot, keep), each (T·K,)."""
    n = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    counts = _counts(flat_e, E)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n, device=flat_e.device) - starts[flat_e[order]]
    pos = torch.empty_like(rank)
    pos[order] = rank
    keep = pos < C
    return torch.where(keep, flat_e, 0), torch.where(keep, pos, C), keep


def _experts(params, buf):
    """Every expert's SwiGLU over its slots: buf (E, C, D) -> (E, C, D)."""
    g = torch.bmm(buf, params["w_gate"])
    h = torch.bmm(buf, params["w_in"])
    act = F.silu(g.float()).to(buf.dtype) * h
    return torch.bmm(act, params["w_out"])


def moe_apply(params, x, cfg):
    """x (B, S, D) -> (B, S, D). params: {"router" (D, E) f32, "w_gate",
    "w_in" (E, D, F), "w_out" (E, F, D)}."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    T = B * S
    C = capacity(T, cfg)
    xt = x.reshape(T, D)
    _, top_p, top_e = _route(params, xt, cfg)
    expert, slot, keep = _slots(top_e.reshape(-1), E, C)

    # dispatch: one writer per kept (expert, slot); the dropped rows all
    # land on the drop slot C, which is cut off
    buf = x.new_zeros((E, C + 1, D)).index_put(
        (expert, slot), torch.repeat_interleave(xt, K, dim=0))
    y = _experts(params, buf[:, :C])

    # combine: each token's K rows through the inverse map, summed in a
    # fixed order (the zero row C stands in for a dropped assignment)
    y = torch.cat([y, y.new_zeros((E, 1, D))], dim=1)
    w = (top_p.reshape(-1) * keep).to(y.dtype)
    rows = y[expert, slot] * w[:, None]                           # (T·K, D)
    return torch.sum(rows.reshape(T, K, D), dim=1).reshape(B, S, D)


def load_balance_loss(params, x, cfg):
    """Auxiliary load-balancing loss (Shazeer-style): E · Σ_e f_e · p_e,
    with f_e the share of top-k assignments routed to expert e and p_e its
    mean router probability."""
    E = cfg.num_experts
    probs, _, top_e = _route(params, x.reshape(-1, x.shape[-1]), cfg)
    f = _counts(top_e.reshape(-1), E).float() / probs.shape[0]
    return E * torch.sum(f * torch.mean(probs, dim=0))


def ep_applicable(cfg, plan) -> bool:
    """Whether the expert-parallel path applies: never without a sharding
    plan; the port has no plans before ROADMAP A15."""
    if plan is None or not cfg.num_experts:
        return False
    raise NotImplementedError(
        "expert parallelism over a sharding plan comes with ROADMAP A15")


def moe_apply_ep(params, x, cfg, plan):
    """The reference's expert-parallel path (experts sharded over the
    plan's model axis, one psum of the partial outputs per layer)."""
    raise NotImplementedError(
        "moe_apply_ep (expert parallelism over a sharding plan) comes with "
        "ROADMAP A15")
