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

Under a sharding plan (``core.parallelism``) the layer takes DTensors.
`moe_apply_ep` is the reference's expert-parallel path: each rank routes
its data shard's tokens to its own slice of the experts at the per-shard
capacity, and the partial outputs are summed over the tensor axes.
`moe_apply` (the serving verbs' MoE, and training's where the experts do
not divide the tensor axes) keeps the capacity global, as the reference's
GSPMD step keeps it: where the tensor axes divide the experts each rank
routes the whole batch and runs its own experts, and the partial outputs
are summed; otherwise it gathers its inputs and runs on every rank, as
`load_balance_loss` does.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core import parallelism as par


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


def _replicated(fn):
    """fn over DTensor arguments run on every rank on their whole values
    (gathered), its result a replicated DTensor. Every rank computes the
    same thing, so the gradients stay replicated too."""
    def run(params, x, cfg):
        if not par.is_dtensor(x):
            return fn(params, x, cfg)
        from torch.distributed.tensor import DTensor, Replicate
        mesh = x.device_mesh
        rep = (Replicate(),) * mesh.ndim

        def local(t):
            return (t.redistribute(mesh, rep).to_local()
                    if par.is_dtensor(t) else t)
        out = fn({k: local(v) for k, v in params.items()}, local(x), cfg)
        return DTensor.from_local(out, mesh, rep, run_check=False)
    return run


def _moe(params, x, cfg, lo=0, n=None):
    """x (B, S, D) -> (B, S, D) at the global capacity, as run by the
    experts lo .. lo + n (all of them by default), whose weights `params`
    holds: the other experts' assignments add nothing."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    n = E if n is None else n
    T = B * S
    C = capacity(T, cfg)
    xt = x.reshape(T, D)
    _, top_p, top_e = _route(params, xt, cfg)
    expert, slot, keep = _slots(top_e.reshape(-1), E, C)
    if n < E:                           # this rank's experts only
        keep = keep & (expert >= lo) & (expert < lo + n)
        expert = torch.where(keep, expert - lo, 0)
        slot = torch.where(keep, slot, C)

    # dispatch: one writer per kept (expert, slot); the dropped rows all
    # land on the drop slot C, which is cut off
    buf = x.new_zeros((n, C + 1, D)).index_put(
        (expert, slot), torch.repeat_interleave(xt, K, dim=0))
    y = _experts(params, buf[:, :C])

    # combine: each token's K rows through the inverse map, summed in a
    # fixed order (the zero row C stands in for a dropped assignment)
    y = torch.cat([y, y.new_zeros((n, 1, D))], dim=1)
    w = (top_p.reshape(-1) * keep).to(y.dtype)
    rows = y[expert, slot] * w[:, None]                           # (T·K, D)
    return torch.sum(rows.reshape(T, K, D), dim=1).reshape(B, S, D)


def moe_apply(params, x, cfg):
    """x (B, S, D) -> (B, S, D). params: {"router" (D, E) f32, "w_gate",
    "w_in" (E, D, F), "w_out" (E, F, D)}. Under a plan whose tensor axes
    divide the experts, every rank routes the whole batch at the global
    capacity (the same slots as without a plan) and runs its own experts
    only; the partial outputs are summed over the tensor axes, as GSPMD
    splits the reference's experts. Otherwise the whole layer runs on
    every rank (`_replicated`)."""
    plan = par.current_plan()
    if par.is_dtensor(x) and ep_applicable(cfg, plan):
        return _moe_split(params, x, cfg, plan)
    return _replicated(_moe)(params, x, cfg)


def _moe_split(params, x, cfg, plan):
    from torch.distributed.tensor import DTensor, Replicate
    mesh = x.device_mesh
    rep = (Replicate(),) * mesh.ndim
    n = cfg.num_experts // plan.axis_size(plan.tensor_axes)
    w_pl = par.placements(par.P(plan.tensor_axes), mesh)
    # every data rank runs the same whole batch: a gradient is a partial
    # sum over the tensor axes only
    t = plan.tensor_axes
    local = {"router": _local(params["router"], rep, t)}
    local.update({k: _local(params[k], w_pl, t)
                  for k in ("w_gate", "w_in", "w_out")})
    out = _moe(local, _local(x, rep, t), cfg, _ep_rank(mesh, plan) * n, n)
    out = _SumOverGroups.apply(out, *(mesh.get_group(a)
                                      for a in plan.tensor_axes))
    return DTensor.from_local(out, mesh, rep, run_check=False,
                              shape=x.shape, stride=x.stride())


def _local(t, want, partial=None):
    """The rank's tensor of the DTensor `t` redistributed to `want`. The
    gradient of a value replicated over a mesh dim named in `partial`
    (default: every dim) is each rank's partial contribution there: every
    rank runs other experts / rows."""
    from torch.distributed.tensor import Partial, Replicate
    names = t.device_mesh.mesh_dim_names
    grad = tuple(Partial() if isinstance(p, Replicate)
                 and (partial is None or names[i] in partial) else p
                 for i, p in enumerate(want))
    return t.redistribute(t.device_mesh, want).to_local(grad_placements=grad)


def _ep_rank(mesh, plan) -> int:
    """This rank's index over the plan's tensor axes, major first, as the
    experts' Shard splits them."""
    names = list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    r = 0
    for a in plan.tensor_axes:
        i = names.index(a)
        r = r * mesh.size(i) + coord[i]
    return r


@_replicated
def load_balance_loss(params, x, cfg):
    """Auxiliary load-balancing loss (Shazeer-style): E · Σ_e f_e · p_e,
    with f_e the share of top-k assignments routed to expert e and p_e its
    mean router probability."""
    E = cfg.num_experts
    probs, _, top_e = _route(params, x.reshape(-1, x.shape[-1]), cfg)
    f = _counts(top_e.reshape(-1), E).float() / probs.shape[0]
    return E * torch.sum(f * torch.mean(probs, dim=0))


def ep_applicable(cfg, plan) -> bool:
    """Whether the expert-parallel path applies: a plan with tensor axes
    whose size divides the experts."""
    if plan is None or not cfg.num_experts:
        return False
    axes = plan.tensor_axes
    if not axes:
        return False
    ep = plan.axis_size(axes)
    return cfg.num_experts % ep == 0 and cfg.num_experts >= ep


class _SumOverGroups(torch.autograd.Function):
    """All-reduce (sum) over each process group in turn; the backward is
    the identity. The summed output's consumers are replicated over these
    groups, so each rank's gradient of it is already the whole gradient
    (an all-reduce there would multiply it by the group size)."""

    @staticmethod
    def forward(ctx, t, *groups):
        t = t.clone()
        for g in groups:
            dist.all_reduce(t, group=g)
        return t

    @staticmethod
    def backward(ctx, grad):
        return (grad,) + (None,) * len(ctx.needs_input_grad[1:])


def moe_apply_ep(params, x, cfg, plan):
    """Expert-parallel MoE (survey §5.2): the experts are split over the
    plan's tensor axes (E / ep per rank) and x (B, S, D) is split over its
    batch axes and replicated over the tensor axes, so every rank already
    holds the tokens its experts need and the dispatch moves nothing. Each
    rank routes its T_loc tokens to its own experts at the per-shard
    capacity C_loc = ceil(T_loc·k/E · capacity_factor) and the only
    collective is one sum of the (T_loc, D) partial outputs over the tensor
    axes. Drops can differ from the global-capacity `moe_apply` (the
    reference's documented approximation). x and params are DTensors on the
    plan's mesh; returns x's shape, split over the batch axes."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = x.device_mesh
    t_axes = plan.tensor_axes
    E, K = cfg.num_experts, cfg.experts_per_token
    E_loc = E // plan.axis_size(t_axes)
    x_spec = par.clean_spec(plan, x.shape, par.P(plan.batch_axes or None))
    x_pl = par.placements(x_spec, mesh, x.shape)
    w_pl = par.placements(par.P(t_axes), mesh)
    rep = (Replicate(),) * mesh.ndim
    router = _local(params["router"], rep)
    w = {k: _local(params[k], w_pl) for k in ("w_gate", "w_in", "w_out")}
    xl = _local(x, x_pl)
    B, S, D = xl.shape
    T = B * S
    C = capacity(T, cfg)
    xt = xl.reshape(T, D)
    _, top_p, top_e = _route({"router": router}, xt, cfg)
    lo = _ep_rank(mesh, plan) * E_loc
    flat_e = top_e.reshape(-1)
    mine = (flat_e >= lo) & (flat_e < lo + E_loc)
    # rank within its local expert, among this rank's assignments only
    # (E_loc is the discard bin)
    expert, slot, keep = _slots(torch.where(mine, flat_e - lo, E_loc),
                                E_loc + 1, C)
    keep = keep & mine
    expert = torch.where(keep, expert, 0)
    slot = torch.where(keep, slot, C)
    buf = xl.new_zeros((E_loc, C + 1, D)).index_put(
        (expert, slot), torch.repeat_interleave(xt, K, dim=0))
    y = _experts(w, buf[:, :C])
    y = torch.cat([y, y.new_zeros((E_loc, 1, D))], dim=1)
    wt = (top_p.reshape(-1) * keep).to(y.dtype)
    out = torch.sum((y[expert, slot] * wt[:, None]).reshape(T, K, D), dim=1)
    out = _SumOverGroups.apply(out, *(mesh.get_group(a) for a in t_axes))
    return DTensor.from_local(out.reshape(B, S, D), mesh, x_pl,
                              run_check=False,
                              shape=x.shape, stride=x.stride())
