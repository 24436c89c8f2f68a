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
k (expert, slot) entries, so the combine here sums each token's rows over
k in a fixed order: a gather through the inverse map, or, for a block of
the slots of a larger batch, k scatters that each write a token once
(`_to_tokens`). The dispatch gathers each slot's token row, and its
backward sums the same way (`_ToSlots`). The expert products are plain
``torch.bmm``: the reference computes them with XLA einsums outside any
Pallas kernel.

Under a sharding plan (``core.parallelism``) the layer takes DTensors.
`moe_apply_ep` is the reference's expert-parallel path: each rank routes
its data shard's tokens to its own slice of the experts at the per-shard
capacity, and the partial outputs are summed over the tensor axes.
`moe_apply` (the serving verbs' MoE, and training's where the experts do
not divide the tensor axes) keeps the capacity global, as the reference's
GSPMD step keeps it: every rank runs its own block of the dispatch buffer
(`moe_apply`), from the routing of the whole batch gathered; each rank
routes only its own rows, there and in `load_balance_loss`.
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


def _dispatch_combine(w, xt, top_p, expert, slot, keep, n, c):
    """The experts of `w` (n of them, c slots each) over the token rows xt
    (T, D): each kept assignment's token goes to its (expert, slot) of an
    (n, c, D) buffer, and each token's K rows come back weighted by top_p
    (T, K) and summed in the order of k. expert, slot and keep are
    (T·K,); a dropped assignment points at the drop slot c. Nothing of
    size (T·K, D) is made where the buffer has fewer rows than the tokens
    (a rank's block of a planned layer over the whole batch); the sums go
    through the slots then (`_to_tokens`). Returns (T, D)."""
    T, D = xt.shape
    K = top_p.shape[1]
    N = n * c
    # the buffer's row of each assignment (N: none), and the assignment of
    # each row (T·K: none); the dropped rows all land on row N, cut off
    row = torch.where(keep, expert * c + slot, N)
    ids = torch.arange(T * K, device=xt.device)
    asg = torch.full((N + 1,), T * K, dtype=ids.dtype,
                     device=xt.device).index_put((row,), ids)[:N]
    by_slots = N < T
    buf = _ToSlots.apply(xt, asg, row, K, by_slots)
    y = _experts(w, buf.reshape(n, c, D)).reshape(N, D)
    mine = asg < T * K
    wt = top_p.reshape(-1)[torch.where(mine, asg, 0)] * mine
    return _to_tokens(y * wt[:, None].to(y.dtype), asg, row, T, K, by_slots)


def _to_tokens(rows, asg, row, T, K, by_slots):
    """(T, D): each token's sum, in the order of k, of the rows (N, D) of
    its assignments (asg (N,): the assignment t·K + k of each row, T·K for
    none; row (T·K,): the row of each assignment, N for none). Through the
    tokens (`by_slots` False): each token gathers its K rows and sums
    them, a (T·K, D) gather. Through the slots: K scatters, the k-th
    adding each row of a k-th assignment into its token (one row a token:
    the sums do not depend on the order of the writes); made for a block
    of the rows of a larger batch, it never holds a (T·K, D) tensor."""
    D = rows.shape[1]
    if not by_slots:
        rows = torch.cat([rows, rows.new_zeros((1, D))])
        return torch.sum(rows[row].reshape(T, K, D), dim=1)
    out = rows.new_zeros((T + 1, D))
    tok, k_of = torch.div(asg, K, rounding_mode="floor"), asg % K
    for k in range(K):
        out.index_put_((torch.where(k_of == k, tok, T),), rows,
                       accumulate=True)
    return out[:T]


class _ToSlots(torch.autograd.Function):
    """The dispatch: row i of the result is the token row of assignment
    asg[i] of xt (T, D) (zeros for none). Its backward sums each token's
    rows with `_to_tokens`, in a fixed order (the autograd of a gather adds
    a token's K rows with atomics on CUDA)."""

    @staticmethod
    def forward(ctx, xt, asg, row, K, by_slots):
        T = xt.shape[0]
        ctx.save_for_backward(asg, row)
        ctx.T, ctx.K, ctx.by_slots = T, K, by_slots
        mine = asg < T * K
        tok = torch.div(torch.where(mine, asg, 0), K, rounding_mode="floor")
        return xt[tok] * mine[:, None].to(xt.dtype)

    @staticmethod
    def backward(ctx, grad):
        asg, row = ctx.saved_tensors
        return (_to_tokens(grad, asg, row, ctx.T, ctx.K, ctx.by_slots),
                None, None, None, None)


def _block(expert, slot, keep, E, C, experts, slots):
    """(expert, slot, keep) of the assignments in the block of experts
    `experts` = (lo, n) and slots `slots` = (lo, c) of each (None: all),
    numbered within the block; the others are dropped (slot c)."""
    e_lo, n = experts or (0, E)
    c_lo, c = slots or (0, C)
    if (n, c) != (E, C):
        keep = (keep & (expert >= e_lo) & (expert < e_lo + n)
                & (slot >= c_lo) & (slot < c_lo + c))
        expert = torch.where(keep, expert - e_lo, 0)
        slot = torch.where(keep, slot - c_lo, c)
    return expert, slot, keep, n, c


def _moe(params, x, cfg):
    """x (B, S, D) -> (B, S, D) at the global capacity."""
    B, S, D = x.shape
    E = cfg.num_experts
    T = B * S
    C = capacity(T, cfg)
    xt = x.reshape(T, D)
    _, top_p, top_e = _route(params, xt, cfg)
    expert, slot, keep = _slots(top_e.reshape(-1), E, C)
    return _dispatch_combine(params, xt, top_p, expert, slot, keep, E,
                             C).reshape(B, S, D)


def moe_apply(params, x, cfg):
    """x (B, S, D) -> (B, S, D). params: {"router" (D, E) f32, "w_gate",
    "w_in" (E, D, F), "w_out" (E, F, D)}. Under a plan every rank routes
    its own rows, and the routing of the whole batch is gathered (small:
    (T, K)), so every rank assigns the same slots at the global capacity
    (the same drops as without a plan); each runs its own block of the
    (E, C, D) dispatch buffer, as the reference's constraint ("expert",
    "capacity", None) splits it: its share of the capacity over the batch
    axes, and over the tensor axes its own experts where they divide, else
    every expert on its own columns of the F dim (the param rule splits
    the experts' E dim, else their F dim). The partial outputs are summed
    over the mesh dims that split the work (a reduce-scatter to the
    rows)."""
    if not par.is_dtensor(x):
        return _moe(params, x, cfg)
    return _moe_planned(params, x, cfg, par.current_plan())


def _own_routing(params, x, cfg):
    """The router's (probs, top_p, top_e) of the DTensor x's rows held by
    this rank (x's split of the batch; every rank of a tensor axis routes
    the same rows), each a DTensor split as those rows, and their
    placements."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = x.device_mesh
    rows_pl = tuple(p if isinstance(p, Shard) and p.dim == 0
                    else Replicate() for p in x.placements)
    own = tuple(a for a, p in zip(mesh.mesh_dim_names, rows_pl)
                if p != Replicate())
    router = _local(params["router"], (Replicate(),) * mesh.ndim, own)
    xo = x.redistribute(mesh, rows_pl).to_local()
    out = _route({"router": router}, xo.reshape(-1, x.shape[-1]), cfg)
    return tuple(DTensor.from_local(v, mesh, rows_pl, run_check=False)
                 for v in out) + (rows_pl,)


def _moe_planned(params, x, cfg, plan):
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    rep = (Replicate(),) * mesh.ndim
    B, S, D = x.shape
    E = cfg.num_experts
    T = B * S
    C = capacity(T, cfg)
    if plan is None:        # DTensors outside a plan: the whole layer
        t = b = ()
        w_pl = dict.fromkeys(("w_gate", "w_in", "w_out"), rep)
    else:
        t = plan.tensor_axes
        b = plan.batch_axes
        b = b if par._divisible(C, b, plan.shape) else ()
        w_pl = {k: par.placements(plan.spec_for_param(
            f"moe/{k}", params[k].shape), mesh)
            for k in ("w_gate", "w_in", "w_out")}
    # the mesh dims that split the work: the capacity's, and the tensor
    # axes where the weights split over them
    t = t if any(p != Replicate() for p in w_pl["w_in"]) else ()
    split = tuple(a for a in names if a in b + t and mesh.size(
        names.index(a)) > 1)
    # the routing of the rank's own rows, gathered
    _, top_p, top_e, rows_pl = _own_routing(params, x, cfg)
    top_p = _local(top_p, rep, split)
    top_e = top_e.redistribute(mesh, rep).to_local()
    expert, slot, keep = _slots(top_e.reshape(-1), E, C)
    experts = slots = None
    if ep_applicable(cfg, plan):
        n = E // plan.axis_size(t)
        experts = (_rank_over(mesh, t) * n, n)
    if b:
        c = C // plan.axis_size(b)
        slots = (_rank_over(mesh, b) * c, c)
    expert, slot, keep, n, c = _block(expert, slot, keep, E, C, experts,
                                      slots)
    w = {k: _local(params[k], w_pl[k], b) for k in w_pl}
    out = _dispatch_combine(w, _local(x, rep, split).reshape(T, D), top_p,
                            expert, slot, keep, n, c)
    partial = tuple(Partial() if a in split else Replicate() for a in names)
    out = DTensor.from_local(out.reshape(B, S, D), mesh, partial,
                             run_check=False, shape=x.shape,
                             stride=x.stride())
    return out.redistribute(mesh, rows_pl)


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


def _rank_over(mesh, axes) -> int:
    """This rank's index over the mesh axes `axes`, major first, as a
    Shard over them splits a dim."""
    names = list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    r = 0
    for a in axes:
        i = names.index(a)
        r = r * mesh.size(i) + coord[i]
    return r


def load_balance_loss(params, x, cfg):
    """Auxiliary load-balancing loss (Shazeer-style): E · Σ_e f_e · p_e,
    with f_e the share of top-k assignments routed to expert e and p_e its
    mean router probability. Under a plan each rank routes its own rows
    and the (E,) sums are added over the batch's split; the loss is a
    replicated DTensor."""
    E = cfg.num_experts
    if not par.is_dtensor(x):
        probs, _, top_e = _route(params, x.reshape(-1, x.shape[-1]), cfg)
        f = _counts(top_e.reshape(-1), E).float() / probs.shape[0]
        return E * torch.sum(f * torch.mean(probs, dim=0))
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = x.device_mesh
    rep = (Replicate(),) * mesh.ndim
    probs, _, top_e, rows_pl = _own_routing(params, x, cfg)
    partial = tuple(Partial() if p != Replicate() else p for p in rows_pl)

    def total(v):           # the sum of the rows' sums over the batch's split
        return DTensor.from_local(v, mesh, partial, run_check=False
                                  ).redistribute(mesh, rep).to_local()
    T = x.shape[0] * x.shape[1]
    p = total(torch.sum(probs.to_local(), dim=0)) / T
    f = total(_counts(top_e.to_local().reshape(-1), E)).float() / T
    return DTensor.from_local(E * torch.sum(f * p), mesh, rep,
                              run_check=False)


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
    E_loc = cfg.num_experts // plan.axis_size(t_axes)
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
    lo = _rank_over(mesh, t_axes) * E_loc
    flat_e = top_e.reshape(-1)
    mine = (flat_e >= lo) & (flat_e < lo + E_loc)
    # rank within its local expert, among this rank's assignments only
    # (E_loc is the discard bin)
    expert, slot, keep = _slots(torch.where(mine, flat_e - lo, E_loc),
                                E_loc + 1, C)
    keep = keep & mine
    expert = torch.where(keep, expert, 0)
    slot = torch.where(keep, slot, C)
    out = _dispatch_combine(w, xt, top_p, expert, slot, keep, E_loc, C)
    out = _SumOverGroups.apply(out, *(mesh.get_group(a) for a in t_axes))
    return DTensor.from_local(out.reshape(B, S, D), mesh, x_pl,
                              run_check=False,
                              shape=x.shape, stride=x.stride())
