"""Parallelism strategies (survey §5) as composable sharding plans, on
``torch.distributed.tensor`` (DTensor) over a ``DeviceMesh`` (counterpart of
``repro.core.parallelism``).

A `ShardingPlan` maps parameter / activation / cache trees to specs `P`
over a mesh with axes drawn from ('pod', 'data', 'model'). The rules are
the reference's, rule for rule; a spec becomes DTensor placements by
`placements`: ``Shard(d)`` on each mesh dim that the spec's entry for
tensor dim d names, else ``Replicate()``.

Presets (selectable via ``--plan``):
  dp           pure data parallelism (§5.1): params replicated, batch sharded
               over every mesh axis (all devices are data).
  tp           pure model parallelism (§5.2): heads / FFN / experts / vocab
               sharded over *all* axes; batch replicated.
  dp_tp        hybrid (§5.4, Krizhevsky "one weird trick"): batch over
               ('pod','data'), tensor dims over 'model'.
  dp_tp_zero1  dp_tp + optimizer state sharded over 'data' (the
               reduce-scatter descendant of the sharded parameter server,
               §6.2).
  dp_tp_seq    dp_tp + sequence sharding of long KV caches over 'data' for
               decode shapes.
  dp_tp_sp     dp_tp + Megatron-style sequence parallelism of the residual
               stream over 'model' between layers (with ZeRO-1:
               dp_tp_sp_zero1).

The rules need only the mesh's axis sizes, so a plan takes either a real
``DeviceMesh`` (with ``mesh_dim_names``) or an `AbstractMesh` (names and
sizes, no ranks). Activation constraints inside model code go through
`constrain(x, names)`, a no-op unless a plan context is active and `x` is a
DTensor, so the models run unchanged without a plan.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
import re
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.spans import span

PLANS = ("dp", "tp", "dp_tp", "dp_tp_zero1", "dp_tp_seq", "dp_tp_sp",
         "dp_tp_sp_zero1")

_ctx: contextvars.ContextVar = contextvars.ContextVar("sharding_ctx",
                                                      default=None)


class P(tuple):
    """A partition spec: one entry per tensor dim, each None, a mesh axis
    name, or a tuple of names (major first). A one-name tuple is stored as
    the name and an empty one as None, as ``jax.sharding.PartitionSpec``
    stores them."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, tuple) and len(e) <= 1:
                return e[0] if e else None
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


class AbstractMesh:
    """Axis names and sizes without ranks: the rules' view of a mesh (the
    counterpart of ``jax.sharding.AbstractMesh``)."""

    def __init__(self, shape, axes):
        if len(shape) != len(axes):
            raise ValueError(f"shape {shape} and axes {axes} differ in rank")
        self.shape = dict(zip(axes, (int(s) for s in shape)))
        self.axis_names = tuple(axes)


def mesh_shape(mesh) -> dict:
    """{axis name: size} of an `AbstractMesh` or a ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _axes(entry) -> tuple:
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _divisible(n: Optional[int], axes, shape: dict) -> bool:
    if n is None:
        return False
    size = math.prod(shape[a] for a in axes)
    return n % size == 0 and n >= size


@dataclass
class ShardingPlan:
    name: str
    mesh: object

    @property
    def shape(self) -> dict:
        return mesh_shape(self.mesh)

    @property
    def batch_axes(self) -> tuple:
        ax = tuple(a for a in ("pod", "data") if a in self.shape)
        if self.name == "dp":           # every axis is a data axis
            return ax + (("model",) if "model" in self.shape else ())
        if self.name == "tp":
            return ()
        return ax

    @property
    def tensor_axes(self) -> tuple:
        if self.name == "dp":
            return ()
        if self.name == "tp":
            return tuple(a for a in ("pod", "data", "model")
                         if a in self.shape)
        return ("model",)

    @property
    def seq_axes(self) -> tuple:
        """Axis for activation / cache sequence sharding: 'data' for the
        long-context decode plan; 'model' for Megatron-style sequence
        parallelism (residual stream sharded between layers)."""
        if self.name == "dp_tp_seq":
            return ("data",)
        if self.name in ("dp_tp_sp", "dp_tp_sp_zero1"):
            return ("model",)
        return ()

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in axes)

    # ---------------------------------------------------------------- helpers
    def _shard_dim(self, size):
        """tensor axes if divisible, else nothing."""
        return (self.tensor_axes
                if _divisible(size, self.tensor_axes, self.shape) else None)

    def spec_for_param(self, path: str, shape) -> P:
        """Name+shape-based tensor-parallel rules (§5.2: partition neurons).
        Stacked leading superblock dims are never sharded."""
        t = self.tensor_axes
        if not t:
            return P()
        dims = list(shape)

        def dspec(i):
            return self._shard_dim(dims[i])

        if re.search(r"embed/table|lm_head/w", path):
            # shard vocab dim: table (V, D) dim0; head w (D, V) dim1
            vdim = 0 if "table" in path else 1
            spec = [None] * len(dims)
            spec[vdim] = dspec(vdim)
            return P(*spec)
        if re.search(r"attn/(wq|wk|wv)", path):
            spec = [None] * len(dims)
            spec[-1] = dspec(len(dims) - 1)     # heads*hd output dim
            return P(*spec)
        if re.search(r"attn/wo", path):
            spec = [None] * len(dims)
            spec[-2] = dspec(len(dims) - 2)     # heads*hd input dim
            return P(*spec)
        if re.search(r"(mlp|cm_k)/(w_gate|w_in)|cm_k", path):
            spec = [None] * len(dims)
            spec[-1] = dspec(len(dims) - 1)     # ffn dim
            return P(*spec)
        if re.search(r"(mlp/w_out|cm_v)", path):
            spec = [None] * len(dims)
            spec[-2] = dspec(len(dims) - 2)
            return P(*spec)
        if re.search(r"moe/(w_gate|w_in|w_out)", path):
            # (..., E, D, F) / (..., E, F, D): expert dim if divisible, else F
            e_dim = len(dims) - 3
            f_dim = len(dims) - 2 if "w_out" in path else len(dims) - 1
            spec = [None] * len(dims)
            if _divisible(dims[e_dim], t, self.shape):
                spec[e_dim] = t
            else:
                spec[f_dim] = dspec(f_dim)
            return P(*spec)
        if re.search(r"rwkv/(wr|wk|wv|wg|wo)|mamba/(in_proj|out_proj)", path):
            spec = [None] * len(dims)
            spec[-1] = dspec(len(dims) - 1)
            return P(*spec)
        return P()  # norms, biases, routers, small decays: replicated

    def spec_for_batch_leaf(self, path: str, shape) -> P:
        """Input batch: tokens/labels (B, S), embeds (B, S, D), M-RoPE
        positions (3, B, S)."""
        b = self.batch_axes
        bspec = b if _divisible(shape[0], b, self.shape) else None
        if path.endswith("positions") and len(shape) == 3 and shape[0] == 3:
            b2 = b if _divisible(shape[1], b, self.shape) else None
            return P(None, b2, None)
        return P(bspec, *([None] * (len(shape) - 1)))

    def spec_for_cache_leaf(self, path: str, shape) -> P:
        """KV caches (n_sb, B, S, Hkv, hd) and SSM states (n_sb, B, H, ...)."""
        b = self.batch_axes
        spec = [None] * len(shape)
        if len(shape) >= 2 and _divisible(shape[1], b, self.shape):
            spec[1] = b            # batch dim
        elif "/k" in path or "/v" in path:
            # batch unshardable (b=1): shard the cache sequence instead
            seq_ax = self.seq_axes or (
                ("data",) if "data" in self.shape
                and self.name not in ("dp", "tp") else ())
            if (len(shape) >= 3 and seq_ax
                    and _divisible(shape[2], seq_ax, self.shape)):
                spec[2] = seq_ax
        # shard kv heads / state heads over tensor axes when divisible
        if len(shape) >= 4 and self.tensor_axes:
            hdim = 3 if ("/k" in path or "/v" in path) else 2
            if (hdim < len(shape)
                    and _divisible(shape[hdim], self.tensor_axes, self.shape)):
                spec[hdim] = self.tensor_axes
        return P(*spec)

    # ------------------------------------------------------------- tree specs
    def tree_specs(self, tree, leaf_fn, path=()):
        """leaf_fn("a/b/c", shape) over a nested dict of tensors or of
        anything with a ``shape``; the same nesting of specs."""
        if isinstance(tree, dict):
            return {k: self.tree_specs(tree[k], leaf_fn, path + (k,))
                    for k in sorted(tree)}
        return leaf_fn("/".join(path), tuple(tree.shape))

    def param_specs(self, params):
        return self.tree_specs(params, self.spec_for_param)

    def batch_specs(self, batch):
        return self.tree_specs(batch, self.spec_for_batch_leaf)

    def cache_specs(self, cache):
        return self.tree_specs(cache, self.spec_for_cache_leaf)

    def opt_specs(self, params, zero1: Optional[bool] = None):
        """Optimizer-moment specs; ZeRO-1 additionally shards the largest
        still-unsharded divisible dim over the data axis (sharded-PS, §6.2)."""
        zero1 = (self.name in ("dp_tp_zero1", "dp_tp_sp_zero1")
                 if zero1 is None else zero1)
        if not zero1 or "data" not in self.shape:
            return self.param_specs(params)

        def upgrade(path, shape):
            spec = list(self.spec_for_param(path, shape))
            spec += [None] * (len(shape) - len(spec))
            order = sorted(range(len(shape)), key=lambda i: -shape[i])
            for i in order:
                if spec[i] is None and _divisible(shape[i], ("data",),
                                                  self.shape):
                    spec[i] = "data"
                    break
            return P(*spec)

        return self.tree_specs(params, upgrade)

    # --------------------------------------------------- activation constraints
    def logical_spec(self, names) -> P:
        out = []
        for n in names:
            if n == "batch":
                out.append(self.batch_axes or None)
            elif n == "seq":
                out.append(self.seq_axes or None)
            elif n in ("heads", "ffn", "vocab", "expert"):
                out.append(self.tensor_axes or None)
            elif n == "capacity":
                out.append(self.batch_axes or None)
            else:
                out.append(None)
        return P(*out)


def make_plan(name: str, mesh) -> ShardingPlan:
    if name not in PLANS:
        raise ValueError(f"unknown plan {name!r}; options: {PLANS}")
    return ShardingPlan(name, mesh)


# ------------------------------------------------------------------- context
@contextlib.contextmanager
def plan_context(plan: Optional[ShardingPlan]):
    """Make `plan` the current plan (None: no plan) for the block. The
    forward and the backward of a planned step both run inside it: DTensor
    treats a plain tensor that meets a DTensor as replicated
    (``implicit_replication``), as GSPMD treats a constant."""
    token = _ctx.set(plan)
    try:
        if plan is None:
            yield
        else:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                yield
    finally:
        _ctx.reset(token)


def current_plan():
    """The active ShardingPlan, or None outside a plan context."""
    return _ctx.get()


def checkpoint(fn, *args):
    """``torch.utils.checkpoint`` (non-reentrant) of fn(*args), whose
    recomputation runs in the plan context of its forward pass: on the
    card the autograd engine runs the backward pass, and with it the
    recomputation, on a thread of its own, which the plan's context
    variable does not reach (the recomputed attention then took every
    head and row, and its shapes differed from the saved ones). While a
    profiler records, fn's first call runs in the range "remat/forward"
    and the backward pass's recomputation in "remat/recompute"
    (``repro_torch.spans``)."""
    from torch.utils.checkpoint import checkpoint as ckpt
    calls = [0]

    def labelled(*a):
        calls[0] += 1
        with span("remat/recompute" if calls[0] > 1 else "remat/forward"):
            return fn(*a)
    plan = current_plan()
    if plan is None:
        return ckpt(labelled, *args, use_reentrant=False)
    return ckpt(labelled, *args, use_reentrant=False, context_fn=lambda: (
        contextlib.nullcontext(), plan_context(plan)))


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def clean_spec(plan, shape, spec) -> P:
    """`spec` with every entry whose axes do not divide its dim dropped
    (GSPMD would pad; avoid), padded with None to the rank of `shape`. An
    entry naming an axis that an earlier dim already took is dropped too:
    dp_tp_seq's ("batch", "seq") names 'data' twice, which the reference
    passes to ``with_sharding_constraint`` as it is and which JAX refuses
    (``DuplicateSpecError``) whenever both dims divide; the batch keeps
    the axis."""
    out, used = [], set()
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    for dim, entry in zip(shape, entries):
        if entry is None:
            out.append(None)
            continue
        axes = _axes(entry)
        ok = _divisible(dim, axes, plan.shape) and not used & set(axes)
        out.append(axes if ok else None)
        used |= set(axes) if ok else set()
    return P(*out)


def constrain(x, names):
    """Redistribute `x` to the logical spec of `names` if a plan context is
    active and `x` is a DTensor; else `x` itself. As the reference's
    ``with_sharding_constraint``, whose transpose constrains the cotangent
    to the same spec, the gradient reaching this point is put in the same
    placements in the backward pass (`_ConstrainGrad`): a Megatron layer's
    "f" and "g" (the all-reduce of a partial gradient sum before it
    reaches the weights of the layer below). Without it DTensor carries
    partial sums down the residual stream and, in each matmul's backward,
    gathers a split weight or activation whole instead (every rank then
    computes the whole layer's gradient)."""
    plan = _ctx.get()
    if plan is None or not is_dtensor(x):
        return x
    names = tuple(names)
    if len(names) < x.ndim:            # leading stack dims
        names = (None,) * (x.ndim - len(names)) + names
    elif len(names) > x.ndim:
        names = names[-x.ndim:]
    spec = clean_spec(plan, x.shape, plan.logical_spec(names))
    want = placements(spec, x.device_mesh, x.shape)
    if tuple(x.placements) != want:
        x = x.redistribute(x.device_mesh, want)
    if x.requires_grad:
        x = _ConstrainGrad.apply(x)
    return x


class _ConstrainGrad(torch.autograd.Function):
    """Identity on a DTensor; its gradient is redistributed to the
    forward value's placements."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if is_dtensor(grad) and tuple(grad.placements) != ctx.placements:
            grad = grad.redistribute(ctx.mesh, ctx.placements)
        return grad


# ------------------------------------------------------------ DTensor glue
def local_call(fn, args, names, outs):
    """fn(*args) on each rank's own shards. Without DTensor arguments it is
    fn(*args). Under a plan, through ``local_map``: each argument split as
    `constrain` would split it by its logical `names` (a tuple per
    argument; None for an argument passed as it is; a plain tensor with
    names is taken as replicated, as DTensor's implicit replication takes
    it), and each result placed by its (shape, names) in `outs`. The
    recurrent scans use it: their per-head matmuls then run on plain local
    tensors (DTensor in torch 2.11 refuses to flatten a batch and a split
    head dim into a matmul's batch)."""
    mesh = next((a.device_mesh for a in args if is_dtensor(a)), None)
    if mesh is None:
        return fn(*args)
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map
    plan = _ctx.get()

    def pl(shape, n):
        if n is None:
            return None
        spec = (clean_spec(plan, shape, plan.logical_spec(n))
                if plan is not None else P())
        return placements(spec, mesh, shape)
    args = tuple(DTensor.from_local(a, mesh, (Replicate(),) * mesh.ndim,
                                    run_check=False)
                 if isinstance(a, torch.Tensor) and not is_dtensor(a)
                 and n is not None else a for a, n in zip(args, names))
    in_pl = tuple(pl(tuple(a.shape), n) if is_dtensor(a) else None
                  for a, n in zip(args, names))
    out_pl = tuple(pl(tuple(shape), n) for shape, n in outs)
    split = {d for p in out_pl for d, q in enumerate(p) if q.is_shard()}
    args = tuple(_summed_grad(a.redistribute(mesh, p), split)
                 if p is not None and a.requires_grad else a
                 for a, p in zip(args, in_pl))
    return local_map(fn, out_placements=out_pl, in_placements=in_pl,
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def _summed_grad(x, split):
    """`x` (a DTensor argument of ``local_call``), whose gradient is summed
    over each mesh dim of `split` (where the results are split) on which
    `x` is replicated: every rank's share of the results read all of `x`,
    so each rank's gradient is a partial sum. ``local_map`` would take it
    as replicated (each rank keeping only its own share)."""
    dims = tuple(d for d in sorted(split) if x.placements[d].is_replicate())
    return _SummedGrad.apply(x, dims) if dims else x


class _SummedGrad(torch.autograd.Function):
    """Identity on a DTensor; its gradient's mesh dims `dims` are taken as
    partial sums and reduced (an all-reduce each)."""

    @staticmethod
    def forward(ctx, x, dims):
        ctx.dims = dims
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import DTensor, Partial
        want = tuple(grad.placements)
        partial = tuple(Partial() if d in ctx.dims else q
                        for d, q in enumerate(want))
        grad = DTensor.from_local(grad.to_local(), grad.device_mesh,
                                  partial, run_check=False,
                                  shape=grad.shape, stride=grad.stride())
        return grad.redistribute(grad.device_mesh, want), None


def placements(spec, mesh, shape=None) -> tuple:
    """DTensor placements of `spec` on the ``DeviceMesh`` `mesh`: Shard(d)
    on each mesh dim that entry d names, else Replicate(). A multi-axis
    entry must list its axes in mesh order (major first), as every rule
    here does. A mesh axis of size 1 splits nothing (Shard and Replicate
    hold the same values there), so:
      * given the tensor's `shape`, a dim of size 1 stays replicated
        (DTensor refuses to view, flatten or squeeze a split singleton);
      * a multi-axis entry leaves out its axes of size 1, so that a dim is
        split over two mesh dims only where both split it (DTensor in
        torch 2.11 refuses such a hybrid split in many ops, ``index``
        among them, and a (1, 1) mesh then needs none)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    sizes = dict(zip(names, mesh.mesh.shape))
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None or (shape is not None and shape[d] == 1):
            continue
        axes = _axes(entry)
        if len(axes) > 1:
            axes = tuple(a for a in axes if sizes[a] > 1)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in mesh order "
                             f"{tuple(names)}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {names[i]} shards two dims of "
                                 f"{spec}")
            out[i] = Shard(d)
    return tuple(out)


def _local_offset(shape, mesh, placements) -> tuple:
    """The global offset of this rank's shard of a DTensor of `shape` in
    `placements` (host bookkeeping: ``core.op_analysis`` runs it outside
    its modes)."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    return tuple(compute_local_shape_and_global_offset(
        shape, mesh, placements)[1])


def embedding(table, ids):
    """``table[ids]`` for a DTensor `table` (V, D) and `ids` (a DTensor or
    a plain tensor, taken as replicated), computed on each rank's local
    tensors: the ids keep their batch split (Shard(0)), the table its
    vocabulary split (Shard(0)); each rank looks up the ids that fall in
    its own rows and leaves zeros elsewhere, so the output is a partial
    sum over the vocabulary split (DTensor's masked embedding, written
    out). The table's gradient is a partial sum over the mesh dims that
    split the batch. Going around DTensor's ``index`` keeps its backward
    (an ``index_put``) off DTensors, which torch 2.11 refuses under a
    sequence split."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = table.device_mesh
    if not is_dtensor(ids):
        ids = DTensor.from_local(ids, mesh, (Replicate(),) * mesh.ndim,
                                 run_check=False)

    def split0(p):
        return isinstance(p, Shard) and p.dim == 0
    t_pl = tuple(p if split0(p) else Replicate() for p in table.placements)
    i_pl = tuple(p if split0(p) and not split0(t) else Replicate()
                 for p, t in zip(ids.placements, t_pl))
    t_grad = tuple(Partial() if split0(i) else t for i, t in zip(i_pl, t_pl))
    out_pl = tuple(Partial() if split0(t) else i for i, t in zip(i_pl, t_pl))
    local = table.redistribute(mesh, t_pl).to_local(grad_placements=t_grad)
    idx = ids.redistribute(mesh, i_pl).to_local()
    lo, n = _local_offset(table.shape, mesh, t_pl)[0], local.shape[0]
    if n == table.shape[0]:
        out = local[idx]
    else:
        mine = (idx >= lo) & (idx < lo + n)
        out = local[torch.clamp(idx - lo, 0, n - 1)] * mine[..., None].to(
            local.dtype)
    shape = tuple(ids.shape) + (table.shape[1],)
    return DTensor.from_local(out, mesh, out_pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def write_along(dst, dim, index, src):
    """``dst[(slice(None),) * dim + (index,)] = src`` in place, where `dst`
    may be a DTensor split along `dim` (dp_tp_seq's sequence-split cache):
    there each rank writes the positions of `index` (an int, or a 1-D
    tensor of distinct positions) that fall in its own shard. A plain `dst`
    is written as it is."""
    lead = (slice(None),) * dim
    if not is_dtensor(dst):
        dst[lead + (index,)] = src
        return dst
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = dst.device_mesh
    drop = isinstance(index, int)
    want = []
    for p in dst.placements:
        if isinstance(p, Shard) and p.dim == dim:
            want.append(Replicate())
        elif isinstance(p, Shard) and drop and p.dim > dim:
            want.append(Shard(p.dim - 1))
        else:
            want.append(p)
    if not any(getattr(p, "dim", None) == dim for p in dst.placements):
        # `src` in the placements of the rows it lands in
        if is_dtensor(src) and tuple(src.placements) != tuple(want):
            src = src.redistribute(mesh, want)
        dst[lead + (index,)] = src
        return dst
    if not is_dtensor(src):
        src = DTensor.from_local(src, mesh, (Replicate(),) * mesh.ndim,
                                 run_check=False)
    src = src.redistribute(mesh, want).to_local()
    local = dst.to_local()
    lo, n = _local_offset(dst.shape, mesh, dst.placements)[dim], \
        local.shape[dim]
    if drop:
        if lo <= index < lo + n:
            local[lead + (index - lo,)] = src
        return dst
    index = torch.as_tensor(index, device=local.device)
    mine = (index >= lo) & (index < lo + n)
    pick = torch.nonzero(mine)[:, 0]
    local[lead + (index[pick] - lo,)] = torch.index_select(src, dim, pick)
    return dst


def _map2(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map2(fn, tree[k], specs[k]) for k in tree}
    return fn(tree, specs)


def shard_tree(tree, specs, mesh):
    """Every leaf of `tree` (equal on every rank) as a DTensor on `mesh`
    with the placements of its spec in `specs` (rank 0's values are
    scattered). On a one-rank mesh every shard is the whole tensor, so the
    DTensor wraps the leaf itself (no copy). Leaves that are not tensors
    (an optimizer's step count) stay as they are."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def one(t, spec):
        if not isinstance(t, torch.Tensor):
            return t
        want = placements(spec, mesh, t.shape)
        if is_dtensor(t):
            return t.redistribute(mesh, want)
        if mesh.size() == 1:
            return DTensor.from_local(t.detach(), mesh, want,
                                      run_check=False)
        return distribute_tensor(t.detach(), mesh, want)
    return _map2(one, tree, specs)


def full(t):
    """The whole value of a DTensor (gathered) as a plain tensor; a plain
    tensor as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def full_tree(tree):
    if isinstance(tree, dict):
        return {k: full_tree(v) for k, v in tree.items()}
    return full(tree)
