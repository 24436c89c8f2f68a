"""Op-level cost analysis of a PyTorch call — the dry run's "profiler"
(counterpart of ``repro.core.hlo_analysis``, which parses XLA's optimized
HLO).

`OpAnalysis` is a ``TorchDispatchMode`` that sees every aten op (and every
custom op, such as B6's ``repro_torch::flash_attention_fwd``) that a call
issues on a rank's own tensors. In eager PyTorch an op is one kernel, as a
top-level HLO op or fusion is in the reference, and a Python loop is
unrolled by running it, so trip counts multiply by construction. Per op:

  * ``flops``      — from ``torch.utils.flop_counter``'s formulas (mm,
                     addmm, bmm, baddbmm, convolutions, SDPA) and those the
                     port registers (B6: 4·B·H·S·S·hd); the counterpart of
                     ``_dot_flops`` / ``_conv_flops``.
  * ``hbm_bytes``  — operand plus result bytes (a broadcast operand counts
                     its distinct elements), with the reference's exceptions
                     in eager terms: an op whose outputs only alias its
                     inputs (a view) launches nothing and costs 0; ``copy_``
                     into a slice, ``index_put_``, ``scatter_`` and their
                     kin count the update written (2 × update + indices),
                     not the whole buffer, as dynamic-update-slice does.
  * collectives    — the result bytes of each ``_c10d_functional``
                     collective and c10d op (the point-to-point receives of
                     ``core.pipeline``'s hops as ``collective-permute``),
                     keyed by the reference's names.
  * ``memory``     — storages are tracked while they live (each storage
                     once, however many views share it; a weak reference per
                     storage frees it when its last tensor goes).
                     ``argument_size_in_bytes``: the call's tensor
                     arguments; ``output_size_in_bytes``: its results;
                     ``alias_size_in_bytes``: results that are argument
                     storages (the train step updates params and optimizer
                     state in place); ``temp_size_in_bytes``: the peak of
                     live bytes beyond the arguments, less the new results,
                     so argument + temp + output − alias is the predicted
                     peak. With call sites, ``top_ops(metric="peak_bytes")``
                     is what is live at that peak, by the op, result shape
                     and call site that made each storage.

DTensor ops are left to the subclass (the mode returns ``NotImplemented``),
which issues the local ops and collectives that one rank runs: the numbers
are per rank, as the reference's SPMD module is per device. The global-shape
op that DTensor's sharding propagation runs to learn an output's shape is
not a rank's work and is not counted. The same code counts a real run (CPU
or CUDA tensors) and a trace on fake tensors (``FakeTensorMode``, nothing
allocated). While the analysis is active, the port's host bookkeeping on a
traced path (RoPE's device constants, DTensor shard offsets:
`_HOST_FUNCTIONS`) runs outside the modes, so a trace caches no fake
constant and counts what a real run counts.
"""
from __future__ import annotations

import contextlib
import sys
import threading
import weakref
from collections import defaultdict

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")

_COLLECTIVES = {
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.allgather_into_tensor_coalesced_": "all-gather",
    "c10d.allreduce_": "all-reduce",
    "c10d.allreduce_coalesced_": "all-reduce",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "c10d.alltoall_": "all-to-all",
    "c10d.alltoall_base_": "all-to-all",
    # DTensor's Shard(i) -> Shard(j) redistribution (torch 2.11)
    "_dtensor.shard_dim_alltoall": "all-to-all",
    # a hop of core.pipeline: its receive is the permute's result (the
    # send, which has none, is not counted apart)
    "c10d.recv_": "collective-permute",
}

# in-place writes of an update into a buffer: 2 x update + indices (the
# reference's dynamic-update-slice / scatter rule), the buffer unread
_UPDATE_ARG = {
    "aten.index_put_": "values", "aten._index_put_impl_": "values",
    "aten.scatter_": "src", "aten.scatter_add_": "src",
    "aten.scatter_reduce_": "src", "aten.index_copy_": "source",
    "aten.index_add_": "source", "aten.masked_scatter_": "source",
    "aten.put_": "source",
}

_DTYPE_NAMES = {
    torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
    torch.float64: "f64", torch.int64: "s64", torch.int32: "s32",
    torch.int16: "s16", torch.int8: "s8", torch.uint8: "u8",
    torch.bool: "pred", torch.complex64: "c64",
}

_local = threading.local()


def _in_propagation() -> bool:
    return getattr(_local, "propagating", 0) > 0


def _outside_modes(fn):
    """`fn` run outside every dispatch mode (this one and the fake
    tensors'): host bookkeeping, whose index tensors a fake trace could not
    read back."""
    from torch.utils._python_dispatch import _disable_current_modes

    def wrapped(*args, **kwargs):
        with _disable_current_modes():
            return fn(*args, **kwargs)
    return wrapped


def _flagged(fn):
    """`fn` run with the thread-local flag set that makes the mode skip
    its ops."""
    def wrapped(*args, **kwargs):
        _local.propagating = getattr(_local, "propagating", 0) + 1
        try:
            return fn(*args, **kwargs)
        finally:
            _local.propagating -= 1
    return wrapped


# the port's own host bookkeeping on a traced path: the device constants
# that model code caches by device (a fake trace would cache a fake tensor
# into a later real run, and a real run with a cold cache would count the
# host copy) and DTensor shard offsets (built from host index tensors, which
# a fake trace cannot read back); run outside the modes while the analysis
# is active
_HOST_FUNCTIONS = (("repro_torch.models.layers", "_rope_freqs_on"),
                   ("repro_torch.models.layers", "_mrope_select_on"),
                   ("repro_torch.core.parallelism", "_local_offset"))


def _patches() -> list:
    """(owner, name, wrapper) of every function the analysis wraps while
    it is active: DTensor's sharding propagation (which decides each op's
    placements, and runs the op on empty global-shape fake tensors to learn
    its output's shape) runs outside the dispatch modes where torch enters
    it from Python, and with the mode's skip flag set where it runs the
    op: it is not a rank's work; and `_HOST_FUNCTIONS` run outside the
    modes."""
    import importlib
    out = [(importlib.import_module(mod), name, _outside_modes)
           for mod, name in _HOST_FUNCTIONS]
    try:
        from torch.distributed.tensor._dispatch import OpDispatcher
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
    except ImportError:           # no distributed support: no DTensor
        return out
    meta = "_propagate_tensor_meta_non_cached"
    if meta not in ShardingPropagator.__dict__:
        raise RuntimeError(f"torch {torch.__version__}: DTensor's "
                           f"ShardingPropagator has no {meta}; the analysis "
                           f"cannot tell its shape propagation from a "
                           f"rank's work")
    out.append((ShardingPropagator, meta, _flagged))
    out += [(owner, name, _outside_modes) for owner, name in (
        (OpDispatcher, "_propagate_op_sharding_dispatch_slow_path"),
        (ShardingPropagator, "propagate")) if name in owner.__dict__]
    return out


@contextlib.contextmanager
def _patched():
    """`_patches()` applied while active."""
    patches = _patches()
    saved = [(owner, name, owner.__dict__[name])
             for owner, name, _ in patches]
    for owner, name, wrap in patches:
        setattr(owner, name, wrap(owner.__dict__[name]))
    try:
        yield
    finally:
        for owner, name, orig in reversed(saved):
            setattr(owner, name, orig)


def _subclass(t) -> bool:
    """A tensor subclass with its own dispatch (DTensor, a functional
    collective's AsyncCollectiveTensor), not a plain or fake tensor."""
    return not (t is torch.Tensor or issubclass(t, FakeTensor)
                or t.__torch_dispatch__ is torch.Tensor.__torch_dispatch__)


def local_tensor(t):
    """The rank's own tensor of a DTensor (its local shard); `t` itself
    otherwise."""
    inner = getattr(t, "_local_tensor", None)
    return inner if isinstance(inner, torch.Tensor) else t


def _tensors(tree):
    return [local_tensor(t) for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _elems(t) -> int:
    """Distinct elements a tensor covers: a broadcast (stride-0) dim reads
    one element along it."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n


def tensor_bytes(t) -> int:
    return _elems(t) * t.element_size()


def shape_text(t) -> str:
    """An HLO-style shape: ``bf16[2,4096,4096]``."""
    dt = _DTYPE_NAMES.get(t.dtype, str(t.dtype).replace("torch.", ""))
    return f"{dt}[{','.join(str(int(d)) for d in t.shape)}]"


def _op_name(func) -> str:
    return str(func.overloadpacket)


def _call_site() -> str:
    """The port's innermost frame on the stack (file:function:line), and
    the autograd node when the op runs in a backward pass."""
    f = sys._getframe(3)
    site = ""
    while f is not None:
        name = f.f_code.co_filename
        if "repro_torch" in name and not name.endswith("op_analysis.py"):
            short = name[name.rindex("repro_torch"):]
            site = f"{short}:{f.f_code.co_name}:{f.f_lineno}"
            break
        f = f.f_back
    node = torch._C._current_autograd_node()
    if node is not None:
        site = f"{node.name()} < {site}" if site else node.name()
    return site


class OpAnalysis(TorchDispatchMode):
    """Counts the ops run inside ``with OpAnalysis() as a:`` (see the
    module docstring). ``a.start(args)`` before the call and
    ``a.finish(result)`` after it give the memory analysis its arguments
    and results; ``a.result()`` is the totals, ``a.top_ops()`` the per-op
    rows (with call sites when made with ``sites=True``)."""

    def __init__(self, *, sites: bool = False):
        super().__init__()
        self.sites = sites
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.collective_bytes = defaultdict(float)
        self.collective_counts = defaultdict(float)
        self.kernel_calls = defaultdict(int)
        self.rows = defaultdict(lambda: [0.0, 0.0, 0])
        self._lock = threading.RLock()
        self._live = {}              # id(storage) -> (weakref, nbytes, row)
        self._live_bytes = 0
        self._peak = 0
        self._held = defaultdict(lambda: [0, 0])   # row -> live bytes, count
        self._at_peak = {}           # self._held when live bytes peaked
        self._peak_unseen = False    # a new peak, not yet in self._at_peak
        self._args = {}              # id(storage) -> nbytes
        self._outputs = None
        self._mark = None

    # ---------------------------------------------------------------- mode
    def __enter__(self):
        self._mark = _patched()
        self._mark.__enter__()
        try:
            return super().__enter__()
        except BaseException:
            self._mark.__exit__(*sys.exc_info())
            raise

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._mark.__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(map(_subclass, types)):
            return NotImplemented       # DTensor & co. issue the local ops
        out = func(*args, **kwargs)
        if not _in_propagation():
            self._record(func, args, kwargs, out)
        return out

    # -------------------------------------------------------------- memory
    def start(self, args) -> None:
        """Record the call's tensor arguments (each storage once)."""
        for t in _tensors(args):
            st = t.untyped_storage()
            self._args.setdefault(id(st), st.nbytes())

    def finish(self, result) -> None:
        """Record the call's results."""
        seen = {}
        for t in _tensors(result):
            st = t.untyped_storage()
            seen.setdefault(id(st), st.nbytes())
        self._outputs = seen

    def _freed(self, key):
        with self._lock:
            entry = self._live.pop(key, None)
            if entry is not None:
                self._see_peak()
                self._live_bytes -= entry[1]
                if entry[2] is not None:
                    held = self._held[entry[2]]
                    held[0] -= entry[1]
                    held[1] -= 1

    def _see_peak(self):
        """Keep what is live at a new peak: called at the first free after
        it (only allocations came between) and when the rows are read."""
        if self._peak_unseen:
            self._at_peak = {k: tuple(v) for k, v in self._held.items()
                             if v[1]}
            self._peak_unseen = False

    def _track(self, t, row=None) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._args or key in self._live:
            return
        n = st.nbytes()
        with self._lock:
            ref = weakref.ref(st, lambda r, k=key: self._freed(k))
            self._live[key] = (ref, n, row)
            self._live_bytes += n
            if row is not None:
                held = self._held[row]
                held[0] += n
                held[1] += 1
            if self._live_bytes > self._peak:
                self._peak = self._live_bytes
                self._peak_unseen = row is not None

    # ---------------------------------------------------------------- cost
    def _record(self, func, args, kwargs, out) -> None:
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        name = _op_name(func)
        coll = _COLLECTIVES.get(name)
        if not outs and coll is None:
            return                      # metadata queries: no kernel
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        if func.namespace == "repro_torch":         # the port's kernels
            self.kernel_calls[func._opname] += 1
        nbytes = self._bytes(func, name, args, kwargs, ins, outs)
        flops = self._flops(func, args, kwargs, out)
        if coll is not None:
            sent = sum(tensor_bytes(t) for t in (outs or ins))
            self.collective_bytes[coll] += sent
            self.collective_counts[coll] += 1
        key = (name, shape_text(outs[0]) if outs else "",
               _call_site() if self.sites else "")
        for t in outs:
            self._track(t, key if self.sites else None)
        self.flops += flops
        self.hbm_bytes += nbytes
        if flops or nbytes:
            row = self.rows[key]
            row[0] += flops
            row[1] += nbytes
            row[2] += 1

    @staticmethod
    def _flops(func, args, kwargs, out) -> float:
        from torch.utils.flop_counter import flop_registry
        formula = flop_registry.get(func.overloadpacket)
        if formula is None:
            return 0.0
        return float(formula(*args, **kwargs, out_val=out))

    @staticmethod
    def _bytes(func, name, args, kwargs, ins, outs) -> float:
        schema = func._schema.arguments
        written = [i for i, a in enumerate(schema)
                   if a.alias_info is not None and a.alias_info.is_write]
        if not written:
            in_st = {id(t.untyped_storage()) for t in ins}
            if outs and all(id(t.untyped_storage()) in in_st for t in outs):
                return 0.0              # a view: no kernel
            return float(sum(map(tensor_bytes, ins))
                         + sum(map(tensor_bytes, outs)))
        bound = {a.name: (args[i] if i < len(args) else kwargs.get(a.name))
                 for i, a in enumerate(schema)}
        if name in _UPDATE_ARG:
            update = bound.get(_UPDATE_ARG[name])
            upd = tensor_bytes(update) if isinstance(update,
                                                     torch.Tensor) else 0
            index = [t for t in tree_leaves(bound.get("indices"))
                     + tree_leaves(bound.get("index"))
                     if isinstance(t, torch.Tensor)]
            return float(2 * upd + sum(map(tensor_bytes, index)))
        dst = [bound[schema[i].name] for i in written]
        dst = [t for t in tree_leaves(dst) if isinstance(t, torch.Tensor)]
        reads = ins
        if name == "aten.copy_" or any(schema[i].name == "out"
                                       for i in written):
            # a copy into a slice, or an out= result: written, not read
            reads = [t for t in ins if not any(t is d for d in dst)]
        return float(sum(map(tensor_bytes, reads))
                     + sum(map(tensor_bytes, dst)))

    # ------------------------------------------------------------- results
    def memory(self) -> dict:
        """The reference's ``memory_analysis_dict`` keys."""
        arg = sum(self._args.values())
        outs = self._outputs or {}
        out = sum(outs.values())
        alias = sum(n for k, n in outs.items() if k in self._args)
        temp = max(self._peak - (out - alias), 0)
        return {"argument_size_in_bytes": int(arg),
                "output_size_in_bytes": int(out),
                "alias_size_in_bytes": int(alias),
                "temp_size_in_bytes": int(temp)}

    def result(self) -> dict:
        """The dict of the reference's ``analyze_hlo_text``, plus
        ``memory`` and ``kernel_calls`` (the port's custom ops reached)."""
        res = {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
               "collective_bytes": dict(self.collective_bytes),
               "collective_counts": dict(self.collective_counts)}
        res["total_collective_bytes"] = sum(res["collective_bytes"].values())
        res["memory"] = self.memory()
        res["kernel_calls"] = dict(self.kernel_calls)
        return res

    def top_ops(self, n=15, metric="hbm_bytes") -> list:
        """Rows (cost, op, name, shape, hint), costliest first: each op,
        result shape and call site summed over its calls (the eager
        counterpart of the reference's trip-weighted instructions); name
        is the number of calls. ``metric="peak_bytes"`` (made with
        ``sites=True``): the bytes of each row's storages live at the
        memory peak (beyond the arguments), name their number. ``n=None``
        gives every row."""
        if metric == "peak_bytes":
            with self._lock:
                self._see_peak()
                rows = [(float(b), op, f"x{c}", shape, hint)
                        for (op, shape, hint), (b, c)
                        in self._at_peak.items()]
        else:
            col = {"flops": 0, "hbm_bytes": 1}[metric]
            rows = [(v[col], op, f"x{v[2]}", shape, hint)
                    for (op, shape, hint), v in self.rows.items() if v[col]]
        rows.sort(key=lambda r: -r[0])
        return rows if n is None else rows[:n]


def run(fn, *args, sites=False, **kwargs):
    """(result of fn(*args, **kwargs), its OpAnalysis)."""
    analysis = OpAnalysis(sites=sites)
    analysis.start((args, kwargs))
    with analysis:
        out = fn(*args, **kwargs)
    analysis.finish(out)
    return out, analysis


def analyze(fn, *args, **kwargs) -> dict:
    """Cost of one call of fn(*args, **kwargs): the dict of the reference's
    ``analyze_hlo_text`` (flops, hbm_bytes, collective_bytes,
    collective_counts, total_collective_bytes) plus ``memory`` and
    ``kernel_calls``."""
    return run(fn, *args, **kwargs)[1].result()


def top_ops(fn, *args, n=15, metric="hbm_bytes", **kwargs) -> list:
    """Per-op cost ranking of one call, with call sites: rows (cost, op,
    name, shape, hint) as the reference's ``top_ops``."""
    return run(fn, *args, sites=True, **kwargs)[1].top_ops(n, metric)


def collective_bytes(fn, *args, per_op: bool = False, **kwargs):
    """Collective bytes of one call: the total, or with `per_op` the
    reference's {"total", "by_op", "counts"}."""
    res = analyze(fn, *args, **kwargs)
    out = {"total": res["total_collective_bytes"],
           "by_op": res["collective_bytes"],
           "counts": res["collective_counts"]}
    return out if per_op else out["total"]
