"""train_steps: the port's training step (``make_train_step`` with its
Adam) on batches of the synthetic token stream, every row its own
document.

Set-up builds the one training state from the seed (weights made on the
device by ``bench.weights``, the optimizer's state) and drives it through
its first three steps with the window's own call and feed; they warm every
shape, and the readings of them are kept: each step's loss, each leaf's
norm of the first gradient as the optimizer got it (its first moment after
one step over 1 - beta1), and each leaf's norm of the weights' change after
the third step. The window then runs steps on the same state until the
given seconds have passed, and ends in a synchronize; every step leaves a
raw record for the per-layer readers (``Capture.record``). Afterwards the
state is freed and the configuration's float32 reference
(``bench/reference/<reference>.py``) runs the same three steps from the
same weights; the worst gaps decide ``correct``.
"""
from __future__ import annotations

import gc
import time

import torch

from bench import compare, harness, profiling, traffic, weights

SPANS = ("bench/optimizer",)
READ_STEPS = 3
clock = time.perf_counter


def walk(tree, path=()):
    """(path, leaf) of a nested dict of tensors."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from walk(v, path + (k,))
    else:
        yield path, tree


def ranged(name, fn):
    def run(*a, **k):
        with torch.profiler.record_function(name):
            return fn(*a, **k)
    return run


def run(c, *, seed, seconds, trace, device, steps=None):
    """One run of the cell `c`. `steps`, for tests, replaces the window's
    seconds by a count of steps."""
    from repro_torch.optim.optimizers import Optimizer, make_optimizer
    from repro_torch.train.trainer import make_train_step
    conf, mix, lim = c["config"], c["traffic"], c["limits"]
    m, hp = conf["model"], conf["trainer"]
    ref = harness.reference(conf["reference"])
    specs = ref.leaf_specs(m)
    cfg = harness.model_config(conf)
    cuda = torch.device(device).type == "cuda"
    B, S, V = mix["batch"], mix["seq"], m["vocab_size"]
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    def batch(i):
        b = traffic.lm_batch(seed, i, B, S, V)
        return {k: torch.from_numpy(v).pin_memory().to(device,
                                                       non_blocking=True)
                if cuda else torch.from_numpy(v) for k, v in b.items()}

    opt = make_optimizer("adam", lr=hp["lr"], beta1=hp["beta1"],
                         beta2=hp["beta2"], eps=hp["eps"],
                         grad_clip=hp["grad_clip"])
    opt = Optimizer(opt.name, opt.init, ranged("bench/optimizer",
                                               opt.update))
    state = {"params": weights.make(specs, seed, device)}
    state["opt"] = opt.init(state["params"])
    step = make_train_step(cfg, opt)

    losses, first = [], None
    for i in range(READ_STEPS):
        state, out = step(state, batch(i))
        losses.append(float(out["loss"]))
        if i == 0:
            first = {p: float(torch.linalg.vector_norm(t.double()))
                     / (1 - hp["beta1"]) for p, t in walk(state["opt"]["m"])}
    change = {}
    for path, p0 in weights.leaves(specs, seed, device):
        p = weights.get(state["params"], path)
        change[path] = float(torch.linalg.vector_norm(
            p.double() - p0.double()))
        del p0

    window_start = clock()
    n, prof, traced_s, record = 0, None, 0.0, []
    trace_at = window_start + mix["trace_after"] * seconds
    while (n < steps) if steps is not None else (
            clock() - window_start < seconds):
        if trace and prof is None and (
                clock() >= trace_at if steps is None else n == steps // 2):
            def some():
                nonlocal state
                for j in range(mix["trace_steps"]):
                    state, _ = step(state, batch(READ_STEPS + n + j))
            if cuda:                # the queued steps' time stays untraced
                torch.cuda.synchronize()
            t = clock()
            prof, win, _ = profiling.traced(some)
            traced_s += clock() - t
            n += mix["trace_steps"]
            record += [{"traced": True, "rows": B, "seq": S}] * \
                mix["trace_steps"]
            continue
        state, _ = step(state, batch(READ_STEPS + n))
        record.append({"traced": False, "rows": B, "seq": S})
        n += 1
    if cuda:
        torch.cuda.synchronize()
    end = clock()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    capture = None
    if prof is not None:            # reduced once the window has closed
        capture = profiling.summarize(prof, win, SPANS)
        del prof
        capture.record = {"model": m, "mix": mix, "steps": record,
                          "untraced_s": end - window_start - traced_s,
                          "peak_bytes": int(peak)}
    del state, step, opt
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    ref.highest_precision()
    ref_losses, ref_first, ref_change = ref.run_steps(
        m, lambda: weights.make(specs, seed, device),
        [batch(i) for i in range(READ_STEPS)], hp)
    readings = judge(losses, first, change, ref_losses, ref_first,
                     ref_change)
    checks, correct = compare.judge(
        {k: v for k, (v, _) in readings.items()}, lim)
    notes = [f"steps in window {n}, tokens {n * B * S}; losses "
             f"{losses} vs reference {ref_losses}"] + [
        f"{k} {v!r} at {where}" for k, (v, where) in readings.items()]
    tokens = n * B * S
    return {"window_start": window_start,
            "e2e": {"train_tokens_per_s": tokens / (end - window_start)},
            "checks": checks, "correct": bool(correct), "attempted": n,
            "failed": 0, "memory_peak_bytes": int(peak),
            "capture": capture, "notes": notes, "readings": readings,
            "reference": (ref_losses, ref_first, ref_change)}


def judge(losses, first, change, ref_losses, ref_first, ref_change):
    """{name: (reading, where)} of the three numbers compared."""
    g, g_at = compare.leaf_gap(first, ref_first)
    ch, ch_at = compare.leaf_gap(change, ref_change,
                                 compare.moved_leaves(ref_first))
    return {"loss_gap": (compare.loss_gap(losses, ref_losses), "steps 1-3"),
            "first_grad_gap": (g, ".".join(g_at)),
            "change_gap": (ch, ".".join(ch_at))}


def controls(res, c, seed) -> dict:
    """{control: its readings}: the precision control's (the reference
    with float8 products in the program's place) and the fault "half of
    the batch left out, the mean taken over the rest" (the reference on
    the first half of each batch's rows in the program's place), each
    against this run's float32 reference."""
    from bench.reference.control import fp8_linear
    m, mix, hp = c["config"]["model"], c["traffic"], c["config"]["trainer"]
    ref = harness.reference(c["config"]["reference"])
    specs = ref.leaf_specs(m)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    B, S, V = mix["batch"], mix["seq"], m["vocab_size"]

    def batches():
        return [{k: torch.from_numpy(v).to(device) for k, v in
                 traffic.lm_batch(seed, i, B, S, V).items()}
                for i in range(READ_STEPS)]
    out = {}
    for name, kw in (("control_fp8", {"lin": fp8_linear}),
                     ("half_batch", {"rows": (0, B // 2)})):
        got = ref.run_steps(m, lambda: weights.make(specs, seed, device),
                            batches(), hp, **kw)
        out[name] = {k: v for k, (v, _) in
                     judge(*got, *res["reference"]).items()}
    return out
