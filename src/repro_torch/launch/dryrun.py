"""Multi-pod dry run (deliverable (e)) + roofline extraction (deliverable
(g)) — the port's counterpart of ``repro.launch.dryrun``.

For a given (architecture × input shape × mesh × plan):
  1. build the production mesh (16×16 single-pod / 2×16×16 multi-pod) as
     rank 0 of a "fake" process group (``launch/mesh.py``): collectives
     move nothing,
  2. trace one train step (train shapes), forward + last-position logits
     (prefill) or one dense-cache serve step (decode) on fake tensors
     (``FakeTensorMode``: nothing allocated), placed by the plan as
     DTensors, under ``core.op_analysis`` — rank 0's own ops, kernels and
     collectives,
  3. print the memory it needs (fits?) and its FLOPs and HBM bytes,
  4. and its collective bytes,
  5. emit the roofline terms (``costmodel.H100``) + the MODEL_FLOPS ratio
     as JSON.

The default device is the card: the trace then takes the card's path (B6
through its custom op's fake implementation, which launches nothing) and
raises on a machine without one unless ``--device cpu`` (the CPU path: the
reference's chunked attention, the plain versions). Run one combination per
process (the fake group is process-wide):

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b \\
        --shape train_4k --mesh single --plan dp_tp [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

import torch

from repro_torch import kernels
from repro_torch.configs.base import SHAPES, get_config
from repro_torch.core import costmodel as cm
from repro_torch.core import op_analysis as oa
from repro_torch.core import parallelism as par
from repro_torch.data.pipeline import shard_batch
from repro_torch.launch.mesh import make_dryrun_mesh
from repro_torch.launch.specs import fake_mode, input_specs, shape_applicable
from repro_torch.models import transformer as T
from repro_torch.optim import make_optimizer
from repro_torch.serving import serve
from repro_torch.train import trainer


def lower_combo(cfg, shape, mesh, plan_name, accum_steps=1, device="cuda",
                sites=False):
    """Trace one step of (cfg, shape) under `plan_name` on `mesh` (a
    ``DeviceMesh``, a fake group's) on fake tensors of `device`, as rank 0
    runs it. Returns (the ``OpAnalysis`` of the step, tokens it processes,
    trace seconds); `sites` records each op's call site for ``top_ops``.
    The state, params, cache and batch are placed by the plan before the
    step, outside the analysis, as the reference's jit in_shardings place
    them."""
    plan = par.make_plan(plan_name, mesh)
    mode = fake_mode()
    specs = input_specs(cfg, shape, device=device, mode=mode)
    optimizer = make_optimizer("adam", lr=1e-4)
    with mode:
        if shape.kind == "train":
            state = trainer.init_state(cfg, optimizer, device=device)
            fn, state, batch = trainer.jit_train_step(
                cfg, optimizer, plan, state, specs["batch"],
                accum_steps=accum_steps)
            args = (state, batch)
            tokens = shape.global_batch * shape.seq_len
        elif shape.kind == "prefill":
            params = T.init_params(cfg, device=device)
            params = par.shard_tree(params, plan.param_specs(params), mesh)
            batch = shard_batch(specs["batch"], plan)

            @torch.no_grad()
            def fn(params, batch):
                with par.plan_context(plan):
                    hidden, _ = T.forward(cfg, params, batch)
                    return T.logits(cfg, params, hidden[:, -1:, :])
            args = (params, batch)
            tokens = shape.global_batch * shape.seq_len
        else:
            params = T.init_params(cfg, device=device)
            step, params, cache, inputs = serve.jit_serve_step(
                cfg, plan, params, specs["cache"], specs["inputs"])
            index = shape.seq_len - 1       # the cache's last slot

            @torch.no_grad()
            def fn(params, cache, inputs):
                return step(params, cache, inputs, index)
            args = (params, cache, inputs)
            tokens = shape.global_batch     # ONE new token per sequence
        t0 = time.perf_counter()
        _, analysis = oa.run(fn, *args, sites=sites)
        trace_s = time.perf_counter() - t0
    return analysis, tokens, trace_s


def run(arch, shape_name, mesh_kind, plan_name, out_path=None, quiet=False,
        accum_steps=1, device="cuda"):
    """One dry-run record (the reference's keys; ``trace_s`` in place of
    ``lower_s``, ``compile_s`` 0, plus ``device``, ``kernel_calls`` and
    ``launches``: the custom ops the trace reached and the kernels it
    launched, none), written to `out_path` if given. Builds the fake mesh:
    one call per process."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the dry run traces the card's path by default "
                           "and this machine has no card; pass "
                           "device='cpu' (--device cpu) to trace the CPU "
                           "path")
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "plan": plan_name, "accum_steps": accum_steps, "device": device,
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
    }
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = why
        _emit(rec, out_path, quiet)
        return rec

    mesh = make_dryrun_mesh(multi_pod=(mesh_kind == "multi"), device=device)
    chips = mesh.size()
    before = dict(kernels.launch_counts)
    analysis, tokens, trace_s = lower_combo(cfg, shape, mesh, plan_name,
                                            accum_steps=accum_steps,
                                            device=device)
    res = analysis.result()
    launches = {k: n - before[k] for k, n in kernels.launch_counts.items()}
    mem = res["memory"]
    collectives = {"total": res["total_collective_bytes"],
                   "by_op": res["collective_bytes"],
                   "counts": res["collective_counts"]}
    if not quiet:
        print("memory_analysis:", json.dumps(mem, indent=1))
        print("per rank: flops=%.3e hbm=%.3e coll=%.3e (trace %.1f s)"
              % (res["flops"], res["hbm_bytes"], collectives["total"],
                 trace_s))

    # the counts are rank 0's (one rank's program); normalize to global
    flops_dev = res["flops"]
    bytes_dev = res["hbm_bytes"]
    coll_dev = collectives["total"]
    mf = cm.model_flops(cfg.active_param_count(), tokens)
    if shape.kind != "train":
        mf /= 3.0  # forward only: 2ND
    global_flops = flops_dev * chips
    terms = cm.roofline_terms(global_flops, bytes_dev * chips,
                              coll_dev * chips, chips, hw=cm.H100)
    hbm_need = (mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
                + mem["output_size_in_bytes"] - mem["alias_size_in_bytes"])
    rec.update({
        "status": "ok",
        "chips": chips,
        "tokens": tokens,
        "trace_s": round(trace_s, 1),
        # nothing is compiled (eager ops); results/make_tables.py's summary
        # line reads the reference's compile time
        "compile_s": 0.0,
        "flops_per_device": flops_dev,
        "bytes_per_device": bytes_dev,
        "collective_bytes_per_device": coll_dev,
        "collectives": collectives,
        "memory": mem,
        "hbm_needed_per_device": hbm_need,
        "fits_hbm": bool(hbm_need < cm.H100.hbm_bytes),
        "model_flops": mf,
        "useful_flops_ratio": (mf / global_flops) if global_flops else None,
        "roofline": terms,
        "dominant": cm.dominant_term(terms),
        "kernel_calls": res["kernel_calls"],
        # the kernels the trace launched: none (fake tensors)
        "launches": launches,
    })
    _emit(rec, out_path, quiet)
    return rec


def _emit(rec, out_path, quiet):
    if out_path:
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=1)
    if not quiet:
        slim = {k: v for k, v in rec.items()
                if k not in ("collectives", "memory")}
        print(json.dumps(slim, indent=1, default=str))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=("single", "multi"))
    ap.add_argument("--plan", default="dp_tp", choices=par.PLANS)
    ap.add_argument("--out", default=None)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    try:
        rec = run(args.arch, args.shape, args.mesh, args.plan, args.out,
                  accum_steps=args.accum, device=args.device)
        return 0 if rec.get("status") in ("ok", "skipped") else 1
    except Exception:  # noqa: BLE001 — the record says what failed
        traceback.print_exc()
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"arch": args.arch, "shape": args.shape,
                           "mesh": args.mesh, "plan": args.plan,
                           "status": "error",
                           "error": traceback.format_exc()[-2000:]}, f,
                          indent=1)
        return 1


if __name__ == "__main__":
    sys.exit(main())
