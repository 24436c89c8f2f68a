"""Drive the dry-run matrix on the port: every (arch × shape × mesh ×
plan), one process per combination (the fake process group is
process-wide). Results land in
results/dryrun_torch/<arch>__<shape>__<mesh>__<plan>.json; existing files
are skipped, so the sweep is resumable (the port's counterpart of
``repro.launch.sweep``). ``python results/make_tables.py
results/dryrun_torch`` renders them.

  PYTHONPATH=src python -m repro_torch.launch.sweep --mesh single multi \\
      --plan dp_tp [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

from repro_torch.configs.base import SHAPES

ARCHS = [
    "gemma3-12b", "phi4-mini-3.8b", "qwen2-vl-2b", "mixtral-8x7b",
    "stablelm-3b", "rwkv6-7b", "yi-9b", "qwen3-moe-30b-a3b",
    "zamba2-2.7b", "musicgen-medium",
]

SRC = Path(__file__).resolve().parents[2]


def _status(path):
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f).get("status")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", nargs="+", default=["single", "multi"])
    ap.add_argument("--plan", nargs="+", default=["dp_tp"])
    ap.add_argument("--arch", nargs="+", default=ARCHS)
    ap.add_argument("--shape", nargs="+", default=list(SHAPES))
    ap.add_argument("--outdir", default="results/dryrun_torch")
    ap.add_argument("--timeout", type=int, default=1800)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    os.makedirs(args.outdir, exist_ok=True)

    combos = [(a, s, m, p) for a in args.arch for s in args.shape
              for m in args.mesh for p in args.plan]
    t_start = time.time()
    n_ok = n_skip = n_err = 0
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    for i, (arch, shape, mesh, plan) in enumerate(combos):
        out = os.path.join(args.outdir,
                           f"{arch}__{shape}__{mesh}__{plan}.json")
        if _status(out) in ("ok", "skipped"):
            continue
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--mesh", mesh,
               "--plan", plan, "--out", out, "--device", args.device]
        t0 = time.time()
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=args.timeout, env=env)
        except subprocess.TimeoutExpired:
            n_err += 1
            with open(out, "w") as f:
                json.dump({"arch": arch, "shape": shape, "mesh": mesh,
                           "plan": plan, "status": "error",
                           "error": "timeout"}, f)
            print(f"[{i+1}/{len(combos)}] {arch} {shape} {mesh}: TIMEOUT",
                  flush=True)
            continue
        status = _status(out) or "?"
        if status == "ok":
            n_ok += 1
        elif status == "skipped":
            n_skip += 1
        else:
            n_err += 1
            tail = (r.stderr or r.stdout or "")[-800:]
            print(f"[{i+1}/{len(combos)}] {arch} {shape} {mesh} ERROR\n{tail}",
                  flush=True)
            continue
        print(f"[{i+1}/{len(combos)}] {arch} {shape} {mesh} {plan}: "
              f"{status} ({time.time()-t0:.0f}s)", flush=True)
    print(f"done in {time.time()-t_start:.0f}s: ok={n_ok} skip={n_skip} "
          f"err={n_err}")
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
