"""Run one cell of the benchmark and print its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for. Set-up (imports, kernel builds, weights, the program's state,
warm-up) runs first; then the window of `--seconds`, the check of its
outputs against the plain reference, and one JSON line on standard output.
`--trace 0` reports the cell's end-to-end metrics, `--trace 1` its
per-layer metrics, read from a profiler trace of a few of the window's
steps. Exits non-zero, printing no result, where there is no such card,
where the program is missing, or where the process ends up holding JAX or
the JAX package.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
os.environ.setdefault("USE_FLAX", "0")


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from bench import harness
    c = harness.cell(args.workload)
    import torch
    chips = c["workload"]["chips"]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"bench: workload {args.workload} needs {chips} CUDA "
              f"device(s); this machine has {have}. Nothing was measured.",
              file=sys.stderr)
        return 3
    torch.cuda.set_device(0)
    harness.prebuild()
    drv = harness.driver(c["traffic"]["driver"])
    res = drv.run(c, seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace), device="cuda")
    setup_s = res["window_start"] - T0

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": res["memory_peak_bytes"]}
    out = {"correct": res["correct"], "attempted": res["attempted"],
           "failed": res["failed"]}
    if args.trace:
        cap = res["capture"]
        metrics = {}
        for m in c["per_layer"]:
            v = harness.metric_reader(m["name"])(cap)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device.update(busy_s=cap.busy_s, window_s=cap.window_s)
        out.update(metrics=metrics, device=device, breakdown=cap.breakdown)
    else:
        values = dict(res["e2e"], setup_s=setup_s)
        out.update(metrics={m["name"]: {"value": values[m["name"]],
                                        "unit": m["unit"]}
                            for m in c["end_to_end"]}, device=device)
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in res["checks"].items()}

    held = harness.forbidden_modules()
    if held:
        print(f"bench: the measured process holds {held}; the benchmark "
              f"measures the port alone. No result.", file=sys.stderr)
        return 4
    print(f"setup_s {setup_s:.3f}; " + "; ".join(res.get("notes", [])))
    for k, (v, lim) in res["checks"].items():
        print(f"check {k}: {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
