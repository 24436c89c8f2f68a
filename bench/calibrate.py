"""Readings that set the limits of ``bench/limits/<workload>.json``: the
sound program's on many seeds, and the precision control's and the
planted faults' on a few, all at the cell's own size in one process.

    python3 bench/calibrate.py --workload <name> --seeds 11,12,... \
        --control-seeds 3 --seconds <run_seconds> [--out FILE]

Each seed prints one JSON line: the run's end-to-end numbers, its readings
of the numbers compared, and on the first `--control-seeds` seeds the
driver's ``controls`` readings, each judged against the cell's limits by
the runs' own comparison (``compare.judge``): a control has to come out
not correct. Needs the card the cell asks for.
"""
import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    from bench import compare, harness
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    harness.prebuild()
    c = harness.cell(args.workload)
    drv = harness.driver(c["traffic"]["driver"])
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        res = drv.run(c, seed=seed, seconds=args.seconds, trace=False,
                      device="cuda")
        line = {"workload": args.workload, "seed": seed,
                "e2e": res["e2e"], "correct": res["correct"],
                "readings": {k: v for k, (v, _) in res["checks"].items()},
                "peak_gib": res["memory_peak_bytes"] / 2**30,
                "notes": res["notes"]}
        if i < args.control_seeds:
            line["controls"] = {}
            for name, got in drv.controls(res, c, seed).items():
                checks, ok = compare.judge(got, c["limits"])
                line["controls"][name] = {"readings": got, "correct": ok,
                                          "checks": checks}
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as out:
                out.write(text + "\n")
        del res
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
