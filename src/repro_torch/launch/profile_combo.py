"""§Perf profiler: trace one combo on the fake production mesh and print
the per-op top rows by HBM traffic or FLOPs (summed over each op's calls,
per device), or by the bytes each holds at the memory peak, and the
collectives — the evidence for each hypothesis (the
port's counterpart of ``repro.launch.profile_combo``).

  PYTHONPATH=src python -m repro_torch.launch.profile_combo --arch rwkv6-7b \\
      --shape train_4k --plan dp_tp --metric peak_bytes [--device cpu]
"""
import argparse

from repro_torch.configs.base import SHAPES, get_config
from repro_torch.core import parallelism as par
from repro_torch.launch.dryrun import lower_combo
from repro_torch.launch.mesh import make_dryrun_mesh


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--plan", default="dp_tp", choices=par.PLANS)
    ap.add_argument("--metric", default="hbm_bytes",
                    choices=("hbm_bytes", "flops", "peak_bytes"))
    ap.add_argument("--n", type=int, default=20)
    ap.add_argument("--collectives", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    mesh = make_dryrun_mesh(device=args.device)
    analysis, _, _ = lower_combo(cfg, SHAPES[args.shape], mesh, args.plan,
                                 device=args.device, sites=True)
    total = analysis.result()
    print(f"total flops={total['flops']:.3e} hbm={total['hbm_bytes']:.3e} "
          f"coll={total['total_collective_bytes']:.3e} "
          f"temp={total['memory']['temp_size_in_bytes']:.4e}")
    how = ("live at the memory peak" if args.metric == "peak_bytes"
           else "summed over calls")
    print(f"--- top {args.n} by {args.metric} ({how}, per device) ---")
    for cost, op, name, shape, hint in analysis.top_ops(args.n, args.metric):
        print(f"{cost:12.4e}  {op:18s} {name:>6s} {shape:28s} {hint}")
    if args.collectives:
        print("--- collectives ---")
        for k, v in total["collective_bytes"].items():
            n = total["collective_counts"][k]
            print(f"{k:20s} {v:12.4e} bytes  x{n:.0f}")


if __name__ == "__main__":
    main()
