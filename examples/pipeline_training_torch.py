"""Survey §5.3 on the PyTorch port: a layer pipeline (GPipe) over 4 stages.

    PYTHONPATH=src python examples/pipeline_training_torch.py  # 4 cards
    PYTHONPATH=src python examples/pipeline_training_torch.py --device cpu

The counterpart of ``examples/pipeline_training.py``. Runs an MLP forward
through ``core.pipeline.pipeline_forward`` on a ("stage",) mesh of S ranks,
one process each (``torch.multiprocessing``), checks it against the
sequential computation, and prints the schedule's rounds and idle share
beside the bubble fraction of the paper's latency model. NCCL refuses two
ranks of one group on one card, so on the card rank r takes ``cuda:r`` and
S cards are needed; ``--device cpu`` runs S gloo ranks on the host. No
kernel is on this path; the last line gives the launch counts all the same.
"""
import argparse
import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import kernels
from repro_torch.core import pipeline as PL
from repro_torch.core.costmodel import pipeline_bubble_fraction
from repro_torch.launch.mesh import make_host_mesh

S, M, MB, DIM = 4, 8, 16, 32     # stages, microbatches, microbatch rows, width


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: S cards, rank r on cuda:r) or cpu")
    return ap.parse_args(argv)


def make_inputs():
    """Stage weights W (S, DIM, DIM), biases b (S, DIM) and the
    microbatches x (M, MB, DIM), from one seeded CPU generator (equal on
    every rank)."""
    gen = torch.Generator().manual_seed(0)
    W = torch.randn(S, DIM, DIM, generator=gen) * 0.3
    b = torch.randn(S, DIM, generator=gen) * 0.1
    x = torch.randn(M, MB, DIM, generator=gen)
    return W, b, x


def stage_fn(p, x):
    # p arrives sliced to this stage: w (dim, dim), b (dim,)
    return torch.tanh(x @ p["w"] + p["b"])


def _rank(rank, device, store, out_path):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(S),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    mesh = make_host_mesh((S,), ("stage",), device=device,
                          init_method=f"file://{store}")
    try:
        on = torch.device("cuda", rank) if device == "cuda" else "cpu"
        W, b, x = (t.to(on) for t in make_inputs())
        out = PL.pipeline_forward(stage_fn, {"w": W, "b": b}, x, mesh)
        ref = x
        for s in range(S):
            ref = stage_fn({"w": W[s], "b": b[s]}, ref)
        if rank == 0:
            torch.save({"err": float(torch.max(torch.abs(out - ref))),
                        "rounds": PL.counts["rounds"],
                        "hops": PL.counts["hops"]}, out_path)
    finally:
        dist.destroy_process_group()


def main(argv=None):
    args = parse(argv)
    if args.device == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < S:
            raise RuntimeError(
                f"the pipeline puts each of its {S} stages on a card of its "
                f"own (NCCL refuses two ranks of one group on one card) and "
                f"this machine has {n}; pass --device cpu for {S} gloo "
                f"ranks on the host")
    kernels.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "rank0.pt")
        mp.spawn(_rank, args=(args.device, os.path.join(tmp, "store"),
                              out_path), nprocs=S, join=True)
        res = torch.load(out_path)
    where = ("gloo ranks on the host" if args.device == "cpu"
             else "cards, one rank each")
    print(f"ran {S} stages on {S} {where}")
    print(f"pipeline output matches sequential: maxerr={res['err']:.2e}")
    rounds = res["rounds"]
    assert rounds == PL.num_pipeline_rounds(S, M)
    bubble = pipeline_bubble_fraction(S, M)
    print(f"stages={S} microbatches={M}: {rounds} rounds, "
          f"bubble={(rounds - M) / rounds:.3f} (paper model: {bubble:.3f})")
    assert res["err"] < 1e-5, f"pipeline output off by {res['err']}"
    print(kernels.launch_line())
    return res


if __name__ == "__main__":
    main()
