"""Survey §6.3 end to end on the PyTorch port: train one model under
different gradient compressors (with error feedback) in the explicit-
collective "paper mode" and compare loss curves and wire bytes.

    PYTHONPATH=src python examples/compression_comparison_torch.py  # 4 cards
    PYTHONPATH=src python examples/compression_comparison_torch.py --ranks 1
    PYTHONPATH=src python examples/compression_comparison_torch.py \
        --device cpu --ranks 2

The counterpart of ``examples/compression_comparison.py``, which spawns 4
devices: ``--ranks`` data-parallel ranks (default 4), one process each
(``torch.multiprocessing``; one rank runs in this process), rank r on
``cuda:r`` (NCCL) or on the host (``--device cpu``, gloo). Each compressor
(none, int8, onebit, topk at 1%) trains the same 2-layer model on the same
batches through ``make_paper_train_step(algorithm="ring")``. It reproduces
the survey's central compression claim: with local gradient accumulation
(error feedback), even 1-bit / top-1% gradients track the uncompressed loss
curve while moving 30–2000x fewer bytes. On the card the int8 compressor
runs kernel B9; the last line gives rank 0's launch counts.
"""
import argparse
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import kernels
from repro_torch.configs import ModelConfig
from repro_torch.core.compression import make_compressor
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.mesh import make_dp_group
from repro_torch.optim import make_optimizer
from repro_torch.train import trainer

CFG = ModelConfig(name="c", family="dense", num_layers=2, d_model=64,
                  num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128,
                  vocab_size=64, loss_chunk=32, attn_chunk=32, remat=False)
COMPRESSORS = ("none", "int8", "onebit", "topk")


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: rank r on cuda:r) or cpu (gloo)")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--batches", type=int, default=60)
    ap.add_argument("--batch", type=int, default=16)
    return ap.parse_args(argv)


def compressor(name):
    return None if name == "none" else make_compressor(name, frac=0.01)


def wire(name):
    """(compression ratio, MB a rank sends a step)."""
    comp = compressor(name)
    ratio = 1.0 if comp is None else comp.ratio()
    return ratio, CFG.param_count() * 4 / ratio / 1e6


def train(name, batches, device):
    """Loss per step of one compressor's run on the default group."""
    comp = compressor(name)
    opt = make_optimizer("adam", lr=3e-3)
    state = trainer.init_state(CFG, opt, seed=0, device=device)
    step = trainer.make_paper_train_step(CFG, opt, algorithm="ring",
                                         compression=comp)
    residual = trainer.zero_residual(state["params"]) if comp else None
    losses = []
    for b in batches:
        state, m, residual = step(state, b, residual)
        losses.append(float(m["loss"]))
    return losses


def _rank(rank, args, batches, store, out_path):
    spawned = args.ranks > 1
    if spawned:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(args.ranks),
                          LOCAL_RANK=str(rank))
        torch.set_num_threads(1)
    device = (torch.device("cuda", rank) if args.device == "cuda"
              else torch.device("cpu"))
    make_dp_group(args.device, init_method=f"file://{store}")
    try:
        kernels.reset_launch_counts()
        losses = {name: train(name, batches, device)
                  for name in COMPRESSORS}
        if rank == 0:
            torch.save({"losses": losses,
                        "launches": dict(kernels.launch_counts)}, out_path)
    finally:
        dist.destroy_process_group()


def main(argv=None):
    """The batches are drawn here once and handed to every rank (the
    generator's per-batch seed is a per-process ``hash``)."""
    args = parse(argv)
    if args.device == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < args.ranks:
            raise RuntimeError(
                f"{args.ranks} ranks take a card each (NCCL refuses two "
                f"ranks of one group on one card) and this machine has "
                f"{n}; pass --ranks {max(n, 1)} or --device cpu")
    if dist.is_initialized():
        raise RuntimeError("the example makes its own process group; this "
                           "process holds one already")
    data = SyntheticLM(CFG.vocab_size, 64, noise=0.05)
    batches = list(data.batches(args.batch, args.batches))
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "rank0.pt")
        rank_args = (args, batches, os.path.join(tmp, "store"), out_path)
        if args.ranks == 1:
            _rank(0, *rank_args)
        else:
            mp.spawn(_rank, args=rank_args, nprocs=args.ranks, join=True)
        res = torch.load(out_path)
    where = "gloo on the host" if args.device == "cpu" else "nccl"
    print(f"{args.ranks} data-parallel rank(s), {where}, "
          f"{len(batches)} batches")
    out = {}
    for name in COMPRESSORS:
        losses = res["losses"][name]
        ratio, wire_mb = wire(name)
        out[name] = {"losses": losses, "ratio": ratio, "wire_mb": wire_mb}
        print(f"{name:8s} first5={sum(losses[:5]) / 5:.3f} "
              f"last5={sum(losses[-5:]) / 5:.3f} wire={wire_mb:.2f}MB/step "
              f"({ratio:.0f}x compression)")
        assert np.all(np.isfinite(losses)), f"{name}: non-finite loss"
    print(kernels.launch_line(res["launches"]))
    return out


if __name__ == "__main__":
    main()
