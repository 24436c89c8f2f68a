"""Training launcher — the end-to-end driver (counterpart of
``repro.launch.train``):

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b \\
      --preset reduced --steps 50 --batch 8 --seq 128 --optimizer adam \\
      --lr 3e-4 --device cpu

Trains on the card by default (``--device cuda``), on the CPU when asked.
Supports checkpoint save (``--checkpoint``) and restore (``--resume``) in
the reference's format. ``--paper-mode`` trains with explicit data
parallelism over a ``torch.distributed`` group — the ``--algorithm``
allreduce schedule, with ``--compress`` gradient compression and error
feedback — on one rank, or on N under torchrun:

  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch yi-9b --preset reduced --paper-mode --algorithm ring \
      --compress int8 --device cpu

The reference's sharding plans other than ``dp`` come with
``core/parallelism.py`` (ROADMAP A15) and raise here.
"""
from __future__ import annotations

import argparse
import time

import torch.distributed as dist


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--preset", default="full", choices=("full", "reduced"))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--plan", default="dp")
    ap.add_argument("--optimizer", default="adam")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-clip", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--paper-mode", action="store_true",
                    help="explicit data parallelism with a chosen collective")
    ap.add_argument("--algorithm", default="ring")
    ap.add_argument("--compress", default="none")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.plan != "dp":
        raise NotImplementedError(
            f"--plan {args.plan}: the port trains on one device, plan 'dp'")

    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.mesh import make_dp_group
    from repro_torch.optim import make_optimizer

    cfg = get_config(args.arch)
    if args.preset == "reduced":
        cfg = reduced(cfg)
    optimizer = make_optimizer(args.optimizer, lr=args.lr,
                               grad_clip=args.grad_clip)
    owns_group = args.paper_mode and not dist.is_initialized()
    # the group first: under torchrun it picks this rank's card
    group = make_dp_group(args.device) if args.paper_mode else None
    try:
        return _train(args, cfg, optimizer, group)
    finally:
        if owns_group:
            dist.destroy_process_group()


def _train(args, cfg, optimizer, group):
    from repro_torch.core.compression import make_compressor
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import trainer

    state = trainer.init_state(cfg, optimizer, seed=args.seed,
                               device=args.device)
    start_step = 0
    if args.resume:
        state, start_step = ckpt.restore(args.resume, state)
        print(f"resumed from {args.resume} at step {start_step}")

    data = SyntheticLM(cfg.vocab_size, args.seq, seed=args.seed)
    if args.paper_mode:
        compressor = (None if args.compress == "none"
                      else make_compressor(args.compress))
        paper_step = trainer.make_paper_train_step(
            cfg, optimizer, group, algorithm=args.algorithm,
            compression=compressor)
        residual = (trainer.zero_residual(state["params"]) if compressor
                    else None)

        def step_fn(state, batch):
            nonlocal residual
            state, metrics, residual = paper_step(state, batch, residual)
            return state, metrics
    else:
        step_fn = trainer.make_train_step(cfg, optimizer)
    t0 = time.time()
    for i, batch in enumerate(data.batches(args.batch, args.steps)):
        state, metrics = step_fn(state, batch)
        if (i + 1) % args.log_every == 0 or i == 0:
            print(f"step {start_step+i+1}: loss={float(metrics['loss']):.4f} "
                  f"({(time.time()-t0)/(i+1):.2f}s/step)", flush=True)

    # the ranks hold equal params: rank 0 writes the checkpoint
    if args.checkpoint and (group is None or dist.get_rank(group) == 0):
        ckpt.save(args.checkpoint, state, start_step + args.steps)
        print(f"saved {args.checkpoint}")
    return state


if __name__ == "__main__":
    main()
