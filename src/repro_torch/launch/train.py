"""Training launcher — the end-to-end driver (counterpart of
``repro.launch.train``):

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b \\
      --preset reduced --steps 50 --batch 8 --seq 128 --optimizer adam \\
      --lr 3e-4 --device cpu

Trains on one device: the card by default (``--device cuda``), the CPU when
asked. Supports checkpoint save (``--checkpoint``) and restore
(``--resume``) in the reference's format. The reference's sharding plans
other than ``dp`` and its paper-mode runtime with explicit collectives and
gradient compression (``--paper-mode``, ``--compress``) need several
devices; they come with ``torch.distributed`` (ROADMAP A15) and raise here.
"""
from __future__ import annotations

import argparse
import time


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
    ap.add_argument("--compress", default="none")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.paper_mode or args.compress != "none":
        raise NotImplementedError(
            "--paper-mode / --compress (explicit collectives with gradient "
            "compression) come with torch.distributed, ROADMAP A15")
    if args.plan != "dp":
        raise NotImplementedError(
            f"--plan {args.plan}: the port trains on one device, plan 'dp'")

    from repro_torch.configs import get_config, reduced
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.optim import make_optimizer
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import trainer

    cfg = get_config(args.arch)
    if args.preset == "reduced":
        cfg = reduced(cfg)
    optimizer = make_optimizer(args.optimizer, lr=args.lr,
                               grad_clip=args.grad_clip)
    state = trainer.init_state(cfg, optimizer, seed=args.seed,
                               device=args.device)
    start_step = 0
    if args.resume:
        state, start_step = ckpt.restore(args.resume, state)
        print(f"resumed from {args.resume} at step {start_step}")

    data = SyntheticLM(cfg.vocab_size, args.seq, seed=args.seed)
    step_fn = trainer.make_train_step(cfg, optimizer)
    t0 = time.time()
    for i, batch in enumerate(data.batches(args.batch, args.steps)):
        state, metrics = step_fn(state, batch)
        if (i + 1) % args.log_every == 0 or i == 0:
            print(f"step {start_step+i+1}: loss={float(metrics['loss']):.4f} "
                  f"({(time.time()-t0)/(i+1):.2f}s/step)", flush=True)

    if args.checkpoint:
        ckpt.save(args.checkpoint, state, start_step + args.steps)
        print(f"saved {args.checkpoint}")
    return state


if __name__ == "__main__":
    main()
