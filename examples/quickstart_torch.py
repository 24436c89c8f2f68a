"""Quickstart on the PyTorch port: train a small decoder on synthetic data.

    PYTHONPATH=src python examples/quickstart_torch.py               # card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # CPU

The counterpart of ``examples/quickstart.py``. Builds a reduced yi-9b-family
config, trains 100 steps of minibatch SGD with Adam (survey Algorithm 2 +
Table 3) under the "dp" plan on a one-rank mesh, prints the loss curve,
saves and restores a checkpoint, and greedily decodes a few tokens. On the
card the training attention's forward is kernel B6. The last line gives
the kernels' launch counts.
"""
import argparse
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import kernels
from repro_torch.configs import get_config, reduced
from repro_torch.core import parallelism as par
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim import make_optimizer
from repro_torch.serving import serve
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import trainer


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--new", type=int, default=8,
                    help="greedy tokens decoded after the restore")
    return ap.parse_args(argv)


def run(args, cfg, batches, state=None):
    """Train `cfg` on `batches` (dicts of (B, S) "tokens" / "labels") on a
    one-rank group of its own, save and restore, decode. `state`
    ({"params", "opt"}, plain tensors) replaces the seeded one. Returns
    {"losses", "state" (whole tensors), "restored", "step", "tokens"}."""
    print(f"arch={cfg.name} params={cfg.param_count():,}")
    opt = make_optimizer("adam", lr=3e-3, grad_clip=1.0)
    made_group = not dist.is_initialized()
    try:
        plan = par.make_plan("dp", make_host_mesh(device=args.device))
        if state is None:
            state = trainer.init_state(cfg, opt, seed=0, device=args.device)
        step, state, _ = trainer.jit_train_step(cfg, opt, plan, state)
        losses = []
        for i, batch in enumerate(batches):
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            if i % 10 == 0:
                print(f"step {i:3d}  loss {losses[-1]:.4f}")
        whole = par.full_tree(state)
    finally:
        if made_group and dist.is_initialized():
            dist.destroy_process_group()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "quickstart_ckpt.npz")
        ckpt.save(path, whole, step=len(losses))
        restored, at = ckpt.restore(path, whole)
    print(f"checkpoint roundtrip ok (step {at})")

    prompt = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32)
    out = serve.generate(cfg, restored["params"], prompt, max_new=args.new,
                         temperature=0.0)
    print("greedy continuation:", out[0].tolist())
    return {"losses": losses, "state": whole, "restored": restored,
            "step": at, "tokens": out.cpu().numpy()}


def main(argv=None):
    args = parse(argv)
    kernels.reset_launch_counts()
    cfg = reduced(get_config("yi-9b"))
    data = SyntheticLM(cfg.vocab_size, seq_len=args.seq, noise=0.05)
    out = run(args, cfg, data.batches(batch_size=args.batch,
                                      steps=args.steps))
    assert np.all(np.isfinite(out["losses"])), "non-finite loss"
    print(kernels.launch_line())
    return out


if __name__ == "__main__":
    main()
