"""Serving demo on the PyTorch port: train a tiny model on the copy task
until it can copy, then serve it wave after wave.

    PYTHONPATH=src python examples/serve_demo_torch.py               # card
    PYTHONPATH=src python examples/serve_demo_torch.py --device cpu  # CPU

The counterpart of ``examples/serve_demo.py``, wave for wave: the static
batch (``serve.generate``, batched prefill) and the continuous-batching
engine (paged KV cache, chunked prefill, mixed-length requests joining and
leaving the batch); a replay wave that shows prefix caching (repeated
prompts alias their cached KV blocks and skip most of prefill, with
bit-identical outputs); the engine's telemetry read out (per-request
timelines, the distinct step signatures, a JSONL trace replayed back into
the same timelines, a Prometheus snapshot); an oversubscription wave with
one forced preemption mid-flight, bit-identical to ``serve.generate``; an
n-gram speculative wave (k = 6), bit-identical to the plain engine; and a
zamba2-style hybrid wave (mamba2 slabs and paged shared attention behind
one block table), bit-identical to ``serve.generate``. On the card the
training attention is kernel B6, the engines' decode B1 and the verify
step B4; the last line gives the launch counts.
"""
import argparse
import os
import tempfile

import numpy as np
import torch.distributed as dist

from repro_torch import kernels
from repro_torch.configs import ModelConfig
from repro_torch.core import parallelism as par
from repro_torch.data.pipeline import copy_task
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as T
from repro_torch.optim import make_optimizer
from repro_torch.serving import serve
from repro_torch.serving import telemetry as TM
from repro_torch.serving.engine import (Engine, EngineConfig, OversubConfig,
                                        SpecConfig)
from repro_torch.train import trainer

COPY = ModelConfig(name="copy", family="dense", num_layers=2, d_model=128,
                   num_heads=4, num_kv_heads=4, head_dim=32, d_ff=256,
                   vocab_size=32, loss_chunk=32, attn_chunk=32, remat=False)
HYBRID = ModelConfig(name="copy-hybrid", family="hybrid",
                     hybrid_ssm_per_attn=1, num_layers=2, d_model=64,
                     num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
                     vocab_size=32, loss_chunk=32, attn_chunk=32,
                     remat=False, dtype="float32", ssm_state_dim=8,
                     ssm_head_dim=32)
SEQ = 32


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--steps", type=int, default=250,
                    help="copy-task training steps (batch 32)")
    return ap.parse_args(argv)


def train(cfg, steps, device):
    """The copy model after `steps` Adam steps on ``copy_task`` batches
    (seed = step) under the "dp" plan on a one-rank group of its own;
    whole tensors."""
    made_group = not dist.is_initialized()
    try:
        plan = par.make_plan("dp", make_host_mesh(device=device))
        opt = make_optimizer("adam", lr=2e-3, grad_clip=1.0)
        state = trainer.init_state(cfg, opt, seed=0, device=device)
        step, state, _ = trainer.jit_train_step(cfg, opt, plan, state)
        for i in range(steps):
            state, m = step(state, copy_task(32, SEQ, cfg.vocab_size,
                                             seed=i))
            if i % 50 == 0:
                print(f"step {i:3d} loss {float(m['loss']):.4f}")
        return par.full_tree(state["params"])
    finally:
        if made_group and dist.is_initialized():
            dist.destroy_process_group()


def _engine(cfg, params, device, **kw):
    base = dict(block_size=8, num_blocks=64, max_blocks_per_seq=8,
                max_slots=4, prefill_chunk=16)
    return Engine(cfg, params, EngineConfig(**{**base, **kw}), device=device)


def _generate(cfg, params, prompt, max_new):
    out = serve.generate(cfg, params, np.asarray(prompt)[None],
                         max_new=max_new, temperature=0.0)
    return out[0].cpu().numpy()


def waves(cfg, params, hparams, device):
    """Every serving wave of the demo, printed and checked as the
    reference's; returns each wave's tokens: "static" (4, keep), "engine",
    "replay", "oversub", "spec" (lists in request order) and "hybrid"."""
    res = {}
    test = copy_task(4, SEQ, cfg.vocab_size, seed=9999)
    half = SEQ // 2
    keep = half // 2
    prompt = test["tokens"][:, :half + keep]
    out = serve.generate(cfg, params, prompt, max_new=keep,
                         temperature=0.0).cpu().numpy()
    res["static"] = out
    expect = test["tokens"][:, half + keep:half + 2 * keep]
    acc = float(np.mean(out == expect))
    print(f"legacy static batch: copy accuracy over {keep} tokens x4: "
          f"{acc:.2f}")

    # engine: the same requests, but MIXED lengths — each request keeps a
    # different amount of the copy, so a static batch would have to pad
    eng = _engine(cfg, params, device)
    keeps = [keep, keep // 2, keep - 2, 3]
    prompts = [test["tokens"][b, :half + kp] for b, kp in enumerate(keeps)]
    rids, expects = [], []
    for b, kp in enumerate(keeps):
        rids.append(eng.add_request(prompts[b], max_new=kp))
        expects.append(test["tokens"][b, half + kp:half + 2 * kp])
        eng.step()                       # requests arrive staggered
    outs = eng.drain()
    res["engine"] = [outs[r] for r in rids]
    hits = sum(int(np.sum(outs[r] == e)) for r, e in zip(rids, expects))
    total = sum(len(e) for e in expects)
    st = eng.stats
    print(f"engine (mixed lengths x4): copy accuracy {hits / total:.2f} "
          f"({st['decode_steps']} decode steps, "
          f"{st['prefill_chunks']} prefill chunks, "
          f"occupancy {st['occupancy_sum'] / max(st['decode_steps'], 1):.2f})")
    assert eng.block_pool.num_free == 64, "engine leaked KV blocks"
    signatures_first = eng.telemetry.recompiles.total

    # prefix caching: replay the same prompts — their full prompt blocks are
    # now in the prefix index, so prefill is (almost) entirely skipped and
    # the greedy outputs are bit-identical to the first wave
    chunks_before = eng.stats["prefill_chunks"]
    rids2 = [eng.add_request(p, max_new=kp) for p, kp in zip(prompts, keeps)]
    outs2 = eng.drain()
    res["replay"] = [outs2[r] for r in rids2]
    for r1, r2 in zip(rids, rids2):
        np.testing.assert_array_equal(outs[r1], outs2[r2])
    print(f"engine replay with prefix caching: "
          f"{eng.stats['prefix_hit_tokens']} prompt tokens served from "
          f"cache, {eng.stats['prefill_chunks'] - chunks_before} prefill "
          f"chunks (vs {chunks_before} cold), outputs bit-identical")
    assert eng.stats["prefix_hit_tokens"] > 0, "prefix cache never hit"
    assert eng.block_pool.num_free == 64, "engine leaked KV blocks"

    # telemetry readout: lifecycle timelines, step signatures, exporters
    tel = eng.telemetry
    for rid in rids:
        tl = tel.request_timeline(rid)
        print(f"  request {rid}: queue wait {tl['queue_wait'] * 1e3:.2f} ms, "
              f"TTFT {tl['ttft'] * 1e3:.2f} ms, "
              f"{len(tl['decode_tokens'])} decode tokens")
    print(f"distinct step signatures: {tel.recompiles.total} "
          f"{tel.recompiles.variants()} after both waves "
          f"({signatures_first} after the first)")
    fd, trace_path = tempfile.mkstemp(suffix=".jsonl")
    os.close(fd)
    try:
        n_events = tel.export_jsonl(trace_path)
        replay = TM.replay_jsonl(trace_path)
        for rid in rids:
            assert replay[rid]["ttft"] == tel.request_timeline(rid)["ttft"]
        print(f"JSONL trace: {n_events} events exported and replayed into "
              f"{len(replay)} per-request timelines (TTFTs match live)")
    finally:
        os.unlink(trace_path)
    prom = tel.prometheus_text().splitlines()
    picks = [line for line in prom
             if line.startswith(("engine_tokens_emitted_total",
                                 "engine_prefix_hit_tokens",
                                 "pool_registrations_total",
                                 "engine_request_ttft"))]
    print("prometheus snapshot excerpt:")
    for line in picks[:6]:
        print(f"  {line}")

    # oversubscription wave: an optimistic engine admits with only its prompt
    # blocks reserved and appends decode blocks on demand; forcing a
    # preemption mid-flight exercises the full victim rollback — prefix
    # registered in the cache, request evicted, then resumed from the cached
    # prefix with bit-identical greedy output
    ov = _engine(cfg, params, device, num_blocks=24, oversub=OversubConfig())
    ov_rids, ov_refs = [], []
    for b, (p, kp) in enumerate(zip(prompts, keeps)):
        ov_rids.append(ov.add_request(p, max_new=kp, priority=b % 2))
        ov_refs.append(_generate(cfg, params, p, kp))
    for _ in range(3):
        ov.step()
    forced = next(r for r in ov_rids if ov.preempt_request(r))
    ov_outs = ov.drain()
    res["oversub"] = [ov_outs[r] for r in ov_rids]
    for r, ref in zip(ov_rids, ov_refs):
        np.testing.assert_array_equal(ov_outs[r], ref)
    tl = ov.telemetry.request_timeline(forced)
    print(f"engine oversubscription wave x{len(ov_rids)}: "
          f"{ov.stats['block_appends']} on-demand block appends, "
          f"{ov.stats['preemptions']} preemption(s), "
          f"{ov.stats['resumes']} resume(s), outputs bit-identical")
    print(f"  request {forced} was evicted mid-flight and resumed: "
          f"{tl['preempts']} preempt/resume cycle(s), "
          f"{tl['preempted_s'] * 1e3:.2f} ms out of the batch")
    assert ov.stats["preemptions"] >= 1 and ov.stats["resumes"] >= 1
    assert ov.block_pool.num_free == 24, "oversub engine leaked KV blocks"

    # speculative wave: the copy task is the n-gram drafter's best case —
    # the continuation has literally been seen before (it IS the pattern),
    # so the prompt-lookahead drafter proposes the true tokens and each
    # verify step advances several positions at once, bit-identically
    sp = _engine(cfg, params, device, spec=SpecConfig(k=6))
    sp_rids = [sp.add_request(p, max_new=kp) for p, kp in zip(prompts, keeps)]
    sp_outs = sp.drain()
    res["spec"] = [sp_outs[r] for r in sp_rids]
    for r0, r in zip(rids, sp_rids):
        np.testing.assert_array_equal(outs[r0], sp_outs[r])
    reg = sp.telemetry.registry
    drafted = reg.get("engine_draft_tokens_total").value
    accepted = reg.get("engine_accepted_tokens_total").value
    vsteps = reg.get("engine_verify_steps_total").value
    emitted = sum(len(sp_outs[r]) for r in sp_rids)
    print(f"engine speculative wave (n-gram self-drafting, k=6) x"
          f"{len(sp_rids)}: {accepted}/{drafted} drafts accepted, "
          f"{(emitted - len(sp_rids)) / max(vsteps, 1):.2f} tokens/verify "
          f"step, outputs bit-identical")
    assert accepted > 0, "speculation never accepted a draft"

    # hybrid wave: mamba2 layers carry O(1) recurrent slabs, the shared
    # attention layer pages KV — the same engine serves both behind one
    # block table, matching serve.generate token for token
    rng = np.random.default_rng(0)
    hprompts = [rng.integers(0, 32, size=int(n)).astype(np.int32)
                for n in (5, 11, 8, 3)]
    hnews = [6, 4, 9, 7]
    heng_cfg = EngineConfig(block_size=8, num_blocks=32, max_blocks_per_seq=8,
                            max_slots=4, prefill_chunk=8)
    houts = serve.engine_generate(HYBRID, hparams, hprompts, hnews,
                                  engine_cfg=heng_cfg, device=device)
    res["hybrid"] = houts
    for out, p, mn in zip(houts, hprompts, hnews):
        np.testing.assert_array_equal(out, _generate(HYBRID, hparams, p, mn))
    print(f"engine hybrid wave (mamba2 slabs + paged shared attention) x"
          f"{len(hprompts)}: outputs bit-identical to serve.generate")
    return res


def main(argv=None):
    args = parse(argv)
    kernels.reset_launch_counts()
    params = train(COPY, args.steps, args.device)
    hparams = T.init_params(HYBRID, seed=7, device=args.device)
    res = waves(COPY, params, hparams, args.device)
    print(kernels.launch_line())
    return res


if __name__ == "__main__":
    main()
