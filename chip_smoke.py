#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one
NVIDIA GPU. Run from the repository root:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the final ok line:

  1. device — require CUDA; print the card's name and power limit.
  2. build  — compile every kernel of the main path with nvcc into build/.
  3. kernel — every kernel against its plain PyTorch version on the card
     (f32 atol 2e-5, bf16 atol 2e-2), over the reference's test sweep and
     the yi-9b decode shape; time kernel, plain version and one library
     call, beside the byte / operation bound.
  4. parity — a tiny f32 model served on cuda and on cpu from the same
     weights (staggered requests, a mid-flight defragment, a prefix-cache
     copy-on-write replay): greedy tokens must be equal.
  5. main path — yi-9b at full width (48 layers, bf16, seeded random
     weights) through the port's Engine: mixed requests plus two ~1000-token
     prompts; every request finishes, no NaN logits, no leaked blocks, and
     the paged-attention kernel ran once per layer per decode step.

The last lines are the kernels JSON line, the card line, and
``{"ok": true, "device": {...}}``. Imports nothing of JAX or ``repro``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published peaks (NVIDIA data sheet), at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12                # dense tensor-core peak


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    check(r.returncode == 0 and r.stdout.strip(),
          f"nvidia-smi failed: {r.stderr}")
    return r.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ timing
def time_ms(fn, iters=30, warmup=3):
    """Mean device ms per call from CUDA events around each call, with the
    50 MB L2 flushed before every call (a decode step meets each layer's
    pool cold)."""
    import torch
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


# ----------------------------------------------------------- phase 3: kernel
def _paged_case(gen, B, H, Hkv, hd, N, bs, P, dtype, lens):
    import torch
    dev = "cuda"
    q = torch.randn((B, H, hd), generator=gen, device=dev).to(dtype)
    kp = torch.randn((N, bs, Hkv, hd), generator=gen, device=dev).to(dtype)
    vp = torch.randn((N, bs, Hkv, hd), generator=gen, device=dev).to(dtype)
    perm = torch.randperm(N, generator=gen, device=dev)[:B * P]
    tables = perm.reshape(B, P).to(torch.int32).contiguous()
    return q, kp, vp, tables, torch.tensor(lens, dtype=torch.int32, device=dev)


def kernel_phase(card):
    import torch
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_ref)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    tol = {torch.float32: 2e-5, torch.bfloat16: 2e-2}

    def compare(case, label):
        out = paged_attention(*case)
        ref = paged_attention_ref(*case)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        dt = case[0].dtype
        check(math.isfinite(err) and err <= tol[dt],
              f"paged_attention {label} {dt}: max_abs_err {err} > {tol[dt]}")
        return out, err

    # the reference test sweep (tests/test_paged_attention.py), plus the
    # head dims 16/128/256 and a GQA group count above one pass (16)
    B, N, bs, P = 3, 24, 8, 4
    for H, Hkv, hd in [(4, 4, 32), (4, 2, 64), (8, 1, 32), (8, 2, 16),
                       (8, 2, 128), (4, 1, 256), (16, 1, 64)]:
        for dt in (torch.float32, torch.bfloat16):
            case = _paged_case(gen, B, H, Hkv, hd, N, bs, P, dt,
                               [1, bs * P, bs + 3])
            _, err = compare(case, f"sweep H{H} Hkv{Hkv} hd{hd}")
            print(f"kernel sweep H={H} Hkv={Hkv} hd={hd} {dt}: "
                  f"max_abs_err {err:.3e}")
    # an inactive slot writes zeros
    case = _paged_case(gen, 2, 4, 2, 32, 8, 4, 2, torch.float32, [5, 0])
    out, _ = compare(case, "inactive slot")
    check(bool((out[1] == 0).all()) and bool(torch.isfinite(out).all()),
          "inactive slot row is not all zeros")
    # keys past seq_len are never read: poisoning them changes nothing
    q, kp, vp, tables, lens = _paged_case(gen, 1, 2, 2, 32, 6, 4, 3,
                                          torch.float32, [6])
    out1 = paged_attention(q, kp, vp, tables, lens)
    t = tables[0].tolist()
    for pool in (kp, vp):
        pool[t[1], 2:] = 1e4
        pool[t[2]] = 1e4
    out2 = paged_attention(q, kp, vp, tables, lens)
    check(torch.equal(out1, out2), "poisoned pages past seq_len leaked")
    print("kernel: inactive slot zero, poisoned pages masked")

    # the yi-9b decode shape: B=8 slots, 32 heads over 4 kv heads, hd 128,
    # block 16, 128-page tables, lengths spread over 1..2048
    B, H, Hkv, hd, bs, P = 8, 32, 4, 128, 16, 128
    N = B * P + 1
    lens = [int(x) for x in np.linspace(1, bs * P, B)]
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        case = _paged_case(gen, B, H, Hkv, hd, N, bs, P, dt, lens)
        _, errs[dt] = compare(case, "yi-9b shape")
    print(f"kernel yi-9b shape: max_abs_err f32 {errs[torch.float32]:.3e} "
          f"bf16 {errs[torch.bfloat16]:.3e}")

    q, kp, vp, tables, lens_t = case                    # bf16, as served
    item = q.element_size()
    n_keys = sum(lens)
    pages = sum(-(-n // bs) for n in lens)
    nbytes = (n_keys * Hkv * hd * 2 * item             # K and V read once
              + 2 * q.numel() * item                   # q in, out
              + pages * 4 + B * 4)                     # table entries, lens
    flops = 4 * n_keys * H * hd                        # q·k and p·v
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"

    ms = time_ms(lambda: paged_attention(q, kp, vp, tables, lens_t))
    plain_ms = time_ms(lambda: paged_attention_ref(q, kp, vp, tables, lens_t))
    # library yardstick: SDPA over K/V already gathered contiguous (gather
    # excluded from the time), with the length mask; never used by the port
    import torch.nn.functional as F
    T = P * bs
    kc = kp[tables.long()].reshape(B, T, Hkv, hd).transpose(1, 2).contiguous()
    vc = vp[tables.long()].reshape(B, T, Hkv, hd).transpose(1, 2).contiguous()
    mask = (torch.arange(T, device="cuda")[None, :]
            < lens_t[:, None])[:, None, None, :]
    qh = q[:, :, None, :]

    def library():
        return F.scaled_dot_product_attention(qh, kc, vc, attn_mask=mask,
                                              enable_gqa=True)
    lib_out = library()[:, :, 0]
    lib_err = (lib_out.float() - paged_attention_ref(
        q, kp, vp, tables, lens_t).float()).abs().max().item()
    library_ms = time_ms(library)
    print(f"B1 paged_attention @ yi-9b decode shape (bf16, sum(len)={n_keys}): "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library SDPA on "
          f"pre-gathered K/V {library_ms:.4f} ms (err vs plain {lib_err:.2e}), "
          f"bound {bound_ms:.4f} ms by {bound_by} ({nbytes} B, {flops} flop) "
          f"| {card}")
    return {"name": "paged_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/paged_attention/csrc/"
                      "paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention/kernel.py:52",
            "launches": None, "max_abs_err": errs[torch.bfloat16],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


# ----------------------------------------------------------- phase 4: parity
def _tree_to(tree, device):
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


MIXED_LENS = (3, 7, 12, 5, 20, 9, 4, 15, 26)
MIXED_NEWS = (4, 6, 3, 8, 5, 7, 2, 6, 5)


def parity_phase(card):
    import torch
    from repro_torch import kernels
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import Engine, EngineConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ModelConfig(name="parity-t", family="dense", num_layers=2,
                      d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
                      d_ff=128, vocab_size=50, dtype="float32")
    params = T.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(42)
    prompts = [rng.integers(0, 50, size=n).astype(np.int32)
               for n in MIXED_LENS]
    replay = rng.integers(0, 50, size=12).astype(np.int32)   # 3 full blocks
    outs = {}
    for dev in ("cpu", "cuda"):
        p = _tree_to(params, dev)
        eng = Engine(cfg, p, EngineConfig(block_size=4, num_blocks=64,
                                          max_blocks_per_seq=8, max_slots=4,
                                          prefill_chunk=8), device=dev)
        kernels.reset_launch_counts()
        rids = []
        for pr, mn in zip(prompts, MIXED_NEWS):
            rids.append(eng.add_request(pr, mn))
            eng.step()                              # staggered arrivals
        eng.defragment()                            # mid-flight compaction
        eng.drain()
        # the same prompt twice: the second is fully cached, so the engine
        # copies its last block (copy-on-write) and re-runs one token
        rids += [eng.add_request(replay, 5)]
        eng.drain()
        rids += [eng.add_request(replay, 5)]
        got = eng.drain()
        check(eng.stats["cow_copies"] == 1,
              f"{dev}: cow_copies {eng.stats['cow_copies']} != 1")
        outs[dev] = [got[r].tolist() for r in rids]
        launches = kernels.launch_counts["paged_attention"]
        check(launches == (eng.stats["decode_steps"] * cfg.num_layers
                           if dev == "cuda" else 0),
              f"{dev}: paged_attention launches {launches}")
    check(outs["cpu"] == outs["cuda"],
          f"cuda tokens {outs['cuda']} != cpu tokens {outs['cpu']}")
    print(f"parity: {len(prompts)} staggered requests + defragment + a "
          f"copy-on-write replay pair, cuda tokens == cpu tokens (tf32 off) "
          f"| {card}")


# -------------------------------------------------------- phase 5: main path
def main_path_phase(card, kernel_row):
    import torch
    from repro_torch import kernels
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.serving.workloads import mixed_workload
    cfg = get_config("yi-9b")
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"main: yi-9b weights ({cfg.param_count() / 1e9:.2f} B params, "
          f"{cfg.num_layers} layers, bf16) made on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    ecfg = EngineConfig(block_size=16, num_blocks=1024, max_blocks_per_seq=128,
                        max_slots=8, prefill_chunk=256, step_timing=True)
    eng = Engine(cfg, params, ecfg)

    prompts, news = mixed_workload(n=8, seed=0, vocab=cfg.vocab_size)
    rng = np.random.default_rng(1)
    for n in (1000, 1003):                  # 4 prefill chunks, > 60 pages
        prompts.append(rng.integers(0, cfg.vocab_size, size=n)
                       .astype(np.int32))
        news.append(32)

    nan_flags = []

    def watch(fn, logits_at):
        def wrapped(*a):
            out = fn(*a)
            nan_flags.append(torch.isnan(out[logits_at]).any())
            return out
        return wrapped
    eng._decode = watch(eng._decode, 1)
    eng._prefill = watch(eng._prefill, 1)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rids = [eng.add_request(p, m) for p, m in zip(prompts, news)]
    outs = eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts["paged_attention"]

    check(all(r in outs and len(outs[r]) == m for r, m in zip(rids, news)),
          "not every request finished with its max_new tokens")
    check(not bool(torch.stack(nan_flags).any()), "NaN logits")
    check(eng.block_pool.num_free == ecfg.num_blocks,
          f"blocks leaked: {eng.block_pool.num_free} free of {ecfg.num_blocks}")
    steps = eng.stats["decode_steps"]
    check(launches == steps * cfg.num_layers,
          f"paged_attention launched {launches} times, want decode steps "
          f"{steps} x {cfg.num_layers} layers")
    check(all(0 <= t < cfg.vocab_size for r in rids for t in outs[r]),
          "token out of vocab range")

    generated = sum(len(outs[r]) for r in rids)
    tls = [eng.telemetry.request_timeline(r) for r in rids]
    ttft = [tl["ttft"] for tl in tls]
    tpot = [(tl["finish"] - tl["first_token"]) / (len(outs[r]) - 1)
            for r, tl in zip(rids, tls) if len(outs[r]) > 1]
    host = [s["host_s"] for s in eng.telemetry.steps]
    dev = [s["device_s"] for s in eng.telemetry.steps]
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"main: {len(rids)} requests, {generated} tokens in {wall:.3f} s "
          f"wall = {generated / wall:.2f} tok/s; decode steps {steps}, prefill "
          f"chunks {eng.stats['prefill_chunks']}; depth not cut | {card}")
    print(f"main: TTFT p50 {np.percentile(ttft, 50) * 1e3:.2f} ms p99 "
          f"{np.percentile(ttft, 99) * 1e3:.2f} ms; TPOT p50 "
          f"{np.percentile(tpot, 50) * 1e3:.2f} ms p99 "
          f"{np.percentile(tpot, 99) * 1e3:.2f} ms (step_timing: each device "
          f"call synchronized) | {card}")
    print(f"main: per engine step host {np.median(host) * 1e3:.2f} ms / "
          f"device {np.median(dev) * 1e3:.2f} ms (median of {len(host)}); "
          f"peak memory {peak:.2f} GiB; B1 launches {launches} = {steps} x "
          f"{cfg.num_layers} | {card}")
    kernel_row["launches"] = launches

    # the same requests with the host running ahead of the card (no
    # per-call synchronize): the throughput a serving loop gets
    fast = Engine(cfg, params, dataclasses.replace(ecfg, step_timing=False))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p, m in zip(prompts, news):
        fast.add_request(p, m)
    fast_outs = fast.drain()
    torch.cuda.synchronize()
    wall_fast = time.perf_counter() - t0
    check(sorted(fast_outs) == sorted(range(len(prompts))),
          "host-ahead run did not finish every request")
    print(f"main: host-ahead run (no per-call synchronize) {generated} tokens "
          f"in {wall_fast:.3f} s = {generated / wall_fast:.2f} tok/s | {card}")
    where_time_goes(card, fast, prompts[:8], news[:8])


def where_time_goes(card, eng, prompts, news, warm=3, window=8):
    """Device kernel time by kind over `window` engine steps of the mixed
    requests (prefills and decodes as the scheduler interleaves them),
    from torch.profiler; busy share = kernel time / window wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for p, m in zip(prompts, news):
        eng.add_request(p, m)
    for _ in range(warm):
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(window):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    eng.drain()

    def device_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0) or 0)
    # device-side events, less the engine's own record_function spans
    # ("engine/decode", ...), which the profiler mirrors onto the device
    # timeline as annotations
    kern = [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and device_us(e) > 0 and not e.key.startswith("engine/")]
    busy_ms = sum(device_us(e) for e in kern) / 1e3
    if busy_ms == 0:
        print(f"profile: no device time recorded — not measured | {card}")
        return
    kinds = {"paged_attention kernel (B1)": ("paged_decode",),
             "matmul (cuBLAS)": ("gemm", "nvjet", "cutlass", "xmma", "sm90"),
             }
    by_kind = dict.fromkeys(list(kinds) + ["other kernels and copies"], 0.0)
    for e in kern:
        name = e.key.lower()
        kind = next((k for k, pats in kinds.items()
                     if any(p in name for p in pats)),
                    "other kernels and copies")
        by_kind[kind] += device_us(e) / 1e3
    launches = sum(e.count for e in kern)
    parts = "; ".join(f"{k} {v:.2f} ms ({v / busy_ms:.1%})"
                      for k, v in by_kind.items())
    print(f"profile: {window} engine steps, wall {wall_ms:.2f} ms (profiler "
          f"on), device busy {busy_ms:.2f} ms = {busy_ms / wall_ms:.1%} of "
          f"wall, idle {1 - busy_ms / wall_ms:.1%}; {launches} device ops = "
          f"{launches / window:.0f} per step | {card}")
    print(f"profile: by kind: {parts}")
    top = sorted(kern, key=device_us, reverse=True)[:6]
    print("profile: top kernels: " + "; ".join(
        f"{e.key[:60]} {device_us(e) / 1e3:.2f} ms x{e.count}" for e in top))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"FAIL: {SRC / 'repro_torch'} not found; run from the "
              f"repository root", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()
    try:
        card = card_line()
        name = torch.cuda.get_device_name(0)
        print(f"device: {name} x{torch.cuda.device_count()} | {card} | torch "
              f"{torch.__version__} cuda {torch.version.cuda}")

        from repro_torch.kernels import build
        from repro_torch.kernels.paged_attention.kernel import SOURCE
        t0 = time.perf_counter()
        lib = build.build(SOURCE, extra_flags=("-Xptxas", "-v"), echo=True)
        print(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s")

        row = kernel_phase(card)
        parity_phase(card)
        main_path_phase(card, row)
    except Exception as exc:  # noqa: BLE001 — report any phase's failure
        import traceback
        traceback.print_exc()
        print(f"FAIL: {type(exc).__name__}: {exc}", file=sys.stderr)
        return 1
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [row]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
