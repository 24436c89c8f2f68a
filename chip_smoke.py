#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one
NVIDIA GPU. Run from the repository root:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the final ok line:

  1. device — require CUDA; print the card's name and power limit.
  2. build  — compile the paged-attention, flash-attention, quantize and
     matmul sources (every kernel of the main paths) with nvcc into build/,
     one compiler per source, started together; print the registers and
     spills of each redesigned kernel's instantiations (B6 bf16 by width,
     B7 by input and output type, the bf16 decode and verify B1/B2/B4/B5
     by width, pool and mode) and require 0 spill stores for B6 bf16 at
     widths 64, 80 and 128, for B7 in f32 and bf16 and for the bf16 decode
     and verify at 64, 80, 128 and 256.
  3. kernel — every kernel against its plain PyTorch version on the card
     (f32 atol 2e-5, bf16 atol 2e-2): B1 over the reference's test sweep
     and the yi-9b decode shape; B2 (ring decode), B4 (verify) and B5 (ring
     verify) over head layouts incl. gemma3's and yi-9b's, k = 2, 4, 8,
     ring positions before, at and far past the first wrap, an inactive
     slot and poisoned dead/stale keys, and the CUDA-core entry refusing
     a bf16 query (which runs on the tensor cores in every mode);
     one-query decode (B1, B2) also at
     24 groups (two 16-row tiles) and head dims 72 and 200; each kernel
     timed beside its plain version, one library call and its byte /
     operation bound (B1 at the yi-9b decode shape, B2/B4/B5 at
     gemma3-12b's), by CUDA events and by device time (torch.profiler, the
     L2 flush left out); every bf16 case of B2, B4 and B5 (also on int8
     pools) in the sweeps and every timed bf16 row (B1 too) also within
     1e-2 of each row's rms (the check that sees a lost key slice or
     split). Then B3, the same four modes on int8 pools
     with their scales (dequantized in the kernel), over the same sweeps
     with poisoned dead keys and NaN scales, each timed likewise and beside
     the bf16 kernel on the same values. Then
     B6 (flash attention, the training forward; bf16 on the tensor cores,
     f32 on the CUDA cores): causal and windowed (32, 40, 48, 64, 100,
     1024; 40 and 48 cut a key tile mid-way), GQA 1/4/8, hd 8, 16, 64, 80,
     96, 112, 128, 136, 200, 256 and ragged lengths, with its row
     log-sum-exp within 1e-4 (bf16 also within 1e-2 of each row's rms,
     the check that sees a dropped key tile in a long row); the
     autograd.Function's gradients against autograd through the plain
     version (also at hd 80, and bf16 at hd 80 and 128 on lengths no tile
     divides); at the training shapes (yi-9b, batch 2 x 4096; stablelm-3b,
     hd 80, 1 x 2048) checked by the same three measures and timed beside
     its plain version, SDPA(is_causal) and its operation bound, each with
     TFLOP/s, the kernel and SDPA also by device time.
     Then B9 and B8 (the block quantizers, stochastic and nearest): bits 8
     and 4, n = 256, 1000, 4096, 65537 and a case with an
     all-zero row and a ragged tail, q and scales EQUAL to the plain
     version; the int8 KV quantizer equal on cuda and cpu; each mode timed
     at the largest yi-9b training leaf and over a training step's 12
     leaves beside its plain version and byte bound (no library call
     computes the function), the kernel also by device time. Then B7 (the
     blocked GEMM; bf16 on the tensor cores, f32 on the CUDA cores, each
     fed by a cp.async ring) in f32 and bf16 over the reference's
     sweep, ragged shapes (K = 577 and N = 65 take the bf16 kernel's masked
     scalar loader, N = 200 a partial tile) and the five im2col shapes of
     the survey's Table 6 layer, against its plain version (f32 within
     min(2e-6 K, 1e-5 max|ref|), bf16 within 2e-2 max|ref|; f32 equality
     with cuBLAS f32 printed), timed at the K=3 and K=13 shapes beside its
     plain version, cuBLAS and its bound, each with TFLOP/s and GB/s, the
     kernel and cuBLAS also by device time.
  4. parity — tiny f32 models served on cuda and on cpu from the same
     weights: a full-attention one (staggered requests, a mid-flight
     defragment, a prefix-cache copy-on-write replay), reduced gemma3 and a
     dense sliding config, each also with SpecConfig(k=4) on cuda: greedy
     tokens must be equal. The three again with int8 pools, plain and with
     speculation, and two of them under OversubConfig() with every request
     force-preempted once. Then training: reduced f32 yi-9b and gemma3
     and a tiny dense model at head dim 80 trained 3 Adam steps on cuda and
     on cpu from the same weights and batches; the losses must agree per
     step. Then the paper-mode trainer
     on a one-rank group (gloo for cpu, then nccl for cuda): reduced f32
     yi-9b, 3 Adam steps with the ring allreduce and no compression,
     onebit and topk, cuda vs cpu; and int8 on cuda with B9 vs the same run
     with the plain quantizer (B9 launching only in the first).
  5. main paths — yi-9b at full width (48 layers, bf16, seeded random
     weights) through the port's Engine: mixed requests plus two
     ~1000-token prompts, with bf16 and with int8 pools, then, cut to 16
     of its 48 layers, both pool types in turns and at one fixed pool byte
     budget under oversubscription (the bf16 pool must preempt; peak
     resident sequences of each); then gemma3-12b
     at full width (48 layers: 40 ring-KV local, 8 global) served without
     speculation, with the n-gram drafter and with a replay drafter (k=4),
     plus two prompts that wrap the ring, and with int8 pools without
     speculation and with the n-gram drafter. Every request finishes,
     logits stay finite, no block leaks, and each kernel ran once per
     layer of its kind per decode or verify step. Last, training: yi-9b
     at full width cut to 8 of its 48 layers, batch 2 x 4096, Adam with
     remat, 1 warm-up and 3 timed steps through the port's trainer; the
     losses stay finite and B6 runs twice per layer per step (forward and
     recompute). Then the same model, batch and optimizer through the
     paper-mode trainer (launch/mesh.py's one-rank nccl group, ring
     allreduce, int8 compression with error feedback): finite losses, B6
     twice per layer and B9 once per gradient leaf (12) per step, B8
     never, a finite nonzero residual; step time and peak memory beside
     the plain step's, the compression timed alone, one profiled step.
     Then stablelm-3b (head dim 80) at full width cut to 2 of its 32
     layers, batch 1 x 2048, Adam with remat, 1 warm-up and 2 timed steps:
     finite losses, B6 twice per layer per step. Last, the survey's §4.3
     convolutions at its Table 6 layer (N=64, C=K=64, 56 x 56, f32, kernel
     sizes 3/5/7/11/13, Winograd at 3): every algorithm against
     conv_direct, conv_direct against float64, im2col's GEMM on B7 (once
     per conv_im2col call, also once in bf16), each timed beside its
     Work-Depth W, and the survey's Winograd accuracy claim measured.

  6. serving beyond greedy attention decoders. Kernels: B1 and B4
     at zamba2-2.7b's shared-attention layout (32/32 heads, hd 80), bf16
     and int8 pools, against the plain version and timed beside SDPA and
     the bound (all four rows join the kernels line). Parity (reduced f32,
     TF32 off): serve.generate cuda == cpu == the cuda engine, f32 and
     int8 caches; a sampled request (temperature 0.8, seeded generator):
     cuda engine == cpu engine == cpu generate == forcibly preempted after
     3 decode steps == under SpecConfig(k=4), run unspeculated; rwkv6-7b
     and zamba2-2.7b: cuda engine == cpu engine == cpu generate, n-gram
     spec == plain, every request preempted once == plain (rwkv6: snapshot
     resume, one token prefilled after it). Full width: yi-9b's
     serve.generate (2 x 512-token prompts, 32 new, no kernel launch), 4
     sampled + 4 greedy requests plainly, with a forced preemption and
     under speculation, and a draft-model drafter (2-layer yi-9b width,
     seed 1) with its acceptance; yi-9b in f32 cut to 2 layers, where the
     sampled request's tokens with and without preemption and under
     speculation, and draft-model speculation against plain greedy, are
     gated equal. Then rwkv6-7b (32 layers, full depth) and zamba2-2.7b
     (hd 80; 18 of its 54 layers, 3 of 9 superblocks), bf16: 8 requests
     (prompts 32-128, 32 new) plainly, with n-gram spec k = 4 and under
     oversubscription with one forced preemption (rwkv6 resumes from its
     snapshot, zamba2 re-prefills): finite logits, no leaked block,
     zamba2's B1 == decode steps x 3 and B4 == verify steps x 3 (one
     shared attention a superblock); tokens/s, TTFT, TPOT, per-step host and
     device ms, peak memory and a profile of the decode window. bf16 token
     agreement between paths is reported, not gated (bf16 prefill, decode
     and K-row verify round differently; the f32 runs gate it). zamba2 is
     also served on int8 pools, plainly and with n-gram spec (the same
     requests): B1+B3 == decode steps x 3, B4+B3 == verify steps x 3.

  7. the MoE family and recurrent training. Kernels: B2 and B5 (k = 4)
     at mixtral-8x7b's layout (32/8 heads, hd 128) on its 4096-token
     ring, bf16 and int8 pools, with lengths before, at and past the wrap
     (several splits and a merge), against the plain version (also by
     row error) and timed beside SDPA and the bound (the four rows join
     the kernels line). Parity (reduced f32,
     TF32 off; each path against itself on the cpu, never across paths:
     an MoE layer's capacity follows the step's padded batch): mixtral-8x7b
     and qwen3-moe-30b-a3b engine tokens cuda == cpu, plain, n-gram k=4
     and int8 pools; serve.generate cuda == cpu, batched and loop; 3 Adam
     steps' losses within 1e-4; rwkv6-7b and zamba2-2.7b training losses
     likewise; a tiny hd-80 hybrid on int8 pools, cuda == cpu. Full width:
     qwen3-moe-30b-a3b at full depth (48 layers, 61.1 GB bf16) and
     mixtral-8x7b cut to 16 of 32 layers (93.4 GB for all 32), 8 requests
     of 64-512 prompt tokens and 32 new (mixtral: plus a 4200-token prompt
     that wraps the 4096-token ring), plainly, with n-gram spec, on int8
     pools and with a forced preemption: finite logits, tokens in the
     vocabulary, no leaked block, B1/B4 (qwen3) and B2/B5 (mixtral) once
     per layer a step; spec and preempted agreement with plain printed;
     a decode profile with the MoE layers' device time split into expert
     products and routing, dispatch and combine. Training at full width:
     qwen3-moe-30b-a3b (2 of 48 layers, 1 x 4096, with a profiled step
     whose MoE forward and backward device time is split into expert
     products and routing, dispatch and combine),
     rwkv6-7b (2 of 32, 1 x 2048) and zamba2-2.7b (6 of 54 = one
     superblock, 1 x 2048, B6 at hd 80), Adam with remat: every gradient
     leaf finite once, finite losses, B6 twice per attention layer a step
     (every training main path, yi-9b and stablelm-3b too, checks its
     gradients once before its timed steps).

  8. the last configs (A17). Kernels: B1 and B4 (k = 4) at
     musicgen-medium's layout (24/24 heads, hd 64: MHA), bf16 and int8
     pools, against the plain version (also by row error) and timed
     beside SDPA and the bound (the four rows join the kernels line), and
     untimed at qwen2-vl-2b's (12/2, hd 128) and phi4-mini-3.8b's (24/8,
     hd 128) layouts. Parity (f32, TF32 off): reduced qwen2-vl-2b,
     musicgen-medium and phi4-mini-3.8b engine tokens cuda == cpu, plain,
     n-gram k = 4 and int8 pools; qwen2-vl-2b at full width cut to 2
     layers, engine tokens cuda == cpu, and 2 Adam steps on stub
     embeddings with distinct t / h / w M-RoPE streams (a 1 x 8 x 8 patch
     grid, then text), the first with accum_steps = 2: losses within 1e-4.
     Full width: qwen2-vl-2b at full depth (28 layers) served plainly, with
     n-gram spec, on int8 pools and with a forced preemption, with a
     decode profile, and trained (1 x 4096 stub embeddings with a 32 x 32
     patch grid, Adam, remat); musicgen-medium at full depth (48 layers)
     served plainly and with n-gram spec and trained (1 x 2048 stub
     embeddings); phi4-mini-3.8b served plainly at full depth (32 layers)
     and trained at 4 of 32 layers (1 x 4096). Gates as in 7: finite
     logits, tokens in the vocabulary, no leaked block, B1 / B4 / B1+B3
     once per layer a step, B6 twice per layer a step, every gradient
     leaf finite.

  9. the sharding plans (A15: core/parallelism.py on DTensor) on a
     one-rank group and a (1, 1) ("data", "model") mesh (one card; the
     multi-rank runs are the CPU tests'). Parity (f32, TF32 off): reduced
     yi-9b and qwen3-moe-30b-a3b (capacity factor 1.0, an overflow
     asserted), 2 Adam steps under each of the seven plans: losses within
     1e-4 of the unplanned cuda steps and of the same plan on a gloo cpu
     group; moe_apply_ep under every plan with tensor axes, never under
     dp; B6 launching as in the unplanned steps; pipeline_forward at S =
     1 against the sequential stack. Full width: yi-9b (8 of 48 layers, 2
     x 4096) and qwen3-moe-30b-a3b (2 layers, 1 x 4096, expert
     parallelism engaged) trained under dp_tp in turns with the unplanned
     step (step ms, peak GiB, B6 twice per attention layer a step in
     both); yi-9b served at full width (16 of 48 layers, bf16, 8
     requests x 32 new) under Engine(plan=dp_tp) in turns with the
     unplanned engine (tokens/s, TPOT p50, a profile's busy share; B1 ==
     decode steps x 16), and in f32 at 2 layers with tokens equal to the
     unplanned engine's.

 10. the dry run (A15's op analysis, A16's launch scripts). yi-9b at full
     width cut to 8 of 48 layers, batch 2 x 4096, Adam, remat: one train
     step traced on fake CUDA tensors under core/op_analysis.py, then run
     for real under it: equal FLOPs and HBM bytes, B6's custom-op calls
     equal to its launches, the predicted peak within 10% of
     max_memory_allocated over the step; the H100 roofline time printed
     beside the measured step. Then python -m repro_torch.launch.dryrun on
     the card's path over a fake 256-rank 16 x 16 mesh under dp_tp, three
     processes started together: yi-9b train_4k (ok, B6 reached twice per
     attention layer, none launched), rwkv6-7b decode_32k (ok, fits the
     card), phi4-mini-3.8b long_500k (skipped), each record printed.

 11. the examples (A16): examples/quickstart_torch.py, serve_demo_torch.py
     and compression_comparison_torch.py --ranks 1 on the card at the
     reference's sizes, pipeline_training_torch.py --device cpu (4 gloo
     ranks on the host; its 4-card run needs 4 cards), started together
     with the dry runs of 10 (dryrun_and_examples_phase: seven processes,
     each with a time limit). Each must exit 0, print its reference lines
     (serve_demo keeps the reference's assertions: the pools drain, the prefix cache hits, speculation accepts drafts,
     outputs bit-identical across waves) and launch its kernels, counted
     from 0 in its own process: B6 in quickstart; B1, B4 and B6 in
     serve_demo; B9 in the compression comparison.

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
FP32_FLOPS = 67e12                 # FP32 on the CUDA cores (no tensor cores)


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
def _tflops(flops, ms):
    return f"{flops / ms / 1e9:.1f} TFLOP/s"


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


def _device_us(e):
    """Device time of a profiler key average, in µs (either attribute
    name, by torch version)."""
    return (getattr(e, "self_device_time_total", None)
            or getattr(e, "self_cuda_time_total", 0) or 0)


def device_ms(fn, iters=30, warmup=3):
    """Mean device time per call from torch.profiler: the summed durations
    of the device kernels and copies `fn` launches, with the L2 flush before
    each call (as in time_ms; here a bitwise_not over 128 MB, a kernel no
    timed call launches) left out by its name. Unlike time_ms it holds no
    host time. A profile is kept only if it holds exactly one flush a call;
    None if three profiles in a row do not (the profiler now and then drops
    device events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                flush.bitwise_not_()
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and _device_us(e) > 0]
        flushes = sum(e.count for e in dev if "bitwise_not" in e.key)
        total = sum(_device_us(e) for e in dev if "bitwise_not" not in e.key)
        if flushes == iters and total > 0:
            return total / iters / 1e3
    return None


def _ms(x):
    return "not measured" if x is None else f"{x:.4f} ms"


# bf16 decode (B1, B2 and with int8 pools): the largest row error relative
# to the row's scale, as B6's B6_ROW_TOL. A late row over 2048 keys has rms
# ~0.03, where the absolute 2e-2 alone could pass a kernel that loses one
# warp's key slice or one split
DECODE_ROW_TOL = 1e-2


def _row_error(out, ref):
    """max over rows of rms(out - ref) / rms(ref), rows along the last
    dim (a row whose ref is all zero counts its rms(out))."""
    def rms(x):
        return x.pow(2).mean(-1).sqrt()
    diff = out.float() - ref.float()
    return (rms(diff) / rms(ref.float()).clamp_min(1e-30)).max().item()


# ----------------------------------------------------------- phase 3: kernel
# head layouts (H, Hkv, hd) of the B1 sweeps: the reference test sweep
# (tests/test_paged_attention.py) plus head dims 16/128/256 and 16 groups
B1_LAYOUTS = [(4, 4, 32), (4, 2, 64), (8, 1, 32), (8, 2, 16), (8, 2, 128),
              (4, 1, 256), (16, 1, 64)]
# one-query decode only (B1 and B2): 24 groups (two 16-row tiles, the second
# partial), head dims between the bf16 kernel's widths (72 runs at 80, 200
# at 256; int8 rows of 72 bytes start 8-byte aligned)
DECODE_EXTRA = [(24, 1, 64), (8, 2, 72), (4, 2, 200)]


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

    B, N, bs, P = 3, 24, 8, 4
    for H, Hkv, hd in B1_LAYOUTS + DECODE_EXTRA:
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
        out, errs[dt] = compare(case, "yi-9b shape")
    row_err = _row_error(out, paged_attention_ref(*case))
    check(row_err <= DECODE_ROW_TOL, f"paged_attention yi-9b shape bf16: row "
          f"error {row_err} > {DECODE_ROW_TOL}")
    print(f"kernel yi-9b shape: max_abs_err f32 {errs[torch.float32]:.3e} "
          f"bf16 {errs[torch.bfloat16]:.3e}; bf16 row error {row_err:.3e} "
          f"(limit {DECODE_ROW_TOL})")

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
    dev_ms = device_ms(lambda: paged_attention(q, kp, vp, tables, lens_t))
    lib_dev_ms = device_ms(library)
    print(f"B1 paged_attention @ yi-9b decode shape (bf16, sum(len)={n_keys}): "
          f"kernel {ms:.4f} ms (device {_ms(dev_ms)}), plain {plain_ms:.4f} "
          f"ms, library SDPA on pre-gathered K/V {library_ms:.4f} ms (device "
          f"{_ms(lib_dev_ms)}; err vs plain {lib_err:.2e}), bound "
          f"{bound_ms:.4f} ms by {bound_by} ({nbytes} B, {flops} flop); row "
          f"error {row_err:.3e} | {card}")
    return {"name": "paged_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/paged_attention/csrc/"
                      "paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention/kernel.py:52",
            "launches": None, "max_abs_err": errs[torch.bfloat16],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "device_ms": dev_ms, "library_device_ms": lib_dev_ms,
            "row_error": row_err}


# ---------------------------------------- phase 3b: ring and verify kernels
MULTI_KERNELS = {
    # launch-count key: (name in the kernels line, TPU body it replaces)
    "paged_ring": ("paged_ring",
                   "src/repro/kernels/paged_attention/kernel.py:238"),
    "paged_verify": ("paged_verify",
                     "src/repro/kernels/paged_attention/kernel.py:101"),
    "paged_ring_verify": ("paged_ring_verify",
                          "src/repro/kernels/paged_attention/kernel.py:167"),
}


# head layouts of the ring / verify sweeps, incl. gemma3's and yi-9b's
MULTI_LAYOUTS = [(4, 2, 64), (8, 1, 32), (8, 2, 16), (16, 8, 256),
                 (32, 4, 128)]


def _ring_pages(window, bs, draft=0):
    return -(-(window + draft) // bs) + 1


def _multi_inputs(gen, B, n_q, H, Hkv, hd, N, bs, P, dtype, lens, ring):
    """One case of a ring / verify kernel: (args, kwargs) for the wrapper.
    `ring` = (window, R) or None; decode (n_q == 0) takes q (B, H, hd).
    Ring decode's positions are lens - 1 (0 for an inactive slot, as the
    engine passes); ring verify's are lens - 1 (-1 when inactive)."""
    import torch
    dev = "cuda"
    shape = (B, H, hd) if n_q == 0 else (B, n_q, H, hd)
    q = torch.randn(shape, generator=gen, device=dev).to(dtype)
    kp = torch.randn((N, bs, Hkv, hd), generator=gen, device=dev).to(dtype)
    vp = torch.randn((N, bs, Hkv, hd), generator=gen, device=dev).to(dtype)
    tables = torch.randperm(N, generator=gen, device=dev)[:B * P]
    tables = tables.reshape(B, P).to(torch.int32).contiguous()
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    kw = {}
    if ring is not None:
        window, R = ring
        pos = lens_t - 1
        if n_q == 0:
            pos = torch.clamp(pos, min=0)
        kw = dict(window=window, positions=pos.contiguous(), ring_pages=R)
    return (q, kp, vp, tables, lens_t), kw


def _referenced(tables, lens, kw, n_q, bs, P):
    """(block, offset) pairs some query row may attend: everything else in
    the pool is dead or stale and may be poisoned."""
    out = set()
    tables = tables.tolist()
    for b, n in enumerate(lens):
        if n <= 0:
            continue
        if not kw:
            for t in range(n):
                out.add((tables[b][t // bs], t % bs))
            continue
        R, window = kw["ring_pages"], kw["window"]
        pos = int(kw["positions"][b])
        lo = pos - max(n_q - 1, 0) - window
        for t in range(R * bs):
            q_cur = pos // bs
            page = q_cur - ((q_cur % R - t // bs) % R)
            kpos = page * bs + t % bs
            if page >= 0 and lo < kpos <= pos:
                out.add((tables[b][t // bs], t % bs))
    return out


def multi_kernel_phase(card):
    """B2 (ring decode), B4 (verify) and B5 (ring verify) against their
    plain versions, then each timed at gemma3-12b's decode shape."""
    import torch
    from repro_torch.kernels.paged_attention import (
        paged_attention, paged_attention_ref, paged_attention_verify,
        paged_attention_verify_ref)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    tol = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
    worst = {key: 0.0 for key in MULTI_KERNELS}
    worst_row = dict(worst)

    def run(key, n_q, args, kw):
        if key == "paged_ring":
            return (paged_attention(*args, **kw),
                    paged_attention_ref(*args, **kw))
        return (paged_attention_verify(*args, **kw),
                paged_attention_verify_ref(*args, **kw))

    def compare(key, n_q, args, kw, label):
        out, ref = run(key, n_q, args, kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        dt = args[0].dtype
        check(math.isfinite(err) and err <= tol[dt],
              f"{key} {label} {dt}: max_abs_err {err} > {tol[dt]}")
        if dt == torch.bfloat16:
            worst[key] = max(worst[key], err)
            row_err = _row_error(out, ref)
            check(row_err <= DECODE_ROW_TOL, f"{key} {label} bf16: row error "
                  f"{row_err} > {DECODE_ROW_TOL}")
            worst_row[key] = max(worst_row[key], row_err)
        return out, err

    # sweep: head layouts incl. gemma3's (16, 8, 256) and yi-9b's (32, 4,
    # 128); k in {2, 4, 8}; ring positions before, at and far past the
    # first wrap; an inactive slot; then the dead/stale pages poisoned
    bs, window = 4, 10
    n_cases = 0
    for H, Hkv, hd in MULTI_LAYOUTS + DECODE_EXTRA:
        for dt in (torch.float32, torch.bfloat16):
            for key, n_q in ([("paged_ring", 0)]
                             + [(m, k) for m in ("paged_verify",
                                                 "paged_ring_verify")
                                for k in (2, 4, 8)
                                if (H, Hkv, hd) in MULTI_LAYOUTS]):
                ring_mode = key != "paged_verify"
                if ring_mode:
                    R = _ring_pages(window, bs, max(n_q - 1, 0))
                    P = R + 2
                    wrap = R * bs
                    lens = [max(n_q, 1), window, wrap, wrap + 1,
                            5 * wrap + 3, 0]
                    ring = (window, R)
                else:
                    P, ring = 12, None
                    lens = [n_q, n_q + 3, 13 + n_q, 0, 16, 29 + n_q]
                B = len(lens)
                args, kw = _multi_inputs(gen, B, n_q, H, Hkv, hd, B * P + 3,
                                         bs, P, dt, lens, ring)
                label = f"H{H} Hkv{Hkv} hd{hd} k{n_q}"
                out, _ = compare(key, n_q, args, kw, label)
                check(bool((out[lens.index(0)] == 0).all()),
                      f"{key} {label}: inactive slot row is not zeros")
                q, kp, vp, tables, lens_t = args
                keep = _referenced(tables, lens, kw, n_q, bs, P)
                poison = torch.ones(kp.shape[:2], dtype=torch.bool)
                for blk, off in keep:
                    poison[blk, off] = False
                poison = poison.to("cuda")
                kp2 = torch.where(poison[..., None, None], 1e4, kp).to(dt)
                vp2 = torch.where(poison[..., None, None], 1e4, vp).to(dt)
                out2 = run(key, n_q, (q, kp2, vp2, tables, lens_t), kw)[0]
                check(torch.equal(out, out2),
                      f"{key} {label} {dt}: poisoned dead/stale keys leaked")
                n_cases += 1
    # a bf16 query has one route, the tensor-core kernel: the CUDA-core
    # entry refuses it before launching anything
    from repro_torch.kernels.paged_attention import kernel as PK
    q, kp, vp, tables, lens_t = args
    q = q.to(torch.bfloat16)
    if q.dim() == 3:
        q = q[:, None].contiguous()
    rc = PK._library().paged_attention_multi(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), None, None,
        tables.data_ptr(), lens_t.data_ptr(), lens_t.data_ptr(),
        torch.empty_like(q).data_ptr(), None, q.shape[0], q.shape[1],
        q.shape[2], kp.shape[2], q.shape[3], kp.shape[1], tables.shape[1],
        0, 0, PK.SPLIT_TOKENS, 1.0, 1,
        torch.cuda.current_stream().cuda_stream)
    check(rc != 0, "paged_attention_multi accepted a bf16 query")
    print(f"kernel B4/B5: the CUDA-core entry refuses a bf16 query (CUDA "
          f"error {rc}); bf16 runs paged_decode_tc")
    print(f"kernel B2/B4/B5: {n_cases} cases (5 head layouts x f32/bf16 x "
          f"ring decode + verify/ring verify at k=2,4,8, 3 more layouts in "
          f"ring decode; ring wraps, an "
          f"inactive slot, poisoned dead and stale keys) within f32 2e-5 / "
          f"bf16 2e-2 and bf16 row error {DECODE_ROW_TOL}; worst bf16 err "
          + ", ".join(f"{k} {v:.3e} (row error {worst_row[k]:.3e})"
                      for k, v in worst.items()))

    # gemma3-12b decode shape: B=8, 16 heads over 8 kv heads, hd 256, block
    # 16, 128-page tables, lengths spread over 4..2048, bf16, k=4
    B, H, Hkv, hd, bs, P, W, K = 8, 16, 8, 256, 16, 128, 1024, 4
    lens = [int(x) for x in np.linspace(K, bs * P, B)]
    rows = []
    for key, n_q in (("paged_ring", 0), ("paged_verify", K),
                     ("paged_ring_verify", K)):
        ring = None
        if key != "paged_verify":
            ring = (W, _ring_pages(W, bs, max(n_q - 1, 0)))
        errs = {}
        for dt in (torch.float32, torch.bfloat16):
            args, kw = _multi_inputs(gen, B, n_q, H, Hkv, hd, B * P + 1, bs,
                                     P, dt, lens, ring)
            _, errs[dt] = compare(key, n_q, args, kw, "gemma3 shape")
        rows.append(_time_multi(card, key, n_q, args, kw, errs, W))
    return rows


def _time_multi(card, key, n_q, args, kw, errs, window, shape="gemma3-12b",
                row_name=None, row_replaces=None):
    """Kernel, plain version and SDPA on pre-gathered K/V at one shape, by
    CUDA events and by device time; byte and operation bounds from these
    inputs' live keys; the bf16 output also held to DECODE_ROW_TOL of each
    row's rms. n_q == 0 is a one-query decode (B1 or B2), else a K-query
    verify (B4 or B5). With int8 pools
    (k_scale / v_scale in `kw`) the bytes count the int8 values plus 4
    bytes of scale per vector, SDPA takes K/V gathered AND dequantized
    beforehand, and the bf16 kernel of the same mode is also timed on the
    pools' dequantized contents (the dequant's cost). `row_name` /
    `row_replaces` override the row's name and TPU body (a kernel timed at
    another model's shape)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import (
        paged_attention, paged_attention_ref, paged_attention_verify,
        paged_attention_verify_ref)
    from repro_torch.kernels.paged_attention.ref import ring_key_positions
    from repro_torch.kernels.quantize import dequantize_kv
    q, kp, vp, tables, lens_t = args
    B, H, hd = q.shape[0], q.shape[-2], q.shape[-1]
    _, bs, Hkv, _ = kp.shape
    K = max(n_q, 1)
    quant = "k_scale" in kw
    ring = "ring_pages" in kw
    kern_fn, plain_fn = ((paged_attention, paged_attention_ref) if n_q == 0
                         else (paged_attention_verify,
                               paged_attention_verify_ref))

    def kern():
        return kern_fn(*args, **kw)

    def plain():
        return plain_fn(*args, **kw)
    # key positions and per-row masks, as SDPA's boolean mask
    lens64 = lens_t.long()
    if ring:
        R = kw["ring_pages"]
        pos = kw["positions"].long()
        kpos = ring_key_positions(kw["positions"], R, bs)          # (B, R*bs)
        qpos = pos[:, None] - (K - 1) + torch.arange(K, device="cuda")
        mask = ((kpos[:, None, :] >= 0) & (kpos[:, None, :] <= qpos[..., None])
                & (kpos[:, None, :] > qpos[..., None] - window))
        gather = tables[:, :R].long()
    else:
        T = tables.shape[1] * bs
        kpos = torch.arange(T, device="cuda")[None].expand(B, T)
        qpos = lens64[:, None] - K + torch.arange(K, device="cuda")
        mask = kpos[:, None, :] <= qpos[..., None]
        gather = tables.long()
    n_keys = int(mask.any(dim=1).sum())              # keys some row attends
    pairs = int(mask.sum())                          # (row, key) pairs
    item = q.element_size()
    pages = int(mask.any(dim=1).reshape(B, -1, bs).any(-1).sum())
    vec = hd + 4 if quant else hd * item             # one K or V vector
    nbytes = (n_keys * Hkv * vec * 2                 # K and V read once
              + 2 * q.numel() * item                 # q in, out
              + pages * 4 + B * 4 * (2 if ring else 1))
    flops = 4 * pairs * H * hd                       # q·k and p·v per head
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"

    Tk = gather.shape[1] * bs
    kg, vg = kp[gather], vp[gather]
    if quant:
        kg = dequantize_kv(kg, kw["k_scale"][gather]).to(q.dtype)
        vg = dequantize_kv(vg, kw["v_scale"][gather]).to(q.dtype)
    kc = kg.reshape(B, Tk, Hkv, hd).transpose(1, 2).contiguous()
    vc = vg.reshape(B, Tk, Hkv, hd).transpose(1, 2).contiguous()
    qh = (q[:, :, None, :] if n_q == 0 else q.transpose(1, 2)).contiguous()
    smask = mask[:, None]                            # (B, 1, K, Tk)

    def library():
        return F.scaled_dot_product_attention(qh, kc, vc, attn_mask=smask,
                                              enable_gqa=True)
    lib = library()
    lib = lib[:, :, 0] if n_q == 0 else lib.transpose(1, 2)
    ref = plain()
    lib_err = (lib.float() - ref.float()).abs().max().item()
    row_err = _row_error(kern(), ref)
    check(row_err <= DECODE_ROW_TOL, f"{key} @ {shape} bf16: row error "
          f"{row_err} > {DECODE_ROW_TOL}")
    row = {"row_error": row_err}
    ms = time_ms(kern)
    plain_ms = time_ms(plain)
    library_ms = time_ms(library)
    dev_ms, lib_dev_ms = device_ms(kern), device_ms(library)
    extra = f"; row error {row_err:.3e} (limit {DECODE_ROW_TOL})"
    if quant:
        # the bf16 kernel of the same mode on the same (dequantized) values
        deq = (q, dequantize_kv(kp, kw["k_scale"]).to(q.dtype),
               dequantize_kv(vp, kw["v_scale"]).to(q.dtype), tables, lens_t)
        kw16 = {k: v for k, v in kw.items() if not k.endswith("_scale")}
        bf16_ms = time_ms(lambda: kern_fn(*deq, **kw16))
        name, replaces = key, INT8_KERNELS[key][1]
        row.update(bf16_pool_ms=bf16_ms, variant_of=INT8_KERNELS[key][0])
        extra += (f", bf16 kernel on the dequantized pool {bf16_ms:.4f} ms "
                  f"({ms / bf16_ms:.2f}x)")
    else:
        name, replaces = MULTI_KERNELS.get(key, (key, None))
    replaces = row_replaces or replaces
    pools = "int8" if quant else "bf16"
    print(f"{name} @ {shape} decode shape (bf16 q, {pools} pools, B={B}, "
          f"k={K}, {n_keys} live keys): kernel {ms:.4f} ms (device "
          f"{_ms(dev_ms)}), plain {plain_ms:.4f} ms, library SDPA on "
          f"pre-gathered K/V {library_ms:.4f} ms (device {_ms(lib_dev_ms)}; "
          f"err vs plain {lib_err:.2e}){extra}, bound "
          f"{bound_ms:.4f} ms by {bound_by} ({nbytes} B, {flops} flop); "
          f"max_abs_err f32 {errs[torch.float32]:.3e} bf16 "
          f"{errs[torch.bfloat16]:.3e} | {card}")
    return {"name": row_name or name, "route": "cuda",
            "source": "src/repro_torch/kernels/paged_attention/csrc/"
                      "paged_attention.cu",
            "replaces": replaces, "launches": None,
            "max_abs_err": errs[torch.bfloat16], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "device_ms": dev_ms,
            "library_device_ms": lib_dev_ms, **row}


# ------------------------------------------- phase 3c: int8 pools (B3)
INT8_KERNELS = {
    # launch-count key: (TPU body whose quant=True variant it is, the B3
    # dequant it carries)
    "paged_attention_int8": (
        "src/repro/kernels/paged_attention/kernel.py:52",
        "src/repro/kernels/paged_attention/kernel.py:41"),
    "paged_ring_int8": ("src/repro/kernels/paged_attention/kernel.py:238",
                        "src/repro/kernels/paged_attention/kernel.py:41"),
    "paged_verify_int8": ("src/repro/kernels/paged_attention/kernel.py:101",
                          "src/repro/kernels/paged_attention/kernel.py:41"),
    "paged_ring_verify_int8": (
        "src/repro/kernels/paged_attention/kernel.py:167",
        "src/repro/kernels/paged_attention/kernel.py:41"),
}


def _quantized(args, kw):
    """The case with its pools quantized as the engine stores them: int8
    values and one f32 scale per (slot, kv head) vector."""
    from repro_torch.kernels.quantize import quantize_kv
    q, kp, vp, tables, lens_t = args
    kq, ks = quantize_kv(kp)
    vq, vs = quantize_kv(vp)
    return (q, kq, vq, tables, lens_t), dict(kw, k_scale=ks.contiguous(),
                                             v_scale=vs.contiguous())


def int8_kernel_phase(card):
    """B3: every paged-attention mode on int8 pools (B1, B2, B4, B5 with the
    in-kernel dequant) against its plain version with scales over the B1
    and B2/B4/B5 sweeps, poisoned dead keys (values 127, scales NaN) read
    nowhere, and ref-with-scales == ref on the dequantized pool bit for
    bit; then each timed beside the bf16 kernel on the same (dequantized)
    values: B1 at yi-9b's decode shape, B2/B4/B5 at gemma3-12b's."""
    import torch
    from repro_torch.kernels.paged_attention import (
        paged_attention, paged_attention_ref, paged_attention_verify,
        paged_attention_verify_ref)
    from repro_torch.kernels.quantize import dequantize_kv
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    tol = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
    worst = dict.fromkeys(INT8_KERNELS, 0.0)
    worst_row = dict(worst)

    def fns(n_q):
        return ((paged_attention, paged_attention_ref) if n_q == 0
                else (paged_attention_verify, paged_attention_verify_ref))

    def compare(key, n_q, args, kw, label):
        kern, plain = fns(n_q)
        out, ref = kern(*args, **kw), plain(*args, **kw)
        q, kq, vq, tables, lens_t = args
        kw16 = {k: v for k, v in kw.items() if not k.endswith("_scale")}
        ref_deq = plain(q, dequantize_kv(kq, kw["k_scale"]),
                        dequantize_kv(vq, kw["v_scale"]), tables, lens_t,
                        **kw16)
        torch.cuda.synchronize()
        check(torch.equal(ref, ref_deq), f"{key} {label}: ref with scales != "
              f"ref on the dequantized pool")
        err = (out.float() - ref.float()).abs().max().item()
        dt = q.dtype
        check(math.isfinite(err) and err <= tol[dt],
              f"{key} {label} {dt}: max_abs_err {err} > {tol[dt]}")
        if dt == torch.bfloat16:
            worst[key] = max(worst[key], err)
            row_err = _row_error(out, ref)
            check(row_err <= DECODE_ROW_TOL, f"{key} {label} bf16: row error "
                  f"{row_err} > {DECODE_ROW_TOL}")
            worst_row[key] = max(worst_row[key], row_err)
        return out, err

    def poisoned(key, n_q, args, kw, lens, bs, P, label):
        """Every (block, offset) no row may attend gets int8 127 and scale
        NaN: the output must not change by one bit."""
        q, kq, vq, tables, lens_t = args
        keep = _referenced(tables, lens,
                           {k: v for k, v in kw.items()
                            if not k.endswith("_scale")}, n_q, bs, P)
        dead = torch.ones(kq.shape[:2], dtype=torch.bool)
        for blk, off in keep:
            dead[blk, off] = False
        dead = dead.to("cuda")
        kern = fns(n_q)[0]
        out = kern(*args, **kw)
        bad = dict(kw, k_scale=torch.where(dead[..., None], float("nan"),
                                           kw["k_scale"]).contiguous(),
                   v_scale=torch.where(dead[..., None], float("nan"),
                                       kw["v_scale"]).contiguous())
        kq2 = torch.where(dead[..., None, None], 127, kq).to(torch.int8)
        vq2 = torch.where(dead[..., None, None], 127, vq).to(torch.int8)
        out2 = kern(q, kq2, vq2, tables, lens_t, **bad)
        check(torch.equal(out, out2),
              f"{key} {label}: poisoned dead keys or scales leaked")

    n_cases = 0
    # B1 + B3: the B1 sweep, an inactive slot, dead pages past seq_len
    B, N, bs, P = 3, 24, 8, 4
    for H, Hkv, hd in B1_LAYOUTS + DECODE_EXTRA:
        for dt in (torch.float32, torch.bfloat16):
            lens = [1, bs * P, bs + 3]
            args, kw = _quantized(_paged_case(gen, B, H, Hkv, hd, N, bs, P,
                                              dt, lens), {})
            label = f"H{H} Hkv{Hkv} hd{hd}"
            compare("paged_attention_int8", 0, args, kw, label)
            poisoned("paged_attention_int8", 0, args, kw, lens, bs, P, label)
            n_cases += 1
    args, kw = _quantized(_paged_case(gen, 2, 4, 2, 32, 8, 4, 2,
                                      torch.float32, [5, 0]), {})
    out, _ = compare("paged_attention_int8", 0, args, kw, "inactive slot")
    check(bool((out[1] == 0).all()), "int8 inactive slot row is not zeros")
    # B2/B4/B5 + B3: the ring / verify sweep
    bs, window = 4, 10
    for H, Hkv, hd in MULTI_LAYOUTS + DECODE_EXTRA:
        for dt in (torch.float32, torch.bfloat16):
            for key, n_q in ([("paged_ring_int8", 0)]
                             + [(m, k) for m in ("paged_verify_int8",
                                                 "paged_ring_verify_int8")
                                for k in (2, 4, 8)
                                if (H, Hkv, hd) in MULTI_LAYOUTS]):
                if key != "paged_verify_int8":
                    R = _ring_pages(window, bs, max(n_q - 1, 0))
                    P = R + 2
                    wrap = R * bs
                    lens = [max(n_q, 1), window, wrap, wrap + 1,
                            5 * wrap + 3, 0]
                    ring = (window, R)
                else:
                    P, ring = 12, None
                    lens = [n_q, n_q + 3, 13 + n_q, 0, 16, 29 + n_q]
                args, kw = _quantized(*_multi_inputs(
                    gen, len(lens), n_q, H, Hkv, hd, len(lens) * P + 3, bs,
                    P, dt, lens, ring))
                label = f"H{H} Hkv{Hkv} hd{hd} k{n_q}"
                out, _ = compare(key, n_q, args, kw, label)
                check(bool((out[lens.index(0)] == 0).all()),
                      f"{key} {label}: inactive slot row is not zeros")
                poisoned(key, n_q, args, kw, lens, bs, P, label)
                n_cases += 1
    print(f"kernel B3 (int8 pools in B1/B2/B4/B5): {n_cases} cases + an "
          f"inactive slot within f32 2e-5 / bf16 2e-2 and bf16 row error "
          f"{DECODE_ROW_TOL}, ref with scales == "
          f"ref on the dequantized pool bit for bit, poisoned dead keys and "
          f"NaN scales read nowhere; worst bf16 err " + ", ".join(
              f"{k} {v:.3e} (row error {worst_row[k]:.3e})"
              for k, v in worst.items()))

    rows = []
    # B1 + B3 at the yi-9b decode shape (as kernel_phase times B1)
    B, H, Hkv, hd, bs, P = 8, 32, 4, 128, 16, 128
    lens = [int(x) for x in np.linspace(1, bs * P, B)]
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        args, kw = _quantized(_paged_case(gen, B, H, Hkv, hd, B * P + 1, bs,
                                          P, dt, lens), {})
        _, errs[dt] = compare("paged_attention_int8", 0, args, kw,
                              "yi-9b shape")
    rows.append(_time_multi(card, "paged_attention_int8", 0, args, kw, errs,
                            None, shape="yi-9b"))
    # B2/B4/B5 + B3 at the gemma3-12b decode shape (as multi_kernel_phase)
    B, H, Hkv, hd, bs, P, W, K = 8, 16, 8, 256, 16, 128, 1024, 4
    lens = [int(x) for x in np.linspace(K, bs * P, B)]
    for key, n_q in (("paged_ring_int8", 0), ("paged_verify_int8", K),
                     ("paged_ring_verify_int8", K)):
        ring = None
        if key != "paged_verify_int8":
            ring = (W, _ring_pages(W, bs, max(n_q - 1, 0)))
        errs = {}
        for dt in (torch.float32, torch.bfloat16):
            args, kw = _quantized(*_multi_inputs(
                gen, B, n_q, H, Hkv, hd, B * P + 1, bs, P, dt, lens, ring))
            _, errs[dt] = compare(key, n_q, args, kw, "gemma3 shape")
        rows.append(_time_multi(card, key, n_q, args, kw, errs, W))
    return rows


# ----------------------------------------------------------- phase 4: parity
def _tree_to(tree, device):
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


MIXED_LENS = (3, 7, 12, 5, 20, 9, 4, 15, 26)
MIXED_NEWS = (4, 6, 3, 8, 5, 7, 2, 6, 5)


def parity_phase(card):
    import torch
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

        def run(eng=eng):
            rids = []
            for pr, mn in zip(prompts, MIXED_NEWS):
                rids.append(eng.add_request(pr, mn))
                eng.step()                          # staggered arrivals
            eng.defragment()                        # mid-flight compaction
            eng.drain()
            # the same prompt twice: the second is fully cached, so the
            # engine copies its last block (copy-on-write) and re-runs one
            # token
            rids += [eng.add_request(replay, 5)]
            eng.drain()
            rids += [eng.add_request(replay, 5)]
            got = eng.drain()
            return [got[r].tolist() for r in rids]
        outs[dev], n = _counted(eng, run)
        check(eng.stats["cow_copies"] == 1,
              f"{dev}: cow_copies {eng.stats['cow_copies']} != 1")
        launches = n["paged_attention"]
        check(launches == (eng.stats["decode_steps"] * cfg.num_layers
                           if dev == "cuda" else 0),
              f"{dev}: paged_attention launches {launches}")
    check(outs["cpu"] == outs["cuda"],
          f"cuda tokens {outs['cuda']} != cpu tokens {outs['cpu']}")
    print(f"parity: {len(prompts)} staggered requests + defragment + a "
          f"copy-on-write replay pair, cuda tokens == cpu tokens (tf32 off) "
          f"| {card}")


def _serve(eng, prompts, news, stagger=True):
    rids = []
    for p, m in zip(prompts, news):
        rids.append(eng.add_request(p, m))
        if stagger:
            eng.step()
    got = eng.drain()
    return [got[r].tolist() for r in rids]


def ring_spec_parity_phase(card):
    """Reduced gemma3 (1 local + 1 global layer, window 32) and a dense
    sliding config (window 8, so 16-token prefill chunks lap its 12-slot
    ring), f32: cuda tokens == cpu tokens, and the cuda engine with
    SpecConfig(k=4) == without; each kernel ran once per layer of its kind
    per decode or verify step."""
    import torch
    from repro_torch.configs.base import ModelConfig, get_config, reduced
    from repro_torch.models import state_providers as SP
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import Engine, EngineConfig, SpecConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gemma = dataclasses.replace(reduced(get_config("gemma3-12b")),
                                dtype="float32")
    sliding = ModelConfig(name="sliding-t", family="dense", num_layers=2,
                          d_model=64, num_heads=4, num_kv_heads=2,
                          head_dim=16, d_ff=128, vocab_size=50,
                          attention_type="sliding", window_size=8,
                          dtype="float32")
    rng = np.random.default_rng(7)
    for cfg, lens, news, ek in (
            (gemma, (5, 40, 70, 12, 33), (10, 30, 8, 20, 12),
             dict(block_size=4, num_blocks=128, max_blocks_per_seq=24,
                  max_slots=3, prefill_chunk=16)),
            (sliding, (3, 26, 9, 17, 30), (6, 12, 20, 5, 9),
             dict(block_size=4, num_blocks=64, max_blocks_per_seq=10,
                  max_slots=3, prefill_chunk=16))):
        params = T.init_params(cfg, seed=0, device="cpu")
        prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
                   for n in lens]
        kinds = SP.state_kinds(cfg)
        n_sb, _ = SP.superblock_layout(cfg)
        n_full, n_ring = (n_sb * kinds.count(k) for k in ("full", "ring"))
        outs = {}
        for dev, spec in (("cpu", None), ("cuda", None), ("cuda", 4)):
            eng = Engine(cfg, _tree_to(params, dev), EngineConfig(
                **ek, spec=SpecConfig(k=spec) if spec else None), device=dev)
            outs[dev, spec], n = _counted(
                eng, lambda eng=eng: _serve(eng, prompts, news))
            steps = eng.stats["decode_steps"] if dev == "cuda" else 0
            want = ({"paged_attention": n_full * steps,
                     "paged_ring": n_ring * steps}
                    if spec is None else
                    {"paged_verify": n_full * steps,
                     "paged_ring_verify": n_ring * steps})
            got = {k: n[k] for k in want}
            check(got == want and sum(n.values()) == sum(want.values()),
                  f"{cfg.name} {dev} spec={spec}: launches {n} != {want}")
        check(outs["cuda", None] == outs["cpu", None],
              f"{cfg.name}: cuda tokens {outs['cuda', None]} != cpu tokens "
              f"{outs['cpu', None]}")
        check(outs["cuda", 4] == outs["cuda", None],
              f"{cfg.name}: spec tokens {outs['cuda', 4]} != plain "
              f"{outs['cuda', None]}")
        print(f"parity {cfg.name}: {len(lens)} staggered requests, cuda "
              f"tokens == cpu tokens, cuda spec k=4 tokens == cuda plain "
              f"(tf32 off) | {card}")


def _counted(eng, run):
    """`run()` from zeroed launch counts; returns its result and the kernel
    launches it made, by ``kernels.launch_counts`` key. The wrappers count
    what they issue. An engine that replays its captured decode graph
    issues the decode's paged kernels through none of them: its run is
    traced (kernels only, which keeps the trace cheap) and the paged
    decode kernels that the trace names are added
    (``kernels.trace_decode_launches``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import kernels
    kernels.reset_launch_counts()
    if getattr(eng, "_decode_graph", None) is None:
        out = run()
        return out, dict(kernels.launch_counts)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = run()
        torch.cuda.synchronize()
    n = dict(kernels.launch_counts)
    for k, m in kernels.trace_decode_launches(
            e.name for e in prof.events()
            if str(e.device_type).endswith("CUDA")).items():
        n[k] += m
    return out, n


def _launch_want(**counts):
    """Every launch-count key, zero unless given."""
    from repro_torch import kernels
    return {k: counts.get(k, 0) for k in kernels.launch_counts}


def int8_parity_phase(card):
    """int8 pools (EngineConfig.kv_quant) on the three parity configs (the
    full-attention one, reduced gemma3, the dense sliding one), f32: cuda
    tokens == cpu tokens, plain and with SpecConfig(k=4), and spec == plain;
    the int8 kernels ran once per layer of their kind per step. Then the
    full-attention and gemma3 configs under OversubConfig() with every
    request force-preempted once after its second token (budgets of at
    least 4 tokens): cuda == cpu == the cuda run without preemption."""
    import torch
    from repro_torch.configs.base import ModelConfig, get_config, reduced
    from repro_torch.models import state_providers as SP
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import (Engine, EngineConfig,
                                            KVQuantConfig, OversubConfig,
                                            SpecConfig)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    small = dict(family="dense", num_layers=2, d_model=64, num_heads=4,
                 num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=50,
                 dtype="float32")
    full = ModelConfig(name="parity-t", **small)
    sliding = ModelConfig(name="sliding-t", attention_type="sliding",
                          window_size=8, **small)
    gemma = dataclasses.replace(reduced(get_config("gemma3-12b")),
                                dtype="float32")
    kvq = KVQuantConfig()
    rng = np.random.default_rng(11)
    plain_outs = {}
    for cfg, lens, news, ek in (
            (full, MIXED_LENS, MIXED_NEWS,
             dict(block_size=4, num_blocks=64, max_blocks_per_seq=12,
                  max_slots=4, prefill_chunk=8)),
            (gemma, (5, 40, 70, 12, 33), (10, 30, 8, 20, 12),
             dict(block_size=4, num_blocks=128, max_blocks_per_seq=24,
                  max_slots=3, prefill_chunk=16)),
            (sliding, (3, 26, 9, 17, 30), (6, 12, 20, 5, 9),
             dict(block_size=4, num_blocks=64, max_blocks_per_seq=10,
                  max_slots=3, prefill_chunk=16))):
        params = T.init_params(cfg, seed=0, device="cpu")
        prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
                   for n in lens]
        kinds = SP.state_kinds(cfg)
        n_sb, _ = SP.superblock_layout(cfg)
        n_full, n_ring = (n_sb * kinds.count(k) for k in ("full", "ring"))
        outs = {}
        for dev, spec in (("cpu", None), ("cuda", None), ("cpu", 4),
                          ("cuda", 4)):
            eng = Engine(cfg, _tree_to(params, dev), EngineConfig(
                **ek, kv_quant=kvq,
                spec=SpecConfig(k=spec) if spec else None), device=dev)
            outs[dev, spec], n = _counted(
                eng, lambda eng=eng: _serve(eng, prompts, news))
            steps = eng.stats["decode_steps"] if dev == "cuda" else 0
            want = (_launch_want(paged_attention_int8=n_full * steps,
                                 paged_ring_int8=n_ring * steps)
                    if spec is None else
                    _launch_want(paged_verify_int8=n_full * steps,
                                 paged_ring_verify_int8=n_ring * steps))
            check(n == want,
                  f"int8 {cfg.name} {dev} spec={spec}: launches {n} != "
                  f"{want}")
        for spec in (None, 4):
            check(outs["cuda", spec] == outs["cpu", spec],
                  f"int8 {cfg.name} spec={spec}: cuda tokens "
                  f"{outs['cuda', spec]} != cpu tokens {outs['cpu', spec]}")
        check(outs["cuda", 4] == outs["cuda", None],
              f"int8 {cfg.name}: spec tokens {outs['cuda', 4]} != plain "
              f"{outs['cuda', None]}")
        plain_outs[cfg.name] = (cfg, params, prompts, news, ek)
        print(f"parity int8 {cfg.name}: {len(lens)} staggered requests, cuda "
              f"tokens == cpu tokens plain and spec k=4, spec == plain "
              f"(tf32 off) | {card}")

    for name in (full.name, gemma.name):
        cfg, params, prompts, news, ek = plain_outs[name]
        news = [max(m, 4) for m in news]
        outs = {}
        for dev, forced in (("cpu", True), ("cuda", True), ("cuda", False)):
            eng = Engine(cfg, _tree_to(params, dev), EngineConfig(
                **ek, kv_quant=kvq, oversub=OversubConfig()), device=dev)
            rids = [eng.add_request(p, m) for p, m in zip(prompts, news)]
            pending = set(rids) if forced else set()
            while eng.scheduler.has_work:
                eng.step()
                for r in sorted(pending):
                    req = eng.requests[r]
                    if req.state == "decoding" and len(req.out_tokens) >= 2:
                        check(eng.preempt_request(r), f"preempt {r} refused")
                        pending.discard(r)
            got = eng.drain()
            check(not pending and eng.stats["resumes"] >= (
                len(rids) if forced else 0),
                f"int8 oversub {name} {dev}: not every request was preempted "
                f"and resumed ({eng.stats})")
            check(eng.block_pool.num_free == ek["num_blocks"],
                  f"int8 oversub {name} {dev}: blocks leaked")
            outs[dev, forced] = [got[r].tolist() for r in rids]
        check(outs["cuda", True] == outs["cpu", True] == outs["cuda", False],
              f"int8 oversub {name}: forced-preemption tokens cuda "
              f"{outs['cuda', True]} / cpu {outs['cpu', True]} != "
              f"unpreempted {outs['cuda', False]}")
        print(f"parity int8 + oversub {name}: every request preempted once "
              f"mid-decode and resumed; cuda tokens == cpu tokens == the run "
              f"without preemption | {card}")


# -------------------------------------------------------- phase 5: main path
def main_path_phase(card, kernel_row):
    """yi-9b at full width through the port's Engine (bf16 pools); returns
    what the int8 and oversubscription runs reuse: (params, engine config,
    prompts, news, tokens per request)."""
    import torch
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

    def run():
        outs = eng.drain()
        torch.cuda.synchronize()
        return outs, time.perf_counter()
    t0 = time.perf_counter()
    rids = [eng.add_request(p, m) for p, m in zip(prompts, news)]
    (outs, t1), n = _counted(eng, run)
    wall = t1 - t0           # the trace's post-processing left out
    launches = n["paged_attention"]

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
          f"chunks {eng.stats['prefill_chunks']}; depth not cut; kernels "
          f"traced | {card}")
    print(f"main: TTFT p50 {np.percentile(ttft, 50) * 1e3:.2f} ms p99 "
          f"{np.percentile(ttft, 99) * 1e3:.2f} ms; TPOT p50 "
          f"{np.percentile(tpot, 50) * 1e3:.2f} ms p99 "
          f"{np.percentile(tpot, 99) * 1e3:.2f} ms (step_timing: each device "
          f"call synchronized) | {card}")
    print(f"main: per engine step host {np.median(host) * 1e3:.2f} ms / "
          f"device {np.median(dev) * 1e3:.2f} ms (median of {len(host)}); "
          f"peak memory {peak:.2f} GiB; B1 launches {launches} = {steps} x "
          f"{cfg.num_layers} | {card}")
    check(sum(n.values()) == launches,
          f"yi-9b launched other kernels: {n}")
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
    where_time_goes(card, fast, prompts, news, warm=18,
                    label="decode with the two long contexts")
    return params, ecfg, prompts, news, [outs[r].tolist() for r in rids]


def _timed_run(card, eng, label, waves, hook=None):
    """Serve request waves through `eng` with every device call checked for
    finite logits: wave 0 is submitted at once, each later wave after one
    more engine step; then drain. Checks that every request finished with
    its max_new tokens in the vocabulary and that no block leaked; prints
    tokens/s, TTFT / TPOT p50 and p99 (step_timing engines), per-step host
    and device medians, peak resident sequences, preemptions, resumes,
    block appends, the pools' bytes and peak device memory. `waves`: lists
    of (prompt, max_new, priority); `hook(eng)`, if given, runs after every
    step (a forced preemption). The run's launches are `_counted`'s."""
    import torch
    bad = []

    def watch(fn, logits_at):
        def wrapped(*a):
            out = fn(*a)
            bad.append(~torch.isfinite(out[logits_at]).all())
            return out
        return wrapped
    eng._decode = watch(eng._decode, 1)
    eng._prefill = watch(eng._prefill, 1)
    if eng._verify is not None:
        eng._verify = watch(eng._verify, 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rids, news = [], []

    def run():
        resident = 0
        for i, wave in enumerate(waves):
            if i:
                eng.step()
                resident = max(resident, len(eng.scheduler.running))
            for p, m, pr in wave:
                rids.append(eng.add_request(p, m, priority=pr))
                news.append(m)
        while eng.scheduler.has_work:
            eng.step()
            resident = max(resident, len(eng.scheduler.running))
            if hook is not None:
                hook(eng)
        got = eng.drain()
        torch.cuda.synchronize()
        return got, resident, time.perf_counter()
    t0 = time.perf_counter()
    (got, resident, t1), launches = _counted(eng, run)
    wall = t1 - t0           # the trace's post-processing left out
    vocab = eng.cfg.vocab_size
    check(all(r in got and len(got[r]) == m for r, m in zip(rids, news)),
          f"{label}: not every request finished with its max_new tokens")
    check(not bool(torch.stack(bad).any()), f"{label}: non-finite logits")
    check(eng.block_pool.num_free == eng.ecfg.num_blocks,
          f"{label}: blocks leaked")
    check(all(0 <= t < vocab for r in rids for t in got[r]),
          f"{label}: token out of vocab range")
    st = eng.stats
    generated = sum(len(got[r]) for r in rids)
    tls = [eng.telemetry.request_timeline(r) for r in rids]
    ttft = [tl["ttft"] for tl in tls]
    tpot = [(tl["finish"] - tl["first_token"]) / (len(got[r]) - 1)
            for r, tl in zip(rids, tls) if len(got[r]) > 1]
    host = [x["host_s"] for x in eng.telemetry.steps]
    dev = [x["device_s"] for x in eng.telemetry.steps]
    peak = torch.cuda.max_memory_allocated() / 2**30
    pool_mib = sum(a.numel() * a.element_size()
                   for layer in eng.pool_state.values()
                   for a in layer.values()) / 2**20
    print(f"{label}: {len(rids)} requests, {generated} tokens in {wall:.3f} s "
          f"= {generated / wall:.2f} tok/s (each device call synchronized"
          f"{', kernels traced' if eng._decode_graph is not None else ''}); "
          f"decode steps {st['decode_steps']}, prefill chunks "
          f"{st['prefill_chunks']}; peak resident sequences {resident}; "
          f"preemptions {st['preemptions']}, resumes {st['resumes']}, block "
          f"appends {st['block_appends']} | {card}")
    print(f"{label}: TTFT p50 {np.percentile(ttft, 50) * 1e3:.2f} ms p99 "
          f"{np.percentile(ttft, 99) * 1e3:.2f} ms; TPOT p50 "
          f"{np.percentile(tpot, 50) * 1e3:.2f} ms p99 "
          f"{np.percentile(tpot, 99) * 1e3:.2f} ms; per step host "
          f"{np.median(host) * 1e3:.2f} ms / device "
          f"{np.median(dev) * 1e3:.2f} ms (median of {len(host)}); pools "
          f"{eng.ecfg.num_blocks} blocks = {pool_mib:.2f} MiB; peak memory "
          f"{peak:.2f} GiB | {card}")
    return {"outs": [got[r].tolist() for r in rids],
            "launches": launches,
            "steps": st["decode_steps"], "resident": resident,
            "preemptions": st["preemptions"], "resumes": st["resumes"],
            "tok_s": generated / wall, "step_ms": np.median(dev) * 1e3,
            "tpot_p50": float(np.percentile(tpot, 50)) * 1e3}


def _match_share(label, base, other, against="the bf16-pool run",
                 why=None):
    """Requests whose tokens equal `base`'s (by default the bf16-pool run's:
    int8 is a different result), reported, not gated; the f32 parity phases
    gate token equality."""
    same, first = 0, []
    for a, b in zip(base, other):
        diff = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
        same += not diff
        first.append(diff[0] if diff else None)
    print(f"{label}: {same}/{len(first)} requests match {against} end "
          f"to end; first divergent position per request {first} (reported, "
          f"not gated{': ' + why if why else ''})")


POOL_TURN_LAYERS = 16   # of yi-9b's 48: the pools in turns and the fixed
                        # budget runs, whose cost is per layer (for the
                        # smoke's time)


def yi9b_int8_phase(card, rows, params, ecfg, prompts, news, bf16_outs):
    """yi-9b at full width with int8 pools (kv_quant) at the main phase's
    settings and requests; then, cut to POOL_TURN_LAYERS layers, the two
    pool types in turns and at one fixed pool byte budget under
    OversubConfig(): bf16 with N blocks, int8 with N·(2·hd·2) //
    (2·(hd + 4)) blocks. Traffic for the budget runs: the 8 mixed
    requests as batch class 1, then after one step the two long prompts
    as interactive class 0, with 16 slots so the pool binds; the bf16 pool
    must preempt."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.serving.engine import Engine, KVQuantConfig, OversubConfig
    _release_card()
    cfg = get_config("yi-9b")
    kvq = KVQuantConfig()
    L = cfg.num_layers
    eng = Engine(cfg, params, dataclasses.replace(ecfg, kv_quant=kvq))
    r = _timed_run(card, eng, "yi-9b int8", [[(p, m, 0) for p, m in
                                              zip(prompts, news)]])
    want = _launch_want(paged_attention_int8=r["steps"] * L)
    check(r["launches"] == want,
          f"yi-9b int8: launches {r['launches']} != {want}")
    print(f"yi-9b int8: B1 int8 launches {r['steps'] * L} = {r['steps']} x "
          f"{L} layers")
    _match_share("yi-9b int8 vs bf16", bf16_outs, r["outs"])
    by_name = {row["name"]: row for row in rows}
    by_name["paged_attention_int8"]["launches"] = r["launches"][
        "paged_attention_int8"]
    del eng
    _release_card()
    # the host-ahead run and the profiles at full depth (below); the turns
    # and the budget runs on the first POOL_TURN_LAYERS layers' weights
    full, cfg = cfg, dataclasses.replace(cfg, num_layers=POOL_TURN_LAYERS)
    L = cfg.num_layers
    # bf16 and int8 pools in turns within this process (bf16, int8, int8,
    # bf16), synchronized: the pool type's cost on the same requests
    turns = []
    for label, q in (("bf16", None), ("int8", kvq), ("int8", kvq),
                     ("bf16", None)):
        eng = Engine(cfg, params, dataclasses.replace(ecfg, kv_quant=q))
        r = _timed_run(card, eng, f"yi-9b turn {len(turns) + 1} {label}",
                       [[(p, m, 0) for p, m in zip(prompts, news)]])
        turns.append(f"{label} {r['tok_s']:.2f} tok/s, decode step "
                     f"{r['step_ms']:.2f} ms")
        del eng
        _release_card()
    print(f"yi-9b pools in turns ({L} of {full.num_layers} layers): "
          + "; ".join(turns) + f" | {card}")
    # the same requests host-ahead, then the profile, as for bf16 pools
    fast = Engine(full, params, dataclasses.replace(ecfg, kv_quant=kvq,
                                                    step_timing=False))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p, m in zip(prompts, news):
        fast.add_request(p, m)
    fast.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"yi-9b int8: host-ahead run (no per-call synchronize) {sum(news)} "
          f"tokens in {wall:.3f} s = {sum(news) / wall:.2f} tok/s | {card}")
    where_time_goes(card, fast, prompts[:8], news[:8])
    where_time_goes(card, fast, prompts, news, warm=18,
                    label="decode with the two long contexts")
    del fast
    _release_card()

    hd = cfg.resolved_head_dim
    n_bf16 = 80
    n_int8 = n_bf16 * (2 * hd * 2) // (2 * (hd + 4))
    waves = [[(p, m, 1) for p, m in zip(prompts[:8], news[:8])],
             [(p, m, 0) for p, m in zip(prompts[8:], news[8:])]]
    budget = {}
    for label, n, q in (("bf16", n_bf16, None), ("int8", n_int8, kvq)):
        eng = Engine(cfg, params, dataclasses.replace(
            ecfg, num_blocks=n, max_slots=16, kv_quant=q,
            oversub=OversubConfig()))
        r = budget[label] = _timed_run(card, eng, f"yi-9b budget {label}",
                                       waves)
        key = "paged_attention" if q is None else "paged_attention_int8"
        want = _launch_want(**{key: r["steps"] * L})
        check(r["launches"] == want,
              f"yi-9b budget {label}: launches {r['launches']} != {want}")
        del eng
        _release_card()
    check(budget["bf16"]["preemptions"] > 0,
          "fixed-budget bf16 run did not preempt")
    print(f"yi-9b fixed pool budget ({n_bf16} bf16 blocks = {n_int8} int8 "
          f"blocks; {L} of {full.num_layers} layers): peak resident "
          f"sequences bf16 "
          f"{budget['bf16']['resident']}, int8 {budget['int8']['resident']}; "
          f"preemptions bf16 {budget['bf16']['preemptions']}, int8 "
          f"{budget['int8']['preemptions']} | {card}")


def _release_card():
    """Free the device memory of engines no longer referenced: an Engine
    sits in a reference cycle (its block pool's eviction hook points back
    at it), so its pools and weights wait for the cyclic collector."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def gemma3_main_phase(card, rows):
    """gemma3-12b at full depth and width (48 layers: 8 superblocks of 5
    ring-KV local layers and 1 paged global layer; bf16, seeded random
    weights) through the port's Engine, served three times: without
    speculation, with SpecConfig(k=4) and the n-gram drafter, and with a
    ReplayDrafter that remembers the first run's outputs; then with int8
    pools (kv_quant), without speculation (B1 + B2 int8) and with the
    n-gram drafter (B4 + B5 int8). Traffic: the mixed requests plus prompts
    of 1500 and 2000 tokens, which wrap the 1040-slot ring during prefill
    and decode past the wrap."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import state_providers as SP
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import (Engine, EngineConfig,
                                            KVQuantConfig, ReplayDrafter,
                                            SpecConfig)
    from repro_torch.serving.workloads import mixed_workload
    _release_card()
    cfg = get_config("gemma3-12b")
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"gemma3: weights ({cfg.param_count() / 1e9:.2f} B params, "
          f"{cfg.num_layers} layers, bf16) made on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    kinds = SP.state_kinds(cfg)
    n_sb, _ = SP.superblock_layout(cfg)
    n_full, n_ring = n_sb * kinds.count("full"), n_sb * kinds.count("ring")
    prompts, news = mixed_workload(n=8, seed=0, vocab=cfg.vocab_size)
    rng = np.random.default_rng(2)
    for n in (1500, 2000):
        prompts.append(rng.integers(0, cfg.vocab_size, size=n)
                       .astype(np.int32))
        news.append(32)
    base = dict(block_size=16, num_blocks=1024, max_blocks_per_seq=128,
                max_slots=8, prefill_chunk=256)
    replay = ReplayDrafter()
    outs = {}
    counts = {}
    for label, spec in (("plain", None), ("ngram", SpecConfig(k=4)),
                        ("replay", SpecConfig(k=4, drafter=replay))):
        eng = Engine(cfg, params, EngineConfig(**base, spec=spec,
                                               step_timing=True))
        bad = []

        def watch(fn, logits_at):
            def wrapped(*a):
                out = fn(*a)
                bad.append(~torch.isfinite(out[logits_at]).all())
                return out
            return wrapped
        eng._decode = watch(eng._decode, 1)
        eng._prefill = watch(eng._prefill, 1)
        if eng._verify is not None:
            eng._verify = watch(eng._verify, 2)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        def run(eng=eng):
            got = eng.drain()
            torch.cuda.synchronize()
            return got, time.perf_counter()
        t0 = time.perf_counter()
        rids = [eng.add_request(p, m) for p, m in zip(prompts, news)]
        (got, t1), n = _counted(eng, run)
        wall = t1 - t0       # the trace's post-processing left out
        check(all(r in got and len(got[r]) == m for r, m in zip(rids, news)),
              f"gemma3 {label}: not every request finished with its max_new "
              f"tokens")
        check(not bool(torch.stack(bad).any()), f"gemma3 {label}: "
              f"non-finite logits")
        check(eng.block_pool.num_free == base["num_blocks"],
              f"gemma3 {label}: blocks leaked")
        check(all(0 <= t < cfg.vocab_size for r in rids for t in got[r]),
              f"gemma3 {label}: token out of vocab range")
        steps = eng.stats["decode_steps"]
        want = (_launch_want(paged_attention=n_full * steps,
                             paged_ring=n_ring * steps)
                if spec is None else
                _launch_want(paged_verify=n_full * steps,
                             paged_ring_verify=n_ring * steps))
        check(n == want, f"gemma3 {label}: launches {n} != {want}")
        counts[label] = n
        outs[label] = [got[r].tolist() for r in rids]
        if label == "plain":
            for r, p in zip(rids, prompts):
                replay.remember(r, np.concatenate([p, got[r]]))
            # what the n-gram drafter will see: streams that repeat one
            # token are drafted right by its repeat-the-last-token fallback
            flat = sum(len(set(got[r].tolist())) == 1 for r in rids)
            echo = sum(bool((got[r] == p[-1]).all())
                       for r, p in zip(rids, prompts))
            print(f"gemma3 plain: {flat}/{len(rids)} requests emit a single "
                  f"repeated token, {echo} of them their prompt's last token")

        generated = sum(len(got[r]) for r in rids)
        tls = [eng.telemetry.request_timeline(r) for r in rids]
        ttft = [tl["ttft"] for tl in tls]
        tpot = [(tl["finish"] - tl["first_token"]) / (len(got[r]) - 1)
                for r, tl in zip(rids, tls) if len(got[r]) > 1]
        host = [s["host_s"] for s in eng.telemetry.steps]
        dev = [s["device_s"] for s in eng.telemetry.steps]
        peak = torch.cuda.max_memory_allocated() / 2**30
        reg = eng.telemetry.registry
        accept = ""
        if spec is not None:
            drafted = reg.get("engine_draft_tokens_total").value
            accepted = reg.get("engine_accepted_tokens_total").value
            accept = (f"; acceptance {accepted}/{drafted} = "
                      f"{accepted / max(drafted, 1):.4f}")
        print(f"gemma3 {label}: {len(rids)} requests, {generated} tokens in "
              f"{wall:.3f} s = {generated / wall:.2f} tok/s (each device call "
              f"synchronized); decode steps {steps}, prefill chunks "
              f"{eng.stats['prefill_chunks']}{accept} | {card}")
        print(f"gemma3 {label}: TTFT p50 {np.percentile(ttft, 50) * 1e3:.2f} "
              f"ms p99 {np.percentile(ttft, 99) * 1e3:.2f} ms; TPOT p50 "
              f"{np.percentile(tpot, 50) * 1e3:.2f} ms p99 "
              f"{np.percentile(tpot, 99) * 1e3:.2f} ms; per step host "
              f"{np.median(host) * 1e3:.2f} ms / device "
              f"{np.median(dev) * 1e3:.2f} ms (median of {len(host)}); peak "
              f"memory {peak:.2f} GiB | {card}")
        print(f"gemma3 {label}: launches {n} = {n_full} full + {n_ring} ring "
              f"layers x {steps} steps")
        del eng
        _release_card()

    for label in ("ngram", "replay"):
        same, first = 0, []
        for a, b in zip(outs["plain"], outs[label]):
            diff = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
            same += not diff
            first.append(diff[0] if diff else None)
        print(f"gemma3 {label} vs plain: {same}/{len(first)} requests match "
              f"end to end; first divergent position per request {first} "
              f"(reported, not gated: bf16 K-row verify and one-row decode "
              f"round differently)")
    by_name = {r["name"]: r for r in rows}
    by_name["paged_ring"]["launches"] = counts["plain"]["paged_ring"]
    by_name["paged_verify"]["launches"] = counts["ngram"]["paged_verify"]
    by_name["paged_ring_verify"]["launches"] = (
        counts["ngram"]["paged_ring_verify"])

    # int8 pools: B1 + B2 int8 without speculation, B4 + B5 int8 with the
    # n-gram drafter
    kvq = KVQuantConfig()
    for label, spec in (("int8", None), ("int8 ngram", SpecConfig(k=4))):
        eng = Engine(cfg, params, EngineConfig(**base, spec=spec,
                                               kv_quant=kvq,
                                               step_timing=True))
        r = _timed_run(card, eng, f"gemma3 {label}",
                       [[(p, m, 0) for p, m in zip(prompts, news)]])
        steps = r["steps"]
        want = (_launch_want(paged_attention_int8=n_full * steps,
                             paged_ring_int8=n_ring * steps)
                if spec is None else
                _launch_want(paged_verify_int8=n_full * steps,
                             paged_ring_verify_int8=n_ring * steps))
        check(r["launches"] == want,
              f"gemma3 {label}: launches {r['launches']} != {want}")
        print(f"gemma3 {label}: launches {r['launches']} = {n_full} full + "
              f"{n_ring} ring layers x {steps} steps")
        _match_share(f"gemma3 {label} vs bf16 "
                     f"{'ngram' if spec else 'plain'}",
                     outs["ngram" if spec else "plain"], r["outs"])
        counts[label] = r["launches"]
        del eng
        _release_card()
    by_name["paged_ring_int8"]["launches"] = counts["int8"]["paged_ring_int8"]
    by_name["paged_verify_int8"]["launches"] = (
        counts["int8 ngram"]["paged_verify_int8"])
    by_name["paged_ring_verify_int8"]["launches"] = (
        counts["int8 ngram"]["paged_ring_verify_int8"])

    # host-ahead plain run (no per-call synchronize), then the profile
    fast = Engine(cfg, params, EngineConfig(**base))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p, m in zip(prompts, news):
        fast.add_request(p, m)
    fast.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    generated = sum(news)
    print(f"gemma3 plain host-ahead run (no per-call synchronize): "
          f"{generated} tokens in {wall:.3f} s = {generated / wall:.2f} "
          f"tok/s | {card}")
    where_time_goes(card, fast, prompts[:8], news[:8])


# ------------------------- phase 3g: paged kernels at zamba2's and mixtral's
ZAMBA2_LAYOUT = (32, 32, 80)        # zamba2-2.7b's shared attention
MIXTRAL_LAYOUT = (32, 8, 128)       # mixtral-8x7b's attention
MIXTRAL_WINDOW = 4096
# ring lengths before, at and past the wrap (R·bs = 4112 for the decode,
# 4128 for the k = 4 verify), the engine's 4200-token prompt with its 32
# new tokens, and three times round the ring
MIXTRAL_LENS = (4, 512, 2048, 4095, 4096, 4129, 4232, 12295)


def _layout_rows(card, shape, layout, window, lens, seed, replaces,
                 timed=True):
    """One-query decode (B1, or B2 on a ring of `window`) and the k = 4
    verify (B4, or B5) at one model's head layout, bf16 and int8 pools,
    held against the plain version (f32 2e-5, bf16 2e-2 by max_abs_err,
    and DECODE_ROW_TOL by row error), then, if `timed`, timed beside SDPA
    and the bound: B = 8 slots, block 16, the given lengths. Returns the
    four rows (bf16 decode, verify; int8 decode, verify) keyed by launch
    count key (none untimed); the int8 rows are variants of the bf16
    ones."""
    import torch
    from repro_torch.kernels.paged_attention import (
        paged_attention, paged_attention_ref, paged_attention_verify,
        paged_attention_verify_ref)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    tol = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
    H, Hkv, hd = layout
    B, bs, K = len(lens), 16, 4
    lens = list(lens)
    rows = {}
    for key, n_q in (("paged_ring" if window else "paged_attention", 0),
                     ("paged_ring_verify" if window else "paged_verify", K)):
        kern, plain = ((paged_attention, paged_attention_ref) if n_q == 0
                       else (paged_attention_verify,
                             paged_attention_verify_ref))
        if window:
            R = _ring_pages(window, bs, max(n_q - 1, 0))
            ring, P = (window, R), R + 2
        else:
            ring, P = None, 128
        for quant in (False, True):
            errs = {}
            for dt in (torch.float32, torch.bfloat16):
                args, kw = _multi_inputs(gen, B, n_q, H, Hkv, hd, B * P + 1,
                                         bs, P, dt, lens, ring)
                if quant:
                    args, kw = _quantized(args, kw)
                out, ref = kern(*args, **kw), plain(*args, **kw)
                torch.cuda.synchronize()
                errs[dt] = (out.float() - ref.float()).abs().max().item()
                check(math.isfinite(errs[dt]) and errs[dt] <= tol[dt],
                      f"{key} @ {shape} {dt} int8={quant}: max_abs_err "
                      f"{errs[dt]} > {tol[dt]}")
            k = key + "_int8" if quant else key
            if not timed:
                row_err = _row_error(out, ref)
                check(row_err <= DECODE_ROW_TOL,
                      f"{k} @ {shape} bf16: row error {row_err} > "
                      f"{DECODE_ROW_TOL}")
                print(f"{k} @ {shape} (H {H}, Hkv {Hkv}, hd {hd}): "
                      f"max_abs_err f32 {errs[torch.float32]:.3e} bf16 "
                      f"{errs[torch.bfloat16]:.3e}, bf16 row error "
                      f"{row_err:.3e}")
                continue
            rows[k] = _time_multi(card, k, n_q, args, kw, errs, window,
                                  shape=shape, row_name=f"{k} @ {shape}",
                                  row_replaces=None if quant
                                  else replaces[n_q > 0])
    return rows


def zamba2_kernel_phase(card):
    """B1 (one-query decode) and B4 (k = 4 verify) at zamba2-2.7b's shared
    attention layout (32/32 heads, hd 80: the first model path that runs
    the tensor-core decode at width 80), bf16 and int8 pools, against the
    plain version, then timed (as B1 at yi-9b's shape: 128-page tables,
    lengths over 4..2048). Returns the rows, for the kernels line."""
    lens = [int(x) for x in np.linspace(4, 16 * 128, 8)]
    rows = _layout_rows(card, "zamba2-2.7b", ZAMBA2_LAYOUT, None, lens, 3,
                        ("src/repro/kernels/paged_attention/kernel.py:52",
                         "src/repro/kernels/paged_attention/kernel.py:101"))
    return list(rows.values())


def mixtral_kernel_phase(card):
    """B2 (ring decode) and B5 (k = 4 ring verify) at mixtral-8x7b's layout
    (32/8 heads, hd 128) on its 4096-token window, bf16 and int8 pools,
    with lengths before, at and past the ring's wrap (MIXTRAL_LENS: each
    live span is cut into several splits and merged), against the plain
    version, then timed. Returns the rows, for the kernels line; the
    mixtral serving phase sets their launches."""
    rows = _layout_rows(card, "mixtral-8x7b", MIXTRAL_LAYOUT, MIXTRAL_WINDOW,
                        MIXTRAL_LENS, 4,
                        ("src/repro/kernels/paged_attention/kernel.py:238",
                         "src/repro/kernels/paged_attention/kernel.py:167"))
    return list(rows.values())


# ------------------------------------------- phase 4f: serving parity (A7, A9)
def _no_launches(label):
    from repro_torch import kernels
    check(not any(kernels.launch_counts.values()),
          f"{label}: the dense path launched kernels "
          f"{dict(kernels.launch_counts)}")


def serve_parity_phase(card):
    """Reduced f32 configs, TF32 off, cuda against cpu from the same
    weights. yi-9b: cuda generate == cpu generate (batched prefill, also on
    int8 caches) == the cuda engine (int8 pools for the int8 caches); a
    sampled request == on the cpu engine, == generate with the same seed,
    and == itself forcibly preempted after 3 decode steps and under
    SpecConfig(k=4) (run unspeculated: no drafted token). rwkv6-7b and
    zamba2-2.7b: cuda engine tokens == cpu engine tokens == cpu generate,
    cuda n-gram speculation == plain, every request forcibly preempted once
    == plain (snapshot resume for rwkv6: after the resume the prefill covers
    the pending token only; zamba2 re-prefills)."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models import state_providers as SP
    from repro_torch.models import transformer as T
    from repro_torch.serving import serve
    from repro_torch.serving.engine import (Engine, EngineConfig,
                                            KVQuantConfig, OversubConfig,
                                            SpecConfig)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ek = dict(block_size=4, num_blocks=64, max_blocks_per_seq=12,
              max_slots=3, prefill_chunk=16)
    slo_off = OversubConfig(ttft_slo_s=1e9, tpot_slo_s=1e9)
    rng = np.random.default_rng(21)

    cfg = dataclasses.replace(reduced(get_config("yi-9b")), dtype="float32")
    params = T.init_params(cfg, seed=0, device="cpu")
    dev_params = {"cpu": params, "cuda": _tree_to(params, "cuda")}
    batch = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    for kvq in (None, KVQuantConfig()):
        got = {}
        for dev in ("cpu", "cuda"):
            kernels.reset_launch_counts()
            got[dev] = serve.generate(cfg, dev_params[dev], batch, 16,
                                      kv_quant=kvq).cpu().tolist()
            _no_launches(f"generate {dev}")
        eng_out = serve.engine_generate(
            cfg, dev_params["cuda"], list(batch), [16, 16],
            engine_cfg=EngineConfig(**ek, kv_quant=kvq), device="cuda")
        check(got["cuda"] == got["cpu"] == [o.tolist() for o in eng_out],
              f"generate kv_quant={kvq}: cuda {got['cuda']} / cpu "
              f"{got['cpu']} / cuda engine {eng_out}")
    print(f"parity generate (reduced f32 yi-9b, 2 x 24-token prompts, 16 "
          f"new): cuda == cpu == cuda engine_generate, f32 and int8 caches "
          f"(tf32 off); no kernel launch on the dense path | {card}")

    # sampling: host Gumbel-max from the request's generator
    prompt = rng.integers(0, cfg.vocab_size, 13).astype(np.int32)
    greedy_p = rng.integers(0, cfg.vocab_size, 9).astype(np.int32)

    def sampled(dev, preempt=False, spec=None):
        eng = Engine(cfg, dev_params[dev], EngineConfig(
            **ek, oversub=slo_off, spec=spec), device=dev)
        rid = eng.add_request(prompt, 12, temperature=0.8,
                              generator=torch.Generator().manual_seed(42))
        other = eng.add_request(greedy_p, 12)
        steps = 0
        while eng.scheduler.has_work:
            eng.step()
            if eng.requests[rid].state == "decoding":
                steps += 1
                if preempt and steps == 3:     # after 3 decode steps
                    check(eng.preempt_request(rid), "preempt refused")
        got = eng.drain()
        check(eng.stats["resumes"] == int(preempt),
              f"sampled: resumes {eng.stats['resumes']}")
        drafted = eng.telemetry.request_timeline(rid)["draft_tokens"]
        check(drafted == 0, f"sampled request drafted {drafted} tokens")
        return got[rid].tolist(), got[other].tolist()
    base = sampled("cuda")
    want = serve.generate(cfg, dev_params["cpu"], prompt[None], 12,
                          temperature=0.8,
                          generator=torch.Generator().manual_seed(42))
    for label, out in (("cpu engine", sampled("cpu")),
                       ("forced preemption", sampled("cuda", preempt=True)),
                       ("spec k=4", sampled("cuda", spec=SpecConfig(k=4)))):
        check(out == base, f"sampled {label}: {out} != {base}")
    check(base[0] == want[0].tolist(),
          f"sampled engine {base[0]} != cpu generate {want[0].tolist()}")
    print(f"parity temperature 0.8 (reduced f32 yi-9b): the cuda engine's "
          f"sampled tokens == the cpu engine's == cpu generate's (same "
          f"seed) == forcibly preempted after 3 decode steps == under "
          f"SpecConfig(k=4) (0 drafted tokens) | {card}")

    for arch in ("rwkv6-7b", "zamba2-2.7b"):
        cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
        params = T.init_params(cfg, seed=0, device="cpu")
        dp = {"cpu": params, "cuda": _tree_to(params, "cuda")}
        lens, news = (5, 23, 9, 17), (8, 6, 10, 7)
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                   for n in lens]
        n_sb, _ = SP.superblock_layout(cfg)
        n_attn = n_sb * SP.state_kinds(cfg).count("full")
        outs = {}
        for dev, mode in (("cpu", "plain"), ("cuda", "plain"),
                          ("cuda", "spec"), ("cuda", "preempt")):
            eng = Engine(cfg, dp[dev], EngineConfig(
                **ek, spec=SpecConfig(k=4) if mode == "spec" else None,
                oversub=slo_off if mode == "preempt" else None), device=dev)
            rids = [eng.add_request(p, m) for p, m in zip(prompts, news)]
            pending = set(rids) if mode == "preempt" else set()

            def run(eng=eng, pending=pending):
                while eng.scheduler.has_work:
                    eng.step()
                    for r in sorted(pending):
                        req = eng.requests[r]
                        if (req.state == "decoding"
                                and len(req.out_tokens) >= 2):
                            check(eng.preempt_request(r),
                                  f"preempt {r} refused")
                            pending.discard(r)
                return eng.drain()
            got, n = _counted(eng, run)
            outs[dev, mode] = [got[r].tolist() for r in rids]
            check(eng.block_pool.num_free == ek["num_blocks"],
                  f"{arch} {dev} {mode}: blocks leaked")
            if mode == "preempt":
                check(not pending and eng.stats["resumes"] == len(rids),
                      f"{arch}: not every request preempted and resumed")
                for r in rids:
                    after = _prefill_after_resume(eng, r)
                    check((after == 1) == (arch == "rwkv6-7b"),
                          f"{arch} request {r}: {after} tokens prefilled "
                          f"after its resume")
            steps = eng.stats["decode_steps"] if dev == "cuda" else 0
            key = "paged_verify" if mode == "spec" else "paged_attention"
            want = _launch_want(**{key: n_attn * steps})
            check(n == want,
                  f"{arch} {dev} {mode}: launches {n} != {want}")
        ref = [serve.generate(cfg, params, p[None], m)[0].tolist()
               for p, m in zip(prompts, news)]
        check(all(outs[k] == ref for k in outs),
              f"{arch}: tokens differ: {outs} vs cpu generate {ref}")
        print(f"parity {arch} (reduced f32): cuda engine == cpu engine == "
              f"cpu generate, cuda n-gram spec k=4 == plain, every request "
              f"preempted once == plain ("
              f"{'snapshot resume' if arch == 'rwkv6-7b' else 're-prefill'}"
              f"); B1/B4 once per attention layer a step | {card}")


def _prefill_after_resume(eng, rid):
    """Prompt tokens a request prefilled after its (last) resume event."""
    n = None
    for ev in eng.telemetry.request_timeline(rid)["events"]:
        if ev.name == "resume":
            n = 0
        elif ev.name == "prefill_chunk" and n is not None:
            n += ev.data["tokens"]
    return n


# --------------------------- phase 5f: generate, temperature, draft model
def _watch_dense_logits(flags):
    """Wrap the dense steps so every logits tensor is checked for NaN (no
    host read until the end); returns the restore function."""
    import torch
    from repro_torch.models import transformer as T
    saved = T.prefill_step, T.decode_step

    def wrap(fn):
        def run(*a, **k):
            out = fn(*a, **k)
            flags.append(torch.isnan(out[0]).any())
            return out
        return run
    T.prefill_step, T.decode_step = map(wrap, saved)

    def restore():
        T.prefill_step, T.decode_step = saved
    return restore


def yi9b_serve_phase(card, params, ecfg, prompts, news):
    """yi-9b at full width (48 layers, bf16) beyond greedy engine serving:
    serve.generate on two 512-token prompts (32 new tokens, batched prefill,
    the dense cache: no kernel launch), its tokens beside the engine's;
    then 4 requests at temperature 0.8 (each its own seeded generator) and
    4 greedy ones through the engine, again with the first sampled request
    forcibly preempted after 3 decode steps, and under SpecConfig(k=4)
    (sampled requests draft nothing); then SpecConfig(k=4) with a
    draft-model drafter (yi-9b's width, 2 layers, seed 1) on 2 requests of
    16 new tokens, its acceptance. The bf16 runs' tokens are compared
    with each other and reported (bf16 prefill, decode and K-row verify
    round differently); token equality is gated in f32 (serve_parity_phase,
    f32_width_phase)."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving import serve
    from repro_torch.serving.engine import (DraftModelDrafter, Engine,
                                            OversubConfig, SpecConfig)
    _release_card()
    cfg = get_config("yi-9b")
    rng = np.random.default_rng(31)
    long = rng.integers(0, cfg.vocab_size, (2, 512)).astype(np.int32)
    flags = []
    restore = _watch_dense_logits(flags)
    try:
        serve.generate(cfg, params, long[:, :16], 2)           # warm-up
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        toks = serve.generate(cfg, params, long, 32, prefill_mode="batched")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        restore()
    _no_launches("yi-9b generate")
    check(not bool(torch.stack(flags).any()), "yi-9b generate: NaN logits")
    toks = toks.cpu().numpy()
    check(toks.shape == (2, 32) and ((0 <= toks) & (toks < cfg.vocab_size))
          .all(), "yi-9b generate: tokens out of the vocabulary")
    t_pre = time.perf_counter()
    serve.generate(cfg, params, long, 1, prefill_mode="batched")
    torch.cuda.synchronize()
    pre = time.perf_counter() - t_pre
    eng = Engine(cfg, params, ecfg)
    rids = [eng.add_request(p, 32) for p in long]
    got = eng.drain()
    print(f"yi-9b generate: 2 x 512-token prompts, 32 new tokens each, "
          f"batched prefill: {wall:.3f} s = {64 / wall:.2f} tok/s; prefill + "
          f"1 token {pre * 1e3:.1f} ms, per decode step (both rows) "
          f"{(wall - pre) / 31 * 1e3:.2f} ms; no kernel launch (dense "
          f"cache) | {card}")
    _match_share("yi-9b generate vs the engine", toks.tolist(),
                 [got[r].tolist() for r in rids], against="the engine's",
                 why="the dense and paged bf16 paths round differently")
    del eng
    _release_card()

    # temperature: 4 sampled + 4 greedy requests
    reqs = list(zip(prompts[:8], [min(m, 16) for m in news[:8]]))

    def run(label, preempt=False, spec=None):
        eng = Engine(cfg, params, dataclasses.replace(
            ecfg, spec=spec, oversub=OversubConfig(
                ttft_slo_s=1e9, tpot_slo_s=1e9) if preempt else None))
        rids = [eng.add_request(p, m, temperature=0.8 if i < 4 else 0.0,
                                generator=torch.Generator().manual_seed(i)
                                if i < 4 else None)
                for i, (p, m) in enumerate(reqs)]
        t0, steps = time.perf_counter(), 0
        while eng.scheduler.has_work:
            eng.step()
            if eng.requests[rids[0]].state == "decoding":
                steps += 1
                if preempt and steps == 3:
                    check(eng.preempt_request(rids[0]), "preempt refused")
        got = eng.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(all(len(got[r]) == m for r, (_, m) in zip(rids, reqs)),
              f"yi-9b temperature {label}: a request fell short of its "
              f"budget")
        check(all(0 <= t < cfg.vocab_size for r in rids for t in got[r]),
              f"yi-9b temperature {label}: token out of the vocabulary")
        check(eng.block_pool.num_free == ecfg.num_blocks,
              f"yi-9b temperature {label}: blocks leaked")
        check(eng.stats["resumes"] == int(preempt),
              f"yi-9b temperature {label}: resumes {eng.stats['resumes']}")
        drafted = [eng.telemetry.request_timeline(r)["draft_tokens"]
                   for r in rids]
        check(not any(drafted[:4]),
              f"yi-9b temperature {label}: sampled requests drafted "
              f"{drafted[:4]}")
        n = sum(m for _, m in reqs)
        print(f"yi-9b temperature {label}: 4 sampled (T 0.8) + 4 greedy "
              f"requests, {n} tokens in {wall:.3f} s = {n / wall:.2f} tok/s; "
              f"decode steps {eng.stats['decode_steps']}; drafted per request "
              f"{drafted} | {card}")
        out = [got[r].tolist() for r in rids]
        del eng
        _release_card()
        return out
    base = run("plain")
    distinct = len({tuple(o) for o in base[:4]})
    why = "bf16 prefill, decode and verify round differently"
    _match_share("yi-9b temperature forced preemption vs plain", base,
                 run("preempted", preempt=True), against="the plain run's",
                 why=why)
    _match_share("yi-9b temperature spec k=4 vs plain", base,
                 run("spec k=4", spec=SpecConfig(k=4)),
                 against="the plain run's", why=why)
    print(f"yi-9b temperature: {distinct} distinct sampled streams of 4")

    # draft-model speculation
    dcfg = dataclasses.replace(cfg, num_layers=2)
    dparams = T.init_params(dcfg, seed=1, device="cuda")
    two = [(p, 16) for p in prompts[:2]]
    outs = {}
    for label, spec in (("plain", None), ("draft model", SpecConfig(
            k=4, drafter=DraftModelDrafter(dcfg, dparams)))):
        eng = Engine(cfg, params, dataclasses.replace(ecfg, spec=spec))
        r = _timed_run(card, eng, f"yi-9b {label}", [[(p, m, 0)
                                                       for p, m in two]])
        outs[label] = r["outs"]
        if spec is None:
            want = _launch_want(paged_attention=r["steps"] * cfg.num_layers)
            check(r["launches"] == want,
                  f"yi-9b plain: launches {r['launches']} != {want}")
        else:
            reg = eng.telemetry.registry
            drafted = reg.get("engine_draft_tokens_total").value
            accepted = reg.get("engine_accepted_tokens_total").value
            want = _launch_want(paged_verify=r["steps"] * cfg.num_layers)
            check(r["launches"] == want,
                  f"yi-9b draft model: launches {r['launches']} != {want}")
            print(f"yi-9b draft model (2-layer yi-9b width, seed 1): "
                  f"acceptance {accepted}/{drafted} = "
                  f"{accepted / max(drafted, 1):.1%} over {r['steps']} verify "
                  f"steps | {card}")
        del eng
        _release_card()
    _match_share("yi-9b draft-model spec vs plain", outs["plain"],
                 outs["draft model"], against="the plain run's",
                 why="bf16 K-row verify and one-row decode round differently")
    del dparams
    _release_card()


F32_WIDTH_LAYERS = 2    # of yi-9b's 48: full width in f32 (3.5 GB)


def f32_width_phase(card):
    """yi-9b at full width in f32 (2 of 48 layers, TF32 off): the token
    equality that bf16 cannot show. A sampled request (T 0.8, seeded
    generator) beside a greedy one: forcibly preempted after 3 decode steps
    == not preempted == under SpecConfig(k=4) (0 drafted tokens); then
    draft-model speculation with the target itself as the drafter
    (acceptance near 1, the multi-token accept path) and with a 1-layer
    seed-1 draft: tokens == plain greedy."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import (DraftModelDrafter, Engine,
                                            EngineConfig, OversubConfig,
                                            SpecConfig)
    _release_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config("yi-9b"), num_layers=F32_WIDTH_LAYERS,
                              dtype="float32")
    params = T.init_params(cfg, seed=0, device="cuda")
    ek = dict(block_size=16, num_blocks=64, max_blocks_per_seq=16,
              max_slots=4, prefill_chunk=64)
    rng = np.random.default_rng(41)
    sp, gp = (rng.integers(0, cfg.vocab_size, n).astype(np.int32)
              for n in (70, 33))
    outs = {}
    for label, preempt, spec in (("plain", False, None),
                                 ("preempted", True, None),
                                 ("spec k=4", False, SpecConfig(k=4))):
        eng = Engine(cfg, params, EngineConfig(**ek, spec=spec,
                                               oversub=OversubConfig(
                                                   ttft_slo_s=1e9,
                                                   tpot_slo_s=1e9)))
        rid = eng.add_request(sp, 16, temperature=0.8,
                              generator=torch.Generator().manual_seed(42))
        other = eng.add_request(gp, 16)
        steps = 0
        while eng.scheduler.has_work:
            eng.step()
            if eng.requests[rid].state == "decoding":
                steps += 1
                if preempt and steps == 3:
                    check(eng.preempt_request(rid), "preempt refused")
        got = eng.drain()
        check(eng.stats["resumes"] == int(preempt),
              f"f32 yi-9b {label}: resumes {eng.stats['resumes']}")
        check(eng.telemetry.request_timeline(rid)["draft_tokens"] == 0,
              f"f32 yi-9b {label}: the sampled request drafted tokens")
        outs[label] = [got[rid].tolist(), got[other].tolist()]
        del eng
    check(outs["preempted"] == outs["plain"] == outs["spec k=4"],
          f"f32 yi-9b temperature: {outs}")
    print(f"f32 yi-9b ({F32_WIDTH_LAYERS} layers, full width, tf32 off): the "
          f"sampled request's tokens (T 0.8) forcibly preempted after 3 "
          f"decode steps == not preempted == under SpecConfig(k=4), where it "
          f"ran unspeculated | {card}")

    dcfg = dataclasses.replace(cfg, num_layers=1)
    dparams = T.init_params(dcfg, seed=1, device="cuda")
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (40, 57)]
    outs = {}
    for label, drafter in (("plain", None),
                           ("self-draft", DraftModelDrafter(cfg, params)),
                           ("1-layer draft", DraftModelDrafter(dcfg,
                                                               dparams))):
        spec = SpecConfig(k=4, drafter=drafter) if drafter else None
        eng = Engine(cfg, params, EngineConfig(**ek, spec=spec))
        rids = [eng.add_request(p, 16) for p in prompts]
        got = eng.drain()
        outs[label] = [got[r].tolist() for r in rids]
        reg = eng.telemetry.registry
        if drafter is not None:
            d = reg.get("engine_draft_tokens_total").value
            a = reg.get("engine_accepted_tokens_total").value
            print(f"f32 yi-9b {label}: acceptance {a}/{d}, "
                  f"{eng.stats['decode_steps']} verify steps for 2 x 16 "
                  f"tokens")
            if label == "self-draft":
                check(a > d / 2, f"self-draft acceptance {a}/{d}")
        del eng
    check(outs["self-draft"] == outs["plain"] == outs["1-layer draft"],
          f"f32 yi-9b draft-model spec: {outs}")
    print(f"f32 yi-9b: draft-model speculation (the target itself, and a "
          f"1-layer seed-1 draft) == plain greedy tokens | {card}")
    del params, dparams
    _release_card()


# ------------------------------- phase 5g: recurrent families (A9 serving)
# prompts of 32-128 tokens: the recurrent prefill is the decode path's
# token loop, ~80 ms an iteration for rwkv6-7b's 32 layers on an H100, so
# a 256-token prompt alone costs ~20 s a run
RECURRENT_LENS = (32, 48, 64, 80, 96, 112, 128, 128)


RECURRENT_LAYERS = {"rwkv6-7b": 32,      # full depth
                    "zamba2-2.7b": 18}   # 3 of 9 superblocks: the host's
                                         # token loops cost per layer


def recurrent_main_phase(card, arch, kernel_rows=()):
    """rwkv6-7b (32 layers) or zamba2-2.7b (54 = 9 x (5 mamba2 + shared
    attention), hd 80; cut to RECURRENT_LAYERS, for the smoke's time) at
    full width, bf16, seeded random
    weights, through the port's Engine: 8 requests with prompts of 32-128
    tokens (one packed prefill: the recurrent layers' token loop) and 32 new
    tokens, served plainly, with n-gram speculation (k = 4) and under
    oversubscription with the first request forcibly preempted after 3
    decode steps. Every request finishes, logits stay finite, no block
    leaks; rwkv6 resumes from its slab snapshot (after the resume only the
    pending token is prefilled) and launches no kernel; zamba2 re-prefills
    and launches B1 once per shared-attention layer per decode step and B4
    once per layer per verify step. Spec and preempted tokens beside the
    plain run's are reported (bf16; the f32 parity phase gates them).
    zamba2 is also served on int8 pools, plainly and with n-gram
    speculation, with the same requests: B1+B3 and B4+B3 at hd 80 on a
    model path (contexts up to 160 keys, three 64-key stages), once per
    shared-attention layer a step.
    `kernel_rows`: zamba2's B1 / B4 rows (bf16 and int8 pools), whose
    launches these runs set."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import state_providers as SP
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import (Engine, EngineConfig,
                                            KVQuantConfig, OversubConfig,
                                            SpecConfig)
    _release_card()
    cfg = dataclasses.replace(get_config(arch),
                              num_layers=RECURRENT_LAYERS[arch])
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_sb, _ = SP.superblock_layout(cfg)
    n_attn = n_sb * SP.state_kinds(cfg).count("full")
    print(f"{arch}: weights ({cfg.param_count() / 1e9:.2f} B params, "
          f"{cfg.num_layers} layers = {n_sb} superblocks of "
          f"{SP.layer_kinds(cfg)}, bf16) made on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(51)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in RECURRENT_LENS]
    news = [32] * len(prompts)
    ecfg = EngineConfig(block_size=16, num_blocks=160, max_blocks_per_seq=24,
                        max_slots=8, prefill_chunk=256, prefills_per_step=8,
                        step_timing=True)
    wave = [[(p, m, 0) for p, m in zip(prompts, news)]]
    runs = [("plain", ecfg),
            ("ngram k=4", dataclasses.replace(ecfg, spec=SpecConfig(k=4))),
            ("preempted", dataclasses.replace(
                ecfg, oversub=OversubConfig(ttft_slo_s=1e9,
                                            tpot_slo_s=1e9)))]
    if n_attn:
        q8 = dataclasses.replace(ecfg, kv_quant=KVQuantConfig())
        runs += [("int8", q8),
                 ("int8 ngram k=4", dataclasses.replace(
                     q8, spec=SpecConfig(k=4)))]
    res = {}
    for label, e in runs:
        eng = Engine(cfg, params, e)
        state = {"steps": 0}

        def hook(eng, state=state):
            r0 = eng.requests[0]
            if r0.state == "decoding":
                state["steps"] += 1
                if state["steps"] == 3:
                    check(eng.preempt_request(0), "preempt refused")
        r = res[label] = _timed_run(card, eng, f"{arch} {label}", wave,
                                    hook if label == "preempted" else None)
        steps = r["steps"]
        key = ("paged_verify" if "ngram" in label else "paged_attention"
               ) + ("_int8" if "int8" in label else "")
        want = _launch_want(**{key: n_attn * steps})
        check(r["launches"] == want,
              f"{arch} {label}: launches {r['launches']} != {want}")
        if n_attn:
            print(f"{arch} {label}: B{4 if 'ngram' in label else 1}"
                  f"{'+B3' if 'int8' in label else ''} launches "
                  f"{n_attn * steps} = {steps} steps x {n_attn} "
                  f"shared-attention layers")
        if label == "preempted":
            after = _prefill_after_resume(eng, 0)
            check(r["resumes"] == 1, f"{arch}: resumes {r['resumes']} != 1")
            snap = arch == "rwkv6-7b"
            check((after == 1) if snap else (after > RECURRENT_LENS[0]),
                  f"{arch}: {after} tokens prefilled after the resume")
            print(f"{arch} preempted: request 0 resumed by "
                  f"{'its slab snapshot' if snap else 're-prefill'}, "
                  f"{after} tokens prefilled after the resume")
        if label == "plain":
            # the same requests host-ahead, for the profile
            del eng
            _release_card()
            # (prompts cut to 32 tokens: the profiled window is decode)
            fast = Engine(cfg, params, dataclasses.replace(
                ecfg, step_timing=False))
            where_time_goes(card, fast, [p[:32] for p in prompts], news,
                            warm=2)
            del fast
        else:
            del eng
        _release_card()
    for label in ("ngram k=4", "preempted"):
        _match_share(f"{arch} {label} vs plain", res["plain"]["outs"],
                     res[label]["outs"], against="the plain run's",
                     why="bf16 K-row verify, one-row decode and a 1-segment "
                         "prefill round differently")
    by_name = {row["name"]: row for row in kernel_rows}
    if by_name:
        by_name["paged_attention @ zamba2-2.7b"]["launches"] = (
            res["plain"]["launches"]["paged_attention"])
        by_name["paged_verify @ zamba2-2.7b"]["launches"] = (
            res["ngram k=4"]["launches"]["paged_verify"])
        by_name["paged_attention_int8 @ zamba2-2.7b"]["launches"] = (
            res["int8"]["launches"]["paged_attention_int8"])
        by_name["paged_verify_int8 @ zamba2-2.7b"]["launches"] = (
            res["int8 ngram k=4"]["launches"]["paged_verify_int8"])
    del params
    _release_card()


# ------------------------- phase 7: the MoE family (A13), A9's training rest
HYBRID_HD80_TINY = dict(name="hybrid-hd80-tiny", family="hybrid",
                        num_layers=2, d_model=160, num_heads=2,
                        num_kv_heads=2, head_dim=80, d_ff=320,
                        vocab_size=256, ssm_type="mamba2", ssm_state_dim=16,
                        hybrid_ssm_per_attn=1, dtype="float32", remat=False,
                        loss_chunk=64, attn_chunk=32)


def _paged_want(cfg, steps, spec=False, int8=False):
    """Launches of a served config: each full / ring attention layer runs
    its paged kernel (B1 / B2; with speculation B4 / B5; int8 pools +B3)
    once per decode or verify step."""
    from repro_torch.models import state_providers as SP
    n_sb, _ = SP.superblock_layout(cfg)
    kinds = SP.state_kinds(cfg)
    want = {}
    for skind, key in (("full", "paged_verify" if spec else "paged_attention"),
                       ("ring", "paged_ring_verify" if spec
                        else "paged_ring")):
        if kinds.count(skind):
            want[key + ("_int8" if int8 else "")] = (
                n_sb * kinds.count(skind) * steps)
    return _launch_want(**want)


def _train_losses(cfg, params, dev, batches):
    """Losses of 3 Adam steps (lr 3e-4, clip 1.0) from a copy of `params`
    on `dev`, and B6's launches in them."""
    from repro_torch import kernels
    from repro_torch.optim import make_optimizer
    from repro_torch.train.trainer import make_train_step
    from repro_torch.tree import tree_map
    opt = make_optimizer("adam", lr=3e-4, grad_clip=1.0)
    p = tree_map(lambda t: t.clone().to(dev), params)
    state = {"params": p, "opt": opt.init(p)}
    step = make_train_step(cfg, opt)
    kernels.reset_launch_counts()
    losses = []
    for b in batches:
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))
    return losses, kernels.launch_counts["flash_attention"]


def _engine_parity(cfg, dp, modes, ek, prompts, news):
    """Each of `modes` ((label, EngineConfig keywords)) served on cpu and
    on cuda from the same weights (`dp`: {device: params}), staggered:
    tokens equal, each paged kernel once per layer a step on cuda and none
    on cpu, no block leaked."""
    from repro_torch.serving.engine import Engine, EngineConfig
    for label, kw in modes:
        outs = {}
        for dev in ("cpu", "cuda"):
            eng = Engine(cfg, dp[dev], EngineConfig(**ek, **kw), device=dev)
            outs[dev], n = _counted(
                eng, lambda eng=eng: _serve(eng, prompts, news))
            want = (_paged_want(cfg, eng.stats["decode_steps"],
                                spec="spec" in kw, int8="kv_quant" in kw)
                    if dev == "cuda" else _launch_want())
            check(n == want,
                  f"{cfg.name} {label} {dev}: launches {n} != {want}")
            check(eng.block_pool.num_free == ek["num_blocks"],
                  f"{cfg.name} {label} {dev}: blocks leaked")
            del eng
        check(outs["cuda"] == outs["cpu"],
              f"{cfg.name} {label}: cuda tokens {outs['cuda']} != cpu "
              f"{outs['cpu']}")


def moe_parity_phase(card):
    """Reduced f32 configs, TF32 off, cuda against cpu from the same weights
    (an MoE layer's capacity counts the whole padded step, so each path is
    compared with itself on the other device, never across paths).
    mixtral-8x7b (ring layers, window 32) and qwen3-moe-30b-a3b (full):
    engine tokens cuda == cpu, plain, n-gram k = 4 and int8 pools, each
    paged kernel once per layer a step; serve.generate cuda == cpu, batched
    and loop prefill; 3 Adam steps, losses within TRAIN_PARITY_TOL a step
    (B6 on cuda). Then reduced rwkv6-7b and zamba2-2.7b trained likewise,
    and a tiny hybrid at hd 80 (HYBRID_HD80_TINY) served on int8 pools,
    cuda == cpu (B1+B3 and B4+B3 at width 80)."""
    import torch
    from repro_torch.configs import ModelConfig, get_config, reduced
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import transformer as T
    from repro_torch.serving import serve
    from repro_torch.serving.engine import KVQuantConfig, SpecConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ek = dict(block_size=4, num_blocks=64, max_blocks_per_seq=12,
              max_slots=3, prefill_chunk=8)
    rng = np.random.default_rng(33)
    modes = (("plain", {}), ("ngram k=4", dict(spec=SpecConfig(k=4))),
             ("int8", dict(kv_quant=KVQuantConfig())))
    for arch in ("mixtral-8x7b", "qwen3-moe-30b-a3b"):
        cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
        params = T.init_params(cfg, seed=0, device="cpu")
        dp = {"cpu": params, "cuda": _tree_to(params, "cuda")}
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                   for n in (5, 17, 9, 30)]
        news = (8, 6, 10, 12)
        _engine_parity(cfg, dp, modes, ek, prompts, news)
        batch = np.stack([p[:5] for p in prompts])
        for mode in ("batched", "loop"):
            got = {dev: serve.generate(cfg, dp[dev], batch, 8,
                                       prefill_mode=mode).cpu().tolist()
                   for dev in ("cpu", "cuda")}
            check(got["cuda"] == got["cpu"],
                  f"{arch} generate {mode}: cuda {got['cuda']} != cpu "
                  f"{got['cpu']}")
        print(f"parity {arch} (reduced f32, 4 experts top 2): cuda engine "
              f"tokens == cpu, plain / n-gram k=4 / int8 pools, each paged "
              f"kernel once per layer a step; generate cuda == cpu, batched "
              f"and loop (tf32 off) | {card}")
    for arch in ("mixtral-8x7b", "qwen3-moe-30b-a3b", "rwkv6-7b",
                 "zamba2-2.7b"):
        cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32",
                                  remat=True)
        params = T.init_params(cfg, seed=0, device="cpu")
        batches = list(SyntheticLM(cfg.vocab_size, 64, seed=0).batches(2, 3))
        (cpu, n_cpu), (cuda, n) = (_train_losses(cfg, params, dev, batches)
                                   for dev in ("cpu", "cuda"))
        diff = max(abs(a - b) for a, b in zip(cpu, cuda))
        attn = arch != "rwkv6-7b"
        check(all(map(math.isfinite, cuda)) and diff <= TRAIN_PARITY_TOL,
              f"{arch} train parity: cuda {cuda} vs cpu {cpu} (max diff "
              f"{diff} > {TRAIN_PARITY_TOL})")
        check(n_cpu == 0 and (n > 0) == attn,
              f"{arch} train parity: B6 launches cpu {n_cpu} cuda {n}")
        print(f"train parity {cfg.name} (f32, remat, Adam, 3 steps): cuda "
              f"losses {cuda} vs cpu {cpu}, max diff {diff:.3e} (tol "
              f"{TRAIN_PARITY_TOL}), B6 launches {n} | {card}")
    cfg = ModelConfig(**HYBRID_HD80_TINY)
    params = T.init_params(cfg, seed=0, device="cpu")
    dp = {"cpu": params, "cuda": _tree_to(params, "cuda")}
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 14, 9)]
    news = (8, 6, 10)
    _engine_parity(cfg, dp, [(f"int8 {label}",
                              dict(kv_quant=KVQuantConfig(), **kw))
                             for label, kw in modes[:2]], ek, prompts, news)
    print(f"parity {cfg.name} (mamba2 + shared attention at hd 80, f32, "
          f"int8 pools): cuda engine tokens == cpu, plain (B1+B3) and n-gram "
          f"k=4 (B4+B3) | {card}")


MOE_LENS = (64, 128, 192, 256, 320, 384, 448, 512)
MOE_LAYERS = {"qwen3-moe-30b-a3b": 48,     # full depth: 61.1 GB of bf16
              "mixtral-8x7b": 16}          # of 32: all 32 are 93.4 GB
MIXTRAL_LONG = 4200                        # passes the 4096-token window
MOE_PROFILE_STEPS = 2


def _serve_variants(card, arch, cfg, params, ecfg, prompts, news, modes,
                    kernel_rows, compare, why):
    """The requests through the port's Engine once for each of `modes`:
    "plain" (`ecfg`), "ngram k=4" (SpecConfig(k=4)), "int8" (int8 pools)
    and "preempted" (oversubscription, request 0 forcibly preempted after
    3 decode steps; one resume). Each run is a _timed_run (finished
    requests, finite logits, tokens in the vocabulary, no leaked block),
    and the paged kernel of its mode runs once per layer a decode or
    verify step. Rows of `kernel_rows` named "<key> @ <arch>" take the
    launches of the runs other than "preempted" (0 where none). The
    tokens of each mode in `compare` are held to the plain run's,
    reported, not gated (`why`)."""
    from repro_torch.serving.engine import (Engine, KVQuantConfig,
                                            OversubConfig, SpecConfig)
    variants = {
        "plain": ecfg,
        "ngram k=4": dataclasses.replace(ecfg, spec=SpecConfig(k=4)),
        "int8": dataclasses.replace(ecfg, kv_quant=KVQuantConfig()),
        "preempted": dataclasses.replace(ecfg, oversub=OversubConfig(
            ttft_slo_s=1e9, tpot_slo_s=1e9))}
    wave = [[(p, m, 0) for p, m in zip(prompts, news)]]
    res = {}
    for label in modes:
        eng = Engine(cfg, params, variants[label])
        state = {"steps": 0}

        def hook(eng, state=state):
            if eng.requests[0].state == "decoding":
                state["steps"] += 1
                if state["steps"] == 3:
                    check(eng.preempt_request(0), "preempt refused")
        r = res[label] = _timed_run(card, eng, f"{arch} {label}", wave,
                                    hook if label == "preempted" else None)
        want = _paged_want(cfg, r["steps"], spec="ngram" in label,
                           int8=label == "int8")
        check(r["launches"] == want,
              f"{arch} {label}: launches {r['launches']} != {want}")
        (key, n), = ((k, v) for k, v in want.items() if v)
        print(f"{arch} {label}: {key} launches {n} = {r['steps']} steps x "
              f"{cfg.num_layers} layers")
        if label == "preempted":
            check(r["resumes"] == 1, f"{arch}: resumes {r['resumes']} != 1")
        for row in kernel_rows:
            if row["name"] == f"{key} @ {arch}" and label != "preempted":
                row["launches"] = n
        del eng
        _release_card()
    for row in kernel_rows:
        if row["launches"] is None:
            row["launches"] = 0
    for label in compare:
        _match_share(f"{arch} {label} vs plain", res["plain"]["outs"],
                     res[label]["outs"], against="the plain run's", why=why)


def moe_main_phase(card, arch, kernel_rows=()):
    """An MoE model at full width (qwen3-moe-30b-a3b: 48 layers, d 2048,
    32/4 heads, hd 128, 128 experts top 8 of d_ff 768; mixtral-8x7b: d
    4096, 32/8 heads, hd 128, 8 experts top 2 of d_ff 14336, sliding window
    4096, cut to 16 of 32 layers), bf16, seeded random weights made on the
    card, through the port's Engine: 8 requests with prompts of 64-512
    tokens and 32 new (mixtral: plus one 4200-token prompt, which wraps
    the ring during prefill), served plainly, with n-gram speculation (k =
    4), on int8 pools and under oversubscription with request 0 forcibly
    preempted after 3 decode steps. Every request finishes, logits stay
    finite, tokens lie in the vocabulary, no block leaks, and B1 (qwen3) /
    B2 (mixtral) runs once per layer a decode step, B4 / B5 once per layer
    a verify step (+B3 on int8 pools). Agreement of the spec and preempted
    tokens with the plain run's is printed, not gated: capacity follows the
    batch shape, so even the reference does not promise it for MoE. Then
    a profile of the plain decode window with the MoE layer's device time
    split into the expert products and the routing, dispatch and combine.
    `kernel_rows`: mixtral's B2 / B5 rows (bf16 and int8 pools), whose
    launches these runs set (no run here verifies on int8 pools: B5+B3's
    row keeps 0)."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import Engine, EngineConfig
    _release_card()
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=MOE_LAYERS[arch])
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"{arch}: weights ({cfg.param_count() / 1e9:.2f} B params = "
          f"{2 * cfg.param_count() / 1e9:.1f} GB bf16, {cfg.num_layers} of "
          f"{full.num_layers} layers, {cfg.num_experts} experts top "
          f"{cfg.experts_per_token}, {cfg.active_param_count() / 1e9:.2f} B "
          f"active a token) made on the card in "
          f"{time.perf_counter() - t0:.1f} s; decode capacity "
          f"{M.capacity(8, cfg)} slot(s) an expert at 8 slots")
    rng = np.random.default_rng(61)
    lens = MOE_LENS + ((MIXTRAL_LONG,) if arch == "mixtral-8x7b" else ())
    # (mixtral's 9 requests share 8 slots: the last waits for a free one)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    news = [32] * len(prompts)
    long = arch == "mixtral-8x7b"    # ring of ceil((4096 + 3) / 16) + 1 pages
    ecfg = EngineConfig(block_size=16, num_blocks=640 if long else 320,
                        max_blocks_per_seq=272 if long else 40, max_slots=8,
                        prefill_chunk=512, prefills_per_step=8,
                        step_timing=True)
    _serve_variants(card, arch, cfg, params, ecfg, prompts, news,
                    ("plain", "ngram k=4", "int8", "preempted"), kernel_rows,
                    ("ngram k=4", "preempted"),
                    "capacity and bf16 rounding follow the step's batch "
                    "shape")
    fast = Engine(cfg, params, dataclasses.replace(ecfg, step_timing=False))
    # two profiled steps: post-processing the profile of qwen3-moe's
    # ~5,300 device ops a step is most of this phase's time
    where_time_goes(card, fast, [p[:64] for p in prompts[:8]], news[:8],
                    warm=2, window=MOE_PROFILE_STEPS, label=f"{arch} decode")
    del fast, params
    _release_card()


def _is_span(key) -> bool:
    """Whether a profile row is one of the port's own ranges (engine/,
    serve/, moe/, remat/, train/: ``repro_torch.spans.PREFIXES``), which
    the profiler mirrors onto the device timeline as annotations, and not
    a kernel."""
    from repro_torch.spans import PREFIXES
    return key.startswith(PREFIXES)


STEP_PARTS = ("MoE experts forward", "MoE routing+dispatch+combine forward",
              "MoE experts recompute",
              "MoE routing+dispatch+combine recompute",
              "MoE experts backward", "MoE routing+dispatch+combine backward",
              "other forward", "other recompute", "other backward",
              "optimizer")
_EVAL = "autograd::engine::evaluate_function: "


def _step_parts(events, self_time):
    """A training step's time by part, from the profiler's host op tree
    and the program's ranges (``repro_torch.spans``): `self_time(e)` of
    every host op (the device time of the kernels it launched itself) goes
    to the optimizer (inside "train/optimizer"), to a recomputation
    (inside "remat/recompute"), to the backward pass (under an autograd
    node: an MoE part when the node's forward op, matched by thread and
    sequence number, ran inside "moe/apply" in the forward pass) or to the
    forward pass (inside "train/grads", outside any autograd node); an op
    in none of these is left out. An MoE op is an expert product inside
    "moe/experts", else routing, dispatch and combine (inside "moe/apply"
    or "moe/balance": the load-balancing loss's routing included).
    Returns (parts by STEP_PARTS, remat): remat holds the forward pass's
    time inside "remat/forward" (the first pass of every checkpointed
    function) as "first pass" and the recomputation's as "recompute",
    which a checkpoint repeats, so the two should read alike."""
    host = [e for e in events
            if not str(getattr(e, "device_type", "")).endswith("CUDA")]

    def chain(e):
        out = []
        while e is not None:
            out.append(e)
            e = e.cpu_parent
        return out

    def moe_kind(names):
        return ("experts" if "moe/experts" in names else
                "routing+dispatch+combine"
                if names & {"moe/apply", "moe/balance"} else None)
    fwd = {}
    for e in host:
        if e.sequence_nr < 0:
            continue
        names = {a.name for a in chain(e)}
        kind = moe_kind(names)
        if kind and "train/grads" in names and not any(
                n.startswith(_EVAL) for n in names):
            fwd[(e.thread, e.sequence_nr)] = kind
    parts = dict.fromkeys(STEP_PARTS, 0.0)
    remat = {"first pass": 0.0, "recompute": 0.0}
    for e in host:
        t = self_time(e)
        if not t:
            continue
        up = chain(e)
        names = {a.name for a in up}
        kind = moe_kind(names)
        node = next((a for a in up if a.name.startswith(_EVAL)), None)
        if "train/optimizer" in names:
            part = "optimizer"
        elif "remat/recompute" in names:
            part = f"MoE {kind} recompute" if kind else "other recompute"
            remat["recompute"] += t
        elif node is not None:
            kind = fwd.get((node.fwd_thread, node.sequence_nr))
            part = f"MoE {kind} backward" if kind else "other backward"
        elif "train/grads" in names:
            part = f"MoE {kind} forward" if kind else "other forward"
            if "remat/forward" in names:
                remat["first pass"] += t
        else:
            continue
        parts[part] += t
    return parts, remat


# ------------------------------------------ phase 3d: flash attention (B6)
# (B, S, H, Hkv, hd, causal, window): GQA groups 1, 4 and 8, hd 64 / 128 /
# 256, windows 32 and 1024, ragged lengths (not multiples of the 64-row
# query tile or of the key tile), and the mask without its causal half;
# then head dims that the f32 kernel runs in a padded tile (80 as
# stablelm-3b, 8, 136); then head dims that the bf16 kernel runs at the
# next width of its table (16 at 64, 96 and 112 at 128, 200 at 256),
# lengths no tile divides, and windows (40, 48) that cut a 32-key tile
# mid-way
FLASH_SWEEP = [
    (2, 256, 4, 4, 64, True, None),
    (2, 256, 8, 2, 64, True, None),
    (1, 512, 8, 1, 128, True, None),
    (1, 384, 4, 1, 256, True, None),
    (2, 200, 4, 1, 64, True, 32),
    (1, 2048, 8, 1, 128, True, 1024),
    (1, 1100, 4, 2, 256, True, 1024),
    (2, 130, 8, 2, 128, True, None),
    (1, 300, 4, 4, 64, False, None),
    (1, 333, 4, 2, 128, False, 100),
    (2, 256, 4, 4, 80, True, None),
    (1, 300, 8, 2, 80, True, 64),
    (1, 200, 4, 1, 80, False, None),
    (2, 100, 4, 2, 8, True, None),
    (1, 260, 4, 2, 136, True, 100),
    (1, 200, 4, 2, 16, True, None),
    (2, 333, 4, 1, 96, True, None),
    (1, 277, 8, 2, 112, True, 48),
    (1, 300, 4, 4, 200, True, 100),
    (2, 515, 4, 2, 128, True, 40),
]
# forward and backward cases: (B, S, H, Hkv, hd, causal, window)
FLASH_GRAD_CASES = [
    (2, 256, 8, 2, 64, True, None),
    (1, 300, 4, 1, 128, True, 64),
    (1, 640, 8, 1, 128, True, None),
    (1, 256, 4, 4, 80, True, None),
    (1, 200, 4, 2, 80, True, 32),
    (1, 515, 8, 2, 80, True, None),
    (2, 384, 8, 1, 128, True, 100),
]
# the training main paths' attention: yi-9b, batch 2 x 4096; stablelm-3b
# (MHA, hd 80), batch 1 x 2048
FLASH_MAIN = (2, 4096, 32, 4, 128, True, None)
FLASH_HD80 = (1, 2048, 32, 32, 80, True, None)
# bf16: the largest error of a row of hd outputs relative to that row's
# scale, max over rows of rms(out - ref) / rms(ref). Late rows of a long
# causal row average thousands of values (rms ~0.03 at S = 4096), where an
# absolute 2e-2 would pass a kernel that drops a key tile; a sound kernel
# differs by P's rounding (~2^-9 of each p) and one bf16 ulp on either side
B6_ROW_TOL = 1e-2


def _flash_errors(out, lse, ref, ref_lse):
    """B6's forward against its plain version: (max abs error, the
    largest row error relative to the row's scale, max lse error)."""
    return ((out.float() - ref.float()).abs().max().item(),
            _row_error(out, ref), (lse - ref_lse).abs().max().item())


def _admitted_pairs(S, causal, window):
    """(query, key) pairs the mask admits: the work the kernel must do."""
    q = np.arange(S)
    hi = q + 1 if causal else np.full(S, S)
    lo = np.maximum(0, q - window + 1) if window is not None else 0
    return int(np.sum(hi - lo))


def _flash_inputs(gen, B, S, H, Hkv, hd, dtype):
    import torch
    q = torch.randn((B, S, H, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, S, Hkv, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, S, Hkv, hd), generator=gen, device="cuda").to(dtype)
    return q, k, v


def flash_kernel_phase(card):
    """B6 against its plain version on the card: the forward (and its row
    log-sum-exp) over FLASH_SWEEP in f32 and bf16, the autograd.Function's
    dq/dk/dv against autograd through the plain version, then the kernel
    timed at the training main paths' shapes (FLASH_MAIN, FLASH_HD80)
    beside its plain version, SDPA(is_causal=True) as the library
    yardstick, its bound and the backward's time. Returns the two rows of
    the kernels line."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    from repro_torch.kernels.flash_attention.ops import _forward_kernel
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    tol = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for B, S, H, Hkv, hd, causal, window in FLASH_SWEEP:
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = _flash_inputs(gen, B, S, H, Hkv, hd, dt)
            out, lse = _forward_kernel(q, k, v, hd ** -0.5, causal, window)
            ref, ref_lse = flash_attention_ref(q, k, v, causal=causal,
                                               window=window)
            torch.cuda.synchronize()
            err, row, lse_err = _flash_errors(out, lse, ref, ref_lse)
            row_tol = B6_ROW_TOL if dt == torch.bfloat16 else math.inf
            label = (f"B6 B={B} S={S} H={H} Hkv={Hkv} hd={hd} causal={causal} "
                     f"window={window} {dt}")
            # lse: a log of an f32 sum taken in another order, |lse| ~ 10
            check(math.isfinite(err) and err <= tol[dt] and row <= row_tol
                  and lse_err <= 1e-4,
                  f"{label}: max_abs_err {err} (tol {tol[dt]}), row error "
                  f"{row} (tol {row_tol}), lse err {lse_err} (tol 1e-4)")
            worst[dt] = max(worst[dt], err)
            print(f"kernel {label}: max_abs_err {err:.3e}, row {row:.3e}, "
                  f"lse {lse_err:.3e}")
    # gradients: the kernel's forward + the PyTorch backward against
    # autograd through the plain version, tolerance scaled by the largest
    # gradient (f32: 2e-5 x max(1, |g|); bf16: 2e-2 x max(1, |g|), each
    # gradient rounded once to bf16 on both sides)
    for B, S, H, Hkv, hd, causal, window in FLASH_GRAD_CASES:
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = (t.requires_grad_() for t in
                       _flash_inputs(gen, B, S, H, Hkv, hd, dt))
            dout = torch.randn((B, S, H, hd), generator=gen,
                               device="cuda").to(dt)
            out = flash_attention(q, k, v, causal=causal, window=window)
            got = torch.autograd.grad(out, (q, k, v), dout)
            ref, _ = flash_attention_ref(q, k, v, causal=causal,
                                         window=window)
            want = torch.autograd.grad(ref, (q, k, v), dout)
            errs = []
            for name, a, b in zip("qkv", got, want):
                err = (a.float() - b.float()).abs().max().item()
                bound = tol[dt] * max(1.0, b.float().abs().max().item())
                check(math.isfinite(err) and err <= bound,
                      f"B6 grad d{name} S={S} hd={hd} window={window} {dt}: "
                      f"{err} > {bound}")
                errs.append(f"d{name} {err:.3e} (tol {bound:.3e})")
            print(f"kernel B6 backward B={B} S={S} H={H} Hkv={Hkv} hd={hd} "
                  f"window={window} {dt}: " + ", ".join(errs))

    return [_flash_timed(card, gen, FLASH_MAIN, "flash_attention",
                         "yi-9b training shape"),
            _flash_timed(card, gen, FLASH_HD80, "flash_attention_hd80",
                         "stablelm-3b training shape")]


def _flash_timed(card, gen, shape, name, where):
    """B6 in bf16 at one training shape: checked against the plain
    version, timed beside it, SDPA and its bound; one row of the kernels
    line."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    from repro_torch.kernels.flash_attention.ops import (_forward_kernel,
                                                         attention_backward)
    B, S, H, Hkv, hd, causal, window = shape
    q, k, v = _flash_inputs(gen, B, S, H, Hkv, hd, torch.bfloat16)
    with torch.no_grad():
        out, lse = _forward_kernel(q, k, v, hd ** -0.5, causal, window)
        ref, ref_lse = flash_attention_ref(q, k, v, causal=causal,
                                           window=window)
        main_err, row, lse_err = _flash_errors(out, lse, ref, ref_lse)
        check(main_err <= 2e-2 and row <= B6_ROW_TOL and lse_err <= 1e-4,
              f"B6 at the {where}: max_abs_err {main_err} (tol 2e-2), row "
              f"error {row} (tol {B6_ROW_TOL}), lse err {lse_err} (tol 1e-4)")
        del ref, ref_lse
        item = q.element_size()
        pairs = _admitted_pairs(S, causal, window)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * item + lse.numel() * 4
        flops = 4 * hd * pairs * B * H
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS * 1e3
        bound_ms = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        ms = time_ms(lambda: flash_attention(q, k, v), iters=10)
        plain_ms = time_ms(lambda: flash_attention_ref(q, k, v), iters=5,
                           warmup=1)
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                                  enable_gqa=True)
        lib_err = (library().transpose(1, 2).float()
                   - out.float()).abs().max().item()
        library_ms = time_ms(library, iters=10)
        dev_ms = device_ms(lambda: flash_attention(q, k, v), iters=10)
        lib_dev_ms = device_ms(library, iters=10)
        dout = torch.randn_like(q)
        bwd_ms = time_ms(lambda: attention_backward(
            q, k, v, out, lse, dout, scale=hd ** -0.5, causal=causal,
            window=window), iters=3, warmup=1)
    print(f"B6 {name} @ {where}: max_abs_err {main_err:.3e}, row error "
          f"{row:.3e}, lse err {lse_err:.3e}")
    print(f"B6 {name} @ {where} (B={B}, S={S}, H={H}, Hkv={Hkv}, hd={hd}, "
          f"bf16, causal): kernel {ms:.4f} ms ({_tflops(flops, ms)}), plain "
          f"{plain_ms:.4f} ms ({_tflops(flops, plain_ms)}), library "
          f"SDPA(is_causal) {library_ms:.4f} ms "
          f"({_tflops(flops, library_ms)}; err vs kernel {lib_err:.2e}); "
          f"device ms kernel {_ms(dev_ms)}, SDPA {_ms(lib_dev_ms)}; "
          f"bound {bound_ms:.4f} ms by "
          f"{bound_by} ({_tflops(flops, bound_ms)}; {nbytes} B, {flops} "
          f"flop); PyTorch backward {bwd_ms:.4f} ms | {card}")
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:27",
            "launches": None, "max_abs_err": main_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "device_ms": dev_ms, "library_device_ms": lib_dev_ms}


# ------------------------------------------------ phase 4d: training parity
TRAIN_PARITY_TOL = 1e-4    # |loss cuda - loss cpu| per step, losses near 6.3


# a tiny dense MHA model at head dim 80 (stablelm-3b's; reduced() sets 64),
# so B6 runs in its padded tile inside a training step
HD80_TINY = dict(name="hd80-tiny", family="dense", num_layers=2, d_model=160,
                 num_heads=2, num_kv_heads=2, head_dim=80, d_ff=320,
                 vocab_size=256, dtype="float32", remat=False, loss_chunk=64,
                 attn_chunk=32)


def train_parity_phase(card):
    """Reduced f32 yi-9b (remat off), gemma3-12b (local + global, remat
    on) and HD80_TINY trained 3 steps with Adam on cuda and on cpu from the
    same params and the same SyntheticLM batches: the losses agree per step
    within TRAIN_PARITY_TOL (f32 sums in another order on the card; Adam's
    first steps move each weight by about lr·sign(g), so tiny gradient
    differences can show). tf32 off."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import ModelConfig, get_config, reduced
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import transformer as T
    from repro_torch.optim import make_optimizer
    from repro_torch.train.trainer import make_train_step
    from repro_torch.tree import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfgs = [dataclasses.replace(reduced(get_config(arch)), dtype="float32",
                                remat=remat)
            for arch, remat in (("yi-9b", False), ("gemma3-12b", True))]
    for cfg in cfgs + [ModelConfig(**HD80_TINY)]:
        arch, remat = cfg.name, cfg.remat
        params = T.init_params(cfg, seed=0, device="cpu")
        batches = list(SyntheticLM(cfg.vocab_size, 64, seed=0).batches(2, 3))
        losses = {}
        for dev in ("cpu", "cuda"):
            opt = make_optimizer("adam", lr=3e-4, grad_clip=1.0)
            p = tree_map(lambda t: t.clone().to(dev), params)
            state = {"params": p, "opt": opt.init(p)}
            step = make_train_step(cfg, opt)
            kernels.reset_launch_counts()
            losses[dev] = []
            for b in batches:
                state, metrics = step(state, b)
                losses[dev].append(float(metrics["loss"]))
            n = kernels.launch_counts["flash_attention"]
            check(n > 0 if dev == "cuda" else n == 0,
                  f"{arch} train parity on {dev}: flash launches {n}")
        diff = max(abs(a - b) for a, b in zip(losses["cpu"], losses["cuda"]))
        check(all(map(math.isfinite, losses["cuda"]))
              and diff <= TRAIN_PARITY_TOL,
              f"{arch} train parity: cuda losses {losses['cuda']} vs cpu "
              f"{losses['cpu']} (max diff {diff} > {TRAIN_PARITY_TOL})")
        print(f"train parity {cfg.name} (f32, remat {remat}, Adam, 3 steps): "
              f"cuda losses {losses['cuda']} vs cpu {losses['cpu']}, max diff "
              f"{diff:.3e} (tol {TRAIN_PARITY_TOL}), B6 launches {n} | {card}")


# --------------------------------------------- phase 5c: training main path
TRAIN_LAYERS = 8     # of yi-9b's 48: Adam's state for all 48 needs ~141 GB
STABLELM_LAYERS = 2  # of stablelm-3b's 32: the hd-80 path at full width


def train_main_phase(card, row, arch="yi-9b", layers=TRAIN_LAYERS, batch=2,
                     seq=4096, timed=3, profile=True, make_batches=None):
    """A model at full width (yi-9b: d_model 4096, 32 heads over 4 kv heads,
    hd 128, d_ff 11008, vocab 64000, bf16; stablelm-3b: d_model 2560, 32
    heads, hd 80, d_ff 6912, vocab 50304; qwen3-moe-30b-a3b,
    rwkv6-7b, zamba2-2.7b), cut to `layers` layers, trained through the
    port's own entry points (trainer.init_state, make_train_step -> loss_fn
    -> forward -> attention_train -> B6): Adam with lr 3e-4 and grad clip
    1.0 (the launcher's defaults), remat on, batch `batch` x `seq` from
    SyntheticLM, 1 warm-up step and `timed` timed steps. Every loss is
    finite and each step launches B6 exactly twice per attention layer (the
    forward and the remat recompute; none for rwkv6). First the gradients
    of the first batch are computed once and must all be finite. `row`
    (B6's kernels-line row, or None) takes the launch count.
    `make_batches(cfg, batch, seq, n)`, if given, makes the batches in
    place of SyntheticLM's tokens (the stub frontends' embeddings).
    Returns the median step ms."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import state_providers as SP
    from repro_torch.models import transformer as T
    from repro_torch.optim import make_optimizer
    from repro_torch.train import trainer
    from repro_torch.tree import leaves_with_path
    tag = "train" if arch == "yi-9b" else f"train {arch}"
    _release_card()         # engines of the serving phases wait in cycles
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=layers)
    n_sb, _ = SP.superblock_layout(cfg)
    n_attn = n_sb * sum(k in T._ATTN_KINDS for k in SP.layer_kinds(cfg))
    opt = make_optimizer("adam", lr=3e-4, grad_clip=1.0)
    t0 = time.perf_counter()
    state = trainer.init_state(cfg, opt, seed=0)
    torch.cuda.synchronize()
    print(f"{tag}: {arch} at full width, {cfg.num_layers} of "
          f"{full.num_layers} layers "
          f"({cfg.param_count() / 1e9:.2f} B params, bf16, remat "
          f"{cfg.remat}, hd {cfg.resolved_head_dim}), Adam state made on "
          f"the card in {time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    if make_batches is None:
        batches = list(SyntheticLM(cfg.vocab_size, seq, seed=0)
                       .batches(batch, timed + 1))
    else:
        batches = make_batches(cfg, batch, seq, timed + 1)
    step = trainer.make_train_step(cfg, opt)
    per_step = 2 * n_attn
    t0 = time.perf_counter()
    _, g = trainer._grads_of(cfg, state["params"],
                             trainer._on(batches[0], "cuda"))
    g = leaves_with_path(g)
    bad = [k for k, v in g if not bool(torch.isfinite(v).all())]
    check(not bad, f"{tag}: non-finite gradients in {bad}")
    print(f"{tag}: all {len(g)} gradient leaves finite (one extra forward "
          f"and backward, {time.perf_counter() - t0:.1f} s)")
    del g
    kernels.reset_launch_counts()
    times, losses = [], []
    for i, b in enumerate(batches):
        before = kernels.launch_counts["flash_attention"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, metrics = step(state, b)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = kernels.launch_counts["flash_attention"] - before
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(math.isfinite(loss), f"{tag} step {i}: loss {loss}")
        check(n == per_step, f"{tag} step {i}: B6 launches {n} != {per_step}")
        label = "warm-up" if i == 0 else f"step {i}"
        print(f"{tag} {label}: loss {loss:.4f}, {dt * 1e3:.1f} ms, "
              f"{batch * seq / dt:.0f} tokens/s, peak {peak:.2f} GiB, B6 "
              f"launches {n} | {card}")
        if i:
            times.append(dt)
            losses.append(loss)
    launches = kernels.launch_counts["flash_attention"]
    check(launches == per_step * len(batches),
          f"{tag}: B6 launches {launches} != {per_step * len(batches)}")
    if row is not None:
        row["launches"] = launches
    print(f"{tag}: {timed} timed steps, median {np.median(times) * 1e3:.1f} "
          f"ms = {batch * seq / np.median(times):.0f} tokens/s; losses "
          f"{losses}; B6 launches {launches} = {per_step} x {len(batches)} "
          f"steps | {card}")
    if profile:
        train_profile(card, step, state, batches[-1], label=tag,
                      parts=bool(cfg.num_experts))
    del state
    _release_card()
    return float(np.median(times)) * 1e3


TRAIN_KINDS = ("B6 flash_attention forward", "B9 quantize_rows (int8)",
               "matmul (cuBLAS)", "other kernels and copies")


def train_profile(card, step, state, batch, label="train", parts=False):
    """Device kernel time by kind over one more training step, from
    torch.profiler; busy share = kernel time / the step's wall time. With
    `parts` its device time is also split by STEP_PARTS, from the
    program's own ranges."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, metrics = step(state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def device_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0) or 0)
    kern = [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and device_us(e) > 0 and not _is_span(e.key)]
    busy_ms = sum(device_us(e) for e in kern) / 1e3
    if busy_ms == 0:
        print(f"{label} profile: no device time recorded — not measured | "
              f"{card}")
        return
    if parts:
        split, remat = _step_parts(prof.events(), lambda e: sum(
            k.duration for k in e.kernels) / 1e3)
        total = sum(split.values())
        print(f"{label} profile: device time by part of the step (host op "
              f"tree; {total:.2f} ms of the {busy_ms:.2f} ms busy "
              f"attributed): " + "; ".join(
                  f"{k} {v:.2f} ms ({v / busy_ms:.1%})"
                  for k, v in split.items()) + f" | {card}")
        print(f"{label} profile: checkpointed functions, first pass "
              f"{remat['first pass']:.2f} ms, recomputation "
              f"{remat['recompute']:.2f} ms | {card}")
    by_kind = dict.fromkeys(TRAIN_KINDS, 0.0)
    for e in kern:
        name = e.key.lower()
        kind = (TRAIN_KINDS[0] if "flash_fwd" in name else
                TRAIN_KINDS[1] if "quantize_rows" in name else
                TRAIN_KINDS[2] if any(p in name for p in (
                    "gemm", "nvjet", "cutlass", "xmma", "sm90")) else
                TRAIN_KINDS[3])
        by_kind[kind] += device_us(e) / 1e3
    parts = "; ".join(f"{k} {v:.2f} ms ({v / busy_ms:.1%})"
                      for k, v in by_kind.items())
    print(f"{label} profile: one step, wall {wall_ms:.2f} ms (profiler on), "
          f"device busy {busy_ms:.2f} ms = {busy_ms / wall_ms:.1%} of wall, "
          f"{sum(e.count for e in kern)} device ops; by kind: {parts} | "
          f"{card}")
    top = sorted(kern, key=device_us, reverse=True)[:8]
    print(f"{label} profile: top kernels: " + "; ".join(
        f"{e.key[:60]} {device_us(e) / 1e3:.2f} ms x{e.count}" for e in top))


# ------------------------------------------------ phase 3e: kernels B8/B9
QUANT_NS = (256, 1000, 4096, 65_537)
QUANT_SOURCE = "src/repro_torch/kernels/quantize/csrc/quantize.cu"


def _quant_bytes(n, stochastic):
    """Bytes B8/B9 must move for n values: x (f32) read once, the noise
    (f32, B9 only, every row in full) read once, q (int8) and one f32 scale
    per 256-value row written once."""
    rows = -(-n // 256)
    return n * 4 + rows * 256 * (5 if stochastic else 1) + rows * 4


def _train_leaf_sizes():
    """Values in each parameter leaf of the training main path (yi-9b at
    full width, TRAIN_LAYERS layers): one gradient leaf each per step."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import param_specs
    from repro_torch.tree import tree_leaves
    cfg = dataclasses.replace(get_config("yi-9b"), num_layers=TRAIN_LAYERS)
    return [math.prod(shape) for shape, _, _ in tree_leaves(param_specs(cfg))]


def quantize_kernel_phase(card):
    """B9 (stochastic rounding) and B8 (round half to even) against their
    plain version on the card: both modes, bits 8 and 4, n in QUANT_NS plus
    a case with an all-zero row and a ragged tail; q and scales must be
    EQUAL (both compute the same IEEE f32 operations). Then the int8 KV
    quantizer on cuda against cpu, bit for bit (a Python-number divisor
    would be a reciprocal multiply on cuda). Then each mode timed at the
    largest training leaf (yi-9b's MLP weight over 8 layers) and over the
    whole step's 12 leaves, beside the plain version and the byte bound;
    no single PyTorch call computes the function (library: none)."""
    import torch
    from repro_torch.kernels.quantize import ops, quantize_kv
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    worst = {"stochastic": 0.0, "nearest": 0.0}
    n_cases = 0
    for mode in ("stochastic", "nearest"):
        for bits in (8, 4):
            cases = [(f"n={n}", torch.randn(n, generator=gen, device="cuda")
                      * 0.02) for n in QUANT_NS]
            ragged = torch.randn(256 * 3 + 5, generator=gen,
                                 device="cuda") * 0.1
            ragged[256:512] = 0.0
            cases.append(("zero row + ragged tail n=773", ragged))
            for label, flat in cases:
                rows = -(-flat.numel() // 256)
                noise = (torch.rand((rows, 256), generator=gen, device="cuda")
                         if mode == "stochastic" else None)
                q, s = ops._kernel(flat, noise, bits, 256, mode)
                qp, sp = ops._plain(flat, noise, bits, 256, mode)
                torch.cuda.synchronize()
                err = max((q.int() - qp.int()).abs().max().item(),
                          (s - sp).abs().max().item())
                check(torch.equal(q, qp) and torch.equal(s, sp),
                      f"B8/B9 {mode} bits={bits} {label}: q differs in "
                      f"{int((q != qp).sum())}, scales in "
                      f"{int((s != sp).sum())} of {rows} rows")
                if label.startswith("zero"):
                    check(s[1].item() == 1.0 and not q[1].any()
                          and not q[3, 5:].any(),
                          f"B8/B9 {mode} bits={bits}: zero row / tail")
                worst[mode] = max(worst[mode], err)
                n_cases += 1
    print(f"kernel B9/B8: {n_cases} cases (stochastic and nearest, bits 8 "
          f"and 4, n {QUANT_NS} + a zero row with a ragged tail): q and "
          f"scales equal to the plain version in every case | {card}")
    x = torch.randn((4096, 8, 128), generator=gen, device="cuda")
    qg, sg = quantize_kv(x)
    qc, sc = quantize_kv(x.cpu())
    amax = x.abs().amax(-1)
    recip = int((amax / 127.0 != amax / torch.full((), 127.0,
                                                   device="cuda")).sum())
    check(torch.equal(qg.cpu(), qc) and torch.equal(sg.cpu(), sc),
          "quantize_kv: cuda and cpu differ")
    print(f"quantize_kv (int8 KV write) cuda == cpu bit for bit on "
          f"{amax.numel()} vectors (a Python-number divisor on cuda would "
          f"differ in {recip} scales)")
    del x, qg, sg, amax

    sizes = _train_leaf_sizes()
    n = max(sizes)
    rows_out = []
    for mode, name, line in (("stochastic", "quantize_stochastic", 25),
                             ("nearest", "quantize_nearest", 38)):
        stoch = mode == "stochastic"
        xs = [torch.randn(k, generator=gen, device="cuda") * 0.01
              for k in sizes]
        us = [torch.rand((-(-k // 256), 256), generator=gen, device="cuda")
              if stoch else None for k in sizes]
        big = sizes.index(n)
        x, u = xs[big], us[big]
        q, s = ops._kernel(x, u, 8, 256, mode)
        qp, sp = ops._plain(x, u, 8, 256, mode)
        check(torch.equal(q, qp) and torch.equal(s, sp),
              f"B8/B9 {mode} at the largest leaf: differs from plain")
        del q, s, qp, sp
        ms = time_ms(lambda: ops._kernel(x, u, 8, 256, mode), iters=20)
        dev_ms = device_ms(lambda: ops._kernel(x, u, 8, 256, mode), iters=20)
        plain_ms = time_ms(lambda: ops._plain(x, u, 8, 256, mode), iters=5,
                           warmup=1)
        step_ms = time_ms(lambda: [ops._kernel(a, b, 8, 256, mode)
                                   for a, b in zip(xs, us)], iters=5)
        step_plain_ms = time_ms(lambda: [ops._plain(a, b, 8, 256, mode)
                                         for a, b in zip(xs, us)], iters=2,
                                warmup=1)
        nbytes = _quant_bytes(n, stoch)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        step_bytes = sum(_quant_bytes(k, stoch) for k in sizes)
        step_bound = step_bytes / HBM_BYTES_PER_S * 1e3
        tag = "B9" if stoch else "B8"
        print(f"{tag} {name} @ the largest yi-9b training leaf ({n} values, "
              f"{-(-n // 256)} rows, bits 8): kernel {ms:.4f} ms "
              f"({nbytes / ms / 1e9:.2f} TB/s; device {_ms(dev_ms)}), plain "
              f"{plain_ms:.4f} ms, "
              f"library none, bound {bound_ms:.4f} ms by bytes ({nbytes} B); "
              f"over the step's {len(sizes)} leaves ({sum(sizes)} values): "
              f"kernel {step_ms:.4f} ms, plain {step_plain_ms:.4f} ms, bound "
              f"{step_bound:.4f} ms ({step_bytes} B) | {card}")
        rows_out.append({
            "name": name, "route": "cuda", "source": QUANT_SOURCE,
            "replaces": f"src/repro/kernels/quantize/kernel.py:{line}",
            "launches": None, "max_abs_err": worst[mode], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": None, "device_ms": dev_ms})
        del xs, us, x, u
        _release_card()
    return rows_out


# ----------------------------------------- phase 4e: paper-mode parity
PAPER_COMPRESS = ("none", "onebit", "topk")


def _paper_losses(cfg, params, batches, dev, compress, group):
    """Losses of 3 paper-mode Adam steps (ring allreduce, one rank) from
    `params` on `dev`, with the named compressor ("none": no compression)."""
    from repro_torch.core.compression import make_compressor
    from repro_torch.optim import make_optimizer
    from repro_torch.train import trainer
    from repro_torch.tree import tree_map
    opt = make_optimizer("adam", lr=3e-4, grad_clip=1.0)
    p = tree_map(lambda t: t.clone().to(dev), params)
    state = {"params": p, "opt": opt.init(p)}
    comp = None if compress == "none" else make_compressor(compress)
    step = trainer.make_paper_train_step(cfg, opt, group, algorithm="ring",
                                         compression=comp)
    res = trainer.zero_residual(p) if comp else None
    losses = []
    for b in batches:
        state, metrics, res = step(state, b, res)
        losses.append(float(metrics["loss"]))
    return losses


def paper_parity_phase(card):
    """Reduced f32 yi-9b through the paper-mode step on a one-rank group
    (launch/mesh.py), 3 Adam steps: with no compression, onebit and topk
    (deterministic) the cuda losses (nccl group) agree with the cpu losses
    (gloo group) within TRAIN_PARITY_TOL; with int8 the cuda run with B9
    agrees within it with the same cuda run whose quantize_blocks takes the
    plain version (this phase only), B9 launching in the first run and not
    in the second. A process holds one default group at a time: the gloo
    group is destroyed before the nccl group is made."""
    import torch
    import torch.distributed as dist
    from repro_torch import kernels
    from repro_torch.configs import get_config, reduced
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels.quantize import ops
    from repro_torch.launch.mesh import make_dp_group
    from repro_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(reduced(get_config("yi-9b")), dtype="float32",
                              remat=False)
    params = T.init_params(cfg, seed=0, device="cpu")
    batches = list(SyntheticLM(cfg.vocab_size, 64, seed=0).batches(2, 3))
    losses = {}
    group = make_dp_group("cpu")
    try:
        for c in PAPER_COMPRESS:
            losses["cpu", c] = _paper_losses(cfg, params, batches, "cpu", c,
                                             group)
    finally:
        dist.destroy_process_group()
    group = make_dp_group("cuda")
    try:
        for c in PAPER_COMPRESS:
            got = losses["cuda", c] = _paper_losses(cfg, params, batches,
                                                    "cuda", c, group)
            want = losses["cpu", c]
            diff = max(abs(a - b) for a, b in zip(got, want))
            check(all(map(math.isfinite, got)) and diff <= TRAIN_PARITY_TOL,
                  f"paper parity {c}: cuda {got} vs cpu {want}")
            print(f"paper parity {cfg.name} (f32, ring, {c}, Adam, 3 steps): "
                  f"cuda losses {got} vs cpu {want}, max diff {diff:.3e} "
                  f"(tol {TRAIN_PARITY_TOL}) | {card}")
        kernels.reset_launch_counts()
        with_kernel = _paper_losses(cfg, params, batches, "cuda", "int8",
                                    group)
        n_kernel = kernels.launch_counts["quantize_stochastic"]
        saved, ops._kernel = ops._kernel, ops._plain
        try:
            plain = _paper_losses(cfg, params, batches, "cuda", "int8", group)
        finally:
            ops._kernel = saved
        n_plain = kernels.launch_counts["quantize_stochastic"] - n_kernel
        diff = max(abs(a - b) for a, b in zip(with_kernel, plain))
        check(n_kernel > 0 and n_plain == 0
              and all(map(math.isfinite, with_kernel))
              and diff <= TRAIN_PARITY_TOL,
              f"paper parity int8: B9 {with_kernel} ({n_kernel} launches) vs "
              f"plain {plain} ({n_plain} launches)")
        print(f"paper parity {cfg.name} (f32, ring, int8, cuda): B9 losses "
              f"{with_kernel} ({n_kernel} launches) vs plain quantize "
              f"{plain} ({n_plain} launches), max diff {diff:.3e} (tol "
              f"{TRAIN_PARITY_TOL}) | {card}")
    finally:
        dist.destroy_process_group()


# ------------------------------------------ phase 5d: paper-mode main path
def paper_main_phase(card, rows, plain_ms):
    """yi-9b at full width cut to TRAIN_LAYERS layers, batch 2 x 4096,
    through the paper-mode trainer: launch/mesh.py's one-rank nccl group,
    make_paper_train_step(algorithm="ring", compression=int8) (QSGD with
    error feedback: B9 on each of the 12 gradient leaves, then the ring
    allreduce, which returns the gradient at one rank), Adam lr 3e-4, clip
    1.0, remat; 1 warm-up and 3 timed steps. Every loss is finite, each
    step launches B6 2 x layers times and B9 once per leaf, B8 never; the
    residual is finite and nonzero. Then the error-feedback compression
    timed alone over the step's leaves, and one profiled step."""
    import torch
    import torch.distributed as dist
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.compression import make_compressor
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.mesh import make_dp_group
    from repro_torch.optim import make_optimizer
    from repro_torch.train import trainer
    from repro_torch.tree import tree_leaves, tree_map
    batch, seq = 2, 4096
    _release_card()
    cfg = dataclasses.replace(get_config("yi-9b"), num_layers=TRAIN_LAYERS)
    opt = make_optimizer("adam", lr=3e-4, grad_clip=1.0)
    group = make_dp_group("cuda")
    try:
        probe = torch.ones(1, device="cuda")
        dist.all_reduce(probe, group=group)
        check(probe.item() == 1.0, f"nccl one-rank all_reduce: {probe}")
        state = trainer.init_state(cfg, opt, seed=0)
        comp = make_compressor("int8")
        residual = trainer.zero_residual(state["params"])
        n_leaves = len(tree_leaves(state["params"]))
        step = trainer.make_paper_train_step(cfg, opt, group,
                                             algorithm="ring",
                                             compression=comp)
        batches = list(SyntheticLM(cfg.vocab_size, seq, seed=0)
                       .batches(batch, 4))
        per_step = {"flash_attention": 2 * cfg.num_layers,
                    "quantize_stochastic": n_leaves, "quantize_nearest": 0}
        kernels.reset_launch_counts()
        times, losses, peak = [], [], 0.0
        for i, b in enumerate(batches):
            before = dict(kernels.launch_counts)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state, metrics, residual = step(state, b, residual)
            loss = float(metrics["loss"])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            n = {k: kernels.launch_counts[k] - before[k] for k in per_step}
            step_peak = torch.cuda.max_memory_allocated() / 2**30
            peak = max(peak, step_peak)
            check(math.isfinite(loss), f"paper step {i}: loss {loss}")
            check(n == per_step, f"paper step {i}: launches {n} != {per_step}")
            label = "warm-up" if i == 0 else f"step {i}"
            print(f"paper {label}: loss {loss:.4f}, {dt * 1e3:.1f} ms, "
                  f"{batch * seq / dt:.0f} tokens/s, peak {step_peak:.2f} "
                  f"GiB, launches {n} | {card}")
            if i:
                times.append(dt)
                losses.append(loss)
        launches = dict(kernels.launch_counts)
        want = {k: v * len(batches) for k, v in per_step.items()}
        check({k: launches[k] for k in want} == want,
              f"paper: launches {launches} != {want}")
        for r in rows:
            if r["name"] in ("quantize_stochastic", "quantize_nearest"):
                r["launches"] = launches[r["name"]]
        res = tree_leaves(residual)
        check(all(bool(torch.isfinite(r).all()) for r in res)
              and any(bool(r.abs().max() > 0) for r in res),
              "paper: the error-feedback residual is not finite and nonzero")
        med = float(np.median(times)) * 1e3
        print(f"paper: 3 timed steps (yi-9b, {cfg.num_layers} layers, int8 + "
              f"error feedback, ring, 1 rank), median {med:.1f} ms = "
              f"{batch * seq / med * 1e3:.0f} tokens/s, peak {peak:.2f} GiB; "
              f"plain step of this run {plain_ms:.1f} ms "
              f"({med / plain_ms - 1:+.1%}); losses {losses}; launches "
              f"{want} over {len(batches)} steps | {card}")
        grads = tree_map(lambda p: torch.randn(p.shape, device="cuda")
                         .to(p.dtype) * 1e-3, state["params"])
        ef_ms = time_ms(lambda: comp.compress_with_feedback(grads, residual),
                        iters=3, warmup=1)
        print(f"paper: int8 compress_with_feedback over the {n_leaves} "
              f"leaves alone (residual add, noise draw, B9, dequantize, "
              f"cast, residual update) {ef_ms:.2f} ms = {ef_ms / med:.1%} of "
              f"a paper step | {card}")
        del grads
        train_profile(card, lambda s, b: step(s, b, residual)[:2], state,
                      batches[-1], label="paper")
    finally:
        dist.destroy_process_group()
    del state, residual
    _release_card()


DEVICE_KINDS = ("B1 full decode (bf16 q: and B4 verify)",
                "B2 ring decode (bf16 q: and B5 ring verify)",
                "f32 B5 ring verify split (and f32 ring decode)",
                "f32 B4 verify split", "paged merges", "matmul (cuBLAS)",
                "other kernels and copies")


def _device_kind(key: str) -> str:
    """Kind of a device kernel by its (demangled or mangled) name; the ring
    instantiations carry the template flag `true` (mangled `Lb1E`)."""
    name = key.lower()
    ring = "true>" in name or "lb1e" in name
    if "paged" in name and "merge" in name:
        return DEVICE_KINDS[4]
    if "paged_decode_tc" in name:
        return DEVICE_KINDS[1 if ring else 0]
    if "paged_decode" in name:
        return DEVICE_KINDS[0]
    if "paged_multi_split" in name:
        return DEVICE_KINDS[2 if ring else 3]
    if any(p in name for p in ("gemm", "nvjet", "cutlass", "xmma", "sm90")):
        return DEVICE_KINDS[5]
    return DEVICE_KINDS[6]


def where_time_goes(card, eng, prompts, news, warm=3, window=4,
                    label="mixed"):
    """Device kernel time by kind over `window` engine steps of the given
    requests (prefills and decodes as the scheduler interleaves them),
    from torch.profiler, after `warm` steps; busy share = kernel time /
    window wall time. The next `window` steps run without the profiler,
    for their wall time per step."""
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
    t0 = time.perf_counter()
    for _ in range(window):
        eng.step()
    torch.cuda.synchronize()
    bare_ms = (time.perf_counter() - t0) * 1e3 / window
    eng.drain()

    device_us = _device_us
    # device-side events, less the program's own ranges ("engine/decode",
    # "moe/apply", ...: `_is_span`), which the profiler mirrors onto the
    # device timeline as annotations
    # (aggregated once: the profiler's post-processing of a window is
    # most of this function's time)
    averages = prof.key_averages()
    kern = [e for e in averages
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and device_us(e) > 0 and not _is_span(e.key)]
    busy_ms = sum(device_us(e) for e in kern) / 1e3
    if busy_ms == 0:
        print(f"profile: no device time recorded — not measured | {card}")
        return
    _print_moe_split(averages, busy_ms, wall_ms, window)
    by_kind = dict.fromkeys(DEVICE_KINDS, 0.0)
    for e in kern:
        by_kind[_device_kind(e.key)] += device_us(e) / 1e3
    by_kind = {k: v for k, v in by_kind.items() if v}
    launches = sum(e.count for e in kern)
    parts = "; ".join(f"{k} {v:.2f} ms ({v / busy_ms:.1%})"
                      for k, v in by_kind.items())
    print(f"profile ({label}): {window} engine steps after {warm}, wall "
          f"{wall_ms:.2f} ms (profiler on), device busy {busy_ms:.2f} ms = "
          f"{busy_ms / wall_ms:.1%} of wall, idle {1 - busy_ms / wall_ms:.1%}; "
          f"{launches} device ops = {launches / window:.0f} per step; the "
          f"next {window} steps without the profiler {bare_ms:.2f} ms each "
          f"| {card}")
    print(f"profile: by kind: {parts}")
    top = sorted(kern, key=device_us, reverse=True)[:6]
    print("profile: top kernels: " + "; ".join(
        f"{e.key[:60]} {device_us(e) / 1e3:.2f} ms x{e.count}" for e in top))
    # where the host's time goes (self time of host-side ops and CUDA
    # runtime calls, profiler overhead included)
    host = [e for e in averages
            if not str(getattr(e, "device_type", "")).endswith("CUDA")
            and not _is_span(e.key)]
    host.sort(key=lambda e: e.self_cpu_time_total, reverse=True)
    print("profile: top host self time: " + "; ".join(
        f"{e.key[:40]} {e.self_cpu_time_total / 1e3:.2f} ms x{e.count}"
        for e in host[:10]))
    return busy_ms / wall_ms


def _print_moe_split(averages, busy_ms, wall_ms, window):
    """The device time of the kernels launched inside the program's host
    ranges "moe/apply" and "moe/experts" (the profiler's
    total device time of a range's ops), as shares of the busy time. A
    replayed decode graph runs no Python and so opens no such range: with
    one, the split covers the eager calls (prefill, verify) alone."""
    spans = {}
    for e in averages:
        if (e.key in ("moe/apply", "moe/experts") and not
                str(getattr(e, "device_type", "")).endswith("CUDA")):
            us = (getattr(e, "device_time_total", None)
                  or getattr(e, "cuda_time_total", 0) or 0)
            spans[e.key] = spans.get(e.key, 0.0) + us / 1e3
    if not spans:
        return
    moe, experts = spans.get("moe/apply", 0.0), spans.get("moe/experts", 0.0)
    print(f"profile: MoE layers {moe:.2f} ms of device time "
          f"({moe / busy_ms:.1%} of busy, {moe / window:.2f} ms a step): "
          f"expert products (bmm, silu) {experts:.2f} ms "
          f"({experts / busy_ms:.1%}), routing + dispatch + combine "
          f"{moe - experts:.2f} ms ({(moe - experts) / busy_ms:.1%}); wall "
          f"{wall_ms:.2f} ms")


# ------------------------------------------------------ phase 3f: kernel B7
MATMUL_SOURCE = "src/repro_torch/kernels/matmul/csrc/matmul.cu"
# (M, K, N): the reference's sweep (tests/test_kernels.py:14), then shapes
# no tile divides (K past a k tile, M and N past a 128 x 64 tile); K or N
# not a multiple of 8 sends that operand through the bf16 kernel's masked
# scalar loader (K = 577, N = 65), N = 200 ends in a partial 64-wide tile
MATMUL_SWEEP = [(128, 128, 128), (256, 512, 128), (128, 1024, 256),
                (384, 256, 640), (1000, 577, 65), (1, 9, 1), (130, 17, 70),
                (7, 33, 129), (513, 576, 65), (300, 577, 200),
                (1000, 576, 200)]
# the survey's Table 6 layer (benchmarks/table6_conv_algorithms.py): batch
# 64, 64 input and 64 output channels, 56 x 56, VALID, at each kernel size
CONV_LAYER = (64, 64, 56, 64)      # N, C_in, H (= W), C_out
CONV_KS = (3, 5, 7, 11, 13)
MATMUL_TIMED = (3, 13)             # kernel sizes whose GEMM is timed


def _im2col_shape(k):
    """(M, K, N) of conv_im2col's GEMM at the Table 6 layer, kernel k x k."""
    N, C, H, K = CONV_LAYER
    Ho = H - k + 1
    return N * Ho * Ho, C * k * k, K


def _matmul_tol(dt, K, scale):
    """f32: 1e-5 of max |ref| (a K-long sum in f32 on both sides, in
    another order), and never looser than the reference's 2e-6 K; bf16: 2e-2
    of max |ref| (both sum in f32; each output rounds once to bf16, one
    bf16 step is 2**-8 of the value)."""
    import torch
    if dt == torch.float32:
        return min(2e-6 * K, 1e-5 * scale)
    return 2e-2 * scale


def matmul_kernel_phase(card):
    """B7 against its plain version (f32 cuBLAS on f32 copies, no TF32) on
    the card, in f32 and bf16, over MATMUL_SWEEP and the five im2col
    shapes; bf16 in with f32 out and f32 in with bf16 out at one ragged
    shape; then B7 timed at the K=3 and K=13 im2col shapes beside its plain
    version, torch.matmul at the working dtype (cuBLAS: the library
    yardstick; in f32 it is the plain version's call) and its bound. Returns
    the f32 and bf16 rows of the kernels line (K=3)."""
    import torch
    from repro_torch.kernels.matmul import matmul_ref
    from repro_torch.kernels.matmul.ops import _kernel
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    f32, bf16 = torch.float32, torch.bfloat16
    shapes = MATMUL_SWEEP + [_im2col_shape(k) for k in CONV_KS]
    for M, K, N in shapes:
        a32 = torch.randn((M, K), generator=gen, device="cuda")
        b32 = torch.randn((K, N), generator=gen, device="cuda")
        errs = []
        for dt in (f32, bf16):
            a, b = a32.to(dt), b32.to(dt)
            out = _kernel(a, b, None)
            ref = matmul_ref(a, b)
            torch.cuda.synchronize()
            scale = ref.float().abs().max().item()
            err = (out.float() - ref.float()).abs().max().item()
            tol = _matmul_tol(dt, K, scale)
            check(out.dtype == dt and math.isfinite(err) and err <= tol,
                  f"B7 M={M} K={K} N={N} {dt}: max_abs_err {err} > {tol}")
            errs.append(f"{dt}: {err:.3e} (tol {tol:.3e}, max|ref| "
                        f"{scale:.1f}" + (f"; equal to cuBLAS f32 bit for "
                                          f"bit: {torch.equal(out, ref)})"
                                          if dt == f32 else ")"))
            del a, b, out, ref
        print(f"kernel B7 M={M} K={K} N={N}: " + ", ".join(errs))
        del a32, b32
    a = torch.randn((1000, 577), generator=gen, device="cuda")
    b = torch.randn((577, 65), generator=gen, device="cuda")
    for dt, out_dt in ((f32, bf16), (bf16, f32)):
        out = _kernel(a.to(dt), b.to(dt), out_dt)
        ref = matmul_ref(a.to(dt), b.to(dt), out_dt)
        scale = ref.float().abs().max().item()
        err = (out.float() - ref.float()).abs().max().item()
        tol = _matmul_tol(out_dt, 577, scale)
        check(out.dtype == out_dt and err <= tol,
              f"B7 {dt} -> {out_dt}: max_abs_err {err} > {tol}")
        print(f"kernel B7 M=1000 K=577 N=65 {dt} in, {out_dt} out: "
              f"max_abs_err {err:.3e} (tol {tol:.3e})")
    _release_card()

    rows = []
    for k in MATMUL_TIMED:
        M, K, N = _im2col_shape(k)
        a32 = torch.randn((M, K), generator=gen, device="cuda")
        b32 = torch.randn((K, N), generator=gen, device="cuda")
        for dt in (f32, bf16):
            a, b = a32.to(dt), b32.to(dt)
            out = _kernel(a, b, None)
            ref = matmul_ref(a, b)
            err = (out.float() - ref.float()).abs().max().item()
            del out, ref
            iters = 10 if k == 3 else 4
            ms = time_ms(lambda: _kernel(a, b, None), iters=iters)
            plain_ms = time_ms(lambda: matmul_ref(a, b), iters=iters)
            library_ms = time_ms(lambda: torch.matmul(a, b), iters=iters)
            dev_ms = device_ms(lambda: _kernel(a, b, None), iters=iters)
            lib_dev_ms = device_ms(lambda: torch.matmul(a, b), iters=iters)
            item = a.element_size()
            nbytes = (M * K + K * N + M * N) * item
            flops = 2 * M * N * K
            peak = FP32_FLOPS if dt == f32 else BF16_FLOPS
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / peak * 1e3
            bound_ms = max(t_bytes, t_ops)
            bound_by = "bytes" if t_bytes >= t_ops else "operations"

            def rates(t):
                return (f"{_tflops(flops, t)}, "
                        f"{nbytes / t / 1e6:.1f} GB/s")
            print(f"B7 matmul @ Table 6 im2col GEMM, kernel {k}x{k} (M={M}, "
                  f"K={K}, N={N}, {dt}): kernel {ms:.4f} ms ({rates(ms)}; "
                  f"device {_ms(dev_ms)}), "
                  f"plain (f32 cuBLAS) {plain_ms:.4f} ms ({rates(plain_ms)}), "
                  f"library torch.matmul {library_ms:.4f} ms "
                  f"({rates(library_ms)}; device {_ms(lib_dev_ms)}), bound "
                  f"{bound_ms:.4f} ms by "
                  f"{bound_by} ({rates(bound_ms)}; {nbytes} B, {flops} flop; "
                  f"peak {peak / 1e12:.0f} TFLOP/s) | {card}")
            if k == 3:
                rows.append({
                    "name": "matmul" if dt == f32 else "matmul_bf16",
                    "route": "cuda", "source": MATMUL_SOURCE,
                    "replaces": "src/repro/kernels/matmul/kernel.py:21",
                    "launches": None, "max_abs_err": err, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": library_ms,
                    "device_ms": dev_ms, "library_device_ms": lib_dev_ms})
            del a, b
        del a32, b32
        _release_card()
    return rows


# ------------------------------------------- phase 5e: §4.3 convolutions
# |algorithm - conv_direct| and |conv_direct - float64| over max |float64|:
# f32 accuracy. The longest f32 sum here is conv_im2col's at K=13 (10,816
# terms, one FMA chain per output in B7); its rounding error stays a few
# 1e-6 of the largest output. TF32 (10-bit mantissa) would give ~1e-3.
CONV_TOL = 2e-5
CONV_F64_BATCH = 8       # images of the batch held against float64
CLAIM_DRAWS = 32         # draws at the reference test's shape


def conv_phase(card, rows):
    """The survey's §4.3 algorithms at its Table 6 layer (CONV_LAYER, f32,
    weights x 0.2 as the reference's tests draw them) for each kernel size
    in CONV_KS (Winograd, F(2x2, 3x3), at 3 only), through the port's
    models/conv.py: each algorithm against conv_direct on the card within
    CONV_TOL of max |ref|, and conv_direct against float64 F.conv2d on
    CONV_F64_BATCH images, with cuDNN's TF32 left at PyTorch's default (on)
    so that conv_direct's own scoped setting is what keeps it f32. B7 runs
    once per conv_im2col call and nothing else launches it; once more in
    bf16 at 3 x 3 (within 2e-2 of max |ref|). Each algorithm timed beside
    its Work-Depth W (core/workdepth.py, as Table 6 computes it); the
    fastest at each size printed. Then the survey's claim that Winograd is
    less accurate than im2col, measured (not gated): at this layer with
    inputs x 100 against float64, and over CLAIM_DRAWS draws at the
    reference test's shape (2 x 3 x 18 x 18, 4 kernels)."""
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels
    from repro_torch.core import workdepth as WD
    from repro_torch.models import conv as CV
    N, C, H, K = CONV_LAYER
    _release_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True           # PyTorch's default
    gen = torch.Generator(device="cuda")
    gen.manual_seed(16)
    x = torch.randn((N, C, H, H), generator=gen, device="cuda")
    calls = {torch.float32: 0, torch.bfloat16: 0}    # conv_im2col calls

    def im2col(a, b):
        calls[a.dtype] += 1
        return CV.conv_im2col(a, b)
    algos = {**CV.ALGORITHMS, "im2col": im2col}
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    fastest = {}
    for k in CONV_KS:
        w = torch.randn((K, C, k, k), generator=gen, device="cuda") * 0.2
        ref = CV.conv_direct(x, w)
        check(torch.backends.cudnn.allow_tf32,
              "conv_direct changed the caller's cuDNN TF32 setting")
        r64 = F.conv2d(x[:CONV_F64_BATCH].double(), w.double())
        scale64 = r64.abs().max().item()
        err64 = ((ref[:CONV_F64_BATCH].double() - r64).abs().max().item()
                 / scale64)
        check(err64 <= CONV_TOL, f"conv_direct {k}x{k} vs float64: "
              f"{err64:.3e} of max|ref| > {CONV_TOL}")
        line = [f"direct vs float64 {err64:.2e}"]
        if k == 3:
            tf32 = F.conv2d(x[:CONV_F64_BATCH], w)       # cuDNN's default
            e = (tf32.double() - r64).abs().max().item() / scale64
            line.append(f"plain F.conv2d under the TF32 default vs float64 "
                        f"{e:.2e}")
            del tf32
        del r64
        scale = ref.abs().max().item()
        wd = {"direct": WD.conv_direct(N, H, H, C, K, k, k),
              "im2col": WD.conv_im2col(N, H, H, C, K, k, k),
              "fft": WD.conv_fft(N, H, H, C, K),
              "winograd": WD.conv_winograd(N, H, H, C, K, r=3, m=2)}
        times = {}
        for name, fn in algos.items():
            if name == "winograd" and k != 3:
                continue
            if name != "direct":
                out = fn(x, w)
                check(tuple(out.shape) == tuple(ref.shape),
                      f"{name} {k}x{k}: shape {tuple(out.shape)}")
                err = (out - ref).abs().max().item() / scale
                check(math.isfinite(err) and err <= CONV_TOL,
                      f"{name} {k}x{k} vs conv_direct: {err:.3e} of max|ref| "
                      f"> {CONV_TOL}")
                line.append(f"{name} vs direct {err:.2e}")
                del out
            times[name] = time_ms(lambda: fn(x, w), iters=3, warmup=1)
        if k == 3:
            out = im2col(x.bfloat16(), w.bfloat16())
            err = (out.float() - ref).abs().max().item() / scale
            check(out.dtype == torch.bfloat16 and err <= 2e-2,
                  f"im2col bf16 3x3 vs conv_direct: {err:.3e} of max|ref|")
            line.append(f"im2col bf16 vs direct {err:.2e}")
            del out
        del ref
        fastest[k] = min(times, key=times.get)
        macs = wd["direct"].work
        print(f"conv {k}x{k} @ Table 6 layer (N={N}, C={C}, {H}x{H}, K={K}, "
              f"f32): errors over max|ref|: " + ", ".join(line) + " | "
              f"{card}")
        for name, t in times.items():
            print(f"conv {k}x{k} {name}: {t:.4f} ms; Work-Depth W = "
                  f"{wd[name].work:.4e}, D = {wd[name].depth}; W / time = "
                  f"{wd[name].work / t / 1e6:.1f} G op/s; direct-equivalent "
                  f"2 x {macs:.4e} MAC / time = {2 * macs / t / 1e9:.2f} "
                  f"TFLOP/s")
        print(f"conv {k}x{k}: fastest {fastest[k]} ({times[fastest[k]]:.4f} "
              f"ms), peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
              f"GiB")
        del w
        _release_card()
        torch.cuda.reset_peak_memory_stats()
    launches = dict(kernels.launch_counts)
    n_calls = sum(calls.values())
    check(launches["matmul"] == n_calls and all(calls.values()),
          f"conv: B7 launches {launches['matmul']} != conv_im2col calls "
          f"{n_calls}")
    others = {k: v for k, v in launches.items() if k != "matmul" and v}
    check(not others, f"conv: other kernels launched: {others}")
    for r in rows:
        if r["name"] in ("matmul", "matmul_bf16"):
            r["launches"] = calls[torch.float32 if r["name"] == "matmul"
                                  else torch.bfloat16]
    print(f"conv: B7 launches {launches['matmul']} == conv_im2col calls "
          f"{n_calls} (f32 {calls[torch.float32]}, bf16 "
          f"{calls[torch.bfloat16]}); "
          f"fastest per kernel size {fastest} (no one algorithm wins "
          f"everywhere: {len(set(fastest.values())) > 1}) | {card}")

    # the survey's claim, measured: Winograd's error against im2col's
    w = torch.randn((K, C, 3, 3), generator=gen, device="cuda") * 0.2
    xs = x[:CONV_F64_BATCH] * 100.0
    r64 = F.conv2d(xs.double(), w.double())
    e_w = (CV.conv_winograd(xs, w).double() - r64).abs().max().item()
    e_i = (CV.conv_im2col(xs, w).double() - r64).abs().max().item()
    wins = 0
    for _ in range(CLAIM_DRAWS):
        xt = torch.randn((2, 3, 18, 18), generator=gen, device="cuda") * 100
        wt = torch.randn((4, 3, 3, 3), generator=gen, device="cuda") * 0.2
        t64 = F.conv2d(xt.double(), wt.double())
        wins += ((CV.conv_winograd(xt, wt).double() - t64).abs().max()
                 >= (CV.conv_im2col(xt, wt).double() - t64).abs().max()).item()
    print(f"conv claim (survey §4.3: Winograd less accurate than im2col), "
          f"against float64, inputs x 100: Table 6 layer ({CONV_F64_BATCH} "
          f"images) Winograd {e_w:.3e} vs im2col {e_i:.3e} -> "
          f"{'holds' if e_w >= e_i else 'does not hold'}; the reference "
          f"test's shape: holds in {wins} of {CLAIM_DRAWS} draws | {card}")
    del x, xs, w, r64
    _release_card()


# redesigned kernels whose ptxas report must show 0 spill stores: B6 in
# bf16 at the widths of the configs' head dims 64, 80 and 128, B7 in f32
# and bf16 (both output types), and the bf16 decode and verify (B1, B2, B4,
# B5; bf16 and int8 pools) at all its widths, the configs' head dims 64,
# 80, 128 and 256
# ------------------------------------------ phase 8: the last configs (A17)
MUSICGEN_LAYOUT = (24, 24, 64)      # musicgen-medium: MHA, hd 64
A17_LAYOUTS = {"qwen2-vl-2b": (12, 2, 128),     # 6 groups
               "phi4-mini-3.8b": (24, 8, 128)}  # 3 groups
A17_PARITY_LAYERS = 2               # of qwen2-vl-2b's 28, f32 at full width
MUSICGEN_TRAIN_LAYERS = 48          # full depth: ~18 GB of Adam state
A17_LENS = (64, 128, 192, 256, 320, 384, 448, 512)


def vl_positions(B, S, grid):
    """(3, B, S) Qwen2-VL M-RoPE position ids (arXiv:2409.12191 §2.1): row
    b holds b text tokens, a 1 x grid x grid image (t = b, h = b + row, w =
    b + column), then text whose three ids continue at the image's max +
    1 (row 0: the image first, t = 0, h = row, w = column)."""
    r, c = np.divmod(np.arange(grid * grid), grid)
    out = np.empty((3, B, S), np.int64)
    for b in range(B):
        img = b + np.stack([np.zeros_like(r), r, c])
        tail = img.max() + 1 + np.arange(S - b - grid * grid)
        lead = np.broadcast_to(np.arange(b), (3, b))
        out[:, b] = np.concatenate(
            [lead, img, np.broadcast_to(tail, (3, len(tail)))], axis=1)
    return out


def _stub_batches(grid=None, seed=0):
    """make_batches for train_main_phase: the stub frontend's embeddings
    (seeded normal · 0.5, made on the card), random labels and, with
    `grid`, Qwen2-VL's (3, B, S) positions of a grid x grid image."""
    def make(cfg, batch, seq, n):
        import torch
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        out = []
        for _ in range(n):
            b = {"embeds": torch.randn((batch, seq, cfg.d_model),
                                       generator=gen, device="cuda") * 0.5,
                 "labels": torch.randint(0, cfg.vocab_size, (batch, seq),
                                         generator=gen, device="cuda")}
            if grid is not None:
                b["positions"] = torch.as_tensor(vl_positions(batch, seq,
                                                              grid),
                                                 device="cuda")
            out.append(b)
        return out
    return make


def a17_kernel_phase(card):
    """B1 (one-query decode) and B4 (k = 4 verify) at musicgen-medium's
    layout (24/24 heads, hd 64: MHA, one live row of each 16-row tile),
    bf16 and int8 pools, against the plain version, timed beside SDPA and
    the bound (rows for the kernels line; the musicgen runs set their
    launches, no musicgen run uses int8 pools). Then, untimed, both at
    qwen2-vl-2b's (12/2, hd 128) and phi4-mini-3.8b's (24/8, hd 128)
    layouts, bf16, f32 and int8, against the plain version."""
    lens = [int(x) for x in np.linspace(4, 16 * 128, 8)]
    rows = _layout_rows(card, "musicgen-medium", MUSICGEN_LAYOUT, None, lens,
                        5, ("src/repro/kernels/paged_attention/kernel.py:52",
                            "src/repro/kernels/paged_attention/kernel.py:101"))
    for i, (arch, layout) in enumerate(A17_LAYOUTS.items()):
        _layout_rows(card, arch, layout, None, lens, 6 + i, None, timed=False)
    return list(rows.values())


def a17_parity_phase(card):
    """f32, TF32 off, cuda against cpu from the same weights. The engine
    (plain, n-gram k = 4, int8 pools; each paged kernel once per layer a
    step) for reduced qwen2-vl-2b, musicgen-medium and phi4-mini-3.8b:
    tokens equal. Then qwen2-vl-2b at full width cut to A17_PARITY_LAYERS
    layers (12/2 heads, hd 128: M-RoPE's sections 16/24/24): the engine,
    tokens equal; and 2 Adam steps on stub embeddings with DISTINCT t / h /
    w streams (a 1 x 8 x 8 patch grid, then text; vl_positions), the first
    with accum_steps = 2 (the microbatches cut the positions on axis 1):
    losses within TRAIN_PARITY_TOL a step, B6 on cuda only."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import transformer as T
    from repro_torch.optim import make_optimizer
    from repro_torch.serving.engine import KVQuantConfig, SpecConfig
    from repro_torch.train.trainer import make_train_step
    from repro_torch.tree import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ek = dict(block_size=4, num_blocks=64, max_blocks_per_seq=12,
              max_slots=3, prefill_chunk=8)
    rng = np.random.default_rng(71)
    modes = (("plain", {}), ("ngram k=4", dict(spec=SpecConfig(k=4))),
             ("int8", dict(kv_quant=KVQuantConfig())))
    full = dataclasses.replace(get_config("qwen2-vl-2b"), dtype="float32",
                               num_layers=A17_PARITY_LAYERS)
    cfgs = [dataclasses.replace(reduced(get_config(arch)), dtype="float32")
            for arch in ("qwen2-vl-2b", "musicgen-medium", "phi4-mini-3.8b")]
    for cfg in cfgs + [full]:
        params = T.init_params(cfg, seed=0, device="cpu")
        dp = {"cpu": params, "cuda": _tree_to(params, "cuda")}
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                   for n in (5, 17, 9, 30)]
        news = (8, 6, 10, 12)
        _engine_parity(cfg, dp, modes if cfg is not full else modes[:1], ek,
                       prompts, news)
        print(f"parity {cfg.name} (f32, {cfg.num_layers} layers, "
              f"{cfg.num_heads}/{cfg.num_kv_heads} heads, hd "
              f"{cfg.resolved_head_dim}): cuda engine tokens == cpu, "
              + ("plain" if cfg is full else "plain / n-gram k=4 / int8 pools")
              + f", each paged kernel once per layer a step | {card}")
    # training with distinct streams, the first step accumulated
    B, S = 2, 128
    batches = []
    for i in range(2):
        r = np.random.default_rng(80 + i)
        batches.append({
            "embeds": (r.standard_normal((B, S, full.d_model)) * 0.5
                       ).astype(np.float32),
            "positions": vl_positions(B, S, 8),
            "labels": r.integers(0, full.vocab_size, (B, S)).astype(np.int64)})
    losses, b6 = {}, {}
    for dev in ("cpu", "cuda"):
        opt = make_optimizer("adam", lr=3e-4, grad_clip=1.0)
        p = tree_map(lambda t: t.clone().to(dev), params)
        state = {"params": p, "opt": opt.init(p)}
        kernels.reset_launch_counts()
        losses[dev] = []
        for accum, b in zip((2, 1), batches):
            state, metrics = make_train_step(full, opt, accum_steps=accum)(
                state, b)
            losses[dev].append(float(metrics["loss"]))
        b6[dev] = kernels.launch_counts["flash_attention"]
        del state, p
    diff = max(abs(a - b) for a, b in zip(losses["cpu"], losses["cuda"]))
    check(all(map(math.isfinite, losses["cuda"])) and diff <= TRAIN_PARITY_TOL,
          f"qwen2-vl-2b train parity: cuda {losses['cuda']} vs cpu "
          f"{losses['cpu']} (max diff {diff} > {TRAIN_PARITY_TOL})")
    # remat on: forward and recompute, per layer, per microbatch
    want = 2 * full.num_layers * 3
    check(b6["cpu"] == 0 and b6["cuda"] == want,
          f"qwen2-vl-2b train parity: B6 launches {b6} (cuda want {want})")
    print(f"train parity {full.name} ({full.num_layers} layers at full width, "
          f"f32, remat, Adam; stub embeds {B} x {S}, a 1 x 8 x 8 patch grid "
          f"then text, distinct t/h/w streams; step 1 with accum_steps = 2): "
          f"cuda losses {losses['cuda']} vs cpu {losses['cpu']}, max diff "
          f"{diff:.3e} (tol {TRAIN_PARITY_TOL}), B6 launches {b6['cuda']} | "
          f"{card}")
    del dp, params
    _release_card()


def a17_main_phase(card, arch, layers, modes, kernel_rows=(), profile=False):
    """An A17 config at full width, bf16, seeded random weights made on the
    card, cut to `layers` layers, through the port's Engine: 8 requests of
    64-512 prompt tokens (A17_LENS) and 32 new each, in each of `modes`:
    "plain", "ngram k=4" (B4), "int8" (B1+B3), "preempted" (request 0
    forcibly preempted after 3 decode steps). Every request finishes,
    logits stay finite, tokens lie in the vocabulary, no block leaks, and
    the paged kernel runs once per layer a decode / verify step. bf16
    agreement with the plain run is printed, not gated. `kernel_rows`:
    rows whose name is "<key> @ <arch>" take their launches from these
    runs (0 if no run launched them). With `profile`, where_time_goes over
    the plain decode window."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import Engine, EngineConfig
    _release_card()
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=layers)
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"{arch}: weights ({cfg.param_count() / 1e9:.2f} B params = "
          f"{2 * cfg.param_count() / 1e9:.1f} GB bf16, {cfg.num_layers} of "
          f"{full.num_layers} layers, {cfg.num_heads}/{cfg.num_kv_heads} "
          f"heads, hd {cfg.resolved_head_dim}, rope {cfg.rope_mode}) made on "
          f"the card in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(91)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in A17_LENS]
    news = [32] * len(prompts)
    ecfg = EngineConfig(block_size=16, num_blocks=320, max_blocks_per_seq=40,
                        max_slots=8, prefill_chunk=512, prefills_per_step=8,
                        step_timing=True)
    _serve_variants(card, arch, cfg, params, ecfg, prompts, news, modes,
                    kernel_rows, modes[1:], "bf16 prefill, decode and K-row "
                    "verify round differently")
    if profile:
        fast = Engine(cfg, params, dataclasses.replace(ecfg,
                                                       step_timing=False))
        where_time_goes(card, fast, [p[:64] for p in prompts], news, warm=2,
                        window=4, label=f"{arch} decode")
        del fast
    del params
    _release_card()


# ---------------------------------------- phase 9: sharding plans (A15)
PLAN_ARCHS = ("yi-9b", "qwen3-moe-30b-a3b")


def _one_rank_mesh(device):
    """A one-rank default group (launch/mesh.py: gloo for cpu, nccl for
    cuda) and a (1, 1) ("data", "model") DeviceMesh over it."""
    from repro_torch.launch.mesh import make_host_mesh
    return make_host_mesh((1, 1), ("data", "model"), device)


def _plan_cfg(arch):
    """Reduced f32 configs of the parity checks; qwen3-moe at capacity
    factor 1.0, where its experts overflow."""
    from repro_torch.configs import get_config, reduced
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32",
                              remat=False)
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=1.0)
    return cfg


def _plan_losses(cfg, params, batches, dev, plan):
    """Losses of Adam steps (lr 3e-4, clip 1.0) from a copy of `params` on
    `dev`, planned by `plan` (None: the unplanned step); with B6's and
    moe_apply_ep's calls over them."""
    from repro_torch import kernels
    from repro_torch.optim import make_optimizer
    from repro_torch.train import trainer
    from repro_torch.tree import tree_map
    opt = make_optimizer("adam", lr=3e-4, grad_clip=1.0)
    p = tree_map(lambda t: t.clone().to(dev), params)
    state = {"params": p, "opt": opt.init(p)}
    if plan is None:
        step = trainer.make_train_step(cfg, opt)
    else:
        step, state, _ = trainer.jit_train_step(cfg, opt, plan, state)
    kernels.reset_launch_counts()
    _EP_CALLS[0] = 0
    losses = []
    for b in batches:
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))
    return losses, kernels.launch_counts["flash_attention"], _EP_CALLS[0]


_EP_CALLS = [0]
_DROPS = [0]


def _plan_spies():
    """Count moe_apply_ep's calls and the expert assignments dropped at
    capacity (inside moe_apply_ep the last local id is the discard bin, not
    an expert). Returns the function that removes the spies."""
    import torch
    from repro_torch.core import parallelism as par
    from repro_torch.models import moe as M
    ep, slots = M.moe_apply_ep, M._slots
    inside = [False]

    def counted(*a, **k):
        _EP_CALLS[0] += 1
        inside[0] = True
        try:
            return ep(*a, **k)
        finally:
            inside[0] = False

    def spied(flat_e, E, C):
        expert, slot, keep = slots(flat_e, E, C)
        real = flat_e < (E - 1 if inside[0] else E)
        _DROPS[0] += int(torch.sum(real & ~par.full(keep)))
        return expert, slot, keep

    def restore():
        M.moe_apply_ep, M._slots = ep, slots
    M.moe_apply_ep, M._slots = counted, spied
    return restore


def plan_parity_phase(card):
    """(a) Reduced f32 yi-9b and qwen3-moe-30b-a3b (capacity factor 1.0,
    an overflow asserted), 2 Adam steps under each of the seven plans on a
    (1, 1) mesh: the losses within TRAIN_PARITY_TOL of the unplanned cuda
    steps and of the same plan on a one-rank gloo cpu group (made, then
    destroyed, before the nccl group: a process holds one default group at
    a time); moe_apply_ep called under every plan with tensor axes and
    never under dp; B6 launching as often as in the unplanned steps. Then
    pipeline_forward at S = 1 on cuda against the sequential stack.
    Returns the cuda mesh (its nccl group stays up for the next phases)."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import parallelism as par
    from repro_torch.core import pipeline as PL
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    restore = _plan_spies()
    try:
        cfgs = {a: _plan_cfg(a) for a in PLAN_ARCHS}
        params = {a: T.init_params(c, seed=0, device="cpu")
                  for a, c in cfgs.items()}
        batches = {a: list(SyntheticLM(c.vocab_size, 64, seed=0)
                           .batches(2, 2)) for a, c in cfgs.items()}
        ref = {a: _plan_losses(cfgs[a], params[a], batches[a], "cuda", None)
               for a in PLAN_ARCHS}
        cpu = {}
        mesh = _one_rank_mesh("cpu")
        try:
            for a in PLAN_ARCHS:
                for name in par.PLANS:
                    cpu[a, name] = _plan_losses(
                        cfgs[a], params[a], batches[a], "cpu",
                        par.make_plan(name, mesh))[0]
        finally:
            dist.destroy_process_group()
        mesh = _one_rank_mesh("cuda")
        for a in PLAN_ARCHS:
            for name in par.PLANS:
                plan = par.make_plan(name, mesh)
                _DROPS[0] = 0
                got, b6, ep = _plan_losses(cfgs[a], params[a], batches[a],
                                           "cuda", plan)
                want, want_b6, _ = ref[a]
                diff = max(max(abs(x - y) for x, y in zip(got, want)),
                           max(abs(x - y) for x, y in zip(got, cpu[a, name])))
                check(all(map(math.isfinite, got))
                      and diff <= TRAIN_PARITY_TOL,
                      f"plan parity {a} {name}: cuda {got} vs unplanned "
                      f"{want} and cpu {cpu[a, name]}")
                check(b6 == want_b6, f"plan parity {a} {name}: B6 launches "
                      f"{b6} != unplanned {want_b6}")
                if cfgs[a].num_experts:
                    check((ep > 0) == bool(plan.tensor_axes),
                          f"plan parity {a} {name}: moe_apply_ep called "
                          f"{ep} times with tensor axes {plan.tensor_axes}")
                    check(_DROPS[0] > 0, f"plan parity {a} {name}: no "
                          f"expert assignment dropped at capacity 1.0")
                print(f"plan parity {cfgs[a].name} (f32, {name}, (1, 1) "
                      f"mesh, Adam, 2 steps): cuda losses {got} vs unplanned "
                      f"{want} and cpu {cpu[a, name]}, max diff {diff:.3e} "
                      f"(tol {TRAIN_PARITY_TOL}); B6 launches {b6} "
                      f"(unplanned {want_b6}); moe_apply_ep calls {ep}; "
                      f"assignments dropped {_DROPS[0]} | {card}")
    finally:
        restore()
    from torch.distributed.device_mesh import init_device_mesh
    smesh = init_device_mesh("cuda", (1,), mesh_dim_names=("stage",))
    gen = torch.Generator().manual_seed(3)
    w = (torch.randn(1, 64, 64, generator=gen) * 0.3).cuda()
    b = (torch.randn(1, 64, generator=gen) * 0.1).cuda()
    x = torch.randn(8, 4, 64, generator=gen).cuda()
    out = PL.pipeline_forward(lambda p, t: torch.tanh(t @ p["w"] + p["b"]),
                              {"w": w, "b": b}, x, smesh)
    want = torch.tanh(x @ w[0] + b[0])
    err = float((out - want).abs().max())
    check(err <= 2e-5 and PL.counts["rounds"] == 8
          and PL.counts["hops"] == 0,
          f"pipeline_forward S=1: err {err}, counts {PL.counts}")
    print(f"plan parity: pipeline_forward 1 stage x 8 microbatches on cuda "
          f"== the sequential stack (max err {err:.2e}; {PL.counts['rounds']} "
          f"rounds, {PL.counts['hops']} hops) | {card}")
    return mesh


def _plan_train_turns(card, mesh, arch, layers, batch, seq):
    """(b) `arch` at full width cut to `layers` layers, batch x seq, Adam
    (lr 3e-4, clip 1.0) with remat, unplanned and under dp_tp on the (1, 1)
    mesh over the same tensors (a one-rank DTensor wraps its local
    tensor), in turns unplanned, dp_tp, dp_tp, unplanned after one warm-up
    step each: step ms and peak GiB of each, finite losses, B6 twice per
    attention layer a step in both; under dp_tp an MoE layer takes
    moe_apply_ep."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core import parallelism as par
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import state_providers as SP
    from repro_torch.models import transformer as T
    from repro_torch.optim import make_optimizer
    from repro_torch.train import trainer
    _release_card()
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=layers)
    n_sb, _ = SP.superblock_layout(cfg)
    per_step = 2 * n_sb * sum(k in T._ATTN_KINDS for k in SP.layer_kinds(cfg))
    opt = make_optimizer("adam", lr=3e-4, grad_clip=1.0)
    state = trainer.init_state(cfg, opt, seed=0)
    plan = par.make_plan("dp_tp", mesh)
    steps = {"unplanned": trainer.make_train_step(cfg, opt)}
    steps["dp_tp"], pstate, _ = trainer.jit_train_step(cfg, opt, plan, state)
    states = {"unplanned": state, "dp_tp": pstate}
    batches = list(SyntheticLM(cfg.vocab_size, seq, seed=0).batches(batch, 6))
    turns = ["unplanned", "dp_tp", "unplanned", "dp_tp", "dp_tp",
             "unplanned"]
    restore = _plan_spies()
    rec = {"unplanned": [], "dp_tp": []}
    try:
        for i, (turn, b) in enumerate(zip(turns, batches)):
            kernels.reset_launch_counts()
            _EP_CALLS[0] = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            states[turn], metrics = steps[turn](states[turn], b)
            loss = float(metrics["loss"])
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) * 1e3
            peak = torch.cuda.max_memory_allocated() / 2**30
            n = kernels.launch_counts["flash_attention"]
            check(math.isfinite(loss), f"plan train {arch} {turn}: loss "
                  f"{loss}")
            check(n == per_step, f"plan train {arch} {turn}: B6 launches "
                  f"{n} != {per_step}")
            if cfg.num_experts:
                check((_EP_CALLS[0] > 0) == (turn == "dp_tp"),
                      f"plan train {arch} {turn}: moe_apply_ep calls "
                      f"{_EP_CALLS[0]}")
            what = "warm-up" if i < 2 else "timed"
            print(f"plan train {arch} ({layers} of {full.num_layers} layers, "
                  f"{batch} x {seq}, remat) {turn} {what}: loss {loss:.4f}, "
                  f"{dt:.1f} ms, peak {peak:.2f} GiB, B6 launches {n}, "
                  f"moe_apply_ep calls {_EP_CALLS[0]} | {card}")
            if i >= 2:
                rec[turn].append((dt, peak))
    finally:
        restore()
    summary = {k: (float(np.median([d for d, _ in v])),
                   max(p for _, p in v)) for k, v in rec.items()}
    print(f"plan train {arch}: step ms unplanned "
          f"{summary['unplanned'][0]:.1f} vs dp_tp {summary['dp_tp'][0]:.1f} "
          f"(x{summary['dp_tp'][0] / summary['unplanned'][0]:.3f}); peak GiB "
          f"{summary['unplanned'][1]:.2f} vs {summary['dp_tp'][1]:.2f} "
          f"(2 timed steps each, in turns) | {card}")
    del states, steps, state, pstate
    _release_card()


PLAN_SERVE_LAYERS = 16   # of yi-9b's 48: the plan's cost is per layer


def _plan_serve(card, mesh):
    """(c) yi-9b at full width cut to PLAN_SERVE_LAYERS layers (bf16)
    through the Engine unplanned and with Engine(plan=dp_tp) on the (1, 1)
    mesh, in turns unplanned, dp_tp, dp_tp, unplanned: 8 mixed requests
    with 32 new tokens each; tokens/s and TPOT p50 of each (step_timing),
    B1 == decode steps x layers in both, bf16 token agreement printed; the
    device busy share of both from a profile of 4 engine steps. Then yi-9b
    in f32 cut to 2 layers: the planned engine's tokens equal the
    unplanned engine's."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import parallelism as par
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.serving.workloads import mixed_workload
    _release_card()
    cfg = dataclasses.replace(get_config("yi-9b"),
                              num_layers=PLAN_SERVE_LAYERS)
    params = T.init_params(cfg, seed=0, device="cuda")
    ecfg = EngineConfig(block_size=16, num_blocks=1024, max_blocks_per_seq=128,
                        max_slots=8, prefill_chunk=256, step_timing=True)
    prompts, _ = mixed_workload(n=8, seed=0, vocab=cfg.vocab_size)
    news = [32] * len(prompts)
    plan = par.make_plan("dp_tp", mesh)
    wave = [[(p, m, 0) for p, m in zip(prompts, news)]]
    res = {"unplanned": [], "dp_tp": []}
    for turn in ("unplanned", "dp_tp", "dp_tp", "unplanned"):
        eng = Engine(cfg, params, ecfg,
                     plan=plan if turn == "dp_tp" else None)
        r = _timed_run(card, eng, f"plan serve yi-9b {turn}", wave)
        b1 = r["launches"]["paged_attention"]
        check(b1 == r["steps"] * cfg.num_layers,
              f"plan serve {turn}: B1 launches {b1} != {r['steps']} x "
              f"{cfg.num_layers}")
        res[turn].append(r)
        del eng
        _release_card()
    same = sum(a == b for a, b in zip(res["unplanned"][0]["outs"],
                                      res["dp_tp"][0]["outs"]))
    busy = {}
    for turn in ("unplanned", "dp_tp"):
        eng = Engine(cfg, params, dataclasses.replace(ecfg, step_timing=False),
                     plan=plan if turn == "dp_tp" else None)
        busy[turn] = where_time_goes(card, eng, prompts, news, warm=3,
                                     window=4, label=f"yi-9b {turn}")
        del eng
        _release_card()

    def med(turn, key):
        return float(np.median([r[key] for r in res[turn]]))
    print(f"plan serve yi-9b ({cfg.num_layers} layers, bf16, {len(prompts)} "
          f"requests x {news[0]} new): tok/s "
          f"unplanned {med('unplanned', 'tok_s'):.2f} vs dp_tp "
          f"{med('dp_tp', 'tok_s'):.2f}; TPOT p50 "
          f"{med('unplanned', 'tpot_p50'):.2f} vs "
          f"{med('dp_tp', 'tpot_p50'):.2f} ms (x"
          f"{med('dp_tp', 'tpot_p50') / med('unplanned', 'tpot_p50'):.2f}); "
          f"device busy {_share(busy['unplanned'])} vs "
          f"{_share(busy['dp_tp'])} (profiles of 4 steps); bf16 tokens "
          f"equal on {same} of {len(prompts)} requests | {card}")
    del params
    _release_card()
    f32 = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    params = T.init_params(f32, seed=0, device="cuda")
    small = dataclasses.replace(ecfg, step_timing=False)
    outs = []
    for pl in (None, plan):
        eng = Engine(f32, params, small, plan=pl)
        rids = [eng.add_request(p, m) for p, m in zip(prompts, news)]
        got = eng.drain()
        outs.append([got[r].tolist() for r in rids])
    check(outs[0] == outs[1], "plan serve f32: dp_tp tokens != unplanned")
    print(f"plan serve yi-9b f32 (2 layers): Engine(plan=dp_tp) tokens == "
          f"unplanned on all {len(prompts)} requests | {card}")
    del params
    _release_card()


def _share(x):
    return "not measured" if x is None else f"{x:.1%}"


def plan_phase(card):
    """The sharding plans (core/parallelism.py on DTensor) on the card: a
    one-rank nccl group and a (1, 1) ("data", "model") mesh (one H100: the
    multi-rank runs are the CPU tests'); (a) plan_parity_phase, (b)
    yi-9b (8 of 48 layers, 2 x 4096) and qwen3-moe-30b-a3b (2 layers, 1 x
    4096) training under dp_tp beside the unplanned step, (c) yi-9b
    serving under Engine(plan=dp_tp) beside the unplanned engine."""
    import torch.distributed as dist
    mesh = plan_parity_phase(card)
    try:
        _plan_train_turns(card, mesh, "yi-9b", TRAIN_LAYERS, 2, 4096)
        _plan_train_turns(card, mesh, "qwen3-moe-30b-a3b", 2, 1, 4096)
        _plan_serve(card, mesh)
    finally:
        dist.destroy_process_group()


# ------------------------------------------ phase 10: the dry run (A15/A16)
# (arch, shape, what the record must show): the card's path traced on fake
# tensors on rank 0 of a fake 256-rank group (the 16 x 16 mesh), dp_tp.
# phi4-mini's 24 query heads and mixtral's 8 experts do not divide the
# 16-way 'model' axis; mixtral's record ("reference") is held to
# MODEL_FLOPS / counted >= MIN_MOE_RATIO and to at most REF_HBM_TOL times
# the HBM a device that the reference's own record needs,
# MIXTRAL_REF_HBM (`python -m repro.launch.dryrun --arch mixtral-8x7b
# --shape train_4k --mesh single --plan dp_tp`, JAX on the CPU: 0.575 of
# MODEL_FLOPS counted, and it does not fit the card's memory either)
DRYRUN_COMBOS = (("mixtral-8x7b", "train_4k", "reference"),
                 ("phi4-mini-3.8b", "train_4k", "ok"),
                 ("yi-9b", "train_4k", "ok"),
                 ("rwkv6-7b", "decode_32k", "fits"),
                 ("phi4-mini-3.8b", "long_500k", "skipped"))
MIXTRAL_REF_HBM = 109_926_633_984
REF_HBM_TOL = 1.10
MIN_MOE_RATIO = 0.40
SUBPROCESS_TIMEOUT = 600


def _run_together(cmds, timeout):
    """Each of `cmds` (argument lists) as a subprocess from the repository
    root, all started together, each writing to a log of its own; what
    still runs `timeout` s after the start is killed. Returns (exit code,
    None if killed; seconds from the start to its end; its output) for
    each."""
    import os
    import tempfile
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="smoke-") as tmp:
        logs = [open(Path(tmp) / f"{i}.log", "w+") for i in range(len(cmds))]
        procs = [subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                  env=env, cwd=ROOT)
                 for cmd, log in zip(cmds, logs)]
        ends = [None] * len(procs)
        try:
            while None in ends and time.perf_counter() - t0 < timeout:
                for i, proc in enumerate(procs):
                    if ends[i] is None and proc.poll() is not None:
                        ends[i] = time.perf_counter() - t0
                time.sleep(0.2)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                proc.wait()
        results = []
        for proc, log, end in zip(procs, logs, ends):
            log.seek(0)
            results.append((None if end is None else proc.returncode, end,
                            log.read()))
            log.close()
    return results


def dryrun_and_examples_phase(card):
    """Phases 10 and 11, their subprocesses all started together (each
    waits on processes; the host's cores are shared and no kernel is
    timed), each with a time limit of SUBPROCESS_TIMEOUT s."""
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="dryrun-") as tmp:
        records = [Path(tmp) / f"{arch}__{shape}.json"
                   for arch, shape, _ in DRYRUN_COMBOS]
        cmds = [[sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 arch, "--shape", shape, "--mesh", "single", "--plan",
                 "dp_tp", "--device", "cuda", "--out", str(path)]
                for (arch, shape, _), path in zip(DRYRUN_COMBOS, records)]
        cmds += [[sys.executable, str(ROOT / "examples" / f"{name}_torch.py"),
                  *argv] for name, argv, _, _ in EXAMPLES]
        results = _run_together(cmds, SUBPROCESS_TIMEOUT)
        failed = _check_dryruns(card, records, results[:len(DRYRUN_COMBOS)])
    failed += _check_examples(card, results[len(DRYRUN_COMBOS):])
    check(not failed, f"dry runs or examples failed: {failed}")
    print(f"dryrun and examples: {len(cmds)} processes in "
          f"{time.perf_counter() - t0:.1f} s (in parallel) | {card}")


def _check_dryruns(card, records, results):
    """Phase 10: ``python -m repro_torch.launch.dryrun`` on the card
    (device cuda), one process per combo (the fake group is
    process-wide): yi-9b and phi4-mini-3.8b train_4k under dp_tp on the
    16 x 16 mesh (status ok, 256 chips, B6's custom op reached once a
    forward per attention layer: twice with remat), mixtral-8x7b train_4k
    (ok, B6 as those, MODEL_FLOPS / counted at least MIN_MOE_RATIO and
    HBM needed within REF_HBM_TOL of the reference's record),
    rwkv6-7b decode_32k (ok, fits the card's memory) and phi4-mini-3.8b
    long_500k (skipped: full attention); each
    ok record's ``launches`` (the kernels its trace launched) all 0. The 2
    x 16 x 16 multi-pod mesh is left out: DTensor's sharding propagation
    over its three mesh dims made one decode trace take 392 s on a CPU
    (33x the 16 x 16 mesh's). Prints each record's roofline terms, memory
    needed and trace time; returns the combos that failed."""
    from repro_torch.configs import get_config
    from repro_torch.models import state_providers as SP
    from repro_torch.models import transformer as T
    failed = []
    for (arch, shape, want), path, (rc, secs, text) in zip(
            DRYRUN_COMBOS, records, results):
        label = f"dryrun {arch} {shape} single dp_tp"
        if rc != 0:
            status = (f"killed at the {SUBPROCESS_TIMEOUT} s limit"
                      if rc is None else f"exited {rc}")
            print(f"{label}: {status}:\n{text[-3000:]}")
            failed.append(label)
            continue
        rec = json.loads(path.read_text())
        if want == "skipped":
            check(rec["status"] == "skipped", f"{label}: {rec}")
            print(f"{label}: skipped ({rec['reason'][:60]}...)")
            continue
        check(rec["status"] == "ok" and rec["chips"] == 256
              and rec["device"] == "cuda", f"{label}: {rec}")
        check(not any(rec["launches"].values()),
              f"{label}: the trace launched kernels {rec['launches']}")
        ratio = rec["useful_flops_ratio"]
        t = rec["roofline"]
        print(f"{label}: per device flops {rec['flops_per_device']:.4e}, HBM "
              f"bytes {rec['bytes_per_device']:.4e}, collective bytes "
              f"{rec['collective_bytes_per_device']:.4e} "
              f"{json.dumps(rec['collectives']['counts'])}; roofline on the "
              f"H100 entry: compute {t['compute_s']:.6f} s, memory "
              f"{t['memory_s']:.6f} s, collective {t['collective_s']:.6f} s "
              f"({rec['dominant']}); MODEL_FLOPS / counted "
              f"{ratio}; HBM needed {rec['hbm_needed_per_device']} B "
              f"(fits {rec['fits_hbm']}; memory {json.dumps(rec['memory'])}); "
              f"kernel calls {rec['kernel_calls']}; trace {rec['trace_s']} s, "
              f"ended {secs:.1f} s after the start | {card}")
        check(ratio is not None and math.isfinite(ratio) and ratio > 0,
              f"{label}: useful_flops_ratio {ratio}")
        if want == "fits":
            check(rec["fits_hbm"] is True, f"{label}: needs "
                  f"{rec['hbm_needed_per_device']} B of the card's")
        if want == "reference":
            check(ratio >= MIN_MOE_RATIO, f"{label}: MODEL_FLOPS / counted "
                  f"{ratio} < {MIN_MOE_RATIO}")
            check(rec["hbm_needed_per_device"]
                  <= REF_HBM_TOL * MIXTRAL_REF_HBM,
                  f"{label}: needs {rec['hbm_needed_per_device']} B, more "
                  f"than {REF_HBM_TOL} x the reference's {MIXTRAL_REF_HBM}")
        cfg = get_config(arch)
        n_sb, _ = SP.superblock_layout(cfg)
        n_attn = n_sb * sum(k in T._ATTN_KINDS for k in SP.layer_kinds(cfg))
        if shape == "train_4k":
            calls = rec["kernel_calls"].get("flash_attention_fwd", 0)
            want_calls = n_attn * (2 if cfg.remat else 1)
            check(calls == want_calls, f"{label}: B6 reached {calls} times, "
                  f"want {want_calls} ({n_attn} attention layers, remat "
                  f"{cfg.remat})")
    return failed


ANALYSIS_LAYERS = TRAIN_LAYERS     # yi-9b at the training shape, 8 of 48
PEAK_TOL = 0.10


def analysis_phase(card):
    """core/op_analysis.py on one card, no plan: yi-9b at full width cut to
    ANALYSIS_LAYERS layers, batch 2 x 4096, Adam, remat (the training main
    path's shape). One train step is traced on fake CUDA tensors, then the
    same step runs for real under the analysis. Gates: equal flops and HBM
    bytes; B6's custom-op calls equal its launches; the predicted peak
    (argument + temp + output - alias) within PEAK_TOL of
    torch.cuda.max_memory_allocated() over the step, less the bytes held
    before the state was made. Prints (no gate) the H100 roofline time
    beside a plain step's measured ms."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core import costmodel as cm
    from repro_torch.core import op_analysis as oa
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.specs import fake_mode
    from repro_torch.optim import make_optimizer
    from repro_torch.train import trainer
    _release_card()
    cfg = dataclasses.replace(get_config("yi-9b"), num_layers=ANALYSIS_LAYERS)
    opt = make_optimizer("adam", lr=3e-4, grad_clip=1.0)
    step = trainer.make_train_step(cfg, opt)
    host = next(SyntheticLM(cfg.vocab_size, 4096, seed=0).batches(2, 1))
    t0 = time.perf_counter()
    with fake_mode() as mode:
        fstate = trainer.init_state(cfg, opt, device="cuda")
        fbatch = {k: torch.empty(v.shape, dtype=torch.int64, device="cuda")
                  for k, v in host.items()}
        fake = oa.analyze(step, fstate, fbatch)
    del fstate, fbatch, mode
    trace_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    state = trainer.init_state(cfg, opt, device="cuda")
    batch = {k: torch.as_tensor(v, device="cuda").long()
             for k, v in host.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches = kernels.launch_counts["flash_attention"]
    t0 = time.perf_counter()
    (state, metrics), an = oa.run(step, state, batch)
    loss = float(metrics["loss"])
    torch.cuda.synchronize()
    real_s = time.perf_counter() - t0
    measured = torch.cuda.max_memory_allocated() - base
    launches = kernels.launch_counts["flash_attention"] - launches
    real = an.result()
    del metrics
    check(math.isfinite(loss), f"analysis: loss {loss}")
    check(fake["flops"] == real["flops"]
          and fake["hbm_bytes"] == real["hbm_bytes"],
          f"analysis: fake trace flops {fake['flops']} / bytes "
          f"{fake['hbm_bytes']} != real run {real['flops']} / "
          f"{real['hbm_bytes']}")
    calls = real["kernel_calls"].get("flash_attention_fwd", 0)
    check(calls == launches == fake["kernel_calls"].get(
              "flash_attention_fwd", 0) == 2 * cfg.num_layers,
          f"analysis: B6 calls {calls} (fake "
          f"{fake['kernel_calls']}) vs launches {launches}")
    mem = fake["memory"]
    predicted = (mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
                 + mem["output_size_in_bytes"] - mem["alias_size_in_bytes"])
    err = predicted / measured - 1
    print(f"analysis: yi-9b {cfg.num_layers} of 48 layers, 2 x 4096, Adam, "
          f"remat: flops {fake['flops']:.6e} (real run {real['flops']:.6e}), "
          f"HBM bytes {fake['hbm_bytes']:.6e} ({real['hbm_bytes']:.6e}); "
          f"B6 calls {calls} == launches {launches}; fake trace {trace_s:.1f} "
          f"s, real step under the analysis {real_s * 1e3:.1f} ms | {card}")
    print(f"analysis: memory (fake) {json.dumps(mem)}; (real run) "
          f"{json.dumps(real['memory'])}; predicted peak {predicted} B "
          f"({predicted / 2**30:.3f} GiB) vs max_memory_allocated over the "
          f"step less the bytes held before the state {measured} B "
          f"({measured / 2**30:.3f} GiB): {err:+.2%} (tol "
          f"{PEAK_TOL:.0%}) | {card}")
    check(abs(err) <= PEAK_TOL, f"analysis: predicted peak {predicted} vs "
          f"measured {measured} ({err:+.2%})")
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    terms = cm.roofline_terms(fake["flops"], fake["hbm_bytes"], 0.0, 1,
                              hw=cm.H100)
    bound = max(terms["compute_s"], terms["memory_s"]) * 1e3
    print(f"analysis: roofline on the H100 entry {bound:.1f} ms (compute "
          f"{terms['compute_s'] * 1e3:.1f} ms, memory "
          f"{terms['memory_s'] * 1e3:.1f} ms) beside the step without the "
          f"analysis {times[-1]:.1f} ms (first {times[0]:.1f} ms): "
          f"{bound / times[-1]:.1%} of it | {card}")
    del state, batch
    _release_card()


NO_SPILL = {"flash_attention": r"flash_fwd_bf16ILi(64|80|128)E",
            "matmul": r"matmul_(bf16_)?kernel",
            "paged_attention": r"paged_decode_tcILi(64|80|128|256)E"}
# their instantiations by mangled template arguments, for the summary
TC_KERNELS = {"flash_attention": (r"flash_fwd_bf16ILi(\d+)E", "width"),
              "matmul": (r"matmul_(bf16_|)kernelI(\w+?)E", "input, output"),
              "paged_attention": (
                  r"paged_decode_tcILi(\d+)E(a|13__nv_bfloat16)Lb([01])E",
                  "width, pool, mode")}
TC_NAMES = {"f": "f32", "13__nv_bfloat16": "bf16", "a": "int8", "0": "full",
            "1": "ring", "bf16_": "bf16", "": "f32"}


# ------------------------------------------------ phase 11: the examples
# (example, arguments, lines it must print, kernels that must launch): the
# three card runs at the reference's sizes; the pipeline on 4 gloo ranks on
# the host (its 4-card run needs a machine with 4 cards)
EXAMPLES = (
    ("quickstart", (), ("arch=yi-9b-reduced params=", "step  90  loss ",
                        "checkpoint roundtrip ok (step 100)",
                        "greedy continuation: ["), ("B6",)),
    ("serve_demo", (), (
        "legacy static batch: copy accuracy",
        "engine (mixed lengths x4): copy accuracy",
        "engine replay with prefix caching:", "outputs bit-identical",
        "distinct step signatures:", "(TTFTs match live)",
        'engine_request_ttft_seconds{quantile="0.5"}',
        "engine oversubscription wave x4:",
        "was evicted mid-flight and resumed",
        "engine speculative wave (n-gram self-drafting, k=6) x4:",
        "engine hybrid wave (mamba2 slabs + paged shared attention) x4: "
        "outputs bit-identical to serve.generate"), ("B1", "B4", "B6")),
    ("compression_comparison", ("--ranks", "1"), (
        "1 data-parallel rank(s), nccl, 60 batches", "none     first5=",
        "int8     first5=", "onebit   first5=", "topk     first5="),
     ("B9",)),
    ("pipeline_training", ("--device", "cpu"), (
        "ran 4 stages on 4 gloo ranks on the host",
        "pipeline output matches sequential: maxerr=",
        "stages=4 microbatches=8: 11 rounds"), ()),
)


def _launches(line):
    """{"B1": n, ...} of an example's last line, ``kernels: B1=n ...``."""
    check(line.startswith("kernels: "), f"no launch line: {line!r}")
    return {k: int(v) for k, v in
            (kv.split("=") for kv in line.split()[1:])}


def _check_examples(card, results):
    """Phase 11: the four ``examples/*_torch.py``: quickstart, serve_demo
    and compression_comparison --ranks 1 on the card at the reference's
    sizes, pipeline_training with --device cpu (4 gloo ranks on the host;
    its 4-card run needs a machine with 4 cards). Each must exit 0, print
    its reference lines and launch its kernels (B6 in quickstart; B1, B4
    and B6 in serve_demo; B9 in the compression comparison), counted from
    0 in its own process. Returns the examples that failed."""
    failed = []
    for (name, argv, lines, kernels), (rc, secs, text) in zip(EXAMPLES,
                                                               results):
        label = f"example {name}_torch.py {' '.join(argv)}".rstrip()
        missing = [ln for ln in lines if ln not in text]
        if rc != 0 or missing:
            status = (f"killed at the {SUBPROCESS_TIMEOUT} s limit"
                      if rc is None else f"exited {rc}")
            print(f"{label}: {status}, missing {missing}:\n{text[-3000:]}")
            failed.append(label)
            continue
        out = [ln for ln in text.splitlines() if ln.strip()
               and "Warning" not in ln and "warn(" not in ln]
        counts = _launches(out[-1])
        print(f"{label}: ok, ended {secs:.1f} s after the start; "
              f"{out[-1]} | {card}")
        for ln in out[:-1]:
            if ln.startswith(("step ", "legacy", "engine", "none ", "int8 ",
                              "onebit ", "topk ", "ran ", "pipeline",
                              "stages=", "distinct", "JSONL", "checkpoint",
                              "greedy", "1 data")):
                print(f"  {ln}")
        idle = [k for k in kernels if counts.get(k, 0) <= 0]
        if idle:
            print(f"{label}: kernels {idle} never launched")
            failed.append(label)
    print("example pipeline_training_torch.py ran its 4 stages on gloo "
          "ranks on the host; its 4-card run waits for a machine with 4 "
          "cards")
    return failed


def _ptxas_kernels(text):
    """(mangled name, registers, spill-store bytes) of each kernel in a
    `ptxas -v` report."""
    import re
    kernels, name, spill = [], None, 0
    for line in text.splitlines():
        if m := re.search(r"Function properties for (\S+)", line):
            name, spill = m.group(1), 0
        elif m := re.search(r"(\d+) bytes spill stores", line):
            spill = int(m.group(1))
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            kernels.append((name, int(m.group(1)), spill))
            name = None
    return kernels


def build_phase():
    """nvcc every kernel source of the main paths (paged attention, flash
    attention, the block quantizers, the blocked GEMM) into build/, one
    compiler per source, all started together;
    each compiler's per-kernel report goes to build/ptxas-<source>.txt and
    one summary line per source (kernels, most registers, spills) is
    printed, then registers and spills of each tensor-core instantiation
    (B6 bf16 by width, B7 bf16 by output type, the bf16 decode by width,
    pool and mode); fails if one in NO_SPILL spills."""
    import io
    import re
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.kernel import SOURCE as FLASH
    from repro_torch.kernels.matmul.kernel import SOURCE as MATMUL
    from repro_torch.kernels.paged_attention.kernel import SOURCE as PAGED
    from repro_torch.kernels.quantize.kernel import SOURCE as QUANT

    def one(src):
        t0 = time.perf_counter()
        report = io.StringIO()
        lib = build.build(src, extra_flags=("-Xptxas", "-v"), report=report)
        return src, lib, report.getvalue(), time.perf_counter() - t0

    t0 = time.perf_counter()
    sources = (PAGED, FLASH, QUANT, MATMUL)
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        results = list(pool.map(one, sources))
    for src, lib, text, secs in results:
        report = build.BUILD_DIR / f"ptxas-{src.stem}.txt"
        report.write_text(text)
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores",
                                             text)]
        print(f"build: {lib.name} in {secs:.1f} s; {len(regs)} kernels, most "
              f"registers {max(regs, default=0)}, spill stores {sum(spills)} "
              f"B (report: build/{report.name})")
        if src.stem in TC_KERNELS:
            pattern, what = TC_KERNELS[src.stem]
            found = [(" ".join(TC_NAMES.get(x, x) for x in m.groups()), r,
                      sp) for n, r, sp in _ptxas_kernels(text)
                     if (m := re.search(pattern, n))]
            print(f"build: {src.stem} redesigned kernels by {what}: " + ", "
                  .join(f"{key} {r} registers / {sp} B spilled"
                        for key, r, sp in found))
            gated = [(n, sp) for n, _, sp in _ptxas_kernels(text)
                     if re.search(NO_SPILL[src.stem], n)]
            check(gated and all(sp == 0 for _, sp in gated),
                  f"{src.name}: redesigned kernels spill: {gated}")
    print(f"build: all sources in {time.perf_counter() - t0:.1f} s")


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
        print(f"device: total_memory "
              f"{torch.cuda.get_device_properties(0).total_memory} B "
              f"(torch.cuda.get_device_properties(0))")

        laps = [time.perf_counter()]

        def lap(name):
            now = time.perf_counter()
            print(f"time: {name} {now - laps[0]:.1f} s")
            laps[0] = now
        build_phase()
        lap("build")
        rows = ([kernel_phase(card)] + multi_kernel_phase(card)
                + int8_kernel_phase(card))
        flash_row, hd80_row = flash_kernel_phase(card)
        rows += [flash_row, hd80_row]
        rows += quantize_kernel_phase(card)
        rows += matmul_kernel_phase(card)
        zamba2_rows = zamba2_kernel_phase(card)
        mixtral_rows = mixtral_kernel_phase(card)
        rows += zamba2_rows + mixtral_rows
        lap("kernels")
        musicgen_rows = a17_kernel_phase(card)
        rows += musicgen_rows
        lap("kernels (A17 layouts)")
        parity_phase(card)
        ring_spec_parity_phase(card)
        int8_parity_phase(card)
        train_parity_phase(card)
        paper_parity_phase(card)
        serve_parity_phase(card)
        lap("parity (slices 1-10)")
        moe_parity_phase(card)
        lap("parity (MoE, recurrent training)")
        yi = main_path_phase(card, rows[0])
        yi9b_int8_phase(card, rows, *yi)
        yi9b_serve_phase(card, *yi[:4])
        del yi
        f32_width_phase(card)
        lap("yi-9b serving")
        gemma3_main_phase(card, rows)
        lap("gemma3-12b serving")
        recurrent_main_phase(card, "rwkv6-7b")
        lap("rwkv6-7b serving")
        recurrent_main_phase(card, "zamba2-2.7b", zamba2_rows)
        lap("zamba2-2.7b serving")
        plain_ms = train_main_phase(card, flash_row)
        paper_main_phase(card, rows, plain_ms)
        train_main_phase(card, hd80_row, arch="stablelm-3b",
                         layers=STABLELM_LAYERS, batch=1, seq=2048, timed=2,
                         profile=False)
        conv_phase(card, rows)
        lap("yi-9b / stablelm-3b training, convolutions")
        moe_main_phase(card, "qwen3-moe-30b-a3b")
        lap("qwen3-moe-30b-a3b serving")
        moe_main_phase(card, "mixtral-8x7b", mixtral_rows)
        lap("mixtral-8x7b serving")
        for arch, layers, seq in (("qwen3-moe-30b-a3b", 2, 4096),
                                  ("rwkv6-7b", 2, 2048),
                                  ("zamba2-2.7b", 6, 2048)):
            train_main_phase(card, None, arch=arch, layers=layers, batch=1,
                             seq=seq, timed=2,
                             profile=arch == "qwen3-moe-30b-a3b")
            lap(f"{arch} training")
        a17_parity_phase(card)
        lap("parity (A17)")
        a17_main_phase(card, "qwen2-vl-2b", 28,
                       ("plain", "ngram k=4", "int8", "preempted"),
                       profile=True)
        train_main_phase(card, None, arch="qwen2-vl-2b", layers=28, batch=1,
                         seq=4096, timed=2, profile=False,
                         make_batches=_stub_batches(grid=32))
        lap("qwen2-vl-2b serving and training")
        a17_main_phase(card, "musicgen-medium", 48, ("plain", "ngram k=4"),
                       musicgen_rows)
        train_main_phase(card, None, arch="musicgen-medium",
                         layers=MUSICGEN_TRAIN_LAYERS, batch=1, seq=2048,
                         timed=2, profile=False,
                         make_batches=_stub_batches())
        lap("musicgen-medium serving and training")
        a17_main_phase(card, "phi4-mini-3.8b", 32, ("plain",))
        train_main_phase(card, None, arch="phi4-mini-3.8b", layers=4, batch=1,
                         seq=4096, timed=2, profile=False)
        lap("phi4-mini-3.8b serving and training")
        plan_phase(card)
        lap("sharding plans")
        analysis_phase(card)
        lap("op analysis")
        dryrun_and_examples_phase(card)
        lap("dry run and examples")
    except Exception as exc:  # noqa: BLE001 — report any phase's failure
        import traceback
        traceback.print_exc()
        print(f"FAIL: {type(exc).__name__}: {exc}", file=sys.stderr)
        return 1
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
