#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one
NVIDIA GPU. Run from the repository root:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the final ok line:

  1. device — require CUDA; print the card's name and power limit.
  2. build  — compile the paged-attention, flash-attention, quantize and
     matmul sources (every kernel of the main paths) with nvcc into build/,
     one compiler per source, started together.
  3. kernel — every kernel against its plain PyTorch version on the card
     (f32 atol 2e-5, bf16 atol 2e-2): B1 over the reference's test sweep
     and the yi-9b decode shape; B2 (ring decode), B4 (verify) and B5 (ring
     verify) over head layouts incl. gemma3's and yi-9b's, k = 2, 4, 8,
     ring positions before, at and far past the first wrap, an inactive
     slot and poisoned dead/stale keys; each kernel timed beside its plain
     version, one library call and its byte / operation bound (B1 at the
     yi-9b decode shape, B2/B4/B5 at gemma3-12b's). Then B3, the same four
     modes on int8 pools with their scales (dequantized in the kernel),
     over the same sweeps with poisoned dead keys and NaN scales, each
     timed likewise and beside the bf16 kernel on the same values. Then
     B6 (flash attention, the training forward): causal and windowed
     (32, 64, 1024), GQA 1/4/8, hd 8/64/80/128/136/256 and ragged lengths,
     with its row log-sum-exp; the autograd.Function's gradients against
     autograd through the plain version (also at hd 80); timed at the
     training shapes (yi-9b, batch 2 x 4096; stablelm-3b, hd 80, 1 x 2048)
     beside its plain version, SDPA(is_causal) and its operation bound.
     Then B9 and B8 (the block quantizers, stochastic and nearest): bits 8
     and 4, n = 256, 1000, 4096, 65537 and a case with an
     all-zero row and a ragged tail, q and scales EQUAL to the plain
     version; the int8 KV quantizer equal on cuda and cpu; each mode timed
     at the largest yi-9b training leaf and over a training step's 12
     leaves beside its plain version and byte bound (no library call
     computes the function). Then B7 (the blocked GEMM) in f32 and bf16
     over the reference's sweep, ragged shapes and the five im2col shapes
     of the survey's Table 6 layer, against its plain version (f32 within
     min(2e-6 K, 1e-5 max|ref|), bf16 within 2e-2 max|ref|), timed at the
     K=3 and K=13 shapes beside its plain version, cuBLAS and its bound.
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
     ~1000-token prompts, with bf16 and with int8 pools, then both pool
     types at one fixed pool byte budget under oversubscription (the bf16
     pool must preempt; peak resident sequences of each); then gemma3-12b
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
        return out, err

    # sweep: head layouts incl. gemma3's (16, 8, 256) and yi-9b's (32, 4,
    # 128); k in {2, 4, 8}; ring positions before, at and far past the
    # first wrap; an inactive slot; then the dead/stale pages poisoned
    bs, window = 4, 10
    n_cases = 0
    for H, Hkv, hd in [(4, 2, 64), (8, 1, 32), (8, 2, 16), (16, 8, 256),
                       (32, 4, 128)]:
        for dt in (torch.float32, torch.bfloat16):
            for key, n_q in ([("paged_ring", 0)]
                             + [(m, k) for m in ("paged_verify",
                                                 "paged_ring_verify")
                                for k in (2, 4, 8)]):
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
    print(f"kernel B2/B4/B5: {n_cases} cases (5 head layouts x f32/bf16 x "
          f"ring decode + verify/ring verify at k=2,4,8; ring wraps, an "
          f"inactive slot, poisoned dead and stale keys) within f32 2e-5 / "
          f"bf16 2e-2; worst bf16 err " + ", ".join(
              f"{k} {v:.3e}" for k, v in worst.items()))

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


def _time_multi(card, key, n_q, args, kw, errs, window, shape="gemma3-12b"):
    """Kernel, plain version and SDPA on pre-gathered K/V at one shape;
    byte and operation bounds from these inputs' live keys. n_q == 0 is a
    one-query decode (B1 or B2), else a K-query verify. With int8 pools
    (k_scale / v_scale in `kw`) the bytes count the int8 values plus 4
    bytes of scale per vector, SDPA takes K/V gathered AND dequantized
    beforehand, and the bf16 kernel of the same mode is also timed on the
    pools' dequantized contents (the dequant's cost)."""
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
    lib_err = (lib.float() - plain().float()).abs().max().item()
    ms = time_ms(kern)
    plain_ms = time_ms(plain)
    library_ms = time_ms(library)
    extra, row = "", {}
    if quant:
        # the bf16 kernel of the same mode on the same (dequantized) values
        deq = (q, dequantize_kv(kp, kw["k_scale"]).to(q.dtype),
               dequantize_kv(vp, kw["v_scale"]).to(q.dtype), tables, lens_t)
        kw16 = {k: v for k, v in kw.items() if not k.endswith("_scale")}
        bf16_ms = time_ms(lambda: kern_fn(*deq, **kw16))
        name, replaces = key, INT8_KERNELS[key][1]
        row = {"bf16_pool_ms": bf16_ms, "variant_of": INT8_KERNELS[key][0]}
        extra = (f", bf16 kernel on the dequantized pool {bf16_ms:.4f} ms "
                 f"({ms / bf16_ms:.2f}x)")
    else:
        name, replaces = MULTI_KERNELS[key]
    pools = "int8" if quant else "bf16"
    print(f"{name} @ {shape} decode shape (bf16 q, {pools} pools, B={B}, "
          f"k={K}, {n_keys} live keys): kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, library SDPA on pre-gathered K/V "
          f"{library_ms:.4f} ms (err vs plain {lib_err:.2e}){extra}, bound "
          f"{bound_ms:.4f} ms by {bound_by} ({nbytes} B, {flops} flop); "
          f"max_abs_err f32 {errs[torch.float32]:.3e} bf16 "
          f"{errs[torch.bfloat16]:.3e} | {card}")
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/paged_attention/csrc/"
                      "paged_attention.cu",
            "replaces": replaces, "launches": None,
            "max_abs_err": errs[torch.bfloat16], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, **row}


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
    for H, Hkv, hd in [(4, 4, 32), (4, 2, 64), (8, 1, 32), (8, 2, 16),
                       (8, 2, 128), (4, 1, 256), (16, 1, 64)]:
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
    for H, Hkv, hd in [(4, 2, 64), (8, 1, 32), (8, 2, 16), (16, 8, 256),
                       (32, 4, 128)]:
        for dt in (torch.float32, torch.bfloat16):
            for key, n_q in ([("paged_ring_int8", 0)]
                             + [(m, k) for m in ("paged_verify_int8",
                                                 "paged_ring_verify_int8")
                                for k in (2, 4, 8)]):
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
          f"inactive slot within f32 2e-5 / bf16 2e-2, ref with scales == "
          f"ref on the dequantized pool bit for bit, poisoned dead keys and "
          f"NaN scales read nowhere; worst bf16 err " + ", ".join(
              f"{k} {v:.3e}" for k, v in worst.items()))

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
    from repro_torch import kernels
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
            kernels.reset_launch_counts()
            outs[dev, spec] = _serve(eng, prompts, news)
            n = kernels.launch_counts
            steps = eng.stats["decode_steps"] if dev == "cuda" else 0
            want = ({"paged_attention": n_full * steps,
                     "paged_ring": n_ring * steps}
                    if spec is None else
                    {"paged_verify": n_full * steps,
                     "paged_ring_verify": n_ring * steps})
            got = {k: n[k] for k in want}
            check(got == want and sum(n.values()) == sum(want.values()),
                  f"{cfg.name} {dev} spec={spec}: launches {dict(n)} != "
                  f"{want}")
        check(outs["cuda", None] == outs["cpu", None],
              f"{cfg.name}: cuda tokens {outs['cuda', None]} != cpu tokens "
              f"{outs['cpu', None]}")
        check(outs["cuda", 4] == outs["cuda", None],
              f"{cfg.name}: spec tokens {outs['cuda', 4]} != plain "
              f"{outs['cuda', None]}")
        print(f"parity {cfg.name}: {len(lens)} staggered requests, cuda "
              f"tokens == cpu tokens, cuda spec k=4 tokens == cuda plain "
              f"(tf32 off) | {card}")


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
    from repro_torch import kernels
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
            kernels.reset_launch_counts()
            outs[dev, spec] = _serve(eng, prompts, news)
            steps = eng.stats["decode_steps"] if dev == "cuda" else 0
            want = (_launch_want(paged_attention_int8=n_full * steps,
                                 paged_ring_int8=n_ring * steps)
                    if spec is None else
                    _launch_want(paged_verify_int8=n_full * steps,
                                 paged_ring_verify_int8=n_ring * steps))
            check(kernels.launch_counts == want,
                  f"int8 {cfg.name} {dev} spec={spec}: launches "
                  f"{kernels.launch_counts} != {want}")
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
    check(sum(kernels.launch_counts.values()) == launches,
          f"yi-9b launched other kernels: {kernels.launch_counts}")
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


def _timed_run(card, eng, label, waves):
    """Serve request waves through `eng` with every device call checked for
    finite logits: wave 0 is submitted at once, each later wave after one
    more engine step; then drain. Checks that every request finished with
    its max_new tokens in the vocabulary and that no block leaked; prints
    tokens/s, TTFT / TPOT p50 and p99 (step_timing engines), per-step host
    and device medians, peak resident sequences, preemptions, resumes,
    block appends, the pools' bytes and peak device memory. `waves`: lists
    of (prompt, max_new, priority)."""
    import torch
    from repro_torch import kernels
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
    kernels.reset_launch_counts()
    resident = 0
    rids, news = [], []
    t0 = time.perf_counter()
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
    got = eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
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
          f"= {generated / wall:.2f} tok/s (each device call synchronized); "
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
            "launches": dict(kernels.launch_counts),
            "steps": st["decode_steps"], "resident": resident,
            "preemptions": st["preemptions"], "tok_s": generated / wall,
            "step_ms": np.median(dev) * 1e3}


def _match_share(label, base, other):
    """Requests whose tokens equal the bf16-pool run's, reported (int8 is a
    different result, so this is not gated; the f32 parity phases are)."""
    same, first = 0, []
    for a, b in zip(base, other):
        diff = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
        same += not diff
        first.append(diff[0] if diff else None)
    print(f"{label}: {same}/{len(first)} requests match the bf16-pool run end "
          f"to end; first divergent position per request {first} (reported, "
          f"not gated)")


def yi9b_int8_phase(card, rows, params, ecfg, prompts, news, bf16_outs):
    """yi-9b at full width with int8 pools (kv_quant) at the main phase's
    settings and requests; then both pool types at one fixed pool byte
    budget under OversubConfig(): bf16 with N blocks, int8 with
    N·(2·hd·2) // (2·(hd + 4)) blocks. Traffic for the budget runs: the 8
    mixed requests as batch class 1, then after one step the two long
    prompts as interactive class 0, with 16 slots so the pool binds; the
    bf16 pool must preempt."""
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
    print(f"yi-9b pools in turns: " + "; ".join(turns) + f" | {card}")
    # the same requests host-ahead, then the profile, as for bf16 pools
    fast = Engine(cfg, params, dataclasses.replace(ecfg, kv_quant=kvq,
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
          f"blocks): peak resident sequences bf16 "
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
    from repro_torch import kernels
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
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        rids = [eng.add_request(p, m) for p, m in zip(prompts, news)]
        got = eng.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = dict(kernels.launch_counts)
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


# ------------------------------------------ phase 3d: flash attention (B6)
# (B, S, H, Hkv, hd, causal, window): GQA groups 1, 4 and 8, hd 64 / 128 /
# 256, windows 32 and 1024, ragged lengths (not multiples of the 64-row
# query tile or of the key tile), and the mask without its causal half;
# then head dims that run in a padded tile (80 as stablelm-3b, 8, 136)
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
]
# forward and backward cases: (B, S, H, Hkv, hd, causal, window)
FLASH_GRAD_CASES = [
    (2, 256, 8, 2, 64, True, None),
    (1, 300, 4, 1, 128, True, 64),
    (1, 640, 8, 1, 128, True, None),
    (1, 256, 4, 4, 80, True, None),
    (1, 200, 4, 2, 80, True, 32),
]
# the training main paths' attention: yi-9b, batch 2 x 4096; stablelm-3b
# (MHA, hd 80), batch 1 x 2048
FLASH_MAIN = (2, 4096, 32, 4, 128, True, None)
FLASH_HD80 = (1, 2048, 32, 32, 80, True, None)


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
            err = (out.float() - ref.float()).abs().max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            label = (f"B6 B={B} S={S} H={H} Hkv={Hkv} hd={hd} causal={causal} "
                     f"window={window} {dt}")
            # lse: a log of an f32 sum taken in another order, |lse| ~ 10
            check(math.isfinite(err) and err <= tol[dt] and lse_err <= 1e-4,
                  f"{label}: max_abs_err {err} (tol {tol[dt]}), lse err "
                  f"{lse_err} (tol 1e-4)")
            worst[dt] = max(worst[dt], err)
            print(f"kernel {label}: max_abs_err {err:.3e}, lse {lse_err:.3e}")
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
        ref, _ = flash_attention_ref(q, k, v, causal=causal, window=window)
        main_err = (out.float() - ref.float()).abs().max().item()
        check(main_err <= 2e-2,
              f"B6 at the {where}: max_abs_err {main_err}")
        del ref
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
        dout = torch.randn_like(q)
        bwd_ms = time_ms(lambda: attention_backward(
            q, k, v, out, lse, dout, scale=hd ** -0.5, causal=causal,
            window=window), iters=3, warmup=1)
    print(f"B6 {name} @ {where} (B={B}, S={S}, H={H}, Hkv={Hkv}, hd={hd}, "
          f"bf16, causal): kernel {ms:.4f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, library "
          f"SDPA(is_causal) {library_ms:.4f} ms (err vs kernel {lib_err:.2e}), "
          f"bound {bound_ms:.4f} ms by {bound_by} ({nbytes} B, {flops} flop); "
          f"PyTorch backward {bwd_ms:.4f} ms | {card}")
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:27",
            "launches": None, "max_abs_err": main_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


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
                     seq=4096, timed=3, profile=True):
    """A model at full width (yi-9b: d_model 4096, 32 heads over 4 kv heads,
    hd 128, d_ff 11008, vocab 64000, bf16; stablelm-3b: d_model 2560, 32
    heads, hd 80, d_ff 6912, vocab 50304), cut to `layers` layers, trained
    through the port's own entry points (trainer.init_state,
    make_train_step -> loss_fn -> forward -> attention_train -> B6): Adam
    with lr 3e-4 and grad clip 1.0 (the launcher's defaults), remat on,
    batch `batch` x `seq` from SyntheticLM, 1 warm-up step and `timed`
    timed steps. Every loss is finite and each step launches B6 exactly 2 x
    layers times (the forward and the remat recompute). Returns the median
    step ms."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.optim import make_optimizer
    from repro_torch.train import trainer
    tag = "train" if arch == "yi-9b" else f"train {arch}"
    _release_card()         # engines of the serving phases wait in cycles
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=layers)
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
    batches = list(SyntheticLM(cfg.vocab_size, seq, seed=0)
                   .batches(batch, timed + 1))
    step = trainer.make_train_step(cfg, opt)
    per_step = 2 * cfg.num_layers
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
    row["launches"] = launches
    print(f"{tag}: {timed} timed steps, median {np.median(times) * 1e3:.1f} "
          f"ms = {batch * seq / np.median(times):.0f} tokens/s; losses "
          f"{losses}; B6 launches {launches} = {per_step} x {len(batches)} "
          f"steps | {card}")
    if profile:
        train_profile(card, step, state, batches[-1])
    del state
    _release_card()
    return float(np.median(times)) * 1e3


TRAIN_KINDS = ("B6 flash_attention forward", "B9 quantize_rows (int8)",
               "matmul (cuBLAS)", "other kernels and copies")


def train_profile(card, step, state, batch, label="train"):
    """Device kernel time by kind over one more training step, from
    torch.profiler; busy share = kernel time / the step's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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
            and device_us(e) > 0]
    busy_ms = sum(device_us(e) for e in kern) / 1e3
    if busy_ms == 0:
        print(f"{label} profile: no device time recorded — not measured | "
              f"{card}")
        return
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
              f"({nbytes / ms / 1e9:.2f} TB/s), plain {plain_ms:.4f} ms, "
              f"library none, bound {bound_ms:.4f} ms by bytes ({nbytes} B); "
              f"over the step's {len(sizes)} leaves ({sum(sizes)} values): "
              f"kernel {step_ms:.4f} ms, plain {step_plain_ms:.4f} ms, bound "
              f"{step_bound:.4f} ms ({step_bytes} B) | {card}")
        rows_out.append({
            "name": name, "route": "cuda", "source": QUANT_SOURCE,
            "replaces": f"src/repro/kernels/quantize/kernel.py:{line}",
            "launches": None, "max_abs_err": worst[mode], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": None})
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


DEVICE_KINDS = ("B1 paged_attention (full decode)", "B2/B5 ring split",
                "B4 verify split", "B2/B4/B5 merge", "matmul (cuBLAS)",
                "other kernels and copies")


def _device_kind(key: str) -> str:
    """Kind of a device kernel by its (demangled or mangled) name; the ring
    instantiations carry the template flag `true` (mangled `Lb1E`)."""
    name = key.lower()
    if "paged_decode" in name:
        return DEVICE_KINDS[0]
    if "paged_multi_split" in name:
        return DEVICE_KINDS[1 if ("true>" in name or "lb1e" in name) else 2]
    if "paged_multi_merge" in name:
        return DEVICE_KINDS[3]
    if any(p in name for p in ("gemm", "nvjet", "cutlass", "xmma", "sm90")):
        return DEVICE_KINDS[4]
    return DEVICE_KINDS[5]


def where_time_goes(card, eng, prompts, news, warm=3, window=8,
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
    host = [e for e in prof.key_averages()
            if not str(getattr(e, "device_type", "")).endswith("CUDA")
            and not e.key.startswith("engine/")]
    host.sort(key=lambda e: e.self_cpu_time_total, reverse=True)
    print("profile: top host self time: " + "; ".join(
        f"{e.key[:40]} {e.self_cpu_time_total / 1e3:.2f} ms x{e.count}"
        for e in host[:10]))


# ------------------------------------------------------ phase 3f: kernel B7
MATMUL_SOURCE = "src/repro_torch/kernels/matmul/csrc/matmul.cu"
# (M, K, N): the reference's sweep (tests/test_kernels.py:14), then shapes
# no tile divides (K past a 16-deep k tile, M and N past a 128 x 64 tile)
MATMUL_SWEEP = [(128, 128, 128), (256, 512, 128), (128, 1024, 256),
                (384, 256, 640), (1000, 577, 65), (1, 9, 1), (130, 17, 70),
                (7, 33, 129)]
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
                        f"{scale:.1f})")
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
            item = a.element_size()
            nbytes = (M * K + K * N + M * N) * item
            flops = 2 * M * N * K
            peak = FP32_FLOPS if dt == f32 else BF16_FLOPS
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / peak * 1e3
            bound_ms = max(t_bytes, t_ops)
            bound_by = "bytes" if t_bytes >= t_ops else "operations"
            print(f"B7 matmul @ Table 6 im2col GEMM, kernel {k}x{k} (M={M}, "
                  f"K={K}, N={N}, {dt}): kernel {ms:.4f} ms "
                  f"({flops / ms / 1e9:.1f} TFLOP/s), plain (f32 cuBLAS) "
                  f"{plain_ms:.4f} ms, library torch.matmul {library_ms:.4f} "
                  f"ms, bound {bound_ms:.4f} ms by {bound_by} ({nbytes} B, "
                  f"{flops} flop; peak {peak / 1e12:.0f} TFLOP/s) | {card}")
            if k == 3:
                rows.append({
                    "name": "matmul" if dt == f32 else "matmul_bf16",
                    "route": "cuda", "source": MATMUL_SOURCE,
                    "replaces": "src/repro/kernels/matmul/kernel.py:21",
                    "launches": None, "max_abs_err": err, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": library_ms})
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


def build_phase():
    """nvcc every kernel source of the main paths (paged attention, flash
    attention, the block quantizers, the blocked GEMM) into build/, one
    compiler per source, all started together;
    each compiler's per-kernel report goes to build/ptxas-<source>.txt and
    one summary line per source (kernels, most registers, spills) is
    printed."""
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

        build_phase()
        rows = ([kernel_phase(card)] + multi_kernel_phase(card)
                + int8_kernel_phase(card))
        flash_row, hd80_row = flash_kernel_phase(card)
        rows += [flash_row, hd80_row]
        rows += quantize_kernel_phase(card)
        rows += matmul_kernel_phase(card)
        parity_phase(card)
        ring_spec_parity_phase(card)
        int8_parity_phase(card)
        train_parity_phase(card)
        paper_parity_phase(card)
        yi = main_path_phase(card, rows[0])
        yi9b_int8_phase(card, rows, *yi)
        del yi
        gemma3_main_phase(card, rows)
        plain_ms = train_main_phase(card, flash_row)
        paper_main_phase(card, rows, plain_ms)
        train_main_phase(card, hd80_row, arch="stablelm-3b",
                         layers=STABLELM_LAYERS, batch=1, seq=2048, timed=2,
                         profile=False)
        conv_phase(card, rows)
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
