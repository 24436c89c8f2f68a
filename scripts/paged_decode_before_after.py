#!/usr/bin/env python3
"""Times the bf16 one-query paged decode of this tree (B1 full mode, B2
ring mode, each on bf16 and on int8 pools) against an earlier
``paged_attention.cu`` in one process, in turns, at chip_smoke.py's timed
decode shapes. Run from the repository root on one card, with the earlier
source saved first:

    git show <commit>:src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu \\
        > build/paged_attention_before.cu
    python3 scripts/paged_decode_before_after.py build/paged_attention_before.cu

The earlier source is built into build/ beside this tree's and driven
through its own C entry points with a bf16 query, as its wrapper did
(``paged_attention_decode`` for full mode, ``paged_attention_multi`` with
one query for ring mode, 256-key splits); this tree's through
``ops.paged_attention``. Both outputs are first held to the plain version
(max abs error 2e-2, row error ``chip_smoke.DECODE_ROW_TOL``). Then each
row is timed before, after, after, before, by device time
(``chip_smoke.device_ms``: the profiler's summed kernel durations with the
L2 flush left out) and by CUDA events (``chip_smoke.time_ms``, host time
included); this tree's pair also split into its split pass and its
merge (one profile each). ``--splits 64,256`` also times this tree's
kernel at those
split sizes instead of the one the host chooses. Prints one line per row,
then one JSON line; exits 0 when every output is within its limits.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OLD_SPLIT = 256          # the earlier wrappers' SPLIT_TOKENS


def _rows(smoke, gen):
    """(name, args, kw) at the smoke's timed decode shapes: yi-9b full mode
    (B=8, 32/4 heads, hd 128, lengths 1..2048) and gemma3-12b ring mode
    (B=8, 16/8 heads, hd 256, window 1024, lengths 4..2048), bf16 and int8."""
    import torch
    B, H, Hkv, hd, bs, P = 8, 32, 4, 128, 16, 128
    lens = [int(x) for x in np.linspace(1, bs * P, B)]
    full = (smoke._paged_case(gen, B, H, Hkv, hd, B * P + 1, bs, P,
                              torch.bfloat16, lens), {})
    B, H, Hkv, hd, bs, P, W = 8, 16, 8, 256, 16, 128, 1024
    lens = [int(x) for x in np.linspace(4, bs * P, B)]
    ring = smoke._multi_inputs(gen, B, 0, H, Hkv, hd, B * P + 1, bs, P,
                               torch.bfloat16, lens,
                               (W, smoke._ring_pages(W, bs)))
    return [("B1", *full), ("B1+B3", *smoke._quantized(*full)),
            ("B2", *ring), ("B2+B3", *smoke._quantized(*ring))]


def _old_call(lib, args, kw):
    """The earlier kernels with a bf16 query, as their wrapper launched
    them: out and workspace allocated on every call."""
    import torch
    q, kp, vp, tables, lens = args
    B, H, hd = q.shape
    _, bs, Hkv, _ = kp.shape
    P = tables.shape[1]
    ks, vs = kw.get("k_scale"), kw.get("v_scale")
    R = kw.get("ring_pages", 0)

    def ptr(t):
        return None if t is None else t.data_ptr()

    def call():
        out = torch.empty_like(q)
        n_splits = -(-(R or P) * bs // OLD_SPLIT)
        ws = torch.empty(B * H * n_splits * (hd + 2), dtype=torch.float32,
                         device=q.device)
        stream = torch.cuda.current_stream().cuda_stream
        if R:
            rc = lib.paged_attention_multi(
                q.data_ptr(), kp.data_ptr(), vp.data_ptr(), ptr(ks), ptr(vs),
                tables.data_ptr(), lens.data_ptr(),
                kw["positions"].data_ptr(), out.data_ptr(), ws.data_ptr(), B,
                1, H, Hkv, hd, bs, P, R, kw["window"], OLD_SPLIT,
                hd ** -0.5, 1, stream)
        else:
            rc = lib.paged_attention_decode(
                q.data_ptr(), kp.data_ptr(), vp.data_ptr(), ptr(ks), ptr(vs),
                tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
                ws.data_ptr(), B, H, Hkv, hd, bs, P, OLD_SPLIT, hd ** -0.5, 1,
                stream)
        if rc != 0:
            raise RuntimeError(f"earlier kernel: CUDA error {rc}")
        return out
    return call


def _split_and_merge_ms(smoke, fn, iters=30):
    """This tree's kernel pair by device time, (split pass, merge) per call,
    from one profile with the L2 flush before each call (left out)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    fn()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.bitwise_not_()
            fn()
        torch.cuda.synchronize()
    split = merge = 0.0
    for e in prof.key_averages():
        if "paged_decode_tc" not in e.key or not str(
                getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        if "merge" in e.key:
            merge += smoke._device_us(e)
        else:
            split += smoke._device_us(e)
    return split / iters / 1e3, merge / iters / 1e3


def _load_old(path: Path):
    from repro_torch.kernels import build
    src = build.BUILD_DIR / "before" / "paged_attention.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(path.read_text())
    lib = ctypes.CDLL(str(build.build(src)))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.paged_attention_decode.argtypes = [P] * 9 + [I] * 7 + [
        ctypes.c_float, I, P]
    lib.paged_attention_multi.argtypes = [P] * 10 + [I] * 10 + [
        ctypes.c_float, I, P]
    lib.paged_attention_decode.restype = I
    lib.paged_attention_multi.restype = I
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("before", type=Path, help="the earlier paged_attention.cu")
    ap.add_argument("--splits", default="",
                    help="comma-separated split sizes to time this tree's "
                         "kernel at as well")
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as smoke
    from repro_torch.kernels.paged_attention import (kernel,
                                                     paged_attention,
                                                     paged_attention_ref)
    card = smoke.card_line()
    old = _load_old(opts.before)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(18)
    ok, result = True, []
    for name, args, kw in _rows(smoke, gen):
        before = _old_call(old, args, kw)

        def after():
            return paged_attention(*args, **kw)
        ref = paged_attention_ref(*args, **kw)
        errs = {}
        for label, fn in (("before", before), ("after", after)):
            out = fn()
            torch.cuda.synchronize()
            errs[label] = ((out.float() - ref.float()).abs().max().item(),
                           smoke._row_error(out, ref))
            ok &= errs[label][0] <= 2e-2 and errs[label][1] <= \
                smoke.DECODE_ROW_TOL
        dev = [smoke.device_ms(f) for f in (before, after, after, before)]
        ev = [smoke.time_ms(f) for f in (before, after, after, before)]
        split_ms, merge_ms = _split_and_merge_ms(smoke, after)
        row = {"row": name, "device_ms_before": [dev[0], dev[3]],
               "device_ms_after": [dev[1], dev[2]],
               "after_split_ms": split_ms, "after_merge_ms": merge_ms,
               "event_ms_before": [ev[0], ev[3]],
               "event_ms_after": [ev[1], ev[2]],
               "max_abs_err": {k: v[0] for k, v in errs.items()},
               "row_error": {k: v[1] for k, v in errs.items()}}
        for split in [int(x) for x in opts.splits.split(",") if x]:
            chosen = kernel.decode_split_tokens
            kernel.decode_split_tokens = lambda *a, s=split: s
            try:
                row[f"device_ms_split_{split}"] = smoke.device_ms(after)
            finally:
                kernel.decode_split_tokens = chosen
        result.append(row)
        print(f"{name}: device ms before {smoke._ms(dev[0])} / "
              f"{smoke._ms(dev[3])}, after {smoke._ms(dev[1])} / "
              f"{smoke._ms(dev[2])} (split pass {split_ms:.4f}, merge "
              f"{merge_ms:.4f}); events before {ev[0]:.4f} / "
              f"{ev[3]:.4f}, after {ev[1]:.4f} / {ev[2]:.4f} ms; max abs err "
              f"before {errs['before'][0]:.3e} after {errs['after'][0]:.3e}, "
              f"row error before {errs['before'][1]:.3e} after "
              f"{errs['after'][1]:.3e} | {card}")
    print(json.dumps({"card": card, "rows": result}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
