#!/usr/bin/env python3
"""Times the f32 blocked GEMM (B7) and the bf16 paged verify (B4 full mode,
B5 ring mode, each also on int8 pools, B3) of this tree against earlier
sources of ``matmul.cu`` and ``paged_attention.cu`` in one process, in
turns. Run from the repository root on one card, with the earlier kernels'
tree unpacked into build/ first:

    mkdir -p build/before
    git archive <commit> src/repro_torch/kernels | tar -x -C build/before
    python3 scripts/verify_matmul_before_after.py build/before

The earlier sources are built into build/ beside this tree's and driven
through their own C entry points, as their wrappers did: ``matmul_f32acc``
for the GEMM, ``paged_attention_multi`` with a bf16 query and 256-key
splits for the verify; this tree's through ``matmul.ops._kernel`` and
``ops.paged_attention_verify``. Rows:

  * B7 f32 at the survey's Table 6 im2col GEMMs, kernel 3x3 (M 186,624, K
    576, N 64) and 13x13 (M 123,904, K 10,816, N 64), chip_smoke.py's
    timed shapes. The outputs must be EQUAL bit for bit, there and at the
    ragged 1000 x 577 x 65 case (K and N not multiples of 4: the masked
    scalar loaders); cuBLAS f32 (``torch.matmul``, TF32 off) is timed once
    beside them and its equality reported, not gated.
  * B4, B5, B4+B3, B5+B3 at chip_smoke.py's timed verify shape (gemma3-12b:
    B 8, 16/8 heads, hd 256, block 16, 128-page tables, window 1024, k =
    4: 8 query rows a kv head, one 16-row tile); then B4 at yi-9b's head
    layout (32/4 heads, hd 128, the same tables) with k = 2, 4 and 5: 16,
    32 and 40 rows a kv head, one, two and three row tiles, which this
    tree runs as separate blocks re-reading the same K/V stages. Both
    outputs are held to the plain version (max abs error 2e-2, row error
    ``chip_smoke.DECODE_ROW_TOL``).

Each row is timed before, after, after, before, by device time
(``chip_smoke.device_ms``: the profiler's summed kernel durations with the
L2 flush left out) and by CUDA events (``chip_smoke.time_ms``, host time
included). Prints one line per row, then one JSON line; exits 0 only when
every check passes.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OLD_SPLIT = 256          # the earlier verify wrapper's SPLIT_TOKENS
KERNELS = "src/repro_torch/kernels"


def _build(before: Path):
    """This tree's and the earlier tree's two libraries, built together;
    returns the earlier ones, loaded, with their entry points typed."""
    from repro_torch.kernels import build
    from repro_torch.kernels.matmul import kernel as mk
    from repro_torch.kernels.paged_attention import kernel as pk
    srcs = [mk.SOURCE, pk.SOURCE,
            before / KERNELS / "matmul/csrc/matmul.cu",
            before / KERNELS / "paged_attention/csrc/paged_attention.cu"]
    with ThreadPoolExecutor(len(srcs)) as pool:
        libs = list(pool.map(build.build, srcs))
    mm, pa = (ctypes.CDLL(str(p)) for p in libs[2:])
    P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    mm.matmul_f32acc.argtypes = [P, P, P, L, L, L, I, I, P]
    mm.matmul_f32acc.restype = I
    pa.paged_attention_multi.argtypes = [P] * 10 + [I] * 10 + [
        ctypes.c_float, I, P]
    pa.paged_attention_multi.restype = I
    return mm, pa


def _old_matmul(lib, a, b):
    import torch

    def call():
        c = torch.empty((a.shape[0], b.shape[1]), dtype=torch.float32,
                        device=a.device)
        rc = lib.matmul_f32acc(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                               a.shape[0], b.shape[1], a.shape[1], 0, 0,
                               torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"earlier matmul: CUDA error {rc}")
        return c
    return call


def _old_verify(lib, args, kw):
    """The earlier CUDA-core verify with a bf16 query, as its wrapper
    launched it: out and workspace allocated on every call."""
    import torch
    q, kp, vp, tables, lens = args
    B, n_q, H, hd = q.shape
    _, bs, Hkv, _ = kp.shape
    P = tables.shape[1]
    R = kw.get("ring_pages", 0)

    def ptr(t):
        return None if t is None else t.data_ptr()

    def call():
        out = torch.empty_like(q)
        n_splits = -(-(R or P) * bs // OLD_SPLIT)
        ws = torch.empty(B * n_q * H * n_splits * (hd + 2),
                         dtype=torch.float32, device=q.device)
        rc = lib.paged_attention_multi(
            q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
            ptr(kw.get("k_scale")), ptr(kw.get("v_scale")),
            tables.data_ptr(), lens.data_ptr(),
            kw.get("positions", lens).data_ptr(), out.data_ptr(),
            ws.data_ptr(), B, n_q, H, Hkv, hd, bs, P, R, kw.get("window", 0),
            OLD_SPLIT, hd ** -0.5, 1, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"earlier verify: CUDA error {rc}")
        return out
    return call


def _turns(smoke, before, after, iters):
    """(device ms, event ms), each [before, after, after, before]."""
    fns = (before, after, after, before)
    dev = [smoke.device_ms(f, iters=iters) for f in fns]
    ev = [smoke.time_ms(f, iters=iters) for f in fns]
    return dev, ev


def _matmul_rows(smoke, mm, gen, card):
    import torch
    from repro_torch.kernels.matmul.ops import _kernel
    torch.backends.cuda.matmul.allow_tf32 = False
    ok, rows = True, []
    a = torch.randn((1000, 577), generator=gen, device="cuda")
    b = torch.randn((577, 65), generator=gen, device="cuda")
    same = torch.equal(_old_matmul(mm, a, b)(), _kernel(a, b, None))
    ok &= same
    print(f"B7 f32 M=1000 K=577 N=65 (masked scalar loaders): after == before "
          f"bit for bit: {same}")
    for k in smoke.MATMUL_TIMED:
        M, K, N = smoke._im2col_shape(k)
        a = torch.randn((M, K), generator=gen, device="cuda")
        b = torch.randn((K, N), generator=gen, device="cuda")
        before = _old_matmul(mm, a, b)

        def after():
            return _kernel(a, b, None)
        out_b, out_a, lib = before(), after(), torch.matmul(a, b)
        same = torch.equal(out_a, out_b)
        ok &= same
        iters = 10 if k == 3 else 4
        dev, ev = _turns(smoke, before, after, iters)
        lib_dev = smoke.device_ms(lambda: torch.matmul(a, b), iters=iters)
        lib_ev = smoke.time_ms(lambda: torch.matmul(a, b), iters=iters)
        row = {"row": f"B7 f32 {k}x{k}", "shape": [M, K, N],
               "device_ms_before": [dev[0], dev[3]],
               "device_ms_after": [dev[1], dev[2]],
               "event_ms_before": [ev[0], ev[3]],
               "event_ms_after": [ev[1], ev[2]],
               "cublas_device_ms": lib_dev, "cublas_event_ms": lib_ev,
               "equal_before": same,
               "equal_cublas": torch.equal(out_a, lib)}
        rows.append(row)
        print(f"{row['row']} (M={M}, K={K}, N={N}): device ms before "
              f"{smoke._ms(dev[0])} / {smoke._ms(dev[3])}, after "
              f"{smoke._ms(dev[1])} / {smoke._ms(dev[2])}; events before "
              f"{ev[0]:.4f} / {ev[3]:.4f}, after {ev[1]:.4f} / {ev[2]:.4f} "
              f"ms; cuBLAS f32 device {smoke._ms(lib_dev)}, events "
              f"{lib_ev:.4f} ms; after == before bit for bit: {same}; after "
              f"== cuBLAS: {row['equal_cublas']} | {card}")
        del a, b, out_a, out_b, lib
        smoke._release_card()
    return ok, rows


def _verify_rows(smoke, pa, gen, card):
    """B4, B5, each also with B3, at the smoke's timed gemma3-12b shape;
    B4 at yi-9b's head layout with one, two and three row tiles."""
    import torch
    from repro_torch.kernels.paged_attention import (
        paged_attention_verify, paged_attention_verify_ref)
    B, H, Hkv, hd, bs, P, W, K = 8, 16, 8, 256, 16, 128, 1024, 4
    lens = [int(x) for x in np.linspace(K, bs * P, B)]
    cases = []
    for name, ring in (("B4", None), ("B5", (W, smoke._ring_pages(W, bs,
                                                                  K - 1)))):
        case = smoke._multi_inputs(gen, B, K, H, Hkv, hd, B * P + 1, bs, P,
                                   torch.bfloat16, lens, ring)
        cases += [(name, *case), (name + "+B3", *smoke._quantized(*case))]
    for k in (2, 4, 5):
        lens = [int(x) for x in np.linspace(k, bs * P, B)]
        cases.append((f"B4 yi-9b k={k}", *smoke._multi_inputs(
            gen, B, k, 32, 4, 128, B * P + 1, bs, P, torch.bfloat16, lens,
            None)))
    ok, rows = True, []
    for name, args, kw in cases:
        before = _old_verify(pa, args, kw)

        def after():
            return paged_attention_verify(*args, **kw)
        ref = paged_attention_verify_ref(*args, **kw)
        errs = {}
        for label, fn in (("before", before), ("after", after)):
            out = fn()
            torch.cuda.synchronize()
            errs[label] = ((out.float() - ref.float()).abs().max().item(),
                           smoke._row_error(out, ref))
            ok &= (errs[label][0] <= 2e-2
                   and errs[label][1] <= smoke.DECODE_ROW_TOL)
        dev, ev = _turns(smoke, before, after, 30)
        row = {"row": name, "device_ms_before": [dev[0], dev[3]],
               "device_ms_after": [dev[1], dev[2]],
               "event_ms_before": [ev[0], ev[3]],
               "event_ms_after": [ev[1], ev[2]],
               "max_abs_err": {k: v[0] for k, v in errs.items()},
               "row_error": {k: v[1] for k, v in errs.items()}}
        rows.append(row)
        q = args[0]
        shape = (f"B {q.shape[0]}, {q.shape[2]}/{args[1].shape[2]} heads, "
                 f"hd {q.shape[3]}, k={q.shape[1]}")
        print(f"{name} ({shape}): device ms before "
              f"{smoke._ms(dev[0])} / {smoke._ms(dev[3])}, after "
              f"{smoke._ms(dev[1])} / {smoke._ms(dev[2])}; events before "
              f"{ev[0]:.4f} / {ev[3]:.4f}, after {ev[1]:.4f} / {ev[2]:.4f} "
              f"ms; max abs err before {errs['before'][0]:.3e} after "
              f"{errs['after'][0]:.3e}, row error before "
              f"{errs['before'][1]:.3e} after {errs['after'][1]:.3e} | "
              f"{card}")
    return ok, rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("before", type=Path,
                    help="the earlier tree, holding src/repro_torch/kernels")
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as smoke
    card = smoke.card_line()
    mm, pa = _build(opts.before)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)
    ok_m, m_rows = _matmul_rows(smoke, mm, gen, card)
    ok_v, v_rows = _verify_rows(smoke, pa, gen, card)
    print(json.dumps({"card": card, "rows": m_rows + v_rows}))
    if not ok_m:
        print("FAIL: B7 f32 differs from the earlier kernel", file=sys.stderr)
    if not ok_v:
        print("FAIL: a verify output is outside its limits", file=sys.stderr)
    return 0 if ok_m and ok_v else 1


if __name__ == "__main__":
    sys.exit(main())
