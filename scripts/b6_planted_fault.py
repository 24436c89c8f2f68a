#!/usr/bin/env python3
"""Shows that chip_smoke.py's check of B6 (the flash-attention forward)
catches a bf16 kernel that drops work in its long rows. Run from the
repository root on one card:

    python3 scripts/b6_planted_fault.py

It builds ``flash_attention.cu`` as it is and a copy with one planted fault
(into build/), and reads the smoke's three measures of B6 against its plain
version (``chip_smoke._flash_errors``: max abs error, the largest row error
relative to the row's rms, max lse error) for both, at the training shapes
(``FLASH_MAIN``, ``FLASH_HD80``). The fault: the bf16 kernel skips the
products of one key tile, the middle one, in the last query tile. Exits 0
when the sound kernel is within every limit and the planted one is outside
at least one.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# inserted after the bf16 kernel's loads of the next tile are issued, so
# the block's barriers and cp.async groups stay as they were
ANCHOR = ("    cp_async_commit();\n"
          "    const bf16* k_s = kv_s + 2 * (t & 1) * BK * LD;\n")
FAULT = "    if (qt == n_qt - 1 && t == n_tiles / 2) continue;\n"


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as smoke
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import (flash_attention_ref,
                                                     kernel)
    from repro_torch.kernels.flash_attention.ops import _forward_kernel

    sound = kernel.SOURCE
    text = sound.read_text()
    if text.count(ANCHOR) != 1:
        print("FAIL: the bf16 kernel's loop no longer has the anchor line",
              file=sys.stderr)
        return 1
    planted = build.BUILD_DIR / "planted" / sound.name
    planted.parent.mkdir(parents=True, exist_ok=True)
    planted.write_text(text.replace(ANCHOR, ANCHOR + FAULT))

    limits = (2e-2, smoke.B6_ROW_TOL, 1e-4)
    caught = []
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    for name, shape in (("yi-9b", smoke.FLASH_MAIN),
                        ("stablelm-3b", smoke.FLASH_HD80)):
        B, S, H, Hkv, hd, causal, window = shape
        q, k, v = smoke._flash_inputs(gen, B, S, H, Hkv, hd, torch.bfloat16)
        with torch.no_grad():
            ref, ref_lse = flash_attention_ref(q, k, v, causal=causal,
                                               window=window)
            for label, src in (("sound", sound), ("planted", planted)):
                kernel.SOURCE = src
                kernel._library.cache_clear()
                out, lse = _forward_kernel(q, k, v, hd ** -0.5, causal,
                                           window)
                errs = smoke._flash_errors(out, lse, ref, ref_lse)
                over = [e > lim for e, lim in zip(errs, limits)]
                print(f"B6 {label} @ {name} {shape}: max_abs_err "
                      f"{errs[0]:.4e} (limit 2e-2{', OVER' * over[0]}), row "
                      f"error {errs[1]:.4e} (limit {limits[1]}"
                      f"{', OVER' * over[1]}), lse err {errs[2]:.4e} (limit "
                      f"1e-4{', OVER' * over[2]})")
                if label == "sound" and any(over):
                    print("FAIL: the sound kernel is outside a limit",
                          file=sys.stderr)
                    return 1
                if label == "planted":
                    caught.append(any(over))
        kernel.SOURCE = sound
        kernel._library.cache_clear()
    print(smoke.card_line())
    if not all(caught):
        print("FAIL: the planted fault passed the check", file=sys.stderr)
        return 1
    print("planted fault caught at both shapes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
