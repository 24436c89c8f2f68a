"""Build a CUDA source into a shared library with ``nvcc`` and load it.

Each kernel is a ``.cu`` file with a plain C interface, compiled for Hopper
(``sm_90a``) into ``build/`` at the repository root the first time a CUDA
tensor reaches its wrapper, and loaded with ``ctypes``. The library's name
carries a hash of its source and flags, so an edited source is rebuilt and
an unchanged one is loaded as is. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(src: Path) -> Path:
    """Where the library built from `src` lives: the name keys on the source
    bytes, those of the headers it includes by a quoted path (the shared
    ``kernels/csrc/*.cuh``) and the flags, so a stale build is never
    loaded."""
    text = src.read_bytes()
    headers = re.findall(rb'^#include "([^"]+)"', text, re.MULTILINE)
    text += b"".join((src.parent / h.decode()).read_bytes() for h in headers)
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def build(src: Path, extra_flags=(), report=None) -> Path:
    """Compile `src` unless its library is already built; returns its path.
    The compiler writes to a temporary name that is renamed into place, so
    builds started together for different sources never see a partial
    library. `report`, a text stream, receives the compiler's output (with
    ``-Xptxas -v`` in `extra_flags`: registers, shared memory and spills
    per kernel)."""
    out = library_path(src)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", tmp, str(src)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed on {src.name} ({r.returncode}):\n{r.stdout}\n"
                f"{r.stderr}")
        if report is not None:
            report.write(r.stdout + r.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(src: Path) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(src)))
