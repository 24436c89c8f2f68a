"""Finding a cell's pieces by name, and the checks every run makes.

``BENCHMARK.json`` names each cell's configuration and traffic mix; the
configuration is ``bench/configs/<name>.json``, the mix
``bench/traffic/<name>.json``, whose ``driver`` key names
``bench/drivers/<driver>.py``; the configuration's ``reference`` key names
its plain reference, ``bench/reference/<reference>.py``, which also lists
the leaves of its weights; each per-layer metric is
``bench/metrics/<metric>.py`` and each cell's limits
``bench/limits/<workload>.json``. Adding a cell adds files and entries;
nothing here changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level modules the measured process must not hold: the JAX package
# the port was made from, and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(name: str, man: dict = None) -> dict:
    """Everything a run of workload `name` reads: the manifest entries of
    the workload and its configuration, the configuration file, the
    traffic mix, the limits, and the end-to-end and per-layer metric
    entries that the workload reports."""
    man = man or manifest()
    wl = {w["name"]: w for w in man["workloads"]}.get(name)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{sorted(w['name'] for w in man['workloads'])}")
    cfg = {c["name"]: c for c in man["configs"]}[wl["config"]]
    e2e = [m for m in man["end_to_end"]
           if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    layer = [m for m in man["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return {"workload": wl,
            "config": json.loads((ROOT / cfg["file"]).read_text()),
            "traffic": json.loads(
                (BENCH / "traffic" / f"{wl['traffic']}.json").read_text()),
            "limits": json.loads(
                (BENCH / "limits" / f"{name}.json").read_text()),
            "end_to_end": e2e, "per_layer": layer}


def _load(path: Path, tag: str):
    spec = importlib.util.spec_from_file_location(
        "bench_" + tag.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    return _load(BENCH / "drivers" / f"{name}.py", "driver_" + name)


def reference(name: str):
    """The plain reference module ``bench/reference/<name>.py``."""
    return importlib.import_module(f"bench.reference.{name}")


def metric_reader(name: str):
    """The `read(capture)` function of per-layer metric `name`."""
    return _load(BENCH / "metrics" / f"{name}.py", "metric_" + name).read


def model_config(config: dict):
    """The port's ModelConfig of a configuration file: its registry entry
    with every field the file's "model" gives."""
    from dataclasses import fields, replace

    from repro_torch.configs.base import get_config
    base = get_config(config["registry"])
    known = {f.name for f in fields(base)}
    unknown = set(config["model"]) - known
    if unknown:
        raise KeyError(f"configuration keys the port does not know: "
                       f"{sorted(unknown)}")
    return replace(base, **config["model"])


def prebuild() -> None:
    """Build every hand-written kernel library of the port that is not
    built yet, all compilers at once (the program builds into ``build/``
    inside the checkout on first use; only a checkout's first run
    compiles)."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import build
    sources = sorted((ROOT / "src" / "repro_torch" / "kernels").glob(
        "*/csrc/*.cu"))
    with ThreadPoolExecutor(len(sources) or 1) as pool:
        list(pool.map(build.build, sources))


def forbidden_modules(names=None) -> list:
    """The forbidden top-level modules among `names` (by default, those
    this process holds), compared by whole top-level name
    (``repro_torch`` is not ``repro``)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))
