"""Port rules: the PyTorch port stands alone beside the JAX reference.

* Nothing under ``src/repro_torch/``, in ``chip_smoke.py`` or in the
  examples' ``examples/*_torch.py`` imports ``jax`` or ``repro`` (AST
  scan), and importing the engine leaves both out of ``sys.modules``.
* Entry points default to the card: ``Engine(cfg, params)``,
  ``trainer.init_state``, the data-parallel group and the training launcher
  (also with ``--paper-mode``) with no device raise where there is no CUDA
  instead of running on the CPU.
* ``params_from_jax`` round-trips the reference's float32 and bfloat16
  parameter trees with the port's shapes and dtypes.
* The port's own copies of the reference's repo-lint fences: KV pools are
  made only by ``state_providers.alloc_kv_pool``, metrics flow through the
  telemetry registry, and BlockPool internals stay inside paged_cache.py.
"""
import ast
import os
import pathlib
import re
import subprocess
import sys

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.models import transformer as JT
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax
from repro_torch.models.transformer import param_specs

pytestmark = pytest.mark.port

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
EXAMPLES = sorted((REPO / "examples").glob("*_torch.py"))
PORT_FILES = (sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
              + EXAMPLES)

CFG_KW = dict(name="rules-t", family="dense", num_layers=2, d_model=64,
              num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
              vocab_size=50, remat=False)


def _banned(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


def test_port_imports_neither_jax_nor_repro():
    assert PORT.is_dir() and len(PORT_FILES) > 10
    assert len(EXAMPLES) == 4, EXAMPLES
    offenders = [f"{p.relative_to(REPO)}:{line}: {mod}"
                 for p in PORT_FILES for line, mod in _imports(p)
                 if _banned(mod)]
    assert not offenders, "port imports the reference:\n" + "\n".join(offenders)


def test_import_scan_catches_the_banned_forms(tmp_path):
    assert _banned("jax.numpy") and _banned("repro.models.layers")
    assert _banned("repro") and _banned("jaxlib")
    assert not _banned("repro_torch.models") and not _banned("torch")
    src = ("import jax\nfrom repro.configs import base\n"
           "import importlib\nimportlib.import_module('repro.serving')\n")
    probe = tmp_path / "probe.py"
    probe.write_text(src)
    mods = [m for _, m in _imports(probe)]
    assert [m for m in mods if _banned(m)] == ["jax", "repro.configs",
                                              "repro.serving"]


def test_importing_the_engine_loads_no_jax():
    code = ("import sys, repro_torch.serving.engine, repro_torch.convert\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\nprint('PASS')\n")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 0 and "PASS" in r.stdout, r.stderr


TRAINING_SUBPACKAGES = ("optim", "data", "train", "launch",
                        "kernels/flash_attention", "core", "kernels/quantize")
# the survey's §4.3 convolutions and their GEMM (B7)
CONV_SUBPACKAGES = ("models", "kernels/matmul")


@pytest.mark.parametrize("sub", TRAINING_SUBPACKAGES + CONV_SUBPACKAGES)
def test_import_fence_covers_the_training_subpackages(sub):
    files = [p for p in PORT_FILES if (PORT / sub) in p.parents]
    assert files, f"no module of src/repro_torch/{sub} is scanned"
    offenders = [f"{p.relative_to(REPO)}:{line}: {mod}"
                 for p in files for line, mod in _imports(p) if _banned(mod)]
    assert not offenders, "\n".join(offenders)


def test_importing_the_training_path_loads_no_jax():
    code = ("import sys, repro_torch.launch.train, repro_torch.train.trainer, "
            "repro_torch.train.checkpoint, repro_torch.optim, "
            "repro_torch.data.pipeline, repro_torch.kernels.flash_attention\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\nprint('PASS')\n")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 0 and "PASS" in r.stdout, r.stderr


def test_importing_the_conv_path_loads_no_jax():
    code = ("import sys, repro_torch.models.conv, repro_torch.kernels.matmul, "
            "repro_torch.core.workdepth, repro_torch.configs.stablelm_3b\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\nprint('PASS')\n")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 0 and "PASS" in r.stdout, r.stderr


def test_training_entry_points_default_to_cuda_and_refuse_cpu_fallback():
    from repro_torch.launch import train as launcher
    from repro_torch.optim import make_optimizer
    from repro_torch.train import trainer
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is usable")
    cfg = ModelConfig(**CFG_KW, dtype="float32")
    assert trainer.init_state.__kwdefaults__["device"] == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trainer.init_state(cfg, make_optimizer("sgd"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launcher.main(["--arch", "yi-9b", "--preset", "reduced",
                       "--steps", "1"])


def test_paper_mode_defaults_to_cuda_and_refuses_cpu_fallback():
    import torch.distributed as dist
    from repro_torch.launch import train as launcher
    from repro_torch.launch.mesh import make_dp_group
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is usable")
    assert make_dp_group.__defaults__ == ("cuda",)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launcher.main(["--arch", "yi-9b", "--preset", "reduced",
                       "--steps", "1", "--paper-mode", "--compress", "int8"])
    assert not dist.is_initialized()


def test_importing_the_paper_mode_loads_no_jax():
    code = ("import sys, repro_torch.core.compression, "
            "repro_torch.core.collectives, repro_torch.core.consistency, "
            "repro_torch.core.consolidation, repro_torch.core.metaopt, "
            "repro_torch.launch.mesh, repro_torch.kernels.quantize\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\nprint('PASS')\n")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 0 and "PASS" in r.stdout, r.stderr


def test_engine_defaults_to_cuda_and_refuses_cpu_fallback():
    from repro_torch.models import transformer as TT
    from repro_torch.serving.engine import Engine, EngineConfig
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is usable")
    cfg = ModelConfig(**CFG_KW, dtype="float32")
    params = TT.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(cfg, params)
    with pytest.raises(RuntimeError):
        Engine(cfg, params, EngineConfig(num_blocks=8, max_blocks_per_seq=4))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_round_trip(dtype):
    jcfg = JaxModelConfig(**CFG_KW, dtype=dtype)
    cfg = ModelConfig(**CFG_KW, dtype=dtype)
    tree = jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(1)))
    params = params_from_jax(tree, cfg, "cpu")
    want = getattr(torch, dtype)

    def walk(t, p, spec, path):
        if isinstance(spec, dict):
            assert set(t) == set(p) == set(spec), path
            for k in spec:
                walk(t[k], p[k], spec[k], f"{path}.{k}")
            return
        shape, dt, _ = spec
        assert tuple(p.shape) == tuple(shape) == tuple(t.shape), path
        assert p.dtype == dt, path
        expect = t.astype(np.float32)
        np.testing.assert_array_equal(p.float().numpy(), expect, err_msg=path)
    walk(tree, params, param_specs(cfg), "params")
    assert params["blocks"]["l0"]["attn"]["wq"].dtype == want
    assert params["final_norm"]["scale"].dtype == torch.float32
    if dtype == "bfloat16":
        assert tree["embed"]["table"].dtype == ml_dtypes.bfloat16


def test_params_from_jax_rejects_mismatched_trees():
    jcfg = JaxModelConfig(**CFG_KW, dtype="float32")
    tree = jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(1)))
    other = ModelConfig(**{**CFG_KW, "d_ff": 96}, dtype="float32")
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(tree, other, "cpu")
    del tree["final_norm"]
    with pytest.raises(ValueError, match="keys"):
        params_from_jax(tree, ModelConfig(**CFG_KW, dtype="float32"), "cpu")


# ------------------------------------------------------ fences (port copies)
_KV_POOL_ALLOC = re.compile(
    r"""["'](?:k|v|k_scale|v_scale)["']\s*:\s*torch\.(?:zeros|ones|empty|full)\b"""
    r"|[(,\s](?:k|v|k_scale|v_scale)=torch\.(?:zeros|ones|empty|full)\(")
_RAW_STATS_MUTATION = re.compile(
    r"\.stats\[[^\]]+\]\s*(?:[-+*/|&^%]|//|>>|<<)?=(?!=)")
_POOL_INTERNAL = re.compile(
    r"\._(?:free|ref|owned|index|hash_of|n_cached_free)\b")


def _offenders(pattern, root, allowed):
    out = []
    for path in sorted(root.rglob("*.py")):
        if path.name in allowed:
            continue
        for lineno, line in enumerate(path.read_text().splitlines(), 1):
            if pattern.search(line):
                out.append(f"{path.relative_to(REPO)}:{lineno}: "
                           f"{line.strip()}")
    return out


def test_kv_pool_allocation_only_in_state_providers():
    bad = _offenders(_KV_POOL_ALLOC, PORT, ("state_providers.py",))
    assert not bad, "raw KV pool allocation (use alloc_kv_pool):\n" + \
        "\n".join(bad)


def test_kv_alloc_regex_catches_the_banned_patterns():
    bad = ['return {"k": torch.zeros(shape), "v": torch.zeros(shape)}',
           "cache = dict(k=torch.zeros(s), v=torch.zeros(s))",
           "pool = {'v': torch.empty(s)}",
           '"k_scale": torch.ones(sshape, dtype=torch.float32),',
           "scales = dict(k_scale=torch.ones(s), v_scale=torch.ones(s))",
           "{'v_scale': torch.full(s, 1.0)}"]
    good = ['"ln_scale": torch.ones(d)', "k = torch.zeros((4, 4))",
            'kv["k"][bids, offs] = k_new', "kv = dict(k=new_k, v=new_v)",
            'kv["k_scale"][bids, offs] = sk',
            "dict(k_scale=kv.get(\"k_scale\"), v_scale=kv.get(\"v_scale\"))"]
    assert all(_KV_POOL_ALLOC.search(s) for s in bad)
    assert not any(_KV_POOL_ALLOC.search(s) for s in good)


def test_metrics_and_pool_internals_stay_fenced():
    serving = PORT / "serving"
    assert not _offenders(_RAW_STATS_MUTATION, serving, ("telemetry.py",))
    assert not _offenders(_POOL_INTERNAL, serving, ("paged_cache.py",))
    assert _POOL_INTERNAL.search("pool._ref[b] -= 1")
    assert not _POOL_INTERNAL.search("self._free_slots.pop()")
    assert _RAW_STATS_MUTATION.search('self.stats["x"] += 1')
    assert not _RAW_STATS_MUTATION.search('assert eng.stats["x"] == 1')

