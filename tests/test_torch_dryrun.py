"""The port's dry run (``repro_torch.launch.{specs,mesh,dryrun}``) against
the reference's (``repro.launch``): ``input_specs`` keys, shapes and dtypes
equal the reference's ``ShapeDtypeStruct`` trees for every config and
shape, as fake tensors (nothing allocated); ``shape_applicable`` alike;
the reference's own dry-run smoke (rwkv6-7b decode_32k on the 16 x 16
production mesh, phi4-mini-3.8b long_500k skipped) with ``device="cpu"``;
per-device FLOPs of a reduced train step, prefill and decode step under
dp_tp on a (2, 4) mesh against the reference's ``lower_combo`` +
``analyze_compiled`` at 8 fake devices (10%); and
``results/make_tables.py`` rendering the port's records. Each fake-group run is a subprocess with a time limit (the group
is process-wide); the JAX one runs beside it."""
import concurrent.futures
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import textwrap

import jax
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor

from conftest import run_multidev
from repro.configs import base as JB
from repro.launch import specs as jspecs
from repro_torch.configs import base as B
from repro_torch.launch import dryrun, specs
from repro_torch.tree import leaves_with_path

pytestmark = pytest.mark.port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = sorted(B.list_configs())


def run_fake_group(code: str, timeout: int) -> str:
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=timeout,
                       env=env)
    assert r.returncode == 0 and "PASS" in r.stdout, \
        f"subprocess failed:\n{r.stdout}\n{r.stderr[-3000:]}"
    return r.stdout


def _jax_leaves(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in p): v
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", sorted(B.SHAPES))
def test_input_specs_match_reference(arch, shape):
    """Keys, shapes and dtypes equal the reference's abstract inputs; every
    leaf a fake tensor (on the CPU here: this build cannot make the decode
    cache's fake CUDA tensors; the card's dry run makes them)."""
    want = _jax_leaves(jspecs.input_specs(JB.get_config(arch),
                                          JB.SHAPES[shape]))
    got = dict(leaves_with_path(specs.input_specs(
        B.get_config(arch), B.SHAPES[shape], device="cpu")))
    got = {"/".join(k): v for k, v in got.items()}
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert isinstance(v, FakeTensor), k
        assert v.device.type == "cpu", k
        assert tuple(v.shape) == tuple(want[k].shape), k
        assert str(v.dtype).removeprefix("torch.") == str(want[k].dtype), k


def test_shape_applicable_matches_reference():
    for arch in ARCHS:
        for name in B.SHAPES:
            assert (specs.shape_applicable(B.get_config(arch),
                                           B.SHAPES[name])
                    == jspecs.shape_applicable(JB.get_config(arch),
                                               JB.SHAPES[name]))


def test_dry_run_refuses_the_cpu_without_asking():
    from repro_torch.launch.mesh import make_dryrun_mesh
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is usable")
    assert inspect.signature(dryrun.run).parameters["device"].default \
        == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.run("rwkv6-7b", "decode_32k", "single", "dp_tp", quiet=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_dryrun_mesh()
    assert not torch.distributed.is_initialized()


def _make_tables():
    spec = importlib.util.spec_from_file_location(
        "make_tables", os.path.join(REPO, "results", "make_tables.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_reference_dry_run_smoke_and_tables(tmp_path):
    """tests/test_accum_and_dryrun.py's dry run on the port (CPU path):
    one full-config decode combo traced on the 256-rank fake mesh, and the
    skipped long_500k; results/make_tables.py renders both records."""
    run_fake_group(f"""
        from repro_torch.launch.dryrun import run
        rec = run('rwkv6-7b', 'decode_32k', 'single', 'dp_tp', quiet=True,
                  device='cpu', out_path={str(tmp_path / 'a.json')!r})
        assert rec['status'] == 'ok', rec
        assert rec['chips'] == 256
        assert rec['fits_hbm'] is True
        assert rec['roofline']['memory_s'] > 0
        assert rec['memory']['alias_size_in_bytes'] > 0   # the state
        rec2 = run('phi4-mini-3.8b', 'long_500k', 'single', 'dp_tp',
                   quiet=True, device='cpu',
                   out_path={str(tmp_path / 'b.json')!r})
        assert rec2['status'] == 'skipped'
        print('PASS')
    """, timeout=300)
    mt = _make_tables()
    rows = mt.load(str(tmp_path))
    table = mt.fmt(rows, "single")
    assert "| rwkv6-7b | decode_32k |" in table
    assert "| phi4-mini-3.8b | long_500k | — |" in table
    assert "1 lowered+compiled, 1 documented skips" in mt.dryrun_stats(rows)
    rec = json.loads((tmp_path / "a.json").read_text())
    assert rec["hbm_needed_per_device"] < 85_017_493_504


# train: dense GQA (yi-9b's 1 kv head: the query heads split, the kv
# replicated), MHA (heads split), local-global and MoE; the serving kinds
# (forward + last-position logits, one dense-cache decode step) of dense
# GQA and MoE (the serving verbs' MoE keeps the global capacity), and the
# recurrent and hybrid decode steps
ARCHS_24 = ("yi-9b", "stablelm-3b", "gemma3-12b", "qwen3-moe-30b-a3b")
SERVING_24 = tuple((arch, kind) for arch in ("yi-9b", "qwen3-moe-30b-a3b")
                   for kind in ("prefill", "decode")) + (
    ("rwkv6-7b", "decode"), ("zamba2-2.7b", "decode"))
COMBOS_24 = tuple((arch, "train") for arch in ARCHS_24) + SERVING_24
SHAPE_24 = (8, 128)          # global batch, sequence (the decode's cache)


@pytest.fixture(scope="module")
def flops_24(tmp_path_factory):
    """Per-device counts of each of COMBOS_24, reduced, under dp_tp on a
    (2, 4) ('data', 'model') mesh, keyed "arch/kind": the reference's
    loop-aware count of its compiled SPMD module at 8 fake devices (Auto
    axes), and the port's on rank 0 of a fake group, in two processes at
    once."""
    d = tmp_path_factory.mktemp("dp_tp_24")
    jax_code = f"""
        import json
        from repro.configs.base import InputShape, get_config, reduced
        from repro.core import hlo_analysis as ha
        from repro.launch.dryrun import lower_combo
        from repro.launch.mesh import _make_mesh
        mesh = _make_mesh((2, 4), ("data", "model"))
        out = {{}}
        for arch, kind in {COMBOS_24!r}:
            shape = InputShape(kind, {SHAPE_24[1]}, {SHAPE_24[0]}, kind)
            lowered, _ = lower_combo(reduced(get_config(arch)), shape, mesh,
                                     "dp_tp")
            out[arch + "/" + kind] = ha.analyze_compiled(lowered,
                                                         lowered.compile())
        open({str(d / 'jax.json')!r}, "w").write(json.dumps(out))
        print("PASS")
    """
    port_code = f"""
        import json
        from repro_torch.configs.base import InputShape, get_config, reduced
        from repro_torch.launch.dryrun import lower_combo
        from repro_torch.launch.mesh import make_fake_mesh
        mesh = make_fake_mesh((2, 4), ("data", "model"), "cpu")
        out = {{}}
        for arch, kind in {COMBOS_24!r}:
            shape = InputShape(kind, {SHAPE_24[1]}, {SHAPE_24[0]}, kind)
            an, _, _ = lower_combo(reduced(get_config(arch)), shape, mesh,
                                   "dp_tp", device="cpu", sites=True)
            res = out[arch + "/" + kind] = an.result()
            res["top"] = an.top_ops(10, "flops")
        open({str(d / 'port.json')!r}, "w").write(json.dumps(out))
        print("PASS")
    """
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        runs = [pool.submit(run_multidev, jax_code, devices=8, timeout=400),
                pool.submit(run_fake_group, port_code, 400)]
        for r in runs:
            r.result()
    return (json.loads((d / "jax.json").read_text()),
            json.loads((d / "port.json").read_text()))


def _check_flops_24(flops_24, key):
    """The port's per-device FLOPs within 10% of the reference's (its
    rows by FLOPs in the message where they are not); both move partial
    sums (the gradients' and the activations')."""
    want, got = flops_24[0][key], flops_24[1][key]
    assert got["flops"] == pytest.approx(want["flops"], rel=0.10), \
        got["top"]
    assert got["collective_counts"]["all-reduce"] > 0
    assert want["collectives"]["counts"]["all-reduce"] > 0


@pytest.mark.parametrize("arch", ARCHS_24)
def test_dp_tp_flops_per_device_match_reference(flops_24, arch):
    """A train step's."""
    _check_flops_24(flops_24, f"{arch}/train")


@pytest.mark.parametrize("arch,kind", SERVING_24)
def test_dp_tp_serving_flops_per_device_match_reference(flops_24, arch,
                                                         kind):
    """A prefill's and a decode step's: the token embedding and each
    attention layer's sublayers join the residual stream's placements,
    and the MoE's experts stay split over the tensor axes (left partial
    sums, or gathered whole, every rank ran whole layers: 1.4x yi-9b's
    decode count, 3.7x qwen3-moe's, 1.6x rwkv6's)."""
    _check_flops_24(flops_24, f"{arch}/{kind}")


def test_recompute_runs_in_the_forward_plan_on_another_thread():
    """On the card the autograd engine runs the backward pass (and a
    checkpoint's recomputation) on a thread of its own: the recomputation
    still sees the plan of its forward pass (a context variable alone does
    not reach that thread)."""
    import threading
    from repro_torch.core import parallelism as par
    plan = par.make_plan("dp_tp", par.AbstractMesh((2, 4), ("data",
                                                           "model")))
    seen = []

    def fn(x):
        seen.append(par.current_plan())
        return x * x                     # saves x: the backward recomputes

    x = torch.ones(4, requires_grad=True)
    with par.plan_context(plan):
        y = par.checkpoint(fn, x).sum()
    grads = []
    t = threading.Thread(target=lambda: grads.append(
        torch.autograd.grad(y, x)[0]))
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    assert seen == [plan, plan]          # the forward, then the recompute
    assert torch.equal(grads[0], torch.full((4,), 2.0))      # d(x^2) at 1
    assert par.current_plan() is None
