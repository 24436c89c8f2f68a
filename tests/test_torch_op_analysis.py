"""The op-level analyser (``repro_torch.core.op_analysis``) case for case
against ``tests/test_hlo_analysis.py``: known FLOPs, loops, collectives —
and against the reference's ``analyze_hlo_text`` on the same functions
(1%; the tiny decoder's gradient 5%) and ``FlopCounterMode``. Then what
only the eager analyser has: HBM bytes and the memory analysis of a
hand-counted function, ``top_ops`` rows that sum to the totals, a real and
a fake-tensor run of one train step counted alike, and B6's custom op:
its fake implementation on fake CUDA tensors and its registered FLOPs.
Runs on a fake process group go to a subprocess each (the group is
process-wide), with a time limit."""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.core import hlo_analysis as ha
from repro.models import transformer as JT
from repro_torch.configs.base import ModelConfig
from repro_torch.core import op_analysis as oa
from repro_torch.models import transformer as T
from repro_torch.tree import leaves_with_path, tree_from_leaves
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_fake_group(code: str, timeout: int = 120) -> str:
    """`code` in a fresh python (a fake process group is process-wide);
    it prints PASS on success."""
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=timeout,
                       env=env)
    assert r.returncode == 0 and "PASS" in r.stdout, \
        f"subprocess failed:\n{r.stdout}\n{r.stderr[-3000:]}"
    return r.stdout


def jax_flops(fn, *args):
    return ha.analyze_hlo_text(
        jax.jit(fn).lower(*args).compile().as_text())["flops"]


def loop(x, w):
    for _ in range(10):
        x = x @ w
    return x


def nested(x, w):
    for _ in range(3):
        for _ in range(4):
            x = x @ w
    return x


def jax_loop(x, w):
    return jax.lax.scan(lambda c, _: (c @ w, None), x, None, length=10)[0]


def jax_nested(x, w):
    def inner(c):
        return jax.lax.scan(lambda d, _: (d @ w, None), c, None, length=4)[0]
    return jax.lax.scan(lambda c, _: (inner(c), None), x, None, length=3)[0]


# ------------------------------------------------------------------ flops
def test_plain_matmul_exact():
    a, b = torch.zeros(128, 256), torch.zeros(256, 64)
    res = oa.analyze(lambda x, y: x @ y, a, b)
    assert res["flops"] == 2 * 128 * 256 * 64
    assert res["flops"] == pytest.approx(
        jax_flops(lambda x, y: x @ y, jnp.zeros((128, 256)),
                  jnp.zeros((256, 64))), rel=0.01)


@pytest.mark.parametrize("fn,jfn,n,trips", [(loop, jax_loop, 64, 10),
                                            (nested, jax_nested, 32, 12)])
def test_loops_multiply_by_trip_count(fn, jfn, n, trips):
    """A Python loop is unrolled by running it: 10 and 3 x 4 trips."""
    w = torch.zeros(n, n)
    res = oa.analyze(fn, w, w)
    assert res["flops"] == trips * 2 * n ** 3
    z = jnp.zeros((n, n))
    assert res["flops"] == pytest.approx(jax_flops(jfn, z, z), rel=0.01)


def test_matches_flop_counter_mode_without_dtensor():
    a = torch.randn(128, 128)

    def chain(x):
        return torch.relu((x @ x) @ x).sum()
    with FlopCounterMode(display=False) as fc:
        chain(a)
    assert oa.analyze(chain, a)["flops"] == fc.get_total_flops()
    assert fc.get_total_flops() == pytest.approx(
        jax_flops(lambda x: jax.nn.relu((x @ x) @ x).sum(),
                  jnp.zeros((128, 128))), rel=0.01)


TINY = dict(name="t", family="dense", num_layers=4, d_model=128,
            num_heads=4, num_kv_heads=4, head_dim=32, d_ff=256,
            vocab_size=512, loss_chunk=64, attn_chunk=64, remat=False)


def _grad_fn(cfg):
    def grads(params, batch):
        paths, leaves = zip(*leaves_with_path(params))
        live = [p.detach().requires_grad_() for p in leaves]
        loss = T.loss_fn(cfg, tree_from_leaves(zip(paths, live)), batch)
        return torch.autograd.grad(loss, live)
    return grads


def _tiny_batch(cfg):
    rng = np.random.default_rng(0)
    return {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 128)))
            for k in ("tokens", "labels")}


def test_model_grad_flops_match_reference_and_6nd():
    """The tiny decoder of test_hlo_analysis: the port's loss_fn and
    autograd.grad against the JAX grad's compiled HLO (5%: the port's
    chunked attention and loss count as XLA's after fusion only up to the
    masking), between 0.5 and 2.5 x 6ND, and equal to FlopCounterMode."""
    cfg = ModelConfig(**TINY)
    params = T.init_params(cfg, seed=0, device="cpu")
    batch = _tiny_batch(cfg)
    grads = _grad_fn(cfg)
    res = oa.analyze(grads, params, batch)
    with FlopCounterMode(display=False) as fc:
        grads(params, batch)
    assert res["flops"] == fc.get_total_flops()

    jcfg = JaxModelConfig(**TINY)
    jparams = jax.eval_shape(lambda: JT.init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    jbatch = {k: jax.ShapeDtypeStruct((4, 128), jnp.int32)
              for k in ("tokens", "labels")}
    txt = jax.jit(jax.grad(lambda p, b: JT.loss_fn(jcfg, p, b))) \
        .lower(jparams, jbatch).compile().as_text()
    want = ha.analyze_hlo_text(txt)["flops"]
    assert res["flops"] == pytest.approx(want, rel=0.05)
    model = 6 * cfg.param_count() * 4 * 128
    assert 0.5 * model < res["flops"] < 2.5 * model


# -------------------------------------------------------- bytes, memory
def test_bytes_and_memory_of_a_hand_counted_function():
    """Views cost nothing; a copy into a slice and index_put_ count the
    update (2 x update + indices); an in-place add reads and writes its
    buffer; the result that is the argument's storage is aliased."""
    buf = torch.zeros(8, 16)                       # 512 B
    upd = torch.ones(2, 16)                        # 128 B
    idx = torch.tensor([5, 6])                     # 16 B (int64)

    def fn(buf, upd, idx):
        view = buf[2:4].t()                        # views: free
        buf[0:2] = upd                             # copy_: 2 x 128
        buf.index_put_((idx,), upd)                # 2 x 128 + 16
        buf.add_(1.0)                              # 512 + 512
        tmp = buf * 2.0                            # 512 + 512
        return buf, tmp.sum() + view.sum()         # 512 + 4, 128 + 4; 12

    out, an = oa.run(fn, buf, upd, idx)
    res = an.result()
    assert res["flops"] == 0
    assert res["hbm_bytes"] == 256 + 272 + 1024 + 1024 + 516 + 132 + 12
    mem = res["memory"]
    assert mem["argument_size_in_bytes"] == 512 + 128 + 16
    assert mem["output_size_in_bytes"] == 512 + 4
    assert mem["alias_size_in_bytes"] == 512
    # live beyond the arguments at the peak, while the scalars are added:
    # tmp (512), the two sums (8) and the result (4), less the result
    assert mem["temp_size_in_bytes"] == 520
    assert out[0] is buf


@pytest.mark.parametrize("metric", ["flops", "hbm_bytes"])
def test_top_ops_rows_sum_to_the_total(metric):
    cfg = ModelConfig(**{**TINY, "num_layers": 2})
    params = T.init_params(cfg, seed=0, device="cpu")
    _, an = oa.run(_grad_fn(cfg), params, _tiny_batch(cfg), sites=True)
    rows = an.top_ops(None, metric)
    assert sum(r[0] for r in rows) == pytest.approx(an.result()[metric],
                                                    rel=1e-12)
    assert rows == sorted(rows, key=lambda r: -r[0])
    # every row has its call site in the port, but the gradient's seed
    # that autograd.grad makes in this file
    assert [r[1] for r in rows if not r[4]] in ([], ["aten.ones_like"])
    assert an.top_ops(3, metric) == rows[:3]


def test_real_and_fake_train_step_count_alike():
    """One reduced Adam step (remat on) on real CPU tensors and on fake
    ones: equal FLOPs, bytes and memory analysis."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.specs import fake_mode
    from repro_torch.optim import make_optimizer
    from repro_torch.train import trainer
    import dataclasses
    cfg = dataclasses.replace(reduced(get_config("yi-9b")), remat=True,
                              dtype="float32")
    opt = make_optimizer("adam", lr=1e-3)
    step = trainer.make_train_step(cfg, opt)
    rng = np.random.default_rng(1)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 64)))
             for k in ("tokens", "labels")}
    real = oa.analyze(step, trainer.init_state(cfg, opt, device="cpu"),
                      batch)
    with fake_mode() as mode:
        state = trainer.init_state(cfg, opt, device="cpu")
        fbatch = {k: mode.from_tensor(v) for k, v in batch.items()}
        fake = oa.analyze(step, state, fbatch)
    assert real["flops"] > 0 and real["memory"]["alias_size_in_bytes"] > 0
    assert fake == real


def test_a_fake_trace_caches_no_fake_constant():
    """RoPE's device constants made during a fake trace under the analysis
    are real (the analysis makes them outside its modes and the fake
    tensors'): a later real run reads no fake tensor from the cache, and
    the trace counts no op of theirs."""
    from torch._subclasses.fake_tensor import FakeTensor
    from repro_torch.launch.specs import fake_mode
    from repro_torch.models import layers as L
    L._rope_freqs_on.cache_clear()
    with fake_mode():
        x = torch.empty(1, 4, 2, 16)
        pos = torch.empty(1, 4, dtype=torch.long)
        _, an = oa.run(L.apply_rope, x, pos)
    assert L._rope_freqs_on.cache_info().currsize == 1
    freqs = L._rope_freqs_on(16, 10_000.0, torch.device("cpu"))
    assert not isinstance(freqs, FakeTensor)
    np.testing.assert_array_equal(
        freqs.numpy(), L.rope_freqs(16, 10_000.0).astype(np.float32))
    real = oa.analyze(L.apply_rope, torch.ones(1, 4, 2, 16),
                      torch.arange(4)[None])
    assert an.result()["hbm_bytes"] == real["hbm_bytes"] > 0


# ------------------------------------------------------------ collectives
def test_all_reduce_bytes_on_a_fake_group():
    """One all-reduce of a (1, 1024) f32 shard per rank over 8 ranks, as
    the reference's psum test; a DTensor redistribute Shard(0) ->
    Replicate, which all-gathers: its result bytes on the rank; DTensor's
    all-to-all op; and core.pipeline's point-to-point hops as
    collective-permutes."""
    run_fake_group("""
        import torch, torch.distributed as dist
        import torch.distributed._functional_collectives as fc
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import (Replicate, Shard,
                                              distribute_tensor)
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch.core import op_analysis as oa
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=8)
        x = torch.zeros(1, 1024)
        res = oa.analyze(lambda v: fc.all_reduce(v, "sum", dist.group.WORLD)
                         * 1.0, x)
        total = res["total_collective_bytes"]
        assert 4000 <= total <= 16384, total
        assert res["collective_counts"] == {"all-reduce": 1}, res
        mesh = init_device_mesh("cpu", (8,), mesh_dim_names=("data",))
        d = distribute_tensor(torch.zeros(64, 32), mesh, [Shard(0)])
        res = oa.analyze(lambda t: t.redistribute(mesh, [Replicate()])
                         .to_local() + 1.0, d)
        assert res["collective_bytes"] == {"all-gather": 64 * 32 * 4}, res
        assert res["collective_counts"] == {"all-gather": 1}, res
        # DTensor's Shard(0) -> Shard(1) redistribution on the card (torch
        # 2.11): an all-to-all, its (32, 8) f32 result on the rank
        res = oa.analyze(lambda t: torch.ops._dtensor.shard_dim_alltoall(
            t, 0, 1, dist.group.WORLD.group_name), torch.zeros(4, 64))
        assert res["collective_bytes"] == {"all-to-all": 32 * 8 * 4}, res
        assert res["kernel_calls"] == {}, res
        dist.destroy_process_group()
        # core.pipeline on 4 stages, 3 microbatches of (2, 16) f32: M + S - 1
        # hops (each a send and a receive: one permute) and the closing
        # all-reduce of the (3, 2, 16) outputs
        from repro_torch.core.pipeline import pipeline_forward
        from repro_torch.launch.mesh import make_fake_mesh
        mesh = make_fake_mesh((4,), ("stage",), "cpu")
        res = oa.analyze(lambda p, x: pipeline_forward(
            lambda sp, v: v @ sp["w"], p, x, mesh),
            {"w": torch.zeros(4, 16, 16)}, torch.zeros(3, 2, 16))
        assert res["collective_counts"] == {"collective-permute": 6,
                                            "all-reduce": 1}, res
        assert res["collective_bytes"] == {"collective-permute": 6 * 128,
                                           "all-reduce": 384}, res
        print("PASS")
    """)


def test_dtensor_matmul_counts_the_local_product_only():
    """A (1024 x 4096) . (4096 x 14336) product split over a 16 x 16 fake
    mesh: one rank's local product (64 x 4096 . 4096 x 896), not the
    global-shape product DTensor's shape propagation runs; its output
    all-gathered over 'data'."""
    run_fake_group("""
        import torch, torch.distributed as dist
        from torch.distributed.tensor import (Replicate, Shard,
                                              distribute_tensor)
        from repro_torch.core import op_analysis as oa
        from repro_torch.launch.mesh import make_dryrun_mesh
        from repro_torch.launch.specs import fake_mode
        mesh = make_dryrun_mesh(device="cpu")
        with fake_mode():
            x = distribute_tensor(torch.empty(1024, 4096), mesh,
                                  [Shard(0), Replicate()])
            w = distribute_tensor(torch.empty(4096, 14336), mesh,
                                  [Replicate(), Shard(1)])
            res = oa.analyze(lambda a, b: (a @ b).redistribute(
                mesh, [Replicate(), Shard(1)]), x, w)
        assert res["flops"] == 2 * 64 * 4096 * 896, res["flops"]
        assert res["collective_bytes"] == {"all-gather": 1024 * 896 * 4}, res
        mem = res["memory"]
        assert mem["argument_size_in_bytes"] == (64 + 896) * 4096 * 4, mem
        print("PASS")
    """)


# --------------------------------------------------------- B6's custom op
def test_flash_attention_custom_op_fake_and_flops():
    """B6's op on fake CUDA tensors (made with torch.empty inside a
    FakeTensorMode; no autograd: this CPU build cannot make a CUDA
    gradient edge): out in q's shape and dtype, lse (B, H, S) f32, one
    kernel call counted, and its registered FLOPs equal FlopCounterMode's
    count of the plain version at the same shape."""
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import flash_attention_ref, ops
    B, S, H, Hkv, hd = 2, 96, 8, 2, 64
    before = kernels.launch_counts["flash_attention"]
    with FakeTensorMode():
        q = torch.empty(B, S, H, hd, device="cuda", dtype=torch.bfloat16)
        k = torch.empty(B, S, Hkv, hd, device="cuda", dtype=torch.bfloat16)
        out, lse = ops._forward_kernel(q, k, k, hd ** -0.5, True, None)
        res = oa.analyze(ops._forward_kernel, q, k, k, hd ** -0.5, True, 16)
        with torch.no_grad():
            y = ops.flash_attention(q, k, k)
    assert out.shape == (B, S, H, hd) and out.dtype == torch.bfloat16
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    assert out.is_cuda and lse.is_cuda and y.shape == q.shape
    assert kernels.launch_counts["flash_attention"] == before
    assert res["kernel_calls"] == {"flash_attention_fwd": 1}
    assert res["hbm_bytes"] == (2 * q.numel() + 2 * k.numel()) * 2 \
        + lse.numel() * 4
    qc, kc = torch.randn(B, S, H, hd), torch.randn(B, S, Hkv, hd)
    with FlopCounterMode(display=False) as fc:
        flash_attention_ref(qc, kc, kc)
    assert res["flops"] == fc.get_total_flops() == 4 * B * H * S * S * hd
    with pytest.raises(NotImplementedError):   # no CPU implementation
        ops._forward_kernel(qc, kc, kc, hd ** -0.5, True, None)
