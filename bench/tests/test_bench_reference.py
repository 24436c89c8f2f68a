"""The plain references against the port's CPU path at reduced float32
sizes: the weights' layout, the serving forward's logits, the training
loss and one Adam step."""
import copy

import numpy as np
import pytest
import torch

from bench import traffic, weights
from bench.harness import model_config
from bench.reference import decoder as REF
from bench.reference import train as TRAIN_REF
from bench.tests import tiny

SEED = 2**31 + 77


def tiny_config(workload):
    c = tiny.cell(workload)
    return c, c["config"]["model"], model_config(c["config"])


def perturbed(m, seed):
    """The benchmark's weights with the norm scales drawn too, so the
    comparison sees every leaf."""
    p = weights.make(REF.leaf_specs(m), seed, "cpu")
    g = torch.Generator().manual_seed(1)
    for path, _, _, scale in REF.leaf_specs(m):
        if scale is None:
            t = weights.get(p, path)
            t.copy_(1 + 0.1 * torch.randn(t.shape, generator=g))
    return p


@pytest.mark.parametrize("workload", ["mixtral-chat", "yi9b-train"])
def test_weights_in_the_ports_layout(workload):
    from repro_torch.models import transformer as T
    c, m, cfg = tiny_config(workload)
    specs = T.param_specs(cfg)
    got = dict(weights.leaves(REF.leaf_specs(m), SEED, "cpu"))
    want = {}

    def walk(t, path=()):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                want[path + (k,)] = v
    walk(specs)
    assert set(got) == set(want)
    for path, (shape, dtype, _) in want.items():
        assert tuple(got[path].shape) == tuple(shape), path
        assert got[path].dtype == dtype, path
    again = dict(weights.leaves(REF.leaf_specs(m), SEED, "cpu"))
    assert all(torch.equal(got[k], again[k]) for k in got)


@pytest.mark.parametrize("workload", ["mixtral-chat", "yi9b-train"])
def test_forward_logits_match_the_port(workload):
    from repro_torch.models import transformer as T
    c, m, cfg = tiny_config(workload)
    if m.get("num_experts"):
        # dropless in the port too: capacity covers every row
        cfg = model_config(dict(c["config"], model=dict(
            m, capacity_factor=m["num_experts"] / m["experts_per_token"])))
    params = perturbed(m, SEED)
    rng = np.random.default_rng(0)
    lens = (40, 17)
    toks = [torch.as_tensor(rng.integers(0, m["vocab_size"], n))
            for n in lens]
    reads = [torch.arange(n) for n in lens]
    ref = REF.logits_at(m, params, toks, reads)
    for t, r in zip(toks, ref):
        h, _ = T.forward(cfg, params, {"tokens": t[None]})
        port = T.logits(cfg, params, h[0])
        torch.testing.assert_close(r, port, rtol=1e-4, atol=1e-4)


def test_loss_and_one_adam_step_match_the_port():
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train.trainer import make_train_step
    c, m, cfg = tiny_config("yi9b-train")
    hp = c["config"]["trainer"]
    b = {k: torch.from_numpy(v) for k, v in
         traffic.lm_batch(SEED, 0, 2, 32, m["vocab_size"]).items()}
    params = perturbed(m, SEED)
    split = TRAIN_REF.split_params(m, params)
    ref_loss = TRAIN_REF.loss(m, split, b["tokens"], b["labels"])
    port_loss = T.loss_fn(cfg, params, {k: v.long() for k, v in b.items()})
    assert float(ref_loss) == pytest.approx(float(port_loss), rel=1e-5)

    ref_losses, ref_first, ref_change = TRAIN_REF.run_steps(
        m, lambda: perturbed(m, SEED), [b], hp)
    opt = make_optimizer("adam", lr=hp["lr"], beta1=hp["beta1"],
                         beta2=hp["beta2"], eps=hp["eps"],
                         grad_clip=hp["grad_clip"])
    state = {"params": copy.deepcopy(params)}
    state["opt"] = opt.init(state["params"])
    state, out = make_train_step(cfg, opt)(state, b)
    assert float(out["loss"]) == pytest.approx(ref_losses[0], rel=1e-5)
    for path, p0, in weights.leaves(REF.leaf_specs(m), SEED, "cpu"):
        moved = weights.get(state["params"], path) - weights.get(params, path)
        assert float(moved.norm()) == pytest.approx(ref_change[path],
                                                    rel=1e-3, abs=1e-9), path
        g = weights.get(state["opt"]["m"], path) / (1 - hp["beta1"])
        assert float(g.norm()) == pytest.approx(ref_first[path], rel=1e-4), \
            path
