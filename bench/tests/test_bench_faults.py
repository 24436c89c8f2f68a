"""The rest of a run, without the look for a card, on the CPU at a tiny
size: sound, it comes out correct; with the timed path broken underneath,
or with the precision control in the program's place, it does not."""
import pytest

from bench import compare, harness
from bench.tests import tiny

SEED = 2**31 + 4242


def serve(**kw):
    c = tiny.cell("mixtral-chat")
    drv = harness.driver(c["traffic"]["driver"])
    return c, drv, drv.run(c, seed=SEED, seconds=0, trace=False,
                           device="cpu", steps=24, **kw)


def train():
    c = tiny.cell("yi9b-train")
    drv = harness.driver(c["traffic"]["driver"])
    return c, drv, drv.run(c, seed=SEED, seconds=0, trace=False,
                           device="cpu", steps=2)


@pytest.fixture(scope="module")
def sound_serve():
    return serve()


@pytest.fixture(scope="module")
def sound_train():
    return train()


def test_sound_serving_is_correct(sound_serve):
    _, _, res = sound_serve
    assert res["correct"], res["notes"]
    assert res["readings"]["mean_gap"] == 0.0


def test_serving_token_altered_where_produced(monkeypatch):
    from repro_torch.models import transformer as T
    real = T.paged_decode_step

    def altered(*a, **k):
        logits, pool = real(*a, **k)
        logits = logits.clone()
        logits[:, 7] += 1e4                 # every slot emits token 7
        return logits, pool
    monkeypatch.setattr(T, "paged_decode_step", altered)
    _, _, res = serve()
    assert not res["correct"]
    assert res["readings"]["mean_gap"] > 0


def test_serving_precision_control_fails(sound_serve):
    c, drv, res = sound_serve
    got = drv.controls(res, c, SEED)
    _, ok = compare.judge(got["control_fp8"], c["limits"])
    assert not ok


def test_sound_training_is_correct(sound_train):
    _, _, res = sound_train
    assert res["correct"], res["notes"]


def test_training_state_returned_unchanged(monkeypatch):
    from repro_torch.optim import optimizers as O
    real = O.make_optimizer

    def frozen(*a, **k):
        opt = real(*a, **k)
        return O.Optimizer(opt.name, opt.init, lambda g, s, p: (p, s))
    monkeypatch.setattr(O, "make_optimizer", frozen)
    _, _, res = train()
    assert not res["correct"]
    assert res["readings"]["change_gap"][0] == pytest.approx(1.0)


def test_training_half_the_batch_left_out(monkeypatch):
    from repro_torch.train import trainer as TR
    real = TR.make_train_step

    def halved(*a, **k):
        step = real(*a, **k)

        def run(state, batch):
            n = batch["tokens"].shape[0] // 2
            return step(state, {key: v[:n] for key, v in batch.items()})
        return run
    monkeypatch.setattr(TR, "make_train_step", halved)
    _, _, res = train()
    assert not res["correct"]


def test_training_precision_control_fails(sound_train):
    c, drv, res = sound_train
    got = drv.controls(res, c, SEED)
    for name in ("control_fp8", "half_batch"):
        _, ok = compare.judge(got[name], c["limits"])
        assert not ok, name
