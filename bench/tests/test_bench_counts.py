"""The operation and byte counts against hand counts for one layer of each
configuration."""
import json

import pytest

from bench import counts
from bench.harness import BENCH

MIX = json.loads((BENCH / "configs" / "mixtral-8x7b-16l.json").read_text())
YI = json.loads((BENCH / "configs" / "yi-9b-16l.json").read_text())


def one_layer(m):
    return dict(m, num_layers=1)


def test_matmul_params_of_one_layer():
    # q and o: 4096 x 32 x 128 each; k and v: 4096 x 8 x 128 each; two of
    # eight experts' SwiGLU (3 x 4096 x 14336 each) and the 4096 x 8 router
    assert counts.layer_matmul_params(MIX["model"]) == (
        2 * 4096 * 4096 + 2 * 4096 * 1024 + 2 * 3 * 4096 * 14336
        + 4096 * 8)
    # yi-9b: 4 kv heads, the dense SwiGLU of 11008
    assert counts.layer_matmul_params(YI["model"]) == (
        2 * 4096 * 4096 + 2 * 4096 * 512 + 3 * 4096 * 11008)


def test_pairs():
    assert counts.pairs(0, 4) == 1 + 2 + 3 + 4
    assert counts.pairs(3, 2) == 4 + 5
    assert counts.pairs(0, 6, window=3) == 1 + 2 + 3 + 3 + 3 + 3
    assert counts.pairs(4, 3, window=5) == 5 + 5 + 5
    assert counts.pairs(2, 3, window=4) == 3 + 4 + 4
    brute = sum(min(p + 1, 100) for p in range(37, 37 + 250))
    assert counts.pairs(37, 250, window=100) == brute


def test_forward_and_training_flops():
    m = one_layer(YI["model"])
    n = counts.layer_matmul_params(m)
    # one token at position 0: 2 FLOPs a weight, one pair of 32 heads x
    # 128 x 4, and the head
    assert counts.forward_flops(m, 1, 1, 1) == (
        2 * n + 4 * 32 * 128 + 2 * 4096 * 64000)
    S = 8
    want = 3 * (2 * n * S + 4 * 32 * 128 * (S * (S + 1) // 2)
                + 2 * 4096 * 64000 * S)
    assert counts.train_step_flops(m, 1, S) == want


def test_b2_bytes_by_hand():
    m = dict(one_layer(MIX["model"]), attention_type="sliding",
             window_size=64)
    # in a window of 64: two decoding slots of 100 and 20 keys read 64 and
    # 20, 64 rows, blocks of 16: keys and values 84 x 8 heads x 128 x 2 x
    # 2 B; pages 4 + 2; q and out 64 x 32 x 128 x 2 B each
    assert counts.paged_decode_bytes(m, [100, 20], 64, 16) == (
        84 * 8 * 128 * 2 * 2 + 4 * (4 + 2) + 2 * 64 * 32 * 128 * 2)


def test_b1_bytes_by_hand():
    m = one_layer(MIX["model"])
    # whole contexts: 100 and 20 keys, pages ceil(100 / 16) + ceil(20 / 16)
    assert counts.paged_decode_bytes(m, [100, 20], 64, 16) == (
        120 * 8 * 128 * 2 * 2 + 4 * (7 + 2) + 2 * 64 * 32 * 128 * 2)
    assert counts.window(m) is None


def test_b6_call_by_hand():
    m = one_layer(YI["model"])
    f, b = counts.b6_call(m, 2, 4096)
    assert f == 4 * 128 * 32 * 2 * (4096 * 4097 // 2)
    assert b == 2 * 4096 * 128 * (2 * 32 + 2 * 4) * 2 + 4 * 2 * 32 * 4096
    assert counts.roofline_s(f, b) == pytest.approx(
        f / counts.H100["bf16_flops"])
