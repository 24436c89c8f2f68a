"""Tiny cells for the harness's CPU tests: the benchmark's own
configurations and mixes cut to a size a test run holds, every width
small, in float32."""
from __future__ import annotations

import copy

from bench import harness

MODEL = {"num_layers": 2, "d_model": 64, "num_heads": 4, "num_kv_heads": 2,
         "head_dim": 16, "d_ff": 96, "vocab_size": 128, "dtype": "float32",
         "loss_chunk": 32, "attn_chunk": 32}
MOE = {"num_experts": 4, "experts_per_token": 2, "capacity_factor": 2.0}


def cell(name: str) -> dict:
    """The workload `name` of BENCHMARK.json at the tiny size."""
    c = copy.deepcopy(harness.cell(name))
    m = c["config"]["model"]
    m.update(MODEL)
    if m.get("num_experts"):
        m.update(MOE)
    if "engine" in c["config"]:
        c["config"]["engine"].update(
            block_size=8, num_blocks=6 * 8, max_blocks_per_seq=8,
            max_slots=4, prefill_chunk=16)
        c["traffic"].update(
            clients=4, conversations_per_client=2, turns=3, max_context=64,
            warmup_steps=6, trace_steps=4,
            first_message={"median": 20, "sigma": 0.8, "min": 4, "max": 40},
            next_message={"median": 6, "sigma": 0.8, "min": 2, "max": 12},
            answer={"median": 6, "sigma": 0.8, "min": 2, "max": 12})
        c["limits"].update(mean_gap=1e-4, sample_tokens=20,
                           sample_requests=3)
    else:
        c["traffic"].update(batch=2, seq=32, trace_steps=1)
        c["limits"].update(loss_gap=1e-4, first_grad_gap=1e-3,
                           change_gap=1e-3)
    return c
