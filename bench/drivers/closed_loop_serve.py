"""closed_loop_serve: a gateway holding one request per client in flight
through the port's serving engine; each client sends its next turn (its
conversation so far and a new message, ``bench.traffic.ChatSessions``)
when the last token of its answer reaches it.

The loop streams tokens as a server must: after ``Engine.step()`` issues
step n it queues the copy of step n's token vectors to pinned host memory
and an event, issues step n + 1, then waits for step n's event and stamps
each token with the host clock as its value arrives. Requests are greedy,
with random token ids.

Set-up: weights made on the device from the seed, the engine (pools, its
prefill warm-up), then `warmup_steps` steps of the loop. The window then
runs for the given seconds; every step of it leaves a raw record for the
per-layer readers (``Capture.record``). Afterwards the engine is freed and
a sample of the finished requests, drawn from the seed and holding the
longest, is run through the configuration's float32 reference
(``bench/reference/<reference>.py``): the gaps by which served tokens'
reference logits lie below the reference's best decide ``correct``.
"""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from bench import compare, harness, profiling, traffic, weights

SPANS = ("engine/prefill", "engine/decode")
clock = time.perf_counter


@dataclass
class Rec:
    rid: int
    client: int
    key: tuple                      # the conversation's, in the traffic
    submit: float
    prompt: np.ndarray
    max_new: int
    issued: int = 0                 # tokens the engine has recorded
    prefilled: int = -1             # prompt tokens in the cache (-1: queued)
    tokens: list = field(default_factory=list)
    stamps: list = field(default_factory=list)


class TokenPipe:
    """Token values from the device to the host, one step behind: `send`
    queues copies of a step's token vectors into pinned buffers and an
    event; `receive` waits for the event and returns the arrival time."""

    def __init__(self, device, width: int, depth: int = 8):
        self.cuda = torch.device(device).type == "cuda"
        self.bufs = [torch.empty(width, dtype=torch.int32,
                                 pin_memory=self.cuda) for _ in range(depth)]
        self.next = 0

    def send(self, refs):
        """refs: [(rec, token index, (vector, row) or int)]."""
        out, seen = [], {}
        for rec, k, ref in refs:
            if isinstance(ref, tuple):
                vec, row = ref
                buf = seen.get(id(vec))
                if buf is None:
                    buf = seen[id(vec)] = self.bufs[self.next]
                    self.next = (self.next + 1) % len(self.bufs)
                    buf[:vec.numel()].copy_(vec, non_blocking=self.cuda)
                out.append((rec, k, buf, int(row)))
            else:
                out.append((rec, k, None, int(ref)))
        event = None
        if self.cuda:
            event = torch.cuda.Event()
            event.record()
        return event, out

    def receive(self, ticket):
        event, out = ticket
        if event is not None:
            event.synchronize()
        now = clock()
        for rec, k, buf, row in out:
            if k != len(rec.tokens):
                raise RuntimeError(f"request {rec.rid}: token {k} arrived "
                                   f"after {len(rec.tokens)}")
            rec.tokens.append(int(buf[row]) if buf is not None else row)
            rec.stamps.append(now)
        return now


def p95(xs) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), 95))


def run(c, *, seed, seconds, trace, device, steps=None):
    """One run of the cell `c` (``harness.cell``). `steps`, for tests,
    replaces the window's seconds by a count of steps."""
    from repro_torch.serving.engine.engine import Engine, EngineConfig
    conf, mix, lim = c["config"], c["traffic"], c["limits"]
    m = conf["model"]
    ref = harness.reference(conf["reference"])
    cfg = harness.model_config(conf)
    ecfg = EngineConfig(**conf["engine"])
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    params = weights.make(ref.leaf_specs(m), seed, device)
    eng = Engine(cfg, params, ecfg, device=device)
    chats = traffic.ChatSessions(mix, seed, m["vocab_size"])
    recs: dict = {}
    filling: dict = {}              # rid -> Rec, prompt not all prefilled
    refused = []

    def submit(client, now):
        key, prompt, max_new = chats.next_turn(client)
        try:
            rid = eng.add_request(prompt, max_new)
        except ValueError as err:
            refused.append(str(err))
            return
        recs[rid] = filling[rid] = Rec(rid, client, key, now, prompt,
                                       max_new)

    pipe = TokenPipe(device, max(ecfg.max_slots, ecfg.prefills_per_step))
    record = []                     # one entry a step of the window
    now_in = {"window": False, "traced": False}

    def step_once():
        """Issue one engine step; note what it does: its host time, the
        prompt rows it prefills, each decoding slot's keys, each admitted
        request's prompt and cached tokens."""
        t = clock()
        emitted = eng.step()
        host = clock() - t
        refs, decode = [], []
        for rid in emitted:
            r = recs[rid]
            k = r.issued
            r.issued += 1
            refs.append((r, k, eng.requests[rid].out_tokens[k]))
            if k:
                decode.append(len(r.prompt) + k)
        ticket = pipe.send(refs)
        prefill, admitted = [], []
        for rid, r in list(filling.items()):
            req = eng.requests[rid]
            if req.state == "waiting":
                continue
            if r.prefilled < 0:     # admitted in this step
                r.prefilled = (req.prefill_len - 1 if req.cow_src is not None
                               else req.shared_blocks * ecfg.block_size)
                admitted.append([len(r.prompt), r.prefilled])
            if req.prefilled > r.prefilled:
                prefill.append([r.prefilled, req.prefilled - r.prefilled])
                r.prefilled = req.prefilled
            if r.prefilled == len(r.prompt):
                del filling[rid]
        return ticket, {"traced": now_in["traced"], "host_s": host,
                        "prefill": prefill, "decode": decode,
                        "admitted": admitted, "emitted": len(emitted)}

    pending = [None]

    def advance():
        t = clock()
        ticket, step = step_once()
        if pending[0] is not None:
            now = pipe.receive(pending[0])
            for r in {id(x[0]): x[0] for x in pending[0][1]}.values():
                if len(r.tokens) == r.max_new:
                    chats.answered(r.key, r.prompt, r.tokens)
                    submit(r.client, now)
        pending[0] = ticket
        step["wall_s"] = clock() - t
        if now_in["window"]:
            record.append(step)

    now = clock()
    for client in range(mix["clients"]):
        submit(client, now)
    for _ in range(mix["warmup_steps"]):
        advance()
    stats = {"window_start": dict(eng.stats)}
    now_in["window"] = True
    window_start = clock()
    end = window_start + seconds
    trace_at = window_start + mix["trace_after"] * seconds
    prof, n = None, 0
    while (n < steps) if steps is not None else (clock() < end):
        if trace and prof is None and (
                clock() >= trace_at if steps is None else n == steps // 2):
            now_in["traced"] = True
            prof, win, _ = profiling.traced(lambda: [
                advance() for _ in range(mix["trace_steps"])])
            now_in["traced"] = False
        else:
            advance()
        n += 1
    if steps is not None:
        end = clock()
    if pending[0] is not None:
        pipe.receive(pending[0])
    stats["window_end"] = dict(eng.stats)
    peak = 0
    if cuda:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    capture = None
    if prof is not None:            # reduced once the window has closed
        capture = profiling.summarize(prof, win, SPANS)
        del prof
        capture.record = {"model": m, "engine": conf["engine"], "mix": mix,
                          "steps": record, "stats": stats,
                          "peak_bytes": int(peak)}
    del eng
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # end-to-end, by the client's clock
    done = [r for r in recs.values() if len(r.tokens) == r.max_new]
    stamps = [t for r in recs.values() for t in r.stamps]
    in_win = sum(window_start <= t <= end for t in stamps)
    ttft = [r.stamps[0] - r.submit for r in recs.values()
            if r.stamps and window_start <= r.stamps[0] <= end]
    tpot = [(r.stamps[-1] - r.stamps[0]) / (r.max_new - 1) for r in done
            if r.max_new > 1 and window_start <= r.stamps[-1] <= end]
    e2e = {"serve_tokens_per_s": in_win / (end - window_start)}
    if ttft:
        e2e["ttft_p95_ms"] = p95(ttft) * 1e3
    if tpot:
        e2e["tpot_p95_ms"] = p95(tpot) * 1e3

    sample = draw_sample(done, seed, lim)
    gaps = served_gaps(m, ref, params, sample)
    readings = compare.gap_readings(gaps)
    checks, correct = compare.judge(readings, lim)
    correct = correct and gaps.numel() > 0 and not refused
    untraced = [s["wall_s"] for s in record if not s["traced"]]
    step_ms = sum(untraced) / max(len(untraced), 1) * 1e3
    cached = sum(a[1] for s in record for a in s["admitted"])
    asked = sum(a[0] for s in record for a in s["admitted"])
    notes = [f"requests submitted {len(recs) + len(refused)}, refused "
             f"{len(refused)}, finished {len(done)}, first tokens in window "
             f"{len(ttft)}, finished in window {len(tpot)}, tokens in window "
             f"{in_win}, tokens compared {gaps.numel()} of {len(sample)} "
             f"requests",
             "readings " + ", ".join(f"{k} {v!r}" for k, v in
                                     readings.items()),
             "client numbers " + ", ".join(f"{k} {v!r}" for k, v in
                                           e2e.items()),
             f"window steps {len(record)}, with a decode "
             f"{sum(bool(s['decode']) for s in record)}, decode tokens "
             f"{sum(len(s['decode']) for s in record)}, prompt tokens "
             f"prefilled {sum(p[1] for s in record for p in s['prefill'])}, "
             f"prompt tokens cached {cached} of {asked}, mean untraced step "
             f"{step_ms:.2f} ms"]
    return {"window_start": window_start, "e2e": e2e, "checks": checks,
            "correct": bool(correct), "attempted": len(recs) + len(refused),
            "failed": len(refused), "memory_peak_bytes": int(peak),
            "capture": capture, "notes": notes, "sample": sample,
            "params": params, "readings": readings}


def draw_sample(done, seed, lim):
    """The longest finished request, then others drawn from the seed,
    until `sample_tokens` served tokens or `sample_requests` requests."""
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.prompt) + r.max_new, r.submit))
    rest = [r for r in done if r is not longest]
    order = np.random.default_rng([int(seed), 3]).permutation(len(rest))
    out, n = [longest], longest.max_new
    for i in order:
        if n >= lim["sample_tokens"] or len(out) >= lim["sample_requests"]:
            break
        out.append(rest[i])
        n += rest[i].max_new
    return out


def reference_inputs(sample, device):
    toks = [torch.as_tensor(np.concatenate([r.prompt, r.tokens[:-1]]),
                            dtype=torch.long, device=device) for r in sample]
    reads = [torch.arange(len(r.prompt) - 1, len(r.prompt) - 1 + r.max_new,
                          device=device) for r in sample]
    return toks, reads


def served_gaps(m, ref, params, sample, lin=None):
    """The gaps of the sample's served tokens against the float32
    reference module `ref` (``compare.token_gaps``)."""
    if not sample:
        return torch.zeros(0, dtype=torch.float64)
    ref.highest_precision()
    device = params["embed"]["table"].device
    toks, reads = reference_inputs(sample, device)
    logits = ref.logits_at(m, params, toks, reads, lin or ref.linear)
    return compare.token_gaps(logits, [r.tokens for r in sample])


def controls(res, c, seed) -> dict:
    """{control: its readings} on this run's sample: the precision
    control's, the gaps of the tokens that the float8 reference puts
    first, at the same positions of the same prompts and served tokens."""
    from bench.reference.control import fp8_linear
    m, params, sample = c["config"]["model"], res["params"], res["sample"]
    ref = harness.reference(c["config"]["reference"])
    ref.highest_precision()
    toks, reads = reference_inputs(sample, params["embed"]["table"].device)
    exact = ref.logits_at(m, params, toks, reads)
    low = ref.logits_at(m, params, toks, reads, fp8_linear)
    gaps = compare.token_gaps(exact, [lg.argmax(dim=-1) for lg in low])
    return {"control_fp8": compare.gap_readings(gaps)}
