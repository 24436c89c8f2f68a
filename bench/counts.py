"""The benchmark's yardstick for work: the card's peaks, the operations a
model step needs, and the bytes and operations each kernel call needs.

Model FLOPs count every matrix product a token needs and nothing else: 2
per multiply-add, the LM head, the router and the k experts a token is
routed to, causal attention at the pairs a query attends (half the square
for a whole sequence, capped by the window), and no recomputation. The
embedding lookup does no FLOPs. Training counts the forward three times
(forward, and the backward's two products per forward product).

Kernel bytes count each input read once and each output written once,
whatever the kernel reads again.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
H100 = {
    "bf16_flops": 989e12,
    "f32_flops": 67e12,
    "hbm_bytes_per_s": 3.35e12,
    "memory_bytes": 80e9,
}

DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def head_dim(m: dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["num_heads"]


def layer_matmul_params(m: dict) -> int:
    """Weights of one decoder layer that a token multiplies by: the q, k,
    v and o projections, and the SwiGLU or, in an MoE layer, the router and
    the k experts it is routed to."""
    d, hd = m["d_model"], head_dim(m)
    attn = 2 * d * m["num_heads"] * hd + 2 * d * m["num_kv_heads"] * hd
    if m.get("num_experts"):
        ffn = (m["experts_per_token"] * 3 * d * m["d_ff"]
               + d * m["num_experts"])
    else:
        ffn = 3 * d * m["d_ff"]
    return attn + ffn


def window(m: dict):
    """The attention window of a sliding-window model, else None."""
    return m["window_size"] if m.get("attention_type") == "sliding" else None


def pairs(start: int, n: int, window: int | None = None) -> int:
    """Query-key pairs of n queries at positions start .. start + n - 1,
    each attending every earlier position and itself, at most `window`."""
    if n <= 0:
        return 0
    hi = start + n                       # attended counts p + 1 for p < hi
    if window is None or hi <= window:
        return (hi * (hi + 1) - start * (start + 1)) // 2
    full = max(0, window - start)        # queries below the cap
    capped = n - full
    return pairs(start, full) + capped * window


def forward_flops(m: dict, tokens: int, attn_pairs: int,
                  head_tokens: int) -> float:
    """Model FLOPs of `tokens` token rows through every layer, attending
    `attn_pairs` query-key pairs in each, and `head_tokens` rows through
    the LM head."""
    L, d, hd = m["num_layers"], m["d_model"], head_dim(m)
    return (2.0 * L * layer_matmul_params(m) * tokens
            + 4.0 * m["num_heads"] * hd * L * attn_pairs
            + 2.0 * d * m["vocab_size"] * head_tokens)


def train_step_flops(m: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step on batch x seq tokens: three times
    the forward, no recomputation."""
    return 3.0 * forward_flops(m, batch * seq,
                               batch * pairs(0, seq, window(m)), batch * seq)


def paged_decode_bytes(m: dict, keys: list, slots: int,
                       block_size: int) -> int:
    """Bytes one paged decode call (B1, or B2 in a window) needs: each
    decoding slot's keys and values (`keys`: the keys each attends,
    capped by the window), its block-table entries for them, and the query
    and output rows of all `slots` rows, in the pool's type."""
    hd, b, w = head_dim(m), DTYPE_BYTES[m["dtype"]], window(m)
    live = [min(k, w) if w else k for k in keys]
    kv = sum(live) * m["num_kv_heads"] * hd * 2 * b
    pages = sum(-(-k // block_size) for k in live)
    qo = 2 * slots * m["num_heads"] * hd * b
    return kv + 4 * pages + qo


def b6_call(m: dict, batch: int, seq: int, window: int | None = None):
    """(FLOPs, bytes) one causal flash-attention forward call (B6) needs:
    4 * hd FLOPs per query-key pair and head; q, k, v read and the output
    written in the model's type, the f32 log-sum-exp written."""
    hd, b = head_dim(m), DTYPE_BYTES[m["dtype"]]
    H, Hkv = m["num_heads"], m["num_kv_heads"]
    flops = 4.0 * hd * H * batch * pairs(0, seq, window)
    nbytes = (batch * seq * hd * (2 * H + 2 * Hkv) * b
              + 4 * batch * H * seq)
    return flops, nbytes


def roofline_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the bf16 compute
    bound and the HBM bound."""
    return max(flops / H100["bf16_flops"], nbytes / H100["hbm_bytes_per_s"])
