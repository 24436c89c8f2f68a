"""Plain float32 reference of the decoders the benchmark runs: token
embedding scaled by sqrt(d), then per layer RMSNorm, causal (and, for a
sliding-window model, windowed) grouped-query attention with rotary
positions, a residual, RMSNorm and a SwiGLU or a dropless top-k mixture of
experts, a residual; a final RMSNorm and the LM head.

Plain ``torch`` in float32 with TF32 off, computed layer by layer from the
benchmark's weights (cast to float32 one layer or one expert at a time) so
that it fits beside them; it imports nothing of the program. Every matrix
product goes through `linear`, which the precision control replaces.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def leaf_specs(m: dict) -> list:
    """The leaves of the port's parameter layout for this decoder, which
    ``bench.weights`` draws: [(path, shape, dtype name, scale)], in
    drawing order; projections normal / sqrt(fan_in), the embedding
    normal * 0.02, norm scales ones (scale None)."""
    L, d, V = m["num_layers"], m["d_model"], m["vocab_size"]
    H, Hkv, ff = m["num_heads"], m["num_kv_heads"], m["d_ff"]
    hd = m.get("head_dim") or d // H
    dt = m["dtype"]
    s_d, s_f, s_o = 1 / math.sqrt(d), 1 / math.sqrt(ff), 1 / math.sqrt(H * hd)
    out = [(("embed", "table"), (V, d), dt, 0.02)]
    blk = ("blocks", "l0")
    out += [(blk + ("ln1", "scale"), (L, d), "float32", None),
            (blk + ("attn", "wq"), (L, d, H * hd), dt, s_d),
            (blk + ("attn", "wk"), (L, d, Hkv * hd), dt, s_d),
            (blk + ("attn", "wv"), (L, d, Hkv * hd), dt, s_d),
            (blk + ("attn", "wo"), (L, H * hd, d), dt, s_o),
            (blk + ("ln2", "scale"), (L, d), "float32", None)]
    E = m.get("num_experts", 0)
    if E:
        out += [(blk + ("moe", "router"), (L, d, E), "float32", s_d),
                (blk + ("moe", "w_gate"), (L, E, d, ff), dt, s_d),
                (blk + ("moe", "w_in"), (L, E, d, ff), dt, s_d),
                (blk + ("moe", "w_out"), (L, E, ff, d), dt, s_f)]
    else:
        out += [(blk + ("mlp", "w_gate"), (L, d, ff), dt, s_d),
                (blk + ("mlp", "w_in"), (L, d, ff), dt, s_d),
                (blk + ("mlp", "w_out"), (L, ff, d), dt, s_f)]
    out += [(("final_norm", "scale"), (d,), "float32", None),
            (("lm_head", "w"), (d, V), dt, s_d)]
    return out


def highest_precision() -> None:
    """Float32 products in float32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def linear(x, w):
    return x @ w.float()


def head_dim(m: dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["num_heads"]


def window_of(m: dict):
    return m["window_size"] if m.get("attention_type") == "sliding" else None


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale.float()


def rope(x, pos, theta):
    """Rotary positions on x (S, H, hd): the first and second halves of
    each head are the rotated pairs."""
    hd = x.shape[-1]
    freqs = torch.as_tensor(
        1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64) / hd),
        dtype=torch.float32, device=x.device)
    ang = pos.float()[:, None, None] * freqs                 # (S, 1, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(m, q, k, v, window, block=512):
    """Causal attention of one sequence: q (S, H, hd), k and v (S, Hkv,
    hd); query head h reads kv head h // (H / Hkv). Query blocks of
    `block` rows."""
    S, H, hd = q.shape
    rep = H // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    out = []
    for a in range(0, S, block):
        b = min(S, a + block)
        lo = 0 if window is None else max(0, a - window + 1)
        s = torch.einsum("qhd,khd->hqk", q[a:b], k[lo:b]) / math.sqrt(hd)
        qp = torch.arange(a, b, device=q.device)[:, None]
        kp = torch.arange(lo, b, device=q.device)[None, :]
        ok = kp <= qp
        if window is not None:
            ok = ok & (kp > qp - window)
        p = torch.softmax(s.masked_fill(~ok, float("-inf")), dim=-1)
        out.append(torch.einsum("hqk,khd->qhd", p, v[lo:b]))
    return torch.cat(out).reshape(S, H * hd)


def swiglu(x, w_gate, w_in, w_out, lin):
    return lin(F.silu(lin(x, w_gate)) * lin(x, w_in), w_out)


def moe(m, x, lp, lin):
    """Dropless top-k mixture: every token through its k experts, their
    outputs weighted by the router's softmax renormalised over the k."""
    probs = torch.softmax(lin(x, lp["router"]), dim=-1)
    top_p, top_e = torch.topk(probs, m["experts_per_token"], dim=-1)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    y = torch.zeros_like(x)
    for e in range(m["num_experts"]):
        tok, slot = torch.nonzero(top_e == e, as_tuple=True)
        if tok.numel():
            out = swiglu(x[tok], lp["w_gate"][e], lp["w_in"][e],
                         lp["w_out"][e], lin)
            y = y.index_add(0, tok, out * top_p[tok, slot][:, None])
    return y


def layer(m, lp, x, seqs, lin=linear):
    """One decoder layer over the rows x (N, D) of the sequences `seqs`
    ((start row, length) each, positions from 0)."""
    H, Hkv, hd = m["num_heads"], m["num_kv_heads"], head_dim(m)
    eps, theta, window = m["norm_eps"], m["rope_theta"], window_of(m)
    h = rmsnorm(x, lp["ln1"], eps)
    q = lin(h, lp["wq"]).reshape(-1, H, hd)
    k = lin(h, lp["wk"]).reshape(-1, Hkv, hd)
    v = lin(h, lp["wv"]).reshape(-1, Hkv, hd)
    outs = []
    for a, n in seqs:
        pos = torch.arange(n, device=x.device)
        outs.append(attention(m, rope(q[a:a + n], pos, theta),
                              rope(k[a:a + n], pos, theta), v[a:a + n],
                              window))
    x = x + lin(torch.cat(outs), lp["wo"])
    h = rmsnorm(x, lp["ln2"], eps)
    if m.get("num_experts"):
        return x + moe(m, h, lp, lin)
    return x + swiglu(h, lp["w_gate"], lp["w_in"], lp["w_out"], lin)


def layer_params(params: dict, i: int, as_f32: bool = True) -> dict:
    """Layer i's weights from the stacked leaves, flat: ln1, wq .. wo,
    ln2, and the SwiGLU's or the experts' and router's. Casting to f32 per
    layer keeps one layer's float32 copy alive at a time; experts stay in
    their type and are cast one at a time by `linear`."""
    b = params["blocks"]["l0"]
    lp = {"ln1": b["ln1"]["scale"][i], "ln2": b["ln2"]["scale"][i]}
    lp.update({k: b["attn"][k][i] for k in ("wq", "wk", "wv", "wo")})
    ffn = b["moe"] if "moe" in b else b["mlp"]
    lp.update({k: ffn[k][i] for k in ffn})
    if as_f32:
        lp = {k: (v if v.dim() == 3 else v.float()) for k, v in lp.items()}
    return lp


@torch.no_grad()
def logits_at(m, params, tokens, reads, lin=linear):
    """float32 logits of each sequence of `tokens` (a list of 1-D int64
    tensors) at the positions `reads` (a list of 1-D index tensors), each
    sequence attending only itself. Returns a list of (len(read), V)."""
    d = m["d_model"]
    table = params["embed"]["table"]
    x = torch.cat([table[t].float() for t in tokens]) * math.sqrt(d)
    seqs, a = [], 0
    for t in tokens:
        seqs.append((a, t.numel()))
        a += t.numel()
    for i in range(m["num_layers"]):
        x = layer(m, layer_params(params, i), x, seqs, lin)
    rows = torch.cat([s[0] + r for s, r in zip(seqs, reads)])
    h = rmsnorm(x[rows], params["final_norm"]["scale"], m["norm_eps"])
    out = lin(h, params["lm_head"]["w"])
    return list(torch.split(out, [r.numel() for r in reads]))
