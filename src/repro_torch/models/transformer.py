"""Decoder assembled from a ModelConfig: parameters, the training forward
and loss, the dense-cache decode of ``serve.generate``, and the paged entry
points the serving engine drives (counterpart of
``repro.models.transformer``).

Parameters are a plain dict with the reference's layout: per-layer weights
are stacked on a leading superblock axis (n_sb, ...), so the JAX
``init_params`` pytree converts leaf for leaf (``repro_torch.convert``) and
``pool[sb]`` / ``weight[sb]`` are contiguous views. The reference's
``lax.scan`` over superblocks is a Python loop here.

  family                superblock
  ------                ----------
  dense/moe             1 layer (attn + mlp|moe)
  local_global (gemma3) ratio local layers + 1 global layer
  ssm (rwkv6)           time-mix + channel-mix
  hybrid (zamba2)       N mamba2 layers + 1 *shared-weight* attention layer

Entry points:
  init_params(cfg, seed=..., device=...)
  forward(cfg, params, inputs)                  -> hidden (B,S,D), aux
  loss_fn(cfg, params, batch)                   -> scalar loss (chunked CE)
  init_decode_state(cfg, batch, max_len, device=...)
  prefill_step(cfg, params, state, inputs)      -> logits (B,V), state
  decode_step(cfg, params, state, inputs, idx)  -> logits (B,V), state
  init_paged_state(cfg, num_blocks, block_size, max_slots=..., device=...)
  paged_decode_step(cfg, params, pool, inputs, block_tables, positions, attn_lens)
  paged_verify_step(cfg, params, pool, tokens, block_tables, base, qlims)
  paged_prefill_packed(cfg, params, pool, tokens, tables, starts, valids, slots)
  paged_prefill_step(cfg, params, pool, tokens, table_row, start, valid_len, slot)

Serving and training cover every family of the registry: dense, MoE
(mixtral, qwen3-moe), local-global, recurrent (rwkv6), hybrid (zamba2), the
vision-language qwen2-vl (M-RoPE) and the audio musicgen; each serving
layer dispatches on its state kind. The vision and audio frontends are
stubs, as in the reference: `forward` takes precomputed "embeds" (and
M-RoPE's (3, B, S) "positions"), `decode_step` an "embed"; the serving
verbs take token ids and, under M-RoPE, the text position in all three
streams.

Under a sharding plan (``core.parallelism``: the params, and in training
the batch, are DTensors) `forward` constrains the residual stream to
("batch", "seq", None) after the embedding and after each superblock, as
the reference does, an MoE layer takes ``moe_apply_ep`` where
``ep_applicable`` holds, and the loss's gold logit is a one-hot
contraction. The paged entry points, whose pools are plain tensors,
return their logits gathered whole.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import parallelism as par
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models import state_providers as SP

superblock_layout = SP.superblock_layout
_layer_kinds = SP.layer_kinds


_ATTN_KINDS = ("attn", "local", "global", "moe_attn", "shared_attn")
_RECURRENT_KINDS = ("rwkv", "mamba")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a rope mode neither package knows."""
    if cfg.rope_mode not in ("standard", "mrope", "none"):
        raise ValueError(f"{cfg.name}: unknown rope_mode {cfg.rope_mode!r}")


# ------------------------------------------------------------------ param init
def _attn_layer_spec(cfg, lead, moe=False):
    """One attention layer's weights (attention, two norms, SwiGLU or, with
    `moe`, the experts), with the stack axes `lead` ((n_sb,) for
    per-superblock layers, () for the hybrid's shared block)."""
    d = cfg.d_model
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    dt, f32 = L.dtype_of(cfg), torch.float32
    spec = {
        "ln1": {"scale": (lead + (d,), f32, "ones")},
        "attn": {"wq": (lead + (d, h * hd), dt, "dense"),
                 "wk": (lead + (d, hkv * hd), dt, "dense"),
                 "wv": (lead + (d, hkv * hd), dt, "dense"),
                 "wo": (lead + (h * hd, d), dt, "dense")},
        "ln2": {"scale": (lead + (d,), f32, "ones")},
    }
    if moe:
        spec["moe"] = _moe_spec(cfg, lead)
    else:
        spec["mlp"] = _swiglu_spec(cfg, lead)
    return spec


def _swiglu_spec(cfg, lead):
    d, f, dt = cfg.d_model, cfg.d_ff, L.dtype_of(cfg)
    return {"w_gate": (lead + (d, f), dt, "dense"),
            "w_in": (lead + (d, f), dt, "dense"),
            "w_out": (lead + (f, d), dt, "dense")}


def _moe_spec(cfg, lead):
    """The reference's ``init_moe``: the (d, E) f32 router at 1/√d, and the
    (E, d, f) / (E, f, d) experts at 1/√E — the reference's ``dense_init``
    takes fan_in = shape[0], which for a stacked expert leaf is E."""
    d, f, e, dt = cfg.d_model, cfg.d_ff, cfg.num_experts, L.dtype_of(cfg)
    expert = ("dense", 1.0 / np.sqrt(e))
    return {"router": (lead + (d, e), torch.float32, "dense"),
            "w_gate": (lead + (e, d, f), dt, expert),
            "w_in": (lead + (e, d, f), dt, expert),
            "w_out": (lead + (e, f, d), dt, expert)}


def _rwkv_spec(cfg, lead):
    """The reference's ``init_rwkv6``: token-shift mixes 0.5, decay base
    w0 = linspace(-6, -1), 0.01-scaled decay LoRA (rank 32), bonus u 0."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.ssm_head_dim
    dt, f32 = L.dtype_of(cfg), torch.float32
    lora = 32
    return {
        "mix": (lead + (5, d), f32, ("fill", 0.5)),
        "wr": (lead + (d, d), dt, "dense"),
        "wk": (lead + (d, d), dt, "dense"),
        "wv": (lead + (d, d), dt, "dense"),
        "wg": (lead + (d, d), dt, "dense"),
        "wo": (lead + (d, d), dt, "dense"),
        "w0": (lead + (d,), f32, ("linspace", -6.0, -1.0)),
        "w_lora_a": (lead + (d, lora), f32, ("dense", 0.01)),
        "w_lora_b": (lead + (lora, d), f32, ("dense", 0.01)),
        "u": (lead + (d,), f32, ("fill", 0.0)),
        "ln_scale": (lead + (d // hd, hd), f32, "ones"),
        "cm_mix": (lead + (2, d), f32, ("fill", 0.5)),
        "cm_r": (lead + (d, d), dt, "dense"),
        "cm_k": (lead + (d, f), dt, "dense"),
        "cm_v": (lead + (f, d), dt, "dense"),
    }


def _mamba_spec(cfg, lead):
    """The reference's ``init_mamba2``: A_log = log(linspace(1, 16, H)),
    D 1, dt_bias 0, conv taps normal · 0.1."""
    d, ds = cfg.d_model, cfg.ssm_state_dim
    d_inner = 2 * d
    H = d_inner // cfg.ssm_head_dim
    dt, f32 = L.dtype_of(cfg), torch.float32
    return {
        "in_proj": (lead + (d, 2 * d_inner + 2 * ds + H), dt, "dense"),
        "conv_w": (lead + (4, d_inner + 2 * ds), f32, ("dense", 0.1)),
        "A_log": (lead + (H,), f32, ("log_linspace", 1.0, 16.0)),
        "D": (lead + (H,), f32, "ones"),
        "dt_bias": (lead + (H,), f32, ("fill", 0.0)),
        "norm_scale": (lead + (d_inner,), f32, "ones"),
        "out_proj": (lead + (d_inner, d), dt, "dense"),
    }


def _layer_spec(kind, cfg, lead):
    d, f32 = cfg.d_model, torch.float32

    def norm():
        return {"scale": (lead + (d,), f32, "ones")}
    if kind in ("attn", "local", "global", "moe_attn"):
        return _attn_layer_spec(cfg, lead, moe=kind == "moe_attn")
    if kind == "rwkv":
        return {"ln1": norm(), "rwkv": _rwkv_spec(cfg, lead), "ln2": norm()}
    if kind == "mamba":
        return {"ln1": norm(), "mamba": _mamba_spec(cfg, lead),
                "ln2": norm(), "mlp": _swiglu_spec(cfg, lead)}
    if kind == "shared_attn":
        return {}       # weights live once in params["shared_attn"]
    raise ValueError(kind)


def param_specs(cfg: ModelConfig) -> dict:
    """Nested dict of (shape, dtype, init) leaves, in the reference's
    layout; init is "dense", "embed", "ones", or a tuple ("dense", scale),
    ("fill", value), ("linspace", a, b), ("log_linspace", a, b)."""
    check_supported(cfg)
    n_sb, _ = superblock_layout(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    dt, f32 = L.dtype_of(cfg), torch.float32
    specs = {"embed": {"table": ((v, d), dt, "embed")},
             "blocks": {f"l{i}": _layer_spec(kind, cfg, (n_sb,))
                        for i, kind in enumerate(_layer_kinds(cfg))},
             "final_norm": {"scale": ((d,), f32, "ones")}}
    if not cfg.tie_embeddings:
        specs["lm_head"] = {"w": ((d, v), dt, "dense")}
    if cfg.family == "hybrid":
        specs["shared_attn"] = _attn_layer_spec(cfg, ())
    return specs


def _map_specs(fn, specs):
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    return fn(specs)


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda"):
    """Random weights made on `device` from a seeded ``torch.Generator``:
    normal · 1/√fan_in for projections, normal · 0.02 for the embedding,
    ones for norm scales, and the recurrent layers' constants (the
    reference's initialisers; the two frameworks' generators give different
    numbers, so parity tests convert the JAX weights instead). Stacked
    leaves are filled one superblock at a time to bound the float32
    temporaries."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def const(shape, dtype, init):
        kind, *args = init
        if kind == "fill":
            return torch.full(shape, args[0], dtype=dtype, device=device)
        ramp = torch.linspace(args[0], args[1], shape[-1], dtype=dtype,
                              device=device)
        if kind == "log_linspace":
            ramp = torch.log(ramp)
        return ramp.expand(shape).contiguous()

    def make(spec):
        shape, dtype, init = spec
        if init == "ones":
            return torch.ones(shape, dtype=dtype, device=device)
        if init == "embed":
            return L.embed_init(shape, dtype, gen, device)
        scale = None
        if isinstance(init, tuple):
            if init[0] != "dense":
                return const(shape, dtype, init)
            scale = init[1]
        if len(shape) == 2:
            return L.dense_init(shape, dtype, gen, device, scale)
        out = torch.empty(shape, dtype=dtype, device=device)
        for i in range(shape[0]):
            out[i] = L.dense_init(shape[1:], dtype, gen, device, scale)
        return out

    return _map_specs(make, param_specs(cfg))


def _at(tree, i):
    """Superblock i of a stacked (n_sb, ...) dict tree, as views."""
    return {k: _at(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def logits(cfg: ModelConfig, params, hidden):
    if cfg.tie_embeddings:
        return L.unembed(params["embed"], hidden)
    return hidden @ params["lm_head"]["w"]


def _embed_tokens(cfg, params, tokens):
    """The scaled token embeddings, in the residual stream's placements
    under a plan (a vocab-split table's lookup is a partial sum)."""
    table = params["embed"]["table"]
    x = (par.embedding(table, tokens) if par.is_dtensor(table)
         else L.embed(params["embed"], tokens))
    if cfg.family != "ssm":
        x = x * float(np.sqrt(cfg.d_model))
    return _residual(x)


def _window(kind, cfg):
    """Sliding window of an attention layer kind, or None (full)."""
    if kind == "local" or (cfg.attention_type == "sliding"
                           and kind in ("attn", "moe_attn")):
        return cfg.window_size
    return None


# -------------------------------------------------------------------- forward
def _residual(y):
    """A sublayer's output `y` in the residual stream's placements, ("batch",
    "seq", None): under sequence parallelism the row-split linear's partial
    sums are reduce-scattered over the sequence, as Megatron's do, so the
    gradient reaching the matmul is not split over the sequence (DTensor in
    torch 2.11 refuses to flatten one into the matmul's rows). A no-op
    without a plan."""
    return par.constrain(y, ("batch", "seq", None))


def _whole_seq(h):
    """`h` (B, S, D) split over the batch axes only. Under sequence
    parallelism (dp_tp_sp) the residual stream is split over the sequence
    between layers; a layer's matmuls take the whole sequence, as
    Megatron's all-gather before its column-split linear does (DTensor in
    torch 2.11 refuses to flatten a split sequence into a matmul's rows).
    A no-op without a plan."""
    return par.constrain(h, ("batch", None, None))


def _split_columns(p, names):
    """`p` with each replicated weight of `names` split over the tensor
    axes along its output columns under a plan (each rank's slice of a
    replicated tensor: no communication). Over a whole sequence GSPMD
    partitions the reference's products with a replicated weight over the
    model axis; DTensor runs them whole on every rank (rwkv6's cm_r and
    decay LoRA: 1.35x the reference's FLOPs a rank). A no-op without a
    plan."""
    return {**p, **{k: par.constrain(p[k], (None, "heads")) for k in names}}


def _apply_layer_train(kind, lp, x, positions, cfg):
    """One layer over a full sequence. Attention kinds: x + attention, then
    x + MLP or MoE (whose load-balancing loss is the aux); rwkv: x + time
    mix, then x + channel mix; mamba: x + Mamba2 mix, then x + MLP. For
    ``shared_attn`` `lp` is the hybrid's shared block. Returns (x, aux
    loss)."""
    h = _whole_seq(L.rmsnorm(lp["ln1"], x, cfg.norm_eps))
    if kind in _ATTN_KINDS:
        x = x + _residual(A.attention_train(lp["attn"], h, positions, cfg,
                                            window=_window(kind, cfg)))
        h = _whole_seq(L.rmsnorm(lp["ln2"], x, cfg.norm_eps))
        if "moe" in lp:
            plan = par.current_plan()
            if M.ep_applicable(cfg, plan):
                y = M.moe_apply_ep(lp["moe"], h, cfg, plan)
            else:
                y = M.moe_apply(lp["moe"], h, cfg)
            return x + _residual(y), M.load_balance_loss(lp["moe"], h, cfg)
        return x + _residual(L.swiglu(lp["mlp"], h)), 0.0
    if kind == "rwkv":
        p = _split_columns(lp["rwkv"], ("w_lora_b", "cm_r"))
        x = x + _residual(S.rwkv6_mix(p, h, cfg)[0])
        h = _whole_seq(L.rmsnorm(lp["ln2"], x, cfg.norm_eps))
        return x + _residual(S.rwkv6_channel_mix(p, h, cfg)[0]), 0.0
    if kind == "mamba":
        x = x + _residual(S.mamba2_mix(lp["mamba"], h, cfg)[0])
        h = _whole_seq(L.rmsnorm(lp["ln2"], x, cfg.norm_eps))
        return x + _residual(L.swiglu(lp["mlp"], h)), 0.0
    raise ValueError(kind)


def _checkpointed(fn):
    def run(*args):
        return par.checkpoint(fn, *args)
    return run


def forward(cfg: ModelConfig, params, inputs):
    """inputs: {"tokens": (B,S)} or {"embeds": (B,S,D)}, optional
    "positions" (B,S), or (3,B,S) under M-RoPE (default: the text position
    0..S-1, in all three streams under M-RoPE). Returns (hidden (B,S,D),
    aux_loss f32 scalar).

    With ``cfg.remat`` each superblock is checkpointed (only its input is
    kept; its layers run again in the backward pass), and when a superblock
    has more than one layer each layer is checkpointed again inside it, so
    the superblock's backward holds one layer's intermediates at a time.
    Gradients reach the stacked (n_sb, ...) weights through the superblock
    views (``_at``), and the hybrid's shared block gathers its gradient from
    every superblock. The aux is the sum of the MoE layers' load-balancing
    losses (0 without MoE)."""
    if "embeds" in inputs:
        x = inputs["embeds"].to(L.dtype_of(cfg))
    else:
        x = _embed_tokens(cfg, params, inputs["tokens"])
    B, Sq = x.shape[0], x.shape[1]
    positions = inputs.get("positions")
    if positions is None:
        positions = A.rope_positions(
            torch.arange(Sq, device=x.device)[None].expand(B, Sq), cfg)
    x = par.constrain(x, ("batch", "seq", None))
    kinds = _layer_kinds(cfg)
    shared = params.get("shared_attn")
    layer_fn = _apply_layer_train
    if cfg.remat and len(kinds) > 1:
        layer_fn = _checkpointed(_apply_layer_train)

    def sb_fn(x, sb_params):
        aux = 0.0
        for i, kind in enumerate(kinds):
            lp = shared if kind == "shared_attn" else sb_params[f"l{i}"]
            x, a = layer_fn(kind, lp, x, positions, cfg)
            aux = aux + a
        return par.constrain(x, ("batch", "seq", None)), aux

    if cfg.remat:
        sb_fn = _checkpointed(sb_fn)
    n_sb, _ = superblock_layout(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for sb in range(n_sb):
        x, a = sb_fn(x, _at(params["blocks"], sb))
        aux = aux + a
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x, aux


def _ce_chunk(h, labels, head):
    """Summed cross-entropy of one chunk: h (B, c, D) against head (D, V).
    The gold logit is a gather on plain tensors; on DTensors (a sharding
    plan) it is the reference's one-hot contraction, which keeps
    vocab-sharded logits sharded (DTensor cannot gather along a sharded
    dim)."""
    lg = (h @ head).float()
    lse = torch.logsumexp(lg, dim=-1)
    if par.is_dtensor(lg):
        vocab = torch.arange(lg.shape[-1], device=lg.device)
        gold = torch.sum(lg * (labels[..., None] == vocab).float(), dim=-1)
    else:
        gold = torch.gather(lg, -1, labels[..., None])[..., 0]
    return torch.sum(lse - gold)


def loss_fn(cfg: ModelConfig, params, batch):
    """Chunked cross-entropy over sequence chunks of ``cfg.loss_chunk``,
    each chunk checkpointed so its (B, chunk, V) f32 logits are recomputed
    in the backward pass instead of stored; plus 0.01 · aux. The gold logit
    is a gather without a plan (the reference contracts a one-hot only to
    keep its vocab-sharded logits sharded; under a plan the port does too).
    batch: {"tokens", "labels"} (B, S)."""
    hidden, aux = forward(cfg, params, batch)
    hidden = _whole_seq(hidden)
    labels = batch["labels"].long()
    B, Sq, _ = hidden.shape
    chunk = min(cfg.loss_chunk, Sq)
    if Sq % chunk:
        raise ValueError(f"sequence length {Sq} is not a multiple of "
                         f"loss_chunk {chunk}")
    head = (params["embed"]["table"].T if cfg.tie_embeddings
            else params["lm_head"]["w"])                          # (D, V)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, Sq, chunk):
        total = total + checkpoint(_ce_chunk, hidden[:, c0:c0 + chunk],
                                   labels[:, c0:c0 + chunk], head,
                                   use_reentrant=False)
    return total / (B * Sq) + 0.01 * aux


# --------------------------------------------------------------------- decode
def _layer_cache(kind, cfg, batch, max_len, kv_quant, device):
    if kind in _ATTN_KINDS:
        return A.init_kv_cache(cfg, batch, max_len, window=_window(kind, cfg),
                               kv_quant=kv_quant, device=device)
    if kind == "rwkv":
        return S.init_rwkv6_state(cfg, batch, device)
    if kind == "mamba":
        return S.init_mamba2_state(cfg, batch, device)
    raise ValueError(kind)


def init_decode_state(cfg: ModelConfig, batch, max_len, kv_quant=None, *,
                      device="cuda"):
    """Dense decode state of ``serve.generate``: per layer of a superblock,
    a KV cache (n_sb, batch, size, Hkv, hd) (size = max_len, or the ring
    min(max_len, window) of a sliding layer; int8 with scales under
    `kv_quant`) or the recurrent state (n_sb, batch, ...), zero-filled. The
    decode and prefill steps update it in place through per-superblock
    views."""
    check_supported(cfg)
    n_sb, _ = superblock_layout(cfg)
    out = {}
    for i, kind in enumerate(_layer_kinds(cfg)):
        one = _layer_cache(kind, cfg, batch, max_len, kv_quant, device)
        out[f"l{i}"] = {k: a[None].repeat((n_sb,) + (1,) * a.dim())
                        for k, a in one.items()}
    return out


def _apply_layer_decode(kind, lp, cache, x, index, cfg):
    """One layer over x (B, S, D) against its dense state. Attention kinds
    take one token (S == 1) at absolute position `index` and update their
    cache in place; the recurrent kinds are functional (any S a multiple of
    the chunk, `index` unused) and return their NEW state, which the caller
    writes back. For ``shared_attn`` `lp` is the hybrid's shared block.
    Returns (x, state)."""
    if kind in _ATTN_KINDS:
        h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        y, cache = A.attention_decode(lp["attn"], h, cache, index, cfg,
                                      window=_window(kind, cfg))
        return _attn_block(lp, x, y, cfg), cache
    if kind == "rwkv":
        h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        y, new = S.rwkv6_mix(lp["rwkv"], h, cfg,
                             state={"S": cache["S"], "prev": cache["prev"]})
        x = x + y
        h = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
        y, prev_cm = S.rwkv6_channel_mix(lp["rwkv"], h, cfg,
                                         state=cache["prev_cm"])
        return x + y, {"S": new["S"], "prev": new["prev"],
                       "prev_cm": prev_cm}
    if kind == "mamba":
        h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        y, new = S.mamba2_mix(lp["mamba"], h, cfg, state=cache)
        x = x + y
        h = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
        return x + L.swiglu(lp["mlp"], h), new
    raise ValueError(kind)


def _write(st, new, keep=None):
    """Copy a recurrent layer's new state into its slab views, in place;
    rows where `keep` (B,) is False keep their old state. A plain slab
    takes a DTensor state (a sharding plan's) gathered whole."""
    for k, a in st.items():
        n = new[k] if par.is_dtensor(a) else par.full(new[k])
        if keep is None:
            a.copy_(n)
        else:
            a.copy_(torch.where(keep.reshape((-1,) + (1,) * (a.dim() - 1)),
                                n, a))


def supports_batched_prefill(cfg: ModelConfig) -> bool:
    """True when every layer kind has a one-shot prefill path (attention
    families; recurrent ssm/hybrid states prefill token by token)."""
    return all(k in _ATTN_KINDS for k in _layer_kinds(cfg))


def _dense_layers(cfg, params, state):
    """Every layer in order: (kind, layer params, layer state) as views of
    superblock sb; ``shared_attn`` layers get the hybrid's shared block."""
    n_sb, _ = superblock_layout(cfg)
    kinds = _layer_kinds(cfg)
    shared = params.get("shared_attn")
    for sb in range(n_sb):
        for i, kind in enumerate(kinds):
            lp = (shared if kind == "shared_attn"
                  else _at(params["blocks"][f"l{i}"], sb))
            yield kind, lp, _at(state[f"l{i}"], sb)


def prefill_step(cfg: ModelConfig, params, state, inputs):
    """Batched prefill: the WHOLE prompt through every layer in one pass,
    filling the dense decode state (vs. the O(S) token loop).
    inputs: {"tokens": (B, S0)}. Returns (logits (B,V) of the last prompt
    token, state updated in place)."""
    if not supports_batched_prefill(cfg):
        raise NotImplementedError(
            f"batched prefill needs attention-only layers, got "
            f"{_layer_kinds(cfg)}")
    x = _embed_tokens(cfg, params, inputs["tokens"])
    for kind, lp, st in _dense_layers(cfg, params, state):
        h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        y, _ = A.attention_prefill(lp["attn"], h, st, cfg,
                                   window=_window(kind, cfg))
        x = _attn_block(lp, x, y, cfg)
    x = L.rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    return logits(cfg, params, x)[:, 0], state


def decode_step(cfg: ModelConfig, params, state, inputs, index):
    """One-token decode against the dense state. inputs: {"token": (B,)} or
    {"embed": (B,D)}; index: the token's absolute position (an int).
    Returns (logits (B,V), state updated in place)."""
    if "embed" in inputs:
        x = inputs["embed"][:, None, :].to(L.dtype_of(cfg))
    else:
        x = _embed_tokens(cfg, params, inputs["token"][:, None])
    for kind, lp, st in _dense_layers(cfg, params, state):
        x, new = _apply_layer_decode(kind, lp, st, x, index, cfg)
        if kind in _RECURRENT_KINDS:
            _write(st, new)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return logits(cfg, params, x)[:, 0], state


# -------------------------------------------------------------- paged decode
def init_paged_state(cfg: ModelConfig, num_blocks: int, block_size: int, *,
                     max_slots: int = None, device="cuda", kv_quant=None):
    """Per-superblock, per-layer sequence state, built by each layer's state
    provider (models.state_providers):

      full / ring layers — paged KV pools (n_sb, num_blocks + 1, bs, Hkv,
        hd); all layers share one block table per sequence, each layer
        owns its pool storage (ring layers use the table's first ring_pages
        entries modulo the ring), and block num_blocks is the scratch
        block. `kv_quant` (KVQuantConfig) makes the pools int8 with
        per-vector f32 scales; the steps dispatch on the pools' structure
        ("k_scale" in the layer's dict).
      rwkv / mamba layers — per-slot recurrent slabs (n_sb, max_slots,
        ...); no block accounting.

    `max_slots` is required whenever the config has recurrent layers."""
    check_supported(cfg)
    if (any(k in _RECURRENT_KINDS for k in SP.state_kinds(cfg))
            and max_slots is None):
        raise ValueError("recurrent layers need max_slots for their state "
                         "slab")
    n_sb, _ = superblock_layout(cfg)
    providers = SP.providers_for(cfg, num_blocks=num_blocks,
                                 block_size=block_size,
                                 max_slots=max_slots or 0, kv_quant=kv_quant)
    return {f"l{i}": p.init_layer_state(n_sb, device)
            for i, p in enumerate(providers)}


def _attn_block(p, h_in, attn_out, cfg):
    """Residual + MLP or MoE tail shared by every attention-layer dispatch
    of the serving steps. The MoE sees the step's whole padded batch
    (inactive slots, padding rows and segments included), as the
    reference's does: its capacity counts them. Under a plan each
    sublayer's output joins the residual stream's placements
    (`_residual`), as in training: left a partial sum, DTensor would
    gather the next layer's split weights whole instead. (The recurrent
    layers' decode leaves its residual as DTensor places it: their
    column-split output projections split it over the model width, as
    GSPMD keeps it, and their replicated channel-mix weights then run on
    each rank's share of it.)"""
    x = h_in + _residual(attn_out)
    h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    if "moe" in p:
        return x + _residual(M.moe_apply(p["moe"], h, cfg))
    return x + _residual(L.swiglu(p["mlp"], h))


def _layers(cfg, params, pool, draft):
    """Every layer in order: (name, kind, layer params, layer state, window,
    ring_pages) as views of superblock sb; ``shared_attn`` layers get the
    hybrid's shared block; window and ring_pages are None but for ring
    layers. ``draft`` sets the ring slack (ring_pages(window, bs, draft)).
    The params and pools were made for a supported config (param_specs and
    init_paged_state check it)."""
    n_sb, _ = superblock_layout(cfg)
    kinds, skinds = _layer_kinds(cfg), SP.state_kinds(cfg)
    shared = params.get("shared_attn")
    for sb in range(n_sb):
        for i, (kind, skind) in enumerate(zip(kinds, skinds)):
            st = _at(pool[f"l{i}"], sb)
            window = rp = None
            if skind == "ring":
                window = cfg.window_size
                rp = SP.ring_pages(window, st["k"].shape[1], draft=draft)
            lp = (shared if kind == "shared_attn"
                  else _at(params["blocks"][f"l{i}"], sb))
            yield f"l{i}", kind, lp, st, window, rp


def paged_decode_step(cfg: ModelConfig, params, pool, inputs, block_tables,
                      positions, attn_lens, *, draft=0):
    """One-token decode for a continuous batch of slots. inputs: {"token":
    (B,)}; block_tables: (B, P) int32; positions: (B,) absolute position of
    each incoming token; attn_lens: (B,) int32 tokens to attend over
    including the new one (0 = inactive slot). Recurrent slabs are per slot
    (B == max_slots) and the updates of inactive slots are masked, so slots
    mid-prefill are never corrupted by the batched decode. ``draft`` must
    match the engine's speculative K-1 (0 when speculation is off) so ring
    layers use the same ring as the verify step. Returns (logits (B,V),
    pool updated in place)."""
    x = _embed_tokens(cfg, params, inputs["token"][:, None])
    active = attn_lens > 0
    for _, kind, lp, st, window, rp in _layers(cfg, params, pool, draft):
        if kind in _RECURRENT_KINDS:
            x, new = _apply_layer_decode(kind, lp, st, x, 0, cfg)
            _write(st, new, active)
            continue
        h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        y, _ = A.attention_decode_paged(lp["attn"], h, st, block_tables,
                                        positions, attn_lens, cfg,
                                        window=window, ring_pages=rp)
        x = _attn_block(lp, x, y, cfg)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return par.full(logits(cfg, params, x)[:, 0]), pool


def _stack_states(states):
    """[state dict] -> one dict of stacked leaves (len(states), ...)."""
    return {k: torch.stack([s[k] for s in states]) for k in states[0]}


def _recurrent_verify_layer(kind, lp, slab, x, cfg):
    """Speculative verify through a recurrent layer: a K-step token loop of
    the decode path that keeps every intermediate state. slab leaves:
    (max_slots, ...); x: (B, K, D) with B == max_slots. Returns (y (B, K,
    D), checkpoints) with checkpoint leaves (K, max_slots, ...):
    checkpoint j is the state after drafts 0..j, so the caller rolls
    rejected drafts back exactly by taking checkpoint `accepted - 1`
    (state_providers.select_checkpoint). The slab itself is not touched;
    under a sharding plan the checkpoints are gathered whole, as the slab
    is a plain tensor."""
    st, ys, cps = slab, [], []
    for t in range(x.shape[1]):
        yt, st = _apply_layer_decode(kind, lp, st, x[:, t:t + 1], t, cfg)
        ys.append(yt[:, 0])
        cps.append(st)
    return torch.stack(ys, dim=1), par.full_tree(_stack_states(cps))


def paged_verify_step(cfg: ModelConfig, params, pool, tokens, block_tables,
                      base, qlims):
    """Multi-query speculative verify for a continuous batch of slots.
    tokens: (B, K) — K draft tokens per slot, draft j at absolute position
    `base[b] + j`; qlims: (B,) number of draft positions that may commit
    K/V this step (0 = inactive slot). Paged layers write the first
    qlims[b] drafts' K/V in place (write-then-attend) and attend causally
    among the draft positions (ring layers on the ring with K-1 slack);
    recurrent layers loop over the K tokens keeping per-step checkpoint
    states for exact rollback. Returns (logits (B, K, V), aux): aux[name]
    is the layer's pool (updated in place) for paged layers, and stacked
    checkpoints (n_sb, K, max_slots, ...) for recurrent layers — the
    caller selects the accepted one via state_providers.select_checkpoint."""
    x = _embed_tokens(cfg, params, tokens)                        # (B, K, D)
    cps = {}
    for name, kind, lp, st, window, rp in _layers(cfg, params, pool,
                                                  tokens.shape[1] - 1):
        if kind in _RECURRENT_KINDS:
            x, c = _recurrent_verify_layer(kind, lp, st, x, cfg)
            cps.setdefault(name, []).append(c)
            continue
        h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        y, _ = A.attention_verify_paged(lp["attn"], h, st, block_tables,
                                        base, qlims, cfg, window=window,
                                        ring_pages=rp)
        x = _attn_block(lp, x, y, cfg)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    aux = {name: _stack_states(cps[name]) if name in cps else layer
           for name, layer in pool.items()}
    return par.full(logits(cfg, params, x)), aux


def _recurrent_prefill_layer(kind, lp, slab, x, valids, slots, cfg, steps):
    """Packed chunked prefill through a recurrent layer: a token loop of the
    decode path (recurrent state has no one-shot prefill), with each
    segment's state updates masked past `valids[g]` so each slab row ends
    at exactly its last real token. The loop runs `steps` = max(valids)
    tokens: later positions are padding in every segment, so their outputs
    are zeros (never read, never written). slab leaves: (max_slots, ...)
    views, written in place; x: (G, C, D); slots: (G,) slab row per segment
    — `slots[g] >= max_slots` marks a padded segment (its gather clamps to
    an arbitrary row and its write-back is dropped). Returns y (G, C, D)."""
    max_slots = next(iter(slab.values())).shape[0]
    slots = slots.long()
    st = {k: a[torch.clamp(slots, max=max_slots - 1)]
          for k, a in slab.items()}
    y = torch.zeros_like(x)
    for t in range(steps):
        yt, new = _apply_layer_decode(kind, lp, st, x[:, t:t + 1], t, cfg)
        keep = t < valids                                         # (G,)
        st = {k: torch.where(keep.reshape((-1,) + (1,) * (a.dim() - 1)),
                             new[k], a) for k, a in st.items()}
        y[:, t] = yt[:, 0]
    # write each real segment's final state to its row: row r takes the
    # segment whose slot is r (slots of real segments are distinct), and
    # rows no segment names keep their state — one gather, no host read
    match = slots[None, :] == torch.arange(max_slots, device=x.device)[:, None]
    src = torch.argmax(match.to(torch.int32), dim=1)              # (max_slots,)
    _write(slab, {k: a[src] for k, a in st.items()}, match.any(dim=1))
    return y


def paged_prefill_packed(cfg: ModelConfig, params, pool, tokens, tables,
                         starts, valids, slots, *, draft=0):
    """Segment-masked packed prefill: one prompt chunk per segment, all
    segments in ONE call. tokens: (G, C) int32 — segment g's chunk starts
    at absolute position `starts[g]` with the first `valids[g]` tokens real;
    tables: (S, P) block-table rows indexed by `slots`. `slots[g] >= S`
    marks an all-padding segment (valids[g] == 0): its table gather clamps,
    its paged writes go to the scratch block and its recurrent-slab
    write-back is dropped. With recurrent layers the call reads max(valids)
    to the host once (the length of their token loop). ``draft`` as in
    :func:`paged_decode_step`.
    Returns (logits (G, V) of each segment's last valid token, pool updated
    in place)."""
    x = _embed_tokens(cfg, params, tokens)
    rows = tables[torch.clamp(slots, max=tables.shape[0] - 1).long()]
    steps = None
    if any(k in _RECURRENT_KINDS for k in _layer_kinds(cfg)):
        # the recurrent token loop stops at the longest segment: one host
        # read a call (an all-padding warm-up call loops zero times)
        steps = int(valids.max())
    for _, kind, lp, st, window, rp in _layers(cfg, params, pool, draft):
        if kind in _RECURRENT_KINDS:
            x = _recurrent_prefill_layer(kind, lp, st, x, valids, slots, cfg,
                                         steps)
            continue
        h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        if window is None:
            y, _ = A.attention_prefill_paged(lp["attn"], h, st, rows, starts,
                                             valids, cfg)
        else:
            y, _ = A.attention_prefill_ring(lp["attn"], h, st, rows, starts,
                                            valids, cfg, window=window,
                                            ring_pages=rp)
        x = _attn_block(lp, x, y, cfg)
    idx = torch.clamp(valids - 1, min=0).long()                   # (G,)
    last = x[torch.arange(x.shape[0], device=x.device), idx][:, None]
    last = L.rmsnorm(params["final_norm"], last, cfg.norm_eps)    # (G, 1, D)
    return par.full(logits(cfg, params, last)[:, 0]), pool


def paged_prefill_step(cfg: ModelConfig, params, pool, tokens, table_row,
                       start, valid_len, slot, *, draft=0):
    """Chunked prefill of ONE sequence (a G=1 packed call). tokens: (1, C)
    chunk starting at absolute position `start`, first `valid_len` real;
    `table_row` (P,). Returns (logits (1,V) of the chunk's last valid
    token, pool)."""
    dev = tokens.device

    def one(v):
        return torch.tensor([v], dtype=torch.int32, device=dev)

    return paged_prefill_packed(cfg, params, pool, tokens, table_row[None],
                                one(start), one(valid_len), one(slot),
                                draft=draft)
