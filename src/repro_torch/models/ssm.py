"""Attention-free sequence mixers: RWKV6 (Finch) and Mamba2 (SSD) — the
port's copy of ``repro.models.ssm``.

Both run in *chunked* form: within a chunk the work is dense matmuls, and
the recurrent state is carried across chunks. The reference carries it
through ``lax.scan`` and vmaps the per-(batch, head) chunk over batch and
heads; here the chunk loop is a Python loop and the chunk functions take
any leading batch dims (``(..., C, K)``), so one batched matmul covers all
batches and heads.

Numerics follow the reference: decays live in log space, and RWKV6's
per-step log-decay is clamped at ``-_MAX_CHUNK_LOGDECAY / CHUNK`` so the
factorised chunk's factors stay within e^40. r/k/v are cast to float32
inside the chunk, the states ``S`` are float32, and the token-shift and
convolution carries (``prev``, ``prev_cm``, ``conv``) keep the config's
dtype.

When autograd records a graph through it, each chunk runs under a
non-reentrant checkpoint (the reference's ``jax.checkpoint`` on its chunk
step), so training keeps one chunk's (C, C) intermediates at a time;
serving runs the chunks plainly. Mamba2's chunk masks inside the
exponent, where the reference masks after it and its gradients are not
finite (``_ssd_chunk``).

Parameter initialisers live with the parameter specs in
``models.transformer`` (``param_specs``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core import parallelism as par
from repro_torch.models import layers as L

CHUNK = 32  # within-chunk dense block length

# max total log-decay magnitude per chunk in the factorised form (exp(40)
# ≈ 2.4e17 stays finite in f32 after one multiply)
_MAX_CHUNK_LOGDECAY = 40.0


def _run_chunk(fn, *args):
    """fn(*args), under a non-reentrant checkpoint when autograd records a
    graph through it (the reference's ``jax.checkpoint`` on each chunk: a
    chunk's (C, C) intermediates are recomputed in the backward pass
    instead of kept for every chunk of the sequence). Serving passes no
    tensor that requires grad and runs `fn` plainly."""
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _strict_lower(C, device):
    return torch.tril(torch.ones((C, C), dtype=torch.bool, device=device),
                      diagonal=-1)


# =============================================================== RWKV6 (Finch)
def _token_shift(x, prev=None):
    """Shift sequence right by one; `prev` fills slot 0 (decode/chunk carry)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev, x[:, :-1]], dim=1)


def _wkv_chunk(r, k, v, logw, u, S0):
    """One chunk of the WKV recurrence over any leading dims.

    r, k: (..., C, K); v: (..., C, V); logw: (..., C, K) (non-positive,
    clamped per step by the caller); u: (..., K) or (K,); S0: (..., K, V)
    float32. Returns (y (..., C, V), S1 (..., K, V)) in float32.

    The pair decay exp(lw_prev[t] - lw[i]) is factorised through the
    chunk-end reference lw_end, A[t, i] = (r_t e^{lw_prev[t] - lw_end}) ·
    (k_i e^{lw_end - lw[i]}), so the chunk is two matmuls and the (C, C, K)
    decay tensor never exists; the clamp bounds the factors at e^40."""
    C = r.shape[-2]
    lw = torch.cumsum(logw, dim=-2)                  # (..., C, K)
    lw_prev = lw - logw                              # lw_{t-1}, row 0 = 0
    lw_end = lw[..., -1:, :]                         # (..., 1, K)
    r, k, v = r.float(), k.float(), v.float()
    q_fac = r * torch.exp(lw_prev - lw_end)          # factors <= e^40
    k_fac = k * torch.exp(lw_end - lw)               # factors <= 1
    A = q_fac @ k_fac.transpose(-1, -2)              # (..., C, C)
    A = torch.where(_strict_lower(C, r.device), A, 0.0)
    A = A + torch.diag_embed(torch.sum(r * u[..., None, :] * k, dim=-1))
    y = A @ v + (r * torch.exp(lw_prev)) @ S0
    S1 = (torch.exp(lw_end).transpose(-1, -2) * S0
          + k_fac.transpose(-1, -2) @ v)
    return y, S1


def rwkv6_mix(params, x, cfg, state=None):
    """Time-mix (WKV) over a sequence. x: (B, S, D). Returns (y, new_state).

    state: {"S": (B,H,K,V) f32, "prev": (B,1,D)} or None (zeros)."""
    B, S, D = x.shape
    hd = cfg.ssm_head_dim
    H = D // hd
    prev = None if state is None else state["prev"]
    xs = _token_shift(x, prev)
    mix = params["mix"]
    xr, xk, xv, xg, xw = ((x + mix[i] * (xs - x)).to(x.dtype)
                          for i in range(5))
    r = xr @ params["wr"]                            # config dtype until the
    k = xk @ params["wk"]                            # chunk casts them
    v = xv @ params["wv"]
    g = xg @ params["wg"]
    logw = -torch.exp(params["w0"] + (xw.float() @ params["w_lora_a"])
                      @ params["w_lora_b"])          # (B,S,D) strictly < 0
    logw = torch.clamp(logw, min=-_MAX_CHUNK_LOGDECAY / CHUNK)

    def heads(t):                                    # (B, H, S, hd)
        return t.reshape(B, S, H, hd).transpose(1, 2)
    r, k, v, logw = heads(r), heads(k), heads(v), heads(logw)
    u = params["u"].reshape(H, hd)
    C = min(CHUNK, S)
    if S % C:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"chunk {C}")

    def scan(r, k, v, logw, u, Sc):                  # on local heads
        if Sc is None:
            Sc = torch.zeros(r.shape[:2] + (hd, hd), dtype=torch.float32,
                             device=r.device)
        ys = []
        for c0 in range(0, S, C):
            sl = slice(c0, c0 + C)
            y, Sc = _run_chunk(_wkv_chunk, r[:, :, sl], k[:, :, sl],
                               v[:, :, sl], logw[:, :, sl], u, Sc)
            ys.append(y)
        return torch.cat(ys, dim=2), Sc

    bh = ("batch", "heads", None, None)
    Sc = None if state is None else state["S"]
    y, Sc = par.local_call(scan, (r, k, v, logw, u, Sc),
                           (bh, bh, bh, bh, ("heads", None), bh),
                           ((r.shape, bh), ((B, H, hd, hd), bh)))
    y = y.transpose(1, 2)                            # (B, S, H, hd) f32

    # per-head group norm (population variance, as jnp.var) + gating
    mean = torch.mean(y, dim=-1, keepdim=True)
    var = torch.var(y, dim=-1, keepdim=True, correction=0)
    y = (y - mean) * torch.rsqrt(var + 64e-5) * params["ln_scale"]
    y = (y.reshape(B, S, D).to(x.dtype)
         * F.silu(g.float()).to(x.dtype))
    out = y @ params["wo"]
    return out, {"S": Sc, "prev": x[:, -1:]}


def rwkv6_channel_mix(params, x, cfg, state=None):
    """Channel mix. x: (B, S, D); state: the previous token (B, 1, D) or
    None. The mixes are float32 (the reference's promotion), so the first
    two projections run in float32; returns (y, x[:, -1:])."""
    xs = _token_shift(x, state)
    mix = params["cm_mix"]
    xk = x + mix[0] * (xs - x)
    xr = x + mix[1] * (xs - x)
    r = torch.sigmoid((xr @ params["cm_r"].to(xr.dtype)).float())
    k = (xk @ params["cm_k"].to(xk.dtype)).float()
    vv = torch.square(torch.relu(k)).to(x.dtype)
    v = vv @ params["cm_v"]
    r = r.to(x.dtype)
    if r.requires_grad:
        # training under a plan takes cm_r split by column: r joins x's
        # placements before it scales v's partial sums, so the backward
        # pass takes dv whole and keeps the (B, S, d_ff) gradient split
        # over d_ff (a forward alone needs no such gather)
        r = par.constrain(r, ("batch", None, None))
    return r * v, x[:, -1:]


def rwkv6_state_spec(cfg):
    """Per-sequence recurrent-state layout: name -> (shape, dtype). The
    single source of truth for the dense decode state AND the engine's
    per-slot slabs (state_providers.RecurrentSlabProvider)."""
    hd = cfg.ssm_head_dim
    H = cfg.d_model // hd
    return {
        "S": ((H, hd, hd), torch.float32),
        "prev": ((1, cfg.d_model), L.dtype_of(cfg)),
        "prev_cm": ((1, cfg.d_model), L.dtype_of(cfg)),
    }


def _zeros_state(spec, batch, device):
    return {k: torch.zeros((batch,) + shape, dtype=dt, device=device)
            for k, (shape, dt) in spec.items()}


def init_rwkv6_state(cfg, batch, device="cuda"):
    return _zeros_state(rwkv6_state_spec(cfg), batch, device)


# ================================================================ Mamba2 (SSD)
def _causal_conv(x, w, prev=None):
    """Depthwise causal conv, kernel k. x: (B,S,C), w: (k,C), prev:
    (B,k-1,C). Returns (out (B,S,C) in the promoted dtype, carry (B,k-1,C)
    in x's dtype)."""
    kk = w.shape[0]
    if prev is None:
        prev = torch.zeros((x.shape[0], kk - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([prev, x], dim=1)
    S = x.shape[1]
    out = sum(xp[:, i:i + S] * w[i] for i in range(kk))
    return out, xp[:, -(kk - 1):]


def _ssd_chunk(xh, Bm, Cm, la, dtv, S0):
    """One SSD chunk over any leading dims (B and C may broadcast over
    heads).

    xh: (..., C, hd) inputs; Bm, Cm: (..., C, ds); la: (..., C) cumulative
    log-decay within the chunk; dtv: (..., C) step sizes; S0: (..., hd,
    ds). Returns (y (..., C, hd), S1 (..., hd, ds)).

    The causal mask sits inside the exponent, G = exp(where(tri, la_t -
    la_i, -inf)): above the diagonal la_t - la_i is a sum of positive
    increments that overflows exp to inf, and masking after the exp (as
    the reference does) keeps the forward finite but makes the backward
    0 * inf = NaN. exp(-inf) is exactly 0, so the forward values are the
    same bit for bit."""
    Cl = xh.shape[-2]
    tri = torch.tril(torch.ones((Cl, Cl), dtype=torch.bool,
                                device=xh.device))
    G = torch.exp(torch.where(tri, la[..., :, None] - la[..., None, :],
                              float("-inf")))                 # decay i -> t
    M = (Cm @ Bm.transpose(-1, -2)) * G * dtv[..., None, :]
    y = M @ xh + torch.exp(la)[..., None] * (Cm @ S0.transpose(-1, -2))
    w_end = torch.exp(la[..., -1:] - la) * dtv                # (..., C)
    S1 = (torch.exp(la[..., -1])[..., None, None] * S0
          + (xh * w_end[..., None]).transpose(-1, -2) @ Bm)
    return y, S1


def _ssd_step(xh, Bm, Cm, log_a, dtv, S0):
    """One chunk of the SSD scan from the sequence layout: xh (B,C,H,hd);
    Bm, Cm (B,C,ds), shared by the heads; log_a, dtv (B,C,H); S0
    (B,H,hd,ds). Returns (y (B,H,C,hd), S1)."""
    la = torch.cumsum(log_a, dim=1).transpose(1, 2)              # (B,H,C)
    return _ssd_chunk(xh.transpose(1, 2), Bm[:, None], Cm[:, None], la,
                      dtv.transpose(1, 2), S0)


def _in_proj(w, x, sizes):
    """x @ w split into its column sections `sizes`, for a DTensor w (a
    plan's column split). The sections do not fall on the bounds of that
    split, so cutting x @ w gathers the (B, S, 2·d_inner + 2·ds + H)
    product whole on every rank; where that product has more rows than
    the weight (a prefill or a training step) each section is computed
    instead from its own columns of the gathered weight, split over the
    tensor axes where they divide."""
    if x.numel() // x.shape[-1] <= w.shape[0]:
        return torch.split(x @ w, list(sizes), dim=-1)
    w = par.constrain(w, (None, None))
    return [x @ par.constrain(piece, (None, "heads"))
            for piece in torch.split(w, list(sizes), dim=-1)]


def mamba2_mix(params, x, cfg, state=None):
    """Mamba2 block. x: (B,S,D) -> (y, new_state); state: {"S": (B,H,hd,ds)
    f32, "conv": (B,3,conv_dim)} or None (zeros). Under a plan the conv,
    its float32 silu, the scan and the gate run through ``local_call`` on
    each rank's own heads, where the tensor axes divide the heads, so
    their float32 copies are the rank's share."""
    B, S, D = x.shape
    d_inner = 2 * D
    hd = cfg.ssm_head_dim
    H = d_inner // hd
    ds = cfg.ssm_state_dim
    C = min(CHUNK, S)
    if S % C:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"chunk {C}")
    if state is None:
        kk = params["conv_w"].shape[0]
        prev = torch.zeros((B, kk - 1, d_inner + 2 * ds), dtype=x.dtype,
                           device=x.device)
        Sc = torch.zeros((B, H, hd, ds), dtype=torch.float32,
                         device=x.device)
    else:
        prev, Sc = state["conv"], state["S"]

    def mix(z, xbc, log_a, dtv, w, Dh, prev, Sc):
        # on a rank's own rows and heads: z (b,S,h·hd); xbc the conv's
        # input, xc (b,S,h·hd) then B and C (shared by the heads), w and
        # prev its taps and previous rows; log_a, dtv (b,S,h); Dh (h,); Sc
        # (b,h,hd,ds)
        b, n = z.shape[0], z.shape[-1]
        conv, carry = _causal_conv(xbc, w, prev)
        xc, Bm, Cm = torch.split(F.silu(conv.float()), [n, ds, ds], dim=-1)
        xh = xc.reshape(b, S, -1, hd)
        ys = []
        for c0 in range(0, S, C):
            sl = slice(c0, c0 + C)
            y, Sc = _run_chunk(_ssd_step, xh[:, sl], Bm[:, sl], Cm[:, sl],
                               log_a[:, sl], dtv[:, sl], Sc)
            ys.append(y)
        y = torch.cat(ys, dim=2).transpose(1, 2)              # (b,S,h,hd)
        y = y + Dh[None, None, :, None] * xh
        return y.reshape(b, S, -1) * F.silu(z.float()), Sc, carry

    def decay(dt_raw):
        dtv = F.softplus(dt_raw.float() + params["dt_bias"])  # (B,S,H)
        return dtv * -torch.exp(params["A_log"]), dtv         # log_a <= 0

    if not par.is_dtensor(x):
        z, xbc, dt_raw = torch.split(x @ params["in_proj"],
                                     [d_inner, d_inner + 2 * ds, H], dim=-1)
        y, Sc, carry = mix(z, xbc, *decay(dt_raw), params["conv_w"],
                           params["D"], prev, Sc)
    else:
        z, xc, bc, dt_raw = _in_proj(params["in_proj"], x,
                                     (d_inner, d_inner, 2 * ds, H))
        # xc's channels split with the heads, B's and C's whole
        plan = par.current_plan()
        heads = "heads" if plan is not None and par._divisible(
            H, plan.tensor_axes, plan.shape) else None
        seq_h, seq = ("batch", None, heads), ("batch", None, None)
        bh = ("batch", heads, None, None)

        def local(z, xc, bc, log_a, dtv, w_x, w_bc, Dh, prev_x, prev_bc,
                  Sc):
            y, Sc, carry = mix(z, torch.cat([xc, bc], dim=-1), log_a, dtv,
                               torch.cat([w_x, w_bc], dim=-1), Dh,
                               torch.cat([prev_x, prev_bc], dim=-1), Sc)
            return (y, Sc) + tuple(torch.split(
                carry, [xc.shape[-1], 2 * ds], dim=-1))
        cols = [d_inner, 2 * ds]
        y, Sc, carry_x, carry_bc = par.local_call(
            local, (z, xc, bc, *decay(dt_raw),
                    *torch.split(params["conv_w"], cols, dim=-1),
                    params["D"], *torch.split(prev, cols, dim=-1), Sc),
            (seq_h, seq_h, seq, seq_h, seq_h, (None, heads), (None, None),
             (heads,), seq_h, seq, bh),
            (((B, S, d_inner), seq_h), ((B, H, hd, ds), bh),
             ((B, prev.shape[1], d_inner), seq_h),
             ((B, prev.shape[1], 2 * ds), seq)))
        carry = torch.cat([par.constrain(carry_x, seq), carry_bc], dim=-1)
    # gated RMSNorm (the gate applied on the local heads)
    var = torch.mean(y * y, dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + cfg.norm_eps) * params["norm_scale"]
    out = y.to(x.dtype) @ params["out_proj"]
    return out, {"S": Sc, "conv": carry}


def mamba2_state_spec(cfg):
    """Per-sequence recurrent-state layout: name -> (shape, dtype)."""
    d_inner = 2 * cfg.d_model
    hd = cfg.ssm_head_dim
    H = d_inner // hd
    ds = cfg.ssm_state_dim
    conv_dim = d_inner + 2 * ds
    return {
        "S": ((H, hd, ds), torch.float32),
        "conv": ((3, conv_dim), L.dtype_of(cfg)),
    }


def init_mamba2_state(cfg, batch, device="cuda"):
    return _zeros_state(mamba2_state_spec(cfg), batch, device)
