"""Plain float32 reference of a training step of a dense decoder: the mean
next-token cross-entropy of ``decoder``'s forward, its gradients by
autograd, global-norm clipping and Adam with bias correction (Kingma & Ba
2015), all in float32 with TF32 off.

Each layer's weights are separate float32 tensors, each layer is
checkpointed (its activations recomputed in the backward pass) and the
cross-entropy runs in checkpointed chunks, so the step fits beside its
float32 state. Imports nothing of the program.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from bench.reference import decoder as D
# the trained decoder's weights, window and precision are the decoder's
from bench.reference.decoder import (  # noqa: F401
    highest_precision, leaf_specs, window_of)

LAYER_KEYS = (("ln1", "scale"), ("attn", "wq"), ("attn", "wk"),
              ("attn", "wv"), ("attn", "wo"), ("ln2", "scale"),
              ("mlp", "w_gate"), ("mlp", "w_in"), ("mlp", "w_out"))


def split_params(m: dict, params: dict) -> dict:
    """{name: float32 tensor}: the embedding, final norm and head, and each
    layer's leaves as separate tensors "l{i}.{key}" (one gradient a layer,
    never a whole stacked leaf's)."""
    if m.get("num_experts"):
        raise NotImplementedError("the training reference is dense only")
    b = params["blocks"]["l0"]
    out = {"embed": params["embed"]["table"].float(),
           "final_norm": params["final_norm"]["scale"].float(),
           "lm_head": params["lm_head"]["w"].float()}
    for i in range(m["num_layers"]):
        for grp, key in LAYER_KEYS:
            out[f"l{i}.{key if grp not in ('ln1', 'ln2') else grp}"] = \
                b[grp][key][i].float()
    return out


def stacked_path(name: str):
    """The port's leaf path of a split tensor name, and its layer (None for
    an unstacked leaf)."""
    if name == "embed":
        return ("embed", "table"), None
    if name == "final_norm":
        return ("final_norm", "scale"), None
    if name == "lm_head":
        return ("lm_head", "w"), None
    lay, key = name.split(".")
    grp = {"ln1": ("ln1", "scale"), "ln2": ("ln2", "scale")}.get(key)
    if grp is None:
        grp = ("attn", key) if key.startswith("w") and len(key) == 2 \
            else ("mlp", key)
    return ("blocks", "l0") + grp, int(lay[1:])


def loss(m: dict, p: dict, tokens, labels, chunk: int = 512, lin=D.linear):
    """Mean cross-entropy of the next token over tokens (B, S); every
    matrix product through `lin`."""
    B, S = tokens.shape
    seqs = [(b * S, S) for b in range(B)]
    x = p["embed"][tokens.reshape(-1).long()] * math.sqrt(m["d_model"])
    for i in range(m["num_layers"]):
        names = [n for n in p if n.startswith(f"l{i}.")]

        def run(x, *ws, names=names):
            lp = {n.split(".")[1]: w for n, w in zip(names, ws)}
            return D.layer(m, lp, x, seqs, lin)
        x = checkpoint(run, x, *[p[n] for n in names], use_reentrant=False)
    h = D.rmsnorm(x, p["final_norm"], m["norm_eps"])
    flat = labels.reshape(-1).long()
    total = torch.zeros((), device=x.device)

    def ce(h, lab, w):
        lg = lin(h, w)
        return torch.sum(torch.logsumexp(lg, -1)
                         - lg.gather(-1, lab[:, None])[:, 0])
    for a in range(0, h.shape[0], chunk):
        total = total + checkpoint(ce, h[a:a + chunk], flat[a:a + chunk],
                                   p["lm_head"], use_reentrant=False)
    return total / flat.numel()


class Adam:
    """Adam on a dict of float32 tensors, after clipping the gradients'
    global norm to `clip`."""

    def __init__(self, p: dict, lr, beta1, beta2, eps, clip):
        self.lr, self.b1, self.b2, self.eps, self.clip = (lr, beta1, beta2,
                                                          eps, clip)
        self.m = {k: torch.zeros_like(v) for k, v in p.items()}
        self.v = {k: torch.zeros_like(v) for k, v in p.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, p: dict, g: dict, norms: dict = None) -> None:
        """Update p in place. `norms`, if given, receives each clipped
        gradient's squared norm by name."""
        total = torch.sqrt(sum(torch.sum(x * x) for x in g.values()))
        scale = (torch.clamp(self.clip / (total + 1e-6), max=1.0)
                 if self.clip else torch.ones((), device=total.device))
        self.t += 1
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k in p:
            gk = g[k].mul_(scale)
            if norms is not None:
                norms[k] = float(torch.sum(gk.double() ** 2))
            self.m[k].mul_(self.b1).add_(gk, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(gk, gk, value=1 - self.b2)
            p[k].sub_(self.lr * (self.m[k] / bc1)
                      / (torch.sqrt(self.v[k] / bc2) + self.eps))


def leaf_norms(sq: dict) -> dict:
    """{port leaf path: norm} from squared norms of split tensors by name,
    a stacked leaf's norm over all of its layers."""
    out: dict = {}
    for k, v in sq.items():
        path, _ = stacked_path(k)
        out[path] = out.get(path, 0.0) + v
    return {k: math.sqrt(v) for k, v in out.items()}


def run_steps(m: dict, make_params, batches, hp: dict, *, rows=None,
              lin=D.linear):
    """Reference steps over `batches` from the weights `make_params()`
    returns in the port's layout (their values; float32 copies are made
    here, and the function is called again at the end for the change).
    `rows` (lo, hi) trains on those rows of each batch alone; `lin` takes
    every matrix product (the precision control's). Returns
    (losses, the first clipped gradient's leaf norms, the leaf norms of
    the weights' change)."""
    p = split_params(m, make_params())
    opt = Adam(p, hp["lr"], hp["beta1"], hp["beta2"], hp["eps"],
               hp["grad_clip"])
    losses, first = [], None
    for batch in batches:
        tok, lab = batch["tokens"], batch["labels"]
        if rows is not None:
            tok, lab = tok[rows[0]:rows[1]], lab[rows[0]:rows[1]]
        live = {k: v.detach().requires_grad_() for k, v in p.items()}
        lv = loss(m, live, tok, lab, lin=lin)
        grads = torch.autograd.grad(lv, list(live.values()))
        losses.append(float(lv.detach()))
        del live, lv
        sq = {} if first is None else None
        opt.step(p, dict(zip(p.keys(), grads)), sq)
        del grads
        if sq is not None:
            first = leaf_norms(sq)
    del opt
    p0 = split_params(m, make_params())
    change = leaf_norms({k: float(torch.sum((p[k] - p0.pop(k)).double()
                                            ** 2)) for k in list(p)})
    return losses, first, change
