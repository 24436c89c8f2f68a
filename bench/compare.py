"""The comparisons that decide ``correct``: the program's outputs against
the plain reference's, each reduced to one number that a limit in
``bench/limits/<workload>.json`` bounds."""
from __future__ import annotations

import statistics

import torch


def judge(readings: dict, limits: dict) -> tuple:
    """(checks, correct): {name: (reading, limit)} of the readings that a
    limit bounds (a limit of None is printed, not compared), and whether
    there is one and every one lies within its limit. The runs, the
    calibration's controls and the tests all judge by this."""
    checks = {k: (v, limits[k]) for k, v in readings.items()
              if limits.get(k) is not None}
    return checks, bool(checks) and all(v <= lim
                                        for v, lim in checks.values())


def token_gaps(ref_logits, served):
    """For every served token, by how much the reference's logit of that
    token lies below the reference's best at its position. ref_logits:
    list of (n_i, V) tensors; served: list of n_i token ids each. Returns
    one float64 tensor of all the gaps."""
    out = []
    for lg, toks in zip(ref_logits, served):
        t = torch.as_tensor(toks, dtype=torch.long, device=lg.device)
        out.append((lg.max(dim=-1).values
                    - lg.gather(-1, t[:, None])[:, 0]).double().cpu())
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.float64)


def gap_readings(gaps) -> dict:
    """The numbers read from the served tokens' gaps: their mean, the
    widest, and the share of tokens that are not the reference's first
    choice."""
    if gaps.numel() == 0:
        return {"mean_gap": float("inf"), "widest_gap": float("inf"),
                "mismatch_share": 1.0}
    return {"mean_gap": float(gaps.mean()), "widest_gap": float(gaps.max()),
            "mismatch_share": float((gaps > 0).double().mean())}


def loss_gap(losses, ref_losses) -> float:
    """The largest relative gap between the program's loss and the
    reference's over the steps compared."""
    return max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))


def leaf_gap(norms: dict, ref_norms: dict, keep=None) -> tuple:
    """(worst gap, its leaf): for each leaf, the gap between the program's
    norm and the reference's, over the larger of the reference's norm of
    that leaf and of the median leaf. `keep` limits the leaves compared."""
    leaves = [k for k in ref_norms if keep is None or k in keep]
    median = statistics.median(ref_norms[k] for k in leaves)
    worst, where = 0.0, None
    for k in leaves:
        g = abs(norms[k] - ref_norms[k]) / max(ref_norms[k], median)
        if g >= worst:
            worst, where = g, k
    return worst, where


def moved_leaves(ref_grad_norms: dict) -> set:
    """Leaves whose reference gradient is more than a thousandth of the
    median leaf's: the others move under Adam by round-off alone, and are
    left out of the change."""
    median = statistics.median(ref_grad_norms.values())
    return {k for k, v in ref_grad_norms.items() if v > 1e-3 * median}
