"""The numbers that decide ``correct``, and their limits.

Training (the first steps of the very object the window drives, against
``reference.train``):

- ``loss_gap``: the largest over the compared steps of |program's loss -
  reference's| / |reference's|;
- ``grad_gap``: over the leaves, the largest gap between the norms of
  the first step's clipped gradient (the program's worked out from
  AdamW's first moment after one step), |program - reference| over the
  larger of the leaf's reference norm and the median leaf's;
- ``change_gap``: the same of the norms of each leaf's change over the
  compared steps, leaving out the leaves whose reference gradient is
  under a thousandth of the median leaf's (they move by round-off alone).

Serving: ``logit_gap``, the widest gap by which a served token's logit
lies below the reference's best at its position.

A cell's limits are ``limits/<cell>.json``: the numbers it names are
compared, and a run is correct when each is at or under its limit.
"""
from __future__ import annotations

import statistics

#: a leaf whose reference gradient norm is under this share of the median
#: leaf's moves by round-off alone, and its change is not compared
STILL_LEAF = 1e-3


def leaf_gap(prog: dict, ref: dict, keys=None) -> tuple[float, str]:
    """(largest gap, its leaf) of two {leaf: norm} over ``keys``."""
    keys = sorted(ref if keys is None else keys)
    med = statistics.median(ref[k] for k in keys)
    worst, leaf = -1.0, ""
    for k in keys:
        gap = abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
        if gap > worst:
            worst, leaf = gap, k
    return worst, leaf


def moving_leaves(ref_grads: dict) -> list[str]:
    med = statistics.median(ref_grads.values())
    return sorted(k for k, g in ref_grads.items() if g >= STILL_LEAF * med)


def train_numbers(prog: dict, ref: dict) -> dict:
    """prog, ref: {"losses", "grad_norms", "change_norms"} over the same
    steps and leaves."""
    if set(prog["grad_norms"]) != set(ref["grad_norms"]):
        raise ValueError("the program's leaves are not the reference's")
    gaps = [abs(p - r) / abs(r) for p, r in
            zip(prog["losses"], ref["losses"])]
    grad, grad_leaf = leaf_gap(prog["grad_norms"], ref["grad_norms"])
    change, change_leaf = leaf_gap(prog["change_norms"], ref["change_norms"],
                                   moving_leaves(ref["grad_norms"]))
    return {"loss_gap": max(gaps), "grad_gap": grad, "change_gap": change,
            "_leaves": {"grad_gap": grad_leaf, "change_gap": change_leaf}}


def token_gaps(ref_logits, tokens):
    """ref_logits (N, gen, vocab), tokens (N, gen) -> (N, gen) gaps of
    each token's reference logit below the reference's best."""
    best = ref_logits.max(-1).values
    got = ref_logits.gather(-1, tokens[..., None].long())[..., 0]
    return best - got


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the numbers a limit
    names.  A number that is missing or not finite fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and value == value and value <= limit
        ok &= good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
