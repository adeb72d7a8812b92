"""The numbers that decide ``correct``, from the readings of the program
and of the plain reference.

Training cells read three steps from the same weights, batches and draws:
each step's loss, the norm of every leaf's first gradient as SGD receives
it, and the norm of every leaf's change over the three steps.  Each number
is a worst case: over the steps, the largest gap of the loss as a share of
the reference's; over the leaves, the largest gap between the two norms as
a share of the reference's norm of that leaf or of the median leaf's,
whichever is larger.  Leaves whose reference gradient is under a
thousandth of the median leaf's (a bias that a BatchNorm follows: its
gradient is nought but for rounding) are left out of both leaf numbers.

Eval cells read the confusion matrix of each sampled val batch: the gap
is the summed absolute difference of the two matrices over twice the
valid pixels, the least share of pixels whose prediction differs; divided
by the share of pixels on which the reference's two best classes nearly
tie, it is the flips per near tie.
"""

from __future__ import annotations

import statistics
from typing import Dict, List

ZERO_GRAD = 1e-3


def loss_gap(prog: List[float], ref: List[float]) -> float:
    return max(abs(p - r) / abs(r) for p, r in zip(prog, ref))


def counted_leaves(ref_grad: Dict[str, float]) -> List[str]:
    med = statistics.median(ref_grad.values())
    return [n for n, v in ref_grad.items() if v >= ZERO_GRAD * med]


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], leaves: List[str]) -> List[float]:
    med = statistics.median(ref[n] for n in leaves)
    return [abs(prog[n] - ref[n]) / max(ref[n], med) for n in leaves]


def training_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``prog`` and ``ref``: {"losses": [3 floats], "grad": {leaf: norm},
    "change": {leaf: norm}}.  Besides the worst cases, the first step's
    loss gap and the median leaf's gaps, which vary less from seed to
    seed."""
    leaves = counted_leaves(ref["grad"])
    grad = leaf_gaps(prog["grad"], ref["grad"], leaves)
    change = leaf_gaps(prog["change"], ref["change"], leaves)
    out = {"loss_gap": loss_gap(prog["losses"], ref["losses"]),
           "loss0_gap": loss_gap(prog["losses"][:1], ref["losses"][:1]),
           "grad_gap": max(grad), "grad_median_gap": statistics.median(grad),
           "change_gap": max(change), "change_median_gap": statistics.median(change)}
    for i, k in enumerate(("sup0_gap", "unsup0_gap", "mask0_gap")):
        if "terms" in prog and "terms" in ref:
            out[k] = loss_gap([prog["terms"][0][i]], [ref["terms"][0][i]])
    return out


def worst_leaves(prog: Dict, ref: Dict) -> Dict[str, List]:
    """The leaf of each leaf number's worst case, with both norms."""
    leaves = counted_leaves(ref["grad"])
    out = {}
    for key in ("grad", "change"):
        gaps = leaf_gaps(prog[key], ref[key], leaves)
        n = leaves[max(range(len(leaves)), key=gaps.__getitem__)]
        out[key] = [n, prog[key][n], ref[key][n]]
    return out


def held(numbers: Dict[str, float], limits: Dict) -> Dict[str, Dict[str, float]]:
    """Each number that ``limits`` (a cell's ``limits/<workload>.json``)
    holds, beside its limit."""
    return {k: {"value": numbers[k], "limit": v["limit"]} for k, v in limits.items()}


def correct(held_numbers: Dict[str, Dict[str, float]]) -> bool:
    return all(c["value"] <= c["limit"] for c in held_numbers.values())


def confusion_gap(prog: List, ref: List, valid_pixels: int) -> float:
    diff = sum(float(abs(p.long() - r.long()).sum()) for p, r in zip(prog, ref))
    return diff / (2.0 * max(valid_pixels, 1))


def eval_numbers(prog: List, ref: List, valid_pixels: int, near_tie: float) -> Dict[str, float]:
    """The confusion gap, and the gap over the reference's near-tie share:
    flips happen where the two best classes nearly tie, and how many
    pixels nearly tie varies from seed to seed more than the precision's
    effect does."""
    gap = confusion_gap(prog, ref, valid_pixels)
    return {"confusion_gap": gap, "flips_per_near_tie": gap / max(near_tie, 1e-12)}
