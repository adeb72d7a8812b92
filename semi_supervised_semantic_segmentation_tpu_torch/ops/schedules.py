"""LR and consistency-weight schedules (pure functions of the step).

Poly LR ``base * (1 - step/total)^power``; the Mean-Teacher sigmoid ramp
``exp(-5 (1 - t)^2)`` or a linear one.  The step counter lives on the host,
so these return Python floats.
"""

from __future__ import annotations

import math


def poly_lr(step: int, base_lr: float, total_steps: int, power: float = 0.9) -> float:
    """Polynomial decay; never negative even if step overruns total_steps."""
    frac = min(max(step / max(total_steps, 1), 0.0), 1.0)
    return base_lr * (1.0 - frac) ** power


def sigmoid_rampup(step: int, rampup_steps: int) -> float:
    if rampup_steps <= 0:
        return 1.0
    t = min(max(step / rampup_steps, 0.0), 1.0)
    return math.exp(-5.0 * (1.0 - t) ** 2)


def linear_rampup(step: int, rampup_steps: int) -> float:
    if rampup_steps <= 0:
        return 1.0
    return min(max(step / rampup_steps, 0.0), 1.0)


def consistency_weight(step: int, base_weight: float, rampup_steps: int,
                       kind: str = "sigmoid") -> float:
    ramp = sigmoid_rampup(step, rampup_steps) if kind == "sigmoid" else linear_rampup(step, rampup_steps)
    return base_weight * ramp
