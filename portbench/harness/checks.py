"""The numbers that decide `correct`, each against its limit.

Render cells compare the image the window accumulated with the reference's
retrace of the same pixels over every iteration the program ran:
`image_gap` = sum |program - reference| / sum |reference| over a sample of
pixels drawn from the seed, all three channels.

The train cell compares the first three steps of its window's own call with
the reference's: `loss_gap`, the largest relative gap of a step's loss;
`grad_gap`, the worst leaf's gap between the norms of the first step's
gradient (the program's read back from Adam's first moment after one step,
mu / (1 - b1)); `change_gap`, the worst leaf's gap between the norms of the
parameters' change over the three steps. A leaf's gap is measured against
the larger of its reference norm and the median leaf's; leaves whose
reference gradient is under a thousandth of the median nonzero leaf's are
left out (their change is round-off alone)."""
from __future__ import annotations

import statistics
from typing import Dict, Sequence

import numpy as np

ADAM_B1 = 0.9


def image_gap(program: np.ndarray, reference: np.ndarray) -> float:
    program = np.asarray(program, np.float64)
    reference = np.asarray(reference, np.float64)
    den = np.abs(reference).sum()
    if not np.isfinite(program).all():
        return float("inf")
    return float(np.abs(program - reference).sum() / max(den, 1e-30))


def _norm(t) -> float:
    return float(np.linalg.norm(np.asarray(t, np.float64).ravel()))


def kept_leaves(ref_grad: Dict[str, object]) -> list:
    """The leaves whose reference gradient norm is at least a thousandth of
    the median nonzero leaf's."""
    norms = {k: _norm(v) for k, v in ref_grad.items()}
    nonzero = [n for n in norms.values() if n > 0]
    if not nonzero:
        return []
    floor = 1e-3 * statistics.median(nonzero)
    return sorted(k for k, n in norms.items() if n > 0 and n >= floor)


def leaf_gap(program: Dict[str, object], reference: Dict[str, object],
             leaves: Sequence[str]) -> float:
    """The worst leaf's |norm(program) - norm(reference)| over the larger
    of norm(reference) and the median leaf's norm."""
    if not leaves:
        return float("inf")
    ref = {k: _norm(reference[k]) for k in leaves}
    med = statistics.median(ref.values())
    worst = 0.0
    for k in leaves:
        p = _norm(program[k])
        if not np.isfinite(p):
            return float("inf")
        worst = max(worst, abs(p - ref[k]) / max(ref[k], med, 1e-30))
    return worst


def train_numbers(program: dict, reference: dict) -> Dict[str, float]:
    """`program` and `reference` hold "losses" (the first three steps'),
    "grad" (the first step's gradient by leaf; the program's from Adam's
    first moment), "start" and "after" (the leaves before the first step and
    after the third)."""
    leaves = kept_leaves(reference["grad"])
    lp = np.asarray(program["losses"], np.float64)
    lr = np.asarray(reference["losses"], np.float64)
    loss_gap = float(np.max(np.abs(lp - lr) / np.maximum(np.abs(lr), 1e-30)))
    if not np.isfinite(lp).all():
        loss_gap = float("inf")

    def change(side):
        return {k: np.asarray(side["after"][k], np.float64)
                - np.asarray(side["start"][k], np.float64) for k in leaves}
    return dict(loss_gap=loss_gap,
                grad_gap=leaf_gap(program["grad"], reference["grad"], leaves),
                change_gap=leaf_gap(change(program), change(reference),
                                    leaves))


def judged(numbers: Dict[str, float], limits: Dict[str, float]) -> dict:
    """name -> {"value", "limit"}; every number has a limit."""
    missing = set(numbers) - set(limits)
    if missing:
        raise KeyError(f"no limit for {sorted(missing)}")
    return {k: dict(value=float(v), limit=float(limits[k]))
            for k, v in numbers.items()}


def correct(checks: dict) -> bool:
    return all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())
