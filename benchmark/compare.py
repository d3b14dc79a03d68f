"""The numbers that decide ``correct``, and their limits.

Each reading compares what the program produced with what the plain
reference (``reference.py``) produced from the same inputs, as a gap
relative to the reference's own size, and takes the worst over rows:

  - ``loss_gap``: every training step's loss, each row and step, against
    the larger of |reference loss| and the median |loss| over the rows at
    that step; ``loss1_gap`` the same of the first step alone, before any
    update (steadier: from the second step on, Adam moves every weight by
    about lr whatever its gradient's size, so a rounding-level change of a
    small gradient flips a whole update, and bf16 products part the
    later losses by ~1%);
  - ``grad_gap``: the first step's gradient as Adam received it (the
    program's from its first moment after one step, m / (1 − β1)), leaf by
    leaf: the gap between the two norms against the larger of the
    reference leaf's norm and the row's median leaf norm; ``grad_diff_gap``
    the norm of the two whole gradients' difference against the
    reference's norm (a gap of norms can cancel by chance in one row,
    where the errors of lower-precision products do not);
  - ``change_gap``: the parameters' change over the first steps, leaf by
    leaf as for ``grad_gap``, over the leaves whose reference gradient is
    at least a thousandth of the row's median leaf gradient (a leaf below
    that moves under Adam by round-off alone);
  - ``eval_gap``: where the cell checks an eval, every stat each row's
    eval wrote, against the larger of |reference| and the median over rows.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Sequence

import torch

GRAD_FLOOR = 1e-3  # a leaf's gradient under this share of the median leaf's is round-off


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def loss_gap(prog: Sequence[Sequence[float]], ref: Sequence[Sequence[float]]) -> float:
    worst = 0.0
    for s in range(len(ref[0])):
        floor = statistics.median(abs(r[s]) for r in ref)
        for p, r in zip(prog, ref):
            worst = max(worst, abs(p[s] - r[s]) / max(abs(r[s]), floor))
    return worst


def _leaf_gaps(p: Dict[str, torch.Tensor], r: Dict[str, torch.Tensor],
               names: Sequence[str]) -> List[float]:
    ref_norms = {k: _norm(r[k]) for k in names}
    floor = statistics.median(ref_norms.values())
    return [abs(_norm(p[k]) - ref_norms[k]) / max(ref_norms[k], floor) for k in names]


def leaf_gap(prog: Sequence[Dict[str, torch.Tensor]], ref: Sequence[Dict[str, torch.Tensor]],
             keep: Sequence[Sequence[str]] = None) -> float:
    """The worst leaf's gap over every row."""
    return max(max(_leaf_gaps(p, r, list(r) if keep is None else keep[i]))
               for i, (p, r) in enumerate(zip(prog, ref)))


def grad_diff(prog: Sequence[Dict[str, torch.Tensor]],
              ref: Sequence[Dict[str, torch.Tensor]]) -> float:
    """The worst row's ‖program − reference‖ over its whole gradient,
    against the reference gradient's norm."""
    worst = 0.0
    for p, r in zip(prog, ref):
        diff = sum(_norm(p[k] - r[k]) ** 2 for k in r) ** 0.5
        worst = max(worst, diff / sum(_norm(r[k]) ** 2 for k in r) ** 0.5)
    return worst


def kept_leaves(ref_g1: Sequence[Dict[str, torch.Tensor]]) -> List[List[str]]:
    """Each row's leaves whose reference gradient is not round-off."""
    out = []
    for g in ref_g1:
        norms = {k: _norm(t) for k, t in g.items()}
        floor = GRAD_FLOOR * statistics.median(norms.values())
        out.append([k for k, n in norms.items() if n >= floor])
    return out


def eval_gap(prog: Sequence[Dict[str, float]], ref: Sequence[Dict[str, float]]) -> float:
    worst = 0.0
    for key in ref[0]:
        floor = statistics.median(abs(r[key]) for r in ref)
        for p, r in zip(prog, ref):
            worst = max(worst, abs(p[key] - r[key]) / max(abs(r[key]), floor))
    return worst


def readings(prog: dict, ref: dict) -> Dict[str, float]:
    """Every number a cell compares, from the program's records and the
    reference's (the same keys: "loss", "g1", "delta", and "eval" where the
    cell checks an eval)."""
    first = lambda losses: [row[:1] for row in losses]  # noqa: E731
    out = {"loss_gap": loss_gap(prog["loss"], ref["loss"]),
           "loss1_gap": loss_gap(first(prog["loss"]), first(ref["loss"])),
           "grad_gap": leaf_gap(prog["g1"], ref["g1"]),
           "grad_diff_gap": grad_diff(prog["g1"], ref["g1"]),
           "change_gap": leaf_gap(prog["delta"], ref["delta"], kept_leaves(ref["g1"]))}
    if "eval" in ref:
        out["eval_gap"] = eval_gap(prog["eval"], ref["eval"])
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when every number is within its limit (a missing or non-finite
    number fails)."""
    return all(k in numbers and numbers[k] == numbers[k] and numbers[k] <= lim
               for k, lim in limits.items())
