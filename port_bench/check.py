"""The numbers that decide ``correct``: the program's readings of its
first epochs against the reference's readings of the same epochs.

- ``loss_gap``: the widest relative gap between the two losses over the
  epochs read, each side on its own trajectory.
- ``grad_gap``: the first gradient as the optimizer holds it after one
  step, by the worst leaf: the gap between the program's norm of the
  leaf and the reference's, over the larger of the reference's norm of
  that leaf and of the median leaf.
- ``change_gap``: the parameters' change over the epochs read, by the
  worst leaf, measured alike; ``change_median_gap``: the median leaf's.
  Leaves whose reference gradient is under a thousandth of the median
  leaf's are left out of both (Adam moves them by round-off alone).
- ``pred_gap``: over every node and every epoch read, the widest gap by
  which the reference's logit of the class the program predicted lies
  below the reference's best, the reference's eval forward taken at the
  program's own parameters after that epoch (0 where both pick the same
  class).

Each cell's limits file gives every number a limit, or ``null`` where
the cell does not compare it (``PERF.md`` gives the readings and why).
"""

from __future__ import annotations

import math
import statistics
from typing import Callable, Dict, List, Tuple

import torch

NUMBERS = ("loss_gap", "grad_gap", "change_gap", "change_median_gap",
           "pred_gap")
EXCLUDE_BELOW = 1e-3


def _norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.detach().double().norm()) for k, v in leaves.items()}


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              leaves: List[str]) -> Dict[str, float]:
    """Each leaf's norm gap over the larger of its reference norm and the
    median leaf's."""
    pn = _norms({k: prog[k] for k in leaves})
    rn = _norms({k: ref[k] for k in leaves})
    med = statistics.median(rn.values())
    out = {}
    for k in leaves:
        denom = max(rn[k], med)
        gap = abs(pn[k] - rn[k]) / denom if denom > 0 else math.inf
        out[k] = gap if math.isfinite(gap) else math.inf
    return out


def pred_gap(preds: List[torch.Tensor], ref_logits: Callable[[int],
                                                             torch.Tensor]
             ) -> float:
    """``ref_logits(i)``: the reference's eval logits at the program's
    parameters after epoch ``i``."""
    worst = 0.0
    for i, pred in enumerate(preds):
        logits = ref_logits(i)
        best = logits.max(dim=-1).values
        got = logits.gather(-1, pred.long().view(-1, 1))[:, 0]
        gap = float((best - got).max())
        del logits, best, got
        if not math.isfinite(gap):
            return math.inf
        worst = max(worst, gap)
    return worst


def sign_flips(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]
               ) -> int:
    """Entries of the first gradient whose sign differs between the two
    (Adam's first step moves each entry by the learning rate in the
    direction of its sign, so one such entry parts the trajectories)."""
    return int(sum(int((torch.sign(prog[k]) != torch.sign(ref[k])).sum())
                   for k in ref))


def numbers(prog: Dict, ref: Dict,
            ref_logits: Callable[[int], torch.Tensor]) -> Dict:
    """``{name: value}`` for :data:`NUMBERS`, plus what they were read
    over (each epoch's loss gap, the worst leaves, the excluded leaves,
    the first gradient's sign flips)."""
    losses = []
    for lp, lr in zip(prog["losses"], ref["losses"]):
        g = abs(lp - lr) / abs(lr) if lr != 0 else math.inf
        losses.append(g if math.isfinite(g) else math.inf)
    if len(prog["losses"]) != len(ref["losses"]) or not losses:
        losses.append(math.inf)
    leaves = list(ref["grad1"])
    gnorm = _norms(ref["grad1"])
    med = statistics.median(gnorm.values())
    moving = [k for k in leaves if gnorm[k] >= EXCLUDE_BELOW * med]
    grad = leaf_gaps(prog["grad1"], ref["grad1"], leaves)
    change = leaf_gaps(prog["change"], ref["change"], moving)
    return {
        "loss_gap": max(losses),
        "grad_gap": max(grad.values()),
        "change_gap": max(change.values()),
        "change_median_gap": statistics.median(change.values()),
        "pred_gap": pred_gap(prog["preds"], ref_logits),
        "loss_gaps": losses,
        "grad_worst_leaf": max(grad, key=grad.get),
        "change_worst_leaf": max(change, key=change.get),
        "excluded_leaves": sorted(set(leaves) - set(moving)),
        "sign_flips": sign_flips(prog["grad1"], ref["grad1"]),
    }


def judge(nums: Dict, limits: Dict) -> Tuple[bool, Dict]:
    """``correct`` (every number the cell compares at or under its
    limit) and ``{name: {"value", "limit"}}`` of those numbers."""
    shown, ok = {}, True
    for name in NUMBERS:
        lim = limits.get(name)
        if lim is None:
            continue
        v = nums[name]
        shown[name] = {"value": v, "limit": lim}
        ok = ok and math.isfinite(v) and v <= lim
    return ok and bool(shown), shown


def preds_of(logits: torch.Tensor) -> torch.Tensor:
    """A node's predicted class, as the program's epoch reads it, kept in
    one byte a node where the classes fit."""
    pred = logits.argmax(dim=-1)
    return pred.to(torch.uint8) if logits.shape[-1] <= 256 else pred
