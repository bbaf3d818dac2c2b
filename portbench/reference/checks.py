"""The numbers that decide ``correct``, each beside its limit.

Served tokens: for every sampled request, the reference's logits at the
positions that produced its served tokens; a served token's gap is how far
its logit lies below the reference's best there, and ``served_gap`` is the
widest.  A control that computes in a lower precision is read by the gap
of the token it puts first (``first_choice_gap``).

Training: ``loss_rel`` is the widest relative gap of the first steps'
losses; ``grad_gap`` and ``change_gap`` compare per-leaf norms of the
first gradient as the optimizer took it and of the parameters' change over
the first steps: the worst leaf's |program - reference| over the larger of
that leaf's reference norm and the median leaf's.  Leaves whose reference
gradient is under a thousandth of the median leaf's are left out of the
change: Adam moves them by round-off alone.
"""

from __future__ import annotations

import statistics

import torch


def served_gap(ref_logits: list[torch.Tensor], served: list[torch.Tensor]
               ) -> float:
    worst = 0.0
    for z, tok in zip(ref_logits, served):
        gap = z.max(dim=-1).values - z.gather(-1, tok[:, None].long())[:, 0]
        worst = max(worst, float(gap.max()))
    return worst


def first_choice_gap(ref_logits: list[torch.Tensor],
                     other_logits: list[torch.Tensor]) -> float:
    return served_gap(ref_logits, [o.argmax(dim=-1) for o in other_logits])


def _leaf_gap(prog: list[float], ref: list[float], keep=None) -> float:
    floor = statistics.median(ref)
    idx = range(len(ref)) if keep is None else keep
    return max((abs(prog[i] - ref[i]) / (max(ref[i], floor) or 1.0)
                for i in idx), default=0.0)


def train_numbers(prog: dict, ref: dict) -> dict[str, float]:
    """``prog`` and ``ref``: ``loss`` (one a step), ``grad`` and
    ``change`` (one a leaf)."""
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"],
                                                         ref["loss"]))
    floor = statistics.median(ref["grad"])
    keep = [i for i, g in enumerate(ref["grad"]) if g >= 1e-3 * floor]
    return {"loss_rel": loss_rel,
            "grad_gap": _leaf_gap(prog["grad"], ref["grad"]),
            "change_gap": _leaf_gap(prog["change"], ref["change"], keep),
            "leaves_left_out": len(ref["grad"]) - len(keep)}


def verdict(numbers: dict[str, float], limits: dict[str, float]) -> dict:
    """Each number beside its limit; ``correct`` when none exceeds it."""
    rows = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(r["value"] <= r["limit"] for r in rows.values())
    return {"correct": ok, "checks": rows}
