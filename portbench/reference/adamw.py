"""Plain AdamW in fp32: the update the job file states, worked out again.

The step's learning rate is a linear warmup to ``lr`` over
``warmup_steps``, then a cosine to ``min_lr_frac * lr`` at
``total_steps``; gradients are scaled by ``min(1, grad_clip / |g|)`` (the
global norm); the moments have bias corrections; weight decay is decoupled
and applies to every leaf.  The weights may be kept in the configuration's
parameter type between steps (``store``).
"""

from __future__ import annotations

import math

import torch


def learning_rate(opt: dict, step: int) -> float:
    warm = max(opt["warmup_steps"], 1)
    if step < opt["warmup_steps"]:
        return opt["lr"] * step / warm
    span = max(opt["total_steps"] - opt["warmup_steps"], 1)
    t = min(max((step - opt["warmup_steps"]) / span, 0.0), 1.0)
    lo = opt["min_lr_frac"]
    return opt["lr"] * (lo + (1 - lo) * 0.5 * (1 + math.cos(math.pi * t)))


@torch.no_grad()
def update(params: list, grads: list, m: list, v: list, step: int,
           opt: dict, store=None) -> float:
    """One step in place over fp32 leaves; ``step`` counts from 1.  With
    ``store`` (the configuration's parameter type) each updated weight is
    rounded to it, as the configuration keeps its weights; the arithmetic
    stays fp32.  Returns the clip scale the gradients were given."""
    gnorm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
    scale = min(1.0, opt["grad_clip"] / max(float(gnorm), 1e-12)) \
        if opt["grad_clip"] else 1.0
    lr = learning_rate(opt, step)
    b1, b2 = opt["b1"], opt["b2"]
    c1, c2 = 1 - b1 ** step, 1 - b2 ** step
    for p, g, mi, vi in zip(params, grads, m, v):
        g = g * scale
        mi.mul_(b1).add_(g, alpha=1 - b1)
        vi.mul_(b2).addcmul_(g, g, value=1 - b2)
        delta = (mi / c1) / (torch.sqrt(vi / c2) + opt["eps"]) \
            + opt["weight_decay"] * p
        p.sub_(lr * delta)
        if store is not None:
            p.copy_(p.to(store))
    return scale
