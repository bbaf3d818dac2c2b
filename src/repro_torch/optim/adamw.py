"""AdamW with the reference's warmup-cosine schedule, in place on one GPU.

Counterpart of ``src/repro/optim/adamw.py``: the same ``AdamWConfig``,
schedule, global-norm clip, bias corrections, decoupled weight decay on
every leaf, and moments held in ``state_dtype`` (fp32, or bf16 to halve
them).  What differs, by design:

* the update is **in place** on the parameter and moment tensors, the
  counterpart of the reference donating them to its compiled step
  (``donate_argnums``): no second copy of the weights or the moments is
  ever live;
* the fp32 temporaries of a leaf are formed a slab of rows at a time
  (at most ``SLAB_BYTES`` of fp32 a slab), as the reference maps its
  update over the stacked axis of a large leaf (its ``:91``): qwen3-14b's
  embedding alone is 3.1 GB in fp32;
* no shardings (``state_shardings``): one GPU holds the state;
* the step counter is a Python int, so that the schedule costs no read
  from the card.

The update is elementwise PyTorch, bound by the bytes it moves; the
reference leaves it to XLA too.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map

SLAB_BYTES = 1 << 28     # fp32 bytes of one slab of a large leaf's update


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"      # "bfloat16" halves optimizer memory
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def cosine_schedule(cfg: AdamWConfig) -> Callable[[int], float]:
    """Linear warmup to ``lr``, then a cosine to ``min_lr_frac * lr`` at
    ``total_steps``; in fp32 as the reference computes it."""
    f = np.float32

    def lr(step: int) -> float:
        s = f(step)
        warm = f(cfg.lr) * s / f(max(cfg.warmup_steps, 1))
        t = np.clip((s - f(cfg.warmup_steps))
                    / f(max(cfg.total_steps - cfg.warmup_steps, 1)),
                    f(0.0), f(1.0))
        cos = f(cfg.min_lr_frac) + (f(1) - f(cfg.min_lr_frac)) * f(0.5) * (
            f(1) + np.cos(f(math.pi) * t))
        return float(warm if s < f(cfg.warmup_steps) else f(cfg.lr) * cos)
    return lr


def init_state(params: Any, cfg: AdamWConfig) -> dict:
    """Step 0 and zero moments of ``state_dtype`` beside every parameter."""
    dt = getattr(torch, cfg.state_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    return {"step": 0, "m": tree_map(zeros, params),
            "v": tree_map(zeros, params)}


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32, on the leaves'
    device (no read back)."""
    return torch.sqrt(sum(torch.sum(leaf.to(torch.float32) ** 2)
                          for leaf in tree_leaves(tree)))


def _slabs(t: torch.Tensor) -> list[torch.Tensor]:
    """Views of ``t`` along its first axis whose fp32 copies take at most
    ``SLAB_BYTES`` (the whole tensor when it is small, or on the meta
    device, where nothing is allocated and the count is the same)."""
    if t.dim() == 0 or t.is_meta or t.numel() * 4 <= SLAB_BYTES:
        return [t]
    rows = max(1, SLAB_BYTES // (4 * (t.numel() // t.shape[0])))
    return list(torch.split(t, rows, dim=0))


@torch.no_grad()
def apply_update(params: Any, grads: Any, state: dict, cfg: AdamWConfig
                 ) -> tuple[Any, dict, dict]:
    """One AdamW step, in place: returns (params, state, metrics), the
    first two the same objects updated, metrics ``grad_norm`` (a 0-d fp32
    tensor on the device) and ``lr``."""
    step = state["step"] + 1
    lr = cosine_schedule(cfg)(step)
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                         max=1.0) if cfg.grad_clip else 1.0)
    b1, b2 = cfg.b1, cfg.b2
    f = np.float32
    c1 = float(f(1.0) - f(b1) ** f(step))
    c2 = float(f(1.0) - f(b2) ** f(step))
    f32 = torch.float32
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["m"]), tree_leaves(state["v"])):
        for ps, gs, ms, vs in zip(_slabs(p), _slabs(g), _slabs(m), _slabs(v)):
            g32 = gs.to(f32) * scale
            m32 = b1 * ms.to(f32) + (1 - b1) * g32
            v32 = b2 * vs.to(f32) + (1 - b2) * g32 * g32
            delta = (m32 / c1) / (torch.sqrt(v32 / c2) + cfg.eps) \
                + cfg.weight_decay * ps.to(f32)
            ps.copy_(ps.to(f32) - lr * delta)
            ms.copy_(m32)
            vs.copy_(v32)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
