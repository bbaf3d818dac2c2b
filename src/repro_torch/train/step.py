"""The training step: microbatched gradient accumulation + AdamW.

Counterpart of ``src/repro/train/step.py`` on one GPU:

* **microbatching**: the batch is split into ``grad_accum`` microbatches
  run in a Python loop (the reference's ``lax.scan``); only one
  microbatch's activations and logits are live at a time, and each
  microbatch's gradients are added into one accumulation buffer per
  parameter, fp32, or bf16 above 1e11 parameters (the reference's rule);
* **gradient compression**: ``none``, ``bf16`` or ``int8`` with error
  feedback (``distributed/compression.py``), applied before the update;
* **the update**: ``optim/adamw.apply_update``, in place.

There are no shardings, meshes or ``jit_train_step``: the port runs on one
GPU, where PyTorch runs the step eagerly and nothing needs placing
(ROADMAP.md, Queue 1: the production mesh).  Gradients come from autograd
through the model's kernels, whose backward passes are hand-written
kernels on the card (``kernels/*/ops.py``).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.distributed import compression as comp
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def make_loss_fn(cfg: ModelConfig, remat: bool = True) -> Callable:
    def loss_fn(params, batch):
        return tfm.loss_fn(params, cfg, batch, remat=remat)
    return loss_fn


def value_and_grad(loss_fn: Callable, params: Any, batch: dict
                   ) -> tuple[torch.Tensor, Any]:
    """(loss, gradients in the structure of ``params``) by autograd; every
    parameter must require grad."""
    loss = loss_fn(params, batch)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    return loss.detach(), tree_unflatten(params, list(grads))


def _micro(batch: dict, n: int) -> list[dict]:
    """``batch`` split along its first axis into ``n`` microbatches."""
    for v in batch.values():
        if v.shape[0] % n:
            raise ValueError(f"batch of {v.shape[0]} does not split into "
                             f"{n} microbatches")
    parts = {k: torch.chunk(v, n, dim=0) for k, v in batch.items()}
    return [{k: p[i] for k, p in parts.items()} for i in range(n)]


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    grad_accum: int = 1, compression: str = "none",
                    accum_dtype=None, remat: bool = True) -> Callable:
    """step_fn(params, opt_state, batch, err_fb) -> (params, opt_state,
    metrics, err_fb), updating params and opt_state in place; ``batch`` on
    the parameters' device.  ``accum_dtype`` sets the accumulation buffer's
    type (default: fp32, bf16 above 1e11 parameters)."""
    loss_fn = make_loss_fn(cfg, remat)
    acc_dt = accum_dtype or (torch.bfloat16 if cfg.param_count() > 1e11
                             else torch.float32)

    def train_step(params, opt_state, batch, err_fb):
        if grad_accum > 1:
            gsum, lsum = None, 0.0
            for mb in _micro(batch, grad_accum):
                loss, g = value_and_grad(loss_fn, params, mb)
                if gsum is None:
                    gsum = tree_map(lambda t: t.to(acc_dt), g)
                else:
                    tree_map(lambda a, t: a.add_(t.to(acc_dt)), gsum, g)
                del g
                lsum = lsum + loss
            grads = tree_map(lambda a: a / grad_accum, gsum)
            loss = lsum / grad_accum
        else:
            loss, grads = value_and_grad(loss_fn, params, batch)
        grads, err_fb = comp.compress_grads(grads, err_fb, compression)
        params, opt_state, metrics = adamw.apply_update(params, grads,
                                                        opt_state, opt_cfg)
        metrics["loss"] = loss
        return params, opt_state, metrics, err_fb

    return train_step
