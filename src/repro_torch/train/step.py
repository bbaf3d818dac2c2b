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

``jit_train_step`` keeps the reference's signature and returns this eager
step with the spec trees of the parameters, the optimizer state and the
batch from ``distributed/sharding.py``'s rules: there is no jit (PyTorch
runs the step as it comes), and on the one GPU the port runs on every spec
is already met; on the production mesh the specs give the per-device
shards the dry run accounts (``launch/dryrun.py``).  Gradients come from
autograd through the model's kernels, whose backward passes are
hand-written kernels on the card (``kernels/*/ops.py``).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.distributed import compression as comp
from repro_torch.distributed.sharding import batch_specs, param_specs
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


def jit_train_step(cfg: ModelConfig, mesh, opt_cfg: adamw.AdamWConfig,
                   params_like: Any, batch_like: dict,
                   grad_accum: int = 1, compression: str = "none",
                   fsdp: bool = False, layout: str = "tp"
                   ) -> tuple[Callable, dict]:
    """The reference's ``jit_train_step``: (step_fn, specs), where step_fn
    is ``make_train_step``'s eager step (no jit: PyTorch runs it as it
    comes) and ``specs`` holds the spec trees the reference pins as
    shardings: ``params`` (``fsdp``, ``layout``), ``opt`` (the step
    replicated; the moments in the ZeRO placement, sharded over data and
    model, or the parameters' own under ``fsdp2d``), ``batch`` (dim 0 over
    (pod, data)) and ``err`` (the int8 error feedback in the ZeRO
    placement, else None).  ``params_like`` and ``batch_like`` may be meta
    tensors (the dry run's)."""
    p_specs = param_specs(params_like, mesh, fsdp=fsdp, layout=layout,
                          cfg=cfg)
    zero = (p_specs if layout == "fsdp2d"
            else param_specs(params_like, mesh, fsdp=True, cfg=cfg))
    specs = {"params": p_specs, "opt": {"step": (), "m": zero, "v": zero},
             "batch": batch_specs(batch_like, mesh),
             "err": zero if compression == "int8" else None}
    step = make_train_step(cfg, opt_cfg, grad_accum=grad_accum,
                           compression=compression)
    return step, specs
