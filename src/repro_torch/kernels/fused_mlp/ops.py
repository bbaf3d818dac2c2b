"""Public wrapper of the fused MLP: CUDA kernel or plain version by device,
with its gradient."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import cost
from repro_torch.kernels.dispatch import dispatch
from repro_torch.kernels.fused_mlp.kernel import (fused_mlp_bwd_kernel,
                                                  fused_mlp_kernel)
from repro_torch.kernels.fused_mlp.ref import fused_mlp_bwd_ref, fused_mlp_ref

_OPERANDS = ("x", "w_up", "w_down", "w_gate", "b_up", "b_down")


class _FusedMlp(torch.autograd.Function):
    """``fused_mlp`` with its gradient: ``fused_mlp_bwd_kernel`` on a CUDA
    tensor, ``fused_mlp_bwd_ref`` on a CPU tensor."""

    @staticmethod
    def forward(ctx, x, w_up, w_down, w_gate, b_up, b_down, act):
        ctx.act = act
        ctx.save_for_backward(x, w_up, w_down, w_gate, b_up, b_down)
        return _forward(x, w_up, w_down, w_gate, b_up, b_down, act)

    @staticmethod
    def backward(ctx, dy):
        x, w_up, w_down, w_gate, b_up, b_down = ctx.saved_tensors
        kw = dict(w_gate=w_gate, b_up=b_up, b_down=b_down, act=ctx.act)
        grads = dispatch(
            x, lambda: fused_mlp_bwd_kernel(x, w_up, w_down, dy, **kw),
            lambda: fused_mlp_bwd_ref(x, w_up, w_down, dy, **kw),
            lambda: cost.fused_mlp_bwd(x, w_up, w_down, dy, w_gate, b_up,
                                       b_down))
        return (*(grads[name] for name in _OPERANDS), None)


def _forward(x, w_up, w_down, w_gate, b_up, b_down, act):
    return dispatch(
        x,
        lambda: fused_mlp_kernel(x, w_up, w_down, w_gate, b_up, b_down,
                                 act=act),
        lambda: fused_mlp_ref(x, w_up, w_down, w_gate=w_gate, b_up=b_up,
                              b_down=b_down, act=act),
        lambda: cost.fused_mlp(x, w_up, w_down, w_gate, b_up, b_down))


def fused_mlp(x: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor, *,
              w_gate: Optional[torch.Tensor] = None,
              b_up: Optional[torch.Tensor] = None,
              b_down: Optional[torch.Tensor] = None,
              act: str = "silu") -> torch.Tensor:
    """up-proj -> activation -> down-proj without storing the intermediate.

    GLU when ``w_gate`` is given, plain MLP (optional fc biases) otherwise.
    On a CUDA tensor the hand-written kernel runs (or raises); on a CPU
    tensor the einsum composition ``fused_mlp_ref``.  When autograd records
    (grad enabled and an operand that requires it) the call goes through
    ``_FusedMlp``, whose gradient is the backward kernel on the card."""
    operands = (x, w_up, w_down, w_gate, b_up, b_down)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in operands):
        return _FusedMlp.apply(*operands, act)
    return _forward(*operands, act)
