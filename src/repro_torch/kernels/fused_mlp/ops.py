"""Public wrapper of the fused MLP: CUDA kernel or plain version by device."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.dispatch import dispatch
from repro_torch.kernels.fused_mlp.kernel import fused_mlp_kernel
from repro_torch.kernels.fused_mlp.ref import fused_mlp_ref


def fused_mlp(x: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor, *,
              w_gate: Optional[torch.Tensor] = None,
              b_up: Optional[torch.Tensor] = None,
              b_down: Optional[torch.Tensor] = None,
              act: str = "silu") -> torch.Tensor:
    """up-proj -> activation -> down-proj without storing the intermediate.

    GLU when ``w_gate`` is given, plain MLP (optional fc biases) otherwise.
    On a CUDA tensor the hand-written kernel runs (or raises); on a CPU
    tensor the einsum composition ``fused_mlp_ref``."""
    return dispatch(
        x,
        lambda: fused_mlp_kernel(x, w_up, w_down, w_gate, b_up, b_down,
                                 act=act),
        lambda: fused_mlp_ref(x, w_up, w_down, w_gate=w_gate, b_up=b_up,
                              b_down=b_down, act=act))
