"""Public wrapper of the ELK-blocked matmul: CUDA kernel or plain version by
device, with its gradient."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import cost
from repro_torch.kernels.dispatch import dispatch
from repro_torch.kernels.elk_matmul.kernel import elk_matmul_kernel
from repro_torch.kernels.elk_matmul.ref import matmul_bwd_ref, matmul_ref


class _Matmul(torch.autograd.Function):
    """out = x @ y with both gradients on the same route as the product:
    dx = dout @ y^T (y's transpose read in place, as ``layout`` takes it)
    and dy = x^T @ dout (x read transposed in place, contracted over its
    rows: the tokens of a weight gradient), each one call of the kernel on
    a CUDA tensor and of ``matmul_ref`` on a CPU tensor."""

    @staticmethod
    def forward(ctx, x, y):
        ctx.save_for_backward(x, y)
        return dispatch(x, lambda: elk_matmul_kernel(x, y),
                        lambda: matmul_ref(x, y), lambda: cost.matmul(x, y))

    @staticmethod
    def backward(ctx, dout):
        x, y = ctx.saved_tensors
        need_x, need_y = ctx.needs_input_grad[:2]
        dout = dout.contiguous()   # autograd may hand over an expanded view
        return dispatch(
            x,
            lambda: (elk_matmul_kernel(dout, y.t()) if need_x else None,
                     elk_matmul_kernel(x.t(), dout) if need_y else None),
            lambda: matmul_bwd_ref(x, y, dout, need_x, need_y),
            lambda: cost.matmul_bwd(x, y, dout, need_x, need_y))


def matmul(x: torch.Tensor, y: torch.Tensor, *, bm: Optional[int] = None,
           bn: Optional[int] = None, bk: Optional[int] = None
           ) -> torch.Tensor:
    """(M, K) @ (K, N) -> (M, N), fp32 accumulation, output in x's type.

    On a CUDA tensor the hand-written kernel runs (or raises), with the
    block shape given or, for what is not given, ``smem_plan``'s; on a CPU
    tensor ``matmul_ref``, whatever the block shape.  When autograd
    records (grad enabled and an operand that requires it) the product
    runs through ``_Matmul``, whose gradients are the kernel's too; the
    serving paths (inference mode, no grad) call the kernel directly."""
    if (torch.is_grad_enabled() and (x.requires_grad or y.requires_grad)
            and bm is None and bn is None and bk is None):
        return _Matmul.apply(x, y)
    return dispatch(x, lambda: elk_matmul_kernel(x, y, bm=bm, bn=bn, bk=bk),
                    lambda: matmul_ref(x, y), lambda: cost.matmul(x, y))

