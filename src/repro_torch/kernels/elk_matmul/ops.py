"""Public wrapper of the ELK-blocked matmul: CUDA kernel or plain version by
device."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.dispatch import dispatch
from repro_torch.kernels.elk_matmul.kernel import elk_matmul_kernel
from repro_torch.kernels.elk_matmul.ref import matmul_ref


def matmul(x: torch.Tensor, y: torch.Tensor, *, bm: Optional[int] = None,
           bn: Optional[int] = None, bk: Optional[int] = None
           ) -> torch.Tensor:
    """(M, K) @ (K, N) -> (M, N), fp32 accumulation, output in x's type.

    On a CUDA tensor the hand-written kernel runs (or raises), with the
    block shape given or, for what is not given, ``smem_plan``'s; on a CPU
    tensor ``matmul_ref``, whatever the block shape."""
    return dispatch(x, lambda: elk_matmul_kernel(x, y, bm=bm, bn=bn, bk=bk),
                    lambda: matmul_ref(x, y))
