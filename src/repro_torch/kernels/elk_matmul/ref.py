"""Plain PyTorch oracle for the ELK-blocked matmul.

Counterpart of ``src/repro/kernels/elk_matmul/ref.py``.  Only the oracle
is here (``fused_mlp``'s ``composed_ref`` is built from it); the Hopper
kernel for ``elk_matmul`` itself is still to be ported (ROADMAP.md,
Queue 2).
"""

from __future__ import annotations

from typing import Optional

import torch


def matmul_ref(x: torch.Tensor, y: torch.Tensor,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(M, K) @ (K, N) with fp32 accumulation, output in ``x``'s dtype."""
    out = torch.matmul(x.to(torch.float32), y.to(torch.float32))
    return out.to(out_dtype or x.dtype)
