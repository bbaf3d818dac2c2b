"""Plain PyTorch oracle for the ELK-blocked matmul.

Counterpart of ``src/repro/kernels/elk_matmul/ref.py``.  The Hopper kernel
is ``csrc/elk_matmul.cu`` (wrapper ``kernel.py``, routed by ``ops.matmul``,
which ``models/layers.linear`` calls for every projection and the LM head);
this is its plain version, what ``ops.matmul`` runs on CPU tensors and
what ``chip_smoke.py`` holds the kernel to.  ``fused_mlp``'s
``composed_ref`` is built from it too.
"""

from __future__ import annotations

from typing import Optional

import torch


def matmul_ref(x: torch.Tensor, y: torch.Tensor,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(M, K) @ (K, N) with fp32 accumulation, output in ``x``'s dtype."""
    out = torch.matmul(x.to(torch.float32), y.to(torch.float32))
    return out.to(out_dtype or x.dtype)
