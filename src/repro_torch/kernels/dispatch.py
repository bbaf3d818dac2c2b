"""Backend dispatch for the kernel wrappers of the port.

Counterpart of the reference's ``kernels/dispatch.py``.  Its three-way
split (compiled on the TPU / interpret mode when forced / jnp oracle)
becomes two-way here, and the tensor's device decides: a CUDA tensor
launches the hand-written kernel or raises, a CPU tensor takes the plain
PyTorch version.  There is no interpret mode for a CUDA kernel, hence no
``force_kernels``; and nothing here catches a kernel's failure to give way
to the plain version.
"""

from __future__ import annotations

from typing import Callable

import torch


def dispatch(x: torch.Tensor, kernel_call: Callable[[], torch.Tensor],
             ref_call: Callable[[], torch.Tensor]) -> torch.Tensor:
    """``kernel_call()`` when ``x`` lies on a CUDA device, ``ref_call()``
    when it lies on the CPU; any other device is refused."""
    if x.is_cuda:
        return kernel_call()
    if x.device.type == "cpu":
        return ref_call()
    raise ValueError(f"no kernel route for device {x.device}")
