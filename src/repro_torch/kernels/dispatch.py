"""Backend dispatch for the kernel wrappers of the port.

Counterpart of the reference's ``kernels/dispatch.py``.  Its three-way
split (compiled on the TPU / interpret mode when forced / jnp oracle)
becomes this, and the tensor's device decides: a CUDA tensor launches the
hand-written kernel or raises, a CPU tensor takes the plain PyTorch
version, and a **meta** tensor (the dry run's, ``launch/hlo_analysis``)
gets an empty result of the kernel's shapes while the counter in force
records the kernel's own work (``kernels/cost.py``: its FLOPs, operand and
result bytes); neither the kernel nor the plain version runs.  There is
no interpret mode for a CUDA kernel, hence no ``force_kernels``; and
nothing here catches a kernel's failure to give way to the plain version.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

# the counters in force, innermost last (``counting``)
_COUNTERS: list = []


def dispatch(x: torch.Tensor, kernel_call: Callable[[], torch.Tensor],
             ref_call: Callable[[], torch.Tensor],
             meta_call: Optional[Callable[[], tuple]] = None
             ) -> torch.Tensor:
    """``kernel_call()`` when ``x`` lies on a CUDA device, ``ref_call()``
    when it lies on the CPU; on the meta device the result of
    ``meta_call()``, which returns (result, entries), the entries (name,
    FLOPs, bytes) given to the counter in force, if any.  Any other device
    is refused."""
    if x.is_cuda:
        return kernel_call()
    if x.device.type == "cpu":
        return ref_call()
    if x.device.type == "meta" and meta_call is not None:
        out, entries = meta_call()
        if _COUNTERS:
            for entry in entries:
                _COUNTERS[-1].kernel(*entry)
        return out
    raise ValueError(f"no kernel route for device {x.device}")


@contextlib.contextmanager
def counting(counter):
    """``counter`` (with ``kernel(name, flops, bytes)`` and
    ``host_copy(bytes)``) receives the kernel launches on meta tensors
    until the context ends."""
    _COUNTERS.append(counter)
    try:
        yield counter
    finally:
        _COUNTERS.remove(counter)


def count_host_copy(nbytes: float) -> None:
    """A host-to-device copy of ``nbytes`` made on the meta device (a
    streamed layer's weights), for the counter in force, if any."""
    if _COUNTERS:
        _COUNTERS[-1].host_copy(nbytes)
