"""Gradient compression of the reference's cross-pod boundary, on one GPU.

Counterpart of ``src/repro/distributed/compression.py``: ``bf16`` (cast
the gradients to bf16) and ``int8`` (a per-tensor scale, with **error
feedback**: the quantization residual is carried to the next step so that
the compression bias telescopes away).  The port has one GPU and no pod
axis to reduce over, so this is what the wire would carry, applied to the
gradients before the update, as the reference's step applies it.

The int8 scale divides as a tensor (``x / scale``), and the rounding is
half to even (``torch.round``), as ``jnp.round``: PyTorch on the card
multiplies by the reciprocal of a Python number, which moves ties.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.tree import tree_map


def _q_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    amax = torch.max(torch.abs(x.to(torch.float32)))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127)
    return q.to(torch.int8), scale


def _dq_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_grads(grads: Any, error: Optional[Any], method: str = "none"
                   ) -> tuple[Any, Optional[Any]]:
    """(wire_grads, new_error_feedback): the (de)quantized values the
    receiving side would see, and the residual to add next step."""
    if method == "none":
        return grads, error
    if method == "bf16":
        return tree_map(lambda g: g.to(torch.bfloat16), grads), error
    if method == "int8":
        if error is None:
            error = init_error_feedback(grads, "int8")

        def one(g, e):
            target = g.to(torch.float32) + e
            deq = _dq_int8(*_q_int8(target))
            return deq.to(g.dtype), target - deq

        pairs = tree_map(one, grads, error)
        return _split(pairs, 0), _split(pairs, 1)
    raise KeyError(method)


def _split(pairs: Any, i: int) -> Any:
    """Item ``i`` of every (wire, residual) pair of a tree of pairs."""
    if isinstance(pairs, dict):
        return {k: _split(v, i) for k, v in pairs.items()}
    if isinstance(pairs, list):
        return [_split(v, i) for v in pairs]
    return pairs[i]


def init_error_feedback(grads: Any, method: str) -> Optional[Any]:
    """Zero fp32 residuals beside every gradient for ``int8``, else None."""
    if method != "int8":
        return None
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)
