"""Plain PyTorch versions of the fused MLP.

Counterpart of ``src/repro/kernels/fused_mlp/ref.py``.  ``fused_mlp_ref``
is the einsum composition the model runs on CPU tensors; ``composed_ref``
(matmul_ref + activation + matmul_ref, fp32 accumulation per product) is
what the CUDA kernel is held to; ``two_pass_ref`` is the function of the
kernel's two-pass route written out (h formed in fp32 and rounded to x's
type once, then the down product).  Nothing on the serving path calls any
of them when the tensors are on the card.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.elk_matmul.ref import matmul_ref

ACTS = ("silu", "gelu", "relu")


def act_fn(name: str):
    """silu / tanh-form gelu / relu, as the reference's ``_ACT``."""
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda t: F.gelu(t, approximate="tanh")
    if name == "relu":
        return F.relu
    raise ValueError(f"unknown activation {name!r}; known: {ACTS}")


def fused_mlp_ref(x: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
                  *, w_gate: Optional[torch.Tensor] = None,
                  b_up: Optional[torch.Tensor] = None,
                  b_down: Optional[torch.Tensor] = None,
                  act: str = "silu") -> torch.Tensor:
    a = act_fn(act)
    if w_gate is not None:
        gate = torch.matmul(x, w_gate)
        up = torch.matmul(x, w_up)
        return torch.matmul(a(gate) * up, w_down)
    h = torch.matmul(x, w_up)
    if b_up is not None:
        h = h + b_up.to(h.dtype)
    h = a(h)
    out = torch.matmul(h, w_down)
    if b_down is not None:
        out = out + b_down.to(out.dtype)
    return out


def composed_ref(x: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
                 *, w_gate: Optional[torch.Tensor] = None,
                 b_up: Optional[torch.Tensor] = None,
                 b_down: Optional[torch.Tensor] = None,
                 act: str = "silu") -> torch.Tensor:
    """matmul_ref + activation + matmul_ref: the kernel's parity oracle."""
    a = act_fn(act)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if w_gate is not None:
        h = a(matmul_ref(x2, w_gate)) * matmul_ref(x2, w_up)
    else:
        h = matmul_ref(x2, w_up)
        if b_up is not None:
            h = h + b_up.to(h.dtype)
        h = a(h)
    out = matmul_ref(h.to(x.dtype), w_down)
    if b_down is not None:
        out = out + b_down.to(out.dtype)
    return out.reshape(*lead, w_down.shape[-1])


def two_pass_ref(x: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
                 *, w_gate: Optional[torch.Tensor] = None,
                 b_up: Optional[torch.Tensor] = None,
                 b_down: Optional[torch.Tensor] = None,
                 act: str = "silu") -> torch.Tensor:
    """The two-pass route in plain PyTorch.  Pass 1: h = act(x @ w_gate) *
    (x @ w_up), or act(x @ w_up + b_up), from fp32 products, rounded to x's
    type once (where ``composed_ref`` rounds it before the down product);
    pass 2: h @ w_down [+ b_down], fp32 sum, rounded once.  In fp32 it is
    ``composed_ref`` bit for bit."""
    a = act_fn(act)
    f32 = torch.float32
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if w_gate is not None:
        h = a(matmul_ref(x2, w_gate, f32)) * matmul_ref(x2, w_up, f32)
    else:
        h = matmul_ref(x2, w_up, f32)
        if b_up is not None:
            h = h + b_up.to(f32)
        h = a(h)
    out = matmul_ref(h.to(x.dtype), w_down, f32)
    if b_down is not None:
        out = out + b_down.to(f32)
    return out.to(x.dtype).reshape(*lead, w_down.shape[-1])
