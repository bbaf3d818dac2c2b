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

from repro_torch.kernels.elk_matmul.ref import matmul2_ref, matmul_ref

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


def act_grad_fn(name: str):
    """d act / d v of ``act_fn(name)``, in the form the backward kernel
    computes it."""
    if name == "silu":
        def silu_grad(v):
            s = torch.sigmoid(v)
            return s * (1.0 + v * (1.0 - s))
        return silu_grad
    if name == "gelu":
        def gelu_grad(v):
            c = 0.7978845608028654   # sqrt(2 / pi)
            t = torch.tanh(c * (v + 0.044715 * v * v * v))
            return (0.5 * (1.0 + t)
                    + 0.5 * v * (1.0 - t * t) * c * (1.0 + 3 * 0.044715 * v * v))
        return gelu_grad
    if name == "relu":
        return lambda v: (v > 0).to(v.dtype)
    raise ValueError(f"unknown activation {name!r}; known: {ACTS}")


def fused_mlp_bwd_ref(x: torch.Tensor, w_up: torch.Tensor,
                      w_down: torch.Tensor, dy: torch.Tensor, *,
                      w_gate: Optional[torch.Tensor] = None,
                      b_up: Optional[torch.Tensor] = None,
                      b_down: Optional[torch.Tensor] = None,
                      act: str = "silu") -> dict:
    """The gradients of ``fused_mlp`` for ``dy``, step by step as the
    backward kernel takes them: the pre-activations g = x w_gate, u = x
    w_up [+ b_up] in fp32; dh = dy w_down^T in fp32 and, from it, dg = dh u
    act'(g), du = dh act(g) (GLU) or du = dh act'(u), and h = act(g) u or
    act(u), each rounded to x's type once (h as the forward rounds it
    before its down product); then dw_down = h^T dy, dw_gate = x^T dg,
    dw_up = x^T du, dx = dg w_gate^T + du w_up^T in one fp32 sum, and the
    bias gradients as column sums in fp32.  Returns the gradients by the
    names of what they are the gradient of (``x``, ``w_up``, ``w_down``,
    ``w_gate``, ``b_up``, ``b_down``; None for an operand not given)."""
    a, da = act_fn(act), act_grad_fn(act)
    dt = x.dtype
    f32 = torch.float64 if dt == torch.float64 else torch.float32
    d, dout = x.shape[-1], w_down.shape[-1]
    x2 = x.reshape(-1, d)
    dy2 = dy.reshape(-1, dout).to(dt)
    dh = matmul_ref(dy2, w_down.t(), f32)
    out = dict.fromkeys(("x", "w_up", "w_down", "w_gate", "b_up", "b_down"))
    if w_gate is not None:
        g = matmul_ref(x2, w_gate, f32)
        u = matmul_ref(x2, w_up, f32)
        ag = a(g)
        dg = (dh * u * da(g)).to(dt)
        du = (dh * ag).to(dt)
        h = (ag * u).to(dt)
        out["w_gate"] = matmul_ref(x2.t(), dg)
        out["x"] = matmul2_ref(dg, w_gate.t(), du, w_up.t())
    else:
        u = matmul_ref(x2, w_up, f32)
        if b_up is not None:
            u = u + b_up.to(f32)
        du = (dh * da(u)).to(dt)
        h = a(u).to(dt)
        out["x"] = matmul_ref(du, w_up.t())
    out["x"] = out["x"].reshape(x.shape)
    out["w_up"] = matmul_ref(x2.t(), du)
    out["w_down"] = matmul_ref(h.t(), dy2)
    if b_up is not None:
        out["b_up"] = du.to(f32).sum(0).to(dt)
        out["b_down"] = dy2.to(f32).sum(0).to(dt)
    return out
