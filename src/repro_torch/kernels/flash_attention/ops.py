"""Public wrappers of flash attention: CUDA kernel or plain version by device,
the whole-sequence op with its gradient."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import cost
from repro_torch.kernels.dispatch import dispatch
from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_bwd_kernel, flash_attention_kernel)
from repro_torch.kernels.flash_attention.ref import (mha_bwd_ref, mha_lse_ref,
                                                     mha_pos_ref, mha_ref)
from repro_torch.kernels.kv_quant.ref import KVScales


class _FlashAttn(torch.autograd.Function):
    """``flash_attn`` with its gradient: the forward also keeps each row's
    log-sum-exp (the kernel writes it when given the buffer), and the
    backward is ``flash_attention_bwd_kernel`` on a CUDA tensor,
    ``mha_bwd_ref`` on a CPU tensor."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        ctx.kw = dict(causal=causal, window=window, scale=scale)

        def kernel():
            lse = torch.empty(q.shape[:3], dtype=torch.float32,
                              device=q.device)
            return flash_attention_kernel(q, k, v, lse=lse, **ctx.kw), lse

        out, lse = dispatch(
            q, kernel, lambda: mha_lse_ref(q, k, v, **ctx.kw),
            lambda: cost.flash(q, k, v, causal=causal, window=window,
                               lse=True))
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = dispatch(
            q,
            lambda: flash_attention_bwd_kernel(q, k, v, out, dout, lse,
                                               **ctx.kw),
            lambda: mha_bwd_ref(q, k, v, out, dout, lse, **ctx.kw),
            lambda: cost.flash_bwd(q, k, v, causal=ctx.kw["causal"],
                                   window=ctx.kw["window"]))
        return dq, dk, dv, None, None, None


def flash_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               causal: bool = True, window: int = 0,
               scale: Optional[float] = None) -> torch.Tensor:
    """Attention of a whole sequence at positions 0..S-1: (B, Hq, S, D);
    with ``causal=False`` and no window, Sq queries against any Sk keys (a
    cross-attention).

    On a CUDA tensor the hand-written kernel runs (or raises); on a CPU
    tensor ``mha_ref``.  When autograd records (grad enabled and an
    operand that requires it) the call goes through ``_FlashAttn``, whose
    gradient is the backward kernel on the card."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttn.apply(q, k, v, causal, window, scale)
    return dispatch(
        q,
        lambda: flash_attention_kernel(q, k, v, causal=causal, window=window,
                                       scale=scale),
        lambda: mha_ref(q, k, v, causal=causal, window=window, scale=scale),
        lambda: cost.flash(q, k, v, causal=causal, window=window))


def flash_attn_pos(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                   causal: bool = True, window: int = 0,
                   scale: Optional[float] = None,
                   kv_scales: KVScales = None) -> torch.Tensor:
    """Attention with positions per row, ``q_pos`` (B, Sq) against
    ``k_pos`` (B, Sk) (a chunk against the ring's tags): (B, Hq, Sq, D).
    An int8 ring takes its scales ``kv_scales`` = (k_scale, v_scale).
    Serving only: no gradient.

    On a CUDA tensor the hand-written kernel runs (or raises); on a CPU
    tensor ``mha_pos_ref``."""
    return dispatch(
        q,
        lambda: flash_attention_kernel(q, k, v, q_pos, k_pos, causal=causal,
                                       window=window, scale=scale,
                                       kv_scales=kv_scales),
        lambda: mha_pos_ref(q, k, v, q_pos, k_pos, causal=causal,
                            window=window, scale=scale, kv_scales=kv_scales),
        lambda: cost.flash(q, k, v, causal=causal, window=window,
                           positions=(q_pos, k_pos), kv_scales=kv_scales))
