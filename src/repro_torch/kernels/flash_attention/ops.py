"""Public wrappers of flash attention: CUDA kernel or plain version by device."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.dispatch import dispatch
from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
from repro_torch.kernels.flash_attention.ref import mha_pos_ref, mha_ref
from repro_torch.kernels.kv_quant.ref import KVScales


def flash_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               causal: bool = True, window: int = 0,
               scale: Optional[float] = None) -> torch.Tensor:
    """Attention of a whole sequence at positions 0..S-1: (B, Hq, S, D);
    with ``causal=False`` and no window, Sq queries against any Sk keys (a
    cross-attention).

    On a CUDA tensor the hand-written kernel runs (or raises); on a CPU
    tensor ``mha_ref``."""
    return dispatch(
        q,
        lambda: flash_attention_kernel(q, k, v, causal=causal, window=window,
                                       scale=scale),
        lambda: mha_ref(q, k, v, causal=causal, window=window, scale=scale))


def flash_attn_pos(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                   causal: bool = True, window: int = 0,
                   scale: Optional[float] = None,
                   kv_scales: KVScales = None) -> torch.Tensor:
    """Attention with positions per row, ``q_pos`` (B, Sq) against
    ``k_pos`` (B, Sk) (a chunk against the ring's tags): (B, Hq, Sq, D).
    An int8 ring takes its scales ``kv_scales`` = (k_scale, v_scale).

    On a CUDA tensor the hand-written kernel runs (or raises); on a CPU
    tensor ``mha_pos_ref``."""
    return dispatch(
        q,
        lambda: flash_attention_kernel(q, k, v, q_pos, k_pos, causal=causal,
                                       window=window, scale=scale,
                                       kv_scales=kv_scales),
        lambda: mha_pos_ref(q, k, v, q_pos, k_pos, causal=causal,
                            window=window, scale=scale, kv_scales=kv_scales))
