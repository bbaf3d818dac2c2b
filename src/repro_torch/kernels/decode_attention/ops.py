"""Public wrapper of decode attention: CUDA kernel or plain version by device."""

from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.kernels.decode_attention.kernel import decode_attention_kernel
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels import cost
from repro_torch.kernels.dispatch import dispatch
from repro_torch.kernels.kv_quant.ref import KVScales


def decode_attn(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                slot_pos: torch.Tensor, q_pos: Union[int, torch.Tensor], *,
                window: int = 0, scale: Optional[float] = None,
                kv_scales: KVScales = None) -> torch.Tensor:
    """One query token a row against its ring KV cache: (B, Hq, D).  An
    int8 ring takes its scales ``kv_scales`` = (k_scale, v_scale), the
    reference's ``kq_scales``.

    On a CUDA tensor the hand-written kernel runs (or raises); on a CPU
    tensor ``decode_attention_ref``."""
    return dispatch(
        q,
        lambda: decode_attention_kernel(q, k_cache, v_cache, slot_pos, q_pos,
                                        window=window, scale=scale,
                                        kv_scales=kv_scales),
        lambda: decode_attention_ref(q, k_cache, v_cache, slot_pos, q_pos,
                                     window=window, scale=scale,
                                     kv_scales=kv_scales),
        lambda: cost.decode_attn(q, k_cache, v_cache, slot_pos, kv_scales))
