"""Public wrapper of the int8 KV quantization: CUDA kernel or plain version
by device."""

from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.kernels import cost
from repro_torch.kernels.dispatch import dispatch
from repro_torch.kernels.kv_quant.kernel import kv_quant_kernel
from repro_torch.kernels.kv_quant.ref import quantize_into_ref


def quantize_into(k_new: torch.Tensor, v_new: torch.Tensor,
                  k_cache: torch.Tensor, v_cache: torch.Tensor,
                  k_scale: torch.Tensor, v_scale: torch.Tensor,
                  positions: Union[int, torch.Tensor],
                  sin: Optional[torch.Tensor] = None,
                  cos: Optional[torch.Tensor] = None) -> None:
    """Quantize a layer's new K and V rows (B, Hkv, T, D) into the int8 ring
    and its scales at slot ``position % C``, in place; with the rope tables
    ``sin``/``cos`` K is rotated first (``models.layers.apply_rope``).

    On a CUDA tensor the hand-written kernel runs (or raises); on a CPU
    tensor ``quantize_into_ref``."""
    args = (k_new, v_new, k_cache, v_cache, k_scale, v_scale, positions,
            sin, cos)
    dispatch(k_new, lambda: kv_quant_kernel(*args),
             lambda: quantize_into_ref(*args),
             lambda: cost.kv_quant(k_new, v_new, k_scale, sin))
