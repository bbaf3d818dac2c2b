"""Plain PyTorch version of the int8 KV cache's quantization.

``quantize_kv`` and ``dequantize_kv`` are the reference's ``_quantize_kv``
and ``_dequantize_kv`` (``src/repro/models/transformer.py``): one bf16
scale per (row, head, slot), the amax of the row's D elements over 127, the
elements divided by the fp32 scale, rounded half to even and clipped to
+-127; the scale is stored rounded to bf16, and dequantization rounds each
element to bf16.  The model, the attention kernels' plain versions and the
CPU tests all use them.  ``quantize_into_ref`` adds the scatter into the
ring's slots, in place (with K's rope first where the serving paths give
the tables: ``models.layers.apply_rope``), and is what the CUDA kernel
``csrc/kv_quant.cu`` is held to bit for bit on the card and what
``ops.quantize_into`` runs on CPU tensors.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.models.layers import apply_rope

# an int8 ring's scales (k_scale, v_scale), each (B, Hkv, C, 1) bf16; None
# for a ring of another type
KVScales = Optional[tuple[torch.Tensor, torch.Tensor]]


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (..., D) -> (int8 (..., D), bf16 scale (..., 1))."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor: on the card PyTorch multiplies by the reciprocal of
    # a Python number, which is not the division the reference rounds
    scale = amax.clamp_min(1e-6) / torch.full_like(amax, 127.0)
    q = torch.round(xf / scale).clamp(-127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 (..., D) and bf16 scale (..., 1) -> bf16 (..., D)."""
    return (q.to(torch.float32) * scale.to(torch.float32)).to(torch.bfloat16)


def dequantized(k_cache: torch.Tensor, v_cache: torch.Tensor,
                kv_scales: KVScales) -> tuple[torch.Tensor, torch.Tensor]:
    """The ring as attention reads it: an int8 ring with its ``kv_scales``
    dequantized to bf16, as the reference does before it attends; any other
    ring as it is."""
    if kv_scales is None:
        return k_cache, v_cache
    return (dequantize_kv(k_cache, kv_scales[0]),
            dequantize_kv(v_cache, kv_scales[1]))


def quantize_into_ref(k_new: torch.Tensor, v_new: torch.Tensor,
                      k_cache: torch.Tensor, v_cache: torch.Tensor,
                      k_scale: torch.Tensor, v_scale: torch.Tensor,
                      positions: Union[int, torch.Tensor],
                      sin: Optional[torch.Tensor] = None,
                      cos: Optional[torch.Tensor] = None) -> None:
    """Quantize the new rows k_new, v_new (B, Hkv, T, D) and write them and
    their scales into the ring's slots, in place: caches (B, Hkv, C, D)
    int8, scales (B, Hkv, C, 1) bf16.  ``positions``: one int for every row
    (T = 1, the lock-step decode step) or (B, T); position p goes to slot
    p % C (T <= C keeps a row's slots distinct).  With ``sin``/``cos``,
    ``apply_rope(k_new, sin, cos)`` is what is quantized for K."""
    if sin is not None:
        k_new = apply_rope(k_new, sin, cos)
    c = k_cache.shape[2]
    for new, cache, scales in ((k_new, k_cache, k_scale),
                               (v_new, v_cache, v_scale)):
        q, s = quantize_kv(new)
        if isinstance(positions, int):
            slot = positions % c
            cache[:, :, slot:slot + 1, :] = q
            scales[:, :, slot:slot + 1, :] = s
        else:
            rows = torch.arange(new.shape[0], device=new.device)[:, None]
            slots = (positions % c).long()                     # (B, T)
            cache[rows, :, slots, :] = q.transpose(1, 2)
            scales[rows, :, slots, :] = s.transpose(1, 2)
