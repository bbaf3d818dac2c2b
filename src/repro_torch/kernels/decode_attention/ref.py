"""Plain PyTorch oracle for single-token decode attention over a ring cache.

Counterpart of ``src/repro/kernels/decode_attention/ref.py``.  It is what
the CUDA kernel (``csrc/decode_attention.cu``) is held to on the card and
what ``ops.decode_attn`` runs on CPU tensors; the model's own CPU path
keeps ``layers.gqa_attention`` as the reference model does.

Beyond the reference's signature it takes the per-row form that the
slot-batched decode step needs: ``slot_pos`` (B, C) and ``q_pos`` (B,),
one ring and one position per request.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def live_mask(slot_pos: torch.Tensor, q_pos: Union[int, torch.Tensor],
              batch: int, window: int = 0) -> torch.Tensor:
    """(B, C) bool: slot ``c`` of row ``b`` may be attended to.  ``slot_pos``
    is (C,) or (B, C); ``q_pos`` a scalar or (B,)."""
    sp = slot_pos if slot_pos.dim() == 2 else slot_pos[None, :]
    if isinstance(q_pos, torch.Tensor) and q_pos.dim() == 1:
        qp = q_pos[:, None]
    else:
        qp = q_pos
    ok = sp <= qp
    if window:
        ok = ok & (sp > qp - window)
    return ok.expand(batch, sp.shape[-1])


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, slot_pos: torch.Tensor,
                         q_pos: Union[int, torch.Tensor], *, window: int = 0,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Hq, D); caches: (B, Hkv, C, D); slot_pos: (C,) or (B, C)
    absolute position per slot (sentinel > q_pos for unwritten slots);
    q_pos: scalar or (B,).  fp32 logits and P.V; a row with no attendable
    slot gives zeros.  Returns (B, Hq, D) in ``q``'s dtype."""
    b, hq, d = q.shape
    hkv, c = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    sc = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, hkv, g, d).to(torch.float32)
    logits = torch.einsum("bhgd,bhkd->bhgk", qg,
                          k_cache.to(torch.float32)) * sc
    ok = live_mask(slot_pos, q_pos, b, window)
    logits = logits.masked_fill(~ok[:, None, None, :], float("-inf"))
    p = torch.softmax(logits, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)
    out = torch.einsum("bhgk,bhkd->bhgd", p, v_cache.to(torch.float32))
    return out.reshape(b, hq, d).to(q.dtype)
