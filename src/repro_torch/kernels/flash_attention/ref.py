"""Plain PyTorch oracles for blockwise (flash) attention: causal / GQA / SWA.

``mha_ref`` is the counterpart of ``src/repro/kernels/flash_attention/ref.py``
(positions ``arange(S)``, ``Sq == Sk``).  ``mha_pos_ref`` takes positions
per row, which is what a chunk of a prompt against the ring cache needs
(``transformer.chunk_prefill``); the Pallas signature is its special case.
They are what the CUDA kernel (``csrc/flash_attention.cu``) is held to on
the card and what ``ops.flash_attn``/``ops.flash_attn_pos`` run on CPU
tensors.
"""

from __future__ import annotations

from typing import Optional

import torch


def live_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
              window: int) -> torch.Tensor:
    """(B, Sq, Sk) bool: key j may be attended to by query i of row b.
    ``q_pos`` (B, Sq), ``k_pos`` (B, Sk) absolute positions; an unwritten
    ring slot's ``2**30`` tag masks itself out under ``causal``."""
    qp, kp = q_pos[:, :, None], k_pos[:, None, :]
    ok = torch.ones(qp.shape[:2] + kp.shape[2:], dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok = ok & (kp <= qp)
    if window:
        ok = ok & (kp > qp - window)
    return ok


def mha_pos_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                causal: bool = True, window: int = 0,
                scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Sk, D); q_pos (B, Sq), k_pos (B, Sk)
    -> (B, Hq, Sq, D) in ``q``'s type.  A key is attendable where
    ``k_pos <= q_pos`` (causal) and ``k_pos > q_pos - window`` (window > 0).
    fp32 logits, softmax and P.V; GQA by head-group folding; a query with no
    attendable key gives zeros."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    sc = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, hkv, g, sq, d).to(torch.float32)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg,
                          k.to(torch.float32)) * sc
    ok = live_mask(q_pos, k_pos, causal=causal, window=window)
    logits = logits.masked_fill(~ok[:, None, None], float("-inf"))
    p = torch.softmax(logits, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.to(torch.float32))
    return out.reshape(b, hq, sq, d).to(q.dtype)


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, window: int = 0,
            scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Hq, S, D); k/v: (B, Hkv, S, D) -> (B, Hq, S, D): fp32
    softmax, GQA via head-group folding, ``window`` > 0 applies
    sliding-window attention of that width; a fully masked row gives
    zeros."""
    b, s = q.shape[0], q.shape[2]
    pos = torch.arange(s, dtype=torch.int32, device=q.device)
    pos = pos[None, :].expand(b, s)
    return mha_pos_ref(q, k, v, pos, pos, causal=causal, window=window,
                       scale=scale)
