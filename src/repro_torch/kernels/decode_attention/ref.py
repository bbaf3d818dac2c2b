"""Plain PyTorch oracle for single-token decode attention over a ring cache.

Counterpart of ``src/repro/kernels/decode_attention/ref.py``.  It is what
the CUDA kernel (``csrc/decode_attention.cu``) is held to on the card and
what ``ops.decode_attn`` runs on CPU tensors; the model's own CPU path
keeps ``layers.gqa_attention`` as the reference model does.

Beyond the reference's signature it takes the per-row form that the
slot-batched decode step needs: ``slot_pos`` (B, C) and ``q_pos`` (B,),
one ring and one position per request; and the int8 ring, ``kv_scales``
(the reference's ``kq_scales``), dequantized to bf16 as the reference does
before it attends.  ``decode_attention_split_ref`` is
the plain version of how the kernel cuts the work (the cache split over a
cluster, slots over warps, the carries merged in order); the CPU tests hold
it to the oracle.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.kernels.flash_attention.ref import carry, merge_carries
from repro_torch.kernels.kv_quant.ref import KVScales, dequantized


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
                         scale: Optional[float] = None,
                         kv_scales: KVScales = None) -> torch.Tensor:
    """q: (B, Hq, D); caches: (B, Hkv, C, D); slot_pos: (C,) or (B, C)
    absolute position per slot (sentinel > q_pos for unwritten slots);
    q_pos: scalar or (B,); an int8 ring takes its scales ``kv_scales``.
    fp32 logits and P.V; a row with no attendable slot gives zeros.
    Returns (B, Hq, D) in ``q``'s dtype."""
    k_cache, v_cache = dequantized(k_cache, v_cache, kv_scales)
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


def decode_attention_split_ref(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, slot_pos: torch.Tensor,
                               q_pos: Union[int, torch.Tensor], *,
                               splits: int, route: str = "mma", bk: int = 64,
                               window: int = 0,
                               scale: Optional[float] = None,
                               kv_scales: KVScales = None) -> torch.Tensor:
    """What the CUDA kernel computes, in plain PyTorch (fp32 on the CPU):
    for each (b, kv head) the tiles of ``bk`` slots that hold a live slot,
    cut into ``splits`` ranges of ceil(n / splits) tiles (a range may be
    empty); inside a split, the carries of the warps: route "mma" eight
    warps in two groups of four that take alternate tiles, 16 slots each;
    route "fma" eight warps that take bk / 8 slots of every tile.  The
    warps' (m, l, acc) merged in warp order, then the splits' in rank
    order, l floored at 1e-30.  Same arguments and result as
    ``decode_attention_ref``."""
    k_cache, v_cache = dequantized(k_cache, v_cache, kv_scales)
    b, hq, d = q.shape
    hkv, c = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    sc = scale if scale is not None else d ** -0.5
    ok = live_mask(slot_pos, q_pos, b, window)                 # (B, C)
    qf, kf, vf = q.float(), k_cache.float(), v_cache.float()
    out = torch.zeros(b, hq, d)
    tiles_total = -(-c // bk)
    for bi in range(b):
        tiles = [t for t in range(tiles_total)
                 if bool(ok[bi, t * bk:(t + 1) * bk].any())]
        per = -(-len(tiles) // splits)
        for h in range(hkv):
            qr = qf[bi, h * g:(h + 1) * g]                      # (G, D)
            splits_carries = []
            for s in range(splits):
                mine = tiles[s * per:(s + 1) * per]
                warps = []
                for w in range(8):
                    if route == "mma":
                        slots = [i * bk + (w % 4) * 16 + j
                                 for n, i in enumerate(mine) if n % 2 == w // 4
                                 for j in range(16)]
                    else:
                        spw = bk // 8
                        slots = [i * bk + w * spw + j for i in mine
                                 for j in range(spw)]
                    slots = torch.tensor([x for x in slots if x < c],
                                         dtype=torch.long)
                    logits = qr @ kf[bi, h, slots].T * sc       # (G, n)
                    logits = logits.masked_fill(~ok[bi, slots][None],
                                                float("-inf"))
                    warps.append(carry(logits, vf[bi, h, slots]))
                splits_carries.append(merge_carries(warps))
            _, l, acc = merge_carries(splits_carries)
            out[bi, h * g:(h + 1) * g] = acc / l.clamp_min(1e-30)[:, None]
    return out.to(q.dtype)
