"""Plain PyTorch oracles for blockwise (flash) attention: causal / GQA / SWA.

``mha_ref`` is the counterpart of ``src/repro/kernels/flash_attention/ref.py``
(positions ``arange(S)``, ``Sq == Sk``).  ``mha_pos_ref`` takes positions
per row, which is what a chunk of a prompt against the ring cache needs
(``transformer.chunk_prefill``); the Pallas signature is its special case.
They are what the CUDA kernel (``csrc/flash_attention.cu``) is held to on
the card and what ``ops.flash_attn``/``ops.flash_attn_pos`` run on CPU
tensors.  ``mha_pos_split_ref`` is the plain version of how the kernel's
"wgmma" route cuts the work (GQA rows packed, the KV loop split over a
cluster and merged in rank order, ``live_tiles``, ``carry``,
``merge_carries``); the CPU tests hold it to the oracles.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.kv_quant.ref import KVScales, dequantized


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type the plain versions sum in: fp32, or float64 for float64
    operands (``torch.autograd.gradcheck``)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


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


# the bytes of fp32 scores one call of ``mha_pos_ref`` holds at once; past
# them it takes the batch rows one at a time (h2o-danube-1.8b's prefill of
# 8 x 4608 positions at 32 heads would hold 21.7 GB of them, and as much
# again for each of the mask, the softmax and its copy)
SCORE_BYTES_AT_ONCE = 2 ** 31


def mha_pos_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                causal: bool = True, window: int = 0,
                scale: Optional[float] = None,
                kv_scales: KVScales = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Sk, D); q_pos (B, Sq), k_pos (B, Sk)
    -> (B, Hq, Sq, D) in ``q``'s type.  A key is attendable where
    ``k_pos <= q_pos`` (causal) and ``k_pos > q_pos - window`` (window > 0).
    An int8 ring takes its scales ``kv_scales`` and is dequantized to bf16
    first, as the reference does.  fp32 logits, softmax and P.V; GQA by
    head-group folding; a query with no attendable key gives zeros.  Scores
    of more than SCORE_BYTES_AT_ONCE are taken one batch row at a time."""
    k, v = dequantized(k, v, kv_scales)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if b > 1 and b * hq * sq * sk * 4 > SCORE_BYTES_AT_ONCE:
        return torch.cat([mha_pos_ref(
            q[i:i + 1], k[i:i + 1], v[i:i + 1], q_pos[i:i + 1],
            k_pos[i:i + 1], causal=causal, window=window, scale=scale)
            for i in range(b)])
    g = hq // hkv
    sc = scale if scale is not None else d ** -0.5
    f = acc_dtype(q.dtype)
    qg = q.reshape(b, hkv, g, sq, d).to(f)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.to(f)) * sc
    ok = live_mask(q_pos, k_pos, causal=causal, window=window)
    logits = logits.masked_fill(~ok[:, None, None], float("-inf"))
    p = torch.softmax(logits, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.to(f))
    return out.reshape(b, hq, sq, d).to(q.dtype)


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, window: int = 0,
            scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Sk, D) -> (B, Hq, Sq, D): fp32
    softmax, GQA via head-group folding, ``window`` > 0 applies
    sliding-window attention of that width; a fully masked row gives
    zeros.  Positions 0..Sq-1 and 0..Sk-1; Sq != Sk only bidirectional and
    with no window (a cross-attention), where positions mask nothing."""
    b, sq, sk = q.shape[0], q.shape[2], k.shape[2]
    if sq != sk and (causal or window):
        raise ValueError(f"Sq {sq} != Sk {sk} takes causal=False and no "
                         "window")
    q_pos = torch.arange(sq, dtype=torch.int32, device=q.device)
    k_pos = torch.arange(sk, dtype=torch.int32, device=q.device)
    return mha_pos_ref(q, k, v, q_pos[None].expand(b, sq),
                       k_pos[None].expand(b, sk), causal=causal,
                       window=window, scale=scale)


def live_tiles(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
               window: int, bk: int) -> list[int]:
    """The KV tiles (of ``bk`` keys) a block of queries at positions
    ``q_pos`` (R,) reads against keys at ``k_pos`` (Sk,): those holding a
    key live for some position between the least and the greatest of
    ``q_pos``, as the kernel lists them."""
    qmin, qmax = int(q_pos.min()), int(q_pos.max())
    ok = torch.ones_like(k_pos, dtype=torch.bool)
    if causal:
        ok &= k_pos <= qmax
    if window:
        ok &= k_pos > qmin - window
    tiles = -(-k_pos.shape[0] // bk)
    return [t for t in range(tiles) if bool(ok[t * bk:(t + 1) * bk].any())]


def merge_carries(carries: list) -> tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """One (m, l, acc) of partial softmax carries, merged in list order:
    weights exp(m_i - M) (0 where m_i is -inf), l and acc their weighted
    sums.  m (R,), l (R,), acc (R, D)."""
    m = torch.stack([c[0] for c in carries])                  # (n, R)
    big = m.max(dim=0).values
    w = torch.where(torch.isinf(m) & (m < 0), torch.zeros_like(m),
                    torch.exp(m - torch.where(torch.isinf(big), 0.0, big)))
    l = sum(w[i] * c[1] for i, c in enumerate(carries))
    acc = sum(w[i][:, None] * c[2] for i, c in enumerate(carries))
    return big, l, acc


def carry(s: torch.Tensor, v: torch.Tensor) -> tuple:
    """(m, l, acc) of masked scores ``s`` (R, n; -inf where masked)
    against values ``v`` (n, D); no key at all, or none live: (-inf, 0,
    0)."""
    if s.shape[1] == 0:
        r = s.shape[0]
        return (torch.full((r,), float("-inf")), torch.zeros(r),
                torch.zeros(r, v.shape[1]))
    m = s.max(dim=1).values
    p = torch.exp(s - torch.where(torch.isinf(m), 0.0, m)[:, None])
    p = torch.where(torch.isinf(s), torch.zeros_like(p), p)
    return m, p.sum(dim=1), p @ v


def mha_pos_split_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                      splits: int, rows: int = 64, bk: int = 64,
                      causal: bool = True, window: int = 0,
                      scale: Optional[float] = None,
                      kv_scales: KVScales = None) -> torch.Tensor:
    """What route "wgmma" of the CUDA kernel computes, in plain PyTorch (fp32
    on the CPU): rows (query position t, head g of a kv head's group) in
    tiles of ``rows``, row = t G + g; for each (b, kv head, row tile) the
    tiles of ``bk`` keys that ``live_tiles`` lists, cut into ``splits``
    ranges of ceil(n / splits) tiles (a range may be empty); each split's
    (m, l, acc) over its keys, masked per query; the splits merged in rank
    order, l floored at 1e-30.  Same arguments and result as
    ``mha_pos_ref``."""
    k, v = dequantized(k, v, kv_scales)
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    sc = scale if scale is not None else d ** -0.5
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.zeros(b, hq, sq, d)
    for bi in range(b):
        kp = k_pos[min(bi, k_pos.shape[0] - 1)]
        for h in range(hkv):
            for r0 in range(0, sq * g, rows):
                r = torch.arange(r0, min(r0 + rows, sq * g))
                t, gg = r // g, r % g
                qp = q_pos[min(bi, q_pos.shape[0] - 1)][t]
                ok = live_mask(qp[None], kp[None], causal=causal,
                               window=window)[0]               # (R, Sk)
                tiles = live_tiles(qp, kp, causal=causal, window=window,
                                   bk=bk)
                per = -(-len(tiles) // splits)
                carries = []
                for s in range(splits):
                    keys = [j for i in tiles[s * per:(s + 1) * per]
                            for j in range(i * bk, min((i + 1) * bk,
                                                       kp.shape[0]))]
                    keys = torch.tensor(keys, dtype=torch.long)
                    logits = qf[bi, h * g + gg, t] @ kf[bi, h, keys].T * sc
                    logits = logits.masked_fill(~ok[:, keys], float("-inf"))
                    carries.append(carry(logits, vf[bi, h, keys]))
                _, l, acc = merge_carries(carries)
                out[bi, h * g + gg, t] = acc / l.clamp_min(1e-30)[:, None]
    return out.to(q.dtype)


def _positions_mask(q: torch.Tensor, sk: int, causal: bool, window: int
                    ) -> torch.Tensor:
    """(Sq, Sk) bool: key j live for query i at positions 0..S-1."""
    sq = q.shape[2]
    if sq != sk and (causal or window):
        raise ValueError(f"Sq {sq} != Sk {sk} takes causal=False and no "
                         "window")
    qp = torch.arange(sq, device=q.device)[None]
    kp = torch.arange(sk, device=q.device)[None]
    return live_mask(qp, kp, causal=causal, window=window)[0]


def mha_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool = True, window: int = 0,
                scale: Optional[float] = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """``mha_ref`` and each row's log-sum-exp of the scaled, masked scores
    (fp32 (B, Hq, Sq); +inf for a row with no live key): what the forward
    kernel returns when asked for ``lse``."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    sc = scale if scale is not None else d ** -0.5
    f = acc_dtype(q.dtype)
    qg = q.reshape(b, hkv, hq // hkv, sq, d).to(f)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.to(f)) * sc
    ok = _positions_mask(q, sk, causal, window)
    logits = logits.masked_fill(~ok, float("-inf"))
    lse = torch.logsumexp(logits, dim=-1)
    lse = torch.where(torch.isneginf(lse), torch.full_like(lse, float("inf")),
                      lse)
    return (mha_ref(q, k, v, causal=causal, window=window, scale=scale),
            lse.reshape(b, hq, sq))


def mha_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor, *,
                causal: bool = True, window: int = 0,
                scale: Optional[float] = None
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``mha_ref`` for ``dout``, step by step as the
    backward kernel takes them, in fp32: delta = rowsum(dout * out), P =
    exp(scale q k^T - lse) (0 where a key is not live, and on a row with no
    live key, whose lse is +inf), dv = P^T dout, dP = dout v^T, dS = P (dP -
    delta), dq = scale dS k, dk = scale dS^T q; a kv head's dk and dv sum
    the G query heads of its group.  Each in its operand's type."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    sc = scale if scale is not None else d ** -0.5
    f32 = acc_dtype(q.dtype)
    qf = q.reshape(b, hkv, g, sq, d).to(f32)
    of = out.reshape(b, hkv, g, sq, d).to(f32)
    dof = dout.reshape(b, hkv, g, sq, d).to(f32)
    kf, vf = k.to(f32), v.to(f32)
    delta = (dof * of).sum(-1)                                # (b,hkv,g,sq)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf) * sc
    ok = _positions_mask(q, sk, causal, window)
    p = torch.exp(s - lse.reshape(b, hkv, g, sq, 1).to(f32))
    p = torch.where(ok, p, torch.zeros_like(p))
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dof)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dof, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf) * sc
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qf) * sc
    return (dq.reshape(b, hq, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
