"""A kernel launch on meta tensors: its result's shapes and its work.

``dispatch``'s third route, for ``launch/hlo_analysis.count_step``: each
function returns the launch's result as empty meta tensors of the kernel's
shapes and types (nothing runs, not even the plain version) and its
entries (kernel name, FLOPs, bytes): the bytes each input read once and
each output written once, the FLOPs those of its products (2 m n k a
product), as ``chip_smoke.py``'s bounds count them.  Meta tensors carry
no data, so what depends on the data is counted at its most: decode
attention reads every ring slot (the dry run's rings are full), and
``flash_attn_pos`` every (query, key) pair.  Attention over positions
0..S-1 (``flash_attn``) counts its causal or windowed pairs exactly.
"""

from __future__ import annotations

from typing import Optional

import torch


def _empty(like: torch.Tensor, shape=None, dtype=None) -> torch.Tensor:
    return torch.empty(like.shape if shape is None else shape,
                       dtype=dtype or like.dtype, device=like.device)


def _nb(*ts: Optional[torch.Tensor]) -> float:
    return float(sum(t.numel() * t.element_size() for t in ts
                     if t is not None))


def matmul(x: torch.Tensor, y: torch.Tensor):
    """(M, K) @ (K, N): x and y read, the (M, N) output written in x's
    type."""
    m, k = x.shape
    n = y.shape[1]
    return _empty(x, (m, n)), [("elk_matmul", 2.0 * m * n * k,
                                _nb(x, y) + m * n * x.element_size())]


def matmul_bwd(x: torch.Tensor, y: torch.Tensor, dout: torch.Tensor,
               need_x: bool, need_y: bool):
    """dx = dout y^T and dy = x^T dout, each one launch of the kernel."""
    m, k = x.shape
    n = y.shape[1]
    out = []
    if need_x:
        out.append(("elk_matmul", 2.0 * m * n * k,
                    _nb(dout, y) + m * k * x.element_size()))
    if need_y:
        out.append(("elk_matmul", 2.0 * m * n * k,
                    _nb(x, dout) + k * n * y.element_size()))
    return ((_empty(x) if need_x else None, _empty(y) if need_y else None),
            out)


def fused_mlp(x, w_up, w_down, w_gate=None, b_up=None, b_down=None):
    """up (and gate), activation, down: the operands read once, the output
    written once; the products of ``chip_smoke.mlp_bound_ms``."""
    d, ff = w_up.shape
    dout = w_down.shape[1]
    m = x.numel() // d
    ups = 2 if w_gate is not None else 1
    return _empty(x, (*x.shape[:-1], dout)), [
        ("fused_mlp", 2.0 * m * ff * (d * ups + dout),
         _nb(x, w_up, w_down, w_gate, b_up, b_down)
         + m * dout * x.element_size())]


def fused_mlp_bwd(x, w_up, w_down, dy, w_gate=None, b_up=None, b_down=None):
    """The MLP's gradient: x, the weights and dy read, dx and the weights'
    gradients written; the products of ``chip_smoke.mlp_bwd_bound_ms``
    (up and gate recomputed, dh, the weight gradients, dx)."""
    d, ff = w_up.shape
    dout = w_down.shape[1]
    m = x.numel() // d
    ups = 2 if w_gate is not None else 1
    weights = _nb(w_up, w_down, w_gate, b_up, b_down)
    grads = {name: None if t is None else _empty(t) for name, t in (
        ("x", x), ("w_up", w_up), ("w_down", w_down), ("w_gate", w_gate),
        ("b_up", b_up), ("b_down", b_down))}
    return grads, [("fused_mlp_bwd", 2.0 * m * ff * (3 * d * ups + 2 * dout),
                    _nb(x, dy) + weights + _nb(x) + weights)]


def _scales_nb(kv_scales) -> float:
    return _nb(*kv_scales) if kv_scales is not None else 0.0


def decode_attn(q, k_cache, v_cache, slot_pos, kv_scales=None):
    """One query a row against the whole ring: q read and the output
    written, K and V (an int8 ring's with its scales) and the tags read;
    two products over every slot."""
    b, hq, d = q.shape
    c = k_cache.shape[2]
    return _empty(q), [("decode_attention", 4.0 * b * hq * c * d,
                        2 * _nb(q) + _nb(k_cache, v_cache, slot_pos)
                        + _scales_nb(kv_scales))]


def _pairs(sq: int, sk: int, causal: bool, window: int) -> float:
    """(query, key) pairs the mask lets through at positions 0..S-1 (a
    cross-attention's Sq != Sk is bidirectional: all of them)."""
    if not causal:
        return float(sq * sk)
    if window <= 0 or window >= sq:
        return sq * (sq + 1) / 2.0
    return window * (window + 1) / 2.0 + (sq - window) * float(window)


def flash(q, k, v, *, causal: bool, window: int, lse: bool = False,
          positions: tuple = (), kv_scales=None):
    """A whole sequence's attention (``positions`` empty: 0..S-1, its
    pairs exact) or a chunk against a ring (``positions`` = (q_pos,
    k_pos): every pair); ``lse``: the row log-sum-exp (fp32 (B, Hq, Sq))
    returned and written too."""
    b, hq, sq, d = q.shape
    sk = k.shape[2]
    pairs = (float(sq * sk) if positions
             else _pairs(sq, sk, causal, window))
    extra = b * hq * sq * 4.0 if lse else 0.0
    out = _empty(q)
    if lse:
        out = (out, _empty(q, (b, hq, sq), torch.float32))
    return out, [("flash_attention", 4.0 * b * hq * pairs * d,
                  2 * _nb(q) + _nb(k, v, *positions) + _scales_nb(kv_scales)
                  + extra)]


def flash_bwd(q, k, v, *, causal: bool, window: int):
    """``chip_smoke.flash_bwd_bound_ms``: q, out, dout, k, v and the fp32
    lse read, dq, dk, dv written; five products over the pairs."""
    b, hq, sq, d = q.shape
    pairs = _pairs(sq, k.shape[2], causal, window)
    return (_empty(q), _empty(k), _empty(v)), [
        ("flash_attention_bwd", 5 * 2.0 * b * hq * pairs * d,
         3 * _nb(q) + _nb(k, v) + b * hq * sq * 4.0 + _nb(q, k, v))]


def kv_quant(k_new, v_new, k_scale, sin=None):
    """The new K and V rows read; their int8 rows and scales written (in
    place: no result); with K's rope, its tables read and three operations
    an element of K (two products, a sum)."""
    rows = k_new.numel() // k_new.shape[-1]          # (B, Hkv, T) rows
    flops, nbytes = 0.0, _nb(k_new, v_new) + 2.0 * (
        k_new.numel() + rows * k_scale.element_size())
    if sin is not None:
        flops = 3.0 * k_new.numel()
        nbytes += 2.0 * sin.numel() * sin.element_size()
    return None, [("kv_quant", flops, nbytes)]
