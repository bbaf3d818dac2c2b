"""Plain PyTorch oracle for the ELK-blocked matmul.

Counterpart of ``src/repro/kernels/elk_matmul/ref.py``.  The Hopper kernel
is ``csrc/elk_matmul.cu`` (wrapper ``kernel.py``, routed by ``ops.matmul``,
which ``models/layers.linear`` calls for every projection and the LM head);
this is its plain version, what ``ops.matmul`` runs on CPU tensors and
what ``chip_smoke.py`` holds the kernel to.  ``fused_mlp``'s
``composed_ref`` is built from it too.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.chip.h100 import SmemPlan, tile_origin, xt_schedule_of


def matmul_ref(x: torch.Tensor, y: torch.Tensor,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(M, K) @ (K, N) with fp32 accumulation (float64 for float64
    operands), output in ``x``'s dtype."""
    f = torch.float64 if x.dtype == torch.float64 else torch.float32
    out = torch.matmul(x.to(f), y.to(f))
    return out.to(out_dtype or x.dtype)


def matmul_split_ref(x: torch.Tensor, y: torch.Tensor, *, bk: int,
                     splits: int) -> torch.Tensor:
    """``matmul_ref`` summed as route "fma_splitk" sums it: K cut into
    tiles of ``bk``, the tiles into ``splits`` runs of the same count (the
    last shorter, none empty), each run's fp32 partial product taken on its
    own and the partials added in rank order; output in ``x``'s dtype.  The
    plain split-and-combine version of the kernel's split, for the CPU
    tests (``mha_pos_split_ref`` is attention's)."""
    f = torch.float64 if x.dtype == torch.float64 else torch.float32
    k = x.shape[1]
    k_tiles = -(-k // bk)
    per = -(-k_tiles // splits)
    out = None
    for s in range(-(-k_tiles // per)):
        lo, hi = s * per * bk, min(k, (s + 1) * per * bk)
        part = matmul_ref(x[:, lo:hi], y[lo:hi], f)
        out = part if out is None else out + part
    return out.to(x.dtype)


def matmul_xt_split_ref(x: torch.Tensor, y: torch.Tensor,
                        plan: SmemPlan) -> torch.Tensor:
    """``matmul_ref`` summed as route "wgmma_xt" sums it under ``plan``
    (``chip/h100.smem_plan(..., x_trans=True)``): every whole tile one fp32
    sum over K; each split tile (the ``plan.tail`` tiles after the whole
    ones, in the order of ``tile_origin``) cut by K into ``plan.splits``
    runs of ``plan.k_per_split`` tiles of ``plan.bk``, each run's fp32
    partial taken on its own and the partials added in rank order; output
    in ``x``'s dtype.  The plain split-and-combine version of the kernel's
    schedule, for the CPU tests."""
    f = torch.float64 if x.dtype == torch.float64 else torch.float32
    (m, k), n = x.shape, y.shape[1]
    out = matmul_ref(x, y, f)
    sched = xt_schedule_of(plan)
    m_tiles, n_tiles = -(-m // plan.bm), -(-n // plan.bn)
    span = sched.per * plan.bk
    for c in range(sched.tail):
        mt, nt = tile_origin(sched.full + c, m_tiles, n_tiles)
        rows = slice(mt * plan.bm, (mt + 1) * plan.bm)
        cols = slice(nt * plan.bn, (nt + 1) * plan.bn)
        acc = None
        for r in range(sched.splits):
            part = matmul_ref(x[rows, r * span:(r + 1) * span],
                              y[r * span:(r + 1) * span, cols], f)
            acc = part if acc is None else acc + part
        out[rows, cols] = acc
    return out.to(x.dtype)


def matmul2_ref(x: torch.Tensor, y: torch.Tensor, x2: torch.Tensor,
                y2: torch.Tensor) -> torch.Tensor:
    """x @ y + x2 @ y2 in one fp32 sum (the two products added in that
    order), output in ``x``'s dtype: the kernel's two-part product."""
    f = torch.float64 if x.dtype == torch.float64 else torch.float32
    return (matmul_ref(x, y, f) + matmul_ref(x2, y2, f)).to(x.dtype)


def matmul_bwd_ref(x: torch.Tensor, y: torch.Tensor, dout: torch.Tensor,
                   need_x: bool = True, need_y: bool = True
                   ) -> tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The gradients of ``out = x @ y`` for ``dout``: dx = dout @ y^T and
    dy = x^T @ dout, each ``matmul_ref`` of the transposed view (fp32 sum,
    in x's dtype); the one not needed is None."""
    dx = matmul_ref(dout, y.t()) if need_x else None
    dy = matmul_ref(x.t(), dout) if need_y else None
    return dx, dy
