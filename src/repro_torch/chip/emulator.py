"""Dataflow emulator: the numerical correctness of ELK partition plans.

Counterpart of ``src/repro/chip/emulator.py``.  The paper's emulator ran
plans on a physical IPU-POD4; here the timing role belongs to
``chip/simulator.py`` and the numerical role to this module: execute a
partition plan's tile dataflow with explicit per-core tiles and explicit
inter-core movement (the preloaded fraction of a shared tile, completed by
the distribution phase; the compute-shift rotation at execute), in fp32,
and hold the result to a plain product.

This checks the claims a plan makes: its dim splits cover the iteration
space exactly, the preload fraction and the distribution phase rebuild the
whole shared tile on every core, and the reduction over a split contraction
dim recombines to the true product.  The inputs come from an explicit
``torch.Generator``; the work runs on ``device``, the card unless the caller
names the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.partition import ExecPlan, PreloadPlan
from repro_torch.models.transformer import resolve_device


def _splits(dim: int, parts: int) -> list[slice]:
    step = -(-dim // parts)
    return [slice(i * step, min((i + 1) * step, dim)) for i in range(parts)]


def emulate_matmul_plan(x: torch.Tensor, w: torch.Tensor, plan: ExecPlan,
                        preload: Optional[PreloadPlan] = None
                        ) -> torch.Tensor:
    """(M, K) @ (K, N) under ``plan.split`` = (sm, sn, sk), a core grid.

    Core (i, j, l) computes X[i rows, l cols] @ W[l rows, j cols], in fp32;
    the partial results reduce over l.  Each core's copy of its W tile
    starts as the ``preload.frac`` slice of its rows (what the memory
    controllers broadcast) and is completed by the distribution phase (the
    peers' rows concatenated), then the product runs in ``plan.chunk``
    steps of rows (the compute-shift rotation), so a wrong fraction or
    chunking breaks the numbers, not only a cost.  Returns (M, N) in
    ``x``'s type."""
    m, k = x.shape
    k2, n = w.shape
    if k != k2:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} do not "
                         "chain")
    sm, sn, sk = (tuple(plan.split) + (1, 1, 1))[:3]
    frac = preload.frac if preload is not None else 1.0
    out = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    for mslc in _splits(m, sm):
        for nslc in _splits(n, sn):
            for kslc in _splits(k, sk):
                x_tile = x[mslc, kslc].to(torch.float32)
                w_full = w[kslc, nslc].to(torch.float32)
                rows = w_full.shape[0]
                # preload: the core holds a fraction of its tile's rows
                own = max(int(round(rows * frac)), 1)
                w_tile = w_full[:own]
                # distribution: the rest fetched from the peers
                if own < rows:
                    w_tile = torch.cat([w_tile, w_full[own:]], dim=0)
                # execute: the rotation in chunks of rows
                r = max(plan.chunk, 1)
                csz = -(-w_tile.shape[0] // r)
                acc = torch.zeros((x_tile.shape[0], w_tile.shape[1]),
                                  dtype=torch.float32, device=x.device)
                for c in range(r):
                    rs = slice(c * csz, min((c + 1) * csz, w_tile.shape[0]))
                    if rs.start >= w_tile.shape[0]:
                        break
                    acc = acc + x_tile[:, rs] @ w_tile[rs]
                out[mslc, nslc] += acc
    return out.to(x.dtype)


def check_plan_numerics(plan: ExecPlan, preload: Optional[PreloadPlan] = None,
                        m: int = 64, n: int = 48, k: int = 32, seed: int = 0,
                        rtol: float = 2e-2, device="cuda") -> float:
    """A random fp32 (m, k) @ (k, n), drawn from ``torch.Generator`` seeded
    ``seed`` on ``device``, under the plan against the plain product;
    returns the max abs error and raises ``AssertionError`` unless
    ``max|got - ref| <= rtol * (max|ref| + 1)``, the reference's bound."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device=device)
    w = torch.randn((k, n), generator=gen, device=device)
    got = emulate_matmul_plan(x, w, plan, preload)
    ref = x @ w
    err = float((got - ref).abs().max())
    bound = rtol * (float(ref.abs().max()) + 1.0)
    assert err <= bound, (
        f"plan dataflow diverges from the plain product: max abs err "
        f"{err:.3e} > rtol*max|ref| bound {bound:.3e}")
    return err
