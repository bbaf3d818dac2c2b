"""Cost models (paper §4.3 "Cost model for execution time").

Two models with one interface:

* ``AnalyticCostModel`` — closed-form per-core tile time (compute roofline with
  an MXU/AMP small-tile efficiency term + SRAM feed bound + per-chunk issue
  overhead) and a per-link transfer model (volume/bw + hop latency).  This is
  the ground-truth used by the event simulator.
* ``LinearTreeCostModel`` — the paper fits linear-tree regressors [10] on tiles
  profiled on real IPU hardware.  No IPU exists in this container, so the tree
  is fitted on microbenchmarks of the *simulator's* analytic model (DESIGN.md
  §4 hardware-adaptation note); Figure-12-style accuracy is reproduced as
  tree-vs-analytic agreement in ``benchmarks/fig12_costmodel.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.chip.config import ChipConfig

# fraction of peak a dim contributes when smaller than full MXU/AMP alignment
_ALIGN = 32.0
_CHUNK_OVERHEAD = 1e-6       # per rotation-chunk issue overhead (s)
_VECTOR_OVERHEAD = 1e-6


def _mxu_eff(tile_dims: Sequence[float]) -> float:
    """Efficiency of the matrix pipeline for a per-core tile.

    Small dims under-fill the systolic/AMP pipeline; efficiency is the product
    of per-dim fill ratios, floored to avoid degenerate zero-cost division."""
    eff = 1.0
    for t in tile_dims:
        eff *= min(1.0, max(t, 1.0) / _ALIGN)
    return max(eff, 1.0 / 4096.0)


class AnalyticCostModel:
    """Closed-form tile execution + link transfer costs."""

    def __init__(self, chip: ChipConfig):
        self.chip = chip

    # -- per-core execution --------------------------------------------------
    def tile_time(self, kind: str, tile_dims: Sequence[int],
                  tile_flops: float, tile_bytes: int,
                  chunks: int = 1) -> float:
        c = self.chip
        if kind == "matmul":
            peak = c.core_flops * _mxu_eff(tile_dims)
            t_comp = tile_flops / peak
            over = _CHUNK_OVERHEAD * max(chunks, 1)
        else:
            t_comp = tile_flops / c.core_flops_vector
            over = _VECTOR_OVERHEAD
        t_mem = tile_bytes / c.sram_bw_per_core
        return max(t_comp, t_mem) + over

    # -- interconnect ---------------------------------------------------------
    def link_time(self, volume: int, hops: int = 1, rounds: int = 1) -> float:
        c = self.chip
        return volume / c.link_bw + hops * rounds * c.link_latency

    def rot_time(self, volume: int, rounds: int = 1) -> float:
        """Compute-shift rotation / ring-reduce transfer time for one core's
        exec-phase traffic.  Topology-aware: crossings of a slower link tier
        stretch the serial time by ``rot_time_factor`` (1.0 on flat
        topologies, reproducing the plain per-link model)."""
        if volume <= 0:
            return 0.0
        c = self.chip
        topo = c.topo
        return (volume * topo.rot_time_factor / c.link_bw
                + topo.rot_latency_hops * max(rounds, 1) * c.link_latency)

    def dist_time(self, volume: int) -> float:
        """Data-distribution (preload->execute state) fetch time for one
        core, with the topology's slow-tier blend and the per-hop latency
        of every link class the fetch crosses."""
        if volume <= 0:
            return 0.0
        c = self.chip
        topo = c.topo
        return volume * topo.dist_time_factor / c.link_bw + topo.dist_latency

    def hbm_time(self, volume: int) -> float:
        c = self.chip
        if c.hbm_bw <= 0:
            return 0.0
        return volume / c.hbm_bw + c.hbm_latency

    def tier_time(self, volume: int, tier: int) -> float:
        """Preload-source roofline for a block resident in memory tier
        ``tier`` (DESIGN.md §10): its aggregate bandwidth plus per-request
        latency.  Tier 0 is the cores' own SRAM — the block is already
        resident, so sourcing it is free — and the backing tier reproduces
        ``hbm_time`` exactly (same operands, same operation order)."""
        if tier <= 0:
            return 0.0
        tiers = self.chip.mem_tiers
        t = tiers[min(tier, len(tiers) - 1)]
        if t.bandwidth <= 0:
            return 0.0
        return volume / t.bandwidth + t.latency

    def spill_time(self, volume: int, src: int, dst: int) -> float:
        """One-time staging transfer between two tiers (spill on the way
        down, refill on the way up): the volume at the slower endpoint's
        bandwidth plus both per-request latencies."""
        if volume <= 0 or src == dst:
            return 0.0
        tiers = self.chip.mem_tiers
        a = tiers[min(max(src, 0), len(tiers) - 1)]
        b = tiers[min(max(dst, 0), len(tiers) - 1)]
        bws = [t.bandwidth for t in (a, b) if t.bandwidth > 0]
        if not bws:
            return 0.0
        return volume / min(bws) + a.latency + b.latency

    def collective_time(self, kind: str, nbytes: float, width: int,
                        link_class: str | None = None) -> float:
        """Ring-collective time among ``width`` chips of the pod this chip
        belongs to (hybrid pod planner, DESIGN.md §9)."""
        return self.chip.topo.collective_time(kind, nbytes, width, link_class)


# ---------------------------------------------------------------------------
# Linear-tree regressor (paper ref [10], re-implemented minimally)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Leaf:
    coef: np.ndarray
    intercept: float


@dataclasses.dataclass
class _Node:
    feature: int
    threshold: float
    left: "object"
    right: "object"


def _fit_linear(X: np.ndarray, y: np.ndarray) -> _Leaf:
    A = np.concatenate([X, np.ones((len(X), 1))], axis=1)
    sol, *_ = np.linalg.lstsq(A, y, rcond=None)
    return _Leaf(sol[:-1], float(sol[-1]))


def _leaf_sse(X: np.ndarray, y: np.ndarray) -> float:
    leaf = _fit_linear(X, y)
    pred = X @ leaf.coef + leaf.intercept
    return float(np.sum((pred - y) ** 2))


class LinearTreeCostModel:
    """Piecewise-linear regression tree: split greedily on the (feature,
    median-quantile threshold) minimizing children linear-fit SSE."""

    def __init__(self, max_depth: int = 3, min_samples: int = 16):
        self.max_depth = max_depth
        self.min_samples = min_samples
        self.root: _Node | _Leaf | None = None

    def fit(self, X: np.ndarray, y: np.ndarray) -> "LinearTreeCostModel":
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        self.root = self._build(X, y, 0)
        return self

    def _build(self, X, y, depth):
        if depth >= self.max_depth or len(y) < 2 * self.min_samples:
            return _fit_linear(X, y)
        base = _leaf_sse(X, y)
        best = None
        for f in range(X.shape[1]):
            for q in (0.25, 0.5, 0.75):
                thr = float(np.quantile(X[:, f], q))
                mask = X[:, f] <= thr
                if mask.sum() < self.min_samples or (~mask).sum() < self.min_samples:
                    continue
                sse = _leaf_sse(X[mask], y[mask]) + _leaf_sse(X[~mask], y[~mask])
                if best is None or sse < best[0]:
                    best = (sse, f, thr, mask)
        if best is None or best[0] >= base * 0.999:
            return _fit_linear(X, y)
        _, f, thr, mask = best
        return _Node(f, thr,
                     self._build(X[mask], y[mask], depth + 1),
                     self._build(X[~mask], y[~mask], depth + 1))

    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, dtype=np.float64)
        out = np.empty(len(X))
        for i, row in enumerate(X):
            node = self.root
            while isinstance(node, _Node):
                node = node.left if row[node.feature] <= node.threshold else node.right
            out[i] = row @ node.coef + node.intercept
        return out


def fit_tile_cost_model(chip: ChipConfig, kind: str = "matmul",
                        n_samples: int = 512, seed: int = 0,
                        ) -> tuple[LinearTreeCostModel, np.ndarray, np.ndarray]:
    """Paper §4.3: 'randomly generate tiles with varied shapes, run each tile
    ... fit a linear tree model using the tile shapes as inputs and the
    profiled execution times as outputs.'  Profiling target here = the
    analytic simulator core model."""
    rng = np.random.default_rng(seed)
    analytic = AnalyticCostModel(chip)
    X, y = [], []
    for _ in range(n_samples):
        if kind == "matmul":
            m, n, k = (int(2 ** rng.uniform(0, 9)) for _ in range(3))
            flops = 2.0 * m * n * k
            bts = 2 * (m * k + k * n + m * n)
            t = analytic.tile_time("matmul", (m, n, k), flops, bts)
            X.append([m, n, k, flops, bts])
        else:
            n = int(2 ** rng.uniform(4, 18))
            flops = 8.0 * n
            bts = 2 * n
            t = analytic.tile_time("vector", (n,), flops, bts)
            X.append([n, 1, 1, flops, bts])
        y.append(t)
    X, y = np.asarray(X), np.asarray(y)
    return LinearTreeCostModel().fit(X, y), X, y


def fit_link_cost_model(chip: ChipConfig, n_samples: int = 256, seed: int = 1,
                        ) -> tuple[LinearTreeCostModel, np.ndarray, np.ndarray]:
    """Per-link transfer-time regressor (volume -> time), paper Fig. 12."""
    rng = np.random.default_rng(seed)
    analytic = AnalyticCostModel(chip)
    X = (2 ** rng.uniform(6, 24, size=n_samples)).astype(np.int64)
    y = np.array([analytic.link_time(int(v)) for v in X])
    Xf = np.stack([X, np.ones_like(X)], axis=1).astype(np.float64)
    return LinearTreeCostModel(max_depth=2).fit(Xf, y), Xf, y
