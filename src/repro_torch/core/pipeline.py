"""Cached, incremental ELK compile pipeline (DESIGN.md §1-§2).

The compile path is an explicit pass sequence

    build graph -> curve cache -> candidate orders -> inductive schedule
                -> finalize -> select

driven by a per-compile :class:`CompileContext` that owns the shared state
the passes would otherwise re-derive from scratch:

* :class:`PlanCurveCache` — exec/preload Pareto curves interned by
  ``(op signature, chip)``.  Identical layers, repeated ``Scheduler``
  instances (the §6.1 baseline sweeps build ten per design), every
  candidate preload order, and both reduced-L extrapolation truncations
  all hit the same curve objects.
* :class:`WindowCache` — §4.3 allocation windows memoized on a frozen
  item-signature key (curve identities + fixed choices + capacity).  The
  greedy descent result is independent of the window's interconnect
  surcharge, so one solve serves every order/design that builds the same
  window.
* a process-level :class:`PlanCache` keyed by ``(model config, chip,
  batch, seq, phase, design, ...)`` so ``compare_designs``, the serving
  stack (``integration.pod_plan`` / ``serve.engine``), the dry-run driver
  and the benchmarks reuse finished :class:`ExecutionPlan` objects instead
  of recompiling per request.

Cached plans are shared objects — treat them as immutable.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Optional

from repro_torch.chip.config import ChipConfig
from repro_torch.core.cost_model import AnalyticCostModel
from repro_torch.core.fusion import (FUSION_VERSION, FusedOp,
                               enumerate_fused_exec_plans, fuse_graph,
                               fusion_signature)
from repro_torch.core.graph import OpGraph, Phase, build_graph
from repro_torch.core.partition import (enumerate_exec_plans,
                                  enumerate_preload_plans,
                                  op_curve_signature)
from repro_torch.core.plan import Breakdown, ExecutionPlan, Utilization
from repro_torch.models.config import ModelConfig

PIPELINE_PASSES = ("graph", "curves", "orders", "schedule", "finalize",
                   "select")


def plan_signature(cfg: ModelConfig, chip: ChipConfig, *parts) -> tuple:
    """The canonical plan-cache key prefix: model + chip identity plus the
    chip's derived topology and memory-hierarchy signatures, followed by
    the caller's own discriminating parts.

    Every plan-level cache in the repo (``compile_pipeline``,
    ``plan_pipeline``, ``plan_hybrid``) builds its key through this one
    helper so a new hardware knob only has to be added here — forgetting
    to thread it through some key assembly elsewhere was exactly how a
    stale-hit bug could slip in.
    """
    return (cfg, chip, chip.topo_signature, chip.mem_signature) + parts


# ---------------------------------------------------------------------------
# pass 2 state: plan-curve cache
# ---------------------------------------------------------------------------

class PlanCurveCache:
    """Interns exec/preload Pareto curves per (op signature, chip).

    Every interned list gets a stable integer ``uid`` used by the window
    cache to build frozen item-signature keys without hashing plan
    contents.  Derived curves (execution-space-capped exec curves, the
    Static baseline's single-plan preload picks) are interned too, so two
    ``Scheduler`` instances with the same knobs share identical objects.
    """

    def __init__(self, chip: ChipConfig, cost: Optional[AnalyticCostModel] = None):
        self.chip = chip
        self.cost = cost or AnalyticCostModel(chip)
        # curves depend on topology through rotation/distribution costs
        # (and, for capped variants, on the memory hierarchy); the combined
        # hardware signature in every key makes a topology or tier change
        # miss even if a cache instance were ever shared across chips
        self._hw_sig = (chip.topo_signature, chip.mem_signature)
        self.hits = 0
        self.misses = 0
        self._exec: dict = {}        # sig -> [ExecPlan]
        self._pre: dict = {}         # (sig, exec key) -> [PreloadPlan]
        self._derived: dict = {}     # transform key -> list
        self._uids: dict = {}        # id(list) -> uid
        self._next_uid = 0

    def _intern(self, plans: list) -> list:
        self._uids[id(plans)] = self._next_uid
        self._next_uid += 1
        return plans

    def uid_of(self, plans) -> Optional[int]:
        return self._uids.get(id(plans))

    def exec_plans(self, op) -> list:
        # FusedOp signatures carry curve_signature_extra (incl. the fusion
        # version), so fused and plain curves can never share an entry
        sig = (op_curve_signature(op), self._hw_sig)
        got = self._exec.get(sig)
        if got is None:
            self.misses += 1
            enum = (enumerate_fused_exec_plans if isinstance(op, FusedOp)
                    else enumerate_exec_plans)
            got = self._exec[sig] = self._intern(
                enum(op, self.chip, self.cost))
        else:
            self.hits += 1
        return got

    def exec_plans_capped(self, op, cap: int) -> list:
        """The Static/capped baselines' single fastest-fitting plan."""
        sig = (op_curve_signature(op), self._hw_sig, "cap", cap)
        got = self._derived.get(sig)
        if got is None:
            self.misses += 1
            plans = self.exec_plans(op)
            fit = [p for p in plans if p.space <= cap]
            got = self._derived[sig] = self._intern(
                [min(fit or plans, key=lambda p: p.time)])
        else:
            self.hits += 1
        return got

    def preload_plans(self, op, exec_plan) -> list:
        sig = (op_curve_signature(op), self._hw_sig, exec_plan.key())
        got = self._pre.get(sig)
        if got is None:
            self.misses += 1
            got = self._pre[sig] = self._intern(
                enumerate_preload_plans(op, exec_plan, self.chip, self.cost))
        else:
            self.hits += 1
        return got

    def preload_plans_static(self, op, exec_plan, first: bool) -> list:
        """Static baseline: the max- or min-footprint plan only."""
        sig = (op_curve_signature(op), self._hw_sig, exec_plan.key(),
               "static", first)
        got = self._derived.get(sig)
        if got is None:
            self.misses += 1
            plans = self.preload_plans(op, exec_plan)
            got = self._derived[sig] = self._intern(
                [plans[0] if first else plans[-1]])
        else:
            self.hits += 1
        return got


# ---------------------------------------------------------------------------
# pass 4 state: window cache
# ---------------------------------------------------------------------------

class WindowCache:
    """Memoized §4.3 greedy window solves.

    Key: ``(capacity, ((curve uid, fixed, fixed_choice), ...))`` — the
    items' order matters (it is the greedy's tie-break order).  Value: the
    *core* of an allocation — ``(feasible, per-slot choices, space,
    exec_time, dist_time, exec_noc_bytes)`` — which is independent of the
    window's ``extra_preload_noc`` surcharge; callers finish the cost
    arithmetic per lookup.
    """

    def __init__(self):
        self._d: dict = {}
        self.hits = 0
        self.misses = 0

    def get(self, key):
        got = self._d.get(key)
        if got is not None:
            self.hits += 1
        return got

    def put(self, key, core) -> None:
        self.misses += 1
        self._d[key] = core


# ---------------------------------------------------------------------------
# compile context (one per compile / compare_designs sweep)
# ---------------------------------------------------------------------------

class CompileContext:
    """Shared state threaded through every pass of one compile.

    One context serves any number of ``Scheduler`` instances, designs and
    candidate orders, as long as they target the same chip.
    """

    def __init__(self, chip: ChipConfig,
                 cost: Optional[AnalyticCostModel] = None):
        self.chip = chip
        if cost is not None and getattr(cost, "chip", chip) != chip:
            raise ValueError("cost model bound to a different chip")
        self.cost = cost or AnalyticCostModel(chip)
        self.curves = PlanCurveCache(chip, self.cost)
        self.windows = WindowCache()
        self._graphs: dict = {}

    def graph(self, cfg: ModelConfig, *, batch: int, seq: int,
              phase: Phase) -> OpGraph:
        key = (cfg, batch, seq, phase)
        got = self._graphs.get(key)
        if got is None:
            got = self._graphs[key] = build_graph(cfg, batch=batch, seq=seq,
                                                  phase=phase)
        return got

    def fused_graph(self, cfg: ModelConfig, *, batch: int, seq: int,
                    phase: Phase) -> OpGraph:
        """The same graph after the §8 fusion pass (chip-gated on aggregate
        SRAM).  Returns the base graph object itself when nothing fuses."""
        key = (cfg, batch, seq, phase, "fused", FUSION_VERSION)
        got = self._graphs.get(key)
        if got is None:
            base = self.graph(cfg, batch=batch, seq=seq, phase=phase)
            got = self._graphs[key] = fuse_graph(base, self.chip)
        return got


# ---------------------------------------------------------------------------
# process-level plan cache
# ---------------------------------------------------------------------------

class PlanCache:
    """Bounded LRU of finished ExecutionPlans, safe for serving threads."""

    def __init__(self, maxsize: int = 256):
        self.maxsize = maxsize
        self.hits = 0
        self.misses = 0
        self._d: OrderedDict = OrderedDict()
        self._lock = threading.Lock()

    def get(self, key):
        with self._lock:
            got = self._d.get(key)
            if got is not None:
                self._d.move_to_end(key)
                self.hits += 1
            else:
                self.misses += 1
            return got

    def put(self, key, plan) -> None:
        with self._lock:
            self._d[key] = plan
            self._d.move_to_end(key)
            while len(self._d) > self.maxsize:
                self._d.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._d.clear()
            self.hits = self.misses = 0


_PLAN_CACHE = PlanCache()


def plan_cache() -> PlanCache:
    return _PLAN_CACHE


def clear_plan_cache() -> None:
    _PLAN_CACHE.clear()


# ---------------------------------------------------------------------------
# compile driver
# ---------------------------------------------------------------------------

def compile_pipeline(cfg: ModelConfig, chip: ChipConfig, *, batch: int,
                     seq: int, phase: Phase = "decode",
                     design: str = "ELK-Full", max_exact_ops: int = 400,
                     max_orders: int = 24,
                     ctx: Optional[CompileContext] = None,
                     cache: bool = True,
                     parallel: Optional[int] = None,
                     fusion: bool = False) -> ExecutionPlan:
    """Run the full pass pipeline for one (model, chip, shape, design).

    ``ctx`` shares curve/window caches across calls (``compare_designs``
    passes one context for all five designs); ``cache=True`` additionally
    consults the process-level plan cache.  ``parallel`` evaluates §4.4
    candidate preload orders on a worker pool of that size.

    ``fusion=True`` additionally compiles the §8 fused graph against the
    same context and returns whichever plan is faster — fusion is applied
    only where the scheduler's fused curves actually beat preload overlap,
    and the result is never worse than the fusion-off plan.  The fusion
    signature joins every plan-cache key (like ``topo_signature``), so the
    two knob settings can never serve each other's entries.
    """
    if ctx is not None and type(ctx.cost) is not AnalyticCostModel:
        # plan-cache keys don't encode the cost model; a context with a
        # custom one must not poison (or read) default-cost entries
        cache = False
    key = plan_signature(cfg, chip, fusion_signature(fusion), batch, seq,
                         phase, design, max_exact_ops, max_orders)
    if cache:
        hit = _PLAN_CACHE.get(key)
        if hit is not None:
            return hit
    ctx = ctx or CompileContext(chip)
    plan = _compile_variant(cfg, chip, batch, seq, phase, design,
                            max_exact_ops, max_orders, ctx, cache, parallel,
                            fused=False)
    if fusion:
        fgraph = ctx.fused_graph(cfg, batch=batch, seq=seq, phase=phase)
        base_graph = ctx.graph(cfg, batch=batch, seq=seq, phase=phase)
        fplan = None
        if fgraph is not base_graph:
            fplan = _compile_variant(cfg, chip, batch, seq, phase, design,
                                     max_exact_ops, max_orders, ctx, cache,
                                     parallel, fused=True)
        if fplan is not None and fplan.total_time < plan.total_time:
            plan = dataclasses.replace(fplan, fusion=True)
        else:
            # base graph won (or nothing fused): return a distinct object so
            # the fusion-on cache entry never aliases the fusion-off one
            plan = dataclasses.replace(plan, fusion=False)
    if cache:
        _PLAN_CACHE.put(key, plan)
    return plan


def _compile_variant(cfg, chip, batch, seq, phase, design, max_exact_ops,
                     max_orders, ctx, cache, parallel,
                     fused: bool) -> ExecutionPlan:
    graph = (ctx.fused_graph(cfg, batch=batch, seq=seq, phase=phase) if fused
             else ctx.graph(cfg, batch=batch, seq=seq, phase=phase))
    if len(graph.ops) <= max_exact_ops:
        return _exact_plan(cfg, chip, batch, seq, phase, design, max_orders,
                           ctx, cache, parallel, fused)
    plan = _extrapolated(cfg, chip, batch, seq, phase, design, max_orders,
                         ctx, cache, parallel, fused)
    if design in ("ELK-Dyn", "ELK-Full"):
        # ELK's search space contains every static configuration; linear
        # layer-extrapolation is not monotonicity-preserving across
        # designs, so re-impose dominance at the extrapolated level.
        st = _extrapolated(cfg, chip, batch, seq, phase, "Static",
                           max_orders, ctx, cache, parallel, fused)
        if st.total_time < plan.total_time:
            plan = dataclasses.replace(st, design=design)
    return plan


def _exact_plan(cfg, chip, batch, seq, phase, design, max_orders, ctx,
                cache, parallel, fused: bool = False) -> ExecutionPlan:
    key = plan_signature(cfg, chip, fusion_signature(fused), batch, seq,
                         phase, design, "exact", max_orders)
    if cache:
        hit = _PLAN_CACHE.get(key)
        if hit is not None:
            return hit
    from repro_torch.core.baselines import build_plan
    graph = (ctx.fused_graph(cfg, batch=batch, seq=seq, phase=phase) if fused
             else ctx.graph(cfg, batch=batch, seq=seq, phase=phase))
    plan = build_plan(graph, chip, design, max_orders=max_orders, ctx=ctx,
                      parallel=parallel)
    if cache:
        _PLAN_CACHE.put(key, plan)
    return plan


def _layer_counts(cfg: ModelConfig) -> tuple[int, int]:
    period = max(cfg.moe_every, 1) if cfg.moe_experts else 1
    l1 = cfg.moe_first_dense + 3 * period
    l2 = l1 + 2 * period
    if l2 >= cfg.num_layers:
        return cfg.num_layers, cfg.num_layers
    return l1, l2


def _extrapolated(cfg, chip, batch, seq, phase, design, max_orders, ctx,
                  cache, parallel, fused: bool = False) -> ExecutionPlan:
    """Reduced-L schedule + linear extrapolation in the layer count.

    The two truncations share every curve (identical layer signatures) and
    most allocation windows through ``ctx``, and land in the plan cache so
    the §6.1 dominance re-check and ``compare_designs`` reuse them.
    """
    l1, l2 = _layer_counts(cfg)
    cfg1 = dataclasses.replace(cfg, num_layers=l1)
    cfg2 = dataclasses.replace(cfg, num_layers=l2)
    # byte/flop totals are fusion-invariant (a FusedOp sums its parts), so
    # the base graph serves both variants' utilization arithmetic
    g_full = ctx.graph(cfg, batch=batch, seq=seq, phase=phase)
    p1 = _exact_plan(cfg1, chip, batch, seq, phase, design, max_orders, ctx,
                     cache, parallel, fused)
    p2 = _exact_plan(cfg2, chip, batch, seq, phase, design, max_orders, ctx,
                     cache, parallel, fused)
    if l1 == l2:
        return p2

    scale = (cfg.num_layers - l2) / (l2 - l1)

    def ext(a: float, b: float) -> float:
        return max(b + (b - a) * scale, 0.0)

    total = ext(p1.total_time, p2.total_time)
    breakdown = Breakdown(
        preload_only=ext(p1.breakdown.preload_only, p2.breakdown.preload_only),
        execute_only=ext(p1.breakdown.execute_only, p2.breakdown.execute_only),
        overlapped=ext(p1.breakdown.overlapped, p2.breakdown.overlapped),
        interconnect_stall=ext(p1.breakdown.interconnect_stall,
                               p2.breakdown.interconnect_stall),
    )
    # extrapolate resource byte/flop totals, recompute utilizations
    flops = sum(op.flops for op in g_full.ops)
    hbm_bytes = sum(op.hbm_bytes for op in g_full.ops)

    def occ_of(p: ExecutionPlan) -> float:
        return p.util.interconnect * p.total_time

    noc_occ = ext(occ_of(p1), occ_of(p2))
    util = Utilization(
        hbm=min(hbm_bytes / (chip.hbm_bw * total), 1.0) if chip.hbm_bw else 0.0,
        interconnect=min(noc_occ / total, 1.0),
        flops=min(flops / (chip.total_flops * total), 1.0),
        achieved_tflops=flops / total / 1e12,
    )
    return ExecutionPlan(p2.graph, chip.name, design, p2.decisions,
                         p2.preload_order, p2.timing, total, breakdown, util,
                         extrapolated_from_layers=l2)
