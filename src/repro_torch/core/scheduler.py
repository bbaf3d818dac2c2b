"""Two-level inductive operator scheduling (paper §4.2) + plan finalization.

Search (backward induction, Lemma 4.1 / Theorem 4.2)
----------------------------------------------------
Operators execute in graph order; preloads are issued sequentially in a
(possibly reordered, §4.4) preload order ``pi``.  The decision variable per
operator ``i`` is the *cumulative issue count* ``c_i`` — how many preloads
(positions in ``pi``) have been issued before ``exec(i)`` starts.  The
paper's "preload number" is ``p_i = c_i - (i+1)`` = operators resident
on-chip in preload state while ``i`` executes.

Walking backward from the last operator, each step enumerates feasible
``c_i`` (memory-checked by the §4.3 allocator) and keeps the one minimizing
the *current-to-end* time — exactly Fig. 10.  Hardware rules (§4.5) are
honored: preloads are sequential; preload position ``m >= c_i`` cannot start
until ``exec(i)`` finishes; an operator must be preloaded before executing;
MoE expert preloads cannot be issued before their router executes (§7).

Finalization (forward)
----------------------
The backward pass may re-decide a resident op's preload plan in several
windows (the paper leaves this implicit).  A forward re-allocation pass walks
windows in execution order, *fixing* each op's preload plan in the window
where its preload is issued, and recomputes exact start/end times, the
Fig.-18 breakdown, and utilizations.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

from repro_torch.chip.config import ChipConfig
from repro_torch.core.allocator import (IncrementalWindow, WindowItem,
                                  _window_cost, core_to_allocation,
                                  place_tiers)
from repro_torch.core.cost_model import AnalyticCostModel
from repro_torch.core.fusion import graph_fusion_signature
from repro_torch.core.graph import OpGraph
from repro_torch.core.partition import ExecPlan, PreloadPlan
from repro_torch.core.pipeline import CompileContext
from repro_torch.core.plan import (Breakdown, ExecutionPlan, OpDecision, OpTiming,
                             Utilization)

_NEG_INF = -math.inf


class Scheduler:
    """§4.2 scheduler for one operator graph on one chip.

    All Pareto curves come from the ``CompileContext``'s ``PlanCurveCache``
    and every allocation window goes through its ``WindowCache`` — pass one
    shared ``ctx`` to amortize curve enumeration and window solves across
    Scheduler instances, candidate preload orders, and §6.1 designs.  With
    ``ctx=None`` the scheduler builds a private context (a cold compile).
    """

    def __init__(self, graph: OpGraph, chip: ChipConfig,
                 cost: Optional[AnalyticCostModel] = None,
                 max_preload: int = 64,
                 exec_space_cap: Optional[int] = None,
                 static_preload_frac: Optional[float] = None,
                 exec_fastest: bool = False,
                 ctx: Optional[CompileContext] = None):
        self.graph = graph
        self.chip = chip
        if ctx is not None:
            assert ctx.chip == chip, "CompileContext bound to a different chip"
            if cost is not None and cost is not ctx.cost:
                # curves come from ctx.cost; a different local cost model
                # would silently produce an inconsistent schedule
                raise ValueError("pass cost through the CompileContext, "
                                 "not alongside it")
        self.ctx = ctx or CompileContext(chip, cost)
        self.cost = self.ctx.cost
        self.max_preload = max_preload
        # Baseline knobs (§6.1): a fixed execution-space budget (Static), a
        # fixed preload-plan policy, and Basic's "maximize execution space"
        # rule; all None/False = full ELK behaviour.
        self.exec_space_cap = exec_space_cap
        self.static_preload_frac = static_preload_frac
        self.exec_fastest = exec_fastest
        # invariant per chip/graph; cached off the property hot paths
        self._topo_sig = chip.topo_signature
        self._fusion_sig = graph_fusion_signature(graph)
        self._mem_sig = chip.mem_signature
        self._preload_bw = chip.preload_noc_bw
        self.curves = [self._curves(op) for op in graph.ops]
        # which memory tier each op's weight block is sourced from
        # (DESIGN.md §10); all-backing for the default two-tier chips.
        # The fastest-exec chain is the steady-interval floor: staging
        # below it costs latency without buying throughput.
        exe_floor = sum(min(p.time for p in curve)
                        for curve in self.curves if curve)
        self._tier_of = place_tiers(chip, graph.ops, self.cost,
                                    floor=exe_floor).tier_of
        self._pre_memo: dict = {}

    # -- plan curves ---------------------------------------------------------
    def _curves(self, op) -> list[ExecPlan]:
        if self.exec_space_cap is not None:
            return self.ctx.curves.exec_plans_capped(op, self.exec_space_cap)
        return self.ctx.curves.exec_plans(op)

    def _exec_curve(self, i: int) -> list[ExecPlan]:
        return self.curves[i]

    def _pre_curve(self, i: int, exec_idx: int) -> list[PreloadPlan]:
        key = (i, exec_idx)
        got = self._pre_memo.get(key)
        if got is None:
            op = self.graph.ops[i]
            ep = self.curves[i][exec_idx]
            if self.static_preload_frac is not None:
                # Static baseline: largest- or smallest-footprint plan only
                got = self.ctx.curves.preload_plans_static(
                    op, ep, self.static_preload_frac >= 0.5)
            else:
                got = self.ctx.curves.preload_plans(op, ep)
            self._pre_memo[key] = got
        return got

    # -- window cache helpers -------------------------------------------------
    def _window_key(self, items, cap: int):
        uid_of = self.ctx.curves.uid_of
        parts = []
        for it in items:
            uid = uid_of(it.plans)
            if uid is None:
                return None
            parts.append((uid, it.fixed, it.fixed_choice, it.tier))
        # topology signature: window costs fold in topology hop weights, so
        # a topology change must miss (contexts are per-chip, but be
        # explicit).  The fusion signature plays the same role for the §8
        # pass: fused and unfused schedules share a context but must never
        # share a window solve, and the memory signature for §10: per-tier
        # capacities change which greedy trace a window solves against.
        return (cap, self._topo_sig, self._fusion_sig, self._mem_sig,
                tuple(parts))

    # -- main entry -----------------------------------------------------------
    def schedule(self, preload_order: Optional[Sequence[int]] = None,
                 design: str = "ELK-Dyn") -> ExecutionPlan:
        graph, chip = self.graph, self.chip
        n = len(graph.ops)
        pi = list(preload_order) if preload_order is not None else list(range(n))
        assert sorted(pi) == list(range(n)), "preload order must be a permutation"
        pos = [0] * n
        for m, j in enumerate(pi):
            pos[j] = m

        # MoE/etc: cap on c_i from preload deps (op j preloadable only after
        # its dep executed): while i <= dep(j), c_i <= pos[j].
        dep_cap = [n] * (n + 1)
        for j, op in enumerate(graph.ops):
            if op.preload_dep >= 0:
                for i in range(0, min(op.preload_dep + 1, n)):
                    dep_cap[i] = min(dep_cap[i], pos[j])

        # c_min(i): every op executed by step i must have been preloaded.
        c_min = [0] * n
        run = 0
        for i in range(n):
            run = max(run, pos[i] + 1)
            c_min[i] = run

        # ---- backward induction -------------------------------------------
        exec_choice = [0] * n              # index into exec curve
        c_seq = [0] * (n + 1)
        c_seq[n] = n
        tau_s_exe = [0.0] * (n + 1)        # time-before-end of exec start
        tau_s_pre = [_NEG_INF] * (n + 1)   # per preload position
        l_exe = [0.0] * n

        cap = self.chip.usable_sram_per_core
        windows = self.ctx.windows
        for i in range(n - 1, -1, -1):
            c_next = c_seq[i + 1]
            best = None
            lo = c_min[i]
            hi = min(c_next, i + 1 + self.max_preload, dep_cap[i])
            hi = max(hi, lo)
            # Window family for exec(i): the resident set — ops issued (< c)
            # and not yet executed (> i), the paper's Fig.-4 capacity
            # tradeoff — grows by one preload per step of c, so the greedy
            # descent warm-starts incrementally instead of re-running cold.
            if self.exec_fastest:
                # Basic (§6.1): execution space maximized, preloads squeeze
                # into the remainder.
                exec_item = WindowItem(i, "exec", self._exec_curve(i),
                                       fixed=True, fixed_choice=0)
            else:
                exec_item = WindowItem(i, "exec", self._exec_curve(i))
            fam = IncrementalWindow(self.chip, cap)
            fam.add_item(exec_item)
            added = 0
            lo_alloc = None
            lo_n_items = 1
            for c in range(lo, hi + 1):
                while added < c:
                    j = pi[added]
                    if j > i:
                        fam.add_item(WindowItem(
                            j, "preload",
                            self._pre_curve(j, exec_choice[j])))
                    added += 1
                # preloads *issued during* this window ([c, c_next)) put
                # their HBM-controller->core delivery bytes on the
                # interconnect here; residents' delivery was charged to
                # their issuing window.
                extra_noc = sum(self._preload_noc_estimate(pi[m], exec_choice)
                                for m in range(c, c_next))
                core = None
                key = self._window_key(fam.items, cap)
                if key is not None:
                    core = windows.get(key)
                if core is None:
                    core = fam.solve_core()
                    if key is not None:
                        windows.put(key, core)
                alloc = core_to_allocation(self.chip, fam.items, core,
                                           extra_noc)
                if c == lo:
                    lo_alloc = alloc
                    lo_n_items = len(fam.items)
                if not alloc.feasible:
                    # residents grow with c => larger c stays infeasible
                    if c > lo:
                        break
                    continue
                lexe = alloc.exec_time + max(
                    0.0, alloc.noc_time - alloc.exec_time)
                # schedule new preload positions [c, c_next) latest-first
                tau_pre_local = {}
                nxt = tau_s_pre[c_next] if c_next < n else _NEG_INF
                for m in range(c_next - 1, c - 1, -1):
                    j = pi[m]
                    t_end = max(tau_s_exe_at(tau_s_exe, j, n), nxt)
                    lpre = self._preload_time(j, exec_choice)
                    tau_pre_local[m] = t_end + lpre
                    nxt = tau_pre_local[m]
                blocker = tau_pre_local.get(c, tau_s_pre[c] if c < n else _NEG_INF)
                tau_e = max(tau_s_exe[i + 1], blocker, 0.0)
                tau_s = tau_e + lexe
                if best is None or tau_s < best[0] - 1e-15:
                    best = (tau_s, c, alloc, tau_pre_local, lexe)
            if best is None:
                # cannot fit even c = c_min: fall back to minimal window with
                # smallest plans (degenerate but schedulable)
                c = lo
                items = fam.items[:lo_n_items]
                choice = {it.op_idx: len(it.plans) - 1 for it in items}
                extra_noc = sum(self._preload_noc_estimate(pi[m], exec_choice)
                                for m in range(c, c_next))
                cost, e, d, nt = _window_cost(self.chip, items, choice,
                                              extra_noc)
                alloc = dataclasses.replace(
                    lo_alloc, feasible=True, choices=choice, exec_time=e,
                    dist_time=d, noc_time=nt, cost=cost)
                lexe = alloc.exec_time
                best = (tau_s_exe[i + 1] + lexe, c, alloc, {}, lexe)
            tau_s, c, alloc, tau_pre_local, lexe = best
            c_seq[i] = c
            tau_s_exe[i] = tau_s
            l_exe[i] = lexe
            for m, v in tau_pre_local.items():
                tau_s_pre[m] = v
            exec_choice[i] = alloc.choices[i]

        # ---- forward finalization ------------------------------------------
        return self._finalize(pi, pos, c_seq, exec_choice, design)

    def _preload_noc_estimate(self, j: int, exec_choice: list[int]) -> float:
        """Delivery bytes of op j's preload (min-space plan estimate; the
        forward finalization recomputes with the bound plan)."""
        return self._pre_curve(j, exec_choice[j])[-1].noc_preload_bytes

    def _preload_time(self, j: int, exec_choice: list[int]) -> float:
        """Paper §4.2: max(source-tier roofline time, interconnect transfer
        time).  The backward pass prices every preload at the *backing*
        tier, whatever its placement: issue decisions stay identical to the
        untiered schedule, so staging can only shorten the per-tier queue
        chains the forward finalization computes — never perturb the
        window structure into a worse plan."""
        op = self.graph.ops[j]
        pre = self._pre_curve(j, exec_choice[j])
        plan = pre[-1]  # minimum-space estimate; finalization refines
        t_src = self.cost.tier_time(plan.hbm_bytes, self.chip.backing_tier)
        t_noc = plan.noc_preload_bytes / self._preload_bw
        return max(t_src, t_noc)

    # -- finalization ----------------------------------------------------------
    def _finalize(self, pi, pos, c_seq, exec_choice, design) -> ExecutionPlan:
        graph, chip, n = self.graph, self.chip, len(self.graph.ops)
        # Two-phase binding.  Phase 1: allocate every window independently
        # and record each resident op's chosen preload plan per window.
        # Phase 2: bind each op to its *min-space* choice across all windows
        # it is resident in — the loaded plan must fit the tightest window
        # it lives through, and binding at issue time (where space is
        # plentiful) was measured to starve later windows so badly that
        # ELK-Dyn fell behind Basic on KV-heavy shapes.
        seen_choice: dict[int, int] = {}
        for i in range(n):
            residents = [j for j in pi[:c_seq[i]] if j > i]
            items = [WindowItem(i, "exec", self._exec_curve(i),
                                fixed=True, fixed_choice=exec_choice[i])]
            for j in residents:
                items.append(WindowItem(
                    j, "preload", self._pre_curve(j, exec_choice[j])))
            alloc, _ = self._allocate_window_items(items, 0.0)
            for j in residents:
                seen_choice[j] = max(seen_choice.get(j, 0),
                                     alloc.choices[j])

        bound_pre: dict[int, PreloadPlan] = {}
        bound_pre_idx: dict[int, int] = {}
        for j, idx in seen_choice.items():
            curve = self._pre_curve(j, exec_choice[j])
            bound_pre_idx[j] = idx
            bound_pre[j] = curve[idx]

        stall = [0.0] * n
        lexe = [0.0] * n
        dist = [0.0] * n
        for i in range(n):
            residents = [j for j in pi[:c_seq[i]] if j > i]
            items = [WindowItem(i, "exec", self._exec_curve(i),
                                fixed=True, fixed_choice=exec_choice[i])]
            for j in residents:
                curve = self._pre_curve(j, exec_choice[j])
                items.append(WindowItem(j, "preload", curve, fixed=True,
                                        fixed_choice=bound_pre_idx[j]))
            extra_noc = 0.0
            for m in range(c_seq[i], c_seq[i + 1]):
                j = pi[m]
                if j in bound_pre:
                    extra_noc += bound_pre[j].noc_preload_bytes
                else:
                    extra_noc += self._preload_noc_estimate(j, exec_choice)
            alloc, _ = self._allocate_window_items(items, extra_noc)
            lexe[i] = alloc.exec_time
            stall[i] = max(0.0, alloc.noc_time - alloc.exec_time)
        # ops never resident anywhere (executed immediately after preload /
        # c window boundaries): bind min-space plan
        for j in range(n):
            if j not in bound_pre:
                curve = self._pre_curve(j, exec_choice[j])
                bound_pre_idx[j] = len(curve) - 1
                bound_pre[j] = curve[-1]
            dist[j] = bound_pre[j].dist_time

        # exact forward timing
        timing = [OpTiming() for _ in range(n)]
        # c_seq is nondecreasing in i; position m is blocked by every i with
        # c_i <= m; the binding (latest-exec) one is max{i : c_i <= m}.
        blocker_of = [-1] * n
        b, idx = -1, 0
        for m in range(n):
            while idx < n and c_seq[idx] <= m:
                b = idx
                idx += 1
            blocker_of[m] = b

        # each source tier serves its preloads sequentially (§4.5, per
        # controller group) — one free-at time per tier; a single-tier chip
        # reduces to the original global chain bit-for-bit
        pre_bw = self._preload_bw
        tier_free: dict[int, float] = {}
        for m in range(n):
            j = pi[m]
            t_blocked = (timing[blocker_of[m]].t_e_exe
                         if blocker_of[m] >= 0 else 0.0)
            dep = graph.ops[j].preload_dep
            t_dep = timing[dep].t_e_exe if dep >= 0 else 0.0
            tk = self._tier_of[j]
            t_start = max(tier_free.get(tk, 0.0), t_blocked, t_dep)
            plan = bound_pre[j]
            lpre = max(self.cost.tier_time(plan.hbm_bytes, tk),
                       plan.noc_preload_bytes / pre_bw)
            timing[j].t_s_pre = t_start
            timing[j].t_e_pre = t_start + lpre
            tier_free[tk] = timing[j].t_e_pre
            # exec timing interleaves: fill exec times for ops whose preload
            # completed — handled in second sweep below.

        # exec sweep (depends on preload completion; preload blocked-by-exec
        # constraint resolved by iterating to fixpoint, 2 passes suffice
        # because blocking only delays preloads of *later* windows)
        for _ in range(3):
            t_prev = 0.0
            for i in range(n):
                t_s = max(t_prev, timing[i].t_e_pre)
                timing[i].t_s_exe = t_s
                timing[i].t_e_exe = t_s + dist[i] + lexe[i] + stall[i]
                t_prev = timing[i].t_e_exe
            tier_free = {}
            for m in range(n):
                j = pi[m]
                t_blocked = (timing[blocker_of[m]].t_e_exe
                             if blocker_of[m] >= 0 else 0.0)
                dep = graph.ops[j].preload_dep
                t_dep = timing[dep].t_e_exe if dep >= 0 else 0.0
                tk = self._tier_of[j]
                t_start = max(tier_free.get(tk, 0.0), t_blocked, t_dep)
                plan = bound_pre[j]
                lpre = max(self.cost.tier_time(plan.hbm_bytes, tk),
                           plan.noc_preload_bytes / pre_bw)
                timing[j].t_s_pre = t_start
                timing[j].t_e_pre = t_start + lpre
                tier_free[tk] = timing[j].t_e_pre

        total = timing[n - 1].t_e_exe if n else 0.0
        decisions = [OpDecision(i, c_seq[i] - (i + 1),
                                self._exec_curve(i)[exec_choice[i]],
                                bound_pre.get(i), stall[i],
                                src_tier=self._tier_of[i])
                     for i in range(n)]
        breakdown = _breakdown(timing, stall, total)
        util = _utilization(self, bound_pre, decisions, total)
        return ExecutionPlan(graph, chip.name, design, decisions, pi, timing,
                             total, breakdown, util)

    def _allocate_window_items(self, items, extra_noc: float = 0.0):
        cap = self.chip.usable_sram_per_core
        key = self._window_key(items, cap)
        core = self.ctx.windows.get(key) if key is not None else None
        if core is None:
            win = IncrementalWindow(self.chip, cap)
            for it in items:
                win.add_item(it)
            core = win.solve_core()
            if key is not None:
                self.ctx.windows.put(key, core)
        alloc = core_to_allocation(self.chip, items, core, extra_noc)
        if not alloc.feasible:
            choice = {it.op_idx: (it.fixed_choice if it.fixed
                                  else len(it.plans) - 1) for it in items}
            cost, e, d, nt = _window_cost(self.chip, items, choice, extra_noc)
            alloc = dataclasses.replace(alloc, feasible=True, choices=choice,
                                        exec_time=e, dist_time=d, noc_time=nt,
                                        cost=cost)
        return alloc, items


def tau_s_exe_at(tau_s_exe: list[float], j: int, n: int) -> float:
    return tau_s_exe[j] if j <= n else 0.0


def _breakdown(timing: list[OpTiming], stall: list[float],
               total: float) -> Breakdown:
    """Interval arithmetic over preload vs exec busy spans (Fig. 18a)."""
    events = []
    for t in timing:
        if t.t_e_pre > t.t_s_pre:
            events.append((t.t_s_pre, t.t_e_pre, "p"))
        if t.t_e_exe > t.t_s_exe:
            events.append((t.t_s_exe, t.t_e_exe, "e"))
    pts = sorted({0.0, total} | {x for s, e, _ in events for x in (s, e)})
    b = Breakdown(interconnect_stall=sum(stall))
    for a, z in zip(pts, pts[1:]):
        mid = (a + z) / 2
        has_p = any(s <= mid < e for s, e, k in events if k == "p")
        has_e = any(s <= mid < e for s, e, k in events if k == "e")
        span = z - a
        if has_p and has_e:
            b.overlapped += span
        elif has_p:
            b.preload_only += span
        elif has_e:
            b.execute_only += span
    # stall time was folded inside exec spans; remove it from execute/overlap
    b.execute_only = max(0.0, b.execute_only - sum(stall))
    return b


def _utilization(sched: "Scheduler", bound_pre, decisions, total
                 ) -> Utilization:
    chip = sched.chip
    if total <= 0:
        return Utilization()
    hbm_bytes = sum(p.hbm_bytes for p in bound_pre.values())
    noc_occ = sum(chip.noc_occupancy(0.0, p.noc_preload_bytes,
                                     p.noc_dist_bytes)
                  for p in bound_pre.values())
    noc_occ += chip.noc_occupancy(
        sum(d.exec_plan.noc_exec_bytes for d in decisions), 0.0)
    flops = sum(op.flops for op in sched.graph.ops)
    hbm = (hbm_bytes / (chip.hbm_bw * total)) if chip.hbm_bw else 0.0
    return Utilization(
        hbm=min(hbm, 1.0),
        interconnect=min(noc_occ / total, 1.0),
        flops=min(flops / (chip.total_flops * total), 1.0),
        achieved_tflops=flops / total / 1e12,
    )
