"""Cost-aware on-chip memory allocation (paper §4.3).

Given the currently executing operator and the set of operators preloaded
(resident) during its execution, jointly pick:

* the execute-state plan of the current op (Tradeoff 1: space <-> time),
* the preload-state plan of each resident op (Tradeoffs 2+3: space <->
  data-distribution time / exec-time inter-core traffic),

such that everything fits in on-chip memory and total window time is
minimized.  Exactly the paper's iterative greedy: start every op at its
fastest (largest-space) Pareto plan; while over capacity, downgrade the op
whose next Pareto step has the best ratio ``delta = freed_space /
added_time``; stop when it fits (or report infeasible).

The window cost combines (1) execution time, (2) data-distribution times,
(3) interconnect contention (total traffic / aggregate bandwidth, §4.3), and
(4) SRAM access contention (folded into ExecPlan.time per footnote 2).

Incremental solving (DESIGN.md §2)
----------------------------------
The §4.2 backward induction allocates a *family* of windows per operator
whose resident set grows by one preload as the cumulative issue count ``c``
increases.  :class:`IncrementalWindow` replays the greedy exactly while
sharing work across the family: the greedy's pop sequence — each round
takes the best ``freed/added`` head among the items' Pareto step streams,
first item winning ties — restricted to any subset of items is unaffected
by the other items, so the pop sequence for ``items + x`` is the head-by-
head merge of the existing sequence with ``x``'s own step stream.
``add_item`` performs that merge; ``solve`` then just selects the shortest
trace prefix whose freed space fits the capacity, reproducing a cold
``allocate()`` bit-for-bit at a fraction of the work.

Tiered placement (DESIGN.md §10)
--------------------------------
With an N-tier ``ChipConfig.mem_tiers`` hierarchy each capacity-bounded
store runs its *own* instance of the same greedy: a :class:`WindowItem`
carries the tier its space is charged against, and ``IncrementalWindow``
keeps one independent trace per tier (the pop-sequence subset property
holds per store, so the warm-start/exact-incremental contract is
preserved tier by tier).  Which tier a layer block is *sourced from* is
decided up front by :func:`place_tiers`: a deterministic longest-first
greedy that assigns blocks to the tier minimizing the steady-state
bottleneck preload chain, never exceeding a staging tier's capacity and
never beating the chain balance (a block stays in the backing store when
promoting it would not shrink the bottleneck).
"""

from __future__ import annotations

import bisect
import dataclasses
import heapq
import math
from typing import Optional, Sequence

from repro_torch.chip.config import ChipConfig
from repro_torch.core.partition import ExecPlan


@dataclasses.dataclass(frozen=True)
class WindowItem:
    """One op's Pareto curve inside an allocation window."""
    op_idx: int
    role: str                       # "exec" | "preload"
    plans: Sequence                 # ExecPlan list or PreloadPlan list
    fixed: bool = False             # plan already bound by an earlier window
    fixed_choice: int = 0
    tier: int = 0                   # memory tier the plan's space lives in


@dataclasses.dataclass
class Allocation:
    feasible: bool
    choices: dict[int, int]              # op_idx -> plan index on its curve
    exec_time: float                     # current op execution (incl. rotation)
    dist_time: float                     # sum of resident ops' future dist time
    noc_time: float                      # window interconnect occupancy (s)
    space: int                           # total per-core bytes
    cost: float                          # scalar objective used by the search

    def exec_plan(self, item: WindowItem) -> ExecPlan:
        return item.plans[self.choices[item.op_idx]]


def _window_cost(chip: ChipConfig, items: Sequence[WindowItem],
                 choice: dict[int, int], extra_preload_noc: float = 0.0,
                 ) -> tuple[float, float, float, float]:
    """Returns (cost, exec_time, dist_time, noc_time).

    ``extra_preload_noc`` carries the HBM-controller->core delivery bytes of
    the preloads *issued during* this window (scheduler-provided).  Resident
    ops' delivery traffic was charged to the window that issued it — counting
    it again here would double-book the interconnect and wrongly punish deep
    preloads.  Residents contribute only their (future) data-distribution
    time, which the greedy descent trades against space.
    """
    exec_t = 0.0
    dist_t = 0.0
    exec_noc = 0.0
    for it in items:
        p = it.plans[choice[it.op_idx]]
        if it.role == "exec":
            exec_t += p.time
            exec_noc += p.noc_exec_bytes
        else:
            dist_t += p.dist_time
    noc_t = chip.noc_occupancy(exec_noc, extra_preload_noc)
    # contention: interconnect time beyond what hides under execution stalls
    # the window (paper Fig. 18's "interconnect" category).
    stall = max(0.0, noc_t - exec_t)
    cost = exec_t + dist_t + stall
    return cost, exec_t, dist_t, noc_t


class _TierGreedy:
    """The §4.3 greedy trace for the items charged against one store."""

    __slots__ = ("cap", "base_space", "slots", "_streams", "_next",
                 "_trace", "_cum", "_heap")

    def __init__(self, cap: int):
        self.cap = cap
        self.base_space = 0          # all items at their starting choice
        self.slots: list[int] = []       # local slot -> global slot index
        self._streams: list[list] = []   # per slot: [(delta, freed), ...]
        self._next: list[int] = []       # per slot: first step not in trace
        self._trace: list[tuple] = []    # (delta, slot, freed) in pop order
        self._cum: list[float] = []      # prefix sums of freed space
        self._heap: list[tuple] = []     # (-delta, slot): heads beyond trace

    def add(self, item: WindowItem, global_slot: int) -> None:
        slot = len(self.slots)
        self.slots.append(global_slot)
        start = item.fixed_choice if item.fixed else 0
        self.base_space += item.plans[start].space
        steps: list[tuple] = []
        if not item.fixed:
            plans = item.plans
            j = start
            while j + 1 < len(plans):
                cur, nxt = plans[j], plans[j + 1]
                freed = cur.space - nxt.space
                if freed <= 0:
                    # the cold greedy never advances past a non-freeing step
                    break
                if item.role == "exec":
                    added = nxt.time - cur.time
                else:
                    added = nxt.dist_time - cur.dist_time
                steps.append((freed / max(added, 1e-12), freed))
                j += 1
        self._streams.append(steps)
        if not steps:
            self._next.append(0)
            return
        k = 0
        if self._trace:
            # head-by-head merge; existing (lower-slot) entries win ties
            merged: list[tuple] = []
            for e in self._trace:
                while k < len(steps) and steps[k][0] > e[0]:
                    merged.append((steps[k][0], slot, steps[k][1]))
                    k += 1
                merged.append(e)
            if k:
                self._trace = merged
                cum, run = [], 0.0
                for _, _, freed in merged:
                    run += freed
                    cum.append(run)
                self._cum = cum
        self._next.append(k)
        if k < len(steps):
            heapq.heappush(self._heap, (-steps[k][0], slot))

    def _extend(self) -> bool:
        """Materialize the next greedy pop into the trace."""
        if not self._heap:
            return False
        _, slot = heapq.heappop(self._heap)
        k = self._next[slot]
        delta, freed = self._streams[slot][k]
        self._trace.append((delta, slot, freed))
        self._cum.append((self._cum[-1] if self._cum else 0.0) + freed)
        self._next[slot] = k + 1
        if k + 1 < len(self._streams[slot]):
            nd, _ = self._streams[slot][k + 1]
            heapq.heappush(self._heap, (-nd, slot))
        return True

    def solve(self, counts: list[int]) -> bool:
        """Run this store's greedy to its fitting prefix; scatter per-item
        downgrade counts into the *global* ``counts`` array."""
        over = self.base_space - self.cap
        p = 0
        feasible = True
        if over > 0:
            while not self._cum or self._cum[-1] < over:
                if not self._extend():
                    feasible = False
                    break
            # cum is strictly increasing (every step frees space): the
            # shortest fitting prefix ends at the first entry >= over
            p = (bisect.bisect_left(self._cum, over) + 1 if feasible
                 else len(self._trace))
        for _, slot, _ in self._trace[:p]:
            counts[self.slots[slot]] += 1
        return feasible


class IncrementalWindow:
    """Exact incremental replay of the §4.3 greedy for a growing window.

    One independent :class:`_TierGreedy` per memory tier touched by the
    items (`WindowItem.tier`); the single-store behaviour — every item at
    tier 0 — is bit-identical to the pre-tier implementation.
    """

    def __init__(self, chip: ChipConfig, capacity: Optional[int] = None):
        self.chip = chip
        self.cap = capacity if capacity is not None \
            else chip.usable_sram_per_core
        self.items: list[WindowItem] = []
        self._tiers: dict[int, _TierGreedy] = {}

    @property
    def base_space(self) -> int:
        return sum(t.base_space for t in self._tiers.values())

    def _tier_state(self, tier: int) -> _TierGreedy:
        st = self._tiers.get(tier)
        if st is None:
            cap = (self.cap if tier <= 0
                   else self.chip.tier_capacity_per_core(tier))
            st = self._tiers[tier] = _TierGreedy(cap)
        return st

    def add_item(self, item: WindowItem) -> None:
        slot = len(self.items)
        self.items.append(item)
        self._tier_state(item.tier).add(item, slot)

    def solve_core(self) -> tuple:
        """Greedy result sans interconnect surcharge, cacheable by window
        signature: (feasible, per-slot choices, space, exec_t, dist_t,
        exec_noc_bytes)."""
        counts = [0] * len(self.items)
        feasible = True
        for tier in sorted(self._tiers):
            feasible &= self._tiers[tier].solve(counts)
        choices = []
        space = 0
        exec_t = dist_t = exec_noc = 0.0
        for slot, it in enumerate(self.items):
            ch = (it.fixed_choice if it.fixed else 0) + counts[slot]
            choices.append(ch)
            plan = it.plans[ch]
            space += plan.space
            if it.role == "exec":
                exec_t += plan.time
                exec_noc += plan.noc_exec_bytes
            else:
                dist_t += plan.dist_time
        return (feasible, tuple(choices), space, exec_t, dist_t, exec_noc)

    def solve(self, extra_preload_noc: float = 0.0) -> Allocation:
        return core_to_allocation(self.chip, self.items, self.solve_core(),
                                  extra_preload_noc)


def core_to_allocation(chip: ChipConfig, items: Sequence[WindowItem],
                       core: tuple, extra_preload_noc: float = 0.0
                       ) -> Allocation:
    """Finish a (possibly cached) greedy core into a full Allocation by
    folding in this window's preload-delivery surcharge."""
    feasible, choices, space, exec_t, dist_t, exec_noc = core
    by_op = {it.op_idx: ch for it, ch in zip(items, choices)}
    if not feasible:
        return Allocation(False, by_op, math.inf, math.inf, math.inf,
                          space, math.inf)
    noc_t = chip.noc_occupancy(exec_noc, extra_preload_noc)
    stall = max(0.0, noc_t - exec_t)
    return Allocation(True, by_op, exec_t, dist_t, noc_t, space,
                      exec_t + dist_t + stall)


def allocate(chip: ChipConfig, items: Sequence[WindowItem],
             capacity: Optional[int] = None,
             extra_preload_noc: float = 0.0) -> Allocation:
    win = IncrementalWindow(chip, capacity)
    for it in items:
        win.add_item(it)
    return win.solve(extra_preload_noc)


# ---------------------------------------------------------------------------
# Cross-tier source placement (DESIGN.md §10)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TierPlacement:
    """Where each layer weight block is sourced from, per memory tier."""
    tier_of: tuple                 # per-op index into chip.mem_tiers
    chains: tuple                  # per-tier steady serial preload chain (s)
    staged_bytes: tuple            # bytes resident per tier (0: sram/backing)
    noc_chain: float               # shared delivery-NoC serial floor (s)
    fill_time: float               # one-time refill backing -> staged tiers

    @property
    def bottleneck(self) -> float:
        return max(max(self.chains, default=0.0), self.noc_chain)


def place_tiers(chip: ChipConfig, ops: Sequence, cost=None, *,
                floor: float = 0.0) -> TierPlacement:
    """Assign each op's weight block a source tier (§4.3 generalized to N
    stores).

    Preloads from one tier are served sequentially by its controllers
    (paper §4.5), so the steady-state cost of a placement is the *longest
    per-tier serial chain* — each block contributing
    ``max(tier_time, noc_delivery)`` exactly as the schedule finalization
    charges it — with the shared core-delivery NoC as a global floor no
    promotion can beat.  ``floor`` (typically the execution-time chain)
    joins that max: staging a block onto a slower tier lengthens its own
    preload latency, so the greedy only moves blocks while the backing
    chain genuinely binds the steady interval.  Blocks are placed
    longest-first (LPT); each goes to the tier that minimizes the
    resulting bottleneck, staging tiers competing only while they have
    capacity left.  Ties keep the block in the backing store, so two-tier
    chips reproduce the flat placement exactly and the result is never
    worse than all-backing.
    """
    if cost is None:
        from repro_torch.core.cost_model import AnalyticCostModel
        cost = AnalyticCostModel(chip)
    tiers = chip.mem_tiers
    backing = chip.backing_tier
    staging = chip.staging_tiers
    n = len(ops)
    sizes = [int(getattr(op, "hbm_bytes", 0)) for op in ops]
    tier_of = [backing] * n
    chains = {k: 0.0 for k in (backing, *staging) if k > 0}
    pre_bw = chip.preload_noc_bw
    t_noc = [nbytes / pre_bw if pre_bw > 0 else 0.0 for nbytes in sizes]
    noc_chain = sum(t_noc)
    if staging and backing > 0:
        used = {k: 0 for k in staging}
        order = sorted((j for j in range(n) if sizes[j] > 0),
                       key=lambda j: (-sizes[j], j))
        for j in order:
            nbytes = sizes[j]
            best_k = backing
            best_val = max(floor, noc_chain, max(chains.values()),
                           chains[backing]
                           + max(cost.tier_time(nbytes, backing), t_noc[j]))
            for k in staging:
                if used[k] + nbytes > tiers[k].capacity:
                    continue
                val = max(floor, noc_chain, max(chains.values()),
                          chains[k] + max(cost.tier_time(nbytes, k), t_noc[j]))
                # strictly-better only: ties stay in the backing store (and
                # once the shared-NoC or execution floor dominates, nothing
                # is staged)
                if val < best_val * (1 - 1e-12):
                    best_k, best_val = k, val
            if best_k == backing:
                # Latency-free fallback: even when the bottleneck chain
                # cannot improve (execution-bound stage), moving a block to
                # a tier that serves it at least as fast still drains the
                # backing controller's queue sooner — the schedule's
                # preload stalls shrink and nothing can get worse, since
                # the block's own service time does not grow and the tier's
                # chain stays within the all-backing trajectory.
                svc_b = max(cost.tier_time(nbytes, backing), t_noc[j])
                best_svc = svc_b
                for k in staging:
                    if used[k] + nbytes > tiers[k].capacity:
                        continue
                    svc_k = max(cost.tier_time(nbytes, k), t_noc[j])
                    if (svc_k <= best_svc
                            and chains[k] + svc_k <= chains[backing] + svc_b):
                        best_k, best_svc = k, svc_k
            tier_of[j] = best_k
            chains[best_k] += max(cost.tier_time(nbytes, best_k), t_noc[j])
            if best_k != backing:
                used[best_k] += nbytes
    elif backing > 0:
        for j in range(n):
            if sizes[j] > 0:
                chains[backing] += max(cost.tier_time(sizes[j], backing),
                                       t_noc[j])
    staged = [0] * len(tiers)
    for j, k in enumerate(tier_of):
        if 0 < k < backing:
            staged[k] += sizes[j]
    fill = sum(cost.spill_time(staged[k], backing, k)
               for k in range(len(tiers)) if staged[k] > 0)
    chain_vec = [0.0] * len(tiers)
    for k, v in chains.items():
        chain_vec[k] = v
    return TierPlacement(tuple(tier_of), tuple(chain_vec),
                         tuple(staged), noc_chain, fill)
