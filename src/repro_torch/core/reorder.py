"""Preload order permutation (paper §4.4).

Reordering preloads (1) dodges interconnect "rush hours" and (2) shortens the
on-chip lifespan of large operators' preload footprints (Fig. 13).

Search space control, exactly as §4.4 prescribes:

* only **HBM-heavy** ops are reordered (tensor size above the layer average;
  the paper: 289 of OPT-30B's 2269 ops carry 99.8% of HBM volume);
* only **within one layer**; the same order is replayed across identical
  layers (LLMs are stacks of identical blocks);
* candidate orders are generated back-to-front as a **suffix tree** (Fig. 14):
  pick the last op to preload first; prune any branch whose co-resident set
  cannot fit on-chip (ops preloaded before a delayed op but executing after
  it must stay resident simultaneously);
* orders are additionally bounded by an **edit distance** derived from the
  free SRAM after minimal preload spaces are accounted.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

from repro_torch.chip.config import ChipConfig
from repro_torch.core.graph import OpGraph
from repro_torch.core.pipeline import CompileContext


def heavy_ops_in_layer(graph: OpGraph) -> list[int]:
    lo, hi = graph.layer_span
    return [i for i in range(lo, hi) if graph.hbm_heavy(i)]


def _min_preload_spaces(graph: OpGraph, chip: ChipConfig,
                        idxs: Sequence[int],
                        ctx: Optional[CompileContext] = None) -> dict[int, int]:
    ctx = ctx or CompileContext(chip)
    out = {}
    for i in idxs:
        op = graph.ops[i]
        ep = ctx.curves.exec_plans(op)[-1]            # smallest exec plan
        pp = ctx.curves.preload_plans(op, ep)[-1]     # smallest preload
        out[i] = pp.space
    return out


def valid_heavy_orders(graph: OpGraph, chip: ChipConfig,
                       max_orders: int = 720,
                       max_edit_distance: int | None = None,
                       ctx: Optional[CompileContext] = None,
                       ) -> Iterator[tuple[int, ...]]:
    """Yield valid permutations of layer-0's heavy ops (execution-order
    indices), via the Fig.-14 back-to-front suffix walk with capacity
    pruning."""
    heavy = heavy_ops_in_layer(graph)
    h = len(heavy)
    if h <= 1:
        yield tuple(heavy)
        return
    spaces = _min_preload_spaces(graph, chip, heavy, ctx)
    cap = chip.usable_sram_per_core

    if max_edit_distance is None:
        # §4.4: bound edit distance by available SRAM capacity — how many
        # average heavy preloads fit simultaneously.
        avg = max(sum(spaces.values()) // h, 1)
        free = max(cap - avg, 0)
        max_edit_distance = max(1, min(h, int(free // avg) + 1))

    exec_rank = {op: r for r, op in enumerate(heavy)}

    def co_resident_fits(order: tuple[int, ...]) -> bool:
        # order[m] = op preloaded at position m. Op executed at rank r whose
        # preload position is m > r forces ops with position < m and exec
        # rank > r to co-reside.  Approximate with a prefix-window check.
        for r, op in enumerate(heavy):
            m = order.index(op)
            resident = [o for o in order[:m + 1] if exec_rank[o] >= r]
            if sum(spaces[o] for o in resident) > cap:
                return False
        return True

    count = 0
    # back-to-front generation: choose last-to-preload first (Fig. 14)
    def gen(suffix: tuple[int, ...], remaining: frozenset[int]):
        nonlocal count
        if count >= max_orders:
            return
        if not remaining:
            order = tuple(reversed(suffix))
            if co_resident_fits(order):
                count += 1
                yield order
            return
        for op in sorted(remaining):
            # edit-distance prune: op's preload position would be
            # len(remaining)-1 .. check displacement vs its exec rank
            pos = len(remaining) - 1
            if abs(pos - exec_rank[op]) > max_edit_distance:
                continue
            # capacity prune (Fig. 14): ops that execute before `op` but are
            # forced to preload before it must co-reside with it
            later = [o for o in remaining if exec_rank[o] > exec_rank[op]]
            need = spaces[op] + sum(spaces[o] for o in later)
            if need > cap:
                continue
            yield from gen(suffix + (op,), remaining - {op})

    yield from gen(tuple(), frozenset(heavy))


def apply_heavy_order(graph: OpGraph, heavy_order: Sequence[int]) -> list[int]:
    """Expand a layer-0 heavy-op permutation into a full-model preload order:
    identity everywhere, with each identical layer's heavy slots permuted the
    same way (§4.4: 'applies the same order to identical layers')."""
    lo, hi = graph.layer_span
    span = hi - lo
    heavy0 = heavy_ops_in_layer(graph)
    if list(heavy_order) == heavy0 or not heavy0:
        return list(range(len(graph.ops)))
    # π[slot] = op: heavy preload SLOTS keep their positions, the op filling
    # each slot is permuted.  slot_off[j] holds slot offsets; src_off[j] the
    # op (offset) preloaded at that slot.
    slot_off = [h - lo for h in heavy0]
    src_off = [h - lo for h in heavy_order]
    # layer signature check: apply only to layers whose op names match layer 0
    names0 = [graph.ops[lo + k].name.split(".", 1)[-1] for k in range(span)]

    order = list(range(len(graph.ops)))
    base = lo
    while base + span <= len(graph.ops):
        names = [graph.ops[base + k].name.split(".", 1)[-1]
                 for k in range(span)]
        if names != names0:
            break
        for slot, src in zip(slot_off, src_off):
            order[base + slot] = base + src
        base += span
    return order


def best_reordered_plan(scheduler, graph: OpGraph, chip: ChipConfig,
                        max_orders: int = 64, design: str = "ELK-Full",
                        parallel: Optional[int] = None):
    """Try candidate preload orders, schedule each (§4.2 pass per §4.4),
    return the best plan.

    ``parallel`` > 1 farms candidate orders out to a process pool; each
    worker owns a private ``CompileContext`` (caches do not cross process
    boundaries) and the earliest-candidate-wins tie-break of the serial
    loop is preserved, so results are identical either way.
    """
    ctx = getattr(scheduler, "ctx", None)
    orders = [apply_heavy_order(graph, horder) for horder in
              valid_heavy_orders(graph, chip, max_orders=max_orders, ctx=ctx)]
    if parallel and parallel > 1 and len(orders) > 1 \
            and _pool_safe(scheduler):
        knobs = dict(max_preload=scheduler.max_preload,
                     exec_space_cap=scheduler.exec_space_cap,
                     static_preload_frac=scheduler.static_preload_frac,
                     exec_fastest=scheduler.exec_fastest)
        best = _parallel_best(graph, chip, orders, design, parallel, knobs)
        if best is not None:
            return best
    best = None
    for pi in orders:
        plan = scheduler.schedule(pi, design=design)
        if best is None or plan.total_time < best.total_time:
            best = plan
    if best is None:
        best = scheduler.schedule(design=design)
    return best


def _pool_safe(scheduler) -> bool:
    """Workers rebuild the scheduler from its knobs; a custom cost model
    would not survive the trip, so such schedulers stay on the serial path."""
    from repro_torch.core.cost_model import AnalyticCostModel
    return type(scheduler.cost) is AnalyticCostModel


def _eval_order_chunk(payload):
    """Worker: schedule a chunk of candidate orders with the caller's
    scheduler knobs, return the chunk's best plan and its global candidate
    index (for deterministic tie-breaks)."""
    from repro_torch.core.scheduler import Scheduler
    graph, chip, design, knobs, chunk = payload
    sched = Scheduler(graph, chip, **knobs)
    best = None
    for idx, pi in chunk:
        plan = sched.schedule(pi, design=design)
        if best is None or plan.total_time < best[1].total_time:
            best = (idx, plan)
    return best


def _parallel_best(graph, chip, orders, design, workers, knobs):
    """Evaluate candidate orders on a spawn pool; None on pool failure (the
    caller falls back to the serial loop).  Spawn, not fork: the parent has
    usually initialized multithreaded JAX, and forking it can deadlock a
    worker.  Workers only import the (numpy-level) scheduler stack, so the
    spawn cost is import-bounded and paid once per pool."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    workers = min(workers, len(orders))
    chunks = [[] for _ in range(workers)]
    for idx, pi in enumerate(orders):
        chunks[idx % workers].append((idx, pi))
    try:
        mp_ctx = mp.get_context("spawn")
    except ValueError:
        mp_ctx = None
    try:
        with ProcessPoolExecutor(max_workers=workers,
                                 mp_context=mp_ctx) as pool:
            results = list(pool.map(
                _eval_order_chunk,
                [(graph, chip, design, knobs, ch) for ch in chunks if ch]))
    except Exception:  # noqa: BLE001 — optional acceleration only: spawn
        # can fail in exotic parents (no importable __main__, exhausted
        # fds, BrokenProcessPool); the serial loop is always correct
        return None
    results = [r for r in results if r is not None]
    if not results:
        return None
    # serial loop keeps the earliest candidate on ties
    _, plan = min(results, key=lambda r: (r[1].total_time, r[0]))
    return plan
