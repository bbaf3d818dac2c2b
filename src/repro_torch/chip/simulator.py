"""Event-driven ICCA chip simulator (paper §5 "Simulation framework").

Simulates the execution of an ELK ``ExecutionPlan`` over contended
resources, independently of the scheduler's own cost estimates:

* **Memory tiers** — every off-core tier of ``chip.mem_tiers`` (HBM,
  stacked DRAM, ...) is its own contended resource serving *its* preloads
  one at a time in preload order (§4.5 rule 2, per controller group),
  gated by on-chip space and MoE routing deps; each request pays the
  tier's per-request latency.  A two-tier chip reduces to the single
  serial HBM server of the original model.
* **NoC** — processor-sharing fluid model over the topology's *link
  classes* (``chip.topo.classes``): flat topologies expose one
  ``intra`` pool; the hierarchical pod adds a slower ``inter`` tier.
  Each flow (preload delivery, data distribution, execution-time
  rotation) carries per-class weighted byte-hops from
  ``topo.flow_weights``; flows active on a class split that class's
  capacity, and a flow completes when *every* class it crosses has
  drained — congestion on one tier stretches only the flows that cross
  it (the paper's contention ②/③, now per tier).  Transfers additionally
  pay per-hop ``link_latency`` before bytes start flowing, matching the
  analytic cost model's ``volume/bw + hops*latency`` vocabulary.
* **Cores** — execute ops sequentially; an op's execute phase cannot run
  faster than its rotation traffic allows.  (Rotation *serial* latency is
  already inside ``ExecPlan.time`` via ``AnalyticCostModel.rot_time``, so
  the rotation flow charges contention only.)

Outputs everything Figures 17-24 read: total latency, the Fig-18(a)
four-way breakdown, HBM/NoC utilization, achieved TFLOPS.  The simulator
is also the DSE vehicle (§6.4): scale ``ChipConfig`` fields or swap the
topology and re-run.
"""

from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING, Optional

from repro_torch.chip.config import ChipConfig
from repro_torch.core.graph import OpGraph
from repro_torch.core.plan import (Breakdown, ExecutionPlan, OpTiming, Utilization)

if TYPE_CHECKING:
    from repro_torch.core.pipeline_pod import PipelinePlan

_EPS = 1e-12


@dataclasses.dataclass
class _Flow:
    kind: str               # "preload" | "dist" | "rot"
    rem: dict               # link-class name -> weighted byte-hops remaining
    demand: dict            # link-class name -> byte-hops/s drain-rate cap
    latency: float = 0.0    # per-hop pipeline-fill latency not yet elapsed

    def done(self) -> bool:
        return self.latency <= _EPS and all(v <= _EPS
                                            for v in self.rem.values())


@dataclasses.dataclass
class SimResult:
    total_time: float
    breakdown: Breakdown
    util: Utilization
    op_exec_end: list


def simulate(plan: ExecutionPlan, chip: ChipConfig,
             hbm_bw: Optional[float] = None) -> SimResult:
    graph = plan.graph
    n = len(graph.ops)
    hbm_bw = hbm_bw if hbm_bw is not None else chip.hbm_bw
    topo = chip.topo
    caps = {lc.name: lc.capacity for lc in topo.classes}
    cap_total = topo.total_capacity
    cap_mem = chip.usable_sram_per_core
    tiers = chip.mem_tiers
    last_tier = len(tiers) - 1

    pi = plan.preload_order
    dec = {d.op_idx: d for d in plan.decisions}

    def src_tier(j: int) -> int:
        k = dec[j].src_tier
        return k if 0 <= k <= last_tier else last_tier

    op_tiers = {src_tier(j) for j in range(n)}

    def mk_flow(kind: str, nbytes: float, payload_demand: float,
                latency: float) -> _Flow:
        weights = topo.flow_weights(kind)
        # zero-byte flows keep their class entries: an active phase occupies
        # its share of each class it maps onto until the phase completes
        # (processor-sharing semantics inherited from the single-pool model)
        rem = {c: nbytes * w for c, w in weights.items() if w > 0.0}
        # demand is in byte-hop units: a payload-bytes/s cap times the hop
        # weight of the class (so an uncontended transfer drains in
        # bytes/payload_demand seconds, matching the scheduler estimate)
        demand = {c: payload_demand * w for c, w in weights.items()
                  if w > 0.0}
        return _Flow(kind, rem, demand,
                     latency if nbytes > 0 else 0.0)

    # --- state ----------------------------------------------------------
    t = 0.0
    next_pre = 0                       # index into pi
    pre_done = [False] * n
    pre_started = [False] * n          # streaming on some tier server
    exe_done = [-1.0] * n
    space_used = 0.0
    cur = 0                            # next op to execute
    # one serial preload server per source tier (§4.5 rule 2 per
    # controller group); two-tier chips have exactly one server, the
    # original single-HBM state machine
    srv_op: dict[int, int] = {}        # tier -> op currently streaming
    srv_flow: dict[int, Optional[_Flow]] = {}   # NoC side of each preload
    srv_left: dict[int, float] = {}    # tier time remaining (s at full bw)
    exe_flow: Optional[_Flow] = None   # dist or rot flow of current op
    exe_left = 0.0                     # pure-compute seconds remaining
    exe_phase = "idle"                 # idle | dist | run
    # accounting
    busy_hbm = 0.0
    busy_exec = 0.0
    overlap = 0.0
    noc_bytes_served = 0.0

    def preload_space(j: int) -> float:
        p = dec[j].preload_plan
        return p.space if p else 0.0

    def exec_space(j: int) -> float:
        return dec[j].exec_plan.space

    def can_start_preload(j: int) -> bool:
        if graph.ops[j].preload_dep >= 0 and \
                exe_done[graph.ops[j].preload_dep] < 0:
            return False
        return space_used + preload_space(j) <= cap_mem + _EPS

    def tier_service_time(p, k: int) -> float:
        """Tier-side roofline of one preload request (per-request latency +
        volume at the tier's aggregate bandwidth; the ``hbm_bw`` argument
        still overrides the backing tier for DSE-style sweeps)."""
        if not (p and p.hbm_bytes) or k <= 0:
            return 0.0
        if k == last_tier and tiers[last_tier].unbounded:
            return (p.hbm_bytes / hbm_bw + chip.hbm_latency) if hbm_bw else 0.0
        tk = tiers[k]
        return (p.hbm_bytes / tk.bandwidth + tk.latency) if tk.bandwidth \
            else 0.0

    def start_next_preload(force: bool = False):
        nonlocal next_pre, space_used
        # each tier serves one preload at a time (§4.5 rule 2; clobbering a
        # streaming preload leaked its space and deadlocked the sim); scan
        # pi from the head so every tier picks *its* ops in preload order
        while next_pre < n and (pre_done[pi[next_pre]]
                                or pre_started[pi[next_pre]]):
            next_pre += 1
        if len(srv_op) >= len(op_tiers):
            return                     # every source tier already busy
        m = next_pre
        while m < n:
            j = pi[m]
            if pre_done[j] or pre_started[j]:
                m += 1
                continue
            if exe_done[j] >= 0:       # already executed (tiny op, no data)
                pre_done[j] = True
                if m == next_pre:
                    next_pre += 1
                m += 1
                continue
            k = src_tier(j)
            if k in srv_op:
                # this op's tier is busy; later ops on *other* tiers may
                # still start (their chains run in parallel)
                m += 1
                continue
            if not can_start_preload(j):
                # ``force`` models streaming-through under space pressure:
                # when the whole chip is otherwise stalled (execution waits
                # on this preload chain and nothing else is active), the
                # hardware streams the tile through space freed as the
                # blocking residents execute; the fluid accounting lets
                # ``space_used`` transiently exceed the cap instead of
                # wedging.  Routing deps are never forced.  Space is
                # claimed strictly in preload order: a space-blocked op
                # stops the scan for every tier.
                if not force or (graph.ops[j].preload_dep >= 0 and
                                 exe_done[graph.ops[j].preload_dep] < 0):
                    return
            p = dec[j].preload_plan
            srv_op[k] = j
            # per-request tier latency + volume roofline (bugfix: the seed
            # simulator never charged hbm_latency/link_latency at all)
            srv_left[k] = tier_service_time(p, k)
            nbytes = p.noc_preload_bytes if p else 0.0
            srv_flow[k] = mk_flow("preload", nbytes,
                                  topo.preload_delivery_bw,
                                  topo.preload_latency)
            space_used += preload_space(j)
            pre_started[j] = True
            if m == next_pre:
                next_pre += 1
            if force or len(srv_op) >= len(op_tiers):
                return
            m += 1

    def start_exec():
        nonlocal exe_flow, exe_left, exe_phase, space_used
        if cur >= n or exe_phase != "idle" or not pre_done[cur]:
            return
        d = dec[cur]
        p = d.preload_plan
        space_used += exec_space(cur) - (preload_space(cur))
        if p and p.noc_dist_bytes > 0:
            exe_phase = "dist"
            exe_flow = mk_flow("dist", p.noc_dist_bytes, math.inf,
                               topo.dist_latency)
        else:
            _enter_run()

    def _enter_run():
        nonlocal exe_phase, exe_flow, exe_left
        d = dec[cur]
        exe_phase = "run"
        exe_left = d.exec_plan.time
        rot = d.exec_plan.noc_exec_bytes
        exe_flow = mk_flow("rot", float(rot), math.inf, 0.0) if rot else None

    start_next_preload()
    start_exec()

    guard = 0
    while cur < n and guard < 400 * n + 20000:
        guard += 1
        if exe_phase == "idle" and not srv_op:
            # deadlock-or-done check: try to make progress
            start_next_preload()
            start_exec()
            if exe_phase == "idle" and not srv_op:
                # nothing active: advance by marking next preload done
                if next_pre >= n and cur < n and not pre_done[cur]:
                    pre_done[cur] = True     # defensive: zero-data op
                    start_exec()
                    continue
                if exe_phase == "idle" and next_pre < n:
                    # space-blocked with nothing draining: stream the next
                    # preload through (see start_next_preload)
                    start_next_preload(force=True)
                    if srv_op:
                        continue
                if exe_phase == "idle":
                    break

        # per-link-class processor sharing: every active phase occupies its
        # share of each class it maps onto for the phase's whole lifetime
        flows = [f for f in srv_flow.values() if f is not None]
        if exe_flow is not None:
            flows.append(exe_flow)
        nact: dict = {}
        for f in flows:
            for c in f.rem:
                nact[c] = nact.get(c, 0) + 1

        def rate(f: _Flow, c: str) -> float:
            return min(caps[c] / max(nact.get(c, 1), 1), f.demand[c])

        def flow_dt(f: Optional[_Flow]) -> float:
            if f is None or f.done():
                return 0.0
            drain = 0.0
            for c, v in f.rem.items():
                if v > _EPS:
                    drain = max(drain, v / rate(f, c))
            return f.latency + drain

        # time to next completion event
        dts = []
        for k in srv_op:
            dts.append(max(srv_left[k], flow_dt(srv_flow[k])))
        if exe_phase == "dist" and exe_flow:
            dts.append(flow_dt(exe_flow))
        elif exe_phase == "run":
            dts.append(max(exe_left, flow_dt(exe_flow)))
        if not dts:
            break
        dt = max(min(dts), 1e-9)

        # advance
        pre_active = bool(srv_op)
        exe_active = exe_phase != "idle"
        if pre_active and exe_active:
            overlap += dt
        elif pre_active:
            busy_hbm += dt
        elif exe_active:
            busy_exec += dt

        def advance(f: Optional[_Flow]) -> float:
            if f is None:
                return 0.0
            lat = min(f.latency, dt)
            f.latency -= lat
            eff = dt - lat
            served_total = 0.0
            if eff > 0:
                for c in list(f.rem):
                    v = f.rem[c]
                    if v <= _EPS:
                        continue
                    served = min(v, rate(f, c) * eff)
                    f.rem[c] = v - served
                    served_total += served
            return served_total

        for k in srv_op:
            srv_left[k] = max(0.0, srv_left[k] - dt)
            noc_bytes_served += advance(srv_flow[k])
        if exe_active:
            noc_bytes_served += advance(exe_flow)
        if exe_phase == "run":
            exe_left = max(0.0, exe_left - dt)
        t += dt

        # completions
        finished = [k for k in srv_op
                    if srv_left[k] <= _EPS and (srv_flow[k] is None
                                                or srv_flow[k].done())]
        for k in finished:
            pre_done[srv_op[k]] = True
            del srv_op[k], srv_flow[k], srv_left[k]
        if finished:
            start_next_preload()
        if exe_phase == "dist" and exe_flow and exe_flow.done():
            _enter_run()
        elif exe_phase == "run" and exe_left <= _EPS and (
                exe_flow is None or exe_flow.done()):
            exe_done[cur] = t
            space_used = max(0.0, space_used - exec_space(cur))
            exe_phase, exe_flow = "idle", None
            cur += 1
            start_next_preload()
            start_exec()

    total = t
    flops = sum(op.flops for op in graph.ops)
    hbm_bytes = sum((dec[j].preload_plan.hbm_bytes
                     if dec[j].preload_plan else 0) for j in range(n))
    util = Utilization(
        hbm=min(hbm_bytes / (hbm_bw * total), 1.0) if (hbm_bw and total)
        else 0.0,
        interconnect=min(noc_bytes_served / (cap_total * total), 1.0)
        if total else 0.0,
        flops=min(flops / (chip.total_flops * total), 1.0) if total else 0.0,
        achieved_tflops=flops / total / 1e12 if total else 0.0,
    )
    idle = max(0.0, total - busy_hbm - busy_exec - overlap)
    breakdown = Breakdown(preload_only=busy_hbm, execute_only=busy_exec,
                          overlapped=overlap, interconnect_stall=idle)
    return SimResult(total, breakdown, util, exe_done)


# ---------------------------------------------------------------------------
# pipeline-parallel pod simulation (DESIGN.md §7)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PipelineSimResult:
    total_time: float              # last microbatch leaves the last stage
    interval: float                # steady per-microbatch completion period
    fill_time: float               # first microbatch end-to-end
    stage_intervals: list          # per-stage steady interval (event-sim)
    microbatch_end: list           # per-microbatch completion times


def _tile_plan(plan: ExecutionPlan, copies: int) -> ExecutionPlan:
    """Concatenate ``copies`` repetitions of a stage plan into one plan:
    running it through the event simulator models a stage serving
    back-to-back microbatches, where copy ``c+1``'s preloads overlap copy
    ``c``'s execution under the same per-link-class contention the
    single-pass simulation uses."""
    g = plan.graph
    n = len(g.ops)
    ops = []
    for c in range(copies):
        for op in g.ops:
            if op.preload_dep >= 0:
                op = dataclasses.replace(op, preload_dep=op.preload_dep
                                         + c * n)
            ops.append(op)
    graph = OpGraph(g.model, g.phase, tuple(ops), g.layer_span,
                    g.num_layers * copies)
    order = [c * n + j for c in range(copies) for j in plan.preload_order]
    decs = [dataclasses.replace(d, op_idx=c * n + d.op_idx)
            for c in range(copies) for d in plan.decisions]
    timing = [OpTiming() for _ in ops]
    return ExecutionPlan(graph, plan.chip_name, plan.design, decs, order,
                         timing, 0.0, Breakdown(), Utilization())


def simulate_pipeline(pplan: "PipelinePlan", chip: ChipConfig,
                      microbatches: Optional[int] = None
                      ) -> PipelineSimResult:
    """Event-simulate a :class:`PipelinePlan`: every stage runs its
    microbatch stream on a member chip (``chip_view()``) with the
    per-link-class contention machinery, and inter-stage activation
    transfers cross the inter-chip tier — serialized per boundary (each
    boundary is the sending chip's own gateway links on ``hier_pod``; a
    bisection share on flat pools), so a slow tier backs the pipeline up
    exactly like any other contended resource.

    Stage plans must be exact (non-extrapolated): truncate the model before
    planning when simulating deep stacks, as the DSE sweeps do.

    Hybrid stages (DESIGN.md §9): a stage with tensor-parallel ``width``
    re-prices its intra-stage collectives from the plan's ``(kind, bytes)``
    descriptors through ``chip.topo.collective_time`` — the simulator's own
    view of the link tiers, not the planner's number — and serializes them
    at the end of each microbatch's service (ring steps synchronize every
    member chip, so they cannot overlap the next microbatch's compute).  A
    stage with ``replicas`` copies round-robins its microbatch stream over
    that many servers.  Width-1, replica-1 stages are bit-identical to the
    pure-pipeline composition.
    """
    view = chip.chip_view()
    M = microbatches if microbatches is not None else pplan.microbatches
    M = max(M, 1)
    for st in pplan.stages:
        if st.plan.extrapolated_from_layers:
            raise ValueError(
                "simulate_pipeline needs exact stage plans; plan a layer "
                "truncation of the model for simulation (stage "
                f"{st.index} extrapolated from "
                f"{st.plan.extrapolated_from_layers} layers)")
    # a one-stage single-chip plan was compiled against the whole pod
    # (degenerate path); everything else against the member chip view
    one = len(pplan.stages) == 1 and pplan.stages[0].chips == 1
    member = chip if one else view.chip
    # replicated stages bunch completions within one round, so their steady
    # cadence only shows over a second decode round (gated on the real
    # token dependency: a group re-enters stage 0 after its previous round
    # left the last stage).  Pure-pipeline plans keep the one-round path.
    cycles = 2 if any(st.replicas > 1 for st in pplan.stages) else 1
    Mt = M * cycles
    # per-stage microbatch completion times under intra-chip contention
    ends = []
    for st in pplan.stages:
        n = len(st.plan.graph.ops)
        res = simulate(_tile_plan(st.plan, Mt), member)
        ends.append([res.op_exec_end[(c + 1) * n - 1] for c in range(Mt)])
    # intra-stage collective time per microbatch, re-priced by the pod topo
    colls = [sum(chip.topo.collective_time(kind, b, st.width)
                 for kind, b in st.collectives) if st.width > 1 else 0.0
             for st in pplan.stages]
    # compose stages: microbatch m enters stage s after its predecessor on
    # the same stage finishes and after its own activation arrives over the
    # boundary (sends on one boundary are serialized in microbatch order)
    S = len(pplan.stages)
    t = [[0.0] * Mt for _ in range(S)]
    for s in range(S):
        durs = [ends[s][0]] + [ends[s][c] - ends[s][c - 1]
                               for c in range(1, Mt)]
        r = max(pplan.stages[s].replicas, 1)
        free = [0.0] * r               # r data-parallel servers round-robin
        send_prev_end = 0.0
        for m in range(Mt):
            if s == 0:
                # round 2 of a group waits for its round-1 sampled token
                arrive = t[S - 1][m - M] if m >= M else 0.0
            else:
                start = max(t[s - 1][m], send_prev_end)
                send_prev_end = start + pplan.stages[s - 1].send_time
                arrive = send_prev_end
            prev = t[s][m - 1] if m else 0.0
            done = max(arrive, free[m % r]) + durs[m] + colls[s]
            # keep handoffs in microbatch order for the next boundary
            free[m % r] = t[s][m] = max(done, prev)
    out = t[S - 1]
    if cycles > 1:
        # steady per-microbatch cadence across the second round
        interval = (out[Mt - 1] - out[M - 1]) / M
        stage_ivals = [(e[Mt - 1] - e[M - 1]) / M for e in ends]
    else:
        interval = ((out[M - 1] - out[0]) / (M - 1)) if M > 1 else out[0]
        stage_ivals = [((e[M - 1] - e[0]) / (M - 1)) if M > 1 else e[0]
                       for e in ends]
    return PipelineSimResult(out[Mt - 1], interval, out[0], stage_ivals, out)


# ---------------------------------------------------------------------------
# KV offload traffic (serve-side spills, DESIGN.md §11)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KVTrafficResult:
    total_time: float        # completion of the last transfer
    busy: dict               # tier index -> busy seconds on its server
    finish: list             # per-event completion times, input order


def simulate_kv_traffic(chip: ChipConfig, events, *, src: int = 0,
                        dst: Optional[int] = None) -> KVTrafficResult:
    """Serve the batcher's KV spill/refill events on the per-tier serial
    resources this simulator already models (§4.5 rule 2: one transfer at
    a time per off-core tier).

    ``events`` is ``ContinuousBatcher.spill_events``-shaped: ``(kind,
    nbytes)`` or ``(kind, nbytes, at)`` with ``at`` the earliest start
    time.  Every transfer moves one slot's ring between tier ``src``
    (default: the cores' SRAM) and ``dst`` (default: the chip's backing
    tier) and holds each *off-core* endpoint's server for
    ``AnalyticCostModel.spill_time`` — the identical pricing vocabulary
    the planner's ``ServeConfig.slot_spill_s`` uses, so plan-vs-sim
    agreement is a consistency gate (CI ``kvoffload-smoke``), with the
    simulator adding only the serialization a shared tier imposes."""
    from repro_torch.core.cost_model import AnalyticCostModel

    cm = AnalyticCostModel(chip)
    if dst is None:
        dst = chip.backing_tier
    free: dict = {}
    busy: dict = {}
    finish = []
    for ev in events:
        kind, nbytes = ev[0], ev[1]
        at = float(ev[2]) if len(ev) > 2 else 0.0
        svc = cm.spill_time(nbytes, src, dst)
        start = max([at] + [free.get(t, 0.0) for t in (src, dst) if t > 0])
        end = start + svc
        for t in (src, dst):
            if t > 0:
                free[t] = end
                busy[t] = busy.get(t, 0.0) + svc
        finish.append(end)
    return KVTrafficResult(total_time=max(finish, default=0.0), busy=busy,
                           finish=finish)


def simulate_fleet_traffic(fleet, events) -> KVTrafficResult:
    """Re-serve a fleet router's KV migrations (DESIGN.md §12) on serial
    servers, one tier further up than :func:`simulate_kv_traffic`.

    ``events`` is ``FleetRouter.migration_events``-shaped: ``(nbytes, at,
    src_pod, dst_pod)`` per migration.  Each migration is three chained
    legs — offload on the source pod's backing tier, the inter-pod wire,
    refill on the destination pod's backing tier — priced exactly as the
    plan's ``FleetSpec.migration_time`` (same ``spill_time`` +
    ``transfer_time`` vocabulary), with the simulator adding only the
    serialization shared resources impose: one transfer at a time per pod
    backing tier (§4.5 rule 2 again) and one at a time on the fleet link.
    ``busy`` keys are ``("pod", i)`` for pod ``i``'s backing tier and
    ``"fleet"`` for the inter-pod link."""
    from repro_torch.core.cost_model import AnalyticCostModel

    cms = [AnalyticCostModel(p) for p in fleet.pods]
    free: dict = {}
    busy: dict = {}
    finish = []
    for nbytes, at, src, dst in events:
        off = cms[src].spill_time(nbytes, 0, fleet.pods[src].backing_tier)
        wire = fleet.transfer_time(nbytes)
        ref = cms[dst].spill_time(nbytes, 0, fleet.pods[dst].backing_tier)
        t0 = max(float(at), free.get(("pod", src), 0.0))
        t1 = max(t0 + off, free.get("fleet", 0.0))
        t2 = max(t1 + wire, free.get(("pod", dst), 0.0))
        end = t2 + ref
        free[("pod", src)] = t0 + off
        free["fleet"] = t1 + wire
        free[("pod", dst)] = end
        busy[("pod", src)] = busy.get(("pod", src), 0.0) + off
        busy["fleet"] = busy.get("fleet", 0.0) + wire
        busy[("pod", dst)] = busy.get(("pod", dst), 0.0) + ref
        finish.append(end)
    return KVTrafficResult(total_time=max(finish, default=0.0), busy=busy,
                           finish=finish)
