"""Fleet-tier serving: an SLO-aware router over N pod-backed batchers.

Counterpart of ``src/repro/serve/fleet.py``.  One ``ContinuousBatcher``
schedules one pod; this module is the level above:

* a :class:`FleetRouter` owns the shared request queue and dispatches
  across N pods, each a ``ContinuousBatcher`` ticked **in lockstep on a
  common virtual clock**: every pod carries its own clock, the router
  always ticks the laggard, and each tick advances that pod's clock by a
  plan-derived cost (:class:`PodCosts`).  An N-pod fleet is simulated
  deterministically in one process, and fleet comparisons are scheduling
  deltas, not wall-clock noise.  The pods' passes run for real (on the
  card, through the port's kernels); only the time they are charged is
  virtual.
* pods carry **roles**: a ``prefill`` pod never decodes.  Its batcher's
  ``handoff`` hook hands every finished prefill (a host copy of the request
  cache + the first token) back to the router, which prices the move over
  the fleet tier (``FleetSpec.migration_time``: offload + inter-pod wire +
  refill) and ``adopt``s it into a ``decode`` pod once the transfer lands.
  ``mixed`` pods do both; a fleet of one mixed pod gives what driving the
  batcher directly gives (:func:`run_virtual_trace`).
* admission is **SLO-aware**: the router predicts TTFT per pod from its
  queue depth, chunk budget and tick costs (:meth:`FleetRouter.
  predict_ttft`, a deliberate over-estimate), routes to the pod minimizing
  it, and with a p99 target set **sheds** requests whose best predicted
  TTFT would violate it.

A migration's bytes are those of the request cache's tensors (``pos``, the
K/V ring, the int8 scales, ``slot_pos``, recurrent states), the leaves the
reference counts; they price the migration, so an equal count keeps the
whole schedule equal to the reference's.  The migrations are re-served by
``chip.simulator.simulate_fleet_traffic`` within 2x of the plan.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Optional, Sequence

from repro_torch.serve.batcher import (Completion, ContinuousBatcher, Request,
                                       _chunk_len, summarize)
from repro_torch.serve.engine import PREFILL_SAT, ServeEngine
from repro_torch.serve.prefix import state_bytes

ROLES = ("mixed", "prefill", "decode")


class VirtualClock:
    """A callable clock the router advances explicitly.  Batchers built
    on one read simulated seconds, so every timestamp they record
    (arrivals, TTFT, finishes) lives on the fleet's common timeline."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def prefill_passes(length: int, budget: int) -> int:
    """Scheduler ticks one prompt's chunked prefill takes: replays the
    batcher's power-of-two chunking exactly (``_chunk_len``)."""
    n, off = 0, 0
    budget = max(1, budget)
    while off < length:
        off += _chunk_len(length - off, budget)
        n += 1
    return n


@dataclasses.dataclass(frozen=True)
class PodCosts:
    """Virtual-time cost of one scheduler tick on one pod.

    ``decode_step_s`` is one weight pass: the pod's plan-derived steady
    decode interval.  A prefill chunk is priced as ``ceil(tokens /
    prefill_sat)`` weight passes: below the saturating token count a chunk
    is bandwidth-bound on the same weight traffic a decode step moves, so a
    16-token chunk and a 128-token chunk cost one pass each.
    ``tick_overhead_s`` is the fixed per-tick dispatch cost; ``spill_s``
    prices each charged ring move (``ServeConfig.slot_spill_s``).  These
    are the planner's figures for the modelled pod, not times taken on the
    card.
    """
    decode_step_s: float
    tick_overhead_s: float
    prefill_sat: int = PREFILL_SAT
    spill_s: float = 0.0

    def prefill_cost(self, tokens: int) -> float:
        if tokens <= 0:
            return 0.0
        passes = -(-tokens // max(self.prefill_sat, 1))
        return passes * self.decode_step_s

    def tick_cost(self, *, decoded: bool, prefill_tokens: int,
                  spill_moves: int = 0) -> float:
        return (self.tick_overhead_s
                + (self.decode_step_s if decoded else 0.0)
                + self.prefill_cost(prefill_tokens)
                + spill_moves * self.spill_s)

    @classmethod
    def from_serve_config(cls, scfg, *, default_decode_s: float = 1e-3,
                          overhead_frac: float = 0.5) -> "PodCosts":
        """Plan-derived costs: the hybrid pod plan's steady interval when
        the config carries one, a nominal decode quantum otherwise, with
        the fixed dispatch overhead a fraction of it."""
        d = scfg.steady_interval_s if scfg.steady_interval_s > 0 \
            else default_decode_s
        return cls(decode_step_s=d, tick_overhead_s=overhead_frac * d,
                   spill_s=scfg.slot_spill_s)


@dataclasses.dataclass
class FleetPod:
    """One pod's spec: its engine, role, and (optionally) explicit tick
    costs / batcher knobs.  The router builds the batcher so that it can
    wire the virtual clock and the migration hook."""
    engine: ServeEngine
    role: str = "mixed"
    costs: Optional[PodCosts] = None
    oversub: Optional[float] = None
    prefix_store: object = None
    swap_after: int = 4


@dataclasses.dataclass
class _Pod:
    index: int
    role: str
    batcher: ContinuousBatcher
    clock: VirtualClock
    costs: PodCosts


@dataclasses.dataclass
class _Migration:
    req: Request
    state: dict
    generated: list
    first_s: float
    admitted_s: float
    avail_s: float          # when the transfer lands on the target pod
    dst: int


class FleetRouter:
    """Two-level scheduler: the router admits and places requests, each
    pod's ``ContinuousBatcher`` schedules its own slots.

    ``fleet`` (a ``chip.topology.FleetSpec``) prices prefill->decode
    migrations; without one the wire leg is free and unrecorded.
    ``ttft_slo_s`` > 0 arms shedding.
    """

    def __init__(self, pods: Sequence[FleetPod], *, fleet=None,
                 ttft_slo_s: float = 0.0):
        if not pods:
            raise ValueError("FleetRouter needs at least one pod")
        for fp in pods:
            if fp.role not in ROLES:
                raise ValueError(f"unknown pod role {fp.role!r}; "
                                 f"known: {ROLES}")
        if all(fp.role == "decode" for fp in pods):
            raise ValueError("a fleet of only decode pods can never "
                             "prefill; add a prefill or mixed pod")
        if any(fp.role == "prefill" for fp in pods) and \
                not any(fp.role in ("decode", "mixed") for fp in pods):
            raise ValueError("prefill pods need a decode (or mixed) pod "
                             "to migrate to")
        if fleet is not None and fleet.num_pods != len(pods):
            raise ValueError(f"FleetSpec has {fleet.num_pods} pods, "
                             f"router has {len(pods)}")
        self.fleet = fleet
        self.ttft_slo_s = ttft_slo_s
        self.pods: list[_Pod] = []
        self._handoffs: list[tuple] = []
        for i, fp in enumerate(pods):
            clock = VirtualClock()
            handoff = self._make_handoff(i) if fp.role == "prefill" \
                else None
            bat = ContinuousBatcher(
                fp.engine, clock, oversub=fp.oversub,
                prefix_store=fp.prefix_store, swap_after=fp.swap_after,
                handoff=handoff)
            costs = fp.costs or PodCosts.from_serve_config(fp.engine.scfg)
            self.pods.append(_Pod(i, fp.role, bat, clock, costs))
        self.queue: deque[Request] = deque()
        self._migrating: list[_Migration] = []
        self.migration_events: list[tuple] = []   # (nbytes, at, src, dst)
        self.planned_migration_s = 0.0
        self.migrations = 0
        self.shed: list[Request] = []
        self.routed = [0] * len(pods)
        self.completed: list[Completion] = []

    # -- migration ---------------------------------------------------------
    def _make_handoff(self, src: int) -> Callable:
        def handoff(req, state, generated, first_s, admitted_s):
            self._handoffs.append((src, req, state, generated, first_s,
                                   admitted_s))
        return handoff

    def _pick_decode_pod(self) -> int:
        """Least-loaded migration target: decode pods first, mixed pods
        as fallback; load = in-flight streams (adoptions in transit
        included) per physical slot."""
        cands = [p for p in self.pods if p.role == "decode"] or \
            [p for p in self.pods if p.role == "mixed"]
        inbound = [0] * len(self.pods)
        for m in self._migrating:
            inbound[m.dst] += 1
        return min(cands, key=lambda p: (
            (len(p.batcher.active) + len(p.batcher.spilled)
             + inbound[p.index]) / max(p.batcher.slots, 1),
            p.clock.t, p.index)).index

    def _drain_handoffs(self) -> None:
        while self._handoffs:
            src, req, state, generated, first_s, admitted_s = \
                self._handoffs.pop(0)
            dst = self._pick_decode_pod()
            nbytes = state_bytes(state)
            t = self.pods[src].clock.t
            planned = self.fleet.migration_time(nbytes, src, dst) \
                if self.fleet is not None else 0.0
            self.planned_migration_s += planned
            self.migrations += 1
            if self.fleet is not None:
                self.migration_events.append((nbytes, t, src, dst))
            self._migrating.append(_Migration(
                req=req, state=state, generated=generated,
                first_s=first_s, admitted_s=admitted_s,
                avail_s=t + planned, dst=dst))

    def _deliver_migrations(self) -> None:
        for m in list(self._migrating):
            dp = self.pods[m.dst]
            if m.avail_s <= dp.clock.t + 1e-12:
                dp.batcher.adopt(m.req, m.state, m.generated, m.first_s,
                                 admitted_s=m.admitted_s)
                self._migrating.remove(m)

    # -- SLO-aware routing -------------------------------------------------
    def predict_ttft(self, index: int, prompt_len: int,
                     now: float) -> float:
        """Predicted TTFT of a request routed to pod ``index`` at
        ``now``: the pod's clock lag, plus one prefill pass-cost per
        chunked tick of the work queued ahead of it and of its own
        prompt.  Deliberately conservative: a pass on a mixed pod is
        priced with decode interference whenever the pod holds any work,
        so the prediction upper-bounds the realized TTFT and shedding
        against it keeps admitted p99 under the target."""
        p = self.pods[index]
        bat = p.batcher
        budget = bat.chunk_budget
        passes = prefill_passes(prompt_len, budget)
        ahead = sum(prefill_passes(len(r.prompt), budget)
                    for r in bat.queue)
        if bat.prefilling is not None:
            ahead += prefill_passes(
                len(bat.prefilling.req.prompt) - bat.prefilling.off,
                budget)
        holds_work = bool(bat.active or bat.spilled or bat.queue
                          or bat.prefilling)
        interfere = p.role == "mixed" and (holds_work or ahead > 0)
        pass_cost = p.costs.tick_cost(decoded=interfere,
                                      prefill_tokens=budget)
        return max(p.clock.t - now, 0.0) + (ahead + passes) * pass_cost

    def _route(self, now: float) -> None:
        while self.queue:
            req = self.queue.popleft()
            best, best_t = -1, float("inf")
            for p in self.pods:
                if p.role == "decode":
                    continue
                t = self.predict_ttft(p.index, len(req.prompt), now)
                if t < best_t - 1e-12:
                    best, best_t = p.index, t
            if self.ttft_slo_s > 0 and best_t > self.ttft_slo_s:
                self.shed.append(req)
                continue
            self.routed[best] += 1
            self.pods[best].batcher.submit(req)

    # -- the lockstep loop -------------------------------------------------
    @property
    def wall_s(self) -> float:
        return max(p.clock.t for p in self.pods)

    def run(self, requests: list[Request]) -> list[Completion]:
        """Replay an arrival trace across the fleet to completion.
        Returns the merged completions in global finish order (shed
        requests never complete; see ``self.shed``)."""
        pending = sorted(requests, key=lambda r: (r.arrival_s, r.rid))
        while pending or self.queue or self._migrating or \
                any(p.batcher.busy for p in self.pods):
            busy = [p for p in self.pods if p.batcher.busy]
            if busy:
                now = min(p.clock.t for p in busy)
            else:
                # fleet idle: jump to the next event on the timeline
                events = [m.avail_s for m in self._migrating]
                if pending:
                    events.append(pending[0].arrival_s)
                now = max(self.wall_s, min(events)) if events \
                    else self.wall_s
            for p in self.pods:       # idle pods ride the common clock
                if not p.batcher.busy and p.clock.t < now:
                    p.clock.t = now
            while pending and pending[0].arrival_s <= now + 1e-12:
                self.queue.append(pending.pop(0))
            self._route(now)
            self._deliver_migrations()
            busy = [p for p in self.pods if p.batcher.busy]
            if not busy:
                continue
            p = min(busy, key=lambda q: (q.clock.t, q.index))
            spills0 = len(p.batcher.spill_events)
            p.batcher.tick()
            p.clock.advance(p.costs.tick_cost(
                decoded=p.batcher.tick_decoded,
                prefill_tokens=p.batcher.tick_prefill_tokens,
                spill_moves=len(p.batcher.spill_events) - spills0))
            self._drain_handoffs()
        out = sorted((c for p in self.pods for c in p.batcher.completed),
                     key=lambda c: c.finish_s)
        for i, c in enumerate(out):
            c.finish_order = i
        self.completed = out
        return out

    def summary(self) -> dict:
        """Merged ``summarize`` over the fleet's virtual timeline plus
        the router-level signals (migrations, shedding, placement)."""
        stats = summarize(self.completed, self.wall_s) if self.completed \
            else {"requests": 0, "wall_s": round(self.wall_s, 4)}
        stats["pods"] = len(self.pods)
        stats["roles"] = [p.role for p in self.pods]
        stats["routed"] = list(self.routed)
        stats["migrations"] = self.migrations
        stats["planned_migration_s"] = round(self.planned_migration_s, 6)
        stats["shed"] = len(self.shed)
        return stats


def run_virtual_trace(batcher: ContinuousBatcher, requests: list[Request],
                      costs: PodCosts) -> list[Completion]:
    """Drive one ``ContinuousBatcher`` on the fleet's virtual clock: the
    single-pod reference a one-mixed-pod fleet must reproduce (same
    completions, same summary).  The batcher must have been built with a
    :class:`VirtualClock`; its ``t0`` is reset here."""
    clock = batcher.clock
    if not isinstance(clock, VirtualClock):
        raise TypeError("run_virtual_trace needs a batcher built on a "
                        "VirtualClock (ContinuousBatcher(eng, clock))")
    pending = sorted(requests, key=lambda r: (r.arrival_s, r.rid))
    batcher.t0 = clock()
    while pending or batcher.busy:
        now = clock() - batcher.t0
        if not batcher.busy and pending and pending[0].arrival_s > now:
            clock.t = batcher.t0 + pending[0].arrival_s
            now = pending[0].arrival_s
        while pending and pending[0].arrival_s <= now + 1e-12:
            batcher.submit(pending.pop(0))
        spills0 = len(batcher.spill_events)
        batcher.tick()
        clock.advance(costs.tick_cost(
            decoded=batcher.tick_decoded,
            prefill_tokens=batcher.tick_prefill_tokens,
            spill_moves=len(batcher.spill_events) - spills0))
    return batcher.completed


def predict_fleet_rates(costs: PodCosts, *, num_pods: int, n_prefill: int,
                        slots: int, prompt_len: int,
                        chunk_mixed: int = 16,
                        chunk_prefill: int = PREFILL_SAT) -> dict:
    """Closed-form rate model of the disaggregation trade (used by
    ``chip.dse.fleet_sweep``; not a simulator): steady generated-token rate
    and one prompt's prefill latency for ``num_pods`` mixed replicas vs an
    ``n_prefill``/``num_pods - n_prefill`` prefill/decode split, under the
    :class:`PodCosts` tick pricing."""
    if not 0 < n_prefill < num_pods:
        raise ValueError(f"need 0 < n_prefill < num_pods, got "
                         f"{n_prefill}/{num_pods}")
    o, d = costs.tick_overhead_s, costs.decode_step_s
    mixed_tick = o + d + costs.prefill_cost(chunk_mixed)
    mixed_passes = prefill_passes(prompt_len, chunk_mixed)
    pf_tick = o + costs.prefill_cost(chunk_prefill)
    pf_passes = prefill_passes(prompt_len, chunk_prefill)
    dec_tick = o + d
    n_dec = num_pods - n_prefill
    return {
        "mixed_gen_tok_s": num_pods * slots / mixed_tick,
        "mixed_prefill_s": mixed_passes * mixed_tick,
        "mixed_prefill_req_s": num_pods / (mixed_passes * mixed_tick),
        "disagg_gen_tok_s": n_dec * slots / dec_tick,
        "disagg_prefill_s": pf_passes * pf_tick,
        "disagg_prefill_req_s": n_prefill / (pf_passes * pf_tick),
    }
