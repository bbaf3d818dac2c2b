"""Continuous-batching request scheduler over the slot-batched engine.

Counterpart of ``src/repro/serve/batcher.py``.  The lock-step
``ServeEngine.generate`` path serves one static batch: every request waits
for batch formation, prefills together, and decodes until the *slowest*
request finishes.  This module schedules at request granularity instead:

* a request **queue** admits work as it arrives;
* requests **prefill in chunks** (at most ``ServeConfig.prefill_chunk``
  tokens per scheduler tick, clamped to the cache capacity, in powers of
  two), interleaved with decode steps of the running batch;
* a prefilled request is **spliced into a free slot** of the engine's
  per-slot cache and decodes alongside whatever else is running;
* a finished request **leaves its slot immediately** -- the next queued
  request takes it over while the others keep decoding.

With a backing tier (``ServeConfig.oversub`` = K > 1, or ``oversub=``
given) the batcher **oversubscribes**: up to K x the physical slot count
may be in flight.  Requests admitted while every slot is busy prefill
*ahead* into a slotless cache and park offloaded (a host copy: host memory
is the backing tier); a refill-ahead hook moves the longest-waiting
spilled request into each slot the moment it frees, and an LRU policy over
decode recency (residency-age tiebreak) swaps a long-running resident out
for a starving waiter.  Each move is priced at ``ServeConfig.slot_spill_s``
and recorded in ``spill_events`` so that ``chip.simulator.
simulate_kv_traffic`` can re-price the same traffic.  Offload and refill
copy the slot state exactly, so oversubscribed greedy output equals
running each request alone.  A ``PrefixStore`` (``serve/prefix.py``)
given, or funded by the plan, snapshots the request cache at every chunk
boundary of a prefill and restores the longest stored prefix of a new
prompt at admission.

The decode hot loop is one ``engine.step`` per tick regardless of how
requests come and go.  Greedy outputs equal running each request alone.
Two hooks serve the fleet (``serve/fleet.py``): with ``handoff`` given, a
request that finishes its prefill leaves as a host copy of its request
cache and its first token instead of decoding here (a prefill pod), and
``adopt`` takes such a request over mid-stream (a decode pod); each tick
records the prompt tokens it prefilled and whether it decoded, which the
fleet's virtual clock prices.  ``make_trace`` and ``summarize`` are
numpy-only and give what the reference's give for equal arguments.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.prefix import PrefixStore, host_copy


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (S0,) int32 token ids
    max_new_tokens: int
    arrival_s: float = 0.0        # offset from trace start
    tenant: int = 0               # multi-tenant traces: which arrival
    #                               stream this request came from


@dataclasses.dataclass
class Completion:
    rid: int
    tokens: np.ndarray            # (S0 + max_new_tokens,)
    prompt_len: int
    arrival_s: float
    finish_s: float
    finish_order: int
    first_token_s: float = -1.0   # when the first new token appeared
    #                               (-1: degenerate request, no token)
    admitted_s: float = -1.0      # when the request left the queue and
    #                               its prefill began (-1: unknown)

    @property
    def latency_s(self) -> float:
        return self.finish_s - self.arrival_s

    @property
    def ttft_s(self) -> float:
        """Time to first token."""
        if self.first_token_s < 0:
            return self.latency_s
        return self.first_token_s - self.arrival_s

    @property
    def queue_wait_s(self) -> float:
        """Seconds spent queued before admission."""
        if self.admitted_s < 0:
            return 0.0
        return max(self.admitted_s - self.arrival_s, 0.0)


@dataclasses.dataclass
class _Prefill:
    req: Request
    cache: dict
    off: int                      # prompt tokens already processed
    slot: int                     # reserved destination slot (-1: prefill
    #                               ahead, will park offloaded)


@dataclasses.dataclass
class _Active:
    req: Request
    generated: list
    first_s: float = -1.0         # first-token time (from trace start)
    last_step: int = 0            # tick of the slot's last decode step
    since: int = 0                # tick the request became resident


@dataclasses.dataclass
class _Spilled:
    """A request whose KV ring lives on the backing tier: either prefilled
    ahead of any free slot or swapped out mid-decode by the LRU policy."""
    req: Request
    generated: list
    pending: int                  # next token to feed after refill
    state: dict                   # host-resident slot state (real copies)
    first_s: float
    spilled_at: int               # tick it left (or never entered) a slot
    last_step: int                # decode recency carried across the spill


def _chunk_len(remaining: int, budget: int) -> int:
    """Largest power of two <= min(remaining, budget): bounds the set of
    chunk shapes to O(log budget) for arbitrary prompt lengths."""
    t = 1
    while t * 2 <= min(remaining, budget):
        t *= 2
    return t


class ContinuousBatcher:
    """Drives a ``ServeEngine`` in slot-batched mode.

    ``submit`` enqueues requests; each ``tick`` performs (at most) one
    admission, one prefill chunk, and one decode step over the running
    slots.  ``run`` replays a whole arrival trace to completion.
    """

    def __init__(self, engine: ServeEngine,
                 clock: Callable[[], float] = time.perf_counter, *,
                 oversub: Optional[float] = None,
                 prefix_store: Optional[PrefixStore] = None,
                 swap_after: int = 4, handoff: Optional[Callable] = None):
        self.engine = engine
        self.slots = engine.scfg.slots
        # a chunk larger than the cache capacity would wrap a request's
        # own ring mid-chunk; clamp whatever the config asked for
        self.chunk_budget = max(1, min(engine.scfg.prefill_chunk,
                                       engine.scfg.cache_capacity))
        # oversubscription: K from the plan unless the caller pins it; K=1
        # is the slot-capped scheduler exactly
        self.oversub = engine.scfg.oversub if oversub is None else oversub
        self.virtual_slots = max(self.slots,
                                 int(round(self.slots * self.oversub)))
        self.swap_after = max(1, swap_after)
        # the plan-funded store rides along with oversubscription; a K=1
        # batcher has none unless the caller hands it one
        if prefix_store is None and self.oversub > 1.0 \
                and engine.scfg.prefix_cache_bytes > 0:
            prefix_store = PrefixStore(engine.scfg.prefix_cache_bytes)
        self.prefix = prefix_store
        # fleet migration hook: when set, a request that finishes prefill
        # is handed off (host state + first token) to the router instead of
        # decoding here (a prefill pod)
        self.handoff = handoff
        self.clock = clock
        self.queue: deque[Request] = deque()
        self.prefilling: Optional[_Prefill] = None
        self.active: dict[int, _Active] = {}
        self.spilled: dict[int, _Spilled] = {}      # rid -> parked state
        self.free = list(range(self.slots))[::-1]   # pop() -> lowest slot
        self.tokens = np.zeros((self.slots,), np.int32)
        self.completed: list[Completion] = []
        self.ticks = 0
        self.decode_ticks = 0
        self.spill_events: list[tuple[str, int]] = []   # (kind, nbytes)
        self.planned_spill_s = 0.0
        self.prefix_hits = 0
        self.prefix_tokens_saved = 0
        self._ring_bytes = 0
        self._admitted: dict[int, float] = {}   # rid -> admission time
        # what this tick did, read by the fleet's virtual clock to price it
        # (reset at the top of every tick)
        self.tick_prefill_tokens = 0
        self.tick_decoded = False
        self.t0 = self.clock()

    # -- scheduling --------------------------------------------------------
    def submit(self, req: Request) -> None:
        if len(req.prompt) == 0:
            raise ValueError(f"request {req.rid}: empty prompt (the first "
                             "generated token is seeded by prefill)")
        self.queue.append(req)

    @property
    def busy(self) -> bool:
        return bool(self.queue or self.prefilling or self.active
                    or self.spilled)

    def _now(self) -> float:
        return self.clock() - self.t0

    def _finish(self, req: Request, new_tokens: list,
                first_s: float = -1.0) -> None:
        toks = np.concatenate([np.asarray(req.prompt, np.int32),
                               np.asarray(new_tokens, np.int32)])
        self.completed.append(Completion(
            rid=req.rid, tokens=toks, prompt_len=len(req.prompt),
            arrival_s=req.arrival_s, finish_s=self._now(),
            finish_order=len(self.completed), first_token_s=first_s,
            admitted_s=self._admitted.pop(req.rid, -1.0)))

    def _charge(self, kind: str) -> None:
        """Record one ring move across the tier boundary, accumulating the
        plan-priced cost (the simulator re-prices the same event list)."""
        if not self._ring_bytes:
            self._ring_bytes = self.engine.slot_state_bytes()
        self.spill_events.append((kind, self._ring_bytes))
        self.planned_spill_s += self.engine.scfg.slot_spill_s

    def _admit(self) -> None:
        while self.queue and self.queue[0].max_new_tokens <= 0:
            req = self.queue.popleft()
            self._admitted[req.rid] = self._now()
            self._finish(req, [])
        if self.prefilling is not None or not self.queue:
            return
        inflight = len(self.active) + len(self.spilled)
        if self.free:
            slot = self.free.pop()
        elif self.oversub > 1.0 and inflight < self.virtual_slots:
            slot = -1       # prefill ahead; the finished ring parks spilled
        else:
            return
        req = self.queue.popleft()
        self._admitted[req.rid] = self._now()
        cache, off = None, 0
        if self.prefix is not None:
            hit = self.prefix.lookup(
                req.prompt, max_len=min(len(req.prompt) - 1,
                                        self.engine.scfg.cache_capacity))
            if hit is not None:
                off, state = hit
                # restore = one refill off the backing tier, into a fresh
                # cache: the stored state stays as it is
                cache = self.engine.load_request_cache(state)
                self._charge("refill")
                self.prefix_hits += 1
                self.prefix_tokens_saved += off
        if cache is None:
            cache = self.engine.new_request_cache()
        self.prefilling = _Prefill(req=req, cache=cache, off=off, slot=slot)

    def _prefill_tick(self) -> None:
        ps = self.prefilling
        if ps is None:
            return
        t = _chunk_len(len(ps.req.prompt) - ps.off, self.chunk_budget)
        chunk = torch.from_numpy(np.ascontiguousarray(
            ps.req.prompt[None, ps.off:ps.off + t], dtype=np.int64))
        tok, ps.cache = self.engine.prefill_chunk(ps.cache, chunk)
        ps.off += t
        self.tick_prefill_tokens = t
        if ps.off < len(ps.req.prompt):
            # snapshot at the chunk boundary: a strict in-capacity prefix
            # whose ring has never wrapped, the prefix store's unit of reuse
            if (self.prefix is not None
                    and ps.off <= self.engine.scfg.cache_capacity):
                self.prefix.put(ps.req.prompt[:ps.off], host_copy(ps.cache))
            return
        first = int(tok[0])
        now = self._now()
        if ps.req.max_new_tokens == 1:      # no decode needed
            self._finish(ps.req, [first], first_s=now)
            if ps.slot >= 0:
                self.free.append(ps.slot)
        elif self.handoff is not None:
            # prefill pod: the finished prefill leaves for a decode pod as a
            # host copy of its request cache (one charged offload); the slot
            # is free only once the copy is taken
            state = host_copy(ps.cache)
            self._charge("spill")
            if ps.slot >= 0:
                self.free.append(ps.slot)
            self.handoff(ps.req, state, [first], now,
                         self._admitted.pop(ps.req.rid, -1.0))
        elif ps.slot >= 0:
            self.engine.insert_slot(ps.slot, ps.cache)
            self.active[ps.slot] = _Active(
                req=ps.req, generated=[first], first_s=now,
                last_step=self.ticks, since=self.ticks)
            self.tokens[ps.slot] = first
        else:
            # prefilled ahead of any free slot: park on the backing tier
            self.spilled[ps.req.rid] = _Spilled(
                req=ps.req, generated=[first], pending=first,
                state=host_copy(ps.cache), first_s=now,
                spilled_at=self.ticks, last_step=self.ticks)
            self._charge("spill")
        self.prefilling = None

    def _lru_waiter(self) -> int:
        """rid of the spilled request to refill next: least-recently
        decoded, then longest parked."""
        return min(self.spilled,
                   key=lambda r: (self.spilled[r].last_step,
                                  self.spilled[r].spilled_at, r))

    def _maybe_swap(self) -> None:
        """LRU eviction over decode recency: when a spilled request has
        waited >= ``swap_after`` ticks and no slot is free, offload the
        least-recently-stepped resident (ties: longest resident) so the
        waiter gets its turn -- time-slicing K virtual streams over the
        physical slots without starving any of them."""
        if self.free or not self.spilled or not self.active:
            return
        sp = self.spilled[self._lru_waiter()]
        if self.ticks - sp.spilled_at < self.swap_after:
            return
        victim = min(self.active,
                     key=lambda s: (self.active[s].last_step,
                                    self.active[s].since, s))
        va = self.active[victim]
        if self.ticks - va.since < self.swap_after:
            return          # every resident is fresher than one timeslice
        state = self.engine.offload_slot(victim)
        self._charge("spill")
        self.spilled[va.req.rid] = _Spilled(
            req=va.req, generated=va.generated,
            pending=int(self.tokens[victim]), state=state,
            first_s=va.first_s, spilled_at=self.ticks,
            last_step=va.last_step)
        del self.active[victim]
        self.free.append(victim)

    def _refill_tick(self) -> None:
        """Refill-ahead: spilled requests take freed slots before any new
        admission -- a refill resumes decode this very tick, while a fresh
        admission still has its whole prefill in front of it."""
        self._maybe_swap()
        while self.free and self.spilled:
            sp = self.spilled.pop(self._lru_waiter())
            slot = self.free.pop()
            self.engine.refill_slot(slot, sp.state)
            self._charge("refill")
            self.active[slot] = _Active(
                req=sp.req, generated=sp.generated, first_s=sp.first_s,
                last_step=self.ticks, since=self.ticks)
            self.tokens[slot] = sp.pending

    def _decode_tick(self) -> None:
        if not self.active:
            return
        self.decode_ticks += 1
        self.tick_decoded = True
        nxt = self.engine.step(torch.from_numpy(
            self.tokens.astype(np.int64))).cpu().numpy().astype(np.int32)
        self.tokens = nxt.copy()
        for slot in sorted(self.active):
            st = self.active[slot]
            st.last_step = self.ticks
            st.generated.append(int(nxt[slot]))
            if len(st.generated) >= st.req.max_new_tokens:
                self._finish(st.req, st.generated, first_s=st.first_s)
                self.engine.evict_slot(slot, keep=False)
                del self.active[slot]
                self.free.append(slot)

    def tick(self) -> None:
        """One scheduler step: refill spilled work into freed slots, admit,
        advance one prefill chunk, decode."""
        self.tick_prefill_tokens = 0
        self.tick_decoded = False
        self._refill_tick()
        self._admit()
        self._prefill_tick()
        self._decode_tick()
        self.ticks += 1

    def adopt(self, req: Request, state: dict, generated: list,
              first_s: float, *, admitted_s: float = -1.0) -> None:
        """Take over a request mid-stream (fleet migration).

        ``state`` is a host slot state (another pod's ``handoff`` payload
        or an ``offload_slot`` result); it parks on this pod's backing tier
        and the refill-ahead path puts it into the next free slot, at any K
        (the refill is charged there; the offload was charged where the
        state came from).  ``generated`` must hold at least the prefill's
        first token: its last entry is the next token to feed."""
        if not generated:
            raise ValueError(f"request {req.rid}: nothing generated yet -- "
                             "adopt() resumes a stream, prefill seeds it")
        self._admitted[req.rid] = admitted_s
        self.spilled[req.rid] = _Spilled(
            req=req, generated=list(generated),
            pending=int(generated[-1]), state=state, first_s=first_s,
            spilled_at=self.ticks, last_step=self.ticks)

    # -- trace replay ------------------------------------------------------
    def run(self, requests: list[Request]) -> list[Completion]:
        """Replay an arrival trace to completion; returns completions in
        finish order (not arrival order)."""
        pending = sorted(requests, key=lambda r: (r.arrival_s, r.rid))
        self.t0 = self.clock()
        while pending or self.busy:
            now = self.clock() - self.t0
            while pending and pending[0].arrival_s <= now:
                self.submit(pending.pop(0))
            if not self.busy:
                time.sleep(min(pending[0].arrival_s - now, 0.01))
                continue
            self.tick()
        return self.completed


# ---------------------------------------------------------------------------
# static-batching baseline + trace tooling (shared by bench and launcher)
# ---------------------------------------------------------------------------

def run_static_trace(engine: ServeEngine, requests: list[Request],
                     clock: Callable[[], float] = time.perf_counter
                     ) -> list[Completion]:
    """Lock-step baseline: requests batch up in arrival order; each batch
    left-pads prompts to its longest and decodes until its slowest request
    is done (``generate`` with the batch-max step count).

    This is a *cost* baseline, not a parity path: ``generate`` has no
    padding mask, so in a mixed-length batch the pad tokens leak into a
    request's context and its tokens can differ from serving it alone."""
    bsz = engine.scfg.batch
    order = sorted(requests, key=lambda r: (r.arrival_s, r.rid))
    out: list[Completion] = []
    t0 = clock()
    for i in range(0, len(order), bsz):
        batch = order[i:i + bsz]
        while clock() - t0 < max(r.arrival_s for r in batch):
            time.sleep(0.001)
        smax = max(len(r.prompt) for r in batch)
        steps = max(r.max_new_tokens for r in batch)
        prompts = np.zeros((bsz, smax), np.int64)
        for j, r in enumerate(batch):
            prompts[j, smax - len(r.prompt):] = r.prompt
        toks = engine.generate(torch.from_numpy(prompts),
                               steps=steps).cpu().numpy()
        finish = clock() - t0
        for j, r in enumerate(batch):
            out.append(Completion(
                rid=r.rid,
                tokens=np.concatenate([
                    np.asarray(r.prompt, np.int32),
                    toks[j, smax:smax + r.max_new_tokens].astype(np.int32)]),
                prompt_len=len(r.prompt),
                arrival_s=r.arrival_s, finish_s=finish,
                finish_order=len(out),
                # lock-step emits the whole stream at batch completion
                first_token_s=finish))
    return out


def make_trace(n: int, *, vocab_size: int, prompt_lens=(8, 12, 20, 32),
               max_new=(4, 8, 16, 24), arrival_spacing_s: float = 0.0,
               seed: int = 0, burst: int = 1, sys_prompt_len: int = 0,
               sys_prompt_frac: float = 0.0, tenant_rates=(),
               tail_frac: float = 0.0,
               tail_mult: float = 4.0) -> list[Request]:
    """Mixed-length request trace: prompts/output budgets cycle through the
    given grids out of phase, arrivals optionally staggered.

    ``burst`` > 1 lands requests in groups of ``burst`` sharing one arrival
    time, groups ``arrival_spacing_s`` apart.  ``sys_prompt_len`` /
    ``sys_prompt_frac`` prepend a shared "system prompt" of that length to
    the given fraction of prompts.  ``tenant_rates`` labels requests with
    tenants drawn by rate share and makes arrivals one Poisson stream of
    mean inter-arrival ``arrival_spacing_s``; ``tail_frac`` stretches that
    fraction of prompt lengths by a Pareto(2) factor capped at
    ``tail_mult``.  Everything is keyed off ``seed``, each knob on its own
    substream, so equal arguments give byte-identical traces."""
    rng = np.random.default_rng(seed)
    burst = max(1, burst)
    sys_prompt = None
    pick = None
    if sys_prompt_len > 0 and sys_prompt_frac > 0:
        sys_prompt = np.random.default_rng(seed + 1).integers(
            0, vocab_size, size=(sys_prompt_len,), dtype=np.int32)
        pick = np.random.default_rng(seed + 2)
    tenants = arrivals = None
    if len(tenant_rates) > 0:
        rates = np.asarray(tenant_rates, float)
        if rates.min() <= 0:
            raise ValueError(f"tenant_rates must be positive: {tenant_rates}")
        trng = np.random.default_rng(seed + 3)
        tenants = trng.choice(len(rates), size=n, p=rates / rates.sum())
        arrivals = np.cumsum(trng.exponential(
            scale=max(arrival_spacing_s, 0.0), size=n))
    tail = np.random.default_rng(seed + 4) if tail_frac > 0 else None
    reqs = []
    for i in range(n):
        s0 = prompt_lens[i % len(prompt_lens)]
        if tail is not None and tail.random() < tail_frac:
            s0 = min(int(s0 * (1.0 + tail.pareto(2.0))),
                     int(s0 * max(tail_mult, 1.0)))
        prompt = rng.integers(0, vocab_size, size=(s0,), dtype=np.int32)
        if sys_prompt is not None and pick.random() < sys_prompt_frac:
            prompt = np.concatenate([sys_prompt, prompt])
        reqs.append(Request(
            rid=i, prompt=prompt,
            max_new_tokens=max_new[(i * 3 + 1) % len(max_new)],
            arrival_s=(float(arrivals[i]) if arrivals is not None
                       else (i // burst) * arrival_spacing_s),
            tenant=int(tenants[i]) if tenants is not None else 0))
    return reqs


def summarize(completions: list[Completion], wall_s: float) -> dict:
    """Throughput (generated tokens only) + latency/TTFT/queue-wait
    percentiles, and the steady decode token rate over the span between
    the first token anywhere and the last finish."""
    lats = np.asarray([c.latency_s for c in completions])
    ttfts = np.asarray([c.ttft_s for c in completions])
    waits = np.asarray([c.queue_wait_s for c in completions])
    gen = sum(len(c.tokens) - c.prompt_len for c in completions)
    firsts = [c.first_token_s for c in completions if c.first_token_s >= 0]
    span = (max(c.finish_s for c in completions) - min(firsts)) \
        if firsts else 0.0
    return {
        "requests": len(completions),
        "wall_s": round(wall_s, 4),
        "gen_tok_s": 0.0 if wall_s <= 0 else round(gen / wall_s, 2),
        "p50_latency_s": round(float(np.percentile(lats, 50)), 4),
        "p99_latency_s": round(float(np.percentile(lats, 99)), 4),
        "p50_ttft_s": round(float(np.percentile(ttfts, 50)), 4),
        "p99_ttft_s": round(float(np.percentile(ttfts, 99)), 4),
        "p50_queue_wait_s": round(float(np.percentile(waits, 50)), 4),
        "p99_queue_wait_s": round(float(np.percentile(waits, 99)), 4),
        "decode_tok_s": round(gen / span, 2) if span > 0 else (
            0.0 if wall_s <= 0 else round(gen / wall_s, 2)),
    }
