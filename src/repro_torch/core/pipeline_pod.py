"""Pipeline-parallel pod planner (DESIGN.md §7).

The compile stack so far plans one operator graph onto one flat ICCA chip;
the pod flavors (``hier_pod``, the IPU-POD4 emulator target) were only a
contention model.  This module partitions the graph into **pipeline stages
across the chips of a pod**:

* the layer stack is cut at decoder-layer boundaries into ``S`` contiguous
  stages, one per member chip (``chip_view()`` projects the pod topology
  onto one chip's intra-chip link classes);
* each stage's sub-graph is scheduled with the unmodified inductive
  :class:`~repro_torch.core.scheduler.Scheduler` through **one shared**
  :class:`~repro_torch.core.pipeline.CompileContext` — identical layers across
  stages hit the same Pareto-curve and allocation-window caches, and stage
  sub-graph signatures key a per-search plan memo;
* the cut points come from a **DP over layer boundaries** minimizing the
  steady-state bottleneck ``max_s(stage interval + inter-stage activation
  transfer on the inter-chip tier)``;
* the result is a :class:`PipelinePlan`: per-stage ``ExecutionPlan``s, the
  steady-state interval, fill/drain and microbatch knobs.

Steady-state interval
---------------------
A pipelined stage serves a stream of *independent* microbatches (distinct
request groups under continuous batching), so consecutive microbatches
software-pipeline on the chip: microbatch ``m+1``'s preloads overlap
microbatch ``m``'s execution.  The stage's steady-state interval is
therefore the bottleneck *serial resource* of its plan — the HBM/delivery
chain (§4.5: preloads are served sequentially) or the execution chain —
not the plan's end-to-end latency, which pays the fill ramp every pass.
The replicated baseline (one full-model plan per chip) cannot hide that
ramp: decode step ``t+1`` of the *same* requests needs step ``t``'s
sampled token, so each step pays the plan's full ``total_time``.  That
fill/stall amortization is exactly what the pipeline buys; both sides of
the comparison stream identical HBM bytes per token.

Degenerate case: one stage (or a one-chip pod) returns today's single-chip
plan unchanged — bit-identical, test-pinned.

Hybrid parallelism (DESIGN.md §9)
---------------------------------
:func:`plan_hybrid` generalizes the cut DP to a joint search over (cut,
tensor-parallel width, data-parallel replicas, microbatch count): a stage
may span ``width`` chips (its sub-graph sharded Megatron-style by
:func:`shard_graph` — weight/KV bytes divided, per-layer all-reduce for
row-sharded matmuls, expert all-to-all for MoE — priced through
``TopologyModel.collective_time``) and/or be replicated ``replicas`` times
(round-robin over the microbatch stream divides the effective cadence).
Fewer, wider stages stream each weight byte fewer times per decode round,
which is where hybrid beats the pure pipeline on HBM-bound decode; the
pure-pipeline plan is always computed alongside and returned whenever it
is at least as good, so ``mode="hybrid"`` is never worse and degenerates
bit-identically when widths/replicas are pinned to 1.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.chip.config import ChipConfig
from repro_torch.chip.topology import ChipView
from repro_torch.core.graph import OpGraph, Phase, build_graph
from repro_torch.core.partition import op_curve_signature
from repro_torch.core.pipeline import CompileContext, PlanCache, plan_signature
from repro_torch.core.plan import ExecutionPlan
from repro_torch.models.config import ModelConfig

_INF = math.inf


# ---------------------------------------------------------------------------
# plan artifacts
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StagePlan:
    """One pipeline stage: a contiguous layer range on one stage group of
    ``width * replicas`` member chips (one chip in the pure pipeline)."""
    index: int
    layers: tuple[int, int]        # [lo, hi) decoder-layer range
    graph: OpGraph                 # exact stage sub-graph (conservation;
    #                                the sharded per-chip graph when width>1)
    plan: ExecutionPlan            # per-microbatch schedule (may extrapolate)
    time: float                    # per-microbatch stage latency
    interval: float                # steady-state per-microbatch interval
    send_bytes: int                # activation bytes to the next stage
    send_time: float               # inter-chip-tier transfer estimate
    # hybrid parallelism (DESIGN.md §9); defaults are the pure pipeline
    width: int = 1                 # tensor-parallel chips in this stage
    replicas: int = 1              # data-parallel copies of this stage
    collective_time: float = 0.0   # per-microbatch intra-stage collectives
    collectives: tuple = ()        # (kind, payload bytes) descriptors

    @property
    def chips(self) -> int:
        return self.width * self.replicas

    @property
    def effective_interval(self) -> float:
        """Steady per-microbatch cadence this stage group sustains:
        ``replicas`` copies round-robin the microbatch stream, each paying
        the sharded interval plus the intra-stage collectives, and the
        handoff to the next stage rides on top.  Bit-identical to
        ``interval + send_time`` in the degenerate width=replicas=1 case."""
        return (self.interval + self.collective_time) \
            / max(self.replicas, 1) + self.send_time


@dataclasses.dataclass(frozen=True)
class PipelinePlan:
    """A graph partitioned into pipeline stages across a pod."""
    model: str
    phase: Phase
    chip_name: str
    design: str
    num_chips: int
    batch: int                     # total in-flight requests
    microbatch: int                # requests per microbatch
    microbatches: int              # concurrent microbatch groups (>= stages)
    stages: tuple[StagePlan, ...]
    interval: float                # steady-state per-microbatch bottleneck
    batch_interval: float          # microbatches * interval: one decode
    #                                round of the whole running batch
    fill_time: float               # first microbatch end-to-end latency
    total_time: float              # fill + (microbatches-1) * interval

    @property
    def num_stages(self) -> int:
        return len(self.stages)

    @property
    def total_flops(self) -> float:
        """Per-microbatch FLOPs over all stage sub-graphs (conserved across
        cuts — fuzz-tested against the unpartitioned graph)."""
        return sum(op.flops for st in self.stages for op in st.graph.ops)

    @property
    def hbm_bytes(self) -> int:
        """Per-microbatch off-chip bytes over all stage sub-graphs."""
        return sum(op.hbm_bytes for st in self.stages for op in st.graph.ops)


# ---------------------------------------------------------------------------
# graph slicing
# ---------------------------------------------------------------------------

def _layer_starts(g: OpGraph) -> tuple[dict[int, int], int, int]:
    """First op index per decoder layer + the [first, end) span of all
    layer ops (ops outside it are the prefix/suffix: embed, encoder,
    final norm, lm_head)."""
    starts: dict[int, int] = {}
    first = len(g.ops)
    last_end = 0
    for i, op in enumerate(g.ops):
        if op.layer >= 0:
            first = min(first, i)
            last_end = max(last_end, i + 1)
            if op.layer not in starts:
                starts[op.layer] = i
    return starts, first, last_end


def stage_subgraph(g: OpGraph, lo: int, hi: int, num_layers: int) -> OpGraph:
    """The sub-graph of decoder layers [lo, hi); stage 0 keeps the prefix
    ops (embed/frontends/encoder), the last stage keeps the suffix
    (final norm, lm_head).  ``preload_dep`` indices are re-based; deps are
    intra-layer (MoE router -> experts), so cuts at layer boundaries never
    sever one."""
    starts, first, last_end = _layer_starts(g)
    off = starts[lo] if lo > 0 else 0
    end = starts[hi] if hi < num_layers else len(g.ops)
    sub = []
    for op in g.ops[off:end]:
        dep = op.preload_dep
        if dep >= 0:
            dep -= off
            if dep < 0:            # severed dep (never at layer cuts)
                dep = -1
            op = dataclasses.replace(op, preload_dep=dep)
        sub.append(op)
    span_lo = starts[lo] - off
    span_hi = (starts[lo + 1] - off) if lo + 1 < hi else \
        (min(last_end, end) - off)
    return OpGraph(f"{g.model}[{lo}:{hi}]", g.phase, tuple(sub),
                   (span_lo, span_hi), hi - lo)


# ---------------------------------------------------------------------------
# tensor-parallel graph sharding (DESIGN.md §9)
# ---------------------------------------------------------------------------

# Megatron-style shard rules by op-name suffix: (sharded iteration dim,
# divide-all-inputs).  Column-sharded projections split the output features
# (dim 1) — weight and bias divide, activations replicate, no collective.
# Row-sharded projections split the reduce dim (dim 2) — weight and
# activation divide, partial outputs need an all-reduce (detected below via
# ``dim in reduce_dims``).  Attention BMMs and the vector ops that ride a
# sharded intermediate (rope/softmax/activations/recurrences) split with
# the heads/features they follow; vector ops declare their intermediate as
# spanning only dim 0, so they divide every input explicitly.
_SHARD_RULES: dict[str, tuple[int, bool]] = {
    # column-parallel matmuls (QKV/head projections, up-projections)
    **{s: (1, False) for s in ("q", "kv", "qkv", "xq", "fc1", "gate_up",
                               "shared_up", "cm_k", "ssm_in",
                               "r", "k", "v", "g")},
    # row-parallel matmuls (output/down projections -> all-reduce)
    **{s: (2, False) for s in ("o", "xo", "out", "fc2", "down",
                               "shared_down", "cm_v", "ssm_out")},
    # head-sharded attention BMMs (merge happens in the o-proj all-reduce)
    **{s: (0, False) for s in ("score", "attnv", "xscore", "xattnv")},
    # vector ops on a head/feature-sharded intermediate
    **{s: (1, True) for s in ("rope", "act", "cm_act", "shared_act",
                              "wkv", "ssm_scan")},
    **{s: (0, True) for s in ("softmax", "xsoftmax")},
}
# replicated: ln*/router/embed/final_norm/lm_head/vision_patches — cheap,
# and their inputs arrive replicated after the preceding all-reduce.


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def shard_graph(g: OpGraph, width: int) -> tuple[OpGraph, tuple]:
    """Project a stage graph onto one of ``width`` tensor-parallel chips.

    Returns ``(per-chip graph, collective descriptors)`` where each
    descriptor is ``(kind, payload bytes)`` of one per-microbatch
    intra-stage collective: an all-reduce of the full output for every
    row-sharded matmul, and a dispatch + combine all-to-all pair for every
    expert-parallel MoE op (each chip owns ``1/width`` of the routed
    experts).  Op count, order and ``preload_dep`` indices are preserved,
    so MoE late binding survives sharding unchanged.
    """
    if width <= 1:
        return g, ()
    ops = []
    colls = []
    for op in g.ops:
        names = [t.name for t in op.inputs]
        if "w_experts" in names:
            # expert parallelism: split the routed rows/experts (dim 0),
            # ring the activations to the owning chips and back
            ops.append(_shard_op(op, 0, width, all_inputs=True))
            colls.append(("all_to_all", op.inputs[0].bytes_total))
            colls.append(("all_to_all", op.out_bytes))
            continue
        rule = _SHARD_RULES.get(op.name.rsplit(".", 1)[-1])
        if rule is None or len(op.dims) <= rule[0]:
            ops.append(op)             # replicated
            continue
        dim, all_inputs = rule
        ops.append(_shard_op(op, dim, width, all_inputs=all_inputs))
        if dim in op.reduce_dims:
            colls.append(("all_reduce", op.out_bytes))
    return OpGraph(f"{g.model}@tp{width}", g.phase, tuple(ops),
                   g.layer_span, g.num_layers), tuple(colls)


def _shard_op(op, dim: int, width: int, *, all_inputs: bool):
    """One op's ``1/width`` shard along iteration dim ``dim``: the dim,
    FLOPs and every tensor spanning it divide by the real shrink factor
    (ceil on the dim, so tiny dims never vanish); the output divides unless
    ``dim`` is reduced (row-shard -> full-size partial sums)."""
    old = op.dims[dim]
    new = _ceil_div(old, width)
    f = new / old
    dims = op.dims[:dim] + (new,) + op.dims[dim + 1:]
    inputs = tuple(
        dataclasses.replace(t, bytes_total=int(math.ceil(t.bytes_total * f)))
        if (all_inputs or dim in t.dims) else t
        for t in op.inputs)
    out = op.out_bytes if dim in op.reduce_dims \
        else int(math.ceil(op.out_bytes * f))
    return dataclasses.replace(op, dims=dims, flops=op.flops * f,
                               inputs=inputs, out_bytes=out)


# ---------------------------------------------------------------------------
# steady-state interval of one stage plan
# ---------------------------------------------------------------------------

def steady_interval(plan: ExecutionPlan, chip: ChipConfig,
                    ctx: Optional[CompileContext] = None) -> float:
    """Throughput bound of a stage serving back-to-back microbatches: the
    busiest of the per-tier serial preload chains (§4.5 rule 2 — each
    source tier's controllers serve sequentially), the shared delivery-NoC
    chain, and the serial execution chain, clamped to the plan's one-pass
    latency.  On a two-tier chip the single hbm chain makes this exactly
    the pre-§10 ``sum(max(t_hbm, t_noc))`` bound."""
    cost = ctx.cost if ctx is not None else None
    pre_bw = chip.preload_noc_bw
    tiers = chip.mem_tiers
    last = len(tiers) - 1
    chains = [0.0] * (last + 1)
    noc_chain = 0.0
    for d in plan.decisions:
        p = d.preload_plan
        if p is None or not (p.hbm_bytes or p.noc_preload_bytes):
            continue
        k = d.src_tier if 0 <= d.src_tier <= last else last
        if cost is not None:
            t_src = cost.tier_time(p.hbm_bytes, k)
        else:
            t_src = (p.hbm_bytes / tiers[k].bandwidth + tiers[k].latency) \
                if (k > 0 and tiers[k].bandwidth) else 0.0
        t_noc = p.noc_preload_bytes / pre_bw
        chains[k] += max(t_src, t_noc)
        noc_chain += t_noc
    hbm = max(max(chains), noc_chain)
    exe = sum(t.t_e_exe - t.t_s_exe for t in plan.timing)
    if plan.total_time <= 0:
        return max(hbm, exe)
    return min(max(hbm, exe), plan.total_time)


# ---------------------------------------------------------------------------
# stage-cost search state
# ---------------------------------------------------------------------------

class _StageCosts:
    """Memoized stage compiles for the cut DP.

    Stage plans are keyed by (op-signature tuple, tensor-parallel width) —
    identical layer stacks collapse every same-shape candidate range to one
    compile per width — and every compile shares one ``CompileContext``:
    curves and allocation windows are computed once for the whole search
    (sharded ops carry divided dims/bytes/flops, so their curve signatures
    differ and never collide with the unsharded ones).
    """

    def __init__(self, g: OpGraph, member: ChipConfig, design: str,
                 max_orders: int, max_exact_ops: int,
                 pod: Optional[ChipConfig] = None):
        self.g = g
        self.member = member
        self.design = design
        self.max_orders = max_orders
        self.max_exact_ops = max_exact_ops
        self.pod = pod               # pod config pricing collectives (§9)
        self.ctx = CompileContext(member)
        self.num_layers = g.num_layers
        self._sigs = [op_curve_signature(op) for op in g.ops]
        starts, first, last_end = _layer_starts(g)
        self._starts, self._first, self._last_end = starts, first, last_end
        # layer uniformity: identical per-layer signatures let deep stages
        # extrapolate from truncations (MoE stacks with dense prefixes are
        # not uniform and always schedule exactly)
        sig0 = self._layer_sig(0)
        self.uniform = all(self._layer_sig(i) == sig0
                           for i in range(1, g.num_layers))
        self._memo: dict = {}

    def _layer_sig(self, i: int) -> tuple:
        lo = self._starts[i]
        hi = self._starts[i + 1] if i + 1 < self.num_layers else self._last_end
        return tuple(self._sigs[lo:hi])

    def _compile(self, sub: OpGraph) -> ExecutionPlan:
        from repro_torch.core.baselines import build_plan
        return build_plan(sub, self.member, self.design,
                          max_orders=self.max_orders, ctx=self.ctx)

    def stage(self, lo: int, hi: int,
              width: int = 1) -> tuple[OpGraph, ExecutionPlan, float, float]:
        """(sub-graph, plan, per-microbatch time, steady interval) for
        decoder layers [lo, hi), optionally sharded ``width`` ways (the
        returned sub-graph is then the per-chip shard)."""
        sub = stage_subgraph(self.g, lo, hi, self.num_layers)
        if width > 1:
            sub, _ = shard_graph(sub, width)
        key = (lo == 0, hi == self.num_layers, width,
               tuple(self._sigs[self._op_lo(lo):self._op_hi(hi)]))
        got = self._memo.get(key)
        if got is None:
            got = self._solve(sub, lo, hi, width)
            self._memo[key] = got
        plan, time, ival = got
        return sub, plan, time, ival

    def collective(self, lo: int, hi: int, width: int) -> tuple[float, tuple]:
        """(time, descriptors) of the per-microbatch intra-stage collectives
        of decoder layers [lo, hi) sharded ``width`` ways — arithmetic on
        the exact sub-graph (no compile), so it stays exact even when the
        stage plan extrapolates."""
        if width <= 1 or self.pod is None:
            return 0.0, ()
        key = ("coll", lo == 0, hi == self.num_layers, width,
               tuple(self._sigs[self._op_lo(lo):self._op_hi(hi)]))
        got = self._memo.get(key)
        if got is None:
            sub = stage_subgraph(self.g, lo, hi, self.num_layers)
            _, colls = shard_graph(sub, width)
            topo = self.pod.topo
            t = sum(topo.collective_time(kind, b, width)
                    for kind, b in colls)
            got = self._memo[key] = (t, colls)
        return got

    def _op_lo(self, lo: int) -> int:
        return self._starts[lo] if lo > 0 else 0

    def _op_hi(self, hi: int) -> int:
        return self._starts[hi] if hi < self.num_layers else len(self.g.ops)

    def _solve(self, sub: OpGraph, lo: int, hi: int, width: int = 1):
        k = hi - lo
        if len(sub.ops) <= self.max_exact_ops or not self.uniform or k <= 3:
            plan = self._compile(sub)
            return plan, plan.total_time, steady_interval(
                plan, self.member, self.ctx)
        # deep uniform stage: linear layer-count extrapolation from two
        # truncations of the same flavor (both land in the memo, so every
        # deep candidate range reuses them)
        k2 = min(k - 1, 8)
        k1 = max(k2 - 2, 1)
        scale = (k - k2) / (k2 - k1)

        def probe(kk: int):
            # anchor the truncation to whichever end carries this stage's
            # prefix/suffix ops, so embed and lm_head stay in both probes
            if hi == self.num_layers and lo > 0:
                s = stage_subgraph(self.g, hi - kk, hi, self.num_layers)
            else:
                s = stage_subgraph(self.g, lo, lo + kk, self.num_layers)
            if width > 1:
                s, _ = shard_graph(s, width)
            p = self._compile(s)
            return p, p.total_time, steady_interval(p, self.member, self.ctx)

        p1, t1, i1 = probe(k1)
        p2, t2, i2 = probe(k2)
        time = max(t2 + (t2 - t1) * scale, 0.0)
        ival = max(i2 + (i2 - i1) * scale, 0.0)
        plan = dataclasses.replace(p2, total_time=time,
                                   extrapolated_from_layers=k2)
        return plan, time, min(ival, time)


# ---------------------------------------------------------------------------
# cut-point DP
# ---------------------------------------------------------------------------

def _cut_dp(costs: _StageCosts, num_stages: int, send_time: float,
            slack: Optional[int]) -> list[int]:
    """Cut points minimizing ``max_s(interval_s + send_s)`` (ties broken by
    total fill).  ``slack`` bands candidate stage depths around the
    balanced ``ceil(L/S)`` to bound the number of stage compiles; the band
    widens automatically if it admits no feasible partition."""
    L, S = costs.num_layers, num_stages
    base = -(-L // S)
    if slack is None:
        slack = L if L <= 16 else max(3, base // 3)

    def run(band: int) -> Optional[list[int]]:
        lo_k = max(1, base - band)
        hi_k = min(L, base + band)

        def stage_cost(a: int, b: int) -> float:
            if not (lo_k <= b - a <= hi_k):
                return _INF
            _, _, _, ival = costs.stage(a, b)
            return ival + (send_time if b < L else 0.0)

        # f[s][l]: min bottleneck over first l layers in s stages
        f = [[_INF] * (L + 1) for _ in range(S + 1)]
        g = [[0.0] * (L + 1) for _ in range(S + 1)]    # fill tie-break
        back = [[-1] * (L + 1) for _ in range(S + 1)]
        f[0][0] = 0.0
        for s in range(1, S + 1):
            for l in range(s, L - (S - s) + 1):
                for m in range(s - 1, l):
                    if f[s - 1][m] == _INF:
                        continue
                    if not (lo_k <= l - m <= hi_k):
                        continue
                    c = stage_cost(m, l)
                    if c == _INF:
                        continue
                    v = max(f[s - 1][m], c)
                    fill = g[s - 1][m] + costs.stage(m, l)[2]
                    if v < f[s][l] - 1e-15 or (
                            abs(v - f[s][l]) <= 1e-15 and fill < g[s][l]):
                        f[s][l], g[s][l], back[s][l] = v, fill, m
        if f[S][L] == _INF:
            return None
        cuts, l = [], L
        for s in range(S, 0, -1):
            cuts.append(l)
            l = back[s][l]
        return list(reversed(cuts))        # S cut points, last == L

    band = slack
    while True:
        cuts = run(band)
        if cuts is not None:
            return cuts
        if band >= L:
            raise RuntimeError(f"no feasible {S}-stage cut of {L} layers")
        band = min(L, max(band * 2, 1))


# ---------------------------------------------------------------------------
# planner entry
# ---------------------------------------------------------------------------

_PIPE_CACHE = PlanCache(maxsize=64)


def pipeline_cache() -> PlanCache:
    return _PIPE_CACHE


def plan_pipeline(cfg: ModelConfig, chip: ChipConfig, *, batch: int,
                  seq: int, phase: Phase = "decode",
                  design: str = "ELK-Full",
                  num_stages: Optional[int] = None,
                  microbatches: Optional[int] = None,
                  max_orders: int = 4, max_exact_ops: int = 400,
                  cut_slack: Optional[int] = None,
                  cache: bool = True,
                  _costs: Optional[_StageCosts] = None) -> PipelinePlan:
    """Partition ``cfg``'s operator graph into pipeline stages across the
    chips of ``chip`` (a pod config: ``num_chips >= 1``).

    ``num_stages`` defaults to the pod's chip count; ``microbatches``
    defaults to the stage count (the minimum keeping every stage busy in
    steady state).  The per-microbatch request count is
    ``ceil(batch / microbatches)``.

    A one-stage (or one-chip) plan degenerates to today's single-chip
    compile path, bit-identical (test-pinned).
    """
    S = num_stages if num_stages is not None else max(chip.num_chips, 1)
    S = max(1, min(S, max(chip.num_chips, 1), cfg.num_layers))
    M = microbatches if microbatches is not None else S
    M = max(M, S)
    key = plan_signature(cfg, chip, batch, seq, phase, design, S, M,
                         max_orders, max_exact_ops)
    if cache:
        hit = _PIPE_CACHE.get(key)
        if hit is not None:
            return hit

    from repro_torch.core.elk import compile_model

    if S == 1:
        plan = compile_model(cfg, chip, batch=batch, seq=seq, phase=phase,
                             design=design, max_orders=max_orders)
        g = build_graph(cfg, batch=batch, seq=seq, phase=phase)
        st = StagePlan(0, (0, cfg.num_layers), g, plan, plan.total_time,
                       plan.total_time, 0, 0.0)
        pp = PipelinePlan(cfg.name, phase, chip.name, design,
                          max(chip.num_chips, 1), batch, batch, 1, (st,),
                          plan.total_time, plan.total_time, plan.total_time,
                          plan.total_time)
        pp = _prefer_untiered(pp, cfg, chip, batch=batch, seq=seq,
                              phase=phase, design=design,
                              num_stages=num_stages,
                              microbatches=microbatches,
                              max_orders=max_orders,
                              max_exact_ops=max_exact_ops,
                              cut_slack=cut_slack, cache=cache)
        if cache:
            _PIPE_CACHE.put(key, pp)
        return pp

    b = -(-batch // M)
    view: ChipView = chip.chip_view()
    if _costs is not None:
        costs, g = _costs, _costs.g
    else:
        g = build_graph(cfg, batch=b, seq=seq, phase=phase)
        costs = _StageCosts(g, view.chip, design, max_orders, max_exact_ops)

    starts, first, last_end = _layer_starts(g)
    # activation crossing a layer boundary: the last op of the previous
    # layer's output (rows x d_model for every supported family)
    act_bytes = g.ops[(starts[1] if cfg.num_layers > 1 else last_end) - 1] \
        .out_bytes
    send_time = act_bytes / view.inter_bw + view.inter_latency

    cuts = _cut_dp(costs, S, send_time, cut_slack)
    stages = []
    lo = 0
    for i, hi in enumerate(cuts):
        sub, plan, time, ival = costs.stage(lo, hi)
        send_b = act_bytes if hi < cfg.num_layers else 0
        send_t = send_time if hi < cfg.num_layers else 0.0
        stages.append(StagePlan(i, (lo, hi), sub, plan, time, ival,
                                send_b, send_t))
        lo = hi
    interval = max(st.effective_interval for st in stages)
    fill = sum(st.time + st.collective_time + st.send_time for st in stages)
    pp = PipelinePlan(cfg.name, phase, chip.name, design,
                      max(chip.num_chips, 1), b * M, b, M, tuple(stages),
                      interval, M * interval, fill,
                      fill + (M - 1) * interval)
    pp = _prefer_untiered(pp, cfg, chip, batch=batch, seq=seq, phase=phase,
                          design=design, num_stages=num_stages,
                          microbatches=microbatches, max_orders=max_orders,
                          max_exact_ops=max_exact_ops, cut_slack=cut_slack,
                          cache=cache)
    if cache:
        _PIPE_CACHE.put(key, pp)
    return pp


def _prefer_untiered(pp: PipelinePlan, cfg: ModelConfig, chip: ChipConfig,
                     **kw) -> PipelinePlan:
    """Staging-tier plans win strictly or not at all (DESIGN.md §10).

    Candidate schedules inside a stage compile are selected on one-pass
    latency, so a staged placement can flip the winner toward a plan with
    worse steady throughput.  Planning the pod again with its middle tiers
    stripped (exactly the two-tier baseline — usually a cache hit in any
    sweep that also plans the base pod) and keeping the tiered plan only
    when strictly better makes the tiered planner never worse by
    construction."""
    if not chip.staging_tiers:
        return pp
    base = plan_pipeline(cfg, dataclasses.replace(chip, mem_tiers=()), **kw)
    return pp if pp.batch_interval < base.batch_interval else base


# ---------------------------------------------------------------------------
# hybrid (cut x width x replicas x microbatch) search — DESIGN.md §9
# ---------------------------------------------------------------------------

def _pow2_upto(n: int) -> tuple[int, ...]:
    vals = {1, n}
    p = 2
    while p < n:
        vals.add(p)
        p *= 2
    return tuple(sorted(vals))


def _hybrid_dp(costs: _StageCosts, chips: int, widths: tuple,
               replicas: tuple, send_time: float, max_slots: int,
               slack: Optional[int]) -> Optional[list]:
    """DP over (layer boundary, chips used, replica slots) assigning each
    stage a (depth, width, replicas) triple: minimize the bottleneck
    ``max_s((interval_s + collective_s)/replicas_s + send_s)`` subject to
    ``sum(width*replicas) == chips`` (leftover chips always help the
    bottleneck as replicas, so exact use is never worse) and
    ``sum(replicas) <= max_slots`` — each replica holds one in-flight
    microbatch, so the microbatch count bounds total replication.  A
    replica overlaps preload with execution only when it alternates >= 2
    distinct microbatch groups (M >= 2*replicas); otherwise its cadence is
    the full stage latency.  Returns ``[(hi, width, replicas), ...]`` or
    ``None`` when no banded partition is feasible.
    """
    L = costs.num_layers
    combos = sorted({(w, r) for w in widths for r in replicas
                     if w * r <= chips and r <= max_slots})
    if not combos:
        return None
    if slack is None:
        slack = L if L <= 16 else max(3, _ceil_div(L, chips) // 3)

    def run(band: int) -> Optional[list]:
        f = {(0, 0, 0): (0.0, 0.0)}
        back: dict = {}
        for l in range(1, L + 1):
            for c in range(1, chips + 1):
                for s in range(1, min(max_slots, c) + 1):
                    best = bptr = None
                    for w, r in combos:
                        wc = w * r
                        if wc > c or r > s:
                            continue
                        base_k = max(1, _ceil_div(L * wc, chips))
                        lo_k = max(1, base_k - band)
                        hi_k = min(L, base_k + band, l)
                        for k in range(lo_k, hi_k + 1):
                            prev = f.get((l - k, c - wc, s - r))
                            if prev is None:
                                continue
                            _, _, t, ival = costs.stage(l - k, l, w)
                            ct, _ = costs.collective(l - k, l, w)
                            # steady overlap needs >= 2 distinct groups
                            # per replica; else pay the full latency
                            pace = ival if max_slots >= 2 * r else t
                            send = send_time if l < L else 0.0
                            eff = (pace + ct) / r + send
                            v = max(prev[0], eff)
                            fill = prev[1] + t + ct + send
                            if best is None or v < best[0] - 1e-15 or (
                                    abs(v - best[0]) <= 1e-15
                                    and fill < best[1]):
                                best = (v, fill)
                                bptr = (l - k, c - wc, s - r, w, r)
                    if best is not None:
                        f[(l, c, s)] = best
                        back[(l, c, s)] = bptr
        ends = [(f[(L, chips, s)], s)
                for s in range(1, min(max_slots, chips) + 1)
                if (L, chips, s) in f]
        if not ends:
            return None
        _, s_end = min(ends, key=lambda e: e[0])
        out = []
        state = (L, chips, s_end)
        while state != (0, 0, 0):
            pl, pc, ps, w, r = back[state]
            out.append((state[0], w, r))
            state = (pl, pc, ps)
        return list(reversed(out))

    band = slack
    while True:
        got = run(band)
        if got is not None:
            return got
        if band >= L:
            return None
        band = min(L, max(band * 2, 1))


def plan_hybrid(cfg: ModelConfig, chip: ChipConfig, *, batch: int,
                seq: int, phase: Phase = "decode",
                design: str = "ELK-Full",
                widths: Optional[tuple] = None,
                replicas: Optional[tuple] = None,
                microbatches: Optional[int] = None,
                max_orders: int = 4, max_exact_ops: int = 400,
                cut_slack: Optional[int] = None,
                cache: bool = True) -> PipelinePlan:
    """Joint (cut x tensor-parallel width x data-parallel replicas x
    microbatch count) plan over the pod (DESIGN.md §9).

    ``widths``/``replicas`` default to the powers of two up to the chip
    count.  When ``microbatches`` is None the search also sweeps the
    microbatch count downward from the pipeline default — fewer, larger
    microbatches stream each stage's weights fewer times per decode round,
    which is the lever that lets wide stages beat the pure pipeline on
    HBM-bound decode.  Plans are compared on time per request per decode
    round (``batch_interval / batch``); the pure pipeline is always
    planned alongside and returned when it is at least as good, so the
    result is **never worse** than ``plan_pipeline`` and degenerates
    bit-identically when widths and replicas are pinned to 1 (or on a
    one-chip pod).
    """
    C = max(chip.num_chips, 1)
    L = cfg.num_layers
    widths = _pow2_upto(C) if widths is None else \
        tuple(sorted({int(w) for w in widths if 1 <= int(w) <= C}))
    replicas = _pow2_upto(C) if replicas is None else \
        tuple(sorted({int(r) for r in replicas if 1 <= int(r) <= C}))
    if not widths or not replicas:
        raise ValueError("widths/replicas must contain a value in "
                         f"[1, {C}]")
    key = plan_signature(cfg, chip, batch, seq, phase, design, "hybrid",
                         widths, replicas, microbatches, max_orders,
                         max_exact_ops)
    if cache:
        hit = _PIPE_CACHE.get(key)
        if hit is not None:
            return hit

    S_pipe = max(1, min(C, L))
    shared = None
    if C > 1 and L > 1:
        # one CompileContext shared between the pure-pipeline baseline and
        # the same-microbatch hybrid candidate: plan_pipeline clamps its
        # group count to >= S_pipe, so both see the same microbatch size
        M0 = max(microbatches, S_pipe) if microbatches else S_pipe
        b0 = -(-batch // M0)
        g0 = build_graph(cfg, batch=b0, seq=seq, phase=phase)
        shared = (M0, _StageCosts(g0, chip.chip_view().chip, design,
                                  max_orders, max_exact_ops, pod=chip))
    pipe = plan_pipeline(cfg, chip, batch=batch, seq=seq, phase=phase,
                         design=design, microbatches=microbatches,
                         max_orders=max_orders, max_exact_ops=max_exact_ops,
                         cut_slack=cut_slack, cache=cache,
                         _costs=shared[1] if shared else None)
    best = pipe
    if C > 1 and L > 1 and (widths != (1,) or replicas != (1,)):
        if microbatches is not None:
            m_cands = [max(microbatches, 1)]
        else:
            m_cands = sorted({S_pipe, max(S_pipe // 2, 1), 1}, reverse=True)
        for M in m_cands:
            hp = _plan_hybrid_at(cfg, chip, batch, seq, phase, design,
                                 widths, replicas, M, max_orders,
                                 max_exact_ops, cut_slack,
                                 costs=shared[1]
                                 if shared and shared[0] == M else None)
            if hp is not None and (hp.batch_interval / hp.batch
                                   < best.batch_interval / best.batch):
                best = hp
    if chip.staging_tiers:
        # same strictly-better-only rule as _prefer_untiered: a staged
        # hybrid candidate must beat the whole untiered hybrid search
        base = plan_hybrid(cfg, dataclasses.replace(chip, mem_tiers=()),
                           batch=batch, seq=seq, phase=phase, design=design,
                           widths=widths, replicas=replicas,
                           microbatches=microbatches, max_orders=max_orders,
                           max_exact_ops=max_exact_ops, cut_slack=cut_slack,
                           cache=cache)
        if not (best.batch_interval / best.batch
                < base.batch_interval / base.batch):
            best = base
    if cache:
        _PIPE_CACHE.put(key, best)
    return best


def _plan_hybrid_at(cfg: ModelConfig, chip: ChipConfig, batch: int,
                    seq: int, phase: Phase, design: str, widths: tuple,
                    replicas: tuple, M: int, max_orders: int,
                    max_exact_ops: int, cut_slack: Optional[int],
                    costs: Optional[_StageCosts] = None
                    ) -> Optional[PipelinePlan]:
    """The best hybrid partition at a fixed microbatch count (or None when
    the (widths, replicas, M) grid admits no exact-chip-count partition)."""
    C = max(chip.num_chips, 1)
    b = -(-batch // M)
    view = chip.chip_view()
    if costs is not None:
        g = costs.g
    else:
        g = build_graph(cfg, batch=b, seq=seq, phase=phase)
        costs = _StageCosts(g, view.chip, design, max_orders, max_exact_ops,
                            pod=chip)
    starts, first, last_end = _layer_starts(g)
    act_bytes = g.ops[(starts[1] if cfg.num_layers > 1 else last_end) - 1] \
        .out_bytes
    send_time = act_bytes / view.inter_bw + view.inter_latency
    assign = _hybrid_dp(costs, C, widths, replicas, send_time, M, cut_slack)
    if assign is None:
        return None
    stages = []
    lo = 0
    for i, (hi, w, r) in enumerate(assign):
        sub, plan, time, ival = costs.stage(lo, hi, w)
        ct, colls = costs.collective(lo, hi, w)
        if M < 2 * r:                  # no cross-group overlap (see DP)
            ival = time
        last = hi >= cfg.num_layers
        stages.append(StagePlan(i, (lo, hi), sub, plan, time, ival,
                                0 if last else act_bytes,
                                0.0 if last else send_time,
                                w, r, ct, colls))
        lo = hi
    interval = max(st.effective_interval for st in stages)
    fill = sum(st.time + st.collective_time + st.send_time for st in stages)
    return PipelinePlan(cfg.name, phase, chip.name, design, C, b * M, b, M,
                        tuple(stages), interval, M * interval, fill,
                        fill + (M - 1) * interval)


def replicated_plan(cfg: ModelConfig, chip: ChipConfig, *, batch: int,
                    seq: int, phase: Phase = "decode",
                    design: str = "ELK-Full",
                    max_orders: int = 4) -> ExecutionPlan:
    """Data-parallel baseline: every member chip replicates the full model
    and serves ``batch / num_chips`` requests.  Its steady-state interval
    per pod decode round is the member plan's ``total_time`` — step ``t+1``
    of the same requests cannot start before step ``t``'s sampled tokens,
    so the per-step fill/stall is paid every round."""
    from repro_torch.core.elk import compile_model
    view = chip.chip_view()
    b = -(-batch // max(chip.num_chips, 1))
    return compile_model(cfg, view.chip, batch=b, seq=seq, phase=phase,
                         design=design, max_orders=max_orders)
