"""Inter-core kernel fusion pass (DESIGN.md §8).

The ICCA chip's aggregate SRAM turns fusion from a vector-epilogue trick
into something that works for compute-intensive chains: a matmul ->
vector-activation -> matmul chain whose intermediate fits the combined
on-chip memory of the executing core group can run as ONE operator — the
intermediate is held in SRAM (partials staged over the interconnect by
the reduction of the second matmul's contraction split) instead of being
stored and reloaded between ops, and both weight matrices ride one HBM
preload pass.

This module contributes three pieces:

* ``find_fusable_chains`` / ``fuse_graph`` — graph pass emitting candidate
  :class:`FusedOp` nodes for every MLP-block chain (plain ``fc1 -> act ->
  fc2``, GLU ``gate_up -> act -> down``, MoE shared-expert ``shared_up ->
  shared_act -> shared_down``, RWKV channel-mix ``cm_k -> cm_act ->
  cm_v``), gated on the intermediate fitting ``chip.total_sram``.  The
  matcher is structural (op kinds, byte flow, weight provenance), so
  matmul -> vector *pairs* fuse too when ``pairs=True``.
* ``enumerate_fused_exec_plans`` — the fused-op Pareto curve, built by
  *zipping the stage matmuls' own generic Pareto curves*: each stage
  keeps the layout the generic enumerator found best for it and the
  intermediate is resharded stage-to-stage over the interconnect (with
  the activation applied in-stream).  Every pairing contributes a
  *fused* point (second-stage weights resident through the first, one
  merged preload window) AND a *composed* point (same stage plans,
  separate activation op, per-stage peak footprint only), so the §4.3
  allocator and §4.2 scheduler see both alternatives per window and
  pick fusion only where it beats preload overlap.
* cache signatures (``fusion_signature`` / ``graph_fusion_signature``) —
  threaded through the plan cache and allocation-window keys exactly like
  ``topo_signature``, so fusion-on and fusion-off compiles never share a
  stale entry.  ``FUSION_VERSION`` bumps invalidate everything at once.

The selection contract (never worse than fusion-off) is enforced one
level up: ``core.pipeline`` compiles the fused and unfused graphs against
one shared ``CompileContext`` and keeps the faster plan.
"""

from __future__ import annotations

import dataclasses

from repro_torch.chip.config import ChipConfig
from repro_torch.core.cost_model import AnalyticCostModel
from repro_torch.core.graph import Op, OpGraph, TensorSpec
from repro_torch.core.partition import _pareto, ExecPlan, enumerate_exec_plans

# Bump to invalidate every fusion-dependent cache entry (curve signatures,
# window keys, plan-cache keys) in one place.
FUSION_VERSION = 1


def fusion_signature(enabled: bool) -> tuple:
    """Plan-cache key component for the compile-level fusion knob."""
    return ("fusion", FUSION_VERSION if enabled else 0)


def graph_fusion_signature(graph: OpGraph) -> tuple:
    """Window-cache key component: whether (and how much of) the graph being
    scheduled is fused.  Mirrors ``topo_signature``'s role from the topology
    subsystem."""
    n = sum(1 for op in graph.ops if isinstance(op, FusedOp))
    return ("fusion", FUSION_VERSION if n else 0, n)


# ---------------------------------------------------------------------------
# the fused node
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FusedOp(Op):
    """A matmul -> vector [-> matmul] chain collapsed into one operator.

    The declared iteration space ``(M, FF)`` — output rows by the chain's
    staging width (the second matmul's contraction dim) — describes the
    op's *memory residency* for the preload side: inputs are ``x`` (spans
    M), ``w1`` (first matmul's weights+bias, spans FF) and, for triples,
    ``w2`` (second matmul's weights+bias, spans FF); both weight tensors
    keep ``from_hbm``, so the *generic* preload-plan enumerator prices
    them as one merged HBM pass with a single request latency — the fused
    preload curve falls out for free.  Execution is priced per *stage*
    (``enumerate_fused_exec_plans``): each stage matmul runs under its own
    generic split, connected by an interconnect reshard — a single split
    tuple over (M, FF) cannot express two good stage layouts at once (the
    output reduction would span the whole FF split).
    """
    parts: tuple[Op, ...] = ()
    inter_bytes: int = 0        # live intermediate bytes (whole chain)

    @property
    def curve_signature_extra(self) -> tuple:
        """Joins ``op_curve_signature`` so fused curves never collide with a
        plain matmul of the same shape.  Shape-only (no names/layers): the
        chain in every identical layer interns one curve."""
        return ("fused", FUSION_VERSION, self.inter_bytes,
                tuple((p.kind, p.dims, p.reduce_dims, p.flops, p.out_bytes)
                      for p in self.parts))


# ---------------------------------------------------------------------------
# chain detection
# ---------------------------------------------------------------------------

def _mm_with_hbm_weight(op: Op) -> bool:
    """A plain (m,n,k) matmul whose weight streams from HBM — excludes the
    2-dim attention BMMs (KV/score operands) by construction."""
    return (op.kind == "matmul" and len(op.dims) == 3
            and len(op.inputs) >= 2 and op.inputs[1].dims == (2, 1)
            and op.inputs[1].from_hbm)


def _vec_consumes(a: Op, b: Op) -> bool:
    """``b`` is a pure elementwise op over ``a``'s output (GLU activations
    read half the ``gate_up`` width).  A ``from_hbm`` input (RWKV's wkv
    state, SSM scan state, embedding tables) disqualifies: the op is a
    recurrence, not an activation."""
    if b.kind != "vector" or b.layer != a.layer or b.layer < 0:
        return False
    if b.preload_dep >= 0 or any(t.from_hbm for t in b.inputs):
        return False
    return b.inputs[0].bytes_total in (a.out_bytes, a.out_bytes // 2)


def _mm_closes(a: Op, b: Op, c: Op) -> bool:
    """``c`` down-projects ``b``'s output back: contraction width matches
    the intermediate (plain) or half the up-projection (GLU).

    The hourglass check (``a`` *strictly* expands, ``c`` contracts)
    rejects chains the byte flow alone can't: ``o -> ln2 -> gate_up`` /
    ``o -> ln2 -> router`` are structurally matmul -> vector -> matmul,
    but the vector op there is a norm sitting on the residual stream, not
    an activation on ``a``'s output (the op graph doesn't carry residual
    edges).  Square projections are always that pattern — an MLP
    up-projection widens."""
    if not _mm_with_hbm_weight(c) or c.layer != a.layer or c.preload_dep >= 0:
        return False
    if c.inputs[0].bytes_total != b.out_bytes or c.dims[0] != a.dims[0]:
        return False
    if a.dims[1] <= a.dims[2] or c.dims[1] > c.dims[2]:
        return False
    return a.dims[1] in (c.dims[2], 2 * c.dims[2])


def _fits_group_sram(a: Op, b: Op, chip: ChipConfig) -> bool:
    """§8 gate: the chain's live intermediate must fit the aggregate SRAM
    of the executing core group (the whole chip/pod here)."""
    return max(a.out_bytes, b.out_bytes) <= chip.total_sram


def find_fusable_chains(graph: OpGraph, chip: ChipConfig, *,
                        pairs: bool = False) -> list[tuple[int, int]]:
    """Non-overlapping ``[start, end)`` op-index spans of fusable chains,
    greedily longest-first (triples before pairs)."""
    ops = graph.ops
    chains: list[tuple[int, int]] = []
    i = 0
    while i < len(ops) - 1:
        a = ops[i]
        if _mm_with_hbm_weight(a) and _vec_consumes(a, ops[i + 1]):
            b = ops[i + 1]
            if (i + 2 < len(ops) and _mm_closes(a, b, ops[i + 2])
                    and _fits_group_sram(a, b, chip)):
                chains.append((i, i + 3))
                i += 3
                continue
            if pairs and a.dims[1] > a.dims[2] and _fits_group_sram(a, b, chip):
                chains.append((i, i + 2))
                i += 2
                continue
        i += 1
    return chains


def _make_fused(parts: tuple[Op, ...]) -> FusedOp:
    a, b = parts[0], parts[1]
    c = parts[2] if len(parts) == 3 else None
    x = a.inputs[0]
    inputs = [TensorSpec(x.name, (0,), x.bytes_total, x.from_hbm),
              TensorSpec("w1", (1,), sum(t.bytes_total for t in a.inputs[1:]),
                         a.inputs[1].from_hbm)]
    if c is not None:
        inputs.append(TensorSpec("w2", (1,),
                                 sum(t.bytes_total for t in c.inputs[1:]),
                                 c.inputs[1].from_hbm))
        dims = (a.dims[0], c.dims[2])
        reduce_dims: tuple[int, ...] = (1,)
        out_bytes = c.out_bytes
    else:
        dims = (a.dims[0], a.dims[1])
        reduce_dims = ()
        out_bytes = b.out_bytes
    # "l3.gate_up" + "act" + "down" -> "l3.gate_up+act+down": the layer-
    # invariant suffix (name.split(".", 1)[-1]) stays identical across
    # layers, so §4.4 order replay over identical layers keeps working.
    name = "+".join([a.name] + [p.name.split(".")[-1] for p in parts[1:]])
    return FusedOp(name, "matmul", a.layer, dims, reduce_dims,
                   sum(p.flops for p in parts), tuple(inputs), out_bytes,
                   a.preload_dep, parts=tuple(parts),
                   inter_bytes=max(a.out_bytes, b.out_bytes))


def fuse_graph(graph: OpGraph, chip: ChipConfig, *,
               pairs: bool = False) -> OpGraph:
    """Rewrite ``graph`` with every fusable chain collapsed to a FusedOp.

    ``preload_dep`` indices (MoE router late binding) are remapped to the
    new op positions; ``layer_span`` is recomputed so §4.4 layer-identity
    pruning sees the fused layer shape.  Returns ``graph`` unchanged (same
    object) when nothing fuses."""
    chains = find_fusable_chains(graph, chip, pairs=pairs)
    if not chains:
        return graph
    span_end = dict(chains)
    new_ops: list[Op] = []
    old2new = [0] * len(graph.ops)
    i = 0
    while i < len(graph.ops):
        end = span_end.get(i)
        if end is None:
            old2new[i] = len(new_ops)
            new_ops.append(graph.ops[i])
            i += 1
        else:
            for k in range(i, end):
                old2new[k] = len(new_ops)
            new_ops.append(_make_fused(tuple(graph.ops[i:end])))
            i = end
    for ni, op in enumerate(new_ops):
        if op.preload_dep >= 0 and old2new[op.preload_dep] != op.preload_dep:
            new_ops[ni] = dataclasses.replace(
                op, preload_dep=old2new[op.preload_dep])
    s, e = graph.layer_span
    new_span = (old2new[s], old2new[e - 1] + 1) if e > s else \
        (len(new_ops), len(new_ops))
    return OpGraph(graph.model, graph.phase, tuple(new_ops), new_span,
                   graph.num_layers)


# ---------------------------------------------------------------------------
# fused-op execution curve
# ---------------------------------------------------------------------------

def _stage_weight_resident(part: Op, plan: ExecPlan) -> int:
    """Per-core residency of a stage's weight operands under its plan
    (mirrors the generic enumerator's shared-tensor accounting)."""
    total = 0
    used, r = plan.cores_used, plan.chunk
    for t in part.inputs[1:]:
        tb = t.tile_bytes(plan.split)
        q = 1
        for dix in t.dims:
            q *= plan.split[dix]
        g = used // max(q, 1)
        if g <= 1 or r == 1:
            total += tb
        else:
            total += min(-(-tb // g) + 2 * -(-tb // r), tb)
    return total


def _pow2_floor(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def _project_split(op: FusedOp, chip: ChipConfig,
                   stages: list[tuple[Op, ExecPlan]]) -> tuple[int, int]:
    """Map the stage plans' layouts onto the FusedOp's (M, FF) residency
    space — ``enumerate_preload_plans`` prices weight shard fractions and
    the distribution phase off this split.  The weight split is taken as
    the *coarsest* across stages (every weight is at least that sharded)
    and the row split as the finest, so per-core preload space and
    distribution volume are over-, never under-estimated."""
    w_q = []
    for part, plan in stages:
        q = 1
        for dix in part.inputs[1].dims:
            q *= plan.split[dix]
        w_q.append(max(q, 1))
    s1 = min(min(w_q), _pow2_floor(op.dims[1]))
    s0 = min(min(plan.split[0] for _, plan in stages),
             _pow2_floor(op.dims[0]))
    while s0 * s1 > chip.num_cores:
        if s1 > 1:
            s1 //= 2
        else:
            s0 //= 2
    return (s0, s1)


def enumerate_fused_exec_plans(op: FusedOp, chip: ChipConfig,
                               cost: AnalyticCostModel | None = None,
                               max_plans: int = 48) -> list[ExecPlan]:
    """Pareto execute-state curve for a fused chain, fastest/biggest first.

    Stage matmuls are priced by the *generic* enumerator under their own
    layouts — a single split tuple over (M, FF) cannot serve both stages
    (the output reduction would span the entire FF split and its round
    count would dominate).  Every (stage-a plan, stage-c plan) pairing
    contributes up to two points:

    * ``fused=True`` — the chain runs as one operator: the intermediate
      is resharded stage-a-layout -> stage-c-layout over the interconnect
      with the activation applied in-stream (no separate SRAM pass, no
      separate issue), and the second stage's weights stay resident
      through the first — the price of the single merged preload window.
    * ``fused=False`` — the composed alternative with the same stage
      plans: a separate activation op between the stages and only the
      per-stage peak footprint held (the scheduler time-multiplexes SRAM
      between the stages' weights).

    The allocator's choice between them is the fuse-vs-footprint
    tradeoff; the fused point's exec-time edge (in-stream activation vs a
    separate vector op) is small — fusion's real win is the merged
    preload window the scheduler sees.
    """
    cost = cost or AnalyticCostModel(chip)
    cap = chip.usable_sram_per_core
    a = op.parts[0]
    c = op.parts[2] if len(op.parts) == 3 else None
    vec_flops = sum(p.flops for p in op.parts if p.kind != "matmul")
    t_vec, v_space = 0.0, 0
    for v in (p for p in op.parts if p.kind != "matmul"):
        vp = enumerate_exec_plans(v, chip, cost, max_plans)[0]
        t_vec += vp.time
        v_space = max(v_space, vp.space)
    curve_a = enumerate_exec_plans(a, chip, cost, max_plans)
    raw: list[ExecPlan] = []
    if c is None:
        for pa in curve_a:
            split = _project_split(op, chip, [(a, pa)])
            # epilogue fusion: the activation runs on the VPU against the
            # output tile still in registers — its compute adds, its SRAM
            # pass and issue overhead vanish
            t_act = vec_flops / pa.cores_used / chip.core_flops_vector
            raw.append(ExecPlan(split, pa.chunk, pa.cores_used,
                                pa.time + t_act, pa.space,
                                pa.noc_exec_bytes, pa.sram_remote_bytes,
                                fused=True))
            raw.append(ExecPlan(split, pa.chunk, pa.cores_used,
                                pa.time + t_vec, max(pa.space, v_space),
                                pa.noc_exec_bytes, pa.sram_remote_bytes,
                                fused=False))
    else:
        curve_c = enumerate_exec_plans(c, chip, cost, max_plans)
        for pa in curve_a:
            for pc in curve_c:
                split = _project_split(op, chip, [(a, pa), (c, pc)])
                used = max(pa.cores_used, pc.cores_used)
                chunk = max(pa.chunk, pc.chunk)
                noc = pa.noc_exec_bytes + pc.noc_exec_bytes
                rem = pa.sram_remote_bytes + pc.sram_remote_bytes
                raw.append(ExecPlan(split, chunk, used,
                                    pa.time + t_vec + pc.time,
                                    max(pa.space, v_space, pc.space),
                                    noc, rem, fused=False))
                f_space = max(pa.space + _stage_weight_resident(c, pc),
                              pc.space)
                if f_space > cap:
                    continue
                h_core = -(-op.inter_bytes
                           // min(pa.cores_used, pc.cores_used))
                t_resh = (cost.dist_time(h_core)
                          + vec_flops / used / chip.core_flops_vector)
                raw.append(ExecPlan(split, chunk, used,
                                    pa.time + pc.time + t_resh, f_space,
                                    noc + op.inter_bytes, rem + h_core,
                                    fused=True))
    plans = _pareto(raw, lambda p: p.time, lambda p: p.space)
    if len(plans) > max_plans:
        idxs = [int(i * (len(plans) - 1) / (max_plans - 1))
                for i in range(max_plans)]
        plans = [plans[i] for i in sorted(set(idxs))]
    return plans
