"""Lower an ELK ``ExecutionPlan`` into runtime knobs (DESIGN.md §3).

Two integration levels:

* ``pod_plan``  — read the TPU pod as one ICCA chip (chips = cores, ICI =
  interconnect, the sharded weight store = off-chip memory), run the
  paper's scheduler on the arch's decode/prefill graph, and extract the
  runtime knobs the serving/training stacks consume: the **prefetch
  depth** (paper: preload number) for the gather-ahead window and the
  **resident fraction** (paper: preload-state fraction f) that decides
  FSDP sharding of block weights.

* ``vmem_plan`` — read one TPU chip as an ICCA chip at the VMEM level and
  pick Pallas matmul block shapes (bm, bn, bk): the (bm, bn) fp32
  accumulator + current operand tiles are the execution space, the grid
  pipeline's in-flight next blocks are the preload space.  The search is
  the paper's §4.3 greedy on a closed-form cost (HBM traffic per FLOP),
  constrained to MXU-aligned multiples of 128.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.chip.config import (MB, ChipConfig, tpu_v5e_pod, tpu_v5e_pod_hier,
                               tpu_v5e_vmem)
from repro_torch.core.elk import compile_model
from repro_torch.core.graph import Phase
from repro_torch.core.plan import ExecutionPlan
from repro_torch.models.config import ModelConfig

# share of the on-chip store the gather-ahead window may occupy; the other
# half stays execution state (the §3 space split at pod level)
_PREFETCH_SRAM_SHARE = 0.5


@dataclasses.dataclass(frozen=True)
class PodKnobs:
    """Runtime knobs for the pod-level ELK realization."""
    prefetch_depth: int          # gather-ahead window (preload number p)
    resident_fraction: float     # preload-state fraction f (1/k of weights)
    fsdp: bool                   # f < 1 => weights stay sharded (ZeRO-3)
    design: str = "ELK-Full"
    # pipeline mode (DESIGN.md §7): filled when the pod plans the graph as
    # pipeline stages across its chips instead of one flat core pool
    num_stages: int = 1
    stage_boundaries: tuple = ()     # layer cut points: stage s owns
    #                                  [boundary[s-1], boundary[s])
    microbatch: int = 0              # requests per microbatch
    microbatches: int = 1            # concurrent microbatch groups
    interval_s: float = 0.0          # steady per-microbatch interval
    batch_interval_s: float = 0.0    # one decode round of the whole batch
    # hybrid mode (DESIGN.md §9): per-stage tensor-parallel width and
    # data-parallel replica count (all 1s for the pure pipeline)
    stage_widths: tuple = ()
    stage_replicas: tuple = ()


def _plan_knobs(plan: ExecutionPlan, chip: ChipConfig) -> tuple[int, float]:
    """(prefetch depth in layer-blocks, resident fraction) of one plan.

    The prefetch-depth clamp is derived from capacity, not magic numbers:
    the gather-ahead window may hold at most the layer-blocks that fit in
    the prefetch share of the chip's on-chip store, and never fewer than
    one block — the window cannot be empty while an op is executing (§4.5:
    an operator must be preloaded before it executes).
    """
    lo, hi = plan.graph.layer_span
    ops_per_layer = max(hi - lo, 1)
    p_ops = max(plan.mean_preload_number, 0.0)
    per_layer_hbm = sum(op.hbm_bytes
                        for op in plan.graph.ops[lo:hi]) or 1
    cap_layers = max(
        int(chip.total_sram * _PREFETCH_SRAM_SHARE) // per_layer_hbm, 1)
    p_layers = min(max(math.ceil(p_ops / ops_per_layer), 1), cap_layers)
    fr = [d.preload_plan.frac for d in plan.decisions
          if d.preload_plan is not None and plan.graph.ops[d.op_idx].hbm_bytes]
    f = sum(fr) / len(fr) if fr else 1.0
    return p_layers, f


def pod_plan(cfg: ModelConfig, *, batch: int, seq: int,
             phase: Phase = "decode", num_chips: int = 256,
             design: str = "ELK-Full", chip: Optional[ChipConfig] = None,
             mode: str = "flat",
             num_stages: Optional[int] = None,
             widths: Optional[tuple] = None,
             replicas: Optional[tuple] = None) -> PodKnobs:
    """Run the faithful ELK compiler against the pod model and translate
    its decisions to runtime knobs.

    ``mode="flat"`` (default) reads the whole pod as one ICCA chip, exactly
    as before.  ``mode="pipeline"`` partitions the layer stack into
    pipeline stages across the pod's chips (``core.pipeline_pod``) and
    additionally returns the stage boundaries, microbatch knobs and the
    steady-state interval the serving stack sizes admission from.
    ``mode="hybrid"`` runs the joint (cut x width x replicas x microbatch)
    search (DESIGN.md §9); never worse than ``"pipeline"``, bit-identical
    to it when ``widths``/``replicas`` are pinned to ``(1,)``.

    Repeat calls for the same (model, shape, design) hit the process-level
    plan caches (DESIGN.md §2, §7), so the serving/training stacks can ask
    for knobs on the request path without recompiling.
    """
    if mode not in ("flat", "pipeline", "hybrid"):
        raise ValueError(f"unknown pod_plan mode {mode!r}")
    if mode in ("pipeline", "hybrid"):
        from repro_torch.core.pipeline_pod import plan_hybrid, plan_pipeline
        chip = chip or tpu_v5e_pod_hier(num_chips)
        if mode == "hybrid":
            pp = plan_hybrid(cfg, chip, batch=batch, seq=seq, phase=phase,
                             design=design, widths=widths, replicas=replicas)
        else:
            pp = plan_pipeline(cfg, chip, batch=batch, seq=seq, phase=phase,
                               design=design, num_stages=num_stages)
        # knobs from the bottleneck stage: its plan paces the pipeline
        bottleneck = max(pp.stages, key=lambda st: st.effective_interval)
        flat = pp.num_stages == 1 and pp.stages[0].chips == 1
        member = chip if flat else chip.chip_view().chip
        depth, f = _plan_knobs(bottleneck.plan, member)
        return PodKnobs(prefetch_depth=depth, resident_fraction=f,
                        fsdp=f < 0.999, design=design,
                        num_stages=pp.num_stages,
                        stage_boundaries=tuple(st.layers[1]
                                               for st in pp.stages),
                        microbatch=pp.microbatch,
                        microbatches=pp.microbatches,
                        interval_s=pp.interval,
                        batch_interval_s=pp.batch_interval,
                        stage_widths=tuple(st.width for st in pp.stages),
                        stage_replicas=tuple(st.replicas
                                             for st in pp.stages))
    chip = chip or tpu_v5e_pod(num_chips)
    plan = compile_model(cfg, chip, batch=batch, seq=seq, phase=phase,
                         design=design, max_orders=8)
    # preload number: ops resident in preload state while one executes.
    # The pod runtime prefetches whole layer-blocks, so convert the mean
    # op-level preload number to layers: ops-per-layer is the graph period.
    p_layers, f = _plan_knobs(plan, chip)
    return PodKnobs(prefetch_depth=p_layers, resident_fraction=f,
                    fsdp=f < 0.999, design=design)


# ---------------------------------------------------------------------------
# VMEM-level block planning for the Pallas kernels
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class VmemPlan:
    bm: int
    bn: int
    bk: int
    vmem_bytes: int              # execution + preload footprint claimed
    hbm_traffic: int             # bytes moved for the whole matmul


def _align(v: int, a: int = 128) -> int:
    return max(a, (v // a) * a)


def vmem_plan(m: int, n: int, k: int, *,
              chip: Optional[ChipConfig] = None,
              dtype_bytes: int = 2,
              vmem_budget: Optional[int] = None) -> VmemPlan:
    """Choose (bm, bn, bk) for ``elk_matmul``.

    VMEM model (the ELK §3 split): execution space = fp32 accumulator
    (bm*bn*4) + current operand tiles; preload space = the next operand
    tiles in flight (Pallas double-buffers inputs => 2x operand bytes).

    Cost = HBM traffic: x is read N/bn times, y is read M/bm times, out
    written once: larger (bm, bn) divides re-reads; larger bk amortizes
    accumulator flushes (already 1 here) but enlarges operand tiles —
    the greedy therefore grows bm=bn first (quadratic reuse win), then bk.
    """
    chip = chip or tpu_v5e_vmem()
    budget = vmem_budget or int(chip.sram_per_core * 0.75)

    def footprint(bm, bn, bk):
        acc = bm * bn * 4
        operands = (bm * bk + bk * bn) * dtype_bytes
        return acc + 2 * operands          # double-buffered preload

    def traffic(bm, bn, bk):
        xn = math.ceil(n / bn)             # x re-reads
        ym = math.ceil(m / bm)             # y re-reads
        return (m * k * xn + k * n * ym) * dtype_bytes + m * n * dtype_bytes

    bm = bn = bk = 128
    best = (bm, bn, bk)
    # greedy doubling along the steepest-traffic-reduction axis (§4.3's
    # delta rule with signs flipped: grow the dim with best bytes-saved
    # per VMEM-byte-spent)
    while True:
        cands = []
        for dim in ("m", "n", "k"):
            nb = {"m": (min(2 * bm, _align(m)), bn, bk),
                  "n": (bm, min(2 * bn, _align(n)), bk),
                  "k": (bm, bn, min(2 * bk, _align(k)))}[dim]
            if nb == (bm, bn, bk):
                continue
            if footprint(*nb) > budget:
                continue
            saved = traffic(bm, bn, bk) - traffic(*nb)
            spent = footprint(*nb) - footprint(bm, bn, bk)
            cands.append((saved / max(spent, 1), nb))
        if not cands:
            break
        gain, nb = max(cands, key=lambda c: c[0])
        if gain <= 0:
            break
        bm, bn, bk = nb
        best = nb
    bm, bn, bk = best
    return VmemPlan(bm, bn, bk, footprint(bm, bn, bk), traffic(bm, bn, bk))
