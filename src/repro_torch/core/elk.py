"""Top-level ELK compile driver.

``compile_model(cfg, chip, design, ...)`` builds the operator graph and runs
the chosen §6.1 design's scheduling pipeline, returning an ``ExecutionPlan``.
Since the pass-pipeline refactor (DESIGN.md §1) this module is the thin
public API over ``core.pipeline``: compiles run through a ``CompileContext``
(shared Pareto-curve and allocation-window caches) and finished plans land
in a process-level cache consumed by serving/integration/benchmarks.

Large models (thousands of ops) exploit identical-layer periodicity: the
schedule is computed for two truncations L1 < L2 of the layer stack and the
end-to-end time is extrapolated linearly in the layer count (the backward
induction reaches a steady state after a couple of layers; tests validate
the extrapolation against exact schedules on small models).  This mirrors
the paper's own use of layer identity in §4.4 and keeps compile times in the
"minutes" regime the paper reports (Fig. 16).
"""

from __future__ import annotations

from typing import Optional

from repro_torch.chip.config import ChipConfig
from repro_torch.core.graph import Phase
from repro_torch.core.pipeline import CompileContext, compile_pipeline
from repro_torch.core.plan import ExecutionPlan
from repro_torch.models.config import ModelConfig


def compile_model(cfg: ModelConfig, chip: ChipConfig, *, batch: int,
                  seq: int, phase: Phase = "decode",
                  design: str = "ELK-Full", max_exact_ops: int = 400,
                  max_orders: int = 24,
                  ctx: Optional[CompileContext] = None,
                  cache: bool = True,
                  parallel: Optional[int] = None,
                  fusion: bool = False) -> ExecutionPlan:
    """``fusion=True`` enables the §8 inter-core fusion pass: the fused and
    unfused graphs compile against one context and the faster plan wins
    (``plan.fusion`` records whether the fused graph was selected)."""
    return compile_pipeline(cfg, chip, batch=batch, seq=seq, phase=phase,
                            design=design, max_exact_ops=max_exact_ops,
                            max_orders=max_orders, ctx=ctx, cache=cache,
                            parallel=parallel, fusion=fusion)


def compare_designs(cfg: ModelConfig, chip: ChipConfig, *, batch: int,
                    seq: int, phase: Phase = "decode",
                    designs=("Basic", "Static", "ELK-Dyn", "ELK-Full",
                             "Ideal"),
                    ctx: Optional[CompileContext] = None,
                    fusion: bool = False,
                    **kw) -> dict[str, ExecutionPlan]:
    """Compile every design against one shared ``CompileContext`` — curves
    and allocation windows are computed once and reused across designs.
    ``fusion`` applies the §8 pass to every design; check ``plan.fusion``
    per design to see where the fused graph actually won."""
    ctx = ctx or CompileContext(chip)
    return {d: compile_model(cfg, chip, batch=batch, seq=seq, phase=phase,
                             design=d, ctx=ctx, fusion=fusion, **kw)
            for d in designs}
