"""Execution plan artifacts produced by the ELK scheduler."""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.graph import OpGraph
from repro_torch.core.partition import ExecPlan, PreloadPlan


@dataclasses.dataclass
class OpTiming:
    t_s_pre: float = 0.0
    t_e_pre: float = 0.0
    t_s_exe: float = 0.0
    t_e_exe: float = 0.0


@dataclasses.dataclass
class OpDecision:
    op_idx: int
    preload_number: int              # residents during this op's execution
    exec_plan: ExecPlan
    preload_plan: Optional[PreloadPlan]   # this op's own preload-state plan
    stall: float = 0.0               # interconnect-contention stall charged here
    # memory tier the weight block is preloaded from (DESIGN.md §10);
    # -1 = the chip's backing tier (legacy two-level plans)
    src_tier: int = -1


@dataclasses.dataclass
class Breakdown:
    """Fig. 18(a) categories, in seconds."""
    preload_only: float = 0.0
    execute_only: float = 0.0
    overlapped: float = 0.0
    interconnect_stall: float = 0.0

    @property
    def total(self) -> float:
        return (self.preload_only + self.execute_only + self.overlapped
                + self.interconnect_stall)


@dataclasses.dataclass
class Utilization:
    hbm: float = 0.0
    interconnect: float = 0.0
    flops: float = 0.0
    achieved_tflops: float = 0.0


@dataclasses.dataclass
class ExecutionPlan:
    graph: OpGraph
    chip_name: str
    design: str                       # Basic | Static | ELK-Dyn | ELK-Full | Ideal
    decisions: list[OpDecision]
    preload_order: list[int]          # op indices in preload-issue sequence
    timing: list[OpTiming]
    total_time: float
    breakdown: Breakdown
    util: Utilization
    extrapolated_from_layers: int = 0  # 0 = exact full-model schedule
    # True when the compile-level fusion knob was on AND the fused graph
    # won the base-vs-fused selection (plan.graph then contains FusedOps).
    fusion: bool = False

    @property
    def mean_preload_number(self) -> float:
        return sum(d.preload_number for d in self.decisions) / max(
            len(self.decisions), 1)

    def edit_distance(self) -> float:
        """Mean displacement of ops between preload order and exec order
        (paper §6.2 reports an average edit distance of 2.9 steps)."""
        n = len(self.preload_order)
        if not n:
            return 0.0
        return sum(abs(pos - op) for pos, op in
                   enumerate(self.preload_order)) / n
