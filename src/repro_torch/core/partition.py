"""Operator partition plans (paper §4.3 intra-operator tradeoffs, §5.2).

Execute-state plans (Tradeoff 1, Fig. 11)
-----------------------------------------
A plan splits the op's iteration space over cores, ``<s1,s2,...>`` (§5: "evenly
slices each dimension"), with a rotation-chunk count ``r`` following the
compute-shift execution model of T10 [34]:

* every input tensor spanned by only a subset of dims is *shared* by a group
  of ``g = P/q`` cores (Fig. 3);
* ``r == 1``: the shared tile is fully resident per core during execution
  (fast, big execution space);
* ``r > 1``: the tile is rotated between group peers in ``1/r`` chunks
  (small execution space = own shard + double-buffered chunk, but inter-core
  traffic during execution + per-chunk issue overhead + SRAM port contention).

Larger execution space => faster execution and less exec-time interconnect
traffic — exactly Fig. 5's measured correlation.

Preload-state plans (Tradeoffs 2+3)
-----------------------------------
Given an execute-state plan, a preload fraction ``f`` picks how much of each
shared tile the HBM controllers broadcast per core at preload time
(paper: split a tile shared by 4 cores into 1, 2 or 4 chunks => each core
receives 1, 1/2, 1/4).  The *data-distribution phase* fetches the rest from
peers when the op transitions preload-state -> execute-state.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator

from repro_torch.chip.config import ChipConfig
from repro_torch.core.cost_model import AnalyticCostModel
from repro_torch.core.graph import Op

_CHUNKS = (1, 2, 4, 8)


@dataclasses.dataclass(frozen=True)
class ExecPlan:
    split: tuple[int, ...]
    chunk: int
    cores_used: int
    time: float            # contention-free per-op execution time
    space: int             # per-core execution space (bytes)
    noc_exec_bytes: int    # total inter-core volume during execution
    sram_remote_bytes: int # per-core bytes served to peers (contention ③)
    # True when this point runs the chain of a FusedOp as one SRAM pass
    # (core/fusion.py); False on every plain-op plan and on the composed
    # (store-reload) alternatives a fused curve carries.
    fused: bool = False

    def key(self) -> tuple:
        return (self.split, self.chunk)


@dataclasses.dataclass(frozen=True)
class PreloadPlan:
    frac: float
    space: int                 # per-core preload space (bytes)
    dist_time: float           # data-distribution time (preload->exec state)
    noc_dist_bytes: int        # inter-core volume of the distribution phase
    noc_preload_bytes: int     # interconnect bytes HBM-controllers -> cores
    hbm_bytes: int             # off-chip read volume


# ---------------------------------------------------------------------------

def op_curve_signature(op: Op) -> tuple:
    """Hashable key capturing everything plan enumeration depends on.

    Identical layers produce ops with identical signatures (only ``name``/
    ``layer``/``preload_dep`` differ), so one curve computation serves every
    repetition — the ``PlanCurveCache`` in ``core.pipeline`` keys on this.

    Op subclasses that enumerate differently (``core.fusion.FusedOp``)
    expose ``curve_signature_extra``; appending it keeps a fused chain from
    ever sharing a curve with a plain op of the same outer shape.
    """
    base = (op.kind, op.dims, op.reduce_dims, op.flops, op.out_bytes,
            tuple((t.dims, t.bytes_total, t.from_hbm) for t in op.inputs))
    extra = getattr(op, "curve_signature_extra", None)
    return base if extra is None else base + (extra,)


def _pow2_splits(dim: int, cores: int) -> list[int]:
    out, s = [], 1
    while s <= min(dim, cores):
        out.append(s)
        s *= 2
    return out


def _split_iter(dims: tuple[int, ...], cores: int) -> Iterator[tuple[int, ...]]:
    choices = [_pow2_splits(d, cores) for d in dims]

    def rec(i: int, prod: int, acc: list[int]):
        if i == len(dims):
            yield tuple(acc)
            return
        for s in choices[i]:
            if prod * s > cores:
                break
            acc.append(s)
            yield from rec(i + 1, prod * s, acc)
            acc.pop()

    yield from rec(0, 1, [])


def _pareto(plans, time_of, space_of):
    """Keep plans where no other plan is <= in both time and space."""
    plans = sorted(plans, key=lambda p: (space_of(p), time_of(p)))
    out, best_t = [], math.inf
    for p in plans:
        t = time_of(p)
        if t < best_t - 1e-15:
            out.append(p)
            best_t = t
    # out is sorted by increasing space, decreasing time; re-sort by space desc
    # so index 0 = fastest/biggest (allocator starts there and downgrades).
    return list(reversed(out))


# ---------------------------------------------------------------------------

def enumerate_exec_plans(op: Op, chip: ChipConfig,
                         cost: AnalyticCostModel | None = None,
                         max_plans: int = 48) -> list[ExecPlan]:
    """All Pareto-optimal execute-state plans, fastest (max space) first."""
    cost = cost or AnalyticCostModel(chip)
    cap = chip.usable_sram_per_core
    raw: list[ExecPlan] = []
    raw_spill: list[tuple] = []
    for split in _split_iter(op.dims, chip.num_cores):
        used = 1
        for s in split:
            used *= s
        tile_dims = tuple(-(-d // s) for d, s in zip(op.dims, split))
        tile_flops = op.flops / used
        chunk_opts = _CHUNKS if op.kind == "matmul" else (1,)
        for r in chunk_opts:
            space = -(-op.out_bytes // used)
            noc_total = 0
            remote_per_core = 0
            read_bytes = space
            rounds = 0
            feasible = True
            for t in op.inputs:
                tb = t.tile_bytes(split)
                q = 1
                for dix in t.dims:
                    q *= split[dix]
                g = used // max(q, 1)
                read_bytes += tb
                if g <= 1:
                    space += tb
                    continue
                if r == 1:
                    resident = tb                      # full replication
                else:
                    resident = -(-tb // g) + 2 * -(-tb // r)
                    if resident > tb:
                        resident = tb
                space += resident
                moved = tb - (-(-tb // g))             # (g-1)/g of the tile
                if r > 1:
                    # each of the q distinct tiles visits its g-1 group peers
                    noc_total += tb * (g - 1) * q
                    remote_per_core += moved
                    rounds += r * (g - 1)
            # reduction: partial outputs combined across reduce-split cores
            red = 1
            for dix in op.reduce_dims:
                red *= split[dix]
            if red > 1:
                red_bytes = op.out_bytes // max(used // red, 1)
                noc_total += red_bytes * (red - 1)
                remote_per_core += -(-op.out_bytes // used) * 2
                rounds += red - 1
            if space > cap:
                feasible = False
            if not feasible:
                # remember the most-compact infeasible plan: ops whose
                # minimum tile exceeds per-core SRAM (trillion-param MoE
                # experts on an IPU-class chip) fall back to a *spill plan*
                # — per-chunk streaming through SRAM, modeled by the
                # SRAM-feed bound in tile_time with r = ceil(space/cap).
                raw_spill.append((space, split, r, tile_dims, tile_flops,
                                  read_bytes, noc_total, remote_per_core,
                                  rounds))
                continue
            t_tile = cost.tile_time(op.kind, tile_dims, tile_flops,
                                    read_bytes, chunks=max(r, 1) + rounds)
            # topology-aware rotation cost: neighbor transfers on flat
            # topologies, stretched by slow-tier crossings on hierarchical
            # ones (cost_model delegates to chip.topo)
            t_rot = cost.rot_time(remote_per_core, rounds=max(rounds, 1))
            if chip.sram_port_blocking and remote_per_core:
                # footnote 2: remote reads pause local execution
                t_tile += remote_per_core / chip.sram_bw_per_core
            raw.append(ExecPlan(split, r, used, t_tile + t_rot, space,
                                noc_total, remote_per_core))
    if not raw and raw_spill:
        # spill plan: stream the tile through SRAM in ceil(space/cap)
        # rounds; claims the full SRAM and pays the extra chunk overhead
        space, split, r, tile_dims, tile_flops, read_bytes, noc_total, \
            remote_per_core, rounds = min(raw_spill, key=lambda t: t[0])
        spill_rounds = -(-space // cap)
        t_tile = cost.tile_time(op.kind, tile_dims, tile_flops,
                                read_bytes,
                                chunks=max(r, 1) + rounds + spill_rounds)
        t_tile += read_bytes / chip.sram_bw_per_core * spill_rounds
        used = 1
        for s in split:
            used *= s
        raw.append(ExecPlan(split, r, used, t_tile, cap, noc_total,
                            remote_per_core))
    plans = _pareto(raw, lambda p: p.time, lambda p: p.space)
    if len(plans) > max_plans:
        idxs = [int(i * (len(plans) - 1) / (max_plans - 1))
                for i in range(max_plans)]
        plans = [plans[i] for i in sorted(set(idxs))]
    return plans


def enumerate_preload_plans(op: Op, exec_plan: ExecPlan, chip: ChipConfig,
                            cost: AnalyticCostModel | None = None,
                            ) -> list[PreloadPlan]:
    """Pareto-optimal preload-state plans for an op whose execute-state plan
    is fixed (paper §4.3, Tradeoffs 2 and 3).  Sorted max-space first."""
    cost = cost or AnalyticCostModel(chip)
    split, used, r = exec_plan.split, exec_plan.cores_used, exec_plan.chunk

    shared = []   # (tile_bytes, group, resident_need_frac, q, hbm?)
    base_space = 0          # non-shared per-core preload bytes
    hbm_bytes = 0
    base_noc = 0
    for t in op.inputs:
        tb = t.tile_bytes(split)
        q = 1
        for dix in t.dims:
            q *= split[dix]
        g = used // max(q, 1)
        if t.from_hbm:
            hbm_bytes += t.bytes_total
        if g <= 1:
            base_space += tb
            if t.from_hbm:
                base_noc += t.bytes_total
            continue
        need = 1.0 if r == 1 else 1.0 / g
        shared.append((tb, g, need, q, t.from_hbm))

    fracs = {1.0}
    for _, g, _, _, _ in shared:
        f = 1.0
        while f > 1.0 / g:
            f /= 2
            fracs.add(max(f, 1.0 / g))
        fracs.add(1.0 / g)
    out = []
    for f in sorted(fracs, reverse=True):
        space = base_space
        noc_pre = base_noc
        dist_vol_per_core = 0
        noc_dist = 0
        for tb, g, need, q, from_hbm in shared:
            ff = max(f, 1.0 / g)
            space += int(tb * ff)
            if from_hbm:
                noc_pre += int(tb * ff * g) * q
            missing = max(0.0, need - ff)
            dist_vol_per_core += int(tb * missing)
            noc_dist += int(tb * missing) * used
        t_dist = cost.dist_time(dist_vol_per_core) if dist_vol_per_core else 0.0
        out.append(PreloadPlan(f, space, t_dist, noc_dist, noc_pre, hbm_bytes))
    return _pareto(out, lambda p: p.dist_time, lambda p: p.space)
