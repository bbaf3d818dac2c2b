"""Design-space sweeps, shared by ``examples/dse_explore.py`` and the
benchmark sections.

* :func:`topology_sweep` (paper §6.4) — one row per (topology, design):
  the compiled plan's latency plus an event-simulated latency on a small
  layer truncation (the simulator exercises the per-link-class contention
  the plan estimate approximates), and the topology's routing summary.
* :func:`pipeline_sweep` (DESIGN.md §7) — stage-count x chip-count sweep
  of the pipeline-parallel pod planner: steady-state interval vs the
  replicated single-chip baseline, with a simulated interval on a layer
  truncation to validate the planner's estimate.
* :func:`hybrid_sweep` (DESIGN.md §9) — topology x model sweep of the
  joint (cut x width x replicas x microbatch) hybrid planner against the
  pure pipeline it is never allowed to lose to, with a simulated interval
  validating the hybrid plan (collectives + replica servers included).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

from repro_torch.chip.config import ChipConfig, ipu_pod4_hbm


def topology_sweep(cfg, topologies: Sequence[str], *, batch: int = 32,
                   seq: int = 2048, designs: Sequence[str] = ("ELK-Full",),
                   max_orders: int = 4, sim_layers: int = 2,
                   chip_factory: Callable[..., ChipConfig] = ipu_pod4_hbm,
                   ) -> list[dict]:
    from repro_torch.chip.simulator import simulate
    from repro_torch.core.baselines import build_plan
    from repro_torch.core.elk import compare_designs
    from repro_torch.core.graph import build_graph
    from repro_torch.core.pipeline import CompileContext

    sim_cfg = dataclasses.replace(cfg, num_layers=min(cfg.num_layers,
                                                      sim_layers))
    g = build_graph(sim_cfg, batch=batch, seq=seq, phase="decode")
    rows = []
    for topo in topologies:
        chip = chip_factory(topology=topo)
        ctx = CompileContext(chip)   # curves/windows shared across designs
        plans = compare_designs(cfg, chip, batch=batch, seq=seq,
                                phase="decode", designs=tuple(designs),
                                max_orders=max_orders, ctx=ctx)
        t = chip.topo
        for d, p in plans.items():
            # simulate *this design's* plan on the truncation, so each row
            # pairs a plan estimate with its own simulated counterpart.
            # Ideal is a roofline with no preload plans — the simulator
            # would see zero preload traffic, so no sim column for it.
            sim = (simulate(build_plan(g, chip, d, max_orders=max_orders,
                                       ctx=ctx), chip)
                   if d != "Ideal" else None)
            rows.append({
                "topology": topo, "design": d,
                "latency_ms": round(p.total_time * 1e3, 3),
                "sim_ms": round(sim.total_time * 1e3, 3) if sim else "",
                "sim_layers": sim_cfg.num_layers if sim else "",
                "noc_util": round(p.util.interconnect, 4),
                "preload_hops": round(t.preload_hops, 2),
                "delivery_tbps": round(t.preload_delivery_bw / 1e12, 3),
                "bisection_tbps": round(t.bisection_bw / 1e12, 3),
                "mean_preload_number": round(p.mean_preload_number, 2),
            })
    return rows


def scale_pod(base: ChipConfig, num_chips: int) -> ChipConfig:
    """Scale a pod config to ``num_chips`` chips, keeping per-chip
    resources (cores, HBM share, controllers) fixed."""
    n0 = max(base.num_chips, 1)
    per_cores = base.cores_per_chip
    per_hbm = base.hbm_bw / n0
    per_ctrl = max(base.hbm_controllers // n0, 1)
    return base.scaled(name=f"{base.name}-x{num_chips}",
                       num_chips=num_chips,
                       num_cores=per_cores * num_chips,
                       hbm_bw=per_hbm * num_chips,
                       hbm_controllers=per_ctrl * num_chips)


def pipeline_sweep(cfg, *, num_chips_list: Sequence[int] = (1, 2, 4),
                   stage_counts: Optional[Sequence[int]] = None,
                   batch: int = 32, seq: int = 2048,
                   design: str = "ELK-Full", max_orders: int = 4,
                   sim_layers: int = 8,
                   chip_factory: Callable[..., ChipConfig] = ipu_pod4_hbm,
                   ) -> list[dict]:
    """Stage-count x chip-count sweep of the pipeline-parallel planner.

    Each row pairs the planner's steady-state decode interval for the whole
    running batch (``microbatches * bottleneck interval``) with the
    replicated single-chip baseline (every chip serves ``batch/num_chips``
    requests with a full model replica) and with an event-simulated
    interval on a ``sim_layers`` truncation — the planner estimate the CI
    gate holds to within 2x.
    """
    from repro_torch.chip.simulator import simulate_pipeline
    from repro_torch.core.pipeline_pod import plan_pipeline, replicated_plan

    base = chip_factory(topology="hier_pod")
    rows = []
    for n in num_chips_list:
        pod = scale_pod(base, n)
        for s in (stage_counts or (n,)):
            if s > n or s > cfg.num_layers:
                continue
            pp = plan_pipeline(cfg, pod, batch=batch, seq=seq,
                               design=design, num_stages=s,
                               max_orders=max_orders)
            rep = replicated_plan(cfg, pod, batch=batch, seq=seq,
                                  design=design, max_orders=max_orders)
            # simulate on a truncation: exact (non-extrapolated) stage
            # plans, same per-link-class contention machinery
            sim_cfg = dataclasses.replace(
                cfg, num_layers=min(cfg.num_layers, max(sim_layers, s)))
            pps = plan_pipeline(sim_cfg, pod, batch=batch, seq=seq,
                                design=design, num_stages=s,
                                max_orders=max_orders)
            sim = simulate_pipeline(pps, pod)
            rows.append({
                "model": cfg.name, "num_chips": n, "stages": pp.num_stages,
                "microbatch": pp.microbatch,
                "microbatches": pp.microbatches,
                "cuts": "/".join(str(st.layers[1]) for st in pp.stages),
                "interval_ms": round(pp.interval * 1e3, 3),
                "batch_interval_ms": round(pp.batch_interval * 1e3, 3),
                "fill_ms": round(pp.fill_time * 1e3, 3),
                "replicated_ms": round(rep.total_time * 1e3, 3),
                "speedup_vs_replicated": round(
                    rep.total_time / pp.batch_interval, 3)
                if pp.batch_interval else "",
                "sim_layers": sim_cfg.num_layers,
                "sim_interval_ms": round(sim.interval * 1e3, 3),
                "plan_sim_ratio": round(sim.interval / pps.interval, 3)
                if pps.interval else "",
            })
    return rows


def hybrid_sweep(models: Sequence[str] = ("opt_30b",), *,
                 topologies: Sequence[str] = ("all2all", "mesh2d", "torus2d",
                                              "ring", "hier_pod"),
                 num_chips: int = 4, batch: int = 32, seq: int = 2048,
                 design: str = "ELK-Full", max_orders: int = 4,
                 sim_layers: int = 8,
                 microbatches: Optional[int] = None,
                 chip_factory: Callable[..., ChipConfig] = ipu_pod4_hbm,
                 ) -> list[dict]:
    """Topology x model sweep of the hybrid planner (DESIGN.md §9).

    Each row pairs the pure-pipeline plan with the hybrid plan on the same
    ``sim_layers`` truncation (exact stage plans, one memoized compile
    context per (model, topology) shared across all widths and microbatch
    candidates) and event-simulates the hybrid plan — replica servers and
    intra-stage collectives included.  Two gates ride on the rows:
    per-request hybrid time never above pipeline (the planner is
    never-worse by construction, so a violation is a regression) and the
    simulated steady interval within 2x of the planner's.
    """
    from repro_torch.chip.simulator import simulate_pipeline
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline_pod import plan_hybrid, plan_pipeline

    rows = []
    for model in models:
        cfg = get_config(model)
        sim_cfg = dataclasses.replace(cfg, num_layers=min(cfg.num_layers,
                                                          sim_layers))
        for topo in topologies:
            pod = scale_pod(chip_factory(topology=topo), num_chips)
            # hybrid first: it plans the pure pipeline internally through
            # the shared context, so the explicit call below hits the cache
            hyb = plan_hybrid(sim_cfg, pod, batch=batch, seq=seq,
                              design=design, max_orders=max_orders,
                              microbatches=microbatches)
            pipe = plan_pipeline(sim_cfg, pod, batch=batch, seq=seq,
                                 design=design, max_orders=max_orders)
            sim = simulate_pipeline(hyb, pod)
            pipe_req = pipe.batch_interval / max(pipe.batch, 1)
            hyb_req = hyb.batch_interval / max(hyb.batch, 1)
            rows.append({
                "model": cfg.name, "topology": topo, "num_chips": num_chips,
                "pipe_interval_ms": round(pipe.interval * 1e3, 3),
                "pipe_batch_interval_ms": round(pipe.batch_interval * 1e3,
                                                3),
                "pipe_req_us": round(pipe_req * 1e6, 3),
                "hybrid_interval_ms": round(hyb.interval * 1e3, 3),
                "hybrid_batch_interval_ms": round(hyb.batch_interval * 1e3,
                                                  3),
                "hybrid_req_us": round(hyb_req * 1e6, 3),
                "hybrid_speedup": round(pipe_req / hyb_req, 3)
                if hyb_req else "",
                "hybrid_won": int(hyb_req < pipe_req),
                "stages": hyb.num_stages,
                "microbatch": hyb.microbatch,
                "microbatches": hyb.microbatches,
                "cuts": "/".join(str(st.layers[1]) for st in hyb.stages),
                "widths": "/".join(str(st.width) for st in hyb.stages),
                "replicas": "/".join(str(st.replicas) for st in hyb.stages),
                "sim_layers": sim_cfg.num_layers,
                "sim_interval_ms": round(sim.interval * 1e3, 3),
                "plan_sim_ratio": round(sim.interval / hyb.interval, 3)
                if hyb.interval else "",
            })
    return rows


def tier_sweep(model: str = "opt_30b", *,
               sizes_gb: Sequence[float] = (4, 8, 16),
               bws_tbps: Sequence[float] = (2, 8, 16),
               num_chips: int = 4, batch: int = 4, seq: int = 2048,
               design: str = "ELK-Full", max_orders: int = 2,
               sim_layers: int = 8,
               chip_factory: Callable[..., ChipConfig] = ipu_pod4_hbm,
               ) -> list[dict]:
    """Stacked-DRAM (size x bandwidth) sweep of the tiered-memory planner
    (DESIGN.md §10).

    The base pod is planned once; every swept row appends a stacked tier
    via :meth:`ChipConfig.with_stacked_dram` and re-plans the same decode
    round.  The tiered planner is never-worse by construction
    (``_prefer_untiered``), so ``round_ms`` can only drop: ``improved``
    marks rows where the stacked tier strictly beat the flat HBM backing
    store, and the event simulator validates the plan estimate on every
    improved row (CI gates on both).
    """
    from repro_torch.chip.config import GB, TB
    from repro_torch.chip.simulator import simulate_pipeline
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline_pod import plan_pipeline

    cfg = get_config(model)
    sim_cfg = dataclasses.replace(cfg, num_layers=min(cfg.num_layers,
                                                      sim_layers))
    pod = scale_pod(chip_factory(topology="hier_pod"), num_chips)
    base = plan_pipeline(sim_cfg, pod, batch=batch, seq=seq, design=design,
                         max_orders=max_orders)
    base_sim = simulate_pipeline(base, pod)
    rows = [{
        "model": cfg.name, "num_chips": num_chips,
        "tier": "none", "size_gb": "", "bw_tbps": "",
        "round_ms": round(base.batch_interval * 1e3, 4),
        "interval_ms": round(base.interval * 1e3, 4),
        "speedup": 1.0, "improved": 0,
        "staged_mb": 0.0,
        "sim_layers": sim_cfg.num_layers,
        "sim_interval_ms": round(base_sim.interval * 1e3, 4),
        "plan_sim_ratio": round(base_sim.interval / base.interval, 3)
        if base.interval else "",
    }]
    for size in sizes_gb:
        for bw in bws_tbps:
            tiered = pod.with_stacked_dram(int(size * GB), bw * TB)
            pp = plan_pipeline(sim_cfg, tiered, batch=batch, seq=seq,
                               design=design, max_orders=max_orders)
            # the never-worse fallback returns the base pod's (cached) plan
            # object itself — its src_tier indices refer to the *two-tier*
            # chip, so count/simulate it against the chip it was planned on
            if pp is base:
                sim, staged = base_sim, 0
            else:
                sim = simulate_pipeline(pp, tiered)
                backing = len(tiered.chip_view().chip.mem_tiers) - 1
                staged = sum(d.preload_plan.hbm_bytes
                             for st in pp.stages for d in st.plan.decisions
                             if d.preload_plan is not None
                             and 0 < d.src_tier < backing)
            rows.append({
                "model": cfg.name, "num_chips": num_chips,
                "tier": "stacked", "size_gb": size, "bw_tbps": bw,
                "round_ms": round(pp.batch_interval * 1e3, 4),
                "interval_ms": round(pp.interval * 1e3, 4),
                "speedup": round(base.batch_interval / pp.batch_interval, 4)
                if pp.batch_interval else "",
                "improved": int(pp.batch_interval < base.batch_interval),
                "staged_mb": round(staged / 1e6, 1),
                "sim_layers": sim_cfg.num_layers,
                "sim_interval_ms": round(sim.interval * 1e3, 4),
                "plan_sim_ratio": round(sim.interval / pp.interval, 3)
                if pp.interval else "",
            })
    return rows


def kv_offload_sweep(model: str = "opt_30b", *,
                     sizes_gb: Sequence[float] = (16, 32, 64, 128),
                     bw_tbps: float = 2.0, slots: int = 4,
                     cache_capacity: int = 2048,
                     kv_dtype: str = "bfloat16",
                     smoke: bool = False) -> list[dict]:
    """Backing-tier size sweep of the serve-side KV offload design space
    (DESIGN.md §11): for each stacked-DRAM size on an SRAM-only chip
    (``ipu_mk2`` — no unbounded HBM, so the whole hierarchy is finite),
    the static per-request budget (``tier_kv_capacity``), the admission
    multiplier K (``tier_kv_oversub``), one slot-ring spill/refill time
    (``AnalyticCostModel.spill_time``), and the rings the tier holds —
    how much serving concurrency each GB of stacked capacity buys."""
    from repro_torch.chip.config import GB, TB, ipu_mk2
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core.cost_model import AnalyticCostModel
    from repro_torch.serve.engine import (_tier_bytes_left, kv_ring_bytes,
                                    tier_kv_capacity, tier_kv_oversub)

    cfg = get_smoke_config(model) if smoke else get_config(model)
    ring = kv_ring_bytes(cfg, cache_capacity, kv_dtype)
    rows = []
    for size in sizes_gb:
        chip = ipu_mk2().with_stacked_dram(int(size * GB), bw_tbps * TB)
        cap = tier_kv_capacity(cfg, chip, batch=slots, kv_dtype=kv_dtype)
        k = tier_kv_oversub(cfg, chip, slots=slots,
                            cache_capacity=cache_capacity,
                            kv_dtype=kv_dtype)
        spill = AnalyticCostModel(chip).spill_time(ring, 0,
                                                   chip.backing_tier)
        rows.append({
            "model": cfg.name, "slots": slots,
            "cache_capacity": cache_capacity,
            "size_gb": size, "bw_tbps": bw_tbps,
            "kv_tokens_per_req": cap,
            "rings": int(_tier_bytes_left(cfg, chip) // max(ring, 1)),
            "oversub_k": round(k, 3),
            "ring_mb": round(ring / 1e6, 3),
            "slot_spill_us": round(spill * 1e6, 3),
        })
    return rows


def fleet_sweep(model: str = "opt_30b", *,
                num_pods: int = 4,
                n_prefill_list: Sequence[int] = (1, 2),
                inter_bw_ratios: Sequence[float] = (0.25, 0.0625),
                slots: int = 4, cache_capacity: int = 2048,
                prompt_len: int = 1024, kv_dtype: str = "bfloat16",
                decode_step_s: float = 1e-3,
                smoke: bool = False) -> list[dict]:
    """Fleet disaggregation sweep (DESIGN.md §12): for each prefill/decode
    split of a ``num_pods`` fleet and each inter-pod fabric dilution, the
    predicted steady decode rate and prefill service rate of the split vs
    the same pods run as mixed replicas (``serve.fleet.
    predict_fleet_rates`` under the PodCosts tick pricing), and what one
    KV-ring migration costs over that fabric (``FleetSpec.
    migration_time``) against the decode work it unlocks.  A split "wins"
    when it beats the mixed baseline on prefill service rate without
    giving up generated-token rate — the router only disaggregates when
    this row says so."""
    from repro_torch.chip.config import ipu_pod4_hbm
    from repro_torch.chip.topology import fleet_spec
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.serve.engine import PREFILL_SAT, kv_ring_bytes
    from repro_torch.serve.fleet import PodCosts, predict_fleet_rates

    cfg = get_smoke_config(model) if smoke else get_config(model)
    pod = ipu_pod4_hbm()
    ring = kv_ring_bytes(cfg, cache_capacity, kv_dtype)
    costs = PodCosts(decode_step_s=decode_step_s,
                     tick_overhead_s=0.5 * decode_step_s)
    rows = []
    for ratio in inter_bw_ratios:
        fl = dataclasses.replace(fleet_spec(pod, num_pods),
                                 inter_pod_bw=0.0, inter_bw_ratio=ratio)
        mig = fl.migration_time(ring, 0, num_pods - 1)
        for n_pf in n_prefill_list:
            if not 0 < n_pf < num_pods:
                continue
            r = predict_fleet_rates(
                costs, num_pods=num_pods, n_prefill=n_pf, slots=slots,
                prompt_len=prompt_len, chunk_prefill=PREFILL_SAT)
            # migration overhead per request, amortized over its decode
            # stream on the split's decode pods
            rows.append({
                "model": cfg.name, "num_pods": num_pods,
                "n_prefill": n_pf, "slots": slots,
                "prompt_len": prompt_len,
                "inter_bw_ratio": ratio,
                "ring_mb": round(ring / 1e6, 3),
                "migration_ms": round(mig * 1e3, 4),
                "mixed_gen_tok_s": round(r["mixed_gen_tok_s"], 1),
                "disagg_gen_tok_s": round(r["disagg_gen_tok_s"], 1),
                "mixed_prefill_req_s": round(r["mixed_prefill_req_s"], 2),
                "disagg_prefill_req_s":
                    round(r["disagg_prefill_req_s"], 2),
                "disagg_won": bool(
                    r["disagg_prefill_req_s"] > r["mixed_prefill_req_s"]
                    and r["disagg_gen_tok_s"] >= r["mixed_gen_tok_s"]),
            })
    return rows
