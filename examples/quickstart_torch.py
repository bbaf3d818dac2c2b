"""Quickstart of the PyTorch port's planner (``repro_torch.core`` and
``repro_torch.chip``): compile a model with ELK, inspect the plan, compare
the paper's five designs, and run the event simulator, all on the CPU.
The planner needs no card and imports neither ``jax`` nor the JAX package.

    PYTHONPATH=src python examples/quickstart_torch.py
"""

from repro_torch.chip.config import ipu_pod4_hbm
from repro_torch.chip.simulator import simulate
from repro_torch.configs import get_config
from repro_torch.core.elk import compare_designs, compile_model

chip = ipu_pod4_hbm()                      # the paper's emulator target
cfg = get_config("llama2_13b")

# --- one ELK-Full compile -------------------------------------------------
plan = compile_model(cfg, chip, batch=32, seq=2048, phase="decode",
                     design="ELK-Full")
print(f"ELK-Full plan for {cfg.name}: {len(plan.graph.ops)} ops, "
      f"per-token latency {plan.total_time*1e3:.2f} ms")
print(f"  mean preload number : {plan.mean_preload_number:.1f}")
print(f"  reorder edit dist   : {plan.edit_distance():.2f}")
print(f"  HBM util {plan.util.hbm:.1%} | NoC util "
      f"{plan.util.interconnect:.1%} | {plan.util.achieved_tflops:.0f} "
      f"TFLOPS")

# --- the §6.1 ablation ------------------------------------------------------
plans = compare_designs(cfg, chip, batch=32, seq=2048, phase="decode")
ideal = plans["Ideal"].total_time
print("\ndesign comparison (paper Fig. 17):")
for name, p in plans.items():
    print(f"  {name:9s} {p.total_time*1e3:7.3f} ms   "
          f"{ideal/p.total_time:6.1%} of Ideal")

# --- independent event-driven simulation -----------------------------------
import dataclasses
small = dataclasses.replace(cfg, num_layers=2)
sim_plan = compile_model(small, chip, batch=32, seq=2048, phase="decode",
                         design="ELK-Dyn")
res = simulate(sim_plan, chip)
print(f"\nevent simulator cross-check (2-layer model): "
      f"plan={sim_plan.total_time*1e3:.3f} ms, sim={res.total_time*1e3:.3f} "
      f"ms")
