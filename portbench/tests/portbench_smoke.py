"""Cells of ``BENCHMARK.json`` cut to a size the CPU tests hold: the port's
smoke widths for each configuration, a short mix, the plain path on the
CPU.  Shared by the benchmark's tests."""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench import run as harness  # noqa: E402

SERVE = "opt-30b.docqa"
TRAIN = "h2o-danube-1.8b.train8k"
_ARCH = {SERVE: "opt_30b", TRAIN: "h2o_danube_1_8b"}
_MIX = {SERVE: {"engine": {"batch": 3, "cache_capacity": 64,
                           "prefill_chunk": 16, "kv_dtype": "float32"},
                "clients": 6, "requests": 64,
                "prompt": {"median": 16, "min": 8, "max": 24},
                "output": {"median": 4, "min": 2, "max": 8},
                "check": {"requests": 4}},
        TRAIN: {"batch": 2, "seq": 40}}
# windows long enough for requests to finish on a loaded CPU
SECONDS = {SERVE: 3.0, TRAIN: 0.5}
_SIZES = ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
          "vocab_size", "sliding_window")


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def small_model(workload: str, dtype: str = "bfloat16") -> dict:
    """The cell's configuration at the port's smoke widths."""
    from repro_torch.configs import get_smoke_config
    plan = harness.cell_plan(manifest(), workload)
    smoke = get_smoke_config(_ARCH[workload])
    model = dict(plan["config"]["model"])
    for key in _SIZES:
        if key in model or getattr(smoke, key):
            model[key] = getattr(smoke, key)
    model["dtype"] = model["param_dtype"] = dtype
    return model


def small_plan(workload: str, dtype: str = "float32") -> dict:
    """The cell's plan with the small model and mix.  In fp32 (the
    default) the port's plain path agrees with the reference to round-off,
    so a sound run reads far under the cell's limits and a fault far over
    them; in bf16 (the cell's type) the controls are read."""
    plan = harness.cell_plan(manifest(), workload)
    plan["config"] = dict(plan["config"], model=small_model(workload, dtype))
    mix = json.loads(json.dumps(plan["mix"]))
    for key, val in _MIX[workload].items():
        if isinstance(val, dict):
            mix[key].update(val)
        else:
            mix[key] = val
    plan["mix"] = mix
    return plan


def drive(workload: str, seed: int = 20260, trace: bool = False) -> dict:
    """One run of the small cell on the CPU, the look for a card skipped."""
    return harness.drive(small_plan(workload), seed, SECONDS[workload],
                         trace, "cpu", 0.0)
