"""Readings that set a cell's limits: the program and its controls, by seed.

    python3 portbench/control.py --workload <cell> --seconds <s> --seeds <n> ...
        [--controls fp8 half_batch]

Runs the cell's driver once a seed in one process (a short window where
the cell serves; training reads its first steps and needs none), and
prints one JSON line a seed: the numbers the check compares for the
program, and the same numbers for each control put in its place: ``fp8``,
the reference with every product's operands in float8 e4m3, the precision
below the configuration's bf16 (serving: the gap of the token it puts
first); ``half_batch``, the reference on half of each batch, a fault
planted (training).  The benchmark's own runs never run a control.  Needs
the card, as ``run.py`` does.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", nargs="*", default=["fp8"])
    args = ap.parse_args(argv)
    from portbench import run as harness
    import torch
    if not torch.cuda.is_available():
        harness.Env.say("no CUDA device: the readings are the card's")
        return 3
    manifest = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    plan = harness.cell_plan(manifest, args.workload)
    from repro_torch.kernels import _build
    _build.build_all()
    driver = harness.load_module(HERE / "drivers"
                                 / f"{plan['mix']['driver']}.py")
    for seed in args.seeds:
        env = harness.Env(plan, seed, args.seconds, False, "cuda")
        env.controls = list(args.controls)
        out = driver.run(env)
        row = {"workload": args.workload, "seed": seed,
               "program": {k: v["value"]
                           for k, v in out["check"]["checks"].items()},
               "controls": out["controls"],
               "memory_peak_bytes": out["memory_peak_bytes"],
               "e2e": out["e2e"], "attempted": out["attempted"]}
        print(json.dumps(row), flush=True)
        del out, env
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(HERE.parent))
    from portbench.run import checkout_paths
    checkout_paths()
    sys.exit(main())
