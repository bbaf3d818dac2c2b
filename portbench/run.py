"""Run one cell of ``BENCHMARK.json`` once on the card and print its line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell names its configuration (``configs/<name>.json``) and its traffic
or job (``traffic/<name>.json``), which names its driver
(``drivers/<driver>.py``).  With ``--trace 0`` the line's metrics are the
cell's end-to-end metrics; with ``--trace 1`` the window runs under
``torch.profiler`` with the benchmark's spans, and the metrics are the
cell's per-layer metrics, each read by ``metrics/<name>.py``.  Every run
checks what the window produced against the fp32 reference and prints each
compared number beside its limit, last on standard error and last in the
line.  Without a CUDA card, with fewer cards than the cell asks for, or
with JAX or the JAX package loaded once the window has closed, the run
fails and prints no line.  Build and kernel caches stay inside the
checkout, under ``build/``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_module(path: Path):
    """A module of the benchmark found by file name (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_plan(manifest: dict, workload: str) -> dict:
    """The cell, its configuration file, its traffic file and the metrics
    it reports, by name."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    config = next(c for c in manifest["configs"]
                  if c["name"] == cell["config"])

    def mine(metric):
        return workload in metric.get("workloads", [workload])

    return {"cell": cell,
            "config": json.loads((ROOT / config["file"]).read_text()),
            "mix": json.loads((HERE / "traffic"
                               / f"{cell['traffic']}.json").read_text()),
            "end_to_end": [m for m in manifest["end_to_end"] if mine(m)],
            "per_layer": [m for m in manifest["per_layer"] if mine(m)]}


class Env:
    """What a driver gets: the cell's files, the seed, the window's length,
    the tracer and the device, and the hooks it reports through."""

    def __init__(self, plan: dict, seed: int, seconds: float, trace: bool,
                 device: str):
        from portbench import timeline
        self.cell, self.config, self.mix = (plan["cell"], plan["config"],
                                            plan["mix"])
        self.model = self.config["model"]
        self.seed, self.seconds, self.device = seed, seconds, str(device)
        self.tracer = timeline.Tracer(trace, cuda=self.is_cuda())
        self.window_t0 = None
        self.controls: list[str] = []    # read by portbench/control.py

    def port_config(self):
        from repro_torch.models.config import ModelConfig
        return ModelConfig(**self.model)

    def dims(self) -> dict:
        from portbench import counts
        return counts.dims(self.model)

    def is_cuda(self) -> bool:
        return self.device.startswith("cuda")

    def sync(self) -> None:
        if self.is_cuda():
            import torch
            torch.cuda.synchronize()

    def window_opened(self, t0: float) -> None:
        self.window_t0 = t0

    def memory_peak(self) -> int:
        if not self.is_cuda():
            return 0
        import torch
        return int(torch.cuda.max_memory_allocated())

    def free(self) -> None:
        if self.is_cuda():
            import torch
            torch.cuda.empty_cache()

    @staticmethod
    def say(msg: str) -> None:
        print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def drive(plan: dict, seed: int, seconds: float, trace: bool,
          device: str, t_start: float) -> dict:
    """Run the cell's driver and build the result line (a dict)."""
    env = Env(plan, seed, seconds, trace, device)
    driver = load_module(HERE / "drivers" / f"{plan['mix']['driver']}.py")
    out = driver.run(env)
    setup_s = env.window_t0 - t_start
    if trace:
        ctx = dict(out["layer"])
        metrics = {}
        for m in plan["per_layer"]:
            reader = load_module(HERE / "metrics" / f"{m['name']}.py")
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(out["e2e"], setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in plan["end_to_end"]
                   if values.get(m["name"]) is not None}
    result = {"correct": out["check"]["correct"],
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics,
              "device": {"platform": "gpu" if env.is_cuda() else "cpu",
                         "kind": device_name(device),
                         "count": 1,
                         "memory_peak_bytes": out["memory_peak_bytes"]}}
    tl = out["layer"].get("timeline")
    if trace and tl is not None:
        result["device"]["busy_s"] = tl["busy_s"]
        result["device"]["window_s"] = tl["window_s"]
        result["breakdown"] = {"device_ops": tl["device_ops"],
                               "idle_gaps": tl["idle_gaps"]}
    result["checks"] = out["check"]["checks"]
    env.say(f"setup_s {setup_s:.3f}")
    return result


def device_name(device: str) -> str:
    if not str(device).startswith("cuda"):
        return "cpu"
    import torch
    return torch.cuda.get_device_name(0)


def power_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc}"


def forbidden_modules() -> list[str]:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    plan = cell_plan(manifest, args.workload)

    import torch
    import repro_torch  # noqa: F401  (the system under test must be here)
    if not torch.cuda.is_available():
        Env.say("no CUDA device: the benchmark measures the card only")
        return 3
    if torch.cuda.device_count() < plan["cell"]["chips"]:
        Env.say(f"{torch.cuda.device_count()} CUDA devices, the cell asks "
                f"for {plan['cell']['chips']}")
        return 3
    from repro_torch.kernels import _build
    _build.build_all()
    result = drive(plan, args.seed, args.seconds, bool(args.trace), "cuda",
                   T_START)
    found = forbidden_modules()
    if found:
        Env.say(f"loaded once the window closed: {', '.join(found)}")
        return 4
    peaks = json.loads((HERE / "peaks.json").read_text())
    Env.say(f"card: {power_line()}; peaks {peaks['bf16_flops_per_s']:.4g} "
            f"FLOP/s bf16, {peaks['hbm_bytes_per_s']:.4g} B/s")
    for name, row in result["checks"].items():
        Env.say(f"check {name} {row['value']!r} limit {row['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


def checkout_paths() -> None:
    """The benchmark and the program from this checkout; every build and
    kernel cache in its ``build/``, at fixed paths."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        os.environ[var] = str(ROOT / "build" / sub)
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path if Path(p or ".").resolve() != HERE]


if __name__ == "__main__":
    checkout_paths()
    sys.exit(main())
