"""The harness's control flow rehearsed on the CPU at smoke widths: the
keys of the last line, traced and not, a run without a card, the faults a
cell can have coming out as not correct, and the timeline's reduction."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch
import portbench_smoke as smoke

from portbench import run as harness
from portbench import timeline

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _names(kind: str, workload: str) -> set:
    return {m["name"] for m in smoke.manifest()[kind]
            if workload in m.get("workloads", [workload])}


@pytest.mark.parametrize("workload", [smoke.SERVE, smoke.TRAIN])
def test_measuring_line(workload):
    out = json.loads(json.dumps(smoke.drive(workload)))
    assert list(out) == KEYS
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    assert set(out["metrics"]) == _names("end_to_end", workload)
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert all(set(r) == {"value", "limit"} for r in out["checks"].values())


@pytest.mark.parametrize("workload", [smoke.SERVE, smoke.TRAIN])
def test_traced_line(workload):
    out = smoke.drive(workload, seed=77, trace=True)
    assert list(out) == KEYS[:5] + ["breakdown", "checks"]
    assert out["correct"] is True
    names = _names("per_layer", workload)
    assert set(out["metrics"]) <= names
    # no device on the CPU: the readers of the device's trace find nothing
    # and leave their metrics out; the program's spans and counts remain
    device_read = {n for n in names
                   if n.startswith(("kernels.", "device."))}
    assert set(out["metrics"]) == names - device_read
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def _alter_every_token(monkeypatch):
    from repro_torch.serve.engine import ServeEngine
    step = ServeEngine.step

    def altered(self, tokens):
        return (step(self, tokens) + 1) % self.cfg.vocab_size
    monkeypatch.setattr(ServeEngine, "step", altered)


def _half_the_slots(monkeypatch):
    from repro_torch.serve.engine import ServeEngine
    step = ServeEngine.step

    def half(self, tokens):
        out = step(self, tokens).clone()
        out[out.shape[0] // 2:] = 0
        return out
    monkeypatch.setattr(ServeEngine, "step", half)


def _state_unchanged(monkeypatch):
    import repro_torch.optim.adamw as adamw

    def unchanged(params, grads, state, cfg):
        return params, state, {"grad_norm": adamw.global_norm(grads),
                               "lr": 0.0}
    monkeypatch.setattr(adamw, "apply_update", unchanged)


def _half_the_batch(monkeypatch):
    import repro_torch.train.step as step_mod
    vag = step_mod.value_and_grad

    def half(loss_fn, params, batch):
        n = batch["tokens"].shape[0] // 2
        return vag(loss_fn, params, {k: v[:n] for k, v in batch.items()})
    monkeypatch.setattr(step_mod, "value_and_grad", half)


@pytest.mark.parametrize("workload,fault", [
    (smoke.SERVE, _alter_every_token), (smoke.SERVE, _half_the_slots),
    (smoke.TRAIN, _state_unchanged), (smoke.TRAIN, _half_the_batch)])
def test_a_fault_is_not_correct(monkeypatch, workload, fault):
    fault(monkeypatch)
    out = smoke.drive(workload, seed=4242)
    assert out["correct"] is False
    assert any(r["value"] > r["limit"] for r in out["checks"].values())


def _run_script(cwd, extra_env=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(extra_env or {})
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", smoke.SERVE,
         "--seed", "2147483659", "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_without_a_card_no_line(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is here: the run would measure")
    res = _run_script(smoke.ROOT)
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_without_the_program_no_line(tmp_path):
    shutil.copy(smoke.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(smoke.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _run_script(tmp_path)
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_jax_or_the_jax_package_loaded_is_found(monkeypatch):
    import repro_torch  # noqa: F401
    clean = {k: v for k, v in sys.modules.items()
             if k.split(".")[0] not in harness.FORBIDDEN}
    monkeypatch.setattr(sys, "modules", clean)
    assert harness.forbidden_modules() == []     # repro_torch is not repro
    clean["jax.numpy"] = object()
    clean["repro.core"] = object()
    assert harness.forbidden_modules() == ["jax", "repro"]


def test_timeline_reduction():
    events = [("void hg::(anonymous namespace)::gemm_kernel<64, 128>(int)",
               0, 10),
              ("void (anonymous namespace)::flash_attention_wgmma_kernel"
               "<128, true>(Args)", 20, 30),
              ("void at::native::vectorized_elementwise_kernel<4>(int)",
               25, 40),
              ("Memcpy HtoD (Pageable -> Device)", 60, 70)]
    spans = [("tick", 0, 50), ("step", 10, 22)]
    tl = timeline.reduce(events, 0, 50, spans)
    assert tl["busy_s"] == pytest.approx(30e-9)
    assert tl["window_s"] == pytest.approx(50e-9)
    assert tl["family_s"] == pytest.approx({"matmul": 10e-9,
                                            "attention": 10e-9,
                                            "other": 15e-9})
    assert dict(tl["idle_gaps"]) == pytest.approx({"step": 10e-9,
                                                   "tick": 10e-9})
    assert tl["device_ops"][0] == ["vectorized_elementwise_kernel",
                                   pytest.approx(15e-9)]


def test_each_cell_reports_its_own_metrics():
    man = smoke.manifest()
    for cell in man["workloads"]:
        plan = harness.cell_plan(man, cell["name"])
        e2e = {m["name"] for m in plan["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        moved = {m["moves"] for m in plan["per_layer"]}
        assert plan["per_layer"] and moved <= e2e
    with pytest.raises(SystemExit):
        harness.cell_plan(man, "no-such-cell")
