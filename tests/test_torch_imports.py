"""The port stands alone: it imports neither ``jax`` nor the JAX package,
and its entry points refuse to run when no card is there instead of
falling back to the CPU."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import transformer as tfm
from repro_torch.serve.engine import ServeConfig, ServeEngine

ROOT = Path(__file__).resolve().parents[1]

# One interpreter imports every module of MODULES in turn.  Before any of
# them, a meta-path finder records and refuses (ImportError) every import of
# jax, jaxlib or the reference package, with the module being probed at the
# time, so that a guarded ``try: import jax`` is caught as well as a plain
# one; the record of each module is printed as one JSON object.
_PROBE = """
import importlib, json, sys, traceback
FORBIDDEN = ('jax', 'jaxlib', 'repro')
probing = [None]
attempts = {}

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in FORBIDDEN:
            attempts.setdefault(probing[0], []).append(name)
            raise ImportError('the port may not import ' + name)
        return None

sys.meta_path.insert(0, Refuse())
records = {}
for module in json.loads(sys.argv[1]):
    probing[0] = module
    error = None
    try:
        importlib.import_module(module)
    except BaseException:
        error = traceback.format_exc()
    loaded = sorted(m for m in sys.modules
                    if m.split('.')[0] in FORBIDDEN)
    records[module] = {'error': error, 'refused': attempts.get(module, []),
                       'loaded': loaded}
print(json.dumps(records))
"""

MODULES = [
    "repro_torch", "repro_torch.serve.engine", "repro_torch.launch.serve",
    "repro_torch.convert", "repro_torch.kernels.fused_mlp.kernel",
    "repro_torch.kernels._build", "repro_torch.serve.batcher",
    "repro_torch.kernels.decode_attention.kernel",
    "repro_torch.kernels.decode_attention.ops",
    "repro_torch.kernels.decode_attention.ref", "chip_smoke",
    "repro_torch.kernels.flash_attention.kernel",
    "repro_torch.kernels.flash_attention.ops",
    "repro_torch.kernels.flash_attention.ref", "repro_torch.serve.stream",
    "repro_torch.core.integration", "repro_torch.core.pipeline_pod",
    "repro_torch.chip", "repro_torch.chip.h100", "repro_torch.chip.dsmem",
    "repro_torch.serve.prefix", "repro_torch.chip.simulator",
    "repro_torch.kernels.elk_matmul.ops",
    "repro_torch.kernels.elk_matmul.kernel",
    "repro_torch.serve.fleet", "repro_torch.chip.dse",
    "repro_torch.train.trainer", "repro_torch.launch.train",
    "repro_torch.train.step", "repro_torch.optim.adamw",
    "repro_torch.distributed.compression", "repro_torch.data.pipeline",
    "repro_torch.checkpoint.store", "repro_torch.kernels.fused_mlp.ops",
    "repro_torch.launch.mesh", "repro_torch.distributed.sharding",
    "repro_torch.launch.specs", "repro_torch.launch.hlo_analysis",
    "repro_torch.launch.dryrun", "repro_torch.kernels.cost",
]


@pytest.fixture(scope="module")
def import_records() -> dict:
    """Every module's record from one interpreter (``_PROBE``)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    res = subprocess.run([sys.executable, "-c", _PROBE, json.dumps(MODULES)],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", MODULES)
def test_import_leaves_jax_and_reference_out(module, import_records):
    """The module imports, tries no import of jax, jaxlib or the reference
    package (guarded or not) while it is being imported, and leaves none
    loaded."""
    rec = import_records[module]
    assert rec["error"] is None, rec["error"]
    assert rec["refused"] == [], rec
    assert rec["loaded"] == [], rec


def test_no_source_of_the_port_names_jax_imports():
    """Belt and braces for lazily imported modules: no ``import jax`` or
    ``import repro`` statement anywhere in the port or its smoke script."""
    files = list((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for path in files:
        for line in path.read_text().splitlines():
            words = line.strip().split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                top = words[1].split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (path, line)




def _skip_if_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the refusal cannot be shown")


def test_engine_refuses_to_run_without_a_card():
    _skip_if_card()
    cfg = get_smoke_config("qwen3_14b")
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    with pytest.raises(RuntimeError, match="CUDA device"):
        ServeEngine(cfg, params, ServeConfig(batch=1, cache_capacity=8))
    with pytest.raises(RuntimeError, match="CUDA device"):
        ServeEngine(cfg, params, ServeConfig(batch=1, cache_capacity=8),
                    device="cuda")


def test_init_entry_points_default_to_the_card():
    _skip_if_card()
    cfg = get_smoke_config("qwen3_14b")
    with pytest.raises(RuntimeError, match="CUDA device"):
        tfm.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="CUDA device"):
        tfm.init_cache(cfg, tfm.CacheSpec(capacity=8, batch=1))


def test_launcher_defaults_to_the_card_and_runs_on_cpu_when_asked(capsys):
    from repro_torch.launch import serve
    args = ["--arch", "qwen3-14b", "--smoke", "--batch", "2", "--steps", "3",
            "--prompt-len", "5", "--cache", "16"]
    serve.main(args + ["--device", "cpu"])
    assert "generated 3 tokens x 2 requests" in capsys.readouterr().out
    _skip_if_card()
    with pytest.raises(RuntimeError, match="CUDA device"):
        serve.main(args)


def test_chip_smoke_fails_without_a_card():
    """Non-zero exit and no result line when there is no card."""
    _skip_if_card()
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_dryrun_defaults_to_the_card_and_refuses_without_one(tmp_path):
    """``python -m repro_torch.launch.dryrun`` measures on ``cuda`` unless
    told otherwise: without a card it refuses before any work."""
    _skip_if_card()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3_14b", "--shape", "decode_32k", "--mesh", "single",
         "--out-dir", str(tmp_path)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert res.returncode != 0
    assert "CUDA device" in res.stderr
    assert not list(tmp_path.iterdir())
