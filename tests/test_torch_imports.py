"""The port stands alone: it imports neither ``jax`` nor the JAX package,
and its entry points refuse to run when no card is there instead of
falling back to the CPU."""

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

_PROBE = """
import importlib, json, sys
importlib.import_module({module!r})
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))
print(json.dumps(bad))
"""


@pytest.mark.parametrize("module", [
    "repro_torch", "repro_torch.serve.engine", "repro_torch.launch.serve",
    "repro_torch.convert", "repro_torch.kernels.fused_mlp.kernel",
    "repro_torch.kernels._build", "chip_smoke",
])
def test_import_leaves_jax_and_reference_out(module):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    res = subprocess.run([sys.executable, "-c", _PROBE.format(module=module)],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]", res.stdout


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
