"""The port's copy of the design-space sweeps (``repro_torch/chip/dse.py``)
and the example twins, on the CPU.

``chip/dse.py`` is the reference's file with its imports renamed, like the
rest of the planner copy; each sweep runs here at the reference tests'
smallest settings (or the examples' ``--fast`` ones) in both copies and must
give equal rows.  The example twins (``examples/*_torch.py``) run as
scripts, in a process that imports no ``jax``.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.chip import dse as rdse
from repro.configs import get_config as ref_config
from repro.configs import get_smoke_config as ref_smoke
from repro_torch.chip import dse as tdse
from repro_torch.chip.config import ipu_pod4_hbm
from repro_torch.configs import get_config, get_smoke_config

ROOT = Path(__file__).resolve().parents[1]


def test_dse_is_the_reference_with_imports_renamed():
    ref = (ROOT / "src/repro/chip/dse.py").read_text()
    port = (ROOT / "src/repro_torch/chip/dse.py").read_text()
    assert port == ref.replace("repro.", "repro_torch.")


@pytest.mark.parametrize("topologies", [("all2all", "mesh2d"),
                                        ("ring", "hier_pod", "torus2d")])
def test_topology_sweep_equals_reference(topologies):
    kw = dict(designs=("ELK-Full",), max_orders=2)
    trim = lambda c: dataclasses.replace(c, num_layers=2)  # noqa: E731
    got = tdse.topology_sweep(trim(get_config("llama2_13b")), topologies,
                              **kw)
    want = rdse.topology_sweep(trim(ref_config("llama2_13b")), topologies,
                               **kw)
    assert got == want and len(got) == len(topologies)


def test_scale_pod_equals_reference():
    from repro.chip.config import ipu_pod4_hbm as ref_pod
    for n in (1, 2, 4):
        a = tdse.scale_pod(ipu_pod4_hbm(topology="hier_pod"), n)
        b = rdse.scale_pod(ref_pod(topology="hier_pod"), n)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.num_chips == n


def test_pipeline_sweep_equals_reference():
    kw = dict(num_chips_list=(1, 2), max_orders=2, sim_layers=2)
    got = tdse.pipeline_sweep(get_smoke_config("opt_30b"), **kw)
    assert got == rdse.pipeline_sweep(ref_smoke("opt_30b"), **kw)
    assert [r["num_chips"] for r in got] == [1, 2]


def test_hybrid_sweep_equals_reference():
    kw = dict(topologies=("all2all", "hier_pod"), sim_layers=2, max_orders=2)
    got = tdse.hybrid_sweep(("opt_30b",), **kw)
    assert got == rdse.hybrid_sweep(("opt_30b",), **kw)
    assert all(0.5 <= r["plan_sim_ratio"] <= 2.0 for r in got)


def test_tier_sweep_equals_reference():
    """The reference's acceptance point (stacked 8 GB at 16 TB/s improves
    planned opt_30b decode), in both copies."""
    kw = dict(sizes_gb=(8,), bws_tbps=(16,))
    got = tdse.tier_sweep(**kw)
    assert got == rdse.tier_sweep(**kw)
    assert any(r["improved"] for r in got if r["tier"] == "stacked")


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_kv_offload_sweep_equals_reference(smoke, kv_dtype):
    kw = dict(sizes_gb=(16, 64), smoke=smoke, kv_dtype=kv_dtype)
    got = tdse.kv_offload_sweep(**kw)
    assert got == rdse.kv_offload_sweep(**kw)
    assert got[1]["rings"] >= got[0]["rings"]


@pytest.fixture(scope="module")
def nojax(tmp_path_factory) -> Path:
    """A ``jax`` package that fails on import: the twins must not need
    jax, and a process with it first on its path proves they do not."""
    stub = tmp_path_factory.mktemp("nojax")
    (stub / "jax").mkdir()
    (stub / "jax" / "__init__.py").write_text(
        "raise ImportError('an example twin imported jax')\n")
    return stub


def _run_example(stub: Path, name: str,
                 *args: str) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(stub), str(ROOT / "src")])
    return subprocess.run([sys.executable, str(ROOT / "examples" / name),
                           *args], capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=300)


def test_quickstart_twin_runs(nojax):
    res = _run_example(nojax, "quickstart_torch.py")
    assert res.returncode == 0, res.stderr
    assert "design comparison" in res.stdout
    assert "event simulator cross-check" in res.stdout


def test_dse_explore_twin_runs(nojax, tmp_path):
    out = tmp_path / "topo.csv"
    res = _run_example(nojax, "dse_explore_torch.py", "--fast",
                       "--topologies", "all2all,ring", "--csv", str(out))
    assert res.returncode == 0, res.stderr
    assert out.read_text().splitlines()[0].startswith("topology,design")
    assert len(out.read_text().splitlines()) == 3


def test_serve_elk_stream_twin_runs_on_the_cpu(nojax):
    res = _run_example(nojax, "serve_elk_stream_torch.py", "--device",
                       "cpu")
    assert res.returncode == 0, res.stderr
    assert "exact match" in res.stdout


def test_serve_elk_stream_twin_needs_a_card_by_default(nojax):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the refusal cannot be shown")
    res = _run_example(nojax, "serve_elk_stream_torch.py")
    assert res.returncode != 0 and "CUDA device" in res.stderr
