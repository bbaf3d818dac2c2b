"""What the benchmark may import and read, and that every name in
``BENCHMARK.json`` finds its file under the benchmark's own folder."""

import ast
import json
import re

import pytest
import portbench_smoke as smoke

BENCH = smoke.ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
JAX_BENCHMARKS = "benchmarks" + "/"    # the JAX package's, never read
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _imports(path) -> set:
    """Top-level names of every module a source imports (relative
    imports count as the benchmark's own)."""
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and not node.level:
            tops.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            tops.add(node.args[0].value.split(".")[0])
    return tops


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not _imports(path) & FORBIDDEN, path
    assert JAX_BENCHMARKS not in path.read_text()


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH / "reference").glob("*.py")):
        tops = _imports(path)
        assert "repro_torch" not in tops, path
        assert tops <= {"__future__", "contextlib", "math", "statistics",
                        "typing", "torch"}, (path, tops)


def test_every_name_finds_its_file():
    man = smoke.manifest()
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert man["paths"] == ["portbench"]
    for cfg in man["configs"]:
        data = json.loads((smoke.ROOT / cfg["file"]).read_text())
        assert cfg["file"].startswith("portbench/configs/")
        assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
        assert data["reduced"] == cfg["reduced"]
    for cell in man["workloads"]:
        mix = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
        assert (BENCH / "drivers" / f"{mix['driver']}.py").exists()
        assert set(mix["check"]["limits"]) and all(
            v > 0 for v in mix["check"]["limits"].values())
    for metric in man["per_layer"]:
        src = (BENCH / "metrics" / f"{metric['name']}.py").read_text()
        assert "def read(ctx)" in src, metric["name"]


def test_the_manifest_keeps_the_contract():
    man = smoke.manifest()
    assert 1 <= man["run_seconds"] <= 51
    cells = {w["name"]: w for w in man["workloads"]}
    configs = {c["name"] for c in man["configs"]}
    for entry in man["configs"] + man["workloads"] + man["end_to_end"] \
            + man["per_layer"]:
        assert NAME.match(entry["name"]), entry["name"]
    for cell in cells.values():
        assert cell["config"] in configs and cell["chips"] in (1, 4)
        assert len(cell["why"]) <= 200
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in man["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"]: m for m in man["end_to_end"]}
    for m in man["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for name in cells:
        reports = {m["name"] for m in man["end_to_end"]
                   if name in m.get("workloads", cells)}
        assert "setup_s" in reports and len(reports) >= 2
        assert any(name in m["workloads"] for m in man["per_layer"])
