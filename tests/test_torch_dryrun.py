"""The port's dry run, its mesh flags and FSDP on one device, on the CPU.

``launch/dryrun.run_cell`` counts a full-size cell on the meta device and
writes the reference's record keys; ``run_cell_accounting`` measures a
smoke-size cell on the CPU (on the card it runs the full width:
``chip_smoke.py``'s ``[dryrun]`` phase); both launchers refuse
``--production-mesh`` with the mesh's device count; ``Trainer`` with
``fsdp`` on a mesh of one device equals it without, bit for bit.
"""

import json

import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.launch import hlo_analysis as ref_hlo
from repro.launch import specs as ref_specs
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import dryrun, specs
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.launch.mesh import Mesh
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import tree_leaves

# the record keys of the reference's run_cell, 16 GB fit read at 80 GB
RECORD_KEYS = {"arch", "shape", "mesh", "mode", "status", "memory",
               "fits_80gb", "roofline", "roofline_flash", "meta",
               "grad_accum", "collectives"}


def test_run_cell_writes_the_references_record(tmp_path, capsys):
    rec = dryrun.run_cell("qwen3_14b", "decode_32k", "single",
                          out_dir=str(tmp_path))
    assert rec["status"] == "ok" and RECORD_KEYS <= set(rec)
    path = tmp_path / "qwen3_14b__decode_32k__single.json"
    assert json.loads(path.read_text()) == rec
    rf = ref_hlo.Roofline(1, 1, 0, 1, 1, 0, 1, 1).to_dict()
    assert set(rec["roofline"]) == set(rf) == set(rec["roofline_flash"])
    case = ref_specs.SHAPES["decode_32k"]
    assert rec["meta"]["model_flops"] == ref_specs.model_flops(
        ref_get_config("qwen3_14b"), case)
    assert rec["roofline"]["num_chips"] == 256
    assert rec["collectives"] is None and rec["roofline"]["collective_s"] == 0
    assert rec["memory"]["total_hbm_bytes"] > 0 and rec["fits_80gb"]
    assert rec["meta"]["kv_dtype"] == "int8" and not rec["meta"]["streamed"]
    assert "[ok] qwen3_14b" in capsys.readouterr().out
    # resumable: the record is read back, not counted again
    path.write_text(json.dumps({**rec, "status": "ok", "mark": 1}))
    assert dryrun.run_cell("qwen3_14b", "decode_32k", "single",
                           out_dir=str(tmp_path))["mark"] == 1


def test_ineligible_cells_are_skipped_with_the_references_reason(tmp_path):
    rec = dryrun.run_cell("llama2_70b", "long_500k", "multi",
                          out_dir=str(tmp_path))
    want = ref_specs.eligible(ref_get_config("llama2_70b"), "long_500k")[1]
    assert rec == {"arch": "llama2_70b", "shape": "long_500k",
                   "mesh": "multi", "mode": "elk", "status": "skipped",
                   "reason": want}


def test_the_launcher_counts_on_the_cpu(tmp_path, capsys):
    tally = dryrun.main(["--arch", "hymba_1_5b", "--shape", "long_500k",
                         "--mesh", "both", "--count-only", "--device", "cpu",
                         "--out-dir", str(tmp_path)])
    assert tally == {"ok": 2, "skipped": 0, "error": 0}
    assert "dry-run complete: 2 ok" in capsys.readouterr().out
    rec = json.loads((tmp_path / "hymba_1_5b__long_500k__multi.json")
                     .read_text())
    assert rec["recurrence_correction"]["flops"] > 0     # the SSM's scan
    assert rec["roofline"]["num_chips"] == 512


def test_a_smoke_cell_is_measured_at_two_depths(tmp_path, monkeypatch):
    """The accounting path on the CPU at the smoke config's width: two
    depths measured and extrapolated, the arguments' bytes what
    ``local_bytes`` says, the record's keys."""
    monkeypatch.setattr(specs, "get_config", get_smoke_config)
    monkeypatch.setattr(dryrun, "get_config", get_smoke_config)
    rec = dryrun.run_cell_accounting("hymba_1_5b", "long_500k", device="cpu",
                                     out_dir=str(tmp_path), iters=1)
    assert rec["status"] == "ok", rec.get("traceback")
    assert {"variants", "reduced", "fits_80gb", "roofline_fraction",
            "memory", "ms"} <= set(rec)
    assert [v["layers"] for v in rec["variants"]] == [1, 2]
    for v in rec["variants"]:
        assert v["ms"] > 0 and v["bound_ms"] > 0 and v["batch"] == 1
    assert rec["ms"] >= rec["variants"][-1]["ms"]
    cell = specs.build_cell("hymba_1_5b", "long_500k",
                            dryrun.make_mesh("local"), device="cpu",
                            num_layers_override=2)
    nbytes = sum(t.numel() * t.element_size()
                 for t in tree_leaves(list(cell.args))
                 if isinstance(t, torch.Tensor))
    assert rec["variants"][-1]["arg_bytes_local"] == nbytes


def test_fsdp_on_one_device_changes_nothing(tmp_path):
    """``Trainer`` with ``fsdp`` on the local mesh of one CPU device equals
    it without, bit for bit, after 3 steps (the reference's ``mesh11``)."""
    cfg = get_smoke_config("qwen3_14b")
    dcfg = DataConfig(batch=2, seq=8, vocab_size=cfg.vocab_size)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=3)
    runs = []
    for fsdp in (False, True):
        tcfg = TrainerConfig(workdir=str(tmp_path / str(fsdp)), total_steps=3,
                             ckpt_every=100, fsdp=fsdp)
        tr = Trainer(cfg, dcfg, ocfg, tcfg, device="cpu")
        assert tr.mesh.shape == {"data": 1, "model": 1}
        log = tr.run()
        runs.append(([m["loss"] for m in log], tree_leaves(tr.params)))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_trainer_refuses_a_mesh_of_more_devices(tmp_path):
    cfg = get_smoke_config("qwen3_14b")
    mesh = Mesh(("data", "model"), (2, 1), (torch.device("cpu"),) * 2)
    with pytest.raises(ValueError, match="no multi-GPU placement"):
        Trainer(cfg, DataConfig(batch=2, seq=8, vocab_size=cfg.vocab_size),
                AdamWConfig(), TrainerConfig(workdir=str(tmp_path)),
                device="cpu", mesh=mesh)


@pytest.mark.parametrize("launcher", ["train", "serve"])
def test_production_mesh_is_parsed_and_refused(launcher):
    args = ["--arch", "qwen3-14b", "--smoke", "--device", "cpu",
            "--production-mesh"]
    mod = train_launcher if launcher == "train" else serve_launcher
    assert mod.parse_args(args).production_mesh
    with pytest.raises(RuntimeError, match="needs 256 devices"):
        mod.main(args)
