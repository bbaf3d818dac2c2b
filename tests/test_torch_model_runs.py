"""The full-width runs of ``chip_smoke.py``'s ``[models]`` phase, reckoned
on the CPU, and what they draw.

Each run of ``MODEL_RUNS`` holds its bf16 weights and its bf16 ring on one
H100 80GB HBM3 (85.5e9 bytes as PyTorch sees the card) with ``HEADROOM``
left for a prefill's activations and logits; qwen1.5-32b at all 64 layers
would not, which is why it runs cut.  A config with biases serves them
nonzero (``fill_biases``), and the MLP rows of the kernel phases carry fc
biases exactly where the model's MLPs have them (``mlp_bias``).  The DSMEM
probe's expected sums (``chip/dsmem.py``) are the words its blocks write.
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.chip import dsmem
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import transformer as tfm
from repro_torch.serve.engine import kv_ring_bytes

ROOT = Path(__file__).resolve().parents[1]
CARD_BYTES = 85.5e9
HEADROOM = 8e9


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules.setdefault("chip_smoke", mod)
    spec.loader.exec_module(mod)
    return mod


cs = _load_chip_smoke()


def _resident_bytes(cfg, ring: int) -> float:
    """bf16 weights and a batch of bf16 rings of ``ring`` slots."""
    return 2 * cfg.param_count() + cs.BATCH * kv_ring_bytes(cfg, ring)


@pytest.mark.parametrize("run", cs.MODEL_RUNS, ids=[r[0] for r in
                                                    cs.MODEL_RUNS])
def test_model_run_fits_one_card(run):
    arch, depth, _, ring = run
    cfg = cs.model_cfg(arch, depth)
    assert CARD_BYTES - _resident_bytes(cfg, ring) >= HEADROOM, (
        arch, _resident_bytes(cfg, ring) / 1e9)


def test_qwen15_runs_cut_because_all_64_layers_do_not_fit():
    full = get_config("qwen1_5_32b")
    assert full.num_layers == 64 and cs.QWEN15_DEPTH < 64
    assert CARD_BYTES - _resident_bytes(full, cs.CACHE) < HEADROOM
    assert ("qwen1_5_32b", cs.QWEN15_DEPTH, cs.PROMPT_LEN,
            cs.CACHE) in cs.MODEL_RUNS


def test_danube_runs_past_its_window():
    """h2o-danube-1.8b's run reaches past its window: the prompt is longer
    than the window, the ring wider than the window."""
    cfg = get_config("h2o_danube_1_8b")
    window = tfm.attn_spec(cfg).sliding_window
    assert ("h2o_danube_1_8b", 0, cs.DANUBE_PROMPT_LEN,
            cs.DANUBE_CACHE) in cs.MODEL_RUNS
    assert window < cs.DANUBE_PROMPT_LEN < cs.DANUBE_CACHE
    assert cs.DANUBE_PROMPT_LEN + cs.STEPS <= cs.DANUBE_CACHE


@pytest.mark.parametrize("arch", ["opt_30b", "qwen1_5_32b"])
def test_bias_draw_is_nonzero(arch):
    """``fill_biases`` fills every bias of every layer with seeded nonzero
    values: the q, k, v biases, and opt's fc biases; the same seed draws
    the same values."""
    cfg = get_smoke_config(arch)
    drawn = []
    for _ in range(2):
        params = tfm.init_params(torch.Generator().manual_seed(0), cfg,
                                 "cpu")
        names = cs.fill_biases(params)
        drawn.append(params)
    want = {"b_q", "b_k", "b_v"} | ({"b_up", "b_down"}
                                    if cs.mlp_bias(cfg) else set())
    assert set(names) == want
    for a, b in zip(drawn[0]["layers"], drawn[1]["layers"]):
        for group in ("attn", "mlp"):
            for name, t in a[group].items():
                if name.startswith("b_"):
                    assert torch.count_nonzero(t) == t.numel(), (arch, name)
                    assert float(t.abs().max()) < 1.0
                    assert torch.equal(t, b[group][name])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_mlp_rows_carry_biases_where_the_model_does(arch):
    cfg = get_smoke_config(arch)
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    mlps = [layer[k] for layer in params["layers"]
            for k in ("mlp", "shared_mlp") if k in layer]
    for mlp in mlps:
        assert ("b_up" in mlp) == ("b_down" in mlp) == cs.mlp_bias(cfg)
    assert cs.mlp_bias(cfg) == (arch == "opt_30b")


def test_dsmem_probe_sums_are_the_peer_words():
    """Word i of the block of rank r is r * 0x9E3779B9 + i * 0x85EBCA6B + 1
    (mod 2**32), as the source's ``word_of``; each block sums its peer's
    ``rounds`` times."""
    words, rounds = 1000, 7
    for rank in (0, 1):
        plain = sum((rank * 0x9E3779B9 + i * 0x85EBCA6B + 1) % 2 ** 32
                    for i in range(words)) % 2 ** 32
        assert dsmem.word_sum(rank, words) == plain
    want = dsmem.expected_sums(3, rounds, words)
    assert want.tolist() == [dsmem.word_sum(1, words) * rounds % 2 ** 32,
                             dsmem.word_sum(0, words) * rounds % 2 ** 32] * 3
    assert want.dtype == np.uint64


def test_dsmem_probe_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA device"):
        dsmem.measure_dsmem(device="cpu")
